"""Inference latency microbenchmark of the port.

    python -m facesr_torch.cli.measure_inference_time --bf16 --batch-size 128

Times the 64x64 -> 256x256 forward of FaceEnhanceNet (6x10x64 with
seeded random weights) or of the model in ``--checkpoint`` (a ``.pth`` or
``.fckpt`` of any model the port loads) after warm-up, each run bracketed
by CUDA events, and reports avg/min/max/p50 ms and images/s; then, with
``--transfer-checkpoint``, the transfer model in that checkpoint at the
same precision. The same report as ``scripts/measure_inference_time.py``
of the JAX package. ``--int8`` times the full-int8 forward (s8 convs,
per-image dynamic activation scales), ``--int8 --calibrate N`` with
static scales calibrated on N seeded random images of the input size,
for any model the port loads.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Measure SR inference latency (PyTorch port)")
    p.add_argument("--checkpoint", "--custom-checkpoint", dest="checkpoint",
                   default=None, help=".pth or .fckpt to time (default: fresh "
                   "6x10x64 model with seeded random weights)")
    p.add_argument("--transfer-checkpoint", default=None,
                   help="also time the transfer model in this .pth or .fckpt")
    p.add_argument("--input-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-runs", type=int, default=100)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (the trunk runs the Hopper group kernel)")
    p.add_argument("--int8", action="store_true",
                   help="full-int8 serving path (s8 convs, per-image activation scales)")
    p.add_argument("--calibrate", type=int, default=0, metavar="N",
                   help="with --int8: static activation scales calibrated on N random "
                        "images")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace to this file")
    p.add_argument("--device", default=None,
                   help="device (default: cuda; 'cpu' runs the plain versions)")
    return p


def _device_banner(dev: torch.device) -> str:
    if dev.type != "cuda":
        return str(dev)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    return f"{torch.cuda.get_device_name(dev)} ({smi})"


def describe(model) -> str:
    """One line of a model's architecture for the banner."""
    cfg = model.config
    mtype = getattr(model, "model_type", "custom")
    if mtype == "transfer":
        return (f"transfer {cfg.backbone_blocks} backbone RRDBs + {cfg.head_blocks}-RCAB "
                f"head x{cfg.head_channels}")
    if mtype == "esrgan":
        return f"RRDBNet {cfg.num_blocks}x{cfg.num_feat} growth {cfg.num_grow_ch}"
    return f"model {cfg.num_groups}x{cfg.blocks_per_group}x{cfg.num_channels}"


def main(argv=None) -> None:
    args = _parser().parse_args(argv)

    from facesr_torch.device import resolve_device
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
    from facesr_torch.models.load import load_any_model
    from facesr_torch.parallel.serving import build_serving_fn

    dev = resolve_device(args.device)
    if args.checkpoint:
        model = load_any_model(args.checkpoint, device=dev)
    else:
        cfg = FaceEnhanceNetConfig(num_groups=6, blocks_per_group=10, num_channels=64)
        model = FaceEnhanceNet(cfg, seed=0, device=dev)
    transfer = None
    if args.transfer_checkpoint:
        transfer = load_any_model(args.transfer_checkpoint, device=dev)
        if getattr(transfer, "model_type", "custom") != "transfer":
            raise SystemExit(f"--transfer-checkpoint {args.transfer_checkpoint} holds a "
                             f"{type(transfer).__name__}, not a transfer model")
    if args.int8:
        dtype = "int8_full"
        prec = "int8_full/calibrated" if args.calibrate > 0 else "int8_full"
    else:
        dtype = torch.bfloat16 if args.bf16 else None
        prec = "bf16" if args.bf16 else "f32"
    calibration = None
    if args.int8 and args.calibrate > 0:
        calibration = np.random.default_rng(1).random(
            (args.calibrate, args.input_size, args.input_size, 3), dtype=np.float32)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (args.batch_size, args.input_size, args.input_size, 3),
        dtype=np.float32)).to(dev)
    print(f"Device: {_device_banner(dev)} | {describe(model)} | batch {args.batch_size} | "
          f"input {args.input_size}x{args.input_size} | {prec}")
    cuda = dev.type == "cuda"

    def time_model(m) -> None:
        fwd = build_serving_fn(m.eval(), dtype, calibration=calibration,
                               max_batch=max(args.batch_size, 1))

        def timed_run() -> float:
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fwd(x)
                end.record()
                end.synchronize()
                return start.elapsed_time(end)
            t0 = time.perf_counter()
            fwd(x)
            return (time.perf_counter() - t0) * 1000

        for _ in range(args.warmup):
            timed_run()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        ctx = (torch.profiler.profile(activities=acts) if args.profile
               else contextlib.nullcontext())
        with ctx as prof:
            times = np.asarray([timed_run() for _ in range(args.num_runs)])
        if args.profile:
            prof.export_chrome_trace(args.profile)
            print(f"Profiler trace written to {args.profile}")

        print(f"\nInference time over {args.num_runs} runs"
              f" ({'CUDA events' if cuda else 'host clock'}):")
        print(f"  avg: {times.mean():.2f} ms")
        print(f"  min: {times.min():.2f} ms")
        print(f"  max: {times.max():.2f} ms")
        print(f"  p50: {np.percentile(times, 50):.2f} ms")
        print(f"  images/sec: {args.batch_size / (times.mean() / 1000):.1f}")

    time_model(model)
    if transfer is not None:
        # the same serving precision: the banner applies to both
        print(f"\nTransfer Model (from {args.transfer_checkpoint}): {describe(transfer)}")
        time_model(transfer)


if __name__ == "__main__":
    sys.exit(main())
