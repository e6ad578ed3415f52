"""Benchmark every checkpoint in a directory against the OpenCV baselines,
with the flags of the JAX package's `scripts/compare_two_models.py`:

    python -m facesr_torch.cli.compare_two_models --checkpoint-dir checkpoints \\
        --test-dir data/processed/test/HR --output outputs/compare_models [--device cpu]

Every ``*.fckpt`` and ``*.pth`` in ``--checkpoint-dir`` is evaluated
against Bilinear, Bicubic and Lanczos4 4x upscales (the port's copies of
cv2's ``INTER_LINEAR``, ``INTER_CUBIC``, ``INTER_LANCZOS4``) with
skimage-compatible PSNR and SSIM, LPIPS when converted AlexNet weights
are found and FID when converted InceptionV3 weights are found; it writes
a comparison strip every ``--save-every`` images (unlabelled: the column
order is printed into the summary) and ``results_summary.txt`` with the
deltas against the best baseline. It runs on one CUDA card unless
``--device cpu`` is given and raises when there is no card and no
``--device``.

FaceEnhanceNet, transfer and RRDBNet checkpoints load
(`models.load.load_any_model`); a file that does not load is skipped with
its reason. ``--serve-dtype`` f32 (the default), bf16 (the hand-written
group kernel in FaceEnhanceNet's trunk and the transfer head), int8
(weight-only) or int8_full (s8 convs); with int8_full, ``--calibrate N``
calibrates static activation scales on LR synthesised from the first N
evaluation images (else the scales are per-image dynamic); every family
serves in every dtype.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["main", "run", "parse_args", "find_checkpoints", "OPENCV_BASELINES", "STAGES"]

OPENCV_BASELINES = {"Bilinear": "linear", "Bicubic": "cubic", "Lanczos4": "lanczos4"}
EVAL_CHUNK = 256  # images decoded and scored at a time
# the stages whose host-clock seconds `run` returns (each device stage
# ends in a read to the host, so its time includes the device's)
STAGES = ("decode", "lr_synthesis", "model_forwards", "baseline_resizes", "skimage_metrics",
          "lpips", "inception_activations", "frechet", "strip_writes")


def find_checkpoints(checkpoint_dir: str) -> Dict[str, Path]:
    """Every ``.fckpt`` and ``.pth`` checkpoint, under friendly names (a
    ``.pth`` written in one save with a ``.fckpt`` of its stem by the
    port's Trainer counts once, as the ``.fckpt``); a name that a
    baseline or another checkpoint already has gets " (model)" appended."""
    from facesr_torch.models.load import checkpoint_files

    paths = sorted(checkpoint_files(checkpoint_dir))
    names: Dict[str, Path] = {}
    for p in paths:
        friendly = {"best_model": "Best Model", "final_model": "Final Model"}.get(
            p.stem, p.stem.replace("_", " ").title())
        while friendly in OPENCV_BASELINES or friendly in names:
            friendly += " (model)"
        names[friendly] = p
    return names


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Compare SR models vs OpenCV baselines "
                                                 "(PyTorch port)")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    parser.add_argument("--test-dir", "--hr-dir", dest="test_dir", type=str,
                        default="data/processed/test/HR")
    parser.add_argument("--output", "--output-dir", dest="output", type=str,
                        default="outputs/compare_models")
    parser.add_argument("--num-images", type=int, default=100)
    parser.add_argument("--save-every", type=int, default=20,
                        help="Save a comparison strip every N images")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--per-image", action="store_true",
                        help="Batch-1 f32 forwards instead of the batched path")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="Forward batch of the batched path (128 on CUDA, 8 on the CPU)")
    parser.add_argument("--serve-dtype", type=str, default=None,
                        choices=["f32", "bf16", "int8", "int8_full"],
                        help="Precision of the model forwards: f32 (default, the per-image "
                             "computation), bf16 (the group-kernel trunk), int8 or int8_full "
                             "(the quantized serving paths' quality against the baselines)")
    parser.add_argument("--calibrate", type=int, default=0, metavar="N",
                        help="with --serve-dtype int8_full: calibrate static activation "
                             "scales on LR synthesised from the first N eval images")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when omitted (raises without a card)")
    return parser.parse_args(argv)


def _center_crop(h: np.ndarray, scale: int) -> np.ndarray:
    """Crop an HR image to a multiple of ``scale`` on each side, centred,
    so the SR and HR shapes agree."""
    oy, ox = (h.shape[0] % scale) // 2, (h.shape[1] % scale) // 2
    return h[oy:oy + h.shape[0] // scale * scale, ox:ox + h.shape[1] // scale * scale]


def _calibration_lrs(files, scale: int, device) -> np.ndarray:
    """LR synthesised (the trainer's bicubic) from the readable ones of
    ``files``, as one batch of the first image's shape: the distribution
    the predictor serves."""
    from facesr_torch.data.png import read_rgb
    from facesr_torch.evaluation.batched import synthesize_lr_batched

    hrs = []
    for f in files:
        try:
            hrs.append(_center_crop(read_rgb(f), scale))
        except IOError:
            continue
    if not hrs:
        raise SystemExit(f"--calibrate: none of the first {len(files)} eval images were "
                         "readable")
    lrs = synthesize_lr_batched(hrs, scale, device=device)
    return np.stack([lr for lr in lrs if lr.shape == lrs[0].shape])


def run(argv: Optional[List[str]] = None) -> Optional[dict]:
    """Parse ``argv`` and evaluate. Returns ``{"summary": {method: {metric:
    value}}, "methods", "images", "timings": {stage: s}}``, or None when
    there are no test images."""
    args = parse_args(argv)
    if args.per_image and args.serve_dtype:
        raise SystemExit("--serve-dtype routes through the batched serving path; drop "
                         "--per-image (the per-image loop runs plain f32 forwards and would "
                         "mislabel the results)")

    import torch

    from facesr_torch.cli.test_model import compute_metrics
    from facesr_torch.data.cv_compat import resize
    from facesr_torch.data.dataset import _list_images
    from facesr_torch.data.png import read_rgb, write_png
    from facesr_torch.device import resolve_device
    from facesr_torch.evaluation.batched import (make_predictor, sr_batched,
                                                 synthesize_lr_batched, to_uint8)
    from facesr_torch.evaluation.fid import fid_from_activations, inception_activations
    from facesr_torch.evaluation.metrics import LPIPS
    from facesr_torch.models.inception import load_inception_weights
    from facesr_torch.models.load import load_any_model

    device = resolve_device(args.device)
    timings: Dict[str, float] = defaultdict(float)

    models = {}
    for name, path in find_checkpoints(args.checkpoint_dir).items():
        try:
            model = load_any_model(path, device=device)
        except Exception as e:  # noqa: BLE001 — an unloadable file is skipped, as in JAX
            print(f"Skipping {path}: {e}")
            continue
        models[name] = model
        print(f"Loaded {name} ({type(model).__name__}) from {path}")
    if not models:
        print(f"No loadable checkpoints in {args.checkpoint_dir}; "
              "evaluating OpenCV baselines only")

    lpips_fn = LPIPS(verbose=True)
    inception_weights = load_inception_weights(device=device)
    if inception_weights is None:
        print("Warning: InceptionV3 weights not found. FID column unavailable (set "
              "$FACESR_INCEPTION_WEIGHTS to converted weights).")

    test_dir = Path(args.test_dir)
    files = (_list_images(test_dir) if test_dir.is_dir() else [])[: args.num_images]
    if not files:
        print(f"No test images in {args.test_dir}")
        return None
    print(f"\nEvaluating on {len(files)} images...\n")

    methods = list(OPENCV_BASELINES) + list(models)
    all_metrics = {m: {"psnr": [], "ssim": [], "lpips": []} for m in methods}
    fid_acts = {m: [] for m in methods} if inception_weights is not None else None
    hr_acts = []
    out_dir = Path(args.output)
    (out_dir / "samples").mkdir(parents=True, exist_ok=True)
    dtype = {"bf16": torch.bfloat16, "int8": "int8",
             "int8_full": "int8_full"}.get(args.serve_dtype)
    predictors = None
    n_images = 0

    def clock(stage: str, t0: float) -> float:
        now = time.perf_counter()
        timings[stage] += now - t0
        return now

    for chunk_start in range(0, len(files), EVAL_CHUNK):
        t0 = time.perf_counter()
        chunk_files, hrs = [], []
        for f in files[chunk_start:chunk_start + EVAL_CHUNK]:
            try:
                hr = read_rgb(f)
            except IOError as e:  # a corrupt or unreadable file: skip it, go on
                print(f"  skipping unreadable image {f.name} ({e})")
                continue
            chunk_files.append(f)
            hrs.append(_center_crop(hr, args.scale))
        t0 = clock("decode", t0)
        if not hrs:
            continue
        n_images += len(hrs)
        lrs = synthesize_lr_batched(hrs, args.scale, device=device)
        t0 = clock("lr_synthesis", t0)
        if args.per_image:
            model_srs = {}
            with torch.inference_mode():
                for name, model in models.items():
                    model_srs[name] = [to_uint8(model(torch.from_numpy(lr[None]).to(device))
                                                .cpu().numpy()[0]) for lr in lrs]
        else:
            if predictors is None:  # once, even with zero models
                calibration = None
                if args.calibrate > 0 and args.serve_dtype == "int8_full":
                    calibration = _calibration_lrs(files[:args.calibrate], args.scale, device)
                predictors = {name: make_predictor(m, max_batch=args.batch_size, dtype=dtype,
                                                   device=device, calibration=calibration)
                              for name, m in models.items()}
            model_srs = {name: sr_batched(None, lrs, predictor=predictors[name])
                         for name in models}
        t0 = clock("model_forwards", t0)

        chunk_outputs = {name: [] for name in methods}
        for j, (hr, lr_f) in enumerate(zip(hrs, lrs)):
            i = chunk_start + j
            lr_uint8 = to_uint8(lr_f)
            t0 = time.perf_counter()
            outputs = {name: resize(lr_uint8, (hr.shape[1], hr.shape[0]), interp)
                       for name, interp in OPENCV_BASELINES.items()}
            t0 = clock("baseline_resizes", t0)
            for name in models:
                outputs[name] = model_srs[name][j]
            for name, out in outputs.items():
                chunk_outputs[name].append(out)
                for k, v in compute_metrics(out, hr).items():
                    all_metrics[name][k].append(v)
            t0 = clock("skimage_metrics", t0)
            if lpips_fn.available:
                b = torch.from_numpy(hr[None].astype(np.float32) / 255.0).to(device)
                for name, out in outputs.items():
                    a = torch.from_numpy(out[None].astype(np.float32) / 255.0).to(device)
                    all_metrics[name]["lpips"].append(float(lpips_fn(a, b)))
                t0 = clock("lpips", t0)
            if args.save_every and i % args.save_every == 0:
                strip = np.hstack([outputs[m] for m in methods] + [hr])
                write_png(out_dir / "samples" / f"compare_{i:04d}.png", strip)
                t0 = clock("strip_writes", t0)
            if (i + 1) % 25 == 0:
                print(f"  {i + 1}/{len(files)}")

        if fid_acts is not None:
            t0 = time.perf_counter()
            fid_batch = min(32, len(files))
            hr_acts.append(inception_activations(hrs, inception_weights, fid_batch, device))
            for name in methods:
                fid_acts[name].append(inception_activations(chunk_outputs[name],
                                                            inception_weights, fid_batch,
                                                            device))
            clock("inception_activations", t0)

    fid_values = None
    if fid_acts is not None and hr_acts:
        t0 = time.perf_counter()
        real = np.concatenate(hr_acts, axis=0)
        try:
            fid_values = {name: fid_from_activations(np.concatenate(fid_acts[name], axis=0),
                                                     real) for name in methods}
        except ValueError as e:  # fewer than 2 images: keep the PSNR/SSIM table
            print(f"Warning: FID column unavailable ({e})")
        clock("frechet", t0)
    if not n_images:
        print(f"No readable test images in {args.test_dir}")
        return None

    has_lpips = lpips_fn.available
    lines = []
    header = (f"{'Method':<16} {'PSNR (dB)':<12} {'SSIM':<10}"
              + (" LPIPS " if has_lpips else "")
              + (" FID" if fid_values is not None else ""))
    lines.append(header)
    lines.append("-" * len(header))
    summary: Dict[str, Dict[str, float]] = {}
    for name in methods:
        p = float(np.mean(all_metrics[name]["psnr"]))
        s = float(np.mean(all_metrics[name]["ssim"]))
        row = f"{name:<16} {p:<12.2f} {s:<10.4f}"
        summary[name] = {"psnr": p, "ssim": s}
        if has_lpips:
            lp = float(np.mean(all_metrics[name]["lpips"]))
            row += f" {lp:.4f}"
            summary[name]["lpips"] = lp
        if fid_values is not None:
            row += f" {fid_values[name]:.2f}"
            summary[name]["fid"] = fid_values[name]
        lines.append(row)

    best_baseline = max(OPENCV_BASELINES, key=lambda n: summary[n]["psnr"])
    lines.append("")
    lines.append(f"Best baseline: {best_baseline}")
    for name in models:
        dp = summary[name]["psnr"] - summary[best_baseline]["psnr"]
        ds = summary[name]["ssim"] - summary[best_baseline]["ssim"]
        delta = f"{name} vs {best_baseline}: {dp:+.2f} dB PSNR, {ds:+.4f} SSIM"
        if has_lpips:
            delta += f", {summary[name]['lpips'] - summary[best_baseline]['lpips']:+.4f} LPIPS"
        if fid_values is not None:
            delta += f", {fid_values[name] - fid_values[best_baseline]:+.2f} FID"
        lines.append(delta)
    if args.save_every:
        lines.append("")
        lines.append("Strip columns, left to right: " + ", ".join(methods + ["GT"]))

    report = "\n".join(lines)
    print("\n" + report)
    (out_dir / "results_summary.txt").write_text(report + "\n")
    print(f"\nSummary saved to {out_dir / 'results_summary.txt'}")
    return {"summary": summary, "methods": methods, "images": n_images,
            "timings": {k: timings.get(k, 0.0) for k in STAGES}}


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
