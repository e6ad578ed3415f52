#!/usr/bin/env python3
"""Drive the PyTorch port (facesr_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero; no phase
catches an error and goes on):

1. header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: every kernel of the serving path from the sources in this
   checkout (nvcc, sm_90a), with the ptxas register/smem/spill lines;
3. each kernel against its plain PyTorch version on the card, at the
   production shape, ragged ones, a width past one tile and a lone image,
   and two calls on the same input must agree bitwise;
4. the full 6x10x64 FaceEnhanceNet in bf16: kernel trunk against the plain
   trunk (conv_last redrawn non-zero), plain trunks with a planted fault
   as controls (the model limits must reject a dropped SE gate and a
   halved res_scale; the kernel tolerance must reject a bf16-rounded
   feature buffer at one group), and zero conv_last == bicubic;
5. serving, the main path: `Predictor(bf16, max_batch=128)` on one request
   of 130 images and eight concurrent single-image requests through
   `MicroBatcher`; the launch counters are zeroed just before and read
   just after, and every kernel must have run;
6. times on this card (CUDA events for kernels, host clock ending in
   synchronize for requests and the batch-1 forward), peak memory, the
   profiler's kernels of one group call and of two forwards, and the
   ptxas register/spill lines.

It prints the kernel table as one JSON line, then the nvidia-smi line,
then the result line ``{"ok": true, "device": {...}}`` last. Without a
CUDA card it exits non-zero and prints no result.
"""

import ctypes
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# kernel vs plain: bf16 output, another f32 summation order -> an element
# may round one bf16 ulp (<= 2**-7 relative) the other way
KERNEL_ATOL, KERNEL_RTOL = 2e-2, 2.0 ** -7
# model: the trunk's one-ulp differences compound over 6 groups and pass
# through four more bf16 convs (conv_after_body, two upsample stages,
# conv_last), so the bound is relative to the residual's own scale
# max|out - bicubic| (random weights make that residual large); the mean
# abs difference is held to the same share of mean|out - bicubic|
MODEL_RTOL = 2.0 ** -5
DEVICE = "cuda"
MAX_BATCH = 128                   # serving chunk, the production batch
REQUEST = 130                     # one full chunk plus a padded remainder
GROUP_TIMING = (128, 64, 64, 64, 10)  # N, H, W, C, B of the timed group call
# kernel vs plain: the production shape and a ragged one (bands of 2 and 3
# rows), each at a batch where every cluster takes one image and at one
# where clusters loop over several (the grid holds 7 to 15 clusters), so
# the next image's loads behind a tail conv run; a width past one 64-pixel
# tile with an H the band count does not divide (the scratch variant); a
# lone image (one cluster); and bands of 1 and 2 rows at an odd width
CHECK_SHAPES = (((4, 64, 64, 64), 10), ((128, 64, 64, 64), 10),
                ((3, 20, 36, 64), 3), ((40, 20, 36, 64), 3),
                ((2, 40, 80, 64), 2), ((1, 64, 64, 64), 10), ((2, 12, 17, 64), 2))
# plain groups with a planted fault, the controls for the limits: the
# model limits must reject the wiring faults; the rounding fault passes
# them (its reading is printed) and the kernel tolerance must reject it
WIRING_FAULTS = ("no_gate", "half_res_scale")
ROUNDING_FAULT = "bf16_feat"


def log(msg=""):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, iters, warmup=2) -> float:
    """Mean device time of fn() in ms: CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def seeded_group(B, seed):
    """One ResidualGroup (C=64, r=4) from a seeded generator, biases and
    PReLU slopes moved off their init so every term of the kernel counts."""
    from facesr_torch.models import blocks

    gen = torch.Generator().manual_seed(seed)
    group = blocks.make_residual_groups(1, B, 64, 3, 4, gen)[0]
    with torch.no_grad():
        for name, p in group.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
            elif name.endswith("prelu.weight"):
                p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return group


def group_weights(group, dev):
    from facesr_torch.ops.rcab_group import prepare_group_weights

    return {k: v.to(dev) for k, v in prepare_group_weights(group).items()}


def group_bound(n, h, w, c, B, cr):
    """(bound_ms, bound_by) of one group call: operations over the bf16 peak
    vs bytes (x and out once, the weights once) over the HBM rate."""
    flops = 2.0 * n * h * w * 9 * c * c * (2 * B + 1)
    weight_bytes = (B * (2 * 9 * c * c * 2 + 3 * c * 4 + 2 * c * cr * 4)
                    + 9 * c * c * 2 + c * 4)
    nbytes = 2.0 * n * h * w * c * 2 + weight_bytes
    t_ops, t_bytes = flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def library_group(x, gw, res_scale):
    """The same group with cuDNN bf16 channels_last convolutions and torch
    elementwise ops: the yardstick `library_ms` (the port never calls it)."""
    import torch.nn.functional as F

    def conv(t, w_mat, b):
        w = w_mat.reshape(3, 3, 64, 64).permute(3, 2, 0, 1)  # OIHW
        y = F.conv2d(t.to(torch.bfloat16).permute(0, 3, 1, 2), w, padding=1)
        return y.permute(0, 2, 3, 1).float() + b

    feat = x.float()
    for k in range(gw["w1"].shape[0]):
        t = conv(feat, gw["w1"][k], gw["b1"][k])
        t = torch.where(t >= 0, t, gw["a"][k] * t)
        t = conv(t, gw["w2"][k], gw["b2"][k])
        y = torch.sigmoid(torch.relu(t.mean(dim=(1, 2)) @ gw["fc1"][k]) @ gw["fc2"][k])
        feat = feat + (t * y[:, None, None, :]) * res_scale
    return (conv(feat, gw["wg"], gw["bg"]) + x.float()).to(torch.bfloat16)


def group_diff(got, want):
    """(max abs, mean abs, share of elements that differ, excess over the
    kernel tolerance) of two bf16 group outputs."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    excess = (diff - (KERNEL_ATOL + KERNEL_RTOL * want.abs())).max().item()
    return (diff.max().item(), diff.mean().item(), (diff > 0).float().mean().item(),
            excess)


def check_kernel(dev, shape, B, seed):
    from facesr_torch.ops.rcab_group import fused_residual_group, rcab_group_reference

    gw = group_weights(seeded_group(B, seed), dev)
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(shape, generator=gen).to(torch.bfloat16).to(dev)
    got = fused_residual_group(x, gw, 0.2)
    again = fused_residual_group(x, gw, 0.2)
    torch.cuda.synchronize()
    want = rcab_group_reference(x, gw, 0.2)
    max_abs, mean_abs, share, excess = group_diff(got, want)
    repeat = torch.equal(got, again)
    log(f"  {tuple(shape)} B={B} ({kernel_variant(shape)}): max_abs={max_abs:.6g} "
        f"mean_abs={mean_abs:.6g} differing={share:.6g} "
        f"max|ref|={want.float().abs().max().item():.4g} "
        f"finite={bool(torch.isfinite(got).all())} repeat bitwise equal={repeat}")
    if not torch.isfinite(got).all() or excess > 0:
        raise AssertionError(f"kernel disagrees with its plain version at {shape}: "
                             f"max_abs={max_abs} exceeds {KERNEL_ATOL} + "
                             f"{KERNEL_RTOL}*|ref| by {excess}")
    if not repeat:
        raise AssertionError(f"two kernel calls on the same input differ at {shape}: "
                             "the design claims fixed-order sums")
    return max_abs


def kernel_variant(shape):
    """The launch the kernel's plan picks for an NHWC shape."""
    from facesr_torch.ops import rcab_group as rg

    n, h, w, _ = shape
    clusters, size, scratch = rg._plan(rg._lib(), n, h, w)
    return (f"{'scratch' if scratch else 'resident'}, {clusters} cluster(s) of {size}")


def planted_fault_group(x, gw, res_scale, fault):
    """`rcab_group_reference` with one planted fault, the control that shows
    a check rejects a wrong trunk: "no_gate" drops the SE gate,
    "half_res_scale" halves res_scale, "bf16_feat" rounds the f32 feature
    accumulator to bf16 after every RCAB."""
    from facesr_torch.ops.conv import conv2d

    def bf(t):
        return t.to(torch.bfloat16).float()

    def conv(t, w_mat, b):
        w = w_mat.reshape(3, 3, 64, 64).permute(3, 2, 0, 1)  # OIHW
        return conv2d(bf(t), bf(w), b, padding=1)

    scale = res_scale / 2 if fault == "half_res_scale" else res_scale
    x32 = bf(x)
    feat = x32
    for k in range(gw["w1"].shape[0]):
        t = conv(feat, gw["w1"][k], gw["b1"][k])
        t = torch.where(t >= 0, t, gw["a"][k] * t)
        t = conv(t, gw["w2"][k], gw["b2"][k])
        if fault != "no_gate":
            y = torch.sigmoid(torch.relu(t.mean(dim=(1, 2)) @ gw["fc1"][k]) @ gw["fc2"][k])
            t = t * y[:, None, None, :]
        feat = feat + t * scale
        if fault == "bf16_feat":
            feat = bf(feat)
    return (conv(feat, gw["wg"], gw["bg"]) + x32).to(torch.bfloat16)


def production_config():
    from facesr_torch.models.face_enhance_net import FaceEnhanceNetConfig

    return FaceEnhanceNetConfig(num_groups=6, blocks_per_group=10, num_channels=64)


def production_model(dev, nonzero_last):
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.ops.init import kaiming_normal

    model = FaceEnhanceNet(production_config(), seed=0, device=dev).eval()
    if nonzero_last:
        # the zero init makes the output bicubic and hides any trunk error
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            w = model.conv_last.weight
            w.copy_(kaiming_normal(w.shape, gen, scale=0.1))
    return model


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from facesr_torch.ops import _build
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.ops.rcab_group import (fused_residual_group, prepare_group_weights,
                                             rcab_group_reference)
    from facesr_torch.ops.resize import bicubic_up
    from facesr_torch.parallel.serving import MicroBatcher, Predictor, build_serving_fn

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"== 1. header\n  nvidia-smi: {card}\n  torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s), {kind}")

    log("== 2. build (nvcc, sm_90a)")
    t0 = time.perf_counter()
    _build.build_all(["rcab_group"])
    log(f"  built in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs().items():
        for line in text.splitlines():
            if any(s in line for s in ("registers", "spill", "smem", "Compiling entry")):
                log(f"  {name}: {line.strip()}")
    lib = _build.load_library("rcab_group")
    lib.rcab_group_smem_bytes.argtypes = [ctypes.c_int]
    lib.rcab_group_smem_bytes.restype = ctypes.c_int
    log(f"  dynamic shared memory a block: resident {lib.rcab_group_smem_bytes(1)} bytes, "
        f"scratch {lib.rcab_group_smem_bytes(0)} bytes")

    log(f"== 3. kernel vs plain (|diff| <= {KERNEL_ATOL} + 2^-7*|ref|: bf16 output, "
        "another f32 summation order)")
    max_err = max(check_kernel(dev, shape, B, seed=i)
                  for i, (shape, B) in enumerate(CHECK_SHAPES))

    cfg = production_config()
    log(f"== 4. FaceEnhanceNet {cfg.num_groups}x{cfg.blocks_per_group}x{cfg.num_channels} bf16, batch 4 (kernel trunk vs plain trunk, "
        f"max and mean abs <= {MODEL_RTOL} * max and mean |out - bicubic|: the "
        "trunk's bf16-ulp differences compound and pass through four more bf16 convs)")
    model = production_model(dev, nonzero_last=True)
    x4 = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    res_scale = model.config.res_scale

    def trunk_of(group_fn):
        def trunk(groups, feat):
            for g in groups:
                feat = group_fn(feat, group_weights(g, dev))
            return feat
        return trunk

    plain_trunk = trunk_of(lambda f, gw: rcab_group_reference(f, gw, res_scale))
    with torch.inference_mode():
        out_k = model(x4, train=True, dtype=torch.bfloat16)
        out_p = model(x4, train=True, dtype=torch.bfloat16, trunk_fn=plain_trunk)
        resid = (out_p - bicubic_up(x4, 4)).abs()
        limit_max = MODEL_RTOL * resid.max().item()
        limit_mean = MODEL_RTOL * resid.mean().item()

        def model_check(name, out):
            d = (out - out_p).abs()
            mx, mean = d.max().item(), d.mean().item()
            ok = mx <= limit_max and mean <= limit_mean
            log(f"  {name}: max_abs={mx:.6g} (limit {limit_max:.6g}) mean_abs={mean:.6g} "
                f"(limit {limit_mean:.6g}) -> {'within' if ok else 'rejected'}")
            return ok

        log(f"  out {tuple(out_k.shape)}: max|out-bicubic|={resid.max().item():.6g} "
            f"mean|out-bicubic|={resid.mean().item():.6g}")
        if out_k.shape != (4, 256, 256, 3) or not torch.isfinite(out_k).all():
            raise AssertionError("model output has the wrong shape or is not finite")
        if not model_check("kernel trunk", out_k):
            raise AssertionError("kernel trunk disagrees with the plain trunk")
        for fault in WIRING_FAULTS + (ROUNDING_FAULT,):
            faulty = trunk_of(lambda f, gw: planted_fault_group(f, gw, res_scale, fault))
            rejected = not model_check(f"planted fault {fault}", model(
                x4, train=True, dtype=torch.bfloat16, trunk_fn=faulty))
            if fault in WIRING_FAULTS and not rejected:
                raise AssertionError(f"the model limits let the planted fault {fault} pass")
        # the rounding fault against the kernel tolerance, at one group
        shape, B = CHECK_SHAPES[0]
        gw = group_weights(seeded_group(B, 0), dev)
        xg = torch.rand(shape, generator=torch.Generator().manual_seed(0)).to(
            torch.bfloat16).to(dev)
        mx, mean, share, excess = group_diff(
            planted_fault_group(xg, gw, 0.2, ROUNDING_FAULT), rcab_group_reference(xg, gw, 0.2))
        log(f"  planted fault {ROUNDING_FAULT}, one group {shape} B={B} vs plain: "
            f"max_abs={mx:.6g} mean_abs={mean:.6g} differing={share:.6g} -> "
            f"{'rejected' if excess > 0 else 'within'} the kernel tolerance")
        if excess <= 0:
            raise AssertionError(f"the kernel tolerance lets the planted fault "
                                 f"{ROUNDING_FAULT} pass")
        zero_last = production_model(dev, nonzero_last=False)
        out_z = zero_last(x4, train=True, dtype=torch.bfloat16)
        if not torch.equal(out_z, bicubic_up(x4, 4)):
            raise AssertionError("zero conv_last model does not equal bicubic_up")
        log("  zero conv_last model == bicubic_up: exact")
        del zero_last, out_z, out_k, out_p

    log(f"== 5. serving (main path): Predictor(bf16, max_batch={MAX_BATCH}) + MicroBatcher")
    pred = Predictor(model, dtype=torch.bfloat16, max_batch=MAX_BATCH, device=dev)
    rng = np.random.default_rng(3)
    request = rng.random((REQUEST, 64, 64, 3), dtype=np.float32)
    singles = rng.random((8, 64, 64, 3), dtype=np.float32)
    rg.fused_residual_group.launches = 0  # every kernel's count, just before the main path
    t0 = time.perf_counter()
    out = pred(request)
    mb = MicroBatcher(pred, max_batch=min(8, MAX_BATCH), window_ms=20.0)  # one chunk each
    results = [None] * len(singles)

    def client(i):
        results[i] = mb(singles[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(singles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    mb.close()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {"fused_residual_group": rg.fused_residual_group.launches}  # just after
    chunks = math.ceil(REQUEST / MAX_BATCH) + mb.calls
    per_chunk = cfg.num_groups
    log(f"  {REQUEST}-image request + {len(singles)} single requests in {mb.calls} "
        f"micro-batch(es): {chunks} chunk forwards, {main_s:.2f} s; launches {launches}")
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("a MicroBatcher request did not complete")
    singles_out = np.stack(results)
    for name, arr, n in (("request", out, REQUEST), ("singles", singles_out, len(singles))):
        if arr.shape != (n, 256, 256, 3) or not np.isfinite(arr).all() \
                or arr.min() < 0 or arr.max() > 1:
            raise AssertionError(f"{name} output: shape {arr.shape}, finite "
                                 f"{np.isfinite(arr).all()}, range [{arr.min()}, {arr.max()}]")
    direct = pred(singles)
    if not np.allclose(singles_out, direct, atol=1e-5):
        raise AssertionError("MicroBatcher results differ from one Predictor call: "
                             f"{np.abs(singles_out - direct).max()}")
    if launches["fused_residual_group"] != per_chunk * chunks:
        raise AssertionError(f"expected {per_chunk} group-kernel launches per chunk "
                             f"forward ({per_chunk * chunks}), counted {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    log(f"  outputs [N,256,256,3] finite in [0,1]; {launches['fused_residual_group']} "
        f"group launches = {per_chunk} per chunk forward")

    log(f"== 6. times on this card ({card})")
    fwd = build_serving_fn(model, torch.bfloat16)
    x128 = torch.from_numpy(request[:MAX_BATCH]).to(dev)
    for _ in range(2):
        fwd(x128)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        fwd(x128)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    fwd_med = statistics.median(fwd_s)
    log(f"  forward batch {MAX_BATCH} bf16 (device-resident input): median of 3 "
        f"{fwd_med * 1e3:.3f} ms = {MAX_BATCH / fwd_med:.1f} images/s [{card}]")
    log(f"  peak device memory of that forward: {peak_gib:.3f} GiB [{card}]")
    pred_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred(request[:MAX_BATCH])
        torch.cuda.synchronize()
        pred_s.append(time.perf_counter() - t0)
    pred_med = statistics.median(pred_s)
    log(f"  Predictor {MAX_BATCH} images numpy in/out: median of 3 "
        f"{pred_med * 1e3:.3f} ms = {MAX_BATCH / pred_med:.1f} images/s [{card}]")

    def host_ms(fn, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    x1 = x128[:1].contiguous()
    fwd(x1)
    one_ms = host_ms(lambda: fwd(x1), reps=5)
    prep_ms = host_ms(lambda: [prepare_group_weights(g) for g in model.residual_groups], 3)
    log(f"  forward batch 1 bf16 (device-resident input): median of 5 {one_ms:.3f} ms; "
        f"preparing the {cfg.num_groups} groups' kernel weights, which a forward "
        f"reuses until they change: median of 3 {prep_ms:.3f} ms [{card}]")

    n, h, w, c, B = GROUP_TIMING
    gw = group_weights(seeded_group(B, seed=4), dev)
    cr = gw["fc1"].shape[-1]
    xg = torch.rand((n, h, w, c), generator=torch.Generator().manual_seed(5)).to(
        torch.bfloat16).to(dev)
    kernel_ms = cuda_ms(lambda: fused_residual_group(xg, gw, 0.2), iters=10)
    plain_ms = cuda_ms(lambda: rcab_group_reference(xg, gw, 0.2), iters=3, warmup=1)
    library_ms = cuda_ms(lambda: library_group(xg, gw, 0.2), iters=10)
    bound_ms, bound_by = group_bound(n, h, w, c, B, cr)
    log(f"  one group call N={n} {h}x{w} C={c} B={B} ({kernel_variant(xg.shape)}): kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library (cuDNN bf16) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    x1g = xg[:1].contiguous()
    lone_ms = cuda_ms(lambda: fused_residual_group(x1g, gw, 0.2), iters=20)
    log(f"  one group call N=1 ({kernel_variant(x1g.shape)}): kernel {lone_ms:.4f} ms [{card}]")

    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused_residual_group(xg, gw, 0.2)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(getattr(e, "device_type", None), "name", "") == "CUDA" and dev_us(e) > 0]
    log(f"  profiler, one group call N={n}: {len(rows)} device kernel(s) [{card}]")
    for e in sorted(rows, key=lambda e: -dev_us(e)):
        log(f"    {dev_us(e) / 1e3:9.4f} ms  x{e.count:<3} {e.key[:100]}")
    for text in _build.build_logs().values():
        for line in text.splitlines():
            if any(s in line for s in ("registers", "spill")):
                log(f"  ptxas: {line.strip()}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd(x128)
        fwd(x128)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(getattr(e, "device_type", None), "name", "") == "CUDA"]
    total_us = sum(dev_us(e) for e in events)
    if total_us > 0:
        log(f"  profiler, 2 forwards at batch {MAX_BATCH}: {total_us / 2e3:.3f} ms "
            f"device time a forward; top kernels by device time [{card}]:")
        for e in sorted(events, key=lambda e: -dev_us(e))[:12]:
            log(f"    {dev_us(e) / total_us * 100:6.2f}%  {dev_us(e) / 2e3:9.4f} ms/fwd"
                f"  x{e.count // 2:<4} {e.key[:90]}")
    else:
        log("  profiler: no device time recorded")

    log(f"  total script time {time.perf_counter() - t_start:.1f} s")
    table = {"kernels": [{
        "name": "fused_residual_group",
        "route": "cuda",
        "source": "facesr_torch/csrc/rcab_group.cu",
        "replaces": "facesr/ops/pallas/rcab_group.py:90",
        "launches": launches["fused_residual_group"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
