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
   production shape, ragged ones, a width past one tile, a lone image and
   the scratch variant spread over many clusters (one 256x256 image over
   every SM, ragged units, several images sharing the clusters), on
   inputs whose rows darken towards the top; two calls on the same input
   must agree bitwise;
4. the full 6x10x64 FaceEnhanceNet in bf16: kernel trunk against the plain
   trunk (conv_last redrawn non-zero), plain trunks with a planted fault
   as controls (the model limits must reject a dropped SE gate and a
   halved res_scale; the kernel tolerance must reject a bf16-rounded
   feature buffer at one group, and an SE mean over half the rows at
   phase 3's 256x256 check), and zero conv_last == bicubic;
5. serving, the main path: `Predictor(bf16, max_batch=128)` on one request
   of 130 images and eight concurrent single-image requests through
   `MicroBatcher`; the launch counters are zeroed just before and read
   just after, and every kernel must have run;
6. times on this card (CUDA events for kernels, host clock ending in
   synchronize for requests and the batch-1 forward), peak memory, the
   profiler's kernels of one group call and of two forwards, and the
   ptxas register/spill lines;
7. stage-1 content training, the second path: one small f32 step on the
   card against the same step on the CPU (loss, every gradient, every
   updated parameter), with a control that forces TF32 convs and must be
   rejected; the production step (6x10x64 f32, batch 48, HR 256, L1 + VGG19
   conv3_4, AdamW) for 2 warm-up and 6 timed steps on one batch, whose
   losses must be finite and fall and which must launch no kernel of the
   port (the group kernel is forward-only); its ms/step, images/s, peak
   memory, host syncs, profiler breakdown and the VGG and trunk shares;
   then `Trainer.train()` for 2 epochs with its checkpoints written,
   resumed bitwise and reloaded weights-only;
8. the training entry point on PNG files: a set of 240 training HR images
   (256x256, HR-only) and 48 validation HR + LR pairs written with the
   port's PNG encoder, 48 of them decoded back bitwise; the stage-1
   training loader alone as the CLI builds it, with and without
   ``--fast-loader`` (images/s, single-thread decode ms an image); then
   ``python -m facesr_torch.cli.train`` in this process with
   ``configs/stages/stage1_psnr_config.yaml``, then
   ``stage2_ssim_config.yaml`` and ``stage3_gan_config.yaml`` (GAN), all
   unchanged, for one epoch each (its ms/step and loader wait against
   phase 7's step alone); stage 2 must chain from stage 1's
   ``best_model.pth`` bitwise and stage 3 from stage 2's, whose
   discriminator loss history must be finite; controls: a corrupt
   PNG stops the loader with its name, and the CLI without ``--device``
   on a process that sees no card raises;
9. evaluation, the third path: seeded random LPIPS and FID-Inception
   weights written as ``.fckpt`` by the port's writer; Inception
   activations, LPIPS and FID on the card against the CPU, with a control
   that forces TF32 and must be rejected; ``python -m
   facesr_torch.cli.test_model`` in this process on phase 8's 48
   validation PNGs with stage 1's ``best_model.pth``, batched and
   ``--per-image``; ``python -m facesr_torch.cli.compare_two_models`` on
   them with stage 1's two checkpoints, LPIPS and FID on, once with
   ``--serve-dtype f32`` (no kernel launch) and once with ``bf16`` (the
   group kernel, the launch counters zeroed just before and read just
   after; under the CUDA profiler for the device-busy share): baseline
   rows bitwise equal across the two, the models' bf16 PSNR within 0.1 dB
   of f32; seconds by stage, images/s, Inception images/s at batch 32 and
   LPIPS ms a pair;
10. GAN training (stage 3), the fourth path: one small GAN step on the
   card against the same step on the CPU (losses, every G and D gradient,
   every updated parameter, the BatchNorm running stats), with a control
   that forces TF32 and must be rejected; the production GAN step
   (6x10x64 f32, batch 48, HR 256, L1 0.01 + VGG19 conv3_4 1.0 + vanilla
   GAN 0.005, the discriminator at 256 with 64 channels and BatchNorm; G
   AdamW lr 1e-5 clip 0.5, D lr 1e-4) for 2 warm-up and 6 timed steps on
   one batch, whose losses must be finite and which must launch no kernel
   of the port (the counters zeroed just before and read just after); its
   ms/step, images/s, profiler device time, the discriminator's share and
   peak memory; then `Trainer.train()` with the GAN from epoch 1 of 2,
   resumed bitwise (G, D, BatchNorm stats, both optimisers), and a
   content checkpoint resumed into a GAN trainer (a fresh D, the GAN
   history backfilled).

11. the serving stack, the fifth path: `Predictor(bf16, max_batch=128)` on
   one 130-image request (chunks of 128 and 2 at their true sizes, 12
   launches), each chunk bitwise equal to the model's direct forward,
   with its pinned upload and download times beside phase 6's;
   `SpatialPredictor` at 1x256x256 (the group kernel's scratch variant)
   and 1x96x96, bitwise equal to the direct forward, whose unclamped
   output is held to phase 4's limits of the plain trunk, 6 launches a
   call, its time and peak memory, and one group call at N=1 256x256
   (the scratch variant over every SM), eager and replayed from a CUDA
   graph, against the plain version, cuDNN (eager and graphed), the bound
   and the design's scratch traffic at the HBM rate: the kernel must be
   ahead of graphed cuDNN both ways; `export_serving` in bf16 with a symbolic
   batch written as a ``.pt2``, loaded and run at batch 1 and 8, bitwise
   equal to `Predictor` (the kernel through the custom op, 6 launches a
   call); the HTTP API in this process on a ``.fckpt`` of the model
   written by the port, three ways (``--dtype bf16``, with
   ``--batch-window-ms 20 --max-batch 16``, and ``--exported``), each
   driven by 16 keep-alive clients x 8 64x64 PNGs plus 4 256x256 PNGs:
   every response exactly `Predictor`'s uint8 output on its LR at batch 1
   (micro-batched: at its cohort's batch size, every cohort recorded by
   the server and recomputed), launches = 6 x forwards,
   requests/s, p50/p99 latency and the batching factor from ``/health``;
   controls (an f32 server launches nothing, a JPEG body gets 400, ``--dtype
   int8`` raises at startup); one request's host time split into PNG
   decode, `prepare_inputs`, the forward and PNG encode.

It prints the kernel table as one JSON line, then the nvidia-smi line,
then the result line ``{"ok": true, "device": {...}}`` last. Without a
CUDA card it exits non-zero and prints no result.
"""

import contextlib
import ctypes
import http.client
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
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
REQUEST = 130                     # one full chunk and a remainder of 2
GROUP_TIMING = (128, 64, 64, 64, 10)  # N, H, W, C, B of the timed group call
# kernel vs plain: the production shape and a ragged one (bands of 2 and 3
# rows), each at a batch where every cluster takes one image and at one
# where clusters loop over several (the grid holds 7 to 15 clusters), so
# the next image's loads behind a tail conv run; a width past one 64-pixel
# tile with an H the band count does not divide (the scratch variant); a
# lone image (one cluster); bands of 1 and 2 rows at an odd width; and the
# scratch variant spread over many clusters: one 256x256 image over every
# cluster (SpatialPredictor's shape), ragged 4-row units and a partial
# column tile, several images sharing the card's clusters, and more images
# than it keeps in flight (16), so each slot loops over five. Uniform
# noise, and from entry RAMP_FROM on the rows darken towards the top
# (`check_input`), so that an SE mean over part of an image shows
CHECK_SHAPES = (((4, 64, 64, 64), 10), ((128, 64, 64, 64), 10),
                ((3, 20, 36, 64), 3), ((40, 20, 36, 64), 3),
                ((2, 40, 80, 64), 2), ((1, 64, 64, 64), 10), ((2, 12, 17, 64), 2),
                ((1, 256, 256, 64), 10), ((1, 130, 200, 64), 2), ((3, 96, 96, 64), 3),
                ((80, 40, 80, 64), 2))
RAMP_FROM = 7
# plain groups with a planted fault, the controls for the limits: the
# model limits must reject the wiring faults; the rounding fault passes
# them (its reading is printed) and the kernel tolerance must reject it;
# so must it reject an SE mean over the first half of the rows only (what
# an image spread over clusters computes without the image-wide sum), at
# the shape and input of the 256x256 check
WIRING_FAULTS = ("no_gate", "half_res_scale")
ROUNDING_FAULT = "bf16_feat"
SPLIT_FAULT, SPLIT_CHECK = "half_image_se", 7  # the fault and its CHECK_SHAPES entry
# training: the stage-1 batch (48 images of HR 256x256), warm-up and timed
# steps on one repeated batch; the Trainer phase's smaller batches
TRAIN_BATCH, TRAIN_HR, TRAIN_WARMUP, TRAIN_TIMED = 48, 256, 2, 6
TRAINER_BATCH = 8
# CUDA step vs CPU step in f32, relative L2 per tensor: other summation
# orders give ~1e-7-1e-6; TF32 convs (10-bit mantissa) ~3e-4 and more
STEP_RTOL = 1e-4


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


def graph_ms(fn, iters, reps=1) -> float:
    """Device time of fn() in ms, replayed from one CUDA graph, so the
    host's launch rate does not set it: the median of `reps` means."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return statistics.median(cuda_ms(graph.replay, iters) for _ in range(reps))


def host_ms(fn, reps) -> float:
    """Median host time of fn() in ms, each call ending in synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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


def scratch_traffic_bytes(n, h, w, c, B):
    """Bytes of global scratch that the scratch variant's design moves in a
    group call: an RCAB reads bf16(feat) and writes t1 (conv1), reads t1
    and writes f32 t2 (conv2), reads feat and t2 and writes feat and
    bf16(feat) (the update): 24 bytes a pixel-channel; the tail conv reads
    bf16(feat) and x and writes out."""
    return n * h * w * c * (24 * B + 3 * 2)


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


def check_input(shape, seed, dev, ramp=True):
    """bf16 NHWC uniform noise; with `ramp`, its rows darken towards the top
    (times a ramp from 0.1 to 1 over the rows), so that channel means over
    part of the rows differ from the image's, as in a face crop."""
    x = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
    if ramp:
        x = x * torch.linspace(0.1, 1.0, shape[1]).reshape(1, -1, 1, 1)
    return x.to(torch.bfloat16).to(dev)


def check_kernel(dev, shape, B, seed, ramp):
    from facesr_torch.ops.rcab_group import fused_residual_group, rcab_group_reference

    gw = group_weights(seeded_group(B, seed), dev)
    x = check_input(shape, seed, dev, ramp)
    got = fused_residual_group(x, gw, 0.2)
    again = fused_residual_group(x, gw, 0.2)
    torch.cuda.synchronize()
    want = rcab_group_reference(x, gw, 0.2)
    max_abs, mean_abs, share, excess = group_diff(got, want)
    repeat = torch.equal(got, again)
    log(f"  {tuple(shape)} B={B} {'ramp' if ramp else 'uniform'} ({kernel_variant(shape)}): "
        f"max_abs={max_abs:.6g} "
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
    clusters, size, scratch, per_image = rg._plan(rg._lib(), n, h, w)
    return (f"{'scratch' if scratch else 'resident'}, {clusters} cluster(s) of {size}, "
            f"{per_image} an image, {clusters * size} SMs")


def planted_fault_group(x, gw, res_scale, fault):
    """`rcab_group_reference` with one planted fault, the control that shows
    a check rejects a wrong trunk: "no_gate" drops the SE gate,
    "half_res_scale" halves res_scale, "bf16_feat" rounds the f32 feature
    accumulator to bf16 after every RCAB, "half_image_se" takes the SE mean
    over the first half of the rows only."""
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
            part = t[:, :t.shape[1] // 2] if fault == "half_image_se" else t
            y = torch.sigmoid(torch.relu(part.mean(dim=(1, 2)) @ gw["fc1"][k]) @ gw["fc2"][k])
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


def stage1_loss(dev):
    """The stage-1 loss (L1 1.0 + VGG19 perceptual 1.0 at conv3_4, ImageNet
    normalisation), random VGG from seed 0."""
    from facesr_torch.losses.combined import CombinedLoss, LossConfig

    cfg = LossConfig(l1_weight=1.0, perceptual_weight=1.0, ssim_weight=0.0,
                     perceptual_layers=["conv3_4"])
    return CombinedLoss(cfg, seed=0, device=dev)


def smooth_hr(n, size, seed, dev):
    """Smooth HR images in [0, 1]: seeded 8x8 noise, bicubic up to size."""
    from facesr_torch.ops.resize import bicubic_up

    lo = np.random.default_rng(seed).random((n, 8, 8, 3), dtype=np.float32)
    return bicubic_up(torch.from_numpy(lo).to(dev), size // 8).clamp(0.0, 1.0).contiguous()


def train_step_conv_flops(cfg, n, hr_size):
    """3x3 conv work of one stage-1 step, from the shapes: the model's
    forward, its input and weight gradients (none for conv_first's input),
    the remat recompute of every RCAB's two convs, the VGG19 pred sweep to
    conv3_4 forward and input gradient (its weights are frozen) and the
    target sweep forward."""
    def conv(h, cin, cout):
        return 2.0 * n * h * h * 9 * cin * cout

    lr_size, c = hr_size // 4, cfg.num_channels
    trunk = cfg.num_groups * (2 * cfg.blocks_per_group + 1) * conv(lr_size, c, c)
    rcab_convs = cfg.num_groups * 2 * cfg.blocks_per_group * conv(lr_size, c, c)
    first = conv(lr_size, cfg.in_channels, c)
    rest = (conv(lr_size, c, c) + conv(lr_size, c, 4 * c) + conv(2 * lr_size, c, 4 * c)
            + conv(hr_size, c, cfg.out_channels))
    vgg = (conv(hr_size, 3, 64) + conv(hr_size, 64, 64) + conv(hr_size // 2, 64, 128)
           + conv(hr_size // 2, 128, 128) + conv(hr_size // 4, 128, 256)
           + 3 * conv(hr_size // 4, 256, 256))
    model = first + trunk + rest
    return 3 * model - first + rcab_convs + 3 * vgg


F32_PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def production_step_fn(dev):
    """Stage-1 training at the production width, the YAML's values written
    out (the card has no PyYAML): FaceEnhanceNet 6x10x64 (remat save_ca),
    f32, L1 + perceptual conv3_4, AdamW lr 1e-4, wd 0, clip 0.5,
    vgg_remat off. conv_last is redrawn non-zero: from the zero init the
    output is the bicubic skip, and the first steps move away from it
    before the loss falls. Returns (state, step, loss)."""
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.ops.init import kaiming_normal
    from facesr_torch.training import steps
    from facesr_torch.training.optim import AdamW

    model = FaceEnhanceNet(production_config().replace(remat="save_ca"), seed=0, device="cpu")
    with torch.no_grad():
        model.conv_last.weight.copy_(kaiming_normal(model.conv_last.weight.shape,
                                                    torch.Generator().manual_seed(1), scale=0.1))
    model.to(dev)
    loss = stage1_loss(dev)
    opt = AdamW(weight_decay=0.0, gradient_clip=0.5)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), 1e-4),
                             loss_params=loss.params)
    step = steps.make_train_step(lambda lp, p, t: loss.apply(lp, p, t, vgg_remat=False), opt,
                                 compute_dtype=None)
    return state, step, loss


def trainer_phase(dev):
    """`Trainer.train()` on the production model: 2 epochs of 2 batches,
    one validation batch; checkpoints written, resumed and reloaded."""
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    train = [{"hr": smooth_hr(TRAINER_BATCH, TRAIN_HR, seed=20 + i, dev="cpu").numpy()}
             for i in range(2)]
    val = [{"hr": smooth_hr(TRAINER_BATCH, TRAIN_HR, seed=30, dev="cpu").numpy()}]

    def trainer(ckpt_dir, epochs, seed):
        cfg = TrainerConfig(epochs=epochs, learning_rate=1e-4, weight_decay=0.0,
                            gradient_clip=0.5, use_amp=False, scheduler_T_max=100,
                            save_every=1, checkpoint_dir=ckpt_dir, ema_decay=0.999,
                            early_stopping_metric="val_loss", early_stopping_mode="min")
        model = FaceEnhanceNet(production_config(), seed=seed, device="cpu")
        return Trainer(model, train, val, stage1_loss("cpu"), cfg, device=dev)

    def same(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        return torch.equal(a, b)

    with tempfile.TemporaryDirectory(prefix="facesr_torch_ckpt_") as d:
        tr = trainer(d, epochs=2, seed=0)
        t0 = time.perf_counter()
        history = tr.train()
        train_s = time.perf_counter() - t0
        files = sorted(p.name for p in Path(d).iterdir())
        log(f"  Trainer.train(): 2 epochs x 2 batches of {TRAINER_BATCH} + 1 validation batch "
            f"in {train_s:.2f} s; history {json.dumps(history)}; files {files}")
        want_files = ["best_model.pth", "epoch_1.pth", "epoch_2.pth", "final_model.pth"]
        if files != want_files:
            raise AssertionError(f"checkpoint files {files}, want {want_files}")
        if tr._ckpt_pool is not None or tr._ckpt_futures:
            raise AssertionError("the async checkpoint writer did not flush in train()")
        if tr.global_step != 4 or not all(len(v) == 2 and all(math.isfinite(x) for x in v)
                                          for v in history.values()):
            raise AssertionError(f"trainer history or step count wrong: {tr.global_step}")
        resumed = trainer(d, epochs=3, seed=1)
        resumed.load_checkpoint(str(Path(d) / "final_model.pth"))
        full = (same(resumed.model.state_dict(), tr.model.state_dict())
                and same(resumed.state.opt_state, tr.state.opt_state)
                and same(resumed.state.ema_params, tr.state.ema_params)
                and resumed.current_epoch == 2 and resumed.global_step == 4)
        fresh = trainer(d, epochs=1, seed=2)
        fresh.load_checkpoint(str(Path(d) / "final_model.pth"), weights_only=True)
        weights = (same(fresh.model.state_dict(), tr.model.state_dict())
                   and same(fresh.state.ema_params, dict(tr.model.named_parameters()))
                   and int(fresh.state.opt_state["count"]) == 0 and fresh.global_step == 0)
        log(f"  full resume: params, optimiser state and EMA bitwise equal, epoch 2, "
            f"step 4: {full}; weights-only load: params equal, EMA = params, fresh "
            f"optimiser: {weights}")
        if not (full and weights):
            raise AssertionError("a checkpoint did not round-trip")


def training_phase(dev, card) -> float:
    """Phase 7: the stage-1 content-training path on the card; returns the
    step's median ms."""
    from torch.profiler import ProfilerActivity, profile

    from facesr_torch.losses.perceptual import perceptual_loss
    from facesr_torch.models import blocks
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.ops.conv import full_f32
    from facesr_torch.ops.resize import bicubic_down, bicubic_up

    from facesr_torch.cli.step_numerics import small_step, step_errors

    log(f"== 7. stage-1 training (f32, TF32 off): CUDA step vs CPU step, relative L2 "
        f"error <= {STEP_RTOL} for the loss and each tensor of the gradients and of "
        "the updated parameters")
    cpu = small_step("cpu")
    gpu = small_step(dev)
    errs = step_errors(gpu, cpu)
    # a smooth loss: with the stage-1 loss (L1 criterion) the CUDA step's
    # gradients sit ~6e-4 from the CPU's under cuDNN and ~7e-7 without it,
    # a cause not yet found (python -m facesr_torch.cli.step_numerics)
    log(f"  G=2 B=2 C=16, batch 2, HR 32, L2 + perceptual (L2) + 0.1 SSIM: loss "
        f"{cpu[0].item():.6g}; relative L2 of the loss "
        f"{errs[0]:.3g}, worst gradient {errs[1]:.3g}, worst param {errs[2]:.3g}")
    if max(errs) > STEP_RTOL:
        raise AssertionError(f"the CUDA training step disagrees with the CPU step: {errs}")
    tf32 = step_errors(small_step(dev, tf32_forced=True), cpu)
    log(f"  control, cuDNN and cuBLAS TF32 forced around the same CUDA step: loss {tf32[0]:.3g}, "
        f"worst gradient {tf32[1]:.3g}, worst param {tf32[2]:.3g} -> "
        f"{'rejected' if max(tf32) > STEP_RTOL else 'within'}")
    if max(tf32) <= STEP_RTOL:
        raise AssertionError("the step tolerance cannot see TF32 convs")

    n = TRAIN_BATCH
    log(f"  production step: 6x10x64 f32 remat save_ca, batch {n} HR {TRAIN_HR}x{TRAIN_HR}, "
        "L1 + VGG19 conv3_4, AdamW lr 1e-4 wd 0 clip 0.5, one repeated batch")
    state, step, loss = production_step_fn(dev)
    hr = smooth_hr(n, TRAIN_HR, seed=7, dev=dev)
    rg.fused_residual_group.launches = 0  # just before the training path
    losses, times = [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, metrics = step(state, hr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, metrics = step(state, hr)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    torch.cuda.synchronize()
    losses.append(metrics["loss"])
    launches = rg.fused_residual_group.launches  # just after
    losses = [v.item() for v in losses]
    ms = statistics.median(times[TRAIN_WARMUP:]) * 1e3
    log(f"  losses {['%.6f' % v for v in losses]}")
    log(f"  step time median of {TRAIN_TIMED}: {ms:.3f} ms/step = {n / ms * 1e3:.2f} images/s; "
        f"all {len(times)}: {['%.1f' % (t * 1e3) for t in times]} ms; peak device memory "
        f"{peak_gib:.3f} GiB; host syncs in one step: {len(syncs)} "
        f"{[f'{w.filename}:{w.lineno} {str(w.message)[:80]}' for w in syncs]}; other "
        f"warnings {[str(w.message)[:80] for w in caught if w not in syncs]} [{card}]")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite or not falling: {losses}")
    if launches != 0:
        raise AssertionError(f"the training path launched the forward-only group kernel "
                             f"{launches} times")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, hr)
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if getattr(getattr(e, "device_type", None), "name", "") == "CUDA"]
    total_us = sum(dev_us(e) for e in events)
    port_kernels = [e.key for e in events if "rcab_group" in e.key]
    flops = train_step_conv_flops(state.model.config, n, TRAIN_HR)
    log(f"  profiler, one production step: {total_us / 1e3:.3f} ms device time, "
        f"{len(events)} device op kinds, port kernels {port_kernels}; 3x3 conv work "
        f"{flops / 1e12:.3f} TFLOP = {flops / max(total_us, 1) / 1e6:.2f} TFLOP/s over the "
        f"device time, {flops / max(total_us, 1) * 1e6 / F32_PEAK_FLOPS * 100:.1f}% of the "
        f"f32 peak [{card}]")
    for e in sorted(events, key=lambda e: -dev_us(e))[:15]:
        log(f"    {dev_us(e) / max(total_us, 1) * 100:6.2f}%  {dev_us(e) / 1e3:9.3f} ms"
            f"  x{e.count:<5} {e.key[:90]}")
    if port_kernels:
        raise AssertionError(f"the training step ran a kernel of the port: {port_kernels}")

    # the shares of the step's two big parts, each forward + backward alone
    lr_img = bicubic_down(hr, 4)
    sr = bicubic_up(lr_img, 4).requires_grad_(True)
    feat = torch.randn((n, TRAIN_HR // 4, TRAIN_HR // 4, state.model.config.num_channels),
                       device=dev).requires_grad_(True)
    trunk_params = [feat] + list(state.model.residual_groups.parameters())

    def vgg_part():
        with full_f32():
            v = perceptual_loss(loss.params["vgg"], sr, hr, layers=("conv3_4",), remat=False)
            torch.autograd.grad(v, sr)

    def trunk_part():
        with full_f32():
            out, _ = blocks.residual_groups(state.model.residual_groups, feat, 0.2, 1,
                                            remat="save_ca")
            torch.autograd.grad(out.sum(), trunk_params)

    vgg_ms = cuda_ms(vgg_part, iters=3, warmup=1)
    trunk_ms = cuda_ms(trunk_part, iters=3, warmup=1)
    log(f"  alone, forward + backward: VGG19 perceptual (pred + target sweeps) {vgg_ms:.3f} ms "
        f"= {vgg_ms / ms * 100:.1f}% of the step; trunk (6x10 RCABs, save_ca) "
        f"{trunk_ms:.3f} ms = {trunk_ms / ms * 100:.1f}% [{card}]")
    del state, step, loss, hr, sr, feat, trunk_params, lr_img
    torch.cuda.empty_cache()

    trainer_phase(dev)
    return ms


# phase 8: the stage YAMLs' sizes (batch 48 of HR 256), the PNG set
CLI_TRAIN, CLI_VAL, CLI_HR, CLI_LR, CLI_BATCH = 240, 48, 256, 64, 48
CLI_DECODE_CHECK = 48
REPO = Path(__file__).resolve().parent
STAGE1_YAML = REPO / "configs/stages/stage1_psnr_config.yaml"
STAGE2_YAML = REPO / "configs/stages/stage2_ssim_config.yaml"
STAGE3_YAML = REPO / "configs/stages/stage3_gan_config.yaml"


def write_png_set(root: Path) -> dict:
    """Smooth seeded faces as PNG files: ``train/HR`` (HR-only) and
    ``val/HR`` + ``val/LR`` (LR made as the JAX package's prepare_data makes
    it: cv2's bicubic, here the port's copy). Rows use filter i % 5, so
    every PNG filter occurs. Returns {path: array} of the first files."""
    from facesr_torch.data import png
    from facesr_torch.data.cv_compat import resize_cubic

    rng = np.random.default_rng(8)
    written = {}
    for split, n in (("train", CLI_TRAIN), ("val", CLI_VAL)):
        (root / split / "HR").mkdir(parents=True)
        if split == "val":
            (root / split / "LR").mkdir()
        for i in range(n):
            lo = (rng.random((8, 8, 3)) * 255).astype(np.uint8)
            img = resize_cubic(lo, (CLI_HR, CLI_HR))
            path = root / split / "HR" / f"{i:05d}.png"
            png.write_png(path, img, level=6, filter_type=i % 5)
            if len(written) < CLI_DECODE_CHECK:
                written[path] = img
            if split == "val":
                png.write_png(root / split / "LR" / f"{i:05d}.png",
                              resize_cubic(img, (CLI_LR, CLI_LR)), level=6)
    return written


class _Tee:
    """stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def isatty(self):
        return False

    def text(self):
        return "".join(self.parts)


def cli_phase(card: str, step_alone_ms: float, tmp: Path) -> None:
    """Phase 8: the training entry point on the card, from PNG files
    written under ``tmp``; leaves the PNG set in ``tmp/data`` and stage
    1's checkpoints in ``tmp/stage1_checkpoints`` for phase 9."""
    import os
    import shutil

    from facesr_torch.cli import train as train_cli
    from facesr_torch.config import load_config
    from facesr_torch.data import png
    from facesr_torch.data.dataset import get_dataloader
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.training.trainer import Trainer

    log(f"== 8. training entry point: PNG set, loaders, the train CLI on the stage YAMLs "
        f"[{card}]")
    t_phase = time.perf_counter()
    data = tmp / "data"
    t0 = time.perf_counter()
    written = write_png_set(data)
    write_s = time.perf_counter() - t0
    same = all(np.array_equal(png.read_rgb(p), img) for p, img in written.items())
    t0 = time.perf_counter()
    for p in written:
        png.read_rgb(p)
    decode_ms = (time.perf_counter() - t0) / len(written) * 1e3
    log(f"  wrote {CLI_TRAIN} train HR + {CLI_VAL} val HR/LR PNGs ({CLI_HR}x{CLI_HR}) in "
        f"{write_s:.2f} s; {len(written)} decoded back bitwise equal: {same}; "
        f"single-thread decode {decode_ms:.3f} ms an image; os.cpu_count() "
        f"{os.cpu_count()} [{card}]")
    if not same:
        raise AssertionError("a decoded PNG differs from the array written")

    cfg1 = load_config(str(STAGE1_YAML))
    rates = {}
    for fast in (False, True):
        argv = ["--config", str(STAGE1_YAML)] + (["--fast-loader"] if fast else [])
        train_loader, _ = train_cli.make_loaders(train_cli.parse_args(argv), cfg1,
                                                 str(data), CLI_BATCH, seed=42)
        n, t0 = 0, time.perf_counter()
        for _ in range(2):
            for batch in train_loader:
                hr = batch["hr"]
                if hr.shape != (CLI_BATCH, CLI_HR, CLI_HR, 3) or hr.dtype != np.float32:
                    raise AssertionError(f"loader batch {hr.shape} {hr.dtype}")
                n += len(hr)
        rates[fast] = n / (time.perf_counter() - t0)
        log(f"  stage-1 training loader{' --fast-loader' if fast else ''} (batch "
            f"{CLI_BATCH}, {cfg1['data']['num_workers']} workers, 2 epochs): "
            f"{rates[fast]:.1f} images/s [{card}]")

    # the CLI, in this process, from the temporary directory (the YAMLs'
    # ./checkpoints lands there)
    loaded = []  # (path, the weights right after the load) of each load
    real_load = Trainer.load_checkpoint

    def load_and_record(self, path, weights_only=False):
        real_load(self, path, weights_only)
        loaded.append((path, {k: v.detach().cpu().clone()
                              for k, v in self.model.state_dict().items()}))

    cwd = os.getcwd()
    os.chdir(tmp)
    Trainer.load_checkpoint = load_and_record
    try:
        results, best, chained = {}, {}, {}
        for stage, yaml_path in ((1, STAGE1_YAML), (2, STAGE2_YAML), (3, STAGE3_YAML)):
            tee = _Tee(sys.stdout)
            rg.fused_residual_group.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                trainer = train_cli.run(["--config", str(yaml_path), "--data-root",
                                         str(data), "--epochs", "1"])
            torch.cuda.synchronize()
            results[stage] = (trainer, tee.text(), time.perf_counter() - t0,
                              rg.fused_residual_group.launches)
            chained[stage] = loaded[-1] if stage > 1 and loaded else None
            best[stage] = torch.load(tmp / "checkpoints/best_model.pth", map_location="cpu",
                                     weights_only=True)["model_state_dict"]
            if stage == 1:
                (tmp / "stage1_checkpoints").mkdir()
                for name in ("best_model.pth", "final_model.pth"):
                    shutil.copy(tmp / "checkpoints" / name, tmp / "stage1_checkpoints")
    finally:
        Trainer.load_checkpoint = real_load
        os.chdir(cwd)

    for stage in (1, 2, 3):
        trainer, text, wall_s, launches = results[stage]
        m = trainer.last_train_metrics
        steady = trainer.last_step_times[1:]
        ms = statistics.median(steady) * 1e3
        history = trainer.training_history
        log(f"  stage {stage} CLI: {len(trainer.last_step_times)} steps of {CLI_BATCH}, "
            f"{ms:.3f} ms/step (median host interval after the first) = "
            f"{CLI_BATCH / ms * 1e3:.2f} images/s against {CLI_BATCH / step_alone_ms * 1e3:.2f} "
            f"for phase 7's content step alone ({step_alone_ms:.3f} ms"
            f"{'; this stage runs the GAN step, phase 10 times it alone' if stage == 3 else ''}); "
            f"the step loop waited "
            f"{m['loader_wait_s']:.3f} s on next(loader); steps "
            f"{['%.1f' % (t * 1e3) for t in trainer.last_step_times]} ms; epoch "
            f"{m['time_s']:.2f} s, whole run {wall_s:.2f} s; train losses {m}; history "
            f"{json.dumps(history)}; group-kernel launches {launches} [{card}]")
        values = [v for v in m.values()] + [v for h in history.values() for v in h]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"stage {stage}: a loss or metric is not finite")
        if len(trainer.last_step_times) != CLI_TRAIN // CLI_BATCH or launches != 0:
            raise AssertionError(f"stage {stage}: {len(trainer.last_step_times)} steps, "
                                 f"{launches} group-kernel launches")
    files = sorted(p.name for p in (tmp / "checkpoints").iterdir())
    if not {"best_model.pth", "final_model.pth"} <= set(files):
        raise AssertionError(f"checkpoint files {files}")
    for stage in (2, 3):
        text = results[stage][1]
        mapped = ("best_model.fckpt not found" in text
                  and "Chaining from stage checkpoint checkpoints/best_model.pth" in text)
        path, state = chained[stage] or ("", {})
        want = best[stage - 1]
        bitwise = (path.endswith("best_model.pth") and set(state) == set(want)
                   and all(torch.equal(state[k], want[k]) for k in want))
        log(f"  stage {stage} resolved ./checkpoints/best_model.fckpt to stage {stage - 1}'s "
            f"best_model.pth and said so: {mapped}; weights right after the load bitwise equal "
            f"to that file's model_state_dict: {bitwise}")
        if not (mapped and bitwise):
            raise AssertionError(f"stage {stage} did not chain from stage {stage - 1}'s best "
                                 "weights")
    ssim_in = "ssim" in results[2][0].loss_fn.weights and "ssim" in results[2][0].last_train_metrics
    t3 = results[3][0]
    d_hist = t3.training_history.get("d_loss", [])
    gan_ok = (t3.use_gan and "GAN Training Configuration:" in results[3][1]
              and len(d_hist) == 1 and all(math.isfinite(v) and v > 0 for v in d_hist)
              and t3.disc.config.input_size == CLI_HR)
    log(f"  SSIM term in stage 2's loss: {ssim_in}; stage 3 trained the GAN (D at "
        f"{t3.disc.config.input_size}, d_loss history {d_hist}): {gan_ok}; files {files}")
    if not (ssim_in and gan_ok):
        raise AssertionError("stage 2 lacks its SSIM term or stage 3 did not train the GAN")

    # controls
    bad = tmp / "bad"
    (bad / "train" / "HR").mkdir(parents=True)
    for i in range(4):
        (bad / "train" / "HR" / f"{i:05d}.png").write_bytes(
            (data / "train" / "HR" / f"{i:05d}.png").read_bytes())
    victim = bad / "train" / "HR" / "00002.png"
    raw = bytearray(victim.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    victim.write_bytes(bytes(raw))
    try:
        for _ in get_dataloader(str(bad), mode="train", batch_size=2, num_workers=2,
                                hr_patch_size=CLI_HR, seed=0):
            pass
        named = False
    except IOError as e:
        named = victim.name in str(e)
        log(f"  control, a corrupt PNG in the training set: {type(e).__name__}: "
            f"{str(e)[:160]}")
    if not named:
        raise AssertionError("a corrupt PNG did not stop the loader with its name")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "facesr_torch.cli.train", "--config",
                           str(STAGE1_YAML), "--data-root", str(data), "--epochs", "1"],
                          cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
    refused = proc.returncode != 0 and "no CUDA device is available" in proc.stderr
    log(f"  control, the CLI without --device where no card is visible: exit "
        f"{proc.returncode}, {proc.stderr.strip().splitlines()[-1][:140] if proc.stderr.strip() else ''}")
    if not refused:
        raise AssertionError("the CLI without --device did not refuse to run without a card")
    log(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s [{card}]")


# phase 9: the evaluation networks' card-vs-CPU checks (images, pairs, set
# size) and the CLIs' image count (phase 8's validation HR set)
EVAL_CHECK_IMAGES, EVAL_LPIPS_PAIRS, EVAL_FID_SET, EVAL_IMAGES = 8, 4, 32, 48
# f32 with TF32 off on both sides: other summation orders give ~1e-6;
# TF32 convs (10-bit mantissa) ~1e-3 (the control must exceed the limit)
EVAL_RTOL, FID_RTOL = 1e-4, 1e-3
# test_model batched vs --per-image (cuDNN may pick other algorithms at
# batch 1 than at 128); bf16 kernel trunk vs f32 in the compare run
PER_IMAGE_PSNR_DB, BF16_GAP_DB = 0.01, 0.1


@contextlib.contextmanager
def tf32_forced():
    """cuDNN convs and cuBLAS matmuls in TF32: stands in for `full_f32`
    in the control that the f32 limits must reject."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def inception_acts_tf32(images, weights, dev):
    """The card's activations with TF32 forced around the network."""
    from facesr_torch.evaluation import fid
    from facesr_torch.models import inception

    real = inception.full_f32
    inception.full_f32 = tf32_forced
    try:
        return fid.inception_activations(images, weights, len(images), dev)
    finally:
        inception.full_f32 = real


def eval_cli(module, argv):
    """Run an evaluation CLI in this process with its per-image lines kept
    off the log; returns (result, printed text)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = module.run(argv)
    return result, buf.getvalue()


def eval_phase(dev, card: str, tmp: Path) -> int:
    """Phase 9: evaluation on the card, on phase 8's PNG set and stage 1's
    checkpoints under ``tmp``. Returns the group-kernel launches of the
    bf16 compare run."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from facesr_torch.cli import compare_two_models, test_model
    from facesr_torch.data import png
    from facesr_torch.evaluation import fid
    from facesr_torch.models import inception, lpips
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.ops.resize import resize2d

    log(f"== 9. evaluation: LPIPS and FID-Inception card vs CPU, the test_model and "
        f"compare_two_models CLIs [{card}]")
    t_phase = time.perf_counter()
    wdir = tmp / "eval_weights"
    wdir.mkdir()
    lp_w = lpips.init_random_alexnet(torch.Generator().manual_seed(90))
    inc_w = inception.init_random_inception(torch.Generator().manual_seed(91))
    lpips.save_lpips_weights(str(wdir / "lpips_alex.fckpt"), lp_w)
    inception.save_inception_weights(str(wdir / "inception_fid.fckpt"), inc_w)
    saved_env = {k: os.environ.get(k) for k in (lpips.ENV_WEIGHTS, inception.ENV_WEIGHTS)}
    os.environ[lpips.ENV_WEIGHTS] = str(wdir / "lpips_alex.fckpt")
    os.environ[inception.ENV_WEIGHTS] = str(wdir / "inception_fid.fckpt")
    try:
        val = sorted((tmp / "data" / "val" / "HR").iterdir())
        train = sorted((tmp / "data" / "train" / "HR").iterdir())
        imgs_a = [png.read_rgb(p) for p in val[:EVAL_FID_SET]]
        imgs_b = [png.read_rgb(p) for p in train[:EVAL_FID_SET]]
        inc_card = {n: {k: t.to(dev) for k, t in p.items()} for n, p in inc_w.items()}

        # card vs CPU: Inception, its TF32 control, LPIPS, FID
        check = imgs_a[:EVAL_CHECK_IMAGES]
        got = fid.inception_activations(check, inc_card, len(check), dev)
        want = fid.inception_activations(check, inc_w, len(check), "cpu")
        err, tf32_err = rel_l2(got, want), rel_l2(inception_acts_tf32(check, inc_card, dev), want)
        log(f"  Inception activations of {len(check)} images (256x256 uint8 -> 299): relative L2 "
            f"card vs CPU {err:.3g} (limit {EVAL_RTOL}); control with TF32 forced "
            f"{tf32_err:.3g} -> {'rejected' if tf32_err > EVAL_RTOL else 'within'}")
        if not np.isfinite(got).all() or err > EVAL_RTOL:
            raise AssertionError(f"Inception on the card disagrees with the CPU: {err}")
        if tf32_err <= EVAL_RTOL:
            raise AssertionError("the Inception limit cannot see TF32 convs")
        lp_card = {k: [{n: t.to(dev) for n, t in p.items()} for p in v] for k, v in lp_w.items()}
        lp_errs = []
        for i in range(EVAL_LPIPS_PAIRS):
            a = torch.from_numpy(imgs_a[i][None].astype(np.float32) / 255.0) * 2 - 1
            b = torch.from_numpy(imgs_b[i][None].astype(np.float32) / 255.0) * 2 - 1
            want_lp = lpips.lpips_distance(lp_w, a, b).item()
            got_lp = lpips.lpips_distance(lp_card, a.to(dev), b.to(dev)).item()
            lp_errs.append(abs(got_lp - want_lp) / abs(want_lp))
        log(f"  LPIPS of {EVAL_LPIPS_PAIRS} pairs: relative difference card vs CPU "
            f"{['%.3g' % e for e in lp_errs]} (limit {EVAL_RTOL})")
        if max(lp_errs) > EVAL_RTOL:
            raise AssertionError(f"LPIPS on the card disagrees with the CPU: {lp_errs}")
        fids = {}
        for side, w, d in (("card", inc_card, dev), ("cpu", inc_w, "cpu")):
            fids[side] = fid.fid_from_activations(
                fid.inception_activations(imgs_a, w, EVAL_FID_SET, d),
                fid.inception_activations(imgs_b, w, EVAL_FID_SET, d))
        fid_err = abs(fids["card"] - fids["cpu"]) / abs(fids["cpu"])
        log(f"  FID of two sets of {EVAL_FID_SET}: card {fids['card']:.6f}, CPU "
            f"{fids['cpu']:.6f}, relative difference {fid_err:.3g} (limit {FID_RTOL})")
        if fid_err > FID_RTOL:
            raise AssertionError(f"FID from card activations disagrees with the CPU: {fid_err}")

        # test_model: batched and --per-image, stage 1's best_model.pth, on the card
        best = str(tmp / "stage1_checkpoints" / "best_model.pth")
        rows = {}
        for mode in ("batched", "per_image"):
            argv = ["--checkpoint", best, "--input", str(tmp / "data" / "val" / "HR"),
                    "--output", str(tmp / f"test_model_{mode}"), "--no-comparison"]
            rg.fused_residual_group.launches = 0
            t0 = time.perf_counter()
            rows[mode], _ = eval_cli(test_model, argv + (["--per-image"] if mode == "per_image"
                                                         else []))
            log(f"  test_model {mode}: {len(rows[mode])} images in "
                f"{time.perf_counter() - t0:.2f} s, group-kernel launches "
                f"{rg.fused_residual_group.launches} [{card}]")
            if rg.fused_residual_group.launches:
                raise AssertionError("the f32 test_model run launched the bf16 group kernel")
        gap = max(abs(b["model"]["psnr"] - s["model"]["psnr"])
                  for b, s in zip(rows["batched"], rows["per_image"]))
        most, differing = 0, 0
        for r in rows["batched"]:
            name = Path(r["file"]).stem + "_sr.png"
            x = png.read_rgb(tmp / "test_model_batched" / name).astype(int)
            y = png.read_rgb(tmp / "test_model_per_image" / name)
            most, differing = max(most, int(np.abs(x - y).max())), differing + int((x != y).sum())
        log(f"  test_model batched vs --per-image: largest per-image PSNR gap {gap:.3g} dB "
            f"(limit {PER_IMAGE_PSNR_DB}); SR values differing {differing} of "
            f"{len(rows['batched']) * CLI_HR * CLI_HR * 3}, largest {most} uint8 level(s); "
            f"model PSNR {np.mean([r['model']['psnr'] for r in rows['batched']]):.4f} dB, "
            f"bicubic {np.mean([r['bicubic']['psnr'] for r in rows['batched']]):.4f} dB")
        if len(rows["batched"]) != CLI_VAL or gap > PER_IMAGE_PSNR_DB:
            raise AssertionError(f"test_model batched and --per-image disagree: {gap} dB")

        # compare_two_models: f32, then bf16 (the kernel trunk) under the profiler
        runs = {}
        for sd in ("f32", "bf16"):
            argv = ["--checkpoint-dir", str(tmp / "stage1_checkpoints"),
                    "--test-dir", str(tmp / "data" / "val" / "HR"),
                    "--output", str(tmp / f"compare_{sd}"), "--num-images", str(EVAL_IMAGES),
                    "--save-every", "8", "--serve-dtype", sd]
            rg.fused_residual_group.launches = 0  # just before
            t0 = time.perf_counter()
            if sd == "bf16":
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    res, text = eval_cli(compare_two_models, argv)
                    torch.cuda.synchronize()
            else:
                res, text = eval_cli(compare_two_models, argv)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[sd] = (res, text, wall, rg.fused_residual_group.launches)  # just after
        dev_us = lambda e: getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0))
        events = [e for e in prof.key_averages()
                  if getattr(getattr(e, "device_type", None), "name", "") == "CUDA"]
        busy_s = sum(dev_us(e) for e in events) / 1e6
        for sd, (res, text, wall, launches) in runs.items():
            t = res["timings"]
            log(f"  compare_two_models --serve-dtype {sd}: {res['images']} images, methods "
                f"{res['methods']}, {wall:.2f} s = {res['images'] / wall:.2f} images/s end to "
                f"end{' (under the CUDA profiler)' if sd == 'bf16' else ''}; group-kernel "
                f"launches {launches} [{card}]")
            log(f"    seconds by stage: {json.dumps({k: round(v, 4) for k, v in t.items()})}; "
                f"other {wall - sum(t.values()):.3f}")
            for line in text.splitlines():
                if line.startswith(tuple(res["methods"]) + ("Method", "Best baseline")):
                    log(f"    {line}")
        f32, bf16 = runs["f32"][0]["summary"], runs["bf16"][0]["summary"]
        baselines = list(compare_two_models.OPENCV_BASELINES)
        same_baselines = all(f32[m] == bf16[m] for m in baselines)
        models = [m for m in runs["f32"][0]["methods"] if m not in baselines]
        gaps = {m: bf16[m]["psnr"] - f32[m]["psnr"] for m in models}
        top = sorted(events, key=lambda e: -dev_us(e))[:8]
        log(f"  device busy in the bf16 run: {busy_s:.3f} s of {runs['bf16'][2]:.2f} s wall = "
            f"{busy_s / runs['bf16'][2] * 100:.1f}%; top device ops: "
            f"{[(e.key[:40], round(dev_us(e) / 1e3, 1)) for e in top]} ms [{card}]")
        log(f"  baseline rows bitwise equal between the f32 and bf16 runs: {same_baselines}; "
            f"bf16 - f32 model PSNR {json.dumps({m: round(g, 5) for m, g in gaps.items()})} dB "
            f"(limit {BF16_GAP_DB}); launches f32 {runs['f32'][3]}, bf16 {runs['bf16'][3]}")
        if runs["f32"][3] != 0 or runs["bf16"][3] == 0:
            raise AssertionError(f"group-kernel launches f32 {runs['f32'][3]}, bf16 "
                                 f"{runs['bf16'][3]}: want 0 and more than 0")
        if not same_baselines or len(models) != 2:
            raise AssertionError(f"baseline rows differ or models missing: {models}")
        if not all(abs(g) <= BF16_GAP_DB for g in gaps.values()):
            raise AssertionError(f"bf16 model PSNR strays from f32: {gaps}")
        if not all(math.isfinite(v) for r in f32.values() for v in r.values()) \
                or not {"lpips", "fid"} <= set(f32[models[0]]):
            raise AssertionError("a compare metric is missing or not finite")

        # the evaluation networks alone
        x32 = resize2d(torch.from_numpy(np.stack(imgs_a).astype(np.float32) / 255).to(dev),
                       (inception.INPUT_SIZE, inception.INPUT_SIZE), method="bilinear")
        inc_ms = cuda_ms(lambda: inception.apply(inc_card, x32, resize_input=False), iters=5)
        a1 = torch.from_numpy(imgs_a[0][None].astype(np.float32) / 255.0).to(dev) * 2 - 1
        b1 = torch.from_numpy(imgs_b[0][None].astype(np.float32) / 255.0).to(dev) * 2 - 1
        lp_ms = cuda_ms(lambda: lpips.lpips_distance(lp_card, a1, b1), iters=20)
        log(f"  Inception batch {EVAL_FID_SET} at 299: {inc_ms:.3f} ms = "
            f"{EVAL_FID_SET / inc_ms * 1e3:.1f} images/s; LPIPS one pair at 256x256: "
            f"{lp_ms:.3f} ms (CUDA events) [{card}]")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return runs["bf16"][3]


# phase 10: the stage-3 GAN step at the production size (batch 48, HR 256;
# the discriminator at 256 with 64 base channels), warm-up and timed steps
GAN_BATCH, GAN_HR, GAN_D_BASE, GAN_WARMUP, GAN_TIMED = 48, 256, 64, 2, 6


def gan_step_fn(dev):
    """Stage 3's GAN step at the production width, the YAML's values written
    out: FaceEnhanceNet 6x10x64 (remat save_ca, conv_last redrawn
    non-zero), f32, L1 0.01 + perceptual 1.0 at conv3_4, vanilla GAN
    0.005, G AdamW lr 1e-5 wd 0 clip 0.5, D AdamW lr 1e-4 wd 0 (no clip),
    one D update a step. Returns (state, step, loss)."""
    from facesr_torch.losses.combined import CombinedLoss, LossConfig
    from facesr_torch.models.discriminator import create_discriminator
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.ops.init import kaiming_normal
    from facesr_torch.training import steps
    from facesr_torch.training.optim import AdamW

    model = FaceEnhanceNet(production_config().replace(remat="save_ca"), seed=0, device="cpu")
    with torch.no_grad():
        model.conv_last.weight.copy_(kaiming_normal(model.conv_last.weight.shape,
                                                    torch.Generator().manual_seed(1), scale=0.1))
    model.to(dev)
    disc = create_discriminator(input_size=GAN_HR, base_channels=GAN_D_BASE, use_bn=True,
                                seed=0, device=dev)
    loss = CombinedLoss(LossConfig(l1_weight=0.01, perceptual_weight=1.0, ssim_weight=0.0,
                                   perceptual_layers=["conv3_4"]), seed=0, device=dev)
    opt, d_opt = AdamW(weight_decay=0.0, gradient_clip=0.5), AdamW(weight_decay=0.0,
                                                                   gradient_clip=0.0)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), 1e-5),
                             loss_params=loss.params, disc=disc,
                             d_opt_state=d_opt.init(dict(disc.named_parameters()), 1e-4))
    step = steps.make_gan_train_step(lambda lp, p, t: loss.apply(lp, p, t, vgg_remat=False),
                                     opt, d_opt, gan_weight=0.005, gan_type="vanilla")
    return state, step, loss


def disc_work_flops(n, size, base):
    """Operations of one discriminator forward on n images: its 10 convs
    and 2 dense layers (2 per multiply-add)."""
    from facesr_torch.models.discriminator import _BLOCKS

    flops, cin, s = 0.0, 3, size
    for mult, stride, _ in _BLOCKS:
        s = (s + 1) // 2 if stride == 2 else s
        flops += 2.0 * n * s * s * 9 * cin * base * mult
        cin = base * mult
    flops += 2.0 * n * (cin * s * s * 1024 + 1024)
    return flops


def gan_trainer_phase(dev):
    """`Trainer.train()` with the GAN on the production model: 2 epochs of 2
    batches, the GAN from epoch 1; a full resume and a content checkpoint
    resumed into a GAN trainer."""
    from facesr_torch.models.discriminator import create_discriminator
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    train = [{"hr": smooth_hr(TRAINER_BATCH, GAN_HR, seed=60 + i, dev="cpu").numpy()}
             for i in range(2)]
    val = [{"hr": smooth_hr(TRAINER_BATCH, GAN_HR, seed=70, dev="cpu").numpy()}]

    def trainer(ckpt_dir, epochs, seed, gan=True):
        cfg = TrainerConfig(epochs=epochs, learning_rate=1e-5, weight_decay=0.0,
                            gradient_clip=0.5, use_amp=False, scheduler_type="step",
                            scheduler_step_size=20, scheduler_gamma=1.0, save_every=1,
                            checkpoint_dir=ckpt_dir, early_stopping_metric="val_loss",
                            early_stopping_mode="min", gan_weight=0.005 if gan else 0.0,
                            d_learning_rate=1e-4, gan_start_epoch=1)
        loss = stage1_loss("cpu")
        model = FaceEnhanceNet(production_config(), seed=seed, device="cpu")
        disc = (create_discriminator(input_size=GAN_HR, base_channels=GAN_D_BASE, seed=seed,
                                     device="cpu") if gan else None)
        return Trainer(model, train, val, loss, cfg, device=dev, discriminator=disc)

    def same(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        return torch.equal(a, b)

    with tempfile.TemporaryDirectory(prefix="facesr_torch_gan_") as d:
        tr = trainer(d, epochs=2, seed=0)
        t0 = time.perf_counter()
        history = tr.train()
        train_s = time.perf_counter() - t0
        log(f"  Trainer.train() with the GAN from epoch 1: 2 epochs x 2 batches of "
            f"{TRAINER_BATCH} + 1 validation batch in {train_s:.2f} s; history "
            f"{json.dumps(history)}")
        gan_keys = ("d_loss", "g_loss", "d_real", "d_fake")
        aligned = all(len(history[k]) == 2 and history[k][0] == 0.0 and history[k][1] != 0.0
                      and math.isfinite(history[k][1]) for k in gan_keys)
        if not aligned or tr.global_step != 4:
            raise AssertionError("the GAN history is not 0.0 then the GAN step's, or the "
                                 f"step count is {tr.global_step}")
        resumed = trainer(d, epochs=3, seed=1)
        resumed.load_checkpoint(str(Path(d) / "final_model.pth"))
        full = (same(resumed.model.state_dict(), tr.model.state_dict())
                and same(resumed.disc.state_dict(), tr.disc.state_dict())
                and same(resumed.state.opt_state, tr.state.opt_state)
                and same(resumed.state.d_opt_state, tr.state.d_opt_state)
                and resumed.current_epoch == 2 and resumed.training_history == history)
        c = Path(d) / "content"
        content = trainer(str(c), epochs=1, seed=2, gan=False)
        content.train()
        into = trainer(str(Path(d) / "into"), epochs=2, seed=3)
        fresh_d = {k: v.clone() for k, v in into.disc.state_dict().items()}
        into.load_checkpoint(str(c / "final_model.pth"))
        backfilled = (same(into.model.state_dict(), content.model.state_dict())
                      and same(into.disc.state_dict(), fresh_d)
                      and all(into.training_history.get(k) == [] for k in gan_keys))
        log(f"  full resume: G, D (params and BatchNorm stats), both optimisers bitwise "
            f"equal, epoch 2, history equal: {full}; a content checkpoint resumed into a GAN "
            f"trainer: G restored, D fresh, GAN history backfilled: {backfilled}")
        if not (full and backfilled):
            raise AssertionError("a GAN checkpoint did not round-trip")


def gan_phase(dev, card: str) -> None:
    """Phase 10: GAN training (stage 3) on the card."""
    from torch.profiler import ProfilerActivity, profile

    from facesr_torch.cli.step_numerics import gan_step_errors, small_gan_step
    from facesr_torch.losses.gan import gan_loss
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.ops.conv import full_f32
    from facesr_torch.ops.resize import bicubic_down

    log(f"== 10. GAN training (stage 3, f32, TF32 off): CUDA step vs CPU step, relative L2 "
        f"<= {STEP_RTOL} for the losses and each tensor of the G and D gradients, the "
        f"updated parameters and the BatchNorm running stats [{card}]")
    t_phase = time.perf_counter()
    cpu = small_gan_step("cpu")
    errs = gan_step_errors(small_gan_step(dev), cpu)
    log(f"  G=2 B=2 C=16, D at 64 (8 base channels, BN), batch 4, smooth loss + 0.005 GAN: "
        f"d_loss {cpu['losses']['d_loss'].item():.6g}, g_adv {cpu['losses']['g_adv'].item():.6g}; "
        f"worst relative L2 by part {json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})}")
    if max(errs.values()) > STEP_RTOL:
        raise AssertionError(f"the CUDA GAN step disagrees with the CPU step: {errs}")
    tf32 = gan_step_errors(small_gan_step(dev, tf32_forced=True), cpu)
    log(f"  control, TF32 forced for cuDNN and cuBLAS around the same CUDA step: "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in tf32.items()})} -> "
        f"{'rejected' if max(tf32.values()) > STEP_RTOL else 'within'}")
    if max(tf32.values()) <= STEP_RTOL:
        raise AssertionError("the GAN step tolerance cannot see TF32")

    n = GAN_BATCH
    cfg = production_config()
    log(f"  production GAN step: {cfg.num_groups}x{cfg.blocks_per_group}x{cfg.num_channels} f32 "
        f"remat save_ca, batch {n} HR {GAN_HR}x{GAN_HR}, L1 0.01 + VGG19 conv3_4 1.0 + vanilla "
        f"GAN 0.005, D {GAN_D_BASE} channels with BN at {GAN_HR}, G AdamW lr 1e-5 clip 0.5, "
        "D AdamW lr 1e-4, one repeated batch")
    state, step, loss = gan_step_fn(dev)
    hr = smooth_hr(n, GAN_HR, seed=9, dev=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rg.fused_residual_group.launches = 0  # just before the GAN path
    rows, times = [], []
    for i in range(GAN_WARMUP + GAN_TIMED):
        t0 = time.perf_counter()
        _, metrics = step(state, hr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append({k: metrics[k] for k in ("loss", "g_adv", "d_loss", "d_real", "d_fake")})
    launches = rg.fused_residual_group.launches  # just after
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = [{k: v.item() for k, v in r.items()} for r in rows]
    ms = statistics.median(times[GAN_WARMUP:]) * 1e3
    log(f"  metrics by step {json.dumps([{k: round(v, 6) for k, v in r.items()} for r in rows])}")
    log(f"  step time median of {GAN_TIMED}: {ms:.3f} ms/step = {n / ms * 1e3:.2f} images/s; "
        f"all {len(times)}: {['%.1f' % (t * 1e3) for t in times]} ms; peak device memory "
        f"{peak_gib:.3f} GiB; group-kernel launches {launches} [{card}]")
    if not all(math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"GAN losses not finite: {rows}")
    if launches != 0:
        raise AssertionError(f"the GAN step launched the forward-only group kernel "
                             f"{launches} times")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, hr)
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if getattr(getattr(e, "device_type", None), "name", "") == "CUDA"]
    total_us = sum(dev_us(e) for e in events)
    port_kernels = [e.key for e in events if "rcab_group" in e.key]
    g_flops = train_step_conv_flops(state.model.config, n, GAN_HR)
    # the D update: forwards on hr and sr, backward to inputs and weights
    # (the input gradient of the first conv is skipped); the G head: one
    # forward on sr and its backward to the input only
    d_fwd = disc_work_flops(n, GAN_HR, GAN_D_BASE)
    d_flops = 2 * 3 * d_fwd + 2 * d_fwd
    log(f"  profiler, one production GAN step: {total_us / 1e3:.3f} ms device time, "
        f"{len(events)} device op kinds, port kernels {port_kernels}; work: G content step "
        f"3x3 convs {g_flops / 1e12:.3f} TFLOP + D {d_flops / 1e12:.3f} TFLOP = "
        f"{(g_flops + d_flops) / max(total_us, 1) / 1e6:.2f} TFLOP/s over the device time, "
        f"{(g_flops + d_flops) / max(total_us, 1) * 1e6 / F32_PEAK_FLOPS * 100:.1f}% of the f32 "
        f"peak [{card}]")
    for e in sorted(events, key=lambda e: -dev_us(e))[:15]:
        log(f"    {dev_us(e) / max(total_us, 1) * 100:6.2f}%  {dev_us(e) / 1e3:9.3f} ms"
            f"  x{e.count:<5} {e.key[:90]}")
    if port_kernels:
        raise AssertionError(f"the GAN step ran a kernel of the port: {port_kernels}")

    # the discriminator's two parts, each forward + backward alone
    disc = state.disc
    d_params = list(disc.parameters())
    with torch.no_grad():
        sr = state.model(bicubic_down(hr, 4), train=True)
    sr_g = sr.clone().requires_grad_(True)

    def d_update_part():
        with full_f32():
            d_loss = (gan_loss(disc(hr, train=True), True) + gan_loss(disc(sr, train=True), False)) / 2
            torch.autograd.grad(d_loss, d_params)

    def g_head_part():
        with full_f32():
            torch.autograd.grad(gan_loss(disc(sr_g, train=True), True), sr_g)

    stats = {k: v.clone() for k, v in disc.named_buffers()}
    d_ms = cuda_ms(d_update_part, iters=3, warmup=1)
    head_ms = cuda_ms(g_head_part, iters=3, warmup=1)
    disc.load_stats(stats)
    log(f"  alone, forward + backward: the D update (D on hr and sr, gradients of D's "
        f"weights) {d_ms:.3f} ms = {d_ms / ms * 100:.1f}% of the step; the G head's D "
        f"(forward on sr, gradient of sr) {head_ms:.3f} ms = {head_ms / ms * 100:.1f}%; D's "
        f"work {d_flops / 1e12:.3f} TFLOP in {d_ms + head_ms:.3f} ms = "
        f"{d_flops / (d_ms + head_ms) / 1e9:.2f} TFLOP/s [{card}]")
    del state, step, loss, hr, sr, sr_g, disc, d_params
    torch.cuda.empty_cache()
    gan_trainer_phase(dev)
    log(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s [{card}]")


# phase 11: the serving stack. A request of two chunks at MAX_BATCH (128
# and 2); SpatialPredictor shapes (the first reaches the group kernel's
# scratch variant) and its timed group call (N, H, W, C, B); the exported
# artifact's batches; HTTP: keep-alive clients x 64x64 requests each, the
# first HTTP_HR_CLIENTS clients adding one 256x256 request (the crop and
# synthesise branch); distinct request images; host-split repetitions
SERVE_REQUEST = 130
SPATIAL_SHAPES = ((1, 256, 256, 3), (1, 96, 96, 3))
SCRATCH_TIMING = (1, 256, 256, 64, 10)
SCRATCH_REPS = 5
EXPORT_BATCHES = (1, 8)
HTTP_CLIENTS, HTTP_REQUESTS, HTTP_HR_CLIENTS = 16, 8, 4
HTTP_LR_IMAGES, HTTP_HR_IMAGES = 16, 4
HTTP_TIMEOUT = 120  # seconds, every socket and join
HTTP_WINDOW_MS, HTTP_MAX_BATCH = 20.0, 16
SPLIT_REPS = 20


def model_limits(model, x, dev):
    """Phase 4's reference and limits on input ``x``: the plain trunk's
    output (unclamped) and MODEL_RTOL times the max and mean of its
    residual |out - bicubic|."""
    from facesr_torch.ops.rcab_group import rcab_group_reference
    from facesr_torch.ops.resize import bicubic_up

    def trunk(groups, feat):
        for g in groups:
            feat = rcab_group_reference(feat, group_weights(g, dev), model.config.res_scale)
        return feat

    with torch.inference_mode():
        out = model(x, train=True, dtype=torch.bfloat16, trunk_fn=trunk)
        resid = (out - bicubic_up(x, 4)).abs()
        return (out.float().cpu().numpy(), MODEL_RTOL * resid.max().item(),
                MODEL_RTOL * resid.mean().item())


def check_within(name, got, want, limit_max, limit_mean):
    d = np.abs(got - want)
    log(f"  {name}: bitwise equal {np.array_equal(got, want)}, max_abs={d.max():.6g} "
        f"(limit {limit_max:.6g}) mean_abs={d.mean():.6g} (limit {limit_mean:.6g})")
    if got.shape != want.shape or d.max() > limit_max or d.mean() > limit_mean:
        raise AssertionError(f"{name} disagrees with its reference beyond phase 4's limits")


def check_equal(name, got, want):
    """Bitwise equality, where the same computation ran at the same shape."""
    same = got.shape == want.shape and np.array_equal(got, want)
    log(f"  {name}: bitwise equal {same}")
    if not same:
        d = np.abs(got.astype(np.float64) - want) if got.shape == want.shape else None
        raise AssertionError(f"{name}: not bitwise equal (shapes {got.shape} {want.shape}, "
                             f"max_abs {None if d is None else d.max()})")


def smooth_u8(n, h, w, seed):
    """Face-like smooth uint8 images (a coarse random field upsampled with
    the port's cubic resize, plus noise)."""
    from facesr_torch.data.cv_compat import resize_cubic

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lo = (rng.random((6, 6, 3)) * 255).astype(np.uint8)
        img = resize_cubic(lo, (w, h)).astype(int) + rng.integers(-10, 11, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def drive_http(port, bodies, plan):
    """Run ``plan`` (one list of body indices a client) from one keep-alive
    ``http.client`` connection a client thread. Each client's first request
    warms its connection's server thread (its CUDA library handles) and is
    timed apart; the rest start together after a barrier. Returns (timed
    wall s, timed latencies s, warm-up latencies s, [(body index, status,
    data)] of every request, errors)."""
    lat, warm, results, errors = [], [], [], []
    lock = threading.Lock()
    barrier = threading.Barrier(len(plan) + 1)
    timing = {}

    def client(indices):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
        try:
            for k, i in enumerate(indices):
                if k == 1:
                    barrier.wait(timeout=HTTP_TIMEOUT)
                t0 = time.perf_counter()
                conn.request("POST", "/super-resolve", body=bodies[i])
                resp = conn.getresponse()
                data = resp.read()
                with lock:
                    (warm if k == 0 else lat).append(time.perf_counter() - t0)
                    results.append((i, resp.status, data))
        except Exception as e:  # noqa: BLE001 — reported and failed by the caller
            with lock:
                errors.append(repr(e))
            barrier.abort()
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(p,)) for p in plan]
    for t in threads:
        t.start()
    try:
        barrier.wait(timeout=HTTP_TIMEOUT)
        timing["t0"] = time.perf_counter()
    except threading.BrokenBarrierError:
        timing["t0"] = time.perf_counter()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT)
    wall = time.perf_counter() - timing["t0"]
    if any(t.is_alive() for t in threads):
        errors.append("a client thread did not finish")
    return wall, lat, warm, results, errors


def http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def serving_phase(dev, card: str, tmp: Path, fwd_ms: float, pred_ms: float) -> dict:
    """Phase 11: the serving stack on the card. Returns the group-kernel
    launches of its main paths and the scratch variant's timings."""
    from facesr_torch.app import api
    from facesr_torch.app.demo import prepare_inputs
    from facesr_torch.ckpt import fckpt
    from facesr_torch.ckpt.export import export_serving, input_shape, load_exported
    from facesr_torch.data import png
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.parallel.serving import Predictor, SpatialPredictor, build_serving_fn

    log(f"== 11. serving stack: Predictor, SpatialPredictor, torch.export, HTTP API "
        f"(bitwise against the same computation; the unclamped forward within phase 4's "
        f"limits, MODEL_RTOL={MODEL_RTOL} of the residual) [{card}]")
    t_phase = time.perf_counter()
    cfg = production_config()
    per_fwd = cfg.num_groups
    model = production_model(dev, nonzero_last=True)
    launches = 0

    def counted(fn):
        """fn() with every kernel's count zeroed just before and read just
        after; returns (result, launches)."""
        nonlocal launches
        rg.fused_residual_group.launches = 0
        out = fn()
        torch.cuda.synchronize()
        n = rg.fused_residual_group.launches
        launches += n
        return out, n

    # 11a: Predictor, one request of two chunks at their true sizes
    pred = Predictor(model, dtype=torch.bfloat16, max_batch=MAX_BATCH, device=dev)
    request = np.random.default_rng(11).random((SERVE_REQUEST, 64, 64, 3), dtype=np.float32)
    chunks = []
    inner = pred._forward
    pred._forward = lambda x: (chunks.append(x.shape[0]), inner(x))[1]
    out, n = counted(lambda: pred(request))
    pred._forward = inner
    want_chunks = [min(MAX_BATCH, SERVE_REQUEST - s) for s in range(0, SERVE_REQUEST, MAX_BATCH)]
    log(f"  Predictor(max_batch={MAX_BATCH}) on {SERVE_REQUEST} images: chunks {chunks}, "
        f"{n} launches")
    if chunks != want_chunks or n != per_fwd * len(want_chunks):
        raise AssertionError(f"expected chunks {want_chunks} and {per_fwd * len(want_chunks)} "
                             f"launches, got {chunks} and {n}")
    fwd = build_serving_fn(model, torch.bfloat16)
    for start, size in zip(np.cumsum([0] + want_chunks[:-1]), want_chunks):
        x = torch.from_numpy(request[start:start + size]).to(dev)
        check_equal(f"chunk of {size} vs the model's direct forward", out[start:start + size],
                    fwd(x).float().cpu().numpy())
    x128 = request[:MAX_BATCH]
    xd = torch.from_numpy(x128).to(dev)
    y = fwd(xd)
    up_ms = host_ms(lambda: torch.from_numpy(x128).pin_memory().to(dev, non_blocking=True), 5)
    down_ms = host_ms(lambda: torch.empty(y.shape, pin_memory=True).copy_(y), 5)
    log(f"  Predictor at {MAX_BATCH}, numpy in and out: {pred_ms:.3f} ms = "
        f"{MAX_BATCH / pred_ms * 1e3:.1f} images/s against the forward alone {fwd_ms:.3f} ms = "
        f"{MAX_BATCH / fwd_ms * 1e3:.1f} images/s (phase 6); pinned upload of the input "
        f"{up_ms:.3f} ms, pinned download of the output {down_ms:.3f} ms, medians of 5 [{card}]")
    del y, xd

    # 11b: SpatialPredictor, one forward at the input's own shape

    def kernel_trunk(groups, feat):  # the eval forward's bf16 trunk
        feat = feat.contiguous()
        for gw in model.kernel_group_weights():
            feat = rg.fused_residual_group(feat, gw, model.config.res_scale)
        return feat

    sp = SpatialPredictor(model, dtype=torch.bfloat16, device=dev)
    for k, shape in enumerate(SPATIAL_SHAPES):
        x = np.random.default_rng(12 + k).random(shape, dtype=np.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got, n = counted(lambda: sp(x))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        variant = kernel_variant((shape[0], shape[1], shape[2], cfg.num_channels))
        log(f"  SpatialPredictor {shape} -> {got.shape}: {n} launches, group kernel {variant}, "
            f"peak device memory {peak:.3f} GiB [{card}]")
        if n != per_fwd or got.shape != (shape[0], 4 * shape[1], 4 * shape[2], 3):
            raise AssertionError(f"SpatialPredictor {shape}: {n} launches, output {got.shape}")
        xd = torch.from_numpy(x).to(dev)
        with torch.inference_mode():  # train=True: unclamped, through the serving trunk
            raw = model(xd, train=True, dtype=torch.bfloat16, trunk_fn=kernel_trunk)
        check_equal(f"SpatialPredictor {shape} vs the direct forward", got,
                    raw.clamp(0.0, 1.0).cpu().numpy())
        want, lmax, lmean = model_limits(model, xd, dev)
        check_within(f"the direct forward {shape}, unclamped, vs the plain trunk",
                     raw.cpu().numpy(), want, lmax, lmean)
        del raw, xd
        log(f"  SpatialPredictor {shape} numpy in and out: median of 5 "
            f"{host_ms(lambda: sp(x), 5):.3f} ms [{card}]")
    n_, h, w, c, B = SCRATCH_TIMING
    gw = group_weights(seeded_group(B, seed=13), dev)
    xs = torch.rand((n_, h, w, c), generator=torch.Generator().manual_seed(14)).to(
        torch.bfloat16).to(dev)
    variant = kernel_variant(xs.shape)
    if not variant.startswith("scratch"):
        raise AssertionError(f"{tuple(xs.shape)} should take the scratch variant, got {variant}")
    mx, mean, share, excess = group_diff(rg.fused_residual_group(xs, gw, 0.2),
                                         rg.rcab_group_reference(xs, gw, 0.2))
    if excess > 0:
        raise AssertionError(f"scratch variant disagrees with its plain version: max_abs {mx}")
    kernel = lambda: rg.fused_residual_group(xs, gw, 0.2)  # noqa: E731
    library = lambda: library_group(xs, gw, 0.2)  # noqa: E731
    # medians of SCRATCH_REPS means; eager, and replayed from one CUDA graph
    # so that the host's dispatch rate drops out (cuDNN's chain at N=1 is
    # ~100 small launches)
    scratch = {"ms": statistics.median(cuda_ms(kernel, iters=20) for _ in range(SCRATCH_REPS)),
               "graph_ms": graph_ms(kernel, iters=20, reps=SCRATCH_REPS),
               "plain_ms": cuda_ms(lambda: rg.rcab_group_reference(xs, gw, 0.2), iters=3,
                                   warmup=1),
               "library_ms": statistics.median(cuda_ms(library, iters=10)
                                               for _ in range(SCRATCH_REPS)),
               "library_graph_ms": graph_ms(library, iters=10, reps=SCRATCH_REPS)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        kernel()
    host_call_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    scratch["bound_ms"], scratch["bound_by"] = group_bound(n_, h, w, c, B, gw["fc1"].shape[-1])
    floor_bytes = scratch_traffic_bytes(n_, h, w, c, B)
    log(f"  one group call N={n_} {h}x{w} C={c} B={B} ({variant}), medians of {SCRATCH_REPS}: "
        f"kernel {scratch['ms']:.4f} ms eager and {scratch['graph_ms']:.4f} ms from a CUDA "
        f"graph (host enqueue {host_call_ms:.4f} ms a call), plain {scratch['plain_ms']:.4f} "
        f"ms, library (cuDNN bf16) {scratch['library_ms']:.4f} ms eager and "
        f"{scratch['library_graph_ms']:.4f} ms from a CUDA graph; bound "
        f"{scratch['bound_ms']:.4f} ms ({scratch['bound_by']}); the design's scratch traffic "
        f"{floor_bytes / 1e9:.4f} GB = {floor_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM "
        f"rate; vs plain max_abs={mx:.6g} differing={share:.6g} [{card}]")
    for key in ("ms", "graph_ms"):
        if scratch[key] >= scratch["library_graph_ms"]:
            raise AssertionError(f"the scratch variant ({key} {scratch[key]:.4f}) is not ahead "
                                 f"of graphed cuDNN ({scratch['library_graph_ms']:.4f} ms)")
    del xs, gw

    # 11c: torch.export, a symbolic batch, the group kernel as a custom op
    art = tmp / "face_sr_bf16.pt2"
    t0 = time.perf_counter()
    art.write_bytes(export_serving(model, torch.bfloat16))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = load_exported(str(art), device=dev)
    load_s = time.perf_counter() - t0
    batch_dim = input_shape(served.exported)[0]
    ops = sum(1 for nd in served.exported.graph.nodes
              if nd.target is torch.ops.facesr_torch.rcab_group.default)
    log(f"  export_serving(bf16): {art.stat().st_size / 1e6:.2f} MB in {export_s:.1f} s, "
        f"loaded in {load_s:.1f} s; batch dim {batch_dim}, {ops} rcab_group nodes")
    if isinstance(batch_dim, int) or ops != per_fwd:
        raise AssertionError(f"artifact: batch dim {batch_dim}, {ops} custom-op nodes")
    for batch in EXPORT_BATCHES:
        x = request[:batch]
        got, n = counted(lambda: served(x))
        want = pred(x)
        log(f"  artifact at batch {batch}: {n} launches")
        if n != per_fwd:
            raise AssertionError(f"the artifact launched the kernel {n} times, want {per_fwd}")
        check_equal(f"artifact at batch {batch} vs Predictor", got, want)

    # 11d: the HTTP API in this process, three ways, on a .fckpt of the model
    ckdir = tmp / "serve_checkpoints"
    fckpt.save_model(str(ckdir / "production.fckpt"), model)
    bodies = ([png.encode(im) for im in smooth_u8(HTTP_LR_IMAGES, 64, 64, seed=15)]
              + [png.encode(im) for im in smooth_u8(HTTP_HR_IMAGES, 256, 256, seed=16)])
    lrs = np.stack([prepare_inputs(png.decode_rgb(body))[0] for body in bodies])
    ref_u8 = [(pred(lr[None])[0] * 255).round().astype(np.uint8)  # Predictor at batch 1
              for lr in lrs]
    plan = [[c % HTTP_LR_IMAGES]  # the warm-up request
            + [(c * HTTP_REQUESTS + r) % HTTP_LR_IMAGES for r in range(HTTP_REQUESTS)]
            + ([HTTP_LR_IMAGES + c % HTTP_HR_IMAGES] if c < HTTP_HR_CLIENTS else [])
            for c in range(HTTP_CLIENTS)]
    n_req = sum(len(p) for p in plan)
    n_timed = n_req - len(plan)
    servers = (("bf16", dict(dtype="bf16")),
               (f"bf16 --batch-window-ms {HTTP_WINDOW_MS:g} --max-batch {HTTP_MAX_BATCH}",
                dict(dtype="bf16", batch_window_ms=HTTP_WINDOW_MS, max_batch=HTTP_MAX_BATCH)),
               ("--exported", dict(exported=str(art))))
    for label, kw in servers:
        root = str(tmp / "no_checkpoints") if "exported" in kw else str(ckdir)
        srv = api.serve(root, port=0, host="127.0.0.1", device=dev, **kw)
        cohorts = []  # (input batch, output) of every micro-batched forward

        def recorded(fn):
            def run(batch):
                out = fn(batch)
                cohorts.append((batch, out))
                return out
            return run

        for b in srv.service.batchers.values():
            b.fn = recorded(b.fn)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            port = srv.server_address[1]
            (wall, lat, warm, results, errors), n = counted(
                lambda: drive_http(port, bodies, plan))
            status, health = http_get(port, "/health")
        finally:
            srv.shutdown()
            srv.server_close()
            srv.service.close()
        if errors or len(results) != n_req or any(s != 200 for _, s, _ in results):
            failed = [(s, data[:300]) for _, s, data in results if s != 200]
            raise AssertionError(f"HTTP {label}: errors {errors[:3]}, {len(results)} of {n_req} "
                                 f"answered, statuses {sorted({s for _, s, _ in results})}; "
                                 f"{len(failed)} failed, the first: {failed[:3]}")
        batching = health.get("batching", {})
        calls = sum(b["calls"] for b in batching.values()) if batching else n_req
        images = sum(b["images"] for b in batching.values()) if batching else n_req
        # each body's exact references: Predictor's uint8 output at batch 1,
        # or, micro-batched, at the batch size of each cohort that held it
        # (every cohort's output recomputed by Predictor, bitwise)
        want_u8 = {i: [ref_u8[i]] for i in range(len(bodies))}
        if batching:
            want_u8 = {i: [] for i in range(len(bodies))}
            for batch, got in cohorts:
                if not np.array_equal(got, pred(batch)):
                    raise AssertionError(f"HTTP {label}: a cohort of {len(batch)} is not "
                                         "Predictor's output at its size")
                for row, lr in enumerate(batch):
                    i = next(i for i in range(len(lrs)) if np.array_equal(lr, lrs[i]))
                    want_u8[i].append((got[row] * 255).round().astype(np.uint8))
            log(f"  HTTP {label}: {len(cohorts)} cohorts of "
                f"{[len(batch) for batch, _ in cohorts]} images, each bitwise equal to "
                "Predictor at its size")
        exact, matched, worst, off = 0, 0, 0, {}
        for i, _, data in results:
            img = png.decode_rgb(data)
            if img.shape != (256, 256, 3):
                raise AssertionError(f"HTTP {label}: a response decodes to {img.shape}")
            d = int(np.abs(img.astype(int) - ref_u8[i].astype(int)).max())
            exact += d == 0
            worst = max(worst, d)
            if d:
                off[i] = max(off.get(i, 0), d)
            matched += any(np.array_equal(img, w) for w in want_u8[i])
        lat_ms = sorted(v * 1e3 for v in lat)
        p50 = lat_ms[len(lat_ms) // 2]
        p99 = lat_ms[min(len(lat_ms) - 1, int(math.ceil(0.99 * len(lat_ms))) - 1)]
        warm_ms = sorted(v * 1e3 for v in warm)
        log(f"  HTTP {label}: {n_timed} timed requests from {HTTP_CLIENTS} keep-alive clients "
            f"in {wall:.3f} s = {n_timed / wall:.1f} requests/s, latency p50 {p50:.3f} ms p99 "
            f"{p99:.3f} ms; each connection's first request (a new server thread) p50 "
            f"{warm_ms[len(warm_ms) // 2]:.3f} ms max {warm_ms[-1]:.3f} ms; {n_req} requests, "
            f"{calls} forwards, batching factor {images / calls:.3f} (/health "
            f"{json.dumps(batching) if batching else 'none'}); {n} launches; {matched} of "
            f"{n_req} responses exactly Predictor's uint8 output "
            f"{'at their cohort size' if batching else 'at batch 1'}; against Predictor at "
            f"batch 1: {exact} of {n_req} exact, worst {worst} level(s) (body: levels {off}; "
            f"bodies {HTTP_LR_IMAGES}+ are 256x256) [{card}]")
        if matched != n_req:
            raise AssertionError(f"HTTP {label}: {n_req - matched} of {n_req} responses are not "
                                 "Predictor's output on their own LR")
        if batching and len(cohorts) != calls:
            raise AssertionError(f"HTTP {label}: {len(cohorts)} cohorts recorded, /health "
                                 f"counts {calls} forwards")
        if n != per_fwd * calls:
            raise AssertionError(f"HTTP {label}: {n} launches for {calls} forwards "
                                 f"(want {per_fwd} a forward)")

    # controls: an f32 server launches no kernel; a JPEG body is a 400;
    # int8 raises at startup
    srv = api.serve(str(ckdir), port=0, host="127.0.0.1", device=dev, dtype="f32")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        port = srv.server_address[1]
        (_, _, _, results, errors), n = counted(lambda: drive_http(port, bodies, [[0, 1]]))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
        try:
            conn.request("POST", "/super-resolve", body=b"\xff\xd8\xff\xe0\x00\x10JFIF" + b"\0" * 64)
            resp = conn.getresponse()
            jpeg_status, jpeg_body = resp.status, resp.read()
        finally:
            conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()
    if errors or [s for _, s, _ in results] != [200, 200] or n != 0:
        raise AssertionError(f"f32 server: errors {errors}, statuses "
                             f"{[s for _, s, _ in results]}, {n} launches (want 0)")
    if jpeg_status != 400 or b"A.7.2" not in jpeg_body:
        raise AssertionError(f"a JPEG body got {jpeg_status} {jpeg_body[:120]!r}")
    try:
        api.SRService(str(ckdir), dtype="int8", device=dev)
    except NotImplementedError as e:
        int8_msg = str(e)
    else:
        raise AssertionError("--dtype int8 started a server")
    log(f"  controls: f32 server 2 requests, 200, 0 launches; JPEG body -> {jpeg_status} "
        f"{json.loads(jpeg_body)['error'][:60]!r}...; --dtype int8 -> NotImplementedError "
        f"{int8_msg[:50]!r}...")

    # how one request's host time splits (one thread, no server)
    server_pred = Predictor(model, dtype=torch.bfloat16, max_batch=1, device=dev)
    for label, body in (("64x64", bodies[0]), ("256x256", bodies[HTTP_LR_IMAGES])):
        rgb = png.decode_rgb(body)
        lr, _ = prepare_inputs(rgb)
        sr = server_pred(lr[None])[0]
        u8 = (sr * 255).round().astype(np.uint8)
        split = {"PNG decode": host_ms(lambda: png.decode_rgb(body), SPLIT_REPS),
                 "prepare_inputs": host_ms(lambda: prepare_inputs(rgb), SPLIT_REPS),
                 "forward (Predictor, numpy in and out)":
                     host_ms(lambda: server_pred(lr[None]), SPLIT_REPS),
                 "PNG encode": host_ms(lambda: png.encode(u8, level=api.PNG_LEVEL), SPLIT_REPS)}
        log(f"  one {label} request's host work, medians of {SPLIT_REPS}: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
            + f"; sum {sum(split.values()):.3f} ms [{card}]")
    log(f"  {launches} group launches on phase 11's main paths; phase 11 took "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    del pred, sp, server_pred, served, model
    torch.cuda.empty_cache()
    return {"launches": launches, "scratch": scratch}


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
    max_err = max(check_kernel(dev, shape, B, seed=i, ramp=i >= RAMP_FROM)
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
    # train=True for the unclamped output; the trunk is named, since a
    # training forward runs the plain trunk
    kernel_trunk = trunk_of(lambda f, gw: fused_residual_group(f, gw, res_scale))
    with torch.inference_mode():
        out_k = model(x4, train=True, dtype=torch.bfloat16, trunk_fn=kernel_trunk)
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
        # the split fault against the kernel tolerance, at phase 3's 256x256 check
        shape, B = CHECK_SHAPES[SPLIT_CHECK]
        gw = group_weights(seeded_group(B, SPLIT_CHECK), dev)
        xg = check_input(shape, SPLIT_CHECK, dev)
        mx, mean, share, excess = group_diff(
            planted_fault_group(xg, gw, 0.2, SPLIT_FAULT), rcab_group_reference(xg, gw, 0.2))
        log(f"  planted fault {SPLIT_FAULT}, one group {shape} B={B} vs plain: "
            f"max_abs={mx:.6g} mean_abs={mean:.6g} differing={share:.6g} -> "
            f"{'rejected' if excess > 0 else 'within'} the kernel tolerance")
        if excess <= 0:
            raise AssertionError(f"the kernel tolerance lets the planted fault "
                                 f"{SPLIT_FAULT} pass")
        zero_last = production_model(dev, nonzero_last=False)
        out_z = zero_last(x4, train=True, dtype=torch.bfloat16, trunk_fn=kernel_trunk)
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

    del fwd, pred, model, xg, x128
    torch.cuda.empty_cache()
    step_alone_ms = training_phase(dev, card)
    with tempfile.TemporaryDirectory(prefix="facesr_torch_cli_") as tmp:
        cli_phase(card, step_alone_ms, Path(tmp))
        eval_launches = eval_phase(dev, card, Path(tmp))
    launches["fused_residual_group"] += eval_launches  # phase 5's and phase 9's main paths
    gan_phase(dev, card)
    with tempfile.TemporaryDirectory(prefix="facesr_torch_serve_") as tmp:
        serving = serving_phase(dev, card, Path(tmp), fwd_med * 1e3, pred_med * 1e3)
    launches["fused_residual_group"] += serving["launches"]  # and phase 11's

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
        "scratch_ms": serving["scratch"]["ms"],
        "scratch_graph_ms": serving["scratch"]["graph_ms"],
        "scratch_plain_ms": serving["scratch"]["plain_ms"],
        "scratch_library_ms": serving["scratch"]["library_ms"],
        "scratch_library_graph_ms": serving["scratch"]["library_graph_ms"],
        "scratch_bound_ms": serving["scratch"]["bound_ms"],
    }]}
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
