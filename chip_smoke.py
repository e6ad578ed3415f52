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
   production shape, ragged ones, a width past one tile, a lone image,
   the scratch variant spread over many clusters (one 256x256 image over
   every SM, ragged units, several images sharing the clusters) and the
   transfer head's B = 4 at 128x64x64 and 1x256x256, on
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
   ``best_model.fckpt`` (the Trainer writes it beside ``best_model.pth``)
   bitwise and stage 3 from stage 2's, whose
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
   controls (an f32 server launches nothing, a JPEG body gets 400); one
   request's host time split into PNG decode, `prepare_inputs`, the
   forward and PNG encode;
12. int8 serving and QAT, the sixth path: the s8 conv (im2col +
   ``torch._int_mm``) at every shape the 6x10x64 model gives it, its s32
   product bitwise against the f64 conv and its output against the CPU's,
   the packed conv_last against the conv on the shuffled map; at batch 128
   ``int8`` (weight-only) through `Predictor`, the counts zeroed just
   before and read just after: 6 group launches a forward, bitwise the
   bf16 forward of a model holding the dequantized weights; ``int8_full``
   with dynamic and with calibrated scales (phase 8's val LR PNGs): no
   launch, and at a 2x2x64 depth on 4 images the card's PSNR against the
   CPU f32 forward within 1 dB of the CPU port's; forward ms, Predictor
   images/s and peak memory of bf16, int8 and both int8_full modes, and
   the profiler's split of the int8_full forwards between the ``_int_mm``
   GEMMs, the im2col and the rest, and one trunk conv's stages timed
   apart; `SpatialPredictor` int8_full at 1x256x256 (time, peak memory); ``cli.export_quantized`` on phase 8's
   val HR PNGs, then the HTTP API with ``--dtype int8_full --quant-cache``
   and with ``--dtype int8``, every response exactly `Predictor`'s uint8
   output; the control: that cache on other weights is refused at
   startup; one small QAT step on the card against the CPU with the TF32
   control, phase 7's production step fake-quantized (ms/step); and the
   train CLI on ``configs/rehearsal/stage1_qat_ft.yaml``
   with ``--qat-scales`` on phase 8's PNG set for one epoch.
13. the model zoo, the seventh path, at full width with seeded random
   weights (RRDBNet x4plus: 23 RRDBs, 64 features, growth 32; the
   transfer model: 16 RRDBs and a head of 4 RCABs at 64 channels): each
   in f32 on the card against the CPU port on 2 images (TF32 off; a
   TF32-forced control must be rejected); the bf16 forward at batch 128
   (CUDA events, median of 3: ms, images/s, TFLOP/s from the conv MACs,
   peak memory, the profiler's split into cuDNN convs, concatenation
   copies, the group kernel and the rest); the transfer head on the group
   kernel (one launch a forward) against the plain head, held to phase
   4's share (2^-5) of the head's own effect on the output, with a dropped
   SE gate as the control; one group call at B = 4 timed against its
   plain version, cuDNN and the bound; `Predictor(bf16, 128)` of each,
   bitwise ``clamp(forward)``, the counts zeroed just before and read
   just after; `.pth` and `.fckpt` files written by the port and read back
   by `load_any_model`, bitwise the same forward;
   ``configs/transfer_config.yaml`` through the train CLI on phase 8's PNG
   set (its batch 32, one epoch: the backbone bitwise unchanged, every
   head weight changed) against the transfer step alone, and ``--model
   esrgan`` with the stage-1 YAML at its batch 48 (or the largest that
   fits); the small transfer steps of stages 1-3 and the ESRGAN step, card
   against CPU in f32 (frozen tensors bitwise unchanged; a TF32 control);
   ``test_model`` on the trained transfer checkpoint, ``compare_two_models``
   with a FaceEnhanceNet, a transfer and an RRDBNet row, and the HTTP API
   serving the transfer ``.fckpt`` in bf16, every response bitwise
   `Predictor`'s batch-1 output.
14. the zoo's int8 and ``.pt2``, the eighth path, at phase 13's full
   widths and seeded weights: RRDBNet and TransferSRModel at batch 128
   in bf16, ``int8``, ``int8_full`` dynamic and ``int8_full`` calibrated
   (on 32 of phase 8's 64x64 val LR PNGs, written as a quant cache):
   forward ms (CUDA events, mean of 2), `Predictor` images/s (median of
   2), peak memory, group launches a forward (the transfer model's bf16
   and int8: 1) and the profiler's split of each int8 forward; the
   weight-only int8 transfer forward bitwise the bf16 forward of a copy
   holding the dequantized weights, its kernel head held to phase 4's
   share of the plain head's effect, with a dropped SE gate as the
   control; ``int8_full`` on the card against the CPU port (RRDBNet 2 x 64
   growth 32, transfer 2+2 at 64, 4 images, both scale modes: bitwise in
   bf16); ``.pt2`` files with a
   symbolic batch of RRDBNet (bf16), the transfer model (bf16,
   ``int8_full`` on the quant cache) and FaceEnhanceNet 6x10x64 (``int8``,
   ``int8_full``), each loaded back and run at batch 1 and 128 against
   the live forward (int8 bitwise, bf16 within 1e-2), its custom-op nodes
   counted (``rcab_group``: 0, 1, 0, 6, 0; one ``int8_conv`` an
   int8_full site), its MB and export and load seconds; the HTTP API with
   ``--exported`` on the transfer int8_full artifact, each response
   bitwise the artifact's batch-1 output; ``configs/transfer_config.yaml``
   with ``training.qat: true`` through the train CLI (one epoch, phase 8's
   PNGs) against phase 13's step; the small RRDBNet and transfer (stage 2)
   QAT steps on the card against the CPU within 1e-4, frozen tensors
   bitwise, the CPU taking the card's fake-quant level wherever the two
   round a tie apart (an activation within 1e-3 of a level boundary;
   counted), each with its TF32 control rejected.
15. explainability, ``stage_panel`` and the checkpoint bridge (no kernel:
   everything here runs in f32, and the phase fails if the group kernel
   launches): Grad-CAM of the 6x10x64 model (conv_last non-zero) on 8
   64x64 images at conv_first, group3 and group6, all four regions, and
   the SE attention, on the card against the CPU (CAM max abs <= 1e-4,
   attention <= 1e-5), with a TF32 control that must be rejected; the ms
   of ``generate_multi_region`` (batch 8) and ``visualize_attention_flow``
   (one image), CUDA events, median of 2, the peak memory, and
   ``create_attention_report``'s files; then (15.3) the stage-1 Trainer
   (batch 48, HR 256, L1 + perceptual, EMA on, epochs of 2 batches) for
   1 epoch, resumed fully in a new Trainer from its ``.fckpt`` and from
   its ``.pth``, for 1 more, against 2 uninterrupted epochs (params, EMA,
   moments, counts bitwise with cuDNN deterministic for this phase only,
   else within 1e-6 relative L2 a tensor, the reason printed), and the
   same for the GAN trainer at batch 8, HR 64 (D, its stats and its
   optimiser too), with the ``.fckpt``'s size and write time; (15.2)
   ``python -m facesr_torch.cli.stage_panel`` on 15.3's epoch 1 and 2
   files and 4 256x256 PNGs with ``--device cuda`` and ``--device cpu``
   (panels at most 1 level apart on at most 0.5% of pixels) and their
   wall times; (15.4) ``python -m facesr_torch.cli.convert`` of a
   FaceEnhanceNet 6x10x64 and an RRDBNet x4plus ``.pth`` to ``.fckpt``
   and back with ``--reverse``: the state dict bitwise, keys in order.
16. data parallelism, in child processes (`parallel.launch.run_ranks`)
   started after the parent freed its cache. The machine has one card, so
   NCCL runs at world size 1 and two ranks share cuda:0 over gloo (NCCL
   refuses two ranks on one device). One world-1 NCCL rank: (d) the train
   CLI on the stage-1 YAML under torchrun's environment with
   ``--print-memory`` for one epoch on phase 8's PNGs (the measured step
   peak against phase 7's), (a) the stage-1 step (6x10x64 f32, batch 48,
   HR 256) in the group bitwise the step alone (cuDNN deterministic), the
   all-reduce ms of the gradient bucket, and (e) `ShardedPredictor` over
   [cuda:0, cuda:0] in bf16 at batch 128: each 64-image shard bitwise
   `Predictor` at that size, 6 group launches a shard (counted in the
   kernel line), images/s. Two gloo ranks: (b) the stage-1 and the GAN
   step, 24 of the 48 rows each, against the single-process step on all
   48 (relative L2 of each loss, gradient, parameter and BN stat, TF32
   off, each <= max(1e-4, 10 x that tensor's rounding floor: its largest
   error in the same single-process step on its input times (1 + 2^-23
   noise), two noise draws, with G, D's convs and D's dense layers run on
   the ranks' row blocks), the
   controls (one rank's rows alone, unreduced; a per-rank BatchNorm)
   rejected by the same limits, the ranks' states bitwise equal after 2 steps, ms
   a dp step and of a gloo all-reduce of the bucket (two ranks
   time-sharing one card: no speedup figure); (c) a Trainer epoch on phase
   8's PNGs, 24 rows a rank a step, only rank 0 writing.
17. spatial parallelism (image rows over a mesh; one card, so two row
   shards share cuda:0): (a) `SpatialPredictor` over [cuda:0, cuda:0] at
   1x256x256 LR (one thread and stream a shard) against [cuda:0]: f32
   within max abs 1e-4; bf16, ``int8`` (both the plain trunk) and
   ``int8_full`` (calibrated on phase 8's PNGs, and dynamic) bitwise; the
   kernel trunk (bf16, and int8 on a dequantized copy) against two plain
   shards on the unclamped outputs within phase 4's limits; group launches
   0 sharded and 6 at n = 1; controls that those checks must reject: a
   zero-filled halo (f32, bf16), an SE mean over the shard's rows (bf16,
   ``int8_full``) and a dynamic int8 scale over the shard's rows; ms a
   call, peak memory and the exchanges a forward; (b) the stage-1 step
   (f32, batch 48, HR 256, L1 + VGG19 conv3_4) on a data,space [1, 2]
   grid of two gloo ranks against the single-process step, each tensor
   within phase 16's floor-based limit, gradients summed over space (the
   wrong factor) rejected, the ranks' states bitwise equal, ms a step;
   (c) the stage-1 YAML through the train CLI on data,space [1, 2] under
   torchrun's environment with ``--dist-backend gloo`` and
   ``--print-memory`` for one epoch on 96 of phase 8's train PNGs (two
   steps) and its val set; (d) stage 3's GAN step (G 6x10x64, D at 256
   with 64 base channels and BatchNorm, batch 16) on the grid against
   the single-process step, within the same floor-based limits, the
   wrong factor rejected on G's and D's gradients, D's forward alone
   against one process with a zero stride-2 halo and a BatchNorm over
   one shard's rows as its controls, the ranks bitwise, ms a step, peak
   and exchanges; (e) phase 12's QAT step (batch 2) on the grid, its
   fake-quant levels pinned at ties to the single-process step's (none
   off a tie, ties counted), within the floor-based limits, a per-shard
   activation scale rejected; (f) the stage-3 YAML chained from (c)'s
   final model and the QAT YAML (with phase 12's calibrated scales when
   there), each through the CLI on the grid for one epoch of two steps,
   side by side: exit codes, finite val PSNR, rank 0 writing.

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
# (`check_input`), so that an SE mean over part of an image shows; last,
# the transfer head's shape class (B = 4) at the serving batch and at
# SpatialPredictor's 256x256
CHECK_SHAPES = (((4, 64, 64, 64), 10), ((128, 64, 64, 64), 10),
                ((3, 20, 36, 64), 3), ((40, 20, 36, 64), 3),
                ((2, 40, 80, 64), 2), ((1, 64, 64, 64), 10), ((2, 12, 17, 64), 2),
                ((1, 256, 256, 64), 10), ((1, 130, 200, 64), 2), ((3, 96, 96, 64), 3),
                ((80, 40, 80, 64), 2), ((128, 64, 64, 64), 4), ((1, 256, 256, 64), 4))
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
TRAIN_BATCH, TRAIN_HR, TRAIN_WARMUP, TRAIN_TIMED = 48, 256, 2, 3
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


def production_step_fn(dev, qat: bool = False, mesh=None, opt_cls=None):
    """Stage-1 training at the production width, the YAML's values written
    out (the card has no PyYAML): FaceEnhanceNet 6x10x64 (remat save_ca),
    f32, L1 + perceptual conv3_4, AdamW lr 1e-4, wd 0, clip 0.5,
    vgg_remat off; with ``qat`` every int8 site fake-quantized. conv_last
    is redrawn non-zero: from the zero init the output is the bicubic
    skip, and the first steps move away from it before the loss falls.
    ``mesh``: the step's data-parallel mesh; ``opt_cls``: the optimiser's
    class (phase 16's records the gradients), kept as ``step.optimizers``.
    Returns (state, step, loss)."""
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.ops.init import kaiming_normal
    from facesr_torch.ops.quant import fake_quant_params
    from facesr_torch.training import steps
    from facesr_torch.training.optim import AdamW

    model = FaceEnhanceNet(production_config().replace(remat="save_ca"), seed=0, device="cpu")
    with torch.no_grad():
        model.conv_last.weight.copy_(kaiming_normal(model.conv_last.weight.shape,
                                                    torch.Generator().manual_seed(1), scale=0.1))
    model.to(dev)
    loss = stage1_loss(dev)
    opt = (opt_cls or AdamW)(weight_decay=0.0, gradient_clip=0.5)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), 1e-4),
                             loss_params=loss.params)
    sites = fake_quant_params(model) if qat else None
    step = steps.make_train_step(lambda lp, p, t: loss.apply(lp, p, t, vgg_remat=False), opt,
                                 compute_dtype=None, quant_fn=(lambda: sites) if qat else None,
                                 mesh=mesh)
    step.optimizers = (opt,)
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
        want_files = sorted(f"{stem}{suffix}" for stem in ("best_model", "epoch_1", "epoch_2",
                                                             "final_model")
                            for suffix in (".fckpt", ".pth"))
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
    if not {"best_model.pth", "final_model.pth", "best_model.fckpt",
            "final_model.fckpt"} <= set(files):
        raise AssertionError(f"checkpoint files {files}")
    for stage in (2, 3):
        text = results[stage][1]
        # the Trainer writes .fckpt beside .pth: the YAML's name is found
        mapped = ("not found; loading the port's" not in text
                  and "Chaining from stage checkpoint ./checkpoints/best_model.fckpt" in text)
        path, state = chained[stage] or ("", {})
        want = best[stage - 1]
        bitwise = (path.endswith("best_model.fckpt") and set(state) == set(want)
                   and all(torch.equal(state[k], want[k]) for k in want))
        log(f"  stage {stage} chained from stage {stage - 1}'s ./checkpoints/best_model.fckpt "
            f"(the port's own, no .pth fallback): {mapped}; weights right after the load "
            f"bitwise equal to best_model.pth's model_state_dict: {bitwise}")
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
GAN_BATCH, GAN_HR, GAN_D_BASE, GAN_WARMUP, GAN_TIMED = 48, 256, 64, 2, 3


def gan_step_fn(dev, mesh=None, opt_cls=None):
    """Stage 3's GAN step at the production width, the YAML's values written
    out: FaceEnhanceNet 6x10x64 (remat save_ca, conv_last redrawn
    non-zero), f32, L1 0.01 + perceptual 1.0 at conv3_4, vanilla GAN
    0.005, G AdamW lr 1e-5 wd 0 clip 0.5, D AdamW lr 1e-4 wd 0 (no clip),
    one D update a step; ``mesh`` and ``opt_cls`` as `production_step_fn`'s
    (``step.optimizers`` is (G's, D's)). Returns (state, step, loss)."""
    from facesr_torch.losses.combined import CombinedLoss, LossConfig
    from facesr_torch.models.discriminator import create_discriminator
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.ops.init import kaiming_normal
    from facesr_torch.ops.quant import fake_quant_params
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
    opt_cls = opt_cls or AdamW
    opt = opt_cls(weight_decay=0.0, gradient_clip=0.5)
    d_opt = opt_cls(weight_decay=0.0, gradient_clip=0.0)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), 1e-5),
                             loss_params=loss.params, disc=disc,
                             d_opt_state=d_opt.init(dict(disc.named_parameters()), 1e-4))
    step = steps.make_gan_train_step(lambda lp, p, t: loss.apply(lp, p, t, vgg_remat=False),
                                     opt, d_opt, gan_weight=0.005, gan_type="vanilla", mesh=mesh)
    step.optimizers = (opt, d_opt)
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

    # controls: an f32 server launches no kernel; a JPEG body is a 400
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
    log(f"  controls: f32 server 2 requests, 200, 0 launches; JPEG body -> {jpeg_status} "
        f"{json.loads(jpeg_body)['error'][:60]!r}... (the int8 startup control is phase 12's)")

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


# phase 12: int8 serving and QAT. The int8 conv's shapes in the 6x10x64
# model at a 64x64 input (batch 4): conv_first (K 27 -> 32), a trunk conv,
# the two upsample convs, conv_last (N 3 -> 8) and the subpixel-packed
# conv_last on the packed 128x128 map (K 2304, N 12 -> 16)
INT8_CONV_SHAPES = (("conv_first", (4, 64, 64, 3), 64), ("trunk conv", (4, 64, 64, 64), 64),
                    ("upsample conv 1", (4, 64, 64, 64), 256),
                    ("upsample conv 2", (4, 128, 128, 64), 256),
                    ("conv_last", (4, 256, 256, 64), 3),
                    ("packed conv_last", (4, 128, 128, 256), 12))
INT8_TIMED = 3                    # timed forwards / Predictor calls a mode
INT8_CHECK_IMAGES = 4             # card against the CPU port (bf16: bitwise), at
INT8_CHECK_DEPTH = (2, 2)         # groups, blocks of that comparison's model
INT8_CALIB_IMAGES = 32            # phase 8's val LR PNGs that calibrate int8_full
INT8_HTTP_CLIENTS, INT8_HTTP_REQUESTS = 8, 4
INT8_SPATIAL = (1, 256, 256, 3)   # SpatialPredictor's int8_full input
QAT_WARMUP, QAT_TIMED = 1, 2      # the production QAT step
QAT_YAML = REPO / "configs/rehearsal/stage1_qat_ft.yaml"


def int8_conv_exact(dev, name, shape, cout, seed) -> str:
    """The int8 conv's s32 product on the card against the f64 conv of the
    same integers (exact: every partial sum is an integer below 2^53), and
    its dequantized bf16 and f32 outputs against the CPU's, all bitwise; at
    the packed shape also the packed conv against the shuffled one."""
    import torch.nn.functional as F

    from facesr_torch.ops import conv as tconv
    from facesr_torch.ops.pixel_shuffle import pixel_shuffle
    from facesr_torch.ops.quant import Int8Weight

    gen = torch.Generator().manual_seed(seed)
    n, h, w, cin = shape
    q = torch.randint(-127, 128, (cout, cin, 3, 3), generator=gen).to(torch.int8)
    scale = torch.rand(cout, generator=gen) * 1e-3 + 1e-4
    b = torch.randn(cout, generator=gen) * 0.1
    x = torch.randn(shape, generator=gen)
    wt = Int8Weight(q, scale).to(dev)
    xq = tconv.quantize_act(x.to(dev), x.abs().amax().to(dev) / 127)
    y = torch.cat([c.reshape(-1, cout) for c, *_ in
                   tconv._int8_gemm_conv(xq, wt, 1, (1, 1))]).reshape(n, h, w, cout)
    want = F.conv2d(xq.permute(0, 3, 1, 2).double(), q.to(dev).double(), padding=1)
    exact = torch.equal(y, want.permute(0, 2, 3, 1).to(torch.int32))
    same = all(torch.equal(tconv.conv2d(x.to(dev), wt, b.to(dev), padding=1, dtype=dt).cpu(),
                           tconv.conv2d(x, Int8Weight(q, scale), b, padding=1, dtype=dt))
               for dt in (torch.bfloat16, None))
    k = 9 * cin
    note = (f"  int8 conv {name} {shape} -> {cout}: K {k} -> {-(-k // 8) * 8}, N {cout} -> "
            f"{-(-cout // 8) * 8}; s32 == f64 conv {exact}; bf16 and f32 outputs == the "
            f"CPU's {same}")
    if not (exact and same):
        raise AssertionError(note)
    if cin == 4 * cout:  # the packed conv_last: == the conv on the shuffled map
        wl = Int8Weight(q[:, :cin // 4], scale, torch.tensor(0.02)).to(dev)
        unpacked = tconv.conv2d(pixel_shuffle(xq, 2), wl, b.to(dev), padding=1)
        packed = pixel_shuffle(tconv.conv2d(xq, wl.subpixel_packed(),
                                            b.to(dev).repeat_interleave(4), padding=1), 2)
        if not torch.equal(packed, unpacked):
            raise AssertionError(f"packed conv_last != the conv on the shuffled map: "
                                 f"{(packed - unpacked).abs().max().item()}")
        note += "; packed == unpacked on the card"
    return note


def int8_profile_split(fn) -> str:
    """The profiler's device time of one call of ``fn``, split by aten op:
    the ``_int_mm`` GEMMs, the im2col (pad, slices, cat) and the rest
    (quantize, dequant, PReLU, SE, bicubic)."""
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::") and dev_us(e) > 0]
    total = sum(dev_us(e) for e in ops)
    if total <= 0:
        return "profiler: no device time recorded"
    groups = {"_int_mm": ("aten::_int_mm",),
              "im2col": ("aten::cat", "aten::constant_pad_nd", "aten::zeros", "aten::fill_",
                         "aten::new_zeros")}
    split = {g: sum(dev_us(e) for e in ops if e.key in keys) for g, keys in groups.items()}
    split["other (quantize, dequant, casts, PReLU, SE, bicubic)"] = total - sum(split.values())
    top = sorted(ops, key=lambda e: -dev_us(e))[:8]
    return (f"device time {total / 1e3:.3f} ms: "
            + ", ".join(f"{g} {v / 1e3:.3f} ms ({v / total * 100:.1f}%)" for g, v in split.items())
            + "; top ops: " + ", ".join(f"{e.key[6:]} {dev_us(e) / 1e3:.3f}" for e in top))


def int8_conv_split(dev, n) -> str:
    """CUDA-event times of the stages of one trunk conv (n x 64x64x64 ->
    64, bf16 in and out, dynamic scales) as `_conv2d_int8` runs them:
    the scale and the quantize, the pad and the im2col, the `_int_mm`
    GEMM, the dequant (scale, bias, bf16 cast); and the whole call."""
    from facesr_torch.ops import conv as tconv
    from facesr_torch.ops.quant import Int8Weight, over_127

    gen = torch.Generator().manual_seed(40)
    x = torch.randn((n, 64, 64, 64), generator=gen).to(torch.bfloat16).to(dev)
    w = Int8Weight(torch.randint(-127, 128, (64, 64, 3, 3), generator=gen).to(torch.int8),
                   torch.rand(64, generator=gen) * 1e-3).to(dev)
    b = (torch.randn(64, generator=gen) * 0.1).to(dev)

    def scale():
        lo, hi = torch.aminmax(x.reshape(n, -1), dim=1)
        return over_127(torch.maximum(-lo, hi).float().reshape(-1, 1, 1, 1))

    a = scale()
    xq = tconv.quantize_act(x, a)
    wmat = w.gemm_weight(576, 64).t()

    def im2col():
        xp = torch.nn.functional.pad(xq, (0, 0, 1, 1, 1, 1)).view(torch.int64)
        return torch.cat([xp[:, dy:dy + 64, dx:dx + 64] for dy in range(3) for dx in range(3)],
                         dim=-1).view(torch.int8).reshape(-1, 576)

    cols = im2col()
    y = torch._int_mm(cols, wmat)
    dq = a * w.scale.reshape(1, 1, 1, -1)
    times = {"scale + quantize": cuda_ms(lambda: tconv.quantize_act(x, scale()), iters=10),
             "pad + im2col": cuda_ms(im2col, iters=10),
             "_int_mm": cuda_ms(lambda: torch._int_mm(cols, wmat), iters=10),
             "dequant": cuda_ms(lambda: torch.mul(y.reshape(n, 64, 64, 64), dq).add_(b)
                                .to(torch.bfloat16), iters=10)}
    whole = cuda_ms(lambda: tconv.conv2d(x, w, b, padding=1), iters=10)
    gop = 2 * n * 64 * 64 * 576 * 64 / 1e9
    return (f"one trunk conv at N={n}, CUDA events, means of 10: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + f" (sum {sum(times.values()):.4f}); the call {whole:.4f} ms; the GEMM's "
            f"{gop:.2f} GOP at {gop / times['_int_mm']:.1f} TOP/s")


def int8_phase(dev, card: str, tmp: Path, step_alone_ms: float) -> int:
    """Phase 12: int8 serving and QAT on the card, on phase 8's PNG set in
    ``tmp/data``. Returns the group-kernel launches of its main paths (the
    weight-only int8 Predictor and HTTP server)."""
    import copy

    from facesr_torch.app import api
    from facesr_torch.app.demo import prepare_inputs
    from facesr_torch.ckpt import fckpt
    from facesr_torch.cli import export_quantized
    from facesr_torch.cli import train as train_cli
    from facesr_torch.cli.step_numerics import small_step, step_errors
    from facesr_torch.data import png
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.ops.quant import dequantize_pytree
    from facesr_torch.ops.conv import INT8_CHUNK_BYTES, full_f32
    from facesr_torch.parallel.serving import (Predictor, SpatialPredictor, build_serving_fn,
                                               load_calibration_images)

    log(f"== 12. int8 serving and QAT: the s8 conv (im2col + torch._int_mm) bitwise "
        f"against the f64 conv, the 6x10x64 model in int8 and int8_full, export_quantized, "
        f"the HTTP API, a QAT step and the QAT YAML [{card}]")
    t_phase = time.perf_counter()
    for i, (name, shape, cout) in enumerate(INT8_CONV_SHAPES):
        log(int8_conv_exact(dev, name, shape, cout, seed=30 + i))

    cfg = production_config()
    per_fwd = cfg.num_groups
    model = production_model(dev, nonzero_last=True)
    calib = load_calibration_images(str(tmp / "data" / "val" / "LR"), size=64,
                                    limit=INT8_CALIB_IMAGES)
    x = np.random.default_rng(12).random((MAX_BATCH, 64, 64, 3), dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)
    t0 = time.perf_counter()
    modes = {"bf16": build_serving_fn(model, torch.bfloat16),
             "int8": build_serving_fn(model, "int8"),
             "int8_full dynamic": build_serving_fn(model, "int8_full"),
             "int8_full calibrated": build_serving_fn(model, "int8_full", calibration=calib,
                                                      max_batch=MAX_BATCH)}
    log(f"  serving functions built, int8_full calibrated on {len(calib)} of phase 8's "
        f"64x64 val LR PNGs, in {time.perf_counter() - t0:.2f} s")

    # the main path: weight-only int8 through Predictor, counted just around it
    pred8 = Predictor(model, dtype="int8", max_batch=MAX_BATCH, device=dev)
    rg.fused_residual_group.launches = 0
    out8 = pred8(x)
    torch.cuda.synchronize()
    launches = rg.fused_residual_group.launches
    deq = copy.deepcopy(model)
    with torch.no_grad():
        for pname, wq in dequantize_pytree(pred8._forward.sites).items():
            deq.get_parameter(f"{pname}.weight").copy_(wq.float())
    want8 = Predictor(deq, dtype=torch.bfloat16, max_batch=MAX_BATCH, device=dev)(x)
    log(f"  int8 Predictor at {MAX_BATCH}: {launches} group launches (want {per_fwd}); "
        f"== the bf16 Predictor of a model holding the dequantized weights: "
        f"{np.array_equal(out8, want8)}")
    if launches != per_fwd or not np.array_equal(out8, want8):
        raise AssertionError("int8 serving is not the kernel-trunk bf16 forward of the "
                             "dequantized weights")
    del deq, want8
    for label in ("int8_full dynamic", "int8_full calibrated"):
        rg.fused_residual_group.launches = 0
        y = modes[label](xd)
        torch.cuda.synchronize()
        n = rg.fused_residual_group.launches
        if n or y.shape != (MAX_BATCH, 256, 256, 3) or not torch.isfinite(y).all():
            raise AssertionError(f"{label}: {n} group launches, {tuple(y.shape)}")
    log(f"  int8_full dynamic and calibrated: 0 group launches, finite [{MAX_BATCH}, 256, 256, 3]")

    # the card against the CPU port at a small depth, on the same sites. The
    # served bf16 forward is held bitwise. In f32 compute the SE's float
    # sums (mean, gate) round differently on the card and the CPU, and a
    # last-bit difference in front of an int8 conv moves a level, which
    # then spreads; bf16 rounding absorbs those differences, so that
    # difference is printed, not held
    small_cfg = cfg.replace(num_groups=INT8_CHECK_DEPTH[0], blocks_per_group=INT8_CHECK_DEPTH[1])
    small_cpu = FaceEnhanceNet(small_cfg, seed=0, device="cpu").eval()
    with torch.no_grad():
        small_cpu.conv_last.weight.copy_(model.conv_last.weight.cpu())
    small = copy.deepcopy(small_cpu).to(dev)
    xc = x[:INT8_CHECK_IMAGES]
    with torch.inference_mode():
        f32 = small_cpu(torch.from_numpy(xc)).numpy()
    for label in ("int8_full dynamic", "int8_full calibrated"):
        kw = {"calibration": calib, "max_batch": MAX_BATCH} if "calibrated" in label else {}
        on_card = build_serving_fn(small, "int8_full", **kw)
        sites_cpu = {k: s.to("cpu") for k, s in on_card.sites.items()}
        xt = torch.from_numpy(xc)
        with torch.inference_mode():
            got = on_card(xt.to(dev)).float().cpu().numpy()
            want = small_cpu(xt, dtype=torch.bfloat16, quant=sites_cpu).float().numpy()
            with full_f32():
                d32 = np.abs(small(xt.to(dev), quant=on_card.sites).cpu().numpy()
                             - small_cpu(xt, quant=sites_cpu).numpy())
        p_card = 10 * np.log10(1 / np.mean((got.astype(np.float64) - f32) ** 2))
        same = np.array_equal(got, want)
        log(f"  {label} {small_cfg.num_groups}x{small_cfg.blocks_per_group}x64, "
            f"{INT8_CHECK_IMAGES} images, served bf16: card == CPU port {same} (max |card - "
            f"CPU| {np.abs(got - want).max():.4g}), PSNR against the CPU f32 forward "
            f"{p_card:.3f} dB; f32 compute (not held): max |card - CPU| {d32.max():.4g} at "
            f"{int((d32 > 0).sum())} of {d32.size} elements")
        if not (np.isfinite(got).all() and same):
            raise AssertionError(f"{label}: the card's int8_full is not the CPU port's")
    del small, small_cpu

    # times at batch 128, peak memory, the profiler's split
    for label, fn in modes.items():
        fn(xd)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: fn(xd), iters=INT8_TIMED, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        pred = Predictor(model, dtype="int8_full" if "int8_full" in label else
                         torch.bfloat16 if label == "bf16" else "int8", max_batch=MAX_BATCH,
                         device=dev)
        pred._forward = fn
        pred_ms = host_ms(lambda: pred(x), INT8_TIMED)
        log(f"  {label} batch {MAX_BATCH} 64x64: forward {ms:.3f} ms = "
            f"{MAX_BATCH / ms * 1e3:.1f} images/s (CUDA events, mean of {INT8_TIMED}); "
            f"Predictor numpy in and out {pred_ms:.3f} ms = {MAX_BATCH / pred_ms * 1e3:.1f} "
            f"images/s (median of {INT8_TIMED}); peak device memory {peak:.3f} GiB [{card}]")
    for label in ("int8_full dynamic", "int8_full calibrated"):
        log(f"  profiler, one {label} forward at {MAX_BATCH}: "
            f"{int8_profile_split(lambda: modes[label](xd))} [{card}]")
    log(f"  {int8_conv_split(dev, MAX_BATCH // 2)} [{card}]")
    del modes, pred8, xd

    # a large input: SpatialPredictor's rows chunked under INT8_CHUNK_BYTES
    sp = SpatialPredictor(model, dtype="int8_full", device=dev, calibration=calib[:4])
    big = np.random.default_rng(13).random(INT8_SPATIAL, dtype=np.float32)
    sp(big)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = sp(big)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sp_ms = host_ms(lambda: sp(big), 3)
    log(f"  SpatialPredictor int8_full (calibrated on 4 images, one at a time) {INT8_SPATIAL} -> "
        f"{got.shape}: median of 3 {sp_ms:.3f} ms, peak device memory {peak:.3f} GiB "
        f"(column chunks under {INT8_CHUNK_BYTES >> 20} MiB) [{card}]")
    if got.shape != (1, 4 * INT8_SPATIAL[1], 4 * INT8_SPATIAL[2], 3) or not np.isfinite(got).all():
        raise AssertionError(f"SpatialPredictor int8_full: {got.shape}")
    del sp, got

    # export_quantized on phase 8's PNGs, then the HTTP API on its cache
    ckdir = tmp / "int8_checkpoints"
    fckpt.save_model(str(ckdir / "production.fckpt"), model)
    prefix = tmp / "quant" / "int8"
    cache = Path(f"{prefix}.production.fckpt")
    t0 = time.perf_counter()
    if export_quantized.main(["--checkpoint", str(ckdir / "production.fckpt"), "--calib-dir",
                              str(tmp / "data" / "val" / "HR"), "--calib-hr", "--num-images",
                              str(INT8_CALIB_IMAGES), "--output", str(cache)]) != 0:
        raise AssertionError("export_quantized failed")
    log(f"  export_quantized on {INT8_CALIB_IMAGES} of phase 8's val HR PNGs (--calib-hr): "
        f"{cache.stat().st_size / 1e6:.2f} MB in {time.perf_counter() - t0:.2f} s")
    bodies = [png.encode(im) for im in smooth_u8(INT8_HTTP_CLIENTS, 64, 64, seed=17)]
    lrs = [prepare_inputs(png.decode_rgb(b))[0] for b in bodies]
    plan = [[c] + [(c + r) % len(bodies) for r in range(INT8_HTTP_REQUESTS)]
            for c in range(INT8_HTTP_CLIENTS)]
    n_req = sum(len(p) for p in plan)
    for label, kw in (("--dtype int8_full --quant-cache", dict(dtype="int8_full",
                                                               quant_cache=str(prefix))),
                      ("--dtype int8", dict(dtype="int8"))):
        ref = Predictor(model, dtype=kw["dtype"], max_batch=1, device=dev,
                        quant_cache=str(cache) if "quant_cache" in kw else None)
        want_u8 = [(ref(lr[None])[0] * 255).round().astype(np.uint8) for lr in lrs]
        srv = api.serve(str(ckdir), port=0, host="127.0.0.1", device=dev, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            rg.fused_residual_group.launches = 0
            wall, lat, _, results, errors = drive_http(srv.server_address[1], bodies, plan)
            torch.cuda.synchronize()
            n = rg.fused_residual_group.launches
        finally:
            srv.shutdown()
            srv.server_close()
            srv.service.close()
        exact = sum(s == 200 and np.array_equal(png.decode_rgb(d), want_u8[i])
                    for i, s, d in results)
        lat_ms = sorted(v * 1e3 for v in lat)
        log(f"  HTTP {label}: {n_req} requests from {INT8_HTTP_CLIENTS} keep-alive clients, "
            f"{exact} exactly Predictor's uint8 output; {n_req / wall:.1f} requests/s, p50 "
            f"{lat_ms[len(lat_ms) // 2]:.3f} ms; {n} group launches [{card}]")
        launches += n
        if errors or exact != n_req or n != (per_fwd * n_req if kw["dtype"] == "int8" else 0):
            failed = [(s, d[:200]) for _, s, d in results if s != 200]
            raise AssertionError(f"HTTP {label}: errors {errors[:3]}, {exact} of {n_req} "
                                 f"exact, {n} launches; failed {failed[:3]}")
    # control: a quant cache calibrated from other weights is refused at startup
    other = tmp / "other_checkpoints"
    fckpt.save_model(str(other / "production.fckpt"), production_model(dev, nonzero_last=False))
    try:
        api.SRService(str(other), dtype="int8_full", quant_cache=str(prefix), device=dev)
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError("a quant cache of other weights was served")
    log(f"  control: the cache on another checkpoint -> ValueError {msg[:70]!r}...")

    # QAT: one small step on the card against the CPU, with a TF32 control
    cpu = small_step("cpu", qat=True)
    errs = step_errors(small_step(dev, qat=True), cpu)
    tf32 = step_errors(small_step(dev, qat=True, tf32_forced=True), cpu)
    log(f"  QAT step (G=2 B=2 C=16 fake-quant, f32, smooth loss) card vs CPU: loss "
        f"{errs[0]:.3g}, worst gradient {errs[1]:.3g}, worst param {errs[2]:.3g}; TF32 forced: "
        f"{tf32[0]:.3g} / {tf32[1]:.3g} / {tf32[2]:.3g} -> "
        f"{'rejected' if max(tf32) > STEP_RTOL else 'within'} (limit {STEP_RTOL})")
    if max(errs) > STEP_RTOL:
        raise AssertionError(f"the card's QAT step disagrees with the CPU's: {errs}")
    if max(tf32) <= STEP_RTOL:
        raise AssertionError("the QAT step tolerance cannot see TF32 convs")
    # the production step of phase 7, fake-quantized
    state, step, _ = production_step_fn(dev, qat=True)
    hr = smooth_hr(TRAIN_BATCH, TRAIN_HR, seed=7, dev=dev)
    losses, times = [], []
    for i in range(QAT_WARMUP + QAT_TIMED):
        if i == QAT_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, metrics = step(state, hr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
    qat_ms = statistics.median(times[QAT_WARMUP:]) * 1e3
    log(f"  QAT step 6x10x64 f32 fake-quant, batch {TRAIN_BATCH} HR {TRAIN_HR}, L1 + VGG19 "
        f"conv3_4 (phase 7's step): median of {QAT_TIMED} {qat_ms:.3f} ms/step = "
        f"{TRAIN_BATCH / qat_ms * 1e3:.2f} images/s against phase 7's {step_alone_ms:.3f} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; losses "
        f"{['%.6f' % v for v in losses]} [{card}]")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("the QAT step's losses are not finite")
    del state, step, hr

    # the train CLI on the QAT YAML, data_root on phase 8's PNGs, one epoch
    text = QAT_YAML.read_text().replace("save_dir: /tmp/rehearsal/ckpt_s1_qat",
                                        f"save_dir: {tmp / 'qat_checkpoints'}")
    yaml = tmp / "stage1_qat_ft.yaml"
    yaml.write_text(text)
    rg.fused_residual_group.launches = 0
    t0 = time.perf_counter()
    trainer = train_cli.run(["--config", str(yaml), "--data-root", str(tmp / "data"),
                             "--epochs", "1", "--qat-scales", str(cache)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    hist = trainer.training_history
    ok = (trainer.config.qat and (tmp / "qat_checkpoints" / "final_model.pth").exists()
          and all(math.isfinite(v) for h in hist.values() for v in h))
    log(f"  train CLI {QAT_YAML.relative_to(REPO)} with --qat-scales, 1 epoch: "
        f"{cli_s:.1f} s, {trainer.last_train_metrics.get('step_ms', 0):.1f} ms/step, train loss "
        f"{hist['train_loss']}, val PSNR {hist['val_psnr']}; "
        f"{rg.fused_residual_group.launches} group launches [{card}]")
    if not ok or rg.fused_residual_group.launches:
        raise AssertionError("the QAT CLI run failed")
    log(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s [{card}]")
    del model, trainer
    torch.cuda.empty_cache()
    return launches


# phase 13: the model zoo at full width (RealESRGAN x4plus: 23 RRDBs, 64
# features, growth 32; transfer: 16 RRDBs + a 4-RCAB head at 64 channels)
ZOO_CHECK_IMAGES, ZOO_BATCH, ZOO_TIMED = 2, 128, 3
ZOO_HEAD_IMAGES = 8            # the whole-model check of the head on the kernel
ZOO_HTTP_REQUESTS = 8          # single-image requests to the transfer API
ZOO_ESRGAN_BATCHES = (48, 32, 24, 16)  # the stage-1 YAML's batch, then the fallbacks
ZOO_STEP_TIMED = 2
TRANSFER_YAML = REPO / "configs/transfer_config.yaml"


def zoo_macs(model, h, w) -> int:
    """Multiply-accumulates of one forward on an h x w LR image, counted
    from the conv weights: each conv's (cout * cin * k * k) times its
    output pixels (the upsample convs at 2x and 4x, the PixelShuffle stage
    convs at their input's size); SE and elementwise ops left out."""
    out_scale = {"conv_up1": 4, "conv_up2": 16, "conv_hr": 16, "conv_last": 16,
                 "face_head.upsample.stages.1.conv": 4, "face_head.conv_last": 16}
    total = 0
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            total += mod.weight.numel() * h * w * out_scale.get(name, 1)
    return total


def zoo_model(name, dev):
    """A full-width zoo model from seeded random weights, in eval mode on
    ``dev`` (the transfer model's conv_last is drawn non-zero already)."""
    from facesr_torch.models.esrgan import RRDBNet
    from facesr_torch.models.transfer import TransferSRModel

    cls = RRDBNet if name == "esrgan" else TransferSRModel
    return cls(seed=0, device=dev).eval()


def zoo_profile_split(fn) -> str:
    """The profiler's device time of one call of ``fn``, split by aten op:
    cuDNN convs, the dense concatenation copies (``aten::cat``), the group
    kernel and the rest (bias adds, LeakyReLU/PReLU, casts, residuals)."""
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if (e.key.startswith("aten::") or "rcab_group" in e.key) and dev_us(e) > 0]
    total = sum(dev_us(e) for e in ops)
    if total <= 0:
        return "profiler: no device time recorded"
    split = {"cuDNN convs": sum(dev_us(e) for e in ops if "conv" in e.key),
             "concatenation copies": sum(dev_us(e) for e in ops if e.key == "aten::cat"),
             "group kernel": sum(dev_us(e) for e in ops if "rcab_group" in e.key)}
    split["elementwise and the rest"] = total - sum(split.values())
    top = sorted(ops, key=lambda e: -dev_us(e))[:6]
    return (f"device time {total / 1e3:.3f} ms: "
            + ", ".join(f"{g} {v / 1e3:.3f} ms ({v / total * 100:.1f}%)" for g, v in split.items())
            + "; top ops: " + ", ".join(f"{e.key} {dev_us(e) / 1e3:.3f}" for e in top))


def no_gate_head(head, feat):
    """The transfer head with a planted fault: its SE gates dropped."""
    from facesr_torch.models.transfer import HEAD_RES_SCALE
    from facesr_torch.ops import conv as tconv

    residual = feat
    for blk in head.rcab_blocks:
        out = tconv.conv2d(feat, blk.conv1.weight, blk.conv1.bias, padding=1)
        out = tconv.prelu(out, blk.prelu.weight)
        out = tconv.conv2d(out, blk.conv2.weight, blk.conv2.bias, padding=1)
        feat = feat + out * HEAD_RES_SCALE
    return tconv.conv2d(feat, head.conv_after.weight, head.conv_after.bias,
                        padding=1) + residual


def zoo_phase(dev, card: str, tmp: Path) -> dict:
    """Phase 13: the model zoo on the card. Returns the group-kernel
    launches of its main paths (the transfer Predictor and API) and the
    B=4 group call's times."""
    import os

    from facesr_torch.app import api as port_api
    from facesr_torch.app.demo import prepare_inputs
    from facesr_torch.ckpt import fckpt
    from facesr_torch.ckpt.weights import save_reference_pth
    from facesr_torch.cli import compare_two_models, test_model
    from facesr_torch.cli import train as train_cli
    from facesr_torch.cli.step_numerics import small_zoo_step, step_errors
    from facesr_torch.config import load_config
    from facesr_torch.data import png
    from facesr_torch.losses.combined import create_loss_function
    from facesr_torch.models import transfer as ttr
    from facesr_torch.models.load import load_any_model
    from facesr_torch.ops import conv as tconv
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.parallel.serving import Predictor, build_serving_fn
    from facesr_torch.training import steps
    from facesr_torch.training.optim import AdamW

    log(f"== 13. model zoo: RRDBNet x4plus and TransferSRModel 16+4 at 64 channels, seeded "
        f"random weights [{card}]")
    t_phase = time.perf_counter()
    models = {name: zoo_model(name, dev) for name in ("esrgan", "transfer")}
    launches = 0
    for name, m in models.items():
        log(f"  {name}: {type(m).__name__} {m.config}, {sum(p.numel() for p in m.parameters()):,} "
            f"parameters, {zoo_macs(m, 64, 64) / 1e9:.3f} GMAC a 64x64 image")

    # 13.1 card vs CPU in f32, TF32 off, and the TF32 control
    x2 = torch.rand((ZOO_CHECK_IMAGES, 64, 64, 3), generator=torch.Generator().manual_seed(130))
    for name, m in models.items():
        cpu = zoo_model(name, "cpu")
        with torch.inference_mode():
            want = cpu(x2).numpy()
            got = m(x2.to(dev)).cpu().numpy()
            real = tconv.full_f32
            tconv.full_f32 = tf32_forced
            try:
                forced = m(x2.to(dev)).cpu().numpy()
            finally:
                tconv.full_f32 = real
        err, tf32_err = rel_l2(got, want), rel_l2(forced, want)
        log(f"  13.1 {name} f32 card vs CPU on {ZOO_CHECK_IMAGES} 64x64 images: relative L2 "
            f"{err:.3g} (limit {STEP_RTOL}); TF32 forced {tf32_err:.3g} -> "
            f"{'rejected' if tf32_err > STEP_RTOL else 'within'}")
        if not (np.isfinite(got).all() and err <= STEP_RTOL):
            raise AssertionError(f"{name}: the card's f32 forward is off the CPU's")
        if tf32_err <= STEP_RTOL:
            raise AssertionError(f"{name}: the f32 limit lets TF32 convs pass")
        del cpu

    # 13.2 bf16 forward at batch 128
    xb = torch.rand((ZOO_BATCH, 64, 64, 3), generator=torch.Generator().manual_seed(131)).to(dev)
    fwd_ms = {}
    for name, m in models.items():
        fwd = build_serving_fn(m, torch.bfloat16)
        for _ in range(2):
            fwd(xb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(ZOO_TIMED):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fwd(xb)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = fwd_ms[name] = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tflops = 2.0 * zoo_macs(m, 64, 64) * ZOO_BATCH / (ms * 1e-3) / 1e12
        log(f"  13.2 {name} bf16 forward batch {ZOO_BATCH}: median of {ZOO_TIMED} {ms:.3f} ms "
            f"(CUDA events) = {ZOO_BATCH / ms * 1e3:.1f} images/s, {tflops:.1f} TFLOP/s "
            f"({tflops / (BF16_PEAK_FLOPS / 1e12) * 100:.1f}% of the bf16 peak), peak memory "
            f"{peak:.3f} GiB [{card}]")
        log(f"  13.2 {name} profiler, one forward: {zoo_profile_split(lambda: fwd(xb))} [{card}]")

    # 13.3 the transfer head on the kernel against the plain head, whole model
    tm = models["transfer"]
    xh = torch.rand((ZOO_HEAD_IMAGES, 64, 64, 3),
                    generator=torch.Generator().manual_seed(132)).to(dev)

    with torch.inference_mode():
        before = rg.fused_residual_group.launches
        out_k = tm(xh, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        per_fwd = rg.fused_residual_group.launches - before
        out_p = tm(xh, dtype=torch.bfloat16, head_fn=ttr.plain_head)
        out_0 = tm(xh, dtype=torch.bfloat16, head_fn=lambda head, f: f)
        out_f = tm(xh, dtype=torch.bfloat16, head_fn=no_gate_head)
        ref = (out_p - out_0).abs()
        lim_max, lim_mean = MODEL_RTOL * ref.max().item(), MODEL_RTOL * ref.mean().item()
        results = {}
        for what, out in (("kernel head", out_k), ("planted fault: SE gate dropped", out_f)):
            d = (out - out_p).abs()
            results[what] = d.max().item() <= lim_max and d.mean().item() <= lim_mean
            log(f"  13.3 {what} vs plain head, {ZOO_HEAD_IMAGES} images bf16: max_abs="
                f"{d.max().item():.6g} (limit {lim_max:.6g}) mean_abs={d.mean().item():.6g} "
                f"(limit {lim_mean:.6g}) -> {'within' if results[what] else 'rejected'}")
    log(f"  13.3 group-kernel launches a bf16 eval forward: {per_fwd}")
    if not results["kernel head"] or per_fwd != 1 or not torch.isfinite(out_k).all():
        raise AssertionError("the transfer head on the kernel disagrees or did not launch once")
    if results["planted fault: SE gate dropped"]:
        raise AssertionError("the head limits let a dropped SE gate pass")
    del out_k, out_p, out_0, out_f

    # the kernel at the head's shape class (B = 4) against its plain version
    n, h, w, c, B = GROUP_TIMING[:4] + (4,)
    gw4 = {k: v.to(dev) for k, v in tm.kernel_head_weights().items()}
    x4 = check_input((n, h, w, c), 133, dev, ramp=False)
    b4 = {"ms": cuda_ms(lambda: rg.fused_residual_group(x4, gw4, 0.2), iters=10),
          "plain_ms": cuda_ms(lambda: rg.rcab_group_reference(x4, gw4, 0.2), iters=3, warmup=1),
          "library_ms": cuda_ms(lambda: library_group(x4, gw4, 0.2), iters=10)}
    b4["bound_ms"], b4["bound_by"] = group_bound(n, h, w, c, B, gw4["fc1"].shape[-1])
    log(f"  13.3 one group call at the head's shape N={n} {h}x{w} C={c} B={B}: kernel "
        f"{b4['ms']:.4f} ms, plain {b4['plain_ms']:.4f}, library (cuDNN bf16) "
        f"{b4['library_ms']:.4f}, bound {b4['bound_ms']:.4f} ({b4['bound_by']}) [{card}]")

    # 13.4 Predictor at 128 in bf16: the main path, the counts zeroed just before
    request = np.random.default_rng(134).random((ZOO_BATCH, 64, 64, 3), dtype=np.float32)
    xr = torch.from_numpy(request).to(dev)
    for name, m in models.items():
        pred = Predictor(m, dtype=torch.bfloat16, max_batch=ZOO_BATCH, device=dev)
        pred(request)
        rg.fused_residual_group.launches = 0
        t0 = time.perf_counter()
        out = pred(request)
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t0
        got_launches = rg.fused_residual_group.launches
        launches += got_launches
        with torch.inference_mode():
            direct = m(xr, dtype=torch.bfloat16).clamp(0.0, 1.0).cpu().numpy()
        check_equal(f"13.4 {name} Predictor(bf16, {ZOO_BATCH}) vs clamp(forward) at batch "
                    f"{ZOO_BATCH}", out, direct)
        log(f"  13.4 {name} Predictor numpy in/out: {pred_s * 1e3:.3f} ms = "
            f"{ZOO_BATCH / pred_s:.1f} images/s; group-kernel launches {got_launches} [{card}]")
        if got_launches != (1 if name == "transfer" else 0):
            raise AssertionError(f"{name}: {got_launches} group-kernel launches in one chunk")
    del xr, xb

    # 13.5 checkpoints written by the port, read back
    ck = tmp / "zoo_ckpt"
    ck.mkdir()
    x8 = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(135)).to(dev)
    for name, m in models.items():
        save_reference_pth(str(ck / f"{name}.pth"), m)
        fckpt.save_model(str(ck / f"{name}.fckpt"), m)
        with torch.inference_mode():
            want = m(x8, dtype=torch.bfloat16).cpu().numpy()
            for ext in ("pth", "fckpt"):
                back = load_any_model(ck / f"{name}.{ext}", device=dev)
                if type(back) is not type(m) or back.config != m.config:
                    raise AssertionError(f"{name}.{ext} loads as {type(back).__name__}")
                check_equal(f"13.5 {name}.{ext} read back, bf16 forward",
                            back(x8, dtype=torch.bfloat16).cpu().numpy(), want)
                del back

    # 13.6 the train CLI: transfer_config.yaml, then --model esrgan
    data = tmp / "data"
    run_dir = tmp / "zoo_cli"
    run_dir.mkdir()
    created = {}
    real_create = train_cli.create_model

    def create_and_record(*a, **k):
        model = real_create(*a, **k)
        created["start"] = {n: v.detach().clone() for n, v in model.state_dict().items()}
        return model

    tm.cpu()
    del models
    torch.cuda.empty_cache()
    # the transfer step alone: the YAML's loss, batch and AMP on one batch
    tcfg = load_config(str(TRANSFER_YAML))
    lc, bs = tcfg["loss"], tcfg["data"]["batch_size"]
    step_model = zoo_model("transfer", dev).train()
    loss = create_loss_function(l1_weight=lc["l1_weight"],
                                perceptual_weight=lc["perceptual_weight"],
                                ssim_weight=lc["ssim_weight"],
                                perceptual_layers=lc["perceptual"]["layers"], device=dev)
    opt = AdamW(weight_decay=0.0, gradient_clip=tcfg["training"]["gradient_clip"])
    st = steps.TrainState(model=step_model, loss_params=loss.params,
                          opt_state=opt.init(steps.trainable_parameters(step_model), 2e-4))
    step = steps.make_train_step(
        lambda lp, p, t: loss.apply(lp, p, t, compute_dtype=torch.bfloat16), opt,
        compute_dtype=torch.bfloat16)
    hr = smooth_hr(bs, CLI_HR, 136, dev)
    for _ in range(2):
        step(st, hr)
    torch.cuda.synchronize()
    step_ms = statistics.median(host_ms(lambda: step(st, hr), reps=1)
                                for _ in range(ZOO_STEP_TIMED))
    log(f"  13.6 transfer step alone (stage 1, bf16, batch {bs}, HR {CLI_HR}, the YAML's loss): "
        f"median of {ZOO_STEP_TIMED} {step_ms:.3f} ms = {bs / step_ms * 1e3:.2f} images/s [{card}]")
    del st, step, step_model, hr
    torch.cuda.empty_cache()

    cwd = os.getcwd()
    os.chdir(run_dir)
    train_cli.create_model = create_and_record
    try:
        torch.cuda.reset_peak_memory_stats()
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            trainer = train_cli.run(["--config", str(TRANSFER_YAML), "--data-root", str(data),
                                     "--epochs", "1"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        now = trainer.model.state_dict()
        start = created["start"]
        bb_same = all(torch.equal(now[k].cpu(), start[k].cpu()) for k in now
                      if k.startswith("backbone."))
        head_moved = all(not torch.equal(now[k].cpu(), start[k].cpu()) for k in now
                         if k.startswith("face_head.") and k.endswith("weight"))
        ms = statistics.median(trainer.last_step_times[1:]) * 1e3
        m = trainer.last_train_metrics
        log(f"  13.6 transfer_config.yaml through the CLI (data_root -> phase 8's PNGs, "
            f"--epochs 1): {len(trainer.last_step_times)} steps of {bs}, {ms:.3f} ms/step "
            f"(median host interval after the first) against {step_ms:.3f} for the step alone; "
            f"loader wait {m['loader_wait_s']:.3f} s; peak memory {peak:.3f} GiB; losses {m}; "
            f"backbone bitwise unchanged {bb_same}; every head weight changed {head_moved} "
            f"[{card}]")
        if not (bb_same and head_moved and math.isfinite(m["loss"])
                and trainer.model_type == "transfer"):
            raise AssertionError("the transfer YAML's stage 1 moved the backbone or not the head")
        (ck / "transfer_trained.pth").write_bytes(
            (run_dir / "checkpoints" / "best_model.pth").read_bytes())
        del trainer
        torch.cuda.empty_cache()
        train_cli.create_model = real_create
        esrgan_run = None
        for batch in ZOO_ESRGAN_BATCHES:
            torch.cuda.reset_peak_memory_stats()
            try:
                with contextlib.redirect_stdout(_Tee(sys.stdout)):
                    trainer = train_cli.run(["--config", str(STAGE1_YAML), "--data-root",
                                             str(data), "--epochs", "1", "--model", "esrgan",
                                             "--batch-size", str(batch)])
                torch.cuda.synchronize()
            except torch.cuda.OutOfMemoryError as e:
                log(f"  13.6 --model esrgan at batch {batch}: out of memory ({str(e)[:120]})")
                trainer = None
                torch.cuda.empty_cache()
                continue
            esrgan_run = (batch, trainer, torch.cuda.max_memory_allocated() / 2 ** 30)
            break
    finally:
        train_cli.create_model = real_create
        os.chdir(cwd)
    if esrgan_run is None:
        raise AssertionError("--model esrgan did not fit at any batch")
    batch, trainer, peak = esrgan_run
    m = trainer.last_train_metrics
    ms = statistics.median(trainer.last_step_times[1:]) * 1e3
    log(f"  13.6 --model esrgan with {STAGE1_YAML.name} (f32, random x4plus weights) at batch "
        f"{batch}{'' if batch == ZOO_ESRGAN_BATCHES[0] else ' (the YAML batch did not fit)'}: "
        f"{len(trainer.last_step_times)} steps, {ms:.3f} ms/step = {batch / ms * 1e3:.2f} "
        f"images/s; peak memory {peak:.3f} GiB; losses {m} [{card}]")
    if not all(math.isfinite(v) for v in m.values()) or trainer.model_type != "esrgan":
        raise AssertionError("the ESRGAN CLI run has a non-finite loss")
    del trainer, esrgan_run
    torch.cuda.empty_cache()

    # 13.7 the small zoo steps, card vs CPU in f32
    worst = 0.0
    for kind, stage in (("transfer", 1), ("transfer", 2), ("transfer", 3), ("esrgan", 1)):
        got, start = small_zoo_step(dev, kind, stage)
        want, _ = small_zoo_step("cpu", kind, stage)
        errs = step_errors(got, want)
        labels = (ttr.param_labels(ttr.TransferSRModel(ttr.TransferModelConfig(
            backbone_blocks=5, head_blocks=2, head_channels=16), device="cpu"),
            ttr.TrainingStage(stage)) if kind == "transfer" else {})
        frozen = [k for k, v in labels.items() if v == "frozen"]
        still = all(torch.equal(got[2][k], start[k]) for k in frozen)
        log(f"  13.7 small {kind} step{f' stage {stage}' if kind == 'transfer' else ''} card vs "
            f"CPU (f32): loss {errs[0]:.3g}, worst gradient {errs[1]:.3g}, worst updated param "
            f"{errs[2]:.3g} (limit {STEP_RTOL}); {len(got[1])} trained tensors, {len(frozen)} "
            f"frozen bitwise unchanged {still}")
        worst = max(worst, *errs)
        if max(errs) > STEP_RTOL or not still:
            raise AssertionError(f"the small {kind} step on the card is off the CPU's")
    forced, _ = small_zoo_step(dev, "transfer", 3, tf32_forced=True)
    want, _ = small_zoo_step("cpu", "transfer", 3)
    errs = step_errors(forced, want)
    log(f"  13.7 control, the stage-3 step with TF32 forced: {errs} -> "
        f"{'rejected' if max(errs) > STEP_RTOL else 'within'}")
    if max(errs) <= STEP_RTOL:
        raise AssertionError("the step limit lets TF32 convs pass")

    # 13.8 the entry points on zoo checkpoints
    val_hr = data / "val" / "HR"
    rows, _ = eval_cli(test_model, ["--checkpoint", str(ck / "transfer_trained.pth"), "--input",
                                    str(val_hr), "--output", str(tmp / "zoo_test"), "--no-save"])
    psnr = float(np.mean([r["model"]["psnr"] for r in rows]))
    log(f"  13.8 test_model on the trained transfer checkpoint: {len(rows)} images, model PSNR "
        f"{psnr:.3f} dB, bicubic {np.mean([r['bicubic']['psnr'] for r in rows]):.3f} dB")
    if len(rows) != CLI_VAL or not math.isfinite(psnr):
        raise AssertionError("test_model on the transfer checkpoint")
    cmp_dir = tmp / "zoo_compare"
    cmp_dir.mkdir()
    for src, dst in ((tmp / "stage1_checkpoints" / "best_model.pth", "face_enhance_net.pth"),
                     (ck / "transfer_trained.pth", "transfer.pth"),
                     (ck / "esrgan.pth", "rrdbnet.pth")):
        (cmp_dir / dst).write_bytes(src.read_bytes())
    t0 = time.perf_counter()
    res, _ = eval_cli(compare_two_models, ["--checkpoint-dir", str(cmp_dir), "--test-dir",
                                           str(val_hr), "--output", str(tmp / "zoo_cmp_out"),
                                           "--save-every", "0"])
    log(f"  13.8 compare_two_models, {res['images']} images, {time.perf_counter() - t0:.2f} s: "
        + "; ".join(f"{k} {v['psnr']:.3f} dB / {v['ssim']:.4f}" for k, v in res["summary"].items()))
    if res["methods"][3:] != ["Face Enhance Net", "Rrdbnet", "Transfer"]:
        raise AssertionError(f"compare rows {res['methods']}")

    api_dir = tmp / "zoo_api"
    api_dir.mkdir()
    (api_dir / "transfer.fckpt").write_bytes((ck / "transfer.fckpt").read_bytes())
    srv = port_api.serve(str(api_dir), port=0, host="127.0.0.1", dtype="bf16")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        imgs = smooth_u8(ZOO_HTTP_REQUESTS, 64, 64, 137)
        bodies = [png.encode(im) for im in imgs]
        pred = srv.service.predictors["Transfer"]
        rg.fused_residual_group.launches = 0
        half = ZOO_HTTP_REQUESTS // 2  # two keep-alive clients
        wall, lat, warm, results, errors = drive_http(
            srv.server_address[1], bodies, [list(range(half)),
                                            list(range(half, ZOO_HTTP_REQUESTS))])
        http_launches = rg.fused_residual_group.launches
        launches += http_launches
        bad = [(i, s, d[:200]) for i, s, d in results if s != 200]
        same = all(np.array_equal(png.decode_rgb(d, "response"),
                                  (pred(prepare_inputs(imgs[i])[0][None])[0] * 255).round()
                                  .astype(np.uint8)) for i, s, d in results if s == 200)
        log(f"  13.8 API (--dtype bf16) on the transfer .fckpt: {len(results)} requests, errors "
            f"{errors or bad}; every response bitwise Predictor's batch-1 output {same}; "
            f"launches {http_launches}; p50 {statistics.median(warm + lat) * 1e3:.1f} ms [{card}]")
        if errors or bad or not same or len(results) != ZOO_HTTP_REQUESTS \
                or http_launches != ZOO_HTTP_REQUESTS:
            raise AssertionError("the API serving the transfer model")
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()
    log(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"launches": launches, "b4": b4, "step_ms": step_ms}


# phase 14: the zoo's int8 and the .pt2 files at full width (RealESRGAN x4plus;
# transfer 16+4 at 64 channels), seeded random weights, batch 128 of 64x64
ZOO8_TIMED = 1                  # forwards (CUDA events, mean) and Predictor calls (median)
ZOO8_CHECK_IMAGES = 4           # int8_full card against the CPU port, at the small depths:
ZOO8_SMALL = {"esrgan": dict(num_feat=64, num_blocks=2, num_grow_ch=32),
              "transfer": dict(backbone_blocks=2, head_blocks=2, head_channels=64)}
ZOO8_EXPORT_BATCHES = (1, MAX_BATCH)
# the zoo's .pt2 files are exported from its models at a cut depth (the
# export's trace and the load take ~1 s a block): RRDBNet with 4 RRDBs,
# the transfer model with a backbone of 4 (its head whole); FaceEnhanceNet's
# at full depth
ZOO8_EXPORT_DEPTH = {"esrgan": dict(num_blocks=4),
                     "transfer": dict(backbone_blocks=4, freeze_blocks=4)}
EXPORT_BF16_TOL = 1e-2          # cli.export_serving --verify's bf16 tolerance
ZOO8_HTTP_REQUESTS = 8          # single-image requests to the transfer int8_full .pt2


def zoo_int8_phase(dev, card: str, tmp: Path, step_alone_ms: float) -> int:
    """Phase 14: the zoo's int8 and ``.pt2`` on the card, on phase 8's PNG
    set in ``tmp/data``. Returns the group-kernel launches of its main paths
    (the transfer model's bf16 and int8 serving and its bf16 artifact,
    FaceEnhanceNet's int8 artifact)."""
    import copy
    import os

    from facesr_torch.app import api as port_api
    from facesr_torch.app.demo import prepare_inputs
    from facesr_torch.ckpt import export as ex
    from facesr_torch.cli import train as train_cli
    from facesr_torch.cli.step_numerics import (LEVEL_TIE, SIGN_TIE, fake_quant_levels,
                                                small_zoo_step, step_errors)
    from facesr_torch.data import png
    from facesr_torch.models import esrgan as tesr
    from facesr_torch.models import transfer as ttr
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.ops.conv import full_f32
    from facesr_torch.ops.quant import dequantize_pytree, quantize_conv_kernels
    from facesr_torch.parallel.serving import (Predictor, build_serving_fn,
                                               load_calibration_images)

    log(f"== 14. the zoo's int8 and .pt2: RRDBNet x4plus and TransferSRModel 16+4 in bf16, "
        f"int8 and int8_full, card vs CPU, the .pt2 files of every family, the API on an int8 "
        f"artifact, zoo QAT [{card}]")
    t_phase = time.perf_counter()
    start_launches = rg.fused_residual_group.launches
    calib = load_calibration_images(str(tmp / "data" / "val" / "LR"), size=64,
                                    limit=INT8_CALIB_IMAGES)
    x = np.random.default_rng(140).random((MAX_BATCH, 64, 64, 3), dtype=np.float32)
    xd = torch.from_numpy(x).to(dev)
    models = {name: zoo_model(name, dev) for name in ("esrgan", "transfer")}
    caches = {name: tmp / "zoo_quant" / f"int8.{name}.fckpt" for name in models}

    parts = {}
    mark = lambda name, t0: parts.__setitem__(name, time.perf_counter() - t0)  # noqa: E731
    t_part = time.perf_counter()
    # 14.1 times of the four serving modes at batch 128
    for name, model in models.items():
        t0 = time.perf_counter()
        modes = {"bf16": build_serving_fn(model, torch.bfloat16),
                 "int8": build_serving_fn(model, "int8"),
                 "int8_full dynamic": build_serving_fn(model, "int8_full"),
                 "int8_full calibrated": build_serving_fn(
                     model, "int8_full", calibration=calib, quant_cache=str(caches[name]),
                     max_batch=MAX_BATCH)}
        log(f"  14.1 {name}: serving functions built ({len(modes['int8'].sites)} int8 sites; "
            f"int8_full calibrated on {len(calib)} of phase 8's 64x64 val LR PNGs, its quant "
            f"cache {caches[name].stat().st_size / 1e6:.2f} MB) in "
            f"{time.perf_counter() - t0:.2f} s")
        for label, fn in modes.items():
            before = rg.fused_residual_group.launches
            y = fn(xd)
            torch.cuda.synchronize()
            per_fwd = rg.fused_residual_group.launches - before
            want = 1 if name == "transfer" and label in ("bf16", "int8") else 0
            if per_fwd != want or y.shape != (MAX_BATCH, 256, 256, 3) \
                    or not torch.isfinite(y).all():
                raise AssertionError(f"{name} {label}: {per_fwd} group launches (want {want}), "
                                     f"{tuple(y.shape)}")
            del y
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: fn(xd), iters=ZOO8_TIMED, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            pred = Predictor(model, dtype=torch.bfloat16, max_batch=MAX_BATCH, device=dev)
            pred._forward = fn
            pred_ms = host_ms(lambda: pred(x), ZOO8_TIMED)
            log(f"  14.1 {name} {label} batch {MAX_BATCH} 64x64: forward {ms:.3f} ms = "
                f"{MAX_BATCH / ms * 1e3:.1f} images/s (CUDA events, mean of {ZOO8_TIMED}); "
                f"Predictor numpy in and out {pred_ms:.3f} ms = "
                f"{MAX_BATCH / pred_ms * 1e3:.1f} images/s (median of {ZOO8_TIMED}); peak device "
                f"memory {peak:.3f} GiB; {per_fwd} group launch(es) a forward [{card}]")
            if label != "bf16":
                log(f"  14.1 {name} {label} profiler, one forward: "
                    f"{int8_profile_split(lambda: fn(xd))} [{card}]")
            del pred
        if name == "transfer":
            # 14.2 the weight-only int8 head on the kernel, on the served copy's weights
            fwd8 = modes["int8"]
            xh = xd[:ZOO_HEAD_IMAGES]
            deq = copy.deepcopy(model)
            deq._kernel_weights = None
            with torch.no_grad():
                for pname, wq in dequantize_pytree(fwd8.sites).items():
                    deq.get_parameter(f"{pname}.weight").copy_(wq.float())
            with torch.inference_mode():
                before = rg.fused_residual_group.launches
                got = fwd8(xh)
                torch.cuda.synchronize()
                per_fwd = rg.fused_residual_group.launches - before
                out_k = deq(xh, dtype=torch.bfloat16)
                out_p = deq(xh, dtype=torch.bfloat16, head_fn=ttr.plain_head)
                out_0 = deq(xh, dtype=torch.bfloat16, head_fn=lambda head, f: f)
                out_f = deq(xh, dtype=torch.bfloat16, head_fn=no_gate_head)
            check_equal("14.2 weight-only int8 serving vs the bf16 forward of a copy holding "
                        "the dequantized weights", got.cpu().numpy(),
                        out_k.clamp(0.0, 1.0).cpu().numpy())
            ref = (out_p - out_0).abs()
            lim_max, lim_mean = MODEL_RTOL * ref.max().item(), MODEL_RTOL * ref.mean().item()
            verdict = {}
            for what, out in (("kernel head", out_k), ("planted fault: SE gate dropped", out_f)):
                d = (out - out_p).abs()
                verdict[what] = d.max().item() <= lim_max and d.mean().item() <= lim_mean
                log(f"  14.2 int8 (dequantized weights) {what} vs plain head, {ZOO_HEAD_IMAGES} "
                    f"images bf16: max_abs={d.max().item():.6g} (limit {lim_max:.6g}) mean_abs="
                    f"{d.mean().item():.6g} (limit {lim_mean:.6g}) -> "
                    f"{'within' if verdict[what] else 'rejected'}")
            log(f"  14.2 group-kernel launches a weight-only int8 transfer forward: {per_fwd}")
            if per_fwd != 1 or not verdict["kernel head"]:
                raise AssertionError("the int8 transfer head on the kernel disagrees with the "
                                     "plain head or did not launch once")
            if verdict["planted fault: SE gate dropped"]:
                raise AssertionError("the int8 head limits let a dropped SE gate pass")
            del deq, out_k, out_p, out_0, out_f, got
        del modes
        torch.cuda.empty_cache()

    mark("14.1-14.2", t_part)
    t_part = time.perf_counter()
    # 14.3 int8_full on the card against the CPU port at small depths
    xc = x[:ZOO8_CHECK_IMAGES]
    xt = torch.from_numpy(xc)
    for name, cfg in ZOO8_SMALL.items():
        cls, ccls = ((tesr.RRDBNet, tesr.RRDBNetConfig) if name == "esrgan"
                     else (ttr.TransferSRModel, ttr.TransferModelConfig))
        small_cpu = cls(ccls(**cfg), seed=0, device="cpu").eval()
        small = copy.deepcopy(small_cpu).to(dev)
        with torch.inference_mode():
            f32 = small_cpu(xt).numpy()
        for label in ("dynamic", "calibrated"):
            kw = {"calibration": calib, "max_batch": MAX_BATCH} if label == "calibrated" else {}
            on_card = build_serving_fn(small, "int8_full", **kw)
            sites_cpu = {k: s.to("cpu") for k, s in on_card.sites.items()}
            with torch.inference_mode():
                got = on_card(xt.to(dev)).float().cpu().numpy()
                want = small_cpu(xt, dtype=torch.bfloat16, quant=sites_cpu).clamp(
                    0.0, 1.0).float().numpy()
                want_f32 = small_cpu(xt, quant=sites_cpu).clamp(0.0, 1.0).numpy()
                with full_f32():
                    d32 = np.abs(small(xt.to(dev), quant=on_card.sites).clamp(0.0, 1.0)
                                 .cpu().numpy() - want_f32)
            p_card = 10 * np.log10(1 / np.mean((got.astype(np.float64) - f32.clip(0, 1)) ** 2))
            p_cpu = 10 * np.log10(1 / np.mean((want.astype(np.float64) - f32.clip(0, 1)) ** 2))
            same = np.array_equal(got, want)
            log(f"  14.3 {name} {cfg} int8_full {label}, {ZOO8_CHECK_IMAGES} images, served "
                f"bf16: card == CPU port {same} (max |card - CPU| {np.abs(got - want).max():.4g} "
                f"at {int((got != want).sum())} of {got.size}); PSNR against the CPU f32 forward "
                f"card {p_card:.3f} dB, CPU port {p_cpu:.3f} dB; f32 compute (not held): max "
                f"|card - CPU| {d32.max():.4g} at {int((d32 > 0).sum())} of {d32.size}")
            if not np.isfinite(got).all():
                raise AssertionError(f"{name} int8_full {label} on the card is not finite")
            if not same:
                raise AssertionError(f"{name} int8_full {label}: the card is not the CPU port")
        del small, small_cpu

    mark("14.3", t_part)
    t_part = time.perf_counter()
    # 14.4 the .pt2 files of every family, loaded back against the live forward
    fen = production_model(dev, nonzero_last=True)
    cut = {"esrgan": tesr.RRDBNet(tesr.RRDBNetConfig(**ZOO8_EXPORT_DEPTH["esrgan"]), seed=0,
                                  device=dev).eval(),
           "transfer": ttr.TransferSRModel(ttr.TransferModelConfig(
               **ZOO8_EXPORT_DEPTH["transfer"]), seed=0, device=dev).eval()}
    art_dir = tmp / "zoo_pt2"
    art_dir.mkdir()
    # (artifact, model, dtype, build kw, rcab_group nodes, int8_conv nodes)
    n_sites = {k: len(quantize_conv_kernels(m)) for k, m in (("transfer", cut["transfer"]),
                                                              ("fen", fen))}
    plan = [("rrdbnet_bf16", cut["esrgan"], torch.bfloat16, {}, 0, 0),
            ("transfer_bf16", cut["transfer"], torch.bfloat16, {}, 1, 0),
            ("transfer_int8_full", cut["transfer"], "int8_full",
             {"calibration": calib, "max_batch": MAX_BATCH,
              "quant_cache": str(tmp / "zoo_quant" / "int8.transfer_cut.fckpt")}, 0,
             n_sites["transfer"]),
            ("fen_int8", fen, "int8", {}, production_config().num_groups, 0),
            ("fen_int8_full", fen, "int8_full", {}, 0, n_sites["fen"])]
    artifacts = {}
    for stem, model, dtype, kw, nodes, int8_nodes in plan:
        t0 = time.perf_counter()
        module = ex.build_serving_fn(model, dtype, **kw)
        blob = ex.export_built(module)
        export_s = time.perf_counter() - t0
        path = art_dir / f"{stem}.pt2"
        path.write_bytes(blob)
        t0 = time.perf_counter()
        fn = ex.load_exported(path, device=dev)
        load_s = time.perf_counter() - t0
        got_nodes = (ex.custom_op_nodes(fn.exported), ex.custom_op_nodes(fn.exported, "int8_conv"))
        live = build_serving_fn(model, dtype, **kw)
        errs = []
        for n in ZOO8_EXPORT_BATCHES:
            before = rg.fused_residual_group.launches
            got = fn(x[:n])
            torch.cuda.synchronize()
            runs = rg.fused_residual_group.launches - before
            with torch.inference_mode():
                want = live(xd[:n]).float().cpu().numpy()
            err = float(np.abs(got - want).max())
            errs.append((n, err, runs))
            if got.shape != (n, 256, 256, 3) or runs != nodes or (
                    err != 0.0 if "int8" in stem else err >= EXPORT_BF16_TOL):
                raise AssertionError(f"{stem}.pt2 at batch {n}: max |artifact - live| {err}, "
                                     f"{runs} group launches (want {nodes}), {got.shape}")
        family = "esrgan" if stem.startswith("rrdb") else "transfer"
        depth = "" if model is fen else f" ({ZOO8_EXPORT_DEPTH[family]})"
        log(f"  14.4 {stem}.pt2{depth}: {len(blob) / 1e6:.2f} MB, export {export_s:.1f} s, load "
            f"{load_s:.1f} s, symbolic batch {input_shape_str(fn.exported)}; rcab_group nodes "
            f"{got_nodes[0]} (want {nodes}), int8_conv nodes {got_nodes[1]} (want {int8_nodes}); "
            + "; ".join(f"batch {n}: max |artifact - live| {e:.3g}, {r} group launches"
                        for n, e, r in errs)
            + (" (bitwise)" if "int8" in stem else f" (limit {EXPORT_BF16_TOL})") + f" [{card}]")
        if got_nodes != (nodes, int8_nodes):
            raise AssertionError(f"{stem}.pt2 holds {got_nodes} custom-op nodes")
        artifacts[stem] = fn
        del module, live
    del fen, cut

    mark("14.4", t_part)
    t_part = time.perf_counter()
    # 14.5 the API serving the transfer int8_full artifact
    fn = artifacts["transfer_int8_full"]
    imgs = smooth_u8(ZOO8_HTTP_REQUESTS, 64, 64, 141)
    bodies = [png.encode(im) for im in imgs]
    srv = port_api.serve(str(tmp / "zoo_pt2_empty"), port=0, host="127.0.0.1", device=dev,
                         exported=str(art_dir / "transfer_int8_full.pt2"))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        half = ZOO8_HTTP_REQUESTS // 2
        wall, lat, warm, results, errors = drive_http(
            srv.server_address[1], bodies, [list(range(half)),
                                            list(range(half, ZOO8_HTTP_REQUESTS))])
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()
    bad = [(i, s, d[:200]) for i, s, d in results if s != 200]
    same = sum(s == 200 and np.array_equal(
        png.decode_rgb(d, "response"),
        (fn(prepare_inputs(imgs[i])[0][None])[0] * 255).round().astype(np.uint8))
        for i, s, d in results)
    log(f"  14.5 API --exported transfer_int8_full.pt2: {len(results)} requests from 2 keep-alive "
        f"clients, {same} bitwise the artifact's batch-1 output; errors {errors}; failed "
        f"responses {bad}; p50 {statistics.median(warm + lat) * 1e3:.1f} ms [{card}]")
    if errors or bad or same != ZOO8_HTTP_REQUESTS or len(results) != ZOO8_HTTP_REQUESTS:
        raise AssertionError("the API serving the transfer int8_full artifact")
    del artifacts, fn
    for m in models.values():
        m.cpu()
    del models
    torch.cuda.empty_cache()

    mark("14.5", t_part)
    t_part = time.perf_counter()
    # 14.6 QAT: the transfer YAML through the CLI, and small zoo steps card vs CPU
    run_dir = tmp / "zoo_qat_cli"
    run_dir.mkdir()
    text = TRANSFER_YAML.read_text().replace("training:\n", "training:\n  qat: true\n", 1)
    (run_dir / "transfer_qat.yaml").write_text(text)
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        torch.cuda.reset_peak_memory_stats()
        before = rg.fused_residual_group.launches
        with contextlib.redirect_stdout(_Tee(sys.stdout)):
            trainer = train_cli.run(["--config", "transfer_qat.yaml", "--data-root",
                                     str(tmp / "data"), "--epochs", "1"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        os.chdir(cwd)
    m = trainer.last_train_metrics
    ms = statistics.median(trainer.last_step_times[1:]) * 1e3
    log(f"  14.6 transfer_config.yaml with training.qat through the CLI (phase 8's PNGs, 1 "
        f"epoch): {len(trainer.last_step_times)} steps, {ms:.3f} ms/step against phase 13's "
        f"{step_alone_ms:.3f} ms for the float step alone; peak memory {peak:.3f} GiB; "
        f"{len(trainer._qat_sites)} fake-quant sites; losses {m}; "
        f"{rg.fused_residual_group.launches - before} group launches [{card}]")
    if not (trainer.config.qat and math.isfinite(m["loss"]) and trainer.model_type == "transfer"
            and rg.fused_residual_group.launches == before):
        raise AssertionError("the transfer QAT CLI run failed")
    del trainer
    torch.cuda.empty_cache()
    # the CPU step takes the card's fake-quant level wherever the two round
    # a tie apart (`fake_quant_levels`), so one tie does not spread through
    # the later sites; a level that differs away from a tie fails the check
    for kind, stage in (("esrgan", 1), ("transfer", 2)):
        with fake_quant_levels() as card_lv:
            got, start = small_zoo_step(dev, kind, stage, qat=True)
        with fake_quant_levels(lambda i, w: (card_lv["weights"][i], card_lv["levels"][i],
                                                 card_lv["outputs"][i])) as pin:
            want, _ = small_zoo_step("cpu", kind, stage, qat=True)
        errs = step_errors(got, want)
        frozen = [k for k in start if k not in got[1]]
        still = all(torch.equal(got[2][k], start[k]) for k in frozen)
        where = f" stage {stage}" if kind == "transfer" else ""
        log(f"  14.6 small {kind} QAT step{where} card vs CPU (f32): loss {errs[0]:.3g}, worst "
            f"gradient {errs[1]:.3g}, worst param {errs[2]:.3g} (limit {STEP_RTOL}); "
            f"{len(frozen)} frozen tensors bitwise unchanged {still}; of the kernel and "
            f"activation levels and output signs at {len(pin['levels'])} sites ("
            f"{sum(t.numel() for k in ('weights', 'levels', 'outputs') for t in pin[k])}), "
            f"{pin['ties']} taken from the card at a tie "
            f"(worst level {pin['worst_tie']:.3g} from its boundary, limit {LEVEL_TIE}; signs "
            f"within {SIGN_TIE} of max|y|), {pin['off_tie']} differ away from a tie")
        if (max(errs) > STEP_RTOL or pin["off_tie"] or not still
                or (kind == "transfer") != bool(frozen)):
            raise AssertionError(f"the small {kind} QAT step on the card is off the CPU's")
        with fake_quant_levels() as card_lv:
            forced, _ = small_zoo_step(dev, kind, stage, tf32_forced=True, qat=True)
        with fake_quant_levels(lambda i, w: (card_lv["weights"][i], card_lv["levels"][i],
                                                 card_lv["outputs"][i])) as pin:
            errs = step_errors(forced, small_zoo_step("cpu", kind, stage, qat=True)[0])
        rejected = max(errs) > STEP_RTOL or pin["off_tie"] > 0
        log(f"  14.6 control, the {kind} QAT step with TF32 forced: {errs}, {pin['off_tie']} "
            f"levels and signs off the CPU's away from a tie, {pin['ties']} at a tie -> "
            f"{'rejected' if rejected else 'within'}")
        if not rejected:
            raise AssertionError(f"the {kind} QAT step check lets TF32 convs pass")
    mark("14.6", t_part)
    launches = rg.fused_residual_group.launches - start_launches
    log(f"  {launches} group launches in phase 14; phase 14 took "
        f"{time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + f" [{card}]")
    return launches


# ---------------------------------------------------------------------------
# 15. explainability, stage_panel and the checkpoint bridge

EXPLAIN_BATCH = 4  # cut from 8 (time: the CPU's Grad-CAM at full width)
EXPLAIN_LAYERS = ("conv_first", "group3", "group6")
# card vs CPU, both the port in f32 with TF32 off. The CAM's channel
# weights are the spatial mean of dTarget/dA, which f32 conditions poorly:
# on an H100 the two sit up to 9.16e-05 apart (the CPU as far from f64 as
# the card), while TF32 convs (10-bit mantissa) move the CAM by 3.0e-03 to
# 5.8e-03. The limit sits between the two, ~3x above the one and ~10x
# below the other, so another cuDNN algorithm does not fail a right CAM.
CAM_ATOL, ATTN_ATOL = 3e-4, 1e-5
EXPLAIN_TIMED = 2
PANEL_IMAGES, PANEL_HR = 4, 256
# stage_panel card vs CPU: each model's f32 forward in other summation
# orders moves a uint8 value where the output sits near a rounding midpoint
PANEL_OFF_SHARE = 0.005
RESUME_BATCH, RESUME_HR = 16, 256  # the stage-1 resume, its batch cut from 48 (time)
RESUME_GAN_BATCH, RESUME_GAN_HR = 8, 64
# a resumed run against the uninterrupted one: bitwise with cuDNN made
# deterministic; where the card cannot be, per tensor relative L2
RESUME_RTOL = 1e-6


def event_ms(fn, reps) -> float:
    """Median device time of fn() in ms over ``reps`` calls, each timed by
    CUDA events and ending in a host read."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _tensors_of(state) -> dict:
    """A trainer's state as {name: CPU tensor}: params, EMA, the optimisers'
    moments and counts, and D's params and stats when there is a D."""
    out = {f"param.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in (state.ema_params or {}).items()})
    for prefix, opt in (("opt", state.opt_state), ("d_opt", state.d_opt_state)):
        for k, v in (opt or {}).items():
            if isinstance(v, dict):
                out.update({f"{prefix}.{k}.{n}": t for n, t in v.items()})
            else:
                out[f"{prefix}.{k}"] = v
    if state.disc is not None:
        out.update({f"D.{k}": v for k, v in state.disc.state_dict().items()})
    return {k: v.detach().cpu() for k, v in out.items()}


def _compare_runs(got: dict, want: dict):
    """(bitwise, worst relative L2 of a tensor, its name)."""
    if set(got) != set(want):
        raise AssertionError(f"resumed state has other tensors: {set(got) ^ set(want)}")
    worst, where = 0.0, ""
    for k, w in want.items():
        if torch.equal(got[k], w):
            continue
        rel = float((got[k].double() - w.double()).norm() / max(float(w.double().norm()), 1e-30))
        if rel >= worst:
            worst, where = rel, k
    return worst == 0.0, worst, where


def resume_runs(dev, card, tmp: Path, gan: bool) -> dict:
    """Two uninterrupted epochs against one epoch, a full resume in a new
    Trainer (from the .fckpt, and from the .pth) and one more epoch."""
    from facesr_torch.ckpt import fckpt
    from facesr_torch.models.discriminator import create_discriminator
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    n, hr = (RESUME_GAN_BATCH, RESUME_GAN_HR) if gan else (RESUME_BATCH, RESUME_HR)
    cfg = production_config()
    train = [{"hr": smooth_hr(n, hr, seed=150 + i, dev="cpu").numpy()} for i in range(2)]
    val = [{"hr": smooth_hr(8, hr, seed=160, dev="cpu").numpy()}]
    gan_kw = dict(gan_weight=0.005, d_learning_rate=1e-4) if gan else {}

    def trainer(d, epochs, seed):
        # the stage-1 YAML's values (stage 3's GAN term with gan), EMA on
        cfg = TrainerConfig(epochs=epochs, learning_rate=1e-4, weight_decay=0.0,
                            gradient_clip=0.5, use_amp=False, scheduler_type="cosine",
                            scheduler_T_max=100, scheduler_eta_min=1e-7, save_every=1,
                            checkpoint_dir=str(d), ema_decay=0.999, step_log_every=0,
                            early_stopping_metric="val_loss", early_stopping_mode="min",
                            **gan_kw)
        disc = (create_discriminator(input_size=hr, base_channels=64, device="cpu", seed=seed)
                if gan else None)
        return Trainer(FaceEnhanceNet(production_config(), seed=seed, device="cpu"), train, val,
                       stage1_loss("cpu"), cfg, device=dev, discriminator=disc)

    name = "GAN" if gan else "stage-1"
    root = tmp / ("resume_gan" if gan else "resume")
    full = trainer(root / "full", 2, seed=0)
    t0 = time.perf_counter()
    full.train()
    full_s = time.perf_counter() - t0
    want = _tensors_of(full.state)
    first = trainer(root / "first", 1, seed=0)
    first.train()
    payload = first._checkpoint_payload()
    t0 = time.perf_counter()
    tree = fckpt.train_state_tree(
        first.model_type, payload["model_state_dict"], first.optimizer,
        payload["optimizer_state"], payload["step"], first._loss_params_tree(),
        ema=payload["ema_state_dict"],
        disc_sd=payload.get("discriminator_state_dict"),
        d_optimizer=first.d_optimizer if gan else None,
        d_opt_state=payload.get("d_optimizer_state"))
    tree_s = time.perf_counter() - t0
    timed = root / "timed.fckpt"
    t0 = time.perf_counter()
    fckpt.save_checkpoint(str(timed), tree, {"epoch": payload["epoch"]})
    write_s = time.perf_counter() - t0
    size_mb = (root / "first" / "final_model.fckpt").stat().st_size / 1e6
    log(f"  15.3 {name} .fckpt: {size_mb:.1f} MB, the TrainState tree built in "
        f"{tree_s * 1e3:.1f} ms and written in {write_s * 1e3:.1f} ms on the host; the .pth "
        f"{(root / 'first' / 'final_model.pth').stat().st_size / 1e6:.1f} MB [{card}]")
    del first
    torch.cuda.empty_cache()
    results = {}
    for fmt in ("fckpt", "pth"):
        resumed = trainer(root / f"resumed_{fmt}", 2, seed=7)
        resumed.load_checkpoint(str(root / "first" / f"final_model.{fmt}"))
        if resumed.current_epoch != 1 or resumed.global_step != 2:
            raise AssertionError(f"{name} resume from .{fmt}: epoch {resumed.current_epoch}, "
                                 f"step {resumed.global_step}")
        resumed.train()
        bitwise, worst, where = _compare_runs(_tensors_of(resumed.state), want)
        same_meta = (resumed.global_step == full.global_step
                     and resumed.training_history.keys() == full.training_history.keys())
        results[fmt] = (bitwise, worst)
        log(f"  15.3 {name}: 1 epoch, a new Trainer resumed from final_model.{fmt}, 1 more "
            f"epoch, against 2 uninterrupted epochs ({full_s:.2f} s; batch {n}, HR {hr}, "
            f"{cfg.num_groups}x{cfg.blocks_per_group}x{cfg.num_channels}, L1 + perceptual, "
            f"EMA): params, EMA, moments, counts"
            f"{', D, its stats and its optimiser' if gan else ''} "
            + ("bitwise equal" if bitwise else
               f"not bitwise: worst relative L2 {worst:.3g} at {where} (limit {RESUME_RTOL}; "
               "cudnn.deterministic covers cuDNN's kernels, not every other op's backward)")
            + f"; steps and history keys equal: {same_meta} [{card}]")
        if not (same_meta and (bitwise or worst <= RESUME_RTOL)):
            raise AssertionError(f"{name}: the run resumed from .{fmt} left the "
                                 "uninterrupted run")
        del resumed
        torch.cuda.empty_cache()
    del full
    torch.cuda.empty_cache()
    return {"epochs": [root / "full" / "epoch_1.fckpt", root / "full" / "epoch_2.fckpt"],
            "results": results}


def explain_phase(dev, card, tmp: Path) -> None:
    """Phase 15: explainability at full width (card against CPU, TF32
    control, times, the report), full resumes across the two formats,
    stage_panel on the card and on the CPU, the converter at full width."""
    from facesr_torch.ckpt.weights import read_state_dict, save_reference_pth
    from facesr_torch.cli import convert, stage_panel
    from facesr_torch.data import png
    from facesr_torch.evaluation import explainability as ex
    from facesr_torch.models.esrgan import RRDBNet, RRDBNetConfig
    from facesr_torch.ops import conv as tconv
    from facesr_torch.ops import rcab_group as rg

    t_phase = time.perf_counter()
    start_launches = rg.fused_residual_group.launches
    cfg = production_config()
    log(f"== 15. explainability, stage_panel and the checkpoint bridge, "
        f"{cfg.num_groups}x{cfg.blocks_per_group}x{cfg.num_channels} f32 [{card}]")
    model = production_model(dev, nonzero_last=True)
    cpu_model = production_model("cpu", nonzero_last=True)
    x = torch.rand((EXPLAIN_BATCH, 64, 64, 3), generator=torch.Generator().manual_seed(150))

    # 15.1 Grad-CAM and SE attention, card against CPU
    errs, cpu_cams, cpu_s = {}, {}, 0.0
    for layer in EXPLAIN_LAYERS:
        got = ex.GradCAM(model, layer).generate_multi_region(x)
        t0 = time.perf_counter()
        cpu_cams[layer] = want = ex.GradCAM(cpu_model, layer).generate_multi_region(x)
        cpu_s += time.perf_counter() - t0
        for region in ex.FACE_REGIONS:
            if got[region].shape != (EXPLAIN_BATCH, 64, 64) or not np.isfinite(got[region]).all():
                raise AssertionError(f"CAM {layer}/{region}: {got[region].shape}")
        errs[layer] = max(float(np.abs(got[r] - want[r]).max()) for r in ex.FACE_REGIONS)
    real = tconv.full_f32, ex.full_f32
    tconv.full_f32 = ex.full_f32 = tf32_forced
    try:
        tf32 = {layer: max(float(np.abs(cams[r] - cpu_cams[layer][r]).max())
                           for r in ex.FACE_REGIONS)
                for layer in EXPLAIN_LAYERS
                for cams in [ex.GradCAM(model, layer).generate_multi_region(x)]}
    finally:
        tconv.full_f32, ex.full_f32 = real
    log(f"  15.1 Grad-CAM, batch {EXPLAIN_BATCH} 64x64, card vs CPU, max abs per target "
        f"layer over the 4 regions {errs} (limit {CAM_ATOL}); TF32 forced {tf32} -> "
        f"{'rejected' if max(tf32.values()) > CAM_ATOL else 'within'}; the CPU's three "
        f"generate_multi_region calls took {cpu_s:.2f} s")
    if max(errs.values()) > CAM_ATOL:
        raise AssertionError("Grad-CAM on the card is off the CPU's")
    if max(tf32.values()) <= CAM_ATOL:
        raise AssertionError("the CAM limit lets TF32 convs pass")
    got_a = ex.AttentionExtractor(model).extract(x)
    want_a = ex.AttentionExtractor(cpu_model).extract(x)
    attn_err = max(float(np.abs(got_a[k] - want_a[k]).max()) for k in want_a)
    log(f"  15.1 SE attention, {len(got_a)} RCABs x [{EXPLAIN_BATCH}, {cfg.num_channels}]: card "
        f"vs CPU max abs "
        f"{attn_err:.3g} (limit {ATTN_ATOL})")
    if len(got_a) != cfg.num_groups * cfg.blocks_per_group or attn_err > ATTN_ATOL:
        raise AssertionError("SE attention on the card is off the CPU's")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cam = ex.GradCAM(model, "group3")
    multi_ms = event_ms(lambda: cam.generate_multi_region(x), EXPLAIN_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lr = x[0].numpy()
    flow_ms = event_ms(lambda: ex.visualize_attention_flow(model, lr), EXPLAIN_TIMED)
    log(f"  15.1 generate_multi_region at group3, batch {EXPLAIN_BATCH}: median of "
        f"{EXPLAIN_TIMED} {multi_ms:.3f} ms (CUDA events, 4 regions, one head forward), peak "
        f"memory {peak:.3f} GiB; visualize_attention_flow of one 64x64 image ({cfg.num_groups} "
        f"CAMs and the panel): {flow_ms:.3f} ms [{card}]")
    report = ex.create_attention_report(model, lr, str(tmp / "explain_report"))
    files = sorted(p.name for p in (tmp / "explain_report").iterdir())
    regions = png.read_rgb(tmp / "explain_report" / "gradcam_regions.png")
    flow = png.read_rgb(tmp / "explain_report" / "attention_flow.png")
    ok = (files == ["attention_flow.png", "attention_report.json", "gradcam_regions.png"]
          and regions.shape == (256, 256 * 5, 3) and flow.shape == (256, 256 * 7, 3)
          and json.loads((tmp / "explain_report" / "attention_report.json").read_text())
          == report
          and len(report["attention_summary"]) == cfg.num_groups * cfg.blocks_per_group)
    log(f"  15.1 create_attention_report on the card: {files}, panels {regions.shape} and "
        f"{flow.shape}, most active {report['most_active_block']}, least active "
        f"{report['least_active_block']}: {ok}")
    if not ok:
        raise AssertionError("the attention report's files are not as written")
    del model, cpu_model, cam
    torch.cuda.empty_cache()

    # 15.3 full resumes, deterministic cuDNN for this phase only
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        stage1 = resume_runs(dev, card, tmp, gan=False)
        resume_runs(dev, card, tmp, gan=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved

    # 15.2 stage_panel on the card and on the CPU, on 15.3's epoch files
    hr_dir = tmp / "panel_hr"
    hr_dir.mkdir()
    for i in range(PANEL_IMAGES):
        img = smooth_hr(1, PANEL_HR, seed=170 + i, dev="cpu")[0].numpy()
        png.write_png(hr_dir / f"face_{i}.png", (img * 255).round().astype(np.uint8))
    walls = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        stage_panel.main(["--checkpoints", *map(str, stage1["epochs"]), "--labels", "epoch1",
                          "epoch2", "--test-dir", str(hr_dir), "--output",
                          str(tmp / f"panel_{device}"), "--device", device])
        walls[device] = time.perf_counter() - t0
    names = sorted(p.name for p in (tmp / "panel_cuda").glob("*.png"))
    worst = 0.0
    for n in names:
        a = png.read_rgb(tmp / "panel_cuda" / n).astype(int)
        b = png.read_rgb(tmp / "panel_cpu" / n).astype(int)
        d = np.abs(a - b)
        share = float((d > 0).any(axis=-1).mean())
        worst = max(worst, share)
        if a.shape != b.shape or d.max() > 1 or share > PANEL_OFF_SHARE:
            raise AssertionError(f"stage_panel {n}: card vs CPU max {d.max()}, share {share}")
    if len(names) != 2 * PANEL_IMAGES + 1:
        raise AssertionError(f"stage_panel wrote {names}")
    log(f"  15.2 stage_panel, 2 checkpoints x {PANEL_IMAGES} {PANEL_HR}x{PANEL_HR} PNGs: "
        f"{len(names)} panels, card vs CPU at most 1 level apart on {worst:.4%} of pixels "
        f"(limit {PANEL_OFF_SHARE:.1%}); wall {walls['cuda']:.2f} s --device cuda, "
        f"{walls['cpu']:.2f} s --device cpu [{card}]")

    # 15.4 the converter at full width, both ways
    for kind, model in (("custom", production_model("cpu", nonzero_last=True)),
                        ("rrdbnet", RRDBNet(RRDBNetConfig(), seed=0, device="cpu"))):
        src, mid, back = (tmp / f"conv_{kind}{ext}" for ext in (".pth", ".fckpt", "_back.pth"))
        save_reference_pth(str(src), model)
        t0 = time.perf_counter()
        convert.main(["--input", str(src), "--output", str(mid), "--kind", kind])
        fwd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        convert.main(["--reverse", "--input", str(mid), "--output", str(back)])
        rev_s = time.perf_counter() - t0
        a, b = read_state_dict(str(src)), read_state_dict(str(back))
        same = list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
        log(f"  15.4 convert {kind} ({sum(v.numel() for v in a.values()):,} params): "
            f".pth -> .fckpt {mid.stat().st_size / 1e6:.1f} MB in {fwd_s:.2f} s, --reverse in "
            f"{rev_s:.2f} s; {len(a)} tensors back bitwise, same keys in the same order: {same}")
        if not same:
            raise AssertionError(f"convert {kind}: the state dict did not come back bitwise")
    launches = rg.fused_residual_group.launches - start_launches
    log(f"  {launches} group launches in phase 15 (f32 throughout); phase 15 took "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    if launches:
        raise AssertionError("phase 15 launched the bf16 group kernel")


# phase 16: data parallelism on the card, in child processes started after
# the parent freed its cache: one world-1 NCCL rank for (a) the step in a
# group against the step alone, (d) the train CLI with --print-memory and
# (e) ShardedPredictor over [cuda:0, cuda:0]; two gloo ranks sharing cuda:0
# (NCCL refuses two ranks on one device) for (b) the dp steps against the
# single-process step and (c) a Trainer epoch. The card's machine has one
# card: NCCL across cards is not exercised here.
DP_TIMED = 1            # timed dp steps in (b)
DP_STEP_BATCH = 16      # (b)'s global batch, 8 rows a rank (cut from 48: time)
# (b)'s limit a tensor: max(STEP_RTOL, DP_FLOOR_FACTOR x its rounding
# floor), the floor being how far that tensor of the single-process step
# moves under rounding alone: its input times (1 + 2^-23 N(0, 1)), and the generator, D's convs
# and D's dense layers run on the ranks' row blocks (the same math with the
# cuDNN and cuBLAS algorithms of 24 rows), BatchNorm and the losses still
# over all 48. D's first-layer gradients are sums that cancel (a BatchNorm
# follows), so rounding moves them far more than 1e-4; and Adam's first step
# (~lr * sign(g)) turns a near-zero gradient's flip into a 2 lr move of a
# zero-initialised bias, so a tensor's floor is the larger of two noise
# draws (one draw can miss a flip the dp step makes)
DP_FLOOR_FACTOR = 10
DP_FLOOR_NOISE = 2.0 ** -23
DP_FLOOR_SEEDS = (11, 12)
DP_SHOWN = 6            # tensors of (b) printed with their limits
DP_TRAINER_WORKERS = 4  # loader threads a rank in (c)
DP_TIMEOUT = 300        # seconds: each collective and the group's join
DP_DEVICE, DP_BACKEND = "cuda:0", "nccl"  # the world-1 rank's (the two ranks: gloo)
DP_CLI_FLAGS = ()       # extra train CLI flags of (d)


def _state_hash(tensors) -> str:
    """sha256 over the bytes of tensors, in order (bitwise equality across
    processes without sending them)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _step_record(state, step, hr, gan, moments=False):
    """One step; the loss(es), the recorded gradients, the updated params
    (and D's params and stats), all on the host; with ``moments`` also G's
    first moments."""
    _, metrics = step(state, hr)
    rec = {"losses": {k: metrics[k].detach().cpu() for k in
                      (("loss", "d_loss", "g_adv") if gan else ("loss",))},
           "g_grads": step.optimizers[0].grads,
           "g_params": {k: v.detach().cpu().clone() for k, v in
                        state.model.named_parameters()}}
    if gan:
        rec.update(d_grads=step.optimizers[1].grads,
                   d_params={k: v.detach().cpu().clone() for k, v in
                             state.disc.named_parameters()},
                   d_stats={k: v.detach().cpu().clone() for k, v in state.disc.named_buffers()})
    if moments:
        rec["g_mu"] = {k: v.detach().cpu().clone() for k, v in state.opt_state["mu"].items()}
    return rec


def _tensor_errors(got, want) -> dict:
    """The relative L2 of each tensor of two `_step_record`s, by part."""
    from facesr_torch.cli.step_numerics import rel_l2

    return {part: {k: rel_l2(got[part][k], v) for k, v in want[part].items()}
            for part in want}


def _time_all_reduce(mesh, n, reps=10) -> float:
    """Median ms of one all-reduce of n floats on the rank's card."""
    import torch.distributed as dist

    bucket = torch.randn(n, device=mesh.device)
    times = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(bucket, group=mesh.group)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _row_blocks(fn, parts):
    """fn on each of ``parts`` row blocks of its first argument, concatenated."""
    return lambda x, *args, **kwargs: torch.cat([fn(p, *args, **kwargs)
                                                 for p in x.chunk(parts)])


def _rounding_floor(build, dev, hr, gan, parts, seed, moments=False):
    """The single-process step on all of ``hr`` with rounding-sized changes
    only (see DP_FLOOR_FACTOR), its noise drawn from ``seed`` (None: no
    noise): the recorded step (``moments``: with G's first moments)."""
    from facesr_torch.cli.step_numerics import RecordingAdamW
    from facesr_torch.models import discriminator as dmod

    conv, dense = dmod.conv2d, dmod._dense
    dmod.conv2d, dmod._dense = _row_blocks(conv, parts), _row_blocks(dense, parts)
    try:
        state, step, _ = build(dev, opt_cls=RecordingAdamW)
        state.model.forward = _row_blocks(state.model.forward, parts)
        if seed is not None:
            noise = torch.randn(hr.shape, generator=torch.Generator().manual_seed(seed)).to(dev)
            hr = hr * (1 + DP_FLOOR_NOISE * noise)
        return _step_record(state, step, hr, gan, moments)
    finally:
        dmod.conv2d, dmod._dense = conv, dense


def dp_world1_rank(mesh, tmp: str, card: str) -> dict:
    """(d), (a), the NCCL bucket time and (e) in one world-1 NCCL rank."""
    import gc
    import io
    import os
    import re

    from facesr_torch.cli import train as train_cli
    from facesr_torch.cli.step_numerics import RecordingAdamW
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.parallel.serving import Predictor, ShardedPredictor, shard_bounds

    dev, out, tmp = mesh.device, {"lines": []}, Path(tmp)
    # (d) first, in a fresh process, so its peak is the step's own
    run_dir = tmp / "dp_cli"
    run_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(run_dir)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            trainer = train_cli.run(["--config", str(STAGE1_YAML), "--data-root",
                                     str(tmp / "data"), "--epochs", "1", "--print-memory",
                                     *DP_CLI_FLAGS])
    finally:
        os.chdir(cwd)
    text = buf.getvalue()
    report = {k: int(v) for k, v in re.findall(r"  (\w[\w ]*?)\s+[\d.]+ MB \((\d+) bytes\)",
                                                  text)}
    out["cli"] = {"s": time.perf_counter() - t0, "report": report,
                  "rank_line": "rank 0 of 1, device memory" in text,
                  "joined": "Data parallel: rank 0 of 1" in text,
                  "distributed": trainer.mesh.distributed, "steps": trainer.global_step,
                  "history": trainer.training_history,
                  "files": sorted(p.name for p in (run_dir / "checkpoints").iterdir()),
                  "step_ms": trainer.last_train_metrics.get("step_ms")}
    out["lines"] += [f"  (d) {line.strip()}" for line in text.splitlines()
                     if "MB (" in line or "rank 0 of 1" in line or "Batch size" in line]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # (a) the stage-1 step in the NCCL group against the same step alone,
    # cuDNN deterministic (its backward algorithms may sum in any order)
    hr = smooth_hr(TRAIN_BATCH, TRAIN_HR, seed=7, dev=dev)
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, m in (("alone", None), ("nccl", mesh)):
            state, step, _ = production_step_fn(dev, mesh=m, opt_cls=RecordingAdamW)
            runs[name] = _step_record(state, step, hr, gan=False)
            del state, step
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = runs["alone"], runs["nccl"]
    out["a_bitwise"] = all(torch.equal(a[part][k], b[part][k]) for part in a
                           for k in a[part])
    n_params = sum(v.numel() for v in a["g_params"].values())
    out["n_params"] = n_params
    out["nccl_ms"] = _time_all_reduce(mesh, n_params)
    del runs, a, b, hr
    torch.cuda.empty_cache()

    # (e) ShardedPredictor over [cuda:0, cuda:0] in bf16 at batch MAX_BATCH
    model = production_model(dev, nonzero_last=True)
    x = np.random.default_rng(3).random((MAX_BATCH, 64, 64, 3), dtype=np.float32)
    sp = ShardedPredictor(model, mesh=[dev, dev], dtype=torch.bfloat16, max_batch=MAX_BATCH)
    sp(x)  # warm-up
    rg.fused_residual_group.launches = 0
    got = sp(x)
    torch.cuda.synchronize()
    out["launches"] = rg.fused_residual_group.launches
    bounds = shard_bounds(MAX_BATCH, 2)
    pred = Predictor(model, dtype=torch.bfloat16, max_batch=bounds[0][1], device=dev)
    out["e_bitwise"] = all(np.array_equal(got[lo:hi], pred(x[lo:hi])) for lo, hi in bounds)
    out["e_finite"] = bool(np.isfinite(got).all()) and got.shape == (MAX_BATCH, 256, 256, 3)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sp(x)
        times.append(time.perf_counter() - t0)
    out["e_ms"] = statistics.median(times) * 1e3
    out["shards"] = len(bounds)
    return out


def dp_two_rank(mesh, tmp: str, card: str) -> dict:
    """(b) and (c) on one of two gloo ranks sharing cuda:0."""
    import io

    from facesr_torch.cli.step_numerics import RecordingAdamW
    from facesr_torch.data.dataset import get_dataloader
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.parallel.mesh import shard_batch
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    dev, rank, tmp = mesh.device, mesh.rank, Path(tmp)
    out = {"rank": rank}
    hr = smooth_hr(DP_STEP_BATCH, TRAIN_HR, seed=7, dev=dev)  # the same global batch
    rows = shard_batch(hr, mesh)
    for gan in (False, True):
        build = gan_step_fn if gan else production_step_fn
        key = "gan" if gan else "content"
        if rank == 0:  # the single-process step on the global batch, and on rank 0's rows
            state, step, _ = build(dev, opt_cls=RecordingAdamW)
            want = _step_record(state, step, hr, gan)
            del state, step
            state, step, _ = build(dev, opt_cls=RecordingAdamW)
            alone = _step_record(state, step, rows, gan)
            del state, step
            draws = [_tensor_errors(_rounding_floor(build, dev, hr, gan, mesh.world_size, seed),
                                    want) for seed in DP_FLOOR_SEEDS]
            floor = {part: {k: max(d[part][k] for d in draws) for k in draws[0][part]}
                     for part in draws[0]}
            torch.cuda.empty_cache()
        state, step, _ = build(dev, mesh=mesh, opt_cls=RecordingAdamW)
        got = _step_record(state, step, rows, gan)
        times = []
        for _ in range(DP_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, rows)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        tensors = list(state.model.parameters()) + list(state.opt_state["mu"].values())
        if gan:
            tensors += list(state.disc.parameters()) + list(state.disc.buffers())
        out[key] = {"hash": _state_hash(tensors), "ms": statistics.median(times)}
        del state, step
        control = None
        if gan:  # the per-rank BatchNorm control: D's forward without the mesh
            state, step, _ = build(dev, mesh=mesh, opt_cls=RecordingAdamW)
            forward = state.disc.forward
            state.disc.forward = lambda x, train=True, dtype=None, mesh=None: forward(x, train,
                                                                                     dtype)
            control = _step_record(state, step, rows, gan)
            del state, step
        if rank == 0:
            out[key].update(errors=_tensor_errors(got, want), floor=floor,
                            unreduced=_tensor_errors(alone, want),
                            per_rank_bn=None if control is None else _tensor_errors(control, want))
            del want, alone, floor, draws
        torch.cuda.empty_cache()
    out["gloo_ms"] = _time_all_reduce(mesh, sum(p.numel() for p in
                                                production_model("cpu", False).parameters()))

    # (c) a Trainer epoch on phase 8's PNGs: each rank loads 24 of every 48
    local = TRAIN_BATCH // mesh.world_size
    train = get_dataloader(str(tmp / "data"), mode="train", batch_size=local,
                           num_workers=DP_TRAINER_WORKERS, hr_patch_size=CLI_HR, seed=42)
    val = get_dataloader(str(tmp / "data"), mode="val", batch_size=local,
                         num_workers=DP_TRAINER_WORKERS, seed=42)
    ckpt = tmp / "dp_trainer" / f"rank{rank}"
    cfg = TrainerConfig(epochs=1, learning_rate=1e-4, weight_decay=0.0, gradient_clip=0.5,
                        use_amp=False, save_every=1, checkpoint_dir=str(ckpt), step_log_every=0)
    tr = Trainer(FaceEnhanceNet(production_config(), seed=0, device="cpu"), train, val,
                 stage1_loss("cpu"), cfg, mesh=mesh)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the two ranks' epoch lines
        history = tr.train()
    out["trainer"] = {"s": time.perf_counter() - t0, "history": history,
                      "steps": tr.global_step, "writer": tr.is_writer,
                      "files": sorted(p.name for p in ckpt.iterdir()) if ckpt.exists() else None,
                      "step_ms": tr.last_train_metrics.get("step_ms"),
                      "batch_rows": train.batch_size, "hash": _state_hash(tr.model.parameters())}
    return out


def dp_phase(card: str, tmp: Path) -> int:
    """Phase 16: data parallelism on the card; returns the group kernel's
    launches on its serving path (e)."""
    from facesr_torch.parallel.launch import run_ranks

    log(f"== 16. data parallelism (child processes; the card's machine has one card, so NCCL "
        f"runs at world size 1 and two ranks share cuda:0 over gloo) [{card}]")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    w1 = run_ranks(dp_world1_rank, 1, args=(str(tmp), card), devices=[DP_DEVICE],
                   backend=DP_BACKEND, timeout=DP_TIMEOUT)[0]
    cli = w1["cli"]
    for line in w1["lines"]:
        log(line)
    peak = cli["report"].get("step peak")
    log(f"  (d) the train CLI on the stage-1 YAML under a world-1 torchrun env (NCCL), "
        f"--print-memory, 1 epoch on phase 8's PNGs: {cli['steps']} steps, "
        f"{cli['step_ms']:.3f} ms/step, {cli['s']:.1f} s with its set-up; reported step peak "
        f"{(peak or 0) / 2 ** 30:.3f} GiB against phase 7's 22.1 GiB (PERF.md, batch 48 alone) "
        f"[{card}]")
    measured = not DP_DEVICE.startswith("cuda") or (peak or 0) > cli["report"]["state"]
    if not (cli["joined"] and cli["distributed"] and cli["rank_line"] and measured
            and "final_model.fckpt" in cli["files"]
            and all(math.isfinite(v) for v in cli["history"]["val_psnr"])):
        raise AssertionError(f"the world-1 train CLI run: {cli}")
    log(f"  (a) the stage-1 step (6x10x64 f32, batch {TRAIN_BATCH}, HR {TRAIN_HR}) in a "
        f"world-1 NCCL group against the same step without a group (cuDNN deterministic): "
        f"loss, gradients and params bitwise equal: {w1['a_bitwise']}")
    if not w1["a_bitwise"]:
        raise AssertionError("the world-1 NCCL step is not bitwise the step alone")
    log(f"  all-reduce of the {w1['n_params']}-float gradient bucket, NCCL world 1: median of "
        f"10 {w1['nccl_ms']:.3f} ms [{card}]")
    per = production_config().num_groups
    log(f"  (e) ShardedPredictor(mesh=[cuda:0, cuda:0]) bf16, batch {MAX_BATCH} of 64x64: "
        f"{w1['shards']} shards, each bitwise Predictor at its size: {w1['e_bitwise']}; group "
        f"launches {w1['launches']} (want {per} a shard = {per * w1['shards']}); median of 3 "
        f"{w1['e_ms']:.3f} ms = {MAX_BATCH / w1['e_ms'] * 1e3:.1f} images/s (both shards on "
        f"one card) [{card}]")
    if not (w1["e_bitwise"] and w1["e_finite"] and w1["launches"] == per * w1["shards"]):
        raise AssertionError("ShardedPredictor over [cuda:0, cuda:0] failed its checks")

    two = run_ranks(dp_two_rank, 2, args=(str(tmp), card), devices=[DP_DEVICE] * 2,
                    backend="gloo", timeout=DP_TIMEOUT)
    r0, r1 = two
    fmt = lambda d: json.dumps({k: float(f"{v:.3g}") for k, v in d.items()})
    for key, name in (("content", "stage-1 step"), ("gan", "stage-3 GAN step")):
        res = r0[key]
        limit = {part: {k: max(STEP_RTOL, DP_FLOOR_FACTOR * f) for k, f in floors.items()}
                 for part, floors in res["floor"].items()}
        worst = lambda errs: {part: max(errs[part].values()) for part in errs}
        over = lambda errs, part: [k for k, v in errs[part].items() if v > limit[part][k]]
        ratio = {part: max((e / limit[part][k], k) for k, e in res["errors"][part].items())
                 for part in limit}
        raised = {part: sorted(((v, k) for k, v in limit[part].items() if v > STEP_RTOL),
                               reverse=True) for part in limit}
        log(f"  (b) {name}, 2 gloo ranks x {DP_STEP_BATCH // 2} rows on cuda:0 against the "
            f"single-process step on all {DP_STEP_BATCH} (cut from 48: time), relative L2 (TF32 "
            f"off), the worst "
            f"tensor a part: {fmt(worst(res['errors']))}; the rounding floor (the "
            f"single-process step, its input x (1 + 2^-23 N(0,1)), the larger of two draws, G, "
            f"D's convs and dense layers on the ranks' row blocks), the worst tensor a part: "
            f"{fmt(worst(res['floor']))}; each tensor's limit max({STEP_RTOL}, "
            f"{DP_FLOOR_FACTOR} x its floor): the largest error / limit a part "
            f"{json.dumps({p: [float(f'{r:.3g}'), k] for p, (r, k) in ratio.items()})}; "
            f"tensors whose limit is above {STEP_RTOL}, of all a part: "
            f"{json.dumps({p: [len(v), len(limit[p])] for p, v in raised.items()})}; "
            f"control, rank 0's rows alone (unreduced gradients), the worst tensor a part: "
            f"{fmt(worst(res['unreduced']))}, G gradients over their limits "
            f"{len(over(res['unreduced'], 'g_grads'))} of {len(limit['g_grads'])}"
            + (f"; control, a per-rank BatchNorm, the worst tensor a part: "
               f"{fmt(worst(res['per_rank_bn']))}, over their limits: D gradients "
               f"{len(over(res['per_rank_bn'], 'd_grads'))} of {len(limit['d_grads'])}, "
               f"stats {len(over(res['per_rank_bn'], 'd_stats'))} of {len(limit['d_stats'])}"
               if key == "gan" else "")
            + f"; states bitwise equal across ranks after {1 + DP_TIMED} steps: "
              f"{res['hash'] == r1[key]['hash']}; {res['ms']:.3f} ms a dp step "
              f"(median of {DP_TIMED}; two ranks time-sharing one card, no speedup figure) "
              f"[{card}]")
        closest = sorted(((e / limit[p][k], p, k) for p in limit
                          for k, e in res["errors"][p].items()), reverse=True)[:DP_SHOWN]
        log(f"  (b) {name}, [error, floor, limit] of the {DP_SHOWN} tensors nearest their "
            f"limits: " + json.dumps({f"{p}.{k}": [float(f"{res[r][p][k]:.3g}") for r in
                                                   ("errors", "floor")]
                                      + [float(f"{limit[p][k]:.3g}")] for _, p, k in closest}))
        failed = {part: over(res["errors"], part) for part in limit}
        if any(failed.values()):
            raise AssertionError(f"the dp {name} disagrees with the single-process step: "
                                 f"{failed}")
        if not over(res["unreduced"], "g_grads"):
            raise AssertionError("the step limits cannot see unreduced gradients")
        control = res["per_rank_bn"]
        if key == "gan" and not (over(control, "d_grads") and over(control, "d_stats")):
            raise AssertionError("the step limits cannot see a per-rank BatchNorm")
        if r0[key]["hash"] != r1[key]["hash"]:
            raise AssertionError(f"the ranks' {name} states differ")
    log(f"  all-reduce of the {w1['n_params']}-float gradient bucket, gloo on CUDA (2 ranks, "
        f"one card): median of 10 {r0['gloo_ms']:.3f} ms [{card}]")
    t0, t1 = r0["trainer"], r1["trainer"]
    log(f"  (c) a two-rank Trainer epoch on phase 8's PNGs ({t0['batch_rows']} rows a rank a "
        f"step): {t0['steps']} steps, {t0['step_ms']:.3f} ms/step, {t0['s']:.1f} s; val PSNR "
        f"{t0['history']['val_psnr']}; rank 0 wrote {t0['files']}, rank 1 wrote "
        f"{t1['files']}; params bitwise equal across ranks: {t0['hash'] == t1['hash']} [{card}]")
    if not (t0["writer"] and not t1["writer"] and t1["files"] is None
            and "final_model.fckpt" in (t0["files"] or []) and t0["hash"] == t1["hash"]
            and t0["history"] == t1["history"] and t0["batch_rows"] == TRAIN_BATCH // 2):
        raise AssertionError("the two-rank Trainer epoch failed its checks")
    log(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return w1["launches"]


# ---------------------------------------------------------------------------
# phase 17: spatial parallelism on the card. (a) SpatialPredictor over
# [cuda:0, cuda:0] in the parent: one thread a row shard, each on its own
# stream; on a [1, 2] data,space grid of two gloo ranks sharing cuda:0 (NCCL
# refuses two ranks on one card), one launch: (b) the stage-1 step, (d) the
# stage-3 GAN step and (e) phase 12's QAT step, each against the step
# alone; (c) the train CLI on data,space through torchrun's environment, and
# (f) the stage-3 YAML chained from (c) and the QAT YAML the same way. The
# machine has one card: no NCCL across cards, no multi-card speed-up.
SP_SHAPE = (1, 256, 256, 3)     # (a)'s LR input, its rows darkening towards the top
SP_F32_ATOL = 1e-4              # (a) f32 over two shards against one
SP_TIMED = 1                    # (a) timed calls a timed configuration
SP_STEP_TIMED = 1               # (b) timed sp steps
SP_GRID = (1, 2)
SP_CLI_FLAGS = ()               # extra train CLI flags of (c) and (f)
SP_STEP_BATCH = 8               # (b) the stage-1 step's batch, cut from 48 (time)
SP_CLI_BATCH = 8                # (c) and (f)'s stage 3: --batch-size, cut from the YAMLs' 48
SP_CLI_TRAIN = 2 * SP_CLI_BATCH  # (c) trains on two steps' worth of phase 8's train PNGs
SP_GAN_BATCH = 16               # (d) stage 3's step, its batch cut from 48 (time)
SP_GAN_TIMED = 0                # (d) timed sp GAN steps after the first (none: the first's ms)
SP_QAT_BATCH = 8                # (f) the QAT YAML's --batch-size (its 64 cut): two steps of PNGs
SP_QAT_STEP_BATCH = 2           # (e) the QAT step's batch, cut from 48: its level records


def png_subset(tmp: Path, name: str, n_train: int, n_val: int) -> Path:
    """``tmp / name``: the first ``n_train`` train PNGs and ``n_val`` val
    pairs of phase 8's set, linked (a CLI run's data cut to its steps)."""
    data = tmp / name
    for split, n in (("train", n_train), ("val", n_val)):
        for sub in ("HR", "LR") if split == "val" else ("HR",):
            (data / split / sub).mkdir(parents=True)
            for src in sorted((tmp / "data" / split / sub).iterdir())[:n]:
                (data / split / sub / src.name).symlink_to(src)
    return data


def sp_serving(dev, card: str, tmp: Path) -> dict:
    """(a): SpatialPredictor over [dev, dev] against [dev] in every dtype;
    returns the group kernel's launches at n = 1 and the numbers.

    Two row shards of the plain trunk must give bitwise the unsharded plain
    forward in bf16, ``int8`` and ``int8_full`` (the halo rows are the
    neighbours' own values, an int8 scale is a max, and the SE mean rounds
    to the same bf16), f32 within SP_F32_ATOL (cuDNN may sum another way at
    another height). The kernel trunk is held to phase 4's limits on the
    unclamped outputs. Planted faults in the sharded forward (a zero halo,
    an SE mean or a dynamic int8 scale over one shard's rows) must fail
    those same checks."""
    import copy

    from facesr_torch.models import blocks
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.ops.quant import dequantize_pytree, quantize_conv_kernels
    from facesr_torch.ops.rcab_group import fused_residual_group
    from facesr_torch.ops.resize import bicubic_up
    from facesr_torch.parallel import spatial
    from facesr_torch.parallel.serving import SpatialPredictor, load_calibration_images

    model = production_model(dev, nonzero_last=True)
    res_scale = model.config.res_scale
    # check_input's ramp: an SE mean or an int8 scale over one shard's rows
    # is not the image's
    ramp = np.linspace(0.1, 1.0, SP_SHAPE[1], dtype=np.float32).reshape(1, -1, 1, 1)
    x = np.random.default_rng(17).random(SP_SHAPE, dtype=np.float32) * ramp
    xt = torch.from_numpy(x).to(dev)
    calib = load_calibration_images(str(tmp / "data" / "val" / "LR"), size=64,
                                    limit=INT8_CALIB_IMAGES)
    cache = str(tmp / "sp_int8_full.fckpt")  # the n = 1 predictor writes it, n = 2 reads it
    one, two = [dev], [dev, dev]
    kw_calib = dict(calibration=calib, quant_cache=cache)

    def serve(mesh, dtype, plain=False, timed=True, **kw):
        """A SpatialPredictor's output on x, its group launches, ms (median
        of SP_TIMED after a warm-up; None untimed), peak GiB and exchanges."""
        kernel_trunk = model.kernel_trunk
        model.kernel_trunk = kernel_trunk and not plain
        try:
            sp = SpatialPredictor(model, mesh=mesh, dtype=dtype, **kw)
            sp(x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = rg.fused_residual_group.launches
            got = sp(x)
            launches = rg.fused_residual_group.launches - before
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ms = host_ms(lambda: sp(x), reps=SP_TIMED) if timed else None
        finally:
            model.kernel_trunk = kernel_trunk
        return {"out": got, "launches": launches, "ms": ms, "peak": peak,
                "exchanges": dict(sp.last_exchanges)}

    runs = {"f32_1": serve(one, None), "f32_2": serve(two, None),
            "bf16_kernel_1": serve(one, torch.bfloat16),
            "bf16_plain_1": serve(one, torch.bfloat16, plain=True, timed=False),
            "bf16_2": serve(two, torch.bfloat16),
            "int8_1": serve(one, "int8"), "int8_plain_1": serve(one, "int8", plain=True,
                                                                timed=False),
            "int8_2": serve(two, "int8"),
            "int8_full_1": serve(one, "int8_full", **kw_calib),
            "int8_full_2": serve(two, "int8_full", **kw_calib),
            "int8_full_dyn_1": serve(one, "int8_full"), "int8_full_dyn_2": serve(two, "int8_full")}
    out = {"launches_one": sum(r["launches"] for k, r in runs.items() if k.endswith("_1"))}

    # the checks: (name, sharded, unsharded, max abs limit; 0 is bitwise)
    checks = [("f32", "f32_2", "f32_1", SP_F32_ATOL),
              ("bf16 (plain trunk)", "bf16_2", "bf16_plain_1", 0.0),
              ("int8 (plain trunk)", "int8_2", "int8_plain_1", 0.0),
              ("int8_full calibrated", "int8_full_2", "int8_full_1", 0.0),
              ("int8_full dynamic", "int8_full_dyn_2", "int8_full_dyn_1", 0.0)]
    limit_of = {c[1]: (c[2], c[3]) for c in checks}

    def held(sharded_key, got):
        """(max abs against the unsharded output, within the check's limit)."""
        want, limit = limit_of[sharded_key]
        d = float(np.abs(got - runs[want]["out"]).max())
        return d, d <= limit

    # the controls: a fault planted in the sharded forward, run as sharded_key
    def zero_halo(self, t, top, bottom):
        n, _, w, c = t.shape
        return t.new_zeros((n, top, w, c)), t.new_zeros((n, bottom, w, c))

    local_mean = (spatial, "mean",
                  lambda t, dim=None: t.mean() if dim is None else t.mean(dim=tuple(dim)))
    controls = [("a zero-filled halo", "f32_2", None, (spatial.ThreadShard, "_halo", zero_halo),
                 {}),
                ("a zero-filled halo", "bf16_2", torch.bfloat16,
                 (spatial.ThreadShard, "_halo", zero_halo), {}),
                ("an SE mean over the shard's rows", "bf16_2", torch.bfloat16, local_mean, {}),
                ("an SE mean over the shard's rows", "int8_full_2", "int8_full", local_mean,
                 kw_calib),
                ("a dynamic int8 scale over the shard's rows", "int8_full_dyn_2", "int8_full",
                 (spatial.ThreadShard, "_max", lambda self, t: t), {})]
    control_rows = []
    for what, key, dtype, (target, attr, fake), kw in controls:
        real = getattr(target, attr)
        setattr(target, attr, fake)
        try:
            got = SpatialPredictor(model, mesh=two, dtype=dtype, **kw)(x)
        finally:
            setattr(target, attr, real)
        control_rows.append((what, key, *held(key, got)))

    # the kernel trunk against the plain one on the unclamped outputs (phase
    # 4's limits), the plain one also over two shards (the predictor's row
    # threads, its forward without the clamp): bf16, and int8 on a copy
    # holding the dequantized weights, as the int8 predictor serves
    def plain_trunk(groups, f):
        return blocks.residual_groups(groups, f, res_scale, 1, remat="none")[0]

    def kernel_trunk(groups, f):
        for g in groups:
            f = fused_residual_group(f, group_weights(g, dev), res_scale)
        return f

    def unclamped(m, trunk, sharded):
        def fn(t):
            with torch.inference_mode():
                return m(t, train=True, dtype=torch.bfloat16, trunk_fn=trunk)
        if not sharded:
            return fn(xt).float().cpu().numpy()
        sp = SpatialPredictor(m, mesh=two, dtype=None)
        sp._forwards = {dev: fn}
        return sp._serve_rows(x, (dev, dev)).astype(np.float32)

    deq = copy.deepcopy(model)
    deq._kernel_weights = None
    with torch.no_grad():
        for name, w in dequantize_pytree(quantize_conv_kernels(model), torch.bfloat16).items():
            deq.get_parameter(f"{name}.weight").copy_(w)
    skip = bicubic_up(xt, 4).float().cpu().numpy()
    kernel_rows = []
    for label, m, plain_key in (("bf16", model, "bf16_plain_1"), ("int8", deq, "int8_plain_1")):
        u1, u2, uk = (unclamped(m, plain_trunk, False), unclamped(m, plain_trunk, True),
                      unclamped(m, kernel_trunk, False))
        if not np.array_equal(np.clip(u1, 0, 1), runs[plain_key]["out"]):
            raise AssertionError(f"the plain n = 1 {label} SpatialPredictor is not the plain "
                                 f"{label} forward clamped")
        resid = np.abs(u1 - skip)
        lim_max, lim_mean = MODEL_RTOL * float(resid.max()), MODEL_RTOL * float(resid.mean())
        dk = np.abs(uk - u2)
        kernel_rows.append((label, float(np.abs(u2 - u1).max()), float(dk.max()),
                            float(dk.mean()), lim_max, lim_mean))
    del deq

    log(f"  (a) SpatialPredictor {SP_SHAPE} LR (noise, rows darkening towards the top) on "
        f"[cuda:0, cuda:0] (two row shards, one thread and stream each) against [cuda:0] "
        f"[{card}]")
    failed = []
    for name, key, want, limit in checks:
        d, ok = held(key, runs[key]["out"])
        log(f"    {name}: {key} vs {want}: max abs {d:.6g} (limit "
            f"{'bitwise' if limit == 0 else limit}) -> {'within' if ok else 'OUTSIDE'}")
        if not ok:
            failed.append(name)
    for label, d2, mx, mean, lim_max, lim_mean in kernel_rows:
        ok = d2 == 0 and mx <= lim_max and mean <= lim_mean
        log(f"    {label} unclamped: two plain shards vs one, max abs {d2:.6g} (bitwise); the "
            f"n = 1 kernel trunk vs two plain shards max abs {mx:.6g} (limit {lim_max:.6g}), "
            f"mean {mean:.6g} (limit {lim_mean:.6g}; phase 4's {MODEL_RTOL} x the plain "
            f"forward's max and mean |out - bicubic|) -> {'within' if ok else 'OUTSIDE'}")
        if not ok:
            failed.append(f"{label} unclamped")
    not_rejected = []
    for what, key, d, ok in control_rows:
        log(f"    control, {what}, as {key}: max abs {d:.6g} against {limit_of[key][0]} -> "
            f"{'NOT rejected' if ok else 'rejected'}")
        if ok:
            not_rejected.append(f"{what} ({key})")
    for name, r in runs.items():
        ms = "untimed" if r["ms"] is None else f"{r['ms']:.3f} ms a call (median of {SP_TIMED}, " \
            "numpy in and out)"
        log(f"    {name}: {ms}, peak {r['peak']:.3f} GiB, group launches {r['launches']}, "
            f"exchanges a forward {json.dumps(r['exchanges'])} [{card}]")
    if failed or not_rejected:
        raise AssertionError(f"SpatialPredictor over two row shards: {failed}; controls not "
                             f"rejected: {not_rejected}")
    per = production_config().num_groups
    kernel_runs = {k: r["launches"] for k, r in runs.items()}
    want = {k: (per if k in ("bf16_kernel_1", "int8_1") else 0) for k in runs}
    if kernel_runs != want:
        raise AssertionError(f"group launches {kernel_runs}, want {want}")
    for name, r in runs.items():
        if r["out"].shape != (1, 1024, 1024, 3) or not np.isfinite(r["out"]).all():
            raise AssertionError(f"{name}: output {r['out'].shape} or not finite")
    out.update(runs={k: {kk: v for kk, v in r.items() if kk != "out"} for k, r in runs.items()})
    # where a sharded bf16 call's time goes: the card's kernels against the wall
    from torch.profiler import ProfilerActivity, profile

    sp = SpatialPredictor(model, mesh=two, dtype=torch.bfloat16)
    sp(x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sp(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    kernels = [e for e in prof.key_averages()
               if getattr(getattr(e, "device_type", None), "name", "") == "CUDA"]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    log(f"    profiler, one bf16 call on two shards: {device_ms:.3f} ms of kernels on the card "
        f"({launches} kernels) in {wall_ms:.3f} ms of wall time (under the profiler): "
        f"{100 * (1 - device_ms / wall_ms):.1f}% of the call the card runs no kernel [{card}]")
    out.update(profile_device_ms=device_ms, profile_wall_ms=wall_ms)
    del model, runs, sp, xt
    torch.cuda.empty_cache()
    return out


def _floor_of(draws) -> dict:
    """The larger of the draws' errors, a tensor (phase 16's rounding floor)."""
    return {part: {k: max(d[part][k] for d in draws) for k in draws[0][part]}
            for part in draws[0]}


def _sp_timed(state, step, rows, n):
    """The median ms of ``n`` more steps (None for none)."""
    if n == 0:
        return None
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, rows)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _disc_forward(template, hr, mesh=None, noise_seed=None) -> dict:
    """One train-mode forward of a fresh copy of ``template`` (stage 3's
    discriminator) on ``hr`` (this rank's image rows under ``mesh``): its
    logits and updated running stats on the host, as a `_step_record`-like
    record. ``noise_seed``: the input times (1 + 2^-23 N(0, 1)) first."""
    import copy

    from facesr_torch.parallel import spatial

    if noise_seed is not None:
        gen = torch.Generator().manual_seed(noise_seed)
        hr = hr * (1 + DP_FLOOR_NOISE * torch.randn(hr.shape, generator=gen).to(hr.device))
    disc = copy.deepcopy(template)
    shard = None if mesh is None else mesh.row_shard()
    with torch.no_grad(), spatial.rows(shard):
        logits = disc(hr if shard is None else shard.slab(hr), train=True, mesh=mesh)
    return {"d_logits": {"logits": logits.cpu()},
            "d_stats": {k: v.detach().cpu().clone() for k, v in disc.named_buffers()}}


@contextlib.contextmanager
def _sp_fault(name):
    """A fault planted in the sharded path of (d) or (e): a zero stride-2
    halo (the one row a stride-2 conv borrows from above, still in the
    exchange's graph so every rank runs the same collectives), D's
    BatchNorm over the shard's rows alone, gradients summed over `space`,
    or a per-shard fake-quant activation scale."""
    from facesr_torch.models import discriminator as dmod
    from facesr_torch.ops import conv as conv_ops
    from facesr_torch.parallel import spatial
    from facesr_torch.training import steps

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "zero_stride2_halo":
        halo = spatial.RankShard._halo

        def zero_above(self, x, top, bottom):
            above, below = halo(self, x, top, bottom)
            return (above * 0 if bottom == 0 else above), below

        patch(spatial.RankShard, "_halo", zero_above)
    elif name == "per_shard_bn":
        bn_sum = dmod._bn_sum
        patch(dmod, "_bn_sum", lambda train, mesh, shard:
              None if shard is not None else bn_sum(train, mesh, shard))
    elif name == "wrong_factor":
        reduced = steps._reduced
        patch(steps, "_reduced", lambda g, m: [t * m.axis_size("space") for t in reduced(g, m)])
    elif name == "per_shard_scale":
        scale = conv_ops.fake_quant_scale
        patch(conv_ops, "fake_quant_scale", lambda t, static=None, shard=None: scale(t, static))
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def _sp_step_case(mesh, build, hr, gan: bool, controls, timed: int) -> dict:
    """One sp step case on a rank of the grid: rank 0's single-process step
    on the whole batch and its rounding floor (phase 16's two draws, the
    model's forward and D's convs and dense layers on two row blocks); the
    grid's step, its exchanges, peak and ms, the state's hash after
    ``timed`` more steps; and each planted control's step."""
    from facesr_torch.cli.step_numerics import RecordingAdamW
    from facesr_torch.parallel.mesh import shard_batch

    dev, out = mesh.device, {}
    rows = shard_batch(hr, mesh)  # the data axis is 1: every rank holds the whole batch
    if mesh.rank == 0:
        state, step, _ = build(dev, opt_cls=RecordingAdamW)
        want = _step_record(state, step, hr, gan)
        del state, step
        floor = _floor_of([_tensor_errors(_rounding_floor(build, dev, hr, gan, 2, seed), want)
                           for seed in DP_FLOOR_SEEDS])
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step, _ = build(dev, mesh=mesh, opt_cls=RecordingAdamW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = _step_record(state, step, rows, gan)
    out["first_ms"] = (time.perf_counter() - t0) * 1e3  # the host copies of the record too
    out["exchanges"] = dict(step.row_shard.counts)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["ms"] = _sp_timed(state, step, rows, timed)
    tensors = list(state.model.parameters()) + list(state.opt_state["mu"].values())
    if gan:
        tensors += list(state.disc.parameters()) + list(state.disc.buffers())
    out["hash"] = _state_hash(tensors)
    del state, step
    faults = {}
    for name in controls:
        with _sp_fault(name):
            state, step, _ = build(dev, mesh=mesh, opt_cls=RecordingAdamW)
            faults[name] = _step_record(state, step, rows, gan)
            del state, step
    if mesh.rank == 0:
        out.update(errors=_tensor_errors(got, want), floor=floor,
                   controls={k: _tensor_errors(v, want) for k, v in faults.items()})
    torch.cuda.empty_cache()
    return out


def _sp_qat_case(mesh, tmp: Path) -> dict:
    """(e) on a rank of the grid: phase 12's QAT step at SP_QAT_STEP_BATCH,
    every run's fake-quant levels pinned at ties to rank 0's single-process
    step (`step_numerics.fake_quant_levels`; the grid's runs cut to their
    rows by `row_shard_levels`), so that a level one run rounds the other
    way does not spread through the step: the single-process step and its
    floor (two draws of its input times (1 + 2^-23 N(0, 1)), pinned
    alike), the grid's step and the per-shard-scale control, each with its
    ties taken and its levels off a tie counted. The record goes from rank
    0 to the other through a file."""
    import functools

    import torch.distributed as dist

    from facesr_torch.cli.step_numerics import (RecordingAdamW, fake_quant_levels,
                                                row_shard_levels)
    from facesr_torch.parallel.mesh import shard_batch

    dev, out = mesh.device, {}
    build = functools.partial(production_step_fn, qat=True)
    hr = smooth_hr(SP_QAT_STEP_BATCH, TRAIN_HR, seed=7, dev=dev)
    path = tmp / "sp_qat_levels.pt"
    pins = lambda pin: {k: pin[k] for k in ("ties", "off_tie")} | {  # noqa: E731
        "levels": sum(lv.numel() for lv in pin["levels"])}
    if mesh.rank == 0:
        state, step, _ = build(dev, opt_cls=RecordingAdamW)
        with fake_quant_levels() as rec:
            want = _step_record(state, step, hr, False)
        del state, step
        record = {"weights": [t.to(torch.int8) for t in rec["weights"]],
                  "levels": [t.to(torch.int8) for t in rec["levels"]],
                  "outputs": rec["outputs"]}
        del rec
        torch.save(record, path)
        draws = []
        for seed in DP_FLOOR_SEEDS:
            state, step, _ = build(dev, opt_cls=RecordingAdamW)
            noise = torch.randn(hr.shape, generator=torch.Generator().manual_seed(seed)).to(dev)
            with fake_quant_levels(lambda i, w: (record["weights"][i], record["levels"][i],
                                                 record["outputs"][i])):
                draws.append(_tensor_errors(_step_record(
                    state, step, hr * (1 + DP_FLOOR_NOISE * noise), False), want))
            del state, step
        floor = _floor_of(draws)
        torch.cuda.empty_cache()
    dist.barrier(group=mesh.group)  # rank 0's record is written
    if mesh.rank != 0:
        record = torch.load(path)
    rows = shard_batch(hr, mesh)
    runs = {}
    for name in ("right", "per_shard_scale"):
        with _sp_fault(name) if name != "right" else contextlib.nullcontext():
            torch.cuda.reset_peak_memory_stats()
            state, step, _ = build(dev, mesh=mesh, opt_cls=RecordingAdamW)
            with fake_quant_levels(row_shard_levels(record, step.row_shard)) as pin:
                runs[name] = _step_record(state, step, rows, False)
            out[name] = pins(pin)
            if name == "right":
                out.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                           exchanges=dict(step.row_shard.counts),
                           hash=_state_hash(list(state.model.parameters())
                                            + list(state.opt_state["mu"].values())))
            del state, step, pin
    if mesh.rank == 0:
        out.update(errors=_tensor_errors(runs["right"], want), floor=floor,
                   control=_tensor_errors(runs["per_shard_scale"], want))
    del record, runs
    torch.cuda.empty_cache()
    return out


def sp_step_rank(mesh, tmp: str, card: str) -> dict:
    """(b), (d) and (e) on one of two gloo ranks of the [1, 2] grid sharing
    cuda:0."""
    from facesr_torch.models.discriminator import create_discriminator

    dev, rank = mesh.device, mesh.rank
    out = {"rank": rank, "coords": (mesh.axis_index("data"), mesh.axis_index("space")),
           "seconds": {}}
    hr = smooth_hr(SP_STEP_BATCH, TRAIN_HR, seed=7, dev=dev)
    # (b) the stage-1 step, and the control: gradients summed over `space`
    t0 = time.perf_counter()
    b = _sp_step_case(mesh, production_step_fn, hr, False, ("wrong_factor",), SP_STEP_TIMED)
    out.update(b, wrong_factor=b.get("controls", {}).get("wrong_factor"))
    out["seconds"]["(b)"], t0 = time.perf_counter() - t0, time.perf_counter()
    # (d) stage 3's GAN step at SP_GAN_BATCH; the D forward alone for the
    # halo and BatchNorm controls
    hr_g = smooth_hr(SP_GAN_BATCH, GAN_HR, seed=8, dev=dev)
    gan = _sp_step_case(mesh, gan_step_fn, hr_g, True, ("wrong_factor",), SP_GAN_TIMED)
    disc = create_discriminator(input_size=GAN_HR, base_channels=GAN_D_BASE, use_bn=True,
                                seed=0, device=dev)  # gan_step_fn's
    if rank == 0:
        d_want = _disc_forward(disc, hr_g)
        gan["d_floor"] = _floor_of([_tensor_errors(_disc_forward(disc, hr_g, noise_seed=seed),
                                                   d_want) for seed in DP_FLOOR_SEEDS])
    d_got = {"right": _disc_forward(disc, hr_g, mesh)}
    for name in ("zero_stride2_halo", "per_shard_bn"):
        with _sp_fault(name):
            d_got[name] = _disc_forward(disc, hr_g, mesh)
    del disc
    if rank == 0:
        gan["d_errors"] = {k: _tensor_errors(v, d_want) for k, v in d_got.items()}
    gan["d_logits_hash"] = _state_hash([d_got["right"]["d_logits"]["logits"]])
    out["gan"] = gan
    out["seconds"]["(d)"], t0 = time.perf_counter() - t0, time.perf_counter()
    # (e) phase 12's QAT step (phase 7's, fake-quantized), and the control:
    # a per-shard activation scale
    out["qat"] = _sp_qat_case(mesh, Path(tmp))
    out["seconds"]["(e)"] = time.perf_counter() - t0
    return out


def _sp_limits(case) -> dict:
    """Each tensor's limit of a sp case: max(STEP_RTOL, DP_FLOOR_FACTOR x
    its rounding floor)."""
    return {part: {k: max(STEP_RTOL, DP_FLOOR_FACTOR * f) for k, f in floors.items()}
            for part, floors in case["floor"].items()}


def _over(errs, limit) -> dict:
    """The tensors of each part past their limits."""
    return {part: [k for k, v in errs[part].items() if v > limit[part][k]] for part in limit}


def _worst(errs) -> dict:
    return {part: float(f"{max(errs[part].values()):.3g}") for part in errs}


def _ratios(errs, limit) -> dict:
    """The largest error / limit a part, and its tensor."""
    return {part: [float(f"{r:.3g}"), k] for part, (r, k) in
            ((p, max((e / limit[p][k], k) for k, e in errs[p].items())) for p in limit)}


def sp_gan_report(g0, g1, card: str) -> None:
    """(d): the sp GAN step's numbers and checks (rank 0's comparisons, both
    ranks' hashes)."""
    limit = _sp_limits(g0)
    failed = _over(g0["errors"], limit)
    wrong = _over(g0["controls"]["wrong_factor"], limit)
    d_limit = {part: {k: max(STEP_RTOL, DP_FLOOR_FACTOR * f) for k, f in floors.items()}
               for part, floors in g0["d_floor"].items()}
    d_over = {k: _over(v, d_limit) for k, v in g0["d_errors"].items()}
    log(f"  (d) the stage-3 GAN step (G 6x10x64, D at {GAN_HR} with {GAN_D_BASE} base channels "
        f"and BatchNorm, f32, batch {SP_GAN_BATCH} (cut from 48: time), HR {GAN_HR}, L1 0.01 + "
        f"VGG19 conv3_4 + 0.005 vanilla GAN) on the {list(SP_GRID)} grid against the "
        f"single-process step, relative L2 (TF32 off), the worst tensor a part: "
        f"{json.dumps(_worst(g0['errors']))}; the rounding floor, the worst tensor a part: "
        f"{json.dumps(_worst(g0['floor']))}; each tensor's limit max({STEP_RTOL}, "
        f"{DP_FLOOR_FACTOR} x its floor): the largest error / limit a part "
        f"{json.dumps(_ratios(g0['errors'], limit))}; control, gradients summed over space: "
        f"G gradients over their limits {len(wrong['g_grads'])} of {len(limit['g_grads'])}, "
        f"D's {len(wrong['d_grads'])} of {len(limit['d_grads'])}; states bitwise equal across "
        f"ranks after {1 + SP_GAN_TIMED} step(s): {g0['hash'] == g1['hash']}; "
        f"{g0['first_ms']:.3f} ms the first sp GAN step (with its record's host copies; "
        f"two ranks time-sharing one card); a rank's peak {g0['peak_gib']:.3f} GiB; a rank's exchanges in "
        f"the first step (G's forward and remat recompute, the VGG sweeps, D's three forwards; "
        f"D's BatchNorm sums are all-reduces over the grid's group beside these) "
        f"{json.dumps(g0['exchanges'])} [{card}]")
    log(f"  (d) D's train-mode forward alone (fresh, batch {SP_GAN_BATCH}) on the grid against "
        f"one process, relative L2 of the logits and the updated running stats, the worst "
        f"tensor a part (limit max({STEP_RTOL}, {DP_FLOOR_FACTOR} x the floor {json.dumps(_worst(g0['d_floor']))})): "
        + "; ".join(f"{k} {json.dumps(_worst(v))}" for k, v in g0["d_errors"].items())
        + f"; logits bitwise across ranks: {g0['d_logits_hash'] == g1['d_logits_hash']} [{card}]")
    if any(failed.values()) or any(d_over["right"].values()):
        raise AssertionError(f"the sp GAN step disagrees with the single-process step: "
                             f"{failed}, D's forward {d_over['right']}")
    if not (wrong["g_grads"] and wrong["d_grads"]):
        raise AssertionError("the GAN step limits cannot see gradients reduced with the wrong "
                             "factor over space")
    for name in ("zero_stride2_halo", "per_shard_bn"):
        if not any(d_over[name].values()):
            raise AssertionError(f"D's forward limits cannot see the planted {name}")
    if g0["hash"] != g1["hash"] or g0["d_logits_hash"] != g1["d_logits_hash"]:
        raise AssertionError("the sp GAN ranks' states differ")


def sp_qat_report(q0, q1, card: str) -> None:
    """(e): the sp QAT step's numbers and checks."""
    limit = _sp_limits(q0)
    failed = _over(q0["errors"], limit)
    control = _over(q0["control"], limit)
    right, fault = q0["right"], q0["per_shard_scale"]
    log(f"  (e) phase 12's QAT step (phase 7's step with every int8 site fake-quantized, "
        f"dynamic scales: the image's max over both shards; batch {SP_QAT_STEP_BATCH}, cut from "
        f"{TRAIN_BATCH} for its level records, HR {TRAIN_HR}) on the {list(SP_GRID)} grid, "
        f"its fake-quant levels pinned at ties to the single-process step's: "
        f"{right['ties']} of {right['levels']} levels and signs taken at a tie on rank 0, "
        f"{right['off_tie']} off a tie; against the single-process step, relative L2, the "
        f"worst tensor a part: {json.dumps(_worst(q0['errors']))}; the floor (two input draws, "
        f"pinned alike), the worst tensor a part: {json.dumps(_worst(q0['floor']))}; the "
        f"largest error / limit a part {json.dumps(_ratios(q0['errors'], limit))}; control, a "
        f"per-shard activation scale: {fault['off_tie']} levels off a tie, G gradients over "
        f"their limits {len(control['g_grads'])} of {len(limit['g_grads'])}; states bitwise "
        f"equal across ranks: {q0['hash'] == q1['hash']}; a rank's peak {q0['peak_gib']:.3f} "
        f"GiB; a rank's exchanges in the step {json.dumps(q0['exchanges'])} [{card}]")
    if right["off_tie"] or q1["right"]["off_tie"] or right["ties"] > 1e-4 * right["levels"]:
        raise AssertionError(f"the sp QAT step's levels leave the single process's: {right}, "
                             f"rank 1 {q1['right']}")
    if any(failed.values()):
        raise AssertionError(f"the sp QAT step disagrees with the single-process step: {failed}")
    if not (fault["off_tie"] or control["g_grads"]):
        raise AssertionError("the QAT step checks cannot see a per-shard activation scale")
    if q0["hash"] != q1["hash"]:
        raise AssertionError("the sp QAT ranks' states differ")


def _sp_cli(name: str, argv, tmp: Path, card: str):
    """The train CLI through torchrun's environment on the data,space grid
    (2 ranks on cuda:0 over gloo), in ``tmp / name``: (exit codes, seconds,
    each rank's log)."""
    from facesr_torch.parallel.launch import run_cli_ranks

    run_dir = tmp / name
    run_dir.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    codes = run_cli_ranks("facesr_torch.cli.train",
                          [*argv, "--epochs", "1", "--mesh-axes", "data,space", "--mesh-shape",
                           ",".join(map(str, SP_GRID)), "--dist-backend", "gloo", *SP_CLI_FLAGS],
                          2, timeout=DP_TIMEOUT, log_dir=str(run_dir), cwd=str(run_dir),
                          env={"PYTHONPATH": str(REPO)})
    return codes, time.perf_counter() - t0, [(run_dir / f"rank{r}.log").read_text()
                                             for r in range(2)]


def _cli_checked(what: str, codes, logs, files, extra_ok=True) -> list:
    """The val PSNRs of a CLI run on the grid, once both ranks exited 0,
    found their grid place and rank 0 wrote final_model.fckpt."""
    import re

    psnr = [float(v) for v in re.findall(r"Val PSNR:\s+([-\d.]+) dB", logs[0])]
    if codes != [0, 0] or "final_model.fckpt" not in files or not psnr or not extra_ok \
            or not all(math.isfinite(v) for v in psnr) \
            or not all(f"at (0, {r}) of the data,space grid" in logs[r] for r in range(2)):
        raise AssertionError(f"{what}: {codes}, " + " | ".join(t[-1500:] for t in logs))
    return psnr


def sp_cli_chain(tmp: Path, stage1_dir: Path, data: Path, card: str) -> None:
    """(f): stage 3 chained from (c)'s final model, and the QAT YAML, each
    through the CLI on the grid for one epoch of two steps, the two runs
    side by side (four ranks on cuda:0)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    run3 = tmp / "sp_cli_gan"
    (run3 / "checkpoints").mkdir(parents=True)
    # stage 3's YAML starts from ./checkpoints/best_model.fckpt: (c)'s final model
    shutil.copy(stage1_dir / "checkpoints" / "final_model.fckpt",
                run3 / "checkpoints" / "best_model.fckpt")
    qat_data = png_subset(tmp, "sp_qat_data", 2 * SP_QAT_BATCH, SP_QAT_BATCH)  # two steps
    ckpt = tmp / "sp_qat_checkpoints"
    yaml = tmp / "sp_stage1_qat_ft.yaml"
    yaml.write_text(QAT_YAML.read_text().replace("save_dir: /tmp/rehearsal/ckpt_s1_qat",
                                                 f"save_dir: {ckpt}"))
    cache = tmp / "quant" / "int8.production.fckpt"  # phase 12's calibrated sites, when there
    pin = ["--qat-scales", str(cache)] if cache.exists() else []
    with ThreadPoolExecutor(2) as pool:
        gan = pool.submit(_sp_cli, "sp_cli_gan", ["--config", str(STAGE3_YAML), "--data-root",
                                                  str(data), "--batch-size", str(SP_CLI_BATCH)],
                          tmp, card)
        qat = pool.submit(_sp_cli, "sp_cli_qat", ["--config", str(yaml), "--data-root",
                                                  str(qat_data), "--batch-size",
                                                  str(SP_QAT_BATCH), *pin], tmp, card)
        runs = {"stage 3": gan.result(), "QAT": qat.result()}
    for what, keys in (("stage 3", ("Val PSNR", "ms/step", "GAN:", "Loaded")),
                       ("QAT", ("Val PSNR", "ms/step", "QAT"))):
        for r, text in enumerate(runs[what][2]):
            for line in text.splitlines():
                if any(k in line for k in keys):
                    log(f"  (f) {what} rank {r}: {line.strip()}")
    codes, secs, logs = runs["stage 3"]
    files = sorted(p.name for p in (run3 / "checkpoints").iterdir())
    psnr = _cli_checked("the data,space stage-3 CLI run", codes, logs, files,
                        all("GAN:" in t for t in logs))
    log(f"  (f) the stage-3 YAML through the train CLI on data,space {list(SP_GRID)} (2 ranks on "
        f"cuda:0 over gloo, beside the QAT run's 2), chained from (c)'s final_model.fckpt, "
        f"--batch-size {SP_CLI_BATCH}, 1 epoch on {SP_CLI_TRAIN} of phase 8's train PNGs: exit "
        f"codes {codes}, {secs:.1f} s "
        f"with set-up, val PSNR {psnr}; rank 0 wrote {files} [{card}]")
    codes, secs, logs = runs["QAT"]
    files = sorted(p.name for p in ckpt.iterdir()) if ckpt.exists() else []
    psnr = _cli_checked("the data,space QAT CLI run", codes, logs, files)
    log(f"  (f) {QAT_YAML.name} through the train CLI on data,space {list(SP_GRID)}"
        f"{' with --qat-scales (phase 12' + chr(39) + 's cache)' if pin else ''}, beside the "
        f"stage-3 run, --batch-size {SP_QAT_BATCH}, 1 epoch on {2 * SP_QAT_BATCH} of phase 8's "
        f"train PNGs: exit codes "
        f"{codes}, {secs:.1f} s with set-up, val PSNR {psnr}; rank 0 wrote {files} [{card}]")


def sp_phase(card: str, tmp: Path) -> int:
    """Phase 17: spatial parallelism on the card; returns the group kernel's
    launches on its n = 1 serving calls."""
    import re

    from facesr_torch.parallel.launch import run_cli_ranks, run_ranks

    log(f"== 17. spatial parallelism (image rows over a mesh; the card's machine has one card, "
        f"so two row shards share cuda:0: threads for serving, two gloo ranks for training) "
        f"[{card}]")
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    serving = sp_serving(dev, card, tmp)
    parts = {"(a)": time.perf_counter() - t_phase}

    t0 = time.perf_counter()
    r0, r1 = run_ranks(sp_step_rank, 2, args=(str(tmp), card), devices=[DP_DEVICE] * 2,
                       backend="gloo", timeout=DP_TIMEOUT, axis_names=("data", "space"),
                       shape=SP_GRID)
    parts["(b), (d), (e): one launch of two ranks"] = time.perf_counter() - t0
    parts.update({f"rank 0's {k}": v for k, v in r0["seconds"].items()})
    limit = {part: {k: max(STEP_RTOL, DP_FLOOR_FACTOR * f) for k, f in floors.items()}
             for part, floors in r0["floor"].items()}
    over = lambda errs, part: [k for k, v in errs[part].items() if v > limit[part][k]]
    worst = lambda errs: {part: float(f"{max(errs[part].values()):.3g}") for part in errs}
    ratio = {part: max((e / limit[part][k], k) for k, e in r0["errors"][part].items())
             for part in limit}
    log(f"  (b) the stage-1 step (6x10x64 f32, batch {SP_STEP_BATCH} (cut from 48: time), HR "
        f"{TRAIN_HR}, L1 + VGG19 "
        f"conv3_4) on a data,space {list(SP_GRID)} grid, 2 gloo ranks x {TRAIN_HR // 2} image "
        f"rows on cuda:0, against the single-process step, relative L2 (TF32 off), the worst "
        f"tensor a part: {json.dumps(worst(r0['errors']))}; phase 16's rounding floor, the worst "
        f"tensor a part: {json.dumps(worst(r0['floor']))}; each tensor's limit max({STEP_RTOL}, "
        f"{DP_FLOOR_FACTOR} x its floor): the largest error / limit a part "
        f"{json.dumps({p: [float(f'{r:.3g}'), k] for p, (r, k) in ratio.items()})}; control, "
        f"gradients summed over space, the worst tensor a part: "
        f"{json.dumps(worst(r0['wrong_factor']))}, G gradients over their limits "
        f"{len(over(r0['wrong_factor'], 'g_grads'))} of {len(limit['g_grads'])}; states bitwise "
        f"equal across ranks after {1 + SP_STEP_TIMED} steps: {r0['hash'] == r1['hash']}; "
        f"{r0['ms']:.3f} ms a sp step (median of {SP_STEP_TIMED}; two ranks time-sharing one "
        f"card); a rank's peak {r0['peak_gib']:.3f} GiB; a rank's exchanges in the first step "
        f"(forward, remat recompute and the VGG sweeps) {json.dumps(r0['exchanges'])} [{card}]")
    failed = {part: over(r0["errors"], part) for part in limit}
    if any(failed.values()):
        raise AssertionError(f"the sp step disagrees with the single-process step: {failed}")
    if not over(r0["wrong_factor"], "g_grads"):
        raise AssertionError("the step limits cannot see gradients reduced with the wrong "
                             "factor over space")
    if r0["hash"] != r1["hash"] or (r0["coords"], r1["coords"]) != ((0, 0), (0, 1)):
        raise AssertionError("the sp ranks' states differ")
    sp_gan_report(r0["gan"], r1["gan"], card)
    sp_qat_report(r0["qat"], r1["qat"], card)

    run_dir = tmp / "sp_cli"
    run_dir.mkdir()
    data = png_subset(tmp, "sp_cli_data", SP_CLI_TRAIN, SP_CLI_BATCH)  # two steps, one val batch
    t0 = time.perf_counter()
    codes = run_cli_ranks("facesr_torch.cli.train",
                          ["--config", str(STAGE1_YAML), "--data-root", str(data),
                           "--batch-size", str(SP_CLI_BATCH), "--epochs", "1", "--print-memory",
                           "--mesh-axes", "data,space",
                           "--mesh-shape", ",".join(map(str, SP_GRID)), "--dist-backend", "gloo",
                           *SP_CLI_FLAGS],
                          2, timeout=DP_TIMEOUT, log_dir=str(run_dir), cwd=str(run_dir),
                          env={"PYTHONPATH": str(REPO)})
    cli_s = time.perf_counter() - t0
    logs = [(run_dir / f"rank{r}.log").read_text() for r in range(2)]
    files = sorted(p.name for p in (run_dir / "checkpoints").iterdir()) \
        if (run_dir / "checkpoints").exists() else []
    for r, text in enumerate(logs):
        for line in text.splitlines():
            if "MB (" in line or "data,space grid" in line or "Batch size" in line \
                    or "Val PSNR" in line or "ms/step" in line:
                log(f"  (c) rank {r}: {line.strip()}")
    psnr = [float(v) for v in re.findall(r"Val PSNR:\s+([-\d.]+) dB", logs[0])]
    log(f"  (c) the stage-1 YAML through the train CLI on data,space {list(SP_GRID)} (torchrun's "
        f"environment, 2 ranks on cuda:0 over gloo), --print-memory, --batch-size "
        f"{SP_CLI_BATCH}, 1 epoch on {SP_CLI_TRAIN} of "
        f"phase 8's train PNGs and {SP_CLI_BATCH} of its val pairs: "
        f"exit codes {codes}, {cli_s:.1f} s with set-up; rank 0 wrote {files} [{card}]")
    if codes != [0, 0] or "final_model.fckpt" not in files or not psnr \
            or not all(math.isfinite(v) for v in psnr) \
            or not all(f"at (0, {r}) of the data,space grid" in logs[r] for r in range(2)) \
            or not all("device memory" in t for t in logs):
        raise AssertionError(f"the data,space train CLI run: {codes}, "
                             + " | ".join(t[-1500:] for t in logs))
    parts["(c)"] = cli_s
    t0 = time.perf_counter()
    sp_cli_chain(tmp, run_dir, data, card)
    parts["(f)"] = time.perf_counter() - t0
    log(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + f" [{card}]")
    return serving["launches_one"]


# ---------------------------------------------------------------------------
# phase 18: tensor parallelism on the card. On a [1, 2] data,model grid of
# two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card), one
# launch: (a) the stage-1 step, (b) stage 3's GAN step and (c) phase 12's
# QAT step, each against the step alone; then (d) the stage-1 YAML through
# the train CLI on data,model, its final checkpoint resumed by one process.
# The machine has one card: no NCCL across cards, no multi-card speed-up.
TP_GRID = (1, 2)
# every split conv's output goes through gloo on the host as a full-size
# buffer (and its input gradient back): the batches are cut for time
TP_BATCH = 8                    # (a) the stage-1 step's batch, cut from 48
TP_GAN_BATCH = 8                # (b) stage 3's step, cut from 48
TP_QAT_BATCH, TP_QAT_HR = 2, 128  # (c) the QAT step, cut from 48 at 256: its level records
TP_CLI_BATCH = 4                # (d) --batch-size: two steps' worth of phase 8's train PNGs
TP_CLI_FLAGS = ()               # extra train CLI flags of (d)
TP_CONTROLS = {False: ("gather_backward_sum", "clip_without_model_sum"),
               True: ("reversed_d_gather",)}
# the floor's draws: phase 16's two input-noise seeds and the input as it is
# (None), each with every conv in output-channel halves (`_channel_halves`).
# Adam's first step moves an element by ~lr x sign(g), so an element whose
# gradient is at rounding level flips by 2 lr in any draw; the noise-free
# draw sums as the tp ranks' convs do and finds the flips their order makes
TP_FLOOR_DRAWS = DP_FLOOR_SEEDS + (None,)
# the parameters each record's gradients update (Adam's first step)
ADAM_PARTS = {"g_params": "g_grads", "d_params": "d_grads"}


@contextlib.contextmanager
def _tp_fault(name):
    """A fault planted in the tp path: a gather whose backward sums over
    `model` (every gradient upstream of a split conv t times too large), a
    clip whose global norm skips the `model` sum, or D's convs gathering
    the ranks' channel blocks in reversed order."""
    import torch.distributed as dist

    from facesr_torch.models import discriminator as dmod
    from facesr_torch.parallel import tensor
    from facesr_torch.training import optim

    if name == "gather_backward_sum":
        backward = tensor._Gather.backward
        owner, attr, real = tensor._Gather, "backward", staticmethod(backward)

        def summed(ctx, grad):
            g = backward(ctx, grad)[0].clone()
            dist.all_reduce(g, group=ctx.shard.group)
            return g, None, None

        value = staticmethod(summed)
    elif name == "clip_without_model_sum":
        owner, attr, real = optim, "global_norm", optim.global_norm
        value = lambda grads, params, shard=None: real(grads, params, None)  # noqa: E731
    elif name == "reversed_d_gather":
        owner, attr, real = dmod, "conv2d", dmod.conv2d

        def value(x, w, b=None, padding=1, dtype=None, groups=1, stride=1):
            tp = tensor.current()
            if tp is None or not tensor.is_split(w):
                return real(x, w, b, padding=padding, dtype=dtype, groups=groups, stride=stride)
            with tensor.split(None):
                y = real(tp.copy(x), w, b, padding=padding, dtype=dtype, stride=stride)
            return torch.cat(tp.gather(y).split(y.shape[-1], dim=-1)[::-1], dim=-1)
    else:
        raise ValueError(name)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, real)


@contextlib.contextmanager
def _channel_halves():
    """Every conv whose output channels divide by 2 computed as its two
    halves, concatenated: the same math with the cuDNN algorithms of the
    tp ranks' convs (phase 16's row blocks, for channels), a draw of the
    rounding floor."""
    import torch.nn.functional as F

    real = F.conv2d

    def halves(x, w, *args, **kwargs):
        o = w.shape[0]
        if o % 2 or kwargs.get("groups", 1) != 1:
            return real(x, w, *args, **kwargs)
        return torch.cat([real(x, w[:o // 2], *args, **kwargs),
                          real(x, w[o // 2:], *args, **kwargs)], dim=1)

    F.conv2d = halves
    try:
        yield
    finally:
        F.conv2d = real


def _tp_built(build, dev, mesh, **kw):
    """``build``'s (state, step), the state split over the grid's `model`
    group (`parallel.tensor.shard_state`), and its placement."""
    from facesr_torch.cli.step_numerics import RecordingAdamW
    from facesr_torch.parallel import tensor
    from facesr_torch.parallel.mesh import tp_param_shardings

    state, step, _ = build(dev, mesh=mesh, opt_cls=RecordingAdamW, **kw)
    specs = tp_param_shardings(state, mesh)
    tensor.shard_state(state, mesh.model_shard(), specs)
    return state, step, specs


def _tp_record(state, step, hr, gan, mesh, specs):
    """`_step_record` of a tp step with G's first moments: the gradients come
    whole from `RecordingAdamW`; the parameters, moments and D's stats are
    gathered whole."""
    from facesr_torch.parallel import tensor

    rec = _step_record(state, step, hr, gan)
    shard = mesh.model_shard()
    tensor.unshard_state(state, shard, specs)
    try:
        rec["g_params"] = {k: v.detach().cpu().clone() for k, v in state.model.named_parameters()}
        rec["g_mu"] = {k: v.detach().cpu().clone() for k, v in state.opt_state["mu"].items()}
        if gan:
            rec["d_params"] = {k: v.detach().cpu().clone()
                               for k, v in state.disc.named_parameters()}
            rec["d_stats"] = {k: v.detach().cpu().clone() for k, v in state.disc.named_buffers()}
    finally:
        tensor.shard_state(state, shard, specs)
    return rec


def _tp_hash(state, mesh, specs) -> str:
    """The hash of the whole state (gathered: a collective)."""
    from facesr_torch.parallel import tensor

    shard = mesh.model_shard()
    tensor.unshard_state(state, shard, specs)
    try:
        return _state_hash([t for _, t in tensor.state_tensors(state)])
    finally:
        tensor.shard_state(state, shard, specs)


def _state_bytes(state) -> int:
    """The bytes of a step state's tensors (a rank's slices under tp)."""
    from facesr_torch.parallel import tensor

    return sum(t.numel() * t.element_size() for _, t in tensor.state_tensors(state))


def _adam_ties(want, draws) -> dict:
    """Per parameter tensor, the elements whose gradient lies within
    DP_FLOOR_FACTOR x its rounding noise (the largest |draw - want| over the
    floor's draws) of zero. Adam's first step moves them by ~lr x sign(g),
    a sign that rounding decides: such an element is a tie, as a
    fake-quant level at a boundary is (phase 17 (e))."""
    ties = {}
    for part, grads in ADAM_PARTS.items():
        if part in want:
            ties[part] = {k: g.abs() <= DP_FLOOR_FACTOR * torch.stack(
                              [(d[grads][k] - g).abs() for d in draws]).amax(0)
                          for k, g in want[grads].items()}
    return ties


def _errors_off_ties(got, want, ties) -> dict:
    """`_tensor_errors`, the parameters' over the elements off their ties."""
    from facesr_torch.cli.step_numerics import rel_l2

    errs = _tensor_errors(got, want)
    for part, masks in ties.items():
        for k, tie in masks.items():
            off = ~tie
            errs[part][k] = rel_l2(got[part][k][off], want[part][k][off]) if off.any() else 0.0
    return errs


def _timed(step, times):
    """``step`` that appends each call's ms (ending in a synchronize) to
    ``times``."""
    def run(state, hr):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, hr)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    run.optimizers, run.model_shard = step.optimizers, step.model_shard
    return run


def _tp_case(mesh, build, hr, gan: bool) -> dict:
    """One tp step case on a rank of the grid: on rank 0 the single-process
    step (its record, ms, peak and state bytes) and its rounding floor
    (`TP_FLOOR_DRAWS`); each planted control's tp step, then the right tp
    step, warm (its record, ms, exchanges, peak, state bytes and the
    gathered state's hash). The parameters are compared off their Adam
    ties (`_adam_ties`)."""
    from facesr_torch.cli.step_numerics import RecordingAdamW

    dev, out = mesh.device, {}
    if mesh.rank == 0:
        torch.cuda.reset_peak_memory_stats()
        state, step, _ = build(dev, opt_cls=RecordingAdamW)
        times = []
        want = _step_record(state, _timed(step, times), hr, gan, moments=True)
        out["single"] = {"first_ms": times[0], "ms": _sp_timed(state, step, hr, 1),
                         "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                         "state_bytes": _state_bytes(state)}
        del state, step
        with _channel_halves():
            draws = [_rounding_floor(build, dev, hr, gan, 1, seed, moments=True)
                     for seed in TP_FLOOR_DRAWS]
        ties = _adam_ties(want, draws)
        floor = _floor_of([_errors_off_ties(d, want, ties) for d in draws])
        out["ties"] = {part: sum(int(m.sum()) for m in masks.values())
                       for part, masks in ties.items()}
        del draws
        torch.cuda.empty_cache()
    faults = {}
    for name in TP_CONTROLS[gan]:
        with _tp_fault(name):
            state, step, specs = _tp_built(build, dev, mesh)
            faults[name] = _tp_record(state, step, hr, gan, mesh, specs)
            del state, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step, specs = _tp_built(build, dev, mesh)
    out["state_bytes"] = _state_bytes(state)
    times = []
    got = _tp_record(state, _timed(step, times), hr, gan, mesh, specs)
    out["ms"] = times[0]
    out["exchanges"] = dict(step.model_shard.counts)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["hash"] = _tp_hash(state, mesh, specs)
    del state, step
    if mesh.rank == 0:
        out.update(errors=_errors_off_ties(got, want, ties), floor=floor,
                   controls={k: _errors_off_ties(v, want, ties) for k, v in faults.items()})
    torch.cuda.empty_cache()
    return out


def _tp_qat_case(mesh, tmp: Path) -> dict:
    """(c) on a rank of the grid: phase 12's QAT step at TP_QAT_BATCH, every
    run's fake-quant levels pinned at ties to rank 0's single-process step
    (`step_numerics.fake_quant_levels`; the tp run's record cut to its
    output channels by `model_shard_levels`): the single-process step and
    its floor (`TP_FLOOR_DRAWS`, pinned alike), the tp step with its ties
    taken and its levels off a tie counted. The record goes from rank 0 to
    the other through a file."""
    import functools

    import torch.distributed as dist

    from facesr_torch.cli.step_numerics import (RecordingAdamW, fake_quant_levels,
                                                model_shard_levels)

    dev, out = mesh.device, {}
    build = functools.partial(production_step_fn, qat=True)
    hr = smooth_hr(TP_QAT_BATCH, TP_QAT_HR, seed=7, dev=dev)
    path = tmp / "tp_qat_levels.pt"
    if mesh.rank == 0:
        state, step, _ = build(dev, opt_cls=RecordingAdamW)
        with fake_quant_levels() as rec:
            want = _step_record(state, step, hr, False, moments=True)
        del state, step
        record = {"weights": [t.to(torch.int8) for t in rec["weights"]],
                  "levels": [t.to(torch.int8) for t in rec["levels"]],
                  "outputs": rec["outputs"]}
        del rec
        torch.save(record, path)
        draws = []
        for seed in TP_FLOOR_DRAWS:
            state, step, _ = build(dev, opt_cls=RecordingAdamW)
            x = hr
            if seed is not None:
                x = hr * (1 + DP_FLOOR_NOISE * torch.randn(
                    hr.shape, generator=torch.Generator().manual_seed(seed)).to(dev))
            with _channel_halves(), fake_quant_levels(
                    lambda i, w: (record["weights"][i], record["levels"][i],
                                  record["outputs"][i])):
                draws.append(_step_record(state, step, x, False, moments=True))
            del state, step
        ties = _adam_ties(want, draws)
        floor = _floor_of([_errors_off_ties(d, want, ties) for d in draws])
        out["adam_ties"] = {part: sum(int(m.sum()) for m in masks.values())
                            for part, masks in ties.items()}
        del draws
        torch.cuda.empty_cache()
    dist.barrier(group=mesh.group)  # rank 0's record is written
    if mesh.rank != 0:
        record = torch.load(path)
    torch.cuda.reset_peak_memory_stats()
    state, step, specs = _tp_built(build, dev, mesh)
    with fake_quant_levels(model_shard_levels(record, step.model_shard)) as pin:
        got = _tp_record(state, step, hr, False, mesh, specs)
    out.update(ties=pin["ties"], off_tie=pin["off_tie"],
               levels=sum(lv.numel() for lv in pin["levels"]),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               exchanges=dict(step.model_shard.counts), hash=_tp_hash(state, mesh, specs))
    del state, step, pin, record
    if mesh.rank == 0:
        out.update(errors=_errors_off_ties(got, want, ties), floor=floor)
    torch.cuda.empty_cache()
    return out


def tp_step_rank(mesh, tmp: str, card: str) -> dict:
    """(a), (b) and (c) on one of two gloo ranks of the [1, 2] data,model
    grid sharing cuda:0."""
    from facesr_torch.ops import rcab_group as rg

    dev, rank = mesh.device, mesh.rank
    out = {"rank": rank, "coords": (mesh.axis_index("data"), mesh.axis_index("model")),
           "seconds": {}}
    t0 = time.perf_counter()
    out["content"] = _tp_case(mesh, production_step_fn,
                              smooth_hr(TP_BATCH, TRAIN_HR, seed=7, dev=dev), False)
    out["seconds"]["(a)"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["gan"] = _tp_case(mesh, gan_step_fn, smooth_hr(TP_GAN_BATCH, GAN_HR, seed=8, dev=dev),
                          True)
    out["seconds"]["(b)"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["qat"] = _tp_qat_case(mesh, Path(tmp))
    out["seconds"]["(c)"] = time.perf_counter() - t0
    out["launches"] = rg.fused_residual_group.launches
    return out


def tp_report(name: str, case: dict, other: dict, card: str, what: str) -> None:
    """A tp step case's numbers and checks (rank 0's comparisons, both
    ranks' hashes)."""
    limit = _sp_limits(case)
    failed = _over(case["errors"], limit)
    single = case.get("single")
    log(f"  {name} {what} on the {list(TP_GRID)} data,model grid (2 gloo ranks on cuda:0, the "
        f"state split by tp_param_shardings) against the single-process step, relative L2 "
        f"(TF32 off), the worst tensor a part: {json.dumps(_worst(case['errors']))}; the "
        f"rounding floor (the convs in output-channel halves, the input x (1 + 2^-23 N(0, 1)) "
        f"twice and as it is, the largest of the three draws), the worst tensor a part: "
        f"{json.dumps(_worst(case['floor']))}; each "
        f"tensor's limit max({STEP_RTOL}, {DP_FLOOR_FACTOR} x its floor): the largest error / "
        f"limit a part {json.dumps(_ratios(case['errors'], limit))}; parameters compared off "
        f"their Adam ties (elements whose gradient is within {DP_FLOOR_FACTOR} x its rounding "
        f"noise of zero): {json.dumps(case['ties'])}; states (gathered) bitwise equal across "
        f"ranks: {case['hash'] == other['hash']} [{card}]")
    if single is not None:
        log(f"  {name} ms a step: tp {case['ms']:.3f} (warm: after the controls' steps), one "
            f"process first {single['first_ms']:.3f}, then {single['ms']:.3f}; a rank's "
            f"peak {case['peak_gib']:.3f} GiB against {single['peak_gib']:.3f} alone; a rank's "
            f"state {case['state_bytes']} bytes against {single['state_bytes']} alone "
            f"({case['state_bytes'] / single['state_bytes']:.3f}); a rank's exchanges in the "
            f"step {json.dumps(case['exchanges'])} [{card}]")
    for control, errs in case.get("controls", {}).items():
        over = _over(errs, limit)
        log(f"  {name} control {control}: tensors over their limits "
            + json.dumps({p: f"{len(v)} of {len(limit[p])}" for p, v in over.items()})
            + f", the worst tensor a part {json.dumps(_worst(errs))}")
        if not any(over.values()):
            raise AssertionError(f"the tp checks cannot see the planted {control}")
    if any(failed.values()):
        raise AssertionError(f"the tp {what} disagrees with the single-process step: {failed}")
    if case["hash"] != other["hash"]:
        raise AssertionError(f"the tp ranks' {what} states differ")


def tp_cli(tmp: Path, card: str) -> dict:
    """(d): the stage-1 YAML through the train CLI on data,model [1, 2] with
    --print-memory, one epoch of two steps at --batch-size TP_CLI_BATCH;
    rank 0's final_model.pth loaded strict by a single-process model, its
    final_model.fckpt resumed by a single-process CLI run for epoch 2."""
    import io
    import os
    import re

    from facesr_torch.ckpt.weights import read_state_dict
    from facesr_torch.cli import train as train_cli
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet
    from facesr_torch.ops import rcab_group as rg
    from facesr_torch.parallel.launch import run_cli_ranks

    data = png_subset(tmp, "tp_cli_data", 2 * TP_CLI_BATCH, TP_CLI_BATCH)  # two steps
    run_dir = tmp / "tp_cli"
    run_dir.mkdir()
    flags = ["--config", str(STAGE1_YAML), "--data-root", str(data), "--batch-size",
             str(TP_CLI_BATCH), *TP_CLI_FLAGS]
    t0 = time.perf_counter()
    codes = run_cli_ranks("facesr_torch.cli.train",
                          [*flags, "--epochs", "1", "--print-memory", "--mesh-axes",
                           "data,model", "--mesh-shape", ",".join(map(str, TP_GRID)),
                           "--dist-backend", "gloo"],
                          2, timeout=DP_TIMEOUT, log_dir=str(run_dir), cwd=str(run_dir),
                          env={"PYTHONPATH": str(REPO)})
    out = {"s": time.perf_counter() - t0, "codes": codes}
    logs = [(run_dir / f"rank{r}.log").read_text() for r in range(2)]
    ckpt = run_dir / "checkpoints"
    out["files"] = sorted(p.name for p in ckpt.iterdir()) if ckpt.exists() else []
    for r, text in enumerate(logs):
        for line in text.splitlines():
            if "MB (" in line or "data,model grid" in line or "Batch size" in line \
                    or "Val PSNR" in line or "ms/step" in line:
                log(f"  (d) rank {r}: {line.strip()}")
    psnr = [float(v) for v in re.findall(r"Val PSNR:\s+([-\d.]+) dB", logs[0])]
    if codes != [0, 0] or "final_model.fckpt" not in out["files"] or not psnr \
            or not all(math.isfinite(v) for v in psnr) \
            or not all(f"at (0, {r}) of the data,model grid" in logs[r] for r in range(2)) \
            or not all("device memory" in t for t in logs):
        raise AssertionError("the data,model train CLI run: "
                             + f"{codes}, " + " | ".join(t[-1500:] for t in logs))
    model = FaceEnhanceNet(production_config(), seed=1, device="cpu")
    model.load_state_dict(read_state_dict(str(ckpt / "final_model.pth")), strict=True)
    out["pth_finite"] = all(bool(torch.isfinite(v).all()) for v in model.state_dict().values())
    # one process resumes the tp run's file and trains epoch 2
    resume_dir = tmp / "tp_cli_resume"
    resume_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(resume_dir)
    buf = io.StringIO()
    before = rg.fused_residual_group.launches
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            trainer = train_cli.run([*flags, "--epochs", "2", "--resume",
                                     str(ckpt / "final_model.fckpt")])
    finally:
        os.chdir(cwd)
    out["resume_s"] = time.perf_counter() - t0
    out["resume"] = {"epoch": trainer.current_epoch, "steps": trainer.global_step,
                     "history": trainer.training_history["val_psnr"],
                     "launches": rg.fused_residual_group.launches - before}
    del trainer
    torch.cuda.empty_cache()
    if not (out["pth_finite"] and out["resume"]["steps"] == 4
            and len(out["resume"]["history"]) == 2
            and all(math.isfinite(v) for v in out["resume"]["history"])):
        raise AssertionError(f"the tp checkpoint did not resume in one process: {out}, "
                             + buf.getvalue()[-1500:])
    return out


def tp_phase(card: str, tmp: Path) -> int:
    """Phase 18: tensor parallelism on the card; returns the group kernel's
    launches on its paths (none: training runs the plain trunk)."""
    from facesr_torch.parallel.launch import run_ranks

    log(f"== 18. tensor parallelism (the convs' output channels and the training state over a "
        f"data,model grid; the card's machine has one card, so two gloo ranks share cuda:0) "
        f"[{card}]")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0, r1 = run_ranks(tp_step_rank, 2, args=(str(tmp), card), devices=[DP_DEVICE] * 2,
                       backend="gloo", timeout=DP_TIMEOUT, axis_names=("data", "model"),
                       shape=TP_GRID)
    parts = {"(a), (b), (c): one launch of two ranks": time.perf_counter() - t_phase}
    parts.update({f"rank 0's {k}": v for k, v in r0["seconds"].items()})
    log("  the launch: " + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    if (r0["coords"], r1["coords"]) != ((0, 0), (0, 1)):
        raise AssertionError(f"the grid's coordinates: {r0['coords']}, {r1['coords']}")
    cfg = production_config()
    width = f"{cfg.num_groups}x{cfg.blocks_per_group}x{cfg.num_channels}"
    tp_report("(a)", r0["content"], r1["content"], card,
              f"the stage-1 step ({width} f32, batch {TP_BATCH} (cut from 48: gloo traffic), HR "
              f"{TRAIN_HR}, L1 + VGG19 conv3_4, clip 0.5)")
    tp_report("(b)", r0["gan"], r1["gan"], card,
              f"stage 3's GAN step (G {width}, D at {GAN_HR} with {GAN_D_BASE} base channels and "
              f"BatchNorm, f32, batch {TP_GAN_BATCH}, L1 0.01 + VGG19 conv3_4 + 0.005 vanilla GAN)")
    q0, q1 = r0["qat"], r1["qat"]
    limit = _sp_limits(q0)
    failed = _over(q0["errors"], limit)
    log(f"  (c) phase 12's QAT step (batch {TP_QAT_BATCH}, HR {TP_QAT_HR}: its level records) on "
        f"the grid, its "
        f"fake-quant levels pinned at ties to the single-process step's: {q0['ties']} of "
        f"{q0['levels']} levels and signs taken at a tie on rank 0, {q0['off_tie']} off a tie "
        f"(rank 1: {q1['ties']}, {q1['off_tie']}); against the single-process step, relative "
        f"L2, the worst tensor a part: {json.dumps(_worst(q0['errors']))}; the floor (the convs "
        f"in channel halves, three draws as (a)'s, pinned alike), the worst tensor a part: "
        f"{json.dumps(_worst(q0['floor']))}; the "
        f"largest error / limit a part {json.dumps(_ratios(q0['errors'], limit))}; parameters "
        f"off their Adam ties {json.dumps(q0['adam_ties'])}; states "
        f"bitwise equal across ranks: {q0['hash'] == q1['hash']}; a rank's peak "
        f"{q0['peak_gib']:.3f} GiB; a rank's exchanges {json.dumps(q0['exchanges'])} [{card}]")
    if q0["off_tie"] or q1["off_tie"] or q0["ties"] > 1e-4 * q0["levels"]:
        raise AssertionError(f"the tp QAT step's levels leave the single process's: {q0}")
    if any(failed.values()):
        raise AssertionError(f"the tp QAT step disagrees with the single-process step: {failed}")
    if q0["hash"] != q1["hash"]:
        raise AssertionError("the tp QAT ranks' states differ")
    t0 = time.perf_counter()
    cli = tp_cli(tmp, card)
    parts["(d)"] = time.perf_counter() - t0
    log(f"  (d) the stage-1 YAML through the train CLI on data,model {list(TP_GRID)} (torchrun's "
        f"environment, 2 ranks on cuda:0 over gloo), --print-memory, --batch-size {TP_CLI_BATCH}, "
        f"1 epoch on {2 * TP_CLI_BATCH} of phase 8's train PNGs: exit codes {cli['codes']}, "
        f"{cli['s']:.1f} s with set-up; rank 0 wrote {cli['files']}; final_model.pth loaded "
        f"strict into a {width} FaceEnhanceNet (finite: {cli['pth_finite']}); final_model.fckpt "
        f"resumed by one process for epoch 2: epoch {cli['resume']['epoch'] + 1}, "
        f"{cli['resume']['steps']} steps, val PSNR {cli['resume']['history']}, "
        f"{cli['resume_s']:.1f} s [{card}]")
    launches = r0["launches"] + r1["launches"] + cli["resume"]["launches"]
    log(f"  (e) group-kernel launches in phase 18: {launches} (training runs the plain trunk)")
    if launches:
        raise AssertionError("phase 18 launched the group kernel")
    log(f"  phase 18 took {time.perf_counter() - t_phase:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + f" [{card}]")
    return launches


def input_shape_str(program) -> str:
    from facesr_torch.ckpt.export import input_shape

    return str(tuple(input_shape(program)))


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
        with tempfile.TemporaryDirectory(prefix="facesr_torch_serve_") as stmp:
            serving = serving_phase(dev, card, Path(stmp), fwd_med * 1e3, pred_med * 1e3)
        launches["fused_residual_group"] += serving["launches"]  # and phase 11's
        launches["fused_residual_group"] += int8_phase(dev, card, Path(tmp),
                                                       step_alone_ms)  # and phase 12's
        zoo = zoo_phase(dev, card, Path(tmp))
        launches["fused_residual_group"] += zoo["launches"]  # and phase 13's
        launches["fused_residual_group"] += zoo_int8_phase(
            dev, card, Path(tmp), zoo["step_ms"])  # and phase 14's
        explain_phase(dev, card, Path(tmp))
        launches["fused_residual_group"] += dp_phase(card, Path(tmp))  # and phase 16's
        launches["fused_residual_group"] += sp_phase(card, Path(tmp))  # and phase 17's
        launches["fused_residual_group"] += tp_phase(card, Path(tmp))  # and phase 18's

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
        "b4_ms": zoo["b4"]["ms"],
        "b4_plain_ms": zoo["b4"]["plain_ms"],
        "b4_library_ms": zoo["b4"]["library_ms"],
        "b4_bound_ms": zoo["b4"]["bound_ms"],
    }]}
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
