"""How far one small f32 training step on a device is from the same step
on the CPU, and how far f32 rounding alone moves it.

    python -m facesr_torch.cli.step_numerics [--device cuda]

The step is `make_train_step` on FaceEnhanceNet G=2, B=2, C=16 (conv_last
redrawn non-zero), batch 2 of HR 32x32, AdamW (clip 0.5, lr 1e-4). Each
row is the relative L2 error (||a - b|| / ||b||) of the loss and the
worst one over the tensors of the gradients and of the updated params:

- ``device``: the step on ``--device`` against the CPU step;
- ``TF32 forced``: the same with cuDNN and cuBLAS TF32 allowed and
  `full_f32` bypassed (the control `chip_smoke.py` must reject);
- ``cuDNN off``: the device step with cuDNN disabled;
- ``weights * (1 + 1e-7 noise), CPU``: the CPU step after moving every
  weight by f32-rounding-sized noise, i.e. how well conditioned the
  loss's gradient is at f32 resolution.

Each for the stage-1 loss (L1 + VGG19 perceptual, L1 criterion) and for a
smooth loss with the same ops (L2 + perceptual with the L2 criterion +
0.1 SSIM). Then the sign flips: the elements where the device's forward
and the CPU's disagree in the sign of ``pred - target``, which is the
gradient an L1 criterion sends back, for the pixel L1 term (the model's
output against the HR batch) and for the perceptual term (the VGG19
conv3_4 features of the output against those of the HR batch); and the
device step against the CPU step with those signs pinned to the CPU
forward's on both (`pinned_sign_loss_apply`): if the flips are what
moves the stage-1 gradients, this row falls to the smooth loss's level;
and, the other way round, the CPU step with the one conv3_4 sign nearest
to zero flipped against the CPU step. Then, on a CUDA device, single f32
convs at the shapes of that step against f64: forward, input gradient and
weight gradient, for an upstream gradient drawn N(0, 1) and for its sign.

`small_zoo_step` is the zoo's step (with ``qat``, fake-quantized), and
`fake_quant_levels` records one run's fake-quant levels and output signs
and pins another run's to them where the two round a tie apart, so that
two QAT steps compare without one tie spreading through the step; under
a row shard it reads the shard's levels on the image's grid, and
`row_shard_levels` cuts an unsharded run's record to a shard's rows
(`model_shard_levels` to a `model` rank's output channels,
`grid_shard_levels` to both at once).
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Callable, Dict, Optional, Tuple
from unittest import mock

import numpy as np
import torch

from facesr_torch.losses.basic import l1_loss, l2_loss
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.losses.perceptual import perceptual_loss
from facesr_torch.losses.ssim import ssim_loss
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.ops.init import kaiming_normal
from facesr_torch.ops.quant import fake_quant_params
from facesr_torch.ops.resize import bicubic_up
from facesr_torch.parallel import spatial
from facesr_torch.parallel.tensor import whole_named
from facesr_torch.training import steps
from facesr_torch.training.optim import AdamW

__all__ = ["stage1_loss_apply", "smooth_loss_apply", "small_step", "small_gan_step",
           "small_zoo_step", "step_errors", "gan_step_errors", "rel_l2", "sign_flips",
           "pinned_sign_loss_apply", "LEVEL_TIE", "SIGN_TIE", "grid_levels",
           "fake_quant_levels"]

StepResult = Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]


def stage1_loss_apply(loss_params, sr, hr):
    """L1 + VGG19 perceptual (conv3_4, L1 criterion): the stage-1 loss."""
    comps = {"l1": l1_loss(sr, hr),
             "perceptual": perceptual_loss(loss_params["vgg"], sr, hr, layers=("conv3_4",),
                                           remat=False)}
    return comps["l1"] + comps["perceptual"], comps


def smooth_loss_apply(loss_params, sr, hr):
    """L2 + VGG19 perceptual (conv3_4, L2 criterion) + 0.1 SSIM: the
    stage-1 loss's ops with a gradient that is a smooth function of the
    forward."""
    comps = {"l2": l2_loss(sr, hr),
             "perceptual": perceptual_loss(loss_params["vgg"], sr, hr, layers=("conv3_4",),
                                           criterion="l2", remat=False),
             "ssim": ssim_loss(sr, hr)}
    return comps["l2"] + comps["perceptual"] + 0.1 * comps["ssim"], comps


class RecordingAdamW(AdamW):
    """AdamW that keeps a host copy of the gradients it was given (under a
    `model` shard, the split ones gathered whole)."""

    def update(self, grads, state, params, shard=None):
        whole = whole_named(grads, params, shard)
        self.grads = {k: v.detach().cpu().clone() for k, v in whole.items()}
        super().update(grads, state, params, shard=shard)


def _small_model(weight_noise: float = 0.0) -> FaceEnhanceNet:
    """The step's model on the CPU: G=2, B=2, C=16, conv_last redrawn
    non-zero, every weight times (1 + weight_noise * N(0, 1))."""
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_groups=2, blocks_per_group=2,
                                                num_channels=16), seed=0, device="cpu")
    with torch.no_grad():
        model.conv_last.weight.copy_(kaiming_normal(model.conv_last.weight.shape,
                                                    torch.Generator().manual_seed(1), scale=0.1))
        if weight_noise:
            gen = torch.Generator().manual_seed(9)
            for p in model.parameters():
                p.mul_(1 + weight_noise * torch.randn(p.shape, generator=gen))
    return model


def _small_hr() -> torch.Tensor:
    lo = np.random.default_rng(6).random((2, 8, 8, 3), dtype=np.float32)
    return bicubic_up(torch.from_numpy(lo), 4).clamp(0.0, 1.0).contiguous()


@contextlib.contextmanager
def _tf32_forced():
    """cuDNN convs and cuBLAS matmuls allowed TF32, and `full_f32` bypassed
    wherever a step reaches it."""
    plain = contextlib.nullcontext
    with contextlib.ExitStack() as stack:
        for where in ("facesr_torch.ops.conv", "facesr_torch.training.steps",
                      "facesr_torch.models.discriminator"):
            stack.enter_context(mock.patch(f"{where}.full_f32", plain))
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# two correct f32 runs of a fake-quant step may part at its discontinuities
# where their sums or quotients differ in the last bits: a kernel weight or
# an activation whose quotient t / scale lies within LEVEL_TIE levels of a
# level boundary (f32 moves it by ~1e-5 levels near |127|, TF32 convs by
# ~1e-1), and a conv output within SIGN_TIE of its tensor's max|y| of zero,
# the kink of the LeakyReLU or PReLU that follows it
LEVEL_TIE = 1e-3
SIGN_TIE = 1e-5


def grid_levels(t: torch.Tensor, scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t / scale, its s8 level) on a fake-quant grid."""
    v = t / scale
    return v, torch.round(v).clamp(-127, 127)


def _level_ties(t, scale, want, out):
    """``t`` with the elements whose level ties with the reference's
    ``want`` moved onto the reference's level (to the boundary, at most
    `LEVEL_TIE` levels away, then ulps past it); counts in ``out``."""
    v, lv = grid_levels(t, scale)
    moved = lv != want
    gap = v - (lv + want) / 2
    tie = moved & ((lv - want).abs() == 1) & (gap.abs() <= LEVEL_TIE)
    out["off_tie"] += int((moved & ~tie).sum())
    if not bool(tie.any()):
        return t
    out["ties"] += int(tie.sum())
    out["worst_tie"] = max(out["worst_tie"], float(gap[tie].abs().max()))
    ws, at = want[tie], scale.expand_as(t)[tie]
    step = torch.where(ws > lv[tie], torch.inf, -torch.inf)
    ts = (lv[tie] + ws) / 2 * at  # onto the boundary, then ulps past it
    for _ in range(64):
        off = grid_levels(ts, at)[1] != ws
        if not bool(off.any()):
            break
        ts = torch.where(off, torch.nextafter(ts, step), ts)
    else:
        raise AssertionError("a level tie did not cross its boundary within 64 ulps")
    nudged = t.clone()
    nudged[tie] = ts
    return nudged


@contextlib.contextmanager
def fake_quant_levels(reference: Optional[Callable[[int, torch.Tensor], Tuple[torch.Tensor, ...]]]
                      = None):
    """Record, and pin to a reference run's at ties, the kernel and
    activation levels and the output signs of every fake-quant conv
    (`ops.conv._conv2d_fakequant`) run inside the block.

    Yields a dict: ``weights``, ``levels`` and ``outputs``, each call's
    kernel levels (OIHW), activation levels and conv output (the
    pre-activation) on the CPU, in call order and before pinning;
    ``ties``, the levels and signs taken from ``reference``;
    ``worst_tie``, the largest distance of such a level's quotient from the
    boundary it crossed; ``off_tie``, the levels and signs that differ from
    the reference's away from a tie (not taken).

    ``reference(i, w)`` gives (kernel levels, activation levels, output)
    of the i-th call, whose latent kernel is ``w`` (OIHW), in another run.
    Where a level here is next to the reference's and its quotient within
    `LEVEL_TIE` of the boundary between them, the latent weight or the
    input element moves across it onto the reference's level; where an
    output lies on the other side of zero from the reference's, within
    `SIGN_TIE` of its max, it takes the reference's value. Gradients pass
    all three unchanged. The two runs then go on from the same levels and
    the same activation branches, where one tie would otherwise spread
    through every later site and the backward pass."""
    from facesr_torch.ops import conv as conv_ops
    from facesr_torch.ops.quant import FakeQuantWeight

    real = conv_ops._conv2d_fakequant
    out = {"weights": [], "levels": [], "outputs": [], "ties": 0, "worst_tie": 0.0,
           "off_tie": 0}

    def pinned(x, w, b, stride, padding, groups, dtype):
        if dtype is not None:
            x = x.to(dtype)
        wf, xf = w.w.detach().float(), x.detach().float()
        s = conv_ops.fake_quant_scale(wf)
        a = conv_ops.fake_quant_scale(xf, w.a, shard=spatial.current())
        i = len(out["levels"])
        out["weights"].append(grid_levels(wf, s)[1].cpu())
        out["levels"].append(grid_levels(xf, a)[1].cpu())
        ref = None if reference is None else [t.to(x.device) for t in reference(i, w.w)]
        if ref is not None:
            w = FakeQuantWeight(w.w + (_level_ties(wf, s, ref[0], out).to(w.w.dtype)
                                       - w.w).detach(), w.a)
            x = x + (_level_ties(xf, a, ref[1], out).to(x.dtype) - x).detach()
        y = real(x, w, b, stride, padding, groups, dtype)
        out["outputs"].append(y.detach().cpu())
        if ref is not None:
            want = ref[2].to(y.dtype)
            flip = (y >= 0) != (want >= 0)
            tie = flip & ((y - want).abs() <= SIGN_TIE * want.abs().max())
            out["off_tie"] += int((flip & ~tie).sum())
            if bool(tie.any()):
                out["ties"] += int(tie.sum())
                y = y + (torch.where(tie, want, y) - y).detach()
        return y

    with mock.patch.object(conv_ops, "_conv2d_fakequant", pinned):
        yield out


def row_shard_levels(record, shard, batch: slice = slice(None)):
    """`fake_quant_levels`'s reference for a run on row ``shard`` (rows of
    the images of ``batch``) from an unsharded run's ``record`` (its
    ``weights``, ``levels``, ``outputs``): each call's kernel levels, its
    activation levels cut to the shard's rows with one halo row each way
    (the 3x3 'same' convs of the models; zeros beyond the image), and its
    output cut to the shard's rows."""
    def of(i, w):
        levels, y = record["levels"][i][batch], record["outputs"][i][batch]
        rows = y.shape[1] // shard.size
        top = shard.index * rows
        padded = torch.nn.functional.pad(levels, (0, 0, 0, 0, 1, 1))
        return (record["weights"][i], padded[:, top:top + rows + 2], y[:, top:top + rows])
    return of


def model_shard_levels(record, shard, batch: slice = slice(None)):
    """`fake_quant_levels`'s reference for a run on `model` ``shard`` (the
    images of ``batch``) from an unsharded run's ``record``: a call whose
    latent kernel is this rank's slice of the output channels takes that
    slice of the kernel levels and of the output; the activation levels
    (the whole input) stay whole."""
    def of(i, w):
        kernel, y = record["weights"][i], record["outputs"][i][batch]
        if w.shape[0] != kernel.shape[0]:
            a, b = shard.bounds(kernel.shape[0])
            kernel, y = kernel[a:b], y[..., a:b]
        return kernel, record["levels"][i][batch], y
    return of


def grid_shard_levels(record, row_shard, model_shard, batch: slice = slice(None)):
    """`fake_quant_levels`'s reference for a run on a `data,space,model`
    grid (row ``row_shard`` and `model` ``model_shard`` at once, the images
    of ``batch``) from an unsharded run's ``record``: `row_shard_levels`'s
    cut to the shard's rows, then `model_shard_levels`'s slice of the
    output channels where the call's latent kernel is this rank's slice."""
    rows = row_shard_levels(record, row_shard, batch)

    def of(i, w):
        kernel, levels, y = rows(i, w)
        if w.shape[0] != kernel.shape[0]:
            a, b = model_shard.bounds(kernel.shape[0])
            kernel, y = kernel[a:b], y[..., a:b]
        return kernel, levels, y
    return of


def small_step(dev, loss_apply: Callable = smooth_loss_apply, tf32_forced: bool = False,
               weight_noise: float = 0.0, qat: bool = False) -> StepResult:
    """One train step of the small model on ``dev``; returns (loss, grads,
    updated params) on the CPU. ``tf32_forced`` lets cuDNN and cuBLAS use
    TF32 and bypasses `full_f32`; ``weight_noise`` multiplies every weight
    by (1 + weight_noise * N(0, 1)) first; ``qat`` runs the forward
    fake-quantized on the int8 serving grid (dynamic scales)."""
    model = _small_model(weight_noise).to(dev)
    loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=1.0, ssim_weight=0.0,
                                   perceptual_layers=["conv3_4"]), seed=0, device=dev)
    opt = RecordingAdamW(weight_decay=0.0, gradient_clip=0.5)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), 1e-4),
                             loss_params=loss.params)
    sites = fake_quant_params(model) if qat else None
    step = steps.make_train_step(loss_apply, opt, quant_fn=(lambda: sites) if qat else None)
    hr = _small_hr().to(dev)
    with _tf32_forced() if tf32_forced else contextlib.nullcontext():
        _, metrics = step(state, hr)
    params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return metrics["loss"].cpu(), opt.grads, params


def _small_zoo_model(kind: str, stage: int):
    """The zoo step's model on the CPU: the transfer model of the CPU tests
    (5 backbone blocks, 2 head RCABs, 16 channels) in ``stage``, or an
    RRDBNet of 2 blocks, 16 features, growth 8; every weight moved off its
    init by seeded noise (the zero biases count)."""
    from facesr_torch.models.esrgan import RRDBNet, RRDBNetConfig
    from facesr_torch.models.transfer import TrainingStage, TransferModelConfig, TransferSRModel

    if kind == "transfer":
        model = TransferSRModel(TransferModelConfig(backbone_blocks=5, head_blocks=2,
                                                    head_channels=16), seed=0, device="cpu")
        model.current_stage = TrainingStage(stage)
        model._apply_stage()
    else:
        model = RRDBNet(RRDBNetConfig(num_feat=16, num_blocks=2, num_grow_ch=8), seed=0,
                        device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def small_zoo_step(dev, kind: str = "transfer", stage: int = 1, tf32_forced: bool = False,
                   qat: bool = False) -> Tuple[StepResult, Dict[str, torch.Tensor]]:
    """One train step of a small zoo model (``kind`` "transfer" in
    ``stage`` 1-3, or "esrgan") on ``dev`` with the smooth loss and AdamW
    (clip 0.5, lr 1e-4), batch 2 of HR 32x32; returns ((loss, grads,
    updated params) on the CPU, the params before the step). Only the
    stage's trained parameters get gradients. ``qat`` fake-quantizes
    every int8 site (frozen ones too) on the dynamic grid."""
    model = _small_zoo_model(kind, stage)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model = model.to(dev)
    loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=1.0, ssim_weight=0.0,
                                   perceptual_layers=["conv3_4"]), seed=0, device=dev)
    opt = RecordingAdamW(weight_decay=0.0, gradient_clip=0.5)
    state = steps.TrainState(model=model, loss_params=loss.params,
                             opt_state=opt.init(steps.trainable_parameters(model), 1e-4))
    sites = fake_quant_params(model) if qat else None
    step = steps.make_train_step(smooth_loss_apply, opt, quant_fn=(lambda: sites) if qat else None)
    with _tf32_forced() if tf32_forced else contextlib.nullcontext():
        _, metrics = step(state, _small_hr().to(dev))
    params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return (metrics["loss"].cpu(), opt.grads, params), start


GAN_BATCH, GAN_HR, GAN_D_BASE = 4, 64, 8


def small_gan_step(dev, tf32_forced: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """One GAN step (`make_gan_train_step`) of the small model (G=2, B=2,
    C=16) and a discriminator at 64 with 8 base channels and BatchNorm, on
    a batch of 4 smooth HR 64x64 images, the smooth loss + 0.005 vanilla
    GAN, AdamW for G (clip 0.5, lr 1e-4) and D (lr 1e-4); returns on the
    CPU {"losses", "g_grads", "d_grads", "g_params", "d_params", "d_stats"}.
    ``tf32_forced`` lets cuDNN and cuBLAS use TF32 and bypasses
    `full_f32`."""
    from facesr_torch.models.discriminator import create_discriminator

    model = _small_model().to(dev)
    disc = create_discriminator(input_size=GAN_HR, base_channels=GAN_D_BASE, seed=0,
                                device=dev)
    loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=1.0, ssim_weight=0.0,
                                   perceptual_layers=["conv3_4"]), seed=0, device=dev)
    opt, d_opt = RecordingAdamW(weight_decay=0.0, gradient_clip=0.5), RecordingAdamW(gradient_clip=0.0,
                                                                             weight_decay=0.0)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), 1e-4),
                             loss_params=loss.params, disc=disc,
                             d_opt_state=d_opt.init(dict(disc.named_parameters()), 1e-4))
    step = steps.make_gan_train_step(smooth_loss_apply, opt, d_opt, gan_weight=0.005)
    lo = np.random.default_rng(7).random((GAN_BATCH, 8, 8, 3), dtype=np.float32)
    hr = bicubic_up(torch.from_numpy(lo), GAN_HR // 8).clamp(0.0, 1.0).contiguous().to(dev)
    with _tf32_forced() if tf32_forced else contextlib.nullcontext():
        _, metrics = step(state, hr)

    def host(named):
        return {k: v.detach().cpu().clone() for k, v in named}

    return {"losses": {k: v.cpu() for k, v in metrics.items()}, "g_grads": opt.grads,
            "d_grads": d_opt.grads, "g_params": host(model.named_parameters()),
            "d_params": host(disc.named_parameters()), "d_stats": host(disc.named_buffers())}


def gan_step_errors(got: Dict[str, Dict[str, torch.Tensor]],
                    want: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The worst relative L2 error over the tensors of each part of two
    `small_gan_step` results."""
    return {part: max(rel_l2(got[part][k], want[part][k]) for k in want[part])
            for part in want}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def step_errors(got: StepResult, want: StepResult) -> Tuple[float, float, float]:
    """Relative L2 error of the loss and the worst one over the tensors of
    the gradients and of the updated params. (Adam's first step is
    lr * sign(g) per element: a gradient below rounding may move its
    element 2 lr the other way, which a max-norm would count in full.)"""
    return (rel_l2(got[0], want[0]),
            max(rel_l2(got[1][k], want[1][k]) for k in want[1]),
            max(rel_l2(got[2][k], want[2][k]) for k in want[2]))


def _l1_diffs(dev) -> Dict[str, torch.Tensor]:
    """``pred - target`` of the pixel L1 term (``l1``: the model's output
    against the HR batch) and of the perceptual term (``conv3_4``: the VGG19
    conv3_4 features of both), from the small step's forward on ``dev``,
    returned on the CPU."""
    from facesr_torch.models import vgg
    from facesr_torch.ops.conv import full_f32
    from facesr_torch.ops.resize import bicubic_down

    loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=1.0, ssim_weight=0.0,
                                   perceptual_layers=["conv3_4"]), seed=0, device="cpu")
    idx = vgg.LAYER_MAP["conv3_4"]
    model = _small_model().to(dev)
    vgg_params = [{k: v.to(dev) for k, v in p.items()} for p in loss.params["vgg"]]
    hr = _small_hr().to(dev)
    with torch.no_grad(), full_f32():
        sr = model(bicubic_down(hr, 4), train=True)
        feats = [vgg.extract_features(vgg_params, x, [idx])[idx] for x in (sr, hr)]
    return {"l1": (sr - hr).cpu(), "conv3_4": (feats[0] - feats[1]).cpu()}


def sign_flips(dev) -> Dict[str, Tuple[int, int]]:
    """For each L1 term of `_l1_diffs`: (elements whose sign of ``pred -
    target`` differs between the forward on ``dev`` and on the CPU,
    elements). A zero on one side and not on the other counts as a flip."""
    cpu, other = _l1_diffs("cpu"), _l1_diffs(dev)
    return {k: (int((torch.sign(other[k]) != torch.sign(cpu[k])).sum()), cpu[k].numel())
            for k in cpu}


def pinned_sign_loss_apply(signs: Dict[str, torch.Tensor]) -> Callable:
    """The stage-1 loss with its L1 gradients pinned: ``mean(s * (pred -
    target))`` for the pixel term and the conv3_4 term, with ``s`` the given
    signs (`_l1_diffs` keys) in place of ``sign(pred - target)``. Its
    gradient is the stage-1 loss's wherever the signs agree, and the same
    on every device."""
    from facesr_torch.models import vgg

    idx = vgg.LAYER_MAP["conv3_4"]

    def apply(loss_params, sr, hr):
        f_sr = vgg.extract_features(loss_params["vgg"], sr, [idx])[idx]
        with torch.no_grad():
            f_hr = vgg.extract_features(loss_params["vgg"], hr, [idx])[idx]
        comps = {"l1": (signs["l1"].to(sr.device) * (sr - hr)).mean(),
                 "perceptual": (signs["conv3_4"].to(sr.device) * (f_sr - f_hr)).mean()}
        return comps["l1"] + comps["perceptual"], comps

    return apply


# (N, C_in, C_out, H) of the step's convs: the model's (conv_first, the
# trunk, the upsample stages, conv_last), then the VGG19's up to conv3_4
STEP_CONVS = ((2, 3, 16, 8), (2, 16, 16, 8), (2, 16, 64, 8), (2, 16, 64, 16),
              (2, 16, 3, 32), (2, 3, 64, 32), (2, 64, 64, 32), (2, 64, 128, 16),
              (2, 128, 128, 16), (2, 128, 256, 8), (2, 256, 256, 8))


def conv_probe(dev) -> None:
    """cuDNN f32 (TF32 off) convs, channels_last as the port calls them,
    against the same convs in f64: relative L2 of out, dgrad, wgrad."""
    import torch.nn.functional as F

    from facesr_torch.ops.conv import full_f32

    gen = torch.Generator().manual_seed(0)
    for n, cin, cout, h in STEP_CONVS:
        x64 = torch.randn(n, cin, h, h, generator=gen, dtype=torch.float64)
        w64 = torch.randn(cout, cin, 3, 3, generator=gen, dtype=torch.float64) * 0.1
        g = torch.randn(n, cout, h, h, generator=gen, dtype=torch.float64)
        for kind, g64 in (("N(0,1)", g), ("sign", g.sign())):
            res = []
            for dt in (torch.float64, torch.float32):
                x = x64.to(dev, dt, copy=True).contiguous(memory_format=torch.channels_last)
                x.requires_grad_(True)
                w = w64.to(dev, dt, copy=True).requires_grad_(True)
                with full_f32():
                    y = F.conv2d(x, w, padding=1)
                    y.backward(g64.to(dev, dt))
                res.append((y.detach(), x.grad, w.grad))
            errs = [rel_l2(a, b) for a, b in zip(res[1], res[0])]
            print(f"conv {cin}->{cout} at {h}x{h}, N={n}, upstream {kind:6s}: out "
                  f"{errs[0]:.3g} dgrad {errs[1]:.3g} wgrad {errs[2]:.3g}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device {name}; columns: loss, worst gradient, worst param (relative L2)")
    for label, loss_apply in (("stage-1 loss", stage1_loss_apply),
                              ("smooth loss", smooth_loss_apply)):
        cpu = small_step("cpu", loss_apply)
        rows = [("device", small_step(dev, loss_apply))]
        if dev.type == "cuda":
            rows.append(("TF32 forced", small_step(dev, loss_apply, tf32_forced=True)))
            torch.backends.cudnn.enabled = False
            try:
                rows.append(("cuDNN off", small_step(dev, loss_apply)))
            finally:
                torch.backends.cudnn.enabled = True
        rows.append(("weights * (1 + 1e-7 noise), CPU",
                     small_step("cpu", loss_apply, weight_noise=1e-7)))
        for row, result in rows:
            errs = step_errors(result, cpu)
            print(f"{label:13s} {row:33s} " + " ".join(f"{e:.3g}" for e in errs))
    for term, (flips, total) in sign_flips(dev).items():
        print(f"sign flips of pred - target, {term} term, device vs CPU: {flips} of {total}")
    diffs = _l1_diffs("cpu")
    signs = {k: torch.sign(v) for k, v in diffs.items()}
    pinned = pinned_sign_loss_apply(signs)
    cpu_pinned = small_step("cpu", pinned)
    errs = step_errors(small_step(dev, pinned), cpu_pinned)
    print(f"{'stage-1 loss, L1 signs pinned to the CPU forward':47s} device "
          + " ".join(f"{e:.3g}" for e in errs))
    # the reverse: one flip alone, on the CPU, at the conv3_4 element
    # nearest to zero (the one a rounding difference flips first)
    nearest = int(diffs["conv3_4"].abs().argmin())
    signs["conv3_4"].view(-1)[nearest] *= -1
    errs = step_errors(small_step("cpu", pinned_sign_loss_apply(signs)), cpu_pinned)
    print(f"{'stage-1 loss, CPU, the nearest-zero conv3_4 sign flipped':56s} "
          f"(|pred - target| {diffs['conv3_4'].abs().min().item():.3g}) "
          + " ".join(f"{e:.3g}" for e in errs))
    if dev.type == "cuda":
        conv_probe(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
