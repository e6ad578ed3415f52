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
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Callable, Dict, Tuple
from unittest import mock

import numpy as np
import torch

from facesr_torch.losses.basic import l1_loss, l2_loss
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.losses.perceptual import perceptual_loss
from facesr_torch.losses.ssim import ssim_loss
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.ops.init import kaiming_normal
from facesr_torch.ops.resize import bicubic_up
from facesr_torch.training import steps
from facesr_torch.training.optim import AdamW

__all__ = ["stage1_loss_apply", "smooth_loss_apply", "small_step", "small_gan_step",
           "step_errors", "gan_step_errors", "rel_l2", "sign_flips", "pinned_sign_loss_apply"]

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


class _Recording(AdamW):
    """AdamW that keeps a host copy of the gradients it was given."""

    def update(self, grads, state, params):
        self.grads = {k: v.detach().cpu().clone() for k, v in grads.items()}
        super().update(grads, state, params)


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


def small_step(dev, loss_apply: Callable = smooth_loss_apply, tf32_forced: bool = False,
               weight_noise: float = 0.0) -> StepResult:
    """One train step of the small model on ``dev``; returns (loss, grads,
    updated params) on the CPU. ``tf32_forced`` lets cuDNN and cuBLAS use
    TF32 and bypasses `full_f32`; ``weight_noise`` multiplies every weight
    by (1 + weight_noise * N(0, 1)) first."""
    model = _small_model(weight_noise).to(dev)
    loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=1.0, ssim_weight=0.0,
                                   perceptual_layers=["conv3_4"]), seed=0, device=dev)
    opt = _Recording(weight_decay=0.0, gradient_clip=0.5)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), 1e-4),
                             loss_params=loss.params)
    step = steps.make_train_step(loss_apply, opt)
    hr = _small_hr().to(dev)
    with _tf32_forced() if tf32_forced else contextlib.nullcontext():
        _, metrics = step(state, hr)
    params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return metrics["loss"].cpu(), opt.grads, params


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
    opt, d_opt = _Recording(weight_decay=0.0, gradient_clip=0.5), _Recording(gradient_clip=0.0,
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
