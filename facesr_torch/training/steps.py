"""Train and eval steps (port of `facesr/training/steps.py`).

One content step: the HR batch in f32 -> LR made on the device by
`bicubic_down` -> forward with ``train=True`` in the compute dtype -> loss
-> autograd -> `AdamW.update` -> EMA. The GAN step (`make_gan_train_step`)
adds the discriminator updates and the adversarial term around one
generator forward. The whole step, backward included, runs under
`full_f32()`, so every f32 conv and matmul runs without TF32. Metrics stay
device tensors: a step adds no host sync. ``quant_fn`` (QAT) returns the
fake-quant sites each forward runs with (`ops.quant.fake_quant_params`).
A step differentiates and updates the parameters that require grad
(`trainable_parameters`): all of them, except the frozen ones of the
transfer model's stages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from facesr_torch.losses.gan import gan_loss
from facesr_torch.losses.ssim import ssim
from facesr_torch.ops.conv import full_f32
from facesr_torch.ops.resize import bicubic_down
from facesr_torch.training.optim import AdamW

__all__ = ["TrainState", "init_ema", "ema_update", "trainable_parameters", "make_train_step",
           "make_gan_train_step", "make_eval_step"]

LossApply = Callable[[Dict[str, Any], torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
Metrics = Dict[str, torch.Tensor]
QuantFn = Optional[Callable[[], Dict[str, Any]]]


def _quant(quant_fn: QuantFn):
    return None if quant_fn is None else quant_fn()


@dataclass
class TrainState:
    """What a step reads and updates: the model (its parameters are the
    trained weights), the optimiser state, the frozen loss params (VGG),
    the step count and the EMA of the parameters (None when off); for GAN
    training the discriminator (its parameters, and its BatchNorm running
    stats as buffers) and its optimiser state."""

    model: nn.Module
    opt_state: Dict[str, Any]
    loss_params: Dict[str, Any]
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    disc: Optional[nn.Module] = None
    d_opt_state: Optional[Dict[str, Any]] = None


def trainable_parameters(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters a step trains, by name: those that require grad."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def init_ema(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A fresh EMA: a copy of every parameter, by name."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place."""
    for n, p in model.named_parameters():
        ema[n].copy_(ema[n] * decay + p.to(ema[n].dtype) * (1.0 - decay))


def make_train_step(loss_apply: LossApply, optimizer: AdamW, scale_factor: int = 4,
                    compute_dtype: Optional[torch.dtype] = None,
                    ema_decay: float = 0.0, quant_fn: QuantFn = None,
                    ) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, Metrics]]:
    """Content-only (no GAN) step: ``train_step(state, hr) -> (state,
    metrics)``, ``hr`` an NHWC batch in [0, 1] on the model's device. The
    state is updated in place and returned; metrics are the loss
    components, ``loss`` and, with the non-finite guard, the running count
    ``opt_notfinite``."""

    def train_step(state: TrainState, hr: torch.Tensor) -> Tuple[TrainState, Metrics]:
        params = trainable_parameters(state.model)
        with full_f32():
            hr = hr.float()
            lr_img = bicubic_down(hr, scale_factor)
            sr = state.model(lr_img, train=True, dtype=compute_dtype, quant=_quant(quant_fn))
            loss, comps = loss_apply(state.loss_params, sr, hr)
            grads = torch.autograd.grad(loss, list(params.values()))
        optimizer.update(dict(zip(params, grads)), state.opt_state, params)
        if ema_decay > 0:
            ema_update(state.ema_params, state.model, ema_decay)
        state.step += 1
        metrics = {k: v.detach() for k, v in comps.items()}
        metrics["loss"] = loss.detach()
        if "total_notfinite" in state.opt_state:
            metrics["opt_notfinite"] = state.opt_state["total_notfinite"]
        return state, metrics

    return train_step


def make_gan_train_step(loss_apply: LossApply, optimizer: AdamW, d_optimizer: AdamW,
                        scale_factor: int = 4, gan_weight: float = 0.005,
                        gan_type: str = "vanilla", d_updates_per_g: int = 1,
                        compute_dtype: Optional[torch.dtype] = None, ema_decay: float = 0.0,
                        guard_stats: bool = False, quant_fn: QuantFn = None,
                        ) -> Callable[[TrainState, torch.Tensor], Tuple[TrainState, Metrics]]:
    """Adversarial step: ``d_updates_per_g`` discriminator updates on
    (hr, detached sr), then one generator update with content +
    ``gan_weight`` * adversarial loss. ``state.disc`` runs in train mode
    throughout (each call updates its BatchNorm running stats) and in
    ``compute_dtype``, as the generator does.

    One generator forward serves both roles: its detached output is the
    fake batch of the D updates and its graph carries the G update. The G
    head runs the already-updated D on sr and takes gradients for the
    generator's parameters only, so D keeps no gradient and no update from
    it. ``guard_stats`` (with skip_nonfinite optimisers): when the G or D
    loss is not finite the running stats go back to the step's input
    values (``torch.where``, no host sync). Metrics: the content
    components, ``g_adv``, ``loss``, ``d_loss``, ``d_real`` and ``d_fake``
    (mean sigmoid of the last D update's logits), and the guards' running
    counts ``opt_notfinite`` and ``d_opt_notfinite``."""

    def train_step(state: TrainState, hr: torch.Tensor) -> Tuple[TrainState, Metrics]:
        params = trainable_parameters(state.model)
        disc = state.disc
        d_params = dict(disc.named_parameters())
        stats_in = {k: v.clone() for k, v in disc.named_buffers()} if guard_stats else None
        zero = torch.zeros((), device=hr.device)
        d_loss = d_real_score = d_fake_score = zero
        with full_f32():
            hr = hr.float()
            lr_img = bicubic_down(hr, scale_factor)
            sr = state.model(lr_img, train=True, dtype=compute_dtype, quant=_quant(quant_fn))
            sr_for_d = sr.detach()
            for _ in range(d_updates_per_g):
                d_real = disc(hr, train=True, dtype=compute_dtype)
                d_fake = disc(sr_for_d, train=True, dtype=compute_dtype)
                d_loss = (gan_loss(d_real, True, gan_type) + gan_loss(d_fake, False, gan_type)) / 2
                d_grads = torch.autograd.grad(d_loss, list(d_params.values()))
                d_optimizer.update(dict(zip(d_params, d_grads)), state.d_opt_state, d_params)
                d_loss = d_loss.detach()
                d_real_score = torch.sigmoid(d_real.detach()).mean()
                d_fake_score = torch.sigmoid(d_fake.detach()).mean()
            content, comps = loss_apply(state.loss_params, sr, hr)
            g_adv = gan_loss(disc(sr, train=True, dtype=compute_dtype), True, gan_type)
            loss = content + gan_weight * g_adv
            grads = torch.autograd.grad(loss, list(params.values()))
        optimizer.update(dict(zip(params, grads)), state.opt_state, params)
        if guard_stats:
            disc.load_stats(stats_in, keep=torch.isfinite(loss) & torch.isfinite(d_loss))
        if ema_decay > 0:
            ema_update(state.ema_params, state.model, ema_decay)
        state.step += 1
        metrics = {k: v.detach() for k, v in comps.items()}
        metrics.update(g_adv=g_adv.detach(), loss=loss.detach(), d_loss=d_loss,
                       d_real=d_real_score, d_fake=d_fake_score)
        if "total_notfinite" in state.opt_state:
            metrics["opt_notfinite"] = state.opt_state["total_notfinite"]
        if "total_notfinite" in state.d_opt_state:
            metrics["d_opt_notfinite"] = state.d_opt_state["total_notfinite"]
        return state, metrics

    return train_step


def make_eval_step(loss_apply: LossApply, scale_factor: int = 4, use_ema: bool = False,
                   quant_fn: QuantFn = None,
                   ) -> Callable[[TrainState, torch.Tensor],
                                 Tuple[Metrics, torch.Tensor, torch.Tensor]]:
    """Validation step: the f32 eval forward (clamped), the f32 loss, batch
    PSNR ``10*log10(1/max(mse, 1e-12))`` and SSIM. ``use_ema`` validates
    the EMA weights. Returns (metrics, sr, lr)."""

    def eval_step(state: TrainState, hr: torch.Tensor):
        if use_ema and state.ema_params is None:
            raise ValueError(
                "make_eval_step(use_ema=True) on a TrainState without EMA "
                "weights (ema_params is None); build the step with use_ema=False")
        with torch.no_grad(), full_f32():
            hr = hr.float()
            lr_img = bicubic_down(hr, scale_factor)
            quant = _quant(quant_fn)
            if use_ema:
                sr = functional_call(state.model, state.ema_params, (lr_img,),
                                     {"train": False, "quant": quant})
            else:
                sr = state.model(lr_img, train=False, quant=quant)
            loss, _ = loss_apply(state.loss_params, sr, hr)
            mse = ((sr - hr) ** 2).mean()
            psnr = 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12))
            ssim_val = ssim(sr, hr)
        return {"loss": loss, "psnr": psnr, "ssim": ssim_val}, sr, lr_img

    return eval_step
