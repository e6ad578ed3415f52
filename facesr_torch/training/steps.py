"""Train and eval steps (port of `facesr/training/steps.py`, content path).

One train step: the HR batch in f32 -> LR made on the device by
`bicubic_down` -> forward with ``train=True`` in the compute dtype -> loss
-> autograd -> `AdamW.update` -> EMA. The whole step, backward included,
runs under `full_f32()`, so every f32 conv runs without TF32. Metrics stay
device tensors: a step adds no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from facesr_torch.losses.ssim import ssim
from facesr_torch.ops.conv import full_f32
from facesr_torch.ops.resize import bicubic_down
from facesr_torch.training.optim import AdamW

__all__ = ["TrainState", "init_ema", "ema_update", "make_train_step", "make_eval_step"]

LossApply = Callable[[Dict[str, Any], torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
Metrics = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    """What a step reads and updates: the model (its parameters are the
    trained weights), the optimiser state, the frozen loss params (VGG),
    the step count and the EMA of the parameters (None when off)."""

    model: nn.Module
    opt_state: Dict[str, Any]
    loss_params: Dict[str, Any]
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None


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
                    ema_decay: float = 0.0) -> Callable[[TrainState, torch.Tensor],
                                                        Tuple[TrainState, Metrics]]:
    """Content-only (no GAN) step: ``train_step(state, hr) -> (state,
    metrics)``, ``hr`` an NHWC batch in [0, 1] on the model's device. The
    state is updated in place and returned; metrics are the loss
    components, ``loss`` and, with the non-finite guard, the running count
    ``opt_notfinite``."""

    def train_step(state: TrainState, hr: torch.Tensor) -> Tuple[TrainState, Metrics]:
        params = dict(state.model.named_parameters())
        with full_f32():
            hr = hr.float()
            lr_img = bicubic_down(hr, scale_factor)
            sr = state.model(lr_img, train=True, dtype=compute_dtype)
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


def make_eval_step(loss_apply: LossApply, scale_factor: int = 4, use_ema: bool = False,
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
            if use_ema:
                sr = functional_call(state.model, state.ema_params, (lr_img,),
                                     {"train": False})
            else:
                sr = state.model(lr_img, train=False)
            loss, _ = loss_apply(state.loss_params, sr, hr)
            mse = ((sr - hr) ** 2).mean()
            psnr = 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12))
            ssim_val = ssim(sr, hr)
        return {"loss": loss, "psnr": psnr, "ssim": ssim_val}, sr, lr_img

    return eval_step
