"""Combined SR loss with component tracking (port of
`facesr/losses/combined.py`).

`CombinedLoss.apply(loss_params, pred, target)` returns ``(total,
{name: value})``; only terms with weight > 0 are built. ``loss_params``
holds the frozen VGG conv list (empty without a perceptual term): plain
tensors that require no grad, never optimiser parameters.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import torch

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.losses.basic import charbonnier_loss, l1_loss, l2_loss
from facesr_torch.losses.perceptual import init_perceptual, perceptual_loss
from facesr_torch.losses.ssim import ms_ssim_loss, ssim_loss
from facesr_torch.models.vgg import VGGParams

__all__ = ["LossConfig", "CombinedLoss", "LossTracker", "create_loss_function"]


@dataclass
class LossConfig:
    """Mirrors the JAX package's LossConfig."""

    l1_weight: float = 1.0
    l2_weight: float = 0.0
    perceptual_weight: float = 0.01
    ssim_weight: float = 0.1
    ms_ssim_weight: float = 0.0

    use_charbonnier: bool = False
    charbonnier_eps: float = 1e-3

    perceptual_layers: list = field(default_factory=lambda: ["conv3_4", "conv4_4"])

    ssim_window_size: int = 11


class CombinedLoss:
    """Weighted sum of the enabled loss terms, returning (total, {name:
    value}). A random VGG is drawn from a CPU generator seeded with
    ``seed`` unless ``vgg_params`` are given, then placed on ``device``
    (CUDA unless the caller names one)."""

    def __init__(self, config: Optional[LossConfig] = None,
                 vgg_params: Optional[VGGParams] = None, seed: int = 0,
                 device: DeviceLike = None, **kwargs):
        cfg = replace(config) if config is not None else LossConfig()
        for k, v in kwargs.items():
            if not hasattr(cfg, k):
                raise TypeError(f"Unknown LossConfig field: {k!r}")
            setattr(cfg, k, v)
        self.config = cfg
        self.weights: Dict[str, float] = {}
        for name in ("l1", "l2", "perceptual", "ssim", "ms_ssim"):
            weight = getattr(cfg, f"{name}_weight")
            if weight > 0:
                self.weights[name] = weight
        self.params: Dict[str, Any] = {}
        if "perceptual" in self.weights:
            self.params["vgg"] = init_perceptual(
                torch.Generator().manual_seed(seed),
                layers=tuple(cfg.perceptual_layers), pretrained_params=vgg_params)
        self.to(resolve_device(device))

    def to(self, device: DeviceLike) -> "CombinedLoss":
        """Move the frozen VGG tensors to ``device``."""
        if "vgg" in self.params:
            self.params["vgg"] = [{k: v.to(device) for k, v in p.items()}
                                  for p in self.params["vgg"]]
        return self

    def apply(self, loss_params: Dict[str, Any], pred: torch.Tensor, target: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None, vgg_remat: bool = True,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss of NHWC [0, 1] images. Pixel losses and SSIM run in
        f32; ``compute_dtype`` (bf16 under mixed precision) applies to the
        VGG sweep only."""
        cfg = self.config
        pred = pred.float()
        target = target.float()
        components: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), dtype=torch.float32, device=pred.device)

        if "l1" in self.weights:
            if cfg.use_charbonnier:
                components["l1"] = charbonnier_loss(pred, target, cfg.charbonnier_eps)
            else:
                components["l1"] = l1_loss(pred, target)
        if "l2" in self.weights:
            components["l2"] = l2_loss(pred, target)
        if "perceptual" in self.weights:
            components["perceptual"] = perceptual_loss(
                loss_params["vgg"], pred, target, layers=tuple(cfg.perceptual_layers),
                dtype=compute_dtype, remat=vgg_remat)
        if "ssim" in self.weights:
            components["ssim"] = ssim_loss(pred, target, window_size=cfg.ssim_window_size)
        if "ms_ssim" in self.weights:
            components["ms_ssim"] = ms_ssim_loss(pred, target)
        for name, value in components.items():
            total = total + self.weights[name] * value
        components["total"] = total
        return total, components

    def __call__(self, pred: torch.Tensor, target: torch.Tensor):
        return self.apply(self.params, pred, target)

    def update_weight(self, name: str, weight: float) -> None:
        """Change a built term's weight; a term left out at construction
        (weight 0) cannot be enabled here."""
        if name not in self.weights:
            raise ValueError(f"Unknown loss component: {name}")
        self.weights[name] = weight

    def get_weights(self) -> Dict[str, float]:
        return dict(self.weights)


class LossTracker:
    """Moving-average / epoch-average tracker of host-side loss values."""

    def __init__(self, window_size: int = 100):
        self.window_size = window_size
        self.history: Dict[str, list] = {}
        self.epoch_history: Dict[str, list] = {}

    def update(self, loss_dict: Dict[str, Any]) -> None:
        for name, value in loss_dict.items():
            self.history.setdefault(name, []).append(float(value))

    def get_moving_average(self, name: str) -> float:
        vals = self.history.get(name, [])[-self.window_size:]
        return sum(vals) / len(vals) if vals else 0.0

    def get_epoch_average(self, name: str) -> float:
        vals = self.history.get(name, [])
        return sum(vals) / len(vals) if vals else 0.0

    def end_epoch(self) -> Dict[str, float]:
        avgs = {}
        for name, vals in self.history.items():
            if vals:
                avgs[name] = sum(vals) / len(vals)
                self.epoch_history.setdefault(name, []).append(avgs[name])
        self.history = {name: [] for name in self.history}
        return avgs

    def get_summary(self) -> Dict[str, Any]:
        return {name: {"current": vals[-1], "best": min(vals), "worst": max(vals),
                       "mean": sum(vals) / len(vals)}
                for name, vals in self.epoch_history.items() if vals}

    def to_dict(self) -> Dict[str, list]:
        return dict(self.epoch_history)


def create_loss_function(l1_weight: float = 1.0, perceptual_weight: float = 0.01,
                         ssim_weight: float = 0.1, **kwargs) -> CombinedLoss:
    """Factory of the JAX package's `create_loss_function`; ``vgg_params``
    and ``device`` pass through, any other keyword must be a LossConfig
    field."""
    vgg_params = kwargs.pop("vgg_params", None)
    device = kwargs.pop("device", None)
    cfg = LossConfig(l1_weight=l1_weight, perceptual_weight=perceptual_weight,
                     ssim_weight=ssim_weight)
    for k, v in kwargs.items():
        if not hasattr(cfg, k):
            raise TypeError(f"create_loss_function got unknown argument {k!r} "
                            f"(valid: LossConfig fields)")
        setattr(cfg, k, v)
    return CombinedLoss(cfg, vgg_params=vgg_params, device=device)
