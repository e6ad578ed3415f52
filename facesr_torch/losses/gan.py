"""GAN losses: vanilla (BCE with logits), lsgan (MSE), wgan (raw scores).

Port of `facesr/losses/gan.py`.
"""

from __future__ import annotations

import torch

__all__ = ["gan_loss", "GAN_TYPES"]

GAN_TYPES = ("vanilla", "lsgan", "wgan")


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    # the stable form: max(x, 0) - x*t + log(1 + exp(-|x|))
    return (logits.clamp_min(0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def gan_loss(prediction: torch.Tensor, is_real: bool, gan_type: str = "vanilla",
             real_label: float = 1.0, fake_label: float = 0.0) -> torch.Tensor:
    """Adversarial loss on discriminator logits."""
    if gan_type == "wgan":
        return -prediction.mean() if is_real else prediction.mean()
    target = torch.full_like(prediction, real_label if is_real else fake_label)
    if gan_type == "vanilla":
        return _bce_with_logits(prediction, target)
    if gan_type == "lsgan":
        return (prediction - target).square().mean()
    raise ValueError(f"Unknown GAN type: {gan_type}")
