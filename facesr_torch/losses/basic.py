"""Pixel losses: L1, L2, Charbonnier (port of `facesr/losses/basic.py`)."""

from __future__ import annotations

import torch

__all__ = ["l1_loss", "l2_loss", "charbonnier_loss"]


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().mean()


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     epsilon: float = 1e-6) -> torch.Tensor:
    diff = pred - target
    return torch.sqrt(diff * diff + epsilon * epsilon).mean()
