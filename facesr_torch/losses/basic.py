"""Pixel losses: L1, L2, Charbonnier (port of `facesr/losses/basic.py`).

Each mean is over the whole images under a row shard (`parallel.spatial.mean`)."""

from __future__ import annotations

import torch

from facesr_torch.parallel.spatial import mean

__all__ = ["l1_loss", "l2_loss", "charbonnier_loss"]


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return mean((pred - target).abs())


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return mean((pred - target).square())


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     epsilon: float = 1e-6) -> torch.Tensor:
    diff = pred - target
    return mean(torch.sqrt(diff * diff + epsilon * epsilon))
