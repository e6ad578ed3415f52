"""Epoch-granular LR schedules with PyTorch scheduler semantics (port of
`facesr/training/schedules.py`). Each is a host function of the epoch
index, stepped once an epoch; the trainer writes the value into the
optimiser state between epochs (`optim.set_learning_rate`)."""

from __future__ import annotations

import math
from typing import Optional

__all__ = ["cosine_annealing", "step_lr", "ReduceLROnPlateau", "compute_lr"]


def cosine_annealing(base_lr: float, epoch: int, T_max: int, eta_min: float = 0.0) -> float:
    """`torch.optim.lr_scheduler.CosineAnnealingLR` closed form."""
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / T_max)) / 2


def step_lr(base_lr: float, epoch: int, step_size: int, gamma: float = 0.5) -> float:
    """`torch.optim.lr_scheduler.StepLR` closed form."""
    return base_lr * (gamma ** (epoch // step_size))


class ReduceLROnPlateau:
    """`torch.optim.lr_scheduler.ReduceLROnPlateau(mode='max', factor=0.5,
    patience=5)` with the relative threshold 1e-4."""

    def __init__(self, base_lr: float, mode: str = "max", factor: float = 0.5,
                 patience: int = 5, min_lr: float = 0.0, threshold: float = 1e-4):
        self.lr = base_lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = None
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if self.best is None:
            self.best = metric
        else:
            if self.mode == "max":
                improved = metric > self.best * (1.0 + self.threshold)
            else:
                improved = metric < self.best * (1.0 - self.threshold)
            if improved:
                self.best = metric
                self.num_bad = 0
            else:
                self.num_bad += 1
                if self.num_bad > self.patience:
                    self.lr = max(self.lr * self.factor, self.min_lr)
                    self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad = d["num_bad"]


def compute_lr(scheduler_type: str, base_lr: float, epoch: int, T_max: int = 50,
               eta_min: float = 1e-7, step_size: int = 10, gamma: float = 0.5,
               plateau: Optional[ReduceLROnPlateau] = None) -> float:
    """LR of the given epoch. PyTorch schedulers step after each epoch, so
    epoch e trains at the schedule evaluated at e (epoch 0 at base_lr)."""
    if scheduler_type == "cosine":
        return cosine_annealing(base_lr, epoch, T_max, eta_min)
    if scheduler_type == "step":
        return step_lr(base_lr, epoch, step_size, gamma)
    if scheduler_type == "plateau":
        return plateau.lr if plateau is not None else base_lr
    return base_lr
