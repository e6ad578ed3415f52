"""Training-dynamics monitors, callbacks and LR warmup (the port of
`facesr/training/callbacks.py`).

- `GradientMonitor`: per-parameter gradient norms, by the port's
  parameter names (the reference's module hooks named them so). ``update``
  takes a name -> tensor mapping (gradients, or the norms the steps
  compute with ``grad_norms=True``) or a module, whose ``.grad`` it reads;
  the norms are taken on the device and come to the host in one read.
  The Trainer fills one every ``log_gradients_every`` steps
  (`Trainer.gradient_monitor`). JAX names its norms by the leaves of its
  tree, where each residual group's RCAB weights are stacked into one
  leaf; `ckpt.weights` maps one naming onto the other.
- `ActivationMonitor`: statistics and dead channels of the SE attention
  weights, through the model's `get_attention_maps` (the plain f32
  trunk).
- `WeightMonitor`: the update ratio |w - w_prev| / |w_prev| of each
  parameter, over a module's parameters or a name -> tensor mapping; it
  restarts when the names or shapes change.
- `TrainingCallback`, `MetricLogger` (a JSON record per epoch) and
  `LRWarmup` (linear warmup from ``start_lr`` 1e-7, the reference's).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

__all__ = ["GradientMonitor", "ActivationMonitor", "WeightMonitor", "TrainingCallback",
           "MetricLogger", "LRWarmup"]

Tensors = Union[Mapping[str, Any], nn.Module]


def _named(tensors: Tensors, grads: bool = False) -> Dict[str, torch.Tensor]:
    """Name -> tensor of a mapping (numbers become 0-d tensors) or of a
    module's parameters (their ``.grad`` with ``grads``; parameters without
    one are left out)."""
    if isinstance(tensors, nn.Module):
        if grads:
            return {n: p.grad.detach() for n, p in tensors.named_parameters()
                    if p.grad is not None}
        return {n: p.detach() for n, p in tensors.named_parameters()}
    return {n: (t.detach() if isinstance(t, torch.Tensor) else torch.as_tensor(t))
            for n, t in tensors.items()}


def _host_norms(named: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The L2 norm of every tensor, in f32 on the first tensor's device,
    read in one transfer."""
    if not named:
        return {}
    dev = next(iter(named.values())).device
    norms = torch.stack([torch.linalg.vector_norm(t.float()).to(dev) for t in named.values()])
    return dict(zip(named, norms.tolist()))


class GradientMonitor:
    """Per-parameter gradient-norm tracking: ``update`` each sampled step,
    then ``summary`` (mean, max, min and last norm of each parameter)."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def update(self, grads: Tensors) -> Dict[str, float]:
        norms = _host_norms(_named(grads, grads=True))
        for name, norm in norms.items():
            self.history.setdefault(name, []).append(norm)
        return norms

    def global_norm(self, grads: Tensors) -> float:
        return math.sqrt(sum(v * v for v in _host_norms(_named(grads, grads=True)).values()))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.history.items():
            arr = np.asarray(vals)
            out[name] = {"mean": float(arr.mean()), "max": float(arr.max()),
                         "min": float(arr.min()), "last": float(arr[-1])}
        return out

    def vanishing_layers(self, threshold: float = 1e-7) -> List[str]:
        return [n for n, v in self.summary().items() if v["last"] < threshold]


class ActivationMonitor:
    """Statistics and dead-channel counts of the model's SE attention
    weights (``model.get_attention_maps``)."""

    def __init__(self, model: nn.Module):
        self.model = model
        self.stats: Dict[str, Dict[str, float]] = {}
        self._channel_means: Dict[str, np.ndarray] = {}

    @torch.no_grad()
    def update(self, x: torch.Tensor) -> Dict[str, Dict[str, float]]:
        maps = self.model.get_attention_maps(x)
        names = list(maps)
        flat = [maps[n].float().reshape(-1, maps[n].shape[-1]) for n in names]
        stats = torch.stack([torch.stack([a.mean(), a.std(unbiased=False),
                                          (a < 1e-3).float().mean()]) for a in flat]).tolist()
        means = torch.stack([a.mean(dim=0) for a in flat]).cpu().numpy()
        self.stats = {n: {"mean": s[0], "std": s[1], "dead_fraction": s[2]}
                      for n, s in zip(names, stats)}
        # batch-mean per channel, so dead_channels can count at any threshold
        self._channel_means = dict(zip(names, means))
        return self.stats

    def dead_channels(self, threshold: float = 1e-3) -> Dict[str, int]:
        """Channels of each layer whose batch-mean attention is below
        ``threshold``."""
        return {n: int((m < threshold).sum()) for n, m in self._channel_means.items()}


class WeightMonitor:
    """Update ratio |w - w_prev| / |w_prev| of each parameter (healthy
    training is typically near 1e-3)."""

    def __init__(self):
        self.prev: Optional[Dict[str, torch.Tensor]] = None
        self.history: Dict[str, List[float]] = {}

    @torch.no_grad()
    def update(self, params: Tensors) -> Dict[str, float]:
        named = {n: t.float().clone() for n, t in _named(params).items()}
        ratios: Dict[str, float] = {}
        if self.prev is not None:
            if ([(n, t.shape) for n, t in named.items()]
                    != [(n, t.shape) for n, t in self.prev.items()]):
                # pairing different parameter sets would give meaningless ratios
                print("WeightMonitor: params structure changed; resetting")
                self.prev = named
                return {}
            denom = _host_norms(self.prev)
            delta = _host_norms({n: named[n] - self.prev[n] for n in named})
            for n in named:
                ratios[n] = delta[n] / (denom[n] + 1e-12)
                self.history.setdefault(n, []).append(ratios[n])
        self.prev = named
        return ratios

    def summary(self) -> Dict[str, float]:
        return {n: float(np.mean(v)) for n, v in self.history.items() if v}


class TrainingCallback:
    """Base callback: every hook does nothing."""

    def on_train_begin(self, trainer) -> None: ...

    def on_train_end(self, trainer) -> None: ...

    def on_epoch_begin(self, trainer, epoch: int) -> None: ...

    def on_epoch_end(self, trainer, epoch: int, metrics: Dict[str, float]) -> None: ...

    def on_step_end(self, trainer, step: int, metrics: Dict[str, float]) -> None: ...


class MetricLogger(TrainingCallback):
    """A JSON list of each epoch's metrics, rewritten every epoch."""

    def __init__(self, log_dir: str = "training_logs", filename: str = "metrics.json"):
        self.log_path = Path(log_dir) / filename
        self.records: List[Dict[str, Any]] = []

    def on_epoch_end(self, trainer, epoch: int, metrics: Dict[str, float]) -> None:
        self.records.append({"epoch": epoch, **{k: float(v) for k, v in metrics.items()}})
        self.log_path.parent.mkdir(parents=True, exist_ok=True)
        self.log_path.write_text(json.dumps(self.records, indent=2))


class LRWarmup:
    """Linear LR warmup over the first ``warmup_steps`` steps, from
    ``start_lr`` (the reference's 1e-7: 0 would make step 0 a no-op) to
    ``base_lr``. Compose with an epoch schedule: lr = warmup(step) *
    schedule(epoch) / base."""

    def __init__(self, base_lr: float, warmup_steps: int = 500, start_lr: float = 1e-7):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr

    def __call__(self, step: int) -> float:
        if step >= self.warmup_steps or self.warmup_steps <= 0:
            return self.base_lr
        frac = step / self.warmup_steps
        return self.start_lr + (self.base_lr - self.start_lr) * frac
