"""AdamW with global-norm clipping, gradient accumulation and a non-finite
guard, as plain tensor code that follows the optax chain of the JAX
package's `make_optimizer` (`facesr/training/steps.py:89-134`):

    apply_if_finite(MultiSteps(chain(clip_by_global_norm, adamw)))

`torch.optim.AdamW` with `clip_grad_norm_` would differ: the clip there
scales by ``max_norm / (norm + 1e-6)`` on every step, while optax scales by
``max_norm / norm`` and only when ``norm >= max_norm``.

- AdamW: eps 1e-8 outside the square root, bias correction from the inner
  step count, decoupled decay ``lr * wd * p`` on every leaf;
  ``p += -lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)``.
- The learning rate is a tensor in the state, changed between epochs by
  `set_learning_rate`.
- ``accumulation_steps = k > 1`` (optax.MultiSteps): the running mean of k
  gradients goes through the inner chain, whose update and state are kept
  on every k-th step only.
- ``skip_nonfinite = n > 0`` (optax.apply_if_finite): a step with a
  non-finite gradient leaves params and every moment untouched and counts
  ``total_notfinite``; after more than n bad steps in a row the update
  goes through.

Every decision is a device tensor (``torch.where``), so an update never
waits for the card. The state is a dict of tensors (``torch.save`` writes
it), keyed by parameter name. The optimiser updates the parameters it is
given, so a model with frozen parameters (``requires_grad`` False, the
transfer model's stages) is the JAX package's
``multi_transform({"frozen": set_to_zero, "train": chain(clip, adamw)})``:
the global norm, the decay and the moments cover the trained leaves only.

`StageAdamW` is the transfer model's `make_stage_optimizer`
(`facesr/models/transfer.py:193-212`): ``chain(clip_by_global_norm,
multi_transform(frozen: set_to_zero, backbone: adamw(backbone_lr) or
set_to_zero when it is 0, head: adamw(head_lr)))`` with fixed learning
rates (the epoch schedule does not reach them, as in JAX). Its clip comes
before the split, so its global norm covers every leaf, frozen ones
included: with clipping on it asks for their gradients too
(``needs_frozen_grads``).

Under tensor or pipeline parallelism (``update(..., shard=)``, a
`parallel.tensor.ModelShard` or a `parallel.pipeline.PipeShard`) a
parameter marked as this rank's part (a slice of its channels, or under
pp a residual group's leaf, empty on the stages that do not hold it) has
that part's gradient: the clip's global norm (`global_norm`) sums those
leaves' squares over the group and counts each whole leaf once, so every
rank clips by the whole gradient's norm, and the non-finite guard takes
one decision for the group. Everything else is per leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from facesr_torch.parallel import tensor

__all__ = ["AdamW", "StageAdamW", "set_learning_rate", "global_norm"]

Tensors = Dict[str, torch.Tensor]


class AdamW:
    """The JAX package's `make_optimizer(weight_decay, gradient_clip,
    accumulation_steps, b1, b2, skip_nonfinite)`; ``init`` builds the
    state, ``update`` applies one step to the parameters in place."""

    eps = 1e-8  # optax's adamw default, which the JAX package keeps

    def __init__(self, weight_decay: float = 1e-4, gradient_clip: float = 1.0,
                 accumulation_steps: int = 1, b1: float = 0.9, b2: float = 0.999,
                 skip_nonfinite: int = 0):
        if accumulation_steps < 1:
            raise ValueError(f"accumulation_steps must be >= 1, got {accumulation_steps}")
        self.weight_decay = weight_decay
        self.gradient_clip = gradient_clip
        self.accumulation_steps = accumulation_steps
        self.b1, self.b2 = b1, b2
        self.skip_nonfinite = skip_nonfinite

    def init(self, params: Tensors, learning_rate: float = 0.0) -> Dict[str, Any]:
        dev = next(iter(params.values())).device

        def scalar(v, dtype=torch.int32):
            return torch.tensor(v, dtype=dtype, device=dev)

        def zeros():
            return {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                    for n, p in params.items()}

        state = {"lr": scalar(learning_rate, torch.float32), "count": scalar(0),
                 "mu": zeros(), "nu": zeros()}
        if self.accumulation_steps > 1:
            state.update(mini_step=scalar(0), gradient_step=scalar(0), acc=zeros())
        if self.skip_nonfinite > 0:
            state.update(notfinite_count=scalar(0), last_finite=scalar(True, torch.bool),
                         total_notfinite=scalar(0))
        return state

    def _clip(self, grads: Tensors, params: Tensors, shard) -> Tensors:
        """optax.clip_by_global_norm over ``grads``."""
        if not (self.gradient_clip and self.gradient_clip > 0):
            return grads
        norm = global_norm(grads, params, shard)
        keep = norm < self.gradient_clip
        return {n: torch.where(keep, g, (g / norm) * self.gradient_clip)
                for n, g in grads.items()}

    def _neg_lr(self, name: str, state: Dict[str, Any]):
        """The negated learning rate of parameter ``name`` (None: no update)."""
        return -state["lr"]

    def _inner(self, grads: Tensors, state: Dict[str, Any], params: Tensors, shard=None):
        """clip_by_global_norm -> adamw: (updates, new count, mu, nu)."""
        grads = self._clip(grads, params, shard)
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        bc1 = 1 - torch.pow(b1, count.float())
        bc2 = 1 - torch.pow(b2, count.float())
        mu, nu, updates = {}, {}, {}
        for n, g in grads.items():
            neg_lr = self._neg_lr(n, state)
            if neg_lr is None:  # set_to_zero: no update, no moments
                mu[n], nu[n] = state["mu"][n], state["nu"][n]
                continue
            mu[n] = (1 - b1) * g + b1 * state["mu"][n]
            nu[n] = (1 - b2) * (g * g) + b2 * state["nu"][n]
            u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + self.eps)
            u = u + self.weight_decay * params[n]
            updates[n] = neg_lr * u
        return updates, count, mu, nu

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict[str, Any], params: Tensors,
               shard: Optional["tensor.GroupShard"] = None) -> None:
        """One optimiser step: ``params`` (by name, the tensors training
        reads) and ``state`` are updated in place. ``shard``: the `model`
        shard or the `pp` stage whose parts the marked parameters are (tp,
        pp)."""
        new: Dict[str, Any] = {}
        if self.skip_nonfinite > 0:  # judged on the incoming gradients
            finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
            if shard is not None:
                finite = shard.all(finite)
        if self.accumulation_steps > 1:
            mini = state["mini_step"]
            grads = {n: a + (grads[n] - a) / (mini + 1) for n, a in state["acc"].items()}
        updates, new["count"], new["mu"], new["nu"] = self._inner(grads, state, params, shard)
        if self.accumulation_steps > 1:
            emit = mini == self.accumulation_steps - 1
            updates = {n: emit * u for n, u in updates.items()}
            for key in ("count", "mu", "nu"):
                new[key] = _select(emit, new[key], state[key])
            new["acc"] = {n: (~emit) * a for n, a in grads.items()}
            new["mini_step"] = (mini + 1) % self.accumulation_steps
            new["gradient_step"] = torch.where(emit, state["gradient_step"] + 1,
                                               state["gradient_step"])
        if self.skip_nonfinite > 0:
            bad_run = torch.where(finite, 0, state["notfinite_count"] + 1).to(torch.int32)
            take = finite | (bad_run > self.skip_nonfinite)
            updates = {n: torch.where(take, u, 0.0) for n, u in updates.items()}
            new = {k: _select(take, v, state[k]) for k, v in new.items()}
            new["notfinite_count"] = bad_run
            new["last_finite"] = finite
            new["total_notfinite"] = torch.where(finite, state["total_notfinite"],
                                                 state["total_notfinite"] + 1)
        state.update(new)
        for n, u in updates.items():
            params[n].add_(u)


class StageAdamW(AdamW):
    """The transfer model's per-group optimiser (`make_stage_optimizer` in
    `models.transfer`): ``labels`` maps every parameter name to 'frozen',
    'backbone' or 'head'; 'head' trains at ``head_lr``, 'backbone' at
    ``backbone_lr`` (no update when it is 0), 'frozen' never. The learning
    rates are fixed: `set_learning_rate` leaves them alone. With
    ``gradient_clip`` the global norm covers every parameter given,
    frozen ones included (``needs_frozen_grads``)."""

    def __init__(self, labels: Dict[str, str], head_lr: float, backbone_lr: float,
                 weight_decay: float = 0.0, gradient_clip: float = 0.0,
                 skip_nonfinite: int = 0):
        super().__init__(weight_decay=weight_decay, gradient_clip=gradient_clip,
                         skip_nonfinite=skip_nonfinite)
        self.labels = dict(labels)
        self.lrs = {"head": head_lr, "backbone": backbone_lr, "frozen": 0.0}

    @property
    def needs_frozen_grads(self) -> bool:
        return bool(self.gradient_clip and self.gradient_clip > 0)

    def init(self, params: Tensors, learning_rate: float = 0.0) -> Dict[str, Any]:
        state = super().init(params, learning_rate)
        del state["lr"]  # fixed per-group rates, no injected hyperparameter
        return state

    def _neg_lr(self, name: str, state: Dict[str, Any]):
        lr = self.lrs[self.labels[name]]
        return -lr if lr > 0 else None


def global_norm(grads: Tensors, params: Tensors, shard=None) -> torch.Tensor:
    """The L2 norm of the whole gradient: with a `model` or `pp` ``shard``,
    the squares of the marked (split) parameters' parts summed over the
    group, and each whole parameter's counted once."""
    sq = [torch.sum(g * g) for g in grads.values()]
    if shard is None:
        return torch.sqrt(sum(sq))
    split = [tensor.is_split(params[n]) for n in grads]
    zero = torch.zeros((), dtype=sq[0].dtype, device=sq[0].device)
    parts = shard.sum(sum((s for s, p in zip(sq, split) if p), zero))
    return torch.sqrt(sum((s for s, p in zip(sq, split) if not p), zero) + parts)


def _select(cond: torch.Tensor, new: Any, old: Any) -> Any:
    """``torch.where(cond, new, old)`` over a tensor or a dict of them."""
    if isinstance(new, dict):
        return {k: torch.where(cond, v, old[k]) for k, v in new.items()}
    return torch.where(cond, new, old)


def set_learning_rate(state: Dict[str, Any], lr: float) -> None:
    """Write the learning rate of the next steps into ``state`` (in place,
    on the device: no copy from the host). A state without an injected
    rate (`StageAdamW`'s) is left alone, as the JAX package's
    `set_learning_rate` finds no hyperparameter there."""
    if "lr" in state:
        state["lr"].fill_(lr)
