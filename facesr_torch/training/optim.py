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
it), keyed by parameter name.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["AdamW", "set_learning_rate"]

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

    def _inner(self, grads: Tensors, state: Dict[str, Any], params: Tensors):
        """clip_by_global_norm -> adamw: (updates, new count, mu, nu)."""
        if self.gradient_clip and self.gradient_clip > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            keep = norm < self.gradient_clip
            grads = {n: torch.where(keep, g, (g / norm) * self.gradient_clip)
                     for n, g in grads.items()}
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        bc1 = 1 - torch.pow(b1, count.float())
        bc2 = 1 - torch.pow(b2, count.float())
        neg_lr = -state["lr"]
        mu, nu, updates = {}, {}, {}
        for n, g in grads.items():
            mu[n] = (1 - b1) * g + b1 * state["mu"][n]
            nu[n] = (1 - b2) * (g * g) + b2 * state["nu"][n]
            u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + self.eps)
            u = u + self.weight_decay * params[n]
            updates[n] = neg_lr * u
        return updates, count, mu, nu

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict[str, Any], params: Tensors) -> None:
        """One optimiser step: ``params`` (by name, the tensors training
        reads) and ``state`` are updated in place."""
        new: Dict[str, Any] = {}
        if self.skip_nonfinite > 0:  # judged on the incoming gradients
            finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        if self.accumulation_steps > 1:
            mini = state["mini_step"]
            grads = {n: a + (grads[n] - a) / (mini + 1) for n, a in state["acc"].items()}
        updates, new["count"], new["mu"], new["nu"] = self._inner(grads, state, params)
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


def _select(cond: torch.Tensor, new: Any, old: Any) -> Any:
    """``torch.where(cond, new, old)`` over a tensor or a dict of them."""
    if isinstance(new, dict):
        return {k: torch.where(cond, v, old[k]) for k, v in new.items()}
    return torch.where(cond, new, old)


def set_learning_rate(state: Dict[str, Any], lr: float) -> None:
    """Write the learning rate of the next steps into ``state`` (in place,
    on the device: no copy from the host)."""
    state["lr"].fill_(lr)
