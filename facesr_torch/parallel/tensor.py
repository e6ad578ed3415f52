"""Tensor parallelism (tp): the output channels of the convs split over the
ranks of a `model` group.

Port of what the JAX package's `tp_param_shardings` (`facesr/parallel/
mesh.py`) leaves to XLA's partitioner. Rank i of t holds slice i of every
leaf the rule splits (`parallel.mesh.tp_param_shardings`: axis 0 of an
OIHW conv weight, of its bias, of a PReLU alpha and of a BatchNorm
weight, bias or running stat, where it divides by t), marked with
`mark`; every other leaf is whole on every rank (the SE, a conv whose
output width does not divide, such as conv_last's 3, and the
discriminator's dense layers). A forward runs under `split(shard)`, a
thread-local context, and the ops ask `current()`:

- a conv whose weight is a marked slice (`ops.conv.conv2d`) computes only
  its output channels, with its bias slice, from the whole input, and the
  output channels of the t ranks are gathered: ``gather(conv(copy(x), w_i,
  b_i))``;
- a small per-channel leaf used on a gathered map (a PReLU alpha, a
  BatchNorm's affine and running stats) is gathered for the use.

Every replicated tensor then has the same value and the same gradient on
every rank of the group, which is what makes every gradient right. Three
operations keep it so:

- ``copy``: forward the identity, backward the sum over the group. It sits
  on the input of every split conv: each rank's slice gives only its part
  of the input's gradient.
- ``gather``: forward the all-gather along channels, backward this rank's
  slice. It sits on the output of every split conv (and on the leaves).
- ``sum``: forward the sum over the group, backward the identity (the
  clip's global norm).

(Their fourth, a slice of a replicated tensor whose backward gathers, has
no user here: each rank writes its slice of the updated running stats
without a gradient.)

So neither a replicated leaf (the SE, conv_last, the dense layers) nor a
split one needs a gradient reduction over `model`.

Every exchange is an ``all_reduce`` of a zero-filled full-size buffer into
which each rank writes its block, the sp pattern (`parallel.spatial`):
gloo has no CUDA ``all_gather``, and two ranks sharing a card run over
gloo. Low-precision floats travel as float32 (exact: the other entries
are zeros). Each shard counts its exchanges by kind (``counts``: gather,
copy, leaf, sum, all, mean), for the tests and the chip run.

Mathematically no replicated leaf needs a gradient reduction; but a GPU
kernel that sums with atomics (cuDNN's weight gradients) rounds the same
sum apart on two ranks, and replicas that differ by a bit drift apart
step by step. So the optimiser's caller averages the whole leaves'
gradients over the group (`ModelShard.mean`, one small bucket: the SE,
conv_last, D's dense layers), which leaves equal values equal.

`GroupShard` holds the group's ops that do not split channels (``copy``,
``sum``, ``all``, ``mean``); the pipeline's stages (`parallel.pipeline.
PipeShard`) share them.

The training state moves between its whole and its split form with
`shard_state` (each rank keeps its contiguous slice of every split leaf,
marking the ones a forward reads) and `unshard_state` (the slices
gathered whole, in one bucket a dtype).
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["GroupShard", "ModelShard", "split", "current", "mark", "is_split", "shard_state",
           "unshard_state", "mark_split", "state_tensors", "whole_named"]

_local = threading.local()


def current() -> Optional["ModelShard"]:
    """The `model` shard the calling thread's forward runs on (None: whole)."""
    return getattr(_local, "shard", None)


@contextlib.contextmanager
def split(shard: Optional["ModelShard"]) -> Iterator[None]:
    """Run the block on ``shard``'s channel slices (None or a group of one:
    whole)."""
    prev = current()
    _local.shard = shard if shard is not None and shard.size > 1 else None
    try:
        yield
    finally:
        _local.shard = prev


def mark(t: torch.Tensor, on: bool = True) -> torch.Tensor:
    """Mark ``t`` as this rank's slice of a split leaf (or unmark it)."""
    t._tp_split = on
    return t


def is_split(t: Any) -> bool:
    """Whether ``t`` is a marked slice (`mark`)."""
    return bool(getattr(t, "_tp_split", False))


def _wire_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype


def _blocks(shard: "ModelShard", x: torch.Tensor) -> torch.Tensor:
    """The [size, *x.shape] sum over the group of a zero buffer holding
    ``x`` at this rank's index: every rank's block, in rank order."""
    buf = torch.zeros((shard.size, *x.shape), dtype=_wire_dtype(x), device=x.device)
    buf[shard.index].copy_(x)
    dist.all_reduce(buf, group=shard.group)
    return buf


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        shard.counts["copy"] += 1
        # contiguous: the ranks' gradients may lie in other layouts (a pp
        # stage that did not read the input holds zeros), and the reduce
        # sums storage element by element
        g = grad.to(dtype=_wire_dtype(grad), memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(g, group=shard.group)
        return g.to(grad.dtype), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim, ctx.n = shard, dim, x.shape[dim]
        return torch.cat(_blocks(shard, x).to(x.dtype).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.shard.index * ctx.n, ctx.n), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        y = x.to(dtype=_wire_dtype(x), memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(y, group=shard.group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class GroupShard:
    """Rank ``index`` of the ``size`` ranks of the process group ``group``
    that holds copies of one batch (a `model` group here, a `pp` group in
    `parallel.pipeline`): the exchanges the optimiser and the steps use,
    counted by kind (``counts``)."""

    def __init__(self, group: Any, index: int, size: int):
        self.group, self.index, self.size = group, index, size
        self.counts: Counter = Counter()

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """The identity, whose backward sums the gradient over the group."""
        return _Copy.apply(x, self)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``x`` over the group; backward: the
        identity."""
        self.counts["sum"] += 1
        return _Sum.apply(x, self)

    def all(self, flag: torch.Tensor) -> torch.Tensor:
        """A bool tensor true on every rank of the group (one decision
        for all: the optimiser's non-finite guard)."""
        self.counts["all"] += 1
        bad = (~flag).to(torch.float32).reshape(1)
        dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=self.group)
        return (bad == 0).reshape(flag.shape)

    def mean(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the group of each tensor, no gradient: one
        all-reduce a (dtype, device)."""
        from facesr_torch.parallel.mesh import _bucketed

        self.counts["mean"] += 1

        def mean(flat: torch.Tensor) -> None:
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.size)

        return _bucketed(tensors, mean, in_place=False)


class ModelShard(GroupShard):
    """Rank ``index`` of the ``size`` ranks of the `model` process group
    ``group``: the exchanges the ops and the optimiser use."""

    def bounds(self, n: int) -> Tuple[int, int]:
        """This rank's [start, stop) of a split axis of length ``n``."""
        if n % self.size:
            raise ValueError(f"an axis of {n} does not split over {self.size} model ranks")
        per = n // self.size
        return self.index * per, (self.index + 1) * per

    def part(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of axis 0 of a whole tensor (a copy, no
        gradient): a leaf of the state."""
        a, b = self.bounds(t.shape[0])
        return t.detach()[a:b].clone()

    def gather(self, x: torch.Tensor, dim: int = -1, kind: str = "gather") -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order (the
        whole channels of a split conv's output); backward: this rank's
        slice of the gradient. ``kind`` is the count it adds to."""
        self.counts[kind] += 1
        return _Gather.apply(x, self, dim % x.dim())

    def whole(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every tensor's whole form (the ranks' slices along axis 0, in
        rank order), no gradient: one all-reduce a (dtype, device)."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        buckets: Dict[Tuple[torch.dtype, torch.device], List[int]] = {}
        for i, t in enumerate(tensors):
            buckets.setdefault((t.dtype, t.device), []).append(i)
        with torch.no_grad():
            for idx in buckets.values():
                flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
                buf = _blocks(self, flat)
                offset = 0
                for i in idx:
                    t = tensors[i]
                    n = t.numel()
                    out[i] = (buf[:, offset:offset + n].to(t.dtype)
                              .reshape(self.size * t.shape[0], *t.shape[1:]))
                    offset += n
        return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# the training state, whole or split


def state_tensors(state) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor of a `training.steps.TrainState`, by
    the JAX TrainState's field names: ``params/<name>`` (the model's
    parameters and buffers), ``opt_state/<key>[/<name>]``,
    ``ema_params/<name>``, ``loss_params/vgg/<i>/<w|b>``, ``d_params/<name>``,
    ``d_stats/<name>`` (D's running stats) and ``d_opt_state/...``."""
    yield from ((f"params/{n}", t) for n, t in state.model.state_dict(keep_vars=True).items())
    yield from _opt_tensors("opt_state", state.opt_state)
    for n, t in (state.ema_params or {}).items():
        yield f"ema_params/{n}", t
    for key, value in (state.loss_params or {}).items():
        if isinstance(value, torch.Tensor):
            yield f"loss_params/{key}", value
            continue
        for i, conv in enumerate(value):
            for k, t in conv.items():
                yield f"loss_params/{key}/{i}/{k}", t
    if state.disc is not None:
        yield from ((f"d_params/{n}", t) for n, t in state.disc.named_parameters())
        yield from ((f"d_stats/{n}", t) for n, t in state.disc.named_buffers())
        yield from _opt_tensors("d_opt_state", state.d_opt_state or {})


def _opt_tensors(prefix: str, opt_state: Dict[str, Any]) -> Iterator[Tuple[str, torch.Tensor]]:
    for key, value in opt_state.items():
        if isinstance(value, dict):
            yield from ((f"{prefix}/{key}/{n}", t) for n, t in value.items())
        else:
            yield f"{prefix}/{key}", value


def _split_paths(specs: Dict[str, Any]) -> set:
    return {path for path, s in specs.items() if getattr(s, "spec", s)}


# the state a forward reads: its split leaves are marked for the ops
_FORWARD_PARTS = ("params/", "ema_params/", "loss_params/", "d_params/", "d_stats/")


def shard_state(state, shard: "ModelShard", specs: Dict[str, Any]) -> None:
    """Keep, in place, this rank's slice of every leaf of ``state`` that
    ``specs`` (`parallel.mesh.tp_param_shardings` of the whole state)
    splits; the slices a forward reads are marked (`mark_split`)."""
    split_paths = _split_paths(specs)
    with torch.no_grad():
        for path, t in list(state_tensors(state)):
            if path in split_paths:
                t.data = shard.part(t)
    mark_split(state, specs)


def mark_split(state, specs: Dict[str, Any]) -> None:
    """Mark the split leaves of ``state`` that a forward reads (its
    parameters, EMA, VGG, D and D's stats), already this rank's slices:
    after a part of the state was replaced by other tensors."""
    split_paths = _split_paths(specs)
    for path, t in state_tensors(state):
        if path in split_paths and path.startswith(_FORWARD_PARTS):
            mark(t)


def unshard_state(state, shard: "ModelShard", specs: Dict[str, Any]) -> None:
    """The inverse of `shard_state`: every split leaf gathered whole, in
    place, and unmarked (a collective of the group)."""
    split_paths = _split_paths(specs)
    leaves = [t for path, t in state_tensors(state) if path in split_paths]
    for t, w in zip(leaves, shard.whole(leaves)):
        t.data = w
        mark(t, False)


def whole_named(tensors: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor],
                shard: Optional["ModelShard"]) -> Dict[str, torch.Tensor]:
    """``tensors`` (by parameter name) with the entries whose ``like``
    tensor is a marked part (a `model` slice, or a `pp` stage's leaf)
    gathered whole (a collective of the group; unchanged without a
    shard)."""
    if shard is None:
        return dict(tensors)
    names = [n for n in tensors if is_split(like[n])]
    out = dict(tensors)
    out.update(zip(names, shard.whole([tensors[n] for n in names])))
    return out

