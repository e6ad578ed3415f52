"""Spatial parallelism (sp): the rows of every image of a batch split over a
group of shards.

Port of what the JAX package's row sharding (`facesr/parallel/mesh.py`
`row_sharding`, `grid_sharding`) leaves to XLA's partitioner. Shard i of S
holds rows ``bounds(H)[i]`` of every image, the same number each (H must
divide). A forward runs on the shard's rows under `rows(shard)`, a
thread-local context, and the ops below ask `current()` which shard they
are on:

- a conv pads its rows with `RowShard.halo` (the neighbours' boundary
  rows; zeros at the image's top and bottom) instead of zeros, as many
  above and below as `conv_halo` plans for its kernel, padding and stride
  (a 3x3 'same' conv one each way; at stride 2 one above and none below);
  where a strided conv's output rows do not split with the shards'
  (`RowShard.conv_rows` is None), the caller gathers the whole map and
  runs unsharded from there on (the discriminator's last stride-2 convs
  on small maps);
- every mean over H (the SE pool, the loss means, SSIM's means) is the
  global one, `mean`: the shards' partial sums added by `RowShard.sum`;
- the dynamic int8 activation scale and the QAT fake-quant scale are the
  max over the shards (`RowShard.max`);
- the bicubic skip gathers the whole LR image (`RowShard.gather`) and
  computes this shard's output rows from it.

Two backends share the interface:

- `RankShard`: the ranks of a `space` process group (training). Every
  exchange is an ``all_reduce`` of a zero-padded ``[S, ...]`` buffer (gloo
  has no CUDA ``all_gather`` or ``send``), through a sum whose backward
  sums the ranks' upstream gradients (`parallel.mesh._AllReduceSum`), so a
  halo's gradient returns to the shard that owns the rows and adds there.
  Low-precision floats travel as float32 (exact: the other entries are
  zeros).
- `ThreadRows`: one process, one thread a shard (serving), meeting at a
  barrier; no gradient. On a card each thread runs on its own stream and a
  consumer's stream waits on a CUDA event recorded after the producer
  queued what it shares.

Each shard counts its exchanges by kind (``counts``: halo, sum, max,
gather), for the tests and the chip run.
"""

from __future__ import annotations

import contextlib
import math
import threading
from collections import Counter
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["RowShard", "RankShard", "ThreadRows", "rows", "current", "mean", "row_bounds",
           "conv_halo"]

# seconds a thread shard waits for the others at an exchange: a shard that
# hangs fails the call instead of hanging it
BARRIER_TIMEOUT_S = 600.0

_local = threading.local()


def current() -> Optional["RowShard"]:
    """The shard the calling thread's forward runs on (None: unsharded, or
    a group of one)."""
    return getattr(_local, "shard", None)


@contextlib.contextmanager
def rows(shard: Optional["RowShard"]) -> Iterator[None]:
    """Run the block on ``shard``'s rows (None or a group of one: unsharded)."""
    prev = current()
    _local.shard = shard if shard is not None and shard.size > 1 else None
    try:
        yield
    finally:
        _local.shard = prev


def row_bounds(h: int, parts: int) -> List[Tuple[int, int]]:
    """``parts`` equal contiguous row ranges of ``range(h)``; h must divide."""
    if h % parts:
        raise ValueError(f"{h} image rows do not split over {parts} row shards "
                         f"(pick a height divisible by {parts})")
    per = h // parts
    return [(i * per, (i + 1) * per) for i in range(parts)]


def check_slab(h: int, factor: int, what: str) -> None:
    """A pool under a row shard is local: every shard's rows must split into
    whole windows, so the windows line up with the unsharded image's."""
    if current() is not None and h % factor:
        raise ValueError(f"{what} over row shards needs a shard height divisible by the "
                         f"pooling factor {factor}, got {h} rows a shard")


def conv_halo(kernel: int, padding: int, stride: int) -> Tuple[int, int]:
    """The (top, bottom) halo rows a conv of ``kernel`` rows, row padding
    ``padding`` and ``stride`` takes from the neighbouring shards, when
    every shard's rows start on a multiple of the stride. Output row o
    reads input rows ``o * stride - padding`` on to ``+ kernel - 1``, so a
    shard's first output row reads ``padding`` rows above its own and its
    last ``kernel - padding - stride`` below: a 3x3 'same' conv (1, 1), at
    stride 2 (1, 0). A conv splits so only when the whole map's output
    has ``H / stride`` rows (``kernel - stride <= 2 * padding < kernel``);
    any other raises ValueError."""
    bottom = kernel - padding - stride
    if stride < 1 or padding < 0 or bottom < 0 or not kernel - stride <= 2 * padding < kernel:
        raise ValueError(f"a conv of kernel height {kernel}, row padding {padding} and stride "
                         f"{stride} does not split over row shards (its output rows are not "
                         f"its input rows / {stride})")
    return padding, bottom


class RowShard:
    """Shard ``index`` of ``size`` row shards: the interface the ops use."""

    size: int
    index: int

    def __init__(self, index: int, size: int):
        self.index, self.size = index, size
        self.counts: Counter = Counter()

    def bounds(self, h: int) -> List[Tuple[int, int]]:
        """Every shard's rows of an image of ``h`` rows."""
        return row_bounds(h, self.size)

    def slab(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's rows of the whole NHWC images ``x``."""
        a, b = self.bounds(x.shape[1])[self.index]
        return x[:, a:b]

    def conv_rows(self, h: int, kernel: int, padding: int,
                  stride: int) -> Optional[Tuple[int, int]]:
        """`conv_halo` of a conv over shards of ``h`` rows, or None when
        the shards' rows do not start on multiples of its stride (its
        output has fewer rows than shards, or shards that would start
        inside a stride): the caller gathers the whole map instead."""
        plan = conv_halo(kernel, padding, stride)
        return None if h % stride else plan

    def halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """``x`` (this shard's rows) with ``top`` rows of the shard above and
        ``bottom`` rows of the shard below attached; zeros beyond the
        image's top and bottom rows."""
        if top == bottom == 0:
            return x
        if x.shape[1] < max(top, bottom):
            raise ValueError(f"a row shard of {x.shape[1]} rows cannot give a halo of "
                             f"{max(top, bottom)} rows (use fewer shards)")
        self.counts["halo"] += 1
        above, below = self._halo(x, top, bottom)
        return torch.cat([above, x, below], dim=1)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``x`` over the shards."""
        self.counts["sum"] += 1
        return self._sum(x)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over the shards (no gradient)."""
        self.counts["max"] += 1
        return self._max(x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole images: every shard's rows of ``x``, in order."""
        self.counts["gather"] += 1
        return self._gather(x)

    def _halo(self, x, top, bottom):
        raise NotImplementedError

    def _sum(self, x):
        raise NotImplementedError

    def _max(self, x):
        raise NotImplementedError

    def _gather(self, x):
        raise NotImplementedError


def mean(x: torch.Tensor, dim: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``x.mean(dim)`` (all dims when None) over the whole images: under a
    row shard whose mean covers the row axis (1), the float32 sum of the
    shard's rows, summed over the shards and divided by the global count,
    in x's dtype. Unsharded it is ``x.mean`` itself."""
    shard = current()
    dims = tuple(range(x.dim())) if dim is None else tuple(d % x.dim() for d in dim)
    if shard is None or 1 not in dims:
        return x.mean() if dim is None else x.mean(dim=dims)
    count = math.prod(x.shape[d] for d in dims) * shard.size
    return (shard.sum(x.sum(dim=dims, dtype=torch.float32)) / count).to(x.dtype)


# ---------------------------------------------------------------------------
# ranks of a process group


def _wire_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype


class RankShard(RowShard):
    """This rank's shard of the ranks of a `space` process group ``group``
    (rank ``index`` of ``size`` in it)."""

    def __init__(self, group: Any, index: int, size: int):
        super().__init__(index, size)
        self.group = group

    def _sum(self, x):
        from facesr_torch.parallel.mesh import _AllReduceSum

        wire = _wire_dtype(x)
        return _AllReduceSum.apply(x.to(wire), self.group).to(x.dtype)

    def _max(self, x):
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y

    def _slots(self, x: torch.Tensor, shape, put) -> torch.Tensor:
        """The [size, *shape] zero buffer with this shard's slot filled by
        ``put(slot)``, summed over the shards (differentiable)."""
        buf = torch.zeros((self.size, *shape), dtype=_wire_dtype(x), device=x.device)
        put(buf[self.index])
        return self._sum(buf)

    def _halo(self, x, top, bottom):
        n, h, w, c = x.shape
        p = max(top, bottom)

        def put(slot):
            if bottom:  # the shard above reads these as its bottom halo
                slot[0, :, :bottom] = x[:, :bottom]
            if top:  # the shard below reads these as its top halo
                slot[1, :, :top] = x[:, h - top:]

        buf = self._slots(x, (2, n, p, w, c), put)
        i = self.index
        above = (buf[i - 1, 1, :, :top] if i > 0 else buf.new_zeros((n, top, w, c)))
        below = (buf[i + 1, 0, :, :bottom] if i + 1 < self.size
                 else buf.new_zeros((n, bottom, w, c)))
        return above.to(x.dtype), below.to(x.dtype)

    def _gather(self, x):
        n, h, w, c = x.shape

        def put(slot):
            slot.copy_(x)

        buf = self._slots(x, (n, h, w, c), put)
        return buf.permute(1, 0, 2, 3, 4).reshape(n, self.size * h, w, c).to(x.dtype)


# ---------------------------------------------------------------------------
# threads of one process


class ThreadRows:
    """``len(devices)`` row shards in one process, one thread each (shard i
    on ``devices[i]``; a device may repeat). Every exchange is a meeting
    at a barrier: each shard posts its part, reads the others' and meets
    once more before a slot is reused. A shard that fails calls `abort`,
    which breaks the barrier for the others instead of hanging them."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(torch.device(d) for d in devices)
        self._barrier = threading.Barrier(len(self.devices), timeout=BARRIER_TIMEOUT_S)
        self._slots: List[Any] = [None] * len(self.devices)

    def shards(self) -> List["ThreadShard"]:
        return [ThreadShard(self, i) for i in range(len(self.devices))]

    def abort(self) -> None:
        self._barrier.abort()

    def share(self, index: int, value: Tuple[torch.Tensor, ...]) -> List[Tuple[torch.Tensor, ...]]:
        """Every shard's ``value`` (a tuple of tensors), on this shard's
        device, ready for this shard's current stream."""
        dev = self.devices[index]
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        self._slots[index] = (value, event)
        self._barrier.wait()
        posted = list(self._slots)
        self._barrier.wait()
        return [value if j == index else tuple(_receive(t, ev, dev) for t in v)
                for j, (v, ev) in enumerate(posted)]


def _receive(t: torch.Tensor, event, dev: torch.device) -> torch.Tensor:
    """A tensor another shard's thread posted, usable on ``dev``'s current
    stream: that stream (and, for a copy between cards, the source card's)
    waits on the producer's event, and the allocator keeps the memory
    until this stream's work on it is done."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).wait_event(event)
        if dev.type == "cuda" and dev != t.device:
            torch.cuda.current_stream(dev).wait_event(event)
        t.record_stream(torch.cuda.current_stream(t.device))
    return t.to(dev)


class ThreadShard(RowShard):
    """Shard ``index`` of a `ThreadRows` group."""

    def __init__(self, rows_: ThreadRows, index: int):
        super().__init__(index, len(rows_.devices))
        self._rows = rows_

    def _share(self, *tensors: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        return self._rows.share(self.index, tensors)

    def _sum(self, x):
        parts = [v[0] for v in self._share(x)]
        total = parts[0]
        for part in parts[1:]:  # the same order on every shard
            total = total + part
        return total

    def _max(self, x):
        return torch.stack([v[0] for v in self._share(x)]).amax(dim=0)

    def _halo(self, x, top, bottom):
        n, h, w, c = x.shape
        # copies: the producer's x may be freed before a neighbour reads it
        posted = self._share(x[:, :bottom].clone(), x[:, h - top:].clone())
        i = self.index
        above = posted[i - 1][1] if i > 0 else x.new_zeros((n, top, w, c))
        below = posted[i + 1][0] if i + 1 < self.size else x.new_zeros((n, bottom, w, c))
        return above, below

    def _gather(self, x):
        return torch.cat([v[0] for v in self._share(x)], dim=1)
