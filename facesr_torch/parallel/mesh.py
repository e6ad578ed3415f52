"""The port's mesh: the `data` axis and the `data,space` grid (port of
`facesr/parallel/mesh.py`).

PyTorch's idiom for data parallelism is one process per card: the ranks of
a `torch.distributed` group make up the `data` axis. Each rank holds a
full replica of the training state and its own rows of the global batch;
the train steps all-reduce the gradients explicitly (the mean over the
ranks, one flat bucket per dtype) where XLA inserts its psum, so every
rank applies the same update and the replicas stay bitwise equal. State
is made equal at start and after every resume by a broadcast from rank 0
(`replicate`).

On a 2-D ``("data", "space")`` mesh of shape (d, s) the ranks form a grid,
rank ``r`` at ``(r // s, r % s)``: the s ranks of a grid row (a `space`
group) hold the same batch rows and split their image rows
(`parallel.spatial`: halo exchanges, global means and the bicubic skip's
gather), and the d ranks of a column (a `data` group) hold the same image
rows of other batch rows. Every rank creates every group, in one order
(NCCL and gloo hang otherwise).

A `Mesh` is either that (a group of ranks, one device each: training) or,
for serving, the devices one process drives (`ShardedPredictor`: a
weight replica a device, the rows of a request split over them;
`SpatialPredictor`: the image rows split over them). The collectives used
are `all_reduce` and `broadcast` only: gloo supports no other on CUDA
tensors, and two ranks sharing one card (NCCL refuses that) run over
gloo.

Every training step runs on the grid: the content, GAN and QAT steps and
the eval step. The `model` (tp) and `pp` axes and three axes raise
`NotPorted` and name their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["NotPorted", "Mesh", "Sharding", "get_mesh", "check_mesh_axes", "replicated",
           "batch_sharding", "row_sharding", "grid_sharding", "tp_param_shardings",
           "shard_batch", "replicate", "pad_to_multiple", "all_reduce_mean",
           "all_reduce_sum", "all_reduce_max", "DEFAULT_TIMEOUT_S", "ROADMAP_ITEMS"]

# seconds a collective (and joining the group) waits for a peer: a lost
# rank fails the run instead of hanging it
DEFAULT_TIMEOUT_S = 600.0

ROADMAP_ITEMS = {
    "model": "ROADMAP A.13.3 (tp: conv channels over ranks)",
    "pp": "ROADMAP A.13.4 (pp: the residual groups as a pipeline)",
    "compositions": "ROADMAP A.13.5 (compositions of the mesh axes)",
}


class NotPorted(NotImplementedError):
    """A part of the JAX package the port does not have yet; the message
    names its ROADMAP item."""


@dataclass(frozen=True)
class Mesh:
    """The `data` axis, or the `data,space` grid. ``devices``: the devices
    this process drives (one for a rank of a training group; several for
    serving); ``group``: the process group of all the ranks (None: this
    process alone); ``shape``: the grid's (d, s), or None for the 1-D
    `data` axis; ``axis_groups``: this rank's process group along each
    axis of a grid (``{"data": its column, "space": its row}``)."""

    devices: Tuple[torch.device, ...]
    group: Optional[Any] = None
    rank: int = 0
    world_size: int = 1
    axis_names: Tuple[str, ...] = ("data",)
    shape: Optional[Tuple[int, ...]] = None
    axis_groups: Optional[Dict[str, Any]] = field(default=None, compare=False)

    @property
    def size(self) -> int:
        """Every device of every rank."""
        return self.world_size * len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def space_size(self) -> int:
        """The `space` axis's length (1 without one)."""
        return self.shape[self.axis_names.index("space")] if "space" in self.axis_names else 1

    @property
    def data_size(self) -> int:
        """The `data` axis's length: the batch's divisor."""
        return self.size // self.space_size

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (data, space) coordinates."""
        return divmod(self.rank, self.space_size)

    def row_shard(self):
        """This rank's `parallel.spatial.RankShard` of its `space` group
        (None without a `space` axis of two or more ranks)."""
        from facesr_torch.parallel.spatial import RankShard

        if self.space_size < 2 or not self.distributed:
            return None
        return RankShard(self.axis_groups["space"], self.coords[1], self.space_size)


class Sharding(NamedTuple):
    """How a tensor lies on a mesh: ``spec`` names the mesh axis each
    tensor axis is split over (None: whole), as JAX's PartitionSpec: ()
    replicated, ("data",) the batch, (None, "data") the image rows,
    ("data", "space") the batch and the image rows."""

    mesh: Mesh
    spec: Tuple[str, ...]


def check_mesh_axes(axis_names: Sequence[str], shape: Optional[Sequence[int]] = None) -> None:
    """Let the 1-D `data` axis and the `data,space` grid through; raise
    `NotPorted` for `model` (A.13.3), `pp` (A.13.4) and three axes (A.13.5),
    and ValueError for a shape that does not fit the axes."""
    axes = tuple(axis_names)
    if not axes or axes[0] != "data":
        raise ValueError(f"mesh axes must start with the batch axis 'data', got {axes}")
    extra = [a for a in axes[1:] if a not in ("space", "model", "pp")]
    if extra:
        raise ValueError(f"Unknown mesh axes {extra}; supported extra axes: space, model, pp")
    if len(axes) > 2:
        raise NotPorted(f"mesh axes {','.join(axes)}: three axes are "
                        f"{ROADMAP_ITEMS['compositions']}")
    if len(axes) == 2 and axes[1] != "space":
        raise NotPorted(f"mesh axes {','.join(axes)}: {axes[1]} is {ROADMAP_ITEMS[axes[1]]}; "
                        f"the port has the data axis and data,space")
    if shape is not None and len(tuple(shape)) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not fit the mesh axes "
                         f"{','.join(axes)}: give one length an axis")


def _local_card(local_rank: int) -> int:
    """The card of a local rank: its index, wrapped around the visible
    cards when there are fewer (ranks then share cards)."""
    cards = torch.cuda.device_count()
    return local_rank % cards if cards else local_rank


def _rank_device(devices, local_rank: int) -> torch.device:
    """The device of a rank: ``devices``' one entry (an index-less ``cuda``
    is this rank's card, `_local_card`) or `_local_card`."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != 1:
            raise ValueError(f"a rank of a data-parallel group drives one device, got {devs} "
                             "(launch one process per card)")
        if devs[0].type == "cuda" and devs[0].index is None:
            return torch.device("cuda", _local_card(local_rank))
        return devs[0]
    if not torch.cuda.is_available():
        raise RuntimeError("facesr_torch runs on CUDA by default and no CUDA device is "
                           "available; pass devices=['cpu'] to run a rank on the CPU")
    return torch.device("cuda", _local_card(local_rank))


def _backend(device: torch.device, backend: Optional[str], local_ranks: int) -> str:
    """``backend``, else NCCL on CUDA and gloo on the CPU. NCCL takes one
    rank a card, so more local ranks than cards over NCCL are refused:
    sharing the cards over gloo is the caller's explicit choice."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    cards = torch.cuda.device_count()
    if backend == "nccl" and local_ranks > cards:
        raise ValueError(f"{local_ranks} ranks on this host over NCCL, which takes one rank a "
                         f"card, and {cards} card(s) are visible: start at most {cards} ranks, "
                         "or share the cards over gloo (backend='gloo'; the train CLI's "
                         "--dist-backend gloo)")
    return backend


def _join(devices, rank, world_size, local_rank, init_method, backend, timeout) -> Mesh:
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
        local_rank = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
        device = _rank_device(devices, local_rank)
        return Mesh((device,), dist.group.WORLD, rank, world_size)
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    device = _rank_device(devices, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)  # before the group: NCCL binds the current device
    backend = _backend(device, backend, int(env.get("LOCAL_WORLD_SIZE", 1)))
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return Mesh((device,), dist.group.WORLD, rank, world_size)


def _grid(mesh: Mesh, axis_names: Tuple[str, ...], shape, timeout: float) -> Mesh:
    """The ranks of ``mesh`` as the (d, s) `data,space` grid: rank r at
    (r // s, r % s), with a process group for every grid row (`space`)
    and every column (`data`), created by every rank in one order."""
    n = mesh.world_size
    if len(axis_names) == 1:
        if shape is not None and tuple(shape) != (n,):
            raise ValueError(f"mesh shape {tuple(shape)} does not match the {n} rank(s) of "
                             "the data axis")
        return mesh
    if shape is None:
        raise ValueError("mesh_shape is required with multiple mesh_axes, e.g. "
                         "mesh_shape: [4, 2] for 'data,space' on 8 chips")
    d, s = (int(v) for v in shape)
    if d * s != n:
        raise ValueError(f"mesh shape {(d, s)} needs {d * s} ranks, the group has {n}")
    kw = dict(timeout=datetime.timedelta(seconds=timeout))
    groups = {}
    for i in range(d):
        g = dist.new_group(list(range(i * s, (i + 1) * s)), **kw)
        if i == mesh.rank // s:
            groups["space"] = g
    for j in range(s):
        g = dist.new_group(list(range(j, n, s)), **kw)
        if j == mesh.rank % s:
            groups["data"] = g
    return dataclasses.replace(mesh, axis_names=tuple(axis_names), shape=(d, s),
                               axis_groups=groups)


def get_mesh(devices: Optional[Sequence[Any]] = None, axis_names: Sequence[str] = ("data",),
             shape: Optional[Sequence[int]] = None, *, rank: Optional[int] = None,
             world_size: Optional[int] = None, local_rank: Optional[int] = None,
             init_method: Optional[str] = None, backend: Optional[str] = None,
             timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The `data` mesh, or the `data,space` grid of ``shape`` (d, s).

    Training (a group of ranks): when a process group is initialised, when
    ``rank``/``world_size`` are given, or when torchrun's environment is
    set (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/
    ``MASTER_PORT``), this process joins (or reuses) the default group.
    Its device is ``devices[0]`` or ``cuda:<local rank>`` (modulo the
    visible cards), made current before the group starts; the backend is
    NCCL on CUDA and gloo on the CPU unless ``backend`` names one (ranks
    that share a card need gloo: over NCCL, more ranks than cards, by
    torchrun's ``LOCAL_WORLD_SIZE``, are refused); ``timeout`` bounds the
    join and every collective. ``init_method`` defaults to ``env://``. On a grid the
    d * s ranks also create the process groups of its rows and columns.

    Serving (this process alone): a mesh over ``devices``, by default every
    visible card. A device may repeat (``["cpu", "cpu"]``).

    The `model` and `pp` axes raise `NotPorted`."""
    axes = tuple(axis_names)
    check_mesh_axes(axes, shape)
    joining = (dist.is_initialized() or rank is not None or world_size is not None
               or "WORLD_SIZE" in os.environ)
    if joining:
        return _grid(_join(devices, rank, world_size, local_rank, init_method, backend,
                           timeout), axes, shape, timeout)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("facesr_torch runs on CUDA by default and no CUDA device is "
                               "available; pass devices=['cpu'] for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("get_mesh: no devices")
    if shape is not None and int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} needs {int(np.prod(shape))} devices, "
                         f"got {len(devs)}")
    if len(axes) == 2 and shape is None:
        shape = (len(devs), 1)
    return Mesh(devs, axis_names=axes, shape=None if len(axes) == 1 else tuple(shape))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """The leading (batch) axis split over ``axis``."""
    check_mesh_axes((axis,) if axis == "data" else ("data", axis))
    return Sharding(mesh, (axis,))


def row_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """NHWC images split along H over ``axis``: the spatial-parallel
    sharding (`SpatialPredictor`); the batch is whole on every shard."""
    check_mesh_axes((axis,) if axis == "data" else ("data", axis))
    return Sharding(mesh, (None, axis))


def grid_sharding(mesh: Mesh, batch_axis: str = "data", row_axis: str = "space") -> Sharding:
    """NHWC batch over ``batch_axis`` and image rows over ``row_axis``: dp x
    sp on a 2-D mesh (the Trainer's ``mesh_axes: data,space``)."""
    check_mesh_axes((batch_axis, row_axis))
    return Sharding(mesh, (batch_axis, row_axis))


def tp_param_shardings(params: Any, mesh: Mesh, axis: str = "data") -> Any:
    raise NotPorted(f"tp_param_shardings (conv kernels over output channels) is "
                    f"{ROADMAP_ITEMS['model']}")


def _axis_index(mesh: Mesh, axis: str) -> Tuple[int, int]:
    """This rank's index along ``axis`` and the axis's length."""
    if axis == "space":
        return mesh.coords[1], mesh.space_size
    if "space" in mesh.axis_names:
        return mesh.coords[0], mesh.data_size
    return mesh.rank, mesh.world_size


def shard_batch(batch: Any, mesh: Union[Mesh, Sharding], axis: str = "data") -> Any:
    """This rank's part of a global batch (a tensor, an array or a dict of
    them): under ``mesh`` (or ``batch_sharding(mesh, axis)``) its slice of
    the leading axis, the ``i``-th of the axis's equal contiguous slices;
    under a `Sharding` its part of every axis the spec names (a
    `grid_sharding`: its batch rows and its image rows). Each must divide."""
    sharding = mesh if isinstance(mesh, Sharding) else batch_sharding(mesh, axis)
    if isinstance(batch, dict):
        return {k: shard_batch(v, sharding) for k, v in batch.items()}
    out = batch
    for dim, name in enumerate(sharding.spec):
        if name is None:
            continue
        i, n = _axis_index(sharding.mesh, name)
        size = out.shape[dim]
        if size % n:
            if dim == 0:
                raise ValueError(f"shard_batch: {size} rows do not split over {n} ranks "
                                 "(pad_to_multiple first)")
            raise ValueError(f"image height {size} must divide over the {n}-way {name!r} axis "
                             f"(pick a height divisible by {n})")
        per = size // n
        out = out[(slice(None),) * dim + (slice(i * per, (i + 1) * per),)]
    return out


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a dict / list / tuple / module tree, in a fixed order
    (a module: its parameters, then its buffers)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for k in tree for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _bucketed(tensors: Sequence[torch.Tensor], collective,
              in_place: bool) -> List[torch.Tensor]:
    """Run ``collective(flat)`` on one flat copy of the tensors of each
    (dtype, device). ``in_place``: write the result back into the tensors
    (and return them); otherwise return views of the flat results."""
    tensors = list(tensors)
    buckets: Dict[Tuple[torch.dtype, torch.device], List[int]] = {}
    for i, t in enumerate(tensors):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    out = list(tensors)
    with torch.no_grad():
        for idx in buckets.values():
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
            collective(flat)
            offset = 0
            for i in idx:
                view = flat[offset:offset + tensors[i].numel()].view_as(tensors[i])
                if in_place:
                    tensors[i].copy_(view)
                else:
                    out[i] = view
                offset += tensors[i].numel()
    return out


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Make every tensor of ``tree`` (a module, a dict / list of tensors, or
    a tensor) equal to rank 0's, in place, by broadcast; without a group a
    no-op. Returns ``tree``."""
    if mesh.distributed:
        _bucketed(_tensors(tree), lambda flat: dist.broadcast(flat, src=0, group=mesh.group),
                  in_place=True)
    return tree


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (new tensors, views of one flat
    bucket per dtype and device): a sum by ``all_reduce``, divided by the
    world size. With one rank the values are bitwise the inputs."""
    def mean(flat: torch.Tensor) -> None:
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world_size)

    return _bucketed(tensors, mean, in_place=False)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward is the sum of the ranks'
    upstream gradients: each rank's loss reads the reduced value, so its
    input's gradient gathers every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (the global
    BatchNorm's statistics)."""
    return _AllReduceSum.apply(x, mesh.group)


def all_reduce_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks (a new tensor)."""
    y = x.clone()
    if mesh.distributed:
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group)
    return y


def pad_to_multiple(array: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading axis to a multiple by repeating the last element.
    Returns (padded, valid_count)."""
    n = array.shape[0]
    if n == 0:
        raise ValueError("pad_to_multiple: empty batch (0 rows)")
    rem = n % multiple
    if rem == 0:
        return array, n
    pad = np.repeat(array[-1:], multiple - rem, axis=0)
    return np.concatenate([array, pad], axis=0), n
