"""The port's `data` mesh (port of `facesr/parallel/mesh.py`).

PyTorch's idiom for data parallelism is one process per card: the ranks of
a `torch.distributed` group make up the `data` axis. Each rank holds a
full replica of the training state and its own rows of the global batch;
the train steps all-reduce the gradients explicitly (the mean over the
ranks, one flat bucket per dtype) where XLA inserts its psum, so every
rank applies the same update and the replicas stay bitwise equal. State
is made equal at start and after every resume by a broadcast from rank 0
(`replicate`).

A `Mesh` is either that (a group of ranks, one device each: training) or,
for serving, the devices one process drives (`ShardedPredictor`: a
weight replica a device, the rows of a request split over them). The
collectives used are `all_reduce` and `broadcast` only: gloo supports no
other on CUDA tensors, and two ranks sharing one card (NCCL refuses that)
run over gloo.

The `space` (sp), `model` (tp) and `pp` axes and their compositions are
not ported: they raise `NotPorted` and name their ROADMAP item.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

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
    "space": "ROADMAP A.13.2 (sp: image rows over ranks)",
    "model": "ROADMAP A.13.3 (tp: conv channels over ranks)",
    "pp": "ROADMAP A.13.4 (pp: the residual groups as a pipeline)",
    "compositions": "ROADMAP A.13.5 (compositions of the mesh axes)",
}


class NotPorted(NotImplementedError):
    """A part of the JAX package the port does not have yet; the message
    names its ROADMAP item."""


@dataclass(frozen=True)
class Mesh:
    """The `data` axis. ``devices``: the devices this process drives (one
    for a rank of a training group; several for serving); ``group``: the
    process group of the ranks (None: this process alone)."""

    devices: Tuple[torch.device, ...]
    group: Optional[Any] = None
    rank: int = 0
    world_size: int = 1
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        """The `data` axis's length: every device of every rank."""
        return self.world_size * len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def distributed(self) -> bool:
        return self.group is not None


class Sharding(NamedTuple):
    """How a tensor lies on a mesh: ``spec`` () replicated, ("data",) its
    leading axis split over the ranks."""

    mesh: Mesh
    spec: Tuple[str, ...]


def check_mesh_axes(axis_names: Sequence[str], shape: Optional[Sequence[int]] = None) -> None:
    """Raise `NotPorted` for any mesh but the 1-D `data` axis."""
    axes = tuple(axis_names)
    if not axes or axes[0] != "data":
        raise ValueError(f"mesh axes must start with the batch axis 'data', got {axes}")
    extra = [a for a in axes[1:] if a not in ("space", "model", "pp")]
    if extra:
        raise ValueError(f"Unknown mesh axes {extra}; supported extra axes: space, model, pp")
    if len(axes) > 1:
        item = ROADMAP_ITEMS[axes[1]] if len(axes) == 2 else ROADMAP_ITEMS["compositions"]
        raise NotPorted(f"mesh axes {','.join(axes)}: the port has the data axis only; "
                        f"{axes[1]} is {item}; compositions with data are "
                        f"{ROADMAP_ITEMS['compositions']}")
    if shape is not None and len(tuple(shape)) > 1:
        raise NotPorted(f"mesh shape {tuple(shape)}: a multi-axis mesh is "
                        f"{ROADMAP_ITEMS['compositions']}; the data axis takes no shape")


def _rank_device(devices, local_rank: int) -> torch.device:
    """The device of a rank: ``devices``' one entry (an index-less ``cuda``
    is this rank's card, ``cuda:<local_rank>``) or ``cuda:<local_rank>``."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != 1:
            raise ValueError(f"a rank of a data-parallel group drives one device, got {devs} "
                             "(launch one process per card)")
        if devs[0].type == "cuda" and devs[0].index is None:
            return torch.device("cuda", local_rank)
        return devs[0]
    if not torch.cuda.is_available():
        raise RuntimeError("facesr_torch runs on CUDA by default and no CUDA device is "
                           "available; pass devices=['cpu'] to run a rank on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


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
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return Mesh((device,), dist.group.WORLD, rank, world_size)


def get_mesh(devices: Optional[Sequence[Any]] = None, axis_names: Sequence[str] = ("data",),
             shape: Optional[Sequence[int]] = None, *, rank: Optional[int] = None,
             world_size: Optional[int] = None, local_rank: Optional[int] = None,
             init_method: Optional[str] = None, backend: Optional[str] = None,
             timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The `data` mesh.

    Training (a group of ranks): when a process group is initialised, when
    ``rank``/``world_size`` are given, or when torchrun's environment is
    set (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/
    ``MASTER_PORT``), this process joins (or reuses) the default group.
    Its device is ``devices[0]`` or ``cuda:<local rank>``, made current
    before the group starts; the backend is NCCL on CUDA and gloo on the
    CPU unless ``backend`` names one; ``timeout`` bounds the join and every
    collective. ``init_method`` defaults to ``env://``.

    Serving (this process alone): a mesh over ``devices``, by default every
    visible card. A device may repeat (``["cpu", "cpu"]``).

    Other axes raise `NotPorted`."""
    check_mesh_axes(axis_names, shape)
    joining = (dist.is_initialized() or rank is not None or world_size is not None
               or "WORLD_SIZE" in os.environ)
    if joining:
        return _join(devices, rank, world_size, local_rank, init_method, backend, timeout)
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
    return Mesh(devs)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    check_mesh_axes((axis,) if axis == "data" else ("data", axis))
    return Sharding(mesh, (axis,))


def row_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    raise NotPorted(f"row_sharding (image rows over the mesh) is {ROADMAP_ITEMS['space']}")


def grid_sharding(mesh: Mesh, batch_axis: str = "data", row_axis: str = "space") -> Sharding:
    raise NotPorted(f"grid_sharding (batch x rows) is {ROADMAP_ITEMS['compositions']}, "
                    f"after {ROADMAP_ITEMS['space']}")


def tp_param_shardings(params: Any, mesh: Mesh, axis: str = "data") -> Any:
    raise NotPorted(f"tp_param_shardings (conv kernels over output channels) is "
                    f"{ROADMAP_ITEMS['model']}")


def shard_batch(batch: Any, mesh: Mesh, axis: str = "data") -> Any:
    """This rank's rows of a global batch (a tensor, an array or a dict of
    them): the ``rank``-th of ``world_size`` equal contiguous slices of the
    leading axis, which must divide."""
    batch_sharding(mesh, axis)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in batch.items()}
    n = batch.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"shard_batch: {n} rows do not split over {mesh.world_size} ranks "
                         "(pad_to_multiple first)")
    per = n // mesh.world_size
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


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
