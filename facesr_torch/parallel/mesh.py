"""The port's mesh: the `data` axis, the `data,space`, `data,model` and
`data,pp` grids and the three-axis `data,space,model` grid (port of
`facesr/parallel/mesh.py`).

PyTorch's idiom for data parallelism is one process per card: the ranks of
a `torch.distributed` group make up the `data` axis. Each rank holds a
full replica of the training state and its own rows of the global batch;
the train steps all-reduce the gradients explicitly (the mean over the
ranks, one flat bucket per dtype) where XLA inserts its psum, so every
rank applies the same update and the replicas stay bitwise equal. State
is made equal at start and after every resume by a broadcast from rank 0
(`replicate`).

On a grid of shape (d, k), ``("data", "space")``, ``("data", "model")`` or
``("data", "pp")``, or (d, s, t), ``("data", "space", "model")`` or
``("data", "model", "space")``, rank ``r`` sits at its row-major
coordinates in that shape (the last axis fastest), as JAX reshapes its
devices. Each line of ranks along an axis is that axis's process group:
the ranks of a `space`, `model` or `pp` group hold the same batch rows,
those of a `data` group other batch rows. A `space` group splits its
image rows (`parallel.spatial`: halo exchanges, global means and the
bicubic skip's gather); a `model` group splits the output channels of the
convs (`parallel.tensor`: each rank holds its slice of every leaf
`tp_param_shardings` splits, the whole training state included); a `pp`
group runs the residual groups as a pipeline of stages
(`parallel.pipeline`: each rank holds its own groups' leaves of the state,
`pp_param_shardings`). On three axes both splits run at once: a split
conv's inner conv takes its halo rows over `space` from the whole-channel
input it was copied over `model`. Every rank creates every group, in one
order (NCCL and gloo hang otherwise). `Mesh.axis_size`, `Mesh.axis_index`
and `Mesh.axis_group` read an axis; `Mesh.sum_group` is the group whose
ranks hold different parts of one sum (the gradient mean, the metrics):
the whole group, except under `model` or `pp`, whose ranks hold copies:
then the `data` group, or on three axes the `data` x `space` plane of the
ranks that share this rank's `model` index.

A `Mesh` is either that (a group of ranks, one device each: training) or,
for serving, the devices one process drives (`ShardedPredictor`: a
weight replica a device, the rows of a request split over them;
`SpatialPredictor`: the image rows split over them). The collectives used
are `all_reduce` and `broadcast` only: gloo supports no other on CUDA
tensors, and two ranks sharing one card (NCCL refuses that) run over
gloo.

Every training step runs on every grid (QAT not under `pp`, as in JAX);
`model` with `pp` and `space` with `pp` are refused as JAX refuses them.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["NotPorted", "Mesh", "Sharding", "get_mesh", "check_mesh_axes", "check_single_host",
           "replicated",
           "batch_sharding", "row_sharding", "grid_sharding", "tp_param_shardings",
           "pp_param_shardings", "pp_stages",
           "shard_batch", "replicate", "pad_to_multiple", "all_reduce_mean",
           "all_reduce_sum", "all_reduce_max", "DEFAULT_TIMEOUT_S", "ROADMAP_ITEMS"]

# seconds a collective (and joining the group) waits for a peer: a lost
# rank fails the run instead of hanging it
DEFAULT_TIMEOUT_S = 600.0

# what the port does not have yet, by ROADMAP item (every mesh axis and
# composition is ported)
ROADMAP_ITEMS: Dict[str, str] = {}

# the axes whose ranks hold copies of one batch's sums (the loss replicated)
_COPY_AXES = ("model", "pp")


class NotPorted(NotImplementedError):
    """A part of the JAX package the port does not have yet; the message
    names its ROADMAP item."""


@dataclass(frozen=True)
class Mesh:
    """The `data` axis, or a grid (`data,space`, `data,model`, `data,pp`,
    `data,space,model`). ``devices``: the devices this process drives (one
    for a rank of a training group; several for serving); ``group``: the
    process group of all the ranks (None: this process alone); ``shape``:
    the grid's lengths in axis order, or None for the 1-D `data` axis;
    ``axis_groups``: this rank's process group along each axis of a grid
    (``{"data": ..., "space": ..., "model": ...}``), and on three axes its
    `data` x `space` plane (``"plane"``)."""

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

    def axis_size(self, name: str) -> int:
        """The length of axis ``name`` (1 for an axis the mesh lacks)."""
        if name not in self.axis_names:
            return 1
        if self.shape is None:  # the 1-D data axis
            return self.size
        return self.shape[self.axis_names.index(name)]

    def axis_index(self, name: str) -> int:
        """This rank's index along axis ``name`` (0 for an axis the mesh
        lacks): rank r sits at its row-major coordinates in the shape (of
        a (d, k) grid (r // k, r % k))."""
        if name not in self.axis_names:
            return 0
        if self.shape is None:  # the 1-D data axis
            return self.rank
        return int(np.unravel_index(self.rank, self.shape)[self.axis_names.index(name)])

    def axis_group(self, name: str) -> Any:
        """This rank's process group along axis ``name``: the whole group
        on the 1-D data axis, a line of the grid otherwise."""
        if self.shape is None or len(self.shape) == 1:
            return self.group
        return self.axis_groups[name]

    @property
    def data_size(self) -> int:
        """The `data` axis's length: the batch's divisor."""
        return self.axis_size("data")

    @property
    def _copies(self) -> bool:
        """Whether some axis's ranks hold copies of the step's sums (`model`
        and `pp`: the same batch rows, the loss replicated)."""
        return any(a in self.axis_names for a in _COPY_AXES)

    @property
    def sum_size(self) -> int:
        """The ranks of `sum_group`."""
        if not self._copies:
            return self.world_size
        return math.prod(self.axis_size(a) for a in self.axis_names if a not in _COPY_AXES)

    @property
    def sum_group(self) -> Any:
        """The group whose ranks hold different parts of the step's sums
        (the gradients, the metrics, the eval sums): the whole group; on
        `data,model` and `data,pp` the `data` group (a `model` or `pp`
        group's ranks hold copies of them); on three axes the `data` x
        `space` plane of this rank's `model` index (a `space` group's ranks
        hold other rows, a `model` group's copies)."""
        if not self._copies:
            return self.group
        if "space" in self.axis_names:
            return self.axis_groups["plane"]
        return self.axis_group("data")

    def row_shard(self):
        """This rank's `parallel.spatial.RankShard` of its `space` group
        (None without a `space` axis of two or more ranks)."""
        from facesr_torch.parallel.spatial import RankShard

        s = self.axis_size("space")
        if s < 2 or not self.distributed:
            return None
        return RankShard(self.axis_groups["space"], self.axis_index("space"), s)

    def model_shard(self):
        """This rank's `parallel.tensor.ModelShard` of its `model` group
        (None without a `model` axis of two or more ranks)."""
        from facesr_torch.parallel.tensor import ModelShard

        t = self.axis_size("model")
        if t < 2 or not self.distributed:
            return None
        return ModelShard(self.axis_groups["model"], self.axis_index("model"), t)

    def pp_shard(self, axis: str = "pp"):
        """This rank's `parallel.pipeline.PipeShard`, its stage of the
        ``axis`` group (None without such an axis of two or more ranks)."""
        from facesr_torch.parallel.pipeline import PipeShard

        s = self.axis_size(axis)
        if s < 2 or not self.distributed:
            return None
        return PipeShard(self.axis_groups[axis], self.axis_index(axis), s)


class Sharding(NamedTuple):
    """How a tensor lies on a mesh: ``spec`` names the mesh axis each
    tensor axis is split over (None: whole), as JAX's PartitionSpec: ()
    replicated, ("data",) the batch, (None, "data") the image rows,
    ("data", "space") the batch and the image rows."""

    mesh: Mesh
    spec: Tuple[str, ...]


def check_mesh_axes(axis_names: Sequence[str], shape: Optional[Sequence[int]] = None) -> None:
    """Let the 1-D `data` axis, the `data,space`, `data,model` and
    `data,pp` grids and the three-axis `data,space,model` (and
    `data,model,space`) grid through; raise ValueError for `model` with
    `pp` (both split the parameter tree) and `space` with `pp` (the
    pipelined trunk has no halo exchange), as JAX refuses them, for an axis
    named twice, and for a shape that does not fit the axes."""
    axes = tuple(axis_names)
    if not axes or axes[0] != "data":
        raise ValueError(f"mesh axes must start with the batch axis 'data', got {axes}")
    extra = [a for a in axes[1:] if a not in ("space", "model", "pp")]
    if extra:
        raise ValueError(f"Unknown mesh axes {extra}; supported extra axes: space, model, pp")
    if "model" in axes and "pp" in axes:
        raise ValueError("mesh_axes cannot combine 'model' and 'pp': both shard the parameter "
                         "tree")
    if "space" in axes and "pp" in axes:
        raise ValueError("mesh_axes cannot combine 'space' and 'pp': the pipelined trunk runs "
                         "under manual sharding (no automatic halo exchange); use dp x pp or "
                         "dp x sp")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {','.join(axes)} name an axis twice")
    if shape is not None and len(tuple(shape)) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not fit the mesh axes "
                         f"{','.join(axes)}: give one length an axis")


def check_single_host(world_size: int) -> None:
    """tp state over ranks on more than one host is refused, with JAX's
    reason (torchrun's ``LOCAL_WORLD_SIZE`` below ``WORLD_SIZE``)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if local != world_size:
        raise NotImplementedError(
            "tp/pp-sharded training state is single-host for now: checkpoint saves gather "
            "the state, which requires all shards addressable by the writing process; "
            f"multi-host tp/pp needs an all-gather-on-save path ({local} of {world_size} "
            "ranks on this host)")


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


def _lines(shape: Tuple[int, ...], axis: int) -> List[List[int]]:
    """The ranks of each line of the grid along ``axis`` (every other
    coordinate fixed), lines in row-major order of those coordinates."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    return [list(map(int, line)) for line in np.moveaxis(ranks, axis, -1).reshape(-1, shape[axis])]


def _grid(mesh: Mesh, axis_names: Tuple[str, ...], shape, timeout: float) -> Mesh:
    """The ranks of ``mesh`` as the grid of ``axis_names`` and ``shape``:
    rank r at its row-major coordinates, with a process group for every
    line along every axis (the last axis's first, `data`'s last) and, on
    three axes, for every `data` x `space` plane (the ranks that share a
    `model` index), created by every rank in one order."""
    n = mesh.world_size
    if len(axis_names) == 1:
        if shape is not None and tuple(shape) != (n,):
            raise ValueError(f"mesh shape {tuple(shape)} does not match the {n} rank(s) of "
                             "the data axis")
        return mesh
    if shape is None:
        raise ValueError("mesh_shape is required with multiple mesh_axes, e.g. "
                         "mesh_shape: [4, 2] for 'data,space' on 8 chips")
    shape = tuple(int(v) for v in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks, the group has {n}")
    kw = dict(timeout=datetime.timedelta(seconds=timeout))
    groups = {}
    for axis in reversed(range(len(shape))):
        for line in _lines(shape, axis):
            g = dist.new_group(line, **kw)
            if mesh.rank in line:
                groups[axis_names[axis]] = g
    if len(shape) == 3:  # data, space and model: a plane a model index
        at = np.unravel_index(np.arange(n), shape)[axis_names.index("model")]
        for m in range(shape[axis_names.index("model")]):
            plane = [int(r) for r in np.flatnonzero(at == m)]
            g = dist.new_group(plane, **kw)
            if mesh.rank in plane:
                groups["plane"] = g
    return dataclasses.replace(mesh, axis_names=tuple(axis_names), shape=shape,
                               axis_groups=groups)


def get_mesh(devices: Optional[Sequence[Any]] = None, axis_names: Sequence[str] = ("data",),
             shape: Optional[Sequence[int]] = None, *, rank: Optional[int] = None,
             world_size: Optional[int] = None, local_rank: Optional[int] = None,
             init_method: Optional[str] = None, backend: Optional[str] = None,
             timeout: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The `data` mesh, or the `data,space`, `data,model` or `data,pp` grid
    of ``shape`` (d, k), or the `data,space,model` grid (either order of
    the last two axes) of ``shape`` (d, s, t).

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
    ranks also create the process groups of its lines (and on three axes
    of its `data` x `space` planes).

    Serving (this process alone): a mesh over ``devices``, by default every
    visible card. A device may repeat (``["cpu", "cpu"]``); without
    ``shape`` the devices lie along `data`."""
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
    if len(axes) > 1 and shape is None:
        shape = (len(devs),) + (1,) * (len(axes) - 1)
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
    sp on a `data,space` grid, and the batch of a `data,space,model` grid
    (the Trainer's ``mesh_axes``), whole over `model`."""
    check_mesh_axes((batch_axis, row_axis))
    return Sharding(mesh, (batch_axis, row_axis))


def _state_leaves(state) -> List[Tuple[str, torch.Tensor, Tuple[str, ...], Tuple[int, int]]]:
    """(path, tensor, JAX keys, (JAX leading length, index along it)) of
    every leaf of a training state (or a bare model) by
    `parallel.tensor.state_tensors`' paths (``step`` too): the JAX tree
    path the checkpoint bridge (`ckpt.weights`) maps the leaf to, and
    where on the JAX leaf's leading axis the port's entry lies (a stacked
    JAX leaf, such as a ``groups`` leaf [G, ...], holds one port entry a
    group). The moments, the EMA and the accumulated gradients take their
    parameter's; other leaves their own path and (1, 0)."""
    from facesr_torch.parallel.tensor import state_tensors

    if isinstance(state, torch.nn.Module):
        model, disc = state, None
        tensors = [(f"params/{k}", t) for k, t in state.state_dict(keep_vars=True).items()]
    else:
        model, disc, tensors = state.model, state.disc, list(state_tensors(state))
        tensors.append(("step", torch.as_tensor(state.step)))
    jax_leaves = {"params": _jax_leaves(model, _model_to_jax(model))}
    if disc is not None:
        from facesr_torch.ckpt.weights import jax_discriminator_from_state_dict

        def disc_to_jax(sd):
            params, stats = jax_discriminator_from_state_dict(sd)
            return {"d_params": params, "d_stats": stats}

        jax_leaves["disc"] = _jax_leaves(disc, disc_to_jax)

    def leaf_of(path: str):
        parts = path.split("/")
        field_, name = parts[0], parts[-1]
        if field_ in ("params", "ema_params") or (field_ == "opt_state" and len(parts) == 3):
            keys, at = jax_leaves["params"].get(name, ((), (1, 0)))
            return (field_,) + keys, at
        if field_ in ("d_params", "d_stats") or (field_ == "d_opt_state" and len(parts) == 3):
            keys, at = jax_leaves["disc"].get(name, ((), (1, 0)))
            return (field_,) + keys[1:], at
        return tuple(parts), (1, 0)

    return [(path, t, *leaf_of(path)) for path, t in tensors]


def tp_param_shardings(state: Any, mesh: Mesh, axis: str = "model") -> Dict[str, Sharding]:
    """The tensor-parallel placement of every leaf of a training state: JAX's
    rule (`facesr/parallel/mesh.py` `tp_param_shardings`) read in the
    port's layouts. ``state`` is a `training.steps.TrainState` (or a bare
    model). Returns ``{path: Sharding}`` by `parallel.tensor.state_tensors`'
    paths (``params/<name>``, ``opt_state/mu/<name>``, ``ema_params/...``,
    ``loss_params/vgg/<i>/w``, ``d_params/...``, ``d_stats/...``,
    ``d_opt_state/...``; ``step`` too).

    A leaf splits over ``axis`` along the axis that is JAX's trailing one
    when that axis's length divides by the axis's size: axis 0 of an OIHW
    conv weight, of a `Linear` weight ([out, in]), of a bias, a PReLU
    alpha and a BatchNorm weight, bias or running stat (``spec`` ``(axis,
    None, ...)``). A leaf whose JAX path has a key ``ca`` or a key
    starting ``fc`` stays whole, as in JAX, decided on the path the
    checkpoint bridge (`ckpt.weights`) maps the leaf to: the SE and the
    discriminator's ``fc1``/``fc2`` (``fc1_w``, ...) stay whole. The
    optimiser's moments, the EMA and the accumulated gradients follow
    their parameter; scalars stay whole (``spec`` ``()``)."""
    n = mesh.axis_size(axis)
    out = {}
    for path, t, keys, _ in _state_leaves(state):
        whole = any(k == "ca" or k.startswith("fc") for k in keys)
        if not whole and t.dim() >= 1 and t.shape[0] and t.shape[0] % n == 0:
            out[path] = Sharding(mesh, (axis,) + (None,) * (t.dim() - 1))
        else:
            out[path] = Sharding(mesh, ())
    return out


def _pp_rule(state: Any, mesh: Mesh, axis: str):
    """``{path: (Sharding, stage or None)}``: JAX's pipeline rule on every
    leaf (`pp_param_shardings`) and the stage that holds a split one."""
    n = mesh.axis_size(axis)
    out = {}
    for path, _, keys, (lead, index) in _state_leaves(state):
        if "groups" in keys and lead % n == 0:
            out[path] = (Sharding(mesh, (axis,)), index // (lead // n))
        else:
            out[path] = (Sharding(mesh, ()), None)
    return out


def pp_param_shardings(state: Any, mesh: Mesh, axis: str = "pp") -> Dict[str, Sharding]:
    """The pipeline-parallel placement of every leaf of a training state (or
    a bare model), JAX's rule (`facesr/parallel/pipeline.py`
    `pp_param_shardings`) decided on the JAX path of each port leaf, as
    `tp_param_shardings` is: a leaf under a ``groups`` path whose JAX
    leading axis (the residual groups, [G, ...]) divides by the axis's
    size S is split on that axis over ``axis`` (``spec`` ``(axis,)``);
    everything else is replicated (``()``). The moments, the EMA and the
    accumulated gradients follow their parameter; D, the loss's VGG and
    the scalars have no ``groups``. A port leaf is one group's slice of
    the JAX leaf: `pp_stages` names the stage that holds it."""
    return {path: sharding for path, (sharding, _) in _pp_rule(state, mesh, axis).items()}


def pp_stages(state: Any, mesh: Mesh, axis: str = "pp") -> Dict[str, int]:
    """The stage that holds each leaf `pp_param_shardings` splits: stage i
    of S holds the JAX leaf's groups [i G / S, (i + 1) G / S), so the
    port's entries of those groups (``residual_groups.{g}.*`` of
    FaceEnhanceNet, their moments and EMA)."""
    return {path: stage for path, (_, stage) in _pp_rule(state, mesh, axis).items()
            if stage is not None}


def _model_to_jax(model):
    """The checkpoint bridge of ``model``'s family (state dict -> JAX tree)."""
    from facesr_torch.ckpt import weights

    mtype = getattr(model, "model_type", "custom")
    return {"transfer": weights.jax_params_from_transfer_state_dict,
            "esrgan": weights.jax_params_from_esrgan_state_dict}.get(
                mtype, weights.jax_params_from_state_dict)


def _jax_leaves(module: torch.nn.Module, to_jax
                ) -> Dict[str, Tuple[Tuple[str, ...], Tuple[int, int]]]:
    """The JAX tree path each state-dict entry of ``module`` lands on under
    the bridge ``to_jax``, with the JAX leaf's leading length and the
    entry's index along it: a probe state dict whose entry i is a
    one-element tensor of the entry's rank holding i goes through the
    bridge, and the tree's leaves are read back (a stacked JAX leaf holds
    every entry it stacks, each at its place)."""
    sd = module.state_dict(keep_vars=True)
    names = list(sd)
    probe = {k: torch.full((1,) * sd[k].dim(), float(i)) for i, k in enumerate(names)}
    leaves: Dict[str, Tuple[Tuple[str, ...], Tuple[int, int]]] = {}
    stack = [((), to_jax(probe))]
    while stack:
        path, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((path + (str(k),), v) for k, v in node.items())
        elif isinstance(node, (list, tuple)):
            stack.extend((path + (str(i),), v) for i, v in enumerate(node))
        elif node is not None:
            arr = np.asarray(node)
            lead = arr.shape[0] if arr.ndim else 1
            for i in np.unique(arr):
                at = int(np.argwhere(arr == i)[0][0]) if arr.ndim else 0
                leaves[names[int(i)]] = (path, (lead, at))
    return leaves


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
        i, n = sharding.mesh.axis_index(name), sharding.mesh.axis_size(name)
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
    """The mean over the ranks of `Mesh.sum_group` of each tensor (new
    tensors, views of one flat bucket per dtype and device): a sum by
    ``all_reduce``, divided by their count. With one rank there the
    values are bitwise the inputs."""
    def mean(flat: torch.Tensor) -> None:
        dist.all_reduce(flat, group=mesh.sum_group)
        flat.div_(mesh.sum_size)

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
    """The sum of ``x`` over the ranks of `Mesh.sum_group`,
    differentiable."""
    return _AllReduceSum.apply(x, mesh.sum_group)


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
