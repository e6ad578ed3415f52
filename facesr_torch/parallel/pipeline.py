"""Pipeline parallelism (pp): the residual groups of FaceEnhanceNet as a
GPipe pipeline over the ranks of a `pp` group (port of
`facesr/parallel/pipeline.py`).

Stage i of S holds the groups [i G / S, (i + 1) G / S) of the trunk, and
only their leaves of the training state: their parameters, Adam moments
and EMA (`parallel.mesh.pp_param_shardings`, JAX's rule; `shard_state`
frees the other stages' leaves, `unshard_state` gathers them whole again).
The head and the tail (conv_first, conv_after_body, the upsample,
conv_last, the bicubic skip) and D and the VGG stay replicated on every
stage: the ranks of a `pp` group hold the same batch rows, so they compute
the same loss.

The schedule (`pipeline_trunk`) is JAX's: the local batch is split into
``n_micro`` microbatches; at tick t stage 0 injects microbatch t, each
stage runs its groups on what it holds, the results shift one stage down
the open chain (stage 0 receives zeros), and the last stage banks
microbatch t - (S - 1). There are T = n_micro + S - 1 ticks. The finished
trunk goes back to every stage as the sum of a tensor that is zero except
on the last stage. A stage skips the compute of a bubble tick (JAX
computes it and throws it away), but every stage enters every exchange.

The exchanges are tp's own ops (`parallel.tensor`), applied over `pp`:

- the trunk's input is ``copy``: forward the identity, backward the sum
  over `pp`. Only stage 0 reads the input, so the sum gives conv_first its
  trunk gradient on every stage;
- the stage shift (`_Shift`): forward stage i's output to stage i + 1,
  backward stage i + 1's gradient to stage i;
- the broadcast of the finished trunk (`_Broadcast`): forward the sum,
  backward the identity, so that only the last stage's banked outputs
  take the gradient (a backward that summed would multiply every group's
  gradient by S).

Every rank must enter the exchanges in one order, in the forward and in
autograd's backward. The forward's order is the code's. For the backward,
each exchange takes a 0-d token from the one before it (the trunk's input
for the first shift) and the broadcast the last token: a node runs only
once every node that read its outputs has run, so the backward walks the
broadcast, the shifts from the last tick to the first and then the copy,
on every stage, whatever that stage computed. The token's gradient is
None: it orders the graph and moves no bytes. The groups themselves
exchange nothing, so their recompute under remat (on autograd's thread)
issues no collective.

Each exchange is an ``all_reduce`` of a zero-filled buffer, as in tp and
sp: gloo has no CUDA send, and two ranks that share a card run over gloo.
A shift's buffer holds S - 1 microbatches, one slot a sending stage.
Low-precision floats travel as float32 (exact: the other entries are
zeros). `PipeShard.counts` counts the exchanges by kind: ``shift`` and
``shift_grad`` (a tick's forward and backward), ``copy``, ``broadcast``,
and the optimiser's ``sum``, ``all`` and ``mean``, and ``whole``.

`make_pp_apply` is the drop-in forward: ``apply(x, train=False,
dtype=None)`` runs the model with this pipelined trunk. The eval forward
in bf16 of a config the group kernel takes (``model.kernel_trunk``) runs
each stage's groups through `fused_residual_group` (`blocks.
run_kernel_groups`), the rule the single-device bf16 eval forward follows:
the Hopper kernel on a CUDA tensor, its plain version on a CPU tensor.
Every other forward runs the stage's groups as the plain trunk (with the
config's ``remat`` when ``train``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from facesr_torch.parallel import tensor
from facesr_torch.parallel.tensor import GroupShard, state_tensors

__all__ = ["PipeShard", "pipeline_trunk", "stage_trunk", "make_pp_apply", "check_pp_model",
           "shard_state", "unshard_state", "stage_groups"]


def _wire_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype


class _Shift(torch.autograd.Function):
    """``y`` of stage i to stage i + 1 (stage 0 receives zeros), and a new
    token; backward: the received gradient back to stage i, None for the
    token (`PipeShard.shift`)."""

    @staticmethod
    def forward(ctx, y, token, pipe):
        ctx.pipe, ctx.like = pipe, (y.shape, y.dtype, y.device)
        ctx.set_materialize_grads(False)
        return pipe._pass(y, down=True), token.new_zeros(())

    @staticmethod
    def backward(ctx, grad, _):
        pipe = ctx.pipe
        pipe.counts["shift_grad"] += 1
        if grad is None:  # this stage did not read what it received
            shape, dtype, device = ctx.like
            grad = torch.zeros(shape, dtype=dtype, device=device)
        return pipe._pass(grad, down=False), None, None


class _Broadcast(torch.autograd.Function):
    """The sum of ``x`` over the group after the token; backward: the
    identity (`PipeShard.broadcast`)."""

    @staticmethod
    def forward(ctx, x, token, pipe):
        ctx.pipe = pipe
        # contiguous: the stages' tensors may lie in other layouts, and the
        # reduce sums storage element by element
        y = x.to(dtype=_wire_dtype(x), memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(y, group=pipe.group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class PipeShard(GroupShard):
    """Stage ``index`` of the ``size`` stages of the `pp` process group
    ``group``: the pipeline's exchanges and the optimiser's (`GroupShard`)."""

    def _pass(self, x: torch.Tensor, down: bool) -> Optional[torch.Tensor]:
        """``x`` of stage i to stage i + 1 (``down``) or to stage i - 1: an
        all-reduce of S - 1 slots, slot j the one from stage j to j + 1.
        The stage at the open end receives zeros going down and None (no
        gradient) going up."""
        s, i = self.size, self.index
        buf = torch.zeros((s - 1, *x.shape), dtype=_wire_dtype(x), device=x.device)
        send, recv = (i, i - 1) if down else (i - 1, i)
        if 0 <= send < s - 1:
            buf[send].copy_(x)
        dist.all_reduce(buf, group=self.group)
        if 0 <= recv < s - 1:
            return buf[recv].to(x.dtype)
        return torch.zeros_like(x) if down else None

    def shift(self, y: torch.Tensor, token: torch.Tensor):
        """(what stage i - 1 sent, the next token): one tick's shift."""
        self.counts["shift"] += 1
        return _Shift.apply(y, token, self)

    def broadcast(self, x: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the stages (the last stage's finished
        trunk, zeros elsewhere) after ``token``; backward: the identity."""
        self.counts["broadcast"] += 1
        return _Broadcast.apply(x, token, self)

    def whole(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every tensor whole on every stage, no gradient: each is whole on
        the stage that holds it and empty on the others (`shard_state`).
        Two all-reduces: the holders' shapes, then one a (dtype, device) of
        the tensors laid end to end, each written by its holder."""
        self.counts["whole"] += 1
        if not tensors:
            return []
        device = tensors[0].device
        rank = max(t.dim() for t in tensors)
        shapes = torch.zeros((len(tensors), rank), dtype=torch.int64, device=device)
        with torch.no_grad():
            for i, t in enumerate(tensors):
                if t.numel():
                    shapes[i, :t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
            dist.all_reduce(shapes, group=self.group)
            whole = [torch.Size(shapes[i, :t.dim()].tolist()) for i, t in enumerate(tensors)]
            out: List[Optional[torch.Tensor]] = [None] * len(tensors)
            buckets: Dict[tuple, List[int]] = {}
            for i, t in enumerate(tensors):
                buckets.setdefault((t.dtype, t.device), []).append(i)
            for (dtype, dev), idx in buckets.items():
                sizes = [whole[i].numel() for i in idx]
                flat = torch.zeros(sum(sizes), dtype=_wire_dtype(tensors[idx[0]]), device=dev)
                offset = 0
                for i, n in zip(idx, sizes):
                    if tensors[i].numel():
                        flat[offset:offset + n].copy_(tensors[i].detach().reshape(-1))
                    offset += n
                dist.all_reduce(flat, group=self.group)
                offset = 0
                for i, n in zip(idx, sizes):
                    out[i] = flat[offset:offset + n].to(dtype).view(whole[i])
                    offset += n
        return out  # type: ignore[return-value]


def stage_groups(num_groups: int, pipe: Optional[PipeShard]) -> range:
    """The residual groups stage ``pipe.index`` runs (all without a pipe)."""
    if pipe is None:
        return range(num_groups)
    per = num_groups // pipe.size
    return range(pipe.index * per, (pipe.index + 1) * per)


def _microbatch(n: int, n_micro: int) -> int:
    """The rows of a microbatch of a local batch of ``n`` (JAX's check)."""
    if n % n_micro:
        raise ValueError(f"pipeline n_micro={n_micro} must divide the local batch {n}")
    return n // n_micro


def pipeline_trunk(pipe: PipeShard, run_groups: Callable[[torch.Tensor], torch.Tensor],
                   feat: torch.Tensor, n_micro: int) -> torch.Tensor:
    """The pipelined trunk on this stage: ``feat`` (the local [N, H, W, C]
    trunk input, the same on every stage) in ``n_micro`` microbatches
    through ``run_groups`` (this stage's groups) over the S stages; returns
    the finished trunk on every stage."""
    s, i = pipe.size, pipe.index
    mb = _microbatch(feat.shape[0], n_micro)
    x = pipe.copy(feat)
    micro = x.split(mb)
    token, recv, banked = x, None, []
    idle = x.new_zeros((mb, *x.shape[1:]))  # what a bubble tick sends
    ticks = n_micro + s - 1
    for t in range(ticks):
        m = t - i
        y = idle
        if 0 <= m < n_micro:
            y = run_groups(micro[m] if i == 0 else recv)
            if i == s - 1:
                banked.append(y)
        if t < ticks - 1:
            recv, token = pipe.shift(y, token)
    out = torch.cat(banked) if i == s - 1 else feat.new_zeros(feat.shape)
    return pipe.broadcast(out, token)


def stage_trunk(model, pipe: Optional[PipeShard], n_micro: int, train: bool = False,
                dtype: Optional[torch.dtype] = None):
    """The ``trunk_fn(groups, feat)`` that runs ``model``'s residual groups
    as the pipeline (``pipe`` None: this process's groups on the
    microbatches, one after the other). A stage's groups run the group
    kernel in the bf16 eval forward of a config it takes, else the plain
    trunk (`blocks.residual_groups`, with the config's remat when
    ``train``)."""
    from facesr_torch.models import blocks
    from facesr_torch.ops.rcab_group import prepare_group_weights

    cfg = model.config
    if pipe is not None:
        check_pp_model(model, pipe.size)
    own = stage_groups(cfg.num_groups, pipe)
    kernel = dtype == torch.bfloat16 and not train and model.kernel_trunk

    def trunk(groups, feat):
        mods = [groups[g] for g in own]
        if kernel:
            weights = model.cached_kernel_weights(
                [p for g in mods for p in g.parameters()],
                lambda: [prepare_group_weights(g) for g in mods])

            def run(x):
                return blocks.run_kernel_groups(x, weights, cfg.res_scale)
        else:
            def run(x):
                return blocks.residual_groups(mods, x, cfg.res_scale, cfg.kernel_size // 2,
                                              remat=cfg.remat if train else "none")[0]
        if pipe is None:
            return torch.cat([run(m) for m in feat.split(_microbatch(feat.shape[0], n_micro))])
        return pipeline_trunk(pipe, run, feat, n_micro)

    return trunk


def check_pp_model(model, stages: int) -> None:
    """JAX's refusals of a model under pp: only FaceEnhanceNet has the
    stacked [G] trunk, and its groups must divide over the stages."""
    mtype = getattr(model, "model_type", "custom")
    if mtype != "custom":
        raise ValueError(f"mesh_axes 'pp' requires the FaceEnhanceNet trunk, not "
                         f"model_type={mtype!r}")
    groups = model.config.num_groups
    if groups % stages:
        raise ValueError(f"num_groups={groups} must divide over {stages} pipeline stages")


def make_pp_apply(model, mesh, n_micro: Optional[int] = None, axis: str = "pp",
                  dp_axis: Optional[str] = None) -> Callable[..., torch.Tensor]:
    """``apply(x, train=False, dtype=None)``: ``model``'s forward with its
    residual-group trunk run as the S-stage microbatch pipeline over
    ``mesh``'s ``axis`` group (S = its size; ``num_groups % S`` must be
    0). Each rank of the group calls it with the same ``x``; every rank
    returns the whole output. ``n_micro`` defaults to 2 S, as in JAX, and
    must divide the local batch (raised by the call). With ``dp_axis`` the
    batch also rides that axis: ``x`` is the global batch, each rank
    pipelines its rows of it, and the rows come back gathered (backward:
    each rank's rows). The model's state must be this stage's
    (`shard_state`) or whole."""
    from facesr_torch.parallel.mesh import shard_batch

    stages = mesh.axis_size(axis)
    check_pp_model(model, stages)
    n_micro = 2 * stages if n_micro is None else int(n_micro)
    pipe = mesh.pp_shard(axis)
    rows = None
    if dp_axis is not None and mesh.axis_size(dp_axis) > 1:
        rows = GroupShard(mesh.axis_group(dp_axis), mesh.axis_index(dp_axis),
                          mesh.axis_size(dp_axis))

    def apply(x: torch.Tensor, train: bool = False,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if rows is not None:
            x = shard_batch(x, mesh, dp_axis)
        out = model(x, train=train, dtype=dtype,
                    trunk_fn=stage_trunk(model, pipe, n_micro, train, dtype))
        if rows is not None:
            out = tensor._Gather.apply(out, rows, 0)
        return out

    apply.pipe = pipe
    return apply


# ---------------------------------------------------------------------------
# the training state, whole or a stage's


def shard_state(state, pipe: PipeShard, stages: Dict[str, int]) -> None:
    """Keep, in place, only this stage's leaves of ``state`` among those
    ``stages`` (`parallel.mesh.pp_stages` of the whole state) places: the
    others' storage is freed (an empty tensor of their rank). Every placed
    leaf a forward reads is marked (`tensor.mark_split`): the optimiser's
    clip sums their squares over `pp`."""
    with torch.no_grad():
        for path, t in list(state_tensors(state)):
            if path in stages and stages[path] != pipe.index:
                t.data = t.new_empty((0,) * t.dim())
    tensor.mark_split(state, dict.fromkeys(stages, True))


def unshard_state(state, pipe: PipeShard, stages: Dict[str, int]) -> None:
    """The inverse of `shard_state`: every placed leaf whole on every stage,
    in place, and unmarked (a collective of the group)."""
    leaves = [t for path, t in state_tensors(state) if path in stages]
    for t, w in zip(leaves, pipe.whole(leaves)):
        t.data = w
        tensor.mark(t, False)
