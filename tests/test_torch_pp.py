"""Pipeline parallelism (pp) of the port on the CPU: `pp_param_shardings`
against JAX's on every leaf of the same training state, the pipelined
forward (`make_pp_apply`, f32 and the bf16 eval forward through the group
kernel's wrapper) against the single-process one, and the content, GAN
and eval steps, the Trainer (its checkpoints and resumes both ways) and
the train CLI on `data,pp` grids of gloo ranks started by
`facesr_torch.parallel.launch`, against the single-process steps and
JAX's pp and dp x pp steps on the conftest's CPU devices (JAX's own pp
steps first held to its single-device steps).

Sizes: FaceEnhanceNet C=16, B=2 (every weight perturbed off its init from
numpy, conv_last redrawn non-zero), G=2 on [1, 2] (2 ranks) and [2, 2] (4
ranks), G=4 on [1, 4] (4 ranks: the middle stages both receive and send);
HR 32, a global batch of 4 in S microbatches (and 2S on [1, 2]); the GAN
step at HR 64 with D at 64 (8 base channels, BatchNorm) on [1, 2] and
[2, 2]; the forward at LR 8x8, batch 16 in S and 2S microbatches. One
launch a grid, in a background thread that the parent's single-process
and JAX runs overlap; the children import torch and the port only, never
JAX.

Tolerances (float32): the pipelined forward is bitwise the
single-process one at these sizes (a microbatch of one image would take
other CPU conv kernels, ~1e-5 apart). A step adds the same sums in other
orders (a conv's weight gradient summed a microbatch at a time, the
replicated leaves' mean over `pp`, the clip's norm in two parts), so each
quantity is held to max(1e-4, 10 x its rounding floor): how far the
single-process run moves when its input is multiplied by (1 + 2^-23 N(0,
1)) (two draws) or its trunk runs a microbatch of one image at a time,
the largest draw. Losses and metrics relatively, gradients and moments by
relative L2 a tensor, parameters a tensor off their Adam ties (elements
whose gradient is within 10 x its rounding noise of zero: Adam's first
step moves them by ~lr x a sign that rounding decides); GAN runs by part,
as the tp GAN tests hold them. JAX's pp runs are held to JAX's
single-device runs by JAX's own floor (off the same ties), and the port's
pp runs to JAX's pp runs: each quantity's gap at most the single-process
port run's gap to JAX's single-device run plus its limit. JAX's [2, 2]
GAN run is off its single-device run by more than its floor (at a
rounding event the port's own floor draws also hit), so the port's [2, 2]
GAN run is held to JAX's single-device run. The ranks against each other
bitwise. The planted controls, a broadcast whose backward sums over `pp`
(every group's gradient S times too large), a clip whose norm skips the
`pp` sum and a shift one tick late, put tensors over their limits.
"""

import contextlib
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.cli.step_numerics import RecordingAdamW
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models import discriminator as dmod
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.parallel import launch, pipeline
from facesr_torch.parallel import mesh as pmesh
from facesr_torch.training import optim, steps

torch.set_num_threads(1)

B, C, HR, BATCH = 2, 16, 32, 4
GRIDS = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
GROUPS = {"1x2": 2, "2x2": 2, "1x4": 4}
GAN_GRIDS = ("1x2", "2x2")
# where JAX's pp GAN step agrees with its single-device one; its [2, 2]
# (dp x pp) step does not, so the port's is held to JAX's single device
JAX_GAN_GRIDS = ("1x2",)
LR, CLIP = 1e-3, 0.5
GAN_HR, D_BASE, GAN_LR, D_LR, GAN_WEIGHT = 64, 8, 1e-4, 1e-4, 0.5
LOSS = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1)
VGG_LOSS = dict(l1_weight=1.0, perceptual_weight=0.1, ssim_weight=0.1)
SEEDS = (10, 11)
GAN_SEEDS = (30, 31)
METRICS = ("loss", "d_loss", "g_adv", "d_real", "d_fake")
CONTROLS = ("broadcast_backward_sum", "clip_without_pp_sum", "shift_one_tick_late")
BASE = 1e-4
FLOOR_FACTOR = 10
FLOOR_NOISE = 2.0 ** -23
FLOOR_DRAWS = (11, 12, "micro")  # two input-noise seeds; the trunk one image at a time
FWD_BATCH = 16
ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# what the ranks and the parent both build (torch and numpy only)


def _model(groups=2, channels=C, blocks=B) -> FaceEnhanceNet:
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=channels, num_groups=groups,
                                                blocks_per_group=blocks), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            last = name.endswith("conv_last.weight")
            noise = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            p.copy_(noise * 0.05 if last else p + noise * 0.02)
    return model


def _disc() -> dmod.Discriminator:
    """D at GAN_HR with every parameter and running stat moved off its init."""
    d = dmod.create_discriminator(input_size=GAN_HR, base_channels=D_BASE, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in d.parameters():
            p.add_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) * 0.05)
        for b in d.buffers():
            b.add_(torch.from_numpy(rng.random(b.shape).astype(np.float32)) * 0.1)
    return d


def _hr(seed, n=BATCH, size=HR) -> np.ndarray:
    """Smooth HR images in [0, 1]."""
    rng = np.random.default_rng(seed)
    lo = rng.random((n, size // 4, size // 4, 3), dtype=np.float32)
    return np.clip(np.kron(lo, np.ones((1, 4, 4, 1), np.float32))
                   + rng.normal(0, 0.02, (n, size, size, 3)), 0, 1).astype(np.float32)


def _np(named) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named}


def _rows(x: np.ndarray, mesh=None) -> torch.Tensor:
    """This rank's batch rows of a global batch (all of it without a mesh)."""
    return torch.from_numpy(np.ascontiguousarray(x if mesh is None
                                                 else pmesh.shard_batch(x, mesh)))


def _noisy(x: torch.Tensor, noise, seed: int) -> torch.Tensor:
    if not isinstance(noise, int):
        return x
    gen = torch.Generator().manual_seed(noise + seed)
    return x * (1 + FLOOR_NOISE * torch.randn(x.shape, generator=gen))


@contextlib.contextmanager
def _one_image_trunk(noise):
    """With ``noise`` "micro", the single-process forward runs its trunk one
    image at a time (the pipeline's sums at a microbatch of one)."""
    if noise != "micro":
        yield
        return
    real = FaceEnhanceNet.forward

    def forward(self, x, *args, trunk_fn=None, **kwargs):
        trunk_fn = trunk_fn or pipeline.stage_trunk(self, None, x.shape[0], kwargs.get("train"))
        return real(self, x, *args, trunk_fn=trunk_fn, **kwargs)

    FaceEnhanceNet.forward = forward
    try:
        yield
    finally:
        FaceEnhanceNet.forward = real


def _staged(state, mesh):
    """Keep this stage's leaves of ``state`` (pp); returns the stages."""
    stages = pmesh.pp_stages(state, mesh)
    pipeline.shard_state(state, mesh.pp_shard(), stages)
    return stages


@contextlib.contextmanager
def _whole(state, mesh, stages):
    """The block sees ``state`` whole (a collective; no-op unsharded)."""
    if mesh is None:
        yield
        return
    pipe = mesh.pp_shard()
    pipeline.unshard_state(state, pipe, stages)
    try:
        yield
    finally:
        pipeline.shard_state(state, pipe, stages)


def _content_step(mesh=None, loss_cfg=LOSS, groups=2, n_micro=0):
    """A content step (pp: its state a stage's): (state, optimiser, step,
    loss apply, stages)."""
    model = _model(groups)
    loss = CombinedLoss(LossConfig(**loss_cfg), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=CLIP)
    state = steps.TrainState(model=model, opt_state=opt.init(steps.trainable_parameters(model),
                                                             LR),
                             loss_params=loss.params)
    apply = lambda lp, p, t: loss.apply(lp, p, t)  # noqa: E731
    step = steps.make_train_step(apply, opt, mesh=mesh, pp_microbatches=n_micro)
    stages = _staged(state, mesh) if mesh is not None else None
    return state, opt, step, apply, stages


def _run(mesh=None, loss_cfg=LOSS, groups=2, n_micro=0, seeds=SEEDS, noise=None):
    """Steps on ``seeds`` (a rounding draw ``noise``: an input seed, or
    "micro"): each step's loss and gradients (whole: `RecordingAdamW`
    gathers a stage's), then the whole parameters and moments."""
    state, opt, step, _, stages = _content_step(mesh, loss_cfg, groups, n_micro)
    out = {"losses": [], "grads": [], "exchanges": None}
    with _one_image_trunk(noise):
        for seed in seeds:
            _, m = step(state, _noisy(_rows(_hr(seed), mesh), noise, seed))
            out["losses"].append(float(m["loss"]))
            out["grads"].append({k: v.numpy() for k, v in opt.grads.items()})
            if out["exchanges"] is None and mesh is not None:
                out["exchanges"] = dict(step.pp_shard.counts)
    with _whole(state, mesh, stages):
        out.update(params=_np(state.model.state_dict().items()),
                   mu=_np(state.opt_state["mu"].items()))
    return out


def _gan_step(mesh=None):
    model, disc = _model(), _disc()
    loss = CombinedLoss(LossConfig(**LOSS), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=CLIP)
    d_opt = RecordingAdamW(weight_decay=1e-3, gradient_clip=0.0)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()),
                                                             GAN_LR),
                             loss_params=loss.params, disc=disc,
                             d_opt_state=d_opt.init(dict(disc.named_parameters()), D_LR))
    step = steps.make_gan_train_step(lambda lp, p, t: loss.apply(lp, p, t), opt, d_opt,
                                     gan_weight=GAN_WEIGHT, mesh=mesh)
    stages = _staged(state, mesh) if mesh is not None else None
    return state, opt, d_opt, step, stages


def _gan_run(mesh=None, noise=None):
    """Two GAN steps: each step's metrics, the first step's G and D
    gradients and the whole state after."""
    state, opt, d_opt, step, stages = _gan_step(mesh)
    out = {"metrics": []}
    with _one_image_trunk(noise):
        for i, seed in enumerate(GAN_SEEDS):
            _, m = step(state, _noisy(_rows(_hr(seed, size=GAN_HR), mesh), noise, seed))
            out["metrics"].append({k: float(m[k]) for k in METRICS})
            if i == 0:
                out["g_grads"] = {k: v.numpy() for k, v in opt.grads.items()}
                out["d_grads"] = {k: v.numpy() for k, v in d_opt.grads.items()}
    with _whole(state, mesh, stages):
        out.update({"g": _np(state.model.state_dict().items()),
                    "d": _np(state.disc.state_dict().items()),
                    **{f"{who}_{m}": _np((st[m]).items())
                       for who, st in (("g", state.opt_state), ("d", state.d_opt_state))
                       for m in ("mu", "nu")}})
    return out


@contextlib.contextmanager
def _planted(control):
    """A fault in the pp path: the broadcast's backward summing over `pp`,
    the clip's norm without the `pp` sum, or each shift delivering the
    tick before's microbatch."""
    import torch.distributed as dist

    if control == "broadcast_backward_sum":
        owner, attr, real = pipeline._Broadcast, "backward", pipeline._Broadcast.backward

        def summed(ctx, grad):
            g = grad.clone()
            dist.all_reduce(g, group=ctx.pipe.group)
            return g, None, None

        value, real = staticmethod(summed), staticmethod(real)
    elif control == "clip_without_pp_sum":
        owner, attr, real = optim, "global_norm", optim.global_norm
        value = lambda grads, params, shard=None: real(grads, params, None)  # noqa: E731
    else:
        owner, attr, real = pipeline.PipeShard, "_pass", pipeline.PipeShard._pass

        def value(self, x, down):
            got = real(self, x, down)
            if not down:
                return got
            late, self._late = getattr(self, "_late", None), got
            return torch.zeros_like(got) if late is None else late

    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, real)


def _forward_check(mesh, groups):
    """`make_pp_apply`'s eval forward of a global batch over the grid (the
    rows ride `data`) in S and 2S microbatches, f32; and the bf16 eval
    forward of a C=64 model through the group kernel's wrapper (its plain
    version here), counting the groups it runs."""
    from facesr_torch.ops import rcab_group as rg

    s = mesh.axis_size("pp")
    x = torch.from_numpy(np.random.default_rng(3).random((FWD_BATCH, 8, 8, 3),
                                                         dtype=np.float32))
    out = {}
    model = _model(groups)
    state = steps.TrainState(model=model, opt_state={}, loss_params={})
    _staged(state, mesh)
    for n_micro in (s, 2 * s):
        apply = pipeline.make_pp_apply(model, mesh, n_micro=n_micro, dp_axis="data")
        with torch.no_grad():
            out[n_micro] = apply(x).numpy()
        out[f"exchanges{n_micro}"] = dict(apply.pipe.counts)
    wide = _model(groups, channels=64, blocks=1)
    state = steps.TrainState(model=wide, opt_state={}, loss_params={})
    _staged(state, mesh)
    calls, real = [], rg.rcab_group_reference
    rg.rcab_group_reference = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with torch.no_grad():
            out["bf16"] = pipeline.make_pp_apply(wide, mesh, n_micro=s, dp_axis="data")(
                x[:8 * mesh.data_size], dtype=torch.bfloat16).float().numpy()
    finally:
        rg.rcab_group_reference = real
    out["kernel_calls"] = len(calls)
    return out


def _trainer(ckpt_dir, train, val, mesh=None, epochs=1, **cfg):
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    config = TrainerConfig(epochs=epochs, learning_rate=LR, weight_decay=1e-2,
                           gradient_clip=CLIP, use_amp=False, save_every=1,
                           checkpoint_dir=str(ckpt_dir), ema_decay=0.9, step_log_every=0,
                           scheduler_T_max=4, async_checkpoint=False, **cfg)
    return Trainer(_model(), train, val, CombinedLoss(LossConfig(**VGG_LOSS), device="cpu"),
                   config, device="cpu", mesh=mesh)


def _trainer_state(tr) -> dict:
    """A Trainer's parameters, moments and EMA, whole (a collective under pp)."""
    with tr.whole_state():
        return {"params": _np(tr.model.state_dict().items()),
                "mu": _np(tr.state.opt_state["mu"].items()),
                "nu": _np(tr.state.opt_state["nu"].items()),
                "ema": _np(tr.state.ema_params.items())}


TRAIN_BATCHES = [_hr(40 + i) for i in range(2)]
VAL_BATCHES = [_hr(50)]


def _trainers(mesh, tmp):
    """A data,pp Trainer epoch (rank 0 writes); a single-process file
    resumed fully by a 2-epoch data,pp Trainer, which trains epoch 2; the
    memory report."""
    from facesr_torch.utils.profiling import tensor_bytes

    own = Path(tmp) / f"rank{mesh.rank}"
    train = [{"hr": pmesh.shard_batch(b, mesh)} for b in TRAIN_BATCHES]
    val = [{"hr": pmesh.shard_batch(b, mesh)} for b in VAL_BATCHES]
    grid = dict(mesh_axes="data,pp", mesh_shape=mesh.shape)
    out = {}
    tr = _trainer(own / "pp", train, val, mesh, **grid)
    out["history"] = tr.train()
    out["writer"] = tr.is_writer
    out["trainer_state"] = _trainer_state(tr)
    tr._restore_payload(tr._checkpoint_payload())  # memory_report's snapshot and restore
    out["revalidated"] = tr._validate_epoch()
    out["report"] = tr.memory_report(BATCH, HR, echo=False)
    out["model_bytes"] = tensor_bytes(tr.model)
    single = _trainer(own / "single", [{"hr": b} for b in TRAIN_BATCHES],
                      [{"hr": b} for b in VAL_BATCHES], mesh=pmesh.Mesh((torch.device("cpu"),)))
    single.train()
    resumed = _trainer(own / "resumed", train, val, mesh, epochs=2, **grid)
    resumed.load_checkpoint(str(own / "single" / "final_model.fckpt"))
    got, want = _trainer_state(resumed), _trainer_state(single)
    out["restored"] = all(np.array_equal(got[p][k], v) for p in want for k, v in want[p].items())
    out["resumed_history"] = resumed.train()
    out["resumed_state"] = _trainer_state(resumed)
    return out


def _worker(mesh, tmp, grid):
    """Everything a rank of one grid runs, in one launch."""
    from facesr_torch.utils.profiling import tensor_bytes

    torch.set_num_threads(1)
    groups, s = GROUPS[grid], mesh.axis_size("pp")
    out = {"rank": mesh.rank, "coords": (mesh.axis_index("data"), mesh.axis_index("pp"))}
    out["forward"] = _forward_check(mesh, groups)
    out["content"] = _run(mesh, groups=groups)
    state, _, _, apply, _ = _content_step(mesh, groups=groups)
    metrics, sr, _ = steps.make_eval_step(apply, mesh=mesh)(state, _rows(_hr(20), mesh))
    out["eval"] = {k: float(v) for k, v in metrics.items()}
    out["eval_rows"] = tuple(sr.shape)
    out["state_bytes"] = tensor_bytes([state.model, state.opt_state["mu"], state.opt_state["nu"]])
    out["vgg"] = _run(mesh, VGG_LOSS, groups=groups, seeds=SEEDS[:1])
    if grid == "1x2":
        out["content_2s"] = _run(mesh, n_micro=2 * s)
        out["controls"] = {}
        for control in CONTROLS:
            with _planted(control):
                out["controls"][control] = _run(mesh, VGG_LOSS, seeds=SEEDS[:1])
        out.update(_trainers(mesh, tmp))
    if grid in GAN_GRIDS:
        out["gan"] = _gan_run(mesh)
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every grid's ranks, one grid after the other in a background thread,
    so that the parent's single-process and JAX runs overlap them."""
    tmp = tmp_path_factory.mktemp("pp")

    def run():
        out = {}
        for name, (d, s) in GRIDS.items():
            out[name] = launch.run_ranks(_worker, d * s, args=(str(tmp / name), name),
                                         devices=["cpu"] * (d * s), timeout=120,
                                         run_timeout=400, axis_names=("data", "pp"),
                                         shape=(d, s))
        return out, tmp

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


# ---------------------------------------------------------------------------
# errors and limits


def _rel_l2(got, want, base=None) -> float:
    """||got - want|| / ||want - base|| over every tensor of two same-keyed
    dicts together (``base`` None: / ||want||); arrays for one tensor."""
    if not isinstance(want, dict):
        got, want, base = {"": got}, {"": want}, None if base is None else {"": base}
    num = sum(float(((np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)) ** 2)
                    .sum()) for k in want)
    den = sum(float(((np.asarray(want[k], np.float64)
                      - (0 if base is None else np.asarray(base[k], np.float64))) ** 2).sum())
              for k in want)
    return math.sqrt(num / max(den, 1e-300))


def _ties(want, draws, grads="grads") -> dict:
    """Per parameter, the elements whose gradient (either step's) lies within
    FLOOR_FACTOR x its rounding noise (the largest |draw - want|) of zero."""
    out = {}
    for i, g in enumerate(want[grads] if grads == "grads" else [want[grads]]):
        for k, v in g.items():
            noise = np.max([np.abs((d[grads][i] if grads == "grads" else d[grads])[k] - v)
                            for d in draws], axis=0)
            tie = np.abs(v) <= FLOOR_FACTOR * noise
            out[k] = tie | out.get(k, False)
    return out


def _off(a, tie):
    return np.asarray(a)[~tie] if tie is not None else a


def _errors(got, want, ties=None) -> dict:
    """Each quantity's error of a `_run` record against another: the losses
    relatively, the gradients and moments by relative L2 a tensor, the
    parameters a tensor off their ties."""
    ties = ties or {}
    out = {f"loss{i}": abs(a - b) / abs(b) for i, (a, b) in
           enumerate(zip(got["losses"], want["losses"]))}
    for i, grads in enumerate(want.get("grads", [])):
        out.update({f"grads{i}.{k}": _rel_l2(got["grads"][i][k], v) for k, v in grads.items()})
    out.update({f"params.{k}": _rel_l2(_off(got["params"][k], ties.get(k)),
                                       _off(v, ties.get(k))) for k, v in want["params"].items()})
    if "mu" in want:
        out.update({f"mu.{k}": _rel_l2(got["mu"][k], v) for k, v in want["mu"].items()})
    return out


def _limits(want, draws, ties) -> dict:
    """max(BASE, FLOOR_FACTOR x the floor) a quantity, the floor being the
    largest of the draws' errors."""
    errs = [_errors(d, want, ties) for d in draws]
    return {k: max(BASE, FLOOR_FACTOR * max(e[k] for e in errs)) for k in errs[0]}


def _over(errors, limits) -> dict:
    return {k: (e, limits[k]) for k, e in errors.items() if e > limits[k]}


def _split(sd):
    """A D state dict's parameters and running stats apart."""
    return ({k: v for k, v in sd.items() if "running" not in k},
            {k: v for k, v in sd.items() if "running" in k})


def _gan_errors(got, want, ties=None, grads=True) -> dict:
    """How far a GAN run is from another: each step's metrics (the largest
    relative error), the first step's gradients a tensor (``grads``), G's
    and D's parameters over their update off their ties, D's running
    stats and the four moments by relative L2 over a part."""
    ties = ties or {}
    g0 = _np(_model().state_dict().items())
    d0 = _split(_np(_disc().state_dict().items()))[0]
    (d_got, s_got), (d_want, s_want) = _split(got["d"]), _split(want["d"])
    errs = {f"step {i}": max(abs(a[k] - b[k]) / abs(b[k]) for k in METRICS)
            for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"]))}
    if grads:
        for part in ("g_grads", "d_grads"):
            errs.update({f"{part}.{k}": _rel_l2(got[part][k], v)
                         for k, v in want[part].items()})
    off = lambda sd, part: {k: _off(v, ties.get((part, k))) for k, v in sd.items()}  # noqa: E731
    errs.update({"G": _rel_l2(off(got["g"], "g"), off(want["g"], "g"), off(g0, "g")),
                 "D": _rel_l2(off(d_got, "d"), off(d_want, "d"), off(d0, "d")),
                 "BN stats": _rel_l2(s_got, s_want),
                 **{k: _rel_l2(got[k], want[k]) for k in ("g_mu", "g_nu", "d_mu", "d_nu")}})
    return errs


@pytest.fixture(scope="module")
def single(launched):
    """The single-process runs, their Adam ties and each quantity's limit:
    the content step (two steps) at G=2 and G=4, the VGG step (one) at
    G=2 and G=4, and the GAN step (two)."""
    out = {}
    for key, kw in (("content", {}), ("content4", dict(groups=4)),
                    ("vgg", dict(loss_cfg=VGG_LOSS, seeds=SEEDS[:1])),
                    ("vgg4", dict(loss_cfg=VGG_LOSS, seeds=SEEDS[:1], groups=4))):
        want = _run(**kw)
        draws = [_run(noise=n, **kw) for n in FLOOR_DRAWS]
        ties = _ties(want, draws)
        out[key] = (want, _limits(want, draws, ties), ties)
    want = _gan_run()
    draws = [_gan_run(noise=n) for n in FLOOR_DRAWS]
    ties = {**{("g", k): v for k, v in _ties(want, draws, "g_grads").items()},
            **{("d", k): v for k, v in _ties(want, draws, "d_grads").items()}}
    errs = [_gan_errors(d, want, ties) for d in draws]
    out["gan"] = (want, {k: max(BASE, FLOOR_FACTOR * max(e[k] for e in errs)) for k in errs[0]},
                  ties)
    return out


def _jax_runs():
    """JAX's content steps (two, L1 + SSIM) and GAN steps (two, D at 64):
    single-device (with two input-noise draws each) and on ("data", "pp")
    meshes of the conftest's CPU devices with the whole state placed by
    JAX's `pp_param_shardings` and the trunk through its `make_pp_apply`
    (S microbatches, the batch over `data`), each run in the port's
    layouts."""
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.models import discriminator as jdisc
    from facesr.models import face_enhance_net as fen
    from facesr.parallel import batch_sharding, get_mesh, make_pp_apply, pp_param_shardings
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt.weights import (discriminator_state_dict_from_jax,
                                           jax_discriminator_from_state_dict, jax_params_from,
                                           state_dict_from_jax_params)

    tree_np = lambda tree: jax.tree.map(np.asarray, jax.device_get(tree))  # noqa: E731
    g_sd = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                         state_dict_from_jax_params(tree_np(tree)).items()}
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**LOSS), seed=0)
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=CLIP)
    tx_d = jsteps.make_optimizer(weight_decay=1e-3, gradient_clip=0.0)
    dcfg = jdisc.DiscriminatorConfig(in_channels=3, base_channels=D_BASE, input_size=GAN_HR)
    dparams, dstats = jax.tree.map(jnp.asarray,
                                   jax_discriminator_from_state_dict(_disc().state_dict()))

    def mesh_apply(cfg, grid):
        """(model apply, mesh, batch sharding) of the single device or a grid."""
        if grid is None:
            return (lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype),
                    None, None)
        d, s = GRIDS[grid]
        mesh = get_mesh(jax.devices()[:d * s], axis_names=("data", "pp"), shape=(d, s))
        apply_pp = make_pp_apply(cfg, mesh, n_micro=s, dp_axis="data")
        return ((lambda p, x, train, dtype: apply_pp(p, x, train=train, dtype=dtype)), mesh,
                batch_sharding(mesh, "data"))

    def runs(fn, state, mesh, batch, seeds, size, record):
        """{noise: the run} (single device: no noise and two draws; one
        compile for them)."""
        step, put = jax.jit(fn), jnp.asarray
        if mesh is not None:
            sh = pp_param_shardings(state, mesh)
            step = jax.jit(fn, in_shardings=(sh, batch), out_shardings=(sh, None))
            state = jax.device_put(state, sh)
            put = lambda x: jax.device_put(x, batch)  # noqa: E731
        out = {}
        for noise in ((None,) if mesh is not None else (None, 11, 12)):
            st, metrics = state, []
            for seed in seeds:
                x = _hr(seed, size=size)
                if noise is not None:
                    x = (x * (1 + FLOOR_NOISE * np.random.default_rng(noise + seed)
                              .standard_normal(x.shape))).astype(np.float32)
                st, m = step(st, put(x))
                metrics.append({k: float(v) for k, v in m.items()})
            out[noise] = record(st, metrics)
        return out

    def content_record(state, metrics):
        return {"losses": [m["loss"] for m in metrics], "params": g_sd(state.params)}

    def gan_record(state, metrics):
        stats = tree_np(state.d_stats)
        d = lambda tree: {k: v.numpy() for k, v in discriminator_state_dict_from_jax(  # noqa
            tree_np(tree), stats).items()}
        adam = lambda tree: next(t for t in jax.tree.leaves(  # noqa: E731
            tree, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(t, "mu"))
        strip = lambda sd: {k: v for k, v in sd.items() if "running" not in k}  # noqa: E731
        g_adam, d_adam = adam(state.opt_state), adam(state.d_opt_state)
        return {"metrics": [{k: m[k] for k in METRICS} for m in metrics], "g": g_sd(state.params),
                "d": d(state.d_params), "g_mu": g_sd(g_adam.mu), "g_nu": g_sd(g_adam.nu),
                "d_mu": strip(d(d_adam.mu)), "d_nu": strip(d(d_adam.nu))}

    out = {}
    for groups in (2, 4):
        cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=groups, blocks_per_group=B)
        params = jax.tree.map(jnp.asarray, jax_params_from(_model(groups)))
        for grid in [None] + [g for g in GRIDS if GROUPS[g] == groups]:
            apply, mesh, batch = mesh_apply(cfg, grid)
            fn = jsteps.make_train_step(apply, jloss.apply, tx, scale_factor=4)
            fresh = jsteps.TrainState(step=jnp.asarray(0), params=params,
                                      opt_state=jsteps.set_learning_rate(tx.init(params), LR),
                                      loss_params=jloss.params)
            for noise, rec in runs(fn, fresh, mesh, batch, SEEDS, HR, content_record).items():
                out["content", groups, grid, noise] = rec
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=2, blocks_per_group=B)
    params = jax.tree.map(jnp.asarray, jax_params_from(_model()))
    for grid in (None,) + JAX_GAN_GRIDS:
        apply, mesh, batch = mesh_apply(cfg, grid)
        fn = jsteps.make_gan_train_step(
            apply, jloss.apply, lambda p, st, x, train: jdisc.apply(p, st, x, dcfg, train=train),
            tx, tx_d, gan_weight=GAN_WEIGHT)
        fresh = jsteps.TrainState(
            step=jnp.asarray(0), params=params,
            opt_state=jsteps.set_learning_rate(tx.init(params), GAN_LR), loss_params=jloss.params,
            d_params=dparams, d_stats=dstats,
            d_opt_state=jsteps.set_learning_rate(tx_d.init(dparams), D_LR))
        for noise, rec in runs(fn, fresh, mesh, batch, GAN_SEEDS, GAN_HR, gan_record).items():
            out["gan", grid, noise] = rec
    return out


@pytest.fixture(scope="module")
def jax_runs(launched):
    return _jax_runs()


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The train CLI on data,pp [1, 2] with --print-memory, started before
    the launches are awaited (a plain launch starts its 2 ranks)."""
    tmp = tmp_path_factory.mktemp("pp_cli")
    _cli_files(tmp)
    proc = subprocess.Popen(
        [sys.executable, "-m", "facesr_torch.cli.train", "--config", str(tmp / "s1.yaml"),
         "--data-root", str(tmp / "data"), "--device", "cpu", "--epochs", "1",
         "--mesh-axes", "data,pp", "--mesh-shape", "1,2", "--print-memory", "--yes"],
        cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp), "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT)})
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()


def _cli_files(tmp):
    """4 train PNGs at 40, 2 val pairs at 32 and 8, and the stage-1 YAML at
    G=2, B=1, C=16, batch 2, HR 32 (``tmp/s1.yaml``) under ``tmp``."""
    from facesr_torch.data import png
    from facesr_torch.data.cv_compat import resize_cubic

    rng = np.random.default_rng(0)
    for split, n, size in (("train", 4, 40), ("val", 2, 32)):
        (tmp / "data" / split / "HR").mkdir(parents=True)
        if split == "val":
            (tmp / "data" / split / "LR").mkdir()
        for i in range(n):
            img = resize_cubic((rng.random((5, 5, 3)) * 255).astype(np.uint8), (size, size))
            png.write_png(tmp / "data" / split / "HR" / f"{i:03d}.png", img)
            if split == "val":
                png.write_png(tmp / "data" / split / "LR" / f"{i:03d}.png",
                              resize_cubic(img, (8, 8)))
    text = (ROOT / "configs" / "stages" / "stage1_psnr_config.yaml").read_text()
    for old, new in (("num_channels: 64", "num_channels: 16"), ("num_groups: 6", "num_groups: 2"),
                     ("blocks_per_group: 10", "blocks_per_group: 1"),
                     ("batch_size: 48", "batch_size: 2"), ("num_workers: 16", "num_workers: 1"),
                     ("hr_patch_size: 256", "hr_patch_size: 32")):
        assert old in text, old
        text = text.replace(old, new)
    (tmp / "s1.yaml").write_text(text)


HISTORY = ("train_loss", "val_loss", "val_psnr", "val_ssim")


def _single_trainer_run(tmp, resume=None, noise=None):
    """The single-process Trainer (inputs times (1 + 2^-23 N(0, 1)) with a
    ``noise`` seed; "micro": the trunk one image at a time): one epoch, or
    with ``resume`` a full resume of that file and its second epoch."""
    def batches(arrays, k):
        if not isinstance(noise, int):
            return [{"hr": b} for b in arrays]
        rng = np.random.default_rng(noise + k)
        return [{"hr": (b * (1 + FLOOR_NOISE * rng.standard_normal(b.shape))).astype(np.float32)}
                for b in arrays]

    tr = _trainer(tmp, batches(TRAIN_BATCHES, 0), batches(VAL_BATCHES, 100),
                  epochs=1 if resume is None else 2)
    if resume is not None:
        tr.load_checkpoint(str(resume))
    with _one_image_trunk(noise):
        return tr.train(), _trainer_state(tr)


def _trainer_limits(tmp, resume=None):
    history, state = _single_trainer_run(tmp / "clean", resume)
    draws = [_single_trainer_run(tmp / f"noise{n}", resume, n) for n in FLOOR_DRAWS]
    limits = {k: max(BASE, FLOOR_FACTOR * max(
        float(np.max(np.abs(np.subtract(h[k], history[k])) / np.abs(history[k])))
        for h, _ in draws)) for k in HISTORY}
    for part, tensors in state.items():
        for k, v in tensors.items():
            limits[part, k] = max(BASE, FLOOR_FACTOR * max(_rel_l2(st[part][k], v)
                                                           for _, st in draws))
    return history, state, limits


@pytest.fixture(scope="module")
def single_trainer(launched, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_single")
    epoch = _trainer_limits(tmp / "epoch")
    resumed = _trainer_limits(tmp / "resumed", resume=tmp / "epoch" / "clean" / "final_model.fckpt")
    return {"epoch": epoch, "resumed": resumed}


@pytest.fixture(scope="module")
def ranks(launched, single, jax_runs, cli_run, single_trainer):
    """`launched`'s results, awaited once the parent's runs are done."""
    return launched.result()


def _check_run(history, state, want_history, want_state, limits):
    for k in HISTORY:
        np.testing.assert_allclose(history[k], want_history[k], rtol=limits[k], err_msg=k)
    for part, tensors in want_state.items():
        for k, v in tensors.items():
            assert _rel_l2(state[part][k], v) <= limits[part, k], (part, k)


def _key(grid):
    return "content" if GROUPS[grid] == 2 else "content4"


# ---------------------------------------------------------------------------
# the placement rule against JAX's


@pytest.mark.parametrize("family,groups,s", [("custom", 2, 2), ("custom", 2, 4),
                                             ("custom", 4, 4), ("esrgan", 0, 2),
                                             ("transfer", 0, 2)])
def test_pp_param_shardings_places_every_leaf_as_jaxs_does(family, groups, s):
    """The port's rule on a whole state (G, its moments and EMA, and for
    FaceEnhanceNet D with its stats and moments and the VGG), against
    JAX's on the same state, each JAX leaf carried to the port's leaves by
    the checkpoint bridge (`ckpt/weights.py`); and the stage of each split
    leaf. At G=2 over 4 stages JAX's leading axis does not divide:
    everything stays replicated (and `make_pp_apply` refuses the model)."""
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.parallel import get_mesh
    from facesr.parallel import pp_param_shardings as jax_pp
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt import weights
    from facesr_torch.models.esrgan import RRDBNet, RRDBNetConfig
    from facesr_torch.models.transfer import TransferModelConfig, TransferSRModel

    if family == "esrgan":
        model = RRDBNet(RRDBNetConfig(num_feat=16, num_blocks=2, num_grow_ch=8), device="cpu")
    elif family == "transfer":
        model = TransferSRModel(TransferModelConfig(backbone_blocks=2, freeze_blocks=2,
                                                    head_blocks=2, head_channels=16),
                                device="cpu")
    else:
        model = _model(groups)
    gan = family == "custom"
    loss = CombinedLoss(LossConfig(**VGG_LOSS), device="cpu")
    opt = optim.AdamW(gradient_clip=CLIP)
    disc = _disc() if gan else None
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters())),
                             loss_params=loss.params, ema_params=steps.init_ema(model), disc=disc,
                             d_opt_state=opt.init(dict(disc.named_parameters())) if gan else None)
    mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), world_size=s,
                      axis_names=("data", "pp"), shape=(1, s),
                      axis_groups={"data": object(), "pp": object()})
    got, stages = pmesh.pp_param_shardings(state, mesh), pmesh.pp_stages(state, mesh)

    tx = jsteps.make_optimizer(gradient_clip=CLIP)
    params = jax.tree.map(jnp.asarray, weights.jax_params_from(model))
    jkw = {}
    if gan:
        dparams, dstats = jax.tree.map(jnp.asarray,
                                       weights.jax_discriminator_from_state_dict(
                                           disc.state_dict()))
        jkw = dict(d_params=dparams, d_stats=dstats, d_opt_state=jax.eval_shape(tx.init, dparams))
    jstate = jsteps.TrainState(step=jnp.asarray(0), params=params,
                               opt_state=jax.eval_shape(tx.init, params),
                               loss_params={"vgg": weights.jax_vgg_params_from(loss.params["vgg"])},
                               ema_params=params, **jkw)
    jmesh = get_mesh(jax.devices()[:2 * s], axis_names=("data", "pp"), shape=(2, s))
    flags = jax.tree.map(lambda sh, leaf: np.full(np.shape(leaf), float(bool(sh.spec)),
                                                  np.float32),
                         jax_pp(jstate, jmesh, axis="pp"), jstate)
    to_port = lambda tree: weights.state_dict_from_jax(tree, model.model_type)  # noqa: E731
    adam = lambda tree: next(t for t in jax.tree.leaves(  # noqa: E731
        tree, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(t, "mu"))
    want = {}
    for part, tree in (("params", flags.params), ("ema_params", flags.ema_params),
                       ("opt_state/mu", adam(flags.opt_state).mu),
                       ("opt_state/nu", adam(flags.opt_state).nu)):
        want.update({f"{part}/{k}": v for k, v in to_port(tree).items()})
    want.update({f"loss_params/vgg/{i}/{k}": v for i, p in enumerate(
        weights.vgg_params_from_jax(flags.loss_params["vgg"])) for k, v in p.items()})
    if gan:
        dsd = weights.discriminator_state_dict_from_jax(flags.d_params, flags.d_stats)
        want.update({f"{'d_stats' if 'running' in k else 'd_params'}/{k}": v
                     for k, v in dsd.items()})
        dmu = weights.discriminator_state_dict_from_jax(adam(flags.d_opt_state).mu,
                                                        flags.d_stats)
        want.update({f"d_opt_state/mu/{k}": v for k, v in dmu.items() if "running" not in k})
    for path, flag in want.items():
        values = np.unique(np.asarray(flag))
        assert len(values) == 1, (path, values)  # a port leaf is one JAX leaf's part
        assert got[path].spec == (("pp",) if values[0] else ()), (path, got[path].spec)
        if values[0]:
            group = int(re.search(r"residual_groups\.(\d+)\.", path).group(1))
            assert stages[path] == group // (groups // s), path
    assert got["step"].spec == () and got["opt_state/count"].spec == ()
    assert len(want) >= len(dict(model.named_parameters())) * 4
    split = {p for p, sh in got.items() if sh.spec}
    assert split == set(stages)
    if family == "custom" and groups % s == 0:
        assert {p.split("/")[0] for p in split} == {"params", "ema_params", "opt_state"}
        assert all("residual_groups." in p for p in split)
    else:
        assert not split


def test_a_ranks_state_is_its_stages_groups_and_the_replicated_leaves():
    """A rank's parameters, moments and EMA at G=2 over 2 stages: at most
    0.85 of one process's (JAX's gate); at 6x10x64 (reckoned from the
    shapes) at most 0.55: the groups hold 4,779,648 of its 5,115,651
    parameters, so a stage holds 0.533."""
    from facesr_torch.utils.profiling import tensor_bytes

    mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), world_size=2,
                      axis_names=("data", "pp"), shape=(1, 2),
                      axis_groups={"data": object(), "pp": object()})
    full = FaceEnhanceNetConfig(num_groups=6, blocks_per_group=10, num_channels=64)
    for build, gate in ((_model, 0.85), (lambda: FaceEnhanceNet(full, device="cpu"), 0.55)):
        for stage in range(2):
            model = build()
            state = steps.TrainState(model=model, opt_state=optim.AdamW().init(
                dict(model.named_parameters())), loss_params={}, ema_params=steps.init_ema(model))
            parts = [model, state.opt_state["mu"], state.opt_state["nu"], state.ema_params]
            whole = tensor_bytes(parts)
            groups = sum(p.numel() for p in model.residual_groups.parameters())
            total = sum(p.numel() for p in model.parameters())
            pipeline.shard_state(state, pipeline.PipeShard(object(), stage, 2),
                                 pmesh.pp_stages(state, mesh))
            share = tensor_bytes(parts) / whole
            assert share == (total - groups / 2) / total and 0.5 < share <= gate, share
        if gate == 0.55:
            assert (groups, total) == (4_779_648, 5_115_651)  # a share of 0.533


# ---------------------------------------------------------------------------
# the pipelined forward


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_the_pipelined_forward_is_bitwise_the_single_process_forward(ranks, grid):
    """`make_pp_apply`'s f32 eval forward of a batch over the grid, in S
    and 2S microbatches, against the model's own forward: max abs <= 1e-6,
    and bitwise at these microbatches; a tick's exchanges as counted. The
    bf16 eval forward at C=64 runs every stage's groups through the group
    kernel's wrapper (its plain version on the CPU), each group once a
    microbatch, and equals the single-process bf16 forward."""
    d, s = GRIDS[grid]
    groups = GROUPS[grid]
    x = torch.from_numpy(np.random.default_rng(3).random((FWD_BATCH, 8, 8, 3),
                                                         dtype=np.float32))
    with torch.no_grad():
        want = _model(groups)(x).numpy()
        want16 = _model(groups, channels=64, blocks=1)(x[:8 * d], dtype=torch.bfloat16)
    for r in ranks[0][grid]:
        f = r["forward"]
        for n_micro in (s, 2 * s):
            assert np.abs(f[n_micro] - want).max() <= 1e-6
            assert np.array_equal(f[n_micro], want)
            assert f[f"exchanges{n_micro}"] == {"shift": n_micro + s - 2, "broadcast": 1}
        assert np.array_equal(f["bf16"], want16.float().numpy())
        assert f["kernel_calls"] == groups // s * s  # G/S groups a stage, S microbatches


# ---------------------------------------------------------------------------
# training on data,pp


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_pp_content_steps_match_the_single_process_steps(ranks, single, grid):
    want, limits, _ = single[_key(grid)]
    d, s = GRIDS[grid]
    for r in ranks[0][grid]:
        assert r["coords"] == divmod(r["rank"], s)
        errors = _errors(r["content"], want, single[_key(grid)][2])
        assert not _over(errors, limits), _over(errors, limits)
        assert len(errors) == len(limits) > 100
        # a step in S microbatches: 2S - 2 shifts each way; the optimiser's
        # clip sum, the replicated gradients' mean, and the recorder's gather
        assert r["content"]["exchanges"] == {"shift": 2 * s - 2, "shift_grad": 2 * s - 2,
                                             "copy": 1, "broadcast": 1, "sum": 1, "mean": 1,
                                             "whole": 1}


def test_pp_content_steps_in_2s_microbatches_match_the_single_process_steps(ranks, single):
    want, limits, ties = single["content"]
    for r in ranks[0]["1x2"]:
        errors = _errors(r["content_2s"], want, ties)
        assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_the_pp_step_with_the_vgg_loss_and_the_clip_matches_the_single_process_step(
        ranks, single, grid):
    want, limits, ties = single["vgg" if GROUPS[grid] == 2 else "vgg4"]
    assert float(optim.global_norm({k: torch.from_numpy(v) for k, v in want["grads"][0].items()},
                                   {})) > CLIP  # the clip is active
    for r in ranks[0][grid]:
        errors = _errors(r["vgg"], want, ties)
        assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("control", CONTROLS)
def test_each_planted_control_is_rejected(ranks, single, control):
    want, limits, ties = single["vgg"]
    over = _over(_errors(ranks[0]["1x2"][0]["controls"][control], want, ties), limits)
    part = "mu." if control == "clip_without_pp_sum" else "grads0.residual_groups"
    assert sum(k.startswith(part) for k in over) > 10, (control, len(over))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_every_rank_of_the_grid_holds_bitwise_the_same_gathered_state(ranks, grid):
    out = ranks[0][grid]
    for key in ("content", "vgg") + (("gan",) if grid in GAN_GRIDS else ()):
        runs = [r[key] for r in out]
        for run in runs[1:]:
            for part in ("params", "mu", "g", "d", "g_mu", "d_mu"):
                if part in runs[0]:
                    assert all(np.array_equal(run[part][k], v)
                               for k, v in runs[0][part].items()), (key, part)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_pp_eval_step_matches_the_single_process_eval_step(ranks, grid):
    d, _ = GRIDS[grid]
    state, _, _, apply, _ = _content_step(groups=GROUPS[grid])
    want, _, _ = steps.make_eval_step(apply)(state, torch.from_numpy(_hr(20)))
    for r in ranks[0][grid]:
        assert r["eval_rows"] == (BATCH // d, HR, HR, 3)
        for k, v in want.items():
            np.testing.assert_allclose(r["eval"][k], float(v), rtol=BASE, err_msg=k)


def _jax_limits(jax_runs, kind, *key, ties=None):
    """JAX's single-device run and each quantity's limit: max(BASE, 10 x its
    own floor of two input draws), parameters off the port's Adam ties."""
    want = jax_runs[(kind, *key, None, None)]
    errs = [(_gan_errors(jax_runs[(kind, *key, None, n)], want, ties, grads=False)
             if kind == "gan" else _errors(jax_runs[(kind, *key, None, n)], want, ties))
            for n in (11, 12)]
    return want, {k: max(BASE, FLOOR_FACTOR * max(e[k] for e in errs)) for k in errs[0]}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_jaxs_pp_content_step_matches_its_single_device_step(jax_runs, single, grid):
    ties = single[_key(grid)][2]
    want, limits = _jax_limits(jax_runs, "content", GROUPS[grid], ties=ties)
    errors = _errors(jax_runs["content", GROUPS[grid], grid, None], want, ties)
    assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_pp_content_steps_match_jaxs_pp_and_dp_x_pp_steps(ranks, single, jax_runs, grid):
    """Each quantity's gap to JAX's pp run at most the single-process port
    run's gap to JAX's single-device run plus its limit."""
    want, limits, ties = single[_key(grid)]
    jax_single = jax_runs["content", GROUPS[grid], None, None]
    own_gap = _errors(want, jax_single, ties)
    for r in ranks[0][grid]:
        gap = _errors(r["content"], jax_runs["content", GROUPS[grid], grid, None], ties)
        over = {k: (v, own_gap[k] + limits[k]) for k, v in gap.items()
                if v > own_gap[k] + limits[k]}
        assert not over, over


@pytest.mark.parametrize("grid", GAN_GRIDS)
def test_pp_gan_steps_match_the_single_process_steps(ranks, single, grid):
    want, limits, ties = single["gan"]
    for r in ranks[0][grid]:
        errors = _gan_errors(r["gan"], want, ties)
        assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("grid", JAX_GAN_GRIDS)
def test_jaxs_pp_gan_step_matches_its_single_device_step(jax_runs, single, grid):
    """JAX's GAN step through its `make_pp_apply` with the whole state
    placed by its `pp_param_shardings`, against its single-device step,
    parameters off the Adam ties. Its [2, 2] step is not checked: it lands
    0.0030 (G over its update) and 0.0038 (G's first moments) from the
    single-device run against a floor of 1e-4, the same gap as the port's
    single-process run and one of its input-noise draws show, a rounding
    event two GAN steps amplify; the port's [2, 2] run is held to JAX's
    single-device run."""
    ties = single["gan"][2]
    want, limits = _jax_limits(jax_runs, "gan", ties=ties)
    errors = _gan_errors(jax_runs["gan", grid, None], want, ties, grads=False)
    assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("grid", GAN_GRIDS)
def test_pp_gan_steps_match_jaxs_pp_and_dp_x_pp_gan_steps(ranks, single, jax_runs, grid):
    """Each quantity's gap to JAX's pp run ([1, 2]; JAX's single-device run
    for [2, 2]) at most the single-process port run's gap to JAX's
    single-device run plus its limit."""
    want, limits, ties = single["gan"]
    own_gap = _gan_errors(want, jax_runs["gan", None, None], ties, grads=False)
    ref = grid if grid in JAX_GAN_GRIDS else None
    for r in ranks[0][grid]:
        gap = _gan_errors(r["gan"], jax_runs["gan", ref, None], ties, grads=False)
        over = {k: (v, own_gap[k] + limits[k]) for k, v in gap.items()
                if v > own_gap[k] + limits[k]}
        assert not over, over


# ---------------------------------------------------------------------------
# the Trainer, its checkpoints and the CLI


def test_a_data_pp_trainer_epoch_writes_on_rank0_only_and_equals_the_single_process_one(
        ranks, single_trainer):
    from facesr_torch.ckpt.weights import read_state_dict

    out, tmp = ranks[0]["1x2"], ranks[1] / "1x2"
    assert [r["writer"] for r in out] == [True, False]
    assert not (tmp / "rank1" / "pp").exists()
    files = {p.name for p in (tmp / "rank0" / "pp").iterdir()}
    assert {"final_model.fckpt", "final_model.pth", "best_model.fckpt"} <= files
    for r in out:
        _check_run(r["history"], r["trainer_state"], *single_trainer["epoch"])
        assert r["revalidated"] == {k: r["history"][f"val_{k}"][-1]
                                    for k in ("loss", "psnr", "ssim")}
    for part, tensors in out[0]["trainer_state"].items():
        assert all(np.array_equal(v, out[1]["trainer_state"][part][k])
                   for k, v in tensors.items()), part
    model = _model()
    model.load_state_dict(read_state_dict(str(tmp / "rank0" / "pp" / "final_model.pth")),
                          strict=True)
    assert all(np.array_equal(v.numpy(), out[0]["trainer_state"]["params"][k])
               for k, v in model.state_dict().items())


def test_a_pp_trainer_file_resumes_in_one_process_and_in_the_jax_trainer(ranks, tmp_path):
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from facesr.losses import combined as jcombined
    from facesr.models import face_enhance_net as fen
    from facesr.training.trainer import Trainer as JaxTrainer
    from facesr.training.trainer import TrainerConfig as JaxTrainerConfig
    from facesr_torch.ckpt import fckpt
    from facesr_torch.ckpt.weights import jax_params_from, state_dict_from_jax_params

    out, tmp = ranks[0]["1x2"], ranks[1] / "1x2"
    path = tmp / "rank0" / "pp" / "final_model.fckpt"
    back = _trainer(tmp_path / "back", [{"hr": TRAIN_BATCHES[0]}], [])
    back.load_checkpoint(str(path))
    got, want = _trainer_state(back), out[0]["trainer_state"]
    for part, tensors in want.items():
        assert all(np.array_equal(got[part][k], v) for k, v in tensors.items()), part
    assert back.current_epoch == 1 and back.state.step == len(TRAIN_BATCHES)
    back.config.epochs = 2
    history = back.train()  # and trains
    assert back.state.step == len(TRAIN_BATCHES) + 1 and math.isfinite(history["train_loss"][-1])

    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=2, blocks_per_group=B)
    jt = JaxTrainer(fen.FaceEnhanceNet(cfg, params=jax.tree.map(jnp.asarray,
                                                                jax_params_from(_model()))),
                    [], [], jcombined.CombinedLoss(jcombined.LossConfig(**VGG_LOSS), seed=1),
                    config=JaxTrainerConfig(epochs=1, learning_rate=LR, weight_decay=1e-2,
                                            gradient_clip=CLIP, use_amp=False, ema_decay=0.9,
                                            checkpoint_dir=str(tmp_path / "jax"),
                                            log_dir=str(tmp_path / "jax_logs"),
                                            use_wandb=False, step_log_every=0))
    jt.load_checkpoint(str(path))
    host = serialization.to_state_dict(jax.tree.map(np.asarray, jt.state))
    tree, _ = fckpt.load_checkpoint(str(path))
    for k, v in state_dict_from_jax_params(fckpt.restore_list_nodes(host["params"])).items():
        assert np.array_equal(v.numpy(), want["params"][k]), k
    assert int(host["step"]) == len(TRAIN_BATCHES) == int(tree["step"])
    assert jt.current_epoch == 1


def test_a_single_process_file_resumes_on_data_pp_and_trains_as_one_process(
        ranks, single_trainer):
    out = ranks[0]["1x2"]
    assert all(r["restored"] for r in out)  # each rank's whole state is the file's
    for r in out:
        _check_run(r["resumed_history"], r["resumed_state"], *single_trainer["resumed"])


def test_a_pp_trainers_memory_report_counts_a_ranks_stage(ranks):
    from facesr_torch.utils.profiling import tensor_bytes

    whole = tensor_bytes(_model())
    groups = tensor_bytes(_model().residual_groups)
    for r in ranks[0]["1x2"]:
        assert r["report"]["params_bytes"] == r["model_bytes"] == whole - groups // 2
        assert r["report"]["peak_step_bytes"] is None  # measured on a card only
    for grid in GRIDS:  # a step's state: its stage's groups and the rest
        for r in ranks[0][grid]:
            model = _model(GROUPS[grid])
            full = 3 * tensor_bytes(model)
            held = 3 * (tensor_bytes(model) - tensor_bytes(model.residual_groups)
                        + tensor_bytes(model.residual_groups) // GRIDS[grid][1])
            assert r["state_bytes"] == held and held <= 0.85 * full


def test_the_train_cli_trains_on_data_pp_over_two_ranks(cli_run, ranks):
    """A plain launch with --mesh-axes data,pp --mesh-shape 1,2 starts its
    two ranks; both load the same rows and run their stage's groups; rank
    0 writes the whole checkpoints."""
    from facesr_torch.ckpt import fckpt
    from facesr_torch.ckpt.weights import read_state_dict

    proc, tmp = cli_run
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-4000:]
    assert "Starting 2 ranks" in log
    for r in range(2):
        assert f"rank {r} of 2 on cpu, at (0, {r}) of the data,pp grid (1, 2)" in log
    assert "Batch size: 2 global, 2 a rank over 1 rank(s) of the data axis" in log
    assert len(re.findall(r"rank \d of 2, device memory", log)) == 2
    psnr = [float(v) for v in re.findall(r"Val PSNR:\s+([-\d.]+) dB", log)]
    assert psnr and all(math.isfinite(v) for v in psnr)
    _, meta = fckpt.load_checkpoint(str(tmp / "checkpoints" / "final_model.fckpt"))
    assert meta["global_step"] == 2 and meta["config"]["mesh_axes"] == "data,pp"
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=2,
                                                blocks_per_group=1), device="cpu")
    model.load_state_dict(read_state_dict(str(tmp / "checkpoints" / "final_model.pth")),
                          strict=True)
    assert all(math.isfinite(float(v.abs().sum())) for v in model.state_dict().values())


# ---------------------------------------------------------------------------
# refusals


@pytest.mark.parametrize("what", ["space", "model", "qat", "esrgan", "transfer", "groups",
                                  "n_micro", "hosts"])
def test_what_jax_refuses_under_pp_is_refused(what, monkeypatch, tmp_path):
    from facesr_torch.models.esrgan import RRDBNet, RRDBNetConfig
    from facesr_torch.models.transfer import TransferModelConfig, TransferSRModel
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    if what in ("space", "model"):
        with pytest.raises(ValueError, match=f"cannot combine '{what}' and 'pp'"):
            pmesh.check_mesh_axes(("data", what, "pp"))
        with pytest.raises(ValueError, match=f"cannot combine '{what}' and 'pp'"):
            pmesh.get_mesh(["cpu"] * 4, axis_names=("data", what, "pp"), shape=(1, 2, 2))
        # space with model is ported (tests/test_torch_sp_tp.py); pp on
        # top of both, a fourth axis, is refused with JAX's message
        pmesh.check_mesh_axes(("data", "space", "model"))
        with pytest.raises(ValueError, match="cannot combine 'model' and 'pp'"):
            pmesh.check_mesh_axes(("data", "space", "model", "pp"))
        return
    mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), world_size=2,
                      axis_names=("data", "pp"), shape=(1, 2),
                      axis_groups={"data": object(), "pp": object()})
    model, cfg, match = _model(), {}, None
    if what == "qat":
        cfg, match = dict(qat=True), "qat \\+ pipeline parallelism is not supported"
    elif what == "esrgan":
        model = RRDBNet(RRDBNetConfig(num_feat=16, num_blocks=2, num_grow_ch=8), device="cpu")
        match = "requires the FaceEnhanceNet trunk, not model_type='esrgan'"
    elif what == "transfer":
        model = TransferSRModel(TransferModelConfig(backbone_blocks=2, freeze_blocks=2,
                                                    head_blocks=2, head_channels=16),
                                device="cpu")
        match = "requires the FaceEnhanceNet trunk, not model_type='transfer'"
    elif what == "groups":
        model, match = _model(3), "num_groups=3 must divide over 2 pipeline stages"
        with pytest.raises(ValueError, match=match):
            pipeline.make_pp_apply(model, mesh)
    elif what == "n_micro":  # raised by the call, as in JAX
        apply = pipeline.make_pp_apply(_model(), mesh, n_micro=3)
        with pytest.raises(ValueError, match="pipeline n_micro=3 must divide the local batch 4"):
            apply(torch.zeros((4, 8, 8, 3)))
        return
    elif what == "hosts":
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
        match = "single-host for now"
    with pytest.raises(NotImplementedError if what == "hosts" else ValueError, match=match):
        Trainer(model, [], [], CombinedLoss(LossConfig(**LOSS), device="cpu"),
                TrainerConfig(mesh_axes="data,pp", mesh_shape=(1, 2),
                              checkpoint_dir=str(tmp_path), **cfg), device="cpu", mesh=mesh)
