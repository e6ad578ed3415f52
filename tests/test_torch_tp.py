"""Tensor parallelism (tp) of the port on the CPU: `tp_param_shardings`
against JAX's on every leaf of the same training state, the forward on a
rank's channel slices against the whole one, and the content and eval
steps, the Trainer (its checkpoints and resumes both ways) and the train
CLI on `data,model` grids of gloo ranks started by
`facesr_torch.parallel.launch`, against the single-process step and JAX's
tp and dp x tp steps on the conftest's CPU devices.

Sizes: FaceEnhanceNet G=2, B=2, C=16 (every weight perturbed off its init
from numpy, conv_last redrawn non-zero); RRDBNet 2 RRDBs x 16 features
(growth 8) and the transfer model 2 + 2 x 16 in stage 2; HR 32, a global
batch of 4, on [1, 2] (2 ranks) and [2, 2] (4 ranks) grids, one launch
each in a background thread that the parent's single-process and JAX runs
overlap; the child processes import torch and the port only, never JAX.
The shardings are compared at G=2, B=2, C=16 with D at 64 (8 base
channels) and the VGG to conv4_4, at t = 2 and t = 4.

Tolerances: a conv with half the output channels is not bitwise the
whole conv's slice, and the clip's norm and the SE means add in other
orders, so each quantity is held to max(1e-4, 10 x its rounding floor):
how far the single-process run itself moves when its input is multiplied
by (1 + 2^-23 N(0, 1)), the larger of two draws (a near-zero L1 or SSIM
term that flips sign under rounding moves a few tensors 3e-5 on one draw
of these). Losses and metrics relatively, gradients, parameters and
moments by relative L2 a tensor. The ranks against each other bitwise.
The planted controls, a gather whose backward sums over `model` (t x the
gradients upstream of it) and a clip whose norm skips the `model` sum
(the moments scaled by another factor), put tensors over their limits.
"""

import math
import re
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.cli.step_numerics import RecordingAdamW
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.parallel import launch, tensor
from facesr_torch.parallel import mesh as pmesh
from facesr_torch.training import optim, steps

torch.set_num_threads(1)

G, B, C, HR, BATCH = 2, 2, 16, 32, 4
LR = 1e-3
CLIP = 0.5
LOSS = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1)
VGG_LOSS = dict(l1_weight=1.0, perceptual_weight=0.1, ssim_weight=0.1)
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
SEEDS = (10, 11)
FAMILIES = ("custom", "esrgan", "transfer")
CONTROLS = ("gather_backward_sum", "clip_without_model_sum")
BASE = 1e-4
FLOOR_FACTOR = 10
FLOOR_NOISE = 2.0 ** -23
FLOOR_SEEDS = (11, 12)
ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# what the ranks and the parent both build (torch and numpy only)


def _perturbed(model, seed=0):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            last = name.endswith("conv_last.weight")
            noise = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            p.copy_(noise * 0.05 if last else p + noise * 0.02)
    return model


def _model(family="custom"):
    from facesr_torch.models.esrgan import RRDBNet, RRDBNetConfig
    from facesr_torch.models.transfer import (TrainingStage, TransferModelConfig,
                                              TransferSRModel)

    if family == "esrgan":
        return _perturbed(RRDBNet(RRDBNetConfig(num_feat=16, num_blocks=2, num_grow_ch=8),
                                  seed=0, device="cpu"))
    if family == "transfer":
        model = TransferSRModel(TransferModelConfig(backbone_blocks=2, freeze_blocks=2,
                                                    head_blocks=2, head_channels=16),
                                seed=0, device="cpu")
        model.set_training_stage(TrainingStage.STAGE2_PARTIAL_FINETUNE)
        return _perturbed(model)
    return _perturbed(FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=G,
                                                          blocks_per_group=B),
                                     seed=0, device="cpu"))


def _hr(seed, n=BATCH, size=HR) -> np.ndarray:
    """Smooth HR images in [0, 1]."""
    rng = np.random.default_rng(seed)
    lo = rng.random((n, size // 4, size // 4, 3), dtype=np.float32)
    return np.clip(np.kron(lo, np.ones((1, 4, 4, 1), np.float32))
                   + rng.normal(0, 0.02, (n, size, size, 3)), 0, 1).astype(np.float32)


def _content_step(mesh=None, loss_cfg=LOSS, family="custom"):
    """A content step of ``family`` (tp: its state split over the grid's
    `model` group): (state, optimiser, step, loss apply, specs)."""
    model = _model(family)
    loss = CombinedLoss(LossConfig(**loss_cfg), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=CLIP)
    state = steps.TrainState(model=model, opt_state=opt.init(steps.trainable_parameters(model),
                                                             LR),
                             loss_params=loss.params)
    apply = lambda lp, p, t: loss.apply(lp, p, t)  # noqa: E731
    step = steps.make_train_step(apply, opt, mesh=mesh)
    specs = None
    if mesh is not None:
        specs = pmesh.tp_param_shardings(state, mesh)
        tensor.shard_state(state, mesh.model_shard(), specs)
    return state, opt, step, apply, specs


def _np(named) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named}


def _whole(state, mesh, specs) -> dict:
    """The parameters and first moments, gathered whole (a collective)."""
    shard = mesh.model_shard()
    tensor.unshard_state(state, shard, specs)
    out = {"params": _np(state.model.state_dict().items()),
           "mu": _np(state.opt_state["mu"].items())}
    tensor.shard_state(state, shard, specs)
    return out


def _rows(x: np.ndarray, mesh=None) -> torch.Tensor:
    """This rank's batch rows of a global batch (all of it without a mesh)."""
    return torch.from_numpy(np.ascontiguousarray(x if mesh is None
                                                 else pmesh.shard_batch(x, mesh)))


def _run(mesh=None, loss_cfg=LOSS, family="custom", seeds=SEEDS, noise=None):
    """Steps on ``seeds`` (inputs times (1 + 2^-23 N(0, 1)) with a ``noise``
    seed): each step's loss and gradients, then the parameters and moments."""
    state, opt, step, _, specs = _content_step(mesh, loss_cfg, family)
    out = {"losses": [], "grads": [], "exchanges": None}
    for seed in seeds:
        x = _rows(_hr(seed), mesh)
        if noise is not None:
            x = x * (1 + FLOOR_NOISE * torch.randn(x.shape, generator=torch.Generator()
                                                   .manual_seed(noise)))
        _, m = step(state, x)
        out["losses"].append(float(m["loss"]))
        out["grads"].append({k: v.numpy() for k, v in opt.grads.items()})
        if out["exchanges"] is None and mesh is not None:
            out["exchanges"] = dict(step.model_shard.counts)
    if mesh is None:
        out.update(params=_np(state.model.state_dict().items()),
                   mu=_np(state.opt_state["mu"].items()))
    else:
        out.update(_whole(state, mesh, specs))
    return out


TRAIN_BATCHES = [_hr(40 + i) for i in range(2)]
VAL_BATCHES = [_hr(50)]


def _trainer(ckpt_dir, train, val, mesh=None, epochs=1, **cfg):
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    config = TrainerConfig(epochs=epochs, learning_rate=LR, weight_decay=1e-2,
                           gradient_clip=CLIP, use_amp=False, save_every=1,
                           checkpoint_dir=str(ckpt_dir), ema_decay=0.9, step_log_every=0,
                           scheduler_T_max=4, async_checkpoint=False, **cfg)
    return Trainer(_model(), train, val, CombinedLoss(LossConfig(**VGG_LOSS), device="cpu"),
                   config, device="cpu", mesh=mesh)


def _trainer_state(tr) -> dict:
    """A Trainer's parameters, moments, EMA and VGG, whole (a collective
    under tp)."""
    with tr.whole_state():
        return {"params": _np(tr.model.state_dict().items()),
                "mu": _np(tr.state.opt_state["mu"].items()),
                "nu": _np(tr.state.opt_state["nu"].items()),
                "ema": _np(tr.state.ema_params.items()),
                "vgg": _np((f"{i}.{k}", v) for i, p in enumerate(tr.loss_fn.params["vgg"])
                           for k, v in p.items())}


def _trainers(mesh, tmp):
    """A data,model Trainer epoch (rank 0 writes); a single-process file
    (each rank writes its own) resumed fully by a 2-epoch data,model
    Trainer, which trains epoch 2; the memory report."""
    from facesr_torch.utils.profiling import tensor_bytes

    own = Path(tmp) / f"rank{mesh.rank}"
    train = [{"hr": pmesh.shard_batch(b, mesh)} for b in TRAIN_BATCHES]
    val = [{"hr": pmesh.shard_batch(b, mesh)} for b in VAL_BATCHES]
    grid = dict(mesh_axes="data,model", mesh_shape=mesh.shape)
    out = {}
    tr = _trainer(own / "tp", train, val, mesh, **grid)
    out["history"] = tr.train()
    out["writer"] = tr.is_writer
    out["trainer_state"] = _trainer_state(tr)
    # memory_report's snapshot and restore on a card: the state as it
    # stands (this rank's slices), the EMA's new tensors marked again so
    # the EMA validation runs on the slices
    tr._restore_payload(tr._checkpoint_payload())
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


def _planted(control):
    """Patch a fault into the tp path; returns the undo."""
    import torch.distributed as dist

    if control == "gather_backward_sum":
        real = tensor._Gather.backward

        def summed(ctx, grad):
            g = real(ctx, grad)[0].clone()
            dist.all_reduce(g, group=ctx.shard.group)
            return g, None, None

        tensor._Gather.backward = staticmethod(summed)
        return lambda: setattr(tensor._Gather, "backward", staticmethod(real))
    real_norm = optim.global_norm
    optim.global_norm = lambda grads, params, shard=None: real_norm(grads, params, None)
    return lambda: setattr(optim, "global_norm", real_norm)


def _forward_check(mesh):
    """The eval forward on the rank's channel slices, and the conv weights
    and outputs each `F.conv2d` call sees there."""
    import torch.nn.functional as F

    model = _model()
    lr = torch.from_numpy(np.random.default_rng(3).random((2, 8, 8, 3), dtype=np.float32))
    state = steps.TrainState(model=model, opt_state={}, loss_params={})
    shard = mesh.model_shard()
    tensor.shard_state(state, shard, pmesh.tp_param_shardings(state, mesh))
    seen, real = [], F.conv2d

    def recording(x, w, *args, **kwargs):
        y = real(x, w, *args, **kwargs)
        seen.append((int(w.shape[0]), int(y.shape[1])))
        return y

    F.conv2d = recording
    try:
        with torch.no_grad(), tensor.split(shard):
            sr = model(lr, train=False)
    finally:
        F.conv2d = real
    return {"sr": sr.numpy(), "seen": seen, "exchanges": dict(shard.counts)}


def _worker(mesh, tmp, extras):
    """Everything a rank of one grid runs, in one launch."""
    from facesr_torch.utils.profiling import tensor_bytes

    torch.set_num_threads(1)
    out = {"rank": mesh.rank, "coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
    out["content"] = _run(mesh)
    state, opt, step, apply, _ = _content_step(mesh)
    metrics, sr, _ = steps.make_eval_step(apply, mesh=mesh)(state, _rows(_hr(20), mesh))
    out["eval"] = {k: float(v) for k, v in metrics.items()}
    out["eval_rows"] = tuple(sr.shape)
    out["state_bytes"] = tensor_bytes([state.model, state.opt_state["mu"], state.opt_state["nu"]])
    out["vgg"] = _run(mesh, VGG_LOSS, seeds=SEEDS[:1])
    out["zoo"] = {family: _run(mesh, family=family) for family in FAMILIES[1:]}
    out["controls"] = {}
    for control in CONTROLS:
        undo = _planted(control)
        try:
            out["controls"][control] = _run(mesh, VGG_LOSS, seeds=SEEDS[:1])
        finally:
            undo()
    if "forward" in extras:
        out["forward"] = _forward_check(mesh)
    if "trainers" in extras:
        out.update(_trainers(mesh, tmp))
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both grids' ranks, one grid after the other in a background thread,
    so that the parent's single-process and JAX runs overlap them."""
    tmp = tmp_path_factory.mktemp("tp")

    def run():
        out = {}
        for name, (d, t) in GRIDS.items():
            extras = ("forward", "trainers") if name == "1x2" else ()
            out[name] = launch.run_ranks(_worker, d * t, args=(str(tmp / name), extras),
                                         devices=["cpu"] * (d * t), timeout=120,
                                         run_timeout=400, axis_names=("data", "model"),
                                         shape=(d, t))
        return out, tmp

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _errors(got, want) -> dict:
    """Each quantity's error of a `_run` record against another: the losses
    relatively, the gradients, parameters and moments by relative L2."""
    out = {f"loss{i}": abs(a - b) / abs(b) for i, (a, b) in
           enumerate(zip(got["losses"], want["losses"]))}
    for i, grads in enumerate(want["grads"]):
        out.update({f"grads{i}.{k}": _rel_l2(got["grads"][i][k], v) for k, v in grads.items()})
    for part in ("params", "mu"):
        out.update({f"{part}.{k}": _rel_l2(got[part][k], v) for k, v in want[part].items()})
    return out


def _limits(want, floor_runs) -> dict:
    """max(BASE, FLOOR_FACTOR x the floor) a quantity, the floor being the
    larger of the noise draws' errors."""
    draws = [_errors(run, want) for run in floor_runs]
    return {k: max(BASE, FLOOR_FACTOR * max(d[k] for d in draws)) for k in draws[0]}


def _over(errors, limits) -> dict:
    return {k: (e, limits[k]) for k, e in errors.items() if e > limits[k]}


@pytest.fixture(scope="module")
def single(launched):
    """The single-process runs and their rounding floors: the content step
    (two steps), the VGG step (one) and the zoo's content steps (two)."""
    out = {}
    for key, kw in (("content", {}), ("vgg", dict(loss_cfg=VGG_LOSS, seeds=SEEDS[:1])),
                    ("esrgan", dict(family="esrgan")), ("transfer", dict(family="transfer"))):
        want = _run(**kw)
        out[key] = (want, _limits(want, [_run(noise=s, **kw) for s in FLOOR_SEEDS]))
    return out


@pytest.fixture(scope="module")
def jax_steps(launched):
    """JAX's content step, two steps, on a ("data", "model") mesh of the
    conftest's CPU devices with the whole state placed by its
    `tp_param_shardings`: [1, 2] (tp, the batch replicated) and [2, 2]
    (dp x tp, the batch over data)."""
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.models import face_enhance_net as fen
    from facesr.parallel import batch_sharding, get_mesh, replicated
    from facesr.parallel import tp_param_shardings as jax_tp
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt.weights import jax_params_from, state_dict_from_jax_params

    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**LOSS), seed=0)
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=CLIP)
    params = jax.tree.map(jnp.asarray, jax_params_from(_model()))
    out = {}
    for grid, (d, t) in GRIDS.items():
        mesh = get_mesh(jax.devices()[:d * t], axis_names=("data", "model"), shape=(d, t))
        state = jsteps.TrainState(step=jnp.asarray(0), params=params,
                                  opt_state=jsteps.set_learning_rate(tx.init(params), LR),
                                  loss_params=jloss.params)
        sh = jax_tp(state, mesh, axis="model")
        batch = replicated(mesh) if d == 1 else batch_sharding(mesh, "data")
        step = jax.jit(jsteps.make_train_step(
            lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype),
            jloss.apply, tx, scale_factor=4, compute_dtype=None),
            in_shardings=(sh, batch), out_shardings=(sh, None))
        state = jax.device_put(state, sh)
        losses = []
        for seed in SEEDS:
            state, m = step(state, jax.device_put(_hr(seed), batch))
            losses.append(float(m["loss"]))
        host = jax.tree.map(np.asarray, jax.device_get(state.params))
        out[grid] = {"losses": losses,
                     "params": {k: v.numpy() for k, v in state_dict_from_jax_params(host).items()}}
    return out


def _cli_files(tmp):
    """4 train PNGs at 40, 2 val pairs at 32 and 8, and the stage-1 YAML at
    G=1, B=2, C=16, batch 2, HR 32 (``tmp/s1.yaml``) under ``tmp``."""
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
    for old, new in (("num_channels: 64", "num_channels: 16"), ("num_groups: 6", "num_groups: 1"),
                     ("blocks_per_group: 10", "blocks_per_group: 2"),
                     ("batch_size: 48", "batch_size: 2"), ("num_workers: 16", "num_workers: 1"),
                     ("hr_patch_size: 256", "hr_patch_size: 32")):
        assert old in text, old
        text = text.replace(old, new)
    (tmp / "s1.yaml").write_text(text)


def _cli_env(tmp, **extra):
    return {"PATH": "/usr/bin:/bin", "HOME": str(tmp), "OMP_NUM_THREADS": "1",
            "PYTHONPATH": str(ROOT), **extra}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The train CLI on data,model [1, 2] with --print-memory, started
    before the launches are awaited (a plain launch starts its 2 ranks)."""
    tmp = tmp_path_factory.mktemp("tp_cli")
    _cli_files(tmp)
    proc = subprocess.Popen(
        [sys.executable, "-m", "facesr_torch.cli.train", "--config", str(tmp / "s1.yaml"),
         "--data-root", str(tmp / "data"), "--device", "cpu", "--epochs", "1",
         "--mesh-axes", "data,model", "--mesh-shape", "1,2", "--print-memory", "--yes"],
        cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_cli_env(tmp))
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def single_trainer(launched, tmp_path_factory):
    """The single-process Trainer runs and their limits (`_trainer_limits`):
    an epoch, and a full resume of its file that trains epoch 2 (the ranks
    resume the same file, each written by its own single-process run)."""
    tmp = tmp_path_factory.mktemp("tp_single")
    epoch = _trainer_limits(tmp / "epoch")
    resumed = _trainer_limits(tmp / "resumed", resume=tmp / "epoch" / "clean" / "final_model.fckpt")
    return {"epoch": epoch, "resumed": resumed}


@pytest.fixture(scope="module")
def ranks(launched, single, jax_steps, cli_run, single_trainer):
    """`launched`'s results, awaited once the parent's runs are done."""
    return launched.result()


# ---------------------------------------------------------------------------
# the placement rule against JAX's


def _jax_flags(jstate, jsh):
    """JAX's placement as a tree of arrays of the leaves' shapes: 1 where
    the leaf splits, 0 where it is whole."""
    import jax

    return jax.tree.map(lambda s, leaf: np.full(np.shape(leaf), float(bool(s.spec)),
                                                np.float32), jsh, jstate)


def _adam(tree):
    import optax

    if isinstance(tree, optax.ScaleByAdamState):
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _adam(t)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_tp_param_shardings_places_every_leaf_as_jaxs_does(family, t):
    """The port's rule on a whole state (G, its moments and EMA, and for
    FaceEnhanceNet D with its stats and moments and the VGG), against
    JAX's on the same state, each JAX leaf carried to the port's leaves
    by the checkpoint bridge (`ckpt/weights.py`)."""
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.parallel import get_mesh
    from facesr.parallel import tp_param_shardings as jax_tp
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt import weights
    from facesr_torch.models import discriminator as dmod

    model = _model(family)
    gan = family == "custom"
    loss = CombinedLoss(LossConfig(**VGG_LOSS), device="cpu")
    opt = optim.AdamW(gradient_clip=CLIP)
    disc = dmod.create_discriminator(input_size=64, base_channels=8, device="cpu") if gan else None
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters())),
                             loss_params=loss.params, ema_params=steps.init_ema(model), disc=disc,
                             d_opt_state=opt.init(dict(disc.named_parameters())) if gan else None)
    mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), world_size=t,
                      axis_names=("data", "model"), shape=(1, t),
                      axis_groups={"data": object(), "model": object()})
    got = pmesh.tp_param_shardings(state, mesh)

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
    jmesh = get_mesh(jax.devices()[:2 * t], axis_names=("data", "model"), shape=(2, t))
    flags = _jax_flags(jstate, jax_tp(jstate, jmesh, axis="model"))
    to_port = lambda tree: weights.state_dict_from_jax(tree, model.model_type)  # noqa: E731
    want = {}
    for part, tree in (("params", flags.params), ("ema_params", flags.ema_params),
                       ("opt_state/mu", _adam(flags.opt_state).mu),
                       ("opt_state/nu", _adam(flags.opt_state).nu)):
        want.update({f"{part}/{k}": v for k, v in to_port(tree).items()})
    want.update({f"loss_params/vgg/{i}/{k}": v for i, p in enumerate(
        weights.vgg_params_from_jax(flags.loss_params["vgg"])) for k, v in p.items()})
    if gan:
        dsd = weights.discriminator_state_dict_from_jax(flags.d_params, flags.d_stats)
        want.update({f"{'d_stats' if 'running' in k else 'd_params'}/{k}": v
                     for k, v in dsd.items()})
        dmu = weights.discriminator_state_dict_from_jax(_adam(flags.d_opt_state).mu,
                                                        flags.d_stats)
        want.update({f"d_opt_state/mu/{k}": v for k, v in dmu.items() if "running" not in k})
    compared = 0
    for path, flag in want.items():
        values = np.unique(np.asarray(flag))
        assert len(values) == 1, (path, values)  # a port leaf is one JAX leaf's part
        spec = got[path].spec
        split = spec == ("model",) + (None,) * (np.ndim(flag) - 1)
        assert (spec == () or split) and split == bool(values[0]), (path, spec, values)
        compared += 1
    assert got["step"].spec == () and got["opt_state/count"].spec == ()
    assert compared == len(want) >= len(dict(model.named_parameters())) * 4
    # the JAX leaves that stay whole: SE, conv_last's 3 channels, D's dense layers
    whole = {p for p, s in got.items() if p.startswith("params/") and not s.spec}
    assert {"params/conv_last.weight", "params/conv_last.bias"} <= whole or family == "transfer"
    assert all("channel_attention" in p or "conv_last" in p for p in whole)
    if gan:
        assert {p for p, s in got.items() if p.startswith("d_params/") and not s.spec} == {
            "d_params/fc1.weight", "d_params/fc1.bias", "d_params/fc2.weight",
            "d_params/fc2.bias"}


# ---------------------------------------------------------------------------
# the forward on the channel slices


def test_each_split_conv_computes_only_its_output_slice_and_the_forward_is_the_whole_one(
        ranks):
    out = ranks[0]["1x2"]
    model = _model().eval()
    lr = torch.from_numpy(np.random.default_rng(3).random((2, 8, 8, 3), dtype=np.float32))
    with torch.no_grad():
        want = model(lr, train=False).numpy()
    for r in out:
        f = r["forward"]
        np.testing.assert_allclose(f["sr"], want, atol=2e-5)
        # every conv whose output width divides by 2 sees its half of the
        # kernel and computes half the channels: conv_first, 2 x (2 x 2 + 1)
        # in the trunk, conv_after_body and the two upsample convs (4C out);
        # conv_last (3 channels) runs whole
        assert f["seen"].count((C // 2, C // 2)) == 1 + G * (2 * B + 1) + 1
        assert f["seen"].count((2 * C, 2 * C)) == 2
        assert f["seen"].count((3, 3)) == 1 and len(f["seen"]) == 1 + G * (2 * B + 1) + 4
        assert f["exchanges"] == {"gather": 1 + G * (2 * B + 1) + 1 + 2, "leaf": G * B + 2}
    assert np.array_equal(out[0]["forward"]["sr"], out[1]["forward"]["sr"])


# ---------------------------------------------------------------------------
# training on data,model


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_tp_content_steps_match_the_single_process_steps(ranks, single, grid):
    want, limits = single["content"]
    for r in ranks[0][grid]:
        assert r["coords"] == divmod(r["rank"], GRIDS[grid][1])
        errors = _errors(r["content"], want)
        assert not _over(errors, limits), _over(errors, limits)
        assert len(errors) == len(limits) > 100


def test_the_tp_step_with_the_vgg_loss_and_the_clip_matches_the_single_process_step(
        ranks, single):
    want, limits = single["vgg"]
    assert float(optim.global_norm({k: torch.from_numpy(v) for k, v in want["grads"][0].items()},
                                   {})) > CLIP  # the clip is active
    for grid in GRIDS:
        for r in ranks[0][grid]:
            errors = _errors(r["vgg"], want)
            assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("control", CONTROLS)
def test_each_planted_control_is_rejected(ranks, single, control):
    want, limits = single["vgg"]
    for grid in GRIDS:
        over = _over(_errors(ranks[0][grid][0]["controls"][control], want), limits)
        part = "grads0." if control == "gather_backward_sum" else "mu."
        assert sum(k.startswith(part) for k in over) > 10, (control, len(over))


@pytest.mark.parametrize("family", FAMILIES[1:])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_zoo_content_steps_on_data_model_match_the_single_process_steps(ranks, single, grid,
                                                                       family):
    want, limits = single[family]
    for r in ranks[0][grid]:
        errors = _errors(r["zoo"][family], want)
        assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_every_rank_of_the_grid_holds_bitwise_the_same_gathered_state(ranks, grid):
    out = ranks[0][grid]
    for key in ("content", "vgg", "esrgan", "transfer"):
        runs = [r["zoo"][key] if key in r["zoo"] else r[key] for r in out]
        for run in runs[1:]:
            for part in ("params", "mu"):
                assert all(np.array_equal(run[part][k], v) for k, v in runs[0][part].items())
            assert run["losses"] == runs[0]["losses"]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_tp_eval_step_matches_the_single_process_eval_step(ranks, grid):
    d, _ = GRIDS[grid]
    state, _, _, apply, _ = _content_step()
    want, _, _ = steps.make_eval_step(apply)(state, torch.from_numpy(_hr(20)))
    for r in ranks[0][grid]:
        assert r["eval_rows"] == (BATCH // d, HR, HR, 3)
        for k, v in want.items():
            np.testing.assert_allclose(r["eval"][k], float(v), rtol=BASE, err_msg=k)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_tp_content_steps_match_jaxs_tp_and_dp_x_tp_steps(ranks, single, jax_steps, grid):
    _, limits = single["content"]
    want = jax_steps[grid]
    for r in ranks[0][grid]:
        got = r["content"]
        for i, loss in enumerate(want["losses"]):
            assert abs(got["losses"][i] - loss) / loss <= limits[f"loss{i}"]
        for k, v in want["params"].items():
            assert _rel_l2(got["params"][k], v) <= limits[f"params.{k}"], k


def test_a_rank_holds_about_one_t_th_of_the_split_state(ranks):
    state = _content_step()[0]
    mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), world_size=2,
                      axis_names=("data", "model"), shape=(1, 2),
                      axis_groups={"data": object(), "model": object()})
    specs = pmesh.tp_param_shardings(state, mesh)
    parts = [("params/", state.model.state_dict()), ("opt_state/mu/", state.opt_state["mu"]),
             ("opt_state/nu/", state.opt_state["nu"])]
    split = sum(v.numel() * 4 for pre, sd in parts for k, v in sd.items() if specs[pre + k].spec)
    whole = sum(v.numel() * 4 for pre, sd in parts for k, v in sd.items()
                if not specs[pre + k].spec)
    assert split > 20 * whole  # the split leaves are the bulk of the state
    for grid in GRIDS:
        for r in ranks[0][grid]:
            assert r["state_bytes"] == split // 2 + whole  # its slices and the whole leaves


# ---------------------------------------------------------------------------
# the Trainer, its checkpoints and the CLI


HISTORY = ("train_loss", "val_loss", "val_psnr", "val_ssim")


def _single_trainer_run(tmp, resume=None, noise=None):
    """The single-process Trainer on the whole batches (times (1 + 2^-23
    N(0, 1)) with a ``noise`` seed): one epoch, or with ``resume`` a full
    resume of that file and its second epoch; (history, whole state)."""
    def batches(arrays, k):
        if noise is None:
            return [{"hr": b} for b in arrays]
        rng = np.random.default_rng(noise + k)
        return [{"hr": (b * (1 + FLOOR_NOISE * rng.standard_normal(b.shape))).astype(np.float32)}
                for b in arrays]

    tr = _trainer(tmp, batches(TRAIN_BATCHES, 0), batches(VAL_BATCHES, 100),
                  epochs=1 if resume is None else 2)
    if resume is not None:
        tr.load_checkpoint(str(resume))
    return tr.train(), _trainer_state(tr)


def _trainer_limits(tmp, resume=None):
    """The single-process run and each quantity's limit: max(BASE,
    FLOOR_FACTOR x how far the run moves under input noise, the larger of
    two draws)."""
    history, state = _single_trainer_run(tmp / "clean", resume)
    draws = [_single_trainer_run(tmp / f"noise{seed}", resume, seed) for seed in FLOOR_SEEDS]
    limits = {}
    for k in HISTORY:
        limits[k] = max(BASE, FLOOR_FACTOR * max(
            float(np.max(np.abs(np.subtract(h[k], history[k])) / np.abs(history[k])))
            for h, _ in draws))
    for part, tensors in state.items():
        for k, v in tensors.items():
            limits[part, k] = max(BASE, FLOOR_FACTOR * max(_rel_l2(st[part][k], v)
                                                           for _, st in draws))
    return history, state, limits


def _check_run(history, state, want_history, want_state, limits):
    for k in HISTORY:
        np.testing.assert_allclose(history[k], want_history[k], rtol=limits[k], err_msg=k)
    for part, tensors in want_state.items():
        for k, v in tensors.items():
            assert _rel_l2(state[part][k], v) <= limits[part, k], (part, k)


def test_a_data_model_trainer_epoch_writes_on_rank0_only_and_equals_the_single_process_one(
        ranks, single_trainer):
    from facesr_torch.ckpt.weights import read_state_dict

    out, tmp = ranks[0]["1x2"], ranks[1] / "1x2"
    assert [r["writer"] for r in out] == [True, False]
    assert not (tmp / "rank1" / "tp").exists()
    files = {p.name for p in (tmp / "rank0" / "tp").iterdir()}
    assert {"final_model.fckpt", "final_model.pth", "best_model.fckpt"} <= files
    for r in out:
        _check_run(r["history"], r["trainer_state"], *single_trainer["epoch"])
        assert r["revalidated"] == {k: r["history"][f"val_{k}"][-1]
                                    for k in ("loss", "psnr", "ssim")}
    for part, tensors in out[0]["trainer_state"].items():
        assert all(np.array_equal(v, out[1]["trainer_state"][part][k])
                   for k, v in tensors.items()), part
    # the .pth loads strict into a single-process model and holds the
    # gathered weights
    model = _model()
    model.load_state_dict(read_state_dict(str(tmp / "rank0" / "tp" / "final_model.pth")),
                          strict=True)
    assert all(np.array_equal(v.numpy(), out[0]["trainer_state"]["params"][k])
               for k, v in model.state_dict().items())


def test_a_tp_trainer_file_resumes_in_one_process_and_in_the_jax_trainer(ranks, tmp_path):
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
    path = tmp / "rank0" / "tp" / "final_model.fckpt"
    back = _trainer(tmp_path / "back", [], [])
    back.load_checkpoint(str(path))
    got, want = _trainer_state(back), out[0]["trainer_state"]
    for part, tensors in want.items():
        assert all(np.array_equal(got[part][k], v) for k, v in tensors.items()), part
    assert back.current_epoch == 1 and back.state.step == len(TRAIN_BATCHES)

    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
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


def test_a_single_process_file_resumes_on_data_model_and_trains_as_one_process(
        ranks, single_trainer):
    out = ranks[0]["1x2"]
    assert all(r["restored"] for r in out)  # each rank's whole state is the file's
    for r in out:
        _check_run(r["resumed_history"], r["resumed_state"], *single_trainer["resumed"])


def test_a_trainers_memory_report_counts_a_ranks_slices(ranks):
    from facesr_torch.utils.profiling import tensor_bytes

    out = ranks[0]["1x2"]
    whole = tensor_bytes(_model())
    for r in out:
        assert r["report"]["params_bytes"] == r["model_bytes"]
        # conv_last and the SE stay whole, the rest is halved
        assert 0.5 * whole < r["model_bytes"] < 0.56 * whole
        assert r["report"]["peak_step_bytes"] is None  # measured on a card only


def test_the_train_cli_trains_on_data_model_over_two_ranks(cli_run, ranks):
    """A plain launch with --mesh-axes data,model --mesh-shape 1,2 starts
    its two ranks; both load the same rows and split the channels; rank 0
    writes the whole checkpoints."""
    from facesr_torch.ckpt import fckpt
    from facesr_torch.ckpt.weights import read_state_dict

    proc, tmp = cli_run
    log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-4000:]
    assert "Starting 2 ranks" in log
    for r in range(2):
        assert f"rank {r} of 2 on cpu, at (0, {r}) of the data,model grid (1, 2)" in log
    assert "Batch size: 2 global, 2 a rank over 1 rank(s) of the data axis" in log
    assert len(re.findall(r"rank \d of 2, device memory", log)) == 2
    _, meta = fckpt.load_checkpoint(str(tmp / "checkpoints" / "final_model.fckpt"))
    assert meta["global_step"] == 2 and meta["config"]["mesh_axes"] == "data,model"
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                blocks_per_group=2), device="cpu")
    model.load_state_dict(read_state_dict(str(tmp / "checkpoints" / "final_model.pth")),
                          strict=True)
    assert all(math.isfinite(float(v.abs().sum())) for v in model.state_dict().values())


def test_a_signal_to_one_tp_rank_stops_both_after_one_step_and_saves_the_state_whole(
        tmp_path):
    """SIGTERM to rank 1 alone of a [1, 2] data,model CLI run: at the end of
    the step that is running both ranks learn of it, stop, and gather the
    state together; rank 0 writes interrupted.pth (strict-loadable) and
    interrupted.fckpt. An interrupt that reached one rank mid-step would
    pair its gather with the other rank's step exchanges."""
    from facesr_torch.ckpt import fckpt
    from facesr_torch.ckpt.weights import read_state_dict
    _cli_files(tmp_path)
    port, procs, logs = launch.free_port(), [], [tmp_path / f"rank{r}.log" for r in range(2)]
    for r in range(2):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "facesr_torch.cli.train", "--config",
                 str(tmp_path / "s1.yaml"), "--data-root", str(tmp_path / "data"), "--device",
                 "cpu", "--epochs", "1000", "--mesh-axes", "data,model", "--mesh-shape", "1,2",
                 "--dist-backend", "gloo", "--yes"],
                cwd=str(tmp_path), stdout=out, stderr=subprocess.STDOUT,
                env=_cli_env(tmp_path, **launch.torchrun_env(r, 2, port))))
    try:
        deadline = time.monotonic() + 240
        while "Epoch 2/1000" not in logs[1].read_text():  # trained and saved mid-run
            assert all(p.poll() is None for p in procs), logs[1].read_text()[-3000:]
            assert time.monotonic() < deadline, logs[1].read_text()[-3000:]
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    text = [log.read_text() for log in logs]
    assert codes == [0, 0], text[0][-3000:] + text[1][-3000:]
    assert "Training interrupted (SIGTERM)" in text[1]
    assert "Training interrupted (another rank's signal)" in text[0]
    assert "Checkpoint saved to" in text[0] and "Checkpoint saved to" not in text[1]
    _, meta = fckpt.load_checkpoint(str(tmp_path / "checkpoints" / "interrupted.fckpt"))
    assert meta["config"]["mesh_axes"] == "data,model" and meta["global_step"] >= 2
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                blocks_per_group=2), device="cpu")
    model.load_state_dict(read_state_dict(str(tmp_path / "checkpoints" / "interrupted.pth")),
                          strict=True)
    assert all(math.isfinite(float(v.abs().sum())) for v in model.state_dict().values())


# ---------------------------------------------------------------------------
# refusals


def test_tp_over_more_than_one_host_and_model_with_pp_are_refused(monkeypatch, tmp_path):
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    with pytest.raises(ValueError, match="cannot combine 'model' and 'pp'"):
        pmesh.check_mesh_axes(("data", "model", "pp"))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), world_size=4,
                      axis_names=("data", "model"), shape=(2, 2),
                      axis_groups={"data": object(), "model": object()})
    with pytest.raises(NotImplementedError, match="single-host for now"):
        Trainer(_model(), [], [], CombinedLoss(LossConfig(**LOSS), device="cpu"),
                TrainerConfig(mesh_axes="data,model", mesh_shape=(2, 2),
                              checkpoint_dir=str(tmp_path)), device="cpu", mesh=mesh)
