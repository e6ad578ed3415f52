"""GAN and QAT training of the port on `data,space` grids on the CPU: the
discriminator over row shards (stride-2 halos, BatchNorm over the grid,
the dense head's partial products), the GAN step (stage 3), the QAT content
and eval steps, the GAN and QAT Trainers and the train CLI, on gloo ranks
started by `facesr_torch.parallel.launch`, against the port's
single-process step and JAX's `row_sharding` / `grid_sharding` steps on the
conftest's 8 CPU devices; D alone also over thread shards
(`parallel.spatial.ThreadRows`) against the unsharded D.

Sizes: FaceEnhanceNet G=2, B=2, C=16 (every weight perturbed off its init
from numpy, conv_last redrawn non-zero), HR 64 (LR 16: 8 LR rows a shard at
S = 2), global batches of 4; D at 64 with 8 base channels and BatchNorm,
every parameter and running stat perturbed from numpy (its maps split down
to one row a shard at S = 2; at S = 4 the last stride-2 conv gathers). D
alone also at 32 over S = 2 (the gather path) and at 128 over S = 4 (every
map split, the dense head's columns over four shards). The JAX trees come
from the port's models through `ckpt/weights.py`. One module-scoped launch
a grid, [1, 2] (2 ranks) and [2, 2] (4 ranks), in a background thread
that the parent's single-process and JAX runs overlap; the children
import torch and the port only, never JAX. JAX's GAN step on [2, 2] is
its single-device step (see `jax_gan`).

Tolerances (float32):
- D over row shards against the unsharded D: logits atol 1e-5 + rtol 1e-4
  and the updated running stats atol 1e-6 (the BatchNorm sums and the dense
  head's partial products add in other orders; measured <= 1.5e-5 and
  6e-7); eval mode the same; the shards' logits bitwise equal. Each
  control (a zero stride-2 halo, a BatchNorm over a shard's rows, the
  head without the `space` sum) lands over 10x that limit.
- A GAN run is chaotic at rounding level: Adam's first steps move every
  element by ~lr x sign(g), so a gradient near zero that flips moves D or
  G by 2 lr there and the runs part (the single-process run's own floor
  for G's params, over their update, is 1e-5 to 9e-2 by draw). So three
  GAN steps are held, a quantity at a time, to max(its base limit,
  `FLOOR_FACTOR` x its rounding floor): how far the single-process run
  moves with its inputs times (1 + 2^-23 N(0, 1)) (two draws) or its convs
  summed in another order (oneDNN off), the largest draw. Base limits:
  against the single process 1e-5 (each step's metrics relatively; G's
  and D's params over their update, D's running stats and both
  optimisers' moments by relative L2 over a part); against JAX the first
  step's metrics 1e-4, the rest `STEP_RTOL` (tests/test_torch_gan.py's).
- One GAN step's gradients against the single process's, per tensor
  relative L2, within max(1e-5 for D and 1e-4 for G, 10 x that tensor's
  floor); each control (a zero or a detached stride-2 halo, D's
  BatchNorm over a shard's rows, the head without the `space` sum,
  gradients summed over `space`) puts some tensor over its limit.
- QAT: the sharded runs are pinned at fake-quant ties to the
  single-process run's record (`step_numerics.fake_quant_levels`, cut to
  each rank's rows): a quotient within 1e-3 of a level boundary or an
  output within 1e-5 of zero that one run rounds the other way would
  otherwise spread through the step (the SE means sum their shards'
  partials in another order). No level or sign may differ off a tie,
  ties at most 1e-4 of the levels; then the loss within 1e-6 absolute,
  every gradient and parameter within 1e-5 relative L2 a tensor, the eval
  metrics rtol 1e-5. The per-shard-scale control leaves the record off
  its ties. Against JAX's sharded QAT step (which equals JAX's
  single-device one): each gap at most the single-process run's own gap
  to JAX plus 1e-5 (the packages round kernel quotients and sum convs
  otherwise, and their ties spread).
- The ranks against each other bitwise; the GAN Trainer run (an epoch,
  a full resume, another epoch) held as the GAN steps are, to its own
  floor with a 1e-5 base; the QAT Trainer epoch 1e-5 relative L2 a
  tensor, its history rtol 1e-5.
"""

import contextlib
import math
import re
import subprocess
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.cli.step_numerics import RecordingAdamW
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models import discriminator as dmod
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.ops import conv as tconv
from facesr_torch.parallel import launch, spatial
from facesr_torch.parallel import mesh as pmesh
from facesr_torch.training import steps

torch.set_num_threads(1)

G, B, C, HR, BATCH = 2, 2, 16, 64, 4
D_BASE = 8
LR, D_LR, GAN_WEIGHT = 1e-4, 1e-4, 0.5
QAT_LR = 1e-3
GAN_LOSS = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1)
QAT_LOSS = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1)
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
GAN_CASES = {"plain": {}, "d_updates_2": dict(d_updates_per_g=2), "lsgan": dict(gan_type="lsgan")}
GAN_SEEDS = (30, 31, 32)
QAT_SEEDS = (10, 11)
CONTROLS = ("zero_stride2_halo", "detached_stride2_halo", "per_shard_bn", "head_without_sum",
            "wrong_factor")
METRICS = ("loss", "d_loss", "g_adv", "d_real", "d_fake")
STEP_RTOL = 2e-2
QAT_SP_RTOL = 1e-5
# a three-step run's limit a quantity: max(its base limit, FLOOR_FACTOR x
# how far rounding alone moves the single-process run there)
FLOOR_FACTOR = 10
FLOOR_NOISE = 2.0 ** -23
FLOOR_SEEDS = (11, 12)
FLOOR_DRAWS = FLOOR_SEEDS + ("conv_order",)
# JAX's GAN runs: every case on [1, 2] (`row_sharding`); the plain one on
# [2, 2] (JAX's single-device step: see `jax_gan`)
JAX_GAN_RUNS = [("1x2", case) for case in sorted(GAN_CASES)] + [("2x2", "plain")]
ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# what the ranks and the parent both build (torch and numpy only)


def _model() -> FaceEnhanceNet:
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=G,
                                                blocks_per_group=B), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = 0.05 if name.startswith("conv_last") else 0.02
            noise = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            p.copy_(noise * scale if name == "conv_last.weight" else p + noise * scale)
    return model


def _disc(size=HR):
    """D with every parameter and running stat moved off its init."""
    d = dmod.create_discriminator(input_size=size, base_channels=D_BASE, seed=1, device="cpu")
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


def _calibration() -> np.ndarray:
    return np.random.default_rng(3).random((4, 16, 16, 3), dtype=np.float32)


def _np(named) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named}


def _rows(x: np.ndarray, mesh) -> torch.Tensor:
    """This rank's batch rows (whole images) of a global batch."""
    return torch.from_numpy(np.ascontiguousarray(pmesh.shard_batch(x, mesh)))


def _gan_step(mesh=None, gan_type="vanilla", d_updates_per_g=1):
    model, disc = _model(), _disc()
    loss = CombinedLoss(LossConfig(**GAN_LOSS), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=1e3)
    d_opt = RecordingAdamW(weight_decay=1e-3, gradient_clip=0.0)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), LR),
                             loss_params=loss.params, disc=disc,
                             d_opt_state=d_opt.init(dict(disc.named_parameters()), D_LR))
    step = steps.make_gan_train_step(lambda lp, p, t: loss.apply(lp, p, t), opt, d_opt,
                                     gan_weight=GAN_WEIGHT, gan_type=gan_type,
                                     d_updates_per_g=d_updates_per_g, mesh=mesh)
    return state, opt, d_opt, step


def _gan_state(state) -> dict:
    return {"g": _np(state.model.state_dict().items()),
            "d": _np(state.disc.state_dict().items()),
            **{f"{who}_{m}": _np((st[m]).items())
               for who, st in (("g", state.opt_state), ("d", state.d_opt_state))
               for m in ("mu", "nu")}}


def _qat_sites(model, calibrated):
    from facesr_torch.ops.quant import fake_quant_params
    from facesr_torch.parallel.serving import calibrated_qparams

    cal = calibrated_qparams(model, _calibration(), 4) if calibrated else None
    return fake_quant_params(model, act_scales=cal), cal


def _qat_step(mesh=None, calibrated=False):
    model = _model()
    sites, _ = _qat_sites(model, calibrated)
    loss = CombinedLoss(LossConfig(**QAT_LOSS), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=0.5)
    state = steps.TrainState(model=model,
                             opt_state=opt.init(dict(model.named_parameters()), QAT_LR),
                             loss_params=loss.params)
    apply = lambda lp, p, t: loss.apply(lp, p, t)
    return (state, opt, steps.make_train_step(apply, opt, quant_fn=lambda: sites, mesh=mesh),
            steps.make_eval_step(apply, quant_fn=lambda: sites, mesh=mesh))


@contextlib.contextmanager
def _planted(control, shard_cls=spatial.RankShard):
    """A fault planted in the sharded path (module attributes, restored
    after)."""
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    halo, bn_sum, dense_rows = shard_cls._halo, dmod._bn_sum, dmod._dense_rows
    if control in ("zero_stride2_halo", "detached_stride2_halo"):
        def planted_halo(self, x, top, bottom):
            above, below = halo(self, x, top, bottom)
            if bottom == 0:  # the stride-2 plan: one row from above, none from below
                # zeros, or the right rows whose gradient does not return to
                # their owner; each still in the exchange's graph, so every
                # rank runs its backward all-reduce
                above = above * 0 + (0 if control.startswith("zero") else above.detach())
            return above, below

        patch(shard_cls, "_halo", planted_halo)
    elif control == "per_shard_bn":
        patch(dmod, "_bn_sum", lambda train, mesh, shard:
              None if shard is not None else bn_sum(train, mesh, shard))
    elif control == "head_without_sum":
        patch(dmod, "_dense_rows", lambda x, fc, shard: dense_rows(
            x, fc, shard if shard is None else types.SimpleNamespace(
                size=shard.size, index=shard.index, bounds=shard.bounds, sum=lambda t: t)))
    elif control == "wrong_factor":  # gradients summed over `space` (a mean over `data` only)
        reduced = steps._reduced
        patch(steps, "_reduced", lambda g, m: [t * m.space_size for t in reduced(g, m)])
    elif control == "per_shard_scale":
        scale = tconv.fake_quant_scale
        patch(tconv, "fake_quant_scale", lambda t, static=None, shard=None: scale(t, static))
    else:
        raise ValueError(control)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def _one_gan_step(mesh=None, noise=None):
    """One plain GAN step (its input times (1 + 2^-23 N(0, 1)) with a
    ``noise`` seed): its metrics and D's (first update) and G's gradients."""
    state, opt, d_opt, step = _gan_step(mesh)
    x = _rows(_hr(GAN_SEEDS[0]), mesh) if mesh is not None else torch.from_numpy(_hr(GAN_SEEDS[0]))
    if noise is not None:
        x = x * (1 + FLOOR_NOISE * torch.randn(x.shape, generator=torch.Generator().manual_seed(
            noise)))
    _, m = step(state, x)
    return {"metrics": {k: float(m[k]) for k in METRICS},
            "d_grads": {k: v.numpy() for k, v in d_opt.grads.items()},
            "g_grads": {k: v.numpy() for k, v in opt.grads.items()}}


def _record(rec) -> dict:
    """A `fake_quant_levels` record to send to the ranks: the levels as
    int8 (they lie in +-127), the outputs as they are."""
    return {"weights": [t.to(torch.int8) for t in rec["weights"]],
            "levels": [t.to(torch.int8) for t in rec["levels"]], "outputs": rec["outputs"]}


def _qat_reference(calibrated):
    """The single-process QAT run, its fake-quant levels recorded: two
    steps (losses, gradients, params) and the eval step on fresh weights."""
    from facesr_torch.cli.step_numerics import fake_quant_levels

    state, opt, step, _ = _qat_step(calibrated=calibrated)
    losses, grads = [], []
    with fake_quant_levels() as rec:
        for seed in QAT_SEEDS:
            _, m = step(state, torch.from_numpy(_hr(seed)))
            losses.append(float(m["loss"]))
            grads.append({k: v.numpy() for k, v in opt.grads.items()})
    fresh, _, _, eval_step = _qat_step(calibrated=calibrated)
    with fake_quant_levels() as rec_eval:
        metrics, _, _ = eval_step(fresh, torch.from_numpy(_hr(20)))
    return {"losses": losses, "grads": grads, "params": _np(state.model.state_dict().items()),
            "eval_metrics": {k: float(v) for k, v in metrics.items()},
            "steps": _record(rec), "eval": _record(rec_eval)}


def _qat_run(mesh, ref, calibrated, control=False):
    """The QAT run on a rank, its fake-quant levels pinned at ties to the
    single-process run's ``ref`` (`step_numerics.fake_quant_levels`, cut to
    this rank's batch and image rows): two steps, then the eval step on
    fresh weights; and the exchanges of one unpinned step. A ``control``
    runs the first step only."""
    from facesr_torch.cli.step_numerics import fake_quant_levels, row_shard_levels

    state, opt, step, _ = _qat_step(mesh, calibrated)
    shard = step.row_shard
    per = BATCH // mesh.data_size
    batch = slice(mesh.coords[0] * per, (mesh.coords[0] + 1) * per)
    losses, grads, pins = [], [], []
    with fake_quant_levels(row_shard_levels(ref["steps"], shard, batch)) as pin:
        for seed in QAT_SEEDS[:1] if control else QAT_SEEDS:
            _, m = step(state, _rows(_hr(seed), mesh))
            losses.append(float(m["loss"]))
            grads.append({k: v.numpy() for k, v in opt.grads.items()})
    pins.append(pin)
    if control:
        return {"losses": losses, "grads": grads, "off_tie": pin["off_tie"]}
    fresh, _, _, eval_step = _qat_step(mesh, calibrated)
    with fake_quant_levels(row_shard_levels(ref["eval"], eval_step.row_shard, batch)) as pin:
        metrics, _, _ = eval_step(fresh, _rows(_hr(20), mesh))
    pins.append(pin)
    once, _, once_step, _ = _qat_step(mesh, calibrated)
    once_step(once, _rows(_hr(QAT_SEEDS[0]), mesh))
    return {"losses": losses, "grads": grads, "params": _np(state.model.state_dict().items()),
            "mu": _np(state.opt_state["mu"].items()),
            "eval": {k: float(v) for k, v in metrics.items()},
            "ties": sum(p["ties"] for p in pins), "off_tie": sum(p["off_tie"] for p in pins),
            "levels": sum(lv.numel() for p in pins for lv in p["levels"]),
            "first_exchanges": dict(once_step.row_shard.counts)}


def _trainer_cfg(ckpt_dir, **kw):
    from facesr_torch.training.trainer import TrainerConfig

    return TrainerConfig(**{**dict(epochs=1, learning_rate=LR, weight_decay=1e-2,
                                   gradient_clip=0.5, use_amp=False, save_every=1,
                                   checkpoint_dir=str(ckpt_dir), ema_decay=0.9,
                                   step_log_every=0, d_learning_rate=D_LR), **kw})


TRAIN_BATCHES = [_hr(40 + i) for i in range(2)]
VAL_BATCHES = [_hr(50)]


def _gan_trainer(ckpt_dir, train, val, mesh=None, epochs=1, **grid):
    from facesr_torch.training.trainer import Trainer

    cfg = _trainer_cfg(ckpt_dir, epochs=epochs, gan_weight=GAN_WEIGHT, gan_start_epoch=0, **grid)
    return Trainer(_model(), train, val, CombinedLoss(LossConfig(**GAN_LOSS), device="cpu"), cfg,
                   device="cpu", discriminator=_disc(), mesh=mesh)


def _qat_trainer(ckpt_dir, train, val, mesh=None, **grid):
    from facesr_torch.training.trainer import Trainer

    cfg = _trainer_cfg(ckpt_dir, learning_rate=QAT_LR, qat=True, **grid)
    return Trainer(_model(), train, val, CombinedLoss(LossConfig(**QAT_LOSS), device="cpu"), cfg,
                   device="cpu", mesh=mesh)


def _trainers(mesh, tmp):
    """A GAN Trainer epoch (rank 0 writes), a full resume of its file into a
    2-epoch GAN Trainer that trains epoch 2, and a QAT Trainer epoch."""
    import torch.distributed as dist

    train = [{"hr": pmesh.shard_batch(b, mesh)} for b in TRAIN_BATCHES]
    val = [{"hr": pmesh.shard_batch(b, mesh)} for b in VAL_BATCHES]
    grid = dict(mesh_axes="data,space", mesh_shape=mesh.shape)
    out = {}
    own = Path(tmp) / f"rank{mesh.rank}"
    tr = _gan_trainer(own / "gan", train, val, mesh, **grid)
    out["gan_history"] = tr.train()
    out["gan_writer"] = tr.is_writer
    dist.barrier(group=mesh.group)  # rank 0's files are written
    resumed = _gan_trainer(own / "resumed", train, val, mesh, epochs=2, **grid)
    resumed.load_checkpoint(str(Path(tmp) / "rank0" / "gan" / "final_model.fckpt"))
    out["restored"] = all(torch.equal(a, b) for a, b in zip(
        [*tr.model.state_dict().values(), *tr.disc.state_dict().values(),
         *tr.state.opt_state["mu"].values(), *tr.state.d_opt_state["nu"].values()],
        [*resumed.model.state_dict().values(), *resumed.disc.state_dict().values(),
         *resumed.state.opt_state["mu"].values(), *resumed.state.d_opt_state["nu"].values()]))
    out["resumed_history"] = resumed.train()
    out["resumed"] = _gan_state(resumed.state)
    qat = _qat_trainer(own / "qat", train, val, mesh, **grid)
    out["qat_history"] = qat.train()
    out["qat_params"] = _np(qat.model.state_dict().items())
    return out


def _worker(mesh, tmp, extras, refs):
    """Everything a rank of one grid runs, in one launch; ``refs``: the
    single-process QAT runs' records (`_qat_reference`)."""
    torch.set_num_threads(1)
    out = {"rank": mesh.rank, "coords": mesh.coords, "gan": {}}
    for case, kw in GAN_CASES.items():
        state, _, _, step = _gan_step(mesh, **kw)
        metrics = []
        for i, seed in enumerate(GAN_SEEDS):
            _, m = step(state, _rows(_hr(seed), mesh))
            metrics.append({k: float(m[k]) for k in METRICS})
            if i == 0 and case == "plain":
                out["exchanges"] = dict(step.row_shard.counts)
        out["gan"][case] = {"metrics": metrics, **_gan_state(state)}
    out["one_step"] = _one_gan_step(mesh)
    out["controls"] = {}
    for control in CONTROLS:
        with _planted(control):
            out["controls"][control] = _one_gan_step(mesh)
    out["qat"] = {calibrated: _qat_run(mesh, refs[calibrated], calibrated)
                  for calibrated in (False, True)}
    with _planted("per_shard_scale"):
        out["qat_per_shard_scale"] = _qat_run(mesh, refs[False], False, control=True)
    if "trainers" in extras:
        out.update(_trainers(mesh, tmp))
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both grids' ranks, launched one grid after the other in a background
    thread as soon as the module needs them, so the parent's own
    single-process and JAX runs overlap them: a future of (each grid's
    results, the launch directory, the single-process QAT runs the ranks
    were pinned to, by scale mode)."""
    tmp = tmp_path_factory.mktemp("sp_gan")
    refs = {calibrated: _qat_reference(calibrated) for calibrated in (False, True)}
    sent = {c: {k: r[k] for k in ("steps", "eval")} for c, r in refs.items()}

    def run():
        out = {}
        for name, (d, s) in GRIDS.items():
            extras = ("trainers",) if name == "1x2" else ()
            out[name] = launch.run_ranks(_worker, d * s, args=(str(tmp / name), extras, sent),
                                         devices=["cpu"] * (d * s), timeout=120,
                                         run_timeout=400, axis_names=("data", "space"),
                                         shape=(d, s))
        return out, tmp, refs

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


@pytest.fixture(scope="module")
def ranks(launched, qat_cli, stage_cli, single_gan, single_step, single_trainer, jax_gan,
          jax_qat):
    """`launched`'s results, awaited once the parent's runs are done (the
    CLI runs start first and overlap them too)."""
    return launched.result()


def _rel_l2(got, want, base=None) -> float:
    """||got - want|| / ||want - base|| over every tensor of two same-keyed
    dicts together (``base`` None: / ||want||); arrays for one tensor."""
    if not isinstance(want, dict):
        got, want, base = {"": got}, {"": want}, None if base is None else {"": base}
    assert set(got) == set(want)
    num = sum(float(((np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)) ** 2)
                    .sum()) for k in want)
    den = sum(float(((np.asarray(want[k], np.float64)
                      - (0 if base is None else np.asarray(base[k], np.float64))) ** 2).sum())
              for k in want)
    return math.sqrt(num / max(den, 1e-300))


def _split(sd):
    """A D state dict's parameters and running stats apart."""
    return ({k: v for k, v in sd.items() if "running" not in k},
            {k: v for k, v in sd.items() if "running" in k})


# ---------------------------------------------------------------------------
# D over thread row shards


def _sharded_disc(d, x, shards, train):
    """D's forward on each thread shard's rows (each shard its own copy of
    D, whose running stats it updates): the logits and the copies."""
    import copy

    copies = [copy.deepcopy(d) for _ in shards]
    outs, errors = [None] * len(shards), []

    def work(shard):
        try:
            with torch.no_grad(), spatial.rows(shard):
                outs[shard.index] = copies[shard.index](shard.slab(x), train=train)
        except Exception as e:  # noqa: BLE001 — re-raised in the caller
            errors.append(e)
            shard._rows.abort()

    threads = [threading.Thread(target=work, args=(s,), daemon=True) for s in shards]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return outs, copies


def _disc_check(size, parts, train, seed=2):
    d = _disc(size)
    x = torch.from_numpy(np.random.default_rng(seed).random((4, size, size, 3),
                                                            dtype=np.float32))
    import copy

    ref = copy.deepcopy(d)
    with torch.no_grad():
        want = ref(x, train=train)
    shards = spatial.ThreadRows(["cpu"] * parts).shards()
    outs, copies = _sharded_disc(d, x, shards, train)
    stats = [_np(c.named_buffers()) for c in copies]
    return want, _np(ref.named_buffers()), outs, stats, shards[0].counts


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("size,parts,gathers", [(64, 2, 0), (64, 4, 1), (128, 4, 0), (32, 2, 1)])
def test_discriminator_over_row_shards_equals_the_unsharded_one(size, parts, gathers, train):
    """Stride-2 halos, BatchNorm over every shard's rows, the dense head's
    partial products; where a map's rows stop splitting by 2 (one row a
    shard before a stride-2 conv) one gather and the rest whole."""
    want, want_stats, outs, stats, counts = _disc_check(size, parts, train)
    for out, st in zip(outs, stats):
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5, rtol=1e-4)
        for k, v in want_stats.items():
            np.testing.assert_allclose(st[k], v, atol=1e-6, rtol=0, err_msg=k)
    assert all(torch.equal(o, outs[0]) for o in outs)
    # 10 convs, each on a split map taking a halo; a gather comes before the
    # last (stride-2) one; 9 BatchNorms sum twice in train mode while split;
    # the head sums once while split
    assert counts.get("gather", 0) == gathers
    assert counts["halo"] == 10 - gathers
    assert counts.get("sum", 0) == (2 * (9 - gathers) if train else 0) + (1 - gathers)


@pytest.mark.parametrize("control", ["zero_stride2_halo", "per_shard_bn", "head_without_sum"])
def test_each_discriminator_control_is_rejected_by_the_forward_tolerance(control):
    """At 128 over 4 shards (every map split, the head over four shards)."""
    with _planted(control, spatial.ThreadShard):
        want, want_stats, outs, stats, _ = _disc_check(128, 4, train=True)
    err = max(np.abs(o.numpy() - want.numpy()).max() for o in outs)
    limit = 1e-5 + 1e-4 * np.abs(want.numpy()).max()
    stats_err = max(np.abs(st[k] - v).max() for st in stats for k, v in want_stats.items())
    print(control, f"logits max abs {err:.3g} (limit {limit:.3g}), stats {stats_err:.3g}")
    assert err > 10 * limit


def test_a_conv_that_does_not_split_over_rows_raises_and_names_its_shape():
    assert spatial.conv_halo(3, 1, 1) == (1, 1) and spatial.conv_halo(3, 1, 2) == (1, 0)
    assert spatial.conv_halo(1, 0, 1) == (0, 0)
    for k, p, s in ((3, 0, 1), (3, 2, 1), (3, 1, 3), (5, 1, 1)):
        with pytest.raises(ValueError, match=f"kernel height {k}, row padding {p} and stride {s}"):
            spatial.conv_halo(k, p, s)
    shard = spatial.ThreadRows(["cpu", "cpu"]).shards()[0]
    assert shard.conv_rows(4, 3, 1, 2) == (1, 0) and shard.conv_rows(1, 3, 1, 2) is None
    with spatial.rows(shard), pytest.raises(ValueError, match="gather the map first"):
        tconv.conv2d(torch.zeros((1, 1, 4, 3)), torch.zeros((8, 3, 3, 3)), padding=1, stride=2)


# ---------------------------------------------------------------------------
# the GAN step on data,space


def _perturbed_run(noise):
    """The context of one rounding draw: ``noise`` None (none), "conv_order"
    (oneDNN off: every conv sums in another order), or a seed (each input
    times (1 + 2^-23 N(0, 1)), `_noisy`)."""
    if noise == "conv_order":
        return torch.backends.mkldnn.flags(enabled=False)
    return contextlib.nullcontext()


def _noisy(x: torch.Tensor, noise, seed: int) -> torch.Tensor:
    if not isinstance(noise, int):
        return x
    gen = torch.Generator().manual_seed(noise + seed)
    return x * (1 + FLOOR_NOISE * torch.randn(x.shape, generator=gen))


def _gan_run(kw, noise=None):
    """Three single-process GAN steps under a rounding draw
    (`_perturbed_run`): each step's metrics and the state after."""
    state, _, _, step = _gan_step(**kw)
    metrics = []
    with _perturbed_run(noise):
        for seed in GAN_SEEDS:
            _, m = step(state, _noisy(torch.from_numpy(_hr(seed)), noise, seed))
            metrics.append({k: float(m[k]) for k in METRICS})
    return {"metrics": metrics, **_gan_state(state)}


def _gan_errors(got, want) -> dict:
    """How far a three-step run is from another: the metrics' largest
    relative error each step; G's and D's params over their update, D's
    running stats and the four moments by relative L2 over a part."""
    g0 = _np(_model().state_dict().items())
    d0 = _split(_np(_disc().state_dict().items()))[0]
    (d_got, s_got), (d_want, s_want) = _split(got["d"]), _split(want["d"])
    errs = {f"step {i}": max(abs(a[k] - b[k]) / abs(b[k]) for k in METRICS)
            for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"]))}
    errs.update({"G": _rel_l2(got["g"], want["g"], g0), "D": _rel_l2(d_got, d_want, d0),
                 "BN stats": _rel_l2(s_got, s_want),
                 **{k: _rel_l2(got[k], want[k]) for k in ("g_mu", "g_nu", "d_mu", "d_nu")}})
    return errs


@pytest.fixture(scope="module")
def single_gan():
    """Each case's single-process three-step run, and its rounding floor:
    how far the same run moves when its inputs or its conv summation order
    change by rounding alone, the largest of the draws (`FLOOR_DRAWS`).
    Adam's first steps move every element by ~lr * sign(g), so a gradient
    near zero that flips moves D or G by 2 lr there and the runs part: the
    floor of G's params over their update is 1e-5 to 9e-2 by draw."""
    out = {}
    for case, kw in GAN_CASES.items():
        base = _gan_run(kw)
        draws = [_gan_errors(_gan_run(kw, noise), base) for noise in FLOOR_DRAWS]
        out[case] = base, {k: max(d[k] for d in draws) for k in draws[0]}
    return out


def _check_run(errs, floor, loss_rtol, state_rtol, what):
    """Each error within max(its base limit, FLOOR_FACTOR x its floor): the
    first step's metrics ``loss_rtol``, the state and the later steps'
    metrics, which read the state, ``state_rtol``."""
    limits = {k: max(loss_rtol if k == "step 0" else state_rtol, FLOOR_FACTOR * floor[k])
              for k in errs}
    print(what, {k: f"{v:.3g} ({limits[k]:.3g})" for k, v in errs.items()})
    over = {k: v for k, v in errs.items() if v > limits[k]}
    assert not over, (what, over)


@pytest.mark.parametrize("case", sorted(GAN_CASES))
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_three_sp_gan_steps_match_the_single_process_steps(ranks, single_gan, grid, case):
    got = ranks[0][grid]
    assert [r["coords"] for r in got] == [divmod(i, GRIDS[grid][1]) for i in range(len(got))]
    want, floor = single_gan[case]
    _check_run(_gan_errors(got[0]["gan"][case], want), floor, 1e-5, 1e-5,
               f"{grid} {case} against the single process, error (limit)")


@pytest.fixture(scope="module")
def single_step():
    """One single-process GAN step, and each gradient tensor's rounding
    floor (the larger of two draws): D's first-update gradients move by
    ~1e-5 under rounding alone, and G's, which pass through D after that
    update (Adam's first step is ~lr * sign(g), so a near-zero D gradient
    that flips moves D by 2 lr), by up to 3.5e-2 at conv_last's bias."""
    base = _one_gan_step()
    draws = [_one_gan_step(noise=n) for n in FLOOR_SEEDS]
    floor = {part: {k: max(_rel_l2(d[part][k], v) for d in draws)
                    for k, v in base[part].items()} for part in ("d_grads", "g_grads")}
    return base, floor


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sp_gan_gradients_match_and_every_planted_control_is_rejected(ranks, single_step, grid):
    """Each gradient tensor within max(1e-5 for D, 1e-4 for G, 10 x its
    floor); each control puts some tensor over its limit."""
    want, floor = single_step
    limit = {part: {k: max(base, FLOOR_FACTOR * f) for k, f in floor[part].items()}
             for part, base in (("d_grads", 1e-5), ("g_grads", 1e-4))}
    got = ranks[0][grid][0]

    def over(rec):
        return {part: sorted(k for k, v in want[part].items()
                             if _rel_l2(rec[part][k], v) > limit[part][k]) for part in limit}

    right = over(got["one_step"])
    assert right == {"d_grads": [], "g_grads": []}, right
    for k in METRICS:
        np.testing.assert_allclose(got["one_step"]["metrics"][k], want["metrics"][k], rtol=1e-5,
                                   err_msg=k)
    for control, rec in got["controls"].items():
        rejected = over(rec)
        print(grid, control, {part: f"{len(v)} of {len(want[part])} over"
                              for part, v in rejected.items()})
        assert rejected["d_grads"] or rejected["g_grads"], control


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_every_rank_of_the_grid_holds_bitwise_the_same_gan_and_qat_state(ranks, grid):
    got = ranks[0][grid]
    for r in got[1:]:
        for case in GAN_CASES:
            for part, tensors in got[0]["gan"][case].items():
                if part == "metrics":
                    assert r["gan"][case][part] == tensors
                    continue
                for k, v in tensors.items():
                    assert np.array_equal(r["gan"][case][part][k], v), (case, part, k)
        for calibrated in (False, True):
            for part in ("params", "mu"):
                for k, v in got[0]["qat"][calibrated][part].items():
                    assert np.array_equal(r["qat"][calibrated][part][k], v), (part, k)


def test_a_sp_gan_step_exchanges_what_the_content_step_does_and_ds_rows(ranks):
    """The first plain GAN step on a rank of the [1, 2] grid against the
    first calibrated QAT step (the same generator and loss, no scale max):
    three D forwards more, each 10 halos (D at 64 over 2 splits down to
    one row a shard) and the head's sum. D's BatchNorm sums are
    all-reduces over the grid's group, not shard exchanges."""
    got = ranks[0]["1x2"][0]
    gan, content = got["exchanges"], got["qat"][True]["first_exchanges"]
    assert gan == {"gather": 1, "halo": content["halo"] + 30, "sum": content["sum"] + 3}, \
        (gan, content)


@pytest.fixture(scope="module")
def jax_gan():
    """JAX's three GAN steps of each case: under `row_sharding` on two of
    the conftest's CPU devices for [1, 2]; for [2, 2] on one device, since
    JAX's own `grid_sharding` GAN step on a 2 x 2 mesh disagrees with its
    single-device step at this size (after one plain step G's Adam moments
    0.59 relative L2 apart, the last BatchNorm's running stats 0.47
    normwise, the losses within 2e-6: XLA's partition of D's last map, one
    row a shard beside a split batch; at D 128 the two agree within 0.7%)."""
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.models import discriminator as jdisc
    from facesr.models import face_enhance_net as fen
    from facesr.parallel import get_mesh, replicate, replicated, row_sharding
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt.weights import jax_discriminator_from_state_dict, jax_params_from

    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    dcfg = jdisc.DiscriminatorConfig(in_channels=3, base_channels=D_BASE, input_size=HR)
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**GAN_LOSS), seed=0)
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=1e3)
    tx_d = jsteps.make_optimizer(weight_decay=1e-3, gradient_clip=0.0)
    params = jax.tree.map(jnp.asarray, jax_params_from(_model()))
    dparams, dstats = jax.tree.map(jnp.asarray, jax_discriminator_from_state_dict(
        _disc().state_dict()))
    out = {}
    for grid, (d, s) in GRIDS.items():
        for case, kw in GAN_CASES.items():
            if (grid, case) not in JAX_GAN_RUNS:
                continue
            state = jsteps.TrainState(
                step=jnp.asarray(0), params=params,
                opt_state=jsteps.set_learning_rate(tx.init(params), LR),
                loss_params=jloss.params, d_params=dparams, d_stats=dstats,
                d_opt_state=jsteps.set_learning_rate(tx_d.init(dparams), D_LR))
            fn = jsteps.make_gan_train_step(
                lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype),
                jloss.apply, lambda p, st, x, train: jdisc.apply(p, st, x, dcfg, train=train),
                tx, tx_d, gan_weight=GAN_WEIGHT, gan_type=kw.get("gan_type", "vanilla"),
                d_updates_per_g=kw.get("d_updates_per_g", 1))
            if d == 1:
                mesh = get_mesh(jax.devices()[:s])
                sharding = row_sharding(mesh)
                state = replicate(state, mesh)
                step = jax.jit(fn, in_shardings=(replicated(mesh), sharding))
                put = lambda x: jax.device_put(x, sharding)  # noqa: E731
            else:
                step, put = jax.jit(fn), jnp.asarray
            metrics = []
            for seed in GAN_SEEDS:
                state, m = step(state, put(_hr(seed)))
                metrics.append({k: float(m[k]) for k in METRICS})
            out[grid, case] = (jax.device_get(state), metrics)
    return out


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


@pytest.mark.parametrize("grid,case", JAX_GAN_RUNS)
def test_three_sp_gan_steps_match_jaxs_row_and_grid_sharded_steps(ranks, jax_gan, single_gan,
                                                                 grid, case):
    import jax

    from facesr_torch.ckpt.weights import (discriminator_state_dict_from_jax,
                                           state_dict_from_jax_params)

    state, metrics = jax_gan[grid, case]
    tree = lambda t: jax.tree.map(np.asarray, t)
    stats = tree(state.d_stats)
    d_sd = lambda t: {k: v.numpy() for k, v in discriminator_state_dict_from_jax(
        tree(t), stats).items()}
    g_sd = lambda t: {k: v.numpy() for k, v in state_dict_from_jax_params(tree(t)).items()}
    g_adam, d_adam = _adam(state.opt_state), _adam(state.d_opt_state)
    params_only = lambda t: _split(d_sd(t))[0]
    want = {"metrics": metrics, "g": g_sd(state.params), "d": d_sd(state.d_params),
            "g_mu": g_sd(g_adam.mu), "g_nu": g_sd(g_adam.nu),
            "d_mu": params_only(d_adam.mu), "d_nu": params_only(d_adam.nu)}
    _check_run(_gan_errors(ranks[0][grid][0]["gan"][case], want), single_gan[case][1], 1e-4,
               STEP_RTOL, f"{grid} {case} against JAX, error (limit)")


# ---------------------------------------------------------------------------
# QAT on data,space


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sp_qat_steps_match_the_single_process_steps(ranks, grid, calibrated):
    """Pinned at ties to the single-process run (`_qat_run`): no level or
    sign off a tie, ties at most 1e-4 of the levels, then the content
    step's limits and the eval metrics rtol 1e-5."""
    want = ranks[2][calibrated]
    for r in ranks[0][grid]:
        got = r["qat"][calibrated]
        assert got["off_tie"] == 0 and got["ties"] <= 1e-4 * got["levels"], got["ties"]
        for i, loss in enumerate(want["losses"]):
            assert abs(got["losses"][i] - loss) <= 1e-6
            worst = max(_rel_l2(got["grads"][i][k], g) for k, g in want["grads"][i].items())
            assert worst <= 1e-5, (i, worst)
        for k, v in want["params"].items():
            assert _rel_l2(got["params"][k], v) <= 1e-5, k
        for k, v in want["eval_metrics"].items():
            np.testing.assert_allclose(got["eval"][k], v, rtol=1e-5, err_msg=k)
    counts = ranks[0][grid][0]["qat"][calibrated]["first_exchanges"]
    # a dynamic scale: one max a fake-quant conv run, every halo but those of
    # SSIM's five window filters
    assert counts.get("max", 0) == (0 if calibrated else counts["halo"] - 5), counts
    print(grid, calibrated, "ties taken", ranks[0][grid][0]["qat"][calibrated]["ties"])


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_a_per_shard_fake_quant_scale_is_rejected(ranks, grid):
    """The control, pinned as the right run is: its levels leave the
    single-process run's away from ties, or its step leaves the limits."""
    want = ranks[2][False]
    got = ranks[0][grid][0]["qat_per_shard_scale"]
    grad_err = max(_rel_l2(got["grads"][0][k], g) for k, g in want["grads"][0].items())
    print(grid, f"per-shard scale: {got['off_tie']} levels off a tie, worst first-step "
                f"gradient {grad_err:.3g}")
    assert got["off_tie"] > 0 or grad_err > 1e-5 or abs(got["losses"][0] - want["losses"][0]) > 1e-6


@pytest.fixture(scope="module")
def jax_qat():
    """JAX's QAT content and eval steps (dynamic and calibrated scales)
    under `row_sharding` and `grid_sharding`."""
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.models import face_enhance_net as fen
    from facesr.ops import quant as jquant
    from facesr.parallel import get_mesh, grid_sharding, replicate, replicated, row_sharding
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt.weights import jax_params_from, jax_qtree_from_sites

    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**QAT_LOSS), seed=0)
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=0.5)
    model = _model()
    params = jax.tree.map(jnp.asarray, jax_params_from(model))
    out = {}
    for calibrated in (False, True):
        act = None
        if calibrated:
            act = jax.tree.map(jnp.asarray, jax_qtree_from_sites(model, _qat_sites(model, True)[1]))
        apply = (lambda a: lambda p, x, train, dtype: fen.apply(
            jquant.fake_quant_params(p, act_scales=a), x, cfg, train=train, dtype=dtype))(act)
        for grid, (d, s) in GRIDS.items():
            if d == 1:
                mesh = get_mesh(jax.devices()[:s])
                sharding = row_sharding(mesh)
            else:
                mesh = get_mesh(jax.devices()[:d * s], axis_names=("data", "space"),
                                shape=(d, s))
                sharding = grid_sharding(mesh)
            state = replicate(jsteps.TrainState(
                step=jnp.asarray(0), params=params,
                opt_state=jsteps.set_learning_rate(tx.init(params), QAT_LR),
                loss_params=jloss.params), mesh)
            ev = jax.jit(jsteps.make_eval_step(apply, jloss.apply),
                         in_shardings=(replicated(mesh), sharding))
            metrics = ev(state, jax.device_put(_hr(20), sharding))[0]  # fresh weights
            step = jax.jit(jsteps.make_train_step(apply, jloss.apply, tx, scale_factor=4),
                           in_shardings=(replicated(mesh), sharding))
            losses = []
            for seed in QAT_SEEDS:
                state, m = step(state, jax.device_put(_hr(seed), sharding))
                losses.append(float(m["loss"]))
            out[grid, calibrated] = (losses, jax.device_get(state.params),
                                     {k: float(v) for k, v in metrics.items()})
    return out


def _qat_gaps(run, losses, params, metrics) -> dict:
    """How far a port QAT run is from JAX's: each step's loss and each eval
    metric relatively, each param tensor by relative L2."""
    from facesr_torch.ckpt.weights import state_dict_from_jax_params

    import jax

    want = state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    gaps = {f"loss {i}": abs(a - b) / abs(b) for i, (a, b) in enumerate(zip(run["losses"], losses))}
    gaps.update({f"eval {k}": abs(run["eval"][k] - v) / abs(v) for k, v in metrics.items()})
    gaps.update({k: _rel_l2(run["params"][k], v.numpy()) for k, v in want.items()})
    return gaps


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sp_qat_steps_match_jaxs_row_and_grid_sharded_steps(ranks, jax_qat, grid, calibrated):
    """JAX's sharded QAT steps equal its single-device ones (within 2e-7 in
    the loss), and the port's single-process QAT step sits apart from JAX's
    by its fake-quant ties: XLA divides a kernel by its scales and sums a
    conv in other orders than torch, so a quotient within an ulp of a level
    boundary rounds to the other level and spreads (2.8e-4 in the first
    dynamic loss here; `step_numerics.fake_quant_levels` pins such ties in
    tests/test_torch_zoo_int8.py). The sp run must sit no farther from JAX's
    sharded run than the single-process run does, within the limits it
    meets against the single process (1e-5 relative, `_qat_gaps`)."""
    losses, params, metrics = jax_qat[grid, calibrated]
    sp = _qat_gaps(ranks[0][grid][0]["qat"][calibrated], losses, params, metrics)
    ref = ranks[2][calibrated]
    single = _qat_gaps({"losses": ref["losses"], "params": ref["params"],
                        "eval": ref["eval_metrics"]}, losses, params, metrics)
    print(grid, calibrated, "sp gap, single-process gap", {
        k: (f"{sp[k]:.3g}", f"{single[k]:.3g}") for k in sorted(sp, key=lambda k: -sp[k])[:4]})
    over = {k: (sp[k], single[k]) for k in sp if sp[k] > single[k] + QAT_SP_RTOL}
    assert not over, over


# ---------------------------------------------------------------------------
# the Trainers and the train CLI on data,space


def test_a_data_space_gan_trainer_writes_on_rank0_resumes_and_equals_the_single_process_one(
        ranks, single_trainer):
    from facesr_torch.ckpt import fckpt

    got, tmp = ranks[0]["1x2"], ranks[1] / "1x2"
    assert [r["gan_writer"] for r in got] == [True, False]
    assert not (tmp / "rank1" / "gan").exists()
    files = {p.name for p in (tmp / "rank0" / "gan").iterdir()}
    assert {"final_model.fckpt", "final_model.pth"} <= files
    tree, meta = fckpt.load_checkpoint(str(tmp / "rank0" / "gan" / "final_model.fckpt"))
    assert meta["global_step"] == len(TRAIN_BATCHES) and "d_params" in tree
    assert all(r["restored"] for r in got)
    want, floor = single_trainer
    for r in got:
        errs = _trainer_errors(r, want)
        limits = {k: max(1e-5, FLOOR_FACTOR * floor[k]) for k in errs}
        print("GAN Trainer", {k: f"{v:.3g} ({limits[k]:.3g})" for k, v in errs.items()})
        assert not {k: v for k, v in errs.items() if v > limits[k]}, errs
    for r in got:  # the first epoch, before the resume
        for k in ("train_loss", "val_loss", "val_psnr", "d_loss", "g_loss"):
            assert r["gan_history"][k] == r["resumed_history"][k][:1], k
    for part, tensors in got[0]["resumed"].items():
        assert all(np.array_equal(got[1]["resumed"][part][k], v) for k, v in tensors.items())


def _trainer_run(root, noise=None):
    """The single-process GAN Trainer for 2 epochs, its training batches
    under a rounding draw (`_perturbed_run`)."""
    train = [{"hr": _noisy(torch.from_numpy(b), noise, i).numpy()}
             for i, b in enumerate(TRAIN_BATCHES)]
    tr = _gan_trainer(root / str(noise), train, [{"hr": b} for b in VAL_BATCHES], epochs=2)
    with _perturbed_run(noise):
        history = tr.train()
    return {"resumed_history": history, "resumed": _gan_state(tr.state)}


def _trainer_errors(got, want) -> dict:
    """Each history entry relatively and each state part (G, D's params and
    stats, the four moments) by relative L2 over the part."""
    errs = {f"{k} {i}": abs(a - b) / max(abs(b), 1e-12)
            for k in ("train_loss", "val_loss", "val_psnr", "d_loss", "g_loss")
            for i, (a, b) in enumerate(zip(got["resumed_history"][k],
                                           want["resumed_history"][k]))}
    (d_got, s_got), (d_want, s_want) = _split(got["resumed"]["d"]), _split(want["resumed"]["d"])
    errs.update({"G": _rel_l2(got["resumed"]["g"], want["resumed"]["g"]),
                 "D": _rel_l2(d_got, d_want), "BN stats": _rel_l2(s_got, s_want),
                 **{k: _rel_l2(got["resumed"][k], want["resumed"][k])
                    for k in ("g_mu", "g_nu", "d_mu", "d_nu")}})
    return errs


@pytest.fixture(scope="module")
def single_trainer(tmp_path_factory):
    """The single-process 2-epoch GAN Trainer run and its rounding floor
    (`single_gan`'s draws)."""
    root = tmp_path_factory.mktemp("single_trainer")
    want = _trainer_run(root)
    draws = [_trainer_errors(_trainer_run(root, noise), want) for noise in FLOOR_DRAWS]
    return want, {k: max(d[k] for d in draws) for k in draws[0]}


def test_a_data_space_qat_trainer_epoch_equals_the_single_process_one(ranks, tmp_path):
    got = ranks[0]["1x2"]
    single = _qat_trainer(tmp_path, [{"hr": b} for b in TRAIN_BATCHES],
                          [{"hr": b} for b in VAL_BATCHES])
    history = single.train()
    for r in got:
        for k in ("train_loss", "val_loss", "val_psnr", "val_ssim"):
            np.testing.assert_allclose(r["qat_history"][k], history[k], rtol=1e-5, err_msg=k)
        for k, v in single.model.state_dict().items():
            assert _rel_l2(r["qat_params"][k], v.numpy()) <= 1e-5, k


def _png_set(root: Path) -> None:
    from facesr_torch.data import png
    from facesr_torch.data.cv_compat import resize_cubic

    rng = np.random.default_rng(0)
    for split, n, size in (("train", 4, 40), ("val", 2, 32)):
        (root / "data" / split / "HR").mkdir(parents=True)
        if split == "val":
            (root / "data" / split / "LR").mkdir()
        for i in range(n):
            img = resize_cubic((rng.random((5, 5, 3)) * 255).astype(np.uint8), (size, size))
            png.write_png(root / "data" / split / "HR" / f"{i:03d}.png", img)
            if split == "val":
                png.write_png(root / "data" / split / "LR" / f"{i:03d}.png",
                              resize_cubic(img, (8, 8)))


# the YAMLs' sizes, cut: (text in the YAML, its tiny replacement)
CUTS = (("num_channels: 64", "num_channels: 16"), ("num_groups: 6", "num_groups: 1"),
        ("blocks_per_group: 10", "blocks_per_group: 2"))
STAGE_CUTS = CUTS + (("batch_size: 48", "batch_size: 2"), ("num_workers: 16", "num_workers: 1"),
                     ("hr_patch_size: 256", "hr_patch_size: 32"),
                     ("d_channels: 64", "d_channels: 8"))
QAT_CUTS = CUTS + (("batch_size: 64", "batch_size: 2"), ("num_workers: 4", "num_workers: 1"),
                   ("hr_patch_size: 128", "hr_patch_size: 32"),
                   ("lr_patch_size: 32", "lr_patch_size: 8"), ("hr_size: 128", "hr_size: 32"),
                   ("lr_size: 32", "lr_size: 8"), ("epochs: 8", "epochs: 1"),
                   ("data_root: /tmp/rehearsal/processed", "data_root: data"),
                   ("save_dir: /tmp/rehearsal/ckpt_s1_qat", "save_dir: ./ckpt_qat"))


def _cut(src: Path, dest: Path, cuts) -> Path:
    text = src.read_text()
    for old, new in cuts:
        if old in text:
            text = text.replace(old, new)
        else:
            assert old == "d_channels: 64", old
    dest.write_text(text)
    return dest


def _cli_start(root, yaml, *flags) -> subprocess.Popen:
    """The train CLI on ``yaml`` over a [1, 2] grid of CPU ranks (a plain
    launch starts both), one epoch, in ``root``."""
    return subprocess.Popen(
        [sys.executable, "-m", "facesr_torch.cli.train", "--config", str(yaml),
         "--data-root", str(root / "data"), "--device", "cpu", "--epochs", "1",
         "--mesh-axes", "data,space", "--mesh-shape", "1,2", "--yes", *flags],
        cwd=str(root), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(root), "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT)})


def _cli_log(proc: subprocess.Popen) -> str:
    """The run's log, once it exited 0 on both ranks with a finite Val PSNR."""
    try:
        log, _ = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, log[-4000:]
    assert "Starting 2 ranks" in log
    for r in range(2):
        assert f"rank {r} of 2 on cpu, at (0, {r}) of the data,space grid (1, 2)" in log
    psnr = [float(v) for v in re.findall(r"Val PSNR:\s+([-\d.]+) dB", log)]
    assert psnr and all(math.isfinite(v) for v in psnr), log[-4000:]
    return log


@pytest.fixture(scope="module")
def qat_cli(tmp_path_factory):
    """The QAT YAML's run, started when the module first needs it, so it
    overlaps the stage 2 -> 3 chain."""
    root = tmp_path_factory.mktemp("qat_cli")
    _png_set(root)
    qat = _cut(ROOT / "configs" / "rehearsal" / "stage1_qat_ft.yaml", root / "qat.yaml",
               QAT_CUTS)
    proc = _cli_start(root, qat)
    yield proc, root
    proc.kill()


@pytest.fixture(scope="module")
def stage_cli(tmp_path_factory):
    """Stage 2 then stage 3 through the CLI on a [1, 2] grid, run in a
    background thread from when the module first needs it: a future of
    (the two logs, the run directory)."""
    from facesr_torch.ckpt import fckpt

    root = tmp_path_factory.mktemp("stage_cli")
    _png_set(root)
    (root / "checkpoints").mkdir()  # stage 1's best model, which stage 2 starts from
    fckpt.save_model(str(root / "checkpoints" / "best_model.fckpt"), FaceEnhanceNet(
        FaceEnhanceNetConfig(num_channels=16, num_groups=1, blocks_per_group=2), seed=3,
        device="cpu"))
    stages = ROOT / "configs" / "stages"
    s2 = _cut(stages / "stage2_ssim_config.yaml", root / "s2.yaml", STAGE_CUTS)
    s3 = _cut(stages / "stage3_gan_config.yaml", root / "s3.yaml", STAGE_CUTS)
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(lambda: ([_cli_log(_cli_start(root, s)) for s in (s2, s3)], root))


def test_the_train_cli_chains_stage2_into_the_stage3_gan_on_data_space(stage_cli):
    """Stage 2 (which data,space already ran) then stage 3, each on two
    ranks of a [1, 2] grid: stage 3 loads stage 2's best model and trains
    the GAN with D's rows split (D at 32: its last stride-2 conv gathers)."""
    from facesr_torch.ckpt import fckpt

    (_, log), root = stage_cli.result()
    assert "GAN:" in log
    tree, meta = fckpt.load_checkpoint(str(root / "checkpoints" / "final_model.fckpt"))
    assert "d_params" in tree and meta["global_step"] >= 2


def test_the_train_cli_trains_the_qat_yaml_on_data_space(qat_cli):
    from facesr_torch.ckpt import fckpt

    proc, root = qat_cli
    _cli_log(proc)
    _, meta = fckpt.load_checkpoint(str(root / "ckpt_qat" / "final_model.fckpt"))
    assert meta["global_step"] == 2  # 4 images, 2 rows a step on both ranks


def test_a_gan_and_qat_trainer_builds_on_the_grid(monkeypatch, tmp_path):
    """The GAN and QAT Trainer builds on a data,space mesh: its steps take
    the grid's row shard (the [1, 2] grid's groups are never called here:
    the replication from rank 0 is stubbed)."""
    import facesr_torch.training.trainer as trainer_mod

    mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), rank=1, world_size=2,
                      axis_names=("data", "space"), shape=(1, 2),
                      axis_groups={"data": object(), "space": object()})
    monkeypatch.setattr(trainer_mod, "replicate", lambda tree, m: tree)
    tr = trainer_mod.Trainer(
        _model(), [], [], CombinedLoss(LossConfig(**GAN_LOSS), device="cpu"),
        _trainer_cfg(tmp_path, gan_weight=0.1, qat=True, mesh_axes="data,space",
                     mesh_shape=(1, 2)), device="cpu", discriminator=_disc(), mesh=mesh)
    assert tr.use_gan and not tr.is_writer and tr._batch_divisor == 1
    for step in (tr._train_step, tr._gan_step):
        assert step.row_shard.index == 1 and step.row_shard.size == 2
    assert "space_gan_qat" not in pmesh.ROADMAP_ITEMS
