"""GAN and QAT training of the port on `data,model` grids on the CPU: the
discriminator's conv channels over the `model` ranks (its BatchNorm on the
gathered maps, its dense head whole), the GAN step (stage 3), the QAT
content and eval steps and the GAN Trainer's checkpoint, on gloo ranks
started by `facesr_torch.parallel.launch`, against the port's
single-process steps and JAX's; and JAX's own tp GAN step (the whole state
placed by its `tp_param_shardings`) against JAX's single-device step at
D 64 and D 128, which decides whether the port is held to JAX's tp step.

Sizes: FaceEnhanceNet G=2, B=2, C=16 (every weight perturbed off its init
from numpy, conv_last redrawn non-zero), HR 64, global batches of 4; D at
64 with 8 base channels and BatchNorm, every parameter and running stat
perturbed from numpy (at 128 for the JAX check). One launch a grid, [1, 2]
(2 ranks) and [2, 2] (4 ranks), in a background thread that the parent's
single-process and JAX runs overlap; the children import torch and the
port only, never JAX.

Tolerances (float32):
- A GAN run is chaotic at rounding level (Adam's first steps move every
  element by ~lr x sign(g)), so two GAN steps are held, a quantity at a
  time, to max(1e-4, 10 x its rounding floor): how far the
  single-process run moves with its inputs times (1 + 2^-23 N(0, 1)) (two
  draws) or its convs summed in another order (oneDNN off), the largest
  draw. Each step's metrics relatively; G's and D's params over their
  update, D's running stats and the four moments by relative L2 over a
  part; the first step's gradients a tensor. The control, D's channel
  blocks gathered in reversed rank order, puts D's gradients over their
  limits.
- JAX's tp GAN step against JAX's single-device one: the same quantities
  (one step at D 128, two at D 64), held to max(1e-4, 10 x JAX's own
  floor of two input draws). It holds at both sizes (at D 128 JAX's own
  floor of G's moments is 8e-4: a clipped near-tie), so the port's tp
  GAN run is held to JAX's tp run: each quantity's gap at most the
  single-process port run's gap to JAX's single-device run plus its
  limit.
- QAT: the tp runs are pinned at fake-quant ties to the single-process
  run's record (`step_numerics.fake_quant_levels`, cut to each rank's
  batch rows and output channels by `model_shard_levels`). No level or
  sign may differ off a tie, ties at most 1e-4 of the levels; then each
  quantity within max(1e-4, 10 x its floor) (two pinned input draws), the
  eval metrics alike.
- The ranks against each other bitwise; the GAN Trainer's file holds the
  gathered state bitwise.
"""

import contextlib
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.cli.step_numerics import RecordingAdamW
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models import discriminator as dmod
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.parallel import launch, tensor
from facesr_torch.parallel import mesh as pmesh
from facesr_torch.training import steps

torch.set_num_threads(1)

G, B, C, HR, BATCH = 2, 2, 16, 64, 4
D_BASE = 8
LR, D_LR, GAN_WEIGHT, CLIP = 1e-4, 1e-4, 0.5, 0.5
QAT_LR = 1e-3
GAN_LOSS = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1)
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
GAN_SEEDS = (30, 31)
QAT_SEEDS = (10, 11)
METRICS = ("loss", "d_loss", "g_adv", "d_real", "d_fake")
BASE = 1e-4
FLOOR_FACTOR = 10
FLOOR_NOISE = 2.0 ** -23
FLOOR_SEEDS = (11, 12)
FLOOR_DRAWS = FLOOR_SEEDS + ("conv_order",)
# JAX's own check: (D's input size, grid, steps)
JAX_CHECKS = [(64, "1x2", 2), (64, "2x2", 2), (128, "1x2", 1)]


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


def _np(named) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named}


def _rows(x: np.ndarray, mesh=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x if mesh is None
                                                 else pmesh.shard_batch(x, mesh)))


def _split_state(state, mesh):
    """Keep this rank's slices of ``state`` (tp); returns the specs."""
    specs = pmesh.tp_param_shardings(state, mesh)
    tensor.shard_state(state, mesh.model_shard(), specs)
    return specs


@contextlib.contextmanager
def _whole(state, mesh, specs):
    """The block sees ``state`` whole (a collective; no-op unsharded)."""
    if mesh is None:
        yield
        return
    shard = mesh.model_shard()
    tensor.unshard_state(state, shard, specs)
    try:
        yield
    finally:
        tensor.shard_state(state, shard, specs)


def _gan_step(mesh=None):
    model, disc = _model(), _disc()
    loss = CombinedLoss(LossConfig(**GAN_LOSS), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=CLIP)
    d_opt = RecordingAdamW(weight_decay=1e-3, gradient_clip=0.0)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), LR),
                             loss_params=loss.params, disc=disc,
                             d_opt_state=d_opt.init(dict(disc.named_parameters()), D_LR))
    step = steps.make_gan_train_step(lambda lp, p, t: loss.apply(lp, p, t), opt, d_opt,
                                     gan_weight=GAN_WEIGHT, mesh=mesh)
    specs = _split_state(state, mesh) if mesh is not None else None
    return state, opt, d_opt, step, specs


def _gan_state(state) -> dict:
    return {"g": _np(state.model.state_dict().items()),
            "d": _np(state.disc.state_dict().items()),
            **{f"{who}_{m}": _np((st[m]).items())
               for who, st in (("g", state.opt_state), ("d", state.d_opt_state))
               for m in ("mu", "nu")}}


def _noisy(x: torch.Tensor, noise, seed: int) -> torch.Tensor:
    if not isinstance(noise, int):
        return x
    gen = torch.Generator().manual_seed(noise + seed)
    return x * (1 + FLOOR_NOISE * torch.randn(x.shape, generator=gen))


def _gan_run(mesh=None, noise=None, seeds=GAN_SEEDS):
    """GAN steps on ``seeds`` (a rounding draw ``noise``: an input seed, or
    "conv_order", oneDNN off): each step's metrics, the first step's G and
    D gradients and the whole state after."""
    state, opt, d_opt, step, specs = _gan_step(mesh)
    out = {"metrics": []}
    order = (torch.backends.mkldnn.flags(enabled=False) if noise == "conv_order"
             else contextlib.nullcontext())
    with order:
        for i, seed in enumerate(seeds):
            _, m = step(state, _noisy(_rows(_hr(seed), mesh), noise, seed))
            out["metrics"].append({k: float(m[k]) for k in METRICS})
            if i == 0:
                out["g_grads"] = {k: v.numpy() for k, v in opt.grads.items()}
                out["d_grads"] = {k: v.numpy() for k, v in d_opt.grads.items()}
                if mesh is not None:
                    out["exchanges"] = dict(step.model_shard.counts)
    with _whole(state, mesh, specs):
        out.update(_gan_state(state))
    return out


def _reversed_gather():
    """The control: D's convs gather the ranks' channel blocks in reversed
    rank order (still every rank's exchange); returns the undo."""
    real = dmod.conv2d

    def conv(x, w, b=None, padding=1, dtype=None, groups=1, stride=1):
        tp = tensor.current()
        if tp is None or not tensor.is_split(w):
            return real(x, w, b, padding=padding, dtype=dtype, groups=groups, stride=stride)
        with tensor.split(None):
            y = real(tp.copy(x), w, b, padding=padding, dtype=dtype, stride=stride)
        return torch.cat(tp.gather(y).split(y.shape[-1], dim=-1)[::-1], dim=-1)

    dmod.conv2d = conv
    return lambda: setattr(dmod, "conv2d", real)


def _qat_step(mesh=None):
    from facesr_torch.ops.quant import fake_quant_params

    model = _model()
    sites = fake_quant_params(model)
    loss = CombinedLoss(LossConfig(**GAN_LOSS), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=CLIP)
    state = steps.TrainState(model=model,
                             opt_state=opt.init(dict(model.named_parameters()), QAT_LR),
                             loss_params=loss.params)
    apply = lambda lp, p, t: loss.apply(lp, p, t)  # noqa: E731
    specs = _split_state(state, mesh) if mesh is not None else None
    return (state, opt, steps.make_train_step(apply, opt, quant_fn=lambda: sites, mesh=mesh),
            steps.make_eval_step(apply, quant_fn=lambda: sites, mesh=mesh), specs)


def _qat_run(ref=None, mesh=None, noise=None):
    """Two QAT steps and the eval step on fresh weights, each pinned at
    fake-quant ties to ``ref`` (the single-process run's record, cut to
    this rank's rows and channels) or, without one, recorded."""
    from facesr_torch.cli.step_numerics import fake_quant_levels, model_shard_levels

    state, opt, step, _, specs = _qat_step(mesh)
    batch = slice(None)
    if mesh is not None:
        per = BATCH // mesh.data_size
        batch = slice(mesh.axis_index("data") * per, (mesh.axis_index("data") + 1) * per)

    def pin(record, shard):
        if record is None:
            return None
        return model_shard_levels(record, shard, batch) if shard is not None else (
            lambda i, w: (record["weights"][i], record["levels"][i], record["outputs"][i]))

    out = {"losses": [], "grads": []}
    with fake_quant_levels(pin(None if ref is None else ref["steps"], step.model_shard)) as rec:
        for seed in QAT_SEEDS:
            _, m = step(state, _noisy(_rows(_hr(seed), mesh), noise, seed))
            out["losses"].append(float(m["loss"]))
            out["grads"].append({k: v.numpy() for k, v in opt.grads.items()})
    with _whole(state, mesh, specs):
        out.update(params=_np(state.model.state_dict().items()),
                   mu=_np(state.opt_state["mu"].items()))
    fresh, _, _, eval_step, _ = _qat_step(mesh)
    with fake_quant_levels(pin(None if ref is None else ref["eval"],
                               eval_step.model_shard)) as rec_eval:
        metrics, _, _ = eval_step(fresh, _rows(_hr(20), mesh))
    out["eval"] = {k: float(v) for k, v in metrics.items()}
    out["ties"] = rec["ties"] + rec_eval["ties"]
    out["off_tie"] = rec["off_tie"] + rec_eval["off_tie"]
    out["levels"] = sum(lv.numel() for r in (rec, rec_eval) for lv in r["levels"])
    if ref is None:
        out["record"] = {"steps": _record(rec), "eval": _record(rec_eval)}
    return out


def _record(rec) -> dict:
    return {"weights": [t.to(torch.int8) for t in rec["weights"]],
            "levels": [t.to(torch.int8) for t in rec["levels"]], "outputs": rec["outputs"]}


def _gan_trainer(ckpt_dir, train, val, mesh=None, **grid):
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    cfg = TrainerConfig(epochs=1, learning_rate=LR, weight_decay=1e-2, gradient_clip=CLIP,
                        use_amp=False, save_every=1, checkpoint_dir=str(ckpt_dir), ema_decay=0.9,
                        step_log_every=0, d_learning_rate=D_LR, gan_weight=GAN_WEIGHT,
                        async_checkpoint=False, **grid)
    return Trainer(_model(), train, val, CombinedLoss(LossConfig(**GAN_LOSS), device="cpu"), cfg,
                   device="cpu", discriminator=_disc(), mesh=mesh)


def _gan_trainer_state(tr) -> dict:
    with tr.whole_state():
        return {"g": _np(tr.model.state_dict().items()), "d": _np(tr.disc.state_dict().items()),
                "d_mu": _np(tr.state.d_opt_state["mu"].items()),
                "ema": _np(tr.state.ema_params.items())}


def _worker(mesh, tmp, extras, qat_ref):
    """Everything a rank of one grid runs, in one launch."""
    torch.set_num_threads(1)
    out = {"rank": mesh.rank, "coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
    out["gan"] = _gan_run(mesh)
    undo = _reversed_gather()
    try:
        out["reversed"] = _gan_run(mesh, seeds=GAN_SEEDS[:1])
    finally:
        undo()
    out["qat"] = _qat_run(qat_ref, mesh)
    if "trainer" in extras:
        own = Path(tmp) / f"rank{mesh.rank}"
        batches = [{"hr": pmesh.shard_batch(_hr(40 + i), mesh)} for i in range(2)]
        tr = _gan_trainer(own, batches, batches[:1], mesh, mesh_axes="data,model",
                          mesh_shape=mesh.shape)
        out["history"] = tr.train()
        out["writer"] = tr.is_writer
        out["trainer_state"] = _gan_trainer_state(tr)
    return out


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both grids' ranks, launched one grid after the other in a background
    thread, so that the parent's single-process and JAX runs overlap them:
    a future of (each grid's results, the launch directory), and the
    single-process QAT run the ranks are pinned to with its record."""
    tmp = tmp_path_factory.mktemp("tp_gan")
    qat = _qat_run()
    sent = qat.pop("record")

    def run():
        out = {}
        for name, (d, t) in GRIDS.items():
            extras = ("trainer",) if name == "1x2" else ()
            out[name] = launch.run_ranks(_worker, d * t, args=(str(tmp / name), extras, sent),
                                         devices=["cpu"] * (d * t), timeout=120,
                                         run_timeout=400, axis_names=("data", "model"),
                                         shape=(d, t))
        return out, tmp

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run), (qat, sent)


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


def _split(sd):
    """A D state dict's parameters and running stats apart."""
    return ({k: v for k, v in sd.items() if "running" not in k},
            {k: v for k, v in sd.items() if "running" in k})


def _gan_errors(got, want) -> dict:
    """How far a GAN run is from another: each step's metrics (the largest
    relative error), the first step's gradients a tensor, G's and D's
    params over their update, D's running stats and the four moments by
    relative L2 over a part."""
    g0 = _np(_model().state_dict().items())
    d0 = _split(_np(_disc().state_dict().items()))[0]
    (d_got, s_got), (d_want, s_want) = _split(got["d"]), _split(want["d"])
    errs = {f"step {i}": max(abs(a[k] - b[k]) / abs(b[k]) for k in METRICS)
            for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"]))}
    for part in ("g_grads", "d_grads"):
        errs.update({f"{part}.{k}": _rel_l2(got[part][k], v) for k, v in want[part].items()})
    errs.update({"G": _rel_l2(got["g"], want["g"], g0), "D": _rel_l2(d_got, d_want, d0),
                 "BN stats": _rel_l2(s_got, s_want),
                 **{k: _rel_l2(got[k], want[k]) for k in ("g_mu", "g_nu", "d_mu", "d_nu")}})
    return errs


def _limits(errors_of_draws) -> dict:
    return {k: max(BASE, FLOOR_FACTOR * max(d[k] for d in errors_of_draws))
            for k in errors_of_draws[0]}


def _over(errors, limits) -> dict:
    return {k: (e, limits[k]) for k, e in errors.items() if e > limits[k]}


@pytest.fixture(scope="module")
def single_gan(launched):
    """The single-process GAN run (two steps) and each quantity's limit."""
    base = _gan_run()
    return base, _limits([_gan_errors(_gan_run(noise=n), base) for n in FLOOR_DRAWS])


def _qat_errors(got, want) -> dict:
    errs = {f"loss{i}": abs(a - b) / abs(b) for i, (a, b) in
            enumerate(zip(got["losses"], want["losses"]))}
    for i, grads in enumerate(want["grads"]):
        errs.update({f"grads{i}.{k}": _rel_l2(got["grads"][i][k], v) for k, v in grads.items()})
    for part in ("params", "mu"):
        errs.update({f"{part}.{k}": _rel_l2(got[part][k], v) for k, v in want[part].items()})
    errs.update({f"eval.{k}": abs(got["eval"][k] - v) / abs(v) for k, v in want["eval"].items()})
    return errs


def _jax_gan_runs(size, grids, n_steps):
    """JAX's GAN step at D ``size``: {None: the single-device run, "noise
    <seed>": the same with its inputs times (1 + 2^-23 N(0, 1)), grid: the
    run on that ("data", "model") grid with the whole state placed by
    JAX's `tp_param_shardings`}, ``n_steps`` steps each."""
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.models import discriminator as jdisc
    from facesr.models import face_enhance_net as fen
    from facesr.parallel import batch_sharding, get_mesh, replicated
    from facesr.parallel import tp_param_shardings as jax_tp
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt.weights import jax_discriminator_from_state_dict, jax_params_from

    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    dcfg = jdisc.DiscriminatorConfig(in_channels=3, base_channels=D_BASE, input_size=size)
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**GAN_LOSS), seed=0)
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=CLIP)
    tx_d = jsteps.make_optimizer(weight_decay=1e-3, gradient_clip=0.0)
    params = jax.tree.map(jnp.asarray, jax_params_from(_model()))
    dparams, dstats = jax.tree.map(jnp.asarray, jax_discriminator_from_state_dict(
        _disc(size).state_dict()))
    fresh = lambda: jsteps.TrainState(  # noqa: E731
        step=jnp.asarray(0), params=params,
        opt_state=jsteps.set_learning_rate(tx.init(params), LR), loss_params=jloss.params,
        d_params=dparams, d_stats=dstats,
        d_opt_state=jsteps.set_learning_rate(tx_d.init(dparams), D_LR))
    fn = jsteps.make_gan_train_step(
        lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype),
        jloss.apply, lambda p, st, x, train: jdisc.apply(p, st, x, dcfg, train=train),
        tx, tx_d, gan_weight=GAN_WEIGHT)

    def run(state, step, put, noise=None):
        metrics = []
        for seed in GAN_SEEDS[:n_steps]:
            x = _hr(seed, size=size)
            if noise is not None:
                x = (x * (1 + FLOOR_NOISE * np.random.default_rng(noise + seed)
                          .standard_normal(x.shape))).astype(np.float32)
            state, m = step(state, put(x))
            metrics.append({k: float(m[k]) for k in METRICS})
        return _port_record(jax.device_get(state), metrics)

    single = jax.jit(fn)
    out = {None: run(fresh(), single, jnp.asarray)}
    for noise in FLOOR_SEEDS:
        out[f"noise {noise}"] = run(fresh(), single, jnp.asarray, noise)
    for grid in grids:
        d, t = GRIDS[grid]
        mesh = get_mesh(jax.devices()[:d * t], axis_names=("data", "model"), shape=(d, t))
        state = fresh()
        sh = jax_tp(state, mesh, axis="model")
        batch = replicated(mesh) if d == 1 else batch_sharding(mesh, "data")
        step = jax.jit(fn, in_shardings=(sh, batch), out_shardings=(sh, None))
        out[grid] = run(jax.device_put(state, sh), step,
                        lambda x: jax.device_put(x, batch))  # noqa: B023
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


def _port_record(jstate, metrics) -> dict:
    """A JAX GAN state in `_gan_state`'s layout (through `ckpt/weights.py`)."""
    from facesr_torch.ckpt.weights import (discriminator_state_dict_from_jax,
                                           state_dict_from_jax_params)

    def tree_np(tree):
        import jax

        return jax.tree.map(np.asarray, tree)

    g = lambda tree: {k: v.numpy() for k, v in state_dict_from_jax_params(  # noqa: E731
        tree_np(tree)).items()}
    stats = tree_np(jstate.d_stats)
    d = lambda tree: {k: v.numpy() for k, v in discriminator_state_dict_from_jax(  # noqa: E731
        tree_np(tree), stats).items()}
    g_adam, d_adam = _adam(jstate.opt_state), _adam(jstate.d_opt_state)
    strip = lambda sd: {k: v for k, v in sd.items() if "running" not in k}  # noqa: E731
    return {"metrics": metrics, "g": g(jstate.params), "d": d(jstate.d_params),
            "g_mu": g(g_adam.mu), "g_nu": g(g_adam.nu), "d_mu": strip(d(d_adam.mu)),
            "d_nu": strip(d(d_adam.nu))}


def _state_errors(got, want, size=HR) -> dict:
    """`_gan_errors` without the gradients (JAX's runs record none)."""
    g0 = _np(_model().state_dict().items())
    d0 = _split(_np(_disc(size).state_dict().items()))[0]
    (d_got, s_got), (d_want, s_want) = _split(got["d"]), _split(want["d"])
    errs = {f"step {i}": max(abs(a[k] - b[k]) / abs(b[k]) for k in METRICS)
            for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"]))}
    errs.update({"G": _rel_l2(got["g"], want["g"], g0), "D": _rel_l2(d_got, d_want, d0),
                 "BN stats": _rel_l2(s_got, s_want),
                 **{k: _rel_l2(got[k], want[k]) for k in ("g_mu", "g_nu", "d_mu", "d_nu")}})
    return errs


@pytest.fixture(scope="module")
def jax_gan(launched):
    """JAX's single-device GAN runs with each quantity's limit (its floor of
    two input draws), and its tp runs of `JAX_CHECKS`, by (size, grid)."""
    out = {}
    for size in sorted({s for s, _, _ in JAX_CHECKS}):
        grids = [g for s, g, _ in JAX_CHECKS if s == size]
        runs = _jax_gan_runs(size, grids, max(k for s, _, k in JAX_CHECKS if s == size))
        base = runs[None]
        out[size, None] = base, _limits([_state_errors(runs[f"noise {n}"], base, size)
                                         for n in FLOOR_SEEDS])
        out.update({(size, g): runs[g] for g in grids})
    return out


@pytest.fixture(scope="module")
def single_qat(launched):
    """The single-process QAT run the ranks were pinned to, and each
    quantity's limit from two input draws pinned to its record alike."""
    want, record = launched[1]
    draws = [_qat_errors(_qat_run(record, noise=seed), want) for seed in FLOOR_SEEDS]
    return want, _limits(draws)


@pytest.fixture(scope="module")
def ranks(launched, single_gan, jax_gan, single_qat):
    """`launched`'s results, awaited once the parent's runs are done."""
    return launched[0].result()


# ---------------------------------------------------------------------------
# JAX's own tp GAN step


@pytest.mark.parametrize("size,grid,n_steps", JAX_CHECKS)
def test_jaxs_tp_gan_step_matches_its_single_device_step(jax_gan, size, grid, n_steps):
    """JAX's GAN step with the whole state (G, D, D's stats, both
    optimisers) placed by its `tp_param_shardings` on a ("data", "model")
    mesh, against its single-device step: each quantity within max(1e-4,
    10 x JAX's own floor). It holds at D 64 and D 128, so the port's tp
    GAN run is held to JAX's tp run below."""
    want, limits = jax_gan[size, None]
    errors = _state_errors(jax_gan[size, grid], want, size)
    print(size, grid, {k: f"{v:.3g} ({limits[k]:.3g})" for k, v in errors.items()})
    assert not _over(errors, limits), _over(errors, limits)


# ---------------------------------------------------------------------------
# the port's GAN step on data,model


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_tp_gan_steps_match_the_single_process_steps(ranks, single_gan, grid):
    want, limits = single_gan
    for r in ranks[0][grid]:
        assert r["coords"] == divmod(r["rank"], GRIDS[grid][1])
        errors = _gan_errors(r["gan"], want)
        assert not _over(errors, limits), _over(errors, limits)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_ds_channel_blocks_gathered_in_reversed_order_are_rejected(ranks, single_gan, grid):
    want, limits = single_gan
    over = _over(_gan_errors(ranks[0][grid][0]["reversed"], {**want, "metrics":
                                                              want["metrics"][:1]}), limits)
    d_over = [k for k in over if k.startswith("d_grads.")]
    assert len(d_over) > len(want["d_grads"]) // 2, sorted(over)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_tp_gan_steps_match_jaxs_tp_gan_steps(ranks, single_gan, jax_gan, grid):
    """Each quantity's gap to JAX's tp run at most the single-process port
    run's gap to JAX's single-device run plus its limit."""
    want, limits = single_gan
    jax_single, _ = jax_gan[HR, None]
    own_gap = _state_errors(want, jax_single)
    for r in ranks[0][grid]:
        gap = _state_errors(r["gan"], jax_gan[HR, grid])
        over = {k: (v, own_gap[k] + limits[k]) for k, v in gap.items()
                if v > own_gap[k] + limits[k]}
        assert not over, over


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_every_rank_of_the_grid_holds_bitwise_the_same_gan_and_qat_state(ranks, grid):
    out = ranks[0][grid]
    for r in out[1:]:
        for part in ("g", "d", "g_mu", "d_mu", "d_nu"):
            assert all(np.array_equal(r["gan"][part][k], v)
                       for k, v in out[0]["gan"][part].items()), part
        assert r["gan"]["metrics"] == out[0]["gan"]["metrics"]
        for part in ("params", "mu"):
            assert all(np.array_equal(r["qat"][part][k], v)
                       for k, v in out[0]["qat"][part].items()), part


def test_a_tp_gan_step_gathers_every_split_conv_and_ds_batchnorm_leaves(ranks):
    """The first GAN step on a rank of the [1, 2] grid: G's forward and its
    remat recompute, D's three forwards (10 convs each, the first's bias
    and nine BatchNorms' affine and running stats gathered for the use);
    every split conv's input gradient summed over `model` once."""
    got = ranks[0]["1x2"][0]["gan"]["exchanges"]
    g_forward = 1 + G * (2 * B + 1) + 1 + 2  # conv_first, the trunk, conv_after_body, upsample
    g_remat = G * 2 * B  # the RCABs' two convs again (remat save_ca)
    assert got["gather"] == g_forward + g_remat + 3 * 10
    # PReLUs: G * B RCABs + 2 upsample stages, again in the recompute; D's
    # nine BatchNorms two leaf gathers a forward
    assert got["leaf"] == (G * B + 2) + G * B + 3 * 9 * 2
    assert got["sum"] == 1 and got["copy"] >= g_forward


# ---------------------------------------------------------------------------
# QAT on data,model


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_tp_qat_steps_pinned_at_ties_match_the_single_process_steps(ranks, single_qat, grid):
    """Two QAT steps and the eval step on each rank, pinned at ties to the
    single-process run; within max(1e-4, 10 x the pinned floor)."""
    want, limits = single_qat
    for r in ranks[0][grid]:
        got = r["qat"]
        assert got["off_tie"] == 0 and got["ties"] <= 1e-4 * got["levels"], \
            (got["ties"], got["off_tie"], got["levels"])
        errors = _qat_errors(got, want)
        assert not _over(errors, limits), _over(errors, limits)


# ---------------------------------------------------------------------------
# the GAN Trainer's checkpoint


def test_a_data_model_gan_trainer_file_holds_the_gathered_state_and_resumes_in_one_process(
        ranks, tmp_path):
    out, tmp = ranks[0]["1x2"], ranks[1] / "1x2"
    assert [r["writer"] for r in out] == [True, False]
    assert not (tmp / "rank1").exists()
    for part, tensors in out[0]["trainer_state"].items():
        assert all(np.array_equal(v, out[1]["trainer_state"][part][k])
                   for k, v in tensors.items()), part
    back = _gan_trainer(tmp_path, [], [])
    back.load_checkpoint(str(tmp / "rank0" / "final_model.fckpt"))
    got = _gan_trainer_state(back)
    for part, tensors in out[0]["trainer_state"].items():
        assert all(np.array_equal(got[part][k], v) for k, v in tensors.items()), part
    assert back.current_epoch == 1 and back.state.step == 2
    assert all(math.isfinite(v) for v in out[0]["history"]["d_loss"])
