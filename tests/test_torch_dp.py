"""Data parallelism of the port on the CPU: two gloo ranks started by the
port's launcher (`facesr_torch.parallel.launch`) against the port's
single-process step on the global batch and against the JAX package's dp
step on a 2-device CPU mesh.

Sizes: FaceEnhanceNet G=2, B=2, C=16 (every weight perturbed off its init
from numpy, conv_last redrawn non-zero), HR 32, a global batch of 8 (4
rows a rank); the GAN step's discriminator at 32 with 8 base channels and
BatchNorm. The ranks run in one module-scoped launch (`dp_ranks`); the
child processes import torch and the port only, never JAX.

Tolerances (float32):
- dp against the single process: the content loss within 1e-6
  absolute, the GAN step's losses rtol 1e-5 (its adversarial term reads D
  after an update, whose Adam step is ~lr * sign(g)); every gradient,
  updated parameter and BN stat within 1e-5 relative L2 (the ranks sum
  two half-batch gradients, another summation order), except the GAN
  step's G gradients, 1e-4 (they pass through D after that update;
  measured 2.7e-5 at one SE matrix);
- ranks against each other: parameters, optimiser state and BN stats
  bitwise;
- dp against JAX's dp: losses rtol 1e-5; params after 2 steps within
  5e-6 absolute (lr 1e-3: an Adam step moves an element by ~lr and a
  gradient near eps moves it by a share of that); D's gradients normwise
  1e-4 (`max|a - b| <= tol * max|b|`, other conv summation orders through
  10 layers); the BN running stats after the step 1e-4 relative L2. The
  control, a per-rank `F.batch_norm`, sits orders above both;
- the Trainer's `.fckpt` against a single-process Trainer's: 1e-5
  relative L2 a tensor, validation metrics rtol 1e-5.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.cli.step_numerics import RecordingAdamW
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models.discriminator import create_discriminator
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.ops.conv import full_f32
from facesr_torch.ops.resize import bicubic_down
from facesr_torch.parallel import launch
from facesr_torch.parallel import mesh as pmesh
from facesr_torch.training import steps
from facesr_torch.training.optim import AdamW

torch.set_num_threads(1)

G, B, C, HR, BATCH, WORLD = 2, 2, 16, 32, 8, 2
D_SIZE, D_BASE = 32, 8
LR, D_LR, GAN_WEIGHT = 1e-3, 1e-4, 0.5
LOSS = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1)
GAN_LOSS = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.0)


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


def _disc():
    d = create_discriminator(input_size=D_SIZE, base_channels=D_BASE, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in d.parameters():
            p.add_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) * 0.05)
    return d


def _hr(seed, n=BATCH, size=HR) -> np.ndarray:
    """Smooth HR images in [0, 1]."""
    rng = np.random.default_rng(seed)
    lo = rng.random((n, size // 4, size // 4, 3), dtype=np.float32)
    return np.clip(np.kron(lo, np.ones((1, 4, 4, 1), np.float32))
                   + rng.normal(0, 0.02, (n, size, size, 3)), 0, 1).astype(np.float32)


def _content_step(mesh=None):
    model = _model()
    loss = CombinedLoss(LossConfig(**LOSS), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=0.5)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), LR),
                             loss_params=loss.params)
    return state, opt, steps.make_train_step(lambda lp, p, t: loss.apply(lp, p, t), opt,
                                             mesh=mesh)


def _gan_step(mesh=None):
    model, disc = _model(), _disc()
    loss = CombinedLoss(LossConfig(**GAN_LOSS), device="cpu")
    opt = RecordingAdamW(weight_decay=1e-2, gradient_clip=1e3)
    d_opt = RecordingAdamW(weight_decay=1e-3, gradient_clip=0.0)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), LR),
                             loss_params=loss.params, disc=disc,
                             d_opt_state=d_opt.init(dict(disc.named_parameters()), D_LR))
    step = steps.make_gan_train_step(lambda lp, p, t: loss.apply(lp, p, t), opt, d_opt,
                                     gan_weight=GAN_WEIGHT, mesh=mesh)
    return state, opt, d_opt, step


def _np(named) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named}


def _rows(x: np.ndarray, mesh) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(pmesh.shard_batch(x, mesh)))


def _per_rank_bn(disc):
    """The control: D's forward with the mesh dropped, so each rank's
    BatchNorm takes its own rows' statistics."""
    forward = disc.forward
    disc.forward = lambda x, train=True, dtype=None, mesh=None: forward(x, train, dtype)


TRAIN_BATCHES = [_hr(40 + i) for i in range(2)]
# the last global validation batches are uneven: 3 rows (2 + 1) and 1 row
# (rank 0 only: rank 1 adds a masked batch)
VAL_BATCHES = [_hr(50), _hr(51, n=3), _hr(52, n=1)]


def _rank_val(rank):
    out = []
    for b in VAL_BATCHES:
        per = math.ceil(len(b) / WORLD)
        rows = b[rank * per:(rank + 1) * per]
        if len(rows):
            out.append({"hr": rows})
    return out


def _trainer(ckpt_dir, train, val, mesh=None):
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    cfg = TrainerConfig(epochs=1, learning_rate=LR, weight_decay=1e-2, gradient_clip=0.5,
                        use_amp=False, save_every=1, checkpoint_dir=str(ckpt_dir),
                        ema_decay=0.9, step_log_every=0)
    return Trainer(_model(), train, val, CombinedLoss(LossConfig(**LOSS), device="cpu"), cfg,
                   device="cpu", mesh=mesh)


def _dp_worker(mesh, tmp):
    """Everything the two ranks run, in one launch."""
    torch.set_num_threads(1)
    out = {"rank": mesh.rank}
    # the content step, twice, each rank on its 4 rows of the global batch
    state, opt, step = _content_step(mesh)
    losses, grads = [], []
    for seed in (10, 11):
        _, m = step(state, _rows(_hr(seed), mesh))
        losses.append(float(m["loss"]))
        grads.append({k: v.numpy() for k, v in opt.grads.items()})
        if seed == 10:
            out["content_params_1"] = _np(state.model.named_parameters())
    out.update(content_losses=losses, content_grads=grads,
               content_params=_np(state.model.state_dict().items()),
               content_mu=_np(state.opt_state["mu"].items()))
    # the GAN step, with the global BatchNorm and with the per-rank control
    for case in ("global_bn", "per_rank_bn"):
        state, opt, d_opt, step = _gan_step(mesh)
        if case == "per_rank_bn":
            _per_rank_bn(state.disc)
        hr = _rows(_hr(30), mesh)
        with torch.no_grad(), full_f32():  # the step's fake batch, computed alike
            sr = state.model(bicubic_down(hr, 4), train=True)
        _, m = step(state, hr)
        out[case] = {"metrics": {k: float(v) for k, v in m.items()}, "sr": sr.numpy(),
                     "d_grads": {k: v.numpy() for k, v in d_opt.grads.items()},
                     "g_grads": {k: v.numpy() for k, v in opt.grads.items()},
                     "g_params": _np(state.model.named_parameters()),
                     "disc": _np(state.disc.state_dict().items())}
    # one Trainer epoch; each rank its own checkpoint directory
    train = [{"hr": pmesh.shard_batch(b, mesh)} for b in TRAIN_BATCHES]
    tr = _trainer(Path(tmp) / f"rank{mesh.rank}", train, _rank_val(mesh.rank), mesh)
    out["history"] = tr.train()
    out["trainer_params"] = _np(tr.model.state_dict().items())
    out["is_writer"] = tr.is_writer
    out["overfit"] = _overfit(mesh)
    return out


def _overfit(mesh=None):
    from facesr_torch.training.trainer import overfit_test

    model = _model()
    res = overfit_test(model, [{"hr": _hr(60, n=7)}], num_images=7, num_iterations=3,
                       learning_rate=1e-3, device="cpu", mesh=mesh)
    return {"losses": res["loss_history"], "params": _np(model.named_parameters())}


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    ranks = launch.run_ranks(_dp_worker, WORLD, args=(str(tmp),), devices=["cpu"] * WORLD,
                             timeout=120, run_timeout=300)
    return ranks, tmp


# ---------------------------------------------------------------------------
# the content step


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_dp_content_step_matches_the_single_process_step_on_the_global_batch(dp_ranks):
    ranks, _ = dp_ranks
    state, opt, step = _content_step()
    for i, seed in enumerate((10, 11)):
        _, m = step(state, torch.from_numpy(_hr(seed)))
        for r in ranks:
            assert abs(r["content_losses"][i] - float(m["loss"])) <= 1e-6
            worst = max(_rel_l2(r["content_grads"][i][k], g.numpy())
                        for k, g in opt.grads.items())
            assert worst <= 1e-5, (i, worst)
        if i == 0:
            for r in ranks:
                for k, p in state.model.named_parameters():
                    assert _rel_l2(r["content_params_1"][k], p.detach().numpy()) <= 1e-5, k
    for r in ranks:
        for k, v in state.model.state_dict().items():
            assert _rel_l2(r["content_params"][k], v.numpy()) <= 1e-5, k


def test_an_unreduced_gradient_is_not_the_global_one():
    """The control of the gradient check: one rank's own 4 rows alone."""
    state, opt, step = _content_step()
    step(state, torch.from_numpy(_hr(10)))
    full = dict(opt.grads)
    state, opt, step = _content_step()
    step(state, torch.from_numpy(_hr(10)[:BATCH // WORLD]))
    assert max(_rel_l2(opt.grads[k], full[k]) for k in full) > 1e-2


@pytest.mark.parametrize("part", ["content_params", "content_mu", "global_bn", "trainer_params"])
def test_every_rank_holds_bitwise_the_same_state(dp_ranks, part):
    a, b = dp_ranks[0]
    if part == "global_bn":
        want, got = ({**r["global_bn"]["g_params"], **r["global_bn"]["disc"]} for r in (a, b))
    else:
        want, got = a[part], b[part]
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def _jax_state(params, jsteps, tx, lr, jlp):
    import jax
    import jax.numpy as jnp

    p = jax.tree.map(jnp.asarray, params)
    return jsteps.TrainState(step=jnp.asarray(0), params=p,
                             opt_state=jsteps.set_learning_rate(tx.init(p), lr), loss_params=jlp)


def test_dp_content_steps_match_jax_dp_on_a_two_device_mesh(dp_ranks):
    import jax

    from facesr.losses import combined as jcombined
    from facesr.models import face_enhance_net as fen
    from facesr.parallel import batch_sharding, get_mesh, replicate, replicated
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt.weights import jax_params_from, state_dict_from_jax_params

    ranks, _ = dp_ranks
    model = _model()
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**LOSS), seed=0)
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=0.5)
    mesh = get_mesh(jax.devices()[:WORLD])
    state = replicate(_jax_state(jax_params_from(model), jsteps, tx, LR, jloss.params), mesh)
    step = jax.jit(jsteps.make_train_step(
        lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype),
        jloss.apply, tx, scale_factor=4, compute_dtype=None),
        in_shardings=(replicated(mesh), batch_sharding(mesh)))
    for i, seed in enumerate((10, 11)):
        state, m = step(state, jax.device_put(_hr(seed), batch_sharding(mesh)))
        for r in ranks:
            np.testing.assert_allclose(r["content_losses"][i], float(m["loss"]), rtol=1e-5)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jax.device_get(state.params)))
    for r in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(r["content_params"][k], v.numpy(), atol=5e-6, rtol=0,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the GAN step: D's BatchNorm takes the global statistics


@pytest.fixture(scope="module")
def jax_gan(dp_ranks):
    """JAX's D gradient of the first D update and the state after one GAN
    step, on the 2-device mesh (the batch statistics are global there).
    The gradient takes the ranks' own generator output as its fake batch:
    D's first conv feeds a LeakyReLU and then a BatchNorm, so its gradient
    is a sum that cancels, and the rounding-level difference of the two
    packages' generators moves it far past the tolerance."""
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.losses import gan as jgan
    from facesr.models import discriminator as jdisc
    from facesr.models import face_enhance_net as fen
    from facesr.parallel import batch_sharding, get_mesh, replicate, replicated
    from facesr.training import steps as jsteps
    from facesr_torch.ckpt.weights import jax_discriminator_from_state_dict, jax_params_from

    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    dcfg = jdisc.DiscriminatorConfig(in_channels=3, base_channels=D_BASE, input_size=D_SIZE)
    params = jax.tree.map(jnp.asarray, jax_params_from(_model()))
    dparams, dstats = jax.tree.map(jnp.asarray, jax_discriminator_from_state_dict(
        _disc().state_dict()))
    mesh = get_mesh(jax.devices()[:WORLD])
    hr = jax.device_put(_hr(30), batch_sharding(mesh))
    sr = jax.device_put(np.concatenate([r["global_bn"]["sr"] for r in dp_ranks[0]]),
                        batch_sharding(mesh))

    def d_loss(dp, stats, hr, sr):
        real, stats = jdisc.apply(dp, stats, hr, dcfg, train=True)
        fake, stats = jdisc.apply(dp, stats, sr, dcfg, train=True)
        return (jgan.gan_loss(real, True) + jgan.gan_loss(fake, False)) / 2

    d_grads = jax.jit(jax.grad(d_loss), in_shardings=(
        replicated(mesh), replicated(mesh), batch_sharding(mesh), batch_sharding(mesh)))(
            dparams, dstats, hr, sr)
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**GAN_LOSS), seed=0)
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=1e3)
    tx_d = jsteps.make_optimizer(weight_decay=1e-3, gradient_clip=0.0)
    state = jsteps.TrainState(
        step=jnp.asarray(0), params=params,
        opt_state=jsteps.set_learning_rate(tx.init(params), LR), loss_params=jloss.params,
        d_params=dparams, d_stats=dstats,
        d_opt_state=jsteps.set_learning_rate(tx_d.init(dparams), D_LR))
    step = jax.jit(jsteps.make_gan_train_step(
        lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype),
        jloss.apply, lambda p, s, x, train: jdisc.apply(p, s, x, dcfg, train=train),
        tx, tx_d, gan_weight=GAN_WEIGHT), in_shardings=(replicated(mesh), batch_sharding(mesh)))
    state, metrics = step(replicate(state, mesh), hr)
    return (jax.device_get(d_grads), jax.device_get(state), dstats,
            {k: float(v) for k, v in metrics.items()})


def _d_named(tree, stats):
    from facesr_torch.ckpt.weights import discriminator_state_dict_from_jax

    return {k: v.numpy() for k, v in discriminator_state_dict_from_jax(
        jax_tree(tree), jax_tree(stats)).items()}


def jax_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("case", ["global_bn", "per_rank_bn"])
def test_dp_gan_step_takes_jaxs_global_batchnorm_and_rejects_the_per_rank_control(
        dp_ranks, jax_gan, case):
    ranks, _ = dp_ranks
    d_grads, state, dstats, metrics = jax_gan
    want_grads = {k: v for k, v in _d_named(d_grads, dstats).items() if "running" not in k}
    want_stats = {k: v for k, v in _d_named(state.d_params, state.d_stats).items()
                  if "running" in k}
    grad_err = max(_normwise(ranks[0][case]["d_grads"][k], v) for k, v in want_grads.items())
    stats_err = max(_rel_l2(ranks[0][case]["disc"][k], v) for k, v in want_stats.items())
    print(case, f"D gradients normwise {grad_err:.3g}, BN stats relative L2 {stats_err:.3g}")
    if case == "global_bn":
        assert grad_err <= 1e-4 and stats_err <= 1e-4
        for k in ("loss", "d_loss", "g_adv", "d_real", "d_fake"):
            np.testing.assert_allclose(ranks[0][case]["metrics"][k], metrics[k], rtol=1e-5,
                                       err_msg=k)
    else:
        assert grad_err > 1e-2 and stats_err > 1e-2


def test_dp_gan_step_matches_the_single_process_step(dp_ranks):
    ranks, _ = dp_ranks
    state, opt, d_opt, step = _gan_step()
    _, m = step(state, torch.from_numpy(_hr(30)))
    got = ranks[0]["global_bn"]
    for k in ("loss", "d_loss", "g_adv"):  # g_adv reads D after its update
        np.testing.assert_allclose(got["metrics"][k], float(m[k]), rtol=1e-5, err_msg=k)
    # G's gradients pass through D after its update: 1e-4, as the card's steps
    for mine, theirs, tol in ((got["d_grads"], d_opt.grads, 1e-5),
                              (got["g_grads"], opt.grads, 1e-4)):
        assert max(_rel_l2(mine[k], v.numpy()) for k, v in theirs.items()) <= tol
    for k, v in state.disc.state_dict().items():
        assert _rel_l2(got["disc"][k], v.numpy()) <= 1e-5, k


# ---------------------------------------------------------------------------
# the Trainer


def test_two_rank_trainer_writes_on_rank0_only_and_equals_the_single_process_one(
        dp_ranks, tmp_path):
    from facesr_torch.ckpt import fckpt

    ranks, tmp = dp_ranks
    assert [r["is_writer"] for r in ranks] == [True, False]
    assert not (tmp / "rank1").exists()
    files = sorted(p.name for p in (tmp / "rank0").iterdir())
    assert files == sorted(f"{s}{x}" for s in ("best_model", "epoch_1", "final_model")
                           for x in (".fckpt", ".pth"))
    single = _trainer(tmp_path, [{"hr": b} for b in TRAIN_BATCHES],
                      [{"hr": b} for b in VAL_BATCHES])
    history = single.train()
    for k in ("train_loss", "val_loss", "val_psnr", "val_ssim"):
        for r in ranks:
            np.testing.assert_allclose(r["history"][k], history[k], rtol=1e-5, err_msg=k)
    got, gmeta = fckpt.load_checkpoint(str(tmp / "rank0" / "final_model.fckpt"))
    want, wmeta = fckpt.load_checkpoint(str(tmp_path / "final_model.fckpt"))
    assert gmeta["global_step"] == wmeta["global_step"] == len(TRAIN_BATCHES)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        elif tree is not None:
            yield path, np.asarray(tree)

    want_leaves = dict(leaves(want))
    got_leaves = dict(leaves(got))
    assert set(got_leaves) == set(want_leaves)
    for k, v in want_leaves.items():
        if v.dtype.kind == "f":
            assert _rel_l2(got_leaves[k], v) <= 1e-5, k
        else:
            assert np.array_equal(got_leaves[k], v), k

    # the control: the mean of the ranks' own PSNRs is another number
    def psnr(sr_minus_hr):
        return 10 * math.log10(1 / float((sr_minus_hr ** 2).mean()))

    eval_step = single._eval_step
    per_rank = []
    for b in VAL_BATCHES:
        _, sr, _ = eval_step(single.state, torch.from_numpy(b))
        per = math.ceil(len(b) / WORLD)
        parts = [slice(r * per, (r + 1) * per) for r in range(WORLD)]
        per_rank.append(np.mean([psnr(sr[p] - torch.from_numpy(b)[p]) for p in parts
                                 if len(b[p])]))
    assert abs(np.mean(per_rank) - history["val_psnr"][0]) > 1e-3


# ---------------------------------------------------------------------------
# the train CLI: two ranks from torchrun's environment


def test_train_cli_over_two_ranks_takes_the_global_batch_and_prints_memory(tmp_path):
    from facesr_torch.ckpt import fckpt
    from facesr_torch.data import png
    from facesr_torch.data.cv_compat import resize_cubic
    from facesr_torch.utils.profiling import tensor_bytes

    rng = np.random.default_rng(0)
    for split, n, size in (("train", 12, 40), ("val", 4, 32)):
        (tmp_path / "data" / split / "HR").mkdir(parents=True)
        if split == "val":
            (tmp_path / "data" / split / "LR").mkdir()
        for i in range(n):
            img = resize_cubic((rng.random((5, 5, 3)) * 255).astype(np.uint8), (size, size))
            png.write_png(tmp_path / "data" / split / "HR" / f"{i:03d}.png", img)
            if split == "val":
                png.write_png(tmp_path / "data" / split / "LR" / f"{i:03d}.png",
                              resize_cubic(img, (8, 8)))
    root = Path(__file__).resolve().parent.parent
    text = (root / "configs" / "stages" / "stage1_psnr_config.yaml").read_text()
    for old, new in (("num_channels: 64", "num_channels: 16"), ("num_groups: 6", "num_groups: 1"),
                     ("blocks_per_group: 10", "blocks_per_group: 2"),
                     ("batch_size: 48", "batch_size: 4"), ("num_workers: 16", "num_workers: 1"),
                     ("hr_patch_size: 256", "hr_patch_size: 32")):
        assert old in text, old
        text = text.replace(old, new)
    (tmp_path / "s1.yaml").write_text(text)
    codes = launch.run_cli_ranks(
        "facesr_torch.cli.train",
        ["--config", str(tmp_path / "s1.yaml"), "--data-root", str(tmp_path / "data"),
         "--device", "cpu", "--epochs", "1", "--print-memory", "--yes"],
        WORLD, timeout=240, log_dir=str(tmp_path), cwd=str(tmp_path),
        env={"OMP_NUM_THREADS": "1", "PYTHONPATH": str(root)})
    logs = [(tmp_path / f"rank{r}.log").read_text() for r in range(WORLD)]
    assert codes == [0, 0], logs
    ckpt = tmp_path / "checkpoints"
    tree, meta = fckpt.load_checkpoint(str(ckpt / "final_model.fckpt"))
    # 12 images, 6 a rank, 2 rows a rank a step: 3 steps (4 rows a card would be 1)
    assert meta["global_step"] == 3
    for r, log in enumerate(logs):
        assert f"Data parallel: rank {r} of 2 on cpu" in log
        assert "Batch size: 4 global, 2 a rank over 2 rank(s)" in log
        assert f"rank {r} of 2, device memory" in log
        got = {k: int(v) for k, v in re.findall(r"  (\w+)\s+[\d.]+ MB \((\d+) bytes\)", log)}
        assert "not measured (CPU)" in log
        model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                    blocks_per_group=2), device="cpu")
        opt = AdamW(gradient_clip=0.5).init(dict(model.named_parameters()), 1e-4)
        assert got["params"] == tensor_bytes(model)
        assert got["opt_state"] == tensor_bytes(opt) and got["ema"] == 0
        assert got["state"] == got["params"] + got["opt_state"]
        assert got["batch"] == 2 * 32 * 32 * 3 * 4  # 2 rows a rank of HR 32
    assert "checkpoint writes delegated to rank 0" in logs[1]
    assert "delegated" not in logs[0]


# ---------------------------------------------------------------------------
# serving over several devices


def _serving_model():
    return _model().eval()


@pytest.mark.parametrize("dtype", [None, torch.bfloat16, "int8", "int8_full"])
def test_sharded_predictor_on_one_device_is_the_predictor(dtype):
    from facesr_torch.parallel.serving import Predictor, ShardedPredictor

    x = np.random.default_rng(1).random((11, 16, 16, 3), dtype=np.float32)
    want = Predictor(_serving_model(), dtype=dtype, max_batch=8, device="cpu")(x)
    got = ShardedPredictor(_serving_model(), mesh=["cpu"], dtype=dtype, max_batch=8)(x)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16, "int8_full"])
def test_sharded_predictor_shards_are_the_predictor_at_their_size(dtype):
    from facesr_torch.parallel.serving import Predictor, ShardedPredictor, shard_bounds

    x = np.random.default_rng(1).random((11, 16, 16, 3), dtype=np.float32)
    sp = ShardedPredictor(_serving_model(), mesh=["cpu", "cpu"], dtype=dtype, max_batch=8)
    got = sp(x)
    one = Predictor(_serving_model(), dtype=dtype, max_batch=8, device="cpu")
    for start in range(0, len(x), sp.max_batch):
        chunk = x[start:start + sp.max_batch]
        for a, b in shard_bounds(len(chunk), 2):
            assert np.array_equal(got[start + a:start + b], one(chunk[a:b]))


def test_sharded_predictor_over_two_devices_matches_jaxs():
    import jax
    import jax.numpy as jnp

    from facesr.models import face_enhance_net as fen
    from facesr.parallel import get_mesh
    from facesr.parallel.serving import ShardedPredictor as JaxShardedPredictor
    from facesr_torch.ckpt.weights import jax_params_from
    from facesr_torch.parallel.serving import ShardedPredictor

    model = _serving_model()
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    jmodel = fen.FaceEnhanceNet(cfg, params=jax.tree.map(jnp.asarray, jax_params_from(model)))
    x = np.random.default_rng(1).random((11, 16, 16, 3), dtype=np.float32)  # partial chunks
    want = JaxShardedPredictor(jmodel, mesh=get_mesh(jax.devices()[:WORLD]), dtype=None,
                               max_batch=8)(x)
    got = ShardedPredictor(model, mesh=["cpu", "cpu"], dtype=None, max_batch=8)(x)
    assert got.shape == want.shape == (11, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# the mesh's surface and what stays unported


@pytest.mark.parametrize("axes,item", [("data,space", "A.13.2"), ("data,model", "A.13.3"),
                                       ("data,pp", "A.13.4")])
@pytest.mark.parametrize("where", ["trainer", "get_mesh"])
def test_other_mesh_axes_raise_and_name_their_item(axes, item, where, tmp_path, monkeypatch):
    import facesr_torch.training.trainer as trainer_mod
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    if axes in ("data,space", "data,model") and where == "get_mesh":
        # ported: tests/test_torch_sp.py, tests/test_torch_tp.py
        mesh = pmesh.get_mesh(["cpu"] * 2, axis_names=axes.split(","), shape=(1, 2))
        assert (mesh.data_size, mesh.axis_size(axes.split(",")[1])) == (1, 2)
        return
    if axes == "data,model":  # ported, the whole state split: tests/test_torch_tp.py
        mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), world_size=2,
                          axis_names=("data", "model"), shape=(1, 2),
                          axis_groups={"data": object(), "model": object()})
        monkeypatch.setattr(trainer_mod, "replicate", lambda tree, m: tree)  # no group to call
        tr = Trainer(_model(), [], [], CombinedLoss(LossConfig(**LOSS), device="cpu"),
                     TrainerConfig(mesh_axes=axes, mesh_shape=(1, 2), gan_weight=0.1,
                                   checkpoint_dir=str(tmp_path)),
                     device="cpu", discriminator=_disc(), mesh=mesh)
        assert tr.use_gan and tr._gan_step.model_shard.size == 2 and tr._batch_divisor == 1
        # rank 0's slices of the convs' output channels; conv_last whole
        assert tr.model.conv_first.weight.shape[0] == _model().conv_first.weight.shape[0] // 2
        assert tr.model.conv_last.weight.shape == _model().conv_last.weight.shape
        return
    if axes == "data,space":  # ported, the GAN stage too: tests/test_torch_sp_gan.py
        mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), world_size=2,
                          axis_names=("data", "space"), shape=(1, 2),
                          axis_groups={"data": object(), "space": object()})
        monkeypatch.setattr(trainer_mod, "replicate", lambda tree, m: tree)  # no group to call
        tr = Trainer(_model(), [], [], CombinedLoss(LossConfig(**LOSS), device="cpu"),
                     TrainerConfig(mesh_axes=axes, mesh_shape=(1, 2), gan_weight=0.1,
                                   checkpoint_dir=str(tmp_path)),
                     device="cpu", discriminator=_disc(), mesh=mesh)
        assert tr.use_gan and tr._gan_step.row_shard.size == 2
        return
    with pytest.raises(pmesh.NotPorted, match=item.replace(".", r"\.")):
        if where == "trainer":
            Trainer(_model(), [], [], CombinedLoss(LossConfig(**LOSS), device="cpu"),
                    TrainerConfig(mesh_axes=axes, checkpoint_dir=str(tmp_path)),
                    device="cpu", mesh=None)
        else:
            pmesh.get_mesh(["cpu"], axis_names=axes.split(","))


@pytest.mark.parametrize("fn", ["row_sharding", "grid_sharding", "tp_param_shardings",
                                "pp_param_shardings", "make_pp_apply", "mesh_shape"])
def test_unported_mesh_functions_raise_and_name_their_item(fn):
    import facesr_torch.parallel as par

    mesh = pmesh.get_mesh(["cpu", "cpu"])
    if fn in ("row_sharding", "grid_sharding"):  # ported: tests/test_torch_sp.py
        grid = pmesh.get_mesh(["cpu"] * 4, axis_names=("data", "space"), shape=(2, 2))
        want = (None, "data") if fn == "row_sharding" else ("data", "space")
        assert getattr(par, fn)(grid).spec == want
        return
    if fn == "tp_param_shardings":  # ported: tests/test_torch_tp.py holds it to JAX's
        grid = pmesh.get_mesh(["cpu"] * 4, axis_names=("data", "model"), shape=(2, 2))
        specs = par.tp_param_shardings(_model(), grid)
        assert specs["params/conv_first.weight"].spec == ("model", None, None, None)
        assert specs["params/conv_last.weight"].spec == ()
        return
    with pytest.raises(pmesh.NotPorted, match=r"ROADMAP A\.13\.[2-5]"):
        if fn == "mesh_shape":  # a shape of three axes: the compositions, A.13.5
            pmesh.get_mesh(["cpu"] * 8, axis_names=("data", "space", "model"), shape=(2, 2, 2))
        elif fn in ("pp_param_shardings", "make_pp_apply"):
            getattr(par, fn)()
        else:
            getattr(par, fn)(mesh)


def test_mesh_shards_a_batch_and_keeps_pad_to_multiple():
    from facesr_torch.parallel import serving

    assert serving.pad_to_multiple is pmesh.pad_to_multiple
    x = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    for rank in range(2):
        mesh = pmesh.Mesh((torch.device("cpu"),), group=object(), rank=rank, world_size=2)
        assert np.array_equal(pmesh.shard_batch({"hr": x}, mesh)["hr"], x[rank * 4:rank * 4 + 4])
        assert pmesh.batch_sharding(mesh).spec == ("data",)
        assert pmesh.replicated(mesh).spec == ()
    with pytest.raises(ValueError, match="pad_to_multiple"):
        pmesh.shard_batch(x[:5], mesh)
    padded, n = pmesh.pad_to_multiple(x[:5], 4)
    assert padded.shape == (8, 2) and n == 5 and np.array_equal(padded[7], x[4])
    assert pmesh.get_mesh(["cpu", "cpu"]).size == 2
    assert not pmesh.get_mesh(["cpu"]).distributed


@pytest.mark.parametrize("devices,local_rank,want", [(["cuda"], 1, "cuda:1"),
                                                     ([torch.device("cuda")], 3, "cuda:3"),
                                                     (["cuda:0"], 1, "cuda:0"),
                                                     (["cpu"], 1, "cpu")])
def test_a_ranks_device_maps_an_index_less_cuda_to_its_local_card(devices, local_rank, want):
    assert pmesh._rank_device(devices, local_rank) == torch.device(want)


@pytest.mark.parametrize("batch,world,rows,warning", [(48, 2, 24, None), (9, 2, 4, "trimmed to 8"),
                                                      (1, 2, 1, "padded")])
def test_local_batch_size_follows_the_jax_trim_or_pad_rule(batch, world, rows, warning, capsys):
    from facesr_torch.training.trainer import local_batch_size

    assert local_batch_size(batch, world) == rows
    out = capsys.readouterr().out
    assert (warning in out) if warning else out == ""


def _failing_rank(mesh):
    if mesh.rank == 1:
        raise RuntimeError("planted failure on rank 1")
    import torch.distributed as dist

    dist.barrier()  # would wait for rank 1 for ever without the timeout
    return mesh.rank


def test_a_failing_rank_fails_the_launch_instead_of_hanging_it():
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        launch.run_ranks(_failing_rank, WORLD, devices=["cpu"] * WORLD, timeout=30,
                         run_timeout=60)


def test_overfit_test_over_two_ranks_pads_like_jax_and_follows_the_single_process(dp_ranks):
    """7 crops pad by repetition to 8 (4 a rank), as the JAX harness pads to
    its devices; the ranks' mean MSE and averaged gradients are then the
    single process's on the padded 8."""
    from facesr_torch.parallel.mesh import pad_to_multiple
    from facesr_torch.training.trainer import overfit_test

    ranks, _ = dp_ranks
    model = _model()
    padded = pad_to_multiple(_hr(60, n=7), WORLD)[0]
    want = overfit_test(model, [{"hr": padded}], num_images=8, num_iterations=3,
                        learning_rate=1e-3, device="cpu")
    for r in ranks:
        np.testing.assert_allclose(r["overfit"]["losses"], want["loss_history"], rtol=1e-5)
        for k, p in model.named_parameters():
            assert _rel_l2(r["overfit"]["params"][k], p.detach().numpy()) <= 1e-5, k
    assert all(np.array_equal(ranks[0]["overfit"]["params"][k], ranks[1]["overfit"]["params"][k])
               for k in ranks[0]["overfit"]["params"])


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i])}


@pytest.mark.parametrize("n,batch", [(23, 4), (24, 3)])
def test_each_rank_loads_its_contiguous_slice_of_the_shared_order_like_jaxs_host_shard(
        n, batch):
    from facesr.data.loader import host_shard as jax_host_shard
    from facesr_torch.data.fast_loader import FastHRLoader
    from facesr_torch.data.loader import DataLoader

    seen, lengths = [], set()
    for rank in range(WORLD):
        loader = DataLoader(_Indices(n), batch_size=batch, shuffle=True, drop_last=True,
                            num_workers=0, seed=5, process_index=rank, process_count=WORLD)
        fast = FastHRLoader(_Indices(n), batch_size=batch, seed=5, process_index=rank,
                            process_count=WORLD)
        lengths |= {len(loader), len(fast)}
        for epoch in range(2):
            order = np.arange(n)
            np.random.default_rng(5 + epoch).shuffle(order)
            mine = jax_host_shard(order, rank, WORLD)
            got = np.concatenate([b["i"][:, 0] for b in loader])
            per = len(mine) - len(mine) % batch
            assert np.array_equal(got, mine[:per])
            seen.append(set(got))
    assert len(lengths) == 1  # equal step counts on every rank
    assert not seen[0] & seen[2] and not seen[1] & seen[3]  # disjoint rows in an epoch
