"""The port's GAN stage (the discriminator, the GAN losses, the adversarial
train step and the Trainer's GAN branch) against the JAX package's on the
same weights and batches, on the CPU.

Sizes: the discriminator at input 32 with 8 base channels (10 blocks, the
last at 1x1), batches of 4; the generator FaceEnhanceNet G=2, B=2, C=16 at
HR 32 with every leaf perturbed off its init and conv_last redrawn
non-zero, as in tests/test_torch_training.py.

Tolerances (float32 unless stated; "normwise" is max|a - b| <= tol *
max|b| per tensor):
- discriminator f32 logits and BN running stats: atol 1e-5 + rtol 1e-4
  (other conv summation orders through 10 layers and 2 dense ones);
- discriminator bf16 logits: normwise 0.05 (both frameworks round every
  conv and dense output to bf16, in other summation orders);
  the BN stats, which both take in f32 from bf16 conv outputs, normwise
  0.02;
- GAN losses: rtol 1e-6 (the same f32 expressions);
- three GAN steps (batch 8, lr 1e-4 for G and D): losses and D scores
  each step rtol 1e-4; params, both optimisers' moments, the EMA and the
  BN stats by relative L2 <= 2e-2 (`STEP_RTOL`, where the measured values
  are given); the NaN step's skipped params, moments and stats bitwise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facesr.losses import combined as jcombined
from facesr.losses import gan as jgan
from facesr.models import discriminator as jdisc
from facesr.models import face_enhance_net as fen
from facesr.training import steps as jsteps
from facesr_torch.ckpt.weights import (discriminator_state_dict_from_jax,
                                       state_dict_from_jax_params, vgg_params_from_jax)
from facesr_torch.losses import gan as tgan
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models import discriminator as tdisc
from facesr_torch.models import face_enhance_net as tfen
from facesr_torch.training import optim, steps

torch.set_num_threads(1)

D_SIZE, D_BASE = 32, 8


def _jax_disc(seed=0, use_bn=True):
    """A JAX discriminator (config, params, stats as numpy), every leaf
    moved off its init (running stats too, so eval mode reads them)."""
    cfg, params, stats = jdisc.create_discriminator(input_size=D_SIZE, base_channels=D_BASE,
                                                    use_bn=use_bn, seed=seed)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.05).astype(np.float32),
        params)
    stats = jax.tree.map(
        lambda a: (np.asarray(a) + rng.random(a.shape) * 0.1).astype(np.float32), stats)
    return cfg, params, stats


def _port_disc(params, stats, use_bn=True):
    d = tdisc.create_discriminator(input_size=D_SIZE, base_channels=D_BASE, use_bn=use_bn,
                                   device="cpu")
    d.load_state_dict(discriminator_state_dict_from_jax(params, stats), strict=True)
    return d


def _images(seed, n=4, size=D_SIZE):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _stats_of(d):
    return {k: v.detach().numpy() for k, v in d.named_buffers()}


def _jax_stats_sd(params, stats):
    sd = discriminator_state_dict_from_jax(params, jax.tree.map(np.asarray, stats))
    return {k: v.numpy() for k, v in sd.items() if "running" in k}


# ---------------------------------------------------------------------------
# the discriminator


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("use_bn", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_discriminator_forward_and_bn_stats_match_jax(train, use_bn, dtype):
    cfg, params, stats = _jax_disc(seed=1, use_bn=use_bn)
    x = _images(2)
    jdt, tdt = (None, None) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want, new_stats = jdisc.apply(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, stats), jnp.asarray(x), cfg,
                                  train=train, dtype=jdt)
    d = _port_disc(params, stats, use_bn=use_bn)
    with torch.no_grad():
        got = d(torch.from_numpy(x), train=train, dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (4, 1)
    want = np.asarray(want)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    else:
        assert _normwise(got.numpy(), want) <= 0.05
    want_stats = _jax_stats_sd(params, new_stats)
    got_stats = _stats_of(d)
    assert set(got_stats) == set(want_stats) and (len(got_stats) > 0) == use_bn
    for k, v in want_stats.items():
        if dtype == "f32":
            np.testing.assert_allclose(got_stats[k], v, atol=1e-5, rtol=1e-4, err_msg=k)
        else:
            assert _normwise(got_stats[k], v) <= 0.02, k
    if not train:  # eval mode leaves the running stats alone
        for k, v in _jax_stats_sd(params, stats).items():
            assert np.array_equal(got_stats[k], v), k


def test_discriminator_input_size_and_unknown_kwargs_raise():
    with pytest.raises(ValueError, match="multiple of 32"):
        tdisc.create_discriminator(input_size=48, device="cpu")
    with pytest.raises(ValueError, match="multiple of 32"):
        jdisc.create_discriminator(input_size=48)
    with pytest.raises(TypeError, match="unknown argument"):
        tdisc.create_discriminator(input_size=32, base_channel=8, device="cpu")
    with pytest.raises(TypeError, match="unknown argument"):
        jdisc.create_discriminator(input_size=32, base_channel=8)


def test_discriminator_param_count_and_info_match_jax_at_production_size():
    shapes = jax.eval_shape(lambda k: jdisc.init(k, jdisc.DiscriminatorConfig())[0],
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    d = tdisc.create_discriminator(device="cpu")
    assert tdisc.param_count(d) == want == 42_964_353
    info = d.get_model_info()
    assert info["total_params"] == want and info["name"] == "VGGStyleDiscriminator"
    # the state dict's keys: every JAX leaf, and the running stats of the 9
    # BatchNorm blocks
    assert len(list(d.buffers())) == 18


def test_discriminator_init_statistics_follow_kaiming_fan_in():
    d = tdisc.create_discriminator(input_size=D_SIZE, base_channels=D_BASE, seed=3,
                                   device="cpu")
    w = d.blocks[4].conv.weight  # 16 -> 32 channels, 3x3: fan_in 144
    want_std = math.sqrt(2.0 / (1 + 0.2 ** 2)) / math.sqrt(16 * 9)
    assert abs(w.std().item() / want_std - 1) < 0.1
    assert d.blocks[0].conv.bias is not None and d.blocks[1].conv.bias is None
    again = tdisc.create_discriminator(input_size=D_SIZE, base_channels=D_BASE, seed=3,
                                       device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(d.state_dict().values(),
                                                  again.state_dict().values()))


# ---------------------------------------------------------------------------
# the GAN losses


@pytest.mark.parametrize("gan_type", ["vanilla", "lsgan", "wgan"])
def test_gan_loss_matches_jax(gan_type):
    logits = np.random.default_rng(4).normal(0, 3, (8, 1)).astype(np.float32)
    for is_real in (True, False):
        want = float(jgan.gan_loss(jnp.asarray(logits), is_real, gan_type))
        got = tgan.gan_loss(torch.from_numpy(logits), is_real, gan_type).item()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tgan.GAN_TYPES == jgan.GAN_TYPES
    with pytest.raises(ValueError, match="Unknown GAN type"):
        tgan.gan_loss(torch.from_numpy(logits), True, "hinge")


# ---------------------------------------------------------------------------
# three GAN steps against the JAX package's make_gan_train_step

G, B, C = 2, 2, 16
HR = D_SIZE
# relative L2 of the port's state after three steps against JAX's, over
# every tensor together: of the params, over their three-step update (lr
# 1e-4: Adam moves an element with a gradient near rounding noise by ~lr
# either way, and a few such elements move D and then G); of the moments
# and BN stats, over their values. Measured <= 6.7e-3 (G's moments with
# two D updates a step), <= 2.5e-4 in the other cases.
STEP_RTOL = 2e-2


def _g_params(seed):
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32), params)
    params["conv_last"]["w"] = (rng.standard_normal(params["conv_last"]["w"].shape)
                                * 0.05).astype(np.float32)
    return cfg, params


def _hr(seed, n=8, size=HR):
    """Smooth HR images in [0, 1]."""
    rng = np.random.default_rng(seed)
    lo = rng.random((n, size // 4, size // 4, 3), dtype=np.float32)
    return np.clip(np.kron(lo, np.ones((1, 4, 4, 1), np.float32))
                   + rng.normal(0, 0.02, (n, size, size, 3)), 0, 1).astype(np.float32)


def _adam_state(tree):
    if isinstance(tree, optax.ScaleByAdamState):
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _adam_state(t)
            if found is not None:
                return found
    return None


def _d_sd(tree, stats):
    """A JAX D params-shaped tree (params, mu or nu) as port names, params only."""
    sd = discriminator_state_dict_from_jax(jax.tree.map(np.asarray, tree),
                                           jax.tree.map(np.asarray, stats))
    return {k: v for k, v in sd.items() if "running" not in k}


def _g_sd(tree):
    return state_dict_from_jax_params(jax.tree.map(np.asarray, tree))


def _rel_l2(got, want, base=None):
    """||got - want|| / ||want - base|| over every tensor of two same-keyed
    dicts together (``base`` None: / ||want||)."""
    num = sum(float(((got[k].detach().double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float(((want[k].double() - (0 if base is None else base[k].double())) ** 2).sum())
              for k in want)
    assert set(got) == set(want)
    return math.sqrt(num / max(den, 1e-300))


GAN_CASES = {
    "plain": dict(),
    "d_updates_2": dict(d_updates_per_g=2),
    "lsgan": dict(gan_type="lsgan"),
    "skip_nan": dict(skip_nonfinite=1),
    "ema": dict(ema_decay=0.9),
}


@pytest.mark.parametrize("case", sorted(GAN_CASES))
def test_three_gan_steps_match_jax(case):
    kw = dict(gan_type="vanilla", d_updates_per_g=1, skip_nonfinite=0, ema_decay=0.0)
    kw.update(GAN_CASES[case])
    lr, d_lr, gan_weight = 1e-4, 1e-4, 0.5
    batches = [_hr(30), _hr(31), _hr(32)]
    if case == "skip_nan":
        batches[1] = batches[1].copy()
        batches[1][0, 3, 5, 1] = np.nan
    cfg, params = _g_params(seed=9)
    dcfg, dparams, dstats = _jax_disc(seed=10)
    loss_cfg = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.0)
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**loss_cfg), seed=0)
    jlp = jax.tree.map(np.asarray, jloss.params)
    tloss = CombinedLoss(LossConfig(**loss_cfg), device="cpu")

    skip = kw["skip_nonfinite"]
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=1e3, skip_nonfinite=skip)
    tx_d = jsteps.make_optimizer(weight_decay=1e-3, gradient_clip=0.0, skip_nonfinite=skip)
    jp, jdp = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, dparams)
    jstate = jsteps.TrainState(
        step=jnp.asarray(0), params=jp,
        opt_state=jsteps.set_learning_rate(tx.init(jp), lr), loss_params=jlp,
        d_params=jdp, d_stats=jax.tree.map(jnp.asarray, dstats),
        d_opt_state=jsteps.set_learning_rate(tx_d.init(jdp), d_lr),
        ema_params=jsteps.init_ema(jp) if kw["ema_decay"] else None)
    jstep = jax.jit(jsteps.make_gan_train_step(
        lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype),
        lambda lp, p, t: jloss.apply(lp, p, t),
        lambda p, s, x, train: jdisc.apply(p, s, x, dcfg, train=train),
        tx, tx_d, gan_weight=gan_weight, gan_type=kw["gan_type"],
        d_updates_per_g=kw["d_updates_per_g"], ema_decay=kw["ema_decay"],
        guard_stats=skip > 0))

    model = tfen.FaceEnhanceNet(tfen.FaceEnhanceNetConfig(
        num_channels=C, num_groups=G, blocks_per_group=B), device="cpu")
    model.load_state_dict(_g_sd(params), strict=True)
    disc = _port_disc(dparams, dstats)
    opt = optim.AdamW(weight_decay=1e-2, gradient_clip=1e3, skip_nonfinite=skip)
    d_opt = optim.AdamW(weight_decay=1e-3, gradient_clip=0.0, skip_nonfinite=skip)
    tstate = steps.TrainState(
        model=model, opt_state=opt.init(dict(model.named_parameters()), lr),
        loss_params=tloss.params, disc=disc,
        d_opt_state=d_opt.init(dict(disc.named_parameters()), d_lr),
        ema_params=steps.init_ema(model) if kw["ema_decay"] else None)
    tstep = steps.make_gan_train_step(
        lambda lp, p, t: tloss.apply(lp, p, t), opt, d_opt, gan_weight=gan_weight,
        gan_type=kw["gan_type"], d_updates_per_g=kw["d_updates_per_g"],
        ema_decay=kw["ema_decay"], guard_stats=skip > 0)

    g_init = {k: v.clone() for k, v in model.state_dict().items()}
    d_init = {k: v.clone() for k, v in disc.state_dict().items() if "running" not in k}
    for i, hr in enumerate(batches):
        before = {k: v.clone() for k, v in list(model.state_dict().items())
                  + [(f"D.{k}", v) for k, v in disc.state_dict().items()]}
        moments = {k: v.clone() for k, v in tstate.d_opt_state["mu"].items()}
        jax_stats_before = _jax_stats_sd(dparams, jstate.d_stats)
        jstate, jm = jstep(jstate, hr)
        tstate, tm = tstep(tstate, torch.from_numpy(hr))
        keys = {"l1", "total", "g_adv", "loss", "d_loss", "d_real", "d_fake"} | (
            {"opt_notfinite", "d_opt_notfinite"} if skip else set())
        assert set(tm) == set(jm) == keys
        if case == "skip_nan" and i == 1:
            assert not math.isfinite(float(jm["loss"])) and not torch.isfinite(tm["loss"])
            assert int(jm["opt_notfinite"]) == int(tm["opt_notfinite"]) == 1
            assert int(jm["d_opt_notfinite"]) == int(tm["d_opt_notfinite"]) == 1
            after = list(model.state_dict().items()) + [
                (f"D.{k}", v) for k, v in disc.state_dict().items()]
            for k, v in after:  # params and BN stats
                assert torch.equal(v, before[k]), f"the skipped step moved {k}"
            for k, v in tstate.d_opt_state["mu"].items():
                assert torch.equal(v, moments[k]), k
            for k, v in _jax_stats_sd(dparams, jstate.d_stats).items():  # JAX's too
                assert np.array_equal(v, jax_stats_before[k]), k
            continue
        for k in keys:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {k}")

    assert tstate.step == 3
    g_sd = {k: v for k, v in model.state_dict().items()}
    d_sd = {k: v for k, v in disc.state_dict().items() if "running" not in k}
    errs = {"G": _rel_l2(g_sd, _g_sd(jstate.params), g_init),
            "D": _rel_l2(d_sd, _d_sd(jstate.d_params, jstate.d_stats), d_init),
            "BN stats": _rel_l2(_stats_of_t(disc), {k: torch.from_numpy(v) for k, v in
                                 _jax_stats_sd(dparams, jstate.d_stats).items()})}
    for name, st, jst, to_sd in (("G", tstate.opt_state, jstate.opt_state, _g_sd),
                                 ("D", tstate.d_opt_state, jstate.d_opt_state,
                                  lambda t: _d_sd(t, jstate.d_stats))):
        adam = _adam_state(jst.inner_state if skip else jst)
        assert int(st["count"]) == int(adam.count) == (2 if skip else 3) * (
            kw["d_updates_per_g"] if name == "D" else 1)
        errs[f"{name} mu"] = _rel_l2(st["mu"], to_sd(adam.mu))
        errs[f"{name} nu"] = _rel_l2(st["nu"], to_sd(adam.nu))
    if kw["ema_decay"]:
        errs["EMA"] = _rel_l2(tstate.ema_params, _g_sd(jstate.ema_params), g_init)
    print(case, {k: f"{v:.3g}" for k, v in errs.items()})
    assert max(errs.values()) <= STEP_RTOL, errs


def _stats_of_t(d):
    return {k: v.detach() for k, v in d.named_buffers()}


def test_the_g_head_leaves_no_gradient_and_no_update_on_d():
    _, params = _g_params(seed=11)
    _, dparams, dstats = _jax_disc(seed=12)
    model = tfen.FaceEnhanceNet(tfen.FaceEnhanceNetConfig(
        num_channels=C, num_groups=G, blocks_per_group=B), device="cpu")
    model.load_state_dict(_g_sd(params), strict=True)
    disc = _port_disc(dparams, dstats)
    opt, d_opt = optim.AdamW(gradient_clip=0.0), optim.AdamW(gradient_clip=0.0)
    state = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), 1e-3),
                             loss_params={}, disc=disc,
                             d_opt_state=d_opt.init(dict(disc.named_parameters()), 0.0))
    step = steps.make_gan_train_step(lambda lp, p, t: ((p - t).abs().mean(), {}), opt, d_opt,
                                     gan_weight=1.0)
    before = {k: v.clone() for k, v in disc.named_parameters()}
    _, m = step(state, torch.from_numpy(_hr(33)))
    # D's learning rate 0: its one update moved nothing; the G head added none
    assert all(p.grad is None for p in list(disc.parameters()) + list(model.parameters()))
    assert all(torch.equal(v, before[k]) for k, v in disc.named_parameters())
    assert int(state.d_opt_state["count"]) == 1 and int(state.opt_state["count"]) == 1
    assert m["g_adv"] > 0 and 0 < m["d_real"] < 1 and 0 < m["d_fake"] < 1


# ---------------------------------------------------------------------------
# the Trainer's GAN branch


def _loader(n_batches, seed):
    return [{"hr": _hr(seed + i)} for i in range(n_batches)]


def _trainer_cfg(tmp_path, mod, **kw):
    base = dict(epochs=2, learning_rate=1e-4, weight_decay=0.0, gradient_clip=0.5,
                use_amp=False, scheduler_type="step", scheduler_step_size=10,
                scheduler_gamma=1.0, save_every=1, checkpoint_dir=str(tmp_path),
                early_stopping_metric="val_loss", early_stopping_mode="min",
                step_log_every=0, gan_weight=0.5, d_learning_rate=1e-4, gan_start_epoch=1)
    if mod == "jax":
        base.update(use_wandb=False, log_dir=str(tmp_path / "logs"))
    base.update(kw)
    return base


def _port_trainer(tmp_path, params, dparams, dstats, gan=True, **kw):
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    model = tfen.FaceEnhanceNet(tfen.FaceEnhanceNetConfig(
        num_channels=C, num_groups=G, blocks_per_group=B), device="cpu")
    model.load_state_dict(_g_sd(params), strict=True)
    cfg = TrainerConfig(**_trainer_cfg(tmp_path, "port", **kw))
    if not gan:
        cfg.gan_weight = 0.0
    loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.0),
                        device="cpu")
    return Trainer(model, _loader(2, 40), _loader(1, 50), loss, cfg, device="cpu",
                   discriminator=_port_disc(dparams, dstats) if gan else None)


def test_gan_trainer_history_follows_the_jax_trainer(tmp_path):
    """Two epochs, the GAN from epoch 1: the GAN series are 0.0 for the
    content epoch and then the GAN step's, index-aligned; every history
    value within rtol 1e-4 of the JAX Trainer's (lr 1e-4, measured
    <= 3e-6)."""
    from facesr.training.trainer import Trainer as JaxTrainer
    from facesr.training.trainer import TrainerConfig as JaxTrainerConfig

    cfg, params = _g_params(seed=13)
    dcfg, dparams, dstats = _jax_disc(seed=14)
    jtr = JaxTrainer(fen.FaceEnhanceNet(cfg, params=jax.tree.map(jnp.asarray, params)),
                     _loader(2, 40), _loader(1, 50),
                     jcombined.CombinedLoss(jcombined.LossConfig(
                         l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.0)),
                     JaxTrainerConfig(**_trainer_cfg(tmp_path / "jax", "jax")),
                     discriminator=(dcfg, jax.tree.map(jnp.asarray, dparams),
                                    jax.tree.map(jnp.asarray, dstats)))
    want = jtr.train()
    tr = _port_trainer(tmp_path / "port", params, dparams, dstats)
    got = tr.train()
    assert set(got) == set(want) == {"train_loss", "val_loss", "val_psnr", "val_ssim",
                                     "learning_rate", "d_loss", "g_loss", "d_real", "d_fake"}
    for k in ("d_loss", "g_loss", "d_real", "d_fake"):
        assert got[k][0] == want[k][0] == 0.0 and got[k][1] != 0.0, k
    worst = max(abs(a - b) / max(abs(b), 1e-12) for k in want for a, b in zip(got[k], want[k]))
    print(f"history: worst relative difference {worst:.3g}")
    for k in want:
        assert len(got[k]) == len(want[k]) == 2, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    ckpt = torch.load(tmp_path / "port" / "final_model.pth", weights_only=True)
    assert ckpt["use_gan"] is True and ckpt["discriminator_config"]["input_size"] == D_SIZE


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_gan_trainer_full_resume_restores_g_d_stats_and_both_optimisers(tmp_path):
    _, params = _g_params(seed=15)
    _, dparams, dstats = _jax_disc(seed=16)
    tr = _port_trainer(tmp_path, params, dparams, dstats, gan_start_epoch=0)
    tr.train()
    assert int(tr.state.d_opt_state["count"]) == 4
    _, other, _ = _jax_disc(seed=17)
    _, gother = _g_params(seed=18)
    resumed = _port_trainer(tmp_path / "b", gother, other, dstats, epochs=3,
                            gan_start_epoch=0)
    resumed.load_checkpoint(str(tmp_path / "final_model.pth"))
    assert _equal(resumed.model.state_dict(), tr.model.state_dict())
    assert _equal(resumed.disc.state_dict(), tr.disc.state_dict())  # params + BN stats
    assert _equal(resumed.state.opt_state, tr.state.opt_state)
    assert _equal(resumed.state.d_opt_state, tr.state.d_opt_state)
    assert resumed.current_epoch == 2 and resumed.training_history == tr.training_history
    resumed.train()
    assert all(len(v) == 3 for v in resumed.training_history.values())
    assert int(resumed.state.d_opt_state["count"]) == 6


def test_a_content_checkpoint_resumed_into_a_gan_trainer_keeps_a_fresh_d(tmp_path, capsys):
    _, params = _g_params(seed=19)
    _, dparams, dstats = _jax_disc(seed=20)
    content = _port_trainer(tmp_path, params, dparams, dstats, gan=False, epochs=1)
    content.train()
    assert "d_loss" not in content.training_history
    assert torch.load(tmp_path / "final_model.pth", weights_only=True)["use_gan"] is False
    gan = _port_trainer(tmp_path / "b", params, dparams, dstats, gan_start_epoch=0)
    fresh_d = {k: v.clone() for k, v in gan.disc.state_dict().items()}
    gan.load_checkpoint(str(tmp_path / "final_model.pth"))
    assert "Checkpoint has no discriminator state; D starts fresh" in capsys.readouterr().out
    assert _equal(gan.model.state_dict(), content.model.state_dict())
    assert _equal(gan.disc.state_dict(), fresh_d)
    assert int(gan.state.d_opt_state["count"]) == 0
    assert {k: len(v) for k, v in gan.training_history.items()} == {
        "train_loss": 1, "val_loss": 1, "val_psnr": 1, "val_ssim": 1, "learning_rate": 1,
        "d_loss": 0, "g_loss": 0, "d_real": 0, "d_fake": 0}
    gan.train()  # epoch 2 of 2: the backfilled series take the GAN epoch
    h = gan.training_history
    assert len(h["train_loss"]) == 2 and len(h["d_loss"]) == 1 and h["d_loss"][0] > 0


def test_gan_trainer_needs_a_discriminator_and_chains_weights_only(tmp_path):
    _, params = _g_params(seed=21)
    _, dparams, dstats = _jax_disc(seed=22)
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    with pytest.raises(ValueError, match="no discriminator"):
        Trainer(tfen.FaceEnhanceNet(tfen.FaceEnhanceNetConfig(
            num_channels=C, num_groups=G, blocks_per_group=B), device="cpu"),
            [], [], CombinedLoss(device="cpu"), TrainerConfig(gan_weight=0.1,
                                                              checkpoint_dir=str(tmp_path)),
            device="cpu")
    tr = _port_trainer(tmp_path, params, dparams, dstats, gan_start_epoch=0, epochs=1)
    tr.train()
    fresh = _port_trainer(tmp_path / "b", params, dparams, dstats)
    before = {k: v.clone() for k, v in fresh.disc.state_dict().items()}
    fresh.load_checkpoint(str(tmp_path / "final_model.pth"), weights_only=True)
    assert _equal(fresh.model.state_dict(), tr.model.state_dict())
    assert _equal(fresh.disc.state_dict(), before) and not _equal(before, tr.disc.state_dict())
    assert int(fresh.state.d_opt_state["count"]) == 0
