"""The port's training path (facesr_torch.training, the trainable forward)
against the JAX package's on the same weights and batches, on the CPU.

The model is FaceEnhanceNet G=2, B=2, C=16 with every leaf perturbed off
its init and conv_last redrawn non-zero: with the zero init every gradient
above conv_last is exactly 0 at the first step, and a test would check
conv_last only. Batches are HR 32x32 from numpy.

Tolerances (float32 unless stated; "normwise" is max|a - b| <= tol *
max|b| per tensor, since elements near 0 carry the other framework's
rounding of the large ones):
- f32 gradients: normwise 1e-4 (other conv summation orders through
  ~30 layers and their transposes; measured <= 1.1e-5).
- bf16 gradients: normwise 0.1. Both frameworks round activations to
  bf16 (8 bits, 2^-8 relative) at every conv, PReLU and SE op, at other
  points, through ~10 layers: the trunk's differ from JAX's by <= 0.044
  and each from the f32 gradient by 0.02-0.04 (three seeds). The JAX
  package reduces the gradients of conv_last's bias and the upsample
  PReLU slopes (sums over every output pixel) in bf16, 26-78% off the f32
  gradient, so every port gradient is also held to the port's f32
  gradient (measured <= 0.062).
- Optimiser state after 3 steps: mu normwise 1e-4, nu 2e-4 (squares of
  the gradients above); params to 5e-6 absolute at lr 1e-3 (an Adam step
  moves an element by up to ~lr, and where |g| is near eps a gradient
  difference moves that by a share of lr; measured <= 2.2e-6); the skip
  test needs the skipped step bitwise.
- Schedules: exact (host float arithmetic on both sides).
- Eval step: loss and PSNR rtol 1e-5, SSIM atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facesr.losses import combined as jcombined
from facesr.models import face_enhance_net as fen
from facesr.ops import bicubic_down as jbicubic_down
from facesr.training import schedules as jsched
from facesr.training import steps as jsteps
from facesr_torch.ckpt.weights import state_dict_from_jax_params, vgg_params_from_jax
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models import blocks
from facesr_torch.models import face_enhance_net as tfen
from facesr_torch.ops import rcab_group as tgroup
from facesr_torch.ops.resize import bicubic_down, bicubic_up
from facesr_torch.training import optim, schedules, steps

torch.set_num_threads(1)

G, B, C = 2, 2, 16


def _params(seed=0):
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32), params)
    params["conv_last"]["w"] = (rng.standard_normal(params["conv_last"]["w"].shape)
                                * 0.05).astype(np.float32)
    return cfg, params


def _port(params, remat="save_ca"):
    model = tfen.FaceEnhanceNet(tfen.FaceEnhanceNetConfig(
        num_channels=C, num_groups=G, blocks_per_group=B, remat=remat), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model


def _hr(seed, n=2, size=32):
    """Smooth HR images in [0, 1] (SR is learnable on them)."""
    rng = np.random.default_rng(seed)
    lo = rng.random((n, size // 4, size // 4, 3), dtype=np.float32)
    return np.clip(np.kron(lo, np.ones((1, 4, 4, 1), np.float32))
                   + rng.normal(0, 0.02, (n, size, size, 3)), 0, 1).astype(np.float32)


def _losses(perceptual_weight=1.0, ssim_weight=0.0):
    cfg = dict(l1_weight=1.0, perceptual_weight=perceptual_weight,
               ssim_weight=ssim_weight, perceptual_layers=["conv3_4"])
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**cfg), seed=0)
    jparams = jax.tree.map(np.asarray, jloss.params)
    vgg = vgg_params_from_jax(jparams["vgg"]) if "vgg" in jparams else None
    return jloss, jparams, CombinedLoss(LossConfig(**cfg), vgg_params=vgg, device="cpu")


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _assert_tree_close(got_sd, jax_tree, tol, what):
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_tree))
    assert set(got_sd) == set(want)
    worst = max((_normwise(got_sd[k].detach().numpy(), want[k].numpy()), k) for k in want)
    assert worst[0] <= tol, f"{what}: normwise {worst[0]:.3g} at {worst[1]}"


def _jax_grads(params, cfg, jloss, jlp, hr, dtype=None):
    def loss_fn(p):
        sr = fen.apply(p, jbicubic_down(hr, 4), cfg, train=True, dtype=dtype)
        return jloss.apply(jlp, sr, hr)[0]
    return jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, params))


def _port_grads(model, tloss, hr, dtype=None):
    x = torch.from_numpy(hr)
    sr = model(bicubic_down(x, 4), train=True, dtype=dtype)
    loss, _ = tloss(sr, x)
    named = dict(model.named_parameters())
    return dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


# ---------------------------------------------------------------------------
# the bf16 repair: training never goes through the forward-only kernel


def test_bf16_train_forward_trains_every_trunk_weight_like_jax():
    cfg, params = _params(seed=1)
    jloss, jlp, tloss = _losses(perceptual_weight=0.0)
    hr = _hr(2)
    model = _port(params)
    before = tgroup.fused_residual_group.launches
    grads = _port_grads(model, tloss, hr, dtype=torch.bfloat16)
    assert tgroup.fused_residual_group.launches == before
    trunk = [n for n in grads if n.startswith("residual_groups.")]
    assert len(trunk) == G * (B * 7 + 2)
    assert all(grads[n].abs().max() > 0 for n in trunk), "a trunk weight got no gradient"
    want = state_dict_from_jax_params(jax.tree.map(
        np.asarray, _jax_grads(params, cfg, jloss, jlp, hr, dtype=jnp.bfloat16)))
    f32 = _port_grads(_port(params), tloss, hr)
    for n, g in grads.items():
        assert _normwise(g.numpy(), f32[n].numpy()) <= 0.1, n
        if n in trunk:
            assert _normwise(g.numpy(), want[n].numpy()) <= 0.1, n


def test_fused_residual_group_refuses_to_drop_a_gradient():
    gen = torch.Generator().manual_seed(0)
    gw = tgroup.prepare_group_weights(blocks.make_residual_groups(1, 1, C, 3, 4, gen)[0])
    x = torch.rand(1, 8, 8, C, generator=gen).to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tgroup.fused_residual_group(x, gw)
    with torch.no_grad():
        assert tgroup.fused_residual_group(x, gw).shape == x.shape
    # an eval forward in bf16 with trainable weights of a config the kernel
    # takes (C = 64) is refused the same way
    model = tfen.FaceEnhanceNet(tfen.FaceEnhanceNetConfig(
        num_channels=tgroup.KERNEL_CHANNELS, num_groups=1, blocks_per_group=1), device="cpu")
    with pytest.raises(RuntimeError, match="forward-only"):
        model(torch.from_numpy(_hr(3)[:, ::4, ::4]), dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# f32 gradients and the remat modes


def test_f32_grads_match_jax_grad():
    cfg, params = _params(seed=3)
    jloss, jlp, tloss = _losses()
    hr = _hr(4)
    grads = _port_grads(_port(params), tloss, hr)
    _assert_tree_close(grads, _jax_grads(params, cfg, jloss, jlp, hr), 1e-4, "f32 grads")


@pytest.mark.parametrize("remat", ["rcab", "save_ca", "save_convs"])
def test_remat_modes_give_the_grads_of_no_remat(remat):
    _, params = _params(seed=5)
    _, _, tloss = _losses(perceptual_weight=0.0, ssim_weight=0.1)
    hr = _hr(6)
    want = _port_grads(_port(params, remat="none"), tloss, hr)
    got = _port_grads(_port(params, remat=remat), tloss, hr)
    for k in want:  # the same ops on the same values: bitwise
        assert torch.equal(got[k], want[k]), k


def test_unknown_remat_mode_raises():
    _, params = _params(seed=7)
    model = _port(params, remat="all")
    with pytest.raises(ValueError, match="remat"):
        model(torch.rand(1, 8, 8, 3), train=True)


# ---------------------------------------------------------------------------
# the optimiser: three steps of make_train_step against the JAX step


def _adam_state(tree):
    if isinstance(tree, optax.ScaleByAdamState):
        return tree
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _adam_state(t)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("case", ["clip", "accumulate", "skip_nan", "ema"])
def test_three_steps_match_jax_train_step(case):
    kw = dict(weight_decay=1e-2, gradient_clip=1e3, accumulation_steps=1,
              skip_nonfinite=0)
    ema_decay = 0.0
    batches = [_hr(10), _hr(11), _hr(12)]
    if case == "clip":
        kw["gradient_clip"] = 1e-3
    elif case == "accumulate":
        kw["accumulation_steps"] = 2
    elif case == "skip_nan":
        kw["skip_nonfinite"] = 1
        batches[1] = batches[1].copy()
        batches[1][0, 3, 5, 1] = np.nan
    else:
        ema_decay = 0.9
    lr = 1e-3
    cfg, params = _params(seed=8)
    jloss, jlp, tloss = _losses(perceptual_weight=0.0)

    tx = jsteps.make_optimizer(**kw)
    jstate = jsteps.TrainState(
        step=jnp.asarray(0), params=jax.tree.map(jnp.asarray, params),
        opt_state=jsteps.set_learning_rate(tx.init(params), lr), loss_params=jlp,
        ema_params=jsteps.init_ema(params) if ema_decay else None)
    jstep = jax.jit(jsteps.make_train_step(
        lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype),
        lambda lp, p, t: jloss.apply(lp, p, t), tx, ema_decay=ema_decay))

    model = _port(params)
    opt = optim.AdamW(**kw)
    tstate = steps.TrainState(
        model=model, opt_state=opt.init(dict(model.named_parameters()), lr),
        loss_params=tloss.params, ema_params=steps.init_ema(model) if ema_decay else None)
    tstep = steps.make_train_step(lambda lp, p, t: tloss.apply(lp, p, t), opt,
                                  ema_decay=ema_decay)

    if case == "clip":  # the clip is active at the first step
        g0 = _port_grads(_port(params), tloss, batches[0])
        assert torch.sqrt(sum((g * g).sum() for g in g0.values())) > kw["gradient_clip"]
    for i, hr in enumerate(batches):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        jstate, jm = jstep(jstate, hr)
        tstate, tm = tstep(tstate, torch.from_numpy(hr))
        if case == "skip_nan" and i == 1:
            assert not np.isfinite(float(jm["loss"])) and not torch.isfinite(tm["loss"])
            assert int(jm["opt_notfinite"]) == 1 and int(tm["opt_notfinite"]) == 1
            for k, v in model.state_dict().items():
                assert torch.equal(v, before[k]), f"skipped step moved {k}"
        else:
            np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)

    adam = _adam_state(jstate.opt_state)
    st = tstate.opt_state
    assert int(st["count"]) == int(adam.count) == (1 if case == "accumulate" else
                                                  2 if case == "skip_nan" else 3)
    _assert_tree_close(st["mu"], adam.mu, 1e-4, "mu")
    _assert_tree_close(st["nu"], adam.nu, 2e-4, "nu")
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=5e-6, rtol=0,
                                   err_msg=k)
    if case == "accumulate":
        assert int(st["mini_step"]) == 1 and int(st["gradient_step"]) == 1
    if ema_decay:
        wema = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.ema_params))
        for k, v in tstate.ema_params.items():
            np.testing.assert_allclose(v.numpy(), wema[k].numpy(), atol=5e-6, err_msg=k)


def test_clip_follows_optax_not_clip_grad_norm():
    """optax scales by max_norm / norm, and only when norm >= max_norm."""
    p = {"w": torch.zeros(4)}
    g = {"w": torch.tensor([3.0, 4.0, 0.0, 0.0])}  # norm 5
    for clip, want in ((5.0, g["w"]), (6.0, g["w"]), (2.5, g["w"] / 2)):
        opt = optim.AdamW(weight_decay=0.0, gradient_clip=clip)
        st = opt.init(p, 1.0)
        opt.update(g, st, {"w": torch.zeros(4)})
        assert torch.equal(st["mu"]["w"], (1 - 0.9) * want)


def test_set_learning_rate_writes_the_state():
    p = {"w": torch.ones(3)}
    opt = optim.AdamW(weight_decay=0.0, gradient_clip=0.0)
    st = opt.init(p, 0.0)
    opt.update({"w": torch.ones(3)}, st, p)
    assert torch.equal(p["w"], torch.ones(3))  # lr 0: no move
    optim.set_learning_rate(st, 0.5)
    opt.update({"w": torch.ones(3)}, st, p)
    assert torch.allclose(p["w"], torch.full((3,), 0.5))


# ---------------------------------------------------------------------------
# schedules and the eval step


def test_schedules_match_jax_exactly():
    for e in range(0, 120, 7):
        assert schedules.cosine_annealing(1e-4, e, 100, 1e-7) == \
            jsched.cosine_annealing(1e-4, e, 100, 1e-7)
        assert schedules.step_lr(2e-4, e, 10, 0.5) == jsched.step_lr(2e-4, e, 10, 0.5)
        for kind in ("cosine", "step", "none"):
            assert schedules.compute_lr(kind, 1e-4, e, T_max=100) == \
                jsched.compute_lr(kind, 1e-4, e, T_max=100)
    metrics = [30.0, 31.0, 31.001, 31.0, 30.5, 30.9, 31.0, 30.2, 30.0, 31.5, 29.0,
               29.5, 29.9, 30.0, 30.1, 30.2, 30.3]
    for mode in ("max", "min"):
        tp = schedules.ReduceLROnPlateau(1e-3, mode=mode, patience=2)
        jp = jsched.ReduceLROnPlateau(1e-3, mode=mode, patience=2)
        lrs = [(tp.step(m), jp.step(m)) for m in metrics]
        assert all(a == b for a, b in lrs) and tp.state_dict() == jp.state_dict()
        assert lrs[-1][0] < 1e-3  # it did reduce
        assert schedules.compute_lr("plateau", 1e-3, 5, plateau=tp) == \
            jsched.compute_lr("plateau", 1e-3, 5, plateau=jp)
    restored = schedules.ReduceLROnPlateau(1.0)
    restored.load_state_dict(tp.state_dict())
    assert restored.state_dict() == tp.state_dict()


def test_eval_step_matches_jax():
    cfg, params = _params(seed=13)
    jloss, jlp, tloss = _losses(ssim_weight=0.2)
    hr = _hr(14)
    jstate = jsteps.TrainState(step=jnp.asarray(0), params=params, opt_state=None,
                               loss_params=jlp)
    want, _, _ = jsteps.make_eval_step(
        lambda p, x, train, dtype: fen.apply(p, x, cfg, train=train, dtype=dtype),
        lambda lp, p, t: jloss.apply(lp, p, t))(jstate, hr)
    model = _port(params)
    tstate = steps.TrainState(model=model, opt_state={}, loss_params=tloss.params)
    eval_step = steps.make_eval_step(lambda lp, p, t: tloss.apply(lp, p, t))
    got, sr, lr_img = eval_step(tstate, torch.from_numpy(hr))
    assert sr.shape == hr.shape and lr_img.shape == (2, 8, 8, 3)
    assert sr.min() >= 0 and sr.max() <= 1
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["psnr"].item(), float(want["psnr"]), rtol=1e-5)
    np.testing.assert_allclose(got["ssim"].item(), float(want["ssim"]), atol=1e-6)

    ema_step = steps.make_eval_step(lambda lp, p, t: tloss.apply(lp, p, t), use_ema=True)
    with pytest.raises(ValueError, match="EMA"):
        ema_step(tstate, torch.from_numpy(hr))
    tstate.ema_params = {k: v * 0 for k, v in steps.init_ema(model).items()}
    ema_metrics, ema_sr, _ = ema_step(tstate, torch.from_numpy(hr))
    # zero weights: the EMA forward is the clamped bicubic skip
    assert torch.allclose(ema_sr, bicubic_up(lr_img, 4).clamp(0, 1))
