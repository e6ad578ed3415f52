"""The port's quantization-aware training (the fake-quant conv of
facesr_torch.ops.conv, ops.quant.fake_quant_params, the Trainer's ``qat``
and ``qat_scales``) against the JAX package's, on the CPU; the Trainer's
contract mirrors tests/test_qat.py.

Tolerances (float32):
- the fake-quant conv forward: atol 1e-5 (both convolve the same snapped
  values; only the f32 summation order differs, measured <= 1.2e-6).
- its STE gradients (weight, input, bias) against ``jax.grad``: normwise
  1e-5 (max |a - b| over max |b|; measured <= 4e-7). Both packages clip
  with max then min, which pass half the gradient at a tie, so the
  element at a channel's max |w| (exactly +-127 on the grid) gets half in
  both.
- one QAT train step (model G=2, B=2, C=16, L1 loss, AdamW at lr 1e-3):
  the loss rtol 1e-5; the step's gradients against ``jax.grad`` of the
  fake-quant loss, normwise 1e-5 per tensor (max |a - b| over max |b|;
  measured <= 7.2e-7, and 5.7e-6 for conv_last's bias, a sum of L1 signs
  that nearly cancel); the parameters after the step atol 5e-6 (as the
  float step test: an Adam step moves an element by up to lr, so those
  check the gradients' signs, and the gradient check their sizes).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from facesr.losses import combined as jcombined
from facesr.models import face_enhance_net as fen
from facesr.ops import conv as jconv
from facesr.ops import quant as jquant
from facesr.training import steps as jsteps
from facesr_torch.ckpt.weights import state_dict_from_jax_params
from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models import face_enhance_net as tfen
from facesr_torch.ops import conv as tconv
from facesr_torch.ops import quant as tquant
from facesr_torch.parallel import serving as tserving
from facesr_torch.training import optim, steps
from facesr_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

SMALL = dict(num_channels=16, num_groups=2, blocks_per_group=2)
GRAD_TOL = 1e-5  # a QAT step's gradients, normwise per tensor (see the docstring)


def _params(seed=0):
    cfg = fen.FaceEnhanceNetConfig(**SMALL)
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32), params)
    params["conv_last"]["w"] = (rng.standard_normal(params["conv_last"]["w"].shape)
                                * 0.05).astype(np.float32)
    return cfg, params


def _port(params):
    model = tfen.FaceEnhanceNet(tfen.FaceEnhanceNetConfig(**SMALL), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model


def _normwise(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


# ---------------------------------------------------------------------------
# the fake-quant conv


@pytest.mark.parametrize("static", [False, True])
def test_fake_quant_conv_and_its_ste_gradients_match_jax(static):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 12)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(12) * 0.1).astype(np.float32)
    cot = rng.standard_normal((2, 8, 8, 12)).astype(np.float32)
    a = np.float32(0.01) if static else None  # static: saturates part of x

    def jloss(x_, w_, b_):
        wd = {"fq": w_}
        if static:
            wd["a"] = jnp.full((1, 1, 1, 1), a, jnp.float32)
        return (jconv.conv2d(x_, wd, b_) * cot).sum(), jconv.conv2d(x_, wd, b_)

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))

    tx, tw, tb = (torch.from_numpy(x).requires_grad_(), _oihw(w).requires_grad_(),
                  torch.from_numpy(b).requires_grad_())
    fq = tquant.FakeQuantWeight(tw, None if a is None else torch.tensor(a))
    tout = tconv.conv2d(tx, fq, tb)
    (tout * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-5)
    gx, gw, gb = (np.asarray(g) for g in jgrads)
    assert _normwise(tx.grad.numpy(), gx) <= 1e-5
    assert _normwise(tw.grad.numpy().transpose(2, 3, 1, 0), gw) <= 1e-5
    assert _normwise(tb.grad.numpy(), gb) <= 1e-5


def test_fake_quant_conv_sits_on_the_int8_grid():
    """The fake-quant conv equals the s8 x s8 -> s32 conv (same grid,
    float assembly), with dynamic scales and with a saturating static one."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32))
    w = _oihw((rng.standard_normal((3, 3, 16, 32)) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(32) * 0.01).astype(np.float32))
    q, scale = tquant._quantize_weight(w)
    for a in (None, torch.tensor(0.01)):
        got = tconv.conv2d(x * 100.0, tquant.FakeQuantWeight(w, a), b)
        want = tconv.conv2d(x * 100.0, tquant.Int8Weight(q, scale, a), b)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3, rtol=1e-4)


def test_fake_quant_sites_match_serving_and_mismatches_raise():
    _, params = _params()
    model = _port(params)
    fq = tquant.fake_quant_params(model)
    assert fq and set(fq) == set(tquant.quantize_conv_kernels(model))
    assert all(site.a is None for site in fq.values())
    narrow = tfen.FaceEnhanceNet(tfen.FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                           blocks_per_group=2), device="cpu")
    x = np.random.default_rng(3).random((2, 8, 8, 3), dtype=np.float32)
    with pytest.raises(ValueError, match="does not match"):
        tquant.fake_quant_params(model, act_scales=tserving.calibrated_qparams(narrow, x, 2))
    with pytest.raises(ValueError, match="no calibrated scale"):
        tquant.fake_quant_params(model, act_scales=tquant.quantize_conv_kernels(model))


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def test_qat_forward_tracks_int8_serving():
    """The fake-quant forward sits on the serving grid: it agrees with the
    int8 forward far tighter than either with the float forward (the JAX
    test's bounds), dynamic and calibrated."""
    _, params = _params(seed=4)
    model = _port(params).eval()
    x = torch.from_numpy(np.random.default_rng(5).random((4, 16, 16, 3), dtype=np.float32))
    cal = tserving.calibrated_qparams(model, x.numpy(), 4)
    with torch.no_grad():
        f32 = model(x)
        for fq, q in ((tquant.fake_quant_params(model), tquant.quantize_conv_kernels(model)),
                      (tquant.fake_quant_params(model, act_scales=cal), cal)):
            qat, int8 = model(x, quant=fq), model(x, quant=q)
            agree, drift = _psnr(qat, int8), _psnr(qat, f32)
            assert agree > 40.0 and agree > drift + 5.0, (agree, drift)


# ---------------------------------------------------------------------------
# the train step and the Trainer


class _RecordingAdamW(optim.AdamW):
    """AdamW that keeps the gradients of its last update."""

    def update(self, grads, state, params, shard=None):
        self.grads = {k: v.detach().clone() for k, v in grads.items()}
        return super().update(grads, state, params, shard=shard)


def test_one_qat_train_step_matches_jax():
    cfg, params = _params(seed=6)
    lr = 1e-3
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(l1_weight=1.0, perceptual_weight=0.0,
                                                        ssim_weight=0.0), seed=0)
    tloss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.0),
                         device="cpu")
    tx = jsteps.make_optimizer(weight_decay=1e-2, gradient_clip=1.0)
    jstate = jsteps.TrainState(step=jnp.asarray(0), params=jax.tree.map(jnp.asarray, params),
                               opt_state=jsteps.set_learning_rate(tx.init(params), lr),
                               loss_params=jloss.params)
    jstep = jax.jit(jsteps.make_train_step(
        lambda p, x, train, dtype: fen.apply(jquant.fake_quant_params(p), x, cfg, train=train,
                                             dtype=dtype),
        lambda lp, p, t: jloss.apply(lp, p, t), tx))

    model = _port(params)
    opt = _RecordingAdamW(weight_decay=1e-2, gradient_clip=1.0)
    tstate = steps.TrainState(model=model, opt_state=opt.init(dict(model.named_parameters()), lr),
                              loss_params=tloss.params)
    sites = tquant.fake_quant_params(model)
    tstep = steps.make_train_step(lambda lp, p, t: tloss.apply(lp, p, t), opt,
                                  quant_fn=lambda: sites)
    rng = np.random.default_rng(7)
    lo = rng.random((2, 8, 8, 3), dtype=np.float32)
    hr = np.clip(np.kron(lo, np.ones((1, 4, 4, 1), np.float32))
                 + rng.normal(0, 0.02, (2, 32, 32, 3)), 0, 1).astype(np.float32)
    jstate, jm = jstep(jstate, hr)
    tstate, tm = tstep(tstate, torch.from_numpy(hr))
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    # the step's gradients, which Adam's first step reduces to their signs,
    # against jax.grad of the fake-quant loss on the same batch
    lr_img = jsteps.bicubic_down(jnp.asarray(hr), 4)
    jgrads = jax.grad(lambda p: jloss.apply(
        jloss.params, fen.apply(jquant.fake_quant_params(p), lr_img, cfg, train=True),
        jnp.asarray(hr))[0])(jax.tree.map(jnp.asarray, params))
    jgrads = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads))
    assert set(opt.grads) == set(jgrads)
    for k, g in opt.grads.items():
        err = (g - jgrads[k]).abs().max() / jgrads[k].abs().max()
        assert err <= GRAD_TOL, (k, float(err))
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params))
    moved = 0
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=5e-6, rtol=0, err_msg=k)
        moved += not np.array_equal(v.numpy(), state_dict_from_jax_params(params)[k].numpy())
    assert moved > 0.9 * len(want)


def _batches(n, seed, size=32):
    rng = np.random.default_rng(seed)
    return [{"hr": np.kron(rng.random((2, size // 4, size // 4, 3), dtype=np.float32),
                           np.ones((1, 4, 4, 1), np.float32))} for _ in range(n)]


def _trainer(tmp_path, qat=True, qat_scales=None, seed=0, **kw):
    model = tfen.FaceEnhanceNet(tfen.FaceEnhanceNetConfig(**SMALL), seed=seed, device="cpu")
    with torch.no_grad():
        model.conv_last.weight.copy_(torch.randn(model.conv_last.weight.shape,
                                                 generator=torch.Generator().manual_seed(5))
                                     * 0.05)
    loss = CombinedLoss(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.0, device="cpu")
    cfg = TrainerConfig(epochs=1, learning_rate=1e-3, weight_decay=0.0, use_amp=False,
                        scheduler_T_max=1, save_every=100, checkpoint_dir=str(tmp_path),
                        qat=qat, **kw)
    return Trainer(model, _batches(2, 1), _batches(1, 2), loss, cfg, device="cpu",
                   qat_scales=qat_scales)


def test_trainer_qat_flag_trains_and_validates_fake_quantized(tmp_path):
    tr = _trainer(tmp_path, ema_decay=0.5)
    x = torch.from_numpy(_batches(1, 4, size=8)[0]["hr"])
    with torch.no_grad():
        assert not torch.equal(tr.model(x, quant=tr._qat_quant()), tr.model(x))
    metrics, sr, lr_img = tr._eval_step(tr.state, torch.from_numpy(_batches(1, 2)[0]["hr"]))
    with torch.no_grad():  # validation runs the EMA weights fake-quantized
        want = torch.func.functional_call(tr.model, tr.state.ema_params, (lr_img,),
                                          {"quant": tquant.fake_quant_params(tr.model)})
    assert torch.equal(sr, want)
    history = tr.train()
    assert len(history["train_loss"]) == 1
    assert np.isfinite(history["train_loss"][0]) and np.isfinite(history["val_psnr"][0])
    # checkpoints keep the latent float weights
    ckpt = torch.load(tmp_path / "final_model.pth", weights_only=True)
    assert all(v.dtype == torch.float32 for v in ckpt["model_state_dict"].values())
    assert all(torch.equal(ckpt["model_state_dict"][k], v)
               for k, v in tr.model.state_dict().items())
    assert ckpt["trainer_config"]["qat"] is True


def test_trainer_qat_scales_pin_the_grid(tmp_path):
    model = _trainer(tmp_path / "m", qat=False).model
    calib = np.random.default_rng(8).random((4, 8, 8, 3)).astype(np.float32)
    cal = tserving.calibrated_qparams(model, calib, 4)
    tr = _trainer(tmp_path, qat_scales=cal)
    x = torch.from_numpy(np.random.default_rng(9).random((2, 8, 8, 3), dtype=np.float32))
    with torch.no_grad():
        got = tr.model(x, quant=tr._qat_quant())
        want = tr.model(x, quant=tquant.fake_quant_params(tr.model, act_scales=cal))
        dynamic = tr.model(x, quant=tquant.fake_quant_params(tr.model))
    assert torch.equal(got, want) and not torch.equal(got, dynamic)
    assert np.isfinite(tr.train()["train_loss"][0])
    with pytest.raises(ValueError, match="requires config.qat"):
        _trainer(tmp_path / "n", qat=False, qat_scales=cal)


def test_set_qat_scales_after_restore_contract(tmp_path):
    """--qat-scales: the cache is checked against the restored weights
    (a hash mismatch raises for serving, is a note for QAT), pins the
    grid, and a re-pin after a step has run is refused."""
    source = _trainer(tmp_path / "src", qat=False, seed=1).model
    cache = str(tmp_path / "cal.fckpt")
    calib = np.random.default_rng(8).random((4, 8, 8, 3)).astype(np.float32)
    tserving.calibrated_qparams(source, calib, 4, cache_path=cache)
    tr = _trainer(tmp_path)  # other weights (seed 0)
    with pytest.raises(ValueError, match="DIFFERENT"):
        tserving.load_calibrated_qparams(tr.model, cache)
    pinned = tserving.load_calibrated_qparams(tr.model, cache, require_weight_match=False)
    tr.set_qat_scales(pinned)
    x = torch.from_numpy(calib[:2])
    with torch.no_grad():
        assert torch.equal(tr.model(x, quant=tr._qat_quant()),
                           tr.model(x, quant=tquant.fake_quant_params(tr.model,
                                                                      act_scales=pinned)))
    with pytest.raises(RuntimeError, match="already ran"):
        tr.set_qat_scales(pinned)
    with pytest.raises(ValueError, match="requires config.qat"):
        _trainer(tmp_path / "p", qat=False).set_qat_scales(pinned)
