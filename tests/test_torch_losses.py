"""The port's losses (facesr_torch.losses, models.vgg, the new ops) against
the JAX package's on the same inputs and weights, on the CPU.

Tolerances: float32 on both sides, other summation orders. Pixel losses
and SSIM agree to ~1e-7 relative (atol 1e-6); VGG features are sums of
~2k products per conv over 8-12 convs (rtol 1e-4 of the feature scale);
the perceptual and combined losses reduce those in f32 (rtol 1e-5, and
SSIM's atol 1e-6 for the SSIM terms).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from facesr.losses import basic as jbasic
from facesr.losses import combined as jcombined
from facesr.losses import perceptual as jperc
from facesr.models import vgg as jvgg
from facesr.ops import avg_pool2 as javg_pool2
from facesr.ops import conv2d as jconv2d
from facesr_torch.ckpt.weights import vgg_params_from_jax
from facesr_torch.losses import basic, combined, perceptual
from facesr_torch.models import vgg
from facesr_torch.ops.conv import conv2d
from facesr_torch.ops.resize import avg_pool2

# the packages export a function `ssim` that shadows the module of that name
jssim = importlib.import_module("facesr.losses.ssim")
tssim = importlib.import_module("facesr_torch.losses.ssim")

torch.set_num_threads(1)


def _pair(seed, shape=(2, 32, 32, 3), noise=0.1):
    """(pred, target) in [0, 1], positively correlated as SR outputs are."""
    rng = np.random.default_rng(seed)
    target = rng.random(shape, dtype=np.float32)
    pred = np.clip(target + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return pred, target


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jvgg_params(layers, seed=0):
    """JAX VGG params (numpy) and the same weights in the port's layout."""
    params = jax.tree.map(np.asarray, jperc.init_perceptual(
        jax.random.PRNGKey(seed), layers=layers, pretrained_params=None))
    return params, vgg_params_from_jax(params)


@pytest.mark.parametrize("name", ["l1", "l2", "charbonnier"])
def test_pixel_losses_match_jax(name):
    pred, target = _pair(0)
    if name == "charbonnier":
        want = jbasic.charbonnier_loss(pred, target, 1e-3)
        got = basic.charbonnier_loss(_t(pred), _t(target), 1e-3)
    else:
        want = getattr(jbasic, f"{name}_loss")(pred, target)
        got = getattr(basic, f"{name}_loss")(_t(pred), _t(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("padding,groups,wshape", [
    (((5, 5), (0, 0)), 3, (11, 1, 1, 3)),  # SSIM's column pass
    (((0, 0), (5, 5)), 3, (1, 11, 1, 3)),  # its row pass
    (1, 1, (3, 3, 3, 4)),
])
def test_conv2d_groups_and_per_axis_padding_match_jax(padding, groups, wshape):
    rng = np.random.default_rng(1)
    x = rng.random((2, 13, 10, 3), dtype=np.float32)
    w = rng.standard_normal(wshape).astype(np.float32)
    b = rng.standard_normal(wshape[-1]).astype(np.float32)
    want = jconv2d(x, w, b, padding=list(padding) if not isinstance(padding, int)
                   else padding, feature_group_count=groups)
    got = conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b), padding=padding, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_conv2d_rejects_asymmetric_padding():
    with pytest.raises(ValueError, match="symmetric"):
        conv2d(torch.zeros(1, 4, 4, 1), torch.zeros(1, 1, 3, 3), padding=((1, 0), (1, 1)))


def test_avg_pool2_matches_jax_on_odd_dims():
    x = np.random.default_rng(2).random((2, 7, 9, 3), dtype=np.float32)
    got = avg_pool2(_t(x))
    assert got.shape == (2, 3, 4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(javg_pool2(x)), atol=1e-7)


def test_gaussian_window_matches_jax():
    got = tssim.create_gaussian_window(11, 1.5, 3)  # OIHW
    want = jssim.create_gaussian_window(11, 1.5, 3)  # HWIO
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(size_average):
    pred, target = _pair(3)
    want = np.asarray(jssim.ssim(pred, target, size_average=size_average))
    got = tssim.ssim(_t(pred), _t(target), size_average=size_average).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(tssim.ssim_loss(_t(pred), _t(target)).item(),
                               float(jssim.ssim_loss(pred, target)), atol=1e-6)


def test_ssim_separable_filter_equals_the_full_window():
    pred, _ = _pair(4)
    x = _t(pred)
    full = conv2d(x, _t(tssim.create_gaussian_window(11, 1.5, 3)), padding=5, groups=3)
    np.testing.assert_allclose(tssim._filter(x, 11, 1.5).numpy(), full.numpy(), atol=1e-6)


def test_ms_ssim_matches_jax_at_the_smallest_size():
    # 5 scales: 16 -> 8 -> 4 -> 2 -> 1 pixels; at 8 the last scale is empty
    pred, target = _pair(5, shape=(2, 16, 16, 3), noise=0.05)
    want = float(jssim.ms_ssim(pred, target))
    got = tssim.ms_ssim(_t(pred), _t(target)).item()
    assert np.isfinite(want) and 0 < want <= 1
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(tssim.ms_ssim_loss(_t(pred), _t(target)).item(),
                               float(jssim.ms_ssim_loss(pred, target)), atol=1e-6)


def test_vgg_structure_matches_jax():
    assert vgg.VGG19_CFG == jvgg.VGG19_CFG and vgg.LAYER_MAP == jvgg.LAYER_MAP
    assert vgg.module_sequence() == jvgg.module_sequence()
    for idx in (0, 16, 25, 36):
        assert vgg.num_convs_needed(idx) == jvgg.num_convs_needed(idx)
    params = vgg.init_vgg19(torch.Generator().manual_seed(0), max_index=16)
    shapes = jax.eval_shape(lambda k: jvgg.init_vgg19(k, max_index=16),
                            jax.random.PRNGKey(0))
    assert len(params) == len(shapes) == 8
    for p, s in zip(params, shapes):
        assert tuple(p["w"].shape) == tuple(np.transpose(np.empty(s["w"].shape),
                                                         (3, 2, 0, 1)).shape)
        assert not p["w"].requires_grad


def test_vgg_features_match_jax_at_conv3_4_and_conv4_4():
    jparams, tparams = _jvgg_params(("conv3_4", "conv4_4"))
    x = np.random.default_rng(6).random((2, 32, 32, 3), dtype=np.float32)
    idxs = [vgg.LAYER_MAP["conv3_4"], vgg.LAYER_MAP["conv4_4"]]
    want = jvgg.extract_features(jparams, x, idxs)
    got = vgg.extract_features(tparams, _t(x), idxs)
    for idx in idxs:
        w = np.asarray(want[idx])
        np.testing.assert_allclose(got[idx].numpy(), w, atol=1e-4 * np.abs(w).max())
    assert got[idxs[1]].shape == (2, 4, 4, 512)


@pytest.mark.parametrize("criterion", ["l1", "l2"])
def test_perceptual_loss_and_its_gradient_match_jax(criterion):
    layers = ("conv3_4",)
    jparams, tparams = _jvgg_params(layers, seed=1)
    pred, target = _pair(7)
    want, want_grad = jax.value_and_grad(
        lambda p: jperc.perceptual_loss(jparams, p, target, layers=layers,
                                        criterion=criterion))(pred)
    p = _t(pred).requires_grad_(True)
    got = perceptual.perceptual_loss(tparams, p, _t(target), layers=layers,
                                     criterion=criterion, remat=True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    g = np.asarray(want_grad)
    np.testing.assert_allclose(p.grad.numpy(), g, atol=1e-4 * np.abs(g).max())


def test_perceptual_checks_its_criterion_and_weights():
    _, tparams = _jvgg_params(("conv3_4",), seed=2)
    pred, target = _pair(8)
    with pytest.raises(ValueError, match="criterion"):
        perceptual.perceptual_loss(tparams, _t(pred), _t(target), layers=("conv3_4",),
                                   criterion="l3")
    with pytest.raises(ValueError, match="convs"):
        perceptual.init_perceptual(torch.Generator(), ("conv4_4",), tparams)
    zero = perceptual.perceptual_loss(tparams, _t(pred), _t(target), layers=("conv3_4",),
                                      weights={"conv3_4": 0.0})
    assert zero.item() == 0.0


@pytest.mark.parametrize("stage,weights", [
    ("stage1", dict(l1_weight=1.0, perceptual_weight=1.0, ssim_weight=0.0)),
    ("stage2", dict(l1_weight=1.0, perceptual_weight=0.5, ssim_weight=0.2)),
    ("all_terms", dict(l1_weight=1.0, l2_weight=0.3, perceptual_weight=0.1,
                       ssim_weight=0.2, ms_ssim_weight=0.4, use_charbonnier=True)),
])
def test_combined_loss_matches_jax(stage, weights):
    cfg = dict(weights, perceptual_layers=["conv3_4"])
    jloss = jcombined.CombinedLoss(jcombined.LossConfig(**cfg), seed=0)
    jparams = jax.tree.map(np.asarray, jloss.params)
    tloss = combined.CombinedLoss(combined.LossConfig(**cfg), device="cpu",
                                  vgg_params=vgg_params_from_jax(jparams["vgg"]))
    pred, target = _pair(9)
    want_total, want = jloss.apply(jparams, pred, target)
    got_total, got = tloss(_t(pred), _t(target))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert all(not p.requires_grad for conv in tloss.params["vgg"] for p in conv.values())


def test_combined_loss_builds_only_weighted_terms_and_rejects_unknown_fields():
    tloss = combined.CombinedLoss(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.0,
                                  device="cpu")
    assert tloss.get_weights() == {"l1": 1.0} and tloss.params == {}
    with pytest.raises(TypeError, match="Unknown"):
        combined.CombinedLoss(device="cpu", l1_wieght=1.0)
    with pytest.raises(TypeError, match="unknown argument"):
        combined.create_loss_function(perceptual_weight=0.0, bogus=1, device="cpu")
    with pytest.raises(ValueError):
        tloss.update_weight("ssim", 0.5)
    made = combined.create_loss_function(perceptual_weight=0.0, ssim_weight=0.5,
                                         device="cpu")
    assert made.get_weights() == {"l1": 1.0, "ssim": 0.5}


def test_loss_tracker_matches_jax():
    jt, tt = jcombined.LossTracker(window_size=2), combined.LossTracker(window_size=2)
    for vals in ({"a": 1.0, "b": 4.0}, {"a": 2.0, "b": 5.0}, {"a": 6.0, "b": 3.0}):
        jt.update(vals)
        tt.update({k: torch.tensor(v) for k, v in vals.items()})
    assert tt.get_moving_average("a") == jt.get_moving_average("a")
    assert tt.get_epoch_average("b") == jt.get_epoch_average("b")
    assert tt.end_epoch() == jt.end_epoch()
    tt.update({"a": 0.5})
    jt.update({"a": 0.5})
    tt.end_epoch()
    jt.end_epoch()
    assert tt.get_summary() == jt.get_summary() and tt.to_dict() == jt.to_dict()
