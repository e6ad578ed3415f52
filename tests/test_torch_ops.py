"""Parity of the port's primitives (facesr_torch.ops) with the JAX package
and with torch's own operators, on the CPU, from the same numpy inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from facesr.ops import conv as jconv
from facesr.ops.pixel_shuffle import pixel_shuffle as j_shuffle, pixel_unshuffle as j_unshuffle
from facesr.ops import resize as jresize
from facesr_torch.ops import conv as tconv
from facesr_torch.ops import init as tinit
from facesr_torch.ops.pixel_shuffle import pixel_shuffle as t_shuffle, pixel_unshuffle as t_unshuffle
from facesr_torch.ops import resize as tresize

torch.set_num_threads(1)


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("in_size,out_size", [(16, 64), (64, 16), (7, 13), (9, 9)])
def test_resize_matrix_equals_jax(method, in_size, out_size):
    got = tresize.resize_matrix(in_size, out_size, method)
    want = jresize.resize_matrix(in_size, out_size, method)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_resize_matrix_rejects_unknown_method():
    with pytest.raises(ValueError):
        tresize.resize_matrix(4, 4, "lanczos")


@pytest.mark.parametrize("shape,scale", [((2, 16, 12, 3), 4), ((1, 8, 8, 2), 2)])
def test_bicubic_up_down_match_jax_and_interpolate(shape, scale):
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    xt = torch.from_numpy(x)
    up = tresize.bicubic_up(xt, scale)
    np.testing.assert_allclose(up.numpy(), np.asarray(jresize.bicubic_up(jnp.asarray(x), scale)),
                               atol=1e-5)
    ref = F.interpolate(xt.permute(0, 3, 1, 2), scale_factor=scale, mode="bicubic",
                        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(up.numpy(), ref.numpy(), atol=1e-5)

    down = tresize.bicubic_down(up, scale)
    np.testing.assert_allclose(
        down.numpy(), np.asarray(jresize.bicubic_down(jnp.asarray(up.numpy()), scale)),
        atol=1e-5)
    ref = F.interpolate(up.permute(0, 3, 1, 2), scale_factor=1 / scale, mode="bicubic",
                        align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(down.numpy(), ref.numpy(), atol=1e-5)


def test_resize_keeps_dtype():
    x = torch.rand(1, 4, 4, 3).to(torch.bfloat16)
    assert tresize.bicubic_up(x, 2).dtype == torch.bfloat16


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax_and_torch(r):
    x = np.random.default_rng(1).random((2, 5, 4, 3 * r * r), dtype=np.float32)
    got = t_shuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_shuffle(jnp.asarray(x), r)))
    ref = F.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())

    back = t_unshuffle(got, r)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_unshuffle(jnp.asarray(got.numpy()), r)))
    ref = F.pixel_unshuffle(got.permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(back.numpy(), ref.numpy())


@pytest.mark.parametrize("cin,cout,k,pad", [(3, 16, 3, 1), (16, 8, 3, 1), (8, 8, 1, 0)])
def test_conv2d_f32_matches_jax(cin, cout, k, pad):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 7, cin)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, k, k)) * 0.2).astype(np.float32)  # OIHW
    b = rng.standard_normal(cout).astype(np.float32)
    got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                       padding=pad)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
                        jnp.asarray(b), padding=pad)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_conv2d_restores_tf32_flag():
    prev = torch.backends.cudnn.allow_tf32
    with tconv.full_f32():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == prev


def test_full_f32_overlapping_users_keep_tf32_off():
    # two serving threads whose f32 convs overlap: the first one out must
    # not turn TF32 back on under the other
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        a, b = tconv.full_f32(), tconv.full_f32()
        a.__enter__()
        b.__enter__()
        a.__exit__(None, None, None)
        assert torch.backends.cudnn.allow_tf32 is False
        b.__exit__(None, None, None)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_prelu_leaky_relu_avg_pool_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 5, 6)).astype(np.float32)
    a = rng.random(6).astype(np.float32)
    np.testing.assert_allclose(
        tconv.prelu(torch.from_numpy(x), torch.from_numpy(a)).numpy(),
        np.asarray(jconv.prelu(jnp.asarray(x), jnp.asarray(a))), atol=1e-5)
    np.testing.assert_allclose(
        tconv.leaky_relu(torch.from_numpy(x), 0.2).numpy(),
        np.asarray(jconv.leaky_relu(jnp.asarray(x), 0.2)), atol=1e-5)
    np.testing.assert_allclose(
        tconv.global_avg_pool(torch.from_numpy(x)).numpy(),
        np.asarray(jconv.global_avg_pool(jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("shape,fan_out", [((64, 64, 3, 3), 64 * 9), ((16, 64), 16),
                                           ((256, 64, 3, 3), 256 * 9)])
def test_kaiming_normal_std(shape, fan_out):
    g = torch.Generator().manual_seed(0)
    w = tinit.kaiming_normal(shape, g)
    want = np.sqrt(2.0) / np.sqrt(fan_out)
    assert abs(float(w.std()) / want - 1) < 0.05
    assert abs(float(w.mean())) < 0.05 * want


def test_kaiming_normal_is_seeded():
    a = tinit.kaiming_normal((8, 8, 3, 3), torch.Generator().manual_seed(7))
    b = tinit.kaiming_normal((8, 8, 3, 3), torch.Generator().manual_seed(7))
    assert torch.equal(a, b)


def test_icnr_phases_equal_and_std():
    g = torch.Generator().manual_seed(1)
    w = tinit.icnr((256, 64, 3, 3), g, scale_factor=2)
    phases = w.reshape(64, 4, 64, 3, 3)
    for p in range(1, 4):
        assert torch.equal(phases[:, 0], phases[:, p])
    # sub-kernel drawn with fan_out = (256 / 4) * 9
    want = np.sqrt(2.0) / np.sqrt(64 * 9)
    assert abs(float(phases[:, 0].std()) / want - 1) < 0.05
    # after the shuffle, all four sub-pixels of each output channel are equal
    x = torch.randn(1, 64, 5, 5, generator=g)
    y = F.pixel_shuffle(F.conv2d(x, w, padding=1), 2)
    assert torch.allclose(y[..., 0::2, 0::2], y[..., 1::2, 1::2])
    with pytest.raises(ValueError):
        tinit.icnr((6, 4, 3, 3), g)


def test_prelu_init():
    assert torch.equal(tinit.prelu_init(5), torch.full((5,), 0.25))
