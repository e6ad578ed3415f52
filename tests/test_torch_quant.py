"""The port's int8 quantization (facesr_torch.ops.quant, the int8 conv of
facesr_torch.ops.conv, subpixel_pack_kernel, the packed upsample, the
quant cache) against the JAX package's on the same weights and inputs,
on the CPU.

Tolerances:
- site sets, q, scale, site ids, the int8 conv (dynamic, static and
  pre-quantized input; f32 and bf16 outputs), quantize_act,
  subpixel_pack_kernel, packed vs unpacked: bitwise. The int8 conv is
  exact integer arithmetic, and its f32 dequant runs in the JAX order
  (``y.f32 * (a * scale) + b``, then the cast).
- calibration: each site's static scale within 2% relative of JAX's.
  The recorded maxima are of bf16 activations, which the two packages
  round at other points (conv summation orders, the SE mean): measured
  <= 0.4% on these seeds.
- whole-model int8_full on the same cache (or dynamic scales): in f32
  compute, max |port - JAX| <= 1e-5 (measured 2.4e-7), against an
  int8-vs-f32 error of ~0.1. In bf16 (the serving dtype) the int8 grid
  step of an activation is about one bf16 ulp of it, so a one-ulp
  difference in any float op of the two packages (the SE mean and gate,
  the residual scale) moves int8 levels at a large share of positions and
  the two outputs' quantization noise decorrelates (port vs JAX differs
  as much as int8 vs f32 does, measured on four seeds). There the test
  holds the port's PSNR against the f32 forward within 1 dB of JAX's
  (measured <= 0.35 dB).
"""

import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from facesr.models import face_enhance_net as fen
from facesr.ops import conv as jconv
from facesr.ops.pixel_shuffle import subpixel_pack_kernel as jax_subpixel_pack_kernel
from facesr.ops import quant as jquant
from facesr.parallel import serving as jserving
from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt.weights import jax_qtree_from_sites, state_dict_from_jax_params
from facesr_torch.models import blocks
from facesr_torch.models import face_enhance_net as tfen
from facesr_torch.ops import conv as tconv
from facesr_torch.ops import quant as tquant
from facesr_torch.ops.pixel_shuffle import pixel_shuffle, subpixel_pack_kernel
from facesr_torch.parallel import serving as tserving

torch.set_num_threads(1)

G, B = 2, 2


def _params(c=16, seed=0):
    """JAX params (numpy), every leaf perturbed off its init (distinct
    PReLU slopes, non-zero conv_last)."""
    cfg = fen.FaceEnhanceNetConfig(num_channels=c, num_groups=G, blocks_per_group=B)
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32), params)
    params["conv_last"]["w"] = (rng.standard_normal(params["conv_last"]["w"].shape)
                                * 0.05).astype(np.float32)
    return cfg, params


def _port(params, c=16):
    model = tfen.FaceEnhanceNet(tfen.FaceEnhanceNetConfig(num_channels=c, num_groups=G,
                                                          blocks_per_group=B), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model.eval()


def _x(seed=1, n=2, size=8):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


def _jax_sites(tree):
    """{path string: node} of every int8 dict in a JAX quantized tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda n: isinstance(n, dict) and "q" in n)[0]
    return {jax.tree_util.keystr(p): n for p, n in flat if isinstance(n, dict) and "q" in n}


# ---------------------------------------------------------------------------
# sites, q, scale


@pytest.mark.parametrize("c", [4, 8, 16])
def test_site_sets_q_scale_and_ids_match_jax(c):
    """The predicate counts the stacked leaf: at C = 4 a trunk kernel has
    144 elements but its [G, B] stack 576, so it quantizes in both; at
    C = 8 conv_first (216) stays float in both."""
    cfg, params = _params(c)
    model = _port(params, c)
    jtree, jn = jquant.quantize_conv_kernels(params, with_sids=True)
    sites, n = tquant.quantize_conv_kernels(model, with_sids=True)
    assert n == jn == len(sites)
    got = _jax_sites(jax_qtree_from_sites(model, sites))
    want = _jax_sites(jtree)
    assert sorted(got) == sorted(want)
    for key, node in want.items():
        for leaf in ("q", "scale", "sid"):
            w = np.asarray(node[leaf])
            assert got[key][leaf].dtype == w.dtype and np.array_equal(got[key][leaf], w), \
                (key, leaf)
    if c == 4:
        assert "residual_groups.0.blocks.0.conv1" in sites and "conv_after_body" not in sites
    if c == 8:
        assert "conv_first" not in sites
    assert not any("channel_attention" in s for s in sites)


def test_weight_only_quantize_and_dequantize_match_jax():
    _, params = _params(16, seed=3)
    model = _port(params)
    jq, js = jquant.quantize_pytree(params)
    deq = jquant.dequantize_pytree(jq, js, jnp.bfloat16)
    sites = tquant.quantize_conv_kernels(model)
    got = tquant.dequantize_pytree(sites, torch.bfloat16)
    # every quantized site's dequantized weight equals JAX's leaf slice
    want = state_dict_from_jax_params(jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.float32)), deq))
    assert set(got) == set(sites)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16 and torch.equal(v.float(), want[f"{k}.weight"]), k
    # the float leaves pass through
    assert np.array_equal(np.asarray(deq["groups"]["rcab"]["prelu_a"]),
                          params["groups"]["rcab"]["prelu_a"])


def test_summary_counts_like_jax():
    _, params = _params(16)
    model = _port(params)
    jtree = jquant.quantize_conv_kernels(params)
    assert tquant.quantization_summary(model, tquant.quantize_conv_kernels(model)) == \
        jquant.quantization_summary(jtree)


# ---------------------------------------------------------------------------
# the int8 conv


def _int8_case(rng, cin, cout):
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    s = np.max(np.abs(w), axis=(0, 1, 2), keepdims=True) / np.float32(127)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return q, s, b


def _tw(q, s, a=None):
    return tquant.Int8Weight(torch.from_numpy(q.transpose(3, 2, 0, 1).copy()),
                             torch.from_numpy(s.reshape(-1).copy()),
                             None if a is None else torch.tensor(a))


def _jw(q, s, a=None):
    w = {"q": jnp.asarray(q), "scale": jnp.asarray(s)}
    if a is not None:
        w["a"] = jnp.full((1, 1, 1, 1), a, jnp.float32)
    return w


# (N, H, W, Cin, Cout): conv_first (K 27 -> 32), a trunk conv, an upsample
# conv, conv_last (N 3 -> 8), a packed conv_last (N 12 -> 16), and a
# 1x2x2 input (4 rows, padded past 16)
SHAPES = [(2, 8, 8, 3, 16), (2, 8, 8, 16, 16), (2, 5, 7, 16, 64), (2, 8, 8, 16, 3),
          (1, 6, 6, 64, 12), (1, 2, 2, 16, 16)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", ["dynamic", "static", "int8_input"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_conv_is_bitwise_jax(shape, mode, dtype):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(zlib.crc32(repr((shape, mode, dtype)).encode()))
    q, s, b = _int8_case(rng, cin, cout)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    a = None if mode == "dynamic" else np.float32(0.02)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    if mode == "int8_input":
        jx = jconv.quantize_act(jnp.asarray(x), jnp.asarray(a))
        tx = tconv.quantize_act(torch.from_numpy(x), torch.tensor(a))
        assert np.array_equal(tx.numpy(), np.asarray(jx))
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = jconv.conv2d(jx, _jw(q, s, a), jnp.asarray(b), padding=1, dtype=jd)
    got = tconv.conv2d(tx, _tw(q, s, a), torch.from_numpy(b), padding=1, dtype=td)
    assert str(got.dtype) == f"torch.{want.dtype}"
    assert np.array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("a_ndim", [0, 4])
def test_quantize_act_of_bf16_is_bitwise_jax(a_ndim):
    """A bf16 activation over an f32 scale, as the packed upsample quantizes
    (a 0-d ``a``) and the int8 conv does (a 4-d one): the quotient is taken
    in f32, as JAX's quantize_act does, not rounded to bf16 first (at
    |x / a| >= 32 bf16 steps are 0.25 or more)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 9, 7, 16)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    a = np.full((1,) * a_ndim, np.abs(x).max() / 127 * 0.9, np.float32)
    want = np.asarray(jconv.quantize_act(xb, jnp.asarray(a)))
    got = tconv.quantize_act(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                             .to(torch.bfloat16), torch.from_numpy(a)).numpy()
    assert np.count_nonzero(np.abs(want) >= 32) > 100
    assert np.array_equal(got, want)


def test_int8_conv_chunks_are_bitwise_one_chunk(monkeypatch):
    """Row chunking (whole images, then row bands of one image) changes
    nothing: the integer sums are exact and the dequant is elementwise."""
    rng = np.random.default_rng(5)
    q, s, b = _int8_case(rng, 16, 16)
    x = torch.from_numpy(rng.standard_normal((3, 9, 8, 16)).astype(np.float32))
    tw = _tw(q, s)
    one = tconv.conv2d(x, tw, torch.from_numpy(b), padding=1)
    per_row = 8 * 4 * 16  # one output row's s32 bytes (the larger of the two here)
    for cap in (per_row * 9 * 2, per_row * 4, per_row):  # 2 images, 4 rows, 1 row
        monkeypatch.setattr(tconv, "INT8_CHUNK_BYTES", cap)
        assert torch.equal(tconv.conv2d(x, tw, torch.from_numpy(b), padding=1), one), cap


def test_int8_conv_refuses_an_int8_input_without_a_static_scale():
    rng = np.random.default_rng(6)
    q, s, _ = _int8_case(rng, 16, 16)
    with pytest.raises(ValueError, match="static scale"):
        tconv.conv2d(torch.zeros((1, 4, 4, 16), dtype=torch.int8), _tw(q, s))


# ---------------------------------------------------------------------------
# the packed upsample


def test_subpixel_pack_kernel_is_bitwise_jax():
    rng = np.random.default_rng(7)
    k = rng.integers(-127, 128, (3, 3, 6, 5)).astype(np.int8)
    want = np.asarray(jax_subpixel_pack_kernel(jnp.asarray(k)))
    got = subpixel_pack_kernel(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
    assert np.array_equal(got.numpy().transpose(2, 3, 1, 0), want)


def test_packed_conv_equals_shuffled_conv_bitwise():
    rng = np.random.default_rng(8)
    q, s, b = _int8_case(rng, 4, 3)
    w = _tw(q, s, np.float32(0.05))
    xq = torch.from_numpy(rng.integers(-127, 128, (2, 5, 6, 16)).astype(np.int8))
    want = tconv.conv2d(pixel_shuffle(xq, 2), w, torch.from_numpy(b), padding=1)
    got = pixel_shuffle(tconv.conv2d(xq, w.subpixel_packed(),
                                     torch.from_numpy(b).repeat_interleave(4), padding=1), 2)
    assert torch.equal(got, want)


def _unpacked_forward(model, x, sites):
    """The calibrated int8_full forward with the float order in the
    upsample (shuffle, then PReLU with the plain slopes, then quantize onto
    the next conv's grid) and conv_last on the shuffled int8 map."""
    cfg = model.config
    with torch.no_grad():
        skip = tfen.bicubic_up(x.float(), cfg.scale_factor)
        feat = tconv.conv2d(x, sites["conv_first"], model.conv_first.bias, padding=1,
                            dtype=torch.bfloat16)
        res = feat
        feat, _ = blocks.residual_groups(model.residual_groups, feat, cfg.res_scale, 1,
                                         remat="none", quant=sites)
        feat = tconv.conv2d(feat, sites["conv_after_body"], model.conv_after_body.bias,
                            padding=1) + res
        stages = list(model.upsample.stages)
        for i, st in enumerate(stages):
            y = tconv.conv2d(feat, sites[f"upsample.stages.{i}.conv"], st.conv.bias, padding=1)
            nxt = sites[f"upsample.stages.{i + 1}.conv" if i + 1 < len(stages) else "conv_last"]
            feat = tconv.quantize_act(tconv.prelu(pixel_shuffle(y, 2), st.prelu.weight), nxt.a)
        out = tconv.conv2d(feat, sites["conv_last"], model.conv_last.bias, padding=1)
        return (out.float() + skip).clamp(0, 1)


def test_packed_upsample_equals_the_unpacked_order_bitwise():
    """Quantization and PReLU commute with the shuffle when each slope is
    repeated 4 times channel-major (repeat_interleave): the packed forward
    equals the float order on the same static grid, bitwise. A tiled
    alpha.repeat(4) gives other slopes to most packed channels."""
    _, params = _params(16, seed=9)
    model = _port(params)
    x = torch.from_numpy(_x(seed=10))
    sites = tserving.calibrated_qparams(model, x.numpy(), max_batch=2)
    with torch.no_grad():
        got = model(x, dtype=torch.bfloat16, quant=sites).clamp(0, 1)
    assert torch.equal(got, _unpacked_forward(model, x, sites))


# ---------------------------------------------------------------------------
# calibration, the quant cache, the whole model


def _jax_calibrated(params, cfg, x):
    fwd = jax.jit(lambda p, b: fen.apply(p, b, cfg, train=False, dtype=jnp.bfloat16))
    return jquant.calibrate_act_scales(params, fwd, [x])


@pytest.mark.parametrize("keep_last_packed", [True, False])
def test_calibrated_upsample_in_bf16_is_bitwise_jax(keep_last_packed):
    """The calibrated upsample (int8 convs, packed PReLU, quantize onto the
    next conv's grid, shuffle) on a bf16 feature map, in the port and in
    JAX's blocks.upsample, on one JAX-calibrated tree: bitwise."""
    from facesr.models import blocks as jblocks
    from facesr_torch.ckpt.weights import sites_from_jax_qtree

    cfg, params = _params(16, seed=13)
    model = _port(params)
    jtree = _jax_calibrated(params, cfg, _x(seed=14))
    sites = sites_from_jax_qtree(jax.tree.map(np.asarray, jtree), model)
    feat = np.random.default_rng(15).standard_normal((2, 6, 5, 16)).astype(np.float32)
    fb = jnp.asarray(feat, jnp.bfloat16)
    want = np.asarray(jblocks.upsample(jtree["upsample"], fb, next_w=jtree["conv_last"]["w"],
                                       keep_last_packed=keep_last_packed))
    with torch.no_grad():
        got = blocks.upsample(model.upsample,
                              torch.from_numpy(np.array(fb.astype(jnp.float32)))
                              .to(torch.bfloat16), next_w=sites["conv_last"],
                              keep_last_packed=keep_last_packed, quant=sites).numpy()
    assert got.dtype == np.int8 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_calibration_matches_jax_within_tolerance():
    cfg, params = _params(16, seed=11)
    model = _port(params)
    x = _x(seed=12, n=3)
    jtree = _jax_calibrated(params, cfg, x)
    sites = tserving.calibrated_qparams(model, x, max_batch=2)  # 2 forwards: 2 + 1 images
    want = _jax_sites(jtree)
    got = _jax_sites(jax_qtree_from_sites(model, sites))
    for key, node in want.items():
        a_w, a_g = np.asarray(node["a"]), got[key]["a"]
        np.testing.assert_allclose(a_g, a_w, rtol=2e-2, err_msg=key)


def test_calibration_refuses_a_degenerate_site():
    _, params = _params(16)
    model = _port(params)
    nan = _x()
    nan[0, 2, 2, 1] = np.nan
    with pytest.raises(RuntimeError, match="without a positive finite"):
        tserving.calibrated_qparams(model, nan, max_batch=2)


def test_quant_caches_cross_load_and_pin_their_weights(tmp_path):
    """The same calibration stats written by both packages give the same
    file, byte for byte; each package loads the other's; a cache from other
    weights is refused by both (and only noted with require_weight_match
    off)."""
    cfg, params = _params(16, seed=13)
    model = _port(params)
    assert fckpt.params_fingerprint(model) == jserving._params_fingerprint(params)
    jtree, n = jquant.quantize_conv_kernels(params, with_sids=True)
    stats = np.random.default_rng(14).random(n) + 0.1
    jcal = jquant.attach_act_scales(jtree, stats)
    sites, _ = tquant.quantize_conv_kernels(model, with_sids=True)
    tcal = tquant.attach_act_scales(sites, stats)

    from flax import serialization
    from facesr.ckpt.checkpoint import save_checkpoint as jsave

    jpath, tpath = tmp_path / "j.fckpt", tmp_path / "t.fckpt"
    jsave(str(jpath), serialization.to_state_dict(jcal),
          {"kind": "facesr-int8-calibrated", "params_sha256": jserving._params_fingerprint(params)})
    fckpt.save_quant_cache(str(tpath), model, tcal)
    assert jpath.read_bytes() == tpath.read_bytes()

    from_jax = tserving.load_calibrated_qparams(model, str(jpath))
    assert list(from_jax) == list(tcal)
    for k in tcal:
        assert torch.equal(from_jax[k].q, tcal[k].q) and torch.equal(from_jax[k].a, tcal[k].a)
    jloaded = jserving.load_calibrated_qparams(params, str(tpath))
    for key, node in _jax_sites(jcal).items():
        for leaf in ("q", "scale", "a"):
            assert np.array_equal(np.asarray(_jax_sites(jloaded)[key][leaf]),
                                  np.asarray(node[leaf]))

    _, other = _params(16, seed=99)
    with pytest.raises(ValueError, match="DIFFERENT"):
        tserving.load_calibrated_qparams(_port(other), str(jpath))
    with pytest.raises(ValueError, match="DIFFERENT"):
        jserving.load_calibrated_qparams(other, str(tpath))
    assert set(tserving.load_calibrated_qparams(_port(other), str(tpath),
                                                require_weight_match=False)) == set(tcal)


def test_quant_cache_of_another_architecture_is_refused(tmp_path):
    _, params = _params(16)
    path = tmp_path / "c.fckpt"
    model = _port(params)
    fckpt.save_quant_cache(str(path), model, tserving.calibrated_qparams(model, _x(), 2))
    _, narrow = _params(8)
    with pytest.raises(ValueError, match="does not match this model"):
        tserving.load_calibrated_qparams(_port(narrow, 8), str(path),
                                         require_weight_match=False)
    fckpt.save_checkpoint(str(tmp_path / "m.fckpt"), {"params": {}}, {"model_type": "custom"})
    with pytest.raises(ValueError, match="not a calibrated-int8 cache"):
        tserving.load_calibrated_qparams(model, str(tmp_path / "m.fckpt"))


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


@pytest.mark.parametrize("calibrated", [False, True])
def test_whole_model_int8_full_matches_jax(tmp_path, calibrated):
    cfg, params = _params(16, seed=15)
    model = _port(params)
    x = _x(seed=16, n=3)
    if calibrated:  # both packages serve the one JAX-written cache
        jtree = _jax_calibrated(params, cfg, x[:2])
        from flax import serialization
        from facesr.ckpt.checkpoint import save_checkpoint as jsave

        jsave(str(tmp_path / "c.fckpt"), serialization.to_state_dict(jtree),
              {"kind": "facesr-int8-calibrated",
               "params_sha256": jserving._params_fingerprint(params)})
        sites = tserving.load_calibrated_qparams(model, str(tmp_path / "c.fckpt"))
    else:
        jtree = jquant.quantize_conv_kernels(params)
        sites = tquant.quantize_conv_kernels(model)
    f32 = np.asarray(fen.apply(params, jnp.asarray(x), cfg, train=False))
    for jd, td in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(fen.apply(jtree, jnp.asarray(x), cfg, train=False, dtype=jd))
        with torch.no_grad():
            got = model(torch.from_numpy(x), dtype=td, quant=sites).numpy()
        if td is None:
            err, quant_err = np.abs(got - want).max(), np.abs(want - f32).max()
            assert err <= 1e-5 and quant_err > 1e-2, (err, quant_err)
        else:
            assert abs(_psnr(got, f32) - _psnr(want, f32)) <= 1.0, \
                (_psnr(got, f32), _psnr(want, f32))
