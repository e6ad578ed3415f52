"""The model zoo's int8 in the port (RRDBNet, TransferSRModel: site tables,
weight fingerprints, quant caches, int8 and int8_full forwards, the
transfer head's packed int8 arm, QAT) against the JAX package's on the
same weights, on the CPU. The JAX trees come from seeded port models
through `jax_params_from` (held to JAX's init layout by the zoo tests),
and the JAX functions are jitted.

Tolerances:
- site order and ids, q, scale, fingerprints, quant cache bytes: exact.
- int8_full forwards in f32 compute (dynamic scales, or both packages on
  one cache): max |port - JAX| <= 1e-5 * max|JAX| against an int8-vs-f32
  error of more than 1e-3 * max|JAX|; as the FaceEnhanceNet int8 test, in
  bf16 the port's PSNR against the f32 forward within 1 dB of JAX's (an
  int8 step is about one bf16 ulp of an activation, so the two packages'
  one-ulp differences move levels and decorrelate the noise).
- weight-only int8: the bf16 forward of the dequantized weights in both,
  held as the zoo's bf16 forwards are (max 2^-5, mean 2^-8 of max|JAX|).
- a QAT step (L1, AdamW at lr 1e-4): every gradient normwise within 1e-5
  of JAX's, the updated parameters within 1e-5 relative L2 per tensor of
  JAX's fake-quant step, frozen ones bitwise.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facesr.models import esrgan as esr
from facesr.models import transfer as tr
from facesr.ops import bicubic_down as jbicubic_down
from facesr.ops import quant as jquant
from facesr.parallel import serving as jserving
from facesr.training import steps as jsteps
from facesr_torch.ckpt import fckpt
from facesr_torch.cli.step_numerics import fake_quant_levels, small_zoo_step, step_errors
from facesr_torch.ckpt.weights import jax_params_from, jax_qtree_from_sites, state_dict_from_jax
from facesr_torch.models import esrgan as tesr
from facesr_torch.models import transfer as ttr
from facesr_torch.ops import conv as tconv
from facesr_torch.ops import quant as tquant
from facesr_torch.ops import rcab_group as tgroup
from facesr_torch.ops.resize import bicubic_down
from facesr_torch.parallel import serving as tserving
from facesr_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

# the zoo tests' small widths: RRDBNet 2 x 16, growth 8; transfer 5 + 2 at 16
ESRGAN = dict(num_feat=16, num_blocks=2, num_grow_ch=8)
TRANSFER = dict(backbone_blocks=5, head_blocks=2, head_channels=16)
FAMILIES = ["esrgan", "transfer"]


def _port(family, seed=0, **cfg):
    """A seeded port model in eval mode, every parameter moved off its init
    (non-zero biases)."""
    if family == "esrgan":
        model = tesr.RRDBNet(tesr.RRDBNetConfig(**(cfg or ESRGAN)), seed=seed, device="cpu")
    else:
        model = ttr.TransferSRModel(ttr.TransferModelConfig(**(cfg or TRANSFER)), seed=seed,
                                    device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return model.eval()


def _jax_model(family, model):
    """(jitted apply(tree, x, dtype), JAX params as numpy) of a port model."""
    if family == "esrgan":
        cfg, apply = esr.RRDBNetConfig(**ESRGAN), esr.apply
    else:
        cfg, apply = tr.TransferModelConfig(**TRANSFER), tr.apply
    fn = jax.jit(lambda p, x, dtype=None: apply(p, x, cfg, train=False, dtype=dtype),
                 static_argnames="dtype")
    return fn, jax_params_from(model)


def _x(seed=1, n=2, size=8):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


def _jax_sites(tree):
    """{path string: node} of every int8 dict in a JAX quantized tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda n: isinstance(n, dict) and "q" in n)[0]
    return {jax.tree_util.keystr(p): n for p, n in flat if isinstance(n, dict) and "q" in n}


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


# ---------------------------------------------------------------------------
# sites, fingerprints, quant caches


@pytest.mark.parametrize("family,leaves,sites", [("esrgan", 21, 351), ("transfer", 38, 254)])
def test_full_width_site_table_is_the_jax_order(family, leaves, sites):
    """At the published widths (RealESRGAN x4plus; transfer 16+4 at 64)
    the quantized leaves are JAX's, in tree-flatten order (JAX's shapes
    from ``jax.eval_shape`` of its init), and the site ids leaf-major."""
    model = (tesr.RRDBNet(device="cpu") if family == "esrgan"
             else ttr.TransferSRModel(device="cpu"))
    init, cfg = ((esr.init, esr.RRDBNetConfig()) if family == "esrgan"
                 else (tr.init, tr.TransferModelConfig()))
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    want = [(tuple(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path), leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]
            if jquant._is_conv_kernel(path, leaf)]
    got = tquant.quant_leaves(model)
    assert [tuple(map(str, leaf.path)) for leaf in got] == [p for p, _ in want]
    assert [leaf.stack + tuple(leaf.shape[i] for i in (2, 3, 1, 0)) for leaf in got] == [
        s for _, s in want]
    names = [n for leaf in got for n in leaf.names]
    assert len(got) == leaves and len(names) == sites
    if family == "esrgan":
        assert names[:23] == [f"body.{i}.rdb1.conv1" for i in range(23)]
        assert names[322:345] == [f"body.{i}.rdb3.conv5" for i in range(23)]
        assert names[345:] == ["conv_body", "conv_first", "conv_hr", "conv_last", "conv_up1",
                               "conv_up2"]
    else:
        assert names[0] == "backbone.body.0.rdb1.conv1" and names[11] == \
            "backbone.body.11.rdb1.conv1" and names[180] == "backbone.body.12.rdb1.conv1"
        assert names[240:] == (["backbone.conv_body", "backbone.conv_first",
                                "face_head.conv_after", "face_head.conv_last"]
                               + [f"face_head.rcab_blocks.{b}.conv{c}" for c in (1, 2)
                                  for b in range(4)]
                               + [f"face_head.upsample.stages.{s}.conv" for s in (0, 1)])


@pytest.mark.parametrize("family,cfg", [("esrgan", None), ("transfer", None),
                                        ("transfer", dict(backbone_blocks=3, head_blocks=1,
                                                          head_channels=16))],
                         ids=["esrgan", "transfer", "transfer_no_body_main"])
def test_sites_q_scale_ids_and_fingerprint_match_jax(family, cfg):
    model = _port(family, seed=3, **(cfg or {}))
    params = jax_params_from(model)
    jtree, jn = jquant.quantize_conv_kernels(params, with_sids=True)
    sites, n = tquant.quantize_conv_kernels(model, with_sids=True)
    assert n == jn == len(sites)
    got, want = _jax_sites(jax_qtree_from_sites(model, sites)), _jax_sites(jtree)
    assert list(got) == list(want)  # the same leaves, in tree order
    for key, node in want.items():
        for leaf in ("q", "scale", "sid"):
            w = np.asarray(node[leaf])
            assert got[key][leaf].dtype == w.dtype and np.array_equal(got[key][leaf], w), \
                (key, leaf)
    assert fckpt.params_fingerprint(model) == jserving._params_fingerprint(params)
    assert not any("channel_attention" in s for s in sites)


@pytest.mark.parametrize("family", FAMILIES)
def test_quant_caches_cross_load_byte_identical(family, tmp_path):
    """The same stats written by both packages give the same file, byte
    for byte; each package reads the other's; a cache of other weights is
    refused by both."""
    from flax import serialization
    from facesr.ckpt.checkpoint import save_checkpoint as jsave

    model = _port(family, seed=5)
    params = jax_params_from(model)
    jtree, n = jquant.quantize_conv_kernels(params, with_sids=True)
    stats = np.random.default_rng(6).random(n) + 0.1
    jcal = jquant.attach_act_scales(jtree, stats)
    tcal = tquant.attach_act_scales(tquant.quantize_conv_kernels(model, with_sids=True)[0],
                                    stats)
    jpath, tpath = tmp_path / "j.fckpt", tmp_path / "t.fckpt"
    jsave(str(jpath), serialization.to_state_dict(jcal),
          {"kind": "facesr-int8-calibrated", "params_sha256": jserving._params_fingerprint(params)})
    fckpt.save_quant_cache(str(tpath), model, tcal)
    assert jpath.read_bytes() == tpath.read_bytes()
    from_jax = tserving.load_calibrated_qparams(model, str(jpath))
    assert list(from_jax) == list(tcal)
    for k, w in tcal.items():
        assert torch.equal(from_jax[k].q, w.q) and torch.equal(from_jax[k].scale, w.scale) \
            and torch.equal(from_jax[k].a, w.a), k
    jloaded = _jax_sites(jserving.load_calibrated_qparams(params, str(tpath)))
    for key, node in _jax_sites(jcal).items():
        for leaf in ("q", "scale", "a"):
            assert np.array_equal(np.asarray(jloaded[key][leaf]), np.asarray(node[leaf]))
    other = _port(family, seed=99)
    with pytest.raises(ValueError, match="DIFFERENT"):
        tserving.load_calibrated_qparams(other, str(jpath))
    with pytest.raises(ValueError, match="DIFFERENT"):
        jserving.load_calibrated_qparams(jax_params_from(other), str(tpath))
    assert set(tserving.load_calibrated_qparams(other, str(tpath),
                                                require_weight_match=False)) == set(tcal)


# ---------------------------------------------------------------------------
# forwards


def _jax_calibrated(fn, params, x):
    """JAX's calibrated tree: its own calibration (jitted bf16 forwards)."""
    return jquant.calibrate_act_scales(
        params, jax.jit(lambda p, b: fn(p, b, dtype=jnp.bfloat16)), [x])


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("family", FAMILIES)
def test_int8_full_forward_matches_jax(family, calibrated, tmp_path):
    """Both packages on the same sites (dynamic scales, or a JAX-written
    cache served by both); the calibrated transfer model runs its head's
    packed arm (a subpixel conv_last on the packed upsample)."""
    from flax import serialization
    from facesr.ckpt.checkpoint import save_checkpoint as jsave

    model = _port(family, seed=7)
    fn, params = _jax_model(family, model)
    x = _x(seed=8, n=3)
    if calibrated:
        jtree = _jax_calibrated(fn, params, x[:2])
        jsave(str(tmp_path / "c.fckpt"), serialization.to_state_dict(jtree),
              {"kind": "facesr-int8-calibrated",
               "params_sha256": jserving._params_fingerprint(params)})
        sites = tserving.load_calibrated_qparams(model, str(tmp_path / "c.fckpt"))
    else:
        jtree = jquant.quantize_conv_kernels(params)
        sites = tquant.quantize_conv_kernels(model)
    f32 = np.asarray(fn(params, x))
    for jd, td in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(fn(jtree, x, dtype=jd))
        with torch.no_grad():
            got = model(torch.from_numpy(x), dtype=td, quant=sites).numpy()
        if td is None:
            scale = np.abs(want).max()
            err, quant_err = np.abs(got - want).max(), np.abs(want - f32).max()
            assert err <= 1e-5 * scale and quant_err > 1e-3 * scale, (err, quant_err, scale)
        else:
            assert abs(_psnr(got, f32) - _psnr(want, f32)) <= 1.0, \
                (_psnr(got, f32), _psnr(want, f32))


@pytest.mark.parametrize("family", FAMILIES)
def test_int8_weight_only_serves_the_dequantized_weights_as_jax(family):
    """The dequantized kernels are JAX's ``dequantize_pytree`` bitwise; the
    served forward is the port's bf16 forward of them, bitwise, and JAX's
    within the zoo's bf16 limits (unclamped, as the zoo's bf16 tests)."""
    model = _port(family, seed=9)
    fn, params = _jax_model(family, model)
    x = _x(seed=10)
    jq, js = jquant.quantize_pytree(params)
    jdeq = jquant.dequantize_pytree(jq, js, jnp.bfloat16)
    deq_sd = state_dict_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jdeq), family)
    fwd = tserving.build_serving_fn(model, "int8")
    for name, w in tquant.dequantize_pytree(fwd.sites).items():
        assert torch.equal(w.float(), deq_sd[f"{name}.weight"]), name
    deq = _port(family, seed=9)
    deq.load_state_dict(deq_sd)
    with torch.no_grad():
        unclamped = deq(torch.from_numpy(x), dtype=torch.bfloat16)
    assert torch.equal(fwd(torch.from_numpy(x)), unclamped.clamp(0, 1))
    want = np.asarray(fn(jdeq, x, dtype=jnp.bfloat16))
    d = np.abs(unclamped.numpy() - want)
    assert d.max() <= 2.0 ** -5 * np.abs(want).max() and d.mean() <= 2.0 ** -8 * np.abs(
        want).max(), (d.max(), d.mean(), np.abs(want).max())


@pytest.mark.parametrize("planted", ["bias", "scale"])
def test_a_tiled_repeat_in_the_packed_conv_last_is_rejected(planted, monkeypatch):
    """The head's subpixel conv_last repeats conv_last's bias and scale
    channel-major (``jnp.repeat`` = ``repeat_interleave``). Planting the
    tiling ``repeat(4)`` for one of them puts the f32 calibrated forward
    far outside the limit of `test_int8_full_forward_matches_jax`."""
    model = _port("transfer", seed=11)
    fn, params = _jax_model("transfer", model)
    x = _x(seed=12)
    stats_x = jnp.asarray(x)
    sites = tserving.calibrated_qparams(model, x, max_batch=2)
    jtree = jax_qtree_from_sites(model, sites)
    want = np.asarray(fn(jax.tree.map(jnp.asarray, jtree), stats_x))
    with torch.no_grad():
        good = model(torch.from_numpy(x), quant=sites).numpy()
    assert np.abs(good - want).max() <= 1e-5 * np.abs(want).max()
    target = (model.face_head.conv_last.bias if planted == "bias"
              else sites["face_head.conv_last"].scale)
    real = torch.Tensor.repeat_interleave

    def tiled(self, repeats, *args, **kwargs):
        if self is target:
            return self.repeat(repeats)
        return real(self, repeats, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "repeat_interleave", tiled)
    fresh = {k: tquant.Int8Weight(w.q, w.scale, w.a) for k, w in sites.items()}
    if planted == "scale":
        target = fresh["face_head.conv_last"].scale
    with torch.no_grad():
        bad = model(torch.from_numpy(x), quant=fresh).numpy()
    assert np.abs(bad - want).max() > 1e-3 * np.abs(want).max()


def test_weight_only_int8_transfer_head_runs_the_kernel_once_on_its_own_weights(monkeypatch):
    """At the kernel's width the weight-only int8 transfer forward takes
    the group kernel (here its plain version, one call a forward) on the
    served copy's dequantized weights, not on the original model's cached
    kernel-layout weights."""
    model = _port("transfer", seed=13, backbone_blocks=1, head_blocks=2,
                  head_channels=tgroup.KERNEL_CHANNELS)
    x = torch.from_numpy(_x(seed=14))
    with torch.inference_mode(False), torch.no_grad():
        bf16 = model(x, dtype=torch.bfloat16)  # fills the original's kernel cache
    calls = []
    real = tgroup.rcab_group_reference
    monkeypatch.setattr(tgroup, "rcab_group_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    fwd = tserving.build_serving_fn(model, "int8")
    got = fwd(x)
    assert len(calls) == 1
    deq = _port("transfer", seed=13, backbone_blocks=1, head_blocks=2,
                head_channels=tgroup.KERNEL_CHANNELS)
    with torch.no_grad():
        for name, w in tquant.dequantize_pytree(fwd.sites).items():
            deq.get_parameter(f"{name}.weight").copy_(w)
        want = deq(x, dtype=torch.bfloat16)
        plain = deq(x, dtype=torch.bfloat16, head_fn=ttr.plain_head)
        zero = deq(x, dtype=torch.bfloat16, head_fn=lambda h, f: f)
    assert torch.equal(got, want.clamp(0, 1)) and not torch.equal(got, bf16.clamp(0, 1))
    # the kernel head against the plain head on the same weights, unclamped:
    # phase 4's share of the head's own effect on the output
    ref, d = (plain - zero).abs(), (want - plain).abs()
    assert d.max() <= 2.0 ** -5 * ref.max() and d.mean() <= 2.0 ** -5 * ref.mean(), (
        d.max(), ref.max(), d.mean(), ref.mean())


# ---------------------------------------------------------------------------
# QAT


class _L1Loss:
    """The Trainer's loss interface around a plain L1 (JAX's step loss)."""

    params: dict = {}

    def to(self, device):
        return self

    def apply(self, loss_params, sr, hr, **kw):
        loss = (sr - hr).abs().mean()
        return loss, {"l1": loss}


def _record_jax_levels(monkeypatch):
    """{HWIO kernel bytes: (kernel levels, activation levels, conv output)}
    of every fake-quant conv that JAX runs from now on (the grids and the
    result of `facesr.ops.conv._conv2d_fakequant`, computed in the same jit
    by the same expressions and read through a debug callback, so the
    blocks' scan yields one entry a block)."""
    from facesr.ops import conv as jconv

    seen, real = {}, jconv._conv2d_fakequant

    def record(kernel, wl, lv, y):
        seen[np.asarray(kernel).tobytes()] = (np.array(wl), np.array(lv), np.array(y))

    def recording(x, w, b, stride, padding, feature_group_count, dtype):
        wf = w["fq"].astype(jnp.float32)
        s = jnp.max(jnp.abs(wf), axis=(0, 1, 2), keepdims=True) / 127.0
        s = jnp.where(s == 0, 1.0, s)
        xf = (x.astype(dtype) if dtype is not None else x).astype(jnp.float32)
        if "a" in w:
            a = w["a"]
        else:
            a = jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True) / 127.0
            a = jnp.where(a == 0, 1.0, a)
        y = real(x, w, b, stride, padding, feature_group_count, dtype)
        jax.debug.callback(record, w["fq"], jnp.clip(jnp.round(wf / s), -127, 127),
                           jnp.clip(jnp.round(xf / a), -127, 127), y)
        return y

    monkeypatch.setattr(jconv, "_conv2d_fakequant", recording)
    return seen


def _jax_level_of(seen):
    """`step_numerics.fake_quant_levels`'s reference: JAX's (kernel
    levels, activation levels, output) of the site whose latent OIHW
    kernel is ``w``."""
    def of(i, w):
        wl, lv, y = seen[w.detach().permute(2, 3, 1, 0).contiguous().numpy().tobytes()]
        return torch.from_numpy(wl).permute(3, 2, 0, 1), torch.from_numpy(lv), torch.from_numpy(y)
    return of


@pytest.mark.parametrize("seed", [15, 21, 27])
@pytest.mark.parametrize("family", FAMILIES)
def test_a_qat_step_matches_the_jax_fake_quant_step(family, seed, tmp_path, monkeypatch):
    """A Trainer step with ``qat`` (every site fake-quantized, frozen
    transfer parameters too; stage 2 trains the head, the body's tail and
    conv_body) against JAX's step on ``fake_quant_params`` of the whole
    tree with the stage's labels, on three seeds: the gradient of every
    tensor normwise within 1e-5 of ``jax.grad`` (FaceEnhanceNet's limit) beyond the
    two packages' own difference in the float step's gradient of that
    tensor (the same weights and batch, no fake-quant: conv_last's bias
    gradient under L1 is a near-cancelling sum of +-1/N, which the two
    sum in other orders, ~1.1e-5 on seeds 21 and 27), the updated
    parameters within 1e-5 relative L2 per tensor, the frozen ones
    bitwise. At lr 1e-4 (the transfer stages train at 2e-5 to 2e-4):
    Adam's first step moves an element by lr times its gradient's sign,
    so a near-zero gradient of the other sign in one package moves it 2 lr
    the other way.

    The packages' convs sum, and XLA's jit divides, in other orders, so a
    kernel weight or an activation whose quotient lies within an ulp of a
    level boundary (k + 1/2) may round to k in one and k + 1 in the other
    (seed 21: a weight at -8.5 in the transfer model), and that one level
    spreads through every later site. So the port takes JAX's level at
    such a tie, and JAX's sign at a conv output within an ulp of zero
    (`fake_quant_levels`; counted, at most 1e-4 of the levels), and any
    level or sign that differs away from a tie fails the test."""
    levels = _record_jax_levels(monkeypatch)
    model = _port(family, seed=seed).train()
    params = jax_params_from(model)
    hr = np.random.default_rng(seed + 1).random((2, 32, 32, 3), dtype=np.float32)
    lr, kw = 1e-4, dict(weight_decay=1e-2, gradient_clip=0.0)
    if family == "transfer":
        stage = tr.TrainingStage.STAGE2_PARTIAL_FINETUNE
        model.set_training_stage(ttr.TrainingStage[stage.name])
        labels = jax.tree.map(lambda lab: "frozen" if lab == "frozen" else "train",
                              tr.param_labels(params, stage))
        cfg, apply = tr.TransferModelConfig(**TRANSFER), tr.apply
        port_labels = ttr.param_labels(model, ttr.TrainingStage[stage.name])
    else:
        labels = None
        cfg, apply = esr.RRDBNetConfig(**ESRGAN), esr.apply
        port_labels = {k: "train" for k in model.state_dict()}
    tx = jsteps.make_optimizer(param_labels=labels, **kw)
    lr_img = jbicubic_down(jnp.asarray(hr), 4)

    def step(p):
        def loss_fn(q, wrap):
            return jnp.mean(jnp.abs(apply(wrap(q), lr_img, cfg, train=True) - hr))

        grads = jax.grad(loss_fn)(p, jquant.fake_quant_params)
        updates, _ = tx.update(grads, jsteps.set_learning_rate(tx.init(p), lr), p)
        return grads, optax.apply_updates(p, updates), jax.grad(loss_fn)(p, lambda q: q)

    jgrads, jparams, jfloat = jax.jit(step)(jax.tree.map(jnp.asarray, params))
    jgrads, want, jfloat = (state_dict_from_jax(jax.tree.map(np.asarray, t), family)
                            for t in (jgrads, jparams, jfloat))

    def port_grads(qat):
        """The port's gradient of every tensor, frozen ones included, on a copy."""
        probe = copy.deepcopy(model)
        for p in probe.parameters():
            p.requires_grad_(True)
        with tconv.full_f32():
            sr = probe(bicubic_down(torch.from_numpy(hr), 4), train=True,
                       quant=tquant.fake_quant_params(probe) if qat else None)
            (sr - torch.from_numpy(hr)).abs().mean().backward()
        return {k: p.grad for k, p in probe.named_parameters()}

    def normwise(got, ref, k):
        return ((got[k] - ref[k]).abs().max() / ref[k].abs().max()).item()

    floor = port_grads(qat=False)
    with fake_quant_levels(_jax_level_of(levels)) as pin:
        grads = port_grads(qat=True)
    n_levels = sum(lv.numel() for lv in pin["levels"])
    assert pin["off_tie"] == 0 and pin["ties"] <= 1e-4 * n_levels, (
        pin["off_tie"], pin["ties"], n_levels)
    for k in grads:
        err, own = normwise(grads, jgrads, k), normwise(floor, jfloat, k)
        assert err <= 1e-5 + own, f"gradient {k}: normwise {err:.3g} (float step {own:.3g})"

    trainer = Trainer(model, [], [], _L1Loss(), TrainerConfig(
        use_amp=False, checkpoint_dir=str(tmp_path), learning_rate=lr, qat=True, **kw),
        device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with fake_quant_levels(_jax_level_of(levels)) as pin:
        trainer._train_step(trainer.state, torch.from_numpy(hr))
    assert pin["off_tie"] == 0 and pin["ties"] <= 1e-4 * n_levels
    frozen = 0
    for k, v in model.state_dict().items():
        if port_labels[k] == "frozen":
            frozen += 1
            assert torch.equal(v, before[k]), f"frozen {k} moved"
            continue
        rel = (v - want[k]).norm() / want[k].norm()
        assert rel <= 1e-5, f"{k}: relative L2 {rel:.3g}"
        assert not torch.equal(v, before[k]), f"{k} did not train"
    assert (frozen > 0) == (family == "transfer")


@pytest.mark.parametrize("kind,stage", [("transfer", 2), ("esrgan", 1)])
def test_the_small_qat_step_pinned_at_ties_across_conv_orders(kind, stage):
    """`step_numerics.small_zoo_step` with ``qat`` (the step that
    `chip_smoke.py` holds on the card against the CPU) run with its convs
    summed in two orders, oneDNN on and off, as a card and the CPU differ:
    with the second run taking the first's level or sign at each tie
    (`fake_quant_levels`), the loss, every gradient and every parameter
    agree within 1e-4 relative L2 and nothing differs away from a tie;
    where no tie occurs, pinning changes nothing. (Unpinned, one tie
    spreads: one at the transfer head's conv_after input moved ~800
    levels of the upsample and conv_last, and the step by ~1e-2.)"""
    with torch.backends.mkldnn.flags(enabled=True), fake_quant_levels() as first:
        want, _ = small_zoo_step("cpu", kind, stage, qat=True)
    with torch.backends.mkldnn.flags(enabled=False):
        free, _ = small_zoo_step("cpu", kind, stage, qat=True)
        with fake_quant_levels(lambda i, w: (first["weights"][i], first["levels"][i],
                                             first["outputs"][i])) as pin:
            got, _ = small_zoo_step("cpu", kind, stage, qat=True)
    assert pin["off_tie"] == 0 and max(step_errors(got, want)) <= 1e-4, (
        pin, step_errors(got, want), step_errors(free, want))
    if pin["ties"] == 0:
        assert step_errors(got, free) == (0.0, 0.0, 0.0)
