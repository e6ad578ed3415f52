"""The port's RRDBNet / ESRGANBaseline (facesr_torch.models.esrgan) against
the JAX package's on the same weights, carried over as numpy, on the CPU:
the forward in f32 and bf16, `nearest_up`, the weight functions both ways,
`.pth` and `.fckpt` files read by the other package, and the local-only
weight resolution of ESRGANBaseline."""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facesr.ckpt import checkpoint as jckpt
from facesr.ckpt.convert import convert_pth
from facesr.models import esrgan as esr
from facesr.models.load import load_any_model as jax_load_any_model
from facesr.ops import nearest_up as jax_nearest_up
from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt.weights import (esrgan_state_dict_from_jax_params,
                                       jax_params_from_esrgan_state_dict, save_reference_pth)
from facesr_torch.models import esrgan as tesr
from facesr_torch.models.load import load_any_model
from facesr_torch.ops.resize import nearest_up

torch.set_num_threads(1)

SMALL = dict(num_feat=16, num_blocks=2, num_grow_ch=8)  # the JAX tests' SMALL_RRDB


def _params(seed=0):
    """(JAX config, JAX params as numpy) of a seeded port model, every
    parameter moved off its init by seeded noise (so the zero biases
    count). The JAX tree comes through the port's weight function, held
    to JAX's own layout by `test_param_tree_has_the_jax_layout` and to
    JAX's exporter by `test_state_dict_keys_are_the_reference_layout`
    (the JAX package's eager init takes seconds)."""
    model = tesr.RRDBNet(tesr.RRDBNetConfig(**SMALL), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return esr.RRDBNetConfig(**SMALL), jax_params_from_esrgan_state_dict(model.state_dict())


def test_param_tree_has_the_jax_layout():
    want = jax.eval_shape(lambda k: esr.init(k, esr.RRDBNetConfig(**SMALL)),
                          jax.random.PRNGKey(0))
    _, got = _params()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(got)] == [
        (b.shape, b.dtype) for b in jax.tree.leaves(want)]


def _port(params):
    model = tesr.RRDBNet(tesr.RRDBNetConfig(**SMALL), device="cpu")
    model.load_state_dict(esrgan_state_dict_from_jax_params(params), strict=True)
    return model.eval()


def _x(seed=1, n=2, size=16):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


def _jax_forward(cfg, params, x, dtype=None):
    return np.asarray(esr.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg,
                                dtype=dtype))


def test_f32_forward_matches_jax():
    cfg, params = _params()
    x = _x()
    want = _jax_forward(cfg, params, x)
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 64, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_bf16_forward_matches_jax():
    """Both run every conv and dense concatenation in bf16, but round at
    other points: JAX's weakly typed ``x + 0.2 * x5`` may fuse and round
    once where torch rounds the product and then the sum, and the convs
    sum in other orders; 69 such residual adds compound over the body.
    Measured here: max 0.57% of max|ref|, mean 0.08%."""
    cfg, params = _params(seed=2)
    x = _x(seed=3)
    want = _jax_forward(cfg, params, x, dtype=jnp.bfloat16)
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x), dtype=torch.bfloat16).numpy()
    assert got.dtype == np.float32
    d = np.abs(got - want)
    assert d.max() <= 2.0 ** -5 * np.abs(want).max()
    assert d.mean() <= 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("scale", [2, 4])
def test_nearest_up_is_bitwise_jax(scale):
    x = np.random.default_rng(scale).standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax_nearest_up(jnp.asarray(x), scale))
    got = nearest_up(torch.from_numpy(x), scale).numpy()
    assert np.array_equal(got, want)


def test_weight_functions_round_trip_bitwise():
    _, params = _params(seed=4)
    sd = esrgan_state_dict_from_jax_params(params)
    back = jax_params_from_esrgan_state_dict(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back),
                                                    jax.tree.leaves(params)))
    again = esrgan_state_dict_from_jax_params(back)
    assert sd.keys() == again.keys() and all(torch.equal(sd[k], again[k]) for k in sd)
    # the per-block layout of a legacy save reads the same
    per_block = dict(params, body=[jax.tree.map(lambda a: a[i], params["body"])
                                   for i in range(SMALL["num_blocks"])])
    assert all(torch.equal(sd[k], v) for k, v in
               esrgan_state_dict_from_jax_params(per_block).items())


def test_state_dict_keys_are_the_reference_layout():
    """The RealESRGAN names, exactly those the JAX converter reads."""
    from facesr.ckpt.export_torch import export_rrdbnet_state_dict

    _, params = _params()
    want = export_rrdbnet_state_dict(params)
    model = _port(params)
    assert set(model.state_dict()) == set(want)
    assert all(np.array_equal(model.state_dict()[k].numpy(), v) for k, v in want.items())


def test_port_pth_and_fckpt_read_by_jax(tmp_path):
    _, params = _params(seed=5)
    model = _port(params)
    x = _x(seed=6)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    save_reference_pth(str(tmp_path / "m.pth"), model)
    convert_pth(str(tmp_path / "m.pth"), str(tmp_path / "conv.fckpt"), kind="rrdbnet")
    fckpt.save_model(str(tmp_path / "port.fckpt"), model)
    for name in ("conv.fckpt", "port.fckpt"):
        jm = jax_load_any_model(str(tmp_path / name))
        assert isinstance(jm, esr.RRDBNet) and jm.config == esr.RRDBNetConfig(**SMALL)
        assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(jm.params),
                                                        jax.tree.leaves(params)))
        got = np.asarray(jm(jnp.asarray(x)))
        assert np.abs(got - ours).max() <= 1e-5 * np.abs(ours).max()


def test_jax_written_files_load_in_the_port(tmp_path):
    from facesr.ckpt.export_torch import export_pth

    cfg, params = _params(seed=7)
    jckpt.save_model(str(tmp_path / "j.fckpt"), params, cfg, "esrgan")
    export_pth(str(tmp_path / "j.fckpt"), str(tmp_path / "j.pth"))
    want = _port(params).state_dict()
    for name in ("j.fckpt", "j.pth"):
        model = load_any_model(tmp_path / name, device="cpu")
        assert type(model) is tesr.RRDBNet and model.config == tesr.RRDBNetConfig(**SMALL)
        assert all(torch.equal(model.state_dict()[k], v) for k, v in want.items())


def test_fckpt_without_config_infers_it(tmp_path):
    _, params = _params(seed=8)
    jckpt.save_checkpoint(str(tmp_path / "bare.fckpt"), {"params": params},
                          {"model_type": "esrgan"})
    cfg, sd = fckpt.load_model(str(tmp_path / "bare.fckpt"))
    assert cfg == tesr.RRDBNetConfig(**SMALL)
    assert sd.keys() == esrgan_state_dict_from_jax_params(params).keys()


def test_param_count_of_x4plus_matches_jax():
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax.eval_shape(lambda k: esr.init(k), jax.random.PRNGKey(0))))
    assert tesr.param_count(tesr.RRDBNet(device="cpu")) == want == 16_697_987


def test_scale_other_than_4_raises():
    with pytest.raises(ValueError, match="scale=4 only"):
        tesr.RRDBNet(tesr.RRDBNetConfig(scale=2), device="cpu")


@pytest.fixture()
def no_network(monkeypatch):
    """Any socket the code opens raises."""
    def refuse(*a, **k):
        raise AssertionError("a socket was opened")

    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


def test_baseline_resolves_local_weights_only(tmp_path, no_network, capsys):
    _, params = _params(seed=9)
    model = _port(params)
    wdir = tmp_path / "pretrained"
    wdir.mkdir()
    save_reference_pth(str(wdir / "tiny.pth"), model)
    base = tesr.ESRGANBaseline(model_name="tiny", weights_dir=str(wdir), device="cpu")
    assert base.pretrained and (wdir / "tiny.fckpt").exists()
    assert all(torch.equal(base.state_dict()[k], v) for k, v in model.state_dict().items())
    again = tesr.ESRGANBaseline(model_name="tiny", weights_dir=str(wdir), device="cpu")
    assert again.pretrained  # from the cached .fckpt now
    img = (np.random.default_rng(0).random((16, 16, 3)) * 255).astype(np.uint8)
    out = base.inference(img)
    with torch.inference_mode():
        raw = base(torch.from_numpy(img[None].astype(np.float32) / 255.0)).numpy()[0]
    assert raw.min() >= 0 and raw.max() <= 1  # the baseline's eval forward clamps
    assert out.dtype == np.uint8 and np.array_equal(out, (raw * 255).round().astype(np.uint8))
    # a batch of 2 may take another CPU conv algorithm: a level either way
    batch = base.inference_batch(np.stack([img, img]))
    assert batch.shape == (2, 64, 64, 3) and np.abs(batch[1].astype(int) - out).max() <= 1


def test_baseline_without_weights_warns_and_runs_random(tmp_path, no_network, capsys):
    base = tesr.ESRGANBaseline(model_name="absent", weights_dir=str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert not base.pretrained and "does not download" in out and "randomly" in out
    assert base.config == tesr.RRDBNetConfig()
    with torch.no_grad():
        y = base(torch.rand(1, 4, 4, 3))
    assert y.shape == (1, 16, 16, 3) and y.min() >= 0 and y.max() <= 1


def test_a_bad_pth_is_quarantined(tmp_path, no_network, capsys):
    (tmp_path / "bad.pth").write_bytes(b"<html>not a state dict</html>")
    base = tesr.ESRGANBaseline(model_name="bad", weights_dir=str(tmp_path), device="cpu",
                               scale=4)
    assert not base.pretrained and (tmp_path / "bad.pth.bad").exists()
    assert not (tmp_path / "bad.pth").exists() and "quarantined" in capsys.readouterr().out


def test_int8_serving_of_the_zoo_raises_and_names_its_item():
    """Ported since the zoo's int8 (this test asserted its refusal before):
    an RRDBNet serves in int8 and int8_full through build_serving_fn and
    Predictor, the two agree, and an empty site map is the float forward.
    tests/test_torch_zoo_int8.py holds the int8 forwards against JAX."""
    from facesr_torch.parallel.serving import Predictor, build_serving_fn

    _, params = _params()
    model = _port(params)
    x = _x(seed=4, size=8)
    for dtype in ("int8", "int8_full"):
        fwd = build_serving_fn(model, dtype)
        with torch.no_grad():
            want = fwd(torch.from_numpy(x)).numpy()
        assert want.shape == (2, 32, 32, 3) and np.isfinite(want).all()
        assert len(fwd.sites) == 2 * 15 + 6
        np.testing.assert_array_equal(Predictor(model, dtype=dtype, device="cpu")(x), want)
    with torch.no_grad():
        xt = torch.rand(1, 4, 4, 3)
        assert torch.equal(model(xt, quant={}), model(xt))
