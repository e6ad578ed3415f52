"""The port's LPIPS and FID-InceptionV3 against the JAX package on the same
weights (carried across by `lpips_params_from_jax` /
`inception_params_from_jax`, or written by the port's `.fckpt` writer and
read by the JAX loaders) and the same seeded inputs, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from facesr.evaluation import fid as jfid
from facesr.evaluation import metrics as jmetrics
from facesr.models import inception as jinception
from facesr.models import lpips as jlpips
from facesr_torch.ckpt.weights import inception_params_from_jax, lpips_params_from_jax
from facesr_torch.evaluation import fid, metrics
from facesr_torch.models import inception, lpips

torch.set_num_threads(1)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_lpips():
    """LPIPS weights in the JAX layout (conv HWIO) from a numpy seed, with
    non-zero biases."""
    rng = np.random.default_rng(0)
    convs, in_ch = [], 3
    for out_ch, k, _, _ in jlpips._ALEX_CONVS:
        convs.append({"w": (rng.standard_normal((k, k, in_ch, out_ch))
                            * np.sqrt(2.0 / (k * k * in_ch))).astype(np.float32),
                      "b": (rng.standard_normal(out_ch) * 0.05).astype(np.float32)})
        in_ch = out_ch
    lins = [{"w": (rng.random((p["w"].shape[-1], 1)) * 0.1).astype(np.float32)} for p in convs]
    return {"convs": convs, "lins": lins}


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    return a, np.clip(a + rng.normal(0, 0.1, shape).astype(np.float32), 0, 1)


def test_lpips_distance_matches_jax(jax_lpips):
    a, b = _pair(1, (2, 64, 64, 3))
    want = float(jlpips.lpips_distance(jax.tree.map(jnp.asarray, jax_lpips),
                                       jnp.asarray(a * 2 - 1), jnp.asarray(b * 2 - 1)))
    got = float(lpips.lpips_distance(lpips_params_from_jax(jax_lpips),
                                     torch.from_numpy(a * 2 - 1), torch.from_numpy(b * 2 - 1)))
    assert want > 0 and abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_lpips_weights_file_written_by_the_port_reads_in_both(tmp_path, monkeypatch):
    """The port's writer -> JAX's loader and the port's: the LPIPS metric
    classes agree, and both say so through the env var."""
    params = lpips.init_random_alexnet(torch.Generator().manual_seed(3))
    path = tmp_path / "lpips_alex.fckpt"
    lpips.save_lpips_weights(str(path), params)
    monkeypatch.setenv(lpips.ENV_WEIGHTS, str(path))
    port, jax_metric = metrics.LPIPS(), jmetrics.LPIPS()
    assert port.available and jax_metric.available
    a, b = _pair(2, (1, 64, 64, 3))
    got = float(port(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jax_metric(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    back = lpips.load_lpips_weights()
    for p, q in zip(back["convs"], params["convs"]):
        assert torch.equal(p["w"], q["w"]) and torch.equal(p["b"], q["b"])


@pytest.fixture(scope="module")
def jax_inception():
    """Inception weights in the JAX layout from a numpy seed: He-normal
    convs and a folded BatchNorm that is not the identity."""
    rng = np.random.default_rng(1)
    w = {}
    for name, (ic, oc, (kh, kw), _, _) in sorted(jinception.CONV_SPECS.items()):
        w[name] = {"w": (rng.standard_normal((kh, kw, ic, oc), np.float32)
                         * np.float32(np.sqrt(2.0 / (kh * kw * ic)))),
                   "scale": (1 + 0.1 * rng.standard_normal(oc)).astype(np.float32),
                   "bias": (0.1 * rng.standard_normal(oc)).astype(np.float32)}
    return w


def test_inception_num_params_and_specs_equal_jax():
    assert inception.num_params() == jinception.num_params()
    assert inception.CONV_SPECS == jinception.CONV_SPECS
    assert inception.BLOCKS == jinception.BLOCKS


def test_inception_forward_matches_jax_at_75(jax_inception):
    x = np.random.default_rng(5).random((2, 75, 75, 3), dtype=np.float32)
    want = np.asarray(jinception.apply(jax.tree.map(jnp.asarray, jax_inception),
                                       jnp.asarray(x), resize_input=False))
    got = inception.apply(inception_params_from_jax(jax_inception), torch.from_numpy(x),
                          resize_input=False).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert _rel_l2(got, want) <= 1e-5, _rel_l2(got, want)


def test_inception_activations_through_the_299_resize_match_jax(jax_inception):
    """One uint8 image through the grouped bilinear resize to 299 and the
    full-size network, and a grey image repeated to three channels."""
    rng = np.random.default_rng(6)
    imgs = [(rng.random((64, 64, 3)) * 255).astype(np.uint8)]
    want = jfid.inception_activations(imgs, jax.tree.map(jnp.asarray, jax_inception),
                                      batch_size=1)
    port_w = inception_params_from_jax(jax_inception)
    got = fid.inception_activations(imgs, port_w, batch_size=1, device="cpu")
    assert got.shape == (1, 2048) and _rel_l2(got, want) <= 1e-5, _rel_l2(got, want)
    grey = [imgs[0][..., 0], imgs[0][..., :1]]
    acts = fid.inception_activations(grey, port_w, batch_size=2, device="cpu")
    np.testing.assert_array_equal(acts[0], acts[1])


def test_inception_activations_need_a_device_or_the_card(jax_inception, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fid.inception_activations([np.zeros((8, 8, 3), np.uint8)],
                                  inception_params_from_jax(jax_inception))


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(40, 16))
    b = rng.normal(size=(30, 16)) * 1.3 + 0.2
    mu1, mu2 = a.mean(0), b.mean(0)
    s1, s2 = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    want = jfid.frechet_distance(mu1, s1, mu2, s2)
    assert abs(fid.frechet_distance(mu1, s1, mu2, s2) - want) <= 1e-9 * abs(want)
    want = jfid.fid_from_activations(a, b)
    assert abs(fid.fid_from_activations(a, b) - want) <= 1e-9 * abs(want)
    assert fid.fid_from_activations(a, a) < 1e-9


def test_fid_needs_two_images_a_set():
    rng = np.random.default_rng(8)
    one, many = rng.normal(size=(1, 8)), rng.normal(size=(16, 8))
    for x, y in ((one, many), (many, one)):
        with pytest.raises(ValueError, match=">=2 images"):
            fid.fid_from_activations(x, y)


def test_fid_from_images_through_the_env_var(tmp_path, monkeypatch):
    """Weights written by the port and found through the env var read back
    bitwise; two different sets give a finite FID above 0."""
    params = inception.init_random_inception(torch.Generator().manual_seed(4))
    path = tmp_path / "inception_fid.fckpt"
    inception.save_inception_weights(str(path), params)
    monkeypatch.setenv(inception.ENV_WEIGHTS, str(path))
    back = inception.load_inception_weights()
    assert all(torch.equal(back[n][k], params[n][k]) for n in params for k in params[n])
    rng = np.random.default_rng(9)
    real = [(rng.random((32, 32, 3)) * 255).astype(np.uint8) for _ in range(2)]
    fake = [np.clip(r.astype(int) + rng.integers(-40, 40, r.shape), 0, 255).astype(np.uint8)
            for r in real]
    diff = fid.fid_from_images(real, fake, batch_size=2, device="cpu")
    assert np.isfinite(diff) and diff > 0
