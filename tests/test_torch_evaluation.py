"""The port's evaluation metrics and their helpers against the JAX package
and cv2 on the same seeded inputs: PSNR, skimage-compatible PSNR/SSIM,
SSIM, the dataset evaluator, the unavailable LPIPS/FID paths, the cv2
resize copies of the baselines, the weights resolver and the `.fckpt`
writer."""

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp

from facesr.ckpt import checkpoint as jckpt
from facesr.ckpt.weights import resolve_weights_path as jax_resolve
from facesr.evaluation import metrics as jmetrics
from facesr.evaluation import skimage_compat as jsk
from facesr.ops.resize import bicubic_up as jax_bicubic_up
from facesr_torch.ckpt import fckpt, resolve
from facesr_torch.data import cv_compat
from facesr_torch.evaluation import metrics, skimage_compat, visualize
from facesr_torch.ops.resize import bicubic_up

torch.set_num_threads(1)


def _pair(seed, shape=(2, 24, 20, 3)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, shape).astype(np.float32), 0, 1)
    return a, b


@pytest.mark.parametrize("exact", [False, True])
def test_psnr_and_psnr_batch_match_jax_including_inf(exact):
    a, b = _pair(0)
    if exact:
        b = b.copy()
        b[1] = a[1]  # image 1 matches exactly: inf
    got = metrics.psnr_batch(torch.from_numpy(b), torch.from_numpy(a)).numpy()
    want = np.asarray(jmetrics.psnr_batch(jnp.asarray(b), jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)
    assert np.isinf(got[1]) == exact
    got1 = float(metrics.PSNR()(torch.from_numpy(b), torch.from_numpy(a)))
    want1 = float(jmetrics.psnr(jnp.asarray(b), jnp.asarray(a)))
    assert abs(got1 - want1) <= 1e-5
    assert float(metrics.psnr(torch.from_numpy(a), torch.from_numpy(a))) == float("inf")


def test_ssim_metric_matches_jax():
    a, b = _pair(1, (2, 32, 32, 3))
    got = float(metrics.SSIM()(torch.from_numpy(b), torch.from_numpy(a)))
    want = float(jmetrics.SSIM()(jnp.asarray(b), jnp.asarray(a)))
    assert abs(got - want) <= 1e-5


def _uint8_pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.integers(-20, 21, shape)
    return a, np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape,kwargs", [
    ((64, 48, 3), {"channel_axis": -1}),
    ((3, 40, 33), {"channel_axis": 0}),
    ((30, 31), {}),
    ((256, 256, 3), {"channel_axis": -1}),
    ((20, 20, 3), {"channel_axis": -1, "win_size": 5}),
])
def test_skimage_psnr_ssim_match_jax(shape, kwargs):
    a, b = _uint8_pair(sum(shape), shape)
    got = skimage_compat.structural_similarity(a, b, data_range=255, **kwargs)
    want = jsk.structural_similarity(a, b, data_range=255, **kwargs)
    assert abs(got - want) <= 1e-9, (got, want)
    p_got = skimage_compat.peak_signal_noise_ratio(a, b, data_range=255)
    assert abs(p_got - jsk.peak_signal_noise_ratio(a, b, data_range=255)) <= 1e-9
    assert skimage_compat.peak_signal_noise_ratio(a, a) == float("inf")
    assert skimage_compat.structural_similarity(a, a, data_range=255, **kwargs) == \
        pytest.approx(1.0, abs=1e-12)


@pytest.mark.parametrize("args,kwargs", [
    (((8, 8, 3),), {}),                                   # 3-D without channel_axis
    (((16, 16, 3),), {"channel_axis": -1, "win_size": 6}),  # even window
    (((16, 16, 3),), {"channel_axis": -1, "win_size": 1}),  # window below 3
    (((5, 9, 3),), {"channel_axis": -1}),                 # smaller than the window
    (((3, 6, 40),), {"channel_axis": 0}),                 # CHW measured on H, W
])
def test_skimage_ssim_guards_raise_like_jax(args, kwargs):
    a, b = _uint8_pair(3, args[0])
    with pytest.raises(ValueError) as got:
        skimage_compat.structural_similarity(a, b, data_range=255, **kwargs)
    with pytest.raises(ValueError) as want:
        jsk.structural_similarity(a, b, data_range=255, **kwargs)
    assert str(got.value) == str(want.value)


_CV2 = {"linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC,
        "lanczos4": cv2.INTER_LANCZOS4, "nearest": cv2.INTER_NEAREST}


@pytest.mark.parametrize("interp", ["linear", "cubic", "lanczos4", "nearest"])
def test_baseline_resizes_against_cv2(interp):
    """The baselines' 64->256 RGB upscale (and a few other sizes) against
    cv2: every copy is exact (the per-case counts are printed)."""
    rng = np.random.default_rng(11)
    counts = []
    for shape, size in (((64, 64, 3), (256, 256)), ((64, 64, 3), (256, 256)),
                        ((37, 50, 3), (200, 148)), ((64, 64), (256, 256)),
                        ((48, 40, 3), (12, 10))):
        smooth = cv2.resize((rng.random((8, 8) + shape[2:]) * 255).astype(np.uint8),
                            shape[1::-1], interpolation=cv2.INTER_CUBIC)
        img = np.clip(smooth.astype(int) + rng.integers(-30, 31, smooth.shape), 0, 255)
        img = img.astype(np.uint8).reshape(shape)
        want = cv2.resize(img, size, interpolation=_CV2[interp])
        got = cv_compat.resize(img, size, interp)
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want)
        counts.append(int((diff > 0).sum()))
        assert diff.max() <= 1
    print(f"{interp}: values differing from cv2 per case {counts}")
    assert sum(counts) == 0


def test_resize_rejects_what_it_cannot_do():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError):
        cv_compat.resize(img, (8, 8), "area")
    with pytest.raises(ValueError):
        cv_compat.resize_linear(img.astype(np.float32), (8, 8))
    with pytest.raises(ValueError):
        cv_compat.resize_lanczos4(img, (0, 8))


def test_evaluate_dataset_matches_jax_aggregation_and_refuses_zero_batches():
    rng = np.random.default_rng(5)
    hr = rng.random((5, 32, 32, 3), dtype=np.float32)
    lr = np.clip(hr[:, ::4, ::4] + rng.normal(0, 0.02, (5, 8, 8, 3)).astype(np.float32), 0, 1)
    batches = [{"lr": lr[:2], "hr": hr[:2]}, {"lr": lr[2:4], "hr": hr[2:4]},
               {"lr": lr[4:], "hr": hr[4:]}]  # ragged last batch
    calc = metrics.MetricCalculator()
    assert not calc.lpips.available
    got = calc.evaluate_dataset(lambda x: bicubic_up(x, 4), batches)
    want = jmetrics.MetricCalculator().evaluate_dataset(lambda x: jax_bicubic_up(x, 4), batches)
    assert set(got) == set(want) == {"psnr_mean", "psnr_std", "ssim_mean", "ssim_std"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    with pytest.raises(RuntimeError, match="zero batches"):
        calc.evaluate_dataset(lambda x: x, [])


def test_lpips_and_fid_unavailable_without_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("FACESR_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("FACESR_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.setattr(resolve, "WEIGHTS_DIR", tmp_path)
    lp = metrics.LPIPS()
    assert not lp.available and float(lp(torch.zeros(1, 8, 8, 3), torch.ones(1, 8, 8, 3))) == 0.0
    imgs = [np.zeros((16, 16, 3), np.uint8)] * 2
    assert metrics.compute_fid(imgs, imgs) == -1.0
    monkeypatch.setenv("FACESR_LPIPS_WEIGHTS", str(tmp_path / "missing.fckpt"))
    with pytest.raises(FileNotFoundError):
        metrics.LPIPS()


def test_resolve_weights_path_follows_jax(monkeypatch, tmp_path):
    present = tmp_path / "w.fckpt"
    present.write_bytes(b"x")
    monkeypatch.setenv("FACESR_TEST_WEIGHTS", str(present))
    assert resolve.resolve_weights_path("FACESR_TEST_WEIGHTS", "n") == \
        jax_resolve("FACESR_TEST_WEIGHTS", "n") == str(present)
    monkeypatch.setenv("FACESR_TEST_WEIGHTS", str(tmp_path / "gone"))
    for fn in (resolve.resolve_weights_path, jax_resolve):
        with pytest.raises(FileNotFoundError):
            fn("FACESR_TEST_WEIGHTS", "n")
    monkeypatch.delenv("FACESR_TEST_WEIGHTS")
    monkeypatch.setattr(resolve, "WEIGHTS_DIR", tmp_path)
    assert resolve.resolve_weights_path("FACESR_TEST_WEIGHTS", "w.fckpt") == str(present)
    assert resolve.resolve_weights_path("FACESR_TEST_WEIGHTS", "absent.fckpt") is None


def _tree(rng):
    return {
        "params": {"b": rng.standard_normal((3, 4)).astype(np.float32),
                   "a": [np.arange(5, dtype=np.int64),
                         {"z": np.float32(2.5), "y": rng.standard_normal(40).astype(np.float16)}]},
        "step": 7, "lr": 1e-4, "flag": True, "neg": -300, "big": 2 ** 40,
        "empty": np.zeros((0, 3), np.uint8), "long": np.ones(70000, np.float64),
        "nested": {str(i): np.full(2, i, np.int32) for i in range(20)},
    }


def test_fckpt_writer_equals_the_jax_writer_and_reads_back(tmp_path):
    rng = np.random.default_rng(0)
    tree, meta = _tree(rng), {"model_type": "custom", "config": {"num_channels": 16}}
    fckpt.save_checkpoint(str(tmp_path / "port.fckpt"), tree, meta)
    jckpt.save_checkpoint(str(tmp_path / "jax.fckpt"), tree, meta)
    assert (tmp_path / "port.fckpt").read_bytes() == (tmp_path / "jax.fckpt").read_bytes()
    for loader in (jckpt.load_checkpoint, fckpt.load_checkpoint):
        back, m = loader(str(tmp_path / "port.fckpt"))
        assert m == meta
        assert np.array_equal(back["params"]["b"], tree["params"]["b"])
        assert np.asarray(back["params"]["b"]).dtype == np.float32
        assert np.array_equal(np.asarray(back["params"]["a"]["1"]["y"]
                                         if isinstance(back["params"]["a"], dict)
                                         else back["params"]["a"][1]["y"]), tree["params"]["a"][1]["y"])
        assert int(np.asarray(back["big"])) == 2 ** 40 and bool(np.asarray(back["flag"]))
    bf = {"w": torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    fckpt.save_checkpoint(str(tmp_path / "bf.fckpt"), bf)
    back, _ = jckpt.load_checkpoint(str(tmp_path / "bf.fckpt"))
    assert str(back["w"].dtype) == "bfloat16"
    assert np.array_equal(np.asarray(back["w"], np.float32), bf["w"].float().numpy())
    assert torch.equal(fckpt.load_checkpoint(str(tmp_path / "bf.fckpt"))[0]["w"], bf["w"])


def test_fckpt_writer_refuses_arrays_flax_would_chunk(monkeypatch, tmp_path):
    """flax writes an array above its chunk size in chunks; the port's
    writer raises instead of writing a file the JAX writer would not (the
    limit lowered so the test stays small)."""
    monkeypatch.setattr(fckpt, "_MAX_CHUNK_BYTES", 1024)
    fckpt.save_checkpoint(str(tmp_path / "ok.fckpt"), {"x": np.zeros(256, np.float32)})
    with pytest.raises(fckpt.FckptError, match="chunk size"):
        fckpt.save_checkpoint(str(tmp_path / "big.fckpt"), {"x": np.zeros(257, np.float32)})
    with pytest.raises(fckpt.FckptError, match="cannot write"):
        fckpt.packb(object())


def test_visualize_ports_the_image_helpers_and_refuses_figures(tmp_path):
    from facesr.evaluation import visualize as jvis
    from facesr_torch.data.png import read_rgb

    x = np.random.default_rng(2).random((1, 3, 8, 6), dtype=np.float32)  # NCHW-ish
    assert np.array_equal(visualize.tensor_to_image(torch.from_numpy(x)),
                          jvis.tensor_to_image(x))
    hwc = x[0].transpose(1, 2, 0)
    visualize.save_sr_result(hwc, str(tmp_path / "sr.png"))
    jvis.save_sr_result(hwc, str(tmp_path / "jax_sr.png"))
    assert np.array_equal(read_rgb(tmp_path / "sr.png"), read_rgb(tmp_path / "jax_sr.png"))
    table = {"Bicubic": {"psnr": 25.0, "ssim": 0.7}, "Model": {"psnr_mean": 27.5, "ssim": 0.8}}
    assert visualize.create_metrics_table(table) == jvis.create_metrics_table(table)
    for name in ("create_comparison_grid", "create_zoom_comparison", "plot_training_curves"):
        with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
            getattr(visualize, name)({})
