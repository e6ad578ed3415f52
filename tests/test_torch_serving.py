"""The port's serving layer (facesr_torch.parallel.serving) on the CPU, and
the port's independence from JAX."""

import ast
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.parallel.serving import (
    MicroBatcher, Predictor, SpatialPredictor, build_serving_fn, pad_to_multiple,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _model():
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                blocks_per_group=2), device="cpu")
    with torch.no_grad():  # a non-zero conv_last so the trunk shows in the output
        g = torch.Generator().manual_seed(0)
        model.conv_last.weight.copy_(torch.randn(model.conv_last.weight.shape,
                                                 generator=g) * 0.05)
    return model


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_predictor_chunks_and_pads_like_one_forward(dtype):
    model = _model()
    images = np.random.default_rng(0).random((6, 8, 8, 3), dtype=np.float32)
    pred = Predictor(model, dtype=dtype, max_batch=4, device="cpu")
    got = pred(images)
    assert got.shape == (6, 32, 32, 3) and got.dtype == np.float32
    with torch.no_grad():
        want = model(torch.from_numpy(images), dtype=dtype).clamp(0, 1).numpy()
    # images are independent of their batchmates; only CPU conv blocking
    # may differ between batch sizes
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got.min() >= 0 and got.max() <= 1


def test_predictor_forward_always_sees_max_batch():
    # chunks run at their true size: a 5-image request at max_batch 4 is a
    # forward of 4 and one of 1 (no padding to max_batch)
    seen = []
    model = _model()
    pred = Predictor(model, dtype=None, max_batch=4, device="cpu")
    inner = pred._forward
    pred._forward = lambda x: (seen.append(x.shape[0]), inner(x))[1]
    pred(np.zeros((5, 8, 8, 3), np.float32))
    assert seen == [4, 1]
    with pytest.raises(ValueError):
        pred(np.zeros((0, 8, 8, 3), np.float32))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_predictor_pipeline_equals_a_serial_run(dtype):
    # 11 images at max_batch 4: three chunks (4, 4, 3) through the depth-2
    # pipeline, each equal to a serial forward of the same chunk (bitwise:
    # the same computation at the same batch size)
    model = _model()
    images = np.random.default_rng(5).random((11, 8, 8, 3), dtype=np.float32)
    pred = Predictor(model, dtype=dtype, max_batch=4, device="cpu")
    seen = []
    inner = pred._forward
    pred._forward = lambda x: (seen.append(x.shape[0]), inner(x))[1]
    got = pred(images)
    assert seen == [4, 4, 3] and got.shape == (11, 32, 32, 3)
    with torch.no_grad():
        want = np.concatenate([
            model(torch.from_numpy(images[i:i + 4]), dtype=dtype).clamp(0, 1).float().numpy()
            for i in range(0, 11, 4)])
    np.testing.assert_array_equal(got, want)


def test_pad_to_multiple_repeats_last():
    a = np.arange(5)[:, None]
    padded, valid = pad_to_multiple(a, 4)
    assert valid == 5 and padded[:, 0].tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    same, valid = pad_to_multiple(a[:4], 4)
    assert valid == 4 and same.shape[0] == 4


def test_spatial_predictor_is_one_forward_at_any_shape():
    model = _model()
    sp = SpatialPredictor(model, dtype=None, device="cpu")
    images = np.random.default_rng(6).random((1, 40, 80, 3), dtype=np.float32)
    seen = []
    inner = sp._forward
    sp._forward = lambda x: (seen.append(tuple(x.shape)), inner(x))[1]
    got = sp(images)
    with torch.no_grad():
        want = model(torch.from_numpy(images)).clamp(0, 1).numpy()
    assert seen == [(1, 40, 80, 3)] and got.shape == (1, 160, 320, 3)
    np.testing.assert_array_equal(got, want)
    assert sp(np.concatenate([images, images]))[1].shape == (160, 320, 3)  # one forward of 2
    assert seen[-1] == (2, 40, 80, 3)
    with pytest.raises(NotImplementedError, match="A.13"):
        SpatialPredictor(model, mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        sp(np.zeros((0, 8, 8, 3), np.float32))


def test_predictor_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(_model())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=8, num_groups=1,
                                            blocks_per_group=1))


def test_int8_serving_not_ported():
    """Once refused; both int8 modes now build and serve the model's
    quantized forward (clipped)."""
    from facesr_torch.ops.quant import quantize_conv_kernels

    model = _model()
    x = torch.from_numpy(np.random.default_rng(1).random((2, 8, 8, 3), dtype=np.float32))
    for mode in ("int8", "int8_full"):
        fwd = build_serving_fn(model, mode)
        assert fwd.sites and set(fwd.sites) == set(quantize_conv_kernels(model))
        got = fwd(x)
        assert got.shape == (2, 32, 32, 3) and got.min() >= 0 and got.max() <= 1
    with torch.no_grad():
        want = model(x, dtype=torch.bfloat16, quant=fwd.sites).clamp(0, 1)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unsupported serving dtype"):
        build_serving_fn(model, "int4")


def test_microbatcher_returns_each_callers_slice():
    calls = []

    def fn(batch):
        calls.append(len(batch))
        return batch * 2 + 1

    mb = MicroBatcher(fn, max_batch=8, window_ms=50)
    results = {}
    inputs = {i: np.full((2, 2, 3), i, np.float32) for i in range(8)}

    def client(i):
        results[i] = mb(inputs[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    mb.close()
    assert not any(t.is_alive() for t in threads)
    for i in range(8):
        np.testing.assert_array_equal(results[i], inputs[i] * 2 + 1)
    assert sum(calls) == 8 and mb.images == 8 and mb.calls == len(calls)
    assert len(calls) < 8  # requests were coalesced


def test_microbatcher_isolates_a_failing_request():
    def fn(batch):
        if np.isnan(batch).any():
            raise ValueError("bad image")
        return batch

    mb = MicroBatcher(fn, max_batch=4, window_ms=50)
    out, errs = {}, {}

    def client(i, x):
        try:
            out[i] = mb(x)
        except ValueError as e:
            errs[i] = e

    xs = [np.ones((1, 1, 3), np.float32), np.full((1, 1, 3), np.nan, np.float32)]
    threads = [threading.Thread(target=client, args=(i, x)) for i, x in enumerate(xs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    mb.close()
    assert list(out) == [0] and list(errs) == [1]
    with pytest.raises(RuntimeError):
        mb(xs[0])


def test_microbatcher_over_predictor():
    pred = Predictor(_model(), dtype=None, max_batch=4, device="cpu")
    mb = MicroBatcher(pred, max_batch=4, window_ms=20)
    images = np.random.default_rng(1).random((3, 8, 8, 3), dtype=np.float32)
    res = [None] * 3

    def client(i):
        res[i] = mb(images[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    mb.close()
    np.testing.assert_allclose(np.stack(res), pred(images), atol=1e-6)


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "facesr")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_no_facesr():
    files = sorted((ROOT / "facesr_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        bad = {m for m in _imported_roots(f) if m in _FORBIDDEN}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, facesr_torch, facesr_torch.models, facesr_torch.parallel, "
            "facesr_torch.ckpt, facesr_torch.ops.rcab_group, "
            "facesr_torch.cli.measure_inference_time; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'facesr')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
