"""The port's int8 serving surfaces on the CPU: `build_serving_fn`'s int8
and int8_full arms through `Predictor`, `SpatialPredictor` and
`MicroBatcher`, the quant cache as a serving artifact
(`calibrated_qparams`, `cli.export_quantized`, against the JAX package's
script), the calibration images, `measure_inference_time --int8` and the
HTTP API with ``--quant-cache``.

Tolerances: bitwise wherever the port is compared with itself (a served
forward against the model's own forward on the same sites, a cache
written and read back, an HTTP response against `Predictor`); the
export CLI's static scales within 5% of the JAX script's: the bf16
calibration forwards round differently (test_torch_quant.py) and the LR
synthesis differs in the last bits; each site's scale is the max of one
activation map, equal at most sites and 2.2% apart at the worst one
(conv_last, after the whole trunk) on this set. The calibration images
exactly (the port's INTER_AREA copy is exact).
"""

import http.client
import importlib.util
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from facesr.ckpt import checkpoint as jckpt
from facesr.models import face_enhance_net as fen
from facesr.parallel import serving as jserving
from facesr_torch.app import api as port_api
from facesr_torch.cli import export_quantized, measure_inference_time
from facesr_torch.data import png
from facesr_torch.evaluation.batched import make_predictor
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.models.load import load_any_model
from facesr_torch.ops import quant as tquant
from facesr_torch.ops import rcab_group
from facesr_torch.parallel import serving as tserving

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = fen.FaceEnhanceNetConfig(num_channels=16, num_groups=2, blocks_per_group=2)


def _model(c=16, g=2, b=2, seed=0):
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=c, num_groups=g,
                                                blocks_per_group=b), seed=seed, device="cpu")
    with torch.no_grad():  # a non-zero conv_last so the trunk shows in the output
        model.conv_last.weight.copy_(torch.randn(model.conv_last.weight.shape,
                                                 generator=torch.Generator().manual_seed(seed))
                                     * 0.05)
    return model.eval()


def _x(n=3, size=8, seed=1):
    return np.random.default_rng(seed).random((n, size, size, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A JAX-written model checkpoint and 5 HR PNGs of 32x32 (one 24x24)."""
    root = tmp_path_factory.mktemp("int8_ckpt")
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(3), SMALL))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32),
                          params)
    jckpt.save_model(str(root / "best_model.fckpt"), params, SMALL)
    (root / "hr").mkdir()
    for i in range(5):
        size = 24 if i == 3 else 32
        lo = rng.random((4, 4, 3))
        img = np.kron(lo, np.ones((size // 4, size // 4, 1))) * 200 + rng.random((size, size, 3)) * 55
        png.write_png(root / "hr" / f"f{i}.png", img.astype(np.uint8))
    return root


def test_int8_weight_only_is_the_bf16_forward_of_the_dequantized_weights(monkeypatch):
    """Weight-only int8 serves the bf16 forward of the dequantized weights:
    bitwise the bf16 forward of a model loaded with them, through the
    kernel trunk (one group call a group, here its plain version on the
    CPU), and the float model's weights and kernel weights stay its own."""
    model = _model(c=64, g=2, b=1)
    calls = []
    real = rcab_group.rcab_group_reference
    monkeypatch.setattr(rcab_group, "rcab_group_reference",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    x = _x()
    bf16 = tserving.Predictor(model, dtype=torch.bfloat16, max_batch=8, device="cpu")
    before = bf16(x)
    int8 = tserving.Predictor(model, dtype="int8", max_batch=8, device="cpu")
    calls.clear()
    got = int8(x)
    assert len(calls) == 2
    deq = _model(c=64, g=2, b=1)
    with torch.no_grad():
        for name, w in tquant.dequantize_pytree(int8._forward.sites).items():
            deq.get_parameter(f"{name}.weight").copy_(w.float())
    want = tserving.Predictor(deq, dtype=torch.bfloat16, max_batch=8, device="cpu")(x)
    assert np.array_equal(got, want) and not np.array_equal(got, before)
    assert np.array_equal(bf16(x), before)


def test_int8_and_bf16_serving_of_one_model_from_many_threads():
    """Weight-only int8 serves a copy that holds the dequantized weights
    and leaves the module alone, so threads serving one model in int8 and
    in bf16 at once each get their own dtype's output (swapping the
    module's parameters, as ``functional_call`` does, let a thread run the
    other's weights)."""
    model = _model(c=64, g=2, b=1)
    preds = {d: tserving.Predictor(model, dtype=d, max_batch=2, device="cpu")
             for d in ("int8", torch.bfloat16)}
    x = _x(n=2)
    want = {d: p(x) for d, p in preds.items()}
    got, errors = [], []

    def serve(d):
        try:
            for _ in range(3):
                got.append((d, preds[d](x)))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(d,)) for d in preds for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(got) == 24
    assert all(np.array_equal(out, want[d]) for d, out in got)


@pytest.mark.parametrize("calibrated", [False, True])
def test_int8_full_predictors_serve_the_models_quantized_forward(calibrated):
    """Predictor (chunked at 2), SpatialPredictor (another shape) and a
    MicroBatcher over the predictor give the model's int8_full forward;
    the per-image scales (dynamic) keep an image's output independent of
    its batchmates."""
    model = _model()
    x = _x(n=5)
    calib = _x(n=2, seed=7) if calibrated else None
    pred = tserving.Predictor(model, dtype="int8_full", max_batch=2, device="cpu",
                              calibration=calib)
    sites = pred._forward.sites
    assert all((s.a is not None) == calibrated for s in sites.values())
    with torch.no_grad():
        want = model(torch.from_numpy(x), dtype=torch.bfloat16, quant=sites).clamp(0, 1).numpy()
    assert np.array_equal(pred(x), want)
    sp = tserving.SpatialPredictor(model, dtype="int8_full", device="cpu", calibration=calib)
    big = _x(n=1, size=12, seed=4)[:, :, :10]
    with torch.no_grad():
        want_big = model(torch.from_numpy(np.ascontiguousarray(big)), dtype=torch.bfloat16,
                         quant=sp._forward.sites).clamp(0, 1).numpy()
    assert np.array_equal(sp(big), want_big)
    mb = tserving.MicroBatcher(pred, max_batch=4, window_ms=100)
    try:
        out = [None] * 3
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, mb(x[i])))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for i in range(3):
            assert np.array_equal(out[i], want[i])
    finally:
        mb.close()


def test_quant_cache_is_written_reused_and_required(tmp_path, capsys):
    model = _model()
    cache = str(tmp_path / "q.fckpt")
    first = tserving.Predictor(model, dtype="int8_full", max_batch=4, device="cpu",
                               calibration=_x(n=4, seed=2), quant_cache=cache)
    assert Path(cache).exists()
    again = tserving.Predictor(model, dtype="int8_full", max_batch=4, device="cpu",
                               quant_cache=cache)
    x = _x()
    assert np.array_equal(again(x), first(x))
    with pytest.raises(ValueError, match="does not exist"):
        tserving.build_serving_fn(model, "int8_full", quant_cache=str(tmp_path / "missing.fckpt"),
                                  require_calibration=True)
    dynamic = tserving.Predictor(model, dtype="int8_full", device="cpu",
                                 quant_cache=str(tmp_path / "missing.fckpt"))
    assert all(s.a is None for s in dynamic._forward.sites.values())
    capsys.readouterr()
    bf16 = tserving.Predictor(model, dtype=torch.bfloat16, device="cpu", quant_cache=cache)
    assert "ignoring them" in capsys.readouterr().out
    assert np.array_equal(bf16(x), tserving.Predictor(model, device="cpu")(x))
    with pytest.raises(ValueError, match="DIFFERENT"):
        tserving.Predictor(_model(seed=4), dtype="int8_full", device="cpu", quant_cache=cache)
    pred = make_predictor(model, dtype="int8_full", device="cpu", calibration=_x(n=4, seed=2))
    assert np.array_equal(pred(x), first(x))


def test_calibration_images_and_cache_names_match_jax(ckpt_dir, tmp_path):
    (tmp_path / "c").mkdir()
    for f in sorted((ckpt_dir / "hr").iterdir()):
        (tmp_path / "c" / f.name).write_bytes(f.read_bytes())
    (tmp_path / "c" / "broken.png").write_bytes(b"not a png")
    got = tserving.load_calibration_images(str(tmp_path / "c"), size=16, limit=4)
    want = jserving.load_calibration_images(str(tmp_path / "c"), size=16, limit=4)
    assert got.shape == (4, 16, 16, 3) and np.array_equal(got, want)
    for base in (None, "", "quant/int8"):
        assert tserving.per_model_quant_cache(base, "Best Model") == \
            jserving.per_model_quant_cache(base, "Best Model")
    with pytest.raises(RuntimeError, match="No readable"):
        tserving.load_calibration_images(str(tmp_path), size=16)  # holds no image


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_export_quantized_matches_the_jax_script(ckpt_dir, tmp_path, monkeypatch, capsys):
    """Both CLIs on one JAX checkpoint and PNG set (--calib-hr): the same
    site set, static scales within 2%, and each package serves the other's
    artifact. A second export replaces the first atomically."""
    args = ["--checkpoint", str(ckpt_dir / "best_model.fckpt"), "--calib-dir",
            str(ckpt_dir / "hr"), "--calib-hr", "--num-images", "4"]
    port_out, jax_out = tmp_path / "port" / "int8.fckpt", tmp_path / "jax" / "int8.fckpt"
    assert export_quantized.main(args + ["--output", str(port_out), "--device", "cpu"]) == 0
    assert "Calibrating on 3 images (8x8 LR)" in capsys.readouterr().out  # 24x24 dropped
    monkeypatch.setattr(sys, "argv", ["export_quantized.py"] + args
                        + ["--output", str(jax_out), "--platform", "cpu"])
    _jax_script("export_quantized").main()
    model = load_any_model(ckpt_dir / "best_model.fckpt")
    got = tserving.load_calibrated_qparams(model, str(port_out))
    want = tserving.load_calibrated_qparams(model, str(jax_out))
    assert list(got) == list(want)
    for k in got:
        assert torch.equal(got[k].q, want[k].q)
        np.testing.assert_allclose(float(got[k].a), float(want[k].a), rtol=5e-2, err_msg=k)
    params = jax.tree.map(np.asarray, jckpt.load_model(str(ckpt_dir / "best_model.fckpt"))[1])
    jserving.load_calibrated_qparams(params, str(port_out))  # JAX reads the port's artifact
    first = port_out.read_bytes()
    assert export_quantized.main(args + ["--output", str(port_out), "--device", "cpu",
                                         "--num-images", "2"]) == 0
    assert "Replacing existing artifact" in capsys.readouterr().out
    assert port_out.read_bytes() != first and not list(port_out.parent.glob("*.tmp*"))


def test_measure_inference_time_int8(ckpt_dir, tmp_path, capsys):
    model = load_any_model(ckpt_dir / "best_model.fckpt")
    torch.save({"model_state_dict": model.state_dict(),
                "config": {"num_channels": 16, "num_groups": 2, "blocks_per_group": 2}},
               tmp_path / "m.pth")
    common = ["--checkpoint", str(tmp_path / "m.pth"), "--input-size", "8", "--batch-size",
              "2", "--num-runs", "2", "--warmup", "1", "--device", "cpu", "--int8"]
    measure_inference_time.main(common)
    assert "| int8_full\n" in capsys.readouterr().out
    measure_inference_time.main(common + ["--calibrate", "2"])
    out = capsys.readouterr().out
    assert "| int8_full/calibrated" in out and "images/sec" in out


def _request(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/super-resolve", body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_api_serves_int8_full_from_the_quant_cache(ckpt_dir, tmp_path):
    """--dtype int8_full --quant-cache <prefix> serves the exported
    artifact <prefix>.best_model.fckpt: each response is the Predictor's
    output on that cache, bitwise; a cache calibrated from other weights
    is refused at startup."""
    from facesr_torch.app.demo import prepare_inputs

    prefix = tmp_path / "q" / "int8"
    cache = Path(f"{prefix}.best_model.fckpt")
    assert export_quantized.main(["--checkpoint", str(ckpt_dir / "best_model.fckpt"),
                                  "--calib-dir", str(ckpt_dir / "hr"), "--calib-hr",
                                  "--output", str(cache), "--device", "cpu"]) == 0
    srv = port_api.serve(str(ckpt_dir), port=0, host="127.0.0.1", device="cpu",
                         dtype="int8_full", quant_cache=str(prefix))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        pred = tserving.Predictor(load_any_model(ckpt_dir / "best_model.fckpt"),
                                  dtype="int8_full", quant_cache=str(cache), device="cpu")
        rng = np.random.default_rng(11)
        for shape in ((64, 64, 3), (200, 200, 3)):
            img = (rng.random(shape) * 255).astype(np.uint8)
            status, body = _request(srv.server_address[1], png.encode(img))
            want = (pred(prepare_inputs(img)[0][None])[0] * 255).round().astype(np.uint8)
            assert status == 200 and np.array_equal(png.decode_rgb(body), want)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()
    other = tmp_path / "other"
    other.mkdir()
    jckpt.save_model(str(other / "best_model.fckpt"),
                     jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(9), SMALL)), SMALL)
    with pytest.raises(ValueError, match="DIFFERENT"):
        port_api.SRService(str(other), dtype="int8_full", quant_cache=str(prefix), device="cpu")
