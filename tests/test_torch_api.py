"""The port's HTTP API (facesr_torch.app.api) against the JAX package's
(app/api.py) on one `.fckpt` written by `facesr`, and through a real
socket on the CPU: health and models, the round trip, the error paths,
keep-alive after an undrained error, micro-batching and exported
artifacts. Every socket has a timeout."""

import http.client
import json
import threading

import jax
import numpy as np
import pytest
import torch

from facesr.ckpt import checkpoint as jckpt
from facesr.models import face_enhance_net as fen
from facesr_torch.app import api as port_api
from facesr_torch.ckpt.export import export_serving
from facesr_torch.data import png
from facesr_torch.models.load import load_any_model

torch.set_num_threads(1)

SMALL = fen.FaceEnhanceNetConfig(num_channels=16, num_groups=2, blocks_per_group=2)
TIMEOUT = 60  # seconds, every socket
# f32: the two packages' forwards, LR synthesis and area resizes differ in
# the last f32 bits, which can move a uint8 SR value one level at a
# rounding boundary: within 1 level, at most 0.1% of the values
F32_LEVELS, F32_SHARE = 1, 1e-3
# bf16 (the bound of test_torch_face_enhance_net's bf16 eval test): both
# round every conv to bf16 in other summation orders, some bf16 ulps of 0.5
# apart
BF16_MAX, BF16_MEAN = 3e-2, 3e-3
# request shapes: LR as it is, LR resized down by area weights, and three
# HR crops (crop upscaled to 256, exactly 256, and downscaled)
SHAPES = [(64, 64), (100, 90), (200, 200), (256, 256), (300, 400)]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A JAX-written model checkpoint, every leaf off its init (conv_last
    non-zero so the SR is not the bicubic skip)."""
    root = tmp_path_factory.mktemp("api_ckpt")
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(7), SMALL))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32),
                          params)
    jckpt.save_model(str(root / "best_model.fckpt"), params, SMALL)
    return root


def _images(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in SHAPES:
        lo = (rng.random((6, 6, 3)) * 255).astype(np.uint8)
        base = np.kron(lo, np.ones((h // 6 + 1, w // 6 + 1, 1), np.uint8))[:h, :w]
        out.append(np.clip(base.astype(int) + rng.integers(-20, 21, (h, w, 3)), 0, 255)
                   .astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def server(ckpt_dir):
    srv = port_api.serve(str(ckpt_dir), port=0, host="127.0.0.1", device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _start(**kw):
    srv = port_api.serve(kw.pop("ckpt"), port=0, host="127.0.0.1", device="cpu", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(*servers):
    for srv in servers:
        srv.shutdown()
        srv.server_close()
        srv.service.close()


def _levels(a, b):
    """(max level difference, share of values that differ) of two uint8
    images."""
    d = np.abs(a.astype(int) - b.astype(int))
    return int(d.max()), float((d > 0).mean())


def test_f32_service_matches_jax_service(ckpt_dir):
    import cv2
    from app.api import SRService as JaxService

    jax_svc = JaxService(str(ckpt_dir))
    port_svc = port_api.SRService(str(ckpt_dir), device="cpu")
    assert list(port_svc.models) == list(jax_svc.models) == ["Best Model"]
    for img in _images():
        body = png.encode(img)
        got = png.decode_rgb(port_svc.super_resolve(body))
        want = cv2.cvtColor(cv2.imdecode(np.frombuffer(jax_svc.super_resolve(body), np.uint8),
                                         cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        levels, share = _levels(got, want)
        print(f"{img.shape}: max {levels} level(s), {share:.2e} of the values differ")
        assert got.shape == want.shape == (256, 256, 3)
        assert levels <= F32_LEVELS and share <= F32_SHARE


def test_bf16_service_matches_jax_service(ckpt_dir):
    from app.api import SRService as JaxService
    from app.demo import prepare_inputs as jax_prepare

    jax_svc = JaxService(str(ckpt_dir), dtype="bf16")
    port_svc = port_api.SRService(str(ckpt_dir), dtype="bf16", device="cpu")
    name = port_svc.default
    for img in _images(seed=1)[:3]:
        lr = jax_prepare(img)[0][None]
        got = port_svc.predictors[name](lr)
        want = jax_svc.predictors[name](lr)
        diff = np.abs(got - want)
        print(f"{img.shape}: max abs {diff.max():.3g}, mean abs {diff.mean():.3g}")
        assert got.shape == want.shape and diff.max() <= BF16_MAX and diff.mean() <= BF16_MEAN


def test_health_and_models(server):
    status, ctype, data = _request(server, "GET", "/health")
    payload = json.loads(data)
    assert status == 200 and "json" in ctype
    assert payload == {"status": "ok", "models": ["Best Model"], "device": "cpu"}
    status, _, data = _request(server, "GET", "/models")
    info = json.loads(data)["Best Model"]
    assert info["scale_factor"] == 4 and info["model_class"] == "FaceEnhanceNet"


def test_super_resolve_roundtrip(server, ckpt_dir):
    img = _images(seed=2)[0]
    status, ctype, data = _request(server, "POST", "/super-resolve", body=png.encode(img))
    assert status == 200 and ctype == "image/png"
    out = png.decode_rgb(data)
    assert out.shape == (256, 256, 3)
    model = load_any_model(ckpt_dir / "best_model.fckpt")
    with torch.no_grad():
        want = model(torch.from_numpy(img[None].astype(np.float32) / 255)).numpy()[0]
    # the server's threads may run the CPU convs on another thread count,
    # so in another summation order: within one level
    levels, share = _levels(out, (want * 255).round().astype(np.uint8))
    assert levels <= F32_LEVELS and share <= F32_SHARE


def test_error_paths(server):
    status, _, data = _request(server, "POST", "/super-resolve", body=b"not an image")
    assert status == 400 and b"decode" in data
    jpeg = b"\xff\xd8\xff\xe0\x00\x10JFIF" + b"\x00" * 32
    status, _, data = _request(server, "POST", "/super-resolve", body=jpeg)
    assert status == 400 and b"JPEG" in data and b"A.7.2" in data
    status, _, _ = _request(server, "POST", "/super-resolve")
    assert status == 400
    status, _, data = _request(server, "POST", "/super-resolve?model=nope", body=b"x" * 10)
    assert status == 400 and b"nope" in data
    status, _, _ = _request(server, "GET", "/nope")
    assert status == 404


def test_keepalive_survives_undrained_error_responses(server):
    body = png.encode(_images(seed=4)[0])
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=TIMEOUT)
    try:
        conn.request("POST", "/superresolve", body=body)  # a wrong path: body not drained
        resp = conn.getresponse()
        assert resp.status == 404 and resp.getheader("Connection") == "close"
        resp.read()
        conn.request("POST", "/super-resolve", body=body)  # http.client reconnects
        resp = conn.getresponse()
        data = resp.read()
        assert resp.status == 200 and png.decode_rgb(data).shape == (256, 256, 3)
    finally:
        conn.close()
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=TIMEOUT)
    try:
        for _ in range(2):  # two requests on one connection
            conn.request("POST", "/super-resolve", body=body)
            resp = conn.getresponse()
            assert resp.status == 200 and resp.getheader("Connection") != "close"
            resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_microbatched_serving_matches_unbatched(ckpt_dir, dtype):
    """Concurrent requests coalesce into one forward of their true size;
    each client gets the unbatched server's image (within one level: the
    CPU conv may sum a batch of 4 in another order than a batch of 1)."""
    plain = _start(ckpt=str(ckpt_dir), dtype=dtype)
    batched = _start(ckpt=str(ckpt_dir), dtype=dtype, batch_window_ms=200.0, max_batch=8)
    try:
        bodies = [png.encode(img) for img in _images(seed=5)[:3]] + [png.encode(_images(6)[0])]
        serial = [_request(plain.server_address[1], "POST", "/super-resolve", body=b)[2]
                  for b in bodies]
        got = [None] * len(bodies)

        def hit(i):
            got[i] = _request(batched.server_address[1], "POST", "/super-resolve",
                              body=bodies[i])[2]

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        for g, s in zip(got, serial):
            assert _levels(png.decode_rgb(g), png.decode_rgb(s))[0] <= 1
        stats = json.loads(_request(batched.server_address[1], "GET", "/health")[2])["batching"]
        b = stats["Best Model"]
        assert b["images"] == len(bodies) and 1 <= b["calls"] < len(bodies)
    finally:
        _stop(plain, batched)


def test_exported_artifact_serving(ckpt_dir, tmp_path):
    """Serve from a .pt2 artifact alone (no checkpoint directory): the same
    images as the checkpoint-served f32 forward (the f32 artifact is the
    same computation)."""
    art = tmp_path / "face_sr_f32.pt2"
    art.write_bytes(export_serving(load_any_model(ckpt_dir / "best_model.fckpt"), dtype=None))
    srv_art = _start(ckpt=str(tmp_path / "nonexistent"), exported=str(art))
    srv_mb = _start(ckpt=str(tmp_path / "nonexistent"), exported=str(art),
                    batch_window_ms=20.0, max_batch=4)
    srv_ckpt = _start(ckpt=str(ckpt_dir))
    try:
        p_art = srv_art.server_address[1]
        assert json.loads(_request(p_art, "GET", "/health")[2])["models"] == ["face_sr_f32"]
        info = json.loads(_request(p_art, "GET", "/models")[2])["face_sr_f32"]
        assert info["model_class"] == "ExportedArtifact"
        body = png.encode(_images(seed=3)[1])
        outs = [_request(s.server_address[1], "POST", "/super-resolve", body=body)
                for s in (srv_art, srv_mb, srv_ckpt)]
        assert all(o[0] == 200 and o[1] == "image/png" for o in outs)
        imgs = [png.decode_rgb(o[2]) for o in outs]
        assert imgs[0].shape == (256, 256, 3)
        assert _levels(imgs[0], imgs[2])[0] <= 1 and _levels(imgs[1], imgs[2])[0] <= 1
    finally:
        _stop(srv_art, srv_mb, srv_ckpt)


@pytest.mark.parametrize("kw", [{"dtype": "int8"}, {"dtype": "int8_full"},
                                {"dtype": "bf16", "calib_dir": "calib"},
                                {"dtype": "bf16", "quant_cache": "cache"}])
def test_int8_serving_raises_at_startup(ckpt_dir, kw, tmp_path, capsys):
    """These once raised at startup; now each comes up and serves: int8 and
    int8_full answer what their `Predictor` gives, bitwise, and bf16 with
    a calibration argument warns that it ignores it and serves bf16."""
    from facesr_torch.app.demo import prepare_inputs
    from facesr_torch.parallel.serving import Predictor

    if "calib_dir" in kw:
        (tmp_path / "calib").mkdir()
        png.write_png(tmp_path / "calib" / "a.png", _images(seed=9)[0])
        kw = dict(kw, calib_dir=str(tmp_path / "calib"))
    if "quant_cache" in kw:
        kw = dict(kw, quant_cache=str(tmp_path / "cache"))
    svc = port_api.SRService(str(ckpt_dir), device="cpu", **kw)
    if kw["dtype"] == "bf16":
        assert "ignoring them" in capsys.readouterr().out
    img = _images(seed=8)[2]
    got = png.decode_rgb(svc.super_resolve(png.encode(img)))
    serve_dtype = torch.bfloat16 if kw["dtype"] == "bf16" else kw["dtype"]
    pred = Predictor(load_any_model(ckpt_dir / "best_model.fckpt"), dtype=serve_dtype,
                     max_batch=1, device="cpu")
    want = pred(prepare_inputs(img)[0][None])[0]
    assert np.array_equal(got, (want * 255).round().astype(np.uint8))


def test_service_startup_errors(ckpt_dir, tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="No checkpoints"):
        port_api.SRService(str(tmp_path), device="cpu")
    art = tmp_path / "best_model.pt2"  # the stem a checkpoint model would take
    art.write_bytes(export_serving(load_any_model(ckpt_dir / "best_model.fckpt"), dtype=None,
                                   batch=1))
    (tmp_path / "ck").mkdir()
    (tmp_path / "ck" / "best_model.fckpt").write_bytes((ckpt_dir / "best_model.fckpt")
                                                       .read_bytes())
    renamed = tmp_path / "Best Model.pt2"
    renamed.write_bytes(art.read_bytes())
    with pytest.raises(ValueError, match="collide"):
        port_api.SRService(str(tmp_path / "ck"), exported=str(renamed), device="cpu")
    with pytest.raises(ValueError, match="pinned"):  # micro-batching needs a symbolic batch
        port_api.SRService(str(tmp_path / "ck"), exported=str(art), batch_window_ms=5,
                           device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_api.SRService(str(ckpt_dir))
