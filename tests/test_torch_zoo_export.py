"""`.pt2` export of every family and serving dtype (facesr_torch.ckpt.export,
cli.export_serving), the servers on zoo int8, and `cli.validate_parity
--int8` against the JAX package's `scripts/validate_parity.py`, on the CPU.

- Round trips: one artifact with a symbolic batch, run at two batch
  sizes, bitwise the live `parallel.serving.build_serving_fn` forward, in
  f32, bf16 (the group kernel's plain version on the CPU), weight-only
  ``int8`` and ``int8_full`` (dynamic, and calibrated with the transfer
  head's packed arm), with the custom-op nodes counted.
- The servers: the HTTP API with ``--exported`` int8 artifacts and with
  ``--dtype int8 | int8_full --quant-cache`` on zoo checkpoints; each
  response bitwise the matching `Predictor`'s (or the artifact's) output.
- validate_parity: both packages on the same port-written ``.pth`` files
  with ``--int8``: model rows within 1e-4 dB PSNR and 1e-5 SSIM; each
  row's int8 agreement within 0.25 dB (the two packages' int8_full
  outputs differ as much as int8 from f32 does in bf16, tests/
  test_torch_quant.py); the baselines within `BASELINE_PSNR_TOL` of
  tests/test_torch_eval_cli.py (the LR synthesis differs by up to 1.8e-7).
"""

import http.client
import importlib.util
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.app import api as port_api
from facesr_torch.app.demo import prepare_inputs
from facesr_torch.ckpt import export as ex
from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt.weights import save_reference_pth
from facesr_torch.cli import export_quantized
from facesr_torch.cli import export_serving as export_cli
from facesr_torch.cli import validate_parity
from facesr_torch.data import png
from facesr_torch.data.cv_compat import resize_cubic
from facesr_torch.models import esrgan as tesr
from facesr_torch.models import transfer as ttr
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.models.load import load_any_model
from facesr_torch.ops import conv as tconv
from facesr_torch.ops import rcab_group as tgroup
from facesr_torch.parallel.serving import Predictor, build_serving_fn

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SIZE = 8        # the artifacts' LR input size
TIMEOUT = 60    # seconds, every socket
C = tgroup.KERNEL_CHANNELS


def _perturbed(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return model.eval()


def _model(family, seed=0):
    """Small models; the transfer head and FaceEnhanceNet's trunk at the
    kernel's width, so their bf16 and int8 artifacts keep the custom op."""
    if family == "esrgan":
        m = tesr.RRDBNet(tesr.RRDBNetConfig(num_feat=16, num_blocks=1, num_grow_ch=8),
                         seed=seed, device="cpu")
    elif family == "transfer":
        m = ttr.TransferSRModel(ttr.TransferModelConfig(backbone_blocks=1, head_blocks=2,
                                                        head_channels=C), seed=seed, device="cpu")
    else:
        m = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=2, blocks_per_group=1),
                           seed=seed, device="cpu")
    return _perturbed(m, seed)


def _x(n, seed):
    return np.random.default_rng(seed).random((n, SIZE, SIZE, 3), dtype=np.float32)


# (family, dtype, custom-op nodes): the kernel groups stay nodes in bf16 and
# weight-only int8 (FaceEnhanceNet's 2 groups here, the transfer head's 1)
CASES = [("esrgan", "f32", 0), ("esrgan", "int8_full", 0), ("transfer", "bf16", 1),
         ("transfer", "int8", 1), ("transfer", "int8_full_calibrated", 0),
         ("custom", "int8", 2), ("custom", "int8_full_calibrated", 0)]
DTYPES = {"f32": None, "bf16": torch.bfloat16, "int8": "int8", "int8_full": "int8_full",
          "int8_full_calibrated": "int8_full"}


@pytest.mark.parametrize("family,dtype,nodes", CASES, ids=lambda v: str(v))
def test_one_symbolic_artifact_is_the_live_forward_at_two_batches(family, dtype, nodes):
    model = _model(family, seed=1)
    kw = {"calibration": _x(2, 2)} if dtype.endswith("calibrated") else {}
    live = build_serving_fn(model, DTYPES[dtype], **kw)
    fn = ex.load_exported(ex.export_serving(model, DTYPES[dtype], input_size=SIZE, **kw),
                          device="cpu")
    assert ex.custom_op_nodes(fn.exported) == nodes
    assert isinstance(ex.input_shape(fn.exported)[0], torch.SymInt)
    for n in (1, 3):
        x = _x(n, 10 + n)
        with torch.inference_mode():
            want = live(torch.from_numpy(x)).float().numpy()
        got = fn(x)
        assert got.shape == (n, 4 * SIZE, 4 * SIZE, 3)
        np.testing.assert_array_equal(got, want)


def test_int8_artifacts_are_smaller_and_hold_no_float_kernel():
    model = _model("transfer", seed=3)
    sizes = {d: len(ex.export_serving(model, DTYPES[d], input_size=SIZE))
             for d in ("bf16", "int8")}
    assert sizes["int8"] < sizes["bf16"] / 2, sizes
    module = ex.build_serving_fn(model, "int8")
    assert module.model.face_head.conv_last.weight is None
    assert all(t.dtype == torch.int8 for n, t in module.named_buffers() if n.startswith("int8_rows"))


def test_an_int8_full_conv_is_one_custom_op_node_chunked_at_the_call(monkeypatch):
    """Each int8_full site is one ``facesr_torch::int8_conv`` node; its
    im2col is chunked when the program runs, at the batch it is given
    (here into bands of a few output rows), bitwise the live forward."""
    model = _model("esrgan", seed=4)
    fn = ex.load_exported(ex.export_serving(model, "int8_full", input_size=SIZE), device="cpu")
    assert ex.custom_op_nodes(fn.exported, "int8_conv") == 15 + 6
    x = _x(5, 5)
    with torch.inference_mode():
        want = build_serving_fn(model, "int8_full")(torch.from_numpy(x)).numpy()
    chunks = []
    real = tconv._int8_gemm_conv

    def counted(*a, **k):
        for part in real(*a, **k):
            chunks.append(part[1:])
            yield part

    monkeypatch.setattr(tconv, "INT8_CHUNK_BYTES", 4 * 32 * 160)
    monkeypatch.setattr(tconv, "_int8_gemm_conv", counted)
    np.testing.assert_array_equal(fn(x), want)
    assert len(chunks) > 21 and any(c[3] - c[2] < 32 for c in chunks)


def test_export_cli_int8_modes_and_the_missing_cache(tmp_path, capsys):
    model = _perturbed(ttr.TransferSRModel(ttr.TransferModelConfig(
        backbone_blocks=1, head_blocks=1, head_channels=16), seed=6, device="cpu"), 6)
    fckpt.save_model(str(tmp_path / "transfer.fckpt"), model)
    (tmp_path / "lr").mkdir()
    for i in range(2):
        png.write_png(tmp_path / "lr" / f"{i}.png", (_x(1, 20 + i)[0] * 255).astype(np.uint8))
    common = ["--checkpoint", str(tmp_path / "transfer.fckpt"), "--input-size", str(SIZE),
              "--device", "cpu", "--verify"]
    for flags in (["--dtype", "int8"], ["--dtype", "int8_full", "--calib-dir",
                                        str(tmp_path / "lr")]):
        art = tmp_path / f"{flags[1]}.pt2"
        assert export_cli.main(common + ["--output", str(art)] + flags) == 0
        out = capsys.readouterr().out
        assert "verify: max |exported - live| = 0.00e+00" in out and "int8 sites" in out
    # a quant cache: export_quantized's file serves the artifact's scales
    cache = tmp_path / "q.transfer.fckpt"
    assert export_quantized.main(["--checkpoint", str(tmp_path / "transfer.fckpt"),
                                  "--calib-dir", str(tmp_path / "lr"), "--output", str(cache),
                                  "--device", "cpu"]) == 0
    assert export_cli.main(common + ["--output", str(tmp_path / "c.pt2"), "--dtype", "int8_full",
                                     "--quant-cache", str(cache)]) == 0
    with pytest.raises(ValueError, match="does not exist"):  # no silent dynamic scales
        export_cli.main(common + ["--output", str(tmp_path / "m.pt2"), "--dtype", "int8_full",
                                  "--quant-cache", str(tmp_path / "missing.fckpt")])


def _request(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/super-resolve", body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _serve_and_check(srv, want_fn):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        rng = np.random.default_rng(30)
        for _ in range(2):
            img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
            status, body = _request(srv.server_address[1], png.encode(img))
            want = (want_fn(prepare_inputs(img)[0][None])[0] * 255).round().astype(np.uint8)
            assert status == 200 and np.array_equal(png.decode_rgb(body), want)
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()


@pytest.mark.parametrize("mode", ["int8", "int8_full_cache", "exported_int8_full"])
def test_the_api_serves_zoo_int8(mode, tmp_path):
    """``--dtype int8``, ``--dtype int8_full --quant-cache`` on an RRDBNet
    checkpoint, and ``--exported`` with a calibrated int8_full RRDBNet
    artifact (the transfer model's is served on the card, chip_smoke.py
    phase 14): every response bitwise what the matching Predictor or the
    artifact gives."""
    ck = tmp_path / "ck"
    ck.mkdir()
    if mode == "exported_int8_full":
        model = _model("esrgan", seed=7)
        art = tmp_path / "rrdbnet_int8.pt2"
        art.write_bytes(ex.export_serving(model, "int8_full", input_size=64,
                                          calibration=_x(2, 8)))
        srv = port_api.serve(str(tmp_path / "none"), port=0, host="127.0.0.1", device="cpu",
                             exported=str(art))
        _serve_and_check(srv, ex.load_exported(art, device="cpu"))
        return
    model = _model("esrgan", seed=9)
    save_reference_pth(str(ck / "rrdbnet.pth"), model)
    kw = {"dtype": "int8"}
    if mode == "int8_full_cache":
        cache = tmp_path / "q" / "int8.rrdbnet.fckpt"
        fckpt.save_quant_cache(str(cache), model, build_serving_fn(
            model, "int8_full", calibration=_x(2, 10)).sites)
        kw = {"dtype": "int8_full", "quant_cache": str(tmp_path / "q" / "int8")}
    srv = port_api.serve(str(ck), port=0, host="127.0.0.1", device="cpu", **kw)
    pred = Predictor(load_any_model(ck / "rrdbnet.pth"), dtype=kw["dtype"], max_batch=1,
                     device="cpu", quant_cache=(str(cache) if "quant_cache" in kw else None))
    _serve_and_check(srv, pred)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_validate_parity_int8_matches_the_jax_script(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_eval_cli import BASELINE_PSNR_TOL

    monkeypatch.delenv("FACESR_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("FACESR_INCEPTION_WEIGHTS", raising=False)
    art, hr = tmp_path / "artifacts", tmp_path / "hr"
    art.mkdir()
    hr.mkdir()
    save_reference_pth(str(art / "custom_model.pth"), _perturbed(FaceEnhanceNet(
        FaceEnhanceNetConfig(num_channels=16, num_groups=1, blocks_per_group=2), seed=11,
        device="cpu"), 11))
    save_reference_pth(str(art / "transfer_model.pth"), _perturbed(ttr.TransferSRModel(
        ttr.TransferModelConfig(backbone_blocks=2, head_blocks=1, head_channels=16), seed=12,
        device="cpu"), 12))
    save_reference_pth(str(art / "esrgan_model.pth"), _model("esrgan", seed=13))
    rng = np.random.default_rng(14)
    for i in range(3):
        png.write_png(hr / f"face_{i}.png",
                      resize_cubic((rng.random((5, 5, 3)) * 255).astype(np.uint8), (32, 32)))
    common = ["--artifacts", str(art), "--test-dir", str(hr), "--num-images", "3", "--int8",
              "--calibrate", "2"]
    validate_parity.main(common + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["validate_parity.py"] + common
                        + ["--output", str(tmp_path / "jax"), "--platform", "cpu"])
    try:
        _jax_script("validate_parity").main()
    except SystemExit:
        pass
    got = json.loads((tmp_path / "port" / "parity_report.json").read_text())
    want = json.loads((tmp_path / "jax" / "parity_report.json").read_text())
    models = ("custom_model", "transfer_model", "esrgan_model")
    assert set(got["int8"]) == set(want["int8"]) == set(models)
    for name in models:
        assert abs(got["rows"][name]["psnr"] - want["rows"][name]["psnr"]) <= 1e-4, name
        assert abs(got["rows"][name]["ssim"] - want["rows"][name]["ssim"]) <= 1e-5, name
        assert abs(got["int8"][name]["agreement_psnr"]
                   - want["int8"][name]["agreement_psnr"]) <= 0.25, (
            name, got["int8"][name], want["int8"][name])
    for name in ("Bilinear", "Bicubic", "Lanczos4"):
        assert abs(got["rows"][name]["psnr"] - want["rows"][name]["psnr"]) <= BASELINE_PSNR_TOL


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_conv_op_passes_opcheck(static):
    from facesr_torch.ops.quant import Int8Weight

    gen = torch.Generator().manual_seed(40)
    q = torch.randint(-127, 128, (16, 8, 3, 3), generator=gen).to(torch.int8)
    w = Int8Weight(q, torch.rand(16, generator=gen) * 1e-2,
                   torch.tensor(0.01) if static else None)
    x = torch.randn((2, 6, 5, 8), generator=gen).to(torch.bfloat16)
    args = (x, w.gemm_weight(*tconv.int8_gemm_pads(q.shape)), w.scale, w.a,
            torch.randn(16, generator=gen), list(q.shape), 1, [1, 1], torch.bfloat16)
    result = torch.library.opcheck(torch.ops.facesr_torch.int8_conv.default, args)
    assert all(v == "SUCCESS" for v in result.values()), result
    assert torch.equal(torch.ops.facesr_torch.int8_conv(*args),
                       tconv._int8_conv(x, w, args[4], 1, 1, torch.bfloat16))


@pytest.mark.parametrize("mode", ["int8_full_calibrated", "exported_int8"])
def test_the_demo_serves_zoo_int8(mode, tmp_path):
    """The headless demo with ``--dtype int8_full --calib-dir`` on a
    transfer checkpoint, and with ``--exported`` on a weight-only int8
    RRDBNet artifact: its SR is what the matching Predictor or the
    artifact gives on the demo's own inputs."""
    from facesr_torch.app import demo

    img_path = tmp_path / "face.png"
    png.write_png(img_path, (_x(1, 50)[0] * 255).astype(np.uint8))
    (tmp_path / "lr").mkdir()
    png.write_png(tmp_path / "lr" / "0.png", (_x(1, 51)[0] * 255).astype(np.uint8))
    ck = tmp_path / "ck"
    ck.mkdir()
    if mode == "exported_int8":
        art = tmp_path / "rrdbnet_int8.pt2"
        art.write_bytes(ex.export_serving(_model("esrgan", seed=52), "int8", input_size=64))
        flags = ["--exported", str(art)]
        servable = ex.load_exported(art, device="cpu")
    else:
        model = _perturbed(ttr.TransferSRModel(ttr.TransferModelConfig(
            backbone_blocks=1, head_blocks=1, head_channels=16), seed=53, device="cpu"), 53)
        fckpt.save_model(str(ck / "transfer.fckpt"), model)
        flags = ["--dtype", "int8_full", "--calib-dir", str(tmp_path / "lr")]
        from facesr_torch.parallel.serving import load_calibration_images

        servable = Predictor(load_any_model(ck / "transfer.fckpt"), dtype="int8_full",
                             max_batch=8, device="cpu",
                             calibration=load_calibration_images(str(tmp_path / "lr")))
    out = tmp_path / "out"
    assert demo.main(["--checkpoint-dir", str(ck), "--image", str(img_path), "--output",
                      str(out), "--device", "cpu"] + flags) == 0
    want = demo.process_image(png.read_rgb(img_path), servable)["sr"]
    assert np.array_equal(png.read_rgb(out / "sr.png"), want)
