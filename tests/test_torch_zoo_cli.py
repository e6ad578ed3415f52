"""The model zoo through the port's entry points on the CPU: `load_any_model`
dispatch, `compare_two_models` with a FaceEnhanceNet, a transfer and an
RRDBNet row, `test_model` and `measure_inference_time
--transfer-checkpoint` on zoo checkpoints, the HTTP API serving a transfer
`.fckpt`, `validate_parity` on `.pth` files the port writes from seeded
weights, and the train CLI on `configs/transfer_config.yaml` and with
``--model esrgan`` (sizes cut as `tests/test_torch_train_cli.py` cuts the
stage YAMLs)."""

import http.client
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr.models import transfer as tr
from facesr.models.load import load_any_model as jax_load_any_model
from facesr_torch.app import api as port_api
from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt.weights import save_reference_pth
from facesr_torch.cli import compare_two_models as port_compare
from facesr_torch.cli import measure_inference_time, validate_parity
from facesr_torch.cli import test_model as port_test
from facesr_torch.cli import train as train_cli
from facesr_torch.data import png
from facesr_torch.data.cv_compat import resize_cubic
from facesr_torch.evaluation.batched import (make_predictor, sr_batched, synthesize_lr_batched,
                                             to_uint8)
from facesr_torch.models import esrgan as tesr
from facesr_torch.models import transfer as ttr
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.models.load import load_any_model
from facesr_torch.parallel.serving import Predictor

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 60  # seconds, every socket
TR = dict(backbone_blocks=2, head_blocks=1, head_channels=16)
RR = dict(num_feat=16, num_blocks=1, num_grow_ch=8)


def _perturbed(model, seed):
    """Every parameter moved off its init (zero biases and conv_last too)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    return model.eval()


def _hr_pngs(root: Path, n: int, size: int = 32, seed: int = 0):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = resize_cubic((rng.random((5, 5, 3)) * 255).astype(np.uint8), (size, size))
        png.write_png(root / f"face_{i:02d}.png", img)
    return root


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """A checkpoint directory with a FaceEnhanceNet and a transfer `.fckpt`
    and an RRDBNet `.pth`, all port-written from seeded weights, and 3 HR
    PNGs of 32x32."""
    root = tmp_path_factory.mktemp("zoo")
    (root / "ckpt").mkdir()
    custom = _perturbed(FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                            blocks_per_group=2),
                                       seed=3, device="cpu"), 3)
    fckpt.save_model(str(root / "ckpt" / "best_model.fckpt"), custom)
    transfer = _perturbed(ttr.TransferSRModel(ttr.TransferModelConfig(**TR), seed=4,
                                              device="cpu"), 4)
    fckpt.save_model(str(root / "ckpt" / "transfer.fckpt"), transfer)
    rrdb = _perturbed(tesr.RRDBNet(tesr.RRDBNetConfig(**RR), seed=5, device="cpu"), 5)
    save_reference_pth(str(root / "ckpt" / "rrdbnet.pth"), rrdb)
    _hr_pngs(root / "hr", 3)
    return root


def test_load_any_model_dispatches_on_the_model_type(zoo):
    got = {name: load_any_model(zoo / "ckpt" / name, device="cpu")
           for name in ("best_model.fckpt", "transfer.fckpt", "rrdbnet.pth")}
    assert type(got["best_model.fckpt"]) is FaceEnhanceNet
    assert type(got["transfer.fckpt"]) is ttr.TransferSRModel
    assert got["transfer.fckpt"].config == ttr.TransferModelConfig(**TR)
    assert type(got["rrdbnet.pth"]) is tesr.RRDBNet
    assert got["rrdbnet.pth"].config == tesr.RRDBNetConfig(**RR)
    assert isinstance(jax_load_any_model(str(zoo / "ckpt" / "transfer.fckpt")),
                      tr.TransferSRModel)


def test_a_zoo_pth_with_missing_or_extra_keys_raises_naming_the_file(zoo, tmp_path):
    sd = load_any_model(zoo / "ckpt" / "transfer.fckpt").state_dict()
    missing = {k: v for k, v in sd.items() if "conv_after" not in k}
    torch.save({"model_state_dict": missing, "model_type": "transfer",
                "model_config": TR}, tmp_path / "missing.pth")
    torch.save({"params": {**load_any_model(zoo / "ckpt" / "rrdbnet.pth").state_dict(),
                           "extra.weight": torch.zeros(2)}}, tmp_path / "extra.pth")
    for name in ("missing.pth", "extra.pth"):
        with pytest.raises(RuntimeError, match=name):
            load_any_model(tmp_path / name)


@pytest.fixture()
def no_eval_weights(monkeypatch):
    monkeypatch.delenv("FACESR_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("FACESR_INCEPTION_WEIGHTS", raising=False)


def test_compare_scores_the_three_families(zoo, no_eval_weights, tmp_path, capsys):
    args = ["--checkpoint-dir", str(zoo / "ckpt"), "--test-dir", str(zoo / "hr"),
            "--device", "cpu", "--save-every", "1"]
    batched = port_compare.run(args + ["--output", str(tmp_path / "b")])
    assert batched["methods"] == ["Bilinear", "Bicubic", "Lanczos4", "Best Model", "Rrdbnet",
                                  "Transfer"]
    single = port_compare.run(args + ["--output", str(tmp_path / "s"), "--per-image"])
    for name in batched["methods"]:
        for k in ("psnr", "ssim"):
            assert abs(batched["summary"][name][k] - single["summary"][name][k]) <= 1e-2, name
    # the transfer row is the model's own f32 SR, scored
    hrs = [png.read_rgb(f) for f in sorted((zoo / "hr").iterdir())]
    lrs = synthesize_lr_batched(hrs, 4, device="cpu")
    srs = sr_batched(load_any_model(zoo / "ckpt" / "transfer.fckpt"), lrs, device="cpu")
    want = np.mean([port_test.compute_metrics(sr, hr)["psnr"] for sr, hr in zip(srs, hrs)])
    assert abs(batched["summary"]["Transfer"]["psnr"] - want) <= 1e-9
    capsys.readouterr()
    res = port_compare.run(args + ["--output", str(tmp_path / "q"), "--serve-dtype", "int8"])
    out = capsys.readouterr().out
    assert res["methods"][3:] == ["Best Model", "Rrdbnet", "Transfer"] and "Skipping" not in out
    # the zoo's int8 rows are the int8 Predictor's SR, scored
    srs = sr_batched(None, lrs, predictor=make_predictor(
        load_any_model(zoo / "ckpt" / "transfer.fckpt"), dtype="int8", device="cpu"))
    want = np.mean([port_test.compute_metrics(sr, hr)["psnr"] for sr, hr in zip(srs, hrs)])
    assert abs(res["summary"]["Transfer"]["psnr"] - want) <= 1e-9


def test_test_model_on_a_transfer_checkpoint(zoo, tmp_path):
    rows = port_test.run(["--checkpoint", str(zoo / "ckpt" / "transfer.fckpt"), "--input",
                          str(zoo / "hr"), "--output", str(tmp_path), "--device", "cpu"])
    assert len(rows) == 3 and (tmp_path / "face_00_sr.png").exists()
    model = load_any_model(zoo / "ckpt" / "transfer.fckpt")
    hr = png.read_rgb(zoo / "hr" / "face_01.png")
    lr = port_test.generate_lr(hr, 4, "cpu")
    with torch.no_grad():
        sr = to_uint8(model(torch.from_numpy(lr[None])).numpy()[0])
    assert rows[1]["model"] == port_test.compute_metrics(sr, hr)


def test_measure_inference_time_with_a_transfer_checkpoint(zoo, capsys):
    common = ["--input-size", "8", "--batch-size", "2", "--num-runs", "2", "--warmup", "1",
              "--device", "cpu", "--checkpoint", str(zoo / "ckpt" / "rrdbnet.pth"),
              "--transfer-checkpoint", str(zoo / "ckpt" / "transfer.fckpt")]
    measure_inference_time.main(common + ["--bf16"])
    out = capsys.readouterr().out
    assert "RRDBNet 1x16 growth 8" in out and "| bf16" in out
    assert "Transfer Model (from" in out and out.count("images/sec") == 2
    measure_inference_time.main(common + ["--int8", "--calibrate", "2"])
    out = capsys.readouterr().out
    assert "| int8_full/calibrated" in out and "Transfer Model (from" in out
    assert out.count("images/sec") == 2


@pytest.mark.parametrize("name", ["transfer.fckpt", "rrdbnet.pth"])
def test_spatial_predictor_microbatcher_and_demo_serve_the_zoo(zoo, name):
    from facesr_torch.app.demo import process_image
    from facesr_torch.parallel.serving import MicroBatcher, SpatialPredictor

    model = load_any_model(zoo / "ckpt" / name)
    x = np.random.default_rng(9).random((1, 12, 20, 3), dtype=np.float32)
    with torch.inference_mode():
        want = model(torch.from_numpy(x), dtype=torch.bfloat16).clamp(0, 1).numpy()
    got = SpatialPredictor(model, device="cpu")(x)
    assert got.shape == (1, 48, 80, 3) and np.array_equal(got, want)
    pred = Predictor(model, device="cpu", dtype=None)
    mb = MicroBatcher(pred, max_batch=4, window_ms=5.0)
    try:
        singles = np.random.default_rng(10).random((3, 8, 8, 3), dtype=np.float32)
        outs = [mb(im) for im in singles]
    finally:
        mb.close()
    assert np.allclose(np.stack(outs), pred(singles), atol=1e-5)
    res = process_image(png.read_rgb(zoo / "hr" / "face_00.png"), model)  # an LR input
    assert res["sr"].shape == (256, 256, 3) and "No ground truth" in res["metrics_text"]


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/super-resolve", body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_api_serves_a_transfer_fckpt(zoo, tmp_path, dtype):
    from facesr_torch.app.demo import prepare_inputs

    (tmp_path / "transfer.fckpt").write_bytes((zoo / "ckpt" / "transfer.fckpt").read_bytes())
    srv = port_api.serve(str(tmp_path), port=0, host="127.0.0.1", device="cpu", dtype=dtype)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        img = png.read_rgb(zoo / "hr" / "face_02.png")
        status, body = _post(srv.server_address[1], png.encode(img))
        assert status == 200
        got = png.decode_rgb(body, "response")
        lr, _ = prepare_inputs(img)
        pred = Predictor(load_any_model(tmp_path / "transfer.fckpt"), device="cpu",
                         dtype=torch.bfloat16 if dtype else None)
        assert np.array_equal(got, (pred(lr[None])[0] * 255).round().astype(np.uint8))
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=TIMEOUT)
        conn.request("GET", "/models")
        info = json.loads(conn.getresponse().read())
        conn.close()
        assert info["Transfer"]["model_class"] == "TransferSRModel"
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.close()


def _cheap_activations(images, weights, batch_size=32, device=None):
    """Stands in for the InceptionV3 pool3 activations (a 299x299 network
    on the CPU costs ~2 s an image): the first 64 values of each image."""
    return np.stack([np.asarray(im, np.float64).reshape(-1)[:64] / 255.0 for im in images])


def test_validate_parity_on_port_written_pth(zoo, tmp_path, capsys, monkeypatch):
    """Classify, convert and score port-written artifacts; the FID column's
    wiring runs on stand-in activations (`tests/test_torch_lpips_fid.py`
    holds the network), the converted Inception weights are held bitwise
    to the JAX converter's."""
    sys.path.insert(0, str(ROOT / "tests"))
    from test_convert_parity import _make_alexnet_sd
    from test_fid_inception import _synthetic_state_dict

    from facesr.ckpt.convert import convert_inception_state_dict
    from facesr_torch.evaluation import fid
    from facesr_torch.models.inception import load_inception_weights

    monkeypatch.setattr(fid, "inception_activations", _cheap_activations)

    art = tmp_path / "artifacts"
    art.mkdir()
    custom = _perturbed(FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                            blocks_per_group=2),
                                       seed=6, device="cpu"), 6)
    save_reference_pth(str(art / "custom_model.pth"), custom)
    save_reference_pth(str(art / "transfer_model.pth"),
                       load_any_model(zoo / "ckpt" / "transfer.fckpt"))
    save_reference_pth(str(art / "esrgan_model.pth"),
                       load_any_model(zoo / "ckpt" / "rrdbnet.pth"))
    torch.save({k: torch.from_numpy(v) for k, v in _make_alexnet_sd(seed=7).items()},
               art / "alexnet.pth")
    rng = np.random.default_rng(8)
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(
        np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32) * 0.1)
        for i, c in enumerate([64, 192, 384, 256, 256])}, art / "lpips_alex.pth")
    inception_sd = _synthetic_state_dict(seed=9)
    torch.save({k: torch.from_numpy(v) for k, v in inception_sd.items()},
               art / "pt_inception.pth")
    (art / "garbage.pth").write_bytes(b"not a checkpoint")
    base = ["--artifacts", str(art), "--test-dir", str(zoo / "hr"), "--num-images", "2",
            "--device", "cpu"]
    targets = tmp_path / "targets.json"
    res = validate_parity.run(base + ["--output", str(tmp_path / "o1"),
                                      "--emit-targets", str(targets)])
    assert "SKIP garbage.pth" in capsys.readouterr().out
    assert res["skipped_artifacts"] == ["garbage.pth"]
    emitted = json.loads(targets.read_text())["rows"]
    for row in ("Bicubic", "custom_model", "transfer_model", "esrgan_model"):
        assert {"psnr", "ssim", "lpips", "fid"} <= set(emitted[row])
    # the converted files are .fckpt files both packages read
    conv = tmp_path / "o1" / "converted"
    assert isinstance(jax_load_any_model(str(conv / "transfer_model.fckpt")), tr.TransferSRModel)
    want = convert_inception_state_dict(inception_sd)
    got = load_inception_weights(str(conv / "pt_inception.fckpt"))
    assert all(np.array_equal(got[n][k].permute(2, 3, 1, 0).numpy() if k == "w"
                              else got[n][k].numpy(), want[n][k])
               for n in want for k in ("w", "scale", "bias"))
    assert validate_parity.main(base + ["--output", str(tmp_path / "o2"), "--targets",
                                        str(targets), "--int8", "--calibrate", "2"]) == 0
    out = capsys.readouterr().out
    report = json.loads((tmp_path / "o2" / "parity_report.json").read_text())
    statuses = {(e["row"], e["metric"]): e["status"] for e in report["report"]}
    assert statuses[("transfer_model", "psnr")] == "PASS"
    assert statuses[("custom_model [int8]", "delta_psnr")] == "PASS"
    assert set(report["int8"]) == {"custom_model", "transfer_model", "esrgan_model"}
    assert "A.12.1" not in out and all(
        np.isfinite(report["int8"][m]["agreement_psnr"]) for m in report["int8"])
    bad = json.loads(targets.read_text())
    bad["rows"]["esrgan_model"]["psnr"] += 1.0
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    assert validate_parity.main(base + ["--output", str(tmp_path / "o3"), "--targets",
                                        str(tmp_path / "bad.json")]) == 1


# the transfer YAML's sizes, cut as the stage YAMLs are
TRANSFER_CUTS = (("backbone_blocks: 16", "backbone_blocks: 5"),
                 ("head_channels: 64", "head_channels: 16"),
                 ("batch_size: 32", "batch_size: 2"), ("num_workers: 16", "num_workers: 1"),
                 ("hr_patch_size: 256", "hr_patch_size: 32"),
                 ("lr_patch_size: 64", "lr_patch_size: 8"), ("hr_size: 256", "hr_size: 32"),
                 ("lr_size: 64", "lr_size: 8"), ("epochs: 50", "epochs: 1"))


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """A run directory with the cut transfer YAML and a PNG set (6 training
    HR of 40x40, 2 validation HR 32x32 + LR 8x8)."""
    rng = np.random.default_rng(0)
    for split, n, size in (("train", 6, 40), ("val", 2, 32)):
        (tmp_path / "data" / split / "HR").mkdir(parents=True)
        for i in range(n):
            img = resize_cubic((rng.random((5, 5, 3)) * 255).astype(np.uint8), (size, size))
            png.write_png(tmp_path / "data" / split / "HR" / f"{i:03d}.png", img)
            if split == "val":
                (tmp_path / "data" / split / "LR").mkdir(exist_ok=True)
                png.write_png(tmp_path / "data" / split / "LR" / f"{i:03d}.png",
                              resize_cubic(img, (8, 8)))
    text = (ROOT / "configs" / "transfer_config.yaml").read_text()
    for old, new in TRANSFER_CUTS:
        assert old in text, old
        text = text.replace(old, new)
    (tmp_path / "transfer_config.yaml").write_text(text)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_train_cli_runs_the_transfer_yaml_in_stage_1(workdir, monkeypatch):
    """Stage 1: the head trains, the backbone stays bitwise as built."""
    built = {}
    real = train_cli.create_model

    def create(*a, **k):
        model = built["model"] = real(*a, **k)
        built["start"] = {n: v.clone() for n, v in model.state_dict().items()}
        return model

    monkeypatch.setattr(train_cli, "create_model", create)
    trainer = train_cli.run(["--config", "transfer_config.yaml", "--data-root", "data",
                             "--device", "cpu"])
    model = built["model"]
    assert type(model) is ttr.TransferSRModel and trainer.model_type == "transfer"
    assert model.config == ttr.TransferModelConfig(backbone_blocks=5, head_channels=16)
    now = model.state_dict()
    for n, v in built["start"].items():
        assert torch.equal(now[n], v) == n.startswith("backbone."), n
    ckpt = torch.load(workdir / "checkpoints" / "final_model.pth", weights_only=True)
    assert ckpt["model_type"] == "transfer" and ckpt["model_config"]["backbone_blocks"] == 5
    again = load_any_model(workdir / "checkpoints" / "final_model.pth")
    assert all(torch.equal(again.state_dict()[k], v.cpu()) for k, v in now.items())


def test_train_cli_trains_esrgan(workdir, capsys):
    stage1 = (ROOT / "configs" / "stages" / "stage1_psnr_config.yaml").read_text()
    for old, new in (("batch_size: 48", "batch_size: 2"), ("num_workers: 16", "num_workers: 1"),
                     ("hr_patch_size: 256", "hr_patch_size: 32")):
        stage1 = stage1.replace(old, new)
    (workdir / "stage1.yaml").write_text(stage1)
    trainer = train_cli.run(["--config", "stage1.yaml", "--data-root", "data", "--device", "cpu",
                             "--model", "esrgan", "--epochs", "1"])
    out = capsys.readouterr().out
    assert "does not download" in out and trainer.model_type == "esrgan"
    assert type(trainer.model) is tesr.ESRGANBaseline
    assert np.isfinite(trainer.training_history["train_loss"]).all()
    again = load_any_model(workdir / "checkpoints" / "final_model.pth")
    assert type(again) is tesr.RRDBNet and again.config == tesr.RRDBNetConfig()


def test_train_cli_runs_zoo_qat_pinned_to_a_quant_cache(workdir, capsys):
    """``training.qat: true`` on the cut transfer YAML, with ``--qat-scales``
    from `export_quantized` of another transfer checkpoint of the same
    architecture (a weights mismatch is a note): stage 1 trains the head
    fake-quantized, the backbone stays bitwise as built, the losses are
    finite; the checkpoints keep float weights."""
    from facesr_torch.cli import export_quantized
    from facesr_torch.ops.quant import quantize_conv_kernels

    text = (workdir / "transfer_config.yaml").read_text().replace(
        "training:\n", "training:\n  qat: true\n", 1)
    (workdir / "qat.yaml").write_text(text)
    other = _perturbed(ttr.TransferSRModel(ttr.TransferModelConfig(backbone_blocks=5,
                                                                   head_channels=16),
                                           seed=21, device="cpu"), 21)
    fckpt.save_model(str(workdir / "other.fckpt"), other)
    cache = workdir / "q" / "int8.other.fckpt"
    assert export_quantized.main(["--checkpoint", str(workdir / "other.fckpt"), "--calib-dir",
                                  "data/val/HR", "--calib-hr", "--output", str(cache),
                                  "--device", "cpu"]) == 0
    trainer = train_cli.run(["--config", "qat.yaml", "--data-root", "data", "--device", "cpu",
                             "--qat-scales", str(cache)])
    out = capsys.readouterr().out
    assert "QAT pinned to calibrated activation scales" in out and "different weights" in out
    assert trainer.config.qat and trainer.model_type == "transfer"
    assert set(trainer._qat_sites) == set(quantize_conv_kernels(trainer.model))
    assert all(s.a is not None for s in trainer._qat_sites.values())
    assert np.isfinite(trainer.training_history["train_loss"]).all()
    again = load_any_model(workdir / "checkpoints" / "final_model.pth")
    assert all(v.dtype == torch.float32 for v in again.state_dict().values())
