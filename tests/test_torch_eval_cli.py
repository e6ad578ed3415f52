"""The port's evaluation CLIs (`python -m facesr_torch.cli.test_model`,
`python -m facesr_torch.cli.compare_two_models`) against the JAX package's
`scripts/test_model.py` and `scripts/compare_two_models.py` (run in this
process with ``--platform cpu``) on the same JAX-written 2x2x16 `.fckpt`
and the same 6 PNGs, on the CPU; the batched path against ``--per-image``;
and the refusals of what is not ported."""

import importlib.util
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from facesr.ckpt import checkpoint as jckpt
from facesr.models import face_enhance_net as fen
from facesr_torch.ckpt import fckpt
from facesr_torch.cli import compare_two_models as port_compare
from facesr_torch.cli import test_model as port_test
from facesr_torch.data import png
from facesr_torch.data.cv_compat import resize_cubic
from facesr_torch.evaluation import metrics as port_metrics
from facesr_torch.models import lpips

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = fen.FaceEnhanceNetConfig(num_channels=16, num_groups=2, blocks_per_group=2)
# per-image tolerances against the JAX scripts: the two packages' f32
# forwards and LR synthesis differ in the last bits, which can move a uint8
# SR value by one level at a rounding boundary
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5
# a baseline row is exact where both packages round the LR to the same
# uint8 values (the resize copies are exact, or within one level for
# cubic: test_torch_evaluation.py); where an LR value rounds one level
# apart (seen: 1 of 270 values of a 40x36 face, 0.0028 dB), this bound
BASELINE_PSNR_TOL, BASELINE_SSIM_TOL = 1e-2, 1e-4


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def evalset(tmp_path_factory):
    """A JAX-written model checkpoint (conv_last non-zero so the SR is not
    the bicubic skip), 6 HR PNGs (4 of 32x32, 2 of 40x36) and LPIPS
    weights written by the port."""
    root = tmp_path_factory.mktemp("evalset")
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(5), SMALL))
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32),
                          params)
    (root / "ckpt").mkdir()
    jckpt.save_model(str(root / "ckpt" / "best_model.fckpt"), params, SMALL)
    (root / "hr").mkdir()
    for i in range(6):
        h, w = (32, 32) if i < 4 else (40, 36)
        lo = (rng.random((5, 5, 3)) * 255).astype(np.uint8)
        img = np.clip(resize_cubic(lo, (w, h)).astype(int) + rng.integers(-12, 13, (h, w, 3)),
                      0, 255).astype(np.uint8)
        png.write_png(root / "hr" / f"face_{i:02d}.png", img)
    lp = lpips.init_random_alexnet(torch.Generator().manual_seed(6))
    lpips.save_lpips_weights(str(root / "lpips_alex.fckpt"), lp)
    return root


@pytest.fixture()
def no_eval_weights(monkeypatch):
    monkeypatch.delenv("FACESR_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("FACESR_INCEPTION_WEIGHTS", raising=False)


def _jax_test_model(monkeypatch, argv):
    mod = _jax_script("test_model")
    rows = []
    real = mod._print_row

    def record(r):
        rows.append(r)
        real(r)

    monkeypatch.setattr(mod, "_print_row", record)
    monkeypatch.setattr(sys, "argv", ["test_model.py"] + argv + ["--platform", "cpu"])
    mod.main()
    return rows


def _close(got, want, what, tols=(PSNR_TOL, SSIM_TOL)):
    for key, tol in zip(("psnr", "ssim"), tols):
        g, w = got[key], want[key]
        assert (math.isinf(g) and g == w) or abs(g - w) <= tol, (what, key, g, w)


def _lr_uint8_differing(path, scale=4):
    """How many LR uint8 values of an HR file the two packages' LR
    syntheses round apart."""
    import jax.numpy as jnp

    from facesr.ops import bicubic_down as jax_down
    from facesr_torch.evaluation.batched import to_uint8
    from facesr_torch.ops.resize import bicubic_down

    hr = png.read_rgb(path).astype(np.float32)[None] / 255.0
    a = to_uint8(np.asarray(jax_down(jnp.asarray(hr), scale))[0])
    b = to_uint8(bicubic_down(torch.from_numpy(hr), scale).numpy()[0])
    return int((a != b).sum())


def _close_baseline(got, want, path):
    """Exact where the LR agrees (SSIM to the skimage copies' 1e-9: a box
    filter by running sums against cv2's), else within the stated bound."""
    if _lr_uint8_differing(path) == 0:
        assert got["psnr"] == want["psnr"] and abs(got["ssim"] - want["ssim"]) <= 1e-9, \
            (path.name, got, want)
    else:
        _close(got, want, path.name, (BASELINE_PSNR_TOL, BASELINE_SSIM_TOL))


def test_test_model_rows_match_the_jax_script(evalset, monkeypatch, no_eval_weights, tmp_path):
    args = ["--checkpoint", str(evalset / "ckpt" / "best_model.fckpt"),
            "--input", str(evalset / "hr")]
    want = _jax_test_model(monkeypatch, args + ["--output", str(tmp_path / "jax")])
    got = port_test.run(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    assert [r["file"] for r in got] == [r["file"] for r in want] and len(got) == 6
    worst = max(abs(g[m]["psnr"] - w[m]["psnr"]) for g, w in zip(got, want)
                for m in ("model", "bicubic"))
    lr_apart = {r["file"]: _lr_uint8_differing(evalset / "hr" / r["file"]) for r in want}
    print(f"largest per-image PSNR gap to the JAX script: {worst:.3g} dB; LR uint8 values "
          f"rounded apart by file: {lr_apart}")
    for g, w in zip(got, want):
        _close(g["model"], w["model"], g["file"])
        _close_baseline(g["bicubic"], w["bicubic"], evalset / "hr" / g["file"])
    differing = 0
    for kind in ("sr", "comparison"):
        for f in sorted((tmp_path / "jax").glob(f"*_{kind}.png")):
            a = png.read_rgb(f)
            b = png.read_rgb(tmp_path / "port" / f.name)
            assert a.shape == b.shape and np.abs(a.astype(int) - b).max() <= 1
            differing += int((a != b).sum())
    print(f"SR and comparison PNG values differing from the JAX script's: {differing}")


def test_test_model_batched_against_per_image(evalset, no_eval_weights, tmp_path):
    """Baselines equal; the model's SR within one uint8 level. The CPU's
    conv kernels sum in another order at batch 1 than at batch 8 for some
    shapes (3.4e-6 at the 10x9 LR here, none at 8x8), which moves a value
    across a rounding boundary now and then."""
    args = ["--checkpoint", str(evalset / "ckpt" / "best_model.fckpt"),
            "--input", str(evalset / "hr"), "--device", "cpu", "--no-comparison"]
    batched = port_test.run(args + ["--output", str(tmp_path / "b")])
    single = port_test.run(args + ["--output", str(tmp_path / "s"), "--per-image"])
    differing = 0
    for b, s1 in zip(batched, single):
        assert b["file"] == s1["file"] and b["bicubic"] == s1["bicubic"]
        _close(b["model"], s1["model"], b["file"])
        x = png.read_rgb(tmp_path / "b" / f"{Path(b['file']).stem}_sr.png").astype(int)
        y = png.read_rgb(tmp_path / "s" / f"{Path(b['file']).stem}_sr.png")
        assert np.abs(x - y).max() <= 1
        differing += int((x != y).sum())
    print(f"batched vs --per-image: {differing} SR values one level apart")


def _record_compare(monkeypatch, module, attr):
    calls = []
    real = getattr(module, attr)

    def record(sr, hr, *rest):
        m = real(sr, hr, *rest)
        calls.append(m)
        return m

    monkeypatch.setattr(module, attr, record)
    return calls


def test_compare_rows_match_the_jax_script(evalset, monkeypatch, no_eval_weights, tmp_path):
    monkeypatch.setenv("FACESR_LPIPS_WEIGHTS", str(evalset / "lpips_alex.fckpt"))
    args = ["--checkpoint-dir", str(evalset / "ckpt"), "--test-dir", str(evalset / "hr"),
            "--num-images", "6", "--save-every", "3"]
    mod = _jax_script("compare_two_models")
    jax_calls = _record_compare(monkeypatch, mod, "compute_metrics")
    monkeypatch.setattr(sys, "argv", ["compare_two_models.py"] + args
                        + ["--output", str(tmp_path / "jax"), "--platform", "cpu"])
    mod.main()
    port_calls = _record_compare(monkeypatch, port_test, "compute_metrics")
    port_lpips = []
    real_lpips = port_metrics.LPIPS.__call__

    def lpips_call(self, a, b):
        v = real_lpips(self, a, b)
        port_lpips.append(float(v))
        return v

    monkeypatch.setattr(port_metrics.LPIPS, "__call__", lpips_call)
    res = port_compare.run(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    methods = ["Bilinear", "Bicubic", "Lanczos4", "Best Model"]
    assert res["methods"] == methods and res["images"] == 6
    assert len(port_calls) == len(jax_calls) == 6 * len(methods)
    files = sorted((evalset / "hr").iterdir())
    for i, (g, w) in enumerate(zip(port_calls, jax_calls)):
        if methods[i % 4] == "Best Model":
            _close(g, w, (files[i // 4].name, "Best Model"))
        else:
            _close_baseline(g, w, files[i // 4])
    gaps = {m: max(abs(g["psnr"] - w["psnr"]) for i, (g, w) in
                   enumerate(zip(port_calls, jax_calls)) if methods[i % 4] == m)
            for m in methods}
    print(f"largest per-image PSNR gap to the JAX script by method: {gaps}")
    # LPIPS of the same output image (its PSNR equal to the bit) within
    # 1e-5 relative; an output one uint8 level apart moves it more
    same = [(g, w["lpips"]) for g, w, c in zip(port_lpips, jax_calls, port_calls)
            if c["psnr"] == w["psnr"]]
    assert len(port_lpips) == len(jax_calls) and len(same) >= 20
    for g, w in same:
        assert abs(g - w) <= 1e-5 * abs(w), (g, w)
    for j, m in enumerate(methods):
        assert res["summary"][m]["lpips"] == np.mean(port_lpips[j::4])
    jax_text = (tmp_path / "jax" / "results_summary.txt").read_text().splitlines()
    port_text = (tmp_path / "port" / "results_summary.txt").read_text().splitlines()
    assert port_text[:len(jax_text)] == jax_text  # the port adds the strip column order
    assert port_text[-1] == "Strip columns, left to right: " + ", ".join(methods + ["GT"])
    strips = sorted(p.name for p in (tmp_path / "port" / "samples").iterdir())
    assert strips == sorted(p.name for p in (tmp_path / "jax" / "samples").iterdir()) \
        == ["compare_0000.png", "compare_0003.png"]


def test_compare_batched_against_per_image_and_crops_hr(evalset, no_eval_weights, tmp_path):
    """The baseline rows equal, the model's within the per-image
    tolerances (see the test_model case); an HR of 34x35 is cropped,
    centred, to 32x32."""
    hr = tmp_path / "hr"
    hr.mkdir()
    for f in sorted((evalset / "hr").iterdir())[:3]:
        (hr / f.name).write_bytes(f.read_bytes())
    odd = np.random.default_rng(7).integers(0, 256, (34, 35, 3), dtype=np.uint8)
    png.write_png(hr / "odd.png", odd)
    args = ["--checkpoint-dir", str(evalset / "ckpt"), "--test-dir", str(hr),
            "--save-every", "1", "--device", "cpu"]
    batched = port_compare.run(args + ["--output", str(tmp_path / "b")])
    single = port_compare.run(args + ["--output", str(tmp_path / "s"), "--per-image"])
    assert batched["images"] == 4 and set(batched["timings"]) == set(port_compare.STAGES)
    for m in ("Bilinear", "Bicubic", "Lanczos4"):
        assert batched["summary"][m] == single["summary"][m]
    _close(batched["summary"]["Best Model"], single["summary"]["Best Model"], "Best Model")
    strip = png.read_rgb(tmp_path / "b" / "samples" / "compare_0003.png")
    assert strip.shape == (32, 32 * 5, 3)
    assert np.array_equal(strip[:, -32:], odd[1:33, 1:33])


def test_compare_skips_unloadable_checkpoints_and_unreadable_images(evalset, no_eval_weights,
                                                                    tmp_path, capsys):
    ckpts = tmp_path / "ckpt"
    ckpts.mkdir()
    (ckpts / "best_model.fckpt").write_bytes((evalset / "ckpt" / "best_model.fckpt").read_bytes())
    fckpt.save_checkpoint(str(ckpts / "esrgan.fckpt"), {"params": {"w": np.zeros(2)}},
                          {"model_type": "esrgan"})
    (ckpts / "broken.pth").write_bytes(b"not a checkpoint")
    hr = tmp_path / "hr"
    hr.mkdir()
    for f in sorted((evalset / "hr").iterdir())[:2]:
        (hr / f.name).write_bytes(f.read_bytes())
    (hr / "zz_corrupt.png").write_bytes(b"\x89PNG\r\n\x1a\n garbage")
    res = port_compare.run(["--checkpoint-dir", str(ckpts), "--test-dir", str(hr),
                            "--output", str(tmp_path / "out"), "--device", "cpu"])
    out = capsys.readouterr().out
    # the zoo loads now; a zoo file without its weights is skipped, named
    assert "Skipping" in out and "esrgan.fckpt" in out and "broken.pth" in out
    assert "skipping unreadable image zz_corrupt.png" in out
    assert res["methods"] == ["Bilinear", "Bicubic", "Lanczos4", "Best Model"]
    assert res["images"] == 2


def test_find_checkpoints_names_like_jax(tmp_path):
    for name in ("best_model.fckpt", "bicubic.fckpt", "my_run.fckpt"):
        (tmp_path / name).write_bytes(b"")
    want = _jax_script("compare_two_models").find_checkpoints(str(tmp_path))
    got = port_compare.find_checkpoints(str(tmp_path))
    assert {k: v.name for k, v in got.items()} == {k: v.name for k, v in want.items()}
    assert "Bicubic (model)" in got
    (tmp_path / "best_model.pth").write_bytes(b"")
    got = port_compare.find_checkpoints(str(tmp_path))
    assert got["Best Model"].name == "best_model.fckpt"
    assert got["Best Model (model)"].name == "best_model.pth"


@pytest.mark.parametrize("flags", [
    ["--serve-dtype", "int8"],
    ["--serve-dtype", "int8_full", "--calibrate", "2"],
    ["--serve-dtype", "bf16", "--per-image"],
])
def test_compare_refuses_what_is_not_ported(evalset, flags, monkeypatch, no_eval_weights,
                                            tmp_path):
    """A serve dtype with --per-image is refused. The int8 serve dtypes
    were refused until they were ported; now they serve, and the model's
    mean PSNR and SSIM sit within 0.05 dB and 1e-3 of the JAX script's with
    the same flags (the baselines within the baseline tolerance: the LR
    synthesis differs in the last bits). The quantized
    forwards' bf16 float ops round differently in the two packages
    (test_torch_quant.py), which moves single uint8 levels."""
    args = ["--checkpoint-dir", str(evalset / "ckpt"), "--test-dir", str(evalset / "hr"),
            "--num-images", "6", "--save-every", "100"] + flags
    if "--per-image" in flags:
        with pytest.raises(SystemExit, match="drop --per-image"):
            port_compare.run(args + ["--device", "cpu"])
        return
    mod = _jax_script("compare_two_models")
    jax_calls = _record_compare(monkeypatch, mod, "compute_metrics")
    monkeypatch.setattr(sys, "argv", ["compare_two_models.py"] + args
                        + ["--output", str(tmp_path / "jax"), "--platform", "cpu"])
    mod.main()
    res = port_compare.run(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    want = {k: np.mean([c[k] for c in jax_calls[3::4]]) for k in ("psnr", "ssim")}
    got = res["summary"]["Best Model"]
    assert abs(got["psnr"] - want["psnr"]) <= 0.05 and abs(got["ssim"] - want["ssim"]) <= 1e-3
    for j, m in enumerate(("Bilinear", "Bicubic", "Lanczos4")):
        want_m = np.mean([c["psnr"] for c in jax_calls[j::4]])
        assert abs(res["summary"][m]["psnr"] - want_m) <= BASELINE_PSNR_TOL


def test_test_model_refusals(evalset, tmp_path, monkeypatch, no_eval_weights):
    ckpt = str(evalset / "ckpt" / "best_model.fckpt")
    # --exported serves a .pt2 artifact now (tests/test_torch_export.py); a
    # missing one raises with its name
    with pytest.raises(FileNotFoundError, match="x.pt2"):
        port_test.run(["--exported", str(tmp_path / "x.pt2"), "--input", str(evalset / "hr"),
                       "--device", "cpu"])
    (tmp_path / "face.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(IOError, match="face.jpg"):
        port_test.run(["--checkpoint", ckpt, "--input", str(tmp_path / "face.jpg"),
                       "--device", "cpu", "--no-save"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test.run(["--checkpoint", ckpt, "--input", str(evalset / "hr")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_compare.run(["--checkpoint-dir", str(evalset / "ckpt"),
                          "--test-dir", str(evalset / "hr")])


def test_load_model_takes_the_pth_ema_and_the_config_override(evalset, tmp_path):
    cfg, sd = fckpt.load_model(str(evalset / "ckpt" / "best_model.fckpt"))
    ema = {k: v + 0.01 for k, v in sd.items()}
    torch.save({"model_state_dict": sd, "ema_state_dict": ema,
                "config": {"num_channels": 16, "num_groups": 2, "blocks_per_group": 2}},
               tmp_path / "m.pth")
    model = port_test.load_model(str(tmp_path / "m.pth"))
    assert all(torch.equal(model.state_dict()[k], ema[k]) for k in ema)
    (tmp_path / "cfg.yaml").write_text("model:\n  custom:\n    num_channels: 16\n"
                                       "    num_groups: 2\n    blocks_per_group: 2\n"
                                       "    upscale_factor: 4\n")
    model = port_test.load_model(str(evalset / "ckpt" / "best_model.fckpt"),
                                 config_yaml=str(tmp_path / "cfg.yaml"))
    assert model.config.num_groups == 2 and model.config.scale_factor == 4
