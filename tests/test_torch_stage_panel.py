"""The port's `stage_panel` CLI (facesr_torch.cli.stage_panel) against the
JAX script `scripts/stage_panel.py` (run in this process with
``--platform cpu``) on the same two small `.fckpt` files and synthetic
PNGs, on the CPU.

Sizes: FaceEnhanceNet G=2, B=2, C=16 (conv_last non-zero), five smooth
64x64 PNGs of which four are sampled.

Limits: the panels are equal outside the label bars (the JAX script draws
Hershey text there, the port leaves the bar plain), uint8 values at most 1
apart on at most 0.5% of pixels: the port's bicubic LR sits up to 1.8e-7
from JAX's and moves single uint8 LR values (ROADMAP C, last-bit LR
synthesis), which the model carries to a few output pixels.
"""

import importlib.util
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from facesr.ckpt import checkpoint as jckpt
from facesr.models import face_enhance_net as fen
from facesr_torch.cli import stage_panel
from facesr_torch.data.png import read_rgb, write_png

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SMALL = fen.FaceEnhanceNetConfig(num_channels=16, num_groups=2, blocks_per_group=2)
BAR = 22
MAX_OFF_SHARE = 0.005


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_stage_panel",
                                                  ROOT / "scripts" / "stage_panel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params(seed):
    """JAX params (numpy) of a seeded port model, every leaf moved off its
    init and conv_last redrawn non-zero (JAX's eager init costs seconds)."""
    from facesr_torch.ckpt.weights import jax_params_from
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig

    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=2,
                                                blocks_per_group=2), seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
        model.conv_last.weight.normal_(0, 0.05, generator=gen)
    return jax_params_from(model)


def write_faces(d: Path, n=5, size=64, seed=3):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        lo = rng.random((size // 8, size // 8, 3))
        img = cv2.resize(lo, (size, size), interpolation=cv2.INTER_CUBIC)
        write_png(d / f"face_{i:02d}.png", (np.clip(img, 0, 1) * 255).round().astype(np.uint8))
    return d


@pytest.fixture(scope="module")
def panelset(tmp_path_factory):
    root = tmp_path_factory.mktemp("panel")
    ckpts = []
    for stage, seed in (("s1", 11), ("s2", 12)):
        (root / stage).mkdir()
        path = root / stage / "best_model.fckpt"
        jckpt.save_model(str(path), _params(seed), SMALL)
        ckpts.append(str(path))
    return {"ckpts": ckpts, "hr": write_faces(root / "hr"), "root": root}


def run_jax(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["stage_panel.py"] + argv + ["--platform", "cpu"])
    _jax_script().main()
    return capsys.readouterr().out


def run_port(argv, capsys):
    path = stage_panel.main(argv + ["--device", "cpu"])
    return path, capsys.readouterr().out


def _bar_rows(out_dir: Path, names):
    """The rows of stage_panel.png that are label bars, from the heights of
    the per-region panels in panel order."""
    rows, off = [], 0
    for name in names:
        h = read_rgb(out_dir / name).shape[0]
        rows.extend(range(off, off + BAR))
        off += h + 4
    return rows


def compare_panels(jax_dir: Path, port_dir: Path, stems, regions):
    names = [f"panel_{s}_{r}.png" for s in stems for r in regions]
    assert {p.name for p in port_dir.glob("*.png")} == {p.name for p in jax_dir.glob("*.png")} \
        == set(names) | {"stage_panel.png"}
    report = {}
    for name, bars in [(n, list(range(BAR))) for n in names] + [
            ("stage_panel.png", _bar_rows(port_dir, names))]:
        got = read_rgb(port_dir / name).astype(int)
        want = cv2.cvtColor(cv2.imread(str(jax_dir / name)), cv2.COLOR_BGR2RGB).astype(int)
        assert got.shape == want.shape, name
        assert np.isin(got[bars], (0, 32)).all(), name  # plain grey bars, black padding
        keep = np.ones(got.shape[0], bool)
        keep[bars] = False
        diff = np.abs(got[keep] - want[keep])
        share = float((diff > 0).any(axis=-1).mean())
        report[name] = (int(diff.max()), share)
        assert diff.max() <= 1 and share <= MAX_OFF_SHARE, (name, report[name])
    return report


def test_the_panels_match_the_jax_script(panelset, tmp_path, monkeypatch, capsys):
    common = ["--checkpoints", *panelset["ckpts"], "--test-dir", str(panelset["hr"]),
              "--num-images", "4", "--seed", "7", "--zoom", "2"]
    jout = run_jax(common + ["--output", str(tmp_path / "jax")], monkeypatch, capsys)
    path, pout = run_port(common + ["--output", str(tmp_path / "port")], capsys)
    assert path == tmp_path / "port" / "stage_panel.png"
    jcols, pcols = (out.split("columns: ")[1].strip().rstrip(")") for out in (jout, pout))
    assert pcols == jcols == "bicubic, s1, s2, GT"
    assert (tmp_path / "port" / "stage_panel_columns.txt").read_text().strip() == pcols
    picks = sorted(np.random.default_rng(7).choice(5, size=4, replace=False).tolist())
    report = compare_panels(tmp_path / "jax", tmp_path / "port",
                            [f"face_{i:02d}" for i in picks], ["eyes", "mouth"])
    print(f"max |diff|, share of pixels off per panel: {report}")


@pytest.mark.parametrize("extra,message", [
    (["--labels", "a", "a"], "Duplicate or reserved labels"),
    (["--labels", "a", "GT"], "Duplicate or reserved labels"),
    (["--labels", "bicubic", "b"], "Duplicate or reserved labels"),
    (["--labels", "only"], "--labels must match --checkpoints"),
    (["--regions", "eyes,nose"], "Unknown region 'nose'"),
], ids=["duplicate", "gt", "bicubic", "count", "region"])
def test_refusals_match_the_jax_script(panelset, tmp_path, monkeypatch, capsys, extra, message):
    argv = ["--checkpoints", *panelset["ckpts"], "--test-dir", str(panelset["hr"]),
            "--output", str(tmp_path / "out")] + extra
    with pytest.raises(SystemExit) as jax_exit:
        run_jax(argv, monkeypatch, capsys)
    with pytest.raises(SystemExit) as port_exit:
        run_port(argv, capsys)
    assert str(port_exit.value) == str(jax_exit.value)
    assert message in str(port_exit.value)


def test_other_image_formats_and_an_empty_folder_are_refused(panelset, tmp_path, capsys):
    """JPEG files read now (`data.codecs`): a corrupt one is skipped as the
    JAX script skips it, and a JPEG the port does not decode (CMYK) raises
    by name."""
    from PIL import Image

    from facesr_torch.parallel.mesh import NotPorted

    (tmp_path / "jpg").mkdir()
    (tmp_path / "jpg" / "a.jpg").write_bytes(b"\xff\xd8\xff")
    argv = ["--checkpoints", panelset["ckpts"][0], "--output", str(tmp_path / "out")]
    with pytest.raises(SystemExit, match="unreadable"):
        run_port(argv + ["--test-dir", str(tmp_path / "jpg")], capsys)
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).convert("CMYK").save(
        tmp_path / "jpg" / "a.jpg")
    with pytest.raises(NotPorted, match="a.jpg: CMYK"):
        run_port(argv + ["--test-dir", str(tmp_path / "jpg")], capsys)
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="No test images"):
        run_port(argv + ["--test-dir", str(tmp_path / "empty")], capsys)


def test_the_jax_script_reads_port_trainer_files(panelset, tmp_path, monkeypatch, capsys):
    """The port's Trainer writes ``.fckpt`` files that the JAX script
    loads (EMA weights, as it prefers them): the panels match the port's."""
    from facesr_torch.losses.combined import CombinedLoss, LossConfig
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(8)
    batches = [{"hr": rng.random((4, 32, 32, 3), dtype=np.float32)}]
    ckpts = []
    for stage, seed in (("stage1", 1), ("stage2", 2)):
        model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=2,
                                                    blocks_per_group=2), seed=seed, device="cpu")
        with torch.no_grad():
            model.conv_last.weight.normal_(0, 0.05, generator=torch.Generator().manual_seed(seed))
        loss = CombinedLoss(LossConfig(l1_weight=1.0, perceptual_weight=0.0), device="cpu")
        Trainer(model, batches, batches, loss,
                TrainerConfig(epochs=1, use_amp=False, ema_decay=0.5, step_log_every=0,
                              checkpoint_dir=str(tmp_path / stage)), device="cpu").train()
        ckpts.append(str(tmp_path / stage / "best_model.fckpt"))
    common = ["--checkpoints", *ckpts, "--test-dir", str(panelset["hr"]), "--num-images", "2",
              "--regions", "eyes"]
    run_jax(common + ["--output", str(tmp_path / "jax")], monkeypatch, capsys)
    _, pout = run_port(common + ["--output", str(tmp_path / "port")], capsys)
    assert "columns: bicubic, stage1, stage2, GT" in pout
    picks = sorted(np.random.default_rng(0).choice(5, size=2, replace=False).tolist())
    compare_panels(tmp_path / "jax", tmp_path / "port", [f"face_{i:02d}" for i in picks],
                   ["eyes"])
