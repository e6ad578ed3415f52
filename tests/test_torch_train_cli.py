"""The port's training CLI (`python -m facesr_torch.cli.train`) on the
stage YAMLs cut to a tiny model (G=1, B=2, C=16, HR 32, batch 2; stage 3's
discriminator at 8 base channels) on the CPU: stage 1 then stage 2 with
the `.fckpt` -> `.pth` name mapping, stage 3 (GAN) chained from stage 2,
chaining from a JAX-written `.fckpt`, the refusals of what is not ported,
SIGTERM, and `overfit_test` against the JAX package's."""

import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facesr.ckpt import checkpoint as jckpt
from facesr.models import face_enhance_net as fen
from facesr.training.trainer import overfit_test as jax_overfit_test
from facesr_torch.ckpt.weights import state_dict_from_jax_params
from facesr_torch.cli import train as train_cli
from facesr_torch.data import png
from facesr_torch.data.cv_compat import resize_cubic
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.training.trainer import Trainer, overfit_test

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
STAGES = ROOT / "configs" / "stages"
SMALL = fen.FaceEnhanceNetConfig(num_channels=16, num_groups=1, blocks_per_group=2)
# the stage YAMLs' sizes, cut: (text in the YAML, its tiny replacement)
CUTS = (("num_channels: 64", "num_channels: 16"), ("num_groups: 6", "num_groups: 1"),
        ("blocks_per_group: 10", "blocks_per_group: 2"), ("batch_size: 48", "batch_size: 2"),
        ("num_workers: 16", "num_workers: 1"), ("hr_patch_size: 256", "hr_patch_size: 32"))


def _tiny_yaml(stage_file: str, dest: Path) -> Path:
    text = (STAGES / stage_file).read_text()
    cuts = CUTS + ((("d_channels: 64", "d_channels: 8"),) if "gan" in stage_file else ())
    for old, new in cuts:
        assert old in text, old
        text = text.replace(old, new)
    path = dest / stage_file
    path.write_text(text)
    return path


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """A run directory with the tiny stage YAMLs and a PNG set: 6 HR-only
    training faces of 40x40 and 2 validation HR 32x32 + LR 8x8 pairs. The
    YAMLs' relative ./checkpoints lands here."""
    rng = np.random.default_rng(0)
    for split, n, size in (("train", 6, 40), ("val", 2, 32)):
        (tmp_path / "data" / split / "HR").mkdir(parents=True)
        if split == "val":
            (tmp_path / "data" / split / "LR").mkdir()
        for i in range(n):
            img = resize_cubic((rng.random((5, 5, 3)) * 255).astype(np.uint8), (size, size))
            png.write_png(tmp_path / "data" / split / "HR" / f"{i:03d}.png", img,
                          filter_type=i % 5)
            if split == "val":
                png.write_png(tmp_path / "data" / split / "LR" / f"{i:03d}.png",
                              resize_cubic(img, (8, 8)))
    for stage in ("stage1_psnr_config.yaml", "stage2_ssim_config.yaml",
                  "stage3_gan_config.yaml"):
        _tiny_yaml(stage, tmp_path)
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture()
def record_loads(monkeypatch):
    """The path and the model weights right after each
    `Trainer.load_checkpoint`."""
    loads = []
    real = Trainer.load_checkpoint

    def load(self, path, weights_only=False):
        real(self, path, weights_only)
        loads.append((path, {k: v.clone() for k, v in self.model.state_dict().items()}))

    monkeypatch.setattr(Trainer, "load_checkpoint", load)
    return loads


def _run(stage_file, *flags):
    return train_cli.run(["--config", stage_file, "--data-root", "data", "--device", "cpu",
                          *flags])


def _finite(trainer):
    values = list(trainer.last_train_metrics.values())
    values += [v for h in trainer.training_history.values() for v in h]
    return values and all(math.isfinite(v) for v in values)


def test_stage1_then_stage2_chains_through_the_pth_beside_the_fckpt_name(
        workdir, record_loads, capsys):
    # stage 1 also prints the loss every step (logging.console.step_log_every)
    s1 = workdir / "stage1_psnr_config.yaml"
    s1.write_text(s1.read_text().replace("  console:\n", "  console:\n    step_log_every: 1\n"))
    t1 = _run("stage1_psnr_config.yaml", "--epochs", "1")
    out1 = capsys.readouterr().out
    assert "Effective augmentation: horizontal_flip=0.5" in out1 and "W&B: off" in out1
    assert all(f"  step {i}/3 loss " in out1 for i in (1, 2, 3))
    assert len(t1.last_step_times) == 3 and _finite(t1)
    assert t1.last_train_metrics["loader_wait_s"] >= 0 and t1.last_train_metrics["step_ms"] > 0
    assert t1.loss_fn.get_weights() == {"l1": 1.0, "perceptual": 1.0}
    assert {"best_model.pth", "final_model.pth", "best_model.fckpt", "final_model.fckpt"} <= {
        p.name for p in (workdir / "checkpoints").iterdir()}
    assert not record_loads
    best = torch.load(workdir / "checkpoints" / "best_model.pth", map_location="cpu",
                      weights_only=True)["model_state_dict"]

    # a run folder written before the port wrote .fckpt holds the .pth only
    (workdir / "checkpoints" / "best_model.fckpt").unlink()
    t2 = _run("stage2_ssim_config.yaml", "--epochs", "1")
    out2 = capsys.readouterr().out
    assert ("checkpoint.resume ./checkpoints/best_model.fckpt not found; loading the port's "
            "checkpoints/best_model.pth in its place") in out2
    assert "Chaining from stage checkpoint checkpoints/best_model.pth (weights only)" in out2
    (path, loaded), = record_loads
    assert path == "checkpoints/best_model.pth"
    assert set(loaded) == set(best) and all(torch.equal(loaded[k], best[k]) for k in best)
    assert t2.loss_fn.get_weights() == {"l1": 1.0, "perceptual": 0.5, "ssim": 0.2}
    assert "ssim" in t2.last_train_metrics and _finite(t2)
    assert "  step 1/3 loss " not in out2  # the default: every 24 steps
    assert t2.config.learning_rate == 1e-5 and t2.config.scheduler_type == "step"


def test_stage2_chains_from_a_jax_written_fckpt(workdir, record_loads):
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(3), SMALL))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32),
                          params)
    (workdir / "checkpoints").mkdir()
    jckpt.save_model(str(workdir / "checkpoints" / "best_model.fckpt"), params, SMALL)
    (workdir / "checkpoints" / "best_model.pth").write_bytes(b"not read")
    _run("stage2_ssim_config.yaml", "--epochs", "0")
    (path, loaded), = record_loads
    assert path == "./checkpoints/best_model.fckpt"
    want = state_dict_from_jax_params(params)
    assert set(loaded) == set(want) and all(torch.equal(loaded[k], want[k]) for k in want)
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                blocks_per_group=2), device="cpu")
    model.load_state_dict(loaded)
    x = np.random.default_rng(1).random((2, 16, 16, 3), dtype=np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want_out = np.asarray(fen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), SMALL))
    np.testing.assert_allclose(got, want_out, atol=2e-5, rtol=1e-4)


def test_resume_from_the_ports_fckpt_is_a_full_resume(workdir, capsys):
    t1 = _run("stage1_psnr_config.yaml", "--epochs", "1")
    capsys.readouterr()
    t2 = _run("stage1_psnr_config.yaml", "--epochs", "2", "--resume",
              "checkpoints/final_model.fckpt")
    out = capsys.readouterr().out
    assert "Loaded checkpoint from epoch 1" in out and "Epoch 2/2" in out
    assert t2.global_step == 2 * t1.global_step
    assert all(len(v) == 2 and v[0] == t1.training_history[k][0]
               for k, v in t2.training_history.items())


def test_a_missing_chain_checkpoint_raises(workdir):
    with pytest.raises(SystemExit, match="checkpoint.resume not found"):
        _run("stage2_ssim_config.yaml", "--epochs", "1")
    with pytest.raises(SystemExit, match="--resume checkpoint not found"):
        _run("stage1_psnr_config.yaml", "--resume", "nowhere.pth")


def test_stage3_chains_from_stage2_and_trains_the_gan(workdir, record_loads, capsys):
    _run("stage1_psnr_config.yaml", "--epochs", "1")
    _run("stage2_ssim_config.yaml", "--epochs", "1")
    best2 = torch.load(workdir / "checkpoints" / "best_model.pth", map_location="cpu",
                       weights_only=True)["model_state_dict"]
    capsys.readouterr()
    t3 = _run("stage3_gan_config.yaml", "--epochs", "1")
    out = capsys.readouterr().out
    assert "GAN Training Configuration:" in out and "GAN weight: 0.005, type: vanilla" in out
    assert "D LR: 0.0001, D updates/G: 1" in out
    # the stage YAML's best_model.fckpt is the port's own file now
    assert "Chaining from stage checkpoint ./checkpoints/best_model.fckpt (weights only)" in out
    assert "not found; loading the port's" not in out
    path, loaded = record_loads[-1]
    assert path == "./checkpoints/best_model.fckpt"
    assert set(loaded) == set(best2) and all(torch.equal(loaded[k], best2[k]) for k in best2)
    h = t3.training_history
    assert len(h["d_loss"]) == 1 and _finite(t3) and h["d_loss"][0] > 0
    assert all(math.isfinite(v) and v != 0 for k in ("g_loss", "d_real", "d_fake")
               for v in h[k])
    assert t3.loss_fn.get_weights() == {"l1": 0.01, "perceptual": 1.0}
    ckpt = torch.load(workdir / "checkpoints" / "final_model.pth", map_location="cpu",
                      weights_only=True)
    assert ckpt["use_gan"] is True and ckpt["discriminator_config"]["input_size"] == 32


# edits of stage 3's loss.gan section and what they must set
GAN_FIELDS = {
    "unchanged": ((), dict(gan_weight=0.005, gan_type="vanilla", d_learning_rate=1e-4,
                           d_weight_decay=0.0, d_updates_per_g=1, gan_start_epoch=0),
                  dict(input_size=32, base_channels=8, use_bn=True)),
    "edited": ((("type: vanilla", "type: lsgan"), ("d_updates_per_g: 1", "d_updates_per_g: 2"),
                ("start_epoch: 0", "start_epoch: 3"), ("d_use_bn: true", "d_use_bn: false"),
                ("d_weight_decay: 0.0", "d_weight_decay: 0.01"), ("d_lr: 0.0001", "d_lr: 0.0003"),
                ("hr_patch_size: 32", "hr_patch_size: 64")),
               dict(gan_weight=0.005, gan_type="lsgan", d_learning_rate=3e-4,
                    d_weight_decay=0.01, d_updates_per_g=2, gan_start_epoch=3),
               dict(input_size=64, base_channels=8, use_bn=False)),
}


@pytest.mark.parametrize("case", sorted(GAN_FIELDS))
def test_stage3_gan_fields_reach_the_trainer_and_the_discriminator(workdir, case):
    edits, want_cfg, want_disc = GAN_FIELDS[case]
    text = (workdir / "stage3_gan_config.yaml").read_text()
    for old, new in edits:
        assert old in text, old
        text = text.replace(old, new)
    (workdir / "s3.yaml").write_text(text)
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(5), SMALL))
    (workdir / "checkpoints").mkdir()
    jckpt.save_model(str(workdir / "checkpoints" / "best_model.fckpt"), params, SMALL)
    trainer = _run("s3.yaml", "--epochs", "0")
    for k, v in want_cfg.items():
        assert getattr(trainer.config, k) == v, k
    d = trainer.disc
    assert {k: getattr(d.config, k) for k in want_disc} == want_disc
    assert d.blocks[1].bn is None if not want_disc["use_bn"] else d.blocks[1].bn is not None
    assert trainer.use_gan and int(trainer.state.d_opt_state["count"]) == 0


# (config, flags, what the refusal names); --qat-scales is ported and
# refused, as in JAX, only without training.qat, for every family (the
# zoo's QAT is ported: tests/test_torch_zoo_cli.py trains it)
REFUSED = {
    "qat_scales": ("stage1_psnr_config.yaml", ["--qat-scales", "x.npz"],
                   "requires training.qat"),
    # data,model is ported (tests/test_torch_tp.py): without a shape it is
    # JAX's refusal, with [1, 1] it trains
    "mesh_axes": ("stage1_psnr_config.yaml", ["--mesh-axes", "data,model"],
                  "mesh_shape is required with multiple mesh_axes"),
    # three axes are ported (tests/test_torch_sp_tp.py): without a shape it
    # is JAX's refusal, with [1, 1, 1] it trains
    "mesh_shape": ("stage1_psnr_config.yaml", ["--mesh-axes", "data,space,model"],
                   "mesh_shape is required with multiple mesh_axes"),
    # --print-memory is ported, and data,pp (tests/test_torch_pp.py): without a
    # shape it is JAX's refusal, with [1, 1] it reports and trains
    "print_memory": ("stage1_psnr_config.yaml", ["--print-memory", "--mesh-axes", "data,pp"],
                     "mesh_shape is required with multiple mesh_axes"),
    "transfer": ("stage1_psnr_config.yaml", ["--model", "transfer", "--qat-scales", "x.npz"],
                 "requires training.qat"),
    "esrgan": ("stage1_psnr_config.yaml", ["--model", "esrgan", "--qat-scales", "x.npz"],
               "requires training.qat"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_what_is_not_ported_raises_and_names_its_roadmap_item(workdir, what):
    config, flags, item = REFUSED[what]
    if what in ("mesh_axes", "print_memory", "mesh_shape"):
        with pytest.raises(ValueError, match=item):
            _run(config, *flags)
        shape = "1,1,1" if what == "mesh_shape" else "1,1"
        trainer = _run(config, *flags, "--mesh-shape", shape, "--epochs", "1")
        assert trainer.mesh.shape == tuple(map(int, shape.split(","))) and trainer.global_step > 0
        return
    with pytest.raises(SystemExit, match=item):
        _run(config, *flags)


@pytest.mark.parametrize("section", ["mesh_shape: [4, 2]", "mesh_axes: data,space",
                                     "pp_microbatches: 4"])
def test_what_is_not_ported_in_the_yaml_raises(workdir, section):
    """The YAML's mesh_shape, mesh_axes and pp_microbatches are read
    (data,space trains: tests/test_torch_sp.py; data,pp:
    tests/test_torch_pp.py)."""
    text = (workdir / "stage1_psnr_config.yaml").read_text()
    text = text.replace("training:\n", f"training:\n  {section}\n", 1)
    (workdir / "s.yaml").write_text(text)
    if section == "mesh_shape: [4, 2]":  # a plain launch starts the grid's 8 ranks
        assert train_cli._ranks_to_start(["--config", "s.yaml", "--mesh-axes",
                                          "data,space"]) == 8
        with pytest.raises(ValueError, match="does not fit the mesh axes data"):
            _run("s.yaml")
    elif section == "mesh_axes: data,space":  # JAX's message without a shape; 1x1 trains
        with pytest.raises(ValueError, match="mesh_shape is required with multiple mesh_axes"):
            _run("s.yaml")
        trainer = _run("s.yaml", "--mesh-shape", "1,1", "--epochs", "1")
        assert trainer.mesh.shape == (1, 1) and trainer.global_step > 0
    else:  # as scripts/train.py reads it: a rank's 2 rows padded to the 4 microbatches
        trainer = _run("s.yaml", "--mesh-axes", "data,pp", "--mesh-shape", "1,1", "--epochs",
                       "1")
        assert trainer.config.pp_microbatches == 4 and trainer._batch_divisor == 4
        assert trainer.global_step > 0


# the QAT rehearsal YAML's sizes, cut as the stage YAMLs are
QAT_CUTS = CUTS[:3] + (("batch_size: 64", "batch_size: 2"), ("num_workers: 4", "num_workers: 1"),
                       ("hr_patch_size: 128", "hr_patch_size: 32"),
                       ("lr_patch_size: 32", "lr_patch_size: 8"), ("hr_size: 128", "hr_size: 32"),
                       ("lr_size: 32", "lr_size: 8"), ("epochs: 8", "epochs: 1"),
                       ("data_root: /tmp/rehearsal/processed", "data_root: data"),
                       ("save_dir: /tmp/rehearsal/ckpt_s1_qat", "save_dir: ./ckpt_qat"))


def test_qat_yaml_trains_and_qat_scales_pin_its_grid(workdir, capsys):
    """configs/rehearsal/stage1_qat_ft.yaml (training.qat: true) trains
    fake-quantized; a quant cache exported from its best checkpoint then
    pins the next run's activation grid (--qat-scales; that run starts
    from other weights, which is only a note)."""
    from facesr_torch.cli import export_quantized
    from facesr_torch.ops.quant import FakeQuant

    text = (ROOT / "configs" / "rehearsal" / "stage1_qat_ft.yaml").read_text()
    for old, new in QAT_CUTS:
        assert old in text, old
        text = text.replace(old, new)
    (workdir / "qat.yaml").write_text(text)
    t1 = _run("qat.yaml")
    assert t1.config.qat and _finite(t1) and len(t1.training_history["val_psnr"]) == 1
    assert all(isinstance(s, FakeQuant) and s.a is None for s in t1._qat_sites.values())
    assert (workdir / "ckpt_qat" / "best_model.pth").exists()
    assert export_quantized.main(["--checkpoint", "ckpt_qat/best_model.pth", "--calib-dir",
                                  "data/val/HR", "--calib-hr", "--output", "q/int8.fckpt",
                                  "--device", "cpu"]) == 0
    from facesr_torch.models.load import load_any_model
    from facesr_torch.parallel.serving import load_calibrated_qparams

    cal = load_calibrated_qparams(load_any_model("ckpt_qat/best_model.pth"), "q/int8.fckpt")
    capsys.readouterr()
    t2 = _run("qat.yaml", "--qat-scales", "q/int8.fckpt")
    out = capsys.readouterr().out
    assert "calibrated from different weights" in out and "QAT pinned" in out
    assert set(t2._qat_sites) == set(cal)
    assert all(torch.equal(t2._qat_sites[k].a, cal[k].a) for k in cal) and _finite(t2)


def test_without_device_it_runs_on_cuda_or_raises(workdir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        train_cli.run(["--config", "stage1_psnr_config.yaml", "--data-root", "data"])


def test_fast_loader_builds_the_native_hr_loader(workdir, capsys):
    args = train_cli.parse_args(["--config", "stage1_psnr_config.yaml", "--fast-loader"])
    cfg = train_cli.load_config("stage1_psnr_config.yaml")
    loader, val = train_cli.make_loaders(args, cfg, "data", 2, seed=42)
    out = capsys.readouterr().out
    assert "Fast loader: native assembler built" in out
    assert "WARNING: --fast-loader drops augmentations: color_jitter (p=0.3)" in out
    batches = list(loader)
    assert len(batches) == 3 and all(set(b) == {"hr"} and b["hr"].shape == (2, 32, 32, 3)
                                     for b in batches)
    assert [b["hr"].shape for b in val] == [(2, 32, 32, 3)]


def test_sigterm_saves_interrupted_pth(workdir):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                       os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "facesr_torch.cli.train", "--config",
         "stage1_psnr_config.yaml", "--data-root", "data", "--device", "cpu"],
        cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        started = False
        for line in proc.stdout:
            if "Epoch 1/" in line:
                started = True
                break
            if time.monotonic() > deadline:
                break
        assert started, "training never started"
        proc.send_signal(signal.SIGTERM)
        out = proc.stdout.read()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, out[-2000:]
    assert "Training interrupted (SIGTERM)" in out, out[-2000:]
    ckpt = torch.load(workdir / "checkpoints" / "interrupted.pth", map_location="cpu",
                      weights_only=True)
    assert set(ckpt["model_state_dict"]) == set(FaceEnhanceNet(FaceEnhanceNetConfig(
        num_channels=16, num_groups=1, blocks_per_group=2), device="cpu").state_dict())


def test_overfit_test_follows_the_jax_package():
    params = jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(4), SMALL))
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * 0.02).astype(np.float32),
                          params)
    hr = resize_cubic((rng.random((6, 6, 3)) * 255).astype(np.uint8), (32, 32))
    batch = {"hr": np.stack([np.roll(hr, 3 * i, axis=1) for i in range(8)]
                            ).astype(np.float32) / 255}
    kw = dict(num_images=8, num_iterations=3, learning_rate=2e-4)
    want = jax_overfit_test(fen.FaceEnhanceNet(SMALL, params=params), [batch], **kw)
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=16, num_groups=1,
                                                blocks_per_group=2), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    got = overfit_test(model, [batch], device="cpu", **kw)
    assert got["converged"] == want["converged"]
    np.testing.assert_allclose(got["loss_history"], want["loss_history"], rtol=1e-4)
    np.testing.assert_allclose(got["psnr_history"], want["psnr_history"], rtol=1e-5)
