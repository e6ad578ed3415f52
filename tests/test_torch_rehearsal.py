"""The port's auxiliaries on the CPU: the dress rehearsal
(`cli.dress_rehearsal`: its generated configs as ``scripts/dress_rehearsal.sh``
writes them, and a tiny stage 1 -> 2 -> 3 run end to end), the grid search
(`training.hyperparameter_search`) against the JAX package's from the same
initial weights, with each package resuming the other's ``results.json``,
and the dry-run entry (`graft_entry`).

Sizes: the rehearsal's stage YAMLs cut to FaceEnhanceNet 1 x 2 x 16, D at 8
channels, batch 2, 32-pixel crops, 1 epoch a stage, on 16 synthetic faces
(13 train, 1 val, 2 test); the grid at 16 channels, 1 group of 2 RCABs,
2 steps of batch 2 on 8 HR crops of 32, in f32 (``use_amp=False``).
Tolerances: the grid's final loss, PSNR and SSIM within 1e-4 relative of
JAX's (two AdamW steps at lr 1e-4; measured differences are printed).
"""

import math
import os
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.cli import dress_rehearsal as dr
from facesr_torch.training import hyperparameter_search as hs

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CUTS = (("num_channels: 64", "num_channels: 16"), ("num_groups: 6", "num_groups: 1"),
        ("blocks_per_group: 10", "blocks_per_group: 2"), ("num_workers: 4", "num_workers: 1"),
        ("hr_patch_size: 128", "hr_patch_size: 32"), ("lr_patch_size: 32", "lr_patch_size: 8"))
GRID = {"learning_rate": [1e-4], "batch_size": [2], "perceptual_weight": [0.0, 0.01],
        "num_rcab_blocks": [2], "num_channels": [16], "epochs": [1]}
GRID_RTOL = 1e-4


# ---------------------------------------------------------------------------
# the rehearsal


def test_setup_only_writes_the_configs_as_the_jax_script_does(tmp_path, monkeypatch):
    from facesr_torch.config import load_config

    work = tmp_path / "other_rehearsal"
    jax_work = tmp_path / "jax_rehearsal"
    env = dict(os.environ, REHEARSAL_SETUP_ONLY="1")
    proc = subprocess.run(["bash", "scripts/dress_rehearsal.sh", str(jax_work)], cwd=ROOT,
                          capture_output=True, text=True, timeout=60, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    monkeypatch.setenv("REHEARSAL_SETUP_ONLY", "1")
    assert dr.main([str(work)]) == 0
    assert not (work / "raw").exists()
    for stage, prev in (("stage1_psnr", None), ("stage2_ssim", "ckpt_s1"),
                        ("stage3_gan", "ckpt_s2")):
        path = work / "configs" / f"{stage}.yaml"
        text = path.read_text()
        assert "/tmp/rehearsal" not in text
        assert text == (jax_work / "configs" / f"{stage}.yaml").read_text().replace(
            str(jax_work), str(work))
        cfg = load_config(str(path))  # the generated copy is schema-valid
        assert cfg["data"]["data_root"] == str(work / "processed")
        assert cfg["checkpoint"]["save_dir"].startswith(str(work))
        resume = cfg["checkpoint"].get("resume")
        assert resume == (None if prev is None else str(work / prev / "best_model.fckpt"))


def _cut_configs(dest: Path) -> Path:
    dest.mkdir(parents=True)
    for name in dr.STAGES:
        text = (ROOT / "configs" / "rehearsal" / f"{name}.yaml").read_text()
        for old, new in CUTS + ((("d_channels: 64", "d_channels: 8"),) if "gan" in name else ()):
            assert old in text, (name, old)
            text = text.replace(old, new)
        text = re.sub(r"batch_size: \d+", "batch_size: 2", text)
        text = re.sub(r"\bepochs: \d+", "epochs: 1", text)
        (dest / f"{name}.yaml").write_text(text)
    return dest


def test_a_tiny_rehearsal_runs_stage_1_2_3_on_the_cpu(tmp_path, capsys, monkeypatch):
    """As the JAX script, it prepares with ``--hdf5``: each stage's loaders
    read train.h5 and val.h5."""
    from facesr_torch.data import hdf5

    opened = []
    real = hdf5.H5File.__init__

    def record(self, path):
        opened.append(Path(path).name)
        real(self, path)

    monkeypatch.setattr(hdf5.H5File, "__init__", record)
    out = dr.rehearse(str(tmp_path / "work"), str(_cut_configs(tmp_path / "cfg")), num_faces=16,
                      device="cpu")
    log = capsys.readouterr().out
    work = (tmp_path / "work").resolve()
    assert len(list((work / "raw").glob("face_*.png"))) == 16
    assert {s: len(list((work / "processed" / s / "HR").iterdir()))
            for s in ("train", "val", "test")} == {"train": 13, "val": 1, "test": 2}
    with hdf5.H5File(work / "processed" / "train.h5") as f:
        assert len(f["HR"]) == 13 and f.attrs == {"hr_size": 128, "lr_size": 32,
                                                  "num_images": 13}
    assert opened.count("train.h5") == 3 + 1 and opened.count("val.h5") == 3
    for i, name in enumerate(dr.STAGES):
        assert out["checkpoints"][name] == work / f"ckpt_s{i + 1}" / "best_model.fckpt"
        assert out["checkpoints"][name].exists() and (work / "best_all" / f"{name}.fckpt").exists()
    for prev in ("ckpt_s1", "ckpt_s2"):  # each stage chained from the one before
        assert f"Chaining from stage checkpoint {work / prev / 'best_model.fckpt'}" in log
    assert "not drawn (it needs matplotlib, ROADMAP A.8.4)" in log
    summary = out["comparison"]["summary"]
    assert {"Stage1 Psnr", "Stage2 Ssim", "Stage3 Gan", "Bicubic"} <= set(summary)
    assert all(math.isfinite(v["psnr"]) for v in summary.values())
    assert (work / "comparison" / "results_summary.txt").exists()
    assert Path(out["panel"]).exists()


def test_the_rehearsal_raises_without_a_card_or_a_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dr.rehearse(str(tmp_path / "w"), num_faces=1)
    assert not (tmp_path / "w" / "raw").exists()


# ---------------------------------------------------------------------------
# the grid search


def _data():
    rng = np.random.default_rng(0)
    return (rng.random((8, 32, 32, 3), dtype=np.float32),
            rng.random((4, 32, 32, 3), dtype=np.float32))


@pytest.fixture(scope="module")
def jax_grid(tmp_path_factory):
    from facesr.training.hyperparameter_search import GridSearchTrainer

    path = tmp_path_factory.mktemp("jax_grid") / "results.json"
    train, val = _data()
    searcher = GridSearchTrainer(train, val, grid=GRID, results_path=str(path),
                                 steps_per_epoch=2, seed=3, use_amp=False)
    searcher.run()
    return searcher, path


def _from_jax_init(monkeypatch):
    """The port's experiments start from JAX's initial weights (and VGG)."""
    import jax

    from facesr.losses import combined as jcombined
    from facesr.models import face_enhance_net as fen
    from facesr_torch.ckpt.weights import state_dict_from_jax_params, vgg_params_from_jax

    build_model, build_loss = hs.build_model, hs.build_loss

    def model(cfg, scale, seed, dev):
        m = build_model(cfg, scale, seed, dev)
        jcfg = fen.FaceEnhanceNetConfig(num_channels=cfg.num_channels,
                                        num_groups=m.config.num_groups,
                                        blocks_per_group=m.config.blocks_per_group,
                                        scale_factor=scale)
        m.load_state_dict(state_dict_from_jax_params(
            jax.tree.map(np.asarray, fen.init(jax.random.PRNGKey(seed), jcfg))))
        return m

    def loss(cfg, dev):
        jloss = jcombined.create_loss_function(l1_weight=1.0,
                                               perceptual_weight=cfg.perceptual_weight,
                                               ssim_weight=0.0, perceptual_layers=["conv2_2"])
        if "vgg" not in jloss.params:
            return build_loss(cfg, dev)
        from facesr_torch.losses.combined import create_loss_function

        return create_loss_function(l1_weight=1.0, perceptual_weight=cfg.perceptual_weight,
                                    ssim_weight=0.0, perceptual_layers=["conv2_2"], device=dev,
                                    vgg_params=vgg_params_from_jax(jloss.params["vgg"]))

    monkeypatch.setattr(hs, "build_model", model)
    monkeypatch.setattr(hs, "build_loss", loss)


def test_grid_search_matches_jax_from_its_initial_weights(jax_grid, tmp_path, monkeypatch):
    _from_jax_init(monkeypatch)
    jsearcher, _ = jax_grid
    train, val = _data()
    searcher = hs.GridSearchTrainer(train, val, grid=GRID, results_path=str(tmp_path / "r.json"),
                                    steps_per_epoch=2, seed=3, use_amp=False, device="cpu")
    got = searcher.run()
    want = jsearcher.results
    assert set(got) == set(want) and len(got) == 2
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.status == w.status == "completed" and g.config == w.config
        for field in ("final_loss", "final_psnr", "final_ssim"):
            a, b = getattr(g, field), getattr(w, field)
            worst = max(worst, abs(a - b) / abs(b))
            assert abs(a - b) <= GRID_RTOL * abs(b), (k, field, a, b)
    print(f"grid: worst relative difference to JAX {worst:.3g}")
    want_rows = jsearcher.report().to_dict("records")
    rows = searcher.report()
    assert [r["experiment_id"] for r in rows] == [r["experiment_id"] for r in want_rows]
    assert set(rows[0]) == set(want_rows[0])
    impact, jimpact = searcher.impact_analysis(), jsearcher.impact_analysis()
    assert {p: list(v) for p, v in impact.items()} == {p: list(v) for p, v in jimpact.items()}
    for p in jimpact:
        for v in jimpact[p]:
            assert abs(impact[p][v] - jimpact[p][v]) <= GRID_RTOL * abs(jimpact[p][v])
    assert searcher.best().config == jsearcher.best().config


def test_grid_search_resumes_jaxs_results_and_jax_resumes_the_ports(jax_grid, tmp_path, capsys,
                                                                     monkeypatch):
    from facesr.training.hyperparameter_search import GridSearchTrainer as JaxGridSearchTrainer

    _, jpath = jax_grid
    train, val = _data()
    hs.GridSearchTrainer(train, val, grid=GRID, results_path=str(jpath), device="cpu").run()
    out = capsys.readouterr().out
    assert "Resumed grid search: 2 completed" in out and out.count("skipped (completed)") == 2
    # a port file with one completed and one failed record (its error kept)
    build_loss = hs.build_loss

    def loss(cfg, dev):
        if cfg.perceptual_weight:
            raise RuntimeError("planted failure")
        return build_loss(cfg, dev)

    monkeypatch.setattr(hs, "build_loss", loss)
    path = tmp_path / "port.json"
    port = hs.GridSearchTrainer(train, val, grid=GRID, results_path=str(path),
                                steps_per_epoch=1, device="cpu")
    records = port.run()
    assert {r.status: r.error for r in records.values()} == {"completed": "",
                                                            "failed": "planted failure"}
    assert [r["perceptual_weight"] for r in port.report()] == [0.0]
    jax_side = JaxGridSearchTrainer(train, val, grid=dict(GRID, perceptual_weight=[0.0]),
                                    results_path=str(path), steps_per_epoch=1)
    jax_side.run()
    out = capsys.readouterr().out
    assert "Resumed grid search: 1 completed" in out and "skipped (completed)" in out
    assert set(jax_side.results) == set(records)
    assert jax_side.results[port.best().config["experiment_id"]].final_psnr == \
        port.best().final_psnr


# ---------------------------------------------------------------------------
# the dry-run entry


def test_entry_runs_the_production_forward_on_the_cpu():
    from facesr_torch import graft_entry

    forward, (model, x) = graft_entry.entry(device="cpu")
    cfg = model.config
    assert (cfg.num_groups, cfg.blocks_per_group, cfg.num_channels) == (6, 10, 64)
    assert tuple(x.shape) == (1, 64, 64, 3) and not x.any()
    out = forward(model, x)
    assert tuple(out.shape) == (1, 256, 256, 3) and torch.isfinite(out).all()


def test_entry_raises_without_a_card_or_a_device(monkeypatch):
    from facesr_torch import graft_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()


def test_dryrun_multichip_runs_a_gan_step_over_two_gloo_ranks():
    from facesr_torch import graft_entry

    vals = graft_entry.dryrun_multichip(2, device="cpu")
    assert {"loss", "d_loss", "g_adv", "d_real", "d_fake"} <= set(vals)
    assert all(math.isfinite(v) for v in vals.values()) and vals["ema_finite"] == 1.0
