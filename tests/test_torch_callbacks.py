"""The monitors of the port (`training/callbacks.py`) and the Trainer's
per-parameter gradient norms on the CPU, against the JAX package's.

- The monitors on the same weights (JAX's tree converted by
  `ckpt.weights`): `GradientMonitor` on each package's gradients of one
  loss, `ActivationMonitor` on the SE attention, `WeightMonitor` across
  one perturbation, `MetricLogger` and `LRWarmup`.
- The Trainer with ``log_gradients_every=1``: two steps' norms against
  the JAX Trainer's, the port's per-parameter norms folded into JAX's
  stacked leaves (square root of the sum of squares, through the weight
  mapping).
- The same Trainer on `data,model` and `data,pp` [1, 2] grids of gloo
  ranks (one background launch, `parallel.launch.run_ranks`; the children
  import torch and the port only) against the single process, and the
  train CLI with ``logging.log_gradients_every`` on one process and on
  both grids (subprocess ranks).

Sizes: FaceEnhanceNet G=2, B=2, C=16, every weight perturbed off its
init, HR 32, batches of 8 (the grids' ranks load the same rows). Limits:
the monitors 1e-4 relative (the attention statistics 1e-5 absolute); the
Trainer's folded norms 1e-4 relative against JAX; the grids'
max(1e-4, 10 x the single process's rounding floor), the floor being how
far its own norms move when the input is multiplied by
(1 + 2^-23 N(0, 1)), the larger of two draws; the ranks bitwise against
each other.
"""

import json
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from facesr_torch.losses.combined import CombinedLoss, LossConfig
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.parallel import launch
from facesr_torch.training.callbacks import (ActivationMonitor, GradientMonitor, LRWarmup,
                                             MetricLogger, WeightMonitor)

torch.set_num_threads(1)

G, B, C, HR, BATCH = 2, 2, 16, 32, 8
LOSS = dict(l1_weight=1.0, perceptual_weight=0.0, ssim_weight=0.1)
GRIDS = {"tp": ("data,model", (1, 2)), "pp": ("data,pp", (1, 2))}
BASE = 1e-4
FLOOR_FACTOR = 10
FLOOR_NOISE = 2.0 ** -23
FLOOR_SEEDS = (11, 12)
ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# what the ranks and the parent both build (torch and numpy only)


def _model(seed=0):
    model = FaceEnhanceNet(FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B),
                           seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
            p.copy_(noise * 0.05 if name.startswith("conv_last") else p + noise * 0.02)
    return model


def _hr(seed, n=BATCH):
    """Smooth HR images in [0, 1]."""
    lo = np.random.default_rng(seed).random((n, HR // 4, HR // 4, 3), dtype=np.float32)
    return np.kron(lo, np.ones((1, 4, 4, 1), np.float32))


def _loaders(noise=None):
    def batch(seed):
        hr = _hr(seed)
        if noise is not None:
            eps = np.random.default_rng(noise * 100 + seed).standard_normal(hr.shape)
            hr = (hr * (1 + FLOOR_NOISE * eps)).astype(np.float32)
        return {"hr": hr}

    return [batch(20), batch(21)], [batch(30)]


def _trainer_cfg(tmp, **kw):
    cfg = dict(epochs=1, learning_rate=1e-4, weight_decay=1e-2, gradient_clip=0.5,
               use_amp=False, scheduler_type="step", scheduler_step_size=10, scheduler_gamma=1.0,
               save_every=10, save_best=False, checkpoint_dir=str(tmp), step_log_every=0,
               early_stopping_metric="val_loss", early_stopping_mode="min",
               log_gradients_every=1)
    cfg.update(kw)
    return cfg


def _port_trainer(tmp, mesh=None, noise=None, model=None, **kw):
    from facesr_torch.training.trainer import Trainer, TrainerConfig

    train, val = _loaders(noise)
    return Trainer(model if model is not None else _model(), train, val,
                   CombinedLoss(LossConfig(**LOSS), device="cpu"),
                   TrainerConfig(**_trainer_cfg(tmp, **kw)), device="cpu", mesh=mesh)


def _norms_worker(mesh, tmp, axes, shape):
    torch.set_num_threads(1)
    tr = _port_trainer(Path(tmp) / f"rank{mesh.rank}", mesh=mesh, mesh_axes=axes,
                       mesh_shape=shape)
    tr.train()
    return {"rank": mesh.rank, "norms": tr.gradient_monitor.history,
            "history_keys": sorted(tr.training_history)}


def _cli_files(tmp: Path, extra_yaml: str) -> Path:
    """4 train PNGs at 40, 2 val pairs at 32 and 8, and the stage-1 YAML
    cut to G=2, B=1, C=16, batch 2, HR 32 with ``extra_yaml`` under
    ``logging``."""
    from facesr_torch.data import png
    from facesr_torch.data.cv_compat import resize_cubic

    rng = np.random.default_rng(0)
    for split, n, size in (("train", 4, 40), ("val", 2, 32)):
        (tmp / "data" / split / "HR").mkdir(parents=True)
        if split == "val":
            (tmp / "data" / split / "LR").mkdir()
        for i in range(n):
            img = resize_cubic((rng.random((5, 5, 3)) * 255).astype(np.uint8), (size, size))
            png.write_png(tmp / "data" / split / "HR" / f"{i:03d}.png", img)
            if split == "val":
                png.write_png(tmp / "data" / split / "LR" / f"{i:03d}.png",
                              resize_cubic(img, (8, 8)))
    text = (ROOT / "configs" / "stages" / "stage1_psnr_config.yaml").read_text()
    for old, new in (("num_channels: 64", "num_channels: 16"), ("num_groups: 6", "num_groups: 2"),
                     ("blocks_per_group: 10", "blocks_per_group: 1"),
                     ("batch_size: 48", "batch_size: 2"), ("num_workers: 16", "num_workers: 1"),
                     ("hr_patch_size: 256", "hr_patch_size: 32"),
                     ("logging:\n", f"logging:\n{extra_yaml}")):
        assert old in text, old
        text = text.replace(old, new)
    (tmp / "s1.yaml").write_text(text)
    return tmp / "s1.yaml"


def _cli(tmp: Path, *mesh_args):
    """The train CLI on the cut YAML for one epoch (a grid: the plain
    launch starts its ranks)."""
    return subprocess.run(
        [sys.executable, "-m", "facesr_torch.cli.train", "--config", str(tmp / "s1.yaml"),
         "--data-root", str(tmp / "data"), "--device", "cpu", "--epochs", "1", "--yes",
         *mesh_args],
        cwd=str(tmp), capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp), "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT)})


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both grids' Trainer ranks, then the CLI on both grids, in a
    background thread that the parent's runs overlap."""
    tmp = tmp_path_factory.mktemp("norms")

    def run():
        out = {}
        for name, (axes, shape) in GRIDS.items():
            out[name] = launch.run_ranks(_norms_worker, 2, args=(str(tmp / name), axes, shape),
                                         devices=["cpu", "cpu"], timeout=120, run_timeout=300,
                                         axis_names=tuple(axes.split(",")), shape=shape)
        for name, (axes, shape) in GRIDS.items():
            d = tmp / f"cli_{name}"
            d.mkdir()
            _cli_files(d, "  log_gradients_every: 1\n")
            out[f"cli_{name}"] = _cli(d, "--mesh-axes", axes, "--mesh-shape",
                                      ",".join(map(str, shape)))
        return out

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run)


# ---------------------------------------------------------------------------
# folding the port's names into JAX's leaves


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _folded(norms, model):
    """Per-parameter norms as JAX's leaves' norms: each parameter's square
    spread evenly over a tensor of its shape, mapped by the weight
    functions, summed a leaf."""
    from facesr_torch.ckpt.weights import jax_params_from_state_dict

    sd = {n: torch.full(p.shape, norms[n] ** 2 / p.numel(), dtype=torch.float64)
          for n, p in model.named_parameters()}
    tree = jax_params_from_state_dict(sd, keep_dtype=True)
    return {k: math.sqrt(float(np.sum(v))) for k, v in _flat(tree).items()}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# the monitors on their own


def test_gradient_monitor_names_norms_and_vanishing_layers():
    gm = GradientMonitor()
    norms = gm.update({"a.w": torch.ones(2, 2), "b": torch.zeros(3)})
    assert abs(norms["a.w"] - 2.0) < 1e-6 and norms["b"] == 0.0
    assert gm.vanishing_layers() == ["b"]
    assert abs(gm.global_norm({"a.w": torch.ones(2, 2), "b": torch.zeros(3)}) - 2.0) < 1e-6
    s = gm.summary()
    assert s["a.w"]["last"] == s["a.w"]["mean"]


def test_weight_monitor_resets_when_the_parameters_change():
    wm = WeightMonitor()
    assert wm.update({"w": torch.ones(4)}) == {}
    assert abs(wm.update({"w": torch.ones(4) * 1.001})["w"] - 0.001) < 1e-5
    assert wm.update({"v": torch.ones(4)}) == {}  # other names: a restart
    assert wm.update({"v": torch.ones(5)}) == {}  # other shapes too
    assert set(wm.summary()) == {"w"}


def _jax_setup():
    import jax
    import jax.numpy as jnp

    from facesr.models import face_enhance_net as fen
    from facesr_torch.ckpt.weights import jax_params_from

    model = _model(seed=3)
    params = jax.tree.map(jnp.asarray, jax_params_from(model))
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    return model, params, cfg


def test_gradient_monitor_matches_jaxs_on_converted_weights():
    import jax
    import jax.numpy as jnp

    from facesr.models import face_enhance_net as fen
    from facesr.training.callbacks import GradientMonitor as JaxGradientMonitor

    model, params, cfg = _jax_setup()
    hr = _hr(5)
    lr = hr[:, ::4, ::4]
    jgrads = jax.grad(lambda p: jnp.mean(jnp.abs(fen.apply(p, jnp.asarray(lr), cfg, train=True)
                                                 - hr)))(params)
    jm = JaxGradientMonitor()
    want = jm.update(jgrads)
    loss = (model(torch.from_numpy(lr), train=True) - torch.from_numpy(hr)).abs().mean()
    loss.backward()
    tm = GradientMonitor()
    got = tm.update(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    folded = _folded(got, model)
    assert set(folded) == set(want)
    worst = max(_rel(folded[k], want[k]) for k in want)
    print(f"folded gradient norms: worst relative difference {worst:.3g}")
    assert worst <= 1e-4
    assert _rel(tm.global_norm(model), jm.global_norm(jgrads)) <= 1e-4
    assert tm.vanishing_layers() == [] == jm.vanishing_layers()


def test_activation_monitor_matches_jaxs_on_converted_weights():
    import jax.numpy as jnp

    from facesr.models import face_enhance_net as fen
    from facesr.training.callbacks import ActivationMonitor as JaxActivationMonitor

    model, params, cfg = _jax_setup()
    x = _hr(6, n=2)[:, ::4, ::4]
    jam = JaxActivationMonitor(fen.FaceEnhanceNet(cfg, params=params))
    want = jam.update(jnp.asarray(x))
    tam = ActivationMonitor(model)
    got = tam.update(torch.from_numpy(x))
    assert set(got) == set(want) and len(got) == G * B
    for name in want:
        for stat in ("mean", "std", "dead_fraction"):
            assert abs(got[name][stat] - want[name][stat]) <= 1e-5, (name, stat)
    for threshold in (1e-3, 0.5):
        assert tam.dead_channels(threshold) == jam.dead_channels(threshold)


def test_weight_monitor_matches_jaxs_on_converted_weights():
    import jax

    from facesr.training.callbacks import WeightMonitor as JaxWeightMonitor
    from facesr_torch.ckpt.weights import jax_params_from

    model = _model(seed=4)
    jwm, twm = JaxWeightMonitor(), WeightMonitor()
    jwm.update(jax.tree.map(np.array, jax_params_from(model)))  # copies, not views
    twm.update(model)
    old = {n: float(p.detach().norm()) for n, p in model.named_parameters()}
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.mul_(1 + 1e-3 * (1 + i % 3))
    want = jwm.update(jax.tree.map(np.asarray, jax_params_from(model)))
    got = twm.update(model)
    assert set(got) == set(old)
    # each leaf's ratio from the parts': |delta| folded over |old| folded
    delta = _folded({n: got[n] * old[n] for n in got}, model)
    base = _folded(old, model)
    assert set(delta) == set(want)
    worst = max(_rel(delta[k] / base[k], want[k]) for k in want)
    print(f"update ratios: worst relative difference {worst:.3g}")
    assert worst <= 1e-4
    assert _rel(twm.summary()["conv_first.weight"], jwm.summary()["conv_first.w"]) <= 1e-4


def test_metric_logger_and_lr_warmup_match_jax(tmp_path):
    from facesr.training.callbacks import LRWarmup as JaxLRWarmup
    from facesr.training.callbacks import MetricLogger as JaxMetricLogger

    for cls, d in ((JaxMetricLogger, "jax"), (MetricLogger, "port")):
        logger = cls(log_dir=str(tmp_path / d))
        logger.on_epoch_end(None, 0, {"loss": 1.0, "psnr": np.float32(20.5)})
        logger.on_epoch_end(None, 1, {"loss": torch.tensor(0.5), "psnr": 21})
    assert (json.loads((tmp_path / "port" / "metrics.json").read_text())
            == json.loads((tmp_path / "jax" / "metrics.json").read_text()))
    for kw in ({}, {"warmup_steps": 10}, {"warmup_steps": 0}, {"start_lr": 0.0}):
        jw, tw = JaxLRWarmup(1e-3, **kw), LRWarmup(1e-3, **kw)
        assert [tw(s) for s in range(0, 600, 7)] == [jw(s) for s in range(0, 600, 7)]
    assert LRWarmup(1e-3).start_lr == 1e-7 and LRWarmup(1e-3)(0) == 1e-7


# ---------------------------------------------------------------------------
# the Trainer's norms


def test_trainer_norms_match_the_jax_trainers_folded_into_its_leaves(tmp_path):
    import jax
    import jax.numpy as jnp

    from facesr.losses import combined as jcombined
    from facesr.models import face_enhance_net as fen
    from facesr.training.trainer import Trainer as JaxTrainer
    from facesr.training.trainer import TrainerConfig as JaxTrainerConfig
    from facesr_torch.ckpt.weights import jax_params_from

    model = _model()
    cfg = fen.FaceEnhanceNetConfig(num_channels=C, num_groups=G, blocks_per_group=B)
    train, val = _loaders()
    jtr = JaxTrainer(fen.FaceEnhanceNet(cfg, params=jax.tree.map(jnp.asarray,
                                                                 jax_params_from(model))),
                     train, val, jcombined.CombinedLoss(jcombined.LossConfig(**LOSS)),
                     JaxTrainerConfig(**_trainer_cfg(tmp_path / "jax"), use_wandb=False,
                                      log_dir=str(tmp_path / "logs")))
    jtr.train()
    want = jtr.gradient_monitor.history
    tr = _port_trainer(tmp_path / "port")
    tr.train()
    got = tr.gradient_monitor.history
    assert set(got) == {n for n, _ in model.named_parameters()}
    assert all(len(v) == 2 for v in got.values()) and all(len(v) == 2 for v in want.values())
    assert "grad_norms" not in tr.last_train_metrics
    worst = 0.0
    for step in range(2):
        folded = _folded({k: v[step] for k, v in got.items()}, tr.model)
        assert set(folded) == set(want)
        worst = max(worst, max(_rel(folded[k], want[k][step]) for k in want))
    print(f"Trainer norms, 2 steps: worst relative difference to JAX {worst:.3g}")
    assert worst <= 1e-4


def test_no_norms_without_log_gradients_every(tmp_path):
    tr = _port_trainer(tmp_path, log_gradients_every=0)
    assert tr.gradient_monitor is None
    state, metrics = tr._train_step(tr.state, torch.from_numpy(_hr(3)))
    assert "grad_norms" not in metrics


@pytest.fixture(scope="module")
def single(launched, tmp_path_factory):
    """The single-process Trainer's norms and each norm's limit."""
    tmp = tmp_path_factory.mktemp("norms_single")
    tr = _port_trainer(tmp / "clean")
    tr.train()
    want = tr.gradient_monitor.history
    draws = []
    for s in FLOOR_SEEDS:
        noisy = _port_trainer(tmp / f"noise{s}", noise=s)
        noisy.train()
        draws.append(noisy.gradient_monitor.history)
    limits = {k: [max(BASE, FLOOR_FACTOR * max(_rel(d[k][i], want[k][i]) for d in draws))
                  for i in range(len(want[k]))] for k in want}
    return want, limits


@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_norms_are_whole_leaf_norms_of_one_process(launched, single, grid):
    """Under tp a rank holds a slice of each split leaf and under pp only
    its stage's groups; the norms it logs are the whole leaves'."""
    ranks = launched.result()[grid]
    want, limits = single
    assert ranks[0]["norms"] == ranks[1]["norms"]  # bitwise across the ranks
    got = ranks[0]["norms"]
    assert set(got) == set(want)
    ratios = {f"{k}[{i}]": _rel(got[k][i], want[k][i]) / limits[k][i]
              for k in want for i in range(len(want[k]))}
    top = sorted(ratios.items(), key=lambda kv: -kv[1])[:3]
    print(f"{grid}: largest error / limit {top}")
    assert max(ratios.values()) <= 1.0


def test_train_cli_logs_gradient_norms_on_one_process(tmp_path, monkeypatch, capsys):
    from facesr_torch.cli import train

    _cli_files(tmp_path, "  log_gradients_every: 1\n")
    monkeypatch.chdir(tmp_path)
    trainer = train.run(["--config", "s1.yaml", "--data-root", "data", "--device", "cpu",
                         "--epochs", "1", "--yes"])
    hist = trainer.gradient_monitor.history
    assert hist and all(len(v) == 2 and all(math.isfinite(x) for x in v) for v in hist.values())
    assert "Gradient norms:" in capsys.readouterr().out


@pytest.mark.parametrize("grid", list(GRIDS))
def test_train_cli_logs_gradient_norms_on_a_grid(launched, grid):
    proc = launched.result()[f"cli_{grid}"]
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Gradient norms:" in proc.stdout
