"""Grid search with JSON persistence and resume (the port of
`facesr/training/hyperparameter_search.py`).

`ExperimentConfig` (one grid point; `make_id` names it by every field),
`ExperimentResult` (its record), `DEFAULT_GRID` (learning rate x batch
size x perceptual weight x RCAB blocks) and `GridSearchTrainer`: each
experiment is saved to ``results_path`` as it ends, a failed one is
recorded with its error and the search goes on, and a completed one is
skipped on the next run. The JSON file is the JAX package's: either
package resumes the other's.

An experiment is a short single-device loop, as in JAX: ``epochs`` x
``steps_per_epoch`` steps of a batch drawn with replacement from the
training HR crops (``np.random.default_rng(seed)``), the LR made on the
device by bicubic downsampling, FaceEnhanceNet at ``num_rcab_blocks //
2`` groups of 2 RCABs, L1 + VGG19 ``conv2_2``, AdamW at optax's defaults
(weight decay 1e-4, no clipping), bf16 compute under ``use_amp``; then one
f32 evaluation of the validation crops: PSNR of the mean squared error and
the real SSIM. The model and the loss come from `build_model` and
`build_loss`, so a caller (the parity test) can start from other weights.

``run(devices=...)``: None runs the experiments one after another on the
searcher's device (CUDA unless ``device="cpu"``); "auto" takes every
visible card (the CPU when the searcher's device is the CPU), and a list
of devices runs one experiment a device at a time, in threads. On a
one-card machine "auto" is one H100, so the experiments run in turn.

`report` returns the completed runs as a list of dicts (the JAX
package's DataFrame rows, highest PSNR first: the card's machine has no
pandas); `impact_analysis` the mean PSNR for each value of each grid
parameter; `best` the completed record with the highest PSNR.
"""

from __future__ import annotations

import itertools
import json
import queue
import threading
import time
from dataclasses import asdict, dataclass, field, fields
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.losses.combined import CombinedLoss, create_loss_function
from facesr_torch.losses.ssim import ssim
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
from facesr_torch.ops.conv import full_f32
from facesr_torch.ops.resize import bicubic_down
from facesr_torch.training.optim import AdamW
from facesr_torch.training.steps import TrainState, make_train_step, trainable_parameters

__all__ = ["ExperimentConfig", "ExperimentResult", "DEFAULT_GRID", "GridSearchTrainer",
           "quick_search", "build_model", "build_loss"]


@dataclass
class ExperimentConfig:
    """One grid point."""

    learning_rate: float = 1e-4
    batch_size: int = 16
    perceptual_weight: float = 0.01
    num_rcab_blocks: int = 8  # total blocks; mapped to groups x blocks
    num_channels: int = 64
    epochs: int = 3
    experiment_id: str = ""

    def make_id(self) -> str:
        # every searchable field takes part, or grid points would collapse
        # into one "completed" entry and the rest of an axis be skipped
        return (f"lr{self.learning_rate}_bs{self.batch_size}"
                f"_pw{self.perceptual_weight}_blocks{self.num_rcab_blocks}"
                f"_ch{self.num_channels}_ep{self.epochs}")


@dataclass
class ExperimentResult:
    """An experiment's outcome."""

    config: Dict[str, Any] = field(default_factory=dict)
    status: str = "pending"  # pending / completed / failed
    final_psnr: float = 0.0
    final_ssim: float = 0.0
    final_loss: float = float("inf")
    wall_time_s: float = 0.0
    error: str = ""
    device: str = ""  # the device that ran the experiment ("cuda:0", "cpu:0")


DEFAULT_GRID = {
    "learning_rate": [1e-3, 1e-4, 1e-5],
    "batch_size": [8, 16, 32],
    "perceptual_weight": [0.0, 0.01, 0.1],
    "num_rcab_blocks": [4, 8, 12],
}

BLOCKS_PER_GROUP = 2


def build_model(cfg: ExperimentConfig, scale_factor: int, seed: int,
                device: torch.device) -> FaceEnhanceNet:
    """The experiment's FaceEnhanceNet: ``num_rcab_blocks // 2`` groups
    (at least 1) of 2 RCABs, weights from ``seed``."""
    model_cfg = FaceEnhanceNetConfig(num_channels=cfg.num_channels,
                                     num_groups=max(cfg.num_rcab_blocks // BLOCKS_PER_GROUP, 1),
                                     blocks_per_group=BLOCKS_PER_GROUP,
                                     scale_factor=scale_factor)
    return FaceEnhanceNet(model_cfg, seed=seed, device=device)


def build_loss(cfg: ExperimentConfig, device: torch.device) -> CombinedLoss:
    """L1 + ``perceptual_weight`` x VGG19 ``conv2_2``."""
    return create_loss_function(l1_weight=1.0, perceptual_weight=cfg.perceptual_weight,
                                ssim_weight=0.0, perceptual_layers=["conv2_2"],
                                device=device)


def _device_name(dev: torch.device) -> str:
    return f"{dev.type}:{dev.index or 0}"


class GridSearchTrainer:
    """Runs the grid, saving the results after each experiment.

    ``train_data`` / ``val_data``: [N, H, W, 3] float32 HR crops in [0, 1]
    (small search sets). ``device``: where ``run(devices=None)`` runs (CUDA
    unless the caller names one)."""

    def __init__(self, train_data: np.ndarray, val_data: np.ndarray,
                 grid: Optional[Dict[str, list]] = None,
                 results_path: str = "outputs/grid_search/results.json",
                 scale_factor: int = 4, steps_per_epoch: int = 20, seed: int = 0,
                 use_amp: bool = True, device: DeviceLike = None):
        self.train_data = np.asarray(train_data, np.float32)
        self.val_data = np.asarray(val_data, np.float32)
        self.grid = grid or DEFAULT_GRID
        self.results_path = Path(results_path)
        self.scale_factor = scale_factor
        self.steps_per_epoch = steps_per_epoch
        self.use_amp = use_amp  # bf16 compute in training; the evaluation is f32
        self.seed = seed
        self.device = resolve_device(device)
        self.results: Dict[str, ExperimentResult] = {}
        self._load_results()

    # -- persistence ----------------------------------------------------
    def _load_results(self) -> None:
        if not self.results_path.exists():
            return
        known = {f.name for f in fields(ExperimentResult)}
        for k, v in json.loads(self.results_path.read_text()).items():
            try:
                # another version's file: unknown fields are ignored, a record
                # missing required ones is re-run
                self.results[k] = ExperimentResult(**{a: b for a, b in v.items() if a in known})
            except TypeError as e:
                print(f"Warning: skipping unreadable result record {k!r} ({e}); "
                      "it will be re-run")
        done = sum(1 for r in self.results.values() if r.status == "completed")
        print(f"Resumed grid search: {done} completed experiments found")

    def _save_results(self) -> None:
        self.results_path.parent.mkdir(parents=True, exist_ok=True)
        self.results_path.write_text(
            json.dumps({k: asdict(v) for k, v in self.results.items()}, indent=2))

    # -- grid -------------------------------------------------------------
    def experiment_configs(self) -> List[ExperimentConfig]:
        keys = list(self.grid)
        configs = []
        for combo in itertools.product(*(self.grid[k] for k in keys)):
            cfg = ExperimentConfig(**dict(zip(keys, combo)))
            cfg.experiment_id = cfg.make_id()
            configs.append(cfg)
        return configs

    # -- one experiment -----------------------------------------------------
    def _run_experiment(self, cfg: ExperimentConfig,
                        device: Optional[torch.device] = None) -> ExperimentResult:
        dev = torch.device(device) if device is not None else self.device
        model = build_model(cfg, self.scale_factor, self.seed, dev)
        loss_fn = build_loss(cfg, dev)
        compute_dtype = torch.bfloat16 if self.use_amp else None
        optimizer = AdamW(weight_decay=1e-4, gradient_clip=0.0)  # optax.adamw's defaults
        state = TrainState(model=model,
                           opt_state=optimizer.init(trainable_parameters(model),
                                                    cfg.learning_rate),
                           loss_params=loss_fn.params)
        step = make_train_step(
            lambda lp, p, t: loss_fn.apply(lp, p, t, compute_dtype=compute_dtype), optimizer,
            scale_factor=self.scale_factor, compute_dtype=compute_dtype)

        rng = np.random.default_rng(self.seed)
        n = len(self.train_data)
        train = torch.from_numpy(self.train_data).to(dev)
        t0 = time.time()
        loss = torch.zeros((), device=dev)
        for _ in range(cfg.epochs):
            for _ in range(self.steps_per_epoch):
                idx = rng.integers(0, n, size=min(cfg.batch_size, n))
                state, metrics = step(state, train[torch.from_numpy(idx).to(dev)])
                loss = metrics["loss"]
        with torch.no_grad(), full_f32():
            hr = torch.from_numpy(self.val_data).to(dev)
            sr = model(bicubic_down(hr, self.scale_factor), train=False)
            mse = torch.mean((sr - hr) ** 2)
            psnr = 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12))
            values = torch.stack([psnr, ssim(sr, hr), loss.float()]).tolist()
        return ExperimentResult(config=asdict(cfg), status="completed", final_psnr=values[0],
                                final_ssim=values[1], final_loss=values[2],
                                wall_time_s=time.time() - t0, device=_device_name(dev))

    # -- running the grid ---------------------------------------------------
    def _devices(self, devices) -> List[torch.device]:
        if devices is None:
            return [self.device]
        if devices == "auto":
            if self.device.type != "cuda":
                return [self.device]
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [torch.device(d) for d in devices]

    def run(self, max_experiments: Optional[int] = None,
            devices: Union[None, str, Sequence[DeviceLike]] = None
            ) -> Dict[str, ExperimentResult]:
        """Run the grid, saving after each experiment. ``devices``: None
        (one after another on the searcher's device), "auto" (every card)
        or a list: one experiment a device at a time, in threads."""
        configs = self.experiment_configs()
        if max_experiments:
            configs = configs[:max_experiments]
        devs = self._devices(devices)
        n_workers = min(len(devs), len(configs)) or 1
        print(f"Grid search: {len(configs)} experiments"
              + (f" on {n_workers} devices" if n_workers > 1 else ""))
        lock = threading.Lock()
        work: "queue.Queue" = queue.Queue()
        for item in enumerate(configs):
            work.put(item)

        def worker(dev: torch.device) -> None:
            while True:
                try:
                    i, cfg = work.get_nowait()
                except queue.Empty:
                    return
                with lock:
                    prev = self.results.get(cfg.experiment_id, ExperimentResult())
                if prev.status == "completed":
                    print(f"[{i + 1}/{len(configs)}] {cfg.experiment_id}: skipped (completed)")
                    continue
                print(f"[{i + 1}/{len(configs)}] {cfg.experiment_id}: running on "
                      f"{_device_name(dev)}...")
                try:
                    result = self._run_experiment(cfg, device=dev)
                    print(f"    PSNR {result.final_psnr:.2f} dB, SSIM {result.final_ssim:.4f}, "
                          f"{result.wall_time_s:.1f}s")
                except Exception as e:  # record the failure and go on
                    result = ExperimentResult(config=asdict(cfg), status="failed", error=str(e),
                                              device=_device_name(dev))
                    print(f"    FAILED: {e}")
                with lock:
                    self.results[cfg.experiment_id] = result
                    self._save_results()

        if n_workers == 1:
            worker(devs[0])
        else:
            threads = [threading.Thread(target=worker, args=(d,), daemon=True)
                       for d in devs[:n_workers]]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        return self.results

    # -- analysis ------------------------------------------------------------
    def report(self) -> List[Dict[str, Any]]:
        """The completed runs, one dict each (the config's fields, psnr,
        ssim, loss, wall_time_s), highest PSNR first."""
        rows = [{**r.config, "psnr": r.final_psnr, "ssim": r.final_ssim,
                 "loss": r.final_loss, "wall_time_s": r.wall_time_s}
                for r in self.results.values() if r.status == "completed"]
        return sorted(rows, key=lambda r: r["psnr"], reverse=True)

    def impact_analysis(self) -> Dict[str, Dict[str, float]]:
        """Mean PSNR for each value of each grid parameter (values as
        strings, in ascending order)."""
        rows = self.report()
        out: Dict[str, Dict[str, float]] = {}
        for param in self.grid:
            groups: Dict[Any, List[float]] = {}
            for r in rows:
                if param in r:
                    groups.setdefault(r[param], []).append(r["psnr"])
            if groups:
                out[param] = {str(k): float(np.mean(v)) for k, v in sorted(groups.items())}
        return out

    def best(self) -> Optional[ExperimentResult]:
        done = [r for r in self.results.values() if r.status == "completed"]
        return max(done, key=lambda r: r.final_psnr) if done else None


QUICK_GRID = {
    "learning_rate": [1e-3, 1e-4],
    "batch_size": [8],
    "perceptual_weight": [0.0, 0.01],
    "num_rcab_blocks": [4],
}


def quick_search(train_data, val_data, results_path: str = "outputs/grid_search/quick.json",
                 devices: Union[None, str, Sequence[DeviceLike]] = "auto",
                 **kwargs) -> GridSearchTrainer:
    """The reduced 2 x 1 x 2 x 1 grid, on every card by default."""
    searcher = GridSearchTrainer(train_data, val_data, grid=QUICK_GRID,
                                 results_path=results_path, **kwargs)
    searcher.run(devices=devices)
    return searcher
