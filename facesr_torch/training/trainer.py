"""Single-card Trainer of the content path (port of
`facesr/training/trainer.py`: TrainerConfig, EarlyStopping, Trainer).

Loaders are iterables of ``{'hr': NHWC float32 [0, 1]}`` batches (numpy
or torch), the JAX Trainer's contract. Per epoch: the schedule's LR is
written into the optimiser state, every batch runs one train step, the
epoch's metrics come to the host in one read, validation runs the eval
step, and checkpoints follow ``save_every`` / ``save_best``.

Checkpoints are ``torch.save`` files with the JAX Trainer's payload:
``model_state_dict`` under the reference key names and ``config`` (the
model config in the reference field set), so `facesr_torch.ckpt.
load_reference_pth` and the JAX package's `facesr/ckpt/convert.py` read
them; plus ``model_config``, ``trainer_config``, ``optimizer_state``,
``ema_state_dict``, ``step``, ``epoch``, ``global_step``, ``best_metric``,
``training_history``, ``scheduler_state``, ``model_type`` and
``use_gan``. With ``async_checkpoint`` one writer thread writes them; the
tensors are copied to the host before the step loop goes on.

Not in this slice: mesh axes, GAN, QAT, W&B, the validation image grid and
the gradient monitor.
"""

from __future__ import annotations

import copy
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.training import schedules
from facesr_torch.training.optim import AdamW, set_learning_rate
from facesr_torch.training.steps import (TrainState, init_ema, make_eval_step,
                                         make_train_step)

__all__ = ["TrainerConfig", "EarlyStopping", "Trainer", "REFERENCE_CONFIG_FIELDS"]

# the reference FaceEnhanceNetConfig's fields: the checkpoint's ``config``
# holds only these, so the reference constructor accepts it verbatim
REFERENCE_CONFIG_FIELDS = (
    "num_channels", "num_groups", "blocks_per_group", "kernel_size",
    "reduction_ratio", "scale_factor", "res_scale", "in_channels",
    "out_channels", "init_scale", "num_rcab_blocks",
)
HISTORY_KEYS = ("train_loss", "val_loss", "val_psnr", "val_ssim", "learning_rate")


@dataclass
class TrainerConfig:
    """The JAX TrainerConfig's fields of the single-card content path."""

    epochs: int = 50
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    gradient_clip: float = 1.0
    accumulation_steps: int = 1
    # bf16 compute for the trunk and the VGG sweep (the reference's AMP);
    # the stage-1 YAML sets mixed_precision: false
    use_amp: bool = True

    scheduler_type: str = "cosine"  # 'cosine', 'step', 'plateau'
    scheduler_T_max: int = 50
    scheduler_eta_min: float = 1e-7
    scheduler_step_size: int = 10
    scheduler_gamma: float = 0.5

    early_stopping_patience: int = 10
    early_stopping_metric: str = "val_psnr"
    early_stopping_mode: str = "max"

    checkpoint_dir: str = "checkpoints"
    save_every: int = 10
    save_best: bool = True
    # write checkpoints on one background thread; flushed at train() end
    # and before any load
    async_checkpoint: bool = True

    scale_factor: int = 4
    # recompute the perceptual VGG sweep in the backward pass
    vgg_remat: bool = False
    # EMA of the generator weights, 0 = off; validation and best-checkpoint
    # selection then run on the EMA weights
    ema_decay: float = 0.0
    # consecutive non-finite steps the optimiser skips (0 = off)
    skip_nonfinite_updates: int = 0


class EarlyStopping:
    """Stop after ``patience`` epochs without an improvement."""

    def __init__(self, patience: int = 10, mode: str = "max", min_delta: float = 0.0):
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.counter = 0
        self.best_score: Optional[float] = None
        self.should_stop = False

    def __call__(self, score: float) -> bool:
        if self.best_score is None:
            self.best_score = score
            return False
        if self.mode == "max":
            improved = score > self.best_score + self.min_delta
        else:
            improved = score < self.best_score - self.min_delta
        if improved:
            self.best_score = score
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop


def _to_host(tree: Any) -> Any:
    """A copy of every tensor in ``tree`` on the CPU (a copy even of CPU
    tensors: training goes on updating them in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _to_device(tree: Any, like: Any, device: torch.device, where: str) -> Any:
    """``tree`` (from a checkpoint) on ``device``, checked against the
    structure of ``like`` (this trainer's state)."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint {where} does not match this trainer's "
                             f"(keys {sorted(tree) if isinstance(tree, dict) else tree} "
                             f"vs {sorted(like)}); was it written with other "
                             "accumulation/skip_nonfinite settings?")
        return {k: _to_device(tree[k], like[k], device, f"{where}.{k}") for k in like}
    if tuple(tree.shape) != tuple(like.shape) or tree.dtype != like.dtype:
        raise ValueError(f"checkpoint {where}: {tree.dtype} {tuple(tree.shape)} vs "
                         f"{like.dtype} {tuple(like.shape)}")
    return tree.to(device)


def _write(path: str, payload: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class Trainer:
    """Single-card training manager.

    Args:
        model: a `FaceEnhanceNet` (moved to ``device``).
        train_loader / val_loader: iterables of {'hr': NHWC float32 [0, 1]}.
        loss_fn: a `CombinedLoss` (moved to ``device``).
        device: CUDA unless the caller names one.
    """

    def __init__(self, model, train_loader, val_loader, loss_fn,
                 config: Optional[TrainerConfig] = None, device: DeviceLike = None):
        self.config = cfg = config or TrainerConfig()
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.model_cfg = model.config
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.loss_fn = loss_fn.to(self.device)

        self.compute_dtype = torch.bfloat16 if cfg.use_amp else None
        cd, vr = self.compute_dtype, cfg.vgg_remat
        loss_apply = lambda lp, p, t: loss_fn.apply(lp, p, t, compute_dtype=cd, vgg_remat=vr)
        # validation stays f32 end to end; no backward runs, so no remat
        loss_apply_eval = lambda lp, p, t: loss_fn.apply(lp, p, t, compute_dtype=None,
                                                         vgg_remat=False)
        self.optimizer = AdamW(weight_decay=cfg.weight_decay,
                               gradient_clip=cfg.gradient_clip,
                               accumulation_steps=cfg.accumulation_steps,
                               skip_nonfinite=cfg.skip_nonfinite_updates)
        self.use_ema = cfg.ema_decay > 0
        self.state = TrainState(
            model=self.model,
            opt_state=self.optimizer.init(dict(self.model.named_parameters()),
                                          cfg.learning_rate),
            loss_params=self.loss_fn.params,
            ema_params=init_ema(self.model) if self.use_ema else None)
        self._train_step = make_train_step(loss_apply, self.optimizer,
                                           scale_factor=cfg.scale_factor,
                                           compute_dtype=self.compute_dtype,
                                           ema_decay=cfg.ema_decay)
        self._eval_step = make_eval_step(loss_apply_eval, scale_factor=cfg.scale_factor,
                                         use_ema=self.use_ema)

        self.plateau = (schedules.ReduceLROnPlateau(cfg.learning_rate)
                        if cfg.scheduler_type == "plateau" else None)
        self.early_stopping = EarlyStopping(patience=cfg.early_stopping_patience,
                                            mode=cfg.early_stopping_mode)
        self.checkpoint_dir = Path(cfg.checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self._last_val_batches = 1
        self.best_metric: Optional[float] = None
        self.current_epoch = 0
        self.global_step = 0
        self.current_lr: Optional[float] = cfg.learning_rate
        self.training_history: Dict[str, List] = {k: [] for k in HISTORY_KEYS}
        self._ckpt_pool: Optional[ThreadPoolExecutor] = None
        self._ckpt_futures: List[Future] = []

    # ------------------------------------------------------------------
    def _epoch_lr(self, epoch: int) -> float:
        cfg = self.config
        return schedules.compute_lr(cfg.scheduler_type, cfg.learning_rate, epoch,
                                    T_max=cfg.scheduler_T_max, eta_min=cfg.scheduler_eta_min,
                                    step_size=cfg.scheduler_step_size,
                                    gamma=cfg.scheduler_gamma, plateau=self.plateau)

    def _set_lr(self, lr: float) -> None:
        # current_lr None = unknown (right after a full resume): always write
        if self.current_lr is None or abs(lr - self.current_lr) > 1e-12:
            set_learning_rate(self.state.opt_state, lr)
        self.current_lr = lr

    def _batch_to_device(self, hr) -> torch.Tensor:
        """One loader batch on the card: pinned, then an asynchronous copy,
        so the step loop does not wait for the card here."""
        t = torch.as_tensor(hr)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @staticmethod
    def _host_values(pending: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
        """The metric tensors of many steps, fetched in one host read."""
        if not pending:
            return []
        keys = list(pending[0])
        table = torch.stack([torch.stack([m[k].float() for k in keys])
                             for m in pending]).tolist()
        return [dict(zip(keys, row)) for row in table]

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        """The full loop: per epoch LR, train, validate, log, checkpoint,
        early stopping; then the final checkpoint."""
        print(f"Starting training on {self.device}")
        print(f"Epochs: {self.config.epochs}")
        if self.current_epoch >= self.config.epochs:
            print(f"Warning: resumed at epoch {self.current_epoch} >= configured "
                  f"epochs {self.config.epochs}; nothing to train. Use a "
                  "weights-only load to start a new stage.")

        for epoch in range(self.current_epoch, self.config.epochs):
            self.current_epoch = epoch
            self._set_lr(self._epoch_lr(epoch))

            train_metrics = self._train_epoch()
            val_metrics = self._validate_epoch()

            if self.plateau is not None and self._last_val_batches > 0:
                self.plateau.step(val_metrics["psnr"])

            self._log_epoch_metrics(epoch, train_metrics, val_metrics, self.current_lr)

            if self.config.save_every and (epoch + 1) % self.config.save_every == 0:
                self.save_checkpoint(f"epoch_{epoch + 1}.pth")

            metric_key = self.config.early_stopping_metric.replace("val_", "")
            metric_value = val_metrics.get(metric_key, val_metrics.get("psnr", 0.0))
            if self._last_val_batches > 0:  # zero-batch validation = no metric
                if self.config.save_best and self._is_best(metric_value):
                    self.save_checkpoint("best_model.pth", is_best=True)
                if self.early_stopping(metric_value):
                    print(f"\nEarly stopping triggered at epoch {epoch + 1}")
                    break

        self.save_checkpoint("final_model.pth")
        self.flush_checkpoints()
        return self.training_history

    def _train_epoch(self) -> Dict[str, float]:
        pending: List[Dict[str, torch.Tensor]] = []
        t0 = time.time()
        for batch in self.train_loader:
            hr = self._batch_to_device(batch["hr"])
            self.state, metrics = self._train_step(self.state, hr)
            pending.append(metrics)
            self.global_step += 1
        if not pending:
            print("WARNING: train loader yielded 0 batches this epoch — is "
                  "batch_size larger than the training split? No optimization "
                  "happened.")
        rows = self._host_values(pending)  # the epoch's one host read
        out = {k: sum(r[k] for r in rows) / len(rows) for k in (rows[0] if rows else ())}
        # a running count: the epoch's value is the last step's
        if rows and "opt_notfinite" in rows[-1]:
            out["opt_notfinite"] = rows[-1]["opt_notfinite"]
        out["time_s"] = time.time() - t0
        out.setdefault("loss", 0.0)
        return out

    def _validate_epoch(self) -> Dict[str, float]:
        pending = []
        for batch in self.val_loader:
            metrics, _, _ = self._eval_step(self.state, self._batch_to_device(batch["hr"]))
            pending.append(metrics)
        rows = self._host_values(pending)  # one host read
        self._last_val_batches = len(rows)
        if not rows:
            print("WARNING: val loader yielded 0 batches — all validation "
                  "metrics are 0.0 and best-model selection / early stopping "
                  "are skipped this epoch.")
        return {k: sum(r[k] for r in rows) / max(len(rows), 1)
                for k in ("loss", "psnr", "ssim")}

    def _log_epoch_metrics(self, epoch, train_metrics, val_metrics, lr):
        h = self.training_history
        h["train_loss"].append(train_metrics["loss"])
        h["val_loss"].append(val_metrics["loss"])
        h["val_psnr"].append(val_metrics["psnr"])
        h["val_ssim"].append(val_metrics["ssim"])
        h["learning_rate"].append(lr)
        print(f"\nEpoch {epoch + 1}/{self.config.epochs}")
        print(f"  Train Loss: {train_metrics['loss']:.4f}")
        print(f"  Val Loss:   {val_metrics['loss']:.4f}")
        print(f"  Val PSNR:   {val_metrics['psnr']:.2f} dB")
        print(f"  Val SSIM:   {val_metrics['ssim']:.4f}")
        print(f"  LR:         {lr:.2e}  ({train_metrics.get('time_s', 0):.1f}s)")

    def _is_best(self, metric_value: float) -> bool:
        if self.best_metric is None:
            self.best_metric = metric_value
            return True
        better = (metric_value > self.best_metric
                  if self.config.early_stopping_mode == "max"
                  else metric_value < self.best_metric)
        if better:
            self.best_metric = metric_value
        return better

    # ------------------------------------------------------------------
    def _checkpoint_payload(self) -> Dict[str, Any]:
        """What a checkpoint file holds, every tensor copied to the host."""
        model_config = asdict(self.model_cfg)
        return {
            "model_state_dict": _to_host(self.model.state_dict()),
            "config": {k: v for k, v in model_config.items()
                       if k in REFERENCE_CONFIG_FIELDS},
            "model_config": model_config,
            "trainer_config": asdict(self.config),
            "optimizer_state": _to_host(self.state.opt_state),
            "ema_state_dict": _to_host(self.state.ema_params),
            "step": self.state.step,
            "epoch": self.current_epoch,
            "global_step": self.global_step,
            "best_metric": self.best_metric,
            "training_history": copy.deepcopy(self.training_history),
            "scheduler_state": self.plateau.state_dict() if self.plateau else None,
            "model_type": "custom",
            "use_gan": False,
        }

    def save_checkpoint(self, filename: str, is_best: bool = False) -> None:
        """Write ``checkpoint_dir/filename``: on the writer thread with
        ``async_checkpoint`` (the payload is on the host before this
        returns), else here."""
        payload = self._checkpoint_payload()
        path = str(self.checkpoint_dir / filename)
        if self.config.async_checkpoint:
            if self._ckpt_pool is None:
                self._ckpt_pool = ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix="ckpt-writer")
            # submit first, reap after: an earlier failure must not stop
            # this write
            self._ckpt_futures.append(self._ckpt_pool.submit(_write, path, payload))
            self._reap_ckpt_errors(wait=False)
        else:
            _write(path, payload)
        if is_best:
            print(f"  New best model saved: {self.best_metric:.4f}")

    def _reap_ckpt_errors(self, wait: bool) -> None:
        # prune first, raise after: a failed write is reported once, by the
        # raise that consumes it, and never blocks later writes
        pending, errors = [], []
        for fut in self._ckpt_futures:
            if fut.done() or wait:
                exc = fut.exception()  # blocks if wait and not done
                if exc is not None:
                    errors.append(exc)
            else:
                pending.append(fut)
        self._ckpt_futures = pending
        if errors:
            raise RuntimeError(f"async checkpoint write(s) failed: {errors}")

    def flush_checkpoints(self) -> None:
        """Block until every queued checkpoint is on disk (raises if any
        write failed, after awaiting all) and retire the writer thread."""
        try:
            self._reap_ckpt_errors(wait=True)
        finally:
            if self._ckpt_pool is not None:
                self._ckpt_pool.shutdown(wait=True)
                self._ckpt_pool = None

    def load_checkpoint(self, path: str, weights_only: bool = False) -> None:
        """Full resume (epoch + 1, global_step, optimiser and EMA state,
        history) or, with ``weights_only``, the model weights alone and a
        fresh EMA (a new stage)."""
        self.flush_checkpoints()  # the file may still be in the write queue
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            self.model.load_state_dict(ckpt["model_state_dict"], strict=True)
        if weights_only:
            self.state.ema_params = init_ema(self.model) if self.use_ema else None
            print(f"Loaded model weights from epoch {ckpt.get('epoch')} (fine-tuning mode)")
            print(f"  Starting fresh with LR={self.config.learning_rate}")
            return

        self.state.opt_state = _to_device(ckpt["optimizer_state"], self.state.opt_state,
                                          self.device, "optimizer_state")
        ema = ckpt.get("ema_state_dict")
        if not self.use_ema:
            self.state.ema_params = None
        elif ema is None:  # EMA turned on at resume: start from the weights
            self.state.ema_params = init_ema(self.model)
        else:
            self.state.ema_params = _to_device(ema, self.state.ema_params, self.device,
                                               "ema_state_dict")
        self.state.step = ckpt["step"]
        # the restored state carries the checkpoint's LR: mark ours unknown
        # so the first epoch writes the schedule's
        self.current_lr = None
        self.current_epoch = ckpt["epoch"] + 1
        self.global_step = ckpt["global_step"]
        self.best_metric = ckpt["best_metric"]
        self.training_history = ckpt["training_history"]
        for k in HISTORY_KEYS:  # a checkpoint of another trainer may lack some
            self.training_history.setdefault(k, [])
        if self.plateau is not None and ckpt.get("scheduler_state"):
            self.plateau.load_state_dict(ckpt["scheduler_state"])
        print(f"Loaded checkpoint from epoch {ckpt['epoch'] + 1}")
