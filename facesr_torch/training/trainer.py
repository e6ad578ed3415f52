"""Single-card Trainer (port of `facesr/training/trainer.py`:
TrainerConfig, EarlyStopping, Trainer), content and GAN training.

Loaders are iterables of ``{'hr': NHWC float32 [0, 1]}`` batches (numpy
or torch), the JAX Trainer's contract. Per epoch: the schedule's LR is
written into the optimiser state, every batch runs one train step, the
epoch's metrics come to the host in one read, validation runs the eval
step, and checkpoints follow ``save_every`` / ``save_best``.

With ``gan_weight > 0`` and a `Discriminator`, an epoch from
``gan_start_epoch`` on runs the GAN step (`make_gan_train_step`), earlier
ones the content step. D's optimiser is the port's AdamW without clipping,
with ``d_weight_decay`` and the same non-finite guard as G's; its learning
rate stays ``d_learning_rate`` (the epoch schedule writes G's only). The
history then gains ``d_loss``, ``g_loss`` (the adversarial term),
``d_real`` and ``d_fake``, appended every epoch (0.0 before the GAN
starts) so they stay index-aligned with the others.

Every ``step_log_every`` steps the loss is printed, the one host read
between epochs; the epoch line adds the seconds the step loop waited on
the loader and the median host interval between step dispatches.

Checkpoints are ``torch.save`` files with the JAX Trainer's payload:
``model_state_dict`` under the reference key names and ``config`` (the
model config in the reference field set), so `facesr_torch.ckpt.
load_reference_pth` and the JAX package's `facesr/ckpt/convert.py` read
them; plus ``model_config``, ``trainer_config``, ``optimizer_state``,
``ema_state_dict``, ``step``, ``epoch``, ``global_step``, ``best_metric``,
``training_history``, ``scheduler_state``, ``model_type`` and
``use_gan``; a GAN trainer adds ``discriminator_state_dict`` (its
parameters and BatchNorm running stats), ``discriminator_config`` and
``d_optimizer_state``. With ``async_checkpoint`` one writer thread writes
them; the tensors are copied to the host before the step loop goes on.
`Trainer.load_checkpoint` also reads the JAX package's ``.fckpt`` files
(told apart by content), weights only. A full resume of a non-GAN
checkpoint into a GAN trainer restores G and keeps the fresh D; a
weights-only load always keeps the fresh D.

Not in this slice: mesh axes, QAT, W&B, the validation image grid and the
gradient monitor.
"""

from __future__ import annotations

import copy
import math
import os
import statistics
import sys
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt.weights import state_dict_from_jax_params
from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.training import schedules
from facesr_torch.training.optim import AdamW, set_learning_rate
from facesr_torch.training.steps import (TrainState, init_ema, make_eval_step,
                                         make_gan_train_step, make_train_step)

__all__ = ["TrainerConfig", "EarlyStopping", "Trainer", "REFERENCE_CONFIG_FIELDS",
           "overfit_test"]

# the reference FaceEnhanceNetConfig's fields: the checkpoint's ``config``
# holds only these, so the reference constructor accepts it verbatim
REFERENCE_CONFIG_FIELDS = (
    "num_channels", "num_groups", "blocks_per_group", "kernel_size",
    "reduction_ratio", "scale_factor", "res_scale", "in_channels",
    "out_channels", "init_scale", "num_rcab_blocks",
)
HISTORY_KEYS = ("train_loss", "val_loss", "val_psnr", "val_ssim", "learning_rate")
# a GAN trainer's history keys, and the epoch metric each one reads
GAN_HISTORY_KEYS = {"d_loss": "d_loss", "g_loss": "g_adv", "d_real": "d_real",
                    "d_fake": "d_fake"}
# running counts of skipped steps: an epoch's value is its last step's
COUNTERS = ("opt_notfinite", "d_opt_notfinite")


@dataclass
class TrainerConfig:
    """The JAX TrainerConfig's fields of single-card training."""

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

    # print the loss every this many steps (one host read each), 0 = off
    step_log_every: int = 24

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

    # GAN (stage 3): the adversarial term's weight (0 = off), its loss, the
    # discriminator's optimiser and updates a step, and the first epoch
    # that runs the GAN step
    gan_weight: float = 0.0
    gan_type: str = "vanilla"
    d_learning_rate: float = 1e-4
    d_weight_decay: float = 0.0
    d_updates_per_g: int = 1
    gan_start_epoch: int = 0


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
        discriminator: a `Discriminator` (moved to ``device``), needed when
            ``config.gan_weight > 0``.
    """

    def __init__(self, model, train_loader, val_loader, loss_fn,
                 config: Optional[TrainerConfig] = None, device: DeviceLike = None,
                 discriminator=None):
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

        if cfg.gan_weight > 0 and discriminator is None:
            # dropping the adversarial term would train a "GAN" stage as
            # stage 1 with no trace of why
            raise ValueError("gan_weight > 0 but no discriminator was provided: pass one "
                             "from create_discriminator, or set gan_weight to 0")
        self.use_gan = cfg.gan_weight > 0
        self.disc = None
        self._gan_step = None
        if self.use_gan:
            self.disc = self.state.disc = discriminator.to(self.device)
            # no clipping; the same non-finite guard as G's
            self.d_optimizer = AdamW(weight_decay=cfg.d_weight_decay, gradient_clip=0.0,
                                     skip_nonfinite=cfg.skip_nonfinite_updates)
            self.state.d_opt_state = self.d_optimizer.init(
                dict(self.disc.named_parameters()), cfg.d_learning_rate)
            self._gan_step = make_gan_train_step(
                loss_apply, self.optimizer, self.d_optimizer, scale_factor=cfg.scale_factor,
                gan_weight=cfg.gan_weight, gan_type=cfg.gan_type,
                d_updates_per_g=cfg.d_updates_per_g, compute_dtype=self.compute_dtype,
                ema_decay=cfg.ema_decay,
                # the BN running stats sit outside the optimiser's guard
                guard_stats=cfg.skip_nonfinite_updates > 0)

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
        self.training_history: Dict[str, List] = {k: [] for k in self._history_keys()}
        self._ckpt_pool: Optional[ThreadPoolExecutor] = None
        self._ckpt_futures: List[Future] = []
        self.last_step_times: List[float] = []
        self.last_train_metrics: Dict[str, float] = {}

    def _history_keys(self) -> List[str]:
        return list(HISTORY_KEYS) + (list(GAN_HISTORY_KEYS) if self.use_gan else [])

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

            train_metrics = self.last_train_metrics = self._train_epoch()
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
        gan_active = self.use_gan and self.current_epoch >= self.config.gan_start_epoch
        step_fn = self._gan_step if gan_active else self._train_step
        pending: List[Dict[str, torch.Tensor]] = []
        t0 = time.time()
        every = self.config.step_log_every
        total = f"/{len(self.train_loader)}" if hasattr(self.train_loader, "__len__") else ""
        loader_wait = 0.0
        dispatched = [time.perf_counter()]
        batches = iter(self.train_loader)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            loader_wait += time.perf_counter() - t_wait
            if batch is None:
                break
            hr = self._batch_to_device(batch["hr"])
            self.state, metrics = step_fn(self.state, hr)
            pending.append(metrics)
            self.global_step += 1
            dispatched.append(time.perf_counter())
            if every > 0 and len(pending) % every == 0:
                print(f"  step {len(pending)}{total} loss {metrics['loss'].item():.4f}",
                      end="\r" if sys.stdout.isatty() else "\n", flush=True)
        # host intervals between step dispatches: once the card's queue is
        # full the host waits for it, so after the first step these follow
        # the device's step time
        self.last_step_times = [b - a for a, b in zip(dispatched, dispatched[1:])]
        if not pending:
            print("WARNING: train loader yielded 0 batches this epoch — is "
                  "batch_size larger than the training split? No optimization "
                  "happened.")
        rows = self._host_values(pending)  # the epoch's one host read
        out = {k: sum(r[k] for r in rows) / len(rows) for k in (rows[0] if rows else ())}
        for k in COUNTERS:
            if rows and k in rows[-1]:
                out[k] = rows[-1][k]
        out["time_s"] = time.time() - t0
        out["loader_wait_s"] = loader_wait
        steady = self.last_step_times[1:] or self.last_step_times
        out["step_ms"] = statistics.median(steady) * 1e3 if steady else 0.0
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
        if self.use_gan:
            for key, metric in GAN_HISTORY_KEYS.items():
                h[key].append(train_metrics.get(metric, 0.0))
        print(f"\nEpoch {epoch + 1}/{self.config.epochs}")
        print(f"  Train Loss: {train_metrics['loss']:.4f}")
        print(f"  Val Loss:   {val_metrics['loss']:.4f}")
        print(f"  Val PSNR:   {val_metrics['psnr']:.2f} dB")
        print(f"  Val SSIM:   {val_metrics['ssim']:.4f}")
        print(f"  LR:         {lr:.2e}  ({train_metrics.get('time_s', 0):.1f}s)")
        if "d_loss" in train_metrics:
            print(f"  GAN:        D loss {train_metrics['d_loss']:.4f}, G adversarial "
                  f"{train_metrics['g_adv']:.4f}, D(real) {train_metrics['d_real']:.3f}, "
                  f"D(fake) {train_metrics['d_fake']:.3f}")
        print(f"  Steps:      {train_metrics.get('step_ms', 0):.1f} ms/step (median host "
              f"interval after the first), loader wait "
              f"{train_metrics.get('loader_wait_s', 0):.3f} s")

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
        gan = {}
        if self.use_gan:
            gan = {"discriminator_state_dict": _to_host(self.disc.state_dict()),
                   "discriminator_config": asdict(self.disc.config),
                   "d_optimizer_state": _to_host(self.state.d_opt_state)}
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
            "use_gan": self.use_gan,
            **gan,
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
        fresh EMA (a new stage). The format is told by content: a
        ``torch.save`` zip file, or a JAX ``.fckpt`` (flax msgpack), which
        loads weights only: its tree's ``params``, as the JAX package's
        weights-only path takes them."""
        self.flush_checkpoints()  # the file may still be in the write queue
        with open(path, "rb") as f:
            head = f.read(4)
        if fckpt.is_fckpt(head):
            if not weights_only:
                raise NotImplementedError(
                    f"{path}: a full resume from a JAX .fckpt needs its optax state mapped "
                    "to the port's optimiser (ROADMAP A.5); load it weights only")
            tree, meta = fckpt.load_checkpoint(path)
            if "params" not in tree:
                raise ValueError(f"{path}: no 'params' in the checkpoint tree")
            sd = state_dict_from_jax_params(fckpt.restore_list_nodes(tree["params"]))
            epoch = meta.get("epoch")
        elif head == b"PK\x03\x04":
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
            sd, epoch = ckpt["model_state_dict"], ckpt.get("epoch")
        else:
            raise ValueError(f"{path} is neither a torch checkpoint nor a JAX .fckpt")
        with torch.no_grad():
            self.model.load_state_dict(sd, strict=True)
        if weights_only:
            self.state.ema_params = init_ema(self.model) if self.use_ema else None
            print(f"Loaded model weights from epoch {epoch} (fine-tuning mode)")
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
        if self.use_gan and ckpt.get("use_gan"):
            with torch.no_grad():
                self.disc.load_state_dict(ckpt["discriminator_state_dict"], strict=True)
            self.state.d_opt_state = _to_device(ckpt["d_optimizer_state"],
                                                self.state.d_opt_state, self.device,
                                                "d_optimizer_state")
        elif self.use_gan:
            print("  Checkpoint has no discriminator state; D starts fresh")
        self.state.step = ckpt["step"]
        # the restored state carries the checkpoint's LR: mark ours unknown
        # so the first epoch writes the schedule's
        self.current_lr = None
        self.current_epoch = ckpt["epoch"] + 1
        self.global_step = ckpt["global_step"]
        self.best_metric = ckpt["best_metric"]
        self.training_history = ckpt["training_history"]
        for k in self._history_keys():  # a checkpoint of another trainer may lack some
            self.training_history.setdefault(k, [])
        if self.plateau is not None and ckpt.get("scheduler_state"):
            self.plateau.load_state_dict(ckpt["scheduler_state"])
        print(f"Loaded checkpoint from epoch {ckpt['epoch'] + 1}")


def overfit_test(model, dataloader, loss_fn=None, num_images: int = 10,
                 num_iterations: int = 1000, learning_rate: float = 2e-4,
                 device: DeviceLike = None) -> Dict[str, Any]:
    """Overfit ``num_images`` HR crops of the loader's first batch with pure
    MSE on the clamped output (``loss_fn`` is accepted and unused, as in the
    JAX package) and plain Adam; converged iff the final PSNR > 35 dB. The
    loss is read every 50 iterations and at the last."""
    from facesr_torch.ops.conv import full_f32
    from facesr_torch.ops.resize import bicubic_down

    print(f"\nOverfitting test on {num_images} images...")
    dev = resolve_device(device)
    model = model.to(dev)
    hr = torch.as_tensor(next(iter(dataloader))["hr"][:num_images],
                         dtype=torch.float32).to(dev)
    scale = model.config.scale_factor
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=learning_rate, eps=1e-8, foreach=False)
    losses, psnrs = [], []
    for i in range(num_iterations):
        with full_f32():
            sr = model(bicubic_down(hr, scale), train=True).clamp(0.0, 1.0)
            mse = ((sr - hr) ** 2).mean()
            opt.zero_grad(set_to_none=True)
            mse.backward()
        opt.step()
        if i % 50 == 0 or i == num_iterations - 1:
            m = mse.item()
            losses.append(m)
            psnrs.append(10.0 * math.log10(1.0 / max(m, 1e-12)))
            print(f"  iter {i}: loss={losses[-1]:.6f} psnr={psnrs[-1]:.2f}")
    results = {"final_loss": losses[-1], "final_psnr": psnrs[-1], "loss_history": losses,
               "psnr_history": psnrs, "converged": psnrs[-1] > 35}
    print("\nOverfit test results:")
    print(f"  Final loss: {results['final_loss']:.6f}")
    print(f"  Final PSNR: {results['final_psnr']:.2f} dB")
    print(f"  Converged: {results['converged']}")
    return results
