"""The Trainer (port of `facesr/training/trainer.py`: TrainerConfig,
EarlyStopping, Trainer), content and GAN training, on one card or
data-parallel over the ranks of a process group.

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
the loader and the median host interval between step dispatches. With
``log_gradients_every`` N > 0 the steps compute every trained parameter's
gradient norm on the device (the whole leaf's on every mesh), and every
N steps they come to the host into ``gradient_monitor`` (a
`callbacks.GradientMonitor`, by the port's parameter names); they stay
out of the epoch's metric means.

Checkpoints are ``torch.save`` files with the JAX Trainer's payload:
``model_state_dict`` under the reference key names and ``config`` (the
model config in the reference field set), so `facesr_torch.ckpt.
load_reference_pth` and the JAX package's `facesr/ckpt/convert.py` read
them; plus ``model_config``, ``trainer_config``, ``optimizer_state``,
``ema_state_dict``, ``step``, ``epoch``, ``global_step``, ``best_metric``,
``training_history``, ``scheduler_state``, ``model_type`` and
``use_gan``; a GAN trainer adds ``discriminator_state_dict`` (its
parameters and BatchNorm running stats), ``discriminator_config`` and
``d_optimizer_state``. Beside each ``.pth`` the Trainer writes a ``.fckpt``
of the same stem: the JAX Trainer's file (its ``TrainState`` tree with
the optax state of the same optimiser, `ckpt.fckpt.train_state_tree`, and
its meta), which the JAX package's loaders and Trainer read. With
``async_checkpoint`` one writer thread writes both; the tensors are copied
to the host before the step loop goes on.
`Trainer.load_checkpoint` reads either format (told apart by content), a
``.fckpt`` from either package, weights only or as a full resume. A full
resume of a non-GAN checkpoint into a GAN trainer restores G and keeps the
fresh D; a weights-only load always keeps the fresh D.

With ``qat`` every conv site the int8 serving path quantizes runs
fake-quantized (`ops.quant.fake_quant_params`: the serving grid, with
straight-through gradients) in training and in validation, so val PSNR
and early stopping follow the quantized model; ``qat_scales`` (calibrated
int8 sites, or `set_qat_scales` before the first step) pins the
activation grid to static serving scales. Checkpoints keep the latent
float weights; quantize at export (`cli.export_quantized`).

The model is a `FaceEnhanceNet`, a `TransferSRModel` or an `RRDBNet`
(`ESRGANBaseline`); checkpoints carry its ``model_type`` and
``model_config``. A transfer model trains the parameters its stage leaves
unfrozen (``requires_grad``), so frozen tensors stay bitwise unchanged and
the default optimiser's clip, decay and moments cover the trained ones
only, as the JAX Trainer's ``param_labels`` multi-transform.
``optimizer`` takes a custom optimiser in place of the default AdamW, such
as the transfer model's `make_stage_optimizer`; the config's non-finite
guard is applied to it too.

Data parallelism (``mesh``, or the default process group when one is
initialised; `parallel.mesh.get_mesh`): one process a card, each rank's
loaders yield that rank's rows (the port's loaders shard by rank, every
rank the same number of batches), the steps reduce gradients and metrics
over the ranks, and the state is broadcast from rank 0 at construction
and after every checkpoint load, so the replicas stay bitwise equal.
Validation reduces each batch's squared-error sum and row counts over
the ranks (PSNR from the global MSE, loss and SSIM row-weighted); a rank
that runs out of validation batches first adds masked ones, so every rank
calls the same collectives, and early stopping and best-model selection
decide alike everywhere. Only the writer (rank 0, or every rank with
``write_all_processes``) writes checkpoints. `local_batch_size` is the
JAX Trainer's trim-or-pad rule for a global batch over the ranks.
``mesh_axes: data,space`` with ``mesh_shape: [d, s]`` trains dp x sp on
d * s ranks (`parallel.mesh` grid): the ranks of a `space` group load the
same batch rows (the loaders shard by the data coordinate), the steps split
the image rows (`training.steps`), the batch divisor is d, and an HR
height must divide by s x the scale. GAN and QAT training run there too
(D's rows split, its BatchNorm over the grid; the fake-quant scale over
the shards). ``mesh_axes: data,model`` with ``mesh_shape: [d, t]``
trains dp x tp on d * t ranks: the batch divisor is d, and after rank 0's
broadcast every rank keeps its slice of each leaf
`parallel.mesh.tp_param_shardings` splits (G's parameters, moments and
EMA, D's parameters, running stats and moments, the loss's VGG convs;
`parallel.tensor.shard_state`), which the steps train on the rank's
channel slices. A checkpoint gathers the state whole first (every rank
takes part; rank 0 writes a ``.pth`` a single-process model loads and a
``.fckpt`` either package resumes), and a load reads the whole file and
keeps each rank's slice. tp state over more than one host is refused, as
in JAX. ``mesh_axes: data,pp`` with ``mesh_shape: [d, S]`` trains dp x pp
on d * S ranks: each `pp` group runs its batch rows' residual groups as
an S-stage pipeline in ``pp_microbatches`` microbatches (0: S), the batch
divisor is d x the microbatches (a rank's rows trimmed or padded to a
multiple of them, JAX's rule), and after rank 0's broadcast every rank
keeps only its stage's groups' leaves of the state (G's parameters,
moments and EMA; `parallel.mesh.pp_param_shardings`,
`parallel.pipeline.shard_state`), which checkpoints gather whole as
under tp. As in JAX, pp refuses QAT, a model other than FaceEnhanceNet,
``num_groups`` that does not divide over the stages and more than one
host. ``mesh_axes: data,space,model`` (or ``data,model,space``) with
``mesh_shape: [d, s, t]`` (in the axes' order) trains all three at once
on d * s * t ranks: the ranks of a batch shard's `space` x `model` block
load the same rows (by the data coordinate), each holds its slice of the
state as under tp and runs the steps on its image rows and channel slices,
the batch divisor is d and an HR height must divide by s x the scale;
checkpoints, loads, the stop at a step's end and the single-host rule
are tp's. `memory_report` gives the state's and the batch's bytes per rank
(under tp a rank's slices, under pp its stage's groups) and, on a card,
the measured peak of one step.

After each validation the writer saves the LR|SR|HR grid of the first
batch's first images (`save_validation_grid`, ``<log_dir>/epoch_NNNN.png``)
where its eval step returns whole images (not under a row split). Not in
this slice: W&B.
"""

from __future__ import annotations

import contextlib
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

import numpy as np
import torch

from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt import optax_state as ox
from facesr_torch.ckpt.weights import (REFERENCE_CONFIG_FIELDS,  # noqa: F401 — re-exported
                                       discriminator_state_dict_from_jax, reference_config,
                                       state_dict_from_jax, vgg_params_from_jax)
from facesr_torch.data.png import write_png
from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.ops.quant import fake_quant_params
from facesr_torch.ops.resize import nearest_up
from facesr_torch.parallel import pipeline, spatial, tensor
from facesr_torch.parallel.mesh import (Mesh, all_reduce_max, all_reduce_sum, check_mesh_axes,
                                        check_single_host, get_mesh, pad_to_multiple,
                                        pp_param_shardings, pp_stages, replicate, shard_batch,
                                        tp_param_shardings)
from facesr_torch.training import schedules
from facesr_torch.training.callbacks import GradientMonitor
from facesr_torch.training.optim import AdamW, set_learning_rate
from facesr_torch.training.steps import (TrainState, _dp, _mean_metrics, _reduced, _slabs,
                                         eval_metrics_from_sums, init_ema,
                                         make_eval_step, make_gan_train_step,
                                         make_train_step, trainable_parameters)

__all__ = ["TrainerConfig", "EarlyStopping", "Trainer", "REFERENCE_CONFIG_FIELDS",
           "overfit_test", "local_batch_size", "save_validation_grid"]

HISTORY_KEYS = ("train_loss", "val_loss", "val_psnr", "val_ssim", "learning_rate")
# a GAN trainer's history keys, and the epoch metric each one reads
GAN_HISTORY_KEYS = {"d_loss": "d_loss", "g_loss": "g_adv", "d_real": "d_real",
                    "d_fake": "d_fake"}
# running counts of skipped steps: an epoch's value is its last step's
COUNTERS = ("opt_notfinite", "d_opt_notfinite")


def save_validation_grid(lr_images, sr_images, hr_images, epoch: int,
                         save_dir: str = "training_logs") -> None:
    """The LR|SR|HR comparison grid of an epoch, as the JAX package's
    `save_validation_grid`: NHWC float [0, 1] in (clipped), the LR
    nearest-upscaled to the HR size, at most 4 rows, 2-pixel white padding,
    ``(grid * 255).astype(uint8)`` (truncated), written as
    ``<save_dir>/epoch_NNNN.png``."""
    save_path = Path(save_dir)
    save_path.mkdir(parents=True, exist_ok=True)
    lr_images = np.clip(np.asarray(lr_images), 0, 1)
    sr_images = np.clip(np.asarray(sr_images), 0, 1)
    hr_images = np.clip(np.asarray(hr_images), 0, 1)
    scale = hr_images.shape[1] // lr_images.shape[1]
    lr_up = nearest_up(torch.from_numpy(np.ascontiguousarray(lr_images)), scale).numpy()
    num = min(4, lr_images.shape[0])
    pad = 2
    h, w = hr_images.shape[1], hr_images.shape[2]
    grid = np.ones((num * (h + pad) + pad, 3 * (w + pad) + pad, 3), dtype=np.float32)
    for i in range(num):
        for j, img in enumerate((lr_up[i], sr_images[i], hr_images[i])):
            y0 = pad + i * (h + pad)
            x0 = pad + j * (w + pad)
            grid[y0:y0 + h, x0:x0 + w] = img
    write_png(save_path / f"epoch_{epoch:04d}.png", (grid * 255).astype(np.uint8))


@dataclass
class TrainerConfig:
    """The JAX TrainerConfig's fields of training on one card or over the
    `data` axis."""

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
    # every this many steps the per-parameter gradient norms come to the
    # host into `Trainer.gradient_monitor` (0 = off: the steps compute none)
    log_gradients_every: int = 0

    checkpoint_dir: str = "checkpoints"
    log_dir: str = "training_logs"  # the validation grids
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
    # quantization-aware training: every int8 serving site runs fake-quant
    # (train and validation); checkpoints keep the latent float weights
    qat: bool = False
    # the mesh: the batch axis and the composition ("data", or "data,space",
    # "data,model" or "data,pp" with mesh_shape [d, k], or "data,space,model"
    # with [d, s, t])
    mesh_axis: str = "data"
    mesh_axes: str = "data"
    mesh_shape: Optional[tuple] = None
    # pp microbatches a step; 0 = one a pipeline stage. More shrink the
    # pipeline's bubble but must divide a rank's rows
    pp_microbatches: int = 0
    # every rank writes checkpoints (per-host local disks), not rank 0 only
    write_all_processes: bool = False


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


def local_batch_size(batch_size: int, world_size: int) -> int:
    """This rank's rows of a global batch of ``batch_size`` over
    ``world_size`` ranks (the JAX Trainer's `_shard_hr` rule): the
    remainder of a batch at least as large as the world is dropped, and a
    smaller batch grows to one row a rank; each prints the JAX warning."""
    rem = batch_size % world_size
    if rem and batch_size >= world_size:
        print(f"Warning: batch of {batch_size} trimmed to {batch_size - rem} for "
              f"mesh_axes=data over {world_size} ranks ({rem} samples dropped per batch "
              f"— pick a batch_size divisible by {world_size})")
    elif rem:
        print(f"Warning: batch of {batch_size} padded to a multiple of {world_size} for "
              f"mesh_axes=data: each of the {world_size} ranks loads 1 row, so the global "
              f"batch is {world_size} rows")
        return 1
    return batch_size // world_size


def _trainer_mesh(cfg: "TrainerConfig", mesh: Optional[Mesh], device: DeviceLike) -> Mesh:
    """The Trainer's mesh: ``mesh``, else the default process group's (this
    rank's device; a grid of ``mesh_shape``) when one is initialised, else
    one device alone."""
    axes = tuple(a.strip() for a in cfg.mesh_axes.split(",") if a.strip())
    if not axes:
        raise ValueError("training.mesh_axes must name at least the batch axis (e.g. "
                         "'data'), got an empty value")
    if axes[0] != cfg.mesh_axis:
        raise ValueError(f"mesh_axes must start with the batch axis {cfg.mesh_axis!r}, "
                         f"got {axes}")
    check_mesh_axes(axes, cfg.mesh_shape)
    if len(axes) > 1 and cfg.mesh_shape is None:
        raise ValueError("mesh_shape is required with multiple mesh_axes, e.g. "
                         "mesh_shape: [4, 2] for 'data,space' on 8 chips")
    shape = None if cfg.mesh_shape is None else tuple(int(v) for v in cfg.mesh_shape)
    if mesh is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            mesh = get_mesh(devices=None if device is None else [device], axis_names=axes,
                            shape=shape)
        elif shape is not None and math.prod(shape) != 1:
            raise ValueError(f"mesh_shape {shape} needs {math.prod(shape)} ranks and this "
                             "process is alone: start them with torchrun or "
                             "parallel.launch (the train CLI: --mesh-axes/--mesh-shape)")
        else:
            mesh = Mesh((resolve_device(device),), axis_names=axes,
                        shape=shape if len(axes) > 1 else None)
    if len(mesh.devices) != 1:
        raise ValueError(f"a Trainer drives one device a process, got {mesh.devices}: "
                         "launch one process per card (torchrun, or the train CLI)")
    if tuple(mesh.axis_names) != axes:
        raise ValueError(f"mesh_axes {','.join(axes)} but the mesh's axes are "
                         f"{','.join(mesh.axis_names)}")
    if shape is not None and shape != (mesh.shape or (mesh.size,)):
        raise ValueError(f"mesh_shape {shape} does not match the "
                         f"{mesh.shape or mesh.size} rank(s) of the mesh")
    if ("model" in axes or "pp" in axes) and mesh.distributed:
        check_single_host(mesh.world_size)
    return mesh


def _write(path: str, payload: Dict[str, Any]) -> None:
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


CHECKPOINT_SUFFIXES = (".pth", ".fckpt")


def _fckpt_meta(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX Trainer's checkpoint meta, from a `.pth` payload."""
    return {"epoch": payload["epoch"], "global_step": payload["global_step"],
            "best_metric": payload["best_metric"],
            "training_history": payload["training_history"],
            "config": payload["trainer_config"], "model_config": payload["model_config"],
            "model_type": payload["model_type"],
            "scheduler_state": payload["scheduler_state"], "use_gan": payload["use_gan"]}


class Trainer:
    """Training manager, on one card or as one rank of a data-parallel group.

    Args:
        model: a `FaceEnhanceNet`, `TransferSRModel` or `RRDBNet` (moved to
            ``device``).
        train_loader / val_loader: iterables of {'hr': NHWC float32 [0, 1]}.
        loss_fn: a `CombinedLoss` (moved to ``device``).
        device: CUDA unless the caller names one.
        discriminator: a `Discriminator` (moved to ``device``), needed when
            ``config.gan_weight > 0``.
        qat_scales: with ``config.qat``, calibrated int8 sites of the same
            architecture whose static activation scales pin the fake-quant
            grid (`set_qat_scales` sets them later, before the first step).
        optimizer: an optimiser in place of the default AdamW (the
            transfer model's `make_stage_optimizer`); one whose clip needs
            the frozen parameters' gradients (``needs_frozen_grads``) gets
            them: every parameter then requires grad, and its labels keep
            the frozen ones unchanged.
        mesh: the `data` mesh (`parallel.mesh.get_mesh`); None takes the
            default process group's when one is initialised (this rank's
            device), else ``device`` alone. Under a group the device is the
            mesh's.
    """

    def __init__(self, model, train_loader, val_loader, loss_fn,
                 config: Optional[TrainerConfig] = None, device: DeviceLike = None,
                 discriminator=None, qat_scales=None, optimizer=None,
                 mesh: Optional[Mesh] = None):
        self.config = cfg = config or TrainerConfig()
        self.mesh = _trainer_mesh(cfg, mesh, device)
        self.device = self.mesh.device
        self.n_devices = self.mesh.size
        # under pp a rank's rows split into the microbatches too
        self._pp_micro = 1
        if "pp" in self.mesh.axis_names:
            pipeline.check_pp_model(model, self.mesh.axis_size("pp"))
            if cfg.qat:
                raise ValueError("qat + pipeline parallelism is not supported (fake-quant scale "
                                 "leaves break the stage sharding rule); use dp/sp/tp meshes "
                                 "for QAT")
            self._pp_micro = cfg.pp_microbatches or self.mesh.axis_size("pp")
        self._warned_micro = False
        # the global batch must split over the data axis and a rank's rows
        # over the pp microbatches (memory_report's check)
        self._batch_divisor = self.mesh.data_size * self._pp_micro
        # one writer: every rank holds the same replicated state
        self.is_writer = bool(cfg.write_all_processes) or self.mesh.rank == 0
        self._warned_nonwriter = False
        self.model = model.to(self.device)
        self.model_cfg = model.config
        self.model_type = getattr(model, "model_type", "custom")
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.loss_fn = loss_fn.to(self.device)

        self.compute_dtype = torch.bfloat16 if cfg.use_amp else None
        cd, vr = self.compute_dtype, cfg.vgg_remat
        loss_apply = lambda lp, p, t: loss_fn.apply(lp, p, t, compute_dtype=cd, vgg_remat=vr)
        # validation stays f32 end to end; no backward runs, so no remat
        loss_apply_eval = lambda lp, p, t: loss_fn.apply(lp, p, t, compute_dtype=None,
                                                         vgg_remat=False)
        self._qat_sites = None
        self._qat_frozen = False
        if cfg.qat:
            self._qat_sites = fake_quant_params(self.model, act_scales=qat_scales)
        elif qat_scales is not None:
            raise ValueError("qat_scales requires config.qat")
        quant_fn = self._qat_quant if cfg.qat else None
        if optimizer is None:
            optimizer = AdamW(weight_decay=cfg.weight_decay, gradient_clip=cfg.gradient_clip,
                              accumulation_steps=cfg.accumulation_steps,
                              skip_nonfinite=cfg.skip_nonfinite_updates)
        else:
            if cfg.skip_nonfinite_updates > 0:  # a custom optimiser keeps the guard
                optimizer.skip_nonfinite = cfg.skip_nonfinite_updates
            if getattr(optimizer, "needs_frozen_grads", False):
                for p in self.model.parameters():
                    p.requires_grad_(True)
        self.optimizer = optimizer
        self.use_ema = cfg.ema_decay > 0
        self.state = TrainState(
            model=self.model,
            opt_state=self.optimizer.init(trainable_parameters(self.model), cfg.learning_rate),
            loss_params=self.loss_fn.params,
            ema_params=init_ema(self.model) if self.use_ema else None)
        norms_on = cfg.log_gradients_every > 0
        self.gradient_monitor = GradientMonitor() if norms_on else None
        self._train_step = make_train_step(loss_apply, self.optimizer,
                                           scale_factor=cfg.scale_factor,
                                           compute_dtype=self.compute_dtype,
                                           ema_decay=cfg.ema_decay, quant_fn=quant_fn,
                                           mesh=self.mesh, pp_microbatches=self._pp_micro,
                                           grad_norms=norms_on)
        self._eval_step = make_eval_step(loss_apply_eval, scale_factor=cfg.scale_factor,
                                         use_ema=self.use_ema, quant_fn=quant_fn,
                                         mesh=self.mesh, pp_microbatches=self._pp_micro)

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
                guard_stats=cfg.skip_nonfinite_updates > 0, quant_fn=quant_fn,
                mesh=self.mesh, pp_microbatches=self._pp_micro, grad_norms=norms_on)
        self._replicate_state()
        # tp and pp: the whole state's placement, then each rank's part
        self._tp, self._pp = self.mesh.model_shard(), self.mesh.pp_shard()
        self._state_sharding = self._stages = None
        if self._tp is not None:
            self._state_sharding = tp_param_shardings(self.state, self.mesh)
        elif self._pp is not None:
            self._state_sharding = pp_param_shardings(self.state, self.mesh)
            self._stages = pp_stages(self.state, self.mesh)
        self._shard_state()
        self._stop_reason: Optional[str] = None  # `request_stop`

        self.plateau = (schedules.ReduceLROnPlateau(cfg.learning_rate)
                        if cfg.scheduler_type == "plateau" else None)
        self.early_stopping = EarlyStopping(patience=cfg.early_stopping_patience,
                                            mode=cfg.early_stopping_mode)
        self.checkpoint_dir = Path(cfg.checkpoint_dir)
        if self.is_writer:
            self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self._last_val_batches = 1
        self.best_metric: Optional[float] = None
        self.current_epoch = 0
        self.global_step = 0
        self.current_lr: Optional[float] = cfg.learning_rate
        self.training_history: Dict[str, List] = {k: [] for k in self._history_keys()}
        self._ckpt_pool: Optional[ThreadPoolExecutor] = None
        self._ckpt_futures: List[Future] = []
        self._loss_tree: Optional[Dict[str, Any]] = None
        self.last_step_times: List[float] = []
        self.last_train_metrics: Dict[str, float] = {}

    def _replicate_state(self) -> None:
        """Every rank's state made rank 0's (a broadcast; no-op without a
        group): the model's parameters and buffers, both optimisers'
        state, the EMA, the discriminator and the loss's frozen params."""
        replicate([self.model, self.state.opt_state, self.state.ema_params,
                   self.loss_fn.params, self.disc, self.state.d_opt_state], self.mesh)

    def _shard_state(self) -> None:
        """Under tp, keep this rank's slice of every split leaf; under pp,
        its stage's groups' leaves (no-op otherwise)."""
        if self._tp is not None:
            tensor.shard_state(self.state, self._tp, self._state_sharding)
        elif self._pp is not None:
            pipeline.shard_state(self.state, self._pp, self._stages)

    @property
    def stops_at_step_boundary(self) -> bool:
        """Whether a signal should `request_stop` rather than interrupt
        (under tp and pp: saving is a collective, so the ranks stop
        together)."""
        return self._tp is not None or self._pp is not None

    def request_stop(self, reason: str) -> None:
        """Stop training after the step that is running: at that step's
        end every rank of the group learns that one asked and raises
        KeyboardInterrupt (``reason`` on the rank that asked)."""
        self._stop_reason = reason

    def _stop_agreed(self) -> bool:
        """Whether any rank asked to stop (a max over the group: a
        collective every rank enters after each step under tp and pp)."""
        asked = torch.tensor([float(self._stop_reason is not None)], device=self.device)
        return bool(all_reduce_max(asked, self.mesh).item())

    @contextlib.contextmanager
    def whole_state(self):
        """The block runs with the state whole on every rank (under tp the
        slices, under pp the stages' groups are gathered first and each
        rank's part kept again after; a collective every rank of the group
        enters)."""
        if self._tp is not None:
            tensor.unshard_state(self.state, self._tp, self._state_sharding)
        elif self._pp is not None:
            pipeline.unshard_state(self.state, self._pp, self._stages)
        else:
            yield
            return
        try:
            yield
        finally:
            self._shard_state()

    def _qat_quant(self):
        # the first step that reads the sites fixes them (set_qat_scales refuses after)
        self._qat_frozen = True
        return self._qat_sites

    def set_qat_scales(self, qat_scales) -> None:
        """Pin the fake-quant grid to calibrated scales after construction
        but before any step has run: the provenance check of a quant cache
        must see the weights training starts from, which a checkpoint load
        after ``__init__`` sets (the train CLI's ``--qat-scales``)."""
        if not self.config.qat:
            raise ValueError("set_qat_scales requires config.qat")
        if self._qat_frozen:
            raise RuntimeError("a training/eval step already ran with the previous "
                               "qat_scales; set them before the first step")
        with self.whole_state():  # the sites are checked against the whole kernels
            self._qat_sites = fake_quant_params(self.model, act_scales=qat_scales)

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

    def _check_rows(self, h: int) -> None:
        """On a `space` axis of s ranks the LR image's rows split too, so an
        HR height must divide by s x the scale."""
        s, scale = self.mesh.axis_size("space"), self.config.scale_factor
        if s > 1 and h % (s * scale):
            raise ValueError(f"image height {h} must divide over the {s}-way 'space' axis "
                             f"(pick an hr_patch_size divisible by {s * scale}: the "
                             f"x{scale} LR image's rows split too)")

    def _fit_microbatches(self, t: torch.Tensor) -> torch.Tensor:
        """Under pp, a rank's rows made a multiple of the microbatches (the
        JAX Trainer's `_shard_hr` rule): the remainder dropped, or a batch
        smaller than them padded by repetition, each with its warning."""
        div, n = self._pp_micro, t.shape[0]
        rem = n % div
        if not rem:
            return t
        if not self._warned_micro:
            self._warned_micro = True
            if n >= div:
                print(f"Warning: batch of {n} trimmed to {n - rem} for mesh_axes="
                      f"{self.config.mesh_axes} ({rem} samples dropped per batch — pick a "
                      f"batch_size divisible by {div})")
            else:
                print(f"Warning: batch of {n} padded by repetition to a multiple of {div} for "
                      f"mesh_axes={self.config.mesh_axes}; metrics over this batch include "
                      "duplicate samples")
        if n >= div:
            return t[:n - rem]
        return torch.cat([t, t[-1:].repeat(div - rem, *(1,) * (t.dim() - 1))])

    def _batch_to_device(self, hr) -> torch.Tensor:
        """One loader batch on the card: pinned, then an asynchronous copy,
        so the step loop does not wait for the card here."""
        t = self._fit_microbatches(torch.as_tensor(hr))
        self._check_rows(t.shape[1])
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
    def memory_report(self, batch_size: int, hr_size: int, gan: Optional[bool] = None,
                      echo: bool = True) -> Dict[str, Any]:
        """This rank's device memory for the train step at a global batch
        of ``batch_size`` (a multiple of the rank count) of HR
        ``hr_size``: the state's bytes by part and the batch's
        (`utils.profiling.memory_report`); on a card also the peak of one
        step, which runs once on a random batch, after which the state
        (weights, optimisers, EMA, D and its stats, the step count) is
        restored. Under a group every rank must call it (the step's
        collectives)."""
        from facesr_torch.utils.profiling import format_memory_report, memory_report

        use_gan = self.use_gan if gan is None else gan
        if use_gan and self._gan_step is None:
            raise ValueError("memory_report(gan=True) needs a GAN trainer "
                             "(config.gan_weight > 0 and a discriminator)")
        if batch_size % self._batch_divisor:
            raise ValueError(f"batch_size {batch_size} is not a multiple of "
                             f"{self._batch_divisor} (the ranks of the data axis x the pp "
                             "microbatches)")
        local = batch_size // self._batch_divisor
        self._check_rows(hr_size)
        hr = torch.rand((local, hr_size, hr_size, 3),
                        generator=torch.Generator().manual_seed(0)).to(self.device)
        parts = {"params": self.model, "opt_state": self.state.opt_state,
                 "ema": self.state.ema_params}
        if use_gan:
            parts.update(disc=self.disc, d_opt_state=self.state.d_opt_state)
        step = self._gan_step if use_gan else self._train_step
        # this rank's state as it stands (under tp its slices, under pp its stage's)
        snapshot = self._checkpoint_payload() if self.device.type == "cuda" else None
        frozen = self._qat_frozen
        try:
            report = memory_report(parts, hr, lambda: step(self.state, hr),
                                   rank=self.mesh.rank, world_size=self.mesh.world_size)
        finally:
            if snapshot is not None:
                self._restore_payload(snapshot)
            self._qat_frozen = frozen
        if echo:
            label = (f"{'GAN' if use_gan else 'content'} step, mesh_axes="
                     f"{self.config.mesh_axes}, batch={batch_size}@{hr_size}px "
                     f"({local} a rank)")
            print(format_memory_report(report, label))
        return report

    def _restore_payload(self, payload: Dict[str, Any]) -> None:
        """The state of a `_checkpoint_payload` written back (weights,
        optimisers, EMA, D with its stats, the step count)."""
        with torch.no_grad():
            self.model.load_state_dict(payload["model_state_dict"], strict=True)
        self.state.opt_state = _to_device(payload["optimizer_state"], self.state.opt_state,
                                          self.device, "optimizer_state")
        if payload["ema_state_dict"] is not None:
            self.state.ema_params = _to_device(payload["ema_state_dict"], self.state.ema_params,
                                               self.device, "ema_state_dict")
        if self.use_gan:
            with torch.no_grad():
                self.disc.load_state_dict(payload["discriminator_state_dict"], strict=True)
            self.state.d_opt_state = _to_device(payload["d_optimizer_state"],
                                                self.state.d_opt_state, self.device,
                                                "d_optimizer_state")
        self.state.step = payload["step"]
        if self._tp is not None or self._pp is not None:  # the new EMA tensors: its part
            tensor.mark_split(self.state, self._state_sharding)

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        """The full loop: per epoch LR, train, validate, log, checkpoint,
        early stopping; then the final checkpoint."""
        print(f"Starting training on {self.n_devices} device(s): {self.device}"
              + (f" (rank {self.mesh.rank} of {self.mesh.world_size})"
                 if self.mesh.distributed else ""))
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
                self.save_checkpoint(f"epoch_{epoch + 1}")

            metric_key = self.config.early_stopping_metric.replace("val_", "")
            metric_value = val_metrics.get(metric_key, val_metrics.get("psnr", 0.0))
            if self._last_val_batches > 0:  # zero-batch validation = no metric
                if self.config.save_best and self._is_best(metric_value):
                    self.save_checkpoint("best_model", is_best=True)
                if self.early_stopping(metric_value):
                    print(f"\nEarly stopping triggered at epoch {epoch + 1}")
                    break

        self.save_checkpoint("final_model")
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
            norms = metrics.pop("grad_norms", None)  # kept out of the epoch's means
            pending.append(metrics)
            self.global_step += 1
            if norms is not None and self.global_step % self.config.log_gradients_every == 0:
                self.gradient_monitor.update(norms)  # one host read
            dispatched.append(time.perf_counter())
            if every > 0 and len(pending) % every == 0:
                print(f"  step {len(pending)}{total} loss {metrics['loss'].item():.4f}",
                      end="\r" if sys.stdout.isatty() else "\n", flush=True)
            if self.stops_at_step_boundary and self._stop_agreed():
                raise KeyboardInterrupt(self._stop_reason or "another rank's signal")
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
        dp = self.mesh.distributed
        pending = []
        sample = None
        # the grid needs whole images: under a row split sr and lr are slabs
        grid = self.is_writer and getattr(self._eval_step, "row_shard", None) is None
        for batch in self.val_loader:
            hr = self._batch_to_device(batch["hr"])
            metrics, sr, lr_img = (self._eval_step(self.state, hr, reduce=False) if dp
                                   else self._eval_step(self.state, hr))
            pending.append(metrics)
            if grid and sample is None:
                sample = tuple(t[:8].float().cpu().numpy() for t in (lr_img, sr, hr))
        if dp:
            # one reduction an epoch: every rank's batch sums, the table of a
            # rank short of batches padded with zero rows
            n = int(all_reduce_max(torch.tensor([float(len(pending))], device=self.device),
                                   self.mesh).item())
            table = torch.zeros((n, 5), device=self.device)
            if pending:
                table[:len(pending)] = torch.stack([m["sums"] for m in pending])
            metrics = eval_metrics_from_sums(all_reduce_sum(table, self.mesh))
            pending = [{k: v[i] for k, v in metrics.items()} for i in range(n)]
        rows = self._host_values(pending)  # one host read
        self._last_val_batches = len(rows)
        if sample is not None:
            try:
                save_validation_grid(*sample, epoch=self.current_epoch,
                                     save_dir=self.config.log_dir)
            except Exception as e:  # a picture must never stop training
                print(f"Warning: failed to save validation grid: {e}")
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
        """What a checkpoint file holds, every tensor copied to the host (of
        the state as it stands: under tp and pp, within `whole_state`)."""
        model_config = asdict(self.model_cfg)
        gan = {}
        if self.use_gan:
            gan = {"discriminator_state_dict": _to_host(self.disc.state_dict()),
                   "discriminator_config": asdict(self.disc.config),
                   "d_optimizer_state": _to_host(self.state.d_opt_state)}
        return {
            "model_state_dict": _to_host(self.model.state_dict()),
            "config": reference_config(self.model),
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
            "model_type": self.model_type,
            "use_gan": self.use_gan,
            **gan,
        }

    def _loss_params_tree(self) -> Dict[str, Any]:
        """The loss's frozen params in the JAX layout, copied to the host
        once (they change only when a full resume loads them)."""
        if self._loss_tree is None:
            self._loss_tree = fckpt.loss_params_tree(self.loss_fn.params)
        return self._loss_tree

    def _write_checkpoints(self, base: str, payload: Dict[str, Any],
                           loss_tree: Dict[str, Any]) -> None:
        """``base.pth`` and ``base.fckpt`` of one host payload."""
        _write(f"{base}.pth", payload)
        gan = payload["use_gan"]
        tree = fckpt.train_state_tree(
            self.model_type, payload["model_state_dict"], self.optimizer,
            payload["optimizer_state"], payload["step"], loss_tree,
            ema=payload["ema_state_dict"],
            disc_sd=payload["discriminator_state_dict"] if gan else None,
            d_optimizer=self.d_optimizer if gan else None,
            d_opt_state=payload["d_optimizer_state"] if gan else None)
        fckpt.save_checkpoint(f"{base}.fckpt", tree, _fckpt_meta(payload))

    def save_checkpoint(self, filename: str, is_best: bool = False) -> None:
        """Write ``checkpoint_dir/<stem>.pth`` and ``<stem>.fckpt`` (the
        stem of ``filename``: a ``.pth`` or ``.fckpt`` suffix is dropped):
        on the writer thread with ``async_checkpoint`` (the payload is on
        the host before this returns), else here. A rank that is not the
        writer writes nothing (this covers the interrupt path too); under
        tp and pp every rank first takes part in gathering the state whole."""
        with self.whole_state():  # under tp and pp every rank takes part in the gather
            host = ((self._checkpoint_payload(), self._loss_params_tree())
                    if self.is_writer else None)
        if not self.is_writer:
            if not self._warned_nonwriter:
                print(f"rank {self.mesh.rank}: checkpoint writes delegated to rank 0 "
                      "(write_all_processes=False)")
                self._warned_nonwriter = True
            if is_best:
                print(f"  New best model: {self.best_metric:.4f} (saved by rank 0)")
            return
        stem = filename
        for suffix in CHECKPOINT_SUFFIXES:
            if stem.endswith(suffix):
                stem = stem[:-len(suffix)]
        args = (str(self.checkpoint_dir / stem), *host)
        if self.config.async_checkpoint:
            if self._ckpt_pool is None:
                self._ckpt_pool = ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix="ckpt-writer")
            # submit first, reap after: an earlier failure must not stop
            # this write
            self._ckpt_futures.append(self._ckpt_pool.submit(self._write_checkpoints, *args))
            self._reap_ckpt_errors(wait=False)
        else:
            self._write_checkpoints(*args)
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
        history, the scheduler, and from a ``.fckpt`` the loss's frozen
        params) or, with ``weights_only``, the model weights alone and a
        fresh EMA (a new stage). The format is told by content: a
        ``torch.save`` zip file, or a ``.fckpt`` (flax msgpack) of either
        package, whose optax state `ckpt.optax_state` maps onto this
        trainer's optimisers (a tree of other settings raises, naming the
        path). The EMA follows this trainer's setting: dropped when off,
        started from the loaded weights when the file has none."""
        self.flush_checkpoints()  # the file may still be in the write queue
        with self.whole_state():  # whole leaves to load into; sliced again after
            self._load_checkpoint(path, weights_only)

    def _load_checkpoint(self, path: str, weights_only: bool) -> None:
        with open(path, "rb") as f:
            head = f.read(4)
        if fckpt.is_fckpt(head):
            tree, meta = fckpt.load_checkpoint(path)
            if "params" not in tree:
                raise ValueError(f"{path}: no 'params' in the checkpoint tree")
            mtype = {"lite": "custom"}.get(meta.get("model_type"), meta.get("model_type"))
            mtype = mtype or self.model_type
            if mtype != self.model_type:
                raise ValueError(f"{path} holds a {mtype!r} model; this trainer trains "
                                 f"a {self.model_type!r} one")
            sd = state_dict_from_jax(fckpt.prepare_params(tree["params"], mtype), mtype)
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
            self._replicate_state()
            print(f"Loaded model weights from epoch {epoch} (fine-tuning mode)")
            print(f"  Starting fresh with LR={self.config.learning_rate}")
            return
        if fckpt.is_fckpt(head):
            self._resume_fckpt(tree, meta, path)
        else:
            self._resume_pth(ckpt)
            meta = ckpt
        # the restored state carries the checkpoint's LR: mark ours unknown
        # so the first epoch writes the schedule's
        self.current_lr = None
        self.current_epoch = meta["epoch"] + 1
        self.global_step = meta["global_step"]
        self.best_metric = meta["best_metric"]
        self.training_history = meta["training_history"]
        for k in self._history_keys():  # a checkpoint of another trainer may lack some
            self.training_history.setdefault(k, [])
        if self.plateau is not None and meta.get("scheduler_state"):
            self.plateau.load_state_dict(meta["scheduler_state"])
        self._replicate_state()
        print(f"Loaded checkpoint from epoch {meta['epoch'] + 1}")

    def _resume_pth(self, ckpt: Dict[str, Any]) -> None:
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

    def _resume_fckpt(self, tree: Dict[str, Any], meta: Dict[str, Any], path: str) -> None:
        """The rest of a full resume from a ``.fckpt`` (the JAX Trainer's
        ``load_checkpoint``): optimiser, EMA, loss params and D; a non-GAN
        file into a GAN trainer restores the generator side only."""
        missing = [k for k in fckpt.TRAIN_STATE_FIELDS if k not in tree]
        if missing:
            raise ValueError(f"{path}: not a trainer checkpoint (no {missing} in its tree)")
        mtype = self.model_type
        model_sd = self.model.state_dict()
        labels = ox.stage_labels(self.optimizer, self.state.opt_state, model_sd, mtype)
        self.state.opt_state = ox.port_state_from_optax(
            self.optimizer, tree["opt_state"], self.state.opt_state, mtype, model_sd, labels,
            where=f"{path}: opt_state")
        if not self.use_ema:
            self.state.ema_params = None
        elif tree["ema_params"] is None:  # EMA turned on at resume: start from the weights
            self.state.ema_params = init_ema(self.model)
        else:
            ema = state_dict_from_jax(fckpt.prepare_params(tree["ema_params"], mtype), mtype)
            self.state.ema_params = _to_device(ema, self.state.ema_params, self.device,
                                               "ema_params")
        gan_file = bool(meta.get("use_gan", False))
        if self.use_gan and not gan_file:
            print("  Checkpoint has no discriminator state; D starts fresh")
        else:
            self._load_loss_params(tree["loss_params"], path)
        if self.use_gan and gan_file:
            d_params = fckpt.restore_list_nodes(tree["d_params"])
            d_stats = fckpt.restore_list_nodes(tree["d_stats"])
            with torch.no_grad():
                self.disc.load_state_dict(discriminator_state_dict_from_jax(d_params, d_stats),
                                          strict=True)
            d_named = {k: v for k, v in self.disc.state_dict().items() if ".running_" not in k}
            self.state.d_opt_state = ox.port_state_from_optax(
                self.d_optimizer, tree["d_opt_state"], self.state.d_opt_state, "disc", d_named,
                where=f"{path}: d_opt_state")
        self.state.step = int(tree["step"])

    def _load_loss_params(self, loss_tree: Any, path: str) -> None:
        """The loss's frozen params from a ``.fckpt`` (each package seeds its
        own VGG without pretrained weights: the file's are the run's)."""
        ours = self.loss_fn.params
        if set(loss_tree) != set(ours):
            raise ValueError(f"{path}: loss_params holds {sorted(loss_tree)}, this trainer's "
                             f"loss {sorted(ours)} (perceptual weight on in one only?)")
        if "vgg" not in ours:
            return
        vgg = vgg_params_from_jax(fckpt.restore_list_nodes(loss_tree["vgg"]))
        if len(vgg) != len(ours["vgg"]):
            raise ValueError(f"{path}: loss_params holds {len(vgg)} VGG convs, this "
                             f"trainer's loss {len(ours['vgg'])}")
        with torch.no_grad():
            for mine, theirs in zip(ours["vgg"], vgg):
                for k in ("w", "b"):
                    if mine[k].shape != theirs[k].shape:
                        raise ValueError(f"{path}: loss_params VGG shape {tuple(theirs[k].shape)}"
                                         f" vs {tuple(mine[k].shape)}")
                    mine[k].copy_(theirs[k])
        self._loss_tree = None


def overfit_test(model, dataloader, loss_fn=None, num_images: int = 10,
                 num_iterations: int = 1000, learning_rate: float = 2e-4,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Overfit ``num_images`` HR crops of the loader's first batch with pure
    MSE on the clamped output (``loss_fn`` is accepted and unused, as in the
    JAX package) and plain Adam; converged iff the final PSNR > 35 dB. The
    loss is read every 50 iterations and at the last. Under a ``mesh`` with
    a group the crops are padded by repetition to a multiple of the data
    axis (as the JAX package pads them to its devices), each rank trains on
    its rows (on a grid, its image rows of them), and the gradients and the
    loss are means over the ranks."""
    from facesr_torch.ops.conv import full_f32
    from facesr_torch.ops.resize import bicubic_down

    print(f"\nOverfitting test on {num_images} images...")
    dp = _dp(mesh)
    shard = None if dp is None else dp.row_shard()
    dev = mesh.device if mesh is not None else resolve_device(device)
    model = model.to(dev)
    hr = np.asarray(next(iter(dataloader))["hr"][:num_images], dtype=np.float32)
    if dp is not None:
        replicate(model, dp)
        hr = shard_batch(pad_to_multiple(hr, dp.data_size)[0], dp)
    hr = torch.from_numpy(np.ascontiguousarray(hr)).to(dev)
    scale = getattr(model.config, "scale_factor", getattr(model.config, "scale", 4))
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=learning_rate, eps=1e-8, foreach=False)
    losses, psnrs = [], []
    for i in range(num_iterations):
        with full_f32(), spatial.rows(shard):
            lr, target = _slabs(shard, bicubic_down(hr, scale), hr)
            sr = model(lr, train=True).clamp(0.0, 1.0)
            mse = spatial.mean((sr - target) ** 2)
            opt.zero_grad(set_to_none=True)
            mse.backward()
        for p, g in zip(params, _reduced([p.grad for p in params], dp)):
            p.grad = g
        mse = _mean_metrics({"mse": mse.detach()}, dp)["mse"]
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
