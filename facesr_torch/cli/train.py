"""Training CLI of the port, with the flags of the JAX package's
`scripts/train.py`:

    python -m facesr_torch.cli.train --config configs/stages/stage1_psnr_config.yaml
    python -m facesr_torch.cli.train --config configs/stages/stage2_ssim_config.yaml
    python -m facesr_torch.cli.train --config configs/stages/stage3_gan_config.yaml

CLI flags override the YAML, which overrides the coded defaults. It trains
on CUDA unless ``--device cpu`` is given, and raises when there is no card
and no ``--device``. Images are PNG files under ``data_root``
(``train/HR`` with or without ``train/LR``, ``val/HR`` + ``val/LR``).

Data parallelism (``mesh_axes: data``, the default), as the JAX CLI runs
over every visible chip: under torchrun (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` set) each process joins
that group, one rank a card (``cuda:<LOCAL_RANK>``; NCCL, or gloo with
``--device cpu``); a plain launch on a host with N > 1 visible cards
starts the N ranks itself (`parallel.launch.run_cli_ranks`). The YAML's
``batch_size`` is the global batch: each rank loads ``batch_size / N``
rows of its own slice of the shuffled order (a remainder is trimmed with
the JAX warning), and only rank 0 writes checkpoints.

Spatial parallelism on top (``--mesh-axes data,space --mesh-shape d,s``,
or ``training.mesh_axes``/``mesh_shape`` in the YAML): d * s ranks in a
grid, the s ranks of each `space` group loading the same ``batch_size / d``
rows of their data coordinate's slice and splitting the image rows
(`parallel.spatial`), for every stage, the GAN stage and QAT included; a
plain launch starts the d * s ranks itself. On CUDA it refuses more ranks
than visible cards unless ``--dist-backend gloo`` lets them share the
cards (NCCL takes one rank a card); under torchrun the same holds for the
ranks of one host. Tensor parallelism the same way (``--mesh-axes
data,model --mesh-shape d,t``): d * t ranks, the t ranks of each `model`
group loading the same rows and holding their slices of the conv output
channels and of the training state (`parallel.tensor`); rank 0 writes the
checkpoints whole. ``--print-memory``
prints each rank's memory budget of the train step (the state's and the
batch's bytes, and on a card the peak of one step, run once) at the
effective batch, after any checkpoint load and ``--qat-scales`` pinning.

Stage chaining: a ``checkpoint.resume`` path in the YAML loads weights only
(a new stage); ``--resume`` is a full resume unless ``--fine-tune``, from
a ``.pth`` or a ``.fckpt`` of either package (the JAX Trainer's optax
state is mapped onto the port's optimiser). The Trainer writes each
checkpoint as ``.pth`` and ``.fckpt``, so the stage YAMLs'
``best_model.fckpt`` finds the port's own file; for a run folder holding
only ``best_model.pth`` (written before the port wrote ``.fckpt``), that
is loaded in its place and both names are printed.

A ``loss.gan.weight > 0`` (stage 3) trains with the VGG-style
discriminator sized for the training HR crop (``hr_patch_size``), with
``loss.gan``'s ``d_channels`` and ``d_use_bn``; the other ``loss.gan``
fields set the adversarial term and D's optimiser.

``training.qat: true`` trains with every int8 serving site fake-quantized
(QAT; checkpoints keep the float weights). ``--qat-scales <quant cache>``
(`cli.export_quantized`'s artifact) pins its activation grid to the
cache's static scales; it needs ``training.qat`` and is checked against
the weights training starts from, after any checkpoint load, where a
weights mismatch is a note (QAT moves the weights away from the
calibration source on purpose).

``--model transfer`` (or ``model.type: transfer``, as
``configs/transfer_config.yaml`` sets) trains the transfer model of the
``model.transfer`` section in stage 1 (head only; the backbone from
``pretrained_path`` when it names one); ``--model esrgan`` trains the
RRDBNet of `ESRGANBaseline`, its weights resolved from
``checkpoints/pretrained/`` (local files only; random when absent).

QAT covers the model zoo too: every int8 site of the tree trains
fake-quantized, frozen transfer parameters included (their forward is
what serving quantizes), and the stage optimiser still updates only what
the stage trains.

What is not ported raises and names its ROADMAP item: the mesh axis
``pp`` with ``pp_microbatches`` (A.13.4), three mesh axes (A.13.5), the
gradient monitor (A.14); ``model`` with ``pp`` and tp over more than one
host are refused as JAX refuses them. W&B is not ported and stays
off. The perceptual loss uses a VGG19 with random weights drawn from seed
0 (no pretrained file is in the repo).
SIGTERM saves ``interrupted.pth`` and ``interrupted.fckpt`` before the
process exits. Under ``data,model`` SIGTERM and SIGINT to any rank stop
every rank at the end of the step that is running, where they gather the
state for that save together.
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import sys
from pathlib import Path
from typing import List, Optional, Tuple

from facesr_torch.config import load_config, set_seed
from facesr_torch.parallel.mesh import ROADMAP_ITEMS, NotPorted, check_mesh_axes

__all__ = ["main", "run", "parse_args", "make_loaders", "create_model", "resolve_chain_path",
           "NotPorted"]


def create_model(model_type: str, config: dict, seed: int = 0):
    """The model of the config's ``model`` section, on the CPU (the JAX
    CLI's factory): ``custom``, ``transfer`` or ``esrgan``."""
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig

    if model_type == "transfer":
        from facesr_torch.models.transfer import create_transfer_model

        tc = config.get("model", {}).get("transfer", {})
        return create_transfer_model(pretrained_path=tc.get("pretrained_path"),
                                     backbone_blocks=tc.get("backbone_blocks", 16),
                                     freeze_blocks=tc.get("freeze_blocks", 16),
                                     head_blocks=tc.get("head_blocks", 4),
                                     head_channels=tc.get("head_channels", 64),
                                     scale_factor=tc.get("scale_factor", 4),
                                     seed=seed, device="cpu")
    if model_type == "esrgan":
        from facesr_torch.models.esrgan import create_esrgan_baseline

        return create_esrgan_baseline(seed=seed, device="cpu")
    if model_type != "custom":
        raise ValueError(f"Unknown model type: {model_type}")
    mc = config.get("model", {}).get("custom", {})
    cfg = FaceEnhanceNetConfig(num_channels=mc.get("num_channels", 64),
                               num_groups=mc.get("num_groups", 3),
                               blocks_per_group=mc.get("blocks_per_group", 4),
                               reduction_ratio=mc.get("reduction_ratio", 4),
                               scale_factor=mc.get("upscale_factor", 4),
                               res_scale=mc.get("res_scale", 0.2))
    return FaceEnhanceNet(cfg, seed=seed, device="cpu")


def resolve_chain_path(path: str) -> str:
    """The file a ``checkpoint.resume`` path loads: the path itself, or, for
    a missing ``X.fckpt`` with ``X.pth`` beside it, ``X.pth``. Raises
    SystemExit when neither exists."""
    p = Path(path)
    if p.exists():
        return path
    if p.suffix == ".fckpt" and p.with_suffix(".pth").exists():
        pth = str(p.with_suffix(".pth"))
        print(f"checkpoint.resume {path} not found; loading the port's {pth} in its place")
        return pth
    raise SystemExit(f"checkpoint.resume not found: {path}")


def _mesh_settings(args, config: dict):
    """(mesh_axes, mesh_shape) from the CLI over the YAML; raises NotPorted
    for any mesh but the data axis, data,space and data,model."""
    training = config.get("training", {})
    mesh_axes = args.mesh_axes or training.get("mesh_axes", "data")
    mesh_shape = (tuple(int(v) for v in args.mesh_shape.split(",")) if args.mesh_shape
                  else tuple(training["mesh_shape"]) if training.get("mesh_shape") else None)
    axes = [a.strip() for a in mesh_axes.split(",") if a.strip()] or ["data"]
    check_mesh_axes(axes, mesh_shape)
    if len(axes) > 1 and mesh_shape is None:
        raise ValueError("mesh_shape is required with multiple mesh_axes, e.g. "
                         "mesh_shape: [4, 2] for 'data,space' on 8 chips")
    if training.get("pp_microbatches", 0):
        raise NotPorted(f"pp_microbatches: the pp axis is {ROADMAP_ITEMS['pp']}")
    return mesh_axes, mesh_shape


def _refuse_unported(args, config: dict, model_type: str):
    """Raise NotPorted for what the port does not have; returns the mesh
    settings (`_mesh_settings`)."""
    logging_config = config.get("logging", {})
    mesh = _mesh_settings(args, config)
    if logging_config.get("log_gradients_every", 0):
        raise NotPorted("logging.log_gradients_every: the gradient monitor is not ported "
                        "yet (ROADMAP A.14)")
    return mesh


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train Face Super-Resolution Model "
                                                 "(PyTorch port)")
    parser.add_argument("--config", type=str, default="configs/config.yaml")
    parser.add_argument("--model", type=str, default=None,
                        choices=["custom", "transfer", "esrgan"])
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--gradient-clip", type=float, default=None)
    parser.add_argument("--perceptual-weight", type=float, default=None)
    parser.add_argument("--patience", type=int, default=None)
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--fine-tune", action="store_true",
                        help="Fine-tune mode: load weights only, reset optimizer/scheduler")
    parser.add_argument("--overfit-test", action="store_true")
    parser.add_argument("--no-wandb", action="store_true")
    parser.add_argument("--yes", action="store_true",
                        help="Skip interactive prompts (CI / headless runs)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when omitted (raises without a card)")
    parser.add_argument("--platform", type=str, default=None,
                        help="the JAX CLI's spelling: 'cpu' means --device cpu")
    parser.add_argument("--qat-scales", type=str, default=None,
                        help="calibrated int8 artifact (cli.export_quantized) pinning QAT's "
                             "activation grid to the static serving scales "
                             "(training.qat must be on)")
    parser.add_argument("--mesh-axes", type=str, default=None,
                        help="mesh composition: 'data' (data parallel over the ranks) or "
                             "'data,space' (dp x sp: image rows over the ranks of a row)")
    parser.add_argument("--mesh-shape", type=str, default=None,
                        help="the mesh shape: the rank count for 'data', d,s for "
                             "'data,space'")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="the ranks' torch.distributed backend (default: NCCL on a "
                             "card, gloo on the CPU); gloo lets ranks share a card")
    parser.add_argument("--print-memory", action="store_true",
                        help="print each rank's device memory of the train step before "
                             "training (on a card the step runs once to measure its peak)")
    parser.add_argument("--fast-loader", action="store_true",
                        help="Use the native (C++) HR-only batch assembler for the "
                             "training loader (LR is made on the device anyway)")
    return parser.parse_args(argv)


def make_loaders(args: argparse.Namespace, config: dict, data_root: str, batch_size: int,
                 seed: int, shard: Optional[Tuple[int, int]] = None):
    """(train loader, val loader) as the JAX CLI builds them: the threaded
    `get_dataloader` with the effective augmentation, or with
    ``--fast-loader`` the native HR-only `FastHRLoader` (crop and flip
    only). ``shard``: (index, count) of this rank's slice of the order
    along the data axis (default: torch.distributed's rank and world)."""
    index, count = shard if shard is not None else (None, None)
    from facesr_torch.data.dataset import FFHQDataset, get_dataloader
    from facesr_torch.data.fast_loader import FastHRLoader

    data_config = config.get("data", {})
    aug_config = config.get("augmentation", {})
    color_jitter = aug_config.get("color_jitter", {})
    hr_patch = aug_config.get("random_crop", {}).get("hr_patch_size", 128)
    num_workers = data_config.get("num_workers", 4)
    if args.fast_loader:
        from facesr_torch import native

        native.load("batch_assembler")  # a failed build raises here
        print("Fast loader: native assembler built")
        dropped = []
        if color_jitter.get("probability", 0.3) > 0:
            dropped.append(f"color_jitter (p={color_jitter.get('probability', 0.3)})")
        if aug_config.get("random_rotate90", 0.0) > 0:
            dropped.append(f"random_rotate90 (p={aug_config.get('random_rotate90', 0.0)})")
        if dropped:
            print(f"WARNING: --fast-loader drops augmentations: {', '.join(dropped)}. "
                  f"Set augmentation.color_jitter.probability: 0 (and rotate90: 0) "
                  f"in the config to silence this, or drop --fast-loader to keep them.")
        train_dataset = FFHQDataset(data_root, mode="train", hr_patch_size=hr_patch)
        train_loader = FastHRLoader(train_dataset, batch_size=batch_size, crop=hr_patch,
                                    flip_prob=aug_config.get("horizontal_flip", 0.5),
                                    num_workers=num_workers, seed=seed, process_index=index,
                                    process_count=count)
    else:
        eff_aug = dict(
            horizontal_flip=aug_config.get("horizontal_flip", 0.5),
            random_rotate90=aug_config.get("random_rotate90", 0.0),
            color_jitter_prob=color_jitter.get("probability", 0.3),
            brightness=color_jitter.get("brightness", 0.1),
            contrast=color_jitter.get("contrast", 0.1),
            saturation=color_jitter.get("saturation", 0.1),
            hue=color_jitter.get("hue", 0.05),
        )
        print("Effective augmentation: " + ", ".join(f"{k}={v}" for k, v in eff_aug.items()))
        train_loader = get_dataloader(data_root, mode="train", batch_size=batch_size,
                                      num_workers=num_workers, hr_patch_size=hr_patch,
                                      seed=seed, process_index=index, process_count=count,
                                      **eff_aug)
    val_loader = get_dataloader(data_root, mode="val", batch_size=batch_size,
                                num_workers=num_workers, seed=seed, process_index=index,
                                process_count=count)
    return train_loader, val_loader


def run(argv: Optional[List[str]] = None):
    """Parse ``argv``, build and train; returns the `Trainer` (None when an
    overfit test stops the run)."""
    args = parse_args(argv)
    if args.platform and not args.device:
        args.device = args.platform

    config = {}
    if Path(args.config).exists():
        config = load_config(args.config)
        print(f"Loaded config from {args.config}")
    elif args.config != "configs/config.yaml":
        raise SystemExit(f"Config not found: {args.config}")

    project_config = config.get("project", {})
    data_config = config.get("data", {})
    training_config = config.get("training", {})
    loss_config = config.get("loss", {})
    checkpoint_config = config.get("checkpoint", {})
    logging_config = config.get("logging", {})
    model_type = args.model or config.get("model", {}).get("type", "custom")
    mesh_axes, mesh_shape = _refuse_unported(args, config, model_type)

    import torch

    from facesr_torch.device import resolve_device
    from facesr_torch.parallel.mesh import Mesh, get_mesh
    from facesr_torch.training.trainer import local_batch_size

    axes = tuple(a.strip() for a in mesh_axes.split(",") if a.strip())
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:  # a rank of torchrun's (or run_cli_ranks') group
        mesh = get_mesh(devices=None if args.device is None else [device], axis_names=axes,
                        shape=mesh_shape, backend=args.dist_backend)
        device = mesh.device
        print(f"Data parallel: rank {mesh.rank} of {mesh.world_size} on {device}"
              + (f", at {(mesh.axis_index(axes[0]), mesh.axis_index(axes[1]))} of the "
                 f"{','.join(axes)} grid {mesh.shape}" if len(axes) > 1 else ""))
    else:
        mesh = Mesh((device,), axis_names=axes, shape=mesh_shape if len(axes) > 1 else None)
    seed = project_config.get("seed", 42)
    set_seed(seed)

    global_batch = (args.batch_size if args.batch_size is not None
                    else data_config.get("batch_size", 16))
    batch_size = local_batch_size(global_batch, mesh.data_size)
    epochs = args.epochs if args.epochs is not None else training_config.get("epochs", 50)
    lr = args.lr if args.lr is not None else training_config.get("optimizer", {}).get("lr", 1e-4)
    data_root = args.data_root or data_config.get("data_root", "data/processed")

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"\n{'=' * 60}")
    print("Face Super-Resolution Training (PyTorch port)")
    print(f"{'=' * 60}")
    print(f"Model: {model_type}")
    print(f"Epochs: {epochs}")
    print(f"Batch size: {global_batch} global, {batch_size} a rank over "
          f"{mesh.data_size} rank(s) of the data axis")
    print(f"Learning rate: {lr}")
    print(f"Device: {device} ({name})")
    print(f"Data root: {data_root}")
    print(f"{'=' * 60}\n")

    from facesr_torch.losses.combined import create_loss_function
    from facesr_torch.training.trainer import Trainer, TrainerConfig, overfit_test

    print("Creating data loaders...")
    train_loader, val_loader = make_loaders(args, config, data_root, batch_size, seed,
                                            shard=(mesh.axis_index("data"), mesh.data_size))
    print(f"Train samples: {len(train_loader.dataset)}")
    print(f"Val samples: {len(val_loader.dataset)}")

    print(f"\nCreating {model_type} model...")
    model = create_model(model_type, config, seed=seed)
    print(f"Model parameters: {model.get_model_info().get('total_params', 'N/A'):,}")

    print("\nCreating loss function...")
    perceptual_weight = (args.perceptual_weight if args.perceptual_weight is not None
                         else loss_config.get("perceptual_weight", 0.01))
    loss_fn = create_loss_function(
        l1_weight=loss_config.get("l1_weight", 1.0),
        perceptual_weight=perceptual_weight,
        ssim_weight=loss_config.get("ssim_weight", 0.1),
        use_charbonnier=loss_config.get("use_charbonnier", False),
        charbonnier_eps=loss_config.get("charbonnier_eps", 1e-3),
        perceptual_layers=loss_config.get("perceptual", {}).get("layers",
                                                                ["conv3_4", "conv4_4"]),
        device=device,
    )
    print(f"Loss weights: {loss_fn.get_weights()}")
    if "perceptual" in loss_fn.weights:
        print("VGG19 perceptual: random weights from seed 0 (no pretrained file in the repo)")

    if args.overfit_test:
        print("\n" + "=" * 60)
        print("Running overfitting test...")
        print("=" * 60)
        results = overfit_test(model, train_loader, loss_fn, num_images=10,
                               num_iterations=1000, device=device, mesh=mesh)
        if not results["converged"]:
            print("\nWarning: Model did not converge on small batch!")
            if not args.yes:
                response = input("Continue with training? [y/N] ")
                if response.lower() != "y":
                    print("Training aborted.")
                    return None

    gradient_clip = (args.gradient_clip if args.gradient_clip is not None
                     else training_config.get("gradient_clip", 1.0))
    early_stopping_config = training_config.get("early_stopping", {})
    patience = (args.patience if args.patience is not None
                else early_stopping_config.get("patience", 10))
    scheduler_config = training_config.get("scheduler", {})
    wandb_config = logging_config.get("wandb", {})
    console_config = logging_config.get("console", {})
    gan_config = loss_config.get("gan", {})
    gan_weight = gan_config.get("weight", 0.0)
    if not args.no_wandb and wandb_config.get("enabled", False):
        print("W&B: logging.wandb.enabled is set, but W&B is not ported (ROADMAP A.14); "
              "it stays off")
    else:
        print("W&B: off")

    trainer_config = TrainerConfig(
        epochs=epochs,
        learning_rate=lr,
        weight_decay=training_config.get("optimizer", {}).get("weight_decay", 0.0),
        gradient_clip=gradient_clip,
        accumulation_steps=training_config.get("accumulation_steps", 1),
        use_amp=training_config.get("mixed_precision", True),
        vgg_remat=training_config.get("vgg_remat", False),
        ema_decay=training_config.get("ema_decay", 0.0),
        scheduler_type=scheduler_config.get("type", "cosine"),
        scheduler_T_max=scheduler_config.get("T_max", epochs),
        scheduler_eta_min=scheduler_config.get("eta_min", 1e-7),
        scheduler_step_size=scheduler_config.get("step_size", 10),
        scheduler_gamma=scheduler_config.get("gamma", 0.5),
        early_stopping_patience=patience,
        early_stopping_metric=early_stopping_config.get("metric", "val_psnr"),
        early_stopping_mode=early_stopping_config.get("mode", "max"),
        checkpoint_dir=checkpoint_config.get("save_dir", "checkpoints"),
        save_every=checkpoint_config.get("save_every", 10),
        save_best=checkpoint_config.get("save_best", True),
        step_log_every=console_config.get("step_log_every", 24),
        scale_factor=data_config.get("scale_factor", 4),
        skip_nonfinite_updates=training_config.get("skip_nonfinite_updates", 0),
        gan_weight=gan_weight,
        gan_type=gan_config.get("type", "vanilla"),
        d_learning_rate=gan_config.get("d_lr", 1e-4),
        d_weight_decay=gan_config.get("d_weight_decay", 0.0),
        d_updates_per_g=gan_config.get("d_updates_per_g", 1),
        gan_start_epoch=gan_config.get("start_epoch", 0),
        qat=training_config.get("qat", False),
        mesh_axes=mesh_axes,
        mesh_shape=mesh_shape,
    )
    if args.qat_scales and not trainer_config.qat:
        raise SystemExit("--qat-scales requires training.qat: true")
    if trainer_config.qat:
        print("QAT: every int8 serving conv site trains fake-quantized")

    discriminator = None
    if gan_weight > 0:
        from facesr_torch.models.discriminator import create_discriminator

        print("\nGAN Training Configuration:")
        print(f"  GAN weight: {gan_weight}, type: {trainer_config.gan_type}")
        print(f"  D LR: {trainer_config.d_learning_rate}, "
              f"D updates/G: {trainer_config.d_updates_per_g}")
        # D sees the training HR crops: size it for them
        hr_patch = config.get("augmentation", {}).get("random_crop", {}).get("hr_patch_size", 128)
        discriminator = create_discriminator(input_size=hr_patch,
                                             base_channels=gan_config.get("d_channels", 64),
                                             use_bn=gan_config.get("d_use_bn", True),
                                             device="cpu")
    trainer = Trainer(model, train_loader, val_loader, loss_fn, trainer_config, device=device,
                      discriminator=discriminator, mesh=mesh)

    # --resume is a full resume (unless --fine-tune); a `resume:` path in the
    # stage YAML chains stages and loads weights only
    if args.resume and not Path(args.resume).exists():
        raise SystemExit(f"--resume checkpoint not found: {args.resume}")
    if args.resume:
        print(f"\nLoading checkpoint from {args.resume}")
        trainer.load_checkpoint(args.resume, weights_only=args.fine_tune)
    elif checkpoint_config.get("resume"):
        path = resolve_chain_path(checkpoint_config["resume"])
        print(f"\nChaining from stage checkpoint {path} (weights only)")
        trainer.load_checkpoint(path, weights_only=True)

    if args.qat_scales:
        # after any load, so the provenance check sees the weights training
        # starts from; a weights mismatch is only a note here
        from facesr_torch.parallel.serving import load_calibrated_qparams

        trainer.set_qat_scales(load_calibrated_qparams(trainer.model, args.qat_scales,
                                                       require_weight_match=False))
        print(f"QAT pinned to calibrated activation scales from {args.qat_scales}")

    if args.print_memory:
        # after any load and --qat-scales pinning: the step it measures is
        # the one training runs, at the batch the ranks load
        effective = batch_size * mesh.data_size
        if effective != global_batch:
            print(f"(--print-memory: reporting on the effective batch {effective}, the "
                  f"ranks' trim/pad of {global_batch})")
        hr_patch = config.get("augmentation", {}).get("random_crop", {}).get("hr_patch_size",
                                                                              128)
        trainer.memory_report(effective, hr_patch)

    print("\n" + "=" * 60)
    print("Starting training...")
    print("=" * 60 + "\n")

    def _sigterm(_signum, _frame):
        raise KeyboardInterrupt("SIGTERM")

    def _at_step_end(signum, _frame):
        trainer.request_stop(signal.Signals(signum).name)

    # under tp the interrupted save gathers the state (a collective), so a
    # signal stops every rank at the end of the same step
    handlers = ({signal.SIGTERM: _at_step_end, signal.SIGINT: _at_step_end}
                if trainer.stops_at_step_boundary else {signal.SIGTERM: _sigterm})
    previous = {s: signal.signal(s, h) for s, h in handlers.items()}
    try:
        history = trainer.train()
        print("\n" + "=" * 60)
        print("Training complete!")
        print("=" * 60)
        print("\nFinal metrics:")
        if history["val_psnr"]:
            print(f"  Best PSNR: {max(history['val_psnr']):.2f} dB")
            print(f"  Best SSIM: {max(history['val_ssim']):.4f}")
    except KeyboardInterrupt as e:
        print(f"\n\nTraining interrupted ({e or 'user'}).")
        print("Saving checkpoint...")
        trainer.save_checkpoint("interrupted")  # the writer's only (tp: all gather)
        trainer.flush_checkpoints()
        if trainer.is_writer:
            print(f"Checkpoint saved to {trainer_config.checkpoint_dir}/interrupted.pth "
                  "(and .fckpt)")
    finally:
        for s, h in previous.items():
            if h is not None:
                signal.signal(s, h)
    return trainer


def _ranks_to_start(argv: Optional[List[str]]) -> int:
    """The ranks a plain launch starts: d * s of a ``mesh_shape`` that asks
    for more than one, else every visible card unless a device is named;
    1 when this process is a rank already. On CUDA a shape of more ranks
    than visible cards is refused unless ``--dist-backend gloo``."""
    import torch

    args = parse_args(argv)
    if "WORLD_SIZE" in os.environ:
        return 1
    config = load_config(args.config) if Path(args.config).exists() else {}
    _, shape = _mesh_settings(args, config)
    device = args.device or args.platform
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if shape is not None and math.prod(shape) > 1:
        ranks = math.prod(shape)
        on_cards = cards and (device is None or torch.device(device).type == "cuda")
        if on_cards and ranks > cards and args.dist_backend != "gloo":
            raise ValueError(f"mesh shape {tuple(shape)} needs {ranks} ranks and {cards} "
                             f"card(s) are visible: a plain launch starts one rank a card "
                             "over NCCL; pass --dist-backend gloo to share the cards")
        return ranks
    if device:
        return 1
    return cards or 1


def main(argv: Optional[List[str]] = None) -> int:
    ranks = _ranks_to_start(argv)
    if ranks > 1:
        from facesr_torch.parallel.launch import run_cli_ranks

        print(f"Starting {ranks} ranks")
        codes = run_cli_ranks("facesr_torch.cli.train",
                              sys.argv[1:] if argv is None else argv, ranks)
        return max(codes, key=abs)
    try:
        run(argv)
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
