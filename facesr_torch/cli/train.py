"""Training CLI of the port, with the flags of the JAX package's
`scripts/train.py`:

    python -m facesr_torch.cli.train --config configs/stages/stage1_psnr_config.yaml
    python -m facesr_torch.cli.train --config configs/stages/stage2_ssim_config.yaml
    python -m facesr_torch.cli.train --config configs/stages/stage3_gan_config.yaml

CLI flags override the YAML, which overrides the coded defaults. It trains
on one CUDA card unless ``--device cpu`` is given, and raises when there
is no card and no ``--device``. Images are PNG files under ``data_root``
(``train/HR`` with or without ``train/LR``, ``val/HR`` + ``val/LR``).

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

What is not ported raises and names its ROADMAP item: mesh axes other
than ``data``, ``--mesh-shape``,
``pp_microbatches`` and ``--print-memory`` (A.13), the gradient monitor
(A.14). W&B is not ported and stays off. The perceptual loss uses a VGG19
with random weights drawn from seed 0 (no pretrained file is in the repo).
SIGTERM saves ``interrupted.pth`` and ``interrupted.fckpt`` before the
process exits.
"""

from __future__ import annotations

import argparse
import signal
import sys
from pathlib import Path
from typing import List, Optional

from facesr_torch.config import load_config, set_seed

__all__ = ["main", "run", "parse_args", "make_loaders", "create_model", "resolve_chain_path",
           "NotPorted"]


class NotPorted(NotImplementedError):
    pass


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


def _refuse_unported(args, config: dict, model_type: str) -> None:
    training = config.get("training", {})
    logging_config = config.get("logging", {})
    mesh_axes = args.mesh_axes or training.get("mesh_axes", "data")
    if mesh_axes != "data" or args.mesh_shape or training.get("mesh_shape") \
            or training.get("pp_microbatches", 0):
        raise NotPorted(f"mesh_axes={mesh_axes!r}, --mesh-shape / mesh_shape and "
                        "pp_microbatches: the port trains on one card (ROADMAP A.13)")
    if args.print_memory:
        raise NotPorted("--print-memory reports XLA buffer assignment and is not ported "
                        "(ROADMAP A.13)")
    if logging_config.get("log_gradients_every", 0):
        raise NotPorted("logging.log_gradients_every: the gradient monitor is not ported "
                        "yet (ROADMAP A.14)")


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
    parser.add_argument("--mesh-axes", type=str, default=None)
    parser.add_argument("--mesh-shape", type=str, default=None)
    parser.add_argument("--print-memory", action="store_true")
    parser.add_argument("--fast-loader", action="store_true",
                        help="Use the native (C++) HR-only batch assembler for the "
                             "training loader (LR is made on the device anyway)")
    return parser.parse_args(argv)


def make_loaders(args: argparse.Namespace, config: dict, data_root: str, batch_size: int,
                 seed: int):
    """(train loader, val loader) as the JAX CLI builds them: the threaded
    `get_dataloader` with the effective augmentation, or with
    ``--fast-loader`` the native HR-only `FastHRLoader` (crop and flip
    only)."""
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
                                    num_workers=num_workers, seed=seed)
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
                                      seed=seed, **eff_aug)
    val_loader = get_dataloader(data_root, mode="val", batch_size=batch_size,
                                num_workers=num_workers, seed=seed)
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
    _refuse_unported(args, config, model_type)

    import torch

    from facesr_torch.device import resolve_device

    device = resolve_device(args.device)
    seed = project_config.get("seed", 42)
    set_seed(seed)

    batch_size = (args.batch_size if args.batch_size is not None
                  else data_config.get("batch_size", 16))
    epochs = args.epochs if args.epochs is not None else training_config.get("epochs", 50)
    lr = args.lr if args.lr is not None else training_config.get("optimizer", {}).get("lr", 1e-4)
    data_root = args.data_root or data_config.get("data_root", "data/processed")

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"\n{'=' * 60}")
    print("Face Super-Resolution Training (PyTorch port)")
    print(f"{'=' * 60}")
    print(f"Model: {model_type}")
    print(f"Epochs: {epochs}")
    print(f"Batch size: {batch_size}")
    print(f"Learning rate: {lr}")
    print(f"Device: {device} ({name})")
    print(f"Data root: {data_root}")
    print(f"{'=' * 60}\n")

    from facesr_torch.losses.combined import create_loss_function
    from facesr_torch.training.trainer import Trainer, TrainerConfig, overfit_test

    print("Creating data loaders...")
    train_loader, val_loader = make_loaders(args, config, data_root, batch_size, seed)
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
                               num_iterations=1000, device=device)
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
                      discriminator=discriminator)

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

    print("\n" + "=" * 60)
    print("Starting training...")
    print("=" * 60 + "\n")

    def _sigterm(_signum, _frame):
        raise KeyboardInterrupt("SIGTERM")

    prev_sigterm = signal.signal(signal.SIGTERM, _sigterm)
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
        trainer.save_checkpoint("interrupted")
        trainer.flush_checkpoints()
        print(f"Checkpoint saved to {trainer_config.checkpoint_dir}/interrupted.pth "
              "(and .fckpt)")
    finally:
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
    return trainer


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
