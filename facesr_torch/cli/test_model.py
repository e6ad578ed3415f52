"""Evaluation CLI of the port (single image or directory), with the flags
of the JAX package's `scripts/test_model.py`:

    python -m facesr_torch.cli.test_model --checkpoint checkpoints/best_model.pth \\
        --input data/processed/test/HR --output outputs/test [--device cpu]

LR synthesis is the trainer's (PyTorch-parity bicubic x1/scale on the
device); metrics are skimage-compatible PSNR/SSIM on uint8 images at
data_range 255; a bicubic baseline (the port's copy of cv2's
``INTER_CUBIC``) is reported beside the model. It runs on one CUDA card
unless ``--device cpu`` is given and raises when there is no card and no
``--device``. ``--checkpoint`` takes a JAX ``.fckpt`` (EMA weights when
it has them) or a ``.pth`` of FaceEnhanceNet, the transfer model or
RRDBNet (`models.load.load_any_model`); ``--config`` overrides a
FaceEnhanceNet's architecture only, as in the JAX CLI.
``--exported`` evaluates a ``.pt2`` serving artifact
(`cli.export_serving`) in place of a checkpoint: the deployed program,
batched straight through its symbolic batch. Images are PNG, JPEG, BMP or
TIFF files, read bitwise as cv2 reads them (`data.codecs`); a corrupt file
raises with its name.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["main", "run", "parse_args", "load_model", "compute_metrics", "generate_lr"]

EVAL_CHUNK = 256  # images decoded and scored at a time on the batched path


def load_model(checkpoint_path: str, config_yaml: Optional[str] = None, device=None):
    """The model of a ``.fckpt`` or a ``.pth`` (`models.load.load_any_model`,
    EMA weights preferred), on ``device``.

    ``config_yaml``: the ``model.custom`` section of a training YAML (or a
    bare mapping) overrides the architecture, as ``--config`` does in the
    JAX CLI."""
    from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig
    from facesr_torch.models.load import load_any_model

    if not Path(checkpoint_path).exists():
        sys.exit(f"Error: checkpoint not found: {checkpoint_path}")
    model = load_any_model(checkpoint_path)
    if config_yaml:
        from facesr_torch.yaml_lite import load_file

        y = load_file(config_yaml) or {}
        section = (y.get("model", {}) or {}).get("custom", y)
        known = {k: v for k, v in section.items() if k in FaceEnhanceNetConfig.__dataclass_fields__}
        if "upscale_factor" in section:  # the reference YAML's spelling
            known["scale_factor"] = section["upscale_factor"]
        if known:
            sd = model.state_dict()
            model = FaceEnhanceNet(FaceEnhanceNetConfig(**known), device="cpu").eval()
            model.load_state_dict(sd, strict=True)
    print(f"Loaded model: {type(model).__name__} ({model.config})")
    return model.to(device) if device is not None else model


def generate_lr(hr_uint8: np.ndarray, scale: int, device) -> np.ndarray:
    """Trainer-matched LR synthesis of one image: float [0, 1],
    PyTorch-parity bicubic downsample on ``device``."""
    from facesr_torch.evaluation.batched import synthesize_lr_batched

    return synthesize_lr_batched([hr_uint8], scale, device=device)[0]


def compute_metrics(sr_uint8: np.ndarray, hr_uint8: np.ndarray) -> dict:
    """skimage-compatible PSNR/SSIM at data_range=255."""
    from facesr_torch.evaluation.skimage_compat import (peak_signal_noise_ratio,
                                                        structural_similarity)

    return {"psnr": peak_signal_noise_ratio(hr_uint8, sr_uint8, data_range=255),
            "ssim": structural_similarity(hr_uint8, sr_uint8, data_range=255, channel_axis=-1)}


def _score(path: Path, hr: np.ndarray, lr: np.ndarray, sr_uint8: np.ndarray,
           output_dir: Optional[Path], save_comparison: bool) -> dict:
    """Metrics of one image and its bicubic baseline; writes the SR and the
    comparison strip (LR nearest, bicubic, SR, HR) when ``output_dir``."""
    from facesr_torch.data.cv_compat import resize_cubic, resize_nearest
    from facesr_torch.data.png import write_png
    from facesr_torch.evaluation.batched import to_uint8

    lr_uint8 = to_uint8(lr)
    size = (hr.shape[1], hr.shape[0])
    bicubic = resize_cubic(lr_uint8, size)
    r = {"model": compute_metrics(sr_uint8, hr), "bicubic": compute_metrics(bicubic, hr),
         "file": path.name}
    if output_dir is not None:
        write_png(output_dir / f"{path.stem}_sr.png", sr_uint8)
        if save_comparison:
            strip = np.hstack([resize_nearest(lr_uint8, size), bicubic, sr_uint8, hr])
            write_png(output_dir / f"{path.stem}_comparison.png", strip)
    return r


def _print_row(r: dict) -> None:
    print(f"{r['file']}: model PSNR {r['model']['psnr']:.2f} dB "
          f"SSIM {r['model']['ssim']:.4f} | bicubic PSNR "
          f"{r['bicubic']['psnr']:.2f} dB SSIM {r['bicubic']['ssim']:.4f}")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Test Face Super-Resolution Model "
                                                 "(PyTorch port)")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--exported", type=str, default=None,
                        help="evaluate a .pt2 serving artifact "
                             "(python -m facesr_torch.cli.export_serving) instead of a "
                             "checkpoint; its input size must be the LR size (HR / scale)")
    parser.add_argument("--config", type=str, default=None,
                        help="Explicit model config YAML override")
    parser.add_argument("--input", "--image", "--hr-dir", dest="input", type=str,
                        required=True, help="HR image file or directory")
    parser.add_argument("--output", "--output-dir", dest="output", type=str,
                        default="outputs/test_results")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--max-images", "--num-images", dest="max_images", type=int,
                        default=None)
    parser.add_argument("--no-comparison", action="store_true")
    parser.add_argument("--no-save", action="store_true",
                        help="Do not save output images (metrics only)")
    parser.add_argument("--per-image", action="store_true",
                        help="Batch-1 forwards instead of the batched path")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="Forward batch of the batched path (128 on CUDA, 8 on the CPU)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when omitted (raises without a card)")
    return parser.parse_args(argv)


def run(argv: Optional[List[str]] = None) -> List[dict]:
    """Parse ``argv``, evaluate, print the table; returns the per-image
    rows."""
    args = parse_args(argv)
    if not args.checkpoint and not args.exported:
        raise SystemExit("one of --checkpoint / --exported is required")

    from facesr_torch.data.codecs import imread
    from facesr_torch.data.dataset import _list_images
    from facesr_torch.device import resolve_device
    from facesr_torch.evaluation.batched import (make_predictor, sr_batched,
                                                 synthesize_lr_batched, to_uint8)

    device = resolve_device(args.device)
    artifact = model = None
    if args.exported:
        from facesr_torch.ckpt.export import load_exported

        art_fn = load_exported(args.exported, device=device)
        artifact = lambda b: np.clip(art_fn(b), 0, 1)  # noqa: E731
        print(f"Evaluating exported artifact {args.exported}")
    else:
        model = load_model(args.checkpoint, config_yaml=args.config, device=device)
    input_path = Path(args.input)
    output_dir = Path(args.output)

    files = [input_path] if input_path.is_file() else _list_images(input_path)
    if args.max_images:
        files = files[: args.max_images]
    if not files:
        print(f"No images found at {input_path}")
        return []

    print(f"\nTesting on {len(files)} image(s)...\n")
    save_dir = None if args.no_save else output_dir
    if save_dir is not None:
        save_dir.mkdir(parents=True, exist_ok=True)
    results = []
    if args.per_image or len(files) == 1:
        import torch

        for f in files:
            hr = imread(f)
            lr = generate_lr(hr, args.scale, device)
            if artifact is not None:
                sr = artifact(lr[None])[0]
            else:
                with torch.inference_mode():
                    sr = model(torch.from_numpy(lr[None]).to(device)).cpu().numpy()[0]
            r = _score(f, hr, lr, to_uint8(sr), save_dir, not args.no_comparison)
            results.append(r)
            _print_row(r)
    else:
        # one predictor, chunked forwards per image shape; macro-chunks
        # bound host memory on large directories
        # an artifact batches straight through its symbolic batch; a
        # checkpoint goes through the Predictor
        predictor = (artifact if artifact is not None
                     else make_predictor(model, max_batch=args.batch_size, device=device))
        for start in range(0, len(files), EVAL_CHUNK):
            chunk_files = files[start:start + EVAL_CHUNK]
            hrs = [imread(f) for f in chunk_files]
            lrs = synthesize_lr_batched(hrs, args.scale, device=device)
            srs = sr_batched(None, lrs, predictor=predictor)
            for f, hr, lr, sr in zip(chunk_files, hrs, lrs, srs):
                r = _score(f, hr, lr, sr, save_dir, not args.no_comparison)
                results.append(r)
                _print_row(r)

    m_psnr = np.mean([r["model"]["psnr"] for r in results])
    m_ssim = np.mean([r["model"]["ssim"] for r in results])
    b_psnr = np.mean([r["bicubic"]["psnr"] for r in results])
    b_ssim = np.mean([r["bicubic"]["ssim"] for r in results])
    print("\n" + "=" * 60)
    print(f"{'Method':<12} {'PSNR (dB)':<12} {'SSIM':<10}")
    print("-" * 60)
    print(f"{'Bicubic':<12} {b_psnr:<12.2f} {b_ssim:<10.4f}")
    print(f"{'Model':<12} {m_psnr:<12.2f} {m_ssim:<10.4f}")
    print("-" * 60)
    print(f"vs bicubic: {m_psnr - b_psnr:+.2f} dB PSNR, {m_ssim - b_ssim:+.4f} SSIM")
    print("=" * 60)
    if not args.no_save:
        print(f"\nResults saved to {output_dir}")
    return results


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
