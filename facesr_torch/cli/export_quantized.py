"""Export a calibrated int8 serving artifact (a quant cache) from a
checkpoint, with the flags of the JAX package's `scripts/export_quantized.py`:

    python -m facesr_torch.cli.export_quantized --checkpoint checkpoints/best_model.pth \\
        --calib-dir data/processed/val/HR --calib-hr \\
        --output quant/int8.best_model.fckpt [--device cpu]
    python -m facesr_torch.app.api --checkpoint-dir checkpoints --dtype int8_full \\
        --quant-cache quant/int8

Quantizes the model's conv kernels (per-output-channel int8), calibrates
static activation scales on the ``--calib-dir`` images (or, with
``--calib-hr``, on LR made from them with the trainer's bicubic x1/scale,
`ops.resize.bicubic_down`, on the device) and writes the calibrated tree
with `parallel.serving.calibrated_qparams`: the ``.fckpt`` that
``Predictor(..., dtype="int8_full", quant_cache=...)``, the API's
``--quant-cache`` and the JAX package's loaders read. The API derives its
cache name as ``<prefix>.<model name>.fckpt``, the model name being the
checkpoint's stem lowercased. Calibration goes to a temporary file that
replaces the output only on success. PNG only (JPEG is ROADMAP A.7.2).
Runs on CUDA unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Export calibrated int8 serving params "
                                                 "(PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--calib-dir", type=str, required=True,
                        help="directory of calibration images; with --calib-hr they are "
                             "HR and LR is made with the trainer's bicubic")
    parser.add_argument("--calib-hr", action="store_true",
                        help="treat --calib-dir images as HR and synthesize LR "
                             "(x1/scale bicubic, the trainer's pipeline)")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--num-images", type=int, default=32)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when omitted (raises without a card)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    from facesr_torch.data.dataset import _list_images
    from facesr_torch.data.png import PNGError, read_rgb
    from facesr_torch.device import resolve_device
    from facesr_torch.models.load import load_any_model
    from facesr_torch.ops.resize import bicubic_down
    from facesr_torch.parallel.serving import calibrated_qparams

    args = parse_args(argv)
    device = resolve_device(args.device)
    model = load_any_model(args.checkpoint, device=device)

    calib_dir = Path(args.calib_dir)
    paths = (_list_images(calib_dir) if calib_dir.is_dir() else [])[:args.num_images]
    if not paths:
        raise SystemExit(f"No images found in {args.calib_dir}")
    imgs = []
    for p in paths:
        try:
            imgs.append(read_rgb(p).astype(np.float32) / 255.0)
        except (PNGError, OSError) as e:
            print(f"Skipping {p.name}: {e}")
    if not imgs:
        raise SystemExit(f"No readable images in {args.calib_dir} "
                         f"({len(paths)} files found, none decoded)")
    imgs = [i for i in imgs if i.shape == imgs[0].shape]  # one uniform batch
    calib = np.stack(imgs)
    if args.calib_hr:
        with torch.inference_mode():
            calib = bicubic_down(torch.from_numpy(calib).to(device), args.scale).cpu().numpy()
    print(f"Calibrating on {len(calib)} images ({calib.shape[1]}x{calib.shape[2]} LR)...")

    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    # calibrate into a temporary name and move it over the output only on
    # success: an existing cache_path is a cache hit for calibrated_qparams,
    # and a failed run must not destroy a good artifact
    tmp = out.with_name(out.name + ".tmp")
    if tmp.exists():
        tmp.unlink()
    try:
        calibrated_qparams(model, calib, max_batch=max(len(calib), 1), cache_path=str(tmp))
        if out.exists():
            print(f"Replacing existing artifact {out}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    print(f"Wrote calibrated int8 tree to {args.output} ({out.stat().st_size / 1e6:.1f} MB)")
    stem = Path(args.checkpoint).stem.lower().replace(" ", "_")
    print(f"Serve with: python -m facesr_torch.app.api --checkpoint-dir <dir> --dtype "
          f"int8_full --quant-cache <prefix>  (the api loads <prefix>.{stem}.fckpt for this "
          f"checkpoint), or Predictor(model, dtype='int8_full', quant_cache={args.output!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
