"""Export a checkpoint's serving forward to a ``.pt2`` artifact, with the
flags of the JAX package's `scripts/export_serving.py`:

    python -m facesr_torch.cli.export_serving --checkpoint checkpoints/best_model.pth \\
        --output serve/model.pt2 [--dtype bf16|f32|int8|int8_full] [--batch 128] \\
        [--calib-dir data/val/LR | --quant-cache quant/int8.best_model.fckpt] \\
        [--verify] [--device cpu]

One file, weights inside, a symbolic batch by default (`ckpt.export`), for
a FaceEnhanceNet, a transfer model or an RRDBNet. ``--dtype int8`` holds
the conv kernels as int8 and dequantizes them inside the graph;
``int8_full`` runs s8 convs with per-image dynamic scales, or static ones
calibrated on the LR images of ``--calib-dir`` or read from
``--quant-cache`` (`cli.export_quantized`'s file; named but missing, with
no ``--calib-dir``, it raises). The trace runs
on ``--device`` (CUDA unless named) and the artifact is moved to the
serving device when it is loaded. ``--verify`` loads it back and compares
it with the live forward on seeded inputs (tolerance 1e-5 in f32, 1e-2
otherwise, as in JAX). The JAX flag ``--platforms`` has no counterpart: a
``.pt2`` moves to the serving device when loaded.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Export the serving forward with torch.export "
                                            "(PyTorch port)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32", "int8", "int8_full"],
                   help="serving mode (same semantics as the HTTP API)")
    p.add_argument("--batch", type=int, default=None,
                   help="pin the batch dimension (default: symbolic — one artifact serves "
                        "every batch size)")
    p.add_argument("--input-size", type=int, default=64)
    p.add_argument("--calib-dir", default=None,
                   help="with --dtype int8_full: calibrate static activation scales on the LR "
                        "images in this directory")
    p.add_argument("--quant-cache", default=None,
                   help="calibrated-scale artifact to reuse (cli.export_quantized)")
    p.add_argument("--verify", action="store_true",
                   help="load the artifact back and compare it with the live forward")
    p.add_argument("--device", default=None,
                   help="torch device of the trace; CUDA when omitted (raises without a card)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    from facesr_torch.ckpt.export import build_serving_fn, export_built, load_exported
    from facesr_torch.device import resolve_device
    from facesr_torch.models.load import load_any_model
    from facesr_torch.parallel.serving import load_calibration_images

    args = parse_args(argv)
    device = resolve_device(args.device)
    model = load_any_model(args.checkpoint, device=device)
    calibration = load_calibration_images(args.calib_dir) if args.calib_dir else None
    dtype = {"bf16": torch.bfloat16, "f32": None}.get(args.dtype, args.dtype)
    # built once: --verify reuses it (a second build would calibrate again)
    module = build_serving_fn(model, dtype, calibration=calibration,
                              quant_cache=args.quant_cache, max_batch=args.batch or 8)
    blob = export_built(module, batch=args.batch, input_size=args.input_size)
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(blob)
    shape = (args.batch or "b", args.input_size, args.input_size, 3)
    print(f"Exported {args.dtype} serving forward {shape} on {device} -> {out} "
          f"({len(blob) / 1e6:.2f} MB)")
    if args.dtype in ("int8", "int8_full"):
        q_bytes = sum(t.numel() for n, t in module.named_buffers() if t.dtype == torch.int8)
        f_bytes = 4 * sum(p.numel() for p in model.parameters())
        print(f"  int8 sites: {q_bytes / 1e6:.2f} MB of int8 buffers; the model's float "
              f"weights are {f_bytes / 1e6:.2f} MB in f32")
    if args.verify:
        serve = load_exported(blob, device=device)
        x = np.random.default_rng(0).random(
            (args.batch or 2, args.input_size, args.input_size, 3), dtype=np.float32)
        with torch.inference_mode():
            want = module(torch.from_numpy(x).to(device)).float().cpu().numpy()
        err = float(np.max(np.abs(serve(x) - want)))
        tol = 1e-5 if dtype is None else 1e-2
        print(f"verify: max |exported - live| = {err:.2e} on batch {x.shape[0]} "
              f"(tol {tol:.0e}: {'OK' if err < tol else 'MISMATCH'})")
        if err >= tol:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
