"""The serving demo of the port, headless: `app/demo.py`'s interface on
one card or every visible one.

    python -m facesr_torch.app.demo --checkpoint-dir checkpoints \\
        --image face.png --output outputs/demo [--dtype bf16] [--device cpu]

Loads every ``*.fckpt`` and ``*.pth`` in ``--checkpoint-dir`` (and
``--exported`` ``.pt2`` artifacts), enhances one PNG with the first model
and writes the LR input, the bicubic and Lanczos-4 baselines (the port's
copies of cv2's ``INTER_CUBIC`` and ``INTER_LANCZOS4``), the SR image and
the ground truth as PNGs, with PSNR/SSIM (and LPIPS with converted
weights) of each method against the ground truth. The input-size rule is
the reference's: an image of at most 128 px is already LR (resized to 64
with ``INTER_AREA`` when it is not 64x64, no ground truth); a larger one
is centre-cropped to a square, resized to 256 with ``INTER_AREA`` and its
64 px LR synthesised with the trainer's bicubic. ``--dtype bf16`` serves
through `ShardedPredictor` (every visible card; the group-kernel trunk), ``int8`` with int8 weights
dequantized to bf16, ``int8_full`` with s8 convs: static activation
scales calibrated on ``--calib-dir`` images, or loaded from the per-model
quant cache ``<--quant-cache>.<model name>.fckpt`` (written there after a
calibration), else per-image dynamic scales. It runs on CUDA unless
``--device cpu`` is given.

Not ported: the gradio UI and its ``--port``/``--share``/``--sample-dir``
(gradio is not installed, so ``main`` without ``--image`` prints the JAX
demo's message). ``--image`` is read by `data.codecs.imread` (PNG, JPEG,
BMP, TIFF), bitwise cv2's.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from facesr_torch.data.cv_compat import resize_area, resize_cubic, resize_lanczos4
from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.evaluation.batched import to_uint8
from facesr_torch.ops.resize import bicubic_down

__all__ = ["LR_SIZE", "HR_SIZE", "load_models_from_checkpoints", "load_exported_servables",
           "load_servables", "wrap_predictors", "prepare_inputs", "process_image", "serve_batch",
           "create_demo", "main"]

LR_SIZE = 64
HR_SIZE = 256
GRADIO_MESSAGE = "gradio is not installed; use --image for headless mode."


def load_models_from_checkpoints(checkpoint_dir: str = "checkpoints",
                                 device: DeviceLike = None) -> dict:
    """Every ``*.fckpt`` and ``*.pth`` in the directory, keyed by friendly
    name (the stem, underscores to spaces, title case), loaded by
    `models.load.load_any_model` onto ``device`` (CUDA unless named). A
    file that does not load is skipped with its reason, as in JAX; a stem
    present in both formats raises and names both files, unless the two
    are one save of the port's Trainer (`models.load.checkpoint_files`:
    the ``.fckpt`` is loaded)."""
    from facesr_torch.models.load import load_any_model

    from facesr_torch.models.load import checkpoint_files

    dev = resolve_device(device)
    paths = checkpoint_files(checkpoint_dir)
    by_stem: dict = {}
    for path in paths:
        if path.stem in by_stem:
            raise ValueError(f"checkpoint {path.stem!r} exists as both {by_stem[path.stem]} "
                             f"and {path}; keep one")
        by_stem[path.stem] = path
    models = {}
    for path in paths:
        try:
            model = load_any_model(path, device=dev)
        except Exception as e:  # noqa: BLE001 — an unloadable file is skipped, as in JAX
            print(f"Skipping {path}: {e}")
            continue
        name = path.stem.replace("_", " ").title()
        models[name] = model
        print(f"Loaded {name} ({type(model).__name__})")
    return models


def load_exported_servables(exported: str, device: DeviceLike = None,
                            require_symbolic_batch: bool = False) -> dict:
    """``.pt2`` serving artifacts (`cli.export_serving`) keyed by file
    stem, checked at load time (`ckpt.export.load_exported_many`). Each is
    a servable: numpy in, its clipped output as numpy out."""
    from facesr_torch.ckpt.export import load_exported_many

    servables = load_exported_many(exported, spatial=LR_SIZE,
                                   require_symbolic_batch=require_symbolic_batch, device=device)
    for name in servables:
        print(f"Loaded exported artifact {name}")
    return servables


def load_servables(checkpoint_dir: str, dtype: Optional[str] = None,
                   calib_dir: Optional[str] = None, quant_cache: Optional[str] = None,
                   exported: Optional[str] = None, device: DeviceLike = None,
                   require_symbolic_batch: bool = False) -> tuple:
    """(checkpoint models, exported artifacts), the one assembly policy of
    this demo and `app.api.SRService`: an unknown serving dtype raises
    before anything loads; the checkpoint directory is optional when
    artifacts are given; a name in both raises."""
    _check_serving_dtype(dtype)
    artifacts = (load_exported_servables(exported, device, require_symbolic_batch)
                 if exported else {})
    models = (load_models_from_checkpoints(checkpoint_dir, device)
              if not artifacts or Path(checkpoint_dir).exists() else {})
    dup = set(models) & set(artifacts)
    if dup:
        raise ValueError(f"exported artifact name(s) {sorted(dup)} collide with checkpoint "
                         "model names — rename the artifact")
    return models, artifacts


def _assemble_models(checkpoint_dir: str, dtype: Optional[str] = None,
                     calib_dir: Optional[str] = None, quant_cache: Optional[str] = None,
                     exported: Optional[str] = None, device: DeviceLike = None) -> dict:
    """Checkpoints (optional when artifacts are given) -> serving-dtype
    predictors -> exported artifacts, in one dict."""
    models, artifacts = load_servables(checkpoint_dir, dtype, calib_dir, quant_cache,
                                       exported, device)
    return {**wrap_predictors(models, dtype, calib_dir, quant_cache, device=device),
            **artifacts}


SERVING_DTYPES = (None, "f32", "bf16", "int8", "int8_full")


def _check_serving_dtype(dtype: Optional[str]) -> None:
    if dtype not in SERVING_DTYPES:
        raise ValueError(f"unknown serving dtype {dtype!r}; one of f32, bf16, int8, int8_full")


def wrap_predictors(models: dict, dtype: Optional[str] = None,
                    calib_dir: Optional[str] = None, quant_cache: Optional[str] = None,
                    max_batch: int = 8, device: DeviceLike = None) -> dict:
    """Every model through a `ShardedPredictor` when a serving dtype is
    asked for, as the JAX demo and API serve: over every visible card when
    ``device`` is ``cuda`` without an index, else on the model's own
    device (on one device it is `Predictor`): ``bf16`` the group-kernel
    trunk, ``int8`` int8 weights dequantized
    to bf16, ``int8_full`` s8 convs with static scales calibrated on
    ``calib_dir`` images or loaded from the model's quant cache
    (`per_model_quant_cache` of ``quant_cache``), else dynamic scales. f32
    (or none) keeps the raw models. ``calib_dir``/``quant_cache`` under
    another dtype print a warning and are ignored."""
    from facesr_torch.parallel.serving import (ShardedPredictor, load_calibration_images,
                                               per_model_quant_cache)

    _check_serving_dtype(dtype)
    if dtype != "int8_full" and (calib_dir or quant_cache):
        print(f"Warning: --calib-dir/--quant-cache only apply to --dtype int8_full "
              f"(got {dtype or 'f32'}); ignoring them")
    if not dtype or dtype == "f32":
        return models
    calibration = None
    if calib_dir and dtype == "int8_full":
        calibration = load_calibration_images(calib_dir)
    serve_dtype = torch.bfloat16 if dtype == "bf16" else dtype
    every_card = device is not None and torch.device(device) == torch.device("cuda")
    return {name: ShardedPredictor(
                m, mesh=None if every_card else [next(m.parameters()).device],
                dtype=serve_dtype, max_batch=max_batch, calibration=calibration,
                quant_cache=per_model_quant_cache(quant_cache if dtype == "int8_full" else None,
                                                  name))
            for name, m in models.items()}


def serve_batch(model, batch: np.ndarray) -> np.ndarray:
    """A servable — a raw model (its f32 eval forward: FaceEnhanceNet's is
    clamped, the zoo's is not), a `Predictor` or an artifact callable — on
    an NHWC float batch; float32 numpy."""
    if isinstance(model, torch.nn.Module):
        dev = next(model.parameters()).device
        with torch.inference_mode():
            x = torch.from_numpy(np.require(batch, np.float32, "CW")).to(dev)
            return model(x).cpu().numpy()
    return np.asarray(model(batch), np.float32)


def _metrics(sr_uint8: np.ndarray, hr_uint8: np.ndarray, lpips_fn=None) -> dict:
    from facesr_torch.evaluation.skimage_compat import (peak_signal_noise_ratio,
                                                        structural_similarity)

    m = {"psnr": peak_signal_noise_ratio(hr_uint8, sr_uint8, data_range=255),
         "ssim": structural_similarity(hr_uint8, sr_uint8, data_range=255, channel_axis=-1)}
    if lpips_fn is not None and lpips_fn.available:
        m["lpips"] = float(lpips_fn(
            torch.from_numpy(sr_uint8[None].astype(np.float32) / 255.0),
            torch.from_numpy(hr_uint8[None].astype(np.float32) / 255.0)))
    return m


def prepare_inputs(image_rgb: np.ndarray):
    """The input-size rule (reference :244-266): an image of at most 128 px
    is LR (no ground truth); a larger one is centre-cropped to 256 HR and a
    64 px LR synthesised (the trainer's bicubic, on the host). Returns
    (lr float32 [64, 64, 3], hr uint8 or None)."""
    h, w = image_rgb.shape[:2]
    if max(h, w) <= 2 * LR_SIZE:
        lr = (resize_area(image_rgb, (LR_SIZE, LR_SIZE))
              if (h, w) != (LR_SIZE, LR_SIZE) else image_rgb)
        return lr.astype(np.float32) / 255.0, None
    side = min(h, w)
    top, left = (h - side) // 2, (w - side) // 2
    hr = image_rgb[top:top + side, left:left + side]
    if side != HR_SIZE:
        hr = resize_area(hr, (HR_SIZE, HR_SIZE))
    with torch.inference_mode():
        lr = bicubic_down(torch.from_numpy(hr[None].astype(np.float32) / 255.0), 4)[0]
    # C-contiguous, as JAX's: the resize's einsum leaves H and W transposed
    return np.ascontiguousarray(lr.numpy()), hr


def process_image(image_rgb: np.ndarray, model, lpips_fn=None) -> dict:
    """SR against the bicubic and Lanczos-4 baselines, with the metric text
    (reference :268-359)."""
    lr, hr = prepare_inputs(image_rgb)
    sr_uint8 = to_uint8(serve_batch(model, lr[None])[0])
    lr_uint8 = to_uint8(lr)
    out_size = (sr_uint8.shape[1], sr_uint8.shape[0])
    bicubic = resize_cubic(lr_uint8, out_size)
    lanczos = resize_lanczos4(lr_uint8, out_size)
    text = "No ground truth (input treated as LR) — metrics unavailable."
    if hr is not None:
        rows = []
        for name, img in (("Bicubic", bicubic), ("Lanczos4", lanczos), ("Model", sr_uint8)):
            m = _metrics(img, hr, lpips_fn)
            row = f"{name}: PSNR {m['psnr']:.2f} dB, SSIM {m['ssim']:.4f}"
            if "lpips" in m:
                row += f", LPIPS {m['lpips']:.4f}"
            rows.append(row)
        text = "\n".join(rows)
    return {"lr": lr_uint8, "bicubic": bicubic, "lanczos": lanczos, "sr": sr_uint8,
            "hr": hr, "metrics_text": text}


def create_demo(*args, **kwargs):
    """The gradio UI of the JAX demo; gradio is not installed on the
    port's machines, so this raises with the JAX demo's message."""
    raise RuntimeError(GRADIO_MESSAGE)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Face SR demo (PyTorch port, headless)")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    parser.add_argument("--image", type=str, default=None,
                        help="Headless mode: process one PNG and exit")
    parser.add_argument("--output", type=str, default="outputs/demo")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when omitted (raises without a card)")
    parser.add_argument("--dtype", type=str, default=None,
                        choices=["f32", "bf16", "int8", "int8_full"],
                        help="serving dtype: bf16 routes through Predictor (the group "
                             "kernel); int8 = int8 weights, int8_full = s8 convs")
    parser.add_argument("--calib-dir", type=str, default=None,
                        help="images that calibrate int8_full's static activation scales")
    parser.add_argument("--quant-cache", type=str, default=None,
                        help="path prefix of the per-model calibrated int8 caches "
                             "(<prefix>.<model>.fckpt), read when present, else written "
                             "after calibration")
    parser.add_argument("--exported", type=str, default=None,
                        help="comma-separated .pt2 serving artifacts "
                             "(python -m facesr_torch.cli.export_serving)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    from facesr_torch.data.codecs import ImageDecodeError, imread
    from facesr_torch.data.png import write_png
    from facesr_torch.evaluation.metrics import LPIPS

    args = parse_args(argv)
    if not args.image:
        print(GRADIO_MESSAGE)
        return 0
    models = _assemble_models(args.checkpoint_dir, args.dtype, args.calib_dir,
                              args.quant_cache, args.exported, args.device)
    if not models:
        print(f"No checkpoints in {args.checkpoint_dir} (and no --exported artifacts)")
        return 1
    name = next(iter(models))
    try:
        img = imread(args.image)
    except ImageDecodeError as e:
        print(f"Cannot read image {args.image}: {e}")
        return 1
    res = process_image(img, models[name], LPIPS())
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    for key in ("lr", "bicubic", "lanczos", "sr", "hr"):
        if res.get(key) is not None:
            write_png(out / f"{key}.png", res[key])
    print(f"[{name}]\n{res['metrics_text']}")
    print(f"Outputs in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
