"""Stage-vs-stage face-region crop panel (port of `scripts/stage_panel.py`).

Qualitative evidence for the GAN stage: side-by-side eye/mouth crops from
successive stage checkpoints against bicubic and ground truth, the regions
GAN training sharpens. Complements the metric table of
`compare_two_models`, where stage 3's PSNR dip hides its perceptual gain.

    python -m facesr_torch.cli.stage_panel \\
        --checkpoints s2/best_model.fckpt s3/best_model.fckpt \\
        --labels stage2 stage3 --test-dir processed/test/HR \\
        --output panel --num-images 4

The flags are the JAX script's, with ``--device`` in place of
``--platform``: the models run on the card unless ``--device cpu`` is
given. Checkpoints are any the port loads (`models.load.load_any_model`:
``.fckpt`` of either package, ``.pth``). The LR is the port's
`bicubic_down` of the HR crop, the bicubic column cv2's ``INTER_CUBIC``
(`data.cv_compat.resize_cubic`), each model's column its f32 forward.
Images are read by `data.codecs.imread` (PNG, JPEG, BMP, TIFF, bitwise
cv2's) and written as PNG (`data.png`). The label bars keep their size and
grey, without the text (ROADMAP A.8.2): the column order is printed and
written to ``stage_panel_columns.txt``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["main", "crop_region", "label_strip"]


def crop_region(img: np.ndarray, box) -> np.ndarray:
    """Crop a (y0, x0, y1, x1)-fraction box out of an HWC image."""
    h, w = img.shape[:2]
    y0, x0, y1, x1 = box
    return img[int(y0 * h):int(y1 * h), int(x0 * w):int(x1 * w)]


def label_strip(img: np.ndarray) -> np.ndarray:
    """Add the (unlabelled) bar above the image."""
    bar = np.full((22, img.shape[1], 3), 32, np.uint8)
    return np.vstack([bar, img])


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoints", nargs="+", required=True,
                        help="Stage checkpoints, in curriculum order")
    parser.add_argument("--labels", nargs="+", default=None,
                        help="One label per checkpoint (default: parent folder names)")
    parser.add_argument("--test-dir", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--num-images", type=int, default=4)
    parser.add_argument("--regions", default="eyes,mouth",
                        help="Comma-separated FACE_REGIONS names")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--zoom", type=int, default=3, help="Nearest-neighbour zoom on the crops")
    parser.add_argument("--seed", type=int, default=0,
                        help="Sample picker seed (images are sampled, not the first N)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Path:
    """Write the panels; returns the path of ``stage_panel.png``."""
    args = _parse(argv)

    import torch

    from facesr_torch.data import codecs, png
    from facesr_torch.data.cv_compat import resize_cubic, resize_nearest
    from facesr_torch.data.dataset import _list_images
    from facesr_torch.device import resolve_device
    from facesr_torch.evaluation.explainability import FACE_REGIONS
    from facesr_torch.models.load import load_any_model
    from facesr_torch.ops.conv import full_f32
    from facesr_torch.ops.resize import bicubic_down

    labels = args.labels or [Path(p).parent.name or Path(p).stem for p in args.checkpoints]
    if len(labels) != len(args.checkpoints):
        raise SystemExit("--labels must match --checkpoints")
    # labels key the model/output dicts and the reserved panel columns: a
    # collision would silently drop a checkpoint while the printed column
    # list still advertises it
    reserved = {"bicubic", "GT"}
    bad = {lab for lab in labels if labels.count(lab) > 1} | (set(labels) & reserved)
    if bad:
        raise SystemExit(f"Duplicate or reserved labels {sorted(bad)}; pass unique "
                         f"--labels (and not {sorted(reserved)})")
    regions = [r.strip() for r in args.regions.split(",") if r.strip()]
    for r in regions:
        if r not in FACE_REGIONS:
            raise SystemExit(f"Unknown region {r!r}; have {list(FACE_REGIONS)}")

    device = resolve_device(args.device)
    models = {}
    for label, path in zip(labels, args.checkpoints):
        models[label] = load_any_model(path, device=device)
        print(f"Loaded {label}: {path}")

    test_dir = Path(args.test_dir)
    files = _list_images(test_dir) if test_dir.is_dir() else []
    if not files:
        raise SystemExit(f"No test images in {args.test_dir}")
    rng = np.random.default_rng(args.seed)
    picks = sorted(rng.choice(len(files), size=min(args.num_images, len(files)),
                              replace=False).tolist())
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)

    rows = []
    for i in picks:
        try:
            hr = codecs.imread(files[i])
        except codecs.UnsupportedImage:
            raise
        except codecs.ImageDecodeError:  # corrupt sample: skip it, keep the panel alive
            print(f"  skipping unreadable image {files[i].name}")
            continue
        ch, cw = (hr.shape[0] // args.scale * args.scale, hr.shape[1] // args.scale * args.scale)
        hr = hr[:ch, :cw]
        with full_f32(), torch.no_grad():
            lr = bicubic_down(torch.from_numpy(hr[None].astype(np.float32) / 255.0),
                              args.scale)[0].numpy()
        lr_u8 = (np.clip(lr, 0, 1) * 255).round().astype(np.uint8)

        outputs = {"bicubic": resize_cubic(lr_u8, (cw, ch))}
        for label, model in models.items():
            with full_f32(), torch.no_grad():
                sr = model(torch.from_numpy(lr[None]).to(device))[0].cpu().numpy()
            outputs[label] = (np.clip(sr, 0, 1) * 255).round().astype(np.uint8)
        outputs["GT"] = hr

        for region in regions:
            box = FACE_REGIONS[region]
            tiles = []
            for img in outputs.values():
                crop = crop_region(img, box)
                crop = resize_nearest(crop, (crop.shape[1] * args.zoom,
                                             crop.shape[0] * args.zoom))
                tiles.append(label_strip(crop))
            h = max(t.shape[0] for t in tiles)
            tiles = [np.pad(t, ((0, h - t.shape[0]), (0, 2), (0, 0))) for t in tiles]
            rows.append(np.hstack(tiles))
            png.write_png(out_dir / f"panel_{files[i].stem}_{region}.png", rows[-1])

    if not rows:
        raise SystemExit("All sampled test images were unreadable; no panel")
    w = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 4), (0, w - r.shape[1]), (0, 0))) for r in rows]
    panel = np.vstack(rows)
    panel_path = out_dir / "stage_panel.png"
    png.write_png(panel_path, panel)
    columns = ["bicubic", *labels, "GT"]
    (out_dir / "stage_panel_columns.txt").write_text(", ".join(columns) + "\n")
    print(f"Panel saved to {panel_path} ({len(picks)} images x {len(regions)} regions; "
          f"columns: {', '.join(columns)})")
    return panel_path


if __name__ == "__main__":
    main()
