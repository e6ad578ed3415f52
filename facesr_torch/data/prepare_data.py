"""Offline data preparation: raw face PNGs -> HR/LR pairs (the port of
`facesr/data/prepare_data.py`), with its CLI:

    python -m facesr_torch.data.prepare_data --input raw/ --output processed/

Degradations: 'bicubic', 'bilinear' and 'realistic' (7x7 Gaussian blur,
sigma 1.5, + N(0, 5) noise, bicubic downsample); the HR size by area
resampling; the seeded train/val/test split (0.857/0.071 by default) in
`random.Random(seed)` order; ``prepare_stats.json``; ``--dry-run``.
Host-side numpy, as in the JAX package: the resizes and the blur are
`cv_compat`'s copies of cv2's (bitwise), and the files are `data.png`'s.
The JAX package reads BGR through cv2 and the port RGB, which changes no
pixel: every step is per channel, and the realistic noise is drawn as
JAX draws it (one [H, W, 3] array from ``rng``, the global numpy stream
by default) and added to the channels in reverse, so each value lands
on the channel it lands on in JAX.

Inputs (``.jpg``, ``.jpeg``, ``.png``, ``.bmp``, ``.tiff``, as the JAX
package lists them) are read by `codecs.imread`, bitwise what the JAX
package's ``cv2.imread`` gives. A file the port does not decode (a CMYK
JPEG, a tiled TIFF ...: `codecs.UnsupportedImage`) is refused by name
before anything is written; one that is corrupt for cv2 too is warned
about and skipped, as the JAX package skips it. A JPEG cut inside its
entropy data is kept: ``cv2.imread`` patches it (the rest grey), and so
does `codecs.imread`.

``--hdf5`` packs each split into ``<output>/<split>.h5`` after writing its
PNGs (`save_to_hdf5`): gzip'd uint8 ``HR`` and ``LR``, one image a chunk,
and ``filenames``, written by the port's own `data.hdf5` (the card's
machine has no h5py); h5py reads the files, and the datasets read them
before the PNG folders.
"""

from __future__ import annotations

import argparse
import json
import random
import shutil
from collections import Counter
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from facesr_torch.data import codecs, hdf5
from facesr_torch.data.cv_compat import (gaussian_blur, resize_area, resize_cubic,
                                         resize_linear)
from facesr_torch.data.png import write_png

__all__ = ["create_lr_image", "resize_hr_image", "get_image_files", "check_inputs",
           "split_dataset", "process_and_save_images", "save_to_hdf5", "main"]

_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tiff")


def create_lr_image(hr_image: np.ndarray, lr_size: int = 64, method: str = "bicubic",
                    rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Downsample an [H, W, 3] RGB uint8 HR image with the chosen
    degradation. 'realistic' draws its noise from ``rng`` (None: the
    global numpy stream, as the JAX package does)."""
    size = (lr_size, lr_size)
    if method == "bicubic":
        return resize_cubic(hr_image, size)
    if method == "bilinear":
        return resize_linear(hr_image, size)
    if method == "realistic":
        blurred = gaussian_blur(hr_image, 7, 1.5)
        noise = (rng or np.random).normal(0, 5, blurred.shape).astype(np.float32)
        noisy = np.clip(blurred.astype(np.float32) + noise[..., ::-1], 0, 255).astype(np.uint8)
        return resize_cubic(noisy, size)
    raise ValueError(f"Unknown degradation method: {method}")


def resize_hr_image(image: np.ndarray, hr_size: int = 256) -> np.ndarray:
    """Area downsample of the raw image to the HR size."""
    return resize_area(image, (hr_size, hr_size))


def get_image_files(input_dir: Path) -> List[Path]:
    """Every image file under ``input_dir`` (recursive; the JAX package's
    extensions, either case), sorted."""
    files: List[Path] = []
    for ext in _EXTENSIONS:
        files.extend(input_dir.glob(f"**/*{ext}"))
        files.extend(input_dir.glob(f"**/*{ext.upper()}"))
    return sorted(set(files))


def check_inputs(files: List[Path]) -> None:
    """Raise, before anything is written, when a file is one the port
    does not decode (the JAX package reads it through cv2). A corrupt file
    passes: it is skipped with a warning when its turn comes."""
    bad = [(f, why) for f in files if (why := codecs.refusal(f)) is not None]
    if bad:
        shown = "; ".join(why for _, why in bad[:3])
        raise SystemExit(
            f"{len(bad)} input file(s) the port cannot read, e.g. {shown}. The port reads "
            "JPEG (baseline, progressive), PNG, BMP and TIFF (strips; none, PackBits, LZW or "
            "Deflate) as cv2 does; convert these first")


def split_dataset(files: List[Path], train_ratio: float = 0.857, val_ratio: float = 0.071,
                  seed: int = 42) -> Tuple[List[Path], List[Path], List[Path]]:
    """Seeded shuffle split (~60k/5k/5k of FFHQ's 70k), in the JAX
    package's order (a local ``random.Random(seed)``)."""
    files = list(files)
    random.Random(seed).shuffle(files)
    n_total = len(files)
    n_train = int(n_total * train_ratio)
    n_val = int(n_total * val_ratio)
    return files[:n_train], files[n_train:n_train + n_val], files[n_train + n_val:]


def process_and_save_images(files: List[Path], output_dir: Path, hr_size: int = 256,
                            lr_size: int = 64, degradation: str = "bicubic",
                            desc: str = "Processing",
                            rng: Optional[np.random.RandomState] = None) -> int:
    """Write HR/ and LR/ PNGs for each input image; returns the count
    written. This run owns the split's HR/ and LR/ folders: files of an
    earlier run (another --max-images or --seed) are removed first, or
    they would leak into the new split."""
    hr_dir = output_dir / "HR"
    lr_dir = output_dir / "LR"
    for d in (hr_dir, lr_dir):
        if d.exists() and any(d.iterdir()):
            print(f"Clearing stale files in {d} from a previous run")
            shutil.rmtree(d)
    hr_dir.mkdir(parents=True, exist_ok=True)
    lr_dir.mkdir(parents=True, exist_ok=True)

    count = 0
    for i, path in enumerate(files):
        try:
            img = codecs.imread(path)
        except codecs.UnsupportedImage:
            raise
        except codecs.ImageDecodeError as e:
            print(f"Warning: could not read {path}: {e}")
            continue
        hr = resize_hr_image(img, hr_size)
        lr = create_lr_image(hr, lr_size, degradation, rng)
        name = f"{path.stem}.png"
        write_png(hr_dir / name, hr)
        write_png(lr_dir / name, lr)
        count += 1
        if (i + 1) % 500 == 0:
            print(f"{desc}: {i + 1}/{len(files)}")
    return count


def save_to_hdf5(split_dir: Path, output_path: Path, hr_size: int = 256,
                 lr_size: int = 64) -> None:
    """Pack a processed split dir (HR/ + LR/ PNGs, sorted by name) into one
    gzip'd HDF5 file, as the JAX package does: every pair is checked
    (readable, the sizes given) as it is written."""
    hr_files = sorted((Path(split_dir) / "HR").glob("*.png"))

    def pairs():
        for hr_path in hr_files:
            lr_path = Path(split_dir) / "LR" / hr_path.name
            try:
                hr, lr = codecs.imread(hr_path), codecs.imread(lr_path)
            except codecs.ImageDecodeError:
                raise IOError(f"Unreadable/missing pair for {hr_path.name} "
                              f"(LR exists: {lr_path.exists()})") from None
            if hr.shape[:2] != (hr_size, hr_size) or lr.shape[:2] != (lr_size, lr_size):
                raise ValueError(
                    f"{hr_path.name}: sizes {hr.shape[:2]}/{lr.shape[:2]} do not match "
                    f"hr_size={hr_size}/lr_size={lr_size} — stale files from a previous run "
                    "with different sizes?")
            yield hr, lr, hr_path.name

    n = hdf5.write_pairs(output_path, pairs(), hr_size, lr_size)
    print(f"Saved {n} pairs to {output_path}")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Prepare FFHQ SR data (PyTorch port)")
    parser.add_argument("--input", type=str, required=True, help="Raw image dir")
    parser.add_argument("--output", type=str, required=True, help="Output dir")
    parser.add_argument("--hr-size", type=int, default=256)
    parser.add_argument("--lr-size", type=int, default=64)
    parser.add_argument("--degradation", type=str, default="bicubic",
                        choices=["bicubic", "bilinear", "realistic"])
    parser.add_argument("--train-ratio", type=float, default=0.857)
    parser.add_argument("--val-ratio", type=float, default=0.071)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--hdf5", "--save-hdf5", dest="hdf5", action="store_true",
                        help="Also pack splits into .h5 files")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--dry-run", action="store_true",
                        help="Show the split without processing")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None, rng: Optional[np.random.RandomState] = None
         ) -> dict:
    """The CLI; returns the per-split counts (empty on a dry run).
    ``rng``: the realistic noise's stream (None: numpy's global one)."""
    args = parse_args(argv)
    files = get_image_files(Path(args.input))
    if args.max_images:
        files = files[: args.max_images]
    dupes = [st for st, c in Counter(f.stem for f in files).items() if c > 1]
    if dupes:
        # outputs are flat HR/<stem>.png: colliding stems would overwrite pairs
        raise SystemExit(
            f"{len(dupes)} duplicate stems across subdirectories "
            f"(e.g. {dupes[:3]}); rename or flatten the input first")
    check_inputs(files)
    print(f"Found {len(files)} images")

    train_f, val_f, test_f = split_dataset(files, args.train_ratio, args.val_ratio, args.seed)
    if args.dry_run:
        print(f"  Train: {len(train_f)} images")
        print(f"  Val:   {len(val_f)} images")
        print(f"  Test:  {len(test_f)} images")
        print("\n[Dry run] No files were processed.")
        return {}
    out = Path(args.output)
    stats = {}
    for split, flist in (("train", train_f), ("val", val_f), ("test", test_f)):
        stats[split] = process_and_save_images(flist, out / split, args.hr_size, args.lr_size,
                                               args.degradation, desc=split, rng=rng)
        if args.hdf5:
            save_to_hdf5(out / split, out / f"{split}.h5", args.hr_size, args.lr_size)
    (out / "prepare_stats.json").write_text(json.dumps({
        "stats": stats,
        "hr_size": args.hr_size,
        "lr_size": args.lr_size,
        "degradation": args.degradation,
        "seed": args.seed,
    }, indent=2))
    print(f"Done: {stats}")
    return stats


if __name__ == "__main__":
    main()
