"""Split raw files into train/val/test folders (the port of
`scripts/split_data.py`), with its CLI:

    python -m facesr_torch.cli.split_data --input raw/ --output split/ [--move]

The ratios are normalised to sum to 1, the seed is 42 by default, files
are copied (or moved with ``--move``) into flat ``<split>/<name>``
folders, and duplicate basenames under the input are refused up front
(they would overwrite one another, and with ``--move`` destroy files).
The shuffle is ``random.Random(seed)``: the JAX script's ``random.seed``
+ ``random.shuffle`` order, without resetting the process's global
stream. Standard library only.
"""

from __future__ import annotations

import argparse
import random
import shutil
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["split_data", "main"]

_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def split_data(input_dir: str, output_dir: str, train_ratio: float = 0.857,
               val_ratio: float = 0.071, test_ratio: float = 0.072, seed: int = 42,
               move: bool = False) -> Dict[str, int]:
    """Copy or move the images under ``input_dir`` into
    ``output_dir/{train,val,test}``; returns the count of each split."""
    input_path, output_path = Path(input_dir), Path(output_dir)
    total = train_ratio + val_ratio + test_ratio
    train_ratio, val_ratio = train_ratio / total, val_ratio / total

    files = sorted(f for f in input_path.rglob("*") if f.suffix.lower() in _EXTENSIONS)
    if not files:
        raise ValueError(f"No images found in {input_dir}")
    dupes = [n for n, c in Counter(f.name for f in files).items() if c > 1]
    if dupes:
        raise ValueError(
            f"{len(dupes)} duplicate basenames across subdirectories "
            f"(e.g. {dupes[:3]}); splits write flat <split>/<name> — "
            f"rename or flatten the input first")
    print(f"Found {len(files)} images")

    random.Random(seed).shuffle(files)
    n = len(files)
    n_train = int(n * train_ratio)
    n_val = int(n * val_ratio)
    splits: Dict[str, List[Path]] = {
        "train": files[:n_train],
        "val": files[n_train:n_train + n_val],
        "test": files[n_train + n_val:],
    }
    op = shutil.move if move else shutil.copy2
    counts = {}
    for split, flist in splits.items():
        dest = output_path / split
        dest.mkdir(parents=True, exist_ok=True)
        for f in flist:
            op(str(f), str(dest / f.name))
        counts[split] = len(flist)
        print(f"{split}: {len(flist)} files -> {dest}")
    return counts


def main(argv: Optional[List[str]] = None) -> Dict[str, int]:
    parser = argparse.ArgumentParser(description="Split dataset into train/val/test")
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--train-ratio", type=float, default=0.857)
    parser.add_argument("--val-ratio", type=float, default=0.071)
    parser.add_argument("--test-ratio", type=float, default=0.072)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--move", action="store_true", help="Move instead of copy")
    args = parser.parse_args(argv)
    return split_data(args.input, args.output, args.train_ratio, args.val_ratio,
                      args.test_ratio, args.seed, args.move)


if __name__ == "__main__":
    main()
