"""FFHQ dataset: HR+LR directories or HR-only with synthesised LR, an LRU
cache, and the loader factory (port of `facesr/data/dataset.py`).

- two sources: ``HR/`` + ``LR/`` directories, or HR-only with the LR made
  on the fly by `cv_compat.resize_cubic` (cv2's ``INTER_CUBIC``); an HDF5
  root (``.h5``) raises, since the card's machine has no h5py;
- HR/LR pair reconciliation by file stem, and refusal of duplicate stems;
- a thread-safe LRU ImageCache with a hit-rate statistic;
- samples are ``{'hr', 'lr'[, 'filename']}`` float32 HWC arrays in [0, 1].

Images are read with `png.read_rgb`; a JPEG or BMP file raises with its
name.
"""

from __future__ import annotations

import threading
from collections import Counter, OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from facesr_torch.data import png
from facesr_torch.data.cv_compat import resize_cubic
from facesr_torch.data.loader import DataLoader
from facesr_torch.data.transforms import PairedTransform, to_array

__all__ = ["ImageCache", "FFHQDataset", "get_dataloader"]

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def _list_images(d: Path) -> List[Path]:
    """All images in `d`, every supported extension, case-insensitive,
    one sorted listing (an `or`-chain of per-extension globs would drop
    every .jpg the moment a single .png exists)."""
    return sorted(p for p in d.iterdir()
                  if p.suffix.lower() in _IMAGE_EXTS)


def _read_rgb(path: Path) -> np.ndarray:
    """HWC RGB uint8; a corrupt or unreadable file raises with its name."""
    try:
        return png.read_rgb(path)
    except png.PNGError as e:
        raise IOError(f"Could not decode image {path}: {e}") from e


class ImageCache:
    """Thread-safe LRU cache for decoded image pairs."""

    def __init__(self, max_size: int = 100):
        self.max_size = max_size
        self.cache: OrderedDict = OrderedDict()
        self.lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        with self.lock:
            if key in self.cache:
                self.cache.move_to_end(key)
                self.hits += 1
                return self.cache[key]
            self.misses += 1
            return None

    def put(self, key: str, value: Tuple[np.ndarray, np.ndarray]) -> None:
        with self.lock:
            if key in self.cache:
                self.cache.move_to_end(key)
            else:
                if len(self.cache) >= self.max_size:
                    self.cache.popitem(last=False)
                self.cache[key] = value

    def clear(self) -> None:
        with self.lock:
            self.cache.clear()
            self.hits = 0
            self.misses = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total > 0 else 0.0


class FFHQDataset:
    """Map-style dataset over FFHQ-style HR(/LR) face images."""

    def __init__(
        self,
        data_root: str,
        mode: str = "train",
        scale_factor: int = 4,
        hr_patch_size: int = 128,
        use_cache: bool = True,
        cache_size: int = 100,
        return_filename: bool = False,
        horizontal_flip: float = 0.5,
        random_rotate90: float = 0.0,
        color_jitter_prob: float = 0.3,
        brightness: float = 0.1,
        contrast: float = 0.1,
        saturation: float = 0.1,
        hue: float = 0.05,
        generate_lr_on_the_fly: bool = True,
        seed: Optional[int] = None,
    ):
        self.data_root = Path(data_root)
        self.mode = mode
        self.scale_factor = scale_factor
        self.hr_patch_size = hr_patch_size
        self.lr_patch_size = hr_patch_size // scale_factor
        self.return_filename = return_filename
        self.generate_lr_on_the_fly = generate_lr_on_the_fly
        self.hr_only_mode = False

        if self.data_root.suffix == ".h5" or (self.data_root / f"{mode}.h5").exists():
            raise NotImplementedError(
                f"{data_root}: HDF5 datasets are not read by the port (the card's "
                "machine has no h5py; ROADMAP A.7); use HR/ + LR/ or HR-only PNG "
                "directories")
        self._init_directory()

        rng = np.random.default_rng(seed) if seed is not None else None
        self.transform = PairedTransform(
            hr_patch_size=hr_patch_size,
            scale_factor=scale_factor,
            mode=mode,
            horizontal_flip=horizontal_flip,
            random_rotate90=random_rotate90,
            color_jitter_prob=color_jitter_prob,
            brightness=brightness,
            contrast=contrast,
            saturation=saturation,
            hue=hue,
            rng=rng,
        )

        self.use_cache = use_cache and mode == "train"
        self.cache = ImageCache(cache_size) if self.use_cache else None

    # -- backend --------------------------------------------------------
    def _init_directory(self) -> None:
        mode_dir = self.data_root / self.mode
        if mode_dir.exists():
            hr_dir, lr_dir = mode_dir / "HR", mode_dir / "LR"
        else:
            hr_dir, lr_dir = self.data_root / "HR", self.data_root / "LR"

        if not hr_dir.exists():
            raise ValueError(f"Could not find HR directory in {self.data_root}")

        self.hr_files = _list_images(hr_dir)
        if not self.hr_files:
            raise ValueError(f"No images found in {hr_dir}")

        lr_listing = _list_images(lr_dir) if lr_dir.exists() else []
        if not lr_listing:
            if self.generate_lr_on_the_fly:
                self.hr_only_mode = True
                self.lr_files: List[Path] = []
                print(f"HR-only mode: {len(self.hr_files)} HR images, LR generated on-the-fly")
            else:
                raise ValueError(
                    f"Could not find LR directory in {self.data_root} "
                    "and generate_lr_on_the_fly=False"
                )
        else:
            self.lr_files = lr_listing
            # stems are the pairing key: a duplicate stem within one dir
            # (face1.png + face1.jpg) would mispair, so refuse it
            for label, files in (("HR", self.hr_files), ("LR", self.lr_files)):
                dupes = sorted(s for s, n in Counter(f.stem for f in files).items() if n > 1)
                if dupes:
                    raise ValueError(
                        f"Duplicate image stems in {label} dir (same name, "
                        f"different extension): {dupes[:5]}"
                        f"{'...' if len(dupes) > 5 else ''} — HR/LR pairing "
                        "is by stem and would be ambiguous")
            hr_names = {f.stem for f in self.hr_files}
            lr_names = {f.stem for f in self.lr_files}
            if hr_names != lr_names:
                missing_lr = hr_names - lr_names
                missing_hr = lr_names - hr_names
                if missing_lr:
                    print(f"Warning: {len(missing_lr)} HR images without LR pair")
                if missing_hr:
                    print(f"Warning: {len(missing_hr)} LR images without HR pair")
                common = hr_names & lr_names
                self.hr_files = [f for f in self.hr_files if f.stem in common]
                self.lr_files = [f for f in self.lr_files if f.stem in common]

        self.filenames = [f.name for f in self.hr_files]
        self.length = len(self.hr_files)

    # -- access ----------------------------------------------------------
    def __len__(self) -> int:
        return self.length

    def load_hr(self, idx: int) -> np.ndarray:
        """Decode only the HR image (the HR-only training loader's path: it
        skips the LR that _load_images would make and discard)."""
        return _read_rgb(self.hr_files[idx])

    def _load_images(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        hr_image = _read_rgb(self.hr_files[idx])
        if self.hr_only_mode:
            h, w = hr_image.shape[:2]
            lr_image = resize_cubic(hr_image, (w // self.scale_factor, h // self.scale_factor))
        else:
            lr_image = _read_rgb(self.lr_files[idx])
        return hr_image, lr_image

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        cache_key = f"{self.mode}_{idx}"
        if self.cache is not None:
            cached = self.cache.get(cache_key)
            if cached is not None:
                hr_image, lr_image = cached[0].copy(), cached[1].copy()
            else:
                hr_image, lr_image = self._load_images(idx)
                self.cache.put(cache_key, (hr_image.copy(), lr_image.copy()))
        else:
            hr_image, lr_image = self._load_images(idx)

        hr_image, lr_image = self.transform(hr_image, lr_image)

        result = {
            "hr": to_array(hr_image),
            "lr": to_array(lr_image),
        }
        if self.return_filename:
            result["filename"] = self.filenames[idx]
        return result

    def get_sample_images(self, n: int = 5) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Sample n (lr, hr) pairs: (LR, HR), the reverse of
        `_load_images`' (hr, lr) order, as the JAX package returns them."""
        indices = np.random.default_rng(0).choice(len(self), min(n, len(self)), replace=False)
        return [tuple(reversed(self._load_images(int(i)))) for i in indices]


def get_dataloader(
    data_root: str,
    mode: str = "train",
    batch_size: int = 16,
    num_workers: int = 4,
    prefetch_batches: int = 4,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    **dataset_kwargs,
) -> DataLoader:
    """Loader factory: shuffle + drop_last in train mode, threaded
    prefetch. A ``seed`` kwarg sets both the augmentation RNG and the
    shuffle order; prefetch depth and multi-process sharding pass through."""
    dataset = FFHQDataset(data_root, mode=mode, **dataset_kwargs)
    shuffle = mode == "train"
    drop_last = mode == "train"
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=num_workers,
        prefetch_batches=prefetch_batches,
        seed=dataset_kwargs.get("seed", 0) or 0,
        process_index=process_index,
        process_count=process_count,
    )
