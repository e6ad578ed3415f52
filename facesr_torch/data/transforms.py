"""Synchronized LR<->HR augmentation on the host (port of
`facesr/data/transforms.py`, with `cv_compat` in place of cv2).

Scale-aware random crop (HR crop coordinates / scale for LR), horizontal
flip, optional rot90 (default probability 0 for faces), and colour jitter
with the same parameters for both images (brightness multiply, contrast
around the mean, HSV saturation scale). The per-thread generators are
spawned from one SeedSequence and drawn in the JAX package's order, so the
same seed gives the same crops, flips and jitter.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np

from facesr_torch.data.cv_compat import hsv_to_rgb, rgb_to_hsv

__all__ = ["PairedTransform", "to_array"]


class PairedTransform:
    """Synchronized transforms for an (HR, LR) uint8 image pair."""

    def __init__(
        self,
        hr_patch_size: int = 128,
        scale_factor: int = 4,
        mode: str = "train",
        horizontal_flip: float = 0.5,
        random_rotate90: float = 0.0,  # default 0 for faces
        color_jitter_prob: float = 0.3,
        brightness: float = 0.1,
        contrast: float = 0.1,
        saturation: float = 0.1,
        hue: float = 0.05,
        rng: Optional[np.random.Generator] = None,
        seed: Optional[int] = None,
    ):
        self.hr_patch_size = hr_patch_size
        self.lr_patch_size = hr_patch_size // scale_factor
        self.scale_factor = scale_factor
        self.mode = mode
        self.flip_prob = horizontal_flip if mode == "train" else 0.0
        self.rotate_prob = random_rotate90 if mode == "train" else 0.0
        self.color_prob = color_jitter_prob if mode == "train" else 0.0
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        # accepted for config parity but not applied, as in the JAX
        # package; a user who sets it is warned that it is a no-op
        self.hue = hue
        if hue not in (0, 0.05) and mode == "train" and color_jitter_prob > 0:
            import warnings
            warnings.warn(
                "color_jitter 'hue' is accepted for config parity but not "
                "applied (the JAX package does not apply it either)",
                stacklevel=2)
        # DataLoader calls __getitem__ from a thread pool, and numpy
        # Generators are not thread-safe: each worker thread gets its own,
        # spawned from one SeedSequence (deterministic for num_workers <= 1)
        if rng is not None:
            ss = getattr(rng.bit_generator, "seed_seq", None)
            if ss is None:  # numpy < 1.25 spells it _seed_seq
                ss = getattr(rng.bit_generator, "_seed_seq", None)
            self._seed_seq = ss if ss is not None else np.random.SeedSequence()
        else:
            self._seed_seq = np.random.SeedSequence(seed)
        self._local = threading.local()
        self._spawn_lock = threading.Lock()

    @property
    def rng(self) -> np.random.Generator:
        gen = getattr(self._local, "gen", None)
        if gen is None:
            with self._spawn_lock:  # spawn() mutates the SeedSequence counter
                child = self._seed_seq.spawn(1)[0]
            gen = np.random.default_rng(child)
            self._local.gen = gen
        return gen

    def __call__(self, hr_image: np.ndarray, lr_image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        hr_h, hr_w = hr_image.shape[:2]

        if self.mode == "train":
            # scale-aware random crop; >= so that an image with one side
            # equal to the patch is still cropped on the other side
            if hr_h >= self.hr_patch_size and hr_w >= self.hr_patch_size:
                top = int(self.rng.integers(0, hr_h - self.hr_patch_size + 1))
                left = int(self.rng.integers(0, hr_w - self.hr_patch_size + 1))
                hr_image = hr_image[top:top + self.hr_patch_size, left:left + self.hr_patch_size]
                lt, ll = top // self.scale_factor, left // self.scale_factor
                lr_image = lr_image[lt:lt + self.lr_patch_size, ll:ll + self.lr_patch_size]

            if self.rng.random() < self.flip_prob:
                hr_image = np.fliplr(hr_image).copy()
                lr_image = np.fliplr(lr_image).copy()

            if self.rng.random() < self.rotate_prob:
                k = int(self.rng.integers(1, 4))
                hr_image = np.rot90(hr_image, k).copy()
                lr_image = np.rot90(lr_image, k).copy()

            if self.rng.random() < self.color_prob:
                hr_image, lr_image = self._color_jitter(hr_image, lr_image)

        return hr_image, lr_image

    def _color_jitter(self, hr_image: np.ndarray, lr_image: np.ndarray):
        """The same jitter parameters for both images."""
        brightness = self.rng.uniform(1.0 - self.brightness, 1.0 + self.brightness)
        contrast = self.rng.uniform(1.0 - self.contrast, 1.0 + self.contrast)
        saturation = self.rng.uniform(1.0 - self.saturation, 1.0 + self.saturation)

        out = []
        for img in (hr_image, lr_image):
            img = np.ascontiguousarray(img)
            f = img.astype(np.float32) / 255.0
            f = f * brightness
            mean = f.mean()
            f = (f - mean) * contrast + mean
            hsv = rgb_to_hsv(np.clip(f * 255, 0, 255).astype(np.uint8)).astype(np.float32)
            hsv[:, :, 1] = hsv[:, :, 1] * saturation
            hsv = np.clip(hsv, 0, 255).astype(np.uint8)
            out.append(hsv_to_rgb(hsv))
        return out[0], out[1]


def to_array(image: np.ndarray, normalize: bool = True) -> np.ndarray:
    """uint8 HWC image -> float32 HWC in [0,1] (the port's public functions
    take NHWC, so there is no CHW transpose)."""
    arr = np.asarray(image)
    if normalize:
        arr = arr.astype(np.float32) / 255.0
    return arr

