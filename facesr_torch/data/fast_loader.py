"""Fast HR-only training loader on the native batch assembler (port of
`facesr/data/fast_loader.py`).

The train step makes the LR on the device from the HR batch, so training
needs HR crops only. This loader decodes HR images on a thread pool and
hands crop + flip + normalise + stack to the C++
`facesr_torch.native.assemble_hr_batch`, yielding ``{'hr': [B, crop, crop,
3] float32}`` batches. There is no numpy fallback: a failed build raises.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from facesr_torch.data.cv_compat import resize_cubic
from facesr_torch.data.loader import bounded_prefetch, host_shard, host_shard_len
from facesr_torch.native import assemble_hr_batch

__all__ = ["FastHRLoader"]


class FastHRLoader:
    """Iterable of {'hr'} batches from a dataset exposing `_load_images`."""

    def __init__(
        self,
        dataset,
        batch_size: int = 48,
        crop: int = 256,
        flip_prob: float = 0.5,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch_batches: int = 4,
        seed: int = 0,
        nthreads: int = 0,
        process_index: int | None = None,
        process_count: int | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.crop = crop
        self.flip_prob = flip_prob
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self.seed = seed
        self.nthreads = nthreads
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def __len__(self) -> int:
        n = host_shard_len(len(self.dataset), self.process_index, self.process_count)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _decode(self, idx: int) -> np.ndarray:
        # HR-only decode (skips the LR synthesis _load_images would discard)
        if hasattr(self.dataset, "load_hr"):
            hr = self.dataset.load_hr(idx)
        else:
            hr, _ = self.dataset._load_images(idx)
        h, w = hr.shape[:2]
        if h < self.crop or w < self.crop:
            # upscale undersized images so every sample supports the crop
            # (the assembler bounds-checks and would reject them)
            scale = max(self.crop / h, self.crop / w)
            hr = resize_cubic(hr, (max(int(round(w * scale)), self.crop),
                                   max(int(round(h * scale)), self.crop)))
        return np.ascontiguousarray(hr)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1
        order = np.arange(n)
        if self.shuffle:
            rng.shuffle(order)
        order = host_shard(order, self.process_index, self.process_count)
        n = len(order)

        batches = []
        for i in range(0, n, self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            batches.append(idx)

        def assemble(images):
            b = len(images)
            tops = np.empty(b, np.int32)
            lefts = np.empty(b, np.int32)
            for j, img in enumerate(images):
                h, w = img.shape[:2]
                tops[j] = rng.integers(0, max(h - self.crop, 0) + 1)
                lefts[j] = rng.integers(0, max(w - self.crop, 0) + 1)
            flips = (rng.random(b) < self.flip_prob).astype(np.uint8)
            return {"hr": assemble_hr_batch(images, self.crop, tops, lefts,
                                            flips, nthreads=self.nthreads)}

        yield from bounded_prefetch(
            batches,
            fetch=self._decode,
            build=assemble,
            num_workers=self.num_workers,
            prefetch_batches=self.prefetch_batches,
        )
