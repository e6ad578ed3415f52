"""Single-card serving: a chunking predictor and a request micro-batcher.

Port of `facesr/parallel/serving.py` for one CUDA card:

- `build_serving_fn`: the serving precision dispatch (f32 or bf16; the
  int8 modes are not ported yet).
- `Predictor`: the single-card counterpart of the JAX ``ShardedPredictor``
  — chunks a request at ``max_batch``, pads the last chunk to
  ``max_batch`` by repeating its last image (one batch shape for the
  predictor's lifetime), clips to [0, 1] and returns numpy.
- `MicroBatcher`: coalesces concurrent single-image requests into one
  batched forward (an own copy of the JAX package's threading logic).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from facesr_torch.device import DeviceLike, resolve_device

__all__ = ["build_serving_fn", "Predictor", "MicroBatcher", "pad_to_multiple"]

ServingDtype = Optional[Union[torch.dtype, str]]


def build_serving_fn(model: torch.nn.Module,
                     dtype: ServingDtype = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """``forward(x) -> clip(model(x, train=False, dtype), 0, 1)`` under
    ``torch.inference_mode``. dtype: None or torch.float32 (f32 parity
    path), torch.bfloat16 (the kernel trunk)."""
    if dtype in ("int8", "int8_full"):
        raise NotImplementedError(
            f"serving dtype {dtype!r} is not ported yet (ROADMAP A.10: int8 "
            f"serving and QAT)")
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported serving dtype {dtype!r}")

    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x, train=False, dtype=dtype).clamp(0.0, 1.0)

    return forward


def pad_to_multiple(array: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the leading axis to a multiple by repeating the last element.
    Returns (padded, valid_count)."""
    n = array.shape[0]
    if n == 0:
        raise ValueError("pad_to_multiple: empty batch (0 rows)")
    rem = n % multiple
    if rem == 0:
        return array, n
    pad = np.repeat(array[-1:], multiple - rem, axis=0)
    return np.concatenate([array, pad], axis=0), n


class Predictor:
    """Serve a FaceEnhanceNet on one device.

    ``__call__(images)`` takes an NHWC float batch of any size and returns
    the clipped SR batch as float32 numpy. Every forward runs at
    ``max_batch`` images: larger requests are chunked, the last chunk is
    padded. The model is moved to ``device`` (CUDA unless named)."""

    def __init__(self, model: torch.nn.Module, dtype: ServingDtype = torch.bfloat16,
                 max_batch: int = 128, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.max_batch = max(1, int(max_batch))
        self.model = model.to(self.device).eval()
        self._forward = build_serving_fn(self.model, dtype)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images, np.float32)
        if len(images) == 0:
            raise ValueError("Predictor called with 0 images")
        outs = []
        for i in range(0, len(images), self.max_batch):
            chunk, valid = pad_to_multiple(images[i:i + self.max_batch],
                                           self.max_batch)
            x = torch.from_numpy(chunk).to(self.device)
            outs.append(self._forward(x)[:valid].float().cpu().numpy())
        return np.concatenate(outs, axis=0)


class MicroBatcher:
    """Coalesce concurrent single-image requests into one device batch.

    A background dispatcher collects requests for up to ``window_ms`` (or
    until ``max_batch`` same-shape images wait), runs ONE batched forward
    ``fn`` ([N,h,w,3] float32 -> [N,H,W,3]) and hands each caller its
    slice. Mixed shapes are grouped: each dispatch takes the same-shape
    cohort of the queue's head. If a batch fails, each of its images is
    retried alone so only the offending request sees the error."""

    def __init__(self, fn: Callable, max_batch: int = 8, window_ms: float = 5.0):
        self.fn = fn
        self.max_batch = max(1, int(max_batch))
        self.window = max(0.0, float(window_ms)) / 1000.0
        self.calls = 0   # batched forwards issued
        self.images = 0  # images served (images / calls = batching factor)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: list = []
        self._closed = False
        self._worker = threading.Thread(
            target=self._loop, daemon=True, name="facesr-torch-microbatcher")
        self._worker.start()

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """Submit one HWC image; blocks until its SR result is ready."""
        item = {"x": np.asarray(image), "out": None, "err": None,
                "done": threading.Event()}
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._pending.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._worker.join(timeout=5)

    def _take_cohort(self) -> list:
        shape = self._pending[0]["x"].shape
        cohort, rest = [], []
        for item in self._pending:
            if len(cohort) < self.max_batch and item["x"].shape == shape:
                cohort.append(item)
            else:
                rest.append(item)
        self._pending = rest
        return cohort

    def _run(self, batch: np.ndarray) -> np.ndarray:
        out = np.asarray(self.fn(batch))
        with self._lock:
            self.calls += 1
            self.images += len(batch)
        return out

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if self._closed and not self._pending:
                    return
                # linger up to the window for co-arriving same-shape requests
                deadline = time.monotonic() + self.window
                head_shape = self._pending[0]["x"].shape
                while not self._closed:
                    n_same = sum(1 for it in self._pending
                                 if it["x"].shape == head_shape)
                    remaining = deadline - time.monotonic()
                    if n_same >= self.max_batch or remaining <= 0:
                        break
                    self._cv.wait(remaining)
                cohort = self._take_cohort()
            try:
                out = self._run(np.stack([i["x"] for i in cohort]))
                for idx, item in enumerate(cohort):
                    item["out"] = out[idx]
            except Exception as batch_err:  # noqa: BLE001 — the dispatcher must keep serving
                for item in cohort:
                    if len(cohort) == 1:
                        item["err"] = batch_err
                        continue
                    try:
                        item["out"] = self._run(item["x"][None])[0]
                    except Exception as e:  # noqa: BLE001
                        item["err"] = e
            finally:
                for item in cohort:
                    item["done"].set()
