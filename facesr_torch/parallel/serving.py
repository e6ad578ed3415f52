"""Single-card serving: a chunking predictor, a per-shape predictor and a
request micro-batcher.

Port of `facesr/parallel/serving.py` for one CUDA card:

- `build_serving_fn`: the serving precision dispatch (f32 or bf16; the
  int8 modes are not ported yet).
- `pad_to_multiple`: the JAX module's batch-padding helper (the port's
  predictors run every chunk at its true size and do not pad).
- `Predictor`: the single-card counterpart of the JAX ``ShardedPredictor``
  — chunks a request at ``max_batch`` and runs each chunk at its true
  size (eager PyTorch keeps no compiled batch shape, and the group kernel
  masks any N), clips to [0, 1] and returns numpy. On a card the copies
  go through pinned host memory and the chunks are pipelined at depth 2.
- `SpatialPredictor`: one forward per call at the input's own shape (the
  JAX class splits rows over a mesh; on one card it is a per-shape
  forward).
- `MicroBatcher`: coalesces concurrent single-image requests into one
  batched forward (an own copy of the JAX package's threading logic).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Union

import numpy as np
import torch

from facesr_torch.device import DeviceLike, resolve_device

__all__ = ["build_serving_fn", "pad_to_multiple", "Predictor", "SpatialPredictor",
           "MicroBatcher"]

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
    the clipped SR batch as float32 numpy. Requests larger than
    ``max_batch`` are chunked; every chunk runs at its true size, so a
    lone image pays a batch-1 forward, and the JAX class's
    ``remainder_sizes`` (extra compiled sizes for a request's last chunk)
    have no counterpart. The model is moved to ``device`` (CUDA unless
    named).

    On a card, each chunk is copied up from pinned host memory, and its
    result is copied down on a side stream straight into one pinned
    output buffer, which the returned array views: chunk i+1 is uploaded
    and run while chunk i downloads, and a chunk is waited for once two
    newer ones are in flight (the JAX class's depth-2 pipeline). Each call
    takes its own pinned buffers and stream, so concurrent callers (the
    HTTP server's threads) share nothing; the result is returned only
    after every download's event has completed."""

    def __init__(self, model: torch.nn.Module, dtype: ServingDtype = torch.bfloat16,
                 max_batch: int = 128, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.max_batch = max(1, int(max_batch))
        self.model = model.to(self.device).eval()
        self._forward = build_serving_fn(self.model, dtype)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        return self._serve(images, self.max_batch)

    def _serve(self, images: np.ndarray, chunk: int) -> np.ndarray:
        images = np.asarray(images, np.float32)
        n = len(images)
        if n == 0:
            raise ValueError(f"{type(self).__name__} called with 0 images")
        cuda = self.device.type == "cuda"
        download = torch.cuda.Stream(self.device) if cuda else None
        out = None  # the whole result, pinned on a card
        in_flight: deque = deque()  # download events not yet waited for
        for start in range(0, n, chunk):
            x = torch.from_numpy(np.require(images[start:start + chunk], requirements="CW"))
            if cuda:
                x = x.pin_memory().to(self.device, non_blocking=True)
            y = self._forward(x)
            if out is None:
                out = torch.empty((n, *y.shape[1:]), dtype=torch.float32, pin_memory=cuda)
            dst = out[start:start + len(x)]
            if not cuda:
                dst.copy_(y)
                continue
            download.wait_stream(torch.cuda.current_stream(self.device))
            y.record_stream(download)  # y's memory is reused only after its copy
            with torch.cuda.stream(download):
                dst.copy_(y, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            in_flight.append(done)
            if len(in_flight) > 2:
                in_flight.popleft().synchronize()
        for done in in_flight:
            done.synchronize()
        return out.numpy()


class SpatialPredictor(Predictor):
    """Serve inputs of any H and W, one forward per call at the input's
    own shape: no padding and no chunking.

    The JAX class splits the image rows over a mesh of devices (halo
    exchanges by XLA's partitioner) and falls back to the largest device
    count that divides H. On one card that count is 1 for every H, so the
    class is a per-shape forward; large inputs reach the group kernel's
    scratch variant (W > 64, or H outside 8..64). A ``mesh`` raises: row
    splitting over several cards is ROADMAP A.13."""

    def __init__(self, model: torch.nn.Module, mesh=None,
                 dtype: ServingDtype = torch.bfloat16, device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "SpatialPredictor over a mesh of cards is not ported yet (ROADMAP "
                "A.13: parallelism); with mesh=None one card serves every H")
        super().__init__(model, dtype=dtype, max_batch=1, device=device)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """NHWC float batch (usually N=1) -> SR batch, one forward."""
        return self._serve(images, max(1, len(images)))


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
