"""Single-card serving: a chunking predictor, a per-shape predictor and a
request micro-batcher.

Port of `facesr/parallel/serving.py` for one CUDA card:

- `build_serving_fn`: the serving precision dispatch of any model the
  port loads (FaceEnhanceNet, the transfer model, RRDBNet): f32, bf16
  (the group kernel in FaceEnhanceNet's trunk and the transfer head),
  ``int8`` (per-channel int8 weights, dequantized to bf16 once, the
  kernel trunk and head) and ``int8_full`` (s8 convs with per-image
  dynamic or calibrated static activation scales).
- `calibrated_qparams`, `load_calibrated_qparams`: calibrate static
  scales or restore them from a quant cache (a ``.fckpt`` the JAX
  package's `load_calibrated_qparams` reads too, pinned to its source
  weights by a hash), `per_model_quant_cache` (the API's and the demo's
  cache names) and `load_calibration_images` (PNG only).
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

import copy
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional, Union

import numpy as np
import torch

from facesr_torch.device import DeviceLike, resolve_device

__all__ = ["build_serving_fn", "pad_to_multiple", "Predictor", "SpatialPredictor",
           "MicroBatcher", "calibrated_qparams", "load_calibrated_qparams",
           "load_calibration_images", "per_model_quant_cache"]

ServingDtype = Optional[Union[torch.dtype, str]]


def per_model_quant_cache(quant_cache: Optional[str], model_name: str) -> Optional[str]:
    """The per-model quant-cache name of the API and the demo:
    ``<base>.<model_name lowercased, spaces to underscores>.fckpt``, or None
    without a base."""
    if not quant_cache:
        return None
    return f"{quant_cache}.{model_name.lower().replace(' ', '_')}.fckpt"


def load_calibration_images(calib_dir: str, size: int = 64, limit: int = 64) -> np.ndarray:
    """Up to ``limit`` images of ``calib_dir`` as an [N, size, size, 3]
    float batch in [0, 1], each resized with `cv_compat.resize_area` (cv2
    ``INTER_AREA``) when it is not size x size: the scales are per-site
    scalars, so the calibration shape need not be the serving shape.
    Files that do not decode are skipped (the port reads PNG only; JPEG is
    ROADMAP A.7.2), and the limit counts readable images."""
    from facesr_torch.data.cv_compat import resize_area
    from facesr_torch.data.dataset import _list_images
    from facesr_torch.data.png import PNGError, read_rgb

    imgs = []
    for p in _list_images(Path(calib_dir)):
        if len(imgs) >= limit:
            break
        try:
            rgb = read_rgb(p)
        except (PNGError, OSError) as e:
            print(f"Skipping calibration image {p.name}: {e}")
            continue
        if rgb.shape[:2] != (size, size):
            rgb = resize_area(rgb, (size, size))
        imgs.append(rgb.astype(np.float32) / 255.0)
    if not imgs:
        raise RuntimeError(f"No readable calibration images in {calib_dir}")
    return np.stack(imgs)


def load_calibrated_qparams(model: torch.nn.Module, cache_path: str,
                            require_weight_match: bool = True):
    """The calibrated int8 sites of a quant cache (`cli.export_quantized`,
    or the JAX package's), checked against this model's structure, on the
    model's device. The cache holds the hash of its source weights: a
    mismatch raises for serving, and with ``require_weight_match=False``
    (QAT's ``--qat-scales``: training moves the weights away from the
    calibration source on purpose) prints a note instead. Only the int8
    sites are taken from the cache; the float parameters are the model's."""
    from facesr_torch.ckpt.fckpt import load_quant_cache, params_fingerprint
    from facesr_torch.ckpt.weights import sites_from_jax_qtree

    tree, meta = load_quant_cache(cache_path)
    cached_fp = meta.get("params_sha256")
    if cached_fp is None:
        print(f"Warning: quant cache {cache_path} predates weight fingerprinting; "
              "cannot verify it matches this model's weights; re-export to silence this")
    elif cached_fp != params_fingerprint(model):
        if require_weight_match:
            raise ValueError(
                f"quant cache {cache_path} was calibrated from DIFFERENT weights than "
                "this model's (content hash mismatch); serving it would use the old "
                "model's int8 kernels: re-run calibration / cli.export_quantized for "
                "the current checkpoint")
        print(f"Note: {cache_path} was calibrated from different weights than the "
              "current model's (expected when pinning a QAT grid from an earlier "
              "checkpoint; the static scales remain the deployed serving grid)")
    return sites_from_jax_qtree(tree, model, where=f"quant cache {cache_path}")


def calibrated_qparams(model: torch.nn.Module, calibration: Optional[np.ndarray],
                       max_batch: int, cache_path: Optional[str] = None):
    """Quantize the model's conv kernels and calibrate static activation
    scales on ``calibration`` (an [N, H, W, 3] float batch; small images
    are fine, the scales are per-site scalars), running the bf16 int8_full
    forward ``max_batch`` images at a time on the model's device. An
    existing ``cache_path`` is loaded instead (`load_calibrated_qparams`);
    otherwise the result is written there."""
    from facesr_torch.ckpt.fckpt import save_quant_cache
    from facesr_torch.ops.quant import calibrate_act_scales

    if cache_path and os.path.exists(cache_path):
        return load_calibrated_qparams(model, cache_path)
    if calibration is None or len(np.atleast_1d(calibration)) == 0:
        raise ValueError(
            "calibrated_qparams needs calibration images (none given"
            + (f" and cache {cache_path!r} does not exist" if cache_path else "")
            + "): pass a [N,H,W,3] float batch; small images are fine, the scales are "
            "per-site scalars")
    calib = np.asarray(calibration, np.float32)
    n = max(1, min(max_batch, len(calib)))
    device = next(model.parameters()).device

    def forward(sites, batch):
        with torch.inference_mode():
            model(torch.from_numpy(np.ascontiguousarray(batch)).to(device), train=False,
                  dtype=torch.bfloat16, quant=sites)

    sites = calibrate_act_scales(model, forward,
                                 [calib[i:i + n] for i in range(0, len(calib), n)])
    if cache_path:
        save_quant_cache(cache_path, model, sites)
    return sites


def build_serving_fn(model: torch.nn.Module, dtype: ServingDtype = None,
                     calibration: Optional[np.ndarray] = None,
                     quant_cache: Optional[str] = None, max_batch: int = 8,
                     require_calibration: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """The serving precision dispatch: ``forward(x) -> clip(SR(x), 0, 1)``
    under ``torch.inference_mode``. dtype:

    - None or torch.float32: the f32 parity path;
    - torch.bfloat16: the bf16 forward (the group-kernel trunk);
    - "int8": weight-only: the conv sites are quantized to int8 with
      per-channel scales and dequantized to bf16 once, into a copy of the
      model that the bf16 forward (kernel trunk included) serves; the
      sites never change after this call, so no forward repeats that;
    - "int8_full": s8 x s8 -> s32 convs at every site, in a bf16 forward
      through the plain trunk. With ``calibration`` images or an existing
      ``quant_cache`` the activation scales are static (the cache is
      written when calibrating); otherwise per-image dynamic. A named but
      missing cache without images raises with ``require_calibration``
      and goes dynamic without it.

    ``calibration``/``quant_cache`` under another dtype print a warning and
    are ignored. The forward's ``sites`` attribute holds the int8 sites
    (None for the float dtypes). Every family serves in every dtype."""
    if dtype not in (None, torch.float32, torch.bfloat16, "int8", "int8_full"):
        raise ValueError(f"unsupported serving dtype {dtype!r}")
    if dtype != "int8_full" and (calibration is not None or quant_cache):
        print(f"Warning: calibration/quant_cache only apply to dtype='int8_full' "
              f"(got dtype={dtype!r}); ignoring them")
    sites = None
    if dtype == "int8":
        from facesr_torch.ops.quant import dequantize_pytree, quantize_conv_kernels

        sites = quantize_conv_kernels(model)
        served = copy.deepcopy(model)
        if hasattr(served, "_kernel_weights"):
            # the copy prepares its own kernel-layout weights from the
            # dequantized ones, never the original's cached layout
            served._kernel_weights = None
        with torch.no_grad():
            for name, w in dequantize_pytree(sites, torch.bfloat16).items():
                served.get_parameter(f"{name}.weight").copy_(w)

        def forward(x: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return served(x, train=False, dtype=torch.bfloat16).clamp(0.0, 1.0)
    elif dtype == "int8_full":
        from facesr_torch.ops.quant import quantize_conv_kernels

        if (calibration is not None or (quant_cache and os.path.exists(quant_cache))
                or (quant_cache and require_calibration)):
            # the last arm lets calibrated_qparams raise on the missing cache
            # instead of serving dynamic scales under the cache's name
            sites = calibrated_qparams(model, calibration, max_batch, cache_path=quant_cache)
        else:
            sites = quantize_conv_kernels(model)

        def forward(x: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return model(x, train=False, dtype=torch.bfloat16,
                             quant=sites).clamp(0.0, 1.0)
    else:
        def forward(x: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return model(x, train=False, dtype=dtype).clamp(0.0, 1.0)

    forward.sites = sites
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
    """Serve a model on one device (FaceEnhanceNet, a transfer model or an
    RRDBNet, in any dtype of `build_serving_fn`).

    ``__call__(images)`` takes an NHWC float batch of any size and returns
    the clipped SR batch as float32 numpy. Requests larger than
    ``max_batch`` are chunked; every chunk runs at its true size, so a
    lone image pays a batch-1 forward, and the JAX class's
    ``remainder_sizes`` (extra compiled sizes for a request's last chunk)
    have no counterpart. The model is moved to ``device`` (CUDA unless
    named). ``dtype`` and the calibration arguments are those of
    `build_serving_fn`.

    On a card, each chunk is copied up from pinned host memory, and its
    result is copied down on a side stream straight into one pinned
    output buffer, which the returned array views: chunk i+1 is uploaded
    and run while chunk i downloads, and a chunk is waited for once two
    newer ones are in flight (the JAX class's depth-2 pipeline). Each call
    takes its own pinned buffers and stream, so concurrent callers (the
    HTTP server's threads) share nothing; the result is returned only
    after every download's event has completed."""

    def __init__(self, model: torch.nn.Module, dtype: ServingDtype = torch.bfloat16,
                 max_batch: int = 128, device: DeviceLike = None,
                 calibration: Optional[np.ndarray] = None, quant_cache: Optional[str] = None):
        self.device = resolve_device(device)
        self.max_batch = max(1, int(max_batch))
        self.model = model.to(self.device).eval()
        self._forward = build_serving_fn(self.model, dtype, calibration=calibration,
                                         quant_cache=quant_cache, max_batch=self.max_batch)

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
    splitting over several cards is ROADMAP A.13. The int8 dtypes serve as
    in `Predictor`; calibration forwards run one image at a time (pass
    small calibration images: the scales are per-site scalars)."""

    def __init__(self, model: torch.nn.Module, mesh=None,
                 dtype: ServingDtype = torch.bfloat16, device: DeviceLike = None,
                 calibration: Optional[np.ndarray] = None, quant_cache: Optional[str] = None):
        if mesh is not None:
            raise NotImplementedError(
                "SpatialPredictor over a mesh of cards is not ported yet (ROADMAP "
                "A.13: parallelism); with mesh=None one card serves every H")
        super().__init__(model, dtype=dtype, max_batch=1, device=device,
                         calibration=calibration, quant_cache=quant_cache)

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
