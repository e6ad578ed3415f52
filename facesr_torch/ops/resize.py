"""Image resize with exact PyTorch `F.interpolate` semantics, NHWC.

Port of `facesr/ops/resize.py`: a separable resize is a linear map along
each spatial axis, so the per-axis interpolation matrices are built on
the host (numpy, float64 then float32) and contracted with the image as
two float32 matmuls — the model's global bicubic skip and the on-device
LR synthesis. Semantics: half-pixel source coordinates
(``align_corners=False``), Keys A=-0.75 cubic taps with index clamping,
no antialias.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from facesr_torch.parallel import spatial

__all__ = ["resize_matrix", "resize2d", "bicubic_resize", "bicubic_up",
           "bicubic_down", "nearest_up", "avg_pool2"]

# Keys cubic convolution constant used by PyTorch (and OpenCV) bicubic.
_A = -0.75


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """Cubic convolution weights of the 4 taps at offsets [-1, 0, +1, +2]
    around floor(src), for fractional offset t (PyTorch's
    `get_cubic_upsample_coefficients`)."""
    A = _A

    def k1(x):  # |x| <= 1
        return ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0

    def k2(x):  # 1 < |x| <= 2
        return ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A

    return np.stack([k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t)], axis=-1)


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, method: str = "bicubic") -> np.ndarray:
    """Dense [out_size, in_size] float32 interpolation matrix for one axis.

    bicubic: Keys A=-0.75, 4 taps, tap indices clamped at the borders;
    bilinear: the source coordinate clamped at 0; nearest: PyTorch's legacy
    floor(i * in/out). Cached: treat the result as read-only."""
    if method not in ("bicubic", "bilinear", "nearest"):
        raise ValueError(f"Unknown resize method: {method}")
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == out_size:
        np.fill_diagonal(mat, 1.0)
        return mat.astype(np.float32)

    scale = in_size / out_size
    i = np.arange(out_size, dtype=np.float64)
    rows = np.arange(out_size)
    if method == "bicubic":
        src = (i + 0.5) * scale - 0.5
        base = np.floor(src).astype(np.int64)
        w = _cubic_weights(src - base)  # [out, 4]
        for tap in range(4):
            idx = np.clip(base - 1 + tap, 0, in_size - 1)
            np.add.at(mat, (rows, idx), w[:, tap])
    elif method == "bilinear":
        src = np.maximum((i + 0.5) * scale - 0.5, 0.0)
        i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        t = src - i0
        np.add.at(mat, (rows, i0), 1.0 - t)
        np.add.at(mat, (rows, i1), t)
    else:  # nearest
        idx = np.minimum((i * scale).astype(np.int64), in_size - 1)
        mat[rows, idx] = 1.0
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _matrix(in_size: int, out_size: int, method: str,
            device: torch.device) -> torch.Tensor:
    """`resize_matrix` on ``device``, kept: a copy from pageable host memory
    waits for the card, so a copy per call would sync every step. Made
    outside inference mode, so an autograd forward may save it later, and
    outside any fake-tensor mode, so a `torch.export` trace takes it as a
    constant and the cache never keeps a fake tensor for later eager calls."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with torch.inference_mode(False), unset_fake_temporarily():
        return torch.from_numpy(resize_matrix(in_size, out_size, method)).to(device)


def resize2d(x: torch.Tensor, out_hw: Tuple[int, int],
             method: str = "bicubic") -> torch.Tensor:
    """Resize NHWC ``x`` to ``out_hw`` as two float32 contractions (rows,
    then columns); the result is cast back to ``x``'s dtype. The f32
    matmuls run in full f32 (PyTorch's default matmul precision)."""
    _, h, w, _ = x.shape
    out_h, out_w = out_hw
    xf = x.float()
    if out_h != h:
        xf = torch.einsum("oh,nhwc->nowc", _matrix(h, out_h, method, x.device), xf)
    if out_w != w:
        xf = torch.einsum("ow,nhwc->nhoc", _matrix(w, out_w, method, x.device), xf)
    return xf.to(x.dtype)


def bicubic_resize(x: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """`F.interpolate(x, scale_factor, mode='bicubic', align_corners=False)`
    on NHWC, up or down (no antialias)."""
    _, h, w, _ = x.shape
    out_h = int(np.floor(h * scale_factor))
    out_w = int(np.floor(w * scale_factor))
    return resize2d(x, (out_h, out_w), method="bicubic")


def bicubic_up(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-scale bicubic upsample (the model's global skip). Under a row
    shard ``x`` is the shard's rows: the whole image is gathered and the
    shard's output rows come from its rows of the row matrix."""
    shard = spatial.current()
    if shard is None:
        return bicubic_resize(x, float(scale))
    full = shard.gather(x)
    _, h, w, _ = full.shape
    a, b = shard.bounds(h)[shard.index]
    rows = _matrix(h, h * scale, "bicubic", x.device)[a * scale:b * scale]
    xf = torch.einsum("oh,nhwc->nowc", rows, full.float())
    xf = torch.einsum("ow,nhwc->nhoc", _matrix(w, w * scale, "bicubic", x.device), xf)
    return xf.to(x.dtype)


def bicubic_down(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-scale bicubic downsample (LR synthesis)."""
    return bicubic_resize(x, 1.0 / float(scale))


def nearest_up(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer-scale nearest upsample of NHWC ``x`` (the ESRGAN upsampling
    path): PyTorch's legacy 'nearest' at an integer scale is a pure
    repeat, a broadcast and a reshape here as in the JAX package (row-local
    under a row shard)."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, scale, w, scale, c)
    return x.reshape(n, h * scale, w * scale, c)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool on NHWC (MS-SSIM pyramid), dropping the
    trailing row/column of odd dims like `F.avg_pool2d(kernel_size=2)`.
    Row-local under a row shard (see `spatial.check_slab`)."""
    n, h, w, c = x.shape
    spatial.check_slab(h, 2, "avg_pool2")
    h2, w2 = h // 2, w // 2
    x = x[:, : h2 * 2, : w2 * 2, :]
    return x.reshape(n, h2, 2, w2, 2, c).mean(dim=(2, 4))
