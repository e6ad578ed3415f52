"""Copies of the two OpenCV uint8 functions the input pipeline calls, in
numpy, so the port needs no cv2:

- `resize_cubic`: ``cv2.resize(img, (w, h), interpolation=INTER_CUBIC)``
  (the JAX package's HR-only LR synthesis and the fast loader's upscale of
  undersized images);
- `rgb_to_hsv` / `hsv_to_rgb`: ``cv2.cvtColor`` ``RGB2HSV`` /
  ``HSV2RGB`` on uint8 (the colour jitter; H in [0, 180)).

Both follow the arithmetic of the OpenCV these were held against
(5.0, x86-64): the resize's separable Keys kernel (a = -0.75) at
half-pixel centres with a replicated border, positions and weights in
f64 rounded to f32, an f32 horizontal then vertical pass and a
round-half-even to uint8; RGB2HSV's integer division tables with 12-bit
shifts; HSV2RGB through f32 H, S, V with ``1 - s*h`` fused (one
rounding), truncated to uint8 in whole vectors of 32 pixels (its AVX2
path) and rounded half to even in the rest of a row (its scalar tail).
RGB2HSV and HSV2RGB match it on every input; the resize matches it
exactly at the x1/4 downscale and within 1 elsewhere (tests/
test_torch_data.py prints the counts).
"""

from __future__ import annotations

import numpy as np

__all__ = ["resize_cubic", "rgb_to_hsv", "hsv_to_rgb"]


def _taps(dst: int, src: int):
    """(first source index of the 4 taps [dst], f32 weights [dst, 4]) of
    one axis."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f)
    x = f - s
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    return s.astype(np.int64) - 1, np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)


def resize_cubic(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_CUBIC)`` for an
    [H, W] or [H, W, C] uint8 image; ``size`` is (width, height) as cv2
    takes it."""
    if img.dtype != np.uint8:
        raise ValueError(f"resize_cubic takes uint8, got {img.dtype}")
    squeeze = img.ndim == 2
    src = img[:, :, None] if squeeze else img
    h, w, _ = src.shape
    dw, dh = int(size[0]), int(size[1])
    if dw <= 0 or dh <= 0:
        raise ValueError(f"bad size {size}")
    x0, wx = _taps(dw, w)
    y0, wy = _taps(dh, h)
    cols = np.clip(x0[:, None] + np.arange(4), 0, w - 1)   # [dw, 4]
    g = src.astype(np.float32)[:, cols, :]                # [h, dw, 4, c]
    buf = g[:, :, 0] * wx[None, :, 0, None]
    for k in (1, 2, 3):
        buf = buf + g[:, :, k] * wx[None, :, k, None]
    rows = np.clip(y0[:, None] + np.arange(4), 0, h - 1)  # [dh, 4]
    t = buf[rows]                                         # [dh, 4, dw, c]
    acc = t[:, 0] * wy[:, 0, None, None]
    for k in (1, 2, 3):
        acc = acc + t[:, k] * wy[:, k, None, None]
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out[:, :, 0] if squeeze else out


_HSV_SHIFT = 12


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    # saturate_cast<int>(double): round half to even
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of an [..., 3] uint8 image
    (H in [0, 180))."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"rgb_to_hsv takes [..., 3] uint8, got {img.shape} {img.dtype}")
    rgb = img.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# pixels a vector step of OpenCV's HSV2RGB on uint8 (its AVX2 build)
_HSV_LANES = 32
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)`` of an [..., 3] uint8 image
    (H in [0, 180))."""
    if img.dtype != np.uint8 or img.shape[-1] != 3:
        raise ValueError(f"hsv_to_rgb takes [..., 3] uint8, got {img.shape} {img.dtype}")
    f32 = np.float32
    h = img[..., 0].astype(f32)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = h * f32(6.0 / 180.0)
    pre = np.trunc(h)
    h = h - pre
    sector = (pre - np.trunc(pre * f32(1.0 / 6.0)) * f32(6.0)).astype(np.int64)
    one = f32(1.0)

    def one_minus(a, b):  # 1 - a*b with one rounding (a fused multiply-add)
        return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(f32)

    tab = np.stack([v, v * (one - s), v * one_minus(s, h), v * one_minus(s, one - h)],
                   axis=-1)
    idx = _SECTORS[sector]                                            # [..., 3] (b, g, r)
    bgr = np.take_along_axis(tab, idx, axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    rgb = bgr[..., ::-1] * f32(255.0)
    # each row's first whole runs of _HSV_LANES pixels take the vector path,
    # which truncates; the rest of the row the scalar path, which rounds
    width = rgb.shape[-2] if rgb.ndim >= 2 else 1
    vec = np.arange(width) < width // _HSV_LANES * _HSV_LANES
    out = np.where(vec[:, None], np.trunc(rgb), np.rint(rgb))
    return np.clip(out, 0, 255).astype(np.uint8)
