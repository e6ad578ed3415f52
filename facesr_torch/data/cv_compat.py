"""Copies of the OpenCV uint8 functions the input pipeline and the
evaluation CLIs call, in numpy, so the port needs no cv2:

- `resize_cubic`: ``cv2.resize(img, (w, h), interpolation=INTER_CUBIC)``
  (the JAX package's HR-only LR synthesis, the fast loader's upscale of
  undersized images and the evaluation's bicubic baseline);
- `resize_linear`, `resize_lanczos4`, `resize_nearest`: ``INTER_LINEAR``,
  ``INTER_LANCZOS4`` and ``INTER_NEAREST`` (the evaluation's baselines
  and comparison strips); `resize` picks one by name;
- `rgb_to_hsv` / `hsv_to_rgb`: ``cv2.cvtColor`` ``RGB2HSV`` /
  ``HSV2RGB`` on uint8 (the colour jitter; H in [0, 180)).

These follow the arithmetic of the OpenCV they were held against (5.0,
x86-64, with Intel IPP). Its uint8 ``INTER_CUBIC`` runs through IPP's
float kernel (``cv2.ipp.setUseIPP(False)`` gives OpenCV's own 11-bit
fixed-point path and other values): the Keys kernel (a = -0.75) at
half-pixel centres with a replicated border, positions and weights in f64
rounded to f32, an f32 horizontal pass that sums the four taps by a chain
of fused multiply-adds, a vertical pass of two fused pairs ``fma(t0, w0,
t1*w1) + fma(t2, w2, t3*w3)`` and a round-half-even to uint8. It matches
cv2 on every case of the tests and at every x4/x2 upscale and x1/2, x1/4
downscale tried; at other ratios about 1 value in 100,000 lands one
level off, at sums within 1e-4 of a rounding midpoint, where IPP's
weights evidently differ from these in the last f32 bit
(tests/test_torch_data.py prints the counts). RGB2HSV's
integer division tables with 12-bit shifts; HSV2RGB through f32 H, S, V
with ``1 - s*h`` fused (one rounding), truncated to uint8 in whole vectors
of 32 pixels (its AVX2 path) and rounded half to even in the rest of a
row (its scalar tail). RGB2HSV and HSV2RGB match it on every input.

The linear and Lanczos-4 resizes follow OpenCV's 8-bit fixed point:
taps at f32 half-pixel positions, weights rounded to 11 bits
(x 2048), an exact integer horizontal pass. Lanczos-4 then sums the
vertical pass in integers and rounds at bit 22. Linear takes OpenCV's
SIMD vertical pass: each row >> 4 to int16, times the weight keeping the
high 16 bits, the two terms added and rounded at bit 2. Linear clamps a
border column's position (weight 0 on the outside tap) but not a border
row's (both taps read the edge row with their own weights). Nearest
takes ``floor(i * src / dst)``. All three match it on every input tried
(the tests print the counts).
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["resize", "resize_cubic", "resize_linear", "resize_lanczos4",
           "resize_nearest", "rgb_to_hsv", "hsv_to_rgb"]


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
    # horizontal: a chain of fused multiply-adds over the taps in order
    buf = g[:, :, 0] * wx[None, :, 0, None]
    for k in (1, 2, 3):
        buf = _fma(g[:, :, k], wx[None, :, k, None], buf)
    rows = np.clip(y0[:, None] + np.arange(4), 0, h - 1)  # [dh, 4]
    t = buf[rows]                                         # [dh, 4, dw, c]
    wy = wy[:, :, None, None]
    # vertical: two fused pairs, then their sum
    acc = (_fma(t[:, 0], wy[:, 0], t[:, 1] * wy[:, 1])
           + _fma(t[:, 2], wy[:, 2], t[:, 3] * wy[:, 3]))
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out[:, :, 0] if squeeze else out


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` of f32 arrays with one rounding to f32: the product is
    exact in f64 and the sum is rounded twice only where it lies within
    2^-53 of an f32 rounding midpoint."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _positions(dst: int, src: int):
    """(floor, f32 fraction) of OpenCV's source position of each output
    index: ``(float)((i + 0.5) * scale - 0.5)``, scale = 1 / (dst / src)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def _lanczos4_weights(x: float) -> list:
    """OpenCV's ``interpolateLanczos4`` for one f32 fraction: sines in
    f64, the 8 weights in f32, normalised by the f32 reciprocal of their
    f32 sum."""
    s45 = 0.70710678118654752440084436210485
    cs = ((1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45), (0, -1), (-s45, s45))
    f32 = np.float32
    y0 = -float(f32(x) + f32(3)) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs, total = [], f32(0)
    for i in range(8):
        yi = f32(f32(x) + f32(3 - i))
        if abs(yi) >= 1e-6:
            y = -float(yi) * math.pi * 0.25
            c = f32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y))
        else:
            c = f32(1e30)
        coeffs.append(c)
        total = f32(total + c)
    inv = f32(f32(1) / total)
    return [f32(c * inv) for c in coeffs]


@functools.lru_cache(maxsize=64)
def _fixed_taps(dst: int, src: int, kind: str, clamp: bool):
    """(source indices [dst, k], int weights [dst, k] scaled by 2^11) of
    one axis. ``clamp`` pins a linear border tap's fraction to 0 (OpenCV
    does so along x only)."""
    s, fx = _positions(dst, src)
    if kind == "linear":
        if clamp:
            fx = np.where((s < 0) | (s >= src - 1), np.float32(0), fx)
            s = np.clip(s, 0, src - 1)
        w = np.stack([np.float32(1) - fx, fx], axis=1)
        first = s
    else:  # lanczos4
        w = np.array([_lanczos4_weights(x) for x in fx], np.float32)
        first = s - 3
    idx = np.clip(first[:, None] + np.arange(w.shape[1]), 0, src - 1)
    return idx, np.rint(w * np.float32(1 << _COEF_BITS)).astype(np.int64)


def _check(img: np.ndarray, size, name: str):
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"{name} takes an [H, W] or [H, W, C] uint8 image, got "
                         f"{img.shape} {img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    if dw <= 0 or dh <= 0:
        raise ValueError(f"bad size {size}")
    return (img[:, :, None] if img.ndim == 2 else img), dw, dh


def _horizontal(src: np.ndarray, dw: int, kind: str) -> np.ndarray:
    """The exact integer horizontal pass, [h, dw, c] int64 scaled by 2^11."""
    idx, w = _fixed_taps(dw, src.shape[1], kind, True)
    g = src.astype(np.int64)[:, idx, :]                  # [h, dw, k, c]
    return np.einsum("hdkc,dk->hdc", g, w)


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` for an
    [H, W] or [H, W, C] uint8 image; ``size`` is (width, height)."""
    src, dw, dh = _check(img, size, "resize_linear")
    buf = _horizontal(src, dw, "linear")
    idx, w = _fixed_taps(dh, src.shape[0], "linear", False)
    s0, s1 = buf[idx[:, 0]] >> 4, buf[idx[:, 1]] >> 4
    t = ((s0 * w[:, 0, None, None]) >> 16) + ((s1 * w[:, 1, None, None]) >> 16)
    out = np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)
    return out[:, :, 0] if img.ndim == 2 else out


def resize_lanczos4(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LANCZOS4)`` for an
    [H, W] or [H, W, C] uint8 image; ``size`` is (width, height)."""
    src, dw, dh = _check(img, size, "resize_lanczos4")
    buf = _horizontal(src, dw, "lanczos4")
    idx, w = _fixed_taps(dh, src.shape[0], "lanczos4", False)
    acc = np.einsum("ykdc,yk->ydc", buf[idx], w)
    out = np.clip((acc + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS), 0, 255)
    out = out.astype(np.uint8)
    return out[:, :, 0] if img.ndim == 2 else out


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)`` for an
    [H, W] or [H, W, C] uint8 image; ``size`` is (width, height)."""
    src, dw, dh = _check(img, size, "resize_nearest")
    h, w = src.shape[:2]
    cols = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(np.int64), w - 1)
    rows = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(np.int64), h - 1)
    out = src[rows][:, cols]
    return out[:, :, 0] if img.ndim == 2 else out


_RESIZES = {"linear": resize_linear, "cubic": resize_cubic, "lanczos4": resize_lanczos4,
            "nearest": resize_nearest}


def resize(img: np.ndarray, size, interpolation: str) -> np.ndarray:
    """``cv2.resize`` with ``interpolation`` one of "linear", "cubic",
    "lanczos4", "nearest" (``INTER_*``)."""
    if interpolation not in _RESIZES:
        raise ValueError(f"unknown interpolation {interpolation!r}; one of {sorted(_RESIZES)}")
    return _RESIZES[interpolation](img, size)


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
