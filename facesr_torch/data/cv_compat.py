"""Copies of the OpenCV uint8 functions the input pipeline and the
evaluation CLIs call, in numpy, so the port needs no cv2:

- `resize_cubic`: ``cv2.resize(img, (w, h), interpolation=INTER_CUBIC)``
  (the JAX package's HR-only LR synthesis, the fast loader's upscale of
  undersized images and the evaluation's bicubic baseline);
- `resize_linear`, `resize_lanczos4`, `resize_nearest`: ``INTER_LINEAR``,
  ``INTER_LANCZOS4`` and ``INTER_NEAREST`` (the evaluation's baselines
  and comparison strips); `resize` picks one by name;
- `resize_area`: ``INTER_AREA`` on uint8 and float32 (the demo's and the
  API's input sizing);
- `rgb_to_hsv` / `hsv_to_rgb`: ``cv2.cvtColor`` ``RGB2HSV`` /
  ``HSV2RGB`` on uint8 (the colour jitter; H in [0, 180));
- `resize_linear_float`: ``cv2.resize(img, (w, h))`` (``INTER_LINEAR``) on
  float32, and `apply_colormap_jet`: ``cv2.applyColorMap(u8,
  COLORMAP_JET)`` then ``COLOR_BGR2RGB`` (the explainability heatmaps);
- `gaussian_blur`: ``cv2.GaussianBlur(img, (k, k), sigma)`` with the
  default ``BORDER_REFLECT_101``, on uint8 (the realistic degradation of
  `data.prepare_data`) and on float32 at 3x3 (the synthetic faces).

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

The float32 linear resize follows IPP's: source positions ``(i + 0.5) *
src / dst - 0.5`` in f64, their fractions rounded to f32, both taps
clamped to the image, and each pass a fused ``s0 + (s1 - s0) * t``,
horizontal first. It matches cv2 bitwise on every source of at least 2x2
pixels tried (a source one pixel wide or high takes another path in cv2).
The Gaussian blur builds OpenCV's bit-exact kernel (``softdouble``: the
weights exp(-x^2 / (2 sigma^2)) normalised by the reciprocal of their
sum; sigma <= 0 takes the fixed 3/5/7 tables or 0.3 ((k - 1) / 2 - 1) +
0.8). On uint8 it takes OpenCV's fixed-point path: the weights times 2^8
rounded with error diffusion from the outside in (the centre takes the
rest, so they sum to 256), an exact integer row pass, an exact column
pass and ``(sum + 2^15) >> 16``; bitwise cv2's on every size and kernel
tried. On float32 (3x3 only) the weights are rounded to f32 and each
pass is the symmetric small filter: the row pass ``fma(c, k0, (l + r) *
k1)`` (in a row of odd length its last value ``fma(l + r, k1, c * k0)``,
the scalar tail), the column pass ``fma(u + d, k1, c * k0)``; bitwise on
every size tried.
JET is OpenCV's own construction: the piecewise-linear basemap sampled at
i / 255 and stored in f32, resampled by ``interp1`` at an f32
``linspace(0, 1, 256)`` (every point is interpolated from its left
neighbour, in f32) and converted with ``round(v * 255)``; all 256 levels
equal cv2's.
"""

from __future__ import annotations

import functools
import math

import numpy as np

__all__ = ["resize", "resize_area", "resize_cubic", "resize_linear", "resize_lanczos4",
           "resize_nearest", "rgb_to_hsv", "hsv_to_rgb", "resize_linear_float",
           "apply_colormap_jet", "JET_RGB", "gaussian_blur"]


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
    out = _linear_vertical(_horizontal(src, dw, "linear"),
                           *_fixed_taps(dh, src.shape[0], "linear", False))
    return out[:, :, 0] if img.ndim == 2 else out


def _linear_vertical(buf: np.ndarray, idx: np.ndarray, w: np.ndarray) -> np.ndarray:
    """OpenCV's SIMD vertical pass of the 8-bit linear resize over the
    horizontal pass ``buf`` (scaled by 2^11): each row >> 4, times its
    weight keeping the high 16 bits, the two added and rounded at bit 2."""
    s0, s1 = buf[idx[:, 0]] >> 4, buf[idx[:, 1]] >> 4
    t = ((s0 * w[:, 0, None, None]) >> 16) + ((s1 * w[:, 1, None, None]) >> 16)
    return np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)


def _float_taps(dst: int, src: int):
    """(first tap [dst], second tap [dst], f32 fraction [dst]) of one axis
    of the float linear resize, both taps clamped to the image."""
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(pos)
    frac = (pos - s).astype(np.float32)
    s = s.astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), frac


def resize_linear_float(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size)`` (``INTER_LINEAR``) for an [H, W] or [H, W,
    C] float32 image; ``size`` is (width, height)."""
    if img.dtype != np.float32 or img.ndim not in (2, 3):
        raise ValueError(f"resize_linear_float takes an [H, W] or [H, W, C] float32 image, "
                         f"got {img.shape} {img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    if dw <= 0 or dh <= 0:
        raise ValueError(f"bad size {size}")
    src = img[:, :, None] if img.ndim == 2 else img
    x0, x1, fx = _float_taps(dw, src.shape[1])
    y0, y1, fy = _float_taps(dh, src.shape[0])
    buf = _fma(src[:, x1] - src[:, x0], fx[None, :, None], src[:, x0])
    out = _fma(buf[y1] - buf[y0], fy[:, None, None], buf[y0])
    return out[:, :, 0] if img.ndim == 2 else out


def _jet_rgb() -> np.ndarray:
    f32 = np.float32
    x = np.arange(256, dtype=np.float64) / 255.0
    # OpenCV's basemap: red, green, blue ramps of slope 4 capped to [0, 1]
    base = [np.clip(np.minimum(4 * x + lo, -4 * x + hi), 0, 1).astype(f32)
            for lo, hi in ((-1.5, 4.5), (-0.5, 3.5), (0.5, 2.5))]
    step = f32(1) / f32(255)
    xs = f32(0) + np.arange(256, dtype=f32) * step  # OpenCV's f32 linspace
    lo = np.maximum(np.arange(256) - 1, 0)
    hi = lo + 1
    out = []
    for y in base:
        # interp1 at the table's own points: each from its left neighbour
        v = y[lo] + ((xs - xs[lo]) * (y[hi] - y[lo])) / (xs[hi] - xs[lo])
        out.append(np.rint(v * f32(255)))
    table = np.stack(out, axis=1).astype(np.uint8)
    table.setflags(write=False)
    return table


JET_RGB = _jet_rgb()  # the 256-entry RGB table of apply_colormap_jet


def apply_colormap_jet(gray: np.ndarray) -> np.ndarray:
    """``cvtColor(applyColorMap(gray, COLORMAP_JET), COLOR_BGR2RGB)`` for an
    [H, W] uint8 image: [H, W, 3] uint8 RGB."""
    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError(f"apply_colormap_jet takes an [H, W] uint8 image, got "
                         f"{gray.shape} {gray.dtype}")
    return JET_RGB[gray]


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


_DBL_EPSILON = 2.220446049250313e-16
_F32_LANES = 4  # f32 lanes of OpenCV's baseline (SSE3) vector code


def _area_integer(src: np.ndarray, kx: int, ky: int) -> np.ndarray:
    """The integer-factor box path: each output the sum of its kx x ky
    block (row-major) times the f32 ``1 / area``, rounded half to even to
    uint8; uint8 at 2x2 takes ``(sum + 2) >> 2``. f32 sums groups of four
    left to right, and its one-channel 2x2 vector lanes ``(a + b) + (c +
    d)``."""
    h, w, c = src.shape
    dh, dw, area = h // ky, w // kx, kx * ky
    taps = src.reshape(dh, ky, dw, kx, c).transpose(0, 2, 4, 1, 3).reshape(dh, dw, c, area)
    if src.dtype == np.uint8:
        total = taps.astype(np.int64).sum(axis=-1)
        if area == 4 and kx == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        v = total.astype(np.float32) * np.float32(1.0 / area)
        return np.clip(np.rint(v), 0, 255).astype(np.uint8)
    total = None
    for k in range(0, area - area % 4, 4):
        group = ((taps[..., k] + taps[..., k + 1]) + taps[..., k + 2]) + taps[..., k + 3]
        total = group if total is None else total + group
    for k in range(area - area % 4, area):
        total = taps[..., k] if total is None else total + taps[..., k]
    out = total * np.float32(1.0 / area)
    if area == 4 and kx == 2 and c == 1:
        lanes = dw - dw % _F32_LANES
        pair = ((taps[..., 0] + taps[..., 1]) + (taps[..., 2] + taps[..., 3])) * np.float32(0.25)
        out[:, :lanes] = pair[:, :lanes]
    return out


@functools.lru_cache(maxsize=64)
def _area_weights(src: int, dst: int):
    """OpenCV's ``computeResizeAreaTab`` of one axis as dense arrays:
    (source index, f32 weight, valid) [dst, m], each output's entries in
    OpenCV's order."""
    scale = 1.0 / (dst / src)
    cells = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        width = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        cell = []
        if s1 - f1 > 1e-3:
            cell.append((s1 - 1, (s1 - f1) / width))
        cell += [(s, 1.0 / width) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            cell.append((s2, min(min(f2 - s2, 1.0), width) / width))
        cells.append(cell)
    m = max(len(cell) for cell in cells)
    idx = np.zeros((dst, m), np.int64)
    wt = np.zeros((dst, m), np.float32)
    valid = np.zeros((dst, m), bool)
    for d, cell in enumerate(cells):
        for j, (s, a) in enumerate(cell):
            idx[d, j], wt[d, j], valid[d, j] = s, a, True
    return idx, wt, valid


def _area_fractional(src: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """The fractional downscale: f32 area weights, a horizontal sum of
    ``S * alpha`` in entry order, then a vertical one of ``beta * row``."""
    h, w, c = src.shape
    xi, xw, xv = _area_weights(w, dw)
    yi, yw, yv = _area_weights(h, dh)
    s = src.astype(np.float32)
    buf = np.zeros((h, dw, c), np.float32)
    for j in range(xi.shape[1]):
        buf = np.where(xv[None, :, j, None], buf + s[:, xi[:, j]] * xw[None, :, j, None], buf)
    acc = yw[:, 0, None, None] * buf[yi[:, 0]]
    for j in range(1, yi.shape[1]):
        acc = np.where(yv[:, j, None, None], acc + yw[:, j, None, None] * buf[yi[:, j]], acc)
    if src.dtype == np.uint8:
        return np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return acc


def _area_linear_taps(dst: int, src: int, clamp: bool):
    """(source indices [dst, 2], f32 weights [dst, 2]) of the linear
    resize OpenCV runs for an area upscale: position ``floor(i * scale)``,
    fraction ``(i + 1) - (s + 1) / scale`` wrapped to [0, 1). ``clamp``
    pins the last column's fraction to 0 (x only, as for linear)."""
    inv = dst / src
    d = np.arange(dst)
    s = np.floor(d * (1.0 / inv)).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    if clamp:
        f = np.where(s >= src - 1, np.float32(0), f)
        s = np.minimum(s, src - 1)
    idx = np.clip(s[:, None] + np.arange(2), 0, src - 1)
    return idx, np.stack([np.float32(1) - f, f], axis=1)


def _area_upscale(src: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """An upscale along either axis: OpenCV's linear resize (uint8 in its
    11-bit fixed point, f32 as two products and a sum) with area-style
    coefficients."""
    xi, xw = _area_linear_taps(dw, src.shape[1], True)
    yi, yw = _area_linear_taps(dh, src.shape[0], False)
    if src.dtype == np.uint8:
        one = np.float32(1 << _COEF_BITS)
        xw_i, yw_i = (np.rint(t * one).astype(np.int64) for t in (xw, yw))
        buf = np.einsum("hdkc,dk->hdc", src.astype(np.int64)[:, xi, :], xw_i)
        return _linear_vertical(buf, yi, yw_i)
    g = src[:, xi, :]
    buf = g[:, :, 0] * xw[None, :, 0, None] + g[:, :, 1] * xw[None, :, 1, None]
    return buf[yi[:, 0]] * yw[:, 0, None, None] + buf[yi[:, 1]] * yw[:, 1, None, None]


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)`` for an
    [H, W] or [H, W, C] (C 1 or 3) uint8 or float32 image; ``size`` is
    (width, height); one channel comes back [H, W], as from cv2. OpenCV's three paths: an integer factor on both axes
    (box sums), another downscale (area weights) and an upscale along
    either axis (linear with area coefficients). cv2 runs its own code
    here with IPP on or off (IPP's area resize is not bit-exact, so
    OpenCV leaves it off)."""
    if img.dtype not in (np.uint8, np.float32) or img.ndim not in (2, 3) \
            or (img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"resize_area takes an [H, W] or [H, W, 1|3] uint8 or float32 "
                         f"image, got {img.shape} {img.dtype}")
    src = img[:, :, None] if img.ndim == 2 else img
    h, w = src.shape[:2]
    dw, dh = int(size[0]), int(size[1])
    if dw <= 0 or dh <= 0:
        raise ValueError(f"bad size {size}")
    scale_x, scale_y = 1.0 / (dw / w), 1.0 / (dh / h)
    if scale_x >= 1 and scale_y >= 1:
        kx, ky = round(scale_x), round(scale_y)
        if abs(scale_x - kx) < _DBL_EPSILON and abs(scale_y - ky) < _DBL_EPSILON:
            out = _area_integer(src, kx, ky)
        else:
            out = _area_fractional(src, dw, dh)
    else:
        out = _area_upscale(src, dw, dh)
    return out[:, :, 0] if out.shape[2] == 1 else out  # cv2 drops a single channel


_RESIZES = {"linear": resize_linear, "cubic": resize_cubic, "lanczos4": resize_lanczos4,
            "nearest": resize_nearest}


def resize(img: np.ndarray, size, interpolation: str) -> np.ndarray:
    """``cv2.resize`` with ``interpolation`` one of "linear", "cubic",
    "lanczos4", "nearest" (``INTER_*``) on uint8."""
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


_SMALL_GAUSSIANS = {1: (1.0,), 3: (0.25, 0.5, 0.25), 5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
                    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125)}


def _gaussian_kernel(k: int, sigma: float) -> np.ndarray:
    """OpenCV's bit-exact Gaussian kernel of odd size ``k`` (f64)."""
    if k <= 0 or k % 2 == 0:
        raise ValueError(f"the kernel size must be odd and positive, got {k}")
    if sigma <= 0:
        if k in _SMALL_GAUSSIANS:
            return np.array(_SMALL_GAUSSIANS[k])
        sigma = ((k - 1) * 0.5 - 1) * 0.3 + 0.8
    scale = -0.125 / (sigma * sigma)
    half = (k - 1) // 2
    vals = [math.exp(float(x * x) * scale) for x in range(1 - k, -1, 2)][:half]
    inv = 1.0 / (sum(vals) * 2 + 1.0)
    out = np.empty(k)
    for i, v in enumerate(vals):
        out[i] = out[k - 1 - i] = v * inv
    out[half] = inv
    return out


def _fixed_gaussian(k: int, sigma: float) -> np.ndarray:
    """The uint8 path's integer weights (x 2^8, error-diffused, sum 256)."""
    kern = _gaussian_kernel(k, sigma)
    err, out, total = 0.0, np.zeros(k, np.int64), 0
    for i in range(k // 2):
        adj = kern[i] * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[k - 1 - i] = v
        total += v
    out[k // 2] = 256 - 2 * total
    return out


def _reflect101(n: int, r: int) -> np.ndarray:
    """[n, 2r + 1] source indices of each position's taps, reflected at
    the borders without repeating the edge (``BORDER_REFLECT_101``)."""
    idx = np.abs(np.arange(n)[:, None] + np.arange(-r, r + 1)[None])
    if n == 1:
        return np.zeros_like(idx)
    while (idx >= n).any() or (idx < 0).any():
        idx = np.abs(np.where(idx >= n, 2 * (n - 1) - idx, idx))
    return idx


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` for an [H, W] or
    [H, W, C] uint8 image (any odd size) or float32 image (3x3)."""
    if img.ndim not in (2, 3):
        raise ValueError(f"gaussian_blur takes an [H, W] or [H, W, C] image, got {img.shape}")
    src = img[:, :, None] if img.ndim == 2 else img
    h, w, c = src.shape
    r = ksize // 2
    cols, rows = _reflect101(w, r), _reflect101(h, r)
    if img.dtype == np.uint8:
        wt = _fixed_gaussian(ksize, sigma)
        row = np.einsum("hxkc,k->hxc", src.astype(np.int64)[:, cols], wt)
        out = np.einsum("ykxc,k->yxc", row[rows], wt)
        out = ((out + (1 << 15)) >> 16).astype(np.uint8)
    elif img.dtype == np.float32:
        if ksize != 3:
            raise ValueError(f"gaussian_blur takes float32 at 3x3 only, got {ksize}x{ksize}")
        k1, k0 = _gaussian_kernel(3, sigma).astype(np.float32)[:2]
        g = src[:, cols]                                      # [h, w, 3, c]
        row = _fma(g[:, :, 1], k0, (g[:, :, 0] + g[:, :, 2]) * k1)
        if (w * c) % 2:  # OpenCV's row pass computes an odd row's last value apart
            last = _fma(g[:, -1, 0, -1] + g[:, -1, 2, -1], k1, g[:, -1, 1, -1] * k0)
            row[:, -1, -1] = last
        t = row[rows]                                         # [h, 3, w, c]
        out = _fma(t[:, 0] + t[:, 2], k1, t[:, 1] * k0)
    else:
        raise ValueError(f"gaussian_blur takes uint8 or float32, got {img.dtype}")
    return out[:, :, 0] if img.ndim == 2 else out
