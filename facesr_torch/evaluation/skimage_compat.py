"""numpy copies of scikit-image's PSNR and SSIM as the evaluation CLIs call
them (uint8 images, ``data_range=255``).

Port of `facesr/evaluation/skimage_compat.py`, which reproduces skimage's
defaults: ``structural_similarity`` with a 7x7 uniform window, K1=0.01,
K2=0.03, the sample covariance (N/(N-1)), per-channel SSIM averaged over
channels (``channel_axis``), and only the windows that lie wholly inside
the image counted; ``peak_signal_noise_ratio`` as 10 log10(range^2/mse).

The uniform filter is a separable box sum in f64 by cumulative sums,
computed for the interior windows only (the ones skimage keeps), so no
border mode enters.
"""

from __future__ import annotations

import numpy as np

__all__ = ["peak_signal_noise_ratio", "structural_similarity"]


def peak_signal_noise_ratio(image_true: np.ndarray, image_test: np.ndarray,
                            data_range: float = 255.0) -> float:
    a = np.asarray(image_true, dtype=np.float64)
    b = np.asarray(image_test, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / mse))


def _box_mean(img: np.ndarray, win: int) -> np.ndarray:
    """The mean of every win x win window that lies inside ``img``
    ([H - win + 1, W - win + 1]): a running sum down the rows, then across
    the columns."""
    def down_rows(a: np.ndarray) -> np.ndarray:
        c = np.cumsum(a, axis=0)
        return np.concatenate([c[win - 1:win], c[win:] - c[:-win]], axis=0)

    return down_rows(down_rows(img).T).T / float(win * win)


def _ssim_single_channel(x: np.ndarray, y: np.ndarray, win: int,
                         data_range: float) -> float:
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    cov_norm = win * win / (win * win - 1)  # sample covariance (skimage default)

    ux = _box_mean(x, win)
    uy = _box_mean(y, win)
    uxx = _box_mean(x * x, win)
    uyy = _box_mean(y * y, win)
    uxy = _box_mean(x * y, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return float(((a1 * a2) / (b1 * b2)).mean())


def structural_similarity(im1: np.ndarray, im2: np.ndarray,
                          data_range: float = 255.0,
                          channel_axis: int | None = None,
                          win_size: int = 7) -> float:
    im1 = np.asarray(im1)
    im2 = np.asarray(im2)
    if channel_axis is None and im1.ndim == 3:
        # skimage would filter a 3-D input as a volume (7x7x7 windows)
        raise ValueError(
            "3-D input without channel_axis: pass channel_axis=-1 for "
            "multichannel SSIM (volumetric SSIM is not implemented)")
    if win_size < 3 or win_size % 2 == 0:
        # skimage raises on even windows, which would crop asymmetrically
        raise ValueError(f"win_size={win_size} must be an odd value >= 3")
    if channel_axis is not None:
        im1 = np.moveaxis(im1, channel_axis, -1)
        im2 = np.moveaxis(im2, channel_axis, -1)
    if min(im1.shape[0], im1.shape[1]) < win_size:
        # checked after moveaxis, so a CHW input is measured on its spatial
        # dims; skimage fails here too, where a mean of nothing would be NaN
        raise ValueError(
            f"win_size={win_size} exceeds image extent "
            f"{im1.shape[:2]}; use larger images or a smaller odd win_size")
    if channel_axis is not None:
        vals = [_ssim_single_channel(im1[..., c], im2[..., c], win_size, data_range)
                for c in range(im1.shape[-1])]
        return float(np.mean(vals))
    return _ssim_single_channel(im1, im2, win_size, data_range)
