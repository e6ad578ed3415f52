"""Differentiable SSIM / MS-SSIM for NHWC tensors.

Port of `facesr/losses/ssim.py`: an 11x11 gaussian window (sigma 1.5)
applied as a depthwise convolution with SAME zero padding, run as two
separable 1-D depthwise passes; K = (0.01, 0.03); variance via
E[x^2] - E[x]^2 (biased); MS-SSIM with the standard 5 scale weights over a
2x2 average-pool pyramid, per-scale cs means clamped at 0 (as the JAX
package does, so a negative mean cannot turn the product into NaN).

Always float32 with TF32 off (`conv2d` runs f32 convs under `full_f32`):
E[x^2] - E[x]^2 cancels catastrophically in reduced precision and drives
SSIM above 1.

Under a row shard (`parallel.spatial`) the gaussian's column pass takes its
halo rows from the neighbouring shards (`conv2d`) and every mean is over
the whole images, so the clamps and the MS-SSIM product act on the global
means; the pyramid's pools need shard heights divisible by 2 a level.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from facesr_torch.ops.conv import conv2d
from facesr_torch.ops.resize import avg_pool2
from facesr_torch.parallel.spatial import mean

__all__ = ["create_gaussian_window", "ssim", "ms_ssim", "ssim_loss", "ms_ssim_loss",
           "MS_SSIM_WEIGHTS"]

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian(window_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


@functools.lru_cache(maxsize=16)
def create_gaussian_window(window_size: int, sigma: float, channels: int) -> np.ndarray:
    """The full 2-D depthwise window, OIHW [C, 1, k, k] (for tests against
    the separable filter). Cached: treat the result as read-only."""
    g = _gaussian(window_size, sigma)
    w2d = np.outer(g, g).astype(np.float32)
    return np.ascontiguousarray(np.tile(w2d[None, None], (channels, 1, 1, 1)))


@functools.lru_cache(maxsize=16)
def _gaussian_1d(window_size: int, sigma: float, channels: int,
                 device: torch.device) -> torch.Tensor:
    """The 1-D factor of the window as a depthwise column kernel
    [C, 1, k, 1] on ``device``, kept so a step copies nothing to the card."""
    g = _gaussian(window_size, sigma).astype(np.float32)
    col = np.ascontiguousarray(np.tile(g[None, None, :, None], (channels, 1, 1, 1)))
    with torch.inference_mode(False):
        return torch.from_numpy(col).to(device)


def _filter(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Depthwise gaussian blur, SAME zero padding, as a column then a row
    pass (k + k taps instead of k * k)."""
    channels = x.shape[-1]
    g_col = _gaussian_1d(window_size, sigma, channels, x.device)
    pad = window_size // 2
    x = conv2d(x, g_col, padding=((pad, pad), (0, 0)), groups=channels)
    g_row = g_col.reshape(channels, 1, 1, window_size)
    return conv2d(x, g_row, padding=((0, 0), (pad, pad)), groups=channels)


def _ssim_components(pred: torch.Tensor, target: torch.Tensor, window_size: int,
                     sigma: float, c1: float, c2: float):
    """Windowed luminance and contrast-structure maps, in f32 whatever the
    inputs' dtype."""
    pred = pred.float()
    target = target.float()
    mu_p = _filter(pred, window_size, sigma)
    mu_t = _filter(target, window_size, sigma)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_pp = _filter(pred * pred, window_size, sigma) - mu_pp
    sigma_tt = _filter(target * target, window_size, sigma) - mu_tt
    sigma_pt = _filter(pred * target, window_size, sigma) - mu_pt
    luminance = (2 * mu_pt + c1) / (mu_pp + mu_tt + c1)
    cs = (2 * sigma_pt + c2) / (sigma_pp + sigma_tt + c2)
    return luminance, cs


def ssim(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, data_range: float = 1.0, size_average: bool = True,
         K: Tuple[float, float] = (0.01, 0.03)) -> torch.Tensor:
    """SSIM over NHWC images: the mean, or per image with
    ``size_average=False``."""
    c1 = (K[0] * data_range) ** 2
    c2 = (K[1] * data_range) ** 2
    luminance, cs = _ssim_components(pred, target, window_size, sigma, c1, c2)
    ssim_map = luminance * cs
    if size_average:
        return mean(ssim_map)
    return mean(ssim_map, (1, 2, 3))


def ms_ssim(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
            sigma: float = 1.5, data_range: float = 1.0,
            weights: Tuple[float, ...] = MS_SSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM over len(weights) scales; the images must be at
    least 2**(len(weights) - 1) pixels on a side."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    levels = len(weights)
    mcs = []
    for i in range(levels):
        luminance, cs = _ssim_components(pred, target, window_size, sigma, c1, c2)
        if i == levels - 1:
            result = mean(luminance * cs).clamp_min(0.0)
        else:
            mcs.append(mean(cs).clamp_min(0.0))
            pred = avg_pool2(pred)
            target = avg_pool2(target)
    for i, m in enumerate(mcs):
        result = result * (m ** weights[i])
    return result


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
              **kwargs) -> torch.Tensor:
    """1 - SSIM."""
    return 1.0 - ssim(pred, target, window_size=window_size, **kwargs)


def ms_ssim_loss(pred: torch.Tensor, target: torch.Tensor, **kwargs) -> torch.Tensor:
    """1 - MS-SSIM."""
    return 1.0 - ms_ssim(pred, target, **kwargs)
