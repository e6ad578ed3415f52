"""PixelShuffle (depth-to-space) in NHWC with torch channel order.

Port of `facesr/ops/pixel_shuffle.py`: input channel k = c*r^2 + dy*r + dx
goes to output channel c at spatial offset (dy, dx), as `nn.PixelShuffle`.
"""

from __future__ import annotations

import torch

__all__ = ["pixel_shuffle", "pixel_unshuffle"]


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC [N, H, W, C*r^2] -> [N, H*r, W*r, C]."""
    n, h, w, cr2 = x.shape
    c = cr2 // (r * r)
    x = x.reshape(n, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)  # n, h, dy, w, dx, c
    return x.reshape(n, h * r, w * r, c)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of pixel_shuffle: [N, H*r, W*r, C] -> [N, H, W, C*r^2]."""
    n, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(n, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)  # n, h, w, c, dy, dx
    return x.reshape(n, h, w, c * r * r)
