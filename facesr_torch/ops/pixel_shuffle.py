"""PixelShuffle (depth-to-space) in NHWC with torch channel order.

Port of `facesr/ops/pixel_shuffle.py`: input channel k = c*r^2 + dy*r + dx
goes to output channel c at spatial offset (dy, dx), as `nn.PixelShuffle`.
`subpixel_pack_kernel` rewrites a 3x3 kernel that reads a PixelShuffle(2)
output into one that reads the packed (pre-shuffle) layout (the int8
serving path's conv_last).
"""

from __future__ import annotations

import torch

__all__ = ["pixel_shuffle", "pixel_unshuffle", "subpixel_pack_kernel"]


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


def subpixel_pack_kernel(k: torch.Tensor, r: int = 2) -> torch.Tensor:
    """An OIHW 3x3 kernel ``k`` on a PixelShuffle(2) output, rewritten as
    the 3x3 kernel on the packed layout with

        conv3x3(pixel_shuffle(x, 2), k) == pixel_shuffle(conv3x3(x, k'), 2).

    Output pixel (2i+dy, 2j+dx) reads shuffled row 2i+dy+u-1 (u in 0..2),
    which is packed row offset and phase divmod(dy+u-1, 2): every tap lands
    in packed offsets -1..1, and one packed row of zero padding covers the
    original's one shuffled row. Channels follow torch PixelShuffle (packed
    = c*4 + py*2 + px, on both sides). Exact for integer convolution."""
    cout, cin, kh, kw = k.shape
    if kh != 3 or kw != 3 or r != 2:
        raise NotImplementedError("subpixel_pack_kernel supports 3x3, r=2")
    packed = k.new_zeros((cout * 4, cin * 4, 3, 3))
    for dy in range(2):
        for dx in range(2):
            for u in range(3):
                for v in range(3):
                    di, py = divmod(dy + u - 1, 2)
                    dj, px = divmod(dx + v - 1, 2)
                    packed[dy * 2 + dx::4, py * 2 + px::4, di + 1, dj + 1] = k[:, :, u, v]
    return packed
