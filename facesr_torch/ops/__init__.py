"""Tensor primitives of the port (NHWC) and its hand-written kernels."""

from facesr_torch.ops.conv import conv2d, global_avg_pool, leaky_relu, prelu
from facesr_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from facesr_torch.ops.resize import (avg_pool2, bicubic_down, bicubic_up, nearest_up,
                                     resize2d, resize_matrix)

__all__ = ["conv2d", "prelu", "leaky_relu", "global_avg_pool", "pixel_shuffle",
           "pixel_unshuffle", "resize_matrix", "resize2d", "bicubic_up",
           "bicubic_down", "nearest_up", "avg_pool2"]
