"""NHWC convolution and activation primitives.

Port of the float path of `facesr/ops/conv.py`. Tensors are NHWC at the
API; ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is already a
``channels_last`` NCHW tensor, so cuDNN sees NHWC with no copy, and the
result permutes back to contiguous NHWC. Weights are torch OIHW.

Precision: the JAX package forces ``Precision.HIGHEST`` for f32 convs
(reduced precision broke SSIM's E[x^2]-E[x]^2). cuDNN runs f32 convs in
TF32 by default on Hopper, so f32 convs here run with TF32 off (and f32
matmuls, which cuBLAS runs in IEEE float32 unless a caller allows TF32). The bf16
path is the explicit ``dtype=torch.bfloat16`` policy. cuDNN reads the flag
when a conv runs, and autograd runs the backward convs after `conv2d` has
returned, so a training step holds `full_f32()` around its backward too.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "prelu", "leaky_relu", "global_avg_pool", "full_f32"]


_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_saved = (True, False)


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """cuDNN float32 convs and cuBLAS float32 matmuls in IEEE float32, not
    TF32. The flags are process-wide, so overlapping users (serving
    threads) are counted: the first turns TF32 off and the last out
    restores the caller's settings. f32 ops on other threads meanwhile only
    become more exact."""
    global _tf32_users, _tf32_saved
    with _tf32_lock:
        if _tf32_users == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_users -= 1
            if _tf32_users == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved


Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def _pad_arg(padding: Padding) -> Union[int, Tuple[int, int]]:
    if isinstance(padding, int):
        return padding
    (top, bottom), (left, right) = padding
    if top != bottom or left != right:
        raise ValueError(f"conv2d takes symmetric padding per axis, got {padding}")
    return top, left


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           padding: Padding = 1, dtype: Optional[torch.dtype] = None,
           groups: int = 1, stride: int = 1) -> torch.Tensor:
    """2-D convolution, NHWC x OIHW -> NHWC. ``padding`` is an int
    (PyTorch ``padding=k``) or per axis ``((ph, ph), (pw, pw))``; ``groups``
    is the JAX ``feature_group_count`` (``groups=C`` with a [C, 1, kh, kw]
    weight is depthwise). ``dtype`` casts the input first; the weight
    follows the input's dtype. The bias is added after the convolution in
    the output dtype, as in the JAX package."""
    if dtype is not None:
        x = x.to(dtype)
    w = w.to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    pad = _pad_arg(padding)
    if x.dtype == torch.float32:
        with full_f32():
            out = F.conv2d(xc, w, stride=stride, padding=pad, groups=groups)
    else:
        out = F.conv2d(xc, w, stride=stride, padding=pad, groups=groups)
    out = out.permute(0, 2, 3, 1)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU on NHWC; alpha [C]."""
    a = alpha.to(x.dtype)
    return torch.where(x >= 0, x, a * x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> [N, C] global average pool (SE squeeze)."""
    return x.mean(dim=(1, 2))
