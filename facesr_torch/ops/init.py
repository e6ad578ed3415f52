"""Weight initializers with PyTorch semantics, drawn from a torch.Generator.

Port of `facesr/ops/init.py`. Kernels here are in torch layouts (conv
OIHW, dense [out, in]), so fans follow torch's own
`_calculate_fan_in_and_fan_out`: fan_in = in * kh * kw, fan_out =
out * kh * kw — the same numbers the JAX package computes on HWIO.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["calculate_gain", "kaiming_normal", "icnr", "prelu_init"]


def calculate_gain(nonlinearity: str, a: float = 0.0) -> float:
    """PyTorch `nn.init.calculate_gain`."""
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1.0 + a * a))
    if nonlinearity in ("linear", "conv2d", "sigmoid"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    raise ValueError(f"Unsupported nonlinearity: {nonlinearity}")


def _fans(shape: Sequence[int]) -> tuple[int, int]:
    """(fan_in, fan_out) of an OIHW conv or [out, in] dense kernel."""
    if len(shape) not in (2, 4):
        raise ValueError(f"Unsupported kernel shape: {tuple(shape)}")
    rf = math.prod(shape[2:])
    return shape[1] * rf, shape[0] * rf


def kaiming_normal(shape: Sequence[int], generator: torch.Generator,
                   mode: str = "fan_out", nonlinearity: str = "relu",
                   a: float = 0.0, scale: float = 1.0,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """`nn.init.kaiming_normal_` values for an OIHW / [out, in] kernel."""
    fan_in, fan_out = _fans(shape)
    std = calculate_gain(nonlinearity, a) / math.sqrt(
        fan_in if mode == "fan_in" else fan_out)
    w = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return (w * (std * scale)).to(device or generator.device)


def icnr(shape: Sequence[int], generator: torch.Generator,
         scale_factor: int = 2, device: Optional[torch.device] = None) -> torch.Tensor:
    """ICNR init of a PixelShuffle conv kernel (OIHW, out = C * s^2).

    A [out/s^2, in, kh, kw] sub-kernel is drawn Kaiming fan_out/relu and
    repeated s^2 times along the output axis (repeat_interleave), so in
    PixelShuffle's channel order (c*s^2 + phase) all s^2 phases of each
    output channel start equal."""
    cout = shape[0]
    r2 = scale_factor ** 2
    if cout % r2:
        raise ValueError(
            f"ICNR needs out channels divisible by scale^2: {cout} % {r2} != 0")
    sub = kaiming_normal((cout // r2,) + tuple(shape[1:]), generator,
                         mode="fan_out", nonlinearity="relu", device=device)
    return sub.repeat_interleave(r2, dim=0)


def prelu_init(num_channels: int, init: float = 0.25,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Per-channel PReLU slope, torch default 0.25."""
    return torch.full((num_channels,), init, device=device)
