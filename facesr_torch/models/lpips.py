"""LPIPS (AlexNet backbone + learned linear heads) on NHWC tensors.

Port of `facesr/models/lpips.py`, the lpips package's computation:

  input in [-1, 1] -> per-channel shift/scale -> AlexNet features
  (relu1..relu5; 3x3 stride-2 max-pool after relu1 and relu2) ->
  unit-normalise over channels -> squared difference -> 1x1 linear head
  -> spatial mean -> batch mean -> sum over the five layers.

Weights: ``lpips_alex.fckpt`` in the JAX package's layout (conv HWIO),
found through ``$FACESR_LPIPS_WEIGHTS`` or ``weights/`` and read with the
port's own ``.fckpt`` reader. Without them the metric is unavailable.
f32 convs run with TF32 off (`ops.conv.conv2d`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt.resolve import resolve_weights_path
from facesr_torch.ckpt.weights import lpips_params_from_jax
from facesr_torch.ops.conv import conv2d
from facesr_torch.ops.init import kaiming_normal

__all__ = ["lpips_distance", "load_lpips_weights", "save_lpips_weights",
           "default_weights_path", "init_random_alexnet", "ENV_WEIGHTS"]

# (out_ch, kernel, stride, pad) of AlexNet's feature convs
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # 3x3 stride-2 max-pool after relu1 and relu2
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ENV_WEIGHTS = "FACESR_LPIPS_WEIGHTS"

Weights = Dict[str, List[Dict[str, torch.Tensor]]]


def default_weights_path() -> Optional[str]:
    return resolve_weights_path(ENV_WEIGHTS, "lpips_alex.fckpt")


def load_lpips_weights(path: Optional[str] = None) -> Optional[Weights]:
    """The LPIPS weights of a ``.fckpt`` in the JAX layout, on the CPU;
    None when there is no file."""
    path = path or default_weights_path()
    if path is None or not os.path.exists(path):
        return None
    tree, _ = fckpt.load_checkpoint(path)
    return lpips_params_from_jax(tree)


def save_lpips_weights(path: str, params: Weights) -> None:
    """Write ``params`` as the ``.fckpt`` `load_lpips_weights` and the JAX
    package's loader read (conv weights HWIO)."""
    tree = {"convs": [{"w": p["w"].detach().cpu().permute(2, 3, 1, 0).contiguous().numpy(),
                       "b": p["b"].detach().cpu().numpy()} for p in params["convs"]],
            "lins": [{"w": p["w"].detach().cpu().numpy()} for p in params["lins"]]}
    fckpt.save_checkpoint(path, tree, {"kind": "lpips_alex"})


def _alexnet_features(convs: List[Dict[str, torch.Tensor]], x: torch.Tensor) -> List[torch.Tensor]:
    feats = []
    h = x
    for i, ((_, _, stride, pad), p) in enumerate(zip(_ALEX_CONVS, convs)):
        h = torch.relu(conv2d(h, p["w"], p["b"], padding=pad, stride=stride))
        feats.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + eps)


def lpips_distance(weights: Weights, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """LPIPS distance (a scalar: the batch mean). pred/target: NHWC in
    [-1, 1]."""
    shift = torch.tensor(_SHIFT, dtype=pred.dtype, device=pred.device)
    scale = torch.tensor(_SCALE, dtype=pred.dtype, device=pred.device)
    fp = _alexnet_features(weights["convs"], (pred - shift) / scale)
    ft = _alexnet_features(weights["convs"], (target - shift) / scale)
    total = torch.zeros((), dtype=torch.float32, device=pred.device)
    for f0, f1, lin in zip(fp, ft, weights["lins"]):
        d = (_unit_normalize(f0) - _unit_normalize(f1)) ** 2
        val = torch.einsum("nhwc,co->nhwo", d, lin["w"].to(d.dtype))  # the 1x1 head
        total = total + val.mean(dim=(1, 2, 3)).mean()
    return total


def init_random_alexnet(generator: torch.Generator) -> Weights:
    """Random LPIPS weights of the production structure, drawn from a CPU
    generator: for tests and `chip_smoke.py` only (not perceptually
    meaningful)."""
    convs, in_ch = [], 3
    for out_ch, k, _, _ in _ALEX_CONVS:
        convs.append({"w": kaiming_normal((out_ch, in_ch, k, k), generator, mode="fan_in"),
                      "b": torch.zeros(out_ch)})
        in_ch = out_ch
    lins = [{"w": torch.rand((c, 1), generator=generator) * 0.1}
            for c, *_ in _ALEX_CONVS]
    return {"convs": convs, "lins": lins}
