"""FID InceptionV3 feature extractor (pool3, 2048-d) on NHWC tensors.

Port of `facesr/models/inception.py`, the pytorch-fid network
("pt_inception-2015-12-05"): BatchNorm (eval) folded into a per-conv
scale and bias, average-pool branches with ``count_include_pad=False``,
a max-pool branch in ``Mixed_7c``, input x 2 - 1, a global mean to
[N, 2048]. One architecture table (`CONV_SPECS`, `BLOCKS`) drives the
forward, the random init and the parameter count.

The forward runs NCHW in channels_last memory (cuDNN sees NHWC), f32
convs with TF32 off. Weights: ``inception_fid.fckpt`` in the JAX
package's layout (conv HWIO), found through ``$FACESR_INCEPTION_WEIGHTS``
or ``weights/``, read with the port's own ``.fckpt`` reader.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from facesr_torch.ckpt import fckpt
from facesr_torch.ckpt.resolve import resolve_weights_path
from facesr_torch.ckpt.weights import inception_params_from_jax
from facesr_torch.ops.conv import full_f32
from facesr_torch.ops.resize import resize2d

__all__ = ["CONV_SPECS", "BLOCKS", "FEATURE_DIM", "INPUT_SIZE", "ENV_WEIGHTS", "apply",
           "load_inception_weights", "save_inception_weights", "default_weights_path",
           "init_random_inception", "num_params"]

ENV_WEIGHTS = "FACESR_INCEPTION_WEIGHTS"

# name -> (in_ch, out_ch, (kh, kw), stride, (pad_h, pad_w))
ConvSpec = Tuple[int, int, Tuple[int, int], int, Tuple[int, int]]
Params = Dict[str, Dict[str, torch.Tensor]]


def _inception_a(name: str, in_ch: int, pool_ch: int) -> Dict[str, ConvSpec]:
    return {
        f"{name}.branch1x1": (in_ch, 64, (1, 1), 1, (0, 0)),
        f"{name}.branch5x5_1": (in_ch, 48, (1, 1), 1, (0, 0)),
        f"{name}.branch5x5_2": (48, 64, (5, 5), 1, (2, 2)),
        f"{name}.branch3x3dbl_1": (in_ch, 64, (1, 1), 1, (0, 0)),
        f"{name}.branch3x3dbl_2": (64, 96, (3, 3), 1, (1, 1)),
        f"{name}.branch3x3dbl_3": (96, 96, (3, 3), 1, (1, 1)),
        f"{name}.branch_pool": (in_ch, pool_ch, (1, 1), 1, (0, 0)),
    }


def _inception_b(name: str, in_ch: int) -> Dict[str, ConvSpec]:
    return {
        f"{name}.branch3x3": (in_ch, 384, (3, 3), 2, (0, 0)),
        f"{name}.branch3x3dbl_1": (in_ch, 64, (1, 1), 1, (0, 0)),
        f"{name}.branch3x3dbl_2": (64, 96, (3, 3), 1, (1, 1)),
        f"{name}.branch3x3dbl_3": (96, 96, (3, 3), 2, (0, 0)),
    }


def _inception_c(name: str, in_ch: int, c7: int) -> Dict[str, ConvSpec]:
    return {
        f"{name}.branch1x1": (in_ch, 192, (1, 1), 1, (0, 0)),
        f"{name}.branch7x7_1": (in_ch, c7, (1, 1), 1, (0, 0)),
        f"{name}.branch7x7_2": (c7, c7, (1, 7), 1, (0, 3)),
        f"{name}.branch7x7_3": (c7, 192, (7, 1), 1, (3, 0)),
        f"{name}.branch7x7dbl_1": (in_ch, c7, (1, 1), 1, (0, 0)),
        f"{name}.branch7x7dbl_2": (c7, c7, (7, 1), 1, (3, 0)),
        f"{name}.branch7x7dbl_3": (c7, c7, (1, 7), 1, (0, 3)),
        f"{name}.branch7x7dbl_4": (c7, c7, (7, 1), 1, (3, 0)),
        f"{name}.branch7x7dbl_5": (c7, 192, (1, 7), 1, (0, 3)),
        f"{name}.branch_pool": (in_ch, 192, (1, 1), 1, (0, 0)),
    }


def _inception_d(name: str, in_ch: int) -> Dict[str, ConvSpec]:
    return {
        f"{name}.branch3x3_1": (in_ch, 192, (1, 1), 1, (0, 0)),
        f"{name}.branch3x3_2": (192, 320, (3, 3), 2, (0, 0)),
        f"{name}.branch7x7x3_1": (in_ch, 192, (1, 1), 1, (0, 0)),
        f"{name}.branch7x7x3_2": (192, 192, (1, 7), 1, (0, 3)),
        f"{name}.branch7x7x3_3": (192, 192, (7, 1), 1, (3, 0)),
        f"{name}.branch7x7x3_4": (192, 192, (3, 3), 2, (0, 0)),
    }


def _inception_e(name: str, in_ch: int) -> Dict[str, ConvSpec]:
    return {
        f"{name}.branch1x1": (in_ch, 320, (1, 1), 1, (0, 0)),
        f"{name}.branch3x3_1": (in_ch, 384, (1, 1), 1, (0, 0)),
        f"{name}.branch3x3_2a": (384, 384, (1, 3), 1, (0, 1)),
        f"{name}.branch3x3_2b": (384, 384, (3, 1), 1, (1, 0)),
        f"{name}.branch3x3dbl_1": (in_ch, 448, (1, 1), 1, (0, 0)),
        f"{name}.branch3x3dbl_2": (448, 384, (3, 3), 1, (1, 1)),
        f"{name}.branch3x3dbl_3a": (384, 384, (1, 3), 1, (0, 1)),
        f"{name}.branch3x3dbl_3b": (384, 384, (3, 1), 1, (1, 0)),
        f"{name}.branch_pool": (in_ch, 192, (1, 1), 1, (0, 0)),
    }


def _build_conv_specs() -> Dict[str, ConvSpec]:
    specs: Dict[str, ConvSpec] = {
        "Conv2d_1a_3x3": (3, 32, (3, 3), 2, (0, 0)),
        "Conv2d_2a_3x3": (32, 32, (3, 3), 1, (0, 0)),
        "Conv2d_2b_3x3": (32, 64, (3, 3), 1, (1, 1)),
        "Conv2d_3b_1x1": (64, 80, (1, 1), 1, (0, 0)),
        "Conv2d_4a_3x3": (80, 192, (3, 3), 1, (0, 0)),
    }
    specs.update(_inception_a("Mixed_5b", 192, 32))   # -> 256
    specs.update(_inception_a("Mixed_5c", 256, 64))   # -> 288
    specs.update(_inception_a("Mixed_5d", 288, 64))   # -> 288
    specs.update(_inception_b("Mixed_6a", 288))       # -> 768
    specs.update(_inception_c("Mixed_6b", 768, 128))
    specs.update(_inception_c("Mixed_6c", 768, 160))
    specs.update(_inception_c("Mixed_6d", 768, 160))
    specs.update(_inception_c("Mixed_6e", 768, 192))
    specs.update(_inception_d("Mixed_7a", 768))       # -> 1280
    specs.update(_inception_e("Mixed_7b", 1280))      # -> 2048
    specs.update(_inception_e("Mixed_7c", 2048))      # -> 2048
    return specs


CONV_SPECS: Dict[str, ConvSpec] = _build_conv_specs()
# (kind, name) in forward order
BLOCKS: List[Tuple[str, str]] = [
    ("stem", ""),
    ("A", "Mixed_5b"), ("A", "Mixed_5c"), ("A", "Mixed_5d"),
    ("B", "Mixed_6a"),
    ("C", "Mixed_6b"), ("C", "Mixed_6c"), ("C", "Mixed_6d"), ("C", "Mixed_6e"),
    ("D", "Mixed_7a"),
    ("E_avg", "Mixed_7b"),
    ("E_max", "Mixed_7c"),  # FIDInceptionE_2: the pool branch is a MAX pool
]

FEATURE_DIM = 2048
INPUT_SIZE = 299


def num_params() -> int:
    """Parameter count: conv kernels + folded BatchNorm scale and bias."""
    return sum(kh * kw * ic * oc + 2 * oc for ic, oc, (kh, kw), _, _ in CONV_SPECS.values())


# ---------------------------------------------------------------------------
# Forward (NCHW in channels_last memory)
# ---------------------------------------------------------------------------

def _bconv(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """BasicConv2d: conv (no bias) + folded BatchNorm + relu."""
    _, _, _, stride, pad = CONV_SPECS[name]
    p = params[name]
    h = F.conv2d(x, p["w"], stride=stride, padding=pad)
    return torch.relu(h * p["scale"][:, None, None] + p["bias"][:, None, None])


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _block_a(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b1 = _bconv(params, f"{name}.branch1x1", x)
    b5 = _bconv(params, f"{name}.branch5x5_2", _bconv(params, f"{name}.branch5x5_1", x))
    b3 = _bconv(params, f"{name}.branch3x3dbl_1", x)
    b3 = _bconv(params, f"{name}.branch3x3dbl_2", b3)
    b3 = _bconv(params, f"{name}.branch3x3dbl_3", b3)
    bp = _bconv(params, f"{name}.branch_pool", _avg_pool3(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _block_b(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b3 = _bconv(params, f"{name}.branch3x3", x)
    bd = _bconv(params, f"{name}.branch3x3dbl_1", x)
    bd = _bconv(params, f"{name}.branch3x3dbl_2", bd)
    bd = _bconv(params, f"{name}.branch3x3dbl_3", bd)
    return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


def _block_c(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b1 = _bconv(params, f"{name}.branch1x1", x)
    b7 = _bconv(params, f"{name}.branch7x7_1", x)
    b7 = _bconv(params, f"{name}.branch7x7_2", b7)
    b7 = _bconv(params, f"{name}.branch7x7_3", b7)
    bd = _bconv(params, f"{name}.branch7x7dbl_1", x)
    for i in (2, 3, 4, 5):
        bd = _bconv(params, f"{name}.branch7x7dbl_{i}", bd)
    bp = _bconv(params, f"{name}.branch_pool", _avg_pool3(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _block_d(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    b3 = _bconv(params, f"{name}.branch3x3_2", _bconv(params, f"{name}.branch3x3_1", x))
    b7 = _bconv(params, f"{name}.branch7x7x3_1", x)
    for i in (2, 3, 4):
        b7 = _bconv(params, f"{name}.branch7x7x3_{i}", b7)
    return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


def _block_e(params: Params, name: str, x: torch.Tensor, pool: str) -> torch.Tensor:
    b1 = _bconv(params, f"{name}.branch1x1", x)
    b3 = _bconv(params, f"{name}.branch3x3_1", x)
    b3 = torch.cat([_bconv(params, f"{name}.branch3x3_2a", b3),
                    _bconv(params, f"{name}.branch3x3_2b", b3)], dim=1)
    bd = _bconv(params, f"{name}.branch3x3dbl_1", x)
    bd = _bconv(params, f"{name}.branch3x3dbl_2", bd)
    bd = torch.cat([_bconv(params, f"{name}.branch3x3dbl_3a", bd),
                    _bconv(params, f"{name}.branch3x3dbl_3b", bd)], dim=1)
    pooled = _avg_pool3(x) if pool == "avg" else F.max_pool2d(x, 3, 1, padding=1)
    bp = _bconv(params, f"{name}.branch_pool", pooled)
    return torch.cat([b1, b3, bd, bp], dim=1)


_DISPATCH = {"A": _block_a, "B": _block_b, "C": _block_c, "D": _block_d}


def apply(params: Params, images: torch.Tensor, resize_input: bool = True) -> torch.Tensor:
    """images: NHWC float in [0, 1] -> pool3 activations [N, 2048] (f32).

    ``resize_input`` is pytorch-fid's default: bilinear to 299x299
    (``align_corners=False``, `ops.resize.resize2d`), then [-1, 1]."""
    x = images.float()
    if resize_input and tuple(x.shape[1:3]) != (INPUT_SIZE, INPUT_SIZE):
        x = resize2d(x, (INPUT_SIZE, INPUT_SIZE), method="bilinear")
    x = (x * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with full_f32():
        x = _bconv(params, "Conv2d_1a_3x3", x)
        x = _bconv(params, "Conv2d_2a_3x3", x)
        x = _bconv(params, "Conv2d_2b_3x3", x)
        x = F.max_pool2d(x, 3, 2)
        x = _bconv(params, "Conv2d_3b_1x1", x)
        x = _bconv(params, "Conv2d_4a_3x3", x)
        x = F.max_pool2d(x, 3, 2)
        for kind, name in BLOCKS[1:]:
            if kind.startswith("E"):
                x = _block_e(params, name, x, pool="avg" if kind == "E_avg" else "max")
            else:
                x = _DISPATCH[kind](params, name, x)
    return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def default_weights_path() -> Optional[str]:
    return resolve_weights_path(ENV_WEIGHTS, "inception_fid.fckpt")


def load_inception_weights(path: Optional[str] = None,
                           device: Optional[torch.device] = None) -> Optional[Params]:
    """FID-Inception weights of a ``.fckpt`` in the JAX layout, on
    ``device`` (the CPU when None); None when there is no file. Raises
    when a conv of `CONV_SPECS` is missing."""
    path = path or default_weights_path()
    if path is None or not os.path.exists(path):
        return None
    tree, _ = fckpt.load_checkpoint(path)
    missing = [n for n in CONV_SPECS if n not in tree]
    if missing:
        raise ValueError(f"Inception weights at {path} miss convs: {missing[:4]}...")
    params = inception_params_from_jax({n: tree[n] for n in CONV_SPECS})
    return {n: {k: t.to(device) if device is not None else t for k, t in p.items()}
            for n, p in params.items()}


def save_inception_weights(path: str, params: Params) -> None:
    """Write ``params`` as the ``.fckpt`` `load_inception_weights` and the
    JAX package's loader read (conv weights HWIO)."""
    tree = {n: {"w": p["w"].detach().cpu().permute(2, 3, 1, 0).contiguous().numpy(),
                "scale": p["scale"].detach().cpu().numpy(),
                "bias": p["bias"].detach().cpu().numpy()} for n, p in params.items()}
    fckpt.save_checkpoint(path, tree, {"kind": "inception_fid"})


def init_random_inception(generator: torch.Generator) -> Params:
    """Random weights of the production structure from a CPU generator (He
    normal convs; folded BatchNorm scale N(1, 0.1) and bias N(0, 0.1), so
    the scale and bias paths are exercised): for tests and
    `chip_smoke.py` only."""
    params = {}
    for name, (ic, oc, (kh, kw), _, _) in sorted(CONV_SPECS.items()):
        w = torch.randn((oc, ic, kh, kw), generator=generator) * math.sqrt(2.0 / (kh * kw * ic))
        params[name] = {"w": w,
                        "scale": 1.0 + 0.1 * torch.randn(oc, generator=generator),
                        "bias": 0.1 * torch.randn(oc, generator=generator)}
    return params
