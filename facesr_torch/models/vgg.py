"""VGG19 feature extractor for the perceptual loss, on NHWC tensors.

Port of `facesr/models/vgg.py`: the torchvision ``vgg19.features`` module
sequence and layer names ('conv1_1' ... 'pool5'); features are taken after
a conv and before its ReLU; 2x2 VALID max pools; ImageNet normalisation.
Conv params are a list of ``{"w": OIHW, "b": [C]}`` ordered by depth,
plain tensors outside any optimiser. Pretrained weights are not in the
repository, so, like the JAX package without them, the loss uses a seeded
random VGG (`init_vgg19`); `facesr_torch.ckpt.weights.vgg_params_from_jax`
carries a JAX conv list over.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from facesr_torch.ops import init as finit
from facesr_torch.ops.conv import conv2d
from facesr_torch.parallel import spatial

__all__ = ["VGG19_CFG", "LAYER_MAP", "IMAGENET_MEAN", "IMAGENET_STD",
           "module_sequence", "num_convs_needed", "init_vgg19", "max_pool2",
           "extract_features"]

# Channel progression of VGG19 features; 'M' = 2x2 max pool.
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

# torchvision vgg19.features Sequential index of each named layer; conv
# names point at the Conv2d module, so features are post-conv, pre-ReLU.
LAYER_MAP = {
    "conv1_1": 0, "relu1_1": 1, "conv1_2": 2, "relu1_2": 3, "pool1": 4,
    "conv2_1": 5, "relu2_1": 6, "conv2_2": 7, "relu2_2": 8, "pool2": 9,
    "conv3_1": 10, "relu3_1": 11, "conv3_2": 12, "relu3_2": 13,
    "conv3_3": 14, "relu3_3": 15, "conv3_4": 16, "relu3_4": 17, "pool3": 18,
    "conv4_1": 19, "relu4_1": 20, "conv4_2": 21, "relu4_2": 22,
    "conv4_3": 23, "relu4_3": 24, "conv4_4": 25, "relu4_4": 26, "pool4": 27,
    "conv5_1": 28, "relu5_1": 29, "conv5_2": 30, "relu5_2": 31,
    "conv5_3": 32, "relu5_3": 33, "conv5_4": 34, "relu5_4": 35, "pool5": 36,
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

VGGParams = List[Dict[str, torch.Tensor]]


def module_sequence() -> List[tuple]:
    """[(torchvision_index, kind, conv_number)] for the features stack."""
    seq = []
    idx = 0
    conv_no = 0
    for c in VGG19_CFG:
        if c == "M":
            seq.append((idx, "pool", None))
            idx += 1
        else:
            seq.append((idx, "conv", conv_no))
            seq.append((idx + 1, "relu", None))
            idx += 2
            conv_no += 1
    return seq


def num_convs_needed(max_index: int) -> int:
    return sum(1 for i, kind, _ in module_sequence() if kind == "conv" and i <= max_index)


def init_vgg19(generator: torch.Generator, max_index: int = 36) -> VGGParams:
    """Conv params up to torchvision index ``max_index``: Kaiming
    fan_out/relu weights from ``generator``, zero biases (on the
    generator's device)."""
    params = []
    in_ch = 3
    for c in [c for c in VGG19_CFG if c != "M"][:num_convs_needed(max_index)]:
        params.append({
            "w": finit.kaiming_normal((c, in_ch, 3, 3), generator),
            "b": torch.zeros(c, device=generator.device),
        })
        in_ch = c
    return params


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max pool on NHWC (row-local under a row shard,
    whose height must then be even)."""
    spatial.check_slab(x.shape[1], 2, "the VGG max pool")
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=8)
def _imagenet_stats(device: torch.device, dtype: torch.dtype):
    """(mean, std) on ``device``, kept so a step copies nothing to the card."""
    with torch.inference_mode(False):
        return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
                torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def extract_features(params: VGGParams, x: torch.Tensor, layer_indices: Sequence[int],
                     normalize: bool = True) -> Dict[int, torch.Tensor]:
    """Run the features stack on NHWC ``x`` in [0, 1], capturing the
    outputs at the given torchvision indices. Computes in x's dtype."""
    if normalize:
        mean, std = _imagenet_stats(x.device, x.dtype)
        x = (x - mean) / std
    wanted = set(int(i) for i in layer_indices)
    if not wanted:
        raise ValueError(
            "extract_features needs at least one layer index (empty "
            "perceptual_layers? drop the perceptual term instead)")
    max_idx = max(wanted)
    feats: Dict[int, torch.Tensor] = {}
    for idx, kind, conv_no in module_sequence():
        if idx > max_idx:
            break
        if kind == "conv":
            p = params[conv_no]
            x = conv2d(x, p["w"], p["b"], padding=1)
        elif kind == "relu":
            x = torch.relu(x)
        else:
            x = max_pool2(x)
        if idx in wanted:
            feats[idx] = x
    return feats
