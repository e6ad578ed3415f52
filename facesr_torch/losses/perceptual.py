"""VGG19 perceptual loss (port of `facesr/losses/perceptual.py`).

`init_perceptual` builds the frozen VGG conv list (or takes one given),
`perceptual_loss` computes the weighted L1/L2 feature distance. The VGG
tensors are plain tensors that require no grad: they never reach an
optimiser.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from facesr_torch.losses.basic import l1_loss, l2_loss
from facesr_torch.models import vgg
from facesr_torch.parallel import spatial, tensor

__all__ = ["init_perceptual", "perceptual_loss", "DEFAULT_LAYERS"]

DEFAULT_LAYERS = ("conv3_4", "conv4_4")


def init_perceptual(generator: torch.Generator, layers: Sequence[str] = DEFAULT_LAYERS,
                    pretrained_params: Optional[vgg.VGGParams] = None) -> vgg.VGGParams:
    """VGG19 conv params truncated to the deepest requested layer: the given
    ``pretrained_params``, else a random VGG drawn from ``generator``."""
    max_idx = max(vgg.LAYER_MAP[layer] for layer in layers)
    needed = vgg.num_convs_needed(max_idx)
    if pretrained_params is not None:
        if len(pretrained_params) < needed:
            raise ValueError(
                f"VGG19 weights have {len(pretrained_params)} convs but the "
                f"requested layers need {needed} — corrupt/truncated conversion?")
        return [{k: v.detach() for k, v in p.items()} for p in pretrained_params[:needed]]
    return vgg.init_vgg19(generator, max_index=max_idx)


def perceptual_loss(vgg_params: vgg.VGGParams, pred: torch.Tensor, target: torch.Tensor,
                    layers: Sequence[str] = DEFAULT_LAYERS,
                    weights: Optional[Dict[str, float]] = None,
                    criterion: str = "l1", normalize: bool = True,
                    dtype: Optional[torch.dtype] = None,
                    remat: bool = True) -> torch.Tensor:
    """Weighted feature-matching distance over the named VGG layers.

    pred/target: NHWC in [0, 1]. The target branch runs under ``no_grad``;
    ``dtype`` sets the sweep's compute precision (bf16 under the trainer's
    mixed-precision policy); the distance reduces in f32 either way.
    ``remat`` (the JAX package's default) recomputes the pred branch's
    sweep in the backward pass (`torch.utils.checkpoint`) instead of
    keeping its activations."""
    if criterion not in ("l1", "l2"):
        raise ValueError(f"Unknown perceptual criterion {criterion!r}; use 'l1' or 'l2'")
    dist = l1_loss if criterion == "l1" else l2_loss
    weights = weights if weights is not None else {layer: 1.0 for layer in layers}
    idxs = [vgg.LAYER_MAP[layer] for layer in layers]
    if dtype is not None:
        pred = pred.to(dtype)
        target = target.to(dtype)

    # re-entered by the backward pass's recompute
    shard, tp = spatial.current(), tensor.current()

    def extract(x):
        with spatial.rows(shard), tensor.split(tp):
            return vgg.extract_features(vgg_params, x, idxs, normalize=normalize)

    if remat:
        pred_feats = checkpoint(extract, pred, use_reentrant=False,
                                preserve_rng_state=False)
    else:
        pred_feats = extract(pred)
    with torch.no_grad():
        target_feats = extract(target)

    loss = torch.zeros((), dtype=torch.float32, device=pred.device)
    for name, idx in zip(layers, idxs):
        loss = loss + weights.get(name, 1.0) * dist(pred_feats[idx].float(),
                                                    target_feats[idx].float())
    return loss
