"""FaceEnhanceNet building blocks as nn.Modules over NHWC tensors.

Port of `facesr/models/blocks.py`. Module and parameter
names follow the reference state dict (`residual_groups.{g}.blocks.{b}.
conv1.weight`, `...channel_attention.fc.0.weight`, `upsample.stages.{s}.
conv.weight`, ...), so reference `.pth` files load with ``strict=True``.
Parameters are created uninitialized (`torch.nn.utils.skip_init`) and
filled from an explicit `torch.Generator` by the ``init_*`` functions.

  - ChannelAttention (SE): mean over HW -> FC(C -> max(C/r, 8), no bias)
    -> ReLU -> FC(-> C, no bias) -> sigmoid -> scale
  - RCAB: conv3x3 -> PReLU -> conv3x3 -> CA -> * res_scale + skip
  - ResidualGroup: B RCABs -> conv3x3 -> + group skip
  - Upsample stage: conv C -> 4C (ICNR) -> PixelShuffle(2) -> PReLU

The forward functions take ``quant``, a map from conv site (module path)
to its int8 serving or QAT site (`ops.quant`), as the JAX functions take
a transformed parameter tree.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils import skip_init
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from facesr_torch.ops import init as finit
from facesr_torch.ops.conv import conv2d, prelu, quantize_act
from facesr_torch.ops.pixel_shuffle import pixel_shuffle
from facesr_torch.ops.quant import QuantSites, is_int8_kernel, site_weight
from facesr_torch.ops.rcab_group import GroupWeights, fused_residual_group
from facesr_torch.parallel import spatial, tensor

__all__ = ["reduced_channels", "KernelWeightCache", "ChannelAttention", "RCAB", "ResidualGroup",
           "UpsampleStage", "Upsample", "make_conv", "channel_attention", "rcab",
           "residual_groups", "REMAT_MODES", "upsample", "make_residual_groups",
           "make_upsample", "init_conv", "init_rcab", "init_residual_group",
           "init_upsample"]


def reduced_channels(num_channels: int, reduction_ratio: int) -> int:
    """SE bottleneck width: max(C // r, 8)."""
    return max(num_channels // reduction_ratio, 8)


class KernelWeightCache:
    """Mixin of a model that runs residual groups on the group kernel:
    their weights in the kernel layout, prepared once and reused until a
    parameter they come from changes. An in-place edit or `load_state_dict`
    bumps a parameter's version; a device or dtype move clears the cache
    (`_apply`). Parameters made under `torch.inference_mode` track no
    version, so theirs are prepared on every call."""

    _kernel_weights = None  # (key, prepared weights)

    def cached_kernel_weights(self, params, prepare):
        """``prepare()``'s result for the current state of ``params``, as
        plain tensors even under inference_mode (a later autograd forward
        on the CPU may save them for backward)."""
        key = None if any(p.is_inference() for p in params) else tuple(
            (p.data_ptr(), p._version) for p in params)
        if key is None or self._kernel_weights is None or self._kernel_weights[0] != key:
            with torch.inference_mode(False), torch.no_grad():
                self._kernel_weights = (key, prepare())
        return self._kernel_weights[1]

    def _apply(self, fn, *args, **kwargs):
        self._kernel_weights = None
        return super()._apply(fn, *args, **kwargs)


def group_with(rcabs, conv: nn.Conv2d, weights: Dict[str, torch.Tensor], rcabs_path: str,
               conv_path: str) -> SimpleNamespace:
    """A residual group's RCABs and tail conv under a residual group's
    names (``blocks``, ``conv``), for `prepare_group_weights`, each conv
    weight taken from ``weights`` (site -> tensor) where it has an entry
    (``{rcabs_path}.{i}.conv1``, ``{conv_path}``), else the module's."""
    def with_weight(mod, name):
        return SimpleNamespace(weight=weights.get(name, mod.weight), bias=mod.bias)

    return SimpleNamespace(
        blocks=[SimpleNamespace(conv1=with_weight(b.conv1, f"{rcabs_path}.{i}.conv1"),
                                prelu=b.prelu,
                                conv2=with_weight(b.conv2, f"{rcabs_path}.{i}.conv2"),
                                channel_attention=b.channel_attention)
                for i, b in enumerate(rcabs)],
        conv=with_weight(conv, conv_path))


def run_kernel_groups(feat: torch.Tensor, groups: List[GroupWeights],
                      res_scale: float) -> torch.Tensor:
    """``feat`` through `fused_residual_group` once a group of ``groups``
    (kernel-layout weights). A copy, not ``.contiguous()``: a trace drops
    ``.contiguous()`` where the example was contiguous, and at another
    batch (N=1) the conv before the groups may return other strides."""
    feat = feat.clone(memory_format=torch.contiguous_format)
    for gw in groups:
        feat = fused_residual_group(feat, gw, res_scale)
    return feat


def make_conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    """An uninitialized Conv2d (weight OIHW, bias) holding parameters only."""
    return skip_init(nn.Conv2d, cin, cout, k, padding=k // 2)


class ChannelAttention(nn.Module):
    def __init__(self, c: int, reduction_ratio: int):
        super().__init__()
        cr = reduced_channels(c, reduction_ratio)
        self.fc = nn.Sequential(
            skip_init(nn.Linear, c, cr, bias=False),
            nn.ReLU(),
            skip_init(nn.Linear, cr, c, bias=False),
        )


class RCAB(nn.Module):
    def __init__(self, c: int, k: int, reduction_ratio: int):
        super().__init__()
        self.conv1 = make_conv(c, c, k)
        self.prelu = skip_init(nn.PReLU, c)
        self.conv2 = make_conv(c, c, k)
        self.channel_attention = ChannelAttention(c, reduction_ratio)


class ResidualGroup(nn.Module):
    def __init__(self, c: int, num_blocks: int, k: int, reduction_ratio: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            RCAB(c, k, reduction_ratio) for _ in range(num_blocks))
        self.conv = make_conv(c, c, k)


class UpsampleStage(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = make_conv(c, c * 4, 3)
        self.prelu = skip_init(nn.PReLU, c)


class Upsample(nn.Module):
    def __init__(self, c: int, scale_factor: int):
        super().__init__()
        num_stages = int(math.log2(scale_factor))
        if 2 ** num_stages != scale_factor:
            raise ValueError(f"scale_factor must be a power of 2, got {scale_factor}")
        self.stages = nn.ModuleList(UpsampleStage(c) for _ in range(num_stages))


# ---------------------------------------------------------------------------
# Initialization (Kaiming fan_out/relu, zero biases, PReLU 0.25, ICNR)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_conv(conv: nn.Conv2d, gen: torch.Generator) -> None:
    conv.weight.copy_(finit.kaiming_normal(conv.weight.shape, gen))
    conv.bias.zero_()


@torch.no_grad()
def init_rcab(blk: RCAB, gen: torch.Generator) -> None:
    init_conv(blk.conv1, gen)
    blk.prelu.weight.copy_(finit.prelu_init(blk.prelu.weight.numel()))
    init_conv(blk.conv2, gen)
    for i in (0, 2):
        fc = blk.channel_attention.fc[i].weight
        fc.copy_(finit.kaiming_normal(fc.shape, gen))


def init_residual_group(group: ResidualGroup, gen: torch.Generator) -> None:
    for blk in group.blocks:
        init_rcab(blk, gen)
    init_conv(group.conv, gen)


@torch.no_grad()
def init_upsample(up: Upsample, gen: torch.Generator) -> None:
    for st in up.stages:
        st.conv.weight.copy_(finit.icnr(st.conv.weight.shape, gen, scale_factor=2))
        st.conv.bias.zero_()
        st.prelu.weight.copy_(finit.prelu_init(st.prelu.weight.numel()))


def make_residual_groups(num_groups: int, blocks_per_group: int, c: int, k: int,
                         reduction_ratio: int, gen: torch.Generator) -> nn.ModuleList:
    groups = nn.ModuleList(
        ResidualGroup(c, blocks_per_group, k, reduction_ratio)
        for _ in range(num_groups))
    for g in groups:
        init_residual_group(g, gen)
    return groups


def make_upsample(c: int, scale_factor: int, gen: torch.Generator) -> Upsample:
    up = Upsample(c, scale_factor)
    init_upsample(up, gen)
    return up


# ---------------------------------------------------------------------------
# Forward functions (NHWC; compute dtype follows the input)
# ---------------------------------------------------------------------------

def channel_attention(ca: ChannelAttention,
                      x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SE gating. Returns (gated tensor, attention weights [N, C]). Under a
    row shard the squeeze is the mean over the whole image."""
    y = spatial.mean(x, (1, 2))
    y = torch.relu(y @ ca.fc[0].weight.t().to(y.dtype))
    y = torch.sigmoid(y @ ca.fc[2].weight.t().to(y.dtype))
    return x * y[:, None, None, :], y


def rcab(blk: RCAB, x: torch.Tensor, res_scale: float, padding: int,
         quant: Optional[QuantSites] = None,
         name: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """One residual channel-attention block (module path ``name``).
    Returns (out, attention [N, C])."""
    out = conv2d(x, site_weight(quant, f"{name}.conv1", blk.conv1.weight), blk.conv1.bias,
                 padding=padding)
    out = prelu(out, blk.prelu.weight)
    out = conv2d(out, site_weight(quant, f"{name}.conv2", blk.conv2.weight), blk.conv2.bias,
                 padding=padding)
    out, attn = channel_attention(blk.channel_attention, out)
    return x + out * res_scale, attn


def _rcab_on(shard, tp, *args):
    with spatial.rows(shard), tensor.split(tp):
        return rcab(*args)


def _save_only(ops):
    """Selective-checkpoint policy: keep the outputs of ``ops``, recompute
    every other op of the block in the backward pass."""
    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


# what each selective remat mode keeps of an RCAB (the JAX package's
# checkpoint names): "save_ca" the SE squeeze (mean) and gate (sigmoid),
# [N, C] each; "save_convs" the two conv outputs (the bias add, elementwise,
# is recomputed)
_SAVED_OPS = {
    "save_ca": (torch.ops.aten.mean.dim, torch.ops.aten.sigmoid.default),
    "save_convs": (torch.ops.aten.convolution.default,),
}
REMAT_MODES = ("rcab", "save_ca", "save_convs", "none")


def residual_groups(groups: nn.ModuleList, x: torch.Tensor, res_scale: float,
                    padding: int, collect_attention: bool = False,
                    remat: str = "rcab", quant: Optional[QuantSites] = None,
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain trunk: each group runs its RCABs, then the tail conv and
    the group skip. Returns (features, attention [G, B, N, C] if
    ``collect_attention`` else None).

    ``remat`` trades backward-pass memory for recompute, per RCAB:
    "rcab" keeps only each block's input and recomputes the block;
    "save_ca" also keeps the SE squeeze and gate, so the recompute skips
    the global mean over the feature map; "save_convs" keeps the two conv
    outputs and recomputes only the elementwise tail; "none" keeps what
    autograd saves. All four give the same gradients. ``quant`` holds the
    sites under the module path ``residual_groups.{g}...``."""
    if remat not in REMAT_MODES:
        raise ValueError(f"Unknown remat mode: {remat!r}")
    block_fn = rcab
    if remat != "none":
        context_fn = noop_context_fn
        if remat in _SAVED_OPS:
            context_fn = functools.partial(create_selective_checkpoint_contexts,
                                           _save_only(_SAVED_OPS[remat]))

        # the recompute runs in the backward pass, maybe on autograd's
        # thread: it re-enters this forward's row and model shards itself
        shard, tp = spatial.current(), tensor.current()

        def block_fn(blk, h, scale, pad, quant, name):
            return checkpoint(_rcab_on, shard, tp, blk, h, scale, pad, quant, name,
                              use_reentrant=False, preserve_rng_state=False,
                              context_fn=context_fn)

    attns: List[torch.Tensor] = []
    for gi, g in enumerate(groups):
        res = x
        for bi, blk in enumerate(g.blocks):
            x, attn = block_fn(blk, x, res_scale, padding, quant,
                               f"residual_groups.{gi}.blocks.{bi}")
            if collect_attention:
                attns.append(attn)
        x = conv2d(x, site_weight(quant, f"residual_groups.{gi}.conv", g.conv.weight),
                   g.conv.bias, padding=padding) + res
    if not collect_attention:
        return x, None
    return x, torch.stack(attns).reshape(len(groups), -1, *attns[0].shape)


def upsample(up: Upsample, x: torch.Tensor, next_w=None, keep_last_packed: bool = False,
             quant: Optional[QuantSites] = None, name: str = "upsample") -> torch.Tensor:
    """Cascaded conv -> PixelShuffle(2) -> PReLU stages.

    ``next_w`` is the weight that consumes the result (conv_last's). When
    the conv after a stage is a calibrated int8 site, the stage applies
    the PReLU in the packed layout (each slope repeated 4 times,
    channel-major: packed channel c*4 + phase is channel c) and quantizes
    onto that conv's static grid before the shuffle, which then moves
    int8. Both commute with the shuffle, so this equals the float order
    bitwise on the same grid. ``keep_last_packed`` skips the last shuffle
    and returns the packed int8 tensor [N, H, W, 4C] for a
    subpixel-packed conv_last. ``name`` is the module path of ``up``
    (its sites are ``{name}.stages.{i}.conv``)."""
    stages = list(up.stages)
    for i, st in enumerate(stages):
        y = conv2d(x, site_weight(quant, f"{name}.stages.{i}.conv", st.conv.weight),
                   st.conv.bias, padding=1)
        nxt = (site_weight(quant, f"{name}.stages.{i + 1}.conv", stages[i + 1].conv.weight)
               if i + 1 < len(stages) else next_w)
        if is_int8_kernel(nxt) and y.dtype.is_floating_point:
            y = prelu(y, st.prelu.weight.repeat_interleave(4))
            y = quantize_act(y, nxt.a)
            if keep_last_packed and i + 1 == len(stages):
                return y
            x = pixel_shuffle(y, 2)
        else:
            x = prelu(pixel_shuffle(y, 2), st.prelu.weight)
    return x
