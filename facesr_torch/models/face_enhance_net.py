"""FaceEnhanceNet — the flagship 4x face-SR generator, as an nn.Module.

Port of `facesr/models/face_enhance_net.py`:

  conv_first (3 -> C) -> G residual groups (B RCABs each) ->
  conv_after_body + feature skip -> log2(scale) PixelShuffle stages ->
  conv_last (C -> 3, zero-init) -> + f32 global bicubic skip -> clamp at eval.

``forward`` takes and returns NHWC. The eval forward with
``dtype=torch.bfloat16`` (serving) of a config the group kernel takes
(`kernel_trunk_fits`: C = 64, 3x3 convs) runs the trunk as
`fused_residual_group`, one call per group: the Hopper kernel on a CUDA
tensor, its plain version on a CPU tensor. The choice is made once, from
the config. Every other forward runs the plain trunk
(`blocks.residual_groups`) in the compute dtype, as the JAX package's
``apply`` does: ``dtype=None`` is f32, a bf16 model of another width or
kernel size runs it in bf16, and ``train=True`` always takes it, with the
config's ``remat`` mode, because the kernel is forward-only (the JAX
package trains through XLA too).

``forward(..., quant=sites)`` runs the int8 serving or QAT forward
(`ops.quant`): every conv site in ``sites`` takes the s8 conv or the
fake-quant conv, through the plain trunk. With calibrated scales the
upsample feeds conv_last in the packed layout and conv_last runs
subpixel-packed, as the JAX ``apply`` does on a transformed tree.
Weight-only int8 serving is the bf16 forward of a copy of the model that
holds the dequantized weights (`parallel.serving.build_serving_fn`), so it
takes the kernel trunk.

On two or more row shards (`parallel.spatial`: `SpatialPredictor` over a
mesh, training on `data,space`) the forward is the same code on the
shard's rows, and the bf16 eval forward takes the plain trunk: a residual
group cannot be one kernel launch there, since every RCAB's SE gate needs
the mean over the whole image and each of the group's convs a halo row of
the neighbouring shard, exchanges between launches that the kernel does
not make (a variant that exports its SE partial sums and takes a halo plan
is on ROADMAP's perf list). One shard keeps the kernel trunk.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.models import blocks
from facesr_torch.ops.conv import conv2d
from facesr_torch.ops.pixel_shuffle import pixel_shuffle
from facesr_torch.ops.quant import QuantSites, is_int8_kernel, site_weight
from facesr_torch.ops.rcab_group import (KERNEL_CHANNELS, GroupWeights,
                                         fused_residual_group, prepare_group_weights)
from facesr_torch.ops.resize import bicubic_up
from facesr_torch.parallel import spatial, tensor

__all__ = ["FaceEnhanceNetConfig", "FaceEnhanceNet", "kernel_trunk_fits", "param_count",
           "get_model_info"]


@dataclass
class FaceEnhanceNetConfig:
    """Mirrors the reference `FaceEnhanceNetConfig` (and the JAX package's)."""

    num_channels: int = 64
    num_groups: int = 3
    blocks_per_group: int = 4
    kernel_size: int = 3
    reduction_ratio: int = 4
    scale_factor: int = 4
    res_scale: float = 0.2
    in_channels: int = 3
    out_channels: int = 3
    init_scale: float = 0.1
    # backward-pass memory/recompute trade of the trunk in training:
    # "rcab" | "save_ca" | "save_convs" | "none" (blocks.residual_groups);
    # eval forwards use "none"
    remat: str = "save_ca"

    def replace(self, **kwargs) -> "FaceEnhanceNetConfig":
        d = asdict(self)
        if "upscale_factor" in kwargs:  # reference YAML spelling
            kwargs["scale_factor"] = kwargs.pop("upscale_factor")
        unknown = set(kwargs) - set(d)
        if unknown:
            raise TypeError(f"Unknown FaceEnhanceNetConfig field(s): "
                            f"{sorted(unknown)}")
        d.update(kwargs)
        return FaceEnhanceNetConfig(**d)


TrunkFn = Callable[[nn.ModuleList, torch.Tensor], torch.Tensor]


def kernel_trunk_fits(cfg: FaceEnhanceNetConfig) -> bool:
    """Whether the group kernel takes this config's trunk: C =
    `KERNEL_CHANNELS`, 3x3 convs and an SE width within 1..C (the checks
    of `fused_residual_group` and of the kernel's entry)."""
    c = cfg.num_channels
    return (c == KERNEL_CHANNELS and cfg.kernel_size == 3
            and 1 <= blocks.reduced_channels(c, cfg.reduction_ratio) <= c)


class FaceEnhanceNet(blocks.KernelWeightCache, nn.Module):
    """FaceEnhanceNet on NHWC tensors. Weights are drawn from a CPU
    `torch.Generator` seeded with ``seed`` (Kaiming fan_out/relu, PReLU
    0.25, ICNR upsample convs, zero conv_last), then placed on ``device``
    (CUDA unless the caller names one)."""

    model_type = "custom"
    subpixel_site = "conv_last"  # runs subpixel-packed when calibrated int8

    def __init__(self, config: Optional[FaceEnhanceNetConfig] = None,
                 seed: int = 0, device: DeviceLike = None, **kwargs):
        super().__init__()
        cfg = config or FaceEnhanceNetConfig()
        if kwargs:
            cfg = cfg.replace(**kwargs)
        self.config = cfg
        # the bf16 eval trunk, chosen once from the config
        self.kernel_trunk = kernel_trunk_fits(cfg)
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        c, k = cfg.num_channels, cfg.kernel_size
        # built on the CPU (where the generator draws), moved once at the end
        self.conv_first = blocks.make_conv(cfg.in_channels, c, k)
        blocks.init_conv(self.conv_first, gen)
        self.residual_groups = blocks.make_residual_groups(
            cfg.num_groups, cfg.blocks_per_group, c, k, cfg.reduction_ratio, gen)
        self.conv_after_body = blocks.make_conv(c, c, k)
        blocks.init_conv(self.conv_after_body, gen)
        self.upsample = blocks.make_upsample(c, cfg.scale_factor, gen)
        # zero-init: the initial output equals the bicubic upsample exactly
        self.conv_last = blocks.make_conv(c, cfg.out_channels, k)
        with torch.no_grad():
            self.conv_last.weight.zero_()
            self.conv_last.bias.zero_()
        self.to(dev)

    def forward(self, x: torch.Tensor, train: bool = False,
                dtype: Optional[torch.dtype] = None,
                trunk_fn: Optional[TrunkFn] = None,
                quant: Optional[QuantSites] = None) -> torch.Tensor:
        """NHWC LR image in [0, 1] -> NHWC SR image (scale x spatial),
        clamped to [0, 1] only when ``train`` is False.

        ``trunk_fn(residual_groups, feat) -> feat`` overrides the trunk (the
        JAX ``trunk_fn`` hook). By default the eval forward in bf16 runs
        the group kernel where the config fits it (``self.kernel_trunk``)
        and every other forward the plain trunk, with ``config.remat`` when
        ``train``. ``quant`` maps conv sites to int8 or QAT sites
        (`ops.quant`), which take the plain trunk."""
        cfg = self.config
        pad = cfg.kernel_size // 2
        skip = bicubic_up(x.float(), cfg.scale_factor)

        h = x.to(dtype) if dtype is not None else x
        feat = conv2d(h, site_weight(quant, "conv_first", self.conv_first.weight),
                      self.conv_first.bias, padding=pad, dtype=dtype)
        residual = feat
        if trunk_fn is not None:
            feat = trunk_fn(self.residual_groups, feat)
        elif (dtype == torch.bfloat16 and not train and self.kernel_trunk and quant is None
              and spatial.current() is None and tensor.current() is None):
            feat = feat.contiguous()
            for gw in self.kernel_group_weights():
                feat = fused_residual_group(feat, gw, cfg.res_scale)
        else:
            feat, _ = blocks.residual_groups(self.residual_groups, feat,
                                             cfg.res_scale, pad,
                                             remat=cfg.remat if train else "none",
                                             quant=quant)
        feat = conv2d(feat, site_weight(quant, "conv_after_body", self.conv_after_body.weight),
                      self.conv_after_body.bias, padding=pad)
        feat = feat + residual
        w_last = site_weight(quant, "conv_last", self.conv_last.weight)
        # calibrated int8: conv_last reads the upsample's packed int8 output
        # through the subpixel-repacked kernel (bitwise the same: integer
        # sums commute with the shuffle), and the shuffle moves 3 channels
        subpixel = (is_int8_kernel(w_last) and cfg.kernel_size == 3
                    and cfg.scale_factor in (2, 4))
        feat = blocks.upsample(self.upsample, feat, next_w=w_last,
                               keep_last_packed=subpixel, quant=quant)
        if subpixel and feat.dtype == torch.int8:
            res = pixel_shuffle(conv2d(feat, w_last.subpixel_packed(),
                                       self.conv_last.bias.repeat_interleave(4), padding=1), 2)
        else:
            res = conv2d(feat, w_last, self.conv_last.bias, padding=pad)
        out = res.float() + skip
        if not train:
            out = out.clamp(0.0, 1.0)
        return out

    @torch.no_grad()
    def get_attention_maps(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-RCAB SE attention weights [N, C] of the plain f32 trunk,
        keyed 'group{g}_rcab{b}'."""
        cfg = self.config
        pad = cfg.kernel_size // 2
        feat = conv2d(x, self.conv_first.weight, self.conv_first.bias, padding=pad)
        _, attn = blocks.residual_groups(self.residual_groups, feat,
                                         cfg.res_scale, pad,
                                         collect_attention=True, remat="none")
        return {f"group{g}_rcab{b}": attn[g, b]
                for g in range(cfg.num_groups)
                for b in range(cfg.blocks_per_group)}

    def get_model_info(self) -> Dict[str, Any]:
        return get_model_info(self, self.config)

    def kernel_group_weights(self) -> List[GroupWeights]:
        """Each residual group's weights in the kernel layout, for the bf16
        trunk (cached, `blocks.KernelWeightCache`)."""
        return self.cached_kernel_weights(list(self.residual_groups.parameters()),
                                          self.kernel_groups)

    def kernel_groups(self, weights: Optional[Dict[str, torch.Tensor]] = None
                      ) -> List[GroupWeights]:
        """The kernel-layout weights of the residual groups that the bf16
        eval forward runs on the group kernel ([] where the config does
        not fit it), prepared anew: from the parameters, or with the conv
        weights of ``weights`` (site -> tensor) in their place."""
        if not self.kernel_trunk:
            return []
        return [prepare_group_weights(blocks.group_with(
                    g.blocks, g.conv, weights or {}, f"residual_groups.{i}.blocks",
                    f"residual_groups.{i}.conv"))
                for i, g in enumerate(self.residual_groups)]

    def kernel_forward(self, groups: List[GroupWeights]) -> Dict[str, TrunkFn]:
        """The `forward` arguments that run the kernel groups on the weights
        ``groups`` (`kernel_groups`'s layout)."""
        return {"trunk_fn": lambda _, feat: blocks.run_kernel_groups(feat, groups,
                                                                     self.config.res_scale)}


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def get_model_info(model: nn.Module, cfg: FaceEnhanceNetConfig) -> Dict[str, Any]:
    """Model statistics (the JAX package's `get_model_info`)."""
    total = param_count(model)
    input_size = 64
    return {
        "name": "FaceEnhanceNet",
        "total_params": total,
        "trainable_params": sum(p.numel() for p in model.parameters()
                                if p.requires_grad),
        "size_mb": total * 4 / (1024 ** 2),
        "num_groups": cfg.num_groups,
        "blocks_per_group": cfg.blocks_per_group,
        "total_rcab_blocks": cfg.num_groups * cfg.blocks_per_group,
        "num_channels": cfg.num_channels,
        "scale_factor": cfg.scale_factor,
        "input_size": f"{input_size}x{input_size}",
        "output_size": f"{input_size * cfg.scale_factor}x{input_size * cfg.scale_factor}",
    }
