"""Transfer-learning SR model: an ESRGAN backbone and a face-specific RCAB
head, as an nn.Module over NHWC tensors.

Port of `facesr/models/transfer.py`. Parameter names follow the reference
state dict: ``backbone.{conv_first, body.{i}.rdb{j}.conv{c}, conv_body}``
and ``face_head.{rcab_blocks.{b}.*, conv_after, upsample.stages.{s}.*,
conv_last}``. The JAX package stores the body as two stacks,
``body_main`` and ``body_tail``, only to say which blocks train in stage
2; here the body is one `ModuleList` and the tail is its last
``min(STAGE2_UNFREEZE_BLOCKS, backbone_blocks)`` blocks.

Freezing: `set_training_stage` sets ``requires_grad`` from `param_labels`
('frozen' / 'backbone' / 'head'), as the reference mutates it per stage;
the Trainer differentiates and updates the parameters that require grad
only, which equals the JAX package's multi-transform (frozen leaves get a
zero update; clipping, weight decay and the Adam moments cover the
trained leaves) and skips the frozen backbone's backward.
`make_stage_optimizer` (training/optim.py `StageAdamW`) is the per-group
learning-rate optimiser of `facesr/models/transfer.py:193-212`.

The head is one residual group: ``head_blocks`` RCABs at res_scale 0.2 and
reduction 4, the tail conv ``conv_after`` and the skip. The eval forward
in bf16 of a head the group kernel takes (64 channels, SE width within
1..C; `head_kernel_fits`) runs it as one `fused_residual_group` call: the
Hopper kernel on a CUDA tensor, its plain version on a CPU tensor.
Training, f32 and other widths run the plain head, as the JAX ``apply``.

``forward(..., quant=sites)`` runs the int8 serving or QAT forward
(`ops.quant`; sites under the module paths ``backbone.body.{i}.rdb{r}.
conv{k}``, ``face_head.rcab_blocks.{b}.conv1``, ...) through the plain
head. With a calibrated ``conv_last`` the head's int8 arm runs as the JAX
``apply``'s: the upsample keeps its output packed on conv_last's static
grid and conv_last runs subpixel-packed, its scale and bias repeated
channel-major (``repeat_interleave``), then the shuffle. Weight-only
int8 serves the bf16 forward of a copy that holds the dequantized
weights (`parallel.serving.build_serving_fn`), so its head takes the
kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.models import blocks
from facesr_torch.models.esrgan import _init_conv, make_rrdb, rrdb
from facesr_torch.ops.conv import conv2d
from facesr_torch.ops.pixel_shuffle import pixel_shuffle
from facesr_torch.ops.quant import QuantSites, is_int8_kernel, site_weight
from facesr_torch.ops.rcab_group import (KERNEL_CHANNELS, GroupWeights, fused_residual_group,
                                         prepare_group_weights)
from facesr_torch.parallel import spatial, tensor

__all__ = ["STAGE2_UNFREEZE_BLOCKS", "HEAD_RES_SCALE", "HEAD_REDUCTION", "TrainingStage",
           "TransferModelConfig", "TransferSRModel", "FaceHead", "Backbone", "head_kernel_fits",
           "plain_head", "param_labels", "stage_learning_rates", "make_stage_optimizer",
           "trainable_param_count", "create_transfer_model"]

STAGE2_UNFREEZE_BLOCKS = 4
HEAD_RES_SCALE = 0.2
HEAD_REDUCTION = 4
GROWTH = 32  # the backbone's dense growth channels (the JAX init's)


class TrainingStage(Enum):
    STAGE1_HEAD_ONLY = 1
    STAGE2_PARTIAL_FINETUNE = 2
    STAGE3_FULL_FINETUNE = 3


@dataclass
class TransferModelConfig:
    """Mirrors the JAX package's `TransferModelConfig`."""

    backbone_blocks: int = 16
    freeze_blocks: int = 16
    head_blocks: int = 4
    head_channels: int = 64
    scale_factor: int = 4
    stage1_lr: float = 2e-4
    stage2_lr: float = 2e-5
    stage3_lr: float = 1e-5


class Backbone(nn.Module):
    def __init__(self, nf: int, num_blocks: int, gc: int, gen: torch.Generator):
        super().__init__()
        self.conv_first = blocks.make_conv(3, nf, 3)
        self.body = nn.ModuleList(make_rrdb(nf, gc, gen) for _ in range(num_blocks))
        self.conv_body = blocks.make_conv(nf, nf, 3)
        _init_conv(self.conv_first, gen, scale=1.0)
        _init_conv(self.conv_body, gen, scale=1.0)


class FaceHead(nn.Module):
    def __init__(self, c: int, num_blocks: int, scale_factor: int, gen: torch.Generator):
        super().__init__()
        self.rcab_blocks = nn.ModuleList(blocks.RCAB(c, 3, HEAD_REDUCTION)
                                         for _ in range(num_blocks))
        for blk in self.rcab_blocks:
            blocks.init_rcab(blk, gen)
        self.conv_after = blocks.make_conv(c, c, 3)
        blocks.init_conv(self.conv_after, gen)
        self.upsample = blocks.make_upsample(c, scale_factor, gen)
        self.conv_last = blocks.make_conv(c, 3, 3)
        blocks.init_conv(self.conv_last, gen)


HeadFn = Callable[[FaceHead, torch.Tensor], torch.Tensor]


def plain_head(head: FaceHead, feat: torch.Tensor,
               quant: Optional[QuantSites] = None) -> torch.Tensor:
    """The head's residual group in the input's dtype: the RCABs, the tail
    conv and the skip (`facesr/models/transfer.py:130-137`), with the
    int8 or QAT sites of ``quant`` (module paths ``face_head.*``)."""
    residual = feat
    for b, blk in enumerate(head.rcab_blocks):
        feat, _ = blocks.rcab(blk, feat, HEAD_RES_SCALE, 1, quant=quant,
                              name=f"face_head.rcab_blocks.{b}")
    return conv2d(feat, site_weight(quant, "face_head.conv_after", head.conv_after.weight),
                  head.conv_after.bias, padding=1) + residual


def head_kernel_fits(cfg: TransferModelConfig) -> bool:
    """Whether the group kernel takes this config's head: C =
    `KERNEL_CHANNELS` and an SE width within 1..C (the head's convs are
    3x3)."""
    c = cfg.head_channels
    return (c == KERNEL_CHANNELS
            and 1 <= blocks.reduced_channels(c, HEAD_REDUCTION) <= c)


class TransferSRModel(blocks.KernelWeightCache, nn.Module):
    """TransferSRModel on NHWC tensors. Weights are drawn from a CPU
    `torch.Generator` seeded with ``seed`` (the JAX package's init
    scheme), the backbone optionally replaced from ``pretrained_path``
    (`load_pretrained_backbone`), then placed on ``device`` (CUDA unless
    named). Starts in stage 1 (the backbone frozen). ``num_grow_ch`` is
    the backbone's dense growth (32 in every config; a reference state
    dict may carry another, which `models.load` reads from its shapes)."""

    model_type = "transfer"
    subpixel_site = "face_head.conv_last"  # runs subpixel-packed when calibrated int8

    def __init__(self, config: Optional[TransferModelConfig] = None,
                 pretrained_path: Optional[str] = None, seed: int = 0,
                 device: DeviceLike = None, num_grow_ch: int = GROWTH):
        super().__init__()
        self.config = cfg = config or TransferModelConfig()
        self.kernel_head = head_kernel_fits(cfg)
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        nf = cfg.head_channels
        self.backbone = Backbone(nf, cfg.backbone_blocks, num_grow_ch, gen)
        self.face_head = FaceHead(nf, cfg.head_blocks, cfg.scale_factor, gen)
        self.current_stage = TrainingStage.STAGE1_HEAD_ONLY
        self._apply_stage()
        if pretrained_path:
            self.load_pretrained_backbone(pretrained_path)
        self.to(dev)

    def forward(self, x: torch.Tensor, train: bool = False,
                dtype: Optional[torch.dtype] = None, quant: Optional[QuantSites] = None,
                head_fn: Optional[HeadFn] = None) -> torch.Tensor:
        """NHWC LR image in [0, 1] -> NHWC SR image, f32, not clamped (the
        JAX ``apply``). ``head_fn(face_head, feat) -> feat`` overrides the
        head's residual group; by default the bf16 eval forward without
        ``quant`` runs the group kernel where the config fits it
        (``self.kernel_head``), every other forward `plain_head`; so does
        a forward on two or more row shards (`parallel.spatial`: the SE gate
        needs the whole image's mean). ``quant``: the int8 serving or QAT
        sites (`ops.quant`)."""
        bb, hd = self.backbone, self.face_head
        h = x.to(dtype) if dtype is not None else x
        feat = conv2d(h, site_weight(quant, "backbone.conv_first", bb.conv_first.weight),
                      bb.conv_first.bias, padding=1)
        body = feat
        for i, blk in enumerate(bb.body):
            body = rrdb(blk, body, quant, f"backbone.body.{i}")
        feat = feat + conv2d(body, site_weight(quant, "backbone.conv_body", bb.conv_body.weight),
                             bb.conv_body.bias, padding=1)
        if head_fn is not None:
            feat = head_fn(hd, feat)
        elif (dtype == torch.bfloat16 and not train and self.kernel_head and quant is None
              and spatial.current() is None and tensor.current() is None):
            feat = fused_residual_group(feat.contiguous(), self.kernel_head_weights(),
                                        HEAD_RES_SCALE)
        else:
            feat = plain_head(hd, feat, quant)
        w_last = site_weight(quant, "face_head.conv_last", hd.conv_last.weight)
        # calibrated int8: conv_last reads the upsample's packed int8 output
        # through the subpixel-repacked kernel (`facesr/models/transfer.py:
        # 139-156`; bitwise the unpacked order)
        subpixel = is_int8_kernel(w_last)
        feat = blocks.upsample(hd.upsample, feat, next_w=w_last, keep_last_packed=subpixel,
                               quant=quant, name="face_head.upsample")
        if subpixel and feat.dtype == torch.int8:
            out = pixel_shuffle(conv2d(feat, w_last.subpixel_packed(),
                                       hd.conv_last.bias.repeat_interleave(4), padding=1), 2)
        else:
            out = conv2d(feat, w_last, hd.conv_last.bias, padding=1)
        return out.float()

    def kernel_head_weights(self) -> GroupWeights:
        """The head's weights in the kernel layout (cached,
        `blocks.KernelWeightCache`)."""
        params = [p for n, p in self.face_head.named_parameters()
                  if n.startswith(("rcab_blocks.", "conv_after."))]
        return self.cached_kernel_weights(params, lambda: self.kernel_groups()[0])

    def kernel_groups(self, weights: Optional[Dict[str, torch.Tensor]] = None
                      ) -> List[GroupWeights]:
        """The head's kernel-layout weights as a list of one group ([] where
        the config does not fit the kernel), prepared anew: from the
        parameters, or with the conv weights of ``weights`` (site ->
        tensor) in their place."""
        if not self.kernel_head:
            return []
        hd = self.face_head
        return [prepare_group_weights(blocks.group_with(
            hd.rcab_blocks, hd.conv_after, weights or {}, "face_head.rcab_blocks",
            "face_head.conv_after"))]

    def kernel_forward(self, groups: List[GroupWeights]) -> Dict[str, HeadFn]:
        """The `forward` arguments that run the head on the kernel with the
        weights ``groups`` (`kernel_groups`'s layout)."""
        return {"head_fn": lambda _, feat: blocks.run_kernel_groups(feat, groups,
                                                                    HEAD_RES_SCALE)}

    # -- stages -------------------------------------------------------------
    def _apply_stage(self) -> None:
        labels = param_labels(self, self.current_stage)
        for name, p in self.named_parameters():
            p.requires_grad_(labels[name] != "frozen")

    def set_training_stage(self, stage: TrainingStage) -> None:
        self.current_stage = stage
        self._apply_stage()
        print(f"Training stage set to: {stage.name}")

    def get_trainable_params(self) -> List[Dict[str, Any]]:
        head_lr, backbone_lr = stage_learning_rates(self.config, self.current_stage)
        return [{"group": "backbone", "lr": backbone_lr}, {"group": "head", "lr": head_lr}]

    def get_model_info(self) -> Dict[str, Any]:
        total = sum(p.numel() for p in self.parameters())
        trainable = trainable_param_count(self, self.current_stage)
        return {
            "name": "TransferSRModel",
            "total_params": total,
            "trainable_params": trainable,
            "size_mb": total * 4 / (1024 ** 2),
            "backbone_blocks": self.config.backbone_blocks,
            "head_blocks": self.config.head_blocks,
            "current_stage": self.current_stage.name,
            "frozen_params": total - trainable,
        }

    @torch.no_grad()
    def load_pretrained_backbone(self, path: str) -> None:
        """Load an RRDBNet's ``conv_first``, first ``backbone_blocks`` body
        blocks and ``conv_body`` into the backbone, from a ``.fckpt``
        (RRDBNet or transfer), a port ``.pth`` or an official-layout state
        dict. Too few source blocks raise ValueError; more are truncated,
        and that is printed."""
        from facesr_torch.models.load import read_model_state

        _, _, sd = read_model_state(path, model_type="esrgan")
        if any(k.startswith("backbone.") for k in sd):  # a transfer model's backbone
            sd = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
        n_src = len({int(k.split(".")[1]) for k in sd if k.startswith("body.")})
        need = self.config.backbone_blocks
        if n_src < need:
            raise ValueError(
                f"Pretrained backbone at {path} has only {n_src} RRDB blocks; "
                f"config.backbone_blocks={need}: a short load would leave an empty stage-2 "
                "unfreeze set")
        if n_src > need:
            print(f"Using the first {need} of {n_src} source RRDB blocks")
        want = {k: v for k, v in sd.items()
                if k.split(".")[0] in ("conv_first", "conv_body")
                or (k.startswith("body.") and int(k.split(".")[1]) < need)}
        self.backbone.load_state_dict(want, strict=True)
        print(f"Loaded pre-trained backbone from {path}")


def param_labels(model: TransferSRModel, stage: TrainingStage) -> Dict[str, str]:
    """Every parameter's label for ``stage``: 'frozen', 'backbone' or
    'head' (the JAX package's `param_labels`, by parameter name)."""
    n = model.config.backbone_blocks
    tail = n - min(STAGE2_UNFREEZE_BLOCKS, n)  # the first block of body_tail
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "face_head":
            out[name] = "head"
        elif stage == TrainingStage.STAGE1_HEAD_ONLY:
            out[name] = "frozen"
        elif stage == TrainingStage.STAGE2_PARTIAL_FINETUNE:
            trains = parts[1] == "conv_body" or (parts[1] == "body" and int(parts[2]) >= tail)
            out[name] = "backbone" if trains else "frozen"
        else:
            out[name] = "backbone"
    return out


def stage_learning_rates(cfg: TransferModelConfig, stage: TrainingStage) -> Tuple[float, float]:
    """(head_lr, backbone_lr) of a stage (reference transfer.py:288-297)."""
    if stage == TrainingStage.STAGE1_HEAD_ONLY:
        return cfg.stage1_lr, 0.0
    if stage == TrainingStage.STAGE2_PARTIAL_FINETUNE:
        return cfg.stage2_lr, cfg.stage2_lr * 0.1
    return cfg.stage3_lr, cfg.stage3_lr


def make_stage_optimizer(model: TransferSRModel, stage: TrainingStage,
                         weight_decay: float = 0.0, gradient_clip: float = 0.0):
    """The per-group optimiser of ``stage``: AdamW at the stage's head and
    backbone learning rates, frozen parameters never updated
    (`training.optim.StageAdamW`; the JAX package's
    `make_stage_optimizer`). Pass it to the Trainer as ``optimizer``."""
    from facesr_torch.training.optim import StageAdamW

    head_lr, backbone_lr = stage_learning_rates(model.config, stage)
    return StageAdamW(param_labels(model, stage), head_lr, backbone_lr,
                      weight_decay=weight_decay, gradient_clip=gradient_clip)


def trainable_param_count(model: TransferSRModel, stage: TrainingStage) -> int:
    labels = param_labels(model, stage)
    return sum(p.numel() for n, p in model.named_parameters() if labels[n] != "frozen")


def create_transfer_model(pretrained_path: Optional[str] = None, seed: int = 0,
                          device: DeviceLike = None, **kwargs) -> TransferSRModel:
    known = {k: v for k, v in kwargs.items() if k in TransferModelConfig.__dataclass_fields__}
    return TransferSRModel(TransferModelConfig(**known), pretrained_path, seed=seed,
                           device=device)
