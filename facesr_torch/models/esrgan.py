"""ESRGAN / RRDBNet baseline as an nn.Module over NHWC tensors.

Port of `facesr/models/esrgan.py`: RRDBNet with N RRDB blocks (each three
residual dense blocks, x0.2 residual scaling), two nearest-x2 upsample
convs and LeakyReLU(0.2). Parameter names follow the RealESRGAN state
dict (`conv_first`, `body.{i}.rdb{1,2,3}.conv{1..5}`, `conv_body`,
`conv_up1`, `conv_up2`, `conv_hr`, `conv_last`), so official and
reference `.pth` files load with ``strict=True``.

``forward(x, train=False, dtype=None, quant=None)`` has FaceEnhanceNet's
signature, so `Predictor`, the Trainer and the evaluation CLIs call it
unchanged; like the JAX ``apply`` it does not clamp. Every conv is a
cuDNN conv (the JAX package runs them through XLA, not Pallas). A dense
block concatenates its growing feature maps with `torch.cat` (four times
a block). ``quant`` maps conv sites (module paths: ``conv_first``,
``body.{i}.rdb{r}.conv{k}``, ``conv_up1``, ...) to int8 serving or QAT
sites (`ops.quant`): under ``int8_full`` a dense conv quantizes its whole
concatenated input with one per-image scale, as the JAX package does.
There is no packed int8 layout: the upsample is `nearest_up` then a conv.
On row shards (`parallel.spatial`) every conv takes its halo rows through
`conv2d`; `nearest_up` and the dense blocks' `torch.cat` are row-local.

`ESRGANBaseline` is the frozen pretrained baseline: an `RRDBNet` whose
eval forward clamps to [0, 1] (the JAX ``__call__``), with uint8
``inference``/``inference_batch``. Its weights come from
`resolve_pretrained_weights`: ``<weights_dir>/<name>.fckpt``, else
``<name>.pth`` converted once to that ``.fckpt``. There is no download:
when neither file is there it warns and runs randomly initialized, the
JAX package's offline behaviour. A ``.pth`` that does not convert is
quarantined to ``<name>.pth.bad``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.models.blocks import make_conv
from facesr_torch.ops import init as finit
from facesr_torch.ops.conv import conv2d, leaky_relu
from facesr_torch.ops.quant import QuantSites, site_weight
from facesr_torch.ops.resize import nearest_up

__all__ = ["RRDBNetConfig", "RDB", "RRDB", "RRDBNet", "ESRGANBaseline", "rdb", "rrdb",
           "make_rrdb", "infer_rrdbnet_config", "param_count", "resolve_pretrained_weights",
           "create_esrgan_baseline"]


@dataclass
class RRDBNetConfig:
    """Mirrors the JAX package's `RRDBNetConfig` (RealESRGAN x4plus)."""

    in_channels: int = 3
    out_channels: int = 3
    num_feat: int = 64
    num_blocks: int = 23
    num_grow_ch: int = 32
    scale: int = 4


class RDB(nn.Module):
    """Residual dense block: five 3x3 convs over the dense concatenation."""

    def __init__(self, nf: int, gc: int):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i + 1}", make_conv(nf + i * gc, gc if i < 4 else nf, 3))


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = RDB(nf, gc), RDB(nf, gc), RDB(nf, gc)


@torch.no_grad()
def _init_conv(conv: nn.Conv2d, gen: torch.Generator, scale: float = 0.1) -> None:
    """ESRGAN init: Kaiming fan_in (leaky_relu, a=0.2) scaled by ``scale``
    (0.1 in the dense blocks), zero bias."""
    conv.weight.copy_(finit.kaiming_normal(conv.weight.shape, gen, mode="fan_in",
                                           nonlinearity="leaky_relu", a=0.2, scale=scale))
    conv.bias.zero_()


def make_rrdb(nf: int, gc: int, gen: torch.Generator) -> RRDB:
    blk = RRDB(nf, gc)
    for r in (blk.rdb1, blk.rdb2, blk.rdb3):
        for i in range(5):
            _init_conv(getattr(r, f"conv{i + 1}"), gen)
    return blk


def _conv(conv: nn.Conv2d, x: torch.Tensor, quant: Optional[QuantSites] = None,
          name: str = "") -> torch.Tensor:
    return conv2d(x, site_weight(quant, name, conv.weight), conv.bias, padding=1)


def rdb(m: RDB, x: torch.Tensor, quant: Optional[QuantSites] = None,
        name: str = "") -> torch.Tensor:
    """Five convs with dense concatenation, x0.2 skip (NHWC); ``name`` is
    the block's module path (its sites are ``{name}.conv{k}``)."""
    feats = [x]
    for i in range(1, 5):
        feats.append(leaky_relu(_conv(getattr(m, f"conv{i}"), torch.cat(feats, -1), quant,
                                      f"{name}.conv{i}"), 0.2))
    return x + 0.2 * _conv(m.conv5, torch.cat(feats, -1), quant, f"{name}.conv5")


def rrdb(m: RRDB, x: torch.Tensor, quant: Optional[QuantSites] = None,
         name: str = "") -> torch.Tensor:
    """Three RDBs, x0.2 block skip (``name``: the block's module path)."""
    out = x
    for r in ("rdb1", "rdb2", "rdb3"):
        out = rdb(getattr(m, r), out, quant, f"{name}.{r}")
    return x + 0.2 * out


class RRDBNet(nn.Module):
    """RRDBNet on NHWC tensors. Weights are drawn from a CPU
    `torch.Generator` seeded with ``seed`` (the ESRGAN init), then placed
    on ``device`` (CUDA unless the caller names one). Only scale 4 is
    built (two nearest-x2 stages, as the reference architecture)."""

    model_type = "esrgan"

    def __init__(self, config: Optional[RRDBNetConfig] = None, seed: int = 0,
                 device: DeviceLike = None, **kwargs):
        super().__init__()
        cfg = config or RRDBNetConfig()
        if kwargs:
            cfg = replace(cfg, **kwargs)
        if cfg.scale != 4:
            raise ValueError(
                f"RRDBNet supports scale=4 only (two nearest-x2 stages); got "
                f"scale={cfg.scale}. RealESRGAN x2 checkpoints use the pixel-unshuffle "
                "input variant, which is not implemented.")
        self.config = cfg
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        nf = cfg.num_feat
        self.conv_first = make_conv(cfg.in_channels, nf, 3)
        self.body = nn.ModuleList(make_rrdb(nf, cfg.num_grow_ch, gen)
                                  for _ in range(cfg.num_blocks))
        self.conv_body = make_conv(nf, nf, 3)
        self.conv_up1 = make_conv(nf, nf, 3)
        self.conv_up2 = make_conv(nf, nf, 3)
        self.conv_hr = make_conv(nf, nf, 3)
        self.conv_last = make_conv(nf, cfg.out_channels, 3)
        for conv in (self.conv_first, self.conv_body, self.conv_up1, self.conv_up2,
                     self.conv_hr, self.conv_last):
            _init_conv(conv, gen, scale=1.0)
        self.to(dev)

    def forward(self, x: torch.Tensor, train: bool = False,
                dtype: Optional[torch.dtype] = None,
                quant: Optional[QuantSites] = None) -> torch.Tensor:
        """NHWC LR image in [0, 1] -> NHWC SR image (4x spatial), f32, not
        clamped (the JAX ``apply``). ``train`` changes nothing (no
        dropout, no normalisation); ``quant``: the int8 serving or QAT
        sites (`ops.quant`)."""
        h = x.to(dtype) if dtype is not None else x
        feat = _conv(self.conv_first, h, quant, "conv_first")
        body = feat
        for i, blk in enumerate(self.body):
            body = rrdb(blk, body, quant, f"body.{i}")
        feat = feat + _conv(self.conv_body, body, quant, "conv_body")
        feat = leaky_relu(_conv(self.conv_up1, nearest_up(feat, 2), quant, "conv_up1"), 0.2)
        feat = leaky_relu(_conv(self.conv_up2, nearest_up(feat, 2), quant, "conv_up2"), 0.2)
        feat = leaky_relu(_conv(self.conv_hr, feat, quant, "conv_hr"), 0.2)
        return _conv(self.conv_last, feat, quant, "conv_last").float()

    def get_model_info(self) -> Dict[str, Any]:
        total = param_count(self)
        return {"name": type(self).__name__, "total_params": total,
                "trainable_params": sum(p.numel() for p in self.parameters()
                                        if p.requires_grad),
                "size_mb": total * 4 / (1024 ** 2), **asdict(self.config)}


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def infer_rrdbnet_config(params: Dict[str, Any], scale: int = 4) -> RRDBNetConfig:
    """An RRDBNetConfig from the JAX parameter shapes (HWIO kernels, a body
    stacked on a leading axis), for a checkpoint without config metadata."""
    first_w = np.shape(params["conv_first"]["w"])
    rdb1_w = np.shape(params["body"]["rdb1"]["conv1_w"])
    return RRDBNetConfig(in_channels=int(first_w[-2]),
                         out_channels=int(np.shape(params["conv_last"]["w"])[-1]),
                         num_feat=int(first_w[-1]), num_blocks=int(rdb1_w[0]),
                         num_grow_ch=int(rdb1_w[-1]), scale=scale)


def resolve_pretrained_weights(model_name: str = "RealESRGAN_x4plus",
                               weights_dir: str = "checkpoints/pretrained") -> Optional[str]:
    """The converted weights of ``model_name``: ``<weights_dir>/<name>.fckpt``
    when it exists; else ``<name>.pth`` (an official or reference RRDBNet
    state dict) converted once to that ``.fckpt``, which the JAX package
    reads too. Returns None after a warning when neither file is there
    (the caller runs randomly initialized), when the conversion fails for
    want of disk or memory (the ``.pth`` stays, to retry), or when the
    ``.pth`` is not an RRDBNet state dict (quarantined to
    ``<name>.pth.bad``). Nothing is downloaded."""
    from facesr_torch.ckpt.fckpt import save_model
    from facesr_torch.models.load import build_model, read_model_state

    d = Path(weights_dir)
    fckpt = d / f"{model_name}.fckpt"
    if fckpt.exists():
        return str(fckpt)
    pth = d / f"{model_name}.pth"
    if not pth.exists():
        print(f"Warning: no {model_name} weights at {fckpt} or {pth} (this port does not "
              "download them); place the official .pth there to enable the pretrained "
              "baseline.")
        return None
    try:
        mtype, cfg, sd = read_model_state(pth, model_type="esrgan")
        if mtype != "esrgan":
            raise ValueError(f"it holds a {mtype!r} model")
        save_model(str(fckpt), build_model(mtype, cfg, sd, where=str(pth)))
    except (OSError, MemoryError) as e:
        print(f"Warning: could not convert {pth} ({type(e).__name__}: {e}); leaving it in "
              "place: conversion will retry on the next construction. Running randomly "
              "initialized.")
        return None
    except Exception as e:  # noqa: BLE001 — a bad .pth must not break construction
        bad = d / f"{model_name}.pth.bad"
        try:
            pth.replace(bad)
            where = f"quarantined to {bad}"
        except OSError:
            where = f"left at {pth}"
        print(f"Warning: {pth} is not a loadable {model_name} state dict "
              f"({type(e).__name__}: {e}); {where}. Running randomly initialized.")
        return None
    print(f"Converted {pth} -> {fckpt}")
    return str(fckpt)


class ESRGANBaseline(RRDBNet):
    """The frozen pretrained baseline (reference esrgan.py:106-260).

    With no ``weights_path``, ``model_name`` is resolved through
    `resolve_pretrained_weights` in ``weights_dir``. A ``weights_path``
    is a ``.fckpt`` or a ``.pth`` (told apart by content). When nothing
    resolves it warns and runs randomly initialized (seeded), and
    ``pretrained`` is False. The eval forward (``train`` False) clamps to
    [0, 1], as the JAX ``__call__`` does; ``train=True`` is the unclamped
    RRDBNet forward the Trainer differentiates."""

    def __init__(self, weights_path: Optional[str] = None, scale: int = 4,
                 model_name: str = "RealESRGAN_x4plus",
                 weights_dir: str = "checkpoints/pretrained", seed: int = 0,
                 device: DeviceLike = None):
        from facesr_torch.models.load import read_model_state

        self.model_name = model_name
        if weights_path is None:
            weights_path = resolve_pretrained_weights(model_name, weights_dir)
        sd, cfg = None, RRDBNetConfig(scale=scale)
        if weights_path:
            mtype, cfg, sd = read_model_state(weights_path, model_type="esrgan")
            if mtype != "esrgan":
                raise ValueError(f"{weights_path} holds a {mtype!r} model, not an RRDBNet")
            cfg = replace(cfg, scale=scale)
        super().__init__(cfg, seed=seed, device="cpu")
        self.pretrained = sd is not None
        if sd is not None:
            self.load_state_dict(sd, strict=True)
        else:
            print("Warning: no RealESRGAN weights provided; ESRGANBaseline runs randomly "
                  "initialized (place the official .pth in the weights directory).")
        self.eval().to(resolve_device(device))

    def forward(self, x: torch.Tensor, train: bool = False,
                dtype: Optional[torch.dtype] = None,
                quant: Optional[QuantSites] = None) -> torch.Tensor:
        out = super().forward(x, train=train, dtype=dtype, quant=quant)
        return out if train else out.clamp(0.0, 1.0)

    @torch.inference_mode()
    def inference_batch(self, images_uint8: np.ndarray) -> np.ndarray:
        """NHWC uint8 -> SR NHWC uint8 (f32 forward, clamped, rounded)."""
        dev = self.conv_first.weight.device
        x = torch.from_numpy(np.asarray(images_uint8).astype(np.float32) / 255.0).to(dev)
        out = self(x).cpu().numpy()
        return (np.clip(out, 0, 1) * 255).round().astype(np.uint8)

    def inference(self, image_uint8: np.ndarray) -> np.ndarray:
        """HWC uint8 -> SR HWC uint8 (reference esrgan.py:205-231)."""
        return self.inference_batch(np.asarray(image_uint8)[None])[0]


def create_esrgan_baseline(weights_path: Optional[str] = None, **kwargs) -> ESRGANBaseline:
    return ESRGANBaseline(weights_path=weights_path, **kwargs)
