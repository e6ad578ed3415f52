"""Load any checkpoint the port reads into its model.

Port of `facesr/models/load.py`: the one dispatch by checkpoint content,
shared by the evaluation CLIs, the demo, the HTTP API and the export CLI.
A JAX ``.fckpt`` (a model or trainer file, EMA weights preferred) goes
through `ckpt.fckpt.load_model`; a torch zip ``.pth`` (the port's Trainer
checkpoint, or a reference state dict such as
`facesr/ckpt/export_torch.py` writes) is read for its
``ema_state_dict`` when it has one, else its ``model_state_dict``. The
architecture comes from the file's ``model_config``/``config``. Only
FaceEnhanceNet (``custom``/``lite``) is ported; the transfer and ESRGAN
models raise (ROADMAP A.12).
"""

from __future__ import annotations

from pathlib import Path

import torch

from facesr_torch.ckpt import fckpt
from facesr_torch.device import DeviceLike
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig

__all__ = ["load_any_model"]

_PTH_MAGIC = b"PK\x03\x04"  # torch.save's zip container


def load_any_model(path, device: DeviceLike = None) -> FaceEnhanceNet:
    """The FaceEnhanceNet in the checkpoint at ``path``, told apart by
    content, in eval mode. Built on the CPU and moved to ``device`` when
    one is named (left on the CPU otherwise: a loader does not pick a card
    for its caller)."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(4)
    if fckpt.is_fckpt(head):
        cfg, sd = fckpt.load_model(str(path))
    elif head == _PTH_MAGIC:
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
        if not isinstance(ckpt, dict) or "model_state_dict" not in ckpt:
            raise ValueError(f"{path} is not a FaceEnhanceNet checkpoint (no 'model_state_dict')")
        mtype = ckpt.get("model_type", "custom")
        if mtype not in ("custom", "lite"):
            raise NotImplementedError(f"{path}: model_type {mtype!r} is not ported yet "
                                      "(ROADMAP A.12); only 'custom' FaceEnhanceNet loads")
        known = set(FaceEnhanceNetConfig.__dataclass_fields__)
        cfg_dict = ckpt.get("model_config") or ckpt.get("config") or {}
        cfg = FaceEnhanceNetConfig(**{k: v for k, v in cfg_dict.items() if k in known})
        sd = ckpt.get("ema_state_dict") or ckpt["model_state_dict"]
    else:
        raise ValueError(f"{path} is neither a torch checkpoint nor a JAX .fckpt")
    model = FaceEnhanceNet(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    model.eval()
    return model.to(device) if device is not None else model
