"""Load any checkpoint the port reads into its model.

Port of `facesr/models/load.py`: the one dispatch by checkpoint content,
shared by the evaluation CLIs, the demo, the HTTP API and the export CLI.
It returns a `FaceEnhanceNet` (``custom``/``lite``), a `TransferSRModel`
(``transfer``) or an `RRDBNet` (``esrgan``).

- A JAX ``.fckpt`` (a model or trainer file, EMA weights preferred) goes
  through `ckpt.fckpt.load_model`, which reads its ``model_type``.
- A torch zip ``.pth``: the port's Trainer checkpoint (its
  ``ema_state_dict`` when it has one, else ``model_state_dict``, and its
  ``model_type``), or a reference state dict (unwrapped from
  ``model_state_dict`` / ``state_dict`` / ``params_ema`` / ``params``),
  whose type is told by its keys. The architecture is the file's
  ``model_config``/``config``, else inferred from the shapes.

A file whose weights do not fit its model (missing or extra keys, other
shapes) raises torch's RuntimeError, and one whose model cannot be told
or built ValueError; both name the file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from facesr_torch.ckpt import fckpt
from facesr_torch.device import DeviceLike
from facesr_torch.models.esrgan import RRDBNet, infer_rrdbnet_config
from facesr_torch.models.face_enhance_net import FaceEnhanceNet
from facesr_torch.models.transfer import GROWTH, TransferSRModel

__all__ = ["load_any_model", "read_model_state", "build_model", "sniff_model_type",
           "checkpoint_files"]

_PTH_MAGIC = b"PK\x03\x04"  # torch.save's zip container


def sniff_model_type(sd: Dict[str, Any]) -> Optional[str]:
    """A state dict's model type by its keys (validate_parity's rule)."""
    if any(k.startswith("residual_groups.0.blocks.0.") for k in sd):
        return "custom"
    if any(k.startswith("backbone.body.0.") for k in sd):
        return "transfer"
    if any(k.startswith("body.0.rdb1.") for k in sd):
        return "esrgan"
    return None


def _config_from_state_dict(mtype: str, sd: Dict[str, torch.Tensor]):
    from facesr_torch.ckpt.weights import (jax_params_from_esrgan_state_dict,
                                           jax_params_from_state_dict,
                                           jax_params_from_transfer_state_dict)

    if mtype == "esrgan":
        return infer_rrdbnet_config(jax_params_from_esrgan_state_dict(sd))
    if mtype == "transfer":
        return fckpt.infer_transfer_config(jax_params_from_transfer_state_dict(sd))
    return fckpt.infer_model_config_from_params(jax_params_from_state_dict(sd))


def _read_pth(path: Path, model_type: Optional[str]) -> Tuple[str, Any, Dict[str, torch.Tensor]]:
    from facesr_torch.ckpt.weights import read_state_dict

    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        sd = ckpt.get("ema_state_dict") or ckpt["model_state_dict"]
        cfg_dict = ckpt.get("model_config") or ckpt.get("config") or {}
        mtype = ckpt.get("model_type") or sniff_model_type(sd) or model_type
    else:
        sd = read_state_dict(str(path))
        cfg_dict, mtype = {}, sniff_model_type(sd) or model_type
    if mtype not in fckpt.MODEL_CONFIGS:
        raise ValueError(f"{path}: cannot tell its model type (model_type {mtype!r}, keys "
                         f"e.g. {sorted(sd)[:3]})")
    cls = fckpt.MODEL_CONFIGS[mtype]
    known = {k: v for k, v in cfg_dict.items() if k in cls.__dataclass_fields__}
    if mtype == "custom" and "upscale_factor" in cfg_dict and "scale_factor" not in known:
        known["scale_factor"] = cfg_dict["upscale_factor"]
    try:
        cfg = cls(**known) if known else _config_from_state_dict(mtype, sd)
    except (KeyError, IndexError, ValueError) as e:
        raise ValueError(f"{path}: not a {mtype!r} state dict ({type(e).__name__}: {e})") from e
    return mtype, cfg, sd


def read_model_state(path, model_type: Optional[str] = None
                     ) -> Tuple[str, Any, Dict[str, torch.Tensor]]:
    """(model type, config, state dict) of the checkpoint at ``path``,
    told apart by content (``model_type`` is the fallback type of a file
    that does not say)."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(4)
    if fckpt.is_fckpt(head):
        cfg, sd = fckpt.load_model(str(path), model_type=model_type or "custom")
        mtype = next(t for t, cls in fckpt.MODEL_CONFIGS.items() if type(cfg) is cls)
        return mtype, cfg, sd
    if head == _PTH_MAGIC:
        return _read_pth(path, model_type)
    raise ValueError(f"{path} is neither a torch checkpoint nor a JAX .fckpt")


def build_model(mtype: str, cfg, sd: Dict[str, torch.Tensor], where: str = "checkpoint"):
    """The model of ``mtype`` and ``cfg`` on the CPU holding ``sd``
    (``strict=True``), in eval mode; a mismatch raises RuntimeError naming
    ``where``."""
    if mtype == "transfer":
        first = sd.get("backbone.body.0.rdb1.conv1.weight")
        model = TransferSRModel(cfg, device="cpu",
                                num_grow_ch=GROWTH if first is None else int(first.shape[0]))
    elif mtype == "esrgan":
        model = RRDBNet(cfg, device="cpu")
    else:
        model = FaceEnhanceNet(cfg, device="cpu")
    try:
        model.load_state_dict(sd, strict=True)
    except RuntimeError as e:  # torch's strict-load error, with the file named
        raise RuntimeError(f"{where}: the weights do not fit a {mtype!r} model of "
                           f"{cfg}: {e}") from e
    return model.eval()


def load_any_model(path, device: DeviceLike = None):
    """The model in the checkpoint at ``path``, told apart by content, in
    eval mode. Built on the CPU and moved to ``device`` when one is named
    (left on the CPU otherwise: a loader does not pick a card for its
    caller)."""
    mtype, cfg, sd = read_model_state(path)
    model = build_model(mtype, cfg, sd, where=str(path))
    return model.to(device) if device is not None else model


def _is_trainer_twin(pth: Path, fck: Path) -> bool:
    """Whether ``pth`` and ``fck`` are the two files of one save of the
    port's Trainer (the same epoch, step and model type)."""
    try:
        ckpt = torch.load(str(pth), map_location="cpu", weights_only=True, mmap=True)
        meta = fckpt.read_meta(str(fck))
    except Exception:  # noqa: BLE001 — an unreadable file is nobody's twin
        return False
    return (isinstance(ckpt, dict) and "optimizer_state" in ckpt
            and all(ckpt.get(k) == meta.get(k) for k in ("epoch", "global_step", "model_type")))


def checkpoint_files(checkpoint_dir) -> List[Path]:
    """Every ``*.fckpt`` (sorted), then every ``*.pth`` (sorted) in the
    directory, less each ``.pth`` that the port's Trainer wrote beside a
    ``.fckpt`` of the same stem in the same save: the two hold one state,
    and the ``.fckpt`` (which the JAX package reads too) stands for it."""
    d = Path(checkpoint_dir)
    fckpts = sorted(d.glob("*.fckpt"))
    by_stem = {p.stem: p for p in fckpts}
    return fckpts + [p for p in sorted(d.glob("*.pth"))
                     if not (p.stem in by_stem and _is_trainer_twin(p, by_stem[p.stem]))]
