"""Convert reference PyTorch weights to ``.fckpt`` files and back (port of
`facesr/ckpt/convert.py` and `facesr/ckpt/export_torch.py`), with the JAX
CLI's flags:

    python -m facesr_torch.cli.convert --input model.pth --output model.fckpt \\
        [--kind custom|vgg19|lpips|rrdbnet|inception|transfer] [--extra lins.pth]
    python -m facesr_torch.cli.convert --reverse --input best_model.fckpt \\
        --output best_model.pth [--kind auto|custom|transfer|rrdbnet] [--no-ema]

Forward, a ``.pth`` state dict (unwrapped from ``model_state_dict``,
``state_dict``, ``params_ema`` or ``params``) becomes the ``.fckpt`` the
JAX CLI writes for the same input and output paths, byte for byte: the
same JAX-layout tree (conv OIHW -> HWIO, dense [out, in] -> [in, out],
repeated blocks stacked on leading axes, dtypes kept) and the same meta
(the model type, the config inferred from the shapes, ``converted_from``).
The three model kinds go through `ckpt.weights`' ``jax_params_from_*``,
the layout every ``.fckpt`` writer of the port uses.
``lpips`` takes the torchvision AlexNet as ``--input`` and the lpips
package's linear heads as ``--extra``; ``inception`` folds each eval-mode
BatchNorm into a scale and a bias. ``--reverse`` writes a model ``.fckpt``
(either package's, model or trainer file) as the reference-format ``.pth``
the JAX package's ``export_pth`` writes: the EMA weights when the file has
them unless ``--no-ema``. ``--kind auto`` is for ``--reverse`` only.

Files are read with ``torch.load`` (`ckpt.weights.read_state_dict`):
weights only for ``rrdbnet``, ``vgg19`` and ``inception``; for the others
weights only first, then a full unpickle (reference checkpoints may hold
richer pickles), as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import re
from dataclasses import asdict
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["convert_vgg19_state_dict", "convert_lpips_weights", "convert_inception_state_dict",
           "check_model_layout", "convert_pth", "export_pth", "main"]

# the reference's num_rcab_blocks, a field of the JAX package's
# FaceEnhanceNetConfig (before remat) that the port's lacks, and its default
NUM_RCAB_BLOCKS = 8
_VGG19_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]
_ALEX_CONV_IDX = [0, 3, 6, 8, 10]
REVERSE_KINDS = ("custom", "transfer", "esrgan")


def _numpy(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in sd.items()}


def _hwio(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 1, 0)


def _indices(sd, pattern: str) -> List[int]:
    return sorted({int(m.group(1)) for k in sd if (m := re.match(pattern, k))})


def check_model_layout(kind: str, sd: Dict[str, Any]) -> None:
    """Refuse a model state dict whose repeated blocks are missing or not
    numbered 0..N-1 (a ``module.`` prefix, a partial dict), with the JAX
    converter's message."""
    if kind == "custom":
        groups = _indices(sd, r"residual_groups\.(\d+)\.")
        blocks = _indices(sd, r"residual_groups\.0\.blocks\.(\d+)\.")
        if not groups or not blocks or groups != list(range(len(groups))) \
                or blocks != list(range(len(blocks))):
            raise ValueError(
                f"Unrecognized FaceEnhanceNet state dict (groups={groups}, blocks={blocks}; "
                f"keys e.g. {sorted(sd)[:3]}) — expected contiguous "
                "'residual_groups.<g>.blocks.<b>.*' keys; strip any 'module.' prefix before "
                "converting")
    elif kind == "rrdbnet":
        idxs = _indices(sd, r"body\.(\d+)\.")
        if not idxs or idxs != list(range(len(idxs))):
            raise ValueError(
                f"RRDBNet state dict body indices missing or non-contiguous (found {idxs[:6]}): "
                "not a plain RRDBNet state dict — strip any 'module.' (DataParallel) prefix first")
    elif kind == "transfer":
        blocks = _indices(sd, r"backbone\.body\.(\d+)\.")
        heads = _indices(sd, r"face_head\.rcab_blocks\.(\d+)\.")
        if not blocks or blocks != list(range(len(blocks))) or not heads \
                or heads != list(range(len(heads))):
            raise ValueError(
                f"Unrecognized TransferSRModel state dict (body blocks={blocks}, head blocks="
                f"{heads}; keys e.g. {sorted(sd)[:3]}) — expected 'backbone.body.<i>.*' + "
                "'face_head.rcab_blocks.<b>.*' keys; strip any 'module.' prefix before "
                "converting")


def convert_vgg19_state_dict(sd: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """torchvision vgg19 (full model or ``.features``) -> the JAX VGG conv
    list; a clean prefix of the convs is a valid partial extractor, a gap
    raises."""
    prefix = "features." if any(k.startswith("features.") for k in sd) else ""
    params = []
    for i, idx in enumerate(_VGG19_CONV_IDX):
        w_key = f"{prefix}{idx}.weight"
        if w_key not in sd:
            deeper = [j for j in _VGG19_CONV_IDX[i:] if f"{prefix}{j}.weight" in sd]
            if not params or deeper:
                raise ValueError(
                    f"vgg19 state dict missing {w_key!r} (have e.g. {sorted(sd)[:3]}) — "
                    "unrecognized layout; strip any 'module.' prefix before converting")
            break
        params.append({"w": _hwio(sd[w_key]), "b": sd[f"{prefix}{idx}.bias"]})
    return params


def convert_lpips_weights(alexnet_sd: Dict[str, np.ndarray],
                          lpips_sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """torchvision alexnet + the lpips package's linear heads -> the JAX
    LPIPS weights (``lins`` as [C, 1])."""
    prefix = "features." if any(k.startswith("features.") for k in alexnet_sd) else ""
    convs = [{"w": _hwio(alexnet_sd[f"{prefix}{i}.weight"]), "b": alexnet_sd[f"{prefix}{i}.bias"]}
             for i in _ALEX_CONV_IDX]
    lins = []
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lpips_sd:
                w = lpips_sd[key]
                break
        else:
            raise KeyError(f"lin{i} weight not found in LPIPS state dict")
        lins.append({"w": w.reshape(w.shape[1], 1)})
    return {"convs": convs, "lins": lins}


def convert_inception_state_dict(sd: Dict[str, np.ndarray], bn_eps: float = 1e-3) -> Dict[str, Any]:
    """An InceptionV3 state dict (pytorch-fid or torchvision) -> the JAX
    FID-Inception params: each conv HWIO, its eval-mode BatchNorm folded to
    ``scale = gamma / sqrt(var + eps)``, ``bias = beta - mean * scale``."""
    from facesr_torch.models.inception import CONV_SPECS

    params: Dict[str, Any] = {}
    for name, (ic, oc, (kh, kw), _, _) in CONV_SPECS.items():
        w = sd[f"{name}.conv.weight"]
        if w.shape != (oc, ic, kh, kw):
            raise ValueError(f"{name}.conv.weight has shape {w.shape}, expected "
                             f"{(oc, ic, kh, kw)}")
        scale = sd[f"{name}.bn.weight"] / np.sqrt(sd[f"{name}.bn.running_var"] + bn_eps)
        params[name] = {"w": _hwio(w).astype(np.float32), "scale": scale.astype(np.float32),
                        "bias": (sd[f"{name}.bn.bias"] - sd[f"{name}.bn.running_mean"] * scale
                                 ).astype(np.float32)}
    return params


def _custom_config(cfg, source: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """A port FaceEnhanceNetConfig as the JAX package's asdict: its fields
    in JAX's order, num_rcab_blocks from ``source`` (a file's config) or
    its default."""
    out = {}
    for k, v in asdict(cfg).items():
        if k == "remat":
            out["num_rcab_blocks"] = (source or {}).get("num_rcab_blocks", NUM_RCAB_BLOCKS)
        out[k] = v
    return out


def convert_pth(pth_path: str, out_path: str, kind: str = "custom",
                extra_pth: Optional[str] = None) -> None:
    """One ``.pth`` -> a ``.fckpt``; kind: custom, vgg19, lpips (``extra_pth``
    the lpips linear heads), rrdbnet, inception or transfer."""
    from facesr_torch.ckpt.fckpt import (infer_model_config_from_params,
                                         infer_transfer_config, save_checkpoint)
    from facesr_torch.ckpt.weights import (jax_params_from_esrgan_state_dict,
                                           jax_params_from_state_dict,
                                           jax_params_from_transfer_state_dict, read_state_dict)
    from facesr_torch.models.esrgan import infer_rrdbnet_config

    sd = read_state_dict(
        pth_path, weights_only={"rrdbnet": True, "vgg19": True, "inception": True}.get(kind))
    if kind in ("custom", "rrdbnet", "transfer"):
        check_model_layout(kind, sd)
    # the model kinds through the layout the .fckpt model writer uses, with
    # the file's dtypes kept as the JAX CLI keeps them
    if kind == "custom":
        params = jax_params_from_state_dict(sd, keep_dtype=True)
        save_checkpoint(out_path, {"params": params},
                        {"model_type": "custom",
                         "config": _custom_config(infer_model_config_from_params(params)),
                         "converted_from": pth_path})
    elif kind == "vgg19":
        save_checkpoint(out_path, {"convs": convert_vgg19_state_dict(_numpy(sd))},
                        {"model_type": "vgg19", "converted_from": pth_path})
    elif kind == "lpips":
        if extra_pth is None:
            raise ValueError("lpips conversion needs extra_pth = lpips lin heads .pth")
        save_checkpoint(out_path, convert_lpips_weights(
            _numpy(sd), _numpy(read_state_dict(extra_pth, weights_only=None))),
                        {"model_type": "lpips_alex", "converted_from": pth_path})
    elif kind == "rrdbnet":
        params = jax_params_from_esrgan_state_dict(sd, keep_dtype=True)
        save_checkpoint(out_path, {"params": params},
                        {"model_type": "esrgan", "config": asdict(infer_rrdbnet_config(params)),
                         "converted_from": pth_path})
    elif kind == "transfer":
        params = jax_params_from_transfer_state_dict(sd, keep_dtype=True)
        save_checkpoint(out_path, {"params": params},
                        {"model_type": "transfer",
                         "config": asdict(infer_transfer_config(params)),
                         "converted_from": pth_path})
    elif kind == "inception":
        save_checkpoint(out_path, convert_inception_state_dict(_numpy(sd)),
                        {"model_type": "inception_fid", "converted_from": pth_path})
    else:
        raise ValueError(f"Unknown conversion kind: {kind}")
    print(f"Converted {pth_path} -> {out_path} ({kind})")


def export_pth(fckpt_path: str, out_path: str, kind: str = "auto",
               prefer_ema: bool = True) -> str:
    """A model ``.fckpt`` -> the reference-format ``.pth`` of the JAX
    package's ``export_pth``: an RRDBNet as ``{"params": state dict}``, a
    FaceEnhanceNet or transfer model as ``{"model_state_dict", "config",
    "epoch", "global_step"}`` (plus ``best_psnr``/``best_metric`` when the
    meta has them). Returns the model type."""
    import torch

    from facesr_torch.ckpt import fckpt
    from facesr_torch.ckpt.weights import (REFERENCE_CONFIG_FIELDS,
                                           REFERENCE_TRANSFER_CONFIG_FIELDS)

    _, meta = fckpt.load_checkpoint(fckpt_path)
    mtype = meta.get("model_type", "custom") if kind == "auto" else kind
    mtype = {"rrdbnet": "esrgan", "lite": "custom"}.get(mtype, mtype)
    if mtype not in REVERSE_KINDS:
        raise ValueError(f"Cannot export model_type '{mtype}' to a reference .pth "
                         "(supported: custom/lite, transfer, esrgan/rrdbnet)")
    cfg, sd = fckpt.load_model(fckpt_path, model_type=mtype, prefer_ema=prefer_ema)
    sd = {k: v.clone() for k, v in sd.items()}
    if mtype == "esrgan":
        ckpt: Dict[str, Any] = {"params": sd}
    else:
        if mtype == "custom":
            source = meta.get("model_config") or meta.get("config") or {}
            known = any(k in asdict(cfg) for k in source)
            config = {k: v for k, v in _custom_config(cfg, source if known else None).items()
                      if k in REFERENCE_CONFIG_FIELDS}
        else:
            config = {k: v for k, v in asdict(cfg).items()
                      if k in REFERENCE_TRANSFER_CONFIG_FIELDS}
        ckpt = {"model_state_dict": sd, "config": config, "epoch": meta.get("epoch", 0),
                "global_step": meta.get("step", meta.get("global_step", 0))}
        for key in ("best_psnr", "best_metric"):
            if meta.get(key) is not None:
                ckpt[key] = meta[key]
    torch.save(ckpt, out_path)
    n_params = sum(int(v.numel()) for v in sd.values())
    print(f"Exported {fckpt_path} -> {out_path} ({mtype}, {len(sd)} tensors, {n_params:,} "
          f"params{', ema' if prefer_ema else ''})")
    return mtype


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Convert PyTorch weights to facesr format")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--kind", default=None,
                   choices=["custom", "vgg19", "lpips", "rrdbnet", "inception", "transfer",
                            "auto"],
                   help="default: custom (forward), auto (--reverse)")
    p.add_argument("--extra", default=None, help="lpips lin-heads .pth")
    p.add_argument("--reverse", action="store_true",
                   help="export a facesr .fckpt back to a reference-format .pth (kinds: "
                        "auto/custom/transfer/rrdbnet)")
    p.add_argument("--no-ema", action="store_true",
                   help="with --reverse: export raw weights instead of EMA")
    a = p.parse_args(argv)
    if a.reverse:
        export_pth(a.input, a.output, a.kind or "auto", prefer_ema=not a.no_ema)
    else:
        if a.kind == "auto":
            p.error("--kind auto is only for --reverse")
        convert_pth(a.input, a.output, a.kind or "custom", a.extra)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
