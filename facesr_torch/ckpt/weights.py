"""Carry FaceEnhanceNet weights into the port.

- `state_dict_from_jax_params`: the JAX package's params pytree, as numpy
  arrays with scan-stacked [G, B, ...] leaves, -> this port's state dict
  (conv HWIO -> OIHW, dense [in, out] -> [out, in], stacks unrolled into
  the reference key names). An own copy of the layout rules of the JAX
  package's torch exporter; it reads numpy only.
- `vgg_params_from_jax`: the JAX package's VGG19 conv list -> the port's,
  so the loss tests run both packages on the same frozen VGG.
- `lpips_params_from_jax`, `inception_params_from_jax`: the evaluation
  networks' weights as the JAX package and its ``.fckpt`` files hold
  them (HWIO) -> the port's (OIHW); the weight loaders use them too.
- `load_reference_pth`: a reference-format ``{'model_state_dict',
  'config'}`` checkpoint -> a `FaceEnhanceNet`, loaded with ``strict=True``.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict, List

import numpy as np
import torch

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.models.face_enhance_net import FaceEnhanceNet, FaceEnhanceNetConfig

__all__ = ["state_dict_from_jax_params", "vgg_params_from_jax", "lpips_params_from_jax",
           "inception_params_from_jax", "load_reference_pth"]


def _oihw(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).transpose(3, 2, 0, 1).copy())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX FaceEnhanceNet params (numpy leaves) -> this port's state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(name: str, p: Dict[str, Any]) -> None:
        sd[f"{name}.weight"] = _oihw(p["w"])
        sd[f"{name}.bias"] = _t(p["b"])

    conv("conv_first", params["conv_first"])
    groups = params["groups"]
    rcab = groups["rcab"]
    num_groups, blocks_per_group = np.shape(rcab["conv1_w"])[:2]
    for g in range(num_groups):
        for b in range(blocks_per_group):
            pre = f"residual_groups.{g}.blocks.{b}"
            leaf = lambda a: np.asarray(a)[g, b]
            sd[f"{pre}.conv1.weight"] = _oihw(leaf(rcab["conv1_w"]))
            sd[f"{pre}.conv1.bias"] = _t(leaf(rcab["conv1_b"]))
            sd[f"{pre}.prelu.weight"] = _t(leaf(rcab["prelu_a"]))
            sd[f"{pre}.conv2.weight"] = _oihw(leaf(rcab["conv2_w"]))
            sd[f"{pre}.conv2.bias"] = _t(leaf(rcab["conv2_b"]))
            sd[f"{pre}.channel_attention.fc.0.weight"] = _t(leaf(rcab["ca"]["fc1_w"]).T)
            sd[f"{pre}.channel_attention.fc.2.weight"] = _t(leaf(rcab["ca"]["fc2_w"]).T)
        sd[f"residual_groups.{g}.conv.weight"] = _oihw(np.asarray(groups["conv_w"])[g])
        sd[f"residual_groups.{g}.conv.bias"] = _t(np.asarray(groups["conv_b"])[g])
    conv("conv_after_body", params["conv_after_body"])
    for s, stage in enumerate(params["upsample"]):
        sd[f"upsample.stages.{s}.conv.weight"] = _oihw(stage["conv_w"])
        sd[f"upsample.stages.{s}.conv.bias"] = _t(stage["conv_b"])
        sd[f"upsample.stages.{s}.prelu.weight"] = _t(stage["prelu_a"])
    conv("conv_last", params["conv_last"])
    return sd


def vgg_params_from_jax(params: List[Dict[str, Any]]) -> List[Dict[str, torch.Tensor]]:
    """The JAX package's VGG19 conv list (numpy leaves, HWIO) -> this
    port's (``{"w": OIHW, "b"}`` tensors, depth order)."""
    return [{"w": _oihw(p["w"]), "b": _t(p["b"])} for p in params]


def lpips_params_from_jax(tree: Dict[str, Any]) -> Dict[str, List[Dict[str, torch.Tensor]]]:
    """The JAX package's LPIPS weights (``{"convs": [{"w": HWIO, "b"}],
    "lins": [{"w": [C, 1]}]}``, lists possibly digit-keyed as a ``.fckpt``
    holds them) -> this port's (conv weights OIHW, lins kept [C, 1])."""
    def as_list(node):
        return [node[k] for k in sorted(node, key=int)] if isinstance(node, dict) else list(node)

    return {"convs": [{"w": _oihw(p["w"]), "b": _t(p["b"])} for p in as_list(tree["convs"])],
            "lins": [{"w": _t(p["w"])} for p in as_list(tree["lins"])]}


def inception_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's FID-InceptionV3 weights (``{name: {"w": HWIO,
    "scale", "bias"}}``, BatchNorm folded) -> this port's (``w`` OIHW)."""
    return {name: {"w": _oihw(p["w"]), "scale": _t(p["scale"]), "bias": _t(p["bias"])}
            for name, p in tree.items()}


def load_reference_pth(path: str, device: DeviceLike = None) -> FaceEnhanceNet:
    """Load a reference-format FaceEnhanceNet ``.pth`` (``{'model_state_dict':
    ..., 'config': ...}``, as the JAX package's ``export_pth`` writes it)
    with ``strict=True``. Runs on CUDA unless ``device`` names another."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "model_state_dict" not in ckpt:
        raise ValueError(f"{path} is not a reference FaceEnhanceNet checkpoint "
                         f"(no 'model_state_dict')")
    known = {f.name for f in fields(FaceEnhanceNetConfig)}
    cfg_dict = {k: v for k, v in (ckpt.get("config") or {}).items() if k in known}
    model = FaceEnhanceNet(FaceEnhanceNetConfig(**cfg_dict), device="cpu")
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    return model.to(dev)
