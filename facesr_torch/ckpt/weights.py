"""Carry the weights of the three model families into the port.

- `state_dict_from_jax_params`: the JAX package's params pytree, as numpy
  arrays with scan-stacked [G, B, ...] leaves, -> this port's state dict
  (conv HWIO -> OIHW, dense [in, out] -> [out, in], stacks unrolled into
  the reference key names). An own copy of the layout rules of the JAX
  package's torch exporter; it reads numpy only.
- `vgg_params_from_jax` / `jax_vgg_params_from`: the JAX package's VGG19
  conv list <-> the port's (the perceptual loss's frozen weights, also
  the ``loss_params`` of a trainer ``.fckpt``).
- `lpips_params_from_jax`, `inception_params_from_jax`: the evaluation
  networks' weights as the JAX package and its ``.fckpt`` files hold
  them (HWIO) -> the port's (OIHW); the weight loaders use them too.
- `discriminator_state_dict_from_jax`: the JAX discriminator's ``(params,
  batch_stats)`` -> the port's `Discriminator` state dict (conv HWIO ->
  OIHW, dense [in, out] -> [out, in], gamma/beta and the running stats
  under the BatchNorm names); `jax_discriminator_from_state_dict` is its
  inverse (also of a parameters-only dict, an optimiser moment's).
- `jax_params_from_state_dict`: the inverse of `state_dict_from_jax_params`
  (the `.fckpt` model writer's layout).
- `jax_qtree_from_sites` / `sites_from_jax_qtree`: a quantized model of
  any of the three families as the JAX package's int8 tree (a conv leaf
  becomes ``{"q": int8 HWIO, "scale": [..., 1, 1, 1, O], "a": [..., 1, 1,
  1, 1]}``, stacked over the leaf's stack axes: [G, B] or [G] in
  FaceEnhanceNet's trunk, [N] in an RRDB body, [B] in the transfer head)
  and back to the port's per-site `ops.quant.Int8Weight` (q OIHW, scale
  [O], a a scalar), checked leaf by leaf against the model (the quant
  cache's layout).
- `esrgan_state_dict_from_jax_params` / `jax_params_from_esrgan_state_dict`
  and `transfer_state_dict_from_jax_params` /
  `jax_params_from_transfer_state_dict`: the model zoo's weights between
  the JAX layout (scan-stacked HWIO bodies; the transfer body split into
  ``body_main`` and ``body_tail``, its head's RCABs stacked) and the
  reference key names; both directions are bitwise.
- `read_state_dict`: a ``.pth`` state dict, unwrapped from
  ``model_state_dict`` / ``state_dict`` / ``params_ema`` / ``params`` as
  `facesr/ckpt/convert.py` does, read with ``weights_only=True`` unless
  asked otherwise.
- `save_reference_pth`: a model as the reference-format ``.pth`` the JAX
  package's ``export_pth`` writes (and its ``convert_pth`` reads).
- `load_reference_pth`: a reference-format ``.pth`` (a FaceEnhanceNet
  ``{'model_state_dict', 'config'}``, a transfer model's, or an RRDBNet
  state dict in its RealESRGAN container) -> the model, loaded with
  ``strict=True``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.models.transfer import STAGE2_UNFREEZE_BLOCKS

__all__ = ["state_dict_from_jax_params", "jax_params_from_state_dict", "jax_qtree_from_sites",
           "sites_from_jax_qtree", "vgg_params_from_jax", "jax_vgg_params_from",
           "jax_discriminator_from_state_dict",
           "lpips_params_from_jax", "inception_params_from_jax",
           "discriminator_state_dict_from_jax", "esrgan_state_dict_from_jax_params",
           "jax_params_from_esrgan_state_dict", "transfer_state_dict_from_jax_params",
           "jax_params_from_transfer_state_dict", "state_dict_from_jax", "jax_params_from",
           "read_state_dict", "reference_config", "save_reference_pth", "load_reference_pth",
           "REFERENCE_CONFIG_FIELDS", "REFERENCE_TRANSFER_CONFIG_FIELDS"]

# the reference FaceEnhanceNetConfig's and TransferModelConfig's fields
# (src/models/custom.py:23-43, src/models/transfer.py:24-43): a reference
# checkpoint's ``config`` holds only these, so the reference constructors
# accept it verbatim
REFERENCE_CONFIG_FIELDS = (
    "num_channels", "num_groups", "blocks_per_group", "kernel_size",
    "reduction_ratio", "scale_factor", "res_scale", "in_channels",
    "out_channels", "init_scale", "num_rcab_blocks",
)
REFERENCE_TRANSFER_CONFIG_FIELDS = (
    "backbone_blocks", "freeze_blocks", "head_blocks", "head_channels",
    "scale_factor", "stage1_lr", "stage2_lr", "stage3_lr",
)


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


def jax_params_from_state_dict(sd: Dict[str, torch.Tensor],
                               keep_dtype: bool = False) -> Dict[str, Any]:
    """This port's FaceEnhanceNet state dict -> JAX params (numpy leaves),
    the inverse of `state_dict_from_jax_params`. Leaves are float32 unless
    ``keep_dtype`` keeps the tensors' own."""
    arr, hwio, conv = _sd_reader(sd, keep_dtype)
    num_groups = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("residual_groups."))
    blocks_per_group = 1 + max(int(k.split(".")[3]) for k in sd
                               if k.startswith("residual_groups.0.blocks."))
    pre = [[f"residual_groups.{g}.blocks.{b}" for b in range(blocks_per_group)]
           for g in range(num_groups)]

    def stacked(fn) -> np.ndarray:
        return np.stack([np.stack([fn(p) for p in row]) for row in pre])

    rcab = {"conv1_w": stacked(lambda p: hwio(f"{p}.conv1.weight")),
            "conv1_b": stacked(lambda p: arr(f"{p}.conv1.bias")),
            "prelu_a": stacked(lambda p: arr(f"{p}.prelu.weight")),
            "conv2_w": stacked(lambda p: hwio(f"{p}.conv2.weight")),
            "conv2_b": stacked(lambda p: arr(f"{p}.conv2.bias")),
            "ca": {"fc1_w": stacked(lambda p: arr(f"{p}.channel_attention.fc.0.weight").T),
                   "fc2_w": stacked(lambda p: arr(f"{p}.channel_attention.fc.2.weight").T)}}
    stages = sorted({int(k.split(".")[2]) for k in sd if k.startswith("upsample.stages.")})
    return {
        "conv_first": conv("conv_first"),
        "groups": {"rcab": rcab,
                   "conv_w": np.stack([hwio(f"residual_groups.{g}.conv.weight")
                                       for g in range(num_groups)]),
                   "conv_b": np.stack([arr(f"residual_groups.{g}.conv.bias")
                                       for g in range(num_groups)])},
        "conv_after_body": conv("conv_after_body"),
        "upsample": [{"conv_w": hwio(f"upsample.stages.{s}.conv.weight"),
                      "conv_b": arr(f"upsample.stages.{s}.conv.bias"),
                      "prelu_a": arr(f"upsample.stages.{s}.prelu.weight")} for s in stages],
        "conv_last": conv("conv_last"),
    }


def _node(tree: Any, path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _set_node(tree: Any, path, value: Any) -> None:
    _node(tree, path[:-1])[path[-1]] = value


def jax_qtree_from_sites(model, sites: Dict[str, Any]) -> Dict[str, Any]:
    """The model's JAX parameter tree (numpy, `jax_params_from`) with every
    quantized leaf as
    the JAX package's int8 dict: ``q`` int8 HWIO and ``scale`` [..., 1, 1,
    1, O] stacked over the leaf's stack axes, plus ``a`` [..., 1, 1, 1, 1]
    when the sites are calibrated and ``sid`` (int32, stack-shaped) when
    they carry site ids."""
    from facesr_torch.ops.quant import quant_leaves

    tree = jax_params_from(model)
    for leaf in quant_leaves(model):
        ws = [sites[n] for n in leaf.names]
        o = leaf.shape[0]
        node = {"q": np.stack([w.q.cpu().numpy().transpose(2, 3, 1, 0) for w in ws])
                .reshape(leaf.stack + tuple(ws[0].q.shape[i] for i in (2, 3, 1, 0))),
                "scale": np.stack([w.scale.detach().cpu().float().numpy() for w in ws])
                .reshape(leaf.stack + (1, 1, 1, o))}
        if all(w.a is not None for w in ws):
            node["a"] = np.asarray([float(w.a) for w in ws], np.float32).reshape(
                leaf.stack + (1, 1, 1, 1))
        if all(w.sid is not None for w in ws):
            node["sid"] = np.asarray([w.sid for w in ws], np.int32).reshape(leaf.stack)
        _set_node(tree, leaf.path, node)
    return tree


def sites_from_jax_qtree(tree: Dict[str, Any], model,
                         where: str = "quant tree") -> Dict[str, Any]:
    """A JAX int8 tree (lists as lists or digit-keyed maps) -> this
    model's ``{site: Int8Weight}`` on the model's device. The tree must
    have this model's structure: an int8 dict exactly at the sites the
    predicate selects (with ``q``, ``scale`` and ``a``) and every other
    leaf of the parameter shapes; anything else raises ValueError."""
    from facesr_torch.ckpt.fckpt import restore_list_nodes
    from facesr_torch.ops.quant import Int8Weight, quant_leaves

    tree = restore_list_nodes(tree)
    want = jax_params_from(model)
    device = next(model.parameters()).device
    qpaths = {leaf.path: leaf for leaf in quant_leaves(model)}

    def mismatch(path, got, exp) -> ValueError:
        return ValueError(f"{where} does not match this model: leaf "
                          f"{'/'.join(map(str, path))} is {got}, expected {exp}")

    def walk(node, ref, path) -> None:
        if path in qpaths:
            if not (isinstance(node, dict) and {"q", "scale", "a"} <= set(node)):
                raise mismatch(path, type(node).__name__, "a calibrated int8 dict")
            leaf = qpaths[path]
            for key, shape in (("q", np.shape(ref)), ("scale", leaf.stack + (1, 1, 1, leaf.shape[0])),
                               ("a", leaf.stack + (1, 1, 1, 1))):
                if tuple(np.shape(node[key])) != tuple(shape):
                    raise mismatch(path + (key,), f"shape {tuple(np.shape(node[key]))}",
                                   f"{tuple(shape)}")
            if np.asarray(node["q"]).dtype != np.int8:
                raise mismatch(path + ("q",), np.asarray(node["q"]).dtype, "int8")
            return
        if isinstance(ref, dict):
            if not isinstance(node, dict) or set(node) != set(ref):
                raise mismatch(path, sorted(node) if isinstance(node, dict) else
                               type(node).__name__, sorted(ref))
            for k in ref:
                walk(node[k], ref[k], path + (k,))
        elif isinstance(ref, list):
            if not isinstance(node, list) or len(node) != len(ref):
                raise mismatch(path, type(node).__name__, f"a list of {len(ref)}")
            for i, (n, r) in enumerate(zip(node, ref)):
                walk(n, r, path + (i,))
        elif isinstance(node, dict) or tuple(np.shape(node)) != tuple(np.shape(ref)):
            raise mismatch(path, f"shape {np.shape(node)}" if not isinstance(node, dict)
                           else "an int8 dict", f"shape {np.shape(ref)}")

    walk(tree, want, ())
    sites = {}
    for leaf in qpaths.values():
        node = _node(tree, leaf.path)
        q = np.asarray(node["q"]).reshape((-1,) + np.shape(node["q"])[-4:])
        scale = np.asarray(node["scale"], np.float32).reshape(q.shape[0], -1)
        a = np.asarray(node["a"], np.float32).reshape(-1)
        for j, name in enumerate(leaf.names):
            sites[name] = Int8Weight(
                torch.from_numpy(q[j].transpose(3, 2, 0, 1).copy()).to(device),
                torch.from_numpy(scale[j].copy()).to(device),
                torch.tensor(a[j], dtype=torch.float32, device=device))
    return sites


def vgg_params_from_jax(params: List[Dict[str, Any]]) -> List[Dict[str, torch.Tensor]]:
    """The JAX package's VGG19 conv list (numpy leaves, HWIO) -> this
    port's (``{"w": OIHW, "b"}`` tensors, depth order)."""
    return [{"w": _oihw(p["w"]), "b": _t(p["b"])} for p in params]


def _hwio(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().float().numpy().transpose(2, 3, 1, 0))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def jax_vgg_params_from(params: List[Dict[str, torch.Tensor]]) -> List[Dict[str, np.ndarray]]:
    """The port's VGG19 conv list (``{"w": OIHW, "b"}``) -> the JAX
    package's (numpy, HWIO), the inverse of `vgg_params_from_jax`."""
    return [{"w": _hwio(p["w"]), "b": _np(p["b"])} for p in params]


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


def discriminator_state_dict_from_jax(params: Dict[str, Any],
                                      batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX discriminator's params and BatchNorm stats (numpy leaves; a
    block without BatchNorm has a conv bias ``b`` and empty stats ``{}``)
    -> this port's `Discriminator` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i, (block, stat) in enumerate(zip(params["blocks"], batch_stats["blocks"])):
        pre = f"blocks.{i}"
        sd[f"{pre}.conv.weight"] = _oihw(block["w"])
        if "b" in block:
            sd[f"{pre}.conv.bias"] = _t(block["b"])
        if "gamma" in block:
            sd[f"{pre}.bn.weight"] = _t(block["gamma"])
            sd[f"{pre}.bn.bias"] = _t(block["beta"])
            sd[f"{pre}.bn.running_mean"] = _t(stat["mean"])
            sd[f"{pre}.bn.running_var"] = _t(stat["var"])
    for fc in ("fc1", "fc2"):
        sd[f"{fc}.weight"] = _t(np.asarray(params[f"{fc}_w"]).T)
        sd[f"{fc}.bias"] = _t(params[f"{fc}_b"])
    return sd


def jax_discriminator_from_state_dict(sd: Dict[str, torch.Tensor]):
    """The port's `Discriminator` state dict -> the JAX discriminator's
    ``(params, batch_stats)`` (numpy), the inverse of
    `discriminator_state_dict_from_jax`. A block with a conv bias has no
    BatchNorm and empty stats ``{}``; a dict without running stats (an
    optimiser moment of the parameters) gives stats None."""
    n = _block_count(sd, "blocks.")
    has_stats = any(k.endswith(".running_mean") for k in sd)
    params: Dict[str, Any] = {"blocks": []}
    stats: Dict[str, Any] = {"blocks": []}
    for i in range(n):
        pre = f"blocks.{i}"
        block = {"w": _hwio(sd[f"{pre}.conv.weight"])}
        stat: Dict[str, np.ndarray] = {}
        if f"{pre}.conv.bias" in sd:
            block["b"] = _np(sd[f"{pre}.conv.bias"])
        else:
            block["gamma"] = _np(sd[f"{pre}.bn.weight"])
            block["beta"] = _np(sd[f"{pre}.bn.bias"])
            if has_stats:
                stat = {"mean": _np(sd[f"{pre}.bn.running_mean"]),
                        "var": _np(sd[f"{pre}.bn.running_var"])}
        params["blocks"].append(block)
        stats["blocks"].append(stat)
    for fc in ("fc1", "fc2"):
        params[f"{fc}_w"] = np.ascontiguousarray(_np(sd[f"{fc}.weight"]).T)
        params[f"{fc}_b"] = _np(sd[f"{fc}.bias"])
    return params, (stats if has_stats else None)


# ---------------------------------------------------------------------------
# The model zoo (RRDBNet, TransferSRModel)
# ---------------------------------------------------------------------------

_RDB_CONVS = [f"conv{c}" for c in range(1, 6)]


def _per_block(node: Any) -> List[Dict[str, Any]]:
    """A stacked RRDB body (``{rdb{j}: {conv{c}_w: [N, ...]}}``) or a list
    of per-block trees (a legacy per-block save, lists restored) ->
    per-block trees; None -> []."""
    if node is None:
        return []
    if isinstance(node, list):
        return node
    n = np.shape(node["rdb1"]["conv1_w"])[0]
    return [{r: {k: np.asarray(v)[i] for k, v in node[r].items()} for r in node}
            for i in range(n)]


def _rrdb_to_sd(sd: Dict[str, torch.Tensor], pre: str, blk: Dict[str, Any]) -> None:
    for j in (1, 2, 3):
        for c in _RDB_CONVS:
            sd[f"{pre}.rdb{j}.{c}.weight"] = _oihw(blk[f"rdb{j}"][f"{c}_w"])
            sd[f"{pre}.rdb{j}.{c}.bias"] = _t(blk[f"rdb{j}"][f"{c}_b"])


def _sd_reader(sd: Dict[str, torch.Tensor], keep_dtype: bool = False):
    """Leaf readers of a state dict: ``arr`` (numpy), ``hwio`` (a conv
    weight OIHW -> HWIO) and ``conv`` (``{"w", "b"}``); float32 unless
    ``keep_dtype``."""
    def arr(name: str) -> np.ndarray:
        t = sd[name].detach().cpu()
        return (t if keep_dtype else t.float()).numpy()

    def hwio(name: str) -> np.ndarray:
        return np.ascontiguousarray(arr(name).transpose(2, 3, 1, 0))

    def conv(name: str) -> Dict[str, np.ndarray]:
        return {"w": hwio(f"{name}.weight"), "b": arr(f"{name}.bias")}

    return arr, hwio, conv


def _stacked_body(sd: Dict[str, torch.Tensor], pres: List[str], keep_dtype: bool = False):
    """The RRDB blocks at module paths ``pres`` stacked as the JAX body
    (``{rdb{j}: {conv{c}_w: [N, ...], conv{c}_b}}``); None when empty."""
    if not pres:
        return None
    arr, hwio, _ = _sd_reader(sd, keep_dtype)
    return {f"rdb{j}": {k: np.stack([fn(f"{p}.rdb{j}.{c}.{suffix}") for p in pres])
                        for c in _RDB_CONVS
                        for k, fn, suffix in ((f"{c}_w", hwio, "weight"),
                                              (f"{c}_b", arr, "bias"))}
            for j in (1, 2, 3)}


def _block_count(sd: Dict[str, Any], prefix: str) -> int:
    idx = {int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)}
    if sorted(idx) != list(range(len(idx))):
        raise ValueError(f"blocks under {prefix!r} are not numbered 0..N-1: {sorted(idx)[:8]}")
    return len(idx)


def esrgan_state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX RRDBNet params (numpy leaves, stacked or per-block body) ->
    the RealESRGAN state dict (`models.esrgan.RRDBNet`)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(name: str) -> None:
        sd[f"{name}.weight"] = _oihw(params[name]["w"])
        sd[f"{name}.bias"] = _t(params[name]["b"])

    conv("conv_first")
    for i, blk in enumerate(_per_block(params["body"])):
        _rrdb_to_sd(sd, f"body.{i}", blk)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        conv(name)
    return sd


def jax_params_from_esrgan_state_dict(sd: Dict[str, torch.Tensor],
                                      keep_dtype: bool = False) -> Dict[str, Any]:
    """The inverse of `esrgan_state_dict_from_jax_params` (a stacked body;
    float32 leaves unless ``keep_dtype``)."""
    _, _, conv = _sd_reader(sd, keep_dtype)
    n = _block_count(sd, "body.")
    out = {name: conv(name) for name in ("conv_first", "conv_body", "conv_up1", "conv_up2",
                                         "conv_hr", "conv_last")}
    out["body"] = _stacked_body(sd, [f"body.{i}" for i in range(n)], keep_dtype)
    return out


def _rcab_leaves(fn) -> Dict[str, Any]:
    """An RCAB leaf tree, each leaf ``fn(leaf name)``."""
    return {"conv1_w": fn("conv1_w"), "conv1_b": fn("conv1_b"), "prelu_a": fn("prelu_a"),
            "conv2_w": fn("conv2_w"), "conv2_b": fn("conv2_b"),
            "ca": {"fc1_w": fn("fc1_w"), "fc2_w": fn("fc2_w")}}


def transfer_state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX TransferSRModel params (numpy leaves; ``body_main`` then
    ``body_tail``, either None, stacked or per-block; stacked ``rcabs``)
    -> the reference state dict (`models.transfer.TransferSRModel`)."""
    sd: Dict[str, torch.Tensor] = {}
    bb, hd = params["backbone"], params["face_head"]

    def conv(name: str, p: Dict[str, Any]) -> None:
        sd[f"{name}.weight"] = _oihw(p["w"])
        sd[f"{name}.bias"] = _t(p["b"])

    conv("backbone.conv_first", bb["conv_first"])
    body = _per_block(bb.get("body_main")) + _per_block(bb.get("body_tail"))
    for i, blk in enumerate(body):
        _rrdb_to_sd(sd, f"backbone.body.{i}", blk)
    conv("backbone.conv_body", bb["conv_body"])
    rcabs = hd["rcabs"]
    for b in range(np.shape(rcabs["conv1_w"])[0]):
        pre = f"face_head.rcab_blocks.{b}"
        leaf = lambda a: np.asarray(a)[b]  # noqa: E731
        sd[f"{pre}.conv1.weight"] = _oihw(leaf(rcabs["conv1_w"]))
        sd[f"{pre}.conv1.bias"] = _t(leaf(rcabs["conv1_b"]))
        sd[f"{pre}.prelu.weight"] = _t(leaf(rcabs["prelu_a"]))
        sd[f"{pre}.conv2.weight"] = _oihw(leaf(rcabs["conv2_w"]))
        sd[f"{pre}.conv2.bias"] = _t(leaf(rcabs["conv2_b"]))
        sd[f"{pre}.channel_attention.fc.0.weight"] = _t(leaf(rcabs["ca"]["fc1_w"]).T)
        sd[f"{pre}.channel_attention.fc.2.weight"] = _t(leaf(rcabs["ca"]["fc2_w"]).T)
    conv("face_head.conv_after", hd["conv_after"])
    for s, stage in enumerate(hd["upsample"]):
        sd[f"face_head.upsample.stages.{s}.conv.weight"] = _oihw(stage["conv_w"])
        sd[f"face_head.upsample.stages.{s}.conv.bias"] = _t(stage["conv_b"])
        sd[f"face_head.upsample.stages.{s}.prelu.weight"] = _t(stage["prelu_a"])
    conv("face_head.conv_last", hd["conv_last"])
    return sd


def jax_params_from_transfer_state_dict(sd: Dict[str, torch.Tensor],
                                        keep_dtype: bool = False) -> Dict[str, Any]:
    """The inverse of `transfer_state_dict_from_jax_params`: the body
    split into ``body_main`` and the last ``min(4, N)`` blocks as
    ``body_tail`` (an empty part is None), the head's RCABs stacked;
    float32 leaves unless ``keep_dtype``."""
    arr, hwio, conv = _sd_reader(sd, keep_dtype)
    n = _block_count(sd, "backbone.body.")
    n_main = n - min(STAGE2_UNFREEZE_BLOCKS, n)
    pres = [f"backbone.body.{i}" for i in range(n)]
    heads = [f"face_head.rcab_blocks.{b}"
             for b in range(_block_count(sd, "face_head.rcab_blocks."))]
    keys = {"conv1_w": ("conv1.weight", hwio), "conv1_b": ("conv1.bias", arr),
            "prelu_a": ("prelu.weight", arr), "conv2_w": ("conv2.weight", hwio),
            "conv2_b": ("conv2.bias", arr),
            "fc1_w": ("channel_attention.fc.0.weight", lambda k: arr(k).T),
            "fc2_w": ("channel_attention.fc.2.weight", lambda k: arr(k).T)}
    rcabs = _rcab_leaves(lambda leaf: np.stack([keys[leaf][1](f"{p}.{keys[leaf][0]}")
                                                for p in heads]))
    stages = range(_block_count(sd, "face_head.upsample.stages."))
    return {
        "backbone": {"conv_first": conv("backbone.conv_first"),
                     "body_main": _stacked_body(sd, pres[:n_main], keep_dtype),
                     "body_tail": _stacked_body(sd, pres[n_main:], keep_dtype),
                     "conv_body": conv("backbone.conv_body")},
        "face_head": {"rcabs": rcabs, "conv_after": conv("face_head.conv_after"),
                      "upsample": [{"conv_w": hwio(f"face_head.upsample.stages.{s}.conv.weight"),
                                    "conv_b": arr(f"face_head.upsample.stages.{s}.conv.bias"),
                                    "prelu_a": arr(f"face_head.upsample.stages.{s}.prelu.weight")}
                                   for s in stages],
                      "conv_last": conv("face_head.conv_last")},
    }


def state_dict_from_jax(params: Dict[str, Any], model_type: str) -> Dict[str, torch.Tensor]:
    """JAX params of a ``custom``/``lite``, ``transfer`` or ``esrgan``
    model -> the port's state dict."""
    if model_type in ("custom", "lite"):
        return state_dict_from_jax_params(params)
    if model_type == "transfer":
        return transfer_state_dict_from_jax_params(params)
    if model_type == "esrgan":
        return esrgan_state_dict_from_jax_params(params)
    raise ValueError(f"Unsupported model_type: {model_type!r}")


def jax_params_from(model) -> Dict[str, Any]:
    """A model's weights as the JAX package's parameter tree, by its type."""
    mtype = getattr(model, "model_type", "custom")
    sd = model.state_dict()
    if mtype == "transfer":
        return jax_params_from_transfer_state_dict(sd)
    if mtype == "esrgan":
        return jax_params_from_esrgan_state_dict(sd)
    return jax_params_from_state_dict(sd)


def read_state_dict(path: str, weights_only: Optional[bool] = True) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict, unwrapped from the first of
    ``model_state_dict``, ``state_dict``, ``params_ema`` and ``params`` it
    has (`facesr/ckpt/convert.py`). ``weights_only`` None tries the safe
    mode first and falls back to a full unpickle (reference checkpoints
    may hold richer pickles)."""
    if weights_only is None:
        try:
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
        except Exception:  # noqa: BLE001 — a richer pickle: the JAX CLI's fallback
            ckpt = torch.load(path, map_location="cpu", weights_only=False)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=weights_only)
    for key in ("model_state_dict", "state_dict", "params_ema", "params"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    if not isinstance(ckpt, dict) or not all(isinstance(v, torch.Tensor) for v in ckpt.values()):
        raise ValueError(f"{path} holds no state dict of tensors")
    return ckpt


def reference_config(model) -> Dict[str, Any]:
    """A model's config as a reference checkpoint's ``config`` holds it:
    the reference fields of a FaceEnhanceNet or a transfer model, every
    field of an RRDBNet's."""
    from dataclasses import asdict

    keep = {"custom": REFERENCE_CONFIG_FIELDS, "transfer": REFERENCE_TRANSFER_CONFIG_FIELDS}.get(
        getattr(model, "model_type", "custom"))
    return {k: v for k, v in asdict(model.config).items() if keep is None or k in keep}


def save_reference_pth(path: str, model) -> None:
    """Write ``model`` as the JAX package's ``export_pth`` does: an
    RRDBNet as ``{"params": state dict}`` (RealESRGAN's container); a
    FaceEnhanceNet or transfer model as ``{"model_state_dict", "config"}``
    with the reference config fields."""
    sd = {k: v.detach().cpu().float().clone() for k, v in model.state_dict().items()}
    if getattr(model, "model_type", "custom") == "esrgan":
        payload: Dict[str, Any] = {"params": sd}
    else:
        payload = {"model_state_dict": sd, "config": reference_config(model)}
    torch.save(payload, path)


def load_reference_pth(path: str, device: DeviceLike = None):
    """Load a reference-format ``.pth`` (a FaceEnhanceNet or transfer
    ``{'model_state_dict': ..., 'config': ...}`` as the JAX package's
    ``export_pth`` writes it, or an RRDBNet state dict in its
    ``{'params': ...}`` container) with ``strict=True``
    (`models.load.load_any_model`). Runs on CUDA unless ``device`` names
    another."""
    from facesr_torch.models.load import load_any_model

    return load_any_model(path, device=resolve_device(device))
