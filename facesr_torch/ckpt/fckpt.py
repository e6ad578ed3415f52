"""Read and write the JAX package's ``.fckpt`` checkpoints without flax or
msgpack.

A ``.fckpt`` file is flax's ``msgpack_serialize`` of ``{"meta": <JSON
string>, "tree": <pytree>}`` (`facesr/ckpt/checkpoint.py`). This module
holds a msgpack writer (`packb`, `save_checkpoint`) that writes what the
JAX package's ``save_checkpoint`` writes for the same tree, byte for
byte (maps in sorted key order, every numeric leaf an ndarray; an array
above flax's 2^30-byte chunk size raises), and a msgpack reader of its
own for what that writes:

- nil, booleans, ints, floats, str, bin, arrays and maps of every width;
- ext type 1, an ndarray: a packed ``[shape, dtype name, C-order bytes]``
  (numpy arrays; the name ``bfloat16``, which numpy lacks, becomes a
  ``torch.bfloat16`` tensor);
- ext type 3, a numpy scalar (the same payload, shape ``[]``);
- ext type 2, a complex number (a packed ``[real, imag]``);
- flax's chunked arrays (``{"__msgpack_chunked_array__": True, "shape",
  "chunks"}``, which it writes for arrays above 2^30 bytes), joined back;
  a malformed one raises and names it.

Lists come back from flax as digit-keyed maps; `load_model` restores them
(`restore_list_nodes`), restacks scanned bodies saved per block, and maps
the parameters of a FaceEnhanceNet (``custom``/``lite``), a transfer model
or an RRDBNet (``esrgan``) to this port's state dict
(`weights.state_dict_from_jax`); `save_model` writes any of the three.
`train_state_tree` is a port Trainer's state as the JAX Trainer's
``TrainState`` tree (`ckpt.optax_state` maps the optimisers), which a JAX
Trainer resumes from and `training.Trainer.load_checkpoint` reads back.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import fields
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from facesr_torch.ckpt.weights import state_dict_from_jax
from facesr_torch.models.esrgan import RRDBNetConfig, infer_rrdbnet_config
from facesr_torch.models.face_enhance_net import FaceEnhanceNetConfig
from facesr_torch.models.transfer import TransferModelConfig

__all__ = ["FckptError", "packb", "save_checkpoint", "save_model", "unpackb", "is_fckpt",
           "QUANT_CACHE_KIND", "params_fingerprint", "save_quant_cache", "load_quant_cache",
           "load_checkpoint", "read_meta", "load_model", "restore_list_nodes",
           "infer_model_config_from_params", "infer_transfer_config", "prepare_params",
           "MODEL_CONFIGS", "train_state_tree", "loss_params_tree", "TRAIN_STATE_FIELDS"]

_CHUNKED = "__msgpack_chunked_array__"
_MAX_CHUNK_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE: larger arrays it writes in chunks


class FckptError(ValueError):
    pass


def _head(n: int, small: Tuple[int, int], wide: Tuple[int, ...]) -> bytes:
    """A msgpack length header: the fix form (``small`` = (base, limit))
    or the first of the 1-, 2- and 4-byte forms (``wide`` markers, None
    where the form does not exist) that holds ``n``."""
    if n < small[1]:
        return bytes([small[0] | n])
    for marker, size in zip(wide, (1, 2, 4)):
        if marker is not None and n < 1 << (8 * size):
            return bytes([marker]) + n.to_bytes(size, "big")
    raise FckptError(f"msgpack length {n} is too large")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80 or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v >= 0:
        for marker, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                return bytes([marker]) + struct.pack(fmt, v)
    else:
        for marker, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([marker]) + struct.pack(fmt, v)
    raise FckptError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (bytes([fixed[len(data)]]) if len(data) in fixed
            else _head(len(data), (0, 0), (0xC7, 0xC8, 0xC9)))
    return head + struct.pack(">b", code) + data


def _ndarray_bytes(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: a packed [shape, dtype name, C-order
    bytes]; a bfloat16 tensor keeps the name numpy lacks."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, data = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise FckptError(f"object and structured dtypes are not written: {arr.dtype}")
        shape, name, data = arr.shape, arr.dtype.name, arr.tobytes("C")
    return packb([list(shape), name, data])


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` as ``msgpack.packb(obj, use_bin_type=True,
    strict_types=True, default=<flax's ext hook>)`` gives them, for
    None, bool, int, float, str, bytes, lists (and tuples), dicts and
    ndarrays or tensors (ext type 1)."""
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if type(obj) is int:
        return _pack_int(obj)
    if type(obj) is float:
        return b"\xcb" + struct.pack(">d", obj)
    if type(obj) is str:
        data = obj.encode("utf-8")
        return _head(len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + data
    if type(obj) in (bytes, bytearray):
        return _head(len(obj), (0, 0), (0xC4, 0xC5, 0xC6)) + bytes(obj)
    if type(obj) in (list, tuple):
        return (_head(len(obj), (0x90, 16), (None, 0xDC, 0xDD))
                + b"".join(packb(v) for v in obj))
    if type(obj) is dict:
        return (_head(len(obj), (0x80, 16), (None, 0xDE, 0xDF))
                + b"".join(packb(k) + packb(v) for k, v in obj.items()))
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        nbytes = obj.numel() * obj.element_size() if isinstance(obj, torch.Tensor) else obj.nbytes
        if nbytes > _MAX_CHUNK_BYTES:
            # flax splits such an array into chunks; no port caller writes one
            raise FckptError(f"an array of {nbytes} bytes is above flax's chunk size "
                             f"({_MAX_CHUNK_BYTES}); chunked writing is not ported")
        return _pack_ext(1, _ndarray_bytes(obj))
    raise FckptError(f"cannot write a {type(obj).__name__} into a .fckpt")


def _prepare(tree: Any) -> Any:
    """The tree as `facesr.ckpt.save_checkpoint` hands it to msgpack: maps
    with sorted keys (a jax tree map rebuilds them so), numeric leaves as
    ndarrays (``np.asarray``), tensors on the host."""
    if isinstance(tree, dict):
        return {k: _prepare(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_prepare(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (bool, int, float, np.generic, np.ndarray)):
        return np.asarray(tree)
    return tree


def save_checkpoint(path: str, tree: Any, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``{"meta": json(meta), "tree": tree}`` as a ``.fckpt`` that
    `facesr.ckpt.load_checkpoint` and `load_checkpoint` read; written to
    a per-process temporary name and renamed into place."""
    data = packb(_prepare({"meta": json.dumps(meta or {}), "tree": tree}))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save_model(path: str, model, model_type: Optional[str] = None) -> None:
    """Write a model's weights as a model ``.fckpt`` (the JAX package's
    ``save_model``: ``{"params": tree}`` with the model type and config in
    the meta), which `load_model` and the JAX loaders read. The type is
    the model's own (``custom``, ``transfer`` or ``esrgan``) unless
    ``model_type`` names one."""
    from dataclasses import asdict

    from facesr_torch.ckpt.weights import jax_params_from

    mtype = model_type or getattr(model, "model_type", "custom")
    save_checkpoint(path, {"params": jax_params_from(model)},
                    {"model_type": mtype, "config": asdict(model.config)})


QUANT_CACHE_KIND = "facesr-int8-calibrated"


def _tree_leaves(tree: Any):
    """Leaves in JAX tree-flatten order: dict keys sorted, lists in order,
    None (an empty transfer ``body_main``) no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_leaves(v)
    elif tree is not None:
        yield tree


def params_fingerprint(model) -> str:
    """sha256 of the model's JAX-layout float32 leaves in JAX tree order
    (`weights.jax_params_from`, any of the three families): the JAX
    package's ``_params_fingerprint`` of the same weights."""
    import hashlib

    from facesr_torch.ckpt.weights import jax_params_from

    h = hashlib.sha256()
    for leaf in _tree_leaves(jax_params_from(model)):
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()


def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict``: every list a map keyed '0', '1', ..."""
    if isinstance(tree, dict):
        return {k: _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def save_quant_cache(path: str, model, sites: Dict[str, Any]) -> None:
    """Write calibrated int8 sites as the JAX package's quant cache."""
    from facesr_torch.ckpt.weights import jax_qtree_from_sites

    tree = jax_qtree_from_sites(model, sites)
    save_checkpoint(path, _state_dict(tree),
                    {"kind": QUANT_CACHE_KIND, "params_sha256": params_fingerprint(model)})


def load_quant_cache(path: str) -> Tuple[Any, Dict[str, Any]]:
    """(tree, meta) of a quant cache; raises when the file is another kind
    of ``.fckpt``."""
    tree, meta = load_checkpoint(path)
    if meta.get("kind") != QUANT_CACHE_KIND:
        raise ValueError(f"{path} is not a calibrated-int8 cache")
    return tree, meta


class _Reader:
    def __init__(self, data: bytes, name: str):
        self.buf = memoryview(data)
        self.pos = 0
        self.name = name

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise FckptError(f"{self.name}: truncated msgpack data at byte {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self, raw: bool = False) -> Any:
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.value(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.uint(1 << (b - 0xC7))
            return self.ext(n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:
            n = 1 << (b - 0xD0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self.str(self.uint(1 << (b - 0xD9)), raw)
        if b in (0xDC, 0xDD):
            return [self.value(raw) for _ in range(self.uint(2 if b == 0xDC else 4))]
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4), raw)
        raise FckptError(f"{self.name}: byte 0x{b:02x} at {self.pos - 1} is not msgpack")

    def str(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.value(raw)
            out[key] = self.value(raw)
        return out

    def ext(self, n: int) -> Any:
        code = int.from_bytes(self.take(1), "big", signed=True)
        payload = bytes(self.take(n))
        if code in (1, 3):
            arr = _ndarray(payload, self.name)
            return arr[()] if code == 3 and isinstance(arr, np.ndarray) else arr
        if code == 2:
            re_im = _Reader(payload, self.name).value()
            return complex(re_im[0], re_im[1])
        raise FckptError(f"{self.name}: msgpack ext type {code} is not one flax writes")


def _ndarray(payload: bytes, name: str):
    shape, dtype_name, data = _Reader(payload, name).value(raw=True)
    dtype_name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    shape = tuple(shape)
    if dtype_name == "bfloat16":
        flat = torch.frombuffer(bytearray(data), dtype=torch.bfloat16) if data \
            else torch.empty(0, dtype=torch.bfloat16)
        return flat.reshape(shape)
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise FckptError(f"{name}: array dtype {dtype_name!r} is not readable") from e
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def _unchunk(tree: Any, where: str = "tree") -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            try:
                shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
                chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
                if any(isinstance(c, torch.Tensor) for c in chunks):
                    return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
                return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)
            except (KeyError, TypeError, ValueError, RuntimeError) as e:
                raise FckptError(f"malformed chunked array at {where}: {e}") from e
        return {k: _unchunk(v, f"{where}.{k}") for k, v in tree.items()}
    return tree


def unpackb(data: bytes, name: str = "<msgpack>") -> Any:
    """flax's ``msgpack_restore``: the tree in ``data``, chunked arrays
    joined."""
    reader = _Reader(data, name)
    out = reader.value()
    if reader.pos != len(data):
        raise FckptError(f"{name}: {len(data) - reader.pos} bytes after the msgpack object")
    return _unchunk(out)


def is_fckpt(head: bytes) -> bool:
    """Whether a file's first bytes open a msgpack map (a ``.fckpt``)."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """(tree, meta) of a ``.fckpt`` file, as the JAX package's
    ``load_checkpoint(path)`` returns them (lists still digit-keyed)."""
    with open(path, "rb") as f:
        data = f.read()
    payload = unpackb(data, str(path))
    if not isinstance(payload, dict) or "meta" not in payload or "tree" not in payload:
        raise FckptError(f"{path}: not a facesr checkpoint (no 'meta' and 'tree')")
    return payload["tree"], json.loads(payload["meta"])


def read_meta(path: str) -> Dict[str, Any]:
    """The meta of a ``.fckpt`` without parsing its tree: both packages
    write the "meta" entry first (sorted keys), so only the file's head is
    read (more of it while the entry is cut short)."""
    size = 1 << 16
    with open(path, "rb") as f:
        while True:
            f.seek(0)
            data = f.read(size)
            reader = _Reader(data, str(path))
            try:
                b = reader.uint(1)
                if not (0x80 <= b <= 0x8F or b in (0xDE, 0xDF)):
                    raise FckptError(f"{path}: not a facesr checkpoint")
                if b in (0xDE, 0xDF):
                    reader.uint(2 if b == 0xDE else 4)
                if reader.value() != "meta":
                    return load_checkpoint(path)[1]
                return json.loads(reader.value())
            except FckptError as e:
                if "truncated" not in str(e) or len(data) < size:
                    raise
                size *= 4


def restore_list_nodes(tree: Any) -> Any:
    """flax writes lists as {'0': ..., '1': ...}; turn every all-digit-keyed
    map back into a list."""
    if isinstance(tree, dict):
        if tree and all(isinstance(k, str) and k.isdigit() for k in tree):
            return [restore_list_nodes(tree[k]) for k in sorted(tree, key=int)]
        return {k: restore_list_nodes(v) for k, v in tree.items()}
    return tree


def infer_model_config_from_params(params: Any) -> FaceEnhanceNetConfig:
    """A FaceEnhanceNetConfig from the JAX parameter shapes, for a
    checkpoint without config metadata."""
    first_w = np.asarray(params["conv_first"]["w"])
    num_channels = int(first_w.shape[-1])
    kernel_size = int(first_w.shape[0])  # [kh, kw, I, O]
    rcab_w = np.asarray(params["groups"]["rcab"]["conv1_w"])
    num_groups, blocks_per_group = int(rcab_w.shape[0]), int(rcab_w.shape[1])
    reduced = int(np.asarray(params["groups"]["rcab"]["ca"]["fc1_w"]).shape[-1])
    if reduced < 8:
        # the SE bottleneck is max(C // r, 8): a narrower one is not this model
        raise ValueError(f"Cannot infer reduction_ratio: SE bottleneck width {reduced} is "
                         "below the floor of 8; checkpoint is not a FaceEnhanceNet.")
    return FaceEnhanceNetConfig(num_channels=num_channels, num_groups=num_groups,
                                blocks_per_group=blocks_per_group,
                                reduction_ratio=max(num_channels // reduced, 1),
                                scale_factor=2 ** len(params["upsample"]),
                                kernel_size=kernel_size)


def _model_params(tree: Any, path: str, prefer_ema: bool) -> Any:
    if prefer_ema and tree.get("ema_params") is not None:
        return tree["ema_params"]
    if "params" in tree:
        return tree["params"]
    if "state" in tree and "params" in tree["state"]:
        return tree["state"]["params"]
    raise ValueError(f"No model params found in checkpoint {path}")


def _restack(node: Any) -> Any:
    """A scanned body saved per block (a list of per-block trees once the
    lists are restored) stacked on a leading axis, as the JAX package's
    `restack_scanned`; a stacked body or None is returned as is."""
    if not isinstance(node, list):
        return node

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack([np.asarray(x) for x in xs])

    return stack(*node)


def prepare_params(params: Any, model_type: str) -> Any:
    """A parameter tree as a ``.fckpt`` holds it -> the JAX layout: lists
    restored, and a scanned body saved per block (an RRDBNet's ``body``, a
    transfer model's ``body_main``/``body_tail``) restacked."""
    params = restore_list_nodes(params)
    if model_type == "esrgan":
        params["body"] = _restack(params["body"])
    elif model_type == "transfer":
        bb = params["backbone"]
        for k in ("body_main", "body_tail"):
            bb[k] = _restack(bb.get(k))
    return params


def infer_transfer_config(params: Any) -> TransferModelConfig:
    """A TransferModelConfig from the JAX parameter shapes (the JAX
    package's `infer_transfer_config`), for a checkpoint without config
    metadata."""
    bb, hd = params["backbone"], params["face_head"]
    n_main, n_tail = (0 if bb[k] is None else int(np.shape(bb[k]["rdb1"]["conv1_w"])[0])
                      for k in ("body_main", "body_tail"))
    return TransferModelConfig(backbone_blocks=n_main + n_tail,
                               head_blocks=int(np.shape(hd["rcabs"]["conv1_w"])[0]),
                               head_channels=int(np.shape(bb["conv_first"]["w"])[-1]),
                               scale_factor=2 ** len(hd["upsample"]))


# each model type's config class
MODEL_CONFIGS = {"custom": FaceEnhanceNetConfig, "lite": FaceEnhanceNetConfig,
                 "transfer": TransferModelConfig, "esrgan": RRDBNetConfig}


def load_model(path: str, model_type: str = "custom", prefer_ema: bool = True,
               ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """(config, state dict) of the model in a model or trainer ``.fckpt``
    (the JAX package's ``load_model``): a FaceEnhanceNet (``custom`` or
    ``lite``), a transfer model or an RRDBNet (``esrgan``), by the file's
    ``model_type`` (``model_type`` when it has none). ``prefer_ema``
    takes the EMA weights when the checkpoint has them. The config is the
    file's ``model_config`` or ``config``, else inferred from the shapes.
    A tree that is not the model it says raises ValueError naming the
    file."""
    tree, meta = load_checkpoint(path)
    mtype = meta.get("model_type", model_type)
    if mtype not in MODEL_CONFIGS:
        raise ValueError(f"{path}: unsupported model_type {mtype!r}")
    params = _model_params(tree, path, prefer_ema)
    # trainer checkpoints carry the architecture under 'model_config'
    # ('config' is the TrainerConfig); model-only ones under 'config'
    cfg_dict = meta.get("model_config") or meta.get("config") or {}
    cls = MODEL_CONFIGS[mtype]
    known = {k: v for k, v in cfg_dict.items() if k in {f.name for f in fields(cls)}}
    try:
        params = prepare_params(params, mtype)
        if mtype == "esrgan":
            cfg = RRDBNetConfig(**known) if known else infer_rrdbnet_config(params)
        elif mtype == "transfer":
            cfg = TransferModelConfig(**known) if known else infer_transfer_config(params)
        else:
            cfg = cls(**known) if known else infer_model_config_from_params(params)
        return cfg, state_dict_from_jax(params, mtype)
    except (KeyError, IndexError, TypeError, AttributeError) as e:
        raise ValueError(f"{path}: not a {mtype!r} model checkpoint "
                         f"({type(e).__name__}: {e})") from e


# the JAX Trainer's TrainState fields (facesr/training/steps.py), each a
# key of a trainer .fckpt's tree
TRAIN_STATE_FIELDS = ("step", "params", "opt_state", "loss_params", "d_params", "d_stats",
                      "d_opt_state", "ema_params")


def train_state_tree(model_type: str, model_sd: Dict[str, torch.Tensor], optimizer,
                     opt_state: Dict[str, Any], step: int, loss_params: Any,
                     ema: Optional[Dict[str, torch.Tensor]] = None,
                     disc_sd: Optional[Dict[str, torch.Tensor]] = None, d_optimizer=None,
                     d_opt_state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """A port Trainer's state as flax's ``to_state_dict`` of the JAX
    Trainer's ``TrainState``: the model's parameters, its optimiser's optax
    state, ``loss_params`` (the perceptual VGG in the JAX layout, or ``{}``
    without one, as given: `loss_params_tree`), the discriminator's
    parameters, BatchNorm stats and optax state (None without a GAN) and
    the EMA (None when off). Tensors may sit on any device."""
    from facesr_torch.ckpt import optax_state as ox
    from facesr_torch.ckpt.weights import jax_discriminator_from_state_dict

    labels = ox.stage_labels(optimizer, opt_state, model_sd, model_type)
    tree: Dict[str, Any] = {
        "step": np.asarray(step, np.int32),
        "params": ox.jax_tree(model_type, model_sd),
        "opt_state": ox.optax_state_dict(optimizer, opt_state, model_type, model_sd, labels),
        "loss_params": loss_params,
        "d_params": None, "d_stats": None, "d_opt_state": None,
        "ema_params": None if ema is None else ox.jax_tree(model_type, ema),
    }
    if disc_sd is not None:
        d_params, d_stats = jax_discriminator_from_state_dict(disc_sd)
        d_named = {k: v for k, v in disc_sd.items() if ".running_" not in k}
        tree.update(d_params=_state_dict(d_params), d_stats=_state_dict(d_stats),
                    d_opt_state=ox.optax_state_dict(d_optimizer, d_opt_state, "disc", d_named))
    return tree


def loss_params_tree(loss_params: Dict[str, Any]) -> Dict[str, Any]:
    """A `CombinedLoss`'s params as the JAX loss's ``loss_params``: the VGG
    conv list in the JAX layout under "vgg", or ``{}`` without one."""
    from facesr_torch.ckpt.weights import jax_vgg_params_from

    if "vgg" not in loss_params:
        return {}
    return {"vgg": _state_dict(jax_vgg_params_from(loss_params["vgg"]))}
