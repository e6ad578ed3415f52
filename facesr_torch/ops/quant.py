"""Per-channel int8 weights, calibrated activation scales and QAT sites.

Port of `facesr/ops/quant.py`. A quantized model is its float module plus
a mapping from conv *site* (the module path of one conv, e.g.
``residual_groups.0.blocks.1.conv2``) to a small object:

- `Int8Weight`: int8 OIHW ``q``, f32 ``scale`` [O] (one per output
  channel), an optional static activation scale ``a`` (a 0-d f32 tensor,
  from calibration) and an optional site id ``sid`` (for calibration).
  `ops.conv.conv2d` dispatches it to the s8 x s8 -> s32 conv.
- `FakeQuant`: the QAT marker of a site, with an optional static ``a``.
  The forward pairs it with the conv's live float weight
  (`FakeQuantWeight`), so autograd, checkpointing and
  ``torch.func.functional_call`` (EMA validation) see the latent weights.

Site selection is the JAX package's `_is_conv_kernel`, applied to the JAX
layout of the parameters: a kernel leaf counts with its *stack* (the
[G, B, kh, kw, I, O] trunk leaf, not one block's kernel), so the serving,
calibration and QAT transforms select the same sites in both packages at
every width. `conv_leaves` lists the leaves in JAX tree-flatten order
(sorted dict keys), which also numbers the site ids.

Weight-only ``int8`` serving quantizes the same sites and serves the bf16
forward of the weights `dequantize_pytree` gives back, kernel trunk
(FaceEnhanceNet) and kernel head (the transfer model) included.

The three families have site tables: FaceEnhanceNet, RRDBNet and the
transfer model. A stacked RRDB body is one leaf per (RDB, conv) of the
JAX tree, so its site ids are leaf-major (``body.rdb1.conv1_w`` takes one
id per block, then ``rdb1.conv2_w``, ...); the transfer body is the JAX
package's two stacks, ``body_main`` and the last ``min(4, N)`` blocks as
``body_tail`` (no leaves when ``body_main`` is empty).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["MIN_QUANT_SIZE", "Int8Weight", "FakeQuant", "FakeQuantWeight", "QuantSites",
           "ConvLeaf", "conv_leaves", "is_int8_kernel", "site_weight", "over_127", "amax_scale",
           "dequantize_pytree", "quantize_conv_kernels", "collecting_act_stats",
           "record_act_scale", "attach_act_scales", "calibrate_act_scales",
           "fake_quant_params", "quantization_summary"]

# Leaves smaller than this stay float: per-channel scales on tiny tensors
# cost accuracy for no footprint (the JAX package's MIN_QUANT_SIZE).
MIN_QUANT_SIZE = 256


@dataclass(eq=False)
class Int8Weight:
    """One quantized conv site: int8 OIHW ``q``, f32 per-output-channel
    ``scale`` [O], optional static activation scale ``a`` (0-d f32) and
    calibration site id ``sid``. Immutable by convention: the GEMM layout
    and the subpixel-packed kernel are derived once and memoized."""

    q: torch.Tensor
    scale: torch.Tensor
    a: Optional[torch.Tensor] = None
    sid: Optional[int] = None
    _memo: dict = field(default_factory=dict, repr=False)

    def to(self, device) -> "Int8Weight":
        return Int8Weight(self.q.to(device), self.scale.to(device),
                          None if self.a is None else self.a.to(device), self.sid)

    def gemm_weight(self, k_pad: int, n_pad: int) -> torch.Tensor:
        """``q`` as the [n_pad, k_pad] int8 matrix of the im2col GEMM
        (rows: output channels; columns (kh, kw, I), zero padded)."""
        key = ("gemm", k_pad, n_pad)
        if key not in self._memo:
            o, i, kh, kw = self.q.shape
            mat = torch.zeros((n_pad, k_pad), dtype=torch.int8, device=self.q.device)
            mat[:o, :kh * kw * i] = self.q.permute(0, 2, 3, 1).reshape(o, kh * kw * i)
            self._memo[key] = mat
        return self._memo[key]

    def subpixel_packed(self) -> "Int8Weight":
        """This 3x3 kernel rewritten for the packed (pre-PixelShuffle(2))
        layout, with the scale repeated per output phase (channel-major,
        as the packed channels are c*4 + phase)."""
        if "packed" not in self._memo:
            from facesr_torch.ops.pixel_shuffle import subpixel_pack_kernel

            self._memo["packed"] = Int8Weight(subpixel_pack_kernel(self.q),
                                              self.scale.repeat_interleave(4), self.a)
        return self._memo["packed"]


@dataclass(eq=False)
class FakeQuant:
    """QAT marker of one site: fake-quantize its conv on the int8 serving
    grid, with the calibrated static activation scale ``a`` when given,
    else per-image dynamic scales."""

    a: Optional[torch.Tensor] = None


@dataclass(eq=False)
class FakeQuantWeight:
    """A site's live float weight (OIHW) with its QAT marker's ``a``: what
    `ops.conv.conv2d` dispatches to the fake-quant conv."""

    w: torch.Tensor
    a: Optional[torch.Tensor] = None


# a site's entry: int8 serving or QAT (or an exported weight-only kernel)
QuantSites = Dict[str, Union[Int8Weight, FakeQuant, torch.Tensor]]


def is_int8_kernel(w) -> bool:
    """True for a calibrated int8 site (``q`` and a static ``a``): the
    predicate of the packed-layout upsample and the subpixel conv_last.
    Dynamic-scale and QAT sites take the plain paths."""
    return isinstance(w, Int8Weight) and w.a is not None


def site_weight(quant: Optional[QuantSites], name: str, weight: torch.Tensor):
    """What the forward hands `conv2d` for the conv at ``name``: its float
    ``weight``, the site's `Int8Weight`, the weight paired with the site's
    QAT marker, or a float tensor in the site's place (the dequantized
    kernel of a weight-only int8 `.pt2`, `ckpt.export`)."""
    site = None if quant is None else quant.get(name)
    if site is None:
        return weight
    if isinstance(site, FakeQuant):
        return FakeQuantWeight(weight, site.a)
    return site


# ---------------------------------------------------------------------------
# Site selection (the JAX layout)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvLeaf:
    """One >= 4-d float leaf of the JAX parameter tree: its path, its
    leading stack axes, its per-site OIHW shape and the port module paths
    of its sites, row-major over the stack (empty for the SE matrices,
    which are not convs)."""

    path: Tuple[Union[str, int], ...]
    stack: Tuple[int, ...]
    shape: Tuple[int, ...]
    names: Tuple[str, ...]


def _is_conv_kernel(path, shape, dtype) -> bool:
    """The JAX package's shared site predicate of the serving and QAT
    transforms: float leaves with >= 4 dims (the stacked shape) and at
    least MIN_QUANT_SIZE elements, outside any ``ca``/``fc*`` path."""
    keys = [str(k) for k in path]
    if any(k == "ca" or k.startswith("fc") for k in keys):
        return False
    size = int(np.prod(shape, dtype=np.int64))
    return (len(shape) >= 4 and size >= MIN_QUANT_SIZE
            and dtype in (torch.float32, torch.bfloat16))


def _oihw(conv) -> Tuple[int, ...]:
    return tuple(conv.weight.shape)


def _face_enhance_net_leaves(model) -> List[ConvLeaf]:
    cfg = model.config
    g_n, b_n = cfg.num_groups, cfg.blocks_per_group
    blk = model.residual_groups[0].blocks[0]
    fc1, fc2 = blk.channel_attention.fc[0].weight, blk.channel_attention.fc[2].weight
    rcab_names = lambda conv: tuple(f"residual_groups.{g}.blocks.{b}.{conv}"  # noqa: E731
                                    for g in range(g_n) for b in range(b_n))
    leaves = [
        ConvLeaf(("conv_after_body", "w"), (), _oihw(model.conv_after_body), ("conv_after_body",)),
        ConvLeaf(("conv_first", "w"), (), _oihw(model.conv_first), ("conv_first",)),
        ConvLeaf(("conv_last", "w"), (), _oihw(model.conv_last), ("conv_last",)),
        ConvLeaf(("groups", "conv_w"), (g_n,), _oihw(model.residual_groups[0].conv),
                 tuple(f"residual_groups.{g}.conv" for g in range(g_n))),
        # the SE matrices ([G, B, in, out]) are 4-d too; the predicate
        # keeps them float by their path
        ConvLeaf(("groups", "rcab", "ca", "fc1_w"), (g_n, b_n), tuple(fc1.t().shape), ()),
        ConvLeaf(("groups", "rcab", "ca", "fc2_w"), (g_n, b_n), tuple(fc2.t().shape), ()),
        ConvLeaf(("groups", "rcab", "conv1_w"), (g_n, b_n), _oihw(blk.conv1), rcab_names("conv1")),
        ConvLeaf(("groups", "rcab", "conv2_w"), (g_n, b_n), _oihw(blk.conv2), rcab_names("conv2")),
    ]
    return leaves + _upsample_leaves(model.upsample, ("upsample",), "upsample")


def _upsample_leaves(up, path, prefix) -> List[ConvLeaf]:
    return [ConvLeaf(path + (s, "conv_w"), (), _oihw(st.conv), (f"{prefix}.stages.{s}.conv",))
            for s, st in enumerate(up.stages)]


def _rrdb_body_leaves(body, path, prefix: str, blocks: range) -> List[ConvLeaf]:
    """The leaves of the RRDB blocks ``blocks`` of ``body`` stacked at JAX
    ``path``: one per (RDB, conv), in sorted key order, each with a site a
    block; none for an empty stack (JAX's None)."""
    if not len(blocks):
        return []
    blk = body[blocks[0]]
    return [ConvLeaf(path + (r, f"conv{k}_w"), (len(blocks),),
                     _oihw(getattr(getattr(blk, r), f"conv{k}")),
                     tuple(f"{prefix}.{i}.{r}.conv{k}" for i in blocks))
            for r in ("rdb1", "rdb2", "rdb3") for k in range(1, 6)]


def _conv_leaf(model, path, name) -> ConvLeaf:
    return ConvLeaf(path, (), _oihw(model.get_submodule(name)), (name,))


def _rrdbnet_leaves(model) -> List[ConvLeaf]:
    body = _rrdb_body_leaves(model.body, ("body",), "body", range(len(model.body)))
    return body + [_conv_leaf(model, (name, "w"), name)
                   for name in ("conv_body", "conv_first", "conv_hr", "conv_last", "conv_up1",
                                "conv_up2")]


def _transfer_leaves(model) -> List[ConvLeaf]:
    from facesr_torch.models.transfer import STAGE2_UNFREEZE_BLOCKS

    body, hd = model.backbone.body, model.face_head
    n = len(body)
    n_main = n - min(STAGE2_UNFREEZE_BLOCKS, n)
    blk = hd.rcab_blocks[0]
    b_n = len(hd.rcab_blocks)
    return (_rrdb_body_leaves(body, ("backbone", "body_main"), "backbone.body", range(n_main))
            + _rrdb_body_leaves(body, ("backbone", "body_tail"), "backbone.body",
                                range(n_main, n))
            + [_conv_leaf(model, ("backbone", "conv_body", "w"), "backbone.conv_body"),
               _conv_leaf(model, ("backbone", "conv_first", "w"), "backbone.conv_first"),
               _conv_leaf(model, ("face_head", "conv_after", "w"), "face_head.conv_after"),
               _conv_leaf(model, ("face_head", "conv_last", "w"), "face_head.conv_last")]
            # the head's SE matrices ([B, in, out]) are 3-d: not listed
            + [ConvLeaf(("face_head", "rcabs", f"{conv}_w"), (b_n,),
                        _oihw(getattr(blk, conv)),
                        tuple(f"face_head.rcab_blocks.{b}.{conv}" for b in range(b_n)))
               for conv in ("conv1", "conv2")]
            + _upsample_leaves(hd.upsample, ("face_head", "upsample"), "face_head.upsample"))


def conv_leaves(model) -> List[ConvLeaf]:
    """The >= 4-d leaves of a model's JAX parameter tree, in JAX
    tree-flatten order (sorted keys; the upsample stages a list): a
    FaceEnhanceNet (``custom``/``lite``), an RRDBNet (``esrgan``) or a
    transfer model, by its ``model_type``."""
    mtype = getattr(model, "model_type", "custom")
    if mtype == "esrgan":
        return _rrdbnet_leaves(model)
    if mtype == "transfer":
        return _transfer_leaves(model)
    return _face_enhance_net_leaves(model)


def quant_leaves(model) -> List[ConvLeaf]:
    """The leaves the transforms quantize, in JAX tree-flatten order."""
    dtype = next(model.parameters()).dtype
    return [leaf for leaf in conv_leaves(model)
            if _is_conv_kernel(leaf.path, leaf.stack + leaf.shape, dtype)]


def _conv_modules(model) -> Dict[str, torch.nn.Module]:
    return dict(model.named_modules())


def over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, divided by a tensor on t's device: a CUDA tensor divided by
    a Python number is multiplied by its rounded reciprocal, one bit off
    the true quotient the CPU and JAX compute."""
    return t / torch.full((), 127.0, device=t.device)


def amax_scale(t: torch.Tensor, dim) -> torch.Tensor:
    """max|t| over ``dim`` (kept) / 127."""
    return over_127(t.abs().amax(dim=dim, keepdim=True))


def _quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, f32 scale [O]) of one OIHW kernel: scale = max|w| over
    (I, kh, kw) / 127 (0 -> 1), q = round-half-even(w / scale) clipped to
    +-127."""
    f = w.detach().float()
    scale = amax_scale(f, (1, 2, 3)).reshape(-1)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(f / scale[:, None, None, None]), -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# Serving transforms
# ---------------------------------------------------------------------------

def quantize_conv_kernels(model, with_sids: bool = False):
    """The int8 serving transform: ``{site: Int8Weight}`` for every conv
    the predicate selects (biases, PReLU slopes and the SE matrices stay
    float). int8_full runs them with dynamic per-image activation scales;
    weight-only int8 serves their `dequantize_pytree`. ``with_sids``: each
    site also carries its id (JAX tree-flatten order, row-major over a
    stack) and the call returns ``(sites, n_sites)``, for
    `calibrate_act_scales`."""
    modules = _conv_modules(model)
    sites: Dict[str, Int8Weight] = {}
    for leaf in quant_leaves(model):
        for name in leaf.names:
            q, scale = _quantize_weight(modules[name].weight)
            sites[name] = Int8Weight(q, scale, None, len(sites) if with_sids else None)
    return (sites, len(sites)) if with_sids else sites


def dequantize_pytree(sites: Dict[str, Int8Weight],
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The sites' weights as weight-only int8 serves them:
    ``{site: (q.f32 * scale) cast to dtype}``."""
    return {name: (w.q.float() * w.scale[:, None, None, None]).to(dtype)
            for name, w in sites.items()}


# ---------------------------------------------------------------------------
# Activation-scale calibration
# ---------------------------------------------------------------------------
#
# While a window is open, every int8 conv with a site id records the
# largest of its per-image dynamic scales, max over all forwards run inside
# the window. The maxima stay on the device (torch.maximum, so a NaN sticks,
# as np.maximum does in the JAX package) until the window closes.

_ACT_STATS: dict = {"sites": None, "lock": threading.Lock()}


def record_act_scale(w: Int8Weight, a: torch.Tensor) -> None:
    """Called by the int8 conv with its dynamic scales ``a`` [N, 1, 1, 1];
    records only inside a window, for a site with an id."""
    if w.sid is None:
        return
    with _ACT_STATS["lock"]:
        seen = _ACT_STATS["sites"]
        if seen is None:
            return
        m = a.detach().max().float()
        seen[w.sid] = m if w.sid not in seen else torch.maximum(seen[w.sid], m)


@contextlib.contextmanager
def collecting_act_stats(n_sites: int):
    """Open a calibration window. Yields a float64 array of ``n_sites``,
    filled with each site's recorded maximum when the window closes (0 for
    a site that never ran)."""
    with _ACT_STATS["lock"]:
        if _ACT_STATS["sites"] is not None:
            raise RuntimeError("nested activation-stats collection")
        _ACT_STATS["sites"] = {}
    arr = np.zeros(n_sites, np.float64)
    try:
        yield arr
    finally:
        with _ACT_STATS["lock"]:
            seen, _ACT_STATS["sites"] = _ACT_STATS["sites"], None
        for sid, m in seen.items():
            arr[sid] = float(m)


def attach_act_scales(sites: Dict[str, Int8Weight], stats: np.ndarray,
                      margin: float = 1.0) -> Dict[str, Int8Weight]:
    """Static scales from calibration stats: each site's ``a`` =
    f32(stat) * margin (1.0 where that is <= 0); the site ids go."""
    out = {}
    for name, w in sites.items():
        a = np.float32(stats[w.sid]) * np.float32(margin)
        a = np.float32(1.0) if a <= 0 else a
        out[name] = Int8Weight(w.q, w.scale, torch.tensor(a, dtype=torch.float32,
                                                           device=w.q.device))
    return out


def calibrate_act_scales(model, forward_fn: Callable, batches: Iterable,
                         margin: float = 1.0) -> Dict[str, Int8Weight]:
    """Quantize ``model``'s conv kernels, run ``forward_fn(sites, batch)``
    over the calibration batches with dynamic scales and recording on,
    and return the sites with static activation scales. Raises when a site
    records no positive finite maximum (every site runs on every forward,
    so that means a forward that bypassed the sites, degenerate input or
    non-finite activations)."""
    sites, n_sites = quantize_conv_kernels(model, with_sids=True)
    with collecting_act_stats(n_sites) as stats:
        for batch in batches:
            forward_fn(sites, batch)
    bad = np.flatnonzero(~(stats > 0) | ~np.isfinite(stats))
    if bad.size:
        raise RuntimeError(
            f"calibration left {bad.size}/{stats.size} conv sites without a "
            f"positive finite activation max (sids {bad[:8].tolist()}"
            f"{'...' if bad.size > 8 else ''}): did the forward take the quantized "
            "sites, and was the calibration input non-degenerate?")
    return attach_act_scales(sites, stats, margin=margin)


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------

def fake_quant_params(model, act_scales: Optional[Dict[str, Int8Weight]] = None
                      ) -> Dict[str, FakeQuant]:
    """QAT transform: ``{site: FakeQuant}`` for the sites int8 serving
    quantizes. ``act_scales``: calibrated sites of the same architecture
    (`calibrate_act_scales`, or a quant cache through
    `parallel.serving.load_calibrated_qparams`); their static ``a`` pins
    the fake-quant grid, saturation included. A site set or kernel shape
    that differs from this model's raises."""
    names = [n for leaf in quant_leaves(model) for n in leaf.names]
    if act_scales is None:
        return {n: FakeQuant() for n in names}
    if set(act_scales) != set(names):
        raise ValueError(
            f"act_scales does not match this model's sites: {len(act_scales)} vs "
            f"{len(names)} sites (missing {sorted(set(names) - set(act_scales))[:4]}, "
            f"extra {sorted(set(act_scales) - set(names))[:4]}); calibrate on the same "
            "architecture")
    modules = _conv_modules(model)
    out = {}
    for n in names:
        site = act_scales[n]
        if not is_int8_kernel(site):
            raise ValueError(f"act_scales has no calibrated scale at {n}")
        if tuple(site.q.shape) != tuple(modules[n].weight.shape):
            raise ValueError(
                f"act_scales was calibrated on a different architecture: kernel "
                f"{tuple(site.q.shape)} vs {tuple(modules[n].weight.shape)} at {n}")
        out[n] = FakeQuant(site.a.detach().to(modules[n].weight.device))
    return out


def quantization_summary(model, sites: Dict[str, Int8Weight]) -> dict:
    """Footprint of a quantized model, counted over its JAX-layout tree as
    the JAX package counts it: int8 leaves at 1 byte, the rest at their
    size; sidecars (scales, ``a``, site ids) count toward ``bytes`` but
    not toward the float baseline ``bytes_f32``."""
    from facesr_torch.ckpt.weights import jax_qtree_from_sites

    tree = jax_qtree_from_sites(model, sites)
    q_bytes = f_bytes = orig = n_q = total = 0
    stack = [((), tree)]
    while stack:
        path, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((path + (k,), v) for k, v in node.items())
            continue
        if isinstance(node, list):
            stack.extend((path + (i,), v) for i, v in enumerate(node))
            continue
        arr = np.asarray(node)
        total += 1
        if arr.dtype == np.int8:
            q_bytes += arr.size
            n_q += 1
            orig += arr.size * 4
        else:
            f_bytes += arr.nbytes
            if path[-1] not in ("scale", "a", "sid"):
                orig += arr.size * 4
    return {"quantized_leaves": n_q, "total_leaves": total, "bytes": q_bytes + f_bytes,
            "bytes_f32": orig, "compression": orig / max(q_bytes + f_bytes, 1)}
