"""NHWC convolution and activation primitives.

Port of `facesr/ops/conv.py`. Tensors are NHWC at the
API; ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is already a
``channels_last`` NCHW tensor, so cuDNN sees NHWC with no copy, and the
result permutes back to contiguous NHWC. Weights are torch OIHW.

Precision: the JAX package forces ``Precision.HIGHEST`` for f32 convs
(reduced precision broke SSIM's E[x^2]-E[x]^2). cuDNN runs f32 convs in
TF32 by default on Hopper, so f32 convs here run with TF32 off (and f32
matmuls, which cuBLAS runs in IEEE float32 unless a caller allows TF32). The bf16
path is the explicit ``dtype=torch.bfloat16`` policy. cuDNN reads the flag
when a conv runs, and autograd runs the backward convs after `conv2d` has
returned, so a training step holds `full_f32()` around its backward too.

`conv2d` dispatches on the weight, as the JAX one does on its dict:
an `ops.quant.Int8Weight` takes the s8 x s8 -> s32 conv (`_conv2d_int8`:
an im2col of nine shifted slices of the zero-padded int8 input, and
``torch._int_mm``, cuBLASLt's int8 tensor-core GEMM on a card), a
`FakeQuantWeight` the differentiable fake-quant conv of QAT
(`_conv2d_fakequant`).

A serving site's int8 conv is one call of the custom op
``facesr_torch::int8_conv`` (the same code on every device; a fake that
gives the output's shape), so `torch.export` keeps each int8 conv as one
graph node, whose im2col chunking runs at the batch the program is
called with: an int8 ``.pt2`` keeps a symbolic batch, and the chunks stay
under `INT8_CHUNK_BYTES` at any batch. A site with a calibration id runs
the same code outside the op, to record its dynamic scales.

Under a row shard (`parallel.spatial`, two or more shards) a conv pads
its rows with the neighbours' boundary rows (`RowShard.halo`, zeros at the
image's edges) instead of zeros, as many above and below as
`spatial.conv_halo` plans (a stride-2 3x3 conv one above, none below),
and its W padding stays local; a strided conv whose output rows do not
split with the shards' raises ValueError (the discriminator gathers the
map before it). An int8 conv and the QAT fake-quant conv exchange the
float rows before they quantize them, their dynamic activation scale the
max over the shards (the whole image's max|x|); a static scale and the
weights' per-channel scales need no exchange.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from facesr_torch.ops import quant as _quant
from facesr_torch.ops.quant import FakeQuantWeight, Int8Weight
from facesr_torch.parallel import spatial

__all__ = ["conv2d", "quantize_act", "prelu", "leaky_relu", "global_avg_pool", "full_f32",
           "INT8_CHUNK_BYTES", "int8_gemm_pads", "int8_site_of_gemm", "fake_quant_scale"]


_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_saved = (True, False)


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """cuDNN float32 convs and cuBLAS float32 matmuls in IEEE float32, not
    TF32. The flags are process-wide, so overlapping users (serving
    threads) are counted: the first turns TF32 off and the last out
    restores the caller's settings. f32 ops on other threads meanwhile only
    become more exact."""
    global _tf32_users, _tf32_saved
    with _tf32_lock:
        if _tf32_users == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_users -= 1
            if _tf32_users == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved


Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def _pad_arg(padding: Padding) -> Union[int, Tuple[int, int]]:
    if isinstance(padding, int):
        return padding
    (top, bottom), (left, right) = padding
    if top != bottom or left != right:
        raise ValueError(f"conv2d takes symmetric padding per axis, got {padding}")
    return top, left


def conv2d(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
           padding: Padding = 1, dtype: Optional[torch.dtype] = None,
           groups: int = 1, stride: int = 1) -> torch.Tensor:
    """2-D convolution, NHWC x OIHW -> NHWC. ``padding`` is an int
    (PyTorch ``padding=k``) or per axis ``((ph, ph), (pw, pw))``; ``groups``
    is the JAX ``feature_group_count`` (``groups=C`` with a [C, 1, kh, kw]
    weight is depthwise). ``dtype`` casts the input first; the weight
    follows the input's dtype. The bias is added after the convolution in
    the output dtype, as in the JAX package. An `Int8Weight` or a
    `FakeQuantWeight` takes the int8 or the fake-quant conv."""
    shard = spatial.current()
    if shard is not None:
        x, padding = _halo_rows(shard, x, w, padding, stride)
    if isinstance(w, Int8Weight):
        return _conv2d_int8(x, w, b, stride, padding, groups, dtype)
    if isinstance(w, FakeQuantWeight):
        return _conv2d_fakequant(x, w, b, stride, padding, groups, dtype)
    if dtype is not None:
        x = x.to(dtype)
    w = w.to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    pad = _pad_arg(padding)
    if x.dtype == torch.float32:
        with full_f32():
            out = F.conv2d(xc, w, stride=stride, padding=pad, groups=groups)
    else:
        out = F.conv2d(xc, w, stride=stride, padding=pad, groups=groups)
    out = out.permute(0, 2, 3, 1)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def _halo_rows(shard, x: torch.Tensor, w, padding: Padding, stride: int):
    """``x`` with its row padding taken from the neighbouring shards
    (`spatial.conv_halo`), and the padding left for the conv (the W
    padding only)."""
    kh = (w.q if isinstance(w, Int8Weight) else w.w if isinstance(w, FakeQuantWeight)
          else w).shape[2]
    pad = _pad_arg(padding)
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    plan = shard.conv_rows(x.shape[1], kh, ph, stride)
    if plan is None:
        raise ValueError(f"a stride-{stride} conv over row shards of {x.shape[1]} rows: its "
                         f"output rows do not split with the shards' (gather the map first)")
    return shard.halo(x, *plan), ((0, 0), (pw, pw))


# ---------------------------------------------------------------------------
# int8 convs
# ---------------------------------------------------------------------------

# the im2col rows of one int8 GEMM are chunked so that the int8 columns and
# the s32 product of a chunk stay under this many bytes each (a 256x256
# SpatialPredictor forward or a batch of 128 stays bounded)
INT8_CHUNK_BYTES = 1 << 28


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_gemm_pads(q_shape) -> Tuple[int, int]:
    """(K, N) of the im2col GEMM of an OIHW int8 kernel, padded to the
    multiples of 8 that ``torch._int_mm`` takes on a card."""
    o, i, kh, kw = q_shape
    return _round_up(kh * kw * i, 8), _round_up(o, 8)


def _out_size(size: int, k: int, pad: int, stride: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def _int8_gemm_conv(xq: torch.Tensor, w: Int8Weight, stride: int, pad: Tuple[int, int]):
    """The s8 conv of NHWC int8 ``xq`` in row chunks: yields ``(y, n0, n1,
    h0, h1)``, ``y`` the s32 [n1 - n0, h1 - h0, Wo, O] product for images
    n0..n1 and output rows h0..h1. Each chunk is an im2col (nine shifted
    slices of the zero-padded input, K ordered (kh, kw, I)) times the
    kernel matrix. ``torch._int_mm`` wants more than 16 rows and K and N
    multiples of 8 on a card: zero rows, K columns and N columns are
    padded in, which keeps the integer sums exact."""
    n, h, wd, c = xq.shape
    o, i, kh, kw = w.q.shape
    if i != c:
        raise ValueError(f"int8 conv: input has {c} channels, the kernel takes {i}")
    ph, pw = pad
    ho, wo = _out_size(h, kh, ph, stride), _out_size(wd, kw, pw, stride)
    k = kh * kw * c
    k_pad, n_pad = int8_gemm_pads(w.q.shape)
    wmat = w.gemm_weight(k_pad, n_pad).t()
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph)) if ph or pw else xq.contiguous()
    rows = max(1, INT8_CHUNK_BYTES // (wo * max(k_pad, 4 * n_pad)))  # output rows a chunk
    nb = max(1, min(n, rows // ho))  # whole images a chunk
    hb = ho if rows >= ho else rows  # or a band of one image's rows
    for n0 in range(0, n, nb):
        n1 = min(n, n0 + nb)
        for h0 in range(0, ho, hb):
            h1 = min(ho, h0 + hb)
            band = xp[n0:n1, h0 * stride:(h1 - 1) * stride + kh]
            if k_pad == k and c % 8 == 0:
                # move the taps as int64 words: an 8x smaller copy than bytes
                band = band.view(torch.int64)
            taps = [band[:, dy:dy + (h1 - h0 - 1) * stride + 1:stride,
                         dx:dx + (wo - 1) * stride + 1:stride]
                    for dy in range(kh) for dx in range(kw)]
            if k_pad > k:
                taps.append(band.new_zeros((n1 - n0, h1 - h0, wo, k_pad - k)))
            cols = torch.cat(taps, dim=-1).view(torch.int8).reshape(-1, k_pad)
            m = cols.shape[0]
            if m <= 16:
                cols = torch.cat([cols, cols.new_zeros((24 - m, k_pad))])
            y = torch._int_mm(cols, wmat)[:m, :o]
            yield y.reshape(n1 - n0, h1 - h0, wo, o), n0, n1, h0, h1


def _conv2d_int8(x: torch.Tensor, w: Int8Weight, b: Optional[torch.Tensor], stride: int,
                 padding: Padding, groups: int, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The int8 conv of a site (`_int8_conv`): through the custom op
    ``facesr_torch::int8_conv``, or, for a site with a calibration id, in
    Python (it records its dynamic scales)."""
    if groups != 1:
        raise NotImplementedError("the int8 conv takes groups=1 only")
    if w.sid is not None or spatial.current() is not None:
        return _int8_conv(x, w, b, stride, padding, dtype)
    pad = _pad_arg(padding)
    pad = [pad, pad] if isinstance(pad, int) else list(pad)
    if x.dtype == torch.int8:
        out_dtype = dtype if dtype is not None else torch.float32
    else:
        if dtype is not None:
            x = x.to(dtype)
        out_dtype = x.dtype if x.dtype.is_floating_point else torch.float32
    return torch.ops.facesr_torch.int8_conv(x, w.gemm_weight(*int8_gemm_pads(w.q.shape)),
                                            w.scale, w.a, b, list(w.q.shape), stride, pad,
                                            out_dtype)


def int8_site_of_gemm(wmat: torch.Tensor, scale: torch.Tensor, a: Optional[torch.Tensor],
                      q_shape: List[int]) -> Int8Weight:
    """The site of a GEMM matrix ``wmat`` (`Int8Weight.gemm_weight`, its
    OIHW shape ``q_shape``): its OIHW kernel a view of the matrix."""
    o, i, kh, kw = q_shape
    q = wmat[:o, :kh * kw * i].reshape(o, kh, kw, i).permute(0, 3, 1, 2)
    return Int8Weight(q, scale, a, _memo={("gemm",) + int8_gemm_pads(q_shape): wmat})


@torch.library.custom_op("facesr_torch::int8_conv", mutates_args=())
def _int8_conv_op(x: torch.Tensor, wmat: torch.Tensor, scale: torch.Tensor,
                  a: Optional[torch.Tensor], b: Optional[torch.Tensor], q_shape: List[int],
                  stride: int, pad: List[int], out_dtype: torch.dtype) -> torch.Tensor:
    """`_int8_conv` of the site (``wmat`` its [N_pad, K_pad] GEMM matrix,
    `Int8Weight.gemm_weight`, ``q_shape`` its OIHW shape); the output in
    ``out_dtype``."""
    return _int8_conv(x, int8_site_of_gemm(wmat, scale, a, q_shape), b, stride,
                      (tuple(pad[:1] * 2), tuple(pad[1:] * 2)), out_dtype)


@_int8_conv_op.register_fake
def _(x, wmat, scale, a, b, q_shape, stride, pad, out_dtype):
    n, h, wd, _ = x.shape
    o, _, kh, kw = q_shape
    return x.new_empty((n, _out_size(h, kh, pad[0], stride), _out_size(wd, kw, pad[1], stride),
                        o), dtype=out_dtype)


def _int8_conv(x: torch.Tensor, w: Int8Weight, b: Optional[torch.Tensor], stride: int,
               padding: Padding, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """s8 x s8 -> s32 conv with per-tensor activation quantization:
    ``out = conv(round(x / a), q) * (a * scale) + b``, assembled in f32 in
    that order (then cast), as the JAX package does. ``a`` is the site's
    static scale, or per image max|x| / 127 (0 -> 1), recorded while a
    calibration window is open. An int8 ``x`` is already on this conv's
    static grid (the packed upsample quantizes before the shuffle) and
    needs ``w.a``. The output takes x's float dtype (``dtype``, or f32 for
    an int8 x)."""
    if x.dtype == torch.int8:
        if w.a is None:
            raise ValueError("int8 conv input requires a static scale "
                             "(a calibrated Int8Weight with 'a')")
        a = w.a.reshape(1, 1, 1, 1)
        xq = x
        out_dtype = dtype if dtype is not None else torch.float32
    else:
        if dtype is not None:
            x = x.to(dtype)
        out_dtype = x.dtype if x.dtype.is_floating_point else torch.float32
        if w.a is not None:
            # static scale: out-of-range activations saturate at +-127
            a = w.a.reshape(1, 1, 1, 1)
        else:
            # per image, so an image's grid does not depend on its batchmates;
            # max|x| = max(-min x, max x), without an |x| pass
            lo, hi = torch.aminmax(x.reshape(x.shape[0], -1), dim=1)
            amax = torch.maximum(-lo, hi).float().reshape(-1, 1, 1, 1)
            shard = spatial.current()
            if shard is not None:  # the image's max: halo rows are its rows or zeros
                amax = shard.max(amax)
            a = _quant.over_127(amax)
            a = torch.where(a == 0, torch.ones_like(a), a)
            _quant.record_act_scale(w, a)
        xq = quantize_act(x, a)
    dq = a * w.scale.reshape(1, 1, 1, -1)  # [N or 1, 1, 1, O]
    bias = None if b is None else b.float()
    pad = _pad_arg(padding)
    pad = (pad, pad) if isinstance(pad, int) else pad
    n, h, wd, _ = xq.shape
    o, _, kh, kw = w.q.shape
    ho, wo = _out_size(h, kh, pad[0], stride), _out_size(wd, kw, pad[1], stride)
    out = None
    for y, n0, n1, h0, h1 in _int8_gemm_conv(xq, w, stride, pad):
        # the s32 product times the f32 scales (int32 * f32 promotes each
        # element to f32 first, as y.float() would), then the bias
        part = torch.mul(y, dq if dq.shape[0] == 1 else dq[n0:n1])
        if bias is not None:
            part.add_(bias)
        if (n1 - n0, h1 - h0) == (n, ho):  # one chunk: the whole output
            return part.to(out_dtype)
        if out is None:
            out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=xq.device)
        out[n0:n1, h0:h1].copy_(part)  # the cast on the way
    return out


def quantize_act(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Activations on the s8 grid of scale ``a``: round-half-even(x / a) in
    f32, clipped to +-127. Producers quantize before a pure permutation
    (the pixel shuffle) with it: per-tensor quantization commutes with one."""
    # the quotient in f32, as JAX's: a 0-d ``a`` would not promote a bf16 x
    # (the quotient would round to bf16 first), so it takes x's rank; on
    # x's device, since a CPU scalar divisor of a CUDA tensor becomes a
    # multiply by its reciprocal
    a = a.to(device=x.device, dtype=torch.float32)
    q = torch.round(torch.div(x, a.reshape((1,) * x.dim()) if a.dim() == 0 else a))
    return q.clamp_(-127, 127).to(torch.int8)


def _ste_round(v: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through gradient (d/dv = 1)."""
    return v + (torch.round(v) - v).detach()


def _clip127(v: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(v, -127, 127)`` with its gradient: max then min, each
    splitting the gradient evenly at a tie, as torch.maximum/minimum and
    JAX's max/min do (so an element exactly at the grid edge passes half)."""
    lo = torch.full((), -127.0, dtype=v.dtype, device=v.device)
    hi = torch.full((), 127.0, dtype=v.dtype, device=v.device)
    return torch.minimum(hi, torch.maximum(lo, v))


def _conv2d_fakequant(x: torch.Tensor, w: FakeQuantWeight, b: Optional[torch.Tensor],
                      stride: int, padding: Padding, groups: int,
                      dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Differentiable mirror of `_conv2d_int8` for QAT: the conv of the
    weight and the input snapped onto the int8 serving grid (the same
    per-output-channel weight scales, per-image or static activation
    scales, round and clip) but kept float, with straight-through
    gradients to the latent weights; the scales are detached. The conv
    runs in the policy dtype (x's, after ``dtype``)."""
    if dtype is not None:
        x = x.to(dtype)
    out_dtype = x.dtype if x.dtype.is_floating_point else torch.float32
    wf = w.w.float()
    s = fake_quant_scale(wf)
    wq = _clip127(_ste_round(wf / s)) * s
    xf = x.float()
    a = fake_quant_scale(xf, w.a, shard=spatial.current())
    xq = _clip127(_ste_round(xf / a)) * a
    with spatial.rows(None):  # x already holds its halo rows
        return conv2d(xq.to(out_dtype), wq.to(out_dtype), b, padding=padding, groups=groups,
                      stride=stride)


def fake_quant_scale(t: torch.Tensor, static: Optional[torch.Tensor] = None,
                     shard=None) -> torch.Tensor:
    """The scale the fake-quant conv divides f32 ``t`` by: the calibrated
    serving grid ``static`` of an activation (saturation included), else
    max|t| / 127 (0 -> 1) per leading index (an image of an NHWC
    activation, an output channel of an OIHW kernel), detached. Under a
    row ``shard`` (``t`` its rows) the max is the whole image's, over the
    shards, taken before the 0 -> 1."""
    if static is not None:
        return static.reshape(1, 1, 1, 1)
    a = _quant.amax_scale(t, (1, 2, 3)).detach()
    if shard is not None:
        a = shard.max(a)
    return torch.where(a == 0, torch.ones_like(a), a)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Per-channel PReLU on NHWC; alpha [C]."""
    a = alpha.to(x.dtype)
    return torch.where(x >= 0, x, a * x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> [N, C] global average pool (SE squeeze), over the whole
    image under a row shard."""
    return spatial.mean(x, (1, 2))
