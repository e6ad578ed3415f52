"""One residual group (B RCABs + tail conv + group skip) as one kernel call.

Port of the Pallas TPU kernel `fused_residual_group` in
`facesr/ops/pallas/rcab_group.py`. On a CUDA tensor the wrapper launches
the hand-written Hopper kernel in ``facesr_torch/csrc/rcab_group.cu`` (see
the note there for its design and what bounds it) and raises for anything
the kernel does not take; on a CPU tensor it computes the plain version,
`rcab_group_reference`. There is no fallback between the two.

The call goes through the custom op ``torch.ops.facesr_torch.rcab_group``
(``torch.library.custom_op``: a CUDA kernel that launches the Hopper
kernel, a CPU kernel that is the plain version, a fake that gives
``empty_like(x)``), so ``torch.export`` keeps the group as one node of the
exported graph and the loaded artifact launches the same kernel. The op
takes the ten weight tensors one by one (a custom op takes no dict).

Precision (the Pallas kernel's rounding points): the feature accumulator
stays f32 for the whole group, every conv input is the f32 buffer rounded
to bf16, conv products are bf16 x bf16 accumulated in f32 with the bias
added in f32, PReLU and the SE path run in f32, and the output is
``bf16(acc + x)``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch
import torch.nn.functional as F

from facesr_torch.ops.conv import conv2d

__all__ = ["fused_residual_group", "rcab_group_reference", "rcab_group",
           "prepare_group_weights", "group_weight_args", "KERNEL_CHANNELS"]

KERNEL_CHANNELS = 64  # the CUDA kernel's only channel width

GroupWeights = Dict[str, torch.Tensor]


def prepare_group_weights(group) -> GroupWeights:
    """One `ResidualGroup` module's parameters in the kernel layout (the
    JAX package's `prepare_group_weights` layout): convs [B, 3, 3C, C]
    bf16 with row index dx*C + cin per dy; biases and PReLU slopes [B, C]
    f32; SE fc1 [B, C, Cr] and fc2 [B, Cr, C] f32 (i.e. [in, out]); tail
    conv wg [3, 3C, C] bf16, bg [C] f32. Detached and contiguous."""
    blocks = list(group.blocks)

    def to_mat(w_oihw: torch.Tensor) -> torch.Tensor:
        # OIHW -> HWIO -> [3, 3*Cin, Cout]
        o, i, kh, kw = w_oihw.shape
        return w_oihw.permute(2, 3, 1, 0).reshape(kh, kw * i, o)

    def stack(fn) -> torch.Tensor:
        return torch.stack([fn(b) for b in blocks]).detach()

    return {
        "w1": stack(lambda b: to_mat(b.conv1.weight)).to(torch.bfloat16).contiguous(),
        "b1": stack(lambda b: b.conv1.bias).float().contiguous(),
        "a": stack(lambda b: b.prelu.weight).float().contiguous(),
        "w2": stack(lambda b: to_mat(b.conv2.weight)).to(torch.bfloat16).contiguous(),
        "b2": stack(lambda b: b.conv2.bias).float().contiguous(),
        "fc1": stack(lambda b: b.channel_attention.fc[0].weight.t()).float().contiguous(),
        "fc2": stack(lambda b: b.channel_attention.fc[2].weight.t()).float().contiguous(),
        "wg": to_mat(group.conv.weight).detach().to(torch.bfloat16).contiguous(),
        "bg": group.conv.bias.detach().float().contiguous(),
    }


def _mat_to_oihw(m: torch.Tensor) -> torch.Tensor:
    """[3, 3C, C] kernel layout -> OIHW."""
    kh, kwc, c = m.shape
    return m.reshape(kh, kwc // c, c, c).permute(3, 2, 0, 1)


def rcab_group_reference(x: torch.Tensor, gw: GroupWeights,
                         res_scale: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device. ``x`` NHWC of any
    float dtype; computes on bf16(x) and returns bf16 cast back to x's
    dtype, as the Pallas wrapper does. Each conv is an f32 conv of
    bf16-rounded operands — products of bf16 values are exact in f32, so
    this is "bf16 operands, f32 accumulation"."""
    def bf(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).float()

    def conv(t, w_mat, b):
        return conv2d(bf(t), bf(_mat_to_oihw(w_mat)), b.float(), padding=1)

    x32 = bf(x)
    feat = x32
    for k in range(gw["w1"].shape[0]):
        t = conv(feat, gw["w1"][k], gw["b1"][k])
        a = gw["a"][k].float()
        t = torch.where(t >= 0, t, a * t)
        t = conv(t, gw["w2"][k], gw["b2"][k])
        y = t.mean(dim=(1, 2))
        y = F.relu(y @ gw["fc1"][k].float())
        y = torch.sigmoid(y @ gw["fc2"][k].float())
        feat = feat + (t * y[:, None, None, :]) * res_scale
    out = conv(feat, gw["wg"], gw["bg"]) + x32
    return out.to(torch.bfloat16).to(x.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 5
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


_lib_lock = threading.Lock()  # serving threads reach the first call together


def _lib() -> ctypes.CDLL:
    from facesr_torch.ops._build import load_library

    lib = load_library("rcab_group")
    with _lib_lock:
        if lib.rcab_group_error_name.restype is not ctypes.c_char_p:
            lib.rcab_group_forward.argtypes = _ARGTYPES
            lib.rcab_group_forward.restype = ctypes.c_int
            lib.rcab_group_plan.argtypes = ([ctypes.c_int] * 3
                                            + [ctypes.POINTER(ctypes.c_int)] * 4)
            lib.rcab_group_plan.restype = ctypes.c_int
            lib.rcab_group_barrier_bytes.argtypes = []
            lib.rcab_group_barrier_bytes.restype = ctypes.c_int
            lib.rcab_group_error_site.argtypes = []
            lib.rcab_group_error_site.restype = ctypes.c_char_p
            lib.rcab_group_error_name.argtypes = [ctypes.c_int]
            lib.rcab_group_error_name.restype = ctypes.c_char_p  # set last: the flag
    return lib


def cuda_error(lib: ctypes.CDLL, entry: str, err: int) -> RuntimeError:
    """The error an entry of the library returned, by its CUDA name and the
    call that returned it (in the calling thread)."""
    name = lib.rcab_group_error_name(err).decode()
    site = lib.rcab_group_error_site().decode()
    return RuntimeError(f"{entry} failed: {name} (cudaError_t {err}) in {site}")


_plans: Dict[tuple, tuple] = {}


def _plan(lib: ctypes.CDLL, n: int, h: int, w: int):
    """(clusters, cluster size, scratch images, clusters an image) of the
    launch for n images of h x w on the current device: the kernel keeps an
    image on chip where it fits, else in scratch for the images in flight
    (at most 16), each over max(1, m / min(n, 16)) of the m clusters the
    card holds. Kept per
    device and shape: the plan's occupancy queries are the same every call
    (the forward entry sets the kernel's attributes in its own thread)."""
    key = (torch.cuda.current_device(), n, h, w)
    plan = _plans.get(key)
    if plan is None:
        out = [ctypes.c_int(0) for _ in range(4)]
        err = lib.rcab_group_plan(n, h, w, *(ctypes.byref(v) for v in out))
        if err != 0:
            raise cuda_error(lib, "rcab_group_plan", err)
        plan = _plans[key] = tuple(v.value for v in out)
    return plan


_barriers: Dict[tuple, torch.Tensor] = {}


def _barrier_counters(lib: ctypes.CDLL, device: torch.device) -> torch.Tensor:
    """The scratch variant's barrier counters for a launch on the current
    stream. They must be zero before their first use and never shared by
    two launches in flight at once; a launch leaves them zero, so one
    buffer a stream serves every launch on it (stream order). A launch
    being captured into a CUDA graph gets its own, zeroed inside the graph
    (a graph replays apart from the stream it was captured on)."""
    stream = torch.cuda.current_stream(device)
    nbytes = lib.rcab_group_barrier_bytes()
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(nbytes, dtype=torch.uint8, device=device)
    key = (device.index, stream.cuda_stream)
    buf = _barriers.get(key)
    if buf is None:
        with _lib_lock:
            buf = _barriers.get(key)
            if buf is None:
                buf = _barriers[key] = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    return buf


def _scratch(n_slots: int, h: int, w: int, c: int, blocks: int, device: torch.device):
    """One allocation for the scratch variant's buffers, in the forward
    entry's order: feat, featb, t1, t2, partial (data pointers, each
    256-byte aligned) and the tensor that owns them."""
    px = n_slots * h * w * c
    sizes = [px * 4, px * 2, px * 2, px * 4, n_slots * blocks * c * 4]
    offsets, total = [], 0
    for nbytes in sizes:
        offsets.append(total)
        total += (nbytes + 255) // 256 * 256
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return [base + o for o in offsets], buf


_WEIGHT_SPECS = {  # name -> (dtype, shape given C, B, Cr)
    "w1": (torch.bfloat16, lambda c, b, r: (b, 3, 3 * c, c)),
    "b1": (torch.float32, lambda c, b, r: (b, c)),
    "a": (torch.float32, lambda c, b, r: (b, c)),
    "w2": (torch.bfloat16, lambda c, b, r: (b, 3, 3 * c, c)),
    "b2": (torch.float32, lambda c, b, r: (b, c)),
    "fc1": (torch.float32, lambda c, b, r: (b, c, r)),
    "fc2": (torch.float32, lambda c, b, r: (b, r, c)),
    "wg": (torch.bfloat16, lambda c, b, r: (3, 3 * c, c)),
    "bg": (torch.float32, lambda c, b, r: (c,)),
}


def _check(x: torch.Tensor, gw: GroupWeights) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_residual_group takes bf16 features, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_residual_group takes a contiguous NHWC tensor, "
                         f"got shape {tuple(x.shape)} contiguous={x.is_contiguous()}")
    n, h, w, c = x.shape
    if min(n, h, w) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    num_blocks = gw["w1"].shape[0]
    cr = gw["fc1"].shape[-1]
    if not 1 <= cr <= c:
        raise ValueError(f"SE width {cr} outside 1..{c}")
    for name, (dtype, shape_fn) in _WEIGHT_SPECS.items():
        t = gw[name]
        want = shape_fn(c, num_blocks, cr)
        if t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(f"group weight {name}: want {dtype} {want}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"group weight {name} must be contiguous on {x.device}")


def group_weight_args(gw: GroupWeights) -> tuple:
    """The ten weight tensors of ``gw`` in the custom op's argument order."""
    return tuple(gw[k] for k in _WEIGHT_SPECS)


def _weights(*tensors: torch.Tensor) -> GroupWeights:
    return dict(zip(_WEIGHT_SPECS, tensors))


_launch_lock = threading.Lock()  # serving threads launch concurrently


@torch.library.custom_op("facesr_torch::rcab_group", mutates_args=(), device_types="cuda")
def rcab_group(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, a: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, fc1: torch.Tensor, fc2: torch.Tensor,
               wg: torch.Tensor, bg: torch.Tensor, res_scale: float) -> torch.Tensor:
    """One residual group on the card: launches the Hopper kernel (counted
    in ``fused_residual_group.launches``) or raises."""
    gw = _weights(w1, b1, a, w2, b2, fc1, fc2, wg, bg)
    _check(x, gw)
    n, h, w, c = x.shape
    if c != KERNEL_CHANNELS:
        raise ValueError(f"the fused_residual_group kernel takes C={KERNEL_CHANNELS}, got C={c}")
    lib = _lib()
    with torch.cuda.device(x.device):
        clusters, cluster_size, scratch_images, per_image = _plan(lib, n, h, w)
        # scratch for the images in flight, not the batch (`owner` keeps it
        # alive past the launch)
        ptrs, bar, owner = [None] * 5, None, None
        if scratch_images:
            ptrs, owner = _scratch(scratch_images, h, w, c, per_image * cluster_size, x.device)
            bar = _barrier_counters(lib, x.device).data_ptr()
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rcab_group_forward(
            x.data_ptr(), out.data_ptr(),
            *(gw[k].data_ptr() for k in _WEIGHT_SPECS),
            *ptrs, bar,  # feat, featb, t1, t2, partial; the barrier counters
            n, h, w, gw["w1"].shape[0], gw["fc1"].shape[-1],
            float(res_scale), clusters, cluster_size, per_image, stream)
    if err != 0:
        raise cuda_error(lib, "rcab_group_forward", err)
    with _launch_lock:
        fused_residual_group.launches += 1
    return out


@rcab_group.register_kernel("cpu")
def _rcab_group_cpu(x, w1, b1, a, w2, b2, fc1, fc2, wg, bg, res_scale):
    gw = _weights(w1, b1, a, w2, b2, fc1, fc2, wg, bg)
    _check(x, gw)
    return rcab_group_reference(x, gw, res_scale)


@rcab_group.register_fake
def _rcab_group_fake(x, w1, b1, a, w2, b2, fc1, fc2, wg, bg, res_scale):
    return torch.empty_like(x)


def fused_residual_group(x: torch.Tensor, gw: GroupWeights,
                         res_scale: float = 0.2) -> torch.Tensor:
    """One residual group over NHWC bf16 features ``x`` [N, H, W, C] with
    weights from `prepare_group_weights`; returns bf16 [N, H, W, C].

    Calls the custom op `rcab_group`. CUDA tensor: launches the Hopper
    kernel (counted in ``fused_residual_group.launches``, exactly under
    concurrent callers) or raises; the kernel takes C=64 only. CPU tensor:
    the plain version, any C, not counted. Forward only: the weights are
    detached and the kernel's output has no graph, so with grad mode on and
    ``x`` requiring grad it raises rather than drop the gradient (the
    training trunk is `blocks.residual_groups`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "fused_residual_group is forward-only and would cut the graph: "
            "call it under torch.no_grad()/inference_mode, or train through "
            "the plain trunk (FaceEnhanceNet.forward(train=True))")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_residual_group runs on cuda or cpu, not {x.device}")
    return rcab_group(x, *group_weight_args(gw), float(res_scale))


fused_residual_group.launches = 0
