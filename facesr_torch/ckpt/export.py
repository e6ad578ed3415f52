"""Ahead-of-time serving export with `torch.export` (``.pt2`` files).

Port of `facesr/ckpt/export.py`. The serving forward of a model
(``clip(model(x, train=False, dtype), 0, 1)``) with its weights is traced
into one `torch.export.ExportedProgram` and saved as a ``.pt2`` file: a
server loads it with `load_exported` and needs no checkpoint. The batch
dimension is exported symbolically by default (a `torch.export.Dim`), so
one artifact serves every batch size; an int pins it. In bf16 a config
the group kernel takes (C = 64, k = 3) keeps each residual group as one
node of the custom op ``facesr_torch::rcab_group``: the loaded program
launches the Hopper kernel on a card and runs the plain version on the
CPU. f32 and bf16 are exported; the int8 modes raise (their `.pt2`
variants are ROADMAP A.10.1).

Where the JAX package lists target platforms, a ``.pt2`` holds tensors on
the device it was traced on, and `load_exported` moves it to the device
it serves on. Load only artifacts you made or trust.
"""

from __future__ import annotations

import io
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.ops.conv import full_f32
from facesr_torch.ops.rcab_group import fused_residual_group
from facesr_torch.parallel.serving import ServingDtype, build_serving_fn as _check_dtype

__all__ = ["ServingModule", "build_serving_fn", "export_serving", "export_built",
           "input_shape", "load_exported", "load_exported_many", "MAX_EXPORT_BATCH"]

MAX_EXPORT_BATCH = 4096  # the symbolic batch's upper bound
INT8_EXPORT_NOT_PORTED = ("the int8 .pt2 export (dtype int8/int8_full, --calib-dir, "
                          "--quant-cache) is not ported yet (ROADMAP A.10.1: int8 .pt2 "
                          "export); serve int8 through Predictor or the API")


ZOO_EXPORT_NOT_PORTED = ("the .pt2 export of the model zoo (transfer, esrgan) is not ported "
                         "yet (ROADMAP A.12.1: int8 and .pt2 of the zoo); serve it through "
                         "Predictor or the API")


class ServingModule(nn.Module):
    """The serving forward of a FaceEnhanceNet as a module `torch.export`
    traces. The kernel trunk reads each group's kernel-layout weights from
    buffers of this module, prepared once here: the model's own cache of
    them is keyed on ``data_ptr``/``_version``, which a trace cannot
    follow."""

    def __init__(self, model: nn.Module, dtype: ServingDtype = torch.bfloat16):
        super().__init__()
        if getattr(model, "model_type", "custom") not in ("custom", "lite"):
            raise NotImplementedError(ZOO_EXPORT_NOT_PORTED)
        if dtype in ("int8", "int8_full"):
            raise NotImplementedError(INT8_EXPORT_NOT_PORTED)
        _check_dtype(model, dtype)  # the serving dtype dispatch
        self.model = model.eval()
        self.dtype = dtype
        self.kernel_trunk = dtype == torch.bfloat16 and model.kernel_trunk
        self._names = []
        if self.kernel_trunk:
            for g, gw in enumerate(model.kernel_group_weights()):
                self._names.append({})
                for k, t in gw.items():
                    self.register_buffer(f"group{g}_{k}", t.clone())
                    self._names[g][k] = f"group{g}_{k}"

    def _trunk(self, groups, feat: torch.Tensor) -> torch.Tensor:
        # a copy, not .contiguous(): a trace drops .contiguous() where the
        # example was contiguous, and at another batch (N=1) the conv
        # before the trunk may return other strides
        feat = feat.clone(memory_format=torch.contiguous_format)
        for names in self._names:
            gw = {k: getattr(self, name) for k, name in names.items()}
            feat = fused_residual_group(feat, gw, self.model.config.res_scale)
        return feat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.model(x, train=False, dtype=self.dtype,
                         trunk_fn=self._trunk if self.kernel_trunk else None)
        return out.clamp(0.0, 1.0)


def build_serving_fn(model: nn.Module, dtype: ServingDtype = torch.bfloat16) -> ServingModule:
    """The serving forward of ``model`` at ``dtype`` as a `ServingModule`
    (JAX: ``(fn, params)``; a torch module holds its weights). The dtype
    dispatch is `parallel.serving.build_serving_fn`'s, so an artifact
    cannot drift from live serving."""
    return ServingModule(model, dtype)


def export_built(module: nn.Module, batch: Optional[int] = None,
                 input_size: int = 64) -> bytes:
    """Trace a built serving module (`build_serving_fn`) on its device
    with an NHWC float32 input of ``input_size``² and return the ``.pt2``
    bytes. ``batch=None`` exports a symbolic batch (1 to
    `MAX_EXPORT_BATCH`); an int pins it."""
    device = next(module.parameters()).device
    x = torch.rand((batch or 2, input_size, input_size, 3), device=device)
    dynamic = None
    if batch is None:
        dynamic = {"x": {0: torch.export.Dim("batch", min=1, max=MAX_EXPORT_BATCH)}}
    with torch.no_grad():
        program = torch.export.export(module, (x,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_serving(model: nn.Module, dtype: ServingDtype = torch.bfloat16,
                   batch: Optional[int] = None, input_size: int = 64) -> bytes:
    """The ``.pt2`` bytes of ``model``'s serving forward at ``dtype``,
    traced on the model's device (see `export_built`)."""
    return export_built(build_serving_fn(model, dtype), batch=batch, input_size=input_size)


def input_shape(program: torch.export.ExportedProgram) -> tuple:
    """The image input's shape; a symbolic dim is a `torch.SymInt`."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == name)
    return tuple(node.meta["val"].shape)


def load_exported(path_or_bytes, device: DeviceLike = None):
    """An exported artifact (a ``.pt2`` path or its bytes) as a callable
    ``f(x) -> sr`` on ``device`` (CUDA unless named): ``x`` an NHWC float
    batch (numpy or tensor), the result float32 numpy, run under
    inference mode with TF32 off (the f32 path's precision, as live
    serving). Concurrent callers (server threads) run the program one at a
    time: the module `torch.export` unlifts is not documented as safe to
    call from several threads, and one card runs one forward at a time
    anyway. ``f.exported`` is the `torch.export.ExportedProgram`."""
    from torch.export.passes import move_to_device_pass

    import facesr_torch.ops.rcab_group  # noqa: F401 — registers the custom op the graph calls

    dev = resolve_device(device)
    blob = path_or_bytes
    if not isinstance(blob, (bytes, bytearray)):
        blob = Path(path_or_bytes).read_bytes()
    program = torch.export.load(io.BytesIO(bytes(blob)))
    program = move_to_device_pass(program, dev)
    module = program.module()
    lock = threading.Lock()

    def call(x) -> np.ndarray:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        x = x.float().to(dev)
        with lock, torch.inference_mode(), full_f32():
            return module(x).float().cpu().numpy()

    call.exported = program
    call.device = dev
    return call


def load_exported_many(spec: str, spatial: Optional[int] = None,
                       require_symbolic_batch: bool = False,
                       device: DeviceLike = None) -> dict:
    """Load a comma-separated list of artifact paths, keyed by file stem —
    the parser behind ``api --exported`` and ``demo --exported``. Loud at
    load time: an artifact whose spatial size is not ``spatial``, one with
    a pinned batch where ``require_symbolic_batch`` (or pinned to other
    than 1 anywhere: servers feed variable batches), and duplicate stems
    raise ValueError."""
    out = {}
    for path in [p.strip() for p in spec.split(",") if p.strip()]:
        fn = load_exported(path, device=device)
        b, h, w = input_shape(fn.exported)[:3]
        if spatial is not None and (h, w) != (spatial, spatial):
            raise ValueError(f"{path}: artifact expects {h}x{w} inputs but this server "
                             f"feeds {spatial}x{spatial} LR images — re-export with "
                             f"--input-size {spatial}")
        if isinstance(b, int) and (require_symbolic_batch or b != 1):
            raise ValueError(f"{path}: artifact batch dimension is pinned to {b} but this "
                             "server feeds variable batches — re-export without --batch "
                             "(symbolic batch)")
        stem = Path(path).stem
        if stem in out:
            raise ValueError(f"duplicate artifact name {stem!r} ({path}) — artifacts are "
                             "keyed by filename stem; rename one")
        out[stem] = fn
    return out
