"""Ahead-of-time serving export with `torch.export` (``.pt2`` files).

Port of `facesr/ckpt/export.py`. The serving forward of a model of any
family (FaceEnhanceNet, the transfer model, RRDBNet) at any serving dtype
(f32, bf16, weight-only ``int8``, ``int8_full`` with dynamic or calibrated
scales) is traced into one `torch.export.ExportedProgram` with its
weights and saved as a ``.pt2`` file: a server loads it with
`load_exported` and needs no checkpoint. The dtype dispatch is
`parallel.serving.build_serving_fn`'s, so an artifact cannot drift from
live serving.

- The batch dimension is exported symbolically by default (a
  `torch.export.Dim`), so one artifact serves every batch size; an int
  pins it.
- bf16 keeps each residual group the group kernel takes (C = 64, k = 3)
  as one node of the custom op ``facesr_torch::rcab_group``: six in
  FaceEnhanceNet's trunk (B = 10), one in the transfer head (B = 4). Its
  kernel-layout weights are buffers of the module, prepared once (a
  model's own cache is keyed on ``data_ptr``/``_version``, which a trace
  cannot follow). The loaded program launches the Hopper kernel on a
  card and runs the plain version on the CPU.
- The int8 modes hold the sites as int8 buffers, and the served model
  is a copy without the float kernels of those sites, so an int8
  artifact is about a quarter of the float one. ``int8_full`` holds each
  site's im2col GEMM matrix (its OIHW kernel is a view of it), scale and
  static ``a``, and for a calibrated subpixel conv_last the packed
  matrix too: the tensors `ops.quant.Int8Weight` derives on first use,
  precomputed. Weight-only ``int8`` keeps the dequant inside the graph,
  as the JAX artifact keeps ``dequantize_pytree``: the int8 rows of all
  sites with one row length (I*kh*kw) are one buffer, dequantized to
  bf16 by one multiply a forward, and the kernel-layout weights of the
  trunk or head are prepared in the graph from them, so the group kernel
  nodes stay (six and one). Calibration (``calibration`` images or a
  ``quant_cache``) happens once, at build time, with
  ``require_calibration``: a named but missing cache without images
  raises, as in JAX.
- Each int8 conv is one node of the custom op ``facesr_torch::int8_conv``
  (`ops.conv`), whose im2col is chunked under `ops.conv.INT8_CHUNK_BYTES`
  at the batch it is called with: the chunking is no control flow of the
  graph, so an int8 artifact keeps a symbolic batch, and it runs the live
  forward's code, bitwise.

Where the JAX package lists target platforms, a ``.pt2`` holds tensors on
the device it was traced on, and `load_exported` moves it to the device
it serves on. Load only artifacts you made or trust.
"""

from __future__ import annotations

import copy
import io
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from facesr_torch.device import DeviceLike, resolve_device
from facesr_torch.ops.conv import full_f32, int8_gemm_pads, int8_site_of_gemm
from facesr_torch.ops.quant import Int8Weight, is_int8_kernel
from facesr_torch.parallel.serving import ServingDtype, build_serving_fn as _serving_fn

__all__ = ["ServingModule", "build_serving_fn", "export_serving", "export_built",
           "input_shape", "custom_op_nodes", "load_exported", "load_exported_many",
           "MAX_EXPORT_BATCH"]

MAX_EXPORT_BATCH = 4096  # the symbolic batch's upper bound


def _without(model: nn.Module, names) -> nn.Module:
    """A copy of ``model`` whose convs at ``names`` hold no weight (the
    int8 sites: the artifact carries them as int8 buffers)."""
    served = copy.deepcopy(model).eval()
    if hasattr(served, "_kernel_weights"):
        served._kernel_weights = None
    for name in names:
        served.get_submodule(name).register_parameter("weight", None)
    return served


class ServingModule(nn.Module):
    """The serving forward of a model at ``dtype`` as a module
    `torch.export` traces: ``forward(x) -> clip(SR(x), 0, 1)``. The dtype
    dispatch, and for ``int8_full`` the calibration, are
    `parallel.serving.build_serving_fn`'s (``calibration``,
    ``quant_cache``, ``max_batch``, ``require_calibration``)."""

    def __init__(self, model: nn.Module, dtype: ServingDtype = torch.bfloat16,
                 calibration: Optional[np.ndarray] = None, quant_cache: Optional[str] = None,
                 max_batch: int = 8, require_calibration: bool = False):
        super().__init__()
        live = _serving_fn(model.eval(), dtype, calibration=calibration,
                           quant_cache=quant_cache, max_batch=max_batch,
                           require_calibration=require_calibration)
        self.dtype = dtype
        self.compute_dtype = None if dtype in (None, torch.float32) else torch.bfloat16
        self._groups = []  # kernel groups: [{weight key: buffer name}]
        self._sites = {}   # int8_full: site -> its buffer names and shapes
        self._rows = {}    # int8: row length -> [(site, first row, OIHW shape)]
        # the residual groups the model runs on the group kernel (models
        # without any have no kernel_groups)
        groups = (model.kernel_groups() if dtype in (torch.bfloat16, "int8")
                  and hasattr(model, "kernel_groups") else [])
        self.kernel = bool(groups)
        if dtype in ("int8", "int8_full"):
            self.model = _without(model, live.sites)
            if dtype == "int8":
                self._register_rows(live.sites)
            else:
                self._register_sites(live.sites, getattr(model, "subpixel_site", None))
        else:
            self.model = model
            for gw in groups:
                self._register_group(gw)

    # -- buffers ------------------------------------------------------------
    def _register_group(self, gw) -> None:
        g = len(self._groups)
        self._groups.append({})
        for k, t in gw.items():
            self.register_buffer(f"group{g}_{k}", t.clone())
            self._groups[g][k] = f"group{g}_{k}"

    def _register_sites(self, sites: Dict[str, Int8Weight], subpixel: Optional[str]) -> None:
        for j, (name, w) in enumerate(sites.items()):
            entry = {"shape": tuple(w.q.shape), "gemm": f"site{j}_gemm",
                     "scale": f"site{j}_scale", "a": None, "packed": None}
            self.register_buffer(entry["gemm"], w.gemm_weight(*int8_gemm_pads(w.q.shape)).clone())
            self.register_buffer(entry["scale"], w.scale.clone())
            if w.a is not None:
                entry["a"] = f"site{j}_a"
                self.register_buffer(entry["a"], w.a.clone())
            if name == subpixel and is_int8_kernel(w) and w.q.shape[-2:] == (3, 3):
                pw = w.subpixel_packed()
                entry["packed"] = (tuple(pw.q.shape), f"site{j}_packed_gemm",
                                   f"site{j}_packed_scale")
                self.register_buffer(entry["packed"][1],
                                     pw.gemm_weight(*int8_gemm_pads(pw.q.shape)).clone())
                self.register_buffer(entry["packed"][2], pw.scale.clone())
            self._sites[name] = entry

    def _register_rows(self, sites: Dict[str, Int8Weight]) -> None:
        rows: Dict[int, list] = {}
        for name, w in sites.items():
            rows.setdefault(w.q[0].numel(), []).append((name, w))
        for length, group in rows.items():
            self.register_buffer(f"int8_rows{length}",
                                 torch.cat([w.q.reshape(w.q.shape[0], -1) for _, w in group]))
            self.register_buffer(f"int8_scale{length}", torch.cat([w.scale for _, w in group]))
            first, self._rows[length] = 0, []
            for name, w in group:
                self._rows[length].append((name, first, tuple(w.q.shape)))
                first += w.q.shape[0]

    # -- the forward's pieces -----------------------------------------------
    def _int8_sites(self) -> Dict[str, Int8Weight]:
        """The int8_full sites over the buffers, their derived tensors
        memoized from buffers too (the OIHW kernel a view of the GEMM
        matrix)."""
        def site(shape, gemm_name, scale_name, a):
            return int8_site_of_gemm(self.get_buffer(gemm_name), self.get_buffer(scale_name), a,
                                     list(shape))

        out = {}
        for name, e in self._sites.items():
            a = None if e["a"] is None else self.get_buffer(e["a"])
            out[name] = site(e["shape"], e["gemm"], e["scale"], a)
            if e["packed"] is not None:
                out[name]._memo["packed"] = site(*e["packed"], a)
        return out

    def _dequantized(self) -> Dict[str, torch.Tensor]:
        """Weight-only int8: each site's bf16 kernel, dequantized in the
        graph (``q.f32 * scale`` per output channel, then bf16: bitwise
        `ops.quant.dequantize_pytree`)."""
        out = {}
        for length, entries in self._rows.items():
            deq = (self.get_buffer(f"int8_rows{length}").float()
                   * self.get_buffer(f"int8_scale{length}")[:, None]).to(torch.bfloat16)
            for name, first, shape in entries:
                out[name] = deq[first:first + shape[0]].reshape(shape)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        quant, groups = None, None
        if self.dtype == "int8_full":
            quant = self._int8_sites()
        elif self.dtype == "int8":
            quant = self._dequantized()
            if self.kernel:
                groups = self.model.kernel_groups(quant)
        elif self.kernel:
            groups = [{k: self.get_buffer(b) for k, b in names.items()}
                      for names in self._groups]
        kw = {} if groups is None else self.model.kernel_forward(groups)
        out = self.model(x, train=False, dtype=self.compute_dtype, quant=quant, **kw)
        return out.clamp(0.0, 1.0)


def build_serving_fn(model: nn.Module, dtype: ServingDtype = torch.bfloat16,
                     calibration: Optional[np.ndarray] = None,
                     quant_cache: Optional[str] = None, max_batch: int = 8) -> ServingModule:
    """The serving forward of ``model`` at ``dtype`` as a `ServingModule`
    (JAX: ``(fn, params)``; a torch module holds its weights), through
    `parallel.serving.build_serving_fn` with ``require_calibration=True``:
    a named but missing ``quant_cache`` without ``calibration`` raises
    (an offline export must not change precision silently)."""
    return ServingModule(model, dtype, calibration=calibration, quant_cache=quant_cache,
                         max_batch=max_batch, require_calibration=True)


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
                   batch: Optional[int] = None, input_size: int = 64,
                   calibration: Optional[np.ndarray] = None,
                   quant_cache: Optional[str] = None) -> bytes:
    """The ``.pt2`` bytes of ``model``'s serving forward at ``dtype``,
    traced on the model's device (see `build_serving_fn`, `export_built`)."""
    module = build_serving_fn(model, dtype, calibration=calibration, quant_cache=quant_cache,
                              max_batch=batch or 8)
    return export_built(module, batch=batch, input_size=input_size)


def input_shape(program: torch.export.ExportedProgram) -> tuple:
    """The image input's shape; a symbolic dim is a `torch.SymInt`."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == name)
    return tuple(node.meta["val"].shape)


def custom_op_nodes(program: torch.export.ExportedProgram,
                    op: str = "rcab_group") -> int:
    """How many calls of the custom op ``facesr_torch::<op>`` the program's
    graph holds (``rcab_group``: one a residual group on the kernel;
    ``int8_conv``: one an int8_full conv site)."""
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function" and f"facesr_torch.{op}." in str(n.target))


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

    import facesr_torch.ops.rcab_group  # noqa: F401 — registers the custom ops the graph calls

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
