"""HTTP serving API of the port: `app/api.py` on one card.

Standard-library ``http.server`` with threads, HTTP/1.1 keep-alive.

Endpoints:
  GET  /health            -> {"status": "ok", "models": [...], "device": "cuda"|"cpu"}
                             (+ "batching": per-model {"calls", "images"} when
                             micro-batching)
  GET  /models            -> model names + configs
  POST /super-resolve     -> body: PNG image bytes. Query: ?model=<name>
                             (default: the first loaded). Response: PNG bytes
                             of the SR image. An input of at most 128 px is
                             LR (resized to 64 with INTER_AREA); a larger one
                             is centre-cropped, resized to 256 and a 64 px LR
                             synthesised (`app.demo.prepare_inputs`).

Usage:
  python -m facesr_torch.app.api --checkpoint-dir checkpoints --port 8000 --dtype bf16
  curl -X POST --data-binary @face.png localhost:8000/super-resolve > sr.png

``--dtype bf16`` serves every model through `Predictor` (the group-kernel
trunk: 6 kernel launches a forward of the production 6x10x64 model);
without it (or with ``f32``) the raw f32 forward. ``--dtype int8`` serves
per-channel int8 weights dequantized to bf16 (the kernel trunk too);
``--dtype int8_full`` s8 convs with static activation scales calibrated
on ``--calib-dir`` images or read from the per-model quant cache
``<--quant-cache>.<model name>.fckpt`` (`cli.export_quantized`), else
per-image dynamic scales. A cache calibrated from other weights is refused
at startup. ``--batch-window-ms``
coalesces concurrent requests into one forward of up to ``--max-batch``
images (`MicroBatcher`). Each cohort runs at its true size: eager PyTorch
compiles nothing per batch size, so the JAX server's power-of-two padding
ladder has no work to do. ``--exported`` serves ``.pt2`` artifacts
(`cli.export_serving`) under their file stems. It runs on CUDA unless
``--device cpu`` is given. ``--compile-cache`` is accepted and caches
nothing: the port compiles no programs, and its one CUDA build is kept in
``facesr_torch/_build/`` across restarts already.

Not ported: JPEG bodies (400, ROADMAP A.7.2).
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from facesr_torch.device import DeviceLike, resolve_device

__all__ = ["SRService", "make_handler", "serve", "main"]

_JPEG_MAGIC = b"\xff\xd8\xff"
PNG_LEVEL = 1  # zlib level of the response PNGs (cv2.imencode's default)


class SRService:
    """Loads models once; thread-safe inference."""

    def __init__(self, checkpoint_dir: str, dtype: Optional[str] = None,
                 calib_dir: Optional[str] = None, quant_cache: Optional[str] = None,
                 batch_window_ms: float = 0.0, max_batch: int = 0,
                 exported: Optional[str] = None, device: DeviceLike = None):
        """dtype: None/'f32' raw f32 forwards; 'bf16', 'int8' and
        'int8_full' through `Predictor` (`app.demo.wrap_predictors`, with
        ``calib_dir`` and the per-model ``quant_cache`` for int8_full).
        batch_window_ms > 0
        coalesces concurrent requests into one forward (`MicroBatcher`) of
        up to ``max_batch`` images (0 = 4). exported: comma-separated
        ``.pt2`` artifacts served under their file stems; with only
        artifacts, ``checkpoint_dir`` may be absent."""
        from facesr_torch.app.demo import load_servables, wrap_predictors
        from facesr_torch.parallel.serving import MicroBatcher

        self.device = resolve_device(device)
        # loud at load: the spatial size this server feeds, and a symbolic
        # batch when cohorts of any size arrive
        self.models, self.exported = load_servables(
            checkpoint_dir, dtype, calib_dir, quant_cache, exported, self.device,
            require_symbolic_batch=batch_window_ms > 0)
        if not self.models and not self.exported:
            raise RuntimeError(f"No checkpoints found in {checkpoint_dir}")
        self.default = next(iter({**self.models, **self.exported}))
        mb = (max_batch or 4) if batch_window_ms > 0 else 0
        self.predictors = {}
        if dtype and dtype != "f32":
            self.predictors = wrap_predictors(self.models, dtype, calib_dir, quant_cache,
                                              max_batch=max(1, max_batch, mb))
        self.batchers = {}
        if batch_window_ms > 0:
            servables = {**self.models, **self.exported, **self.predictors}
            self.batchers = {name: MicroBatcher(lambda b, _m=m: self._forward(_m, b),
                                                max_batch=mb, window_ms=batch_window_ms)
                             for name, m in servables.items()}

    @staticmethod
    def _forward(servable, batch: np.ndarray) -> np.ndarray:
        from facesr_torch.app.demo import serve_batch

        return np.clip(serve_batch(servable, batch), 0, 1)

    def model_info(self) -> dict:
        from facesr_torch.ckpt.export import input_shape

        out = {}
        for name, m in self.models.items():
            info = asdict(m.config)
            info["model_class"] = type(m).__name__
            out[name] = info
        for name, fn in self.exported.items():
            out[name] = {"model_class": "ExportedArtifact",
                         "input_shape": str(input_shape(fn.exported)),
                         "device": str(fn.device)}
        return out

    def super_resolve(self, image_bytes: bytes, model_name: Optional[str] = None) -> bytes:
        """PNG bytes in, the SR image's PNG bytes out. ValueError for a body
        that is not a PNG the port reads, KeyError for an unknown model."""
        from facesr_torch.app.demo import prepare_inputs
        from facesr_torch.data.png import PNGError, decode_rgb, encode

        name = model_name or self.default
        if name not in self.models and name not in self.exported:
            raise KeyError(f"unknown model {name!r}; available: "
                           f"{list(self.models) + list(self.exported)}")
        if image_bytes.startswith(_JPEG_MAGIC):
            raise ValueError("could not decode image: JPEG bodies are not decoded by the "
                             "port yet (ROADMAP A.7.2); POST a PNG")
        try:
            rgb = decode_rgb(image_bytes, "request body")
        except PNGError as e:
            raise ValueError(f"could not decode image: {e}") from e
        lr, _ = prepare_inputs(rgb)
        if name in self.batchers:
            sr = self.batchers[name](lr)
        else:
            servable = self.predictors.get(name, self.models.get(name, self.exported.get(name)))
            sr = self._forward(servable, lr[None])[0]
        return encode((sr * 255).round().astype(np.uint8), level=PNG_LEVEL)

    def close(self) -> None:
        for b in self.batchers.values():
            b.close()


def make_handler(service: SRService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every response carries an exact
        # Content-Length; HTTP/1.0 would close the connection per request
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj, close: bool = False) -> None:
            # close=True: the request body was never drained (wrong path /
            # missing length), so the next keep-alive request on this
            # connection would be parsed out of the leftover bytes
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if close:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                path = urlparse(self.path).path
                if path == "/health":
                    info = {"status": "ok",
                            "models": list(service.models) + list(service.exported),
                            "device": service.device.type}
                    if service.batchers:
                        info["batching"] = {name: {"calls": b.calls, "images": b.images}
                                            for name, b in service.batchers.items()}
                    self._json(200, info)
                elif path == "/models":
                    self._json(200, service.model_info())
                else:
                    self._json(404, {"error": f"unknown path {path}"})
            except Exception as e:  # noqa: BLE001 — always answer the request
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            path = urlparse(self.path).path
            if path != "/super-resolve":
                self._json(404, {"error": f"unknown path {path}"}, close=True)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._json(400, {"error": "empty body; POST image bytes"}, close=True)
                    return
                body = self.rfile.read(length)
                model = parse_qs(urlparse(self.path).query).get("model", [None])[0]
                png = service.super_resolve(body, model)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)
            except (KeyError, ValueError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — always answer the request
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(checkpoint_dir: str, port: int = 8000, host: str = "0.0.0.0",
          dtype: Optional[str] = None, calib_dir: Optional[str] = None,
          quant_cache: Optional[str] = None, batch_window_ms: float = 0.0,
          max_batch: int = 0, exported: Optional[str] = None,
          device: DeviceLike = None) -> ThreadingHTTPServer:
    """A bound, not yet serving HTTP server (call ``serve_forever``);
    ``server.service`` is its `SRService` (``close()`` stops its batchers)."""
    service = SRService(checkpoint_dir, dtype=dtype, calib_dir=calib_dir,
                        quant_cache=quant_cache, batch_window_ms=batch_window_ms,
                        max_batch=max_batch, exported=exported, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.service = service
    print(f"facesr_torch API serving {list(service.models) + list(service.exported)} "
          f"on {host}:{server.server_address[1]} ({service.device})")
    return server


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Face SR HTTP API (PyTorch port)")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when omitted (raises without a card)")
    parser.add_argument("--dtype", type=str, default=None,
                        choices=["f32", "bf16", "int8", "int8_full"],
                        help="serving precision: bf16 runs the group-kernel trunk; int8 = "
                             "int8 weights (bf16 compute), int8_full = s8 convs")
    parser.add_argument("--calib-dir", type=str, default=None,
                        help="representative LR images for int8_full's static "
                             "activation-scale calibration")
    parser.add_argument("--quant-cache", type=str, default=None,
                        help="path prefix of the calibrated int8 caches (per model) so "
                             "restarts skip calibration")
    parser.add_argument("--batch-window-ms", type=float, default=0.0,
                        help="coalesce concurrent requests arriving within this window "
                             "into one forward; 0 = one forward per request")
    parser.add_argument("--max-batch", type=int, default=0,
                        help="micro-batch size cap (0 = 4)")
    parser.add_argument("--exported", type=str, default=None,
                        help="comma-separated .pt2 artifacts "
                             "(python -m facesr_torch.cli.export_serving) served under "
                             "their file stems; no checkpoints needed")
    parser.add_argument("--compile-cache", type=str, default=None,
                        help="accepted for the JAX server's flag; the port compiles no "
                             "programs, and its CUDA build stays in facesr_torch/_build/")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.compile_cache:
        print("--compile-cache: nothing to cache (the port compiles no programs; the "
              "kernel build is kept in facesr_torch/_build/)")
    server = serve(args.checkpoint_dir, args.port, args.host, dtype=args.dtype,
                   calib_dir=args.calib_dir, quant_cache=args.quant_cache,
                   batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
                   exported=args.exported, device=args.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nShutting down.")
    finally:
        server.server_close()
        server.service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
