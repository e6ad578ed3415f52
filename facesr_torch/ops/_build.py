"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source ``facesr_torch/csrc/<name>.cu`` has a plain C interface and is
compiled for Hopper (``sm_90a``) into ``facesr_torch/_build/`` at first
use — never at import, since CPU-only hosts import every module. The
library's file name carries a hash of the nvcc flags and of every source
it is built from (the ``.cu`` and the ``csrc/`` headers it includes), so
an edit anywhere is rebuilt and a stale build is never loaded. Builds of
several sources run as parallel nvcc processes. The build links the CUDA
runtime only: a kernel that needs a CUDA driver API function (the TMA
tensor-map encoder) fetches it with ``cudaGetDriverEntryPoint``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["load_library", "build_all", "build_logs", "BuildError"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


class BuildError(RuntimeError):
    pass


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise BuildError("nvcc not found (CUDA_HOME unset and no nvcc on PATH)")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every file it includes from ``csrc/`` with
    ``#include "..."``, transitively, in a fixed order."""
    root = CSRC.resolve()
    seen: List[Path] = []
    todo = [root / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            cand = (path.parent / inc.decode()).resolve()
            if cand.is_file() and root in cand.parents:
                todo.append(cand)
    return seen


def _target(name: str) -> Path:
    """The library's path: its name carries a hash of the flags and of every
    source it is built from, so no edit leaves a stale build loadable."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load the named sources, one nvcc process per
    source, all started together. Raises BuildError on any failure."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            target = _target(name)
            if target.exists():
                continue
            # unique temp name, then an atomic rename: concurrent builds
            # (test workers, several processes) never load a half-written file
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, target)
        failed = []
        for name, (proc, tmp, target) in procs.items():
            log, _ = proc.communicate()
            _logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)
        if failed:
            raise BuildError("CUDA build failed:\n" + "\n".join(failed))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return {n: _libs[n] for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all([name])[name]


def build_logs() -> Dict[str, str]:
    """nvcc output (with ``-Xptxas -v`` register/smem/spill lines) of the
    sources this process compiled; empty for a library found prebuilt."""
    return dict(_logs)
