"""The port's host-side C++ helpers, built with g++ and bound with ctypes.

- ``png_unfilter.cpp``: the PNG row filters undone (`png_unfilter`), for
  `facesr_torch.data.png`;
- ``batch_assembler.cpp``: crop + flip + uint8 -> float32 + stack of a
  training batch (`assemble_hr_batch`), for
  `facesr_torch.data.fast_loader`;
- ``jpeg_decode.cpp``: a JPEG's Huffman data into coefficient planes
  (`jpeg_entropy`, one call an image: sequential and progressive scans,
  restart intervals, faults in the data met as libjpeg-turbo meets them),
  the block smoothing of a progressive file cut short (`jpeg_smooth`),
  and the rest of libjpeg-turbo's default decode
  (`jpeg_reconstruct`: the islow IDCT, fancy upsampling, YCbCr -> RGB), for
  `facesr_torch.data.jpeg`. Their plain versions are in ``jpeg_numpy.py``.

Each library is compiled at first use, never at import, into
``facesr_torch/_build/``; its file name carries a hash of the compiler
flags and the source, so an edit is rebuilt and a stale build is never
loaded. The build writes a temporary name and renames it into place, so
parallel processes do not race. A failed build or load raises: there is
no fallback. The numpy versions beside each entry (``*_numpy``) are plain
references for tests, chosen only by name. ctypes releases the GIL for the
length of a call, so loader threads run these in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from facesr_torch.native.jpeg_numpy import (RECONSTRUCT_ERRORS, EntropyError,
                                            jpeg_entropy_numpy, jpeg_reconstruct_numpy,
                                            jpeg_smooth_numpy)

__all__ = ["NativeBuildError", "load", "png_unfilter", "png_unfilter_numpy",
           "assemble_hr_batch", "assemble_hr_batch_numpy", "jpeg_entropy",
           "jpeg_entropy_numpy", "jpeg_smooth", "jpeg_smooth_numpy", "jpeg_reconstruct",
           "jpeg_reconstruct_numpy", "RECONSTRUCT_ERRORS"]

_SRC = Path(__file__).resolve().parent
BUILD_DIR = _SRC.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_I32P = ctypes.POINTER(ctypes.c_int32)
_VP = ctypes.c_void_p
_SIGNATURES = {
    "png_unfilter": {
        "png_unfilter": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                          ctypes.c_int32], ctypes.c_int32),
    },
    "batch_assembler": {
        "assemble_hr_batch": ([ctypes.POINTER(ctypes.c_void_p), _I32P, _I32P, ctypes.c_int32,
                               ctypes.c_int32, _I32P, _I32P, ctypes.POINTER(ctypes.c_uint8),
                               ctypes.POINTER(ctypes.c_float), ctypes.c_int32], None),
    },
    "jpeg_decode": {
        "jpeg_entropy": ([_VP, ctypes.c_int64, _VP, _VP, _VP, ctypes.c_int32, _VP, _VP, _VP,
                          _VP], ctypes.c_int32),
        "jpeg_smooth": ([_VP, _VP, _VP, ctypes.c_int32, ctypes.c_int32, _VP, ctypes.c_int32,
                         _VP], None),
        "jpeg_reconstruct": ([_VP, _VP, _VP, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                              ctypes.c_int32, _VP], ctypes.c_int32),
    },
}


class NativeBuildError(RuntimeError):
    pass


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((_SRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The library of ``native/<name>.cpp``, compiled with g++ on first use.
    Raises `NativeBuildError` if it cannot be built or loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        target = _target(name)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC / f"{name}.cpp")]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise NativeBuildError(f"cannot run g++ to build {name}.cpp: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(f"g++ failed to build {name}.cpp (exit "
                                       f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as e:
            raise NativeBuildError(f"cannot load {target}: {e}") from e
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib


def png_unfilter(data: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Inflated PNG image data (``height`` rows of a filter byte and
    ``rowbytes`` bytes) -> the unfiltered [height, rowbytes] uint8 rows.
    Raises ValueError on a filter type other than 0-4."""
    if len(data) < height * (rowbytes + 1):
        raise ValueError(f"image data holds {len(data)} bytes, want "
                         f"{height * (rowbytes + 1)}")
    src = np.frombuffer(data, np.uint8)
    out = np.empty((height, rowbytes), np.uint8)
    bad = load("png_unfilter").png_unfilter(src.ctypes.data, out.ctypes.data, height,
                                            rowbytes, bpp)
    if bad:
        raise ValueError(f"row {bad - 1} has filter type {src[(bad - 1) * (rowbytes + 1)]}")
    return out


def png_unfilter_numpy(data: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The plain version of `png_unfilter`: numpy, one row at a time (the
    Average and Paeth filters one pixel at a time)."""
    if len(data) < height * (rowbytes + 1):
        raise ValueError(f"image data holds {len(data)} bytes, want "
                         f"{height * (rowbytes + 1)}")
    rows = np.frombuffer(data, np.uint8)[:height * (rowbytes + 1)].reshape(height, rowbytes + 1)
    out = np.zeros((height + 1, rowbytes), np.uint8)  # row 0: the zero row above
    for y in range(height):
        ftype, raw, up = rows[y, 0], rows[y, 1:], out[y]
        cur = out[y + 1]
        if ftype == 0:
            cur[:] = raw
        elif ftype == 1:
            cur[:] = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            cur[:] = raw + up
        elif ftype in (3, 4):
            up16 = up.astype(np.int16)
            a = np.zeros(bpp, np.int16)
            c = np.zeros(bpp, np.int16)
            for x in range(0, rowbytes, bpp):
                b = up16[x:x + bpp]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (raw[x:x + bpp].astype(np.int16) + pred).astype(np.uint8)
                a = cur[x:x + bpp].astype(np.int16)
                c = b
        else:
            raise ValueError(f"row {y} has filter type {ftype}")
    return out[1:]


def _check_batch(images: Sequence[np.ndarray], crop: int, tops, lefts) -> None:
    for i, img in enumerate(images):
        # the native code reads h*w*3 raw bytes: anything else would be an
        # out-of-bounds or garbage read, so both versions check here
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"image {i} must be HWC uint8 RGB, got "
                             f"shape={img.shape} dtype={img.dtype}")
        h, w = img.shape[:2]
        t, l = int(tops[i]), int(lefts[i])
        if t < 0 or l < 0 or t + crop > h or l + crop > w:
            raise ValueError(f"image {i} ({h}x{w}) cannot supply a {crop}px crop at ({t},{l})")


def assemble_hr_batch(images: Sequence[np.ndarray], crop: int, tops: np.ndarray,
                      lefts: np.ndarray, flips: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """Crop + flip + normalise + stack HWC uint8 RGB images -> [N, crop,
    crop, 3] float32 ``x * (1/255)``, in C++ on ``nthreads`` threads (0: one
    a core, at most one an image)."""
    _check_batch(images, crop, tops, lefts)
    lib = load("batch_assembler")
    n = len(images)
    images = [np.ascontiguousarray(img) for img in images]
    ptrs = (ctypes.c_void_p * n)(*[img.ctypes.data for img in images])
    heights = np.asarray([img.shape[0] for img in images], np.int32)
    widths = np.asarray([img.shape[1] for img in images], np.int32)
    tops = np.ascontiguousarray(tops, np.int32)
    lefts = np.ascontiguousarray(lefts, np.int32)
    flips = np.ascontiguousarray(flips, np.uint8)
    out = np.empty((n, crop, crop, 3), np.float32)
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, n)
    lib.assemble_hr_batch(ptrs, heights.ctypes.data_as(_I32P), widths.ctypes.data_as(_I32P),
                          n, crop, tops.ctypes.data_as(_I32P), lefts.ctypes.data_as(_I32P),
                          flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nthreads)
    return out


def assemble_hr_batch_numpy(images: Sequence[np.ndarray], crop: int, tops: np.ndarray,
                            lefts: np.ndarray, flips: np.ndarray) -> np.ndarray:
    """The plain version of `assemble_hr_batch` (the same ``x * (1/255)``
    in f32)."""
    _check_batch(images, crop, tops, lefts)
    out = np.empty((len(images), crop, crop, 3), np.float32)
    for i, img in enumerate(images):
        t, l = int(tops[i]), int(lefts[i])
        patch = img[t:t + crop, l:l + crop]
        if flips[i]:
            patch = patch[:, ::-1]
        out[i] = patch.astype(np.float32) * np.float32(1.0 / 255.0)
    return out


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def jpeg_entropy(data: bytes, frame: np.ndarray, comps: np.ndarray, scans: np.ndarray,
                 huff: np.ndarray, rows: np.ndarray = None) -> np.ndarray:
    """Every scan's Huffman-coded data -> int16 [sum(bw * bh), 64]
    coefficient planes, in C++ (the plan's layout: `jpeg_numpy`). Raises
    `jpeg_numpy.EntropyError` for a bad Huffman table. ``rows`` (int32
    [nscans]), when given, gets each scan's last iMCU row begun with data
    left."""
    comps, scans, frame = _i32(comps), _i32(scans), _i32(frame)
    huff = np.ascontiguousarray(huff, np.uint8)
    src = np.frombuffer(data, np.uint8)
    total = int((comps[:, 2].astype(np.int64) * comps[:, 3]).sum())
    out = np.zeros((total, 64), np.int16)
    where = np.zeros(2, np.int32)
    last = np.zeros(len(scans), np.int32)
    code = load("jpeg_decode").jpeg_entropy(
        src.ctypes.data, len(data), frame.ctypes.data, comps.ctypes.data, scans.ctypes.data,
        len(scans), huff.ctypes.data, out.ctypes.data, where.ctypes.data, last.ctypes.data)
    if code:
        raise EntropyError(int(code), int(where[0]), int(where[1]))
    if rows is not None:
        rows[:] = last
    return out


def jpeg_smooth(coef: np.ndarray, comps: np.ndarray, qts: np.ndarray, imcu_rows: int,
                latch: np.ndarray, last_good: int) -> np.ndarray:
    """libjpeg's block smoothing of a progressive file's coefficient planes,
    in C++ (see `jpeg_numpy.jpeg_smooth_numpy`): a smoothed copy."""
    coef, comps, qts, latch = (np.ascontiguousarray(coef, np.int16), _i32(comps), _i32(qts),
                               _i32(latch))
    out = coef.copy()
    load("jpeg_decode").jpeg_smooth(coef.ctypes.data, comps.ctypes.data, qts.ctypes.data,
                                    len(comps), imcu_rows, latch.ctypes.data, last_good,
                                    out.ctypes.data)
    return out


def jpeg_reconstruct(coef: np.ndarray, comps: np.ndarray, qts: np.ndarray, width: int,
                     height: int, color: int) -> np.ndarray:
    """Coefficient planes -> [height, width, 3] RGB uint8, in C++ (see
    `jpeg_numpy.jpeg_reconstruct_numpy`). Raises ValueError(code), a
    `RECONSTRUCT_ERRORS` code."""
    coef = np.ascontiguousarray(coef, np.int16)
    comps, qts = _i32(comps), _i32(qts)
    out = np.empty((height, width, 3), np.uint8)
    code = load("jpeg_decode").jpeg_reconstruct(
        coef.ctypes.data, comps.ctypes.data, qts.ctypes.data, len(comps), width, height,
        color, out.ctypes.data)
    if code:
        raise ValueError(int(code))
    return out
