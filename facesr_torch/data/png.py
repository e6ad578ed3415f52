"""PNG read and write with zlib and numpy (the card's machine has no cv2
and no PIL).

`read_rgb` returns what the JAX package's ``cv2.imread`` + ``BGR2RGB``
returns for the same file: HWC RGB uint8, grey replicated to three
channels, alpha dropped (``IMREAD_COLOR``). It takes non-interlaced 8-bit
grey, grey + alpha, RGB and RGBA PNGs with any of the five row filters;
the filters are undone in C++ (`facesr_torch.native.png_unfilter`).
Interlaced, 16-bit and palette PNGs, and JPEG or BMP files, raise with the
file name. Every chunk's CRC is checked.

`encode` / `write_png` write 8-bit grey, grey + alpha, RGB or RGBA, one filter type for
every row (0-4), at a zlib level.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Callable, Union

import numpy as np

from facesr_torch import native

__all__ = ["PNGError", "read_rgb", "decode", "decode_rgb", "encode", "write_png"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type written

PathLike = Union[str, Path]


class PNGError(IOError):
    pass


def decode(data: bytes, name: str = "<png>", unfilter: Callable = native.png_unfilter
           ) -> np.ndarray:
    """The pixels of a PNG file's bytes: [H, W, C] uint8 with C the file's
    channel count (1 grey, 2 grey + alpha, 3 RGB, 4 RGBA). ``unfilter`` is
    `native.png_unfilter` or its plain numpy version."""
    if not data.startswith(SIGNATURE):
        raise PNGError(f"{name}: not a PNG file (JPEG, BMP and other formats are "
                       "not read by the port)")
    pos, header, idat = len(SIGNATURE), None, []
    while True:
        if pos + 8 > len(data):
            raise PNGError(f"{name}: truncated (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError(f"{name}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise PNGError(f"{name}: CRC mismatch in the {kind.decode('latin-1')} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif header is not None and header[3] == 3:
            raise PNGError(f"{name}: palette PNGs are not read by the port")
        elif not (kind[0] & 0x20) and kind != b"PLTE":  # an unknown critical chunk
            raise PNGError(f"{name}: unsupported critical chunk {kind!r}")
    if header is None or not idat:
        raise PNGError(f"{name}: no IHDR or no IDAT chunk")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype == 3:
        raise PNGError(f"{name}: palette PNGs are not read by the port")
    if ctype not in _CHANNELS:
        raise PNGError(f"{name}: bad colour type {ctype}")
    if depth != 8:
        raise PNGError(f"{name}: {depth}-bit PNGs are not read by the port (8-bit only)")
    if interlace:
        raise PNGError(f"{name}: interlaced PNGs are not read by the port")
    if comp != 0 or filt != 0 or width == 0 or height == 0:
        raise PNGError(f"{name}: bad IHDR {header}")
    channels = _CHANNELS[ctype]
    rowbytes = width * channels
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{name}: corrupt image data ({e})") from e
    if len(raw) != height * (rowbytes + 1):
        raise PNGError(f"{name}: image data holds {len(raw)} bytes, want "
                       f"{height * (rowbytes + 1)}")
    try:
        rows = unfilter(raw, height, rowbytes, channels)
    except ValueError as e:
        raise PNGError(f"{name}: {e}") from e
    return rows.reshape(height, width, channels)


def read_rgb(path: PathLike, unfilter: Callable = native.png_unfilter) -> np.ndarray:
    """The image at ``path`` as HWC RGB uint8, as ``cv2.imread`` +
    ``cvtColor(BGR2RGB)`` give it."""
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        raise PNGError(f"Could not read image {path}: {e}") from e
    return decode_rgb(data, str(path), unfilter)


def decode_rgb(data: bytes, name: str = "<png>",
               unfilter: Callable = native.png_unfilter) -> np.ndarray:
    """A PNG file's bytes as HWC RGB uint8, as ``cv2.imdecode`` with
    ``IMREAD_COLOR`` + ``cvtColor(BGR2RGB)`` give it: grey replicated to
    three channels, alpha dropped."""
    img = decode(data, name, unfilter)
    c = img.shape[2]
    if c <= 2:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3]) if c == 4 else img


def _filter(cur: np.ndarray, ftype: int, bpp: int) -> bytes:
    """``cur`` [H, W*C] (int16) as PNG scanlines, every row with filter
    ``ftype``."""
    h, rowbytes = cur.shape
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    upleft = np.zeros_like(cur)
    upleft[:, bpp:] = up[:, :-bpp]
    if ftype == 0:
        pred = np.zeros_like(cur)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    elif ftype == 4:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"filter type {ftype} is not 0-4")
    out = np.empty((h, rowbytes + 1), np.uint8)
    out[:, 0] = ftype
    out[:, 1:] = (cur - pred).astype(np.uint8)
    return out.tobytes()


def encode(img: np.ndarray, level: int = 6, filter_type: int = 0) -> bytes:
    """An [H, W] or [H, W, C] uint8 image (C 1-4; RGB order) as PNG
    bytes, every row with ``filter_type``, zlib ``level``."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode takes HxW[xC] uint8 with C in 1-4, got "
                         f"{img.shape} {img.dtype}")
    h, w, c = img.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    rows = _filter(img.reshape(h, w * c).astype(np.int16), filter_type, c)
    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows, level))
            + chunk(b"IEND", b""))


def write_png(path: PathLike, img: np.ndarray, level: int = 6, filter_type: int = 0) -> None:
    Path(path).write_bytes(encode(img, level, filter_type))
