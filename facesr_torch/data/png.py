"""PNG read and write with zlib and numpy (the card's machine has no cv2
and no PIL).

`read_rgb` returns what the JAX package's ``cv2.imread`` + ``BGR2RGB``
returns for the same file (libpng 1.6 as OpenCV sets it up): HWC RGB
uint8, grey replicated to three channels, alpha and ``tRNS`` dropped
(``IMREAD_COLOR``). It reads every PNG: grey at 1, 2, 4, 8 and 16 bits,
grey + alpha, RGB and RGBA at 8 and 16 bits, palette images at 1-8 bits,
Adam7-interlaced or not, with any of the five row filters (undone in C++,
`facesr_torch.native.png_unfilter`). 16-bit samples become ``x >> 8``
(libpng's ``png_set_strip_16``), 1/2/4-bit grey is scaled to 8 bits (x 255,
85, 17), and an ``eXIf`` chunk's orientation is applied as cv2 applies it.
A corrupt or truncated file raises `PNGError` with its name; every chunk's
CRC is checked.

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
from facesr_torch.data.image_errors import ImageDecodeError
from facesr_torch.data.jpeg import apply_orientation, exif_orientation

__all__ = ["PNGError", "read_rgb", "decode", "decode_rgb", "encode", "write_png"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type written
# Adam7 passes: (x start, y start, x step, y step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))

PathLike = Union[str, Path]


class PNGError(ImageDecodeError):
    pass


def _chunks(data: bytes, name: str):
    """(kind, body) of every chunk up to IEND, CRCs checked."""
    if not data.startswith(SIGNATURE):
        raise PNGError(f"{name}: not a PNG file")
    pos = len(SIGNATURE)
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
        yield kind, body
        if kind == b"IEND":
            return


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, rowbytes] -> [h, width, channels] samples:
    uint8 below 16 bits (unscaled), uint16 at 16."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    if depth == 16:
        return rows.view(">u2").reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :, None]


def _pass(raw: bytes, pos: int, width: int, height: int, channels: int, depth: int,
          unfilter: Callable, name: str):
    """One (sub)image of ``height`` rows from the inflated data at ``pos``;
    returns its samples and the offset after it."""
    rowbytes = (width * channels * depth + 7) // 8
    size = height * (rowbytes + 1)
    if pos + size > len(raw):
        raise PNGError(f"{name}: image data holds {len(raw)} bytes, want more")
    try:
        rows = unfilter(raw[pos:pos + size], height, rowbytes,
                        max(1, channels * depth // 8))
    except ValueError as e:
        raise PNGError(f"{name}: {e}") from e
    return _samples(rows, width, channels, depth), pos + size


def _parse(data: bytes, name: str, unfilter: Callable):
    """The image's samples at the file's depth [H, W, C], its header, its
    palette and its EXIF orientation."""
    header, idat, palette, orientation = None, [], None, 1
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            if len(body) != 13:
                raise PNGError(f"{name}: bad IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            if len(body) % 3 or len(body) > 768:
                raise PNGError(f"{name}: bad PLTE chunk")
            palette = np.zeros((256, 3), np.uint8)  # indices past the table read black
            palette[:len(body) // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"eXIf" and not idat:
            orientation = exif_orientation(body)
        elif kind in (b"IEND",) or kind[0] & 0x20:  # ancillary chunks: tRNS, gAMA ...
            continue
        else:
            raise PNGError(f"{name}: unsupported critical chunk {kind!r}")
    if header is None or not idat:
        raise PNGError(f"{name}: no IHDR or no IDAT chunk")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise PNGError(f"{name}: bad colour type {ctype} at {depth} bits")
    if comp != 0 or filt != 0 or interlace > 1 or width == 0 or height == 0:
        raise PNGError(f"{name}: bad IHDR {header}")
    if ctype == 3 and palette is None:
        raise PNGError(f"{name}: palette PNG without a PLTE chunk")
    channels = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{name}: corrupt image data ({e})") from e
    if not interlace:
        img, used = _pass(raw, 0, width, height, channels, depth, unfilter, name)
    else:
        img = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        used = 0
        for xs, ys, dx, dy in _ADAM7:
            pw, ph = -(-(width - xs) // dx), -(-(height - ys) // dy)
            if pw <= 0 or ph <= 0:
                continue
            sub, used = _pass(raw, used, pw, ph, channels, depth, unfilter, name)
            img[ys::dy, xs::dx] = sub
    if used != len(raw):
        raise PNGError(f"{name}: image data holds {len(raw)} bytes, want {used}")
    return img, (width, height, depth, ctype), palette, orientation


def _decode8(data: bytes, name: str, unfilter: Callable):
    img, (_, _, depth, ctype), palette, orientation = _parse(data, name, unfilter)
    if depth == 16:
        img = (img >> 8).astype(np.uint8)
    elif ctype == 3:
        img = palette[img[:, :, 0]]
    elif depth < 8:
        img = img * np.uint8({1: 255, 2: 85, 4: 17}[depth])
    return img, orientation


def decode(data: bytes, name: str = "<png>", unfilter: Callable = native.png_unfilter
           ) -> np.ndarray:
    """The pixels of a PNG file's bytes as 8-bit samples: [H, W, C] uint8
    with C the file's channel count (1 grey, 2 grey + alpha, 3 RGB, 4
    RGBA; 3 for a palette image, its colours). ``unfilter`` is
    `native.png_unfilter` or its plain numpy version."""
    return _decode8(data, name, unfilter)[0]


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
    three channels, alpha dropped, the ``eXIf`` orientation applied."""
    img, orientation = _decode8(data, name, unfilter)
    c = img.shape[2]
    if c <= 2:
        img = np.repeat(img[:, :, :1], 3, axis=2)
    elif c == 4:
        img = np.ascontiguousarray(img[:, :, :3])
    return apply_orientation(img, orientation)


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
