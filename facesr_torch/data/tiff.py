"""TIFF decoding with numpy and zlib: what the JAX package's ``cv2.imread``
(libtiff 4.7 through OpenCV) + ``BGR2RGB`` gives, bit for bit.

It reads the first page of a classic TIFF in either byte order, stored in
strips with contiguous samples: 8-bit grey (min-is-black), grey + alpha,
RGB and RGBA (alpha dropped; unassociated alpha premultiplied first, as
libtiff's RGBA reader does), uncompressed, PackBits, LZW or Deflate, with
predictor 1 or 2 (horizontal differencing), and applies the Orientation
tag as cv2 does. Refused by name (`UnsupportedImage`): tiles, BigTIFF,
separate planes, other depths and sample formats, other photometric
interpretations (min-is-white, palette, YCbCr, CMYK ...) and other
compressions (JPEG, CCITT ...). A truncated or corrupt file raises
`TIFFError`.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List

import numpy as np

from facesr_torch.data.image_errors import ImageDecodeError, UnsupportedImage
from facesr_torch.data.jpeg import apply_orientation

__all__ = ["SIGNATURES", "TIFFError", "decode", "check", "lzw_decode", "packbits_decode"]

SIGNATURES = (b"II*\0", b"MM\0*")
_BIGTIFF = (b"II+\0", b"MM\0+")
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q"}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}


class TIFFError(ImageDecodeError):
    pass


def _ifd(data: bytes, e: str, at: int, name: str) -> Dict[int, List[int]]:
    """The tags of the IFD at ``at``: tag -> its values."""
    try:
        (n,) = struct.unpack(e + "H", data[at:at + 2])
        tags = {}
        for i in range(n):
            tag, kind, count = struct.unpack(e + "HHI", data[at + 2 + 12 * i:at + 10 + 12 * i])
            if kind not in _TYPES:
                continue
            fmt = _TYPES[kind]
            size = struct.calcsize(fmt) * count
            where = at + 10 + 12 * i
            if size > 4:
                (where,) = struct.unpack(e + "I", data[where:where + 4])
            raw = data[where:where + size]
            if len(raw) != size:
                raise TIFFError(f"{name}: truncated TIFF tag {tag}")
            tags[tag] = list(struct.unpack(e + fmt * count, raw))
        return tags
    except struct.error:
        raise TIFFError(f"{name}: truncated TIFF directory") from None


def packbits_decode(src: bytes, size: int) -> bytes:
    """PackBits (TIFF compression 32773) -> ``size`` bytes at most."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < size:
        c = src[i]
        i += 1
        if c < 128:
            out += src[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += bytes([src[i]]) * (257 - c)
            i += 1
    return bytes(out)


def lzw_decode(src: bytes, size: int) -> bytes:
    """TIFF LZW (compression 5: MSB-first codes of 9-12 bits, Clear 256,
    EOI 257, the code width growing one code early) -> ``size`` bytes at
    most. Raises ValueError for a corrupt stream."""
    if len(src) >= 2 and src[0] == 0 and src[1] & 1:
        raise ValueError("old-style (LSB-first) LZW")
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    acc, nacc, pos = 0, 0, 0
    width = 9
    prev = None
    while len(out) < size:
        while nacc < width:
            if pos >= len(src):
                return bytes(out)  # libtiff stops at the end of the strip
            acc = (acc << 8) | src[pos]
            pos += 1
            nacc += 8
        code = (acc >> (nacc - width)) & ((1 << width) - 1)
        nacc -= width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width = 9
            prev = None
            continue
        if prev is None:
            if code >= 256:
                raise ValueError("LZW code before a literal")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("LZW code past the table")
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def decode(data: bytes, name: str = "<tiff>") -> np.ndarray:
    """The first page of a TIFF file's bytes -> HWC RGB uint8."""
    return _decode(data, name, pixels=True)


def check(data: bytes, name: str = "<tiff>") -> None:
    """Raise as `decode` would for the first page's tags, without
    decompressing its strips."""
    _decode(data, name, pixels=False)


def _decode(data: bytes, name: str, pixels: bool):
    if data[:4] in _BIGTIFF:
        raise UnsupportedImage(f"{name}: BigTIFF is not decoded by the port")
    if data[:4] not in SIGNATURES or len(data) < 8:
        raise TIFFError(f"{name}: not a TIFF file")
    e = "<" if data[:2] == b"II" else ">"
    (first,) = struct.unpack(e + "I", data[4:8])
    tags = _ifd(data, e, first, name)

    def one(tag: int, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    def refuse(what: str) -> UnsupportedImage:
        return UnsupportedImage(f"{name}: TIFF with {what} is not decoded by the port")

    width, height = one(256), one(257)
    if not width or not height:
        raise TIFFError(f"{name}: TIFF without image size")
    if 322 in tags or 324 in tags:
        raise refuse("tiles")
    spp = one(277, 1)
    bits = tags.get(258, [1] * spp)
    if any(b != 8 for b in bits):
        raise refuse(f"{bits[0]}-bit samples")
    if one(339, 1) != 1:
        raise refuse("non-integer samples")
    if one(284, 1) != 1:
        raise refuse("separate sample planes")
    comp = one(259, 1)
    if comp not in _COMPRESSIONS:
        raise refuse(f"compression {comp}")
    photo = one(262)
    if not ((photo == 1 and spp in (1, 2)) or (photo == 2 and spp in (3, 4))):
        raise refuse(f"photometric interpretation {photo} and {spp} samples")
    predictor = one(317, 1)
    if predictor not in (1, 2):
        raise refuse(f"predictor {predictor}")
    offsets, counts = tags.get(273), tags.get(279)
    if not offsets or not counts or len(offsets) != len(counts):
        raise TIFFError(f"{name}: TIFF without strips")
    if not pixels:
        return None
    rps = min(one(278, height), height)
    rowbytes = width * spp
    strips = []
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        rows = min(rps, height - i * rps)
        if rows <= 0:
            break
        raw = data[off:off + cnt]
        if len(raw) != cnt:
            raise TIFFError(f"{name}: truncated TIFF strip {i}")
        want = rows * rowbytes
        try:
            if comp == 1:
                buf = raw
            elif comp == 32773:
                buf = packbits_decode(raw, want)
            elif comp == 5:
                buf = lzw_decode(raw, want)
            else:
                buf = zlib.decompress(raw)
        except (ValueError, zlib.error) as err:
            raise TIFFError(f"{name}: corrupt TIFF strip {i} ({err})") from None
        if len(buf) < want:
            raise TIFFError(f"{name}: TIFF strip {i} holds {len(buf)} bytes, want {want}")
        strips.append(np.frombuffer(buf, np.uint8, want).reshape(rows, width, spp))
    if sum(s.shape[0] for s in strips) != height:
        raise TIFFError(f"{name}: TIFF strips hold fewer rows than the image")
    img = np.concatenate(strips, axis=0)
    if predictor == 2:
        img = np.cumsum(img, axis=1, dtype=np.uint8)
    if spp == 4 and one(338) == 2:
        # libtiff's RGBA reader, which OpenCV uses for colour, premultiplies
        # unassociated alpha: (v * a + 127) // 255
        a = img[:, :, 3:].astype(np.int32)
        img = ((img[:, :, :3].astype(np.int32) * a + 127) // 255).astype(np.uint8)
    img = np.repeat(img[:, :, :1], 3, axis=2) if spp <= 2 else img[:, :, :3]
    return apply_orientation(np.ascontiguousarray(img), one(274, 1))
