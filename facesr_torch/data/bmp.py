"""BMP decoding with numpy: what the JAX package's ``cv2.imread`` (OpenCV's
own BMP reader) + ``BGR2RGB`` gives, bit for bit.

It reads files with a BITMAPINFOHEADER or a V4/V5 header: 1-, 4- and
8-bit palette images, 24-bit BGR, 32-bit BI_RGB and BI_BITFIELDS (the
fourth byte ignored; a V4/V5 header's masks must be BGRA), 16-bit BI_RGB
(5-5-5) and BI_BITFIELDS (5-5-5 or 5-6-5, read after the header as OpenCV
reads them; the low bits of each channel zero, as OpenCV expands them);
rows bottom-up (positive height) or top-down (negative). A palette index
past the table reads black. Refused by name (`UnsupportedImage`):
RLE4/RLE8 and other compressions, OS/2 core headers, other 32-bit masks.
A truncated or corrupt file raises `BMPError`.
"""

from __future__ import annotations

import struct

import numpy as np

from facesr_torch.data.image_errors import ImageDecodeError, UnsupportedImage

__all__ = ["SIGNATURE", "BMPError", "decode"]

SIGNATURE = b"BM"
_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
_MASKS_555 = (0x7C00, 0x03E0, 0x001F)
_MASKS_565 = (0xF800, 0x07E0, 0x001F)
_MASKS_BGRA = (0x00FF0000, 0x0000FF00, 0x000000FF)


class BMPError(ImageDecodeError):
    pass


def decode(data: bytes, name: str = "<bmp>") -> np.ndarray:
    """A BMP file's bytes -> HWC RGB uint8."""
    if not data.startswith(SIGNATURE) or len(data) < 18:
        raise BMPError(f"{name}: not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    if size == 12:
        raise UnsupportedImage(f"{name}: OS/2 BMP (core header) is not decoded by the port")
    if size < 40 or len(data) < 14 + size:
        raise BMPError(f"{name}: truncated or bad BMP header")
    width, height, _, bpp, comp, _, _, _, used = struct.unpack(
        "<iiHHIIiiI", data[18:50])
    if comp in (_BI_RLE8, _BI_RLE4):
        raise UnsupportedImage(f"{name}: RLE{8 if comp == _BI_RLE8 else 4}-compressed BMP is "
                               "not decoded by the port")
    if comp not in (_BI_RGB, _BI_BITFIELDS):
        raise UnsupportedImage(f"{name}: BMP compression {comp} is not decoded by the port")
    if width <= 0 or height == 0 or bpp not in (1, 4, 8, 16, 24, 32):
        raise BMPError(f"{name}: bad BMP header ({width}x{height}, {bpp} bits)")
    masks = None
    if comp == _BI_BITFIELDS and bpp == 16:
        # OpenCV reads them after the header, whatever its size
        if len(data) < 14 + size + 12:
            raise BMPError(f"{name}: truncated BMP bit masks")
        masks = struct.unpack("<III", data[14 + size:26 + size])
        if masks not in (_MASKS_555, _MASKS_565):
            raise BMPError(f"{name}: 16-bit BMP with bit masks {[hex(m) for m in masks]}")
    elif comp == _BI_BITFIELDS and bpp == 32 and size > 40:
        # a V4/V5 header's masks are used; a BITMAPINFOHEADER's are ignored
        if struct.unpack("<III", data[54:66]) != _MASKS_BGRA:
            raise UnsupportedImage(f"{name}: 32-bit BMP with bit masks other than BGRA is "
                                   "not decoded by the port")
    elif comp == _BI_BITFIELDS and bpp != 32:
        raise BMPError(f"{name}: bit masks on a {bpp}-bit BMP")
    top_down = height < 0
    height = abs(height)
    stride = (width * bpp + 31) // 32 * 4
    if offset + stride * height > len(data):
        raise BMPError(f"{name}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp <= 8:
        count = used if used else 1 << bpp
        palette = np.zeros((256, 3), np.uint8)
        at = 14 + size
        entries = np.frombuffer(data[at:at + 4 * min(count, 256)], np.uint8)
        n = len(entries) // 4
        palette[:n] = entries[:4 * n].reshape(n, 4)[:, 2::-1]  # BGRx -> RGB
        if bpp == 8:
            idx = rows[:, :width]
        else:
            bits = np.unpackbits(rows, axis=1)[:, :width * bpp].reshape(height, width, bpp)
            weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)
            idx = (bits * weights).sum(axis=2, dtype=np.uint8)
        return palette[idx]
    if bpp == 24:
        return np.ascontiguousarray(rows[:, :3 * width].reshape(height, width, 3)[:, :, ::-1])
    if bpp == 32:
        return np.ascontiguousarray(rows[:, :4 * width].reshape(height, width, 4)[:, :, 2::-1])
    t = rows[:, :2 * width].copy().view("<u2").astype(np.int32)
    b = (t << 3) & 0xF8
    if masks == _MASKS_565:
        g, r = (t >> 3) & 0xFC, (t >> 8) & 0xF8
    else:
        g, r = (t >> 2) & 0xF8, (t >> 7) & 0xF8
    return np.stack([r, g, b], axis=2).astype(np.uint8)
