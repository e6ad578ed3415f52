"""The port's image readers: `imread` and `imdecode` give what the JAX
package's ``cv2.imread`` / ``cv2.imdecode(buf, IMREAD_COLOR)`` followed by
``cvtColor(BGR2RGB)`` give, HWC RGB uint8, bit for bit (OpenCV 5.0 with
libjpeg-turbo 3.1, libpng 1.6 and libtiff 4.7).

The decoder is picked by the file's signature, not its extension, as cv2
picks it: JPEG (`data.jpeg`: baseline, extended and progressive, restart
intervals, the EXIF orientation), PNG (`data.png`: every depth, palette,
Adam7), BMP (`data.bmp`) and TIFF (`data.tiff`: strips, none / PackBits /
LZW / Deflate). Every fault raises `ImageDecodeError` with the file's name:
a truncated or corrupt file (cv2 returns None), or an unknown format. A
JPEG cut inside its entropy data is not such a file for `imread`, which
reads a file as ``cv2.imread`` does (libjpeg's stdio source: a fake EOI at
the end, the rest of the image grey); `imdecode` of the same bytes raises,
as ``cv2.imdecode`` returns None (the API answers 400). A
format or variant that cv2 reads and the port does not (WebP, GIF, JPEG
2000, AVIF, HDR, PNM, Sun raster, BigTIFF, CMYK JPEG ...) raises
`UnsupportedImage`, which is also a `NotPorted`.

`imread_numpy` / `imdecode_numpy` are the same readers with the plain
(Python and numpy) versions of the C++ helpers, for tests.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from facesr_torch import native
from facesr_torch.data import bmp, jpeg, png, tiff
from facesr_torch.data.image_errors import ImageDecodeError, UnsupportedImage
from facesr_torch.parallel.mesh import NotPorted

__all__ = ["ImageDecodeError", "UnsupportedImage", "NotPorted", "imread", "imdecode",
           "imread_numpy", "imdecode_numpy", "format_of", "refusal"]

PathLike = Union[str, Path]

# formats cv2 5.0 reads here (its build) that the port refuses, by signature
_OTHER = (
    (b"RIFF", 8, b"WEBP", "WebP"),
    (b"GIF87a", 0, b"", "GIF"),
    (b"GIF89a", 0, b"", "GIF"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", 0, b"", "JPEG 2000"),
    (b"\xff\x4f\xff\x51", 0, b"", "JPEG 2000 codestream"),
    (b"#?RADIANCE", 0, b"", "Radiance HDR"),
    (b"#?RGBE", 0, b"", "Radiance HDR"),
    (b"\x59\xa6\x6a\x95", 0, b"", "Sun raster"),
    (b"II+\x00", 0, b"", "BigTIFF"),
    (b"MM\x00+", 0, b"", "BigTIFF"),
)


def format_of(data: bytes) -> str:
    """The format cv2 would read ``data`` as: 'jpeg', 'png', 'bmp', 'tiff',
    the name of one the port refuses, or '' when none."""
    if data.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if data.startswith(png.SIGNATURE):
        return "png"
    if data.startswith(bmp.SIGNATURE):
        return "bmp"
    if data[:4] in tiff.SIGNATURES:
        return "tiff"
    for head, at, tail, what in _OTHER:
        if data.startswith(head) and data[at:at + len(tail)] == tail:
            return what
    if data[4:12] in (b"ftypavif", b"ftypavis"):
        return "AVIF"
    if len(data) > 2 and data[0:1] == b"P" and data[1:2] in b"1234567fF" \
            and data[2:3] in b" \t\r\n":
        return "PNM/PFM"
    return ""


def _decode(data: bytes, name: str, plain: bool, file: bool = False) -> np.ndarray:
    kind = format_of(data)
    if kind == "jpeg":
        if plain:
            return jpeg.decode(data, name, native.jpeg_entropy_numpy,
                               native.jpeg_reconstruct_numpy, native.jpeg_smooth_numpy,
                               file=file)
        return jpeg.decode(data, name, file=file)
    if kind == "png":
        return png.decode_rgb(data, name,
                              native.png_unfilter_numpy if plain else native.png_unfilter)
    if kind == "bmp":
        return bmp.decode(data, name)
    if kind == "tiff":
        return tiff.decode(data, name)
    if kind:
        raise UnsupportedImage(f"{name}: {kind} images are not decoded by the port "
                               "(JPEG, PNG, BMP and TIFF are)")
    raise ImageDecodeError(f"{name}: not an image file the port or cv2 knows "
                           f"(starts with {data[:8]!r})")


def imdecode(data: bytes, name: str = "<image>") -> np.ndarray:
    """An image file's bytes -> HWC RGB uint8, as ``cv2.imdecode`` with
    ``IMREAD_COLOR`` + ``BGR2RGB`` give it."""
    return _decode(bytes(data), name, plain=False)


def imdecode_numpy(data: bytes, name: str = "<image>") -> np.ndarray:
    """`imdecode` with the plain versions of the C++ helpers."""
    return _decode(bytes(data), name, plain=True)


def refusal(path: PathLike) -> Optional[str]:
    """Why the port would refuse the image file at ``path`` (the
    `UnsupportedImage` message), from its headers alone; None when it
    decodes it, or when the file is corrupt or unreadable (cv2 returns None
    for it too: a caller skips it)."""
    try:
        data = _read(path)
        kind = format_of(data)
        if kind == "jpeg":
            jpeg.parse(jpeg.file_bytes(data), str(path))
        elif kind == "bmp":
            bmp.decode(data, str(path))
        elif kind == "tiff":
            tiff.check(data, str(path))
        elif kind and kind != "png":
            _decode(data, str(path), plain=False)
    except UnsupportedImage as e:
        return str(e)
    except ImageDecodeError:
        return None
    return None


def _read(path: PathLike) -> bytes:
    try:
        return Path(path).read_bytes()
    except OSError as e:
        raise ImageDecodeError(f"Could not read image {path}: {e}") from e


def imread(path: PathLike) -> np.ndarray:
    """The image file at ``path`` -> HWC RGB uint8, as ``cv2.imread`` +
    ``BGR2RGB`` give it: a JPEG cut inside its entropy data decodes, the
    rest grey, where `imdecode` of the same bytes raises."""
    return _decode(_read(path), str(path), plain=False, file=True)


def imread_numpy(path: PathLike) -> np.ndarray:
    """`imread` with the plain versions of the C++ helpers."""
    return _decode(_read(path), str(path), plain=True, file=True)
