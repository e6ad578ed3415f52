"""The two errors of the port's image decoders (`facesr_torch.data.codecs`).

- `ImageDecodeError`: a file that cannot be decoded, truncated or corrupt;
  where the JAX package reads the same bytes, ``cv2.imread`` returns None.
- `UnsupportedImage`: a format or variant that cv2 reads and the port does
  not (WebP, CMYK JPEG, a tiled TIFF ...). It is an `ImageDecodeError` and
  a `NotPorted` at once, so one ``except ImageDecodeError`` catches every
  decoder fault and ``except NotPorted`` only the refusals.
"""

from __future__ import annotations

from facesr_torch.parallel.mesh import NotPorted

__all__ = ["ImageDecodeError", "UnsupportedImage"]


class ImageDecodeError(IOError):
    pass


class UnsupportedImage(NotPorted, ImageDecodeError):
    pass
