"""The errors of the port's file readers: the image decoders
(`facesr_torch.data.codecs`) and the HDF5 reader (`facesr_torch.data.hdf5`).

- `ImageDecodeError`: an image file that cannot be decoded, truncated or
  corrupt; where the JAX package reads the same bytes, ``cv2.imread``
  returns None (a JPEG cut inside its entropy data is not such a file:
  ``cv2.imread`` patches it, and so does `codecs.imread`).
- `UnsupportedImage`: a format or variant that cv2 reads and the port does
  not (WebP, CMYK JPEG, a tiled TIFF ...). It is an `ImageDecodeError` and
  a `NotPorted` at once, so one ``except ImageDecodeError`` catches every
  decoder fault and ``except NotPorted`` only the refusals.
- `HDF5Error`: an ``.h5`` file that is truncated or corrupt.
- `UnsupportedHDF5`: a layout that h5py reads and the port does not (a
  newer superblock, a fractal heap, a filter other than deflate ...); an
  `HDF5Error` and a `NotPorted` at once.
"""

from __future__ import annotations

from facesr_torch.parallel.mesh import NotPorted

__all__ = ["ImageDecodeError", "UnsupportedImage", "HDF5Error", "UnsupportedHDF5"]


class ImageDecodeError(IOError):
    pass


class UnsupportedImage(NotPorted, ImageDecodeError):
    pass


class HDF5Error(IOError):
    pass


class UnsupportedHDF5(NotPorted, HDF5Error):
    pass
