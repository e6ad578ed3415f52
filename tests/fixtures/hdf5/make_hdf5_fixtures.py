"""Write the HDF5 fixtures of this folder and ``digests.json``.

The card's machine has no h5py, so `chip_smoke.py` holds the port's HDF5
reader (`facesr_torch.data.hdf5`) to these files, each written by the JAX
package's ``save_to_hdf5`` (h5py 3.14) from PNG pairs made here:

- ``faces_256.h5``: three synthetic faces at HR 256 / LR 64 (LR by cv2's
  INTER_AREA);
- ``chunks_4200.h5``: 4,200 pairs of 4x4 / 1x1 images, so each chunk
  index is a version-1 B-tree three levels deep (a node holds at most 64
  entries, and 64 x 64 < 4,200).

``digests.json`` holds, for each file, the shape and SHA-256 of ``HR`` and
``LR`` as h5py reads them, the SHA-256 of the filenames joined by newlines,
and the attributes. ``tests/test_torch_hdf5.py`` recomputes them with h5py,
so the JSON cannot go stale.

    python tests/fixtures/hdf5/make_hdf5_fixtures.py
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
FILES = {"faces_256.h5": (3, 256, 64), "chunks_4200.h5": (4200, 4, 1)}


def _pairs(split: Path, n: int, hr_size: int, lr_size: int) -> None:
    import cv2

    from facesr_torch.cli.make_synthetic_faces import render_face

    rng = np.random.default_rng(hr_size)
    (split / "HR").mkdir(parents=True)
    (split / "LR").mkdir()
    for i in range(n):
        if hr_size >= 64:
            hr = render_face(np.random.default_rng(i), hr_size)
        else:
            hr = rng.integers(0, 256, (hr_size, hr_size, 3), dtype=np.uint8)
        lr = cv2.resize(hr, (lr_size, lr_size), interpolation=cv2.INTER_AREA)
        cv2.imwrite(str(split / "HR" / f"{i:05d}.png"), hr[..., ::-1])
        cv2.imwrite(str(split / "LR" / f"{i:05d}.png"), lr[..., ::-1])


def digest(path: Path) -> dict:
    """What h5py reads from ``path``: ``HR``/``LR`` shape and SHA-256, the
    filenames' SHA-256, the attributes."""
    import h5py

    with h5py.File(path, "r") as f:
        out = {k: {"shape": list(f[k].shape),
                   "sha256": hashlib.sha256(np.ascontiguousarray(f[k][:]).tobytes()).hexdigest()}
               for k in ("HR", "LR")}
        names = b"\n".join(f["filenames"][:].tolist())
        out["filenames"] = hashlib.sha256(names).hexdigest()
        out["attrs"] = {k: int(v) for k, v in sorted(f.attrs.items())}
    return out


def main() -> None:
    sys.path.insert(0, str(REPO))
    from facesr.data.prepare_data import save_to_hdf5

    digests = {}
    for name, (n, hr_size, lr_size) in FILES.items():
        with tempfile.TemporaryDirectory() as d:
            _pairs(Path(d), n, hr_size, lr_size)
            save_to_hdf5(Path(d), HERE / name, hr_size, lr_size)
        digests[name] = digest(HERE / name)
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    print(f"wrote {len(FILES)} files, "
          f"{sum((HERE / n).stat().st_size for n in FILES)} bytes, and digests.json")


if __name__ == "__main__":
    main()
