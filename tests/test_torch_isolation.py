"""The port stands alone: nothing under facesr_torch/ and nothing in
chip_smoke.py imports jax, flax, optax or the JAX package `facesr`, nor
a package the card's machine lacks (cv2, PIL, PyYAML, h5py, msgpack,
matplotlib, scikit-image, pandas)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "facesr", "cv2", "PIL", "yaml", "h5py",
             "msgpack", "matplotlib", "skimage", "pandas")
FILES = sorted((ROOT / "facesr_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_sees_the_files():
    assert len(FILES) > 20 and any(p.name == "trainer.py" for p in FILES)
