"""The port's CUDA build helper (facesr_torch.ops._build) on the CPU: which
sources a library is built from and the name it is built under. nvcc
itself runs only on the card's machine."""

import pytest

from facesr_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (src / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (src / "a.cuh").write_text('#pragma once\n#  include "b.cuh"\n')
    (src / "b.cuh").write_text('#pragma once\n#include "a.cuh"\nint b;\n')
    return src


def test_sources_follow_local_includes(csrc):
    # system headers are not ours; a cycle of includes ends
    assert [p.name for p in _build._sources("k")] == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "b.cuh"])
def test_target_changes_with_any_source(csrc, edited):
    before = _build._target("k")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    after = _build._target("k")
    assert after != before
    assert after.parent == _build.BUILD_DIR and after.name.startswith("libk.")


def test_target_changes_with_the_flags(csrc, monkeypatch):
    before = _build._target("k")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._target("k") != before


def test_target_ignores_files_not_included(csrc):
    before = _build._target("k")
    (csrc / "other.cuh").write_text("int unrelated;\n")
    assert _build._target("k") == before
