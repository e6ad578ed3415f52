"""The offline data CLIs of the port on the CPU against the JAX package's
(cv2 inside it): `cv_compat.gaussian_blur` against ``cv2.GaussianBlur``,
`data.draw` against cv2's drawing on float canvases for every call shape
``render_face`` makes, `cli.make_synthetic_faces` against
``scripts/make_synthetic_faces.py``, `data.prepare_data` against
``facesr/data/prepare_data.py`` (its three degradations, end to end, and
JPEG, 16-bit and palette inputs, and its refusals) and `cli.split_data`
against ``scripts/split_data.py``.

Tolerances: none. Every comparison is bitwise: uint8 and float32 blurs,
every drawn shape, every synthetic face (a differing value is counted and
printed first), the prepared HR and LR pixels and ``prepare_stats.json``,
and the split file sets.
"""

import json
import random
import shutil
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from facesr_torch.cli import make_synthetic_faces as tfaces
from facesr_torch.cli import split_data as tsplit
from facesr_torch.data import draw
from facesr_torch.data import prepare_data as tprep
from facesr_torch.data.cv_compat import gaussian_blur
from facesr_torch.data.png import read_rgb, write_png

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))


def _jax_faces():
    import make_synthetic_faces

    return make_synthetic_faces


# ---------------------------------------------------------------------------
# the Gaussian blur


@pytest.mark.parametrize("shape,k,sigma", [((128, 128, 3), 7, 1.5), ((37, 53, 3), 7, 1.5),
                                           ((160, 160, 3), 7, 1.5), ((64, 64, 3), 5, 1.0),
                                           ((33, 20), 3, 0.0), ((40, 41, 3), 9, 2.0),
                                           ((5, 3, 3), 7, 1.5)])
def test_uint8_gaussian_blur_is_cv2s_bitwise(shape, k, sigma):
    img = np.random.default_rng(k * 100 + shape[0]).integers(0, 256, shape, dtype=np.uint8)
    want = cv2.GaussianBlur(img, (k, k), sigma)
    got = gaussian_blur(img, k, sigma)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(320, 320, 3), (128, 128, 3), (17, 7, 3), (9, 13, 3),
                                   (11, 5), (1, 6, 3)])
def test_float32_gaussian_blur_3x3_is_cv2s_bitwise(shape):
    """The synthetic faces' 3x3, sigma 0.8 blur of a float canvas; odd row
    lengths take OpenCV's scalar tail for their last value."""
    rng = np.random.default_rng(shape[0])
    img = (rng.random(shape) * 255).astype(np.float32) + \
        rng.normal(0, 4, shape).astype(np.float32)
    want = cv2.GaussianBlur(img, (3, 3), 0.8)
    got = gaussian_blur(img, 3, 0.8)
    differ = int((got != want).sum())
    print(f"{shape}: {differ} of {want.size} values differ")
    assert got.dtype == np.float32 and differ == 0


# ---------------------------------------------------------------------------
# drawing: every call shape of render_face, on float canvases


def _shape_args(kind, rng, S):
    """Random arguments of one render_face call shape at canvas size S
    (inside the canvas sideways, as render_face's shapes are: a partial
    fill or a thick line clipped at a side edge is not held)."""
    cx, cy = int(rng.integers(S // 4, 3 * S // 4)), int(rng.integers(S // 4, 3 * S // 4))
    ax, ay = int(rng.integers(1, S // 3)), int(rng.integers(1, S // 3))
    ang = float(rng.uniform(-12, 12))
    if kind == "head":
        return "ellipse", ((cx, cy), (ax, ay), ang, 0, 360), -1
    if kind == "hair":  # a half ellipse, at times through the top edge (never a side)
        ax = min(ax, cx - 1, S - 2 - cx)
        return "ellipse", ((cx, int(rng.integers(-S // 8, S // 2))), (ax, ay), ang, 180, 360), -1
    if kind == "nose_tip":
        return "ellipse", ((cx, cy), (max(2, ax // 8), max(1, ay // 16)), 0, 0, 180), -1
    if kind == "eye":
        return "ellipse", ((cx, cy), (max(3, ax // 5), max(2, ay // 8)), 0, 0, 360), -1
    if kind.startswith("brow"):
        th = 1 if kind == "brow_thin" else 3
        return "ellipse", ((cx, cy), (max(1, ax // 4), max(1, ay // 8)), float(rng.uniform(-8, 8)),
                           200, 340), th
    if kind == "circle":
        return "circle", ((cx, cy), int(rng.integers(0, S // 10))), -1
    th = 1 if kind == "nose_line_thin" else 2
    return "line", ((cx, cy), (cx + int(rng.integers(-3, 4)), cy + int(rng.integers(1, S // 5)))), th


@pytest.mark.parametrize("kind", ["head", "hair", "nose_tip", "eye", "brow_thin", "brow_thick",
                                  "circle", "nose_line_thin", "nose_line"])
def test_drawing_is_cv2s_bitwise(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    for trial in range(24):
        S = (128, 320)[trial % 2]
        fn, args, th = _shape_args(kind, rng, S)
        color = rng.uniform(0, 255, 3).tolist()
        base = rng.uniform(0, 255, (S, S, 3)).astype(np.float32)
        want, got = base.copy(), base.copy()
        getattr(cv2, fn)(want, *args, color, th, lineType=cv2.LINE_AA)
        getattr(draw, fn)(got, *args, color, th)
        differ = int((got != want).any(-1).sum())
        assert differ == 0, (kind, trial, args, th, differ)


def test_sin_table_reads_back_through_cv2_ellipse2poly():
    """OpenCV's 7-decimal sine table: cv2's own points at a 2^30 radius
    are the table's values times 2^30."""
    a = 1 << 30
    pts = np.array(cv2.ellipse2Poly((0, 0), (a, a), 0, 0, 90, 1), np.float64)
    np.testing.assert_array_equal(pts[:, 1] / a, draw.SIN_TABLE[:91].astype(np.float64))


# ---------------------------------------------------------------------------
# synthetic faces


@pytest.mark.parametrize("size,pairs", [(64, ((0, 0), (0, 1), (3, 7), (5, 2))),
                                        (160, ((0, 0), (1, 4), (2, 9), (7, 3)))])
def test_render_face_is_the_jax_scripts_bitwise(size, pairs):
    jfaces = _jax_faces()
    for seed, i in pairs:
        want = jfaces.render_face(np.random.default_rng((seed, i)), size)
        got = tfaces.render_face(np.random.default_rng((seed, i)), size)
        differ = int((got != want).sum())
        print(f"size {size}, (seed {seed}, face {i}): {differ} values differ")
        assert got.dtype == np.uint8 and got.shape == (size, size, 3) and differ == 0


def test_make_synthetic_faces_cli_writes_the_jax_pixels(tmp_path, monkeypatch):
    jfaces = _jax_faces()
    monkeypatch.setattr(sys, "argv", ["make_synthetic_faces.py", "--output",
                                      str(tmp_path / "jax"), "--num", "3", "--size", "48",
                                      "--seed", "4"])
    jfaces.main()
    tfaces.main(["--output", str(tmp_path / "port"), "--num", "3", "--size", "48",
                 "--seed", "4"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "face_00000.png", "face_00001.png", "face_00002.png"]
    for n in names:  # cv2 wrote BGR, the port RGB: the same decoded pixels
        np.testing.assert_array_equal(read_rgb(tmp_path / "port" / n),
                                      read_rgb(tmp_path / "jax" / n))


# ---------------------------------------------------------------------------
# prepare_data


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "realistic"])
def test_create_lr_image_matches_jax(method):
    from facesr.data import prepare_data as jprep

    hr = cv2.GaussianBlur(np.random.default_rng(1).integers(0, 256, (128, 128, 3),
                                                            dtype=np.uint8), (5, 5), 1.5)
    np.random.seed(7)
    want = jprep.create_lr_image(hr[..., ::-1].copy(), 32, method)[..., ::-1]  # cv2's BGR
    got = tprep.create_lr_image(hr, 32, method, np.random.RandomState(7))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tprep.resize_hr_image(hr, 48),
                                  jprep.resize_hr_image(hr[..., ::-1], 48)[..., ::-1])


def _raw_set(root: Path, n: int = 6) -> Path:
    """``n`` PNG faces of various sizes and colour types (RGB, grey, RGBA),
    one in a subfolder."""
    rng = np.random.default_rng(0)
    (root / "sub").mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(90, 170)), int(rng.integers(90, 170))
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (9, 9), 3)
        if i == 1:
            img = img[..., 0]
        elif i == 2:
            img = np.concatenate([img, np.full((h, w, 1), 200, np.uint8)], axis=-1)
        write_png((root / "sub" if i == 3 else root) / f"im_{i:02d}.png", img)
    return root


def _run_jax_prepare(monkeypatch, argv):
    from facesr.data import prepare_data as jprep

    monkeypatch.setattr(sys, "argv", ["prepare_data.py", *argv])
    jprep.main()


def _split_files(out: Path):
    return {s: sorted(p.name for p in (out / s / "HR").iterdir())
            for s in ("train", "val", "test")}


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "realistic"])
def test_prepare_data_end_to_end_matches_jax(tmp_path, monkeypatch, method):
    raw = _raw_set(tmp_path / "raw")
    argv = ["--input", str(raw), "--hr-size", "64", "--lr-size", "16", "--degradation", method,
            "--train-ratio", "0.5", "--val-ratio", "0.34", "--seed", "3"]
    np.random.seed(11)  # the JAX package's realistic noise: numpy's global stream
    _run_jax_prepare(monkeypatch, argv + ["--output", str(tmp_path / "jax")])
    stats = tprep.main(argv + ["--output", str(tmp_path / "port")], rng=np.random.RandomState(11))
    assert stats == {"train": 3, "val": 2, "test": 1}
    assert _split_files(tmp_path / "port") == _split_files(tmp_path / "jax")
    for split, names in _split_files(tmp_path / "jax").items():
        for sub in ("HR", "LR"):
            for n in names:
                np.testing.assert_array_equal(read_rgb(tmp_path / "port" / split / sub / n),
                                              read_rgb(tmp_path / "jax" / split / sub / n),
                                              err_msg=f"{split}/{sub}/{n}")
    assert (json.loads((tmp_path / "port" / "prepare_stats.json").read_text())
            == json.loads((tmp_path / "jax" / "prepare_stats.json").read_text()))


def test_prepare_data_clears_stale_outputs_and_dry_runs_like_jax(tmp_path, monkeypatch, capsys):
    raw = _raw_set(tmp_path / "raw")
    out = tmp_path / "out"
    (out / "train" / "HR").mkdir(parents=True)
    (out / "train" / "HR" / "stale.png").write_bytes(b"x")
    tprep.main(["--input", str(raw), "--output", str(out), "--hr-size", "32", "--lr-size", "8",
                "--max-images", "4"])
    assert "Clearing stale files" in capsys.readouterr().out
    assert not (out / "train" / "HR" / "stale.png").exists()
    argv = ["--input", str(raw), "--output", str(tmp_path / "dry"), "--dry-run"]
    _run_jax_prepare(monkeypatch, argv)
    want = capsys.readouterr().out
    assert tprep.main(argv) == {}
    assert capsys.readouterr().out == want and not (tmp_path / "dry").exists()


def _png16(path: Path) -> None:
    raw = b"".join(b"\x00" + b"\x00\x01" * 6 for _ in range(2))  # 2x2 16-bit RGB

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I",
                                                                       zlib.crc32(kind + body))

    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 16, 2,
                                                                         0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["jpeg", "png16", "palette"])
def test_prepare_data_refuses_what_it_cannot_decode_before_writing(tmp_path, monkeypatch, case):
    """A JPEG, a 16-bit and a palette PNG were refused until the port had
    its decoders: each now goes through the pipeline bitwise as the JAX
    package's. A file the port still cannot decode (a CMYK JPEG) beside it
    is refused by name before anything is written."""
    from PIL import Image

    raw = _raw_set(tmp_path / "raw", n=3)
    rng = np.random.default_rng(5)
    img = cv2.GaussianBlur(rng.integers(0, 256, (72, 88, 3), dtype=np.uint8), (9, 9), 3)
    if case == "jpeg":
        cv2.imwrite(str(raw / "face.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    elif case == "png16":
        _png16(raw / "deep.png")
    else:
        Image.fromarray(img).convert("P").save(raw / "pal.png")
    Image.fromarray(img).convert("CMYK").save(raw / "cmyk.jpg")
    argv = ["--input", str(raw), "--hr-size", "32", "--lr-size", "8", "--train-ratio", "0.5",
            "--val-ratio", "0.25"]
    with pytest.raises(SystemExit, match="cmyk.jpg: CMYK/YCCK JPEG is not decoded"):
        tprep.main(argv + ["--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    (raw / "cmyk.jpg").unlink()
    _run_jax_prepare(monkeypatch, argv + ["--output", str(tmp_path / "jax")])
    assert tprep.main(argv + ["--output", str(tmp_path / "out")]) == {"train": 2, "val": 1,
                                                                      "test": 1}
    names = _split_files(tmp_path / "jax")
    assert _split_files(tmp_path / "out") == names
    for split, files in names.items():
        for sub in ("HR", "LR"):
            for n in files:
                np.testing.assert_array_equal(read_rgb(tmp_path / "out" / split / sub / n),
                                              read_rgb(tmp_path / "jax" / split / sub / n),
                                              err_msg=f"{split}/{sub}/{n}")


def test_prepare_data_refuses_hdf5_and_duplicate_stems(tmp_path):
    """``--hdf5`` with an empty split (4 images: no val) raises as the JAX
    CLI does, where h5py refuses a chunk larger than the dataset; the
    splits before it are packed."""
    raw = _raw_set(tmp_path / "raw", n=4)
    with pytest.raises(ValueError, match="Chunk shape must not be greater than data shape"):
        tprep.main(["--input", str(raw), "--output", str(tmp_path / "h5"), "--hdf5"])
    assert (tmp_path / "h5" / "train.h5").exists() and not (tmp_path / "h5" / "test.h5").exists()
    shutil.copy(raw / "im_00.png", raw / "sub" / "im_00.png")
    with pytest.raises(SystemExit, match="duplicate stems"):
        tprep.main(["--input", str(raw), "--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------------------
# split_data


def _files(root: Path, n: int = 23) -> Path:
    (root / "a").mkdir(parents=True)
    for i in range(n):
        ext = (".png", ".jpg", ".JPEG", ".webp")[i % 4]
        ((root / "a") if i % 5 == 0 else root).joinpath(f"f{i:03d}{ext}").write_bytes(bytes([i]))
    (root / "notes.txt").write_text("skipped")
    return root


@pytest.mark.parametrize("move", [False, True])
def test_split_data_gives_the_jax_scripts_file_sets(tmp_path, move):
    import split_data as jsplit

    src_j, src_t = _files(tmp_path / "in_jax"), _files(tmp_path / "in_port")
    state = random.getstate()
    want = jsplit.split_data(str(src_j), str(tmp_path / "jax"), 0.6, 0.2, 0.1, seed=5, move=move)
    random.setstate(state)
    got = tsplit.split_data(str(src_t), str(tmp_path / "port"), 0.6, 0.2, 0.1, seed=5, move=move)
    assert random.getstate() == state  # the port leaves the global stream alone
    assert got == want == {"train": 15, "val": 5, "test": 3}
    for split in want:
        names = sorted(p.name for p in (tmp_path / "jax" / split).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "port" / split).iterdir())
        for n in names:
            assert (tmp_path / "port" / split / n).read_bytes() == \
                (tmp_path / "jax" / split / n).read_bytes()
    left = sorted(p.name for p in src_t.rglob("*") if p.is_file())
    assert len(left) == (1 if move else 24) and "notes.txt" in left


def test_split_data_refuses_duplicate_basenames(tmp_path):
    src = _files(tmp_path / "in", n=6)
    (src / "a" / "f002.JPEG").write_bytes(b"dup")
    with pytest.raises(ValueError, match="duplicate basenames"):
        tsplit.main(["--input", str(src), "--output", str(tmp_path / "out"), "--move"])
    assert not (tmp_path / "out").exists() and (src / "f002.JPEG").exists()
