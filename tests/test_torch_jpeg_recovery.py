"""The port's JPEG decoder on cut and corrupt files, against cv2 5.0
(libjpeg-turbo 3.1) on the CPU: `codecs.imread` / `imread_numpy` against
``cv2.imread`` (libjpeg's stdio source, which gives a fake EOI where a file
ends, so a cut file decodes with the rest grey), `codecs.imdecode` /
`imdecode_numpy` against ``cv2.imdecode`` (a memory source: a cut file is
None, and an error here); planted faults (an early EOI, a wrong or missing
restart marker, a Huffman code longer than 16 bits); progressive files cut
short, which libjpeg smooths and so does the port; the recovery fixtures
the card checks against; `prepare_data` on a cut JPEG against the JAX
package.

Tolerances: none; every decode is bitwise cv2's. One refusal by name
stands where cv2 returns an image: a cut or corrupt byte whose zero-filled
MCU gives a coefficient past `jpeg.RANGE_LIMIT` (cv2's 16-bit SIMD IDCT
wraps or saturates there); each test counts them and checks the reason.
"""

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from facesr_torch import native
from facesr_torch.data import codecs, jpeg, png

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CODECS = ROOT / "tests" / "fixtures" / "codecs"
RECOVERY = CODECS / "recovery"
sys.path.insert(0, str(CODECS))
import make_codec_fixtures as fx  # noqa: E402

Q, RST = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_RST_INTERVAL
SEQUENTIAL = ["jpeg_420_q90.jpg", "jpeg_restart.jpg", "jpeg_grey.jpg", "jpeg_411_q50.jpg"]


def _rgb(bgr):
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _cv2_read(path: Path):
    return _rgb(cv2.imread(str(path)))


def _cv2_decode(data: bytes):
    return _rgb(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


def _jpg(img: np.ndarray, *flags) -> bytes:
    return cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]), list(flags))[1].tobytes()


def _out_of_range(e: Exception) -> bool:
    return isinstance(e, codecs.UnsupportedImage) and "beyond the decoder's range" in str(e)


def _check(want, fn, arg) -> str:
    """'same' when ``fn(arg)`` is ``want`` bitwise (or raises
    `ImageDecodeError` where ``want`` is None), 'range' for a refusal past
    `RANGE_LIMIT`; anything else fails."""
    try:
        got = fn(arg)
    except codecs.ImageDecodeError as e:
        if want is None:
            return "same"
        assert _out_of_range(e), f"{fn.__name__}: {e} where cv2 decodes"
        return "range"
    assert want is not None, f"{fn.__name__} decodes where cv2 returns None"
    assert got.shape == want.shape and np.array_equal(got, want), \
        f"{fn.__name__}: {int((got != want).sum())} values differ"
    return "same"


def _scan_start(data: bytes) -> int:
    return int(jpeg.parse(data).scans[0][17])


# ---------------------------------------------------------------------------
# cut files: imread patches them, imdecode raises


@pytest.mark.parametrize("name", SEQUENTIAL)
def test_imread_equals_cv2_imread_at_every_cut_inside_the_scan(tmp_path, name):
    """Native at every offset from three bytes before the entropy data to
    the last byte; plain at 12 seeded offsets."""
    data = (CODECS / name).read_bytes()
    start = _scan_start(data)
    cuts = range(start - 3, len(data))
    sample = set(np.random.default_rng(len(name)).choice(list(cuts), 12, replace=False).tolist())
    seen = {"same": 0, "range": 0}
    path = tmp_path / "cut.jpg"
    for cut in cuts:
        path.write_bytes(data[:cut])
        want = _cv2_read(path)
        assert want is not None, cut  # libjpeg patches every one of them
        seen[_check(want, codecs.imread, path)] += 1
        if cut in sample:
            assert _check(want, codecs.imread_numpy, path) == "same" or \
                _check(want, codecs.imread, path) == "range"
    print(name, seen)
    assert seen["range"] <= len(cuts) // 100  # a rare cut; its reason is checked
    assert seen["same"] >= len(cuts) - len(cuts) // 100


@pytest.mark.parametrize("name", SEQUENTIAL)
def test_imdecode_still_raises_where_cv2_imdecode_returns_none(name):
    data = (CODECS / name).read_bytes()
    start = _scan_start(data)
    rng = np.random.default_rng(1)
    for cut in list(range(start - 3, len(data), 7)) + [len(data) - 2, len(data) - 1]:
        assert _cv2_decode(data[:cut]) is None, cut
        fns = (codecs.imdecode, codecs.imdecode_numpy) if rng.random() < 0.2 else \
            (codecs.imdecode,)
        for fn in fns:
            with pytest.raises(codecs.ImageDecodeError, match="cut.jpg: truncated"):
                fn(data[:cut], "cut.jpg")


def test_a_face_cut_at_half_reads_grey_below_the_cut(tmp_path):
    data = (CODECS / "face_256_q95_420.jpg").read_bytes()
    (tmp_path / "half.jpg").write_bytes(data[:len(data) // 2])
    want = _cv2_read(tmp_path / "half.jpg")
    assert want.shape == (256, 256, 3) and (want[-127:] == 128).all()
    for fn in (codecs.imread, codecs.imread_numpy):
        np.testing.assert_array_equal(fn(tmp_path / "half.jpg"), want)
    with pytest.raises(codecs.ImageDecodeError, match="truncated"):
        codecs.imdecode(data[:len(data) // 2])


def test_a_cut_past_the_range_is_refused_by_name(tmp_path):
    """jpeg_420_q90.jpg cut at byte 849: zero bits finish the MCU in
    progress with a coefficient of -127 (x 20), and the first IDCT pass
    reaches past 8191, where cv2's 16-bit SIMD lanes leave exact arithmetic;
    the port refuses that file by name."""
    data = (CODECS / "jpeg_420_q90.jpg").read_bytes()
    (tmp_path / "c.jpg").write_bytes(data[:849])
    assert _cv2_read(tmp_path / "c.jpg") is not None
    for fn in (codecs.imread, codecs.imread_numpy):
        with pytest.raises(codecs.UnsupportedImage, match="c.jpg: an IDCT value beyond"):
            fn(tmp_path / "c.jpg")
    p = jpeg.parse(jpeg.file_bytes(data[:849]))
    coef = native.jpeg_entropy(jpeg.file_bytes(data[:849]), p.frame, p.comps, p.scans, p.huff)
    assert np.abs(coef).max() == 127


# ---------------------------------------------------------------------------
# planted faults: both cv2 entry points patch them, and so does the port


def _restart_file(seed: int, interval: int) -> bytes:
    return _jpg(fx.smooth(np.random.default_rng(seed), 37 + seed % 7, 53), Q, 90, RST, interval)


def _markers(data: bytes):
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]


def _same_both_ways(data: bytes, tmp_path: Path, plain: bool = True) -> str:
    want = _cv2_decode(data)
    (tmp_path / "f.jpg").write_bytes(data)
    assert want is not None
    np.testing.assert_array_equal(_cv2_read(tmp_path / "f.jpg"), want)
    fns = (codecs.imdecode, codecs.imdecode_numpy) if plain else (codecs.imdecode,)
    seen = {_check(want, fn, data) for fn in fns}
    seen.add(_check(want, codecs.imread, tmp_path / "f.jpg"))
    assert len(seen) == 1
    return seen.pop()


@pytest.mark.parametrize("shift", range(1, 8))
def test_a_wrong_restart_marker_equals_cv2(tmp_path, shift):
    """RSTn replaced by RST(n + shift): +1, +2 keep the marker for later,
    -1, -2 (7, 6) skip to the next one, the others drop it
    (``jpeg_resync_to_restart``'s three actions)."""
    for seed in range(6):
        data = _restart_file(seed, 1 + seed % 3)
        for k in (0, 2, len(_markers(data)) - 1):
            at = _markers(data)[k]
            bad = data[:at + 1] + bytes([0xD0 + (data[at + 1] - 0xD0 + shift) % 8]) + \
                data[at + 2:]
            assert _same_both_ways(bad, tmp_path, plain=seed < 2) == "same"


def test_missing_restart_markers_equal_cv2(tmp_path):
    for seed in range(8):
        data = _restart_file(seed, 1 + seed % 3)
        marks = _markers(data)
        for drop in ([marks[1]], [marks[0], marks[-1]], marks[2:5]):
            bad = data
            for at in sorted(drop, reverse=True):
                bad = bad[:at] + bad[at + 2:]
            assert _same_both_ways(bad, tmp_path, plain=seed < 2) == "same"


@pytest.mark.parametrize("restart", [0, 2])
def test_an_early_eoi_inside_the_scan_equals_cv2(tmp_path, restart):
    rng = np.random.default_rng(restart)
    for seed in range(10):
        img = fx.smooth(np.random.default_rng(seed), 48, 40)
        data = _jpg(img, Q, 85, RST, restart) if restart else _jpg(img, Q, 85)
        start = _scan_start(data)
        at = int(rng.integers(start + 1, len(data) - 2))
        if data[at - 1] == 0xFF:
            at += 1
        seen = _same_both_ways(data[:at] + b"\xff\xd9", tmp_path, plain=seed < 3)
        assert seen == "same" or seen == "range"


def test_huffman_codes_longer_than_16_bits_decode_as_zero_as_in_cv2(tmp_path):
    """Three stuffed FF bytes (24 one bits, which no code is) planted in
    the entropy data, at many places; the decoder takes 17 bits and a 0."""
    data = (CODECS / "jpeg_420_q90.jpg").read_bytes()
    start, end = _scan_start(data), data.rindex(b"\xff\xd9")
    counts = {"same": 0, "range": 0}
    for at in range(start + 5, end - 8, 11):
        if data[at - 1] == 0xFF:
            continue
        counts[_same_both_ways(data[:at] + b"\xff\x00" * 3 + data[at + 3:], tmp_path,
                               plain=at % 5 == 0)] += 1
    print(counts)  # the ones read as values are large: a share is past the range
    assert counts["same"] >= 20


def test_corrupt_bytes_in_the_scan_equal_cv2_or_are_refused_past_the_range(tmp_path):
    """Seeded byte flips in the entropy data (never making a marker):
    cv2's patched image, or a refusal past `RANGE_LIMIT` (counted)."""
    rng = np.random.default_rng(5)
    counts = {"same": 0, "range": 0}
    for seed in range(20):
        data = bytearray(_restart_file(seed, seed % 3))
        start = _scan_start(bytes(data))
        for _ in range(3):
            at = int(rng.integers(start + 1, len(data) - 3))
            v = int(rng.integers(0, 255))
            if 0xFF in (data[at - 1], data[at], v):
                continue
            bad = data.copy()
            bad[at] = v
            counts[_same_both_ways(bytes(bad), tmp_path, plain=seed < 3)] += 1
    print(counts)
    assert counts["same"] >= 40


# ---------------------------------------------------------------------------
# progressive files cut short


def test_progressive_fixtures_cut_at_every_offset_equal_cv2_imread(tmp_path):
    """A progressive file cut before its low coefficients are refined is
    one libjpeg smooths (``decompress_smooth_data``: estimates from the 5x5
    blocks' DC values, for rows past the cut from the bits before the last
    scan); the port smooths it bitwise. Native at every offset, plain at
    every 9th."""
    for name in ("jpeg_progressive.jpg", "jpeg_progressive_pil_422.jpg"):
        data = (CODECS / name).read_bytes()
        counts = {"same": 0, "smoothed": 0}
        for cut in range(_scan_start(data) - 3, len(data)):
            (tmp_path / "p.jpg").write_bytes(data[:cut])
            want = _cv2_read(tmp_path / "p.jpg")
            fns = (codecs.imread, codecs.imread_numpy) if cut % 9 == 0 else (codecs.imread,)
            for fn in fns:
                assert _check(want, fn, tmp_path / "p.jpg") == "same", (name, cut)
            if want is not None:
                p = jpeg.parse(jpeg.file_bytes(data[:cut]))
                counts["smoothed" if p.smooth is not None else "same"] += 1
        print(name, counts)
        assert counts["smoothed"] > 0.6 * (counts["same"] + counts["smoothed"])


def _progressive(seed: int) -> bytes:
    """Progressive files of many shapes: cv2's (4:2:0, with and without
    restart intervals, grey) and PIL's (4:4:4, 4:2:2, 4:2:0); one and two
    blocks wide among them (the smoothing window clamps at the edges)."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    if seed % 4 == 0:
        w = int(rng.integers(9, 17))  # a plane two blocks wide
    img = fx.smooth(rng, max(h, 6), max(w, 6))[:h, :w]
    kind = seed % 6
    if kind == 0:
        return _jpg(img, Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    if kind == 1:
        return _jpg(img, Q, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, RST, 1 + seed % 3)
    if kind == 2:
        return cv2.imencode(".jpg", np.ascontiguousarray(img[..., 0]),
                            [Q, 85, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    import io

    from PIL import Image

    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "JPEG", quality=80, progressive=True, subsampling=kind - 3)
    return bio.getvalue()


@pytest.mark.parametrize("seeds", [range(0, 12), range(12, 24)])
def test_progressive_files_of_many_shapes_cut_short_equal_cv2_imread(tmp_path, seeds):
    counts = {"same": 0, "range": 0}
    for seed in seeds:
        data = _progressive(seed)
        start = _scan_start(data)
        cuts = np.random.default_rng(seed).integers(start, len(data), 12)
        for i, cut in enumerate(cuts.tolist()):
            (tmp_path / "p.jpg").write_bytes(data[:cut])
            want = _cv2_read(tmp_path / "p.jpg")
            counts[_check(want, codecs.imread, tmp_path / "p.jpg")] += 1
            if i % 4 == 0:
                _check(want, codecs.imread_numpy, tmp_path / "p.jpg")
    print(counts)
    assert counts["same"] >= 0.95 * (counts["same"] + counts["range"])


def test_refusal_passes_a_progressive_file_cut_short(tmp_path):
    """`prepare_data`'s header check keeps what the port now decodes."""
    data = (CODECS / "jpeg_progressive.jpg").read_bytes()
    (tmp_path / "p.jpg").write_bytes(data[:int(len(data) * 0.6)])
    assert codecs.refusal(tmp_path / "p.jpg") is None
    assert jpeg.parse(jpeg.file_bytes(data[:int(len(data) * 0.6)])).smooth is not None


# ---------------------------------------------------------------------------
# the fixtures the card checks, and prepare_data


RECOVERY_DIGESTS = json.loads((RECOVERY / "digests.json").read_text())


def test_the_recovery_fixtures_are_what_their_script_writes():
    files = fx.recovery_fixtures(fx.fixtures())
    assert sorted(files) == sorted(RECOVERY_DIGESTS)
    for name, data in files.items():
        assert (RECOVERY / name).read_bytes() == data, name
    assert sum(len(d) for d in files.values()) < 64 * 1024


@pytest.mark.parametrize("name", sorted(RECOVERY_DIGESTS))
def test_recovery_digests_are_cv2s_and_the_ports(name):
    data = (RECOVERY / name).read_bytes()
    d = RECOVERY_DIGESTS[name]
    assert fx.cv2_read_digest(data) == d["imread"]
    assert fx.cv2_digest_or_none(data) == d["imdecode"]

    def digest(img):
        return {"shape": list(img.shape),
                "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()}

    for fn in (codecs.imread, codecs.imread_numpy):
        assert digest(fn(RECOVERY / name)) == d["imread"], fn.__name__
    for fn in (codecs.imdecode, codecs.imdecode_numpy):
        if d["imdecode"] is None:
            with pytest.raises(codecs.ImageDecodeError, match="truncated"):
                fn(data, name)
        else:
            assert digest(fn(data, name)) == d["imdecode"], fn.__name__


def test_prepare_data_keeps_a_cut_jpeg_as_the_jax_cli_does(tmp_path, monkeypatch):
    from facesr.data import prepare_data as jprep
    from facesr_torch.data import prepare_data as tprep

    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(6):
        img = fx.smooth(np.random.default_rng(40 + i), 90, 100)
        data = _jpg(img, Q, 90)
        if i == 2:
            data = data[:_scan_start(data) + (len(data) - _scan_start(data)) // 2]
        (raw / f"f{i}.jpg").write_bytes(data)
    (raw / "g.jpg").write_bytes(_jpg(fx.smooth(np.random.default_rng(9), 64, 64), Q, 90)[:200])
    argv = ["--input", str(raw), "--hr-size", "64", "--lr-size", "16", "--train-ratio", "0.5",
            "--val-ratio", "0.25"]
    monkeypatch.setattr(sys, "argv", ["prepare_data.py", *argv, "--output",
                                      str(tmp_path / "jax")])
    jprep.main()
    stats = tprep.main(argv + ["--output", str(tmp_path / "port")])
    assert sum(stats.values()) == 6  # the cut JPEG kept, the one cut in its header skipped
    assert json.loads((tmp_path / "jax" / "prepare_stats.json").read_text())["stats"] == stats
    found = 0
    for split in ("train", "val", "test"):
        for sub in ("HR", "LR"):
            names = sorted(p.name for p in (tmp_path / "jax" / split / sub).iterdir())
            assert sorted(p.name for p in (tmp_path / "port" / split / sub).iterdir()) == names
            found += "f2.png" in names
            for n in names:
                np.testing.assert_array_equal(
                    png.read_rgb(tmp_path / "port" / split / sub / n),
                    png.read_rgb(tmp_path / "jax" / split / sub / n), err_msg=f"{split}/{n}")
    assert found == 2
