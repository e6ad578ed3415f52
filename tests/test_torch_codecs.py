"""The port's image decoders (`facesr_torch.data.codecs`: JPEG, PNG, BMP,
TIFF) against ``cv2.imread`` / ``cv2.imdecode`` + ``BGR2RGB`` on the CPU,
on files that cv2 and PIL write and on hand-built ones; their refusals;
the entry points that read images against the JAX package; the fixtures
the card checks against.

Tolerances: none. Every decode is compared bitwise with cv2, for the native
decoder (C++ `jpeg_decode` and `png_unfilter`) and for the plain one
(`codecs.imdecode_numpy`). The entry points' outputs (the dataset's
samples, `prepare_data`'s PNGs) are compared bitwise with the JAX
package's.
"""

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from facesr_torch import native
from facesr_torch.data import bmp, codecs, jpeg, png, tiff
from facesr_torch.parallel.mesh import NotPorted

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "codecs"
sys.path.insert(0, str(FIXTURES))
import make_codec_fixtures as fx  # noqa: E402

Q, SF = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _cv2(data: bytes):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _same_as_cv2(data: bytes, name: str = "x") -> None:
    want = _cv2(data)
    assert want is not None, f"{name}: cv2 cannot read it"
    for fn in (codecs.imdecode, codecs.imdecode_numpy):
        got = fn(data, name)
        assert got.dtype == np.uint8 and got.shape == want.shape, (fn.__name__, got.shape)
        differ = int((got != want).sum())
        assert differ == 0, f"{name} {fn.__name__}: {differ} values differ"


def _smooth(seed: int, h: int, w: int) -> np.ndarray:
    return fx.smooth(np.random.default_rng(seed), h, w)


def _jpg(img: np.ndarray, *flags) -> bytes:
    return cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]), list(flags))[1].tobytes()


def _pil(img, fmt: str, **kw) -> bytes:
    bio = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(bio, fmt, **kw)
    return bio.getvalue()


# ---------------------------------------------------------------------------
# JPEG


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_jpeg_quality_and_sampling(quality, sampling):
    img = _smooth(quality + len(sampling), 37, 53)
    _same_as_cv2(_jpg(img, Q, quality, SF, SAMPLING[sampling]), f"q{quality} {sampling}")


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (7, 13), (8, 8), (16, 17), (37, 53),
                                 (255, 257)])
@pytest.mark.parametrize("sampling", ["420", "422", "444"])
def test_jpeg_odd_sizes(h, w, sampling):
    """Planes at most 2 samples wide box-replicate; the edges replicate."""
    img = _smooth(h * w, h, w) if min(h, w) > 4 else \
        np.random.default_rng(h).integers(0, 256, (h, w, 3), dtype=np.uint8)
    _same_as_cv2(_jpg(img, Q, 95, SF, SAMPLING[sampling]), f"{h}x{w} {sampling}")


@pytest.mark.parametrize("sampling", ["444", "420", "411"])
def test_jpeg_noise_at_q100(sampling):
    """Noise at q100 drives the IDCT to and past 0 and 255."""
    img = np.random.default_rng(7).integers(0, 256, (48, 40, 3), dtype=np.uint8)
    _same_as_cv2(_jpg(img, Q, 100, SF, SAMPLING[sampling]), sampling)


@pytest.mark.parametrize("case", ["grey", "grey_progressive", "progressive",
                                  "progressive_restart", "restart1", "restart3",
                                  "pil_progressive_444", "pil_progressive_422",
                                  "pil_progressive_420", "pil_optimize", "pil_grey",
                                  "pil_rgb_adobe", "no_dht"])
def test_jpeg_variants(case):
    img = _smooth(3, 45, 61)
    grey = np.ascontiguousarray(img[..., 0])
    if case == "grey":
        data = cv2.imencode(".jpg", grey, [Q, 90])[1].tobytes()
    elif case == "grey_progressive":
        data = cv2.imencode(".jpg", grey, [Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    elif case == "progressive":
        data = _jpg(img, Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    elif case == "progressive_restart":
        data = _jpg(img, Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    elif case.startswith("restart"):
        data = _jpg(img, Q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, int(case[-1]))
        assert b"\xff\xd0" in data
    elif case.startswith("pil_progressive"):
        sub = {"444": 0, "422": 1, "420": 2}[case[-3:]]
        data = _pil(img, "JPEG", quality=85, subsampling=sub, progressive=True)
    elif case == "pil_optimize":
        data = _pil(img, "JPEG", quality=85, optimize=True)
    elif case == "pil_grey":
        data = _pil(grey, "JPEG", quality=70)
    elif case == "pil_rgb_adobe":
        data = _pil(img, "JPEG", quality=90, keep_rgb=True)
        assert b"Adobe" in data  # transform 0: RGB, no conversion
    else:  # a Motion-JPEG frame: the standard tables, no DHT (libjpeg preloads them)
        data = _strip_dht(_jpg(img, Q, 80))
        assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
    _same_as_cv2(data, case)


def _strip_dht(data: bytes) -> bytes:
    out, pos = data[:2], 2
    while data[pos + 1] != 0xDA:
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return out + data[pos:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation(orientation):
    ex = Image.Exif()
    ex[0x0112] = orientation
    data = _pil(_smooth(orientation, 37, 53), "JPEG", quality=85, exif=ex)
    _same_as_cv2(data, f"orientation {orientation}")


def test_native_and_plain_entropy_decoders_give_the_same_coefficients():
    for data in (_jpg(_smooth(1, 40, 56), Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                      cv2.IMWRITE_JPEG_RST_INTERVAL, 3),
                 _pil(_smooth(2, 33, 30), "JPEG", quality=60, subsampling=1, progressive=True)):
        p = jpeg.parse(data)
        a = native.jpeg_entropy(data, p.frame, p.comps, p.scans, p.huff)
        b = native.jpeg_entropy_numpy(data, p.frame, p.comps, p.scans, p.huff)
        assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)
        r = native.jpeg_reconstruct(a, p.comps, p.qts, p.width, p.height, p.color)
        assert np.array_equal(r, native.jpeg_reconstruct_numpy(a, p.comps, p.qts, p.width,
                                                               p.height, p.color))


def _scan_ends(data: bytes):
    """The offsets just past every scan's entropy data (at its terminating
    marker)."""
    p = jpeg.parse(data)
    return [int(s[18]) for s in p.scans]


@pytest.mark.parametrize("cut", ["header", "first_scan", "before_eoi", "half_eoi"])
def test_truncated_jpeg_raises_with_its_name(cut):
    data = _jpg(_smooth(4, 37, 53), Q, 90)
    at = {"header": 100, "first_scan": len(data) // 2, "before_eoi": len(data) - 2,
          "half_eoi": len(data) - 1}[cut]
    assert _cv2(data[:at]) is None
    for fn in (codecs.imdecode, codecs.imdecode_numpy):
        with pytest.raises(codecs.ImageDecodeError, match="cut.jpg") as e:
            fn(data[:at], "cut.jpg")
        assert not isinstance(e.value, NotPorted)


def test_corrupt_entropy_data_and_restart_markers_raise():
    """libjpeg only warns on a wrong restart marker and on an early EOI
    inside a scan, and cv2 returns a patched image: the port gives that
    image bitwise. An undefined Huffman table still raises."""
    data = bytearray(_jpg(_smooth(5, 37, 53), Q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 1))
    rst = data.index(b"\xff\xd1")
    bad = bytes(data[:rst + 1] + b"\xd5" + data[rst + 2:])  # RST5 where RST1 belongs
    _same_as_cv2(bad, "bad.jpg")
    # an early EOI inside the scan: the data ends inside an MCU
    end = _scan_ends(bytes(data))[0]
    short = bytes(data[:end - 40]) + b"\xff\xd9"
    _same_as_cv2(short, "short.jpg")
    # an undefined Huffman table
    bad = bytearray(_jpg(_smooth(5, 37, 53), Q, 90))
    sos = bad.index(b"\xff\xda")
    bad[sos + 6] = 0x33
    with pytest.raises(jpeg.JPEGError, match="undefined Huffman table 3"):
        codecs.imdecode(bytes(bad), "t.jpg")


def _patch_sof(data: bytes, marker: int = None, precision: int = None) -> bytes:
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def _unrefined_progressive() -> bytes:
    """A progressive file cut after its first AC scans: the low
    coefficients stay at Al > 0 (libjpeg smooths such blocks)."""
    data = _jpg(_smooth(6, 37, 53), Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    ends = _scan_ends(data)
    return data[:ends[4]] + b"\xff\xd9"


@pytest.mark.parametrize("case,what", [
    ("cmyk", "CMYK/YCCK"), ("arithmetic", "arithmetic-coded"), ("lossless", "lossless"),
    ("12bit", "12-bit"), ("unrefined", "not refined to full precision"),
    ("range", "beyond the decoder's range")])
def test_jpeg_refusals_raise_not_ported_by_name(case, what):
    img = _smooth(7, 32, 40)
    base = _jpg(img, Q, 90)
    if case == "cmyk":
        data = _pil(Image.fromarray(img).convert("CMYK"), "JPEG")
    elif case == "arithmetic":
        data = _patch_sof(base, marker=0xC9)
    elif case == "lossless":
        data = _patch_sof(base, marker=0xC3)
    elif case == "12bit":
        data = _patch_sof(base, precision=12)
    elif case == "unrefined":
        # no longer a refusal: libjpeg smooths such a file's blocks
        # (decompress_smooth_data), and the port does as it does, bitwise
        _same_as_cv2(_unrefined_progressive(), "unrefined.jpg")
        return
    else:
        # a flat white q100 image with its DC quantiser raised 5x: the IDCT
        # reaches 635, past the range where cv2's 16-bit SIMD IDCT and exact
        # arithmetic agree
        white = _jpg(np.full((16, 16, 3), 255, np.uint8), Q, 100)
        at = white.index(b"\xff\xdb") + 5
        data = white[:at] + b"\x05" + white[at + 1:]
        assert _cv2(data) is not None
    for fn in (codecs.imdecode, codecs.imdecode_numpy):
        with pytest.raises(NotPorted, match=f"{case}.jpg: .*{what}"):
            fn(data, f"{case}.jpg")


def test_a_failed_jpeg_build_raises(tmp_path, monkeypatch):
    (tmp_path / "jpeg_decode.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed to build jpeg_decode"):
        codecs.imdecode(_jpg(_smooth(8, 8, 8), Q, 90))


# ---------------------------------------------------------------------------
# PNG


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_16_bit_reads_as_the_high_byte(channels):
    rng = np.random.default_rng(channels)
    samples = rng.integers(0, 65536, (11, 19, channels))
    data = fx.png_bytes(samples, 16, {1: 0, 2: 4, 3: 2, 4: 6}[channels], filters=(0, 1))
    _same_as_cv2(data, f"16-bit x{channels}")
    assert np.array_equal(png.decode(data), (samples >> 8).astype(np.uint8))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_png_palette(depth):
    rng = np.random.default_rng(depth)
    n = 1 << depth
    pal = rng.integers(0, 256, (n, 3))
    data = fx.png_bytes(rng.integers(0, n, (9, 23, 1)), depth, 3, palette=pal)
    _same_as_cv2(data, f"palette {depth}")


@pytest.mark.parametrize("case", ["pil_P", "pil_1", "pil_L", "pil_LA", "pil_P_trns",
                                  "short_palette"])
def test_png_pil_files_and_palette_edges(case):
    img = _smooth(9, 37, 53)
    if case == "short_palette":  # indices past a 2-entry table read black
        data = fx.png_bytes(np.random.default_rng(0).integers(0, 4, (5, 7, 1)), 2, 3,
                            palette=np.array([[10, 20, 30], [200, 100, 50]]))
    elif case == "pil_P_trns":
        data = _pil(Image.fromarray(img).convert("P"), "PNG", transparency=3)
    else:
        data = _pil(Image.fromarray(img).convert(case[4:]), "PNG")
    _same_as_cv2(data, case)


@pytest.mark.parametrize("depth", [1, 2, 4, 16])
def test_png_grey_low_and_high_depths(depth):
    rng = np.random.default_rng(depth)
    _same_as_cv2(fx.png_bytes(rng.integers(0, 1 << depth, (13, 21, 1)), depth, 0,
                              filters=(1, 0)), f"grey {depth}")


@pytest.mark.parametrize("h,w,depth,ctype,channels", [
    (21, 29, 8, 2, 3), (21, 29, 8, 0, 1), (13, 17, 16, 6, 4), (9, 11, 1, 0, 1),
    (1, 1, 8, 2, 3), (3, 2, 8, 4, 2), (10, 6, 4, 3, 1), (8, 8, 16, 0, 1)])
def test_png_adam7(h, w, depth, ctype, channels):
    rng = np.random.default_rng(h * w)
    top = 1 << depth
    samples = rng.integers(0, top, (h, w, channels))
    pal = rng.integers(0, 256, (16, 3)) if ctype == 3 else None
    data = fx.png_bytes(samples, depth, ctype, interlace=True, palette=pal, filters=(1, 0))
    _same_as_cv2(data, f"adam7 {h}x{w} d{depth} c{ctype}")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation(orientation):
    ex = Image.Exif()
    ex[0x0112] = orientation
    _same_as_cv2(_pil(_smooth(orientation, 21, 34), "PNG", exif=ex), f"eXIf {orientation}")


# ---------------------------------------------------------------------------
# BMP


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_pil_files(mode):
    _same_as_cv2(_pil(Image.fromarray(_smooth(11, 37, 53)).convert(mode), "BMP"), mode)


@pytest.mark.parametrize("case", ["4bit", "4bit_topdown", "4bit_5_colours", "8bit_v5",
                                  "16_rgb", "16_555", "16_565", "16_565_v4", "16_565_v5_topdown",
                                  "24_topdown", "24_v5", "32_rgb", "32_bitfields",
                                  "32_bitfields_v5"])
def test_bmp_hand_built(case):
    rng = np.random.default_rng(len(case))
    w, h = 13, 7
    td = "topdown" in case
    hdr = 124 if "v5" in case else 108 if "v4" in case else 40
    if case.startswith("4bit") or case.startswith("8bit"):
        bits = 4 if case.startswith("4") else 8
        pal = rng.integers(0, 256, (1 << bits, 4), dtype=np.uint8).tobytes()
        if case == "4bit_5_colours":
            pal = pal[:20]
        idx = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
        data = fx.bmp_bytes([fx._pack_row(r, bits) for r in idx], w, h, bits, palette=pal,
                            header=hdr, top_down=td)
        if case == "4bit_5_colours":  # biClrUsed = 5: indices past it read black
            data = data[:46] + struct.pack("<I", 5) + data[50:]
    elif case.startswith("16"):
        px = rng.integers(0, 65536, (h, w)).astype("<u2")
        masks = {"555": (0x7C00, 0x03E0, 0x001F)}.get(case[3:6], (0xF800, 0x07E0, 0x001F))
        comp = 0 if case == "16_rgb" else 3
        data = fx.bmp_bytes([r.tobytes() for r in px], w, h, 16, comp=comp,
                            masks=masks if comp else None, header=hdr, top_down=td)
    else:
        c = 3 if case.startswith("24") else 4
        px = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        comp = 3 if "bitfields" in case else 0
        data = fx.bmp_bytes([r.tobytes() for r in px], w, h, 8 * c, comp=comp,
                            masks=(0xFF0000, 0xFF00, 0xFF) if comp else None, header=hdr,
                            top_down=td)
    _same_as_cv2(data, case)


def test_bmp_refusals_and_corrupt_files():
    w, h = 13, 7
    rle = fx.bmp_bytes([b"\0" * w] * h, w, h, 8, comp=1, palette=bytes(1024))
    assert _cv2(rle) is not None
    with pytest.raises(NotPorted, match="rle.bmp: RLE8"):
        codecs.imdecode(rle, "rle.bmp")
    odd = fx.bmp_bytes([bytes(4 * w)] * h, w, h, 32, comp=3, masks=(0xFF, 0xFF00, 0xFF0000),
                       header=124)
    with pytest.raises(NotPorted, match="odd.bmp: 32-bit BMP with bit masks"):
        codecs.imdecode(odd, "odd.bmp")
    good = fx.bmp_bytes([bytes(3 * w)] * h, w, h, 24)
    assert _cv2(good[:-10]) is None
    with pytest.raises(bmp.BMPError, match="short.bmp: truncated"):
        codecs.imdecode(good[:-10], "short.bmp")


# ---------------------------------------------------------------------------
# TIFF


@pytest.mark.parametrize("compression", [None, "packbits", "tiff_lzw", "tiff_deflate",
                                         "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA"])
def test_tiff_compressions_and_modes(compression, mode):
    img = _smooth(12, 37, 53)
    if mode in ("RGBA", "LA"):  # unassociated alpha: libtiff premultiplies it
        arr = np.array(Image.fromarray(img).convert(mode))
        arr[..., -1] = np.random.default_rng(1).integers(0, 256, arr.shape[:2])
        pimg = Image.fromarray(arr, mode)
    else:
        pimg = Image.fromarray(img).convert(mode)
    _same_as_cv2(_pil(pimg, "TIFF", compression=compression), f"{mode} {compression}")


@pytest.mark.parametrize("compression", ["tiff_lzw", "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_tiff_predictor_2(compression, mode):
    data = _pil(Image.fromarray(_smooth(13, 64, 48)).convert(mode), "TIFF",
                compression=compression, tiffinfo={317: 2})
    _same_as_cv2(data, f"predictor 2 {compression}")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_both_byte_orders(orientation):
    ex = Image.Exif()
    ex[0x0112] = orientation
    img = _smooth(orientation, 21, 34)
    _same_as_cv2(_pil(img, "TIFF", exif=ex), f"II orientation {orientation}")
    _same_as_cv2(fx.tiff_be_bytes(img, orientation), f"MM orientation {orientation}")


def test_tiff_multiple_strips_and_lzw_code_widths():
    """A 200x180 noise image: LZW's table passes 511, 1023 and 2047
    entries, with Clear codes; rows across several strips."""
    img = np.random.default_rng(3).integers(0, 256, (200, 180, 3), dtype=np.uint8)
    data = _pil(img, "TIFF", compression="tiff_lzw")
    _same_as_cv2(data, "lzw noise")
    _same_as_cv2(_pil(img, "TIFF", compression="packbits"), "packbits noise")


@pytest.mark.parametrize("case,what", [("jpeg", "compression 7"),
                                       ("palette", "photometric interpretation 3"),
                                       ("16bit", "16-bit samples"),
                                       ("bigtiff", "BigTIFF")])
def test_tiff_refusals(tmp_path, case, what):
    img = _smooth(14, 24, 32)
    if case == "jpeg":
        data = _pil(img, "TIFF", compression="jpeg")
    elif case == "palette":
        data = _pil(Image.fromarray(img).convert("P"), "TIFF")
    elif case == "16bit":
        data = cv2.imencode(".tiff", img.astype(np.uint16) * 257)[1].tobytes()
    else:
        data = b"II+\x00\x08\x00\x00\x00" + bytes(16)
    if case != "bigtiff":
        assert _cv2(data) is not None
    with pytest.raises(NotPorted, match=f"{case}.tif: .*{what}"):
        codecs.imdecode(data, f"{case}.tif")
    (tmp_path / f"{case}.tif").write_bytes(data)
    assert what in codecs.refusal(tmp_path / f"{case}.tif")


def test_truncated_tiff_raises():
    data = _pil(_smooth(15, 24, 32), "TIFF")
    assert _cv2(data[:len(data) // 2]) is None
    with pytest.raises(tiff.TIFFError, match="t.tif: truncated"):
        codecs.imdecode(data[:len(data) // 2], "t.tif")


# ---------------------------------------------------------------------------
# the signature, not the extension; other formats


def test_the_decoder_is_picked_by_signature(tmp_path):
    img = _smooth(16, 20, 24)
    (tmp_path / "a.jpg").write_bytes(png.encode(img))
    (tmp_path / "b.png").write_bytes(_jpg(img, Q, 90))
    for name in ("a.jpg", "b.png"):
        want = cv2.cvtColor(cv2.imread(str(tmp_path / name)), cv2.COLOR_BGR2RGB)
        assert np.array_equal(codecs.imread(tmp_path / name), want)
        assert np.array_equal(codecs.imread_numpy(tmp_path / name), want)
    with pytest.raises(codecs.ImageDecodeError, match="missing.png"):
        codecs.imread(tmp_path / "missing.png")


@pytest.mark.parametrize("fmt,what", [("WEBP", "WebP"), ("GIF", "GIF"),
                                      ("JPEG2000", "JPEG 2000"), ("PPM", "PNM")])
def test_other_formats_cv2_reads_raise_not_ported(tmp_path, fmt, what):
    data = _pil(_smooth(17, 20, 24), fmt)
    assert _cv2(data) is not None
    with pytest.raises(NotPorted, match=f"x.{fmt.lower()}: {what}"):
        codecs.imdecode(data, f"x.{fmt.lower()}")
    (tmp_path / "f").write_bytes(data)
    assert what in codecs.refusal(tmp_path / "f")


def test_unknown_bytes_are_a_decode_error():
    assert _cv2(b"hello, world") is None
    with pytest.raises(codecs.ImageDecodeError, match="x: not an image") as e:
        codecs.imdecode(b"hello, world", "x")
    assert not isinstance(e.value, NotPorted)


# ---------------------------------------------------------------------------
# the fixtures the card checks


DIGESTS = json.loads((FIXTURES / "digests.json").read_text())


def test_the_fixtures_are_what_their_script_writes_and_small():
    files = fx.fixtures()
    assert sorted(files) == sorted(DIGESTS)
    for name, data in files.items():
        assert (FIXTURES / name).read_bytes() == data, name
    assert sum(p.stat().st_size for p in FIXTURES.iterdir() if p.is_file()) < 512 * 1024


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests_are_cv2s_and_the_ports(name):
    data = (FIXTURES / name).read_bytes()
    assert fx.cv2_digest(data) == DIGESTS[name]
    decoders = (codecs.imdecode,) if name.startswith("face_") else (codecs.imdecode,
                                                                      codecs.imdecode_numpy)
    for fn in decoders:
        img = fn(data, name)
        assert list(img.shape) == DIGESTS[name]["shape"]
        assert hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() == \
            DIGESTS[name]["sha256"], fn.__name__


# ---------------------------------------------------------------------------
# entry points against the JAX package


@pytest.mark.parametrize("ext", [".jpg", ".bmp", ".tiff_as_png"])
def test_dataset_samples_on_jpeg_and_bmp_folders_match_jax(tmp_path, ext):
    from facesr.data.dataset import FFHQDataset as JaxDataset
    from facesr_torch.data.dataset import FFHQDataset

    root = tmp_path / "d"
    for sub in ("HR", "LR"):
        (root / sub).mkdir(parents=True)
    for i in range(3):
        hr = _smooth(20 + i, 48, 48)
        for sub, img in (("HR", hr), ("LR", cv2.resize(hr, (12, 12),
                                                      interpolation=cv2.INTER_AREA))):
            if ext == ".jpg":
                (root / sub / f"f{i}.jpg").write_bytes(_jpg(img, Q, 85 + i))
            elif ext == ".bmp":
                (root / sub / f"f{i}.bmp").write_bytes(_pil(img, "BMP"))
            else:  # a TIFF named .png: read by its signature, as cv2 does
                (root / sub / f"f{i}.png").write_bytes(_pil(img, "TIFF",
                                                            compression="tiff_lzw"))
    for mode in ("train", "val"):
        kw = dict(mode=mode, hr_patch_size=32, use_cache=False, seed=3)
        ours, theirs = FFHQDataset(str(root), **kw), JaxDataset(str(root), **kw)
        for i in range(3):  # seeded: the same augmentation draws on both sides
            a, b = ours[i], theirs[i]
            for k in ("hr", "lr"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{mode} {i} {k}")


def test_prepare_data_on_a_mixed_folder_matches_jax(tmp_path, monkeypatch):
    """JPEG (baseline, progressive, EXIF-rotated), BMP, TIFF, 16-bit and
    palette PNG inputs, end to end: the output PNGs bitwise the JAX
    package's; a corrupt JPEG is skipped by both."""
    from facesr.data import prepare_data as jprep
    from facesr_torch.data import prepare_data as tprep

    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(30)
    ex = Image.Exif()
    ex[0x0112] = 6
    files = {
        "a.jpg": _jpg(_smooth(31, 90, 120), Q, 92),
        "b.jpeg": _jpg(_smooth(32, 100, 80), Q, 80, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "c.JPG": _pil(_smooth(33, 70, 96), "JPEG", quality=88, exif=ex),
        "d.bmp": _pil(_smooth(34, 64, 64), "BMP"),
        "e.tiff": _pil(_smooth(35, 80, 72), "TIFF", compression="tiff_lzw"),
        "f.png": fx.png_bytes(rng.integers(0, 65536, (66, 70, 3)), 16, 2),
        "g.png": _pil(Image.fromarray(_smooth(36, 72, 72)).convert("P"), "PNG"),
        "h.jpg": _jpg(_smooth(37, 64, 64), Q, 90)[:300],
    }
    for name, data in files.items():
        (raw / name).write_bytes(data)
    argv = ["--input", str(raw), "--hr-size", "64", "--lr-size", "16", "--train-ratio", "0.5",
            "--val-ratio", "0.25", "--degradation", "bilinear"]
    monkeypatch.setattr(sys, "argv", ["prepare_data.py", *argv, "--output",
                                      str(tmp_path / "jax")])
    jprep.main()
    stats = tprep.main(argv + ["--output", str(tmp_path / "port")])
    assert sum(stats.values()) == len(files) - 1  # the cut JPEG is skipped
    jax_stats = json.loads((tmp_path / "jax" / "prepare_stats.json").read_text())
    assert jax_stats["stats"] == stats
    for split in ("train", "val", "test"):
        for sub in ("HR", "LR"):
            names = sorted(p.name for p in (tmp_path / "jax" / split / sub).iterdir())
            assert sorted(p.name for p in (tmp_path / "port" / split / sub).iterdir()) == names
            for n in names:
                np.testing.assert_array_equal(
                    png.read_rgb(tmp_path / "port" / split / sub / n),
                    png.read_rgb(tmp_path / "jax" / split / sub / n), err_msg=f"{split}/{n}")


def test_calibration_images_skip_only_corrupt_files(tmp_path):
    from facesr.parallel.serving import load_calibration_images as jax_load
    from facesr_torch.parallel.serving import load_calibration_images

    (tmp_path / "a.jpg").write_bytes(_jpg(_smooth(40, 80, 80), Q, 90))
    (tmp_path / "b.png").write_bytes(b"\x89PNG broken")
    (tmp_path / "c.bmp").write_bytes(_pil(_smooth(41, 64, 64), "BMP"))
    np.testing.assert_array_equal(load_calibration_images(str(tmp_path)),
                                  jax_load(str(tmp_path)))
    (tmp_path / "d.jpg").write_bytes(_pil(Image.fromarray(_smooth(42, 64, 64)).convert("CMYK"),
                                          "JPEG"))
    with pytest.raises(NotPorted, match="d.jpg: CMYK"):
        load_calibration_images(str(tmp_path))
