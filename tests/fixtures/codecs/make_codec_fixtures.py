"""Write the image-decoder fixtures of this folder and ``digests.json``.

The card's machine has neither cv2 nor PIL, so `chip_smoke.py` holds the
port's decoders to these files: each file's shape and the SHA-256 of what
``cv2.imread`` + ``BGR2RGB`` give for it (the bytes of the HWC RGB uint8
array). ``tests/test_torch_codecs.py`` recomputes every digest with cv2, so
the JSON cannot go stale. The files cover each decoder, progressive JPEG
and the orientation tags, plus a 256x256 and a 1024x1024 4:2:0 q95 JPEG of
a synthetic face for timing.

``recovery/`` holds JPEGs cut inside their entropy data (progressive ones
among them, which libjpeg smooths) or with a planted fault (a wrong or
missing restart marker, an early EOI, a Huffman code longer than 16
bits), made from the files above, and
``recovery/digests.json``: for each, the digest of ``cv2.imread`` of the
file (libjpeg's stdio source, which patches it) and that of
``cv2.imdecode`` of its bytes, or null where that returns None.

    python tests/fixtures/codecs/make_codec_fixtures.py

The hand-built writers (Adam7 and low-bit PNG, BMP headers, big-endian
TIFF) are imported by the tests too.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack_row(samples: np.ndarray, depth: int) -> bytes:
    """One row of samples (any shape) as PNG bytes at ``depth`` bits."""
    flat = samples.reshape(-1)
    if depth == 16:
        return flat.astype(">u2").tobytes()
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    bits = np.unpackbits(flat.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:].reshape(-1)
    return np.packbits(bits).tobytes()


def png_bytes(img: np.ndarray, depth: int, ctype: int, interlace: bool = False,
              palette: np.ndarray = None, filters=(0,)) -> bytes:
    """A PNG of ``img`` ([H, W, C] samples, already at ``depth``), rows
    filtered None or Sub in turn (``filters``), Adam7 when ``interlace``."""
    h, w = img.shape[:2]
    c = img.shape[2]
    bpp = max(1, c * depth // 8)

    def rows(sub: np.ndarray) -> bytes:
        out = b""
        for y in range(sub.shape[0]):
            raw = np.frombuffer(_pack_row(sub[y], depth), np.uint8).astype(np.int16)
            ftype = filters[y % len(filters)]
            if ftype == 1:
                left = np.concatenate([np.zeros(bpp, np.int16), raw[:-bpp]])
                raw = raw - left
            out += bytes([ftype]) + (raw % 256).astype(np.uint8).tobytes()
        return out

    if interlace:
        data = b"".join(rows(img[ys::dy, xs::dx]) for xs, ys, dx, dy in ADAM7
                        if img[ys::dy, xs::dx].size)
    else:
        data = rows(img)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                              0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def bmp_bytes(rows_bytes, w: int, h: int, bpp: int, comp: int = 0, masks=None,
              palette: bytes = b"", header: int = 40, top_down: bool = False) -> bytes:
    """A BMP with a BITMAPINFOHEADER (40) or a V4 (108) / V5 (124) header;
    bit masks after the header (where OpenCV reads a 16-bit file's) and,
    for V4/V5, in it too."""
    stride = (w * bpp + 31) // 32 * 4
    data = b"".join(r.ljust(stride, b"\0") for r in rows_bytes)
    body = struct.pack("<iiHHIIiiII", w, -h if top_down else h, 1, bpp, comp, len(data), 2835,
                       2835, 0, 0)
    if header > 40:
        body += struct.pack("<IIII", *(masks or (0, 0, 0)), 0) + b"\0" * (header - 56)
    extra = struct.pack("<III", *masks) if comp == 3 else b""
    head = struct.pack("<I", header) + body
    off = 14 + len(head) + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + head + extra + palette
            + data)


def tiff_be_bytes(img: np.ndarray, orientation: int = 1) -> bytes:
    """An uncompressed big-endian (MM) RGB TIFF, one strip."""
    h, w, _ = img.shape
    pix = img.astype(np.uint8).tobytes()
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 3, None), (259, 3, 1, 1),
               (262, 3, 1, 2), (273, 4, 1, None), (274, 3, 1, orientation), (277, 3, 1, 3),
               (278, 3, 1, h), (279, 4, 1, len(pix))]
    ifd_at = 8
    bits_at = ifd_at + 2 + 12 * len(entries) + 4
    pix_at = bits_at + 6
    out = b"MM\0*" + struct.pack(">I", ifd_at) + struct.pack(">H", len(entries))
    for tag, kind, count, value in entries:
        if tag == 258:
            value = bits_at
        elif tag == 273:
            value = pix_at
        short = kind == 3 and count == 1  # else a LONG, or the offset of 3 SHORTs
        field = struct.pack(">H", value) + b"\0\0" if short else struct.pack(">I", value)
        out += struct.pack(">HHI", tag, kind, count) + field
    return out + b"\0\0\0\0" + struct.pack(">HHH", 8, 8, 8) + pix


def smooth(rng, h: int, w: int) -> np.ndarray:
    import cv2

    return cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 2)


def fixtures() -> dict:
    """name -> file bytes."""
    import cv2
    from PIL import Image

    sys.path.insert(0, str(HERE.parents[2]))
    from facesr_torch.cli.make_synthetic_faces import render_face

    rng = np.random.default_rng(20)
    img = smooth(rng, 37, 53)
    out = {}

    def jpg(a, *flags):
        return cv2.imencode(".jpg", a[..., ::-1], list(flags))[1].tobytes()

    def pil(a, fmt, **kw):
        bio = io.BytesIO()
        (a if isinstance(a, Image.Image) else Image.fromarray(a)).save(bio, fmt, **kw)
        return bio.getvalue()

    q, sf = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    out["jpeg_420_q90.jpg"] = jpg(img, q, 90, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    out["jpeg_422_q75.jpg"] = jpg(img, q, 75, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
    out["jpeg_411_q50.jpg"] = jpg(img, q, 50, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)
    out["jpeg_440_q95.jpg"] = jpg(img, q, 95, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
    out["jpeg_444_q100_noise.jpg"] = jpg(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8),
                                         q, 100, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    out["jpeg_grey.jpg"] = cv2.imencode(".jpg", img[..., 0], [q, 85])[1].tobytes()
    out["jpeg_progressive.jpg"] = jpg(img, q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    out["jpeg_progressive_pil_422.jpg"] = pil(img, "JPEG", quality=80, subsampling=1,
                                              progressive=True)
    out["jpeg_restart.jpg"] = jpg(img, q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    for o in (6, 3, 8):
        ex = Image.Exif()
        ex[0x0112] = o
        out[f"jpeg_exif{o}.jpg"] = pil(img, "JPEG", quality=85, exif=ex)
    out["png16_rgb.png"] = cv2.imencode(".png", rng.integers(0, 65536, (13, 17, 3))
                                        .astype(np.uint16))[1].tobytes()
    out["png_palette.png"] = pil(Image.fromarray(img).convert("P"), "PNG")
    out["png_grey4.png"] = png_bytes(rng.integers(0, 16, (9, 11, 1)), 4, 0)
    out["png_adam7.png"] = png_bytes(rng.integers(0, 256, (21, 29, 3)), 8, 2, interlace=True,
                                     filters=(0, 1))
    ex = Image.Exif()
    ex[0x0112] = 6
    out["png_exif6.png"] = pil(img, "PNG", exif=ex)
    pal = rng.integers(0, 256, (16, 4), dtype=np.uint8).tobytes()
    idx = rng.integers(0, 16, (7, 13)).astype(np.uint8)
    out["bmp_4bit.bmp"] = bmp_bytes([_pack_row(r, 4) for r in idx], 13, 7, 4, palette=pal)
    px = rng.integers(0, 65536, (7, 13)).astype("<u2")
    out["bmp_565_v5.bmp"] = bmp_bytes([r.tobytes() for r in px], 13, 7, 16, comp=3,
                                      masks=(0xF800, 0x07E0, 0x001F), header=124)
    px = rng.integers(0, 256, (7, 13, 3), dtype=np.uint8)
    out["bmp_24_topdown.bmp"] = bmp_bytes([r.tobytes() for r in px], 13, 7, 24, top_down=True)
    out["bmp_1bit.bmp"] = pil(Image.fromarray(img).convert("1"), "BMP")
    out["tiff_lzw_pred2.tif"] = pil(img, "TIFF", compression="tiff_lzw", tiffinfo={317: 2})
    out["tiff_packbits_grey.tif"] = pil(Image.fromarray(img).convert("L"), "TIFF",
                                        compression="packbits")
    rgba = np.concatenate([img, rng.integers(0, 256, (37, 53, 1), dtype=np.uint8)], axis=2)
    out["tiff_deflate_rgba.tif"] = pil(Image.fromarray(rgba, "RGBA"), "TIFF",
                                       compression="tiff_adobe_deflate")
    out["tiff_be_orient3.tif"] = tiff_be_bytes(img[:9, :11], orientation=3)
    for size in (256, 1024):
        face = render_face(np.random.default_rng(0), size)
        out[f"face_{size}_q95_420.jpg"] = jpg(face, q, 95, sf,
                                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    return out


RECOVERY = HERE / "recovery"


def _scan_span(data: bytes):
    """(start, end) of a baseline JPEG's entropy data: after the first SOS
    header, up to its EOI."""
    sos = data.index(b"\xff\xda")
    return sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0], data.rindex(b"\xff\xd9")


def _scan_middle(data: bytes, k: int) -> int:
    """The middle of the k-th scan's entropy data (from 0)."""
    sos = -1
    for _ in range(k + 1):
        sos = data.index(b"\xff\xda", sos + 1)
    start = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    end = start
    while data[end] != 0xFF or data[end + 1] == 0x00 or 0xD0 <= data[end + 1] <= 0xD7:
        end += 1
    return (start + end) // 2


def _rst(data: bytes, k: int) -> int:
    """The offset of the k-th restart marker's FF."""
    found = [i for i in range(len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    return found[k]


def recovery_fixtures(files: dict) -> dict:
    """The cut and planted JPEGs of ``recovery/``, made from ``fixtures()``."""
    out = {}

    def cut(name: str, share: float) -> bytes:
        start, end = _scan_span(files[name])
        return files[name][:start + int((end - start) * share)]

    out["cut50_jpeg_420_q90.jpg"] = cut("jpeg_420_q90.jpg", 0.5)
    out["cut90_jpeg_restart.jpg"] = cut("jpeg_restart.jpg", 0.9)
    out["cut98_jpeg_grey.jpg"] = cut("jpeg_grey.jpg", 0.98)
    out["cut30_jpeg_411_q50.jpg"] = cut("jpeg_411_q50.jpg", 0.3)
    out["cut50_face_256_q95_420.jpg"] = cut("face_256_q95_420.jpg", 0.5)
    prog = files["jpeg_progressive.jpg"]  # cut in its last scan: nothing left to smooth
    out["cut_last_scan_jpeg_progressive.jpg"] = prog[:prog.rindex(b"\xff\xda") + 40]
    # cut before the low coefficients are refined: libjpeg smooths the blocks
    out["cut_scan5_jpeg_progressive.jpg"] = prog[:_scan_middle(prog, 5)]
    pil = files["jpeg_progressive_pil_422.jpg"]
    out["cut_scan2_jpeg_progressive_pil_422.jpg"] = pil[:_scan_middle(pil, 2)]
    rst = files["jpeg_restart.jpg"]
    at = _rst(rst, 2)  # RST2, which follows the third interval
    for label, k in (("far", 6), ("next", 3), ("prior", 1)):
        out[f"rst_{label}_jpeg_restart.jpg"] = rst[:at + 1] + bytes([0xD0 + k]) + rst[at + 2:]
    out["rst_missing_jpeg_restart.jpg"] = rst[:at] + rst[at + 2:]
    base = files["jpeg_420_q90.jpg"]
    start, end = _scan_span(base)
    mid = (start + end) // 2
    out["early_eoi_jpeg_420_q90.jpg"] = base[:mid] + b"\xff\xd9"
    # three stuffed FF bytes: 24 one bits, which no Huffman code is
    out["bad_code_jpeg_420_q90.jpg"] = base[:mid] + b"\xff\x00" * 3 + base[mid + 3:]
    return out


def cv2_read_digest(data: bytes) -> dict:
    """The shape and SHA-256 of ``cv2.imread`` of a file holding ``data``
    + ``BGR2RGB`` (the stdio source: a file cut short is patched)."""
    import tempfile

    import cv2

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "f.jpg"
        path.write_bytes(data)
        bgr = cv2.imread(str(path))
    rgb = np.ascontiguousarray(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    return {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def cv2_digest_or_none(data: bytes):
    import cv2

    if cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None:
        return None
    return cv2_digest(data)


def cv2_digest(data: bytes) -> dict:
    """The shape and SHA-256 of ``cv2.imdecode(data)`` + ``BGR2RGB``."""
    import cv2

    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    rgb = np.ascontiguousarray(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    return {"shape": list(rgb.shape), "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def main() -> None:
    files = fixtures()
    digests = {}
    for name, data in sorted(files.items()):
        (HERE / name).write_bytes(data)
        digests[name] = cv2_digest(data)
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(len(d) for d in files.values())
    print(f"wrote {len(files)} files, {total} bytes, and digests.json")
    RECOVERY.mkdir(exist_ok=True)
    cut = recovery_fixtures(files)
    digests = {}
    for name, data in sorted(cut.items()):
        (RECOVERY / name).write_bytes(data)
        digests[name] = {"imread": cv2_read_digest(data), "imdecode": cv2_digest_or_none(data)}
    (RECOVERY / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    print(f"wrote {len(cut)} files, {sum(len(d) for d in cut.values())} bytes, and "
          "recovery/digests.json")


if __name__ == "__main__":
    main()
