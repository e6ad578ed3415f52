"""Write the image-decoder fixtures of this folder and ``digests.json``.

The card's machine has neither cv2 nor PIL, so `chip_smoke.py` holds the
port's decoders to these files: each file's shape and the SHA-256 of what
``cv2.imread`` + ``BGR2RGB`` give for it (the bytes of the HWC RGB uint8
array). ``tests/test_torch_codecs.py`` recomputes every digest with cv2, so
the JSON cannot go stale. The files cover each decoder, progressive JPEG
and the orientation tags, plus a 256x256 and a 1024x1024 4:2:0 q95 JPEG of
a synthetic face for timing.

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


if __name__ == "__main__":
    main()
