"""JPEG decoding: what the JAX package's ``cv2.imread`` (libjpeg-turbo
3.1, its default decompression) + ``BGR2RGB`` gives, bit for bit.

This module reads the markers (SOI, APPn, DQT, DHT, SOFn, SOS, DRI, EOI)
into a plan; `facesr_torch.native.jpeg_entropy` decodes every scan's
Huffman data into coefficient planes, and `native.jpeg_reconstruct` does
the rest as libjpeg-turbo does by default:

- dequantisation and the islow IDCT (``jidctint.c``: 13-bit constants, 2
  extra bits in the first pass). cv2's libjpeg-turbo runs it in 16-bit
  SIMD lanes, which saturate the output at 0 and 255 (the C version's
  range-limit table would wrap beyond 511); a file whose coefficients leave
  the range where the two agree is refused (`RANGE_LIMIT`);
- fancy upsampling: the triangle filters for 4:2:0, 4:2:2 and 4:4:0
  (2h1v and 2h2v box-replicate a plane at most 2 samples wide), box
  replication for any other integral ratio (4:1:1 ...);
- ``jdcolor.c``'s integer YCbCr -> RGB tables (16 fraction bits); a grey
  JPEG is replicated to three channels; an RGB JPEG (Adobe transform 0, or
  component ids 'R', 'G', 'B' with no JFIF marker) is not converted;
- the EXIF orientation (APP1 ``Exif``, values 1-8), applied after decoding
  as cv2 applies it.

Baseline and extended sequential (SOF0/SOF1, 8-bit) and progressive (SOF2)
files decode, with restart intervals. Faults in the entropy-coded data are
met as libjpeg-turbo meets them, where it only warns: at a marker or where
the data ends, zero bits finish the MCU in progress and the rest of the
restart interval is left as it is (zero, so grey, in a sequential file); a
wrong or missing RSTn marker is resynced (``jpeg_resync_to_restart``); a
Huffman code longer than 16 bits decodes as 0; a coefficient index past 63
lands on 63. The two cv2 entry points differ on a file cut inside its
entropy data: ``cv2.imread`` reads the file through libjpeg's stdio source,
which gives a fake EOI where the file ends, and returns the patched image
(`decode` with ``file=True``, `codecs.imread`); ``cv2.imdecode``'s memory
source suspends there and cv2 returns None (`decode`, `codecs.imdecode`:
`JPEGError`). A single-scan file is read as libjpeg reads it: what follows
its scan changes nothing.

A progressive file whose first ten coefficients are not all refined to
full precision (one cut short, or with such a scan script) has its blocks
smoothed as libjpeg smooths them (``jdcoefct.c`` ``decompress_smooth_data``:
`Plan.smooth` holds the coefficient bits it reads, the entropy pass the
last iMCU row the final scan reached; `native.jpeg_smooth`).

Refused by name, as `UnsupportedImage`: arithmetic coding, 12-bit,
lossless and hierarchical files, CMYK/YCCK; a dequantised coefficient or
first-pass IDCT value beyond `RANGE_LIMIT` (which no encoder writes, but
corrupt or cut data can give). Other faults
(a bad marker segment, an undefined table, an out-of-order progression)
raise `JPEGError`, where cv2 returns None or, for the progression, warns.
"""

from __future__ import annotations

import struct
from typing import Callable, List, Optional

import numpy as np

from facesr_torch import native
from facesr_torch.data.image_errors import ImageDecodeError, UnsupportedImage
from facesr_torch.native.jpeg_numpy import NATURAL_ORDER, RANGE_LIMIT

__all__ = ["SIGNATURE", "JPEGError", "parse", "decode", "file_bytes", "exif_orientation",
           "apply_orientation", "RANGE_LIMIT"]

SIGNATURE = b"\xff\xd8"

# ITU T.81 K.3: libjpeg-turbo preloads these for a sequential file without
# DHT (Motion-JPEG frames)
_STD_TABLES = {
    (0, 0): "00010501010101010100000000000000000102030405060708090a0b",
    (0, 1): "00030101010101010101010000000000000102030405060708090a0b",
    (1, 0): "0002010303020403050504040000017d01020300041105122131410613516107227114328191a1"
            "082342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a43444546474849"
            "4a535455565758595a636465666768696a737475767778797a838485868788898a9293949596979899"
            "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4"
            "e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    (1, 1): "00020102040403040705040400010277000102031104052131061241510761711322328108144291"
            "a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a43444546474849"
            "4a535455565758595a636465666768696a737475767778797a82838485868788898a92939495969798"
            "999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4"
            "e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
}
_SOF_REFUSED = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
                0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded",
                0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
                0xCD: "arithmetic-coded hierarchical", 0xCE: "arithmetic-coded hierarchical",
                0xCF: "arithmetic-coded hierarchical lossless"}
_SMOOTHED = 10  # libjpeg-turbo smooths blocks when one of these coefficients is not exact
_SMOOTHED_AT = NATURAL_ORDER[:_SMOOTHED]  # their places in a block (natural order)
# the markers libjpeg's read_markers takes (with APP0-15); any other is a
# fatal error there
_KNOWN = {0xC0, 0xC1, 0xC2, 0xC4, 0xCC, 0xDA, 0xDB, 0xDC, 0xDD, 0xFE} | set(_SOF_REFUSED)
FAKE_EOI = b"\xff\xd9"


def file_bytes(data: bytes) -> bytes:
    """What libjpeg's stdio source (``cv2.imread``) reads from a file that
    holds ``data``: the bytes, then a fake EOI each time it asks for more.
    Enough of them follow for any marker segment cut at the end to be read
    to its length; the next marker is then an EOI."""
    return bytes(data) + FAKE_EOI * 32770


class JPEGError(ImageDecodeError):
    pass


class Plan:
    """A parsed file: what the two decode entries take (see
    `facesr_torch.native.jpeg_numpy` for the arrays' layout)."""

    def __init__(self, width: int, height: int, frame: np.ndarray, comps: np.ndarray,
                 scans: np.ndarray, huff: np.ndarray, qts: np.ndarray, color: int,
                 orientation: int, smooth: Optional[np.ndarray] = None):
        self.width, self.height = width, height
        self.frame, self.comps, self.scans, self.huff, self.qts = frame, comps, scans, huff, qts
        self.color, self.orientation = color, orientation
        self.smooth = smooth  # block smoothing's latch [ncomp, 2, 10], or None


def exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in EXIF's TIFF structure, 1
    when absent or unreadable."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack(e + "I", tiff[4:8])
        (n,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
        for i in range(n):
            at = ifd + 2 + 12 * i
            tag, kind, count = struct.unpack(e + "HHI", tiff[at:at + 8])
            if tag == 0x0112:
                if kind == 3:
                    return struct.unpack(e + "H", tiff[at + 8:at + 10])[0]
                if kind == 4:
                    return struct.unpack(e + "I", tiff[at + 8:at + 12])[0]
                return 1
    except struct.error:
        return 1
    return 1


_FLIPS = {2: (slice(None), slice(None, None, -1)),  # OpenCV's flip(1), flip(-1), flip(0)
          3: (slice(None, None, -1), slice(None, None, -1)),
          4: (slice(None, None, -1), slice(None))}


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation``: 2-4 flip, 5-8 transpose and then
    flip as 1-4 do; any other value leaves the image as it is."""
    if 5 <= orientation <= 8:
        img = img.transpose(1, 0, 2)
        orientation -= 4
    if orientation in _FLIPS:
        img = img[_FLIPS[orientation]]
    return np.ascontiguousarray(img)


def _find_scan_end(data: bytes, pos: int) -> int:
    """The offset of the marker that ends a scan's entropy data (0xFF then
    a byte that is neither 0x00 nor RSTn), or len(data)."""
    arr = np.frombuffer(data, np.uint8)
    for h in np.flatnonzero(arr[pos:-1] == 0xFF):
        i = pos + int(h)
        j = i + 1
        while j < len(data) and data[j] == 0xFF:
            j += 1
        if j >= len(data):
            break
        if data[j] != 0x00 and not 0xD0 <= data[j] <= 0xD7:
            return i
    return len(data)


def parse(data: bytes, name: str = "<jpeg>") -> Plan:
    """A JPEG file's markers -> the decode `Plan`. Raises `JPEGError` for a
    truncated or corrupt file and `UnsupportedImage` for one the port
    does not decode."""
    if not data.startswith(SIGNATURE):
        raise JPEGError(f"{name}: not a JPEG file")
    n = len(data)
    pos = 2
    qt: dict = {}
    tables: List[np.ndarray] = []
    ht: dict = {}
    frame = None
    sof = None
    scans: List[list] = []
    latched: dict = {}
    restart = 0
    jfif = False
    adobe: Optional[int] = None
    orientation = 1
    saw_exif = False

    def bad(msg: str) -> JPEGError:
        return JPEGError(f"{name}: {msg}")

    while True:
        if pos >= n:
            raise bad("truncated (no EOI marker)")
        if data[pos] != 0xFF:  # libjpeg skips stray bytes before a marker
            nxt = data.find(b"\xff", pos)
            if nxt < 0:
                raise bad("truncated (no EOI marker)")
            pos = nxt
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise bad("truncated (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if marker == 0xD8:
            raise bad("a second SOI marker")
        if marker not in _KNOWN and not 0xE0 <= marker <= 0xEF:
            raise bad(f"unknown marker 0x{marker:02X}")  # libjpeg: a fatal error
        if pos + 2 > n:
            raise bad("truncated marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        if length < 2 or pos + length > n:
            raise bad(f"truncated or bad segment of marker 0x{marker:02X}")
        seg = data[pos + 2:pos + length]
        pos += length
        if marker in _SOF_REFUSED:
            raise UnsupportedImage(f"{name}: {_SOF_REFUSED[marker]} JPEG is not decoded by "
                                   "the port")
        if marker == 0xCC:
            raise UnsupportedImage(f"{name}: arithmetic-coded JPEG is not decoded by the port")
        if marker in (0xC0, 0xC1, 0xC2):
            if sof is not None:
                raise bad("two frame headers")
            if len(seg) < 6:
                raise bad("short frame header")
            prec, height, width, nf = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise UnsupportedImage(f"{name}: {prec}-bit JPEG is not decoded by the port "
                                       "(8-bit only)")
            if height == 0:
                raise UnsupportedImage(f"{name}: a JPEG whose height comes in a DNL marker is "
                                       "not decoded by the port")
            if width == 0 or len(seg) < 6 + 3 * nf or nf == 0:
                raise bad("bad frame header")
            if nf == 4:
                raise UnsupportedImage(f"{name}: CMYK/YCCK JPEG is not decoded by the port")
            if nf not in (1, 3):
                raise bad(f"{nf} colour components")
            comps = []
            for i in range(nf):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise bad("bad sampling factors or quantisation table")
                comps.append((cid, h, v, tq))
            sof = marker
            frame = (width, height, comps)
        elif marker == 0xC4:
            at = 0
            while at < len(seg):
                if at + 17 > len(seg):
                    raise bad("short DHT segment")
                tc, th = seg[at] >> 4, seg[at] & 15
                counts = seg[at + 1:at + 17]
                total = sum(counts)
                if tc > 1 or th > 3 or total > 256 or at + 17 + total > len(seg) \
                        or (tc == 0 and max(seg[at + 17:at + 17 + total], default=0) > 15):
                    raise bad("bad DHT segment")
                spec = np.zeros(272, np.uint8)
                spec[:16 + total] = np.frombuffer(seg[at + 1:at + 17 + total], np.uint8)
                ht[(tc, th)] = len(tables)
                tables.append(spec)
                at += 17 + total
        elif marker == 0xDB:
            at = 0
            while at < len(seg):
                pq, tq = seg[at] >> 4, seg[at] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or at + 1 + size > len(seg):
                    raise bad("bad DQT segment")
                raw = seg[at + 1:at + 1 + size]
                zz = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int32)
                nat = np.zeros(64, np.int32)
                nat[NATURAL_ORDER] = zz
                qt[tq] = nat
                at += 1 + size
        elif marker == 0xDD:
            if len(seg) < 2:
                raise bad("short DRI segment")
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:
            if frame is None:
                raise bad("a scan before the frame header")
            scans.append(_scan(seg, frame, sof, ht, tables, qt, latched, restart, pos, bad))
            if sof != 0xC2 and scans[-1][0] == len(frame[2]) and len(scans) == 1:
                # libjpeg decodes a single-scan file as it reads it; what
                # follows the scan changes nothing, but a memory source
                # that ends with no EOI suspends (cv2.imdecode: None)
                if data.find(b"\xff\xd9", pos) < 0:
                    raise bad("truncated (no EOI marker)")
                scans[-1][18] = n
                break
            pos = _find_scan_end(data, pos)
            scans[-1][18] = pos
        elif marker == 0xDC:
            raise UnsupportedImage(f"{name}: a JPEG with a DNL marker is not decoded by the port")
        elif marker == 0xE0:
            if len(seg) >= 14 and seg[:5] == b"JFIF\0":
                jfif = True
        elif marker == 0xE1:
            if not saw_exif and seg[:6] == b"Exif\0\0":
                saw_exif = True
                orientation = exif_orientation(seg[6:])
        elif marker == 0xEE:
            if len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe = seg[11]
    if frame is None or not scans:
        raise bad("no frame or no scan")
    return _plan(frame, sof, scans, tables, latched, jfif, adobe, orientation, name)


def _scan(seg: bytes, frame, sof: int, ht: dict, tables: list, qt: dict, latched: dict,
          restart: int, start: int, bad) -> list:
    """One SOS header -> its row of the plan (see `native.jpeg_numpy`);
    latches the quantisers of components seen for the first time, as
    libjpeg does."""
    width, height, comps = frame
    if len(seg) < 1:
        raise bad("short SOS segment")
    ns = seg[0]
    if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
        raise bad("bad SOS segment")
    ids = [c[0] for c in comps]
    row = [0] * 20
    row[0] = ns
    ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    progressive = sof == 0xC2
    if progressive:
        if ss > se or se > 63 or (ss == 0 and se != 0) or (ss > 0 and ns != 1) \
                or ah > 13 or al > 13:
            raise bad("bad progression parameters")
    else:  # libjpeg only warns about other values here, and decodes the scan as sequential
        ss, se, ah, al = 0, 63, 0, 0
    blocks = 0
    for j in range(ns):
        cid, tt = seg[1 + 2 * j], seg[2 + 2 * j]
        if cid not in ids:
            raise bad(f"scan names unknown component {cid}")
        c = ids.index(cid)
        row[1 + j] = c
        blocks += comps[c][1] * comps[c][2]
        for k, (tc, th) in enumerate(((0, tt >> 4), (1, tt & 15))):
            needed = (tc == 0 and ss == 0 and ah == 0) or (tc == 1 and se > 0)
            if not needed:
                continue
            if (tc, th) not in ht:
                if progressive or th > 1:
                    raise bad(f"scan uses undefined Huffman table {th}")
                ht[(tc, th)] = len(tables)
                spec = np.zeros(272, np.uint8)
                std = bytes.fromhex(_STD_TABLES[(tc, th)])
                spec[:len(std)] = np.frombuffer(std, np.uint8)
                tables.append(spec)
            row[5 + 4 * k + j] = ht[(tc, th)]
        if c not in latched:
            tq = comps[c][3]
            if tq not in qt:
                raise bad(f"component {cid} uses undefined quantisation table {tq}")
            latched[c] = qt[tq].copy()
    if ns > 1 and blocks > 10:
        raise bad("more than 10 blocks in an MCU")
    row[13:17] = [ss, se, ah, al]
    row[17] = start
    row[19] = restart
    return row


def _plan(frame, sof: int, scans: List[list], tables: list, latched: dict, jfif: bool,
          adobe: Optional[int], orientation: int, name: str) -> Plan:
    width, height, comps = frame
    nf = len(comps)
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    carr = np.zeros((nf, 8), np.int32)
    for i, (cid, h, v, tq) in enumerate(comps):
        if hmax % h or vmax % v:
            raise JPEGError(f"{name}: fractional sampling ratio")
        dw = -(-width * h // hmax)
        dh = -(-height * v // vmax)
        carr[i] = [h, v, mcux * h, mcuy * v, -(-dw // 8), -(-dh // 8), dw, dh]
        if i not in latched:  # a file that ends before its scan: libjpeg's IDCT
            latched[i] = np.zeros(64, np.int32)  # table stays zero, the plane grey
    progressive = sof == 0xC2
    smooth = None
    if progressive:
        # each coefficient's successive-approximation bit (-1: no scan yet),
        # now and before each component's last scan, as jdphuff.c keeps them
        bits = np.full((nf, 64), -1, np.int32)
        prior = np.full((nf, 64), -1, np.int32)
        for n, s in enumerate(scans):
            ss, se, ah, al = s[13:17]
            if ah and al != ah - 1:
                raise JPEGError(f"{name}: bad successive approximation (Al != Ah - 1)")
            for j in range(s[0]):
                c = s[1 + j]
                lo, hi = min(ss, 1), max(se, _SMOOTHED - 1) + 1
                prior[c, lo:hi] = bits[c, lo:hi] if n else 0
                cur = bits[c, ss:se + 1]
                # libjpeg warns here and decodes on; the port refuses
                if np.any(np.maximum(cur, 0) != ah) or (ss > 0 and bits[c, 0] < 0):
                    raise JPEGError(f"{name}: inconsistent progression (a scan out of order)")
                cur[:] = al
        if np.any(bits[:, 0] < 0):
            raise JPEGError(f"{name}: progressive JPEG with no DC scan for a component")
        # jdcoefct.c smoothing_ok: smooth while one of these is inexact, with
        # their quantisers non-zero; with one scan, the prior bits read -1
        qtab = np.stack([latched[i] for i in range(nf)])
        if np.any(bits[:, 1:_SMOOTHED] != 0) and np.all(qtab[:, _SMOOTHED_AT] != 0):
            if len(scans) == 1:
                prior[:, 1:_SMOOTHED] = -1
            smooth = np.stack([bits[:, :_SMOOTHED], prior[:, :_SMOOTHED]], axis=1)
    if nf == 1:
        color = 0
    elif jfif:
        color = 1
    elif adobe is not None:
        color = 2 if adobe == 0 else 1
    else:
        color = 2 if [c[0] for c in comps] == [82, 71, 66] else 1
    qts = np.stack([latched[i] for i in range(nf)]).astype(np.int32)
    huff = np.stack(tables) if tables else np.zeros((1, 272), np.uint8)
    return Plan(width, height, np.array([mcux, mcuy, nf, int(progressive)], np.int32), carr,
                np.array(scans, np.int32).reshape(-1, 20), huff, qts, color, orientation,
                smooth)


def decode(data: bytes, name: str = "<jpeg>", entropy: Callable = native.jpeg_entropy,
           reconstruct: Callable = native.jpeg_reconstruct, smooth: Callable = native.jpeg_smooth,
           file: bool = False) -> np.ndarray:
    """A JPEG file's bytes -> HWC RGB uint8, as ``cv2.imdecode`` with
    ``IMREAD_COLOR`` + ``BGR2RGB`` give it; with ``file``, as ``cv2.imread``
    gives it for a file holding these bytes (libjpeg's stdio source gives a
    fake EOI where the file ends, so a cut file decodes with the rest grey).
    ``entropy`` / ``reconstruct`` / ``smooth``: the native entries, or their
    plain versions (`native.jpeg_entropy_numpy`,
    `native.jpeg_reconstruct_numpy`, `native.jpeg_smooth_numpy`)."""
    if file:
        data = file_bytes(data)
    plan = parse(data, name)
    rows = np.zeros(len(plan.scans), np.int32)
    try:
        coef = entropy(data, plan.frame, plan.comps, plan.scans, plan.huff, rows)
    except ValueError as e:
        raise JPEGError(f"{name}: {e}") from None
    if plan.smooth is not None:
        coef = smooth(coef, plan.comps, plan.qts, int(plan.frame[1]), plan.smooth,
                      int(rows[-1]))
    try:
        img = reconstruct(coef, plan.comps, plan.qts, plan.width, plan.height, plan.color)
    except ValueError as e:
        code = e.args[0] if e.args else 0
        msg = native.RECONSTRUCT_ERRORS.get(code, str(e))
        if code == 3:
            raise JPEGError(f"{name}: {msg}") from None
        raise UnsupportedImage(f"{name}: {msg} (cv2's SIMD IDCT would wrap or saturate "
                               "there); not decoded by the port") from None
    return apply_orientation(img, plan.orientation)

