"""The plain versions of ``jpeg_decode.cpp``'s two entries, in Python and
numpy: `jpeg_entropy_numpy` (Huffman decoding of every scan into int16
coefficient planes) and `jpeg_reconstruct_numpy` (dequantisation, the
islow IDCT, upsampling and the colour conversion). Both take the plan that
`facesr_torch.data.jpeg` parses from a file's markers, and give what the
C++ entries give, bit for bit. The entropy decoder runs one Python step a
Huffman symbol: it is for tests and small images.

The plan (all int32 unless said):

- ``frame``: [mcux, mcuy, ncomp, progressive];
- ``comps``: [ncomp, 8]: h, v, bw, bh (the plane's blocks, MCU-padded),
  nbw, nbh (the blocks that hold samples), dw, dh (the samples);
- ``scans``: [nscans, 20]: ns, the ns component indices (4 slots), their
  DC and AC table indices (4 + 4), Ss, Se, Ah, Al, the byte offsets of the
  entropy data's start and end (the terminating marker), the restart
  interval in MCUs;
- ``huff``: uint8 [ntables, 272]: the 16 code counts, then the values.

The coefficient planes are one int16 array [sum of bw * bh, 64], component
after component, each block in natural (row-major) order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["NATURAL_ORDER", "EntropyError", "huffman_lut", "jpeg_entropy_numpy",
           "jpeg_reconstruct_numpy", "RANGE_LIMIT", "RECONSTRUCT_ERRORS"]

# zigzag index -> natural (row-major) index, ITU T.81 figure A.6
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int32)
_NAT = NATURAL_ORDER.tolist()

# The largest dequantised coefficient and first-pass IDCT value for which
# libjpeg-turbo's 16-bit SIMD islow IDCT equals the exact integer
# arithmetic here; beyond them it wraps or saturates, and the file is
# refused. Files written by an encoder stay far inside (|coefficient|
# <= 1024 + q / 2).
RANGE_LIMIT = 8191
RECONSTRUCT_ERRORS = {1: "a dequantised coefficient beyond the decoder's range",
                      2: "an IDCT value beyond the decoder's range",
                      3: "an unsupported sampling ratio"}

# error codes shared with jpeg_decode.cpp
ERR_BAD_CODE, ERR_PAST_END, ERR_RESTART, ERR_INDEX, ERR_REFINE, ERR_TABLE = 1, 2, 3, 4, 5, 6
_MESSAGES = {
    ERR_BAD_CODE: "bad Huffman code",
    ERR_PAST_END: "entropy data ends inside the MCU (truncated or corrupt)",
    ERR_RESTART: "restart marker missing or out of order",
    ERR_INDEX: "coefficient index past 63 (corrupt data)",
    ERR_REFINE: "a refinement coefficient larger than one bit (corrupt data)",
    ERR_TABLE: "bad Huffman table",
}


class EntropyError(ValueError):
    """A fault in the entropy-coded data: ``code`` (1-6), the scan and the
    MCU (or restart interval) where it was found."""

    def __init__(self, code: int, scan: int, mcu: int):
        self.code, self.scan, self.mcu = code, scan, mcu
        super().__init__(f"scan {scan}, MCU {mcu}: {_MESSAGES.get(code, f'error {code}')}")


def huffman_lut(spec: np.ndarray) -> Tuple[List[int], List[int]]:
    """A table's 16 counts + values -> (length, value) lookups indexed by
    the next 16 bits; length 0 marks no code. Raises ValueError for a table
    whose codes overflow their length (libjpeg refuses it)."""
    counts = [int(c) for c in spec[:16]]
    vals = [int(v) for v in spec[16:16 + sum(counts)]]
    if sum(counts) > 256:
        raise ValueError("more than 256 codes")
    length = [0] * 65536
    value = [0] * 65536
    code, k = 0, 0
    for bits in range(1, 17):
        for _ in range(counts[bits - 1]):
            lo = code << (16 - bits)
            hi = (code + 1) << (16 - bits)
            length[lo:hi] = [bits] * (hi - lo)
            value[lo:hi] = [vals[k]] * (hi - lo)
            code += 1
            k += 1
        if code >= (1 << bits):  # no code may be all ones
            raise ValueError("Huffman codes overflow their length")
        code <<= 1
    return length, value


class _Bits:
    """MSB-first bits of one restart interval's unstuffed bytes."""

    def __init__(self, buf: bytes):
        self.buf = buf + b"\0\0\0\0\0"
        self.pos = 0
        self.total = 8 * len(buf)

    def peek16(self) -> int:
        i, b = self.pos >> 3, self.buf
        return (((b[i] << 16) | (b[i + 1] << 8) | b[i + 2]) >> (8 - (self.pos & 7))) & 0xFFFF

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        i, b = self.pos >> 3, self.buf
        v = (b[i] << 24) | (b[i + 1] << 16) | (b[i + 2] << 8) | b[i + 3]
        r = (v >> (32 - (self.pos & 7) - n)) & ((1 << n) - 1)
        self.pos += n
        if self.pos > self.total:
            raise _PastEnd
        return r


class _PastEnd(Exception):
    pass


class _BadCode(Exception):
    pass


def _decode(br: _Bits, lut) -> int:
    p = br.peek16()
    n = lut[0][p]
    if n == 0:
        raise _BadCode
    br.pos += n
    if br.pos > br.total:
        raise _PastEnd
    return lut[1][p]


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _next_marker(data: bytes, pos: int, end: int) -> int:
    """The offset of the next marker (0xFF then neither 0x00 nor 0xFF) at
    or after ``pos``, or ``end``."""
    while True:
        i = data.find(b"\xff", pos, end)
        if i < 0 or i + 1 >= end:
            return end
        j = i + 1
        while j < end and data[j] == 0xFF:
            j += 1
        if j >= end:
            return end
        if data[j] != 0x00:
            return i
        pos = j + 1


def _block_list(comps, scan) -> List[Tuple[int, int, int]]:
    """(component, row, column) of every block of an interleaved scan's
    MCU, relative to the MCU's first block."""
    ns = scan[0]
    out = []
    for j in range(ns):
        c = scan[1 + j]
        h, v = comps[c][0], comps[c][1]
        for yy in range(v):
            for xx in range(h):
                out.append((c, yy, xx))
    return out


def jpeg_entropy_numpy(data: bytes, frame: np.ndarray, comps: np.ndarray, scans: np.ndarray,
                       huff: np.ndarray) -> np.ndarray:
    """Every scan's Huffman-coded data -> int16 [sum(bw * bh), 64]
    coefficient planes. Raises `EntropyError` on a fault."""
    frame = [int(x) for x in frame]
    comps = [[int(x) for x in row] for row in comps]
    mcux, mcuy = frame[0], frame[1]
    offsets = np.cumsum([0] + [c[2] * c[3] for c in comps])
    coef = np.zeros((int(offsets[-1]), 64), np.int64)
    luts = {}

    def lut(t: int, si: int):
        if t not in luts:
            try:
                luts[t] = huffman_lut(huff[t])
            except ValueError:
                raise EntropyError(ERR_TABLE, si, 0) from None
        return luts[t]

    for si, scan in enumerate(scans):
        scan = [int(x) for x in scan]
        ns = scan[0]
        ss, se, ah, al = scan[13], scan[14], scan[15], scan[16]
        start, end, restart = scan[17], scan[18], scan[19]
        cidx = scan[1:1 + ns]
        dcl = {c: lut(scan[5 + j], si) for j, c in enumerate(cidx)
               if ss == 0 and ah == 0}
        acl = {c: lut(scan[9 + j], si) for j, c in enumerate(cidx) if se > 0}
        if ns > 1:
            units = _block_list(comps, scan)
            total = mcux * mcuy
        else:
            c = cidx[0]
            total = comps[c][4] * comps[c][5]
        per = restart if restart > 0 else total
        pos = start
        mcu = 0
        interval = 0
        while mcu < total:
            if interval > 0:
                m = pos
                j = m + 1
                while j < end and data[j] == 0xFF:
                    j += 1
                want = 0xD0 + ((interval - 1) & 7)  # RST0-7 in turn
                if m >= end or data[m] != 0xFF or j >= end or data[j] != want:
                    raise EntropyError(ERR_RESTART, si, mcu)
                pos = j + 1
            m = _next_marker(data, pos, end)
            br = _Bits(data[pos:m].replace(b"\xff\x00", b"\xff"))
            pos = m
            pred = [0] * len(comps)
            eobrun = 0
            stop = min(total, mcu + per)
            try:
                while mcu < stop:
                    if ns > 1:
                        my, mx = divmod(mcu, mcux)
                        blocks = [(c, my * comps[c][1] + yy, mx * comps[c][0] + xx)
                                  for c, yy, xx in units]
                    else:
                        c = cidx[0]
                        by, bx = divmod(mcu, comps[c][4])
                        blocks = [(c, by, bx)]
                    for c, by, bx in blocks:
                        blk = coef[offsets[c] + by * comps[c][2] + bx]
                        eobrun = _block(br, blk, c, dcl, acl, pred, eobrun, ss, se, ah, al,
                                        frame[3])
                    mcu += 1
            except _BadCode:
                raise EntropyError(ERR_BAD_CODE, si, mcu) from None
            except _PastEnd:
                raise EntropyError(ERR_PAST_END, si, mcu) from None
            except _CoefIndex as e:
                raise EntropyError(e.args[0], si, mcu) from None
            interval += 1
    return coef.astype(np.int16)


class _CoefIndex(Exception):
    pass


def _block(br: _Bits, blk: np.ndarray, c: int, dcl, acl, pred, eobrun: int, ss: int,
           se: int, ah: int, al: int, progressive: int) -> int:
    """Decode one block of one scan into ``blk`` (int64 [64], natural
    order); returns the EOB run left."""
    if not progressive:
        s = _decode(br, dcl[c])
        if s:
            pred[c] += _extend(br.bits(s), s)
        blk[0] = pred[c]
        table = acl[c]
        k = 1
        while k < 64:
            rs = _decode(br, table)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    raise _CoefIndex(ERR_INDEX)
                blk[_NAT[k]] = _extend(br.bits(s), s)
            else:
                if r != 15:
                    break
                k += 15
            k += 1
        return 0
    if ss == 0:  # DC scans
        if ah == 0:
            s = _decode(br, dcl[c])
            if s:
                pred[c] += _extend(br.bits(s), s)
            blk[0] = pred[c] << al
        elif br.bits(1):
            blk[0] |= 1 << al
        return 0
    table = acl[c]
    if ah == 0:  # AC first
        if eobrun > 0:
            return eobrun - 1
        k = ss
        while k <= se:
            rs = _decode(br, table)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if k > 63:
                    raise _CoefIndex(ERR_INDEX)
                blk[_NAT[k]] = _extend(br.bits(s), s) * (1 << al)
            else:
                if r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += br.bits(r)
                    return eobrun - 1
                k += 15
            k += 1
        return 0
    # AC refinement
    p1, m1 = 1 << al, -1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = _decode(br, table)
            r, s = rs >> 4, rs & 15
            if s:
                if s != 1:
                    raise _CoefIndex(ERR_REFINE)
                s = p1 if br.bits(1) else m1
            else:
                if r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += br.bits(r)
                    break
            while True:
                z = _NAT[k]
                if blk[z] != 0:
                    if br.bits(1) and (blk[z] & p1) == 0:
                        blk[z] += p1 if blk[z] >= 0 else m1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
                if k > se:
                    break
            if s:
                if k > 63:
                    raise _CoefIndex(ERR_INDEX)
                blk[_NAT[k]] = s
            k += 1
    if eobrun > 0:
        while k <= se:
            z = _NAT[k]
            if blk[z] != 0 and br.bits(1) and (blk[z] & p1) == 0:
                blk[z] += p1 if blk[z] >= 0 else m1
            k += 1
        eobrun -= 1
    return eobrun


# ---------------------------------------------------------------------------
# dequantisation, IDCT, upsampling, colour conversion


def _idct_1d(x, n: int):
    """jidctint.c's 1-D islow kernel on eight int64 arrays; outputs
    descaled by ``n`` bits."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (n - 1)
    return [(tmp10 + t3 + half) >> n, (tmp11 + t2 + half) >> n, (tmp12 + t1 + half) >> n,
            (tmp13 + t0 + half) >> n, (tmp13 - t0 + half) >> n, (tmp12 - t1 + half) >> n,
            (tmp11 - t2 + half) >> n, (tmp10 - t3 + half) >> n]


def _idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """int16 [N, 64] natural-order blocks, int32 [64] quantiser -> uint8
    [N, 8, 8] samples. Raises ValueError(1 or 2) out of the exact range."""
    d = coef.astype(np.int64).reshape(-1, 8, 8) * qt.astype(np.int64).reshape(8, 8)
    if d.size and np.abs(d).max() > RANGE_LIMIT:
        raise ValueError(1)
    ws = np.stack(_idct_1d([d[:, k, :] for k in range(8)], 11), axis=1)  # [N, row, col]
    if ws.size and np.abs(ws).max() > RANGE_LIMIT:
        raise ValueError(2)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], 18), axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _plane(coef: np.ndarray, qt: np.ndarray, comp) -> np.ndarray:
    """One component's samples [dh, dw] (int32)."""
    h, v, bw, bh, nbw, nbh, dw, dh = comp
    blocks = coef.reshape(bh, bw, 64)[:nbh, :nbw].reshape(-1, 64)
    pix = _idct_islow(blocks, qt).reshape(nbh, nbw, 8, 8)
    return pix.transpose(0, 2, 1, 3).reshape(nbh * 8, nbw * 8)[:dh, :dw].astype(np.int32)


def _upsample(p: np.ndarray, hexp: int, vexp: int) -> np.ndarray:
    """libjpeg-turbo's jdsample.c with fancy upsampling on (its default):
    the triangle filters for 2h1v, 1h2v and 2h2v, box replication for any
    other integral ratio and for 2h1v / 2h2v planes at most 2 samples
    wide. Edges replicate the outermost samples."""
    dw = p.shape[1]
    if hexp == 1 and vexp == 1:
        return p
    if hexp == 1 and vexp == 2:
        pad = np.concatenate([p[:1], p, p[-1:]], axis=0)
        out = np.empty((2 * p.shape[0], dw), np.int32)
        out[0::2] = (3 * p + pad[:-2] + 1) >> 2
        out[1::2] = (3 * p + pad[2:] + 2) >> 2
        return out
    if hexp == 2 and vexp == 1 and dw > 2:
        pad = np.concatenate([p[:, :1], p, p[:, -1:]], axis=1)
        out = np.empty((p.shape[0], 2 * dw), np.int32)
        out[:, 0::2] = (3 * p + pad[:, :-2] + 1) >> 2
        out[:, 1::2] = (3 * p + pad[:, 2:] + 2) >> 2
        return out
    if hexp == 2 and vexp == 2 and dw > 2:
        pad = np.concatenate([p[:1], p, p[-1:]], axis=0)
        sums = np.empty((2 * p.shape[0], dw), np.int32)
        sums[0::2] = 3 * p + pad[:-2]
        sums[1::2] = 3 * p + pad[2:]
        spad = np.concatenate([sums[:, :1], sums, sums[:, -1:]], axis=1)
        out = np.empty((sums.shape[0], 2 * dw), np.int32)
        out[:, 0::2] = (3 * sums + spad[:, :-2] + 8) >> 4
        out[:, 1::2] = (3 * sums + spad[:, 2:] + 7) >> 4
        return out
    return np.repeat(np.repeat(p, vexp, axis=0), hexp, axis=1)


_X = np.arange(256, dtype=np.int64) - 128
CR_R = ((91881 * _X + 32768) >> 16).astype(np.int32)
CB_B = ((116130 * _X + 32768) >> 16).astype(np.int32)
CR_G = (-46802 * _X).astype(np.int64)
CB_G = (-22554 * _X + 32768).astype(np.int64)


def jpeg_reconstruct_numpy(coef: np.ndarray, comps: np.ndarray, qts: np.ndarray, width: int,
                           height: int, color: int) -> np.ndarray:
    """Coefficient planes -> [height, width, 3] RGB uint8. ``qts``: int32
    [ncomp, 64] natural-order quantisers; ``color``: 0 grey, 1 YCbCr, 2 RGB.
    Raises ValueError(code) with a `RECONSTRUCT_ERRORS` code."""
    comps = [[int(x) for x in row] for row in comps]
    hmax = max(c[0] for c in comps)
    vmax = max(c[1] for c in comps)
    planes = []
    off = 0
    for i, comp in enumerate(comps):
        n = comp[2] * comp[3]
        if hmax % comp[0] or vmax % comp[1]:
            raise ValueError(3)
        p = _plane(coef[off:off + n], qts[i], comp)
        off += n
        planes.append(_upsample(p, hmax // comp[0], vmax // comp[1])[:height, :width])
        if color == 0:
            break
    if color == 0:
        return np.repeat(planes[0][:, :, None], 3, axis=2).astype(np.uint8)
    if color == 2:
        return np.stack(planes, axis=2).astype(np.uint8)
    y, cb, cr = planes
    r = y + CR_R[cr]
    g = y + ((CB_G[cb] + CR_G[cr]) >> 16).astype(np.int32)
    b = y + CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)
