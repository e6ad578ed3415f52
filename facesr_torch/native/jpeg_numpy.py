"""The plain versions of ``jpeg_decode.cpp``'s three entries, in Python and
numpy: `jpeg_entropy_numpy` (Huffman decoding of every scan into int16
coefficient planes), `jpeg_smooth_numpy` (libjpeg's block smoothing) and
`jpeg_reconstruct_numpy` (dequantisation, the islow IDCT, upsampling and
the colour conversion). Both take the plan that
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

import re
from typing import List, Tuple

import numpy as np

__all__ = ["NATURAL_ORDER", "EntropyError", "huffman_lut", "jpeg_entropy_numpy",
           "jpeg_smooth_numpy", "jpeg_reconstruct_numpy", "RANGE_LIMIT", "RECONSTRUCT_ERRORS"]

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

# error code shared with jpeg_decode.cpp
ERR_TABLE = 6
_MESSAGES = {ERR_TABLE: "bad Huffman table"}


class EntropyError(ValueError):
    """A fault that stops entropy decoding: ``code``, the scan and the MCU
    where it was found."""

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


_STUFFED = re.compile(b"\xff+\x00")  # FF, any fill FFs, then 00: one data byte FF


def _next_marker(data: bytes, pos: int, end: int) -> Tuple[int, int, int]:
    """libjpeg's next_marker from ``pos``: (the marker's offset, its code,
    the offset after it); the end of the data counts as an EOI there."""
    while True:
        i = data.find(b"\xff", pos, end)
        if i < 0:
            return end, 0xD9, end
        j = i + 1
        while j < end and data[j] == 0xFF:
            j += 1
        if j >= end:
            return i, 0xD9, end
        if data[j] != 0x00:
            return i, data[j], j + 1
        pos = j + 1


class _Bits:
    """libjpeg-turbo's bit reader (jdhuff.c) on the entropy data from
    ``pos``: the bytes up to the next marker, unstuffed, then zero bits. The
    marker that ends them is the unread marker at once (libjpeg meets it
    later, or finds it with next_marker at a restart: the same marker).
    ``short`` is libjpeg's insufficient_data: a bit past the data taken."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.end = data, end
        self.unread = 0
        self.after = pos
        self.load()

    def load(self) -> None:
        """The next stretch: the data from ``after`` to the next marker, or
        none while a marker is unread (libjpeg gives zero bits then)."""
        seg = b""
        if not self.unread:
            m, self.unread, nxt = _next_marker(self.data, self.after, self.end)
            seg = _STUFFED.sub(b"\xff", self.data[self.after:m])
            self.after = nxt
        self.buf = seg + b"\0" * 8
        self.total = 8 * len(seg)
        self.pos = 0

    @property
    def short(self) -> bool:
        return self.pos > self.total

    def _word(self, i: int) -> int:
        b = self.buf
        if i + 3 < len(b):
            return (b[i] << 24) | (b[i + 1] << 16) | (b[i + 2] << 8) | b[i + 3]
        v = 0
        for k in range(4):
            v = (v << 8) | (b[i + k] if i + k < len(b) else 0)
        return v

    def peek17(self) -> int:
        return (self._word(self.pos >> 3) >> (15 - (self.pos & 7))) & 0x1FFFF

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        r = (self._word(self.pos >> 3) >> (32 - (self.pos & 7) - n)) & ((1 << n) - 1)
        self.pos += n
        return r

    def next_marker(self) -> None:
        _, self.unread, self.after = _next_marker(self.data, self.after, self.end)


def _decode(br: _Bits, lut) -> int:
    """One Huffman symbol; a code longer than 16 bits takes 17 bits and
    gives 0 (jpeg_huff_decode)."""
    p = br.peek17() >> 1
    n = lut[0][p]
    if n == 0:
        br.pos += 17
        return 0
    br.pos += n
    return lut[1][p]


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _int16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _int32(v: int) -> int:
    return ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _natural(k: int) -> int:
    """jpeg_natural_order with its 16 extra entries of 63."""
    return _NAT[k] if k < 64 else 63


def _resync(br: _Bits, desired: int) -> None:
    """jdmarker.c jpeg_resync_to_restart: the unread marker is not
    RST``desired``. Action 1 drops it, 2 skips to the next marker and
    decides again, 3 keeps it (the interval is then empty)."""
    while True:
        m = br.unread
        if m < 0xC0:
            action = 2
        elif not 0xD0 <= m <= 0xD7:
            action = 3
        elif m in (0xD0 + ((desired + 1) & 7), 0xD0 + ((desired + 2) & 7)):
            action = 3
        elif m in (0xD0 + ((desired - 1) & 7), 0xD0 + ((desired - 2) & 7)):
            action = 2
        else:
            action = 1
        if action == 1:
            br.unread = 0
            return
        if action == 3:
            return
        br.next_marker()


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
                       huff: np.ndarray, rows: np.ndarray = None) -> np.ndarray:
    """Every scan's Huffman-coded data -> int16 [sum(bw * bh), 64]
    coefficient planes. Faults in the data are handled as libjpeg-turbo
    handles them (see jpeg_decode.cpp); raises `EntropyError` for a bad
    Huffman table. ``rows`` (int32 [nscans]), when given, gets each scan's
    last iMCU row begun with data left (libjpeg's last_good_iMCU_row)."""
    frame = [int(x) for x in frame]
    comps = [[int(x) for x in row] for row in comps]
    mcux, mcuy = frame[0], frame[1]
    offsets = np.cumsum([0] + [c[2] * c[3] for c in comps])
    coef = [[0] * 64 for _ in range(int(offsets[-1]))]
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
        start, end, restart = scan[17], min(scan[18], len(data)), scan[19]
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
        br = _Bits(data, start, end)
        pred = [0] * len(comps)
        eobrun = 0
        next_rst, togo, short = 0, restart, False
        for mcu in range(total):
            if restart > 0:
                if togo == 0:  # process_restart + read_restart_marker (the
                    # stretch's end marker is already unread: libjpeg's next_marker)
                    if br.unread == 0xD0 + next_rst:
                        br.unread = 0
                    else:
                        _resync(br, next_rst)
                    if br.unread == 0:
                        short = False
                    br.load()
                    next_rst = (next_rst + 1) & 7
                    pred = [0] * len(comps)
                    eobrun = 0
                    togo = restart
                togo -= 1
            if short:
                continue
            if rows is not None:
                c = cidx[0]
                rows[si] = mcu // mcux if ns > 1 else mcu // comps[c][4] // comps[c][1]
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
                eobrun = _block(br, blk, c, dcl, acl, pred, eobrun, ss, se, ah, al, frame[3])
            short = br.short
    return np.array(coef, np.int64).astype(np.int16).reshape(-1, 64)


def _block(br: _Bits, blk: list, c: int, dcl, acl, pred, eobrun: int, ss: int, se: int,
           ah: int, al: int, progressive: int) -> int:
    """Decode one block of one scan into ``blk`` (64 ints, natural order,
    int16 values) as jdhuff.c / jdphuff.c do; returns the EOB run left."""
    if not progressive:
        s = _decode(br, dcl[c])
        if s:
            pred[c] = _int32(pred[c] + _extend(br.bits(s), s))
        blk[0] = _int16(pred[c])
        table = acl[c]
        k = 1
        while k < 64:
            rs = _decode(br, table)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                blk[_natural(k)] = _extend(br.bits(s), s)
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
                pred[c] = _int32(pred[c] + _extend(br.bits(s), s))
            blk[0] = _int16(pred[c] << al)
        elif br.bits(1):
            blk[0] = _int16(blk[0] | (1 << al))
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
                blk[_natural(k)] = _int16(_extend(br.bits(s), s) << al)
            else:
                if r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += br.bits(r)
                    return eobrun - 1
                k += 15
            k += 1
        return 0
    # AC refinement; a new coefficient wider than one bit is only warned about
    p1, m1 = 1 << al, -1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = _decode(br, table)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if br.bits(1) else m1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += br.bits(r)
                break
            while True:
                z = _NAT[k]
                if blk[z] != 0:
                    if br.bits(1) and (blk[z] & p1) == 0:
                        blk[z] = _int16(blk[z] + (p1 if blk[z] >= 0 else m1))
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
                if k > se:
                    break
            if s:
                blk[_natural(k)] = s
            k += 1
    if eobrun > 0:
        while k <= se:
            z = _NAT[k]
            if blk[z] != 0 and br.bits(1) and (blk[z] & p1) == 0:
                blk[z] = _int16(blk[z] + (p1 if blk[z] >= 0 else m1))
            k += 1
        eobrun -= 1
    return eobrun


# ---------------------------------------------------------------------------
# block smoothing


def _estimate(al: int, num: int, q: int) -> int:
    """jdcoefct.c's rounding of one estimate, clamped below 2^Al."""
    pred = ((q << 7) + abs(num)) // (q << 8)
    if al > 0 and pred >= (1 << al):
        pred = (1 << al) - 1
    return _int16(pred if num >= 0 else -pred)


def jpeg_smooth_numpy(coef: np.ndarray, comps: np.ndarray, qts: np.ndarray, imcu_rows: int,
                      latch: np.ndarray, last_good: int) -> np.ndarray:
    """The plain version of jpeg_decode.cpp's ``jpeg_smooth``
    (``decompress_smooth_data``'s estimates), block by block: returns a
    smoothed copy of the int16 [sum(bw * bh), 64] coefficient planes.
    ``latch``: [ncomp, 2, 10] coefficient bits of zigzag 0-9 after the last
    scan and before it; ``last_good``: the last iMCU row the last scan
    reached."""
    out = coef.copy()
    off = 0
    for c, comp in enumerate(comps):
        _, v, bw, bh, nbw, nbh, _, _ = (int(x) for x in comp)
        plane = coef[off:off + bw * bh].reshape(bh, bw, 64)
        dst = out[off:off + bw * bh].reshape(bh, bw, 64)
        off += bw * bh
        q = [int(x) for x in qts[c]]
        Q00, Q01, Q10, Q20, Q11, Q02, Q03, Q12, Q21, Q30 = (q[p] for p in (0, 1, 8, 16, 9, 2,
                                                                            3, 10, 17, 24))
        for imcu in range(imcu_rows):
            cb = [int(x) for x in latch[c][1 if imcu > last_good else 0]]
            change_dc = all(b == -1 for b in cb[1:10])
            block_rows = v if imcu < imcu_rows - 1 else (nbh % v or v)
            image_block_rows = block_rows * imcu_rows
            for br in range(block_rows):
                ibr, row = imcu * block_rows + br, imcu * v + br
                prev = row - 1 if ibr > 0 else row
                nxt = row + 1 if ibr < image_block_rows - 1 else row
                rows = (row - 2 if ibr > 1 else prev, prev, row, nxt,
                        row + 2 if ibr < image_block_rows - 2 else nxt)
                # D[i][j]: row rows[i], column b - 2 + j (libjpeg's DC01-DC25)
                D = [[int(plane[r, 0, 0])] * 5 for r in rows]
                last = nbw - 1
                for b in range(nbw):
                    w = dst[row, b]
                    if b == 0 and last > 0:
                        for i, r in enumerate(rows):
                            D[i][3] = D[i][4] = int(plane[r, 1, 0])
                    if b + 1 < last:
                        for i, r in enumerate(rows):
                            D[i][4] = int(plane[r, b + 2, 0])
                    ((DC01, DC02, DC03, DC04, DC05), (DC06, DC07, DC08, DC09, DC10),
                     (DC11, DC12, DC13, DC14, DC15), (DC16, DC17, DC18, DC19, DC20),
                     (DC21, DC22, DC23, DC24, DC25)) = D
                    if cb[1] != 0 and w[1] == 0:
                        w[1] = _estimate(cb[1], Q00 * (
                            (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09
                             + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16
                             + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                            if change_dc else (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
                            Q01)
                    if cb[2] != 0 and w[8] == 0:
                        w[8] = _estimate(cb[2], Q00 * (
                            (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07
                             + 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18
                             - 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                            if change_dc else (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
                            Q10)
                    if cb[3] != 0 and w[16] == 0:
                        w[16] = _estimate(cb[3], Q00 * (
                            (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13
                             - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                            if change_dc else (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
                            Q20)
                    if cb[4] != 0 and w[9] == 0:
                        w[9] = _estimate(cb[4], Q00 * (
                            (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21
                             - DC25)
                            if change_dc else (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20
                                               + DC22 - DC24 + DC04 - DC06 + 10 * DC07
                                               - 10 * DC09)), Q11)
                    if cb[5] != 0 and w[2] == 0:
                        w[2] = _estimate(cb[5], Q00 * (
                            (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13
                             + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                            if change_dc else (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
                            Q02)
                    if change_dc:
                        if cb[6] != 0 and w[3] == 0:
                            w[3] = _estimate(cb[6], Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14
                                                           + DC17 - DC19), Q03)
                        if cb[7] != 0 and w[10] == 0:
                            w[10] = _estimate(cb[7], Q00 * (DC07 - 3 * DC08 + DC09 - DC17
                                                            + 3 * DC18 - DC19), Q12)
                        if cb[8] != 0 and w[17] == 0:
                            w[17] = _estimate(cb[8], Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14
                                                            + DC17 - DC19), Q21)
                        if cb[9] != 0 and w[24] == 0:
                            w[24] = _estimate(cb[9], Q00 * (DC07 + 2 * DC08 + DC09 - DC17
                                                            - 2 * DC18 - DC19), Q30)
                        w[0] = _estimate(0, Q00 * (
                            -2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06
                            + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12
                            + 152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17
                            + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23
                            - 6 * DC24 - 2 * DC25), Q00)
                    for i in range(5):  # slide one column on; the last stays
                        D[i] = D[i][1:] + D[i][4:]
    return out


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
