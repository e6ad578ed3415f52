// JPEG decoding for the port (facesr_torch/data/jpeg.py): the same
// arithmetic as libjpeg-turbo's default decompression, which is what cv2
// uses, so the result is bitwise cv2.imread's.
//
// Three plain C entries for ctypes (which releases the GIL, so loader
// threads decode in parallel):
//
//   jpeg_entropy      every scan's Huffman-coded data -> int16 coefficient
//                     planes: sequential and progressive scans (DC first
//                     and refine, AC first and refine, EOB runs), restart
//                     intervals, and faults in the data as libjpeg-turbo
//                     meets them (jdhuff.c, jdphuff.c, jdmarker.c). One
//                     call an image.
//   jpeg_smooth       block smoothing of a progressive file whose low
//                     coefficients are not all exact (jdcoefct.c
//                     decompress_smooth_data's estimates).
//   jpeg_reconstruct  dequantisation, the islow IDCT (jidctint.c), fancy
//                     upsampling (jdsample.c), YCbCr -> RGB (jdcolor.c).
//
// The plan they take is parsed from the markers in Python; its layout is
// documented in facesr_torch/native/jpeg_numpy.py, whose functions are the
// plain versions of these three, bit for bit.
//
// Build: g++ -O3 -shared -fPIC -o libjpeg_decode.so jpeg_decode.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum { ERR_TABLE = 6 };

const int kNatural[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;
constexpr int kRangeLimit = 8191;  // jpeg_numpy.RANGE_LIMIT

struct Huffman {
  // lookahead of kLookBits bits: (length << 8) | value, 0 = longer code
  uint16_t fast[1 << kLookBits];
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valoff[17];   // index of a length's first value minus its first code
  uint8_t vals[256];
};

// Build a table from 16 counts + values; false if its codes overflow.
bool build(const uint8_t* spec, Huffman* t) {
  int total = 0;
  for (int i = 0; i < 16; ++i) total += spec[i];
  if (total > 256) return false;
  std::memcpy(t->vals, spec + 16, total);
  std::memset(t->fast, 0, sizeof(t->fast));
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    const int n = spec[len - 1];
    t->valoff[len] = k - code;
    for (int i = 0; i < n; ++i, ++code, ++k) {
      if (len <= kLookBits) {
        const int shift = kLookBits - len;
        for (int f = code << shift; f < (code + 1) << shift; ++f)
          t->fast[f] = (uint16_t)((len << 8) | t->vals[k]);
      }
    }
    t->maxcode[len] = n ? code - 1 : -1;
    if (code >= (1 << len)) return false;  // no code may be all ones
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
  return true;
}

// The entropy-coded data as libjpeg-turbo's bit reader sees it (jdhuff.c
// jpeg_fill_bit_buffer): bytes are read MSB first, FF 00 is a data byte FF,
// and reading stops at a marker (FF then neither 00 nor FF), which becomes
// the unread marker; the end of the data counts as an EOI. Past the marker
// the reader gives zero bits. `real` counts the bits in acc that came from
// the data, so a negative value means the decoder took zero bits past the
// marker: libjpeg's insufficient_data.
struct Bits {
  const uint8_t* data;
  int64_t pos, end;  // next byte to read; end of the data
  uint64_t acc = 0;
  int n = 0;         // bits in acc
  int64_t real = 0;  // of which from the data
  int unread = 0;    // the marker the reader met (libjpeg's unread_marker), 0 if none

  void fill() {
    while (n <= 56) {
      uint8_t b = 0;
      if (!unread) {
        if (pos >= end) {
          unread = 0xD9;
        } else {
          b = data[pos++];
          if (b == 0xFF) {
            while (pos < end && data[pos] == 0xFF) ++pos;
            if (pos < end && data[pos] == 0x00) {
              ++pos;
            } else {
              unread = pos < end ? data[pos++] : 0xD9;
              b = 0;
            }
          }
          if (!unread) real += 8;
        }
      }
      acc |= (uint64_t)b << (56 - n);
      n += 8;
    }
  }
  // process_restart: the bits read ahead are dropped
  void discard() {
    acc = 0;
    n = 0;
    real = 0;
  }
  // jdmarker.c next_marker: skip to the next marker and make it unread
  void next_marker() {
    while (true) {
      while (pos < end && data[pos] != 0xFF) ++pos;
      while (pos < end && data[pos] == 0xFF) ++pos;
      if (pos >= end) {
        unread = 0xD9;
        return;
      }
      const uint8_t c = data[pos++];
      if (c != 0x00) {
        unread = c;
        return;
      }
    }
  }
  inline void skip(int k) {
    acc <<= k;
    n -= k;
    real -= k;
  }
  inline int32_t get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    const int32_t v = (int32_t)(acc >> (64 - k));
    skip(k);
    return v;
  }
  // jpeg_huff_decode: a code longer than 16 bits takes 17 bits and gives 0
  int decode(const Huffman& t) {
    if (n < 17) fill();
    const uint32_t look = (uint32_t)(acc >> 48);
    const uint16_t f = t.fast[look >> (16 - kLookBits)];
    if (f) {
      skip(f >> 8);
      return f & 0xFF;
    }
    for (int len = kLookBits + 1; len <= 16; ++len) {
      const int32_t code = (int32_t)(look >> (16 - len));
      if (code <= t.maxcode[len]) {
        skip(len);
        return t.vals[(t.valoff[len] + code) & 0xFF];
      }
    }
    skip(17);
    return 0;
  }
};

// jutils.c's jpeg_natural_order, with its 16 extra entries of 63, where
// corrupt data puts a coefficient past the block's end
inline int natural(int k) { return k < 64 ? kNatural[k] : 63; }

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

inline int16_t shifted(int32_t v, int al) { return (int16_t)(uint16_t)((uint32_t)v << al); }

struct ScanState {
  int ss, se, ah, al;
  bool progressive;
  int32_t pred[4];
  int32_t eobrun;
};

// One block of one scan (jdhuff.c decode_mcu_slow; jdphuff.c's four
// decode_mcu_* for progressive scans).
void decode_block(Bits& br, int16_t* blk, int slot, const Huffman* dc, const Huffman* ac,
                  ScanState& st) {
  if (!st.progressive) {
    int s = br.decode(*dc);
    if (s) st.pred[slot] = (int32_t)((uint32_t)st.pred[slot] + (uint32_t)extend(br.get(s), s));
    blk[0] = (int16_t)st.pred[slot];
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(*ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[natural(k)] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return;
  }
  if (st.ss == 0) {  // DC scans
    if (st.ah == 0) {
      const int s = br.decode(*dc);
      if (s) st.pred[slot] = (int32_t)((uint32_t)st.pred[slot] + (uint32_t)extend(br.get(s), s));
      blk[0] = shifted(st.pred[slot], st.al);
    } else if (br.get(1)) {
      blk[0] = (int16_t)(blk[0] | (1 << st.al));
    }
    return;
  }
  if (st.ah == 0) {  // AC first
    if (st.eobrun > 0) {
      --st.eobrun;
      return;
    }
    for (int k = st.ss; k <= st.se; ++k) {
      const int rs = br.decode(*ac);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[natural(k)] = shifted(extend(br.get(s), s), st.al);
      } else {
        if (r != 15) {
          st.eobrun = 1 << r;
          if (r) st.eobrun += br.get(r);
          --st.eobrun;
          break;
        }
        k += 15;
      }
    }
    return;
  }
  // AC refinement; a new coefficient wider than one bit is only warned about
  const int p1 = 1 << st.al, m1 = -(1 << st.al);
  int k = st.ss;
  if (st.eobrun == 0) {
    for (; k <= st.se; ++k) {
      const int rs = br.decode(*ac);
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {
        s = br.get(1) ? p1 : m1;
      } else if (r != 15) {
        st.eobrun = 1 << r;
        if (r) st.eobrun += br.get(r);
        break;
      }
      do {
        int16_t& c = blk[kNatural[k]];
        if (c != 0) {
          if (br.get(1) && (c & p1) == 0) c = (int16_t)(c >= 0 ? c + p1 : c + m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= st.se);
      if (s) blk[natural(k)] = (int16_t)s;
    }
  }
  if (st.eobrun > 0) {
    for (; k <= st.se; ++k) {
      int16_t& c = blk[kNatural[k]];
      if (c != 0 && br.get(1) && (c & p1) == 0) c = (int16_t)(c >= 0 ? c + p1 : c + m1);
    }
    --st.eobrun;
  }
}

// jdmarker.c jpeg_resync_to_restart: the unread marker is not RST`desired`.
// Action 1 drops it, 2 skips to the next marker and decides again, 3 keeps
// it (the interval is then empty).
void resync(Bits& br, int desired) {
  while (true) {
    const int m = br.unread;
    int action;
    if (m < 0xC0) {
      action = 2;
    } else if (m < 0xD0 || m > 0xD7) {
      action = 3;
    } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) {
      br.unread = 0;
      return;
    }
    if (action == 3) return;
    br.unread = 0;
    br.next_marker();
  }
}

// ---- reconstruction ----------------------------------------------------

// jidctint.c's 1-D kernel on x[0..7] (stride `in`), outputs descaled by n
// bits to y (stride `out`). With every input within kRangeLimit, each
// intermediate stays below 2^31, so 32-bit arithmetic is exact.
inline void idct_1d(const int32_t* x, int in, int32_t* y, int out, int n) {
  int32_t z2 = x[2 * in], z3 = x[6 * in];
  int32_t z1 = (z2 + z3) * 4433;
  const int32_t tmp2 = z1 + z3 * -15137;
  const int32_t tmp3 = z1 + z2 * 6270;
  const int32_t tmp0 = (x[0] + x[4 * in]) * 8192;
  const int32_t tmp1 = (x[0] - x[4 * in]) * 8192;
  const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int32_t t0 = x[7 * in], t1 = x[5 * in], t2 = x[3 * in], t3 = x[1 * in];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  int32_t z4 = t1 + t3;
  const int32_t z5 = (z3 + z4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  const int32_t half = 1 << (n - 1);
  y[0 * out] = (tmp10 + t3 + half) >> n;
  y[7 * out] = (tmp10 - t3 + half) >> n;
  y[1 * out] = (tmp11 + t2 + half) >> n;
  y[6 * out] = (tmp11 - t2 + half) >> n;
  y[2 * out] = (tmp12 + t1 + half) >> n;
  y[5 * out] = (tmp12 - t1 + half) >> n;
  y[3 * out] = (tmp13 + t0 + half) >> n;
  y[4 * out] = (tmp13 - t0 + half) >> n;
}

// One block -> 8x8 samples at dst (row stride `stride`); 0 or an error.
int idct_block(const int16_t* blk, const int32_t* qt, uint8_t* dst, int64_t stride) {
  int32_t d[64], ws[64], px[8];
  bool wide = false;
  for (int i = 0; i < 64; ++i) {
    const int64_t v = (int64_t)blk[i] * qt[i];
    wide |= v > kRangeLimit || v < -kRangeLimit;
    d[i] = (int32_t)v;
  }
  if (wide) return 1;
  for (int c = 0; c < 8; ++c) idct_1d(d + c, 8, ws + c, 8, 11);
  for (int i = 0; i < 64; ++i) wide |= ws[i] > kRangeLimit || ws[i] < -kRangeLimit;
  if (wide) return 2;
  for (int r = 0; r < 8; ++r) {
    idct_1d(ws + 8 * r, 1, px, 1, 18);
    uint8_t* o = dst + r * stride;
    for (int c = 0; c < 8; ++c) {
      const int32_t v = px[c] + 128;
      o[c] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
  return 0;
}

// A component's samples [dh, dw] -> the upsampled plane [H, W] (int16).
// Rows and columns outside the samples replicate the outermost ones.
void upsample(const uint8_t* p, int64_t ps, int dw, int dh, int hexp, int vexp, int W, int H,
              int16_t* out) {
  auto row = [&](int r) { return p + (int64_t)(r < 0 ? 0 : r >= dh ? dh - 1 : r) * ps; };
  const bool h2 = hexp == 2 && dw > 2;
  std::vector<int32_t> sums(dw + 2);
  for (int y = 0; y < H; ++y) {
    int16_t* o = out + (int64_t)y * W;
    if (hexp == 1 && vexp == 1) {
      const uint8_t* a = row(y);
      for (int x = 0; x < W; ++x) o[x] = a[x];
    } else if (hexp == 1 && vexp == 2) {
      const uint8_t* a = row(y >> 1);
      const uint8_t* b = row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x) o[x] = (int16_t)((3 * a[x] + b[x] + bias) >> 2);
    } else if (h2 && (vexp == 1 || vexp == 2)) {
      // 2h1v: the row itself; 2h2v: 3 x nearer row + farther row, then
      // (3 x this + neighbour + bias) >> 2 or >> 4
      const uint8_t* a = row(vexp == 1 ? y : y >> 1);
      if (vexp == 1) {
        for (int c = 0; c < dw; ++c) sums[c + 1] = a[c];
      } else {
        const uint8_t* b = row((y & 1) ? (y >> 1) + 1 : (y >> 1) - 1);
        for (int c = 0; c < dw; ++c) sums[c + 1] = 3 * a[c] + b[c];
      }
      sums[0] = sums[1];
      sums[dw + 1] = sums[dw];
      const int shift = vexp == 1 ? 2 : 4;
      const int even = vexp == 1 ? 1 : 8, odd = vexp == 1 ? 2 : 7;
      for (int x = 0; x < W; ++x) {
        const int c = (x >> 1) + 1;
        o[x] = (int16_t)((x & 1) ? (3 * sums[c] + sums[c + 1] + odd) >> shift
                                 : (3 * sums[c] + sums[c - 1] + even) >> shift);
      }
    } else {
      const uint8_t* a = row(y / vexp);
      for (int x = 0; x < W; ++x) o[x] = a[x / hexp];
    }
  }
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

}  // namespace

extern "C" {

// frame [mcux, mcuy, ncomp, progressive]; comps [ncomp, 8]; scans
// [nscans, 20]; huff [*, 272]; out [sum bw*bh, 64] int16, zeroed by the
// caller. Faults in the data are handled as libjpeg-turbo handles them
// (zero bits past a marker, the rest of the interval left as it is, a
// resync at a wrong restart marker). rows [nscans]: each scan's last iMCU
// row begun with data left (libjpeg's last_good_iMCU_row). Returns 0, or
// ERR_TABLE with where[0] = the scan.
int32_t jpeg_entropy(const uint8_t* data, int64_t len, const int32_t* frame,
                     const int32_t* comps, const int32_t* scans, int32_t nscans,
                     const uint8_t* huff, int16_t* out, int32_t* where, int32_t* rows) {
  const int mcux = frame[0], mcuy = frame[1], ncomp = frame[2];
  const bool progressive = frame[3] != 0;
  int64_t offset[5] = {0};
  for (int c = 0; c < ncomp; ++c)
    offset[c + 1] = offset[c] + (int64_t)comps[8 * c + 2] * comps[8 * c + 3];
  int ntables = 1;
  for (int si = 0; si < nscans; ++si)
    for (int j = 5; j < 13; ++j) ntables = scans[20 * si + j] + 1 > ntables ? scans[20 * si + j] + 1 : ntables;
  std::vector<Huffman> tables(ntables);  // never resized: the scans keep pointers
  std::vector<int> built(ntables, 0);
  auto table = [&](int idx) -> const Huffman* {
    if (!built[idx]) {
      if (!build(huff + 272 * (int64_t)idx, &tables[idx])) return nullptr;
      built[idx] = 1;
    }
    return &tables[idx];
  };
  for (int si = 0; si < nscans; ++si) {
    const int32_t* sc = scans + 20 * si;
    const int ns = sc[0];
    ScanState st{sc[13], sc[14], sc[15], sc[16], progressive, {0, 0, 0, 0}, 0};
    const int64_t end = sc[18] < len ? sc[18] : len;
    const int restart = sc[19];
    where[0] = si;
    where[1] = 0;
    const Huffman* dc[4] = {nullptr, nullptr, nullptr, nullptr};
    const Huffman* ac[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int j = 0; j < ns; ++j) {
      if (st.ss == 0 && st.ah == 0 && !(dc[j] = table(sc[5 + j]))) return ERR_TABLE;
      if (st.se > 0 && !(ac[j] = table(sc[9 + j]))) return ERR_TABLE;
    }
    // the blocks of one MCU: slot in the scan, component, row and col offset
    struct Unit { int slot, c, dy, dx; };
    std::vector<Unit> units;
    int64_t total;
    if (ns > 1) {
      for (int j = 0; j < ns; ++j) {
        const int c = sc[1 + j];
        for (int yy = 0; yy < comps[8 * c + 1]; ++yy)
          for (int xx = 0; xx < comps[8 * c]; ++xx) units.push_back({j, c, yy, xx});
      }
      total = (int64_t)mcux * mcuy;
    } else {
      const int c = sc[1];
      total = (int64_t)comps[8 * c + 4] * comps[8 * c + 5];
    }
    Bits br;
    br.data = data;
    br.pos = sc[17];
    br.end = end;
    int next_rst = 0;
    int64_t togo = restart;
    bool insufficient = false;
    for (int64_t mcu = 0; mcu < total; ++mcu) {
      if (restart > 0) {
        if (togo == 0) {  // process_restart + read_restart_marker
          br.discard();
          if (!br.unread) br.next_marker();
          if (br.unread == 0xD0 + next_rst)
            br.unread = 0;
          else
            resync(br, next_rst);
          next_rst = (next_rst + 1) & 7;
          st.pred[0] = st.pred[1] = st.pred[2] = st.pred[3] = 0;
          st.eobrun = 0;
          togo = restart;
          if (!br.unread) insufficient = false;
        }
        --togo;
      }
      if (insufficient) continue;  // out of data: the MCU is left as it is
      rows[si] = (int32_t)(ns > 1 ? mcu / mcux
                                  : mcu / comps[8 * sc[1] + 4] / comps[8 * sc[1] + 1]);
      if (ns > 1) {
        const int64_t my = mcu / mcux, mx = mcu % mcux;
        for (const Unit& u : units) {
          const int32_t* cp = comps + 8 * u.c;
          const int64_t by = my * cp[1] + u.dy, bx = mx * cp[0] + u.dx;
          decode_block(br, out + 64 * (offset[u.c] + by * cp[2] + bx), u.slot, dc[u.slot],
                       ac[u.slot], st);
        }
      } else {
        const int c = sc[1];
        const int32_t* cp = comps + 8 * c;
        const int64_t by = mcu / cp[4], bx = mcu % cp[4];
        decode_block(br, out + 64 * (offset[c] + by * cp[2] + bx), 0, dc[0], ac[0], st);
      }
      if (br.real < 0) insufficient = true;
    }
  }
  return 0;
}

// jdcoefct.c decompress_smooth_data's estimates, for a progressive file
// whose first ten coefficients are not all exact: a zero coefficient among
// them that is not known exact is estimated from the DC values of the 5x5
// blocks around (and, with no AC data at all, the DC too), each clamped to
// what its scans left unknown. coef and out [sum bw*bh, 64] (out starts as
// a copy of coef); latch [ncomp, 2, 10]: the coefficient bits of zigzag
// 0-9 after the last scan, and before it (rows past last_good take the
// second, as their last scan gave them nothing).
void jpeg_smooth(const int16_t* coef, const int32_t* comps, const int32_t* qts, int32_t ncomp,
                 int32_t imcu_rows, const int32_t* latch, int32_t last_good, int16_t* out) {
  int64_t off = 0;
  for (int c = 0; c < ncomp; ++c) {
    const int32_t* cp = comps + 8 * c;
    const int v = cp[1], bw = cp[2], bh = cp[3], nbw = cp[4], nbh = cp[5];
    const int16_t* plane = coef + 64 * off;
    int16_t* dst = out + 64 * off;
    auto dc = [&](int r, int col) { return (int64_t)plane[64 * ((int64_t)r * bw + col)]; };
    const int32_t* q = qts + 64 * c;
    const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2],
                  Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
    for (int imcu = 0; imcu < imcu_rows; ++imcu) {
      const int32_t* cb = latch + 20 * c + (imcu > last_good ? 10 : 0);
      bool change_dc = true;
      for (int k = 1; k < 10; ++k) change_dc &= cb[k] == -1;
      const int block_rows = imcu < imcu_rows - 1 ? v : (nbh % v ? nbh % v : v);
      const int image_block_rows = block_rows * imcu_rows;
      for (int br = 0; br < block_rows; ++br) {
        const int ibr = imcu * block_rows + br, row = imcu * v + br;
        int r[5];
        r[2] = row;
        r[1] = ibr > 0 ? row - 1 : row;
        r[0] = ibr > 1 ? row - 2 : r[1];
        r[3] = ibr < image_block_rows - 1 ? row + 1 : row;
        r[4] = ibr < image_block_rows - 2 ? row + 2 : r[3];
        int64_t D[5][5];  // D[i][j]: row r[i], column b - 2 + j (libjpeg's DC01-DC25)
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) D[i][j] = dc(r[i], 0);
        const int last = nbw - 1;
        for (int b = 0; b <= last; ++b) {
          int16_t* w = dst + 64 * ((int64_t)row * bw + b);
          if (b == 0 && last > 0)
            for (int i = 0; i < 5; ++i) D[i][3] = D[i][4] = dc(r[i], 1);
          if (b + 1 < last)
            for (int i = 0; i < 5; ++i) D[i][4] = dc(r[i], b + 2);
          const int64_t DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2], DC04 = D[0][3],
                        DC05 = D[0][4], DC06 = D[1][0], DC07 = D[1][1], DC08 = D[1][2],
                        DC09 = D[1][3], DC10 = D[1][4], DC11 = D[2][0], DC12 = D[2][1],
                        DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4], DC16 = D[3][0],
                        DC17 = D[3][1], DC18 = D[3][2], DC19 = D[3][3], DC20 = D[3][4],
                        DC21 = D[4][0], DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3],
                        DC25 = D[4][4];
          auto est = [](int al, int64_t num, int64_t qx) {
            int64_t pred;
            if (num >= 0) {
              pred = ((qx << 7) + num) / (qx << 8);
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            } else {
              pred = ((qx << 7) - num) / (qx << 8);
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
              pred = -pred;
            }
            return (int16_t)pred;
          };
          if (cb[1] != 0 && w[1] == 0)
            w[1] = est(cb[1], Q00 * (change_dc ?
                (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
                 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
                (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)), Q01);
          if (cb[2] != 0 && w[8] == 0)
            w[8] = est(cb[2], Q00 * (change_dc ?
                (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 +
                 DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)), Q10);
          if (cb[3] != 0 && w[16] == 0)
            w[16] = est(cb[3], Q00 * (change_dc ?
                (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
                 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
                (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)), Q20);
          if (cb[4] != 0 && w[9] == 0)
            w[9] = est(cb[4], Q00 * (change_dc ?
                (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
                (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
                 DC06 + 10 * DC07 - 10 * DC09)), Q11);
          if (cb[5] != 0 && w[2] == 0)
            w[2] = est(cb[5], Q00 * (change_dc ?
                (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
                 DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
                (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)), Q02);
          if (change_dc) {
            if (cb[6] != 0 && w[3] == 0)
              w[3] = est(cb[6], Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03);
            if (cb[7] != 0 && w[10] == 0)
              w[10] = est(cb[7], Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12);
            if (cb[8] != 0 && w[17] == 0)
              w[17] = est(cb[8], Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21);
            if (cb[9] != 0 && w[24] == 0)
              w[24] = est(cb[9], Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30);
            w[0] = est(0, Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                                 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                                 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                                 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                                 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25), Q00);
          }
          for (int i = 0; i < 5; ++i)  // slide one column on; the last stays
            for (int j = 0; j < 4; ++j) D[i][j] = D[i][j + 1];
        }
      }
    }
    off += (int64_t)bw * bh;
  }
}

// coef [sum bw*bh, 64] int16; comps [ncomp, 8]; qts [ncomp, 64] natural
// order; color 0 grey, 1 YCbCr, 2 RGB; out [height, width, 3] RGB.
// Returns 0, 1 or 2 (a value beyond the exact range), 3 (a fractional
// sampling ratio).
int32_t jpeg_reconstruct(const int16_t* coef, const int32_t* comps, const int32_t* qts,
                         int32_t ncomp, int32_t width, int32_t height, int32_t color,
                         uint8_t* out) {
  int hmax = 1, vmax = 1;
  for (int c = 0; c < ncomp; ++c) {
    if (comps[8 * c] > hmax) hmax = comps[8 * c];
    if (comps[8 * c + 1] > vmax) vmax = comps[8 * c + 1];
  }
  const int used = color == 0 ? 1 : ncomp;
  const int64_t npix = (int64_t)width * height;
  std::vector<int16_t> planes((size_t)npix * used);
  const int16_t* blocks = coef;
  for (int c = 0; c < used; ++c) {
    const int32_t* cp = comps + 8 * c;
    const int h = cp[0], v = cp[1], bw = cp[2], bh = cp[3], nbw = cp[4], nbh = cp[5];
    const int dw = cp[6], dh = cp[7];
    if (hmax % h || vmax % v) return 3;
    const int64_t ps = (int64_t)nbw * 8;
    std::vector<uint8_t> samples((size_t)(ps * nbh * 8));
    for (int by = 0; by < nbh; ++by)
      for (int bx = 0; bx < nbw; ++bx) {
        const int err = idct_block(blocks + 64 * ((int64_t)by * bw + bx), qts + 64 * c,
                                   samples.data() + (int64_t)by * 8 * ps + bx * 8, ps);
        if (err) return err;
      }
    upsample(samples.data(), ps, dw, dh, hmax / h, vmax / v, width, height,
             planes.data() + npix * c);
    blocks += 64 * (int64_t)bw * bh;
  }
  if (color == 0) {
    for (int64_t i = 0; i < npix; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = (uint8_t)planes[i];
    return 0;
  }
  const int16_t* p0 = planes.data();
  const int16_t* p1 = p0 + npix;
  const int16_t* p2 = p1 + npix;
  if (color == 2) {
    for (int64_t i = 0; i < npix; ++i) {
      out[3 * i] = (uint8_t)p0[i];
      out[3 * i + 1] = (uint8_t)p1[i];
      out[3 * i + 2] = (uint8_t)p2[i];
    }
    return 0;
  }
  int32_t cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = (int32_t)((91881 * x + 32768) >> 16);
    cb_b[i] = (int32_t)((116130 * x + 32768) >> 16);
    cr_g[i] = -46802 * x;
    cb_g[i] = -22554 * x + 32768;
  }
  for (int64_t i = 0; i < npix; ++i) {
    const int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i] = clamp255(y + cr_r[cr]);
    out[3 * i + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
    out[3 * i + 2] = clamp255(y + cb_b[cb]);
  }
  return 0;
}

}  // extern "C"
