// JPEG decoding for the port (facesr_torch/data/jpeg.py): the same
// arithmetic as libjpeg-turbo's default decompression, which is what cv2
// uses, so the result is bitwise cv2.imread's.
//
// Two plain C entries for ctypes (which releases the GIL, so loader
// threads decode in parallel):
//
//   jpeg_entropy      every scan's Huffman-coded data -> int16 coefficient
//                     planes: sequential and progressive scans (DC first
//                     and refine, AC first and refine, EOB runs), restart
//                     intervals. One call an image.
//   jpeg_reconstruct  dequantisation, the islow IDCT (jidctint.c), fancy
//                     upsampling (jdsample.c), YCbCr -> RGB (jdcolor.c).
//
// The plan they take is parsed from the markers in Python; its layout is
// documented in facesr_torch/native/jpeg_numpy.py, whose functions are the
// plain versions of these two, bit for bit.
//
// Build: g++ -O3 -shared -fPIC -o libjpeg_decode.so jpeg_decode.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum { ERR_BAD_CODE = 1, ERR_PAST_END = 2, ERR_RESTART = 3, ERR_INDEX = 4,
       ERR_REFINE = 5, ERR_TABLE = 6 };

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

// MSB-first bits of one restart interval. Reading stops at a marker; what
// follows is zeros, and taking one of those bits is an error (the data
// ended inside an MCU).
struct Bits {
  const uint8_t* data;
  int64_t pos, end;  // next byte to read; end of the scan's data
  uint64_t acc = 0;
  int n = 0;      // bits in acc
  int real = 0;   // of which read from the data
  bool marker = false;
  int err = 0;

  void fill() {
    while (n <= 56) {
      uint8_t b = 0;
      if (!marker && pos < end) {
        b = data[pos];
        if (b == 0xFF) {
          int64_t j = pos + 1;
          while (j < end && data[j] == 0xFF) ++j;
          if (j < end && data[j] == 0x00) {
            pos = j + 1;
          } else {
            marker = true;  // pos stays on the marker
            b = 0;
          }
        } else {
          ++pos;
        }
        if (!marker) real += 8;
      } else {
        marker = true;
      }
      acc |= (uint64_t)b << (56 - n);
      n += 8;
    }
  }
  inline uint32_t peek(int k) {
    if (n < k) fill();
    return (uint32_t)(acc >> (64 - k));
  }
  inline void skip(int k) {
    if (k > real) err = ERR_PAST_END;
    acc <<= k;
    n -= k;
    real -= k;
  }
  inline int32_t get(int k) {
    if (k == 0) return 0;
    const int32_t v = (int32_t)peek(k);
    skip(k);
    return v;
  }
  int decode(const Huffman& t) {
    const uint32_t look = peek(16);
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
    err = ERR_BAD_CODE;
    return 0;
  }
};

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct ScanState {
  int ss, se, ah, al;
  bool progressive;
  int32_t pred[4];
  int32_t eobrun;
};

// One block of one scan; returns an error code or 0.
int decode_block(Bits& br, int16_t* blk, int slot, const Huffman* dc, const Huffman* ac,
                 ScanState& st) {
  if (!st.progressive) {
    int s = br.decode(*dc);
    if (s) st.pred[slot] += extend(br.get(s), s);
    blk[0] = (int16_t)st.pred[slot];
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(*ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return ERR_INDEX;
        blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
      if (br.err) return br.err;
    }
    return br.err;
  }
  if (st.ss == 0) {  // DC scans
    if (st.ah == 0) {
      const int s = br.decode(*dc);
      if (s) st.pred[slot] += extend(br.get(s), s);
      blk[0] = (int16_t)(st.pred[slot] * (1 << st.al));
    } else if (br.get(1)) {
      blk[0] = (int16_t)(blk[0] | (1 << st.al));
    }
    return br.err;
  }
  if (st.ah == 0) {  // AC first
    if (st.eobrun > 0) {
      --st.eobrun;
      return 0;
    }
    for (int k = st.ss; k <= st.se; ++k) {
      const int rs = br.decode(*ac);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return ERR_INDEX;
        blk[kNatural[k]] = (int16_t)(extend(br.get(s), s) * (1 << st.al));
      } else {
        if (r != 15) {
          st.eobrun = 1 << r;
          if (r) st.eobrun += br.get(r);
          --st.eobrun;
          break;
        }
        k += 15;
      }
      if (br.err) return br.err;
    }
    return br.err;
  }
  // AC refinement
  const int p1 = 1 << st.al, m1 = -(1 << st.al);
  int k = st.ss;
  if (st.eobrun == 0) {
    for (; k <= st.se; ++k) {
      const int rs = br.decode(*ac);
      int r = rs >> 4;
      int s = rs & 15;
      if (br.err) return br.err;
      if (s) {
        if (s != 1) return ERR_REFINE;
        s = br.get(1) ? p1 : m1;
      } else if (r != 15) {
        st.eobrun = 1 << r;
        if (r) st.eobrun += br.get(r);
        break;
      }
      while (true) {
        int16_t& c = blk[kNatural[k]];
        if (c != 0) {
          if (br.get(1) && (c & p1) == 0) c = (int16_t)(c >= 0 ? c + p1 : c + m1);
        } else if (--r < 0) {
          break;
        }
        if (++k > st.se) break;
      }
      if (s) {
        if (k > 63) return ERR_INDEX;
        blk[kNatural[k]] = (int16_t)s;
      }
      if (br.err) return br.err;
    }
  }
  if (st.eobrun > 0) {
    for (; k <= st.se; ++k) {
      int16_t& c = blk[kNatural[k]];
      if (c != 0 && br.get(1) && (c & p1) == 0) c = (int16_t)(c >= 0 ? c + p1 : c + m1);
    }
    --st.eobrun;
  }
  return br.err;
}

// The offset of the next marker (0xFF then neither 0x00 nor 0xFF) at or
// after pos, or end.
int64_t next_marker(const uint8_t* d, int64_t pos, int64_t end) {
  while (pos < end) {
    if (d[pos] != 0xFF) {
      ++pos;
      continue;
    }
    int64_t j = pos + 1;
    while (j < end && d[j] == 0xFF) ++j;
    if (j >= end) return end;
    if (d[j] != 0x00) return pos;
    pos = j + 1;
  }
  return end;
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
// caller. Returns 0, or an error code with where[0] = scan, where[1] = MCU.
int32_t jpeg_entropy(const uint8_t* data, int64_t len, const int32_t* frame,
                     const int32_t* comps, const int32_t* scans, int32_t nscans,
                     const uint8_t* huff, int16_t* out, int32_t* where) {
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
    const int64_t per = restart > 0 ? restart : total;
    int64_t pos = sc[17], mcu = 0;
    for (int interval = 0; mcu < total; ++interval) {
      if (interval > 0) {
        int64_t j = pos + 1;
        while (j < end && data[j] == 0xFF) ++j;
        if (pos >= end || data[pos] != 0xFF || j >= end ||
            data[j] != 0xD0 + ((interval - 1) & 7)) {
          where[1] = (int32_t)mcu;
          return ERR_RESTART;
        }
        pos = j + 1;
      }
      Bits br;
      br.data = data;
      br.pos = pos;
      br.end = end;
      st.pred[0] = st.pred[1] = st.pred[2] = st.pred[3] = 0;
      st.eobrun = 0;
      const int64_t stop = mcu + per < total ? mcu + per : total;
      for (; mcu < stop; ++mcu) {
        int err = 0;
        if (ns > 1) {
          const int64_t my = mcu / mcux, mx = mcu % mcux;
          for (const Unit& u : units) {
            const int32_t* cp = comps + 8 * u.c;
            const int64_t by = my * cp[1] + u.dy, bx = mx * cp[0] + u.dx;
            err = decode_block(br, out + 64 * (offset[u.c] + by * cp[2] + bx), u.slot,
                               dc[u.slot], ac[u.slot], st);
            if (err) break;
          }
        } else {
          const int c = sc[1];
          const int32_t* cp = comps + 8 * c;
          const int64_t by = mcu / cp[4], bx = mcu % cp[4];
          err = decode_block(br, out + 64 * (offset[c] + by * cp[2] + bx), 0, dc[0], ac[0], st);
        }
        if (err) {
          where[1] = (int32_t)mcu;
          return err;
        }
      }
      pos = br.marker ? br.pos : next_marker(data, br.pos, end);
    }
  }
  return 0;
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
