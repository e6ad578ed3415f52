// PNG row unfiltering for the port's decoder (facesr_torch/data/png.py).
//
// The inflated image data is `height` rows of one filter-type byte and
// `rowbytes` filtered bytes. Each row is undone against the row above
// (zero above the first) with the PNG filters None, Sub, Up, Average and
// Paeth, `bpp` bytes to a pixel (8-bit samples: the channel count).
// A plain C entry for ctypes, which releases the GIL during the call, so
// loader threads unfilter in parallel.
//
// Build: g++ -O3 -shared -fPIC -o libpng_unfilter.so png_unfilter.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Writes height * rowbytes unfiltered bytes to dst. Returns 0, or 1 + the
// index of the first row whose filter type is not 0-4.
int32_t png_unfilter(const uint8_t* src, uint8_t* dst, int32_t height,
                     int64_t rowbytes, int32_t bpp) {
  for (int32_t y = 0; y < height; ++y) {
    const uint8_t* in = src + (int64_t)y * (rowbytes + 1);
    const uint8_t ftype = in[0];
    ++in;
    uint8_t* out = dst + (int64_t)y * rowbytes;
    const uint8_t* up = y > 0 ? out - rowbytes : nullptr;
    switch (ftype) {
      case 0:
        std::memcpy(out, in, rowbytes);
        break;
      case 1:  // Sub
        for (int64_t x = 0; x < rowbytes; ++x)
          out[x] = (uint8_t)(in[x] + (x >= bpp ? out[x - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t x = 0; x < rowbytes; ++x)
          out[x] = (uint8_t)(in[x] + (up ? up[x] : 0));
        break;
      case 3:  // Average
        for (int64_t x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          out[x] = (uint8_t)(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[x] = (uint8_t)(in[x] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
