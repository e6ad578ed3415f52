// Native batch assembler of the port's input pipeline (facesr_torch/data/
// fast_loader.py), a copy of the JAX package's facesr/native/batch_assembler.cpp.
//
// Fuses the per-sample host work of the training loader — random crop,
// horizontal flip, uint8 -> float32 [0,1] conversion, and batch stacking —
// into one parallel C++ pass. The Python path does this as four separate
// numpy operations per sample plus an np.stack copy; here each output
// element is written exactly once, with a std::thread pool across samples
// (cv2-style GIL-free parallelism, reference parallelism was torch
// DataLoader worker processes, src/data/dataset.py:344-352).
//
// Build: g++ -O3 -shared -fPIC -pthread -o libbatch_assembler.so batch_assembler.cpp
// ABI kept C-plain for ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// imgs[i]: HWC uint8 RGB image of size (heights[i], widths[i], 3).
// For each sample: crop a (crop x crop) window at (top[i], left[i]),
// flip horizontally iff flip[i], convert to float32/255, and write into
// out[i] (NHWC float32, [n, crop, crop, 3]).
void assemble_hr_batch(const uint8_t** imgs,
                       const int32_t* heights,
                       const int32_t* widths,
                       int32_t n,
                       int32_t crop,
                       const int32_t* top,
                       const int32_t* left,
                       const uint8_t* flip,
                       float* out,
                       int32_t nthreads) {
  const float inv = 1.0f / 255.0f;
  const int64_t sample_elems = (int64_t)crop * crop * 3;

  auto work = [&](int32_t begin, int32_t end) {
    for (int32_t i = begin; i < end; ++i) {
      const uint8_t* img = imgs[i];
      const int32_t W = widths[i];
      const int32_t t = top[i];
      const int32_t l = left[i];
      const bool f = flip[i] != 0;
      float* dst = out + (int64_t)i * sample_elems;
      for (int32_t y = 0; y < crop; ++y) {
        const uint8_t* row = img + ((int64_t)(t + y) * W + l) * 3;
        float* drow = dst + (int64_t)y * crop * 3;
        if (!f) {
          for (int32_t x = 0; x < crop * 3; ++x) drow[x] = row[x] * inv;
        } else {
          for (int32_t x = 0; x < crop; ++x) {
            const uint8_t* px = row + (int64_t)(crop - 1 - x) * 3;
            drow[x * 3 + 0] = px[0] * inv;
            drow[x * 3 + 1] = px[1] * inv;
            drow[x * 3 + 2] = px[2] * inv;
          }
        }
      }
    }
  };

  if (nthreads <= 1 || n <= 1) {
    work(0, n);
    return;
  }
  nthreads = std::min(nthreads, n);
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  const int32_t per = (n + nthreads - 1) / nthreads;
  for (int32_t k = 0; k < nthreads; ++k) {
    const int32_t b = k * per;
    const int32_t e = std::min(b + per, n);
    if (b < e) pool.emplace_back(work, b, e);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
