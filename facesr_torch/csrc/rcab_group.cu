// One residual group of FaceEnhanceNet (B RCABs + tail conv + group skip),
// forward, NHWC, bf16 in and out, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_group_kernel` / `fused_residual_group`
// in facesr/ops/pallas/rcab_group.py. Per RCAB k:
//     t1   = PReLU_a(conv3x3(bf16(feat), w1) + b1)
//     t2   = conv3x3(bf16(t1), w2) + b2
//     gate = sigmoid(fc2 . relu(fc1 . mean_hw(t2)))
//     feat = feat + (t2 * gate) * res_scale
// then out = bf16(conv3x3(bf16(feat), wg) + bg + x). feat stays float32 for
// the whole group; every conv input is rounded to bf16 as it is loaded;
// conv products are bf16 x bf16 with f32 accumulation and the bias is added
// in f32 — the rounding points of the Pallas kernel.
//
// What bounds it on this card: the 2B+1 3x3 64->64 convs are ~99% of the
// arithmetic; at N=128, 64x64, B=10 a group is 812 GFLOP, 0.82 ms at the
// bf16 tensor-core peak, while its unavoidable HBM traffic (x, out, weights)
// is ~0.14 GB, 41 us. So it is compute-bound in principle. The Pallas design
// kept one image (512 KB) plus all B RCABs' weights (~1.5 MB) in VMEM for
// the whole group; a Hopper block has at most 227 KB of shared memory, one
// 3x3 64->64 bf16 weight alone is 72 KB, and the SE mean needs every tile of
// an image before the residual update. So this design splits each RCAB into
// launches that pass f32/bf16 intermediates through HBM (~8 GB per group
// call at N=128):
//   (a) conv3x3_kernel: persistent implicit-GEMM 3x3 SAME conv, two blocks
//       an SM so one block's halo load overlaps the other's MMAs. A block
//       keeps the whole [9*64, 64] bf16 weight in shared memory for all its
//       tiles, loads the zero-padded 10x18x64 halo of its next 8x16-pixel
//       tile into registers while the current tile's MMAs run (then rounds
//       f32 to bf16 into shared memory), and multiplies with mma.sync
//       m16n8k16 bf16 tensor-core ops fed by ldmatrix from 144-byte rows
//       (conflict-free), accumulating in f32.
//       The epilogue adds the bias and then, by mode: PReLU and a bf16 store
//       (conv1); an f32 store plus deterministic per-tile channel sums for
//       the SE mean (conv2); the group input and a bf16 store (tail conv).
//   (b) se_gate_kernel: one block per image reduces the tile sums in a fixed
//       order, then mean -> fc1 -> ReLU -> fc2 -> sigmoid in f32.
//   (c) residual_update_kernel: feat += (t2 * gate) * res_scale in f32.
// Fusing (c) into the next conv's prologue and moving the conv to
// wgmma/TMA is the later redesign for speed.
//
// Plain C entry `rcab_group_forward` issues every launch of one group call
// on the caller's stream and returns the first cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;             // channels (the kernel's only width)
constexpr int TH = 8;             // output tile rows
constexpr int TW = 16;            // output tile cols (= the MMA's 16 rows)
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;
constexpr int LDS = C + 8;        // smem row stride in bf16 (144 bytes): the
                                  // 8 rows of an ldmatrix phase hit 8
                                  // distinct 16-byte bank groups
constexpr int WARPS = TH / 2;     // each warp: 2 output rows x 16 px x 64 ch
constexpr int THREADS = WARPS * 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int KROWS = 9 * C;      // GEMM depth: (dy, dx, cin)
constexpr int LOAD_BATCH = 8;     // 16-byte global loads in flight a thread

constexpr size_t W_SMEM = size_t(KROWS) * LDS * sizeof(__nv_bfloat16);
constexpr size_t HALO_SMEM = size_t(HALO_H) * HALO_W * LDS * sizeof(__nv_bfloat16);
constexpr size_t PSUM_SMEM = size_t(WARPS) * C * sizeof(float);
constexpr size_t CONV_SMEM = W_SMEM + HALO_SMEM + PSUM_SMEM;

enum ConvMode { PRELU_BF16 = 0, BIAS_F32_SUMS = 1, SKIP_BF16 = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, col-major), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-byte global load of an input pixel's channels and its bf16 store
// into the halo: f32 input carries 4 channels (rounded to nearest even),
// bf16 input 8.
template <typename Tin>
struct HaloVec;

template <>
struct HaloVec<float> {
  using V = float4;
  static constexpr int CH = 4;
  __device__ static V zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void store(__nv_bfloat16* dst, const V& v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
};

template <>
struct HaloVec<__nv_bfloat16> {
  using V = uint4;
  static constexpr int CH = 8;
  __device__ static V zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void store(__nv_bfloat16* dst, const V& v) {
    *reinterpret_cast<uint4*>(dst) = v;
  }
};

// out[n, y, x, :] = epilogue(sum_{dy,dx,cin} in[n, y+dy-1, x+dx-1, cin] *
//                            w[(dy*3+dx)*C + cin, :] + bias)
template <typename Tin, int MODE>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
conv3x3_kernel(const Tin* __restrict__ in, const __nv_bfloat16* __restrict__ wt,
               const float* __restrict__ bias, const float* __restrict__ alpha,
               const __nv_bfloat16* __restrict__ skip, void* __restrict__ out,
               float* __restrict__ tile_sums, int n_img, int h, int w) {
  using HV = HaloVec<Tin>;
  using V = typename HV::V;
  constexpr int PER_PX = C / HV::CH;
  constexpr int HALO_ITEMS = HALO_H * HALO_W * PER_PX;
  constexpr int HALO_PER_THREAD = (HALO_ITEMS + THREADS - 1) / THREADS;
  constexpr int W_ITEMS = KROWS * (C / 8);

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hsm = reinterpret_cast<__nv_bfloat16*>(smem + W_SMEM);
  float* psum = reinterpret_cast<float*>(smem + W_SMEM + HALO_SMEM);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the whole weight, once per block, LOAD_BATCH vectors in flight a thread
  for (int base = 0; base < W_ITEMS; base += LOAD_BATCH * THREADS) {
    uint4 v[LOAD_BATCH];
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int i = base + j * THREADS + tid;
      if (i < W_ITEMS)
        v[j] = *reinterpret_cast<const uint4*>(wt + (i >> 3) * C + (i & 7) * 8);
    }
#pragma unroll
    for (int j = 0; j < LOAD_BATCH; ++j) {
      const int i = base + j * THREADS + tid;
      if (i < W_ITEMS) *reinterpret_cast<uint4*>(wsm + (i >> 3) * LDS + (i & 7) * 8) = v[j];
    }
  }

  const int tiles_h = (h + TH - 1) / TH;
  const int tiles_w = (w + TW - 1) / TW;
  const int tiles_img = tiles_h * tiles_w;
  const int n_tiles = n_img * tiles_img;

  // ldmatrix row addresses of this lane: A rows are the 16 pixels of an
  // output row (second 8 channels for lanes 16-31); B rows are k = cin
  const int a_px = lane & 15, a_ch = (lane >> 4) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8, b_n = (lane >> 4) * 8;
  const uint32_t w_base = smem_addr(wsm);
  const uint32_t h_base = smem_addr(hsm);
  const int g = lane >> 2, t = lane & 3;  // accumulator row group, column pair
  const int r0 = warp * 2;                // this warp's first output row in the tile

  // The halo of the block's next tile is loaded into registers while the
  // current tile's MMAs run (HALO_PER_THREAD 16-byte loads in flight a
  // thread), then stored to shared memory between tiles.
  V v[HALO_PER_THREAD];
  auto load_halo = [&](int tile) {
    const int n = tile / tiles_img;
    const int t_in = tile % tiles_img;
    const int y0 = (t_in / tiles_w) * TH, x0 = (t_in % tiles_w) * TW;
#pragma unroll
    for (int j = 0; j < HALO_PER_THREAD; ++j) {
      const int i = j * THREADS + tid;
      const int px = i / PER_PX, q = i % PER_PX;
      const int iy = y0 - 1 + px / HALO_W, ix = x0 - 1 + px % HALO_W;
      v[j] = HV::zero();
      if (i < HALO_ITEMS && iy >= 0 && iy < h && ix >= 0 && ix < w)
        v[j] = *reinterpret_cast<const V*>(in + ((size_t(n) * h + iy) * w + ix) * C + q * HV::CH);
    }
  };
  if (blockIdx.x < n_tiles) load_halo(blockIdx.x);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n = tile / tiles_img;
    const int t_in = tile % tiles_img;
    const int y0 = (t_in / tiles_w) * TH;
    const int x0 = (t_in % tiles_w) * TW;

    __syncthreads();  // the previous tile is done with hsm and psum
#pragma unroll
    for (int j = 0; j < HALO_PER_THREAD; ++j) {
      const int i = j * THREADS + tid;
      if (i < HALO_ITEMS) HV::store(hsm + (i / PER_PX) * LDS + (i % PER_PX) * HV::CH, v[j]);
    }
    __syncthreads();
    if (tile + gridDim.x < n_tiles) load_halo(tile + gridDim.x);

    float acc[2][8][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rr][nb][e] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t b[8][2];
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, w_base + ((tap * C + kc * 16 + b_k) * LDS + np * 16 + b_n) * 2);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          uint32_t a[4];
          ldmatrix_x4(a, h_base + (((r0 + rr + dy) * HALO_W + dx + a_px) * LDS + kc * 16 + a_ch) * 2);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) mma_bf16(acc[rr][nb], a, b[nb][0], b[nb][1]);
        }
      }
    }

    // epilogue: acc[rr][nb] holds pixels g and g+8 of output row r0+rr,
    // channels nb*8 + 2t and nb*8 + 2t + 1
    float csum[8][2];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) csum[nb][0] = csum[nb][1] = 0.f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int oy = y0 + r0 + rr, ox = x0 + g + half * 8;
        if (oy >= h || ox >= w) continue;
        const size_t px_off = ((size_t(n) * h + oy) * w + ox) * C;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int c = nb * 8 + 2 * t;
          float v0 = acc[rr][nb][half * 2] + bias[c];
          float v1 = acc[rr][nb][half * 2 + 1] + bias[c + 1];
          if (MODE == PRELU_BF16) {
            v0 = v0 >= 0.f ? v0 : alpha[c] * v0;
            v1 = v1 >= 0.f ? v1 : alpha[c + 1] * v1;
          } else if (MODE == SKIP_BF16) {
            const float2 s = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(skip + px_off + c));
            v0 += s.x;
            v1 += s.y;
          }
          if (MODE == BIAS_F32_SUMS) {
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + px_off + c) =
                make_float2(v0, v1);
            csum[nb][0] += v0;
            csum[nb][1] += v1;
          } else {
            *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + px_off + c) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    if (MODE == BIAS_F32_SUMS) {
      // sum over the warp's pixels: lanes with the same t differ in bits 2..4
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = csum[nb][j];
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
          if (g == 0) psum[warp * C + nb * 8 + 2 * t + j] = s;
        }
      __syncthreads();
      if (tid < C) {
        float s = 0.f;
        for (int wi = 0; wi < WARPS; ++wi) s += psum[wi * C + tid];
        tile_sums[size_t(tile) * C + tid] = s;
      }
    }
  }
}

// gate[n, :] = sigmoid(fc2^T relu(fc1^T mean)), mean = sum of tile sums / HW
__global__ void se_gate_kernel(const float* __restrict__ tile_sums, int tiles_img,
                               float hw, const float* __restrict__ fc1,
                               const float* __restrict__ fc2, int cr,
                               float* __restrict__ gate) {
  __shared__ float y[C];
  __shared__ float z[C];
  const int n = blockIdx.x, c = threadIdx.x;
  float s = 0.f;
  for (int t = 0; t < tiles_img; ++t) s += tile_sums[(size_t(n) * tiles_img + t) * C + c];
  y[c] = s / hw;
  __syncthreads();
  if (c < cr) {
    float a = 0.f;
    for (int k = 0; k < C; ++k) a += y[k] * fc1[k * cr + c];  // fc1 [C, Cr]
    z[c] = fmaxf(a, 0.f);
  }
  __syncthreads();
  float g = 0.f;
  for (int j = 0; j < cr; ++j) g += z[j] * fc2[j * C + c];  // fc2 [Cr, C]
  gate[n * C + c] = 1.f / (1.f + expf(-g));
}

// feat += (t2 * gate[n, c]) * res_scale, 4 channels a thread
__global__ void residual_update_kernel(float* __restrict__ feat,
                                       const float* __restrict__ t2,
                                       const float* __restrict__ gate,
                                       size_t n_vec4, int hw, float res_scale) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n_vec4;
       i += size_t(gridDim.x) * blockDim.x) {
    const size_t e = i * 4;
    const int c = int(e % C);
    const size_t n = e / (size_t(hw) * C);
    float4 f = reinterpret_cast<float4*>(feat)[i];
    const float4 t = reinterpret_cast<const float4*>(t2)[i];
    const float* g = gate + n * C + c;
    f.x += (t.x * g[0]) * res_scale;
    f.y += (t.y * g[1]) * res_scale;
    f.z += (t.z * g[2]) * res_scale;
    f.w += (t.w * g[3]) * res_scale;
    reinterpret_cast<float4*>(feat)[i] = f;
  }
}

// feat = float(x)
__global__ void widen_kernel(const __nv_bfloat16* __restrict__ x,
                             float* __restrict__ feat, size_t n_vec2) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n_vec2;
       i += size_t(gridDim.x) * blockDim.x) {
    reinterpret_cast<float2*>(feat)[i] =
        __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(x)[i]);
  }
}

template <typename Tin, int MODE>
cudaError_t launch_conv(const Tin* in, const __nv_bfloat16* wt, const float* bias,
                        const float* alpha, const __nv_bfloat16* skip, void* out,
                        float* tile_sums, int n, int h, int w, int grid,
                        cudaStream_t stream) {
  auto* kernel = conv3x3_kernel<Tin, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(CONV_SMEM));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, CONV_SMEM, stream>>>(in, wt, bias, alpha, skip, out,
                                               tile_sums, n, h, w);
  return cudaGetLastError();
}

}  // namespace

// Tiles of one HxW image: the middle extent of the tile_sums scratch.
extern "C" int rcab_group_tiles_per_image(int h, int w) {
  return ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
}

#define RETURN_IF_ERR(expr)               \
  do {                                    \
    cudaError_t e_ = (expr);              \
    if (e_ != cudaSuccess) return int(e_); \
  } while (0)

// x, out: [N, H, W, 64] bf16. w1, w2: [B, 9*64, 64] bf16; b1, a, b2: [B, 64]
// f32; fc1: [B, 64, Cr] f32; fc2: [B, Cr, 64] f32; wg: [9*64, 64] bf16;
// bg: [64] f32. Scratch: feat, t2 [N, H, W, 64] f32; t1 [N, H, W, 64] bf16;
// tile_sums [N, rcab_group_tiles_per_image(H, W), 64] f32; gate [N, 64] f32.
extern "C" int rcab_group_forward(
    const void* x, void* out, const void* w1, const void* b1, const void* a,
    const void* w2, const void* b2, const void* fc1, const void* fc2,
    const void* wg, const void* bg, void* feat, void* t1, void* t2,
    void* tile_sums, void* gate, int n, int h, int w, int num_blocks, int cr,
    float res_scale, void* stream_ptr) {
  if (n <= 0 || h <= 0 || w <= 0 || num_blocks <= 0 || cr <= 0 || cr > C)
    return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int dev = 0, sms = 0;
  RETURN_IF_ERR(cudaGetDevice(&dev));
  RETURN_IF_ERR(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));

  const int tiles_img = rcab_group_tiles_per_image(h, w);
  const int n_tiles = n * tiles_img;
  const int grid = n_tiles < BLOCKS_PER_SM * sms ? n_tiles : BLOCKS_PER_SM * sms;
  const size_t elems = size_t(n) * h * w * C;
  const int ew_grid = sms * 8;

  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* featf = static_cast<float*>(feat);
  auto* t1b = static_cast<__nv_bfloat16*>(t1);
  auto* t2f = static_cast<float*>(t2);
  auto* sums = static_cast<float*>(tile_sums);
  auto* gatef = static_cast<float*>(gate);
  const auto* w1b = static_cast<const __nv_bfloat16*>(w1);
  const auto* w2b = static_cast<const __nv_bfloat16*>(w2);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* b2f = static_cast<const float*>(b2);
  const auto* af = static_cast<const float*>(a);
  const auto* fc1f = static_cast<const float*>(fc1);
  const auto* fc2f = static_cast<const float*>(fc2);

  widen_kernel<<<ew_grid, 256, 0, stream>>>(xb, featf, elems / 2);
  RETURN_IF_ERR(cudaGetLastError());
  for (int k = 0; k < num_blocks; ++k) {
    const size_t wo = size_t(k) * KROWS * C;
    RETURN_IF_ERR((launch_conv<float, PRELU_BF16>(
        featf, w1b + wo, b1f + k * C, af + k * C, nullptr, t1b, nullptr, n, h, w,
        grid, stream)));
    RETURN_IF_ERR((launch_conv<__nv_bfloat16, BIAS_F32_SUMS>(
        t1b, w2b + wo, b2f + k * C, nullptr, nullptr, t2f, sums, n, h, w, grid,
        stream)));
    se_gate_kernel<<<n, C, 0, stream>>>(sums, tiles_img, float(h * w),
                                        fc1f + size_t(k) * C * cr,
                                        fc2f + size_t(k) * cr * C, cr, gatef);
    RETURN_IF_ERR(cudaGetLastError());
    residual_update_kernel<<<ew_grid, 256, 0, stream>>>(featf, t2f, gatef, elems / 4,
                                                        h * w, res_scale);
    RETURN_IF_ERR(cudaGetLastError());
  }
  RETURN_IF_ERR((launch_conv<float, SKIP_BF16>(
      featf, static_cast<const __nv_bfloat16*>(wg), static_cast<const float*>(bg),
      nullptr, xb, out, nullptr, n, h, w, grid, stream)));
  return int(cudaSuccess);
}

// Bytes of dynamic shared memory one conv block asks for (for the build log).
extern "C" int rcab_group_conv_smem_bytes() { return int(CONV_SMEM); }
