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
// the whole group; every conv input is bf16 of that f32 value; conv
// products are bf16 x bf16 with f32 accumulation and the bias is added in
// f32 — the rounding points of the Pallas kernel.
//
// What bounds it on this card: the 2B+1 3x3 64->64 convs are ~99% of the
// arithmetic; at N=128, 64x64, B=10 a group is 812 GFLOP, 0.82 ms at the
// bf16 tensor-core peak, while its unavoidable HBM traffic (x, out,
// weights) is ~0.14 GB, 41 us. So it is compute-bound once the RCAB
// intermediates stay out of HBM. The Pallas design kept one image and the
// weights in VMEM for the whole group; a Hopper block has 227 KB of shared
// memory, and the SE mean needs every pixel of an image before the update.
//
// Design: one launch a group call. A persistent grid of thread-block
// clusters walks the images, one image a cluster at a time; the blocks of
// a cluster own row bands of it. Every RCAB stage is separated by a wait on
// the other blocks, not by a launch. The SE mean is the only cross-block
// reduction: each block stores its per-channel sums into every block of the
// cluster (DSMEM) and every block sums them in rank order, so the gate is
// computed without atomics and the same every run. The residual update
// runs in the same kernel and also produces bf16(feat), so every conv reads
// bf16. Two variants of this design, by image size:
//
//  * resident (W <= 64, 8 <= H <= 64; the serving shape): clusters of 8 or
//    16 blocks so a band is at most 4 rows, two a warpgroup. Nothing of an
//    RCAB leaves the chip: each warpgroup keeps its rows' f32 feat and conv
//    accumulators in registers for the whole group call; a conv's epilogue
//    writes the next conv's bf16 input rows into the block's own shared
//    memory and pushes the band's edge rows into the neighbours' halo rows.
//    Data between blocks (those rows, the SE sums) goes by st.async, whose
//    bytes count on the receiving block's mbarrier, so a block waits for
//    exactly the bytes it reads: its neighbours' rows before the taps that
//    read them, every block's sums before the gate (double-buffered). One
//    cluster barrier a conv orders the reuse of buffers: each block arrives
//    when its MMAs of conv q are done and waits late in that conv's
//    epilogue; past it, every block may overwrite the halo rows and the
//    weight buffer conv q read, so the edge rows go out and conv q + 2's
//    weight starts loading (by TMA, one slice a block multicast to the
//    cluster, into the buffer conv q used). Its arrive is relaxed: the
//    release arrive compiles to a GPU-scope memory barrier (MEMBAR.ALL.GPU)
//    that took ~1,000 SM cycles an arrive. HBM sees x, out and the weights.
//  * scratch (any other H x W): the same phases with feat, t2 (f32) and
//    bf16(feat), t1 (bf16) in global scratch sized for the images in
//    flight, one per cluster (~3 MB at 64x64), not for the batch; a larger
//    image only loses L2 residency. Input bands come by TMA as a 4-D box
//    over NHWC whose out-of-bounds zero fill is the SAME padding, in a
//    two-stage ring; the residual update is a pass over the band. Its
//    stages are separated by release/acquire cluster barriers, which
//    publish the global scratch and the SE sums.
//
// Conv mainloops: implicit GEMMs over K = 9 taps x 64 input channels with
// f32 accumulators; the [576, 64] weight sits in 128-byte-swizzled shared
// memory (TMA) and is read through an MN-major SW128 descriptor.
//
//  * resident: pixels are the N operand. D[64 out, 136 slots] =
//    W[64 out, 16 in] (A, shared memory) x X[16 in, 136 slots] (B, shared
//    memory, K-major: a slot's 64 channels in one 128-byte row), one
//    m64n136k16 a tap and 16 channels. The band's input rows and its halo
//    rows lie in one run of rows of 66 slots (the halo columns included),
//    so a warpgroup's two output rows and the two halo columns between them
//    are one run of 136 slots for every tap, which starts dy rows and dx
//    slots on: the descriptor's start moves, and the swizzle follows the
//    absolute address. Each wgmma reads 2 KB of A and 4.25 KB of B for 2.1
//    times the work of an m64n64k16, which reads 4 KB: shared-memory
//    bandwidth is what bounds the MMA passes (measured on an H100 with
//    clock64 marks, facesr_torch/cli/profile_group.py: with pixels as M
//    and A by ldmatrix, a pass of 72 m64n64k16 ran at ~75% of the tensor
//    peak, ~96% when A was loaded once a dy instead of once a tap). With
//    no operand in registers, all of a pass's wgmmas are in flight
//    together; the epilogue writes rows back transposed by stmatrix.trans.
//  * scratch: pixels are the M operand, M = 64 pixels of one image row (a
//    narrower row is masked, a wider one takes several M-tiles), N = 64
//    output channels, wgmma m64n64k16 with A from registers (ldmatrix; the
//    dx shift is a per-lane row address) and the weight as B.
//
// Plain C entries: `rcab_group_plan` picks the variant, the cluster size
// and the number of clusters (the scratch extent), `rcab_group_forward`
// makes the one launch on the caller's stream and returns the first
// cudaError_t of its own calls. Both may be called from many host threads
// at once. Each sets the kernel's attributes in the calling thread before
// it queries or launches: set once from one thread, they did not hold for
// launches from other threads on the H100 (cudaErrorInvalidValue).

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;              // channels (the kernel's only width)
constexpr int TILE = 64;           // pixels of one M-tile (a row, or 64 px of one)
constexpr int NWG = 2;             // warpgroups a block, one M-tile each at a time
constexpr int THREADS = NWG * 128;
constexpr int WARPS = THREADS / 32;
constexpr int KROWS = 9 * C;       // GEMM depth: (dy, dx, cin)
constexpr int BOX_W = TILE + 2;    // an input row: the tile and its two halo columns
constexpr uint32_t ROW_BYTES = BOX_W * C * 2;
constexpr uint32_t W_BYTES = KROWS * C * 2;

// scratch variant: a stage is ROWS image rows (ROWS / NWG tiles a warpgroup)
constexpr int ROWS = 4;
constexpr int BOX_H = ROWS + 2;
constexpr int W_BOX_ROWS = 192;    // weight rows a TMA box (box extents <= 256)
constexpr uint32_t STAGE_BYTES = BOX_H * ROW_BYTES;
constexpr uint32_t STAGE_STRIDE = (STAGE_BYTES + 1023) / 1024 * 1024;
constexpr int STAGES = 2;
constexpr int UPDATE_BATCH = 8;    // residual-update vectors in flight a thread
constexpr int STG_LD = C + 8;      // row stride of the epilogue staging, in elements

// shared memory of the scratch variant, from a 1024-byte-aligned base
constexpr uint32_t OFF_W = 0;
constexpr uint32_t OFF_STAGE = OFF_W + W_BYTES;
constexpr uint32_t OFF_STG = OFF_STAGE + STAGES * STAGE_STRIDE;  // [warps][16][STG_LD] f32
constexpr uint32_t OFF_MISC = OFF_STG + WARPS * 16 * STG_LD * 4;

// resident variant: a band of at most RES_ROWS rows, two a warpgroup
constexpr int RES_ROWS = 4;
constexpr int R_BUF_ROWS = RES_ROWS + 2;  // the row above the band, the band, the row below
constexpr int R_N = 136;                  // wgmma N: two rows of BOX_W slots, to a multiple of 8
constexpr int R_ACC = R_N / 2;            // f32 accumulators a thread of a warpgroup
// the input rows and the slack that a tap's last run reads past them
constexpr uint32_t R_BUF_BYTES = ((R_BUF_ROWS * BOX_W + 12) * 128 + 1023) / 1024 * 1024;
constexpr uint32_t R_OFF_W = 0;                    // two weight buffers
constexpr uint32_t R_OFF_S = 2 * W_BYTES;          // the input rows
constexpr uint32_t R_OFF_MISC = R_OFF_S + R_BUF_BYTES;
constexpr uint32_t PUSH_BYTES = TILE * C * 2;  // a band row pushed into a neighbour's halo row

// the small arrays both variants keep (from OFF_MISC / R_OFF_MISC)
constexpr uint32_t M_WSUM = 0;                     // [warps][C] per-warp channel sums
constexpr uint32_t M_ALLSUM = M_WSUM + WARPS * C * 4;  // [2][16][C] every block's channel sums
constexpr uint32_t M_MEAN = M_ALLSUM + 2 * 16 * C * 4;
constexpr uint32_t M_Z = M_MEAN + C * 4;
constexpr uint32_t M_GATE = M_Z + C * 4;
constexpr uint32_t M_BIAS = M_GATE + C * 4;        // the current conv's bias
constexpr uint32_t M_ALPHA = M_BIAS + C * 4;       // and PReLU slopes
constexpr uint32_t M_WGSUM = M_ALPHA + C * 4;      // [NWG][C] warpgroup channel sums (resident)
constexpr uint32_t M_DUMMY = M_WGSUM + NWG * C * 4;  // 16 bytes no one reads
constexpr uint32_t M_BAR = M_DUMMY + 16;           // mbarriers
constexpr int N_BARS = 6;
constexpr uint32_t M_BYTES = M_BAR + 8 * N_BARS;

constexpr size_t SMEM_BYTES = OFF_MISC + M_BYTES + 1024;  // + room to align the base
constexpr size_t R_SMEM_BYTES = R_OFF_MISC + M_BYTES + 1024;

static_assert(OFF_STAGE % 1024 == 0 && STAGE_STRIDE % 1024 == 0, "SW128 atoms");
static_assert(R_OFF_S % 1024 == 0 && R_BUF_BYTES % 1024 == 0, "SW128");
static_assert((RES_ROWS / NWG) * BOX_W <= R_N && R_N <= 256 && R_N % 8 == 0, "a wgmma N");
static_assert(ROWS % NWG == 0 && RES_ROWS % NWG == 0, "whole tiles a warpgroup");
static_assert(THREADS % C == 0, "the SE gate gives whole groups of threads to each output");
static_assert(SMEM_BYTES <= 232448 && R_SMEM_BYTES <= 232448, "shared memory of a block");

enum ConvMode { PRELU_T1 = 0, BIAS_T2_SUMS = 1, SKIP_OUT = 2 };

struct Params {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  const float* b1;
  const float* a;
  const float* b2;
  const float* fc1;
  const float* fc2;
  const float* bg;
  float* feat;            // scratch variant: [clusters, H, W, C] f32
  float* t2;              // [clusters, H, W, C] f32
  __nv_bfloat16* t1;      // [clusters, H, W, C]
  __nv_bfloat16* featb;   // [clusters, H, W, C]: bf16(feat)
  int n, h, w, num_blocks, cr;
  float res_scale;
};

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` to complete; trap rather than hang if a
// copy never lands (a bad tensor map), so the launch reports an error.
// CLUSTER: acquire at cluster scope, for data that other blocks of the
// cluster stored with st.async.
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    if (CLUSTER)
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same box into shared memory at `dst` (and its barrier at `bar`) of
// every block of the cluster in `mask`
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// generic-proxy writes before async-proxy (TMA) accesses, and back
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// the same for this block's shared memory only, before wgmma reads rows
// that threads stored; on an H100 the full fence above, in the same two
// places of the resident variant, made a group call clearly slower
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The arrive half of a cluster barrier that orders no data, only the
// reuse of buffers (every block is done reading them, by wgmma or ldmatrix,
// before another block's TMA multicast or st.async overwrites them): the
// data between blocks goes through mbarrier transactions. It spares the
// GPU-scope memory barrier (MEMBAR.ALL.GPU) that the release arrive compiles
// to.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t special_reg_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t special_reg_nrank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t special_reg_cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t special_reg_nclusters() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// the address in block `rank`'s shared memory of this block's `addr`
__device__ __forceinline__ uint32_t dsmem_addr(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_dsmem_v4(uint32_t addr, uint32_t rank, const uint4& v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(dsmem_addr(addr, rank)),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// 16 bytes into block `rank`'s shared memory at (its) `addr`, counted as
// complete_tx bytes on its mbarrier at `bar`: the data is visible to that
// block's threads once they see the barrier's phase complete
__device__ __forceinline__ void st_async_v4(uint32_t addr, uint32_t bar, uint32_t rank,
                                            const uint4& v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(dsmem_addr(addr, rank)), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w),
      "r"(dsmem_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ uint4 ld_smem_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_smem_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};" ::"r"(addr), "r"(0) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Shared-memory descriptor of a weight tile stored MN-major (output
// channels contiguous, 128 bytes a K row) in 128-byte swizzle atoms of 8 K
// rows: the stride between 8-row groups (SBO) is 1024 bytes; the 64 output
// channels are one atom wide, so the MN stride (LBO) is never used. The
// scratch variant's wgmma reads it as B, the resident variant's as A.
__device__ __forceinline__ uint64_t desc_w_sw128(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// Shared-memory descriptor of a B tile stored K-major (a pixel slot's 64
// channels in one 128-byte row) in 128-byte swizzle atoms laid out from a
// 1024-byte boundary, 8-row groups 1024 bytes apart. A start off that
// boundary (a tap's slot offset) needs no base offset: measured on an H100,
// the swizzle follows the absolute address bits, as TMA wrote them (a base
// offset of (addr >> 7) & 7 gave wrong results, 0 right ones).
__device__ __forceinline__ uint64_t desc_kmajor_sw128(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// four 8x8 bf16 matrices from the mma fragment layout into shared memory,
// each transposed (lanes 8i..8i+7 give the addresses of matrix i's rows,
// which are its fragment's columns)
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d[64 out-channels, 136 slots] += A[64, 16] * B[16, 136], both from shared
// memory: A (the weight) MN-major, B (input slots) K-major
__device__ __forceinline__ void wgmma_ss_n136(float (&d)[R_ACC], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67}, "
      "%68, %69, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 px, 64 ch] += A[64 px, 16 k] (registers, the mma.m16n8k16 A fragment
// of each warp's 16 rows) * B[16 k, 64 ch] (shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// keeps the compiler from moving accumulator reads above the wgmma wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Byte offset of pixel L, channel c in a run of 128-byte pixel rows that
// starts on a 1024-byte boundary, as TMA's 128-byte swizzle stores it: the
// 16-byte chunk c / 8 of pixel L sits at chunk (c / 8) ^ (L & 7).
__device__ __forceinline__ uint32_t swz(int L, int c) {
  return uint32_t(L) * 128 + (uint32_t((c >> 3) ^ (L & 7)) << 4) + uint32_t(c & 7) * 2;
}

// ---- pieces both variants share ----------------------------------------

// One M-tile: 64 output pixels of one image row. rows[dy] / l0[dy]: where
// the input row dy - 1 relative to the output row lies (a 1024-aligned run
// of BOX_W-pixel rows, and the pixel index of its column -1 in that run).
// acc[4*jn + 2*half + e] ends up holding pixel 16*wq + g + 8*half, channel
// 8*jn + 2*t + e (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void conv_tile(float (&acc)[32], const uint32_t (&rows)[3],
                                          const int (&l0)[3], uint32_t wsm, int wq, int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t a[2][4][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    // this lane's ldmatrix row: pixel 16*wq + (lane & 15) of the tile,
    // channels (lane >> 4) * 8 of each 16-channel step
    const int px = l0[dy] + dx + wq * 16 + (lane & 15);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      ldmatrix_x4(a[tap & 1][kc], rows[dy] + swz(px, kc * 16 + (lane >> 4) * 8));
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs(acc, a[tap & 1][kc], desc_w_sw128(wsm + uint32_t(tap * C + kc * 16) * 128));
    wgmma_commit();
    wgmma_wait<1>();  // the previous tap's group is done with its A registers
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

struct Misc {
  float *wsum, *allsum, *mean, *z, *gate, *bias, *alpha;
  uint32_t bar;  // three mbarriers, 8 bytes apart

  __device__ void init(unsigned char* p) {
    wsum = reinterpret_cast<float*>(p + M_WSUM);
    allsum = reinterpret_cast<float*>(p + M_ALLSUM);
    mean = reinterpret_cast<float*>(p + M_MEAN);
    z = reinterpret_cast<float*>(p + M_Z);
    gate = reinterpret_cast<float*>(p + M_GATE);
    bias = reinterpret_cast<float*>(p + M_BIAS);
    alpha = reinterpret_cast<float*>(p + M_ALPHA);
    bar = smem_u32(p + M_BAR);
  }
};

// The block's per-channel sums of t2 in a fixed order (each warp's lanes
// that share t, which differ in bits 2..4, then the warps in order): thread
// tid < C / 4 gets channels 4 tid .. 4 tid + 3, as the bits of a uint4 for
// a 16-byte store into every block of the cluster.
constexpr int SUM_THREADS = C / 4;
__device__ __forceinline__ uint4 block_channel_sums(const Misc& m, float (&csum)[8][2], int tid) {
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = csum[jn][e];
#pragma unroll
      for (int msk = 4; msk < 32; msk <<= 1) s += __shfl_xor_sync(0xffffffffu, s, msk);
      if (g == 0) m.wsum[(tid >> 5) * C + jn * 8 + 2 * t + e] = s;
    }
  __syncthreads();
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < SUM_THREADS)
    for (int wi = 0; wi < WARPS; ++wi) {
      const float4 v = *reinterpret_cast<const float4*>(m.wsum + wi * C + 4 * tid);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  return make_uint4(__float_as_uint(s.x), __float_as_uint(s.y), __float_as_uint(s.z),
                    __float_as_uint(s.w));
}

// The SE weights of RCAB k that thread `tid` multiplies in se_gate, loaded
// ahead so their latency hides behind the cluster barrier before the gate.
// GATE_LANES adjacent threads share output o = tid / GATE_LANES; lane part
// takes fc1[part * C / GATE_LANES + i, o] and fc2[part + GATE_LANES * i, o].
constexpr int GATE_LANES = THREADS / C;
struct GateWeights {
  float f1[C / GATE_LANES], f2[C / GATE_LANES];
};

__device__ __forceinline__ GateWeights load_gate_weights(const Params& p, int k, int tid) {
  const int o = tid / GATE_LANES, part = tid % GATE_LANES;
  const float* f1 = p.fc1 + size_t(k) * C * p.cr;  // [C, Cr]
  const float* f2 = p.fc2 + size_t(k) * p.cr * C;  // [Cr, C]
  GateWeights gw;
#pragma unroll
  for (int i = 0; i < C / GATE_LANES; ++i) {
    gw.f1[i] = o < p.cr ? f1[(part * (C / GATE_LANES) + i) * p.cr + o] : 0.f;
    gw.f2[i] = part + GATE_LANES * i < p.cr ? f2[(part + GATE_LANES * i) * C + o] : 0.f;
  }
  return gw;
}

// SE gate of RCAB k, the same in every block: the cluster's channel sums
// (`allsum`, one row a block) in rank order, then fc1, ReLU, fc2, sigmoid,
// each output summed by GATE_LANES adjacent lanes. Leaves m.gate ready for
// every thread.
__device__ __forceinline__ void se_gate(const Misc& m, const float* allsum, const Params& p,
                                        const GateWeights& gw, int csize, int tid) {
  if (tid < C) {
    float s = 0.f;
    for (int r = 0; r < csize; ++r) s += allsum[r * C + tid];
    m.mean[tid] = s / float(p.h * p.w);
  }
  __syncthreads();
  const int o = tid / GATE_LANES, part = tid % GATE_LANES;
  {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < C / GATE_LANES; ++i)
      s += m.mean[part * (C / GATE_LANES) + i] * gw.f1[i];
#pragma unroll
    for (int msk = 1; msk < GATE_LANES; msk <<= 1) s += __shfl_xor_sync(0xffffffffu, s, msk);
    if (o < p.cr && part == 0) m.z[o] = fmaxf(s, 0.f);
  }
  __syncthreads();
  {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < C / GATE_LANES; ++i)
      if (part + GATE_LANES * i < p.cr) s += m.z[part + GATE_LANES * i] * gw.f2[i];
#pragma unroll
    for (int msk = 1; msk < GATE_LANES; msk <<= 1) s += __shfl_xor_sync(0xffffffffu, s, msk);
    if (part == 0) m.gate[o] = 1.f / (1.f + expf(-s));
  }
  __syncthreads();
}

// ---- scratch variant ------------------------------------------------------

struct Block {
  uint32_t wsm, stage0, bar_w, bar_s0;
  Misc m;
  float* stg;
  int tid, wq, lane, warp, wg;
  int rank, csize, r0, r1, col_tiles, n_st;
  uint32_t it;  // stages consumed so far (ring slot it & 1, parity (it >> 1) & 1)
  uint32_t q;   // convs started so far (weight barrier parity q & 1)

  __device__ uint32_t stage(uint32_t i) const { return stage0 + (i & 1) * STAGE_STRIDE; }
  __device__ uint32_t bar_s(uint32_t i) const { return bar_s0 + (i & 1) * 8; }

  __device__ void load_weight(const CUtensorMap* map, int row0) const {
    mbar_expect_tx(bar_w, W_BYTES);
#pragma unroll
    for (int part = 0; part < KROWS / W_BOX_ROWS; ++part)
      tma_load_2d(wsm + part * W_BOX_ROWS * C * 2, map, bar_w, 0, row0 + part * W_BOX_ROWS);
  }

  __device__ void load_stage(uint32_t i, int s, const CUtensorMap* map, int img) const {
    const int y0 = r0 + (s / col_tiles) * ROWS, x0 = (s % col_tiles) * TILE;
    mbar_expect_tx(bar_s(i), STAGE_BYTES);
    tma_load_4d(stage(i), map, bar_s(i), 0, x0 - 1, y0 - 1, img);
  }
};

// One 3x3 conv over the block's band, input `in_map` image `in_img`; then
// the next conv's weight (`next_w`, or none) starts loading.
template <int MODE>
__device__ __forceinline__ void conv_phase(Block& b, const Params& p, const CUtensorMap* in_map,
                                           int in_img, const float* bias, const float* alpha,
                                           int img, int slot, const CUtensorMap* next_w,
                                           int next_row) {
  mbar_wait(b.bar_w, b.q & 1);
  if (b.tid == 0 && b.n_st > 0) {
    fence_proxy_async();
    b.load_stage(b.it, 0, in_map, in_img);
  }
  if (b.tid < C) {  // read after the stage loop's first barrier
    b.m.bias[b.tid] = bias[b.tid];
    b.m.alpha[b.tid] = MODE == PRELU_T1 ? alpha[b.tid] : 0.f;
  }
  const int g = b.lane >> 2, t = b.lane & 3;
  float csum[8][2];
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) csum[jn][0] = csum[jn][1] = 0.f;
  // this warp's 16 pixels of a tile, staged so that global stores are whole
  // 16-byte vectors of consecutive channels and pixels: f32 rows of STG_LD
  // floats, or bf16 rows of STG_LD halves (both conflict-free for the
  // fragment writes and the 16-byte reads)
  float* stg = b.stg + b.warp * 16 * STG_LD;
  __nv_bfloat16* stg_h = reinterpret_cast<__nv_bfloat16*>(stg);
  const size_t img_px = size_t(p.h) * p.w;

  for (int s = 0; s < b.n_st; ++s) {
    __syncthreads();  // stage s-1 is done, so its ring slot may be refilled
    if (b.tid == 0 && s + 1 < b.n_st) b.load_stage(b.it + 1, s + 1, in_map, in_img);
    mbar_wait(b.bar_s(b.it), (b.it >> 1) & 1);
    const int y0 = b.r0 + (s / b.col_tiles) * ROWS, x0 = (s % b.col_tiles) * TILE;
#pragma unroll 1
    for (int jj = 0; jj < ROWS / NWG; ++jj) {
      const int j = b.wg + jj * NWG;
      const int y = y0 + j;
      if (y >= b.r1) break;  // uniform over the warpgroup
      float acc[32];
      const uint32_t st = b.stage(b.it);
      const uint32_t rows[3] = {st, st, st};
      const int l0[3] = {j * BOX_W, (j + 1) * BOX_W, (j + 2) * BOX_W};
      conv_tile(acc, rows, l0, b.wsm, b.wq, b.lane);
      const int xw = x0 + b.wq * 16;  // this warp's first pixel
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = g + half * 8;
        const bool valid = xw + px < p.w;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int c = jn * 8 + 2 * t;
          float v0 = acc[4 * jn + 2 * half] + b.m.bias[c];
          float v1 = acc[4 * jn + 2 * half + 1] + b.m.bias[c + 1];
          if (MODE == PRELU_T1) {
            v0 = v0 >= 0.f ? v0 : b.m.alpha[c] * v0;
            v1 = v1 >= 0.f ? v1 : b.m.alpha[c + 1] * v1;
            *reinterpret_cast<__nv_bfloat162*>(stg_h + px * STG_LD + c) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            *reinterpret_cast<float2*>(stg + px * STG_LD + c) = make_float2(v0, v1);
            if (MODE == BIAS_T2_SUMS && valid) {
              csum[jn][0] += v0;
              csum[jn][1] += v1;
            }
          }
        }
      }
      __syncwarp();
      const size_t row0 = size_t(y) * p.w + xw;  // pixel offset in the image
      if (MODE == PRELU_T1) {
        // 16 px x 8 chunks of 8 channels
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = b.lane + 32 * u, px = i >> 3, q = i & 7;
          if (xw + px < p.w)
            *reinterpret_cast<uint4*>(p.t1 + ((size_t(slot) * img_px + row0 + px) * C + q * 8)) =
                *reinterpret_cast<const uint4*>(stg_h + px * STG_LD + q * 8);
        }
      } else if (MODE == BIAS_T2_SUMS) {
        // 16 px x 16 chunks of 4 channels
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = b.lane + 32 * u, px = i >> 4, q = i & 15;
          if (xw + px < p.w)
            *reinterpret_cast<float4*>(p.t2 + ((size_t(slot) * img_px + row0 + px) * C + q * 4)) =
                *reinterpret_cast<const float4*>(stg + px * STG_LD + q * 4);
        }
      } else {
        // out = bf16(acc + bg + x), 16 px x 8 chunks of 8 channels
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = b.lane + 32 * u, px = i >> 3, q = i & 7;
          if (xw + px >= p.w) continue;
          const size_t o = (size_t(img) * img_px + row0 + px) * C + q * 8;
          const uint4 xv = *reinterpret_cast<const uint4*>(p.x + o);
          const float4 lo = *reinterpret_cast<const float4*>(stg + px * STG_LD + q * 8);
          const float4 hi = *reinterpret_cast<const float4*>(stg + px * STG_LD + q * 8 + 4);
          const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xv);
          const float2 x0f = __bfloat1622float2(xh[0]), x1f = __bfloat1622float2(xh[1]);
          const float2 x2f = __bfloat1622float2(xh[2]), x3f = __bfloat1622float2(xh[3]);
          __nv_bfloat162 r[4] = {__floats2bfloat162_rn(lo.x + x0f.x, lo.y + x0f.y),
                                 __floats2bfloat162_rn(lo.z + x1f.x, lo.w + x1f.y),
                                 __floats2bfloat162_rn(hi.x + x2f.x, hi.y + x2f.y),
                                 __floats2bfloat162_rn(hi.z + x3f.x, hi.w + x3f.y)};
          *reinterpret_cast<uint4*>(p.out + o) = *reinterpret_cast<const uint4*>(r);
        }
      }
      __syncwarp();  // the staging rows are free for the next tile
    }
    ++b.it;
  }
  __syncthreads();  // every MMA of this conv is done with the weight buffer
  if (b.tid == 0 && next_w != nullptr) b.load_weight(next_w, next_row);
  ++b.q;
  if (MODE == BIAS_T2_SUMS) {
    // into row `rank` of allsum in every block; the cluster barrier after
    // this conv publishes them
    const uint4 s = block_channel_sums(b.m, csum, b.tid);
    if (b.tid < SUM_THREADS) {
      const uint32_t addr = smem_u32(b.m.allsum + b.rank * C + 4 * b.tid);
      for (int r = 0; r < b.csize; ++r) st_dsmem_v4(addr, uint32_t(r), s);
    }
  }
  fence_proxy_async();  // t1 / out writes before neighbours' TMA reads
}

__global__ void __launch_bounds__(THREADS, 1)
rcab_group_scratch_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_featb,
                          const __grid_constant__ CUtensorMap tm_t1,
                          const __grid_constant__ CUtensorMap tm_w1,
                          const __grid_constant__ CUtensorMap tm_w2,
                          const __grid_constant__ CUtensorMap tm_wg, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sb = smem_raw + (base - raw);

  Block b;
  b.wsm = base + OFF_W;
  b.stage0 = base + OFF_STAGE;
  b.m.init(sb + OFF_MISC);
  b.bar_w = b.m.bar;
  b.bar_s0 = b.m.bar + 8;
  b.stg = reinterpret_cast<float*>(sb + OFF_STG);
  b.tid = threadIdx.x;
  b.warp = b.tid >> 5;
  b.wg = b.tid >> 7;
  b.wq = b.warp & 3;
  b.lane = b.tid & 31;
  b.it = 0;
  b.q = 0;

  b.rank = int(special_reg_rank());
  b.csize = int(special_reg_nrank());
  const int cid = int(special_reg_cluster_id()), ncl = int(special_reg_nclusters());
  b.r0 = b.rank * p.h / b.csize;
  b.r1 = (b.rank + 1) * p.h / b.csize;
  b.col_tiles = (p.w + TILE - 1) / TILE;
  b.n_st = ((b.r1 - b.r0 + ROWS - 1) / ROWS) * b.col_tiles;

  if (b.tid == 0) {
    mbar_init(b.bar_w, 1);
    for (int i = 0; i < STAGES; ++i) mbar_init(b.bar_s(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (cid < p.n) b.load_weight(&tm_w1, 0);
  }
  __syncthreads();

  const int B = p.num_blocks, slot = cid;
  const size_t img_elems = size_t(p.h) * p.w * C;
  const size_t band_off = size_t(b.r0) * p.w * C;
  const int band_vec4 = (b.r1 - b.r0) * p.w * (C / 4);
  float* feat = p.feat + size_t(slot) * img_elems + band_off;
  const float* t2 = p.t2 + size_t(slot) * img_elems + band_off;
  __nv_bfloat16* featb = p.featb + size_t(slot) * img_elems + band_off;

  for (int img = cid; img < p.n; img += ncl) {
    const __nv_bfloat16* xb = p.x + size_t(img) * img_elems + band_off;
    for (int k = 0; k < B; ++k) {
      conv_phase<PRELU_T1>(b, p, k == 0 ? &tm_x : &tm_featb, k == 0 ? img : slot,
                           p.b1 + k * C, p.a + k * C, img, slot, &tm_w2, k * KROWS);
      cluster_sync();  // every block's t1 band is written
      conv_phase<BIAS_T2_SUMS>(b, p, &tm_t1, slot, p.b2 + k * C, nullptr, img, slot,
                               k + 1 < B ? &tm_w1 : &tm_wg, k + 1 < B ? (k + 1) * KROWS : 0);
      const GateWeights gw = load_gate_weights(p, k, b.tid);
      cluster_sync();  // every block's channel sums are in its shared memory
      se_gate(b.m, b.m.allsum, p, gw, b.csize, b.tid);

      // residual update of the band: feat += (t2 * gate) * res_scale in f32
      // (feat starts as float(x)), and bf16(feat) for the next conv
      // (UPDATE_BATCH vectors of loads in flight a thread: one block an SM
      // has too few threads to cover the L2 latency otherwise)
      for (int i0 = b.tid; i0 < band_vec4; i0 += THREADS * UPDATE_BATCH) {
        float4 f[UPDATE_BATCH], tv[UPDATE_BATCH];
#pragma unroll
        for (int u = 0; u < UPDATE_BATCH; ++u) {
          const int i = i0 + u * THREADS;
          if (i >= band_vec4) break;
          if (k == 0) {
            const uint2 xv = reinterpret_cast<const uint2*>(xb)[i];
            const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.x));
            const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv.y));
            f[u] = make_float4(lo.x, lo.y, hi.x, hi.y);
          } else {
            f[u] = reinterpret_cast<const float4*>(feat)[i];
          }
          tv[u] = reinterpret_cast<const float4*>(t2)[i];
        }
#pragma unroll
        for (int u = 0; u < UPDATE_BATCH; ++u) {
          const int i = i0 + u * THREADS;
          if (i >= band_vec4) break;
          const int c = (i * 4) % C;
          f[u].x += (tv[u].x * b.m.gate[c]) * p.res_scale;
          f[u].y += (tv[u].y * b.m.gate[c + 1]) * p.res_scale;
          f[u].z += (tv[u].z * b.m.gate[c + 2]) * p.res_scale;
          f[u].w += (tv[u].w * b.m.gate[c + 3]) * p.res_scale;
          reinterpret_cast<float4*>(feat)[i] = f[u];
          const __nv_bfloat162 lo = __floats2bfloat162_rn(f[u].x, f[u].y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(f[u].z, f[u].w);
          uint2 packed;
          packed.x = *reinterpret_cast<const uint32_t*>(&lo);
          packed.y = *reinterpret_cast<const uint32_t*>(&hi);
          reinterpret_cast<uint2*>(featb)[i] = packed;
        }
      }
      fence_proxy_async();
      cluster_sync();  // every block's bf16(feat) band is written
    }
    const bool more = img + ncl < p.n;
    conv_phase<SKIP_OUT>(b, p, &tm_featb, slot, p.bg, nullptr, img, slot,
                         more ? &tm_w1 : nullptr, 0);
  }
  // no block leaves while another may still read its shared memory
  cluster_sync();
}

// ---- resident variant -------------------------------------------------------
//
// Pixels are the wgmma N operand: D[64 out-channels, R_N slots] =
// W[64 out, 16 in] (A, the weight, MN-major) x X[16 in, R_N slots] (B, the
// input rows, K-major, 128 bytes a slot), both read from shared memory. The
// band's rows and its two halo rows lie in one run of R_BUF_ROWS rows of
// BOX_W slots (input row 0: the row above the band, row nb + 1: the row
// below), so the slots of a warpgroup's two output rows, with the two halo
// columns between them, are one run of R_N slots for every tap: tap
// (dy, dx) starts at input row j0 + dy, slot dx. Column n of the tile is
// band row j0 + n / BOX_W, pixel n % BOX_W (pixels 64 and 65 of a row are
// not the image's).

struct Res {
  uint32_t w0, s;  // shared-memory addresses: weight buffers, input rows
  uint32_t bar_w0, bar_x, bar_h, bar_sum0;  // mbarriers
  uint32_t dummy;  // where stmatrix puts the slots no row of this block owns
  Misc m;
  float* wgsum;    // [NWG][C] the warpgroups' channel sums
  int tid, lane, wg, wq, g, t;
  int rank, csize, r0, nb;  // the band: image rows r0 .. r0 + nb - 1 (1 <= nb <= 4)
  int j0;          // the warpgroup's band rows: j0 and j0 + 1
  int nb_up;       // the band rows of the block above (its bottom halo is its input row nb_up + 1)
  uint32_t q;      // convs started: weight buffer q & 1
  uint32_t ns;     // SE rounds started: sums buffer ns & 1
  uint32_t hphase; // phase parity of the halo barrier
  uint32_t halo_bytes;  // what the neighbours push into the halo rows a conv
  uint64_t vmask;  // bit 2 jb + e: this thread's column 8 jb + 2 t + e is an image pixel of the band

  __device__ uint32_t bar_sum(int buf) const { return bar_sum0 + 8 * uint32_t(buf); }
  __device__ float* allsum(int buf) const { return m.allsum + buf * 16 * C; }
  // 16-byte chunk `chunk` (channels 8 chunk ..) of input slot `slot` (SW128)
  __device__ uint32_t slot_addr(int slot, int chunk) const {
    return s + uint32_t(slot) * 128 + (uint32_t(chunk ^ (slot & 7)) << 4);
  }
  __device__ bool col_valid(int jb, int e) const { return (vmask >> (2 * jb + e)) & 1; }
  __device__ int c_lo() const { return 16 * wq + g; }  // this thread's channels: c_lo, c_lo + 8

  // a conv's weight into buffer `buf` of every block of the cluster: this
  // block's share of its 8-row atoms, multicast
  __device__ void load_weight(const CUtensorMap* map, int row0, uint32_t buf) const {
    const uint32_t bar = bar_w0 + 8 * buf, dst = w0 + buf * W_BYTES;
    mbar_expect_tx(bar, W_BYTES);
    const uint16_t mask = uint16_t((1u << csize) - 1);
    for (int a = rank; a < KROWS / 8; a += csize)
      tma_load_2d_multicast(dst + a * 1024, map, bar, 0, row0 + a * 8, mask);
  }

  // image rows r0 - 1 .. r0 + R_BUF_ROWS - 2 of x into the input rows (zero
  // fill past the image's edges and in the halo columns)
  __device__ void load_x(const CUtensorMap* xm, int img) const {
    fence_proxy_async();
    mbar_expect_tx(bar_x, R_BUF_ROWS * ROW_BYTES);
    tma_load_4d(s, xm, bar_x, 0, -1, r0 - 1, img);
  }

  // Conv q into d: first the taps whose input rows are all band rows, then,
  // once the neighbours' rows are in the halo rows (`pushed`; an image's
  // first conv reads x's rows, loaded by TMA), the rest. No operand is in
  // registers, so all of a pass's wgmmas are in flight together. Ends with
  // the arrive at the cluster barrier that tells the other blocks this
  // block is done with conv q's weight buffer and halo rows.
  __device__ __forceinline__ void conv(float (&d)[R_ACC], const float* bias, const float* alpha,
                                       bool pushed, uint32_t x_parity) {
    if (tid < C) {  // read after the barrier that follows the MMAs
      m.bias[tid] = bias[tid];
      m.alpha[tid] = alpha != nullptr ? alpha[tid] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < R_ACC; ++i) d[i] = 0.f;
    mbar_wait(bar_w0 + 8 * (q & 1), (q >> 1) & 1);
    if (!pushed) mbar_wait(bar_x, x_parity);
    const uint32_t wsm = w0 + (q & 1) * W_BYTES;
    const bool active = j0 < nb;
    // the taps' dy in the order they run (2 bits each): those whose two
    // input rows are band rows, then those that read a halo row
    uint32_t order = 0;
    int n_own = 0, cnt = 0;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int ra = j0 + dy, rb = ra + 1;  // the input rows the run reads
        const bool halo = ra == 0 || ra == nb + 1 || rb == nb + 1;
        if (halo != bool(pass)) continue;
        order |= uint32_t(dy) << (2 * cnt++);
        if (!pass) ++n_own;
      }
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      if (i == n_own && pushed) {
        // Armed here though the pushes may have landed already (the
        // tx-count may go below zero); the next ones come after the cluster
        // barrier this conv arrives at.
        if (tid == 0) mbar_expect_tx(bar_h, halo_bytes);
        mbar_wait<true>(bar_h, hphase);
        fence_proxy_async_smem();  // before wgmma (the async proxy) reads them
      }
      if (!active) continue;
      const int dy = int(order >> (2 * i)) & 3;
      const uint32_t wrow = wsm + uint32_t(dy * 3 * C) * 128;
      const uint32_t srow = s + uint32_t((j0 + dy) * BOX_W) * 128;
      wgmma_fence();
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma_ss_n136(d, desc_w_sw128(wrow + uint32_t(dx * C + kc * 16) * 128),
                        desc_kmajor_sw128(srow + uint32_t(dx * 128 + kc * 32)));
      wgmma_commit();
    }
    if (pushed) hphase ^= 1u;
    wgmma_wait<0>();
    fence_acc(d);
    __syncthreads();  // this block's weight buffer and input rows are free
    cluster_arrive_relaxed();
  }

  // The warpgroup's tile (f32, accumulator layout) as bf16 input rows of the
  // next conv, by stmatrix.trans: 8 channels of a slot are one 16-byte row
  // of a transposed 8x8 matrix. Pixels past W are written as zeros (the
  // next conv's padding); slots no band row owns go to `dummy`.
  __device__ void store_rows(const float (&v)[R_ACC]) const {
#pragma unroll
    for (int k = 0; k < (R_N / 8 + 1) / 2; ++k) {  // column blocks 2k and 2k + 1
      const int mi = lane >> 3, jb = 2 * k + (mi >> 1), n = 8 * jb + (lane & 7);
      const int ro = n / BOX_W, x = n - ro * BOX_W;
      const bool own = jb < R_N / 8 && ro < 2 && x < TILE && j0 + ro < nb;
      const uint32_t addr = own ? slot_addr((j0 + 1) * BOX_W + 1 + n, 2 * wq + (mi & 1)) : dummy;
      uint32_t r[4];  // matrices (jb 2k, channels c_lo), (2k, c_lo + 8), (2k + 1, ..), (2k + 1, ..)
#pragma unroll
      for (int mm = 0; mm < 4; ++mm) {
        const int b = 2 * k + (mm >> 1), h = mm & 1;
        if (b < R_N / 8)
          r[mm] = pack_bf16(col_valid(b, 0) ? v[4 * b + 2 * h] : 0.f,
                            col_valid(b, 1) ? v[4 * b + 2 * h + 1] : 0.f);
        else
          r[mm] = 0;
      }
      stmatrix_x4_trans(addr, r);
    }
  }

  // After a conv's epilogue: the cluster barrier that conv arrived at (every
  // block is done with its weight buffer and halo rows), then conv q + 2's
  // weight into that buffer and, when `push`, band rows 0 and nb - 1 (input
  // rows 1 and nb, just stored) into the neighbours' halo rows: the block
  // above takes row 0 as its bottom halo, the block below row nb - 1 as its
  // top halo (16-byte st.async counted on the receiver's halo barrier).
  __device__ void finish(bool push, const CUtensorMap* next_w, int next_row) {
    fence_proxy_async_smem();  // the rows stmatrix stored, before wgmma reads them
    __syncthreads();
    cluster_wait();
    if (tid == 0 && next_w != nullptr) load_weight(next_w, next_row, q & 1);
    if (push) {
      for (int i = tid; i < 2 * TILE * (C / 8); i += THREADS) {
        const bool up = i < TILE * (C / 8);
        const int k = up ? i : i - TILE * (C / 8), px = k >> 3, ch = k & 7;
        const int dst = up ? rank - 1 : rank + 1;
        if (dst < 0 || dst >= csize) continue;
        const uint4 v = ld_smem_v4(slot_addr((up ? 1 : nb) * BOX_W + 1 + px, ch));
        st_async_v4(slot_addr((up ? nb_up + 1 : 0) * BOX_W + 1 + px, ch), bar_h, uint32_t(dst), v);
      }
    }
    ++q;
  }
};

// The weight of conv c of an image (0 .. 2B): w1[c / 2], w2[c / 2], the tail's wg
struct WeightOf {
  const CUtensorMap* map;
  int row;
};
__device__ __forceinline__ WeightOf weight_of(int c, int B, const CUtensorMap* w1,
                                              const CUtensorMap* w2, const CUtensorMap* wg) {
  if (c == 2 * B) return {wg, 0};
  return {(c & 1) ? w2 : w1, (c >> 1) * KROWS};
}

__global__ void __launch_bounds__(THREADS, 1)
rcab_group_resident_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w1,
                           const __grid_constant__ CUtensorMap tm_w2,
                           const __grid_constant__ CUtensorMap tm_wg, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sb = smem_raw + (base - raw);

  Res r;
  r.w0 = base + R_OFF_W;
  r.s = base + R_OFF_S;
  r.m.init(sb + R_OFF_MISC);
  r.wgsum = reinterpret_cast<float*>(sb + R_OFF_MISC + M_WGSUM);
  r.dummy = smem_u32(sb + R_OFF_MISC + M_DUMMY);
  r.bar_w0 = r.m.bar;
  r.bar_x = r.m.bar + 16;
  r.bar_h = r.m.bar + 24;
  r.bar_sum0 = r.m.bar + 32;
  r.tid = threadIdx.x;
  r.lane = r.tid & 31;
  r.wg = r.tid >> 7;
  r.wq = (r.tid >> 5) & 3;
  r.g = r.lane >> 2;
  r.t = r.lane & 3;
  r.rank = int(special_reg_rank());
  r.csize = int(special_reg_nrank());
  r.r0 = r.rank * p.h / r.csize;
  r.nb = (r.rank + 1) * p.h / r.csize - r.r0;
  r.nb_up = r.r0 - (r.rank - 1) * p.h / r.csize;
  r.j0 = 2 * r.wg;
  r.q = 0;
  r.ns = 0;
  r.hphase = 0;
  r.halo_bytes = PUSH_BYTES * uint32_t((r.rank > 0) + (r.rank + 1 < r.csize));
  r.vmask = 0;
#pragma unroll
  for (int jb = 0; jb < R_N / 8; ++jb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * jb + 2 * r.t + e, ro = n / BOX_W, x = n - ro * BOX_W;
      if (ro < 2 && x < p.w && r.j0 + ro < r.nb) r.vmask |= uint64_t(1) << (2 * jb + e);
    }
  const int cid = int(special_reg_cluster_id()), ncl = int(special_reg_nclusters());
  const int B = p.num_blocks, per_img = 2 * B + 1;

  // zero the input rows and the slack after them: the halo columns, the
  // image's border rows and the pixels past W are never written again
  for (uint32_t i = r.tid; i < R_BUF_BYTES / 16; i += THREADS) st_smem_zero16(r.s + 16 * i);
  if (r.tid == 0) {
    for (int i = 0; i < N_BARS; ++i) mbar_init(r.m.bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  fence_proxy_async();
  cluster_sync();  // every block's barriers exist before a multicast lands
  if (r.tid == 0 && cid < p.n) {
    for (int c = 0; c < 2 && c < per_img; ++c) {
      const WeightOf wo = weight_of(c, B, &tm_w1, &tm_w2, &tm_wg);
      r.load_weight(wo.map, wo.row, uint32_t(c));
    }
    r.load_x(&tm_x, cid);
  }

  const int c0 = r.c_lo(), c1 = c0 + 8;
  uint32_t n_img = 0;  // images this block has taken (x barrier parity)
  for (int img = cid; img < p.n; img += ncl, ++n_img) {
    const bool more = img + ncl < p.n;
    // conv c + 2's weight, if there is such a conv (in this image or the next)
    auto next_weight = [&](int c, int& row) -> const CUtensorMap* {
      int c2 = c + 2;
      if (c2 >= per_img) {
        if (!more) return nullptr;
        c2 -= per_img;
      }
      const WeightOf wo = weight_of(c2, B, &tm_w1, &tm_w2, &tm_wg);
      row = wo.row;
      return wo.map;
    };

    // feat = float(x) for this warpgroup's columns, in accumulator layout
    float feat[R_ACC];
#pragma unroll
    for (int jb = 0; jb < R_N / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float lo = 0.f, hi = 0.f;
        if (r.col_valid(jb, e)) {
          const int n = 8 * jb + 2 * r.t + e, ro = n / BOX_W, x = n - ro * BOX_W;
          const size_t o = ((size_t(img) * p.h + r.r0 + r.j0 + ro) * p.w + x) * C;
          lo = __bfloat162float(p.x[o + c0]);
          hi = __bfloat162float(p.x[o + c1]);
        }
        feat[4 * jb + e] = lo;
        feat[4 * jb + 2 + e] = hi;
      }
    float acc[R_ACC];

    for (int k = 0; k < B; ++k) {
      int row = 0;
      const CUtensorMap* nw;
      // conv1 + PReLU: t1 goes straight into the next conv's input rows
      r.conv(acc, p.b1 + k * C, p.a + k * C, k > 0, n_img & 1);
      {
        const float b[2] = {r.m.bias[c0], r.m.bias[c1]}, a[2] = {r.m.alpha[c0], r.m.alpha[c1]};
#pragma unroll
        for (int i = 0; i < R_ACC; ++i) {
          const int h = (i >> 1) & 1;
          const float v = acc[i] + b[h];
          acc[i] = v >= 0.f ? v : a[h] * v;
        }
        r.store_rows(acc);
      }
      nw = next_weight(2 * k, row);
      r.finish(true, nw, row);

      // conv2: t2 stays in the accumulators across the SE exchange
      r.conv(acc, p.b2 + k * C, nullptr, true, 0);
      {
        const float b[2] = {r.m.bias[c0], r.m.bias[c1]};
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int jb = 0; jb < R_N / 8; ++jb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = acc[4 * jb + 2 * h + e] + b[h];
              acc[4 * jb + 2 * h + e] = v;
              if (r.col_valid(jb, e)) s[h] += v;
            }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // the four lanes of a g (they differ in t)
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
        }
        if (r.t == 0) {
          r.wgsum[r.wg * C + c0] = s[0];
          r.wgsum[r.wg * C + c1] = s[1];
        }
        __syncthreads();
        // the block's sums (warpgroup 0 then 1) into row `rank` of sums
        // buffer ns & 1 in every block
        if (r.tid < SUM_THREADS) {
          const float4 s0 = *reinterpret_cast<const float4*>(r.wgsum + 4 * r.tid);
          const float4 s1 = *reinterpret_cast<const float4*>(r.wgsum + C + 4 * r.tid);
          const uint4 v = make_uint4(__float_as_uint(s0.x + s1.x), __float_as_uint(s0.y + s1.y),
                                     __float_as_uint(s0.z + s1.z), __float_as_uint(s0.w + s1.w));
          const int buf = int(r.ns & 1);
          const uint32_t addr = smem_u32(r.allsum(buf) + r.rank * C + 4 * r.tid);
          for (int dst = 0; dst < r.csize; ++dst)
            st_async_v4(addr, r.bar_sum(buf), uint32_t(dst), v);
        }
      }
      {
        const GateWeights gw = load_gate_weights(p, k, r.tid);
        // every block's sums; the next round that stores into this buffer
        // needs every block's sums of the round between, which each block
        // sends only after its gate of this round
        const int buf = int(r.ns & 1);
        if (r.tid == 0) mbar_expect_tx(r.bar_sum(buf), uint32_t(r.csize) * C * 4);
        mbar_wait<true>(r.bar_sum(buf), (r.ns >> 1) & 1);
        ++r.ns;
        se_gate(r.m, r.allsum(buf), p, gw, r.csize, r.tid);
      }
      // feat += (t2 * gate) * res_scale; bf16(feat) is the next conv's input
      {
        const float gt[2] = {r.m.gate[c0], r.m.gate[c1]};
#pragma unroll
        for (int i = 0; i < R_ACC; ++i) feat[i] += (acc[i] * gt[(i >> 1) & 1]) * p.res_scale;
        r.store_rows(feat);
      }
      nw = next_weight(2 * k + 1, row);
      r.finish(true, nw, row);
    }

    // tail conv: out = bf16(conv + bg + x); then the next image's x loads
    // into the rows this conv read
    r.conv(acc, p.bg, nullptr, true, 0);
    fence_proxy_async();  // the rows TMA overwrites now were written by every thread
    __syncthreads();
    if (r.tid == 0 && more) r.load_x(&tm_x, img + ncl);
    {
      const float b[2] = {r.m.bias[c0], r.m.bias[c1]};
      // the columns' offsets again (not kept in registers from feat's loads)
      int t = r.t;
      asm volatile("" : "+r"(t));
#pragma unroll
      for (int jb = 0; jb < R_N / 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!r.col_valid(jb, e)) continue;
          const int n = 8 * jb + 2 * t + e, ro = n / BOX_W, x = n - ro * BOX_W;
          const size_t o = ((size_t(img) * p.h + r.r0 + r.j0 + ro) * p.w + x) * C;
          p.out[o + c0] = __float2bfloat16_rn(acc[4 * jb + e] + b[0] + __bfloat162float(p.x[o + c0]));
          p.out[o + c1] =
              __float2bfloat16_rn(acc[4 * jb + 2 + e] + b[1] + __bfloat162float(p.x[o + c1]));
        }
    }
    {
      int row = 0;
      const CUtensorMap* nw = next_weight(2 * B, row);
      r.finish(false, nw, row);  // also: the bias is read before the next conv replaces it
    }
  }
}

// ---- host side -----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the CUDA driver API's tensor-map encoder, through the runtime (no -lcuda),
// fetched once (a function-local static is initialised by one thread)
cudaError_t get_encoder(EncodeTiledFn* fn) {
  struct Found {
    cudaError_t err;
    EncodeTiledFn fn;
  };
  static const Found found = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &status);
    if (err == cudaSuccess && (status != cudaDriverEntryPointSuccess || ptr == nullptr))
      err = cudaErrorNotSupported;
    return Found{err, reinterpret_cast<EncodeTiledFn>(ptr)};
  }();
  *fn = found.fn;
  return found.err;
}

// [imgs, h, w, C] bf16, read in boxes of `rows` x BOX_W pixels, zero fill
cudaError_t act_map(EncodeTiledFn enc, CUtensorMap* m, const void* ptr, int imgs, int h, int w,
                    int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(C), cuuint64_t(w), cuuint64_t(h), cuuint64_t(imgs)};
  const cuuint64_t strides[3] = {cuuint64_t(C) * 2, cuuint64_t(w) * C * 2,
                                 cuuint64_t(h) * w * C * 2};
  const cuuint32_t box[4] = {cuuint32_t(C), cuuint32_t(BOX_W), cuuint32_t(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// [rows, C] bf16 weights, read in boxes of `box_rows` rows
cudaError_t weight_map(EncodeTiledFn enc, CUtensorMap* m, const void* ptr, int rows,
                       int box_rows) {
  const cuuint64_t dims[2] = {cuuint64_t(C), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(C) * 2};
  const cuuint32_t box[2] = {cuuint32_t(C), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaLaunchConfig_t launch_config(int clusters, int csize, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * csize, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel>
cudaError_t set_attributes(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// clusters of `csize` blocks of `kernel` that fit on the card at once (0 if none)
template <typename Kernel>
int max_clusters(Kernel kernel, size_t smem, int csize) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(1, csize, smem, nullptr, &attr);
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // an unsupported size is not an error of the launch
    return 0;
  }
  return count;
}

// The resident variant takes an image whose rows split into bands of 1 to
// 4 rows over a cluster of 8 or 16 blocks, and one tile a row; its cluster
// size for that image (0: the scratch variant).
int resident_cluster(int h, int w) {
  if (w > TILE) return 0;
  if (h >= 8 && h <= 4 * 8) return 8;
  if (h > 4 * 8 && h <= 4 * 16) return 16;
  return 0;
}

}  // namespace

// returns the error, and clears it from the thread's last error, so a
// failed call is not reported again by the thread's next call
#define RETURN_IF_ERR(expr)      \
  do {                           \
    cudaError_t e_ = (expr);     \
    if (e_ != cudaSuccess) {     \
      cudaGetLastError();        \
      return int(e_);            \
    }                            \
  } while (0)

// The launch for n images of h x w: the cluster size, the number of
// clusters, and the images of scratch the launch needs (0 for the resident
// variant; else one a cluster, the leading extent of the scratch buffers).
// The scratch variant's clusters have 8 blocks, or 16 where that keeps more
// SMs busy, as for a lone image.
extern "C" int rcab_group_plan(int n, int h, int w, int* clusters, int* cluster_size,
                               int* scratch_images) {
  if (n <= 0 || h <= 0 || w <= 0) return int(cudaErrorInvalidValue);
  const int rc = resident_cluster(h, w);
  if (rc > 0) {
    RETURN_IF_ERR(set_attributes(rcab_group_resident_kernel, R_SMEM_BYTES));
    const int m = max_clusters(rcab_group_resident_kernel, R_SMEM_BYTES, rc);
    if (m <= 0) return int(cudaErrorInvalidConfiguration);
    *cluster_size = rc;
    *clusters = n < m ? n : m;
    *scratch_images = 0;
    return int(cudaSuccess);
  }
  RETURN_IF_ERR(set_attributes(rcab_group_scratch_kernel, SMEM_BYTES));
  const int m8 = max_clusters(rcab_group_scratch_kernel, SMEM_BYTES, 8);
  const int m16 = max_clusters(rcab_group_scratch_kernel, SMEM_BYTES, 16);
  if (m8 <= 0 && m16 <= 0) return int(cudaErrorInvalidConfiguration);
  const int busy8 = (n < m8 ? n : m8) * 8, busy16 = (n < m16 ? n : m16) * 16;
  *cluster_size = busy16 > busy8 ? 16 : 8;
  const int m = busy16 > busy8 ? m16 : m8;
  *clusters = n < m ? n : m;
  *scratch_images = *clusters;
  return int(cudaSuccess);
}

// x, out: [N, H, W, 64] bf16. w1, w2: [B, 9*64, 64] bf16; b1, a, b2: [B, 64]
// f32; fc1: [B, 64, Cr] f32; fc2: [B, Cr, 64] f32; wg: [9*64, 64] bf16;
// bg: [64] f32. clusters, cluster_size from rcab_group_plan; scratch (null
// when it asked for none): feat, t2 [scratch_images, H, W, 64] f32; featb,
// t1 [scratch_images, H, W, 64] bf16.
extern "C" int rcab_group_forward(
    const void* x, void* out, const void* w1, const void* b1, const void* a,
    const void* w2, const void* b2, const void* fc1, const void* fc2,
    const void* wg, const void* bg, void* feat, void* featb, void* t1, void* t2,
    int n, int h, int w, int num_blocks, int cr, float res_scale, int clusters,
    int cluster_size, void* stream_ptr) {
  const int rc = resident_cluster(h, w);
  if (n <= 0 || h <= 0 || w <= 0 || num_blocks <= 0 || cr <= 0 || cr > C || clusters <= 0 ||
      clusters > n || (cluster_size != 8 && cluster_size != 16) ||
      (rc > 0 && cluster_size != rc) ||
      (rc == 0 && (feat == nullptr || featb == nullptr || t1 == nullptr || t2 == nullptr)))
    return int(cudaErrorInvalidValue);
  EncodeTiledFn enc;
  RETURN_IF_ERR(get_encoder(&enc));

  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.b1 = static_cast<const float*>(b1);
  p.a = static_cast<const float*>(a);
  p.b2 = static_cast<const float*>(b2);
  p.fc1 = static_cast<const float*>(fc1);
  p.fc2 = static_cast<const float*>(fc2);
  p.bg = static_cast<const float*>(bg);
  p.feat = static_cast<float*>(feat);
  p.t2 = static_cast<float*>(t2);
  p.t1 = static_cast<__nv_bfloat16*>(t1);
  p.featb = static_cast<__nv_bfloat16*>(featb);
  p.n = n;
  p.h = h;
  p.w = w;
  p.num_blocks = num_blocks;
  p.cr = cr;
  p.res_scale = res_scale;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaLaunchAttribute attr;

  CUtensorMap tm_w1, tm_w2, tm_wg;
  if (rc > 0) {
    CUtensorMap tm_x6;
    RETURN_IF_ERR(act_map(enc, &tm_x6, x, n, h, w, R_BUF_ROWS));
    RETURN_IF_ERR(weight_map(enc, &tm_w1, w1, num_blocks * KROWS, 8));
    RETURN_IF_ERR(weight_map(enc, &tm_w2, w2, num_blocks * KROWS, 8));
    RETURN_IF_ERR(weight_map(enc, &tm_wg, wg, KROWS, 8));
    RETURN_IF_ERR(set_attributes(rcab_group_resident_kernel, R_SMEM_BYTES));
    cudaLaunchConfig_t cfg = launch_config(clusters, cluster_size, R_SMEM_BYTES, stream, &attr);
    RETURN_IF_ERR(cudaLaunchKernelEx(&cfg, rcab_group_resident_kernel, tm_x6, tm_w1, tm_w2,
                                     tm_wg, p));
  } else {
    CUtensorMap tm_x, tm_featb, tm_t1;
    RETURN_IF_ERR(act_map(enc, &tm_x, x, n, h, w, BOX_H));
    RETURN_IF_ERR(act_map(enc, &tm_featb, featb, clusters, h, w, BOX_H));
    RETURN_IF_ERR(act_map(enc, &tm_t1, t1, clusters, h, w, BOX_H));
    RETURN_IF_ERR(weight_map(enc, &tm_w1, w1, num_blocks * KROWS, W_BOX_ROWS));
    RETURN_IF_ERR(weight_map(enc, &tm_w2, w2, num_blocks * KROWS, W_BOX_ROWS));
    RETURN_IF_ERR(weight_map(enc, &tm_wg, wg, KROWS, W_BOX_ROWS));
    RETURN_IF_ERR(set_attributes(rcab_group_scratch_kernel, SMEM_BYTES));
    cudaLaunchConfig_t cfg = launch_config(clusters, cluster_size, SMEM_BYTES, stream, &attr);
    RETURN_IF_ERR(cudaLaunchKernelEx(&cfg, rcab_group_scratch_kernel, tm_x, tm_featb, tm_t1,
                                     tm_w1, tm_w2, tm_wg, p));
  }
  return int(cudaGetLastError());
}

// Bytes of dynamic shared memory a block of each variant asks for.
extern "C" int rcab_group_smem_bytes(int resident) {
  return int(resident ? R_SMEM_BYTES : SMEM_BYTES);
}

// The name of a cudaError_t the entries above returned.
extern "C" const char* rcab_group_error_name(int err) {
  return cudaGetErrorName(cudaError_t(err));
}
