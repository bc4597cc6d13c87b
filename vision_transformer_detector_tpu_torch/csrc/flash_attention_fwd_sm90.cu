// Flash-attention forward in bf16 for Hopper (sm_90a) on wgmma, fed by TMA
// in a warp-specialised pipeline; bound to Python through a plain C
// interface (kernels/ops.py loads it with ctypes). It runs every bf16
// forward route at head dims K <= 128: serving (B1), training with the
// logsumexp (B1-lse) and with dropout (B1-drop), and a ring attention
// block's fp32-output instance with its resumed and suspended online-softmax
// state. fp32 at any K and bf16 at K > 128 run on mma.sync
// (flash_attention_fwd.cu).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// vision_transformer_detector_tpu/kernels/flash_attention.py (launched by
// `_flash_forward`), as flash_attention_fwd.cu does, and computes what that
// kernel computes (its header states the contract): fp32 scores, running
// max and normaliser, the normaliser summed over undropped fp32
// probabilities, P rounded to bf16 (`p.astype(v.dtype)`) before P V with
// fp32 accumulation, lse = m + log(l), and the keep mask of
// `dropout_keep_mask` (dropout_mask.cuh) at the global (batch*head, query,
// key) coordinates, which the backward replays.
//
// What bounds it (one H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): the
// model's shapes sit at or below the bf16 ridge (about 295 FLOP per byte):
// (768, 576, 64) at 288 FLOP per byte (0.068 ms by bytes, 0.066 by
// operations), (2048, 256, 64) with lse at 127 (bound by bytes at 0.081
// ms), (512, 256, 80) at about 100. The mma.sync kernel reached 20-30 % of
// that: with synchronous products the latency of the online-softmax chain
// between the two products of each tile stays exposed, and its 16-byte
// cp.async copies spend the warps' issue slots on addresses. This kernel,
// as chip_smoke.py measured it (H100 SXM, 700 W): 0.196 ms at (768, 576,
// 64), 35 % of its bound, 0.152 ms at (2048, 256, 64) with lse, 53 %, 0.227
// with dropout; at the smaller shapes of serving and of the ViT-H/14-width
// model a call is held by the host (about 0.12-0.14 ms).
//
// Design (FA3's shape, without its intra-warpgroup ping-pong):
//   * one CTA of 5 warps per (batch*head, 64-query tile): a consumer
//     warpgroup (warps 0-3, 16 query rows each) and a producer warp (warp
//     4); two CTAs share an SM (registers: at most 200 a thread);
//   * the producer's one thread issues TMA loads: Q once, then the K and V
//     tiles of kKeys keys (128 at K <= 64, 64 at 64 < K <= 128) into a ring
//     of two stages, each with full barriers for K and for V (the copy's
//     bytes) and an empty barrier the 128 consumer threads arrive on when
//     they are done with the stage; so the next tile's copies are in flight
//     while this one is multiplied, and no consumer instruction computes an
//     address of them;
//   * tensor maps are built on the host from the tensors' own strides,
//     (K, N, heads, batch) with unit head-dim stride, so both layouts
//     (bnhk, bhnk) and strided views are read in place; the box is 64
//     columns (128 bytes, the 128-byte swizzle that wgmma reads) by the
//     tile's rows, one box per 64 columns of the instance (64 or 128), and
//     TMA fills columns past K and rows past N with zeros: the instance
//     reads q, k and v at their own K with no padded copy. The maps are
//     __grid_constant__ parameters, so a captured CUDA graph replays them
//     by value;
//   * S = Q K^T: wgmma m64 x kKeys x 16, both operands K-major in shared
//     memory (descriptors with the 128-byte swizzle), fp32 accumulation in
//     registers, whose layout is mma.sync's (flash_fwd_common.cuh);
//   * the online softmax is the mma.sync forward's, the same code
//     (softmax_step): keys past N masked to -1e30, running max over the
//     quad, alpha = exp(m_old - m_new) rescaling l and O, l summing the fp32
//     probabilities before dropout scales each kept one by 1 / (1 - rate),
//     the mask bit of each score computed by the thread whose accumulator
//     holds it;
//   * O += P V: wgmma m64 x D x 16 with P in registers (the S accumulator
//     rounded to bf16 is the A fragment, as in mma.sync) and V from shared
//     memory as an MN-major B (trans-b), fp32 accumulation in registers;
//   * a ring attention block resumes (m, each lane's part of l, O's
//     accumulator) and suspends them in the (B, H, N, 4) layout of the
//     mma.sync kernel, and runs the same per-tile arithmetic in the same
//     key order as one launch over the sequence, so chained blocks whose
//     boundaries fall on tiles of kKeys keys are bit-equal to it;
//   * epilogue: O / l (or the suspended accumulator) stored from registers
//     through the caller's strides up to K, lse by one lane per row.
// Not done here: overlapping one tile's softmax with the next tile's
// products (FA3's ping-pong between two consumer warpgroups), TMA stores
// and a persistent tile scheduler; setmaxnreg is not used either, as one
// producer warp leaves the consumers 200 registers a thread, which the
// 64 x 128 S and 64 x 128 O accumulators fit in.
// Budget: shared memory, Q 64 x D and two stages of K and V tiles of
// kKeys x D in bf16, plus 1,024 bytes of alignment and the barriers:
// 74,808 (D 64) and 83,000 (D 128) bytes, dynamic; registers 125-168 a
// thread, no spills (-Xptxas -v, CUDA 12.8). chip_smoke.py's build phase
// prints the registers and spills and the HGMMA count of each instance.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "flash_fwd_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;        // query rows per CTA (one warpgroup)
constexpr int kConsumers = 128;  // the consumer warpgroup's threads
constexpr int kThreads = kConsumers + 32;
constexpr int kStages = 2;

template <int D>
struct Shape {
  static constexpr int kKeys = D == 64 ? 128 : 64;   // keys per tile
  static constexpr int kAtoms = D / 64;   // 64-column (128-byte) boxes
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;
  static constexpr int kBarriers = 1 + 3 * kStages;
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * kBarriers;
};

// D (64 x 64, fp32) = A B^T, + D when scale_d: A (64 x 16) and B (64 x 16)
// K-major bf16 in shared memory, through their descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) = A B^T, + D when scale_d: A (64 x 16) and B (128 x 16)
// K-major bf16 in shared memory, through their descriptors.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A B: A (64 x 16 bf16) in registers, B (16 x 64)
// MN-major bf16 in shared memory (trans-b), through its descriptor.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A B: A (64 x 16 bf16) in registers, B (16 x 128)
// MN-major bf16 in shared memory (trans-b), through its descriptor.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int kTiles>
__device__ __forceinline__ void fence_operands(float (&d)[kTiles][4]) {
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}
template <int kSteps>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[kSteps][4]) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
  }
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else {
    wgmma_ss_n128(d, da, db, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// Shared-memory matrix descriptors for the 128-byte swizzle, in which TMA
// stores each box: rows of 64 bf16 (128 bytes), 8-row groups 1,024 bytes
// apart, every group 1,024-byte aligned. Fields: start address >> 4 (bits
// 0-13), leading byte offset >> 4 (16-29), stride byte offset >> 4
// (32-45), layout 1 = 128-byte swizzle (62-63).
__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return (bytes & 0x3FFFF) >> 4;
}

// A K-major operand (Q as A, K as B of S = Q K^T): the k-step of 16
// columns advances the start address 32 bytes within the 128-byte row.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return desc_field(addr) | (desc_field(16) << 16) |
         (desc_field(1024) << 32) | (1ull << 62);
}

// An MN-major operand (V as the B of O += P V, read transposed): the
// leading byte offset steps between 64-column blocks of V (block_bytes
// apart), the stride byte offset between 8-key groups.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr,
                                                 uint32_t block_bytes) {
  return desc_field(addr) | (desc_field(block_bytes) << 16) |
         (desc_field(1024) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of `map` at coordinates (column, row, head, batch) into
// shared memory at dst, its bytes reported to barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

template <int D, bool kDropout, typename O>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      O* __restrict__ o, RowState state, int heads,
                      int seq_len, int kdim, int q_tiles, Strides so,
                      Dropout drop) {
  using S = Shape<D>;
  constexpr int kKeys = S::kKeys;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Every box starts on a 1,024-byte boundary, as the swizzle needs.
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + S::kQBytes;                   // kStages tiles
  const uint32_t v_s = k_s + kStages * S::kTileBytes;      // kStages tiles
  const uint32_t bars = v_s + kStages * S::kTileBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Query tiles of one (batch, head) are neighbours in launch order, so
  // its K and V are read from device memory once and from L2 after that.
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kRows;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kv_tiles = (seq_len + kKeys - 1) / kKeys;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: one thread keeps the ring of stages full.
    if (lane == 0) {
      mbar_expect_tx(q_full, S::kQBytes);
#pragma unroll
      for (int a = 0; a < S::kAtoms; ++a) {
        tma_load(q_s + a * kRows * 128, &tq, q_full, 64 * a, q0, h, b);
      }
      for (int it = 0; it < kv_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
        const uint32_t k_t = k_s + st * S::kTileBytes;
        const uint32_t v_t = v_s + st * S::kTileBytes;
        mbar_expect_tx(k_full(st), S::kTileBytes);
#pragma unroll
        for (int a = 0; a < S::kAtoms; ++a) {
          tma_load(k_t + a * kKeys * 128, &tk, k_full(st), 64 * a,
                   it * kKeys, h, b);
        }
        mbar_expect_tx(v_full(st), S::kTileBytes);
#pragma unroll
        for (int a = 0; a < S::kAtoms; ++a) {
          tma_load(v_t + a * kKeys * 128, &tv, v_full(st), 64 * a,
                   it * kKeys, h, b);
        }
      }
    }
    return;
  }

  // Consumers: warp w owns query rows 16w..16w+15 of the tile; this lane
  // rows row0 and row0 + 8 (flash_fwd_common.cuh's layout).
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + 16 * warp + g;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};
  if (state.m_in != nullptr) {
    resume_state<D / 8>(acc, m_row, l_row, state,
                        state.acc_in + b * so.b + h * so.h, so.n, bh, row0,
                        seq_len, 0, kdim, t);
  }
  unsigned int hash_row[2];
  row_hashes<kDropout>(hash_row, drop, bh, row0);

  float s[kKeys / 8][4];
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
  uint32_t p[kKeys / 16][4];
  mbar_wait(q_full, 0);
  for (int it = 0; it < kv_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const uint32_t k_t = k_s + st * S::kTileBytes;
    const uint32_t v_t = v_s + st * S::kTileBytes;

    // S = Q K^T over D / 16 k-steps, 4 per 64-column box.
    mbar_wait(k_full(st), parity);
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t within = (kk % 4) * 32;
      wgmma_ss<kKeys>(s, kmajor_desc(q_s + (kk / 4) * kRows * 128 + within),
                      kmajor_desc(k_t + (kk / 4) * kKeys * 128 + within),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    softmax_step<kDropout>(s, acc, m_row, l_row, hash_row, it * kKeys,
                           seq_len, t, drop);
    // P rounded to bf16: the S accumulator's pairs are the A fragments.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // O += P V over kKeys / 16 k-steps of 16 keys (2,048 bytes of V each).
    mbar_wait(v_full(st), parity);
    fence_operands(acc);
    fence_operands(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_rs<D>(acc, p[kk], mnmajor_desc(v_t + kk * 16 * 128, kKeys * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    fence_operands(p);
    mbar_arrive(empty(st));
  }
  store_output<D / 8>(acc, m_row, l_row, state, o + b * so.b + h * so.h,
                      so.n, bh, row0, seq_len, 0, kdim, t, true);
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  });
  return fn;
}

// The (K, N, heads, batch) map of a bf16 tensor with element strides s
// (unit head-dim stride), boxes of 64 columns x rows. A stride of an axis
// of size 1 is never followed, and is given the packed value, which TMA's
// 16-byte rule holds.
bool encode(CUtensorMap* map, const void* ptr, int kdim, int seq_len,
            int heads, int batch, Strides s, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t row_bytes = (static_cast<cuuint64_t>(kdim) * 2 + 15) / 16 * 16;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kdim),
                              static_cast<cuuint64_t>(seq_len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t packed[3] = {row_bytes, row_bytes * seq_len,
                                row_bytes * seq_len * heads};
  const long long given[3] = {s.n, s.h, s.b};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed[i]
                                  : static_cast<cuuint64_t>(given[i]) * 2;
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The driver call that encodes the tensor maps needs the device's context
// current in this host thread, which a thread that has made no runtime call
// yet (a server's handler thread) lacks; cudaSetDevice makes it current,
// once per thread and device (the runtime keeps it current until the
// thread selects another device).
cudaError_t make_context_current() {
  thread_local int context_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device != context_device) {
    err = cudaSetDevice(device);
    if (err == cudaSuccess) context_device = device;
  }
  return err;
}

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  RowState state;
  int batch, heads, seq_len, kdim;
  Strides sq, sk, sv, so;
  Dropout drop;
  cudaStream_t stream;
};

template <int D, bool kDropout, typename O>
cudaError_t launch_kernel(const Launch& a) {
  using S = Shape<D>;
  cudaError_t err = make_context_current();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, a.q, a.kdim, a.seq_len, a.heads, a.batch, a.sq, kRows) ||
      !encode(&tk, a.k, a.kdim, a.seq_len, a.heads, a.batch, a.sk,
              S::kKeys) ||
      !encode(&tv, a.v, a.kdim, a.seq_len, a.heads, a.batch, a.sv,
              S::kKeys)) {
    return cudaErrorInvalidValue;
  }
  static std::atomic<unsigned long long> smem_allowed{0};
  auto kernel = flash_fwd_sm90_kernel<D, kDropout, O>;
  err = allow_dynamic_smem(kernel, S::kSmem, smem_allowed);
  if (err != cudaSuccess) return err;
  const int q_tiles = (a.seq_len + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(a.batch) * a.heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, S::kSmem, a.stream>>>(
      tq, tk, tv, static_cast<O*>(a.o), a.state, a.heads, a.seq_len, a.kdim,
      q_tiles, a.so, a.drop);
  return cudaGetLastError();
}

template <typename O, bool kDropout>
cudaError_t launch_dim(const Launch& a) {
  if (a.kdim <= 64) return launch_kernel<64, kDropout, O>(a);
  return launch_kernel<128, kDropout, O>(a);
}

}  // namespace

extern "C" {

// The arguments of flash_attention_fwd.cu's vtd_flash_attention_fwd, for
// bf16 (dtype 1) at head_dim K <= 128 with K % 8 == 0: out_fp32 1 writes
// the output in fp32 (a ring attention block), 0 in bf16. The instance is
// 64 for K <= 64, else 128; TMA zero-fills the columns past K. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// this kernel does not take (and when a tensor map cannot be encoded).
int vtd_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* m_in, const void* l_in, const void* acc_in, void* m_out,
    void* l_out, int dtype, int out_fp32, int batch, int heads, int seq_len,
    int head_dim, long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn, long long v_sb,
    long long v_sh, long long v_sn, long long o_sb, long long o_sh,
    long long o_sn, int dropout, const unsigned int* seed,
    unsigned int threshold, float inv_keep, unsigned int bh_base,
    unsigned int q_base, unsigned int k_base, unsigned int inner_local,
    unsigned int inner_global, unsigned int inner_base, void* stream) {
  if (dtype != 1 || batch <= 0 || heads <= 0 || seq_len <= 0 ||
      head_dim <= 0 || head_dim > 128 || head_dim % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  if (dropout != 0 && seed == nullptr) return cudaErrorInvalidValue;
  if (inner_local == 0) return cudaErrorInvalidValue;
  const RowState state{static_cast<float*>(lse),
                       static_cast<const float*>(m_in),
                       static_cast<const float*>(l_in),
                       static_cast<const float*>(acc_in),
                       static_cast<float*>(m_out),
                       static_cast<float*>(l_out)};
  if (!state_ok(state, out_fp32 != 0)) return cudaErrorInvalidValue;
  const Launch a{q, k, v, o, state, batch, heads, seq_len, head_dim,
                 Strides{q_sb, q_sh, q_sn}, Strides{k_sb, k_sh, k_sn},
                 Strides{v_sb, v_sh, v_sn}, Strides{o_sb, o_sh, o_sn},
                 Dropout{seed, threshold, inv_keep, bh_base, q_base, k_base,
                         inner_local, inner_global, inner_base},
                 static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (out_fp32 != 0) {
    err = dropout != 0 ? launch_dim<float, true>(a)
                       : launch_dim<float, false>(a);
  } else {
    err = dropout != 0 ? launch_dim<bf16, true>(a)
                       : launch_dim<bf16, false>(a);
  }
  return static_cast<int>(err);
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
