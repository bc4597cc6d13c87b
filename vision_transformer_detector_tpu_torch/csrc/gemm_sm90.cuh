// Block-tiled tensor-core GEMM building blocks for Hopper (sm_90a), shared
// by int8_dense.cu and dense_mish.cu. Plain inline PTX on top of
// mma_sm90.cuh; no CUTLASS include path is needed.
//
//   * warp_mma_tile: one warp's mma.sync product of a (WM x BK) slice of A
//     with a (BK x WN) slice of the weight as it lies, both in shared
//     memory, in bf16 (m16n8k16) and fp32 (3xTF32);
//   * load_rows_async: a tile of 16-byte chunks from device memory into a
//     padded shared tile with cp.async, rows and columns past the matrix
//     zero-filled (a zero operand adds nothing to any sum), for the ring of
//     stages of a main loop: stage (kt + S - 1) is requested while stage kt
//     is multiplied, with one __syncthreads() per k tile;
//   * wgmma (warpgroup mma, the only way to the card's full tensor-core
//     rates): the shared-memory descriptor, fence / commit / wait,
//     m64n128k16 with bf16 operands (B read from [k][n] storage through
//     the descriptor's transpose flag) and m64n64k32 with s8 operands and
//     s32 sums (both operands K-major: 8-bit types have no transpose);
//   * the epilogue pieces: mish, casts, and a store of an accumulator pair
//     that is guarded at a ragged last column.
//
// An int8 product through mma.sync.m16n8k32 on ldmatrix fragments was built
// first and measured: 8 warps of 32 x 32 reached 430 TOP/s inside the main
// loop at the vit_b16_384 shapes, whatever the tile height, stage depth or
// stage count, about one IMMA per 18 cycles and sub-core; the wgmma loop
// that replaced it is bound by the weight's way from L2 instead.
//
// wgmma shared-memory layouts (128-byte swizzle; every tile base is
// 1024-byte aligned, and the 16-byte chunk c of a 128-byte row r lies at
// chunk c ^ (r % 8)):
//   * K-major (A, and the s8 B from its (N, K) copy): [row][128 bytes];
//     8-row groups 1024 bytes apart (SBO); a k step (16 bf16, 32 s8)
//     advances the start address by 32 bytes inside the row;
//   * bf16 B, N-major (the (K, N) weight as it lies): per 64 columns a
//     block of [k][64 bf16] rows; 8-k groups 1024 bytes apart (SBO), the
//     next 64 columns one block further (LBO); a k step of 16 advances the
//     start address by two groups.
// Every thread of a warpgroup holds, of a 64 x N accumulator and for each
// n-tile j of 8 columns, d[4j] = (16 w + g, 8j + 2t), d[4j + 1] the next
// column, d[4j + 2] and d[4j + 3] the same eight rows down (w its warp in
// the group, lane = 4 g + t): mma.sync's layout, warp by warp.

#pragma once

#include "mma_sm90.cuh"

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// mish(y) = y * tanh(softplus(y)) in closed form. With s = softplus(y),
// tanh(s) = (e^2s - 1) / (e^2s + 1) and e^s = 1 + e^y, so with u = e^-|y|
// (never above 1, so nothing overflows):
//   y >= 0:  tanh(s) = (1 + 2u) / (1 + 2u + 2u^2)
//   y <  0:  tanh(s) = (u^2 + 2u) / (u^2 + 2u + 2)
// Every term is positive: no cancellation at either end, a few fp32 ulp
// from the expf / log1pf / tanhf chain of the plain version, which is held
// to one bf16 rounding (bf16 out) or 1e-5 of the largest value (fp32 out).
// One exponential and one division instead of three libm calls: mish is as
// many CUDA-core instructions as the whole product is tensor-core time, so
// its cost shows. __expf's relative error grows with |y| (about 1e-6 at
// |y| = 20) only where u no longer matters.
__device__ __forceinline__ float mish(float y) {
  const float u = __expf(-fabsf(y));
  const float w = u * u;
  const bool pos = y >= 0.0f;
  const float num = (pos ? 1.0f : w) + 2.0f * u;
  const float den = num + (pos ? 2.0f * w : 2.0f);
  return y * __fdividef(num, den);
}

// Two adjacent outputs (row, col) and (row, col + 1), col even, of an
// (m, n) row-major matrix: one paired store where n is even (the pair is
// then aligned and inside the row), single stores at a ragged edge.
template <typename T>
__device__ __forceinline__ void store_out(T* out, long long row, int col,
                                          int n, float a, float b) {
  T* p = out + row * n + col;
  if ((n & 1) == 0 && col + 1 < n) {
    store_pair(p, a, b);
  } else {
    if (col < n) p[0] = from_float<T>(a);
    if (col + 1 < n) p[1] = from_float<T>(b);
  }
}

// B for columns n0..+7 (b0) and n0+8..+15 (b1), k k0..+15, from a [k][n]
// tile whose A operand was read from [row][k] storage in k order
// (Mma<T>::load_a). bf16 takes ldmatrix.trans. fp32 cannot take
// Mma<float>::load_b_kn, which pairs with an accumulator turned A fragment
// and reads k in that fragment's permuted order; here b_0 = (k t, column g)
// and b_1 = (k t + 4, column g). kPad is the row padding in elements that
// keeps these loads off bank conflicts: 8 floats put rows t = 0..3 on banks
// 8 t + g.
template <typename T>
struct TileB;
template <>
struct TileB<__nv_bfloat16> {
  static constexpr int kPad = Mma<__nv_bfloat16>::kPad;
  static __device__ __forceinline__ void load_kn(
      Mma<__nv_bfloat16>::B& b0, Mma<__nv_bfloat16>::B& b1,
      const __nv_bfloat16* s, int ld, int k0, int n0, int lane) {
    Mma<__nv_bfloat16>::load_b_kn(b0, b1, s, ld, k0, n0, lane);
  }
};
template <>
struct TileB<float> {
  static constexpr int kPad = 8;
  static __device__ __forceinline__ void load_kn(Mma<float>::B& b0,
                                                 Mma<float>::B& b1,
                                                 const float* s, int ld,
                                                 int k0, int n0, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const float* p = s + (k0 + 8 * st + t) * ld + n0 + g;
      Mma<float>::set(b0, 2 * st + 0, p[0]);
      Mma<float>::set(b0, 2 * st + 1, p[4 * ld]);
      Mma<float>::set(b1, 2 * st + 0, p[8]);
      Mma<float>::set(b1, 2 * st + 1, p[4 * ld + 8]);
    }
  }
};

// acc (WM x WN, this warp's) += A (rows a_row0..+WM-1 of a [row][k] tile
// with row stride lda) times B (columns b_n0..+WN-1 of a [k][n] tile, the
// weight as it lies, row stride ldb), over the tile's BK k.
template <typename T, int WM, int WN, int BK>
__device__ __forceinline__ void warp_mma_tile(float (&acc)[WM / 16][WN / 8][4],
                                              const T* a, int lda, int a_row0,
                                              const T* b, int ldb, int b_n0,
                                              int lane) {
  using M = Mma<T>;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    typename M::A fa[WM / 16];
#pragma unroll
    for (int i = 0; i < WM / 16; ++i) {
      M::load_a(fa[i], a, lda, a_row0 + 16 * i, kk, lane);
    }
#pragma unroll
    for (int np = 0; np < WN / 16; ++np) {
      typename M::B b0, b1;
      TileB<T>::load_kn(b0, b1, b, ldb, kk, b_n0 + 16 * np, lane);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i) {
        M::mma(acc[i][2 * np], fa[i], b0);
        M::mma(acc[i][2 * np + 1], fa[i], b1);
      }
    }
  }
}

// kRows x kChunks 16-byte chunks: row row0 + r of a matrix whose rows are
// row_bytes apart, bytes byte0 + 16 c, into dst + r * kLdBytes + 16 c.
// Rows from `rows` on and bytes from `bytes` on are zero-filled; `bytes`
// and byte0 are multiples of 16. Not committed here.
template <int kRows, int kChunks, int kLdBytes, int kThreads>
__device__ __forceinline__ void load_rows_async(unsigned char* dst,
                                                const unsigned char* src,
                                                long long row_bytes, int row0,
                                                int rows, int byte0,
                                                int bytes, int tid) {
  static_assert((kRows * kChunks) % kThreads == 0, "tile split");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunks;
    const int b = (c % kChunks) * 16;
    const bool valid = row0 + r < rows && byte0 + b < bytes;
    cp_async16(dst + r * kLdBytes + b,
               src + (valid ? (row0 + r) * row_bytes + byte0 + b : 0), valid);
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units, layout type 1 in bits
// 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo_bytes,
                                               int sbo_bytes) {
  uint64_t d = (smem_u32(p) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Shared-memory writes of this thread (cp.async included) become visible to
// wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving uses of an accumulator across an
// asynchronous wgmma's start or wait.
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32, this warpgroup's) += A (64 x 16, K-major) B (16 x 128,
// N-major: transpose flag set), both from shared memory. Thread 32 w + 4 g
// + t of the warpgroup holds, for n-tile j of 8 columns, d[4j] = (16 w + g,
// 8j + 2t), d[4j + 1] the next column, d[4j + 2] and d[4j + 3] row + 8.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64 int32, this warpgroup's) = (accumulate ? d : 0) + A (64 x 32
// s8, K-major) B (32 x 64 s8, K-major: [n][k] storage), both from shared
// memory; 8-bit operands have no transpose flag. The accumulator layout is
// the float one's with 8 n-tiles.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate ? 1 : 0));
}
__device__ __forceinline__ void wgmma_fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The byte address, inside a [rows][128 bytes] tile in the 128-byte swizzle,
// of byte b of row r.
__device__ __forceinline__ int swizzled_128(int r, int b) {
  return r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

// The number of SMs of the current device (132 on an H100), asked once.
inline int sm_count() {
  static std::atomic<int> cached{0};
  int n = cached.load(std::memory_order_relaxed);
  if (n > 0) return n;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      n <= 0) {
    n = 132;
  }
  cached.store(n, std::memory_order_relaxed);
  return n;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
