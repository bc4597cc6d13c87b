// Fused dense + bias + mish for Hopper (sm_90a), bound to Python through a
// plain C interface (kernels/fused_ffn.py loads it with ctypes).
//
// Replaces the Pallas TPU kernel `_ffn_kernel` in
// vision_transformer_detector_tpu/kernels/fused_ffn.py (launched by
// `_fused_forward`): y = x @ w + b with fp32 accumulation, then mish(y) =
// y * tanh(softplus(y)) in fp32 (softplus = max(y, 0) + log1p(exp(-|y|)),
// as jax.nn.softplus), then the cast to x's dtype. x (M, K), w (K, N) and
// b (N,) all come in the compute dtype (fp32 or bf16), as the model hands
// them over.
//
// What bounds it: the 768 -> 1536 layer of vit_b16_384 at batch 32 is
// 2 * 18,432 * 768 * 1536 = 4.35e10 FLOP on 88 MB of bf16: at the card's
// bf16 tensor rate (989 TFLOP/s) about 44 us, so the bf16 kernel is bound
// by its operations, and it has to keep the tensor cores fed from shared
// memory: a 128 x 128 output tile reads (128 + 128) * K operands for
// 128 * 128 * K products, 64 FLOP per byte that L2 delivers, 680 MB in all
// for that layer, which is what holds the wgmma instance back once the
// products are fast. In fp32 the products go to the TF32 tensor cores three
// at a time (3xTF32, fp32 accuracy), 0.26 ms for that layer at the TF32
// rate. mish, in a closed form of one exponential and one division
// (gemm_sm90.cuh), runs on the accumulator registers; two blocks per SM let
// one block's epilogue and its waits run under the other's products.
//
// Three instances, chosen by shape in the plan's query (vtd_dense_mish_plan,
// once per launch plan; dispatch, not a fallback: none is taken because
// another failed):
//   * wgmma (bf16, at least one wave of 128 x 128 tiles): two warpgroups,
//     each m64n128k16 on its 64 rows, A and B from shared memory in the
//     128-byte swizzle, B read from the (K, N) weight's own [k][n] order
//     through the descriptor's transpose flag; a ring of three 64-deep k
//     tiles filled by 16-byte cp.async from all 256 threads, one
//     __syncthreads() per k tile, the next tile's copies started while the
//     warpgroups multiply;
//   * mma.sync (bf16 m16n8k16 through ldmatrix, fp32 as 3xTF32): 8 warps on
//     a 128 x 128 (bf16), 128 x 64 (fp32) or, where the matrix gives fewer
//     tiles than the card has SMs, 64 x 64 tile; the same ring; rows padded
//     by one 16-byte chunk (two for the fp32 weight tile) so that no
//     fragment load meets a bank conflict.
//     The tensor cores truncate when they add into a long-lived fp32
//     accumulator, so the fp32 instance sums each k tile's products in
//     fresh registers and adds them with one rounded fp32 add per element;
//   * guarded (CUDA cores, fp32 FMA, scalar loads): rows of x or w that do
//     not start on 16-byte boundaries (K or N not a multiple of 8 in bf16,
//     of 4 in fp32: reference_608's D = 28, the N = 17 and N = 6 layers),
//     which cp.async cannot move.
// In every instance bias, mish and the cast run on the accumulator
// registers before the only write of the output tile, which is what the
// TPU kernel's single VMEM round trip is for. Ragged M, N and K are masked
// (out-of-range operands load as 0); nothing is padded in device memory.
// The tile index along N runs fastest in the grid, so the blocks that run
// together share their rows of x and re-read the weight from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_sm90.cuh"
#include "launch_common.cuh"

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// Guarded instance: any shape, any alignment.
// ---------------------------------------------------------------------------

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kBlockK = 16;

template <typename T, bool kMish>
__global__ void __launch_bounds__(kThreads) dense_mish_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    T* __restrict__ out, int m, int n, int k) {
  __shared__ float x_tile[kBlockK][kBlockM + 1];   // [k][row]
  __shared__ float w_tile[kBlockK][kBlockN];       // [k][col]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBlockM;
  const int col0 = blockIdx.x * kBlockN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < k; k0 += kBlockK) {
#pragma unroll
    for (int l = 0; l < (kBlockM * kBlockK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kBlockK;
      const int kk = idx % kBlockK;
      const int row = row0 + r;
      const int kg = k0 + kk;
      x_tile[kk][r] = (row < m && kg < k)
                          ? to_float(x[static_cast<long long>(row) * k + kg])
                          : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < (kBlockN * kBlockK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int kk = idx / kBlockN;
      const int c = idx % kBlockN;
      const int col = col0 + c;
      const int kg = k0 + kk;
      w_tile[kk][c] = (col < n && kg < k)
                          ? to_float(w[static_cast<long long>(kg) * n + col])
                          : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBlockK; ++kk) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = x_tile[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = w_tile[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= n) continue;
      float y = acc[i][j] + to_float(b[col]);
      if (kMish) y = mish(y);
      out[static_cast<long long>(row) * n + col] = from_float<T>(y);
    }
  }
}

// ---------------------------------------------------------------------------
// The epilogue of both tensor-core instances, on one accumulator n-tile:
// c[0], c[1] at (row, col), (row, col + 1) and c[2], c[3] eight rows down.
// N is a multiple of the 16-byte chunk, so an even col < n has col + 1 < n.
// ---------------------------------------------------------------------------

template <typename T, bool kMish>
__device__ __forceinline__ void finish_pair(T* out, const T* b, int row,
                                            int col, int m, int n,
                                            const float* c) {
  if (col >= n) return;
  const float b0 = to_float(b[col]), b1 = to_float(b[col + 1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= m) continue;
    float y0 = c[2 * h] + b0, y1 = c[2 * h + 1] + b1;
    if (kMish) {
      y0 = mish(y0);
      y1 = mish(y1);
    }
    store_pair(out + static_cast<long long>(r) * n + col, y0, y1);
  }
}

// ---------------------------------------------------------------------------
// mma.sync instance.
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int BK, int WM, int WN, int S>
struct MmaTile {
  static constexpr int kLdA = BK + Mma<T>::kPad;
  static constexpr int kLdB = BN + TileB<T>::kPad;
  static constexpr int kStageA = BM * kLdA;   // elements
  static constexpr int kStageB = BK * kLdB;
  static constexpr int kSmemBytes =
      S * (kStageA + kStageB) * static_cast<int>(sizeof(T));
  static_assert((BM / WM) * (BN / WN) * 32 == kThreads, "8 warps");
};

template <typename T, int BM, int BN, int BK, int WM, int WN, int S,
          bool kMish>
__global__ void __launch_bounds__(kThreads) dense_mish_mma_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    T* __restrict__ out, int m, int n, int k) {
  using Tile = MmaTile<T, BM, BN, BK, WM, WN, S>;
  constexpr int kSize = static_cast<int>(sizeof(T));
  constexpr int kChunksA = BK * kSize / 16;
  constexpr int kChunksB = BN * kSize / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);
  T* sb = sa + S * Tile::kStageA;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / (BN / WN);
  const int wn = warp % (BN / WN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_tiles = (k + BK - 1) / BK;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);

  auto load_stage = [&](int kt) {
    const int stage = kt % S;
    load_rows_async<BM, kChunksA, Tile::kLdA * kSize, kThreads>(
        reinterpret_cast<unsigned char*>(sa + stage * Tile::kStageA), xb,
        static_cast<long long>(k) * kSize, row0, m, kt * BK * kSize,
        k * kSize, tid);
    load_rows_async<BK, kChunksB, Tile::kLdB * kSize, kThreads>(
        reinterpret_cast<unsigned char*>(sb + stage * Tile::kStageB), wb,
        static_cast<long long>(n) * kSize, kt * BK, k, col0 * kSize,
        n * kSize, tid);
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < k_tiles) load_stage(s);
    cp_async_commit();
  }

  float acc[WM / 16][WN / 8][4] = {};
  for (int kt = 0; kt < k_tiles; ++kt) {
    // Tile kt has landed; every warp is past tile kt - 1, so its stage is
    // free for tile kt + S - 1.
    cp_async_wait<S - 2>();
    __syncthreads();
    if (kt + S - 1 < k_tiles) load_stage(kt + S - 1);
    cp_async_commit();

    const T* a_tile = sa + (kt % S) * Tile::kStageA;
    const T* b_tile = sb + (kt % S) * Tile::kStageB;
    if constexpr (Mma<T>::kTileSums) {
      float part[WM / 16][WN / 8][4] = {};
      warp_mma_tile<T, WM, WN, BK>(part, a_tile, Tile::kLdA, wm * WM, b_tile,
                                   Tile::kLdB, wn * WN, lane);
#pragma unroll
      for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
        for (int j = 0; j < WN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
        }
      }
    } else {
      warp_mma_tile<T, WM, WN, BK>(acc, a_tile, Tile::kLdA, wm * WM, b_tile,
                                   Tile::kLdB, wn * WN, lane);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i) {
#pragma unroll
    for (int j = 0; j < WN / 8; ++j) {
      finish_pair<T, kMish>(out, b, row0 + wm * WM + 16 * i + g,
                            col0 + wn * WN + 8 * j + 2 * t, m, n, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma instance (bf16): 128 x 128 tile, two warpgroups of 64 rows.
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;
constexpr int kWgBN = 128;
constexpr int kWgBK = 64;
constexpr int kWgStages = 3;
constexpr int kWgStageA = kWgBM * kWgBK * 2;         // bytes, 16 KB
constexpr int kWgStageB = kWgBK * kWgBN * 2;         // bytes, 16 KB
constexpr int kWgStage = kWgStageA + kWgStageB;
constexpr int kWgSmemBytes = kWgStages * kWgStage + 1024;   // + alignment

template <bool kMish>
__global__ void __launch_bounds__(kThreads, 2) dense_mish_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out,
    int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The swizzle is a function of the address: stages start on 1024 bytes.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int row0 = blockIdx.y * kWgBM;
  const int col0 = blockIdx.x * kWgBN;
  const int k_tiles = (k + kWgBK - 1) / kWgBK;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);

  auto load_stage = [&](int kt) {
    unsigned char* a_dst = smem + (kt % kWgStages) * kWgStage;
    unsigned char* b_dst = a_dst + kWgStageA;
    // A: 128 rows x 8 chunks; chunk c of row r lies at c ^ (r % 8).
#pragma unroll
    for (int i = 0; i < kWgBM * 8 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int r = id / 8, c = id % 8;
      const int kk = kt * kWgBK + c * 8;
      const bool valid = row0 + r < m && kk < k;
      cp_async16(a_dst + r * 128 + ((c ^ (r & 7)) << 4),
                 xb + (valid ? (static_cast<long long>(row0 + r) * k + kk) * 2
                             : 0),
                 valid);
    }
    // B: 64 k rows x 16 chunks; columns 64 h .. 64 h + 63 form block h of
    // [k][64] rows, chunk c of row kr at c ^ (kr % 8).
#pragma unroll
    for (int i = 0; i < kWgBK * 16 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int kr = id / 16, c = id % 16;
      const int kk = kt * kWgBK + kr;
      const int col = col0 + c * 8;
      const bool valid = kk < k && col < n;
      cp_async16(b_dst + (c / 8) * (kWgBK * 128) + kr * 128 +
                     (((c % 8) ^ (kr & 7)) << 4),
                 wb + (valid ? (static_cast<long long>(kk) * n + col) * 2 : 0),
                 valid);
    }
  };

#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < k_tiles) load_stage(s);
    cp_async_commit();
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    // This thread's copies of tile kt have landed and its warpgroup's
    // products of tile kt - 1 are done; after the barrier that holds for
    // every thread, so tile kt may be read and tile kt - 1's stage refilled.
    cp_async_wait<kWgStages - 2>();
    wgmma_wait<0>();
    fence_proxy_async();
    __syncthreads();

    const unsigned char* a_tile = smem + (kt % kWgStages) * kWgStage;
    const unsigned char* b_tile = a_tile + kWgStageA;
    wgmma_fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // A: this warpgroup's 64 rows, 32 bytes further per k step; 8-row
      // groups 1024 bytes apart. B: two 8-k groups further per k step;
      // groups 1024 bytes apart, the next 64 columns one block on.
      const uint64_t da =
          wgmma_desc(a_tile + wg * (64 * 128) + kk * 32, 16, 1024);
      const uint64_t db =
          wgmma_desc(b_tile + kk * (16 * 128), kWgBK * 128, 1024);
      wgmma_m64n128k16_bf16(acc, da, db);
    }
    wgmma_commit();
    wgmma_fence_acc(acc);

    if (kt + kWgStages - 1 < k_tiles) load_stage(kt + kWgStages - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
  wgmma_fence_acc(acc);

  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row = row0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    finish_pair<__nv_bfloat16, kMish>(out, b, row, col0 + 8 * j + 2 * t, m, n,
                                      acc + 4 * j);
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

enum Instance { kGuarded = 0, kMmaSync = 1, kWgmma = 2 };

template <typename T, int BM, int BN, int BK, int WM, int WN, int S>
cudaError_t launch_mma(const T* x, const T* w, const T* b, T* out, int m,
                       int n, int k, bool apply_mish, cudaStream_t stream) {
  using Tile = MmaTile<T, BM, BN, BK, WM, WN, S>;
  static std::atomic<unsigned long long> done_mish{0}, done_plain{0};
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  if (apply_mish) {
    auto kernel = dense_mish_mma_kernel<T, BM, BN, BK, WM, WN, S, true>;
    cudaError_t err = allow_dynamic_smem(kernel, Tile::kSmemBytes, done_mish);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, Tile::kSmemBytes, stream>>>(x, w, b, out, m, n,
                                                         k);
  } else {
    auto kernel = dense_mish_mma_kernel<T, BM, BN, BK, WM, WN, S, false>;
    cudaError_t err = allow_dynamic_smem(kernel, Tile::kSmemBytes, done_plain);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, Tile::kSmemBytes, stream>>>(x, w, b, out, m, n,
                                                         k);
  }
  return cudaSuccess;
}

cudaError_t launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* w,
                         const __nv_bfloat16* b, __nv_bfloat16* out, int m,
                         int n, int k, bool apply_mish, cudaStream_t stream) {
  static std::atomic<unsigned long long> done_mish{0}, done_plain{0};
  const dim3 grid((n + kWgBN - 1) / kWgBN, (m + kWgBM - 1) / kWgBM);
  if (apply_mish) {
    auto kernel = dense_mish_wgmma_kernel<true>;
    cudaError_t err = allow_dynamic_smem(kernel, kWgSmemBytes, done_mish);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, kWgSmemBytes, stream>>>(x, w, b, out, m, n, k);
  } else {
    auto kernel = dense_mish_wgmma_kernel<false>;
    cudaError_t err = allow_dynamic_smem(kernel, kWgSmemBytes, done_plain);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, kWgSmemBytes, stream>>>(x, w, b, out, m, n, k);
  }
  return cudaSuccess;
}

template <typename T>
void launch_guarded(const T* x, const T* w, const T* b, T* out, int m, int n,
                    int k, bool apply_mish, cudaStream_t stream) {
  const dim3 grid((n + kBlockN - 1) / kBlockN, (m + kBlockM - 1) / kBlockM);
  if (apply_mish) {
    dense_mish_kernel<T, true>
        <<<grid, kThreads, 0, stream>>>(x, w, b, out, m, n, k);
  } else {
    dense_mish_kernel<T, false>
        <<<grid, kThreads, 0, stream>>>(x, w, b, out, m, n, k);
  }
}

// Whether the big tiles give every SM at least one block.
inline bool fills_card(int m, int n, int bm, int bn) {
  const long long tiles =
      static_cast<long long>((m + bm - 1) / bm) * ((n + bn - 1) / bn);
  return tiles >= sm_count();
}

// The instance a call of this shape runs (the plan's query): `request` 0
// by shape, 1 guarded, 2 mma.sync, 3 wgmma; `addresses_aligned` whether x,
// w and out start on 16-byte boundaries. A request that the shape or type
// cannot take is an error, not a silent change.
template <typename T>
cudaError_t choose(int m, int n, int k, int request, bool addresses_aligned,
                   int* instance) {
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  constexpr bool kBf16 = sizeof(T) == 2;
  const bool aligned =
      k % kPerChunk == 0 && n % kPerChunk == 0 && addresses_aligned;
  if (request < 0 || request > 3) return cudaErrorInvalidValue;
  if ((request == 2 || request == 3) && !aligned) return cudaErrorInvalidValue;
  if (request == 3 && !kBf16) return cudaErrorInvalidValue;
  if (request == 1 || !aligned) {
    *instance = kGuarded;
  } else if (request == 2) {
    *instance = kMmaSync;
  } else if (request == 3) {
    *instance = kWgmma;
  } else {
    *instance = kBf16 && fills_card(m, n, kWgBM, kWgBN) ? kWgmma : kMmaSync;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* xv, const void* wv, const void* bv,
                     void* outv, int m, int n, int k, bool apply_mish,
                     int instance, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* b = static_cast<const T*>(bv);
  T* out = static_cast<T*>(outv);
  constexpr bool kBf16 = sizeof(T) == 2;
  if (instance == kGuarded) {
    launch_guarded<T>(x, w, b, out, m, n, k, apply_mish, stream);
    return cudaSuccess;
  }
  // The plan chose a tensor-core instance for 16-byte-aligned operands.
  if (!aligned16(x) || !aligned16(w) || !aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  if constexpr (kBf16) {
    if (instance == kWgmma) {
      return launch_wgmma(x, w, b, out, m, n, k, apply_mish, stream);
    }
    if (fills_card(m, n, 128, 128)) {
      return launch_mma<T, 128, 128, 64, 64, 32, 3>(x, w, b, out, m, n, k,
                                                    apply_mish, stream);
    }
    return launch_mma<T, 64, 64, 64, 32, 16, 3>(x, w, b, out, m, n, k,
                                                apply_mish, stream);
  } else {
    if (instance != kMmaSync) return cudaErrorInvalidValue;
    if (fills_card(m, n, 128, 64)) {
      return launch_mma<T, 128, 64, 32, 32, 32, 3>(x, w, b, out, m, n, k,
                                                   apply_mish, stream);
    }
    return launch_mma<T, 64, 64, 32, 32, 16, 3>(x, w, b, out, m, n, k,
                                                apply_mish, stream);
  }
}

}  // namespace

extern "C" {

// The plan's query: writes into a->instance the instance that calls of
// this block run (0 guarded, 1 mma.sync, 2 wgmma), from the sizes, the
// dtype, a->request (0 by shape, 1 guarded, 2 mma.sync, 3 wgmma) and
// a->aligned16, on a->device (the wgmma instance needs a wave of tiles on
// its SMs). Launches nothing. Returns cudaErrorInvalidValue for a request
// the shape or dtype cannot take (0 on success).
int vtd_dense_mish_plan(DenseMishArgs* a) {
  const DeviceScope scope(a->device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaError_t err;
  if (a->dtype == 0) {
    err = choose<float>(a->m, a->n, a->k, a->request, a->aligned16 != 0,
                        &a->instance);
  } else if (a->dtype == 1) {
    err = choose<__nv_bfloat16>(a->m, a->n, a->k, a->request,
                                a->aligned16 != 0, &a->instance);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// One launch of a->instance from the plan's block `a` (launch_common.cuh's
// DenseMishArgs) and the call's device addresses and stream, on a->device.
// x: contiguous (m, k); w: contiguous (k, n); b: contiguous (n,); out:
// contiguous (m, n); all in a->dtype (0 = float32, 1 = bfloat16). Returns
// the first CUDA error of the launch (0 on success).
int vtd_dense_mish(const DenseMishArgs* a, const void* x, const void* w,
                   const void* b, void* out, void* stream) {
  const int m = a->m, n = a->n, k = a->k;
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  const DeviceScope scope(a->device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a->dtype == 0) {
    err = dispatch<float>(x, w, b, out, m, n, k, a->apply_mish != 0,
                          a->instance, s);
  } else if (a->dtype == 1) {
    err = dispatch<__nv_bfloat16>(x, w, b, out, m, n, k, a->apply_mish != 0,
                                  a->instance, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
