// Fused int8 dense for Hopper (sm_90a), bound to Python through a plain C
// interface (kernels/quantization.py loads it with ctypes).
//
// Replaces the Pallas TPU kernel `_fused_int8_kernel` in
// vision_transformer_detector_tpu/kernels/quantization.py (launched by
// `fused_int8_dense`): per-row dynamic int8 quantization of the activations
// x (M, K), x_scale = max(|x|_max, 1e-8) / 127 and q = clip(round(x /
// x_scale), -127, 127), an int8 x int8 -> int32 product with the int8
// weight (K, N), then y = (float(acc) * x_scale) * w_scale + bias, an
// optional mish in fp32, and the cast out (bf16 for that kernel). The same
// source also serves the module's XLA route `int8_dense` (the attention
// q/k/v/out projections): there x comes in fp32 or bf16 and y goes out in
// fp32, with the same arithmetic.
//
// Numerics held to the JAX package bit for bit up to the epilogue's mish:
//   * round half to even and IEEE divisions for x_scale and x / x_scale
//     (the build has no --use_fast_math), so codes at .5 boundaries come
//     out as in jnp.round; the tensor-core instances reach the same codes
//     through the row's reciprocal and divide only near a .5 (quantize4);
//   * the int32 sums are exact in any order; the epilogue multiplies and
//     adds with __fmul_rn / __fadd_rn, so nvcc fuses nothing into an FMA,
//     in the JAX order (acc * x_scale) * w_scale + bias;
//   * mish(y) = y * tanh(softplus(y)) in a closed form that is a few fp32
//     ulp from the libm chain (gemm_sm90.cuh), far inside the bf16 output's
//     rounding.
//
// What bounds it: at vit_b16_384 batch 32 (M = 18,432) the 768 -> 1536
// layer is 2 * M * K * N = 4.35e10 int8 operations on about 86 MB of
// bf16 x, int8 w and bf16 y: at the card's int8 tensor rate (1,979 TOP/s)
// the bytes bound it (about 26 us at 3.35 TB/s). Beside the product the
// kernel pays for the quantization of x (a pass over x that waits for
// device memory and then costs some seven instructions per element) and
// for what the blocks together read of the weight from L2 (K * N bytes per
// 64 rows), so the quantization is done once per block, not once per tile,
// and under other blocks' products.
//
// Instances, chosen by shape in the plan's query (vtd_int8_dense_plan, once
// per launch plan; dispatch, not a fallback: none is taken because another
// failed):
//   * tensor cores, codes resident: a block of 256 threads owns 64 rows.
//     It finds their maxima over the whole K, keeps x_scale in shared
//     memory and quantizes the 64 x K codes into shared memory ONCE (x is
//     read once where a row fits the lanes' registers, K <= 768 in bf16);
//     no int8 copy of x ever reaches device memory, which is the point of
//     the TPU kernel too. Then it walks its share of the 128-column tiles
//     of the output: the weight, read from an (N, K) copy of the codes
//     (8-bit wgmma takes both operands K-major), streams through a ring of
//     three 128-deep k tiles filled by 16-byte cp.async, one
//     __syncthreads() per k tile, across tile boundaries; two warpgroups
//     form 64 x 64 each with wgmma.m64n64k32 (s8 x s8 -> s32), codes and
//     weights read from shared memory in the 128-byte swizzle. The
//     epilogue runs on the accumulator registers while the next tile's
//     weights are in flight. Two blocks share an SM where K <= 768, so one
//     block's quantization and epilogue run under the other's products;
//     the column tiles of a row tile are split over blocks only as far as
//     that shortens the last wave (each split repeats the quantization);
//   * tensor cores, codes streamed: where 64 x K codes do not fit beside
//     the ring (K above about 2,800: highres_1024's head has 5,376
//     features per slot), the block keeps only x_scale and quantizes each
//     64 x 128 tile of x as it is needed, one tile ahead of the products;
//   * guarded (CUDA cores, __dp4a, scalar loads, the (K, N) weight as it
//     lies): K not a multiple of 16 or x off a 16-byte boundary
//     (reference_608's D = 28), which cp.async cannot move.
// Ragged M, N and K are masked: out-of-range x and w load as 0, and a zero
// code adds nothing to the sum; out-of-range outputs are not written.
// Nothing is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "launch_common.cuh"

namespace {

constexpr int kThreads = 256;

// clip(round(v / scale), -127, 127) as a byte, the quotient an IEEE
// division and the rounding half to even, as jnp.round(x / x_scale).
__device__ __forceinline__ uint32_t code_of(float quotient) {
  float t = rintf(quotient);
  t = fminf(fmaxf(t, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(static_cast<int>(t))));
}

__device__ __forceinline__ uint32_t quantize(float v, float scale) {
  return code_of(__fdiv_rn(v, scale));
}

// The same codes for four values at once from the row's reciprocal,
// inv = rn(1 / scale), with no division in the common case. Adding
// 1.5 * 2^23 rounds v * inv (the exact product: one FMA) to the nearest
// integer, ties to even, and leaves that integer in the sum's low bits; its
// low byte is the code, and |v| <= the row's maximum keeps it inside
// +-127 without a clip. The product is within 2^-17 of v / scale (inv's
// rounding on a quotient of at most 128) and the IEEE quotient within
// 2^-18, so all three round alike unless the product lies that close to a
// half: where any of the four is within 2^-12 of one, the IEEE division
// decides all four. Bit-equal to quantize().
__device__ __forceinline__ uint32_t quantize4(const float* v, float scale,
                                              float inv) {
  constexpr float kMagic = 12582912.0f;          // 1.5 * 2^23
  float t[4];
  float worst = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    t[i] = fmaf(v[i], inv, kMagic);
    const float rounded = t[i] - kMagic;
    worst = fmaxf(worst, fabsf(fmaf(v[i], inv, -rounded)));
  }
  if (worst > 0.5f - 0.000244140625f) {
    return quantize(v[0], scale) | quantize(v[1], scale) << 8 |
           quantize(v[2], scale) << 16 | quantize(v[3], scale) << 24;
  }
  const uint32_t lo =
      __byte_perm(__float_as_uint(t[0]), __float_as_uint(t[1]), 0x0040);
  const uint32_t hi =
      __byte_perm(__float_as_uint(t[2]), __float_as_uint(t[3]), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// y = (acc * x_scale) * w_scale + bias, each step rounded on its own.
__device__ __forceinline__ float rescale(int acc, float x_scale,
                                         float w_scale, float bias) {
  const float y = __fmul_rn(__int2float_rn(acc), x_scale);
  return __fadd_rn(__fmul_rn(y, w_scale), bias);
}

// ---------------------------------------------------------------------------
// Guarded instance: any shape, any alignment.
// ---------------------------------------------------------------------------

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kBlockK = 64;
constexpr int kWords = kBlockK / 4 + 1;   // int32 words per staged row

template <typename Tin, typename Tout, bool kMish>
__global__ void __launch_bounds__(kThreads) int8_dense_kernel(
    const Tin* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ wscale, const float* __restrict__ bias,
    Tout* __restrict__ out, int m, int n, int k) {
  __shared__ int x_tile[kBlockM * kWords];   // quantized x, [row][k / 4]
  __shared__ int w_tile[kBlockN * kWords];   // weight, [col][k / 4]
  __shared__ float row_scale[kBlockM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.y * kBlockM;
  const int col0 = blockIdx.x * kBlockN;

  // 1. x_scale of each row over the full K.
  for (int r = warp; r < kBlockM; r += kThreads / 32) {
    const int row = row0 + r;
    float amax = 0.0f;
    if (row < m) {
      const Tin* x_row = x + static_cast<long long>(row) * k;
      for (int kk = lane; kk < k; kk += 32) {
        amax = fmaxf(amax, fabsf(to_float(x_row[kk])));
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, offset));
    }
    if (lane == 0) row_scale[r] = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  }
  __syncthreads();

  const int tx = tid % 16;
  const int ty = tid / 16;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }

  // The thread's slice of the x tile: 16 consecutive k of one row.
  const int xr = tid / 4;
  const int xk = (tid % 4) * 16;
  const int x_row = row0 + xr;
  const float x_scale = row_scale[xr];
  int8_t* w_bytes = reinterpret_cast<int8_t*>(w_tile);

  for (int k0 = 0; k0 < k; k0 += kBlockK) {
    // 2a. Quantize the x tile into shared memory, 4 codes per word.
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int byte = 0; byte < 4; ++byte) {
        const int kk = k0 + xk + 4 * w + byte;
        const float v = (x_row < m && kk < k)
                            ? to_float(x[static_cast<long long>(x_row) * k + kk])
                            : 0.0f;
        word |= quantize(v, x_scale) << (8 * byte);
      }
      x_tile[xr * kWords + xk / 4 + w] = static_cast<int>(word);
    }
    // 2b. Stage the weight tile transposed; reads run along n.
    for (int idx = tid; idx < kBlockK * kBlockN; idx += kThreads) {
      const int kk = idx / kBlockN;
      const int nn = idx % kBlockN;
      const int kg = k0 + kk;
      const int col = col0 + nn;
      w_bytes[nn * (kWords * 4) + kk] =
          (kg < k && col < n) ? wq[static_cast<long long>(kg) * n + col]
                              : static_cast<int8_t>(0);
    }
    __syncthreads();

    // 3. int32 dots, 4 k per __dp4a.
#pragma unroll
    for (int kw = 0; kw < kBlockK / 4; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = x_tile[(ty + 16 * i) * kWords + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = w_tile[(tx + 16 * j) * kWords + kw];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // 4. Epilogue: rescale, bias, optional mish, cast.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = row0 + r;
    if (row >= m) continue;
    const float scale = row_scale[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= n) continue;
      float y = rescale(acc[i][j], scale, wscale[col], bias[col]);
      if (kMish) y = mish(y);
      out[static_cast<long long>(row) * n + col] = from_float<Tout>(y);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core instances.
// ---------------------------------------------------------------------------

constexpr int kBN = 128;                // output columns per tile
constexpr int kDepth = 128;             // k per code tile and ring stage
constexpr int kStages = 3;              // ring stages
constexpr int kTileB = kBN * kDepth;    // one stage: 16 KB of weights
constexpr int kRows = 64;               // rows of x per block
constexpr int kTileA = kRows * kDepth;  // one k tile of codes, 8 KB
constexpr int kBatch = 12;              // prologue loads in flight per lane
constexpr int kMaxSmem = 232448;        // 227 KB a block may take

// 16 bytes of x as floats: 8 bf16 or 4 fp32.
template <typename Tin>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kCount = 8;
  static __device__ __forceinline__ void load(float (&v)[8],
                                              const __nv_bfloat16* p) {
    unpack(v, *reinterpret_cast<const uint4*>(p));
  }
  // The running maximum of |x|, two bf16 to a register: |bf16| orders as
  // its bits, and the packed max needs no unpacking.
  using Max = __nv_bfloat162;
  static __device__ __forceinline__ Max max_init() {
    return __float2bfloat162_rn(0.0f);
  }
  static __device__ __forceinline__ void max_update(Max& acc, uint4 raw) {
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = __hmax2(acc, __habs2(*reinterpret_cast<const Max*>(&words[i])));
    }
  }
  static __device__ __forceinline__ float max_finish(Max acc) {
    return fmaxf(__low2float(acc), __high2float(acc));
  }
  static __device__ __forceinline__ void unpack(float (&v)[8], uint4 raw) {
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // A bf16 is the upper half of its fp32.
      v[2 * i] = __uint_as_float(words[i] << 16);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
};
template <>
struct Chunk<float> {
  static constexpr int kCount = 4;
  static __device__ __forceinline__ void load(float (&v)[4], const float* p) {
    unpack(v, *reinterpret_cast<const uint4*>(p));
  }
  using Max = float;
  static __device__ __forceinline__ Max max_init() { return 0.0f; }
  static __device__ __forceinline__ void max_update(Max& acc, uint4 raw) {
    acc = fmaxf(fmaxf(acc, fabsf(__uint_as_float(raw.x))),
                fabsf(__uint_as_float(raw.y)));
    acc = fmaxf(fmaxf(acc, fabsf(__uint_as_float(raw.z))),
                fabsf(__uint_as_float(raw.w)));
  }
  static __device__ __forceinline__ float max_finish(Max acc) { return acc; }
  static __device__ __forceinline__ void unpack(float (&v)[4], uint4 raw) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
};

// Codes of kCount values, packed 4 to a word, stored at dst.
template <int kCount>
__device__ __forceinline__ void store_codes(unsigned char* dst,
                                            const float (&v)[kCount],
                                            float scale, float inv) {
  uint32_t words[kCount / 4];
#pragma unroll
  for (int w = 0; w < kCount / 4; ++w) {
    words[w] = quantize4(v + 4 * w, scale, inv);
  }
  if constexpr (kCount == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(words[0], words[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = words[0];
  }
}

// Shared memory of a block: up to 1 KB to reach a 1024-byte boundary, the
// code tiles (all of K, or two), the weight ring, x_scale.
inline int smem_bytes(int k, bool resident) {
  const int code_tiles = resident ? (k + kDepth - 1) / kDepth : 2;
  return 1024 + code_tiles * kTileA + kStages * kTileB +
         kRows * static_cast<int>(sizeof(float));
}

// One row group of the prologue: kLanes lanes to a row, 32 / kLanes rows of
// the warp at a time, starting at block row r_base. x_scale of each row
// over the full K and, with resident codes, the row quantized into the
// swizzled code tiles. kBatch 16-byte loads of a lane are started before the
// first is used. With kOnce a lane's chunks (q, q + kLanes, ...) all fit
// its registers and x is read once; otherwise once for the maximum and
// once more for the codes.
template <typename Tin, bool kResident, int kLanes, bool kOnce>
__device__ __forceinline__ void quantize_rows(
    const Tin* __restrict__ x, int m, int k, int row0, int r_base, int lane,
    int k_tiles, unsigned char* codes, float* row_scale) {
  using C = Chunk<Tin>;
  const int chunks = k / C::kCount;            // K is a multiple of 16
  const int padded_chunks = k_tiles * kDepth / C::kCount;
  const int r = r_base + lane / kLanes;
  const int q = lane % kLanes;
  const bool live = row0 + r < m;
  const Tin* x_row = x + static_cast<long long>(live ? row0 + r : 0) * k;
  auto load = [&](int c) {
    return live && c < chunks
               ? *reinterpret_cast<const uint4*>(x_row + c * C::kCount)
               : make_uint4(0u, 0u, 0u, 0u);
  };
  auto store = [&](int c, uint4 raw, float scale, float inv) {
    if (c >= padded_chunks) return;
    float v[C::kCount];
    C::unpack(v, raw);
    const int kb = c * C::kCount;              // the chunk's first k
    store_codes<C::kCount>(codes + (kb / kDepth) * kTileA +
                               swizzled_128(r, kb % kDepth),
                           v, scale, inv);
  };
  uint4 raw[kBatch];
  typename C::Max packed = C::max_init();
  for (int c0 = q; c0 < chunks; c0 += kLanes * kBatch) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) raw[u] = load(c0 + kLanes * u);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) C::max_update(packed, raw[u]);
  }
  float amax = C::max_finish(packed);
#pragma unroll
  for (int offset = 1; offset < kLanes; offset <<= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, offset));
  }
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (q == 0) row_scale[r] = scale;
  if constexpr (kResident) {
    const float inv = __frcp_rn(scale);
    if constexpr (kOnce) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        store(q + kLanes * u, raw[u], scale, inv);
      }
    } else {
      for (int c0 = q; c0 < padded_chunks; c0 += kLanes * kBatch) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) raw[u] = load(c0 + kLanes * u);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          store(c0 + kLanes * u, raw[u], scale, inv);
        }
      }
    }
  }
}

// 64 rows of x per block and two warpgroups, each taking 64 columns of every
// 128-column tile (m64n64k32). blockIdx.y is the row tile; blockIdx.x says
// which run of `tiles_per_block` column tiles of it the block takes.
template <typename Tin, typename Tout, bool kMish, bool kResident>
__global__ void __launch_bounds__(kThreads, 2) int8_dense_wgmma_kernel(
    const Tin* __restrict__ x, const int8_t* __restrict__ wqt,
    const float* __restrict__ wscale, const float* __restrict__ bias,
    Tout* __restrict__ out, int m, int n, int k, int tiles_per_block) {
  using C = Chunk<Tin>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The swizzle is a function of the address: tiles start on 1024 bytes.
  unsigned char* codes =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int k_tiles = (k + kDepth - 1) / kDepth;
  unsigned char* ring = codes + (kResident ? k_tiles : 2) * kTileA;
  float* row_scale = reinterpret_cast<float*>(ring + kStages * kTileB);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wg = tid / 128;
  const int g = lane >> 2, t = lane & 3;
  // This thread's accumulators: rows acc_row and acc_row + 8 of the block,
  // columns acc_col + 8 j + {0, 1} of the tile, j < 8.
  const int acc_row = (warp % 4) * 16 + g;
  const int acc_col = wg * 64 + 2 * t;

  const int row0 = blockIdx.y * kRows;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int tile_begin = blockIdx.x * tiles_per_block;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_block);
  const int steps = (tile_end - tile_begin) * k_tiles;
  if (steps <= 0) return;

  // The weight tile of step s (tile tile_begin + s / k_tiles, k tile
  // s % k_tiles) into ring stage s % kStages: 128 rows of the (N, K)
  // codes, 128 bytes each, chunk c of row r at c ^ (r % 8). Started ahead
  // of the prologue: the copies land while the block quantizes.
  auto load_weights = [&](int s) {
    const int col0 = (tile_begin + s / k_tiles) * kBN;
    const int k0 = (s % k_tiles) * kDepth;
    unsigned char* dst = ring + (s % kStages) * kTileB;
#pragma unroll
    for (int i = 0; i < kBN * 8 / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int r = id / 8, c = id % 8;
      const bool valid = col0 + r < n && k0 + c * 16 < k;
      const int8_t* src =
          wqt + (valid ? static_cast<long long>(col0 + r) * k + k0 + c * 16
                       : 0);
      cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), src, valid);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_weights(s);
    cp_async_commit();
  }

  // 1. x_scale and codes; each warp takes 8 rows.
  if (k / C::kCount <= 8 * kBatch) {
#pragma unroll 1
    for (int r = 0; r < 8; r += 4) {
      quantize_rows<Tin, kResident, 8, true>(x, m, k, row0, warp * 8 + r,
                                             lane, k_tiles, codes,
                                             row_scale);
    }
  } else {
    quantize_rows<Tin, kResident, 4, false>(x, m, k, row0, warp * 8, lane,
                                            k_tiles, codes, row_scale);
  }
  __syncthreads();

  // Streamed codes: 64 rows x 128 k of x per k tile, 32 consecutive k of
  // one row per thread, into code tile `stage` (the step's parity).
  auto quantize_tile = [&](int kt, int stage) {
    const int r = tid / 4;
    const int q_k = (tid % 4) * 32;
    const float scale = row_scale[r];
    const float inv = __frcp_rn(scale);
#pragma unroll
    for (int c = 0; c < 32 / C::kCount; ++c) {
      const int b = q_k + c * C::kCount;
      const int kk = kt * kDepth + b;
      float v[C::kCount];
      if (row0 + r < m && kk < k) {
        C::load(v, x + static_cast<long long>(row0 + r) * k + kk);
      } else {
#pragma unroll
        for (int i = 0; i < C::kCount; ++i) v[i] = 0.0f;
      }
      store_codes<C::kCount>(codes + stage * kTileA + swizzled_128(r, b), v,
                             scale, inv);
    }
  };
  if constexpr (!kResident) quantize_tile(0, 0);

  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  // w_scale and bias of this thread's columns, fetched when a tile starts
  // so that the epilogue does not wait for them.
  float col_scale[8][2], col_bias[8][2];

  for (int s = 0; s < steps; ++s) {
    const int kt = s % k_tiles;
    const int col0 = (tile_begin + s / k_tiles) * kBN + acc_col;
    if (kt == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + e;
          col_scale[j][e] = col < n ? wscale[col] : 0.0f;
          col_bias[j][e] = col < n ? bias[col] : 0.0f;
        }
      }
    }
    // This thread's copies of step s have landed, its warpgroup's
    // products of step s - 1 are done and its code stores are visible to
    // wgmma; after the barrier that holds for every thread, so step s may
    // be multiplied and the stages of step s - 1 refilled.
    cp_async_wait<kStages - 2>();
    wgmma_wait<0>();
    fence_proxy_async();
    __syncthreads();

    // Both operands K-major: 8-row groups 1024 bytes apart, a k step of
    // 32 codes 32 bytes further inside the 128-byte row.
    const unsigned char* a_tile =
        codes + (kResident ? kt : s % 2) * kTileA;
    const unsigned char* b_tile =
        ring + (s % kStages) * kTileB + wg * (64 * 128);
    wgmma_fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDepth / 32; ++ks) {
      wgmma_m64n64k32_s8(acc, wgmma_desc(a_tile + ks * 32, 16, 1024),
                         wgmma_desc(b_tile + ks * 32, 16, 1024),
                         kt != 0 || ks != 0);
    }
    wgmma_commit();
    wgmma_fence_acc(acc);

    if (s + kStages - 1 < steps) load_weights(s + kStages - 1);
    cp_async_commit();
    if constexpr (!kResident) {
      if (s + 1 < steps) quantize_tile((s + 1) % k_tiles, (s + 1) % 2);
    }

    if (kt == k_tiles - 1) {
      // 2. Epilogue of this tile: rescale, bias, optional mish, cast.
      wgmma_wait<0>();
      wgmma_fence_acc(acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + 8 * j;
        if (col >= n) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = acc_row + 8 * h;
          if (row0 + r >= m) continue;
          const float xs = row_scale[r];
          float y0 = rescale(acc[4 * j + 2 * h], xs, col_scale[j][0],
                             col_bias[j][0]);
          float y1 = rescale(acc[4 * j + 2 * h + 1], xs, col_scale[j][1],
                             col_bias[j][1]);
          if (kMish) {
            y0 = mish(y0);
            y1 = mish(y1);
          }
          store_out(out, row0 + r, col, n, y0, y1);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

enum Instance { kGuarded = 0, kResidentCodes = 1, kStreamedCodes = 2 };

// How many of a row tile's column tiles one block takes: the count that
// makes the estimated time least, in units of one tile's products. A block
// pays about `prologue` such units for the maxima and codes of its rows,
// then one per tile; blocks run in waves of `slots`. Few tiles per block
// repeat the prologue; many leave the last wave nearly empty. (One wave of
// blocks that each take an even share of all tiles measured slower: every
// block's prologue then runs at the start, under no other block's
// products.)
inline int tiles_per_block(int row_tiles, int n_tiles, int slots,
                           int prologue) {
  int best = n_tiles;
  long long best_cost = -1;
  for (int per = n_tiles; per >= 1; --per) {
    const int splits = (n_tiles + per - 1) / per;
    const long long blocks = static_cast<long long>(row_tiles) * splits;
    const long long waves = (blocks + slots - 1) / slots;
    const long long cost = waves * (prologue + per);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = per;
    }
  }
  return best;
}

template <typename Tin, typename Tout, bool kMish, bool kResident>
cudaError_t launch_wgmma(const Tin* x, const int8_t* wqt, const float* wscale,
                         const float* bias, Tout* out, int m, int n, int k,
                         cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  auto kernel = int8_dense_wgmma_kernel<Tin, Tout, kMish, kResident>;
  // Codes may take all a block can have; the limit is raised to that once.
  cudaError_t err = allow_dynamic_smem(kernel, kMaxSmem, done);
  if (err != cudaSuccess) return err;
  const int smem = smem_bytes(k, kResident);
  const int row_tiles = (m + kRows - 1) / kRows;
  const int n_tiles = (n + kBN - 1) / kBN;
  // Two blocks per SM where their shared memory allows (1 KB of each block
  // is the system's).
  const int per_sm = max(1, min(2, (kMaxSmem + 1024) / (smem + 1024)));
  const int per = tiles_per_block(row_tiles, n_tiles, per_sm * sm_count(),
                                  kResident ? 2 : 1);
  const dim3 grid((n_tiles + per - 1) / per, row_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(x, wqt, wscale, bias, out, m, n, k,
                                           per);
  return cudaSuccess;
}

template <typename Tin, typename Tout, bool kMish>
cudaError_t launch(int instance, const Tin* x, const int8_t* wq,
                   const int8_t* wqt, const float* wscale, const float* bias,
                   Tout* out, int m, int n, int k, cudaStream_t stream) {
  if (instance == kResidentCodes) {
    return launch_wgmma<Tin, Tout, kMish, true>(x, wqt, wscale, bias, out, m,
                                                n, k, stream);
  }
  if (instance == kStreamedCodes) {
    return launch_wgmma<Tin, Tout, kMish, false>(x, wqt, wscale, bias, out, m,
                                                 n, k, stream);
  }
  const dim3 grid((n + kBlockN - 1) / kBlockN, (m + kBlockM - 1) / kBlockM);
  int8_dense_kernel<Tin, Tout, kMish>
      <<<grid, kThreads, 0, stream>>>(x, wq, wscale, bias, out, m, n, k);
  return cudaSuccess;
}

template <typename Tin, typename Tout>
cudaError_t launch_mish(int instance, bool apply_mish, const void* x,
                        const int8_t* wq, const int8_t* wqt,
                        const float* wscale, const float* bias, void* out,
                        int m, int n, int k, cudaStream_t stream) {
  const Tin* xt = static_cast<const Tin*>(x);
  Tout* ot = static_cast<Tout*>(out);
  if (apply_mish) {
    return launch<Tin, Tout, true>(instance, xt, wq, wqt, wscale, bias, ot, m,
                                   n, k, stream);
  }
  return launch<Tin, Tout, false>(instance, xt, wq, wqt, wscale, bias, ot, m,
                                  n, k, stream);
}

}  // namespace

extern "C" {

// The plan's query: writes into a->instance the instance that calls of this
// block run (0 guarded, 1 resident, 2 streamed), from K, a->request (0 by
// shape, 1 guarded, 2 codes resident, 3 codes streamed) and a->aligned16.
// The tensor-core instances need the (N, K) codes, K a multiple of 16 and x
// and the codes on 16-byte boundaries; a request that the shape cannot take
// is an error (cudaErrorInvalidValue). Launches nothing; 0 on success.
int vtd_int8_dense_plan(Int8DenseArgs* a) {
  if (a->request < 0 || a->request > 3 || a->x_dtype < 0 || a->x_dtype > 1 ||
      a->out_dtype < 0 || a->out_dtype > 1) {
    return cudaErrorInvalidValue;
  }
  const bool aligned = a->aligned16 != 0 && a->k % 16 == 0;
  const bool fits = smem_bytes(a->k, true) <= kMaxSmem;
  if (a->request >= 2 && !aligned) return cudaErrorInvalidValue;
  if (a->request == 2 && !fits) return cudaErrorInvalidValue;
  if (a->request == 1 || !aligned) {
    a->instance = kGuarded;
  } else if (a->request == 0) {
    a->instance = fits ? kResidentCodes : kStreamedCodes;
  } else {
    a->instance = a->request == 2 ? kResidentCodes : kStreamedCodes;
  }
  return cudaSuccess;
}

// One launch of a->instance from the plan's block `a` (launch_common.cuh's
// Int8DenseArgs) and the call's device addresses and stream, on a->device.
// x: contiguous (m, k) in a->x_dtype; wq: contiguous int8 (k, n); wqt: its
// transpose, contiguous int8 (n, k), or null (the guarded instance reads
// wq, the tensor-core ones wqt); wscale and bias: contiguous fp32 (n,); out:
// contiguous (m, n) in a->out_dtype. Dtypes: 0 = float32, 1 = bfloat16.
// Returns the first CUDA error of the launch (0 on success).
int vtd_int8_dense(const Int8DenseArgs* a, const void* x, const void* wq,
                   const void* wqt, const void* wscale, const void* bias,
                   void* out, void* stream) {
  const int m = a->m, n = a->n, k = a->k, instance = a->instance;
  if (m <= 0 || n <= 0 || k <= 0 || a->x_dtype < 0 || a->x_dtype > 1 ||
      a->out_dtype < 0 || a->out_dtype > 1) {
    return cudaErrorInvalidValue;
  }
  const int8_t* w = static_cast<const int8_t*>(wq);
  const int8_t* wt = static_cast<const int8_t*>(wqt);
  // The plan chose a tensor-core instance for 16-byte-aligned operands.
  if (instance == kGuarded ? w == nullptr
                           : wt == nullptr || !aligned16(x) ||
                                 !aligned16(wt)) {
    return cudaErrorInvalidValue;
  }
  const DeviceScope scope(a->device);
  if (scope.error() != cudaSuccess) return scope.error();
  const float* s = static_cast<const float*>(wscale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mish_on = a->apply_mish != 0;
  cudaError_t err;
  if (a->x_dtype == 0 && a->out_dtype == 0) {
    err = launch_mish<float, float>(instance, mish_on, x, w, wt, s, b, out, m,
                                    n, k, st);
  } else if (a->x_dtype == 0) {
    err = launch_mish<float, __nv_bfloat16>(instance, mish_on, x, w, wt, s, b,
                                            out, m, n, k, st);
  } else if (a->out_dtype == 0) {
    err = launch_mish<__nv_bfloat16, float>(instance, mish_on, x, w, wt, s, b,
                                            out, m, n, k, st);
  } else {
    err = launch_mish<__nv_bfloat16, __nv_bfloat16>(instance, mish_on, x, w,
                                                    wt, s, b, out, m, n, k,
                                                    st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
