// Flash-attention backward for Hopper (sm_90a) on the tensor cores, bound to
// Python through a plain C interface (kernels/flash_attention.py loads it
// with ctypes).
//
// Replaces the Pallas TPU kernel `_fused_bwd_kernel` in
// vision_transformer_detector_tpu/kernels/flash_attention.py (launched by
// `_flash_bwd_pallas`), and with it the default XLA recomputation
// `_flash_bwd_chunked` (rate=None), whose math is the same. From q, k, v,
// the output cotangent g, the forward's fp32 logsumexp lse and
// delta = rowsum(g * out) (computed by the wrapper in fp32) it forms
//   p  = exp(q k^T - lse)            (fp32; the N x N tile stays on chip)
//   dv = p^T g                        (p rounded to the input type first)
//   ds = p * (g v^T - delta)          (fp32, then rounded to the input type)
//   dk = ds^T q,   dq = ds k
// with fp32 accumulation, as the Pallas kernel does. With dropout on, it is
// the gradient of `_flash_bwd_chunked`'s dropout branch in the same single
// pass: each score regenerates the forward's keep mask from the global
// (batch*head, query, key) indices (dropout_mask.cuh), and with
// scale = keep / (1 - rate)
//   dv = (scale * p)^T g              (rounded to the input type first)
//   ds = p * (scale * (g v^T) - delta)
// where delta = rowsum(g * out) of the DROPPED output, which equals
// rowsum(p * scale * (g v^T)), the chunked backward's correction.
//
// What bounds it (one H100 SXM: 989 TFLOP/s bf16, 495 TF32, 3.35 TB/s):
//   * highres_1024 training, (B*H, N, K) = (2048, 256, 64) bf16, with or
//     without the dropout replay: five products, 10 * 2048 * 256^2 * 64 =
//     85.9 GFLOP, on 541 MB (q, k, v, g read and dk, dv written in bf16, dq
//     written and lse, delta read in fp32), 159 FLOP per byte: below the
//     bf16 ridge (about 295), bound by bytes at 0.162 ms;
//   * reference_608 training, (64, 1296, 40) fp32: 43.0 GFLOP (K = 40) on
//     94 MB, done as 3xTF32: bound by operations at 3 * 43.0 G / 495 T =
//     0.26 ms.
// On the split route the dq kernel recomputes S and dP, so the backward
// does seven products where the function needs the five counted above. As
// in the forward, it is held by the latency of the chain between its
// products (exp, the mask replay, the casts), not by bytes or the tensor
// cores: chip_smoke.py times it beside its bound on the card (PERF.md).
//
// dq is the same on every run, as the Pallas kernel's is: its grid walks
// the key blocks in order into a dq block that stays resident
// (_fused_bwd_kernel zeroes it at the first key block and adds each
// block's dS K), so dq = ((c0 + c1) + c2) + ... in key order. Here the sum
// runs in key order too, by one of two routes (the
// wrapper picks one by dtype, kernels/flash_attention.py:dq_route):
//   * split (bf16): flash_bwd_kernel does the dk/dv work of one
//     (batch*head, 64-key tile), then flash_bwd_dq_kernel the dq work of
//     one (batch*head, 64-query tile), walking the key tiles in order and
//     recomputing S and dP;
//   * partials (fp32, where each recomputed product costs three TF32
//     ones): flash_bwd_kernel also forms each query tile's dq
//     contribution dS K (dS^T through a shared tile) and stores it with
//     plain float4 stores into a (tiles, batch*head, N, D) fp32 workspace;
//     flash_bwd_dq_sum_kernel then adds the tiles in key order.
// No atomics: their order would change from run to run.
//
// Design (FA2's backward, for this card):
//   * each kernel runs (batch*head) * tiles CTAs of 4 warps, 64 queries or
//     keys per tile;
//   * dk/dv block: each warp owns 16 keys. K and V are loaded once into
//     shared memory in the input type; dk and dv accumulate in registers
//     (mma accumulator layout) for the whole loop;
//   * the CTA loops over 64-query tiles; q, g, lse and delta are
//     double-buffered by cp.async (16-byte copies for q and g, 4-byte for
//     the fp32 lse/delta rows, which need not be aligned);
//   * key-major products, so that each accumulator is the next product's A
//     fragment with no shuffle: S^T = K Q^T and dP^T = V g^T (mma, fp32
//     accumulation); P^T = exp(S^T - lse), one exp per owned score, masked
//     for queries and keys past N; dV += (scale * P^T, cast to the input
//     type) g; dS^T = P^T * (scale * dP^T - delta), cast to the input type;
//     dK += dS^T Q. The mask is replayed by the owning lane, once per score;
//   * dq block: each warp owns 16 queries; q and g stay in shared memory,
//     lse and delta in registers, and the K and V tiles are double-buffered
//     by cp.async in key order. Per key tile: S = Q K^T and dP = g V^T,
//     dS = P * (scale * dP - delta) with the same mask replay, and dq +=
//     dS K (dS cast to the input type, as in the dk/dv block); dq is
//     written once, with plain fp32 stores, so the caller need not zero it;
//   * fp32 runs the same code on TF32 with the 3xTF32 split of every
//     operand (mma_sm90.cuh); head dim 48, 64 or 128 as in the forward.
//     The 128 instances keep the 64-row tiles and 4 warps: the dk/dv kernel
//     takes each query tile 32 (bf16) or 16 (fp32) queries at a time and
//     the dq kernel each key tile as many keys at a time (sub_tile), so S
//     and dP fit beside the accumulators, and the partials route forms dq's
//     contribution 64 columns at a time;
//   * dk and dv are cast to the input type (or, for a ring attention
//     block, kept in fp32: the output type is a template parameter) and
//     stored through the caller's strides; keys past N are never written,
//     queries past N never touch dq.
// Budget: shared memory, the dk/dv kernel's K, V, two q and two g tiles of
// 64 x (D + 16 bytes) and two lse and two delta rows: bf16 44,032 (48),
// 56,320 (64), 105,472 (128); fp32 80,896 (48), 105,472 (64), 203,776
// (128); on the partials route the dS^T tile of 64 x (64 + 16 bytes) more
// (221,184 at fp32 128, under the 232,448 a CTA may take); the dq
// kernel's q, g and two K and two V tiles, 1,024 bytes less than the dk/dv
// kernel's; dynamic, with cudaFuncAttributeMaxDynamicSharedMemorySize
// raised once per device. Registers (-Xptxas -v, sm_90a, CUDA 12.8, on the
// NVIDIA H100 80GB HBM3's machine), without / with dropout: bf16 dk/dv
// 175 / 243 (48), 213 / 255 (64), 255 / 255 (128, spilling 16 / 20
// bytes), bf16 dq 157 / 186, 165 / 242, 253 / 255 (8 bytes with
// dropout); every fp32 kernel uses 255 and spills 8-104 bytes (the 128
// dk/dv kernel 56 / 52, its partials variant 72 / 104, its dq kernel 24 /
// 16). chip_smoke.py's build phase prints each instance's registers and
// spills and its HMMA count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "dropout_mask.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kBlock = 64;            // keys per CTA and queries per tile
constexpr int kThreads = 128;         // 4 warps of 16 keys
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, n;
};

template <typename T>
constexpr int smem_dq_bytes(int d) {
  return 6 * kBlock * (d + Mma<T>::kPad) * static_cast<int>(sizeof(T));
}

// The dk/dv kernel's; with kPartials also the dS^T tile of 64 x (64 + pad).
template <typename T, bool kPartials>
constexpr int smem_bytes(int d) {
  return smem_dq_bytes<T>(d) + 4 * kBlock * static_cast<int>(sizeof(float)) +
         (kPartials ? kBlock * (kBlock + Mma<T>::kPad) *
                          static_cast<int>(sizeof(T))
                    : 0);
}

// Queries (dk/dv kernel) or keys (dq kernel) taken per step of a 64-row
// tile: all 64 at head dims up to 64; at 128, where the kernel's own
// accumulators (dk and dv, or dq) hold D / 2 registers each for the whole
// loop, 32 in bf16 and 16 in fp32 (whose 3xTF32 fragments are twice as
// wide), so that S and dP (kSub / 2 registers each) fit beside them. The
// steps are a loop the compiler does not unroll: unrolled, it hoisted the
// next step's fragments, and the fp32 instances spilled heavily and built
// slowly.
template <typename T, int D>
__host__ __device__ constexpr int sub_tile() {
  return D <= 64 ? kBlock : (sizeof(T) == 2 ? 32 : 16);
}

// The 64 fp32 values of rows row0..row0+63 of a contiguous (seq_len,) row,
// zero past seq_len; threads 0..63 load lse, 64..127 delta.
__device__ __forceinline__ void load_rows_async(float* lse_dst,
                                                float* delta_dst,
                                                const float* lse_src,
                                                const float* delta_src,
                                                int row0, int seq_len,
                                                int tid) {
  const int i = tid & (kBlock - 1);
  const int row = row0 + i;
  const bool valid = row < seq_len;
  const float* src = (tid < kBlock ? lse_src : delta_src) + (valid ? row : 0);
  cp_async4((tid < kBlock ? lse_dst : delta_dst) + i, src, valid);
}

// dk and dv: block blockIdx.x is key tile blockIdx.x % tiles of batch*head
// blockIdx.x / tiles. With kPartials it also writes this key tile's dq
// contribution dS K for every query into partials, laid out (tiles,
// batch*head, seq_len, D), for flash_bwd_dq_sum_kernel.
template <typename T, int D, bool kDropout, bool kPartials, typename O>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, O* __restrict__ dk,
                 O* __restrict__ dv, float* __restrict__ partials, int heads,
                 int seq_len, int tiles, Strides sq, Strides sk, Strides sv,
                 Strides sg, Strides sdk, Strides sdv, Dropout drop) {
  using M = Mma<T>;
  constexpr int kLd = D + M::kPad;
  constexpr int kTile = kBlock * kLd;
  constexpr int kLdS = kBlock + M::kPad;   // dS^T rows: [key][query]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kTile;
  T* q_s = v_s + kTile;          // two buffers
  T* g_s = q_s + 2 * kTile;      // two buffers
  float* lse_s = reinterpret_cast<float*>(g_s + 2 * kTile);   // two
  float* delta_s = lse_s + 2 * kBlock;                         // two
  T* ds_s = reinterpret_cast<T*>(delta_s + 2 * kBlock);        // kPartials

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;   // the fragment's row group g
  const int t = lane & 3;
  // Key tiles of one (batch, head) are neighbours in launch order, so its
  // q and g are read from device memory once and from L2 after that.
  const int bh = blockIdx.x / tiles;
  const int kv0 = (blockIdx.x % tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const T* q_bh = q + b * sq.b + h * sq.h;
  const T* g_bh = g + b * sg.b + h * sg.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * seq_len;
  const float* delta_bh = delta + static_cast<long long>(bh) * seq_len;

  load_tile_async<T, D, kBlock, kThreads>(k_s, k + b * sk.b + h * sk.h, sk.n,
                                          kv0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(v_s, v + b * sv.b + h * sv.h, sv.n,
                                          kv0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(q_s, q_bh, sq.n, 0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(g_s, g_bh, sg.n, 0, seq_len, tid);
  load_rows_async(lse_s, delta_s, lse_bh, delta_bh, 0, seq_len, tid);
  cp_async_commit();

  // This lane's keys: kv0 + 16 * warp + gr (r = 0) and + 8 (r = 1).
  bool key_ok[2];
  unsigned int hash_key[2] = {0u, 0u};
  const unsigned int seed = kDropout ? load_seed(drop) : 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kv0 + 16 * warp + gr + 8 * r;
    key_ok[r] = key < seq_len;
    if (kDropout) {
      hash_key[r] = hash_part(drop, seed, global_row(drop, bh)) +
                    key_term(drop, static_cast<unsigned int>(key));
    }
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }
  }

  for (int it = 0; it < tiles; ++it) {
    const int q0 = it * kBlock;
    const int buf = it & 1;
    if (it + 1 < tiles) {
      // Into the other buffers, which every warp finished reading before
      // the previous iteration's closing barrier.
      const int nb = buf ^ 1;
      load_tile_async<T, D, kBlock, kThreads>(q_s + nb * kTile, q_bh, sq.n,
                                              q0 + kBlock, seq_len, tid);
      load_tile_async<T, D, kBlock, kThreads>(g_s + nb * kTile, g_bh, sg.n,
                                              q0 + kBlock, seq_len, tid);
      load_rows_async(lse_s + nb * kBlock, delta_s + nb * kBlock, lse_bh,
                      delta_bh, q0 + kBlock, seq_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* q_t = q_s + buf * kTile;
    const T* g_t = g_s + buf * kTile;
    const float* lse_t = lse_s + buf * kBlock;
    const float* delta_t = delta_s + buf * kBlock;

    // S^T = K Q^T and dP^T = V g^T: 16 keys x kSub queries per warp, for
    // the kSub queries from s0.
    constexpr int kSub = sub_tile<T, D>();
#pragma unroll 1
    for (int s0 = 0; s0 < kBlock; s0 += kSub) {
      float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        typename M::A ka, va;
        M::load_a(ka, k_s, kLd, 16 * warp, 16 * kc, lane);
        M::load_a(va, v_s, kLd, 16 * warp, 16 * kc, lane);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          typename M::B b0, b1;
          M::load_b_nk(b0, b1, q_t, kLd, s0 + 16 * np, 16 * kc, lane);
          M::mma(s[2 * np], ka, b0);
          M::mma(s[2 * np + 1], ka, b1);
          M::load_b_nk(b0, b1, g_t, kLd, s0 + 16 * np, 16 * kc, lane);
          M::mma(dp[2 * np], va, b0);
          M::mma(dp[2 * np + 1], va, b1);
        }
      }

      // P^T (scaled by the replayed mask) into s, dS^T into dp: rows are
      // keys (e >> 1), columns queries s0 + 8j + 2t + (e & 1).
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = s0 + 8 * j + 2 * t + (e & 1);
          const int query = q0 + col;
          const float p =
              key_ok[r] && query < seq_len
                  ? exp2f(fmaf(s[j][e], kLog2e, -lse_t[col] * kLog2e))
                  : 0.f;
          float scale = 1.f;
          if (kDropout) {
            scale = keep(drop, hash_key[r] +
                                   query_term(drop,
                                              static_cast<unsigned int>(
                                                  query)))
                        ? drop.inv_keep
                        : 0.f;
          }
          s[j][e] = p * scale;
          dp[j][e] = p * (dp[j][e] * scale - delta_t[col]);
        }
      }

      // dV += P^T g and dK += dS^T Q, each A fragment rounded to the input
      // type.
      add_acc_kn<T, kSub, D>(dv_acc, s, g_t + s0 * kLd, kLd, lane);
      add_acc_kn<T, kSub, D>(dk_acc, dp, q_t + s0 * kLd, kLd, lane);
      if constexpr (kPartials) {
        // dS^T (rounded) into shared memory, for the dq contribution.
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            store_pair(ds_s + (16 * warp + gr + 8 * r) * kLdS + s0 + 8 * j +
                           2 * t,
                       dp[j][2 * r], dp[j][2 * r + 1]);
          }
        }
      }
    }
    if constexpr (kPartials) {
      // Each warp forms 16 query rows of this key tile's dq contribution
      // dS K, col_pass<D>() columns at a time, and stores them.
      __syncthreads();
      constexpr int kCols = col_pass<D>();
#pragma unroll
      for (int c = 0; c < D / kCols; ++c) {
        float dq_acc[kCols / 8][4];
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
        }
#pragma unroll
        for (int kc = 0; kc < kBlock / 16; ++kc) {
          typename M::A a;
          M::load_a_t(a, ds_s, kLdS, 16 * kc, 16 * warp, lane);
#pragma unroll
          for (int np = 0; np < kCols / 16; ++np) {
            typename M::B b0, b1;
            M::load_b_kn(b0, b1, k_s, kLd, 16 * kc, kCols * c + 16 * np,
                         lane);
            M::mma(dq_acc[2 * np], a, b0);
            M::mma(dq_acc[2 * np + 1], a, b1);
          }
        }
        // Lanes t and t ^ 1 swap halves, so each stores four adjacent
        // values of one row: an even lane row gr, columns 8j + 2t .. + 3;
        // an odd lane row gr + 8, columns 8j + 2(t - 1) .. + 3.
        const bool odd = t & 1;
        const int row = q0 + 16 * warp + gr + (odd ? 8 : 0);
        float* dq_row =
            partials +
            ((static_cast<long long>(blockIdx.x % tiles) *
                  (gridDim.x / tiles) +
              bh) * seq_len + row) * D +
            kCols * c + 2 * (t & ~1);
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          const float x0 = odd ? dq_acc[j][0] : dq_acc[j][2];
          const float x1 = odd ? dq_acc[j][1] : dq_acc[j][3];
          const float r0 = __shfl_xor_sync(0xffffffffu, x0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, x1, 1);
          if (row < seq_len) {
            *reinterpret_cast<float4*>(dq_row + 8 * j) =
                odd ? make_float4(r0, r1, dq_acc[j][2], dq_acc[j][3])
                    : make_float4(dq_acc[j][0], dq_acc[j][1], r0, r1);
          }
        }
      }
    }
    __syncthreads();
  }

  O* dk_bh = dk + b * sdk.b + h * sdk.h;
  O* dv_bh = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kv0 + 16 * warp + gr + 8 * r;
    if (!key_ok[r]) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_pair(dk_bh + key * sdk.n + 8 * j + 2 * t, dk_acc[j][2 * r],
                 dk_acc[j][2 * r + 1]);
      store_pair(dv_bh + key * sdv.n + 8 * j + 2 * t, dv_acc[j][2 * r],
                 dv_acc[j][2 * r + 1]);
    }
  }
}

// dq: block blockIdx.x is query tile blockIdx.x % tiles of batch*head
// blockIdx.x / tiles; the key tiles in order, dq = ((c0 + c1) + c2) + ...
// in registers.
template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int heads, int seq_len, int tiles, Strides sq,
                    Strides sk, Strides sv, Strides sg, Strides sdq,
                    Dropout drop) {
  using M = Mma<T>;
  constexpr int kLd = D + M::kPad;
  constexpr int kTile = kBlock * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* g_s = q_s + kTile;
  T* k_s = g_s + kTile;           // two buffers
  T* v_s = k_s + 2 * kTile;       // two buffers

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const T* k_bh = k + b * sk.b + h * sk.h;
  const T* v_bh = v + b * sv.b + h * sv.h;

  load_tile_async<T, D, kBlock, kThreads>(q_s, q + b * sq.b + h * sq.h, sq.n,
                                          q0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(g_s, g + b * sg.b + h * sg.h, sg.n,
                                          q0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(k_s, k_bh, sk.n, 0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(v_s, v_bh, sv.n, 0, seq_len, tid);
  cp_async_commit();

  // This lane's queries: q0 + 16 * warp + gr (r = 0) and + 8 (r = 1).
  bool query_ok[2];
  float lse_r[2], delta_r[2];
  unsigned int hash_query[2] = {0u, 0u};
  const unsigned int seed = kDropout ? load_seed(drop) : 0u;
  const long long rows = static_cast<long long>(bh) * seq_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int query = q0 + 16 * warp + gr + 8 * r;
    query_ok[r] = query < seq_len;
    lse_r[r] = query_ok[r] ? lse[rows + query] * kLog2e : 0.f;
    delta_r[r] = query_ok[r] ? delta[rows + query] : 0.f;
    if (kDropout) {
      hash_query[r] =
          hash_part(drop, seed, global_row(drop, bh)) +
          query_term(drop, static_cast<unsigned int>(query));
    }
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    const int kv0 = it * kBlock;
    const int buf = it & 1;
    if (it + 1 < tiles) {
      // Into the other buffers, which every warp finished reading before
      // the previous iteration's closing barrier.
      const int nb = buf ^ 1;
      load_tile_async<T, D, kBlock, kThreads>(k_s + nb * kTile, k_bh, sk.n,
                                              kv0 + kBlock, seq_len, tid);
      load_tile_async<T, D, kBlock, kThreads>(v_s + nb * kTile, v_bh, sv.n,
                                              kv0 + kBlock, seq_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* k_t = k_s + buf * kTile;
    const T* v_t = v_s + buf * kTile;

    // S = Q K^T and dP = g V^T: 16 queries x kSub keys per warp, for the
    // kSub keys from s0.
    constexpr int kSub = sub_tile<T, D>();
#pragma unroll 1
    for (int s0 = 0; s0 < kBlock; s0 += kSub) {
      float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        typename M::A qa, ga;
        M::load_a(qa, q_s, kLd, 16 * warp, 16 * kc, lane);
        M::load_a(ga, g_s, kLd, 16 * warp, 16 * kc, lane);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          typename M::B b0, b1;
          M::load_b_nk(b0, b1, k_t, kLd, s0 + 16 * np, 16 * kc, lane);
          M::mma(s[2 * np], qa, b0);
          M::mma(s[2 * np + 1], qa, b1);
          M::load_b_nk(b0, b1, v_t, kLd, s0 + 16 * np, 16 * kc, lane);
          M::mma(dp[2 * np], ga, b0);
          M::mma(dp[2 * np + 1], ga, b1);
        }
      }

      // dS into dp: rows are queries (e >> 1), columns keys kv0 + s0 + 8j
      // + 2t + (e & 1).
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = kv0 + s0 + 8 * j + 2 * t + (e & 1);
          const float p =
              query_ok[r] && key < seq_len
                  ? exp2f(fmaf(s[j][e], kLog2e, -lse_r[r]))
                  : 0.f;
          float scale = 1.f;
          if (kDropout) {
            scale = keep(drop, hash_query[r] +
                                   key_term(drop,
                                            static_cast<unsigned int>(key)))
                        ? drop.inv_keep
                        : 0.f;
          }
          dp[j][e] = p * (dp[j][e] * scale - delta_r[r]);
        }
      }
      // dq += dS K, dS rounded to the input type.
      add_acc_kn<T, kSub, D>(dq_acc, dp, k_t + s0 * kLd, kLd, lane);
    }
    __syncthreads();
  }

  float* dq_bh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int query = q0 + 16 * warp + gr + 8 * r;
    if (!query_ok[r]) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_pair(dq_bh + query * sdq.n + 8 * j + 2 * t, dq_acc[j][2 * r],
                 dq_acc[j][2 * r + 1]);
    }
  }
}

// dq from flash_bwd_kernel's partials: thread i sums four adjacent
// columns of one (batch*head, query) row over the key tiles in order,
// dq = ((c0 + c1) + c2) + ..., and stores them through dq's strides.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_sum_kernel(const float* __restrict__ partials,
                        float* __restrict__ dq, int heads, int seq_len,
                        int tiles, long long rows, Strides sdq) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= rows * (D / 4)) return;
  const long long row = i / (D / 4);   // bh * seq_len + query
  const int col = 4 * static_cast<int>(i % (D / 4));
  const float4* src =
      reinterpret_cast<const float4*>(partials + row * D + col);
  const long long tile_stride = rows * (D / 4);
  float4 acc = src[0];
  for (int j = 1; j < tiles; ++j) {
    const float4 c = src[j * tile_stride];
    acc.x += c.x;
    acc.y += c.y;
    acc.z += c.z;
    acc.w += c.w;
  }
  const int bh = static_cast<int>(row / seq_len);
  const int query = static_cast<int>(row % seq_len);
  *reinterpret_cast<float4*>(dq + (bh / heads) * sdq.b +
                             (bh % heads) * sdq.h + query * sdq.n + col) =
      acc;
}

template <typename T, int D, bool kDropout, typename O>
cudaError_t launch_kernel(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dq, void* dk, void* dv, void* partials,
                          int batch, int heads, int seq_len, Strides sq,
                          Strides sk, Strides sv, Strides sg, Strides sdq,
                          Strides sdk, Strides sdv, Dropout drop,
                          cudaStream_t stream) {
  const int tiles = (seq_len + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(batch) * heads * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  cudaError_t err;
  if (partials != nullptr) {
    // fp32 only (the wrapper's choice): the dk/dv kernel stores each key
    // tile's dq contribution, then the sum kernel adds them in key order.
    if constexpr (std::is_same<T, float>::value) {
      constexpr int kSmem = smem_bytes<T, true>(D);
      static std::atomic<unsigned long long> smem_allowed{0};
      err = allow_dynamic_smem(flash_bwd_kernel<T, D, kDropout, true, T>,
                               kSmem, smem_allowed);
      if (err != cudaSuccess) return err;
      float* part = static_cast<float*>(partials);
      flash_bwd_kernel<T, D, kDropout, true, T>
          <<<static_cast<unsigned int>(blocks), kThreads, kSmem, stream>>>(
              qt, kt, vt, gt, lse_f, delta_f, static_cast<T*>(dk),
              static_cast<T*>(dv), part, heads, seq_len, tiles, sq, sk, sv,
              sg, sdk, sdv, drop);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      const long long rows = static_cast<long long>(batch) * heads * seq_len;
      const long long sum_blocks = (rows * (D / 4) + 255) / 256;
      if (sum_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
      flash_bwd_dq_sum_kernel<D>
          <<<static_cast<unsigned int>(sum_blocks), 256, 0, stream>>>(
              part, static_cast<float*>(dq), heads, seq_len, tiles, rows,
              sdq);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  }
  constexpr int kSmem = smem_bytes<T, false>(D);
  constexpr int kSmemDq = smem_dq_bytes<T>(D);
  static std::atomic<unsigned long long> smem_allowed{0}, smem_dq_allowed{0};
  err = allow_dynamic_smem(flash_bwd_kernel<T, D, kDropout, false, O>, kSmem,
                           smem_allowed);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(flash_bwd_dq_kernel<T, D, kDropout>, kSmemDq,
                           smem_dq_allowed);
  if (err != cudaSuccess) return err;
  flash_bwd_kernel<T, D, kDropout, false, O>
      <<<static_cast<unsigned int>(blocks), kThreads, kSmem, stream>>>(
          qt, kt, vt, gt, lse_f, delta_f, static_cast<O*>(dk),
          static_cast<O*>(dv), nullptr, heads, seq_len, tiles, sq, sk, sv, sg,
          sdk, sdv, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D, kDropout>
      <<<static_cast<unsigned int>(blocks), kThreads, kSmemDq, stream>>>(
          qt, kt, vt, gt, lse_f, delta_f, static_cast<float*>(dq), heads,
          seq_len, tiles, sq, sk, sv, sg, sdq, drop);
  return cudaGetLastError();
}

template <typename T, int D, typename O>
cudaError_t launch_dim(bool dropout, const void* q, const void* k,
                       const void* v, const void* g, const void* lse,
                       const void* delta, void* dq, void* dk, void* dv,
                       void* partials, int batch, int heads, int seq_len,
                       Strides sq, Strides sk, Strides sv, Strides sg,
                       Strides sdq, Strides sdk, Strides sdv, Dropout drop,
                       cudaStream_t stream) {
  if (dropout) {
    return launch_kernel<T, D, true, O>(q, k, v, g, lse, delta, dq, dk, dv,
                                     partials, batch, heads, seq_len, sq, sk,
                                     sv, sg, sdq, sdk, sdv, drop, stream);
  }
  return launch_kernel<T, D, false, O>(q, k, v, g, lse, delta, dq, dk, dv,
                                    partials, batch, heads, seq_len, sq, sk,
                                    sv, sg, sdq, sdk, sdv, drop, stream);
}

template <typename T, typename O>
cudaError_t launch(int head_dim, bool dropout, const void* q, const void* k,
                   const void* v, const void* g, const void* lse,
                   const void* delta, void* dq, void* dk, void* dv,
                   void* partials, int batch, int heads, int seq_len,
                   Strides sq, Strides sk, Strides sv, Strides sg,
                   Strides sdq, Strides sdk, Strides sdv, Dropout drop,
                   cudaStream_t stream) {
  if (head_dim == 48) {
    return launch_dim<T, 48, O>(dropout, q, k, v, g, lse, delta, dq, dk, dv,
                             partials, batch, heads, seq_len, sq, sk, sv, sg,
                             sdq, sdk, sdv, drop, stream);
  }
  if (head_dim == 64) {
    return launch_dim<T, 64, O>(dropout, q, k, v, g, lse, delta, dq, dk, dv,
                             partials, batch, heads, seq_len, sq, sk, sv, sg,
                             sdq, sdk, sdv, drop, stream);
  }
  if (head_dim == 128) {
    return launch_dim<T, 128, O>(dropout, q, k, v, g, lse, delta, dq, dk, dv,
                              partials, batch, heads, seq_len, sq, sk, sv, sg,
                              sdq, sdk, sdv, drop, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, and dk, dv unless
// dkv_fp32, which writes them in fp32: a ring attention block's dk and dv
// join fp32 sums unrounded); dq is fp32, every
// element written by the kernels; lse and delta are contiguous fp32 (batch,
// heads, seq_len). dq_partials: null for the split route, or, in fp32
// only, a (tiles, batch * heads, seq_len, head_dim) fp32 workspace for the
// partials route, tiles = ceil(seq_len / 64); dq's rows must then be
// 16-byte aligned too.
// head_dim: 48, 64 or 128 (the wrapper pads). Strides are in elements, for the
// batch, head and token axes; the head dim must be contiguous and every row
// 16-byte aligned. dropout: 0, or 1 with the device address of the
// forward's uint32 seed, the keep threshold and fp32 1 / (1 - rate); delta
// is then rowsum(g * out) of the dropped output; bh_base, q_base and
// k_base: the global batch*head row, query and key of the launch's first,
// and inner_local, inner_global and inner_base the map of a local
// batch*head row to a global one (dropout_mask.cuh; 0, 0, 0 and 1, 1, 0
// for a launch over the whole array). Returns the CUDA error of the launch
// (0 on success).
int vtd_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    void* dq_partials, int dtype, int dkv_fp32, int batch, int heads,
    int seq_len, int head_dim,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long g_sb, long long g_sh, long long g_sn,
    long long dq_sb, long long dq_sh, long long dq_sn, long long dk_sb,
    long long dk_sh, long long dk_sn, long long dv_sb, long long dv_sh,
    long long dv_sn, int dropout, const unsigned int* seed,
    unsigned int threshold, float inv_keep, unsigned int bh_base,
    unsigned int q_base, unsigned int k_base, unsigned int inner_local,
    unsigned int inner_global, unsigned int inner_base, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0) return cudaErrorInvalidValue;
  if (dropout != 0 && seed == nullptr) return cudaErrorInvalidValue;
  if (inner_local == 0) return cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn},
      sv{v_sb, v_sh, v_sn}, sg{g_sb, g_sh, g_sn}, sdq{dq_sb, dq_sh, dq_sn},
      sdk{dk_sb, dk_sh, dk_sn}, sdv{dv_sb, dv_sh, dv_sn};
  const Dropout drop{seed,   threshold,   inv_keep,     bh_base,   q_base,
                     k_base, inner_local, inner_global, inner_base};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, float>(head_dim, dropout != 0, q, k, v, g, lse, delta,
                               dq, dk, dv, dq_partials, batch, heads, seq_len,
                               sq, sk, sv, sg, sdq, sdk, sdv, drop, s);
  } else if (dtype == 1 && dkv_fp32 != 0) {
    if (dq_partials != nullptr) return cudaErrorInvalidValue;
    err = launch<__nv_bfloat16, float>(head_dim, dropout != 0, q, k, v, g,
                                       lse, delta, dq, dk, dv, dq_partials,
                                       batch, heads, seq_len, sq, sk, sv, sg,
                                       sdq, sdk, sdv, drop, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(
        head_dim, dropout != 0, q, k, v, g, lse, delta, dq, dk, dv,
        dq_partials, batch, heads, seq_len, sq, sk, sv, sg, sdq, sdk, sdv,
        drop, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
