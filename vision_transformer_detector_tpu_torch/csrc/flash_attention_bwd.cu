// Flash-attention backward for Hopper (sm_90a) on the tensor cores, bound to
// Python through a plain C interface (kernels/ops.py loads it with ctypes):
// fp32 at head dims K <= 128 here, fp32 past 128 and bf16 past 256 in
// flash_attention_bwd_wide.cu, which shares this file's contract and
// flash_bwd_common.cuh; bf16 at K <= 256 runs on wgmma in
// flash_attention_bwd_sm90.cu (the templates below still take bf16, but
// only fp32 instances are built).
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
// What bounds it (one H100 SXM: 495 TFLOP/s TF32, 3.35 TB/s):
// reference_608 training, (64, 1296, 40) fp32: 43.0 GFLOP (K = 40) on
// 94 MB, done as 3xTF32: bound by operations at 3 * 43.0 G / 495 T =
// 0.26 ms.
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
//   * split (fp32 past 1 GiB of partials; bf16 before the wgmma
//     backward): flash_bwd_kernel does the dk/dv work of one
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
//   * q, k, v and g are read at the caller's head dim K: the cp.async
//     copies zero-fill the columns past K (mma_sm90.cuh), and dq, dk, dv
//     and the partials are stored up to K, so the wrapper pads nothing;
//   * fp32 runs the same code on TF32 with the 3xTF32 split of every
//     operand (mma_sm90.cuh); instances of head dim 48, 64 or 128 take
//     K <= 48, 48 < K <= 64 and 64 < K <= 128.
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
// 64 x (D + 16 bytes) and two lse and two delta rows: fp32 80,896 (48),
// 105,472 (64), 203,776
// (128); on the partials route the dS^T tile of 64 x (64 + 16 bytes) more
// (221,184 at fp32 128, under the 232,448 a CTA may take); the dq
// kernel's q, g and two K and two V tiles, 1,024 bytes less than the dk/dv
// kernel's; dynamic, with cudaFuncAttributeMaxDynamicSharedMemorySize
// raised once per device. Registers (-Xptxas -v, sm_90a, CUDA 12.8, on the
// NVIDIA H100 80GB HBM3's machine), without / with dropout: every fp32
// kernel uses 255 and spills 8-104 bytes (the 128
// dk/dv kernel 56 / 52, its partials variant 72 / 104, its dq kernel 24 /
// 16). chip_smoke.py's build phase prints each instance's registers and
// spills and its HMMA count.

#include "flash_bwd_common.cuh"

namespace {

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
                 int seq_len, int kdim, int tiles, Strides sq, Strides sk,
                 Strides sv, Strides sg, Strides sdk, Strides sdv,
                 Dropout drop) {
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
                                          kv0, seq_len, 0, kdim, tid);
  load_tile_async<T, D, kBlock, kThreads>(v_s, v + b * sv.b + h * sv.h, sv.n,
                                          kv0, seq_len, 0, kdim, tid);
  load_tile_async<T, D, kBlock, kThreads>(q_s, q_bh, sq.n, 0, seq_len, 0,
                                          kdim, tid);
  load_tile_async<T, D, kBlock, kThreads>(g_s, g_bh, sg.n, 0, seq_len, 0,
                                          kdim, tid);
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
                                              q0 + kBlock, seq_len, 0, kdim,
                                              tid);
      load_tile_async<T, D, kBlock, kThreads>(g_s + nb * kTile, g_bh, sg.n,
                                              q0 + kBlock, seq_len, 0, kdim,
                                              tid);
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

      grads_t<kDropout>(s, dp, key_ok, hash_key, lse_t, delta_t, q0, s0,
                        seq_len, t, drop);

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
        store_partials<kCols / 8>(dq_acc, partials, blockIdx.x % tiles,
                                  gridDim.x / tiles, bh, seq_len, kdim,
                                  q0 + 16 * warp + gr, kCols * c, t);
      }
    }
    __syncthreads();
  }

  store_rows<D / 8>(dk_acc, dk + b * sdk.b + h * sdk.h, sdk.n, key_ok,
                    kv0 + 16 * warp + gr, 0, kdim, t);
  store_rows<D / 8>(dv_acc, dv + b * sdv.b + h * sdv.h, sdv.n, key_ok,
                    kv0 + 16 * warp + gr, 0, kdim, t);
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
                    int heads, int seq_len, int kdim, int tiles, Strides sq,
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
                                          q0, seq_len, 0, kdim, tid);
  load_tile_async<T, D, kBlock, kThreads>(g_s, g + b * sg.b + h * sg.h, sg.n,
                                          q0, seq_len, 0, kdim, tid);
  load_tile_async<T, D, kBlock, kThreads>(k_s, k_bh, sk.n, 0, seq_len, 0,
                                          kdim, tid);
  load_tile_async<T, D, kBlock, kThreads>(v_s, v_bh, sv.n, 0, seq_len, 0,
                                          kdim, tid);
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
                                              kv0 + kBlock, seq_len, 0, kdim,
                                              tid);
      load_tile_async<T, D, kBlock, kThreads>(v_s + nb * kTile, v_bh, sv.n,
                                              kv0 + kBlock, seq_len, 0, kdim,
                                              tid);
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

      grads_q<kDropout>(s, dp, query_ok, hash_query, lse_r, delta_r,
                        kv0 + s0, seq_len, t, drop);
      // dq += dS K, dS rounded to the input type.
      add_acc_kn<T, kSub, D>(dq_acc, dp, k_t + s0 * kLd, kLd, lane);
    }
    __syncthreads();
  }

  store_rows<D / 8>(dq_acc, dq + b * sdq.b + h * sdq.h, sdq.n, query_ok,
                    q0 + 16 * warp + gr, 0, kdim, t);
}


template <typename T, int D, bool kDropout, typename O>
cudaError_t launch_kernel(const Launch& a) {
  const int tiles = (a.seq_len + kBlock - 1) / kBlock;
  const T* qt = static_cast<const T*>(a.q);
  const T* kt = static_cast<const T*>(a.k);
  const T* vt = static_cast<const T*>(a.v);
  const T* gt = static_cast<const T*>(a.g);
  cudaError_t err;
  if (a.partials != nullptr) {
    // fp32 only (the wrapper's choice): the dk/dv kernel stores each key
    // tile's dq contribution, then the sum kernel adds them in key order.
    if constexpr (std::is_same<T, float>::value) {
      static std::atomic<unsigned long long> smem_allowed{0};
      err = run(flash_bwd_kernel<T, D, kDropout, true, T>,
                smem_bytes<T, true>(D), smem_allowed, a, 1, qt, kt, vt, gt,
                a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                a.partials, a.heads, a.seq_len, a.kdim, tiles, a.sq, a.sk,
                a.sv, a.sg, a.sdk, a.sdv, a.drop);
      return err != cudaSuccess ? err : sum_partials(a);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  static std::atomic<unsigned long long> smem_allowed{0}, smem_dq_allowed{0};
  err = run(flash_bwd_kernel<T, D, kDropout, false, O>,
            smem_bytes<T, false>(D), smem_allowed, a, 1, qt, kt, vt, gt,
            a.lse, a.delta, static_cast<O*>(a.dk), static_cast<O*>(a.dv),
            static_cast<float*>(nullptr), a.heads, a.seq_len, a.kdim, tiles,
            a.sq, a.sk, a.sv, a.sg, a.sdk, a.sdv, a.drop);
  if (err != cudaSuccess) return err;
  return run(flash_bwd_dq_kernel<T, D, kDropout>, smem_dq_bytes<T>(D),
             smem_dq_allowed, a, 1, qt, kt, vt, gt, a.lse, a.delta, a.dq,
             a.heads, a.seq_len, a.kdim, tiles, a.sq, a.sk, a.sv, a.sg,
             a.sdq, a.drop);
}


// The instance of head dim K in fp32: 48 (K <= 48), 64 (K <= 64), 128
// (K <= 128); K > 128 is flash_attention_bwd_wide.cu's, and bf16 at
// K <= 128 flash_attention_bwd_sm90.cu's (wgmma), so no bf16 instance is
// built here.
template <typename T, typename O, bool kDropout>
cudaError_t launch_dim(const Launch& a) {
  if constexpr (std::is_same<T, float>::value) {
    if (a.kdim <= 48) return launch_kernel<T, 48, kDropout, O>(a);
    if (a.kdim <= 64) return launch_kernel<T, 64, kDropout, O>(a);
    if (a.kdim <= 128) return launch_kernel<T, 128, kDropout, O>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename O>
cudaError_t launch(bool dropout, const Launch& a) {
  return dropout ? launch_dim<T, O, true>(a) : launch_dim<T, O, false>(a);
}

}  // namespace
