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
// 0.26 ms; ViT-H/14's heads in fp32, (128, 256, 80): 6.7 GFLOP on 67 MB,
// 0.041 ms by operations. On the split route the dq kernel recomputes S
// and dP, so the backward does seven products where the function needs
// the five counted above. As in the forward, it is held by the latency of
// the chain between its products (exp, the mask replay, the casts), not by
// bytes or the tensor cores: chip_smoke.py times it beside its bound on
// the card (PERF.md).
//
// dq is the same on every run, as the Pallas kernel's is: its grid walks
// the key blocks in order into a dq block that stays resident
// (_fused_bwd_kernel zeroes it at the first key block and adds each
// block's dS K), so dq = ((c0 + c1) + c2) + ... in key order. Here the sum
// runs in key order too, by one of two routes (the
// wrapper picks one by dtype, kernels/flash_attention.py:dq_route):
//   * split (fp32 past 1 GiB of partials): the dk/dv kernel does the work
//     of one (batch*head, 64-key tile), then the dq kernel that of one
//     (batch*head, 64-query tile), walking the key tiles in order and
//     recomputing S and dP;
//   * partials (fp32, where each recomputed product costs three TF32
//     ones): the dk/dv kernel also forms each query tile's dq
//     contribution dS K (dS^T through a shared tile) and stores it with
//     plain float4 stores into a (tiles, batch*head, N, D) fp32 workspace
//     of 64-key tiles; flash_bwd_dq_sum_kernel then adds the tiles in key
//     order.
// No atomics: their order would change from run to run.
//
// Design (FA2's backward, for this card), at K <= 64 (instances 48, 64):
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
//     operand (mma_sm90.cuh);
//   * dk and dv are cast to the input type (or, for a ring attention
//     block, kept in fp32: the output type is a template parameter) and
//     stored through the caller's strides; keys past N are never written,
//     queries past N never touch dq.
// At 64 < K <= 128 (flash_bwd_halves_kernel, flash_bwd_dq_halves_kernel)
// the same math and routes on another layout. The 128-wide instance of the
// design above multiplied every K in 65..128 at 128 (1.6 times the work at
// K 80), ran one CTA of 4 warps an SM (203,776 bytes of shared memory),
// spilled at 255 registers (dk and dv alone held 128) and took 16 queries
// a step; it took 0.585 ms (partials) and 0.742 (split) at (128, 256, 80)
// against SDPA's fp32 backward's 0.362 (PERF.md §6). Here:
//   * 8 warps a CTA, two halves of 4 that own the same 64 keys (dq: 64
//     queries), each half about half of K's 16-column groups; a half forms
//     its part of S^T and dP^T over its own groups, the parts meet in
//     shared memory (a 64-thread named barrier per pair of warps) and each
//     half adds the other's (the same fp32 sum in both), replays the mask
//     and runs the exp, then accumulates dk and dv (dq) for its own
//     columns only: no product past K's last 16-column group, and each
//     thread holds 64 accumulator registers instead of 128;
//   * 32 queries (dq: keys) a step, the query tiles of 32 double-buffered
//     by cp.async with their lse and delta; each step's products summed in
//     fresh registers 16 columns at a time (the tile sums);
//   * the partials route's dq contribution of each 32-query step: 8 warps,
//     16 rows x 32 columns each, from the dS^T tile (each half stores 16 of
//     the 32 queries) and the staged K.
//   As chip runs measured it (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6):
//   0.308 ms (partials) and 0.404 (split) at (128, 256, 80), against SDPA's
//   fp32 backward's 0.353 (device 0.296 against 0.32); 0.398 at K 128
//   (SDPA's device 0.34-0.36), 13-16 % of the bound by operations:
//   latency, not the tensor cores, still holds it, at 8 warps an SM.
// Budget: shared memory, the 48/64 dk/dv kernel's K, V, two q and two g
// tiles of 64 x (D + 16 bytes) and two lse and two delta rows: fp32 80,896
// (48), 105,472 (64); on the partials route the dS^T tile of 64 x (64 + 16
// bytes) more; the dq kernel's q, g and two K and two V tiles, 1,024 bytes
// less than the dk/dv kernel's. The halves: dk/dv 177,664 bytes with the
// partials, 168,448 without, dq 167,936; one CTA of 8 warps an SM. All
// dynamic, with cudaFuncAttributeMaxDynamicSharedMemorySize raised once
// per device. Registers and spills of every instance: chip_smoke.py's
// build line (-Xptxas -v), which requires the halves to spill nothing; the
// 48 and 64 instances used 255 and spilled 8-104 bytes.

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
// tile by the 48 and 64 instances: all 64. The steps are a loop the
// compiler does not unroll.
template <typename T, int D>
__host__ __device__ constexpr int sub_tile() {
  static_assert(D <= 64, "the 128 instance is the halves'");
  return kBlock;
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


// ------------------------------------------------------------------------
// fp32 at 64 < K <= 128: the column halves. Both kernels run 8 warps, two
// halves of 4 that own the same 64 rows (keys in the dk/dv kernel, queries
// in the dq kernel) and each about half of K's 16-column groups: the first
// ceil(G / 2) of the G = ceil(K / 16) groups, the second the rest. A half
// forms its part of S (and dP) over its own groups only, the two parts meet
// in shared memory and each half adds the other's to its own (s0 + s1 and
// s1 + s0 are the same fp32 sum), then each accumulates its own output
// columns. So no product runs past K's last 16-column group, each thread
// holds half of the accumulators, and the query (key) step is 32.

constexpr int kHalvesThreads = 256;
constexpr int kHalvesGroups = 4;      // 16-column groups a half at most
constexpr int kStep = 32;             // queries (dk/dv) or keys (dq) a step
constexpr int kHalvesLd = 128 + 4;    // shared row stride (floats)
constexpr int kExchange = 2 * 16 * kStep;   // floats: a warp's S and dP parts

constexpr int halves_smem_bytes(bool partials) {
  return (2 * kBlock * kHalvesLd + 4 * kStep * kHalvesLd + 4 * kStep +
          8 * kExchange + (partials ? kBlock * (kStep + 4) : 0)) *
         4;
}

constexpr int halves_dq_smem_bytes() {
  return (2 * kBlock * kHalvesLd + 4 * kStep * kHalvesLd + 8 * kExchange) * 4;
}

// The half of a warp and its 16-column groups [first, first + mine).
struct Half {
  int side, first, mine, col0, col_end;
  __device__ Half(int warp, int kdim) {
    const int groups = (kdim + 15) / 16;
    const int split = (groups + 1) / 2;
    side = warp >> 2;
    first = side * split;
    mine = side ? groups - split : split;
    col0 = 16 * first;
    col_end = min(kdim, 16 * (first + mine));
  }
};

// The two halves' parts of S and dP meet: this warp writes its own, waits
// for its partner (warp ^ 4; named barrier 1 + warp % 4, 64 threads) and
// adds the partner's to its own.
__device__ __forceinline__ void exchange(float (&s)[kStep / 8][4],
                                         float (&dp)[kStep / 8][4],
                                         float* x_s, int warp, int lane) {
  float* mine = x_s + warp * kExchange;
  const float* other = x_s + (warp ^ 4) * kExchange;
#pragma unroll
  for (int j = 0; j < kStep / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(4 * j + e) * 32 + lane] = s[j][e];
      mine[(16 + 4 * j + e) * 32 + lane] = dp[j][e];
    }
  }
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + (warp & 3)) : "memory");
#pragma unroll
  for (int j = 0; j < kStep / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] += other[(4 * j + e) * 32 + lane];
      dp[j][e] += other[(16 + 4 * j + e) * 32 + lane];
    }
  }
}

// out's groups [first, first + mine) += A B, A two 16-deep fragments
// (kStep), B [k][n] rows from b; each group's product summed in fresh
// registers and added with one fp32 add (mma_sm90.cuh's tile sums).
__device__ __forceinline__ void add_groups(
    float (&out)[2 * kHalvesGroups][4],
    const Mma<float>::A (&a)[kStep / 16], const float* b,
    const Half& hf, int lane) {
  using M = Mma<float>;
#pragma unroll
  for (int i = 0; i < kHalvesGroups; ++i) {
    if (i < hf.mine) {
      float part[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < kStep / 16; ++kc) {
        typename M::B b0, b1;
        M::load_b_kn(b0, b1, b, kHalvesLd, 16 * kc, 16 * (hf.first + i),
                     lane);
        M::mma(part[0], a[kc], b0);
        M::mma(part[1], a[kc], b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[2 * i][e] += part[0][e];
        out[2 * i + 1][e] += part[1][e];
      }
    }
  }
}

// dk and dv of the 64 keys of block blockIdx.x (key tile blockIdx.x %
// tiles of batch*head blockIdx.x / tiles) over the query tiles of 32 in
// order; with kPartials also this key tile's dq contribution dS K for every
// query into partials (tiles, batch*head, seq_len, kdim).
template <bool kDropout, bool kPartials>
__global__ void __launch_bounds__(kHalvesThreads, 1)
flash_bwd_halves_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv,
                        float* __restrict__ partials, int heads, int seq_len,
                        int kdim, int tiles, Strides sq, Strides sk,
                        Strides sv, Strides sg, Strides sdk, Strides sdv,
                        Dropout drop) {
  using M = Mma<float>;
  constexpr int kLd = kHalvesLd;
  constexpr int kLdS = kStep + 4;   // dS^T rows: [key][query]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + kBlock * kLd;
  float* q_s = v_s + kBlock * kLd;          // two buffers of kStep rows
  float* g_s = q_s + 2 * kStep * kLd;       // two buffers
  float* lse_s = g_s + 2 * kStep * kLd;     // two
  float* delta_s = lse_s + 2 * kStep;       // two
  float* x_s = delta_s + 2 * kStep;         // 8 warps' parts
  float* ds_s = x_s + 8 * kExchange;        // kPartials

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const Half hf(warp, kdim);
  const int bh = blockIdx.x / tiles;
  const int kv0 = (blockIdx.x % tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const float* q_bh = q + b * sq.b + h * sq.h;
  const float* g_bh = g + b * sg.b + h * sg.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * seq_len;
  const float* delta_bh = delta + static_cast<long long>(bh) * seq_len;
  const int steps = (seq_len + kStep - 1) / kStep;

  // Query tile `it` (kStep rows) and its lse and delta into buffer it & 1.
  auto load_queries = [&](int it) {
    const int nb = it & 1;
    const int q0 = it * kStep;
    load_tile_async<float, 128, kStep, kHalvesThreads>(
        q_s + nb * kStep * kLd, q_bh, sq.n, q0, seq_len, 0, kdim, tid);
    load_tile_async<float, 128, kStep, kHalvesThreads>(
        g_s + nb * kStep * kLd, g_bh, sg.n, q0, seq_len, 0, kdim, tid);
    if (tid < 2 * kStep) {
      const int i = tid & (kStep - 1);
      const bool valid = q0 + i < seq_len;
      const float* src = (tid < kStep ? lse_bh : delta_bh) +
                         (valid ? q0 + i : 0);
      cp_async4((tid < kStep ? lse_s : delta_s) + nb * kStep + i, src, valid);
    }
  };
  load_tile_async<float, 128, kBlock, kHalvesThreads>(
      k_s, k + b * sk.b + h * sk.h, sk.n, kv0, seq_len, 0, kdim, tid);
  load_tile_async<float, 128, kBlock, kHalvesThreads>(
      v_s, v + b * sv.b + h * sv.h, sv.n, kv0, seq_len, 0, kdim, tid);
  load_queries(0);
  cp_async_commit();

  // This lane's keys: kv0 + 16 * (warp % 4) + gr (r = 0) and + 8 (r = 1).
  const int key0 = kv0 + 16 * (warp & 3) + gr;
  bool key_ok[2];
  unsigned int hash_key[2] = {0u, 0u};
  const unsigned int seed = kDropout ? load_seed(drop) : 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_ok[r] = key0 + 8 * r < seq_len;
    if (kDropout) {
      hash_key[r] = hash_part(drop, seed, global_row(drop, bh)) +
                    key_term(drop, static_cast<unsigned int>(key0 + 8 * r));
    }
  }
  float dk_acc[2 * kHalvesGroups][4], dv_acc[2 * kHalvesGroups][4];
#pragma unroll
  for (int j = 0; j < 2 * kHalvesGroups; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }
  }

  for (int it = 0; it < steps; ++it) {
    const int q0 = it * kStep;
    const int buf = it & 1;
    if (it + 1 < steps) {
      // Into the other buffers, which every warp finished reading before
      // the previous step's barrier after its products.
      load_queries(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* q_t = q_s + buf * kStep * kLd;
    const float* g_t = g_s + buf * kStep * kLd;

    // This half's parts of S^T = K Q^T and dP^T = V g^T: 16 keys x 32
    // queries a warp.
    float s[kStep / 8][4], dp[kStep / 8][4];
#pragma unroll
    for (int j = 0; j < kStep / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kHalvesGroups; ++i) {
      if (i < hf.mine) {
        const int k0 = 16 * (hf.first + i);
        typename M::A ka, va;
        M::load_a(ka, k_s, kLd, 16 * (warp & 3), k0, lane);
        M::load_a(va, v_s, kLd, 16 * (warp & 3), k0, lane);
#pragma unroll
        for (int np = 0; np < kStep / 16; ++np) {
          typename M::B b0, b1;
          M::load_b_nk(b0, b1, q_t, kLd, 16 * np, k0, lane);
          M::mma(s[2 * np], ka, b0);
          M::mma(s[2 * np + 1], ka, b1);
          M::load_b_nk(b0, b1, g_t, kLd, 16 * np, k0, lane);
          M::mma(dp[2 * np], va, b0);
          M::mma(dp[2 * np + 1], va, b1);
        }
      }
    }
    exchange(s, dp, x_s, warp, lane);
    grads_t<kDropout>(s, dp, key_ok, hash_key, lse_s + buf * kStep,
                      delta_s + buf * kStep, q0, 0, seq_len, t, drop);
    if constexpr (kPartials) {
      // dS^T into shared memory for the dq contribution: each half stores
      // 16 of the 32 queries.
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j) {
        if ((j >> 1) == hf.side) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            store_pair(ds_s + (16 * (warp & 3) + gr + 8 * r) * kLdS + 8 * j +
                           2 * t,
                       dp[j][2 * r], dp[j][2 * r + 1]);
          }
        }
      }
    }
    // dV += P^T g and dK += dS^T Q over this half's columns.
    typename M::A pa[kStep / 16], da[kStep / 16];
#pragma unroll
    for (int kc = 0; kc < kStep / 16; ++kc) {
      M::acc_to_a(pa[kc], s[2 * kc], s[2 * kc + 1]);
      M::acc_to_a(da[kc], dp[2 * kc], dp[2 * kc + 1]);
    }
    add_groups(dv_acc, pa, g_t, hf, lane);
    add_groups(dk_acc, da, q_t, hf, lane);
    __syncthreads();
    if constexpr (kPartials) {
      // This key tile's dq contribution dS K: warp w forms query rows
      // 16 (w % 2).. of the 32 at columns 32 (w / 2)..+31, the groups that
      // hold columns below K.
      const int rows0 = 16 * (warp & 1);
      const int cols0 = 32 * (warp >> 1);
      const int groups = (kdim + 15) / 16;
      float dq_acc[4][4] = {};
#pragma unroll
      for (int kc = 0; kc < kBlock / 16; ++kc) {
        typename M::A a;
        M::load_a_t(a, ds_s, kLdS, 16 * kc, rows0, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (cols0 / 16 + np < groups) {
            typename M::B b0, b1;
            M::load_b_kn(b0, b1, k_s, kLd, 16 * kc, cols0 + 16 * np, lane);
            M::mma(dq_acc[2 * np], a, b0);
            M::mma(dq_acc[2 * np + 1], a, b1);
          }
        }
      }
      if (cols0 < kdim) {
        store_partials<4>(dq_acc, partials, blockIdx.x % tiles,
                          gridDim.x / tiles, bh, seq_len, kdim,
                          q0 + rows0 + gr, cols0, t);
      }
    }
  }

  store_rows<2 * kHalvesGroups>(dk_acc, dk + b * sdk.b + h * sdk.h, sdk.n,
                                key_ok, key0, hf.col0, hf.col_end, t);
  store_rows<2 * kHalvesGroups>(dv_acc, dv + b * sdv.b + h * sdv.h, sdv.n,
                                key_ok, key0, hf.col0, hf.col_end, t);
}

// dq of the 64 queries of block blockIdx.x over the key tiles of 32 in
// order, dq = ((c0 + c1) + c2) + ... in registers.
template <bool kDropout>
__global__ void __launch_bounds__(kHalvesThreads, 1)
flash_bwd_dq_halves_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ g,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int heads, int seq_len,
                           int kdim, int tiles, Strides sq, Strides sk,
                           Strides sv, Strides sg, Strides sdq,
                           Dropout drop) {
  using M = Mma<float>;
  constexpr int kLd = kHalvesLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* g_s = q_s + kBlock * kLd;
  float* k_s = g_s + kBlock * kLd;          // two buffers of kStep rows
  float* v_s = k_s + 2 * kStep * kLd;       // two buffers
  float* x_s = v_s + 2 * kStep * kLd;       // 8 warps' parts

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const Half hf(warp, kdim);
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const float* k_bh = k + b * sk.b + h * sk.h;
  const float* v_bh = v + b * sv.b + h * sv.h;
  const int steps = (seq_len + kStep - 1) / kStep;

  auto load_keys = [&](int it) {
    const int nb = it & 1;
    load_tile_async<float, 128, kStep, kHalvesThreads>(
        k_s + nb * kStep * kLd, k_bh, sk.n, it * kStep, seq_len, 0, kdim,
        tid);
    load_tile_async<float, 128, kStep, kHalvesThreads>(
        v_s + nb * kStep * kLd, v_bh, sv.n, it * kStep, seq_len, 0, kdim,
        tid);
  };
  load_tile_async<float, 128, kBlock, kHalvesThreads>(
      q_s, q + b * sq.b + h * sq.h, sq.n, q0, seq_len, 0, kdim, tid);
  load_tile_async<float, 128, kBlock, kHalvesThreads>(
      g_s, g + b * sg.b + h * sg.h, sg.n, q0, seq_len, 0, kdim, tid);
  load_keys(0);
  cp_async_commit();

  // This lane's queries: q0 + 16 * (warp % 4) + gr (r = 0) and + 8.
  const int query0 = q0 + 16 * (warp & 3) + gr;
  bool query_ok[2];
  float lse_r[2], delta_r[2];
  unsigned int hash_query[2] = {0u, 0u};
  const unsigned int seed = kDropout ? load_seed(drop) : 0u;
  const long long rows = static_cast<long long>(bh) * seq_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int query = query0 + 8 * r;
    query_ok[r] = query < seq_len;
    lse_r[r] = query_ok[r] ? lse[rows + query] * kLog2e : 0.f;
    delta_r[r] = query_ok[r] ? delta[rows + query] : 0.f;
    if (kDropout) {
      hash_query[r] = hash_part(drop, seed, global_row(drop, bh)) +
                      query_term(drop, static_cast<unsigned int>(query));
    }
  }
  float dq_acc[2 * kHalvesGroups][4];
#pragma unroll
  for (int j = 0; j < 2 * kHalvesGroups; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  }

  for (int it = 0; it < steps; ++it) {
    const int kv0 = it * kStep;
    const int buf = it & 1;
    if (it + 1 < steps) {
      load_keys(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_t = k_s + buf * kStep * kLd;
    const float* v_t = v_s + buf * kStep * kLd;

    // This half's parts of S = Q K^T and dP = g V^T: 16 queries x 32 keys.
    float s[kStep / 8][4], dp[kStep / 8][4];
#pragma unroll
    for (int j = 0; j < kStep / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kHalvesGroups; ++i) {
      if (i < hf.mine) {
        const int k0 = 16 * (hf.first + i);
        typename M::A qa, ga;
        M::load_a(qa, q_s, kLd, 16 * (warp & 3), k0, lane);
        M::load_a(ga, g_s, kLd, 16 * (warp & 3), k0, lane);
#pragma unroll
        for (int np = 0; np < kStep / 16; ++np) {
          typename M::B b0, b1;
          M::load_b_nk(b0, b1, k_t, kLd, 16 * np, k0, lane);
          M::mma(s[2 * np], qa, b0);
          M::mma(s[2 * np + 1], qa, b1);
          M::load_b_nk(b0, b1, v_t, kLd, 16 * np, k0, lane);
          M::mma(dp[2 * np], ga, b0);
          M::mma(dp[2 * np + 1], ga, b1);
        }
      }
    }
    exchange(s, dp, x_s, warp, lane);
    grads_q<kDropout>(s, dp, query_ok, hash_query, lse_r, delta_r, kv0,
                      seq_len, t, drop);
    // dq += dS K over this half's columns, dS in fp32 (3xTF32 split).
    typename M::A da[kStep / 16];
#pragma unroll
    for (int kc = 0; kc < kStep / 16; ++kc) {
      M::acc_to_a(da[kc], dp[2 * kc], dp[2 * kc + 1]);
    }
    add_groups(dq_acc, da, k_t, hf, lane);
    __syncthreads();
  }

  store_rows<2 * kHalvesGroups>(dq_acc, dq + b * sdq.b + h * sdq.h, sdq.n,
                                query_ok, query0, hf.col0, hf.col_end, t);
}

// The fp32 instance at 64 < K <= 128: the dk/dv kernel (with the partials
// or not), then the sum kernel or the dq kernel.
template <bool kDropout>
cudaError_t launch_halves(const Launch& a) {
  const int tiles = (a.seq_len + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(a.batch) * a.heads * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const unsigned int grid = static_cast<unsigned int>(blocks);
  const float* qt = static_cast<const float*>(a.q);
  const float* kt = static_cast<const float*>(a.k);
  const float* vt = static_cast<const float*>(a.v);
  const float* gt = static_cast<const float*>(a.g);
  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
  cudaError_t err;
  if (a.partials != nullptr) {
    static std::atomic<unsigned long long> smem_allowed{0};
    auto kernel = flash_bwd_halves_kernel<kDropout, true>;
    err = allow_dynamic_smem(kernel, halves_smem_bytes(true), smem_allowed);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kHalvesThreads, halves_smem_bytes(true), a.stream>>>(
        qt, kt, vt, gt, a.lse, a.delta, dk, dv, a.partials, a.heads,
        a.seq_len, a.kdim, tiles, a.sq, a.sk, a.sv, a.sg, a.sdk, a.sdv,
        a.drop);
    err = cudaGetLastError();
    return err != cudaSuccess ? err : sum_partials(a);
  }
  static std::atomic<unsigned long long> smem_allowed{0}, smem_dq_allowed{0};
  auto kernel = flash_bwd_halves_kernel<kDropout, false>;
  err = allow_dynamic_smem(kernel, halves_smem_bytes(false), smem_allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kHalvesThreads, halves_smem_bytes(false), a.stream>>>(
      qt, kt, vt, gt, a.lse, a.delta, dk, dv, nullptr, a.heads, a.seq_len,
      a.kdim, tiles, a.sq, a.sk, a.sv, a.sg, a.sdk, a.sdv, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dq_kernel = flash_bwd_dq_halves_kernel<kDropout>;
  err = allow_dynamic_smem(dq_kernel, halves_dq_smem_bytes(),
                           smem_dq_allowed);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kHalvesThreads, halves_dq_smem_bytes(), a.stream>>>(
      qt, kt, vt, gt, a.lse, a.delta, a.dq, a.heads, a.seq_len, a.kdim,
      tiles, a.sq, a.sk, a.sv, a.sg, a.sdq, a.drop);
  return cudaGetLastError();
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
    if (a.kdim <= 128) return launch_halves<kDropout>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename O>
cudaError_t launch(bool dropout, const Launch& a) {
  if (a.dq_bf16 != 0) return cudaErrorInvalidValue;   // dq is fp32 here
  return dropout ? launch_dim<T, O, true>(a) : launch_dim<T, O, false>(a);
}

}  // namespace

extern "C" {

// The dynamic shared memory of the fp32 column halves' kernels: 0 the
// dk/dv kernel, 1 the dk/dv kernel with the partials, 2 the dq kernel.
int vtd_flash_attention_bwd_halves_smem(int kernel) {
  return kernel == 2 ? halves_dq_smem_bytes() : halves_smem_bytes(kernel == 1);
}

}  // extern "C"
