// Flash-attention backward for Hopper (sm_90a) at wide heads: fp32 past
// K 128 and bf16 past K 256 (fp32 at K <= 128 runs flash_attention_bwd.cu,
// bf16 at K <= 256 the wgmma kernels of flash_attention_bwd_sm90.cu).
// Bound to Python through a plain C interface (kernels/ops.py loads it with
// ctypes; the entry point is flash_bwd_common.cuh's, plus this file's
// occupancy query vtd_flash_attention_bwd_clusters).
//
// Replaces the Pallas TPU kernel `_fused_bwd_kernel` in
// vision_transformer_detector_tpu/kernels/flash_attention.py (launched by
// `_flash_bwd_pallas`) and the dropout replay of `_flash_bwd_chunked` at
// these widths, with flash_attention_bwd.cu's contract (its header states
// it; flash_attention_bwd_sm90.cu's states it in short):
//   p  = exp(q k^T - lse),   scale = keep / (1 - rate)
//   dv = (scale p)^T g,   ds = p (scale (g v^T) - delta)
//   dk = ds^T q,   dq = ds k      (p and ds rounded to the input type)
// with the keep mask of dropout_mask.cuh at the global (batch*head, query,
// key) coordinates and the row map, both layouts read through the caller's
// strides, ragged N, K not a multiple of the unit (zero-filled, never
// stored), dk and dv in the input type or fp32 (a ring block), and dq summed
// in key order without atomics by either route: fp32 "partials" (each key
// tile's dq contribution, then flash_bwd_dq_sum_kernel) or "split" (a dq
// kernel), so dq is the same on every run.
//
// What bounds it (one H100 SXM: 989 TFLOP/s bf16, 495 TF32, 3.35 TB/s):
// at (128, 256, 320) bf16 the function moves 147 MB (q, k, v, g read, dk, dv
// and dq written in bf16, lse and delta read) for 26.8 GFLOP: bound by
// bytes at 0.0439 ms. At (128, 256, 512) fp32, 42.9 GFLOP done as 3xTF32
// (128.8 G TF32 products): bound by operations at 0.260 ms. As chip runs
// measured it (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): bf16 at (128,
// 256, 320) 0.401 ms against the windowed route's 0.852 and SDPA's
// 0.70-0.78; fp32 at (128, 256, 512), partials, 2.150 against 11.97 and
// SDPA's 1.40; fp32 at K 192 / 256 / 320 0.737 / 0.870 / 1.481 (SDPA 0.62 /
// 0.74 / 0.96).
//
// Design, the cluster route (fp32 128 < K <= 1024, bf16 256 < K <= 2048):
// the windowed route this replaces split dk, dv and dq over a grid axis of
// 64-column windows and formed S^T and dP^T again in each window, over the
// whole of K in 64-column chunks: 3.3 times the products the function needs
// at bf16 K 320 and 3.8 times at fp32 K 512 (flash_bwd_common.cuh's 4-warp
// CTAs on mma.sync, every thread issuing cp.async). Here:
//   * a thread-block cluster of R CTAs (cudaLaunchKernelEx, neighbours in x)
//     per (batch*head, 64-key tile) in the dk/dv kernel and per
//     (batch*head, 64-query tile) in the dq kernel. Rank r owns a contiguous
//     share of K's columns: fp32 an even share of the 16-column groups, at
//     most 128 columns (R = ceil(K / 128)); bf16 the four 64-column TMA
//     boxes from box 4r (R = ceil(K / 256)), boxes wholly past K neither
//     loaded nor multiplied. R is a launch-time cluster dimension, at most
//     8, not a template parameter;
//   * each CTA stages its share of the tile's K and V (dq: q and g) once and
//     streams its share of q and g (dq: K and V) a step at a time through
//     two stages: fp32 32 rows a step by cp.async, bf16 64 rows a step by
//     TMA, thread 0 issuing the copies a step ahead;
//   * S^T = K q^T and dP^T = V g^T (dq: S and dP) are formed once per
//     (tile, step) across the cluster, the CTA's two halves (fp32: two
//     sets of 4 warps; bf16: two warpgroups) splitting the work by role:
//     the first forms the CTA's part of S over all of its columns, the
//     second its part of dP. Each part goes into an exchange slot of the
//     step's parity; after one cluster barrier every thread sums the R
//     parts it needs through distributed shared memory in one order, rank
//     by rank (sm90_common.cuh's sum_parts, as the wide forward's clusters
//     do), so P^T, dS^T and the replayed mask are bit-identical in every
//     CTA. fp32: two parities make one barrier a step enough. bf16: one
//     exchange, read in two halves of 32 rows (the second half's reads run
//     while the first half's products do), and a second phase of the
//     barrier a step, arrived at once the reads are done and waited for
//     before the next parts are put. A last barrier keeps each CTA
//     resident until its peers' reads are over. The distributed reads are
//     what the exchange costs: with each half owning half of the columns
//     and forming both parts (2R parts of each kind read by every thread)
//     they took 42 % of the bf16 kernels' time at (128, 256, 320) and
//     64 % at K 576 (PERF.md §6);
//   * dk/dv kernel: the first half sums the parts of S and adds dV += P^T g
//     over all of the CTA's columns (bf16: 64 keys x 256 columns in one
//     warpgroup, m64n256k16), the second sums S and dP and adds
//     dK += dS^T q. On the fp32 partials route each CTA also forms its
//     columns of the key tile's dq contribution dS K from the staged K: no
//     second S. dq kernel: both halves sum S and dP, each adds dq += dS K
//     over half of the CTA's columns, key tiles in order;
//   * fp32 on mma.sync 3xTF32, each step's products summed in fresh
//     registers 16 columns at a time and added with one fp32 add (the tile
//     sums of mma_sm90.cuh), 16-byte cp.async copies; bf16 on wgmma fed by
//     TMA in the 128-byte swizzle (parts of S^T by m64n64k16, both operands
//     K-major; dV, dK by m64n256k16 and dq by m64n128k16 with P^T, dS^T, dS
//     in registers and g, q, K as MN-major B), dq rounded to bf16 in the
//     kernel when the caller asks (no cast launch follows);
//   * the dk/dv kernel's lse and delta rows: fp32 by cp.async beside q and
//     g; bf16 read a step ahead into registers and stored to shared memory
//     after the step's cluster barrier, which the next barrier publishes.
// Past the clusters' reach (fp32 past K 1024, bf16 past 2048) the windowed
// route, three kernels a slab of batch*head rows at a time, which forms S
// and dP once per (64-query, 64-key) tile pair where the route it replaces
// formed them over all of K in every 64-column window of both dk/dv and dq
// (2 x 33 passes at bf16 K 2112: 8.2 ms against SDPA's 2.4; PERF.md §6):
//   * flash_bwd_scores_{f32,bf16}_kernel (flash_scores.cuh; one CTA of 128
//     threads a tile pair: bf16 wgmma m64n64k16 fed by TMA, three stages of
//     q, k, g, v boxes; fp32 mma.sync 3xTF32 in 64-column chunks, each
//     chunk's S and dP summed in fresh registers) forms S = q k^T and dP =
//     g v^T over all of K, then P = exp(S - lse) with the mask replayed and
//     stores scale P and dS = P (scale dP - delta), rounded to the input
//     type as the other routes round them, into a workspace of (rows, 2,
//     np, np), np = 64 * ceil(N / 64) (0 past N, so the kernels after it
//     mask nothing), which the operator takes from the caching allocator;
//   * flash_bwd_windowed_kernel: one CTA per (key tile, 64-column window),
//     the query tiles in order: dV += P^T g and dK += dS^T q from the
//     workspace's tiles and q's and g's windows (dk, dv in the input type
//     or fp32 for a ring block);
//   * flash_bwd_dq_windowed_kernel: one CTA per (query tile, window), the
//     key tiles in order: dq += dS K, in key order without atomics (both
//     fp32 dq routes take it: no partials), written in fp32 or, with
//     dq_bf16, in bf16 by the kernel itself.
// Both window kernels are 4-warp mma.sync CTAs fed by cp.async through two
// buffers; in fp32 each tile's product is summed in fresh registers. A
// slab holds as many rows as the larger of q's bytes and one row's P and
// dS take (kernels/flash_attention.py: scores_workspace).
// The Pallas kernel pads K to a multiple of 64 and sets no limit; neither
// does the windowed route.
// Budget (dynamic shared memory; registers and spills: chip_smoke.py's
// build line, -Xptxas -v, which requires the cluster and windowed
// instances to spill nothing): fp32 dk/dv K and V shares (64 x 132 floats
// each), two stages of q and g (32 x 132) with their lse and delta rows,
// two parities of the exchange (4 warps' parts of S and of dP, 32 KB) and
// on the partials route the dS^T tile, 168,448 bytes (177,664 with the
// partials); the fp32 dq kernel 167,936; bf16 the 1,024 bytes of swizzle
// alignment, K and V shares (4 boxes of 64 rows, 32 KB each), two stages
// of q and g (32 KB each), 32 KB of exchange, the rows and the barriers,
// 231,464 bytes in both kernels (of the 232,448 a CTA may take). One CTA
// an SM. Registers (-Xptxas -v, PERF.md §6): fp32 dk/dv 173-175, with the
// partials 201-205, dq 145-147; bf16 dk/dv 220-225, dq 166-168; no spills.
// The windowed route: the scores kernels 98,328 bytes bf16 (three stages
// of four 8 KB boxes and their barriers, after 1,024 of alignment) and
// 139,264 fp32 (two buffers of four 64 x 68 float tiles); the dk/dv kernel
// two buffers of four 64 x (64 + 16 bytes) tiles (73,728 bytes bf16,
// 139,264 fp32), the dq kernel of two (36,864, 69,632); registers 80-255,
// no spills (PERF.md §6).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "flash_bwd_common.cuh"
#include "flash_scores.cuh"
#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------ the windowed route
//
// Past the clusters' reach, three kernels a slab of ws_rows batch*head rows
// at a time (rows bh0..): the scores kernel forms each (query tile, key
// tile) pair's S and dP over the whole of K once (flash_scores.cuh) and
// stores the pair's scaled P and dS, rounded to T, to the workspace (rows,
// 2, np, np), np = 64 * tiles; the dk/dv kernel and the dq kernel read them
// back in 64-column windows of their outputs and form no S.

// A tile pair's P^T-side values into the workspace at local row `local`,
// query tile qt and key tile kt: P = exp(S - lse) (mask replayed, scale =
// keep / (1 - rate)) as scale P, and dS = P (scale dP - delta), each rounded
// to T, as the narrow kernels round them (grads_q). The whole tile is
// written, 0 past seq_len (p = 0 there), so the windowed kernels read no
// unwritten value and mask nothing.
template <bool kDropout, typename T>
__device__ __forceinline__ void store_grads(
    const float (&s)[8][4], const float (&dp)[8][4], T* ws, int local,
    int tiles, int qt, int kt, int bh, int seq_len, const float* lse,
    const float* delta, const Dropout& drop, int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const long long np = static_cast<long long>(tiles) * kBlock;
  const long long rows = static_cast<long long>(bh) * seq_len;
  const int query0 = qt * kBlock + 16 * warp + gr;
  const unsigned int seed = kDropout ? load_seed(drop) : 0u;
  bool ok[2];
  float lse_r[2], delta_r[2];
  unsigned int hash[2] = {0u, 0u};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int query = query0 + 8 * r;
    ok[r] = query < seq_len;
    lse_r[r] = ok[r] ? lse[rows + query] * kLog2e : 0.f;
    delta_r[r] = ok[r] ? delta[rows + query] : 0.f;
    if (kDropout) {
      hash[r] = hash_part(drop, seed, global_row(drop, bh)) +
                query_term(drop, static_cast<unsigned int>(query));
    }
  }
  T* p_row = ws + (2 * local * np + query0) * np + kt * kBlock + 2 * t;
  T* ds_row = p_row + np * np;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float pv[2], dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = kt * kBlock + 8 * j + 2 * t + i;
        const float p = ok[r] && key < seq_len
                            ? exp2f(fmaf(s[j][2 * r + i], kLog2e, -lse_r[r]))
                            : 0.f;
        float scale = 1.f;
        if (kDropout) {
          scale = keep(drop, hash[r] + key_term(drop,
                                                static_cast<unsigned int>(key)))
                      ? drop.inv_keep
                      : 0.f;
        }
        pv[i] = p * scale;
        dsv[i] = p * (dp[j][2 * r + i] * scale - delta_r[r]);
      }
      store_pair(p_row + 8 * r * np + 8 * j, pv[0], pv[1]);
      store_pair(ds_row + 8 * r * np + 8 * j, dsv[0], dsv[1]);
    }
  }
}

// The tile pair blockIdx.x, (local row, query tile, key tile) in that
// order: S = q K^T and dP = g V^T over all of K, fp32 on mma.sync 3xTF32.
template <bool kDropout>
__global__ void __launch_bounds__(kScoreThreads)
flash_bwd_scores_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ g,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ ws, int heads, int seq_len,
                            int kdim, int tiles, int bh0, Strides sq,
                            Strides sk, Strides sv, Strides sg,
                            Dropout drop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int local = blockIdx.x / (tiles * tiles);
  const int qt = blockIdx.x / tiles % tiles;
  const int kt = blockIdx.x % tiles;
  const int bh = bh0 + local;
  const int b = bh / heads;
  const int h = bh % heads;
  float s[2][8][4];
  const float* const a[2] = {q + b * sq.b + h * sq.h, g + b * sg.b + h * sg.h};
  const long long a_sn[2] = {sq.n, sg.n};
  const float* const bk[2] = {k + b * sk.b + h * sk.h,
                              v + b * sv.b + h * sv.h};
  const long long b_sn[2] = {sk.n, sv.n};
  scores_f32<2>(s, reinterpret_cast<float*>(smem_raw), a, a_sn, bk, b_sn,
                kBlock * qt, kBlock * kt, seq_len, kdim, tid);
  store_grads<kDropout>(s[0], s[1], ws, local, tiles, qt, kt, bh, seq_len,
                        lse, delta, drop, tid);
}

// The same in bf16, on wgmma fed by TMA (maps of 64-row boxes).
template <bool kDropout>
__global__ void __launch_bounds__(kScoreThreads)
flash_bwd_scores_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tg,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ ws, int heads,
                             int seq_len, int kdim, int tiles, int bh0,
                             Dropout drop) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int local = blockIdx.x / (tiles * tiles);
  const int qt = blockIdx.x / tiles % tiles;
  const int kt = blockIdx.x % tiles;
  const int bh = bh0 + local;
  float s[2][8][4];
  const CUtensorMap* const a[2] = {&tq, &tg};
  const CUtensorMap* const bk[2] = {&tk, &tv};
  scores_bf16<2>(s, smem_raw, a, bk, kBlock * qt, kBlock * kt, bh % heads,
                 bh / heads, kdim, tid);
  store_grads<kDropout>(s[0], s[1], ws, local, tiles, qt, kt, bh, seq_len,
                        lse, delta, drop, tid);
}

// A (16 rows from row0 x 16 k from k0) of a [row][k] tile in shared
// memory, in the k order of the fp32 [k][n] B loader (mma_sm90.cuh: k = t
// from column 2t, k = t + 4 from 2t + 1 of each 8-column step), which is
// an accumulator pair's (acc_to_a); bf16 ldmatrix, whose B pairs with it
// as stored.
template <typename T>
__device__ __forceinline__ void load_a_kn(typename Mma<T>::A& a, const T* s,
                                          int ld, int row0, int k0,
                                          int lane) {
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const float* p = s + (row0 + g) * ld + k0 + 8 * st + 2 * t;
      Mma<float>::set(a, 4 * st + 0, p[0]);
      Mma<float>::set(a, 4 * st + 1, p[8 * ld]);
      Mma<float>::set(a, 4 * st + 2, p[1]);
      Mma<float>::set(a, 4 * st + 3, p[8 * ld + 1]);
    }
  } else {
    Mma<T>::load_a(a, s, ld, row0, k0, lane);
  }
}

// out (16 rows x kN) += A B over one 64-deep tile: A's 16 rows from row0 of
// a P or dS tile stored [query][key], read as its transpose (kTransA, the
// rows keys: dV, dK) or as stored (the rows queries: dq); B (64 x kN) from
// [k][n] storage. In fp32 the tile's product is summed in fresh registers
// and added with one fp32 add per element (mma_sm90.cuh's tile sums), one
// 16-deep step at a time (unrolled, the 3xTF32 fragments of every step were
// held at once and spilled); bf16 adds in place.
template <typename T, bool kTransA, int kN>
__device__ __forceinline__ void add_tile_product(float (&out)[kN / 8][4],
                                                 const T* a_s, int row0,
                                                 const T* b_s, int ld,
                                                 int lane) {
  using M = Mma<T>;
  // Step kc (16 k) of the product into to.
  auto step = [&](float (&to)[kN / 8][4], int kc) {
    typename M::A x;
    if constexpr (kTransA) {
      M::load_a_t(x, a_s, ld, 16 * kc, row0, lane);
    } else {
      load_a_kn<T>(x, a_s, ld, row0, 16 * kc, lane);
    }
#pragma unroll
    for (int np = 0; np < kN / 16; ++np) {
      typename M::B b0, b1;
      M::load_b_kn(b0, b1, b_s, ld, 16 * kc, 16 * np, lane);
      M::mma(to[2 * np], x, b0);
      M::mma(to[2 * np + 1], x, b1);
    }
  };
  if constexpr (M::kTileSums) {
    float part[kN / 8][4] = {};
#pragma unroll 1
    for (int kc = 0; kc < kBlock / 16; ++kc) step(part, kc);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[j][e] += part[j][e];
    }
  } else {
#pragma unroll
    for (int kc = 0; kc < kBlock / 16; ++kc) step(out, kc);
  }
}

// dk and dv: block (blockIdx.x, blockIdx.y) is key tile blockIdx.x % tiles
// of batch*head row bh0 + blockIdx.x / tiles and column window blockIdx.y,
// dk's and dv's columns 64 * blockIdx.y .. + 63. Over the query tiles in
// order it stages the pair's scale P and dS tiles from the workspace and
// the query tile's q and g at the window's columns, and adds dV += P^T g
// and dK += dS^T q; the stages stream through two buffers, tile i + 1's
// copies in flight while tile i is multiplied.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
flash_bwd_windowed_kernel(const T* __restrict__ q, const T* __restrict__ g,
                          const T* __restrict__ ws, O* __restrict__ dk,
                          O* __restrict__ dv, int heads, int seq_len,
                          int kdim, int tiles, int bh0, Strides sq,
                          Strides sg, Strides sdk, Strides sdv) {
  using M = Mma<T>;
  constexpr int kLd = kChunk + M::kPad;
  constexpr int kTile = kBlock * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);   // [2][P, dS, q, g]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const int local = blockIdx.x / tiles;
  const int bh = bh0 + local;
  const int kv0 = (blockIdx.x % tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const int col0 = blockIdx.y * kChunk;
  const long long np = static_cast<long long>(tiles) * kBlock;
  const T* p_ws = ws + 2 * local * np * np + kv0;   // P's column kv0
  const T* q_bh = q + b * sq.b + h * sq.h;
  const T* g_bh = g + b * sg.b + h * sg.h;

  auto issue = [&](int it) {
    T* dst = bufs + (it & 1) * 4 * kTile;
    const T* p_t = p_ws + it * kBlock * np;
    load_tile_async<T, kChunk, kBlock, kThreads>(dst, p_t, np, 0, kBlock, 0,
                                                 kBlock, tid);
    load_tile_async<T, kChunk, kBlock, kThreads>(dst + kTile, p_t + np * np,
                                                 np, 0, kBlock, 0, kBlock,
                                                 tid);
    load_tile_async<T, kChunk, kBlock, kThreads>(
        dst + 2 * kTile, q_bh, sq.n, it * kBlock, seq_len, col0, kdim, tid);
    load_tile_async<T, kChunk, kBlock, kThreads>(
        dst + 3 * kTile, g_bh, sg.n, it * kBlock, seq_len, col0, kdim, tid);
    cp_async_commit();
  };
  issue(0);

  float dk_acc[kChunk / 8][4] = {}, dv_acc[kChunk / 8][4] = {};
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cur = bufs + (it & 1) * 4 * kTile;
    add_tile_product<T, true, kChunk>(dv_acc, cur, 16 * warp,
                                      cur + 3 * kTile, kLd, lane);
    add_tile_product<T, true, kChunk>(dk_acc, cur + kTile, 16 * warp,
                                      cur + 2 * kTile, kLd, lane);
    __syncthreads();
  }
  const int key0 = kv0 + 16 * warp + gr;
  const bool key_ok[2] = {key0 < seq_len, key0 + 8 < seq_len};
  store_rows<kChunk / 8>(dk_acc, dk + b * sdk.b + h * sdk.h, sdk.n, key_ok,
                         key0, col0, kdim, t);
  store_rows<kChunk / 8>(dv_acc, dv + b * sdv.b + h * sdv.h, sdv.n, key_ok,
                         key0, col0, kdim, t);
}

// dq: block (blockIdx.x, blockIdx.y) is query tile blockIdx.x % tiles of
// batch*head row bh0 + blockIdx.x / tiles and column window blockIdx.y.
// Over the key tiles in order it stages the pair's dS tile and the key
// tile's K at the window's columns and adds dq += dS K: dq summed in key
// order in registers, no atomics, stored once in Q (fp32, or bf16 rounded
// to nearest even as a cast of the fp32 sum rounds it).
template <typename T, typename Q>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_windowed_kernel(const T* __restrict__ k,
                             const T* __restrict__ ws, Q* __restrict__ dq,
                             int heads, int seq_len, int kdim, int tiles,
                             int bh0, Strides sk, Strides sdq) {
  using M = Mma<T>;
  constexpr int kLd = kChunk + M::kPad;
  constexpr int kTile = kBlock * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);   // [2][dS, K]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const int local = blockIdx.x / tiles;
  const int bh = bh0 + local;
  const int q0 = (blockIdx.x % tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const int col0 = blockIdx.y * kChunk;
  const long long np = static_cast<long long>(tiles) * kBlock;
  const T* ds_ws = ws + ((2 * local + 1) * np + q0) * np;   // dS's row q0
  const T* k_bh = k + b * sk.b + h * sk.h;

  auto issue = [&](int it) {
    T* dst = bufs + (it & 1) * 2 * kTile;
    load_tile_async<T, kChunk, kBlock, kThreads>(dst, ds_ws + it * kBlock, np,
                                                 0, kBlock, 0, kBlock, tid);
    load_tile_async<T, kChunk, kBlock, kThreads>(
        dst + kTile, k_bh, sk.n, it * kBlock, seq_len, col0, kdim, tid);
    cp_async_commit();
  };
  issue(0);

  float dq_acc[kChunk / 8][4] = {};
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cur = bufs + (it & 1) * 2 * kTile;
    add_tile_product<T, false, kChunk>(dq_acc, cur, 16 * warp, cur + kTile,
                                       kLd, lane);
    __syncthreads();
  }
  const int row0 = q0 + 16 * warp + gr;
  const bool query_ok[2] = {row0 < seq_len, row0 + 8 < seq_len};
  store_rows<kChunk / 8>(dq_acc, dq + b * sdq.b + h * sdq.h, sdq.n, query_ok,
                         row0, col0, kdim, t);
}

// The dk/dv kernel's and the dq kernel's shared memory: two buffers of
// four and of two 64 x (64 + pad) tiles.
template <typename T>
constexpr int windowed_smem_bytes(int tiles_a_buffer) {
  return 2 * tiles_a_buffer * kBlock * (kChunk + Mma<T>::kPad) *
         static_cast<int>(sizeof(T));
}

// The windowed route: for each slab of ws_rows batch*head rows, the scores
// kernel (one CTA a tile pair), the dk/dv kernel and the dq kernel (one
// CTA per 64-row tile and 64-column window), all on the caller's stream,
// so a slab reuses the workspace once the one before it is done with it.
// dq in fp32, or in bf16 with dq_bf16 (bf16 inputs).
template <typename T, bool kDropout, typename O>
cudaError_t launch_windowed(const Launch& a) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  static std::atomic<unsigned long long> scores_allowed{0}, dkv_allowed{0},
      dq_allowed{0}, dq_bf16_allowed{0};
  const int tiles = (a.seq_len + kBlock - 1) / kBlock;
  const long long rows_all = static_cast<long long>(a.batch) * a.heads;
  const unsigned int windows = (a.kdim + kChunk - 1) / kChunk;
  if (a.scores == nullptr || a.ws_rows <= 0 || a.partials != nullptr ||
      (kF32 && a.dq_bf16 != 0) || windows > 65535u ||
      static_cast<long long>(a.ws_rows) * tiles * tiles > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  auto dkv_kernel = flash_bwd_windowed_kernel<T, O>;
  auto dq_kernel = flash_bwd_dq_windowed_kernel<T, float>;
  // bf16 dq (bf16 inputs only: fp32 takes dq_bf16 0, checked above).
  using DqBf16 = std::conditional_t<kF32, float, bf16>;
  auto dq_bf16_kernel = flash_bwd_dq_windowed_kernel<T, DqBf16>;
  const int smem_scores = kF32 ? scores_f32_smem<2>() : scores_bf16_smem<2>();
  const int smem_dkv = windowed_smem_bytes<T>(4);
  const int smem_dq = windowed_smem_bytes<T>(2);
  cudaError_t err;
  CUtensorMap tq, tk, tv, tg;
  if constexpr (kF32) {
    err = allow_dynamic_smem(flash_bwd_scores_f32_kernel<kDropout>,
                             smem_scores, scores_allowed);
  } else {
    err = allow_dynamic_smem(flash_bwd_scores_bf16_kernel<kDropout>,
                             smem_scores, scores_allowed);
    auto map = [&](CUtensorMap* m, const void* ptr, Strides s) {
      return encode(m, ptr, a.kdim, a.seq_len, a.heads, a.batch, s.b, s.h,
                    s.n, kBlock);
    };
    if (!map(&tq, a.q, a.sq) || !map(&tk, a.k, a.sk) ||
        !map(&tv, a.v, a.sv) || !map(&tg, a.g, a.sg)) {
      return cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(dkv_kernel, smem_dkv, dkv_allowed);
  if (err != cudaSuccess) return err;
  err = a.dq_bf16 != 0
            ? allow_dynamic_smem(dq_bf16_kernel, smem_dq, dq_bf16_allowed)
            : allow_dynamic_smem(dq_kernel, smem_dq, dq_allowed);
  if (err != cudaSuccess) return err;
  T* ws = static_cast<T*>(a.scores);
  for (long long bh0 = 0; bh0 < rows_all; bh0 += a.ws_rows) {
    const int rows = static_cast<int>(
        rows_all - bh0 < a.ws_rows ? rows_all - bh0 : a.ws_rows);
    const int first = static_cast<int>(bh0);
    const unsigned int pairs =
        static_cast<unsigned int>(static_cast<long long>(rows) * tiles * tiles);
    if constexpr (kF32) {
      flash_bwd_scores_f32_kernel<kDropout>
          <<<pairs, kScoreThreads, smem_scores, a.stream>>>(
              static_cast<const float*>(a.q), static_cast<const float*>(a.k),
              static_cast<const float*>(a.v), static_cast<const float*>(a.g),
              a.lse, a.delta, ws, a.heads, a.seq_len, a.kdim, tiles, first,
              a.sq, a.sk, a.sv, a.sg, a.drop);
    } else {
      flash_bwd_scores_bf16_kernel<kDropout>
          <<<pairs, kScoreThreads, smem_scores, a.stream>>>(
              tq, tk, tv, tg, a.lse, a.delta, ws, a.heads, a.seq_len, a.kdim,
              tiles, first, a.drop);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned int>(rows) * tiles, windows);
    dkv_kernel<<<grid, kThreads, smem_dkv, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.g), ws,
        static_cast<O*>(a.dk), static_cast<O*>(a.dv), a.heads, a.seq_len,
        a.kdim, tiles, first, a.sq, a.sg, a.sdk, a.sdv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (a.dq_bf16 != 0) {
      dq_bf16_kernel<<<grid, kThreads, smem_dq, a.stream>>>(
          static_cast<const T*>(a.k), ws, reinterpret_cast<DqBf16*>(a.dq),
          a.heads, a.seq_len, a.kdim, tiles, first, a.sk, a.sdq);
    } else {
      dq_kernel<<<grid, kThreads, smem_dq, a.stream>>>(
          static_cast<const T*>(a.k), ws, a.dq, a.heads, a.seq_len, a.kdim,
          tiles, first, a.sk, a.sdq);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}


// ------------------------------------------------------- the cluster route

constexpr int kCThreads = 256;          // two halves: 4 warps or a warpgroup
constexpr int kStep = 32;               // dk/dv: queries a step; dq: keys
constexpr float kInf = __builtin_huge_valf();

// Raises kernel's dynamic shared-memory limit (once per device) and, for a
// query, lowers *ask.resident to the clusters of `ranks` of it that fit.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem,
                    std::atomic<unsigned long long>& allowed, int ranks,
                    const Ask& ask) {
  cudaError_t err = allow_dynamic_smem(kernel, smem, allowed);
  if (err != cudaSuccess || !ask.query) return err;
  int resident = 0;
  err = resident_clusters(kernel, kCThreads, ranks, smem, &resident);
  if (err == cudaSuccess) *ask.resident = std::min(*ask.resident, resident);
  return err;
}

// One CTA per (batch*head, 64-row tile) and cluster rank.
inline cudaError_t cluster_grid(const Launch& a, int ranks,
                                unsigned int* blocks) {
  const long long n = static_cast<long long>(a.batch) * a.heads *
                      ((a.seq_len + kBlock - 1) / kBlock) * ranks;
  if (n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *blocks = static_cast<unsigned int>(n);
  return cudaSuccess;
}

// ---------------------------------------------------------------- fp32 ---

constexpr int kShareGroups = 8;             // 16-column groups a CTA
constexpr int kF32Share = 16 * kShareGroups;   // columns a CTA at most
constexpr int kF32Ld = kF32Share + 4;       // shared row stride (floats)
constexpr int kF32Tiles = kStep / 8;        // a warp's 8-column tiles of S
// The exchange: [parity][S, dP][warp % 4] parts of kF32Tiles x 32 float4s.
constexpr int kF32Part = kF32Tiles * 32 * 4;          // floats
constexpr int kF32Exchange = 2 * 2 * 4 * kF32Part;    // floats
constexpr int kLdS = kStep + 4;             // dS^T rows: [key][query]

// The dk/dv kernel's: K and V shares, two stages of q and g and of the lse
// and delta rows, the exchange and, with the partials, the dS^T tile.
__host__ __device__ constexpr int f32_cluster_smem(bool partials) {
  return (2 * kBlock * kF32Ld + 4 * kStep * kF32Ld + 4 * kStep +
          kF32Exchange + (partials ? kBlock * kLdS : 0)) *
         4;
}
// The dq kernel's: q and g shares, two stages of K and V, the exchange.
__host__ __device__ constexpr int f32_cluster_dq_smem() {
  return (2 * kBlock * kF32Ld + 4 * kStep * kF32Ld + kF32Exchange) * 4;
}

// This CTA's share of K's 16-column groups (rank r of `ranks`: contiguous,
// the first `extra` ranks one group more than the rest): its first column,
// width and groups; and this warp's half of them in the dq kernel, whose
// halves own the output columns of groups [first, first + mine) of the
// share, the first half ceil(groups / 2) of them, up to K.
struct Share {
  int cbase, width, groups, first, mine, col0, col_end;
  __device__ Share(int rank, int ranks, int warp, int kdim) {
    const int all = (kdim + 15) / 16;
    const int base = all / ranks, extra = all % ranks;
    groups = base + (rank < extra);
    cbase = 16 * (rank * base + min(rank, extra));
    width = 16 * groups;
    const int split = (groups + 1) / 2;
    const int side = warp >> 2;
    first = side * split;
    mine = side ? groups - split : split;
    col0 = cbase + 16 * first;
    col_end = min(kdim, cbase + 16 * (first + mine));
  }
};

// Rows row0..row0+rows-1 of a (seq_len, kdim) head slice, columns
// col0..col0+width-1 (width a multiple of 16), into a shared tile of row
// stride kF32Ld with 16-byte cp.async copies; rows past seq_len and columns
// past kdim are zero-filled. Not committed here. c / per_row as a
// multiply-high by ceil(2^32 / per_row), exact for c * per_row < 2^32.
__device__ __forceinline__ void load_share(float* dst, const float* src,
                                           long long row_stride, int row0,
                                           int rows, int seq_len, int kdim,
                                           int col0, int width, int tid) {
  const unsigned int per_row = width / 4;
  const unsigned int magic = 0xffffffffu / per_row + 1u;
  for (unsigned int c = tid; c < rows * per_row; c += kCThreads) {
    const int r = static_cast<int>(__umulhi(c, magic));
    const int col = static_cast<int>(c - r * per_row) * 4;
    const int row = row0 + r;
    const bool valid = row < seq_len && col < kdim - col0;
    cp_async16(dst + r * kF32Ld + col,
               src + (valid ? row * row_stride + col0 + col : 0), valid);
  }
}

// This warp's part of A B^T over the share's `groups` 16-column groups: 16
// rows of the A tile from row0 (keys in the dk/dv kernel, queries in the
// dq kernel) by the kStep rows of the B tile.
__device__ __forceinline__ void part_product(float (&s)[kF32Tiles][4],
                                             const float* a, int row0,
                                             const float* b_s, int groups,
                                             int lane) {
  using M = Mma<float>;
#pragma unroll
  for (int j = 0; j < kF32Tiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kShareGroups; ++i) {
    if (i < groups) {
      typename M::A x;
      M::load_a(x, a, kF32Ld, row0, 16 * i, lane);
#pragma unroll
      for (int np = 0; np < kStep / 16; ++np) {
        typename M::B b0, b1;
        M::load_b_nk(b0, b1, b_s, kF32Ld, 16 * np, 16 * i, lane);
        M::mma(s[2 * np], x, b0);
        M::mma(s[2 * np + 1], x, b1);
      }
    }
  }
}

// The parts of this step meet. The first half's warps formed this CTA's
// part of S (the products over its columns), the second half's its part of
// dP: each goes into its slot of the step's parity, and after the cluster
// barrier every thread sums the `ranks` parts of S, and with `both` those
// of dP, of its elements in rank order (sum_parts).
__device__ __forceinline__ void exchange_f32(float (&s)[kF32Tiles][4],
                                             float (&dp)[kF32Tiles][4],
                                             float* x_s, int parity,
                                             int warp, int lane, int ranks,
                                             bool both) {
  if (warp < 4) {
    put_part<32>(s, x_s, parity * 8 + warp, lane);
  } else {
    put_part<32>(dp, x_s, parity * 8 + warp, lane);
  }
  cluster_arrive();
  cluster_wait();
  const uint32_t xs = smem_u32(x_s);
  sum_parts<32, kF32Tiles, 1>(s, xs, parity * 8 + (warp & 3), 0, lane,
                              ranks);
  if (both) {
    sum_parts<32, kF32Tiles, 1>(dp, xs, parity * 8 + 4 + (warp & 3), 0,
                                lane, ranks);
  }
}

// out's groups [first, first + count) += A B, A two 16-deep fragments
// (kStep), B [k][n] rows from b; each group's product summed in fresh
// registers and added with one fp32 add (mma_sm90.cuh's tile sums).
template <int kMax>
__device__ __forceinline__ void add_groups(
    float (&out)[2 * kMax][4], const Mma<float>::A (&a)[kStep / 16],
    const float* b, int first, int count, int lane) {
  using M = Mma<float>;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    if (i < count) {
      float part[2][4] = {};
#pragma unroll
      for (int kc = 0; kc < kStep / 16; ++kc) {
        typename M::B b0, b1;
        M::load_b_kn(b0, b1, b, kF32Ld, 16 * kc, 16 * (first + i), lane);
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

// dk and dv: block blockIdx.x is rank blockIdx.x % ranks of the cluster of
// key tile (blockIdx.x / ranks) % tiles of batch*head blockIdx.x / (ranks *
// tiles); the query steps of kStep in order. The first half (warps 0-3)
// forms this CTA's part of S^T and holds dv for all of the CTA's columns,
// the second forms its part of dP^T and holds dk. With kPartials also this
// key tile's dq contribution dS K, this CTA's columns of it, for every
// query into partials (tiles, batch*head, seq_len, kdim).
template <bool kDropout, bool kPartials>
__global__ void __launch_bounds__(kCThreads, 1)
flash_bwd_cluster_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             float* __restrict__ partials, int heads,
                             int seq_len, int kdim, int tiles, Strides sq,
                             Strides sk, Strides sv, Strides sg, Strides sdk,
                             Strides sdv, Dropout drop, int ranks) {
  using M = Mma<float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + kBlock * kF32Ld;
  float* q_s = v_s + kBlock * kF32Ld;          // two stages of kStep rows
  float* g_s = q_s + 2 * kStep * kF32Ld;       // two stages
  float* lse_s = g_s + 2 * kStep * kF32Ld;     // two
  float* delta_s = lse_s + 2 * kStep;          // two
  float* x_s = delta_s + 2 * kStep;            // the exchange
  float* ds_s = x_s + kF32Exchange;            // kPartials

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const bool second = warp >= 4;
  const Share sh(cluster_rank(), ranks, warp, kdim);
  const int tile = blockIdx.x / ranks;
  const int bh = tile / tiles;
  const int kv_tile = tile % tiles;
  const int kv0 = kv_tile * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const float* q_bh = q + b * sq.b + h * sq.h;
  const float* g_bh = g + b * sg.b + h * sg.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * seq_len;
  const float* delta_bh = delta + static_cast<long long>(bh) * seq_len;
  const int steps = (seq_len + kStep - 1) / kStep;

  // Query step `it` (kStep rows of this CTA's columns) and its lse and
  // delta into stage it & 1.
  auto load_queries = [&](int it) {
    const int nb = it & 1;
    const int q0 = it * kStep;
    load_share(q_s + nb * kStep * kF32Ld, q_bh, sq.n, q0, kStep, seq_len,
               kdim, sh.cbase, sh.width, tid);
    load_share(g_s + nb * kStep * kF32Ld, g_bh, sg.n, q0, kStep, seq_len,
               kdim, sh.cbase, sh.width, tid);
    if (tid < 2 * kStep) {
      const int i = tid & (kStep - 1);
      const bool valid = q0 + i < seq_len;
      const float* src = (tid < kStep ? lse_bh : delta_bh) +
                         (valid ? q0 + i : 0);
      cp_async4((tid < kStep ? lse_s : delta_s) + nb * kStep + i, src, valid);
    }
  };
  load_share(k_s, k + b * sk.b + h * sk.h, sk.n, kv0, kBlock, seq_len, kdim,
             sh.cbase, sh.width, tid);
  load_share(v_s, v + b * sv.b + h * sv.h, sv.n, kv0, kBlock, seq_len, kdim,
             sh.cbase, sh.width, tid);
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
  // dv (first half) or dk (second half) of the CTA's columns.
  float acc[2 * kShareGroups][4];
#pragma unroll
  for (int j = 0; j < 2 * kShareGroups; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  for (int it = 0; it < steps; ++it) {
    const int q0 = it * kStep;
    const int buf = it & 1;
    if (it + 1 < steps) {
      // Into the other stage, which every warp finished reading before the
      // previous step's barrier after its products.
      load_queries(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* q_t = q_s + buf * kStep * kF32Ld;
    const float* g_t = g_s + buf * kStep * kF32Ld;

    // This CTA's part of S^T = K q^T (first half) or dP^T = V g^T
    // (second), 16 keys x kStep queries a warp, summed over the cluster:
    // S^T in both halves, dP^T in the second.
    float s[kF32Tiles][4] = {}, dp[kF32Tiles][4] = {};
    if (second) {
      part_product(dp, v_s, 16 * (warp & 3), g_t, sh.groups, lane);
    } else {
      part_product(s, k_s, 16 * (warp & 3), q_t, sh.groups, lane);
    }
    exchange_f32(s, dp, x_s, it & 1, warp, lane, ranks, second);
    grads_t<kDropout>(s, dp, key_ok, hash_key, lse_s + buf * kStep,
                      delta_s + buf * kStep, q0, 0, seq_len, t, drop);
    if (kPartials && second) {
      // dS^T into shared memory for the dq contribution.
#pragma unroll
      for (int j = 0; j < kF32Tiles; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          store_pair(ds_s + (16 * (warp & 3) + gr + 8 * r) * kLdS + 8 * j +
                         2 * t,
                     dp[j][2 * r], dp[j][2 * r + 1]);
        }
      }
    }
    // dV += P^T g (first half) or dK += dS^T q (second) over the CTA's
    // columns.
    typename M::A frag[kStep / 16];
#pragma unroll
    for (int kc = 0; kc < kStep / 16; ++kc) {
      if (second) {
        M::acc_to_a(frag[kc], dp[2 * kc], dp[2 * kc + 1]);
      } else {
        M::acc_to_a(frag[kc], s[2 * kc], s[2 * kc + 1]);
      }
    }
    add_groups<kShareGroups>(acc, frag, second ? q_t : g_t, 0, sh.groups,
                             lane);
    __syncthreads();
    if constexpr (kPartials) {
      // This key tile's dq contribution dS K in this CTA's columns: warp w
      // forms query rows 16 (w % 2).. of the kStep at the share's columns
      // 32 (w / 2)..+31, the groups of the share.
      const int rows0 = 16 * (warp & 1);
      const int cols0 = 32 * (warp >> 1);
      float dq_acc[4][4] = {};
#pragma unroll
      for (int kc = 0; kc < kBlock / 16; ++kc) {
        typename M::A a;
        M::load_a_t(a, ds_s, kLdS, 16 * kc, rows0, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (cols0 / 16 + np < sh.groups) {
            typename M::B b0, b1;
            M::load_b_kn(b0, b1, k_s, kF32Ld, 16 * kc, cols0 + 16 * np,
                         lane);
            M::mma(dq_acc[2 * np], a, b0);
            M::mma(dq_acc[2 * np + 1], a, b1);
          }
        }
      }
      if (cols0 < sh.width) {
        store_partials<4>(dq_acc, partials, kv_tile,
                          gridDim.x / (tiles * ranks), bh, seq_len, kdim,
                          q0 + rows0 + gr, sh.cbase + cols0, t,
                          sh.cbase + sh.width);
      }
    }
  }
  // No CTA leaves while a peer may still read its last parts.
  cluster_arrive();
  cluster_wait();
  float* out = second ? dk + b * sdk.b + h * sdk.h
                      : dv + b * sdv.b + h * sdv.h;
  store_rows<2 * kShareGroups>(acc, out, second ? sdk.n : sdv.n, key_ok,
                               key0, sh.cbase,
                               min(kdim, sh.cbase + sh.width), t);
}

// dq: block blockIdx.x is rank blockIdx.x % ranks of the cluster of query
// tile (blockIdx.x / ranks) % tiles of batch*head blockIdx.x / (ranks *
// tiles); the key steps of kStep in order, dq = ((c0 + c1) + c2) + ... in
// registers. The first half forms this CTA's part of S, the second its
// part of dP; each half holds dq for half of the CTA's columns.
template <bool kDropout>
__global__ void __launch_bounds__(kCThreads, 1)
flash_bwd_dq_cluster_f32_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ g,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dq, int heads,
                                int seq_len, int kdim, int tiles, Strides sq,
                                Strides sk, Strides sv, Strides sg,
                                Strides sdq, Dropout drop, int ranks) {
  using M = Mma<float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* g_s = q_s + kBlock * kF32Ld;
  float* k_s = g_s + kBlock * kF32Ld;          // two stages of kStep rows
  float* v_s = k_s + 2 * kStep * kF32Ld;       // two stages
  float* x_s = v_s + 2 * kStep * kF32Ld;       // the exchange

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const bool second = warp >= 4;
  const Share sh(cluster_rank(), ranks, warp, kdim);
  const int tile = blockIdx.x / ranks;
  const int bh = tile / tiles;
  const int q0 = (tile % tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const float* k_bh = k + b * sk.b + h * sk.h;
  const float* v_bh = v + b * sv.b + h * sv.h;
  const int steps = (seq_len + kStep - 1) / kStep;

  auto load_keys = [&](int it) {
    const int nb = it & 1;
    load_share(k_s + nb * kStep * kF32Ld, k_bh, sk.n, it * kStep, kStep,
               seq_len, kdim, sh.cbase, sh.width, tid);
    load_share(v_s + nb * kStep * kF32Ld, v_bh, sv.n, it * kStep, kStep,
               seq_len, kdim, sh.cbase, sh.width, tid);
  };
  load_share(q_s, q + b * sq.b + h * sq.h, sq.n, q0, kBlock, seq_len, kdim,
             sh.cbase, sh.width, tid);
  load_share(g_s, g + b * sg.b + h * sg.h, sg.n, q0, kBlock, seq_len, kdim,
             sh.cbase, sh.width, tid);
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
  float dq_acc[2 * kShareGroups / 2][4];
#pragma unroll
  for (int j = 0; j < kShareGroups; ++j) {
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
    const float* k_t = k_s + buf * kStep * kF32Ld;
    const float* v_t = v_s + buf * kStep * kF32Ld;

    // This CTA's part of S = q K^T (first half) or dP = g V^T (second),
    // 16 queries x kStep keys a warp, both summed over the cluster.
    float s[kF32Tiles][4] = {}, dp[kF32Tiles][4] = {};
    if (second) {
      part_product(dp, g_s, 16 * (warp & 3), v_t, sh.groups, lane);
    } else {
      part_product(s, q_s, 16 * (warp & 3), k_t, sh.groups, lane);
    }
    exchange_f32(s, dp, x_s, it & 1, warp, lane, ranks, true);
    grads_q<kDropout>(s, dp, query_ok, hash_query, lse_r, delta_r, kv0,
                      seq_len, t, drop);
    // dq += dS K over this half's columns, dS in fp32 (3xTF32 split).
    typename M::A da[kStep / 16];
#pragma unroll
    for (int kc = 0; kc < kStep / 16; ++kc) {
      M::acc_to_a(da[kc], dp[2 * kc], dp[2 * kc + 1]);
    }
    add_groups<kShareGroups / 2>(dq_acc, da, k_t, sh.first, sh.mine, lane);
    __syncthreads();
  }
  cluster_arrive();
  cluster_wait();
  store_rows<kShareGroups>(dq_acc, dq + b * sdq.b + h * sdq.h, sdq.n,
                           query_ok, query0, sh.col0, sh.col_end, t);
}

// ---------------------------------------------------------------- bf16 ---

constexpr int kBoxes = 4;                       // 64-column boxes a CTA
constexpr int kBf16Share = 64 * kBoxes;         // 256 columns
constexpr int kRowsStep = 64;                   // rows a step (both kernels)
constexpr int kHalfStep = kRowsStep / 2;        // rows a half of a step
constexpr int kStages = 2;                      // of the streamed operands
constexpr int kBoxBytes = kBlock * 128;         // a box of 64 rows
constexpr int kBf16Tiles = kRowsStep / 8;       // 8-column tiles of S
constexpr int kHalfTiles = kBf16Tiles / 2;
// The exchange: the S and dP parts, [kind][tile][thread] float4s, read in
// two halves of kHalfTiles tiles.
constexpr int kBf16Part = kBf16Tiles * 128 * 16;        // bytes
constexpr int kBf16Exchange = 2 * kBf16Part;            // bytes
constexpr int kRowsBytes = kStages * 2 * kRowsStep * 4; // lse, delta rows
constexpr int kBarriers = 1 + 2 * kStages;
// Both kernels: two 64-row shares (K and V; dq: q and g), kStages stages
// of two 64-row shares (q and g; dq: K and V), the exchange, the rows (the
// dk/dv kernel's) and the barriers, after 1,024 bytes of alignment.
constexpr int kBf16Smem = 1024 + 2 * kBoxes * kBoxBytes +
                          2 * kStages * kBoxes * kBoxBytes + kBf16Exchange +
                          kRowsBytes + 8 * kBarriers;

// The shared memory of both bf16 kernels (every box on a 1,024-byte
// boundary, as the swizzle needs): the 64-row shares a and b, the stages c
// and d, the exchange, the rows and the barriers (a fixed one for a and b,
// full and empty ones for each stage).
struct Bf16Smem {
  uint32_t a, b, c, d, x, rows_u, bars;
  float* xf;
  float* rows;
  __device__ explicit Bf16Smem(unsigned char* raw_p) {
    const uint32_t raw = smem_u32(raw_p);
    a = (raw + 1023u) & ~1023u;
    b = a + kBoxes * kBoxBytes;
    c = b + kBoxes * kBoxBytes;
    d = c + kStages * kBoxes * kBoxBytes;
    x = d + kStages * kBoxes * kBoxBytes;
    rows_u = x + kBf16Exchange;
    bars = rows_u + kRowsBytes;
    xf = reinterpret_cast<float*>(raw_p + (x - raw));
    rows = reinterpret_cast<float*>(raw_p + (rows_u - raw));
  }
  __device__ uint32_t fixed() const { return bars; }
  __device__ uint32_t full(int st) const { return bars + 8u * (1 + st); }
  __device__ uint32_t empty(int st) const {
    return bars + 8u * (1 + kStages + st);
  }
  __device__ uint32_t c_at(int st) const {
    return c + st * kBoxes * kBoxBytes;
  }
  __device__ uint32_t d_at(int st) const {
    return d + st * kBoxes * kBoxBytes;
  }
};

// The CTA's live boxes (those holding columns below K) of two maps at rows
// row0.. (64 a box), into dst0 and dst1, their bytes reported to bar.
__device__ __forceinline__ void load_boxes(uint32_t dst0, uint32_t dst1,
                                           const CUtensorMap* m0,
                                           const CUtensorMap* m1,
                                           uint32_t bar, int live, int box0,
                                           int row0, int h, int b) {
  mbar_expect_tx(bar, 2 * live * kBoxBytes);
  for (int a = 0; a < live; ++a) {
    tma_load(dst0 + a * kBoxBytes, m0, bar, 64 * (box0 + a), row0, h, b);
    tma_load(dst1 + a * kBoxBytes, m1, bar, 64 * (box0 + a), row0, h, b);
  }
}

// Step j's streamed operands into stage j % kStages (thread 0), once every
// thread is done with the step kStages before it.
__device__ __forceinline__ void load_step(const Bf16Smem& sm,
                                          const CUtensorMap* m0,
                                          const CUtensorMap* m1, int j,
                                          int live, int box0, int h, int b) {
  const int st = j % kStages;
  if (j >= kStages) mbar_wait(sm.empty(st), ((j / kStages) & 1) ^ 1);
  load_boxes(sm.c_at(st), sm.d_at(st), m0, m1, sm.full(st), live, box0,
             j * kRowsStep, h, b);
}

// This warpgroup's part of A B^T (64 rows x 64) over the CTA's live boxes,
// both operands K-major in boxes of 64 rows; issued and waited for.
__device__ __forceinline__ void part_product_bf16(float (&s)[kBf16Tiles][4],
                                                  uint32_t a, uint32_t b,
                                                  int live) {
  clear(s);
  wgmma_fence();
#pragma unroll
  for (int box = 0; box < kBoxes; ++box) {
    if (box < live) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss<kRowsStep>(s, kmajor_desc(a + box * kBoxBytes + kk * 32),
                            kmajor_desc(b + box * kBoxBytes + kk * 32), 1);
      }
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(s);
}

// An accumulator pair rounded to bf16 as A fragments: tiles 2kk and
// 2kk + 1 of acc are k-step kk of the next product.
template <int kTiles>
__device__ __forceinline__ void to_fragments(const float (&acc)[kTiles][4],
                                             uint32_t (&a)[kTiles / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < kTiles / 2; ++kk) {
    a[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    a[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    a[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

// acc (64 x 64 kBoxesT) += A B over half h of a step: A the half's two
// 16-deep fragments in registers, B rows 32h.. of kBoxesT boxes of 64 rows
// from b_s, MN-major, boxes kBoxBytes apart; issued, not waited for.
template <int kBoxesT>
__device__ __forceinline__ void issue_half(float (&acc)[8 * kBoxesT][4],
                                           uint32_t (&a)[2][4],
                                           uint32_t b_s, int h) {
  fence_operands(acc);
  fence_operands(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    wgmma_rs<64 * kBoxesT>(
        acc, a[kk],
        mnmajor_desc(b_s + (2 * h + kk) * 16 * 128, kBoxBytes));
  }
  wgmma_commit();
}

// dk and dv: block blockIdx.x is rank blockIdx.x % ranks of the cluster of
// key tile (blockIdx.x / ranks) % key_tiles of batch*head blockIdx.x /
// (ranks * key_tiles); every map has boxes of 64 rows. The first warpgroup
// forms this CTA's part of S^T and holds dv for all of its boxes (64 keys x
// 256 columns), the second forms the part of dP^T and holds dk. A step is
// 64 queries; its parts meet once, behind the exchange barrier, and are
// read in two halves of 32 queries, the second half's reads running while
// the first half's products do; the barrier's next phase, arrived at once
// the reads are done and waited for before the next step's parts are put,
// frees the exchange.
template <bool kDropout, typename O>
__global__ void __launch_bounds__(kCThreads, 1)
flash_bwd_cluster_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tg,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              O* __restrict__ dk, O* __restrict__ dv,
                              int heads, int seq_len, int kdim,
                              int key_tiles, Strides sdk, Strides sdv,
                              Dropout drop, int ranks) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Bf16Smem sm(smem_raw);   // a K, b V, c q, d g

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = tid >> 7;
  const int slot = tid & 127;
  const int box0 = kBoxes * cluster_rank();
  const int live = min(kBoxes, (kdim + 63) / 64 - box0);
  const int tile = blockIdx.x / ranks;
  const int bh = tile / key_tiles;
  const int kv0 = (tile % key_tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const int steps = (seq_len + kRowsStep - 1) / kRowsStep;
  const long long row_base = static_cast<long long>(bh) * seq_len;

  // Thread i < 2 kRowsStep holds the lse (times log2 e; infinite past
  // seq_len, so p = 0 there) or the delta of query i % kRowsStep of a step.
  auto row_value = [&](int step) {
    const int query = step * kRowsStep + (tid & (kRowsStep - 1));
    const bool ok = query < seq_len;
    return tid < kRowsStep ? (ok ? lse[row_base + query] * kLog2e : kInf)
                           : (ok ? delta[row_base + query] : 0.f);
  };
  if (tid == 0) {
    mbar_init(sm.fixed(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), kCThreads);
    }
    mbar_fence_init();
  }
  if (tid < 2 * kRowsStep) sm.rows[tid] = row_value(0);
  __syncthreads();
  if (tid == 0) {
    load_boxes(sm.a, sm.b, &tk, &tv, sm.fixed(), live, box0, kv0, h, b);
    load_step(sm, &tq, &tg, 0, live, box0, h, b);
  }

  // Warp w % 4 of each warpgroup owns keys kv0 + 16 (w % 4)..; this lane
  // keys key0 and key0 + 8.
  const int t = lane & 3;
  const int key0 = kv0 + 16 * (warp & 3) + (lane >> 2);
  bool key_ok[2];
  unsigned int hash_key[2] = {0u, 0u};
  const unsigned int seed = kDropout ? load_seed(drop) : 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    key_ok[r] = key < seq_len;
    if (kDropout) {
      hash_key[r] = hash_part(drop, seed, global_row(drop, bh)) +
                    key_term(drop, static_cast<unsigned int>(key));
    }
  }
  // dv (first warpgroup) or dk (second) of the CTA's boxes.
  float acc[8 * kBoxes][4];
#pragma unroll
  for (int j = 0; j < 8 * kBoxes; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  mbar_wait(sm.fixed(), 0);
  for (int it = 0; it < steps; ++it) {
    const int st = it % kStages;
    if (tid == 0 && it + 1 < steps) {
      load_step(sm, &tq, &tg, it + 1, live, box0, h, b);
    }
    __syncwarp();
    // Step it + 1's lse or delta, a step ahead of its store.
    const float next_row =
        tid < 2 * kRowsStep && it + 1 < steps ? row_value(it + 1) : 0.f;
    const uint32_t q_t = sm.c_at(st);
    const uint32_t g_t = sm.d_at(st);
    mbar_wait(sm.full(st), (it / kStages) & 1);
    {
      float part[kBf16Tiles][4];
      if (group == 0) {
        part_product_bf16(part, sm.a, q_t, live);   // S^T = K q^T
      } else {
        part_product_bf16(part, sm.b, g_t, live);   // dP^T = V g^T
      }
      // Every peer has read the previous step's parts.
      if (it > 0) cluster_wait();
      put_part<128>(part, sm.xf, group, slot);
    }
    cluster_arrive();
    cluster_wait();
    // Every thread of the CTA is done with step it - 1's rows: step it +
    // 1's go into their stage, and the next exchange barrier publishes
    // them.
    if (tid < 2 * kRowsStep && it + 1 < steps) {
      sm.rows[((it + 1) % kStages) * 2 * kRowsStep + tid] = next_row;
    }
    const float* lse_t = sm.rows + st * 2 * kRowsStep;
    const float* delta_t = lse_t + kRowsStep;
    const uint32_t b_s = group == 0 ? g_t : q_t;
    uint32_t frag[2][2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // The half's S^T (and in the second warpgroup dP^T), summed over
      // the cluster.
      float s[kHalfTiles][4], dp[kHalfTiles][4] = {};
      sum_parts<128, kHalfTiles, 1>(s, sm.x, half, 0, slot, ranks);
      if (group == 1) {
        sum_parts<128, kHalfTiles, 1>(dp, sm.x, 2 + half, 0, slot, ranks);
      }
      if (half == 1) cluster_arrive();   // this step's reads are done
      // P^T (scaled by the keep mask) into s and dS^T into dp, for this
      // lane's keys r = e >> 1 and the queries it * kRowsStep + 32 half +
      // 8j + 2t + (e & 1).
#pragma unroll
      for (int j = 0; j < kHalfTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = kHalfStep * half + 8 * j + 2 * t + (e & 1);
          const float p = exp2f(fmaf(s[j][e], kLog2e, -lse_t[col]));
          float scale = 1.f;
          if (kDropout) {
            scale = keep(drop, hash_key[r] +
                                   query_term(drop, static_cast<unsigned int>(
                                                        it * kRowsStep + col)))
                        ? drop.inv_keep
                        : 0.f;
          }
          s[j][e] = p * scale;
          dp[j][e] = p * (dp[j][e] * scale - delta_t[col]);
        }
      }
      // dV += P^T g (first warpgroup) or dK += dS^T q (second) over the
      // CTA's boxes: the first half's products run while the second half
      // is summed.
      const bool p_role = group == 0;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int jj = 2 * kk + i;
          frag[half][kk][2 * i] =
              pack_bf16(p_role ? s[jj][0] : dp[jj][0],
                        p_role ? s[jj][1] : dp[jj][1]);
          frag[half][kk][2 * i + 1] =
              pack_bf16(p_role ? s[jj][2] : dp[jj][2],
                        p_role ? s[jj][3] : dp[jj][3]);
        }
      }
      issue_half<kBoxes>(acc, frag[half], b_s, half);
    }
    wgmma_wait_all();
    fence_operands(acc);
    fence_operands(frag[0]);
    fence_operands(frag[1]);
    mbar_arrive(sm.empty(st));
  }
  // No CTA leaves while a peer may still read its last parts.
  cluster_wait();
  const int col0 = 64 * box0;
  if (group == 0) {
    store_rows<8 * kBoxes>(acc, dv + b * sdv.b + h * sdv.h, sdv.n, key_ok,
                           key0, col0, kdim, t);
  } else {
    store_rows<8 * kBoxes>(acc, dk + b * sdk.b + h * sdk.h, sdk.n, key_ok,
                           key0, col0, kdim, t);
  }
}

// dq: block blockIdx.x is rank blockIdx.x % ranks of the cluster of query
// tile (blockIdx.x / ranks) % q_tiles of batch*head blockIdx.x / (ranks *
// q_tiles); the key steps of kRowsStep in order, dq = ((c0 + c1) + c2) +
// ... in the accumulator, stored in fp32 or, with dq_bf16, rounded once to
// bf16 (to nearest even, as a cast of the fp32 sum rounds it); every map
// has boxes of 64 rows. The first warpgroup forms this CTA's part of S,
// the second its part of dP; each holds dq for two of the CTA's boxes. The
// exchange runs as in the dk/dv kernel.
template <bool kDropout>
__global__ void __launch_bounds__(kCThreads, 1)
flash_bwd_dq_cluster_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tg,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 void* __restrict__ dq, int dq_bf16,
                                 int heads, int seq_len, int kdim,
                                 int q_tiles, Strides sdq, Dropout drop,
                                 int ranks) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Bf16Smem sm(smem_raw);   // a q, b g, c K, d V

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = tid >> 7;
  const int slot = tid & 127;
  const int box0 = kBoxes * cluster_rank();
  const int live = min(kBoxes, (kdim + 63) / 64 - box0);
  const int mine = max(0, min(2, live - 2 * group));
  const int tile = blockIdx.x / ranks;
  const int bh = tile / q_tiles;
  const int q0 = (tile % q_tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const int steps = (seq_len + kRowsStep - 1) / kRowsStep;

  if (tid == 0) {
    mbar_init(sm.fixed(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), kCThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    load_boxes(sm.a, sm.b, &tq, &tg, sm.fixed(), live, box0, q0, h, b);
    load_step(sm, &tk, &tv, 0, live, box0, h, b);
  }

  // Warp w % 4 of each warpgroup owns queries q0 + 16 (w % 4)..; this lane
  // rows row0 and row0 + 8, their lse (times log2 e; infinite past
  // seq_len, so p = 0) and delta in registers.
  const int t = lane & 3;
  const int row0 = q0 + 16 * (warp & 3) + (lane >> 2);
  float lse_r[2], delta_r[2];
  bool query_ok[2];
  unsigned int hash_query[2] = {0u, 0u};
  const unsigned int seed = kDropout ? load_seed(drop) : 0u;
  const long long row_base = static_cast<long long>(bh) * seq_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    query_ok[r] = row < seq_len;
    lse_r[r] = query_ok[r] ? lse[row_base + row] * kLog2e : kInf;
    delta_r[r] = query_ok[r] ? delta[row_base + row] : 0.f;
    if (kDropout) {
      hash_query[r] = hash_part(drop, seed, global_row(drop, bh)) +
                      query_term(drop, static_cast<unsigned int>(row));
    }
  }
  float dq_acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  }

  mbar_wait(sm.fixed(), 0);
  for (int it = 0; it < steps; ++it) {
    const int st = it % kStages;
    if (tid == 0 && it + 1 < steps) {
      load_step(sm, &tk, &tv, it + 1, live, box0, h, b);
    }
    __syncwarp();
    const uint32_t k_t = sm.c_at(st);
    const uint32_t v_t = sm.d_at(st);
    mbar_wait(sm.full(st), (it / kStages) & 1);
    {
      float part[kBf16Tiles][4];
      if (group == 0) {
        part_product_bf16(part, sm.a, k_t, live);   // S = q K^T
      } else {
        part_product_bf16(part, sm.b, v_t, live);   // dP = g V^T
      }
      if (it > 0) cluster_wait();
      put_part<128>(part, sm.xf, group, slot);
    }
    cluster_arrive();
    cluster_wait();
    uint32_t da[2][2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[kHalfTiles][4], dp[kHalfTiles][4];
      sum_parts<128, kHalfTiles, 1>(s, sm.x, half, 0, slot, ranks);
      sum_parts<128, kHalfTiles, 1>(dp, sm.x, 2 + half, 0, slot, ranks);
      if (half == 1) cluster_arrive();   // this step's reads are done
      // dS into dp for this lane's queries (rows r = e >> 1) and the keys
      // it * kRowsStep + 32 half + 8j + 2t + (e & 1); keys past seq_len
      // take p = 0.
      const int kv0 = it * kRowsStep + kHalfStep * half;
#pragma unroll
      for (int j = 0; j < kHalfTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int key = kv0 + 8 * j + 2 * t + (e & 1);
          const float p = key < seq_len
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
      to_fragments(dp, da[half]);
      // dq += dS K over this warpgroup's two boxes (boxes past K multiply
      // what their shared memory holds and are never stored).
      issue_half<2>(dq_acc, da[half], k_t + 2 * group * kBoxBytes, half);
    }
    wgmma_wait_all();
    fence_operands(dq_acc);
    fence_operands(da[0]);
    fence_operands(da[1]);
    mbar_arrive(sm.empty(st));
  }
  cluster_wait();
  if (mine > 0) {
    const int col0 = 64 * (box0 + 2 * group);
    const long long at = b * sdq.b + h * sdq.h;
    if (dq_bf16 != 0) {
      store_rows<16>(dq_acc, static_cast<bf16*>(dq) + at, sdq.n, query_ok,
                     row0, col0, kdim, t);
    } else {
      store_rows<16>(dq_acc, static_cast<float*>(dq) + at, sdq.n, query_ok,
                     row0, col0, kdim, t);
    }
  }
}

// ------------------------------------------------------------- launch ---

// fp32 at 128 < K <= kClusterMax * kF32Share: the dk/dv kernel (with the
// partials, then the sum kernel; or without, then the dq kernel). A query
// asks all three kernels.
template <bool kDropout>
cudaError_t launch_cluster_f32(const Launch& a, const Ask& ask) {
  const int ranks = cluster_ranks(a.kdim, kF32Share);
  static std::atomic<unsigned long long> partials_allowed{0},
      split_allowed{0}, dq_allowed{0};
  auto partials_kernel = flash_bwd_cluster_f32_kernel<kDropout, true>;
  auto split_kernel = flash_bwd_cluster_f32_kernel<kDropout, false>;
  auto dq_kernel = flash_bwd_dq_cluster_f32_kernel<kDropout>;
  const bool partials = a.partials != nullptr;
  cudaError_t err;
  if (partials || ask.query) {
    err = prepare(partials_kernel, f32_cluster_smem(true), partials_allowed,
                  ranks, ask);
    if (err != cudaSuccess) return err;
  }
  if (!partials || ask.query) {
    err = prepare(split_kernel, f32_cluster_smem(false), split_allowed,
                  ranks, ask);
    if (err != cudaSuccess) return err;
    err = prepare(dq_kernel, f32_cluster_dq_smem(), dq_allowed, ranks, ask);
    if (err != cudaSuccess) return err;
  }
  if (ask.query) return cudaSuccess;
  unsigned int blocks;
  err = cluster_grid(a, ranks, &blocks);
  if (err != cudaSuccess) return err;
  const int tiles = (a.seq_len + kBlock - 1) / kBlock;
  const float* qt = static_cast<const float*>(a.q);
  const float* kt = static_cast<const float*>(a.k);
  const float* vt = static_cast<const float*>(a.v);
  const float* gt = static_cast<const float*>(a.g);
  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
  err = run_cluster(partials ? partials_kernel : split_kernel, kCThreads,
                    blocks, ranks, f32_cluster_smem(partials), a.stream, qt,
                    kt, vt, gt, a.lse, a.delta, dk, dv, a.partials, a.heads,
                    a.seq_len, a.kdim, tiles, a.sq, a.sk, a.sv, a.sg, a.sdk,
                    a.sdv, a.drop, ranks);
  if (err != cudaSuccess) return err;
  if (partials) return sum_partials(a);
  return run_cluster(dq_kernel, kCThreads, blocks, ranks,
                     f32_cluster_dq_smem(), a.stream, qt, kt, vt, gt, a.lse,
                     a.delta, a.dq, a.heads, a.seq_len, a.kdim, tiles, a.sq,
                     a.sk, a.sv, a.sg, a.sdq, a.drop, ranks);
}

// bf16 at 256 < K <= kClusterMax * kBf16Share: the dk/dv kernel, then the
// dq kernel (dq in fp32 or, with dq_bf16, in bf16).
template <bool kDropout, typename O>
cudaError_t launch_cluster_bf16(const Launch& a, const Ask& ask) {
  const int ranks = cluster_ranks(a.kdim, kBf16Share);
  static std::atomic<unsigned long long> allowed{0}, dq_allowed{0};
  auto kernel = flash_bwd_cluster_bf16_kernel<kDropout, O>;
  auto dq_kernel = flash_bwd_dq_cluster_bf16_kernel<kDropout>;
  cudaError_t err = prepare(kernel, kBf16Smem, allowed, ranks, ask);
  if (err != cudaSuccess) return err;
  err = prepare(dq_kernel, kBf16Smem, dq_allowed, ranks, ask);
  if (err != cudaSuccess || ask.query) return err;
  if (a.partials != nullptr) return cudaErrorInvalidValue;
  unsigned int blocks;
  err = cluster_grid(a, ranks, &blocks);
  if (err != cudaSuccess) return err;
  // Boxes of 64 rows for every operand.
  CUtensorMap tq, tk, tv, tg;
  auto map = [&](CUtensorMap* m, const void* ptr, Strides s) {
    return encode(m, ptr, a.kdim, a.seq_len, a.heads, a.batch, s.b, s.h, s.n,
                  kBlock);
  };
  if (!map(&tq, a.q, a.sq) || !map(&tg, a.g, a.sg) || !map(&tk, a.k, a.sk) ||
      !map(&tv, a.v, a.sv)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (a.seq_len + kBlock - 1) / kBlock;
  err = run_cluster(kernel, kCThreads, blocks, ranks, kBf16Smem, a.stream,
                    tq, tk, tv, tg, a.lse, a.delta, static_cast<O*>(a.dk),
                    static_cast<O*>(a.dv), a.heads, a.seq_len, a.kdim, tiles,
                    a.sdk, a.sdv, a.drop, ranks);
  if (err != cudaSuccess) return err;
  return run_cluster(dq_kernel, kCThreads, blocks, ranks, kBf16Smem,
                     a.stream, tq, tk, tv, tg, a.lse, a.delta,
                     static_cast<void*>(a.dq), a.dq_bf16, a.heads, a.seq_len,
                     a.kdim, tiles, a.sdq, a.drop, ranks);
}

// Whether the cluster route takes head dim kdim in type T.
template <typename T>
constexpr bool cluster_route(int kdim) {
  return std::is_same<T, float>::value
             ? kdim > 128 && kdim <= kClusterMax * kF32Share
             : kdim > 256 && kdim <= kClusterMax * kBf16Share;
}

// A launch (or a query) of this source: the cluster route within its
// reach, the windowed route past it.
template <typename T, typename O>
cudaError_t dispatch(bool dropout, const Launch& a, const Ask& ask) {
  if (cluster_route<T>(a.kdim)) {
    if constexpr (std::is_same<T, float>::value) {
      if (a.dq_bf16 != 0) return cudaErrorInvalidValue;
      return dropout ? launch_cluster_f32<true>(a, ask)
                     : launch_cluster_f32<false>(a, ask);
    } else {
      return dropout ? launch_cluster_bf16<true, O>(a, ask)
                     : launch_cluster_bf16<false, O>(a, ask);
    }
  }
  if (ask.query) {
    *ask.resident = 1;
    return cudaSuccess;
  }
  return dropout ? launch_windowed<T, true, O>(a)
                 : launch_windowed<T, false, O>(a);
}

template <typename T, typename O>
cudaError_t launch(bool dropout, const Launch& a) {
  return dispatch<T, O>(dropout, a, kLaunch);
}

}  // namespace

extern "C" {

// The plan's question for a block (flash_launch.cuh's FlashBwdArgs) of this
// source: how many clusters of its route's kernels can be resident on
// args->device at once (cudaOccupancyMaxActiveClusters with the dynamic
// shared memory each takes, the least over the kernels of the route), 1
// for a block of the windowed route, or minus a CUDA error code.
int vtd_flash_attention_bwd_clusters(const FlashBwdArgs* args) {
  const FlashBwdArgs& p = *args;
  if ((p.dtype != 0 && p.dtype != 1) || p.batch <= 0 || p.heads <= 0 ||
      p.seq_len <= 0 || p.head_dim <= 0) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, p.batch, p.heads,
                 p.seq_len, p.head_dim, strides_of<Strides>(p.strides, 0),
                 strides_of<Strides>(p.strides, 1),
                 strides_of<Strides>(p.strides, 2),
                 strides_of<Strides>(p.strides, 3),
                 strides_of<Strides>(p.strides, 4),
                 strides_of<Strides>(p.strides, 5),
                 strides_of<Strides>(p.strides, 6), dropout_of(p, nullptr),
                 nullptr, 0, nullptr, 0};
  const DeviceScope scope(p.device);
  if (scope.error() != cudaSuccess) return -static_cast<int>(scope.error());
  int resident = INT_MAX;
  const Ask ask{true, &resident};
  const bool dropout = p.dropout != 0;
  const cudaError_t err =
      p.dtype == 0       ? dispatch<float, float>(dropout, a, ask)
      : p.dkv_fp32 != 0  ? dispatch<bf16, float>(dropout, a, ask)
                         : dispatch<bf16, bf16>(dropout, a, ask);
  return err == cudaSuccess ? resident : -static_cast<int>(err);
}

// The dynamic shared memory of the cluster route's kernels: 0 the fp32
// dk/dv kernel, 1 the same with the partials, 2 the fp32 dq kernel, 3 the
// bf16 kernels (both).
int vtd_flash_attention_bwd_cluster_smem(int kernel) {
  switch (kernel) {
    case 0: return f32_cluster_smem(false);
    case 1: return f32_cluster_smem(true);
    case 2: return f32_cluster_dq_smem();
    default: return kBf16Smem;
  }
}

}  // extern "C"
