// Flash-attention backward in bf16 for Hopper (sm_90a) on wgmma, fed by TMA
// in a warp-specialised pipeline; bound to Python through a plain C
// interface (kernels/ops.py loads it with ctypes). It runs every bf16
// backward route at head dims K <= 256: B2 (training without dropout),
// B2-replay (the forward's dropout mask replayed) and a ring attention
// block's instance that writes dk and dv in fp32 (dkv_fp32). fp32 at K <=
// 128 runs on mma.sync (flash_attention_bwd.cu); fp32 past 128 and bf16
// past 256 on the wide route (flash_attention_bwd_wide.cu).
//
// Replaces the Pallas TPU kernel `_fused_bwd_kernel` in
// vision_transformer_detector_tpu/kernels/flash_attention.py (launched by
// `_flash_bwd_pallas`) and the dropout branch of `_flash_bwd_chunked`, as
// flash_attention_bwd.cu does, with the same contract (its header states
// it): from q, k, v, the output cotangent g, the forward's fp32 logsumexp
// lse and delta = rowsum(g * out),
//   p  = exp(q k^T - lse),  scale = keep / (1 - rate) (1 without dropout)
//   dv = (scale * p)^T g     (scale * p rounded to bf16 first)
//   ds = p * (scale * (g v^T) - delta)   (rounded to bf16)
//   dk = ds^T q,   dq = ds k            (fp32 accumulation)
// with the keep mask of `dropout_keep_mask` (dropout_mask.cuh) at the
// global (batch*head, query, key) coordinates, as the forward drew it.
//
// What bounds it (one H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s):
// highres_1024's (B*H, N, K) = (2048, 256, 64) moves 541 MB (q, k, v, g
// read and dk, dv written in bf16, dq written and lse, delta read in fp32)
// for the five products of the function, 85.9 GFLOP: 159 FLOP per byte,
// below the bf16 ridge (about 295), so bound by bytes at 0.162 ms. The
// replay adds the keep bits, 16.8 MB written and read again. Since dq is
// summed in key order without atomics (below), the dq kernel recomputes S
// and dP: seven products, 120 GFLOP, 0.122 ms at the peak rate.
// (128, 256, 256), the widest head it takes, moves 134 MB for 10.7 GFLOP
// (80 FLOP per byte): bound by bytes at 0.040 ms. The
// mma.sync kernel it replaces reached 22 % of the bound: synchronous
// products leave the latency of the chain between them (exp, the mask,
// the casts) exposed, and every thread spent issue slots on cp.async
// addresses.
//
// Design (two kernels on one stream, in this order; FA3's shape without
// its ping-pong between consumer warpgroups):
//   * both run CTAs of 5 warps: one consumer warpgroup (warps 0-3, 16 rows
//     of the CTA's 64 each) and one producer warp (warp 4), whose lane 0
//     issues the TMA loads into a ring of two stages (a full barrier, which
//     in the dk/dv kernel also counts the 32 producer lanes that store the
//     query tile's fp32 lse and delta rows beside the copies, and an empty
//     barrier the 128 consumers arrive on), so the next tile's copies are
//     in flight while this one is multiplied and no consumer instruction
//     computes their addresses;
//   * tensor maps from the tensors' own strides, (K, N, heads, batch) with
//     unit head-dim stride, boxes of 64 columns (128 bytes: the 128-byte
//     swizzle that wgmma reads) by the tile's rows: both layouts and
//     strided views are read in place, and TMA fills columns past K and
//     rows past N with zeros, so the 64 instance takes every K <= 64, the
//     128 instance 64 < K <= 128 and the 256 instance 128 < K <= 256 with
//     no padded copy (a box wholly past K, the 256 instance's last at K <=
//     192, is neither loaded nor multiplied);
//   * dk/dv kernel, one CTA per (batch*head, 64-key tile): K and V loaded
//     once; per query tile of kQuery queries (64 at D 64; 32 at D 128 and
//     with the replay, so that S^T and dP^T, and the hash, fit beside the
//     dk and dv accumulators: at D 64 the replay spilled 104 bytes and took
//     0.381 ms at (2048, 256, 64) with 64-query tiles, 0.336 with 32),
//     Q and g with their lse and delta rows; S^T = K Q^T and dP^T = V g^T
//     by wgmma, both operands K-major; P^T, dS^T in fp32 in the
//     accumulators' registers; dV += (scale * P^T)_bf16 g and
//     dK += dS^T_bf16 Q by wgmma with A in registers (the accumulator's
//     tile pairs rounded to bf16) and B MN-major, as O += P V in the
//     forward; dk and dv stored through the caller's strides up to K, in
//     bf16 or fp32. At D 256, dK and dV for 64 keys x 256 columns would
//     take 256 registers a thread, so a grid axis of two column windows
//     splits them: each window's CTA forms S^T and dP^T over the whole of
//     K (the same values in both) and keeps dk and dv for its 128 columns
//     (registers as the 128 instance's); window 0 writes the keep words.
//     The two windows as two consumer warpgroups of one CTA, sharing its
//     tiles (8 warps: no producer warp, as the forward's 256 instance),
//     took 0.1035 ms against 0.1127 at (128, 256, 256) but 0.046 against
//     0.043 at the K-256 model's (40, 256, 256), and were not kept;
//   * the replay hashes each score once: the dk/dv kernel draws each keep
//     bit and also writes the bits packed, one uint32 per (batch*head,
//     32 keys, query) in a (B*H, ceil(N / 32), N) workspace, word w of
//     query q holding keys 32w..32w+31 (bit i = key 32w + i, 0 past N):
//     each accumulator element's keep bits across the warp are one ballot
//     (4 queries x 8 keys), one lane keeps it and stores it to shared
//     memory, and after a barrier of the consumers each word is assembled
//     from four ballots by the thread that stores it, consecutive threads
//     on consecutive queries;
//   * dq kernel, one CTA per (batch*head, 64-query tile): Q and g loaded
//     once; the 64-key tiles in order (one CTA an SM at D 256, where dq's
//     own accumulator is 128 registers a thread: 32-key tiles, tried,
//     took 0.063 ms against 0.054 at (128, 256, 256)), K and V by TMA and
//     (replay) each thread's four keep words by plain loads issued before
//     the tile's products; S = Q K^T and dP = g V^T by wgmma, dS in fp32
//     from lse and delta in registers, dq += dS_bf16 K with K as an
//     MN-major B; dq
//     summed so in key order, ((c0 + c1) + c2) + ..., in the accumulator
//     and written once, with no atomics: the same on every run, as the
//     Pallas kernel's resident dq block is; in fp32, or rounded once to
//     bf16 when the caller asks for dq in q's dtype (no cast launch
//     follows). It never calls the hash;
//   * a captured CUDA graph replays both launches with the seed read from
//     device memory, as the forward does.
// Not done here: a persistent tile scheduler, overlapping one tile's
// elementwise work with the next tile's products, TMA stores, and dq
// summed in a cluster's shared memory in place of the second kernel.
// Budget: shared memory (dynamic, 1,024 bytes of alignment included): the
// dk/dv kernel 52,264 (D 64), 68,136 (D 128) and 133,672 (D 256) bytes,
// the dq kernel 50,216, 99,368 and 197,672. Registers and spills of each
// instance: chip_smoke.py's build phase prints ptxas's lines (PERF.md
// records them); the 256 instance's (CUDA 12.8): dk/dv 217 and, with the
// replay, 254; dq 248 and 255; no spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "dropout_mask.cuh"
#include "flash_launch.cuh"
#include "mma_sm90.cuh"
#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;        // keys (dk/dv) or queries (dq) per CTA
constexpr int kConsumers = 128;  // the consumer warpgroup's threads
constexpr int kThreads = kConsumers + 32;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInf = __builtin_huge_valf();

struct Strides {
  long long b, h, n;
};

// The dk/dv kernel's queries a tile: 64 at D 64 without dropout; 32 at
// D 128, and with the replay, so that S^T and dP^T (and the hash) fit
// beside the dk and dv accumulators.
template <int D, bool kDropout>
__host__ __device__ constexpr int query_tile() {
  return D == 64 && !kDropout ? 64 : 32;
}

template <int D, int kQueryTile = 64>
struct Shape {
  static constexpr int kQuery = kQueryTile;
  static constexpr int kAtoms = D / 64;   // 64-column (128-byte) boxes
  // The dk/dv kernel's column windows (a grid axis: each window's CTA forms
  // S^T and dP^T over the whole of K and keeps dk and dv for its kOut
  // columns): at D 256 two windows of 128, so that dk and dv take 128
  // registers a thread.
  static constexpr int kWindows = D == 256 ? 2 : 1;
  static constexpr int kOut = D / kWindows;
  static constexpr int kTileBytes = kRows * D * 2;      // 64 rows of D
  static constexpr int kQTileBytes = kQuery * D * 2;
  // dk/dv: K, V; per stage Q, g and the lse and delta rows; two buffers of
  // the consumers' keep-bit ballots; barriers kv_full, full, empty.
  static constexpr int kSmem = 1024 + 2 * kTileBytes +
                               kStages * (2 * kQTileBytes + 8 * kQuery) +
                               2 * 4 * kConsumers + 8 * (1 + 2 * kStages);
  // dq: Q, g; per stage K and V; barriers qg_full, full, empty.
  static constexpr int kDqSmem = 1024 + 2 * kTileBytes +
                                 kStages * 2 * kTileBytes +
                                 8 * (1 + 2 * kStages);
};

// The 8 bits of a ballot held by the lanes 4g + t (g = 0..7) of one t,
// as bits g.
__device__ __forceinline__ uint32_t lane_bits(uint32_t mask, int t) {
  uint32_t x = (mask >> t) & 0x11111111u;
  x = (x | (x >> 3)) & 0x03030303u;
  x = (x | (x >> 6)) & 0x000F000Fu;
  return (x | (x >> 12)) & 0xFFu;
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

// D (64 x N) = A B^T over the head dim, A a 64-row and B an N-row tile in
// shared memory, each stored as 64-column boxes one after the other, of
// which the first `atoms` hold columns below K (the rest are not loaded).
template <int D, int N>
__device__ __forceinline__ void product_kmajor(float (&d)[N / 8][4],
                                               uint32_t a_s, uint32_t b_s,
                                               int atoms) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t within = (kk % 4) * 32;
    if (kk / 4 < atoms) {
      wgmma_ss<N>(d, kmajor_desc(a_s + (kk / 4) * kRows * 128 + within),
                  kmajor_desc(b_s + (kk / 4) * N * 128 + within), kk > 0);
    }
  }
}


// This lane's accumulator rows row0 and row0 + 8 (where below seq_len),
// columns up to kdim, stored as O through the row stride.
template <int kTiles, typename O>
__device__ __forceinline__ void store_rows(const float (&acc)[kTiles][4],
                                           O* base, long long row_stride,
                                           int row0, int seq_len, int kdim,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= seq_len) continue;
    O* p = base + row * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (8 * j + 2 * t < kdim) {
        store_pair(p + 8 * j, acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

// dk and dv (and, with kDropout, the packed keep bits): block blockIdx.x is
// column window blockIdx.x % kWindows of key tile (blockIdx.x / kWindows)
// % key_tiles of batch*head blockIdx.x / (kWindows * key_tiles).
template <int D, bool kDropout, typename O>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tg,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, O* __restrict__ dk,
                      O* __restrict__ dv, uint32_t* __restrict__ bits,
                      int heads, int seq_len, int kdim, int key_tiles,
                      Strides sdk, Strides sdv, Dropout drop) {
  using S = Shape<D, query_tile<D, kDropout>()>;
  constexpr int kQ = S::kQuery;
  constexpr int kOut = S::kOut;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Every box starts on a 1,024-byte boundary, as the swizzle needs.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;
  const uint32_t v_s = k_s + S::kTileBytes;
  const uint32_t q_s = v_s + S::kTileBytes;               // kStages tiles
  const uint32_t g_s = q_s + kStages * S::kQTileBytes;    // kStages tiles
  const uint32_t rows_s = g_s + kStages * S::kQTileBytes;
  const uint32_t ballots_s = rows_s + kStages * 8 * kQ;
  const uint32_t bars = ballots_s + 2 * 4 * kConsumers;
  // lse (times log2 e) and delta of stage st's queries.
  float* rows = reinterpret_cast<float*>(smem_raw + (rows_s - raw));
  // Two buffers of each consumer lane's ballot (keep bits, below).
  uint32_t* ballots_base =
      reinterpret_cast<uint32_t*>(smem_raw + (ballots_s - raw));
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Key tiles of one (batch, head), and a tile's windows, are neighbours
  // in launch order, so its q and g are read from device memory once and
  // from L2 after that.
  const int window = blockIdx.x % S::kWindows;
  const int tile = blockIdx.x / S::kWindows;
  const int bh = tile / key_tiles;
  const int kv0 = (tile % key_tiles) * kRows;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q_tiles = (seq_len + kQ - 1) / kQ;
  const int atoms = live_atoms<D>(kdim);

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1 + 32);
      mbar_init(empty(st), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: lane 0 issues the copies; every lane stores its queries'
    // lse and delta rows (lse infinite past seq_len, so p = 0 there).
    const long long row_base = static_cast<long long>(bh) * seq_len;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * atoms * kRows * 128);
#pragma unroll
      for (int a = 0; a < S::kAtoms; ++a) {
        if (a < atoms) {
          tma_load(k_s + a * kRows * 128, &tk, kv_full, 64 * a, kv0, h, b);
          tma_load(v_s + a * kRows * 128, &tv, kv_full, 64 * a, kv0, h, b);
        }
      }
    }
    for (int it = 0; it < q_tiles; ++it) {
      const int st = it % kStages;
      if (it >= kStages) mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
      const int q0 = it * kQ;
      if (lane == 0) {
        const uint32_t q_t = q_s + st * S::kQTileBytes;
        const uint32_t g_t = g_s + st * S::kQTileBytes;
        mbar_expect_tx(full(st), 2 * atoms * kQ * 128);
#pragma unroll
        for (int a = 0; a < S::kAtoms; ++a) {
          if (a < atoms) {
            tma_load(q_t + a * kQ * 128, &tq, full(st), 64 * a, q0, h, b);
            tma_load(g_t + a * kQ * 128, &tg, full(st), 64 * a, q0, h, b);
          }
        }
      }
      float* lse_t = rows + st * 2 * kQ;
#pragma unroll
      for (int i = lane; i < kQ; i += 32) {
        const int q = q0 + i;
        const bool ok = q < seq_len;
        lse_t[i] = ok ? lse[row_base + q] * kLog2e : kInf;
        lse_t[kQ + i] = ok ? delta[row_base + q] : 0.f;
      }
      mbar_arrive(full(st));
    }
    return;
  }

  // Consumers: warp w owns keys kv0 + 16w .. + 15 of the tile; this lane
  // keys key0 and key0 + 8.
  const int g8 = lane >> 2;
  const int t = lane & 3;
  const int key0 = kv0 + 16 * warp + g8;
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
  const int key_words = (seq_len + 31) / 32;
  float dk_acc[kOut / 8][4], dv_acc[kOut / 8][4];
#pragma unroll
  for (int j = 0; j < kOut / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }
  }
  float s[kQ / 8][4], dp[kQ / 8][4];
  uint32_t pa[kQ / 16][4], da[kQ / 16][4];

  mbar_wait(kv_full, 0);
  for (int it = 0; it < q_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const uint32_t q_t = q_s + st * S::kQTileBytes;
    const uint32_t g_t = g_s + st * S::kQTileBytes;
    const float* lse_t = rows + st * 2 * kQ;
    const float* delta_t = lse_t + kQ;

    // S^T = K Q^T and dP^T = V g^T, one group of products.
    mbar_wait(full(st), parity);
    clear(s);
    clear(dp);
    wgmma_fence();
    product_kmajor<D, kQ>(s, k_s, q_t, atoms);
    product_kmajor<D, kQ>(dp, v_s, g_t, atoms);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    // P^T (scaled by the keep mask) into s and dS^T into dp, for this
    // lane's keys r = e >> 1 and the queries it * kQ + 8j + 2t + (e & 1).
    // Each score is hashed once; the warp's keep bits of the accumulator
    // element [j][e] (lane 4g + t: key 16 warp + g + 8r, query 8j + 2t +
    // (e & 1)) are one ballot, which lane 4j + e keeps for the words below.
    uint32_t ballot = 0u;
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = 8 * j + 2 * t + (e & 1);
        const float p = exp2f(fmaf(s[j][e], kLog2e, -lse_t[col]));
        float scale = 1.f;
        if (kDropout) {
          const bool kept = keep(
              drop, hash_key[r] + query_term(drop, static_cast<unsigned int>(
                                                       it * kQ + col)));
          scale = kept ? drop.inv_keep : 0.f;
          const uint32_t votes = __ballot_sync(0xffffffffu,
                                               kept && key_ok[r]);
          ballot = lane == 4 * j + e ? votes : ballot;
        }
        s[j][e] = p * scale;
        dp[j][e] = p * (dp[j][e] * scale - delta_t[col]);
      }
    }
    uint32_t* ballots = ballots_base + (it & 1) * kConsumers;
    if (kDropout) ballots[tid] = ballot;
    to_fragments(s, pa);
    to_fragments(dp, da);

    // dV += P^T g and dK += dS^T Q over kQ / 16 k-steps of 16 queries, in
    // the window's columns of g and Q (its first box, kOut / 64 of them).
    const uint32_t first_box = window * (kOut / 64) * kQ * 128;
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    fence_operands(pa);
    fence_operands(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      wgmma_rs<kOut>(dv_acc, pa[kk], mnmajor_desc(
          g_t + first_box + kk * 16 * 128, kQ * 128));
    }
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      wgmma_rs<kOut>(dk_acc, da[kk], mnmajor_desc(
          q_t + first_box + kk * 16 * 128, kQ * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dv_acc);
    fence_operands(dk_acc);
    fence_operands(pa);
    fence_operands(da);
    mbar_arrive(empty(st));

    if (kDropout && window == 0) {
      // Word c of query q: keys kv0 + 32c .. + 31, the 16 keys of warps 2c
      // (low half) and 2c + 1 (high), each from the two ballots (r = 0,
      // 1) of q's accumulator elements, its bits at lanes 4g + t. The
      // buffers alternate, so the barrier of the next tile also orders
      // these reads before that tile's writes. Window 0 writes the words;
      // the other draws the same bits for its own columns.
      consumers_sync();
      if (tid < 2 * kQ) {
        const int q = tid % kQ;
        const int c = tid / kQ;
        const int word = kv0 / 32 + c;
        const int query = it * kQ + q;
        const int pair = 4 * (q / 8) + (q & 1);    // 4j + e at r = 0
        const int tq = (q % 8) / 2;
        uint32_t bits_q = 0u;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t* warp_ballots = ballots + 32 * (2 * c + half);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bits_q |= lane_bits(warp_ballots[pair + 2 * r], tq)
                      << (16 * half + 8 * r);
          }
        }
        if (word < key_words && query < seq_len) {
          bits[(static_cast<long long>(bh) * key_words + word) * seq_len +
               query] = bits_q;
        }
      }
    }
  }
  const int col0 = window * kOut;
  store_rows<kOut / 8>(dk_acc, dk + b * sdk.b + h * sdk.h + col0, sdk.n,
                       key0, seq_len, kdim - col0, t);
  store_rows<kOut / 8>(dv_acc, dv + b * sdv.b + h * sdv.h + col0, sdv.n,
                       key0, seq_len, kdim - col0, t);
}

// The keep words of key tile `tile` (keys 64 tile .. + 63, two words) for
// the queries row0 and row0 + 8 of batch*head bh, 0 past seq_len.
__device__ __forceinline__ void load_keep_words(
    uint32_t (&w)[2][2], const uint32_t* __restrict__ bits, int bh,
    int key_words, int seq_len, int row0, int tile) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int word = 2 * tile + c;
      const int row = row0 + 8 * r;
      w[r][c] = row < seq_len && word < key_words
                    ? __ldg(bits + (static_cast<long long>(bh) * key_words +
                                    word) * seq_len + row)
                    : 0u;
    }
  }
}

// dq: block blockIdx.x is query tile blockIdx.x % q_tiles of batch*head
// blockIdx.x / q_tiles; the 64-key tiles in order, dq = ((c0 + c1) + c2)
// + ... in the accumulator, stored in fp32 or, with dq_bf16, rounded once
// to bf16 (to nearest even, as a cast of the fp32 sum rounds it). With
// kDropout the keep mask comes from the words the dk/dv kernel wrote.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, D == 256 ? 1 : 2)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         void* __restrict__ dq, int dq_bf16,
                         const uint32_t* __restrict__ bits, int heads,
                         int seq_len, int kdim, int q_tiles, Strides sdq,
                         Dropout drop) {
  using S = Shape<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;
  const uint32_t g_s = q_s + S::kTileBytes;
  const uint32_t k_s = g_s + S::kTileBytes;               // kStages tiles
  const uint32_t v_s = k_s + kStages * S::kTileBytes;     // kStages tiles
  const uint32_t bars = v_s + kStages * S::kTileBytes;
  const uint32_t qg_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + kStages + st); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kRows;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kv_tiles = (seq_len + kRows - 1) / kRows;
  const int atoms = live_atoms<D>(kdim);

  if (tid == 0) {
    mbar_init(qg_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: one thread keeps the ring of stages full.
    if (lane == 0) {
      mbar_expect_tx(qg_full, 2 * atoms * kRows * 128);
#pragma unroll
      for (int a = 0; a < S::kAtoms; ++a) {
        if (a < atoms) {
          tma_load(q_s + a * kRows * 128, &tq, qg_full, 64 * a, q0, h, b);
          tma_load(g_s + a * kRows * 128, &tg, qg_full, 64 * a, q0, h, b);
        }
      }
      for (int it = 0; it < kv_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
        const uint32_t k_t = k_s + st * S::kTileBytes;
        const uint32_t v_t = v_s + st * S::kTileBytes;
        mbar_expect_tx(full(st), 2 * atoms * kRows * 128);
#pragma unroll
        for (int a = 0; a < S::kAtoms; ++a) {
          if (a < atoms) {
            tma_load(k_t + a * kRows * 128, &tk, full(st), 64 * a,
                     it * kRows, h, b);
            tma_load(v_t + a * kRows * 128, &tv, full(st), 64 * a,
                     it * kRows, h, b);
          }
        }
      }
    }
    return;
  }

  // Consumers: warp w owns queries q0 + 16w .. + 15; this lane row0 and
  // row0 + 8, their lse (times log2 e; infinite past seq_len, so p = 0)
  // and delta in registers.
  const int g8 = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + 16 * warp + g8;
  float lse_r[2], delta_r[2];
  const long long row_base = static_cast<long long>(bh) * seq_len;
  const int key_words = (seq_len + 31) / 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const bool ok = row < seq_len;
    lse_r[r] = ok ? lse[row_base + row] * kLog2e : kInf;
    delta_r[r] = ok ? delta[row_base + row] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  }
  float s[kRows / 8][4], dp[kRows / 8][4];
  uint32_t da[kRows / 16][4];
  // The keep words of this lane's rows for the current key tile.
  uint32_t keep_words[2][2] = {{0u, 0u}, {0u, 0u}};
  if (kDropout) {
    load_keep_words(keep_words, bits, bh, key_words, seq_len, row0, 0);
  }

  mbar_wait(qg_full, 0);
  for (int it = 0; it < kv_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    const uint32_t k_t = k_s + st * S::kTileBytes;
    const uint32_t v_t = v_s + st * S::kTileBytes;
    const int kv0 = it * kRows;

    // S = Q K^T and dP = g V^T, one group of products; while they run,
    // the next tile's keep words are requested, a tile ahead of their use.
    mbar_wait(full(st), parity);
    clear(s);
    clear(dp);
    wgmma_fence();
    product_kmajor<D, kRows>(s, q_s, k_t, atoms);
    product_kmajor<D, kRows>(dp, g_s, v_t, atoms);
    wgmma_commit();
    uint32_t next_words[2][2] = {{0u, 0u}, {0u, 0u}};
    if (kDropout && it + 1 < kv_tiles) {
      load_keep_words(next_words, bits, bh, key_words, seq_len, row0,
                      it + 1);
    }
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    const bool ragged = kv0 + kRows > seq_len;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = 8 * j + 2 * t + (e & 1);
        float p = exp2f(fmaf(s[j][e], kLog2e, -lse_r[r]));
        if (ragged && kv0 + col >= seq_len) p = 0.f;
        float scale = 1.f;
        if (kDropout) {
          scale = (keep_words[r][j / 4] >> (col & 31)) & 1u ? drop.inv_keep
                                                           : 0.f;
        }
        dp[j][e] = p * (dp[j][e] * scale - delta_r[r]);
      }
    }
    to_fragments(dp, da);

    // dq += dS K over four k-steps of 16 keys.
    fence_operands(dq_acc);
    fence_operands(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wgmma_rs<D>(dq_acc, da[kk],
                  mnmajor_desc(k_t + kk * 16 * 128, kRows * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(dq_acc);
    fence_operands(da);
    mbar_arrive(empty(st));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      keep_words[r][0] = next_words[r][0];
      keep_words[r][1] = next_words[r][1];
    }
  }
  const long long dq_row0 = b * sdq.b + h * sdq.h;
  if (dq_bf16 != 0) {
    store_rows<D / 8>(dq_acc, static_cast<bf16*>(dq) + dq_row0, sdq.n, row0,
                      seq_len, kdim, t);
  } else {
    store_rows<D / 8>(dq_acc, static_cast<float*>(dq) + dq_row0, sdq.n,
                      row0, seq_len, kdim, t);
  }
}

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;
  const float* delta;
  void* dq;
  int dq_bf16;
  void* dk;
  void* dv;
  uint32_t* bits;
  int batch, heads, seq_len, kdim;
  Strides sq, sk, sv, sg, sdq, sdk, sdv;
  Dropout drop;
  cudaStream_t stream;
};

bool encode_map(CUtensorMap* map, const void* ptr, const Launch& a,
                Strides s, int rows) {
  return encode(map, ptr, a.kdim, a.seq_len, a.heads, a.batch, s.b, s.h,
                s.n, rows);
}

template <int D, bool kDropout, typename O>
cudaError_t launch_kernels(const Launch& a) {
  using S = Shape<D, query_tile<D, kDropout>()>;
  // 64-row boxes of all four, and the dk/dv kernel's query tiles of q and
  // g (the same maps where kQuery is 64: each encoding costs host time).
  CUtensorMap tq, tk, tv, tg, tq_tile, tg_tile;
  if (!encode_map(&tq, a.q, a, a.sq, kRows) ||
      !encode_map(&tk, a.k, a, a.sk, kRows) ||
      !encode_map(&tv, a.v, a, a.sv, kRows) ||
      !encode_map(&tg, a.g, a, a.sg, kRows)) {
    return cudaErrorInvalidValue;
  }
  if (S::kQuery == kRows) {
    tq_tile = tq;
    tg_tile = tg;
  } else if (!encode_map(&tq_tile, a.q, a, a.sq, S::kQuery) ||
             !encode_map(&tg_tile, a.g, a, a.sg, S::kQuery)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (a.seq_len + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(a.batch) * a.heads * tiles;
  if (blocks * S::kWindows > 0x7fffffffLL) {
    return cudaErrorInvalidConfiguration;
  }
  static std::atomic<unsigned long long> smem_allowed{0}, dq_allowed{0};
  auto dkdv = flash_bwd_sm90_kernel<D, kDropout, O>;
  cudaError_t err = allow_dynamic_smem(dkdv, S::kSmem, smem_allowed);
  if (err != cudaSuccess) return err;
  dkdv<<<static_cast<unsigned int>(blocks * S::kWindows), kThreads, S::kSmem,
         a.stream>>>(
      tq_tile, tk, tv, tg_tile, a.lse, a.delta, static_cast<O*>(a.dk),
      static_cast<O*>(a.dv), a.bits, a.heads, a.seq_len, a.kdim, tiles,
      a.sdk, a.sdv, a.drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dq = flash_bwd_dq_sm90_kernel<D, kDropout>;
  err = allow_dynamic_smem(dq, S::kDqSmem, dq_allowed);
  if (err != cudaSuccess) return err;
  dq<<<static_cast<unsigned int>(blocks), kThreads, S::kDqSmem, a.stream>>>(
      tq, tk, tv, tg, a.lse, a.delta, a.dq, a.dq_bf16, a.bits, a.heads,
      a.seq_len, a.kdim, tiles, a.sdq, a.drop);
  return cudaGetLastError();
}

template <typename O, bool kDropout>
cudaError_t launch_dim(const Launch& a) {
  if (a.kdim <= 64) return launch_kernels<64, kDropout, O>(a);
  if (a.kdim <= 128) return launch_kernels<128, kDropout, O>(a);
  return launch_kernels<256, kDropout, O>(a);
}

}  // namespace

extern "C" {

// The arguments of flash_bwd_common.cuh's vtd_flash_attention_bwd, for
// bf16 (dtype 1) at head_dim K <= 256 with K % 8 == 0, except the tenth
// pointer: keep_bits, with dropout the (batch * heads, ceil(seq_len / 32),
// seq_len) uint32 workspace of the keep bits (the dk/dv kernel writes
// every word, the dq kernel reads them), else null. dkv_fp32 1 writes dk
// and dv in fp32 (a ring attention block), 0 in bf16; dq_bf16 1 writes dq
// in bf16, 0 in fp32, every element written. The instance is 64 for
// K <= 64, 128 for K <= 128, else 256; TMA zero-fills the columns past K.
// Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for what
// these kernels do not take (and when a tensor map cannot be encoded).
int vtd_flash_attention_bwd_sm90(const FlashBwdArgs* args, const void* q,
                                 const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta,
                                 void* dq, void* dk, void* dv,
                                 void* keep_bits, const unsigned int* seed,
                                 void* stream) {
  const FlashBwdArgs& p = *args;
  if (p.dtype != 1 || p.batch <= 0 || p.heads <= 0 || p.seq_len <= 0 ||
      p.head_dim <= 0 || p.head_dim > 256 || p.head_dim % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  if (p.dropout != 0 && (seed == nullptr || keep_bits == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (p.inner_local == 0) return cudaErrorInvalidValue;
  const Launch a{q, k, v, g, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dq, p.dq_bf16 != 0 ? 1 : 0,
                 dk, dv, static_cast<uint32_t*>(keep_bits), p.batch, p.heads,
                 p.seq_len, p.head_dim, strides_of<Strides>(p.strides, 0),
                 strides_of<Strides>(p.strides, 1),
                 strides_of<Strides>(p.strides, 2),
                 strides_of<Strides>(p.strides, 3),
                 strides_of<Strides>(p.strides, 4),
                 strides_of<Strides>(p.strides, 5),
                 strides_of<Strides>(p.strides, 6), dropout_of(p, seed),
                 static_cast<cudaStream_t>(stream)};
  const DeviceScope scope(p.device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaError_t err;
  if (p.dkv_fp32 != 0) {
    err = p.dropout != 0 ? launch_dim<float, true>(a)
                         : launch_dim<float, false>(a);
  } else {
    err = p.dropout != 0 ? launch_dim<bf16, true>(a)
                         : launch_dim<bf16, false>(a);
  }
  return static_cast<int>(err);
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
