// Flash-attention forward at wide heads for Hopper (sm_90a): fp32 at
// 64 < K <= 3072 on mma.sync (3xTF32) and bf16 at 256 < K <= 4096 on
// wgmma fed by TMA; bound to Python through a plain C interface
// (kernels/ops.py loads it with ctypes). Every forward route runs here at
// those widths: serving (B1), training with the logsumexp (B1-lse) and
// with dropout (B1-drop), and a ring attention block's resumed and
// suspended online-softmax state with an fp32 output. Narrower heads run
// flash_attention_fwd.cu (fp32 K <= 64) and flash_attention_fwd_sm90.cu
// (bf16 K <= 256); wider ones the windowed route of flash_attention_fwd.cu
// (kReachF32 and kReachBf16, flash_fwd_common.cuh).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// vision_transformer_detector_tpu/kernels/flash_attention.py (launched by
// `_flash_forward`) at those widths and computes what it computes
// (flash_attention_fwd.cu's header states the contract): fp32 scores,
// running max and normaliser, the normaliser summed over the undropped
// fp32 probabilities, P rounded to the input type before P V with fp32
// accumulation, lse = m + log(l), the keep mask of `dropout_keep_mask`
// (dropout_mask.cuh) at the global (batch*head, query, key) coordinates.
//
// What bounds it (one H100 SXM: 989 TFLOP/s bf16 and 495 TF32 dense,
// 3.35 TB/s): at (128, 256, 576) bf16 with lse, 19.3 GFLOP on 151 MB,
// bound by bytes at 0.045 ms; in fp32 at (128, 256, 512), 17.2 GFLOP done
// as 3xTF32 on 268 MB, bound by operations at 0.104 ms; at (128, 256, 80),
// 2.7 GFLOP, 0.016 ms. The windowed route this replaces past K 384 / 512
// formed S once per 128-column window of O (five times at K 576) and
// staged Q again with every key tile, about 7 times the bytes the function
// reads; the mma.sync 128 instance it replaces at fp32 K 65-128 was one
// CTA of 4 warps reloading and splitting Q's fragments at every tile.
//
// Design (one CTA per (batch*head, 64-query tile), 8 warps):
//   * O's columns are split between two halves of the CTA: two sets of 4
//     warps (fp32) or two warpgroups (bf16), each owning the output columns
//     of about half of the CTA's 32-column pairs (bf16: 64-column TMA
//     boxes) for the same 64 query rows; so each thread holds half of the
//     CTA's O accumulator (at most 96 registers in fp32, 128 in bf16);
//   * S is formed once per (query tile, key tile): each half multiplies Q
//     and K over its own columns only, writes its partial S to shared
//     memory, and adds the other half's to its own after one barrier;
//     s0 + s1 and s1 + s0 are the same fp32 sum, so both halves hold the
//     same S and run the same online softmax (max, exp, mask, normaliser),
//     each in registers, rather than one half waiting on the other for P;
//   * past one CTA's widest K (kWideMaxF32 384, kWideMaxBf16 512: Q, two
//     stages of K and V and the exchange fill its shared memory) a
//     thread-block cluster of ranks = ceil(K / kWideMax*) CTAs (at most
//     kClusterMax 8, launched with cudaLaunchKernelEx, a cluster's CTAs
//     neighbours in x) shares the columns: rank r holds a contiguous share
//     of K's units (fp32: an even split of the 32-column pairs; bf16:
//     ceil(boxes / ranks) boxes from box r * that, the last rank's boxes
//     past K zero-filled by TMA) and stages only those columns of Q (once),
//     K and V, so the cluster reads each byte of q, k and v from device
//     memory once. Each CTA writes its halves' parts of S into an exchange
//     slot of the tile's parity; after the cluster barrier (arrive with
//     release, wait with acquire) every thread reads the 2 * ranks parts
//     through distributed shared memory (mapa, ld.shared::cluster) and sums
//     them in one order, rank by rank and the first half's before the
//     second's, so every half of every CTA holds bit-identical S and the
//     max, normaliser, lse and dropout mask agree everywhere. Two parities
//     make one barrier a tile enough: a slot is rewritten two tiles later,
//     after every peer has passed the next barrier, which it reaches only
//     once its reads are done; a last barrier keeps every CTA resident
//     until its peers' reads are over. A cluster's CTA runs the one-CTA
//     body of its type (f32_cta, bf16_cta), with only the exchange, the
//     column offset and the writer of lse taken from its rank;
//   * Q is staged once per CTA, whole; K and V stream in tiles of 32 keys
//     (64 in fp32 one-CTA instances to K 256) through rings of two stages.
//     bf16: TMA boxes of 64 columns in the 128-byte swizzle, full and empty
//     mbarriers for K and for V, thread 0 issuing the copies; each
//     warpgroup issues S of tile i + 1 before tile i's P V, so the two
//     products run back to back. fp32: 16-byte cp.async copies into two
//     slots that alternate K and V, the V tile in flight while S is
//     formed, the next K tile while P V runs;
//   * bf16: each warpgroup's box count is fixed at compile time (instances
//     of 5-8 boxes a CTA, the first warpgroup the first ceil(boxes / 2)),
//     so its products carry no branch: S = Q K^T by wgmma m64n32k16 (both
//     operands K-major), P in registers as the A operand of one wgmma m64 x
//     64 mine x 16 a k-step over the warpgroup's boxes of V (an MN-major B
//     whose boxes lie a leading offset apart). fp32: mma.sync m16n8k8
//     3xTF32 (three TF32 products per fp32 product, mma_sm90.cuh), two
//     16-column groups a guarded step, each tile's P V summed in fresh
//     registers 32 columns at a time and added to O with one fp32 add (the
//     tile sums that keep O's long sum out of the truncating accumulator).
//     tf32 wgmma takes K-major operands only and would need V staged
//     transposed;
//   * fp32 at 64 < K <= 128 (the column halves): at most two pairs a half,
//     32-key tiles, two CTAs of 8 warps an SM at 128 registers a thread;
//   * columns past K are zero-filled by the copies (TMA's bounds, cp.async
//     with a zero source size) and never stored; in one CTA and in fp32
//     never multiplied past the pair (box) that holds K's last column.
//     Operands are read through the caller's strides, both layouts;
//   * the dropout mask, the epilogue and a ring block's state are
//     flash_fwd_common.cuh's, so the (B, H, N, 4) normaliser state is the
//     other forwards'; the first half (of rank 0) writes lse and the state.
//     Chained ring blocks whose boundaries fall on 32-key tiles are
//     bit-equal to one launch.
// As chip runs measured it (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6):
// bf16 at (128, 256, 320) with lse 0.073 ms (SDPA memory-efficient 0.092);
// fp32 at (128, 256, 192 / 256 / 320) 0.20 / 0.26 / 0.36 ms against
// SDPA's 0.20 / 0.23 / 0.30; the clusters at (128, 256, 576) bf16 0.24
// (SDPA 0.17) and (128, 256, 512) fp32 0.64 (SDPA 0.43); the column halves
// at (128, 256, 80) fp32 0.11 (SDPA 0.10).
// Budget (registers and spills: chip_smoke.py's build line, -Xptxas -v):
// shared memory, dynamic: fp32 Q and two slots of 64 and 2 x 32 rows of
// (32 * ceil(K / 32) + 4) floats plus the 16,384-byte S exchange, 215,040
// bytes at K 384; the halves 83,968 at K 128; a cluster's CTA Q and two
// 32-key slots at its share's width plus two parities of the exchange,
// 231,424 at K 3072; bf16 a 64 KB Q, two stages of 32 KB K and V tiles and
// a 32 KB exchange, 230,472 bytes, in one CTA or a cluster. One CTA an SM
// but the halves (two).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_fwd_common.cuh"
#include "flash_launch.cuh"
#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;         // queries a CTA
constexpr int kKeys = 32;         // keys a tile of the bf16 kernel
constexpr int kThreads = 256;     // two halves of 4 warps

// ---------------------------------------------------------------- fp32 ---

// Instances: the column halves at 64 < K <= 128 (two pairs a half, 32-key
// tiles, two CTAs an SM); 64-key tiles at K <= 256, where Q and two such
// slots fit in shared memory (at most 4 pairs a half); else 32-key tiles
// (to K 384, 6 pairs a half), which the cluster route takes too.
constexpr int kF32WideKeys = 256;
constexpr int kF32HalvesKeys = 32;
constexpr int kF32ClusterKeys = 32;

__host__ __device__ constexpr int f32_ld(int kdim) {
  return 32 * ((kdim + 31) / 32) + Mma<float>::kPad;
}

__host__ __device__ constexpr int f32_keys(int kdim) {
  return kdim <= kF32WideKeys ? 64 : 32;
}

// Q, two slots of a key tile and `parts` sets of the 8 warps' S parts
// (16 x keys each): one set in a CTA alone, two (by tile parity) in a
// cluster, whose peers read them a tile later.
__host__ __device__ constexpr int f32_smem(int ld, int keys, int parts) {
  return ((kRows + 2 * keys) * ld + parts * 8 * 16 * keys) * 4;
}

__host__ __device__ constexpr int f32_smem_bytes(int kdim) {
  return f32_smem(f32_ld(kdim), f32_keys(kdim), 1);
}
__host__ __device__ constexpr int f32_halves_smem(int kdim) {
  return f32_smem(f32_ld(kdim), kF32HalvesKeys, 1);
}

// The row stride of a cluster's tiles at K: each CTA holds at most
// ceil(pairs / ranks) 32-column pairs.
__host__ __device__ constexpr int f32_cluster_ld(int kdim) {
  return 32 * (((kdim + 31) / 32 + cluster_ranks(kdim, kWideMaxF32) - 1) /
               cluster_ranks(kdim, kWideMaxF32)) +
         Mma<float>::kPad;
}
__host__ __device__ constexpr int f32_cluster_smem(int kdim) {
  return f32_smem(f32_cluster_ld(kdim), kF32ClusterKeys, 2);
}

// Rows row0..row0+rows-1 of a (seq_len, kdim) head slice, columns
// col0..col0+width-1 (width = 32 * pairs), into a shared tile of row stride
// ld, with 16-byte cp.async copies; rows past seq_len and columns past kdim
// are zero-filled. Not committed here.
__device__ __forceinline__ void load_rows_f32(float* dst, int ld,
                                              const float* src,
                                              long long row_stride, int row0,
                                              int rows, int seq_len,
                                              int kdim, int col0, int width,
                                              int tid) {
  // c / per_row as a multiply-high by ceil(2^32 / per_row), exact for
  // c * per_row < 2^32 (c < 2^13 and per_row < 2^7 here): one integer
  // division a call instead of one a chunk (0.259 ms against 0.282-0.290
  // at (128, 256, 256), NVIDIA H100 80GB HBM3, 700 W, PERF.md §6).
  const unsigned int per_row = width / 4;
  const unsigned int magic = 0xffffffffu / per_row + 1u;
  for (unsigned int c = tid; c < rows * per_row; c += kThreads) {
    const int r = static_cast<int>(__umulhi(c, magic));
    const int col = static_cast<int>(c - r * per_row) * 4;
    const int row = row0 + r;
    const bool valid = row < seq_len && col < kdim - col0;
    cp_async16(dst + r * ld + col,
               src + (valid ? row * row_stride + col0 + col : 0), valid);
  }
}

// One CTA of the fp32 kernels: 64 queries, O's columns split between its
// two halves. kCluster: this CTA is rank r of a cluster of `ranks` and
// holds only its share of K's 32-column pairs (S summed over the cluster);
// else it holds all of K.
template <int kTileKeys, int kF32Pairs, bool kDropout, bool kCluster>
__device__ __forceinline__ void f32_cta(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        float* __restrict__ o, RowState state,
                                        int heads, int seq_len, int kdim,
                                        int q_tiles, Strides sq, Strides sk,
                                        Strides sv, Strides so, Dropout drop,
                                        int ranks) {
  using M = Mma<float>;
  int rank = 0, pairs = (kdim + 31) / 32, unit0 = 0, ld = f32_ld(kdim);
  if constexpr (kCluster) {
    // This CTA's share of the pairs: contiguous, ranks before `extra` one
    // more than the rest.
    rank = cluster_rank();
    const int base = pairs / ranks, extra = pairs % ranks;
    unit0 = rank * base + min(rank, extra);
    pairs = base + (rank < extra);
    ld = f32_cluster_ld(kdim);
  }
  const int width = 32 * pairs;
  const int cbase = 32 * unit0;     // this CTA's first column
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // kRows x ld
  float* k_s = q_s + kRows * ld;                      // kTileKeys x ld
  float* v_s = k_s + kTileKeys * ld;                  // kTileKeys x ld
  float* x_s = v_s + kTileKeys * ld;                  // the warps' S parts

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int side = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tile = kCluster ? blockIdx.x / ranks : blockIdx.x;
  const int bh = tile / q_tiles;
  const int q0 = (tile % q_tiles) * kRows;
  const int b = bh / heads;
  const int h = bh % heads;
  const int row0 = q0 + 16 * (warp & 3) + g;
  // This half's 32-column pairs of 16-column groups [first, first + mine)
  // and the output columns they cover, up to K. A pair is the unit of the
  // loops below, so that each guarded step holds two groups' independent
  // products; the group past K's last one in a pair multiplies zeros.
  const int split = (pairs + 1) / 2;
  const int first = side * split;
  const int mine = side ? pairs - split : split;
  const int col0 = cbase + 32 * first;
  const int col_end = min(kdim, cbase + 32 * (first + mine));
  const float* q_bh = q + b * sq.b + h * sq.h;
  const float* k_bh = k + b * sk.b + h * sk.h;
  const float* v_bh = v + b * sv.b + h * sv.h;
  const int tiles = (seq_len + kTileKeys - 1) / kTileKeys;

  load_rows_f32(q_s, ld, q_bh, sq.n, q0, kRows, seq_len, kdim, cbase, width,
                tid);
  load_rows_f32(k_s, ld, k_bh, sk.n, 0, kTileKeys, seq_len, kdim, cbase,
                width, tid);
  cp_async_commit();

  float acc[4 * kF32Pairs][4];
#pragma unroll
  for (int j = 0; j < 4 * kF32Pairs; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};
  if (state.m_in != nullptr) {
    resume_state<4 * kF32Pairs>(acc, m_row, l_row, state,
                                 state.acc_in + b * so.b + h * so.h, so.n,
                                 bh, row0, seq_len, col0, col_end, t);
  }
  unsigned int hash_row[2];
  row_hashes<kDropout>(hash_row, drop, bh, row0);
  float* x_mine = x_s + warp * 16 * kTileKeys;
  const float* x_other = x_s + (warp ^ 4) * 16 * kTileKeys;

  for (int it = 0; it < tiles; ++it) {
    const int kv0 = it * kTileKeys;
    // K tile it (and, at it 0, Q) has landed, and every warp is done with
    // the V slot: V tile it goes into it while S is formed.
    cp_async_wait<0>();
    __syncthreads();
    load_rows_f32(v_s, ld, v_bh, sv.n, kv0, kTileKeys, seq_len, kdim, cbase,
                  width, tid);
    cp_async_commit();

    // This half's part of S = Q K^T: 16 rows x kTileKeys keys a warp.
    float s[kTileKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kTileKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kF32Pairs; ++i) {
      if (i < mine) {
#pragma unroll
        for (int gg = 0; gg < 2; ++gg) {
          const int k0 = 32 * (first + i) + 16 * gg;
          typename M::A a;
          M::load_a(a, q_s, ld, 16 * (warp & 3), k0, lane);
#pragma unroll
          for (int np = 0; np < kTileKeys / 16; ++np) {
            typename M::B b0, b1;
            M::load_b_nk(b0, b1, k_s, ld, 16 * np, k0, lane);
            M::mma(s[2 * np], a, b0);
            M::mma(s[2 * np + 1], a, b1);
          }
        }
      }
    }
    if constexpr (kCluster) {
      // Every part of the cluster is written (and every warp here is done
      // with the K slot) once the cluster barrier's phase completes.
      put_part<32>(s, x_s, (it & 1) * 8 + warp, lane);
      cluster_arrive();
      cluster_wait();
    } else {
#pragma unroll
      for (int j = 0; j < kTileKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x_mine[(4 * j + e) * 32 + lane] = s[j][e];
      }
      // The other half's part is written, and every warp is done with the
      // K slot: K tile it + 1 goes into it while the softmax and P V run.
      __syncthreads();
    }
    if (it + 1 < tiles) {
      load_rows_f32(k_s, ld, k_bh, sk.n, kv0 + kTileKeys, kTileKeys, seq_len,
                    kdim, cbase, width, tid);
      cp_async_commit();
    }
    if constexpr (kCluster) {
      sum_parts<32>(s, smem_u32(x_s), (it & 1) * 8 + (warp & 3), 4, lane,
                    ranks);
    } else {
#pragma unroll
      for (int j = 0; j < kTileKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += x_other[(4 * j + e) * 32 + lane];
        }
      }
    }
    softmax_step<kDropout>(s, acc, m_row, l_row, hash_row, kv0, seq_len, t,
                           drop);
    // P's A fragments (3xTF32 hi and lo), once for all column groups.
    typename M::A pa[kTileKeys / 16];
#pragma unroll
    for (int kc = 0; kc < kTileKeys / 16; ++kc) {
      M::acc_to_a(pa[kc], s[2 * kc], s[2 * kc + 1]);
    }
    if (it + 1 < tiles) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // V tile it has landed
    // O += P V over this half's columns, each 32-column pair's tile sum
    // in fresh registers.
#pragma unroll
    for (int i = 0; i < kF32Pairs; ++i) {
      if (i < mine) {
        float part[4][4] = {};
#pragma unroll
        for (int kc = 0; kc < kTileKeys / 16; ++kc) {
#pragma unroll
          for (int gg = 0; gg < 2; ++gg) {
            typename M::B b0, b1;
            M::load_b_kn(b0, b1, v_s, ld, 16 * kc, 32 * (first + i) + 16 * gg,
                         lane);
            M::mma(part[2 * gg], pa[kc], b0);
            M::mma(part[2 * gg + 1], pa[kc], b1);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * i + j][e] += part[j][e];
        }
      }
    }
  }
  if constexpr (kCluster) {
    // No CTA leaves while a peer may still read its last parts.
    cluster_arrive();
    cluster_wait();
  }
  store_output<4 * kF32Pairs>(acc, m_row, l_row, state,
                               o + b * so.b + h * so.h, so.n, bh, row0,
                               seq_len, col0, col_end, t,
                               side == 0 && rank == 0);
}

#define VTD_F32_PARAMS                                                     \
  const float* __restrict__ q, const float* __restrict__ k,                \
      const float* __restrict__ v, float* __restrict__ o, RowState state, \
      int heads, int seq_len, int kdim, int q_tiles, Strides sq,          \
      Strides sk, Strides sv, Strides so, Dropout drop, int ranks
#define VTD_F32_ARGS \
  q, k, v, o, state, heads, seq_len, kdim, q_tiles, sq, sk, sv, so, drop, ranks

// 128 < K <= 384: one CTA holds all of K.
template <int kTileKeys, int kF32Pairs, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_f32_kernel(VTD_F32_PARAMS) {
  f32_cta<kTileKeys, kF32Pairs, kDropout, false>(VTD_F32_ARGS);
}

// 64 < K <= 128, the column halves: two pairs a half at most, 32-key
// tiles, two CTAs an SM (at most 128 registers a thread, 83,968 bytes of
// shared memory a CTA at K 128), Q's fragments loaded from shared memory
// and split at every tile. 64-key tiles with each half's fragments of Q
// held in registers (64 of them beside O's 32), one CTA an SM, were 1-5 %
// slower (PERF.md §6).
template <bool kDropout>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_halves_kernel(VTD_F32_PARAMS) {
  f32_cta<kF32HalvesKeys, 2, kDropout, false>(VTD_F32_ARGS);
}

// 384 < K <= 3072: a cluster of `ranks` CTAs, each holding at most 12
// pairs (6 a half), 32-key tiles.
template <bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_cluster_f32_kernel(VTD_F32_PARAMS) {
  f32_cta<kF32ClusterKeys, kWideMaxF32 / 64, kDropout, true>(VTD_F32_ARGS);
}

// ---------------------------------------------------------------- bf16 ---

constexpr int kBoxes = kWideMaxBf16 / 64;        // 64-column boxes of K
constexpr int kQBytes = kBoxes * kRows * 128;
constexpr int kTileBytes = kBoxes * kKeys * 128;
constexpr int kStages = 2;
constexpr int kExchangeBytes = 2 * 2 * 128 * (kKeys / 2) * 4;
constexpr int kBarriers = 1 + 4 * kStages;
constexpr int kBf16Smem = 1024 + kQBytes + 2 * kStages * kTileBytes +
                          kExchangeBytes + 8 * kBarriers;

// The shared-memory layout and the barriers of one CTA: Q's boxes, K and V
// tiles of kKeys keys in kStages stages each, the S exchange (two buffers
// by tile parity, a warpgroup's part each) and, per stage, full barriers
// for K and V (the copies' bytes) and empty ones (both warpgroups done
// with K after its S, with V after its P V).
struct Bf16Smem {
  uint32_t q, k, v, bars, xs;
  float* x;
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t k_full(int st) const { return bars + 8u * (1 + st); }
  __device__ uint32_t v_full(int st) const {
    return bars + 8u * (1 + kStages + st);
  }
  __device__ uint32_t k_empty(int st) const {
    return bars + 8u * (1 + 2 * kStages + st);
  }
  __device__ uint32_t v_empty(int st) const {
    return bars + 8u * (1 + 3 * kStages + st);
  }
};

// The copies, each issued by thread 0 into stage j % kStages once both
// warpgroups have freed it: K tile j and V tile j, every live box of this
// CTA (the boxes of K from box0).
__device__ __forceinline__ void load_k(const Bf16Smem& sm,
                                       const CUtensorMap* tk, int j,
                                       int boxes, int box0, int h, int b) {
  const int st = j % kStages;
  if (j >= kStages) mbar_wait(sm.k_empty(st), ((j / kStages) & 1) ^ 1);
  mbar_expect_tx(sm.k_full(st), boxes * kKeys * 128);
  for (int a = 0; a < boxes; ++a) {
    tma_load(sm.k + st * kTileBytes + a * kKeys * 128, tk, sm.k_full(st),
             64 * (box0 + a), j * kKeys, h, b);
  }
}

__device__ __forceinline__ void load_v(const Bf16Smem& sm,
                                       const CUtensorMap* tv, int j,
                                       int boxes, int box0, int h, int b) {
  const int st = j % kStages;
  if (j >= kStages) mbar_wait(sm.v_empty(st), ((j / kStages) & 1) ^ 1);
  mbar_expect_tx(sm.v_full(st), boxes * kKeys * 128);
  for (int a = 0; a < boxes; ++a) {
    tma_load(sm.v + st * kTileBytes + a * kKeys * 128, tv, sm.v_full(st),
             64 * (box0 + a), j * kKeys, h, b);
  }
}

// This warpgroup's part of S = Q K^T for key tile j, over its kMine boxes
// from kFirst: issued, not waited for.
template <int kMine, int kFirst>
__device__ __forceinline__ void s_part(float (&s)[kKeys / 8][4],
                                       const Bf16Smem& sm, int j) {
  const uint32_t k_t = sm.k + (j % kStages) * kTileBytes;
  mbar_wait(sm.k_full(j % kStages), (j / kStages) & 1);
  clear(s);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss<kKeys>(
          s, kmajor_desc(sm.q + (kFirst + i) * kRows * 128 + kk * 32),
          kmajor_desc(k_t + (kFirst + i) * kKeys * 128 + kk * 32),
          (i | kk) != 0);
    }
  }
  wgmma_commit();
}

// The parts of S for key tile j meet. In one CTA: this warpgroup's part
// goes into the exchange buffer of the tile's parity, both warpgroups wait
// at one named barrier (both run this once a tile), and each adds the
// other's part to its own, so both hold the same S (s0 + s1 = s1 + s0 in
// fp32). In a cluster: the part goes into this CTA's slot of the tile's
// parity, and after the cluster barrier every thread sums the cluster's
// 2 * ranks parts in sum_parts' one order.
template <bool kCluster>
__device__ __forceinline__ void exchange_s(float (&s)[kKeys / 8][4],
                                           const Bf16Smem& sm, int j,
                                           int group, int slot, int ranks) {
  if constexpr (kCluster) {
    put_part<128>(s, sm.x, (j & 1) * 2 + group, slot);
    cluster_arrive();
    cluster_wait();
    sum_parts<128>(s, sm.xs, (j & 1) * 2, 1, slot, ranks);
    return;
  }
  float* x_tile = sm.x + (j & 1) * 2 * 128 * (kKeys / 2);
  float* x_mine = x_tile + group * 128 * (kKeys / 2);
  const float* x_other = x_tile + (group ^ 1) * 128 * (kKeys / 2);
#pragma unroll
  for (int j8 = 0; j8 < kKeys / 8; ++j8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x_mine[(4 * j8 + e) * 128 + slot] = s[j8][e];
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
  for (int j8 = 0; j8 < kKeys / 8; ++j8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j8][e] += x_other[(4 * j8 + e) * 128 + slot];
  }
}

// One warpgroup's whole loop: the query rows row0, row0 + 8 of this lane,
// O's columns of this CTA's boxes kFirst..kFirst + kMine - 1 (K's boxes
// box0 + kFirst..; box0 0 in one CTA). Pipelined: S of key tile it + 1 is
// in flight while tile it's softmax runs, tile it's P V while tile it + 1's
// parts meet. `lead`: this warpgroup writes lse and the ring state.
template <int kMine, int kFirst, bool kDropout, bool kCluster, typename O>
__device__ __forceinline__ void bf16_rows(
    const Bf16Smem& sm, const CUtensorMap* tk, const CUtensorMap* tv,
    O* o_bh, RowState state, const float* acc_in_bh, long long o_sn,
    int bh, int b, int h, int q0, int seq_len, int kdim, int boxes,
    int box0, int ranks, bool lead, int tiles, int tid, Dropout drop) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = kFirst == 0 ? 0 : 1;
  const int t = lane & 3;
  // Both warpgroups hold the same 64 query rows: warp w % 4 rows
  // 16 (w % 4).., this lane rows q_row0 and q_row0 + 8.
  const int q_row0 = q0 + 16 * (warp & 3) + (lane >> 2);
  const int slot = tid & 127;
  const int col0 = 64 * (box0 + kFirst);
  const int col_end = min(kdim, 64 * (box0 + kFirst + kMine));
  float acc[8 * kMine][4];
#pragma unroll
  for (int j = 0; j < 8 * kMine; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};
  if (state.m_in != nullptr) {
    resume_state<8 * kMine>(acc, m_row, l_row, state, acc_in_bh, o_sn, bh,
                            q_row0, seq_len, col0, col_end, t);
  }
  unsigned int hash_row[2];
  row_hashes<kDropout>(hash_row, drop, bh, q_row0);

  // S of tile it + 1 is issued before tile it's P V, so the two products
  // run back to back; then both are waited for together. (Waiting for S
  // alone with P V in flight, to overlap the exchange and the softmax with
  // it, made ptxas serialise every product of the kernel: 0.085 ms against
  // 0.074 at (128, 256, 320), NVIDIA H100 80GB HBM3, 700 W; in a cluster,
  // where the exchange crosses CTAs, that order measured the same as this
  // one at (128, 256, 576), PERF.md §6.)
  float s[kKeys / 8][4], alpha[2];
  uint32_t p[kKeys / 16][4];
  auto scores = [&](int it) {
    softmax_scores<kDropout>(s, alpha, m_row, l_row, hash_row, it * kKeys,
                             seq_len, t, drop);
    rescale(acc, alpha);
    // P rounded to bf16: the S accumulator's pairs are the A fragments.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };
  mbar_wait(sm.q_full(), 0);
  s_part<kMine, kFirst>(s, sm, 0);
  wgmma_wait_all();
  fence_operands(s);
  mbar_arrive(sm.k_empty(0));
  exchange_s<kCluster>(s, sm, 0, group, slot, ranks);
  scores(0);
  for (int it = 0; it < tiles; ++it) {
    if (tid == 0) {
      if (it + 2 < tiles) load_k(sm, tk, it + 2, boxes, box0, h, b);
      if (it + 1 < tiles) load_v(sm, tv, it + 1, boxes, box0, h, b);
    }
    __syncwarp();
    const bool next = it + 1 < tiles;
    if (next) s_part<kMine, kFirst>(s, sm, it + 1);
    // O += P V over this warpgroup's boxes in one product a k-step (they
    // lie kKeys * 128 bytes apart, the descriptor's leading offset).
    const int st = it % kStages;
    mbar_wait(sm.v_full(st), (it / kStages) & 1);
    fence_operands(acc);
    fence_operands(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_rs<64 * kMine>(
          acc, p[kk],
          mnmajor_desc(sm.v + st * kTileBytes + kFirst * kKeys * 128 +
                           kk * 16 * 128,
                       kKeys * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    fence_operands(p);
    fence_operands(s);
    mbar_arrive(sm.v_empty(st));
    if (next) {
      mbar_arrive(sm.k_empty((it + 1) % kStages));
      exchange_s<kCluster>(s, sm, it + 1, group, slot, ranks);
      scores(it + 1);
    }
  }
  if constexpr (kCluster) {
    // No CTA leaves while a peer may still read its last parts.
    cluster_arrive();
    cluster_wait();
  }
  store_output<8 * kMine>(acc, m_row, l_row, state, o_bh, o_sn, bh, q_row0,
                          seq_len, col0, col_end, t, lead && group == 0);
}

// One CTA of the bf16 kernels: kBoxesT 64-column boxes (5..8), the first
// warpgroup owning the first ceil(kBoxesT / 2), the second the rest.
// kCluster: this CTA is rank r of a cluster of `ranks` and holds K's boxes
// r * kBoxesT.., staged alone: Q once, K and V tiles by TMA from its first
// column, so that the cluster reads each byte of q, k and v once. Columns
// past K are zero-filled by TMA in the last rank's last boxes (at most
// ranks - 1 of them wholly past K: a share of kBoxesT - 1 boxes would cost
// a second body of the kernel and save no time, since every tile waits at
// the cluster barrier for the ranks of kBoxesT), and nothing is stored
// past K.
template <int kBoxesT, bool kDropout, typename O, bool kCluster>
__device__ __forceinline__ void bf16_cta(const CUtensorMap& tq,
                                         const CUtensorMap& tk,
                                         const CUtensorMap& tv, O* o,
                                         RowState state, int heads,
                                         int seq_len, int kdim, int q_tiles,
                                         Strides so, Dropout drop,
                                         int ranks) {
  constexpr int kSplit = (kBoxesT + 1) / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Every box starts on a 1,024-byte boundary, as the swizzle needs.
  Bf16Smem sm;
  sm.q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  sm.k = sm.q + kQBytes;
  sm.v = sm.k + kStages * kTileBytes;
  const uint32_t x_u = sm.v + kStages * kTileBytes;
  sm.bars = x_u + kExchangeBytes;
  sm.xs = x_u;
  sm.x = reinterpret_cast<float*>(smem_raw + (x_u - smem_u32(smem_raw)));

  const int rank = kCluster ? cluster_rank() : 0;
  const int box0 = rank * kBoxesT;
  const int tid = threadIdx.x;
  const int tile = kCluster ? blockIdx.x / ranks : blockIdx.x;
  const int bh = tile / q_tiles;
  const int q0 = (tile % q_tiles) * kRows;
  const int b = bh / heads;
  const int h = bh % heads;
  const int tiles = (seq_len + kKeys - 1) / kKeys;

  if (tid == 0) {
    mbar_init(sm.q_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.k_full(st), 1);
      mbar_init(sm.v_full(st), 1);
      mbar_init(sm.k_empty(st), kThreads);
      mbar_init(sm.v_empty(st), kThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sm.q_full(), kBoxesT * kRows * 128);
    for (int a = 0; a < kBoxesT; ++a) {
      tma_load(sm.q + a * kRows * 128, &tq, sm.q_full(), 64 * (box0 + a), q0,
               h, b);
    }
    load_k(sm, &tk, 0, kBoxesT, box0, h, b);
    if (tiles > 1) load_k(sm, &tk, 1, kBoxesT, box0, h, b);
    load_v(sm, &tv, 0, kBoxesT, box0, h, b);
  }
  O* o_bh = o + b * so.b + h * so.h;
  const float* acc_in_bh =
      state.m_in != nullptr ? state.acc_in + b * so.b + h * so.h : nullptr;
  if (tid < 128) {
    bf16_rows<kSplit, 0, kDropout, kCluster>(
        sm, &tk, &tv, o_bh, state, acc_in_bh, so.n, bh, b, h, q0, seq_len,
        kdim, kBoxesT, box0, ranks, rank == 0, tiles, tid, drop);
  } else {
    bf16_rows<kBoxesT - kSplit, kSplit, kDropout, kCluster>(
        sm, &tk, &tv, o_bh, state, acc_in_bh, so.n, bh, b, h, q0, seq_len,
        kdim, kBoxesT, box0, ranks, rank == 0, tiles, tid, drop);
  }
}

#define VTD_BF16_PARAMS                                                     \
  const __grid_constant__ CUtensorMap tq,                                   \
      const __grid_constant__ CUtensorMap tk,                               \
      const __grid_constant__ CUtensorMap tv, O* __restrict__ o,            \
      RowState state, int heads, int seq_len, int kdim, int q_tiles,        \
      Strides so, Dropout drop, int ranks
#define VTD_BF16_ARGS \
  tq, tk, tv, o, state, heads, seq_len, kdim, q_tiles, so, drop, ranks

// 256 < K <= 512: one CTA holds all of K (ranks 1).
template <int kBoxesT, bool kDropout, typename O>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_bf16_kernel(VTD_BF16_PARAMS) {
  bf16_cta<kBoxesT, kDropout, O, false>(VTD_BF16_ARGS);
}

// 512 < K <= 4096: a cluster of `ranks` CTAs of kBoxesT =
// ceil(boxes of K / ranks) boxes each.
template <int kBoxesT, bool kDropout, typename O>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_cluster_bf16_kernel(VTD_BF16_PARAMS) {
  bf16_cta<kBoxesT, kDropout, O, true>(VTD_BF16_ARGS);
}

// ------------------------------------------------------------- launch ---

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

// The grid: one CTA per (batch*head, 64-query tile) and cluster rank; a
// cluster's CTAs are neighbours in x.
inline cudaError_t grid_of(const Launch& a, int ranks, int* q_tiles,
                           unsigned int* blocks) {
  *q_tiles = (a.seq_len + kRows - 1) / kRows;
  const long long n =
      static_cast<long long>(a.batch) * a.heads * *q_tiles * ranks;
  if (n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *blocks = static_cast<unsigned int>(n);
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t run_f32(Kernel kernel, int smem, int ranks, const Launch& a,
                    const Ask& ask) {
  if (ask.query) {
    return resident_clusters(kernel, kThreads, ranks, smem, ask.resident);
  }
  int q_tiles;
  unsigned int blocks;
  cudaError_t err = grid_of(a, ranks, &q_tiles, &blocks);
  if (err != cudaSuccess) return err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);
  if (ranks > 1) {
    return run_cluster(kernel, kThreads, blocks, ranks, smem, a.stream, q,
                       k, v, o, a.state, a.heads, a.seq_len, a.kdim, q_tiles,
                       a.sq, a.sk, a.sv, a.so, a.drop, ranks);
  }
  kernel<<<blocks, kThreads, smem, a.stream>>>(
      q, k, v, o, a.state, a.heads, a.seq_len, a.kdim, q_tiles, a.sq, a.sk,
      a.sv, a.so, a.drop, 1);
  return cudaGetLastError();
}

// The fp32 instance of K: the column halves to K 128, 64-key tiles to
// K 256, 32-key tiles to K 384 and the cluster past it. The dynamic
// shared-memory limit is raised once per device at the instance's widest K.
template <bool kDropout>
cudaError_t launch_f32(const Launch& a, const Ask& ask) {
  if (a.kdim <= 128) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = flash_fwd_halves_kernel<kDropout>;
    cudaError_t err = allow_dynamic_smem(kernel, f32_halves_smem(128), allowed);
    if (err != cudaSuccess) return err;
    return run_f32(kernel, f32_halves_smem(a.kdim), 1, a, ask);
  }
  if (a.kdim <= kF32WideKeys) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = flash_fwd_wide_f32_kernel<64, kF32WideKeys / 64, kDropout>;
    cudaError_t err =
        allow_dynamic_smem(kernel, f32_smem_bytes(kF32WideKeys), allowed);
    if (err != cudaSuccess) return err;
    return run_f32(kernel, f32_smem_bytes(a.kdim), 1, a, ask);
  }
  if (a.kdim <= kWideMaxF32) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = flash_fwd_wide_f32_kernel<32, kWideMaxF32 / 64, kDropout>;
    cudaError_t err =
        allow_dynamic_smem(kernel, f32_smem_bytes(kWideMaxF32), allowed);
    if (err != cudaSuccess) return err;
    return run_f32(kernel, f32_smem_bytes(a.kdim), 1, a, ask);
  }
  static std::atomic<unsigned long long> allowed{0};
  auto kernel = flash_fwd_cluster_f32_kernel<kDropout>;
  cudaError_t err =
      allow_dynamic_smem(kernel, f32_cluster_smem(kReachF32), allowed);
  if (err != cudaSuccess) return err;
  return run_f32(kernel, f32_cluster_smem(a.kdim),
                 cluster_ranks(a.kdim, kWideMaxF32), a, ask);
}

// bf16 at K <= 512 (one CTA of kBoxesT boxes: 5 to 8) or past it (a
// cluster of CTAs of at most kBoxesT boxes).
template <int kBoxesT, bool kDropout, typename O, bool kCluster>
cudaError_t launch_bf16_boxes(const Launch& a, const Ask& ask) {
  static std::atomic<unsigned long long> smem_allowed{0};
  auto kernel = flash_fwd_wide_bf16_kernel<kBoxesT, kDropout, O>;
  if constexpr (kCluster) {
    kernel = flash_fwd_cluster_bf16_kernel<kBoxesT, kDropout, O>;
  }
  cudaError_t err = allow_dynamic_smem(kernel, kBf16Smem, smem_allowed);
  if (err != cudaSuccess) return err;
  const int ranks = kCluster ? cluster_ranks(a.kdim, kWideMaxBf16) : 1;
  if (ask.query) {
    return resident_clusters(kernel, kThreads, ranks, kBf16Smem,
                             ask.resident);
  }
  int q_tiles;
  unsigned int blocks;
  err = grid_of(a, ranks, &q_tiles, &blocks);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, a.q, a.kdim, a.seq_len, a.heads, a.batch, a.sq.b, a.sq.h,
              a.sq.n, kRows) ||
      !encode(&tk, a.k, a.kdim, a.seq_len, a.heads, a.batch, a.sk.b, a.sk.h,
              a.sk.n, kKeys) ||
      !encode(&tv, a.v, a.kdim, a.seq_len, a.heads, a.batch, a.sv.b, a.sv.h,
              a.sv.n, kKeys)) {
    return cudaErrorInvalidValue;
  }
  O* o = static_cast<O*>(a.o);
  if constexpr (kCluster) {
    return run_cluster(kernel, kThreads, blocks, ranks, kBf16Smem, a.stream,
                       tq, tk, tv, o, a.state, a.heads, a.seq_len, a.kdim,
                       q_tiles, a.so, a.drop, ranks);
  }
  kernel<<<blocks, kThreads, kBf16Smem, a.stream>>>(
      tq, tk, tv, o, a.state, a.heads, a.seq_len, a.kdim, q_tiles, a.so,
      a.drop, 1);
  return cudaGetLastError();
}

// The instance of K: the boxes that hold it, 5 (256 < K <= 320) to 8, or
// past 512 a cluster whose CTAs hold at most ceil(boxes / ranks) of them.
template <bool kDropout, typename O>
cudaError_t launch_bf16(const Launch& a, const Ask& ask) {
  const int boxes = (a.kdim + 63) / 64;
  if (a.kdim > kWideMaxBf16) {
    const int ranks = cluster_ranks(a.kdim, kWideMaxBf16);
    switch ((boxes + ranks - 1) / ranks) {
      case 5: return launch_bf16_boxes<5, kDropout, O, true>(a, ask);
      case 6: return launch_bf16_boxes<6, kDropout, O, true>(a, ask);
      case 7: return launch_bf16_boxes<7, kDropout, O, true>(a, ask);
      case 8: return launch_bf16_boxes<8, kDropout, O, true>(a, ask);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (boxes) {
    case 5: return launch_bf16_boxes<5, kDropout, O, false>(a, ask);
    case 6: return launch_bf16_boxes<6, kDropout, O, false>(a, ask);
    case 7: return launch_bf16_boxes<7, kDropout, O, false>(a, ask);
    case 8: return launch_bf16_boxes<8, kDropout, O, false>(a, ask);
    default: return cudaErrorInvalidValue;
  }
}

// The checks of both entry points on an argument block.
inline bool takes(const FlashFwdArgs& p) {
  if ((p.dtype != 0 && p.dtype != 1) || p.batch <= 0 || p.heads <= 0 ||
      p.seq_len <= 0 || p.inner_local == 0) {
    return false;
  }
  return p.dtype == 0 ? p.head_dim > 64 && p.head_dim <= kReachF32 &&
                            p.head_dim % 4 == 0
                      : p.head_dim > 256 && p.head_dim <= kReachBf16 &&
                            p.head_dim % 8 == 0;
}

inline cudaError_t dispatch(const FlashFwdArgs& p, const Launch& a,
                            const Ask& ask) {
  const bool dropout = p.dropout != 0;
  if (p.dtype == 0) {
    return dropout ? launch_f32<true>(a, ask) : launch_f32<false>(a, ask);
  }
  if (p.out_fp32 != 0) {
    return dropout ? launch_bf16<true, float>(a, ask)
                   : launch_bf16<false, float>(a, ask);
  }
  return dropout ? launch_bf16<true, bf16>(a, ask)
                 : launch_bf16<false, bf16>(a, ask);
}

}  // namespace

extern "C" {

// The arguments of flash_attention_fwd.cu's vtd_flash_attention_fwd, for
// fp32 (dtype 0) at 64 < K <= 3072 with K % 4 == 0, or bf16 (dtype 1) at
// 256 < K <= 4096 with K % 8 == 0 (out_fp32 1 writes a bf16 call's output
// in fp32: a ring attention block); the workspace, the windowed route's,
// is not read. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for what this kernel does not take (and
// when a tensor map cannot be encoded).
int vtd_flash_attention_fwd_wide(const FlashFwdArgs* args, const void* q,
                                 const void* k, const void* v, void* o,
                                 void* lse, const void* m_in,
                                 const void* l_in, const void* acc_in,
                                 void* m_out, void* l_out,
                                 void* /*workspace*/,
                                 const unsigned int* seed, void* stream) {
  const FlashFwdArgs& p = *args;
  if (!takes(p)) return cudaErrorInvalidValue;
  if (p.dropout != 0 && seed == nullptr) return cudaErrorInvalidValue;
  const RowState state{static_cast<float*>(lse),
                       static_cast<const float*>(m_in),
                       static_cast<const float*>(l_in),
                       static_cast<const float*>(acc_in),
                       static_cast<float*>(m_out),
                       static_cast<float*>(l_out)};
  if (!state_ok(state, p.dtype == 0 || p.out_fp32 != 0)) {
    return cudaErrorInvalidValue;
  }
  const Launch a{q, k, v, o, state, p.batch, p.heads, p.seq_len, p.head_dim,
                 strides_of<Strides>(p.strides, 0),
                 strides_of<Strides>(p.strides, 1),
                 strides_of<Strides>(p.strides, 2),
                 strides_of<Strides>(p.strides, 3), dropout_of(p, seed),
                 static_cast<cudaStream_t>(stream)};
  const DeviceScope scope(p.device);
  if (scope.error() != cudaSuccess) return scope.error();
  return static_cast<int>(dispatch(p, a, kLaunch));
}

// The plan's question for a block of the cluster route (fp32 past K 384,
// bf16 past K 512): how many clusters of its instance can be resident on
// args->device at once (cudaOccupancyMaxActiveClusters, with the dynamic
// shared memory it takes), 1 for a block that runs no cluster, or minus a
// CUDA error code.
int vtd_flash_attention_fwd_wide_clusters(const FlashFwdArgs* args) {
  const FlashFwdArgs& p = *args;
  if (!takes(p)) return -static_cast<int>(cudaErrorInvalidValue);
  if (p.head_dim <= (p.dtype == 0 ? kWideMaxF32 : kWideMaxBf16)) return 1;
  const Launch a{nullptr, nullptr, nullptr, nullptr,
                 RowState{},
                 p.batch, p.heads, p.seq_len, p.head_dim,
                 strides_of<Strides>(p.strides, 0),
                 strides_of<Strides>(p.strides, 1),
                 strides_of<Strides>(p.strides, 2),
                 strides_of<Strides>(p.strides, 3), dropout_of(p, nullptr),
                 nullptr};
  const DeviceScope scope(p.device);
  if (scope.error() != cudaSuccess) return -static_cast<int>(scope.error());
  int resident = 0;
  const cudaError_t err = dispatch(p, a, Ask{true, &resident});
  return err == cudaSuccess ? resident : -static_cast<int>(err);
}

// The dynamic shared memory a launch takes: fp32 (dtype 0) at head_dim,
// or bf16 (dtype 1) at any K it takes.
int vtd_flash_attention_fwd_wide_smem(int dtype, int head_dim) {
  if (dtype != 0) return kBf16Smem;
  return head_dim <= 128           ? f32_halves_smem(head_dim)
         : head_dim <= kWideMaxF32 ? f32_smem_bytes(head_dim)
                                   : f32_cluster_smem(head_dim);
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
