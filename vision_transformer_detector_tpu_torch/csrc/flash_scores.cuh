// The scores of the windowed flash routes (flash_attention_fwd.cu past the
// forward's clusters, flash_attention_bwd_wide.cu past the backward's):
// S = q k^T, and in the backward also dP = g v^T, of one (64-query tile,
// 64-key tile) pair over the whole head dim K, formed once, for a kernel
// that parks them in a device workspace. The windowed kernels that follow
// read the workspace instead of forming S again in every output window.
//
// A tile pair's products come out in the accumulator layout of
// flash_fwd_common.cuh (mma.sync's m16n8 tiles, warp by warp, which is
// wgmma's m64n64 accumulator too): warp w owns query rows 16w..16w+15, a
// lane rows g and g + 8 (g = lane / 4) and, in each 8-key tile j, keys
// 8j + 2t and 8j + 2t + 1 (t = lane % 4). The caller's epilogue reads them
// there.
//
//   * fp32, scores_f32: 4 warps on mma.sync 3xTF32, K in 64-column chunks
//     staged by 16-byte cp.async through two buffers (rows past seq_len and
//     columns past K zero-filled); each chunk's product summed in fresh
//     registers and added with one fp32 add, as the forward's tile sums are
//     (mma_sm90.cuh): carried through every chunk in the truncating mma
//     accumulator, lse drifted 3.4e-5 at K 3104 against a 2e-5 tolerance.
//   * bf16, scores_bf16: one warpgroup on wgmma m64n64k16 fed by TMA, both
//     operands K-major 64 x 64 boxes in the 128-byte swizzle (sm90_common.cuh),
//     kStages stages of the kPairs' boxes in flight; thread 0 refills a
//     stage once every thread's products have read it. TMA zero-fills rows
//     past seq_len and columns past K.
// Nothing is summed across CTAs: each tile pair is one CTA's, so S is the
// same wherever the pair lies (a ring attention block's launch forms the
// same S for the same rows as one launch over the whole sequence).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sm90.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kScoreTile = 64;       // queries and keys of a tile pair
constexpr int kScoreThreads = 128;   // 4 warps / one warpgroup
constexpr int kScoreChunk = 64;      // fp32: head-dim columns a stage
constexpr int kScoreBox = 64 * 128;  // bf16: bytes of a 64 x 64 TMA box

// bf16: the stages in flight, kPairs boxes of A and of B each (16 KB for
// S alone, 32 KB for S and dP): 64 KB and 96 KB, so three and two CTAs an
// SM.
template <int kPairs>
constexpr int kScoreStages = kPairs == 1 ? 4 : 3;

// Dynamic shared memory: fp32 two buffers of kPairs (A, B) tiles of 64 x
// (64 + 4) floats; bf16 1,024 bytes of swizzle alignment, the stages and
// one barrier each.
template <int kPairs>
constexpr int scores_f32_smem() {
  return 2 * 2 * kPairs * kScoreTile * (kScoreChunk + Mma<float>::kPad) * 4;
}
template <int kPairs>
constexpr int scores_bf16_smem() {
  return 1024 + kScoreStages<kPairs> * (2 * kPairs * kScoreBox + 8);
}

template <int kPairs>
__device__ __forceinline__ void clear_scores(float (&s)[kPairs][8][4]) {
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[p][j][e] = 0.f;
    }
  }
}

// s[p] = A_p B_p^T over all of K (fp32): A_p's 64 rows from arow0 of the
// head slice a[p] (row stride a_sn[p]), B_p's from brow0 of b[p]; the
// queries are A's rows. 128 threads; smem holds scores_f32_smem<kPairs>().
template <int kPairs>
__device__ __forceinline__ void scores_f32(
    float (&s)[kPairs][8][4], float* smem, const float* const (&a)[kPairs],
    const long long (&a_sn)[kPairs], const float* const (&b)[kPairs],
    const long long (&b_sn)[kPairs], int arow0, int brow0, int seq_len,
    int kdim, int tid) {
  using M = Mma<float>;
  constexpr int kLd = kScoreChunk + M::kPad;
  constexpr int kTile = kScoreTile * kLd;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunks = (kdim + kScoreChunk - 1) / kScoreChunk;
  // Chunk c's A and B tiles of every pair into buffer c & 1.
  auto issue = [&](int c) {
    float* dst = smem + (c & 1) * 2 * kPairs * kTile;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      load_tile_async<float, kScoreChunk, kScoreTile, kScoreThreads>(
          dst + 2 * p * kTile, a[p], a_sn[p], arow0, seq_len,
          kScoreChunk * c, kdim, tid);
      load_tile_async<float, kScoreChunk, kScoreTile, kScoreThreads>(
          dst + (2 * p + 1) * kTile, b[p], b_sn[p], brow0, seq_len,
          kScoreChunk * c, kdim, tid);
    }
    cp_async_commit();
  };
  clear_scores(s);
  issue(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      // Into the other buffer, which every warp finished reading before
      // the barrier that closed the previous chunk.
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cur = smem + (c & 1) * 2 * kPairs * kTile;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      float part[8][4] = {};
      // One 16-column step at a time: unrolled, the 3xTF32 fragments of
      // every step were held at once and spilled.
#pragma unroll 1
      for (int kc = 0; kc < kScoreChunk / 16; ++kc) {
        typename M::A x;
        M::load_a(x, cur + 2 * p * kTile, kLd, 16 * warp, 16 * kc, lane);
#pragma unroll
        for (int np = 0; np < kScoreTile / 16; ++np) {
          typename M::B b0, b1;
          M::load_b_nk(b0, b1, cur + (2 * p + 1) * kTile, kLd, 16 * np,
                       16 * kc, lane);
          M::mma(part[2 * np], x, b0);
          M::mma(part[2 * np + 1], x, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[p][j][e] += part[j][e];
      }
    }
    __syncthreads();
  }
}

// s[p] = A_p B_p^T over all of K (bf16): A_p's 64-row boxes from arow0
// of map a[p], B_p's from brow0 of map b[p], at head h of batch bt. 128
// threads (one warpgroup); raw is the kernel's dynamic shared memory,
// scores_bf16_smem<kPairs>() bytes.
template <int kPairs>
__device__ __forceinline__ void scores_bf16(
    float (&s)[kPairs][8][4], unsigned char* raw,
    const CUtensorMap* const (&a)[kPairs],
    const CUtensorMap* const (&b)[kPairs], int arow0, int brow0, int h,
    int bt, int kdim, int tid) {
  constexpr int kStages = kScoreStages<kPairs>;
  constexpr int kStageBytes = 2 * kPairs * kScoreBox;
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  const int boxes = (kdim + 63) / 64;
  // Box c of every operand into stage c % kStages (thread 0).
  auto issue = [&](int c) {
    const int st = c % kStages;
    const uint32_t dst = base + st * kStageBytes;
    const uint32_t bar = bars + 8u * st;
    mbar_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      tma_load(dst + 2 * p * kScoreBox, a[p], bar, 64 * c, arow0, h, bt);
      tma_load(dst + (2 * p + 1) * kScoreBox, b[p], bar, 64 * c, brow0, h,
               bt);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bars + 8u * st, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < kStages && c < boxes; ++c) issue(c);
  }
#pragma unroll
  for (int p = 0; p < kPairs; ++p) clear(s[p]);
  for (int c = 0; c < boxes; ++c) {
    const int st = c % kStages;
    mbar_wait(bars + 8u * st, (c / kStages) & 1);
    const uint32_t cur = base + st * kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss<64>(s[p], kmajor_desc(cur + 2 * p * kScoreBox + kk * 32),
                     kmajor_desc(cur + (2 * p + 1) * kScoreBox + kk * 32),
                     1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < kPairs; ++p) fence_operands(s[p]);
    // Every thread's products have read stage st: refill it.
    __syncthreads();
    if (tid == 0 && c + kStages < boxes) issue(c + kStages);
  }
}

}  // namespace
