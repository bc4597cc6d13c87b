// What the two flash-attention forwards share (flash_attention_fwd.cu, on
// mma.sync, and flash_attention_fwd_sm90.cu, on wgmma): the per-row state
// a ring attention block resumes and suspends, one key tile's online
// softmax on the score accumulator, and the epilogue.
//
// Both kernels hold the scores and the output accumulator in the same
// register layout (mma.sync's m16n8 accumulator tiles are wgmma's, warp by
// warp): a lane owns rows g and g + 8 of its warp's 16 rows (g = lane / 4)
// and, in each 8-column tile j, columns 8j + 2t and 8j + 2t + 1
// (t = lane % 4): s[j][0], s[j][1] on row g, s[j][2], s[j][3] on row g + 8.
// So the softmax below is the same code, operation for operation, in both.

#pragma once

#include <cuda_runtime.h>

#include "dropout_mask.cuh"
#include "mma_sm90.cuh"
#include "sm90_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;     // the Pallas kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
// The widest K one CTA of the wide forward (flash_attention_fwd_wide.cu)
// holds in each dtype: fp32 128 < K <= 384, bf16 256 < K <= 512. Past them
// a thread-block cluster of ceil(K / kWideMax*) such CTAs shares the
// columns, up to the portable cluster size kClusterMax (sm90_common.cuh):
// fp32 to K 3072, bf16 to K 4096. The windowed route of
// flash_attention_fwd.cu takes every K past that reach, and only those
// (kernels/flash_attention.py: forward_kernel names the kernel).
constexpr int kWideMaxF32 = 384;
constexpr int kWideMaxBf16 = 512;
constexpr int kReachF32 = kClusterMax * kWideMaxF32;
constexpr int kReachBf16 = kClusterMax * kWideMaxBf16;

struct Strides {
  long long b, h, n;
};

// Per query row, fp32, each pointer optional: the logsumexp written,
// (batch, heads, seq_len). A ring attention block also carries the online
// softmax's state from the blocks before it to the ones after it, so that
// blocks taken in key order compute what one launch over all the keys
// computes, operation for operation (kernels/ring_attention.py): the
// running max (m_in / m_out, (batch, heads, seq_len)), each lane's part of
// the normaliser (l_in / l_out, (batch, heads, seq_len, 4)) and the
// unnormalised output accumulator (acc_in, in the output's layout). With
// m_in the launch resumes from that state; with m_out it hands its state
// on: the output receives the unnormalised accumulator and no lse is
// written. Both need an fp32 output.
struct RowState {
  float* lse;
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
};

// The dropout hash's part for this lane's two rows (query row0 and
// row0 + 8 of batch*head bh), computed once per launch.
template <bool kDropout>
__device__ __forceinline__ void row_hashes(unsigned int (&hash_row)[2],
                                           const Dropout& drop, int bh,
                                           int row0) {
  hash_row[0] = hash_row[1] = 0u;
  if (kDropout) {
    const unsigned int seed = load_seed(drop);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hash_row[r] = hash_part(drop, seed, global_row(drop, bh)) +
                    query_term(drop, static_cast<unsigned int>(row0 + 8 * r));
    }
  }
}

// Resume: this lane's rows' running max, normaliser part and accumulator
// columns col0.. (kAccTiles tiles of 8; none past kdim), as the previous
// block left them. row0 is the lane's first row (its second is row0 + 8).
template <int kAccTiles>
__device__ __forceinline__ void resume_state(
    float (&acc)[kAccTiles][4], float (&m_row)[2], float (&l_row)[2],
    const RowState& state, const float* acc_bh, long long acc_sn, int bh,
    int row0, int seq_len, int col0, int kdim, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < seq_len) {
      const long long at = static_cast<long long>(bh) * seq_len + row;
      m_row[r] = state.m_in[at];
      l_row[r] = state.l_in[at * 4 + t];
      const float* a_row = acc_bh + row * acc_sn + col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < kAccTiles; ++j) {
        if (col0 + 8 * j + 2 * t < kdim) {
          const float2 a = *reinterpret_cast<const float2*>(a_row + 8 * j);
          acc[j][2 * r] = a.x;
          acc[j][2 * r + 1] = a.y;
        }
      }
    }
  }
}

// One key tile of the online softmax, on S in registers (kTiles tiles of 8
// keys from kv0), but the rescale of the output accumulator: keys past
// seq_len are masked to kNegInf; the running max m_row takes the tile's
// (two shuffles per row: the four lanes of a quad share a row); alpha =
// exp(m_old - m_new), by which the caller rescales the accumulator,
// rescales l_row; S becomes P = exp(S - m), whose fp32 values l_row sums
// before dropout multiplies each kept one by 1 / (1 - rate) (the mask
// drawn at the global (batch*head, query, key) coordinates) and zeroes the
// rest.
template <bool kDropout, int kTiles>
__device__ __forceinline__ void softmax_scores(
    float (&s)[kTiles][4], float (&alpha)[2], float (&m_row)[2],
    float (&l_row)[2], const unsigned int (&hash_row)[2], int kv0,
    int seq_len, int t, const Dropout& drop) {
  if (kv0 + 8 * kTiles > seq_len) {
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kv0 + 8 * j + 2 * t + (e & 1) >= seq_len) s[j][e] = kNegInf;
      }
    }
  }
  float m_new[2] = {m_row[0], m_row[1]};
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    m_new[0] = fmaxf(m_new[0], fmaxf(s[j][0], s[j][1]));
    m_new[1] = fmaxf(m_new[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    alpha[r] = exp2f((m_row[r] - m_new[r]) * kLog2e);
    m_row[r] = m_new[r];
    l_row[r] *= alpha[r];
  }
  const float m_scaled[2] = {m_new[0] * kLog2e, m_new[1] * kLog2e};
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = exp2f(fmaf(s[j][e], kLog2e, -m_scaled[r]));
      l_row[r] += p;
      if (kDropout) {
        const unsigned int key =
            static_cast<unsigned int>(kv0 + 8 * j + 2 * t + (e & 1));
        p = keep(drop, hash_row[r] + key_term(drop, key)) ? p * drop.inv_keep
                                                          : 0.f;
      }
      s[j][e] = p;
    }
  }
}

// The output accumulator's rows rescaled by their alpha.
template <int kAccTiles>
__device__ __forceinline__ void rescale(float (&acc)[kAccTiles][4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < kAccTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
  }
}

// One key tile of the online softmax (softmax_scores), the output
// accumulator rescaled by alpha.
template <bool kDropout, int kTiles, int kAccTiles>
__device__ __forceinline__ void softmax_step(
    float (&s)[kTiles][4], float (&acc)[kAccTiles][4], float (&m_row)[2],
    float (&l_row)[2], const unsigned int (&hash_row)[2], int kv0,
    int seq_len, int t, const Dropout& drop) {
  float alpha[2];
  softmax_scores<kDropout>(s, alpha, m_row, l_row, hash_row, kv0, seq_len,
                           t, drop);
  rescale(acc, alpha);
}

// The epilogue of this lane's two rows (row0, row0 + 8), columns col0..
// (none past kdim). Suspend (state.m_out): the unnormalised accumulator
// into o and, when write_stats, m and each lane's normaliser part into the
// state. Otherwise O / l rounded to O's type and, when write_stats and
// state.lse is set, lse = m + log(l) by one lane per row. write_stats is
// false in all but one of the CTAs that share rows (the column windows of
// the wide route), which compute the same values.
template <int kAccTiles, typename O>
__device__ __forceinline__ void store_output(
    const float (&acc)[kAccTiles][4], const float (&m_row)[2],
    const float (&l_row)[2], const RowState& state, O* o_bh, long long o_sn,
    int bh, int row0, int seq_len, int col0, int kdim, int t,
    bool write_stats) {
  if (state.m_out != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < seq_len) {
        const long long at = static_cast<long long>(bh) * seq_len + row;
        if (write_stats) {
          if (t == 0) state.m_out[at] = m_row[r];
          state.l_out[at * 4 + t] = l_row[r];
        }
        O* o_row = o_bh + row * o_sn + col0 + 2 * t;
#pragma unroll
        for (int j = 0; j < kAccTiles; ++j) {
          if (col0 + 8 * j + 2 * t < kdim) {
            store_pair(o_row + 8 * j, acc[j][2 * r], acc[j][2 * r + 1]);
          }
        }
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row < seq_len) {
      const float inv_l = 1.f / l;
      O* o_row = o_bh + row * o_sn + col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < kAccTiles; ++j) {
        if (col0 + 8 * j + 2 * t < kdim) {
          store_pair(o_row + 8 * j, acc[j][2 * r] * inv_l,
                     acc[j][2 * r + 1] * inv_l);
        }
      }
      if (write_stats && state.lse != nullptr && t == 0) {
        state.lse[static_cast<long long>(bh) * seq_len + row] =
            m_row[r] + logf(l);
      }
    }
  }
}

// The checks both entry points make on a call's state pointers: a resumed
// or suspended block needs an fp32 output and all of its state.
inline bool state_ok(const RowState& state, bool fp32_out) {
  const bool resume = state.m_in != nullptr, suspend = state.m_out != nullptr;
  if ((resume || suspend) && !fp32_out) return false;
  return !((resume && (state.l_in == nullptr || state.acc_in == nullptr)) ||
           (suspend && state.l_out == nullptr));
}

}  // namespace
