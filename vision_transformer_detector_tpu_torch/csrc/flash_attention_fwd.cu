// Flash-attention forward for Hopper (sm_90a) on the tensor cores, bound to
// Python through a plain C interface (kernels/flash_attention.py loads it
// with ctypes).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// vision_transformer_detector_tpu/kernels/flash_attention.py (launched by
// `_flash_forward`): softmax(q k^T) v over (batch*heads, N, K) with an fp32
// running max, normaliser and P@V accumulator, so the N x N scores never
// reach device memory. The caller applies 1/sqrt(key_dim); the kernel
// applies no scale. As in the Pallas kernel, the normaliser sums the fp32
// probabilities and P@V uses the probabilities rounded to the input type.
// A ring attention block may resume the online softmax's state (running
// max, normaliser, unnormalised accumulator) where the block before it
// suspended it, and suspend its own for the next, so that the blocks taken
// in key order compute what one launch over all the keys computes
// (kernels/ring_attention.py).
// With an lse pointer it also writes each query row's fp32 logsumexp,
// m + log(l), into a (batch, heads, N) array: the residual the backward
// kernel (flash_attention_bwd.cu) reads, as the Pallas kernel's `with_lse`
// variant writes it (without the TPU's 8-sublane replication). With dropout
// on, it is also the Pallas kernel's dropout branch: each probability is
// multiplied by keep * (1 / (1 - rate)) after the normaliser has summed it
// (so lse stays the true logsumexp) and before it is rounded to the input
// type for P@V. The keep mask is `dropout_keep_mask` of the Pallas module
// (dropout_mask.cuh), bit-equal to JAX's, and the backward replays it.
//
// What bounds it (one H100 SXM: 989 TFLOP/s bf16 and 495 TF32 dense,
// 3.35 TB/s):
//   * vit_b16_384 serving, (B*H, N, K) = (12 B, 576, 64) bf16: per
//     (batch, head) 4 * 576^2 * 64 = 84.9 MFLOP on 295 KB of q/k/v/o,
//     288 FLOP per byte, at the bf16 ridge (about 295): at B = 64 the
//     bound is 0.068 ms by bytes and 0.066 ms by operations;
//   * highres_1024 training, (2048, 256, 64) bf16 with lse (with or
//     without dropout): 34.4 GFLOP on 270 MB, 127 FLOP per byte, bound by
//     bytes at 0.081 ms;
//   * reference_608 training, (64, 1296, 40) fp32 with lse: 17.2 GFLOP
//     (K = 40), done as 3xTF32 (three TF32 products per fp32 product) on
//     53 MB: bound by operations at 3 * 17.2 G / 495 T = 0.104 ms.
// So the bf16 shapes sit at or below the ridge: a kernel is held by memory
// and by the latency of the online-softmax chain (max, exp, rescale) between
// the two products of each tile, as FA2-class kernels are; the fp32 shape
// is arithmetic. This kernel, as measured by chip_smoke.py (H100 SXM,
// 700 W): 0.33 ms at (768, 576, 64), 196 TFLOP/s, 20 % of its bound;
// 0.26 ms at the dropout shape, 30 %; 0.64 ms in fp32, 16 %. Neither bytes
// nor the tensor cores are saturated: the limit is the latency of that
// chain with 12 resident warps per SM, which mma.sync leaves exposed
// (wgmma's asynchronous products and TMA loads in warp-specialised
// pipelines are the next step).
//
// Design (FA2's, for this card):
//   * one CTA of 4 warps (128 threads) per (batch*head, 64-query tile);
//     each warp owns 16 query rows and holds them as mma A fragments in
//     registers for the whole loop, loaded once from a shared tile;
//   * K and V tiles of 64 keys are staged in shared memory in the input
//     type with 16-byte cp.async copies, double-buffered: tile i + 1 is in
//     flight while tile i is multiplied. Rows carry one extra 16-byte chunk
//     against bank conflicts (mma_sm90.cuh); keys past N are zero-filled;
//   * S = Q K^T with mma.sync (bf16 m16n8k16, fp32 accumulation); keys past
//     N are masked to -1e30, the Pallas kernel's _NEG_INF;
//   * the online softmax runs on the accumulator registers: each lane owns
//     2 rows x 16 scores of a tile, so the row max takes two shuffles per
//     row per tile, the sum stays lane-local until the epilogue, and each
//     score's exp (and, with dropout, its mask hash) is computed once, by
//     the lane that owns it; alpha = exp(m_old - m_new) rescales l and the
//     O accumulator once per tile;
//   * O += P V: the S accumulator's layout is the next mma's A-fragment
//     layout, so rounding P to the input type in registers is the Pallas
//     kernel's `p.astype(v.dtype)` and P never touches shared memory; V
//     comes in through ldmatrix.trans;
//   * fp32 (reference_608) runs the same code on mma.m16n8k8 TF32 with the
//     3xTF32 split for both products (in fp32 P's cast is the identity);
//   * the head dim is a template parameter, 48, 64 or 128: the wrapper pads
//     K <= 48 to 48, 48 < K <= 64 to 64 and 64 < K <= 128 to 128 (zero
//     columns are exact), so reference_608's K = 40 does 48-wide products,
//     not 64, and ViT-H/14's K = 80 runs the 128 instance. The 128
//     instance keeps the 64-row tiles and the warp layout (the ring's
//     per-lane normaliser state is the same); in fp32 it reloads Q's
//     fragments from the shared tile at every key tile instead of holding
//     them (3xTF32 hi and lo fragments of 16 rows x 128 would take 128
//     registers beside O's 64), and every fp32 tile sum covers 64 columns
//     a pass (mma_sm90.cuh);
//   * the output type is a template parameter: the input type, or fp32
//     for a bf16 ring attention block (kernels/ring_attention.py merges the
//     R blocks' unrounded outputs and rounds once, as JAX's ring does);
//   * epilogue: O / l cast to the output type and stored through the
//     caller's strides ((B, N, H, K) or (B, H, N, K) views, unit head
//     stride, rows 16-byte aligned: the wrapper checks); lse = m + log l is
//     written by one lane per row.
// Budget (-Xptxas -v, sm_90a, CUDA 12.8, NVIDIA H100 80GB HBM3's machine),
// registers per instance without / with dropout: bf16 127 / 164 (48),
// 133 / 167 (64), 234 / 254 (128), no spills; fp32 223 / 237 (48),
// 255 / 255 (64; the second spills 16 bytes), 255 / 255 (128; each spills
// 64 bytes). Shared memory, 5 tiles of 64 x (D + 16 bytes): bf16 35,840
// (48), 46,080 (64), 87,040 (128); fp32 66,560 (48), 87,040 (64),
// 168,960 (128), dynamic, with cudaFuncAttributeMaxDynamicSharedMemorySize
// raised once per device. So 3 CTAs of the 48 and 64 bf16 kernels share
// an SM, 2 of the 128 one (registers) and of the fp32 48 and 64 ones, 1 of
// the fp32 128 one (shared memory). chip_smoke.py's build phase prints
// these numbers and the HMMA count of each instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_mask.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kBlock = 64;            // queries per CTA and keys per tile
constexpr int kThreads = 128;         // 4 warps of 16 query rows
constexpr float kNegInf = -1e30f;     // the Pallas kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

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

template <typename T>
constexpr int smem_bytes(int d) {
  return 5 * kBlock * (d + Mma<T>::kPad) * static_cast<int>(sizeof(T));
}

template <typename T, int D, bool kDropout, typename O>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, O* __restrict__ o,
                 RowState state, int heads, int seq_len,
                 int q_tiles, Strides sq, Strides sk, Strides sv, Strides so,
                 Dropout drop) {
  using M = Mma<T>;
  constexpr int kLd = D + M::kPad;
  constexpr int kTile = kBlock * kLd;
  // Q's A fragments stay in registers for the whole loop, except in the
  // 128-wide fp32 instance, whose 3xTF32 fragments (hi and lo) would take
  // 128 registers beside the accumulator's 64: it reloads them from the
  // shared Q tile, which no later copy overwrites, at every key tile.
  constexpr bool kQResident = sizeof(T) == 2 || D <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kTile;          // two buffers
  T* v_s = k_s + 2 * kTile;      // two buffers

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  // Query tiles of one (batch, head) are neighbours in launch order, so
  // its K and V are read from device memory once and from L2 after that.
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const T* q_bh = q + b * sq.b + h * sq.h;
  const T* k_bh = k + b * sk.b + h * sk.h;
  const T* v_bh = v + b * sv.b + h * sv.h;

  load_tile_async<T, D, kBlock, kThreads>(q_s, q_bh, sq.n, q0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(k_s, k_bh, sk.n, 0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(v_s, v_bh, sv.n, 0, seq_len, tid);
  cp_async_commit();

  // This lane's rows: 16 * warp + g (r = 0) and + 8 (r = 1).
  typename M::A qa[kQResident ? D / 16 : 1];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m_row[2] = {kNegInf, kNegInf};   // running max of each row
  float l_row[2] = {0.f, 0.f};           // this lane's part of the normaliser
  if (state.m_in != nullptr) {
    // Resume: this lane's rows' running max, normaliser part and
    // accumulator fragment, as the previous block left them.
    const float* a_bh = state.acc_in + b * so.b + h * so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row < seq_len) {
        const long long at = static_cast<long long>(bh) * seq_len + row;
        m_row[r] = state.m_in[at];
        l_row[r] = state.l_in[at * 4 + t];
        const float* a_row = a_bh + row * so.n + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float2 a = *reinterpret_cast<const float2*>(a_row + 8 * j);
          acc[j][2 * r] = a.x;
          acc[j][2 * r + 1] = a.y;
        }
      }
    }
  }
  unsigned int hash_row[2] = {0u, 0u};
  if (kDropout) {
    const unsigned int seed = load_seed(drop);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hash_row[r] =
          hash_part(drop, seed, global_row(drop, bh)) +
          query_term(drop, static_cast<unsigned int>(q0 + 16 * warp + g +
                                                     8 * r));
    }
  }

  const int kv_tiles = (seq_len + kBlock - 1) / kBlock;
  for (int it = 0; it < kv_tiles; ++it) {
    const int kv0 = it * kBlock;
    const int buf = it & 1;
    if (it + 1 < kv_tiles) {
      // Tile it + 1 into the other buffer, which every warp finished
      // reading before the barrier that closed the previous iteration.
      load_tile_async<T, D, kBlock, kThreads>(k_s + (buf ^ 1) * kTile, k_bh,
                                              sk.n, kv0 + kBlock, seq_len,
                                              tid);
      load_tile_async<T, D, kBlock, kThreads>(v_s + (buf ^ 1) * kTile, v_bh,
                                              sv.n, kv0 + kBlock, seq_len,
                                              tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQResident) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          M::load_a(qa[kc], q_s, kLd, 16 * warp, 16 * kc, lane);
        }
      }
    }
    const T* k_t = k_s + buf * kTile;
    const T* v_t = v_s + buf * kTile;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 accumulator n-tiles.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      if constexpr (!kQResident) {
        M::load_a(qa[0], q_s, kLd, 16 * warp, 16 * kc, lane);
      }
      const typename M::A& a = qa[kQResident ? kc : 0];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        typename M::B b0, b1;
        M::load_b_nk(b0, b1, k_t, kLd, 16 * np, 16 * kc, lane);
        M::mma(s[2 * np], a, b0);
        M::mma(s[2 * np + 1], a, b1);
      }
    }
    if (kv0 + kBlock > seq_len) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kv0 + 8 * j + 2 * t + (e & 1) >= seq_len) s[j][e] = kNegInf;
        }
      }
    }

    // Online softmax on the accumulators: rows g (e = 0, 1) and g + 8
    // (e = 2, 3); the four lanes of a quad share a row.
    float m_new[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m_new[0] = fmaxf(m_new[0], fmaxf(s[j][0], s[j][1]));
      m_new[1] = fmaxf(m_new[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      const float alpha = exp2f((m_row[r] - m_new[r]) * kLog2e);
      m_row[r] = m_new[r];
      l_row[r] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
    const float m_scaled[2] = {m_new[0] * kLog2e, m_new[1] * kLog2e};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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

    // O += P V, P rounded to the input type as it becomes an A fragment.
    add_acc_kn<T, kBlock, D>(acc, s, v_t, kLd, lane);
    __syncthreads();   // this buffer is refilled at the next iteration's top
  }

  O* o_bh = o + b * so.b + h * so.h;
  if (state.m_out != nullptr) {
    // Suspend: hand the state on, the accumulator unnormalised.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row < seq_len) {
        const long long at = static_cast<long long>(bh) * seq_len + row;
        if (t == 0) state.m_out[at] = m_row[r];
        state.l_out[at * 4 + t] = l_row[r];
        O* o_row = o_bh + row * so.n + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          store_pair(o_row + 8 * j, acc[j][2 * r], acc[j][2 * r + 1]);
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
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row < seq_len) {
      const float inv_l = 1.f / l;
      O* o_row = o_bh + row * so.n + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        store_pair(o_row + 8 * j, acc[j][2 * r] * inv_l,
                   acc[j][2 * r + 1] * inv_l);
      }
      if (state.lse != nullptr && t == 0) {
        state.lse[static_cast<long long>(bh) * seq_len + row] =
            m_row[r] + logf(l);
      }
    }
  }
}

template <typename T, int D, bool kDropout, typename O>
cudaError_t launch_kernel(const void* q, const void* k, const void* v,
                          void* o, RowState state, int batch, int heads,
                          int seq_len, Strides sq, Strides sk, Strides sv,
                          Strides so, Dropout drop, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T>(D);
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err =
      allow_dynamic_smem(flash_fwd_kernel<T, D, kDropout, O>, kSmem,
                         smem_allowed);
  if (err != cudaSuccess) return err;
  const int q_tiles = (seq_len + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(batch) * heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, D, kDropout, O>
      <<<static_cast<unsigned int>(blocks), kThreads, kSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<O*>(o), state, heads, seq_len,
          q_tiles, sq, sk, sv, so, drop);
  return cudaGetLastError();
}

template <typename T, int D, typename O>
cudaError_t launch_dim(bool dropout, const void* q, const void* k,
                       const void* v, void* o, RowState state, int batch,
                       int heads, int seq_len, Strides sq, Strides sk,
                       Strides sv, Strides so, Dropout drop,
                       cudaStream_t stream) {
  if (dropout) {
    return launch_kernel<T, D, true, O>(q, k, v, o, state, batch, heads,
                                        seq_len, sq, sk, sv, so, drop,
                                        stream);
  }
  return launch_kernel<T, D, false, O>(q, k, v, o, state, batch, heads,
                                       seq_len, sq, sk, sv, so, drop, stream);
}

template <typename T, typename O>
cudaError_t launch(int head_dim, bool dropout, const void* q, const void* k,
                   const void* v, void* o, RowState state, int batch,
                   int heads,
                   int seq_len, Strides sq, Strides sk, Strides sv,
                   Strides so, Dropout drop, cudaStream_t stream) {
  if (head_dim == 48) {
    return launch_dim<T, 48, O>(dropout, q, k, v, o, state, batch, heads,
                                seq_len, sq, sk, sv, so, drop, stream);
  }
  if (head_dim == 64) {
    return launch_dim<T, 64, O>(dropout, q, k, v, o, state, batch, heads,
                                seq_len, sq, sk, sv, so, drop, stream);
  }
  if (head_dim == 128) {
    return launch_dim<T, 128, O>(dropout, q, k, v, o, state, batch, heads,
                                 seq_len, sq, sk, sv, so, drop, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; out_fp32: 1 writes the output in fp32
// whatever the input dtype (a ring attention block), 0 in the input dtype.
// head_dim: 48, 64 or 128 (the wrapper pads). Strides are in elements, for
// the batch, head and token axes; the head dim must be contiguous and every
// row 16-byte aligned. lse: nullptr, or a contiguous fp32 (batch, heads,
// seq_len) array; m_in, l_in, acc_in and m_out, l_out: nullptr, or a ring
// attention block's online-softmax state to resume from and to hand on
// (RowState; acc_in has the output's strides), each needing an fp32
// output. dropout: 0, or 1 with the device address of the uint32 seed, the
// uint32 keep threshold (keep iff hash < threshold) and inv_keep = 1 / (1 -
// rate) in fp32; bh_base, q_base and k_base: the global batch*head row,
// query and key of the launch's first, and inner_local, inner_global and
// inner_base the map of a local batch*head row to a global one
// (dropout_mask.cuh; 0, 0, 0 and 1, 1, 0 for a launch over the whole
// array). Returns cudaGetLastError() after the launch (0 on success).
int vtd_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, const void* m_in,
                            const void* l_in, const void* acc_in,
                            void* m_out, void* l_out, int dtype,
                            int out_fp32, int batch, int heads,
                            int seq_len, int head_dim,
                            long long q_sb, long long q_sh, long long q_sn,
                            long long k_sb, long long k_sh, long long k_sn,
                            long long v_sb, long long v_sh, long long v_sn,
                            long long o_sb, long long o_sh, long long o_sn,
                            int dropout, const unsigned int* seed,
                            unsigned int threshold, float inv_keep,
                            unsigned int bh_base, unsigned int q_base,
                            unsigned int k_base, unsigned int inner_local,
                            unsigned int inner_global,
                            unsigned int inner_base, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0) return cudaErrorInvalidValue;
  if (dropout != 0 && seed == nullptr) return cudaErrorInvalidValue;
  if (inner_local == 0) return cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn},
      sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  const Dropout drop{seed,   threshold,   inv_keep,     bh_base,   q_base,
                     k_base, inner_local, inner_global, inner_base};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool resume = m_in != nullptr, suspend = m_out != nullptr;
  if ((resume || suspend) && dtype != 0 && out_fp32 == 0) {
    return cudaErrorInvalidValue;
  }
  if ((resume && (l_in == nullptr || acc_in == nullptr)) ||
      (suspend && l_out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const RowState state{static_cast<float*>(lse),
                       static_cast<const float*>(m_in),
                       static_cast<const float*>(l_in),
                       static_cast<const float*>(acc_in),
                       static_cast<float*>(m_out),
                       static_cast<float*>(l_out)};
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float, float>(head_dim, dropout != 0, q, k, v, o, state,
                               batch, heads, seq_len, sq, sk, sv, so, drop,
                               s);
  } else if (dtype == 1 && out_fp32 != 0) {
    err = launch<__nv_bfloat16, float>(head_dim, dropout != 0, q, k, v, o,
                                       state, batch, heads, seq_len, sq, sk,
                                       sv, so, drop, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(head_dim, dropout != 0, q, k,
                                               v, o, state, batch, heads,
                                               seq_len, sq, sk, sv, so, drop,
                                               s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
