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
//   * the head dim is a template parameter, 48 or 64: the wrapper pads
//     K <= 48 to 48 and 48 < K <= 64 to 64 (zero columns are exact), so
//     reference_608's K = 40 does 48-wide products, not 64;
//   * epilogue: O / l cast to the output type and stored through the
//     caller's strides ((B, N, H, K) or (B, H, N, K) views, unit head
//     stride, rows 16-byte aligned: the wrapper checks); lse = m + log l is
//     written by one lane per row.
// Budget (-Xptxas -v, sm_90a, CUDA 12.8), per instance without / with
// dropout: registers 133 / 160 (bf16, 64), 127 / 136 (bf16, 48), 255 / 255
// (fp32, 64; the second spills 4 bytes), 223 / 234 (fp32, 48), so 3 CTAs
// of the bf16 kernel share an SM, 2 of the fp32 one. Shared memory, 5
// tiles of 64 x (D + 16 bytes): 46,080 bytes (bf16, 64), 35,840 (bf16,
// 48), 87,040 (fp32, 64), 66,560 (fp32, 48), dynamic, with
// cudaFuncAttributeMaxDynamicSharedMemorySize raised once per device.
// chip_smoke.py's build phase prints these numbers and the HMMA count of
// each instance.

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

template <typename T>
constexpr int smem_bytes(int d) {
  return 5 * kBlock * (d + Mma<T>::kPad) * static_cast<int>(sizeof(T));
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int heads, int seq_len,
                 int q_tiles, Strides sq, Strides sk, Strides sv, Strides so,
                 Dropout drop) {
  using M = Mma<T>;
  constexpr int kLd = D + M::kPad;
  constexpr int kTile = kBlock * kLd;
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
  typename M::A qa[D / 16];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m_row[2] = {kNegInf, kNegInf};   // running max of each row
  float l_row[2] = {0.f, 0.f};           // this lane's part of the normaliser
  unsigned int hash_row[2] = {0u, 0u};
  if (kDropout) {
    const unsigned int seed = load_seed(drop);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hash_row[r] =
          hash_part(drop, seed, static_cast<unsigned int>(bh)) +
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
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        M::load_a(qa[kc], q_s, kLd, 16 * warp, 16 * kc, lane);
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
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        typename M::B b0, b1;
        M::load_b_nk(b0, b1, k_t, kLd, 16 * np, 16 * kc, lane);
        M::mma(s[2 * np], qa[kc], b0);
        M::mma(s[2 * np + 1], qa[kc], b1);
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

  T* o_bh = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row < seq_len) {
      const float inv_l = 1.f / l;
      T* o_row = o_bh + row * so.n + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        store_pair(o_row + 8 * j, acc[j][2 * r] * inv_l,
                   acc[j][2 * r + 1] * inv_l);
      }
      if (lse != nullptr && t == 0) {
        lse[static_cast<long long>(bh) * seq_len + row] = m_row[r] + logf(l);
      }
    }
  }
}

template <typename T, int D, bool kDropout>
cudaError_t launch_kernel(const void* q, const void* k, const void* v,
                          void* o, float* lse, int batch, int heads,
                          int seq_len, Strides sq, Strides sk, Strides sv,
                          Strides so, Dropout drop, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T>(D);
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err =
      allow_dynamic_smem(flash_fwd_kernel<T, D, kDropout>, kSmem, smem_allowed);
  if (err != cudaSuccess) return err;
  const int q_tiles = (seq_len + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(batch) * heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, D, kDropout>
      <<<static_cast<unsigned int>(blocks), kThreads, kSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, heads, seq_len,
          q_tiles, sq, sk, sv, so, drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dim(bool dropout, const void* q, const void* k,
                       const void* v, void* o, float* lse, int batch,
                       int heads, int seq_len, Strides sq, Strides sk,
                       Strides sv, Strides so, Dropout drop,
                       cudaStream_t stream) {
  if (dropout) {
    return launch_kernel<T, D, true>(q, k, v, o, lse, batch, heads, seq_len,
                                     sq, sk, sv, so, drop, stream);
  }
  return launch_kernel<T, D, false>(q, k, v, o, lse, batch, heads, seq_len,
                                    sq, sk, sv, so, drop, stream);
}

template <typename T>
cudaError_t launch(int head_dim, bool dropout, const void* q, const void* k,
                   const void* v, void* o, float* lse, int batch, int heads,
                   int seq_len, Strides sq, Strides sk, Strides sv,
                   Strides so, Dropout drop, cudaStream_t stream) {
  if (head_dim == 48) {
    return launch_dim<T, 48>(dropout, q, k, v, o, lse, batch, heads, seq_len,
                             sq, sk, sv, so, drop, stream);
  }
  if (head_dim == 64) {
    return launch_dim<T, 64>(dropout, q, k, v, o, lse, batch, heads, seq_len,
                             sq, sk, sv, so, drop, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. head_dim: 48 or 64 (the wrapper pads).
// Strides are in elements, for the batch, head and token axes; the head dim
// must be contiguous and every row 16-byte aligned. lse: nullptr, or a
// contiguous fp32 (batch, heads, seq_len) array. dropout: 0, or 1 with the
// device address of the uint32 seed, the uint32 keep threshold (keep iff
// hash < threshold) and inv_keep = 1 / (1 - rate) in fp32; bh_base, q_base
// and k_base: the global batch*head row, query and key of the launch's
// first (dropout_mask.cuh; 0 for a launch over the whole array). Returns
// cudaGetLastError() after the launch (0 on success).
int vtd_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int batch,
                            int heads, int seq_len, int head_dim,
                            long long q_sb, long long q_sh, long long q_sn,
                            long long k_sb, long long k_sh, long long k_sn,
                            long long v_sb, long long v_sh, long long v_sn,
                            long long o_sb, long long o_sh, long long o_sn,
                            int dropout, const unsigned int* seed,
                            unsigned int threshold, float inv_keep,
                            unsigned int bh_base, unsigned int q_base,
                            unsigned int k_base, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0) return cudaErrorInvalidValue;
  if (dropout != 0 && seed == nullptr) return cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn},
      sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  const Dropout drop{seed, threshold, inv_keep, bh_base, q_base, k_base};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(head_dim, dropout != 0, q, k, v, o, lse_f, batch,
                        heads, seq_len, sq, sk, sv, so, drop, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(head_dim, dropout != 0, q, k, v, o, lse_f,
                                batch, heads, seq_len, sq, sk, sv, so, drop,
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
