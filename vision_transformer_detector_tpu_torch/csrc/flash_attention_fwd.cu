// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C interface (kernels/flash_attention.py loads it with ctypes).
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
// kernel (flash_attention_bwd.cu) reads, as the Pallas kernel's
// `with_lse` variant writes it (without the TPU's 8-sublane replication).
// With dropout on, it is also the Pallas kernel's dropout branch: each
// probability is multiplied by keep * (1 / (1 - rate)) after the
// normaliser has summed it (so lse stays the true logsumexp) and before it
// is rounded to the input type for P@V. The keep mask is
// `dropout_keep_mask` of the Pallas module: a murmur3 finalizer over
// uint32 (wrapping multiplies, logical shifts) of the seed and the global
// (batch*head, query, key) indices, compared with a threshold; CUDA's
// uint32 arithmetic is that arithmetic, so the masks are bit-equal, and
// the backward kernel replays them from the same indices.
//
// What bounds it: at the ViT-B/16 384px serving shape (N = 576, K = 64)
// one (batch, head) pair is 576 x 576 x 64 x 4 = 85 MFLOP on 295 KB of
// bf16 q/k/v/o, 288 FLOP per byte: at the H100's bf16 ridge (about 295),
// so even a tensor-core version is bound by memory and by latency (tile
// loads, the exp/max chain of the online softmax), not by the tensor
// cores. This version keeps the products on the fp32 cores: at large batch
// it is bound by fp32 issue rate and shared-memory reads, at small batch by
// the small grid (batch * heads * ceil(N / 64) blocks; 108 at batch 1) and
// latency. At the highres_1024 training fold ((B * H * windows, N, K) =
// (2048, 256, 64) bf16 at batch 8) a launch is 34 GFLOP on 270 MB, about
// 127 FLOP per byte: also below the ridge. mma/wgmma, TMA staging and
// tuning are later work.
//
// Design:
//   * one thread block per (batch*head, 64-query tile); four adjacent
//     threads share a query row, each holding 16 of the 64 head dims of
//     q and of the fp32 accumulator in registers;
//   * K and V tiles of 64 keys are staged in shared memory as fp32 and the
//     block loops over them (the sequential KV grid axis of the TPU kernel
//     becomes this loop);
//   * scores are taken 16 keys at a time: partial dots are summed across
//     the four threads of a row with warp shuffles, then the running max
//     and the accumulator are rescaled once per 16 keys;
//   * keys past N (the ragged last tile) are zero-filled in shared memory
//     and masked to -1e30, as the Pallas kernel masks its KV padding;
//   * head dim 64 only: the Python wrapper zero-pads any K < 64, which is
//     exact (padded columns add 0 to q.k and give 0 outputs);
//   * dropout is a template flag, so the dropout-free kernel carries no
//     hash. The four lanes of a row each hash the same (query, key) pair:
//     about ten integer operations per score, beside the 32 FMAs per score
//     of the two products; sharing the hashes through shuffles is later
//     work.
// Strides are passed in, so q/k/v/o may be (B, N, H, K) or (B, H, N, K)
// views; the head dim must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_mask.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockQ = 64;          // query rows per block
constexpr int kThreadsPerRow = 4;    // threads sharing one query row
constexpr int kDimsPerThread = kHeadDim / kThreadsPerRow;   // 16
constexpr int kThreads = kBlockQ * kThreadsPerRow;          // 256
constexpr int kBlockKV = 64;         // keys per shared-memory tile
constexpr int kChunk = 16;           // keys scored before one rescale
constexpr float kNegInf = -1e30f;    // the Pallas kernel's mask value

struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p cast to the input type before P@V, as `p.astype(v.dtype)` in the
// Pallas kernel.
template <typename T>
__device__ __forceinline__ float round_to_input(float x) {
  return to_float(from_float<T>(x));
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int heads, int seq_len, Strides sq,
                 Strides sk, Strides sv, Strides so, Dropout drop) {
  __shared__ __align__(16) float k_tile[kBlockKV][kHeadDim];
  __shared__ __align__(16) float v_tile[kBlockKV][kHeadDim];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int row = blockIdx.y * kBlockQ + tid / kThreadsPerRow;
  const int dim0 = (tid % kThreadsPerRow) * kDimsPerThread;
  const bool row_valid = row < seq_len;

  const T* q_bh = q + b * sq.b + h * sq.h;
  const T* k_bh = k + b * sk.b + h * sk.h;
  const T* v_bh = v + b * sv.b + h * sv.h;

  float q_reg[kDimsPerThread];
  float acc[kDimsPerThread];
#pragma unroll
  for (int d = 0; d < kDimsPerThread; ++d) {
    q_reg[d] = row_valid ? to_float(q_bh[row * sq.n + dim0 + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;   // running max of this row's scores
  float l = 0.f;       // running softmax normaliser (undropped)
  // This row's part of the mask hash; each key adds its own term.
  const unsigned int hash_row =
      kDropout ? hash_part(drop, static_cast<unsigned int>(bh)) +
                     query_term(static_cast<unsigned int>(row))
               : 0u;

  for (int kv0 = 0; kv0 < seq_len; kv0 += kBlockKV) {
    __syncthreads();   // every thread is done with the previous tile
    // Stage the tile: consecutive threads load consecutive head dims.
#pragma unroll 4
    for (int idx = tid; idx < kBlockKV * kHeadDim; idx += kThreads) {
      const int r = idx / kHeadDim;
      const int c = idx % kHeadDim;
      const int key = kv0 + r;
      float kk = 0.f, vv = 0.f;
      if (key < seq_len) {
        kk = to_float(k_bh[key * sk.n + c]);
        vv = to_float(v_bh[key * sv.n + c]);
      }
      k_tile[r][c] = kk;
      v_tile[r][c] = vv;
    }
    __syncthreads();

    const int valid = min(kBlockKV, seq_len - kv0);
    for (int c0 = 0; c0 < valid; c0 += kChunk) {
      float s[kChunk];
      float chunk_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4* kr =
            reinterpret_cast<const float4*>(&k_tile[c0 + j][dim0]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < kDimsPerThread / 4; ++d4) {
          const float4 kv4 = kr[d4];
          dot = fmaf(q_reg[4 * d4 + 0], kv4.x, dot);
          dot = fmaf(q_reg[4 * d4 + 1], kv4.y, dot);
          dot = fmaf(q_reg[4 * d4 + 2], kv4.z, dot);
          dot = fmaf(q_reg[4 * d4 + 3], kv4.w, dot);
        }
        // The four threads of a row are adjacent lanes.
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        s[j] = (c0 + j < valid) ? dot : kNegInf;
        chunk_max = fmaxf(chunk_max, s[j]);
      }
      const float m_new = fmaxf(m, chunk_max);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kDimsPerThread; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
        float pd = p;
        if (kDropout) {
          const unsigned int key = static_cast<unsigned int>(kv0 + c0 + j);
          pd = keep(drop, hash_row + key_term(key)) ? p * drop.inv_keep
                                                    : 0.f;
        }
        const float pv = round_to_input<T>(pd);
        const float4* vr =
            reinterpret_cast<const float4*>(&v_tile[c0 + j][dim0]);
#pragma unroll
        for (int d4 = 0; d4 < kDimsPerThread / 4; ++d4) {
          const float4 vv4 = vr[d4];
          acc[4 * d4 + 0] = fmaf(pv, vv4.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(pv, vv4.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(pv, vv4.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(pv, vv4.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row_valid) {
    T* o_row = o + b * so.b + h * so.h + row * so.n + dim0;
#pragma unroll
    for (int d = 0; d < kDimsPerThread; ++d) {
      o_row[d] = from_float<T>(acc[d] / l);
    }
    if (lse != nullptr && dim0 == 0) {
      lse[(static_cast<long long>(bh) * seq_len) + row] = m + logf(l);
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o,
            float* lse, int batch, int heads, int seq_len, Strides sq,
            Strides sk, Strides sv, Strides so, bool dropout, Dropout drop,
            cudaStream_t stream) {
  const dim3 grid(batch * heads, (seq_len + kBlockQ - 1) / kBlockQ);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (dropout) {
    flash_fwd_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, ot, lse, heads, seq_len, sq, sk, sv, so, drop);
  } else {
    flash_fwd_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        qt, kt, vt, ot, lse, heads, seq_len, sq, sk, sv, so, drop);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// batch, head and token axes; the head dim (64) must be contiguous.
// lse: nullptr, or a contiguous fp32 (batch, heads, seq_len) array.
// dropout: 0, or 1 with the uint32 seed, the uint32 keep threshold
// (keep iff hash < threshold) and inv_keep = 1 / (1 - rate) in fp32.
// Returns cudaGetLastError() after the launch (0 on success).
int vtd_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int batch,
                            int heads, int seq_len, long long q_sb,
                            long long q_sh, long long q_sn, long long k_sb,
                            long long k_sh, long long k_sn, long long v_sb,
                            long long v_sh, long long v_sn, long long o_sb,
                            long long o_sh, long long o_sn, int dropout,
                            unsigned int seed, unsigned int threshold,
                            float inv_keep, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0) return cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn},
      sv{v_sb, v_sh, v_sn}, so{o_sb, o_sh, o_sn};
  const Dropout drop{seed, threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(q, k, v, o, static_cast<float*>(lse), batch, heads, seq_len,
                  sq, sk, sv, so, dropout != 0, drop, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), batch, heads,
                          seq_len, sq, sk, sv, so, dropout != 0, drop, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
