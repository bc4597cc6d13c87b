// Flash-attention backward for Hopper (sm_90a), bound to Python through a
// plain C interface (kernels/flash_attention.py loads it with ctypes).
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
// with fp32 accumulation, as the Pallas kernel does.
//
// What bounds it: at the reference_608 training shape ((B*H, N, K) =
// (64, 1296, 40), K padded to 64) the backward does 5 products of
// N x N x 64 per (batch, head): 35 GFLOP on 85 MB of fp32 q/k/v/g/dq/dk/dv,
// about 400 FLOP per byte, so it is bound by arithmetic. This version
// keeps the products on the fp32 cores (no mma/wgmma, no TMA): it is bound
// by fp32 issue rate and shared-memory reads. Tensor cores are later work.
//
// Design:
//   * one thread block per (batch*head, 64-key tile). Four adjacent threads
//     share a key row, each holding 16 of the 64 head dims of k, v and of
//     the fp32 dk/dv accumulators in registers, so the accumulators never
//     touch shared memory;
//   * the block loops over 64-query tiles (the Pallas kernel's in-kernel
//     loop over q blocks): q and g tiles, lse and delta are staged in
//     shared memory as fp32; each key row scores the tile's queries one at
//     a time, with the four partial dots summed by warp shuffles;
//   * dq: the Pallas kernel keeps dq resident in VMEM across a sequential
//     grid, which CUDA blocks do not have. Here each block writes its ds
//     tile to shared memory (transposed, rows padded to 65 floats against
//     bank conflicts), forms that tile's dq contribution ds k, and adds it
//     with fp32 atomicAdd into a zeroed fp32 dq. The order of those adds
//     changes from run to run, so dq agrees with a serial sum to fp32
//     rounding of the partial sums, not bit for bit;
//   * shared memory is 66,064 bytes (q, g and k tiles, ds^T, lse, delta):
//     above the 48 KB static limit, so it is dynamic and the launch raises
//     cudaFuncAttributeMaxDynamicSharedMemorySize first;
//   * ragged N: keys past N are zero in shared memory and get p = 0;
//     queries past N are never scored and never written (on CUDA nothing is
//     zero-padded, so g and delta past N are not zero for free);
//   * head dim 64 only: the wrapper zero-pads K < 64, which is exact.
// Strides are passed in, so every tensor may be (B, N, H, 64) or
// (B, H, N, 64); lse and delta are contiguous (B, H, N) fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockKV = 64;         // keys per block
constexpr int kBlockQ = 64;          // queries per staged tile
constexpr int kThreadsPerRow = 4;    // threads sharing one key (or dq) row
constexpr int kDimsPerThread = kHeadDim / kThreadsPerRow;   // 16
constexpr int kThreads = kBlockKV * kThreadsPerRow;         // 256
constexpr int kDsStride = kBlockKV + 1;   // padded row of the ds^T tile
constexpr int kTile = kBlockQ * kHeadDim;                   // floats
constexpr int kSmemFloats = 3 * kTile + kBlockQ * kDsStride + 2 * kBlockQ;
constexpr int kSmemBytes = kSmemFloats * static_cast<int>(sizeof(float));

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

// `x.astype(in_dtype)` of the Pallas kernel, back in fp32.
template <typename T>
__device__ __forceinline__ float round_to_input(float x) {
  return to_float(from_float<T>(x));
}

// Copies rows [row0, row0 + 64) of a (seq_len, 64) head slice into a
// shared fp32 tile, zero past seq_len.
template <typename T>
__device__ __forceinline__ void stage_tile(float (*tile)[kHeadDim],
                                           const T* __restrict__ src,
                                           long long row_stride, int row0,
                                           int seq_len) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kTile; idx += kThreads) {
    const int r = idx / kHeadDim;
    const int c = idx % kHeadDim;
    const int row = row0 + r;
    tile[r][c] = row < seq_len ? to_float(src[row * row_stride + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, int heads,
                 int seq_len, Strides sq, Strides sk, Strides sv, Strides sg,
                 Strides sdq, Strides sdk, Strides sdv) {
  extern __shared__ __align__(16) float smem[];
  auto q_tile = reinterpret_cast<float (*)[kHeadDim]>(smem);
  auto g_tile = reinterpret_cast<float (*)[kHeadDim]>(smem + kTile);
  auto k_tile = reinterpret_cast<float (*)[kHeadDim]>(smem + 2 * kTile);
  auto ds_t = reinterpret_cast<float (*)[kDsStride]>(smem + 3 * kTile);
  float* lse_s = smem + 3 * kTile + kBlockQ * kDsStride;
  float* delta_s = lse_s + kBlockQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kv0 = blockIdx.y * kBlockKV;
  const int local = tid / kThreadsPerRow;   // this thread's key (or dq) row
  const int key = kv0 + local;
  const int dim0 = (tid % kThreadsPerRow) * kDimsPerThread;
  const bool key_valid = key < seq_len;

  const T* q_bh = q + b * sq.b + h * sq.h;
  const T* k_bh = k + b * sk.b + h * sk.h;
  const T* v_bh = v + b * sv.b + h * sv.h;
  const T* g_bh = g + b * sg.b + h * sg.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * seq_len;
  const float* delta_bh = delta + static_cast<long long>(bh) * seq_len;
  float* dq_bh = dq + b * sdq.b + h * sdq.h;

  // The block's keys, in shared memory for the dq product; this thread's
  // key row of k and v in registers.
  stage_tile<T>(k_tile, k_bh, sk.n, kv0, seq_len);
  float k_reg[kDimsPerThread], v_reg[kDimsPerThread];
  float dk_acc[kDimsPerThread], dv_acc[kDimsPerThread];
#pragma unroll
  for (int d = 0; d < kDimsPerThread; ++d) {
    v_reg[d] = key_valid ? to_float(v_bh[key * sv.n + dim0 + d]) : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int d = 0; d < kDimsPerThread; ++d) k_reg[d] = k_tile[local][dim0 + d];

  for (int q0 = 0; q0 < seq_len; q0 += kBlockQ) {
    __syncthreads();   // every thread is done with the previous tile
    stage_tile<T>(q_tile, q_bh, sq.n, q0, seq_len);
    stage_tile<T>(g_tile, g_bh, sg.n, q0, seq_len);
    if (tid < kBlockQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < seq_len ? lse_bh[row] : 0.f;
      delta_s[tid] = row < seq_len ? delta_bh[row] : 0.f;
    }
    __syncthreads();

    // Block-uniform bound: every lane takes part in the shuffles.
    const int valid_q = min(kBlockQ, seq_len - q0);
    for (int j = 0; j < valid_q; ++j) {
      const float4* qr = reinterpret_cast<const float4*>(&q_tile[j][dim0]);
      const float4* gr = reinterpret_cast<const float4*>(&g_tile[j][dim0]);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < kDimsPerThread / 4; ++d4) {
        const float4 q4 = qr[d4];
        const float4 g4 = gr[d4];
        s = fmaf(k_reg[4 * d4 + 0], q4.x, s);
        s = fmaf(k_reg[4 * d4 + 1], q4.y, s);
        s = fmaf(k_reg[4 * d4 + 2], q4.z, s);
        s = fmaf(k_reg[4 * d4 + 3], q4.w, s);
        dp = fmaf(v_reg[4 * d4 + 0], g4.x, dp);
        dp = fmaf(v_reg[4 * d4 + 1], g4.y, dp);
        dp = fmaf(v_reg[4 * d4 + 2], g4.z, dp);
        dp = fmaf(v_reg[4 * d4 + 3], g4.w, dp);
      }
      // The four threads of a key row are adjacent lanes.
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float p = key_valid ? expf(s - lse_s[j]) : 0.f;
      const float p_in = round_to_input<T>(p);
      const float ds = round_to_input<T>(p * (dp - delta_s[j]));
#pragma unroll
      for (int d4 = 0; d4 < kDimsPerThread / 4; ++d4) {
        const float4 q4 = qr[d4];
        const float4 g4 = gr[d4];
        dv_acc[4 * d4 + 0] = fmaf(p_in, g4.x, dv_acc[4 * d4 + 0]);
        dv_acc[4 * d4 + 1] = fmaf(p_in, g4.y, dv_acc[4 * d4 + 1]);
        dv_acc[4 * d4 + 2] = fmaf(p_in, g4.z, dv_acc[4 * d4 + 2]);
        dv_acc[4 * d4 + 3] = fmaf(p_in, g4.w, dv_acc[4 * d4 + 3]);
        dk_acc[4 * d4 + 0] = fmaf(ds, q4.x, dk_acc[4 * d4 + 0]);
        dk_acc[4 * d4 + 1] = fmaf(ds, q4.y, dk_acc[4 * d4 + 1]);
        dk_acc[4 * d4 + 2] = fmaf(ds, q4.z, dk_acc[4 * d4 + 2]);
        dk_acc[4 * d4 + 3] = fmaf(ds, q4.w, dk_acc[4 * d4 + 3]);
      }
      if (dim0 == 0) ds_t[j][local] = ds;
    }
    __syncthreads();

    // dq rows of this tile: thread (row `local`, dims dim0..dim0+15) sums
    // ds over the block's 64 keys (zero for keys past N).
    if (local < valid_q) {
      float acc[kDimsPerThread];
#pragma unroll
      for (int d = 0; d < kDimsPerThread; ++d) acc[d] = 0.f;
      for (int kk = 0; kk < kBlockKV; ++kk) {
        const float dsv = ds_t[local][kk];
        const float4* kr = reinterpret_cast<const float4*>(&k_tile[kk][dim0]);
#pragma unroll
        for (int d4 = 0; d4 < kDimsPerThread / 4; ++d4) {
          const float4 k4 = kr[d4];
          acc[4 * d4 + 0] = fmaf(dsv, k4.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(dsv, k4.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(dsv, k4.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(dsv, k4.w, acc[4 * d4 + 3]);
        }
      }
      float* dq_row = dq_bh + (q0 + local) * sdq.n + dim0;
#pragma unroll
      for (int d = 0; d < kDimsPerThread; ++d) atomicAdd(&dq_row[d], acc[d]);
    }
  }

  if (key_valid) {
    T* dk_row = dk + b * sdk.b + h * sdk.h + key * sdk.n + dim0;
    T* dv_row = dv + b * sdv.b + h * sdv.h + key * sdv.n + dim0;
#pragma unroll
    for (int d = 0; d < kDimsPerThread; ++d) {
      dk_row[d] = from_float<T>(dk_acc[d]);
      dv_row[d] = from_float<T>(dv_acc[d]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int batch, int heads,
                   int seq_len, Strides sq, Strides sk, Strides sv,
                   Strides sg, Strides sdq, Strides sdk, Strides sdv,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (seq_len + kBlockKV - 1) / kBlockKV);
  flash_bwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      heads, seq_len, sq, sk, sv, sg, sdq, sdk, sdv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dk, dv); dq is fp32 and
// must be zeroed by the caller; lse and delta are contiguous fp32
// (batch, heads, seq_len). Strides are in elements, for the batch, head
// and token axes; the head dim (64) must be contiguous. Returns the CUDA
// error of the launch (0 on success).
int vtd_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int dtype, int batch, int heads, int seq_len, long long q_sb,
    long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long g_sb, long long g_sh, long long g_sn, long long dq_sb,
    long long dq_sh, long long dq_sn, long long dk_sb, long long dk_sh,
    long long dk_sn, long long dv_sb, long long dv_sh, long long dv_sn,
    void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0) return cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn},
      sv{v_sb, v_sh, v_sn}, sg{g_sb, g_sh, g_sn}, sdq{dq_sb, dq_sh, dq_sn},
      sdk{dk_sb, dk_sh, dk_sn}, sdv{dv_sb, dv_sh, dv_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k, v, g, lse, delta, dq, dk, dv, batch, heads,
                        seq_len, sq, sk, sv, sg, sdq, sdk, sdv, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k, v, g, lse, delta, dq, dk, dv, batch,
                                heads, seq_len, sq, sk, sv, sg, sdq, sdk,
                                sdv, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
