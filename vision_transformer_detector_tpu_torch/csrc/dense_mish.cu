// Fused dense + bias + mish for Hopper (sm_90a), bound to Python through a
// plain C interface (kernels/fused_ffn.py loads it with ctypes).
//
// Replaces the Pallas TPU kernel `_ffn_kernel` in
// vision_transformer_detector_tpu/kernels/fused_ffn.py (launched by
// `_fused_forward`): y = x @ w + b with fp32 accumulation, then mish(y) =
// y * tanh(softplus(y)) in fp32 (softplus = max(y, 0) + log1p(exp(-|y|)),
// as jax.nn.softplus), then the cast to x's dtype. x (M, K), w (K, N) and
// b (N,) all come in the compute dtype (fp32 or bf16), as the model hands
// them over; the operands are upcast to fp32, where bf16 x bf16 products
// are exact, and multiplied-added in fp32.
//
// What bounds it: the 768 -> 1536 layer of vit_b16_384 at batch 32 is
// 2 * 18,432 * 768 * 1536 = 4.35e10 FLOP on 88 MB of bf16: at the card's
// bf16 tensor rate (989 TFLOP/s) about 44 us, so a tensor-core version is
// bound by its operations. This version keeps the products on the fp32
// CUDA cores (67 TFLOP/s peak, 0.65 ms for that layer at best) and is a
// plain tiled GEMM, bound by fp32 FMA issue and shared-memory reads; mma /
// wgmma with bf16 operands is later work.
//
// Design: one block of 256 threads per 64 x 64 output tile; 16-deep k
// tiles of x (stored k-major, rows padded to 65 floats, so the transposing
// store meets no bank conflicts) and of w staged in shared memory as
// fp32; each thread owns a 4 x 4 micro-tile (rows ty + 16 i, columns
// tx + 16 j) of fp32 accumulators; bias, mish and the cast run in the
// epilogue before the only write of the output tile, which is what the
// TPU kernel's single VMEM round trip is for. Ragged M, N and K are
// masked (out-of-range operands load as 0); nothing is padded in device
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kBlockK = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float mish(float y) {
  const float softplus = fmaxf(y, 0.0f) + log1pf(expf(-fabsf(y)));
  return y * tanhf(softplus);
}

template <typename T, bool kMish>
__global__ void __launch_bounds__(kThreads) dense_mish_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    T* __restrict__ out, int m, int n, int k) {
  __shared__ float x_tile[kBlockK][kBlockM + 1];   // [k][row]
  __shared__ float w_tile[kBlockK][kBlockN];       // [k][col]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBlockM;
  const int col0 = blockIdx.x * kBlockN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < k; k0 += kBlockK) {
#pragma unroll
    for (int l = 0; l < (kBlockM * kBlockK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kBlockK;
      const int kk = idx % kBlockK;
      const int row = row0 + r;
      const int kg = k0 + kk;
      x_tile[kk][r] = (row < m && kg < k)
                          ? to_float(x[static_cast<long long>(row) * k + kg])
                          : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < (kBlockN * kBlockK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int kk = idx / kBlockN;
      const int c = idx % kBlockN;
      const int col = col0 + c;
      const int kg = k0 + kk;
      w_tile[kk][c] = (col < n && kg < k)
                          ? to_float(w[static_cast<long long>(kg) * n + col])
                          : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBlockK; ++kk) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = x_tile[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = w_tile[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= n) continue;
      float y = acc[i][j] + to_float(b[col]);
      if (kMish) y = mish(y);
      out[static_cast<long long>(row) * n + col] = from_float<T>(y);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* out, int m,
            int n, int k, bool apply_mish, cudaStream_t stream) {
  const dim3 grid((n + kBlockN - 1) / kBlockN, (m + kBlockM - 1) / kBlockM);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  if (apply_mish) {
    dense_mish_kernel<T, true>
        <<<grid, kThreads, 0, stream>>>(xt, wt, bt, ot, m, n, k);
  } else {
    dense_mish_kernel<T, false>
        <<<grid, kThreads, 0, stream>>>(xt, wt, bt, ot, m, n, k);
  }
}

}  // namespace

extern "C" {

// x: contiguous (m, k); w: contiguous (k, n); b: contiguous (n,); out:
// contiguous (m, n); all in dtype (0 = float32, 1 = bfloat16). Returns
// cudaGetLastError() after the launch (0 on success).
int vtd_dense_mish(const void* x, const void* w, const void* b, void* out,
                   int m, int n, int k, int dtype, int apply_mish,
                   void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, w, b, out, m, n, k, apply_mish != 0, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, w, b, out, m, n, k, apply_mish != 0, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
