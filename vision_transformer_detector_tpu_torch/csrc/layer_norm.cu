// Fused LayerNorm for Hopper (sm_90a), bound to Python through a plain C
// interface (kernels/fused_ln.py loads it with ctypes).
//
// Replaces the Pallas TPU kernel `_ln_kernel` in
// vision_transformer_detector_tpu/kernels/fused_ln.py (launched by
// `fused_layer_norm`): LayerNorm over the last axis of a (rows, D) array
// with D % 128 == 0, all math in fp32, a two-pass variance (mean first,
// then the mean of (x - mean)^2, as jnp.var), eps added before the
// reciprocal square root, then * gamma + beta and the cast back to x's
// dtype. rsqrtf is the hardware approximation (within 2 ulp), so the
// output differs from the plain version by a few fp32 ulp.
//
// What bounds it: it reads each element once and writes it once, about 5
// FLOP per element, so memory bounds it: (18,432, 768) bf16 at
// vit_b16_384 batch 32 is 56.6 MB, about 17 us at 3.35 TB/s.
//
// Design: one warp per row, 8 rows per 256-thread block. A lane holds
// D / 32 values of its row in registers, as chunks of 4 neighbours (a
// 16-byte load for fp32, 8 bytes for bf16), lane-major within each
// 128-wide chunk so that a warp's load is one contiguous span. Both
// reductions are warp shuffles over the values in registers: the row is
// read from device memory once, as the TPU kernel keeps its tile resident
// in VMEM. D up to 4096 (chunks of 128: 8 for D <= 1024, else 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

template <typename T, int kMaxChunks>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ out, int rows, int d,
    float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;   // a whole warp leaves together
  const int chunks = d / 128;
  const long long base = static_cast<long long>(row) * d;

  float v[kMaxChunks][4];
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c < chunks) {
      load4(x + base + c * 128 + lane * 4, v[c]);
      sum += (v[c][0] + v[c][1]) + (v[c][2] + v[c][3]);
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(d);

  float squares = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c < chunks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[c][i] -= mean;
        squares += v[c][i] * v[c][i];
      }
    }
  }
  const float var = warp_sum(squares) / static_cast<float>(d);
  const float inv = rsqrtf(var + eps);

#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (c < chunks) {
      const int col = c * 128 + lane * 4;
      float g[4], b[4], y[4];
      load4(gamma + col, g);
      load4(beta + col, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i] = v[c][i] * inv * g[i] + b[i];
      store4(out + base + col, y);
    }
  }
}

template <typename T>
void launch(const void* x, const float* gamma, const float* beta, void* out,
            int rows, int d, float eps, cudaStream_t stream) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (d <= 1024) {
    layer_norm_kernel<T, 8>
        <<<blocks, kThreads, 0, stream>>>(xt, gamma, beta, ot, rows, d, eps);
  } else {
    layer_norm_kernel<T, 32>
        <<<blocks, kThreads, 0, stream>>>(xt, gamma, beta, ot, rows, d, eps);
  }
}

}  // namespace

extern "C" {

// x and out: contiguous (rows, d) in dtype (0 = float32, 1 = bfloat16),
// 16-byte aligned; gamma and beta: contiguous fp32 (d,). d % 128 == 0 and
// d <= 4096. Returns cudaGetLastError() after the launch (0 on success).
int vtd_layer_norm(const void* x, const void* gamma, const void* beta,
                   void* out, int rows, int d, float eps, int dtype,
                   void* stream) {
  if (rows <= 0 || d <= 0 || d % 128 != 0 || d > 4096) {
    return cudaErrorInvalidValue;
  }
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, g, b, out, rows, d, eps, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, g, b, out, rows, d, eps, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
