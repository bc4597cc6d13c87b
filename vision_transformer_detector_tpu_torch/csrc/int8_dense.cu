// Fused int8 dense for Hopper (sm_90a), bound to Python through a plain C
// interface (kernels/quantization.py loads it with ctypes).
//
// Replaces the Pallas TPU kernel `_fused_int8_kernel` in
// vision_transformer_detector_tpu/kernels/quantization.py (launched by
// `fused_int8_dense`): per-row dynamic int8 quantization of the activations
// x (M, K), x_scale = max(|x|_max, 1e-8) / 127 and q = clip(round(x /
// x_scale), -127, 127), an int8 x int8 -> int32 product with the int8
// weight (K, N), then y = (float(acc) * x_scale) * w_scale + bias, an
// optional mish in fp32, and the cast out (bf16 for that kernel). The same
// source also serves the module's XLA route `int8_dense` (the attention
// q/k/v/out projections): there x comes in fp32 or bf16 and y goes out in
// fp32, with the same arithmetic.
//
// Numerics held to the JAX package bit for bit up to the output cast:
//   * round half to even (rintf), IEEE divisions for x_scale and x /
//     x_scale (__fdiv_rn; the build has no --use_fast_math), so codes at
//     .5 boundaries come out as in jnp.round;
//   * the int32 sums are exact; the epilogue multiplies and adds with
//     __fmul_rn / __fadd_rn, so nvcc fuses nothing into an FMA, in the
//     JAX order (acc * x_scale) * w_scale + bias;
//   * mish(y) = y * tanh(softplus(y)), softplus = max(y, 0) +
//     log1p(exp(-|y|)) (jax.nn.softplus), full-precision expf/tanhf.
//
// What bounds it: at vit_b16_384 batch 32 (M = 18,432) the 768 -> 1536
// layer is 2 * M * K * N = 4.35e10 int8 operations on about 86 MB of
// bf16 x, int8 w and bf16 y: at the card's int8 tensor rate (1,979 TOP/s)
// the bytes bound it (about 26 us at 3.35 TB/s). This version forms its
// products with __dp4a on the CUDA cores (4 multiply-adds per
// instruction), so it is bound by dp4a issue and shared-memory reads, at
// roughly two orders of magnitude below the tensor-core rate; wgmma with
// s8 operands is later work.
//
// Design:
//   * one block of 256 threads per 64 x 64 output tile;
//   * the scale needs the whole row, so each block first reads its 64 rows
//     over the full K (one warp per row, shuffle max) and keeps x_scale in
//     shared memory; it then reads x a second time, 64 k at a time, and
//     quantizes straight into shared memory. No int8 copy of x ever
//     reaches device memory, which is the point of the TPU kernel too;
//   * the weight tile is staged transposed, [n][k], so that 4 consecutive
//     k of one column are one 32-bit word for __dp4a; rows of both tiles
//     are padded to 17 words, so neither the staging nor the reads meet
//     bank conflicts;
//   * each thread owns a 4 x 4 micro-tile (rows ty + 16 i, columns
//     tx + 16 j) of int32 accumulators;
//   * ragged M, N and K are masked: out-of-range x and w load as 0, and a
//     zero code adds nothing to the sum; out-of-range outputs are not
//     written. Nothing is padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kWords = kBlockK / 4 + 1;   // int32 words per staged row

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

__device__ __forceinline__ uint32_t quantize(float v, float scale) {
  float t = rintf(__fdiv_rn(v, scale));
  t = fminf(fmaxf(t, -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(static_cast<int>(t))));
}

template <typename Tin, typename Tout, bool kMish>
__global__ void __launch_bounds__(kThreads) int8_dense_kernel(
    const Tin* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ wscale, const float* __restrict__ bias,
    Tout* __restrict__ out, int m, int n, int k) {
  __shared__ int x_tile[kBlockM * kWords];   // quantized x, [row][k / 4]
  __shared__ int w_tile[kBlockN * kWords];   // weight, [col][k / 4]
  __shared__ float row_scale[kBlockM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.y * kBlockM;
  const int col0 = blockIdx.x * kBlockN;

  // 1. x_scale of each row over the full K.
  for (int r = warp; r < kBlockM; r += kThreads / 32) {
    const int row = row0 + r;
    float amax = 0.0f;
    if (row < m) {
      const Tin* x_row = x + static_cast<long long>(row) * k;
      for (int kk = lane; kk < k; kk += 32) {
        amax = fmaxf(amax, fabsf(to_float(x_row[kk])));
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, offset));
    }
    if (lane == 0) row_scale[r] = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  }
  __syncthreads();

  const int tx = tid % 16;
  const int ty = tid / 16;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  }

  // The thread's slice of the x tile: 16 consecutive k of one row.
  const int xr = tid / 4;
  const int xk = (tid % 4) * 16;
  const int x_row = row0 + xr;
  const float x_scale = row_scale[xr];
  int8_t* w_bytes = reinterpret_cast<int8_t*>(w_tile);

  for (int k0 = 0; k0 < k; k0 += kBlockK) {
    // 2a. Quantize the x tile into shared memory, 4 codes per word.
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int byte = 0; byte < 4; ++byte) {
        const int kk = k0 + xk + 4 * w + byte;
        const float v = (x_row < m && kk < k)
                            ? to_float(x[static_cast<long long>(x_row) * k + kk])
                            : 0.0f;
        word |= quantize(v, x_scale) << (8 * byte);
      }
      x_tile[xr * kWords + xk / 4 + w] = static_cast<int>(word);
    }
    // 2b. Stage the weight tile transposed; reads run along n.
    for (int idx = tid; idx < kBlockK * kBlockN; idx += kThreads) {
      const int kk = idx / kBlockN;
      const int nn = idx % kBlockN;
      const int kg = k0 + kk;
      const int col = col0 + nn;
      w_bytes[nn * (kWords * 4) + kk] =
          (kg < k && col < n) ? wq[static_cast<long long>(kg) * n + col]
                              : static_cast<int8_t>(0);
    }
    __syncthreads();

    // 3. int32 dots, 4 k per __dp4a.
#pragma unroll
    for (int kw = 0; kw < kBlockK / 4; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = x_tile[(ty + 16 * i) * kWords + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = w_tile[(tx + 16 * j) * kWords + kw];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // 4. Epilogue: rescale, bias, optional mish, cast.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = row0 + r;
    if (row >= m) continue;
    const float scale = row_scale[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= n) continue;
      float y = __fmul_rn(__int2float_rn(acc[i][j]), scale);
      y = __fadd_rn(__fmul_rn(y, wscale[col]), bias[col]);
      if (kMish) y = mish(y);
      out[static_cast<long long>(row) * n + col] = from_float<Tout>(y);
    }
  }
}

template <typename Tin, typename Tout>
void launch(const void* x, const int8_t* wq, const float* wscale,
            const float* bias, void* out, int m, int n, int k, bool apply_mish,
            cudaStream_t stream) {
  const dim3 grid((n + kBlockN - 1) / kBlockN, (m + kBlockM - 1) / kBlockM);
  const Tin* xt = static_cast<const Tin*>(x);
  Tout* ot = static_cast<Tout*>(out);
  if (apply_mish) {
    int8_dense_kernel<Tin, Tout, true>
        <<<grid, kThreads, 0, stream>>>(xt, wq, wscale, bias, ot, m, n, k);
  } else {
    int8_dense_kernel<Tin, Tout, false>
        <<<grid, kThreads, 0, stream>>>(xt, wq, wscale, bias, ot, m, n, k);
  }
}

template <typename Tin>
int launch_out(int out_dtype, const void* x, const int8_t* wq,
               const float* wscale, const float* bias, void* out, int m,
               int n, int k, bool apply_mish, cudaStream_t stream) {
  if (out_dtype == 0) {
    launch<Tin, float>(x, wq, wscale, bias, out, m, n, k, apply_mish, stream);
  } else if (out_dtype == 1) {
    launch<Tin, __nv_bfloat16>(x, wq, wscale, bias, out, m, n, k, apply_mish,
                               stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// x: contiguous (m, k) in x_dtype; wq: contiguous int8 (k, n); wscale and
// bias: contiguous fp32 (n,); out: contiguous (m, n) in out_dtype.
// Dtypes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
int vtd_int8_dense(const void* x, const void* wq, const void* wscale,
                   const void* bias, void* out, int m, int n, int k,
                   int x_dtype, int out_dtype, int apply_mish, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* s = static_cast<const float*>(wscale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (x_dtype == 0) {
    err = launch_out<float>(out_dtype, x, w, s, b, out, m, n, k,
                            apply_mish != 0, st);
  } else if (x_dtype == 1) {
    err = launch_out<__nv_bfloat16>(out_dtype, x, w, s, b, out, m, n, k,
                                    apply_mish != 0, st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
