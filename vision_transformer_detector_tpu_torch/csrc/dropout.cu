// Dropout of the model's MLP and head activations for Hopper (sm_90a),
// bound to Python through a plain C interface (kernels/dropout.py loads it
// with ctypes).
//
// No Pallas kernel: the JAX package draws these masks with jax.random in
// `_dropout` (vision_transformer_detector_tpu/models/vit_detector.py),
// which the port does not reproduce bit for bit. The port's mask is the
// attention mask's counter hash (dropout_mask.cuh, `dropout_keep_mask`) of
// the layer's seed at batch*head 0 over each element's (row, column)
// index, the rows being all leading axes of a contiguous (rows, cols)
// array, counted from `row_base`: out = keep ? x * (1 / (1 - rate)) : 0,
// in x's dtype. The seed is
// read from device memory, so a captured CUDA graph replays each step with
// the seed its caller wrote there, and a block recomputed under remat (or
// the backward, which applies the same function to the cotangent) draws the
// same mask. The product is x * inv_keep in fp32 rounded once to x's dtype,
// the plain version's `x / keep` as PyTorch computes it on the card (a
// multiply by the scalar's fp32 reciprocal), so the two agree bit for bit.
//
// What bounds it: each element is read once and written once, with about
// 12 integer operations for its hash, so memory bounds it: highres_1024's
// first pyramid layer at batch 8, (32,768, 2048) bf16, moves 268 MB, 0.080
// ms at 3.35 TB/s.
//
// Design: a grid-stride loop over 16-byte chunks of a row (8 bf16 or 4
// fp32 values), one 16-byte load and store each, when the row length is a
// multiple of the chunk and both arrays are 16-byte aligned; otherwise one
// element at a time. Each chunk's row and column come from one 64-bit
// division of its flat index; the row's part of the hash sum is added to
// each column's term.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_mask.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // 16 blocks per SM of an H100 SXM

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

// kVec consecutive values of T, moved as one aligned load or store.
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) dropout_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long rows, int cols,
    Dropout d) {
  const unsigned int seed = load_seed(d);
  const int chunks = cols / kVec;
  const long long total = rows * chunks;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += stride) {
    const long long row = i / chunks;
    const int col = static_cast<int>(i - row * chunks) * kVec;
    const unsigned int part =
        hash_part(d, seed, 0u) +
        query_term(d, static_cast<unsigned int>(row));
    const long long at = row * cols + col;
    Pack<T, kVec> p = *reinterpret_cast<const Pack<T, kVec>*>(x + at);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool kept =
          keep(d, part + key_term(d, static_cast<unsigned int>(col + j)));
      p.v[j] = from_float<T>(kept ? to_float(p.v[j]) * d.inv_keep : 0.0f);
    }
    *reinterpret_cast<Pack<T, kVec>*>(out + at) = p;
  }
}

template <typename T>
void launch(const void* x, void* out, long long rows, int cols, bool packed,
            const Dropout& d, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec = packed ? kVec : 1;
  const long long total = rows * (cols / vec);
  const int blocks = static_cast<int>(
      total / kThreads + 1 < kMaxBlocks ? total / kThreads + 1 : kMaxBlocks);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (packed) {
    dropout_kernel<T, kVec>
        <<<blocks, kThreads, 0, stream>>>(xt, ot, rows, cols, d);
  } else {
    dropout_kernel<T, 1>
        <<<blocks, kThreads, 0, stream>>>(xt, ot, rows, cols, d);
  }
}

}  // namespace

extern "C" {

// x and out: contiguous (rows, cols) arrays in dtype (0 = float32,
// 1 = bfloat16); seed: the device address of the uint32 seed; threshold:
// keep iff hash < threshold; inv_keep: the fp32 reciprocal of 1 - rate;
// row_base: the global row of x's first (0 for the whole array; a rank of a
// data-parallel run passes its first row of the global batch).
// Returns cudaGetLastError() after the launch (0 on success).
int vtd_dropout(const void* x, void* out, long long rows, int cols,
                int dtype, const unsigned int* seed, unsigned int threshold,
                float inv_keep, unsigned int row_base, void* stream) {
  if (rows <= 0 || cols <= 0 || seed == nullptr) return cudaErrorInvalidValue;
  const Dropout drop{seed, threshold, inv_keep, 0u, row_base, 0u};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (dtype == 0) {
    launch<float>(x, out, rows, cols, aligned && cols % 4 == 0, drop, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, out, rows, cols, aligned && cols % 8 == 0, drop,
                          s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
