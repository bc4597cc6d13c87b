// What the two flash-attention backward sources share
// (flash_attention_bwd.cu for head dims K <= 128, flash_attention_bwd_wide.cu
// for K > 128): the tiles' constants, the per-score gradient math (so both
// replay the dropout mask and round alike), the stores, the partials route's
// sum kernel, the launch helper and the C entry point, which calls the
// `launch` each source defines. Two sources, so that nvcc builds them in
// parallel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "dropout_mask.cuh"
#include "flash_launch.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kBlock = 64;            // keys per CTA and queries per tile
constexpr int kThreads = 128;         // 4 warps of 16 keys
constexpr int kChunk = 64;            // the windowed route's output window
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, n;
};


// The 64 fp32 values of rows row0..row0+63 of a contiguous (seq_len,) row,
// zero past seq_len; threads 0..63 load lse, 64..127 delta.
__device__ __forceinline__ void load_rows_async(float* lse_dst,
                                                float* delta_dst,
                                                const float* lse_src,
                                                const float* delta_src,
                                                int row0, int seq_len,
                                                int tid) {
  const int i = tid & (kBlock - 1);
  const int row = row0 + i;
  const bool valid = row < seq_len;
  const float* src = (tid < kBlock ? lse_src : delta_src) + (valid ? row : 0);
  cp_async4((tid < kBlock ? lse_dst : delta_dst) + i, src, valid);
}

// P^T (scaled by the replayed mask) into s and dS^T into dp, for this
// lane's keys (rows r = e >> 1 of each n-tile, valid where key_ok) and the
// queries q0 + s0 + 8j + 2t + (e & 1); lse_t and delta_t hold the query
// tile's rows from q0.
template <bool kDropout, int kTiles>
__device__ __forceinline__ void grads_t(float (&s)[kTiles][4],
                                        float (&dp)[kTiles][4],
                                        const bool (&key_ok)[2],
                                        const unsigned int (&hash_key)[2],
                                        const float* lse_t,
                                        const float* delta_t, int q0, int s0,
                                        int seq_len, int t,
                                        const Dropout& drop) {
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int col = s0 + 8 * j + 2 * t + (e & 1);
      const int query = q0 + col;
      const float p = key_ok[r] && query < seq_len
                          ? exp2f(fmaf(s[j][e], kLog2e, -lse_t[col] * kLog2e))
                          : 0.f;
      float scale = 1.f;
      if (kDropout) {
        scale = keep(drop, hash_key[r] + query_term(drop,
                                                    static_cast<unsigned int>(
                                                        query)))
                    ? drop.inv_keep
                    : 0.f;
      }
      s[j][e] = p * scale;
      dp[j][e] = p * (dp[j][e] * scale - delta_t[col]);
    }
  }
}

// dS into dp for this lane's queries (rows r = e >> 1, valid where
// query_ok; lse_r in log2 units) and the keys kv0 + 8j + 2t + (e & 1).
template <bool kDropout, int kTiles>
__device__ __forceinline__ void grads_q(const float (&s)[kTiles][4],
                                        float (&dp)[kTiles][4],
                                        const bool (&query_ok)[2],
                                        const unsigned int (&hash_query)[2],
                                        const float (&lse_r)[2],
                                        const float (&delta_r)[2], int kv0,
                                        int seq_len, int t,
                                        const Dropout& drop) {
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int key = kv0 + 8 * j + 2 * t + (e & 1);
      const float p = query_ok[r] && key < seq_len
                          ? exp2f(fmaf(s[j][e], kLog2e, -lse_r[r]))
                          : 0.f;
      float scale = 1.f;
      if (kDropout) {
        scale = keep(drop, hash_query[r] +
                               key_term(drop, static_cast<unsigned int>(key)))
                    ? drop.inv_keep
                    : 0.f;
      }
      dp[j][e] = p * (dp[j][e] * scale - delta_r[r]);
    }
  }
}

// A warp's accumulator rows row0 and row0 + 8 (where ok), columns col0..
// (none past kdim), stored as O through the row stride.
template <int kTiles, typename O>
__device__ __forceinline__ void store_rows(const float (&acc)[kTiles][4],
                                           O* base, long long row_stride,
                                           const bool (&ok)[2], int row0,
                                           int col0, int kdim, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ok[r]) continue;
    O* p = base + (row0 + 8 * r) * row_stride + col0 + 2 * t;
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (col0 + 8 * j + 2 * t < kdim) {
        store_pair(p + 8 * j, acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

// One key tile's dq contribution to a warp's 16 query rows (from row0, the
// lane's g added) at columns col0.. (below col_end, by default K), into the
// partials workspace laid out (tiles, bh_count, seq_len, kdim). Lanes t and
// t ^ 1 swap halves, so each stores four adjacent values of one row: an
// even lane row g, columns 8j + 2t .. + 3; an odd lane row g + 8, columns
// 8j + 2(t - 1) .. + 3.
template <int kTiles>
__device__ __forceinline__ void store_partials(
    const float (&dq_acc)[kTiles][4], float* partials, int tile,
    int bh_count, int bh, int seq_len, int kdim, int row0, int col0, int t,
    int col_end = 0x7fffffff) {
  const int limit = min(kdim, col_end);
  const bool odd = t & 1;
  const int row = row0 + (odd ? 8 : 0);
  const int col = col0 + 2 * (t & ~1);
  float* dq_row =
      partials +
      ((static_cast<long long>(tile) * bh_count + bh) * seq_len + row) *
          kdim +
      col;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const float x0 = odd ? dq_acc[j][0] : dq_acc[j][2];
    const float x1 = odd ? dq_acc[j][1] : dq_acc[j][3];
    const float r0 = __shfl_xor_sync(0xffffffffu, x0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, x1, 1);
    if (row < seq_len && col + 8 * j < limit) {
      *reinterpret_cast<float4*>(dq_row + 8 * j) =
          odd ? make_float4(r0, r1, dq_acc[j][2], dq_acc[j][3])
              : make_float4(dq_acc[j][0], dq_acc[j][1], r0, r1);
    }
  }
}


// dq from the dk/dv kernels' partials: thread i sums four adjacent columns
// of one (batch*head, query) row over the key tiles in order,
// dq = ((c0 + c1) + c2) + ..., and stores them through dq's strides. The
// partials' rows are kdim wide (kdim % 4 == 0: fp32 rows of 16 bytes).
__global__ void __launch_bounds__(256)
flash_bwd_dq_sum_kernel(const float* __restrict__ partials,
                        float* __restrict__ dq, int heads, int seq_len,
                        int kdim, int tiles, long long rows, Strides sdq) {
  const long long quads = kdim / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= rows * quads) return;
  const long long row = i / quads;   // bh * seq_len + query
  const int col = 4 * static_cast<int>(i % quads);
  const float4* src =
      reinterpret_cast<const float4*>(partials + row * kdim + col);
  const long long tile_stride = rows * quads;
  float4 acc = src[0];
  for (int j = 1; j < tiles; ++j) {
    const float4 c = src[j * tile_stride];
    acc.x += c.x;
    acc.y += c.y;
    acc.z += c.z;
    acc.w += c.w;
  }
  const int bh = static_cast<int>(row / seq_len);
  const int query = static_cast<int>(row % seq_len);
  *reinterpret_cast<float4*>(dq + (bh / heads) * sdq.b +
                             (bh % heads) * sdq.h + query * sdq.n + col) =
      acc;
}


struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;
  const float* delta;
  float* dq;
  void* dk;
  void* dv;
  float* partials;
  int batch, heads, seq_len, kdim;
  Strides sq, sk, sv, sg, sdq, sdk, sdv;
  Dropout drop;
  cudaStream_t stream;
  int dq_bf16;   // dq written in bf16 (the wide source's bf16 routes)
  void* scores;  // the windowed route's workspace, ws_rows rows of P, dS
  int ws_rows;
};

// Launches kernel over (batch * heads * tiles, windows) blocks of kThreads
// with smem bytes of dynamic shared memory, its arguments after the grid's.
template <typename Kernel, typename... Args>
cudaError_t run(Kernel kernel, int smem, std::atomic<unsigned long long>& ok,
                const Launch& a, unsigned int windows, Args... args) {
  cudaError_t err = allow_dynamic_smem(kernel, smem, ok);
  if (err != cudaSuccess) return err;
  const int tiles = (a.seq_len + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(a.batch) * a.heads * tiles;
  if (blocks > 0x7fffffffLL || windows > 65535u) {
    return cudaErrorInvalidConfiguration;
  }
  kernel<<<dim3(static_cast<unsigned int>(blocks), windows), kThreads, smem,
           a.stream>>>(args...);
  return cudaGetLastError();
}

// dq from the partials workspace, summed in key order.
inline cudaError_t sum_partials(const Launch& a) {
  const int tiles = (a.seq_len + kBlock - 1) / kBlock;
  const long long rows = static_cast<long long>(a.batch) * a.heads * a.seq_len;
  const long long sum_blocks = (rows * (a.kdim / 4) + 255) / 256;
  if (sum_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_bwd_dq_sum_kernel<<<static_cast<unsigned int>(sum_blocks), 256, 0,
                            a.stream>>>(a.partials, a.dq, a.heads, a.seq_len,
                                        a.kdim, tiles, rows, a.sdq);
  return cudaGetLastError();
}


// Each source's dispatch of one launch by head dim and dropout.
template <typename T, typename O>
cudaError_t launch(bool dropout, const Launch& a);

}  // namespace

extern "C" {

// One launch from the plan's argument block `args` (flash_launch.cuh) and
// the call's device addresses and stream. dtype 0 = float32, 1 = bfloat16
// (q, k, v, g, and dk, dv unless dkv_fp32, which writes them in fp32: a
// ring attention block's dk and dv join fp32 sums unrounded); dq is fp32
// (dq_bf16 1 writes it in bf16, which only flash_attention_bwd_wide.cu's
// bf16 routes take), every element written by the kernels; lse and
// delta are contiguous fp32 (batch, heads, seq_len). workspace: with
// args->ws_rows > 0 (flash_attention_bwd_wide.cu's windowed route) the
// scores workspace, (ws_rows, 2, np, np) in the input type with np = 64 *
// ceil(seq_len / 64); else null for the split route, or, in fp32 only, a
// (tiles, batch * heads, seq_len, head_dim) fp32 workspace for the
// partials route, tiles = ceil(seq_len / 64); dq's rows must then be
// 16-byte aligned too.
// head_dim: the caller's K, with K * the element size a multiple of 16
// bytes; the head dim must be contiguous and every row 16-byte aligned.
// seed: with dropout, the device address of the forward's uint32 seed;
// delta is then rowsum(g * out) of the dropped output. Runs on
// args->device and restores the caller's device. Returns the CUDA error of
// the launch (0 on success).
int vtd_flash_attention_bwd(const FlashBwdArgs* args, const void* q,
                            const void* k, const void* v, const void* g,
                            const void* lse, const void* delta, void* dq,
                            void* dk, void* dv, void* workspace,
                            const unsigned int* seed, void* stream) {
  const FlashBwdArgs& p = *args;
  if (p.batch <= 0 || p.heads <= 0 || p.seq_len <= 0 || p.head_dim <= 0) {
    return cudaErrorInvalidValue;
  }
  if (p.dropout != 0 && seed == nullptr) return cudaErrorInvalidValue;
  if (p.inner_local == 0) return cudaErrorInvalidValue;
  const bool scores = p.ws_rows > 0;
  void* partials = scores ? nullptr : workspace;
  if (partials != nullptr && p.head_dim % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  const Launch a{q, k, v, g, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), static_cast<float*>(dq),
                 dk, dv, static_cast<float*>(partials), p.batch, p.heads,
                 p.seq_len, p.head_dim, strides_of<Strides>(p.strides, 0),
                 strides_of<Strides>(p.strides, 1),
                 strides_of<Strides>(p.strides, 2),
                 strides_of<Strides>(p.strides, 3),
                 strides_of<Strides>(p.strides, 4),
                 strides_of<Strides>(p.strides, 5),
                 strides_of<Strides>(p.strides, 6), dropout_of(p, seed),
                 static_cast<cudaStream_t>(stream),
                 p.dq_bf16 != 0 ? 1 : 0, scores ? workspace : nullptr,
                 p.ws_rows};
  const DeviceScope scope(p.device);
  if (scope.error() != cudaSuccess) return scope.error();
  const bool dropout = p.dropout != 0;
  cudaError_t err;
  if (p.dtype == 0) {
    err = launch<float, float>(dropout, a);
  } else if (p.dtype == 1 && p.dkv_fp32 != 0) {
    if (partials != nullptr) return cudaErrorInvalidValue;
    err = launch<__nv_bfloat16, float>(dropout, a);
  } else if (p.dtype == 1) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(dropout, a);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

