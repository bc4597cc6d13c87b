// Flash-attention backward for Hopper (sm_90a) on the tensor cores, bound to
// Python through a plain C interface (kernels/flash_attention.py loads it
// with ctypes).
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
// with fp32 accumulation, as the Pallas kernel does. With dropout on, it is
// the gradient of `_flash_bwd_chunked`'s dropout branch in the same single
// pass: each score regenerates the forward's keep mask from the global
// (batch*head, query, key) indices (dropout_mask.cuh), and with
// scale = keep / (1 - rate)
//   dv = (scale * p)^T g              (rounded to the input type first)
//   ds = p * (scale * (g v^T) - delta)
// where delta = rowsum(g * out) of the DROPPED output, which equals
// rowsum(p * scale * (g v^T)), the chunked backward's correction.
//
// What bounds it (one H100 SXM: 989 TFLOP/s bf16, 495 TF32, 3.35 TB/s):
//   * highres_1024 training, (B*H, N, K) = (2048, 256, 64) bf16, with or
//     without the dropout replay: five products, 10 * 2048 * 256^2 * 64 =
//     85.9 GFLOP, on 541 MB (q, k, v, g read and dk, dv written in bf16, dq
//     written and lse, delta read in fp32), 159 FLOP per byte: below the
//     bf16 ridge (about 295), bound by bytes at 0.162 ms;
//   * reference_608 training, (64, 1296, 40) fp32: 43.0 GFLOP (K = 40) on
//     94 MB, done as 3xTF32: bound by operations at 3 * 43.0 G / 495 T =
//     0.26 ms.
// As in the forward, the kernel is held by the latency of the chain between
// its products (exp, the mask replay, the casts, the dS round trip through
// shared memory) and by dq's atomics, not by bytes or the tensor cores: as
// measured by chip_smoke.py (H100 SXM, 700 W), 0.78 ms with the replay at
// (2048, 256, 64), 110 TFLOP/s, 21 % of its bound; 1.8 ms in fp32, 15 %.
//
// Design (FA2's backward, for this card):
//   * one CTA of 4 warps per (batch*head, 64-key tile); each warp owns 16
//     keys. K and V are loaded once into shared memory in the input type;
//     dk and dv accumulate in registers (mma accumulator layout) for the
//     whole loop;
//   * the CTA loops over 64-query tiles; q, g, lse and delta are
//     double-buffered by cp.async (16-byte copies for q and g, 4-byte for
//     the fp32 lse/delta rows, which need not be aligned);
//   * key-major products, so that each accumulator is the next product's A
//     fragment with no shuffle: S^T = K Q^T and dP^T = V g^T (mma, fp32
//     accumulation); P^T = exp(S^T - lse), one exp per owned score, masked
//     for queries and keys past N; dV += (scale * P^T, cast to the input
//     type) g; dS^T = P^T * (scale * dP^T - delta), cast to the input type;
//     dK += dS^T Q. The mask is replayed by the owning lane, once per score;
//   * dQ = dS K: dS^T goes through a shared tile, and each warp forms 16
//     query rows of the tile's dq contribution with mma, then adds it into
//     the wrapper's zeroed fp32 dq with float4 atomicAdd (global memory,
//     compute capability 9.x): lanes t and t ^ 1 swap a pair of columns so
//     each holds four adjacent values of one row, a quarter of the atomics
//     of a scalar add per value. The order of those adds changes from run
//     to run, so dq agrees with a serial sum up to fp32 rounding of the
//     partial sums, not bit for bit;
//   * fp32 runs the same code on TF32 with the 3xTF32 split of every
//     operand (mma_sm90.cuh); head dim 48 or 64 as in the forward;
//   * dk and dv are cast to the input type and stored through the caller's
//     strides; keys past N are never written, queries past N never touch
//     dq.
// Budget (-Xptxas -v, sm_90a, CUDA 12.8), per instance without / with the
// replay: registers 218 / 245 (bf16, 64), 205 / 228 (bf16, 48), and 255
// with 16-40 bytes of spills in every fp32 instance, so 2 CTAs share an
// SM (1 in fp32 at D = 64, for shared memory). Shared memory: K, V, two q and
// two g tiles of 64 x (D + 16 bytes), the dS^T tile of 64 x (64 + 16
// bytes), two lse and two delta rows: 65,536 bytes (bf16, 64), 53,248
// (bf16, 48), 122,880 (fp32, 64), 98,304 (fp32, 48), dynamic, with
// cudaFuncAttributeMaxDynamicSharedMemorySize raised once per device.
// chip_smoke.py's build phase prints these numbers and the HMMA count of
// each instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dropout_mask.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kBlock = 64;            // keys per CTA and queries per tile
constexpr int kThreads = 128;         // 4 warps of 16 keys
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, n;
};

template <typename T>
constexpr int smem_bytes(int d) {
  return (6 * kBlock * (d + Mma<T>::kPad) +
          kBlock * (kBlock + Mma<T>::kPad)) *
             static_cast<int>(sizeof(T)) +
         4 * kBlock * static_cast<int>(sizeof(float));
}

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

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 T* __restrict__ dk, T* __restrict__ dv, int heads,
                 int seq_len, int kv_tiles, Strides sq, Strides sk,
                 Strides sv, Strides sg, Strides sdq, Strides sdk,
                 Strides sdv, Dropout drop) {
  using M = Mma<T>;
  constexpr int kLd = D + M::kPad;
  constexpr int kTile = kBlock * kLd;
  constexpr int kLdS = kBlock + M::kPad;   // dS^T rows: [key][query]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kTile;
  T* q_s = v_s + kTile;          // two buffers
  T* g_s = q_s + 2 * kTile;      // two buffers
  T* ds_s = g_s + 2 * kTile;
  float* lse_s = reinterpret_cast<float*>(ds_s + kBlock * kLdS);   // two
  float* delta_s = lse_s + 2 * kBlock;                              // two

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;   // the fragment's row group g
  const int t = lane & 3;
  // Key tiles of one (batch, head) are neighbours in launch order, so its
  // q and g are read from device memory once and from L2 after that.
  const int bh = blockIdx.x / kv_tiles;
  const int kv0 = (blockIdx.x % kv_tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const T* q_bh = q + b * sq.b + h * sq.h;
  const T* g_bh = g + b * sg.b + h * sg.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * seq_len;
  const float* delta_bh = delta + static_cast<long long>(bh) * seq_len;

  load_tile_async<T, D, kBlock, kThreads>(k_s, k + b * sk.b + h * sk.h, sk.n,
                                          kv0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(v_s, v + b * sv.b + h * sv.h, sv.n,
                                          kv0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(q_s, q_bh, sq.n, 0, seq_len, tid);
  load_tile_async<T, D, kBlock, kThreads>(g_s, g_bh, sg.n, 0, seq_len, tid);
  load_rows_async(lse_s, delta_s, lse_bh, delta_bh, 0, seq_len, tid);
  cp_async_commit();

  // This lane's keys: kv0 + 16 * warp + gr (r = 0) and + 8 (r = 1).
  bool key_ok[2];
  unsigned int hash_key[2] = {0u, 0u};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kv0 + 16 * warp + gr + 8 * r;
    key_ok[r] = key < seq_len;
    if (kDropout) {
      hash_key[r] = hash_part(drop, static_cast<unsigned int>(bh)) +
                    key_term(static_cast<unsigned int>(key));
    }
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }
  }
  float* dq_bh = dq + b * sdq.b + h * sdq.h;

  const int q_tiles = (seq_len + kBlock - 1) / kBlock;
  for (int it = 0; it < q_tiles; ++it) {
    const int q0 = it * kBlock;
    const int buf = it & 1;
    if (it + 1 < q_tiles) {
      // Into the other buffers, which every warp finished reading before
      // the previous iteration's dS barrier.
      const int nb = buf ^ 1;
      load_tile_async<T, D, kBlock, kThreads>(q_s + nb * kTile, q_bh, sq.n,
                                              q0 + kBlock, seq_len, tid);
      load_tile_async<T, D, kBlock, kThreads>(g_s + nb * kTile, g_bh, sg.n,
                                              q0 + kBlock, seq_len, tid);
      load_rows_async(lse_s + nb * kBlock, delta_s + nb * kBlock, lse_bh,
                      delta_bh, q0 + kBlock, seq_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* q_t = q_s + buf * kTile;
    const T* g_t = g_s + buf * kTile;
    const float* lse_t = lse_s + buf * kBlock;
    const float* delta_t = delta_s + buf * kBlock;

    // S^T = K Q^T and dP^T = V g^T: 16 keys x 64 queries per warp.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      typename M::A ka, va;
      M::load_a(ka, k_s, kLd, 16 * warp, 16 * kc, lane);
      M::load_a(va, v_s, kLd, 16 * warp, 16 * kc, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        typename M::B b0, b1;
        M::load_b_nk(b0, b1, q_t, kLd, 16 * np, 16 * kc, lane);
        M::mma(s[2 * np], ka, b0);
        M::mma(s[2 * np + 1], ka, b1);
        M::load_b_nk(b0, b1, g_t, kLd, 16 * np, 16 * kc, lane);
        M::mma(dp[2 * np], va, b0);
        M::mma(dp[2 * np + 1], va, b1);
      }
    }

    // P^T (scaled by the replayed mask) into s, dS^T into dp: rows are
    // keys (e >> 1), columns queries 8j + 2t + (e & 1).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = 8 * j + 2 * t + (e & 1);
        const int query = q0 + col;
        const float p =
            key_ok[r] && query < seq_len
                ? exp2f(fmaf(s[j][e], kLog2e, -lse_t[col] * kLog2e))
                : 0.f;
        float scale = 1.f;
        if (kDropout) {
          scale = keep(drop, hash_key[r] +
                                 query_term(static_cast<unsigned int>(query)))
                      ? drop.inv_keep
                      : 0.f;
        }
        s[j][e] = p * scale;
        dp[j][e] = p * (dp[j][e] * scale - delta_t[col]);
      }
    }

    // dV += P^T g and dK += dS^T Q, each A fragment rounded to the input
    // type; dS^T (rounded) to shared memory for dQ.
    add_acc_kn<T, kBlock, D>(dv_acc, s, g_t, kLd, lane);
    add_acc_kn<T, kBlock, D>(dk_acc, dp, q_t, kLd, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        store_pair(ds_s + (16 * warp + gr + 8 * r) * kLdS + 8 * j + 2 * t,
                   dp[j][2 * r], dp[j][2 * r + 1]);
      }
    }
    __syncthreads();

    // dQ rows q0 + 16 * warp .. + 15 = dS (16 queries x 64 keys) K.
    float dq_acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < kBlock / 16; ++kc) {
      typename M::A a;
      M::load_a_t(a, ds_s, kLdS, 16 * kc, 16 * warp, lane);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        typename M::B b0, b1;
        M::load_b_kn(b0, b1, k_s, kLd, 16 * kc, 16 * np, lane);
        M::mma(dq_acc[2 * np], a, b0);
        M::mma(dq_acc[2 * np + 1], a, b1);
      }
    }
    // Lanes t and t ^ 1 swap halves: an even lane adds row gr, columns
    // 8j + 2t .. + 3; an odd lane row gr + 8, columns 8j + 2(t - 1) .. + 3.
    const bool odd = t & 1;
    const int row = q0 + 16 * warp + gr + (odd ? 8 : 0);
    float* dq_row = dq_bh + row * sdq.n + 2 * (t & ~1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float s0 = odd ? dq_acc[j][0] : dq_acc[j][2];
      const float s1 = odd ? dq_acc[j][1] : dq_acc[j][3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      const float4 add =
          odd ? make_float4(r0, r1, dq_acc[j][2], dq_acc[j][3])
              : make_float4(dq_acc[j][0], dq_acc[j][1], r0, r1);
      if (row < seq_len) {
        atomicAdd(reinterpret_cast<float4*>(dq_row + 8 * j), add);
      }
    }
  }

  T* dk_bh = dk + b * sdk.b + h * sdk.h;
  T* dv_bh = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kv0 + 16 * warp + gr + 8 * r;
    if (!key_ok[r]) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_pair(dk_bh + key * sdk.n + 8 * j + 2 * t, dk_acc[j][2 * r],
                 dk_acc[j][2 * r + 1]);
      store_pair(dv_bh + key * sdv.n + 8 * j + 2 * t, dv_acc[j][2 * r],
                 dv_acc[j][2 * r + 1]);
    }
  }
}

template <typename T, int D, bool kDropout>
cudaError_t launch_kernel(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dq, void* dk, void* dv, int batch, int heads,
                          int seq_len, Strides sq, Strides sk, Strides sv,
                          Strides sg, Strides sdq, Strides sdk, Strides sdv,
                          Dropout drop, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T>(D);
  static std::atomic<unsigned long long> smem_allowed{0};
  const cudaError_t err =
      allow_dynamic_smem(flash_bwd_kernel<T, D, kDropout>, kSmem, smem_allowed);
  if (err != cudaSuccess) return err;
  const int kv_tiles = (seq_len + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(batch) * heads * kv_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_bwd_kernel<T, D, kDropout>
      <<<static_cast<unsigned int>(blocks), kThreads, kSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(g),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
          heads, seq_len, kv_tiles, sq, sk, sv, sg, sdq, sdk, sdv, drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dim(bool dropout, const void* q, const void* k,
                       const void* v, const void* g, const void* lse,
                       const void* delta, void* dq, void* dk, void* dv,
                       int batch, int heads, int seq_len, Strides sq,
                       Strides sk, Strides sv, Strides sg, Strides sdq,
                       Strides sdk, Strides sdv, Dropout drop,
                       cudaStream_t stream) {
  if (dropout) {
    return launch_kernel<T, D, true>(q, k, v, g, lse, delta, dq, dk, dv,
                                     batch, heads, seq_len, sq, sk, sv, sg,
                                     sdq, sdk, sdv, drop, stream);
  }
  return launch_kernel<T, D, false>(q, k, v, g, lse, delta, dq, dk, dv, batch,
                                    heads, seq_len, sq, sk, sv, sg, sdq, sdk,
                                    sdv, drop, stream);
}

template <typename T>
cudaError_t launch(int head_dim, bool dropout, const void* q, const void* k,
                   const void* v, const void* g, const void* lse,
                   const void* delta, void* dq, void* dk, void* dv,
                   int batch, int heads, int seq_len, Strides sq, Strides sk,
                   Strides sv, Strides sg, Strides sdq, Strides sdk,
                   Strides sdv, Dropout drop, cudaStream_t stream) {
  if (head_dim == 48) {
    return launch_dim<T, 48>(dropout, q, k, v, g, lse, delta, dq, dk, dv,
                             batch, heads, seq_len, sq, sk, sv, sg, sdq, sdk,
                             sdv, drop, stream);
  }
  if (head_dim == 64) {
    return launch_dim<T, 64>(dropout, q, k, v, g, lse, delta, dq, dk, dv,
                             batch, heads, seq_len, sq, sk, sv, sg, sdq, sdk,
                             sdv, drop, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, g, dk, dv); dq is fp32, zeroed
// by the caller; lse and delta are contiguous fp32 (batch, heads, seq_len).
// head_dim: 48 or 64 (the wrapper pads). Strides are in elements, for the
// batch, head and token axes; the head dim must be contiguous and every row
// 16-byte aligned. dropout: 0, or 1 with the forward's uint32 seed, keep
// threshold and fp32 1 / (1 - rate); delta is then rowsum(g * out) of the
// dropped output. Returns the CUDA error of the launch (0 on success).
int vtd_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* g,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int dtype, int batch, int heads, int seq_len, int head_dim,
    long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long g_sb, long long g_sh, long long g_sn,
    long long dq_sb, long long dq_sh, long long dq_sn, long long dk_sb,
    long long dk_sh, long long dk_sn, long long dv_sb, long long dv_sh,
    long long dv_sn, int dropout, unsigned int seed, unsigned int threshold,
    float inv_keep, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_len <= 0) return cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sn}, sk{k_sb, k_sh, k_sn},
      sv{v_sb, v_sh, v_sn}, sg{g_sb, g_sh, g_sn}, sdq{dq_sb, dq_sh, dq_sn},
      sdk{dk_sb, dk_sh, dk_sn}, sdv{dv_sb, dv_sh, dv_sn};
  const Dropout drop{seed, threshold, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(head_dim, dropout != 0, q, k, v, g, lse, delta, dq,
                        dk, dv, batch, heads, seq_len, sq, sk, sv, sg, sdq,
                        sdk, sdv, drop, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(head_dim, dropout != 0, q, k, v, g, lse,
                                delta, dq, dk, dv, batch, heads, seq_len, sq,
                                sk, sv, sg, sdq, sdk, sdv, drop, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
