// Flash-attention backward for Hopper (sm_90a) at head dims K > 128 (the
// wide route): fp32 past 128 and bf16 past 256 (bf16 at K <= 256 runs on
// wgmma, flash_attention_bwd_sm90.cu). Bound to Python through a plain C
// interface (kernels/ops.py loads it with ctypes). It computes what
// flash_attention_bwd.cu computes
// (that file's header states the contract: the Pallas kernel
// `_fused_bwd_kernel` it replaces, dq summed in key order by either route,
// the dropout replay) with the same tiles, mma.sync products and per-score
// math (flash_bwd_common.cuh), at any K:
//   * K > 128 (the wide route: flash_bwd_wide_kernel, flash_bwd_dq_wide_
//     kernel): S and dP are formed over the whole of K in 64-column chunks,
//     each chunk of the four operands staged in shared memory and the
//     chunks added in column order, so every CTA that forms them forms the
//     same values; the outputs (dk and dv, dq, the partials) are written
//     in column windows of 64, a second grid axis picking a CTA's window,
//     with the 64 instance's tiles and registers. Each window recomputes S
//     and dP: ceil(K / 64) times their work, which no preset runs. In fp32
//     past K 384 each chunk's S and dP are summed in fresh registers
//     (chunk_sums), which keeps the gradients within 2e-5 at K 3104.
// The Pallas kernel pads K to a multiple of 64 and sets no limit; neither
// does this route. Budget: the two buffers of four 64 x (64 + 16 bytes)
// tiles (139,264 bytes fp32, 73,728 bf16), the dk/dv kernel's lse and
// delta rows and, on the partials route, K's window and the dS^T tile
// beside them, dynamic; registers as the 64 instances' (the windows are
// 64 columns wide and S and dP are whole 64-row tiles).

#include "flash_bwd_common.cuh"

namespace {

// kChunkSums (fp32 past K 384, kChunkSumsFrom): S and dP summed over K a
// 64-column chunk at a time, each chunk's products formed in fresh
// registers and added with one fp32 add, as the forward's tile sums are
// (mma_sm90.cuh): carried through every chunk in the truncating mma
// accumulator they drifted to 8.4e-5 of the largest gradient at K 3104.
// The fresh registers cost 15-26 % at K 192-512 (PERF.md §6), so
// the narrower widths, within 2e-5, keep the accumulator, and so does bf16
// (held to 2e-2).
constexpr int kChunkSumsFrom = 384;

template <int kChunkSums, int kTiles>
__device__ __forceinline__ void chunk_sums(float (&s)[kTiles][4],
                                           float (&dp)[kTiles][4],
                                           const float (&s_c)[kTiles][4],
                                           const float (&dp_c)[kTiles][4]) {
  if constexpr (kChunkSums != 0) {
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += s_c[j][e];
        dp[j][e] += dp_c[j][e];
      }
    }
  }
}

// K > 128, dk and dv: block (blockIdx.x, blockIdx.y) is key tile
// blockIdx.x % tiles of batch*head blockIdx.x / tiles and column window
// blockIdx.y, dk's and dv's columns 64 * blockIdx.y .. + 63. Each query
// tile is a run of chunks + 1 stages: stage c < chunks stages the 64
// columns 64c.. of K and V (this key tile) and of q and g (the query tile)
// and adds their products into S^T and dP^T; the last stages q's and g's
// window with the tile's lse and delta, forms P^T and dS^T as the narrow
// kernel does and adds dV += P^T g and dK += dS^T q in the window. With
// kPartials it also forms the window's columns of this key tile's dq
// contribution, dS K, from K's window (staged once). The stages stream
// through two buffers, stage i + 1's copies in flight while stage i is
// multiplied.
template <typename T, bool kDropout, bool kPartials, typename O,
          int kChunkSums>
__global__ void __launch_bounds__(kThreads)
flash_bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, O* __restrict__ dk,
                      O* __restrict__ dv, float* __restrict__ partials,
                      int heads, int seq_len, int kdim, int tiles,
                      Strides sq, Strides sk, Strides sv, Strides sg,
                      Strides sdk, Strides sdv, Dropout drop) {
  using M = Mma<T>;
  constexpr int kLd = kChunk + M::kPad;
  constexpr int kTile = kBlock * kLd;
  constexpr int kLdS = kBlock + M::kPad;   // dS^T rows: [key][query]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);                    // [2][4]
  float* lse_s = reinterpret_cast<float*>(bufs + 8 * kTile);   // two
  float* delta_s = lse_s + 2 * kBlock;                          // two
  T* kw_s = reinterpret_cast<T*>(delta_s + 2 * kBlock);         // kPartials
  T* ds_s = kw_s + kTile;                                       // kPartials

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / tiles;
  const int kv0 = (blockIdx.x % tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const int col0 = blockIdx.y * kChunk;
  const T* q_bh = q + b * sq.b + h * sq.h;
  const T* k_bh = k + b * sk.b + h * sk.h;
  const T* v_bh = v + b * sv.b + h * sv.h;
  const T* g_bh = g + b * sg.b + h * sg.h;
  const float* lse_bh = lse + static_cast<long long>(bh) * seq_len;
  const float* delta_bh = delta + static_cast<long long>(bh) * seq_len;
  const int chunks = (kdim + kChunk - 1) / kChunk;
  const int stages = chunks + 1;
  const int total = tiles * stages;

  auto issue = [&](int i) {
    T* dst = bufs + (i & 1) * 4 * kTile;
    const int q0 = i / stages * kBlock;
    const int c = i % stages;
    if (c < chunks) {
      const int c0 = kChunk * c;
      load_tile_async<T, kChunk, kBlock, kThreads>(dst, k_bh, sk.n, kv0,
                                                   seq_len, c0, kdim, tid);
      load_tile_async<T, kChunk, kBlock, kThreads>(dst + kTile, v_bh, sv.n,
                                                   kv0, seq_len, c0, kdim,
                                                   tid);
      load_tile_async<T, kChunk, kBlock, kThreads>(
          dst + 2 * kTile, q_bh, sq.n, q0, seq_len, c0, kdim, tid);
      load_tile_async<T, kChunk, kBlock, kThreads>(
          dst + 3 * kTile, g_bh, sg.n, q0, seq_len, c0, kdim, tid);
    } else {
      load_tile_async<T, kChunk, kBlock, kThreads>(dst, q_bh, sq.n, q0,
                                                   seq_len, col0, kdim, tid);
      load_tile_async<T, kChunk, kBlock, kThreads>(dst + kTile, g_bh, sg.n,
                                                   q0, seq_len, col0, kdim,
                                                   tid);
      load_rows_async(lse_s + (i & 1) * kBlock, delta_s + (i & 1) * kBlock,
                      lse_bh, delta_bh, q0, seq_len, tid);
    }
    cp_async_commit();
  };
  if constexpr (kPartials) {
    load_tile_async<T, kChunk, kBlock, kThreads>(kw_s, k_bh, sk.n, kv0,
                                                 seq_len, col0, kdim, tid);
  }
  issue(0);

  bool key_ok[2];
  unsigned int hash_key[2] = {0u, 0u};
  const unsigned int seed = kDropout ? load_seed(drop) : 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kv0 + 16 * warp + gr + 8 * r;
    key_ok[r] = key < seq_len;
    if (kDropout) {
      hash_key[r] = hash_part(drop, seed, global_row(drop, bh)) +
                    key_term(drop, static_cast<unsigned int>(key));
    }
  }
  float dk_acc[kChunk / 8][4], dv_acc[kChunk / 8][4];
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }
  }

  float s[kBlock / 8][4], dp[kBlock / 8][4];
  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cur = bufs + (i & 1) * 4 * kTile;
    const int q0 = i / stages * kBlock;
    const int c = i % stages;
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      }
    }
    if (c < chunks) {
      // S^T += K[:, chunk] q[:, chunk]^T, dP^T += V[:, chunk] g[:, chunk]^T;
      // with kChunkSums each chunk's products in fresh registers, added
      // with one fp32 add (chunk_sums).
      float s_c[kBlock / 8][4] = {}, dp_c[kBlock / 8][4] = {};
      auto& s_to = *(kChunkSums != 0 ? &s_c : &s);
      auto& dp_to = *(kChunkSums != 0 ? &dp_c : &dp);
#pragma unroll
      for (int kc = 0; kc < kChunk / 16; ++kc) {
        typename M::A ka, va;
        M::load_a(ka, cur, kLd, 16 * warp, 16 * kc, lane);
        M::load_a(va, cur + kTile, kLd, 16 * warp, 16 * kc, lane);
#pragma unroll
        for (int np = 0; np < kBlock / 16; ++np) {
          typename M::B b0, b1;
          M::load_b_nk(b0, b1, cur + 2 * kTile, kLd, 16 * np, 16 * kc, lane);
          M::mma(s_to[2 * np], ka, b0);
          M::mma(s_to[2 * np + 1], ka, b1);
          M::load_b_nk(b0, b1, cur + 3 * kTile, kLd, 16 * np, 16 * kc, lane);
          M::mma(dp_to[2 * np], va, b0);
          M::mma(dp_to[2 * np + 1], va, b1);
        }
      }
      chunk_sums<kChunkSums>(s, dp, s_c, dp_c);
    } else {
      grads_t<kDropout>(s, dp, key_ok, hash_key, lse_s + (i & 1) * kBlock,
                        delta_s + (i & 1) * kBlock, q0, 0, seq_len, t, drop);
      add_acc_kn<T, kBlock, kChunk>(dv_acc, s, cur + kTile, kLd, lane);
      add_acc_kn<T, kBlock, kChunk>(dk_acc, dp, cur, kLd, lane);
      if constexpr (kPartials) {
        // dS^T (rounded) into shared memory, then 16 query rows of the
        // window's dq contribution dS K per warp.
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            store_pair(ds_s + (16 * warp + gr + 8 * r) * kLdS + 8 * j + 2 * t,
                       dp[j][2 * r], dp[j][2 * r + 1]);
          }
        }
        __syncthreads();
        float dq_acc[kChunk / 8][4];
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
        }
#pragma unroll
        for (int kc = 0; kc < kBlock / 16; ++kc) {
          typename M::A a;
          M::load_a_t(a, ds_s, kLdS, 16 * kc, 16 * warp, lane);
#pragma unroll
          for (int np = 0; np < kChunk / 16; ++np) {
            typename M::B b0, b1;
            M::load_b_kn(b0, b1, kw_s, kLd, 16 * kc, 16 * np, lane);
            M::mma(dq_acc[2 * np], a, b0);
            M::mma(dq_acc[2 * np + 1], a, b1);
          }
        }
        store_partials<kChunk / 8>(dq_acc, partials, blockIdx.x % tiles,
                                   gridDim.x / tiles, bh, seq_len, kdim,
                                   q0 + 16 * warp + gr, col0, t);
      }
    }
    __syncthreads();
  }
  store_rows<kChunk / 8>(dk_acc, dk + b * sdk.b + h * sdk.h, sdk.n, key_ok,
                         kv0 + 16 * warp + gr, col0, kdim, t);
  store_rows<kChunk / 8>(dv_acc, dv + b * sdv.b + h * sdv.h, sdv.n, key_ok,
                         kv0 + 16 * warp + gr, col0, kdim, t);
}

// K > 128, dq: block (blockIdx.x, blockIdx.y) is query tile blockIdx.x %
// tiles of batch*head blockIdx.x / tiles and column window blockIdx.y. Each
// key tile is a run of chunks + 1 stages: stage c < chunks stages the 64
// columns 64c.. of q and g (the query tile) and of K and V (the key tile)
// and adds their products into S and dP; the last stages K's window, forms
// dS as the narrow kernel does and adds dq += dS K in the window, the key
// tiles in order.
template <typename T, bool kDropout, int kChunkSums>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int heads, int seq_len,
                         int kdim, int tiles, Strides sq, Strides sk,
                         Strides sv, Strides sg, Strides sdq, Dropout drop) {
  using M = Mma<T>;
  constexpr int kLd = kChunk + M::kPad;
  constexpr int kTile = kBlock * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);   // [2][4 tiles]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const int col0 = blockIdx.y * kChunk;
  const T* q_bh = q + b * sq.b + h * sq.h;
  const T* k_bh = k + b * sk.b + h * sk.h;
  const T* v_bh = v + b * sv.b + h * sv.h;
  const T* g_bh = g + b * sg.b + h * sg.h;
  const int chunks = (kdim + kChunk - 1) / kChunk;
  const int stages = chunks + 1;
  const int total = tiles * stages;

  auto issue = [&](int i) {
    T* dst = bufs + (i & 1) * 4 * kTile;
    const int kv0 = i / stages * kBlock;
    const int c = i % stages;
    if (c < chunks) {
      const int c0 = kChunk * c;
      load_tile_async<T, kChunk, kBlock, kThreads>(dst, q_bh, sq.n, q0,
                                                   seq_len, c0, kdim, tid);
      load_tile_async<T, kChunk, kBlock, kThreads>(dst + kTile, g_bh, sg.n,
                                                   q0, seq_len, c0, kdim,
                                                   tid);
      load_tile_async<T, kChunk, kBlock, kThreads>(
          dst + 2 * kTile, k_bh, sk.n, kv0, seq_len, c0, kdim, tid);
      load_tile_async<T, kChunk, kBlock, kThreads>(
          dst + 3 * kTile, v_bh, sv.n, kv0, seq_len, c0, kdim, tid);
    } else {
      load_tile_async<T, kChunk, kBlock, kThreads>(dst, k_bh, sk.n, kv0,
                                                   seq_len, col0, kdim, tid);
    }
    cp_async_commit();
  };
  issue(0);

  bool query_ok[2];
  float lse_r[2], delta_r[2];
  unsigned int hash_query[2] = {0u, 0u};
  const unsigned int seed = kDropout ? load_seed(drop) : 0u;
  const long long rows = static_cast<long long>(bh) * seq_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int query = q0 + 16 * warp + gr + 8 * r;
    query_ok[r] = query < seq_len;
    lse_r[r] = query_ok[r] ? lse[rows + query] * kLog2e : 0.f;
    delta_r[r] = query_ok[r] ? delta[rows + query] : 0.f;
    if (kDropout) {
      hash_query[r] = hash_part(drop, seed, global_row(drop, bh)) +
                      query_term(drop, static_cast<unsigned int>(query));
    }
  }
  float dq_acc[kChunk / 8][4];
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;
  }

  float s[kBlock / 8][4], dp[kBlock / 8][4];
  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cur = bufs + (i & 1) * 4 * kTile;
    const int c = i % stages;
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
      }
    }
    if (c < chunks) {
      // S += q[:, chunk] K[:, chunk]^T, dP += g[:, chunk] V[:, chunk]^T,
      // with kChunkSums a chunk at a time in fresh registers (chunk_sums).
      float s_c[kBlock / 8][4] = {}, dp_c[kBlock / 8][4] = {};
      auto& s_to = *(kChunkSums != 0 ? &s_c : &s);
      auto& dp_to = *(kChunkSums != 0 ? &dp_c : &dp);
#pragma unroll
      for (int kc = 0; kc < kChunk / 16; ++kc) {
        typename M::A qa, ga;
        M::load_a(qa, cur, kLd, 16 * warp, 16 * kc, lane);
        M::load_a(ga, cur + kTile, kLd, 16 * warp, 16 * kc, lane);
#pragma unroll
        for (int np = 0; np < kBlock / 16; ++np) {
          typename M::B b0, b1;
          M::load_b_nk(b0, b1, cur + 2 * kTile, kLd, 16 * np, 16 * kc, lane);
          M::mma(s_to[2 * np], qa, b0);
          M::mma(s_to[2 * np + 1], qa, b1);
          M::load_b_nk(b0, b1, cur + 3 * kTile, kLd, 16 * np, 16 * kc, lane);
          M::mma(dp_to[2 * np], ga, b0);
          M::mma(dp_to[2 * np + 1], ga, b1);
        }
      }
      chunk_sums<kChunkSums>(s, dp, s_c, dp_c);
    } else {
      grads_q<kDropout>(s, dp, query_ok, hash_query, lse_r, delta_r,
                        i / stages * kBlock, seq_len, t, drop);
      add_acc_kn<T, kBlock, kChunk>(dq_acc, dp, cur, kLd, lane);
    }
    __syncthreads();
  }
  store_rows<kChunk / 8>(dq_acc, dq + b * sdq.b + h * sdq.h, sdq.n, query_ok,
                         q0 + 16 * warp + gr, col0, kdim, t);
}


// The wide kernels' shared memory: two buffers of four 64 x (64 + pad)
// tiles, and the dk/dv kernel's two lse and two delta rows and, with
// kPartials, K's window and the dS^T tile.
template <typename T>
constexpr int wide_dq_smem_bytes() {
  return 8 * kBlock * (kChunk + Mma<T>::kPad) * static_cast<int>(sizeof(T));
}

template <typename T, bool kPartials>
constexpr int wide_smem_bytes() {
  return wide_dq_smem_bytes<T>() + 4 * kBlock * static_cast<int>(sizeof(float)) +
         (kPartials ? 2 * kBlock * (kChunk + Mma<T>::kPad) *
                          static_cast<int>(sizeof(T))
                    : 0);
}


template <typename T, bool kDropout, typename O, int kChunkSums>
cudaError_t launch_wide_sums(const Launch& a) {
  const int tiles = (a.seq_len + kBlock - 1) / kBlock;
  const unsigned int windows = (a.kdim + kChunk - 1) / kChunk;
  const T* qt = static_cast<const T*>(a.q);
  const T* kt = static_cast<const T*>(a.k);
  const T* vt = static_cast<const T*>(a.v);
  const T* gt = static_cast<const T*>(a.g);
  cudaError_t err;
  if (a.partials != nullptr) {
    if constexpr (std::is_same<T, float>::value) {
      static std::atomic<unsigned long long> smem_allowed{0};
      err = run(flash_bwd_wide_kernel<T, kDropout, true, T, kChunkSums>,
                wide_smem_bytes<T, true>(), smem_allowed, a, windows, qt, kt,
                vt, gt, a.lse, a.delta, static_cast<T*>(a.dk),
                static_cast<T*>(a.dv), a.partials, a.heads, a.seq_len,
                a.kdim, tiles, a.sq, a.sk, a.sv, a.sg, a.sdk, a.sdv, a.drop);
      return err != cudaSuccess ? err : sum_partials(a);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  static std::atomic<unsigned long long> smem_allowed{0}, smem_dq_allowed{0};
  err = run(flash_bwd_wide_kernel<T, kDropout, false, O, kChunkSums>,
            wide_smem_bytes<T, false>(), smem_allowed, a, windows, qt, kt, vt,
            gt, a.lse, a.delta, static_cast<O*>(a.dk), static_cast<O*>(a.dv),
            static_cast<float*>(nullptr), a.heads, a.seq_len, a.kdim, tiles,
            a.sq, a.sk, a.sv, a.sg, a.sdk, a.sdv, a.drop);
  if (err != cudaSuccess) return err;
  return run(flash_bwd_dq_wide_kernel<T, kDropout, kChunkSums>,
             wide_dq_smem_bytes<T>(),
             smem_dq_allowed, a, windows, qt, kt, vt, gt, a.lse, a.delta,
             a.dq, a.heads, a.seq_len, a.kdim, tiles, a.sq, a.sk, a.sv, a.sg,
             a.sdq, a.drop);
}


// fp32 past kChunkSumsFrom sums S and dP a chunk at a time (chunk_sums).
template <typename T, bool kDropout, typename O>
cudaError_t launch_wide(const Launch& a) {
  if constexpr (std::is_same<T, float>::value) {
    if (a.kdim > kChunkSumsFrom) return launch_wide_sums<T, kDropout, O, 1>(a);
  }
  return launch_wide_sums<T, kDropout, O, 0>(a);
}

template <typename T, typename O>
cudaError_t launch(bool dropout, const Launch& a) {
  return dropout ? launch_wide<T, true, O>(a) : launch_wide<T, false, O>(a);
}

}  // namespace
