// Flash-attention forward for Hopper (sm_90a) on the tensor cores through
// mma.sync, bound to Python through a plain C interface
// (kernels/flash_attention.py loads it with ctypes). It runs fp32 at head
// dims K <= 64 and, on its windowed route, fp32 past 3072 and bf16 past
// 4096. bf16 at K <= 256 runs on wgmma and TMA
// (flash_attention_fwd_sm90.cu); fp32 at 64 < K <= 3072 and bf16 at
// 256 < K <= 4096 on flash_attention_fwd_wide.cu, which forms S once a tile
// and stages Q once a CTA, past 384 / 512 in a thread-block cluster
// (kReachF32, kReachBf16).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// vision_transformer_detector_tpu/kernels/flash_attention.py (launched by
// `_flash_forward`): softmax(q k^T) v over (batch*heads, N, K) with an fp32
// running max, normaliser and P@V accumulator, so the N x N scores never
// reach device memory. The caller applies 1/sqrt(key_dim); the kernel
// applies no scale. As in the Pallas kernel, the normaliser sums the fp32
// probabilities and P@V uses the probabilities rounded to the input type.
// A ring attention block may resume the online softmax's state (running
// max, normaliser, unnormalised accumulator) where the block before it
// suspended it, and suspend its own for the next, so that the blocks taken
// in key order compute what one launch over all the keys computes
// (kernels/ring_attention.py).
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
// What bounds it (one H100 SXM: 495 TFLOP/s TF32 dense, 3.35 TB/s): at
// reference_608's training shape, (64, 1296, 40) fp32 with lse, 17.2 GFLOP
// done as 3xTF32 (three TF32 products per fp32 product) on 53 MB: bound by
// operations at 3 * 17.2 G / 495 T = 0.104 ms. As chip_smoke.py measured
// it (NVIDIA H100 80GB HBM3, 700 W; PERF.md) it takes 0.578 ms there, 18 %
// of that: the latency of the online-softmax chain (max, exp, rescale)
// between the two products of each tile, which mma.sync leaves exposed in
// one CTA of 4 warps, holds it.
//
// Design (FA2's, for this card):
//   * one CTA of 4 warps (128 threads) per (batch*head, 64-query tile);
//     each warp owns 16 query rows and holds them as mma A fragments in
//     registers for the whole loop, loaded once from a shared tile;
//   * K and V tiles of 64 keys are staged in shared memory in the input
//     type with 16-byte cp.async copies, double-buffered: tile i + 1 is in
//     flight while tile i is multiplied. Rows carry one extra 16-byte chunk
//     against bank conflicts (mma_sm90.cuh); keys past N and columns past
//     the caller's head dim K are zero-filled by the copies, so q, k and v
//     are read at their own K (no padded copy) and the output is stored up
//     to K;
//   * S = Q K^T with mma.sync (3xTF32 m16n8k8 in fp32, bf16 m16n8k16);
//     keys past N are masked to -1e30, the Pallas kernel's _NEG_INF;
//   * the online softmax (flash_fwd_common.cuh, shared with the wgmma
//     forward) runs on the accumulator registers: each lane owns 2 rows x
//     16 scores of a tile, so the row max takes two shuffles per row per
//     tile, the sum stays lane-local until the epilogue, and each score's
//     exp (and, with dropout, its mask hash) is computed once, by the lane
//     that owns it; alpha = exp(m_old - m_new) rescales l and the O
//     accumulator once per tile;
//   * O += P V: the S accumulator's layout is the next mma's A-fragment
//     layout, so rounding P to the input type in registers is the Pallas
//     kernel's `p.astype(v.dtype)` and P never touches shared memory;
//   * instances of head dim 48 and 64 take K <= 48 and 48 < K <= 64 (the
//     zero-filled columns are exact); fp32 at 64 < K <= 128 runs the wide
//     forward's column halves, which took 0.110 ms at (128, 256, 80) with
//     lse where the 128 instance here took 0.186 (it reloaded and split
//     Q's 3xTF32 fragments at every key tile in 4 warps; PERF.md §6);
//   * the windowed route, for the K past the wide forward's clusters (fp32
//     past 3072, bf16 past 4096), two kernels a slab of batch*head rows at
//     a time: a scores kernel (flash_scores.cuh; one CTA of 128 threads a
//     (64-query, 64-key) tile pair: bf16 on wgmma m64n64k16 fed by TMA,
//     four stages of 64-column boxes; fp32 on mma.sync 3xTF32, 64-column
//     chunks by cp.async, each chunk's product summed in fresh registers)
//     forms each tile pair's S over the whole of K once and stores it in
//     fp32 to a workspace of (rows, np, np), np = 64 * ceil(N / 64),
//     which the operator takes from the caching allocator; then the window
//     kernel (flash_fwd_windowed_kernel: one CTA per query tile and
//     128-column window of O, 4 warps in bf16, two sets of 4 warps in fp32,
//     each owning 64 of the columns) stages each key tile's S from the
//     workspace and V at the window's columns through two buffers and runs
//     this kernel's softmax and P V. So no CTA contracts over K more than
//     once per tile pair: at (32, 256, 4160) bf16 the window kernel reads
//     33 x 8.4 MB of S from L2 in place of forming S 33 times (4.2 ms
//     before, against SDPA memory-efficient's 0.31; PERF.md §6). Every
//     window reads the same S, so the softmax statistics and lse are
//     bit-equal across windows (window 0 writes them), and S of a tile
//     pair is the same wherever the pair lies, so a ring attention block
//     resumed at a 64-key tile boundary is bit-equal to one launch. The
//     slab holds as many rows as the larger of q's bytes and one row's S
//     takes (kernels/flash_attention.py: scores_workspace). The Pallas
//     kernel pads K to a multiple of 64 and sets no limit; neither does
//     this route;
//   * the output type is a template parameter: the input type, or fp32
//     for a bf16 ring attention block past K 4096
//     (kernels/ring_attention.py merges the R blocks' unrounded outputs
//     and rounds once, as JAX's ring does);
//   * epilogue: O / l cast to the output type and stored through the
//     caller's strides ((B, N, H, K) or (B, H, N, K) views, unit head
//     stride, rows 16-byte aligned: the wrapper checks); lse = m + log l is
//     written by one lane per row.
// Budget (-Xptxas -v, sm_90a, CUDA 12.8, NVIDIA H100 80GB HBM3's machine):
// the fp32 instances 222-255 registers, the 64 with dropout 8 bytes of
// spill; the windowed route's scores kernels 58 (bf16) and 178 (fp32)
// registers, its window kernel 221-255, no spills. Shared memory, 5 tiles
// of 64 x (D + 16 bytes): fp32 66,560 (48), 87,040 (64); the scores
// kernels 66,568 bf16 (1,024 of alignment, four stages of two 8 KB boxes,
// their barriers) and 69,632 fp32 (two buffers of two 64 x 68 float
// tiles); the window kernel two buffers of the S tile (64 x 72 floats) and
// V's two 64-column halves: 73,728 bf16, 106,496 fp32; dynamic, with
// cudaFuncAttributeMaxDynamicSharedMemorySize raised once per device.
// chip_smoke.py's build phase prints these numbers and the HMMA count of
// each instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_fwd_common.cuh"
#include "flash_launch.cuh"
#include "flash_scores.cuh"

namespace {

constexpr int kBlock = 64;            // queries per CTA and keys per tile
constexpr int kThreads = 128;         // 4 warps of 16 query rows
constexpr int kChunk = 64;            // a V tile's columns
constexpr int kWindow = 128;          // the windowed route's output window
constexpr int kSLd = kBlock + 8;      // a staged S tile's row stride (floats)
// The window kernel's sets of 4 warps: fp32 two halves of 64 columns each
// (with all 128 columns a warp its instances spilled), bf16 one of 128
// (two halves of 8 warps took 25 % longer at (32, 256, 4160)).
template <typename T>
constexpr int kHalves = std::is_same<T, float>::value ? 2 : 1;

template <typename T>
constexpr int smem_bytes(int d) {
  return 5 * kBlock * (d + Mma<T>::kPad) * static_cast<int>(sizeof(T));
}

// The window kernel's: two buffers of the S tile and V's two 64-column
// halves of the window.
template <typename T>
constexpr int windowed_smem_bytes() {
  return 2 * (kBlock * kSLd * 4 +
              2 * kBlock * (kChunk + Mma<T>::kPad) *
                  static_cast<int>(sizeof(T)));
}

// A tile pair's S (the scores kernels' accumulator) into the workspace,
// (rows, np, np) fp32, at local row `local`, query tile qt and key tile kt;
// the whole tile, rows and keys past seq_len too (their S is 0: the loads
// zero-filled them), so the workspace holds no unwritten value.
__device__ __forceinline__ void store_scores(const float (&s)[8][4],
                                             float* scores, int local,
                                             int tiles, int qt, int kt,
                                             int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long np = static_cast<long long>(tiles) * kBlock;
  float* base = scores + (local * np + qt * kBlock + 16 * warp + (lane >> 2)) *
                             np +
                kt * kBlock + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<float2*>(base + 8 * r * np + 8 * j) =
          make_float2(s[j][2 * r], s[j][2 * r + 1]);
    }
  }
}

// A 64 x 64 fp32 S tile (row stride np in the workspace) into shared
// memory of row stride kSLd, with 16-byte cp.async copies by kCopyThreads
// threads. Not committed.
template <int kCopyThreads>
__device__ __forceinline__ void load_scores_tile(float* dst, const float* src,
                                                 long long np, int tid) {
#pragma unroll
  for (int i = 0; i < kBlock * kBlock / 4 / kCopyThreads; ++i) {
    const int c = tid + i * kCopyThreads;
    const int r = c / (kBlock / 4);
    const int col = (c % (kBlock / 4)) * 4;
    cp_async16(dst + r * kSLd + col, src + r * np + col, true);
  }
}

template <typename T, int D, bool kDropout, typename O>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, O* __restrict__ o,
                 RowState state, int heads, int seq_len, int kdim,
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
  const int row0 = q0 + 16 * warp + g;   // this lane's rows: row0, row0 + 8
  const T* q_bh = q + b * sq.b + h * sq.h;
  const T* k_bh = k + b * sk.b + h * sk.h;
  const T* v_bh = v + b * sv.b + h * sv.h;

  load_tile_async<T, D, kBlock, kThreads>(q_s, q_bh, sq.n, q0, seq_len, 0,
                                          kdim, tid);
  load_tile_async<T, D, kBlock, kThreads>(k_s, k_bh, sk.n, 0, seq_len, 0,
                                          kdim, tid);
  load_tile_async<T, D, kBlock, kThreads>(v_s, v_bh, sv.n, 0, seq_len, 0,
                                          kdim, tid);
  cp_async_commit();

  typename M::A qa[D / 16];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m_row[2] = {kNegInf, kNegInf};   // running max of each row
  float l_row[2] = {0.f, 0.f};           // this lane's part of the normaliser
  if (state.m_in != nullptr) {
    resume_state<D / 8>(acc, m_row, l_row, state,
                        state.acc_in + b * so.b + h * so.h, so.n, bh, row0,
                        seq_len, 0, kdim, t);
  }
  unsigned int hash_row[2];
  row_hashes<kDropout>(hash_row, drop, bh, row0);

  const int kv_tiles = (seq_len + kBlock - 1) / kBlock;
  for (int it = 0; it < kv_tiles; ++it) {
    const int kv0 = it * kBlock;
    const int buf = it & 1;
    if (it + 1 < kv_tiles) {
      // Tile it + 1 into the other buffer, which every warp finished
      // reading before the barrier that closed the previous iteration.
      load_tile_async<T, D, kBlock, kThreads>(k_s + (buf ^ 1) * kTile, k_bh,
                                              sk.n, kv0 + kBlock, seq_len, 0,
                                              kdim, tid);
      load_tile_async<T, D, kBlock, kThreads>(v_s + (buf ^ 1) * kTile, v_bh,
                                              sv.n, kv0 + kBlock, seq_len, 0,
                                              kdim, tid);
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
    softmax_step<kDropout>(s, acc, m_row, l_row, hash_row, kv0, seq_len, t,
                           drop);
    // O += P V, P rounded to the input type as it becomes an A fragment.
    add_acc_kn<T, kBlock, D>(acc, s, v_t, kLd, lane);
    __syncthreads();   // this buffer is refilled at the next iteration's top
  }
  store_output<D / 8>(acc, m_row, l_row, state, o + b * so.b + h * so.h,
                      so.n, bh, row0, seq_len, 0, kdim, t, true);
}

// The windowed route, past the wide forward's clusters (kReachF32,
// kReachBf16), in two kernels a slab of batch*head rows at a time (rows
// bh0..): a scores kernel forms each (query tile, key tile) pair's S over
// the whole of K once (flash_scores.cuh) and stores it in fp32 to the
// workspace, (rows, np, np) with np = 64 * tiles; the window kernel reads
// it back a key tile at a time for each 128-column window of O.

// S of the tile pair blockIdx.x: (local row, query tile, key tile) in that
// order, fp32 on mma.sync 3xTF32.
__global__ void __launch_bounds__(kScoreThreads)
flash_fwd_scores_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            float* __restrict__ scores, int heads,
                            int seq_len, int kdim, int tiles, int bh0,
                            Strides sq, Strides sk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int local = blockIdx.x / (tiles * tiles);
  const int qt = blockIdx.x / tiles % tiles;
  const int kt = blockIdx.x % tiles;
  const int bh = bh0 + local;
  const int b = bh / heads;
  const int h = bh % heads;
  float s[1][8][4];
  const float* const a[1] = {q + b * sq.b + h * sq.h};
  const float* const bk[1] = {k + b * sk.b + h * sk.h};
  const long long a_sn[1] = {sq.n};
  const long long b_sn[1] = {sk.n};
  scores_f32<1>(s, reinterpret_cast<float*>(smem_raw), a, a_sn, bk, b_sn,
                kBlock * qt, kBlock * kt, seq_len, kdim, tid);
  store_scores(s[0], scores, local, tiles, qt, kt, tid);
}

// The same in bf16, on wgmma fed by TMA (maps of 64-row boxes).
__global__ void __launch_bounds__(kScoreThreads)
flash_fwd_scores_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             float* __restrict__ scores, int heads,
                             int kdim, int tiles, int bh0) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int local = blockIdx.x / (tiles * tiles);
  const int qt = blockIdx.x / tiles % tiles;
  const int kt = blockIdx.x % tiles;
  const int bh = bh0 + local;
  float s[1][8][4];
  const CUtensorMap* const a[1] = {&tq};
  const CUtensorMap* const bk[1] = {&tk};
  scores_bf16<1>(s, smem_raw, a, bk, kBlock * qt, kBlock * kt, bh % heads,
                 bh / heads, kdim, tid);
  store_scores(s[0], scores, local, tiles, qt, kt, tid);
}

// The window kernel: block (blockIdx.x, blockIdx.y) is query tile
// blockIdx.x % q_tiles of batch*head row bh0 + blockIdx.x / q_tiles, and
// output window blockIdx.y: O's columns 128 * blockIdx.y .. + 127, in
// kHalves<T> sets of 4 warps, set i owning the columns 128 i / kHalves..
// of the window. For each key tile in order it stages the tile pair's S
// from the workspace and the key tile's V at the window's columns; each
// warp reads its rows of S (float2s), runs the softmax and adds P V into
// its set's columns: the stages stream through two buffers, key tile
// i + 1's copies in flight while tile i is used. Every set and every
// window reads the same S, so the softmax statistics and lse are the same
// in all of them; the first set of window 0 writes lse and a ring block's
// suspended state.
template <typename T, bool kDropout, typename O>
__global__ void __launch_bounds__(kThreads * kHalves<T>)
flash_fwd_windowed_kernel(const float* __restrict__ scores,
                          const T* __restrict__ v, O* __restrict__ o,
                          RowState state, int heads, int seq_len, int kdim,
                          int q_tiles, int bh0, Strides sv, Strides so,
                          Dropout drop) {
  using M = Mma<T>;
  constexpr int kLd = kChunk + M::kPad;
  constexpr int kTile = kBlock * kLd;
  constexpr int kAll = kThreads * kHalves<T>;
  constexpr int kCols = kWindow / kHalves<T>;   // a set's columns
  // A buffer: the S tile (64 x kSLd floats), then V's two 64-column halves.
  constexpr int kBuf = kBlock * kSLd * 4 + 2 * kTile * sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int local = blockIdx.x / q_tiles;
  const int bh = bh0 + local;
  const int q0 = (blockIdx.x % q_tiles) * kBlock;
  const int b = bh / heads;
  const int h = bh % heads;
  const int row0 = q0 + 16 * (warp & 3) + g;
  const int win0 = blockIdx.y * kWindow;
  const int col0 = win0 + kCols * half;   // this set's columns
  const long long np = static_cast<long long>(q_tiles) * kBlock;
  const float* s_rows = scores + (local * np + q0) * np;
  const T* v_bh = v + b * sv.b + h * sv.h;

  auto issue = [&](int it) {
    unsigned char* dst = smem_raw + (it & 1) * kBuf;
    load_scores_tile<kAll>(reinterpret_cast<float*>(dst),
                           s_rows + it * kBlock, np, tid);
    T* v_s = reinterpret_cast<T*>(dst + kBlock * kSLd * 4);
    load_tile_async<T, kChunk, kBlock, kAll>(
        v_s, v_bh, sv.n, it * kBlock, seq_len, win0, kdim, tid);
    load_tile_async<T, kChunk, kBlock, kAll>(
        v_s + kTile, v_bh, sv.n, it * kBlock, seq_len, win0 + kChunk, kdim,
        tid);
    cp_async_commit();
  };
  issue(0);

  float acc[kCols / 8][4];
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};
  if (state.m_in != nullptr) {
    resume_state<kCols / 8>(acc, m_row, l_row, state,
                            state.acc_in + b * so.b + h * so.h, so.n, bh,
                            row0, seq_len, col0, kdim, t);
  }
  unsigned int hash_row[2];
  row_hashes<kDropout>(hash_row, drop, bh, row0);

  const int kv_tiles = q_tiles;
  for (int it = 0; it < kv_tiles; ++it) {
    if (it + 1 < kv_tiles) {
      // Into the other buffer, which every warp finished reading before
      // the barrier that closed the previous key tile.
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* cur = smem_raw + (it & 1) * kBuf;
    const float* s_t = reinterpret_cast<const float*>(cur);
    const T* v_t = reinterpret_cast<const T*>(cur + kBlock * kSLd * 4);
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 x = *reinterpret_cast<const float2*>(
            s_t + (16 * (warp & 3) + g + 8 * r) * kSLd + 8 * j + 2 * t);
        s[j][2 * r] = x.x;
        s[j][2 * r + 1] = x.y;
      }
    }
    softmax_step<kDropout>(s, acc, m_row, l_row, hash_row, it * kBlock,
                           seq_len, t, drop);
    // This set's columns += P V, a 64-column V tile at a time.
    if constexpr (kCols == kChunk) {
      add_acc_kn<T, kBlock, kChunk>(acc, s, v_t + half * kTile, kLd, lane);
    } else {
      add_acc_kn<T, kBlock, kChunk, 0, kCols / 8>(acc, s, v_t, kLd, lane);
      add_acc_kn<T, kBlock, kChunk, kChunk / 8, kCols / 8>(
          acc, s, v_t + kTile, kLd, lane);
    }
    __syncthreads();
  }
  store_output<kCols / 8>(acc, m_row, l_row, state,
                          o + b * so.b + h * so.h, so.n, bh, row0, seq_len,
                          col0, kdim, t, blockIdx.y == 0 && half == 0);
}

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  RowState state;
  int batch, heads, seq_len, kdim;
  Strides sq, sk, sv, so;
  Dropout drop;
  cudaStream_t stream;
  float* scores;   // the windowed route's workspace, ws_rows rows of S
  int ws_rows;
};

// Launches kernel over (batch * heads * query tiles, windows) blocks with
// smem bytes of dynamic shared memory.
template <typename T, typename O, typename Kernel>
cudaError_t run(Kernel kernel, int smem, std::atomic<unsigned long long>& ok,
                unsigned int windows, const Launch& a) {
  const cudaError_t err = allow_dynamic_smem(kernel, smem, ok);
  if (err != cudaSuccess) return err;
  const int q_tiles = (a.seq_len + kBlock - 1) / kBlock;
  const long long blocks = static_cast<long long>(a.batch) * a.heads * q_tiles;
  if (blocks > 0x7fffffffLL || windows > 65535u) {
    return cudaErrorInvalidConfiguration;
  }
  kernel<<<dim3(static_cast<unsigned int>(blocks), windows), kThreads, smem,
           a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<O*>(a.o), a.state, a.heads,
      a.seq_len, a.kdim, q_tiles, a.sq, a.sk, a.sv, a.so, a.drop);
  return cudaGetLastError();
}

template <typename T, int D, bool kDropout, typename O>
cudaError_t launch_kernel(const Launch& a) {
  static std::atomic<unsigned long long> smem_allowed{0};
  return run<T, O>(flash_fwd_kernel<T, D, kDropout, O>, smem_bytes<T>(D),
                   smem_allowed, 1, a);
}

// The windowed route: for each slab of ws_rows batch*head rows, the scores
// kernel (one CTA a tile pair), then the window kernel (one CTA per query
// tile and 128-column window of O), both on the caller's stream, so a slab
// reuses the workspace once the one before it is done with it.
template <typename T, bool kDropout, typename O>
cudaError_t launch_windowed(const Launch& a) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  static std::atomic<unsigned long long> scores_allowed{0}, smem_allowed{0};
  const int smem_scores = kF32 ? scores_f32_smem<1>() : scores_bf16_smem<1>();
  auto window_kernel = flash_fwd_windowed_kernel<T, kDropout, O>;
  cudaError_t err =
      kF32 ? allow_dynamic_smem(flash_fwd_scores_f32_kernel, smem_scores,
                                scores_allowed)
           : allow_dynamic_smem(flash_fwd_scores_bf16_kernel, smem_scores,
                                scores_allowed);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(window_kernel, windowed_smem_bytes<T>(),
                           smem_allowed);
  if (err != cudaSuccess) return err;
  const int tiles = (a.seq_len + kBlock - 1) / kBlock;
  const long long rows_all = static_cast<long long>(a.batch) * a.heads;
  const unsigned int windows = (a.kdim + kWindow - 1) / kWindow;
  if (a.scores == nullptr || a.ws_rows <= 0 || windows > 65535u ||
      static_cast<long long>(a.ws_rows) * tiles * tiles > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap tq, tk;
  if constexpr (!kF32) {
    if (!encode(&tq, a.q, a.kdim, a.seq_len, a.heads, a.batch, a.sq.b,
                a.sq.h, a.sq.n, kBlock) ||
        !encode(&tk, a.k, a.kdim, a.seq_len, a.heads, a.batch, a.sk.b,
                a.sk.h, a.sk.n, kBlock)) {
      return cudaErrorInvalidValue;
    }
  }
  for (long long bh0 = 0; bh0 < rows_all; bh0 += a.ws_rows) {
    const int rows = static_cast<int>(
        rows_all - bh0 < a.ws_rows ? rows_all - bh0 : a.ws_rows);
    const unsigned int pairs =
        static_cast<unsigned int>(static_cast<long long>(rows) * tiles * tiles);
    if constexpr (kF32) {
      flash_fwd_scores_f32_kernel<<<pairs, kScoreThreads, smem_scores,
                                    a.stream>>>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          a.scores, a.heads, a.seq_len, a.kdim, tiles,
          static_cast<int>(bh0), a.sq, a.sk);
    } else {
      flash_fwd_scores_bf16_kernel<<<pairs, kScoreThreads, smem_scores,
                                     a.stream>>>(tq, tk, a.scores, a.heads,
                                                 a.kdim, tiles,
                                                 static_cast<int>(bh0));
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    window_kernel<<<dim3(static_cast<unsigned int>(rows) * tiles, windows),
                    kThreads * kHalves<T>, windowed_smem_bytes<T>(),
                    a.stream>>>(
        a.scores, static_cast<const T*>(a.v), static_cast<O*>(a.o), a.state,
        a.heads, a.seq_len, a.kdim, tiles, static_cast<int>(bh0), a.sv, a.so,
        a.drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The instance of head dim K: fp32 48 (K <= 48) or 64 (K <= 64), and the
// windowed route past the cluster route's reach (kReachF32, kReachBf16).
// Every other K is another source's (flash_attention_fwd_sm90.cu,
// flash_attention_fwd_wide.cu) and refused.
template <typename T, typename O, bool kDropout>
cudaError_t launch_dim(const Launch& a) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (a.kdim > (kF32 ? kReachF32 : kReachBf16)) {
    return launch_windowed<T, kDropout, O>(a);
  }
  if constexpr (kF32) {
    if (a.kdim <= 48) return launch_kernel<T, 48, kDropout, O>(a);
    if (a.kdim <= 64) return launch_kernel<T, 64, kDropout, O>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename O>
cudaError_t launch(bool dropout, const Launch& a) {
  return dropout ? launch_dim<T, O, true>(a) : launch_dim<T, O, false>(a);
}

}  // namespace

extern "C" {

// One launch from the plan's argument block `args` (flash_launch.cuh) and
// the call's device addresses and stream. dtype 0 = float32 (head_dim
// <= 64 or > 3072), 1 = bfloat16 (head_dim > 4096 only); out_fp32 1 writes
// the output in fp32 whatever the input dtype (a ring attention block), 0
// in the input dtype. head_dim:
// the caller's K, with K * the element size a multiple of 16 bytes; the
// head dim must be contiguous and every row 16-byte aligned. lse: nullptr,
// or a contiguous fp32 (batch, heads, seq_len) array; m_in, l_in, acc_in
// and m_out, l_out: nullptr, or a ring attention block's online-softmax
// state to resume from and to hand on (RowState; acc_in has the output's
// strides), each needing an fp32 output. workspace: on the windowed route
// (past kReachF32 / kReachBf16) an fp32 (args->ws_rows, np, np) array, np
// = 64 * ceil(seq_len / 64), which the route fills with S a slab of
// ws_rows batch*head rows at a time; else unused. seed: with dropout, the
// device address of the uint32 seed. Runs on args->device and restores
// the caller's device. Returns cudaGetLastError() after the launches (0 on
// success).
int vtd_flash_attention_fwd(const FlashFwdArgs* args, const void* q,
                            const void* k, const void* v, void* o,
                            void* lse, const void* m_in, const void* l_in,
                            const void* acc_in, void* m_out, void* l_out,
                            void* workspace, const unsigned int* seed,
                            void* stream) {
  const FlashFwdArgs& p = *args;
  if (p.batch <= 0 || p.heads <= 0 || p.seq_len <= 0 || p.head_dim <= 0) {
    return cudaErrorInvalidValue;
  }
  if (p.dropout != 0 && seed == nullptr) return cudaErrorInvalidValue;
  if (p.inner_local == 0) return cudaErrorInvalidValue;
  const RowState state{static_cast<float*>(lse),
                       static_cast<const float*>(m_in),
                       static_cast<const float*>(l_in),
                       static_cast<const float*>(acc_in),
                       static_cast<float*>(m_out),
                       static_cast<float*>(l_out)};
  if (!state_ok(state, p.dtype == 0 || p.out_fp32 != 0)) {
    return cudaErrorInvalidValue;
  }
  const Launch a{q, k, v, o, state, p.batch, p.heads, p.seq_len, p.head_dim,
                 strides_of<Strides>(p.strides, 0),
                 strides_of<Strides>(p.strides, 1),
                 strides_of<Strides>(p.strides, 2),
                 strides_of<Strides>(p.strides, 3), dropout_of(p, seed),
                 static_cast<cudaStream_t>(stream),
                 static_cast<float*>(workspace), p.ws_rows};
  const DeviceScope scope(p.device);
  if (scope.error() != cudaSuccess) return scope.error();
  const bool dropout = p.dropout != 0;
  cudaError_t err;
  if (p.dtype == 0) {
    err = launch<float, float>(dropout, a);
  } else if (p.dtype == 1 && p.out_fp32 != 0) {
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
