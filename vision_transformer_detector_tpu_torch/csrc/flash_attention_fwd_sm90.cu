// Flash-attention forward in bf16 for Hopper (sm_90a) on wgmma, fed by TMA
// in a warp-specialised pipeline; bound to Python through a plain C
// interface (kernels/ops.py loads it with ctypes). It runs every bf16
// forward route at head dims K <= 256: serving (B1), training with the
// logsumexp (B1-lse) and with dropout (B1-drop), and a ring attention
// block's fp32-output instance with its resumed and suspended online-softmax
// state. fp32 at any K and bf16 at K > 256 run on mma.sync
// (flash_attention_fwd.cu, the wide route past 128).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// vision_transformer_detector_tpu/kernels/flash_attention.py (launched by
// `_flash_forward`), as flash_attention_fwd.cu does, and computes what that
// kernel computes (its header states the contract): fp32 scores, running
// max and normaliser, the normaliser summed over undropped fp32
// probabilities, P rounded to bf16 (`p.astype(v.dtype)`) before P V with
// fp32 accumulation, lse = m + log(l), and the keep mask of
// `dropout_keep_mask` (dropout_mask.cuh) at the global (batch*head, query,
// key) coordinates, which the backward replays.
//
// What bounds it (one H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): the
// model's shapes sit at or below the bf16 ridge (about 295 FLOP per byte):
// (768, 576, 64) at 288 FLOP per byte (0.068 ms by bytes, 0.066 by
// operations), (2048, 256, 64) with lse at 127 (bound by bytes at 0.081
// ms), (512, 256, 80) at about 100, (128, 256, 256) at 128 (bound by
// bytes at 0.020 ms). The mma.sync kernel reached 20-30 % of
// that: with synchronous products the latency of the online-softmax chain
// between the two products of each tile stays exposed, and its 16-byte
// cp.async copies spend the warps' issue slots on addresses. This kernel,
// as chip_smoke.py measured it (H100 SXM, 700 W): 0.196 ms at (768, 576,
// 64), 35 % of its bound, 0.152 ms at (2048, 256, 64) with lse, 53 %, 0.227
// with dropout; at the smaller shapes of serving and of the ViT-H/14-width
// model a call is held by the host (about 0.12-0.14 ms).
//
// Design (FA3's shape, without its intra-warpgroup ping-pong):
//   * at D 64 and 128 one CTA of 5 warps per (batch*head, 64-query tile):
//     a consumer warpgroup (warps 0-3, 16 query rows each) and a producer
//     warp (warp 4); two CTAs share an SM (registers: at most 168 a
//     thread), so one CTA's softmax runs while the other's products do;
//   * at D 256 O's accumulator alone takes 128 registers a thread. An SM
//     gives a thread at most 168 when any of its four register files
//     serves three warps, so two 5-warp CTAs an SM spilled (1.6 KB; 0.22-
//     0.29 ms at (128, 256, 192-256), against 0.049-0.056 for the same CTA
//     alone on its SM), and so did one CTA of two consumer warpgroups and
//     a producer warp (3.5 KB). The 256 instance runs one CTA of 8 warps
//     per (batch*head, 128-query tile): two consumer warpgroups (warps 0-3
//     and 4-7, 64 query rows each) and no producer warp, at most 255
//     registers a thread; both warpgroups read each K and V tile, so it is
//     loaded once for the two, and one's softmax runs while the other's
//     products do;
//   * TMA loads, each issued by one thread: Q once, then the K and V
//     tiles of kKeys keys (128 at K <= 64, else 64) into a ring of two
//     stages, each with full barriers for K and for V (the copy's bytes)
//     and an empty barrier all the consumer threads arrive on when they
//     are done with the stage; so the next tile's copies are in flight
//     while this one is multiplied, and no other consumer instruction
//     computes an address of them. The producer warp's lane 0 issues them
//     ahead through the ring; at D 256 consumer thread 0 issues tile
//     it + 1 at the top of tile it, once both warpgroups are done with
//     tile it - 1;
//   * tensor maps are built on the host from the tensors' own strides,
//     (K, N, heads, batch) with unit head-dim stride, so both layouts
//     (bnhk, bhnk) and strided views are read in place; the box is 64
//     columns (128 bytes, the 128-byte swizzle that wgmma reads) by the
//     tile's rows, one box per 64 columns of the instance (64, 128 or
//     256), and TMA fills columns past K and rows past N with zeros: the
//     instance reads q, k and v at their own K with no padded copy. A box
//     wholly past K (the 256 instance at K <= 192) is neither loaded nor
//     multiplied: S sums over the live boxes, and the output columns that
//     the dead ones feed are never stored. The maps are __grid_constant__
//     parameters, so a captured CUDA graph replays them by value;
//   * S = Q K^T: wgmma m64 x kKeys x 16, both operands K-major in shared
//     memory (descriptors with the 128-byte swizzle), fp32 accumulation in
//     registers, whose layout is mma.sync's (flash_fwd_common.cuh), over
//     the whole of K: S is formed once per key tile at every instance;
//   * the online softmax is the mma.sync forward's, the same code
//     (softmax_step): keys past N masked to -1e30, running max over the
//     quad, alpha = exp(m_old - m_new) rescaling l and O, l summing the fp32
//     probabilities before dropout scales each kept one by 1 / (1 - rate),
//     the mask bit of each score computed by the thread whose accumulator
//     holds it;
//   * O += P V: wgmma m64 x D x 16 (m64n256k16 at the 256 instance) with P
//     in registers (the S accumulator
//     rounded to bf16 is the A fragment, as in mma.sync) and V from shared
//     memory as an MN-major B (trans-b), fp32 accumulation in registers;
//   * a ring attention block resumes (m, each lane's part of l, O's
//     accumulator) and suspends them in the (B, H, N, 4) layout of the
//     mma.sync kernel, and runs the same per-tile arithmetic in the same
//     key order as one launch over the sequence, so chained blocks whose
//     boundaries fall on tiles of kKeys keys are bit-equal to it;
//   * epilogue: O / l (or the suspended accumulator) stored from registers
//     through the caller's strides up to K, lse by one lane per row.
// Not done here: FA3's ping-pong, which orders the two warpgroups'
// softmax and products by named barriers, TMA stores and a persistent tile
// scheduler; setmaxnreg is not used either (it would give a producer
// warpgroup's registers to two consumer warpgroups): one producer warp
// leaves the consumers 168 registers a thread at D 64 and 128, which the
// 64 x 128 S and O accumulators fit in, and D 256 has no producer warp.
// Budget: shared memory, Q (64 or 128) x D and two stages of K and V tiles
// of kKeys x D in bf16, plus 1,024 bytes of alignment and the barriers:
// 74,808 (D 64) and 83,000 (D 128) bytes, two CTAs an SM, and 197,688
// (D 256), dynamic; registers 128-168 a thread at D 64 and 128, 211 and
// (dropout) 237 at D 256, no spills (-Xptxas -v, CUDA 12.8). chip_smoke.py's
// build phase prints the registers and spills and the HGMMA count of each
// instance.
// The wgmma, descriptor, mbarrier, TMA and tensor-map helpers are
// sm90_common.cuh's, shared with the backward (flash_attention_bwd_sm90.cu).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "flash_fwd_common.cuh"
#include "flash_launch.cuh"
#include "sm90_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64;        // query rows of a consumer warpgroup
constexpr int kStages = 2;

template <int D>
struct Shape {
  // Consumer warpgroups a CTA (two at D 256, which share each K and V
  // tile, one CTA an SM, with no producer warp) and keys per tile.
  static constexpr int kGroups = D == 256 ? 2 : 1;
  static constexpr bool kProducerWarp = kGroups == 1;
  static constexpr int kKeys = D == 64 ? 128 : 64;
  static constexpr int kQRows = kGroups * kRows;       // queries a CTA
  static constexpr int kConsumers = kGroups * 128;
  static constexpr int kThreads = kConsumers + (kProducerWarp ? 32 : 0);
  static constexpr int kMinBlocks = kGroups == 1 ? 2 : 1;
  static constexpr int kAtoms = D / 64;   // 64-column (128-byte) boxes
  static constexpr int kQBytes = kQRows * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;
  static constexpr int kBarriers = 1 + 3 * kStages;
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 8 * kBarriers;
};

template <int D, bool kDropout, typename O>
__global__ void __launch_bounds__(Shape<D>::kThreads, Shape<D>::kMinBlocks)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      O* __restrict__ o, RowState state, int heads,
                      int seq_len, int kdim, int q_tiles, Strides so,
                      Dropout drop) {
  using S = Shape<D>;
  constexpr int kKeys = S::kKeys;
  constexpr int kConsumers = S::kConsumers;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Every box starts on a 1,024-byte boundary, as the swizzle needs.
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + S::kQBytes;                   // kStages tiles
  const uint32_t v_s = k_s + kStages * S::kTileBytes;      // kStages tiles
  const uint32_t bars = v_s + kStages * S::kTileBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // Query tiles of one (batch, head) are neighbours in launch order, so
  // its K and V are read from device memory once and from L2 after that.
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * S::kQRows;
  const int b = bh / heads;
  const int h = bh % heads;
  const int kv_tiles = (seq_len + kKeys - 1) / kKeys;
  const int atoms = live_atoms<D>(kdim);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The copies, each issued by one thread: Q, and key tile `it` into
  // stage it % kStages once the consumers have freed it.
  auto load_q = [&]() {
    mbar_expect_tx(q_full, atoms * S::kQRows * 128);
#pragma unroll
    for (int a = 0; a < S::kAtoms; ++a) {
      if (a < atoms) {
        tma_load(q_s + a * S::kQRows * 128, &tq, q_full, 64 * a, q0, h, b);
      }
    }
  };
  auto load_tile = [&](int it) {
    const int st = it % kStages;
    if (it >= kStages) mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
    const uint32_t k_t = k_s + st * S::kTileBytes;
    const uint32_t v_t = v_s + st * S::kTileBytes;
    mbar_expect_tx(k_full(st), atoms * kKeys * 128);
#pragma unroll
    for (int a = 0; a < S::kAtoms; ++a) {
      if (a < atoms) {
        tma_load(k_t + a * kKeys * 128, &tk, k_full(st), 64 * a,
                 it * kKeys, h, b);
      }
    }
    mbar_expect_tx(v_full(st), atoms * kKeys * 128);
#pragma unroll
    for (int a = 0; a < S::kAtoms; ++a) {
      if (a < atoms) {
        tma_load(v_t + a * kKeys * 128, &tv, v_full(st), 64 * a,
                 it * kKeys, h, b);
      }
    }
  };
  if constexpr (S::kProducerWarp) {
    if (warp == kConsumers / 32) {
      // Producer: one thread keeps the ring of stages full.
      if (lane == 0) {
        load_q();
        for (int it = 0; it < kv_tiles; ++it) load_tile(it);
      }
      return;
    }
  } else if (tid == 0) {
    // No producer warp: consumer thread 0 issues Q and the first tile,
    // then each next tile at the top of the loop below.
    load_q();
    load_tile(0);
  }

  // Consumers: warpgroup `group` owns query rows 64 group.. of the CTA's,
  // its warp w rows 16w..16w+15 of those; this lane rows row0 and row0 + 8
  // (flash_fwd_common.cuh's layout).
  const int group = warp / 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + kRows * group + 16 * (warp % 4) + g;
  const uint32_t q_group = q_s + group * kRows * 128;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};
  if (state.m_in != nullptr) {
    resume_state<D / 8>(acc, m_row, l_row, state,
                        state.acc_in + b * so.b + h * so.h, so.n, bh, row0,
                        seq_len, 0, kdim, t);
  }
  unsigned int hash_row[2];
  row_hashes<kDropout>(hash_row, drop, bh, row0);

  float s[kKeys / 8][4];
  uint32_t p[kKeys / 16][4];
  mbar_wait(q_full, 0);
  for (int it = 0; it < kv_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    if constexpr (!S::kProducerWarp) {
      // Tile it + 1 into the stage tile it - 1 held: in flight while this
      // one is multiplied.
      if (tid == 0 && it + 1 < kv_tiles) load_tile(it + 1);
      __syncwarp();
    }
    const uint32_t k_t = k_s + st * S::kTileBytes;
    const uint32_t v_t = v_s + st * S::kTileBytes;

    // S = Q K^T over the live boxes' k-steps, 4 per 64-column box.
    mbar_wait(k_full(st), parity);
    clear(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t within = (kk % 4) * 32;
      if (kk / 4 < atoms) {
        wgmma_ss<kKeys>(
            s, kmajor_desc(q_group + (kk / 4) * S::kQRows * 128 + within),
            kmajor_desc(k_t + (kk / 4) * kKeys * 128 + within), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    softmax_step<kDropout>(s, acc, m_row, l_row, hash_row, it * kKeys,
                           seq_len, t, drop);
    // P rounded to bf16: the S accumulator's pairs are the A fragments.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // O += P V over kKeys / 16 k-steps of 16 keys (2,048 bytes of V each).
    mbar_wait(v_full(st), parity);
    fence_operands(acc);
    fence_operands(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_rs<D>(acc, p[kk], mnmajor_desc(v_t + kk * 16 * 128, kKeys * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    fence_operands(p);
    mbar_arrive(empty(st));
  }
  store_output<D / 8>(acc, m_row, l_row, state, o + b * so.b + h * so.h,
                      so.n, bh, row0, seq_len, 0, kdim, t, true);
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
};

template <int D, bool kDropout, typename O>
cudaError_t launch_kernel(const Launch& a) {
  using S = Shape<D>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, a.q, a.kdim, a.seq_len, a.heads, a.batch, a.sq.b, a.sq.h,
              a.sq.n, S::kQRows) ||
      !encode(&tk, a.k, a.kdim, a.seq_len, a.heads, a.batch, a.sk.b, a.sk.h,
              a.sk.n, S::kKeys) ||
      !encode(&tv, a.v, a.kdim, a.seq_len, a.heads, a.batch, a.sv.b, a.sv.h,
              a.sv.n, S::kKeys)) {
    return cudaErrorInvalidValue;
  }
  static std::atomic<unsigned long long> smem_allowed{0};
  auto kernel = flash_fwd_sm90_kernel<D, kDropout, O>;
  const cudaError_t err = allow_dynamic_smem(kernel, S::kSmem, smem_allowed);
  if (err != cudaSuccess) return err;
  const int q_tiles = (a.seq_len + S::kQRows - 1) / S::kQRows;
  const long long blocks = static_cast<long long>(a.batch) * a.heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned int>(blocks), S::kThreads, S::kSmem,
           a.stream>>>(
      tq, tk, tv, static_cast<O*>(a.o), a.state, a.heads, a.seq_len, a.kdim,
      q_tiles, a.so, a.drop);
  return cudaGetLastError();
}

template <typename O, bool kDropout>
cudaError_t launch_dim(const Launch& a) {
  if (a.kdim <= 64) return launch_kernel<64, kDropout, O>(a);
  if (a.kdim <= 128) return launch_kernel<128, kDropout, O>(a);
  return launch_kernel<256, kDropout, O>(a);
}

}  // namespace

extern "C" {

// The arguments of flash_attention_fwd.cu's vtd_flash_attention_fwd, for
// bf16 (dtype 1) at head_dim K <= 256 with K % 8 == 0: out_fp32 1 writes
// the output in fp32 (a ring attention block), 0 in bf16. The instance is
// 64 for K <= 64, 128 for K <= 128, else 256; TMA zero-fills the columns
// past K; the workspace, the windowed route's, is not read. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// this kernel does not take (and when a tensor map cannot be encoded).
int vtd_flash_attention_fwd_sm90(const FlashFwdArgs* args, const void* q,
                                 const void* k, const void* v, void* o,
                                 void* lse, const void* m_in,
                                 const void* l_in, const void* acc_in,
                                 void* m_out, void* l_out,
                                 void* /*workspace*/,
                                 const unsigned int* seed, void* stream) {
  const FlashFwdArgs& p = *args;
  if (p.dtype != 1 || p.batch <= 0 || p.heads <= 0 || p.seq_len <= 0 ||
      p.head_dim <= 0 || p.head_dim > 256 || p.head_dim % 8 != 0) {
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
  if (!state_ok(state, p.out_fp32 != 0)) return cudaErrorInvalidValue;
  const Launch a{q, k, v, o, state, p.batch, p.heads, p.seq_len, p.head_dim,
                 strides_of<Strides>(p.strides, 0),
                 strides_of<Strides>(p.strides, 1),
                 strides_of<Strides>(p.strides, 2),
                 strides_of<Strides>(p.strides, 3), dropout_of(p, seed),
                 static_cast<cudaStream_t>(stream)};
  const DeviceScope scope(p.device);
  if (scope.error() != cudaSuccess) return scope.error();
  cudaError_t err;
  if (p.out_fp32 != 0) {
    err = p.dropout != 0 ? launch_dim<float, true>(a)
                         : launch_dim<float, false>(a);
  } else {
    err = p.dropout != 0 ? launch_dim<bf16, true>(a)
                         : launch_dim<bf16, false>(a);
  }
  return static_cast<int>(err);
}

const char* vtd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
