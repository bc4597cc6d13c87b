// Warp-level tensor-core building blocks shared by flash_attention_fwd.cu
// and flash_attention_bwd.cu, for Hopper (sm_90a). Plain inline PTX: the
// build (kernels/_build.py) passes nvcc no include path, so CUTLASS and
// CuTe are not used.
//
//   * cp.async: 16-byte (and 4-byte) asynchronous copies from device memory
//     into shared memory, zero-filling rows past the sequence end, with
//     commit_group / wait_group for double buffering;
//   * ldmatrix (.x4, .x4.trans) for bf16 fragments;
//   * mma.sync.m16n8k16 in bf16 and mma.sync.m16n8k8 in TF32, both with
//     fp32 accumulation;
//   * the 3xTF32 split that keeps fp32 accuracy on the TF32 tensor cores;
//   * what both kernels repeat: the async tile loader, the product of an
//     accumulator with a [k][n] tile (add_acc_kn, which for fp32 also keeps
//     long sums out of the truncating accumulator) and the paired store;
//   * on the host, the raise of a kernel's dynamic shared-memory limit,
//     made once per device rather than at every launch.
//
// Fragments are described from one warp's point of view, in mma.sync's
// register layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "mma.m16n8k8"), with lane = 4 * g + t, g = lane / 4 in 0..7 and
// t = lane % 4:
//   * an accumulator n-tile, float[4], is the 16 x 8 fp32 block's rows g
//     and g + 8 at columns 2t and 2t + 1: c[0] = (g, 2t), c[1] = (g, 2t + 1),
//     c[2] = (g + 8, 2t), c[3] = (g + 8, 2t + 1);
//   * an A fragment covers 16 rows x 16 k, a B fragment 16 k x 8 columns.
// Both element types expose one interface, Mma<T>, so each kernel is
// written once for both:
//   * bf16: one mma.m16n8k16 per (A, B) pair; fragments come from shared
//     memory through ldmatrix (.trans for [k][n] storage), and an
//     accumulator pair rounded to bf16 is already the next product's A
//     fragment (the cast `p.astype(v.dtype)` of the Pallas kernels);
//   * fp32, "3xTF32": each operand is split into its TF32 rounding and the
//     TF32 rounding of the remainder, a = hi + lo, and each m16n8k8 product
//     is three mma.sync, lo*hi + hi*lo + hi*hi, accumulated in fp32. The
//     dropped lo*lo term and lo's own rounding are about 2^-22 of each
//     product, so the result keeps fp32 accuracy to a few ulps at the TF32
//     tensor-core rate; a single TF32 product keeps about three decimal
//     digits. Fragments are read with 32-bit shared-memory loads and split
//     once, when they are loaded.
// The k order inside one product step is free as long as A and B agree.
// The fp32 fragments use that: an accumulator pair (2t, 2t + 1) becomes the
// A fragment's k = t and k = t + 4 with no data movement, so the B loader for
// [k][n] storage (and the A loader for [k][row] storage) reads rows 2t and
// 2t + 1 for them.
//
// Shared-memory tiles are row-major with one extra 16-byte chunk per row
// (Mma<T>::kPad elements), which puts the eight rows that one ldmatrix
// matrix (or one 32-bit load of a fragment) touches on distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with valid false
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, for the unaligned fp32 lse / delta rows of the backward.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ about 2^-22 |x|), both TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two adjacent values of an accumulator row, stored as the element type
// (8 or 4 bytes, aligned: the column is even).
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kPad = 8;   // one 16-byte chunk per row
  static constexpr bool kTileSums = false;   // see add_acc_kn
  struct A {
    uint32_t x[4];
  };
  struct B {
    uint32_t x[2];
  };

  // A (rows row0..+15, k k0..+15) from [row][k] storage, row stride ld.
  static __device__ __forceinline__ void load_a(A& a, const T* s, int ld,
                                                int row0, int k0, int lane) {
    ldmatrix_x4(a.x, s + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
  }

  // A (rows row0..+15, k k0..+15) from [k][row] storage.
  static __device__ __forceinline__ void load_a_t(A& a, const T* s, int ld,
                                                  int k0, int row0,
                                                  int lane) {
    ldmatrix_x4_trans(a.x, s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld +
                               row0 + ((lane >> 3) & 1) * 8);
  }

  // B for columns n0..+7 (b0) and n0+8..+15 (b1), k k0..+15, from [n][k]
  // storage.
  static __device__ __forceinline__ void load_b_nk(B& b0, B& b1, const T* s,
                                                   int ld, int n0, int k0,
                                                   int lane) {
    uint32_t r[4];
    ldmatrix_x4(r, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                       ((lane >> 3) & 1) * 8);
    b0.x[0] = r[0];
    b0.x[1] = r[1];
    b1.x[0] = r[2];
    b1.x[1] = r[3];
  }

  // The same from [k][n] storage.
  static __device__ __forceinline__ void load_b_kn(B& b0, B& b1, const T* s,
                                                   int ld, int k0, int n0,
                                                   int lane) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                             n0 + (lane >> 4) * 8);
    b0.x[0] = r[0];
    b0.x[1] = r[1];
    b1.x[0] = r[2];
    b1.x[1] = r[3];
  }

  // A (16 rows x 16 k) from two accumulator n-tiles, k 0..7 and 8..15,
  // each value rounded to bf16.
  static __device__ __forceinline__ void acc_to_a(A& a, const float (&c0)[4],
                                                  const float (&c1)[4]) {
    a.x[0] = pack_bf16(c0[0], c0[1]);
    a.x[1] = pack_bf16(c0[2], c0[3]);
    a.x[2] = pack_bf16(c1[0], c1[1]);
    a.x[3] = pack_bf16(c1[2], c1[3]);
  }

  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma_bf16_16816(d, a.x, b.x[0], b.x[1]);
  }
};

template <>
struct Mma<float> {
  using T = float;
  static constexpr int kPad = 4;   // one 16-byte chunk per row
  static constexpr bool kTileSums = true;    // see add_acc_kn
  // Two m16n8k8 steps, s = 0 (k 0..7) and s = 1 (k 8..15): element
  // [4 * s + i] of A and [2 * s + i] of B is mma.m16n8k8's a_i / b_i.
  struct A {
    uint32_t hi[8], lo[8];
  };
  struct B {
    uint32_t hi[4], lo[4];
  };

  static __device__ __forceinline__ void set(A& a, int i, float x) {
    split_tf32(x, a.hi[i], a.lo[i]);
  }
  static __device__ __forceinline__ void set(B& b, int i, float x) {
    split_tf32(x, b.hi[i], b.lo[i]);
  }

  // a_0 = (g, t), a_1 = (g + 8, t), a_2 = (g, t + 4), a_3 = (g + 8, t + 4).
  static __device__ __forceinline__ void load_a(A& a, const T* s, int ld,
                                                int row0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const T* p = s + (row0 + g) * ld + k0 + 8 * st + t;
      set(a, 4 * st + 0, p[0]);
      set(a, 4 * st + 1, p[8 * ld]);
      set(a, 4 * st + 2, p[4]);
      set(a, 4 * st + 3, p[8 * ld + 4]);
    }
  }

  // From [k][row] storage, k = t read from row 2t and k = t + 4 from 2t + 1.
  static __device__ __forceinline__ void load_a_t(A& a, const T* s, int ld,
                                                  int k0, int row0,
                                                  int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const T* p = s + (k0 + 8 * st + 2 * t) * ld + row0 + g;
      set(a, 4 * st + 0, p[0]);
      set(a, 4 * st + 1, p[8]);
      set(a, 4 * st + 2, p[ld]);
      set(a, 4 * st + 3, p[ld + 8]);
    }
  }

  // b_0 = (k t, column g), b_1 = (k t + 4, column g).
  static __device__ __forceinline__ void load_b_nk(B& b0, B& b1, const T* s,
                                                   int ld, int n0, int k0,
                                                   int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const T* p = s + (n0 + g) * ld + k0 + 8 * st + t;
      set(b0, 2 * st + 0, p[0]);
      set(b0, 2 * st + 1, p[4]);
      set(b1, 2 * st + 0, p[8 * ld]);
      set(b1, 2 * st + 1, p[8 * ld + 4]);
    }
  }

  // From [k][n] storage, k = t from row 2t and k = t + 4 from row 2t + 1.
  static __device__ __forceinline__ void load_b_kn(B& b0, B& b1, const T* s,
                                                   int ld, int k0, int n0,
                                                   int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const T* p = s + (k0 + 8 * st + 2 * t) * ld + n0 + g;
      set(b0, 2 * st + 0, p[0]);
      set(b0, 2 * st + 1, p[ld]);
      set(b1, 2 * st + 0, p[8]);
      set(b1, 2 * st + 1, p[ld + 8]);
    }
  }

  // Step s takes accumulator n-tile c_s: (g, 2t) and (g + 8, 2t) as k = t,
  // (g, 2t + 1) and (g + 8, 2t + 1) as k = t + 4.
  static __device__ __forceinline__ void acc_to_a(A& a, const float (&c0)[4],
                                                  const float (&c1)[4]) {
    set(a, 0, c0[0]);
    set(a, 1, c0[2]);
    set(a, 2, c0[1]);
    set(a, 3, c0[3]);
    set(a, 4, c1[0]);
    set(a, 5, c1[2]);
    set(a, 6, c1[1]);
    set(a, 7, c1[3]);
  }

  // 3xTF32: the two small cross terms first, then hi * hi.
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const uint32_t* ah = a.hi + 4 * st;
      const uint32_t* al = a.lo + 4 * st;
      const uint32_t* bh = b.hi + 2 * st;
      const uint32_t* bl = b.lo + 2 * st;
      mma_tf32_1688(d, al[0], al[1], al[2], al[3], bh[0], bh[1]);
      mma_tf32_1688(d, ah[0], ah[1], ah[2], ah[3], bl[0], bl[1]);
      mma_tf32_1688(d, ah[0], ah[1], ah[2], ah[3], bh[0], bh[1]);
    }
  }
};

// out (16 x kN) += A (16 x kK) B: A from kK / 8 accumulator n-tiles,
// rounded to T, B (kK x kN) from [k][n] storage with row stride ld.
template <typename T, int kK, int kN>
__device__ __forceinline__ void mma_acc_kn(float (&out)[kN / 8][4],
                                           const float (&a)[kK / 8][4],
                                           const T* b, int ld, int lane) {
  using M = Mma<T>;
#pragma unroll
  for (int kc = 0; kc < kK / 16; ++kc) {
    typename M::A frag;
    M::acc_to_a(frag, a[2 * kc], a[2 * kc + 1]);
#pragma unroll
    for (int np = 0; np < kN / 16; ++np) {
      typename M::B b0, b1;
      M::load_b_kn(b0, b1, b, ld, 16 * kc, 16 * np, lane);
      M::mma(out[2 * np], frag, b0);
      M::mma(out[2 * np + 1], frag, b1);
    }
  }
}

// Columns of a 64-row tile's product that one pass forms in fresh
// registers: all of them up to 64, then 64 at a time (the 128-wide
// instances take two passes), which changes no column's sum.
template <int kN>
__host__ __device__ constexpr int col_pass() {
  static_assert(kN <= 64 || kN % 64 == 0, "column passes");
  return kN > 64 ? 64 : kN;
}

// The same product added into a sum carried over many tiles (the forward's
// O, the backward's dK and dV). The tensor cores align and truncate when
// they add into the fp32 accumulator, so a sum carried in it through
// hundreds of mma drifts by about half an ulp per mma, always the same way
// (1.2e-5 of dk's largest value at N = 1296 in fp32). For fp32 each tile's
// product is therefore summed in fresh registers and added with one
// round-to-nearest fp32 add per element; bf16, held to 2e-2, adds in place.
// The fresh registers cover col_pass<kN>() columns at a time.
template <typename T, int kK, int kN>
__device__ __forceinline__ void add_acc_kn(float (&out)[kN / 8][4],
                                           const float (&a)[kK / 8][4],
                                           const T* b, int ld, int lane) {
  if constexpr (Mma<T>::kTileSums) {
    constexpr int kCols = col_pass<kN>();
#pragma unroll
    for (int c = 0; c < kN / kCols; ++c) {
      float part[kCols / 8][4] = {};
      mma_acc_kn<T, kK, kCols>(part, a, b + kCols * c, ld, lane);
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) out[kCols / 8 * c + j][e] += part[j][e];
      }
    }
  } else {
    mma_acc_kn<T, kK, kN>(out, a, b, ld, lane);
  }
}

// Rows row0..row0+63 of a (seq_len, D) head slice (row stride in
// elements) into a shared tile of row stride D + kPad, with 16-byte
// cp.async copies; rows past seq_len are zero. Not committed here.
template <typename T, int D, int kRows, int kThreads>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long row_stride,
                                                int row0, int seq_len,
                                                int tid) {
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunksPerRow = D / kPerChunk;
  constexpr int kLd = D + Mma<T>::kPad;
  static_assert((kRows * kChunksPerRow) % kThreads == 0, "tile split");
#pragma unroll
  for (int i = 0; i < kRows * kChunksPerRow / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * kPerChunk;
    const int row = row0 + r;
    const bool valid = row < seq_len;
    cp_async16(dst + r * kLd + col, src + (valid ? row : 0) * row_stride + col,
               valid);
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device. The attribute is set once per device (devices 0..63) and `done`
// remembers where; a launch that finds its device's bit set makes no call.
// Two threads may both set it before either records it, which is harmless.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                               std::atomic<unsigned long long>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace
