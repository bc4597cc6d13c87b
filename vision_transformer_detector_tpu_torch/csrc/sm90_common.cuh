// What the Hopper flash kernels share (flash_attention_fwd_sm90.cu, the bf16
// forward, and flash_attention_bwd_sm90.cu, the bf16 backward): the wgmma
// products with fp32 accumulation and their fences, the shared-memory
// descriptors of the 128-byte swizzle in which TMA stores each box, the
// mbarrier operations of a producer/consumer ring, the TMA load, the
// thread-block cluster helpers of the wide forward's and the wide
// backward's cluster routes (flash_attention_{fwd,bwd}_wide.cu), and on the
// host the encoding of a tensor map from a tensor's own strides.
//
// Accumulator layout (m64nNk16, fp32): warp w of the warpgroup owns rows
// 16w..16w+15; a lane owns rows g and g + 8 (g = lane / 4) and, in each
// 8-column tile j, columns 8j + 2t and 8j + 2t + 1 (t = lane % 4):
// d[j][0], d[j][1] on row g, d[j][2], d[j][3] on row g + 8 (mma.sync's
// m16n8 layout, warp by warp). An A fragment in registers (16 rows x 16 k
// of bf16 per warp) is four pairs: (g, 2t), (g + 8, 2t), (g, 2t + 8),
// (g + 8, 2t + 8), so an accumulator's tiles 2kk and 2kk + 1 rounded to
// bf16 are the A fragment of k-step kk with no data movement.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

// D (64 x 32, fp32) = A B^T, + D when scale_d: A (64 x 16) and B (32 x 16)
// K-major bf16 in shared memory, through their descriptors.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) = A B^T, + D when scale_d: A (64 x 16) and B (64 x 16)
// K-major bf16 in shared memory, through their descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) = A B^T, + D when scale_d: A (64 x 16) and B (128 x 16)
// K-major bf16 in shared memory, through their descriptors.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A B: A (64 x 16 bf16) in registers, B (16 x 64)
// MN-major bf16 in shared memory (trans-b), through its descriptor.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A B: A (64 x 16 bf16) in registers, B (16 x 128)
// MN-major bf16 in shared memory (trans-b), through its descriptor.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 192, fp32) += A B: A (64 x 16 bf16) in registers, B (16 x 192)
// MN-major bf16 in shared memory (trans-b), through its descriptor.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[24][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, fp32) += A B: A (64 x 16 bf16) in registers, B (16 x 256)
// MN-major bf16 in shared memory (trans-b), through its descriptor.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[32][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int kTiles>
__device__ __forceinline__ void fence_operands(float (&d)[kTiles][4]) {
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}
template <int kSteps>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[kSteps][4]) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
  }
}

// Zeroes an accumulator before a group of products whose first k-step
// overwrites it: the products' operands are read-write ("+f"), so without
// this last tile's values would stay live, in registers, across the whole
// loop body.
template <int kTiles>
__device__ __forceinline__ void clear(float (&acc)[kTiles][4]) {
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  fence_operands(acc);
}

// D (64 x N) = A B^T (+ D when scale_d), both K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, da, db, scale_d);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else {
    wgmma_ss_n128(d, da, db, scale_d);
  }
}

// D (64 x N) += A B, A in registers, B MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else if constexpr (N == 192) {
    wgmma_rs_n192(d, a, db);
  } else {
    wgmma_rs_n256(d, a, db);
  }
}

// The 64-column boxes of an instance of width D that hold columns below K:
// all of them but at D 256, whose last box lies wholly past K at K <= 192
// and is neither loaded nor multiplied (the output columns it would feed
// are not stored).
template <int D>
__device__ __forceinline__ int live_atoms(int kdim) {
  return D == 256 ? (kdim + 63) / 64 : D / 64;
}

// Shared-memory matrix descriptors for the 128-byte swizzle, in which TMA
// stores each box: rows of 64 bf16 (128 bytes), 8-row groups 1,024 bytes
// apart, every group 1,024-byte aligned. Fields: start address >> 4 (bits
// 0-13), leading byte offset >> 4 (16-29), stride byte offset >> 4
// (32-45), layout 1 = 128-byte swizzle (62-63).
__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return (bytes & 0x3FFFF) >> 4;
}

// A K-major operand (rows x head-dim columns, e.g. Q as A and K as B of
// S = Q K^T): the k-step of 16 columns advances the start address 32 bytes
// within the 128-byte row.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return desc_field(addr) | (desc_field(16) << 16) |
         (desc_field(1024) << 32) | (1ull << 62);
}

// An MN-major operand (a rows x head-dim tile read transposed as the B of
// a product over its rows, e.g. V in O += P V): the leading byte offset
// steps between 64-column blocks of the tile (block_bytes apart), the
// stride byte offset between 8-row groups.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr,
                                                 uint32_t block_bytes) {
  return desc_field(addr) | (desc_field(block_bytes) << 16) |
         (desc_field(1024) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// An arrival with release semantics: this thread's shared-memory stores
// before it are visible to the threads that wait on the phase.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of `map` at coordinates (column, row, head, batch) into
// shared memory at dst, its bytes reported to barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// Thread-block clusters (the wide forward's and the wide backward's cluster
// routes): this CTA's rank
// in its cluster; the cluster barrier, split into an arrival (release: the
// shared-memory stores before it are visible to the cluster) and a wait
// (acquire), which every thread of every CTA of the cluster runs in turn;
// a shared-memory address of this CTA mapped to the same offset in the
// CTA of rank `rank`; and a 16-byte load through such an address.
__device__ __forceinline__ int cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return static_cast<int>(rank);
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t mapped;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(mapped)
               : "r"(addr), "r"(rank));
  return mapped;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// A cluster's exchange of partial products (the wide forward's S, the
// cluster backward's S and dP). Each part (a warp's 16 rows in fp32, a
// warpgroup's 64 in bf16; kSlots threads, kTiles 8-column tiles each) lies in
// shared memory as float4s, [part][tile][thread], so a thread reads 16
// consecutive bytes of a peer's part; parts are indexed by tile parity.
template <int kSlots, int kTiles>
__device__ __forceinline__ void put_part(const float (&s)[kTiles][4],
                                         float* x, int part, int slot) {
  float4* at = reinterpret_cast<float4*>(x) + part * kTiles * kSlots + slot;
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    at[j * kSlots] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
  }
}

// S of this thread's elements: the cluster's kHalves * ranks parts (in
// each CTA, part `first` of the first half and first + step of the second;
// with kHalves 1 the one part `first`) summed in one order, rank by rank
// and the first half's before the second's, so every thread that holds
// these elements, in every CTA, holds the same fp32 S (with two parts the
// order did not matter; with more it is what keeps the softmax, lse and
// the dropout mask the same in every CTA).
template <int kSlots, int kTiles, int kHalves = 2>
__device__ __forceinline__ void sum_parts(float (&s)[kTiles][4], uint32_t x,
                                          int first, int step, int slot,
                                          int ranks) {
  constexpr uint32_t kPart = kTiles * kSlots * 16;   // bytes a part
  const uint32_t mine = x + first * kPart + slot * 16;
  for (int r = 0; r < ranks; ++r) {
    const uint32_t at = map_rank(mine, r);
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        const float4 p = ld_cluster_f4(at + half * step * kPart +
                                       j * kSlots * 16);
        const bool add = (r | half) != 0;
        s[j][0] = add ? s[j][0] + p.x : p.x;
        s[j][1] = add ? s[j][1] + p.y : p.y;
        s[j][2] = add ? s[j][2] + p.z : p.z;
        s[j][3] = add ? s[j][3] + p.w : p.w;
      }
    }
  }
}

// The portable cluster size: the most CTAs a cluster route launches.
constexpr int kClusterMax = 8;

// The CTAs of a cluster at K for CTAs of at most `share` columns.
__host__ __device__ constexpr int cluster_ranks(int kdim, int share) {
  return (kdim + share - 1) / share;
}

// What a cluster route's launcher is asked: to launch, or (query) how many
// clusters of its kernels can be resident at once, the least over them, into
// *resident (plan time: no operand is read, no tensor map encoded).
struct Ask {
  bool query;
  int* resident;
};
constexpr Ask kLaunch{false, nullptr};

// The configuration of a launch of CTAs of `threads` in clusters of `ranks`
// CTAs along x (cudaLaunchKernelEx); built in place, since it points at its
// attribute.
struct ClusterConfig {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  ClusterConfig(int threads, unsigned int blocks, int ranks, int smem,
                cudaStream_t stream) {
    config.gridDim = dim3(blocks);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
  }
  ClusterConfig(const ClusterConfig&) = delete;
};

// How many clusters of `ranks` CTAs of kernel (`threads` each, `smem` bytes
// of dynamic shared memory) fit on the device at once.
template <typename Kernel>
cudaError_t resident_clusters(Kernel kernel, int threads, int ranks,
                              int smem, int* resident) {
  const ClusterConfig c(threads, ranks, ranks, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(resident, kernel, &c.config);
}

template <typename... Params, typename... Args>
cudaError_t run_cluster(void (*kernel)(Params...), int threads,
                        unsigned int blocks, int ranks, int smem,
                        cudaStream_t stream, Args&&... args) {
  const ClusterConfig c(threads, blocks, ranks, smem, stream);
  const cudaError_t err = cudaLaunchKernelEx(&c.config, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A barrier of the consumer warpgroup alone (named barrier 1, 128
// threads): the producer warp never waits on it.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  });
  return fn;
}

// The (K, N, heads, batch) map of a bf16 tensor with element strides sb,
// sh, sn (unit head-dim stride), boxes of 64 columns x rows, stored with
// the 128-byte swizzle; TMA fills columns past K and rows past N with
// zeros. A stride of an axis of size 1 is never followed, and is given the
// packed value, which TMA's 16-byte rule holds.
inline bool encode(CUtensorMap* map, const void* ptr, int kdim, int seq_len,
                   int heads, int batch, long long sb, long long sh,
                   long long sn, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t row_bytes =
      (static_cast<cuuint64_t>(kdim) * 2 + 15) / 16 * 16;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kdim),
                              static_cast<cuuint64_t>(seq_len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t packed[3] = {row_bytes, row_bytes * seq_len,
                                row_bytes * seq_len * heads};
  const long long given[3] = {sn, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? packed[i]
                                  : static_cast<cuuint64_t>(given[i]) * 2;
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
