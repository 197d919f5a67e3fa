// Hopper (sm_90a) building blocks shared by the port's kernels:
// cp.async copies into shared memory, the 128-byte-swizzled tile layout,
// wgmma descriptors, fences and the bf16 and TF32 wgmma products (f32
// accumulators).  Included by flash_attn.cu, gram_norm.cu, pe_conv_grad.cu
// and fma_core.cuh; build.py hashes it with every source that includes
// it.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, of which `bytes` (0 to 16) are
// read and the rest zero-filled; 4 bytes likewise (`bytes` 4 or 0).  The
// source address is aligned to the copy's size.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// This thread's finished copies become visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of the 16-byte chunk c (columns 8c .. 8c + 7) of row r in a
// swizzled tile of R rows: 64-column halves of R x 128 bytes each, chunk
// c % 8 of a row stored at (c % 8) ^ (r % 8).
template <int R>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  return (uint32_t)((c >> 3) * (R * 128) + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

// wgmma matrix descriptor of a 128-byte-swizzled operand in shared
// memory: start address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// k-step kk (columns 16 kk .. 16 kk + 15) of 64 rows from row0 of a
// K-major tile of R rows (the contraction runs along the row).
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0, int kk) {
  return desc(tile + (kk >> 2) * (R * 128) + row0 * 128 + (kk & 3) * 32, 16,
              1024);
}
// k-step kk (rows 16 kk .. 16 kk + 15) of an MN-major tile of R rows (the
// contraction runs down the columns): 8-row groups 1024 bytes apart, the
// second 64-column half R x 128 bytes on.
template <int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, R * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of wgmma's registers across
// the fence / wait around it.
template <int N> __device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define REPRO_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_D32 REPRO_D8(0), REPRO_D8(8), REPRO_D8(16), REPRO_D8(24)
#define REPRO_D64 \
  REPRO_D32, REPRO_D8(32), REPRO_D8(40), REPRO_D8(48), REPRO_D8(56)
#define REPRO_R32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define REPRO_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64, f32) += A.B over 16 of K, both operands in shared memory:
// A (64 x 16) K-major (TA = 0) or MN-major (TA = 1); B (16 x 64) K-major,
// that is stored as B^T (TB = 0), or MN-major (TB = 1).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : REPRO_D32
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}
// d (64 x N, f32) += A.B over 16 of K: A (64 x 16) in registers, B
// (16 x N) MN-major in shared memory; N = 64 or 128.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REPRO_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 64, f32) = scale_d * d + A.B over one 32-byte k-step, both
// operands K-major in shared memory (A and B 64 rows each): 8 of K in
// TF32 (each operand's top 19 bits are read), or 16 of K in bf16.
__device__ __forceinline__ void mma_ss64_tf32(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REPRO_R32
      ", %32, %33, p, 1, 1;\n}\n"
      : REPRO_D32
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void mma_ss64_bf16(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_D32
      : "l"(a), "l"(b), "r"(scale_d));
}
#undef REPRO_D8
#undef REPRO_D32
#undef REPRO_D64
#undef REPRO_R32
#undef REPRO_R64

}  // namespace hopper
