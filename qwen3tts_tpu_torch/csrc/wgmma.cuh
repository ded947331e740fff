// Hopper tensor-core building blocks of T1 (attn_forms.cu): the warpgroup
// product wgmma.mma_async m64n128k16 (bf16 in, f32 accumulate) with A in
// registers and B in shared memory, its shared-memory matrix descriptor
// and fences. sm_90a only.
//
// wgmma m64nNk16, for thread t of the warpgroup (warp w = t / 32, g = (t %
// 32) / 4, c = t % 4; PTX ISA, "Register Fragments and Shared Memory Matrix
// Layouts" of wgmma):
//   A in registers, four 32-bit registers of two bf16 each (the lower column
//     in the low half): a[0] (row 16w+g, cols 2c, 2c+1), a[1] (row 16w+g+8,
//     cols 2c, 2c+1), a[2] (row 16w+g, cols 2c+8, 2c+9), a[3] (row 16w+g+8,
//     cols 2c+8, 2c+9): mma.sync m16n8k16's A layout, a warp a 16-row slab;
//   D f32, N / 2 registers: d[4j], d[4j+1] (row 16w+g, cols 8j+2c, 8j+2c+1),
//     d[4j+2], d[4j+3] (row 16w+g+8, the same cols).
// So D's columns 16s..16s+15 rounded to bf16 are the A operand of a product
// that contracts over those columns: {d[8s], d[8s+1]}, {d[8s+2], d[8s+3]},
// {d[8s+4], d[8s+5]}, {d[8s+6], d[8s+7]}.
//
// B in shared memory with the 128-byte swizzle: rows of 128 bytes (64 bf16),
// eight rows an atom of 1024 bytes (1024-aligned), the 16-byte piece j of
// row r stored at piece j ^ (r % 8). A [rows x 128] bf16 matrix is kept as
// two 64-column halves of rows x 128 bytes each (``sw128_offset``).
//   K-major B (a row a column n of B, contiguous along the contracted k;
//     trans-b 0): SBO = 1024, the step between 8-row groups along N; LBO
//     unused. The k16 step s starts at half s / 4, byte 32 (s % 4) of a row.
//   MN-major B (a row a k, contiguous along N; trans-b 1): SBO = 1024, the
//     step between groups of 8 k; LBO = the step between 64-wide halves
//     along N. The k16 step s starts 2048 s bytes in.
#pragma once

#include <stdint.h>

namespace qt {
namespace {

constexpr uint32_t SW128_ATOM = 1024;  // bytes of one 8-row swizzle atom

// Byte offset of the 16-byte piece p (of 16 a row) of row r, in a
// [rows x 128] bf16 matrix kept as two swizzled 64-column halves.
__device__ __forceinline__ uint32_t sw128_offset(uint32_t r, uint32_t p, uint32_t rows) {
  return (p >> 3) * rows * 128u + r * 128u + (((p & 7u) ^ (r & 7u)) << 4);
}

// The matrix descriptor (start, LBO, SBO in bytes; 128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFFu) >> 4) << 32) | (1ull << 62);
}

// Register writes before it are seen by the wgmma issued after it.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy stores to shared memory are seen by the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of ``d`` across it (put
// after a wait, before the accumulator is read).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a . B, m64n128k16, A in registers, B by descriptor; scale_d 0
// overwrites d. TB: B is MN-major (1) or K-major (0).
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc_b), "n"(TB));
}

}  // namespace
}  // namespace qt
