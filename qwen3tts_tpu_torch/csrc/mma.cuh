// Warp-level tensor-core building blocks (mma.sync m16n8k16, bf16 in, f32
// accumulate; mma.sync m16n8k32, s8 in, s32 accumulate; ldmatrix from shared
// memory; movmatrix; a packed bf16 add), shared by attn_forms.cu (T1),
// int4_repack.cu (T4) and the batched GEMV of common.cuh (K2 at B > 1).
//
// Fragment layout of mma.m16n8k16.row.col (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), for lane t with g = t / 4 and c = t % 4:
//   A [16 x 16], four 32-bit registers of two bf16 each, the lower column in
//     the low half: a[0] (row g, cols 2c, 2c+1), a[1] (row g+8, cols 2c,
//     2c+1), a[2] (row g, cols 2c+8, 2c+9), a[3] (row g+8, cols 2c+8, 2c+9);
//   B [16 x 8], two registers: b0 (rows 2c, 2c+1 of col g), b1 (rows 2c+8,
//     2c+9 of col g);
//   C / D [16 x 8] f32: d[0], d[1] (row g, cols 2c, 2c+1), d[2], d[3]
//     (row g+8, cols 2c, 2c+1).
// So the C tiles of columns 8j..8j+15 are, rounded to bf16, the A fragment
// of a product that contracts over those 16 columns.
//
// mma.m16n8k32.row.col with s8 operands ("Matrix Fragments for
// mma.m16n8k32"): A [16 x 32] in four registers of four int8 each, the lower
// column in the low byte: a[0] (row g, cols 4c..4c+3), a[1] (row g+8, cols
// 4c..4c+3), a[2] (row g, cols 16+4c..16+4c+3), a[3] (row g+8, cols
// 16+4c..); B [32 x 8] in two: b0 (rows 4c..4c+3 of col g), b1 (rows
// 16+4c..16+4c+3 of col g); C / D s32 laid out as the f32 C above.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace qt {
namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m.
// Register m holds matrix m's (row t/4, cols 2(t%4), 2(t%4)+1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, transposed: register m holds matrix m's (rows 2(t%4), 2(t%4)+1
// of col t/4).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores (bf16 products, f32 sums). Not volatile:
// a pure function of its operands, which the compiler may schedule freely
// (the ldmatrix loads above stay volatile, ordered after the barriers that
// publish their shared memory).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on the tensor cores (s8 products, exact s32 sums; no
// saturation: the callers' sums stay far inside the int32 range).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The 8x8 b16 matrix held as mma fragments (lane t: row t/4, cols 2(t%4),
// 2(t%4)+1), transposed across the warp. Not volatile: a pure function of
// the warp's registers, which the compiler may schedule freely (as mma_bf16).
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// bf16x2(a + c), each half rounded once to nearest even (a . 1 + c). For
// bf16 a and c this equals bf16(f32(a) + f32(c)): the f32 sum is exact
// unless the exponents differ by more than 16, and then the smaller term is
// far below half a bf16 step of the larger.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t c) {
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(y) : "r"(a), "r"(0x3f803f80u), "r"(c));
  return y;
}

}  // namespace
}  // namespace qt
