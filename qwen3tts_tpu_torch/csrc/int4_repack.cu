// T4: two forms of a packed-int4 matvec, for Hopper (sm_90a).
//
// Replaces tools/exp_int4_repack.py's two Pallas kernels, the alternatives
// to K4 (csrc/quant_matmul.cu) that the script times beside it:
//
// * ``mxu_variant`` (kernel ``_mxu_kernel`` :48-69, pallas_call at :78):
//   y[o] = (sum_i bf16(x[i]) * q[o, i]) * scales[o, 0] + sum_g biases[o, g],
//   q the 4-bit values of packed u32 [O, I/8] (value i of row o is nibble
//   i % 8 of word i / 8). One per-row scale, so not K4's function (the
//   script: "timing-faithful, numerics not"); this is the TPU kernel's
//   function, exactly. Design: the nibbles are dequantized to bf16 in
//   registers and multiplied on the tensor cores (mma.sync m16n8k16, f32
//   sums), x as the A operand padded with zero rows to the instruction's 16
//   rows, 8 output rows per B tile. A product's K order is free, so each
//   lane builds its B fragment from one packed word: lane (g, c) of a warp
//   loads words 4c..4c+3 of a 16-word chunk of row g (16 bytes, 4 lanes a
//   row's 64 contiguous bytes) and its word 4c+p gives the fragment's
//   values 8(4c+p) + 4h .. +3 at k16 step (p, h); x's A fragment follows
//   the same order from a bf16 copy in shared memory. A CTA's four warps
//   take every fourth chunk of one 8-row tile and meet in shared memory.
// * ``plane_variant`` (kernel ``_plane_kernel`` :96-110, pallas_call at
//   :116): lo and hi u32 [O, I/16] nibble planes (nibble j of word w is
//   value 8w + j of the row's first half in lo, of its second half in hi),
//   y[o] = (sum_i q[o, i] * x[i]) * scales[o, 0] in f32 on the CUDA cores,
//   no bias. Design: K4's, one warp per row, 16-byte loads of each plane,
//   x staged in shared memory as f32, strided by plane word
//   (xs[h*8 + j][w] = x[h*I/2 + 8w + j], the script's ``xs``), so a lane's
//   float4 reads are free of bank conflicts.
//
// Bound on the H100: device-memory bandwidth, every input byte read once:
// the packed words (I/2 bytes a row), the scale column and, for mxu, the
// biases. At (I, O) = (1024, 3072) that is ~1.8 MB, ~0.5 us: a call is
// bound by its launch rather than by its bytes, as K4 is.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "reduce.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using qt::mma_bf16;
using qt::pack_bf16;
using qt::warp_sum;

constexpr int MX_WARPS = 4;               // warps of one 8-row tile, splitting I
constexpr int MX_THREADS = 32 * MX_WARPS;
constexpr int MX_CHUNK = 128;             // values of a row per chunk (16 words)
constexpr int PL_THREADS = 256;           // plane: one row per warp
constexpr int PL_ROWS = PL_THREADS / 32;

__device__ __forceinline__ float nib(uint32_t w, int j) { return (float)((w >> (4 * j)) & 15u); }

__global__ void __launch_bounds__(MX_THREADS)
int4_mxu_kernel(const float* __restrict__ x, const uint32_t* __restrict__ packed,
                const float* __restrict__ scales, const float* __restrict__ biases,
                float* __restrict__ y, int I, int NG) {
  extern __shared__ uint4 mx_smem[];
  bf16* xs = reinterpret_cast<bf16*>(mx_smem);                  // [I]
  float* red = reinterpret_cast<float*>(xs + I);                // [MX_WARPS][8]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3, n0 = blockIdx.x * 8, W = I / 8;
  for (int i = tid; i < I; i += MX_THREADS) xs[i] = __float2bfloat16_rn(x[i]);
  __syncthreads();

  const uint4* row = reinterpret_cast<const uint4*>(packed + (size_t)(n0 + g) * W) + c;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int ch = warp; ch < I / MX_CHUNK; ch += MX_WARPS) {
    const uint4 wv = __ldg(row + 4 * ch);  // words 4c..4c+3 of chunk ch
    const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t a[4] = {0u, 0u, 0u, 0u};
        if (g == 0) {  // x is row 0 of A; rows 1-15 are zero padding
          const uint2 xv = *reinterpret_cast<const uint2*>(xs + ch * MX_CHUNK + 8 * (4 * c + p) + 4 * h);
          a[0] = xv.x;
          a[2] = xv.y;
        }
        const uint32_t w = words[p];
        mma_bf16(acc, a, pack_bf16(nib(w, 4 * h), nib(w, 4 * h + 1)),
                 pack_bf16(nib(w, 4 * h + 2), nib(w, 4 * h + 3)));
      }
    }
  }
  if (g == 0) {  // row 0 of C: outputs n0 + 2c, n0 + 2c + 1
    red[warp * 8 + 2 * c] = acc[0];
    red[warp * 8 + 2 * c + 1] = acc[1];
  }
  __syncthreads();
  if (tid < 8) {
    const int o = n0 + tid;
    float sum = 0.f, bsum = 0.f;
#pragma unroll
    for (int w = 0; w < MX_WARPS; ++w) sum += red[w * 8 + tid];
    for (int j = 0; j < NG; ++j) bsum += biases[(size_t)o * NG + j];
    y[o] = sum * scales[(size_t)o * NG] + bsum;
  }
}

__global__ void __launch_bounds__(PL_THREADS)
int4_plane_kernel(const float* __restrict__ x, const uint32_t* __restrict__ lo,
                  const uint32_t* __restrict__ hi, const float* __restrict__ scales,
                  float* __restrict__ y, int O, int I, int NG) {
  extern __shared__ float4 pl_smem[];
  float* xs = reinterpret_cast<float*>(pl_smem);  // [16][Wp]
  const int Wp = I / 16, W4 = Wp / 4, half = I / 2;
  for (int t = threadIdx.x; t < I; t += PL_THREADS) {
    const int hj = t / Wp, w = t - hj * Wp;  // row h*8 + j of xs, word w
    xs[t] = x[(hj / 8) * half + 8 * w + (hj % 8)];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, o = blockIdx.x * PL_ROWS + (threadIdx.x >> 5);
  if (o >= O) return;
  const uint4* lrow = reinterpret_cast<const uint4*>(lo + (size_t)o * Wp);
  const uint4* hrow = reinterpret_cast<const uint4*>(hi + (size_t)o * Wp);
  const float4* xs4 = pl_smem;
  float acc = 0.f;
#pragma unroll 2
  for (int c = lane; c < W4; c += 32) {
    const uint4 l = __ldg(lrow + c), h = __ldg(hrow + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 xl = xs4[j * W4 + c], xh = xs4[(8 + j) * W4 + c];
      acc = fmaf(nib(l.x, j), xl.x, acc);
      acc = fmaf(nib(l.y, j), xl.y, acc);
      acc = fmaf(nib(l.z, j), xl.z, acc);
      acc = fmaf(nib(l.w, j), xl.w, acc);
      acc = fmaf(nib(h.x, j), xh.x, acc);
      acc = fmaf(nib(h.y, j), xh.y, acc);
      acc = fmaf(nib(h.z, j), xh.z, acc);
      acc = fmaf(nib(h.w, j), xh.w, acc);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) y[o] = acc * scales[(size_t)o * NG];
}

}  // namespace

// y [O] f32 = mxu_variant(x [I] f32, packed u32 [O, I/8], scales and
// biases f32 [O, NG]). Needs O % 8 == 0 and I % 128 == 0.
extern "C" int qt_int4_mxu(int O, int I, int NG, const void* x, const void* packed,
                           const void* scales, const void* biases, void* y, void* stream) {
  if (O <= 0 || O % 8 || I <= 0 || I % MX_CHUNK || NG <= 0 || !x || !packed || !scales ||
      !biases || !y || ((uintptr_t)packed & 15))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)I * sizeof(bf16) + MX_WARPS * 8 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int4_mxu_kernel<<<O / 8, MX_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const uint32_t*)packed, (const float*)scales, (const float*)biases,
      (float*)y, I, NG);
  return (int)cudaGetLastError();
}

// y [O] f32 = plane_variant(x [I] f32, lo and hi u32 [O, I/16], scales f32
// [O, NG]). Needs I % 64 == 0 (16-byte loads of each plane row).
extern "C" int qt_int4_plane(int O, int I, int NG, const void* x, const void* lo, const void* hi,
                             const void* scales, void* y, void* stream) {
  if (O <= 0 || I <= 0 || I % 64 || NG <= 0 || !x || !lo || !hi || !scales || !y ||
      (((uintptr_t)lo | (uintptr_t)hi) & 15))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)I * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        int4_plane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int4_plane_kernel<<<(O + PL_ROWS - 1) / PL_ROWS, PL_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const uint32_t*)lo, (const uint32_t*)hi, (const float*)scales, (float*)y,
      O, I, NG);
  return (int)cudaGetLastError();
}
