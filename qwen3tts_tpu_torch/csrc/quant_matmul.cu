// K4: dequant-in-matmul for one row (B=1 decode) of an MLX-affine packed
// weight, for Hopper (sm_90a).
//
// Replaces qwen3tts_tpu/ops/quant.py::quant_matmul_pallas (body
// _quant_matmul_kernel): y[1, O] = x[1, I] . dequant(W)^T in f32, where W is
// uint32 [O, I/PW] (PW = 32/bits values per word; value j of word k is
// column k*PW + j at bit bits*j) with per-group f32 scales and biases
// [O, I/group]. No [O, I] matrix is ever written.
//
// Bound on the H100: device-memory bandwidth on the packed words plus scales
// and biases, read once each (bits 4, group 64: I/2 + 8*I/64 bytes per row;
// 3072 x 1024 is 1.97 MB, 0.59 us at 3.35 TB/s), one multiply-add per
// weight value. At the 0.6B shapes a call is a few microseconds of latency,
// not bytes: the first form of this kernel (a block per 8 rows that staged x
// in shared memory as f32 and took its group sums behind two block
// barriers, then one 16-byte weight load a lane) read 2.97-5.64 us where
// ``torch._weight_int4pack_mm`` read 2.16-3.48 us (NVIDIA H100 80GB HBM3,
// 700 W, tools/time_k3_k2.py --parts int4lib).
//
// Design: no prologue and one memory round trip a pass. A warp owns R
// consecutive rows; its lanes take the rows' 16-byte chunks (4 words: 32
// int4 or 16 int8 values of neighbouring columns) two at a time (chunk c
// and c + 32), so neighbouring lanes read neighbouring addresses. Each lane
// issues, before any arithmetic, its x values of those columns (x is a few
// KB and sits in L1/L2), the R x 2 weight chunks and the R x 2 scales and
// biases of their groups (a group holds whole chunks, so one of each a
// chunk; a warp's lanes read neighbouring scales). The bias term needs the
// group sums of x: each lane adds b[o, g] * sum(its chunk's x), and the sum
// over the lanes is b[o, g] * XS[g], so no shuffle or shared memory is
// needed until the end, where a warp sum per row finishes it. Values are
// widened exactly through the bits of 2^23 + q (a shift, a bit-or and a
// subtract: the integer-to-float instruction runs at a quarter of the FMA
// rate). The grid is sized to the SMs (at most two blocks of 8 warps each),
// row groups strided across its warps; R (rows a warp, 1, 2, 4 or 8) is
// chosen so that about one block a SM covers O.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_state.cuh"
#include "reduce.cuh"

namespace {

using qt::warp_sum;

constexpr int QG_THREADS = 256;  // 8 warps
constexpr int QG_WARPS = QG_THREADS / 32;
constexpr int QG_BLOCKS_PER_SM = 2;

// value j of a word, exactly, as f32
template <int BITS>
__device__ __forceinline__ float qval(uint32_t u, int j) {
  if (BITS == 4) return __int_as_float(0x4B000000u | ((u >> (4 * j)) & 0xFu)) - 8388608.0f;
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)) - 8388608.0f;
}

// the N = 4 PW values of x in chunk c (columns c N .. c N + N - 1), as f32
template <int N>
__device__ __forceinline__ void load_x(const float* x, int c, float (&v)[N]) {
  const float4* p = reinterpret_cast<const float4*>(x + (size_t)c * N);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 f = __ldg(p + i);
    v[4 * i] = f.x, v[4 * i + 1] = f.y, v[4 * i + 2] = f.z, v[4 * i + 3] = f.w;
  }
}
template <int N>
__device__ __forceinline__ void load_x(const __nv_bfloat16* x, int c, float (&v)[N]) {
  const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)c * N);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const uint4 u = __ldg(p + i);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
      v[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
}

// acc += s * (q . x) + b * sum(x) for one 16-byte chunk of a row
template <int BITS, int N>
__device__ __forceinline__ float chunk_dot(const uint4& w, const float (&x)[N], float xsum, float s,
                                           float b, float acc) {
  constexpr int PW = 32 / BITS;
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < PW; ++j) {
      const float q = qval<BITS>(u[k], j);
      if (k & 1) d1 = fmaf(q, x[k * PW + j], d1);
      else d0 = fmaf(q, x[k * PW + j], d0);
    }
  return fmaf(s, d0 + d1, fmaf(b, xsum, acc));
}

template <int BITS, typename XT, int R>
__global__ void __launch_bounds__(QG_THREADS)
quant_gemv_kernel(const XT* __restrict__ x, const uint4* __restrict__ wq,
                  const float* __restrict__ scales, const float* __restrict__ biases,
                  float* __restrict__ y, int O, int I, int group) {
  constexpr int N = 128 / BITS;  // values of a 16-byte chunk
  const int W4 = I / N, NG = I / group, cpg = group / N, lane = threadIdx.x & 31;
  for (int rg = blockIdx.x * QG_WARPS + (threadIdx.x >> 5); rg * R < O;
       rg += gridDim.x * QG_WARPS) {
    const int o0 = rg * R;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int c = lane; c < W4; c += 64) {  // chunks c and c + 32 of every row
      const bool two = c + 32 < W4;
      float xa[N], xb[N];
      uint4 wa[R], wb[R];
      float sa[R], ba[R], sb[R], bb[R];
      load_x(x, c, xa);
      if (two) load_x(x, c + 32, xb);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int o = min(o0 + r, O - 1);  // a row past O repeats the last, unwritten
        const size_t row = (size_t)o * W4, grow = (size_t)o * NG;
        wa[r] = __ldg(wq + row + c);
        sa[r] = __ldg(scales + grow + c / cpg);
        ba[r] = __ldg(biases + grow + c / cpg);
        if (two) {
          wb[r] = __ldg(wq + row + c + 32);
          sb[r] = __ldg(scales + grow + (c + 32) / cpg);
          bb[r] = __ldg(biases + grow + (c + 32) / cpg);
        }
      }
      float xsa = 0.f, xsb = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) xsa += xa[i];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = chunk_dot<BITS>(wa[r], xa, xsa, sa[r], ba[r], acc[r]);
      if (two) {
#pragma unroll
        for (int i = 0; i < N; ++i) xsb += xb[i];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = chunk_dot<BITS>(wb[r], xb, xsb, sb[r], bb[r], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = warp_sum(acc[r]);
      if (lane == r && o0 + r < O) y[o0 + r] = v;
    }
  }
}

// The current device's SM count (device_state.cuh: one entry a device).
int num_sms() { return qt::device_attr<cudaDevAttrMultiProcessorCount>(132); }

// Rows a warp: the fewest whose row groups fit one block of warps a SM (on
// an H100, 1 at O = 1024, 2 at 2048, 4 at 3072: the fastest of 1, 2, 4 and 8
// at the packed 0.6B shapes, tools/time_k3_k2.py --parts int4lib)
int rows_per_warp(int O) {
  const int warps = num_sms() * QG_WARPS;
  int R = 1;
  while (R < 8 && (O + R - 1) / R > warps) R *= 2;
  return R;
}

template <int BITS, typename XT, int R>
int launch_r(const void* x, const void* w, const void* s, const void* b, void* y, int O, int I,
             int group, cudaStream_t st) {
  const int groups = (O + R - 1) / R;
  const int blocks = min((groups + QG_WARPS - 1) / QG_WARPS, num_sms() * QG_BLOCKS_PER_SM);
  quant_gemv_kernel<BITS, XT, R><<<blocks, QG_THREADS, 0, st>>>(
      (const XT*)x, (const uint4*)w, (const float*)s, (const float*)b, (float*)y, O, I, group);
  return (int)cudaGetLastError();
}

template <int BITS, typename XT>
int launch(const void* x, const void* w, const void* s, const void* b, void* y, int O, int I,
           int group, int R, cudaStream_t st) {
  switch (R) {
    case 1: return launch_r<BITS, XT, 1>(x, w, s, b, y, O, I, group, st);
    case 2: return launch_r<BITS, XT, 2>(x, w, s, b, y, O, I, group, st);
    case 4: return launch_r<BITS, XT, 4>(x, w, s, b, y, O, I, group, st);
    case 8: return launch_r<BITS, XT, 8>(x, w, s, b, y, O, I, group, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y [O] f32 = x [I] (bf16 if x_bf16, else f32; 16-byte aligned) .
// dequant(w)^T. Needs bits 4 or 8, a group that holds whole 16-byte chunks
// (a multiple of 128 / bits) and divides I; ``rpw`` the rows a warp (1, 2,
// 4 or 8; 0: chosen from O). Returns cudaErrorInvalidValue otherwise.
extern "C" int qt_quant_gemv(int O, int I, int bits, int group, int x_bf16, const void* x,
                             const void* w, const void* s, const void* b, void* y, int rpw,
                             void* stream) {
  if ((bits != 4 && bits != 8) || group <= 0 || group % (128 / bits) || I % group || O <= 0 ||
      (rpw != 0 && rpw != 1 && rpw != 2 && rpw != 4 && rpw != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int R = rpw ? rpw : rows_per_warp(O);
  if (bits == 4)
    return x_bf16 ? launch<4, __nv_bfloat16>(x, w, s, b, y, O, I, group, R, st)
                  : launch<4, float>(x, w, s, b, y, O, I, group, R, st);
  return x_bf16 ? launch<8, __nv_bfloat16>(x, w, s, b, y, O, I, group, R, st)
                : launch<8, float>(x, w, s, b, y, O, I, group, R, st);
}
