// K4's function at M rows: y[M, O] = x[M, I] . dequant(W)^T in f32, for the
// packed matmuls of more than one row (the lockstep step, the code
// predictor's two-token first position, prefill), for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package sends these matmuls to XLA's
// quant_matmul (qwen3tts_tpu/ops/quant.py:75-86: dequantize to an f32 [O, I]
// matrix, then an f32 dot). K4 (quant_matmul.cu) takes one row. W is the
// same MLX affine layout: uint32 words [O, I/PW] (PW = 32/bits values a word,
// value j of word k is column k*PW + j at bit bits*j) with per-group f32
// scales and biases [O, I/group]. No [O, I] matrix is ever written.
//
// The TPU kernel's decomposition (_quant_matmul_kernel) carried to M rows:
//   y[m, o] = sum_g s[o, g] * T[m, o, g] + b[o, g] * XS[m, g],
// T the group's dot of the raw levels with x, XS the group's sum of x. The
// levels (0..15, 0..255) are exact in bf16, and so is their product with a
// bf16 x in f32, so mma.sync m16n8k16 (bf16 in, f32 sums) gives each
// group's T up to f32 summation order. The weights are the A operand (16
// output rows a tile), x^T the B operand (8 rows of x an n-tile); XS comes
// from the same B fragments against an A of ones. Each group starts fresh
// accumulators, which are then scaled into the output accumulator in f32.
// An f32 x (the heads' ``hidden.float()``) is split into three bf16 parts,
// hi + mid + lo, which sum to it exactly (8 significant bits each), and each
// part is multiplied: the products stay exact, so the f32 x keeps its
// precision.
//
// Within a 16-column k-step the columns are taken in another order, the
// same for A and B (the sum does not care): lane (g, c) of the mma holds
// columns 4c .. 4c + 3 of the step, so its x fragment is one 8-byte load
// (bf16) or one 16-byte load (f32), and its levels are half a word (int4)
// or one word (int8) of each of its two weight rows.
//
// Bound on the H100: at the lockstep's 2-64 rows, device-memory bandwidth
// on the packed words, scales and biases (int4 group 64: I/2 + 8 I/64 bytes
// a row), x and y; at thousands of rows (prefill) the tensor cores.
//
// Design: a block of 8 warps owns 16 MT output rows (MT = 1, 2 or 4 row
// tiles) and stages their packed words, scales and biases for the whole
// input width into shared memory once (cp.async), then walks its rows of x
// in chunks of 32 (four n-tiles) with the tile staged. The warps split as
// MT row tiles x 8/MT slices of the groups; the slices' partial sums meet in
// shared memory at the end of each chunk, summed in a fixed order
// (deterministic). A warp issues the x loads of four k-steps (two for an
// f32 x) before their mma: the first form of this kernel, one load a k-step
// in turn, left each load's L2 latency exposed (21.45 us at M = 64, 3072 x
// 1024, int4 bf16 x, chip_smoke phase y; NVIDIA H100 80GB HBM3, 700 W;
// PERF.md has this form's times). MT grows with M (fewer blocks read each x
// row), and past one chunk the rows of x are split over grid.y so that the
// grid covers the SMs; the blocks of one row tile then stage its weights
// once each, from the L2 after the first. One block a row tile walking all
// the rows with its tile staged once (``slices`` = 1, a grid of O / 64
// blocks at M = 256) is phase y's yardstick for that choice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device_state.cuh"
#include "mma.cuh"

namespace {

using qt::mma_bf16;
using qt::pack_bf16;

constexpr int QM_THREADS = 256;  // 8 warps
constexpr int QM_WARPS = QM_THREADS / 32;
constexpr int QM_NT = 4;                // n-tiles a chunk
constexpr int QM_CHUNK = 8 * QM_NT;     // rows of x a chunk
constexpr int QM_PAD = 4;               // words after each staged weight row (bank spread)
constexpr int QM_RED = QM_CHUNK + 1;    // floats a row of the partial sums (bank spread)
constexpr uint32_t QM_ONES = 0x3F803F80u;    // bf16x2 (1, 1)
constexpr uint32_t QM_128 = 0x43004300u;     // bf16x2 (128, 128)
constexpr uint32_t QM_M128 = 0xC300C300u;    // bf16x2 (-128, -128)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// bf16x2 (a - 128, c - 128) from bf16x2 (a, c), exactly (integers < 256)
__device__ __forceinline__ uint32_t minus_128(uint32_t p) {
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(y) : "r"(p), "r"(QM_ONES), "r"(QM_M128));
  return y;
}

// The four levels e0..e3 of a lane's columns in one weight row, as bf16x2
// (e0, e1) and (e2, e3). int4: half ``half`` of word ``u`` (16 bits, four
// nibbles), each nibble put under the exponent of 128 and 128 taken off;
// int8: the word's four bytes, widened through f32.
template <int BITS>
__device__ __forceinline__ void levels(uint32_t u, int half, uint32_t& p01, uint32_t& p23) {
  if (BITS == 4) {
    const uint32_t h = half ? u >> 16 : u & 0xFFFFu;
    p01 = minus_128(QM_128 | (h & 0xFu) | ((h & 0xF0u) << 12));
    p23 = minus_128(QM_128 | ((h >> 8) & 0xFu) | ((h & 0xF000u) << 4));
  } else {
    const float e0 = (float)(u & 0xFFu), e1 = (float)((u >> 8) & 0xFFu);
    const float e2 = (float)((u >> 16) & 0xFFu), e3 = (float)(u >> 24);
    p01 = pack_bf16(e0, e1);
    p23 = pack_bf16(e2, e3);
  }
}

__device__ __forceinline__ float lo_f(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

// A lane's B fragments of one n-tile and k-step: x[row][col .. col + 3]
// (b0 = columns 0, 1; b1 = columns 2, 3), loaded raw (``load``) and then
// made fragments (``parts``). bf16 x gives one part; f32 x three, hi + mid
// + lo = x exactly. KB: the k-steps whose loads are issued together.
template <typename XT>
struct XFrag;

template <>
struct XFrag<__nv_bfloat16> {
  static constexpr int PARTS = 1, KB = 4;
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p, bool ok) {
    return ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
  }
  __device__ __forceinline__ static void parts(Raw v, uint32_t (&b)[1][2]) {
    b[0][0] = v.x;
    b[0][1] = v.y;
  }
};

template <>
struct XFrag<float> {
  static constexpr int PARTS = 3, KB = 2;
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p, bool ok) {
    return ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static void parts(Raw f, uint32_t (&b)[3][2]) {
    float r[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const uint32_t a = pack_bf16(r[0], r[1]), c = pack_bf16(r[2], r[3]);
      b[part][0] = a;
      b[part][1] = c;
      r[0] -= lo_f(a), r[1] -= hi_f(a), r[2] -= lo_f(c), r[3] -= hi_f(c);
    }
  }
};

template <int BITS, typename XT, int MT>
__global__ void __launch_bounds__(QM_THREADS)
quant_gemm_kernel(const XT* __restrict__ x, const uint32_t* __restrict__ wq,
                  const float* __restrict__ scales, const float* __restrict__ biases,
                  float* __restrict__ y, int M, int O, int I, int group, int slice_rows) {
  constexpr int R = 16 * MT;          // output rows of a block
  constexpr int KS = QM_WARPS / MT;   // group slices
  constexpr int PARTS = XFrag<XT>::PARTS, KB = XFrag<XT>::KB;
  extern __shared__ uint4 qm_smem[];
  const int W = I / (32 / BITS), WS = W + QM_PAD, NG = I / group, S = group / 16;
  uint32_t* wt = reinterpret_cast<uint32_t*>(qm_smem);  // [R][WS]
  float* sc = reinterpret_cast<float*>(wt + R * WS);     // [R][NG]
  float* bi = sc + R * NG;                               // [R][NG]
  float* red = bi + R * NG;                              // [KS][R][QM_RED]

  const int o0 = blockIdx.x * R;
  // stage the block's rows (a row past O repeats the last; never written)
  const int c16 = W / 4;
  for (int i = threadIdx.x; i < R * c16; i += QM_THREADS) {
    const int r = i / c16, c = i - r * c16, o = min(o0 + r, O - 1);
    cp_async16(wt + r * WS + 4 * c, wq + (size_t)o * W + 4 * c);
  }
  for (int i = threadIdx.x; i < R * NG; i += QM_THREADS) {
    const int r = i / NG, gi = i - r * NG, o = min(o0 + r, O - 1);
    cp_async4(sc + i, scales + (size_t)o * NG + gi);
    cp_async4(bi + i, biases + (size_t)o * NG + gi);
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp / KS, ks = warp - mt * KS;
  const int gl = lane >> 2, c = lane & 3;
  const int r0 = 16 * mt + gl, r1 = r0 + 8;
  const uint32_t* w0 = wt + r0 * WS;
  const uint32_t* w1 = wt + r1 * WS;
  const uint32_t ones[4] = {QM_ONES, QM_ONES, QM_ONES, QM_ONES};
  const int m_lo = blockIdx.y * slice_rows, m_hi = min(M, m_lo + slice_rows);

  for (int m0 = m_lo; m0 < m_hi; m0 += QM_CHUNK) {
    float acc[QM_NT][4];
#pragma unroll
    for (int j = 0; j < QM_NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    for (int gi = ks; gi < NG; gi += KS) {
      float t[QM_NT][4], xs[QM_NT][4];
#pragma unroll
      for (int j = 0; j < QM_NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) t[j][i] = 0.f, xs[j][i] = 0.f;
      for (int s0 = 0; s0 < S; s0 += KB) {
        // this lane's x columns (col + 4c .. col + 4c + 3 of each k-step) of
        // KB k-steps, every load in flight before the first mma
        typename XFrag<XT>::Raw raw[KB][QM_NT];
#pragma unroll
        for (int u = 0; u < KB; ++u)
#pragma unroll
          for (int j = 0; j < QM_NT; ++j) {
            const int m = m0 + 8 * j + gl;
            raw[u][j] = XFrag<XT>::load(x + (size_t)m * I + gi * group + 16 * (s0 + u) + 4 * c,
                                        s0 + u < S && m < m_hi);
          }
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          if (s0 + u >= S) break;  // warp-uniform
          const int col = gi * group + 16 * (s0 + u);  // the k-step's first column
          const int word = BITS == 4 ? col / 8 + (c >> 1) : col / 4 + c;
          uint32_t a[4];
          levels<BITS>(w0[word], c & 1, a[0], a[2]);
          levels<BITS>(w1[word], c & 1, a[1], a[3]);
#pragma unroll
          for (int j = 0; j < QM_NT; ++j) {
            if (m0 + 8 * j >= m_hi) break;  // warp-uniform
            uint32_t b[PARTS][2];
            XFrag<XT>::parts(raw[u][j], b);
#pragma unroll
            for (int part = 0; part < PARTS; ++part) {
              mma_bf16(t[j], a, b[part][0], b[part][1]);
              mma_bf16(xs[j], ones, b[part][0], b[part][1]);
            }
          }
        }
      }
      const float s0 = sc[r0 * NG + gi], s1 = sc[r1 * NG + gi];
      const float b0 = bi[r0 * NG + gi], b1 = bi[r1 * NG + gi];
#pragma unroll
      for (int j = 0; j < QM_NT; ++j) {
        acc[j][0] = fmaf(s0, t[j][0], fmaf(b0, xs[j][0], acc[j][0]));
        acc[j][1] = fmaf(s0, t[j][1], fmaf(b0, xs[j][1], acc[j][1]));
        acc[j][2] = fmaf(s1, t[j][2], fmaf(b1, xs[j][2], acc[j][2]));
        acc[j][3] = fmaf(s1, t[j][3], fmaf(b1, xs[j][3], acc[j][3]));
      }
    }
    // the slices' partial sums meet in shared memory; C fragment (row gl,
    // columns 2c, 2c+1) and (row gl + 8, the same columns)
    float* mine = red + (ks * R) * QM_RED;
#pragma unroll
    for (int j = 0; j < QM_NT; ++j) {
      const int n = 8 * j + 2 * c;
      mine[r0 * QM_RED + n] = acc[j][0];
      mine[r0 * QM_RED + n + 1] = acc[j][1];
      mine[r1 * QM_RED + n] = acc[j][2];
      mine[r1 * QM_RED + n + 1] = acc[j][3];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * QM_CHUNK; i += QM_THREADS) {
      const int n = i / R, r = i - n * R, m = m0 + n, o = o0 + r;
      if (m < m_hi && o < O) {
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k) v += red[(k * R + r) * QM_RED + n];
        y[(size_t)m * O + o] = v;
      }
    }
    __syncthreads();
  }
}

// The current device's SM count and opt-in shared memory a block
// (device_state.cuh: one entry a device).
int num_sms() { return qt::device_attr<cudaDevAttrMultiProcessorCount>(132); }
size_t smem_optin() {
  return (size_t)qt::device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(48 * 1024);
}

size_t smem_bytes(int mt, int W, int NG) {
  const size_t R = 16 * mt;
  return 4 * (R * (W + QM_PAD) + 2 * R * NG + (size_t)QM_WARPS * 16 * QM_RED);
}

template <int BITS, typename XT, int MT>
int launch_mt(const void* x, const void* w, const void* s, const void* b, void* y, int M, int O,
              int I, int group, int slices, cudaStream_t st) {
  static std::atomic<size_t> allowed[qt::QT_MAX_DEVICES];
  auto* kern = quant_gemm_kernel<BITS, XT, MT>;
  const int W = I / (32 / BITS), NG = I / group;
  const size_t bytes = smem_bytes(MT, W, NG);
  const cudaError_t e = qt::allow_smem(kern, bytes, allowed);
  if (e != cudaSuccess) return (int)e;
  const int gx = (O + 16 * MT - 1) / (16 * MT), chunks = (M + QM_CHUNK - 1) / QM_CHUNK;
  if (slices <= 0) slices = max(1, min(chunks, (2 * num_sms() + gx - 1) / gx));
  slices = min(slices, chunks);
  const int slice_rows = (chunks + slices - 1) / slices * QM_CHUNK;
  const dim3 grid(gx, (M + slice_rows - 1) / slice_rows);
  kern<<<grid, QM_THREADS, bytes, st>>>((const XT*)x, (const uint32_t*)w, (const float*)s,
                                        (const float*)b, (float*)y, M, O, I, group, slice_rows);
  return (int)cudaGetLastError();
}

template <int BITS, typename XT>
int launch(const void* x, const void* w, const void* s, const void* b, void* y, int M, int O, int I,
           int group, int mt, int slices, cudaStream_t st) {
  switch (mt) {
    case 1: return launch_mt<BITS, XT, 1>(x, w, s, b, y, M, O, I, group, slices, st);
    case 2: return launch_mt<BITS, XT, 2>(x, w, s, b, y, M, O, I, group, slices, st);
    case 4: return launch_mt<BITS, XT, 4>(x, w, s, b, y, M, O, I, group, slices, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Row tiles (16 output rows each) a block at M rows of x: 1 up to one
// chunk, 2 up to 128 rows, else 4, the most whose staged tile fits the
// device's shared memory; 0 if not even one does.
extern "C" int qt_quant_gemm_tiles(int M, int I, int bits, int group) {
  if ((bits != 4 && bits != 8) || group <= 0 || I % group) return 0;
  const int W = I / (32 / bits), NG = I / group;
  int mt = M <= QM_CHUNK ? 1 : (M <= 128 ? 2 : 4);
  while (mt > 1 && smem_bytes(mt, W, NG) > smem_optin()) mt /= 2;
  return smem_bytes(mt, W, NG) <= smem_optin() ? mt : 0;
}

// y [M, O] f32 = x [M, I] (bf16 if x_bf16, else f32; 16-byte aligned,
// rows contiguous) . dequant(w)^T. Needs bits 4 or 8, a group that holds
// whole 16-byte chunks (a multiple of 128 / bits) and divides I, words a
// row a multiple of 4 and 16-byte aligned. ``mt``: row tiles a block (1, 2
// or 4; 0: qt_quant_gemm_tiles); ``slices``: blocks over the rows of x (0:
// enough to cover the SMs). Returns cudaErrorInvalidValue otherwise.
extern "C" int qt_quant_gemm(int M, int O, int I, int bits, int group, int x_bf16, const void* x,
                             const void* w, const void* s, const void* b, void* y, int mt,
                             int slices, void* stream) {
  if ((bits != 4 && bits != 8) || group <= 0 || group % (128 / bits) || I <= 0 || I % group ||
      (I / (32 / bits)) % 4 || O <= 0 || M <= 0 || slices < 0)
    return (int)cudaErrorInvalidValue;
  if (mt == 0) mt = qt_quant_gemm_tiles(M, I, bits, group);
  if (mt != 1 && mt != 2 && mt != 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bits == 4)
    return x_bf16 ? launch<4, __nv_bfloat16>(x, w, s, b, y, M, O, I, group, mt, slices, st)
                  : launch<4, float>(x, w, s, b, y, M, O, I, group, mt, slices, st);
  return x_bf16 ? launch<8, __nv_bfloat16>(x, w, s, b, y, M, O, I, group, mt, slices, st)
                : launch<8, float>(x, w, s, b, y, M, O, I, group, mt, slices, st);
}
