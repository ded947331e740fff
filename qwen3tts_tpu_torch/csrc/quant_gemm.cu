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
// group's T up to f32 summation order; the weights are the A operand (16
// output rows a tile), x^T the B operand (8 rows of x an n-tile), and each
// group starts fresh accumulators, then scaled into the output accumulator
// in f32. An f32 x (the heads' ``hidden.float()``) is split into three bf16
// parts, hi + mid + lo, which sum to it exactly (8 significant bits each),
// and each part is multiplied: the products stay exact, so the f32 x keeps
// its precision. Within a k-step the columns are taken in another order,
// the same for A and B (the sum does not care), so that a lane's levels and
// x are whole words of neighbouring columns.
//
// Bound on the H100: up to ~64 rows device-memory bandwidth on the packed
// words, scales and biases (int4 group 64: I/2 + 8 I/64 bytes a row), x and
// y (3072 x 1024 int4: 0.60 us at 2 rows, 0.86 at 64); from a few hundred
// rows the tensor cores (2 M O I operations, three times that for an f32
// x: 1.68 us at 256 rows, 26 at 4096). At a few rows a call is latency.
//
// Three forms, one launch a call, chosen in C (qt_quant_gemm_form) by M,
// the x type and the row's width:
//
// * Rows (one or two rows of a bf16 x; at int4 rows of at most 64 16-byte
//   chunks): K4's kernel carried to two x rows on the CUDA cores, each
//   weight value widened once and multiplied into both rows.
//
// * Stream (up to QG_CROSS_BF16 rows of a bf16 x, QG_CROSS_F32 of an f32
//   x): K4's design carried to the tensor cores. A block owns 16 output
//   rows; its warps split the input width into units of 16 S columns (S = 4
//   k-steps where the group holds 64 columns, else 2 or 1), two units a warp
//   (more where the width needs more than 16 warps or the grid more warps
//   than the SMs hold at once). Each lane takes, for its two weight rows,
//   the words of a quarter of each unit straight from device memory into
//   registers (the four lanes of a row read its unit's bytes side by side),
//   the rows' scales and biases, and its x row's matching columns (x sits in
//   L1 / L2), every load of the warp's units issued before any arithmetic:
//   one memory round trip a call. The bias term takes each lane's own sum
//   of its x columns, completed over the unit by two shuffles. The warps'
//   partial sums meet once in shared memory, summed in warp order. The grid
//   is O / 16 blocks; x rows past 8, 16 or 32 (n-tiles 1, 2 or 4) take
//   further passes, the weights then from L2.
//
// * Staged (more rows): a block of 8 warps owns 16 MT output rows (MT = 1,
//   2 or 4 row tiles) and stages their packed words, scales and biases for
//   the whole input width into shared memory once (cp.async), then walks its
//   rows of x in chunks of 32 (four n-tiles) with the tile staged. The warps
//   split as MT row tiles x 8/MT slices of the groups; the slices' partial
//   sums meet in shared memory at the end of each chunk, summed in a fixed
//   order. A warp issues the x loads of four k-steps (two for an f32 x)
//   before their mma. MT grows with M (fewer blocks read each x row), and
//   past one chunk the rows of x are split over grid.y so that the grid
//   covers the SMs; the blocks of one row tile then stage its weights once
//   each, from the L2 after the first (``slices`` = 1 keeps one block a row
//   tile walking all the rows). The loop is bound by its x traffic, not by
//   the tensor cores: for an f32 x its XS is summed on the CUDA cores (the
//   three parts made it three mma of ones a k-step) and its first x loads
//   go out before the staging is waited for; a bf16 x keeps XS as one mma
//   of ones a k-step, which measured faster than the CUDA-core sums.
//
// Sums are taken in a fixed order in every form (no atomics): a form gives
// the same bits from call to call, and the staged form at any ``slices``.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device_state.cuh"
#include "mma.cuh"


namespace {

using qt::mma_bf16;
using qt::pack_bf16;

// the most rows the stream form takes in the automatic choice, by x type
constexpr int QG_CROSS_BF16 = 64;
constexpr int QG_CROSS_F32 = 24;
constexpr int QS_MAX_WARPS = 16;  // warps a block of the stream form

constexpr uint32_t QM_ONES = 0x3F803F80u;    // bf16x2 (1, 1)
constexpr uint32_t QM_128 = 0x43004300u;     // bf16x2 (128, 128)
constexpr uint32_t QM_M128 = 0xC300C300u;    // bf16x2 (-128, -128)

// bf16x2 (a - 128, c - 128) from bf16x2 (a, c), exactly (integers < 256)
__device__ __forceinline__ uint32_t minus_128(uint32_t p) {
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(y) : "r"(p), "r"(QM_ONES), "r"(QM_M128));
  return y;
}

// The four levels e0..e3 of four neighbouring columns of one weight row, as
// bf16x2 (e0, e1) and (e2, e3). int4: half ``half`` of word ``u`` (16 bits,
// four nibbles), each nibble put under the exponent of 128 and 128 taken
// off; int8: the word's four bytes, widened through f32.
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

// Four f32 values as three bf16x2 pairs each, hi + mid + lo = the values
// exactly: b[part][0] = columns 0, 1, b[part][1] = columns 2, 3.
__device__ __forceinline__ void split3(float r0, float r1, float r2, float r3,
                                       uint32_t (&b)[3][2]) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const uint32_t a = pack_bf16(r0, r1), c = pack_bf16(r2, r3);
    b[part][0] = a;
    b[part][1] = c;
    r0 -= lo_f(a), r1 -= hi_f(a), r2 -= lo_f(c), r3 -= hi_f(c);
  }
}

// N words from p (16-byte aligned for N % 4 == 0, 8 for N == 2), or zeros
template <int N>
__device__ __forceinline__ void ld_words(const uint32_t* p, uint32_t (&v)[N], bool ok) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 u = ok ? __ldg(reinterpret_cast<const uint4*>(p) + i) : make_uint4(0, 0, 0, 0);
      v[4 * i] = u.x, v[4 * i + 1] = u.y, v[4 * i + 2] = u.z, v[4 * i + 3] = u.w;
    }
  } else if constexpr (N == 2) {
    const uint2 u = ok ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0, 0);
    v[0] = u.x, v[1] = u.y;
  } else {
    static_assert(N == 1, "1, 2 or a multiple of 4 words");
    v[0] = ok ? __ldg(p) : 0u;
  }
}

// ---------------------------------------------------------------- stream

// A lane's x columns of one unit (4 S of them) as words: bf16 2 S, f32 4 S.
template <typename XT, int S>
__host__ __device__ constexpr int x_words() {
  return sizeof(XT) == 2 ? 2 * S : 4 * S;
}

// Units a warp of the stream form holds in flight: 4 / NT, at most 2 for an
// f32 x, at least 1
template <typename XT, int NT>
__host__ __device__ constexpr int stream_batch() {
  return NT >= 4 ? 1 : (sizeof(XT) == 4 ? 2 : 4 / NT);
}

template <int BITS, int S, typename XT, int NT>
__global__ void __launch_bounds__(QS_MAX_WARPS * 32)
quant_gemm_stream(const XT* __restrict__ x, const uint32_t* __restrict__ wq,
                  const float* __restrict__ scales, const float* __restrict__ biases,
                  float* __restrict__ y, int M, int O, int I, int group, int upw) {
  constexpr int WL = S * BITS / 8;              // words a lane of a row a unit
  constexpr int COLS = 16 * S;                  // columns a unit
  constexpr int XW = x_words<XT, S>();
  constexpr bool F32 = sizeof(XT) == 4;
  constexpr int PARTS = F32 ? 3 : 1;
  constexpr int D = stream_batch<XT, NT>();     // units in flight a warp
  constexpr int N = 8 * NT;                     // x rows a pass
  constexpr int RED = N + 1;                    // floats a row of the partial sums
  extern __shared__ float qs_red[];             // [warps][16][RED]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int warps = blockDim.x >> 5;
  const int W = I / (32 / BITS), NG = I / group, upg = group / COLS;
  const int o0 = blockIdx.x * 16;
  const int u_lo = warp * upw, u_hi = min(I / COLS, u_lo + upw);
  // this lane's two weight rows (a row past O repeats the last; never written)
  const int oa = min(o0 + g, O - 1), ob = min(o0 + g + 8, O - 1);
  const uint32_t* wa = wq + (size_t)oa * W + WL * c;
  const uint32_t* wb = wq + (size_t)ob * W + WL * c;
  const float* sa = scales + (size_t)oa * NG;
  const float* sb = scales + (size_t)ob * NG;
  const float* ba = biases + (size_t)oa * NG;
  const float* bb = biases + (size_t)ob * NG;

  for (int m0 = 0; m0 < M; m0 += N) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    for (int u0 = u_lo; u0 < u_hi; u0 += D) {
      // every load of D units in flight before any arithmetic
      uint32_t wv[D][2][WL], xr[D][NT][XW];
      float sv[D][2], bv[D][2];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int u = u0 + d, gi = u / upg;
        const bool ok = u < u_hi;  // warp-uniform
        ld_words<WL>(wa + 4 * WL * u, wv[d][0], ok);
        ld_words<WL>(wb + 4 * WL * u, wv[d][1], ok);
        sv[d][0] = ok ? __ldg(sa + gi) : 0.f, sv[d][1] = ok ? __ldg(sb + gi) : 0.f;
        bv[d][0] = ok ? __ldg(ba + gi) : 0.f, bv[d][1] = ok ? __ldg(bb + gi) : 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int m = m0 + 8 * j + g;
          ld_words<XW>(reinterpret_cast<const uint32_t*>(x + (size_t)m * I + u * COLS + 4 * S * c),
                       xr[d][j], ok && m < M);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (u0 + d >= u_hi) break;  // warp-uniform
        // XS of the unit for the C columns 2c, 2c + 1 of each n-tile: this
        // lane's sum of its x row's columns, over the row's four lanes, then
        // fetched from the lanes of x rows 2c and 2c + 1
        float xs0[NT], xs1[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < XW; ++i)
            v += F32 ? __uint_as_float(xr[d][j][i]) : lo_f(xr[d][j][i]) + hi_f(xr[d][j][i]);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          xs0[j] = __shfl_sync(0xffffffffu, v, 8 * c);
          xs1[j] = __shfl_sync(0xffffffffu, v, 8 * c + 4);
        }
        float t[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) t[j][i] = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          uint32_t a[4];
          const int word = BITS == 4 ? s >> 1 : s, half = BITS == 4 ? s & 1 : 0;
          levels<BITS>(wv[d][0][word], half, a[0], a[2]);
          levels<BITS>(wv[d][1][word], half, a[1], a[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (m0 + 8 * j >= M) break;  // warp-uniform
            uint32_t b[PARTS][2];
            if constexpr (F32) {
              const uint32_t* r = xr[d][j] + 4 * s;
              split3(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                     __uint_as_float(r[3]), b);
            } else {
              b[0][0] = xr[d][j][2 * s];
              b[0][1] = xr[d][j][2 * s + 1];
            }
#pragma unroll
            for (int part = 0; part < PARTS; ++part) mma_bf16(t[j], a, b[part][0], b[part][1]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          acc[j][0] = fmaf(sv[d][0], t[j][0], fmaf(bv[d][0], xs0[j], acc[j][0]));
          acc[j][1] = fmaf(sv[d][0], t[j][1], fmaf(bv[d][0], xs1[j], acc[j][1]));
          acc[j][2] = fmaf(sv[d][1], t[j][2], fmaf(bv[d][1], xs0[j], acc[j][2]));
          acc[j][3] = fmaf(sv[d][1], t[j][3], fmaf(bv[d][1], xs1[j], acc[j][3]));
        }
      }
    }
    // the warps' partial sums meet in shared memory; C fragment (row g,
    // columns 2c, 2c+1) and (row g + 8, the same columns)
    float* mine = qs_red + warp * 16 * RED;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * c;
      mine[g * RED + n] = acc[j][0];
      mine[g * RED + n + 1] = acc[j][1];
      mine[(g + 8) * RED + n] = acc[j][2];
      mine[(g + 8) * RED + n + 1] = acc[j][3];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 16 * N; i += blockDim.x) {
      const int n = i >> 4, r = i & 15, m = m0 + n, o = o0 + r;
      if (m < M && o < O) {
        float v = 0.f;
        for (int k = 0; k < warps; ++k) v += qs_red[(k * 16 + r) * RED + n];
        y[(size_t)m * O + o] = v;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- rows

constexpr int QR_THREADS = 256;  // 8 warps
constexpr int QR_WARPS = QR_THREADS / 32;
constexpr int QR_MAX_CHUNKS = 64;  // int4 16-byte chunks a row the rows form takes by itself

// value j of a word, exactly, as f32 (through the bits of 2^23 + q)
template <int BITS>
__device__ __forceinline__ float qval(uint32_t u, int j) {
  if (BITS == 4) return __int_as_float(0x4B000000u | ((u >> (4 * j)) & 0xFu)) - 8388608.0f;
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)) - 8388608.0f;
}

// bf16 value i of a lane's x words, as f32
__device__ __forceinline__ float xval(const uint32_t* w, int i) {
  return i & 1 ? hi_f(w[i >> 1]) : lo_f(w[i >> 1]);
}

// K4 (quant_matmul.cu) carried to two rows of a bf16 x on the CUDA cores: a
// warp owns R consecutive output rows, its lanes take the rows' 16-byte
// chunks two at a time (c and c + 32, neighbouring lanes on neighbouring
// addresses), and before any arithmetic each lane has in flight their words,
// the rows' scales and biases, and both x rows' values of those columns;
// each weight value is widened once and multiplied into both x rows. The
// bias term takes each lane's own chunk sum of x; a warp sum a (row, x row)
// finishes it. Row groups strided over the grid's warps.
template <int BITS, int R>
__global__ void __launch_bounds__(QR_THREADS)
quant_gemm_rows(const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ wq,
                const float* __restrict__ scales, const float* __restrict__ biases,
                float* __restrict__ y, int M, int O, int I, int group) {
  constexpr int N = 128 / BITS;  // values a chunk
  constexpr int PW = 32 / BITS;  // values a word
  constexpr int XW = N / 2;      // x words a chunk and row
  const int W4 = I / N, NG = I / group, cpg = group / N, lane = threadIdx.x & 31;
  for (int rg = blockIdx.x * QR_WARPS + (threadIdx.x >> 5); rg * R < O;
       rg += gridDim.x * QR_WARPS) {
    const int o0 = rg * R;
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int c0 = lane; c0 < W4; c0 += 64) {
      uint4 wv[2][R];
      float sv[2][R], bv[2][R];
      uint32_t xr[2][2][XW];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = c0 + 32 * k;
        const bool ok = c < W4;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int o = min(o0 + r, O - 1);  // a row past O repeats the last, unwritten
          wv[k][r] = ok ? __ldg(wq + (size_t)o * W4 + c) : make_uint4(0, 0, 0, 0);
          sv[k][r] = ok ? __ldg(scales + (size_t)o * NG + c / cpg) : 0.f;
          bv[k][r] = ok ? __ldg(biases + (size_t)o * NG + c / cpg) : 0.f;
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ld_words<XW>(reinterpret_cast<const uint32_t*>(x + (size_t)m * I + (size_t)c * N),
                       xr[k][m], ok && m < M);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (c0 + 32 * k >= W4) break;
        float xs[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float v0 = 0.f, v1 = 0.f;
#pragma unroll
          for (int i = 0; i < N; i += 2) v0 += xval(xr[k][m], i), v1 += xval(xr[k][m], i + 1);
          xs[m] = v0 + v1;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t u[4] = {wv[k][r].x, wv[k][r].y, wv[k][r].z, wv[k][r].w};
          float d[2] = {0.f, 0.f};
#pragma unroll
          for (int w = 0; w < 4; ++w)
#pragma unroll
            for (int j = 0; j < PW; ++j) {
              const float q = qval<BITS>(u[w], j);
              d[0] = fmaf(q, xval(xr[k][0], w * PW + j), d[0]);
              d[1] = fmaf(q, xval(xr[k][1], w * PW + j), d[1]);
            }
#pragma unroll
          for (int m = 0; m < 2; ++m)
            acc[r][m] = fmaf(sv[k][r], d[m], fmaf(bv[k][r], xs[m], acc[r][m]));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float v = acc[r][m];
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) v += __shfl_xor_sync(0xffffffffu, v, sh);
        if (lane == 2 * r + m && o0 + r < O && m < M) y[(size_t)m * O + o0 + r] = v;
      }
  }
}

// ---------------------------------------------------------------- staged

constexpr int QM_THREADS = 256;  // 8 warps
constexpr int QM_WARPS = QM_THREADS / 32;
constexpr int QM_NT = 4;                // n-tiles a chunk
constexpr int QM_CHUNK = 8 * QM_NT;     // rows of x a chunk
constexpr int QM_PAD = 4;               // words after each staged weight row (bank spread)
constexpr int QM_RED = QM_CHUNK + 1;    // floats a row of the partial sums (bank spread)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// A lane's B fragments of one n-tile and k-step: x[row][col .. col + 3]
// (b0 = columns 0, 1; b1 = columns 2, 3), loaded raw (``load``) and then
// made fragments (``parts``); for an f32 x ``sum`` adds the four values.
// bf16 x gives one part; f32 x three, hi + mid + lo = x exactly. KB: the
// k-steps whose loads are issued together.
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
    split3(f.x, f.y, f.z, f.w, b);
  }
  __device__ __forceinline__ static float sum(Raw f) { return (f.x + f.y) + (f.z + f.w); }
};

template <int BITS, typename XT, int MT>
__global__ void __launch_bounds__(QM_THREADS)
quant_gemm_staged(const XT* __restrict__ x, const uint32_t* __restrict__ wq,
                  const float* __restrict__ scales, const float* __restrict__ biases,
                  float* __restrict__ y, int M, int O, int I, int group, int slice_rows) {
  constexpr int R = 16 * MT;          // output rows of a block
  constexpr int KS = QM_WARPS / MT;   // group slices
  constexpr int PARTS = XFrag<XT>::PARTS, KB = XFrag<XT>::KB;
  // an f32 x: XS on the CUDA cores, its first x loads issued before the
  // staging is waited for; a bf16 x: XS by one mma of ones a k-step and
  // n-tile on the tensor cores, whose pipe the loop leaves idle (both
  // measured the faster for their x, PERF.md)
  constexpr bool F32 = sizeof(XT) == 4;
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
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = warp / KS, ks = warp - mt * KS;
  const int gl = lane >> 2, c = lane & 3;
  const int r0 = 16 * mt + gl, r1 = r0 + 8;
  const uint32_t* w0 = wt + r0 * WS;
  const uint32_t* w1 = wt + r1 * WS;
  const uint32_t ones[4] = {QM_ONES, QM_ONES, QM_ONES, QM_ONES};
  const int m_lo = blockIdx.y * slice_rows, m_hi = min(M, m_lo + slice_rows);

  // this lane's x columns (col + 4c .. col + 4c + 3 of each k-step) of KB
  // k-steps, every load in flight before the first mma
  typename XFrag<XT>::Raw raw[KB][QM_NT];
  auto load_raw = [&](int m0, int gi, int s0) {
#pragma unroll
    for (int u = 0; u < KB; ++u)
#pragma unroll
      for (int j = 0; j < QM_NT; ++j) {
        const int m = m0 + 8 * j + gl;
        raw[u][j] = XFrag<XT>::load(x + (size_t)m * I + gi * group + 16 * (s0 + u) + 4 * c,
                                    gi < NG && s0 + u < S && m < m_hi);
      }
  };
  bool loaded = F32;
  if (F32) load_raw(m_lo, ks, 0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int m0 = m_lo; m0 < m_hi; m0 += QM_CHUNK) {
    float acc[QM_NT][4];
#pragma unroll
    for (int j = 0; j < QM_NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    for (int gi = ks; gi < NG; gi += KS) {
      // t: the group's level sums; xs: its x sums (f32 x: this lane's own)
      float t[QM_NT][4], xs[QM_NT][4];
#pragma unroll
      for (int j = 0; j < QM_NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) t[j][i] = 0.f, xs[j][i] = 0.f;
      for (int s0 = 0; s0 < S; s0 += KB) {
        if (!loaded) load_raw(m0, gi, s0);
        loaded = false;
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
            for (int part = 0; part < PARTS; ++part) mma_bf16(t[j], a, b[part][0], b[part][1]);
            if constexpr (F32)
              xs[j][0] += XFrag<XT>::sum(raw[u][j]);
            else
              mma_bf16(xs[j], ones, b[0][0], b[0][1]);
          }
        }
      }
      const float s0 = sc[r0 * NG + gi], s1 = sc[r1 * NG + gi];
      const float b0 = bi[r0 * NG + gi], b1 = bi[r1 * NG + gi];
#pragma unroll
      for (int j = 0; j < QM_NT; ++j) {
        if constexpr (F32) {  // the row's four lanes, then x rows 2c and 2c + 1's
          float v = xs[j][0];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          xs[j][0] = __shfl_sync(0xffffffffu, v, 8 * c);
          xs[j][1] = __shfl_sync(0xffffffffu, v, 8 * c + 4);
        }
        acc[j][0] = fmaf(s0, t[j][0], fmaf(b0, xs[j][0], acc[j][0]));
        acc[j][1] = fmaf(s0, t[j][1], fmaf(b0, xs[j][1], acc[j][1]));
        acc[j][2] = fmaf(s1, t[j][2], fmaf(b1, xs[j][0], acc[j][2]));
        acc[j][3] = fmaf(s1, t[j][3], fmaf(b1, xs[j][1], acc[j][3]));
      }
    }
    loaded = false;
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
size_t smem_optin() {
  return (size_t)qt::device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(48 * 1024);
}
int num_sms() { return qt::device_attr<cudaDevAttrMultiProcessorCount>(132); }

size_t staged_smem(int mt, int W, int NG) {
  const size_t R = 16 * mt;
  return 4 * (R * (W + QM_PAD) + 2 * R * NG + (size_t)QM_WARPS * 16 * QM_RED);
}

template <int BITS, typename XT, int MT>
int launch_staged_mt(const void* x, const void* w, const void* s, const void* b, void* y, int M,
                     int O, int I, int group, int slices, cudaStream_t st) {
  static std::atomic<size_t> allowed[qt::QT_MAX_DEVICES];
  auto* kern = quant_gemm_staged<BITS, XT, MT>;
  const int W = I / (32 / BITS), NG = I / group;
  const size_t bytes = staged_smem(MT, W, NG);
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
int launch_staged(const void* x, const void* w, const void* s, const void* b, void* y, int M,
                  int O, int I, int group, int mt, int slices, cudaStream_t st) {
  switch (mt) {
    case 1: return launch_staged_mt<BITS, XT, 1>(x, w, s, b, y, M, O, I, group, slices, st);
    case 2: return launch_staged_mt<BITS, XT, 2>(x, w, s, b, y, M, O, I, group, slices, st);
    case 4: return launch_staged_mt<BITS, XT, 4>(x, w, s, b, y, M, O, I, group, slices, st);
  }
  return (int)cudaErrorInvalidValue;
}

// k-steps a stream unit: 4 where 64 columns divide the group, else 2 (32
// columns; int4 groups always hold them), else 1 (int8, 16 columns)
int stream_steps(int group) {
  return group % 64 == 0 ? 4 : (group % 32 == 0 ? 2 : 1);
}

template <int BITS, int S, typename XT, int NT>
int launch_stream_nt(const void* x, const void* w, const void* s, const void* b, void* y, int M,
                     int O, int I, int group, cudaStream_t st) {
  static std::atomic<size_t> allowed[qt::QT_MAX_DEVICES];
  auto* kern = quant_gemm_stream<BITS, S, XT, NT>;
  const int units = I / (16 * S), blocks = (O + 15) / 16;
  // two units a warp (one where a batch holds one), more where the units
  // need more than QS_MAX_WARPS warps
  // or the grid more warps than the SMs hold at once (16 a SM), then as few
  // warps as cover the units
  int upw = stream_batch<XT, NT>() < 2 ? 1 : 2;
  while ((units + upw - 1) / upw > QS_MAX_WARPS ||
         (upw < units && blocks * ((units + upw - 1) / upw) > 16 * num_sms()))
    ++upw;
  const int warps = (units + upw - 1) / upw;
  const size_t bytes = sizeof(float) * warps * 16 * (8 * NT + 1);
  const cudaError_t e = qt::allow_smem(kern, bytes, allowed);
  if (e != cudaSuccess) return (int)e;
  kern<<<(O + 15) / 16, 32 * warps, bytes, st>>>((const XT*)x, (const uint32_t*)w,
                                                 (const float*)s, (const float*)b, (float*)y, M,
                                                 O, I, group, upw);
  return (int)cudaGetLastError();
}

template <int BITS, int S, typename XT>
int launch_stream_s(const void* x, const void* w, const void* s, const void* b, void* y, int M,
                    int O, int I, int group, cudaStream_t st) {
  if (M <= 8) return launch_stream_nt<BITS, S, XT, 1>(x, w, s, b, y, M, O, I, group, st);
  if (M <= 16) return launch_stream_nt<BITS, S, XT, 2>(x, w, s, b, y, M, O, I, group, st);
  return launch_stream_nt<BITS, S, XT, 4>(x, w, s, b, y, M, O, I, group, st);
}

template <typename XT>
int launch_stream(const void* x, const void* w, const void* s, const void* b, void* y, int M,
                  int O, int I, int bits, int group, cudaStream_t st) {
  const int S = stream_steps(group);
  if (bits == 4)
    return S == 4 ? launch_stream_s<4, 4, XT>(x, w, s, b, y, M, O, I, group, st)
                  : launch_stream_s<4, 2, XT>(x, w, s, b, y, M, O, I, group, st);
  switch (S) {
    case 4: return launch_stream_s<8, 4, XT>(x, w, s, b, y, M, O, I, group, st);
    case 2: return launch_stream_s<8, 2, XT>(x, w, s, b, y, M, O, I, group, st);
  }
  return launch_stream_s<8, 1, XT>(x, w, s, b, y, M, O, I, group, st);
}

// Rows a warp of the rows form: the fewest whose row groups fit one block
// of warps a SM (K4's rule), at most 4
int rows_per_warp(int O) {
  const int warps = num_sms() * QR_WARPS;
  int R = 1;
  while (R < 4 && (O + R - 1) / R > warps) R *= 2;
  return R;
}

template <int BITS, int R>
int launch_rows_r(const void* x, const void* w, const void* s, const void* b, void* y, int M,
                  int O, int I, int group, cudaStream_t st) {
  const int groups = (O + R - 1) / R;
  const int blocks = min((groups + QR_WARPS - 1) / QR_WARPS, num_sms() * 2);
  quant_gemm_rows<BITS, R><<<blocks, QR_THREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const uint4*)w, (const float*)s, (const float*)b, (float*)y, M,
      O, I, group);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_rows(const void* x, const void* w, const void* s, const void* b, void* y, int M,
                int O, int I, int group, cudaStream_t st) {
  switch (rows_per_warp(O)) {
    case 1: return launch_rows_r<BITS, 1>(x, w, s, b, y, M, O, I, group, st);
    case 2: return launch_rows_r<BITS, 2>(x, w, s, b, y, M, O, I, group, st);
  }
  return launch_rows_r<BITS, 4>(x, w, s, b, y, M, O, I, group, st);
}

bool shape_ok(int M, int O, int I, int bits, int group) {
  return (bits == 4 || bits == 8) && group > 0 && group % (128 / bits) == 0 && I > 0 &&
         I % group == 0 && (I / (32 / bits)) % 4 == 0 && O > 0 && M > 0;
}

}  // namespace

// The staged form's row tiles (16 output rows each) a block at M rows of x:
// 1 up to one chunk, 2 up to 128 rows, else 4, the most whose staged tile
// fits the device's shared memory; 0 if not even one does.
extern "C" int qt_quant_gemm_tiles(int M, int I, int bits, int group) {
  if ((bits != 4 && bits != 8) || group <= 0 || I % group) return 0;
  const int W = I / (32 / bits), NG = I / group;
  int mt = M <= QM_CHUNK ? 1 : (M <= 128 ? 2 : 4);
  while (mt > 1 && staged_smem(mt, W, NG) > smem_optin()) mt /= 2;
  return staged_smem(mt, W, NG) <= smem_optin() ? mt : 0;
}

// The form a call takes by default: 3 (rows) for one or two rows of a bf16 x
// (at int4 only where a weight row holds at most QR_MAX_CHUNKS 16-byte
// chunks: the stream form is the faster at the 0.6B down projection's 96),
// else 1
// (stream) up to QG_CROSS_BF16 / QG_CROSS_F32 rows or where the staged tile
// does not fit, else 2 (staged); 0 for a shape no form takes.
extern "C" int qt_quant_gemm_form(int M, int O, int I, int bits, int group, int x_bf16) {
  if (!shape_ok(M, O, I, bits, group)) return 0;
  if (x_bf16 && M <= 2 && (bits == 8 || I / 32 <= QR_MAX_CHUNKS)) return 3;
  if (M <= (x_bf16 ? QG_CROSS_BF16 : QG_CROSS_F32) || qt_quant_gemm_tiles(M, I, bits, group) == 0)
    return 1;
  return 2;
}

// y [M, O] f32 = x [M, I] (bf16 if x_bf16, else f32; 16-byte aligned,
// rows contiguous) . dequant(w)^T. Needs bits 4 or 8, a group that holds
// whole 16-byte chunks (a multiple of 128 / bits) and divides I, words a
// row a multiple of 4 and 16-byte aligned. ``form``: 1 stream, 2 staged, 3
// rows (a bf16 x of one or two rows), 0 qt_quant_gemm_form. The staged
// form's ``mt``: row tiles a block (1, 2 or 4; 0: qt_quant_gemm_tiles);
// ``slices``: blocks over the rows of x (0: enough to cover the SMs); the
// other forms take neither. Returns
// cudaErrorInvalidValue otherwise.
extern "C" int qt_quant_gemm(int M, int O, int I, int bits, int group, int x_bf16, const void* x,
                             const void* w, const void* s, const void* b, void* y, int form,
                             int mt, int slices, void* stream) {
  if (!shape_ok(M, O, I, bits, group) || slices < 0 || form < 0 || form > 3)
    return (int)cudaErrorInvalidValue;
  if (form == 0) form = qt_quant_gemm_form(M, O, I, bits, group, x_bf16);
  cudaStream_t st = (cudaStream_t)stream;
  if (form == 3) {
    if (mt != 0 || slices != 0 || M > 2 || !x_bf16) return (int)cudaErrorInvalidValue;
    return bits == 4 ? launch_rows<4>(x, w, s, b, y, M, O, I, group, st)
                     : launch_rows<8>(x, w, s, b, y, M, O, I, group, st);
  }
  if (form == 1) {
    if (mt != 0 || slices != 0) return (int)cudaErrorInvalidValue;
    return x_bf16 ? launch_stream<__nv_bfloat16>(x, w, s, b, y, M, O, I, bits, group, st)
                  : launch_stream<float>(x, w, s, b, y, M, O, I, bits, group, st);
  }
  if (mt == 0) mt = qt_quant_gemm_tiles(M, I, bits, group);
  if (mt != 1 && mt != 2 && mt != 4) return (int)cudaErrorInvalidValue;
  if (bits == 4)
    return x_bf16 ? launch_staged<4, __nv_bfloat16>(x, w, s, b, y, M, O, I, group, mt, slices, st)
                  : launch_staged<4, float>(x, w, s, b, y, M, O, I, group, mt, slices, st);
  return x_bf16 ? launch_staged<8, __nv_bfloat16>(x, w, s, b, y, M, O, I, group, mt, slices, st)
                : launch_staged<8, float>(x, w, s, b, y, M, O, I, group, mt, slices, st);
}
