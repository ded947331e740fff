// T4: two forms of a packed-int4 matvec, for Hopper (sm_90a).
//
// Replaces tools/exp_int4_repack.py's two Pallas kernels, the alternatives
// to K4 (csrc/quant_matmul.cu) that the script times beside it:
//
// * ``mxu_variant`` (kernel ``_mxu_kernel`` :48-69, pallas_call at :78):
//   y[o] = (sum_i bf16(x[i]) * q[o, i]) * scales[o, 0] + sum_g biases[o, g],
//   q the 4-bit values of the MLX words u32 [O, I/8] (value i of row o is
//   nibble i % 8 of word i / 8). One per-row scale, so not K4's function (the
//   script: "timing-faithful, numerics not"); this is the TPU kernel's
//   function, exactly.
// * ``plane_variant`` (kernel ``_plane_kernel`` :96-110, pallas_call at
//   :116): lo and hi u32 [O, I/16] nibble planes (nibble j of word w is
//   value 8w + j of the row's first half in lo, of its second half in hi),
//   y[o] = (sum_i q[o, i] * x[i]) * scales[o, 0] in f32, no bias.
//
// Bound on the H100: device-memory bandwidth, every input byte read once:
// the packed words (I/2 bytes a row), the scale column and, for mxu, the
// biases. At (I, O) = (1024, 3072) that is ~1.8 MB, ~0.5 us, against an
// empty kernel's ~1.7 us queued: a call is bound by its latency, one launch
// and one round trip to memory, so the designs issue every load of a warp
// before any arithmetic and keep the work after the loads short. A first
// form (one 8-row tile a CTA with x staged in shared memory and x padded to
// 16 rows of the mma, so 15/16 of each instruction was zero; the plane as
// one warp a row behind the same staging) took 5.8 us queued at (1024,
// 3072), where torch._weight_int4pack_mm took 2.6 us (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md, T4's row).
//
// mxu design. The weights are the A operand of mma.sync m16n8k16 (16 output
// rows an instruction) and x is B (7/8 of the instruction is wasted, not
// 15/16). ``mxu_repack`` (the script, once, when it builds its weights)
// stores each 16-row tile's words in fragment order: word [t, ch, lane, p]
// gives lane (g, c) = (lane / 4, lane % 4) its A fragment of k16 step p of
// chunk ch (values 64 ch .. 64 ch + 63): nibbles 0, 4, 2, 6 are row 16t +
// g's values 64 ch + 16 c + 4 p + 0, 1, 2, 3 and nibbles 1, 5, 3, 7 row 16t +
// g + 8's. So one 16-byte load gives a lane its fragment for four k16 steps
// and a warp reads 512 contiguous bytes, with no shared memory. A nibble
// becomes bf16 with no integer-to-float instruction: (w >> (4j - 3)) &
// 0x00780078 | 0x41804180 puts nibbles j and j + 4 into the top four
// mantissa bits of two bf16 16, i.e. the values 16 + q exactly (a shift and
// one lop3 a register); the epilogue takes 16 * sum(bf16(x)) away. (128 + q,
// the low mantissa bits, costs the same but puts 8x more offset than signal
// into the tensor cores' f32 sums; 16 + q keeps the error far under the
// 1e-4 bound.) A block owns a tile and its warps split the chunks, CH (2) in
// flight each. Each warp loads the x of its chunks as one coalesced float4 a
// lane, rounds it to bf16 pairs, and lanes take B by shuffle (every column of
// B gets x; only column 0 of C is read), so x costs one load instruction a
// pass, not sixteen on four lanes. Each warp applies its rows' scales and
// its share of their bias sums (the four lanes of a quad split the bias
// columns) before the one meeting in shared memory, where 16 threads sum the
// warps in warp order. The grid is sized to the SMs (at most four blocks an
// SM), tiles strided across it; a block has up to 32 warps, so at I = 3072
// (48 chunks) every chunk is in flight in one pass.
//
// plane design: K4's (csrc/quant_matmul.cu). A warp owns R consecutive
// rows; each row is the chunk sequence lo ++ hi (16-byte chunks; chunk c
// holds the values 32c .. 32c + 31 in MLX order in both planes, since I/2 =
// 32 (I/64)); a lane takes chunks c and c + 32 of every row, issuing its x
// values of those columns (L1/L2, in registers), the R x 2 chunks and its
// row's scale before any arithmetic. Values are widened through the bits of
// 2^23 + q (a lop3 and a subtract), one warp sum a row at the end. R (1, 2,
// 4 or 8) is K4's: the fewest rows a warp whose row groups fit one block of
// 8 warps a SM. The grid covers every SM: one block a SM, or up to two when
// the row groups fill more, and the row groups are dealt to the blocks in
// turn (group g to block g % blocks), so fewer groups than 8 a SM still
// reach all of them. (All of a row's chunks in one pass, three at I = 3072,
// was slower: each lane reads its own 128-byte line of x an instruction, and
// a weight byte costs 8 / R bytes of x from L1.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_state.cuh"
#include "mma.cuh"
#include "reduce.cuh"

namespace {

using qt::mma_bf16;
using qt::warp_sum;

constexpr int MX_CHUNK = 64;      // values of a k-chunk: four k16 steps, 16 bytes a lane
constexpr int MX_CH = 2;          // chunks a warp keeps in flight
constexpr int MX_MAX_WARPS = 32;  // warps of a block (one tile), splitting the chunks
constexpr int MX_XV = 16 * MX_CH / 32;  // float4 of x a lane loads a pass
constexpr int MX_BLOCKS_PER_SM = 4;
constexpr int PL_THREADS = 256;   // plane: 8 warps, R rows each
constexpr int PL_WARPS = PL_THREADS / 32;
constexpr int PL_BLOCKS_PER_SM = 2;

int num_sms() { return qt::device_attr<cudaDevAttrMultiProcessorCount>(132); }

// bf16 pair (16 + nibble j, 16 + nibble j + 4) of a fragment word, low half first
template <int J>
__device__ __forceinline__ uint32_t nib_pair(uint32_t w) {
  uint32_t s;
  if constexpr (J == 0) s = w << 3;
  else s = w >> (4 * J - 3);
  return (s & 0x00780078u) | 0x41804180u;
}

__device__ __forceinline__ uint32_t to_bf16x2(float lo, float hi) {
  return qt::pack_bf16(lo, hi);
}

// the two bf16 of a pair as f32, summed
__device__ __forceinline__ float pair_sum(uint32_t p) {
  return __uint_as_float(p << 16) + __uint_as_float(p & 0xFFFF0000u);
}

// at MX_CH chunks a warp a thread takes at most 64 registers, so 32 warps
// (1024 threads) fit an SM
__global__ void __launch_bounds__(32 * MX_MAX_WARPS)
int4_mxu_kernel(const float* __restrict__ x, const uint4* __restrict__ frag,
                const float* __restrict__ scales, const float* __restrict__ biases,
                float* __restrict__ y, int O, int I, int NG, int tiles) {
  constexpr int CH = MX_CH, XV = MX_XV;
  __shared__ float red[MX_MAX_WARPS][16];  // [warp][row of the tile]: its share of y
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, c = lane & 3, NC = I / MX_CHUNK;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = 16 * t + g, r1 = r0 + 8;
    float acc[CH][4] = {}, xs = 0.f, b0 = 0.f, b1 = 0.f, s0 = 0.f, s1 = 0.f;
    for (int base = warp * CH; base < NC; base += nw * CH) {
      uint4 wv[CH];
      float4 xq[XV];
#pragma unroll
      for (int j = 0; j < CH; ++j)  // every load of the pass first
        wv[j] = base + j < NC ? __ldg(frag + ((size_t)t * NC + base + j) * 32 + lane)
                              : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < XV; ++i) {  // the pass's x, one coalesced float4 a lane
        const int q = lane + 32 * i;  // float4 q of the pass is in chunk base + q / 16
        xq[i] = q < 16 * CH && base + q / 16 < NC ? __ldg(x4 + 16 * base + q)
                                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (base == warp * CH) {  // this warp's share of the bias columns, and the scales
        for (int k = 4 * warp + c; k < NG; k += 4 * nw) {
          if (r0 < O) b0 += __ldg(biases + (size_t)r0 * NG + k);
          if (r1 < O) b1 += __ldg(biases + (size_t)r1 * NG + k);
        }
        if (c == 0) {
          if (r0 < O) s0 = __ldg(scales + (size_t)r0 * NG);
          if (r1 < O) s1 = __ldg(scales + (size_t)r1 * NG);
        }
      }
      uint32_t hb[XV][2];  // x as bf16 pairs, and the sum of those this lane holds
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        hb[i][0] = to_bf16x2(xq[i].x, xq[i].y);
        hb[i][1] = to_bf16x2(xq[i].z, xq[i].w);
        xs += pair_sum(hb[i][0]) + pair_sum(hb[i][1]);
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {  // a chain of mma a chunk slot
        const uint32_t words[4] = {wv[j].x, wv[j].y, wv[j].z, wv[j].w};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          // B: x[64 ch + 16 c + 4 p .. + 3], float4 16 j + 4 c + p of the pass (column
          // g of B gets the same x: its C columns are not read)
          const int src = 16 * (j & 1) + 4 * c + p;
          const uint32_t xb0 = __shfl_sync(0xffffffffu, hb[j / 2][0], src);
          const uint32_t xb1 = __shfl_sync(0xffffffffu, hb[j / 2][1], src);
          const uint32_t w = words[p];
          const uint32_t a[4] = {nib_pair<0>(w), nib_pair<1>(w), nib_pair<2>(w), nib_pair<3>(w)};
          mma_bf16(acc[j], a, xb0, xb1);
        }
      }
    }
    // sum(bf16(x)) over this warp's chunks; the bias partials over each quad;
    // then this warp's share of each row's y
    xs = warp_sum(xs);
    b0 += __shfl_xor_sync(0xffffffffu, b0, 1);
    b0 += __shfl_xor_sync(0xffffffffu, b0, 2);
    b1 += __shfl_xor_sync(0xffffffffu, b1, 1);
    b1 += __shfl_xor_sync(0xffffffffu, b1, 2);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) d0 += acc[j][0], d1 += acc[j][2];  // column 0 of C: rows g, g + 8
    if (c == 0) {
      red[warp][g] = fmaf(fmaf(-16.f, xs, d0), s0, b0);
      red[warp][g + 8] = fmaf(fmaf(-16.f, xs, d1), s1, b1);
    }
    __syncthreads();
    if (threadIdx.x < 16) {  // the warps' shares in warp order
      float v = 0.f;
      for (int w = 0; w < nw; ++w) v += red[w][threadIdx.x];
      if (16 * t + threadIdx.x < O) y[16 * t + threadIdx.x] = v;
    }
    if (t + (int)gridDim.x < tiles) __syncthreads();  // red is taken again
  }
}

// acc += q . x over one 16-byte chunk (32 values; x[k * 8 + j] is word k's nibble j)
__device__ __forceinline__ float chunk_dot(const uint4& w, const float (&x)[32], float acc) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float q = __int_as_float(0x4B000000u | ((u[k] >> (4 * j)) & 0xFu)) - 8388608.0f;
      if (k & 1) d1 = fmaf(q, x[k * 8 + j], d1);
      else d0 = fmaf(q, x[k * 8 + j], d0);
    }
  return acc + (d0 + d1);
}

__device__ __forceinline__ void load_x32(const float* x, int c, float (&v)[32]) {
  const float4* p = reinterpret_cast<const float4*>(x + (size_t)c * 32);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 f = __ldg(p + i);
    v[4 * i] = f.x, v[4 * i + 1] = f.y, v[4 * i + 2] = f.z, v[4 * i + 3] = f.w;
  }
}

template <int R>
__global__ void __launch_bounds__(PL_THREADS)
int4_plane_kernel(const float* __restrict__ x, const uint4* __restrict__ lo,
                  const uint4* __restrict__ hi, const float* __restrict__ scales,
                  float* __restrict__ y, int O, int I, int NG) {
  const int HC = I / 64, W4 = 2 * HC, lane = threadIdx.x & 31;  // chunks a plane row, a row
  for (int rg = (threadIdx.x >> 5) * gridDim.x + blockIdx.x; rg * R < O;
       rg += gridDim.x * PL_WARPS) {
    const int o0 = rg * R;
    const float s = lane < R && o0 + lane < O ? __ldg(scales + (size_t)(o0 + lane) * NG) : 0.f;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int c = lane; c < W4; c += 64) {  // chunks c and c + 32 of every row
      const bool two = c + 32 < W4;
      float xa[32], xb[32];
      uint4 wa[R], wb[R];
      load_x32(x, c, xa);
      if (two) load_x32(x, c + 32, xb);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // a row past O repeats the last, unwritten
        const size_t row = (size_t)min(o0 + r, O - 1) * HC;
        wa[r] = __ldg(c < HC ? lo + row + c : hi + row + c - HC);
        if (two) wb[r] = __ldg(c + 32 < HC ? lo + row + c + 32 : hi + row + c + 32 - HC);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = chunk_dot(wa[r], xa, acc[r]);
      if (two) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = chunk_dot(wb[r], xb, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = warp_sum(acc[r]);
      if (lane == r && o0 + r < O) y[o0 + r] = v * s;
    }
  }
}

// Rows a plane warp: the fewest of 1, 2, 4, 8 whose row groups fit one block
// of PL_WARPS warps a SM (K4's rule: on an H100 1 at O = 1024, 2 at 2048, 4 at
// 3072, 8 at 6144).
int plane_rows_per_warp(int O) {
  const int warps = num_sms() * PL_WARPS;
  int R = 1;
  while (R < 8 && (O + R - 1) / R > warps) R *= 2;
  return R;
}

// one block a SM, more up to PL_BLOCKS_PER_SM when the row groups fill them,
// never more blocks than row groups
template <int R>
int launch_plane(const float* x, const uint4* lo, const uint4* hi, const float* s, float* y,
                 int O, int I, int NG, cudaStream_t st) {
  const int groups = (O + R - 1) / R, sms = num_sms();
  const int blocks =
      min(groups, min(max(sms, (groups + PL_WARPS - 1) / PL_WARPS), sms * PL_BLOCKS_PER_SM));
  int4_plane_kernel<R><<<blocks, PL_THREADS, 0, st>>>(x, lo, hi, s, y, O, I, NG);
  return (int)cudaGetLastError();
}

int launch_mxu(int O, int I, int NG, const void* x, const void* frag, const void* s,
               const void* b, void* y, cudaStream_t st) {
  const int tiles = (O + 15) / 16, NC = I / MX_CHUNK;
  const int nw = min(MX_MAX_WARPS, (NC + MX_CH - 1) / MX_CH);
  const int blocks = min(tiles, num_sms() * MX_BLOCKS_PER_SM);
  int4_mxu_kernel<<<blocks, 32 * nw, 0, st>>>((const float*)x, (const uint4*)frag,
                                              (const float*)s, (const float*)b, (float*)y, O, I,
                                              NG, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// y [O] f32 = mxu_variant(x [I] f32 16-byte aligned, frag: the fragment-
// order words of mxu_repack, u32 [ceil(O/16), I/64, 32, 4], 16-byte aligned,
// scales and biases f32 [O, NG]). Needs I % 64 == 0.
extern "C" int qt_int4_mxu(int O, int I, int NG, const void* x, const void* frag,
                           const void* scales, const void* biases, void* y, void* stream) {
  if (O <= 0 || I <= 0 || I % MX_CHUNK || NG <= 0 || !x || !frag || !scales || !biases || !y ||
      (((uintptr_t)frag | (uintptr_t)x) & 15))
    return (int)cudaErrorInvalidValue;
  return launch_mxu(O, I, NG, x, frag, scales, biases, y, (cudaStream_t)stream);
}

// y [O] f32 = plane_variant(x [I] f32, lo and hi u32 [O, I/16], scales f32
// [O, NG]); x, lo and hi 16-byte aligned; R rows a warp by
// plane_rows_per_warp. Needs I % 64 == 0.
extern "C" int qt_int4_plane(int O, int I, int NG, const void* x, const void* lo, const void* hi,
                             const void* scales, void* y, void* stream) {
  if (O <= 0 || I <= 0 || I % 64 || NG <= 0 || !x || !lo || !hi || !scales || !y ||
      (((uintptr_t)lo | (uintptr_t)hi | (uintptr_t)x) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const uint4 *l = (const uint4*)lo, *h = (const uint4*)hi;
  const float* s = (const float*)scales;
  float* yf = (float*)y;
  switch (plane_rows_per_warp(O)) {
    case 1: return launch_plane<1>(xf, l, h, s, yf, O, I, NG, st);
    case 2: return launch_plane<2>(xf, l, h, s, yf, O, I, NG, st);
    case 4: return launch_plane<4>(xf, l, h, s, yf, O, I, NG, st);
    default: return launch_plane<8>(xf, l, h, s, yf, O, I, NG, st);
  }
}
