// Building blocks shared by the two decode kernels (talker_step.cu: K1,
// cp_loop.cu: K2). Each has a plain PyTorch twin in
// qwen3tts_tpu_torch/ops/decode_blocks.py with the same rounding points.
//
// Every kernel here takes a batch of B rows (1 <= B <= MAX_BATCH), head_dim
// 128 and bf16 activations, and is launched on the caller's stream by the
// host loops of the two .cu files. Row b's activations sit at b * width.
// The batched GEMVs take the batch in groups of up to BG_GROUP rows, one
// group a grid row (blockIdx.z): a block's registers and staged x are
// sized for one group, and each group's blocks stage their own copy of the
// weight tile (B = 256: the weights read 4 times a GEMV, the later reads
// mostly from the L2). At B <= BG_GROUP the grid has one group and the
// blocks run as they did when the batch stopped there.
//
// The weight GEMV is the bound. Its weights are int8 (weight-only int8: the
// finishing kernels multiply the f32 sum by a per-channel f32 scale) or
// dense bf16 (no scale: the wrappers pass none and the sum is taken as it
// is, the same f32 bits as a unit scale; its one rounding, f32 to bf16,
// comes after the split sum, as the TPU kernel's bf16 mode does). At B=1
// the GEMV is device-memory bandwidth on the weights (every byte is used
// once per token): ``gemv_partial`` reads 16 bytes per thread (16 int8 or 8
// bf16 weights) with neighbouring threads on neighbouring columns and splits
// the reduction dimension across blocks to put ~2 blocks on every SM. At
// B>1 the same weight stream serves every row: the batched GEMV
// (``gemv_batched``) stages each block's weight tile in shared memory once,
// from device memory, and multiplies it into all B rows from there, with
// the rows tiled 8 at a time so the accumulators stay in registers. Its
// arithmetic (2 x B flops per weight, f32 FMA on the CUDA cores) overtakes
// the memory time near B = 8 for int8 (B = 16 for bf16, which moves twice
// the bytes); at B = 64 a 0.6B talker step is ~57 GFLOP, ~0.85 ms of FMA at
// the card's f32 peak against a ~0.13 ms memory floor. The tensor-core form
// (``gemv_batched_mma``, ``gemv_batched_dq_mma``: mma.sync, csrc/mma.cuh)
// stages the same tiles and runs the products on the tensor cores; ``gemv``
// takes it at every B > 1 (K1, K2's loop and T6's ablated step). Only
// ``qt_cp_gemv`` with tc = 0 reaches the CUDA-core form (``gemv_batched``,
// ``gemv_batched_dq``): the tests and tools/time_k3_k2.py hold the two forms
// against each other. K2 at B = 1 runs its own persistent frame
// (cp_loop.cu) on these building blocks' arithmetic.
//
// dyn_int8 (the TPU kernels' ``dyn_int8`` mode, int8 weights only): each
// activation row x is quantized with its own scale s = max(amax(|x|) *
// f32(1/127), 1e-12), xq = round_half_even(x / s) (an IEEE divide), and the
// GEMV sums xq[k] * W[k, o] exactly in int32 with ``__dp4a`` (4 multiply-adds
// per instruction, no widening of the weights): ``gemv_partial_dq`` at B=1,
// ``gemv_batched_dq`` at B>1. Their split partials are int32 too and the
// finishing kernels sum them in int32 before the one conversion to f32, as a
// 6144-deep row reaches 6144 x 127 x 127 > 2^24. The finishing kernels then
// scale: f32(acc) * (s * scale[o]) (layers, rounded to bf16, and the talker's
// codec head), or (f32(acc) * s) * scale[o] (the code predictor's heads).
// W is [K, O] row-major, so the 4 K-consecutive weights of one dp4a word lie
// O bytes apart: a thread loads 16 columns of 4 rows (4 x 16 bytes) and
// transposes them with byte permutes into 16 words.
//
// Where s comes from: the kernel that writes the activation row also writes
// its amax (``amax`` slots, [3][B] f32: the normed input, the attention
// output, the SwiGLU output), so no launch is added, not even a memset. The
// row-owning kernels (``rms_copy``, ``finish_residual_norm``: one block per
// row) write slot 0 and clear the row's slots 1 and 2; the attention (a
// block per kv head) and SwiGLU (a block per 256 columns) take an
// ``atomicMax`` over the float bits (amax >= 0) into slot 1 or 2, which the
// next row-owning kernel reads and clears. A GEMV quantizes x while staging
// it (each block its own rows); the finishing kernel recomputes s from the
// same amax. The first kernel of a call is row-owning, so the slots need no
// initial value.
//
// Unfused weights (the code predictor's q/k/v and gate/up as separate
// matrices) are a ``Mat`` of up to three column segments written side by
// side, so one GEMV launch and the same finishing kernels serve them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "device_state.cuh"
#include "mma.cuh"
#include "reduce.cuh"

typedef __nv_bfloat16 bf16;

// Operations (kernel launches and memsets) enqueued through QT_CHECK_LAUNCH
// since the library was loaded, counted on the host (qt_launches in
// talker_step.cu). Every operation of K1 (qt_talker_step) and K2
// (qt_cp_loop) is followed by exactly one QT_CHECK_LAUNCH, so the count's
// growth over a call is that call's launches, exactly. Host threads of a
// data-parallel mesh launch at once, so the count is atomic.
namespace qt {
inline std::atomic<unsigned long long>& launch_count() {
  static std::atomic<unsigned long long> n{0};  // one instance across the library (inline, external linkage)
  return n;
}
}  // namespace qt

// After each enqueued operation: count it and return its launch error.
#define QT_CHECK_LAUNCH()                                                 \
  do {                                                                    \
    ::qt::launch_count().fetch_add(1, std::memory_order_relaxed);         \
    cudaError_t e_ = cudaGetLastError();                                  \
    if (e_ != cudaSuccess) return (int)e_;                                \
  } while (0)

// Everything sits in an unnamed namespace: both .cu files include this
// header and each gets its own internal copy (no duplicate kernel symbols).
namespace qt {
namespace {

constexpr int HEAD_DIM = 128;
constexpr int MAX_BATCH = 256;             // rows of one K1 / K2 call
constexpr int BG_GROUP = 64;                // batched GEMV: batch rows of one block (grid z: the groups)
constexpr int GEMV_THREADS = 256;           // 8 warps split the rows
constexpr int GEMV_MAX_SPLIT = 64;          // B=1: at most 64 splits
constexpr int GEMV_MAX_PARTS = 512;         // B>1: splits x B <= 512 (the workspace holds 512 x O floats)
constexpr int TC_MAX_PARTS = 1024;          // B>1 on the tensor cores: splits x B <= 1024
constexpr int BG_COLS = 128;                // batched GEMV: columns per block, 16 groups of 8
constexpr int BG_ROWS = 128;                // batched GEMV: weight rows staged per pass
constexpr int BG_XS = BG_ROWS + 2;          // x row stride in shared memory (odd words: no conflicts)
constexpr int BG_SMEM = 64 * 1024;          // batched GEMV: dynamic shared memory per block
constexpr int BGQ_XS = BG_ROWS / 4 + 1;     // dyn_int8: x row stride in words of 4 int8
constexpr int TC_WS = BG_COLS + 8;          // tensor-core GEMV: bf16 tile row stride (272 B)
constexpr int TC_XS = BG_ROWS + 8;          // tensor-core GEMV: bf16 x row stride (272 B)
constexpr int TCQ_WS = BG_COLS + 8;         // dyn_int8 tensor-core GEMV: tile row stride, words
constexpr int TCQ_XS = BG_ROWS / 4 + 4;     // dyn_int8 tensor-core GEMV: x row stride, words
constexpr int AMAX_SLOTS = 3;               // dyn_int8: amax of the normed input, attention, SwiGLU
constexpr int MAX_SEGS = 3;                 // column segments of one unfused weight
constexpr int SAMPLE_THREADS = 1024;
constexpr int SAMPLE_PER_THREAD = 4;        // vocabularies up to 4096
constexpr int SAMPLE_ROW_VALUES = 5;        // per-row sampling: rep, greedy, inv_t, top_k, top_p_thr
constexpr float NEG_BIG = -1e30f;

// the staged tile of the wider weight type (bf16) and x
static_assert(BG_ROWS * BG_COLS * 2 + BG_GROUP * BG_XS * 2 <= BG_SMEM, "batched GEMV staging");
static_assert(BG_ROWS * BG_COLS + BG_GROUP * BGQ_XS * 4 <= BG_SMEM, "dyn_int8 GEMV staging");
static_assert(16 * 8 * BG_COLS * 4 <= BG_SMEM, "batched GEMV reduction");
static_assert(BG_ROWS * TC_WS * 2 + BG_GROUP * TC_XS * 2 <= BG_SMEM, "tensor-core GEMV staging");
static_assert(BG_ROWS / 4 * TCQ_WS * 4 + BG_GROUP * TCQ_XS * 4 <= BG_SMEM,
              "dyn_int8 tensor-core GEMV staging");
static_assert(BG_GROUP == 8 * 8, "a batched GEMV thread's accumulators: 8 tiles of 8 rows");
static_assert(MAX_BATCH % BG_GROUP == 0 && TC_MAX_PARTS >= MAX_BATCH, "batched GEMV groups");

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
// round an f32 value to bf16 and back (a bf16 "store" kept in a register)
__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// dyn_int8: a row's activation scale from its amax, and one quantized value
// (f32 multiply by the f32 constant, IEEE divide, round half to even)
__device__ __forceinline__ float act_scale(float amax) {
  return fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-12f);
}
__device__ __forceinline__ uint32_t quant_act(float x, float s) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fdiv_rn(x, s));
}
// 4 consecutive activations quantized into one dp4a word (x[0] in byte 0)
__device__ __forceinline__ int pack4(const bf16* x, float s) {
  return (int)(quant_act(bf(x[0]), s) | quant_act(bf(x[1]), s) << 8 |
               quant_act(bf(x[2]), s) << 16 | quant_act(bf(x[3]), s) << 24);
}
// quant_act with a multiply where the divide cannot change the result:
// with r = 1/s rounded, y = x * r lies within 3 x 2^-24 |x / s| of the
// correctly rounded quotient, so where y is further than 2.4e-7 |y| from
// the nearest half-integer both round to the same integer; nearer (ties
// included) the divide decides. Bit-equal to quant_act.
__device__ __forceinline__ uint32_t quant_act_r(float x, float s, float r) {
  const float y = __fmul_rn(x, r);
  const float k = rintf(y);
  if (fabsf(fabsf(y - k) - 0.5f) > 2.4e-7f * fabsf(y)) return (uint32_t)(uint8_t)(int8_t)(int)k;
  return quant_act(x, s);
}
__device__ __forceinline__ int pack4_r(const bf16* x, float s, float r) {
  return (int)(quant_act_r(bf(x[0]), s, r) | quant_act_r(bf(x[1]), s, r) << 8 |
               quant_act_r(bf(x[2]), s, r) << 16 | quant_act_r(bf(x[3]), s, r) << 24);
}
// max into a slot of non-negative floats (their bits order as ints)
__device__ __forceinline__ void atomic_amax(float* slot, float v) {
  atomicMax(reinterpret_cast<int*>(slot), __float_as_int(v));
}

// Block-wide reductions; every thread gets the result. red: 32 floats of
// shared memory. blockDim.x must be a multiple of 32.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  return warp_sum(lane < nw ? red[lane] : 0.f);
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  return warp_max(lane < nw ? red[lane] : 0.f);
}

// A weight operand [I, O]: int8 with f32 per-column scales, or dense bf16
// (``wbf16``, no scales), in up to MAX_SEGS column segments: segment i holds
// output columns [end[i-1], end[i]) as its own row-major matrix of that
// width with its own scales (unfused q/k/v, gate/up). A fused weight is one
// segment. Segment widths are multiples of 16, so the columns of one
// 16-byte load lie in one segment.
struct Mat {
  const void* w[MAX_SEGS];
  const float* s[MAX_SEGS];
  int end[MAX_SEGS];
  int n;
  bool wbf16;
};

__host__ __device__ inline Mat mat(bool wbf16) {
  Mat m = {};
  m.wbf16 = wbf16;
  return m;
}

// Append layer l's slice of a stacked weight [L, in, width] (and its scales
// [L, width]) as the next segment.
__host__ __device__ inline void add_seg(Mat& m, const void* w, const void* s, int l, int in, int width) {
  const int i = m.n++;
  const size_t esz = m.wbf16 ? 2 : 1;
  m.w[i] = (const char*)w + (size_t)l * in * width * esz;
  m.s[i] = m.wbf16 ? nullptr : (const float*)s + (size_t)l * width;
  m.end[i] = (i ? m.end[i - 1] : 0) + width;
}

__device__ __forceinline__ int seg_of(const Mat& m, int c) {
  return (m.n > 1 && c >= m.end[0]) + (m.n > 2 && c >= m.end[1]);
}
__device__ __forceinline__ int seg_start(const Mat& m, int i) {
  return i == 0 ? 0 : i == 1 ? m.end[0] : m.end[1];
}

// Row 0 of output column c's weights, and the row stride (its segment's width)
template <typename W>
__device__ __forceinline__ const W* wcol(const Mat& m, int c, int& ld) {
  const int i = seg_of(m, c), c0 = seg_start(m, i);
  ld = (i == 0 ? m.end[0] : i == 1 ? m.end[1] : m.end[2]) - c0;
  return (const W*)(i == 0 ? m.w[0] : i == 1 ? m.w[1] : m.w[2]) + (c - c0);
}

__device__ __forceinline__ float col_scale(const Mat& m, int c) {
  const int i = seg_of(m, c);
  return (i == 0 ? m.s[0] : i == 1 ? m.s[1] : m.s[2])[c - seg_start(m, i)];
}

// Four rows of 16 int8 columns (w[k]: row k's 16 bytes) as 16 words, word j
// holding column j's 4 weights in row order (the dp4a operand).
__device__ __forceinline__ void transpose_4x16(const int4 (&w)[4], int (&cols)[16]) {
  const int* a = reinterpret_cast<const int*>(&w[0]);
  const int* b = reinterpret_cast<const int*>(&w[1]);
  const int* c = reinterpret_cast<const int*>(&w[2]);
  const int* d = reinterpret_cast<const int*>(&w[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // word k of a row: columns 4k..4k+3
    const uint32_t t0 = __byte_perm(a[k], b[k], 0x5140), t1 = __byte_perm(a[k], b[k], 0x7362);
    const uint32_t u0 = __byte_perm(c[k], d[k], 0x5140), u1 = __byte_perm(c[k], d[k], 0x7362);
    cols[4 * k + 0] = (int)__byte_perm(t0, u0, 0x5410);
    cols[4 * k + 1] = (int)__byte_perm(t0, u0, 0x7632);
    cols[4 * k + 2] = (int)__byte_perm(t1, u1, 0x5410);
    cols[4 * k + 3] = (int)__byte_perm(t1, u1, 0x7632);
  }
}

// The counter-based generator (decode_blocks.py ``_mix``/``stream_key``).
__host__ __device__ inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__host__ __device__ inline uint32_t stream_key(uint32_t s0, uint32_t s1, uint32_t stream) {
  return mix32(s0 ^ mix32(s1 + stream * 0x9E3779B9u));
}

// Row b of a batched call draws from stream ``stream + STREAMS_PER_ROW * b``
// (row 0 keeps the single-sequence streams).
constexpr uint32_t STREAMS_PER_ROW = 16;

// ---------------------------------------------------------------------------
// Weight-only GEMV at B=1, first pass: part[split, o] = sum over this
// split's rows r of x[r] * W[r, o] in f32. W is int8 or bf16 [I, O]
// row-major (O % 16 == 0). A thread loads 16 bytes: EPL = 16 (int8) or 8
// (bf16) neighbouring columns, so a block covers 32 x EPL columns. Grid
// (ceil(O / (32 EPL)), splits); each warp walks every 8th row.
// ---------------------------------------------------------------------------
template <typename W>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_partial(const Mat m, const bf16* __restrict__ x, float* __restrict__ part,
             int I, int O, int rows_per_split) {
  constexpr int EPL = 16 / sizeof(W);  // weights per 16-byte load
  constexpr int COLS = 32 * EPL;       // columns per block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * COLS + lane * EPL;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(I, r0 + rows_per_split);
  float acc[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) acc[j] = 0.f;
  if (col < O) {
    int ld;
    const W* wc = wcol<W>(m, col, ld);
#pragma unroll 4
    for (int r = r0 + warp; r < r1; r += GEMV_THREADS / 32) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(wc + (size_t)r * ld));
      const float xv = bf(x[r]);
      const W* wb = reinterpret_cast<const W*>(&w);
#pragma unroll
      for (int j = 0; j < EPL; ++j) acc[j] = fmaf(xv, to_f(wb[j]), acc[j]);
    }
  }
  __shared__ float red[GEMV_THREADS / 32][EPL][32];  // [warp][j][lane]
#pragma unroll
  for (int j = 0; j < EPL; ++j) red[warp][j][lane] = acc[j];
  __syncthreads();
  // each thread sums EPL / NW outputs over the warps, in an unrolled loop
  constexpr int NW = GEMV_THREADS / 32;
  static_assert(EPL % NW == 0, "each warp finishes EPL / NW columns per lane");
#pragma unroll
  for (int jj = 0; jj < EPL / NW; ++jj) {
    const int j = warp + jj * NW;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < GEMV_THREADS / 32; ++w) s += red[w][j][lane];
    const int c = blockIdx.x * COLS + lane * EPL + j;
    if (c < O) part[(size_t)blockIdx.y * O + c] = s;
  }
}

// 8 neighbouring weights of a staged tile, widened to f32
__device__ __forceinline__ void load8(const int8_t* p, float* w) {
  const int2 v = *reinterpret_cast<const int2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = (float)b[j];
}
__device__ __forceinline__ void load8(const bf16* p, float* w) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = bf(b[j]);
}

// ---------------------------------------------------------------------------
// Weight-only GEMV at B>1, first pass: part[split, b, o] = sum over this
// split's rows r of x[b, r] * W[r, o] in f32, W int8 or bf16. Grid
// (ceil(O / 128), splits). A block owns 128 columns and one split of the
// rows; it walks the split in passes of 128 rows, staging the weight tile
// (16-byte loads, each weight read from device memory by this block only,
// once; 16 KB of int8 or 32 KB of bf16) and x[:, rows] in shared memory.
// Thread = (column group of 8, slot of 16): the slots take (row tile of 8
// batch rows, row group) pairs, so at small B the rows of the split are
// spread over up to 16 groups and at B=64 over 2. A thread keeps 8 x 8 f32
// accumulators; the row groups are summed through shared memory. Past 64
// rows, grid z takes the batch in groups of BG_GROUP (``batch_group``).
// ---------------------------------------------------------------------------
// This block's group of batch rows: the first row g0 and the group's B (up
// to BG_GROUP) of the call's Bt rows
__device__ __forceinline__ int batch_group(int Bt, int& g0) {
  g0 = blockIdx.z * BG_GROUP;
  return min(BG_GROUP, Bt - g0);
}

template <typename W>
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_batched(const Mat m, const bf16* __restrict__ x, int Bt,
             float* __restrict__ part, int I, int O, int rows_per_split) {
  constexpr int EPL = 16 / sizeof(W);  // weights per 16-byte load
  int g0;
  const int B = batch_group(Bt, g0);
  x += (size_t)g0 * I;
  extern __shared__ __align__(16) unsigned char bg_smem[];
  W* ws = reinterpret_cast<W*>(bg_smem);                                          // [BG_ROWS][BG_COLS]
  bf16* xs = reinterpret_cast<bf16*>(bg_smem + BG_ROWS * BG_COLS * sizeof(W));   // [B][BG_XS]
  float* red = reinterpret_cast<float*>(bg_smem);                                 // [KG][Bp][BG_COLS], at the end
  const int tid = threadIdx.x;
  const int NBT = (B + 7) / 8, Bp = NBT * 8, KG = 16 / NBT;
  const int cg = tid & 15, slot = tid >> 4;
  const int bt = slot % NBT, kg = slot / NBT;
  const bool active = kg < KG;
  const int c0 = blockIdx.x * BG_COLS;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(I, r0 + rows_per_split);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int rc = r0; rc < r1; rc += BG_ROWS) {
    const int nr = min(BG_ROWS, r1 - rc);
    for (int i = tid; i < nr * (BG_COLS / EPL); i += GEMV_THREADS) {
      const int r = i / (BG_COLS / EPL), ch = i % (BG_COLS / EPL);
      const int c = c0 + ch * EPL;
      int4 w = make_int4(0, 0, 0, 0);
      if (c < O) {
        int ld;
        w = __ldg(reinterpret_cast<const int4*>(wcol<W>(m, c, ld) + (size_t)(rc + r) * ld));
      }
      *reinterpret_cast<int4*>(ws + r * BG_COLS + ch * EPL) = w;
    }
    for (int i = tid; i < B * nr; i += GEMV_THREADS) {
      const int b = i / nr, r = i % nr;
      xs[b * BG_XS + r] = x[(size_t)b * I + rc + r];
    }
    __syncthreads();
    if (active) {
      for (int r = kg; r < nr; r += KG) {
        float w[8];
        load8(ws + r * BG_COLS + cg * 8, w);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int b = bt * 8 + i;
          const float xi = b < B ? bf(xs[b * BG_XS + r]) : 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xi, w[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next pass (or the reduction) overwrites the tiles
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(kg * Bp + bt * 8 + i) * BG_COLS + cg * 8 + j] = acc[i][j];
  }
  __syncthreads();
  for (int o = tid; o < B * BG_COLS; o += GEMV_THREADS) {
    const int b = o / BG_COLS, c = o % BG_COLS;
    if (c0 + c >= O) continue;
    float s = 0.f;
    for (int k = 0; k < KG; ++k) s += red[(k * Bp + b) * BG_COLS + c];
    part[((size_t)blockIdx.y * Bt + g0 + b) * O + c0 + c] = s;
  }
}

// ---------------------------------------------------------------------------
// dyn_int8 GEMV at B=1, first pass: part[split, o] = the int32 sum over
// this split's rows r of xq[r] * W[r, o], W int8, xq = x quantized with the
// row's scale (``act_scale(amax[0])``). The block first quantizes its split
// of x into shared memory (words of 4 rows); then a thread takes 16
// neighbouring columns (a block 512) and each warp every 8th group of 4
// rows: 4 x 16-byte loads, a byte transpose, 16 ``__dp4a``. Grid
// (ceil(O / 512), splits); rows_per_split and I multiples of 4; dynamic
// shared memory rows_per_split bytes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_partial_dq(const Mat m, const bf16* __restrict__ x, const float* __restrict__ amax,
                int* __restrict__ part, int I, int O, int rows_per_split) {
  constexpr int COLS = 32 * 16, NW = GEMV_THREADS / 32;
  extern __shared__ int xq4[];  // [rows_per_split / 4]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * COLS + lane * 16;
  const int r0 = blockIdx.y * rows_per_split;
  const int ng = (min(I, r0 + rows_per_split) - r0) / 4;
  const float s = act_scale(amax[0]);
  for (int g = threadIdx.x; g < ng; g += GEMV_THREADS) xq4[g] = pack4(x + r0 + 4 * g, s);
  __syncthreads();
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  if (col < O) {
    int ld;
    const int8_t* wc = wcol<int8_t>(m, col, ld) + (size_t)r0 * ld;
#pragma unroll 2
    for (int g = warp; g < ng; g += NW) {
      const int8_t* p = wc + (size_t)(4 * g) * ld;
      int4 w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = __ldg(reinterpret_cast<const int4*>(p + (size_t)k * ld));
      int cols[16];
      transpose_4x16(w, cols);
      const int xw = xq4[g];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = __dp4a(cols[j], xw, acc[j]);
    }
  }
  __shared__ int red[NW][16][32];  // [warp][j][lane]
#pragma unroll
  for (int j = 0; j < 16; ++j) red[warp][j][lane] = acc[j];
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < 16 / NW; ++jj) {
    const int j = warp + jj * NW;
    int t = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) t += red[w][j][lane];
    const int c = blockIdx.x * COLS + lane * 16 + j;
    if (c < O) part[(size_t)blockIdx.y * O + c] = t;
  }
}

// ---------------------------------------------------------------------------
// dyn_int8 GEMV at B>1, first pass: part[split, b, o] = the int32 sum over
// this split's rows r of xq[b, r] * W[r, o], W int8, xq = x quantized with
// row b's scale. The blocking of ``gemv_batched``: a block owns 128 columns
// and one split of the rows, in passes of 128 rows; it stages the weight
// tile transposed into dp4a words ([32 row groups][128 columns] of 4 int8,
// 16 KB) and x quantized into words ([B][32], 8 KB, half the bf16 tile).
// A thread takes 8 columns x 8 batch rows of int32 accumulators: per group
// of 4 weight rows, 2 x 16-byte loads of weights, 8 x words and 64 dp4a.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(GEMV_THREADS)
gemv_batched_dq(const Mat m, const bf16* __restrict__ x, int Bt, const float* __restrict__ amax,
                int* __restrict__ part, int I, int O, int rows_per_split) {
  constexpr int NCH = BG_COLS / 16;  // 16-column chunks of the tile
  extern __shared__ __align__(16) unsigned char bg_smem[];
  int* ws4 = reinterpret_cast<int*>(bg_smem);     // [BG_ROWS / 4][BG_COLS]
  int* xs4 = ws4 + (BG_ROWS / 4) * BG_COLS;       // [B][BGQ_XS]
  int* red = reinterpret_cast<int*>(bg_smem);     // [KG][Bp][BG_COLS], at the end
  __shared__ float s_row[BG_GROUP];
  int g0;
  const int B = batch_group(Bt, g0);
  x += (size_t)g0 * I;
  amax += g0;
  const int tid = threadIdx.x;
  const int NBT = (B + 7) / 8, Bp = NBT * 8, KG = 16 / NBT;
  const int cg = tid & 15, slot = tid >> 4;
  const int bt = slot % NBT, kg = slot / NBT;
  const bool active = kg < KG;
  const int c0 = blockIdx.x * BG_COLS;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(I, r0 + rows_per_split);
  for (int b = tid; b < B; b += GEMV_THREADS) s_row[b] = act_scale(amax[b]);
  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;
  __syncthreads();  // s_row
  for (int rc = r0; rc < r1; rc += BG_ROWS) {
    const int ng = min(BG_ROWS, r1 - rc) / 4;
    for (int i = tid; i < ng * NCH; i += GEMV_THREADS) {
      const int g = i / NCH, ch = i % NCH;
      const int c = c0 + ch * 16;
      int4 w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = make_int4(0, 0, 0, 0);
      if (c < O) {
        int ld;
        const int8_t* p = wcol<int8_t>(m, c, ld) + (size_t)(rc + 4 * g) * ld;
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = __ldg(reinterpret_cast<const int4*>(p + (size_t)k * ld));
      }
      int cols[16];
      transpose_4x16(w, cols);
      int4* dst = reinterpret_cast<int4*>(ws4 + g * BG_COLS + ch * 16);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[k] = make_int4(cols[4 * k], cols[4 * k + 1], cols[4 * k + 2], cols[4 * k + 3]);
    }
    for (int i = tid; i < B * ng; i += GEMV_THREADS) {
      const int b = i / ng, g = i % ng;
      xs4[b * BGQ_XS + g] = pack4(x + (size_t)b * I + rc + 4 * g, s_row[b]);
    }
    __syncthreads();
    if (active) {
      for (int g = kg; g < ng; g += KG) {
        const int4 wa = *reinterpret_cast<const int4*>(ws4 + g * BG_COLS + cg * 8);
        const int4 wb = *reinterpret_cast<const int4*>(ws4 + g * BG_COLS + cg * 8 + 4);
        const int w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int b = bt * 8 + i;
          const int xw = b < B ? xs4[b * BGQ_XS + g] : 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(w[j], xw, acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next pass (or the reduction) overwrites the tiles
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(kg * Bp + bt * 8 + i) * BG_COLS + cg * 8 + j] = acc[i][j];
  }
  __syncthreads();
  for (int o = tid; o < B * BG_COLS; o += GEMV_THREADS) {
    const int b = o / BG_COLS, c = o % BG_COLS;
    if (c0 + c >= O) continue;
    int t = 0;
    for (int k = 0; k < KG; ++k) t += red[(k * Bp + b) * BG_COLS + c];
    part[((size_t)blockIdx.y * Bt + g0 + b) * O + c0 + c] = t;
  }
}

// ---------------------------------------------------------------------------
// The batched GEMV on the tensor cores (B > 1), first pass: the function,
// grid, split and partials of ``gemv_batched`` (f32 sums) and
// ``gemv_batched_dq`` (exact int32 sums), so the same finishing kernels read
// them. The products are mma.sync with the operands swapped: the weights
// are the A operand (M = 16 output columns a tile, K = the rows I) and x the
// B operand (N = 8 batch rows a tile), D = W^T x^T in registers. The batch
// is the short side and comes in steps of 8 rows, so B = 8, 24, ... waste
// nothing (x as A would pad B to 16). Each of the 8 warps owns one 16-column
// tile of the block's 128 columns over the whole split and all ceil(B / 8)
// row tiles: its accumulators never meet another warp's, so the block needs
// no reduction and a warp's work grows with B in steps of 8 rows (B = 48
// costs 6/8 of B = 64). Per 128-row pass the block stages the tile as
// ``gemv_batched``/``_dq`` do (each weight read from device memory once),
// but through registers loaded all at once (one memory latency a pass, the
// next pass's loads in flight during this one's products) and into the mma
// operand layouts, with row strides that keep the fragment loads on
// distinct banks. The split goes up to TC_MAX_PARTS / B deep, twice the
// CUDA-core form's, in whole 128-row passes where it can (``batched_splits``):
//  - int8 ``wo_bf16`` and dense bf16 (``gemv_batched_mma``): the tile as
//    bf16 [128 rows][TC_WS] (an int8 weight widened exactly), x as bf16
//    [B][TC_XS]; A fragments by ``ldmatrix.trans`` of the [K][O] tile, B
//    fragments by ``ldmatrix`` of x's rows; m16n8k16 bf16 -> f32. The
//    per-column scale is applied after the split sum by the finishing
//    kernels, as before.
//  - ``dyn_int8`` (``gemv_batched_dq_mma``): the tile in dp4a words (4
//    K-consecutive int8 of one column, ``transpose_4x16``) [32][TCQ_WS],
//    which are the m16n8k32 s8 A operand as they stand, and x quantized per
//    row into words [B][TCQ_XS] (``quant_act_r``: a multiply, the divide
//    only next to a rounding tie; every block quantizes its rows, so this
//    is most of the staging work); m16n8k32 s8 -> s32. Integer sums are
//    exact in any order, so each split's partial equals the dp4a form's to
//    the bit.
// Rows of a pass past the split's end are zero in both operands. I, the
// split rows and O are multiples of 16 (K2's wrapper checks the widths).
// Past 64 rows, grid z takes the batch in groups of BG_GROUP
// (``batch_group``), each block as at B <= 64 on its group's rows.
// ---------------------------------------------------------------------------
template <typename W>
__global__ void __launch_bounds__(GEMV_THREADS, 2)
gemv_batched_mma(const Mat m, const bf16* __restrict__ x, int Bt, float* __restrict__ part, int I,
                 int O, int rows_per_split) {
  constexpr int EPL = 16 / sizeof(W);                          // weights per 16-byte load
  constexpr int WCH = BG_COLS / EPL;                           // 16-byte pieces of a tile row
  constexpr int WL = BG_ROWS * WCH / GEMV_THREADS;             // a thread's pieces of the tile
  constexpr int XL = BG_GROUP * (BG_ROWS / 8) / GEMV_THREADS;  // a thread's pieces of x
  extern __shared__ __align__(16) unsigned char bg_smem[];
  bf16* ws = reinterpret_cast<bf16*>(bg_smem);  // [BG_ROWS][TC_WS]
  bf16* xs = ws + BG_ROWS * TC_WS;              // [BG_GROUP][TC_XS]
  int g0;
  const int B = batch_group(Bt, g0);
  x += (size_t)g0 * I;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NT = (B + 7) / 8;  // batch tiles of 8 rows
  const int c0 = blockIdx.x * BG_COLS;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(I, r0 + rows_per_split);
  const bool live = c0 + warp * 16 < O;  // this warp's 16 columns exist (O % 16 == 0)
  // ldmatrix row addresses: lane l gives row (l & 7) + 8 (l >> 4) of the
  // 16-row slab at column offset 8 ((l >> 3) & 1): the four 8x8 matrices
  // (rows 0-7, cols 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
  const int lrow = (lane & 7) + ((lane >> 4) << 3), lcol = ((lane >> 3) & 1) << 3;
  float acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;
  // a pass's weights and x, loaded into registers all at once (one memory
  // latency a pass, and the next pass's loads fly during this one's products)
  int4 wr[WL], xr[XL];
  auto fetch = [&](int rc) {
    const int nr = min(BG_ROWS, r1 - rc);
#pragma unroll
    for (int j = 0; j < WL; ++j) {
      const int i = tid + j * GEMV_THREADS, r = i / WCH, c = c0 + (i % WCH) * EPL;
      wr[j] = make_int4(0, 0, 0, 0);
      if (r < nr && c < O) {
        int ld;
        wr[j] = __ldg(reinterpret_cast<const int4*>(wcol<W>(m, c, ld) + (size_t)(rc + r) * ld));
      }
    }
#pragma unroll
    for (int j = 0; j < XL; ++j) {
      const int i = tid + j * GEMV_THREADS, b = i / (BG_ROWS / 8), r = (i % (BG_ROWS / 8)) * 8;
      xr[j] = make_int4(0, 0, 0, 0);
      if (b < B && r < nr) xr[j] = __ldg(reinterpret_cast<const int4*>(x + (size_t)b * I + rc + r));
    }
  };
  fetch(r0);
  for (int rc = r0; rc < r1; rc += BG_ROWS) {
    const int nk = (min(BG_ROWS, r1 - rc) + 15) / 16;  // k16 steps (rows past the end are 0)
#pragma unroll
    for (int j = 0; j < WL; ++j) {
      const int i = tid + j * GEMV_THREADS;
      int4* dst = reinterpret_cast<int4*>(ws + (i / WCH) * TC_WS + (i % WCH) * EPL);
      if constexpr (std::is_same<W, int8_t>::value) {  // widen: int8 is exact in bf16
        const int8_t* b = reinterpret_cast<const int8_t*>(&wr[j]);
        uint32_t p[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = pack_bf16((float)b[2 * k], (float)b[2 * k + 1]);
        dst[0] = make_int4((int)p[0], (int)p[1], (int)p[2], (int)p[3]);
        dst[1] = make_int4((int)p[4], (int)p[5], (int)p[6], (int)p[7]);
      } else {
        dst[0] = wr[j];
      }
    }
#pragma unroll
    for (int j = 0; j < XL; ++j) {
      const int i = tid + j * GEMV_THREADS;
      *reinterpret_cast<int4*>(xs + (i / (BG_ROWS / 8)) * TC_XS + (i % (BG_ROWS / 8)) * 8) = xr[j];
    }
    __syncthreads();
    if (rc + BG_ROWS < r1) fetch(rc + BG_ROWS);
    if (live) {
      for (int ks = 0; ks < nk; ++ks) {
        uint32_t a[4];
        ldsm_x4_trans(a, ws + (ks * 16 + lrow) * TC_WS + warp * 16 + lcol);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (2 * p < NT) {  // batch tiles 2p and 2p + 1 (rows past B are never stored)
            uint32_t b[4];
            ldsm_x4(b, xs + (p * 16 + lrow) * TC_XS + ks * 16 + lcol);
            // x's rows are the batch: tile 2p is matrices 0 (k 0-7) and 1
            // (k 8-15), tile 2p + 1 matrices 2 and 3
            mma_bf16(acc[2 * p], a, b[0], b[1]);
            if (2 * p + 1 < NT) mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the next pass overwrites the tiles
  }
  if (!live) return;
  // D fragment: acc[t][0..1] columns g, batch rows 8t + 2c, 8t + 2c + 1;
  // acc[t][2..3] columns g + 8, the same rows
  const int g = lane >> 2, cq = lane & 3;
  const int col = c0 + warp * 16 + g;
  float* dst = part + ((size_t)blockIdx.y * Bt + g0) * O;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int b = t * 8 + 2 * cq;
    if (t < NT && b < B) {
      dst[(size_t)b * O + col] = acc[t][0];
      dst[(size_t)b * O + col + 8] = acc[t][2];
    }
    if (t < NT && b + 1 < B) {
      dst[(size_t)(b + 1) * O + col] = acc[t][1];
      dst[(size_t)(b + 1) * O + col + 8] = acc[t][3];
    }
  }
}

__global__ void __launch_bounds__(GEMV_THREADS, 2)
gemv_batched_dq_mma(const Mat m, const bf16* __restrict__ x, int Bt,
                    const float* __restrict__ amax, int* __restrict__ part, int I, int O,
                    int rows_per_split) {
  constexpr int NCH = BG_COLS / 16;  // 16-column chunks of the tile
  static_assert((BG_ROWS / 4) * NCH == GEMV_THREADS, "one 4 x 16 weight chunk a thread");
  constexpr int XL = BG_GROUP * (BG_ROWS / 8) / GEMV_THREADS;  // a thread's 8-value pieces of x
  extern __shared__ __align__(16) unsigned char bg_smem[];
  int* ws4 = reinterpret_cast<int*>(bg_smem);  // [BG_ROWS / 4][TCQ_WS]
  int* xs4 = ws4 + (BG_ROWS / 4) * TCQ_WS;     // [BG_GROUP][TCQ_XS]
  __shared__ float s_row[BG_GROUP], r_row[BG_GROUP];
  int g0;
  const int B = batch_group(Bt, g0);
  x += (size_t)g0 * I;
  amax += g0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int NT = (B + 7) / 8;
  const int c0 = blockIdx.x * BG_COLS;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(I, r0 + rows_per_split);
  const bool live = c0 + warp * 16 < O;
  for (int b = tid; b < B; b += GEMV_THREADS) {
    s_row[b] = act_scale(amax[b]);
    r_row[b] = __frcp_rn(s_row[b]);
  }
  int acc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0;
  // this thread's weight chunk (group of 4 rows wg, 16 columns from wc) and
  // x pieces, loaded into registers all at once, as in gemv_batched_mma
  const int wg = tid / NCH, wc = c0 + (tid % NCH) * 16;
  int4 wr[4], xr[XL];
  auto fetch = [&](int rc) {
    const int ng = min(BG_ROWS, r1 - rc) / 4;  // groups of 4 rows (I % 4 == 0)
#pragma unroll
    for (int k = 0; k < 4; ++k) wr[k] = make_int4(0, 0, 0, 0);
    if (wg < ng && wc < O) {
      int ld;
      const int8_t* p = wcol<int8_t>(m, wc, ld) + (size_t)(rc + 4 * wg) * ld;
#pragma unroll
      for (int k = 0; k < 4; ++k) wr[k] = __ldg(reinterpret_cast<const int4*>(p + (size_t)k * ld));
    }
#pragma unroll
    for (int j = 0; j < XL; ++j) {
      const int i = tid + j * GEMV_THREADS, b = i / (BG_ROWS / 8), r = (i % (BG_ROWS / 8)) * 8;
      xr[j] = make_int4(0, 0, 0, 0);
      // one 16-byte load (quantizing reads it as bf16 elements, which a
      // plain dereference would let the compiler split into 2-byte loads)
      if (b < B && r < 4 * ng) xr[j] = __ldg(reinterpret_cast<const int4*>(x + (size_t)b * I + rc + r));
    }
  };
  __syncthreads();  // s_row
  fetch(r0);
  for (int rc = r0; rc < r1; rc += BG_ROWS) {
    const int ng8 = (min(BG_ROWS, r1 - rc) / 4 + 7) & ~7;  // k32 steps of 8 groups (past the end: 0)
    {
      int cols[16];
      transpose_4x16(wr, cols);
      int4* dst = reinterpret_cast<int4*>(ws4 + wg * TCQ_WS + (tid % NCH) * 16);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dst[k] = make_int4(cols[4 * k], cols[4 * k + 1], cols[4 * k + 2], cols[4 * k + 3]);
    }
#pragma unroll
    for (int j = 0; j < XL; ++j) {  // 8 values quantized into 2 words (zeros stay 0)
      const int i = tid + j * GEMV_THREADS, b = i / (BG_ROWS / 8), r = (i % (BG_ROWS / 8)) * 8;
      if (b < B) {
        const bf16* v = reinterpret_cast<const bf16*>(&xr[j]);
        const float s = s_row[b], rs = r_row[b];
        xs4[b * TCQ_XS + r / 4] = pack4_r(v, s, rs);
        xs4[b * TCQ_XS + r / 4 + 1] = pack4_r(v + 4, s, rs);
      }
    }
    __syncthreads();
    if (rc + BG_ROWS < r1) fetch(rc + BG_ROWS);
    if (live) {
      for (int ks = 0; ks < ng8 / 8; ++ks) {
        const int* wk = ws4 + (ks * 8 + cq) * TCQ_WS + warp * 16 + g;
        const uint32_t a[4] = {(uint32_t)wk[0], (uint32_t)wk[8], (uint32_t)wk[4 * TCQ_WS],
                               (uint32_t)wk[4 * TCQ_WS + 8]};
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (t < NT) {
            const int* xk = xs4 + (t * 8 + g) * TCQ_XS + ks * 8 + cq;
            mma_s8(acc[t], a, (uint32_t)xk[0], (uint32_t)xk[4]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
  const int col = c0 + warp * 16 + g;
  int* dst = part + ((size_t)blockIdx.y * Bt + g0) * O;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int b = t * 8 + 2 * cq;
    if (t < NT && b < B) {
      dst[(size_t)b * O + col] = acc[t][0];
      dst[(size_t)b * O + col + 8] = acc[t][2];
    }
    if (t < NT && b + 1 < B) {
      dst[(size_t)(b + 1) * O + col] = acc[t][1];
      dst[(size_t)(b + 1) * O + col + 8] = acc[t][3];
    }
  }
}

// The current device's SM count (device_state.cuh: one entry a device).
inline int num_sms() { return device_attr<cudaDevAttrMultiProcessorCount>(132); }

// The split of the reduction dimension: ``cols`` columns per block, a
// multiple of ``align`` rows per split, at most ``max_parts`` / B splits at
// B > 1; returns the splits, sets ``rows``.
inline int gemv_splits(int B, int I, int O, int cols, int align, int& rows,
                       int max_parts = GEMV_MAX_PARTS) {
  const int col_blocks = (O + cols - 1) / cols;
  int splits = B == 1 ? (2 * num_sms()) / col_blocks : (2 * num_sms() + col_blocks - 1) / col_blocks;
  splits = max(1, min(min(splits, B == 1 ? GEMV_MAX_SPLIT : max_parts / B),
                      (I + align - 1) / align));
  rows = (I + splits - 1) / splits;
  rows = (rows + align - 1) / align * align;
  return (I + rows - 1) / rows;
}

// The batched GEMVs' BG_SMEM of dynamic shared memory, allowed once a
// device (``allowed``: the kernel's table, device_state.cuh).
template <typename K>
inline void big_smem(K kernel, std::atomic<size_t> (&allowed)[QT_MAX_DEVICES]) {
  allow_smem(kernel, BG_SMEM, allowed);
}

// The split of a batched GEMV (B > 1): ``rows`` per split. The tensor-core
// form's blocks finish a pass in about a memory latency, so it takes up to
// twice the splits (TC_MAX_PARTS) and, where a split would end in a part
// pass (1024 rows in 6 splits: 176 = 128 + 48), splits deeper into whole
// 128-row passes if the limit allows (8 splits of 128).
inline int batched_splits(int B, int I, int O, int& rows) {
  const int splits = gemv_splits(B, I, O, BG_COLS, 16, rows, TC_MAX_PARTS);
  const int whole = rows / BG_ROWS * BG_ROWS;
  if (rows > BG_ROWS && rows % BG_ROWS && (I + whole - 1) / whole <= TC_MAX_PARTS / B) {
    rows = whole;
    return (I + rows - 1) / rows;
  }
  return splits;
}

// The grid of a batched GEMV: 128 columns, ``splits`` of the rows, groups
// of BG_GROUP batch rows
inline dim3 batched_grid(int B, int O, int splits) {
  return dim3((O + BG_COLS - 1) / BG_COLS, splits, (B + BG_GROUP - 1) / BG_GROUP);
}

// B = 1: ``gemv_partial``; B > 1: the tensor-core form
template <typename W>
inline int gemv_t(const Mat& m, const bf16* x, int B, float* part, int I, int O, cudaStream_t st) {
  int rows;
  if (B == 1) {
    constexpr int COLS = 32 * (16 / sizeof(W));
    const int splits = gemv_splits(1, I, O, COLS, 8, rows);
    gemv_partial<W><<<dim3((O + COLS - 1) / COLS, splits), GEMV_THREADS, 0, st>>>(m, x, part, I,
                                                                                 O, rows);
    return splits;
  }
  static std::atomic<size_t> smem_set[QT_MAX_DEVICES];  // one per weight type
  big_smem(gemv_batched_mma<W>, smem_set);
  const int splits = batched_splits(B, I, O, rows);
  gemv_batched_mma<W><<<batched_grid(B, O, splits), GEMV_THREADS, BG_SMEM, st>>>(m, x, B, part, I,
                                                                               O, rows);
  return splits;
}

inline int gemv_dq(const Mat& m, const bf16* x, int B, const float* amax, int* part, int I, int O,
                   cudaStream_t st) {
  int rows;
  if (B == 1) {
    const int splits = gemv_splits(1, I, O, 512, 8, rows);
    gemv_partial_dq<<<dim3((O + 511) / 512, splits), GEMV_THREADS, rows, st>>>(m, x, amax, part,
                                                                                I, O, rows);
    return splits;
  }
  static std::atomic<size_t> smem_set[QT_MAX_DEVICES];
  big_smem(gemv_batched_dq_mma, smem_set);
  const int splits = batched_splits(B, I, O, rows);
  gemv_batched_dq_mma<<<batched_grid(B, O, splits), GEMV_THREADS, BG_SMEM, st>>>(m, x, B, amax,
                                                                               part, I, O, rows);
  return splits;
}

// Launch the first pass of y[B, O] = x[B, I] @ W; returns the number of
// splits written to ``part`` ([splits][B][O]): f32 sums (W int8 or bf16),
// or with ``amax`` (dyn_int8, the rows' activation amax; W int8) int32 sums
// of x quantized per row. At B > 1 on the tensor cores.
inline int gemv(const Mat& m, const bf16* x, int B, float* part, int I, int O, const float* amax,
                cudaStream_t st) {
  if (amax) return gemv_dq(m, x, B, amax, reinterpret_cast<int*>(part), I, O, st);
  return m.wbf16 ? gemv_t<bf16>(m, x, B, part, I, O, st) : gemv_t<int8_t>(m, x, B, part, I, O, st);
}

// Sum of the splits of output ``idx``; consecutive splits lie ``stride``
// apart (an int: splits x B x O < 2^31, and a 32-bit stride keeps the
// address a single wide multiply). The partials are read through the L2
// (``__ldcg``), never the non-coherent path: K2's persistent frame
// (cp_loop.cu) reads partials that other blocks of the same launch wrote.
__device__ __forceinline__ float split_sum(const float* part, int splits, int stride, int idx) {
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += __ldcg(part + (size_t)k * stride + idx);
  return s;
}

// dyn_int8: the exact int32 sum of the splits, converted to f32 once
__device__ __forceinline__ float split_isum(const float* part, int splits, int stride, int idx) {
  const int* p = reinterpret_cast<const int*>(part);
  int s = 0;
  for (int k = 0; k < splits; ++k) s += __ldcg(p + (size_t)k * stride + idx);
  return __int2float_rn(s);
}

// A GEMV output in f32, column c of ``m``. Weight-only (s == 0): the split
// sum times column c's scale for int8 weights, the sum as it is for bf16.
// dyn_int8 (s > 0, the row's activation scale): f32(int32 sum) * (s * scale).
__device__ __forceinline__ float mv_out(const float* part, int splits, int stride, int idx,
                                        const Mat& m, int c, float s) {
  if (s > 0.f)
    return __fmul_rn(split_isum(part, splits, stride, idx), __fmul_rn(s, col_scale(m, c)));
  const float sum = split_sum(part, splits, stride, idx);
  return m.wbf16 ? sum : __fmul_rn(sum, col_scale(m, c));
}

// dyn_int8, in a row-owning kernel (one block per row): clear row b's
// atomic slots (amax points at slot 0 of the [AMAX_SLOTS][B] slots)
__device__ __forceinline__ void clear_atomic_slots(float* amax, int b) {
  if (threadIdx.x == 0)
    for (int i = 1; i < AMAX_SLOTS; ++i) amax[i * gridDim.x + b] = 0.f;
}

// xn = rms(x, nw) and, if hres != nullptr, hres = x. One block per row;
// row b of x at x + b * x_stride, of xn/hres at b * H. With ``amax_out``
// (dyn_int8, slot 0 of the slots) the row's max |xn| goes to amax_out[b]
// and its atomic slots are cleared.
__global__ void rms_copy(const bf16* __restrict__ x, int x_stride, const float* __restrict__ nw,
                         bf16* __restrict__ xn, bf16* __restrict__ hres, int H, float eps,
                         float* __restrict__ amax_out) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  if (amax_out) clear_atomic_slots(amax_out, b);
  x += (size_t)b * x_stride;
  xn += (size_t)b * H;
  if (hres) hres += (size_t)b * H;
  float ss = 0.f;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const float v = bf(x[c]);
    ss = fmaf(v, v, ss);
  }
  const float r = 1.0f / sqrtf(__fdiv_rn(block_sum(ss, red), (float)H) + eps);
  float mx = 0.f;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const bf16 v = x[c];
    if (hres) hres[c] = v;
    const bf16 o = __float2bfloat16_rn(__fmul_rn(__fmul_rn(bf(v), r), nw[c]));
    xn[c] = o;
    mx = fmaxf(mx, fabsf(bf(o)));
  }
  if (amax_out) {
    mx = block_max(mx, red);
    if (threadIdx.x == 0) amax_out[b] = mx;
  }
}

// Second pass of a GEMV whose output joins the residual stream:
// h = bf16(h + bf16(y)), y the GEMV output (``mv_out``); xn = rms(h, nw).
// With ``bias`` (the small-to-MTP projection, [H] shared by the rows) the
// stream starts there instead: h = bf16(bf16(y) + bias). One block per row.
// dyn_int8: ``amax_in`` holds the GEMV input's amax (an atomic slot, or
// null for the bf16 projection), ``amax_out`` (slot 0 of the slots) takes
// the max |xn| of the row, and the row's atomic slots are cleared once read.
__global__ void finish_residual_norm(const float* __restrict__ part, int splits, const Mat m,
                                     const float* __restrict__ amax_in, bf16* __restrict__ h,
                                     const bf16* __restrict__ bias,
                                     const float* __restrict__ nw, bf16* __restrict__ xn,
                                     int H, float eps, float* __restrict__ amax_out) {
  __shared__ float red[32];
  __shared__ float s_sh;
  const int row = blockIdx.x * H;
  const int stride = gridDim.x * H;
  if (threadIdx.x == 0) s_sh = amax_in ? act_scale(amax_in[blockIdx.x]) : 0.f;
  __syncthreads();
  if (amax_out) clear_atomic_slots(amax_out, blockIdx.x);
  const float s = s_sh;
  float ss = 0.f;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const float y = rbf(mv_out(part, splits, stride, row + c, m, c, s));
    const float hv = rbf(__fadd_rn(bias ? bf(bias[c]) : bf(h[row + c]), y));
    h[row + c] = __float2bfloat16_rn(hv);
    ss = fmaf(hv, hv, ss);
  }
  const float r = 1.0f / sqrtf(__fdiv_rn(block_sum(ss, red), (float)H) + eps);
  float mx = 0.f;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const bf16 o = __float2bfloat16_rn(__fmul_rn(__fmul_rn(bf(h[row + c]), r), nw[c]));
    xn[row + c] = o;
    mx = fmaxf(mx, fabsf(bf(o)));
  }
  if (amax_out) {
    mx = block_max(mx, red);
    if (threadIdx.x == 0) amax_out[blockIdx.x] = mx;
  }
}

// Second pass of the gate_up GEMV: gated = bf16(g * sigmoid(g) * u) with
// g, u the bf16-rounded halves (``mv_out``). Grid (ceil(I / 256), B).
// dyn_int8: s from ``amax_in`` (the GEMV input's), and each warp's max
// |gated| joins row b's atomic slot ``amax_out``.
__global__ void finish_swiglu(const float* __restrict__ part, int splits, const Mat m,
                              const float* __restrict__ amax_in, int I, bf16* __restrict__ gated,
                              float* __restrict__ amax_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  const int O = 2 * I;
  const int stride = gridDim.y * O;
  const float s = amax_in ? act_scale(amax_in[b]) : 0.f;
  float mx = 0.f;
  if (c < I) {
    const float g = rbf(mv_out(part, splits, stride, b * O + c, m, c, s));
    const float u = rbf(mv_out(part, splits, stride, b * O + I + c, m, I + c, s));
    const float sig = 1.0f / (1.0f + expf(-g));
    const bf16 o = __float2bfloat16_rn(__fmul_rn(__fmul_rn(g, sig), u));
    gated[(size_t)b * I + c] = o;
    mx = fabsf(bf(o));
  }
  if (amax_out) {
    mx = warp_max(mx);
    if ((threadIdx.x & 31) == 0) atomic_amax(amax_out + b, mx);
  }
}

// ---------------------------------------------------------------------------
// Attention for one new token of each row, one block per (kv head, row).
// Finishes the qkv GEMV for the group, applies QK-RMSNorm and rope at the
// row's position ``pos`` (``offs[b]`` when given, else the scalar), writes
// the new k/v row at ``pos`` of this layer's cache [B, NKV, T, D] in place
// and attends.
//
// The talker form (CP = false): q scaled first, f32 probabilities, one
// division at the end. It walks the rows in tiles of ATTN_TILE with an
// online softmax (running max and sum per q head, the PV sums rescaled as
// the max grows), so the cache length has no limit. On a bf16 cache the
// rows are [0, pos], the new row read back from the cache. With KVQ the
// cache is int8 with one f32 scale per row ([B, NKV, T]): the new row is
// quantized in place (scale = max(amax / 127, 1e-12), round half to even),
// the prefix [0, pos) is read as int8 with the K scale folded into the
// scores and the V scale into the probabilities, and the current token
// joins with its own unquantized k/v as a final virtual block, as the TPU
// kernel does.
//
// The code predictor's form (CP = true, bf16 cache): scores scaled after the
// dot, probabilities normalised and rounded to bf16 before PV, over rows
// [0, pos] with the new row read back from the cache; the final sum must be
// known before PV, so it takes one tile (pos < ATTN_TILE).
//
// Dynamic shared memory: G * tile floats of scores, tile = min(prefix rows,
// ATTN_TILE) at B=1 and ATTN_TILE when the positions come from ``offs``. (A
// static 4 KB tile measured 3-4 us slower per call on an H100 at B=1 at the
// short caches of the main path.)
// ---------------------------------------------------------------------------
constexpr int ATTN_THREADS = 256;
constexpr int ATTN_MAX_GROUP = 4;
constexpr int ATTN_TILE = 256;
constexpr int ATTN_OWN = ATTN_MAX_GROUP * HEAD_DIM / ATTN_THREADS;  // outputs per thread

struct AttnCache {
  void *k, *v;      // this layer's [B, NKV, T, D]: bf16, or int8 with KVQ
  float *ks, *vs;   // KVQ: this layer's row scales [B, NKV, T]
  int T;
};

// kc/vc: this layer's cache rows (int8 with KVQ, else bf16), ksc/vsc their
// scales (KVQ), as in AttnCache
// dyn_int8: ``amax_in`` gives the qkv GEMV's activation scale, and each
// warp's max |out| joins row b's atomic slot ``amax_out``.
template <bool CP, bool KVQ, typename KV = typename std::conditional<KVQ, int8_t, bf16>::type>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_step(const float* __restrict__ part, int splits, const Mat qkv,
          const float* __restrict__ amax_in, const float* __restrict__ qn,
          const float* __restrict__ kn, float eps,
          const bf16* __restrict__ cosr, const bf16* __restrict__ sinr, int rope_stride,
          KV* __restrict__ kc, KV* __restrict__ vc, float* __restrict__ ksc,
          float* __restrict__ vsc, int T, int pos_all, const int* __restrict__ offs, int NQ,
          int NKV, float scale, bf16* __restrict__ out, float* __restrict__ amax_out) {
  constexpr int D = HEAD_DIM;
  __shared__ float raw[ATTN_MAX_GROUP + 2][D];  // q heads..., k, v (bf16 values)
  __shared__ float qk[ATTN_MAX_GROUP + 1][D];   // normed + roped q heads..., k
  __shared__ float rn[ATTN_MAX_GROUP + 1];
  __shared__ float qscale[2];                   // KVQ: the new k and v rows' scales
  extern __shared__ float sc[];  // [G][TS]: one tile of scores / weights
  __shared__ float m_run[ATTN_MAX_GROUP], l_run[ATTN_MAX_GROUP], alpha[ATTN_MAX_GROUP];
  __shared__ float p_cur[ATTN_MAX_GROUP];
  const int G = NQ / NKV, kvh = blockIdx.x, b = blockIdx.y, B = gridDim.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int OQKV = (NQ + 2 * NKV) * D;
  const int pos = offs ? offs[b] : pos_all;
  const bool in_range = pos >= 0 && pos < T;
  const int stride = B * OQKV;
  part += (size_t)b * OQKV;
  cosr += (size_t)b * rope_stride;
  sinr += (size_t)b * rope_stride;
  const float s_act = amax_in ? act_scale(amax_in[b]) : 0.f;

  for (int i = tid; i < (G + 2) * D; i += blockDim.x) {
    const int which = i / D, d = i % D;
    const int col = which < G ? (kvh * G + which) * D + d
                    : which == G ? (NQ + kvh) * D + d
                                 : (NQ + NKV + kvh) * D + d;
    raw[which][d] = rbf(mv_out(part, splits, stride, col, qkv, col, s_act));
  }
  __syncthreads();
  if (warp <= G) {  // one warp per vector to normalise
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) ss = fmaf(raw[warp][d], raw[warp][d], ss);
    ss = warp_sum(ss);
    if (lane == 0) rn[warp] = 1.0f / sqrtf(__fdiv_rn(ss, (float)D) + eps);
  }
  __syncthreads();
  for (int i = tid; i < (G + 1) * D; i += blockDim.x) {
    const int which = i / D, d = i % D;
    const float* w = which < G ? qn : kn;
    const int dp = d < D / 2 ? d + D / 2 : d - D / 2;
    const float r = rn[which];
    const float xd = rbf(__fmul_rn(__fmul_rn(raw[which][d], r), w[d]));
    const float xp = rbf(__fmul_rn(__fmul_rn(raw[which][dp], r), w[dp]));
    const float rot = d < D / 2 ? -xp : xp;
    const float y = rbf(__fadd_rn(rbf(__fmul_rn(xd, bf(cosr[d]))), rbf(__fmul_rn(rot, bf(sinr[d])))));
    // the talker form scales q before the dot
    qk[which][d] = (!CP && which < G) ? __fmul_rn(y, scale) : y;
  }
  __syncthreads();
  const size_t head = ((size_t)b * NKV + kvh) * T;  // this (row, kv head)'s first cache row
  KV* kbase = kc + head * D;
  KV* vbase = vc + head * D;
  if (KVQ) {
    if (warp < 2) {  // warp 0: the k row's scale, warp 1: the v row's
      const float* src = warp == 0 ? qk[G] : raw[G + 1];
      float m = 0.f;
      for (int d = lane; d < D; d += 32) m = fmaxf(m, fabsf(src[d]));
      m = warp_max(m);
      if (lane == 0) qscale[warp] = fmaxf(__fmul_rn(m, 1.0f / 127.0f), 1e-12f);
    }
    __syncthreads();
    if (in_range) {
      for (int d = tid; d < D; d += blockDim.x) {
        kbase[(size_t)pos * D + d] = (int8_t)__float2int_rn(__fdiv_rn(qk[G][d], qscale[0]));
        vbase[(size_t)pos * D + d] = (int8_t)__float2int_rn(__fdiv_rn(raw[G + 1][d], qscale[1]));
      }
      if (tid == 0) {
        ksc[head + pos] = qscale[0];
        vsc[head + pos] = qscale[1];
      }
    }
  } else if (in_range) {
    for (int d = tid; d < D; d += blockDim.x) {
      // k is stored after rope (its unscaled value sits in qk[G])
      kbase[(size_t)pos * D + d] = __float2bfloat16_rn(qk[G][d]);
      vbase[(size_t)pos * D + d] = __float2bfloat16_rn(raw[G + 1][d]);
    }
  }
  if (tid < G) {
    m_run[tid] = -CUDART_INF_F;
    l_run[tid] = 0.f;
  }
  __syncthreads();  // the new row is visible to the whole block

  const float* ksr = KVQ ? ksc + head : nullptr;
  const float* vsr = KVQ ? vsc + head : nullptr;
  // thread tid owns outputs i = tid + j * ATTN_THREADS of the [G, D] block
  float acc[ATTN_OWN];
#pragma unroll
  for (int j = 0; j < ATTN_OWN; ++j) acc[j] = 0.f;
  // rows read from the cache: the prefix, and the new row but on an int8 cache
  const int n = !in_range ? 0 : KVQ ? pos : pos + 1;
  const int TS = min(n, ATTN_TILE);
  for (int t0 = 0; t0 < n; t0 += ATTN_TILE) {
    const int nt = min(ATTN_TILE, n - t0);
    for (int t = warp; t < nt; t += ATTN_THREADS / 32) {
      const KV* kr = kbase + (size_t)(t0 + t) * D + lane * 4;
      const float k0 = to_f(kr[0]), k1 = to_f(kr[1]), k2 = to_f(kr[2]), k3 = to_f(kr[3]);
      for (int g = 0; g < G; ++g) {
        const float* q = qk[g] + lane * 4;
        float a = q[0] * k0;
        a = fmaf(q[1], k1, a);
        a = fmaf(q[2], k2, a);
        a = fmaf(q[3], k3, a);
        a = warp_sum(a);
        if (lane == 0) sc[g * TS + t] = CP ? __fmul_rn(a, scale) : KVQ ? __fmul_rn(a, ksr[t0 + t]) : a;
      }
    }
    __syncthreads();
    if (warp < G) {  // warp g folds head g's tile into its running max and sum
      float* s = sc + warp * TS;
      float m = -CUDART_INF_F;
      for (int t = lane; t < nt; t += 32) m = fmaxf(m, s[t]);
      const float m_new = fmaxf(m_run[warp], warp_max(m));
      float l = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float e = expf(s[t] - m_new);
        s[t] = KVQ ? __fmul_rn(e, vsr[t0 + t]) : e;  // int8: the V scale joins the weights
        l += e;
      }
      l = warp_sum(l);
      if (CP)  // single tile: l is the whole sum
        for (int t = lane; t < nt; t += 32) s[t] = rbf(__fdiv_rn(s[t], l));
      if (lane == 0) {
        const float a = expf(m_run[warp] - m_new);  // 0 on the first tile
        alpha[warp] = a;
        l_run[warp] = fmaf(l_run[warp], a, l);
        m_run[warp] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ATTN_OWN; ++j) {
      const int i = tid + j * ATTN_THREADS;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        float a = acc[j] * alpha[g];
        for (int t = 0; t < nt; ++t) a = fmaf(sc[g * TS + t], to_f(vbase[(size_t)(t0 + t) * D + d]), a);
        acc[j] = a;
      }
    }
    __syncthreads();  // the next tile overwrites sc
  }
  if (KVQ) {  // the current token, with its own (unquantized) k and v
    if (warp < G) {
      const float* q = qk[warp] + lane * 4;
      const float* k = qk[G] + lane * 4;
      float a = q[0] * k[0];
      a = fmaf(q[1], k[1], a);
      a = fmaf(q[2], k[2], a);
      a = fmaf(q[3], k[3], a);
      a = warp_sum(a);
      if (lane == 0) {
        const float m_f = fmaxf(m_run[warp], a);
        const float al = expf(m_run[warp] - m_f);
        const float p = expf(a - m_f);
        alpha[warp] = al;
        p_cur[warp] = p;
        l_run[warp] = fmaf(l_run[warp], al, p);
        m_run[warp] = m_f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ATTN_OWN; ++j) {
      const int i = tid + j * ATTN_THREADS;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        acc[j] = fmaf(p_cur[g], raw[G + 1][d], acc[j] * alpha[g]);
      }
    }
  }
  out += (size_t)b * NQ * D;
  float mx = 0.f;
#pragma unroll
  for (int j = 0; j < ATTN_OWN; ++j) {
    const int i = tid + j * ATTN_THREADS;
    if (i < G * D) {
      const int g = i / D, d = i % D;
      const bf16 o = __float2bfloat16_rn(CP ? acc[j] : __fdiv_rn(acc[j], l_run[g]));
      out[(kvh * G + g) * D + d] = o;
      mx = fmaxf(mx, fabsf(bf(o)));
    }
  }
  if (amax_out) {
    mx = warp_max(mx);
    if (lane == 0) atomic_amax(amax_out + b, mx);
  }
}

// ---------------------------------------------------------------------------
// The sampler: one block per row, over a vocabulary of up to 4096 ids.
// Finishes the head GEMV (logits = ``mv_out``, f32), then: + suppress mask
// (shared by the rows), repetition penalty (l < 0 ? l * rep : l / rep over
// the row's ``seen``), and either argmax (greedy) or EOS save, exact top-k
// (radix select on the ordered float bits), top-p (``top_p_stage``), EOS
// restore, z * inv_t + Gumbel noise on the row's stream, argmax. Ties go to
// the lowest id. With ``emb`` the block then copies row ``code`` (or the
// forced code) of emb [V, H] to the row's x_next and adds it to its esum
// (f32). With ``rows`` (per-request sampling) row b takes its own rep,
// greedy, inv_t, top_k and top_p_thr from rows[b][0..4] (f32; top_k
// truncated to an int) in place of the scalars: the host derives them as
// it derives the scalars, so a row samples as a scalar call with its
// values would.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t float_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

struct SampleArgs {
  const float* supp;     // [V] additive mask, or null
  const uint8_t* seen;   // [B, V], or null
  float rep;
  int greedy;
  float inv_t;
  int top_k, eos_id;
  uint32_t seed0, seed1, stream;  // row b draws from stream + STREAMS_PER_ROW * b
  int* code_out;         // row b's code at code_out[b * code_stride]
  int code_stride;
  float* logits_out;     // row b's logits at logits_out + b * logits_stride, or null
  int logits_stride;
  const int* force_code; // row b's forced code at force_code[b * force_stride], or null
  int force_stride;
  const bf16* emb;       // [V, H] table whose sampled row feeds the next position, or null
  int H;
  bf16* x_next;          // [B, H]
  float* esum;           // [B, H]
  const float* amax;     // dyn_int8 head (sample_kernel): row b's input amax at amax[b], else null
  int cp_head;           // dyn_int8: (f32(acc) * s) * scale (CP heads), else f32(acc) * (s * scale)
  float top_p_thr;       // top-p: keep a token iff its cumulative mass > this (f32(1 - p)); 0: off
  int ref_exact;         // top-p mass exp(z) unnormalized (the reference's), else softmax(z)
  const float* rows;     // [B][SAMPLE_ROW_VALUES] per-row rep, greedy, inv_t, top_k, top_p_thr,
                         // or null (the scalars above); with rows, top_p_thr is their largest
};

// Top-p on a row held in registers (PT values a thread, id
// tid + i * blockDim.x), after top-k: mass m_i = softmax(z)_i, or exp(z_i)
// with ``ref_exact``; ids in ascending order of (z, id), the stable
// ascending argsort; keep an id iff the cumulative mass up to and including
// it is > ``thr``, drop the rest to NEG_BIG. Ids of zero mass lie at the
// bottom of that order with a cumulative mass of 0 and are dropped without
// being sorted. The ids of positive mass (at most k with top-k on, the whole
// row with it off) are compacted into shared memory as 64-bit keys (ordered
// float bits, id) and sorted by a block-wide bitonic sort; a block scan
// then sums the mass in f32 in the ascending order (PT consecutive ranks a
// thread, then warp and block prefix sums: the terms of jnp.cumsum, in
// another association), and the kept ids are the ranks from the first whose
// cumulative mass exceeds thr up (a suffix of the order, as the sequential
// sum gives). The mass of an id is recomputed from its sorted key with the
// same operations, so the two agree to the bit. The stage is the TOPP
// instance of ``sample_kernel`` (``launch_sampler`` picks it when the stage
// is on) with its keys in dynamic shared memory, so the sampler without
// top-p is the kernel it was, registers and shared memory alike.

__device__ __forceinline__ float top_p_mass(float z, float m, float sum, int ref_exact) {
  return ref_exact ? expf(z) : __fdiv_rn(expf(z - m), sum);
}

template <int PT>
__device__ void top_p_stage(float (&z)[PT], const bool (&valid)[PT], float thr, int ref_exact,
                            float* red, unsigned long long* keys) {
  __shared__ int n_sh, first_sh;
  __shared__ float scan[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float m = 0.f, sum = 1.f;
  if (!ref_exact) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < PT; ++i)
      if (valid[i]) mx = fmaxf(mx, z[i]);
    m = block_max(mx, red);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PT; ++i)
      if (valid[i]) s += expf(z[i] - m);
    sum = block_sum(s, red);
  }
  if (tid == 0) n_sh = 0;
  __syncthreads();
  float mass[PT];
  unsigned long long key[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    mass[i] = valid[i] ? top_p_mass(z[i], m, sum, ref_exact) : 0.f;
    // + 0.f: -0 and +0 compare equal and take the id order
    key[i] = (unsigned long long)float_key(z[i] + 0.f) << 32 | (uint32_t)(tid + i * blockDim.x);
    if (mass[i] > 0.f) keys[atomicAdd(&n_sh, 1)] = key[i];
  }
  __syncthreads();
  const int n = n_sh;
  int N = 1;
  while (N < n) N <<= 1;
  for (int i = n + tid; i < N; i += blockDim.x) keys[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < N; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = keys[i], b = keys[p];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  // ranks PT tid .. PT tid + PT - 1: local cumulative mass, then the block's prefix
  float cum[PT];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int r = tid * PT + i;
    if (r < n) run += top_p_mass(key_float((uint32_t)(keys[r] >> 32)), m, sum, ref_exact);
    cum[i] = run;
  }
  float incl = run;  // inclusive warp scan of the thread totals
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) scan[warp] = incl;
  if (tid == 0) first_sh = n;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    float w = lane < nw ? scan[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    if (lane < nw) scan[lane] = w;  // inclusive over the warps
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);  // the warp's exclusive prefix
  if (lane == 0) excl = 0.f;
  __syncthreads();
  const float before = (warp ? scan[warp - 1] : 0.f) + excl;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int r = tid * PT + i;
    if (r < n && before + cum[i] > thr) {
      atomicMin(&first_sh, r);
      break;
    }
  }
  __syncthreads();
  const int first = first_sh;
  const unsigned long long kmin = first < n ? keys[first] : ~0ull;
#pragma unroll
  for (int i = 0; i < PT; ++i)
    if (valid[i] && !(mass[i] > 0.f && first < n && key[i] >= kmin)) z[i] = NEG_BIG;
}

// Row b of the sampler in one block (up to PT ids a thread, V <= PT x
// blockDim.x): ``logit(c)`` gives the row's f32 logit of id c (the head
// GEMV's output); ``top_p_keys``: next_pow2(V) keys of shared memory (TOPP).
template <bool TOPP, int PT, typename Logit>
__device__ void sample_block(int V, const SampleArgs& a, int b, unsigned long long* top_p_keys,
                             Logit logit) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  __shared__ uint32_t hist[256];
  __shared__ uint32_t sel[2];
  __shared__ float eos_logit;
  __shared__ int code_sh;
  const int tid = threadIdx.x;
  const uint8_t* seen = a.seen ? a.seen + (size_t)b * V : nullptr;
  float* logits_out = a.logits_out ? a.logits_out + (size_t)b * a.logits_stride : nullptr;
  const uint32_t key = stream_key(a.seed0, a.seed1, a.stream + STREAMS_PER_ROW * (uint32_t)b);
  float rep = a.rep, inv_t = a.inv_t, thr = a.top_p_thr;
  int greedy = a.greedy, top_k = a.top_k;
  if (a.rows) {
    const float* r = a.rows + (size_t)b * SAMPLE_ROW_VALUES;
    rep = r[0], greedy = r[1] != 0.f, inv_t = r[2], top_k = (int)r[3], thr = r[4];
  }
  float z[PT];
  bool valid[PT];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int c = tid + i * blockDim.x;
    valid[i] = c < V;
    float v = -CUDART_INF_F;
    if (valid[i]) {
      v = logit(c);
      if (logits_out) logits_out[c] = v;
      if (a.supp) v = __fadd_rn(v, a.supp[c]);
      if (seen && rep != 1.0f && seen[c]) v = v < 0.f ? __fmul_rn(v, rep) : __fdiv_rn(v, rep);
      if (c == a.eos_id) eos_logit = v;
    }
    z[i] = v;
  }
  if (!greedy) {
    if (top_k > 0 && top_k < V) {
      uint32_t keys[PT];
#pragma unroll
      for (int i = 0; i < PT; ++i) keys[i] = float_key(z[i]);
      uint32_t prefix = 0, mask = 0;
      int kk = top_k;
      for (int shift = 24; shift >= 0; shift -= 8) {
        for (int bin = tid; bin < 256; bin += blockDim.x) hist[bin] = 0;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < PT; ++i)
          if (valid[i] && (keys[i] & mask) == prefix) atomicAdd(&hist[(keys[i] >> shift) & 255u], 1u);
        __syncthreads();
        if (tid < 32) {  // the highest digit d >= 1 whose bins from d up hold kk, else 0
          const int hi = 255 - 8 * tid;  // lane tid scans bins hi .. hi - 7, lane 0 the top
          uint32_t v[8], sum = 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            v[i] = hist[hi - i];
            sum += v[i];
          }
          uint32_t incl = sum;  // the bins from hi - 7 up
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
            if (tid >= o) incl += t;
          }
          const unsigned hit = __ballot_sync(0xffffffffu, incl >= (uint32_t)kk);
          if (tid == (hit ? __ffs(hit) - 1 : 31)) {
            uint32_t cum = incl - sum;  // the bins above hi
            int d = hi;
            for (int i = 0; i < 8 && d > 0 && cum + v[i] < (uint32_t)kk; ++i, --d) cum += v[i];
            sel[0] = prefix | ((uint32_t)d << shift);
            sel[1] = (uint32_t)kk - cum;
          }
        }
        __syncthreads();
        prefix = sel[0];
        kk = (int)sel[1];
        mask |= 0xFFu << shift;
      }
      const float kth = key_float(prefix);
#pragma unroll
      for (int i = 0; i < PT; ++i)
        if (valid[i] && !(z[i] >= kth)) z[i] = NEG_BIG;
    }
    // a row whose stage is off skips it in the TOPP instance too (block-uniform):
    // at threshold 0 the stage would still drop an id whose f32 mass is 0
    if (TOPP && thr > 0.f) top_p_stage(z, valid, thr, a.ref_exact, redf, top_p_keys);
    __syncthreads();  // eos_logit
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int c = tid + i * blockDim.x;
      if (!valid[i]) continue;
      if (c == a.eos_id) z[i] = eos_logit;
      const uint32_t bits = mix32(mix32((uint32_t)c) ^ key);
      const float u = __fadd_rn(__fmul_rn((float)(bits & 0xFFFFFFu), 5.9604644775390625e-08f),
                                2.98023223876953125e-08f);
      const float gumbel = -logf(-logf(u));
      z[i] = __fadd_rn(__fmul_rn(z[i], inv_t), gumbel);
    }
  }
  float bv = -CUDART_INF_F;
  int bi = 0x7fffffff;
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const int c = tid + i * blockDim.x;
    if (valid[i] && better(z[i], c, bv, bi)) {
      bv = z[i];
      bi = c;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((tid & 31) == 0) {
    redf[tid >> 5] = bv;
    redi[tid >> 5] = bi;
  }
  __syncthreads();
  if (tid < 32) {
    const int nw = blockDim.x >> 5;
    bv = tid < nw ? redf[tid] : -CUDART_INF_F;
    bi = tid < nw ? redi[tid] : 0x7fffffff;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (tid == 0) {
      // no winner only when every score is NaN: take id 0, as argmax does,
      // so that the embedding gather below stays inside the table
      if (bi >= V) bi = 0;
      a.code_out[(size_t)b * a.code_stride] = bi;
      code_sh = a.force_code ? a.force_code[(size_t)b * a.force_stride] : bi;
    }
  }
  if (a.emb == nullptr) return;
  __syncthreads();
  const bf16* row = a.emb + (size_t)code_sh * a.H;
  bf16* x_next = a.x_next + (size_t)b * a.H;
  float* esum = a.esum + (size_t)b * a.H;
  for (int c = tid; c < a.H; c += blockDim.x) {
    const bf16 e = row[c];
    x_next[c] = e;
    esum[c] = __fadd_rn(esum[c], bf(e));
  }
}

// One block per row b of the head GEMV's splits ([splits][B][V]), the
// logits finished as ``mv_out`` does (the code predictor's dyn_int8 heads:
// (f32(acc) * s) * scale)
template <bool TOPP>
__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_kernel(const float* __restrict__ part, int splits, const Mat head, int V, SampleArgs a) {
  extern __shared__ unsigned long long top_p_keys[];  // TOPP: next_pow2(V) keys
  const int b = blockIdx.x, stride = gridDim.x * V, prow = b * V;
  const float s_act = a.amax ? act_scale(a.amax[b]) : 0.f;
  sample_block<TOPP, SAMPLE_PER_THREAD>(V, a, b, top_p_keys, [&](int c) {
    return a.amax && a.cp_head
               ? __fmul_rn(__fmul_rn(split_isum(part, splits, stride, prow + c), s_act),
                           col_scale(head, c))
               : mv_out(part, splits, stride, prow + c, head, c, s_act);
  });
}

// One sampler launch for B rows: the top-p instance (its keys in
// next_pow2(V) x 8 bytes of dynamic shared memory) when a.top_p_thr > 0
// (with per-row values: when any row has the stage on).
inline void launch_sampler(const float* part, int splits, const Mat& head, int V,
                           const SampleArgs& a, int B, cudaStream_t st) {
  if (a.top_p_thr > 0.f) {
    size_t n = 1;
    while (n < (size_t)V) n <<= 1;
    sample_kernel<true><<<B, SAMPLE_THREADS, n * sizeof(unsigned long long), st>>>(part, splits,
                                                                                   head, V, a);
  } else {
    sample_kernel<false><<<B, SAMPLE_THREADS, 0, st>>>(part, splits, head, V, a);
  }
}

// One transformer layer of one token per row through the kernels above; the
// residual stream is ``h`` [B, H] and ``xn`` holds rms(h, input_layernorm)
// on entry and rms(h, next_norm) on return. The four matmul weights are
// int8 with their scales, or bf16 with none. ``amax`` (dyn_int8, int8
// weights): the [AMAX_SLOTS][B] activation amax slots, the first holding
// xn's on entry (and on return); null in the weight-only modes.

struct LayerW {
  Mat qkv, o, gu, d;
  const float *pln, *qn, *kn;
};

template <bool CP, bool KVQ>
inline int layer_step(const LayerW& w, const float* next_norm, int B, int H, int NQ, int NKV,
                      int I, float eps, float scale, const bf16* cosr, const bf16* sinr,
                      int rope_stride, const AttnCache& cache, int pos, const int* offs,
                      bf16* h, bf16* xn, bf16* attn, bf16* gated, float* ws, float* amax,
                      cudaStream_t st) {
  const int D = HEAD_DIM;
  float* a_xn = amax;                           // xn's amax (row-owning kernels write it)
  float* a_attn = amax ? amax + B : nullptr;    // the attention output's (atomic)
  float* a_gated = amax ? amax + 2 * B : nullptr;  // the SwiGLU output's (atomic)
  int s = gemv(w.qkv, xn, B, ws, H, (NQ + 2 * NKV) * D, a_xn, st);
  QT_CHECK_LAUNCH();
  // score tile: the rows read from the cache, up to ATTN_TILE (all of it
  // when the rows' positions live on the device)
  const int rows = offs ? ATTN_TILE : min(max(KVQ ? pos : pos + 1, 1), ATTN_TILE);
  attn_step<CP, KVQ>
      <<<dim3(NKV, B), ATTN_THREADS, (NQ / NKV) * rows * sizeof(float), st>>>(
      ws, s, w.qkv, a_xn, w.qn, w.kn, eps, cosr, sinr, rope_stride,
      (typename std::conditional<KVQ, int8_t, bf16>::type*)cache.k,
      (typename std::conditional<KVQ, int8_t, bf16>::type*)cache.v, cache.ks, cache.vs, cache.T,
      pos, offs, NQ, NKV, scale, attn, a_attn);
  QT_CHECK_LAUNCH();
  s = gemv(w.o, attn, B, ws, NQ * D, H, a_attn, st);
  QT_CHECK_LAUNCH();
  finish_residual_norm<<<B, 1024, 0, st>>>(ws, s, w.o, a_attn, h, nullptr, w.pln, xn, H, eps,
                                           a_xn);
  QT_CHECK_LAUNCH();
  s = gemv(w.gu, xn, B, ws, H, 2 * I, a_xn, st);
  QT_CHECK_LAUNCH();
  finish_swiglu<<<dim3((I + 255) / 256, B), 256, 0, st>>>(ws, s, w.gu, a_xn, I, gated, a_gated);
  QT_CHECK_LAUNCH();
  s = gemv(w.d, gated, B, ws, I, H, a_gated, st);
  QT_CHECK_LAUNCH();
  finish_residual_norm<<<B, 1024, 0, st>>>(ws, s, w.d, a_gated, h, nullptr, next_norm, xn, H, eps,
                                           a_xn);
  QT_CHECK_LAUNCH();
  return 0;
}

// The stacked layer weights, as (weight, scale) pairs: fused (q = qkv,
// g = gate_up; k, v and u null) or unfused (q, k, v, gate, up apart).
struct StackW {
  const void *q, *qs, *k, *ks, *v, *vs, *o, *os, *g, *gs, *u, *us, *d, *ds;
};

// Layer l's slices of the stacked weights: int8 [L, in, out] with f32
// scales [L, out], or bf16 [L, in, out] (``wbf16``; the scales are ignored).
__host__ __device__ inline LayerW layer_weights(int l, int H, int NQ, int NKV, int I, bool wbf16, const StackW& s,
                            const void* pln, const void* qn, const void* kn) {
  const int D = HEAD_DIM;
  LayerW w;
  w.qkv = w.o = w.gu = w.d = mat(wbf16);
  if (s.k) {
    add_seg(w.qkv, s.q, s.qs, l, H, NQ * D);
    add_seg(w.qkv, s.k, s.ks, l, H, NKV * D);
    add_seg(w.qkv, s.v, s.vs, l, H, NKV * D);
  } else {
    add_seg(w.qkv, s.q, s.qs, l, H, (NQ + 2 * NKV) * D);
  }
  add_seg(w.o, s.o, s.os, l, NQ * D, H);
  if (s.u) {
    add_seg(w.gu, s.g, s.gs, l, H, I);
    add_seg(w.gu, s.u, s.us, l, H, I);
  } else {
    add_seg(w.gu, s.g, s.gs, l, H, 2 * I);
  }
  add_seg(w.d, s.d, s.ds, l, I, H);
  w.pln = (const float*)pln + (size_t)l * H;
  w.qn = (const float*)qn + (size_t)l * D;
  w.kn = (const float*)kn + (size_t)l * D;
  return w;
}

// Whether every present weight of the stack has its scales (int8), and the
// unfused parts come whole (k with v, and up with k).
inline bool stack_ok(const StackW& s, bool wbf16) {
  auto ok = [&](const void* w, const void* sc) { return w == nullptr || wbf16 || sc != nullptr; };
  return s.q && s.o && s.g && s.d && (s.k == nullptr) == (s.v == nullptr) &&
         (s.k == nullptr) == (s.u == nullptr) && ok(s.q, s.qs) && ok(s.k, s.ks) &&
         ok(s.v, s.vs) && ok(s.o, s.os) && ok(s.g, s.gs) && ok(s.u, s.us) && ok(s.d, s.ds);
}

// ---------------------------------------------------------------------------
// The persistent B = 1 kernels' building blocks (K2's ``cp_frame`` in
// cp_loop.cu, K1's ``talker_frame`` in talker_frame.cu): one cooperative
// launch of one block of PF_THREADS threads per SM that walks its phases
// with a grid-wide barrier between dependent ones. A GEMV is split into
// tiles of PF_TILE output columns over one split of the rows; each block
// takes its share of the tiles (``frame_tiles``) and writes f32 (or int32)
// partials that the next phase's prologue, recomputed in every block,
// stages from the L2 and finishes. See cp_loop.cu's note for the design
// and what it measured.
// ---------------------------------------------------------------------------
constexpr int PF_THREADS = 512;             // one block per SM
constexpr int PF_WARPS = PF_THREADS / 32;
constexpr int PF_TILE = 32;                 // output columns of a tile
constexpr int PF_ROUND = 4;                 // tiles a block works on at once
constexpr int PF_MIN_ROWS = 64;             // the shortest split of a GEMV's rows
constexpr int PF_LOADS = 8;                 // 16-byte weight loads a thread has in flight
constexpr int PF_MAX_SPLIT = 32;            // a partial buffer holds 32 x O floats
// ids a thread of the sampler (block 0) past 2048 ids: the multi-launch
// form's vocabulary limit, SAMPLE_THREADS x SAMPLE_PER_THREAD = 4096, at
// PF_THREADS
constexpr int PF_SAMPLE_PER_THREAD = SAMPLE_THREADS * SAMPLE_PER_THREAD / PF_THREADS;
static_assert(2 * PF_MAX_SPLIT <= GEMV_MAX_SPLIT, "two partial buffers in the B = 1 workspace");

__host__ __device__ inline int frame_split(int K, int O, int blocks, int& rows) {
  const int tiles = (O + PF_TILE - 1) / PF_TILE;
  int S = max(1, (blocks + tiles / 2) / tiles);
  S = max(1, min(min(S, PF_MAX_SPLIT), K / PF_MIN_ROWS));
  rows = (K + S - 1) / S;
  rows = (rows + 15) / 16 * 16;
  return (K + rows - 1) / rows;
}

// One GEMV of the frame: its weight, rows K, outputs O, S splits of
// ``rows`` rows, and what it is (G_*).
enum { G_QKV = 0, G_O = 1, G_GU = 2, G_DOWN = 3, G_HEAD = 4, G_PROJ = 5 };

struct Gemv {
  Mat m;
  int K, O, S, rows, kind;
};

__host__ __device__ inline int up4(int x) { return (x + 3) / 4 * 4; }

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The grid-wide barrier: after the block's own barrier, thread 0 adds one
// to the arrival count with release semantics and polls it with acquire
// loads until it reaches ``target`` (barriers so far x blocks); the block's
// barrier then passes what thread 0 acquired to its other threads. (An
// H100 measured 0.64 ms for a frame's 346 barriers this way, 0.87 ms with a
// fence on each side and relaxed polling.) False, in every thread of the
// block, if the error word is set or the wait ran past the budget (which
// sets both error words): the caller leaves the kernel. ``bar``: [0] the
// arrivals, [1] the error word, zeroed before the launch; ``err_host``: a
// mapped host word set when a wait ran past ``budget_ns``.
__device__ bool grid_barrier(unsigned* bar, int* err_host, unsigned long long budget_ns,
                             unsigned target) {
  __shared__ int ok_sh;
  __syncthreads();
  if (threadIdx.x == 0) {
    red_release_add(bar, 1u);
    int ok = 1;
    if (ld_acquire(bar) < target) {
      const unsigned long long t0 = global_ns();
      while (ld_acquire(bar) < target) {
        if (ld_relaxed(bar + 1)) {
          ok = 0;
          break;
        }
        if (global_ns() - t0 > budget_ns) {
          atomicExch(bar + 1, 1u);
          *(volatile int*)err_host = 1;
          __threadfence_system();
          ok = 0;
          break;
        }
      }
    }
    ok_sh = ok;
  }
  __syncthreads();
  return ok_sh != 0;
}

// This block's tiles of a GEMV: [t0, t1) of S x ceil(O / 32)
__device__ __forceinline__ void frame_tiles(const Gemv& g, int& t0, int& t1) {
  const unsigned nt = g.S * ((g.O + PF_TILE - 1) / PF_TILE);  // nt x blocks < 2^32
  t0 = (int)(nt * blockIdx.x / gridDim.x);
  t1 = (int)(nt * (blockIdx.x + 1) / gridDim.x);
}

// 16 bytes from global to shared memory through the L2 (``cp.async.cg``:
// coherent with other blocks' writes before the last barrier), no registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(__cvta_generic_to_global(gmem))
               : "memory");
}

// Reduce-scatter of E values over the lanes that differ in bits O, O/2, ...:
// at each step a lane keeps the half its bit selects and adds its partner's;
// after log2(E) steps acc[0] holds one value, the one of index (lane / U)
// with U = 32 / E, summed over those lanes.
template <int N, int O, typename T, int E>
__device__ __forceinline__ void frame_reduce(T (&acc)[E], int lane) {
  if constexpr (N >= 1) {
    const bool hi = lane & O;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T send = hi ? acc[i] : acc[i + N];
      const T keep = hi ? acc[i + N] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    frame_reduce<N / 2, O / 2>(acc, lane);
  }
}

template <typename T>
__device__ __forceinline__ T lane_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of weights widened to f32, exactly: int8 through the bits of
// 2^23 + (b + 128) (a byte permute and one subtract each, where the
// conversion instruction runs at a quarter of the FMA rate), bf16 by a shift
__device__ __forceinline__ void widen(const int4& w, float (&f)[16]) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = u[i] ^ 0x80808080u;  // b + 128 in each byte
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __int_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + j)) - 8388736.0f;
  }
}
__device__ __forceinline__ void widen(const int4& w, float (&f)[8]) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

// This block's tiles of GEMV g into ``part`` ([S][O]), up to PF_ROUND tiles
// at once (PF_WARPS / n warps each). W: int8 or bf16 weights times x
// (``xs``, f32 of bf16 values) in f32; DQ: int8 weights times x quantized
// (``xq``, words of 4 int8) in exact int32. Lane l takes the 16-byte column
// unit l % U of the tile (EPL columns) and every EPL-th row (DQ: group of 4
// rows) of the warp's share of the split, PF_LOADS loads in flight at once
// (a loop of one load an iteration waited one L2 round trip each).
// PIPE (K1's step; weight-only forms): batches of PF_LOADS / 2 rows, the
// next batch's loads issued before this one's multiply-adds, so that a
// split of many batches keeps loads in flight through its arithmetic.
template <typename W, bool DQ, bool PIPE = false>
__device__ void frame_gemv_tiles(const Gemv& g, const float* xs, const int* xq, float* part,
                                 float* red) {
  constexpr int EPL = DQ ? 16 : 16 / (int)sizeof(W);
  constexpr int U = PF_TILE / EPL;
  using Acc = typename std::conditional<DQ, int, float>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = (g.O + PF_TILE - 1) / PF_TILE;
  const int u = lane % U, sub = lane / U;
  Acc* redv = reinterpret_cast<Acc*>(red);
  int t0, t1;
  frame_tiles(g, t0, t1);
  for (int base = t0; base < t1; base += PF_ROUND) {
    const int nr = min(PF_ROUND, t1 - base), WPT = PF_WARPS / nr;
    const int tl = warp / WPT, wl = warp % WPT;
    Acc acc[EPL];
#pragma unroll
    for (int j = 0; j < EPL; ++j) acc[j] = 0;
    if (tl < nr) {
      const int ti = base + tl, split = ti / ct;
      const int c = (ti % ct) * PF_TILE + u * EPL;
      const int r0 = split * g.rows, r1 = min(g.K, r0 + g.rows);
      if (c < g.O) {
        int ld;
        if constexpr (DQ) {  // PF_LOADS / 4 groups of 4 rows a batch
          const int8_t* wc = wcol<int8_t>(g.m, c, ld);
          const int step = EPL * WPT;
          for (int q0 = r0 / 4 + sub + EPL * wl; q0 < r1 / 4; q0 += PF_LOADS / 4 * step) {
            int4 w[PF_LOADS / 4][4];
#pragma unroll
            for (int j = 0; j < PF_LOADS / 4; ++j) {
              const int q = q0 + j * step;
              const int8_t* pw = wc + (size_t)(4 * q) * ld;
#pragma unroll
              for (int k = 0; k < 4; ++k)
                w[j][k] = q < r1 / 4 ? __ldg(reinterpret_cast<const int4*>(pw + (size_t)k * ld))
                                     : make_int4(0, 0, 0, 0);
            }
#pragma unroll
            for (int j = 0; j < PF_LOADS / 4; ++j) {
              const int q = q0 + j * step;
              if (q >= r1 / 4) break;  // the same for the warp's lanes
              int cols[16];
              transpose_4x16(w[j], cols);
              const int xw = xq[q];
#pragma unroll
              for (int k = 0; k < 16; ++k) acc[k] = __dp4a(cols[k], xw, acc[k]);
            }
          }
        } else if constexpr (PIPE) {
          constexpr int NB = PF_LOADS / 2;  // rows a batch
          const W* wc = wcol<W>(g.m, c, ld);
          const int step = EPL * WPT;
          int4 w[NB];
          auto load = [&](int rb, int4 (&dst)[NB]) {
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const int r = rb + j * step;
              dst[j] = r < r1 ? __ldg(reinterpret_cast<const int4*>(wc + (size_t)r * ld))
                              : make_int4(0, 0, 0, 0);
            }
          };
          int r00 = r0 + sub + EPL * wl;
          load(r00, w);
          for (; r00 < r1; r00 += NB * step) {
            int4 wn[NB];
            load(r00 + NB * step, wn);  // past the split: no load, zeros
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const int r = r00 + j * step;
              if (r >= r1) break;  // the same for the warp's lanes (splits of whole 16-row steps)
              const float xv = xs[r];
              float wf[EPL];
              widen(w[j], wf);
#pragma unroll
              for (int k = 0; k < EPL; ++k) acc[k] = fmaf(xv, wf[k], acc[k]);
            }
#pragma unroll
            for (int j = 0; j < NB; ++j) w[j] = wn[j];
          }
        } else {  // PF_LOADS rows a batch
          const W* wc = wcol<W>(g.m, c, ld);
          const int step = EPL * WPT;
          for (int r00 = r0 + sub + EPL * wl; r00 < r1; r00 += PF_LOADS * step) {
            int4 w[PF_LOADS];
#pragma unroll
            for (int j = 0; j < PF_LOADS; ++j) {
              const int r = r00 + j * step;
              w[j] = r < r1 ? __ldg(reinterpret_cast<const int4*>(wc + (size_t)r * ld))
                            : make_int4(0, 0, 0, 0);
            }
#pragma unroll
            for (int j = 0; j < PF_LOADS; ++j) {
              const int r = r00 + j * step;
              if (r >= r1) break;  // the same for the warp's lanes (splits of whole 16-row steps)
              const float xv = xs[r];
              float wf[EPL];
              widen(w[j], wf);
#pragma unroll
              for (int k = 0; k < EPL; ++k) acc[k] = fmaf(xv, wf[k], acc[k]);
            }
          }
        }
      }
    }
    frame_reduce<EPL / 2, 16>(acc, lane);  // acc[0]: column u * EPL + sub of the tile
    redv[warp * 33 + lane] = acc[0];
    __syncthreads();
    for (int o = warp; o < nr * 32; o += PF_WARPS) {  // (tile o / 32, lane column o % 32)
      const int tl2 = o / 32, lc = o % 32;
      Acc v = lane < WPT ? redv[(tl2 * WPT + lane) * 33 + lc] : (Acc)0;
      v = lane_sum(v);
      const int ti = base + tl2;
      const int col = (ti % ct) * PF_TILE + (lc % U) * EPL + lc / U;
      if (lane == 0 && col < g.O) reinterpret_cast<Acc*>(part)[(size_t)(ti / ct) * g.O + col] = v;
    }
    __syncthreads();  // red is the next round's
  }
}

// Wait for this thread's copies, then the block's
__device__ __forceinline__ void cp_async_join() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  __syncthreads();
}

// ``bytes`` (a multiple of 16) from global to shared memory, 16 a copy
__device__ __forceinline__ void stage_vec(void* dst, const void* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    cp_async16((char*)dst + 16 * i, (const char*)src + 16 * i);
}

__device__ __forceinline__ float ldcg_bf(const bf16* p) {
  return bf(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// A GEMV's output as the next prologue reads it: its partials ([S][O], f32
// or int32) and column scales (int8 weights; null for bf16) copied into
// shared memory with every copy in flight at once (one L2 round trip; a
// loop of loads into registers took one a load).
struct Staged {
  const float* ps;
  const float* scale;
  int S, O;
};

__device__ Staged frame_stage_start(const Gemv& g, const float* part, float* ps, float* pscale) {
  for (int i = threadIdx.x; i < g.S * g.O / 4; i += blockDim.x) cp_async16(ps + 4 * i, part + 4 * i);
  if (!g.m.wbf16) {
    for (int i = threadIdx.x; i < g.O / 4; i += blockDim.x) {
      const int c = 4 * i, sg = seg_of(g.m, c);
      cp_async16(pscale + c, g.m.s[sg] + (c - seg_start(g.m, sg)));
    }
  }
  return Staged{ps, g.m.wbf16 ? nullptr : pscale, g.S, g.O};
}

__device__ Staged frame_stage(const Gemv& g, const float* part, float* ps, float* pscale) {
  const Staged t = frame_stage_start(g, part, ps, pscale);
  cp_async_join();
  return t;
}

// ``mv_out`` on staged partials: output column c (the same operations)
__device__ __forceinline__ float mvs(const Staged& t, int c, float s) {
  if (s > 0.f) {
    const int* p = reinterpret_cast<const int*>(t.ps);
    int acc = 0;
    for (int k = 0; k < t.S; ++k) acc += p[k * t.O + c];
    return __fmul_rn(__int2float_rn(acc), __fmul_rn(s, t.scale[c]));
  }
  float sum = 0.f;
  for (int k = 0; k < t.S; ++k) sum += t.ps[k * t.O + c];
  return t.scale ? __fmul_rn(sum, t.scale[c]) : sum;
}

// xs = bf16(h * r * nw) with r = 1 / sqrt(mean(h^2) + eps), from each
// thread's share of sum(h^2), nw staged; returns max |xs|.
__device__ float frame_norm(const float* h, float ss, const float* nw, float* xs, int H, float eps,
                            float* red) {
  const float r = 1.0f / sqrtf(__fdiv_rn(block_sum(ss, red), (float)H) + eps);
  float mx = 0.f;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const float o = rbf(__fmul_rn(__fmul_rn(h[c], r), nw[c]));
    xs[c] = o;
    mx = fmaxf(mx, fabsf(o));
  }
  return block_max(mx, red);
}

// finish_residual_norm for this block's copy of the stream: h = bf16(h +
// bf16(y)) (or bf16(bias + bf16(y))), y the staged GEMV output (s: its
// input's dyn_int8 scale, else 0), then xs = rms(h) * nw; returns max |xs|.
__device__ float frame_residual_norm(const Staged& t, float s, const bf16* bias, float* h,
                                     const float* nw, float* xs, int H, float eps, float* red) {
  float ss = 0.f;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const float y = rbf(mvs(t, c, s));
    const float hv = rbf(__fadd_rn(bias ? bf(bias[c]) : h[c], y));
    h[c] = hv;
    ss = fmaf(hv, hv, ss);
  }
  return frame_norm(h, ss, nw, xs, H, eps, red);
}

// finish_swiglu: xs[c] = bf16(g * sigmoid(g) * u) over the I columns; returns max |xs|
__device__ float frame_swiglu(const Staged& t, float s, int I, float* xs, float* red) {
  float mx = 0.f;
  for (int c = threadIdx.x; c < I; c += blockDim.x) {
    const float gg = rbf(mvs(t, c, s));
    const float uu = rbf(mvs(t, I + c, s));
    const float sig = 1.0f / (1.0f + expf(-gg));
    const float o = rbf(__fmul_rn(__fmul_rn(gg, sig), uu));
    xs[c] = o;
    mx = fmaxf(mx, fabsf(o));
  }
  return block_max(mx, red);
}

// dyn_int8: x quantized with the row's scale into words of 4 int8 (x[0] in
// byte 0); returns the scale
__device__ float frame_quant(const float* xs, int K, float amax, int* xq) {
  const float s = act_scale(amax);
  for (int q = threadIdx.x; q < K / 4; q += blockDim.x) {
    const float* v = xs + 4 * q;
    xq[q] = (int)(quant_act(v[0], s) | quant_act(v[1], s) << 8 | quant_act(v[2], s) << 16 |
                  quant_act(v[3], s) << 24);
  }
  return s;
}

// The kv heads whose attention outputs this block's tiles of the o GEMV read
__device__ unsigned o_heads(const Gemv& go, int G) {
  int t0, t1;
  frame_tiles(go, t0, t1);
  if (t0 >= t1) return 0u;
  const int ct = (go.O + PF_TILE - 1) / PF_TILE;
  const int lo = t0 / ct * go.rows, hi = min(go.K, ((t1 - 1) / ct + 1) * go.rows);
  unsigned m = 0u;
  for (int kvh = lo / (G * HEAD_DIM); kvh <= (hi - 1) / (G * HEAD_DIM); ++kvh) m |= 1u << kvh;
  return m;
}

}  // namespace
}  // namespace qt
