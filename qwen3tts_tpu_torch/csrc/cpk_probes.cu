// T2: unit probes of the code predictor kernel's building blocks, for
// Hopper (sm_90a).
//
// Replaces tools/exp_cpk.py's twelve Mosaic lowering probes, one small
// kernel and one C entry each. On the TPU each probe asked whether Mosaic
// lowers one construct; on the card each runs the block that K2
// (csrc/cp_loop.cu, csrc/common.cuh) builds from it, so its answer is an
// output to check and a time per launch:
//
//   p1  (:39, pallas_call :46)  x [1, R*C] f32 -> [R, C] = 2 x, the row
//       staged in shared memory and written as rows;
//   p2  (:51, :61)  s8 x s8 -> s32, x [1, K] . w [K, N]: K2's dyn_int8 dot,
//       qt::transpose_4x16 into column words and __dp4a (exact);
//   p3  (:66, :73), p3a (:170, :178), p3b (:189, :197), p3c (:208, :218)
//       a store of row p of a [16, C] shared-memory scratch (3 x, bf16 or
//       f32; p3c as a select over all rows) and a read back by other
//       threads: row p (p3) or the whole scratch (p3a-c). The scratch
//       starts at zero here, so its other rows read 0 (on the TPU they were
//       never written). Its columns are independent, so each block holds
//       the scratch of 64 of them (16 blocks at C = 1024) and writes it out
//       in 16-byte stores (one block of 2- and 4-byte stores read up to
//       2.14x an empty kernel, queued);
//   p4  (:86, :102), p4a (:229, :239), p4b (:245, :261), p4c (:286, :304)
//       the first index of max(z) (K2's greedy argmax, first-max tie-break)
//       into codes[0] of an int32 [16] output (codes[1:] = 0) and/or the
//       embedding row emb[c] gathered at that index (K2's next input); p4c
//       passes c through a shared-memory scalar;
//   p5  (:124, :131)  the sampler's random bits: the TPU core PRNG cannot be
//       reproduced, so this is the port's counter-based generator,
//       u[c] = (mix32(mix32(c) ^ stream_key(seed, 0, 0)) >> 8) * 2^-24
//       (qt::mix32, ops/decode_blocks.py::counter_bits);
//   p6  (:139, :150)  int8 -> bf16 convert of w [K, N], then the dot with a
//       bf16 x [1, K] in f32.
//
// Bound: p2 and p6 read their weights once (2.1 and 3.1 MB, 0.6 and 0.9 us at
// 3.35 TB/s) behind one launch; the other ten move a few KB and are bound by
// their launch (tools/exp_cpk.py times an empty kernel, ``qt_cpk_empty``,
// beside them). A first p2 split K over blocks behind a separate
// cudaMemsetAsync and finished with int32 atomics in 8 blocks of 128
// threads; the first p6 ran N/128 = 24 blocks with 4-byte loads: 13.4 and
// 29.0 us queued (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md, T2's row).
// Design of both now: a block owns one 16-column group across all of K (N/16
// blocks: 128 and 192 at the script's shapes, every SM of the card), its 256
// threads split K, each issuing all of its 16-byte row loads (p2 8, p6 4 a
// thread at K = 1024) before any arithmetic; each warp sums its 16 columns
// (p2: one redux.sync a column, exact; p6: a butterfly of 16 shuffles, each
// lane left with one column, a fixed order) and the warps meet once in shared
// memory, summed in warp order: one launch, no memset, no atomics, and p6's
// f32 sums fall in the same order on every run. p2 keeps transpose_4x16 +
// __dp4a (4 rows of a thread are 16 column words); p6 widens a byte through
// the bits of 2^23 + (b ^ 0x80) (a prmt and a subtract: the int8 -> bf16
// round trip is exact, so its value is the byte's).
#include "common.cuh"

namespace {

constexpr int PR_THREADS = 256;
constexpr int PR_SCRATCH_ROWS = 16;
constexpr int PR_CODES = 16;

__global__ void __launch_bounds__(PR_THREADS)
p1_kernel(const float* __restrict__ x, int rows, int cols, float* __restrict__ out) {
  extern __shared__ float p1_row[];
  const int n = rows * cols;
  for (int i = threadIdx.x; i < n; i += PR_THREADS) p1_row[i] = x[i];
  __syncthreads();
  for (int r = threadIdx.x / 32; r < rows; r += PR_THREADS / 32)
    for (int c = threadIdx.x % 32; c < cols; c += 32) out[r * cols + c] = p1_row[r * cols + c] * 2.f;
}

constexpr int GV_THREADS = 256;  // p2 and p6: a block's threads split K
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 16;       // columns of a block: one 16-byte load a row

// p2: block b sums columns 16 b .. 16 b + 15; thread t the 4-row groups t,
// t + 256, ..., two groups (8 loads) in flight. The warp's column sums with
// redux.sync (one instruction a column), the warps' in shared memory.
__global__ void __launch_bounds__(GV_THREADS)
p2_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int K, int N,
          int* __restrict__ out) {
  __shared__ int red[GV_WARPS][GV_COLS];
  const int col = blockIdx.x * GV_COLS, K4 = K / 4, lane = threadIdx.x & 31;
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  for (int g = threadIdx.x; g < K4; g += 2 * GV_THREADS) {
    const int g2 = g + GV_THREADS;
    const bool two = g2 < K4;
    int4 ra[4], rb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      ra[r] = __ldg(reinterpret_cast<const int4*>(w + (size_t)(4 * g + r) * N + col));
      rb[r] = two ? __ldg(reinterpret_cast<const int4*>(w + (size_t)(4 * g2 + r) * N + col))
                  : make_int4(0, 0, 0, 0);
    }
    const int xa = __ldg(reinterpret_cast<const int*>(x) + g);
    const int xb = two ? __ldg(reinterpret_cast<const int*>(x) + g2) : 0;
    int cols[16];
    qt::transpose_4x16(ra, cols);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = __dp4a(cols[j], xa, acc[j]);
    qt::transpose_4x16(rb, cols);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = __dp4a(cols[j], xb, acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int t = (int)__reduce_add_sync(0xffffffffu, (unsigned)acc[j]);
    if (lane == j) red[threadIdx.x >> 5][j] = t;
  }
  __syncthreads();
  if (threadIdx.x < GV_COLS) {
    int s = 0;
#pragma unroll
    for (int w2 = 0; w2 < GV_WARPS; ++w2) s += red[w2][threadIdx.x];
    out[col + threadIdx.x] = s;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float& d) { d = v; }
__device__ __forceinline__ void from_f(float v, bf16& d) { d = __float2bfloat16_rn(v); }

// The p3 family: MODE 0 stores row p, reads row p; 1 stores row p, reads
// the scratch; 2 selects row p over every row, reads the scratch. Block b
// holds columns 64 b .. 64 b + 63; thread c writes column c, and 16-byte
// vector i of what is read goes to thread n - 1 - i.
constexpr int P3_COLS = 64;
constexpr int P3_THREADS = 128;

template <typename T, int MODE>
__global__ void __launch_bounds__(P3_THREADS)
p3_kernel(const T* __restrict__ x, int p, int cols, T* __restrict__ out) {
  constexpr int V = 16 / sizeof(T), RV = P3_COLS / V;  // values a vector, vectors a row
  __shared__ uint4 buf4[PR_SCRATCH_ROWS * RV];
  T* buf = reinterpret_cast<T*>(buf4);  // [16][P3_COLS]
  const int tid = threadIdx.x, c0 = blockIdx.x * P3_COLS, n = min(P3_COLS, cols - c0);
  for (int i = tid; i < PR_SCRATCH_ROWS * RV; i += P3_THREADS) buf4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (tid < n) {
    T upd;
    from_f(to_f(x[c0 + tid]) * 3.f, upd);
    if (MODE == 2) {
#pragma unroll
      for (int r = 0; r < PR_SCRATCH_ROWS; ++r)
        buf[r * P3_COLS + tid] = r == p ? upd : buf[r * P3_COLS + tid];
    } else {
      buf[p * P3_COLS + tid] = upd;
    }
  }
  __syncthreads();
  const int nv = n / V, total = MODE == 0 ? nv : PR_SCRATCH_ROWS * nv;
  for (int i = total - 1 - tid; i >= 0; i -= P3_THREADS) {
    const int r = MODE == 0 ? p : i / nv, v = i % nv;
    reinterpret_cast<uint4*>(out + (size_t)(MODE == 0 ? 0 : r) * cols + c0)[v] = buf4[r * RV + v];
  }
}

// The p4 family: c = the first index of max(z[0:N]); codes[0] = c and
// codes[1:16] = 0 where WRITE_CODES; row[0:E] = emb[c] where WRITE_ROW;
// VIA_SMEM: thread 0 finishes the argmax and hands c over in a shared
// scalar (p4c); otherwise every thread finishes it from the warps' results.
template <bool WRITE_CODES, bool WRITE_ROW, bool VIA_SMEM>
__global__ void __launch_bounds__(PR_THREADS)
p4_kernel(const float* __restrict__ z, int N, const float* __restrict__ emb, int E,
          int* __restrict__ codes, float* __restrict__ row) {
  __shared__ float wv[PR_THREADS / 32];
  __shared__ int wi[PR_THREADS / 32];
  __shared__ int c_slot;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float bv = -CUDART_INF_F;
  int bi = 0x7fffffff;
  for (int i = tid; i < N; i += PR_THREADS) {
    const float v = z[i];
    if (bi == 0x7fffffff || v > bv) bv = v, bi = i;  // i rises: a later equal value never wins
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (qt::better(ov, oi, bv, bi)) bv = ov, bi = oi;
  }
  if (lane == 0) wv[warp] = bv, wi[warp] = bi;
  __syncthreads();
  int c = 0;
  if (!VIA_SMEM || tid == 0) {
    float cv = wv[0];
    c = wi[0];
    for (int w = 1; w < PR_THREADS / 32; ++w)
      if (qt::better(wv[w], wi[w], cv, c)) cv = wv[w], c = wi[w];
  }
  if (VIA_SMEM) {
    if (tid == 0) c_slot = c;
    __syncthreads();
    c = c_slot;
  }
  if (WRITE_CODES && tid < PR_CODES) codes[tid] = tid == 0 ? c : 0;
  if (WRITE_ROW)
    for (int e = tid; e < E; e += PR_THREADS) row[e] = __ldg(emb + (size_t)c * E + e);
}

__global__ void __launch_bounds__(PR_THREADS)
p5_kernel(uint32_t key, int n, float* __restrict__ out) {
  const int c = blockIdx.x * PR_THREADS + threadIdx.x;
  if (c < n) out[c] = (float)(qt::mix32(qt::mix32((uint32_t)c) ^ key) >> 8) * (1.f / 16777216.f);
}

// A signed byte of a word as f32, exactly: the bits of 2^23 + (b ^ 0x80)
// less 2^23 + 128 (``u`` is the word ^ 0x80808080).
template <int J>
__device__ __forceinline__ float sbyte(uint32_t u) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + J)) - 8388736.0f;
}

__device__ __forceinline__ void dot16(const uint4& q, float xv, float (&acc)[16]) {
  const uint32_t u[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u, q.z ^ 0x80808080u,
                         q.w ^ 0x80808080u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[4 * k] = fmaf(sbyte<0>(u[k]), xv, acc[4 * k]);
    acc[4 * k + 1] = fmaf(sbyte<1>(u[k]), xv, acc[4 * k + 1]);
    acc[4 * k + 2] = fmaf(sbyte<2>(u[k]), xv, acc[4 * k + 2]);
    acc[4 * k + 3] = fmaf(sbyte<3>(u[k]), xv, acc[4 * k + 3]);
  }
}

// Butterfly sum of a warp's 16 column accumulators: each step keeps half of
// the columns and adds the partner's copy of them (16 shuffles in all), a
// fixed order. Returns the warp's total of column lane / 2.
__device__ __forceinline__ float warp_colsum16(float (&v)[16], int lane) {
#pragma unroll
  for (int half = 8; half >= 1; half >>= 1) {
    const bool up = lane & (2 * half);  // this lane keeps the upper half
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float keep = up ? v[j + half] : v[j], send = up ? v[j] : v[j + half];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * half);
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// p6: block b sums columns 16 b .. 16 b + 15; thread t the rows t, t + 256,
// ..., four rows (4 loads) in flight; the warps' column sums meet in shared
// memory in warp order.
constexpr int P6_ROWS = 4;

__global__ void __launch_bounds__(GV_THREADS)
p6_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w, int K, int N,
          float* __restrict__ out) {
  __shared__ float red[GV_WARPS][GV_COLS];
  const int col = blockIdx.x * GV_COLS, lane = threadIdx.x & 31;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  for (int k0 = threadIdx.x; k0 < K; k0 += P6_ROWS * GV_THREADS) {
    uint4 q[P6_ROWS];
    float xv[P6_ROWS];
#pragma unroll
    for (int r = 0; r < P6_ROWS; ++r) {
      const int k = k0 + r * GV_THREADS;
      q[r] = k < K ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * N + col))
                   : make_uint4(0u, 0u, 0u, 0u);
      xv[r] = k < K ? qt::bf(x[k]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < P6_ROWS; ++r) dot16(q[r], xv[r], acc);
  }
  const float t = warp_colsum16(acc, lane);
  if (!(lane & 1)) red[threadIdx.x >> 5][lane >> 1] = t;
  __syncthreads();
  if (threadIdx.x < GV_COLS) {
    float s = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < GV_WARPS; ++w2) s += red[w2][threadIdx.x];
    out[col + threadIdx.x] = s;
  }
}

__global__ void empty_kernel() {}

template <typename T, int MODE>
int launch_p3(int p, int cols, const void* x, void* out, cudaStream_t st) {
  if (p < 0 || p >= PR_SCRATCH_ROWS || cols <= 0 || cols % 8 || !x || !out || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  p3_kernel<T, MODE><<<(cols + P3_COLS - 1) / P3_COLS, P3_THREADS, 0, st>>>((const T*)x, p, cols,
                                                                            (T*)out);
  return (int)cudaGetLastError();
}

template <bool WRITE_CODES, bool WRITE_ROW, bool VIA_SMEM>
int launch_p4(int N, int V, int E, const void* z, const void* emb, void* codes, void* row,
              cudaStream_t st) {
  if (N <= 0 || (WRITE_ROW && (V < N || E <= 0 || !emb || !row)) || (WRITE_CODES && !codes) || !z)
    return (int)cudaErrorInvalidValue;
  p4_kernel<WRITE_CODES, WRITE_ROW, VIA_SMEM><<<1, PR_THREADS, 0, st>>>(
      (const float*)z, N, (const float*)emb, E, (int*)codes, (float*)row);
  return (int)cudaGetLastError();
}

}  // namespace

// p1: out [rows, cols] = 2 x [rows * cols] (f32, at most 12,288 values).
extern "C" int qt_cpk_p1_reshape(int rows, int cols, const void* x, void* out, void* stream) {
  if (rows <= 0 || cols <= 0 || rows * cols > 12288 || !x || !out) return (int)cudaErrorInvalidValue;
  p1_kernel<<<1, PR_THREADS, (size_t)rows * cols * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)x, rows, cols, (float*)out);
  return (int)cudaGetLastError();
}

// p2: out [N] int32 = x [K] int8 . w [K, N] int8; K % 4 == 0, N % 16 == 0,
// w 16-byte aligned, x 4-byte aligned. One launch.
extern "C" int qt_cpk_p2_int8_dot(int K, int N, const void* x, const void* w, void* out,
                                  void* stream) {
  if (K <= 0 || K % 4 || N <= 0 || N % GV_COLS || !x || !w || !out || ((uintptr_t)w & 15) ||
      ((uintptr_t)x & 3))
    return (int)cudaErrorInvalidValue;
  p2_kernel<<<N / GV_COLS, GV_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, K, N, (int*)out);
  return (int)cudaGetLastError();
}

// p3-p3c: cols % 8 == 0, out 16-byte aligned.
// p3: out [cols] bf16 = row p of the scratch after row p = bf16(3 x).
extern "C" int qt_cpk_p3_dynrow(int p, int cols, const void* x, void* out, void* stream) {
  return launch_p3<bf16, 0>(p, cols, x, out, (cudaStream_t)stream);
}

// p3a: out [16, cols] f32 = the scratch after row p = 3 x.
extern "C" int qt_cpk_p3a_dynrow_f32(int p, int cols, const void* x, void* out, void* stream) {
  return launch_p3<float, 1>(p, cols, x, out, (cudaStream_t)stream);
}

// p3b: out [16, cols] bf16 = the scratch after row p = bf16(3 x).
extern "C" int qt_cpk_p3b_dynrow_bf16(int p, int cols, const void* x, void* out, void* stream) {
  return launch_p3<bf16, 1>(p, cols, x, out, (cudaStream_t)stream);
}

// p3c: out [16, cols] bf16 = where(row == p, bf16(3 x), scratch).
extern "C" int qt_cpk_p3c_where_row(int p, int cols, const void* x, void* out, void* stream) {
  return launch_p3<bf16, 2>(p, cols, x, out, (cudaStream_t)stream);
}

// p4: codes int32 [16] and row f32 [E] = emb [V, E] row argmax(z [N]); N <= V.
extern "C" int qt_cpk_p4_argmax_row(int N, int V, int E, const void* z, const void* emb,
                                    void* codes, void* row, void* stream) {
  return launch_p4<true, true, false>(N, V, E, z, emb, codes, row, (cudaStream_t)stream);
}

// p4a: codes int32 [16] = (argmax(z [N]), 0, ...).
extern "C" int qt_cpk_p4a_argmax(int N, const void* z, void* codes, void* stream) {
  return launch_p4<true, false, false>(N, 0, 0, z, nullptr, codes, nullptr, (cudaStream_t)stream);
}

// p4b: row f32 [E] = emb [V, E] row argmax(z [N]).
extern "C" int qt_cpk_p4b_argmax_row(int N, int V, int E, const void* z, const void* emb,
                                     void* row, void* stream) {
  return launch_p4<false, true, false>(N, V, E, z, emb, nullptr, row, (cudaStream_t)stream);
}

// p4c: as p4b, the index passed through a shared-memory scalar.
extern "C" int qt_cpk_p4c_argmax_smem_row(int N, int V, int E, const void* z, const void* emb,
                                          void* row, void* stream) {
  return launch_p4<false, true, true>(N, V, E, z, emb, nullptr, row, (cudaStream_t)stream);
}

// p5: out [n] f32 = the generator's uniform draws for seed (stream 0).
extern "C" int qt_cpk_p5_counter_bits(unsigned seed, int n, void* out, void* stream) {
  if (n <= 0 || !out) return (int)cudaErrorInvalidValue;
  p5_kernel<<<(n + PR_THREADS - 1) / PR_THREADS, PR_THREADS, 0, (cudaStream_t)stream>>>(
      qt::stream_key(seed, 0u, 0u), n, (float*)out);
  return (int)cudaGetLastError();
}

// p6: out [N] f32 = x [K] bf16 . bf16(w [K, N] int8); N % 16 == 0, w
// 16-byte aligned.
extern "C" int qt_cpk_p6_convert_dot(int K, int N, const void* x, const void* w, void* out,
                                     void* stream) {
  if (K <= 0 || N <= 0 || N % GV_COLS || !x || !w || !out || ((uintptr_t)w & 15))
    return (int)cudaErrorInvalidValue;
  p6_kernel<<<N / GV_COLS, GV_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const int8_t*)w, K, N, (float*)out);
  return (int)cudaGetLastError();
}

// An empty kernel, one warp: the floor of a launch queued on the card.
extern "C" int qt_cpk_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
