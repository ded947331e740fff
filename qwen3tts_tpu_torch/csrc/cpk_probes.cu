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
//       qt::transpose_4x16 into column words and __dp4a, K split across
//       blocks, int32 atomics (exact);
//   p3  (:66, :73), p3a (:170, :178), p3b (:189, :197), p3c (:208, :218)
//       a store of row p of a [16, C] shared-memory scratch (3 x, bf16 or
//       f32; p3c as a select over all rows) and a read back by other
//       threads: row p (p3) or the whole scratch (p3a-c). The scratch
//       starts at zero here, so its other rows read 0 (on the TPU they were
//       never written);
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
//       bf16 x [1, K] in f32 (K split over 8 warps, summed in a fixed order).
//
// Every probe is bound by its launch: it moves at most 6.3 MB (p6's and
// p2's weights, ~1.9 us at 3.35 TB/s).
#include "common.cuh"

namespace {

constexpr int PR_THREADS = 256;
constexpr int PR_SCRATCH_ROWS = 16;
constexpr int PR_MAX_COLS = 1024;
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

// blockIdx.x: 128 threads x 16 columns; blockIdx.y: 128 rows of K.
__global__ void __launch_bounds__(128)
p2_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int K, int N,
          int* __restrict__ out) {
  const int col = (blockIdx.x * 128 + threadIdx.x) * 16;
  if (col >= N) return;
  const int k0 = blockIdx.y * 128, k1 = min(k0 + 128, K);
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  for (int k = k0; k < k1; k += 4) {
    int4 rows4[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rows4[r] = __ldg(reinterpret_cast<const int4*>(w + (size_t)(k + r) * N + col));
    int cols[16];
    qt::transpose_4x16(rows4, cols);
    const int xw = *reinterpret_cast<const int*>(x + k);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = __dp4a(cols[j], xw, acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) atomicAdd(out + col + j, acc[j]);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float& d) { d = v; }
__device__ __forceinline__ void from_f(float v, bf16& d) { d = __float2bfloat16_rn(v); }

// The p3 family: MODE 0 stores row p, reads row p; 1 stores row p, reads
// the scratch; 2 selects row p over every row, reads the scratch. The
// writes go by column t + 256 m, the reads by the reversed column.
template <typename T, int MODE>
__global__ void __launch_bounds__(PR_THREADS)
p3_kernel(const T* __restrict__ x, int p, int cols, T* __restrict__ out) {
  extern __shared__ uint4 p3_smem[];
  T* buf = reinterpret_cast<T*>(p3_smem);  // [16][cols]
  const int tid = threadIdx.x;
  for (int i = tid; i < PR_SCRATCH_ROWS * cols; i += PR_THREADS) from_f(0.f, buf[i]);
  __syncthreads();
  for (int c = tid; c < cols; c += PR_THREADS) {
    T upd;
    from_f(to_f(x[c]) * 3.f, upd);
    if (MODE == 2) {
      for (int r = 0; r < PR_SCRATCH_ROWS; ++r) buf[r * cols + c] = r == p ? upd : buf[r * cols + c];
    } else {
      buf[p * cols + c] = upd;
    }
  }
  __syncthreads();
  for (int c = cols - 1 - tid; c >= 0; c -= PR_THREADS) {
    if (MODE == 0) {
      out[c] = buf[p * cols + c];
    } else {
      for (int r = 0; r < PR_SCRATCH_ROWS; ++r) out[r * cols + c] = buf[r * cols + c];
    }
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

// A block: 128 columns (4 a lane) x K in 8 warp slices, summed in order.
__global__ void __launch_bounds__(PR_THREADS)
p6_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w, int K, int N,
          float* __restrict__ out) {
  __shared__ float red[PR_THREADS / 32][128];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 128 + 4 * lane;
  const int ks = K / (PR_THREADS / 32), k0 = warp * ks;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int k = k0; k < k0 + ks; ++k) {
    const char4 q = __ldg(reinterpret_cast<const char4*>(w + (size_t)k * N + col));
    const float xv = qt::bf(x[k]);
    a0 = fmaf(qt::rbf((float)q.x), xv, a0);
    a1 = fmaf(qt::rbf((float)q.y), xv, a1);
    a2 = fmaf(qt::rbf((float)q.z), xv, a2);
    a3 = fmaf(qt::rbf((float)q.w), xv, a3);
  }
  red[warp][4 * lane] = a0;
  red[warp][4 * lane + 1] = a1;
  red[warp][4 * lane + 2] = a2;
  red[warp][4 * lane + 3] = a3;
  __syncthreads();
  if (threadIdx.x < 128) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < PR_THREADS / 32; ++r) s += red[r][threadIdx.x];
    out[blockIdx.x * 128 + threadIdx.x] = s;
  }
}

template <typename T, int MODE>
int launch_p3(int p, int cols, const void* x, void* out, cudaStream_t st) {
  if (p < 0 || p >= PR_SCRATCH_ROWS || cols <= 0 || cols > PR_MAX_COLS || !x || !out)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)PR_SCRATCH_ROWS * cols * sizeof(T);
  auto* kern = p3_kernel<T, MODE>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, PR_THREADS, smem, st>>>((const T*)x, p, cols, (T*)out);
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
// w 16-byte aligned.
extern "C" int qt_cpk_p2_int8_dot(int K, int N, const void* x, const void* w, void* out,
                                  void* stream) {
  if (K <= 0 || K % 4 || N <= 0 || N % 16 || !x || !w || !out || ((uintptr_t)w & 15) ||
      ((uintptr_t)x & 3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * N, st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N / 16 + 127) / 128, (K + 127) / 128);
  p2_kernel<<<grid, 128, 0, st>>>((const int8_t*)x, (const int8_t*)w, K, N, (int*)out);
  return (int)cudaGetLastError();
}

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

// p6: out [N] f32 = x [K] bf16 . bf16(w [K, N] int8); K % 8 == 0,
// N % 128 == 0, w 4-byte aligned.
extern "C" int qt_cpk_p6_convert_dot(int K, int N, const void* x, const void* w, void* out,
                                     void* stream) {
  if (K <= 0 || K % 8 || N <= 0 || N % 128 || !x || !w || !out || ((uintptr_t)w & 3))
    return (int)cudaErrorInvalidValue;
  p6_kernel<<<N / 128, PR_THREADS, 0, (cudaStream_t)stream>>>((const bf16*)x, (const int8_t*)w, K,
                                                              N, (float*)out);
  return (int)cudaGetLastError();
}
