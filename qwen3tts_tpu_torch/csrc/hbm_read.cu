// T3: the card's sustained device-memory read rate, for Hopper (sm_90a).
//
// Replaces tools/exp_hbm_peak.py::main's Pallas probe (kernel ``kern``
// :78-90, pallas_call at :95): the int32 column sums [1, 1024] of a window
// of ``rows`` rows of an int8 [*, 1024] array, read in blocks of
// ``blk_rows`` rows (4, 8, 16 and 32 MiB). On the TPU a block was one grid
// step's VMEM window and the Pallas pipeline fetched it whole; here a block
// is the unit of work of a group of ``group`` CTAs, each reading one
// contiguous slice of the block's rows (the wrapper picks the group so that
// every block size puts about two CTAs on each SM). The window starts at
// ``row0`` (the script moves it by one block every other iteration).
//
// Bound on the H100: device-memory bandwidth, every byte read once: 512 MiB
// a call at the script's size, 0.160 ms at 3.35 TB/s. Design: a thread owns
// 16 columns (one 16-byte load per row, 64 threads across a row, so a warp
// reads 512 contiguous bytes) and a quarter of the slice's rows, four rows
// at a time: four 16-byte loads, a byte transpose into 16 words of one
// column's 4 rows, and 16 ``__dp4a`` against 0x01010101 sum them exactly
// into the column's int32; the four row quarters meet in shared memory and
// each CTA adds its 1024 sums to ``out`` with atomics (zeroed first, on
// the stream). Sums are exact: 2^19 rows x 128 < 2^31.
#include "common.cuh"

namespace {

constexpr int HR_THREADS = 256;
constexpr int HR_COLS = 1024;
constexpr int HR_CHUNKS = HR_COLS / 16;           // 16-byte column chunks of a row
constexpr int HR_QUARTERS = HR_THREADS / HR_CHUNKS;  // threads a column chunk

__global__ void __launch_bounds__(HR_THREADS)
hbm_colsum(const int8_t* __restrict__ x, long long row0, int rows, int blk_rows, int group,
           int* __restrict__ out) {
  __shared__ int red[HR_QUARTERS][HR_COLS];
  const int tid = threadIdx.x, cc = tid % HR_CHUNKS, qr = tid / HR_CHUNKS;
  const int blk = blockIdx.x / group, g = blockIdx.x % group;
  const int slice = ((blk_rows + group - 1) / group + 3) / 4 * 4;
  const long long b0 = row0 + (long long)blk * blk_rows;
  const long long r0 = b0 + (long long)g * slice;
  const long long r1 = min(min(b0 + blk_rows, r0 + slice), row0 + rows);
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  const int8_t* base = x + (size_t)cc * 16;
#pragma unroll 2
  for (long long r = r0 + 4 * qr; r + 3 < r1; r += 4 * HR_QUARTERS) {
    int4 w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = __ldg(reinterpret_cast<const int4*>(base + (size_t)(r + k) * HR_COLS));
    int cols[16];
    qt::transpose_4x16(w, cols);
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = __dp4a(cols[j], 0x01010101, acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) red[qr][cc * 16 + j] = acc[j];
  __syncthreads();
  for (int c = tid; c < HR_COLS; c += HR_THREADS) {
    int s = 0;
#pragma unroll
    for (int q = 0; q < HR_QUARTERS; ++q) s += red[q][c];
    atomicAdd(out + c, s);
  }
}

}  // namespace

// x: int8 [total_rows, 1024] (16-byte aligned); out: int32 [1024], the
// column sums of rows [row0, row0 + rows), read in blocks of blk_rows rows
// by groups of ``group`` CTAs. rows a multiple of blk_rows, blk_rows and
// row0 multiples of 4, the window inside the array.
extern "C" int qt_hbm_colsum(const void* x, long long total_rows, long long row0, int rows,
                             int blk_rows, int group, void* out, void* stream) {
  if (x == nullptr || out == nullptr || ((uintptr_t)x & 15) != 0 || rows <= 0 ||
      blk_rows <= 0 || blk_rows % 4 != 0 || rows % blk_rows != 0 || row0 < 0 || row0 % 4 != 0 ||
      row0 + rows > total_rows || group < 1 || group > blk_rows / 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * HR_COLS, st);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)(rows / blk_rows) * group;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  hbm_colsum<<<(unsigned)blocks, HR_THREADS, 0, st>>>((const int8_t*)x, row0, rows, blk_rows,
                                                      group, (int*)out);
  return (int)cudaGetLastError();
}
