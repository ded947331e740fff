// T7: the talker's weight stream with (almost) no compute, for Hopper
// (sm_90a); also the ``dma`` variant of T6 (talker_ablate.cu).
//
// Replaces tools/exp_weight_stream.py::run_dma_variant (kernel body
// ``_dma_kernel``, pallas_call at :132): a grid over the L layers that
// streams one [1, r, c] block of each [L, r, c] operand per step and adds
// the sum of one corner tile of each block to a carried [1, H] bf16 row:
// h = bf16(f32(h) + sum_ops sum(w[l, 0, :128])), the adds in operand order.
// On the TPU the Pallas pipeline fetched every whole block whatever the body
// read; a GPU reads only what a thread loads, so this kernel reads EVERY
// byte of every operand of every layer and folds them into one checksum per
// (operand, layer): the int64 sum of the bytes of an int8 operand (4 bytes
// per ``__dp4a`` against 0x01010101, exact), the float64 sum of an f32
// operand's values (exact at these sizes and ranges, so independent of the
// order of the atomics). The checksums are what force the full read.
//
// The second form (T6's ``dma``, tools/exp_tk_b1_ablate.py:100-114) sums
// the whole first row of each layer's four weight matrices into one f32
// total t and sets h = bf16(f32(h) + f32(bf16(t))).
//
// Bound on the H100: device-memory bandwidth. At the 0.6B shapes the four
// int8 matrices are 28 x 15.73 MB = 440.4 MB a step, 0.131 ms at 3.35 TB/s;
// the eight f32 scale and norm rows add ~1.6 MB. Design: one launch over
// the whole step (no per-layer launch), each block reading one 256 KB chunk
// of one (operand, layer) slice in 16-byte loads, neighbouring threads on
// neighbouring addresses; the block that reads row 0 of a slice also sums
// its tile into ``tiles``; the last block to finish (an atomic ticket after
// a fence) runs the L-step h chain from the tile sums, so h costs no extra
// pass over the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WS_MAX_OPS = 12;
constexpr int WS_THREADS = 256;
constexpr long long WS_CHUNK = 1 << 18;  // bytes of one block's chunk
constexpr int WS_MAX_L = 64;

struct WsOps {
  const char* w[WS_MAX_OPS];           // [L, r, c] stacks
  long long layer_bytes[WS_MAX_OPS];   // r * c * esz, a multiple of 16
  int esz[WS_MAX_OPS];                 // 1: int8, 4: f32
  int tile[WS_MAX_OPS];                // elements of row 0 summed into h
  int chunks[WS_MAX_OPS];              // blocks per layer slice
  int n;
};

__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_dsum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sums: [n, L] 64-bit slots (int64, or the bits of a double for f32
// operands) and one ticket slot after them, all zero on entry; tiles: [n, L]
// f32; h: [B, H] from x [B, H]. ``form`` 0: T7's chain, 1: T6's.
__global__ void __launch_bounds__(WS_THREADS)
weight_stream_kernel(const WsOps ops, int L, int form, const bf16* __restrict__ x,
                     bf16* __restrict__ h, int B, int H, unsigned long long* __restrict__ sums,
                     float* __restrict__ tiles) {
  __shared__ double dred[WS_THREADS / 32];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int blk = blockIdx.x, i = 0;
  for (; i < ops.n - 1 && blk >= L * ops.chunks[i]; ++i) blk -= L * ops.chunks[i];
  const int l = blk / ops.chunks[i], c = blk % ops.chunks[i];
  const char* slice = ops.w[i] + (size_t)l * ops.layer_bytes[i];
  const long long off = (long long)c * WS_CHUNK;
  const long long n16 = (min(WS_CHUNK, ops.layer_bytes[i] - off)) / 16;
  const int4* p = reinterpret_cast<const int4*>(slice + off);
  unsigned long long* slot = sums + i * L + l;
  if (ops.esz[i] == 1) {
    int acc = 0;
#pragma unroll 4
    for (long long k = tid; k < n16; k += WS_THREADS) {
      const int4 v = __ldg(p + k);
      acc = __dp4a(v.x, 0x01010101, acc);
      acc = __dp4a(v.y, 0x01010101, acc);
      acc = __dp4a(v.z, 0x01010101, acc);
      acc = __dp4a(v.w, 0x01010101, acc);
    }
    acc = warp_isum(acc);
    if (lane == 0) dred[warp] = (double)acc;
  } else {
    double acc = 0.0;
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll 4
    for (long long k = tid; k < n16; k += WS_THREADS) {
      const float4 v = __ldg(q + k);
      acc += (double)v.x + (double)v.y + (double)v.z + (double)v.w;
    }
    acc = warp_dsum(acc);
    if (lane == 0) dred[warp] = acc;
  }
  if (c == 0 && warp == 0) {  // this slice's tile: the first elements of row 0
    float t = 0.f;
    for (int e = lane; e < ops.tile[i]; e += 32)
      t += ops.esz[i] == 1 ? (float)((const int8_t*)slice)[e] : ((const float*)slice)[e];
    t = qt::warp_sum(t);
    if (lane == 0) tiles[i * L + l] = t;
  }
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < WS_THREADS / 32; ++w) s += dred[w];
    if (ops.esz[i] == 1)
      atomicAdd(slot, (unsigned long long)(long long)s);  // two's complement
    else
      atomicAdd(reinterpret_cast<double*>(slot), s);
    __threadfence();
    last = atomicAdd(sums + ops.n * L, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the h chain over the L layers from the tile sums
  __shared__ float ts[WS_MAX_OPS * WS_MAX_L];
  for (int k = tid; k < ops.n * L; k += WS_THREADS) ts[k] = __ldcg(tiles + k);
  __syncthreads();
  for (int k = tid; k < B * H; k += WS_THREADS) {
    float hv = __bfloat162float(x[k]);
    for (int ll = 0; ll < L; ++ll) {
      if (form == 0) {
        float acc = hv;
        for (int j = 0; j < ops.n; ++j) acc = __fadd_rn(acc, ts[j * L + ll]);
        hv = __bfloat162float(__float2bfloat16_rn(acc));
      } else {
        float tot = 0.f;
        for (int j = 0; j < ops.n; ++j) tot = __fadd_rn(tot, ts[j * L + ll]);
        const float tb = __bfloat162float(__float2bfloat16_rn(tot));
        hv = __bfloat162float(__float2bfloat16_rn(__fadd_rn(hv, tb)));
      }
    }
    h[k] = __float2bfloat16_rn(hv);
  }
}

}  // namespace

// n operands w[i] ([L, r, c] stacks, contiguous, 16-byte aligned) of
// layer_bytes[i] bytes a layer and esz[i] bytes an element (1: int8, 4:
// f32); tile[i] elements of each layer's row 0 enter h (form 0: T7, the
// first min(128, c); form 1: T6's dma, the whole row). x, h [B, H] bf16;
// sums [n * L + 1] 64-bit (zeroed here); tiles [n * L] f32 scratch.
extern "C" int qt_weight_stream(int n, const void* const* w, const long long* layer_bytes,
                                const int* esz, const int* tile, int L, int form, int B, int H,
                                const void* x, void* h, void* sums, void* tiles, void* stream) {
  if (n < 1 || n > WS_MAX_OPS || L < 1 || L > WS_MAX_L || B < 1 || (form != 0 && form != 1))
    return (int)cudaErrorInvalidValue;
  WsOps ops = {};
  ops.n = n;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (w[i] == nullptr || (esz[i] != 1 && esz[i] != 4) || layer_bytes[i] <= 0 ||
        layer_bytes[i] % 16 != 0 || ((uintptr_t)w[i] & 15) != 0 || tile[i] < 0 ||
        (long long)tile[i] * esz[i] > layer_bytes[i])
      return (int)cudaErrorInvalidValue;
    ops.w[i] = (const char*)w[i];
    ops.layer_bytes[i] = layer_bytes[i];
    ops.esz[i] = esz[i];
    ops.tile[i] = tile[i];
    ops.chunks[i] = (int)((layer_bytes[i] + WS_CHUNK - 1) / WS_CHUNK);
    blocks += (long long)L * ops.chunks[i];
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(sums, 0, sizeof(unsigned long long) * (n * L + 1), st);
  if (e != cudaSuccess) return (int)e;
  weight_stream_kernel<<<(unsigned)blocks, WS_THREADS, 0, st>>>(
      ops, L, form, (const bf16*)x, (bf16*)h, B, H, (unsigned long long*)sums, (float*)tiles);
  return (int)cudaGetLastError();
}
