// T5: batched in-place KV row append, for Hopper (sm_90a).
//
// Replaces tools/exp_kv_append.py::_append_call (kernel ``_append_kernel``
// :57-87, pallas_call at :97): for every sequence b, write k_new[:, b] and
// v_new[:, b] ([L, Hkv, D] bf16) at T index offsets[b] of the bf16 caches
// [L, B, Hkv, T, D], in place, the function of
// qwen3tts_tpu/models/talker.py::_scatter_append_batched on a bf16 cache
// (an offset outside [0, T) lands where dynamic_update_slice puts it: a
// negative one counts from the end, then it is clamped into [0, T - 1]).
//
// The TPU kernel read and wrote back an aligned 8-row window per sequence
// because Mosaic tiles a bf16 HBM array (8, 128) on its last two dims, so a
// single row could not be a DMA operand (the script's docstring, :9-16).
// The card has no such tiling: one launch writes the rows themselves.
//
// Bound on the H100: device-memory bandwidth on the new rows read once and
// written once: 2 x 2 x L*B*Hkv*D*2 bytes, 7.34 MB at the script's shape
// (L 28, B 32, Hkv 8, D 128), 2.19 us at 3.35 TB/s. Design: a warp takes
// one (layer, sequence) unit at a time, 2 x Hkv rows of D (4 KB at the
// script's shape: a lane carries 4 pieces of 16 bytes of each cache),
// reads and clamps its offset once, issues all its loads before any store,
// and walks its pieces and units by additions in 32-bit arithmetic (the
// only divisions run once a thread, before the loop), so little stands
// before a thread's loads. The grid is one wave sized to the SMs; at the
// script's shape 896 warps carry all 3.67 MB of new rows in flight at
// once. What bounds it then is device memory: each append's rows go to
// lines no earlier append wrote, so its stores evict the dirty rows of
// earlier appends to memory, and the reads and those write-backs share the
// bus (a variant that only loaded read 4.1 us queued, one that only stored
// 3.8, the kernel with plain stores 5.9, an empty kernel 1.75, on an H100;
// PERF.md). The loads are streaming (ld.global.cs): k_new and v_new are
// read once. The stores are plain, so the new rows stay in the L2 for the
// decode step that reads them next. Streaming stores (st.global.cs,
// evict-first) read 5.35 us against 5.9 in one call, but only because the
// timing loop never reads the rows back; they are not taken.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_state.cuh"

namespace {

constexpr int KA_THREADS = 128;                 // 4 warps
constexpr int KA_WARPS = KA_THREADS / 32;
constexpr int KA_BLOCKS_PER_SM = 8;             // resident at once (<= 64 registers a thread)
constexpr int KA_R = 4;                         // 16-byte pieces a lane loads per cache per round

// A unit u = l * B + b holds P = Hkv * PD pieces of each cache's new rows
// (PD = D / 8 a row); its rows go to cache pieces u * T * P + h * T * PD +
// off * PD + col. (dh, dc) = divmod(32, PD), the step from a lane's piece to
// the one 32 further; db = (warps in the grid) % B.
__global__ void __launch_bounds__(KA_THREADS, KA_BLOCKS_PER_SM)
kv_append_kernel(uint4* __restrict__ kc, uint4* __restrict__ vc, const uint4* __restrict__ kn,
                 const uint4* __restrict__ vn, const int* __restrict__ offsets, uint32_t units,
                 uint32_t B, int T, uint32_t PD, uint32_t P, uint32_t db, uint32_t dh,
                 uint32_t dc) {
  const uint32_t lane = threadIdx.x & 31u, warps = gridDim.x * KA_WARPS;
  uint32_t u = blockIdx.x * KA_WARPS + (threadIdx.x >> 5);
  if (u >= units) return;
  uint32_t b = u % B;
  const uint32_t h0 = lane / PD, c0 = lane % PD, TPD = (uint32_t)T * PD, step = dh * TPD;
  for (; u < units; u += warps) {
    int off = __ldg(offsets + b);
    off = min(max(off < 0 ? off + T : off, 0), T - 1);
    const uint4* ks = kn + (size_t)u * P;
    const uint4* vs = vn + (size_t)u * P;
    uint4* kd = kc + (size_t)u * P * (uint32_t)T;
    uint4* vd = vc + (size_t)u * P * (uint32_t)T;
    uint32_t hrow = h0 * TPD + (uint32_t)off * PD, col = c0;  // piece lane's destination
    for (uint32_t p0 = lane; p0 < P; p0 += 32u * KA_R) {
      uint4 kr[KA_R], vr[KA_R];
      uint32_t dst[KA_R];
#pragma unroll
      for (int j = 0; j < KA_R; ++j) {
        const uint32_t p = p0 + 32u * j;
        dst[j] = hrow + col;
        if (p < P) {
          kr[j] = __ldcs(ks + p);
          vr[j] = __ldcs(vs + p);
        }
        col += dc;
        hrow += step;
        if (col >= PD) {
          col -= PD;
          hrow += TPD;
        }
      }
#pragma unroll
      for (int j = 0; j < KA_R; ++j) {
        if (p0 + 32u * j < P) {
          kd[dst[j]] = kr[j];
          vd[dst[j]] = vr[j];
        }
      }
    }
    b += db;
    if (b >= B) b -= B;
  }
}

}  // namespace

// k_cache, v_cache bf16 [L, B, H, T, D]; k_new, v_new bf16 [L, B, H, D];
// offsets int32 [B]; D % 8 == 0, every pointer 16-byte aligned. One
// (layer, sequence)'s cache slab, H * T * D bf16, must hold fewer than 2^32
// 16-byte pieces (64 GB), and L * B must be below 2^31.
extern "C" int qt_kv_append(int L, int B, int H, int T, int D, void* k_cache, void* v_cache,
                            const void* k_new, const void* v_new, const void* offsets,
                            void* stream) {
  if (L <= 0 || B <= 0 || H <= 0 || T <= 0 || D <= 0 || D % 8 || !k_cache || !v_cache ||
      !k_new || !v_new || !offsets ||
      (((uintptr_t)k_cache | (uintptr_t)v_cache | (uintptr_t)k_new | (uintptr_t)v_new) & 15))
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)L * B, P = (long long)H * (D / 8);
  if (units >= 0x80000000LL || P * T >= 0x100000000LL) return (int)cudaErrorInvalidValue;
  const int sms = qt::device_attr<cudaDevAttrMultiProcessorCount>(132);
  const long long need = (units + KA_WARPS - 1) / KA_WARPS;
  const long long wave = (long long)sms * KA_BLOCKS_PER_SM;
  const long long blocks = need < wave ? need : wave;
  const uint32_t PD = (uint32_t)(D / 8), warps = (uint32_t)blocks * KA_WARPS;
  kv_append_kernel<<<(unsigned)blocks, KA_THREADS, 0, (cudaStream_t)stream>>>(
      (uint4*)k_cache, (uint4*)v_cache, (const uint4*)k_new, (const uint4*)v_new,
      (const int*)offsets, (uint32_t)units, (uint32_t)B, T, PD, (uint32_t)P, warps % (uint32_t)B,
      32u / PD, 32u % PD);
  return (int)cudaGetLastError();
}
