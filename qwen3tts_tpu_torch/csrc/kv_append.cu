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
// The card has no such tiling: one launch writes the rows themselves, one
// thread per 16 bytes of a row (16 bf16 pieces of a D = 128 row, both
// caches in one grid), a 16-byte load of the new row and a 16-byte store
// into the cache.
//
// Bound on the H100: device-memory bandwidth on the new rows read once and
// written once: 2 x 2 x L*B*Hkv*D*2 bytes, 7.34 MB at the script's shape
// (L 28, B 32, Hkv 8, D 128), 2.19 us at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KA_THREADS = 256;

// e indexes 16-byte pieces of the rows of k_new then v_new, each [L, B, Hkv, D].
__global__ void __launch_bounds__(KA_THREADS)
kv_append_kernel(uint4* __restrict__ kc, uint4* __restrict__ vc, const uint4* __restrict__ kn,
                 const uint4* __restrict__ vn, const int* __restrict__ offsets, int B, int H,
                 int T, int pieces, long long rows) {
  const long long e = (long long)blockIdx.x * KA_THREADS + threadIdx.x;
  if (e >= 2 * rows * pieces) return;
  const int piece = (int)(e % pieces);
  const long long r = e / pieces;
  const bool is_v = r >= rows;
  const long long row = is_v ? r - rows : r;  // (l * B + b) * H + h
  const int b = (int)((row / H) % B);
  int off = __ldg(offsets + b);
  off = min(max(off < 0 ? off + T : off, 0), T - 1);
  const uint4 val = __ldg((is_v ? vn : kn) + row * pieces + piece);
  (is_v ? vc : kc)[(row * T + off) * pieces + piece] = val;
}

}  // namespace

// k_cache, v_cache bf16 [L, B, H, T, D]; k_new, v_new bf16 [L, B, H, D];
// offsets int32 [B]; D % 8 == 0, every pointer 16-byte aligned.
extern "C" int qt_kv_append(int L, int B, int H, int T, int D, void* k_cache, void* v_cache,
                            const void* k_new, const void* v_new, const void* offsets,
                            void* stream) {
  if (L <= 0 || B <= 0 || H <= 0 || T <= 0 || D <= 0 || D % 8 || !k_cache || !v_cache ||
      !k_new || !v_new || !offsets ||
      (((uintptr_t)k_cache | (uintptr_t)v_cache | (uintptr_t)k_new | (uintptr_t)v_new) & 15))
    return (int)cudaErrorInvalidValue;
  const int pieces = D / 8;
  const long long rows = (long long)L * B * H;
  const long long blocks = (2 * rows * pieces + KA_THREADS - 1) / KA_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kv_append_kernel<<<(unsigned)blocks, KA_THREADS, 0, (cudaStream_t)stream>>>(
      (uint4*)k_cache, (uint4*)v_cache, (const uint4*)k_new, (const uint4*)v_new,
      (const int*)offsets, B, H, T, pieces, rows);
  return (int)cudaGetLastError();
}
