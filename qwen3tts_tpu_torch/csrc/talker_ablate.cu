// T6's ``dma`` part: K1's B=1 talker step reduced to its weight stream, for
// Hopper (sm_90a).
//
// Replaces the ``dma`` variant of tools/exp_tk_b1_ablate.py::variant_step
// (kernel body ``_variant_kernel``, pallas_call at :242), which the script
// times beside the whole step to split it by part: each layer's four weight
// matrices read in full by T7's kernel (weight_stream.cu, form 1), h +=
// bf16(sum of their first rows), and zero k/v rows written at the position.
// The step's other parts (``full``, ``noattn``, ``nomlp``) are switches of
// K1's own persistent step (talker_frame.cu's ``part``), so that they take
// their parts away from the step that serves.
//
// Returns the script's value: h (``hres``) and the new k/v rows, written
// into the cache in place at ``pos`` (K1's contract; the script writes them
// there after the call).
//
// Bound on the H100 (device-memory bandwidth at B=1, 0.6B shapes): the four
// int8 matrices, 440.4 MB (0.131 ms at 3.35 TB/s).
#include "common.cuh"

using namespace qt;

extern "C" int qt_weight_stream(int n, const void* const* w, const long long* layer_bytes,
                                const int* esz, const int* tile, int L, int form, int B, int H,
                                const void* x, void* h, void* sums, void* tiles, void* stream);

// One ``dma`` step of B rows at one position ``pos`` of a bf16 cache [L, B,
// NKV, T, D]; int8 fused weights [L, in, out] (qkv, o, gate_up, down); x [B,
// H]. Returns h in ``hres`` [B, H]; ``sums`` [4 L + 1] 64-bit and ``tiles``
// [4 L] f32 are T7's checksums.
extern "C" int qt_talker_ablate_dma(int L, int H, int NQ, int NKV, int D, int I, int T, int B,
                                    int pos, const void* x, const void* qkv_w, const void* o_w,
                                    const void* gu_w, const void* d_w, void* k_cache,
                                    void* v_cache, void* hres, void* sums, void* tiles,
                                    void* stream) {
  if (D != HEAD_DIM || B < 1 || B > MAX_BATCH || pos < 0 || pos >= T)
    return (int)cudaErrorInvalidValue;
  const void* w[4] = {qkv_w, o_w, gu_w, d_w};
  const long long bytes[4] = {(long long)H * (NQ + 2 * NKV) * D, (long long)NQ * D * H,
                              (long long)H * 2 * I, (long long)I * H};
  const int esz[4] = {1, 1, 1, 1};
  const int tile[4] = {(NQ + 2 * NKV) * D, H, 2 * I, H};  // each matrix's whole row 0
  const int err = qt_weight_stream(4, w, bytes, esz, tile, L, 1, B, H, x, hres, sums, tiles,
                                   stream);
  if (err) return err;
  const size_t row = (size_t)D * sizeof(bf16);
  void* caches[2] = {k_cache, v_cache};
  for (void* c : caches) {  // rows (l, b, kv head) lie T * D elements apart
    const cudaError_t e = cudaMemset2DAsync((char*)c + (size_t)pos * row, (size_t)T * row, 0, row,
                                            (size_t)L * B * NKV, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
