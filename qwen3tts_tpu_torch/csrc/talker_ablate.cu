// T6: K1's B=1 talker step ablated by part, for Hopper (sm_90a).
//
// Replaces tools/exp_tk_b1_ablate.py::variant_step (kernel body
// ``_variant_kernel``, pallas_call at :242), a trimmed copy of the TPU talker
// step (narrow form, wo_bf16 int8 weights, non-sample, bf16 cache) with
// ablation switches, which the script times over a 66-step loop to split
// the step's time by part:
//
//   0 full    K1's layer sequence as it is;
//   1 noattn  the attention block writes the new k/v rows but skips the
//             prefix walk and the softmax, and its output is q after
//             QK-norm and rope (the script's code, :138; its docstring's
//             "first D lanes" is not what the kernel does);
//   2 nomlp   the layer ends after o_proj + residual, whose fused finish
//             applies the next layer's input norm (or the final norm): no
//             gate_up, SwiGLU or down launch;
//   3 dma     each layer's four weight matrices read in full by T7's kernel
//             (weight_stream.cu, form 1), h += bf16(sum of their first
//             rows), and zero k/v rows written at the position.
//
// Each returns the script's value: h before the final norm (``hres``) and
// the new k/v rows, written into the cache in place at ``pos`` (K1's
// contract; the script writes them there after the call). Variants 0-2 are
// template switches of common.cuh's ``layer_step`` and ``attn_step``, so
// they run K1's own kernels and launch sequence minus the ablated launches;
// K1 itself (talker_step.cu) instantiates only the full form.
//
// Bound on the H100 (device-memory bandwidth at B=1, 0.6B shapes): full and
// noattn read the four int8 matrices, 440.4 MB (0.131 ms at 3.35 TB/s),
// full also the KV prefix; nomlp reads qkv and o only, 176.2 MB (0.053
// ms); dma 440.4 MB (0.131 ms).
#include "common.cuh"

using namespace qt;

extern "C" int qt_weight_stream(int n, const void* const* w, const long long* layer_bytes,
                                const int* esz, const int* tile, int L, int form, int B, int H,
                                const void* x, void* h, void* sums, void* tiles, void* stream);

namespace {

template <int PART>
int ablate_layers(int L, int H, int NQ, int NKV, int I, int T, int B, int pos, float eps,
                  float scale, const void* x, const StackW& stack, const void* iln,
                  const void* pln, const void* qn, const void* kn, const void* fnorm,
                  void* k_cache, void* v_cache, const bf16* cosr, const bf16* sinr, bf16* h,
                  bf16* xn, bf16* attn, bf16* gated, float* ws, cudaStream_t st) {
  const size_t layer_rows = (size_t)B * NKV * T;
  rms_copy<<<B, 1024, 0, st>>>((const bf16*)x, H, (const float*)iln, xn, h, H, eps, nullptr);
  QT_CHECK_LAUNCH();
  for (int l = 0; l < L; ++l) {
    const LayerW w = layer_weights(l, H, NQ, NKV, I, false, stack, pln, qn, kn);
    const float* next_norm = l + 1 < L ? (const float*)iln + (size_t)(l + 1) * H
                                       : (const float*)fnorm;
    AttnCache cache;
    cache.k = (bf16*)k_cache + l * layer_rows * HEAD_DIM;
    cache.v = (bf16*)v_cache + l * layer_rows * HEAD_DIM;
    cache.ks = cache.vs = nullptr;
    cache.T = T;
    const int err = layer_step<false, false, PART>(w, next_norm, B, H, NQ, NKV, I, eps, scale,
                                                   cosr, sinr, 0, cache, pos, nullptr, h, xn,
                                                   attn, gated, ws, nullptr, st);
    if (err) return err;
  }
  return 0;
}

}  // namespace

// One step of B rows at one position ``pos`` of a bf16 cache [L, B, NKV, T,
// D]; int8 fused weights with f32 scales (qkv, o, gate_up, down: [L, in,
// out] and [L, out]); x [B, H]; cos/sin one [D] rope row. Returns h before
// the final norm in ``hres`` [B, H]. ``sums`` [4 L + 1] 64-bit and ``tiles``
// [4 L] f32 serve the dma variant (T7's kernel); xn, attn, gated, ws as K1's.
extern "C" int qt_talker_ablate(
    int part, int L, int H, int NQ, int NKV, int D, int I, int T, int B, int pos, float eps,
    float scale, const void* x,
    const void* qkv_w, const void* qkv_s, const void* o_w, const void* o_s,
    const void* gu_w, const void* gu_s, const void* d_w, const void* d_s,
    const void* iln, const void* pln, const void* qn, const void* kn, const void* fnorm,
    void* k_cache, void* v_cache, const void* cosr, const void* sinr,
    void* hres, void* xn, void* attn, void* gated, void* ws, void* sums, void* tiles,
    void* stream) {
  if (part < 0 || part > 3 || D != HEAD_DIM || NQ % NKV != 0 || NQ / NKV > ATTN_MAX_GROUP ||
      B < 1 || B > MAX_BATCH || pos < 0 || pos >= T || qkv_s == nullptr || o_s == nullptr ||
      gu_s == nullptr || d_s == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (part == 3) {  // dma: T7's kernel on the four matrices, zero k/v rows at pos
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
      const cudaError_t e = cudaMemset2DAsync((char*)c + (size_t)pos * row, (size_t)T * row, 0,
                                              row, (size_t)L * B * NKV, st);
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  }
  const StackW stack = {qkv_w, qkv_s, nullptr, nullptr, nullptr, nullptr, o_w, o_s,
                        gu_w, gu_s, nullptr, nullptr, d_w, d_s};
  int (*layers)(int, int, int, int, int, int, int, int, float, float, const void*,
                const StackW&, const void*, const void*, const void*, const void*, const void*,
                void*, void*, const bf16*, const bf16*, bf16*, bf16*, bf16*, bf16*, float*,
                cudaStream_t) = part == 0   ? ablate_layers<LAYER_FULL>
                                : part == 1 ? ablate_layers<LAYER_NOATTN>
                                            : ablate_layers<LAYER_NOMLP>;
  return layers(L, H, NQ, NKV, I, T, B, pos, eps, scale, x, stack, iln, pln, qn, kn, fnorm,
                k_cache, v_cache, (const bf16*)cosr, (const bf16*)sinr, (bf16*)hres, (bf16*)xn,
                (bf16*)attn, (bf16*)gated, (float*)ws, st);
}
