// K1: one talker decode step for B rows (1 <= B <= 64), with the codec head
// and the code0 sampler (sample mode) or without them, for Hopper (sm_90a).
//
// Replaces qwen3tts_tpu/ops/talker_kernel.py::talker_decode_step (body
// _talker_step_kernel), the TPU kernel that ran all L layers as one Pallas
// grid program with double-buffered weight streaming, for any static B at
// per-sequence cache offsets, on a bf16 cache or an int8 cache with per-row
// f32 scales, in sample or non-sample mode, with int8 weights and per-channel
// scales (its ``wo_bf16`` mode, or ``dyn_int8``: each activation row
// quantized to int8, s8 x s8 summed in int32) or dense bf16 weights (its
// ``bf16`` mode).
//
// Bound on the H100. At B=1: device-memory bandwidth on the weights. At the
// 0.6B shapes one step reads 28 x 15.7 MB of int8 layer weights plus the
// 3.1 MB codec head (~443.5 MB), plus the KV prefix of every row:
// 114,688 B per cached position in bf16, 57,344 B + 1,792 B of scales in
// int8; the floor at 3.35 TB/s is 0.132 ms plus the cache. Dense bf16
// weights (a checkpoint served unquantized) double the weight bytes: 28 x
// 31.46 MB + 6.3 MB = 887.1 MB, 0.265 ms. At the 1.7B shapes (H 2048, I
// 6144) a layer is 50.33 MB in int8: 1,415.6 MB with the head, 0.423 ms;
// 2,831.2 MB, 0.845 ms, in bf16. At B>1 the weights are still read once per
// step for the whole batch (the batched GEMV of common.cuh stages each
// weight tile in shared memory once and multiplies it into every row), so
// the bytes barely grow with B but the multiply-adds do: 2 x B flops per
// weight, ~57 GFLOP at B=64 at 0.6B: 0.058 ms at the card's dense bf16
// tensor rate (989 TFLOP/s) against a 0.132 ms memory floor, where the
// CUDA cores' f32 FMA took ~0.85 ms at their peak. In dyn_int8 the
// operations are 2 x B integer multiply-adds per weight (the int8 dense
// rate, 1,979 TOP/s, is the yardstick). So at B > 1 every GEMV of the step
// (the four per layer and the codec head) runs on the tensor cores, as K2's
// do: common.cuh's ``gemv`` takes ``gemv_batched_mma`` (int8 widened to bf16
// in shared memory, or bf16 as it is; m16n8k16 -> f32) and
// ``gemv_batched_dq_mma`` (dyn_int8: m16n8k32 s8 -> exact s32, partials
// bit-equal to the dp4a form's); the workspace holds TC_MAX_PARTS rows of
// partials (``_cuda.workspace_rows(B)``). At B = 1 the GEMV stays
// ``gemv_partial`` / ``gemv_partial_dq``.
//
// Design: split-K GEMVs whose second pass is fused with the residual add
// and the next RMSNorm (or SwiGLU); an attention block per (kv head, row)
// that finishes the qkv GEMV, applies QK-norm and rope at the row's own
// position, writes the new k/v row into the cache in place (quantized, with
// its scale, for an int8 cache) and attends over the row's valid prefix with
// the current token joining unquantized; one sampler block per row. A step
// is a fixed sequence of 8 L + 3 launches (227 at 28 layers) from the host
// loop below (one ctypes call per step); a persistent form of the B = 1
// step, as K2's B = 1 frame has (csrc/cp_loop.cu), is later work.
#include "common.cuh"

using namespace qt;

// The operations enqueued through QT_CHECK_LAUNCH so far (common.cuh).
extern "C" unsigned long long qt_launches(void) { return qt::launch_count(); }

// Row positions: ``offs`` (device int32 [B]) when given, else ``pos`` for
// every row. Layer weights int8 with f32 scales, or bf16 (``w_bf16``; the
// scale pointers are then ignored); the codec head likewise (``head_bf16``).
// ``dyn`` (int8 layers): the dyn_int8 mode for the layers and an int8 head,
// with ``amax`` the [AMAX_SLOTS, B] f32 slots (else null; no initial value).
// Caches [L, B, NKV, T, D] (bf16, or int8 with kv_quant and scales
// [L, B, NKV, T]); rope rows cos/sin at ``cosr + b * rope_stride``.
// Sample mode when ``head_w`` is given: code_out [B], logits_out [B, V];
// top_p_thr is f32(1 - top_p) or 0 (no top-p stage), see SampleArgs;
// ``samp_rows`` (or null) the per-row sampling values [B][5] f32 (rep,
// greedy, inv_t, top_k, top_p_thr), with top_p_thr then their largest.
// On return xn holds rms(h, final norm) [B, H], the hidden the CP consumes.
extern "C" int qt_talker_step(
    int L, int H, int NQ, int NKV, int D, int I, int V, int T, int B, int pos, const void* offs,
    int kv_quant, int w_bf16, int head_bf16, int dyn, float eps, float scale,
    const void* x,
    const void* qkv_w, const void* qkv_s, const void* o_w, const void* o_s,
    const void* gu_w, const void* gu_s, const void* d_w, const void* d_s,
    const void* iln, const void* pln, const void* qn, const void* kn, const void* fnorm,
    void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* cosr, const void* sinr, int rope_stride,
    const void* head_w, const void* head_s, const void* supp, const void* seen,
    float rep, int greedy, float inv_t, int top_k, float top_p_thr, int ref_exact, int eos_id,
    uint32_t seed0, uint32_t seed1, const void* samp_rows,
    void* hres, void* xn, void* attn, void* gated, void* ws, void* amax,
    void* code_out, void* logits_out, void* stream) {
  if (D != HEAD_DIM || NQ % NKV != 0 || NQ / NKV > ATTN_MAX_GROUP || B < 1 || B > MAX_BATCH ||
      V > SAMPLE_THREADS * SAMPLE_PER_THREAD || (offs == nullptr && (pos < 0 || pos >= T)) ||
      (kv_quant && (k_scale == nullptr || v_scale == nullptr)) ||
      (!w_bf16 && (qkv_s == nullptr || o_s == nullptr || gu_s == nullptr || d_s == nullptr)) ||
      (head_w != nullptr && !head_bf16 && head_s == nullptr) ||
      (dyn && (w_bf16 || amax == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t layer_rows = (size_t)B * NKV * T;  // cache rows of one layer
  const size_t esz = kv_quant ? 1 : 2;
  bf16* h = (bf16*)hres;
  bf16* xnb = (bf16*)xn;
  const int* offs_p = (const int*)offs;
  float* ax = dyn ? (float*)amax : nullptr;
  const StackW stack = {qkv_w, qkv_s, nullptr, nullptr, nullptr, nullptr, o_w, o_s,
                        gu_w, gu_s, nullptr, nullptr, d_w, d_s};
  rms_copy<<<B, 1024, 0, st>>>((const bf16*)x, H, (const float*)iln, xnb, h, H, eps, ax);
  QT_CHECK_LAUNCH();
  for (int l = 0; l < L; ++l) {
    const LayerW w = layer_weights(l, H, NQ, NKV, I, w_bf16 != 0, stack, pln, qn, kn);
    const float* next_norm = l + 1 < L ? (const float*)iln + (size_t)(l + 1) * H
                                       : (const float*)fnorm;
    AttnCache cache;
    cache.k = (char*)k_cache + l * layer_rows * D * esz;
    cache.v = (char*)v_cache + l * layer_rows * D * esz;
    cache.ks = kv_quant ? (float*)k_scale + l * layer_rows : nullptr;
    cache.vs = kv_quant ? (float*)v_scale + l * layer_rows : nullptr;
    cache.T = T;
    const int err = kv_quant
        ? layer_step<false, true>(w, next_norm, B, H, NQ, NKV, I, eps, scale, (const bf16*)cosr,
                                  (const bf16*)sinr, rope_stride, cache, pos, offs_p, h, xnb,
                                  (bf16*)attn, (bf16*)gated, (float*)ws, ax, st)
        : layer_step<false, false>(w, next_norm, B, H, NQ, NKV, I, eps, scale, (const bf16*)cosr,
                                   (const bf16*)sinr, rope_stride, cache, pos, offs_p, h, xnb,
                                   (bf16*)attn, (bf16*)gated, (float*)ws, ax, st);
    if (err) return err;
  }
  if (head_w == nullptr) return 0;  // non-sample mode: the post-norm hidden only
  Mat head = mat(head_bf16 != 0);
  add_seg(head, head_w, head_s, 0, H, V);
  const float* head_ax = head_bf16 ? nullptr : ax;  // a dense head stays bf16
  const int s = gemv(head, xnb, B, (float*)ws, H, V, head_ax, st);
  QT_CHECK_LAUNCH();
  SampleArgs a;
  a.supp = (const float*)supp;
  a.seen = (const uint8_t*)seen;
  a.rep = rep;
  a.greedy = greedy;
  a.inv_t = inv_t;
  a.top_k = top_k;
  a.top_p_thr = top_p_thr;
  a.ref_exact = ref_exact;
  a.eos_id = eos_id;
  a.seed0 = seed0;
  a.seed1 = seed1;
  a.stream = 0;
  a.code_out = (int*)code_out;
  a.code_stride = 1;
  a.logits_out = (float*)logits_out;
  a.logits_stride = V;
  a.force_code = nullptr;
  a.force_stride = 0;
  a.emb = nullptr;
  a.H = H;
  a.x_next = nullptr;
  a.esum = nullptr;
  a.amax = head_ax;
  a.cp_head = 0;
  a.rows = (const float*)samp_rows;
  launch_sampler((const float*)ws, s, head, V, a, B, st);
  QT_CHECK_LAUNCH();
  return 0;
}
