// K2: the code predictor's whole inner loop for one frame of B rows
// (1 <= B <= 64), for Hopper (sm_90a).
//
// Replaces qwen3tts_tpu/ops/cp_kernel.py::predict_codes_fused (body
// _cp_kernel): a 2-token prefill of [talker hidden, embed(code0)], then 14
// autoregressive positions through the stack over a 16-slot cache per row;
// positions 1..15 apply lm_head[j], exact top-k and Gumbel-max, and feed
// the sampled code's codec_embedding[j] row to the next position. The TPU
// kernel ran the B rows as one flat cache with a block-diagonal mask; here
// each row attends over its own 16 slots (one attention block per
// (kv head, row)). The TPU kernel took int8 layers, fused or unfused,
// without a projection, in its ``wo_bf16`` or ``dyn_int8`` mode; this one
// takes them all (unfused q/k/v and gate/up are column segments of one
// ``Mat``, common.cuh, so one GEMV launch reads them in place; dyn_int8
// quantizes each activation row and sums s8 x s8 in int32, its heads
// scaled (f32(acc) * s) * scale as the TPU kernel's are), and also dense
// bf16 layers and heads (the TPU kernel's ``bf16`` matmul mode) and the
// small-to-MTP projection of the 1.7B model, both of which went to XLA on
// the TPU; the projection stays a bf16 GEMV in dyn_int8. With the
// projection the inputs are in talker width TH (the talker hidden, the
// talker's embedding of code 0, the [V, TH] rows of codec_embedding[j]) and
// each goes through bf16(bf16(x @ w) + b) into the CP width H before the
// first layer; esum stays in talker width.
//
// Bound on the H100: device-memory bandwidth at small B. The TPU kernel kept
// the whole 5-layer int8 stack (~78.6 MB at the 0.6B shapes) resident in VMEM
// across the 16 positions; an H100 block has at most 227 KB of shared memory
// and the L2 holds 50 MB, so that premise fails here. This simple port
// re-reads the stack at every position, once for all B rows (the batched
// GEMV of common.cuh): 16 x 78.6 MB + 15 x 2 MB of heads ~ 1.29 GB per
// frame, a 0.385 ms floor at any B. In bf16 the stack is 157.3 MB and the
// heads 62.9 MB: each read once is 0.066 ms, the re-read design's 16 x 157.3
// + 62.9 MB ~ 2.58 GB is 0.770 ms. The 1.7B projection (2048 x 1024 bf16,
// 4.2 MB) adds 0.001 ms read once, 67 MB (0.020 ms) as re-read at each of
// the 16 positions. The arithmetic is 2 x B flops per weight per position:
// ~161 GFLOP a frame at B=64, 0.163 ms at the card's dense bf16 rate (989
// TFLOP/s; 0.081 ms in dyn_int8 at 1,979 int8 TOP/s), which the CUDA cores'
// f32 FMAs and dp4a took ~18 and ~11 ms for. So at B > 1 every GEMV of the
// frame (the layers' fused or unfused projections, the 15 heads, the
// projection) runs on the tensor cores: ``layer_step<..., TC = true>`` and
// ``gemv<true>`` select common.cuh's ``gemv_batched_mma`` (int8 widened to
// bf16 in shared memory, or bf16 as it is; mma.sync m16n8k16 -> f32) and
// ``gemv_batched_dq_mma`` (dyn_int8: the dp4a words as the m16n8k32 s8
// operand -> exact s32). The operands are swapped, weights as A (16 output
// columns a tile), x as B (8 batch rows a tile): the batch is the short side
// and goes in steps of 8, where x as A would pad it to 16; this form was
// chosen on that count and the other was not built. The partials and the
// finishing kernels are the CUDA-core form's (the split may go twice as
// deep, TC_MAX_PARTS), so the launches per call do not change. At B = 1 the GEMV stays ``gemv_partial``
// (launch-bound, not arithmetic-bound). It fetches the sampled code's
// embedding row by index (2-4 KB) instead of the TPU kernel's one-hot
// matmul over the table, inside the sampler block. Layers run through the
// same GEMV, attention and sampler kernels as K1 (common.cuh); the 16
// positions are one host loop of launches with no host synchronisation
// (one ctypes call per frame).
#include "common.cuh"

using namespace qt;

// x0 [2, B, TH] (position-major: the talker hidden rows, then the code-0
// embedding rows); layers int8 with f32 scales or bf16 (``w_bf16``), fused
// (q_w = qkv, g_w = gate_up; k, v, u null) or unfused (seven weights), the
// 15 heads likewise (``head_bf16``); ``dyn`` (int8 layers): dyn_int8 for
// the layers and int8 heads, with ``amax`` the [AMAX_SLOTS, B] f32 slots
// (no initial value); emb [NCB, V, TH]; proj_w [TH, H] and proj_b [H]
// bf16, or both null when TH == H; k/v_cache scratch
// [L, B, NKV, NCB + 1, D] bf16; force_codes, codes_out [B, NCB]; esum
// [B, TH]; xbuf [B, TH]; logits_out [NCB, B, V]. Row b draws its codebook j
// from stream j + 1 + 16 b; top_p_thr is f32(1 - top_p) or 0 (no top-p
// stage), see SampleArgs.
extern "C" int qt_cp_loop(
    int L, int H, int NQ, int NKV, int D, int I, int V, int NCB, int B, int TH, int w_bf16,
    int head_bf16, int dyn, float eps, float scale,
    const void* x0,
    const void* q_w, const void* q_s, const void* k_w, const void* k_s, const void* v_w,
    const void* v_s, const void* o_w, const void* o_s, const void* g_w, const void* g_s,
    const void* u_w, const void* u_s, const void* d_w, const void* d_s,
    const void* iln, const void* pln, const void* qn, const void* kn, const void* fnorm,
    const void* lm_w, const void* lm_s, const void* emb, const void* proj_w, const void* proj_b,
    const void* cos_tab, const void* sin_tab, void* k_cache, void* v_cache,
    int greedy, float inv_t, int top_k, float top_p_thr, int ref_exact, uint32_t seed0,
    uint32_t seed1, const void* force_codes,
    void* hres, void* xn, void* attn, void* gated, void* ws, void* xbuf, void* amax,
    void* codes_out, void* esum, void* logits_out, void* stream) {
  const StackW stack = {q_w, q_s, k_w, k_s, v_w, v_s, o_w, o_s, g_w, g_s, u_w, u_s, d_w, d_s};
  if (D != HEAD_DIM || NQ % NKV != 0 || NQ / NKV > ATTN_MAX_GROUP || B < 1 || B > MAX_BATCH ||
      V > SAMPLE_THREADS * SAMPLE_PER_THREAD || NCB + 1 > ATTN_TILE ||
      (proj_w == nullptr && TH != H) || (proj_w != nullptr && proj_b == nullptr) ||
      !stack_ok(stack, w_bf16 != 0) || (!head_bf16 && lm_s == nullptr) ||
      (dyn && (w_bf16 || amax == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int SLOTS = NCB + 1;
  const size_t layer_kv = (size_t)B * NKV * SLOTS * D;
  float* ax = dyn ? (float*)amax : nullptr;
  const float* head_ax = head_bf16 ? nullptr : ax;  // dense heads stay bf16
  Mat proj = mat(true);
  if (proj_w != nullptr) add_seg(proj, proj_w, nullptr, 0, TH, H);
  bf16* h = (bf16*)hres;
  bf16* xnb = (bf16*)xn;
  bf16* xb = (bf16*)xbuf;
  cudaMemsetAsync(esum, 0, sizeof(float) * B * TH, st);
  QT_CHECK_LAUNCH();
  for (int p = 0; p < SLOTS; ++p) {
    const bf16* xin = p < 2 ? (const bf16*)x0 + (size_t)p * B * TH : xb;
    if (proj_w != nullptr) {  // h = bf16(bf16(xin @ proj_w) + proj_b), xn = rms(h)
      const int s = gemv<true>(proj, xin, B, (float*)ws, TH, H, nullptr, st);
      QT_CHECK_LAUNCH();
      finish_residual_norm<<<B, 1024, 0, st>>>((const float*)ws, s, proj, nullptr, h,
                                               (const bf16*)proj_b, (const float*)iln, xnb, H,
                                               eps, ax);
    } else {
      rms_copy<<<B, 1024, 0, st>>>(xin, H, (const float*)iln, xnb, h, H, eps, ax);
    }
    QT_CHECK_LAUNCH();
    const bf16* cosr = (const bf16*)cos_tab + (size_t)p * D;
    const bf16* sinr = (const bf16*)sin_tab + (size_t)p * D;
    for (int l = 0; l < L; ++l) {
      const LayerW w = layer_weights(l, H, NQ, NKV, I, w_bf16 != 0, stack, pln, qn, kn);
      const float* next_norm = l + 1 < L ? (const float*)iln + (size_t)(l + 1) * H
                                         : (const float*)fnorm;
      AttnCache cache;
      cache.k = (bf16*)k_cache + l * layer_kv;
      cache.v = (bf16*)v_cache + l * layer_kv;
      cache.ks = cache.vs = nullptr;
      cache.T = SLOTS;
      const int err = layer_step<true, false, LAYER_FULL, true>(
          w, next_norm, B, H, NQ, NKV, I, eps, scale, cosr, sinr, 0, cache, p, nullptr, h, xnb,
          (bf16*)attn, (bf16*)gated, (float*)ws, ax, st);
      if (err) return err;
    }
    if (p == 0) continue;  // position 0 only fills the cache
    const int j = p - 1;  // head / embedding table of this position
    Mat head = mat(head_bf16 != 0);
    add_seg(head, lm_w, lm_s, j, H, V);
    const int s = gemv<true>(head, xnb, B, (float*)ws, H, V, head_ax, st);
    QT_CHECK_LAUNCH();
    SampleArgs a;
    a.supp = nullptr;
    a.seen = nullptr;
    a.rep = 1.0f;
    a.greedy = greedy;
    a.inv_t = inv_t;
    a.top_k = top_k;
    a.top_p_thr = top_p_thr;
    a.ref_exact = ref_exact;
    a.eos_id = -1;
    a.seed0 = seed0;
    a.seed1 = seed1;
    a.stream = (uint32_t)(j + 1);
    a.code_out = (int*)codes_out + j;
    a.code_stride = NCB;
    a.logits_out = logits_out ? (float*)logits_out + (size_t)j * B * V : nullptr;
    a.logits_stride = V;
    a.force_code = force_codes ? (const int*)force_codes + j : nullptr;
    a.force_stride = NCB;
    a.emb = (const bf16*)emb + (size_t)j * V * TH;
    a.H = TH;
    a.x_next = xb;
    a.esum = (float*)esum;
    a.amax = head_ax;
    a.cp_head = 1;
    launch_sampler((const float*)ws, s, head, V, a, B, st);
    QT_CHECK_LAUNCH();
  }
  return 0;
}

// The batched GEMV of a K2 call alone (B >= 2), for tests and timing: the
// first pass of y[B, O] = x[B, I] @ W into part [splits][B][O] (f32 sums;
// with ``dyn``, x quantized per row from ``amax`` [B] and int32 sums), W
// int8 or (``w_bf16``) bf16 [I, O], on the tensor cores (``tc``, K2's form)
// or the CUDA cores (K1's form), both at K2's split
// (``qt_cp_gemv_splits``), so their partials compare split by split.
extern "C" int qt_cp_gemv_splits(int B, int I, int O) {
  int rows;
  return batched_splits(B, I, O, rows, true);
}

extern "C" int qt_cp_gemv(int tc, int w_bf16, int dyn, int B, int I, int O, const void* w,
                          const void* x, const void* amax, void* part, void* stream) {
  if (B < 2 || B > MAX_BATCH || I % 16 != 0 || O % 16 != 0 || (dyn && (w_bf16 || !amax)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Mat m = mat(w_bf16 != 0);
  add_seg(m, w, nullptr, 0, I, O);
  int rows;
  const dim3 grid((O + BG_COLS - 1) / BG_COLS, batched_splits(B, I, O, rows, true));
  const bf16* xb = (const bf16*)x;
  const float* ax = (const float*)amax;
#define QT_GEMV(kernel, ...)                                            \
  do {                                                                  \
    big_smem(kernel);                                                   \
    kernel<<<grid, GEMV_THREADS, BG_SMEM, st>>>(m, xb, B, __VA_ARGS__); \
  } while (0)
  if (dyn && tc) QT_GEMV(gemv_batched_dq_mma, ax, (int*)part, I, O, rows);
  else if (dyn) QT_GEMV(gemv_batched_dq, ax, (int*)part, I, O, rows);
  else if (w_bf16 && tc) QT_GEMV(gemv_batched_mma<bf16>, (float*)part, I, O, rows);
  else if (w_bf16) QT_GEMV(gemv_batched<bf16>, (float*)part, I, O, rows);
  else if (tc) QT_GEMV(gemv_batched_mma<int8_t>, (float*)part, I, O, rows);
  else QT_GEMV(gemv_batched<int8_t>, (float*)part, I, O, rows);
#undef QT_GEMV
  return (int)cudaGetLastError();
}
