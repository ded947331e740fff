// K1 at B = 1: one talker decode step as one persistent cooperative launch
// (``talker_frame``), for Hopper (sm_90a).
//
// Replaces qwen3tts_tpu/ops/talker_kernel.py::talker_decode_step (body
// _talker_step_kernel) for one sequence: all L layers (RMSNorm, fused qkv,
// QK-norm, rope, the k/v row written into a bf16 or an int8 cache in place,
// GQA attention over the prefix with the current token, o_proj, RMSNorm,
// SwiGLU, down_proj), the final norm and, in sample mode, the codec head and
// the code-0 sampler (mask, penalty, exact top-k, top-p, EOS restore,
// Gumbel-max), in the ``wo_bf16``, ``bf16`` and ``dyn_int8`` modes, as the
// multi-launch step of talker_step.cu computes it. B > 1 stays there.
//
// Bound on the H100: the weights, read once (443.5 MB at 0.6B int8, 0.132
// ms at 3.35 TB/s; 1.7B int8 1,415.6 MB, 0.423 ms), plus the KV prefix
// (114,688 B a row in bf16 at both widths: pos 6000 adds 688 MB, 0.205 ms).
// The multi-launch step took 1.6-1.8 ms at pos 40 for 0.134 ms of bytes:
// 227 launches, each a memory latency plus a launch, and at pos 6000 26-34
// ms, its attention one block per kv head (8 of 132 SMs) walking 6000 rows.
//
// Design. One block of PF_THREADS threads per SM, all resident (checked
// before the launch), walks the step's phases with the grid barrier of K2's
// frame (common.cuh: ``grid_barrier``, bounded, raising through a mapped
// host word). Five barriers a layer:
//  1. qkv: this block's tiles of the GEMV (common.cuh ``frame_gemv_tiles``);
//  2. attention, split over the cache rows (flash-decoding): a kv head's
//     n = pos + 1 rows (the prefix and the current token) are cut into C
//     chunks of equal rows (``tf_chunks``: C = ceil(n / TF_CHUNK), at most
//     blocks / NKV), and each (kv head, chunk) item goes to one block. The block
//     finishes the qkv GEMV for the head's G q vectors, k and v, applies
//     QK-norm and rope (the block of the chunk that holds the current token
//     writes the new k/v row into the cache, quantized with its scale on an
//     int8 cache), scores its rows (16-byte cache reads: half a warp a bf16
//     row, a quarter warp an int8 row, the int8 row scales folded into the
//     scores and the weights as attn_step folds them) in sub-tiles of
//     TF_SUB rows with an online softmax, and writes its running max, sum
//     and unnormalised PV row (f32) for each q head; the current token
//     joins, unquantized, in the last chunk only;
//  3. o: every block merges the chunks of the heads its o tiles read (all
//     heads in dyn_int8, whose input scale is the whole row's amax) in the
//     GEMV's prologue, then its tiles;
//  4. gate_up, after the residual add and RMSNorm, recomputed in every
//     block on its own copy of the residual stream (shared memory);
//  5. down, after SwiGLU over all I columns, recomputed in every block;
// and the next layer's prologue is the residual add and its RMSNorm. After
// the last layer: the final norm (block 0 writes the hidden), then in
// sample mode the codec head's tiles, a barrier, and block 0's sampler.
// dyn_int8 quantizes each GEMV input once per block in its prologue.
//
// The weights of each phase are read from device memory in it
// (``frame_gemv_tiles``, K2's tiles, in batches of 4 rows whose next
// batch's loads are issued before this one's multiply-adds: on an H100
// 80GB HBM3 at 700 W 1-8 % faster a step than K2's 8 loads a batch, 2.52
// against 2.72-2.75 ms at 1.7B int8, pos 40; tools/time_k3_k2.py --parts
// k1b1, two trees in turns; dyn_int8 keeps K2's form). Copying each
// block's share of the next GEMV's weights into shared memory one phase
// ahead (bulk async copies, one a tile row, completing on an mbarrier a
// slot, two slots) made the step 0.44-0.87 ms slower (1.81 against 1.37
// ms at 0.6B int8, pos 40): it was measured and taken out.
//
// ``cut`` (timing only; 0 on every call of the port) stops the work after a
// kind of phase: 1 the barriers alone, 2 + the GEMV tiles, 3 + the prologues (norms, SwiGLU, the attention merge), 4 + the
// attention items, 5 (= 0) + the sampler.
//
// ``part`` (T6's ablations, tools/exp_tk_b1_ablate.py; 0 on every call of
// the port) takes a part of each layer away from this same step: 1
// ``noattn``, one item a kv head that writes the new k/v row and hands q
// (QK-normed and roped, unscaled) to the o GEMV in place of the attention
// (no prefix walk, no softmax); 2 ``nomlp``, each layer ends after o_proj
// and the residual add, normed with the next layer's input norm (no
// gate_up, no down). ``h_out`` takes h before the final norm.
#include "common.cuh"

using namespace qt;

namespace qt {
namespace {

constexpr int TF_CHUNK = 128;       // rows an attention chunk aims at (below blocks / NKV chunks)
constexpr int TF_SUB = 256;         // rows of a chunk scored at once (online softmax)
constexpr int TF_BARRIERS_PER_LAYER = 5;  // qkv, attention, o, gate_up, down
constexpr int TF_MAX_KV_HEADS = 32;       // the kv heads a bit mask of a block's needs holds
enum { TF_CUT_BARRIERS = 1, TF_CUT_GEMV, TF_CUT_PROLOGUE, TF_CUT_ATTENTION, TF_CUT_SAMPLER };
enum { TF_PART_FULL = 0, TF_PART_NOATTN, TF_PART_NOMLP };  // T6's parts of the step

// The attention's chunks of a kv head's n rows: C = ceil(n / TF_CHUNK)
// chunks, at most max(1, blocks / NKV), of ``rows`` rows each (n / C
// rounded up to 16), so that the NKV x C (kv head, chunk) items take one
// block each when the grid has at least NKV blocks. Returns C.
__host__ __device__ inline int tf_chunks(int n, int blocks, int NKV, int& rows) {
  int C = (n + TF_CHUNK - 1) / TF_CHUNK;
  C = max(1, min(C, blocks / NKV));
  rows = (n + C - 1) / C;
  rows = (rows + 15) / 16 * 16;
  return (n + rows - 1) / rows;
}

// One GEMV of the step, compact (the talker's weights are fused: one
// segment each): weight, column scales (int8) or null (bf16), rows K,
// outputs O, S splits of ``rows`` rows.
struct TfGemv {
  const void* w;
  const float* s;
  int K, O, S, rows;
};

// Offsets (in floats) of a block's shared memory, computed on the host
// (``tf_smem``): the residual stream h [H], the GEMV input xs [KMAX] and its
// dyn_int8 words xq, the tile reduction, the staged partials ps and column
// scales pscale, the attention's q/k/v [G + 2][D], scores [G][TF_SUB] and
// per-warp PV rows [PF_WARPS][G][D], the staged small vectors, the GEMV
// table, and the sampler's top-p keys.
struct TfSmem {
  int h, xs, xq, red, ps, pscale, qk, sc, pv, vec, table, keys;
  size_t bytes;
};

struct TalkerFrameArgs {
  int L, H, NQ, NKV, I, V, T, w_bf16, head_bf16, dyn, kv_quant, sample;
  int pos;          // the row's position, if offs is null
  const int* offs;  // [1] on the device, or null
  int cut;          // timing only (0 on the port's calls)
  int layer_part;   // T6's parts (TF_PART_*; 0 on the port's calls)
  float eps, scale;
  const bf16* x;  // [H]
  StackW stack;
  const float *iln, *pln, *qn, *kn, *fnorm;
  void *k_cache, *v_cache;   // [L, NKV, T, D]: bf16, or int8 with kv_quant
  float *k_scale, *v_scale;  // kv_quant: [L, NKV, T]
  const bf16 *cosr, *sinr;   // [D] rope rows at the position
  const void *head_w, *head_s;
  float* part[2];  // the two partial buffers, alternating by GEMV
  float* att;      // [NKV][cmax][G][D + 4]: an item's max, sum, -, -, then its PV row
  int cmax;
  bf16* xn;        // [H] the hidden after the final norm
  bf16* h_out;     // [H] h before the final norm, or null
  SampleArgs sa;
  unsigned* bar;   // [0] arrivals, [1] the error word; zeroed before the launch
  int* err_host;   // mapped host word: set when a wait ran past its budget
  unsigned long long budget_ns;
  TfSmem sm;
};

// Row 0 of GEMV d as a Gemv (one segment)
__device__ __forceinline__ Gemv tf_gemv(const TfGemv& d, bool wbf16) {
  Gemv g;
  g.m = mat(wbf16);
  add_seg(g.m, d.w, d.s, 0, d.K, d.O);
  g.K = d.K, g.O = d.O, g.S = d.S, g.rows = d.rows, g.kind = 0;
  return g;
}

// GEMV u of the step: 4 l + (qkv, o, gate_up, down) for layer l, 4 L the head
__device__ TfGemv tf_desc(const TalkerFrameArgs& a, int u) {
  constexpr int D = HEAD_DIM;
  TfGemv d;
  if (u == 4 * a.L) {
    d.w = a.head_w;
    d.s = a.head_bf16 ? nullptr : (const float*)a.head_s;
    d.K = a.H, d.O = a.V;
  } else {
    const int kind = u % 4;
    const LayerW w = layer_weights(u / 4, a.H, a.NQ, a.NKV, a.I, a.w_bf16 != 0, a.stack, a.pln,
                                   a.qn, a.kn);
    const Mat& m = kind == 0 ? w.qkv : kind == 1 ? w.o : kind == 2 ? w.gu : w.d;
    d.w = m.w[0];
    d.s = m.s[0];
    d.K = kind == 0 || kind == 2 ? a.H : kind == 1 ? a.NQ * D : a.I;
    d.O = kind == 0 ? (a.NQ + 2 * a.NKV) * D : kind == 2 ? 2 * a.I : a.H;
  }
  d.S = frame_split(d.K, d.O, gridDim.x, d.rows);
  return d;
}

// The qkv GEMV's outputs for kv head kvh (its G q heads, k and v; vector v
// of G + 2), finished, q/k normed and roped at the row's position, q
// scaled: qk[v][D]. The block of the chunk that holds the current token
// (``writer``) writes the new k/v row at ``pos`` (in range) of layer l's
// cache; an int8 cache takes it quantized with its row scale.
template <bool KVQ>
__device__ void tf_qkv(const TalkerFrameArgs& a, const Gemv& g, const float* part, float s, int l,
                       int kvh, int pos, bool writer, float* ps, float* pscale, float* vec,
                       float* qk) {
  constexpr int D = HEAD_DIM;
  const int NQ = a.NQ, NKV = a.NKV, G = NQ / NKV, NV = G + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto col0 = [&](int v) { return v < G ? (kvh * G + v) * D : v == G ? (NQ + kvh) * D
                                                                      : (NQ + NKV + kvh) * D; };
  for (int i = tid; i < g.S * NV * (D / 4); i += blockDim.x) {
    const int k = i / (NV * (D / 4)), r = i % (NV * (D / 4)), v = r / (D / 4), d4 = r % (D / 4);
    cp_async16(ps + (k * NV + v) * D + 4 * d4, part + (size_t)k * g.O + col0(v) + 4 * d4);
  }
  if (!g.m.wbf16)
    for (int i = tid; i < NV * (D / 4); i += blockDim.x)
      cp_async16(pscale + 4 * i, g.m.s[0] + col0(i / (D / 4)) + 4 * (i % (D / 4)));
  float* qkn = vec;                                   // [2][D] q-norm, k-norm weights
  bf16* rope = reinterpret_cast<bf16*>(vec + 2 * D);  // [2][D] cos, sin
  stage_vec(qkn, a.qn + (size_t)l * D, D * 4);
  stage_vec(qkn + D, a.kn + (size_t)l * D, D * 4);
  stage_vec(rope, a.cosr, D * 2);
  stage_vec(rope + D, a.sinr, D * 2);
  cp_async_join();
  if (warp < NV) {
    const int v = warp;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i;
      float y;
      if (s > 0.f) {
        int acc = 0;
        for (int k = 0; k < g.S; ++k) acc += reinterpret_cast<const int*>(ps)[(k * NV + v) * D + d];
        y = __fmul_rn(__int2float_rn(acc), __fmul_rn(s, pscale[v * D + d]));
      } else {
        float sum = 0.f;
        for (int k = 0; k < g.S; ++k) sum += ps[(k * NV + v) * D + d];
        y = g.m.wbf16 ? sum : __fmul_rn(sum, pscale[v * D + d]);
      }
      x[i] = rbf(y);
    }
    const size_t row = ((size_t)l * NKV + kvh) * a.T + pos;  // the new row's index in the cache
    const bool put = writer && pos >= 0 && pos < a.T;
    if (v == G + 1) {  // v: raw
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qk[v * D + lane + 32 * i] = x[i];
        m = fmaxf(m, fabsf(x[i]));
      }
      if (put) {
        if (KVQ) {
          const float sc = fmaxf(__fmul_rn(warp_max(m), 1.0f / 127.0f), 1e-12f);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            reinterpret_cast<int8_t*>(a.v_cache)[row * D + lane + 32 * i] =
                (int8_t)__float2int_rn(__fdiv_rn(x[i], sc));
          if (lane == 0) a.v_scale[row] = sc;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            reinterpret_cast<bf16*>(a.v_cache)[row * D + lane + 32 * i] = __float2bfloat16_rn(x[i]);
        }
      }
    } else {  // q heads and k: QK-norm, rope (the partner d +- 64 sits in the same lane)
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) ss = fmaf(x[i], x[i], ss);
      ss = warp_sum(ss);
      const float r = 1.0f / sqrtf(__fdiv_rn(ss, (float)D) + a.eps);
      const float* w = v < G ? qkn : qkn + D;
      float y[4], m = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = lane + 32 * i, dp = d < D / 2 ? d + D / 2 : d - D / 2;
        const float xd = rbf(__fmul_rn(__fmul_rn(x[i], r), w[d]));
        const float xp = rbf(__fmul_rn(__fmul_rn(x[i ^ 2], r), w[dp]));
        const float rot = d < D / 2 ? -xp : xp;
        y[i] = rbf(__fadd_rn(rbf(__fmul_rn(xd, bf(rope[d]))), rbf(__fmul_rn(rot, bf(rope[D + d])))));
        // the talker form scales q before the dot (T6's noattn hands it on
        // unscaled); k is kept as it is stored
        qk[v * D + d] = v < G && a.layer_part != TF_PART_NOATTN ? __fmul_rn(y[i], a.scale) : y[i];
        m = fmaxf(m, fabsf(y[i]));
      }
      if (v == G && put) {
        if (KVQ) {
          const float sc = fmaxf(__fmul_rn(warp_max(m), 1.0f / 127.0f), 1e-12f);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            reinterpret_cast<int8_t*>(a.k_cache)[row * D + lane + 32 * i] =
                (int8_t)__float2int_rn(__fdiv_rn(y[i], sc));
          if (lane == 0) a.k_scale[row] = sc;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            reinterpret_cast<bf16*>(a.k_cache)[row * D + lane + 32 * i] = __float2bfloat16_rn(y[i]);
        }
      }
    }
  }
  __syncthreads();
}

// 16 bytes of cache row values widened to f32: 8 bf16 or 16 int8
__device__ __forceinline__ void kv_widen(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void kv_widen(const uint4& u, float (&f)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f[4 * i + j] = (float)(int8_t)(w[i] >> (8 * j));
}

// One attention item: kv head kvh over rows [r0, r1) of its n rows (row
// n - 1 is the current token, in the last chunk only): its running max m,
// sum l and unnormalised PV row per q head into ``att``. As attn_step's
// talker form: q scaled before the dot, an online softmax over sub-tiles of
// TF_SUB rows, f32 weights; on an int8 cache the K row scale folds into the
// score and the V row scale into the weight, and the current token joins
// with its own unquantized k and v. This pass takes the GP q heads from g0
// (the item's G heads go two at a time, so that a lane's q values and
// accumulators stay in registers at any group size); qk holds the item's
// q heads, k and v (``tf_qkv``). (Asking for a sub-tile's rows in one
// batch of 8 loads a lane, the first before ``tf_qkv``, made the whole step
// 0.6 ms slower on an H100: more registers live, more spills.)
template <int GP, bool KVQ>
__device__ void tf_item_heads(const TalkerFrameArgs& a, int g0, int l, int n, int kvh, int c,
                              int rows, const float* qk, float* sc, float* pv) {
  constexpr int D = HEAD_DIM;
  constexpr int EPL = KVQ ? 16 : 8;      // values in a lane's 16 bytes of a row
  constexpr int LPR = D / EPL;           // lanes a row: 16 (bf16) or 8 (int8)
  constexpr int RPW = 32 / LPR;          // rows a warp reads at once
  constexpr int RIF = 4;                 // rows a lane has in flight
  constexpr int NRG = PF_THREADS / LPR;  // PV: row groups
  using KV = typename std::conditional<KVQ, int8_t, bf16>::type;
  __shared__ float m_run[GP], l_run[GP], alpha[GP];
  const int G = a.NQ / a.NKV, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = c * rows, r1 = min(r0 + rows, n), pre_end = min(r1, n - 1);
  const bool last = r1 == n;
  const size_t head = ((size_t)l * a.NKV + kvh) * a.T;  // this kv head's row 0
  const KV* kbase = reinterpret_cast<const KV*>(a.k_cache) + head * D;
  const KV* vbase = reinterpret_cast<const KV*>(a.v_cache) + head * D;
  const float* ksr = KVQ ? a.k_scale + head : nullptr;
  const float* vsr = KVQ ? a.v_scale + head : nullptr;
  const int hl = lane % LPR, hr = lane / LPR;  // scores: LPR lanes a row
  const int dg = tid % LPR, rg = tid / LPR;    // PV: column group of EPL values, row group
  float qv[GP][EPL];
#pragma unroll
  for (int gg = 0; gg < GP; ++gg)
#pragma unroll
    for (int i = 0; i < EPL; ++i) qv[gg][i] = qk[(g0 + gg) * D + hl * EPL + i];
  if (tid < GP) {
    m_run[tid] = -CUDART_INF_F;
    l_run[tid] = 0.f;
  }
  __syncthreads();
  float acc[GP][EPL];
#pragma unroll
  for (int gg = 0; gg < GP; ++gg)
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[gg][i] = 0.f;
  for (int t0 = r0; t0 < pre_end; t0 += TF_SUB) {
    const int nt = min(TF_SUB, pre_end - t0);
    for (int tb = warp * RPW; tb < nt; tb += PF_WARPS * RPW * RIF) {  // uniform in the warp
      uint4 kr[RIF];
#pragma unroll
      for (int j = 0; j < RIF; ++j) {
        const int t = tb + hr + j * PF_WARPS * RPW;
        kr[j] = t < nt ? __ldg(reinterpret_cast<const uint4*>(kbase + (size_t)(t0 + t) * D) + hl)
                       : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < RIF; ++j) {  // every lane takes part in the shuffles
        const int t = tb + hr + j * PF_WARPS * RPW;
        float kf[EPL];
        kv_widen(kr[j], kf);
#pragma unroll
        for (int gg = 0; gg < GP; ++gg) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < EPL; ++i) d = fmaf(qv[gg][i], kf[i], d);
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
          if (hl == 0 && t < nt) sc[gg * TF_SUB + t] = KVQ ? __fmul_rn(d, ksr[t0 + t]) : d;
        }
      }
    }
    __syncthreads();
    if (warp < GP) {  // warp g folds head g's scores into its running max and sum
      float* sg = sc + warp * TF_SUB;
      float m = -CUDART_INF_F;
      for (int t = lane; t < nt; t += 32) m = fmaxf(m, sg[t]);
      const float m_new = fmaxf(m_run[warp], warp_max(m));
      float ls = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float e = expf(sg[t] - m_new);
        sg[t] = KVQ ? __fmul_rn(e, vsr[t0 + t]) : e;
        ls += e;
      }
      ls = warp_sum(ls);
      if (lane == 0) {
        const float al = expf(m_run[warp] - m_new);  // 0 on the first sub-tile
        alpha[warp] = al;
        l_run[warp] = fmaf(l_run[warp], al, ls);
        m_run[warp] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int gg = 0; gg < GP; ++gg)
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[gg][i] *= alpha[gg];
    for (int tb = rg; tb < nt; tb += NRG * RIF) {
      uint4 vr[RIF];
#pragma unroll
      for (int j = 0; j < RIF; ++j) {
        const int t = tb + j * NRG;
        vr[j] = t < nt ? __ldg(reinterpret_cast<const uint4*>(vbase + (size_t)(t0 + t) * D) + dg)
                       : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < RIF; ++j) {
        const int t = tb + j * NRG;
        if (t >= nt) break;
        float vf[EPL];
        kv_widen(vr[j], vf);
#pragma unroll
        for (int gg = 0; gg < GP; ++gg) {
          const float w = sc[gg * TF_SUB + t];
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[gg][i] = fmaf(w, vf[i], acc[gg][i]);
        }
      }
    }
    __syncthreads();  // the next sub-tile overwrites sc
  }
  // the row groups of a warp, then the warps (in order: the sum does not
  // depend on timing)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int gg = 0; gg < GP; ++gg)
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[gg][i] += __shfl_xor_sync(0xffffffffu, acc[gg][i], o);
  if (lane < LPR)
#pragma unroll
    for (int gg = 0; gg < GP; ++gg)
#pragma unroll
      for (int i = 0; i < EPL; ++i) pv[(warp * GP + gg) * D + dg * EPL + i] = acc[gg][i];
  if (last && warp < GP) {  // the current token: its score with its own k
    const float* q = qk + (g0 + warp) * D + lane * 4;
    const float* k = qk + G * D + lane * 4;
    float d = q[0] * k[0];
    d = fmaf(q[1], k[1], d);
    d = fmaf(q[2], k[2], d);
    d = fmaf(q[3], k[3], d);
    d = warp_sum(d);
    if (lane == 0) {
      const float m_f = fmaxf(m_run[warp], d);
      const float al = expf(m_run[warp] - m_f), p = expf(d - m_f);
      alpha[warp] = al;
      sc[warp] = p;  // the scores are no longer needed
      l_run[warp] = fmaf(l_run[warp], al, p);
      m_run[warp] = m_f;
    }
  }
  __syncthreads();
  float* out = a.att + (((size_t)kvh * a.cmax + c) * G + g0) * (D + 4);
  for (int i = tid; i < GP * D; i += blockDim.x) {
    const int gg = i / D, d = i % D;
    float sum = 0.f;
    for (int w = 0; w < PF_WARPS; ++w) sum += pv[(w * GP + gg) * D + d];
    if (last) sum = fmaf(sc[gg], qk[(G + 1) * D + d], sum * alpha[gg]);
    out[gg * (D + 4) + 4 + d] = sum;
    if (d == 0) {
      out[gg * (D + 4)] = m_run[gg];
      out[gg * (D + 4) + 1] = l_run[gg];
    }
  }
  __syncthreads();  // the next pass reuses the shared arrays
}

// The attention phase: this block's (kv head, chunk) items, each its qkv
// outputs finished (``tf_qkv``), then its q heads two at a time. Inline,
// and entered only by the blocks with an item: out of line, the call's
// register saves to local memory cost 4-8 us a layer on an H100 (the step
// 1.44 against 1.30 ms at 0.6B int8, pos 40), more than its extra spills
// inline cost.
template <bool KVQ>
__device__ __forceinline__ void tf_attention(const TalkerFrameArgs& a, const Gemv& g,
                                          const float* part, float s, int l, int pos, int n,
                                          int C, int rows, float* ps, float* pscale, float* vec,
                                          float* qk, float* sc, float* pv) {
  constexpr int D = HEAD_DIM;
  const int G = a.NQ / a.NKV;
  for (int it = blockIdx.x; it < a.NKV * C; it += gridDim.x) {
    const int kvh = it / C, c = it % C;
    tf_qkv<KVQ>(a, g, part, s, l, kvh, pos, (c + 1) * rows >= n, ps, pscale, vec, qk);
    if (a.layer_part == TF_PART_NOATTN) {  // T6: q itself, as one chunk of max 0 and sum 1
      float* p = a.att + (size_t)kvh * a.cmax * G * (D + 4);
      for (int i = threadIdx.x; i < G * (D + 4); i += blockDim.x) {
        const int gq = i / (D + 4), d = i % (D + 4);
        p[i] = d == 1 ? 1.f : d < 4 ? 0.f : qk[gq * D + d - 4];
      }
      __syncthreads();  // qk is read before the next item's tf_qkv writes it
      continue;
    }
    for (int g0 = 0; g0 < G; g0 += 2) {
      if (G - g0 >= 2) tf_item_heads<2, KVQ>(a, g0, l, n, kvh, c, rows, qk, sc, pv);
      else tf_item_heads<1, KVQ>(a, g0, l, n, kvh, c, rows, qk, sc, pv);
    }
  }
}

// The o GEMV's input: each needed head's chunks merged (running max,
// rescaled sums; the chunks of a head in order), divided once and rounded to
// bf16 into xs. Returns max |xs| over them.
__device__ float tf_merge(const TalkerFrameArgs& a, int C, unsigned need, float* xs, float* red) {
  constexpr int D = HEAD_DIM;
  const int G = a.NQ / a.NKV;
  float mx = 0.f;
  for (int i = threadIdx.x; i < a.NQ * D; i += blockDim.x) {
    const int qh = i / D, d = i % D, kvh = qh / G;
    if (!(need >> kvh & 1u)) continue;
    const float* p = a.att + ((size_t)kvh * a.cmax * G + qh % G) * (D + 4);
    float M = -CUDART_INF_F, Ls = 0.f, acc = 0.f;
    for (int c = 0; c < C; ++c, p += G * (D + 4)) {
      const float m = __ldcg(p), ls = __ldcg(p + 1), v = __ldcg(p + 4 + d);
      const float mn = fmaxf(M, m), e0 = expf(M - mn), e1 = expf(m - mn);
      Ls = fmaf(Ls, e0, ls * e1);
      acc = fmaf(acc, e0, v * e1);
      M = mn;
    }
    const float o = rbf(__fdiv_rn(acc, Ls));
    xs[i] = o;
    mx = fmaxf(mx, fabsf(o));
  }
  return block_max(mx, red);
}

// The sampler in block 0 (out of line: its 8 ids a thread at V > 2048 do
// not raise the rest of the kernel's registers), on the head GEMV's staged
// logits: f32(acc) * (s * scale) in dyn_int8 (the talker's head), the
// weight-only forms as mv_out gives them.
__device__ __noinline__ void tf_sample(const TalkerFrameArgs& a, const Gemv& g, const float* part,
                                       float head_amax, float* ps, float* pscale,
                                       unsigned long long* keys) {
  const Staged t = frame_stage(g, part, ps, pscale);
  const float s_head = a.dyn && !a.head_bf16 ? act_scale(head_amax) : 0.f;
  auto logit = [&](int c) { return mvs(t, c, s_head); };
  const bool narrow = a.V <= PF_THREADS * SAMPLE_PER_THREAD;
  if (a.sa.top_p_thr > 0.f) {
    if (narrow) sample_block<true, SAMPLE_PER_THREAD>(a.V, a.sa, 0, keys, logit);
    else sample_block<true, PF_SAMPLE_PER_THREAD>(a.V, a.sa, 0, keys, logit);
  } else {
    if (narrow) sample_block<false, SAMPLE_PER_THREAD>(a.V, a.sa, 0, keys, logit);
    else sample_block<false, PF_SAMPLE_PER_THREAD>(a.V, a.sa, 0, keys, logit);
  }
}

// A block that leaves the step on a fault marks its outputs: code -1 and a
// NaN hidden, so that no caller takes them for a result (the host flag makes
// the wrapper raise)
__device__ void tf_fail(const TalkerFrameArgs& a) {
  if (threadIdx.x == 0 && a.sample) a.sa.code_out[0] = -1;
  for (int c = threadIdx.x; c < a.H; c += blockDim.x) a.xn[c] = __float2bfloat16_rn(CUDART_NAN_F);
}

__global__ void __launch_bounds__(PF_THREADS, 1)
talker_frame(const __grid_constant__ TalkerFrameArgs a) {
  extern __shared__ __align__(16) float fsm[];
  const TfSmem& f = a.sm;
  const int H = a.H, L = a.L, G = a.NQ / a.NKV, tid = threadIdx.x;
  float* h = fsm + f.h;
  float* xs = fsm + f.xs;
  int* xq = reinterpret_cast<int*>(fsm + f.xq);
  float* red = fsm + f.red;
  float* ps = fsm + f.ps;
  float* pscale = fsm + f.pscale;
  float* vec = fsm + f.vec;
  TfGemv* table = reinterpret_cast<TfGemv*>(fsm + f.table);
  const int cut = a.cut == 0 ? TF_CUT_SAMPLER : a.cut;
  const int ng = 4 * L + (a.sample ? 1 : 0);  // the step's GEMVs
  for (int u = tid; u < ng; u += blockDim.x) table[u] = tf_desc(a, u);
  __syncthreads();
  auto wbf16_of = [&](int n) { return n < 4 * L ? a.w_bf16 != 0 : a.head_bf16 != 0; };
  auto gemv_of = [&](int n) { return tf_gemv(table[n], wbf16_of(n)); };
  const int pos = a.offs ? a.offs[0] : a.pos;
  const int n_rows = pos >= 0 && pos < a.T ? pos + 1 : 1;  // out of range: the current token alone
  int crows;
  int C = tf_chunks(n_rows, gridDim.x, a.NKV, crows);
  if (a.layer_part == TF_PART_NOATTN) C = 1, crows = n_rows;  // one item a kv head, no prefix walk
  const bool work = cut >= TF_CUT_PROLOGUE;
  unsigned target = 0;
  float amax = 0.f, s_in = 0.f;
  bool ok = true;
  // GEMV n on this block's tiles (x quantized if ``dq``), then the barrier
  auto gemv_phase = [&](int n, bool dq) {
    if (cut >= TF_CUT_GEMV) {
      const Gemv g = gemv_of(n);
      s_in = dq ? frame_quant(xs, g.K, amax, xq) : 0.f;
      __syncthreads();
      float* part = a.part[n & 1];
      if (dq) frame_gemv_tiles<int8_t, true>(g, xs, xq, part, red);
      else if (g.m.wbf16) frame_gemv_tiles<bf16, false, true>(g, xs, xq, part, red);
      else frame_gemv_tiles<int8_t, false, true>(g, xs, xq, part, red);
    }
    target += gridDim.x;
    return grid_barrier(a.bar, a.err_host, a.budget_ns, target);
  };
  // the last GEMV's output staged for its consumer, with the weights ``nw``
  // of the norm that follows it (or none)
  auto staged = [&](int n, const float* nw) {
    const Staged t = frame_stage_start(gemv_of(n), a.part[n & 1], ps, pscale);
    if (nw) stage_vec(vec, nw, H * 4);
    cp_async_join();
    return t;
  };
  const bool dq = a.dyn != 0, dq_head = a.dyn && !a.head_bf16;
  if (work) {  // h = x, xs = rms(h): the row and the norm staged
    bf16* row = reinterpret_cast<bf16*>(ps);
    stage_vec(row, a.x, H * 2);
    stage_vec(vec, a.iln, H * 4);
    cp_async_join();
    float ss = 0.f;
    for (int c = tid; c < H; c += blockDim.x) {
      const float v = bf(row[c]);
      h[c] = v;
      ss = fmaf(v, v, ss);
    }
    amax = frame_norm(h, ss, vec, xs, H, a.eps, red);
  }
  const unsigned all = a.NKV == 32 ? ~0u : (1u << a.NKV) - 1u;
  for (int l = 0; l < L && ok; ++l) {
    const int n = 4 * l;
    if (!gemv_phase(n, dq)) { ok = false; break; }  // qkv
    if (cut >= TF_CUT_ATTENTION && (int)blockIdx.x < a.NKV * C) {  // the blocks with an item
      const Gemv g = gemv_of(n);
      float* qk = fsm + f.qk;
      float* sc = fsm + f.sc;
      float* pv = fsm + f.pv;
      if (a.kv_quant)
        tf_attention<true>(a, g, a.part[n & 1], s_in, l, pos, n_rows, C, crows, ps, pscale, vec,
                           qk, sc, pv);
      else
        tf_attention<false>(a, g, a.part[n & 1], s_in, l, pos, n_rows, C, crows, ps, pscale,
                            vec, qk, sc, pv);
    }
    target += gridDim.x;
    if (!grid_barrier(a.bar, a.err_host, a.budget_ns, target)) { ok = false; break; }
    if (work) amax = tf_merge(a, C, dq ? all : o_heads(gemv_of(n + 1), G), xs, red);
    if (!gemv_phase(n + 1, dq)) { ok = false; break; }  // o
    const float* nw = l + 1 < L ? a.iln + (size_t)(l + 1) * H : a.fnorm;
    if (a.layer_part == TF_PART_NOMLP) {  // T6: the layer ends here
      if (work) amax = frame_residual_norm(staged(n + 1, nw), s_in, nullptr, h, vec, xs, H, a.eps, red);
      continue;
    }
    if (work)
      amax = frame_residual_norm(staged(n + 1, a.pln + (size_t)l * H), s_in, nullptr, h, vec, xs,
                                 H, a.eps, red);
    if (!gemv_phase(n + 2, dq)) { ok = false; break; }  // gate_up
    if (work) amax = frame_swiglu(staged(n + 2, nullptr), s_in, a.I, xs, red);
    if (!gemv_phase(n + 3, dq)) { ok = false; break; }  // down
    if (work)
      amax = frame_residual_norm(staged(n + 3, nw), s_in, nullptr, h, vec, xs, H, a.eps, red);
  }
  if (!ok) return tf_fail(a);
  if (blockIdx.x == 0)  // the hidden the code predictor consumes (and T6's h)
    for (int c = tid; c < H; c += blockDim.x) {
      a.xn[c] = __float2bfloat16_rn(xs[c]);
      if (a.h_out) a.h_out[c] = __float2bfloat16_rn(h[c]);
    }
  if (a.sample) {
    const float head_amax = amax;
    if (!gemv_phase(4 * L, dq_head)) return tf_fail(a);
    if (blockIdx.x == 0 && cut >= TF_CUT_SAMPLER)
      tf_sample(a, gemv_of(4 * L), a.part[(4 * L) & 1], head_amax, ps, pscale,
                reinterpret_cast<unsigned long long*>(fsm + f.keys));
  }
  // a block that timed out at the last barrier left while block 0 went on:
  // block 0 reads the error word once more
  if (blockIdx.x == 0) {
    __shared__ int fault;
    if (tid == 0) fault = ld_acquire(a.bar + 1) != 0;
    __syncthreads();  // and the last outputs are written before the marks
    if (fault) tf_fail(a);
  }
}

// The shared-memory layout of a block at ``blocks`` blocks; false if it
// does not fit in ``limit`` bytes.
bool tf_smem(const TalkerFrameArgs& a, int blocks, size_t limit, TfSmem& f) {
  const int D = HEAD_DIM, G = a.NQ / a.NKV, OQKV = (a.NQ + 2 * a.NKV) * D;
  const int kmax = max(max(a.H, a.NQ * D), a.I);
  const int shapes[5][2] = {{a.H, OQKV}, {a.NQ * D, a.H}, {a.H, 2 * a.I}, {a.I, a.H}, {a.H, a.V}};
  int pmax = 0, omax = 0, rows;
  for (int i = 0; i < (a.sample ? 5 : 4); ++i) {
    pmax = max(pmax, frame_split(shapes[i][0], shapes[i][1], blocks, rows) * shapes[i][1]);
    omax = max(omax, shapes[i][1]);
  }
  int n2 = 1;
  while (n2 < a.V) n2 <<= 1;
  int o = 0;
  f.h = o, o += up4(a.H);
  f.xs = o, o += up4(kmax);
  f.xq = o, o += up4(kmax / 4);
  f.red = o, o += up4(PF_WARPS * 33);
  f.ps = o, o += up4(pmax);
  f.pscale = o, o += a.w_bf16 && (a.head_bf16 || !a.sample) ? 0 : up4(omax);
  f.qk = o, o += up4((G + 2) * D);
  f.sc = o, o += up4(G * TF_SUB);
  f.pv = o, o += PF_WARPS * G * D;
  f.vec = o, o += up4(a.H) + 3 * D;
  f.table = o, o += up4((4 * a.L + 1) * (int)(sizeof(TfGemv) / sizeof(float)));
  f.keys = o, o += a.sample ? 2 * n2 : 0;  // n2 keys of 8 bytes
  f.bytes = (size_t)o * sizeof(float);
  return f.bytes <= limit;
}

// One step through ``talker_frame``: the barrier words zeroed, then one
// cooperative launch of ``blocks`` blocks (0: one per SM) if they can all
// be resident at once, else cudaErrorCooperativeLaunchTooLarge with
// nothing enqueued.
int talker_frame_launch(TalkerFrameArgs& fa, int blocks, cudaStream_t st) {
  const int nb = blocks > 0 ? blocks : num_sms();
  // the kernel's static shared memory and the device's opt-in limit, and
  // the dynamic limit set so far: one entry a device (device_state.cuh)
  static std::atomic<size_t> static_smem[QT_MAX_DEVICES], smem_set[QT_MAX_DEVICES];
  const int dev = current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (static_smem[dev].load() == 0) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, talker_frame);
    if (e != cudaSuccess) return (int)e;
    static_smem[dev].store(attr.sharedSizeBytes + 1);  // + 1: read, even where it is 0
  }
  const size_t optin = (size_t)device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(0);
  if (optin == 0) return (int)cudaErrorInvalidValue;
  if (fa.cmax < max(1, nb / fa.NKV)) return (int)cudaErrorInvalidValue;
  if (!tf_smem(fa, nb, optin - (static_smem[dev].load() - 1), fa.sm))
    return (int)cudaErrorInvalidValue;
  const cudaError_t se = allow_smem(talker_frame, fa.sm.bytes, smem_set);
  if (se != cudaSuccess) return (int)se;
  int occ = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, talker_frame,
                                                                      PF_THREADS, fa.sm.bytes);
  if (e != cudaSuccess) return (int)e;
  if (occ * num_sms() < nb) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaMemsetAsync(fa.bar, 0, 2 * sizeof(unsigned), st);
  QT_CHECK_LAUNCH();
  void* args[] = {&fa};
  const cudaError_t le =
      cudaLaunchCooperativeKernel((const void*)talker_frame, nb, PF_THREADS, args, fa.sm.bytes, st);
  if (le != cudaSuccess) {
    cudaGetLastError();
    return (int)le;
  }
  QT_CHECK_LAUNCH();
  return 0;
}

}  // namespace
}  // namespace qt

// One talker decode step at B = 1 (see the note above); the operands as
// qt_talker_step's at B = 1, the caches [L, 1, NKV, T, D] (and scales
// [L, 1, NKV, T]). ``offs``: the position on the device ([1] int32), else
// ``pos``. ``ws`` holds the two partial buffers (2 x PF_MAX_SPLIT x the
// widest output floats), ``att`` the attention items' partials
// [NKV][cmax][G][D + 4] with cmax >= max(1, blocks / NKV); ``ctl`` two uint32
// of device memory (the barrier's words, zeroed here), ``err_host`` one
// int32 of pinned host memory (set to 1 when a wait ran past ``budget_ns``);
// ``blocks`` the grid (0: one block per SM); ``cut``, ``part`` 0 and ``h_out``
// null on the port's calls (T6 passes a part and [H] for h before the final
// norm). Sample mode when ``head_w`` is given: code_out [1], logits_out [V]
// or null. xn [H] takes the hidden after the final norm.
extern "C" int qt_talker_frame(
    int L, int H, int NQ, int NKV, int D, int I, int V, int T, int pos, const void* offs,
    int kv_quant, int w_bf16, int head_bf16, int dyn, float eps, float scale,
    const void* x,
    const void* qkv_w, const void* qkv_s, const void* o_w, const void* o_s,
    const void* gu_w, const void* gu_s, const void* d_w, const void* d_s,
    const void* iln, const void* pln, const void* qn, const void* kn, const void* fnorm,
    void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* cosr, const void* sinr,
    const void* head_w, const void* head_s, const void* supp, const void* seen,
    float rep, int greedy, float inv_t, int top_k, float top_p_thr, int ref_exact, int eos_id,
    uint32_t seed0, uint32_t seed1, void* ws, void* att, int cmax, void* xn,
    void* code_out, void* logits_out, void* ctl, void* err_host, int blocks,
    long long budget_ns, int cut, int part, void* h_out, void* stream) {
  const StackW stack = {qkv_w, qkv_s, nullptr, nullptr, nullptr, nullptr, o_w, o_s,
                        gu_w, gu_s, nullptr, nullptr, d_w, d_s};
  if (D != HEAD_DIM || NQ % NKV != 0 || NQ / NKV > ATTN_MAX_GROUP || NKV > TF_MAX_KV_HEADS ||
      V > SAMPLE_THREADS * SAMPLE_PER_THREAD || (offs == nullptr && (pos < 0 || pos >= T)) ||
      (kv_quant && (k_scale == nullptr || v_scale == nullptr)) || !stack_ok(stack, w_bf16 != 0) ||
      (head_w != nullptr && !head_bf16 && head_s == nullptr) || (dyn && w_bf16) ||
      H % 16 || I % 16 || V % 16 || ctl == nullptr || err_host == nullptr || budget_ns <= 0 ||
      cut < 0 || cut > TF_CUT_SAMPLER || part < TF_PART_FULL || part > TF_PART_NOMLP ||
      att == nullptr || xn == nullptr)
    return (int)cudaErrorInvalidValue;
  TalkerFrameArgs fa;
  fa.L = L, fa.H = H, fa.NQ = NQ, fa.NKV = NKV, fa.I = I, fa.V = V, fa.T = T;
  fa.w_bf16 = w_bf16, fa.head_bf16 = head_bf16, fa.dyn = dyn, fa.kv_quant = kv_quant;
  fa.sample = head_w != nullptr;
  fa.pos = pos, fa.offs = (const int*)offs, fa.cut = cut, fa.layer_part = part;
  fa.eps = eps, fa.scale = scale;
  fa.x = (const bf16*)x;
  fa.stack = stack;
  fa.iln = (const float*)iln, fa.pln = (const float*)pln, fa.qn = (const float*)qn;
  fa.kn = (const float*)kn, fa.fnorm = (const float*)fnorm;
  fa.k_cache = k_cache, fa.v_cache = v_cache;
  fa.k_scale = (float*)k_scale, fa.v_scale = (float*)v_scale;
  fa.cosr = (const bf16*)cosr, fa.sinr = (const bf16*)sinr;
  fa.head_w = head_w, fa.head_s = head_s;
  const int max_o = max(max((NQ + 2 * NKV) * D, 2 * I), max(H, V));
  fa.part[0] = (float*)ws;
  fa.part[1] = (float*)ws + (size_t)PF_MAX_SPLIT * max_o;
  fa.att = (float*)att, fa.cmax = cmax;
  fa.xn = (bf16*)xn, fa.h_out = (bf16*)h_out;
  SampleArgs& sa = fa.sa;
  sa = SampleArgs{};
  sa.supp = (const float*)supp;
  sa.seen = (const uint8_t*)seen;
  sa.rep = rep;
  sa.greedy = greedy;
  sa.inv_t = inv_t;
  sa.top_k = top_k;
  sa.top_p_thr = top_p_thr;
  sa.ref_exact = ref_exact;
  sa.eos_id = eos_id;
  sa.seed0 = seed0;
  sa.seed1 = seed1;
  sa.stream = 0;
  sa.code_out = (int*)code_out;
  sa.code_stride = 1;
  sa.logits_out = (float*)logits_out;
  sa.logits_stride = V;
  sa.H = H;
  sa.cp_head = 0;
  fa.bar = (unsigned*)ctl;
  void* err_dev = nullptr;
  const cudaError_t e = cudaHostGetDevicePointer(&err_dev, err_host, 0);
  if (e != cudaSuccess) return (int)e;
  fa.err_host = (int*)err_dev;
  fa.budget_ns = (unsigned long long)budget_ns;
  return talker_frame_launch(fa, blocks, (cudaStream_t)stream);
}
