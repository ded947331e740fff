// K2: the code predictor's whole inner loop for one frame of B rows
// (1 <= B <= 256), for Hopper (sm_90a).
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
// projection) runs on the tensor cores: common.cuh's ``gemv`` takes
// ``gemv_batched_mma`` (int8 widened to bf16 in shared memory, or bf16 as
// it is; mma.sync m16n8k16 -> f32) and
// ``gemv_batched_dq_mma`` (dyn_int8: the dp4a words as the m16n8k32 s8
// operand -> exact s32). The operands are swapped, weights as A (16 output
// columns a tile), x as B (8 batch rows a tile): the batch is the short side
// and goes in steps of 8, where x as A would pad it to 16; this form was
// chosen on that count and the other was not built. The partials and the
// finishing kernels are the CUDA-core form's (the split may go twice as
// deep, TC_MAX_PARTS), so the launches per call do not change; past 64 rows
// the GEMVs take the batch in groups of 64 (common.cuh's BG_GROUP), and at
// B = 256 a frame is ~660 GFLOP, 0.67 ms at the bf16 rate. At B > 1 the
// 16 positions are one host loop of launches (1 + 16 (1 + 8 L) + 30) with no
// host synchronisation (one ctypes call per frame); the sampler fetches the
// sampled code's embedding row by index (2-4 KB) instead of the TPU
// kernel's one-hot matmul over the table. Layers run through the same GEMV,
// attention and sampler kernels as K1 (common.cuh).
//
// At B = 1 the frame is one persistent kernel (``cp_frame`` below; its note
// gives the design): 687 launches of ~5 us each, each GEMV one memory
// latency plus a launch, took 3.5-3.9 ms of device time for 0.386 ms of
// bytes (NVIDIA H100 80GB HBM3, 700 W).
#include "common.cuh"

using namespace qt;

// ---------------------------------------------------------------------------
// The persistent frame at B = 1 (``cp_frame``): one cooperative launch of one
// block of PF_THREADS threads per SM, all resident, that walks the frame's
// phases in order with a grid-wide barrier between dependent ones.
//
// Phases. Each GEMV of the frame is one phase: this block's tiles of it (a
// tile = 32 output columns over one split of the rows; a GEMV has S splits,
// S ~ blocks / (O / 32), so that it has about one tile per block), then a
// barrier. Everything between two GEMVs is the prologue of the next one,
// recomputed by every block, so it needs no barrier of its own:
//  - the residual stream h lives in each block's shared memory; the residual
//    add and the RMSNorm after o_proj and down_proj (and the projection's
//    bias at 1.7B) are computed by every block, bit-equal in all of them;
//  - SwiGLU over all I columns, before the down GEMV;
//  - the attention, before the o GEMV: each block attends the kv heads whose
//    outputs its o tiles read (all of them in dyn_int8, whose input scale is
//    the amax of the whole row); block kvh % blocks writes head kvh's new
//    k/v row, which every block also holds itself;
//  - dyn_int8: each GEMV input's amax and its quantized words, in every
//    block (the slots and atomics of the multi-launch form are not needed).
// A prologue first copies what it reads from the L2 into shared memory with
// every load in flight at once (the last GEMV's partials and column scales;
// the attention's cache rows), so it costs about one L2 round trip, not one
// per element. What remains are the barriers: one after each GEMV (qkv, o,
// gate_up, down per layer, the projection at 1.7B, the head per code) and
// one after the sampler (block 0 alone: the sampled code feeds every
// block's next position); position 0's last layer ends after its attention
// (only its cache rows are used). At the 0.6B shapes 17 + 15 x 22 - 1 =
// 346 barriers a frame, in place of ~690 launches. Two partial buffers
// alternate by GEMV, so a block that runs ahead never overwrites partials a
// slower block still reads.
//
// Weights. A GEMV reads its tiles from device memory, 8 loads of 16 bytes
// a thread in flight. A tile's lanes each own one 16-byte column unit and
// every EPL-th row; the reduction over a unit's lanes is a reduce-scatter
// (``frame_reduce``: each lane ends with one column), then over the warps
// through shared memory. dyn_int8 tiles take 4 rows at a time with dp4a on
// words quantized in the prologue (exact int32 sums, as before). The
// frame's bytes are 16 x 78.6 MB of int8 layers + 15 x 2 MB of heads at
// 0.6B (0.386 ms at 3.35 TB/s).
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; tools/time_k3_k2.py's cut
// profile, and a clock trace of each phase in blocks 0 and last that the
// kernel no longer carries): not the bytes but the chain of ~346 phases of
// ~12 us, each a barrier (~1.9 us, 0.64 ms a frame alone), a prologue's
// copy round trip and block reductions (~3 us) and a tile (~3-4 us
// whatever its size, 16-64 KB of weights). Tried and not kept,
// each measured no faster: each block asking its share of the weights of
// the GEMV 2 ahead into the L2 (``cp.async.bulk.prefetch.L2``: 0.1-0.4 ms
// a frame slower than none; 4 ahead no better), a block's tiles of
// the next GEMV copied into shared memory between the barrier's arrival and
// its wait, 1024 threads a block (spills; the barriers alone 1.41 ms), a
// back-off in the barrier's poll, every phase out of line (its code is
// ~300 KB of SASS instead of ~590 KB, but the calls cost 0.15 ms).
//
// Coherence. Anything this launch writes and another block reads (the
// partials, the next position's input row, the cache rows) is read through
// the L2 (``cp.async.cg``, ``__ldcg``), never the non-coherent path;
// weights and scales keep ``__ldg``. The barrier is a release add on one
// counter and acquire polling; its spin is bounded: past ``budget_ns`` a
// block sets the error word (every block leaves at its next wait) and a
// mapped host word that the wrapper reads and raises on; a block that
// leaves marks every code -1 (``frame_fail``).
//
// ``cut`` (timing only; 0 on every call of the port) stops the work after a
// kind of phase: 1 the barriers alone, 2 + the GEMV tiles, 3 + the
// prologues but the attention, 4 + the attention, 5 (= 0) + the sampler:
// the frame's time split by phase, as K3's cut form splits its own.
// ---------------------------------------------------------------------------
namespace qt {
namespace {

enum { CUT_BARRIERS = 1, CUT_GEMV, CUT_PROLOGUE, CUT_ATTENTION, CUT_SAMPLER };

struct FrameArgs {
  int L, H, NQ, NKV, I, V, NCB, TH, w_bf16, head_bf16, dyn;
  int cut;  // timing only: a cut (0 on the port's calls)
  float eps, scale;
  const bf16* x0;  // [2, TH]
  StackW stack;
  const float *iln, *pln, *qn, *kn, *fnorm;
  const void *lm_w, *lm_s;
  const bf16 *emb, *proj_w, *proj_b, *cos_tab, *sin_tab;
  bf16 *k_cache, *v_cache;  // [L, NKV, SLOTS, D]
  float* part[2];           // the two partial buffers
  bf16* xnext;              // [TH] the next position's input row
  float* esum;              // [TH]
  int* codes;               // [NCB]
  float* logits;            // [NCB, V] or null
  const int* force;         // [NCB] or null
  SampleArgs sa;            // the sampler's fields shared by the positions
  unsigned* bar;            // [0] arrivals, [1] the error word; zeroed before the launch
  int* err_host;            // mapped host word: set when a barrier ran past its budget
  unsigned long long budget_ns;
};

// The distinct GEMVs of a frame: 4 per layer, the NCB heads, the projection
__host__ __device__ inline int frame_descs(int L, int NCB) { return 4 * L + NCB + 1; }

// Shared memory of a block, in floats: h [H], x [KMAX] (the GEMV input,
// bf16 values in f32), xq [KMAX / 4] (its dyn_int8 words), the tile
// reduction [PF_WARPS][33], the
// staged partials [the most S x O of the frame's GEMVs] and column scales
// [the widest O], the staged cache rows (k, v: [NKV][SLOTS - 1][D] bf16),
// one region shared by the normed, roped q/k [NQ + NKV][D] with the new v
// rows [NKV][D] and by the sampler's top-p keys (block 0, between
// positions), and the small read-only vectors a prologue reads (a norm's
// weights, the q/k-norm weights and rope rows), staged with its partials.
struct FrameSmem {
  int h, xs, xq, red, ps, pscale, kv, u, vec, table;
  size_t bytes;
};


__host__ __device__ inline FrameSmem frame_smem(int L, int H, int TH, int NQ, int NKV, int I,
                                                int V, int SLOTS, int blocks) {
  const int D = HEAD_DIM, OQKV = (NQ + 2 * NKV) * D, NCB = SLOTS - 1;
  const int kmax = max(max(H, TH), max(NQ * D, I));
  const int shapes[6][2] = {{H, OQKV}, {NQ * D, H}, {H, 2 * I}, {I, H}, {H, V}, {TH, H}};
  int pmax = 0, omax = 0, rows;
  for (int i = 0; i < 6; ++i) {
    pmax = max(pmax, frame_split(shapes[i][0], shapes[i][1], blocks, rows) * shapes[i][1]);
    omax = max(omax, shapes[i][1]);
  }
  int n2 = 1;
  while (n2 < V) n2 <<= 1;
  FrameSmem f;
  int o = 0;
  f.h = o, o += up4(H);
  f.xs = o, o += up4(kmax);
  f.xq = o, o += up4(kmax / 4);
  f.red = o, o += up4(PF_WARPS * 33);
  f.ps = o, o += up4(pmax);
  f.pscale = o, o += up4(omax);
  f.kv = o, o += up4(NKV * (SLOTS - 1) * D);  // k and v rows in bf16: NKV (SLOTS - 1) D floats
  f.u = o, o += up4(max((NQ + 2 * NKV) * D, 2 * n2));
  f.vec = o, o += up4(H) + 3 * D;  // a norm's weights [H]; q/k-norm weights [2][D]; rope [2][D] bf16
  f.table = o;  // the GEMV descriptors (``frame_desc``), 16-byte aligned
  f.bytes = (size_t)o * sizeof(float) + (size_t)frame_descs(L, NCB) * sizeof(Gemv);
  return f;
}


// The frame's GEMVs in order: per position [projection] (qkv, o, gate_up,
// down) per layer, and the head at positions 1..NCB; position 0 stops after
// its last layer's qkv.
__device__ __forceinline__ int frame_gemvs(const FrameArgs& a) {
  const int pr = a.proj_w != nullptr;
  return pr + 4 * (a.L - 1) + 1 + a.NCB * (pr + 4 * a.L + 1);
}

// Descriptor u of the distinct GEMVs: 4 l + kind for layer l's, 4 L + j for
// head j, 4 L + NCB for the projection
__device__ Gemv frame_desc(const FrameArgs& a, int u) {
  const int D = HEAD_DIM;
  Gemv g;
  if (u == 4 * a.L + a.NCB) {
    g.kind = G_PROJ;
    g.m = mat(true);
    if (a.proj_w != nullptr) add_seg(g.m, a.proj_w, nullptr, 0, a.TH, a.H);
    g.K = a.TH, g.O = a.H;
  } else if (u >= 4 * a.L) {
    g.kind = G_HEAD;
    g.m = mat(a.head_bf16 != 0);
    add_seg(g.m, a.lm_w, a.lm_s, u - 4 * a.L, a.H, a.V);
    g.K = a.H, g.O = a.V;
  } else {
    const LayerW w = layer_weights(u / 4, a.H, a.NQ, a.NKV, a.I, a.w_bf16 != 0, a.stack, a.pln,
                                   a.qn, a.kn);
    g.kind = u % 4;
    if (g.kind == G_QKV) g.m = w.qkv, g.K = a.H, g.O = (a.NQ + 2 * a.NKV) * D;
    else if (g.kind == G_O) g.m = w.o, g.K = a.NQ * D, g.O = a.H;
    else if (g.kind == G_GU) g.m = w.gu, g.K = a.H, g.O = 2 * a.I;
    else g.m = w.d, g.K = a.I, g.O = a.H;
  }
  g.S = frame_split(g.K, g.O, gridDim.x, g.rows);
  return g;
}

// The distinct GEMV that the frame's GEMV n runs
__device__ __forceinline__ int frame_index(const FrameArgs& a, int n) {
  const int pr = a.proj_w != nullptr;
  const int n0 = pr + 4 * (a.L - 1) + 1, n1 = pr + 4 * a.L + 1;
  const int p = n < n0 ? 0 : 1 + (n - n0) / n1;
  const int i = (n < n0 ? n : (n - n0) % n1) - pr;
  return i < 0 ? 4 * a.L + a.NCB : p > 0 && i == 4 * a.L ? 4 * a.L + p - 1 : i;
}


// attn_step's code-predictor form for B = 1 in one block, over the kv
// heads in ``need``: the prefix rows [0, p) of their cache (layer l) and
// the qkv GEMV's partials, with the layer's q/k-norm weights and the rope
// rows at p, are copied into shared memory first (``kvs``: k then v rows,
// bf16; ``ps``/``pscale``; ``vec``), all copies in flight at once. A
// warp per q/k/v vector then finishes its 128 outputs (4 a lane), and for q
// and k applies QK-norm and rope at position p in registers (the rope
// partner d +- 64 sits in the same lane); block kvh % blocks writes head
// kvh's new k/v row into the cache (slot p). Then a warp per q head: the
// scores over rows [0, p] (the new row as this block computed it, the
// value written), the softmax, probabilities rounded to bf16, and PV.
// out[NQ * D]: bf16 values of the needed heads. Returns max |out| over them.
__device__ float frame_attention(const FrameArgs& a, const Gemv& g, const float* part, float s,
                                 int l, int p, unsigned need, float* ps, float* pscale, float* qk,
                                 float* vrow, bf16* kvs, float* vec, float* out,
                                 float* red) {
  constexpr int D = HEAD_DIM;
  const int NQ = a.NQ, NKV = a.NKV, G = NQ / NKV, SLOTS = a.NCB + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* kl = a.k_cache + (size_t)l * NKV * SLOTS * D;
  bf16* vl = a.v_cache + (size_t)l * NKV * SLOTS * D;
  bf16* ks = kvs;                                  // [NKV][SLOTS - 1][D]
  bf16* vs = kvs + (size_t)NKV * (SLOTS - 1) * D;  // the same
  const int chunks = p * D / 8;                    // 16-byte pieces of a head's prefix
  for (int i = tid; i < NKV * chunks; i += blockDim.x) {
    const int kvh = i / chunks, r = i % chunks;
    if (!(need >> kvh & 1u)) continue;
    const size_t src = (size_t)kvh * SLOTS * D + (size_t)r * 8;
    const size_t dst = (size_t)kvh * (SLOTS - 1) * D + (size_t)r * 8;
    cp_async16(ks + dst, kl + src);
    cp_async16(vs + dst, vl + src);
  }
  const Staged t = frame_stage_start(g, part, ps, pscale);
  float* qkn = vec;                                       // [2][D] q-norm, k-norm weights
  bf16* rope = reinterpret_cast<bf16*>(vec + 2 * D);      // [2][D] cos, sin at p
  stage_vec(qkn, a.qn + (size_t)l * D, D * 4);
  stage_vec(qkn + D, a.kn + (size_t)l * D, D * 4);
  stage_vec(rope, a.cos_tab + (size_t)p * D, D * 2);
  stage_vec(rope + D, a.sin_tab + (size_t)p * D, D * 2);
  cp_async_join();
  const bf16* cosr = rope;
  const bf16* sinr = rope + D;
  for (int v = warp; v < NQ + 2 * NKV; v += PF_WARPS) {  // q heads, k heads, v heads
    const int kvh = v < NQ ? v / G : (v - NQ) % NKV;
    if (!(need >> kvh & 1u)) continue;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = rbf(mvs(t, v * D + lane + 32 * i, s));
    const bool writer = kvh % (int)gridDim.x == (int)blockIdx.x;
    if (v >= NQ + NKV) {  // a v head: raw, into the cache as it is
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vrow[kvh * D + lane + 32 * i] = x[i];
        if (writer) vl[((size_t)kvh * SLOTS + p) * D + lane + 32 * i] = __float2bfloat16_rn(x[i]);
      }
      continue;
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) ss = fmaf(x[i], x[i], ss);
    ss = warp_sum(ss);
    const float r = 1.0f / sqrtf(__fdiv_rn(ss, (float)D) + a.eps);
    const float* w = v < NQ ? qkn : qkn + D;
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i, dp = d < D / 2 ? d + D / 2 : d - D / 2;
      const float xd = rbf(__fmul_rn(__fmul_rn(x[i], r), w[d]));
      const float xp = rbf(__fmul_rn(__fmul_rn(x[i ^ 2], r), w[dp]));
      const float rot = d < D / 2 ? -xp : xp;
      y[i] = rbf(__fadd_rn(rbf(__fmul_rn(xd, bf(cosr[d]))), rbf(__fmul_rn(rot, bf(sinr[d])))));
      qk[v * D + d] = y[i];
      if (v >= NQ && writer) kl[((size_t)kvh * SLOTS + p) * D + d] = __float2bfloat16_rn(y[i]);
    }
  }
  __syncthreads();
  // a warp per needed q head: its scores over rows [0, p] (row r's in lane
  // r), the softmax, and PV with lane l holding outputs d = l + 32 i; no
  // block barrier between them
  float mx = 0.f;
  for (int qh = warp; qh < NQ; qh += PF_WARPS) {
    const int kvh = qh / G;
    if (!(need >> kvh & 1u)) continue;
    const float* q = qk + qh * D + lane * 4;
    const bf16* kh = ks + (size_t)kvh * (SLOTS - 1) * D + lane * 4;
    float sr = -CUDART_INF_F;
    for (int r = 0; r <= p; ++r) {
      float k[4];
      if (r < p) {
        const uint2 kv = *reinterpret_cast<const uint2*>(kh + (size_t)r * D);
        const bf16* kb = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
        for (int i = 0; i < 4; ++i) k[i] = bf(kb[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) k[i] = qk[(NQ + kvh) * D + lane * 4 + i];
      }
      float dot = q[0] * k[0];
      dot = fmaf(q[1], k[1], dot);
      dot = fmaf(q[2], k[2], dot);
      dot = fmaf(q[3], k[3], dot);
      dot = warp_sum(dot);
      if (lane == r) sr = __fmul_rn(dot, a.scale);
    }
    const float m = warp_max(sr);
    const float e = lane <= p ? expf(sr - m) : 0.f;
    const float sum = warp_sum(e);
    const float pw = lane <= p ? rbf(__fdiv_rn(e, sum)) : 0.f;
    const bf16* vh = vs + (size_t)kvh * (SLOTS - 1) * D + lane;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < p; ++r) {
      const float w = __shfl_sync(0xffffffffu, pw, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(w, bf(vh[(size_t)r * D + 32 * i]), acc[i]);
    }
    const float wp = __shfl_sync(0xffffffffu, pw, p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float o = rbf(fmaf(wp, vrow[kvh * D + lane + 32 * i], acc[i]));
      out[qh * D + lane + 32 * i] = o;
      mx = fmaxf(mx, fabsf(o));
    }
  }
  return block_max(mx, red);
}

// What a block carries from phase to phase
struct FrameState {
  const Gemv* table;  // the distinct GEMVs (shared memory)
  const Gemv* last;   // the last GEMV run
  int n, total, cut;  // the next GEMV, the frame's GEMVs, the timing cut
  unsigned target;    // the barrier's next count
  float amax;         // dyn_int8: the amax of the next GEMV's input
  float s_in;         // dyn_int8: the scale of the last GEMV's input, else 0
  float *xs, *red, *ps, *pscale;
  int* xq;
};

// GEMV n on this block's tiles (x quantized if ``dq``), then the barrier
__device__ __forceinline__ bool frame_step(const FrameArgs& a, FrameState& st, bool dq) {
  st.last = st.table + frame_index(a, st.n);
  if (st.cut >= CUT_GEMV) {
    st.s_in = dq ? frame_quant(st.xs, st.last->K, st.amax, st.xq) : 0.f;
    __syncthreads();
    const Gemv& g = *st.last;
    float* part = a.part[st.n & 1];
    if (dq) frame_gemv_tiles<int8_t, true>(g, st.xs, st.xq, part, st.red);
    else if (g.m.wbf16) frame_gemv_tiles<bf16, false>(g, st.xs, st.xq, part, st.red);
    else frame_gemv_tiles<int8_t, false>(g, st.xs, st.xq, part, st.red);
  }
  ++st.n;
  st.target += gridDim.x;
  return grid_barrier(a.bar, a.err_host, a.budget_ns, st.target);
}

// The sampler of code j in block 0, on the head GEMV's staged logits
__device__ void frame_sample(const FrameArgs& a, FrameState& st, int j,
                                          float head_amax, unsigned long long* keys) {
  const Staged t = frame_stage(*st.last, a.part[(st.n - 1) & 1], st.ps, st.pscale);
  const bool dq = a.dyn && !a.head_bf16;
  const float s_head = dq ? act_scale(head_amax) : 0.f;
  auto logit = [&](int c) {  // the code predictor's dyn_int8 heads: (f32(acc) * s) * scale
    if (s_head > 0.f) {
      const int* pi = reinterpret_cast<const int*>(t.ps);
      int acc = 0;
      for (int k = 0; k < t.S; ++k) acc += pi[k * t.O + c];
      return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_head), t.scale[c]);
    }
    return mvs(t, c, 0.f);
  };
  SampleArgs sa = a.sa;
  sa.stream = (uint32_t)(j + 1);
  sa.code_out = a.codes + j;
  sa.logits_out = a.logits ? a.logits + (size_t)j * a.V : nullptr;
  sa.force_code = a.force ? a.force + j : nullptr;
  sa.emb = a.emb + (size_t)j * a.V * a.TH;
  // 4 ids a thread up to the code predictor's 2048, PF_SAMPLE_PER_THREAD
  // above (8 for every V spilled registers and made the whole frame ~0.35
  // ms slower on an H100)
  const bool narrow = a.V <= PF_THREADS * SAMPLE_PER_THREAD;
  if (sa.top_p_thr > 0.f) {
    if (narrow) sample_block<true, SAMPLE_PER_THREAD>(a.V, sa, 0, keys, logit);
    else sample_block<true, PF_SAMPLE_PER_THREAD>(a.V, sa, 0, keys, logit);
  } else {
    if (narrow) sample_block<false, SAMPLE_PER_THREAD>(a.V, sa, 0, keys, logit);
    else sample_block<false, PF_SAMPLE_PER_THREAD>(a.V, sa, 0, keys, logit);
  }
}

// A block that leaves the frame on a barrier fault marks every code -1
// (after block 0's own writes of them: ``grid_barrier`` ends in a block
// barrier), so that no caller takes the frame's outputs for a result; the
// host flag makes the wrapper raise.
__device__ void frame_fail(const FrameArgs& a) {
  for (int j = threadIdx.x; j < a.NCB; j += blockDim.x) a.codes[j] = -1;
}

__global__ void __launch_bounds__(PF_THREADS, 1) cp_frame(const FrameArgs a) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int D = HEAD_DIM;
  const int SLOTS = a.NCB + 1, H = a.H, G = a.NQ / a.NKV, tid = threadIdx.x;
  const FrameSmem f = frame_smem(a.L, H, a.TH, a.NQ, a.NKV, a.I, a.V, SLOTS, gridDim.x);
  float* h = fsm + f.h;
  bf16* kvs = reinterpret_cast<bf16*>(fsm + f.kv);
  float* qk = fsm + f.u;                   // [NQ + NKV][D] normed, roped q and k
  float* vrow = qk + (a.NQ + a.NKV) * D;    // [NKV][D] the new v rows
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(fsm + f.u);
  float* vec = fsm + f.vec;  // staged small vectors (a norm's weights first)
  Gemv* table = reinterpret_cast<Gemv*>(fsm + f.table);
  for (int u = tid; u < frame_descs(a.L, a.NCB); u += blockDim.x) table[u] = frame_desc(a, u);
  __syncthreads();
  FrameState st;
  st.table = st.last = table;
  st.n = 0, st.total = frame_gemvs(a), st.cut = a.cut == 0 ? CUT_SAMPLER : a.cut;
  st.target = 0, st.amax = 0.f, st.s_in = 0.f;
  st.xs = fsm + f.xs, st.red = fsm + f.red, st.ps = fsm + f.ps, st.pscale = fsm + f.pscale;
  st.xq = reinterpret_cast<int*>(fsm + f.xq);
  const bool proj = a.proj_w != nullptr;
  unsigned writers = 0u;  // the kv heads whose new rows this block writes
  for (int kvh = blockIdx.x; kvh < a.NKV; kvh += gridDim.x) writers |= 1u << kvh;
  const unsigned all = a.NKV == 32 ? ~0u : (1u << a.NKV) - 1u;
  if (blockIdx.x == 0)
    for (int c = tid; c < a.TH; c += blockDim.x) a.esum[c] = 0.f;
  const bool work = st.cut >= CUT_PROLOGUE;
  // the last GEMV's output staged for its consumer, with the weights ``nw``
  // of the norm that follows it (or none)
  auto staged = [&](const float* nw) {
    const Staged t = frame_stage_start(*st.last, a.part[(st.n - 1) & 1], st.ps, st.pscale);
    if (nw) stage_vec(vec, nw, H * 4);
    cp_async_join();
    return t;
  };
  const bool dq_layers = a.dyn != 0, dq_head = a.dyn && !a.head_bf16;
  for (int p = 0; p < SLOTS; ++p) {
    const bf16* xin = p < 2 ? a.x0 + (size_t)p * a.TH : a.xnext;
    if (proj) {  // h = bf16(bf16(xin @ proj_w) + proj_b), xs = rms(h)
      if (work)
        for (int c = tid; c < a.TH; c += blockDim.x)
          st.xs[c] = p < 2 ? bf(xin[c]) : ldcg_bf(xin + c);
      if (!frame_step(a, st, false)) return frame_fail(a);
      if (work)
        st.amax = frame_residual_norm(staged(a.iln), 0.f, a.proj_b, h, vec, st.xs, H, a.eps,
                                      st.red);
    } else if (work) {  // h = xin, xs = rms(h): the row (through the L2) and the norm staged
      bf16* row = reinterpret_cast<bf16*>(st.ps);
      stage_vec(row, xin, H * 2);
      stage_vec(vec, a.iln, H * 4);
      cp_async_join();
      float ss = 0.f;
      for (int c = tid; c < H; c += blockDim.x) {
        const float v = bf(row[c]);
        h[c] = v;
        ss = fmaf(v, v, ss);
      }
      st.amax = frame_norm(h, ss, vec, st.xs, H, a.eps, st.red);
    }
    for (int l = 0; l < a.L; ++l) {
      if (!frame_step(a, st, dq_layers)) return frame_fail(a);  // qkv
      const bool last0 = p == 0 && l + 1 == a.L;  // only the new cache rows are used
      if (st.cut >= CUT_ATTENTION) {
        const unsigned need =
            writers | (last0 ? 0u : dq_layers ? all : o_heads(table[frame_index(a, st.n)], G));
        st.amax = frame_attention(a, *st.last, a.part[(st.n - 1) & 1], st.s_in, l, p, need,
                                  st.ps, st.pscale, qk, vrow, kvs, vec, st.xs, st.red);
      }
      if (last0) break;
      if (!frame_step(a, st, dq_layers)) return frame_fail(a);  // o
      if (work)
        st.amax = frame_residual_norm(staged(a.pln + (size_t)l * H), st.s_in, nullptr, h, vec,
                                      st.xs, H, a.eps, st.red);
      if (!frame_step(a, st, dq_layers)) return frame_fail(a);  // gate_up
      if (work) st.amax = frame_swiglu(staged(nullptr), st.s_in, a.I, st.xs, st.red);
      if (!frame_step(a, st, dq_layers)) return frame_fail(a);  // down
      const float* nw = l + 1 < a.L ? a.iln + (size_t)(l + 1) * H : a.fnorm;
      if (work)
        st.amax = frame_residual_norm(staged(nw), st.s_in, nullptr, h, vec, st.xs, H, a.eps,
                                      st.red);
    }
    if (p == 0) {
      __syncthreads();  // the next position overwrites xs and h
      continue;
    }
    const float head_amax = st.amax;
    if (!frame_step(a, st, dq_head)) return frame_fail(a);
    if (blockIdx.x == 0 && st.cut >= CUT_SAMPLER) frame_sample(a, st, p - 1, head_amax, keys);
    if (p + 1 < SLOTS) {  // the sampled code's row feeds every block's next position
      st.target += gridDim.x;
      if (!grid_barrier(a.bar, a.err_host, a.budget_ns, st.target)) return frame_fail(a);
    }
  }
  // a block that timed out at the last barrier left while block 0 went on:
  // block 0 reads the error word once more
  if (blockIdx.x == 0) {
    __shared__ int fault;
    if (tid == 0) fault = ld_acquire(a.bar + 1) != 0;
    __syncthreads();  // and the last code is written before the marks
    if (fault) frame_fail(a);
  }
}

// One frame at B = 1 through ``cp_frame``: the barrier words zeroed, then
// one cooperative launch of ``blocks`` blocks (0: one per SM) if they can
// all be resident at once, else cudaErrorCooperativeLaunchTooLarge with
// nothing enqueued.
int cp_frame_launch(FrameArgs& fa, int blocks, cudaStream_t st) {
  const int nb = blocks > 0 ? blocks : num_sms();
  const FrameSmem f = frame_smem(fa.L, fa.H, fa.TH, fa.NQ, fa.NKV, fa.I, fa.V, fa.NCB + 1, nb);
  static std::atomic<size_t> smem_set[QT_MAX_DEVICES];  // one entry a device (device_state.cuh)
  const cudaError_t se = allow_smem(cp_frame, f.bytes, smem_set);
  if (se != cudaSuccess) return (int)se;
  int occ = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, cp_frame, PF_THREADS,
                                                                      f.bytes);
  if (e != cudaSuccess) return (int)e;
  if (occ * num_sms() < nb) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaMemsetAsync(fa.bar, 0, 2 * sizeof(unsigned), st);
  QT_CHECK_LAUNCH();
  void* args[] = {&fa};
  const cudaError_t le =
      cudaLaunchCooperativeKernel((const void*)cp_frame, nb, PF_THREADS, args, f.bytes, st);
  if (le != cudaSuccess) {
    cudaGetLastError();
    return (int)le;
  }
  QT_CHECK_LAUNCH();
  return 0;
}

}  // namespace
}  // namespace qt

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
// stage), see SampleArgs; ``samp_rows`` (B > 1, or null) the per-row
// sampling values [B][5] f32 (rep, greedy, inv_t, top_k, top_p_thr; rep is
// not read, as the CP applies no penalty), with top_p_thr then their
// largest; at B = 1 it must be null (row 0's values come as the scalars).
// At B = 1 (``cp_frame``): ``ctl`` two uint32 of
// device memory (the barrier's words, zeroed here), ``err_host`` one int32
// of pinned host memory (set to 1 if a barrier ran past ``budget_ns``),
// ``blocks`` the grid (0: one block per SM); ``cut`` 0 on the port's calls
// (for timing, a cut of the frame, see cp_frame); hres, xn, attn, gated and
// amax are not used, and ws holds two buffers of PF_MAX_SPLIT x O floats.
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
    uint32_t seed1, const void* samp_rows, const void* force_codes,
    void* hres, void* xn, void* attn, void* gated, void* ws, void* xbuf, void* amax,
    void* codes_out, void* esum, void* logits_out, void* ctl, void* err_host, int blocks,
    long long budget_ns, int cut, void* stream) {
  const StackW stack = {q_w, q_s, k_w, k_s, v_w, v_s, o_w, o_s, g_w, g_s, u_w, u_s, d_w, d_s};
  if (D != HEAD_DIM || NQ % NKV != 0 || NQ / NKV > ATTN_MAX_GROUP || B < 1 || B > MAX_BATCH ||
      V > SAMPLE_THREADS * SAMPLE_PER_THREAD || NCB + 1 > ATTN_TILE ||
      (proj_w == nullptr && TH != H) || (proj_w != nullptr && proj_b == nullptr) ||
      !stack_ok(stack, w_bf16 != 0) || (!head_bf16 && lm_s == nullptr) ||
      (dyn && (w_bf16 || (B > 1 && amax == nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int SLOTS = NCB + 1;
  if (B == 1) {
    if (NKV > 32 || SLOTS > 32 || ctl == nullptr || err_host == nullptr || budget_ns <= 0 ||
        cut < 0 || cut > CUT_SAMPLER || samp_rows != nullptr)
      return (int)cudaErrorInvalidValue;
    FrameArgs fa;
    fa.L = L, fa.H = H, fa.NQ = NQ, fa.NKV = NKV, fa.I = I, fa.V = V, fa.NCB = NCB, fa.TH = TH;
    fa.w_bf16 = w_bf16, fa.head_bf16 = head_bf16, fa.dyn = dyn;
    fa.cut = cut;
    fa.eps = eps, fa.scale = scale;
    fa.x0 = (const bf16*)x0;
    fa.stack = stack;
    fa.iln = (const float*)iln, fa.pln = (const float*)pln, fa.qn = (const float*)qn;
    fa.kn = (const float*)kn, fa.fnorm = (const float*)fnorm;
    fa.lm_w = lm_w, fa.lm_s = lm_s;
    fa.emb = (const bf16*)emb, fa.proj_w = (const bf16*)proj_w, fa.proj_b = (const bf16*)proj_b;
    fa.cos_tab = (const bf16*)cos_tab, fa.sin_tab = (const bf16*)sin_tab;
    fa.k_cache = (bf16*)k_cache, fa.v_cache = (bf16*)v_cache;
    const int max_o = max(max((NQ + 2 * NKV) * D, 2 * I), max(H, V));
    fa.part[0] = (float*)ws;
    fa.part[1] = (float*)ws + (size_t)PF_MAX_SPLIT * max_o;
    fa.xnext = (bf16*)xbuf, fa.esum = (float*)esum, fa.codes = (int*)codes_out;
    fa.logits = (float*)logits_out, fa.force = (const int*)force_codes;
    SampleArgs& sa = fa.sa;
    sa = SampleArgs{};
    sa.rep = 1.0f;
    sa.greedy = greedy;
    sa.inv_t = inv_t;
    sa.top_k = top_k;
    sa.top_p_thr = top_p_thr;
    sa.ref_exact = ref_exact;
    sa.eos_id = -1;
    sa.seed0 = seed0;
    sa.seed1 = seed1;
    sa.code_stride = NCB;
    sa.logits_stride = V;
    sa.force_stride = NCB;
    sa.H = TH;
    sa.x_next = (bf16*)xbuf;
    sa.esum = (float*)esum;
    sa.cp_head = 1;
    fa.bar = (unsigned*)ctl;
    void* err_dev = nullptr;
    const cudaError_t e = cudaHostGetDevicePointer(&err_dev, err_host, 0);
    if (e != cudaSuccess) return (int)e;
    fa.err_host = (int*)err_dev;
    fa.budget_ns = (unsigned long long)budget_ns;
    return cp_frame_launch(fa, blocks, st);
  }
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
      const int s = gemv(proj, xin, B, (float*)ws, TH, H, nullptr, st);
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
      const int err = layer_step<true, false>(
          w, next_norm, B, H, NQ, NKV, I, eps, scale, cosr, sinr, 0, cache, p, nullptr, h, xnb,
          (bf16*)attn, (bf16*)gated, (float*)ws, ax, st);
      if (err) return err;
    }
    if (p == 0) continue;  // position 0 only fills the cache
    const int j = p - 1;  // head / embedding table of this position
    Mat head = mat(head_bf16 != 0);
    add_seg(head, lm_w, lm_s, j, H, V);
    const int s = gemv(head, xnb, B, (float*)ws, H, V, head_ax, st);
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
    a.rows = (const float*)samp_rows;
    launch_sampler((const float*)ws, s, head, V, a, B, st);
    QT_CHECK_LAUNCH();
  }
  return 0;
}

// The batched GEMV of a K1 or K2 call alone (B >= 2), for tests and
// timing: the first pass of y[B, O] = x[B, I] @ W into part [splits][B][O]
// (f32 sums; with ``dyn``, x quantized per row from ``amax`` [B] and int32
// sums), W int8 or (``w_bf16``) bf16 [I, O], on the tensor cores (``tc``,
// the form K1 and K2 run) or the CUDA cores (the form they ran before), both
// at the tensor-core split (``qt_cp_gemv_splits``), so their partials
// compare split by split.
extern "C" int qt_cp_gemv_splits(int B, int I, int O) {
  int rows;
  return batched_splits(B, I, O, rows);
}

// The rows of each split (the last may be shorter) of that split
extern "C" int qt_cp_gemv_rows(int B, int I, int O) {
  int rows;
  batched_splits(B, I, O, rows);
  return rows;
}

extern "C" int qt_cp_gemv(int tc, int w_bf16, int dyn, int B, int I, int O, const void* w,
                          const void* x, const void* amax, void* part, void* stream) {
  if (B < 2 || B > MAX_BATCH || I % 16 != 0 || O % 16 != 0 || (dyn && (w_bf16 || !amax)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Mat m = mat(w_bf16 != 0);
  add_seg(m, w, nullptr, 0, I, O);
  int rows;
  const dim3 grid = batched_grid(B, O, batched_splits(B, I, O, rows));
  const bf16* xb = (const bf16*)x;
  const float* ax = (const float*)amax;
#define QT_GEMV(kernel, ...)                                            \
  do {                                                                  \
    static std::atomic<size_t> allowed_[QT_MAX_DEVICES];                \
    big_smem(kernel, allowed_);                                         \
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
