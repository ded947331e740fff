// K3: single-token GQA attention (B=1) over the valid prefix [0, pos] of
// one layer's bf16 KV cache, for Hopper (sm_90a).
//
// Replaces qwen3tts_tpu/ops/attention.py::decode_attention_inner (body
// _decode_attn_kernel), which streamed [Hkv, 512, D] stripes of all heads
// through VMEM in one sequential grid program with an online softmax.
//
// Bound on the H100: the k/v bytes of the valid prefix, 4 KB per cached row
// at 8 kv heads x 128 x bf16 x (k + v): 16 MB per layer at pos 4000, a
// 4.9 us floor at 3.35 TB/s. The arithmetic (~33 MFLOP there) is far below
// the card's ridge, so the kernel is a byte mover: what it must do is keep
// enough bytes in flight. One block per kv head would fill 8 of 132 SMs, so
// the prefix is split across blocks (flash-decoding): block (c, h) takes the
// rows [c * DA_CHUNK, min((c + 1) * DA_CHUNK, pos + 1)) of kv head h for the
// G query heads of that kv head. A chunk of one kv head is one contiguous run
// of n x 256 bytes in each of k and v, so the block issues the whole chunk
// at once as 16-byte ``cp.async`` copies straight into shared memory (k as
// one group, v as a second): a chunk's k and v bytes are all in flight
// together, and the scores start when k has landed. A 128-row chunk is 68 KB
// of dynamic shared memory (rows padded to 272 bytes), 3 blocks to an SM, so
// up to 49 chunks a kv head (392 blocks at 8 kv heads: pos 6271) run in one
// wave with every byte of the prefix requested at the start; pos 4000 is 32
// chunks, 256 blocks. Every block's bytes land at about the same time, near
// the end of the transfer, so the arithmetic after it is on the critical
// path: the scores run on the tensor cores (mma.sync m16n8k16, the k rows
// as A, q as B with the G query heads as columns: f32 sums of exact bf16
// products, times the scale), the softmax runs in all 8 warps on the score
// fragments (a warp's max and sum over its 16 rows, then the chunk's),
// probabilities stay f32 and the PV sums run on the CUDA cores, reading v
// 16 bytes a lane (a thread owns 8 dims of every 16th row; read as bf16
// elements, v went through 2-byte loads on conflicting banks and the PV
// loop ran ~5x its instruction count, so it is read in words).
//
// One launch per call: a block writes its chunk's per-query-head f32 max m,
// sum l of exp(s - m) and unnormalised acc = sum_t exp(s_t - m) v_t to the
// caller's scratch, then takes a ticket from its kv head's counter (an
// acquire-release ``atom`` after the block's barrier); the block that draws the last
// ticket merges that head's chunks, out = bf16(sum_c e^(m_c - M) acc_c /
// sum_c e^(m_c - M) l_c), rounded once, and sets the counter back to 0 for
// the next call; it copies the chunks' sums into its shared memory in one
// go (a batch of up to 65 chunks at G = 2) rather than one L2 round trip a
// chunk, and takes each chunk's weight once per head. The counters ([NKV] int32) belong to the caller, are zeroed
// once and are reused: calls that share them must be ordered (one stream).
// A single-chunk call (pos < DA_CHUNK) writes its output directly. Rows past
// pos are never read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "device_state.cuh"
#include "mma.cuh"
#include "reduce.cuh"

namespace {

using qt::ldsm_x4;
using qt::mma_bf16;
using qt::warp_max;
using qt::warp_sum;

typedef __nv_bfloat16 bf16;

constexpr int DA_THREADS = 256;  // 8 warps
constexpr int DA_CHUNK = 128;    // cache rows per block
constexpr int DA_D = 128;        // head_dim
constexpr int DA_RS = DA_D + 8;  // row stride in shared memory (272 bytes: ldmatrix rows on distinct banks)
constexpr int DA_ROW_CHUNKS = DA_D * 2 / 16;              // 16-byte pieces of a row
constexpr int DA_ROW_GROUPS = DA_THREADS / DA_ROW_CHUNKS;  // PV: rows summed at once
constexpr int DA_SMEM = 2 * DA_CHUNK * DA_RS * 2;         // k then v of a chunk, bf16: 68 KB
constexpr int DA_ML = 4;  // floats a (chunk, query head) keeps: m, l and 2 of padding (16 bytes)
constexpr int DA_WTS = 136;  // the merge's weights of one batch of chunks (PB x G <= 136)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
// a kv head's ticket: atomic add of 1 at gpu scope with acquire-release
// order; returns the count before it
__device__ __forceinline__ int ticket(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// 8 bf16 of 16 bytes of shared memory, widened to f32 (a bf16 is the high
// half of its f32): one 16-byte load, taken apart in registers
__device__ __forceinline__ void widen8(const bf16* p, float (&f)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// CUT (the profile of ``qt_decode_attention_cut``; 0 in the kernel K3
// launches): the block stops after its loads (CUT_LOADS), the scores
// (CUT_SCORES), the softmax (CUT_SOFTMAX), the PV sums (CUT_PV), their sum
// over the row groups (CUT_REDUCE), or its partials written out
// (CUT_PARTIALS), each once k and v have landed, before the merge.
constexpr int CUT_NONE = 0, CUT_LOADS = 1, CUT_SCORES = 2, CUT_SOFTMAX = 3, CUT_PV = 4,
              CUT_REDUCE = 5, CUT_PARTIALS = 6;

template <int G, int CUT = CUT_NONE>
__global__ void __launch_bounds__(DA_THREADS, 3)
attn_chunk(const bf16* __restrict__ q, const bf16* __restrict__ kc, const bf16* __restrict__ vc,
           int T, int pos, float scale, float* __restrict__ part_ml,
           float* __restrict__ part_acc, int* __restrict__ counters, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char da_smem[];
  bf16* ks = reinterpret_cast<bf16*>(da_smem);  // [DA_CHUNK][DA_RS]
  bf16* vs = ks + DA_CHUNK * DA_RS;             // [DA_CHUNK][DA_RS]
  float* red = reinterpret_cast<float*>(da_smem);  // PV partials [DA_ROW_GROUPS][G][D], over ks
  static_assert(DA_ROW_GROUPS * G * DA_D * 4 <= DA_CHUNK * DA_RS * 2, "PV partials fit over k");
  static_assert(G <= 8, "query heads of a kv head are the mma's 8 columns");
  static_assert(DA_THREADS / 32 * 16 == DA_CHUNK, "a warp's 16 rows of the chunk");
  __shared__ float sc[G][DA_CHUNK];  // exp(s - m) of the chunk's rows (0 past n)
  __shared__ float wstat[2][DA_THREADS / 32][G];  // each warp's max, then sum, per head
  __shared__ float ml[G][2];
  __shared__ int last;
  const int c = blockIdx.x, h = blockIdx.y, NC = gridDim.x, tid = threadIdx.x;
  const int t0 = c * DA_CHUNK;
  const int n = min(DA_CHUNK, pos + 1 - t0);
  const int lane = tid & 31, warp = tid >> 5;

  // the whole chunk in flight: k (group 0), then v (group 1), 16 bytes a
  // copy into rows DA_RS apart
  const char* kg = reinterpret_cast<const char*>(kc + ((size_t)h * T + t0) * DA_D);
  const char* vg = reinterpret_cast<const char*>(vc + ((size_t)h * T + t0) * DA_D);
  for (int i = tid; i < n * DA_ROW_CHUNKS; i += DA_THREADS)
    cp_async16(ks + (i / DA_ROW_CHUNKS) * DA_RS + (i % DA_ROW_CHUNKS) * 8, kg + (size_t)i * 16);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < n * DA_ROW_CHUNKS; i += DA_THREADS)
    cp_async16(vs + (i / DA_ROW_CHUNKS) * DA_RS + (i % DA_ROW_CHUNKS) * 8, vg + (size_t)i * 16);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // q as the mma's B operand (k = dims, column n = query head; columns
  // past G are 0): lane (n = lane / 4, c = lane % 4) holds dims 2c, 2c + 1
  // and 2c + 8, 2c + 9 of each 16-dim step
  const int qn = lane >> 2, qc = lane & 3;
  uint32_t qb[DA_D / 16][2];
#pragma unroll
  for (int kk = 0; kk < DA_D / 16; ++kk) {
    qb[kk][0] = qb[kk][1] = 0u;
    if (qn < G) {
      const bf16* qp = q + (size_t)(h * G + qn) * DA_D + kk * 16 + 2 * qc;
      qb[kk][0] = *reinterpret_cast<const uint32_t*>(qp);
      qb[kk][1] = *reinterpret_cast<const uint32_t*>(qp + 8);
    }
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this thread's k copies
  __syncthreads();                                         // everyone's
  if (CUT == CUT_LOADS) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    return;
  }
  // scores on the tensor cores: warp w takes rows 16w..16w+15 (A = k rows,
  // ldmatrix with lanes 8j..8j+7 on matrix j = (rows 0-7 | 8-15, dims
  // 0-7 | 8-15) in the A fragment's order), f32 sums of exact bf16
  // products, times the scale. acc4[0..1]: row 16w + lane / 4, heads 2c,
  // 2c + 1; acc4[2..3]: the row + 8 (rows past n: -inf)
  float acc4[4] = {0.f, 0.f, 0.f, 0.f};
  if (warp * 16 < n) {
    const bf16* ka = ks + (warp * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * DA_RS + ((lane >> 4) << 3);
#pragma unroll
    for (int kk = 0; kk < DA_D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, ka + kk * 16);
      mma_bf16(acc4, a, qb[kk][0], qb[kk][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    acc4[j] = warp * 16 + qn + (j >> 1) * 8 < n ? acc4[j] * scale : -CUDART_INF_F;
  if (CUT == CUT_SCORES) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (acc4[0] + acc4[1] + acc4[2] + acc4[3] == 1234.5f) out[0] = q[0];
    return;
  }
  // the softmax across all 8 warps, from the fragments: each warp's max
  // over its 16 rows per head (lanes of one c hold heads 2c, 2c + 1), the
  // chunk's max M from the 8 warps', then p = exp(s - M) into sc for PV and
  // each warp's sum of p
  float mx[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    mx[k] = fmaxf(acc4[k], acc4[k + 2]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], o));
  }
  if (qn == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (2 * qc + k < G) wstat[0][warp][2 * qc + k] = mx[k];
  }
  __syncthreads();
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int g = 2 * qc + k;
    if (g < G) {
      float M = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < DA_THREADS / 32; ++w) M = fmaxf(M, wstat[0][w][g]);
#pragma unroll
      for (int j = k; j < 4; j += 2) {
        const float p = expf(acc4[j] - M);  // 0 past n
        sc[g][warp * 16 + qn + (j >> 1) * 8] = p;
        ps[k] += p;
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) ps[k] += __shfl_xor_sync(0xffffffffu, ps[k], o);
  }
  if (qn == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (2 * qc + k < G) wstat[1][warp][2 * qc + k] = ps[k];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // v has landed, the weights are in sc, k is no longer read
  if (tid < G) {  // the chunk's m and l
    float M = -CUDART_INF_F, l = 0.f;
#pragma unroll
    for (int w = 0; w < DA_THREADS / 32; ++w) {
      M = fmaxf(M, wstat[0][w][tid]);
      l += wstat[1][w][tid];
    }
    ml[tid][0] = M;
    ml[tid][1] = l;
  }
  if (CUT == CUT_SOFTMAX) return;
  // PV on the CUDA cores (f32 probabilities): thread (row group rg, 16-byte
  // piece dg) sums rows rg, rg + 16, ...
  const int rg = tid / DA_ROW_CHUNKS, dg = tid % DA_ROW_CHUNKS;
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
#pragma unroll 2
  for (int r = rg; r < n; r += DA_ROW_GROUPS) {
    float vf[8];
    widen8(vs + r * DA_RS + dg * 8, vf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = sc[g][r];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
    }
  }
  if (CUT == CUT_PV) {  // keep every sum live without a global write
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) t += acc[g][i];
    if (t == 1234.5f) out[0] = q[0];
    return;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float4* dst = reinterpret_cast<float4*>(red + (rg * G + g) * DA_D + dg * 8);
    dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
  }
  __syncthreads();
  for (int i = tid; i < G * DA_D; i += DA_THREADS) {
    const int g = i / DA_D, d = i % DA_D;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < DA_ROW_GROUPS; ++k) a += red[(k * G + g) * DA_D + d];
    if (CUT == CUT_REDUCE) {
      if (a == 1234.5f) out[0] = q[0];
      continue;
    }
    if (NC == 1) {
      out[(size_t)(h * G + g) * DA_D + d] = __float2bfloat16_rn(a / ml[g][1]);
    } else {
      const size_t slot = ((size_t)h * NC + c) * G + g;
      part_acc[slot * DA_D + d] = a;
      if (d < DA_ML) part_ml[slot * DA_ML + d] = d < 2 ? ml[g][d] : 0.f;
    }
  }
  if (NC == 1 || CUT != CUT_NONE) return;

  // the last block of kv head h to finish merges its NC chunks. The ticket
  // is an acquire-release atomic taken after the block's barrier, so it
  // publishes every thread's partials (cumulativity) and, for the last
  // block, makes every other block's visible; the merge reads them from
  // the L2 (cp.async.cg), past the L1. No full fence is needed.
  __syncthreads();
  if (tid == 0) last = ticket(counters + h) == NC - 1;
  __syncthreads();
  if (!last) return;
  // batches of PB chunks: their PV sums and (m, l) copied into shared memory
  // at once (from the L2), then an online merge: the batch's max per head
  // (a warp a head), a weight e^(m_c - M) per (chunk, head), the running
  // sums rescaled and the weighted chunks added (two chains a thread)
  constexpr int PER = G * (DA_D + DA_ML);  // floats a chunk
  constexpr int PB = DA_SMEM / (PER * 4);  // chunks a batch (65 at G = 2)
  constexpr int OWN = (G * DA_D + DA_THREADS - 1) / DA_THREADS;
  static_assert(PB * G <= DA_WTS, "a batch's weights fit");
  float* accs = reinterpret_cast<float*>(da_smem);  // [PB][G][D]
  float* mls = accs + PB * G * DA_D;                // [PB][G][DA_ML]
  __shared__ float wts[DA_WTS], m_run[G], m_new[G];
  if (tid < G) m_run[tid] = -CUDART_INF_F;
  float Lo[OWN], Ao[OWN];
#pragma unroll
  for (int j = 0; j < OWN; ++j) Lo[j] = Ao[j] = 0.f;
  for (int cb = 0; cb < NC; cb += PB) {
    const int nb = min(PB, NC - cb);
    __syncthreads();  // the last batch is read
    const char* ga = reinterpret_cast<const char*>(part_acc + ((size_t)h * NC + cb) * G * DA_D);
    const char* gm = reinterpret_cast<const char*>(part_ml + ((size_t)h * NC + cb) * G * DA_ML);
    for (int i = tid; i < nb * G * DA_D / 4; i += DA_THREADS)
      cp_async16(reinterpret_cast<char*>(accs) + i * 16, ga + (size_t)i * 16);
    for (int i = tid; i < nb * G; i += DA_THREADS)
      cp_async16(reinterpret_cast<char*>(mls) + i * 16, gm + (size_t)i * 16);
    cp_async_wait_all();
    __syncthreads();
    if (warp < G) {  // warp g: the batch's max for head g
      float Mb = m_run[warp];
      for (int cc = lane; cc < nb; cc += 32) Mb = fmaxf(Mb, mls[(cc * G + warp) * DA_ML]);
      Mb = warp_max(Mb);
      if (lane == 0) m_new[warp] = Mb;
    }
    __syncthreads();
    for (int i = tid; i < nb * G; i += DA_THREADS)
      wts[i] = expf(mls[i * DA_ML] - m_new[i % G]);  // i = cc * G + g
    __syncthreads();
#pragma unroll
    for (int j = 0; j < OWN; ++j) {
      const int i = tid + j * DA_THREADS;
      if (i < G * DA_D) {
        const int g = i / DA_D, d = i % DA_D;
        const float r = expf(m_run[g] - m_new[g]);  // 0 at the first batch
        float l0 = Lo[j] * r, a0 = Ao[j] * r, l1 = 0.f, a1 = 0.f;  // two chains
        int cc = 0;
#pragma unroll 2
        for (; cc + 1 < nb; cc += 2) {
          const float w0 = wts[cc * G + g], w1 = wts[(cc + 1) * G + g];
          l0 = fmaf(mls[(cc * G + g) * DA_ML + 1], w0, l0);
          a0 = fmaf(accs[(cc * G + g) * DA_D + d], w0, a0);
          l1 = fmaf(mls[((cc + 1) * G + g) * DA_ML + 1], w1, l1);
          a1 = fmaf(accs[((cc + 1) * G + g) * DA_D + d], w1, a1);
        }
        if (cc < nb) {
          l0 = fmaf(mls[(cc * G + g) * DA_ML + 1], wts[cc * G + g], l0);
          a0 = fmaf(accs[(cc * G + g) * DA_D + d], wts[cc * G + g], a0);
        }
        Lo[j] = l0 + l1;
        Ao[j] = a0 + a1;
      }
    }
    __syncthreads();  // every thread has read m_run
    if (tid < G) m_run[tid] = m_new[tid];
  }
#pragma unroll
  for (int j = 0; j < OWN; ++j) {
    const int i = tid + j * DA_THREADS;
    if (i < G * DA_D) out[(size_t)h * G * DA_D + i] = __float2bfloat16_rn(Ao[j] / Lo[j]);
  }
  if (tid == 0) counters[h] = 0;  // ready for the next call
}

template <int G, int CUT = CUT_NONE>
int launch(const void* q, const void* k, const void* v, int NKV, int T, int pos, float scale,
           int NC, void* part_ml, void* part_acc, void* counters, void* out, cudaStream_t st) {
  static std::atomic<size_t> allowed[qt::QT_MAX_DEVICES];  // one per instance and device
  const cudaError_t e = qt::allow_smem(attn_chunk<G, CUT>, DA_SMEM, allowed, /*max_carveout=*/true);
  if (e != cudaSuccess) return (int)e;
  attn_chunk<G, CUT><<<dim3(NC, NKV), DA_THREADS, DA_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, T, pos, scale, (float*)part_ml,
      (float*)part_acc, (int*)counters, (bf16*)out);
  return (int)cudaGetLastError();
}

bool args_ok(int NQ, int NKV, int D, int T, int pos, int NC) {
  return D == DA_D && NKV > 0 && NQ % NKV == 0 && pos >= 0 && pos < T && NC == pos / DA_CHUNK + 1;
}

}  // namespace

// out [NQ, D] bf16 = softmax((q * scale) . k[0..pos]) v[0..pos] per query head,
// for q [NQ, D] and one layer's k/v [NKV, T, D] (all bf16, contiguous, 16-byte
// aligned), in one launch. NC = pos / DA_CHUNK + 1 chunks (the caller
// computes it to size the scratch): part_ml f32 [NKV, NC, G, DA_ML],
// part_acc f32 [NKV, NC, G, D] (unused when NC == 1); counters int32 [NKV],
// zero on entry and left zero.
extern "C" int qt_decode_attention(int NQ, int NKV, int D, int T, int pos, float scale, int NC,
                                   const void* q, const void* k, const void* v, void* part_ml,
                                   void* part_acc, void* counters, void* out, void* stream) {
  if (!args_ok(NQ, NKV, D, T, pos, NC)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (NQ / NKV) {
    case 1: return launch<1>(q, k, v, NKV, T, pos, scale, NC, part_ml, part_acc, counters, out, st);
    case 2: return launch<2>(q, k, v, NKV, T, pos, scale, NC, part_ml, part_acc, counters, out, st);
    case 4: return launch<4>(q, k, v, NKV, T, pos, scale, NC, part_ml, part_acc, counters, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3's time by phase (tools/exp_k3_phases.py): the kernel of
// qt_decode_attention at G = 2, cut after a phase (1 loads, 2 scores, 3
// softmax, 4 PV, 5 their sum, 6 partials; see CUT_*); nothing is merged
// and ``out`` is not written.
extern "C" int qt_decode_attention_cut(int cut, int NQ, int NKV, int D, int T, int pos,
                                       float scale, int NC, const void* q, const void* k,
                                       const void* v, void* part_ml, void* part_acc,
                                       void* counters, void* out, void* stream) {
  if (!args_ok(NQ, NKV, D, T, pos, NC) || NQ / NKV != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define QT_CUT(c) launch<2, c>(q, k, v, NKV, T, pos, scale, NC, part_ml, part_acc, counters, out, st)
  switch (cut) {
    case CUT_LOADS: return QT_CUT(CUT_LOADS);
    case CUT_SCORES: return QT_CUT(CUT_SCORES);
    case CUT_SOFTMAX: return QT_CUT(CUT_SOFTMAX);
    case CUT_PV: return QT_CUT(CUT_PV);
    case CUT_REDUCE: return QT_CUT(CUT_REDUCE);
    case CUT_PARTIALS: return QT_CUT(CUT_PARTIALS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef QT_CUT
}
