// T1: batched GQA scores . values in four forms, for Hopper (sm_90a).
//
// Replaces tools/exp_attn_forms.py::run_form (kernel ``make_kernel``
// :42-83, pallas_call at :87). The function, for n loop iterations i:
//   q_i = bf16(q + bf16(f32(i) * 1e-6))              (stops hoisting)
//   s_i = q_i . K  over D, f32 sums                  [Bt, M, W]
//   out[1, D] += sum over (b, m) of bf16(s_i) . V    f32
// with q [Bt, M, D], V [Bt, W, D] and K either natural [Bt, W, D] (forms a
// and c2) or pre-transposed [Bt, D, W] (forms b and c); D = 128. At the
// script's shapes every form reads the same 16.8 MB of K and V and differs
// only in M, the rows each product feeds the matrix unit: 2 (a: B*NKV
// batches of G rows), 16 (b: one sequence's NQ heads against its NKV*BT
// keys) or 128 (c, c2: 8 sequences' heads against their 8*NKV*BT keys, the
// cross-sequence products included).
//
// Bound on the H100: operations, 4 * Bt * M * W * D per iteration on the
// bf16 tensor cores (989 TFLOP/s dense: a 0.034 us, b 0.271, c and c2
// 2.171), over the 5.0 us of reading K and V once a call. Every iteration
// computes both products on the tensor cores; nothing is reused across
// iterations. W is cut into 128-key chunks, one CTA per (batch, chunk): a
// CTA reads its K and V chunk once and keeps it on the SM for all n
// iterations, as the TPU kept its operands in VMEM. Two paths, by M:
//
// M <= 16 (forms a, b): mma.sync m16n8k16 with the keys in the operand's 16
// rows and the q rows in its 8 columns ("swap AB"): S^T [16 keys x 8 q] =
// K . q_i^T, then O^T [16 d x 8 q] += V^T . bf16(S^T). So form a pads its 2
// rows to 8, not 16, and form b fills two 8-column tiles. A warp takes 16
// keys and one tile of 8 q rows (8 or 16 warps a CTA); its K and V^T
// fragments (the A operands, 64 registers) are the same in every iteration
// and stay in registers for the whole loop, read once from device memory;
// q's B fragments too. q_i is one packed bf16 fma a register, the score
// accumulator turns into the second product's B operand by movmatrix (a
// transpose of each 8x8 half), and two iterations run interleaved so that
// each warp has two independent chains of 8 score mmas in flight. The loop
// touches no shared memory. mma.sync, not wgmma: wgmma reads B from shared
// memory only, so swapped operands write q_i and the scores to shared memory
// every iteration, each behind a proxy fence and a barrier; such a wgmma
// form (64 keys a warpgroup) read 0.64-0.67 / 0.71-0.73 us an iteration at
// a / b against this form's 0.294 / 0.554-0.562 in one call on an H100
// (PERF.md). What bounds a and b is mma.sync's rate: b's 65,536 m16n8k16
// an iteration run at 0.48 of the dense bf16 peak, where c's wgmma reach
// 0.84-0.89 of it.
//
// M > 16 (forms c, c2): wgmma m64n128k16, two consumer warpgroups of 64 q
// rows each (FlashAttention-3's shape for one iteration); rows at or past M
// are zero (q 0 and no shift), so 17-64 rows leave the second warpgroup's
// products zero. K and V are
// copied once into shared memory in the 128-byte swizzle the descriptors
// name (plain 16-byte stores: the copy is not on the loop's path). S = q_i .
// K^T takes q_i from registers (q kept in registers, q_i built by packed
// fmas; no iteration writes shared memory) and K as B: natural K is the
// K-major B, pre-transposed K the MN-major B (the descriptor's transpose
// bit), one kernel for both forms. bf16(S) becomes the register A operand of
// O += P . V, V the MN-major B. O stays in registers across all iterations.
// A warpgroup's score group waits on its previous value product, so the two
// warpgroups' products interleave on the SM's tensor cores. Two warpgroups
// hold ~230 registers a thread: one CTA an SM; at c and c2 the 256 CTAs run
// as a wave of 132 and one of 124.
//
// At the end each CTA sums its rows and warps in a fixed order into its
// partial [128], and a second kernel adds the partials in CTA order: the
// result does not depend on scheduling (no float atomics), and two calls on
// the same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "device_state.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using qt::add_bf16x2;
using qt::mma_bf16;
using qt::movmatrix_trans;
using qt::pack_bf16;

constexpr int AF_D = 128;                         // head size
constexpr int AF_CHUNK = 128;                     // keys per CTA
constexpr int AF_MAX_M = 128;                     // q rows per batch
constexpr int AF_TILE = AF_CHUNK * AF_D * 2;      // bytes of one K or V chunk in shared memory

// bf16x2(ci, ci) of iteration i, ci = bf16(f32(i) * 1e-6).
__device__ __forceinline__ uint32_t shift2(int i) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn((float)i * 1e-6f));
  return h | (h << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Two bf16 values, p[0] in the low half and p[stride] in the high half.
__device__ __forceinline__ uint32_t ld_pair(const bf16* p, int stride) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) | ((uint32_t)__bfloat16_as_ushort(p[stride]) << 16);
}

// Sum ``lo`` / ``hi`` over the 4 lanes of a fragment row (c = lane % 4).
__device__ __forceinline__ void sum_quad(float& lo, float& hi) {
  lo += __shfl_xor_sync(0xffffffffu, lo, 1);
  hi += __shfl_xor_sync(0xffffffffu, hi, 1);
  lo += __shfl_xor_sync(0xffffffffu, lo, 2);
  hi += __shfl_xor_sync(0xffffffffu, hi, 2);
}

// ---- M <= 16: mma.sync with the keys as rows ("swap AB") ----

// One iteration's two products for a warp's 16 keys and 8 q columns.
struct SwapOperands {
  uint32_t kf[AF_D / 16][4];  // A = K [16 keys x 16 d] of d-step s
  uint32_t vf[AF_D / 16][4];  // A = V^T [16 d x 16 keys] of d-tile t
  uint32_t qb[AF_D / 16][2];  // B = q^T [16 d x 8 q] of d-step s
};

// grid: Bt * (W / AF_CHUNK) CTAs of 8 * QT warps (QT tiles of 8 q rows);
// part [grid, AF_D] f32.
template <bool KT, int QT>
__global__ void __launch_bounds__(256 * QT, 2 / QT)
attn_form_swap(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               int M, int W, int n, float* __restrict__ part) {
  constexpr int WARPS = 8 * QT;
  __shared__ float red[WARPS][AF_D];
  const int chunks = W / AF_CHUNK;
  const int b = blockIdx.x / chunks, w0 = (blockIdx.x % chunks) * AF_CHUNK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, c = lane & 3;
  const int key0 = w0 + 16 * (warp & 7), row = 8 * (warp >> 3) + g;  // this lane's q column
  const bf16* kb = k + (size_t)b * W * AF_D;
  const bf16* vb = v + (size_t)b * W * AF_D;

  SwapOperands op;
#pragma unroll
  for (int s = 0; s < AF_D / 16; ++s) {
    const int d0 = 16 * s + 2 * c;
    if (KT) {  // K^T [D, W]: (key, d) at d * W + key
      op.kf[s][0] = ld_pair(kb + (size_t)d0 * W + key0 + g, W);
      op.kf[s][1] = ld_pair(kb + (size_t)d0 * W + key0 + g + 8, W);
      op.kf[s][2] = ld_pair(kb + (size_t)(d0 + 8) * W + key0 + g, W);
      op.kf[s][3] = ld_pair(kb + (size_t)(d0 + 8) * W + key0 + g + 8, W);
    } else {  // K [W, D]
      op.kf[s][0] = ld32(kb + (size_t)(key0 + g) * AF_D + d0);
      op.kf[s][1] = ld32(kb + (size_t)(key0 + g + 8) * AF_D + d0);
      op.kf[s][2] = ld32(kb + (size_t)(key0 + g) * AF_D + d0 + 8);
      op.kf[s][3] = ld32(kb + (size_t)(key0 + g + 8) * AF_D + d0 + 8);
    }
    // V^T: (d, key) at key * D + d; rows d 16s+g (+8), cols keys 2c, 2c+1 (+8)
    const bf16* vp = vb + (size_t)(key0 + 2 * c) * AF_D + 16 * s + g;
    op.vf[s][0] = ld_pair(vp, AF_D);
    op.vf[s][1] = ld_pair(vp + 8, AF_D);
    op.vf[s][2] = ld_pair(vp + 8 * AF_D, AF_D);
    op.vf[s][3] = ld_pair(vp + 8 * AF_D + 8, AF_D);
  }
  const bool ok = row < M;  // padding columns stay zero: q 0 and no shift
  const bf16* qr = q + ((size_t)b * M + (ok ? row : 0)) * AF_D + 2 * c;
#pragma unroll
  for (int s = 0; s < AF_D / 16; ++s) {
    op.qb[s][0] = ok ? ld32(qr + 16 * s) : 0u;
    op.qb[s][1] = ok ? ld32(qr + 16 * s + 8) : 0u;
  }

  float o[AF_D / 16][4];  // O^T of d-tile t: (d 16t+g, 16t+g+8) x (q 2c, 2c+1), mma's C layout
#pragma unroll
  for (int t = 0; t < AF_D / 16; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;

  int i = 0;
  for (; i + 2 <= n; i += 2) {
    const uint32_t ca = ok ? shift2(i) : 0u, cb = ok ? shift2(i + 1) : 0u;
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < AF_D / 16; ++s) {
      mma_bf16(sa, op.kf[s], add_bf16x2(op.qb[s][0], ca), add_bf16x2(op.qb[s][1], ca));
      mma_bf16(sb, op.kf[s], add_bf16x2(op.qb[s][0], cb), add_bf16x2(op.qb[s][1], cb));
    }
    // S^T's halves (keys g / g+8 x q 2c, 2c+1) transposed: B's (keys 2c,
    // 2c+1 (+8) x q g)
    const uint32_t pa0 = movmatrix_trans(pack_bf16(sa[0], sa[1]));
    const uint32_t pa1 = movmatrix_trans(pack_bf16(sa[2], sa[3]));
    const uint32_t pb0 = movmatrix_trans(pack_bf16(sb[0], sb[1]));
    const uint32_t pb1 = movmatrix_trans(pack_bf16(sb[2], sb[3]));
#pragma unroll
    for (int t = 0; t < AF_D / 16; ++t) {
      mma_bf16(o[t], op.vf[t], pa0, pa1);
      mma_bf16(o[t], op.vf[t], pb0, pb1);
    }
  }
  if (i < n) {  // an odd n's last iteration
    const uint32_t ca = ok ? shift2(i) : 0u;
    float sa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < AF_D / 16; ++s)
      mma_bf16(sa, op.kf[s], add_bf16x2(op.qb[s][0], ca), add_bf16x2(op.qb[s][1], ca));
    const uint32_t pa0 = movmatrix_trans(pack_bf16(sa[0], sa[1]));
    const uint32_t pa1 = movmatrix_trans(pack_bf16(sa[2], sa[3]));
#pragma unroll
    for (int t = 0; t < AF_D / 16; ++t) mma_bf16(o[t], op.vf[t], pa0, pa1);
  }

  // columns (q rows) of each d row, then the warps in order
#pragma unroll
  for (int t = 0; t < AF_D / 16; ++t) {
    float lo = o[t][0] + o[t][1], hi = o[t][2] + o[t][3];
    sum_quad(lo, hi);
    if (c == 0) {
      red[warp][16 * t + g] = lo;
      red[warp][16 * t + g + 8] = hi;
    }
  }
  __syncthreads();
  if (tid < AF_D) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w][tid];
    part[(size_t)blockIdx.x * AF_D + tid] = sum;
  }
}

// ---- M > 16: wgmma, 64 q rows a warpgroup ----

// Copy a [128 x 128] bf16 matrix (row r at src + r * ld) into the swizzled
// layout of wgmma.cuh.
__device__ __forceinline__ void copy_sw128(uint8_t* dst, const bf16* src, int ld, int tid,
                                           int nthreads) {
  for (int e = tid; e < 128 * 16; e += nthreads) {
    const int r = e >> 4, p = e & 15;
    const uint4 val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * ld + p * 8));
    *reinterpret_cast<uint4*>(dst + qt::sw128_offset(r, p, 128)) = val;
  }
}

constexpr int AF_WG_THREADS = 256;  // two warpgroups of 64 q rows
constexpr size_t AF_WG_SMEM =
    qt::SW128_ATOM + 2 * (size_t)AF_TILE + (size_t)(AF_WG_THREADS / 32) * AF_D * sizeof(float);

// grid: Bt * (W / AF_CHUNK) CTAs of two warpgroups; dynamic shared memory
// AF_WG_SMEM; part [grid, AF_D] f32.
template <bool KT>
__global__ void __launch_bounds__(AF_WG_THREADS, 1)
attn_form_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int M, int W, int n, float* __restrict__ part) {
  extern __shared__ uint8_t af_raw[];
  constexpr uintptr_t ALIGN = qt::SW128_ATOM;
  uint8_t* sm = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(af_raw) + ALIGN - 1) &
                                           ~(ALIGN - 1));
  uint8_t* Ks = sm;            // natural: [key][d] K-major; KT: [d][key] MN-major
  uint8_t* Vs = sm + AF_TILE;  // [key][d], MN-major
  float* red = reinterpret_cast<float*>(sm + 2 * AF_TILE);  // [8 warps][AF_D]
  const int chunks = W / AF_CHUNK;
  const int b = blockIdx.x / chunks, w0 = (blockIdx.x % chunks) * AF_CHUNK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, c = lane & 3;

  const bf16* kb = k + (size_t)b * W * AF_D;
  const bf16* vb = v + (size_t)b * W * AF_D;
  if (KT)
    copy_sw128(Ks, kb + w0, W, tid, AF_WG_THREADS);
  else
    copy_sw128(Ks, kb + (size_t)w0 * AF_D, AF_D, tid, AF_WG_THREADS);
  copy_sw128(Vs, vb + (size_t)w0 * AF_D, AF_D, tid, AF_WG_THREADS);

  // q's A fragments: rows 16 warp + g (+8) of the CTA's 128 rows
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const bool ok0 = r0 < M, ok1 = r1 < M;  // padding rows stay zero: q 0 and no shift
  const bf16* q0 = q + ((size_t)b * M + (ok0 ? r0 : 0)) * AF_D + 2 * c;
  const bf16* q1 = q + ((size_t)b * M + (ok1 ? r1 : 0)) * AF_D + 2 * c;
  uint32_t qr[AF_D / 16][4];
#pragma unroll
  for (int s = 0; s < AF_D / 16; ++s) {
    qr[s][0] = ok0 ? ld32(q0 + 16 * s) : 0u;
    qr[s][1] = ok1 ? ld32(q1 + 16 * s) : 0u;
    qr[s][2] = ok0 ? ld32(q0 + 16 * s + 8) : 0u;
    qr[s][3] = ok1 ? ld32(q1 + 16 * s + 8) : 0u;
  }
  qt::fence_proxy_async_smem();
  __syncthreads();

  const uint32_t ks = qt::smem_addr(Ks), vs = qt::smem_addr(Vs);
  float S[64], O[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) S[j] = O[j] = 0.f;

  for (int i = 0; i < n; ++i) {
    const uint32_t ci = shift2(i), c0 = ok0 ? ci : 0u, c1 = ok1 ? ci : 0u;
    uint32_t qa[AF_D / 16][4];
#pragma unroll
    for (int s = 0; s < AF_D / 16; ++s) {
      qa[s][0] = add_bf16x2(qr[s][0], c0);
      qa[s][1] = add_bf16x2(qr[s][1], c1);
      qa[s][2] = add_bf16x2(qr[s][2], c0);
      qa[s][3] = add_bf16x2(qr[s][3], c1);
    }
    qt::wgmma_fence();
#pragma unroll
    for (int s = 0; s < AF_D / 16; ++s) {
      if (KT)  // MN-major K^T: 16 d rows of 128-byte key rows, 2048 bytes a step
        qt::wgmma_m64n128k16_rs<1>(S, qa[s], qt::sw128_desc(ks + 2048 * s, AF_TILE / 2, 1024),
                                   s > 0);
      else  // K-major K: 32 bytes a step within a 64-column half
        qt::wgmma_m64n128k16_rs<0>(
            S, qa[s], qt::sw128_desc(ks + (s >> 2) * (AF_TILE / 2) + 32 * (s & 3), 16, 1024),
            s > 0);
    }
    qt::wgmma_commit();
    qt::wgmma_wait<0>();  // this score group and the previous value group
    qt::fence_operand(S);
    uint32_t pa[AF_CHUNK / 16][4];
#pragma unroll
    for (int s = 0; s < AF_CHUNK / 16; ++s) {
      pa[s][0] = pack_bf16(S[8 * s], S[8 * s + 1]);
      pa[s][1] = pack_bf16(S[8 * s + 2], S[8 * s + 3]);
      pa[s][2] = pack_bf16(S[8 * s + 4], S[8 * s + 5]);
      pa[s][3] = pack_bf16(S[8 * s + 6], S[8 * s + 7]);
    }
    qt::wgmma_fence();
#pragma unroll
    for (int s = 0; s < AF_CHUNK / 16; ++s)  // MN-major V: 16 key rows, 2048 bytes a step
      qt::wgmma_m64n128k16_rs<1>(O, pa[s], qt::sw128_desc(vs + 2048 * s, AF_TILE / 2, 1024), 1);
    qt::wgmma_commit();
  }
  qt::wgmma_wait<0>();
  qt::fence_operand(O);

  // rows g and g + 8, then the 8 lanes of one column pair, then the warps
#pragma unroll
  for (int j = 0; j < AF_D / 8; ++j) {
    float a0 = O[4 * j] + O[4 * j + 2], a1 = O[4 * j + 1] + O[4 * j + 3];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    }
    if (g == 0) {
      red[warp * AF_D + 8 * j + 2 * c] = a0;
      red[warp * AF_D + 8 * j + 2 * c + 1] = a1;
    }
  }
  __syncthreads();
  if (tid < AF_D) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < AF_WG_THREADS / 32; ++w) sum += red[w * AF_D + tid];
    part[(size_t)blockIdx.x * AF_D + tid] = sum;
  }
}

// out[d] = sum over the CTAs, in order, of part[cta, d].
__global__ void attn_form_sum(const float* __restrict__ part, int ctas, float* __restrict__ out) {
  const int d = threadIdx.x;
  float sum = 0.f;
  for (int b = 0; b < ctas; ++b) sum += part[(size_t)b * AF_D + d];
  out[d] = sum;
}

template <bool KT>
cudaError_t launch_wgmma(int ctas, int M, int W, int n, const bf16* q, const bf16* k,
                         const bf16* v, float* part, cudaStream_t st) {
  static std::atomic<size_t> allowed[qt::QT_MAX_DEVICES];
  auto* kern = attn_form_wgmma<KT>;
  const cudaError_t e = qt::allow_smem(kern, AF_WG_SMEM, allowed);
  if (e != cudaSuccess) return e;
  kern<<<ctas, AF_WG_THREADS, AF_WG_SMEM, st>>>(q, k, v, M, W, n, part);
  return cudaGetLastError();
}

template <bool KT>
int launch(int Bt, int M, int W, int n, const void* qp, const void* kp, const void* vp,
           void* partp, void* out, cudaStream_t st) {
  const bf16 *q = (const bf16*)qp, *k = (const bf16*)kp, *v = (const bf16*)vp;
  float* part = (float*)partp;
  const int ctas = Bt * (W / AF_CHUNK);
  cudaError_t e;
  if (M <= 8) {
    attn_form_swap<KT, 1><<<ctas, 256, 0, st>>>(q, k, v, M, W, n, part);
    e = cudaGetLastError();
  } else if (M <= 16) {
    attn_form_swap<KT, 2><<<ctas, 512, 0, st>>>(q, k, v, M, W, n, part);
    e = cudaGetLastError();
  } else {
    e = launch_wgmma<KT>(ctas, M, W, n, q, k, v, part, st);
  }
  if (e != cudaSuccess) return (int)e;
  attn_form_sum<<<1, AF_D, 0, st>>>(part, ctas, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// out [AF_D] f32 = the T1 function of q [Bt, M, 128], k ([Bt, W, 128], or
// [Bt, 128, W] if k_transposed), v [Bt, W, 128], all bf16 and 16-byte
// aligned, over n iterations; part is scratch of Bt * W / 128 x 128 f32.
// Needs 1 <= M <= 128, W a positive multiple of 128, n >= 0.
extern "C" int qt_attn_form(int k_transposed, int Bt, int M, int W, int n, const void* q,
                            const void* k, const void* v, void* part, void* out, void* stream) {
  if (Bt < 1 || M < 1 || M > AF_MAX_M || W < AF_CHUNK || W % AF_CHUNK || n < 0 || !q || !k ||
      !v || !part || !out || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15 ||
      (long long)Bt * (W / AF_CHUNK) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return k_transposed ? launch<true>(Bt, M, W, n, q, k, v, part, out, st)
                      : launch<false>(Bt, M, W, n, q, k, v, part, out, st);
}
