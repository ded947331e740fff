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
// 2.171), over the 5.0 us of reading K and V once a call. Design: W is cut
// into 128-key chunks, one CTA per (batch, chunk), 256 CTAs at every form;
// a CTA copies its K and V chunk (64 KB) and its batch's q rows into shared
// memory once and keeps them there for all n iterations, as the TPU kept
// its operands in VMEM (two CTAs fit an SM). Eight warps split the work:
// warp w takes 16 q rows (M is padded to 16, 32, 64 or 128 rows of zeros)
// and an equal share of the chunk's keys. Per iteration a warp builds q_i's
// A fragments in registers, forms 16 keys of scores at a time with
// mma.sync m16n8k16 (the natural K through ldmatrix, the transposed K
// through ldmatrix.trans: on this card the natural layout is the direct
// column operand of Q.K^T, the reverse of the TPU's case), rounds them to
// bf16 as the next product's A fragment, and accumulates s . V (V through
// ldmatrix.trans) into 16 rows x 128 f32 that stay in registers across all
// iterations. At the end the rows and warps are summed in a fixed order
// into the CTA's partial [128], and a second kernel adds the partials in
// CTA order, so the result does not depend on scheduling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using qt::ldsm_x4;
using qt::ldsm_x4_trans;
using qt::mma_bf16;
using qt::pack_bf16;

constexpr int AF_D = 128;                      // head size
constexpr int AF_CHUNK = 128;                  // keys per CTA
constexpr int AF_THREADS = 256;                // 8 warps
constexpr int AF_WARPS = AF_THREADS / 32;
constexpr int AF_LD = AF_D + 8;                // smem row stride (bf16): ldmatrix without conflicts
constexpr int AF_MAX_M = AF_WARPS * 16;        // 128 q rows per CTA

// Two q values (a 32-bit word of shared memory) plus ci, rounded to bf16.
__device__ __forceinline__ uint32_t q_plus(const bf16* p, float ci, bool row_ok) {
  if (!row_ok) return 0u;  // padding rows stay zero
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return pack_bf16(__uint_as_float(w << 16) + ci, __uint_as_float(w & 0xffff0000u) + ci);
}

// grid: Bt * (W / AF_CHUNK) CTAs; part [grid, AF_D] f32.
template <bool KT>
__global__ void __launch_bounds__(AF_THREADS, 2)
attn_form_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, int M, int Mp, int W, int n,
                 float* __restrict__ part) {
  extern __shared__ uint4 af_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(af_smem);  // natural [key][d]; KT [d][key]
  bf16* Vs = Ks + AF_CHUNK * AF_LD;             // [key][d]
  bf16* Qs = Vs + AF_CHUNK * AF_LD;             // [Mp][d], rows >= M zero
  float* red = reinterpret_cast<float*>(Qs + Mp * AF_LD);  // [AF_WARPS][AF_D]
  const int chunks = W / AF_CHUNK;
  const int b = blockIdx.x / chunks, w0 = (blockIdx.x % chunks) * AF_CHUNK;
  const int tid = threadIdx.x;

  const bf16* kb = k + (size_t)b * W * AF_D;
  const bf16* vb = v + (size_t)b * W * AF_D;
  const bf16* qb = q + (size_t)b * M * AF_D;
  constexpr int V8 = AF_D / 8;  // 16-byte pieces of a row
  for (int e = tid; e < AF_CHUNK * V8; e += AF_THREADS) {
    const int r = e / V8, c8 = (e % V8) * 8;
    const bf16* ks = KT ? kb + (size_t)r * W + w0 + c8 : kb + (size_t)(w0 + r) * AF_D + c8;
    *reinterpret_cast<uint4*>(Ks + r * AF_LD + c8) = __ldg(reinterpret_cast<const uint4*>(ks));
    *reinterpret_cast<uint4*>(Vs + r * AF_LD + c8) =
        __ldg(reinterpret_cast<const uint4*>(vb + (size_t)(w0 + r) * AF_D + c8));
  }
  for (int e = tid; e < Mp * V8; e += AF_THREADS) {
    const int r = e / V8, c8 = (e % V8) * 8;
    *reinterpret_cast<uint4*>(Qs + r * AF_LD + c8) =
        r < M ? __ldg(reinterpret_cast<const uint4*>(qb + (size_t)r * AF_D + c8))
              : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, c = lane & 3;
  const int R = Mp / 16, WP = AF_WARPS / R;  // row groups; warps sharing one
  const int rg = warp / WP, ncol = AF_CHUNK / WP, col0 = (warp % WP) * ncol;
  const int row = rg * 16 + g;
  const bool ok0 = row < M, ok8 = row + 8 < M;
  const bf16* q0 = Qs + row * AF_LD + 2 * c;
  // ldmatrix row addresses: lane l points at row l % 8 of matrix l / 8
  const int mr = lane & 7, mi = lane >> 3;

  float o[AF_D / 8][4];
#pragma unroll
  for (int j = 0; j < AF_D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    const float ci = __bfloat162float(__float2bfloat16_rn((float)i * 1e-6f));
    uint32_t qa[AF_D / 16][4];
#pragma unroll
    for (int kk = 0; kk < AF_D / 16; ++kk) {
      qa[kk][0] = q_plus(q0 + 16 * kk, ci, ok0);
      qa[kk][1] = q_plus(q0 + 8 * AF_LD + 16 * kk, ci, ok8);
      qa[kk][2] = q_plus(q0 + 16 * kk + 8, ci, ok0);
      qa[kk][3] = q_plus(q0 + 8 * AF_LD + 16 * kk + 8, ci, ok8);
    }
    for (int wb = col0; wb < col0 + ncol; wb += 16) {  // 16 keys at a time
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < AF_D / 16; ++kk) {
        uint32_t bk[4];  // [0], [1]: keys wb..wb+7; [2], [3]: keys wb+8..wb+15
        if (KT)
          ldsm_x4_trans(bk, Ks + (16 * kk + (mi & 1) * 8 + mr) * AF_LD + wb + (mi >> 1) * 8);
        else
          ldsm_x4(bk, Ks + (wb + (mi >> 1) * 8 + mr) * AF_LD + 16 * kk + (mi & 1) * 8);
        mma_bf16(s[0], qa[kk], bk[0], bk[1]);
        mma_bf16(s[1], qa[kk], bk[2], bk[3]);
      }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dt = 0; dt < AF_D / 16; ++dt) {
        uint32_t bv[4];  // [0], [1]: d 16dt..+7; [2], [3]: d 16dt+8..+15
        ldsm_x4_trans(bv, Vs + (wb + (mi & 1) * 8 + mr) * AF_LD + 16 * dt + (mi >> 1) * 8);
        mma_bf16(o[2 * dt], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dt + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // rows g and g + 8, then the 8 lanes of one column pair, then the warps
#pragma unroll
  for (int j = 0; j < AF_D / 8; ++j) {
    float a0 = o[j][0] + o[j][2], a1 = o[j][1] + o[j][3];
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
    for (int w = 0; w < AF_WARPS; ++w) sum += red[w * AF_D + tid];
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
int launch(int Bt, int M, int W, int n, const void* q, const void* k, const void* v, void* part,
           void* out, cudaStream_t st) {
  const int Mp = M <= 16 ? 16 : M <= 32 ? 32 : M <= 64 ? 64 : 128;
  const size_t smem = (size_t)(2 * AF_CHUNK + Mp) * AF_LD * sizeof(bf16) +
                      (size_t)AF_WARPS * AF_D * sizeof(float);
  auto* kern = attn_form_kernel<KT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ctas = Bt * (W / AF_CHUNK);
  kern<<<ctas, AF_THREADS, smem, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, M, Mp, W,
                                       n, (float*)part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_form_sum<<<1, AF_D, 0, st>>>((const float*)part, ctas, (float*)out);
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
      !v || !part || !out || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return k_transposed ? launch<true>(Bt, M, W, n, q, k, v, part, out, st)
                      : launch<false>(Bt, M, W, n, q, k, v, part, out, st);
}
