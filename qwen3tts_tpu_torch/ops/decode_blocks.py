"""The building blocks of the decode kernels, in plain PyTorch.

Each function here is the plain version of a stage that the CUDA kernels of
K1 (csrc/talker_step.cu) and K2 (csrc/cp_loop.cu) share through
csrc/common.cuh, with the same rounding points:

* ``mv``: the weight GEMV (``gemv_partial``/``gemv_batched`` + finish):
  f32 sums of exact upcasts, times the per-channel scale of an int8 weight
  (a dense bf16 weight has none), rounded to bf16 once after the sum.
  ``mv_f32`` is the same without the rounding (the codec and LM heads).
  In the ``dyn_int8`` mode an int8 weight instead meets x quantized per row
  (``quantize_rows``): the int32 sum is exact (taken in float64, |sum| <
  2^53, so the card's matmul serves too), converted to f32 once and scaled
  f32(acc) * (s * scale), or (f32(acc) * s) * scale for the code
  predictor's heads (``gemv_partial_dq``/``gemv_batched_dq``). A dense bf16
  weight stays a bf16 GEMV in that mode.
* ``rms``: RMSNorm in f32 to bf16 (``rms_copy``/``finish_residual_norm``).
* ``rope``: x*cos + rotate_half(x)*sin, each op rounded to bf16.
* ``attend``: one query row per sequence against its cache rows [0, pos]
  (``attn_step``, one block per (kv head, row) on the card), each row at its
  own ``pos``, in the talker form (q scaled first, f32 probabilities) or the
  code predictor form (scores scaled after the dot, probabilities rounded to
  bf16). It writes the new k/v row at ``pos`` first; on an int8 cache
  (``quantize_rows``) the prefix is read as int8 with the K scale folded
  into the scores and the V scale into the probabilities, while the current
  token attends with its own unquantized k/v, as the TPU kernel does. The
  kernel walks long caches in tiles with an online softmax; in f32 that
  differs from this one-pass softmax only in rounding order.
* ``split_attend``: ``attend``'s talker form as K1's persistent B = 1 step
  (csrc/talker_frame.cu) computes it: each kv head's rows [0, pos] cut into
  chunks (``chunk_plan``, the kernel's ``tf_chunks``), each chunk's running
  max, sum and unnormalised PV row in f32, merged in chunk order.
* ``layer_step``: one transformer layer for one token of each of B rows,
  on fused or unfused (q/k/v, gate/up apart) projections.
* ``sample_row``: the sampler (``sample_kernel``, one block per row; row b
  draws from stream ``stream + 16 * b``).

The plain versions of K1 and K2 (ops/talker_kernel.py, ops/cp_kernel.py) are
built from these. The sampler's semantics:

  1. additive suppress mask (-1e30 on suppressed ids)
  2. repetition penalty over ``seen``: l < 0 ? l * p : l / p. The TPU
     kernel multiplied by 1/p; the port divides by p in both the kernel and
     this plain version, as the XLA sampler does (ops/sampling.py).
  3. temperature <= 0: argmax, lowest index on ties
  4. save the EOS logit (eos_id >= 0)
  5. top-k: keep every logit >= the EXACT k-th largest (a radix select in
     the kernel, ``torch.topk`` here). The TPU kernels used a threshold
     within (max-min)*2^-24 of it; the XLA sampler's ``lax.top_k`` is exact.
  6. top-p (``top_p_filter``, 0 < top_p < 1) on z at temperature 1: the
     XLA sampler's ``apply_top_p`` (ops/sampling.py), which the TPU kernels
     did not have (the TPU sent top_p < 1 to XLA)
  7. restore the EOS logit
  8. z * (1/temperature) + Gumbel noise, argmax with the lowest index on ties.

The noise comes from a counter-based generator over (two seed words, a
stream id, the column), written once in CUDA and once here in integer torch
ops, so a kernel and its plain version draw the same noise. Noise maps to
uniforms the way the TPU kernels do: 24 bits, plus half an ulp (2^-25).
"""

from __future__ import annotations

import torch

from ._cuda import LIMITS, TALKER_FRAME_LIMITS
from .norms import rms_norm
from .quant import Int8Linear
from .rope import rotate_half

NEG_BIG = -1e30
MASK32 = 0xFFFFFFFF
STREAMS_PER_ROW = LIMITS["STREAMS_PER_ROW"]  # row b of a batched call: streams s + 16 b


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8: x [..., D] -> (int8 [..., D], f32 scale [...]).
    scale = max(amax * f32(1/127), 1e-12), then an IEEE divide;
    ``torch.round`` rounds half to even, as ``jnp.round`` and the kernels'
    ``__float2int_rn`` do. The int8 KV cache's rows and the dyn_int8
    activations both take it."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) * (1.0 / 127.0), 1e-12)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def mv_f32(x: torch.Tensor, w, mode: str = "wo_bf16", cp_head: bool = False) -> torch.Tensor:
    """x bf16 [..., K] @ w -> f32 [..., N]: int8 [K, N] times its scale
    [1, N], or a dense bf16 [K, N] weight as it is. ``mode="dyn_int8"`` with
    an int8 weight: x quantized per row, the exact int32 sum in f32, times
    s * scale (``cp_head``: times s, then the scale)."""
    if isinstance(w, Int8Linear):
        scale = w.scale.reshape(-1)
        if mode == "dyn_int8":
            xq, s = quantize_rows(x)
            acc = (xq.double() @ w.q.double()).float()
            s = s[..., None]
            return acc * s * scale if cp_head else acc * (s * scale)
        return (x.float() @ w.q.float()) * scale
    return x.float() @ w.float()


def mv(x: torch.Tensor, w, mode: str = "wo_bf16") -> torch.Tensor:
    """``mv_f32`` rounded once to bf16."""
    return mv_f32(x, w, mode).to(torch.bfloat16)


def out_dim(w) -> int:
    """Output width of an int8 or a dense [..., K, N] weight."""
    return (w.q if isinstance(w, Int8Linear) else w).shape[-1]


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, rounded to bf16."""
    return rms_norm(x.to(torch.bfloat16), w.float(), eps)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., D] bf16 with cos/sin [D] bf16: every op rounds to bf16."""
    return x * cos + rotate_half(x) * sin


def attend(
    q: torch.Tensor,  # [B, NQ, D] bf16, roped
    k_new: torch.Tensor,  # [B, NKV, D] bf16: the new rows, roped
    v_new: torch.Tensor,
    cache: tuple,  # this layer's (k, v) [B, NKV, T, D] bf16, or (k, v, ks, vs) int8 + f32 [B, NKV, T]
    pos: torch.Tensor,  # int64 [B]: each row's position
    scale: float,
    cp_form: bool,
) -> torch.Tensor:
    """GQA attention of one query row per sequence over its rows [0, pos];
    the new k/v rows are written at ``pos`` in place first (quantized on an
    int8 cache). Returns bf16 [B, NQ * D]."""
    B, nq, d = q.shape
    nkv = k_new.shape[1]
    kc, vc = cache[0], cache[1]
    rows = torch.arange(B, device=q.device)
    t = torch.arange(kc.shape[2], device=q.device)
    cur = (t[None] == pos[:, None])[:, None]  # [B, 1, T]
    valid = (t[None] <= pos[:, None])[:, None, None]  # [B, 1, 1, T]
    ks = vs = None
    if len(cache) == 4:
        (kq, ksc), (vq, vsc) = quantize_rows(k_new), quantize_rows(v_new)
        kc[rows, :, pos], vc[rows, :, pos] = kq, vq
        cache[2][rows, :, pos], cache[3][rows, :, pos] = ksc, vsc
        # the prefix as int8 with its row scales, the current token unquantized
        kf = torch.where(cur[..., None], k_new.float()[:, :, None], kc.float())
        vf = torch.where(cur[..., None], v_new.float()[:, :, None], vc.float())
        ks, vs = torch.where(cur, 1.0, cache[2]), torch.where(cur, 1.0, cache[3])
    else:
        kc[rows, :, pos], vc[rows, :, pos] = k_new, v_new
        kf, vf = kc.float(), vc.float()
    qg = q.float().reshape(B, nkv, nq // nkv, d)
    if cp_form:
        s = torch.einsum("bhgd,bhtd->bhgt", qg, kf) * scale
    else:
        s = torch.einsum("bhgd,bhtd->bhgt", qg * scale, kf)
    if ks is not None:
        s = s * ks[:, :, None]
    s = torch.where(valid, s, float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    if cp_form:
        p = (e / denom).to(torch.bfloat16).float()
        out = torch.einsum("bhgt,bhtd->bhgd", p, vf)
    else:
        if vs is not None:
            e = e * vs[:, :, None]
        out = torch.einsum("bhgt,bhtd->bhgd", e, vf) / denom
    return out.to(torch.bfloat16).reshape(B, nq * d)


def chunk_plan(n: int, blocks: int, nkv: int) -> tuple[int, int]:
    """(chunks C, rows a chunk) of a kv head's ``n`` attention rows (the
    prefix and the current token) on a grid of ``blocks``: C =
    ceil(n / TF_CHUNK), at most max(1, blocks // nkv), of n / C rows
    rounded up to 16 (csrc/talker_frame.cu ``tf_chunks``)."""
    lo = TALKER_FRAME_LIMITS["TF_CHUNK"]
    c = max(1, min(-(-n // lo), blocks // nkv))
    rows = -(-(-(-n // c)) // 16) * 16
    return -(-n // rows), rows


def split_attend(q, k_new, v_new, cache, pos, scale: float, blocks: int) -> torch.Tensor:
    """``attend`` (talker form) cut into the chunks of ``chunk_plan`` and
    merged as K1's persistent step merges them: per chunk m_c = max of its
    scores, l_c = sum exp(s - m_c) and a_c = sum exp(s - m_c) [* v scale] v
    in f32; then, chunk by chunk, M' = max(M, m_c), L = L e^(M - M') +
    l_c e^(m_c - M'), A likewise, and out = bf16(A / L). The current token
    (unquantized on an int8 cache) is the last row of the last chunk."""
    B, nq, d = q.shape
    nkv = k_new.shape[1]
    kc, vc = cache[0], cache[1]
    rows_b = torch.arange(B, device=q.device)
    quant = len(cache) == 4
    if quant:
        (kq, ksc), (vq, vsc) = quantize_rows(k_new), quantize_rows(v_new)
        kc[rows_b, :, pos], vc[rows_b, :, pos] = kq, vq
        cache[2][rows_b, :, pos], cache[3][rows_b, :, pos] = ksc, vsc
    else:
        kc[rows_b, :, pos], vc[rows_b, :, pos] = k_new, v_new
    out = []
    for b in range(B):
        p = int(pos[b])
        kf, vf = kc[b, :, : p + 1].float(), vc[b, :, : p + 1].float()  # [NKV, n, D]
        ones = torch.ones(nkv, p + 1, device=q.device)
        ks = cache[2][b, :, : p + 1].clone() if quant else ones.clone()
        vs = cache[3][b, :, : p + 1].clone() if quant else ones.clone()
        if quant:  # the current token with its own k/v
            kf[:, p], vf[:, p] = k_new[b].float(), v_new[b].float()
            ks[:, p], vs[:, p] = 1.0, 1.0
        qg = q[b].float().reshape(nkv, nq // nkv, d) * scale
        s = torch.einsum("hgd,htd->hgt", qg, kf) * ks[:, None]
        n_chunks, rows = chunk_plan(p + 1, blocks, nkv)
        M = torch.full(s.shape[:2], float("-inf"), device=q.device)
        L, A = torch.zeros_like(M), torch.zeros(*s.shape[:2], d, device=q.device)
        for c in range(n_chunks):
            sc = s[..., c * rows : (c + 1) * rows]
            m_c = sc.amax(-1)
            e = torch.exp(sc - m_c[..., None])
            l_c = e.sum(-1)
            a_c = torch.einsum("hgt,htd->hgd", e * vs[:, None, c * rows : (c + 1) * rows],
                               vf[:, c * rows : (c + 1) * rows])
            mn = torch.maximum(M, m_c)
            e0, e1 = torch.exp(M - mn), torch.exp(m_c - mn)
            L = L * e0 + l_c * e1
            A = A * e0[..., None] + a_c * e1[..., None]
            M = mn
        out.append((A / L[..., None]).to(torch.bfloat16).reshape(nq * d))
    return torch.stack(out)


def _mv_cat(x, layers, l: int, fused: str, parts: tuple, mode: str) -> torch.Tensor:
    """The fused projection ``fused`` of layer l, or its unfused ``parts``
    side by side (each column is the same function of x either way)."""
    if fused in layers:
        return mv(x, layers[fused][l], mode)
    return torch.cat([mv(x, layers[k][l], mode) for k in parts], dim=-1)


def layer_step(layers, l: int, cfg, h, cos, sin, cache, pos, cp_form: bool,
               mode: str = "wo_bf16", part: str = "full", split_blocks: int | None = None):
    """One transformer layer for one token of each row (``layer_step`` in
    common.cuh), in the matmul ``mode`` of ``mv``.

    h: bf16 [B, H] residual stream; cos/sin: bf16 [B, D] rope rows at each
    row's position; cache: this layer's cache tuple (see ``attend``), whose
    row ``pos[b]`` of sequence b is written in place; pos: int64 [B].
    ``part`` (T6's ablations, qwen3tts_tpu_torch/tools/exp_tk_b1_ablate.py;
    a bf16 cache): "noattn" writes the new k/v rows and takes q (normed,
    roped) for the attention output, "nomlp" ends after o_proj + residual.
    ``split_blocks`` (talker form): attend through ``split_attend`` with the
    chunks of a grid of that many blocks. Returns the new h."""
    NQ, NKV, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    B = h.shape[0]
    c, s = cos[:, None], sin[:, None]
    qkv = _mv_cat(rms(h, layers["input_layernorm"][l], eps), layers, l, "qkv_proj",
                  ("q_proj", "k_proj", "v_proj"), mode)
    q = rope(rms(qkv[:, : NQ * D].reshape(B, NQ, D), layers["q_norm"][l], eps), c, s)
    k = rope(rms(qkv[:, NQ * D : (NQ + NKV) * D].reshape(B, NKV, D), layers["k_norm"][l], eps), c, s)
    v = qkv[:, (NQ + NKV) * D :].reshape(B, NKV, D)
    if part == "noattn":
        rows = torch.arange(B, device=h.device)
        cache[0][rows, :, pos], cache[1][rows, :, pos] = k, v
        attn = q.reshape(B, NQ * D)
    elif split_blocks:
        attn = split_attend(q, k, v, cache, pos, D**-0.5, split_blocks)
    else:
        attn = attend(q, k, v, cache, pos, D**-0.5, cp_form)
    h = h + mv(attn, layers["o_proj"][l], mode)
    if part == "nomlp":
        return h
    gu = _mv_cat(rms(h, layers["post_attention_layernorm"][l], eps), layers, l, "gate_up_proj",
                 ("gate_proj", "up_proj"), mode)
    I = gu.shape[-1] // 2
    g, u = gu[:, :I].float(), gu[:, I:].float()
    return h + mv((g * torch.sigmoid(g) * u).to(torch.bfloat16), layers["down_proj"][l], mode)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding uint32 values, without
    int64 overflow (split ``a`` into 16-bit halves)."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit finalizer of the generator (``mix32`` in common.cuh)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix_int(x: int) -> int:
    x &= MASK32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & MASK32
    x ^= x >> 15
    x = (x * 0x846CA68B) & MASK32
    return x ^ (x >> 16)


def stream_key(seed0: int, seed1: int, stream: int) -> int:
    """Per-(seed, stream) key: mix(seed0 ^ mix(seed1 + stream * golden))."""
    return _mix_int(
        (seed0 & MASK32) ^ _mix_int((seed1 + stream * 0x9E3779B9) & MASK32)
    )


def counter_bits(seed0: int, seed1: int, stream: int, n: int, device) -> torch.Tensor:
    """uint32 noise bits (as int64) for columns 0..n-1:
    bits[c] = mix(mix(c) ^ key)."""
    key = stream_key(seed0, seed1, stream)
    c = torch.arange(n, dtype=torch.int64, device=device)
    return _mix(_mix(c) ^ key)


def gumbel_noise(seed0: int, seed1: int, stream: int, n: int, device) -> torch.Tensor:
    """-log(-log(u)) with u = (bits & 0xFFFFFF) * 2^-24 + 2^-25, float32."""
    b24 = (counter_bits(seed0, seed1, stream, n, device) & 0xFFFFFF).to(torch.float32)
    u = b24 * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    return -torch.log(-torch.log(u))


def top_k_filter(z: torch.Tensor, top_k: int) -> torch.Tensor:
    """The top-k stage of the kernels' sampler on one row z [V] f32: every
    value >= the exact k-th largest stays, the rest become NEG_BIG
    (0 < top_k < V; otherwise z as it is)."""
    if not 0 < top_k < z.shape[-1]:
        return z
    kth = torch.topk(z, top_k).values[-1]
    return torch.where(z >= kth, z, torch.full_like(z, NEG_BIG))


def top_p_threshold(top_p: float) -> float:
    """The cumulative mass a token must exceed to stay, f32(1 - top_p) as
    the XLA sampler compares it (a Python float against an f32 array), or
    0.0 where the stage is off (top_p <= 0 or >= 1): the kernels' argument."""
    if top_p <= 0.0 or top_p >= 1.0:
        return 0.0
    return torch.tensor(1.0 - top_p, dtype=torch.float32).item()


def top_p_cum(z: torch.Tensor, ref_exact: bool = False) -> torch.Tensor:
    """The cumulative mass of each id of one row z [V] f32, in id order:
    mass softmax(z) (or the unnormalized exp(z) with ``ref_exact``) summed
    over the ids in stable ascending order of z up to and including it."""
    if ref_exact:
        mass = torch.exp(z)
    else:
        e = torch.exp(z - z.amax())
        mass = e / e.sum()
    order = torch.sort(z, stable=True).indices
    cum = torch.empty_like(mass)
    cum[order] = torch.cumsum(mass[order], 0)
    return cum


def top_p_filter(z: torch.Tensor, top_p: float, ref_exact: bool = False) -> torch.Tensor:
    """The top-p stage of the kernels' sampler (``top_p_stage`` in
    common.cuh) on one row z [V] f32 after top-k: keep an id iff its
    cumulative mass (``top_p_cum``) exceeds ``top_p_threshold(top_p)``; the
    rest become NEG_BIG."""
    thr = top_p_threshold(top_p)
    if thr == 0.0:
        return z
    return torch.where(top_p_cum(z, ref_exact) > thr, z, torch.full_like(z, NEG_BIG))


def sample_row(
    logits: torch.Tensor,  # [V] float32
    *,
    temperature: float,
    top_k: int,
    top_p: float = 1.0,
    ref_exact_top_p: bool = False,
    rep_penalty: float = 1.0,
    seen: torch.Tensor | None = None,  # [V] bool
    suppress_add: torch.Tensor | None = None,  # [V] float32
    eos_id: int = -1,
    seed: tuple[int, int] = (0, 0),
    stream: int = 0,
) -> torch.Tensor:
    """The kernels' sampler for one row; returns the code as int32 [1]."""
    z = logits.float()
    if suppress_add is not None:
        z = z + suppress_add
    if seen is not None and rep_penalty != 1.0:
        # divide by a tensor: CUDA turns division by a host scalar into a
        # multiply by its reciprocal, which the kernel does not do
        pen = torch.where(z < 0, z * rep_penalty, z / torch.full_like(z, rep_penalty))
        z = torch.where(seen, pen, z)
    V = z.shape[-1]
    if temperature > 0:
        if eos_id >= 0:
            eos_logit = z[eos_id].clone()
        z = top_p_filter(top_k_filter(z, top_k), top_p, ref_exact_top_p)
        if eos_id >= 0:
            z = z.clone()
            z[eos_id] = eos_logit
        inv_t = torch.tensor(1.0 / temperature, dtype=torch.float32).item()
        z = z * inv_t + gumbel_noise(seed[0], seed[1], stream, V, z.device)
    return torch.argmax(z).to(torch.int32).reshape(1)
