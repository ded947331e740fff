"""Talker: the main autoregressive MRoPE transformer
(port of qwen3tts_tpu/models/talker.py).

Parameters are plain dicts of tensors with the layers stacked on a leading
axis; linear weights are [in, out] (y = x @ w), ``Int8Linear`` or, in the
low-memory mode, ``PackedLinear`` (MLX layout [out, in/pw]). The KV cache is a
preallocated static-shape buffer [L, B, H_kv, T_max, D], bf16 (``KVCache``)
or int8 with one f32 scale per row (``KVCacheQ``); validity is handled by
masking, never by dynamic shapes. Unlike the JAX code, which returns a new
cache from every call, the port writes new k/v rows into the cache IN PLACE
(at ``offset``, or at ``offsets[b]`` for row b of a batched step) and returns
the same cache object; K1 writes its rows in place too, so the JAX
package's ``_append_cache_rows`` has no counterpart here.

On CUDA a single-token step of fused weights (int8 or dense bf16, the two
layouts of ``talker_kernel._layout``) runs through K1
(ops/talker_kernel.py), or raises where K1 does not take it: ``forward``
and ``forward_batched_step`` in its non-sample mode, ``forward_step_sample``
and ``forward_batched_step_sample`` in its sample mode. Each K1 call takes
the matmul mode ``_kernel_mode`` selects, as the JAX package's do:
QWEN3TTS_TK_MODE=dyn_int8 opts int8 layers into per-row int8 activations.
On an int8 cache the kernel lets the current token attend with its own
unquantized k/v, while the plain path here quantizes the new row before
attending, as the JAX package's XLA path does.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch

from ..config import TalkerConfig
from ..ops.attention import MIN_CACHE, decode_attention_inner
from ..ops.decode_blocks import quantize_rows as quantize_kv_rows  # the int8 cache's rows
from ..ops.norms import rms_norm, silu
from ..ops.quant import Int8Linear, PackedLinear, embed_lookup, int8_matmul, quant_gemv, quant_matmul
from ..ops.rope import apply_rotary, mrope_cos_sin

Params = dict[str, Any]


class KVCache(NamedTuple):
    """Static-shape bf16 KV cache. k/v: [L, B, H_kv, T_max, D]."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return False


class KVCacheQ(NamedTuple):
    """int8 KV cache with per-row (per head per slot) f32 scales.

    k/v: int8 [L, B, H_kv, T_max, D]; ks/vs: f32 [L, B, H_kv, T_max], row
    scale = amax/127 at append time. Half the bytes of a bf16 cache for the
    attention to read; ``kv_cache_dtype="int8"`` opts in."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return True


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows` (q [..., D], scale [...])."""
    return (q.float() * scale[..., None].float()).to(dtype)


def make_cache(
    cfg: TalkerConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None, *,
    quantized: bool = False,
) -> KVCache | KVCacheQ:
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    if quantized:
        return KVCacheQ(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def _put_rows(cache, index: tuple, k, v) -> None:
    """Write k/v rows at ``index`` (an index into the cache's first four
    dims) in place; an int8 cache takes them quantized, with their scales
    at the same index."""
    if cache.quantized:
        (kq, ksc), (vq, vsc) = quantize_kv_rows(k), quantize_kv_rows(v)
        cache.k[index], cache.v[index], cache.ks[index], cache.vs[index] = kq, vq, ksc, vsc
    else:
        cache.k[index], cache.v[index] = k.to(cache.k.dtype), v.to(cache.v.dtype)


def _scatter_append_batched(cache, idx: int, k_new, v_new, offsets) -> None:
    """Write layer ``idx``'s new row of each sequence ([B, H_kv, D]) at its
    own cache offset ``offsets[b]``, in place. The JAX package appends all
    layers' rows after the step; the port's plain batched step writes each
    layer's rows as it goes."""
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    _put_rows(cache, (idx, rows, slice(None), offsets.long()), k_new, v_new)


def _layer_kv(cache, idx: int):
    """Layer ``idx``'s k/v rows to attend over: an int8 cache dequantized to
    bf16 (as the JAX package does, whatever the model's dtype)."""
    if cache.quantized:
        return dequantize_kv(cache.k[idx], cache.ks[idx]), dequantize_kv(cache.v[idx], cache.vs[idx])
    return cache.k[idx], cache.v[idx]


ENV_MODES = ("wo_bf16", "dyn_int8")  # the values of QWEN3TTS_TK_MODE / QWEN3TTS_CPK_MODE


def env_mode(var: str) -> str:
    """The matmul mode a variable of the JAX package selects, read when
    called: ``wo_bf16`` (unset) or ``dyn_int8``; any other value raises
    (the JAX package would treat it as ``wo_bf16``)."""
    mode = os.environ.get(var, "wo_bf16")
    if mode not in ENV_MODES:
        raise ValueError(f"{var}={mode!r}: expected one of {', '.join(ENV_MODES)}")
    return mode


def _kernel_mode(params) -> str:
    """K1's matmul mode, as the JAX package's ``_kernel_mode``
    (talker.py:317-327): "bf16" for a layout other than int8, else
    QWEN3TTS_TK_MODE (``wo_bf16`` by default; ``dyn_int8`` opts the int8
    layers into s8 x s8 matvecs)."""
    from ..ops.talker_kernel import _layout

    mode = env_mode("QWEN3TTS_TK_MODE")
    return mode if _layout(params["layers"]) == "int8" else "bf16"


def _k1_gate(params, x: torch.Tensor) -> bool:
    """Whether a single-token step runs through K1: a CUDA tensor and a fused
    layout (int8 or dense bf16). K1 raises on what it does not take (more
    than MAX_BATCH rows, activations not bf16), so such a step never runs
    the plain loop on the card."""
    from ..ops.talker_kernel import _layout

    return x.device.type == "cuda" and x.shape[1] == 1 and _layout(params["layers"]) is not None


def _dense(x: torch.Tensor, w) -> torch.Tensor:
    """y = x @ w for a dense [in, out] weight, an :class:`Int8Linear` or a
    :class:`PackedLinear`, accumulated in f32 and rounded once to x's dtype.

    A packed weight takes K4 (``quant_gemv``) for one row, which is the
    kernel on a CUDA tensor and the plain ``quant_matmul`` on the CPU; more
    rows (prompt and prefill) dequantize and multiply (``quant_matmul``)."""
    if isinstance(w, Int8Linear):
        return int8_matmul(x, w)
    if isinstance(w, PackedLinear):
        flat = x.reshape(-1, x.shape[-1])
        fn = quant_gemv if flat.shape[0] == 1 else quant_matmul
        y = fn(flat, w.q, w.scales, w.biases, w.bits, w.group)
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def resize_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Text projection MLP: fc2(silu(fc1(x)))."""
    h = _dense(x, params["fc1"]["w"]) + params["fc1"]["b"]
    h = silu(h)
    return _dense(h, params["fc2"]["w"]) + params["fc2"]["b"]


def _embed(table, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of an embedding table; a packed table gives float32."""
    if isinstance(table, PackedLinear):
        return embed_lookup(table, ids)
    return table[ids.long()]


def embed_text(params: Params, cfg: TalkerConfig, ids: torch.Tensor) -> torch.Tensor:
    """Token-map-aware text embedding lookup."""
    token_map = params.get("text_token_map")
    if token_map is not None:
        ids = token_map[ids]
    return _embed(params["text_embedding"], ids)


def embed_codec(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return _embed(params["codec_embedding"], ids)


def _project_qkv(p, x, B, S, nq, nkv, hd, eps):
    """q/k/v projections (fused or separate) + QK-RMSNorm, as [B, H, S, D]."""
    if "qkv_proj" in p:
        qkv = _dense(x, p["qkv_proj"])
        q = qkv[..., : nq * hd].reshape(B, S, nq, hd)
        k = qkv[..., nq * hd : (nq + nkv) * hd].reshape(B, S, nkv, hd)
        v = qkv[..., (nq + nkv) * hd :].reshape(B, S, nkv, hd)
    else:
        q = _dense(x, p["q_proj"]).reshape(B, S, nq, hd)
        k = _dense(x, p["k_proj"]).reshape(B, S, nkv, hd)
        v = _dense(x, p["v_proj"]).reshape(B, S, nkv, hd)
    q = rms_norm(q, p["q_norm"], eps).transpose(1, 2)
    k = rms_norm(k, p["k_norm"], eps).transpose(1, 2)
    return q, k, v.transpose(1, 2)


def _swiglu_mlp(p, x):
    """SwiGLU (fused or separate gate/up), before the down projection."""
    if "gate_up_proj" in p:
        gu = _dense(x, p["gate_up_proj"])
        half = gu.shape[-1] // 2
        return silu(gu[..., :half]) * gu[..., half:]
    return silu(_dense(x, p["gate_proj"])) * _dense(x, p["up_proj"])


def fuse_layer_projections(layers: Params) -> Params:
    """Fuse q/k/v -> qkv_proj and gate/up -> gate_up_proj (concat on out):
    dense stacks [L, in, out] on the last axis, stacked PackedLinears on the
    O axis (MLX groups run along each output row, so packing is kept)."""

    def cat(ws):
        if isinstance(ws[0], PackedLinear):
            return PackedLinear(
                torch.cat([w.q for w in ws], dim=-2),
                torch.cat([w.scales for w in ws], dim=-2),
                torch.cat([w.biases for w in ws], dim=-2),
                ws[0].bits, ws[0].group,
            )
        return torch.cat(ws, dim=-1)

    out = dict(layers)
    out["qkv_proj"] = cat([layers["q_proj"], layers["k_proj"], layers["v_proj"]])
    out["gate_up_proj"] = cat([layers["gate_proj"], layers["up_proj"]])
    for name in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        del out[name]
    return out


def _attend(q, k, v, mask, scale):
    """GQA attention. q: [B, Hq, S, D], k/v: [B, Hkv, T, D], mask: [B, S, T].

    Scores in f32, probabilities rounded to v's dtype, values summed in f32."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, S, D)
    scores = torch.einsum("bhgsd,bhtd->bhgst", qg.float(), k.float()) * scale
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs.float(), v.float())
    return out.reshape(B, Hq, S, D).to(q.dtype)


def _layer(layers: Params, idx: int) -> Params:
    return {k: v[idx] for k, v in layers.items()}


def attention_kernel_gate(S: int, B: int, T_max: int, cache_dtype, device) -> bool:
    """Whether ``forward`` attends through K3 (ops/attention.py): one token of
    one sequence on a CUDA bf16 cache of at least 4096 rows, a multiple of
    128 (the JAX package's gate, talker.py:431-439, without its switch)."""
    return (
        S == 1
        and B == 1
        and T_max % 128 == 0
        and T_max >= MIN_CACHE
        and cache_dtype == torch.bfloat16
        and torch.device(device).type == "cuda"
    )


def forward(
    params: Params,
    cfg: TalkerConfig,
    inputs_embeds: torch.Tensor,  # [B, S, h]
    cache: KVCache,
    offset: int,  # number of valid cache entries
):
    """Run the talker trunk, writing the new k/v rows into ``cache``.

    Prefill (S > 1, right-padded: padded rows land past the valid length and
    stay masked until overwritten) and single-token decode (S == 1). On CUDA
    a single-token step with fused weights (int8 or dense bf16) runs through
    K1 in its non-sample mode (the JAX package's talker.py:403-421); the other
    decode steps attend through K3 over rows [0, offset] where
    :func:`attention_kernel_gate` holds. An int8 cache takes the new rows
    quantized and is attended dequantized to bf16. Returns (hidden [B, S, h]
    after the final norm, cache).
    """
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    T_max = cache.max_len
    positions = (offset + torch.arange(S, device=dev))[None].expand(B, S)
    cos, sin = mrope_cos_sin(
        positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_section, inputs_embeds.dtype
    )
    if _k1_gate(params, inputs_embeds):
        from ..ops.talker_kernel import talker_decode_step

        offs = offset if B == 1 else torch.full((B,), offset, dtype=torch.int32, device=dev)
        h = talker_decode_step(params, cfg, inputs_embeds, cache, offs, cos[:, 0], sin[:, 0],
                               sample=False, mode=_kernel_mode(params))
        return h.reshape(B, 1, -1), cache
    t_idx = torch.arange(T_max, device=dev)
    q_pos = offset + torch.arange(S, device=dev)
    mask = (t_idx[None, :] <= q_pos[:, None])[None].expand(B, S, T_max)

    use_k3 = attention_kernel_gate(S, B, T_max, cache.k.dtype, dev)

    scale = cfg.head_dim**-0.5
    nq, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    h = inputs_embeds
    for idx in range(cfg.num_hidden_layers):
        p = _layer(params["layers"], idx)
        x = rms_norm(h, p["input_layernorm"], eps)
        q, k, v = _project_qkv(p, x, B, S, nq, nkv, hd, eps)
        q, k = apply_rotary(q, k, cos, sin)
        _put_rows(cache, (idx, slice(None), slice(None), slice(offset, offset + S)), k, v)
        if use_k3:
            attn = decode_attention_inner(q, cache.k, cache.v, offset, scale, layer=idx)
        else:
            attn = _attend(q, *_layer_kv(cache, idx), mask, scale)
        attn = attn.transpose(1, 2).reshape(B, S, nq * hd)
        h = h + _dense(attn, p["o_proj"])
        x = rms_norm(h, p["post_attention_layernorm"], eps)
        h = h + _dense(_swiglu_mlp(p, x), p["down_proj"])
    return rms_norm(h, params["norm"], eps), cache


def forward_step_sample(
    params: Params,
    cfg: TalkerConfig,
    inputs_embeds: torch.Tensor,  # [1, 1, h]
    cache: KVCache,
    offset: int,
    *,
    seen: torch.Tensor,  # [vocab] bool
    suppress_add: torch.Tensor,  # [vocab] f32 additive mask (-1e30 suppressed)
    seed: tuple[int, int],  # the sampler's two seed words
    temperature: float,
    top_k: int,
    repetition_penalty: float,
    eos_token_id: int | None,
    rope: tuple[torch.Tensor, torch.Tensor],
    top_p: float = 1.0,
    ref_exact_top_p: bool = False,
):
    """Decode step + codec head + code0 sampler through K1
    (ops/talker_kernel.py), on a bf16 or an int8 cache. ``rope``: the cos/sin
    tables [T_max, D] (bf16) of every cache position. Returns (hidden
    [1, 1, h] post-final-norm, cache, code0 [1] int32)."""
    from ..ops.talker_kernel import talker_decode_step

    cos, sin = rope[0][offset], rope[1][offset]
    h, code0 = talker_decode_step(
        params, cfg, inputs_embeds, cache, offset, cos, sin, mode=_kernel_mode(params),
        temperature=float(temperature),
        top_k=int(top_k),
        top_p=float(top_p),
        ref_exact_top_p=bool(ref_exact_top_p),
        rep_penalty=float(repetition_penalty),
        eos_id=-1 if eos_token_id is None else int(eos_token_id),
        seed=seed,
        suppress_add=suppress_add,
        seen=seen,
    )
    return h.reshape(1, 1, -1), cache, code0


def forward_batched_step_sample(
    params: Params,
    cfg: TalkerConfig,
    inputs_embeds: torch.Tensor,  # [B, 1, h]
    cache,
    offsets: torch.Tensor,  # [B] int32 on the device: per-sequence cache positions
    *,
    seen: torch.Tensor,  # [B, vocab] bool
    suppress_add: torch.Tensor,  # [vocab] f32 additive mask (-1e30 suppressed)
    seed: tuple[int, int],  # the sampler's two seed words (row b: stream 16 b)
    temperature: float,
    top_k: int,
    repetition_penalty: float,
    eos_token_id: int | None,
    rope: tuple[torch.Tensor, torch.Tensor],
    top_p: float = 1.0,
    ref_exact_top_p: bool = False,
    rows=None,  # decode_blocks.SampRows: per-row sampling values (per_request)
):
    """Batched decode step + codec head + per-row code0 sampler through K1
    (the batched twin of :func:`forward_step_sample`); each sequence writes
    its k/v row at its own offset. ``rows`` replaces temperature, top_k,
    top_p and repetition_penalty with each row's own. Returns (hidden
    [B, 1, h] post-final-norm, cache, code0 [B] int32)."""
    from ..ops.talker_kernel import talker_decode_step

    pos = offsets.long()
    h, code0 = talker_decode_step(
        params, cfg, inputs_embeds, cache, offsets, rope[0][pos], rope[1][pos],
        mode=_kernel_mode(params), temperature=float(temperature),
        top_k=int(top_k),
        top_p=float(top_p),
        ref_exact_top_p=bool(ref_exact_top_p),
        rep_penalty=float(repetition_penalty),
        eos_id=-1 if eos_token_id is None else int(eos_token_id),
        seed=seed,
        suppress_add=suppress_add,
        seen=seen,
        rows=rows,
    )
    return h[:, None], cache, code0


def forward_batched_step(
    params: Params,
    cfg: TalkerConfig,
    inputs_embeds: torch.Tensor,  # [B, 1, h]
    cache,
    offsets: torch.Tensor,  # [B] int32 on the device: per-sequence cache positions
):
    """Single-token decode for a batch of sequences at different positions.

    Like :func:`forward` with S=1, but each sequence writes its k/v at its
    own offset and masks its own prefix: the lockstep decoder's step
    (models/batch_generate.py). On CUDA with fused weights (int8 or dense
    bf16) it is K1's non-sample mode; otherwise the plain path, which on an int8 cache
    quantizes the new rows before attending. Returns (hidden [B, 1, h] after
    the final norm, cache)."""
    B, S, _ = inputs_embeds.shape
    if S != 1:
        raise ValueError("forward_batched_step is single-token decode only")
    dev = inputs_embeds.device
    cos, sin = mrope_cos_sin(
        offsets[:, None].long(), cfg.head_dim, cfg.rope_theta, cfg.mrope_section,
        inputs_embeds.dtype,
    )  # [B, 1, D]
    if _k1_gate(params, inputs_embeds):
        from ..ops.talker_kernel import talker_decode_step

        h = talker_decode_step(params, cfg, inputs_embeds, cache, offsets, cos[:, 0], sin[:, 0],
                               sample=False, mode=_kernel_mode(params))
        return h[:, None], cache
    t_idx = torch.arange(cache.max_len, device=dev)
    mask = t_idx[None, None, :] <= offsets.long()[:, None, None]  # [B, 1, T]
    scale = cfg.head_dim**-0.5
    nq, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    h = inputs_embeds
    for idx in range(cfg.num_hidden_layers):
        p = _layer(params["layers"], idx)
        x = rms_norm(h, p["input_layernorm"], eps)
        q, k, v = _project_qkv(p, x, B, S, nq, nkv, hd, eps)
        q, k = apply_rotary(q, k, cos, sin)
        _scatter_append_batched(cache, idx, k[:, :, 0], v[:, :, 0], offsets)
        attn = _attend(q, *_layer_kv(cache, idx), mask, scale)
        attn = attn.transpose(1, 2).reshape(B, S, nq * hd)
        h = h + _dense(attn, p["o_proj"])
        x = rms_norm(h, p["post_attention_layernorm"], eps)
        h = h + _dense(_swiglu_mlp(p, x), p["down_proj"])
    return rms_norm(h, params["norm"], eps), cache


def codec_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """First-codebook logits [B, S, vocab] in float32."""
    return _dense(hidden.float(), params["codec_head"])
