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
from ..ops.quant import Int8Linear, PackedLinear, embed_lookup, int8_matmul, quant_gemm, quant_gemv
from ..ops.rope import apply_rotary, mrope_cos_sin
from ..parallel.mesh import ShardedCache, shard_cache, tree_mesh

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
    quantized: bool = False, mesh=None,
) -> KVCache | KVCacheQ | ShardedCache:
    """A zeroed cache; with ``mesh`` split over it (``parallel.mesh.shard_cache``)."""
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
    if quantized:
        cache = KVCacheQ(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    else:
        cache = KVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )
    return cache if mesh is None else shard_cache(cache, mesh)


def cache_scratch(cache):
    """A zeroed one-sequence cache like ``cache`` (an admission prefills
    into it; ``put_cache_slot`` copies it in)."""
    if isinstance(cache, ShardedCache):
        part, n_heads = cache.parts[0][0], len(cache.parts[0])
        whole = type(part)(*(torch.zeros((a.shape[0], 1, a.shape[2] * n_heads) + a.shape[3:],
                                         dtype=a.dtype) for a in part))
        return shard_cache(whole, cache.mesh)
    return type(cache)(
        *(torch.zeros((a.shape[0], 1) + a.shape[2:], dtype=a.dtype, device=a.device)
          for a in cache)
    )


def put_cache_slot(cache, slot: int, scratch) -> None:
    """Copy a one-sequence cache (``cache_scratch``) into batch row
    ``slot`` of ``cache``, in place."""
    if isinstance(cache, ShardedCache):
        (i, rows), = [(i, r) for i, r in cache.rows() if r.start is None or r.start <= slot < r.stop]
        local = slot - (rows.start or 0)
        for full, part in zip(cache.parts[i], scratch.parts[0]):
            for a, b in zip(full, part):
                a[:, local] = b[:, 0].to(a.device)
        return
    for full, part in zip(cache, scratch):
        full[:, slot] = part[:, 0]


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

    A packed weight takes K4 (``quant_gemv``) for one row and its M-row
    form (``quant_gemm``) for more: the lockstep step, the code predictor's
    two-token first position, prompt and prefill. On a CUDA tensor each
    launches its kernel or raises on a shape it does not take; on the CPU
    both run the plain ``quant_matmul``."""
    if isinstance(w, Int8Linear):
        return int8_matmul(x, w)
    if isinstance(w, PackedLinear):
        flat = x.reshape(-1, x.shape[-1])
        fn = quant_gemv if flat.shape[0] == 1 else quant_gemm
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


def _partial(x: torch.Tensor, w) -> torch.Tensor:
    """A position's share of a row-parallel product (o_proj, down_proj) in
    f32, unrounded: the sum of the shares is rounded once, as the whole
    product is in ``_dense``."""
    if isinstance(w, Int8Linear):
        return torch.matmul(x.float(), w.q.float()) * w.scale
    return torch.matmul(x.float(), w.float())


def _reduce(parts: list[torch.Tensor], device, dtype) -> torch.Tensor:
    """The sum of the positions' shares, on ``device`` (the group's first):
    the partials are copied there and added in position order."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total.to(dtype)


def _tp_attention(ps, group, ctxs, parts, idx, x, heads, step):
    """One layer's attention on a tensor-parallel tree: each position's
    o_proj share [B, S, H] (f32). Where tp divides the kv heads each
    position attends over its own heads and its own part of the cache;
    otherwise (the cache's heads are not split) the positions' q/k/v
    columns are gathered on the group's first device, which attends over
    every head, and each position takes its columns of the output."""
    nq, nkv, hd, eps = heads
    tp = len(group)
    B, S = x.shape[:2]
    if len(parts) == tp:  # heads split with the cache
        o = []
        for t, dev in enumerate(group):
            xt = rms_norm(x.to(dev), ps[t]["input_layernorm"], eps)
            q, k, v = _project_qkv(ps[t], xt, B, S, nq // tp, nkv // tp, hd, eps)
            q, k = apply_rotary(q, k, ctxs[t]["cos"], ctxs[t]["sin"])
            attn = step(ctxs[t], parts[t], idx, q, k, v)
            o.append(_partial(attn.transpose(1, 2).reshape(B, S, -1), ps[t]["o_proj"]))
        return o
    cols = {name: [] for name in ("q_proj", "k_proj", "v_proj")}
    for t, dev in enumerate(group):
        xt = rms_norm(x.to(dev), ps[t]["input_layernorm"], eps)
        for name in cols:
            cols[name].append(_dense(xt, ps[t][name]).to(group[0]))
    whole = {name: torch.cat(c, dim=-1) for name, c in cols.items()}
    whole.update(q_norm=ps[0]["q_norm"], k_norm=ps[0]["k_norm"])
    q = rms_norm(whole["q_proj"].reshape(B, S, nq, hd), whole["q_norm"], eps).transpose(1, 2)
    k = rms_norm(whole["k_proj"].reshape(B, S, nkv, hd), whole["k_norm"], eps).transpose(1, 2)
    v = whole["v_proj"].reshape(B, S, nkv, hd).transpose(1, 2)
    q, k = apply_rotary(q, k, ctxs[0]["cos"], ctxs[0]["sin"])
    attn = step(ctxs[0], parts[0], idx, q, k, v).transpose(1, 2).reshape(B, S, nq * hd)
    return [_partial(a.to(dev), ps[t]["o_proj"])
            for t, (a, dev) in enumerate(zip(torch.chunk(attn, tp, dim=-1), group))]


def _act_max(gated: torch.Tensor) -> torch.Tensor:
    """max |silu(gate) * up| over batch and time, per neuron, in f32."""
    return gated.float().abs().amax(dim=(0, 1))


def _tp_stack(layers: Params, n_layers: int, heads: tuple, h: torch.Tensor, cache, local, step,
              acts=None):
    """The layer stack on a tensor-parallel tree (``parallel.mesh``): for
    each dp row of ``cache`` (a ``ShardedCache``) and each layer, every tp
    position computes its heads (``_tp_attention``) and its slice of the
    MLP, each on its device's current stream and all issued from this host
    thread; the partial sums after o_proj and after down_proj are added on
    the group's first device, and the sum goes back to each position with
    its next input. ``heads`` = (nq, nkv, head_dim, eps); ``local(i, t,
    device, rows)`` gives a position's per-call context (its rope rows and
    mask), ``step(ctx, cache_part, idx, q, k, v)`` writes new k/v rows
    into a part of the cache and attends. ``acts`` (a list of one list a
    layer) collects each position's per-neuron FFN maxima (``_act_max``)
    on the mesh's first device, dp row by dp row and tp position by
    position (``activation_stats``). Returns h [B, S, H] before the final
    norm, on h's device."""
    eps = heads[3]
    mesh = cache.mesh
    tp = mesh.shape["tp"]
    outs = []
    for i, rows in cache.rows():
        group = mesh.devices[i]
        ctxs = [local(i, t, dev, rows) for t, dev in enumerate(group[:len(cache.parts[i])])]
        x = h[rows].to(group[0])
        for idx in range(n_layers):
            ps = [{k: w.parts[i][t][idx] for k, w in layers.items()} for t in range(tp)]
            o = _tp_attention(ps, group, ctxs, cache.parts[i], idx, x, heads, step)
            x = x + _reduce(o, group[0], x.dtype)
            m = []
            for t, dev in enumerate(group):
                xt = rms_norm(x.to(dev), ps[t]["post_attention_layernorm"], eps)
                gated = _swiglu_mlp(ps[t], xt)
                if acts is not None:
                    acts[idx].append(_act_max(gated).to(mesh.home))
                m.append(_partial(gated, ps[t]["down_proj"]))
            x = x + _reduce(m, group[0], x.dtype)
        outs.append(x.to(h.device))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _forward_tp(params, cfg, inputs_embeds, cache, offset: int, offsets=None, acts=None):
    """``forward`` (``offsets`` None) or ``forward_batched_step`` (per-row
    ``offsets`` [B]) on a tensor-parallel tree: the plain per-position
    layer step, the counterpart of the JAX package's XLA path under a mesh.
    At B = 1 on a bf16 cache of >= 4096 rows each position attends over
    its own kv heads through K3 (``attention_kernel_gate``), as the JAX
    XLA path calls ``decode_attention_inner`` under a mesh. ``acts``: as
    in ``_tp_stack``."""
    if not isinstance(cache, ShardedCache):
        raise ValueError("a tensor-parallel model decodes into a sharded cache "
                         "(make_cache(..., mesh=) or parallel.mesh.shard_cache)")
    B, S, _ = inputs_embeds.shape
    T_max = cache.max_len
    scale = cfg.head_dim**-0.5
    heads = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.rms_norm_eps)

    def local(i, t, dev, rows):
        t_idx = torch.arange(T_max, device=dev)
        if offsets is None:
            pos = (offset + torch.arange(S, device=dev))[None].expand(B, S)[rows]
            mask = t_idx[None, None, :] <= pos[:, :, None]
            offs = None
        else:
            offs = offsets[rows].to(dev)
            pos = offs[:, None].long()
            mask = t_idx[None, None, :] <= pos[:, :, None]
        cos, sin = mrope_cos_sin(pos, cfg.head_dim, cfg.rope_theta, cfg.mrope_section,
                                 inputs_embeds.dtype)
        part = cache.parts[i][t]
        k3 = offsets is None and attention_kernel_gate(S, pos.shape[0], T_max, part.k.dtype, dev)
        return dict(cos=cos, sin=sin, mask=mask, offs=offs, k3=k3)

    def step(ctx, part, idx, q, k, v):
        if ctx["offs"] is None:
            _put_rows(part, (idx, slice(None), slice(None), slice(offset, offset + S)), k, v)
        else:
            _scatter_append_batched(part, idx, k[:, :, 0], v[:, :, 0], ctx["offs"])
        if ctx["k3"]:
            return decode_attention_inner(q, part.k, part.v, offset, scale, layer=idx)
        return _attend(q, *_layer_kv(part, idx), ctx["mask"], scale)

    h = _tp_stack(params["layers"], cfg.num_hidden_layers, heads, inputs_embeds, cache, local, step,
                  acts)
    return rms_norm(h, params["norm"], cfg.rms_norm_eps), cache


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
    after the final norm, cache). On a tensor-parallel tree (``mesh=``)
    every step is the plain per-position step (``_forward_tp``).
    """
    if tree_mesh(params) is not None:
        return _forward_tp(params, cfg, inputs_embeds, cache, offset)
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
    if tree_mesh(params) is not None:
        return _forward_tp(params, cfg, inputs_embeds, cache, 0, offsets=offsets)
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


def activation_stats(params: Params, cfg: TalkerConfig, inputs_embeds: torch.Tensor) -> torch.Tensor:
    """Teacher-forced causal forward over a whole sequence, returning the
    per-neuron FFN maxima: max |silu(gate(x)) * up(x)| over batch and time,
    [L, intermediate] f32 (the JAX package's talker.py:762-794).

    It replays a generated sequence (the prompt and the rebuilt decode
    inputs) for the activation profiler (utils/profiler.py); its
    activations are the decode's, as its inputs and causal masking are. It
    is plain PyTorch on every device (the JAX version is XLA, no Pallas),
    on any layout of the talker tree: fused or separate projections,
    ``Int8Linear``, dense bf16 or f32, and packed MLX weights, whose rows
    of more than one token take ``quant_gemm`` (``_dense``). On a tensor-parallel
    tree (``mesh=``) it is the per-position step of ``_tp_stack`` over a
    scratch sharded cache of the sequence's length; each position's
    neurons are its slice of the intermediate axis, concatenated in order
    on the mesh's first device."""
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    L = cfg.num_hidden_layers
    mesh = tree_mesh(params)
    if mesh is not None:
        acts = [[] for _ in range(L)]
        cache = make_cache(cfg, B, S, inputs_embeds.dtype, dev, mesh=mesh)
        _forward_tp(params, cfg, inputs_embeds, cache, 0, acts=acts)
        tp = mesh.shape["tp"]
        return torch.stack([
            torch.stack([torch.cat(a[r : r + tp]) for r in range(0, len(a), tp)]).amax(dim=0)
            for a in acts
        ])
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    cos, sin = mrope_cos_sin(
        positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_section, inputs_embeds.dtype
    )
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()[None].expand(B, S, S)
    scale = cfg.head_dim**-0.5
    nq, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    h = inputs_embeds
    acts = []
    for idx in range(L):
        p = _layer(params["layers"], idx)
        x = rms_norm(h, p["input_layernorm"], eps)
        q, k, v = _project_qkv(p, x, B, S, nq, nkv, hd, eps)
        q, k = apply_rotary(q, k, cos, sin)
        attn = _attend(q, k, v, mask, scale).transpose(1, 2).reshape(B, S, nq * hd)
        h = h + _dense(attn, p["o_proj"])
        x = rms_norm(h, p["post_attention_layernorm"], eps)
        gated = _swiglu_mlp(p, x)
        acts.append(_act_max(gated))
        h = h + _dense(gated, p["down_proj"])
    return torch.stack(acts)


def codec_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """First-codebook logits [B, S, vocab] in float32."""
    return _dense(hidden.float(), params["codec_head"])
