"""CodePredictor: the 5-layer MTP transformer predicting codebooks 2..16
(port of qwen3tts_tpu/models/code_predictor.py).

Per talker frame: a 2-token prefill of [talker hidden, codec_embed(code0)],
then 14 single-token steps, each with its own embedding table and LM head
(stacked on a leading axis), over a 16-slot cache reset every frame. This is
the plain path, which also serves packed weights (their single-row matmuls
go through K4, models/talker.py ``_dense``); fused int8 or dense bf16
weights take K2 on the card (ops/cp_kernel.py).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..config import CodePredictorConfig
from ..ops.norms import rms_norm
from ..ops.quant import PackedLinear, embed_lookup
from ..ops.rope import apply_rotary, rope_cos_sin
from ..ops.sampling import sample_token_inner, sample_token_vec
from .talker import _attend, _dense, _embed, _layer, _project_qkv, _swiglu_mlp

Params = dict[str, Any]


def cache_len(cfg: CodePredictorConfig) -> int:
    """2 (prefill) + 14 (AR steps) = num_code_groups slots."""
    return cfg.num_code_groups


class CPCache(NamedTuple):
    k: torch.Tensor  # [L, B, H_kv, 16, D]
    v: torch.Tensor


def make_cp_cache(cfg: CodePredictorConfig, batch: int, dtype=torch.bfloat16, device=None) -> CPCache:
    shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, cache_len(cfg), cfg.head_dim)
    return CPCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def _project(params: Params, x: torch.Tensor) -> torch.Tensor:
    proj = params.get("small_to_mtp_projection")
    if proj is not None:
        return _dense(x, proj["w"]) + proj["b"]
    return x


def forward(
    params: Params,
    cfg: CodePredictorConfig,
    inputs_embeds: torch.Tensor,  # [B, S, talker_h] (pre-projection)
    cache: CPCache,
    offset: int,
):
    """One trunk pass of S tokens at cache position ``offset``; the new k/v
    rows are written into ``cache`` in place. Returns (hidden [B, S, h],
    cache); the caller picks the LM head."""
    h = _project(params, inputs_embeds)
    B, S, _ = h.shape
    dev = h.device
    T_max = cache.k.shape[3]
    positions = (offset + torch.arange(S, device=dev))[None].expand(B, S)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, h.dtype)
    t_idx = torch.arange(T_max, device=dev)
    q_pos = offset + torch.arange(S, device=dev)
    mask = (t_idx[None, :] <= q_pos[:, None])[None].expand(B, S, T_max)

    scale = cfg.head_dim**-0.5
    nq, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    for idx in range(cfg.num_hidden_layers):
        p = _layer(params["layers"], idx)
        x = rms_norm(h, p["input_layernorm"], eps)
        q, k, v = _project_qkv(p, x, B, S, nq, nkv, hd, eps)
        q, k = apply_rotary(q, k, cos, sin)
        cache.k[idx, :, :, offset : offset + S] = k.to(cache.k.dtype)
        cache.v[idx, :, :, offset : offset + S] = v.to(cache.v.dtype)
        attn = _attend(q, cache.k[idx], cache.v[idx], mask, scale)
        attn = attn.transpose(1, 2).reshape(B, S, nq * hd)
        h = h + _dense(attn, p["o_proj"])
        x = rms_norm(h, p["post_attention_layernorm"], eps)
        h = h + _dense(_swiglu_mlp(p, x), p["down_proj"])
    return rms_norm(h, params["norm"], eps), cache


def head_logits(params: Params, hidden: torch.Tensor, head_idx: int) -> torch.Tensor:
    """LM head ``head_idx`` logits in float32. hidden: [B, h] -> [B, vocab]."""
    return _dense(hidden.float(), params["lm_head"][head_idx])


def predict_codes(
    params: Params,
    cfg: CodePredictorConfig,
    talker_params: Params,
    last_hidden: torch.Tensor,  # [B, talker_h]
    code0: torch.Tensor,  # [B] int32
    generator: torch.Generator | None,
    *,
    temperature: float,
    top_k: int,
    top_p: float,
    ref_exact_top_p: bool = False,
    samp_vec=None,  # [B, 4] per-row (temperature, top_k, top_p, repetition_penalty)
) -> torch.Tensor:
    """Codebooks 2..16 for one frame: codes [B, 15] int32, sampled with the
    shared temperature/top-k/top-p and no penalty, suppression or EOS.
    ``samp_vec`` (serving's per-request sampling) gives each row its own
    temperature, top_k and top_p (columns 0-2; column 3, the penalty, is
    not used: the reference's CP loop applies none)."""
    B = code0.shape[0]
    cache = make_cp_cache(cfg, B, last_hidden.dtype, last_hidden.device)

    def sample(logits):
        if samp_vec is not None:
            return sample_token_vec(
                generator, logits, temperature=samp_vec[:, 0], top_k=samp_vec[:, 1],
                top_p=samp_vec[:, 2], ref_exact_top_p=ref_exact_top_p,
            )
        return sample_token_inner(
            generator, logits, temperature=temperature, top_k=top_k, top_p=top_p,
            ref_exact_top_p=ref_exact_top_p,
        )

    code0_embed = _embed(talker_params["codec_embedding"], code0).to(last_hidden.dtype)
    x0 = torch.stack([last_hidden, code0_embed], dim=1)  # [B, 2, talker_h]
    h, cache = forward(params, cfg, x0, cache, 0)
    codes = [sample(head_logits(params, h[:, -1], 0))]
    for idx in range(1, cfg.num_code_groups - 1):
        emb = _embed(params["codec_embedding"][idx - 1], codes[-1].long()).to(last_hidden.dtype)
        h, cache = forward(params, cfg, emb[:, None], cache, idx + 1)
        codes.append(sample(head_logits(params, h[:, -1], idx)))
    return torch.stack(codes, dim=1).to(torch.int32)


def sum_codec_embeddings(
    params: Params, talker_params: Params, code0: torch.Tensor, rest_codes: torch.Tensor
) -> torch.Tensor:
    """Sum of all 16 codebook embeddings for the next talker input.
    code0: [B], rest_codes: [B, 15] -> [B, talker_h]."""
    emb = _embed(talker_params["codec_embedding"], code0.long())
    tables = params["codec_embedding"]  # [15, vocab, h] (or a stacked PackedLinear)
    idx = torch.arange(rest_codes.shape[-1], device=rest_codes.device)
    rows = (idx[None, :], rest_codes.long())  # row rest_codes[b, i] of table i
    if isinstance(tables, PackedLinear):
        per_cb = embed_lookup(tables, rows)  # [B, 15, h] f32
    else:
        per_cb = tables[rows]
    return (emb + per_cb.sum(dim=1).to(emb.dtype)).to(emb.dtype)
