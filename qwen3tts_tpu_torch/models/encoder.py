"""Speech-tokenizer encoder (Mimi-style) for voice cloning (port of
qwen3tts_tpu/models/encoder.py): 24 kHz audio -> 16-codebook codes at
12.5 Hz (downsample 1920x).

Pipeline: SEANet conv encoder (init conv 1 -> 64, k 7; 4 stages with the
reversed ratios [4, 5, 6, 8]: ELU -> residual block (dilated k 3 + 1x1, true
skip) -> ELU -> strided downsample k = 2r, channels doubling; final conv ->
512) -> 8-layer causal transformer (LayerNorm with bias, tanh-GELU MLP,
LayerScale, standard RoPE, full causal mask) -> stride-2 downsample conv
(edge padding, no bias) -> split RVQ encode: the nearest codebook entry by
||e||^2 / 2 - x.e (the first 16 of 32 quantizers returned).

The whole reference clip is encoded at once, in f32 without TF32
(``ops.conv.exact_f32``); the convolutions and matmuls are plain PyTorch
(cuDNN and cuBLAS on the card), as XLA computed them in the JAX package.
Codebooks are derived from the checkpoint's sums: embedding = embed_sum /
clamp(usage, eps).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import TokenizerEncoderConfig
from ..ops.conv import exact_f32, streamable_conv1d
from ..ops.norms import elu, gelu_tanh, layer_norm
from ..ops.rope import apply_rotary, rope_cos_sin

Params = dict[str, Any]


def seanet_encoder(p: Params, cfg: TokenizerEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, 1] audio -> [B, T / 960, hidden] latents."""
    h = streamable_conv1d(x, p["init_conv"]["w"], p["init_conv"]["b"], causal=cfg.use_causal_conv)
    for layer, ratio in zip(p["layers"], reversed(cfg.upsampling_ratios)):
        for ridx, res in enumerate(layer["residuals"]):
            out = h
            # block = [(k = residual_kernel_size, dilated), (k = 1)]; the
            # dilation grows with the residual layer
            res_dilation = cfg.dilation_growth_rate**ridx
            for j, conv_p in enumerate(res["block"]):
                out = streamable_conv1d(
                    elu(out), conv_p["w"], conv_p["b"],
                    dilation=res_dilation if j == 0 else 1, causal=cfg.use_causal_conv,
                )
            h = out + h  # true-skip shortcut
        h = streamable_conv1d(
            elu(h), layer["downsample"]["w"], layer["downsample"]["b"], stride=ratio, causal=True
        )
    return streamable_conv1d(
        elu(h), p["final_conv"]["w"], p["final_conv"]["b"], causal=cfg.use_causal_conv
    )


def encoder_transformer(p: Params, cfg: TokenizerEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """The causal transformer at the SEANet rate. x: [B, T, d]."""
    B, T, d = x.shape
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = d // nq  # head_dim = d_model / heads
    scale = hd**-0.5
    pos = torch.arange(T, device=x.device)[None].expand(B, T)
    cos, sin = rope_cos_sin(pos, hd, cfg.rope_theta, x.dtype)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    layers = p["layers"]
    h = x
    for l in range(layers["q_proj"].shape[0]):
        w = {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict) else v[l])
             for k, v in layers.items()}
        xn = layer_norm(h, w["norm1"]["w"], w["norm1"]["b"], 1e-5)
        q = (xn @ w["q_proj"]).reshape(B, T, nq, hd).transpose(1, 2)
        k = (xn @ w["k_proj"]).reshape(B, T, nkv, hd).transpose(1, 2)
        v = (xn @ w["v_proj"]).reshape(B, T, nkv, hd).transpose(1, 2)
        q, k = apply_rotary(q, k, cos, sin)
        scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
        scores = torch.where(causal, scores, torch.tensor(-1e30, device=x.device))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("bhst,bhtd->bhsd", probs, v).transpose(1, 2).reshape(B, T, d)
        h = h + (attn @ w["o_proj"]) * w["layer_scale_1"]
        xn = layer_norm(h, w["norm2"]["w"], w["norm2"]["b"], 1e-5)
        h = h + (gelu_tanh(xn @ w["linear1"]) @ w["linear2"]) * w["layer_scale_2"]
    return h


def codebook_embedding(layer: Params, eps: float = 1e-5) -> torch.Tensor:
    usage = torch.clamp_min(layer["cluster_usage"], eps)[:, None]
    return layer["embedding_sum"] / usage


def _euclidean_encode(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """The nearest codebook entry by ||e||^2 / 2 - x.e (the first on a tie).
    x: [B, T, d], embedding: [bins, d] -> codes [B, T] int32."""
    xf, ef = x.float(), embedding.float()
    c2 = 0.5 * (ef * ef).sum(dim=-1)  # [bins]
    dots = torch.einsum("btd,nd->btn", xf, ef)
    return torch.argmin(c2[None, None] - dots, dim=-1).to(torch.int32)


def _rvq_encode(p: Params, x: torch.Tensor, nq: int) -> torch.Tensor:
    """Residual VQ encode. x: [B, T, hidden] -> codes [B, nq, T]."""
    residual = (x @ p["input_proj"]).float()
    codes = []
    for i in range(nq):
        emb = codebook_embedding(p["layers"][i])
        idx = _euclidean_encode(residual, emb)
        residual = residual - emb[idx.long()].float()
        codes.append(idx)
    return torch.stack(codes, dim=1)


def split_rvq_encode(p: Params, cfg: TokenizerEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, hidden] -> codes [B, num_quantizers, T] (semantic first)."""
    first = _rvq_encode(p["rvq_first"], x, 1)
    rest = _rvq_encode(p["rvq_rest"], x, cfg.num_quantizers - 1)
    return torch.cat([first, rest], dim=1)


def encode(
    params: Params, cfg: TokenizerEncoderConfig, audio: torch.Tensor, valid_num_quantizers: int = 16
) -> torch.Tensor:
    """audio [B, samples] at 24 kHz -> codes [B, valid_num_quantizers, T]
    int32 at 12.5 Hz."""
    # the stride from the SEANet rate to the frame rate
    stride = int((cfg.sampling_rate / int(np.prod(cfg.upsampling_ratios))) / cfg.frame_rate)
    with exact_f32():
        x = audio[..., None].float()  # [B, T, 1]
        h = seanet_encoder(params["seanet"], cfg, x)
        h = encoder_transformer(params["transformer"], cfg, h)
        h = streamable_conv1d(
            h, params["downsample"]["w"], None, stride=stride, causal=cfg.use_causal_conv,
            pad_mode="edge",
        )
        codes = split_rvq_encode(params["quantizer"], cfg, h)
    return codes[:, :valid_num_quantizers]
