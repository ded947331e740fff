"""Speech-tokenizer decoder, codes to waveform (port of
qwen3tts_tpu/models/vocoder.py).

16-codebook codes at 12.5 Hz -> 24 kHz waveform (total upsample 1920x):
SplitRVQ dequantize -> causal pre_conv -> bidirectional pre-transformer
(masked to the valid frames, so bucketed decode is exact on its prefix) ->
2 x [causal ConvTranspose + ConvNeXt] -> main decoder (SnakeBeta, causal
ConvTranspose, dilated residual units) -> out conv -> clip [-1, 1].
Activations stay NWC like the JAX code.
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import TokenizerDecoderConfig
from ..ops.conv import causal_conv1d, causal_conv1d_transpose, exact_f32
from ..ops.norms import layer_norm, rms_norm, silu, snake_beta

Params = dict[str, Any]


def _mm(x, w):
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def rvq_decode(params: Params, cfg: TokenizerDecoderConfig, codes: torch.Tensor) -> torch.Tensor:
    """SplitRVQ dequantize. codes: [B, T, 16] -> [B, T, codebook_dim]."""
    nsem = cfg.num_semantic_quantizers
    first = params["quantizer"]["rvq_first"]
    rest = params["quantizer"]["rvq_rest"]
    codes = codes.long()
    sem = torch.zeros(
        codes.shape[:2] + (first["codebooks"].shape[-1],),
        dtype=first["codebooks"].dtype, device=codes.device,
    )
    for i in range(nsem):
        sem = sem + first["codebooks"][i][codes[..., i]]
    out = _mm(sem, first["output_proj"]["w"])
    ac = torch.zeros_like(sem)
    take = min(rest["codebooks"].shape[0], codes.shape[-1] - nsem)
    for i in range(take):
        ac = ac + rest["codebooks"][i][codes[..., nsem + i]]
    if take > 0:
        out = out + _mm(ac, rest["output_proj"]["w"])
    return out


def _frames_per_row(frames, B: int, device) -> torch.Tensor:
    """``frames`` (an int, or one count per row) as an int tensor [B]."""
    if isinstance(frames, int):
        return torch.full((B,), frames, device=device)
    return torch.as_tensor(frames, device=device).reshape(-1).expand(B)


def pre_transformer(
    params: Params, cfg: TokenizerDecoderConfig, x: torch.Tensor, frames=None
) -> torch.Tensor:
    """Bidirectional transformer at the latent rate. x: [B, T, latent].

    With ``frames`` (valid frame count: an int, or [B] per row) attention is
    masked to each row's first ``frames`` keys, so right-padding to a bucket
    does not leak into audio.
    """
    h = _mm(x, params["input_proj"]["w"]) + params["input_proj"]["b"]
    B, T, _ = h.shape
    nq, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    scale = hd**-0.5
    eps = cfg.rms_norm_eps
    key_mask = None
    if frames is not None:
        frames_b = _frames_per_row(frames, B, x.device)
        key_mask = (torch.arange(T, device=x.device)[None] < frames_b[:, None])[:, None, None, :]
    layers = params["layers"]
    for idx in range(layers["q_proj"].shape[0]):
        p = {k: v[idx] for k, v in layers.items()}
        xn = rms_norm(h, p["input_layernorm"], eps)
        q = _mm(xn, p["q_proj"]).reshape(B, T, nq, hd).transpose(1, 2)
        k = _mm(xn, p["k_proj"]).reshape(B, T, nkv, hd).transpose(1, 2)
        v = _mm(xn, p["v_proj"]).reshape(B, T, nkv, hd).transpose(1, 2)
        scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
        if key_mask is not None:
            scores = torch.where(key_mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.einsum("bhst,bhtd->bhsd", probs, v).transpose(1, 2).reshape(B, T, nq * hd)
        h = h + _mm(attn, p["o_proj"]) * p["self_attn_layer_scale"]
        xn = rms_norm(h, p["post_attention_layernorm"], eps)
        gated = silu(_mm(xn, p["gate_proj"])) * _mm(xn, p["up_proj"])
        h = h + _mm(gated, p["down_proj"]) * p["mlp_layer_scale"]
    h = rms_norm(h, params["norm"], eps)
    return _mm(h, params["output_proj"]["w"]) + params["output_proj"]["b"]


def convnext_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """ConvNeXt block. x: [B, T, C]."""
    dim = x.shape[-1]
    h = causal_conv1d(x, p["dwconv"]["w"], p["dwconv"]["b"], groups=dim)
    h = layer_norm(h, p["norm"]["w"], p["norm"]["b"], 1e-6)
    h = _mm(h, p["pwconv1"]["w"]) + p["pwconv1"]["b"]
    h = torch.nn.functional.gelu(h.float()).to(h.dtype)
    h = _mm(h, p["pwconv2"]["w"]) + p["pwconv2"]["b"]
    return x + p["gamma"] * h


def _residual_unit(p: Params, x: torch.Tensor, dilation: int) -> torch.Tensor:
    h = snake_beta(x, p["act1"]["alpha"], p["act1"]["beta"])
    h = causal_conv1d(h, p["conv1"]["w"], p["conv1"]["b"], dilation=dilation)
    h = snake_beta(h, p["act2"]["alpha"], p["act2"]["beta"])
    h = causal_conv1d(h, p["conv2"]["w"], p["conv2"]["b"])
    return x + h


def main_decoder(params: Params, cfg: TokenizerDecoderConfig, x: torch.Tensor) -> torch.Tensor:
    """480x upsampling stack. x: [B, T, latent] -> [B, T*480, 1]."""
    h = causal_conv1d(x, params["init_conv"]["w"], params["init_conv"]["b"])
    for block, rate in zip(params["blocks"], cfg.upsample_rates):
        h = snake_beta(h, block["snake"]["alpha"], block["snake"]["beta"])
        h = causal_conv1d_transpose(h, block["upsample"]["w"], block["upsample"]["b"], stride=rate)
        for name, d in (("res1", 1), ("res2", 3), ("res3", 9)):
            h = _residual_unit(block[name], h, d)
    h = snake_beta(h, params["out_snake"]["alpha"], params["out_snake"]["beta"])
    return causal_conv1d(h, params["out_conv"]["w"], params["out_conv"]["b"])


def decode_latents(
    params: Params, cfg: TokenizerDecoderConfig, codes: torch.Tensor, frames=None
) -> torch.Tensor:
    """codes [B, T, 16] -> waveform [B, T*1920]."""
    h = rvq_decode(params, cfg, codes)
    h = causal_conv1d(h, params["pre_conv"]["w"], params["pre_conv"]["b"])
    h = pre_transformer(params["pre_transformer"], cfg, h, frames)
    for stage, ratio in zip(params["upsample"], cfg.upsampling_ratios):
        h = causal_conv1d_transpose(h, stage["conv"]["w"], stage["conv"]["b"], stride=ratio)
        h = convnext_block(stage["convnext"], h)
    wav = main_decoder(params["decoder"], cfg, h)
    return torch.clamp(wav[..., 0], -1.0, 1.0)


def decode_stages(params: Params, cfg: TokenizerDecoderConfig, codes: torch.Tensor) -> dict:
    """Each stage's output of ``decode_latents`` on codes [B, T, 16]
    (quantizer, pre_conv, pre_transformer, each upsample stage, the main
    decoder, the clipped audio), for golden-value diffs
    (tools/parity_harness.py); not a serving path."""
    out = {}
    with exact_f32():
        h = out["quantizer"] = rvq_decode(params, cfg, codes)
        h = out["pre_conv"] = causal_conv1d(h, params["pre_conv"]["w"], params["pre_conv"]["b"])
        h = out["pre_transformer"] = pre_transformer(params["pre_transformer"], cfg, h)
        for i, (stage, ratio) in enumerate(zip(params["upsample"], cfg.upsampling_ratios)):
            h = causal_conv1d_transpose(h, stage["conv"]["w"], stage["conv"]["b"], stride=ratio)
            h = out[f"upsample{i}"] = convnext_block(stage["convnext"], h)
        wav = out["decoder"] = main_decoder(params["decoder"], cfg, h)
    out["audio"] = torch.clamp(wav[..., 0], -1.0, 1.0)
    return out


def decode(params: Params, cfg: TokenizerDecoderConfig, codes: torch.Tensor, frames=None):
    """codes [B, T, 16] -> (audio [B, T*1920], lengths [B]).

    ``frames`` (an int, or [B] per row) marks the valid frames of a codes
    buffer right-padded to a bucket; output past ``frames * 1920`` samples
    must be trimmed. Valid length = (#frames with first-codebook code > 0)
    * 1920.
    """
    with exact_f32():  # the f32 vocoder's numbers as the reference's
        wav = decode_latents(params, cfg, codes, frames)
    B, T = codes.shape[:2]
    limit = T if frames is None else _frames_per_row(frames, B, codes.device)[:, None]
    in_range = torch.arange(T, device=codes.device)[None] < limit
    valid = ((codes[..., 0] > 0) & in_range).sum(dim=1).to(torch.int32)
    return wav, valid * cfg.total_upsample
