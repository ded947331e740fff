"""Synthetic weights: numpy builders (port of qwen3tts_tpu/utils/host_init.py)
and a ``torch.Generator`` vocoder initializer.

The talker and code-predictor builders are crc32-seeded numpy and produce
arrays byte-identical to the JAX package's, so both packages compute with the
same weights (tests/test_torch_package.py pins this). ``init_vocoder_params``
is the counterpart of ``vocoder.init_vocoder_params``: same tree, shapes and
distributions, drawn from a torch generator on the target device (it does not
reproduce ``jax.random``'s values; tests move JAX vocoder weights across with
utils/convert.py instead). ``init_encoder_params`` and
``init_speaker_encoder_params`` are the voice-clone encoders' counterparts
(``encoder.init_encoder_params``, ``speaker_encoder.
init_speaker_encoder_params``), built the same way.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..config import (
    CodePredictorConfig, SpeakerEncoderConfig, TalkerConfig, TokenizerDecoderConfig,
    TokenizerEncoderConfig,
)
from ..ops.quant import PackedLinear, pack_quantized, packed_from_numpy


def _rs(seed: int, tag: str) -> np.random.Generator:
    # zlib.crc32, not hash(): Python string hashing is salted per process
    return np.random.default_rng(zlib.crc32(f"{seed}:{tag}".encode()))


def _mat(seed, tag, *shape, scale=None):
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[-1])
    return _rs(seed, tag).standard_normal(shape, dtype=np.float32) * np.float32(scale)


def _layer_stack(seed, tag, L, d_in, d_out):
    scale = np.float32(1.0 / np.sqrt(d_in))
    return _rs(seed, tag).standard_normal((L, d_in, d_out), dtype=np.float32) * scale


def host_init_talker_params(seed: int, cfg: TalkerConfig) -> dict:
    """Numpy f32 talker tree (move it with :func:`to_device`)."""
    L, h, hd = cfg.num_hidden_layers, cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    inter = max(cfg.layer_intermediate_size(i) for i in range(L))
    layers = {
        "q_proj": _layer_stack(seed, "q", L, h, nq * hd),
        "k_proj": _layer_stack(seed, "k", L, h, nkv * hd),
        "v_proj": _layer_stack(seed, "v", L, h, nkv * hd),
        "o_proj": _layer_stack(seed, "o", L, nq * hd, h),
        "q_norm": np.ones((L, hd), np.float32),
        "k_norm": np.ones((L, hd), np.float32),
        "gate_proj": _layer_stack(seed, "g", L, h, inter),
        "up_proj": _layer_stack(seed, "u", L, h, inter),
        "down_proj": _layer_stack(seed, "d", L, inter, h),
        "input_layernorm": np.ones((L, h), np.float32),
        "post_attention_layernorm": np.ones((L, h), np.float32),
    }
    return {
        "codec_embedding": _mat(seed, "ce", cfg.vocab_size, h, scale=0.02),
        "text_embedding": _mat(seed, "te", cfg.text_vocab_size, cfg.text_hidden_size, scale=0.02),
        "layers": layers,
        "norm": np.ones((h,), np.float32),
        "text_projection": {
            "fc1": {
                "w": _mat(seed, "fc1", cfg.text_hidden_size, cfg.text_hidden_size),
                "b": np.zeros((cfg.text_hidden_size,), np.float32),
            },
            "fc2": {
                "w": _mat(seed, "fc2", cfg.text_hidden_size, h),
                "b": np.zeros((h,), np.float32),
            },
        },
        "codec_head": _mat(seed, "head", h, cfg.vocab_size),
    }


def host_init_cp_params(seed: int, cfg: CodePredictorConfig, talker_hidden_size: int) -> dict:
    """Numpy f32 code-predictor tree (move it with :func:`to_device`)."""
    L, h, hd = cfg.num_hidden_layers, cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    n = cfg.num_code_groups - 1
    layers = {
        "q_proj": _layer_stack(seed, "cq", L, h, nq * hd),
        "k_proj": _layer_stack(seed, "ck", L, h, nkv * hd),
        "v_proj": _layer_stack(seed, "cv", L, h, nkv * hd),
        "o_proj": _layer_stack(seed, "co", L, nq * hd, h),
        "q_norm": np.ones((L, hd), np.float32),
        "k_norm": np.ones((L, hd), np.float32),
        "gate_proj": _layer_stack(seed, "cg", L, h, cfg.intermediate_size),
        "up_proj": _layer_stack(seed, "cu", L, h, cfg.intermediate_size),
        "down_proj": _layer_stack(seed, "cd", L, cfg.intermediate_size, h),
        "input_layernorm": np.ones((L, h), np.float32),
        "post_attention_layernorm": np.ones((L, h), np.float32),
    }
    params = {
        "codec_embedding": _layer_stack(seed, "cce", n, cfg.vocab_size, talker_hidden_size),
        "layers": layers,
        "norm": np.ones((h,), np.float32),
        "lm_head": _layer_stack(seed, "clm", n, h, cfg.vocab_size),
    }
    if cfg.hidden_size != talker_hidden_size:
        params["small_to_mtp_projection"] = {
            "w": _mat(seed, "mtp", talker_hidden_size, cfg.hidden_size),
            "b": np.zeros((cfg.hidden_size,), np.float32),
        }
    return params


def to_device(params, dtype: torch.dtype, device):
    """Move a numpy tree onto ``device``, casting float arrays to ``dtype``
    (round to nearest even, as ``ml_dtypes`` casts). ``PackedLinear``
    leaves move with their int32 words and f32 scales and biases unchanged."""
    if isinstance(params, dict):
        return {k: to_device(v, dtype, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(to_device(v, dtype, device) for v in params)
    if isinstance(params, PackedLinear):
        return params.to(device)
    t = torch.from_numpy(np.ascontiguousarray(params)).to(device)
    return t.to(dtype) if t.is_floating_point() else t


def pack_linear_params(params: dict, names=None, bits: int = 4, group: int = 64) -> dict:
    """Replace the stacked per-layer linear weights of a numpy tree ([L, in,
    out]) with stacked PackedLinears, and pack codec_head / lm_head too.
    Before :func:`to_device`; the packed bytes equal the JAX package's."""
    out = dict(params)
    layer_names = names or (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"
    )

    def pack(w):  # [in, out] -> MLX [out, in/pw]
        return pack_quantized(np.asarray(w, np.float32).T, bits=bits, group=group)

    def pack_stacked(w):
        qs, ss, bs = zip(*(pack(w[i]) for i in range(w.shape[0])))
        return packed_from_numpy(np.stack(qs), np.stack(ss), np.stack(bs), bits, group)

    layers = dict(out["layers"])
    for name in layer_names:
        layers[name] = pack_stacked(layers[name])
    out["layers"] = layers
    if "codec_head" in out:
        out["codec_head"] = packed_from_numpy(*pack(out["codec_head"]), bits, group)
    if "lm_head" in out:
        out["lm_head"] = pack_stacked(out["lm_head"])
    return out


# ---------------------------------------------------------------------------
# Vocoder (counterpart of qwen3tts_tpu/models/vocoder.py::init_vocoder_params)
# ---------------------------------------------------------------------------


class _Init:
    """Normal draws from one explicit generator on one device."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def normal(self, *shape, scale: float = 1.0) -> torch.Tensor:
        x = torch.randn(shape, generator=self.g, device=self.device, dtype=torch.float32)
        return (x * scale).to(self.dtype)

    def full(self, *shape, value: float = 0.0) -> torch.Tensor:
        return torch.full(shape, value, device=self.device, dtype=self.dtype)

    def conv(self, k, c_in, c_out, groups=1, bias=True):
        p = {"w": self.normal(k, c_in // groups, c_out, scale=1.0 / np.sqrt(c_in * k / groups))}
        if bias:
            p["b"] = self.full(c_out)
        return p

    def convt(self, k, c_in, c_out):
        return {"w": self.normal(k, c_out, c_in, scale=1.0 / np.sqrt(c_in * k)), "b": self.full(c_out)}

    def lin(self, d_in, d_out, bias=True):
        p = {"w": self.normal(d_in, d_out, scale=1.0 / np.sqrt(d_in))}
        if bias:
            p["b"] = self.full(d_out)
        return p

    def snake(self, c):
        return {"alpha": self.full(c), "beta": self.full(c)}


def init_vocoder_params(
    generator: torch.Generator, cfg: TokenizerDecoderConfig, dtype=torch.float32, device=None
) -> dict:
    """Random vocoder parameters at the configured shapes, made on ``device``."""
    r = _Init(generator, device, dtype)
    cb, inner = cfg.codebook_dim, cfg.codebook_dim // 2
    n_ac = cfg.num_quantizers - cfg.num_semantic_quantizers
    L, h = cfg.num_hidden_layers, cfg.hidden_size
    hd, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads

    def stack(d_in, d_out):
        return r.normal(L, d_in, d_out, scale=1.0 / np.sqrt(d_in))

    pre_transformer = {
        "input_proj": r.lin(cfg.latent_dim, h),
        "output_proj": r.lin(h, cfg.latent_dim),
        "layers": {
            "q_proj": stack(h, nq * hd),
            "k_proj": stack(h, nkv * hd),
            "v_proj": stack(h, nkv * hd),
            "o_proj": stack(nq * hd, h),
            "gate_proj": stack(h, cfg.intermediate_size),
            "up_proj": stack(h, cfg.intermediate_size),
            "down_proj": stack(cfg.intermediate_size, h),
            "input_layernorm": r.full(L, h, value=1.0),
            "post_attention_layernorm": r.full(L, h, value=1.0),
            "self_attn_layer_scale": r.full(L, h, value=cfg.layer_scale_initial_scale),
            "mlp_layer_scale": r.full(L, h, value=cfg.layer_scale_initial_scale),
        },
        "norm": r.full(h, value=1.0),
    }
    dd = cfg.decoder_dim
    blocks = []
    for i, rate in enumerate(cfg.upsample_rates):
        c_in, c_out = dd // (1 << i), dd // (1 << (i + 1))
        block = {"snake": r.snake(c_in), "upsample": r.convt(rate * 2, c_in, c_out)}
        for j in range(3):
            block[f"res{j + 1}"] = {
                "act1": r.snake(c_out),
                "conv1": r.conv(7, c_out, c_out),
                "act2": r.snake(c_out),
                "conv2": r.conv(1, c_out, c_out),
            }
        blocks.append(block)
    out_dim = dd // (1 << len(cfg.upsample_rates))
    ld = cfg.latent_dim
    return {
        "quantizer": {
            "rvq_first": {
                "codebooks": r.normal(
                    cfg.num_semantic_quantizers, cfg.semantic_codebook_size, inner, scale=8.0
                ),
                "output_proj": r.lin(inner, cb, bias=False),
            },
            "rvq_rest": {
                "codebooks": r.normal(n_ac, cfg.codebook_size, inner, scale=2.0),
                "output_proj": r.lin(inner, cb, bias=False),
            },
        },
        "pre_conv": r.conv(3, cb, ld),
        "pre_transformer": pre_transformer,
        "upsample": [
            {
                "conv": r.convt(ratio, ld, ld),
                "convnext": {
                    "dwconv": r.conv(7, ld, ld, groups=ld),
                    "norm": {"w": r.full(ld, value=1.0), "b": r.full(ld)},
                    "pwconv1": r.lin(ld, ld * 4),
                    "pwconv2": r.lin(ld * 4, ld),
                    "gamma": r.full(ld, value=1e-6),
                },
            }
            for ratio in cfg.upsampling_ratios
        ],
        "decoder": {
            "init_conv": r.conv(7, ld, dd),
            "blocks": blocks,
            "out_snake": r.snake(out_dim),
            "out_conv": r.conv(7, out_dim, 1),
        },
    }


# ---------------------------------------------------------------------------
# Voice-clone encoders (counterparts of qwen3tts_tpu/models/encoder.py::
# init_encoder_params and speaker_encoder.py::init_speaker_encoder_params)
# ---------------------------------------------------------------------------


def init_encoder_params(
    generator: torch.Generator, cfg: TokenizerEncoderConfig, dtype=torch.float32, device=None
) -> dict:
    """Random speech-tokenizer encoder parameters at the configured shapes,
    made on ``device`` (the codebooks' sums and usages f32)."""
    r = _Init(generator, device, dtype)
    nf, d = cfg.num_filters, cfg.hidden_size
    layers = []
    mult = 1
    for ratio in reversed(cfg.upsampling_ratios):
        dim = mult * nf
        hidden = dim // cfg.compress
        layers.append({
            "residuals": [
                {"block": [r.conv(cfg.residual_kernel_size, dim, hidden), r.conv(1, hidden, dim)]}
                for _ in range(cfg.num_residual_layers)
            ],
            "downsample": r.conv(ratio * 2, dim, dim * 2),
        })
        mult *= 2
    L = cfg.num_hidden_layers
    hd = d // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * hd

    def stack(d_in, d_out):
        return r.normal(L, d_in, d_out, scale=1.0 / np.sqrt(d_in))

    transformer = {
        "layers": {
            "q_proj": stack(d, d),
            "k_proj": stack(d, kv),
            "v_proj": stack(d, kv),
            "o_proj": stack(d, d),
            "norm1": {"w": r.full(L, d, value=1.0), "b": r.full(L, d)},
            "norm2": {"w": r.full(L, d, value=1.0), "b": r.full(L, d)},
            "linear1": stack(d, cfg.intermediate_size),
            "linear2": stack(cfg.intermediate_size, d),
            "layer_scale_1": r.full(L, d, value=cfg.layer_scale_initial_scale),
            "layer_scale_2": r.full(L, d, value=cfg.layer_scale_initial_scale),
        }
    }
    f32 = _Init(generator, device, torch.float32)

    def rvq(nq):
        return {
            "input_proj": r.normal(d, cfg.codebook_dim, scale=1.0 / np.sqrt(d)),
            "output_proj": r.normal(cfg.codebook_dim, d, scale=1.0 / np.sqrt(cfg.codebook_dim)),
            "layers": [
                {"embedding_sum": f32.normal(cfg.codebook_size, cfg.codebook_dim),
                 "cluster_usage": f32.full(cfg.codebook_size, value=1.0)}
                for _ in range(nq)
            ],
        }

    ratio_prod = int(np.prod(cfg.upsampling_ratios))
    stride = int((cfg.sampling_rate / ratio_prod) / cfg.frame_rate)
    return {
        "seanet": {
            "init_conv": r.conv(cfg.kernel_size, cfg.audio_channels, nf),
            "layers": layers,
            "final_conv": r.conv(cfg.last_kernel_size, mult * nf, d),
        },
        "transformer": transformer,
        "downsample": {"w": r.conv(2 * stride, d, d, bias=False)["w"]},
        "quantizer": {"rvq_first": rvq(1), "rvq_rest": rvq(cfg.num_quantizers - 1)},
    }


def init_speaker_encoder_params(
    generator: torch.Generator, cfg: SpeakerEncoderConfig, dtype=torch.float32, device=None
) -> dict:
    """Random ECAPA-TDNN speaker encoder parameters at the configured
    shapes, made on ``device``."""
    r = _Init(generator, device, dtype)
    ch, ksz, scale = cfg.enc_channels, cfg.enc_kernel_sizes, cfg.enc_res2net_scale

    def se_res2net(c_in, c_out, k):
        return {
            "tdnn1": r.conv(1, c_in, c_out),
            "res2net_block": {
                "blocks": [r.conv(k, c_out // scale, c_out // scale) for _ in range(scale - 1)]
            },
            "tdnn2": r.conv(1, c_out, c_out),
            "se_block": {
                "conv1": r.conv(1, c_out, cfg.enc_se_channels),
                "conv2": r.conv(1, cfg.enc_se_channels, c_out),
            },
        }

    return {
        "blocks": [
            r.conv(ksz[0], cfg.mel_dim, ch[0]),
            se_res2net(ch[0], ch[1], ksz[1]),
            se_res2net(ch[1], ch[2], ksz[2]),
            se_res2net(ch[2], ch[3], ksz[3]),
        ],
        "mfa": r.conv(ksz[4], ch[1] + ch[2] + ch[3], ch[4]),
        "asp": {
            "tdnn": r.conv(1, ch[4] * 3, cfg.enc_attention_channels),
            "conv": r.conv(1, cfg.enc_attention_channels, ch[4]),
        },
        "fc": r.conv(1, ch[4] * 2, cfg.enc_dim),
    }
