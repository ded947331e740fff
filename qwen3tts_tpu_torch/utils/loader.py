"""Checkpoint loading: HF safetensors -> the port's parameter trees
(port of qwen3tts_tpu/utils/loader.py).

The safetensors reader is numpy only (no ``safetensors`` package, no JAX):
an 8-byte little-endian header length, a JSON header, then raw buffers read
through ``np.memmap``. BF16 tensors widen exactly to float32 on read, so the
converters below stay numpy like the JAX package's, and every tree leaf is
made by one cast to the target dtype at the end.

Layouts, explicit per tensor class:

  torch Linear          [O, I]     -> [I, O]            (y = x @ w)
  torch Conv1d          [O, I, W]  -> [W, I, O]
  torch ConvTranspose1d [I, O, W]  -> [W, O, I]
  VQ codebooks: embedding = embedding_sum / clamp(cluster_usage, eps)
  MLX affine int4/int8 groups ({weight, scales, biases}) are dequantized at
  load, or kept packed (``PackedLinear``, [O, I/pw]) with ``keep_packed``.

The L decoder layers arrive as ``layers.{i}.*`` and are stacked on a leading
axis. Trees are built on the CPU; ``Checkpoint`` moves them to its device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from ..config import (
    CodePredictorConfig,
    ModelConfig,
    QuantizationConfig,
    SpeakerEncoderConfig,
    TalkerConfig,
    TokenizerConfig,
    TokenizerDecoderConfig,
    TokenizerEncoderConfig,
)
from ..ops.quant import PackedLinear, packed_from_numpy

Params = dict[str, Any]

# ---------------------------------------------------------------------------
# safetensors reading
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """One .safetensors file as numpy arrays (views of a read-only memmap;
    BF16 widened to float32, which is exact)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    if not header:
        return {}
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        if info["dtype"] == "BF16":
            arr = (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = raw.view(_ST_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
        out[name] = arr.reshape(info["shape"])
    return out


_ST_NAMES = {np.dtype(t).name: name for name, t in _ST_DTYPES.items()}


def write_safetensors(path: str, tensors: dict) -> None:
    """Write numpy arrays or torch tensors as one .safetensors file (an
    8-byte little-endian header length, a JSON header padded to 8 bytes,
    then the raw buffers): the inverse of :func:`read_safetensors`. A torch
    bf16 tensor is written as "BF16", the dtype Qwen publishes its
    checkpoints in (through a 16-bit view: numpy has no bf16)."""
    arrays, header, offset = {}, {}, 0
    for k, v in sorted(tensors.items()):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().contiguous()
            bf16 = v.dtype == torch.bfloat16
            a = (v.view(torch.int16) if bf16 else v).numpy()
        else:
            bf16, a = False, np.ascontiguousarray(v)
        header[k] = {"dtype": "BF16" if bf16 else _ST_NAMES[a.dtype.name],
                     "shape": list(a.shape), "data_offsets": [offset, offset + a.nbytes]}
        arrays[k] = a
        offset += a.nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for a in arrays.values():
            f.write(memoryview(a.reshape(-1).view(np.uint8)))


def load_safetensors_dir(path: str) -> dict[str, np.ndarray]:
    """Merge every *.safetensors in a directory into one flat dict."""
    tensors: dict[str, np.ndarray] = {}
    for f in sorted(x for x in os.listdir(path) if x.endswith(".safetensors")):
        tensors.update(read_safetensors(os.path.join(path, f)))
    return tensors


# ---------------------------------------------------------------------------
# dtype / layout helpers
# ---------------------------------------------------------------------------


def _to_dtype(x: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of ``dtype`` from an array (copied where it is a
    read-only view of the file). Floats round to nearest even."""
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    return t.to(dtype) if t.is_floating_point() else t


def _lin(w: np.ndarray, dtype, b: np.ndarray | None = None) -> Params:
    p = {"w": _to_dtype(w.T, dtype)}
    if b is not None:
        p["b"] = _to_dtype(b, dtype)
    return p


def _convw(w: np.ndarray, dtype) -> torch.Tensor:
    """torch Conv1d [O, I, W] -> [W, I, O]."""
    return _to_dtype(np.transpose(w, (2, 1, 0)), dtype)


def _convtw(w: np.ndarray, dtype) -> torch.Tensor:
    """torch ConvTranspose1d [I, O, W] -> [W, O, I]."""
    return _to_dtype(np.transpose(w, (2, 1, 0)), dtype)


def dequantize_mlx(
    weight: np.ndarray, scales: np.ndarray, biases: np.ndarray, bits: int, group: int
) -> np.ndarray:
    """Unpack MLX affine group quantization to float32 [O, I].

    weight: uint32 [O, I/(32/bits)] little-endian packed; scales/biases
    [O, I/group]. w[o, i] = scales[o, i//g] * q[o, i] + biases[o, i//g].
    """
    per_word = 32 // bits
    mask = (1 << bits) - 1
    O, packed = weight.shape
    I = packed * per_word
    shifts = (np.arange(per_word, dtype=np.uint32) * bits)[None, None]
    q = (weight[..., None] >> shifts) & mask  # [O, I/per_word, per_word]
    q = q.reshape(O, I).astype(np.float32)
    s = np.repeat(scales.astype(np.float32), group, axis=1)
    b = np.repeat(biases.astype(np.float32), group, axis=1)
    return q * s[:, :I] + b[:, :I]


class _W:
    """Weight dict view with quantization-aware fetch and usage tracking."""

    def __init__(
        self,
        tensors: Mapping[str, np.ndarray],
        quant: QuantizationConfig | None,
        keep_packed: bool = False,
    ):
        self.t = dict(tensors)
        self.quant = quant
        # keep int4/int8 weights packed (PackedLinear) for the K4 decode path
        # instead of widening them at load
        self.keep_packed = keep_packed
        self.used: set[str] = set()

    def is_packed(self, key: str) -> bool:
        return key + ".scales" in self.t

    def packed(self, key: str) -> PackedLinear:
        """A PackedLinear of a quantized tensor (MLX layout kept)."""
        if self.quant is None:
            raise ValueError(f"{key}: quantized but no quantization config")
        for suf in ("", ".scales", ".biases"):
            self.used.add(key + suf)
        return packed_from_numpy(self.t[key], self.t[key + ".scales"], self.t[key + ".biases"],
                                 self.quant.bits, self.quant.group_size)

    def linear(self, key: str, dtype):
        """Linear weight: PackedLinear (if quantized and keep_packed) or a
        dense [in, out] tensor."""
        if self.keep_packed and self.is_packed(key):
            return self.packed(key)
        return _to_dtype(self.get(key).T, dtype)

    def embedding(self, key: str, dtype):
        """Embedding table: PackedLinear rows or dense [vocab, dim]."""
        if self.keep_packed and self.is_packed(key):
            return self.packed(key)
        return _to_dtype(self.get(key), dtype)

    def has(self, key: str) -> bool:
        return key in self.t or key + ".scales" in self.t

    def get(self, key: str) -> np.ndarray:
        """Fetch a tensor, dequantizing MLX affine groups."""
        if key + ".scales" in self.t:
            if self.quant is None:
                raise ValueError(f"{key}: quantized but no quantization config")
            for suf in ("", ".scales", ".biases"):
                self.used.add(key + suf)
            return dequantize_mlx(
                self.t[key], self.t[key + ".scales"], self.t[key + ".biases"],
                self.quant.bits, self.quant.group_size,
            )
        if key not in self.t:
            raise KeyError(key)
        self.used.add(key)
        return self.t[key]

    def opt(self, key: str) -> np.ndarray | None:
        return self.get(key) if self.has(key) else None


def _stack_packed(items: list[PackedLinear]) -> PackedLinear:
    """Stack per-layer PackedLinears on a new leading axis, zero-padding
    ragged output/input widths (pruned MLP widths). Padded regions have
    q = 0, scale = 0, bias = 0, which dequantize to exactly 0."""

    def pad_to(a: torch.Tensor, shape) -> torch.Tensor:
        pads = []
        for s, t in reversed(list(zip(a.shape, shape))):
            pads += [0, t - s]
        return torch.nn.functional.pad(a, pads)

    def stack(leaves):
        shape = tuple(max(x.shape[d] for x in leaves) for d in range(2))
        return torch.stack([pad_to(x, shape) for x in leaves])

    return PackedLinear(
        stack([p.q for p in items]), stack([p.scales for p in items]),
        stack([p.biases for p in items]), items[0].bits, items[0].group,
    )


def _stack_layers(w: _W, prefix: str, n: int, dtype) -> Params:
    """Stack ``{prefix}.{i}.*`` transformer-layer weights on a leading axis."""
    names = {
        "q_proj": "self_attn.q_proj.weight",
        "k_proj": "self_attn.k_proj.weight",
        "v_proj": "self_attn.v_proj.weight",
        "o_proj": "self_attn.o_proj.weight",
        "gate_proj": "mlp.gate_proj.weight",
        "up_proj": "mlp.up_proj.weight",
        "down_proj": "mlp.down_proj.weight",
    }
    out: Params = {}
    for ours, theirs in names.items():
        keys = [f"{prefix}.{i}.{theirs}" for i in range(n)]
        if w.keep_packed and w.is_packed(keys[0]):
            out[ours] = _stack_packed([w.packed(k) for k in keys])
            continue
        mats = [w.get(k).T for k in keys]
        axis = 1 if ours != "down_proj" else 0
        widths = {m.shape[axis] for m in mats}
        if ours in ("gate_proj", "up_proj", "down_proj") and len(widths) > 1:
            # ragged per-layer MLP widths (pruned checkpoints): zero-pad
            padded = []
            for m in mats:
                pad = [(0, 0), (0, 0)]
                pad[axis] = (0, max(widths) - m.shape[axis])
                padded.append(np.pad(m, pad))
            mats = padded
        out[ours] = _to_dtype(np.stack(mats), dtype)
    for ours, theirs in (
        ("q_norm", "self_attn.q_norm.weight"),
        ("k_norm", "self_attn.k_norm.weight"),
        ("input_layernorm", "input_layernorm.weight"),
        ("post_attention_layernorm", "post_attention_layernorm.weight"),
    ):
        out[ours] = _to_dtype(np.stack([w.get(f"{prefix}.{i}.{theirs}") for i in range(n)]), dtype)
    return out


# ---------------------------------------------------------------------------
# Talker + CodePredictor
# ---------------------------------------------------------------------------


def load_talker(w: _W, cfg: TalkerConfig, dtype=torch.bfloat16) -> Params:
    p = "talker.model"

    def lin_b(key):
        out = {"w": w.linear(f"{key}.weight", dtype)}
        b = w.opt(f"{key}.bias")
        if b is not None:
            out["b"] = _to_dtype(b, dtype)
        return out

    params: Params = {
        "codec_embedding": w.embedding(f"{p}.codec_embedding.weight", dtype),
        "text_embedding": w.embedding(f"{p}.text_embedding.weight", dtype),
        "layers": _stack_layers(w, f"{p}.layers", cfg.num_hidden_layers, dtype),
        "norm": _to_dtype(w.get(f"{p}.norm.weight"), dtype),
        "text_projection": {
            "fc1": lin_b("talker.text_projection.linear_fc1"),
            "fc2": lin_b("talker.text_projection.linear_fc2"),
        },
        "codec_head": w.linear("talker.codec_head.weight", dtype),
    }
    tmap = w.opt(f"{p}.text_token_map")
    if tmap is not None:
        # int32 map original id -> compact row
        params["text_token_map"] = torch.from_numpy(np.asarray(tmap, dtype=np.int32))
    return params


def load_code_predictor(w: _W, cfg: CodePredictorConfig, dtype=torch.bfloat16) -> Params:
    p = "talker.code_predictor"
    n = cfg.num_code_groups - 1

    def stacked(items):
        if isinstance(items[0], PackedLinear):
            return _stack_packed(items)
        return torch.stack(items)

    params: Params = {
        "codec_embedding": stacked(
            [w.embedding(f"{p}.model.codec_embedding.{i}.weight", dtype) for i in range(n)]
        ),
        "layers": _stack_layers(w, f"{p}.model.layers", cfg.num_hidden_layers, dtype),
        "norm": _to_dtype(w.get(f"{p}.model.norm.weight"), dtype),
        "lm_head": stacked([w.linear(f"{p}.lm_head.{i}.weight", dtype) for i in range(n)]),
    }
    if w.has(f"{p}.small_to_mtp_projection.weight"):
        out = {"w": w.linear(f"{p}.small_to_mtp_projection.weight", dtype)}
        b = w.opt(f"{p}.small_to_mtp_projection.bias")
        if b is not None:
            out["b"] = _to_dtype(b, dtype)
        params["small_to_mtp_projection"] = out
    return params


# ---------------------------------------------------------------------------
# Speech tokenizer: vocoder (decoder)
# ---------------------------------------------------------------------------


def _codebook_embed(w: _W, base: str) -> np.ndarray:
    """Decoder codebooks: embedding_sum / clamp(cluster_usage, 1e-5)."""
    s = w.get(f"{base}._codebook.embedding_sum")
    u = w.get(f"{base}._codebook.cluster_usage")
    return s / np.clip(u[:, None], 1e-5, None)


def load_vocoder(w: _W, cfg: TokenizerDecoderConfig, dtype=torch.float32) -> Params:
    def conv(key):
        return {"w": _convw(w.get(f"{key}.weight"), dtype), "b": _to_dtype(w.get(f"{key}.bias"), dtype)}

    def convt(key):
        return {"w": _convtw(w.get(f"{key}.weight"), dtype), "b": _to_dtype(w.get(f"{key}.bias"), dtype)}

    def snake(key):
        return {
            "alpha": _to_dtype(w.get(f"{key}.alpha").reshape(-1), dtype),
            "beta": _to_dtype(w.get(f"{key}.beta").reshape(-1), dtype),
        }

    def rvq(base, nq):
        return {
            "codebooks": _to_dtype(
                np.stack([_codebook_embed(w, f"{base}.vq.layers.{i}") for i in range(nq)]), dtype
            ),
            # 1x1 conv [O, I, 1] -> matmul [I, O]
            "output_proj": {"w": _to_dtype(w.get(f"{base}.output_proj.weight")[:, :, 0].T, dtype)},
        }

    L = cfg.num_hidden_layers
    pt = "decoder.pre_transformer"

    def pt_stack(name):
        return _to_dtype(np.stack([w.get(f"{pt}.layers.{i}.{name}") for i in range(L)]), dtype)

    def pt_stack_lin(name):
        return _to_dtype(np.stack([w.get(f"{pt}.layers.{i}.{name}").T for i in range(L)]), dtype)

    pre_transformer = {
        "input_proj": _lin(w.get(f"{pt}.input_proj.weight"), dtype, w.opt(f"{pt}.input_proj.bias")),
        "output_proj": _lin(w.get(f"{pt}.output_proj.weight"), dtype, w.opt(f"{pt}.output_proj.bias")),
        "layers": {
            "q_proj": pt_stack_lin("self_attn.q_proj.weight"),
            "k_proj": pt_stack_lin("self_attn.k_proj.weight"),
            "v_proj": pt_stack_lin("self_attn.v_proj.weight"),
            "o_proj": pt_stack_lin("self_attn.o_proj.weight"),
            "gate_proj": pt_stack_lin("mlp.gate_proj.weight"),
            "up_proj": pt_stack_lin("mlp.up_proj.weight"),
            "down_proj": pt_stack_lin("mlp.down_proj.weight"),
            "input_layernorm": pt_stack("input_layernorm.weight"),
            "post_attention_layernorm": pt_stack("post_attention_layernorm.weight"),
            "self_attn_layer_scale": pt_stack("self_attn_layer_scale.scale"),
            "mlp_layer_scale": pt_stack("mlp_layer_scale.scale"),
        },
        "norm": _to_dtype(w.get(f"{pt}.norm.weight"), dtype),
    }

    upsample = []
    for i in range(len(cfg.upsampling_ratios)):
        cn = f"decoder.upsample.{i}.1"
        upsample.append({
            "conv": convt(f"decoder.upsample.{i}.0.conv"),
            "convnext": {
                "dwconv": conv(f"{cn}.dwconv.conv"),
                "norm": {
                    "w": _to_dtype(w.get(f"{cn}.norm.weight"), dtype),
                    "b": _to_dtype(w.get(f"{cn}.norm.bias"), dtype),
                },
                "pwconv1": _lin(w.get(f"{cn}.pwconv1.weight"), dtype, w.get(f"{cn}.pwconv1.bias")),
                "pwconv2": _lin(w.get(f"{cn}.pwconv2.weight"), dtype, w.get(f"{cn}.pwconv2.bias")),
                "gamma": _to_dtype(w.get(f"{cn}.gamma"), dtype),
            },
        })

    # main decoder: numeric indices 0..n+2; block.0 = snake, block.1 =
    # upsample, block.2..4 = residual units
    def res_unit(base):
        return {
            "act1": snake(f"{base}.act1"),
            "conv1": conv(f"{base}.conv1.conv"),
            "act2": snake(f"{base}.act2"),
            "conv2": conv(f"{base}.conv2.conv"),
        }

    blocks = []
    for i in range(len(cfg.upsample_rates)):
        b = f"decoder.decoder.{i + 1}"
        blocks.append({
            "snake": snake(f"{b}.block.0"),
            "upsample": convt(f"{b}.block.1.conv"),
            "res1": res_unit(f"{b}.block.2"),
            "res2": res_unit(f"{b}.block.3"),
            "res3": res_unit(f"{b}.block.4"),
        })
    n_stages = len(cfg.upsample_rates)
    main = {
        "init_conv": conv("decoder.decoder.0.conv"),
        "blocks": blocks,
        "out_snake": snake(f"decoder.decoder.{n_stages + 1}"),
        "out_conv": conv(f"decoder.decoder.{n_stages + 2}.conv"),
    }

    return {
        "quantizer": {
            "rvq_first": rvq("decoder.quantizer.rvq_first", cfg.num_semantic_quantizers),
            "rvq_rest": rvq(
                "decoder.quantizer.rvq_rest", cfg.num_quantizers - cfg.num_semantic_quantizers
            ),
        },
        "pre_conv": conv("decoder.pre_conv.conv"),
        "pre_transformer": pre_transformer,
        "upsample": upsample,
        "decoder": main,
    }


# ---------------------------------------------------------------------------
# Voice-clone encoders: the speaker encoder (ECAPA-TDNN) and the speech
# tokenizer's encoder
# ---------------------------------------------------------------------------


def load_speaker_encoder(w: _W, cfg: SpeakerEncoderConfig, dtype=torch.float32) -> Params:
    p = "speaker_encoder"

    def conv(key):
        return {"w": _convw(w.get(f"{key}.weight"), dtype), "b": _to_dtype(w.get(f"{key}.bias"), dtype)}

    def se_res2net(i):
        blk = f"{p}.blocks.{i}"
        return {
            "tdnn1": conv(f"{blk}.tdnn1.conv"),
            "res2net_block": {
                "blocks": [conv(f"{blk}.res2net_block.blocks.{j}.conv")
                           for j in range(cfg.enc_res2net_scale - 1)]
            },
            "tdnn2": conv(f"{blk}.tdnn2.conv"),
            "se_block": {"conv1": conv(f"{blk}.se_block.conv1"), "conv2": conv(f"{blk}.se_block.conv2")},
        }

    return {
        "blocks": [conv(f"{p}.blocks.0.conv"), se_res2net(1), se_res2net(2), se_res2net(3)],
        "mfa": conv(f"{p}.mfa.conv"),
        "asp": {"tdnn": conv(f"{p}.asp.tdnn.conv"), "conv": conv(f"{p}.asp.conv")},
        "fc": conv(f"{p}.fc"),
    }


# SEANet numeric layer index -> (stage, role)
_SEANET_LAYOUT = {
    0: "init",
    1: (0, "res"), 3: (0, "down"),
    4: (1, "res"), 6: (1, "down"),
    7: (2, "res"), 9: (2, "down"),
    10: (3, "res"), 12: (3, "down"),
    14: "final",
}


def load_encoder(w: _W, cfg: TokenizerEncoderConfig, dtype=torch.float32) -> Params:
    def conv(key):
        p = {"w": _convw(w.get(f"{key}.weight"), dtype)}
        if w.has(f"{key}.bias"):
            p["b"] = _to_dtype(w.get(f"{key}.bias"), dtype)
        return p

    layers: list[Params] = [
        {"residuals": [{}], "downsample": None} for _ in range(len(cfg.upsampling_ratios))
    ]
    seanet: Params = {"layers": layers}
    for idx, role in _SEANET_LAYOUT.items():
        base = f"encoder.encoder.layers.{idx}"
        if role == "init":
            seanet["init_conv"] = conv(f"{base}.conv")
        elif role == "final":
            seanet["final_conv"] = conv(f"{base}.conv")
        elif role[1] == "res":  # the residual block's convs: block.1, block.3
            layers[role[0]]["residuals"][0] = {
                "block": [conv(f"{base}.block.1.conv"), conv(f"{base}.block.3.conv")]
            }
        else:
            layers[role[0]]["downsample"] = conv(f"{base}.conv")

    L = cfg.num_hidden_layers
    et = "encoder.encoder_transformer"

    def et_lin(name):
        return _to_dtype(np.stack([w.get(f"{et}.layers.{i}.{name}").T for i in range(L)]), dtype)

    def et_vec(name):
        return _to_dtype(np.stack([w.get(f"{et}.layers.{i}.{name}") for i in range(L)]), dtype)

    transformer = {
        "layers": {
            "q_proj": et_lin("self_attn.q_proj.weight"),
            "k_proj": et_lin("self_attn.k_proj.weight"),
            "v_proj": et_lin("self_attn.v_proj.weight"),
            "o_proj": et_lin("self_attn.o_proj.weight"),
            "norm1": {"w": et_vec("input_layernorm.weight"), "b": et_vec("input_layernorm.bias")},
            "norm2": {"w": et_vec("post_attention_layernorm.weight"),
                      "b": et_vec("post_attention_layernorm.bias")},
            "linear1": et_lin("mlp.fc1.weight"),
            "linear2": et_lin("mlp.fc2.weight"),
            "layer_scale_1": et_vec("self_attn_layer_scale.scale"),
            "layer_scale_2": et_vec("mlp_layer_scale.scale"),
        }
    }

    def rvq(kind, nq):
        base = f"encoder.quantizer.{kind}_residual_vector_quantizer"
        return {
            # 1x1 convs [O, I, 1] -> [I, O] matmuls
            "input_proj": _to_dtype(w.get(f"{base}.input_proj.weight")[:, :, 0].T, dtype),
            "output_proj": _to_dtype(w.get(f"{base}.output_proj.weight")[:, :, 0].T, dtype),
            "layers": [
                {"embedding_sum": _to_dtype(w.get(f"{base}.layers.{i}.codebook.embed_sum"),
                                            torch.float32),
                 "cluster_usage": _to_dtype(w.get(f"{base}.layers.{i}.codebook.cluster_usage"),
                                            torch.float32)}
                for i in range(nq)
            ],
        }

    return {
        "seanet": seanet,
        "transformer": transformer,
        "downsample": {"w": _convw(w.get("encoder.downsample.conv.weight"), dtype)},
        "quantizer": {
            "rvq_first": rvq("semantic", 1),
            "rvq_rest": rvq("acoustic", cfg.num_quantizers - 1),
        },
    }


# ---------------------------------------------------------------------------
# Top-level checkpoint loading
# ---------------------------------------------------------------------------


def to_device(tree, device):
    """Move a loaded tree to ``device`` (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


class Checkpoint:
    """Everything loaded from a model directory, on ``device``: the talker,
    the code predictor, the vocoder and, where the checkpoint has them, the
    voice-clone encoders (the speaker encoder, f32; the speech tokenizer's
    encoder, f32); ``speaker_encoder_params`` and ``encoder_params`` are None
    without them."""

    def __init__(
        self, model_dir: str, dtype=torch.bfloat16, keep_packed: bool | None = None, device="cpu"
    ):
        self.model_dir = model_dir
        self.config = ModelConfig.from_json(os.path.join(model_dir, "config.json"))
        if keep_packed is None:
            # default: keep int4/int8 packed whenever the checkpoint is quantized
            keep_packed = self.config.quantization is not None
        w = _W(load_safetensors_dir(model_dir), self.config.quantization, keep_packed=keep_packed)

        if self.config.talker_config is None:
            raise ValueError("config.json has no talker_config")
        self.talker_params = to_device(load_talker(w, self.config.talker_config, dtype), device)
        cp_cfg = self.config.talker_config.code_predictor_config
        self.cp_params = (
            to_device(load_code_predictor(w, cp_cfg, dtype), device) if cp_cfg is not None else None
        )
        self.speaker_encoder_params = None
        if self.config.speaker_encoder_config is not None and w.has(
            "speaker_encoder.blocks.0.conv.weight"
        ):
            self.speaker_encoder_params = to_device(
                load_speaker_encoder(w, self.config.speaker_encoder_config, torch.float32), device
            )

        # speech_tokenizer/ subdirectory: the vocoder and the encoder
        self.tokenizer_config: TokenizerConfig | None = None
        self.vocoder_params = None
        self.encoder_params = None
        st_dir = os.path.join(model_dir, "speech_tokenizer")
        if os.path.isdir(st_dir):
            with open(os.path.join(st_dir, "config.json")) as f:
                self.tokenizer_config = TokenizerConfig.from_dict(json.load(f))
            st = _W(load_safetensors_dir(st_dir), None)
            if self.tokenizer_config.decoder_config is not None:
                self.vocoder_params = to_device(
                    load_vocoder(st, self.tokenizer_config.decoder_config, torch.float32), device
                )
            if self.tokenizer_config.encoder_config is not None and st.has(
                "encoder.encoder.layers.0.conv.weight"
            ):
                self.encoder_params = to_device(
                    load_encoder(st, self.tokenizer_config.encoder_config, torch.float32), device
                )
