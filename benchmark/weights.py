"""Random weights of a configuration, made on the device from the seed.

The trees have the layout the program loads (``qwen3tts_tpu_torch.utils.
host_init``'s) and its scale convention: normal draws over the square root
of a matrix's input width, embeddings at 0.02, norms at one, biases at
zero. Each tree is drawn in one call into one flat buffer in the type it is
served in (the talker and the CP in bf16, the vocoder in float32), and its
leaves are views of that buffer. The program and the reference are handed
the same tensors.
"""

from __future__ import annotations

import math

import torch


def _normal(*shape, scale=None):
    return ("n", shape, scale if scale is not None else 1.0 / math.sqrt(shape[-2]))


def _full(*shape, value=0.0):
    return ("f", shape, value)


def _make(spec, generator, device, dtype):
    """Materialise a tree of _normal / _full leaves; every normal leaf is a
    scaled view of one buffer drawn in one call."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif node[0] == "n":
            leaves.append(node)

    walk(spec)
    total = sum(math.prod(s) for _, s, _ in leaves)
    flat = torch.randn(total, generator=generator, device=device, dtype=dtype)
    at = [0]

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        kind, shape, arg = node
        if kind == "f":
            return torch.full(shape, arg, device=device, dtype=dtype)
        n = math.prod(shape)
        view = flat[at[0]: at[0] + n].view(shape)
        at[0] += n
        return view.mul_(arg)

    return build(spec)


def _stack(L, c, h):
    """A layer stack's leaves at widths ``c`` with residual width ``h``."""
    nq, nkv, hd, inter = (c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"],
                          c["intermediate_size"])
    return {
        "q_proj": _normal(L, h, nq * hd), "k_proj": _normal(L, h, nkv * hd),
        "v_proj": _normal(L, h, nkv * hd), "o_proj": _normal(L, nq * hd, h),
        "q_norm": _full(L, hd, value=1.0), "k_norm": _full(L, hd, value=1.0),
        "gate_proj": _normal(L, h, inter), "up_proj": _normal(L, h, inter),
        "down_proj": _normal(L, inter, h),
        "input_layernorm": _full(L, h, value=1.0), "post_attention_layernorm": _full(L, h, value=1.0),
    }


def talker_spec(t: dict) -> dict:
    h, th = t["hidden_size"], t["text_hidden_size"]
    return {
        "codec_embedding": _normal(t["vocab_size"], h, scale=0.02),
        "text_embedding": _normal(t["text_vocab_size"], th, scale=0.02),
        "layers": _stack(t["num_hidden_layers"], t, h),
        "norm": _full(h, value=1.0),
        "text_projection": {
            "fc1": {"w": _normal(th, th), "b": _full(th)},
            "fc2": {"w": _normal(th, h), "b": _full(h)},
        },
        "codec_head": _normal(h, t["vocab_size"]),
    }


def cp_spec(c: dict, talker_h: int) -> dict:
    n, h = c["num_code_groups"] - 1, c["hidden_size"]
    spec = {
        "codec_embedding": _normal(n, c["vocab_size"], talker_h),
        "layers": _stack(c["num_hidden_layers"], c, h),
        "norm": _full(h, value=1.0),
        "lm_head": _normal(n, h, c["vocab_size"]),
    }
    if h != talker_h:
        spec["small_to_mtp_projection"] = {"w": _normal(talker_h, h), "b": _full(h)}
    return spec


def vocoder_spec(c: dict) -> dict:
    cb, inner, ld, dd = c["codebook_dim"], c["codebook_dim"] // 2, c["latent_dim"], c["decoder_dim"]
    L, h = c["num_hidden_layers"], c["hidden_size"]
    hd, nq, nkv = c["head_dim"], c["num_attention_heads"], c["num_key_value_heads"]

    def conv(k, c_in, c_out, groups=1, bias=True):
        p = {"w": _normal(k, c_in // groups, c_out, scale=1.0 / math.sqrt(c_in * k / groups))}
        if bias:
            p["b"] = _full(c_out)
        return p

    def convt(k, c_in, c_out):
        return {"w": _normal(k, c_out, c_in, scale=1.0 / math.sqrt(c_in * k)), "b": _full(c_out)}

    def lin(d_in, d_out, bias=True):
        p = {"w": _normal(d_in, d_out)}
        if bias:
            p["b"] = _full(d_out)
        return p

    def snake(ch):
        return {"alpha": _full(ch), "beta": _full(ch)}

    blocks = []
    for i, rate in enumerate(c["upsample_rates"]):
        c_in, c_out = dd // (1 << i), dd // (1 << (i + 1))
        block = {"snake": snake(c_in), "upsample": convt(rate * 2, c_in, c_out)}
        for j in range(3):
            block[f"res{j + 1}"] = {"act1": snake(c_out), "conv1": conv(7, c_out, c_out),
                                    "act2": snake(c_out), "conv2": conv(1, c_out, c_out)}
        blocks.append(block)
    out_dim = dd // (1 << len(c["upsample_rates"]))
    n_ac = c["num_quantizers"] - c["num_semantic_quantizers"]
    return {
        "quantizer": {
            "rvq_first": {"codebooks": _normal(c["num_semantic_quantizers"],
                                               c["semantic_codebook_size"], inner, scale=8.0),
                          "output_proj": lin(inner, cb, bias=False)},
            "rvq_rest": {"codebooks": _normal(n_ac, c["codebook_size"], inner, scale=2.0),
                         "output_proj": lin(inner, cb, bias=False)},
        },
        "pre_conv": conv(3, cb, ld),
        "pre_transformer": {
            "input_proj": lin(ld, h),
            "output_proj": lin(h, ld),
            "layers": {
                "q_proj": _normal(L, h, nq * hd), "k_proj": _normal(L, h, nkv * hd),
                "v_proj": _normal(L, h, nkv * hd), "o_proj": _normal(L, nq * hd, h),
                "gate_proj": _normal(L, h, c["intermediate_size"]),
                "up_proj": _normal(L, h, c["intermediate_size"]),
                "down_proj": _normal(L, c["intermediate_size"], h),
                "input_layernorm": _full(L, h, value=1.0),
                "post_attention_layernorm": _full(L, h, value=1.0),
                "self_attn_layer_scale": _full(L, h, value=c["layer_scale_initial_scale"]),
                "mlp_layer_scale": _full(L, h, value=c["layer_scale_initial_scale"]),
            },
            "norm": _full(h, value=1.0),
        },
        "upsample": [
            {"conv": convt(ratio, ld, ld),
             "convnext": {"dwconv": conv(7, ld, ld, groups=ld),
                          "norm": {"w": _full(ld, value=1.0), "b": _full(ld)},
                          "pwconv1": lin(ld, ld * 4), "pwconv2": lin(ld * 4, ld),
                          "gamma": _full(ld, value=1e-6)}}
            for ratio in c["upsampling_ratios"]
        ],
        "decoder": {"init_conv": conv(7, ld, dd), "blocks": blocks, "out_snake": snake(out_dim),
                    "out_conv": conv(7, out_dim, 1)},
    }


def make(cfg: dict, seed: int, device) -> tuple[dict, dict, dict]:
    """(talker bf16, CP bf16, vocoder f32) trees of the configuration ``cfg``
    (a config file's dict), drawn from ``seed`` on ``device``."""
    t = cfg["talker_config"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    talker = _make(talker_spec(t), g, device, torch.bfloat16)
    cp = _make(cp_spec(t["code_predictor_config"], t["hidden_size"]), g, device, torch.bfloat16)
    voc = _make(vocoder_spec(cfg["decoder_config"]), g, device, torch.float32)
    return talker, cp, voc
