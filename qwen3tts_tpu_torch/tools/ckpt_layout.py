"""The raw on-disk layout of a Qwen3-TTS checkpoint, by name and shape or
with synthetic values (the port's own copy of the numpy weight functions of the
repository's synthetic test checkpoint; numpy only).

``build_main_weights(cfg)`` and ``build_speech_tokenizer_weights(st_cfg)``
give every tensor the loader reads, by its raw name, for a config dict in
``config.json`` form. ``mat(name, *shape, scale=)`` draws each matrix: by
default from a RandomState seeded with the name's crc32 (the test
checkpoint's values, byte for byte); ``shape_only`` gives a zero view that
holds no memory. ``tools/inspect_ckpt.py`` diffs a checkpoint's headers
against the names and shapes; ``tools/parity_harness.py --synthetic`` runs
on ``write_checkpoint``'s directory with ``StubTokenizer``.

``SYNTHETIC_CONFIG`` and ``SYNTHETIC_ST_CONFIG`` are the test checkpoint's
tiny configs with the tts special ids inside the 512-entry text vocabulary
and full 2048-entry vocoder codebooks: torch's gathers raise on an index
past a table, where JAX's clamp it, so here every id the prompt, the
generated codes and the golden codes use is in range.
"""

from __future__ import annotations

import copy
import json
import os
import zlib

import numpy as np

TINY_CONFIG = {
    "model_type": "qwen3_tts",
    "tts_model_type": "custom_voice",
    "tts_model_size": "0b6",
    "sample_rate": 24000,
    "talker_config": {
        "vocab_size": 3072,
        "text_vocab_size": 512,
        "hidden_size": 64,
        "text_hidden_size": 48,
        "intermediate_size": 128,
        "num_hidden_layers": 2,
        "num_attention_heads": 4,
        "num_key_value_heads": 2,
        "head_dim": 16,
        "rope_scaling": {"interleaved": True, "mrope_section": [3, 3, 2]},
        "spk_id": {"aiden": 2001, "vivian": 2002, "eric": 2003},
        "spk_is_dialect": {"aiden": False, "vivian": False, "eric": "sichuan_dialect"},
        "codec_language_id": {
            "english": 2050,
            "chinese": 2055,
            "sichuan_dialect": 2071,
        },
        "code_predictor_config": {
            "vocab_size": 2048,
            "hidden_size": 32,
            "intermediate_size": 64,
            "num_hidden_layers": 2,
            "num_attention_heads": 2,
            "num_key_value_heads": 1,
            "head_dim": 16,
            "num_code_groups": 16,
        },
    },
    "speaker_encoder_config": {
        "mel_dim": 16,
        "enc_dim": 64,
        "enc_channels": [16, 16, 16, 16, 48],
        "enc_kernel_sizes": [5, 3, 3, 3, 1],
        "enc_dilations": [1, 2, 3, 4, 1],
        "enc_attention_channels": 8,
        "enc_res2net_scale": 4,
        "enc_se_channels": 8,
    },
}

TINY_ST_CONFIG = {
    "encoder_valid_num_quantizers": 16,
    "decode_upsample_rate": 1920,
    "encode_downsample_rate": 1920,
    "decoder_config": {
        "latent_dim": 32,
        "codebook_dim": 16,
        "codebook_size": 64,
        "decoder_dim": 64,
        "hidden_size": 16,
        "intermediate_size": 32,
        "num_hidden_layers": 2,
        "num_attention_heads": 2,
        "num_key_value_heads": 2,
        "head_dim": 8,
        "num_quantizers": 16,
        "num_semantic_quantizers": 1,
        "semantic_codebook_size": 128,
        "upsample_rates": [8, 5, 4, 3],
        "upsampling_ratios": [2, 2],
    },
    "encoder_config": {
        "codebook_dim": 8,
        "codebook_size": 32,
        "hidden_size": 16,
        "intermediate_size": 32,
        "num_attention_heads": 2,
        "num_key_value_heads": 2,
        "num_filters": 2,
        "num_hidden_layers": 2,
        "num_quantizers": 32,
        "upsampling_ratios": [8, 6, 5, 4],
    },
}


SYNTHETIC_CONFIG = dict(TINY_CONFIG, tts_bos_token_id=500, tts_eos_token_id=501,
                        tts_pad_token_id=502)
SYNTHETIC_ST_CONFIG = copy.deepcopy(TINY_ST_CONFIG)
SYNTHETIC_ST_CONFIG["decoder_config"].update(codebook_size=2048, semantic_codebook_size=2048)


class StubTokenizer:
    """Deterministic whitespace tokenizer: chat specials, then crc32 word ids
    (no tokenizer files needed; the tests' tokenizer, word for word)."""

    specials = {
        "<|im_start|>": 151644,
        "<|im_end|>": 151645,
    }

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size

    def encode(self, text: str):
        ids = []
        # crude split keeping the chat-template specials as single tokens
        for tag, tid in self.specials.items():
            text = text.replace(tag, f" {tag} ")
        for tok in text.replace("\n", " \\n ").split():
            if tok in self.specials:
                ids.append(self.specials[tok] % self.vocab_size)
            else:
                ids.append(zlib.crc32(tok.encode()) % (self.vocab_size - 16))
        return ids


def _rs(name: str) -> np.random.RandomState:
    # crc32, not hash(): PYTHONHASHSEED randomises hash() per process
    return np.random.RandomState(zlib.crc32(name.encode()) % (2**31))


def _mat(name, *shape, scale=None):
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[-1])
    return (_rs(name).randn(*shape) * scale).astype(np.float32)


def shape_only(name, *shape, scale=None):
    """A ``mat`` that draws nothing: a zero view of the shape."""
    return np.broadcast_to(np.float32(0), shape)


def build_main_weights(cfg: dict, mat=_mat) -> dict[str, np.ndarray]:
    """The main checkpoint's raw tensors (talker, code predictor, speaker
    encoder) for the config dict ``cfg``, by name."""
    t = cfg["talker_config"]
    h, th = t["hidden_size"], t["text_hidden_size"]
    hd, nq, nkv = t["head_dim"], t["num_attention_heads"], t["num_key_value_heads"]
    w: dict[str, np.ndarray] = {
        "talker.model.codec_embedding.weight": mat("ce", t["vocab_size"], h, scale=0.02),
        "talker.model.text_embedding.weight": mat("te", t["text_vocab_size"], th, scale=0.02),
        "talker.model.norm.weight": np.ones(h, np.float32),
        "talker.text_projection.linear_fc1.weight": mat("fc1", th, th),
        "talker.text_projection.linear_fc1.bias": np.zeros(th, np.float32),
        "talker.text_projection.linear_fc2.weight": mat("fc2", h, th),
        "talker.text_projection.linear_fc2.bias": np.zeros(h, np.float32),
        "talker.codec_head.weight": mat("head", t["vocab_size"], h),
    }
    for i in range(t["num_hidden_layers"]):
        p = f"talker.model.layers.{i}"
        w[f"{p}.self_attn.q_proj.weight"] = mat(f"q{i}", nq * hd, h)
        w[f"{p}.self_attn.k_proj.weight"] = mat(f"k{i}", nkv * hd, h)
        w[f"{p}.self_attn.v_proj.weight"] = mat(f"v{i}", nkv * hd, h)
        w[f"{p}.self_attn.o_proj.weight"] = mat(f"o{i}", h, nq * hd)
        w[f"{p}.self_attn.q_norm.weight"] = np.ones(hd, np.float32)
        w[f"{p}.self_attn.k_norm.weight"] = np.ones(hd, np.float32)
        w[f"{p}.mlp.gate_proj.weight"] = mat(f"g{i}", t["intermediate_size"], h)
        w[f"{p}.mlp.up_proj.weight"] = mat(f"u{i}", t["intermediate_size"], h)
        w[f"{p}.mlp.down_proj.weight"] = mat(f"d{i}", h, t["intermediate_size"])
        w[f"{p}.input_layernorm.weight"] = np.ones(h, np.float32)
        w[f"{p}.post_attention_layernorm.weight"] = np.ones(h, np.float32)

    c = t["code_predictor_config"]
    ch, chd = c["hidden_size"], c["head_dim"]
    cq, ckv = c["num_attention_heads"], c["num_key_value_heads"]
    base = "talker.code_predictor"
    w[f"{base}.small_to_mtp_projection.weight"] = mat("mtp", ch, h)
    w[f"{base}.small_to_mtp_projection.bias"] = np.zeros(ch, np.float32)
    w[f"{base}.model.norm.weight"] = np.ones(ch, np.float32)
    for i in range(c["num_code_groups"] - 1):
        w[f"{base}.model.codec_embedding.{i}.weight"] = mat(f"cce{i}", c["vocab_size"], h, scale=0.02)
        w[f"{base}.lm_head.{i}.weight"] = mat(f"clm{i}", c["vocab_size"], ch)
    for i in range(c["num_hidden_layers"]):
        p = f"{base}.model.layers.{i}"
        w[f"{p}.self_attn.q_proj.weight"] = mat(f"cq{i}", cq * chd, ch)
        w[f"{p}.self_attn.k_proj.weight"] = mat(f"ck{i}", ckv * chd, ch)
        w[f"{p}.self_attn.v_proj.weight"] = mat(f"cv{i}", ckv * chd, ch)
        w[f"{p}.self_attn.o_proj.weight"] = mat(f"co{i}", ch, cq * chd)
        w[f"{p}.self_attn.q_norm.weight"] = np.ones(chd, np.float32)
        w[f"{p}.self_attn.k_norm.weight"] = np.ones(chd, np.float32)
        w[f"{p}.mlp.gate_proj.weight"] = mat(f"cg{i}", c["intermediate_size"], ch)
        w[f"{p}.mlp.up_proj.weight"] = mat(f"cu{i}", c["intermediate_size"], ch)
        w[f"{p}.mlp.down_proj.weight"] = mat(f"cd{i}", ch, c["intermediate_size"])
        w[f"{p}.input_layernorm.weight"] = np.ones(ch, np.float32)
        w[f"{p}.post_attention_layernorm.weight"] = np.ones(ch, np.float32)

    s = cfg["speaker_encoder_config"]
    chs, kss = s["enc_channels"], s["enc_kernel_sizes"]
    scale_r = s["enc_res2net_scale"]

    def conv(name, key, c_out, c_in, k):
        w[f"{key}.weight"] = mat(name, c_out, c_in, k)
        w[f"{key}.bias"] = np.zeros(c_out, np.float32)

    conv("sb0", "speaker_encoder.blocks.0.conv", chs[0], s["mel_dim"], kss[0])
    for bi in range(1, 4):
        p = f"speaker_encoder.blocks.{bi}"
        conv(f"st1{bi}", f"{p}.tdnn1.conv", chs[bi], chs[bi - 1], 1)
        for j in range(scale_r - 1):
            conv(f"sr{bi}{j}", f"{p}.res2net_block.blocks.{j}.conv",
                 chs[bi] // scale_r, chs[bi] // scale_r, kss[bi])
        conv(f"st2{bi}", f"{p}.tdnn2.conv", chs[bi], chs[bi], 1)
        conv(f"se1{bi}", f"{p}.se_block.conv1", s["enc_se_channels"], chs[bi], 1)
        conv(f"se2{bi}", f"{p}.se_block.conv2", chs[bi], s["enc_se_channels"], 1)
    conv("mfa", "speaker_encoder.mfa.conv", chs[4], chs[1] + chs[2] + chs[3], kss[4])
    conv("asp1", "speaker_encoder.asp.tdnn.conv", s["enc_attention_channels"], chs[4] * 3, 1)
    conv("asp2", "speaker_encoder.asp.conv", chs[4], s["enc_attention_channels"], 1)
    conv("fc", "speaker_encoder.fc", s["enc_dim"], chs[4] * 2, 1)
    return w


def build_speech_tokenizer_weights(cfg: dict, mat=_mat) -> dict[str, np.ndarray]:
    """``speech_tokenizer/``'s raw tensors (decoder and encoder) for its
    config dict ``cfg``, by name."""
    d = cfg["decoder_config"]
    w: dict[str, np.ndarray] = {}

    def conv(name, key, c_out, c_in, k):
        w[f"{key}.weight"] = mat(name, c_out, c_in, k)
        w[f"{key}.bias"] = np.zeros(c_out, np.float32)

    def convt(name, key, c_in, c_out, k):
        # torch ConvTranspose1d layout [I, O, W]
        w[f"{key}.weight"] = mat(name, c_in, c_out, k)
        w[f"{key}.bias"] = np.zeros(c_out, np.float32)

    def lin(name, key, c_out, c_in, bias=True):
        w[f"{key}.weight"] = mat(name, c_out, c_in)
        if bias:
            w[f"{key}.bias"] = np.zeros(c_out, np.float32)

    inner = d["codebook_dim"] // 2
    for kind, nq, bins in (
        ("rvq_first", d["num_semantic_quantizers"], d["semantic_codebook_size"]),
        ("rvq_rest", d["num_quantizers"] - d["num_semantic_quantizers"], d["codebook_size"]),
    ):
        base = f"decoder.quantizer.{kind}"
        w[f"{base}.input_proj.weight"] = mat(f"{kind}ip", inner, d["codebook_dim"], 1)
        w[f"{base}.output_proj.weight"] = mat(f"{kind}op", d["codebook_dim"], inner, 1)
        for i in range(nq):
            cb = f"{base}.vq.layers.{i}._codebook"
            w[f"{cb}.embedding_sum"] = mat(f"{kind}es{i}", bins, inner, scale=4.0)
            w[f"{cb}.cluster_usage"] = np.ones(bins, np.float32)

    conv("prec", "decoder.pre_conv.conv", d["latent_dim"], d["codebook_dim"], 3)

    pt = "decoder.pre_transformer"
    lin("pti", f"{pt}.input_proj", d["hidden_size"], d["latent_dim"])
    lin("pto", f"{pt}.output_proj", d["latent_dim"], d["hidden_size"])
    w[f"{pt}.norm.weight"] = np.ones(d["hidden_size"], np.float32)
    nq_h, nkv_h, hd = d["num_attention_heads"], d["num_key_value_heads"], d["head_dim"]
    for i in range(d["num_hidden_layers"]):
        p = f"{pt}.layers.{i}"
        lin(f"ptq{i}", f"{p}.self_attn.q_proj", nq_h * hd, d["hidden_size"], bias=False)
        lin(f"ptk{i}", f"{p}.self_attn.k_proj", nkv_h * hd, d["hidden_size"], bias=False)
        lin(f"ptv{i}", f"{p}.self_attn.v_proj", nkv_h * hd, d["hidden_size"], bias=False)
        lin(f"pto{i}", f"{p}.self_attn.o_proj", d["hidden_size"], nq_h * hd, bias=False)
        lin(f"ptg{i}", f"{p}.mlp.gate_proj", d["intermediate_size"], d["hidden_size"], bias=False)
        lin(f"ptu{i}", f"{p}.mlp.up_proj", d["intermediate_size"], d["hidden_size"], bias=False)
        lin(f"ptd{i}", f"{p}.mlp.down_proj", d["hidden_size"], d["intermediate_size"], bias=False)
        w[f"{p}.input_layernorm.weight"] = np.ones(d["hidden_size"], np.float32)
        w[f"{p}.post_attention_layernorm.weight"] = np.ones(d["hidden_size"], np.float32)
        w[f"{p}.self_attn_layer_scale.scale"] = np.full(d["hidden_size"], 0.01, np.float32)
        w[f"{p}.mlp_layer_scale.scale"] = np.full(d["hidden_size"], 0.01, np.float32)

    for i, r in enumerate(d["upsampling_ratios"]):
        convt(f"up{i}", f"decoder.upsample.{i}.0.conv", d["latent_dim"], d["latent_dim"], r)
        cn = f"decoder.upsample.{i}.1"
        # depthwise conv: torch groups=dim -> weight [O, 1, W]
        w[f"{cn}.dwconv.conv.weight"] = mat(f"dw{i}", d["latent_dim"], 1, 7)
        w[f"{cn}.dwconv.conv.bias"] = np.zeros(d["latent_dim"], np.float32)
        w[f"{cn}.norm.weight"] = np.ones(d["latent_dim"], np.float32)
        w[f"{cn}.norm.bias"] = np.zeros(d["latent_dim"], np.float32)
        lin(f"pw1{i}", f"{cn}.pwconv1", d["latent_dim"] * 4, d["latent_dim"])
        lin(f"pw2{i}", f"{cn}.pwconv2", d["latent_dim"], d["latent_dim"] * 4)
        w[f"{cn}.gamma"] = np.full(d["latent_dim"], 1e-6, np.float32)

    dd = d["decoder_dim"]
    conv("minit", "decoder.decoder.0.conv", dd, d["latent_dim"], 7)
    for bi, rate in enumerate(d["upsample_rates"]):
        c_in, c_out = dd // (1 << bi), dd // (1 << (bi + 1))
        b = f"decoder.decoder.{bi + 1}"
        w[f"{b}.block.0.alpha"] = np.zeros(c_in, np.float32)
        w[f"{b}.block.0.beta"] = np.zeros(c_in, np.float32)
        convt(f"mb{bi}", f"{b}.block.1.conv", c_in, c_out, rate * 2)
        for ri, u in enumerate((2, 3, 4)):
            ru = f"{b}.block.{u}"
            w[f"{ru}.act1.alpha"] = np.zeros(c_out, np.float32)
            w[f"{ru}.act1.beta"] = np.zeros(c_out, np.float32)
            conv(f"mr{bi}{ri}1", f"{ru}.conv1.conv", c_out, c_out, 7)
            w[f"{ru}.act2.alpha"] = np.zeros(c_out, np.float32)
            w[f"{ru}.act2.beta"] = np.zeros(c_out, np.float32)
            conv(f"mr{bi}{ri}2", f"{ru}.conv2.conv", c_out, c_out, 1)
    n_stages = len(d["upsample_rates"])
    out_dim = dd // (1 << n_stages)
    w[f"decoder.decoder.{n_stages + 1}.alpha"] = np.zeros(out_dim, np.float32)
    w[f"decoder.decoder.{n_stages + 1}.beta"] = np.zeros(out_dim, np.float32)
    conv("mout", f"decoder.decoder.{n_stages + 2}.conv", 1, out_dim, 7)

    # --- encoder (Mimi) ---
    e = cfg["encoder_config"]
    nf = e["num_filters"]
    seanet = {0: ("init", e.get("kernel_size", 7), 1, nf)}
    mult = 1
    idx_map = [(1, 3), (4, 6), (7, 9), (10, 12)]
    for stage, (res_i, down_i) in enumerate(idx_map):
        dim = mult * nf
        hidden = dim // e.get("compress", 2)
        conv(f"er{stage}a", f"encoder.encoder.layers.{res_i}.block.1.conv",
             hidden, dim, e.get("residual_kernel_size", 3))
        conv(f"er{stage}b", f"encoder.encoder.layers.{res_i}.block.3.conv", dim, hidden, 1)
        ratio = list(reversed(e["upsampling_ratios"]))[stage]
        conv(f"ed{stage}", f"encoder.encoder.layers.{down_i}.conv", dim * 2, dim, ratio * 2)
        mult *= 2
    conv("einit", "encoder.encoder.layers.0.conv", nf, 1, e.get("kernel_size", 7))
    conv("efin", "encoder.encoder.layers.14.conv", e["hidden_size"], mult * nf,
         e.get("last_kernel_size", 3))

    d_model = e["hidden_size"]
    ehd = d_model // e["num_attention_heads"]
    for i in range(e["num_hidden_layers"]):
        p = f"encoder.encoder_transformer.layers.{i}"
        lin(f"etq{i}", f"{p}.self_attn.q_proj", d_model, d_model, bias=False)
        lin(f"etk{i}", f"{p}.self_attn.k_proj",
            e["num_key_value_heads"] * ehd, d_model, bias=False)
        lin(f"etv{i}", f"{p}.self_attn.v_proj",
            e["num_key_value_heads"] * ehd, d_model, bias=False)
        lin(f"eto{i}", f"{p}.self_attn.o_proj", d_model, d_model, bias=False)
        w[f"{p}.input_layernorm.weight"] = np.ones(d_model, np.float32)
        w[f"{p}.input_layernorm.bias"] = np.zeros(d_model, np.float32)
        w[f"{p}.post_attention_layernorm.weight"] = np.ones(d_model, np.float32)
        w[f"{p}.post_attention_layernorm.bias"] = np.zeros(d_model, np.float32)
        lin(f"etf1{i}", f"{p}.mlp.fc1", e["intermediate_size"], d_model, bias=False)
        lin(f"etf2{i}", f"{p}.mlp.fc2", d_model, e["intermediate_size"], bias=False)
        w[f"{p}.self_attn_layer_scale.scale"] = np.full(d_model, 0.01, np.float32)
        w[f"{p}.mlp_layer_scale.scale"] = np.full(d_model, 0.01, np.float32)

    ratio_prod = int(np.prod(e["upsampling_ratios"]))
    stride = int((e.get("sampling_rate", 24000) / ratio_prod) / e.get("frame_rate", 12.5))
    w["encoder.downsample.conv.weight"] = mat("edown", d_model, d_model, 2 * stride)

    for kind, nq2 in (("semantic", 1), ("acoustic", e["num_quantizers"] - 1)):
        base = f"encoder.quantizer.{kind}_residual_vector_quantizer"
        w[f"{base}.input_proj.weight"] = mat(f"{kind}ip", e["codebook_dim"], d_model, 1)
        w[f"{base}.output_proj.weight"] = mat(f"{kind}op", d_model, e["codebook_dim"], 1)
        for i in range(nq2):
            cb = f"{base}.layers.{i}.codebook"
            w[f"{cb}.embed_sum"] = mat(f"{kind}es{i}", e["codebook_size"], e["codebook_dim"], scale=2.0)
            w[f"{cb}.cluster_usage"] = np.ones(e["codebook_size"], np.float32)
            w[f"{cb}.initialized"] = np.ones(1, np.float32)
    return w


def is_quantized_linear(name: str, shape: tuple, group: int) -> bool:
    """Whether an MLX-quantized checkpoint packs this tensor: a 2-D linear
    weight (projections, heads, the text projection's fc layers; no
    embedding) whose input width the group divides."""
    return (
        name.endswith(".weight")
        and len(shape) == 2
        and ("proj" in name or "lm_head" in name or "codec_head" in name or "linear_fc" in name)
        and "embedding" not in name
        and shape[1] % group == 0
    )


def write_checkpoint(path: str, quantize: bool = False, config: dict | None = None) -> str:
    """Write a synthetic checkpoint (``config``, by default
    ``SYNTHETIC_CONFIG``; float32, or MLX int4 group 32 with ``quantize``)
    and its ``speech_tokenizer/`` (``SYNTHETIC_ST_CONFIG``) to ``path`` with
    the port's safetensors writer; returns ``path``."""
    from ..ops.quant import pack_quantized
    from ..utils.loader import write_safetensors

    os.makedirs(os.path.join(path, "speech_tokenizer"), exist_ok=True)
    cfg = dict(SYNTHETIC_CONFIG if config is None else config)
    weights = build_main_weights(cfg)
    if quantize:
        cfg["quantization"] = {"group_size": 32, "bits": 4, "mode": "affine"}
        out = {}
        for k, v in weights.items():
            if is_quantized_linear(k, v.shape, 32):
                out[k], out[k + ".scales"], out[k + ".biases"] = pack_quantized(v, 4, 32)
            else:
                out[k] = v
        weights = out
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    write_safetensors(os.path.join(path, "model.safetensors"), weights)
    with open(os.path.join(path, "speech_tokenizer", "config.json"), "w") as f:
        json.dump(SYNTHETIC_ST_CONFIG, f)
    write_safetensors(os.path.join(path, "speech_tokenizer", "model.safetensors"),
                      build_speech_tokenizer_weights(SYNTHETIC_ST_CONFIG))
    return path
