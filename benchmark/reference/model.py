"""The plain reference of a Qwen3-TTS CustomVoice utterance, in float32.

Written from the model's description for this benchmark and kept frozen
beside it: prompt embedding, the 28-layer talker, the 5-layer code
predictor (CP), per-output-channel weight-only quantisation, and the
12 Hz speech-tokenizer decoder (vocoder). It imports torch and nothing of
the program under test, and takes only the bf16 and f32 weights the
benchmark made; every quantised weight, table and prompt row is worked out
here again. Every step runs teacher-forced over served tokens, so one call
gives the logits of every position of an utterance.

``Reference(..., bits=8)`` is the configuration's own arithmetic (int8
weights, computed in float32). ``bits=4`` and ``tf32=True`` are the lower
precisions the controls put in the program's place.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

CHAT_ASSISTANT = "<|im_start|>assistant\n{}<|im_end|>\n<|im_start|>assistant\n"
TTS_PAD, TTS_BOS, TTS_EOS = 151671, 151672, 151673
CODEC = dict(eos=2150, nothink=2155, think_bos=2156, think_eos=2157, pad=2148, bos=2149)
N_SPECIAL = 1024  # the last ids of the codec vocabulary, suppressed for code 0 (EOS too here)


def dequant(w: torch.Tensor, bits: int | None) -> torch.Tensor:
    """w [..., in, out] as float32 after symmetric per-output-channel
    quantisation to ``bits`` (None: not quantised), round half to even."""
    w = w.float()
    if bits is None:
        return w
    qmax = (1 << (bits - 1)) - 1
    a = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(a == 0, torch.ones_like(a), a / qmax)
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding by halves; x [H, S, D], pos [S]."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cat([ang.cos(), ang.cos()], -1), torch.cat([ang.sin(), ang.sin()], -1)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + rot * sin


def transformer(layers: dict, c: dict, h: torch.Tensor, bits, causal=True, rope_on=True,
                layer_scale=False) -> torch.Tensor:
    """Pre-norm layers with QK-norm (when given), GQA and SwiGLU over
    sequences h [N, S, H] float32; weights dequantised one layer at a time."""
    N, S, _ = h.shape
    nq, nkv, hd, eps = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"], c["eps"]
    pos = torch.arange(S, device=h.device)
    mask = pos[None, :] <= pos[:, None] if causal else None
    for i in range(layers["q_proj"].shape[0]):
        w = {k: dequant(layers[k][i], bits) for k in
             ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")}
        x = rms(h, layers["input_layernorm"][i], eps)
        q = (x @ w["q_proj"]).reshape(N, S, nq, hd).transpose(1, 2)
        k = (x @ w["k_proj"]).reshape(N, S, nkv, hd).transpose(1, 2)
        v = (x @ w["v_proj"]).reshape(N, S, nkv, hd).transpose(1, 2)
        if "q_norm" in layers:
            q, k = rms(q, layers["q_norm"][i], eps), rms(k, layers["k_norm"][i], eps)
        if rope_on:
            q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
        k, v = k.repeat_interleave(nq // nkv, 1), v.repeat_interleave(nq // nkv, 1)
        s = q @ k.transpose(-1, -2) / math.sqrt(hd)
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        a = (s.softmax(-1) @ v).transpose(1, 2).reshape(N, S, nq * hd) @ w["o_proj"]
        h = h + (a * layers["self_attn_layer_scale"][i] if layer_scale else a)
        x = rms(h, layers["post_attention_layernorm"][i], eps)
        m = (F.silu(x @ w["gate_proj"]) * (x @ w["up_proj"])) @ w["down_proj"]
        h = h + (m * layers["mlp_layer_scale"][i] if layer_scale else m)
    return h


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls and convolutions, in TF32 only where asked."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """The reference over the benchmark's weights (``weights.make``'s trees)
    at the configuration ``cfg`` (a config file's dict)."""

    def __init__(self, cfg: dict, talker: dict, cp: dict, vocoder: dict, bits: int | None = 8,
                 tf32: bool = False):
        self.t, self.c, self.v = cfg["talker_config"], cfg["talker_config"]["code_predictor_config"], cfg["decoder_config"]
        self.talker, self.cp, self.voc, self.bits, self.tf32 = talker, cp, vocoder, bits, tf32
        self.speakers = dict(cfg["talker_config"]["spk_id"])

    def _tc(self, c: dict) -> dict:
        return dict(c, eps=c["rms_norm_eps"])

    def _text(self, ids) -> torch.Tensor:
        p = self.talker["text_projection"]
        e = self.talker["text_embedding"][torch.as_tensor(ids, device=p["fc1"]["w"].device)].float()
        h = F.silu(e @ p["fc1"]["w"].float() + p["fc1"]["b"].float())
        return h @ p["fc2"]["w"].float() + p["fc2"]["b"].float()

    def _codec(self, ids) -> torch.Tensor:
        table = self.talker["codec_embedding"]
        return table[torch.as_tensor(ids, device=table.device)].float()

    def prompt(self, text_ids: list[int], speaker: str):
        """(prompt rows [P, H], trailing text rows [T, H], pad row [H]) of a
        CustomVoice request in language "auto", no instruction."""
        bos, eos, pad = self._text([TTS_BOS, TTS_EOS, TTS_PAD])
        text = self._text(text_ids)
        codec = self._codec([CODEC["nothink"], CODEC["think_bos"], CODEC["think_eos"],
                             self.speakers[speaker.lower()], CODEC["pad"], CODEC["bos"]])
        n = codec.shape[0]
        over = torch.cat([pad[None].expand(n - 2, -1), bos[None]]) + codec[: n - 1]
        rows = torch.cat([text[:3], over, text[3:4] + codec[n - 1:]])
        L = text.shape[0]
        trailing = torch.cat([text[4: L - 5], eos[None]]) if L - 5 > 4 else eos[None]
        return rows, trailing, pad

    def code_sum(self, codes: torch.Tensor) -> torch.Tensor:
        """The next talker input's codec part: all 16 codebooks' embeddings of
        codes [N, 16], summed [N, H]."""
        codes = codes.long()
        tables = self.cp["codec_embedding"]
        idx = torch.arange(tables.shape[0], device=codes.device)
        return self._codec(codes[:, 0]) + tables[idx[None], codes[:, 1:]].float().sum(1)

    def talker_hidden(self, rows, trailing, pad, codes) -> torch.Tensor:
        """Post-norm talker hidden [n, H] of the position that samples each of
        the n served frames (codes [n, 16]): the prompt, then for frame t the
        trailing text row t (the pad row past its end) plus frame t's codes."""
        n = codes.shape[0]
        steps = torch.arange(n - 1, device=rows.device)
        text = torch.where((steps < trailing.shape[0])[:, None],
                           trailing[steps.clamp(max=trailing.shape[0] - 1)], pad[None])
        seq = torch.cat([rows, text + self.code_sum(codes[: n - 1])])[None]
        with precision(self.tf32):
            h = transformer(self.talker["layers"], self._tc(self.t), seq, self.bits)[0]
        h = rms(h, self.talker["norm"], self.t["rms_norm_eps"])
        return h[rows.shape[0] - 1:]

    def code0_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        with precision(self.tf32):
            return hidden @ dequant(self.talker["codec_head"], self.bits)

    def cp_logits(self, hidden: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """Logits [n, 15, V] of codebooks 1-15, teacher-forced on codes [n, 16]
        from the talker hidden [n, H]: the CP's positions are the hidden, code
        0's talker embedding, then codebook j's own table for code j."""
        codes = codes.long()
        tables = self.cp["codec_embedding"]
        embs = [self._codec(codes[:, 0])] + [tables[j][codes[:, j + 1]].float() for j in range(14)]
        seq = torch.stack([hidden] + embs, 1)
        proj = self.cp.get("small_to_mtp_projection")
        with precision(self.tf32):
            if proj is not None:
                seq = seq @ proj["w"].float() + proj["b"].float()
            h = transformer(self.cp["layers"], self._tc(self.c), seq, self.bits)
            h = rms(h, self.cp["norm"], self.c["rms_norm_eps"])[:, 1:]
            heads = dequant(self.cp["lm_head"], self.bits)  # [15, Hc, V]
            return torch.einsum("nsh,shv->nsv", h, heads)

    def vocode(self, codes: torch.Tensor) -> torch.Tensor:
        """Waveform [n * 1920] of codes [n, 16], clipped to [-1, 1]."""
        with precision(self.tf32):
            return vocoder(self.voc, self.v, codes[None].long())[0]


def code0_scores(logits: torch.Tensor, codes0: torch.Tensor, penalty: float) -> torch.Tensor:
    """The greedy sampler's scores of code 0 at each of n positions: logits
    [n, V] with the special ids and EOS masked and the repetition penalty on
    every id that an earlier frame served."""
    n, V = logits.shape
    z = logits.clone()
    z[:, V - N_SPECIAL:] = -1e30
    z[:, CODEC["eos"]] = -1e30
    prev = torch.zeros(n, V, dtype=torch.bool, device=z.device)
    for t in range(1, n):
        prev[t] = prev[t - 1]
        prev[t, codes0[t - 1].long()] = True
    pen = torch.where(z < 0, z * penalty, z / penalty)
    return torch.where(prev & (z > -1e29), pen, z)


# ---------------------------------------------------------------------------
# the vocoder: split RVQ, causal pre-conv, bidirectional transformer,
# 2 x (causal transposed conv, ConvNeXt), SnakeBeta decoder, clip
# ---------------------------------------------------------------------------


def _conv(x, w, b=None, dilation=1, groups=1):
    """Causal conv; x [B, T, C], w [W, C_in / groups, C_out]."""
    pad = (w.shape[0] - 1) * dilation
    y = F.conv1d(F.pad(x.transpose(1, 2), (pad, 0)), w.permute(2, 1, 0).float(),
                 dilation=dilation, groups=groups).transpose(1, 2)
    return y if b is None else y + b.float()


def _convt(x, w, b, stride):
    """Causal transposed conv; w [W, C_out, C_in]; T * stride samples out."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.permute(2, 1, 0).float(), stride=stride)
    y = y.transpose(1, 2) + b.float()
    trim = w.shape[0] - stride
    return y[:, :-trim] if trim > 0 else y


def _snake(x, p):
    a, b = torch.exp(p["alpha"].float()), torch.exp(p["beta"].float())
    return x + (1.0 / (b + 1e-9)) * torch.sin(x * a) ** 2


def vocoder(p: dict, c: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, T, 16] -> waveform [B, T * 1920]."""
    q = p["quantizer"]
    first, rest = q["rvq_first"], q["rvq_rest"]
    nsem = c["num_semantic_quantizers"]
    sem = sum(first["codebooks"][i][codes[..., i]].float() for i in range(nsem))
    ac = sum(rest["codebooks"][i][codes[..., nsem + i]].float()
             for i in range(c["num_quantizers"] - nsem))
    h = sem @ first["output_proj"]["w"].float() + ac @ rest["output_proj"]["w"].float()
    h = _conv(h, p["pre_conv"]["w"], p["pre_conv"]["b"])
    t = p["pre_transformer"]
    h = h @ t["input_proj"]["w"].float() + t["input_proj"]["b"].float()
    tc = dict(num_attention_heads=c["num_attention_heads"], num_key_value_heads=c["num_key_value_heads"],
              head_dim=c["head_dim"], eps=c["rms_norm_eps"])
    h = transformer(t["layers"], tc, h, None, causal=False, rope_on=False, layer_scale=True)
    h = rms(h, t["norm"], c["rms_norm_eps"])
    h = h @ t["output_proj"]["w"].float() + t["output_proj"]["b"].float()
    for stage, ratio in zip(p["upsample"], c["upsampling_ratios"]):
        h = _convt(h, stage["conv"]["w"], stage["conv"]["b"], ratio)
        cn = stage["convnext"]
        y = _conv(h, cn["dwconv"]["w"], cn["dwconv"]["b"], groups=h.shape[-1])
        y = F.layer_norm(y, (y.shape[-1],), cn["norm"]["w"].float(), cn["norm"]["b"].float(), 1e-6)
        y = F.gelu(y @ cn["pwconv1"]["w"].float() + cn["pwconv1"]["b"].float())
        y = y @ cn["pwconv2"]["w"].float() + cn["pwconv2"]["b"].float()
        h = h + cn["gamma"].float() * y
    d = p["decoder"]
    h = _conv(h, d["init_conv"]["w"], d["init_conv"]["b"])
    for block, rate in zip(d["blocks"], c["upsample_rates"]):
        h = _convt(_snake(h, block["snake"]), block["upsample"]["w"], block["upsample"]["b"], rate)
        for name, dil in (("res1", 1), ("res2", 3), ("res3", 9)):
            r = block[name]
            y = _conv(_snake(h, r["act1"]), r["conv1"]["w"], r["conv1"]["b"], dilation=dil)
            h = h + _conv(_snake(y, r["act2"]), r["conv2"]["w"], r["conv2"]["b"])
    h = _conv(_snake(h, d["out_snake"]), d["out_conv"]["w"], d["out_conv"]["b"])
    return torch.clamp(h[..., 0], -1.0, 1.0)
