"""chip_smoke.py's phase u (serving) alone on the card: the served path's
checks and numbers without the phases before it.

Builds the kernels and the 0.6B CustomVoice model (int8 fused weights from
``host_init``, a random vocoder, the stub tokenizer) as chip_smoke does,
then runs phase u's own source, cut from ``chip_smoke.py`` in the current
directory together with the helpers it calls. So it runs whatever phase u
the checkout holds, against that checkout's package: run it from the root
of a checkout,

    python3 qwen3tts_tpu_torch/tools/phase_u_alone.py

or, to time another tree's served path with this file, from that tree's
root with this file's path. Phase u's checks raise as in chip_smoke; the
numbers it prints carry the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess  # noqa: F401  (phase u's namespace)
import sys
import textwrap
import time

sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]

import json  # noqa: E402,F401  (phase u's namespace)
import statistics  # noqa: E402,F401

import numpy as np  # noqa: E402,F401
import torch  # noqa: E402
from synthetic_ckpt import StubTokenizer  # noqa: E402

from qwen3tts_tpu_torch import config as C  # noqa: E402
from qwen3tts_tpu_torch.models import code_predictor as cpm_mod  # noqa: E402
from qwen3tts_tpu_torch.models import generate as gen  # noqa: E402,F401
from qwen3tts_tpu_torch.models import talker as tk  # noqa: E402
from qwen3tts_tpu_torch.ops import _cuda  # noqa: E402
from qwen3tts_tpu_torch.ops import cp_kernel as cpk  # noqa: E402,F401
from qwen3tts_tpu_torch.ops import talker_kernel as tkk  # noqa: E402,F401
from qwen3tts_tpu_torch.ops.decode_blocks import (  # noqa: E402,F401
    NEG_BIG, sample_row, top_k_filter, top_p_cum, top_p_threshold,
)
from qwen3tts_tpu_torch.ops.quant import quantize_decode_params_int8  # noqa: E402
from qwen3tts_tpu_torch.ops.rope import mrope_cos_sin  # noqa: E402,F401
from qwen3tts_tpu_torch.tools._card import card, event_ms, require_cuda  # noqa: E402
from qwen3tts_tpu_torch.tts import Qwen3TTSModel  # noqa: E402
from qwen3tts_tpu_torch.utils import host_init as hi  # noqa: E402

# (first line, first line after) of the chip_smoke.py sections phase u needs
SECTIONS = [
    ("    HBM_BYTES_S, PEAK_FLOP_S", "    g = torch.Generator(device=dev).manual_seed(7)"),
    ("    NQ = cfg.num_attention_heads", "    k1_bound = bound("),
    ("    def batch_case(", "    def pen_b("),
    ("    def top_p_flip_ok(", "    top_p_cases ="),
]
PHASE_U = ("    # ---- u. serving", "    print(smi, flush=True)\n    k1_64")


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main() -> None:
    dev = require_cuda("phase_u_alone")
    smi = card()
    t0 = time.time()
    _cuda.library()
    log(f"kernels built in {time.time() - t0:.1f} s  [{smi}]")
    cpc = C.CodePredictorConfig(
        vocab_size=2048, hidden_size=1024, intermediate_size=3072, num_hidden_layers=5,
        num_attention_heads=16, num_key_value_heads=8, head_dim=128,
    )
    cfg = C.TalkerConfig(
        vocab_size=3072, text_vocab_size=151936, hidden_size=1024, text_hidden_size=1024,
        intermediate_size=3072, num_hidden_layers=28, num_attention_heads=16,
        num_key_value_heads=8, head_dim=128, spk_id=(("aiden", 2861), ("vivian", 2862)),
        code_predictor_config=cpc,
    )
    tb = hi.to_device(hi.host_init_talker_params(0, cfg), torch.bfloat16, dev)
    tb["layers"] = tk.fuse_layer_projections(tb["layers"])
    cb = hi.to_device(hi.host_init_cp_params(1, cpc, cfg.hidden_size), torch.bfloat16, dev)
    cb["layers"] = tk.fuse_layer_projections(cb["layers"])
    talker_p = quantize_decode_params_int8(tb, "codec_head")
    cp_p = quantize_decode_params_int8(cb, "lm_head")
    del tb, cb
    dec_cfg = C.TokenizerDecoderConfig()
    voc_p = hi.init_vocoder_params(torch.Generator(device=dev).manual_seed(2), dec_cfg,
                                   torch.float32, dev)
    model = Qwen3TTSModel(
        C.ModelConfig(talker_config=cfg, tts_model_type="custom_voice", tts_model_size="0b6"),
        talker_p, cp_p, voc_p, tokenizer_config=C.TokenizerConfig(decoder_config=dec_cfg),
        tokenizer=StubTokenizer(cfg.text_vocab_size), dtype=torch.bfloat16, device=dev,
    )
    V = cfg.vocab_size
    supp = torch.zeros(V, device=dev)
    supp[V - 1024:] = -1e30
    ns = dict(globals(), dev=dev, smi=smi, cfg=cfg, cpc=cpc, talker_p=talker_p, cp_p=cp_p,
              voc_p=voc_p, dec_cfg=dec_cfg, model=model, H=cfg.hidden_size, V=V,
              D=cfg.head_dim, supp=supp, real_attend=tk._attend,
              real_pc=cpm_mod.predict_codes, timed=event_ms)
    src = open("chip_smoke.py").read()

    def cut(first, after):
        i = src.index(first)
        return textwrap.dedent(src[i:src.index(after, i)])

    for first, after in SECTIONS:
        exec(cut(first, after), ns)
    t0 = time.time()
    try:
        exec(compile(cut(*PHASE_U), "chip_smoke.py phase u", "exec"), ns)
    finally:
        tk._attend, cpm_mod.predict_codes = ns["real_attend"], ns["real_pc"]
    log(f"phase u alone took {time.time() - t0:.1f} s  [{smi}]")


if __name__ == "__main__":
    main()
