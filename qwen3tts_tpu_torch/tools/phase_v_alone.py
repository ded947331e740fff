"""chip_smoke.py's phase v (multi-GPU) alone: the dp and TP checks and
numbers without the phases before it.

Imports ``chip_smoke`` from the current directory and calls its own setup
(``weights_06b``, ``custom_voice_model``: the 0.6B CustomVoice model with
int8 fused weights from ``host_init``, a random vocoder, the stub
tokenizer) and its ``phase_v``. Run it from the root of a checkout,

    python3 qwen3tts_tpu_torch/tools/phase_v_alone.py

on a machine with 2, 4 or 8 cards to run the meshes over every card (with
one card, or another count, phase v names cuda:0 twice). Phase v's checks
raise as in chip_smoke; the numbers it prints carry the card's name and
power limit.
"""

from __future__ import annotations

import os
import sys
import time

sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from qwen3tts_tpu_torch.ops import _cuda  # noqa: E402
from qwen3tts_tpu_torch.tools._card import card, require_cuda  # noqa: E402


def main() -> None:
    dev = require_cuda("phase_v_alone")
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke's main
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    t0 = time.time()
    _cuda.library()
    print(f"kernels built in {time.time() - t0:.1f} s; {torch.cuda.device_count()} card(s)  "
          f"[{smi}]", flush=True)
    cfg, dec_cfg, talker_b, cp_b, talker_p, cp_p, voc_p = chip_smoke.weights_06b(dev)
    model = chip_smoke.custom_voice_model(cfg, dec_cfg, talker_p, cp_p, voc_p, dev)
    t0 = time.time()
    chip_smoke.phase_v(dev, smi, cfg, model, talker_b, cp_b, voc_p)
    print(f"phase v alone took {time.time() - t0:.1f} s  [{smi}]", flush=True)


if __name__ == "__main__":
    main()
