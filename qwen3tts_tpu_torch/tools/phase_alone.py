"""One of chip_smoke.py's later phases alone, without the phases before it:
``v`` (multi-GPU), ``w`` (the CLI and the activation profiler) or ``y``
(the lockstep batch and the service on the packed model).

Imports ``chip_smoke`` from the current directory and calls its own setup
and phase function. Run it from the root of a checkout,

    python3 qwen3tts_tpu_torch/tools/phase_alone.py v   # or w, y

* ``v``: ``weights_06b`` and ``custom_voice_model`` (the 0.6B CustomVoice
  model with int8 fused weights from ``host_init``, a random vocoder, the
  stub tokenizer), then ``phase_v``. On a machine with 2, 4 or 8 cards the
  meshes span every card; with one card, or another count, phase v names
  cuda:0 twice.
* ``w``: the 0.6B int4 (group 64) checkpoint written to a temporary
  directory (``checkpoint_arrays``, ``write_checkpoint``, ~40 s), then
  ``phase_w``.
* ``y``: the same checkpoint loaded with ``from_pretrained(...,
  keep_packed=True)`` and the stub tokenizer, then ``phase_y``.

The phase's checks raise as in chip_smoke; the numbers it prints carry the
card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from qwen3tts_tpu_torch.ops import _cuda  # noqa: E402
from qwen3tts_tpu_torch.tools._card import card, require_cuda  # noqa: E402


def main() -> None:
    phase = sys.argv[1] if len(sys.argv) > 1 else ""
    if phase not in ("v", "w", "y"):
        raise SystemExit("usage: phase_alone.py v|w|y")
    dev = require_cuda("phase_alone")
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke's main
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    t0 = time.time()
    _cuda.library()
    print(f"kernels built in {time.time() - t0:.1f} s; {torch.cuda.device_count()} card(s)  "
          f"[{smi}]", flush=True)
    if phase == "v":
        cfg, dec_cfg, talker_b, cp_b, talker_p, cp_p, voc_p = chip_smoke.weights_06b(dev)
        model = chip_smoke.custom_voice_model(cfg, dec_cfg, talker_p, cp_p, voc_p, dev)
        t0 = time.time()
        chip_smoke.phase_v(dev, smi, cfg, model, talker_b, cp_b, voc_p)
    else:
        cfg = chip_smoke.config_06b()
        with tempfile.TemporaryDirectory(prefix="qt_ckpt_") as ckpt:
            chip_smoke.write_checkpoint(
                ckpt, chip_smoke.checkpoint_arrays(chip_smoke.talker_json(cfg)), packed_group=64)
            if phase == "w":
                t0 = time.time()
                chip_smoke.phase_w(dev, smi, cfg, ckpt)
            else:
                from synthetic_ckpt import StubTokenizer

                from qwen3tts_tpu_torch.tts import Qwen3TTSModel

                packed = Qwen3TTSModel.from_pretrained(ckpt, keep_packed=True)
                packed.tokenizer = StubTokenizer(cfg.text_vocab_size)
                t0 = time.time()
                print(chip_smoke.phase_y(dev, smi, cfg, packed), flush=True)
    print(f"phase {phase} alone took {time.time() - t0:.1f} s  [{smi}]", flush=True)


if __name__ == "__main__":
    main()
