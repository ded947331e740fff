"""Greedy-parity harness of the PyTorch/CUDA port (port of
tools/parity_harness.py): one runnable script for real-checkpoint
validation, whose dump the JAX harness's ``--compare`` reads too.

  1. **Vocoder stage stats**: the reference's golden [5, 16] code matrix
     through the decoder stage by stage (quantizer -> pre_conv ->
     pre_transformer -> upsample stages -> main decoder), mean/std/min/max
     of each stage.
  2. **Greedy token sequence**: a fixed prompt decoded at temperature 0
     (deterministic, so comparable across implementations without porting
     their RNGs).
  3. **Waveform**: the greedy utterance's audio as WAV and raw f32 npy.
  4. Optionally a **reference-exact top-p** sampled run
     (``--ref-exact-top-p`` with ``--temperature`` > 0).

It runs on the CUDA card unless ``--device cpu`` is given.

Usage:
  python -m qwen3tts_tpu_torch.tools.parity_harness --model /path/to/Qwen3-TTS-12Hz-0.6B \
      --out parity_out --speaker Aiden
  # the synthetic checkpoint (tools/ckpt_layout.py), written to OUT/checkpoint:
  python -m qwen3tts_tpu_torch.tools.parity_harness --synthetic --out parity_out
  # diff two dumps (this port's against the JAX package's, or any two):
  python -m qwen3tts_tpu_torch.tools.parity_harness --compare A/parity.json B/parity.json

Exit code 0 = ran (or compared within tolerance); 1 = comparison failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# golden codes from the reference test (Qwen3TTSTests.swift:37-43)
GOLDEN_CODES = [
    [1342, 313, 975, 826, 309, 933, 1642, 28, 782, 1965, 1680, 1507, 258, 1349, 828, 1102],
    [1014, 17, 2016, 285, 1712, 470, 543, 176, 1087, 1963, 588, 1860, 889, 1874, 1121, 1319],
    [1119, 1122, 594, 89, 770, 1644, 331, 242, 1183, 1676, 129, 96, 123, 1840, 661, 285],
    [1119, 1135, 215, 1377, 88, 1611, 904, 1274, 1895, 1872, 1246, 335, 1141, 320, 694, 242],
    [46, 1952, 1023, 1871, 596, 491, 757, 422, 692, 683, 651, 395, 1235, 1300, 618, 1498],
]

GREEDY_PROMPT = "The quick brown fox jumps over the lazy dog."

# python-impl expected stats for the golden codes on the real 0.6B
# checkpoint (reference Qwen3TTSTests.swift comments :75,:274-275)
PYTHON_EXPECTED = {"quantizer": {"std": 12.889, "min": -81.556}, "audio": {"std": 0.1712}}


def _stats(x: np.ndarray) -> dict:
    x = np.asarray(x, np.float32)
    return {
        "shape": list(x.shape),
        "mean": float(x.mean()),
        "std": float(x.std()),
        "min": float(x.min()),
        "max": float(x.max()),
    }


# our stage key -> the reference golden test's section header + value name
# (Qwen3TTSTests.swift print statements; comparison is a textual diff)
_GOLDEN_SECTIONS = [
    ("quantizer", "After quantizer.decode", "quantized"),
    ("pre_conv", "After pre_conv", "pre_conv"),
    ("pre_transformer", "After pre_transformer", "transformer"),
    ("upsample0", "After upsample block 0", "stats"),
    ("upsample1", "After upsample block 1", "stats"),
    ("decoder", "After main decoder", "stats"),
    ("audio", "Final audio", "stats"),
]


def _print_golden_format(stages: dict) -> None:
    """Emit stage stats in the reference golden test's exact print format
    (Qwen3TTSTests.swift:70-253), so the day real weights land the diff
    against the Swift/Python comment blocks is a line-by-line eyeball:

        === After quantizer.decode ===
        quantized stats: min=-81.5562, max=56.5420, mean=..., std=12.8890
    """
    print("\n---- reference golden-test format ----")
    for key, header, label in _GOLDEN_SECTIONS:
        if key not in stages:
            continue
        s = stages[key]
        print(f"=== {header} ===")
        print(f"{label} shape: {s['shape']}")
        print(
            f"{label} stats: min={s['min']:.4f}, max={s['max']:.4f}, "
            f"mean={s['mean']:.6f}, std={s['std']:.4f}"
        )


def run(args) -> int:
    import torch

    from ..models import vocoder as vc
    from ..tts import Qwen3TTSModel
    from ..utils.audio import save_wav

    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        from . import ckpt_layout

        model_path = ckpt_layout.write_checkpoint(os.path.join(args.out, "checkpoint"))
        model = Qwen3TTSModel.from_pretrained(model_path, dtype=torch.float32, device=args.device)
        model.tokenizer = ckpt_layout.StubTokenizer()
    else:
        model = Qwen3TTSModel.from_pretrained(args.model, device=args.device)
    model.ref_exact_top_p = args.ref_exact_top_p

    report: dict = {"model": args.model or "synthetic", "stages": {}, "greedy": {}}

    # 1. vocoder stage stats on the golden codes
    codes = torch.tensor(GOLDEN_CODES, dtype=torch.int32, device=model.device)[None]
    stages = vc.decode_stages(model.vocoder_params, model.tokenizer_config.decoder_config, codes)
    stages = {name: val.float().cpu().numpy() for name, val in stages.items()}
    for name, val in stages.items():
        report["stages"][name] = _stats(val)
        print(f"stage {name:16s} {report['stages'][name]}")
    _print_golden_format(report["stages"])
    np.save(os.path.join(args.out, "golden_audio.npy"), stages["audio"][0])

    # 2+3. greedy generation: deterministic token sequence + waveform
    tokens: list[int] = []
    kwargs = dict(
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        repetition_penalty=args.repetition_penalty,
        max_tokens=args.max_tokens,
        seed=args.seed,
        on_token=tokens.append,
    )
    if model.config.tts_model_type == "voice_design":
        audio = model.generate(GREEDY_PROMPT, instruct="A clear, calm female voice.", **kwargs)
    else:
        speaker = args.speaker or (model.supported_speakers[0] if model.supported_speakers else None)
        audio = model.generate(GREEDY_PROMPT, speaker=speaker, **kwargs)
    audio = np.asarray(audio, np.float32)
    report["greedy"] = {
        "prompt": GREEDY_PROMPT,
        "temperature": args.temperature,
        "tokens": tokens,
        "n_tokens": len(tokens),
        "audio": _stats(audio),
    }
    print(f"greedy: {len(tokens)} tokens, audio {report['greedy']['audio']}")
    np.save(os.path.join(args.out, "greedy_audio.npy"), audio)
    save_wav(os.path.join(args.out, "greedy.wav"), audio)

    with open(os.path.join(args.out, "parity.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}/parity.json, greedy.wav, *.npy")

    # against real weights, also check the python-pinned golden stats
    if not args.synthetic:
        q = report["stages"]["quantizer"]
        ok = q["std"] > 10.0 and abs(q["min"] + 81.5) < 5.0
        print(f"golden quantizer stats vs python pins: {'OK' if ok else 'MISMATCH'}")
        return 0 if ok else 1
    return 0


def compare(path_a: str, path_b: str, wav_tol: float = 1e-3) -> int:
    """Diff two parity.json dumps (+ their .npy waveforms if adjacent)."""
    a, b = json.load(open(path_a)), json.load(open(path_b))
    rc = 0
    for name in sorted(set(a["stages"]) & set(b["stages"])):
        sa, sb = a["stages"][name], b["stages"][name]
        for k in ("mean", "std", "min", "max"):
            if abs(sa[k] - sb[k]) > max(1e-3, 1e-3 * abs(sa[k])):
                print(f"STAGE DIFF {name}.{k}: {sa[k]:.6f} vs {sb[k]:.6f}")
                rc = 1
    ta, tb = a["greedy"]["tokens"], b["greedy"]["tokens"]
    if ta != tb:
        n = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y), min(len(ta), len(tb)))
        print(f"GREEDY TOKEN DIFF: first divergence at step {n} ({len(ta)} vs {len(tb)} tokens)")
        rc = 1
    for fname in ("golden_audio.npy", "greedy_audio.npy"):
        fa = os.path.join(os.path.dirname(path_a), fname)
        fb = os.path.join(os.path.dirname(path_b), fname)
        if os.path.exists(fa) and os.path.exists(fb):
            wa, wb = np.load(fa), np.load(fb)
            if wa.shape != wb.shape:
                print(f"WAVEFORM SHAPE DIFF {fname}: {wa.shape} vs {wb.shape}")
                rc = 1
            else:
                dev = float(np.abs(wa - wb).max())
                print(f"{fname}: max deviation {dev:.2e} (tol {wav_tol})")
                if dev > wav_tol:
                    rc = 1
    print("PARITY OK" if rc == 0 else "PARITY FAILED")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default=os.environ.get("QWEN3_TTS_VOICEDESIGN_MODEL_PATH"))
    ap.add_argument("--synthetic", action="store_true",
                    help="write and use the synthetic checkpoint (tools/ckpt_layout.py)")
    ap.add_argument("--out", default="parity_out")
    ap.add_argument("--speaker", default=None)
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy (default)")
    ap.add_argument("--top-k", type=int, default=50)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--repetition-penalty", type=float, default=1.0)
    ap.add_argument("--max-tokens", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ref-exact-top-p", action="store_true",
                    help="reproduce the reference's unnormalized-exp top-p")
    ap.add_argument("--device", default="cuda", help="torch device of the model (cuda, cpu)")
    ap.add_argument("--compare", nargs=2, metavar=("A.json", "B.json"))
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not args.synthetic and not args.model:
        ap.error("--model (or QWEN3_TTS_VOICEDESIGN_MODEL_PATH) or --synthetic required")
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
