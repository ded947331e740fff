"""Command-line synthesis with the PyTorch/CUDA port (port of
qwen3tts_tpu/cli.py): the same flags, the same printed metrics (load time,
sample count, generation time, RTF, tokens/s, peak device memory) and the
same activation-profiling run over 20 multilingual texts.

    python -m qwen3tts_tpu_torch.cli --model /path/to/ckpt --text "Hello" \
        --speaker Aiden --output out.wav [--profile]

It runs on the CUDA card; ``--device cpu`` runs it on the CPU (the port's
counterpart of choosing the JAX platform). Where no card is present and
none other was asked for, loading raises (exit 1), with no fallback.
Exit codes: 0 done, 1 a ``Qwen3TTSError``, 2 bad arguments.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


# The reference's 20 profiling fixtures, verbatim text + per-text language
# tag (reference main.swift:172-198, `profilingTexts`).
PROFILING_TEXTS = [
    # English — various styles and lengths
    ("Hello, my name is Aiden. Nice to meet you.", "en"),
    ("The quick brown fox jumps over the lazy dog.", "en"),
    ("Please remember to take your medication at eight o'clock tonight.", "en"),
    ("Wow, that's absolutely incredible! I can't believe it!", "en"),
    ("The weather forecast shows heavy rain tomorrow with temperatures dropping to forty degrees.", "en"),
    ("One, two, three, four, five, six, seven, eight, nine, ten.", "en"),
    ("I'm sorry to hear that. Is there anything I can do to help?", "en"),
    ("According to the latest research, artificial intelligence is transforming healthcare.", "en"),
    ("Good morning! How did you sleep last night?", "en"),
    ("The restaurant is located at three hundred and twenty five Main Street.", "en"),
    # Chinese — various styles
    ("你好，我是你的智能助手，有什么可以帮助你的吗？", "chinese"),
    ("今天天气真不错，适合出去散步。", "chinese"),
    ("请注意，前方路口即将变为红灯，请减速慢行。", "chinese"),
    ("根据最新的研究报告，人工智能技术正在快速发展。", "chinese"),
    ("一二三四五六七八九十，百千万。", "chinese"),
    # Japanese
    ("こんにちは、今日はいい天気ですね。", "japanese"),
    ("東京の桜がとても綺麗です。", "japanese"),
    # Korean
    ("안녕하세요, 만나서 반갑습니다.", "korean"),
    # More English with different patterns
    ("Shh, be very quiet. The baby is sleeping.", "en"),
    ("BREAKING NEWS: Scientists discover new species in the deep ocean!", "en"),
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qwen3tts_tpu_torch", description="Qwen3-TTS synthesis on CUDA (PyTorch port)"
    )
    # short flags mirror the reference CLI (main.swift:41-58)
    p.add_argument("-m", "--model", required=True, help="checkpoint directory")
    p.add_argument("-t", "--text", default=None, help="text to synthesize")
    p.add_argument(
        "-i", "--instruct", default=None, help="voice description / style instruction"
    )
    p.add_argument(
        "-s", "--speaker", default=None, help="speaker name (CustomVoice/Base)"
    )
    p.add_argument("-o", "--output", default="output.wav", help="output WAV path")
    p.add_argument("-l", "--language", default="auto")
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--top-k", type=int, default=50)
    p.add_argument("--top-p", type=float, default=1.0)
    # default None so each path keeps its own API default (1.05 generate,
    # 1.5 voice clone) unless the user overrides it
    p.add_argument("--repetition-penalty", type=float, default=None)
    p.add_argument("--max-tokens", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reference-audio", default=None, help="voice-clone reference WAV")
    p.add_argument("--reference-text", default=None, help="voice-clone reference transcript")
    p.add_argument("--profile", action="store_true", help="activation-profiling run")
    p.add_argument("--profile-output", default="activation_profile.json")
    p.add_argument("--stream", action="store_true", help="print token events as generated")
    p.add_argument("--device", default="cuda", help="torch device of the model (cuda, cpu)")
    return p


def run_generation(args, model) -> int:
    from .utils.audio import load_wav, save_wav

    if args.text is None:
        print("error: --text is required", file=sys.stderr)
        return 2

    on_token = None
    if args.stream:
        def on_token(t):
            print(f"token {t}", flush=True)

    t0 = time.time()
    if args.reference_audio:
        if not args.reference_text:
            print("error: --reference-text is required with --reference-audio", file=sys.stderr)
            return 2
        sr, ref = load_wav(args.reference_audio)
        if sr != model.sample_rate:
            print(f"error: reference audio must be {model.sample_rate} Hz (got {sr})",
                  file=sys.stderr)
            return 2
        audio = model.generate_voice_clone(
            args.text,
            reference_audio=ref,
            reference_text=args.reference_text,
            language=args.language,
            temperature=args.temperature,
            top_k=args.top_k,
            top_p=args.top_p,
            repetition_penalty=(
                1.5 if args.repetition_penalty is None else args.repetition_penalty
            ),
            max_tokens=args.max_tokens,
            seed=args.seed,
            on_token=on_token,
        )
    else:
        audio = model.generate(
            args.text,
            speaker=args.speaker,
            instruct=args.instruct,
            language=args.language,
            temperature=args.temperature,
            top_k=args.top_k,
            top_p=args.top_p,
            repetition_penalty=(
                1.05 if args.repetition_penalty is None else args.repetition_penalty
            ),
            max_tokens=args.max_tokens,
            seed=args.seed,
            on_token=on_token,
        )
    gen_time = time.time() - t0

    audio = np.asarray(audio)
    duration = audio.shape[0] / model.sample_rate
    save_wav(args.output, audio, model.sample_rate)
    rtf = gen_time / duration if duration > 0 else float("inf")
    print(f"Generated {audio.shape[0]} samples ({duration:.2f}s audio)")
    print(f"Generation time: {gen_time:.2f}s")
    print(f"RTF (gen_time/audio_duration, lower is better): {rtf:.3f}")
    print(f"Saved to: {args.output}")
    # reference main.swift:294-313: tokens/s + peak memory after a run
    info = model.last_info
    if info is not None:
        print(f"Generation tokens/s: {info.tokens_per_second:.2f}")
        print(f"Peak memory: {info.peak_memory_usage:.2f} GB")
    return 0


def run_profiling(args, model) -> int:
    from .utils.profiler import ActivationProfiler

    profiler = ActivationProfiler()
    profiler.enable(
        num_layers=model.talker_cfg.num_hidden_layers,
        intermediate_size=model.talker_cfg.intermediate_size,
    )
    model.activation_profiler = profiler
    total_t0 = time.time()
    # per-text language tag, as the reference's profiling loop passes
    # (main.swift:347-359)
    for i, (text, language) in enumerate(PROFILING_TEXTS):
        print(f"[{i + 1}/{len(PROFILING_TEXTS)}] \"{text[:50]}...\" (lang={language})")
        try:
            audio = model.generate(
                text,
                speaker=args.speaker,
                instruct=args.instruct,
                language=language,
                temperature=args.temperature,
                top_k=args.top_k,
                max_tokens=args.max_tokens,
                seed=i,
            )
        except Exception as e:  # keep profiling robust across languages
            print(f"  skipped: {e}")
            continue
        audio = np.asarray(audio)
        print(f"    -> {audio.shape[0] / model.sample_rate:.1f}s audio, "
              f"{audio.shape[0]} samples")
        profiler.flush_run()
    print(f"Profiling took {time.time() - total_t0:.1f}s")
    profiler.print_summary()
    profiler.save_json(args.profile_output)
    info = model.last_info
    if info is not None:
        print(f"Peak memory: {info.peak_memory_usage:.2f} GB")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .tts import Qwen3TTSError, Qwen3TTSModel

    try:
        t0 = time.time()
        model = Qwen3TTSModel.from_pretrained(args.model, device=args.device)
        print(f"Model loaded in {time.time() - t0:.2f}s ({model.tts_model_type})")
        if model.supported_speakers:
            print(f"Speakers: {', '.join(model.supported_speakers)}")
        if args.profile:
            return run_profiling(args, model)
        return run_generation(args, model)
    except Qwen3TTSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
