"""One client streaming one utterance at a time: what
``Qwen3TTSModel.generate_stream(..., audio_chunk_frames=N)`` runs (the
prompt and ``_prep_run`` at the call, then ``_generate_stream_events``:
prefill, the first chunk, chunks of ``generate_chunk`` read back at their
ends, windowed vocoder calls, the closing whole decode), called with the
mix's ``SamplingConfig`` (EOS forbidden) and the request's frame count as
its cap. Each request is consumed to its closing ``AudioEvent``."""

from __future__ import annotations

import time

from harness import Record


def serve(bench, unit) -> list[Record]:
    from qwen3tts_tpu_torch.tts import AudioChunkEvent, AudioEvent, TokenEvent

    m = bench.model
    req = unit.requests[0]
    seen = []
    inner = type(m)._stream_codes

    def watched(*args, **kwargs):
        """Keeps the codes the stream's last chunk read back, and ends a
        stream whose chunk did not advance its step (it would never end)."""
        last = -1
        for item in inner(m, *args, **kwargs):
            _, step, codes, done, _ = item
            if step <= last and not done:
                raise RuntimeError(f"the stream's step stayed at {step}")
            last = step
            seen[:] = [codes]
            yield item

    m._stream_codes = watched
    try:
        t0 = time.perf_counter()
        embeds, trailing, pad = m._route_stream_inputs(req.text, req.speaker, None, "auto")
        prep = m._prep_run(embeds, trailing, pad, req.frames)
        first_token = first_audio = audio = None
        tokens = 0
        for ev in m._generate_stream_events(req.text, prep, bench.sampling(req), req.frames,
                                            req.seed, bench.traffic["audio_chunk_frames"]):
            if isinstance(ev, TokenEvent):
                tokens += 1
                first_token = first_token or time.perf_counter()
            elif isinstance(ev, AudioChunkEvent):
                first_audio = first_audio or time.perf_counter()
            elif isinstance(ev, AudioEvent):
                audio = ev.audio
        t1 = time.perf_counter()
    finally:
        del m._stream_codes
    codes = seen[-1][:tokens] if seen else None
    return [Record(req, unit.index, t0, t1, tokens, audio, codes, first_token, first_audio)]
