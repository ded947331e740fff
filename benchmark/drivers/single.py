"""One client, one utterance at a time: what ``Qwen3TTSModel.generate``
runs for a CustomVoice request (the prompt, ``_prep_run``, then
``tts._generate_and_decode``: prefill, the frame loop of ``generate_chunk``,
one vocoder call on the smallest bucket), called with the mix's
``SamplingConfig`` (EOS forbidden) and the request's frame count as its cap."""

from __future__ import annotations

import time

from harness import Record


def serve(bench, unit) -> list[Record]:
    from qwen3tts_tpu_torch import tts

    m = bench.model
    req = unit.requests[0]
    t0 = time.perf_counter()
    embeds, trailing, pad = m._prepare_generation_inputs(req.text, language="auto",
                                                         speaker=req.speaker)
    prep = m._prep_run(embeds, trailing, pad, req.frames)
    dec = m.tokenizer_config.decoder_config
    codes, n, wav, lengths = tts._generate_and_decode(
        m.talker_params, m.cp_params, m.vocoder_params, talker_cfg=m.talker_cfg,
        cp_cfg=m.cp_cfg, sampling=bench.sampling(req), dec_cfg=dec, **prep,
        max_steps=req.frames, seed=req.seed,
    )
    out = wav[0, : n * dec.total_upsample].float().cpu().numpy()
    valid = int(lengths[0])
    if 0 < valid < out.shape[0]:
        out = out[:valid]
    return [Record(req, unit.index, t0, time.perf_counter(), n, out, codes[:n])]
