"""A lockstep batch of texts: what ``Qwen3TTSModel.generate_batch`` runs
for one group (``_codes_batch``: the prompts, one batched prefill,
``batch_generate``'s lockstep to each row's cap; then
``_decode_audio_list``'s batched vocoder calls), with the caps set to the
requests' frame counts and the mix's ``SamplingConfig`` (EOS forbidden),
through ``batch_generate.generate_codes_batch``, the function beneath
``_codes_batch`` that takes per-row caps."""

from __future__ import annotations

import time

import numpy as np

from harness import Record


def serve(bench, unit) -> list[Record]:
    import torch

    from qwen3tts_tpu_torch import tts
    from qwen3tts_tpu_torch.models import batch_generate as bg
    from qwen3tts_tpu_torch.models import talker as tk
    from qwen3tts_tpu_torch.models.generate import pad_to_bucket

    m = bench.model
    reqs = unit.requests
    B = len(reqs)
    t0 = time.perf_counter()
    built = m._build_batch_inputs([r.text for r in reqs], [r.speaker for r in reqs], [None] * B,
                                  "auto")
    p_bucket = pad_to_bucket(max(e.shape[1] for e, _, _ in built))
    t_bucket = pad_to_bucket(max(t.shape[0] for _, t, _ in built))
    pad = torch.nn.functional.pad
    prefill = torch.stack([pad(e[0].to(m.dtype), (0, 0, 0, p_bucket - e.shape[1]))
                           for e, _, _ in built])
    trailing = torch.stack([pad(t.to(m.dtype), (0, 0, 0, t_bucket - t.shape[0]))
                            for _, t, _ in built])
    caps = [r.frames for r in reqs]
    max_frames = pad_to_bucket(max(caps), tts.GEN_BUCKETS)
    cache_len = -(-(p_bucket + max_frames) // 128) * 128
    res = bg.generate_codes_batch(
        m.talker_params, m.cp_params, talker_cfg=m.talker_cfg, cp_cfg=m.cp_cfg,
        sampling=bench.sampling(reqs[0]), prefill_embeds=prefill,
        prefill_lens=[e.shape[1] for e, _, _ in built], trailing_embeds=trailing,
        trailing_lens=[t.shape[0] for _, t, _ in built], tts_pad_embed=built[0][2].to(m.dtype),
        max_steps=caps, max_frames=max_frames, seed=unit.seed,
        cache=tk.make_cache(m.talker_cfg, B, cache_len, m.dtype, m.device, quantized=m.kv_quant),
    )
    n = res.n_frames.cpu().numpy()
    audio = m._decode_audio_list(res.codes, np.maximum(n, 1))
    t1 = time.perf_counter()
    return [Record(r, unit.index, t0, t1, int(n[b]), audio[b] if n[b] else audio[b][:0],
                   res.codes[b, : n[b]]) for b, r in enumerate(reqs)]
