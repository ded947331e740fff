#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (qwen3tts_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and the CUDA toolkit (nvcc), builds the port's
kernels from csrc/, and runs, in order:

  1. the card: name, power limit, torch / CUDA / nvcc versions;
  2. the kernel build (its seconds);
  3. K1 at B = 1 (the persistent step of csrc/talker_frame.cu, one
     cooperative launch; B > 1 runs csrc/talker_step.cu) against its
     plain PyTorch version at the 0.6B talker shapes on a prefilled cache: greedy code0 equal, hidden and
     k/v rows within a bf16 bound, and sampled code0 equal over 32 seeds
     at temperature 0.9 / top-k 50 (a mismatch only on a logit near-tie),
     with EOS suppressed and with EOS unsuppressed just below the k-th
     logit (the sampler's EOS restore; top-k 50 and 1); then the same
     bounds at position 6000 of a 6144-row cache (a tiled online softmax);
  4. K2 (csrc/cp_loop.cu) against its plain version at the 0.6B code
     predictor shapes: greedy codes teacher-forced, esum, sampled codes (at
     B=1 one persistent cooperative launch per frame);
  5. the main path: ``Qwen3TTSModel.generate`` at the full 0.6B
     CustomVoice widths (synthetic host_init weights, fused and int8,
     full-size f32 vocoder), checking that K1 and K2 carried every frame
     (their launch counters; every K1 step the persistent B = 1 one) and
     that the waveform is finite and sized;
  6. the headline: a 66-frame ``forbid_eos`` utterance, wall time, RTF and
     ms per frame with the kernels beside the plain path's, and the times of
     the two once-per-utterance stages (prefill, vocoder);
  7. K4 (csrc/quant_matmul.cu) against its plain version at every packed
     single-row shape of the 0.6B path (talker q/k/v/o/gate/up/down, the
     codec head on an f32 row, the CP layers and lm_head), for int4 group
     64, int4 group 32 and int8 group 64: scaled error and us per call,
     timed over 64 MB of copies of the weight in turn, and at 3072 x 1024
     ``torch._weight_int4pack_mm`` on the same weights beside it;
  8. K3 (csrc/decode_attention.cu, one launch a call) against its plain
     version at pos 40 and 4000 of a 4096-row cache, 6000 of 6144 and on a
     chunk boundary, in both cache layouts: scaled error and ms per call,
     timed over the 28 layers' caches in turn (K3's and K4's times are
     device time per call from torch.profiler, beside the time per call of
     back-to-back calls from Python, which the host bounds; neither finds
     its inputs in the L2); at pos 4000, K3 beside
     ``scaled_dot_product_attention`` and its bound;
  9. the packed main path: a 0.6B int4 (group 64) MLX checkpoint written to
     a temporary directory by tests/synthetic_ckpt.py's numpy functions, then
     ``Qwen3TTSModel.from_pretrained(dir, keep_packed=True).generate()``:
     packed leaves, K4's launch count by formula, K1/K2 untouched, a finite
     waveform of n x 1920 samples; then the default load of the same
     directory (int8, fused) runs K1 and K2;
 10. packed teacher-forced greedy codes over 8 frames: K4 against the plain
     ``quant_matmul`` at every sampled position (equal but for near-ties);
 11. the packed headline (66 frames, K4 beside plain quant_matmul) and the
     long cache: 32 frames on a 4096-row cache, K3 launched 28 times per
     decode step, ms per talker step with K3 beside the plain masked
     attention over all 4096 rows; then one torch.profiler window over 5
     packed frames: device busy share, device ms per frame in K4, K3 and
     the rest;
  a. K1 at B = 8 and 64 rows at ragged offsets against its plain version
     (every GEMV on the tensor cores at B > 1, as K2's),
     both modes, on prefilled 128-row bf16 and 512-row int8 caches (within
     the bf16 bound), and at B=64 on a random 512-row int8 cache, where
     both are held against a float64 step written from the model's maths;
  b. K2 at B = 8 and 64 against its plain version (its GEMVs on the tensor
     cores at B > 1); at B=64 its device time split by kernel (GEMV,
     attention, sampler, finishing) in ``wo_bf16`` and ``dyn_int8``, and
     its batched GEMV alone at the CP's five shapes beside the CUDA-core
     form and one library call (``torch.matmul``, ``torch._int_mm``);
  c. ``generate_batch`` of 8 texts on a bf16 and an int8 cache, one K1 and
     one K2 per lockstep frame;
  d. the batched grid: ``generate_codes_batch``, 66 frames, B in {8, 16,
     32, 48, 64} x {128-row bf16, 512-row int8}: ms per lockstep frame,
     codec tokens/s, per-sequence RTF; K1/K2 device time per frame beside
     the bounds; the plain path at B=8; a profiled window at B=64;
  e. ``generate()`` on an int8 cache: launches, the 66-frame RTF beside
     phase 6's, and K1's device time and the decode loop on each cache;
  f. K1 in bf16 mode (dense bf16 weights, no scales) against its plain
     version at 0.6B, B = 1, 8 and 64, on prefilled bf16 and int8 caches,
     within the bounds of phases 3 and a;
  g. K1 at the 1.7B widths (H 2048, I 6144), int8 and bf16, B = 1 and 64;
     K2 on bf16 weights at 0.6B and at 1.7B (the small-to-MTP projection
     2048 -> 1024, int8 and bf16), B = 1 and 64: teacher-forced greedy
     logits, esum and codes against the plain versions (bounds of phases 4
     and b);
  h. the bf16 checkpoint path: phase 9's 0.6B weights written as BF16, then
     ``Qwen3TTSModel.from_pretrained(dir)`` with defaults gives fused dense
     bf16 talker and CP; ``generate()`` runs K1 on every frame after the
     first and K2 on every frame, no decode step through the plain
     per-layer loop, no plain CP loop, the plain sampler only for the
     first frame's code 0; then its 66-frame headline with K1 and K2
     device time;
  i. the 1.7B model (host_init trees, int8 and bf16) through
     ``Qwen3TTSModel.generate``: the same launch checks, the headline;
  j. ``generate_batch`` of 8 texts on the bf16 checkpoint and at 1.7B int8
     (one K1 and one K2 per lockstep frame), and one B=64 lockstep cell for
     each: ms per frame, codec tokens/s;
  k. the ``dyn_int8`` mode (per-row int8 activations, s8 x s8 -> s32)
     against the plain versions, within the bounds of phases 3, a, 4 and b:
     K1 at 0.6B, B = 1, 8 and 64 on prefilled 128-row bf16 and 512-row int8
     caches, and at 1.7B, B = 1 and 64; K2 at 0.6B, B = 1 and 64, and at
     1.7B with its projection (which stays bf16); K2 on unfused int8 layers
     in both modes at B = 1 and 64; K5's port (ops/cp_kernel_old.py) at B=1
     in both modes. Each with events and device ms beside the same inputs'
     ``wo_bf16`` times and the bound (operations over the int8 rate); the
     library's operations per call (K1, K2 and K5 at B=1: 2, the persistent
     step's or frame's memset and launch);
  l. the main path in dyn_int8 (QWEN3TTS_TK_MODE and QWEN3TTS_CPK_MODE set
     in-process, then restored): ``generate()`` at 0.6B and 1.7B int8 with
     every K1 and K2 launch counted under dyn_int8 and no plain path; the
     66-frame headline beside phase 6's, its decode loop in turns with
     ``wo_bf16``'s; a B=64 lockstep cell in each mode, in turns;
  m. an unfused int8 CP through ``Qwen3TTSModel(...).generate()``: K2 on
     every frame with the plain CP loop made to raise; then ``generate()``
     with K5's port in place of K2's wrapper, one K5 launch per frame;
  n. the top-p stage of the kernels' sampler: K1 (B = 1, 8, 64) and K2
     (B = 1, 64) at top_p 0.8 and 0.95, top-k 50 and 0, ref_exact_top_p off
     and on, their codes against ``sample_row`` on their own logits (equal
     but for flips at the top-p cut, counted); the stage's cost at B = 1
     and 64 in turns; ``generate()`` and ``generate_batch()`` with top_p 0.9
     (and ref_exact_top_p) on K1 and K2 with the plain CP loop and the plain
     sampler (after the first frame) raising; the 66-frame decode loop at
     top_p 0.9 beside 1.0 in turns;
  o. the experiment kernels of qwen3tts_tpu_torch/tools against their plain
     versions, then their scripts' timings at a reduced count: T7's weight
     stream (dma4, dma12, dma1, beside K1 as the full step), T6's ablated
     B=1 step (full, noattn, nomlp, dma over 66 steps), T3's sustained read
     (4-32 MiB blocks, beside a torch reduction);
  p. the last four experiment kernels against their plain versions on the
     card: T1's attention forms (a, b, c, c2 at full size, 4 iterations,
     within 1e-3 scaled), T4's mxu and plane variants at the four talker
     shapes (within 1e-4 scaled), T5's KV append at L 28, B 32, T 256 with
     offsets at both ends, at 8k + 7 and outside the cache (bit-equal) and
     T2's twelve probes on random inputs (exact; p6 within 1e-5 scaled);
     then each script's ``main`` at a reduced count (T1 at n = 100 and 200
     iterations with the bmm yardstick, T4's device times with K4 and
     ``torch._weight_int4pack_mm`` beside them, T5's four appends in the
     script's order with ``index_put_``, T2's probes on the script's inputs
     with an empty kernel's floor, ``torch._int_mm`` beside p2 and
     ``x @ w.to(bf16)`` beside p6), every launch counter from 0, each
     kernel launched in that run. Its kernels' times are queued on the card
     behind a spin kernel (no host, no profiler in the way); phases 7 and 8
     read only profiler windows that recorded every kernel of their calls;
  q. K1's persistent B = 1 step (csrc/talker_frame.cu) against its plain
     version in every mode it takes (0.6B int8 ``wo_bf16`` and
     ``dyn_int8``, 0.6B and 1.7B dense bf16, 1.7B int8, bf16 and int8
     caches, top_p 0.9, non-sample mode) at pos 40 of 256 rows and pos 4000
     of a full-width 4096-row cache of random rows (split over the SMs):
     greedy code0 equal but for near-ties, hidden, logits and the new k/v
     rows within the bounds of phases 3 and a (dyn_int8 against the float64
     step as phase k holds it), 2 operations a call where the multi-launch
     step made 8 L + 3, ms per step by events beside the plain version's
     and the bound;
  r. streaming at phase 6's 66-frame ``forbid_eos`` utterance:
     ``generate_stream(..., audio_chunk_frames=4)`` against ``generate()`` at
     the same seed (TokenEvents equal to its code-0 tokens, the AudioEvent
     bit-equal to its waveform, chunks tiling 66 x 1920 samples, one K1
     and one K2 launch a frame), TTFT, TTFA and ms per frame; the stream
     without audio chunks (its first read-back after the prefill) against
     it; ``generate_stream_async``'s events equal to the stream's;
  s. two host threads, each under its own ``torch.cuda.Stream``, streaming
     two seeds at once, and an async stream beside a stream on the main
     thread, both on the default stream: each seed's tokens and audio equal
     to its run alone (the decodes take turns on the card,
     ``generate.device_turn``), with the walls;
  t. ``generate_voice_clone`` on a Base model at 0.6B with the speaker
     encoder and the tokenizer encoder at their config widths
     (``torch.Generator`` weights) and 3 s of reference audio: K1 and K2 on
     every frame, a finite waveform in [-1, 1]; the encode and speaker
     embedding ms, the ICL prompt's length and its prefill ms;
  u. serving: K1 and K2 with per-row sampling values (serving's
     per-request mode) at B = 8 and 64, each row's codes against
     ``sample_row`` with its own values on the kernels' logits (equal but
     for counted flips at the top-p cut), a uniform table equal to the
     scalar call, ms per call beside the scalar sampler's in turns;
     ``model.serve(slots=16)`` with 32 requests of ragged caps (20-66
     frames), without and with per-request sampling (mixed rows), in
     turns: every future a finite waveform of whole frames, K1 on every
     lockstep frame and K2 on every lockstep and admission frame, the plain
     CP loop and the plain per-layer step raising, codec tokens/s and
     per-request latency p50 / p95, and the run's split into admissions,
     lockstep chunks and vocoder calls (host seconds of calls that end
     synchronised); a served run on an int8 KV cache; one greedy request's
     codes alone and behind sampled neighbours equal; the HTTP front end on
     127.0.0.1 (a NaN sampling value refused with 400, a WAV, a chunked
     WAV, a 429);
  v. multi-GPU, on every card when there are 2, 4 or 8, else on cuda:0
     named twice (the positions take turns on it): ``generate_codes_batch_dp``
     of 8 sampled rows, each shard's codes equal to its rows run alone with
     its shard seed; ``generate_batch(8 texts, dp_mesh=)`` at 0.6B int8 with
     every lockstep frame of every shard on K1 and K2 (counted per shard);
     ``serve(slots=16, dp_mesh=)`` with 16 ragged greedy requests sent at
     once: placed evenly over the shards, codes equal to the run without dp
     at a shard's slots, codec tokens/s and p50/p95 latency; at 0.6B bf16
     unfused with tp = 2, the tensor-parallel step against the unsharded
     plain step and K1's step on the fused copy (phase 3's bf16 bound,
     0.05 scaled) and in f32 against the unsharded step (1e-4), and 8
     greedy frames of ``generate()`` whose
     code 0 is the unsharded plain talker's teacher-forced choice but for
     near-ties, ms a frame;
  w. the CLI and the activation profiler: ``cli.main`` on phase 9's int4
     checkpoint (the default load: int8, fused) at 0.6B, greedy at 24
     frames (the WAV read back at 24 kHz with n x 1920 samples, the RTF,
     tokens/s and peak-memory lines, every frame on K1's persistent B = 1
     step and K2 by their counters and the library's own), the same with
     ``--stream`` (a token line a frame, the same WAV) and again without
     (warm: the same WAV, its RTF), ``--profile
     --max-tokens 16`` over the 20 texts (20 runs, 28 x 3072 maxima, every
     frame on K1 and K2), and the card's ``activation_stats`` of one
     profiled sequence against the same call in f32 on the CPU (0.05
     scaled).

The K1 comparisons in dyn_int8 (phase k) hold kernel and plain version
against a float64 step of the model's maths (the kernel within 1.5x of the
plain version's distance), not against each other within 0.05.

Any failure raises and exits non-zero. The last lines are the card's name
and power limit, one JSON object describing the kernels, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def checkpoint_arrays(talker: dict):
    """(config, weights, speech-tokenizer config, its weights): a Qwen3-TTS
    checkpoint with the talker config ``talker`` (JSON form) and a full-size
    speech-tokenizer decoder, as numpy f32 arrays from
    tests/synthetic_ckpt.py's numpy functions. The small-to-MTP projection is
    kept only where the CP is narrower than the talker."""
    import numpy as np
    from synthetic_ckpt import TINY_CONFIG, TINY_ST_CONFIG, build_main_weights, \
        build_speech_tokenizer_weights

    from qwen3tts_tpu_torch import config as C

    cfg = dict(TINY_CONFIG, talker_config=talker)
    weights = build_main_weights(cfg)
    if talker["code_predictor_config"]["hidden_size"] == talker["hidden_size"]:
        for k in [k for k in weights if "small_to_mtp_projection" in k]:
            del weights[k]
    dec = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(C.TokenizerDecoderConfig()).items()}
    st_cfg = dict(TINY_ST_CONFIG, decoder_config=dec)
    st = build_speech_tokenizer_weights(st_cfg)
    for k, v in st.items():  # conv weights: unit gain per layer (the function
        if v.ndim == 3:      # scales by the kernel width only)
            st[k] = (v / np.sqrt(v.shape[1])).astype(np.float32)
    return cfg, weights, st_cfg, st


def talker_json(cfg) -> dict:
    """``cfg`` (a TalkerConfig with the 0.6B speakers) as config.json's
    talker_config."""
    cpc = cfg.code_predictor_config
    return dict(
        vocab_size=cfg.vocab_size, text_vocab_size=cfg.text_vocab_size,
        hidden_size=cfg.hidden_size, text_hidden_size=cfg.text_hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, spk_id={"aiden": 2861, "vivian": 2862},
        code_predictor_config=dict(
            vocab_size=cpc.vocab_size, hidden_size=cpc.hidden_size,
            intermediate_size=cpc.intermediate_size, num_hidden_layers=cpc.num_hidden_layers,
            num_attention_heads=cpc.num_attention_heads,
            num_key_value_heads=cpc.num_key_value_heads, head_dim=cpc.head_dim,
            num_code_groups=cpc.num_code_groups,
        ),
    )


def write_checkpoint(path: str, arrays, packed_group: int | None = None) -> None:
    """Write ``checkpoint_arrays`` to a directory: its linear weights as MLX
    int4 (``packed_group``; the MLX selection rule of tools/ckpt_layout.py
    with the port's pack_quantized, as synthetic_ckpt's imports JAX), or
    every float tensor of the main checkpoint as BF16, the dtype Qwen
    publishes (through torch: numpy has no bf16)."""
    import torch

    from qwen3tts_tpu_torch.ops.quant import pack_quantized
    from qwen3tts_tpu_torch.tools.ckpt_layout import is_quantized_linear
    from qwen3tts_tpu_torch.utils.loader import write_safetensors

    cfg, weights, st_cfg, st = arrays
    os.makedirs(os.path.join(path, "speech_tokenizer"), exist_ok=True)
    out = {}
    if packed_group:
        cfg = dict(cfg, quantization={"group_size": packed_group, "bits": 4, "mode": "affine"})
        for k, v in weights.items():
            if is_quantized_linear(k, v.shape, packed_group):
                out[k], out[k + ".scales"], out[k + ".biases"] = pack_quantized(v, 4, packed_group)
            else:
                out[k] = v
    else:
        out = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in weights.items()}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    write_safetensors(os.path.join(path, "model.safetensors"), out)
    with open(os.path.join(path, "speech_tokenizer", "config.json"), "w") as f:
        json.dump(st_cfg, f)
    write_safetensors(os.path.join(path, "speech_tokenizer", "model.safetensors"), st)


SERVE_TEXTS = [f"Request {i} asks the served model for a sentence of its own." for i in range(32)]


def scaled(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def fused_trees(c, dev, seed=0):
    """host_init talker and CP trees at ``c``'s widths on ``dev``, fused
    dense bf16, and int8 copies of both (the dense trees stay: phases f-j,
    v)."""
    import torch

    from qwen3tts_tpu_torch.models import talker as tk
    from qwen3tts_tpu_torch.ops.quant import quantize_decode_params_int8
    from qwen3tts_tpu_torch.utils import host_init as hi

    tb = hi.to_device(hi.host_init_talker_params(seed, c), torch.bfloat16, dev)
    tb["layers"] = tk.fuse_layer_projections(tb["layers"])
    cb = hi.to_device(hi.host_init_cp_params(seed + 1, c.code_predictor_config, c.hidden_size),
                      torch.bfloat16, dev)
    cb["layers"] = tk.fuse_layer_projections(cb["layers"])
    return (tb, cb, quantize_decode_params_int8(tb, "codec_head"),
            quantize_decode_params_int8(cb, "lm_head"))


def config_06b():
    """The 0.6B CustomVoice talker config (its CP's inside)."""
    from qwen3tts_tpu_torch import config as C

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
    return cfg


def weights_06b(dev):
    """(cfg, dec_cfg, talker bf16, CP bf16, talker int8, CP int8, vocoder):
    the 0.6B CustomVoice widths, host_init trees fused (``fused_trees``),
    and a random f32 vocoder at the speech tokenizer's decoder widths."""
    import torch

    from qwen3tts_tpu_torch import config as C
    from qwen3tts_tpu_torch.utils import host_init as hi

    cfg = config_06b()
    dec_cfg = C.TokenizerDecoderConfig()
    voc_p = hi.init_vocoder_params(torch.Generator(device=dev).manual_seed(2), dec_cfg,
                                   torch.float32, dev)
    return (cfg, dec_cfg) + fused_trees(cfg, dev) + (voc_p,)


def custom_voice_model(cfg, dec_cfg, talker_p, cp_p, voc_p, dev):
    """The main path's ``Qwen3TTSModel``: the 0.6B CustomVoice model on
    ``dev`` with the stub tokenizer (tests/synthetic_ckpt.py)."""
    import torch
    from synthetic_ckpt import StubTokenizer

    from qwen3tts_tpu_torch import config as C
    from qwen3tts_tpu_torch.tts import Qwen3TTSModel

    return Qwen3TTSModel(
        C.ModelConfig(talker_config=cfg, tts_model_type="custom_voice", tts_model_size="0b6"),
        talker_p, cp_p, voc_p, tokenizer_config=C.TokenizerConfig(decoder_config=dec_cfg),
        tokenizer=StubTokenizer(cfg.text_vocab_size), dtype=torch.bfloat16, device=dev,
    )


def phase_v(dev, smi, cfg, model, talker_b, cp_b, voc_p) -> None:
    """Phase v: dp replicas (``dp_mesh``) and the tensor-parallel mesh at
    0.6B, over every card when there are 2, 4 or 8, else ``dev`` named
    twice. ``model`` is the int8 fused 0.6B model, ``talker_b`` / ``cp_b``
    its fused bf16 trees. Raises at the first failed check."""
    import threading

    import numpy as np
    import torch

    from qwen3tts_tpu_torch.models import batch_generate as bg_v
    from qwen3tts_tpu_torch.models import generate as gen
    from qwen3tts_tpu_torch.models import talker as tk
    from qwen3tts_tpu_torch.ops import cp_kernel as cpk
    from qwen3tts_tpu_torch.ops import talker_kernel as tkk
    from qwen3tts_tpu_torch.tts import Qwen3TTSModel
    from qwen3tts_tpu_torch.parallel import dp as pdp
    from qwen3tts_tpu_torch.parallel import mesh as pm

    t_v = time.time()
    n_cards = torch.cuda.device_count()
    devs_v = ([torch.device("cuda", i) for i in range(n_cards)] if n_cards in (2, 4, 8)
              else [dev, dev])
    dp_mesh = pm.make_mesh(devs_v, tp=1)
    n_dp = len(devs_v)
    log(f"[v] meshes over {[str(d) for d in devs_v]}: "
        + ("every card" if n_cards in (2, 4, 8) else
           f"{n_cards} card named twice (the positions take turns on it; no run across distinct "
           "cards)"))

    # per-shard launch counts: the lockstep calls name their shard (by the
    # cache they decode into) on their host thread; K1 and K2 count under it
    shard_of, shard_now, shard_lock = {}, threading.local(), threading.Lock()
    v_counts = {}  # shard -> {"K1": {mode: n}, "K2": {mode: n}, "frames": lockstep frames}
    real_v = (tkk.talker_decode_step, cpk.predict_codes_fused, bg_v.prefill_start_batch,
              bg_v.generate_chunk_batch)

    def v_shard(cache):
        with shard_lock:  # the shards of distinct cards decode on threads of their own
            s_ = shard_of.setdefault(cache.k.data_ptr(), len(shard_of))
            return v_counts.setdefault(s_, {"K1": {}, "K2": {}, "frames": 0})

    def v_kernel(name, fn):
        def run(*a, **k):
            c_ = getattr(shard_now, "c", None)
            if c_ is not None:  # each shard's dict is written by its own thread only
                c_[name][k.get("mode")] = c_[name].get(k.get("mode"), 0) + 1
            return fn(*a, **k)
        run.__dict__.update(fn.__dict__)
        return run

    def v_prefill(*a, **k):
        shard_now.c = v_shard(k["cache"])
        try:
            return real_v[2](*a, **k)
        finally:
            shard_now.c = None

    def v_chunk(tp_, cp_, carry_, **k):
        shard_now.c = v_shard(carry_.cache)
        try:
            out_ = real_v[3](tp_, cp_, carry_, **k)
            shard_now.c["frames"] += out_.step - carry_.step
            return out_
        finally:
            shard_now.c = None

    real_admit, real_chunks = pdp.admit_slot_dp, pdp.generate_chunk_batch_dp
    tkk.talker_decode_step = v_kernel("K1", real_v[0])
    cpk.predict_codes_fused = v_kernel("K2", real_v[1])
    bg_v.prefill_start_batch, bg_v.generate_chunk_batch = v_prefill, v_chunk
    try:
        # v.1: generate_codes_batch_dp against each shard alone, then the
        # public generate_batch(dp_mesh=) with every shard's frames counted
        v_texts = [f"Replica request {i} reads a short sentence." for i in range(8)]
        built_v = model._build_batch_inputs(v_texts, ["aiden"] * 8, [None] * 8, "english")
        pb_v = max(e.shape[1] for e, _, _ in built_v)
        pad_v = torch.nn.functional.pad
        inp_v = dict(
            prefill_embeds=torch.stack([pad_v(e[0], (0, 0, 0, pb_v - e.shape[1]))
                                        for e, _, _ in built_v]),
            prefill_lens=[e.shape[1] for e, _, _ in built_v],
            trailing_embeds=torch.stack([pad_v(t, (0, 0, 0, 32 - t.shape[0]))
                                         for _, t, _ in built_v]),
            trailing_lens=[t.shape[0] for _, t, _ in built_v], tts_pad_embed=built_v[0][2])
        samp_v = gen.SamplingConfig(0.9, 50, 1.0, 1.05)
        caps_v = [16 + 2 * i for i in range(8)]
        kw_v = dict(talker_cfg=cfg, cp_cfg=cfg.code_predictor_config, sampling=samp_v,
                    max_frames=32)
        got_v = pdp.generate_codes_batch_dp(
            model.talker_params, model.cp_params, mesh=dp_mesh, **kw_v, **inp_v,
            cache=[tk.make_cache(cfg, 8 // n_dp, 256, torch.bfloat16, d)
                   for d in pdp.shard_devices(dp_mesh)], max_steps=caps_v, seed=41)
        lb_v = 8 // n_dp
        for s_ in range(n_dp):
            rows = slice(s_ * lb_v, (s_ + 1) * lb_v)
            d_ = pdp.shard_devices(dp_mesh)[s_]
            tp_s, cp_s = (pdp.replicas(model.talker_params, dp_mesh)[s_],
                          pdp.replicas(model.cp_params, dp_mesh)[s_])
            with torch.cuda.device(d_):
                alone_v = bg_v.generate_codes_batch(
                    tp_s, cp_s, **kw_v,
                    **{k: (v[rows].to(d_) if k != "tts_pad_embed" else v.to(d_))
                       if torch.is_tensor(v) else v[rows] for k, v in inp_v.items()},
                    cache=tk.make_cache(cfg, lb_v, 256, torch.bfloat16, d_),
                    max_steps=caps_v[rows], seed=pdp.shard_seed(41, s_))
            check(torch.equal(got_v.codes[rows].cpu(), alone_v.codes.cpu())
                  and torch.equal(got_v.n_frames[rows].cpu(), alone_v.n_frames.cpu()),
                  f"dp shard {s_}: codes differ from the shard run alone with its shard seed")
        log(f"    generate_codes_batch_dp, 8 rows over dp={n_dp}, sampled: each shard's codes "
            f"equal its rows run alone with shard_seed(41, s)")
        shard_of.clear()
        v_counts.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        wavs_v = model.generate_batch(v_texts, speakers=["aiden"] * 8, language="english",
                                      max_tokens=24, seed=5, dp_mesh=dp_mesh)
        wall_v = time.time() - t0
        check(len(wavs_v) == 8 and all(np.isfinite(w).all() and len(w) % 1920 == 0
                                       for w in wavs_v), "generate_batch(dp_mesh=) waveforms")
        check(len(v_counts) == n_dp, f"{len(v_counts)} shards decoded, not {n_dp}")
        for s_, c_ in sorted(v_counts.items()):
            check(c_["frames"] > 0 and c_["K1"] == {"wo_bf16": c_["frames"]}
                  and c_["K2"] == {"wo_bf16": c_["frames"] + 1},
                  f"shard {s_}: K1 {c_['K1']}, K2 {c_['K2']} for {c_['frames']} lockstep frames")
        log(f"    generate_batch(8 texts, dp_mesh dp={n_dp}): {wall_v:.2f} s; per shard "
            + "; ".join(f"{c_['frames']} lockstep frames, K1 {c_['K1']}, K2 {c_['K2']}"
                        for _, c_ in sorted(v_counts.items())) + f"  [{smi}]")

        # v.2: serve(slots=16, dp_mesh=): 16 ragged greedy requests at once
        # the worker's split: its admissions (one at a time, each on its
        # owner shard) and its chunks (every shard with work at once)
        placed, split = [], {}

        def timed_part(name, fn):
            def run(*a, **k):
                if name == "admit":
                    placed.append(k["slot"])
                t0_ = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    n_, t_ = split.get(name, (0, 0.0))
                    split[name] = (n_ + 1, t_ + time.perf_counter() - t0_)
            return run

        pdp.admit_slot_dp = timed_part("admit", real_admit)
        pdp.generate_chunk_batch_dp = timed_part("chunk", real_chunks)
        greedy_v = dict(temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.0)
        caps_s = [20 + (20 * i) // 15 for i in range(16)]  # 20..40 frames

        def serve_v(mesh_, slots_):
            done_at = [0.0] * 16
            with model.serve(slots=slots_, chunk_frames=8, max_frames=48, dp_mesh=mesh_,
                             **greedy_v) as svc:
                first = svc._item(SERVE_TEXTS[0], "aiden", None, "english", 0, caps_s[0],
                                  None, None, None, None)
                t0_ = time.time()
                with svc._server._lock:  # the worker takes all 16 at once
                    futs = [svc._server.submit(first)] + [
                        svc._server.submit(svc._item(SERVE_TEXTS[i], "aiden", None, "english",
                                                     i, caps_s[i], None, None, None, None))
                        for i in range(1, 16)]
                    for i, f in enumerate(futs):
                        f.add_done_callback(lambda _, i=i: done_at.__setitem__(i, time.time()))
                outs = [f.result(timeout=300) for f in futs]
                wall_ = time.time() - t0_
            return outs, wall_, [d - t0_ for d in done_at]

        def split_text():
            (na, ta), (nc, tc_) = split.pop("admit"), split.pop("chunk")
            return f"{ta:.3f} s in {na} admissions, {tc_:.3f} s in {nc} chunks"

        shard_of.clear()
        v_counts.clear()
        outs_dp, wall_dp, lat_dp = serve_v(dp_mesh, 16)
        split_dp = split_text()
        per_shard_first = [sum(1 for s in placed[:16] if s // (16 // n_dp) == k)
                           for k in range(n_dp)]
        check(len(placed) == 16 and per_shard_first == [16 // n_dp] * n_dp,
              f"dp serve placement {placed}: {per_shard_first} a shard")
        check(all(o.n_frames > 0 for o in outs_dp), "a served dp request gave no frames")
        for s_, c_ in sorted(v_counts.items()):
            check(c_["K1"].get(None, 0) == 0 and sum(c_["K1"].values()) == c_["frames"],
                  f"served shard {s_}: K1 {c_['K1']} for {c_['frames']} lockstep frames")
        # the same requests without dp on one card at a shard's 16/dp slots
        # (K1's and K2's splits are fixed by the rows of a call)
        outs_one, wall_one, lat_one = serve_v(None, 16 // n_dp)
        split_one = split_text()
        same = [i for i in range(16) if outs_dp[i].n_frames == outs_one[i].n_frames
                and (outs_dp[i].codes == outs_one[i].codes).all()]
        check(len(same) == 16, f"served greedy codes differ from the run without dp for "
              f"requests {sorted(set(range(16)) - set(same))}")
        frames_dp = sum(o.n_frames for o in outs_dp)
        p_dp, p_one = np.percentile(lat_dp, [50, 95]), np.percentile(lat_one, [50, 95])
        log(f"    serve(slots=16, dp_mesh dp={n_dp}), 16 greedy requests (caps 20-40): placed "
            f"{per_shard_first} a shard at the first wave, {frames_dp} frames in {wall_dp:.3f} s "
            f"({split_dp}), codec tokens/s {16 * frames_dp / wall_dp:.0f}, latency p50 "
            f"{p_dp[0]:.3f} s, p95 {p_dp[1]:.3f} s; without dp at {16 // n_dp} slots: "
            f"{wall_one:.3f} s ({split_one}), codec tokens/s {16 * frames_dp / wall_one:.0f}, "
            f"p50 {p_one[0]:.3f} s, p95 {p_one[1]:.3f} s;"
            f" greedy codes equal  [{smi}]")
    finally:
        (tkk.talker_decode_step, cpk.predict_codes_fused, bg_v.prefill_start_batch,
         bg_v.generate_chunk_batch) = real_v
        pdp.admit_slot_dp, pdp.generate_chunk_batch_dp = real_admit, real_chunks

    # v.3: tp = 2 at 0.6B, bf16 unfused (the plain per-position step)
    tp_mesh = pm.make_mesh(devs_v[:2], tp=2)

    def unfused(t, c):
        """A fused tree's layers split back into q/k/v and gate/up (views)."""
        lay = dict(t["layers"])
        nq_d, kv_d = c.num_attention_heads * c.head_dim, c.num_key_value_heads * c.head_dim
        qkv, gu = lay.pop("qkv_proj"), lay.pop("gate_up_proj")
        lay.update(q_proj=qkv[..., :nq_d], k_proj=qkv[..., nq_d:nq_d + kv_d],
                   v_proj=qkv[..., nq_d + kv_d:], gate_proj=gu[..., :c.intermediate_size],
                   up_proj=gu[..., c.intermediate_size:])
        return dict(t, layers=lay)

    def to_f32(t):
        return {k: to_f32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()

    tbu, cbu = unfused(talker_b, cfg), unfused(cp_b, cfg.code_predictor_config)
    tbs = pm.shard_talker(tbu, tp_mesh)
    g_v = torch.Generator(device=dev).manual_seed(71)
    pos_v = 40
    pre_v = torch.randn(1, pos_v, cfg.hidden_size, generator=g_v, device=dev).mul(0.2).bfloat16()
    x_v = torch.randn(1, 1, cfg.hidden_size, generator=g_v, device=dev).mul(0.2).bfloat16()
    cache_k = tk.make_cache(cfg, 1, 128, torch.bfloat16, dev)
    tk.forward(talker_b, cfg, pre_v, cache_k, 0)
    cache_p = tk.make_cache(cfg, 1, 128, torch.bfloat16, dev)
    tk.forward(tbu, cfg, pre_v, cache_p, 0)
    cache_t = tk.make_cache(cfg, 1, 128, torch.bfloat16, dev, mesh=tp_mesh)
    tk.forward(tbs, cfg, pre_v, cache_t, 0)
    n1_v = tkk.talker_decode_step.launches
    h_k, _ = tk.forward(talker_b, cfg, x_v, cache_k, pos_v)  # K1
    h_p, _ = tk.forward(tbu, cfg, x_v, cache_p, pos_v)  # the unsharded plain step
    h_t, _ = tk.forward(tbs, cfg, x_v, cache_t, pos_v)
    torch.cuda.synchronize()
    err_v, err_p, err_kp = scaled(h_t, h_k), scaled(h_t, h_p), scaled(h_p, h_k)
    # the TP step is the plain step with its o and down sums split in two,
    # as K1 is the plain step with its sums in another order: both within
    # phase 3's bf16 bound (0.05) of the plain step and of each other
    check(tkk.talker_decode_step.launches == n1_v + 1 and err_p < 0.05 and err_v < 0.05,
          f"tp=2 step: {err_p:.4f} scaled against the unsharded plain step, {err_v:.4f} "
          f"against K1's on the fused copy (K1 against the plain step {err_kp:.4f})")
    # in f32 the split sums are the only difference: 1e-4 scaled, the JAX
    # package's own TP bound (tests/test_parallel.py) at its scale
    tf32, cf32 = to_f32(tbu), to_f32(cbu)
    f32_out = []
    for p_ in (tf32, pm.shard_talker(tf32, tp_mesh)):
        c_ = tk.make_cache(cfg, 1, 128, torch.float32, dev, mesh=pm.tree_mesh(p_))
        tk.forward(p_, cfg, pre_v.float(), c_, 0)
        f32_out.append(tk.forward(p_, cfg, x_v.float(), c_, pos_v)[0])
    err_f32 = scaled(f32_out[1], f32_out[0])
    check(err_f32 < 1e-4, f"tp=2 step in f32 against the unsharded one: {err_f32:.2e} scaled")
    del f32_out

    def v_model(t_, c_, dtype, **where):
        return Qwen3TTSModel(model.config, t_, c_, voc_p, tokenizer_config=model.tokenizer_config,
                             tokenizer=model.tokenizer, dtype=dtype, **where)

    real_gc, got_gc = gen.generate_codes, []
    gen.generate_codes = lambda *a, **k: got_gc.append(real_gc(*a, **k)) or got_gc[-1]
    try:
        text_v = "A tensor parallel sentence."
        greedy_g = dict(speaker="aiden", language="english", temperature=0.0, top_k=0,
                        repetition_penalty=1.0, max_tokens=8, seed=0)
        model_tp = v_model(tbu, cbu, torch.bfloat16, mesh=tp_mesh)
        torch.cuda.synchronize()
        t0 = time.time()
        wav_tp = model_tp.generate(text_v, **greedy_g)
        tp_s = time.time() - t0
        del model_tp
        # the whole greedy decode, talker and code predictor, in f32: the TP
        # run's codes and frame count equal the unsharded plain path's
        for where in (dict(mesh=tp_mesh), dict(device=dev)):
            m_ = v_model(tf32, cf32, torch.float32, **where)
            m_.generate(text_v, **greedy_g)
            del m_
    finally:
        gen.generate_codes = real_gc
    n_tp = got_gc[0].n_frames
    check(np.isfinite(wav_tp).all() and n_tp == 8, f"tp generate(): {n_tp} frames")
    res_tp32, res_one32 = got_gc[1:]
    n32 = res_one32.n_frames
    diff32 = [t_ for t_ in range(n32)
              if not torch.equal(res_tp32.codes[t_].cpu(), res_one32.codes[t_].cpu())]
    check(res_tp32.n_frames == n32 == 8 and not diff32,
          f"tp generate() in f32: {res_tp32.n_frames} frames against {n32} unsharded, codes "
          f"differ at frames {diff32}")
    log(f"    tp=2 at 0.6B (unfused, plain per-position step): bf16 step against the unsharded "
        f"plain step {err_p:.4f} scaled, against K1's on the fused copy {err_v:.4f} (K1 against "
        f"the plain step {err_kp:.4f}); in f32 against the unsharded step {err_f32:.2e}; bf16 "
        f"generate() 8 greedy frames {1e3 * tp_s / n_tp:.1f} ms a frame (vocoder included); f32 "
        f"generate() {n32} greedy frames, all 16 codes of each equal to the unsharded plain "
        f"path's  [{smi}]")
    del tbs, tbu, cbu, tf32, cf32
    log(f"    phase v took {time.time() - t_v:.1f} s")


def phase_w(dev, smi, cfg, ckpt) -> None:
    """Phase w: the CLI and the activation profiler. ``cli.main`` at the
    0.6B CustomVoice widths on phase 9's int4 checkpoint ``ckpt``, whose
    default load is int8 with fused projections (K1 and K2); the stub
    tokenizer is attached by wrapping ``from_pretrained``, which loads once
    and hands the later runs the same model. A greedy run, the same run
    with ``--stream`` and once more (warm), then ``--profile`` over the 20
    texts; the card's
    ``activation_stats`` of one profiled sequence against the same call in
    f32 on the CPU on the same weights (within phase 3's bf16 bound, 0.05
    scaled). Raises at the first failed check."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch
    from synthetic_ckpt import StubTokenizer

    from qwen3tts_tpu_torch import cli
    from qwen3tts_tpu_torch.models import talker as tk
    from qwen3tts_tpu_torch.ops import _cuda
    from qwen3tts_tpu_torch.ops import cp_kernel as cpk
    from qwen3tts_tpu_torch.ops import quant as tq
    from qwen3tts_tpu_torch.ops import talker_kernel as tkk
    from qwen3tts_tpu_torch.tts import Qwen3TTSModel
    from qwen3tts_tpu_torch.utils.audio import load_wav

    t_w = time.time()
    load, stats = Qwen3TTSModel.from_pretrained, tk.activation_stats
    models, replays = [], []

    def loaded(cls, path, device=None):
        if not models:
            m = load(path, device=device)
            m.tokenizer = StubTokenizer(cfg.text_vocab_size)
            models.append(m)
        return models[0]

    def recorded(params, cfg_, seq):
        """``activation_stats`` as the replay calls it, after ``_set_info``:
        the sequence, the maxima and the run's frames."""
        out = stats(params, cfg_, seq)
        replays.append((seq, out, models[0].last_info.generation_token_count))
        return out

    def run(argv):
        """(stdout, K1 launches, K2 launches) of one ``cli.main`` run with
        rc 0; the counts go to 0 just before it. Every K1 launch must be
        the persistent B = 1 step and every K1 and K2 call two library
        operations (``_cuda.launches``, counted by the library itself)."""
        tkk.talker_decode_step.launches = tkk.talker_decode_step.persistent_launches = 0
        cpk.predict_codes_fused.launches = 0
        ops0 = _cuda.launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        k1, k2 = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
        check(rc == 0, f"cli.main({argv}) returned {rc}:\n{out.getvalue()}")
        check(tkk.talker_decode_step.persistent_launches == k1,
              f"{k1 - tkk.talker_decode_step.persistent_launches} K1 steps not the persistent one")
        check(_cuda.launches() - ops0 == 2 * (k1 + k2),
              f"{_cuda.launches() - ops0} library operations for {k1} K1 and {k2} K2 calls")
        return out.getvalue(), k1, k2

    tmp = tempfile.TemporaryDirectory(prefix="qt_cli_")
    Qwen3TTSModel.from_pretrained = classmethod(loaded)
    tk.activation_stats = recorded
    try:
        text = "Hello from the command line of the H100 port."
        base = ["-m", ckpt, "-t", text, "-s", "aiden", "--max-tokens", "24", "--temperature", "0"]
        wav_g, wav_s = os.path.join(tmp.name, "greedy.wav"), os.path.join(tmp.name, "stream.wav")
        t0 = time.time()
        out_g, k1_g, k2_g = run(base + ["-o", wav_g])
        wall_g = time.time() - t0
        (m,) = models
        check(m.device.type == "cuda"
              and isinstance(m.talker_params["layers"]["qkv_proj"], tq.Int8Linear)
              and isinstance(m.cp_params["layers"]["qkv_proj"], tq.Int8Linear),
              "the CLI's load is not int8 fused on the card")
        info_g = m.last_info
        n_g = info_g.generation_token_count
        sr, audio_g = load_wav(wav_g)
        check(sr == 24000 and audio_g.shape[0] == n_g * 1920 and bool(np.isfinite(audio_g).all()),
              f"greedy WAV: {sr} Hz, {audio_g.shape[0]} samples for {n_g} frames")
        check(k2_g == n_g and k1_g == n_g - 1 + int(n_g < 24),
              f"greedy run: K1 {k1_g}, K2 {k2_g} for {n_g} frames")
        for line in ("RTF (gen_time/audio_duration", "Generation tokens/s:", "Peak memory:"):
            check(line in out_g, f"the CLI printed no {line!r}")
        rtf_g = float(re.search(r"RTF \(gen_time/audio_duration, lower is better\): ([0-9.]+)",
                                out_g).group(1))

        out_s, k1_s, k2_s = run(base + ["-o", wav_s, "--stream"])
        info_s = m.last_info
        n_s = info_s.generation_token_count
        tokens = [ln for ln in out_s.splitlines() if ln.startswith("token ")]
        _, audio_s = load_wav(wav_s)
        check(n_s == n_g and len(tokens) == n_s and k2_s == n_s and k1_s == k1_g,
              f"--stream: {len(tokens)} token lines, K1 {k1_s}, K2 {k2_s} for {n_s} frames")
        check(audio_s.shape == audio_g.shape
              and float(np.abs(audio_s - audio_g).max()) <= 2 / 32768,
              "the streamed greedy WAV is not the one-call greedy WAV")
        # the same greedy run again, warm: the model's first call pays for
        # first uses (allocations, library plans) that a served model does not
        out_w, k1_w, k2_w = run(base + ["-o", wav_g])
        info_w = m.last_info
        _, audio_w = load_wav(wav_g)
        check(info_w.generation_token_count == n_g and k1_w == k1_g and k2_w == k2_g
              and np.array_equal(audio_w, audio_g), "the second greedy run differs from the first")
        rtf_w = float(re.search(r"RTF \(gen_time/audio_duration, lower is better\): ([0-9.]+)",
                                out_w).group(1))
        log(f"[w] cli.main greedy (-t ... -s aiden --max-tokens 24 --temperature 0): {n_g} frames, "
            f"{audio_g.shape[0]} samples, {wall_g:.2f} s of main() (the load included); the CLI's RTF "
            f"{rtf_g:.4f}, tokens/s {info_g.tokens_per_second:.2f}, peak memory "
            f"{info_g.peak_memory_usage:.2f} GB; {1000 * info_g.generate_time / n_g:.2f} ms a frame "
            f"of the whole call (prefill, decode, vocoder); warm (the same run again): RTF "
            f"{rtf_w:.4f}, {1000 * info_w.generate_time / n_g:.2f} ms a frame; K1 {k1_g} "
            f"(persistent B=1), K2 {k2_g} a run  [{smi}]")
        log(f"    --stream: {len(tokens)} token lines, the same WAV; decode "
            f"{1000 * info_s.generate_time / n_s:.2f} ms a frame after the prefill "
            f"({1000 * info_s.prefill_time:.1f} ms), host reads at the chunks' ends included; "
            f"K1 {k1_s}, K2 {k2_s}  [{smi}]")

        prof_json = os.path.join(tmp.name, "profile.json")
        replays.clear()
        t0 = time.time()
        out_p, k1_p, k2_p = run(["-m", ckpt, "--profile", "-s", "aiden", "--max-tokens", "16",
                                 "--profile-output", prof_json])
        prof_s = time.time() - t0
        with open(prof_json) as f:
            prof = json.load(f)
        L, inter = cfg.num_hidden_layers, cfg.intermediate_size
        check(prof["run_count"] == 20 and len(replays) == 20 and "skipped" not in out_p,
              f"--profile: run_count {prof['run_count']}, {len(replays)} replays")
        check(prof["num_layers"] == L and prof["intermediate_size"] == inter
              and len(prof["layers"]) == L
              and all(len(ly["max_activations"]) == inter for ly in prof["layers"]),
              "--profile JSON is not 28 layers x 3072 neurons")
        maxes = np.asarray([ly["max_activations"] for ly in prof["layers"]], np.float32)
        check(bool(np.isfinite(maxes).all()) and float(maxes.max()) > 0, "profile maxima")
        n_p = [n for _, _, n in replays]
        check(k2_p == sum(n_p) and k1_p == sum(n - 1 + int(n < 16) for n in n_p),
              f"--profile: K1 {k1_p}, K2 {k2_p} for frames {n_p}")

        seq, card, _ = replays[0]
        t0 = time.time()
        cpu_layers = {k: (tq.Int8Linear(v.q.cpu(), v.scale.cpu().float())
                          if isinstance(v, tq.Int8Linear) else v.cpu().float())
                      for k, v in m.talker_params["layers"].items()}
        ref = stats({"layers": cpu_layers}, cfg, seq.cpu().float())
        cpu_s = time.time() - t0
        err = scaled(card.cpu(), ref)
        check(tuple(card.shape) == (L, inter) and card.dtype == torch.float32
              and card.device.type == "cuda", "activation_stats on the card: shape, dtype, device")
        check(err < 0.05, f"activation_stats on the card vs f32 on the CPU: {err:.4f} scaled")
        log(f"    --profile --max-tokens 16 over the 20 texts: run_count {prof['run_count']}, "
            f"{L} x {inter} maxima, {prof_s:.2f} s, {sum(n_p)} frames, K1 {k1_p}, K2 {k2_p}; "
            f"activation_stats of the first replay ({seq.shape[1]} rows) on the card vs f32 on "
            f"the CPU: max_abs {float((card.cpu() - ref).abs().max()):.5f}, {err:.5f} scaled "
            f"(bound 0.05; the CPU call {cpu_s:.1f} s)  [{smi}]")
    finally:
        Qwen3TTSModel.from_pretrained = load
        tk.activation_stats = stats
        tmp.cleanup()
    log(f"    phase w took {time.time() - t_w:.1f} s")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    if not os.path.isdir(os.path.join(HERE, "qwen3tts_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))

    # chat specials plus crc32 word ids (numpy-only test helper; no JAX)
    from synthetic_ckpt import StubTokenizer

    from qwen3tts_tpu_torch import config as C
    from qwen3tts_tpu_torch.models import generate as gen
    from qwen3tts_tpu_torch.models import talker as tk
    from qwen3tts_tpu_torch.models import vocoder as vc
    from qwen3tts_tpu_torch.ops import _cuda
    from qwen3tts_tpu_torch.ops import cp_kernel as cpk
    from qwen3tts_tpu_torch.ops import quant as tq
    from qwen3tts_tpu_torch.ops import talker_kernel as tkk
    from qwen3tts_tpu_torch.ops.decode_blocks import gumbel_noise
    from qwen3tts_tpu_torch.ops.quant import quantize_decode_params_int8
    from qwen3tts_tpu_torch.ops.rope import mrope_cos_sin
    from qwen3tts_tpu_torch.tts import Qwen3TTSModel, _generate_and_decode
    from qwen3tts_tpu_torch.utils import host_init as hi

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[1] card: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvcc: {nvcc}")

    # ---- 2. kernel build ----
    t0 = time.time()
    _cuda.library()
    log(f"[2] kernels built from csrc/ in {time.time() - t0:.2f} s "
        f"(nvcc {_cuda.build_seconds if _cuda.build_seconds is not None else 'cached'} s)")

    # ---- weights: 0.6B CustomVoice widths, host_init, fused, int8 ----
    t0 = time.time()
    cfg, dec_cfg, talker_b, cp_b, talker_p, cp_p, voc_p = weights_06b(dev)
    cpc = cfg.code_predictor_config
    torch.cuda.synchronize()
    log(f"    weights: talker + CP (host_init, fused, bf16 and int8) + f32 vocoder in "
        f"{time.time() - t0:.1f} s")

    # timed: ms per call of back-to-back calls (CUDA events); device_ms: the
    # device time per call (torch.profiler; a window that did not record
    # every kernel it was given, or no device time, taken again); both after
    # one warm-up call
    from qwen3tts_tpu_torch.tools._card import device_ms, device_ms_by_kernel, queued_ms
    from qwen3tts_tpu_torch.tools._card import event_ms as timed
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def b1_ms(fn, iters):
        """Device ms per call of a persistent B = 1 kernel (K1's step, K2's
        frame): CUDA events around calls queued behind a spin kernel.
        torch.profiler records no cooperative launch (on an H100 its windows
        held only the wrappers' operand copies), so ``device_ms`` cannot
        read one."""
        return queued_ms(fn, iters)

    # the least time the card could take: bytes over the HBM rate, operations
    # over the dense tensor rate of their type, bf16 or (dyn_int8) int8
    # (H100 SXM data sheet, 700 W)
    HBM_BYTES_S, PEAK_FLOP_S, PEAK_INT8_OP_S = 3.35e12, 989e12, 1979e12

    def bound(n_bytes, flops, peak=PEAK_FLOP_S):
        t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    g = torch.Generator(device=dev).manual_seed(7)
    H, V = cfg.hidden_size, cfg.vocab_size
    eos = cfg.codec_eos_token_id

    # ---- 3. K1 against its plain version ----
    pos, T = 40, 256
    cache0 = tk.make_cache(cfg, 1, T, torch.bfloat16, dev)
    prefill = torch.randn(1, pos, H, generator=g, device=dev).mul(0.05).to(torch.bfloat16)
    tk.forward(talker_p, cfg, prefill, cache0, 0)
    x = torch.randn(1, 1, H, generator=g, device=dev).mul(0.05).to(torch.bfloat16)
    cos_t, sin_t = mrope_cos_sin(torch.full((1, 1), pos, device=dev), cfg.head_dim,
                                 cfg.rope_theta, cfg.mrope_section, torch.bfloat16)
    cos, sin = cos_t[0, 0], sin_t[0, 0]
    supp_mask = torch.zeros(V, dtype=torch.bool, device=dev)
    supp_mask[V - 1024:] = True  # the reference's special-token mask, EOS forbidden too
    supp = torch.where(supp_mask, -1e30, 0.0).float()
    seen = torch.zeros(V, dtype=torch.bool, device=dev)
    seen[[11, 500, 1999]] = True

    def k1(fn, cache, temperature, seed, top_k=50, eos_id=-1, suppress_add=supp, **kw):
        return fn(talker_p, cfg, x, cache, pos, cos, sin, temperature=temperature, top_k=top_k,
                  rep_penalty=1.05, eos_id=eos_id, seed=seed, suppress_add=suppress_add,
                  seen=seen, **kw)

    def pen(logits):  # the repetition penalty over ``seen``
        return torch.where(seen, torch.where(logits < 0, logits * 1.05, logits / 1.05), logits)

    ck, cr = tk.KVCache(cache0.k.clone(), cache0.v.clone()), tk.KVCache(cache0.k.clone(), cache0.v.clone())
    hk, codek, lk = k1(tkk.talker_decode_step, ck, 0.0, (1, 2), return_logits=True)
    hr, coder, lr = k1(tkk.talker_decode_step_ref, cr, 0.0, (1, 2), return_logits=True)
    torch.cuda.synchronize()
    err_h, err_l = scaled(hk, hr), scaled(lk, lr)
    err_k = scaled(ck.k[:, 0, :, pos], cr.k[:, 0, :, pos])
    err_v = scaled(ck.v[:, 0, :, pos], cr.v[:, 0, :, pos])
    k1_abs = float((lk - lr).abs().max())
    log(f"[3] K1 vs plain at 0.6B (pos {pos}, cache {T}): scaled err h {err_h:.3g} "
        f"k {err_k:.3g} v {err_v:.3g} logits {err_l:.3g} (max abs {k1_abs:.3g}); "
        f"greedy code0 kernel {int(codek)} plain {int(coder)}")
    # bf16 bound: same rounding points, f32 sums in another order; single bf16
    # flips (2^-8 relative) carry through 28 layers
    check(err_h < 0.05 and err_k < 0.05 and err_v < 0.05, "K1 hidden/kv outside the bf16 bound")
    check(err_l < 0.05, "K1 logits outside the bound")

    def near_tie(logits_r, a, b, delta):
        return abs(float(logits_r[a] - logits_r[b])) <= 2 * delta + 1e-6

    def sampled_flip_explained(z_ref, a, b, delta, noise, temperature=0.9, top_k=50):
        """Kernel code a vs plain code b drawn with the same noise, logits
        within ``delta``: explained by a near-tie of the perturbed scores, or
        by a or b sitting within the error of the top-k boundary."""
        kth = torch.topk(z_ref, top_k).values[-1]
        edge = min(abs(float(z_ref[a] - kth)), abs(float(z_ref[b] - kth)))
        gap = abs(float((z_ref[a] - z_ref[b]) / temperature + noise[a] - noise[b]))
        log(f"    flip {a} vs {b}: |logit - kth| {edge:.4g}, score gap {gap:.4g}, "
            f"logit error {delta:.4g}")
        return edge <= 2 * delta or gap <= 2 * delta / temperature + 1e-6

    check(int(codek) == int(coder) or near_tie(pen(lr) + supp, int(codek), int(coder), k1_abs),
          "K1 greedy code0 differs beyond a near-tie")

    def k1_sampled(label, seed_base, top_k=50, eos_id=-1, suppress_add=supp):
        """Sampled code0 of kernel and plain version over 32 seeds; a code
        that differs must be a near-tie, and never EOS. Returns the number
        of seeds whose plain draw is EOS."""
        mism = eos_draws = 0
        for s in range(32):
            seed = (seed_base + s, 77 * s + 5)
            kw = dict(top_k=top_k, eos_id=eos_id, suppress_add=suppress_add, return_logits=True)
            _, a, la = k1(tkk.talker_decode_step, ck, 0.9, seed, **kw)
            _, b, lb = k1(tkk.talker_decode_step_ref, cr, 0.9, seed, **kw)
            a, b = int(a), int(b)
            eos_draws += b == eos
            if a != b:
                mism += 1
                delta = 1.05 * float((la - lb).abs().max())  # x1.05: the penalty
                check(eos not in (a, b) and sampled_flip_explained(
                          pen(lb) + suppress_add, a, b, delta,
                          gumbel_noise(seed[0], seed[1], 0, V, dev), top_k=top_k),
                      f"K1 sampled code0 ({label}) differs beyond a near-tie (seed {s}: codes "
                      f"{a} vs {b}, logit error {delta:.4g})")
        log(f"    sampled code0 ({label}, T=0.9, top-k {top_k}, 32 seeds): {32 - mism}/32 "
            f"equal, {mism} explained by near-ties, EOS drawn {eos_draws}")
        return eos_draws

    k1_sampled("EOS suppressed", 1000)
    # The EOS restore: the sampler saves the EOS logit before top-k and puts
    # it back after. EOS is left unsuppressed here, its mask entry placing it
    # ``margin`` below the k-th logit of the other ids, so only the restore
    # lets it be drawn; with top-k 1 it is drawn in about half the seeds.
    margin = max(0.1, 4 * 1.05 * k1_abs)
    for top_k in (50, 1):
        kth = torch.topk(pen(lr) + supp, top_k).values[-1]  # supp holds EOS at -1e30
        supp_e = supp.clone()
        supp_e[eos] = kth - margin - pen(lr)[eos]
        draws = k1_sampled(f"EOS {margin:.3g} below the k-th", 4000 + top_k, top_k, eos, supp_e)
        if top_k == 1:
            check(draws > 0, "EOS never drawn at top-k 1: the restore went unchecked")
    k1_ms = timed(lambda: k1(tkk.talker_decode_step, ck, 0.9, (3, 4)), 50)
    k1_plain_ms = timed(lambda: k1(tkk.talker_decode_step_ref, cr, 0.9, (3, 4)), 5)
    log(f"    K1 {k1_ms:.3f} ms/step, plain {k1_plain_ms:.3f} ms/step  [{smi}]")

    # A long cache: the attention walks 24 tiles of 256 rows with an online
    # softmax (cache rows random, as the comparison needs only equal inputs)
    pos_l, T_l = 6000, 6144
    kv = torch.randn(2, cfg.num_hidden_layers, 1, cfg.num_key_value_heads, T_l, cfg.head_dim,
                     generator=g, device=dev).to(torch.bfloat16)
    cos_l, sin_l = mrope_cos_sin(torch.full((1, 1), pos_l, device=dev), cfg.head_dim,
                                 cfg.rope_theta, cfg.mrope_section, torch.bfloat16)
    outs = []
    for fn in (tkk.talker_decode_step, tkk.talker_decode_step_ref):
        c = tk.KVCache(kv[0].clone(), kv[1].clone())
        h_, c0_, l_ = fn(talker_p, cfg, x, c, pos_l, cos_l[0, 0], sin_l[0, 0], temperature=0.0,
                         top_k=50, rep_penalty=1.05, eos_id=-1, seed=(1, 2), suppress_add=supp,
                         seen=seen, return_logits=True)
        outs.append((h_, int(c0_), l_, c))
    (hk_l, ck_l, lk_l, cak_l), (hr_l, cr_l, lr_l, car_l) = outs
    torch.cuda.synchronize()
    errs_l = [scaled(hk_l, hr_l), scaled(lk_l, lr_l),
              scaled(cak_l.k[:, 0, :, pos_l], car_l.k[:, 0, :, pos_l]),
              scaled(cak_l.v[:, 0, :, pos_l], car_l.v[:, 0, :, pos_l])]
    log(f"    K1 at pos {pos_l} (cache {T_l}): scaled err h {errs_l[0]:.3g} logits "
        f"{errs_l[1]:.3g} k {errs_l[2]:.3g} v {errs_l[3]:.3g}; greedy code0 kernel {ck_l} "
        f"plain {cr_l}")
    check(max(errs_l) < 0.05, "K1 at a long cache outside the bf16 bound")
    check(ck_l == cr_l or near_tie(pen(lr_l) + supp, ck_l, cr_l, float((lk_l - lr_l).abs().max())),
          "K1 greedy code0 at a long cache differs beyond a near-tie")
    k1_long_ms = timed(lambda: tkk.talker_decode_step(
        talker_p, cfg, x, cak_l, pos_l, cos_l[0, 0], sin_l[0, 0], temperature=0.9, top_k=50,
        rep_penalty=1.05, eos_id=-1, seed=(3, 4), suppress_add=supp, seen=seen), 20)
    log(f"    K1 at pos {pos_l}: {k1_long_ms:.3f} ms/step  [{smi}]")
    del kv, outs, cak_l, car_l

    # ---- 4. K2 against its plain version ----
    last_h = hk.reshape(1, H)
    code0 = codek.reshape(1)

    def k2(fn, temperature, seed, **kw):
        return fn(cp_p, cpc, talker_p, last_h, code0, seed, temperature=temperature, top_k=50, **kw)

    codes_r, esum_r, lg_r = k2(cpk.predict_codes_fused_ref, 0.0, (5, 6), return_logits=True)
    codes_k, esum_k, lg_k = k2(cpk.predict_codes_fused, 0.0, (5, 6), force_codes=codes_r,
                               return_logits=True)
    torch.cuda.synchronize()
    k2_abs = float((lg_k - lg_r).abs().max())
    err_lg = max(scaled(lg_k[j], lg_r[j]) for j in range(15))
    err_e = scaled(esum_k, esum_r)
    log(f"[4] K2 vs plain at 0.6B (teacher-forced greedy): scaled logits err {err_lg:.3g} "
        f"(max abs {k2_abs:.3g}), esum err {err_e:.3g}; codes equal "
        f"{int((codes_k == codes_r).sum())}/15")
    check(err_lg < 0.05, "K2 logits outside the bound")
    check(err_e == 0.0, "K2 esum differs (same rows, same order: must be exact)")
    for j in range(15):
        a, b = int(codes_k[0, j]), int(codes_r[0, j])
        check(a == b or near_tie(lg_r[j], a, b, k2_abs), f"K2 greedy code {j} beyond a near-tie")
    mism = 0
    for s in range(32):
        seed = (2000 + s, 31 * s + 1)
        ca, _, la = k2(cpk.predict_codes_fused, 0.9, seed, return_logits=True)
        cb, _, lb = k2(cpk.predict_codes_fused_ref, 0.9, seed, return_logits=True)
        diff = (ca != cb).nonzero()
        if len(diff):
            mism += 1
            j = int(diff[0, 1])  # later positions follow different inputs
            a, b = int(ca[0, j]), int(cb[0, j])
            delta = float((la[j] - lb[j]).abs().max())
            noise = gumbel_noise(seed[0], seed[1], j + 1, cpc.vocab_size, dev)
            check(sampled_flip_explained(lb[j], a, b, delta, noise),
                  f"K2 sampled code {j} differs beyond a near-tie (seed {s}: codes {a} vs {b}, "
                  f"logit error {delta:.4g})")
    log(f"    sampled codes (T=0.9, top-k 50, 32 seeds): {32 - mism}/32 frames equal, "
        f"{mism} explained by near-ties")
    k2_ms = timed(lambda: k2(cpk.predict_codes_fused, 0.9, (3, 4)), 20)
    k2_plain_ms = timed(lambda: k2(cpk.predict_codes_fused_ref, 0.9, (3, 4)), 3)
    log(f"    K2 {k2_ms:.3f} ms/frame, plain {k2_plain_ms:.3f} ms/frame  [{smi}]")

    # ---- 5. the main path: Qwen3TTSModel.generate at 0.6B widths ----
    model = custom_voice_model(cfg, dec_cfg, talker_p, cp_p, voc_p, dev)
    tkk.talker_decode_step.launches = 0
    tkk.talker_decode_step.persistent_launches = 0
    cpk.predict_codes_fused.launches = 0
    t0 = time.time()
    wav, info = model.generate("Hello from the H100 port of the talker.", speaker="aiden",
                               language="english", seed=0, return_info=True)
    gen_s = time.time() - t0
    n1, n2 = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
    n1_persistent = tkk.talker_decode_step.persistent_launches
    n = info.generation_token_count
    max_steps = model._effective_max_tokens("Hello from the H100 port of the talker.", 2048)
    eos_hit = n < max_steps
    log(f"[5] generate(): {n} frames (cap {max_steps}{', EOS' if eos_hit else ''}), "
        f"{len(wav)} samples, {gen_s:.2f} s; launches K1 {n1}, K2 {n2}")
    check(n2 == n, f"K2 ran {n2} times for {n} frames")
    check(n1 == n - 1 + int(eos_hit), f"K1 ran {n1} times for {n} frames")
    check(n1_persistent == n1, f"{n1 - n1_persistent} of K1's {n1} steps not the persistent one")
    check(bool(__import__("numpy").isfinite(wav).all()), "waveform not finite")
    check(len(wav) % 1920 == 0 and 0 < len(wav) <= n * 1920, f"waveform length {len(wav)}")

    # ---- 6. the headline: 66 frames, forbid_eos ----
    frames, p_len = 66, 24
    sampling = gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True)
    p_bucket, max_frames = gen.pad_to_bucket(p_len), 128
    prefill = torch.randn(1, p_bucket, H, generator=g, device=dev).mul(0.05).to(torch.bfloat16)
    trailing = torch.randn(64, H, generator=g, device=dev).mul(0.05).to(torch.bfloat16)
    pad = torch.zeros(H, dtype=torch.bfloat16, device=dev)
    run = dict(talker_cfg=cfg, cp_cfg=cpc, sampling=sampling, prefill_embeds=prefill,
               prefill_len=p_len, trailing_embeds=trailing, trailing_len=12, tts_pad_embed=pad,
               max_frames=max_frames)
    cache_len = -(-(p_bucket + max_frames) // 128) * 128

    def e2e(seed):
        torch.cuda.synchronize()
        t = time.time()
        codes, nf, w, _ = _generate_and_decode(talker_p, cp_p, voc_p, dec_cfg=dec_cfg, **run,
                                               max_steps=frames, seed=seed, cache_len=cache_len)
        torch.cuda.synchronize()
        check(nf == frames and bool(torch.isfinite(w).all()), "headline run malformed")
        return time.time() - t, codes

    e2e(0)  # warm-up
    walls = [e2e(s)[0] for s in (1, 2, 3)]
    wall = statistics.median(walls)

    def stage_ms(fn) -> float:
        """Median host ms of three synchronised runs of one stage."""
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.time()
            fn()
            torch.cuda.synchronize()
            out.append((time.time() - t) * 1000)
        return statistics.median(out)

    codes66 = e2e(4)[1]
    prefill_ms = stage_ms(lambda: gen.prefill_start(
        talker_p, cp_p, **run, cache=tk.make_cache(cfg, 1, cache_len, torch.bfloat16, dev), seed=9))
    vocoder_ms = stage_ms(lambda: vc.decode(voc_p, dec_cfg, codes66[None, :72], frames))

    def decode_ms(plain: bool, quantized: bool = False) -> float:
        """ms per frame of the decode loop after the first frame."""
        cache = tk.make_cache(cfg, 1, cache_len, torch.bfloat16, dev, quantized=quantized)
        c = gen.prefill_start(talker_p, cp_p, **run, cache=cache, seed=9)
        steps = 20 if plain else frames - 1
        torch.cuda.synchronize()
        t = time.time()
        if not plain:
            gen.generate_chunk(talker_p, cp_p, c, talker_cfg=cfg, cp_cfg=cpc, sampling=sampling,
                               trailing_embeds=trailing, trailing_len=12, tts_pad_embed=pad,
                               until_step=1 + steps)
        else:  # the same frame loop through the kernels' plain versions
            rope = mrope_cos_sin(torch.arange(cache_len, device=dev)[None], cfg.head_dim,
                                 cfg.rope_theta, cfg.mrope_section, torch.bfloat16)
            x_in, off, seen_p = c.cur_input, c.offset, c.seen
            for step in range(1, 1 + steps):
                tok_seed, cp_seed = gen._frame_seeds(c.seed_words, step)
                h, c0 = tkk.talker_decode_step_ref(
                    talker_p, cfg, x_in, c.cache, off, rope[0][0, off], rope[1][0, off],
                    temperature=0.9, top_k=50, rep_penalty=1.05, eos_id=-1, seed=tok_seed,
                    suppress_add=supp, seen=seen_p)
                check(int(c0[0]) != eos, "EOS under forbid_eos")
                seen_p = seen_p.index_fill(0, c0.long(), True)
                rest, esum = cpk.predict_codes_fused_ref(
                    cp_p, cpc, talker_p, h.reshape(1, H), c0, cp_seed, temperature=0.9, top_k=50)
                csum = tk.embed_codec(talker_p, c0).float() + esum
                x_in = gen._next_input(cp_p, talker_p, trailing, 12, pad, step, c0, rest, csum)
                off += 1
        torch.cuda.synchronize()
        return (time.time() - t) * 1000 / steps

    ms_k = [decode_ms(False), decode_ms(False)]
    ms_p = decode_ms(True)
    decode6_ms = statistics.median(ms_k)  # phase n compares its top-p loop with it
    rtf = wall / (frames / 12.5)
    log(f"[6] headline (66 frames, forbid_eos, T=0.9 top-k 50 rep 1.05): wall {wall:.3f} s "
        f"(runs {', '.join(f'{w:.3f}' for w in walls)}), RTF {rtf:.4f}; decode "
        f"{statistics.median(ms_k):.2f} ms/frame with K1+K2, {ms_p:.2f} ms/frame on the "
        f"plain path; prefill + first frame {prefill_ms:.2f} ms, vocoder (72-frame bucket) "
        f"{vocoder_ms:.2f} ms  [{smi}]")

    # ---- 7. K4 against its plain version ----
    import numpy as np

    rs = np.random.default_rng(11)
    shapes = [  # (O, I, x dtype, where)
        (2048, 1024, torch.bfloat16, "talker/CP q"),
        (1024, 1024, torch.bfloat16, "talker/CP k, v"),
        (1024, 2048, torch.bfloat16, "talker/CP o"),
        (3072, 1024, torch.bfloat16, "talker/CP gate, up"),
        (1024, 3072, torch.bfloat16, "talker/CP down"),
        (V, H, torch.float32, "codec head"),
        (cpc.vocab_size, cpc.hidden_size, torch.float32, "CP lm_head"),
    ]
    k4_err, k4_abs, k4_times, k4_io = 0.0, 0.0, {}, {}
    for bits, group in ((4, 64), (4, 32), (8, 64)):
        for O, I, xdt, where in shapes:
            w = rs.standard_normal((O, I), dtype=np.float32) / np.float32(np.sqrt(I))
            pw = tq.packed_from_numpy(*tq.pack_quantized(w, bits, group), bits, group).to(dev)
            xq = torch.randn(1, I, generator=g, device=dev).to(xdt)
            args = (pw.q, pw.scales, pw.biases, bits, group)
            yk, yr = tq.quant_gemv(xq, *args), tq.quant_matmul(xq, *args)
            torch.cuda.synchronize()
            err = scaled(yk, yr)
            k4_err, k4_abs = max(k4_err, err), max(k4_abs, float((yk - yr).abs().max()))
            # timed over copies of the weight that hold 64 MB in all, in
            # turn: no call finds its weight in the 50 MB L2
            n_cp = -(-(64 << 20) // nbytes(pw.q, pw.scales, pw.biases))
            copies = [(pw.q.clone(), pw.scales.clone(), pw.biases.clone(), bits, group)
                      for _ in range(n_cp)]
            turn = iter(range(1 << 30))

            def run_k():
                return tq.quant_gemv(xq, *copies[next(turn) % n_cp])

            def run_p():
                return tq.quant_matmul(xq, *copies[next(turn) % n_cp])

            us_k, us_p = 1000 * timed(run_k, 200), 1000 * timed(run_p, 50)
            # kernels per call: K4 1; the plain version 10 and a cast of bf16 x
            # (counted on the H100), each profiler window held to them
            dev_k = device_ms(run_k, 2 * n_cp, 1)
            dev_p = device_ms(run_p, 10, 10 + (xdt == torch.bfloat16))
            del copies
            k4_times[(bits, group, O, I, xdt)] = (dev_k, dev_p)
            k4_io[(bits, group, O, I, xdt)] = (nbytes(pw.q, pw.scales, pw.biases, xq, yk), 2 * O * I)
            log(f"[7] K4 bits {bits} group {group} [{O} x {I}] {str(xdt)[6:]} x ({where}): "
                f"scaled err {err:.3g}; device {1000 * dev_k:.2f} us/call, plain "
                f"{1000 * dev_p:.2f}; back to back {us_k:.2f} us/call, plain {us_p:.2f}")
            check(err <= 1e-4, f"K4 outside the 1e-4 bound at bits {bits} group {group} [{O}x{I}]")
    k4_ms, k4_plain_ms = k4_times[(4, 64, 3072, 1024, torch.bfloat16)]
    k4_bound = bound(*k4_io[(4, 64, 3072, 1024, torch.bfloat16)])
    # the library yardstick at the headline shape: torch._weight_int4pack_mm
    # on the same int4 g64 weights (MLX's scale * q + bias as int4pack's
    # (q - 8) * scale + zero, zero = bias + 8 * scale, both rounded to bf16),
    # over the same 64 MB of copies in turn
    k4_lib_ms = None
    w_l = rs.standard_normal((3072, 1024), dtype=np.float32) / np.float32(32.0)
    pw_l = tq.packed_from_numpy(*tq.pack_quantized(w_l, 4, 64), 4, 64).to(dev)
    x_l = torch.randn(1, 1024, generator=g, device=dev).to(torch.bfloat16)
    try:
        nib = torch.stack([(pw_l.q >> (4 * i)) & 0xF for i in range(8)], -1).reshape(3072, 1024)
        packed4 = torch._convert_weight_to_int4pack(((nib[:, ::2] << 4) | nib[:, 1::2])
                                                    .to(torch.uint8), 8)
        sz = torch.stack([pw_l.scales.bfloat16(), (pw_l.biases + 8 * pw_l.scales).bfloat16()],
                         -1).transpose(0, 1).contiguous()
        n_cp = -(-(64 << 20) // nbytes(packed4, sz))
        lib_copies = [(packed4.clone(), sz.clone()) for _ in range(n_cp)]
        turn = iter(range(1 << 30))

        def run_l():
            w4, sz4 = lib_copies[next(turn) % n_cp]
            return torch._weight_int4pack_mm(x_l, w4, 64, sz4)

        k4_lib_ms = device_ms(run_l, 2 * n_cp)
        del lib_copies
    except (RuntimeError, AttributeError, TypeError) as e:  # a build without the op
        log(f"    torch._weight_int4pack_mm not available: {str(e)[:200]}")
    log(f"    K4 max scaled err {k4_err:.3g} (max abs {k4_abs:.3g}); at 3072 x 1024 int4 g64 K4 "
        f"{1000 * k4_ms:.2f} us/call, torch._weight_int4pack_mm "
        f"{'n/a' if k4_lib_ms is None else f'{1000 * k4_lib_ms:.2f}'} us/call  [{smi}]")

    # ---- 8. K3 against its plain version ----
    from qwen3tts_tpu_torch.ops import attention as attn
    from qwen3tts_tpu_torch.tools import time_k3_k2 as tkt

    L, NKV, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    k3_err, k3_abs, k3_times = 0.0, 0.0, {}

    def rotating(fn):
        """fn(layer) over the L layers in turn, as a decode step calls K3:
        at pos 4000 the 28 prefixes hold 459 MB, so no call finds the
        previous call's bytes in the 50 MB L2."""
        calls = iter(range(1 << 30))
        return lambda: fn(next(calls) % L)

    for T_c, pos_c in ((4096, 40), (4096, 4000), (6144, 6000), (4096, 127), (4096, 128)):
        kv = torch.randn(2, L, 1, NKV, T_c, D, generator=g, device=dev).to(torch.bfloat16)
        qv = torch.randn(1, cfg.num_attention_heads, 1, D, generator=g, device=dev).to(torch.bfloat16)
        for layer in (None, L - 1):
            kc, vc = (kv[0], kv[1]) if layer is not None else (kv[0, L - 1], kv[1, L - 1])
            a = (qv, kc, vc, pos_c, D**-0.5)
            ok_, or_ = attn.decode_attention_inner(*a, layer=layer), attn.decode_attention_ref(*a, layer=layer)
            torch.cuda.synchronize()
            err = scaled(ok_, or_)
            k3_err, k3_abs = max(k3_err, err), max(k3_abs, float((ok_.float() - or_.float()).abs().max()))
            if layer is None:  # one layer's cache
                run_k = rotating(lambda l: attn.decode_attention_inner(qv, kv[0, l], kv[1, l], pos_c, D**-0.5))
                run_p = rotating(lambda l: attn.decode_attention_ref(qv, kv[0, l], kv[1, l], pos_c, D**-0.5))
            else:  # the layered cache with a layer index
                run_k = rotating(lambda l: attn.decode_attention_inner(*a, layer=l))
                run_p = rotating(lambda l: attn.decode_attention_ref(*a, layer=l))
            ms_k, ms_p = timed(run_k, 100), timed(run_p, 20)
            # kernels per call: K3 1 (chunks and merge in one launch), the plain version 8
            dev_k, dev_p = device_ms(run_k, 56, 1), device_ms(run_p, 28, 8)
            k3_times[(T_c, pos_c, layer)] = (dev_k, dev_p)
            if (T_c, pos_c, layer) == (4096, 4000, L - 1):
                # the yardstick: one library call over the valid prefix,
                # never called by the port, over the layers in turn too
                run_lib = rotating(lambda l: torch.nn.functional.scaled_dot_product_attention(
                    qv, kc[l, :, :, : pos_c + 1], vc[l, :, :, : pos_c + 1], scale=D**-0.5,
                    enable_gqa=True))
                k3_lib_ms = device_ms(run_lib, 56)
                # the profile: the same kernel stopped after each phase
                k3_cuts = {name: device_ms(tkt.k3_cut(qv, kv, pos_c, cut, L), 56, 1)
                           for cut, name in enumerate(tkt.CUTS, start=1)}
                k3_bound = bound(nbytes(qv, kc[layer, :, :, : pos_c + 1], vc[layer, :, :, : pos_c + 1], ok_),
                                 4 * cfg.num_attention_heads * D * (pos_c + 1))
            log(f"[8] K3 pos {pos_c} of {T_c} ({'layer index' if layer is not None else 'one layer'}): "
                f"scaled err {err:.3g}; device {dev_k:.4f} ms/call, plain {dev_p:.4f}; "
                f"back to back {ms_k:.4f} ms/call, plain {ms_p:.4f} (the {L} layers in turn)")
            check(err <= 1e-2, f"K3 outside the 1e-2 bound at pos {pos_c} of {T_c}")
        del kv
    k3_ms, k3_plain_ms = k3_times[(4096, 4000, L - 1)]
    log(f"    K3 max scaled err {k3_err:.3g} (max abs {k3_abs:.3g}); at pos 4000 "
        f"x {L} layers: device {k3_ms * L:.3f} ms/step, plain {k3_plain_ms * L:.3f}; one call "
        f"{k3_ms:.4f} ms against its bound {k3_bound[0]:.4f} ms ({k3_bound[1]}; "
        f"{k3_bound[0] / k3_ms:.2f} of it) and scaled_dot_product_attention {k3_lib_ms:.4f} ms "
        f"(target, no slower than it: {'met' if k3_ms <= k3_lib_ms else 'missed'})  [{smi}]")
    log("    K3 at pos 4000 stopped after each phase (device ms/call): " + ", ".join(
        f"{name} {t:.4f}" for name, t in k3_cuts.items()) + f", merged {k3_ms:.4f}")

    # ---- 9. the packed main path: from_pretrained(keep_packed=True) ----
    ckpt_tmp = tempfile.TemporaryDirectory(prefix="qt_ckpt_")
    ckpt = ckpt_tmp.name
    t0 = time.time()
    arrays06 = checkpoint_arrays(talker_json(cfg))
    write_checkpoint(ckpt, arrays06, packed_group=64)
    ckpt_s = time.time() - t0
    t0 = time.time()
    packed = Qwen3TTSModel.from_pretrained(ckpt, keep_packed=True)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    packed.tokenizer = StubTokenizer(cfg.text_vocab_size)
    pt_, pc_ = packed.talker_params, packed.cp_params
    check(packed.device.type == "cuda", "from_pretrained did not default to the card")
    check(all(isinstance(pt_["layers"][k], tq.PackedLinear) for k in
              ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"))
          and isinstance(pt_["codec_head"], tq.PackedLinear)
          and isinstance(pc_["lm_head"], tq.PackedLinear)
          and isinstance(pc_["layers"]["q_proj"], tq.PackedLinear), "weights were not kept packed")
    check(pt_["layers"]["q_proj"].q.shape == (L, cfg.num_attention_heads * D, H // 8),
          "packed q_proj shape")
    n_cp = cpc.num_hidden_layers
    per_frame = 7 * L + 1 + 14 * (7 * n_cp + 1) + 1  # talker step + codec head, then the CP
    first = 1 + 14 * (7 * n_cp + 1) + 1  # prefill (plain) + codec-head row, then the CP
    text9 = "Hello from the packed int4 path of the H100 port."
    for c in (tkk.talker_decode_step, cpk.predict_codes_fused, tq.quant_gemv, attn.decode_attention_inner):
        c.launches = 0
    t0 = time.time()
    wav9, info9 = packed.generate(text9, speaker="aiden", language="english", seed=0,
                                  max_tokens=24, return_info=True)
    gen9_s = time.time() - t0
    n9 = info9.generation_token_count
    eos9 = n9 < 24
    k4_launches = tq.quant_gemv.launches
    want = first + per_frame * (n9 - 1) + (7 * L + 1) * int(eos9)
    log(f"[9] checkpoint (0.6B, int4 group 64) written in {ckpt_s:.1f} s, loaded packed in "
        f"{load_s:.1f} s; generate(): {n9} frames{' (EOS)' if eos9 else ''}, {len(wav9)} samples, "
        f"{gen9_s:.2f} s; launches K4 {k4_launches} (formula {first} + {per_frame} x (n - 1)"
        f"{' + ' + str(7 * L + 1) + ' for the EOS step' if eos9 else ''} = {want}), "
        f"K3 {attn.decode_attention_inner.launches}, K1 {tkk.talker_decode_step.launches}, "
        f"K2 {cpk.predict_codes_fused.launches}")
    check(k4_launches == want, f"K4 ran {k4_launches} times, the formula says {want}")
    check(tkk.talker_decode_step.launches == 0 and cpk.predict_codes_fused.launches == 0,
          "K1/K2 ran on packed weights")
    check(bool(np.isfinite(wav9).all()) and len(wav9) == n9 * 1920, f"waveform {len(wav9)} samples")
    t0 = time.time()
    dflt = Qwen3TTSModel.from_pretrained(ckpt)
    dflt.tokenizer = StubTokenizer(cfg.text_vocab_size)
    load_d = time.time() - t0
    check(isinstance(dflt.talker_params["layers"]["qkv_proj"], tq.Int8Linear)
          and isinstance(dflt.cp_params["layers"]["qkv_proj"], tq.Int8Linear),
          "the default load is not int8 and fused")
    for c in (tkk.talker_decode_step, cpk.predict_codes_fused, tq.quant_gemv):
        c.launches = 0
    wav9d, info9d = dflt.generate(text9, speaker="aiden", language="english", seed=0,
                                  max_tokens=24, return_info=True)
    n9d = info9d.generation_token_count
    log(f"    default load (int8, fused) in {load_d:.1f} s: {n9d} frames, launches K1 "
        f"{tkk.talker_decode_step.launches}, K2 {cpk.predict_codes_fused.launches}, "
        f"K4 {tq.quant_gemv.launches}")
    check(cpk.predict_codes_fused.launches == n9d and tkk.talker_decode_step.launches
          == n9d - 1 + int(n9d < 24), "K1/K2 did not carry the default load's frames")
    check(tq.quant_gemv.launches == 0 and bool(np.isfinite(wav9d).all()), "default load output")
    del dflt  # phase w loads the same directory through the CLI

    # ---- 10. packed teacher-forced greedy codes: K4 against plain ----
    from qwen3tts_tpu_torch.models import code_predictor as cpm

    greedy = gen.SamplingConfig(0.0, 50, 1.0, 1.0, forbid_eos=True)
    prefill10 = torch.randn(1, 64, H, generator=g, device=dev).mul(0.05).to(torch.bfloat16)
    trail10 = torch.randn(16, H, generator=g, device=dev).mul(0.05).to(torch.bfloat16)
    pad10 = torch.zeros(H, dtype=torch.bfloat16, device=dev)
    res10 = gen.generate_codes(
        pt_, pc_, talker_cfg=cfg, cp_cfg=cpc, sampling=greedy, prefill_embeds=prefill10,
        prefill_len=24, trailing_embeds=trail10, trailing_len=8, tts_pad_embed=pad10,
        max_steps=8, max_frames=8, seed=0, cache_len=256)
    codes10 = res10.codes.cpu()

    def replay_logits():
        """Logits at every sampled position, fed the codes above."""
        out = []
        cache = tk.make_cache(cfg, 1, 256, torch.bfloat16, dev)
        hid, cache = tk.forward(pt_, cfg, prefill10, cache, 0)
        h_last, off = hid[:, 23], 24
        for f in range(8):
            out.append(tk.codec_logits(pt_, h_last[:, None])[0, 0, :2048])
            c0 = codes10[f, :1].to(dev)
            rest = codes10[f:f + 1, 1:].to(dev)
            cc = cpm.make_cp_cache(cpc, 1, torch.bfloat16, dev)
            x0 = torch.stack([h_last, tk.embed_codec(pt_, c0).to(torch.bfloat16)], dim=1)
            hc, cc = cpm.forward(pc_, cpc, x0, cc, 0)
            for j in range(15):
                out.append(cpm.head_logits(pc_, hc[:, -1], j)[0])
                if j < 14:
                    e = tk._embed(pc_["codec_embedding"][j], rest[:, j]).to(torch.bfloat16)
                    hc, cc = cpm.forward(pc_, cpc, e[:, None], cc, j + 2)
            x = gen._next_input(pc_, pt_, trail10, 8, pad10, f, c0, rest)
            hid, cache = tk.forward(pt_, cfg, x, cache, off)
            h_last, off = hid[:, 0], off + 1
        return torch.stack([r.float() for r in out]).cpu()

    lk10 = replay_logits()
    tk.quant_gemv = tq.quant_matmul  # the same loop through K4's plain version
    try:
        lr10 = replay_logits()
    finally:
        tk.quant_gemv = tq.quant_gemv
    fed = codes10[:8].reshape(-1)
    k4_path_abs = float((lk10 - lr10).abs().max())
    flips = 0
    for i, c in enumerate(fed.tolist()):
        best = int(lr10[i].argmax())
        check(int(lk10[i].argmax()) == c, f"position {i}: greedy code is not the kernel's argmax")
        if best != c:
            flips += 1
            check(near_tie(lr10[i], best, c, k4_path_abs), f"position {i}: code {c} vs plain "
                  f"{best} beyond a near-tie (logit error {k4_path_abs:.4g})")
    log(f"[10] packed teacher-forced greedy codes (8 frames, {len(fed)} positions): "
        f"{len(fed) - flips}/{len(fed)} equal to the plain version's argmax, {flips} near-ties; "
        f"logits max abs err {k4_path_abs:.3g}, scaled {scaled(lk10, lr10):.3g}")

    # ---- 11. the packed headline and the long cache ----
    def packed_e2e(seed, cache_len=cache_len, steps=frames):
        torch.cuda.synchronize()
        t = time.time()
        _c, nf, w, _ = _generate_and_decode(pt_, pc_, packed.vocoder_params, dec_cfg=dec_cfg,
                                            **run, max_steps=steps, seed=seed, cache_len=cache_len)
        torch.cuda.synchronize()
        check(nf == steps and bool(torch.isfinite(w).all()), "packed run malformed")
        return time.time() - t

    packed_e2e(0)  # warm-up
    walls11 = [packed_e2e(s) for s in (1, 2, 3)]
    wall11 = statistics.median(walls11)

    def packed_decode_ms(steps: int) -> float:
        """ms per frame of generate_chunk after the first frame."""
        c = gen.prefill_start(pt_, pc_, **run, cache=tk.make_cache(cfg, 1, cache_len,
                                                                   torch.bfloat16, dev), seed=9)
        torch.cuda.synchronize()
        t = time.time()
        gen.generate_chunk(pt_, pc_, c, talker_cfg=cfg, cp_cfg=cpc, sampling=sampling,
                           trailing_embeds=trailing, trailing_len=12, tts_pad_embed=pad,
                           until_step=1 + steps)
        torch.cuda.synchronize()
        return (time.time() - t) * 1000 / steps

    ms11 = packed_decode_ms(frames - 1)
    tk.quant_gemv = tq.quant_matmul
    try:
        ms11_plain = packed_decode_ms(20)
    finally:
        tk.quant_gemv = tq.quant_gemv
    rtf11 = wall11 / (frames / 12.5)
    log(f"[11] packed headline (66 frames, forbid_eos, T=0.9 top-k 50 rep 1.05): wall "
        f"{wall11:.3f} s (runs {', '.join(f'{w:.3f}' for w in walls11)}), RTF {rtf11:.4f}; "
        f"decode {ms11:.2f} ms/frame with K4, {ms11_plain:.2f} ms/frame on plain quant_matmul  "
        f"[{smi}]")

    for c in (tkk.talker_decode_step, cpk.predict_codes_fused, tq.quant_gemv, attn.decode_attention_inner):
        c.launches = 0
    long_s = packed_e2e(5, cache_len=4096, steps=32)
    k3_launches = attn.decode_attention_inner.launches
    log(f"    long cache (32 frames, 4096-row cache): {long_s:.3f} s; launches K3 {k3_launches} "
        f"(= {L} x 31 decode steps: {k3_launches == L * 31}), K4 {tq.quant_gemv.launches}")
    check(k3_launches == L * 31, f"K3 ran {k3_launches} times for 31 decode steps")

    def step_ms() -> float:
        """ms per packed talker step (tk.forward at S=1) at pos 40 of a 4096-row cache."""
        cache = tk.make_cache(cfg, 1, 4096, torch.bfloat16, dev)
        xs = torch.randn(1, 1, H, generator=g, device=dev).mul(0.05).to(torch.bfloat16)
        return timed(lambda: tk.forward(pt_, cfg, xs, cache, 40), 10)

    st_k3 = step_ms()
    gate = tk.attention_kernel_gate
    tk.attention_kernel_gate = lambda *a: False  # the masked attention over all 4096 rows
    try:
        st_plain = step_ms()
    finally:
        tk.attention_kernel_gate = gate
    log(f"    packed talker step on a 4096-row cache: {st_k3:.3f} ms with K3, {st_plain:.3f} ms "
        f"with the plain masked attention  [{smi}]")

    # where a packed frame's time goes: one torch.profiler window over 5
    # frames (after the prompt) on the 4096-row cache, where K4 and K3 run
    def five_frames(prof=None) -> float:
        c = gen.prefill_start(pt_, pc_, **run, cache=tk.make_cache(cfg, 1, 4096, torch.bfloat16, dev),
                              seed=9)
        torch.cuda.synchronize()
        t = time.time()
        if prof is not None:
            prof.start()
        gen.generate_chunk(pt_, pc_, c, talker_cfg=cfg, cp_cfg=cpc, sampling=sampling,
                           trailing_embeds=trailing, trailing_len=12, tts_pad_embed=pad, until_step=6)
        torch.cuda.synchronize()
        if prof is not None:
            prof.stop()
        return (time.time() - t) * 1000 / 5

    frame_ms = statistics.median(five_frames() for _ in range(3))
    for _ in range(3):  # a window now and then records no device events: take it again
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        five_frames(prof)
        iv = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        if iv:
            break
    check(iv, "the profiler recorded no device events in three windows")
    busy, end = 0.0, float("-inf")  # us: the union of the device intervals
    for _, a, b in sorted(iv, key=lambda r: r[1]):
        if b > end:
            busy, end = busy + b - max(a, end), b
    groups = {"K4": ("quant_gemv_kernel",), "K3": ("attn_chunk",)}
    dev_ms = {k: [0.0, 0] for k in (*groups, "other")}
    for name, a, b in iv:
        key = next((k for k, pats in groups.items() if any(p in name for p in pats)), "other")
        dev_ms[key][0] += (b - a) / 1000 / 5
        dev_ms[key][1] += 1
    log(f"    packed frame on a 4096-row cache: wall {frame_ms:.2f} ms/frame (median of 3, profiler "
        f"off); device busy {busy / 1000 / 5:.2f} ms/frame = {busy / 1000 / 5 / frame_ms:.3f} of "
        f"the wall; device ms/frame " + ", ".join(
            f"{k} {ms:.3f} ({n // 5} kernels, {1000 * ms * 5 / max(n, 1):.2f} us each)"
            for k, (ms, n) in dev_ms.items()) + f"  [{smi}]")

    # ==== the lockstep batch and the int8 KV cache (phases a-e) ====
    from qwen3tts_tpu_torch.models import batch_generate as bg

    NQ = cfg.num_attention_heads
    fused = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
    norms = ("input_layernorm", "post_attention_layernorm", "q_norm", "k_norm")

    def proj_keys(p):
        """The layer stack's projections: fused, or (a CP) unfused int8."""
        return fused if "qkv_proj" in p["layers"] else cpk.UNFUSED_KEYS

    def stack_ws(p):
        """The projections' operands in either weight mode: int8 with its
        scales, or dense bf16."""
        return [t for k in proj_keys(p) for t in tkk._weight(p["layers"][k])]

    def stack_elems(p):
        return sum(tkk._weight(p["layers"][k])[0].numel() for k in proj_keys(p))

    def k1_io(B, prefix_rows, kv_quant, sample, logits=False, p=None, c=cfg):
        """(bytes, flops) of one K1 call on weights ``p`` (int8 or bf16) at
        ``c``'s widths: weights once, x, each row's prefix read and new row
        written, the hidden out; the head, seen, mask, codes and logits in
        sample mode."""
        p = talker_p if p is None else p
        L_, NKV_, NQ_, H_, V_ = (c.num_hidden_layers, c.num_key_value_heads,
                                 c.num_attention_heads, c.hidden_size, c.vocab_size)
        per_row = L_ * NKV_ * D * 2 * (1 if kv_quant else 2) + (L_ * NKV_ * 2 * 4 if kv_quant else 0)
        n = (nbytes(*stack_ws(p), *(p["layers"][k] for k in norms), p["norm"])
             + 2 * B * H_ * 2 + (prefix_rows + B) * per_row)
        flops = 2 * B * stack_elems(p) + 4 * L_ * NQ_ * D * (prefix_rows + B)
        if sample:
            head_w = tkk._weight(p["codec_head"])
            n += nbytes(*head_w) + B * V_ + V_ * 4 + B * 4 + (B * V_ * 4 if logits else 0)
            flops += 2 * B * head_w[0].numel()
        return n, flops

    def k2_reread(p=None):
        """What K2's design moves: the stack (and the projection) re-read at
        each of 16 positions and one head per sampled position."""
        p = cp_p if p is None else p
        proj = p.get("small_to_mtp_projection")
        return (16 * nbytes(*stack_ws(p), *([] if proj is None else [proj["w"], proj["b"]]))
                + nbytes(*tkk._weight(p["lm_head"])))

    def k2_io(B, p=None, c=cpc, th=H):
        """(bytes, flops) of one K2 call on weights ``p`` (int8 or bf16, with
        the projection from talker width ``th`` where the CP is narrower),
        each input read once: the stack, the 15 heads and the projection,
        x0, the 15 sampled embedding rows per row, codes and esum out; 16
        positions through the projection and the stack and 15 heads per
        row."""
        p = cp_p if p is None else p
        NCB, Vc, Hc = c.num_code_groups - 1, c.vocab_size, c.hidden_size
        proj = p.get("small_to_mtp_projection")
        n = (nbytes(*stack_ws(p), *(p["layers"][k] for k in norms), p["norm"],
                    *tkk._weight(p["lm_head"]), *([] if proj is None else [proj["w"], proj["b"]]))
             + B * 2 * th * 2 + NCB * B * th * 2 + B * NCB * 4 + B * th * 4)
        flops = (2 * B * (16 * stack_elems(p) + NCB * Hc * Vc + (16 * th * Hc if proj else 0))
                 + 16 * 4 * c.num_hidden_layers * c.num_attention_heads * D * 16)
        return n, flops

    k1_bound = bound(*k1_io(1, pos, False, True))
    k2_bound = bound(*k2_io(1))

    def batch_case(B, T, kv_quant, lo, hi, seed, prefill=False, p=None, c=cfg):
        """x, a cache of T rows, ragged offsets in [lo, hi), rope rows and
        seen sets, for weights ``p`` (default: the int8 talker) at ``c``'s
        widths. ``prefill``: the cache rows come from the model's own
        prefill of ``hi`` random prompt rows (the comparisons); otherwise
        they are random (the timings)."""
        p = talker_p if p is None else p
        gb = torch.Generator(device=dev).manual_seed(seed)
        cache = tk.make_cache(c, B, T, torch.bfloat16, dev, quantized=kv_quant)
        H_ = c.hidden_size
        if prefill:
            pre = torch.randn(B, hi, H_, generator=gb, device=dev).mul(0.05).to(torch.bfloat16)
            tk.forward(p, c, pre, cache, 0)
            del pre
        elif kv_quant:  # random int8 rows with scales of a bf16 cache of the same spread
            cache.k.copy_(torch.randint(-127, 128, cache.k.shape, generator=gb, device=dev))
            cache.v.copy_(torch.randint(-127, 128, cache.v.shape, generator=gb, device=dev))
            cache.ks.copy_(torch.rand(cache.ks.shape, generator=gb, device=dev).mul(0.03))
            cache.vs.copy_(torch.rand(cache.vs.shape, generator=gb, device=dev).mul(0.015))
        else:
            cache.k.copy_(torch.randn(cache.k.shape, generator=gb, device=dev))
            cache.v.copy_(torch.randn(cache.v.shape, generator=gb, device=dev).mul(0.5))
        offs = torch.randint(lo, hi, (B,), generator=gb, device=dev, dtype=torch.int32)
        xb = torch.randn(B, 1, H_, generator=gb, device=dev).mul(0.05).to(torch.bfloat16)
        rope = mrope_cos_sin(torch.arange(T, device=dev)[None], D, c.rope_theta,
                             c.mrope_section, torch.bfloat16)
        seen_b = torch.rand(B, V, generator=gb, device=dev) < 0.005
        return cache, offs, xb, rope[0][0][offs.long()], rope[1][0][offs.long()], seen_b

    def clone(c):
        return type(c)(*(a.clone() for a in c))

    def pen_b(logits, seen_b):
        return torch.where(seen_b, torch.where(logits < 0, logits * 1.05, logits / 1.05), logits)

    def k1_wide(x, cache, offs, cos, sin, tp_=None, tc_=None):
        """K1's step in float64, written from the model's maths and not from
        K1's plain version: the same int8 weights (``tp_``, default the 0.6B
        talker, at ``tc_``'s widths), bf16 inputs, cache rows and rope rows,
        the prefix dequantized (rows times scales), the current token's own
        unquantized k/v, and no rounding between operations (nor any
        quantization of the activations). Returns the post-norm hidden
        [B, H], the codec head's logits [B, V] and the new k and v rows
        [L, B, NKV, D]."""
        tp_, tc_ = (talker_p, cfg) if tp_ is None else (tp_, tc_)
        f, B, eps = torch.float64, x.shape[0], tc_.rms_norm_eps
        L, NQ, NKV, H = (tc_.num_hidden_layers, tc_.num_attention_heads,
                         tc_.num_key_value_heads, tc_.hidden_size)
        G = NQ // NKV
        lay = tp_["layers"]

        def mv(a, w):
            return (a @ w.q.to(f)) * w.scale.reshape(-1).to(f)

        def norm(a, w):
            return a * torch.rsqrt(a.pow(2).mean(-1, keepdim=True) + eps) * w.to(f)

        c, s = cos.to(f)[:, None], sin.to(f)[:, None]

        def rot(a):
            return a * c + torch.cat([-a[..., D // 2:], a[..., : D // 2]], -1) * s

        h = x.reshape(B, H).to(f)
        prefix = torch.arange(cache.max_len, device=dev)[None] < offs.long()[:, None]  # [B, T]
        k_new, v_new = [], []
        for l in range(L):
            qkv = mv(norm(h, lay["input_layernorm"][l]), lay["qkv_proj"][l])
            q = rot(norm(qkv[:, : NQ * D].reshape(B, NQ, D), lay["q_norm"][l])).reshape(B, NKV, G, D)
            k = rot(norm(qkv[:, NQ * D : (NQ + NKV) * D].reshape(B, NKV, D), lay["k_norm"][l]))
            v = qkv[:, (NQ + NKV) * D :].reshape(B, NKV, D)
            k_new.append(k)
            v_new.append(v)
            kc, vc = cache.k[l].to(f), cache.v[l].to(f)  # [B, NKV, T, D]
            if cache.quantized:
                kc, vc = kc * cache.ks[l].to(f)[..., None], vc * cache.vs[l].to(f)[..., None]
            sc = torch.einsum("bhgd,bhtd->bhgt", q, kc) * D**-0.5
            sc = sc.masked_fill(~prefix[:, None, None], float("-inf"))
            cur = torch.einsum("bhgd,bhd->bhg", q, k)[..., None] * D**-0.5
            p = torch.softmax(torch.cat([sc, cur], -1), -1)
            o = torch.einsum("bhgt,bhtd->bhgd", p[..., :-1], vc) + p[..., -1:] * v[:, :, None]
            h = h + mv(o.reshape(B, NQ * D), lay["o_proj"][l])
            gu = mv(norm(h, lay["post_attention_layernorm"][l]), lay["gate_up_proj"][l])
            gate, up = gu.chunk(2, -1)
            h = h + mv(gate * torch.sigmoid(gate) * up, lay["down_proj"][l])
        hn = norm(h, tp_["norm"])
        head = tp_["codec_head"]
        logits = mv(hn, head) if hasattr(head, "q") else hn @ head.to(f)
        return hn, logits, torch.stack(k_new), torch.stack(v_new)

    # ---- a. K1 at B = 8 and 64 against its plain version ----
    # On caches that the model's own prefill wrote, within the bf16 bound
    # (0.05) of each other. On a random 512-row int8 cache at B=64 both are
    # held against the float64 step instead: K1 within 1.5x (+ 0.005) of
    # the plain version's distance to it, and that distance under 0.1.
    k1b = {}
    for B in (8, 64):
        cases = [(False, 128, 20, 120, True), (True, 512, 100, 500, True)]
        if B == 64:
            cases.append((True, 512, 100, 500, False))
        for kv_quant, T, lo, hi_, prefilled in cases:
            cache, offs, xb, cos_b, sin_b, seen_b = batch_case(B, T, kv_quant, lo, hi_, B + T,
                                                               prefill=prefilled)

            def k1b_call(fn, c, temperature=0.0, seed=(1, 2), sample=True, logits=True):
                kw = dict(temperature=temperature, top_k=50, rep_penalty=1.05, eos_id=-1,
                          seed=seed, suppress_add=supp, seen=seen_b, return_logits=logits)
                if not sample:
                    kw = dict(sample=False)
                return fn(talker_p, cfg, xb, c, offs, cos_b, sin_b, **kw)

            ck, cr = clone(cache), clone(cache)
            hk, codek, lk = k1b_call(tkk.talker_decode_step, ck)
            hr, coder, lr = k1b_call(tkk.talker_decode_step_ref, cr)
            torch.cuda.synchronize()
            rows, posb = torch.arange(B, device=dev), offs.long()
            new = []
            for i in range(2):  # the new k, v rows (dequantized for an int8 cache)
                a, b = ck[i][:, rows, :, posb], cr[i][:, rows, :, posb]
                if kv_quant:
                    a = tk.dequantize_kv(a, ck[2 + i][:, rows, :, posb])
                    b = tk.dequantize_kv(b, cr[2 + i][:, rows, :, posb])
                new.append(scaled(a, b))
            errs = dict(h=scaled(hk, hr), logits=scaled(lk, lr), k=new[0], v=new[1])
            abs_err = float((lk - lr).abs().max())
            z = pen_b(lr, seen_b) + supp
            flips = 0
            for b in range(B):
                a_, b_ = int(codek[b]), int(coder[b])
                if a_ != b_:
                    flips += 1
                    check(near_tie(z[b], a_, b_, abs_err),
                          f"K1 B={B} greedy code0 row {b} differs beyond a near-tie")
            hn = k1b_call(tkk.talker_decode_step, clone(cache), sample=False)
            hn_r = k1b_call(tkk.talker_decode_step_ref, clone(cache), sample=False)
            errs["h non-sample"] = scaled(hn, hn_r)
            check(torch.equal(hn, hk), "K1 non-sample hidden differs from the sample mode's")
            h64 = k1_wide(xb, cache, offs, cos_b, sin_b)[0]
            wide = (scaled(hn, h64), scaled(hn_r, h64))
            del h64
            mism = 0
            for s in range(4):  # sampled code0 over seeds, every row
                seed = (6000 + s, 13 * s + 1)
                _, a_s, la = k1b_call(tkk.talker_decode_step, clone(cache), 0.9, seed)
                _, b_s, lb = k1b_call(tkk.talker_decode_step_ref, clone(cache), 0.9, seed)
                for b in range(B):
                    a_, b_ = int(a_s[b]), int(b_s[b])
                    if a_ != b_:
                        mism += 1
                        delta = 1.05 * float((la[b] - lb[b]).abs().max())
                        noise = gumbel_noise(seed[0], seed[1], 16 * b, V, dev)
                        check(sampled_flip_explained(pen_b(lb[b], seen_b[b]) + supp, a_, b_,
                                                     delta, noise),
                              f"K1 B={B} sampled code0 row {b} differs beyond a near-tie")
            if kv_quant:  # layer 0's rows depend on x alone: bit-equal to quantize_kv_rows
                cb = tk.make_cache(cfg, B, T, torch.bfloat16, dev)
                cq = clone(cache)
                k1b_call(tkk.talker_decode_step, cq, sample=False)
                k1b_call(tkk.talker_decode_step, cb, sample=False)
                for qc, sc, bc in ((cq.k, cq.ks, cb.k), (cq.v, cq.vs, cb.v)):
                    q_ref, s_ref = tk.quantize_kv_rows(bc[0, rows, :, posb])
                    check(torch.equal(qc[0, rows, :, posb], q_ref)
                          and torch.equal(sc[0, rows, :, posb], s_ref),
                          f"K1 B={B}: int8 rows or scales written in place differ")
            if prefilled:
                check(max(errs.values()) < 0.05, f"K1 B={B} outside the bf16 bound: {errs}")
            log(f"[a] K1 B={B} {'int8' if kv_quant else 'bf16'} cache of {T}, "
                f"{'prefilled' if prefilled else 'random'} (offsets "
                f"{int(offs.min())}..{int(offs.max())}): scaled err " + ", ".join(
                    f"{k} {v:.3g}" for k, v in errs.items()) + f" (logits max abs {abs_err:.3g}); "
                f"hidden against the float64 step: kernel {wide[0]:.4g}, plain {wide[1]:.4g}; "
                f"greedy code0 {B - flips}/{B} equal, {flips} near-ties; sampled 4 seeds x {B} rows: "
                f"{4 * B - mism}/{4 * B} equal, {mism} near-ties"
                + ("; int8 rows and scales written in place bit-equal" if kv_quant else ""))
            check(prefilled or (wide[0] <= 1.5 * wide[1] + 0.005 and wide[1] < 0.1),
                  f"K1 B={B} against the float64 step: kernel {wide[0]:.3g}, plain {wide[1]:.3g}")
            if prefilled:
                t_k = timed(lambda: k1b_call(tkk.talker_decode_step, ck, 0.9, (3, 4), logits=False), 20)
                t_p = timed(lambda: k1b_call(tkk.talker_decode_step_ref, cr, 0.9, (3, 4), logits=False), 2)
                t_d = device_ms(lambda: k1b_call(tkk.talker_decode_step, ck, 0.9, (3, 4), logits=False), 10)
                bnd = bound(*k1_io(B, int(offs.sum()), kv_quant, True))
                k1b[(B, kv_quant)] = dict(abs=abs_err, ms=t_k, plain_ms=t_p, dev_ms=t_d, bound=bnd)
                log(f"    K1 B={B}: {t_k:.3f} ms/step back to back, device {t_d:.3f} ms, bound "
                    f"{bnd[0]:.3f} ms ({bnd[1]}), plain {t_p:.3f} ms  [{smi}]")
            del cache, ck, cr

    def library_launches(fn):
        """Operations (kernel launches, memsets) one call of fn enqueues
        through the kernel library, as the library counts them on the host
        (``_cuda.launches``): exact. A profiler window can drop device
        records (on an H100 one window recorded 207 of a K1 call's 232 and
        670 of a K2 call's 695, and three windows of one call each came
        short in another run), so it decides nothing here."""
        fn()
        torch.cuda.synchronize()
        n0 = _cuda.launches()
        fn()
        torch.cuda.synchronize()
        return _cuda.launches() - n0

    # ---- b. K2 at B = 8 and 64 against its plain version ----
    k2b = {}
    for B in (8, 64):
        gb = torch.Generator(device=dev).manual_seed(B)
        hb = torch.randn(B, H, generator=gb, device=dev).mul(0.3).to(torch.bfloat16)
        c0b = torch.randint(0, 2048, (B,), generator=gb, device=dev, dtype=torch.int32)

        def k2b_call(fn, temperature, seed, **kw):
            return fn(cp_p, cpc, talker_p, hb, c0b, seed, temperature=temperature, top_k=50, **kw)

        cr_, er_, lr_ = k2b_call(cpk.predict_codes_fused_ref, 0.0, (5, 6), return_logits=True)
        ck_, ek_, lk_ = k2b_call(cpk.predict_codes_fused, 0.0, (5, 6), force_codes=cr_,
                                 return_logits=True)
        torch.cuda.synchronize()
        abs_err = float((lk_ - lr_).abs().max())
        err_lg = scaled(lk_, lr_)
        check(err_lg < 0.05, f"K2 B={B} logits outside the bound")
        check(torch.equal(ek_, er_), f"K2 B={B} esum differs (same rows, same order)")
        flips = 0
        for b in range(B):
            for j in range(15):
                a_, c_ = int(ck_[b, j]), int(cr_[b, j])
                if a_ != c_:
                    flips += 1
                    check(near_tie(lr_[j, b], a_, c_, abs_err), f"K2 B={B} code ({b}, {j}) beyond a near-tie")
        mism = 0
        for s in range(3):
            seed = (7000 + s, 17 * s + 3)
            ca, _, la = k2b_call(cpk.predict_codes_fused, 0.9, seed, return_logits=True)
            cb_, _, lb = k2b_call(cpk.predict_codes_fused_ref, 0.9, seed, return_logits=True)
            for b in range(B):
                diff = (ca[b] != cb_[b]).nonzero()
                if len(diff):
                    mism += 1
                    j = int(diff[0, 0])  # later positions follow different inputs
                    a_, c_ = int(ca[b, j]), int(cb_[b, j])
                    delta = float((la[j, b] - lb[j, b]).abs().max())
                    noise = gumbel_noise(seed[0], seed[1], j + 1 + 16 * b, cpc.vocab_size, dev)
                    check(sampled_flip_explained(lb[j, b], a_, c_, delta, noise),
                          f"K2 B={B} sampled code ({b}, {j}) beyond a near-tie")
        t_k = timed(lambda: k2b_call(cpk.predict_codes_fused, 0.9, (3, 4)), 10)
        t_p = timed(lambda: k2b_call(cpk.predict_codes_fused_ref, 0.9, (3, 4)), 1)
        t_d = device_ms(lambda: k2b_call(cpk.predict_codes_fused, 0.9, (3, 4)), 5)
        bnd = bound(*k2_io(B))
        k2b[B] = dict(abs=abs_err, ms=t_k, plain_ms=t_p, dev_ms=t_d, bound=bnd)
        log(f"[b] K2 B={B} (teacher-forced greedy): scaled logits err {err_lg:.3g} (max abs "
            f"{abs_err:.3g}), esum bit-equal, codes {15 * B - flips}/{15 * B} equal, {flips} "
            f"near-ties; sampled 3 seeds x {B} rows: {3 * B - mism}/{3 * B} rows equal, {mism} "
            f"explained by near-ties")
        log(f"    K2 B={B}: {t_k:.3f} ms/frame back to back, device {t_d:.3f} ms, bound "
            f"{bnd[0]:.3f} ms ({bnd[1]}; the design's re-read of the stack at 16 positions: "
            f"{k2_reread() / HBM_BYTES_S * 1e3:.3f} ms), plain {t_p:.3f} ms  [{smi}]")
    # where K2's B=64 frame spends its device time, by kernel kind, in both
    # modes (the B=64 rows above), from one profiler window that recorded
    # every kernel of its calls (the library's and the wrapper's operand copies)
    for k2_mode in ("wo_bf16", "dyn_int8"):
        k2_kinds = {}
        for name, t in device_ms_by_kernel(lambda: k2b_call(
                cpk.predict_codes_fused, 0.9, (3, 4), mode=k2_mode), 5).items():
            k2_kinds[tkt.kind_of(name)] = k2_kinds.get(tkt.kind_of(name), 0.0) + t
        log(f"    K2 B=64 {k2_mode}: device {sum(k2_kinds.values()):.3f} ms/frame = " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(k2_kinds.items(), key=lambda kv: -kv[1]))
            + f"  [{smi}]")
    # the batched GEMV alone at B=64 at the CP's shapes: the tensor-core form
    # K2 runs, the CUDA-core form K1 runs, and one library call as yardstick
    # (torch.matmul on the weights in bf16; torch._int_mm on the quantized
    # rows), which the port never calls
    gemv_b64 = []
    tkt.gemv_alone(dev, gemv_b64.append)
    for g64 in gemv_b64:
        g64_lib = g64["library_ms"]
        log(f"    batched GEMV B=64 {g64['shape']} ({g64['I']} x {g64['O']}) {g64['mode']}: tensor "
            f"cores {g64['mma_ms']:.4f} ms, CUDA cores {g64['fma_ms']:.4f}, {g64['library']} "
            + (f"{g64_lib:.4f}" if isinstance(g64_lib, float) else str(g64_lib))
            + f", bound {g64['bound_ms']:.4f} ({g64['bound_by']})")

    # ---- c. generate_batch(8 texts) on a bf16 and an int8 cache ----
    texts = ["Hello from the batched decode.", "The second voice reads a longer sentence here.",
             "Three.", "Batch lane four speaks.", "Lockstep frames for every row.",
             "An int8 cache halves the bytes.", "Seven texts and then", "one more to make eight."]
    gb_frames = {}
    for kv in ("bf16", "int8"):
        mb = Qwen3TTSModel(
            C.ModelConfig(talker_config=cfg, tts_model_type="custom_voice", tts_model_size="0b6"),
            talker_p, cp_p, voc_p, tokenizer_config=C.TokenizerConfig(decoder_config=dec_cfg),
            tokenizer=StubTokenizer(cfg.text_vocab_size), dtype=torch.bfloat16, device=dev,
            kv_cache_dtype=kv)
        tkk.talker_decode_step.launches = 0
        cpk.predict_codes_fused.launches = 0
        t0 = time.time()
        wavs = mb.generate_batch(texts, speakers=["aiden", "vivian"] * 4, language="english",
                                 seed=0)
        wall_c = time.time() - t0
        n1c, n2c = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
        n_tot = mb.last_info.generation_token_count
        lens = [len(w) for w in wavs]
        log(f"[c] generate_batch(8 texts), {kv} cache: {n_tot} frames in all, per-row samples "
            f"{lens}, {wall_c:.2f} s; launches K1 {n1c} (lockstep frames after the first), "
            f"K2 {n2c} (every lockstep frame)")
        check(n1c >= 1 and n2c == n1c + 1, f"K1 {n1c} / K2 {n2c} launches for the lockstep frames")
        check(n1c + 1 >= max(lens) // 1920, "fewer lockstep frames than the longest row's")
        check(all(bool(np.isfinite(w).all()) and len(w) > 0 and len(w) % 1920 == 0 for w in wavs)
              and sum(lens) <= n_tot * 1920, "batched waveforms malformed")
        gb_frames[kv] = (n1c, n2c)
        del mb

    # ---- d. the batched headline: 66 frames, forbid_eos, B x cache grid ----
    grid = {}

    def batch_run(B, kv_quant, T, seed, steps=frames, tp_=None, cp_=None, c_=cfg, cc_=cpc):
        """One lockstep run of B rows (``generate_codes_batch``'s two stages,
        timed apart), on the int8 0.6B trees unless others are given."""
        tp_, cp_ = (talker_p if tp_ is None else tp_), (cp_p if cp_ is None else cp_)
        H_ = c_.hidden_size
        gb = torch.Generator(device=dev).manual_seed(seed)
        pre = torch.randn(B, p_bucket, H_, generator=gb, device=dev).mul(0.05).to(torch.bfloat16)
        trail = torch.randn(B, 64, H_, generator=gb, device=dev).mul(0.05).to(torch.bfloat16)
        lens_p = torch.full((B,), p_len, dtype=torch.int32, device=dev)
        lens_t = torch.full((B,), 12, dtype=torch.int32, device=dev)
        caps = torch.full((B,), steps, dtype=torch.int32, device=dev)
        common = dict(talker_cfg=c_, cp_cfg=cc_, sampling=sampling, trailing_embeds=trail,
                      trailing_lens=lens_t, tts_pad_embed=torch.zeros(H_, dtype=torch.bfloat16,
                                                                      device=dev))
        torch.cuda.synchronize()
        t0 = time.time()
        c = bg.prefill_start_batch(
            tp_, cp_, **common, prefill_embeds=pre, prefill_lens=lens_p,
            cache=tk.make_cache(c_, B, T, torch.bfloat16, dev, quantized=kv_quant),
            max_frames=72, seed=seed)
        torch.cuda.synchronize()
        t1 = time.time()
        c = bg.generate_chunk_batch(tp_, cp_, c, **common, max_steps=caps, until_step=72)
        torch.cuda.synchronize()
        t2 = time.time()
        check(c.frames.tolist() == [steps] * B, f"batched run B={B}: frames {c.frames.tolist()}")
        return t2 - t0, (t2 - t1) * 1000 / (steps - 1)

    for kv_quant, T in ((False, 128), (True, 512)):
        for B in (8, 16, 32, 48, 64):
            batch_run(B, kv_quant, T, 0)  # warm-up
            if B == 64:
                tkk.talker_decode_step.launches = 0
                cpk.predict_codes_fused.launches = 0
            runs = [batch_run(B, kv_quant, T, s) for s in (1, 2, 3)]
            if B == 64:
                grid_launches = (tkk.talker_decode_step.launches // 3,
                                 cpk.predict_codes_fused.launches // 3)
                check(grid_launches == (frames - 1, frames),
                      f"B=64 launches {grid_launches} for {frames} frames")
            wall_d = statistics.median(r[0] for r in runs)
            ms_d = statistics.median(r[1] for r in runs)
            grid[(B, kv_quant)] = (ms_d, B * 16 * frames / wall_d, wall_d / (frames / 12.5), wall_d)
            log(f"[d] B={B:2d} {'512-slot int8' if kv_quant else '128-slot bf16'}: "
                f"{ms_d:.2f} ms/lockstep frame, {B * 16 * frames / wall_d:.0f} codec tokens/s, "
                f"per-sequence RTF {wall_d / (frames / 12.5):.4f} (wall {wall_d:.3f} s, median of 3; "
                f"runs {', '.join(f'{r[0]:.3f}' for r in runs)})  [{smi}]")
    # K1 and K2 device time per frame at the main path's shapes (offsets 57,
    # mid-run) beside their bounds, and the plain path at B=8
    for B in (8, 64):
        for kv_quant, T in ((False, 128), (True, 512)):
            cache, _, xb, _, _, seen_b = batch_case(B, T, kv_quant, 56, 58, 5)
            offs = torch.full((B,), 57, dtype=torch.int32, device=dev)
            rope = mrope_cos_sin(offs.long()[None], D, cfg.rope_theta, cfg.mrope_section,
                                 torch.bfloat16)
            d1 = device_ms(lambda: tkk.talker_decode_step(
                talker_p, cfg, xb, cache, offs, rope[0][0], rope[1][0], temperature=0.9,
                top_k=50, rep_penalty=1.05, eos_id=-1, seed=(1, 2), suppress_add=supp,
                seen=seen_b), 10)
            b1 = bound(*k1_io(B, 57 * B, kv_quant, True))
            log(f"    B={B} {'int8' if kv_quant else 'bf16'}: K1 device {d1:.3f} ms/frame "
                f"(bound {b1[0]:.3f} ms, {b1[1]}), K2 device {k2b[B]['dev_ms']:.3f} ms/frame "
                f"(bound {k2b[B]['bound'][0]:.3f} ms, {k2b[B]['bound'][1]})  [{smi}]")
            del cache
    real_k1, real_k2 = tkk.talker_decode_step, cpk.predict_codes_fused
    tkk.talker_decode_step, cpk.predict_codes_fused = tkk.talker_decode_step_ref, cpk.predict_codes_fused_ref
    try:
        _, plain_ms8 = batch_run(8, False, 128, 9, steps=11)
    finally:
        tkk.talker_decode_step, cpk.predict_codes_fused = real_k1, real_k2
    log(f"    B=8 plain path (the kernels' plain versions in the same loop): "
        f"{plain_ms8:.2f} ms/lockstep frame over 10 frames  [{smi}]")
    # one profiler window over 5 lockstep frames at B=64 on the int8 cache
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    gb = torch.Generator(device=dev).manual_seed(4)
    B = 64
    common = dict(talker_cfg=cfg, cp_cfg=cpc, sampling=sampling,
                  trailing_embeds=torch.zeros(B, 64, H, dtype=torch.bfloat16, device=dev),
                  trailing_lens=torch.full((B,), 12, dtype=torch.int32, device=dev),
                  tts_pad_embed=pad)
    c = bg.prefill_start_batch(
        talker_p, cp_p, **common,
        prefill_embeds=torch.randn(B, p_bucket, H, generator=gb, device=dev).mul(0.05).to(torch.bfloat16),
        prefill_lens=torch.full((B,), p_len, dtype=torch.int32, device=dev),
        cache=tk.make_cache(cfg, B, 512, torch.bfloat16, dev, quantized=True), max_frames=72, seed=4)
    caps = torch.full((B,), 72, dtype=torch.int32, device=dev)
    c = bg.generate_chunk_batch(talker_p, cp_p, c, **common, max_steps=caps, until_step=4)
    torch.cuda.synchronize()
    t0 = time.time()
    prof.start()
    c = bg.generate_chunk_batch(talker_p, cp_p, c, **common, max_steps=caps, until_step=9)
    torch.cuda.synchronize()
    prof.stop()
    win_ms = (time.time() - t0) * 1000 / 5
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in iv:
        if b > end:
            busy, end = busy + b - max(a, end), b
    log(f"    B=64 int8 profiler window (5 lockstep frames): wall {win_ms:.2f} ms/frame with the "
        f"profiler on, device busy {busy / 1000 / 5:.2f} ms/frame = {busy / 1000 / 5 / win_ms:.3f} "
        f"of it  [{smi}]")

    # ---- e. generate() on an int8 KV cache at B=1 ----
    mq = Qwen3TTSModel(
        C.ModelConfig(talker_config=cfg, tts_model_type="custom_voice", tts_model_size="0b6"),
        talker_p, cp_p, voc_p, tokenizer_config=C.TokenizerConfig(decoder_config=dec_cfg),
        tokenizer=StubTokenizer(cfg.text_vocab_size), dtype=torch.bfloat16, device=dev,
        kv_cache_dtype="int8")
    tkk.talker_decode_step.launches = 0
    cpk.predict_codes_fused.launches = 0
    wav_e, info_e = mq.generate("Hello from the H100 port of the talker.", speaker="aiden",
                                language="english", seed=0, return_info=True)
    ne, n1e, n2e = info_e.generation_token_count, tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
    check(n2e == ne and n1e == ne - 1 + int(ne < max_steps), f"int8 generate: K1 {n1e} K2 {n2e} for {ne} frames")
    check(bool(np.isfinite(wav_e).all()) and len(wav_e) % 1920 == 0 and 0 < len(wav_e) <= ne * 1920,
          "int8 generate waveform")

    def e2e_q(seed):
        torch.cuda.synchronize()
        t = time.time()
        _c, nf, w, _ = _generate_and_decode(talker_p, cp_p, voc_p, dec_cfg=dec_cfg, **run,
                                            max_steps=frames, seed=seed, cache_len=cache_len,
                                            kv_quant=True)
        torch.cuda.synchronize()
        check(nf == frames and bool(torch.isfinite(w).all()), "int8 headline run malformed")
        return time.time() - t

    e2e_q(0)
    tkk.talker_decode_step.launches = 0
    walls_e = [e2e_q(s) for s in (1, 2, 3)]
    k1_int8_launches = tkk.talker_decode_step.launches
    check(k1_int8_launches == 3 * (frames - 1), f"K1 ran {k1_int8_launches} times on the int8 headline")
    wall_e = statistics.median(walls_e)
    log(f"[e] generate() on an int8 cache: {ne} frames, K1 {n1e}, K2 {n2e}; 66-frame headline "
        f"wall {wall_e:.3f} s (runs {', '.join(f'{w:.3f}' for w in walls_e)}), RTF "
        f"{wall_e / (frames / 12.5):.4f} against the bf16 headline's {rtf:.4f} (phase 6)  [{smi}]")
    # where the int8 cache's B=1 difference lies: K1's device time at the
    # headline's mid-run offset on each cache, and the decode loop's ms per
    # frame on each, in the order bf16, int8, int8, bf16
    k1_dev_b1 = {}
    for quant in (False, True):
        c1 = tk.make_cache(cfg, 1, cache_len, torch.bfloat16, dev, quantized=quant)
        tk.forward(talker_p, cfg, prefill[:, :57], c1, 0)
        r57 = mrope_cos_sin(torch.full((1, 1), 57, device=dev), D, cfg.rope_theta,
                            cfg.mrope_section, torch.bfloat16)
        k1_dev_b1[quant] = b1_ms(lambda: tkk.talker_decode_step(
            talker_p, cfg, x, c1, 57, r57[0][0, 0], r57[1][0, 0], temperature=0.9, top_k=50,
            rep_penalty=1.05, eos_id=-1, seed=(3, 4), suppress_add=supp, seen=seen), 20)
        del c1
    loop_ms = [decode_ms(False, q) for q in (False, True, True, False)]
    log(f"    B=1 at offset 57: K1 device {k1_dev_b1[False]:.4f} ms/step on the bf16 cache, "
        f"{k1_dev_b1[True]:.4f} on the int8; decode loop (bf16, int8, int8, bf16) "
        f"{', '.join(f'{m:.3f}' for m in loop_ms)} ms/frame  [{smi}]")

    # ==== dense-bf16 weights and the 1.7B model (phases f-j) ====
    def k1_compare(label, p, c, B, T, kv_quant, lo, hi_, seed, sampled=2, iters=20,
                   mode="wo_bf16"):
        """K1 on weights ``p`` at ``c``'s widths against its plain version, in
        matmul ``mode``, B rows at offsets in [lo, hi_) of a T-row cache that
        p's own prefill wrote (B=1 takes the int-offset form): greedy hidden,
        logits and new k/v rows within the bf16 bound (0.05 scaled, phases 3
        and a), code0 equal but for near-ties, the non-sample hidden equal to
        the sample mode's, then ``sampled`` seeds of sampled code0. Returns
        the error, the times (in dyn_int8 beside the same inputs' wo_bf16
        times) and the bound."""
        cache, offs, xb, cos_b, sin_b, seen_b = batch_case(B, T, kv_quant, lo, hi_, seed,
                                                           prefill=True, p=p, c=c)
        one = B == 1
        off = int(offs[0]) if one else offs
        args = (cos_b[0], sin_b[0], seen_b[0]) if one else (cos_b, sin_b, seen_b)

        def call(fn, cc, temperature=0.0, seed=(1, 2), logits=True, mode_=mode):
            out = fn(p, c, xb, cc, off, args[0], args[1], temperature=temperature, top_k=50,
                     rep_penalty=1.05, eos_id=-1, seed=seed, suppress_add=supp, seen=args[2],
                     return_logits=logits, mode=mode_)
            return tuple(t.reshape(B, -1) for t in out)

        ck, cr = clone(cache), clone(cache)
        (hk, codek, lk), (hr, coder, lr) = call(tkk.talker_decode_step, ck), call(
            tkk.talker_decode_step_ref, cr)
        torch.cuda.synchronize()
        rows, posb = torch.arange(B, device=dev), offs.long()
        errs = dict(h=scaled(hk, hr), logits=scaled(lk, lr))
        outs = dict(h=(hk, hr), logits=(lk, lr))
        for i, name in enumerate("kv"):  # the new rows (dequantized for an int8 cache)
            a, b = ck[i][:, rows, :, posb], cr[i][:, rows, :, posb]  # [B, L, NKV, D]
            if kv_quant:
                a = tk.dequantize_kv(a, ck[2 + i][:, rows, :, posb])
                b = tk.dequantize_kv(b, cr[2 + i][:, rows, :, posb])
            errs[name] = scaled(a, b)
            outs[name] = (a, b)
        abs_err = float((lk - lr).abs().max())
        wide = None
        if mode == "dyn_int8":
            # dyn_int8 quantizes every matvec's activation row to int8, so an
            # f32-order flip between kernel and plain version becomes a whole
            # int8 step (amax / 127 of the row): their distance reaches 0.0494
            # of phase 3's 0.05 at B=64 on the int8 cache, with no margin
            # for another seed. Both are held instead against the
            # float64 step of the model's maths (k1_wide, no rounding and no
            # activation quantization), as phase a holds a random int8 cache:
            # the kernel within 1.5x (+ 0.005) of the plain version's distance
            # on every output. That distance is the mode's own quantization
            # error; a plain version of another function would err by O(1),
            # so it stays under 0.25.
            ref = dict(zip(("h", "logits", "k", "v"), k1_wide(xb, cache, offs, cos_b, sin_b,
                                                              tp_=p, tc_=c)))
            ref["k"], ref["v"] = ref["k"].transpose(0, 1), ref["v"].transpose(0, 1)
            wide = {n: (scaled(a, ref[n]), scaled(b, ref[n])) for n, (a, b) in outs.items()}
            check(all(kd <= 1.5 * pd + 0.005 and pd < 0.25 for kd, pd in wide.values()),
                  f"K1 {label} against the float64 step (kernel, plain): {wide}")
        else:
            check(max(errs.values()) < 0.05, f"K1 {label} outside the bf16 bound: {errs}")
        hn = tkk.talker_decode_step(p, c, xb, clone(cache), off, args[0], args[1], sample=False,
                                    mode=mode)
        check(torch.equal(hn.reshape(B, -1), hk), f"K1 {label}: the non-sample hidden differs")
        z = pen_b(lr, seen_b) + supp
        flips = 0
        for b in range(B):
            a_, b_ = int(codek[b, 0]), int(coder[b, 0])
            if a_ != b_:
                flips += 1
                check(near_tie(z[b], a_, b_, abs_err), f"K1 {label} greedy code0 row {b} beyond a near-tie")
        mism = 0
        for s_ in range(sampled):
            seed = (8000 + s_, 19 * s_ + 1)
            _, a_s, la = call(tkk.talker_decode_step, clone(cache), 0.9, seed)
            _, b_s, lb = call(tkk.talker_decode_step_ref, clone(cache), 0.9, seed)
            for b in range(B):
                a_, b_ = int(a_s[b, 0]), int(b_s[b, 0])
                if a_ != b_:
                    mism += 1
                    noise = gumbel_noise(seed[0], seed[1], 16 * b, V, dev)
                    check(sampled_flip_explained(pen_b(lb[b], seen_b[b]) + supp, a_, b_,
                                                 1.05 * float((la[b] - lb[b]).abs().max()), noise),
                          f"K1 {label} sampled code0 row {b} beyond a near-tie")
        def times(mode_):
            t_k = timed(lambda: call(tkk.talker_decode_step, ck, 0.9, (3, 4), False, mode_), iters)
            t_d = (b1_ms if B == 1 else device_ms)(
                lambda: call(tkk.talker_decode_step, ck, 0.9, (3, 4), False, mode_), 10)
            return t_k, t_d

        dyn = mode == "dyn_int8"
        (t_k, t_d), (t_kw, t_dw) = times(mode), times("wo_bf16") if dyn else (None, None)
        t_p = timed(lambda: call(tkk.talker_decode_step_ref, cr, 0.9, (3, 4), logits=False), 2)
        bnd = bound(*k1_io(B, int(offs.sum()), kv_quant, True, p=p, c=c),
                    PEAK_INT8_OP_S if dyn else PEAK_FLOP_S)
        log(f"    K1 {label}, {'int8' if kv_quant else 'bf16'} cache of {T} (offsets "
            f"{int(offs.min())}..{int(offs.max())}): scaled err " + ", ".join(
                f"{k} {v:.3g}" for k, v in errs.items()) + f" (logits max abs {abs_err:.3g})"
            + ("; against the float64 step (kernel, plain): " + ", ".join(
                f"{k} {a:.4g} / {b:.4g}" for k, (a, b) in wide.items()) if wide else "")
            + f"; greedy code0 {B - flips}/{B} equal; sampled {sampled} seeds: {sampled * B - mism}/"
            f"{sampled * B} equal, {mism} near-ties; {t_k:.3f} ms/step back to back, device "
            f"{t_d:.3f}" + (f" (wo_bf16 on the same inputs: {t_kw:.3f}, device {t_dw:.3f})"
                            if dyn else "")
            + f", bound {bnd[0]:.3f} ({bnd[1]}), plain {t_p:.3f}  [{smi}]")
        del cache, ck, cr
        return dict(abs=abs_err, ms=t_k, plain_ms=t_p, dev_ms=t_d, bound=bnd, wo_ms=t_kw,
                    wo_dev_ms=t_dw, errs=errs, wide=wide)

    def k2_compare(label, p, c, tp_, B, seed, iters=10, mode="wo_bf16", fn=None):
        """K2 (or ``fn``, the wrapper of K5's port) on CP weights ``p`` (with
        the projection where ``c`` is narrower than the talker ``tp_``)
        against its plain version at B rows, in matmul ``mode``:
        teacher-forced greedy logits within the bound of phases 4 and b
        (0.05 scaled), esum (talker width) bit-equal, codes equal but for
        near-ties; then one sampled seed. In dyn_int8 the times stand beside
        the same inputs' wo_bf16 times."""
        fn = fn or cpk.predict_codes_fused
        th = tp_["codec_embedding"].shape[-1]
        gb = torch.Generator(device=dev).manual_seed(seed)
        hb = torch.randn(B, th, generator=gb, device=dev).mul(0.3).to(torch.bfloat16)
        c0b = torch.randint(0, 2048, (B,), generator=gb, device=dev, dtype=torch.int32)

        def call(fn_, temperature, seed_, mode_=mode, **kw):
            out = fn_(p, c, tp_, hb, c0b, seed_, temperature=temperature, top_k=50, mode=mode_,
                      **kw)
            return (out[0], out[1], out[2].reshape(15, B, -1)) if len(out) == 3 else out

        cr_, er_, lr_ = call(cpk.predict_codes_fused_ref, 0.0, (5, 6), return_logits=True)
        n_fn = fn.launches
        ck_, ek_, lk_ = call(fn, 0.0, (5, 6), force_codes=cr_, return_logits=True)
        check(fn.launches == n_fn + 1, f"K2 {label}: the wrapper did not launch its kernel")
        torch.cuda.synchronize()
        abs_err, err_lg = float((lk_ - lr_).abs().max()), scaled(lk_, lr_)
        check(err_lg < 0.05, f"K2 {label} logits outside the bound")
        check(ek_.shape == (B, th) and torch.equal(ek_, er_), f"K2 {label} esum differs")
        flips = 0
        for b in range(B):
            for j in range(15):
                a_, c_ = int(ck_[b, j]), int(cr_[b, j])
                if a_ != c_:
                    flips += 1
                    check(near_tie(lr_[j, b], a_, c_, abs_err), f"K2 {label} code ({b}, {j}) beyond a near-tie")
        seed_s = (9000 + B, 7)
        ca, _, la = call(fn, 0.9, seed_s, return_logits=True)
        cb_, _, lb = call(cpk.predict_codes_fused_ref, 0.9, seed_s, return_logits=True)
        mism = 0
        for b in range(B):
            diff = (ca[b] != cb_[b]).nonzero()
            if len(diff):
                mism += 1
                j = int(diff[0, 0])
                noise = gumbel_noise(seed_s[0], seed_s[1], j + 1 + 16 * b, c.vocab_size, dev)
                check(sampled_flip_explained(lb[j, b], int(ca[b, j]), int(cb_[b, j]),
                                             float((la[j, b] - lb[j, b]).abs().max()), noise),
                      f"K2 {label} sampled code ({b}, {j}) beyond a near-tie")
        def times(mode_):
            return (timed(lambda: call(fn, 0.9, (3, 4), mode_), iters),
                    (b1_ms if B == 1 else device_ms)(lambda: call(fn, 0.9, (3, 4), mode_), 5))

        dyn = mode == "dyn_int8"
        (t_k, t_d), (t_kw, t_dw) = times(mode), times("wo_bf16") if dyn else (None, None)
        t_p = timed(lambda: call(cpk.predict_codes_fused_ref, 0.9, (3, 4)), 1)
        bnd = bound(*k2_io(B, p, c, th), PEAK_INT8_OP_S if dyn else PEAK_FLOP_S)
        log(f"    K2 {label}: teacher-forced scaled logits err {err_lg:.3g} (max abs {abs_err:.3g}), "
            f"esum bit-equal, codes {15 * B - flips}/{15 * B} equal; sampled: {B - mism}/{B} rows "
            f"equal, {mism} near-ties; {t_k:.3f} ms/frame back to back, device {t_d:.3f}"
            + (f" (wo_bf16 on the same inputs: {t_kw:.3f}, device {t_dw:.3f})" if dyn else "")
            + f", bound {bnd[0]:.3f} ({bnd[1]}; the re-read design: "
            f"{k2_reread(p) / HBM_BYTES_S * 1e3:.3f}), plain {t_p:.3f}  [{smi}]")
        return dict(abs=abs_err, ms=t_k, plain_ms=t_p, dev_ms=t_d, bound=bnd, wo_ms=t_kw,
                    wo_dev_ms=t_dw)

    # ---- f. K1 in bf16 mode against its plain version at 0.6B ----
    check(tkk._layout(talker_b["layers"]) == "bf16" and tkk._layout(cp_b["layers"]) == "bf16",
          "the dense trees are not in the fused bf16 layout")
    log("[f] K1 in bf16 mode at 0.6B (dense bf16 weights, no scales)")
    k1f = {}
    for B in (1, 8, 64):
        for kv_quant, T, lo, hi_ in ((False, 256 if B == 1 else 128, 40 if B == 1 else 20,
                                      41 if B == 1 else 120), (True, 512, 100, 500)):
            k1f[(B, kv_quant)] = k1_compare(f"bf16 0.6B B={B}", talker_b, cfg, B, T, kv_quant, lo,
                                            hi_, 300 + B, iters=20 if B == 1 else 10)

    # ---- g. K1 at 1.7B widths; K2 on bf16 weights and with the projection ----
    cpc17 = C.CodePredictorConfig(
        vocab_size=2048, hidden_size=1024, intermediate_size=3072, num_hidden_layers=5,
        num_attention_heads=16, num_key_value_heads=8, head_dim=128,
    )
    cfg17 = C.TalkerConfig(  # __graft_entry__.py::_flagship_17b
        vocab_size=3072, text_vocab_size=151936, hidden_size=2048, text_hidden_size=2048,
        intermediate_size=6144, num_hidden_layers=28, num_attention_heads=16,
        num_key_value_heads=8, head_dim=128, spk_id=(("aiden", 2861), ("vivian", 2862)),
        code_predictor_config=cpc17,
    )
    t0 = time.time()
    trees17 = fused_trees(cfg17, dev, seed=10)  # bf16 talker, bf16 CP, int8 talker, int8 CP
    torch.cuda.synchronize()
    check("small_to_mtp_projection" in trees17[1] and "small_to_mtp_projection" in trees17[3],
          "the 1.7B CP has no small-to-MTP projection")
    log(f"[g] 1.7B trees (host_init, fused, bf16 and an int8 copy) in {time.time() - t0:.1f} s")
    k1g, k2g = {}, {}
    for mode, tp_ in (("int8", trees17[2]), ("bf16", trees17[0])):
        for B in (1, 64):
            k1g[(mode, B)] = k1_compare(f"{mode} 1.7B B={B}", tp_, cfg17, B, 256 if B == 1 else 128,
                                        False, 40 if B == 1 else 20, 41 if B == 1 else 120,
                                        400 + B, sampled=1, iters=10)
    for B in (1, 64):
        k2g[("bf16 0.6B", B)] = k2_compare(f"bf16 0.6B B={B}", cp_b, cpc, talker_b, B, 500 + B)
        for mode, cp_, tp_ in (("int8", trees17[3], trees17[2]), ("bf16", trees17[1], trees17[0])):
            k2g[(f"{mode} 1.7B", B)] = k2_compare(f"{mode} 1.7B (projection 2048 -> 1024) B={B}",
                                                  cp_, cpc17, tp_, B, 600 + B)

    # ---- h. the bf16 checkpoint path: from_pretrained(dir) with defaults ----
    from qwen3tts_tpu_torch.models import code_predictor as cpm_mod

    calls = {"attend S=1": 0, "plain CP": 0, "plain sampler": 0}
    real_attend, real_pc, real_samp = tk._attend, cpm_mod.predict_codes, gen.sample_token_inner

    def counting(name, fn, when=lambda *a, **k: True):
        def wrapped(*a, **k):
            calls[name] += int(bool(when(*a, **k)))
            return fn(*a, **k)
        return wrapped

    tk._attend = counting("attend S=1", real_attend, lambda q, *a, **k: q.shape[2] == 1)
    cpm_mod.predict_codes = counting("plain CP", real_pc)
    gen.sample_token_inner = counting("plain sampler", real_samp)

    def reset_counts():
        tkk.talker_decode_step.launches = cpk.predict_codes_fused.launches = 0
        for k in calls:
            calls[k] = 0

    def path_check(label, n, cap):
        """K1 once per frame after the first (and on an EOS step), K2 once
        per frame, no decode step through the plain per-layer loop, no
        plain CP loop, the plain sampler for the first frame's code 0 only."""
        n1_, n2_ = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
        log(f"    {label}: {n} frames; launches K1 {n1_}, K2 {n2_}; plain per-layer decode steps "
            f"{calls['attend S=1']}, plain CP loops {calls['plain CP']}, plain sampler calls "
            f"{calls['plain sampler']}")
        check(n2_ == n and n1_ == n - 1 + int(n < cap), f"{label}: K1 {n1_} / K2 {n2_} for {n} frames")
        check(calls == {"attend S=1": 0, "plain CP": 0, "plain sampler": 1},
              f"{label}: the plain path ran: {calls}")
        return n1_, n2_

    def headline(tp_, cp_, c, cc, voc_):
        """The 66-frame forbid_eos headline on these weights: median wall of
        3 runs after a warm-up (K1 and K2 counted over the 3), RTF, the
        decode loop's ms/frame after the first frame (median of 2)."""
        h_ = c.hidden_size
        gh = torch.Generator(device=dev).manual_seed(21)
        pre = torch.randn(1, p_bucket, h_, generator=gh, device=dev).mul(0.05).to(torch.bfloat16)
        trail = torch.randn(64, h_, generator=gh, device=dev).mul(0.05).to(torch.bfloat16)
        pad_ = torch.zeros(h_, dtype=torch.bfloat16, device=dev)
        r = dict(talker_cfg=c, cp_cfg=cc, sampling=sampling, prefill_embeds=pre, prefill_len=p_len,
                 trailing_embeds=trail, trailing_len=12, tts_pad_embed=pad_)

        def once(seed):
            torch.cuda.synchronize()
            t = time.time()
            _c, nf, w, _ = _generate_and_decode(tp_, cp_, voc_, dec_cfg=dec_cfg, **r,
                                                max_frames=max_frames, max_steps=frames, seed=seed,
                                                cache_len=cache_len)
            torch.cuda.synchronize()
            check(nf == frames and bool(torch.isfinite(w).all()), "headline run malformed")
            return time.time() - t

        def loop_ms():
            c0 = gen.prefill_start(tp_, cp_, **r, cache=tk.make_cache(c, 1, cache_len, torch.bfloat16,
                                                                     dev),
                                   max_frames=max_frames, seed=9)
            torch.cuda.synchronize()
            t = time.time()
            gen.generate_chunk(tp_, cp_, c0, talker_cfg=c, cp_cfg=cc, sampling=sampling,
                               trailing_embeds=trail, trailing_len=12, tts_pad_embed=pad_,
                               until_step=frames)
            torch.cuda.synchronize()
            return (time.time() - t) * 1000 / (frames - 1)

        once(0)
        tkk.talker_decode_step.launches = cpk.predict_codes_fused.launches = 0
        walls_ = [once(s_) for s_ in (1, 2, 3)]
        check((tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches)
              == (3 * (frames - 1), 3 * frames), "headline launches")
        ms_ = statistics.median([loop_ms(), loop_ms()])
        # K1 (offset 57, mid-run) and K2 device time at B=1 on these weights
        c1 = tk.make_cache(c, 1, cache_len, torch.bfloat16, dev)
        tk.forward(tp_, c, pre[:, :57], c1, 0)
        r57 = mrope_cos_sin(torch.full((1, 1), 57, device=dev), D, c.rope_theta, c.mrope_section,
                            torch.bfloat16)
        x57 = pre[:, 57:58].contiguous()
        d1 = b1_ms(lambda: tkk.talker_decode_step(
            tp_, c, x57, c1, 57, r57[0][0, 0], r57[1][0, 0], temperature=0.9, top_k=50,
            rep_penalty=1.05, eos_id=-1, seed=(3, 4), suppress_add=supp, seen=seen), 20)
        code5 = torch.tensor([5], dtype=torch.int32, device=dev)  # made once: a copy would wait
        d2 = b1_ms(lambda: cpk.predict_codes_fused(cp_, cc, tp_, pre[0, :1], code5, (3, 4),
                                                   temperature=0.9, top_k=50), 10)
        wall_ = statistics.median(walls_)
        return dict(wall=wall_, walls=walls_, rtf=wall_ / (frames / 12.5), ms=ms_, k1_dev=d1,
                    k2_dev=d2)

    def show_headline(label, hd):
        log(f"    {label} headline (66 frames, forbid_eos, T=0.9 top-k 50 rep 1.05): wall "
            f"{hd['wall']:.3f} s (runs {', '.join(f'{w:.3f}' for w in hd['walls'])}), RTF "
            f"{hd['rtf']:.4f}; decode {hd['ms']:.2f} ms/frame; device per frame: K1 "
            f"{hd['k1_dev']:.3f} ms, K2 {hd['k2_dev']:.3f} ms  [{smi}]")

    bf16_tmp = tempfile.TemporaryDirectory(prefix="qt_bf16_")
    t0 = time.time()
    write_checkpoint(bf16_tmp.name, arrays06)
    write_s = time.time() - t0
    del arrays06
    t0 = time.time()
    bm = Qwen3TTSModel.from_pretrained(bf16_tmp.name)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    bm.tokenizer = StubTokenizer(cfg.text_vocab_size)
    bt, bc = bm.talker_params, bm.cp_params
    check(bm.device.type == "cuda" and tkk._layout(bt["layers"]) == "bf16"
          and tkk._layout(bc["layers"]) == "bf16" and "q_proj" not in bt["layers"]
          and bt["codec_head"].dtype == torch.bfloat16 and bc["lm_head"].dtype == torch.bfloat16,
          "from_pretrained of a BF16 checkpoint did not give fused dense bf16 leaves")
    log(f"[h] 0.6B checkpoint written as BF16 in {write_s:.1f} s, from_pretrained(dir) with defaults "
        f"in {load_s:.1f} s: talker and CP fused, dense bf16 (qkv_proj "
        f"{tuple(bt['layers']['qkv_proj'].shape)}, codec head {tuple(bt['codec_head'].shape)})")
    reset_counts()
    text_h = "Hello from the bf16 checkpoint on the H100."
    wav_h, info_h = bm.generate(text_h, speaker="aiden", language="english", seed=0,
                                return_info=True)
    n_h = info_h.generation_token_count
    path_h = path_check("generate() on the BF16 checkpoint", n_h,
                        bm._effective_max_tokens(text_h, 2048))
    check(bool(np.isfinite(wav_h).all()) and len(wav_h) % 1920 == 0
          and 0 < len(wav_h) <= n_h * 1920, "bf16 checkpoint waveform")
    hd_h = headline(bt, bc, bm.talker_cfg, bm.cp_cfg, bm.vocoder_params)
    show_headline("bf16 checkpoint", hd_h)

    # ---- i. 1.7B generate(), int8 and bf16 ----
    m17 = {}
    path_i, hd_i = {}, {}
    text_i = "Hello from the 1.7B model on the H100."
    for mode, tp_, cp_ in (("int8", trees17[2], trees17[3]), ("bf16", trees17[0], trees17[1])):
        m17[mode] = Qwen3TTSModel(
            C.ModelConfig(talker_config=cfg17, tts_model_type="custom_voice",
                          tts_model_size="1b7"),
            tp_, cp_, voc_p, tokenizer_config=C.TokenizerConfig(decoder_config=dec_cfg),
            tokenizer=StubTokenizer(cfg17.text_vocab_size), dtype=torch.bfloat16, device=dev)
        reset_counts()
        wav_i, info_i = m17[mode].generate(text_i, speaker="aiden", language="english", seed=0,
                                           return_info=True)
        n_i = info_i.generation_token_count
        log(f"[i] 1.7B {mode}:")
        path_i[mode] = path_check(f"generate() at 1.7B, {mode}", n_i,
                                  m17[mode]._effective_max_tokens(text_i, 2048))
        check(bool(np.isfinite(wav_i).all()) and 0 < len(wav_i) <= n_i * 1920, "1.7B waveform")
        hd_i[mode] = headline(tp_, cp_, cfg17, cpc17, voc_p)
        show_headline(f"1.7B {mode}", hd_i[mode])

    # ---- j. generate_batch on the bf16 checkpoint and at 1.7B int8 ----
    grid_j = {}
    for label, mb, tp_, cp_, c_, cc_ in (
            ("bf16 checkpoint 0.6B", bm, bt, bc, bm.talker_cfg, bm.cp_cfg),
            ("1.7B int8", m17["int8"], trees17[2], trees17[3], cfg17, cpc17)):
        reset_counts()
        t0 = time.time()
        wavs = mb.generate_batch(texts, speakers=["aiden", "vivian"] * 4, language="english",
                                 seed=0)
        wall_j = time.time() - t0
        n1j, n2j = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
        log(f"[j] generate_batch(8 texts), {label}: {mb.last_info.generation_token_count} frames in "
            f"all, {wall_j:.2f} s; launches K1 {n1j} (lockstep frames after the first), K2 {n2j}; "
            f"plain per-layer decode steps {calls['attend S=1']}, plain CP loops "
            f"{calls['plain CP']}")
        check(n1j >= 1 and n2j == n1j + 1 and calls["attend S=1"] == 0 and calls["plain CP"] == 0,
              f"generate_batch {label}: K1 {n1j} / K2 {n2j}, {calls}")
        check(all(bool(np.isfinite(w).all()) and len(w) % 1920 == 0 for w in wavs),
              f"generate_batch {label} waveforms")
        batch_run(64, False, 128, 0, tp_=tp_, cp_=cp_, c_=c_, cc_=cc_)  # warm-up
        reset_counts()
        runs = [batch_run(64, False, 128, s_, tp_=tp_, cp_=cp_, c_=c_, cc_=cc_) for s_ in (1, 2)]
        launches_j = (tkk.talker_decode_step.launches // 2, cpk.predict_codes_fused.launches // 2)
        check(launches_j == (frames - 1, frames), f"B=64 {label}: launches {launches_j}")
        wall_b = statistics.median(r[0] for r in runs)
        grid_j[label] = dict(ms=statistics.median(r[1] for r in runs),
                             tok_s=64 * 16 * frames / wall_b, launches=launches_j)
        log(f"    B=64, 128-slot bf16 cache, {label}: {grid_j[label]['ms']:.2f} ms/lockstep frame, "
            f"{grid_j[label]['tok_s']:.0f} codec tokens/s (walls "
            f"{', '.join(f'{r[0]:.3f}' for r in runs)} s)  [{smi}]")

    # ==== dyn_int8, unfused int8 CP layers, K5 (phases k-m) ====
    from qwen3tts_tpu_torch.ops import cp_kernel_old as cpk_old

    # the 0.6B CP's int8 layers unfused (q/k/v and gate/up apart), from the
    # seed of cp_p's trees
    cp_u = quantize_decode_params_int8(hi.to_device(
        hi.host_init_cp_params(1, cpc, H), torch.bfloat16, dev), "lm_head")
    check(cpk.cp_layout(cp_u["layers"]) == "int8" and "q_proj" in cp_u["layers"],
          "the unfused CP tree is not unfused int8")

    # ---- k. K1 and K2 in dyn_int8, K2 unfused, K5: against the plain versions ----
    log("[k] dyn_int8 (per-row int8 activations, s8 x s8 -> s32) against the plain versions")
    k1k, k2k = {}, {}
    for B in (1, 8, 64):
        for kv_quant, T, lo, hi_ in ((False, 256 if B == 1 else 128, 40 if B == 1 else 20,
                                      41 if B == 1 else 120), (True, 512, 100, 500)):
            k1k[(B, kv_quant)] = k1_compare(f"dyn_int8 0.6B B={B}", talker_p, cfg, B, T, kv_quant,
                                            lo, hi_, 700 + B, sampled=1 if B > 1 else 2,
                                            iters=20 if B == 1 else 10, mode="dyn_int8")
    # the amax of each activation row comes from the block itself (K1's
    # persistent step, K2's persistent frame): dyn_int8 adds no launch to a
    # K1 step or a K2 frame. Expected, from the C entries: K1 at B=1, K2 at
    # B=1 (and K5's port, which launches it) = the memset of the persistent
    # kernel's barrier words + its one cooperative launch (the multi-launch
    # K1 step made 8 L + 3: rms_copy, 8 per layer, head GEMV, sampler)
    c3 = tk.KVCache(cache0.k.clone(), cache0.v.clone())  # phase 3's prefilled cache
    per_call = {m: (library_launches(lambda: k1(tkk.talker_decode_step, c3, 0.9, (3, 4), mode=m)),
                    library_launches(lambda: k2(cpk.predict_codes_fused, 0.9, (3, 4), mode=m)),
                    library_launches(lambda: k2(cpk_old.predict_codes_fused, 0.9, (3, 4), mode=m)))
                for m in ("wo_bf16", "dyn_int8")}
    expect = (2, 2, 2)
    log(f"    library launches per call, K1 B=1 / K2 B=1 / K5 B=1: wo_bf16 "
        f"{per_call['wo_bf16']}, dyn_int8 {per_call['dyn_int8']} (expected {expect})")
    check(per_call["wo_bf16"] == expect, f"K1/K2 launches {per_call['wo_bf16']}, expected {expect}")
    check(per_call["dyn_int8"] == per_call["wo_bf16"], "dyn_int8 changed the launches per call")
    del c3
    for B in (1, 64):
        k1k[("1.7B", B)] = k1_compare(f"dyn_int8 1.7B B={B}", trees17[2], cfg17, B,
                                      256 if B == 1 else 128, False, 40 if B == 1 else 20,
                                      41 if B == 1 else 120, 800 + B, sampled=1, iters=10,
                                      mode="dyn_int8")
    for B in (1, 64):
        k2k[("0.6B", B)] = k2_compare(f"dyn_int8 0.6B B={B}", cp_p, cpc, talker_p, B, 900 + B,
                                      mode="dyn_int8")
    k2k[("1.7B", 1)] = k2_compare("dyn_int8 1.7B (projection stays bf16) B=1", trees17[3], cpc17,
                                  trees17[2], 1, 950, mode="dyn_int8")
    for mode in ("wo_bf16", "dyn_int8"):
        for B in (1, 64):
            k2k[("unfused", mode, B)] = k2_compare(f"unfused int8 layers, {mode}, B={B}", cp_u, cpc,
                                                   talker_p, B, 960 + B, mode=mode)
    for mode in ("wo_bf16", "dyn_int8"):
        k2k[("K5", mode)] = k2_compare(f"K5 (ops/cp_kernel_old.py), {mode}, B=1", cp_p, cpc,
                                       talker_p, 1, 990, mode=mode, fn=cpk_old.predict_codes_fused)

    # ---- l. the main path in dyn_int8: both variables set in-process ----
    modes_k1, modes_k2 = tkk.talker_decode_step.mode_launches, cpk.predict_codes_fused.mode_launches

    def reset_modes():
        reset_counts()
        for d in (modes_k1, modes_k2):
            for k in d:
                d[k] = 0

    saved_env = {v: os.environ.get(v) for v in ("QWEN3TTS_TK_MODE", "QWEN3TTS_CPK_MODE")}

    def set_modes(mode):
        for v in saved_env:
            os.environ[v] = mode

    def mode_check(label, n, cap):
        """path_check's launches and no plain path, every launch in dyn_int8."""
        n1_, n2_ = path_check(label, n, cap)
        check(modes_k1 == {"wo_bf16": 0, "bf16": 0, "dyn_int8": n1_}
              and modes_k2 == {"wo_bf16": 0, "bf16": 0, "dyn_int8": n2_},
              f"{label}: launches by mode K1 {modes_k1}, K2 {modes_k2}")
        return n1_, n2_

    set_modes("dyn_int8")
    try:
        text_l = "Hello from the H100 port of the talker."  # phase 5's text
        reset_modes()
        wav_l, info_l = model.generate(text_l, speaker="aiden", language="english", seed=0,
                                       return_info=True)
        log("[l] the main path in dyn_int8 (QWEN3TTS_TK_MODE = QWEN3TTS_CPK_MODE = dyn_int8):")
        path_l = mode_check("generate() at 0.6B int8", info_l.generation_token_count, max_steps)
        check(bool(np.isfinite(wav_l).all()) and len(wav_l) % 1920 == 0
              and 0 < len(wav_l) <= info_l.generation_token_count * 1920, "dyn_int8 waveform")
        # the 66-frame headline, its decode loop in turns with wo_bf16's
        e2e(0)
        walls_l = [e2e(s_)[0] for s_ in (1, 2, 3)]
        loop_l = {}
        for mode in ("dyn_int8", "wo_bf16", "dyn_int8", "wo_bf16"):
            set_modes(mode)
            loop_l.setdefault(mode, []).append(decode_ms(False))
        set_modes("dyn_int8")
        wall_l = statistics.median(walls_l)
        log(f"    0.6B int8 headline in dyn_int8: wall {wall_l:.3f} s (runs "
            f"{', '.join(f'{w:.3f}' for w in walls_l)}), RTF {wall_l / (frames / 12.5):.4f} "
            f"against phase 6's {rtf:.4f}; decode loop dyn_int8 "
            f"{', '.join(f'{m:.2f}' for m in loop_l['dyn_int8'])} ms/frame, wo_bf16 "
            f"{', '.join(f'{m:.2f}' for m in loop_l['wo_bf16'])} (in turns)  [{smi}]")
        reset_modes()
        wav_l17, info_l17 = m17["int8"].generate(text_i, speaker="aiden", language="english",
                                                 seed=0, return_info=True)
        path_l17 = mode_check("generate() at 1.7B int8", info_l17.generation_token_count,
                              m17["int8"]._effective_max_tokens(text_i, 2048))
        check(bool(np.isfinite(wav_l17).all()) and len(wav_l17) > 0, "1.7B dyn_int8 waveform")
        # one B=64 lockstep cell (128-slot bf16 cache) in each mode, in turns
        cell_l = {}
        for mode in ("dyn_int8", "wo_bf16", "dyn_int8", "wo_bf16"):
            set_modes(mode)
            batch_run(64, False, 128, 0)  # warm-up
            reset_modes()
            runs = [batch_run(64, False, 128, s_) for s_ in (1, 2)]
            want = {m: (0, 0) for m in modes_k1}
            want[mode] = (2 * (frames - 1), 2 * frames)
            check({m: (modes_k1[m], modes_k2[m]) for m in modes_k1} == want,
                  f"B=64 {mode}: launches by mode K1 {modes_k1}, K2 {modes_k2}")
            wall_b = statistics.median(r[0] for r in runs)
            cell_l.setdefault(mode, []).append(dict(
                ms=statistics.median(r[1] for r in runs), tok_s=64 * 16 * frames / wall_b,
                launches=(modes_k1[mode] // 2, modes_k2[mode] // 2)))
        for mode, cells in cell_l.items():
            log(f"    B=64 lockstep cell, 128-slot bf16 cache, 0.6B int8, {mode}: "
                + ", ".join(f"{c_['ms']:.2f} ms/frame ({c_['tok_s']:.0f} codec tokens/s)"
                            for c_ in cells) + f"  [{smi}]")
    finally:
        for v, val in saved_env.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val

    # ---- m. an unfused int8 CP through Qwen3TTSModel(...).generate() ----
    # K2 on every frame, the plain CP loop never (it raises here); then the
    # same with K5's port serving the CP, the module the older TPU layout
    # maps to, in place of K2's wrapper
    def no_plain_cp(*a, **k):
        raise AssertionError("the plain CP loop ran on the card")

    cpm_mod.predict_codes = no_plain_cp
    mu = Qwen3TTSModel(
        C.ModelConfig(talker_config=cfg, tts_model_type="custom_voice", tts_model_size="0b6"),
        talker_p, cp_u, voc_p, tokenizer_config=C.TokenizerConfig(decoder_config=dec_cfg),
        tokenizer=StubTokenizer(cfg.text_vocab_size), dtype=torch.bfloat16, device=dev)
    reset_modes()
    wav_m, info_m = mu.generate(text_l, speaker="aiden", language="english", seed=0,
                                return_info=True)
    log("[m] an unfused int8 code predictor (q/k/v, gate/up apart) through generate():")
    path_m = path_check("generate() with the unfused CP", info_m.generation_token_count, max_steps)
    check(modes_k2["wo_bf16"] == path_m[1], f"unfused CP: K2 launches by mode {modes_k2}")
    check(bool(np.isfinite(wav_m).all()) and len(wav_m) > 0, "unfused CP waveform")
    reset_modes()
    cpk_old.predict_codes_fused.launches = 0
    k2_entry = cpk.predict_codes_fused
    cpk.predict_codes_fused = cpk_old.predict_codes_fused
    try:
        wav_m5, info_m5 = model.generate(text_l, speaker="aiden", language="english", seed=0,
                                         return_info=True)
        n5, k5_launches = info_m5.generation_token_count, cpk_old.predict_codes_fused.launches
    finally:
        cpk.predict_codes_fused = k2_entry
    log(f"    generate() with K5's port serving the CP: {n5} frames, K5 launches {k5_launches}, "
        f"K1 {tkk.talker_decode_step.launches}")
    check(k5_launches == n5 and k2_entry.launches == 0 and bool(np.isfinite(wav_m5).all()),
          f"K5's port: {k5_launches} launches for {n5} frames")
    # ---- n. top-p in the kernels' sampler (K1 sample mode, K2) ----
    # The kernels' sampled codes against sample_row (the plain sampler, its
    # top-p stage included) on the kernels' own logits, same seed and stream:
    # the inputs are the same bits, so only the top-p cut can differ, where a
    # cumulative mass lies within the rounding of the threshold (its f32 sum
    # taken in another association): such flips are counted, and each must
    # sit at the cut.
    from qwen3tts_tpu_torch.ops.decode_blocks import (
        NEG_BIG, sample_row, top_k_filter, top_p_cum, top_p_threshold,
    )

    t_n = time.time()

    def top_p_flip_ok(z, p_, ref_exact, a, b):
        cum = top_p_cum(z, ref_exact)
        tol = int((z > NEG_BIG / 2).sum()) * 2.0**-23 * max(1.0, float(cum.max()))
        thr = top_p_threshold(p_)
        return min(abs(float(cum[a]) - thr), abs(float(cum[b]) - thr)) <= tol

    top_p_cases = [(p_, k_, r_) for p_ in (0.8, 0.95) for k_ in (50, 0) for r_ in (False, True)]
    log("[n] top-p in the kernels' sampler: codes against sample_row on the kernels' own logits, "
        "top_p {0.8, 0.95} x top-k {50, 0} x ref_exact_top_p {off, on}")
    topp = {}
    for B in (1, 8, 64):
        T_n = 256 if B == 1 else 128
        cache_n, offs_n, x_n, cos_n, sin_n, seen_n = batch_case(B, T_n, False, 40 if B == 1 else 20,
                                                                41 if B == 1 else 120, 1100 + B)
        off_n = int(offs_n[0]) if B == 1 else offs_n
        args_n = (cos_n[0], sin_n[0], seen_n[0]) if B == 1 else (cos_n, sin_n, seen_n)
        draws = flips = 0
        for p_, k_, r_ in top_p_cases:
            seed_n = (1200 + B, 7 + k_)
            _, code_n, lg_n = tkk.talker_decode_step(
                talker_p, cfg, x_n, cache_n, off_n, args_n[0], args_n[1], temperature=0.9,
                top_k=k_, top_p=p_, ref_exact_top_p=r_, rep_penalty=1.05, eos_id=-1, seed=seed_n,
                suppress_add=supp, seen=args_n[2], return_logits=True)
            code_n, lg_n = code_n.reshape(B), lg_n.reshape(B, -1)
            for b in range(B):
                want = int(sample_row(lg_n[b], temperature=0.9, top_k=k_, top_p=p_,
                                      ref_exact_top_p=r_, rep_penalty=1.05, seen=seen_n[b],
                                      suppress_add=supp, seed=seed_n, stream=16 * b))
                draws += 1
                if int(code_n[b]) != want:
                    flips += 1
                    z_n = top_k_filter(pen_b(lg_n[b], seen_n[b]) + supp, k_)
                    check(top_p_flip_ok(z_n, p_, r_, int(code_n[b]), want),
                          f"K1 B={B} top_p {p_} top-k {k_} ref_exact {r_}: code0 row {b} "
                          f"{int(code_n[b])} vs sample_row's {want} away from the top-p cut")
        log(f"    K1 B={B}: {draws - flips}/{draws} sampled code0 equal, {flips} flips at the "
            f"top-p cut")
        topp[("K1", B)] = (draws, flips)
        del cache_n
    for B in (1, 64):
        gb = torch.Generator(device=dev).manual_seed(1300 + B)
        h_n = torch.randn(B, H, generator=gb, device=dev).mul(0.3).to(torch.bfloat16)
        c0_n = torch.randint(0, 2048, (B,), generator=gb, device=dev, dtype=torch.int32)
        draws = flips = 0
        for p_, k_, r_ in top_p_cases:
            seed_n = (1400 + B, 3 + k_)
            codes_n, _, lg_n = cpk.predict_codes_fused(
                cp_p, cpc, talker_p, h_n, c0_n, seed_n, temperature=0.9, top_k=k_, top_p=p_,
                ref_exact_top_p=r_, return_logits=True)
            lg_n = lg_n.reshape(15, B, -1)
            for b in range(B):
                for j in range(15):
                    want = int(sample_row(lg_n[j, b], temperature=0.9, top_k=k_, top_p=p_,
                                          ref_exact_top_p=r_, seed=seed_n,
                                          stream=j + 1 + 16 * b))
                    draws += 1
                    if int(codes_n[b, j]) != want:
                        flips += 1
                        check(top_p_flip_ok(top_k_filter(lg_n[j, b], k_), p_, r_,
                                            int(codes_n[b, j]), want),
                              f"K2 B={B} top_p {p_} top-k {k_} ref_exact {r_}: code ({b}, {j}) "
                              f"away from the top-p cut")
        log(f"    K2 B={B}: {draws - flips}/{draws} sampled codes equal, {flips} flips at the "
            f"top-p cut")
        topp[("K2", B)] = (draws, flips)

    # the stage's cost: K1 and K2 at B = 1 and 64 with and without top-p, in turns
    c_n1 = clone(cache0)  # phase 3's cache (phase a's ck, cr are gone)

    def topp_cost(B, p_):
        if B == 1:
            return (lambda: k1(tkk.talker_decode_step, c_n1, 0.9, (3, 4), top_p=p_),
                    lambda: k2(cpk.predict_codes_fused, 0.9, (3, 4), top_p=p_))
        cache_c, offs_c, x_c, cos_c, sin_c, seen_c = cost_case
        return (lambda: tkk.talker_decode_step(
                    talker_p, cfg, x_c, cache_c, offs_c, cos_c, sin_c, temperature=0.9, top_k=50,
                    top_p=p_, rep_penalty=1.05, eos_id=-1, seed=(3, 4), suppress_add=supp,
                    seen=seen_c),
                lambda: cpk.predict_codes_fused(cp_p, cpc, talker_p, hb64, c0b64, (3, 4),
                                                temperature=0.9, top_k=50, top_p=p_))

    cost_case = batch_case(64, 128, False, 20, 120, 1500)
    gb = torch.Generator(device=dev).manual_seed(1501)
    hb64 = torch.randn(64, H, generator=gb, device=dev).mul(0.3).to(torch.bfloat16)
    c0b64 = torch.randint(0, 2048, (64,), generator=gb, device=dev, dtype=torch.int32)
    topp_ms = {}
    for B in (1, 64):
        for p_ in (1.0, 0.9, 1.0, 0.9):
            fk1, fk2 = topp_cost(B, p_)
            topp_ms.setdefault(("K1", B, p_), []).append(timed(fk1, 20 if B == 1 else 10))
            topp_ms.setdefault(("K2", B, p_), []).append(timed(fk2, 10))
        for kern in ("K1", "K2"):
            log(f"    {kern} B={B}, top-k 50: top_p 1.0 "
                f"{', '.join(f'{t:.3f}' for t in topp_ms[(kern, B, 1.0)])} ms, top_p 0.9 "
                f"{', '.join(f'{t:.3f}' for t in topp_ms[(kern, B, 0.9)])} ms (in turns)  [{smi}]")
    del cost_case
    # kernel against plain version with top-p at B=1 (the kernels' entries below)
    k1_tp_ms = statistics.median(topp_ms[("K1", 1, 0.9)])
    k2_tp_ms = statistics.median(topp_ms[("K2", 1, 0.9)])
    _, _, lk_tp = k1(tkk.talker_decode_step, clone(cache0), 0.9, (5, 5), top_p=0.9,
                     return_logits=True)
    _, _, lr_tp = k1(tkk.talker_decode_step_ref, clone(cache0), 0.9, (5, 5), top_p=0.9,
                     return_logits=True)
    k1_tp_abs = float((lk_tp - lr_tp).abs().max())
    k1_tp_plain = timed(lambda: k1(tkk.talker_decode_step_ref, c_n1, 0.9, (3, 4), top_p=0.9), 3)
    _, _, lk2_tp = k2(cpk.predict_codes_fused, 0.0, (5, 5), top_p=0.9, force_codes=codes_r,
                      return_logits=True)
    _, _, lr2_tp = k2(cpk.predict_codes_fused_ref, 0.0, (5, 5), top_p=0.9, force_codes=codes_r,
                      return_logits=True)
    k2_tp_abs = float((lk2_tp - lr2_tp).abs().max())
    k2_tp_plain = timed(lambda: k2(cpk.predict_codes_fused_ref, 0.9, (3, 4), top_p=0.9), 2)

    # the main path with top_p 0.9: K1 and K2 on every frame after the first,
    # the plain CP loop raising (phase m's), the plain sampler raising after
    # the first frame's code 0 (its logits come from the plain prefill)
    counted_samp, counted_bsamp = gen.sample_token_inner, bg.sample_token_inner

    def first_frame_only(fn):
        def wrapped(*a, **k):
            if calls["plain sampler"]:
                raise AssertionError("the plain sampler ran after the first frame")
            calls["plain sampler"] += 1
            return fn(*a, **k)
        return wrapped

    gen.sample_token_inner = first_frame_only(real_samp)
    bg.sample_token_inner = first_frame_only(counted_bsamp)
    try:
        path_n = {}
        for ref_exact in (False, True):
            model.ref_exact_top_p = ref_exact
            reset_counts()
            wav_n, info_n = model.generate(text_l, speaker="aiden", language="english", seed=0,
                                           top_p=0.9, return_info=True)
            path_n[ref_exact] = path_check(
                f"generate() at 0.6B int8, top_p 0.9, ref_exact_top_p {ref_exact}",
                info_n.generation_token_count, max_steps)
            check(bool(np.isfinite(wav_n).all()) and 0 < len(wav_n)
                  <= info_n.generation_token_count * 1920, "top-p waveform")
            reset_counts()
            wavs_n = model.generate_batch(texts, speakers=["aiden", "vivian"] * 4,
                                          language="english", seed=0, top_p=0.9)
            n1b, n2b = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
            log(f"    generate_batch(8 texts), top_p 0.9, ref_exact_top_p {ref_exact}: launches "
                f"K1 {n1b}, K2 {n2b}; plain per-layer decode steps {calls['attend S=1']}, plain "
                f"CP loops {calls['plain CP']}, plain sampler calls {calls['plain sampler']}")
            check(n1b >= 1 and n2b == n1b + 1 and calls == {"attend S=1": 0, "plain CP": 0,
                                                             "plain sampler": 1},
                  f"generate_batch with top_p: K1 {n1b} / K2 {n2b}, {calls}")
            check(all(bool(np.isfinite(w).all()) and len(w) % 1920 == 0 for w in wavs_n),
                  "generate_batch top-p waveforms")
    finally:
        model.ref_exact_top_p = False
        gen.sample_token_inner, bg.sample_token_inner = counted_samp, counted_bsamp

    def loop_top_p(p_):
        """ms per frame of the 66-frame decode loop after the first frame."""
        samp_ = gen.SamplingConfig(0.9, 50, p_, 1.05, forbid_eos=True)
        c0_ = gen.prefill_start(talker_p, cp_p, **dict(run, sampling=samp_),
                                cache=tk.make_cache(cfg, 1, cache_len, torch.bfloat16, dev), seed=9)
        torch.cuda.synchronize()
        t_ = time.time()
        gen.generate_chunk(talker_p, cp_p, c0_, talker_cfg=cfg, cp_cfg=cpc, sampling=samp_,
                           trailing_embeds=trailing, trailing_len=12, tts_pad_embed=pad,
                           until_step=frames)
        torch.cuda.synchronize()
        return (time.time() - t_) * 1000 / (frames - 1)

    loop_n = {}
    for p_ in (0.9, 1.0, 0.9, 1.0):
        loop_n.setdefault(p_, []).append(loop_top_p(p_))
    log(f"    66-frame decode loop, 0.6B int8: top_p 0.9 "
        f"{', '.join(f'{m:.2f}' for m in loop_n[0.9])} ms/frame, top_p 1.0 "
        f"{', '.join(f'{m:.2f}' for m in loop_n[1.0])} (in turns); phase 6: "
        f"{decode6_ms:.2f}  [{smi}]")
    log(f"    phase n took {time.time() - t_n:.1f} s")

    # ---- o. T7, T6, T3: the experiment kernels (qwen3tts_tpu_torch/tools) ----
    # Each against its plain version, then the script's timing at a reduced
    # count (the scripts run the long version: python -m
    # qwen3tts_tpu_torch.tools.<name>).
    from qwen3tts_tpu_torch.tools import exp_hbm_peak as thp
    from qwen3tts_tpu_torch.tools import exp_tk_b1_ablate as tab
    from qwen3tts_tpu_torch.tools import exp_weight_stream as tws

    t_o = time.time()
    log("[o] T7 (weight stream), T6 (K1's B=1 step by part), T3 (sustained read) against their "
        "plain versions, then their timings")
    big, small = tws.talker_operands(talker_p)
    ops_t7 = {"dma4": big, "dma12": big + small, "dma1": [tws.merged(big)]}
    x_o = torch.randn(1, H, generator=g, device=dev).mul(0.5).to(torch.bfloat16)
    t7 = {}
    for name, ops in ops_t7.items():
        h_k, s_k = tws.weight_stream(ops, x_o)
        h_r, s_r = tws.weight_stream_ref(ops, x_o)
        err = float((h_k.float() - h_r.float()).abs().max())
        if name == "dma12":  # f32 tiles summed in another order: within a bf16 step
            check(err <= 2.0**-7 * float(h_r.float().abs().max()), f"T7 {name}: h off by {err}")
        else:
            check(torch.equal(h_k, h_r), f"T7 {name}: h not bit-equal")
        check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(s_k, s_r)),
              f"T7 {name}: checksums differ")
        t7[name] = dict(abs=err, plain_ms=timed(lambda: tws.weight_stream_ref(ops, x_o), 2),
                        bytes=tws.nbytes(ops))
    c_t6 = clone(cache0)  # phase 3's cache: 40 prefilled rows
    t6 = {}
    for part in tab.PARTS:
        ck6, cr6 = clone(c_t6), clone(c_t6)
        hk6, kk6, vk6 = tab.variant_step(talker_p, cfg, x, ck6, pos, cos, sin, part)
        hr6, kr6, vr6 = tab.variant_step_ref(talker_p, cfg, x, cr6, pos, cos, sin, part)
        errs6 = dict(h=scaled(hk6, hr6), k=scaled(kk6, kr6), v=scaled(vk6, vr6))
        if part == "dma":
            check(torch.equal(hk6, hr6) and not kk6.any() and not vk6.any(),
                  "T6 dma: h not bit-equal or k/v rows not zero")
        else:
            check(max(errs6.values()) < 0.05, f"T6 {part} outside the bf16 bound: {errs6}")
        t6[part] = dict(errs=errs6, abs=float((hk6.float() - hr6.float()).abs().max()),
                        plain_ms=timed(lambda: tab.variant_step_ref(talker_p, cfg, x, cr6, pos, cos,
                                                                    sin, part), 2))
        del ck6, cr6
    x_t3 = torch.randint(-128, 127, (thp.ROWS + thp.PAD, thp.COLS), generator=g, device=dev,
                         dtype=torch.int8)
    t3 = {}
    for blk_mb in thp.BLOCK_MIB:
        blk_rows = blk_mb * (1 << 20) // thp.COLS
        got = thp.colsum(x_t3, blk_rows, thp.ROWS, blk_rows)
        check(torch.equal(got, thp.colsum_ref(x_t3, blk_rows, thp.ROWS, blk_rows)),
              f"T3 {blk_mb} MiB blocks: column sums differ")
        t3[blk_mb] = dict(plain_ms=timed(lambda: thp.colsum_ref(x_t3, blk_rows, thp.ROWS,
                                                                blk_rows), 2))
    log(f"    against the plain versions: T7 h bit-equal (dma4, dma1), within "
        f"{t7['dma12']['abs']:.3g} (dma12), checksums exact; T6 "
        + ", ".join(f"{p_} {max(v['errs'].values()):.3g}" for p_, v in t6.items())
        + " (scaled, h/k/v; dma bit-equal); T3 column sums exact at 4-32 MiB blocks")

    # the timings, each launch counter from 0 over its script's run
    tws.weight_stream.launches = tab.variant_step.launches = thp.colsum.launches = 0
    c_full = tk.make_cache(cfg, 1, 256, torch.bfloat16, dev)
    ones, zeros = torch.ones_like(cos), torch.zeros_like(sin)
    full_ms = timed(lambda: tkk.talker_decode_step(talker_p, cfg, x, c_full, 128, ones, zeros,
                                                   sample=False), 20)
    w_bytes = tws.nbytes(big + small)
    log(f"    T7 full (K1 non-sample, offset 128 of 256): {full_ms:.3f} ms/step, "
        f"{w_bytes / 1e6 / full_ms:.0f} GB/s of weights, bound {w_bytes / HBM_BYTES_S * 1e3:.3f} "
        f"ms  [{smi}]")
    for name, ops in ops_t7.items():
        hh = [x_o]

        def t7_step():
            hh[0] = tws.weight_stream(ops, hh[0])[0]

        ms = timed(t7_step, 20)
        b_ = t7[name]["bytes"]
        t7[name].update(ms=ms, bound=bound(b_, 0))
        b_ms = t7[name]["bound"][0]
        log(f"    T7 {name}: {ms:.3f} ms/step, {b_ / 1e6:.1f} MB -> {b_ / 1e6 / ms:.0f} GB/s, "
            f"bound {b_ms:.3f} ms ({b_ms / ms:.3f} of it)  [{smi}]")
    t7_launches = tws.weight_stream.launches
    rope_o = mrope_cos_sin(torch.arange(256, device=dev)[None], D, cfg.rope_theta,
                           cfg.mrope_section, torch.bfloat16)

    def t6_loop(part, c6, steps=66):
        x6 = torch.zeros(1, 1, H, dtype=torch.bfloat16, device=dev)
        for i in range(steps):
            off6 = tab.PREFILL_LEN + i
            cs6, sn6 = rope_o[0][0, off6], rope_o[1][0, off6]
            if part == "full":
                h6 = tkk.talker_decode_step(talker_p, cfg, x6, c6, off6, cs6, sn6, sample=False)
            else:
                h6 = tab.variant_step(talker_p, cfg, x6, c6, off6, cs6, sn6, part)[0]
            x6 = h6.reshape(1, 1, H)

    c6 = tk.make_cache(cfg, 1, 256, torch.bfloat16, dev)
    for part in tab.PARTS:
        ms = timed(lambda: t6_loop(part, c6), 1) / 66
        bnd6 = bound(tab.part_bytes(talker_p, part, tab.PREFILL_LEN + 32, cfg), 0)
        t6[part].update(ms=ms, bound=bnd6)
        log(f"    T6 {part:6s} x66: {ms:.3f} ms/step, {ms / L * 1e3:.1f} us/layer, bound "
            f"{bnd6[0]:.3f} ms ({bnd6[0] / ms:.3f} of it)  [{smi}]")
    t6_launches = tab.variant_step.launches
    n_t3 = ROWS_B = thp.ROWS * thp.COLS
    t3_bound = bound(n_t3, 0)
    lib_ms = timed(lambda: x_t3[8 : 8 + thp.ROWS].sum(0, dtype=torch.int32), 10)
    log(f"    T3 torch reduction x[a:a+ROWS].sum(0, int32): {lib_ms:.3f} ms/iter, "
        f"{ROWS_B / 1e6 / lib_ms:.1f} GB/s  [{smi}]")
    for blk_mb in thp.BLOCK_MIB:
        blk_rows = blk_mb * (1 << 20) // thp.COLS
        it = [0]

        def t3_iter():
            thp.colsum(x_t3, (it[0] % 2) * blk_rows, thp.ROWS, blk_rows)
            it[0] += 1

        ms = timed(t3_iter, 10)
        t3[blk_mb].update(ms=ms, gbs=n_t3 / 1e6 / ms)
        log(f"    T3 blk={blk_mb:2d} MiB: {ms:.4f} ms/iter, {n_t3 / 1e6 / ms:.1f} GB/s, bound "
            f"{t3_bound[0]:.4f} ms ({t3_bound[0] / ms:.3f} of it; 3.35 TB/s published)  [{smi}]")
    t3_launches = thp.colsum.launches
    log(f"    launches in the timings: T7 {t7_launches}, T6 {t6_launches}, T3 {t3_launches}; "
        f"phase o took {time.time() - t_o:.1f} s")
    del x_t3, c6, c_full, c_t6, ops_t7

    tk._attend, cpm_mod.predict_codes, gen.sample_token_inner = real_attend, real_pc, real_samp
    del bm, m17
    bf16_tmp.cleanup()

    # ---- p. T1, T4, T5, T2: the experiment kernels of this slice ----
    # Each against its plain version, on inputs its script's own check does
    # not use, then its script's run (the scripts' ``main`` at reduced
    # counts) with every launch counter from 0.
    from qwen3tts_tpu_torch.tools import exp_attn_forms as taf
    from qwen3tts_tpu_torch.tools import exp_cpk as tcp
    from qwen3tts_tpu_torch.tools import exp_int4_repack as tir
    from qwen3tts_tpu_torch.tools import exp_kv_append as tka

    t_p = time.time()
    log("[p] T1 (attention forms), T4 (int4 matvec forms), T5 (KV append), T2 (CP probes) "
        "against their plain versions, then their scripts at reduced counts")
    n_t1 = 100  # iterations of the T1 script's shorter call (the longer: 2 x n_t1)
    t1 = {}
    for form in taf.FORMS:
        qf, kf, vf = taf.inputs(form, 3, dev)
        got, ref = taf.attn_form(form, qf, kf, vf, 4), taf.attn_form_ref(form, qf, kf, vf, 4)
        err = scaled(got, ref)
        check(err <= 1e-3, f"T1 form {form}: scaled error {err:.3g} > 1e-3")
        t1[form] = dict(abs=float((got - ref).abs().max()), err=err,
                        plain_ms=timed(lambda: taf.attn_form_ref(form, qf, kf, vf, n_t1), 1),
                        bound=bound(taf.call_bytes(qf, kf, vf), n_t1 * taf.iteration_flops(qf, vf)))
    t4 = {}
    for I4, O4 in tir.SHAPES:
        w4 = tir.weights(I4, O4, 1, dev)
        plane_args = (w4["x"], w4["lo"], w4["hi"], w4["scales"])
        # mxu's kernel takes the fragment order, its plain version the MLX words
        for name, fn, ref_fn, args, ref_args in (
                ("mxu", tir.mxu_variant, tir.mxu_variant_ref,
                 (w4["x"], w4["frag"], w4["scales"], w4["biases"]),
                 (w4["x"], w4["packed"], w4["scales"], w4["biases"])),
                ("plane", tir.plane_variant, tir.plane_variant_ref, plane_args, plane_args)):
            got, ref = fn(*args), ref_fn(*ref_args)
            err = scaled(got, ref)
            check(err <= 1e-4, f"T4 {name} at ({I4}, {O4}): scaled error {err:.3g} > 1e-4")
            t4[(name, I4, O4)] = dict(abs=float((got - ref).abs().max()), err=err,
                                      plain_ms=timed(lambda: ref_fn(*ref_args), 10))
    g5 = torch.Generator(device=dev).manual_seed(5)
    rand5 = lambda *s_: torch.randn(*s_, generator=g5, device=dev).to(torch.bfloat16)
    kn5, vn5 = rand5(tka.L, tka.B, tka.HKV, tka.D), rand5(tka.L, tka.B, tka.HKV, tka.D)
    kc5, vc5 = rand5(tka.L, tka.B, tka.HKV, tka.T, tka.D), rand5(tka.L, tka.B, tka.HKV, tka.T, tka.D)
    # offsets at both ends of the cache, at 8k + 7 (the TPU's window edge)
    # and outside it (placed as dynamic_update_slice places them)
    offs5 = torch.tensor([0, 7, 8, tka.T - 1, -1, tka.T + 5] + [8 * k + 7 for k in range(2, 28)],
                         dtype=torch.int32, device=dev)
    ref5 = tka.kv_append_ref(kc5.clone(), vc5.clone(), kn5, vn5, offs5)
    tka.kv_append(kc5, vc5, kn5, vn5, offs5)
    check(torch.equal(kc5, ref5[0]) and torch.equal(vc5, ref5[1]),
          "T5: the kernel's caches differ from the plain version's")
    del kn5, vn5, kc5, vc5, ref5
    t2 = {}
    for name in tcp.PROBES:  # the script checks its own inputs; these are random
        args = tcp.probe_random_inputs(name, dev)
        got, ref = tcp.probe(name, *args), tcp.probe_ref(name, *args)
        err = tcp.agree(name, got, ref)  # raises if an exact probe differs
        check(err <= 1e-5, f"T2 {name}: scaled error {err:.3g} > 1e-5")
        t2[name] = dict(abs=max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(tcp.outputs(got), tcp.outputs(ref))),
                        plain_ms=timed(lambda: tcp.probe_ref(name, *args), 20))
    log(f"    against the plain versions: T1 scaled {max(v['err'] for v in t1.values()):.3g} "
        f"(<= 1e-3), T4 {max(v['err'] for v in t4.values()):.3g} (<= 1e-4), T5 bit-equal, T2 "
        f"exact on random inputs but p6 {t2['p6']['abs']:.3g} (<= 1e-5 scaled)")

    # the scripts' runs, each launch counter from 0
    taf.attn_form.launches = dict.fromkeys(taf.FORMS, 0)
    tcp.probe.launches = dict.fromkeys(tcp.PROBES, 0)
    tir.mxu_variant.launches = tir.plane_variant.launches = tka.kv_append.launches = 0
    r1 = taf.main([str(n_t1)])
    r4 = tir.main(["50"])
    r5 = tka.main(["1"])
    r2 = tcp.main([])
    others = [n_ for n_ in tcp.PROBES if n_ not in ("p2", "p6")]  # bound by their launch
    p_launches = dict(taf.attn_form.launches, mxu=tir.mxu_variant.launches,
                      plane=tir.plane_variant.launches, kv_append=tka.kv_append.launches,
                      p2=tcp.probe.launches["p2"], p6=tcp.probe.launches["p6"],
                      probes=sum(tcp.probe.launches[n_] for n_ in others))
    check(all(v > 0 for v in p_launches.values()) and all(tcp.probe.launches.values()),
          f"phase p: a kernel of the scripts' runs was never launched: {p_launches}, "
          f"{tcp.probe.launches}")
    for form in taf.FORMS:
        t1[form].update(ms=r1[form]["t1_ms"])
    h4 = (1024, 3072)  # the headline shape of the T4 entries
    check("library" in r4[h4]["queued_us"],
          f"T4: torch._weight_int4pack_mm did not run: {r4[h4]['library_dist']}")
    t4_lib_ms = r4[h4]["queued_us"]["library"] / 1e3
    for name in ("mxu", "plane"):
        t4[(name,) + h4].update(ms=r4[h4]["queued_us"][name] / 1e3,
                                bound=bound(r4[h4]["bytes"][name], 0))
    t5 = dict(abs=0.0, ms=r5["kernel"]["queued_ms"], plain_ms=r5["plain append (after)"]["ms"],
              bound=bound(r5["bytes"], 0))
    t5_lib_ms = r5["index_put_ (library)"]["queued_ms"]
    t2_floor_ms = r2["empty"]["queued_us"] / 1e3
    t2_gemv = {}
    for name, peak in (("p2", PEAK_INT8_OP_S), ("p6", PEAK_FLOP_S)):
        kk, nn = tcp.probe_inputs(name, "meta")[1].shape  # w [K, N]
        t2_gemv[name] = dict(abs=t2[name]["abs"], ms=r2[name]["queued_us"] / 1e3,
                             plain_ms=t2[name]["plain_ms"],
                             bound=bound(r2[name]["bytes"], 2 * kk * nn, peak))
    t2_all = dict(abs=max(t2[n_]["abs"] for n_ in others),
                  ms=sum(r2[n_]["queued_us"] for n_ in others) / 1e3,
                  plain_ms=sum(t2[n_]["plain_ms"] for n_ in others),
                  bound=bound(sum(r2[n_]["bytes"] for n_ in others), 0))
    log(f"    launches in the scripts' runs: {p_launches}; T1 us/iter "
        + ", ".join(f"{f_} {r1[f_]['per_us']:.3f}" for f_ in taf.FORMS)
        + f"; T5 ms/append: kernel {t5['ms']:.4f} and index_put_ {t5_lib_ms:.4f} queued, plain "
        f"{t5['plain_ms']:.4f}; T4 at {h4} queued us: mxu {t4[('mxu',) + h4]['ms'] * 1e3:.3f}, "
        f"plane {t4[('plane',) + h4]['ms'] * 1e3:.3f}, K4 {r4[h4]['queued_us']['packed']:.3f}, "
        f"torch._weight_int4pack_mm {t4_lib_ms * 1e3:.3f}; T2 queued us: p2 "
        f"{t2_gemv['p2']['ms'] * 1e3:.3f} (torch._int_mm {r2['p2']['library_us']:.3f}), p6 "
        f"{t2_gemv['p6']['ms'] * 1e3:.3f} ({r2['p6']['library']} {r2['p6']['library_us']:.3f}), "
        f"the other ten {t2_all['ms'] * 1e3:.2f} in all, the most "
        f"{max(r2[n_]['queued_us'] for n_ in others):.3f} against an empty kernel's "
        f"{t2_floor_ms * 1e3:.3f}; phase p took {time.time() - t_p:.1f} s  [{smi}]")

    # ---- q. K1 at B = 1: the persistent step in every mode ----
    t_q = time.time()
    log("[q] K1 at B = 1: the persistent step (csrc/talker_frame.cu) against its plain version")
    q_cases = [  # (label, weights, config, mode, kv_quant, top_p, sample)
        ("0.6B int8", talker_p, cfg, "wo_bf16", False, 1.0, True),
        ("0.6B int8, int8 cache", talker_p, cfg, "wo_bf16", True, 1.0, True),
        ("0.6B dyn_int8", talker_p, cfg, "dyn_int8", False, 1.0, True),
        ("0.6B dyn_int8, int8 cache", talker_p, cfg, "dyn_int8", True, 1.0, True),
        ("0.6B bf16 weights", talker_b, cfg, "wo_bf16", False, 1.0, True),
        ("0.6B bf16 weights, int8 cache", talker_b, cfg, "wo_bf16", True, 1.0, True),
        ("1.7B int8", trees17[2], cfg17, "wo_bf16", False, 1.0, True),
        ("1.7B int8, int8 cache", trees17[2], cfg17, "wo_bf16", True, 1.0, True),
        ("1.7B bf16 weights", trees17[0], cfg17, "wo_bf16", False, 1.0, True),
        ("0.6B int8, top_p 0.9", talker_p, cfg, "wo_bf16", False, 0.9, True),
        ("0.6B int8, non-sample", talker_p, cfg, "wo_bf16", False, 1.0, False),
    ]
    k1q = {}
    for T_q, pos_q in ((256, 40), (4096, 4000)):
        for label, p_, c_, mode, kv_quant, top_p, sample in q_cases:
            cache, offs, xb, cos_q, sin_q, _ = batch_case(1, T_q, kv_quant, pos_q, pos_q + 1,
                                                          pos_q + len(label), p=p_, c=c_)
            temp = 0.9 if top_p < 1 else 0.0
            kw = dict(sample=sample, temperature=temp, top_k=50, top_p=top_p, rep_penalty=1.05,
                      eos_id=-1, seed=(1, 2), suppress_add=supp, seen=seen, mode=mode)
            if sample:
                kw["return_logits"] = True

            def call(fn, c):
                out = fn(p_, c_, xb, c, pos_q, cos_q[0], sin_q[0], **kw)
                return out if sample else (out,)

            ck, cr = clone(cache), clone(cache)
            ok_, rk = call(tkk.talker_decode_step, ck), call(tkk.talker_decode_step_ref, cr)
            torch.cuda.synchronize()
            outs = dict(h=(ok_[0], rk[0]))
            if sample:
                outs["logits"] = (ok_[2], rk[2])
            for i, name in enumerate("kv"):  # the new rows (dequantized on an int8 cache)
                a, b = ck[i][:, 0, :, pos_q], cr[i][:, 0, :, pos_q]
                if kv_quant:
                    a = tk.dequantize_kv(a, ck[2 + i][:, 0, :, pos_q])
                    b = tk.dequantize_kv(b, cr[2 + i][:, 0, :, pos_q])
                outs[name] = (a, b)
            errs = {n_: scaled(a, b) for n_, (a, b) in outs.items()}
            if mode == "dyn_int8":  # against the float64 step, as phase k holds dyn_int8
                ref = dict(zip(("h", "logits", "k", "v"), k1_wide(
                    xb, cache, offs, cos_q, sin_q, tp_=p_, tc_=c_)))
                ref["k"], ref["v"] = ref["k"][:, 0], ref["v"][:, 0]
                wide_ = {n_: (scaled(a, ref[n_]), scaled(b, ref[n_])) for n_, (a, b) in outs.items()}
                check(all(kd <= 1.5 * pd + 0.005 and pd < 0.25 for kd, pd in wide_.values()),
                      f"K1 B=1 {label} at pos {pos_q} against the float64 step: {wide_}")
            else:
                check(max(errs.values()) < 0.05,
                      f"K1 B=1 {label} at pos {pos_q} outside the bf16 bound: {errs}")
            if sample:
                a_, b_ = int(ok_[1]), int(rk[1])
                z_q = pen(rk[2].reshape(-1)) + supp
                if top_p == 1.0:
                    check(a_ == b_ or near_tie(z_q, a_, b_, float((ok_[2] - rk[2]).abs().max())),
                          f"K1 B=1 {label} at pos {pos_q}: greedy code0 {a_} vs {b_}")
                else:
                    check(0 <= a_ < V and float(z_q[a_]) > -1e29,
                          f"K1 B=1 {label}: sampled code0 {a_} is not a kept id")
            ops = library_launches(lambda: call(tkk.talker_decode_step, clone(cache)))
            check(ops == 2, f"K1 B=1 {label}: {ops} operations a call, not 2")
            kc = clone(cache)
            ms_k = timed(lambda: call(tkk.talker_decode_step, kc), 10)
            ms_p = timed(lambda: call(tkk.talker_decode_step_ref, clone(cache)), 1)
            b_q = bound(*k1_io(1, pos_q, kv_quant, sample, logits=sample, p=p_, c=c_))
            k1q[(label, pos_q)] = dict(abs=float((ok_[0].float() - rk[0].float()).abs().max()),
                                       ms=ms_k, plain_ms=ms_p, bound=b_q)
            log(f"    {label}, pos {pos_q} of {T_q}: scaled err "
                + ", ".join(f"{n_} {e:.3g}" for n_, e in errs.items())
                + (f"; code0 {int(ok_[1])} vs {int(rk[1])}" if sample else "")
                + f"; {ms_k:.3f} ms/step (plain {ms_p:.1f}, bound {b_q[0]:.3f}); {ops} operations")
            del cache, ck, cr, kc
    log(f"    phase q took {time.time() - t_q:.1f} s  [{smi}]")

    # ---- r. streaming: generate_stream with and without audio chunks, the async stream ----
    import threading

    import numpy as np

    import qwen3tts_tpu_torch.tts as tts_mod
    from qwen3tts_tpu_torch.tts import AudioChunkEvent, AudioEvent, InfoEvent, TokenEvent

    t_r = time.time()
    log("[r] streaming: generate_stream of phase 6's 66-frame forbid_eos utterance against "
        "generate() at the same seed, with and without audio chunks; generate_stream_async")
    text_r, seed_r = "Streaming from the H100 port of the talker, sixty-six frames.", 11
    # phase 6's sampling (forbid_eos, 66 frames) through the public entry points
    model._sampling = lambda *a: sampling
    kw_r = dict(speaker="aiden", language="english", max_tokens=frames)
    rec = {}
    orig_gd = tts_mod._generate_and_decode

    def recording_gd(*a, **k):
        out = orig_gd(*a, **k)
        rec["codes"], rec["n"] = out[0].cpu(), out[1]
        return out

    tts_mod._generate_and_decode = recording_gd
    try:
        wav_r = model.generate(text_r, seed=seed_r, **kw_r)
    finally:
        tts_mod._generate_and_decode = orig_gd
    check(rec["n"] == frames, f"generate(): {rec['n']} frames, not {frames}")
    tokens_r = rec["codes"][:frames, 0].tolist()

    def stream_events(fn, seed_, **kw):
        """Events of one stream and the host seconds at which each arrived."""
        t0_ = time.time()
        evs, at = [], []
        for ev in fn(text_r, seed=seed_, **kw_r, **kw):
            evs.append(ev)
            at.append(time.time() - t0_)
        return evs, at

    def same_events(a, b, what):
        check([type(e) for e in a] == [type(e) for e in b], f"{what}: event kinds differ")
        for x, y in zip(a, b):
            if isinstance(x, TokenEvent):
                check(x.token == y.token, f"{what}: tokens differ")
            elif isinstance(x, AudioChunkEvent):
                check(x.frame_offset == y.frame_offset and np.array_equal(x.audio, y.audio),
                      f"{what}: chunk at frame {x.frame_offset} differs")
            elif isinstance(x, AudioEvent):
                check(np.array_equal(x.audio, y.audio), f"{what}: final audio differs")

    torch.cuda.synchronize()
    tkk.talker_decode_step.launches = tkk.talker_decode_step.persistent_launches = 0
    cpk.predict_codes_fused.launches = 0
    ev_r, at_r = stream_events(model.generate_stream, seed_r, audio_chunk_frames=4)
    path_r = (tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches)
    check(path_r == (frames - 1, frames) and tkk.talker_decode_step.persistent_launches == frames - 1,
          f"stream: K1 {path_r[0]}, K2 {path_r[1]} launches for {frames} frames")
    tok_ev = [e.token for e in ev_r if isinstance(e, TokenEvent)]
    chunks_r = [e for e in ev_r if isinstance(e, AudioChunkEvent)]
    final_r = ev_r[-1]
    check(isinstance(final_r, AudioEvent) and isinstance(ev_r[-2], InfoEvent),
          "stream: the last events are not InfoEvent, AudioEvent")
    check(tok_ev == tokens_r, "stream: TokenEvents differ from generate()'s code-0 tokens "
          f"(first difference at frame {next((i for i, (a, b) in enumerate(zip(tok_ev, tokens_r)) if a != b), len(tok_ev))})")
    check(np.array_equal(final_r.audio, wav_r), "stream: the AudioEvent differs from generate()'s "
          f"waveform (max |diff| {np.abs(final_r.audio - wav_r).max() if final_r.audio.shape == wav_r.shape else 'shape'})")
    pcm_r = np.concatenate([c.audio for c in chunks_r])
    check(chunks_r[0].frame_offset == 0 and pcm_r.shape[0] == frames * 1920
          and all(b.frame_offset * 1920 == a.frame_offset * 1920 + a.audio.shape[0]
                  for a, b in zip(chunks_r, chunks_r[1:])),
          "stream: the chunks do not tile the utterance")
    check(bool(np.isfinite(pcm_r).all()) and float(np.abs(pcm_r).max()) <= 1.0,
          "stream: chunk PCM not finite or outside [-1, 1]")
    i_tok = next(i for i, e in enumerate(ev_r) if isinstance(e, TokenEvent))
    i_aud = next(i for i, e in enumerate(ev_r) if isinstance(e, AudioChunkEvent))
    i_last = max(i for i, e in enumerate(ev_r) if isinstance(e, TokenEvent))
    first_chunk_r = min(model.stream_chunk_frames,
                        model.STREAM_FIRST_AUDIO_FRAMES + model.STREAM_LOOKAHEAD_FRAMES)

    def stream_times(at):
        """TTFT, TTFA (ms from the call) and the stream's ms a frame after
        its first chunk, of a run with ev_r's event sequence."""
        return (at[i_tok] * 1e3, at[i_aud] * 1e3,
                (at[i_last] - at[i_tok]) * 1e3 / (frames - first_chunk_r))

    log(f"    stream of {frames} frames, audio_chunk_frames=4: {len(tok_ev)} TokenEvents equal to "
        f"generate()'s code-0 tokens, the AudioEvent bit-equal to its waveform, {len(chunks_r)} "
        f"chunks tiling {pcm_r.shape[0]} samples; launches K1 {path_r[0]}, K2 {path_r[1]}")
    # the first stream met the vocoder windows' shapes cold; three warm runs time it
    cold_r = stream_times(at_r)
    warm_r = [stream_times(stream_events(model.generate_stream, seed_r, audio_chunk_frames=4)[1])
              for _ in range(3)]
    ttft_ms, ttfa_ms, stream_ms = (statistics.median(v) for v in zip(*warm_r))
    tokens_only = [stream_events(model.generate_stream, seed_r) for _ in range(3)]
    ttft_tokens_ms = statistics.median(at_[0] * 1e3 for _, at_ in tokens_only)
    log(f"    TTFT (first TokenEvent, after {first_chunk_r} frames) {ttft_ms:.1f} ms, TTFA (first "
        f"AudioChunkEvent) {ttfa_ms:.1f} ms, decode {stream_ms:.2f} ms/frame after the first "
        f"chunk (host reads and vocoder windows included; phase 6's loop: {decode6_ms:.2f}), "
        f"medians of 3 warm runs (the first, cold: {cold_r[0]:.1f}, {cold_r[1]:.1f}, "
        f"{cold_r[2]:.2f}); without audio chunks (the first read-back after the prefill) TTFT "
        f"{ttft_tokens_ms:.1f} ms  [{smi}]")

    # Without audio chunks the first read-back comes after the prefill and
    # the chunks end at other frames: the tokens and the final audio are
    # held equal over the whole utterance.
    ev_t = tokens_only[0][0]
    check([e.token for e in ev_t if isinstance(e, TokenEvent)] == tok_ev,
          "the stream without audio chunks: tokens differ from the stream with them")
    check(np.array_equal(ev_t[-1].audio, final_r.audio),
          "the stream without audio chunks: final audio differs from the stream with them")
    async_ev = list(model.generate_stream_async(text_r, seed=seed_r, audio_chunk_frames=4, **kw_r))
    same_events(ev_r, async_ev, "generate_stream_async against generate_stream")
    log(f"    the stream without audio chunks: the same tokens and final audio over {frames} "
        "frames; generate_stream_async: the same event sequence")
    log(f"    phase r took {time.time() - t_r:.1f} s")

    # ---- s. two streams at once: the decodes take turns on the card ----
    t_s = time.time()
    seeds_s = (seed_r, seed_r + 1)

    def stream_codes(seed_):
        evs = list(model.generate_stream(text_r, seed=seed_, **kw_r))
        return [e.token for e in evs if isinstance(e, TokenEvent)], evs[-1].audio

    torch.cuda.synchronize()
    t0 = time.time()
    alone = {s_: stream_codes(s_) for s_ in seeds_s}
    alone_s = time.time() - t0
    got_s, keys_s, errs_s = {}, {}, []  # keys_s: each thread's CUDA stream
    start_s = threading.Barrier(len(seeds_s))

    def worker(seed_):
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                keys_s[seed_] = torch.cuda.current_stream(dev).cuda_stream
                start_s.wait()
                got_s[seed_] = stream_codes(seed_)
        except BaseException as ex:  # noqa: BLE001  (reported by the check below)
            errs_s.append(repr(ex))

    workers = [threading.Thread(target=worker, args=(s_,)) for s_ in seeds_s]
    t0 = time.time()
    for w_ in workers:
        w_.start()
    for w_ in workers:
        w_.join()
    both_s = time.time() - t0
    check(not errs_s, f"two streams: {errs_s}")
    check(len(set(keys_s.values())) == 2, "two streams: the threads shared a stream")
    for s_ in seeds_s:
        check(got_s[s_][0] == alone[s_][0], f"two streams: seed {s_}'s tokens differ from its run alone")
        check(np.array_equal(got_s[s_][1], alone[s_][1]),
              f"two streams: seed {s_}'s audio differs from its run alone")
    # the async producer and the main thread, both on the default stream
    t0 = time.time()
    async_s = model.generate_stream_async(text_r, seed=seeds_s[0], **kw_r)
    main_s = stream_codes(seeds_s[1])
    evs_s = list(async_s)
    default_s = time.time() - t0
    check([e.token for e in evs_s if isinstance(e, TokenEvent)] == alone[seeds_s[0]][0]
          and np.array_equal(evs_s[-1].audio, alone[seeds_s[0]][1]),
          f"async beside the main thread: seed {seeds_s[0]} differs from its run alone")
    check(main_s[0] == alone[seeds_s[1]][0] and np.array_equal(main_s[1], alone[seeds_s[1]][1]),
          f"async beside the main thread: seed {seeds_s[1]} differs from its run alone")
    del model._sampling  # the class's again
    log(f"[s] two threads, each under its own torch.cuda.Stream, streamed seeds {seeds_s} at once: "
        f"tokens and audio equal to each seed run alone; {both_s:.3f} s at once against "
        f"{alone_s:.3f} s one after the other; an async stream beside a stream on the main "
        f"thread (the default stream): equal too, {default_s:.3f} s  [{smi}]")
    log(f"    phase s took {time.time() - t_s:.1f} s")

    # ---- t. voice clone at full width (the Base model's encoders) ----
    from qwen3tts_tpu_torch.models import encoder as enc_mod
    from qwen3tts_tpu_torch.models import speaker_encoder as spk_mod

    t_t = time.time()
    enc_cfg, spk_cfg = C.TokenizerEncoderConfig(), C.SpeakerEncoderConfig()
    gt = torch.Generator(device=dev).manual_seed(5)
    base = Qwen3TTSModel(
        C.ModelConfig(talker_config=cfg, tts_model_type="base", tts_model_size="0b6",
                      speaker_encoder_config=spk_cfg),
        talker_p, cp_p, voc_p,
        tokenizer_config=C.TokenizerConfig(decoder_config=dec_cfg, encoder_config=enc_cfg),
        encoder_params=hi.init_encoder_params(gt, enc_cfg, torch.float32, dev),
        speaker_encoder_params=hi.init_speaker_encoder_params(gt, spk_cfg, torch.float32, dev),
        tokenizer=StubTokenizer(cfg.text_vocab_size), dtype=torch.bfloat16, device=dev,
    )
    check(base.supports_voice_cloning and base.has_voice_cloning, "Base model: no voice cloning")
    ref_t = (np.random.default_rng(3).standard_normal(3 * 24000) * 0.1).astype(np.float32)
    ref_text, text_t = "A reference transcript of three seconds.", "Hello from a cloned voice."
    audio_t = torch.from_numpy(ref_t).to(dev)
    enc_ms = stage_ms(lambda: enc_mod.encode(base.encoder_params, enc_cfg, audio_t[None]))
    spk_ms = stage_ms(lambda: spk_mod.extract_embedding(base.speaker_encoder_params, spk_cfg,
                                                        audio_t))
    emb_t, trail_t, pad_t, ref_codes_t = base._prepare_icl_generation_inputs(text_t, ref_t,
                                                                             ref_text)
    check(tuple(ref_codes_t.shape) == (1, 16, 38), f"ref codes {tuple(ref_codes_t.shape)}")
    steps_t = base._effective_max_tokens(text_t, 2048)
    prep_t = base._prep_run(emb_t, trail_t, pad_t, steps_t)
    cache_len_t = prep_t.pop("cache_len")
    prep_t.pop("kv_quant")
    icl_prefill_ms = stage_ms(lambda: gen.prefill_start(
        talker_p, cp_p, talker_cfg=cfg, cp_cfg=cpc, sampling=base._sampling(0.9, 50, 1.0, 1.5),
        **prep_t, seed=0, cache=tk.make_cache(cfg, 1, cache_len_t, torch.bfloat16, dev)))
    torch.cuda.synchronize()
    tkk.talker_decode_step.launches = tkk.talker_decode_step.persistent_launches = 0
    cpk.predict_codes_fused.launches = 0
    t0 = time.time()
    wav_t = base.generate_voice_clone(text_t, ref_t, ref_text, seed=0)
    clone_s = time.time() - t0
    n_t = base.last_info.generation_token_count
    path_t = (tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches)
    eos_t = n_t < steps_t
    check(path_t[1] == n_t and path_t[0] == n_t - 1 + int(eos_t)
          and tkk.talker_decode_step.persistent_launches == path_t[0],
          f"clone: K1 {path_t[0]}, K2 {path_t[1]} launches for {n_t} frames")
    check(bool(np.isfinite(wav_t).all()) and float(np.abs(wav_t).max()) <= 1.0 and len(wav_t) > 0,
          "clone: waveform not finite, empty or outside [-1, 1]")
    log(f"[t] generate_voice_clone at 0.6B (Base; speaker encoder and tokenizer encoder at their "
        f"config widths): {n_t} frames (cap {steps_t}{', EOS' if eos_t else ''}), {len(wav_t)} "
        f"samples, {clone_s:.2f} s; launches K1 {path_t[0]}, K2 {path_t[1]}; encode of 3 s "
        f"{enc_ms:.2f} ms ({ref_codes_t.shape[-1]} frames), speaker embedding {spk_ms:.2f} ms, ICL "
        f"prompt {emb_t.shape[1]} positions, prefill + first frame {icl_prefill_ms:.2f} ms  [{smi}]")
    log(f"    phase t took {time.time() - t_t:.1f} s")

    # ---- u. serving: per-row sampling in K1 and K2, model.serve(), HTTP ----
    import http.client
    import threading
    import urllib.error
    import urllib.request

    from qwen3tts_tpu_torch import serving as srv_mod
    from qwen3tts_tpu_torch.ops.decode_blocks import row_sampling, samp_rows
    from qwen3tts_tpu_torch.serving_http import make_server

    t_u = time.time()
    # (temperature, top_k, top_p, repetition_penalty) rows, cycled over a batch:
    # greedy, plain, top-k 1, top-p alone, both with a penalty, a truncated top-k
    per_row = np.asarray([
        [0.0, 0, 1.0, 1.0], [0.9, 50, 1.0, 1.05], [0.7, 1, 1.0, 1.2], [1.1, 0, 0.8, 1.0],
        [0.9, 20, 0.9, 1.3], [0.0, 20, 0.8, 1.2], [1.3, 7.9, 0.5, 1.05], [0.8, 100, 0.95, 1.0],
    ], np.float32)

    def flip_at_cut(r, z, a_, b_):
        return r["temperature"] > 0 and 0 < r["top_p"] < 1 and top_p_flip_ok(
            top_k_filter(z, r["top_k"]), r["top_p"], False, a_, b_)

    k1u, k2u = {}, {}
    log("[u] per-row sampling values in K1 and K2 (a [B, 5] table the sampler reads row by row; "
        "no launch added): codes against sample_row with each row's values on the kernels' logits")
    for B in (8, 64):
        cache_u, offs_u, x_u, cos_u, sin_u, seen_u = batch_case(B, 128, False, 20, 120, 1600 + B)
        vec_u = np.resize(per_row, (B, 4))
        rows_u = samp_rows(vec_u, dev)
        uni_u = samp_rows(np.tile([[0.9, 50, 0.9, 1.05]], (B, 1)), dev)

        def k1u_call(c, seed=(3, 4), rows=rows_u, logits=False, fn=tkk.talker_decode_step):
            return fn(talker_p, cfg, x_u, c, offs_u, cos_u, sin_u, temperature=0.9, top_k=50,
                      top_p=0.9, rep_penalty=1.05, eos_id=-1, seed=seed, suppress_add=supp,
                      seen=seen_u, return_logits=logits, rows=rows)

        check(torch.equal(k1u_call(clone(cache_u), rows=uni_u)[1],
                          k1u_call(clone(cache_u), rows=None)[1]),
              f"K1 B={B}: a uniform per-row table differs from the scalar call")
        flips1 = 0
        for s_ in range(2):
            _, code_k, lg_k = k1u_call(clone(cache_u), (s_, 21), logits=True)
            for b in range(B):
                r = row_sampling(vec_u[b])
                want = int(sample_row(lg_k[b], **r, seen=seen_u[b], suppress_add=supp,
                                      seed=(s_, 21), stream=16 * b))
                if int(code_k[b]) != want:
                    flips1 += 1
                    z = torch.where(seen_u[b], torch.where(lg_k[b] < 0, lg_k[b] * r["rep_penalty"],
                                                           lg_k[b] / r["rep_penalty"]), lg_k[b])
                    check(flip_at_cut(r, z + supp, int(code_k[b]), want),
                          f"K1 B={B} row {b}: per-row code beyond a top-p cut")
        check(flips1 <= max(1, B // 8), f"K1 B={B}: {flips1} per-row flips")
        _, _, lr_u = k1u_call(clone(cache_u), logits=True, fn=tkk.talker_decode_step_ref)
        abs1 = float((lg_k - lr_u).abs().max())
        c_t = clone(cache_u)
        ms1 = {}
        table_of = {"scalar": None, "uniform": uni_u, "per-row": rows_u}
        for form in ("scalar", "uniform", "per-row") * 2:
            ms1.setdefault(form, []).append(timed(lambda: k1u_call(c_t, rows=table_of[form]), 10))
        plain1 = timed(lambda: k1u_call(clone(cache_u), fn=tkk.talker_decode_step_ref), 1)
        k1u[B] = dict(abs=abs1, ms=statistics.median(ms1["per-row"]), plain_ms=plain1,
                      bound=bound(*k1_io(B, int(offs_u.sum()), False, True)))
        del cache_u, c_t
        gb = torch.Generator(device=dev).manual_seed(1700 + B)
        h_u = torch.randn(B, H, generator=gb, device=dev).mul(0.3).to(torch.bfloat16)
        c0_u = torch.randint(0, 2048, (B,), generator=gb, device=dev, dtype=torch.int32)

        def k2u_call(seed=(5, 6), rows=rows_u, fn=cpk.predict_codes_fused, **kw):
            return fn(cp_p, cpc, talker_p, h_u, c0_u, seed, temperature=0.9, top_k=50, top_p=0.9,
                      rows=rows, **kw)

        check(torch.equal(k2u_call(rows=uni_u)[0], k2u_call(rows=None)[0]),
              f"K2 B={B}: a uniform per-row table differs from the scalar call")
        codes_k, _, lg2 = k2u_call(return_logits=True)
        lg2 = lg2.reshape(15, B, -1)
        flips2 = 0
        for b in range(B):
            r = row_sampling(vec_u[b])
            r.pop("rep_penalty")  # the CP applies no penalty
            for j in range(15):
                want = int(sample_row(lg2[j, b], **r, seed=(5, 6), stream=j + 1 + 16 * b))
                if int(codes_k[b, j]) != want:
                    flips2 += 1
                    check(flip_at_cut(dict(r, rep_penalty=1.0), lg2[j, b], int(codes_k[b, j]),
                                      want), f"K2 B={B} ({b}, {j}): per-row code beyond a cut")
        check(flips2 <= max(1, B // 8), f"K2 B={B}: {flips2} per-row flips")
        _, _, lr2 = k2u_call(fn=cpk.predict_codes_fused_ref, force_codes=codes_k,
                             return_logits=True)
        abs2 = float((lg2 - lr2.reshape(15, B, -1)).abs().max())
        ms2 = {}
        for form in ("scalar", "uniform", "per-row") * 2:
            ms2.setdefault(form, []).append(timed(lambda: k2u_call(rows=table_of[form]), 10))
        plain2 = timed(lambda: k2u_call(fn=cpk.predict_codes_fused_ref), 1)
        k2u[B] = dict(abs=abs2, ms=statistics.median(ms2["per-row"]), plain_ms=plain2,
                      bound=bound(*k2_io(B)))
        log(f"    B={B}: K1 {2 * B - flips1}/{2 * B} codes equal ({flips1} at the top-p cut), "
            f"logits max abs {abs1:.3g} against the plain version; K2 {15 * B - flips2}/{15 * B} "
            f"({flips2} at the cut), logits {abs2:.3g}; ms a call in turns, scalar (top-k 50, "
            f"top-p 0.9) / the same values as a table / the mixed rows: K1 " + " / ".join(
                ", ".join(f"{t:.3f}" for t in ms1[k]) for k in table_of) + ", K2 " + " / ".join(
                ", ".join(f"{t:.3f}" for t in ms2[k]) for k in table_of)
            + f"; plain K1 {plain1:.1f}, K2 {plain2:.1f}; bound K1 {k1u[B]['bound'][0]:.3f} "
            f"({k1u[B]['bound'][1]}), K2 {k2u[B]['bound'][0]:.3f} ({k2u[B]['bound'][1]})  [{smi}]")

    # model.serve(slots=16): 32 requests of ragged caps, the whole batch
    # submitted at once; after admission the plain CP loop and the plain
    # per-layer decode step raise (a raise in the worker fails every future)
    def plain_ran(*a, **k):
        raise AssertionError("the plain CP loop ran on the card")

    def no_plain_step(q, *a, **k):
        if q.shape[2] == 1:
            raise AssertionError("a plain per-layer decode step ran on the card")
        return real_attend(q, *a, **k)

    cpm_mod.predict_codes, tk._attend = plain_ran, no_plain_step
    serve_texts = SERVE_TEXTS
    serve_caps = [20 + (46 * i) // 31 for i in range(32)]  # 20..66 frames
    frames_seen = []

    def serve_run(m, per_request, n_req=32, slots=16, **kw):
        """Submit n_req requests at once; returns (wall s, latencies s,
        frames a request, lockstep frames, (K1, K2) launches, spans). The
        spans are the host seconds of each admission and each chunk (both
        end in the device turn's synchronisation) and of each vocoder call
        (it ends in its copy to the host; the worker runs it in the
        request's completion callback, between chunks)."""
        real_decode = m._decode_codes_list
        real_admit, real_chunk = srv_mod.bg.admit_slot, srv_mod.bg.generate_chunk_batch
        spans = {"admit": [], "chunk": [], "vocode": []}

        def span(name, fn):
            def run(*a, **k):
                t_ = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spans[name].append(time.perf_counter() - t_)
            return run

        def counting_decode(codes):
            frames_seen.extend(c.shape[0] for c in codes)
            return real_decode(codes)

        m._decode_codes_list = span("vocode", counting_decode)
        srv_mod.bg.admit_slot = span("admit", real_admit)
        srv_mod.bg.generate_chunk_batch = span("chunk", real_chunk)
        frames_seen.clear()
        tkk.talker_decode_step.launches = tkk.talker_decode_step.persistent_launches = 0
        cpk.predict_codes_fused.launches = 0
        done_at = [0.0] * n_req
        with m.serve(slots=slots, chunk_frames=8, max_frames=72, per_request_sampling=per_request,
                     **kw) as svc:
            torch.cuda.synchronize()
            t0_ = time.time()
            futs = []
            for i in range(n_req):
                over = {}
                if per_request:
                    r = row_sampling(per_row[i % len(per_row)])
                    over = dict(temperature=r["temperature"], top_k=r["top_k"], top_p=r["top_p"],
                                repetition_penalty=r["rep_penalty"])
                f = svc.submit(serve_texts[i], speaker="aiden", language="english", seed=i,
                               max_tokens=serve_caps[i], **over)
                f.add_done_callback(lambda _, i=i: done_at.__setitem__(i, time.time()))
                futs.append(f)
            wavs = [f.result(timeout=600) for f in futs]
            wall_ = time.time() - t0_
            iters = svc._server.total_iterations
        del m._decode_codes_list
        srv_mod.bg.admit_slot, srv_mod.bg.generate_chunk_batch = real_admit, real_chunk
        n1_, n2_ = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
        # whole frames (an EOS on the first frame gives none; a frame whose
        # code 0 is 0 is trimmed, as generate() trims it)
        bad = [(i, len(w), c) for i, (w, c) in enumerate(zip(wavs, serve_caps))
               if not (bool(np.isfinite(w).all()) and len(w) <= c * 1920 and len(w) % 1920 == 0)]
        check(not bad, f"served waveforms malformed (request, samples, cap): {bad}")
        check(len(frames_seen) == sum(len(w) > 0 for w in wavs) and n1_ == iters
              and n2_ == iters + n_req and tkk.talker_decode_step.persistent_launches == 0,
              f"served run: K1 {n1_}, K2 {n2_} for {iters} lockstep frames and {n_req} admissions "
              f"({len(frames_seen)} vocoded)")
        return wall_, [d - t0_ for d in done_at], list(frames_seen), iters, (n1_, n2_), spans

    serve_u = {}
    for per_request in (False, True, False, True):
        serve_u.setdefault(per_request, []).append(serve_run(model, per_request))
    for per_request, runs in serve_u.items():
        tps = [16 * sum(r[2]) / r[0] for r in runs]
        lat = [np.percentile(r[1], [50, 95]) for r in runs]
        log(f"    serve(slots=16), 32 requests (caps 20-66), per_request_sampling={per_request}: "
            f"{sum(runs[0][2])} frames in {runs[0][3]} lockstep frames; codec tokens/s "
            f"{', '.join(f'{t:.0f}' for t in tps)}; per-request latency p50 "
            f"{', '.join(f'{l[0]:.3f}' for l in lat)} s, p95 "
            f"{', '.join(f'{l[1]:.3f}' for l in lat)} s (in turns); launches K1 "
            f"{runs[0][4][0]}, K2 {runs[0][4][1]}  [{smi}]")
        for r in runs:
            adm, chk, voc = (sum(r[5][k]) for k in ("admit", "chunk", "vocode"))
            log(f"      split of a {r[0]:.3f} s run: {len(r[5]['admit'])} admissions "
                f"{adm:.3f} s ({1e3 * adm / max(len(r[5]['admit']), 1):.2f} ms each), "
                f"{len(r[5]['chunk'])} chunks {chk:.3f} s ({r[3]} lockstep frames, "
                f"{1e3 * chk / max(r[3], 1):.2f} ms a frame), the rest {r[0] - adm - chk:.3f} s, "
                f"of it {len(r[5]['vocode'])} vocoder calls on the worker {voc:.3f} s "
                f"({1e3 * voc / max(len(r[5]['vocode']), 1):.2f} ms each)")
    serve_launches = serve_u[True][0][4]
    model_q = Qwen3TTSModel(model.config, talker_p, cp_p, voc_p,
                            tokenizer_config=model.tokenizer_config, tokenizer=model.tokenizer,
                            dtype=torch.bfloat16, device=dev, kv_cache_dtype="int8")
    wall_q, _, frames_q, iters_q, launches_q, _ = serve_run(model_q, True, n_req=16)
    log(f"    serve on an int8 KV cache, 16 per-request requests: {sum(frames_q)} frames, "
        f"{iters_q} lockstep frames, {wall_q:.2f} s, launches K1 {launches_q[0]}, K2 "
        f"{launches_q[1]}")
    cpm_mod.predict_codes, tk._attend = real_pc, real_attend

    # one greedy request alone, then behind five sampled neighbours: another
    # slot, other neighbours, the same codes
    with model.serve(slots=16, chunk_frames=8, max_frames=72, per_request_sampling=True) as svc:
        def served(text, seed, **over):
            item = svc._item(text, "aiden", None, "english", seed, 40, over.get("temperature"),
                             over.get("top_k"), over.get("top_p"), over.get("repetition_penalty"))
            return svc._server.submit(item)  # the server exists once an item was built

        greedy_kw = dict(temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.0)
        alone_u = served(serve_texts[0], 0, **greedy_kw).result(timeout=300)
        futs_u = [served(serve_texts[i], i, temperature=0.9, top_k=50, top_p=0.9,
                         repetition_penalty=1.1) for i in range(1, 6)]
        again_u = served(serve_texts[0], 0, **greedy_kw).result(timeout=300)
        [f.result(timeout=300) for f in futs_u]
    check(alone_u.n_frames == again_u.n_frames > 0 and (alone_u.codes == again_u.codes).all(),
          "a greedy request's codes depend on its slot or neighbours")
    log(f"    a greedy request alone and behind 5 sampled neighbours: {alone_u.n_frames} frames, "
        "codes equal")

    # HTTP on 127.0.0.1: one /synthesize, one /synthesize_stream, a 429
    def post(port_, path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port_}{path}",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    for kw in (dict(slots=4, per_request_sampling=True), dict(slots=1, max_queue=1)):
        with model.serve(chunk_frames=8, max_frames=72, **kw) as svc:
            http_srv = make_server(svc, "127.0.0.1", 0)
            http_port = http_srv.server_address[1]
            threading.Thread(target=http_srv.serve_forever, daemon=True).start()
            try:
                body_u = {"text": "Hello over HTTP.", "speaker": "aiden", "max_tokens": 30}
                if kw["slots"] == 4:
                    # values the sampler cannot take: refused at the door, the worker unharmed
                    code_nan = [post(http_port, "/synthesize", dict(body_u, **bad))[0]
                                for bad in ({"temperature": float("nan")}, {"top_p": "nan"})]
                    check(code_nan == [400, 400], f"HTTP: NaN sampling values gave {code_nan}")
                    code_h, wav_h = post(http_port, "/synthesize", dict(body_u, top_p=0.9))
                    conn = http.client.HTTPConnection("127.0.0.1", http_port, timeout=300)
                    conn.request("POST", "/synthesize_stream", body=json.dumps(body_u),
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    stream_h = resp.read()
                    conn.close()
                    check(code_h == 200 and wav_h[:4] == b"RIFF" and resp.status == 200
                          and stream_h[:4] == b"RIFF" and (len(stream_h) - 44) % (2 * 1920) == 0,
                          f"HTTP: /synthesize {code_h}, /synthesize_stream {resp.status}")
                else:
                    codes_h = []
                    flood = [threading.Thread(target=lambda i=i: codes_h.append(post(
                        http_port, "/synthesize", dict(body_u, text=f"flood {i}"))[0]))
                        for i in range(6)]
                    for t_ in flood:
                        t_.start()
                    for t_ in flood:
                        t_.join()
                    check(429 in codes_h and 200 in codes_h and set(codes_h) <= {200, 429},
                          f"HTTP flood: {codes_h}")
            finally:
                http_srv.shutdown()
                http_srv.server_close()
    log(f"    HTTP: a NaN temperature and a NaN top_p {code_nan}, then /synthesize a "
        f"{len(wav_h)}-byte WAV, /synthesize_stream a chunked {len(stream_h)}-byte WAV, a flood of 6 on one slot with one waiting place: "
        f"{sorted(codes_h)}")
    log(f"    phase u took {time.time() - t_u:.1f} s")

    # ---- v. multi-GPU: dp replicas (dp_mesh) and the tensor-parallel mesh ----
    phase_v(dev, smi, cfg, model, talker_b, cp_b, voc_p)

    # ---- w. the CLI and the activation profiler ----
    phase_w(dev, smi, cfg, ckpt)
    ckpt_tmp.cleanup()

    print(smi, flush=True)
    k1_64, k2_64 = k1b[(64, True)], k2b[64]
    kernels = [
        dict(name="talker_decode_step (B=1: one persistent launch, 2 operations a call)",
             route="cuda", source="qwen3tts_tpu_torch/csrc/talker_frame.cu",
             replaces="qwen3tts_tpu/ops/talker_kernel.py:656", launches=n1,
             max_abs_err=k1_abs, ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound[0],
             bound_by=k1_bound[1], library_ms=None),
        dict(name="predict_codes_fused (B=1: one persistent launch, 2 operations a call)",
             route="cuda", source="qwen3tts_tpu_torch/csrc/cp_loop.cu",
             replaces="qwen3tts_tpu/ops/cp_kernel.py:619", launches=n2,
             max_abs_err=k2_abs, ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound[0],
             bound_by=k2_bound[1], library_ms=None),
        dict(name="decode_attention_inner", route="cuda",
             source="qwen3tts_tpu_torch/csrc/decode_attention.cu",
             replaces="qwen3tts_tpu/ops/attention.py:141", launches=k3_launches,
             max_abs_err=k3_abs, ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound[0],
             bound_by=k3_bound[1], library_ms=k3_lib_ms),
        dict(name="quant_gemv", route="cuda", source="qwen3tts_tpu_torch/csrc/quant_matmul.cu",
             replaces="qwen3tts_tpu/ops/quant.py:134", launches=k4_launches,
             max_abs_err=k4_abs, ms=k4_ms, plain_ms=k4_plain_ms, bound_ms=k4_bound[0],
             bound_by=k4_bound[1], library_ms=k4_lib_ms),
        dict(name="talker_decode_step (B=64, int8 KV; GEMVs on the tensor cores, 8 L + 3 operations "
                  "a call)", route="cuda",
             source="qwen3tts_tpu_torch/csrc/talker_step.cu",
             replaces="qwen3tts_tpu/ops/talker_kernel.py:656", launches=grid_launches[0],
             max_abs_err=k1_64["abs"], ms=k1_64["ms"], plain_ms=k1_64["plain_ms"],
             bound_ms=k1_64["bound"][0], bound_by=k1_64["bound"][1], library_ms=None),
        dict(name="predict_codes_fused (B=64)", route="cuda",
             source="qwen3tts_tpu_torch/csrc/cp_loop.cu",
             replaces="qwen3tts_tpu/ops/cp_kernel.py:619", launches=grid_launches[1],
             max_abs_err=k2_64["abs"], ms=k2_64["ms"], plain_ms=k2_64["plain_ms"],
             bound_ms=k2_64["bound"][0], bound_by=k2_64["bound"][1], library_ms=None),
    ]

    def entry(name, kernel, r, launches):
        src, rep = {"K1": ("talker_step.cu", "talker_kernel.py:656"),
                    "K1 B=1": ("talker_frame.cu", "talker_kernel.py:656"),
                    "K2": ("cp_loop.cu", "cp_kernel.py:619")}[kernel]
        return dict(name=name, route="cuda", source=f"qwen3tts_tpu_torch/csrc/{src}",
                    replaces=f"qwen3tts_tpu/ops/{rep}", launches=launches, max_abs_err=r["abs"],
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=None)

    j_bf16, j_17 = grid_j["bf16 checkpoint 0.6B"], grid_j["1.7B int8"]
    kernels += [
        entry("talker_decode_step (bf16 weights, B=1)", "K1 B=1", k1f[(1, False)], path_h[0]),
        entry("talker_decode_step (bf16 weights, B=64; tensor cores)", "K1", k1f[(64, False)],
              j_bf16["launches"][0]),
        entry("talker_decode_step (1.7B int8, B=1)", "K1 B=1", k1g[("int8", 1)], path_i["int8"][0]),
        entry("talker_decode_step (1.7B bf16, B=1)", "K1 B=1", k1g[("bf16", 1)], path_i["bf16"][0]),
        entry("talker_decode_step (1.7B int8, B=64; tensor cores)", "K1", k1g[("int8", 64)],
              j_17["launches"][0]),
        entry("predict_codes_fused (bf16 weights, B=1; persistent)", "K2", k2g[("bf16 0.6B", 1)],
              path_h[1]),
        entry("predict_codes_fused (bf16 weights, B=64)", "K2", k2g[("bf16 0.6B", 64)],
              j_bf16["launches"][1]),
        entry("predict_codes_fused (1.7B projection, int8, B=1; persistent)", "K2",
              k2g[("int8 1.7B", 1)],
              path_i["int8"][1]),
        entry("predict_codes_fused (1.7B projection, bf16, B=1; persistent)", "K2",
              k2g[("bf16 1.7B", 1)],
              path_i["bf16"][1]),
        entry("predict_codes_fused (1.7B projection, int8, B=64)", "K2", k2g[("int8 1.7B", 64)],
              j_17["launches"][1]),
    ]
    dyn64 = cell_l["dyn_int8"][0]["launches"]
    kernels += [
        entry("talker_decode_step (dyn_int8, B=1)", "K1 B=1", k1k[(1, False)], path_l[0]),
        entry("talker_decode_step (dyn_int8, B=64; tensor cores)", "K1", k1k[(64, False)], dyn64[0]),
        entry("talker_decode_step (1.7B dyn_int8, B=1)", "K1 B=1", k1k[("1.7B", 1)], path_l17[0]),
        entry("predict_codes_fused (dyn_int8, B=1; persistent)", "K2", k2k[("0.6B", 1)], path_l[1]),
        entry("predict_codes_fused (dyn_int8, B=64)", "K2", k2k[("0.6B", 64)], dyn64[1]),
        entry("predict_codes_fused (1.7B dyn_int8, B=1; persistent)", "K2", k2k[("1.7B", 1)],
              path_l17[1]),
        entry("predict_codes_fused (unfused int8 layers, B=1; persistent)", "K2",
              k2k[("unfused", "wo_bf16", 1)], path_m[1]),
        dict(entry("predict_codes_fused (K5's port, ops/cp_kernel_old.py, B=1; persistent)", "K2",
                   k2k[("K5", "wo_bf16")], k5_launches),
             replaces="qwen3tts_tpu/ops/cp_kernel_old.py:598"),
        entry("talker_decode_step (sampler with top_p 0.9, B=1)", "K1 B=1",
              dict(abs=k1_tp_abs, ms=k1_tp_ms, plain_ms=k1_tp_plain, bound=k1_bound),
              path_n[False][0]),
        entry("predict_codes_fused (sampler with top_p 0.9, B=1; persistent)", "K2",
              dict(abs=k2_tp_abs, ms=k2_tp_ms, plain_ms=k2_tp_plain, bound=k2_bound),
              path_n[False][1]),
        entry("talker_decode_step (per-row sampling values, B=64; launches: the served "
              "per-request run at 16 slots)", "K1", k1u[64], serve_launches[0]),
        entry("predict_codes_fused (per-row sampling values, B=64; launches: the served "
              "per-request run at 16 slots)", "K2", k2u[64], serve_launches[1]),
    ]

    q_launches = {"0.6B int8": n1_persistent, "0.6B int8, int8 cache": n1_persistent,
                  "0.6B dyn_int8": path_l[0], "0.6B dyn_int8, int8 cache": path_l[0],
                  "0.6B bf16 weights": path_h[0], "0.6B bf16 weights, int8 cache": path_h[0],
                  "1.7B int8": path_i["int8"][0], "1.7B int8, int8 cache": path_i["int8"][0],
                  "1.7B bf16 weights": path_i["bf16"][0], "0.6B int8, top_p 0.9": path_n[False][0]}
    kernels += [entry(f"talker_decode_step (B=1 persistent, {label}, pos {pos_q})", "K1 B=1",
                      k1q[(label, pos_q)], q_launches[label])
                for (label, pos_q) in k1q if label in q_launches]

    def tool(name, src, rep, r, launches, library_ms=None):
        """An entry of an experiment kernel; r["bound"] is ``bound()``'s."""
        return dict(name=name, route="cuda", source=f"qwen3tts_tpu_torch/csrc/{src}",
                    replaces=f"tools/{rep}", launches=launches, max_abs_err=r["abs"],
                    ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                    bound_by=r["bound"][1], library_ms=library_ms)

    kernels += [tool(f"weight_stream ({name})", "weight_stream.cu", "exp_weight_stream.py:123",
                     t7[name], t7_launches) for name in ("dma4", "dma12", "dma1")]
    kernels += [tool(f"variant_step ({part})", "talker_ablate.cu" if part == "dma" else
                     "talker_frame.cu", "exp_tk_b1_ablate.py:202", t6[part], t6_launches)
                for part in ("noattn", "nomlp", "dma")]
    kernels += [tool(f"colsum ({mb} MiB blocks)", "hbm_read.cu", "exp_hbm_peak.py:57",
                     dict(t3[mb], abs=0.0, bound=t3_bound), t3_launches, lib_ms)
                for mb in thp.BLOCK_MIB]
    kernels += [tool(f"attn_form (form {form}, n={n_t1})", "attn_forms.cu", "exp_attn_forms.py:86",
                     t1[form], p_launches[form]) for form in taf.FORMS]
    kernels += [tool(f"{name}_variant (I={h4[0]}, O={h4[1]}; library: "
                     "torch._weight_int4pack_mm, K4's grouped function on the same words)",
                     "int4_repack.cu",
                     "exp_int4_repack.py:72" if name == "mxu" else "exp_int4_repack.py:113",
                     t4[(name,) + h4], p_launches[name], t4_lib_ms) for name in ("mxu", "plane")]
    kernels += [tool("kv_append (L 28, B 32, T 256)", "kv_append.cu", "exp_kv_append.py:90", t5,
                     p_launches["kv_append"], t5_lib_ms),
                tool(f"cpk probe p2 (s8 x s8 -> s32 dot, 1024 x 2048; library: "
                     f"{r2['p2']['library']})", "cpk_probes.cu", "exp_cpk.py:51", t2_gemv["p2"],
                     p_launches["p2"], r2["p2"]["library_us"] / 1e3),
                tool(f"cpk probe p6 (int8 -> bf16 convert and dot, 1024 x 3072; library: "
                     f"{r2['p6']['library']})", "cpk_probes.cu", "exp_cpk.py:139", t2_gemv["p6"],
                     p_launches["p6"], r2["p6"]["library_us"] / 1e3),
                tool(f"cpk probes (p1, p3-p5, p3a-c, p4a-c; one launch each; ms: the ten "
                     f"together; floor: an empty kernel queued, {t2_floor_ms:.6f} ms)",
                     "cpk_probes.cu", "exp_cpk.py:39", t2_all, p_launches["probes"])]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
