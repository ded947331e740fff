"""Batched autoregressive generation: B utterances in one lockstep decode
(port of qwen3tts_tpu/models/batch_generate.py).

Single-token decode reads the same weights for every sequence, so one
weight stream serves the whole batch: K1 and K2 take all B rows in one call
each per frame, and the frame time grows far more slowly than B.

All sequences advance in lockstep. Each has its own prompt length,
trailing-text stream, repetition-penalty set, EOS state and frame counter;
finished sequences keep "running" with frozen state (their samples are
discarded) until every sequence is done or at its step cap. Shapes stay
static: no compaction of the batch. Prompts are right-padded to a shared
bucket; each sequence's positions come from its own length, and pad slots
past it are masked or overwritten by its decode steps.

The loop runs on the host in eager PyTorch and reads the device back once
per lockstep frame (whether any sequence is still active). The per-row
counters (``steps``, ``frames``, ``offsets``, ``done``) stay on the device.

On CUDA the lockstep decode runs through the kernels only: it raises unless
K1 and K2 both take the batch (a fused layout, int8 or dense bf16, or for
the CP unfused int8, and 1..MAX_BATCH (256) rows; ``Qwen3TTSModel.generate_batch``
splits longer lists into such groups), or the trees are packed
(``from_pretrained(keep_packed=True)``). Both kernels run in the matmul mode
that QWEN3TTS_TK_MODE and QWEN3TTS_CPK_MODE select (``generate.py``). A
packed tree decodes as the JAX package decodes one, through the plain
lockstep (``forward_batched_step``, ``codec_logits``, ``_sample_batch``,
``code_predictor.predict_codes``) at 1..MAX_BATCH rows, with every packed
matmul on a kernel (``talker._dense``: K4 at one row, ``quant_gemm`` at
more) and K1 and K2 launched never.
Every lockstep frame after the first runs K1 in sample mode
(``talker.forward_batched_step_sample``), and every frame K2
(``ops/cp_kernel.py``) once for all rows, at any ``top_p`` and
``ref_exact_top_p``: both kernels' sampler has the top-p stage, which the
TPU kernels lacked (the TPU sent top_p < 1 to XLA). Row b of K1 and K2
draws from its own streams of the counter generator (16 b + 0 for code 0,
16 b + j for codebook j), from the per-frame seed words of
``generate._frame_seeds``.

Per-request sampling (``sampling.per_request``, serving): the calls take a
``samp_vec`` [B, 4] host table (``samp_row`` [1, 4] for an admission) of
each row's temperature, top_k, top_p and repetition_penalty. Each call
turns it into the kernels' per-row values once (``decode_blocks.samp_rows``,
one upload a call, not a frame); K1 and K2 read them at B > 1 and take row
0's as their scalars at B = 1, and the plain samplers take the table
(``ops/sampling.py::sample_token_vec``). The kernels stay on, where the TPU
turned both off in this mode.

``prefill_start_batch``, each ``generate_chunk_batch`` call and
``admit_slot`` run in their device's turn (``generate.device_turn``): a
one-row group or an admission launches the persistent B = 1 forms of K1
and K2, whose workspace, barrier words and fault flags are one per device,
so they must not be in flight beside another thread's decode; the turn's
end reads the fault flags on the thread whose launch had the fault.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CodePredictorConfig, TalkerConfig
from ..ops.decode_blocks import samp_rows
from ..ops.rope import mrope_cos_sin
from ..ops.sampling import sample_token_inner, sample_token_vec
from . import code_predictor as cp
from . import talker as tk
from ..parallel.mesh import tree_mesh
from .generate import (
    _code0_mask, _cpk_mode, _frame_seeds, _use_cp_kernel, _use_talker_sample_kernel,
    check_cp_frames, device_turn, turn_devices,
)


class BatchCarry(NamedTuple):
    step: int  # lockstep iteration counter (chunk bound)
    steps: torch.Tensor  # [B] int32: per-sequence decode steps taken
    frames: torch.Tensor  # [B] int32: frames recorded per sequence
    done: torch.Tensor  # [B] bool
    cur_input: torch.Tensor  # [B, 1, h]
    cache: tk.KVCache | tk.KVCacheQ  # [L, B, Hkv, T, D]
    offsets: torch.Tensor  # [B] int32: per-sequence cache length
    seen: torch.Tensor  # [B, vocab] bool
    codes: torch.Tensor  # [B, max_frames, 16] int32
    tokens: torch.Tensor  # [B, max_frames] int32
    generator: torch.Generator  # noise of the plain sampler
    seed_words: tuple[int, int]  # seed words of the kernels' counter generator


class BatchResult(NamedTuple):
    codes: torch.Tensor  # [B, max_frames, 16]
    n_frames: torch.Tensor  # [B] int32
    tokens: torch.Tensor  # [B, max_frames]


def kernels_take(talker_params, cp_params, talker_cfg, cp_cfg, batch: int, kv_quant: bool) -> bool:
    """Whether the lockstep decode of ``batch`` rows runs only kernels on the
    card: K1 and K2 take it (the talker in a fused layout, int8 or dense
    bf16, the CP fused or, in int8, unfused, with its projection where it is
    narrower than the talker), or the trees are packed
    (``packed_take``); at most MAX_BATCH rows either way."""
    from ..ops.cp_kernel import kernel_supported
    from ..ops.talker_kernel import step_supported

    return (step_supported(talker_params, talker_cfg, batch, kv_quant) and kernel_supported(
        cp_params, cp_cfg, talker_cfg.hidden_size, batch
    )) or packed_take(talker_params, cp_params, batch)


def packed_take(talker_params, cp_params, batch: int) -> bool:
    """Whether the plain lockstep of ``batch`` (1..MAX_BATCH) rows on these
    trees runs a kernel at every matmul: each matmul leaf of the talker and
    the CP (the layers, ``codec_head``, ``lm_head``, the CP's projection if
    there is one) a ``PackedLinear`` that K4 and ``quant_gemm`` take, and a
    packed text projection taken too (a dense one serves only the prompt)."""
    from ..ops.quant import _INT8_LAYER_KEYS, PackedLinear, packed_supported
    from ..ops.talker_kernel import MAX_BATCH

    leaves = [p["layers"][k] for p in (talker_params, cp_params) for k in _INT8_LAYER_KEYS
              if k in p["layers"]]
    leaves += [talker_params.get("codec_head"), cp_params.get("lm_head")]
    if "small_to_mtp_projection" in cp_params:
        leaves.append(cp_params["small_to_mtp_projection"]["w"])
    text = talker_params.get("text_projection", {})
    leaves += [fc["w"] for fc in text.values() if isinstance(fc["w"], PackedLinear)]
    return 1 <= batch <= MAX_BATCH and all(packed_supported(w) for w in leaves)


def _require_kernels(talker_params, cp_params, talker_cfg, cp_cfg, device, batch, kv_quant):
    """On CUDA, raise unless ``kernels_take`` the batch: the lockstep decode
    never runs a plain matmul on the card. A tensor-parallel tree (a
    ``mesh=`` model) runs the plain per-position step, as the JAX mesh runs
    XLA: that is its path, not a fallback."""
    from ..ops.talker_kernel import MAX_BATCH

    if device.type == "cuda" and tree_mesh(talker_params) is None and not kernels_take(
        talker_params, cp_params, talker_cfg, cp_cfg, batch, kv_quant
    ):
        raise ValueError(
            f"lockstep decode of {batch} rows: on CUDA it runs through K1 and K2, which take "
            f"1..{MAX_BATCH} rows of a fused layout: int8 (from_pretrained(quantize='int8')) "
            f"or dense bf16 (an unquantized checkpoint loaded as bf16); K2 also unfused int8; "
            f"or, on packed MLX weights (from_pretrained(keep_packed=True), every matmul "
            f"packed), through K4 and quant_gemm at 1..{MAX_BATCH} rows"
        )


def _rows(sampling, samp_vec, batch: int, device):
    """The per-row sampling values of one call (``decode_blocks.SampRows``)
    under ``sampling.per_request``, uploaded to ``device`` once; None in the
    scalar mode, where ``samp_vec`` is not read (as the JAX package)."""
    if not sampling.per_request:
        return None
    if samp_vec is None:
        raise ValueError("sampling.per_request requires a samp_vec [B, 4] argument "
                         "(temperature, top_k, top_p, repetition_penalty per slot)")
    rows = samp_rows(samp_vec, device)
    if rows.vec.shape[0] != batch:
        raise ValueError(f"samp_vec has {rows.vec.shape[0]} rows for a batch of {batch}")
    return rows


def _sample_batch(generator, logits, sampling, seen, suppress_mask, eos_id, samp_vec=None):
    """The batch-general plain sampler: logits [B, V] -> tokens [B]
    (``suppress_mask`` from ``generate._code0_mask``, which holds EOS under
    ``forbid_eos``). ``samp_vec`` ([B, 4]: temperature, top_k, top_p,
    repetition_penalty) switches to the per-row sampler."""
    eos = None if sampling.forbid_eos else eos_id
    if samp_vec is not None:
        return sample_token_vec(
            generator, logits, temperature=samp_vec[:, 0], top_k=samp_vec[:, 1],
            top_p=samp_vec[:, 2], repetition_penalty=samp_vec[:, 3], seen=seen,
            suppress_mask=suppress_mask, eos_token_id=eos,
            ref_exact_top_p=sampling.ref_exact_top_p,
        )
    return sample_token_inner(
        generator, logits,
        temperature=sampling.temperature, top_k=sampling.top_k, top_p=sampling.top_p,
        ref_exact_top_p=sampling.ref_exact_top_p,
        repetition_penalty=sampling.repetition_penalty, seen=seen,
        suppress_mask=suppress_mask, eos_token_id=eos,
    )


def _frame_batch(
    talker_params, cp_params, talker_cfg, cp_cfg, sampling, suppress_mask,
    hidden_last, logits_last, seen, generator, cp_seed: tuple[int, int], code0=None,
    rows=None,
):
    """Sample codebook 0 for every sequence (unless K1 did) and run the code
    predictor for all of them (finished ones give discarded values);
    ``rows``: the per-row sampling values (``_rows``) or None.

    Returns (code0 [B], rest [B, 15], is_eos [B], seen, codec_sum), with
    ``codec_sum`` the summed 16-codebook embedding ([B, h] f32) when K2 ran,
    else None. Makes no host synchronisation beyond the upload of a
    per-row table to the plain sampler."""
    eos_id = talker_cfg.codec_eos_token_id
    vec = None if rows is None else rows.vec
    if code0 is None:
        code0 = _sample_batch(generator, logits_last, sampling, seen, suppress_mask, eos_id,
                              samp_vec=vec)
    B = code0.shape[0]
    dev = code0.device
    seen = seen.scatter(1, code0.long()[:, None], True)
    is_eos = code0 == eos_id
    code0_cp = torch.where(is_eos, 0, code0)
    if _use_cp_kernel(cp_params, cp_cfg, talker_cfg, sampling, dev, batch=B):
        from ..ops.cp_kernel import predict_codes_fused

        rest, esum = predict_codes_fused(
            cp_params, cp_cfg, talker_params, hidden_last, code0_cp, cp_seed,
            temperature=sampling.temperature, top_k=sampling.top_k, top_p=sampling.top_p,
            ref_exact_top_p=sampling.ref_exact_top_p, mode=_cpk_mode(cp_params), rows=rows,
        )
        codec_sum = tk.embed_codec(talker_params, code0).float() + esum
        return code0, rest, is_eos, seen, codec_sum
    rest = cp.predict_codes(
        cp_params, cp_cfg, talker_params, hidden_last, code0_cp, generator,
        temperature=sampling.temperature, top_k=sampling.top_k, top_p=sampling.top_p,
        ref_exact_top_p=sampling.ref_exact_top_p, samp_vec=vec,
    )
    return code0, rest, is_eos, seen, None


def _next_input_batch(
    cp_params, talker_params, trailing, trailing_lens, tts_pad, steps, code0, rest,
    codec_sum=None,
):
    """Per-sequence next input: trailing[b, steps[b]] (or pad) + the summed
    codec embedding. trailing [B, T_trail, h]; trailing_lens, steps [B]."""
    B = code0.shape[0]
    idx = torch.clamp(steps, max=trailing.shape[1] - 1).long()
    text_rows = trailing[torch.arange(B, device=trailing.device), idx]  # [B, h]
    text = torch.where((steps < trailing_lens)[:, None], text_rows, tts_pad[None])
    if codec_sum is None:
        codec_sum = cp.sum_codec_embeddings(cp_params, talker_params, code0, rest)
    return (text + codec_sum.to(text.dtype))[:, None]  # [B, 1, h]


def _seed_words(seed: int, device) -> tuple[torch.Generator, tuple[int, int]]:
    """A generator seeded by ``seed`` and the two seed words drawn from it
    first (``generate.prefill_start``'s scheme)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    words = torch.randint(0, 2**32, (2,), generator=generator, device=device, dtype=torch.int64)
    return generator, tuple(int(w) for w in words.tolist())


def _first_row(code0, rest, is_eos, max_frames: int):
    """codes [B, max_frames, 16] and tokens [B, max_frames] holding frame 0."""
    B = code0.shape[0]
    codes = torch.zeros(B, max_frames, rest.shape[1] + 1, dtype=torch.int32, device=code0.device)
    tokens = torch.zeros(B, max_frames, dtype=torch.int32, device=code0.device)
    row = torch.cat([code0[:, None], rest.to(torch.int32)], dim=1)
    codes[:, 0] = torch.where(is_eos[:, None], 0, row)
    tokens[:, 0] = torch.where(is_eos, -1, code0)
    return codes, tokens


def prefill_start_batch(
    talker_params,
    cp_params,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    sampling,
    prefill_embeds: torch.Tensor,  # [B, P_bucket, h] right-padded per sequence
    prefill_lens: torch.Tensor,  # [B] int
    trailing_embeds: torch.Tensor,  # [B, T_trail, h]
    trailing_lens: torch.Tensor,  # [B] int
    tts_pad_embed: torch.Tensor,  # [h]
    cache,
    max_frames: int,
    seed: int,
    samp_vec=None,  # [B, 4] (sampling.per_request)
) -> BatchCarry:
    """Prefill every prompt in one batched pass and sample each first frame,
    in the device's turn."""
    B = prefill_embeds.shape[0]
    dev = prefill_embeds.device
    _require_kernels(talker_params, cp_params, talker_cfg, cp_cfg, dev, B, cache.quantized)
    with device_turn(turn_devices(talker_params, dev)):
        rows = _rows(sampling, samp_vec, B, dev)
        generator, seed_words = _seed_words(seed, dev)
        prefill_lens = prefill_lens.to(device=dev, dtype=torch.int32)
        suppress_mask = _code0_mask(talker_cfg, sampling, dev)
        hidden, cache = tk.forward(talker_params, talker_cfg, prefill_embeds, cache, 0)
        last = hidden[torch.arange(B, device=dev), prefill_lens.long() - 1]  # [B, h]
        logits_last = tk.codec_logits(talker_params, last[:, None])[:, 0]
        _, cp_seed = _frame_seeds(seed_words, 0)
        code0, rest, is_eos, seen, codec_sum = _frame_batch(
            talker_params, cp_params, talker_cfg, cp_cfg, sampling, suppress_mask, last,
            logits_last, torch.zeros(B, talker_cfg.vocab_size, dtype=torch.bool, device=dev),
            generator, cp_seed, rows=rows,
        )
        codes, tokens = _first_row(code0, rest, is_eos, max_frames)
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        return BatchCarry(
            step=1,
            steps=zeros + 1,
            frames=torch.where(is_eos, 0, 1).to(torch.int32),
            done=is_eos,
            cur_input=_next_input_batch(
                cp_params, talker_params, trailing_embeds, trailing_lens.to(dev), tts_pad_embed,
                zeros, code0, rest, codec_sum,
            ),
            cache=cache,
            offsets=prefill_lens.clone(),
            seen=seen,
            codes=codes,
            tokens=tokens,
            generator=generator,
            seed_words=seed_words,
        )


def generate_chunk_batch(
    talker_params,
    cp_params,
    carry: BatchCarry,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    sampling,
    trailing_embeds: torch.Tensor,
    trailing_lens: torch.Tensor,
    tts_pad_embed: torch.Tensor,
    max_steps: torch.Tensor,  # [B] per-sequence caps (<= max_frames)
    until_step: int,  # lockstep bound for this chunk
    samp_vec=None,  # [B, 4] (sampling.per_request)
) -> BatchCarry:
    """Advance every sequence in lockstep while any is active and
    ``carry.step < until_step``, in the device's turn. The codes and tokens
    buffers of the carry are updated in place."""
    dev = carry.cur_input.device
    B = trailing_embeds.shape[0]
    _require_kernels(talker_params, cp_params, talker_cfg, cp_cfg, dev, B, carry.cache.quantized)
    with device_turn(turn_devices(talker_params, dev)):
        return _chunk(talker_params, cp_params, carry, talker_cfg, cp_cfg, sampling,
                      trailing_embeds, trailing_lens, tts_pad_embed, max_steps, until_step,
                      _rows(sampling, samp_vec, B, dev))


def _chunk(talker_params, cp_params, carry, talker_cfg, cp_cfg, sampling, trailing_embeds,
           trailing_lens, tts_pad_embed, max_steps, until_step, rows):
    """``generate_chunk_batch``'s loop (inside the turn)."""
    dev = carry.cur_input.device
    B = trailing_embeds.shape[0]
    rows_b = torch.arange(B, device=dev)
    max_steps = max_steps.to(device=dev, dtype=torch.int32)
    trailing_lens = trailing_lens.to(dev)
    suppress_mask = _code0_mask(talker_cfg, sampling, dev)
    eos_id = talker_cfg.codec_eos_token_id
    max_frames = carry.codes.shape[1]
    use_tks = _use_talker_sample_kernel(
        talker_params, talker_cfg, sampling, dev, B, carry.cache.quantized
    )
    if use_tks:
        suppress_add = torch.zeros(talker_cfg.vocab_size, device=dev).masked_fill_(
            suppress_mask, -1e30
        )
        rope = mrope_cos_sin(
            torch.arange(carry.cache.max_len, device=dev)[None], talker_cfg.head_dim,
            talker_cfg.rope_theta, talker_cfg.mrope_section, torch.bfloat16,
        )
        rope = (rope[0][0], rope[1][0])

    c = carry
    while c.step < until_step:
        active = ~c.done & (c.steps < max_steps)
        if not bool(active.any()):  # the frame's one host synchronisation
            break
        check_cp_frames(dev)  # the last frame's K2 ran before that read
        seed_tok, cp_seed = _frame_seeds(c.seed_words, c.step)
        if use_tks:
            hidden, cache, code0 = tk.forward_batched_step_sample(
                talker_params, talker_cfg, c.cur_input, c.cache, c.offsets,
                seen=c.seen, suppress_add=suppress_add, seed=seed_tok,
                temperature=sampling.temperature, top_k=sampling.top_k,
                repetition_penalty=sampling.repetition_penalty,
                eos_token_id=None if sampling.forbid_eos else eos_id,
                rope=rope, top_p=sampling.top_p, ref_exact_top_p=sampling.ref_exact_top_p,
                rows=rows,
            )
            code0, rest, is_eos, seen, codec_sum = _frame_batch(
                talker_params, cp_params, talker_cfg, cp_cfg, sampling, suppress_mask,
                hidden[:, 0], None, c.seen, c.generator, cp_seed, code0=code0, rows=rows,
            )
        else:
            hidden, cache = tk.forward_batched_step(
                talker_params, talker_cfg, c.cur_input, c.cache, c.offsets
            )
            logits_last = tk.codec_logits(talker_params, hidden)[:, 0]
            code0, rest, is_eos, seen, codec_sum = _frame_batch(
                talker_params, cp_params, talker_cfg, cp_cfg, sampling, suppress_mask,
                hidden[:, 0], logits_last, c.seen, c.generator, cp_seed, rows=rows,
            )
        # a sequence records this frame iff it was active and did not hit EOS
        record = active & ~is_eos
        at = torch.clamp(c.steps, max=max_frames - 1).long()
        row = torch.cat([code0[:, None], rest.to(torch.int32)], dim=1)
        c.codes[rows_b, at] = torch.where(record[:, None], row, c.codes[rows_b, at])
        # the token stream's sentinel matches the single path: -1 marks EOS
        c.tokens[rows_b, at] = torch.where(active, torch.where(is_eos, -1, code0),
                                           c.tokens[rows_b, at])
        steps = c.steps + active.to(torch.int32)
        c = c._replace(
            step=c.step + 1,
            steps=steps,
            frames=c.frames + record.to(torch.int32),
            done=c.done | (active & is_eos) | (steps >= max_steps),
            cur_input=_next_input_batch(
                cp_params, talker_params, trailing_embeds, trailing_lens, tts_pad_embed,
                c.steps, code0, rest, codec_sum,
            ),
            cache=cache,
            offsets=c.offsets + active.to(torch.int32),
            seen=torch.where(record[:, None], seen, c.seen),
        )
    return c


def admit_slot(
    talker_params,
    cp_params,
    carry: BatchCarry,
    trailing_all: torch.Tensor,  # [B, T_trail, h] per-slot trailing buffers
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    sampling,
    slot: int,  # the slot to (re)fill
    prefill_embeds: torch.Tensor,  # [1, P_bucket, h] right-padded
    prefill_len: int,
    trailing_row: torch.Tensor,  # [T_trail, h] (padded to the shared bucket)
    trailing_len: int,
    tts_pad_embed: torch.Tensor,  # [h]
    seed: int,
    samp_row=None,  # [1, 4] (sampling.per_request)
) -> tuple[BatchCarry, torch.Tensor]:
    """Admit a new request into a finished slot between decode chunks, in
    the device's turn.

    Prefills the prompt as one sequence into a scratch cache, copies its
    rows (and row scales, for an int8 cache) into the batch cache at
    ``slot``, samples its first frame from a generator seeded by ``seed``
    (with ``samp_row``'s values under ``sampling.per_request``), and resets
    every per-slot field. The other slots are untouched and resume where
    they were on the next ``generate_chunk_batch`` call. The carry's tensors
    and ``trailing_all`` are updated in place."""
    dev = prefill_embeds.device
    _require_kernels(talker_params, cp_params, talker_cfg, cp_cfg, dev, carry.codes.shape[0],
                     carry.cache.quantized)
    with device_turn(turn_devices(talker_params, dev)):
        rows = _rows(sampling, samp_row, 1, dev)
        vocab = talker_cfg.vocab_size
        suppress_mask = _code0_mask(talker_cfg, sampling, dev)
        scratch = tk.cache_scratch(carry.cache)
        hidden, scratch = tk.forward(talker_params, talker_cfg, prefill_embeds, scratch, 0)
        tk.put_cache_slot(carry.cache, slot, scratch)
        last = hidden[:, prefill_len - 1]
        logits = tk.codec_logits(talker_params, last[:, None])[:, 0]
        generator, seed_words = _seed_words(seed, dev)
        _, cp_seed = _frame_seeds(seed_words, 0)
        code0, rest, is_eos, seen1, codec_sum = _frame_batch(
            talker_params, cp_params, talker_cfg, cp_cfg, sampling, suppress_mask, last, logits,
            torch.zeros(1, vocab, dtype=torch.bool, device=dev), generator, cp_seed, rows=rows,
        )
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        next_in = _next_input_batch(
            cp_params, talker_params, trailing_row[None], zero + trailing_len, tts_pad_embed,
            zero, code0, rest, codec_sum,
        )
        codes, tokens = _first_row(code0, rest, is_eos, carry.codes.shape[1])
        carry.steps[slot] = 1
        carry.frames[slot] = torch.where(is_eos, 0, 1)[0]
        carry.done[slot] = is_eos[0]
        carry.cur_input[slot] = next_in[0]
        carry.offsets[slot] = prefill_len
        carry.seen[slot] = seen1[0]
        carry.codes[slot] = codes[0]
        carry.tokens[slot] = tokens[0]
        trailing_all[slot] = trailing_row.to(trailing_all.dtype)
        return carry, trailing_all


def generate_codes_batch(
    talker_params,
    cp_params,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    sampling,
    prefill_embeds,
    prefill_lens,
    trailing_embeds,
    trailing_lens,
    tts_pad_embed,
    cache,
    max_steps,  # [B]
    max_frames: int,
    seed: int,
    samp_vec=None,  # [B, 4] (sampling.per_request)
) -> BatchResult:
    """Prefill and the whole lockstep loop for B utterances: two turns on
    the device, the second's end reading the last frame's fault flags."""
    dev = prefill_embeds.device
    prefill_lens = torch.as_tensor(prefill_lens, dtype=torch.int32, device=dev)
    trailing_lens = torch.as_tensor(trailing_lens, dtype=torch.int32, device=dev)
    common = dict(talker_cfg=talker_cfg, cp_cfg=cp_cfg, sampling=sampling, samp_vec=samp_vec)
    carry = prefill_start_batch(
        talker_params, cp_params, **common, prefill_embeds=prefill_embeds,
        prefill_lens=prefill_lens, trailing_embeds=trailing_embeds, trailing_lens=trailing_lens,
        tts_pad_embed=tts_pad_embed, cache=cache, max_frames=max_frames, seed=seed,
    )
    carry = generate_chunk_batch(
        talker_params, cp_params, carry, **common, trailing_embeds=trailing_embeds,
        trailing_lens=trailing_lens, tts_pad_embed=tts_pad_embed,
        max_steps=torch.as_tensor(max_steps, dtype=torch.int32, device=dev),
        until_step=max_frames,
    )
    return BatchResult(codes=carry.codes, n_frames=carry.frames, tokens=carry.tokens)
