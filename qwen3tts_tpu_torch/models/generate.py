"""The autoregressive generation loop (port of qwen3tts_tpu/models/generate.py).

* ``prefill_start``  — process the (bucketed, right-padded) prompt, sample
  the first frame, return a resumable :class:`GenCarry`.
* ``generate_chunk`` — advance the carry frame by frame up to a step limit.
* ``generate_codes`` — prefill plus the whole loop for one utterance.

Shapes stay static: prompts right-padded to buckets, codes in a
preallocated [max_frames, 16] buffer, the trailing text stream a padded
buffer indexed by the step counter, a fixed-size KV cache. The loop runs on
the host in eager PyTorch; each frame reads its code0 back once (one host
synchronisation per frame) to decide EOS.

EOS contract (as the reference's): the EOS frame records token -1 and a zero
codes row, generation stops, and ``n_frames`` counts the frames before EOS.

On CUDA, with fused weights, every frame after the first runs the talker
step through K1 (ops/talker_kernel.py) and every frame runs the code
predictor through K2 (ops/cp_kernel.py), at any sampling setting: both
kernels' sampler has the top-p stage (``top_p`` and ``ref_exact_top_p``)
that the TPU kernels lacked (the TPU sent top_p < 1 to XLA). Fused means
either layout of ``talker_kernel._layout``: int8 (``quantize='int8'``) or
dense bf16 (an unquantized checkpoint loaded as bf16); K2 also takes an
unfused int8 code predictor and the small-to-MTP projection of the 1.7B
model. The JAX
package's switches pick the kernels' matmul mode on int8 weights:
QWEN3TTS_TK_MODE (K1, ``talker._kernel_mode``) and QWEN3TTS_CPK_MODE (K2,
``_cpk_mode``), ``wo_bf16`` unless set to ``dyn_int8``. Otherwise the plain
path runs (talker.forward + codec_logits + the sampler, cp.predict_codes),
in which a fused talker step on CUDA is still K1, in its non-sample mode.
The cache is bf16 or int8 (``kv_quant``); K1 takes both.

``prefill_start`` and ``generate_chunk`` each run in their device's turn
(``device_turn``): decodes on several host threads take turns on one card,
a prefill or a chunk at a time.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch

from ..config import CodePredictorConfig, TalkerConfig
from ..ops.rope import mrope_cos_sin
from ..ops.sampling import build_suppress_mask, sample_token_inner
from . import code_predictor as cp
from . import talker as tk

MASK32 = 0xFFFFFFFF


class SamplingConfig(NamedTuple):
    """Sampling hyper-parameters.

    ``forbid_eos`` suppresses EOS entirely (benchmarking: forces generation
    to the step cap regardless of weights). ``ref_exact_top_p`` reproduces
    the reference's unnormalized-exp top-p. ``per_request`` (serving): the
    batched paths take a ``samp_vec`` [B, 4] table (temperature, top_k,
    top_p, repetition_penalty per row) and sample each row with its own
    values; the scalar fields are the defaults of rows that override
    nothing. Unlike the TPU's, K1 and K2 stay on in this mode: their
    sampler reads the rows (``decode_blocks.SampRows``).
    """

    temperature: float = 0.9
    top_k: int = 50
    top_p: float = 1.0
    repetition_penalty: float = 1.05
    forbid_eos: bool = False
    ref_exact_top_p: bool = False
    per_request: bool = False


class GenCarry(NamedTuple):
    """Resumable generation state."""

    step: int  # frames completed
    eos: bool  # EOS sampled
    cur_input: torch.Tensor  # [1, 1, h] next talker input
    cache: tk.KVCache | tk.KVCacheQ
    offset: int  # valid cache length
    seen: torch.Tensor  # [vocab] bool, repetition-penalty set
    codes: torch.Tensor  # [max_frames, 16] int32
    tokens: torch.Tensor  # [max_frames] int32 first-codebook tokens
    generator: torch.Generator  # noise of the plain sampler
    seed_words: tuple[int, int]  # seed words of the kernels' counter generator


class GenResult(NamedTuple):
    codes: torch.Tensor  # [max_frames, 16] int32 (rows >= n_frames are zero)
    n_frames: int  # frames generated before EOS/cap
    tokens: torch.Tensor  # [max_frames] int32


def _fused_ok(sampling: SamplingConfig, device: torch.device) -> bool:
    """The kernels run on CUDA tensors, at any ``sampling`` (the top-p stage
    and ``ref_exact_top_p`` included)."""
    return device.type == "cuda"


def _use_cp_kernel(cp_params, cp_cfg, talker_cfg, sampling, device, batch: int = 1) -> bool:
    """Gate for K2: CUDA tensors, int8 (fused or unfused) or fused bf16
    layers (with the projection where the CP is narrower than the talker),
    1..64 rows, any ``top_p`` and ``ref_exact_top_p`` (``_fused_ok``)."""
    from ..ops.cp_kernel import kernel_supported

    return _fused_ok(sampling, device) and kernel_supported(
        cp_params, cp_cfg, talker_cfg.hidden_size, batch
    )


def _cpk_mode(cp_params) -> str:
    """K2's matmul mode: QWEN3TTS_CPK_MODE (``wo_bf16`` unless
    ``dyn_int8``; the JAX package's ``_cpk_mode``) for int8 layers, "bf16"
    for dense ones, as ``talker._kernel_mode`` does for K1."""
    from ..ops.cp_kernel import cp_layout

    mode = tk.env_mode("QWEN3TTS_CPK_MODE")
    return mode if cp_layout(cp_params["layers"]) == "int8" else "bf16"


def check_cp_frames(device, sync: bool = False) -> None:
    """Raise ``BarrierTimeout`` if a persistent B = 1 launch that ran before
    the last host synchronisation (with ``sync``: before now) had a grid
    barrier time out: a frame of K2 (its codes are -1) or a step of K1 (its
    code0 -1, its hidden NaN). Nothing to do off CUDA."""
    if device.type == "cuda":
        from ..ops import cp_kernel, talker_kernel

        if sync:
            torch.cuda.synchronize(device)
        cp_kernel.check_barrier()
        talker_kernel.check_barrier()


_TURNS: dict = {}  # one lock for each CUDA device's index


@contextlib.contextmanager
def device_turn(device: torch.device):
    """Hold ``device``'s turn: one B = 1 prefill or chunk at a time on a
    card, across host threads.

    The persistent B = 1 launches keep one workspace, one set of barrier
    words and one fault flag for each device (ops/talker_kernel.py,
    ops/cp_kernel.py), and K3 one set of merge counters, so two decodes must
    not have that work in flight on one device at once, whichever CUDA
    streams they run on. A turn ends once the caller's current stream has
    finished its work and the fault flags have been read
    (``check_cp_frames``): another thread's decode then finds the device
    idle, and a fault raises on the thread whose launch had it. Off CUDA
    nothing is held."""
    if device.type != "cuda":
        yield
        return
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _TURNS.setdefault(index, threading.Lock()):
        try:
            yield
        finally:
            torch.cuda.current_stream(device).synchronize()
        check_cp_frames(device)


def _use_talker_sample_kernel(
    talker_params, talker_cfg, sampling, device, batch: int = 1, kv_quant: bool = False
) -> bool:
    """Gate for K1 in sample mode: CUDA tensors, fused weights and a head of
    int8 or dense bf16, 1..64 rows, a bf16 or an int8 cache, any ``top_p``
    and ``ref_exact_top_p`` (``_fused_ok``)."""
    from ..ops.talker_kernel import step_supported

    return _fused_ok(sampling, device) and step_supported(
        talker_params, talker_cfg, batch, kv_quant
    )


def _frame_seeds(seed_words: tuple[int, int], step: int):
    """Per-frame seed words of the talker sampler and of the CP, by counter
    mixing with distinct odd constants (generate.py's cheap-seed scheme)."""
    s0, s1 = seed_words
    tok = ((s0 + step * 0x9E3779B9) & MASK32, (s1 ^ (step * 0x85EBCA6B)) & MASK32)
    cpw = ((s0 ^ (step * 0xC2B2AE3D)) & MASK32, (s1 + step * 668265263) & MASK32)
    return tok, cpw


def _code0_mask(talker_cfg: TalkerConfig, sampling: SamplingConfig, device) -> torch.Tensor:
    """Code 0's suppress mask, bool [vocab]: the special ids but EOS, and EOS
    too under ``forbid_eos``. Built on the host and copied once: setting an
    element of a CUDA tensor from Python synchronises the host."""
    eos_id = talker_cfg.codec_eos_token_id
    mask = build_suppress_mask(talker_cfg.vocab_size, eos_id)
    if sampling.forbid_eos:
        mask[eos_id] = True
    return mask.to(device)


def _frame(
    talker_params,
    cp_params,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    sampling: SamplingConfig,
    suppress_mask,  # bool [vocab], from _code0_mask
    hidden_last,  # [1, h] talker hidden at the sampled position
    logits_last,  # [1, vocab] f32 (None when ``code0`` is given)
    seen,  # [vocab] bool
    generator,
    cp_seed: tuple[int, int],
    code0=None,  # [1] int32, already sampled in K1
):
    """Sample codebook 0 (unless given) and run the code predictor.

    Returns (code0 [1], rest [1, 15], is_eos, seen, codec_sum). ``codec_sum``
    is the summed 16-codebook embedding ([1, h] f32) when K2 produced it, else
    None. Reads code0 back once (the frame's one host synchronisation)."""
    eos_id = talker_cfg.codec_eos_token_id
    if code0 is None:
        code0 = sample_token_inner(
            generator, logits_last,
            temperature=sampling.temperature, top_k=sampling.top_k, top_p=sampling.top_p,
            repetition_penalty=sampling.repetition_penalty, seen=seen,
            suppress_mask=suppress_mask,
            eos_token_id=None if sampling.forbid_eos else eos_id,
            ref_exact_top_p=sampling.ref_exact_top_p,
        )
    seen = seen.index_fill(0, code0.long(), True)
    is_eos = int(code0[0]) == eos_id
    dev = hidden_last.device
    check_cp_frames(dev)  # the last frame's K2 ran before that read
    n_rest = cp_cfg.num_code_groups - 1
    if is_eos:
        return code0, torch.zeros(1, n_rest, dtype=torch.int32, device=dev), True, seen, None
    if _use_cp_kernel(cp_params, cp_cfg, talker_cfg, sampling, dev):
        from ..ops.cp_kernel import predict_codes_fused

        rest, esum = predict_codes_fused(
            cp_params, cp_cfg, talker_params, hidden_last, code0, cp_seed,
            temperature=sampling.temperature, top_k=sampling.top_k, top_p=sampling.top_p,
            ref_exact_top_p=sampling.ref_exact_top_p, mode=_cpk_mode(cp_params),
        )
        csum = tk.embed_codec(talker_params, code0).float() + esum
        return code0, rest, False, seen, csum
    rest = cp.predict_codes(
        cp_params, cp_cfg, talker_params, hidden_last, code0, generator,
        temperature=sampling.temperature, top_k=sampling.top_k, top_p=sampling.top_p,
        ref_exact_top_p=sampling.ref_exact_top_p,
    )
    return code0, rest, False, seen, None


def _next_input(
    cp_params, talker_params, trailing_embeds, trailing_len: int, tts_pad_embed, step: int,
    code0, rest, codec_sum=None,
):
    """Trailing text (or pad) + the sum of all 16 codebook embeddings."""
    if step < trailing_len:
        text = trailing_embeds[min(step, trailing_embeds.shape[0] - 1)]
    else:
        text = tts_pad_embed
    if codec_sum is None:
        codec_sum = cp.sum_codec_embeddings(cp_params, talker_params, code0, rest)
    return (text[None] + codec_sum.to(text.dtype))[:, None]  # [1, 1, h]


def _record(codes, tokens, step: int, code0, rest, is_eos: bool):
    """Write frame ``step`` in place: its codes row (unless EOS) and token."""
    if is_eos:
        tokens[step] = -1
    else:
        codes[step, :1] = code0[:1]
        codes[step, 1:] = rest[0]
        tokens[step] = code0[0]
    return codes, tokens


def prefill_start(
    talker_params,
    cp_params,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    sampling: SamplingConfig,
    prefill_embeds: torch.Tensor,  # [1, P_bucket, h] right-padded
    prefill_len: int,  # real prompt tokens
    trailing_embeds: torch.Tensor,  # [T_trail, h]
    trailing_len: int,
    tts_pad_embed: torch.Tensor,  # [h]
    cache: tk.KVCache | tk.KVCacheQ,
    max_frames: int,
    seed: int,
) -> GenCarry:
    """Process the prompt and sample the first frame; returns a GenCarry.

    ``seed`` seeds one ``torch.Generator`` on the prompt's device: it gives
    the plain sampler its noise and, first, the two seed words of the
    kernels' counter generator."""
    dev = prefill_embeds.device
    with device_turn(dev):
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        words = torch.randint(0, 2**32, (2,), generator=generator, device=dev, dtype=torch.int64)
        seed_words = tuple(int(w) for w in words.tolist())
        vocab = talker_cfg.vocab_size
        suppress_mask = _code0_mask(talker_cfg, sampling, dev)
        codes = torch.zeros(max_frames, talker_cfg.num_code_groups, dtype=torch.int32, device=dev)
        tokens = torch.zeros(max_frames, dtype=torch.int32, device=dev)
        seen = torch.zeros(vocab, dtype=torch.bool, device=dev)

        hidden, cache = tk.forward(talker_params, talker_cfg, prefill_embeds, cache, 0)
        hidden_last = hidden[:, prefill_len - 1]
        logits_last = tk.codec_logits(talker_params, hidden_last[:, None])[:, 0]
        _, cp_seed = _frame_seeds(seed_words, 0)
        code0, rest, is_eos, seen, codec_sum = _frame(
            talker_params, cp_params, talker_cfg, cp_cfg, sampling, suppress_mask,
            hidden_last, logits_last, seen, generator, cp_seed,
        )
        codes, tokens = _record(codes, tokens, 0, code0, rest, is_eos)
        return GenCarry(
            step=0 if is_eos else 1,
            eos=is_eos,
            cur_input=_next_input(
                cp_params, talker_params, trailing_embeds, trailing_len, tts_pad_embed, 0,
                code0, rest, codec_sum,
            ),
            cache=cache,
            offset=prefill_len,
            seen=seen,
            codes=codes,
            tokens=tokens,
            generator=generator,
            seed_words=seed_words,
        )


def generate_chunk(
    talker_params,
    cp_params,
    carry: GenCarry,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    sampling: SamplingConfig,
    trailing_embeds: torch.Tensor,
    trailing_len: int,
    tts_pad_embed: torch.Tensor,
    until_step: int,  # run while step < until_step
) -> GenCarry:
    """Advance the generation by up to (until_step - carry.step) frames."""
    dev = carry.cur_input.device
    with device_turn(dev):
        suppress_mask = _code0_mask(talker_cfg, sampling, dev)
        limit = min(until_step, carry.codes.shape[0])
        eos_id = talker_cfg.codec_eos_token_id
        use_tks = _use_talker_sample_kernel(
            talker_params, talker_cfg, sampling, dev, kv_quant=carry.cache.quantized
        )
        if use_tks:
            suppress_add = torch.zeros(talker_cfg.vocab_size, device=dev).masked_fill_(
                suppress_mask, -1e30
            )
            T = carry.cache.max_len
            rope = mrope_cos_sin(
                torch.arange(T, device=dev)[None], talker_cfg.head_dim, talker_cfg.rope_theta,
                talker_cfg.mrope_section, torch.bfloat16,
            )
            rope = (rope[0][0], rope[1][0])

        c = carry
        while not c.eos and c.step < limit:
            seed_tok, cp_seed = _frame_seeds(c.seed_words, c.step)
            if use_tks:
                hidden_last, cache, code0 = tk.forward_step_sample(
                    talker_params, talker_cfg, c.cur_input, c.cache, c.offset,
                    seen=c.seen, suppress_add=suppress_add, seed=seed_tok,
                    temperature=sampling.temperature, top_k=sampling.top_k,
                    repetition_penalty=sampling.repetition_penalty,
                    eos_token_id=None if sampling.forbid_eos else eos_id,
                    rope=rope, top_p=sampling.top_p, ref_exact_top_p=sampling.ref_exact_top_p,
                )
                code0, rest, is_eos, seen, codec_sum = _frame(
                    talker_params, cp_params, talker_cfg, cp_cfg, sampling, suppress_mask,
                    hidden_last[:, 0], None, c.seen, c.generator, cp_seed, code0=code0,
                )
            else:
                hidden, cache = tk.forward(
                    talker_params, talker_cfg, c.cur_input, c.cache, c.offset
                )
                logits_last = tk.codec_logits(talker_params, hidden)[:, 0]
                code0, rest, is_eos, seen, codec_sum = _frame(
                    talker_params, cp_params, talker_cfg, cp_cfg, sampling, suppress_mask,
                    hidden[:, 0], logits_last, c.seen, c.generator, cp_seed,
                )
            codes, tokens = _record(c.codes, c.tokens, c.step, code0, rest, is_eos)
            c = c._replace(
                step=c.step + (0 if is_eos else 1),
                eos=is_eos,
                cur_input=_next_input(
                    cp_params, talker_params, trailing_embeds, trailing_len, tts_pad_embed,
                    c.step, code0, rest, codec_sum,
                ),
                cache=cache,
                offset=c.offset + 1,
                seen=seen,
                codes=codes,
                tokens=tokens,
            )
        return c


def generate_codes(
    talker_params,
    cp_params,
    *,
    talker_cfg: TalkerConfig,
    cp_cfg: CodePredictorConfig,
    sampling: SamplingConfig,
    prefill_embeds: torch.Tensor,
    prefill_len: int,
    trailing_embeds: torch.Tensor,
    trailing_len: int,
    tts_pad_embed: torch.Tensor,
    max_steps: int,
    max_frames: int,
    seed: int,
    cache: tk.KVCache | tk.KVCacheQ | None = None,
    cache_len: int = 0,
    kv_quant: bool = False,
) -> GenResult:
    """The full AR synthesis loop for one utterance; returns codec codes.
    With ``cache=None`` a cache of ``cache_len`` rows is allocated: bf16, or
    int8 with row scales when ``kv_quant``."""
    if cache is None:
        cache = tk.make_cache(
            talker_cfg, 1, cache_len, prefill_embeds.dtype, prefill_embeds.device,
            quantized=kv_quant,
        )
    common = dict(talker_cfg=talker_cfg, cp_cfg=cp_cfg, sampling=sampling)
    stream = dict(
        trailing_embeds=trailing_embeds, trailing_len=trailing_len, tts_pad_embed=tts_pad_embed
    )
    carry = prefill_start(
        talker_params, cp_params, **common, **stream, prefill_embeds=prefill_embeds,
        prefill_len=prefill_len, cache=cache, max_frames=max_frames, seed=seed,
    )
    carry = generate_chunk(  # its turn's end reads the last frame's fault flags
        talker_params, cp_params, carry, **common, **stream, until_step=max_steps
    )
    return GenResult(codes=carry.codes, n_frames=carry.step, tokens=carry.tokens)


def pad_to_bucket(length: int, buckets=(64, 128, 256, 384, 512, 768, 1024, 1536, 2048)):
    """Smallest bucket >= length."""
    for b in buckets:
        if length <= b:
            return b
    return ((length + 255) // 256) * 256
