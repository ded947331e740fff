"""Public Qwen3-TTS API (port of qwen3tts_tpu/tts.py): one utterance,
streaming, voice cloning and lockstep batches.

``Qwen3TTSModel.from_pretrained(dir)`` loads a checkpoint directory
(utils/loader.py); ``Qwen3TTSModel(...)`` is built from parameter trees
already on a device. Both target CUDA unless ``device="cpu"`` is asked for,
and raise ``Qwen3TTSError`` when no card is present. ``generate`` /
``generate_custom_voice`` / ``generate_voice_design`` build the prompt on
the host, run prefill and the decode loop (models/generate.py), then the
vocoder on the smallest ``GEN_BUCKETS`` prefix that covers the generated
frames; with ``on_token`` the decode runs in chunks and each new code-0
token is handed to the callback at its chunk's end. ``generate_stream``
yields ``TokenEvent``s while the utterance is generated (optionally
``AudioChunkEvent``s of windowed vocoder PCM), then one ``InfoEvent`` and
the final ``AudioEvent``; ``generate_stream_async`` runs it on a producer
thread (``AsyncEventStream``). ``generate_voice_clone`` encodes reference
audio to codes (models/encoder.py) and a speaker embedding
(models/speaker_encoder.py) into an in-context prompt. ``generate_batch``
runs B utterances in lockstep decodes of at most 64 each
(models/batch_generate.py), with one batched vocoder call per group.
``kv_cache_dtype="int8"`` keeps the talker's KV cache in int8 with per-row
scales. ``generate_batch_continuous`` runs N texts over a fixed number of
cache slots, refilling a slot as soon as its utterance ends (serving.py),
and ``serve`` returns a ``TTSService``: a long-lived worker behind a
thread-safe ``submit`` (a Future of the waveform) and ``submit_stream``
(``generate_stream``'s events, through the shared slots), with
per-request sampling that K1 and K2 carry row by row. ``serving_http.py``
puts it behind HTTP.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import warnings
import weakref
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from .config import ModelConfig, TalkerConfig
from .models import encoder as enc_mod
from .models import generate as gen_mod
from .models import speaker_encoder as spk_mod
from .models import talker as tk_mod
from .models import vocoder as vc_mod
from .models.generate import SamplingConfig, pad_to_bucket
from .ops.talker_kernel import MAX_BATCH

CHAT_ASSISTANT = "<|im_start|>assistant\n{}<|im_end|>\n<|im_start|>assistant\n"
CHAT_ASSISTANT_CLOSED = "<|im_start|>assistant\n{}<|im_end|>\n"
CHAT_USER = "<|im_start|>user\n{}<|im_end|>\n"

# Frame-count buckets for the max_frames cap and the vocoder's decode length
# (the JAX package's default ladder).
GEN_BUCKETS = (72, 96, 128, 256, 512, 1024, 2048)


class Qwen3TTSError(Exception):
    """Generation errors."""


@dataclass
class GenerationInfo:
    prompt_token_count: int
    generation_token_count: int
    prefill_time: float
    generate_time: float
    tokens_per_second: float
    peak_memory_usage: float  # GB

    @property
    def summary(self) -> str:
        return (
            f"Prompt:     {self.prompt_token_count} tokens, {self.prefill_time:.3f}s\n"
            f"Generation: {self.generation_token_count} tokens, "
            f"{self.tokens_per_second:.2f} tokens/s, {self.generate_time:.3f}s\n"
            f"Peak Memory Usage: {self.peak_memory_usage:.3f} GB"
        )


@dataclass
class TokenEvent:
    token: int


@dataclass
class InfoEvent:
    info: GenerationInfo


@dataclass
class AudioEvent:
    audio: np.ndarray


@dataclass
class AudioChunkEvent:
    """Incremental PCM for frames [frame_offset, frame_offset + n_frames),
    asked for with ``generate_stream(..., audio_chunk_frames=N)``. Chunks
    concatenate into a coherent waveform; the final AudioEvent still
    carries the whole utterance's decode."""

    audio: np.ndarray
    frame_offset: int


def _generate_and_decode(
    talker_params,
    cp_params,
    voc_params,
    *,
    talker_cfg,
    cp_cfg,
    sampling,
    dec_cfg,
    prefill_embeds,
    prefill_len: int,
    trailing_embeds,
    trailing_len: int,
    tts_pad_embed,
    max_steps: int,
    max_frames: int,
    seed: int,
    cache_len: int,
    kv_quant: bool = False,
):
    """The whole utterance: prefill, decode loop, then the vocoder on the
    smallest bucket prefix of the codes buffer that covers ``n_frames``.
    Returns (codes [max_frames, 16], n_frames, wav [1, b * 1920], lengths)."""
    res = gen_mod.generate_codes(
        talker_params, cp_params,
        talker_cfg=talker_cfg, cp_cfg=cp_cfg, sampling=sampling,
        prefill_embeds=prefill_embeds, prefill_len=prefill_len,
        trailing_embeds=trailing_embeds, trailing_len=trailing_len,
        tts_pad_embed=tts_pad_embed, max_steps=max_steps, max_frames=max_frames,
        seed=seed, cache_len=cache_len, kv_quant=kv_quant,
    )
    buckets = [b for b in GEN_BUCKETS if b < max_frames] + [max_frames]
    b = next(b for b in buckets if res.n_frames <= b)
    wav, lengths = vc_mod.decode(voc_params, dec_cfg, res.codes[None, :b], res.n_frames)
    return res.codes, res.n_frames, wav, lengths


def _device_peak_memory_gb(device) -> float:
    """The peak memory allocated on a CUDA device, GB (0 off CUDA)."""
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 1e9


def _kernel_device(device: torch.device) -> bool:
    """Whether K1 and K2 serve the decode on ``device`` (CUDA). The load
    rules of ``from_pretrained`` that choose the kernels' layouts follow it,
    as the JAX package's follow the TPU."""
    return device.type == "cuda"


def _device(device) -> torch.device:
    """The model's device: CUDA unless another is asked for; CUDA with no
    card present raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise Qwen3TTSError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


class Qwen3TTSModel:
    """A model bundle on one device + the synthesis entry points."""

    def __init__(
        self,
        config: ModelConfig,
        talker_params,
        cp_params,
        vocoder_params=None,
        tokenizer_config=None,
        encoder_params=None,
        speaker_encoder_params=None,
        tokenizer=None,
        dtype=torch.bfloat16,
        device=None,
        kv_cache_dtype: str = "bf16",
    ):
        if config.talker_config is None:
            raise Qwen3TTSError("Talker config is required")
        if kv_cache_dtype not in ("bf16", "int8"):
            raise Qwen3TTSError(f"Unsupported kv_cache_dtype: {kv_cache_dtype!r}")
        self.config = config
        self.talker_cfg: TalkerConfig = config.talker_config
        self.cp_cfg = self.talker_cfg.code_predictor_config
        self.talker_params = talker_params
        self.cp_params = cp_params
        self.vocoder_params = vocoder_params
        self.tokenizer_config = tokenizer_config
        self.encoder_params = encoder_params
        self.speaker_encoder_params = speaker_encoder_params
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = _device(device)
        # int8 KV cache with per-row scales: half the bytes the decode
        # attention reads; opt-in, as int8 rounding perturbs attention
        self.kv_quant = kv_cache_dtype == "int8"
        # streaming chunk size (frames between host reads); 25 = 2 s of audio
        self.stream_chunk_frames = 25
        self.ref_exact_top_p = False
        # the most recent utterance's info, whichever thread ran it (a
        # stream's InfoEvent carries its own)
        self.last_info: GenerationInfo | None = None

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls,
        model_path: str,
        dtype=torch.bfloat16,
        keep_packed: bool | None = None,
        fuse: bool = False,
        quantize: str | None = None,
        mesh=None,
        kv_cache_dtype: str = "bf16",
        device=None,
    ) -> "Qwen3TTSModel":
        """Load config.json + safetensors (+ speech_tokenizer/, tokenizer)
        from a local directory onto ``device`` (default CUDA, which raises
        ``Qwen3TTSError`` where no card is present; ``device="cpu"`` runs on
        the CPU).

        ``keep_packed=True`` keeps MLX int4/int8 weights packed: the
        low-memory mode, whose single-row matmuls run through K4.
        ``quantize='int8'`` requantizes the talker and code-predictor
        matmuls to weight-only int8 with fused q/k/v and gate/up (int4
        checkpoints are dequantized first), the layout K1 and K2 serve.
        On CUDA an unquantized checkpoint loaded as bf16 (no ``quantize``,
        not packed) is fused too, talker and CP: K1 and K2 serve it in
        their dense-bf16 mode. ``fuse`` fuses the projections without
        quantizing.
        ``kv_cache_dtype='int8'`` stores decode KV caches as int8 with
        per-row scales. ``mesh`` is not ported yet and raises."""
        from .ops.quant import quantize_decode_params_int8
        from .utils.loader import Checkpoint

        if quantize not in (None, "int8"):
            raise Qwen3TTSError(f"Unsupported quantize mode: {quantize!r}")
        if mesh is not None:
            raise Qwen3TTSError("mesh (multi-device) loading is not ported yet")
        if kv_cache_dtype not in ("bf16", "int8"):
            raise Qwen3TTSError(f"Unsupported kv_cache_dtype: {kv_cache_dtype!r}")
        device = _device(device)
        kernels = _kernel_device(device)
        if quantize is None and keep_packed is None and kernels:
            # CUDA takes the JAX package's TPU default: a quantized (MLX
            # affine) checkpoint is dequantized and requantized to int8, which
            # K1 and K2 serve; keep_packed=True stays the low-memory mode. On
            # the CPU the packed default holds, as in the JAX package.
            with open(os.path.join(model_path, "config.json")) as f:
                if json.load(f).get("quantization"):
                    quantize = "int8"
        if quantize:
            keep_packed = False  # int4 checkpoints: dequantize, then requantize int8
        ckpt = Checkpoint(model_path, dtype, keep_packed=keep_packed, device=device)
        # The JAX package's fusion rule (its tts.py:427-443) with CUDA in the
        # TPU's place: int8 fuses the talker and CP projections, the layout
        # K1 and K2 read; so does a dense bf16 load on the card (JAX's
        # ``bf16_kernel_ready``), which K1 and K2 serve in their bf16 mode.
        # The JAX package fuses only the talker there, as its bf16 CP ran on
        # XLA; the port's K2 takes the fused bf16 layout, so the CP is fused
        # too. Other dtypes, packed weights and the CPU stay unfused.
        q0 = ckpt.talker_params["layers"]["q_proj"]
        bf16_kernel_ready = (
            kernels and quantize is None and isinstance(q0, torch.Tensor)
            and q0.dtype == torch.bfloat16
        )
        if fuse or quantize == "int8" or bf16_kernel_ready:
            ckpt.talker_params["layers"] = tk_mod.fuse_layer_projections(
                ckpt.talker_params["layers"]
            )
            if ckpt.cp_params is not None:
                ckpt.cp_params["layers"] = tk_mod.fuse_layer_projections(ckpt.cp_params["layers"])
        if quantize == "int8":
            ckpt.talker_params = quantize_decode_params_int8(ckpt.talker_params, "codec_head")
            if ckpt.cp_params is not None:
                ckpt.cp_params = quantize_decode_params_int8(ckpt.cp_params, "lm_head")
        tokenizer = None
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
        except Exception as ex:  # noqa: BLE001  (any failure leaves text synthesis unavailable)
            # non-fatal (codes-only work needs no text), but say so now rather
            # than at the first "Tokenizer not loaded" far from the cause
            warnings.warn(
                f"could not load a text tokenizer from {model_path}: {ex!r}; "
                "text synthesis entry points will raise until one is available",
                stacklevel=2,
            )
        return cls(
            config=ckpt.config,
            talker_params=ckpt.talker_params,
            cp_params=ckpt.cp_params,
            vocoder_params=ckpt.vocoder_params,
            tokenizer_config=ckpt.tokenizer_config,
            encoder_params=ckpt.encoder_params,
            speaker_encoder_params=ckpt.speaker_encoder_params,
            tokenizer=tokenizer,
            dtype=dtype,
            device=device,
            kv_cache_dtype=kv_cache_dtype,
        )

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def tts_model_type(self) -> str:
        return self.config.tts_model_type

    @property
    def supported_speakers(self) -> list[str]:
        return sorted(self.talker_cfg.speaker_ids)

    @property
    def has_voice_cloning(self) -> bool:
        return self.speaker_encoder_params is not None

    @property
    def supports_voice_cloning(self) -> bool:
        return self.config.tts_model_type == "base" and self.encoder_params is not None

    # ------------------------------------------------------------------
    # Prompt construction
    # ------------------------------------------------------------------

    def _encode_text(self, text: str) -> torch.Tensor:
        if self.tokenizer is None:
            raise Qwen3TTSError("Tokenizer not loaded")
        ids = self.tokenizer.encode(text)
        return torch.tensor([ids], dtype=torch.int64, device=self.device)

    def _embed_project(self, ids: torch.Tensor) -> torch.Tensor:
        raw = tk_mod.embed_text(self.talker_params, self.talker_cfg, ids)
        return tk_mod.resize_mlp(self.talker_params["text_projection"], raw)

    def _tts_special_embeds(self):
        c = self.config
        ids = torch.tensor(
            [[c.tts_bos_token_id, c.tts_eos_token_id, c.tts_pad_token_id]], device=self.device
        )
        e = self._embed_project(ids)
        return e[:, 0:1], e[:, 1:2], e[:, 2:3]  # bos, eos, pad each [1, 1, h]

    def _resolve_language_id(self, language: str, speaker: str | None) -> int | None:
        cfg = self.talker_cfg
        lang = language.lower()
        language_id = cfg.language_ids.get(lang) if lang != "auto" else None
        if lang in ("chinese", "auto") and speaker:
            dialect = cfg.speaker_dialects.get(speaker.lower())
            if dialect and dialect in cfg.language_ids:
                language_id = cfg.language_ids[dialect]
        return language_id

    def _codec_prefix_ids(self, language_id: int | None) -> list[int]:
        cfg = self.talker_cfg
        if language_id is None:
            return [cfg.codec_nothink_id, cfg.codec_think_bos_id, cfg.codec_think_eos_id]
        return [cfg.codec_think_id, cfg.codec_think_bos_id, language_id, cfg.codec_think_eos_id]

    def _build_codec_prefix(self, language_id, speaker_embed):
        """[think-prefix ..., (speaker,) pad, bos] codec-side embeddings."""
        cfg = self.talker_cfg
        emb = tk_mod.embed_codec(
            self.talker_params,
            torch.tensor([self._codec_prefix_ids(language_id)], device=self.device),
        )
        suffix = tk_mod.embed_codec(
            self.talker_params, torch.tensor([[cfg.codec_pad_id, cfg.codec_bos_id]], device=self.device)
        )
        parts = [emb]
        if speaker_embed is not None:
            parts.append(speaker_embed.reshape(1, 1, -1).to(emb.dtype))
        parts.append(suffix)
        return torch.cat(parts, dim=1)

    def _prepare_generation_inputs(
        self,
        text: str,
        language: str = "auto",
        speaker: str | None = None,
        instruct: str | None = None,
    ):
        """Non-ICL prefill construction. Returns (input_embeds [1, P, h],
        trailing [T, h], tts_pad [h])."""
        cfg = self.talker_cfg
        text_embed = self._embed_project(self._encode_text(CHAT_ASSISTANT.format(text)))
        tts_bos, tts_eos, tts_pad = self._tts_special_embeds()
        speaker_embed = None
        if speaker is not None:
            spk_token = cfg.speaker_ids.get(speaker.lower())
            if spk_token is not None:
                speaker_embed = tk_mod.embed_codec(
                    self.talker_params, torch.tensor([spk_token], device=self.device)
                )
        codec_embed = self._build_codec_prefix(
            self._resolve_language_id(language, speaker), speaker_embed
        )
        codec_len = codec_embed.shape[1]
        parts = []
        if instruct:
            parts.append(self._embed_project(self._encode_text(CHAT_USER.format(instruct))))
        # tts_pad * (codec_len - 2) + tts_bos, overlaid on codec prefix[:-1]
        combined = torch.cat([tts_pad.expand(1, codec_len - 2, tts_pad.shape[-1]), tts_bos], dim=1)
        combined = combined + codec_embed[:, : codec_len - 1]
        # role tokens, the overlay, then first text token + codec bos
        parts += [text_embed[:, 0:3], combined, text_embed[:, 3:4] + codec_embed[:, codec_len - 1 :]]
        input_embeds = torch.cat(parts, dim=1)
        # trailing text stream: tokens[4 : len-5] + tts_eos
        text_len = text_embed.shape[1]
        if text_len - 5 > 4:
            trailing = torch.cat([text_embed[:, 4 : text_len - 5], tts_eos], dim=1)
        else:
            trailing = tts_eos
        return input_embeds, trailing[0], tts_pad[0, 0]

    def _prepare_icl_generation_inputs(
        self, text: str, ref_audio: np.ndarray, ref_text: str, language: str = "auto"
    ):
        """ICL (voice-clone) prefill: the reference audio's codes and both
        texts in context. Returns (input_embeds [1, P, h], trailing [1, h],
        tts_pad [h], ref_codes [1, 16, T] int32)."""
        cfg = self.talker_cfg
        if self.encoder_params is None or self.tokenizer_config is None:
            raise Qwen3TTSError("Speech tokenizer encoder not available")
        audio = torch.as_tensor(np.asarray(ref_audio, np.float32), device=self.device)
        ref_codes = enc_mod.encode(
            self.encoder_params, self.tokenizer_config.encoder_config, audio[None],
            self.tokenizer_config.encoder_valid_num_quantizers,
        )  # [1, 16, T]

        ref_ids = self._encode_text(CHAT_ASSISTANT_CLOSED.format(ref_text))
        ref_text_ids = ref_ids[:, 3 : ref_ids.shape[1] - 2]
        target_ids = self._encode_text(CHAT_ASSISTANT.format(text))
        text_ids = target_ids[:, 3 : target_ids.shape[1] - 5]

        tts_bos, tts_eos, tts_pad = self._tts_special_embeds()
        combined_ids = torch.cat([ref_text_ids, text_ids], dim=1)
        text_embed = torch.cat([self._embed_project(combined_ids), tts_eos], dim=1)
        text_lens = text_embed.shape[1]

        # codec side: codec_bos + the summed 16-codebook embeddings of the ref codes
        ref_codec = tk_mod.embed_codec(self.talker_params, ref_codes[:, 0])
        for i in range(cfg.num_code_groups - 1):
            ref_codec = ref_codec + self.cp_params["codec_embedding"][i][ref_codes[:, i + 1].long()]
        codec_bos = tk_mod.embed_codec(
            self.talker_params, torch.tensor([[cfg.codec_bos_id]], device=self.device)
        )
        codec_icl = torch.cat([codec_bos, ref_codec.to(codec_bos.dtype)], dim=1)
        codec_lens = codec_icl.shape[1]

        # non-streaming overlay: text + codec_pad || codec + tts_pad
        codec_pad = tk_mod.embed_codec(
            self.talker_params, torch.tensor([[cfg.codec_pad_id]], device=self.device)
        )
        h = codec_pad.shape[-1]
        text_part = text_embed + codec_pad.expand(1, text_lens, h)
        codec_part = codec_icl + tts_pad.expand(1, codec_lens, h)
        icl_embed = torch.cat([text_part, codec_part], dim=1)

        speaker_embed = None
        if self.speaker_encoder_params is not None:
            speaker_embed = spk_mod.extract_embedding(
                self.speaker_encoder_params, self.config.speaker_encoder_config, audio
            )
        codec_prefix = self._build_codec_prefix(self._resolve_language_id(language, None),
                                                speaker_embed)
        prefix_len = codec_prefix.shape[1]
        role_embed = self._embed_project(target_ids[:, 0:3])
        combined_prefix = torch.cat([tts_pad.expand(1, prefix_len - 2, h), tts_bos], dim=1)
        combined_prefix = combined_prefix + codec_prefix[:, : prefix_len - 1]
        input_embeds = torch.cat([role_embed, combined_prefix, icl_embed], dim=1)
        return input_embeds, tts_pad[0], tts_pad[0, 0], ref_codes

    # ------------------------------------------------------------------
    # Synthesis entry points
    # ------------------------------------------------------------------

    def _effective_max_tokens(self, text: str, max_tokens: int) -> int:
        """min(max_tokens, max(75, 6 * text_tokens))."""
        n = len(self.tokenizer.encode(text)) if self.tokenizer else len(text)
        return min(max_tokens, max(75, n * 6))

    def _sampling(self, temperature, top_k, top_p, repetition_penalty) -> SamplingConfig:
        return SamplingConfig(
            temperature, top_k, top_p, repetition_penalty, ref_exact_top_p=self.ref_exact_top_p
        )

    def _prep_run(self, input_embeds, trailing, tts_pad, max_steps: int) -> dict:
        """Bucket/pad the prompt and trailing streams; size the KV cache
        (int8 with row scales under ``kv_cache_dtype="int8"``)."""
        p_len = input_embeds.shape[1]
        p_bucket = pad_to_bucket(p_len)
        prefill = torch.nn.functional.pad(
            input_embeds.to(self.dtype), (0, 0, 0, p_bucket - p_len)
        )
        max_frames = pad_to_bucket(max_steps, GEN_BUCKETS)
        t_len = trailing.shape[0]
        trailing_p = torch.nn.functional.pad(
            trailing.to(self.dtype), (0, 0, 0, pad_to_bucket(t_len) - t_len)
        )
        return dict(
            prefill_embeds=prefill,
            prefill_len=p_len,
            trailing_embeds=trailing_p,
            trailing_len=t_len,
            tts_pad_embed=tts_pad.to(self.dtype),
            max_frames=max_frames,
            cache_len=-(-(p_bucket + max_frames) // 128) * 128,
            kv_quant=self.kv_quant,
        )

    def _set_info(self, n_tokens: int, prompt_tokens: int, prefill_t: float, gen_t: float):
        info = GenerationInfo(
            prompt_token_count=prompt_tokens,
            generation_token_count=n_tokens,
            prefill_time=prefill_t,
            generate_time=gen_t,
            tokens_per_second=n_tokens / max(gen_t, 1e-9),
            peak_memory_usage=_device_peak_memory_gb(self.device),
        )
        self.last_info = info
        return info

    def _run_generation(
        self,
        input_embeds,
        trailing,
        tts_pad,
        *,
        sampling: SamplingConfig,
        max_steps: int,
        seed: int,
        on_token: Callable[[int], None] | None = None,
    ) -> tuple[np.ndarray, int]:
        """Prefill and the decode loop; returns (codes [max_frames, 16] numpy
        int32, n_frames). Without ``on_token`` the loop runs whole
        (``generate_codes``); with it, in the chunks of ``_stream_codes``,
        and each new code-0 token goes to ``on_token`` at its chunk's end."""
        if self.cp_params is None or self.cp_cfg is None:
            raise Qwen3TTSError("Code predictor not available")
        prep = self._prep_run(input_embeds, trailing, tts_pad, max_steps)
        if on_token is None:
            t0 = time.time()
            res = gen_mod.generate_codes(
                self.talker_params, self.cp_params,
                talker_cfg=self.talker_cfg, cp_cfg=self.cp_cfg, sampling=sampling,
                **prep, max_steps=max_steps, seed=seed,
            )
            codes = res.codes.cpu().numpy()
            gen_t = time.time() - t0
            if res.n_frames == 0:
                raise Qwen3TTSError("No tokens generated")
            # prefill runs inside the same call; reported as 0 rather than
            # guessed (the chunked path measures it)
            self._set_info(res.n_frames, input_embeds.shape[1], 0.0, gen_t)
            return codes, res.n_frames

        t0 = time.time()
        codes, n, prefill_t = None, 0, 0.0
        for new_tokens, step, codes_np, done, prefill_t in self._stream_codes(
            prep, sampling, max_steps, seed
        ):
            for t in new_tokens:
                on_token(t)
            if done:
                codes, n = codes_np, step
        if n == 0:
            raise Qwen3TTSError("No tokens generated")
        self._set_info(n, input_embeds.shape[1], prefill_t, time.time() - t0 - prefill_t)
        return codes, n

    def _run_generation_audio(self, input_embeds, trailing, tts_pad, *, sampling, max_steps, seed):
        """Generate and vocode one utterance; returns the waveform (numpy f32)."""
        self._require_audio_models()
        prep = self._prep_run(input_embeds, trailing, tts_pad, max_steps)
        dec_cfg = self.tokenizer_config.decoder_config
        t0 = time.time()
        _codes, n, wav, lengths = _generate_and_decode(
            self.talker_params, self.cp_params, self.vocoder_params,
            talker_cfg=self.talker_cfg, cp_cfg=self.cp_cfg, sampling=sampling,
            dec_cfg=dec_cfg, **prep, max_steps=max_steps, seed=seed,
        )
        out = wav[0, : n * dec_cfg.total_upsample].float().cpu().numpy()
        gen_t = time.time() - t0
        if n == 0:
            raise Qwen3TTSError("No tokens generated")
        self._set_info(n, input_embeds.shape[1], 0.0, gen_t)
        valid = int(lengths[0])
        if 0 < valid < out.shape[0]:
            out = out[:valid]
        return out

    def _stream_codes(
        self, prep: dict, sampling: SamplingConfig, max_steps: int, seed: int,
        audio: bool = False,
    ):
        """Prefill, then the decode loop in chunks, yielding between them.

        Yields (new_tokens, total_frames, codes [max_frames, 16] numpy,
        done, prefill_t): the host reads the tokens and codes back at each
        chunk's end, so a consumer sees the tokens while the utterance is
        still being generated; ``prefill_t`` is this stream's prefill wall
        time (s). The first read-back comes after the prefill, then after
        a chunk just big enough to clear the vocoder's lookahead and the
        first audio emit (``min(stream_chunk_frames,
        STREAM_FIRST_AUDIO_FRAMES + STREAM_LOOKAHEAD_FRAMES)`` frames), and
        so does the second; later chunks are ``stream_chunk_frames``. With
        ``audio`` the prefill and the first chunk run before the first
        read-back, which then carries the first audio window's frames (the
        reference's schedule when it streams audio).

        The decode loop reads code 0 back once a frame (models/generate.py),
        so the next chunk cannot be queued on the device ahead of the
        consumer as a device-resident loop could: it runs after the
        consumer has taken this one. The events, not that overlap, are the
        contract. The prefill and each chunk run in the device's turn
        (``generate.device_turn``), whose end reads the persistent B = 1
        launches' fault flags, so a barrier fault raises at the chunk that
        had it."""
        common = dict(talker_cfg=self.talker_cfg, cp_cfg=self.cp_cfg, sampling=sampling)
        chunk_args = dict(
            trailing_embeds=prep["trailing_embeds"],
            trailing_len=prep["trailing_len"],
            tts_pad_embed=prep["tts_pad_embed"],
        )
        chunk = self.stream_chunk_frames
        first_chunk = min(chunk, self.STREAM_FIRST_AUDIO_FRAMES + self.STREAM_LOOKAHEAD_FRAMES)
        prep = dict(prep)
        cache = tk_mod.make_cache(
            self.talker_cfg, 1, prep.pop("cache_len"), prep["prefill_embeds"].dtype,
            prep["prefill_embeds"].device, quantized=prep.pop("kv_quant"),
        )
        t0 = time.time()
        carry = gen_mod.prefill_start(
            self.talker_params, self.cp_params, **common, **prep, cache=cache, seed=seed
        )
        prefill_t = time.time() - t0
        if audio:
            carry = gen_mod.generate_chunk(
                self.talker_params, self.cp_params, carry, **chunk_args, **common,
                until_step=min(first_chunk, max_steps),
            )
        emitted = 0
        while True:
            step = carry.step
            done = carry.eos or step >= max_steps
            tokens = carry.tokens.cpu().numpy()[:step]
            new = [int(t) for t in tokens[emitted:] if t >= 0]
            emitted = step
            yield new, step, carry.codes.cpu().numpy(), done, prefill_t
            if done:
                return
            cur = first_chunk if emitted <= first_chunk else chunk
            carry = gen_mod.generate_chunk(
                self.talker_params, self.cp_params, carry, **chunk_args, **common,
                until_step=min(step + cur, max_steps),
            )

    def _decode_audio(self, codes: np.ndarray, n_frames: int) -> np.ndarray:
        """The vocoder on the smallest GEN_BUCKETS bucket that covers
        ``n_frames`` rows of ``codes`` (numpy [rows, 16]), trimmed to the
        valid samples."""
        if self.vocoder_params is None or self.tokenizer_config is None:
            raise Qwen3TTSError("Speech tokenizer not loaded")
        dec_cfg = self.tokenizer_config.decoder_config
        t_bucket = pad_to_bucket(n_frames, GEN_BUCKETS)
        buf = np.zeros((1, t_bucket, dec_cfg.num_quantizers), np.int32)
        buf[0, : min(n_frames, codes.shape[0])] = codes[:n_frames]
        wav, lengths = vc_mod.decode(
            self.vocoder_params, dec_cfg, torch.from_numpy(buf).to(self.device), n_frames
        )
        valid = int(lengths[0])
        # the padded tail is read back and cut on the host
        out = wav[0].float().cpu().numpy()[: n_frames * dec_cfg.total_upsample]
        if 0 < valid < out.shape[0]:
            out = out[:valid]
        return out

    # ------------------------------------------------------------------
    # Public generation entry points
    # ------------------------------------------------------------------

    def generate_voice_design(
        self,
        text: str,
        language: str = "auto",
        instruct: str | None = None,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        repetition_penalty: float = 1.05,
        max_tokens: int = 2048,
        seed: int = 0,
        on_token: Callable[[int], None] | None = None,
    ) -> np.ndarray:
        """VoiceDesign synthesis; ``on_token`` receives each code-0 token as
        the decode produces it."""
        embeds, trailing, pad = self._prepare_generation_inputs(
            text, language=language, speaker=None, instruct=instruct
        )
        return self._synthesize(embeds, trailing, pad, text, temperature, top_k, top_p,
                                repetition_penalty, max_tokens, seed, on_token)

    def _synthesize(self, embeds, trailing, pad, text, temperature, top_k, top_p,
                    repetition_penalty, max_tokens, seed, on_token) -> np.ndarray:
        """One utterance's audio: the one-call path, or with ``on_token`` the
        chunked decode and then the vocoder."""
        sampling = self._sampling(temperature, top_k, top_p, repetition_penalty)
        max_steps = self._effective_max_tokens(text, max_tokens)
        if on_token is None:
            return self._run_generation_audio(
                embeds, trailing, pad, sampling=sampling, max_steps=max_steps, seed=seed
            )
        codes, n = self._run_generation(
            embeds, trailing, pad, sampling=sampling, max_steps=max_steps, seed=seed,
            on_token=on_token,
        )
        return self._decode_audio(codes, n)

    def generate_custom_voice(
        self,
        text: str,
        speaker: str,
        language: str = "auto",
        instruct: str | None = None,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        repetition_penalty: float = 1.05,
        max_tokens: int = 2048,
        seed: int = 0,
        on_token: Callable[[int], None] | None = None,
    ) -> np.ndarray:
        """CustomVoice/Base synthesis; ``on_token`` as in
        ``generate_voice_design``."""
        speakers = self.talker_cfg.speaker_ids
        if not speakers:
            raise Qwen3TTSError("This model does not support CustomVoice. No speakers defined.")
        if speaker.lower() not in speakers:
            raise Qwen3TTSError(
                f"Speaker '{speaker}' not found. Available speakers: "
                + ", ".join(sorted(speakers))
            )
        embeds, trailing, pad = self._prepare_generation_inputs(
            text, language=language, speaker=speaker, instruct=instruct
        )
        return self._synthesize(embeds, trailing, pad, text, temperature, top_k, top_p,
                                repetition_penalty, max_tokens, seed, on_token)

    def generate_voice_clone(
        self,
        text: str,
        reference_audio: np.ndarray,
        reference_text: str,
        language: str = "auto",
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        repetition_penalty: float = 1.5,
        max_tokens: int = 2048,
        seed: int = 0,
        on_token: Callable[[int], None] | None = None,
    ) -> np.ndarray:
        """ICL voice cloning: ``reference_audio`` (24 kHz f32) and its
        transcript ``reference_text`` go into the prompt as codes and text
        (with the speaker embedding, where the model has a speaker
        encoder). The vocoder decodes the reference codes ahead of the
        generated ones for context, and the reference's share of the
        waveform is cut off again."""
        if self.vocoder_params is None:
            raise Qwen3TTSError("Speech tokenizer not loaded")
        if self.encoder_params is None:
            raise Qwen3TTSError(
                "Voice cloning (ICL mode) requires the speech tokenizer encoder. "
                "Make sure to load a model with encoder weights."
            )
        embeds, trailing, pad, ref_codes = self._prepare_icl_generation_inputs(
            text, reference_audio, reference_text, language
        )
        codes, n = self._run_generation(
            embeds, trailing, pad,
            sampling=self._sampling(temperature, top_k, top_p, repetition_penalty),
            max_steps=self._effective_max_tokens(text, max_tokens), seed=seed, on_token=on_token,
        )
        # reference codes ahead for the vocoder's context, then a proportional trim
        ref = ref_codes[0].T.cpu().numpy()  # [T_ref, 16]
        full = np.concatenate([ref, codes[:n]], axis=0)
        ref_len, total_len = ref.shape[0], full.shape[0]
        audio = self._decode_audio(full, total_len)
        cut = int(ref_len / max(total_len, 1) * audio.shape[0])
        if 0 < cut < audio.shape[0]:
            audio = audio[cut:]
        return audio

    def generate(
        self,
        text: str,
        speaker: str | None = None,
        instruct: str | None = None,
        language: str = "auto",
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        repetition_penalty: float = 1.05,
        max_tokens: int = 2048,
        seed: int = 0,
        on_token: Callable[[int], None] | None = None,
        return_info: bool = False,
    ):
        """Route by model type; ``return_info`` adds the GenerationInfo;
        ``on_token`` receives each code-0 token as the decode produces it."""
        kwargs = dict(
            language=language, temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, max_tokens=max_tokens, seed=seed,
            on_token=on_token,
        )
        mode = self.config.tts_model_type
        if mode == "voice_design":
            if instruct is None:
                raise Qwen3TTSError("VoiceDesign model requires 'instruct' to describe the voice")
            audio = self.generate_voice_design(text, instruct=instruct, **kwargs)
        elif mode in ("custom_voice", "base"):
            if speaker is None:
                raise Qwen3TTSError(
                    f"{mode} model requires 'speaker'. Available speakers: "
                    + ", ".join(self.supported_speakers)
                )
            audio = self.generate_custom_voice(
                text, speaker, instruct=instruct if mode == "custom_voice" else None, **kwargs
            )
        else:
            audio = self.generate_voice_design(text, instruct=instruct, **kwargs)
        return (audio, self.last_info) if return_info else audio

    # ------------------------------------------------------------------
    # Streaming
    # ------------------------------------------------------------------

    def _route_stream_inputs(self, text, speaker, instruct, language):
        """Mode routing and validation for streaming (as ``generate()``)."""
        mode = self.config.tts_model_type
        if mode == "voice_design":
            if instruct is None:
                raise Qwen3TTSError("VoiceDesign model requires 'instruct' to describe the voice")
            speaker = None
        elif mode in ("custom_voice", "base"):
            if speaker is None:
                raise Qwen3TTSError(
                    f"{'CustomVoice' if mode == 'custom_voice' else 'Base'} model "
                    "requires 'speaker'. Available speakers: " + ", ".join(self.supported_speakers)
                )
            if speaker.lower() not in self.talker_cfg.speaker_ids:
                raise Qwen3TTSError(
                    f"Speaker '{speaker}' not found. Available speakers: "
                    + ", ".join(self.supported_speakers)
                )
            if mode == "base":
                instruct = None
        return self._prepare_generation_inputs(
            text, language=language, speaker=speaker, instruct=instruct
        )

    # frames of PCM held back while the vocoder's bidirectional
    # pre-transformer can still see new right context, and the causal convs'
    # left-context frames decoded again with each window
    STREAM_LOOKAHEAD_FRAMES = 8
    STREAM_CTX_FRAMES = 32
    # the first PCM leaves as soon as this many frames clear the lookahead
    # (later chunks follow audio_chunk_frames): small, for time to first audio
    STREAM_FIRST_AUDIO_FRAMES = 4
    # vocoder buckets of the streaming windows: the first window is about
    # FIRST_AUDIO + LOOKAHEAD frames and later ones CTX + chunk + LOOKAHEAD,
    # well below GEN_BUCKETS' smallest
    STREAM_BUCKETS = (16, 32, 64) + GEN_BUCKETS

    def _decode_audio_window(
        self, codes: np.ndarray, start_f: int, end_f: int, n_valid: int
    ) -> np.ndarray:
        """PCM of frames [start_f, end_f) from codes[:n_valid]: the window
        starts STREAM_CTX_FRAMES early so that every causal conv runs on real
        history, and reaches frame n_valid so that the pre-transformer sees
        every frame generated so far. Its outputs are approximate only within
        STREAM_LOOKAHEAD_FRAMES of the window's end, which the caller holds
        back until more frames arrive. The window is cut on the host."""
        dec_cfg = self.tokenizer_config.decoder_config
        s = max(0, start_f - self.STREAM_CTX_FRAMES)
        w = n_valid - s
        bucket = pad_to_bucket(w, self.STREAM_BUCKETS)
        buf = np.zeros((1, bucket, dec_cfg.num_quantizers), np.int32)
        buf[0, :w] = codes[s:n_valid]
        wav, _ = vc_mod.decode(self.vocoder_params, dec_cfg, torch.from_numpy(buf).to(self.device), w)
        up = dec_cfg.total_upsample
        return wav[0].float().cpu().numpy()[(start_f - s) * up : (end_f - s) * up]

    def generate_stream(
        self,
        text: str,
        speaker: str | None = None,
        instruct: str | None = None,
        language: str = "auto",
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        repetition_penalty: float = 1.05,
        max_tokens: int = 2048,
        seed: int = 0,
        audio_chunk_frames: int | None = None,
    ) -> Iterator[TokenEvent | AudioChunkEvent | InfoEvent | AudioEvent]:
        """Streaming generation: a ``TokenEvent`` for each code-0 token while
        the utterance is generated (read back at each chunk of
        ``stream_chunk_frames``), then one ``InfoEvent``, then one final
        ``AudioEvent``.

        ``audio_chunk_frames=N`` also yields ``AudioChunkEvent``s of
        incremental PCM about every N frames (N * 80 ms of audio), the first
        after STREAM_FIRST_AUDIO_FRAMES; they concatenate into one waveform,
        and the closing AudioEvent still carries the whole decode. The first
        TokenEvents then come with the first chunk's, after the prefill and
        ``STREAM_FIRST_AUDIO_FRAMES + STREAM_LOOKAHEAD_FRAMES`` frames.

        Validation and prompt construction run at the call (this is a plain
        function that returns a generator): a bad speaker or instruct raises
        ``Qwen3TTSError`` here, before any event."""
        if self.vocoder_params is None or self.tokenizer_config is None:
            raise Qwen3TTSError("Speech tokenizer not loaded")
        embeds, trailing, pad = self._route_stream_inputs(text, speaker, instruct, language)
        sampling = self._sampling(temperature, top_k, top_p, repetition_penalty)
        max_steps = self._effective_max_tokens(text, max_tokens)
        prep = self._prep_run(embeds, trailing, pad, max_steps)
        return self._generate_stream_events(text, prep, sampling, max_steps, seed,
                                            audio_chunk_frames)

    def _generate_stream_events(self, text, prep, sampling, max_steps, seed, audio_chunk_frames):
        start = time.time()
        n_final = 0
        codes_final: np.ndarray | None = None
        audio_emitted = 0  # frames whose PCM has been yielded
        prefill_t = 0.0
        for new_tokens, step, codes, done, prefill_t in self._stream_codes(
            prep, sampling, max_steps, seed, audio=bool(audio_chunk_frames)
        ):
            for t in new_tokens:
                yield TokenEvent(t)
            if audio_chunk_frames and step > 0:
                upto = step if done else max(step - self.STREAM_LOOKAHEAD_FRAMES, 0)
                if done:
                    need = 1
                elif audio_emitted == 0:
                    # a ramped first emit: a few frames of PCM leave as early
                    # as they can, then the chunk cadence
                    need = min(audio_chunk_frames, self.STREAM_FIRST_AUDIO_FRAMES)
                else:
                    need = audio_chunk_frames
                if upto - audio_emitted >= need:
                    pcm = self._decode_audio_window(codes, audio_emitted, upto, step)
                    yield AudioChunkEvent(pcm, audio_emitted)
                    audio_emitted = upto
            if done:
                n_final, codes_final = step, codes
        if n_final == 0:
            raise Qwen3TTSError("No tokens generated")

        total = time.time() - start
        prompt_tokens = len(self.tokenizer.encode(text)) if self.tokenizer else 0
        yield InfoEvent(
            self._set_info(n_final, prompt_tokens, prefill_t, max(total - prefill_t, 1e-9))
        )
        yield AudioEvent(self._decode_audio(codes_final, n_final))

    def generate_stream_async(self, *args, max_pending: int = 64, **kwargs) -> "AsyncEventStream":
        """``generate_stream`` driven by a producer thread: events queue up
        while the caller does other work. Same arguments and event sequence.
        The queue holds at most ``max_pending`` events: a consumer that stops
        reading pauses the generation instead of piling up PCM. ``close()``
        (or leaving a ``with`` block) abandons the stream; the generator is
        closed on the producer thread, so no further chunk is decoded. The
        producer's prefill and chunks take turns on the card with any other
        thread's (``generate.device_turn``)."""
        return AsyncEventStream(self.generate_stream(*args, **kwargs), maxsize=max_pending)

    def extract_speaker_embedding(self, audio: np.ndarray, sample_rate: int = 24000):
        """The speaker encoder's x-vector of 24 kHz ``audio``: [1, enc_dim] f32."""
        if sample_rate != 24000:
            raise Qwen3TTSError("Only 24kHz audio is supported for speaker embedding extraction")
        if self.speaker_encoder_params is None:
            raise Qwen3TTSError("Speaker encoder not available for this model")
        return spk_mod.extract_embedding(
            self.speaker_encoder_params, self.config.speaker_encoder_config,
            torch.as_tensor(np.asarray(audio, np.float32), device=self.device),
        )

    # ------------------------------------------------------------------
    # Batched synthesis
    # ------------------------------------------------------------------

    def generate_batch(
        self,
        texts: list[str],
        speakers: list[str] | None = None,
        instructs: list[str] | None = None,
        language: str = "auto",
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        repetition_penalty: float = 1.05,
        max_tokens: int = 2048,
        seed: int = 0,
        dp_mesh=None,
    ) -> list[np.ndarray]:
        """Synthesize B utterances in lockstep decodes of at most
        ``MAX_BATCH`` (64) texts each; one waveform per text. One weight
        stream serves every sequence of a group, so a frame costs far less
        than B single-utterance frames. Group g (texts 64 g ...) draws from
        ``seed + g``; the first group is the whole batch up to 64 texts.

        On CUDA the decode runs through K1 and K2, which take either fused
        layout: int8 (``from_pretrained(..., quantize='int8')``, the default
        for a quantized checkpoint) or dense bf16 (the default load of an
        unquantized checkpoint), at 0.6B and 1.7B: other weights (packed,
        unfused talker, float32) raise ``Qwen3TTSError``; an unfused int8
        code predictor runs through K2.

        Unlike ``generate()``, a sequence that samples EOS on its very first
        frame yields an empty waveform instead of raising (the batch's other
        results stand); check ``len(audio)``. ``dp_mesh`` (data-parallel
        replicas) is not ported yet and raises."""
        from .models import batch_generate as bg

        if dp_mesh is not None:
            raise Qwen3TTSError("dp_mesh (data-parallel decode) is not ported yet")
        B = len(texts)
        if B == 0:
            return []
        speakers = speakers if speakers is not None else [None] * B
        instructs = instructs if instructs is not None else [None] * B
        if len(speakers) != B or len(instructs) != B:
            raise Qwen3TTSError(
                f"generate_batch: texts ({B}), speakers ({len(speakers)}) and "
                f"instructs ({len(instructs)}) must have equal lengths"
            )
        self._require_audio_models()
        if self.device.type == "cuda" and not bg.kernels_take(
            self.talker_params, self.cp_params, self.talker_cfg, self.cp_cfg,
            min(B, MAX_BATCH), self.kv_quant,
        ):
            raise Qwen3TTSError(
                "generate_batch on CUDA runs through K1 and K2, which take a fused layout: "
                "int8 (from_pretrained(..., quantize='int8')) or dense bf16 (the default "
                "from_pretrained of an unquantized checkpoint with dtype bf16); K2 also an "
                "unfused int8 code predictor"
            )
        sampling = self._sampling(temperature, top_k, top_p, repetition_penalty)
        t0 = time.time()
        groups = [
            self._codes_batch(texts[i:i + MAX_BATCH], speakers[i:i + MAX_BATCH],
                              instructs[i:i + MAX_BATCH], language, sampling, max_tokens,
                              seed + i // MAX_BATCH)
            for i in range(0, B, MAX_BATCH)
        ]
        n_frames = np.concatenate([n for _, n, _ in groups])
        if (n_frames == 0).all():
            raise Qwen3TTSError("No tokens generated")
        audio = [a for codes, n, _ in groups
                 for a in self._decode_audio_list(codes, np.maximum(n, 1))]
        prompt = max(p for _, _, p in groups)
        self._set_info(int(n_frames.sum()), prompt, 0.0, time.time() - t0)
        return [a if n_frames[b] else a[:0] for b, a in enumerate(audio)]

    def _codes_batch(self, texts, speakers, instructs, language, sampling, max_tokens, seed):
        """One lockstep decode of at most MAX_BATCH texts; returns (codes
        [B, max_frames, 16] on the device, n_frames numpy [B], the prompt
        bucket)."""
        from .models import batch_generate as bg

        B = len(texts)
        built = self._build_batch_inputs(texts, speakers, instructs, language)
        p_bucket = pad_to_bucket(max(e.shape[1] for e, _, _ in built))
        t_bucket = pad_to_bucket(max(t.shape[0] for _, t, _ in built))
        pad = torch.nn.functional.pad
        prefill = torch.stack(
            [pad(e[0].to(self.dtype), (0, 0, 0, p_bucket - e.shape[1])) for e, _, _ in built]
        )
        trailing = torch.stack(
            [pad(t.to(self.dtype), (0, 0, 0, t_bucket - t.shape[0])) for _, t, _ in built]
        )
        caps = [self._effective_max_tokens(t, max_tokens) for t in texts]
        max_frames = pad_to_bucket(max(caps), GEN_BUCKETS)
        cache_len = -(-(p_bucket + max_frames) // 128) * 128
        res = bg.generate_codes_batch(
            self.talker_params, self.cp_params,
            talker_cfg=self.talker_cfg, cp_cfg=self.cp_cfg, sampling=sampling,
            prefill_embeds=prefill,
            prefill_lens=[e.shape[1] for e, _, _ in built],
            trailing_embeds=trailing,
            trailing_lens=[t.shape[0] for _, t, _ in built],
            tts_pad_embed=built[0][2].to(self.dtype),
            cache=tk_mod.make_cache(self.talker_cfg, B, cache_len, self.dtype, self.device,
                                    quantized=self.kv_quant),
            max_steps=caps, max_frames=max_frames, seed=seed,
        )
        return res.codes, res.n_frames.cpu().numpy(), p_bucket

    def generate_batch_continuous(
        self,
        texts: list[str],
        speakers: list[str] | None = None,
        instructs: list[str] | None = None,
        language: str = "auto",
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        repetition_penalty: float = 1.05,
        max_tokens: int = 2048,
        seed: int = 0,
        slots: int = 4,
        chunk_frames: int | None = None,
        dp_mesh=None,
    ) -> list[np.ndarray]:
        """Continuous batching: N texts over ``slots`` cache slots, a freed
        slot refilled from the queue between decode chunks (serving.py).
        Unlike ``generate_batch`` (lockstep until the last sequence ends),
        the slots stay busy with ragged lengths and N may exceed them. Text
        i's first frame draws from ``seed + i``, its later frames from its
        slot's streams of the lockstep generator (as in ``serve``). Returns
        one waveform per text, in order (an
        empty one for a text that sampled EOS on its first frame). On CUDA
        the decode runs through K1 and K2 (slots <= 64, a fused layout).
        ``dp_mesh`` is not ported yet and raises."""
        from .serving import BatchItem, ContinuousBatcher

        if dp_mesh is not None:
            raise Qwen3TTSError("dp_mesh (data-parallel serving) is not ported yet")
        N = len(texts)
        if N == 0:
            return []
        speakers = speakers if speakers is not None else [None] * N
        instructs = instructs if instructs is not None else [None] * N
        if len(speakers) != N or len(instructs) != N:
            raise Qwen3TTSError(
                f"generate_batch_continuous: texts ({N}), speakers ({len(speakers)}) and "
                f"instructs ({len(instructs)}) must have equal lengths"
            )
        self._require_audio_models()
        built = self._build_batch_inputs(texts, speakers, instructs, language)
        caps = [self._effective_max_tokens(t, max_tokens) for t in texts]
        items = [BatchItem(prefill_embeds=e, trailing=t, max_steps=cap, seed=seed + i)
                 for i, ((e, t, _), cap) in enumerate(zip(built, caps))]
        batcher = ContinuousBatcher(
            self.talker_params, self.cp_params, talker_cfg=self.talker_cfg, cp_cfg=self.cp_cfg,
            sampling=self._sampling(temperature, top_k, top_p, repetition_penalty),
            tts_pad_embed=built[0][2], slots=slots,
            chunk_frames=chunk_frames or self.stream_chunk_frames,
            max_frames=pad_to_bucket(max(caps), GEN_BUCKETS), dtype=self.dtype,
            kv_quant=self.kv_quant,
        )
        outs = batcher.run(items)
        if all(o.n_frames == 0 for o in outs):
            raise Qwen3TTSError("No tokens generated")
        audio = self._decode_codes_list([o.codes for o in outs])
        return [a if o.n_frames else a[:0] for a, o in zip(audio, outs)]

    def serve(
        self,
        slots: int = 4,
        chunk_frames: int | None = None,
        max_frames: int = 256,
        prompt_bucket: int = 256,
        trailing_bucket: int = 64,
        temperature: float = 0.9,
        top_k: int = 50,
        top_p: float = 1.0,
        repetition_penalty: float = 1.05,
        dp_mesh=None,
        max_queue: int | None = None,
        per_request_sampling: bool = False,
    ) -> "TTSService":
        """A long-lived synthesis service over this model: a
        :class:`TTSService` whose thread-safe ``submit(text, ...)`` returns
        a Future of the waveform. Requests are batched continuously over
        ``slots`` KV-cache slots (serving.Qwen3TTSServer), admitted between
        decode chunks.

        ``max_frames`` caps every request's codec frames for the life of the
        service; a request whose own cap exceeds it is cut there, and
        ``submit`` warns. ``max_queue`` bounds the waiting requests (the
        admitted ones do not count): a submit beyond it raises
        ``serving.ServiceOverloaded``, which the HTTP front end maps to 429.

        ``per_request_sampling``: ``submit`` takes temperature, top_k,
        top_p and repetition_penalty per request (the scalars here are the
        defaults); without it the service freezes them and refuses
        overrides, a policy of the operator's. Both modes decode alike: the
        service keeps a per-slot table and K1 and K2 read each row's values,
        where the TPU turned both kernels off for per-request sampling.
        Values that are not finite, or a repetition_penalty <= 0, raise.
        ``dp_mesh`` is not ported yet and raises; on CUDA ``slots`` must be
        1..64 (K1 and K2's batch)."""
        from .models import batch_generate as bg
        from .serving import check_samp_row

        if dp_mesh is not None:
            raise Qwen3TTSError("dp_mesh (data-parallel serving) is not ported yet")
        try:
            check_samp_row((temperature, top_k, top_p, repetition_penalty))
        except ValueError as e:
            raise Qwen3TTSError(str(e)) from None
        self._require_audio_models()
        bg._require_kernels(self.talker_params, self.cp_params, self.talker_cfg, self.cp_cfg,
                            self.device, slots, self.kv_quant)
        sampling = self._sampling(temperature, top_k, top_p, repetition_penalty)
        return TTSService(
            self, slots=slots, chunk_frames=chunk_frames or self.stream_chunk_frames,
            max_frames=max_frames, prompt_bucket=prompt_bucket, trailing_bucket=trailing_bucket,
            sampling=sampling._replace(per_request=per_request_sampling), max_queue=max_queue,
        )

    def _require_audio_models(self):
        """Raise unless the code predictor and the vocoder are loaded."""
        if self.cp_params is None or self.cp_cfg is None:
            raise Qwen3TTSError("Code predictor not available")
        if self.vocoder_params is None or self.tokenizer_config is None:
            raise Qwen3TTSError("Speech tokenizer not loaded")

    def _decode_codes_list(self, codes: list[np.ndarray]) -> list[np.ndarray]:
        """``_decode_audio_list`` of host codes [n_i, 16] (an empty one
        decodes one zero frame)."""
        n = np.asarray([max(c.shape[0], 1) for c in codes])
        buf = np.zeros((len(codes), int(n.max()), 16), np.int32)
        for i, c in enumerate(codes):
            buf[i, : c.shape[0]] = c
        return self._decode_audio_list(torch.from_numpy(buf).to(self.device), n)

    def _build_batch_inputs(self, texts, speakers, instructs, language):
        """Per-request validation and prompt construction for batched paths
        (the per-mode rules of ``generate()``)."""
        mode = self.config.tts_model_type
        built = []
        for text, speaker, instruct in zip(texts, speakers, instructs):
            if mode == "voice_design":
                if instruct is None:
                    raise Qwen3TTSError("VoiceDesign model requires 'instruct' for every text")
                speaker = None
            elif mode in ("custom_voice", "base"):
                if speaker is None:
                    raise Qwen3TTSError(
                        "CustomVoice/Base model requires 'speaker' for every text. "
                        "Available speakers: " + ", ".join(self.supported_speakers)
                    )
                if speaker.lower() not in self.talker_cfg.speaker_ids:
                    raise Qwen3TTSError(
                        f"Speaker '{speaker}' not found. Available speakers: "
                        + ", ".join(self.supported_speakers)
                    )
                if mode == "base":
                    instruct = None
            built.append(self._prepare_generation_inputs(
                text, language=language, speaker=speaker, instruct=instruct
            ))
        return built

    def _decode_audio_list(self, codes, n_frames) -> list[np.ndarray]:
        """One vocoder call for ragged utterances on a shared bucket.
        codes [B, max_frames, 16] on the device; n_frames: per-row counts."""
        dec_cfg = self.tokenizer_config.decoder_config
        n_frames = np.asarray(n_frames, np.int64)
        bucket = pad_to_bucket(max(int(n_frames.max()), 1), GEN_BUCKETS)
        buf = torch.zeros(codes.shape[0], bucket, codes.shape[2], dtype=codes.dtype,
                          device=codes.device)
        take = min(bucket, codes.shape[1])
        in_range = torch.arange(take, device=codes.device)[None, :, None] < torch.as_tensor(
            n_frames, device=codes.device)[:, None, None]
        buf[:, :take] = torch.where(in_range, codes[:, :take], 0)
        wav, lengths = vc_mod.decode(self.vocoder_params, dec_cfg, buf, torch.as_tensor(n_frames))
        wav, lengths = wav.float().cpu().numpy(), lengths.cpu().numpy()
        out = []
        for b in range(len(n_frames)):
            samples = wav[b][: n_frames[b] * dec_cfg.total_upsample]
            valid = int(lengths[b])
            if 0 < valid < samples.shape[0]:
                samples = samples[:valid]
            out.append(samples)
        return out


class AsyncEventStream:
    """Iterator over the events a background generation thread produces
    (``Qwen3TTSModel.generate_stream_async``).

    Events queue up as they are produced, at most ``maxsize``: when the
    consumer lags that far behind, the producer blocks before it advances
    the generator. An exception of the generation thread is raised again on
    the consumer at the point of iteration. ``pending()`` counts the queued
    events. ``close()`` wakes the producer and closes the generator on the
    producer thread (GeneratorExit at its current yield), so an abandoned
    stream stops decoding within one event."""

    _SENTINEL = object()

    def __init__(self, gen, maxsize: int = 64):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, maxsize))
        self._stop = threading.Event()
        self._exc: BaseException | None = None

        def put_or_stop(ev) -> bool:
            """A blocking put that close() wakes; False if the stream closed."""
            while not self._stop.is_set():
                try:
                    self._q.put(ev, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for ev in gen:
                    if not put_or_stop(ev):
                        break
            except BaseException as ex:  # noqa: BLE001  (raised again on the consumer)
                self._exc = ex
            finally:
                # closed here, on the producer thread: an abandoned
                # generate_stream stops at its current yield now, not at
                # garbage collection
                try:
                    gen.close()
                except Exception:  # noqa: BLE001  (the stream is over either way)
                    pass
                # the sentinel always lands so that a consumer ends; after
                # close() the consumer may be gone, so make room
                while True:
                    try:
                        self._q.put(self._SENTINEL, timeout=0.05)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            try:
                                self._q.get_nowait()
                            except queue.Empty:
                                pass

        self._thread = threading.Thread(target=run, name="qwen3tts-stream", daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        ev = self._q.get()
        if ev is self._SENTINEL:
            self._thread.join()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return ev

    def pending(self) -> int:
        """Events already produced but not yet consumed."""
        return self._q.qsize()

    def close(self):
        """Abandon the stream: wake a blocked producer and stop generation."""
        self._stop.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TTSService:
    """Long-lived synthesis service: text in, Future[waveform] out.

    A thin layer over :class:`serving.Qwen3TTSServer`: builds each
    request's prompt (the mode rules of ``generate``), queues it for
    continuous batching, and vocodes the harvested codes in the completion
    callback (on the server's worker), as the JAX service does: a vocoder
    thread of its own, on the worker's CUDA stream or on one of its own,
    made a served burst no faster on the H100 (``PERF.md``, serving). Made
    by ``Qwen3TTSModel.serve()``; use it as a context manager or call
    ``close()``."""

    def __init__(self, model: Qwen3TTSModel, *, slots, chunk_frames, max_frames, prompt_bucket,
                 trailing_bucket, sampling, max_queue=None):
        self._model = model
        self._kw = dict(slots=slots, chunk_frames=chunk_frames, max_frames=max_frames,
                        prompt_bucket=prompt_bucket, trailing_bucket=trailing_bucket,
                        max_queue=max_queue)
        self._sampling = sampling
        self._server = None  # made at the first submit (it needs a pad embedding)
        self._server_lock = threading.Lock()

    @property
    def model(self) -> Qwen3TTSModel:
        return self._model

    def _ensure_server(self, pad):
        # submits come from HTTP threads: two first submits at once must not
        # make two servers (each owns a cache and a worker thread)
        from .serving import Qwen3TTSServer

        m = self._model
        with self._server_lock:
            if self._server is None:
                self._server = Qwen3TTSServer(
                    m.talker_params, m.cp_params, talker_cfg=m.talker_cfg, cp_cfg=m.cp_cfg,
                    sampling=self._sampling, tts_pad_embed=pad, dtype=m.dtype,
                    kv_quant=m.kv_quant, **self._kw,
                )

    def _item(self, text, speaker, instruct, language, seed, max_tokens, temperature, top_k,
              top_p, repetition_penalty):
        """Validate, build the prompt and the server's item; warns when the
        request's cap exceeds the service's ``max_frames``."""
        from .serving import BatchItem

        m = self._model
        (embeds, trailing, pad), = m._build_batch_inputs([text], [speaker], [instruct], language)
        self._ensure_server(pad)
        cap = m._effective_max_tokens(text, max_tokens)
        if cap > self._kw["max_frames"]:
            warnings.warn(
                f"request would allow {cap} frames but the service was created with "
                f"max_frames={self._kw['max_frames']}; long texts will be truncated to that many "
                "codec frames. Create the service with a larger max_frames to avoid this.",
                stacklevel=3,
            )
        return BatchItem(prefill_embeds=embeds, trailing=trailing, max_steps=cap, seed=seed,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         repetition_penalty=repetition_penalty)

    def submit(
        self,
        text: str,
        speaker: str | None = None,
        instruct: str | None = None,
        language: str = "auto",
        seed: int = 0,
        max_tokens: int = 2048,
        temperature: float | None = None,
        top_k: int | None = None,
        top_p: float | None = None,
        repetition_penalty: float | None = None,
    ) -> Future:
        """Queue one request; returns Future[np.ndarray] (an empty waveform
        if the request sampled EOS first). The four sampling overrides apply
        to this request only and need ``serve(per_request_sampling=True)``;
        otherwise they raise ``Qwen3TTSError``, as does a value that is not
        finite, a repetition_penalty <= 0 or a seed outside [0, 2**63).
        ``cancel()`` reaches the queued request, so a request cancelled
        before admission costs no device work."""
        m = self._model
        item = self._item(text, speaker, instruct, language, seed, max_tokens, temperature,
                          top_k, top_p, repetition_penalty)
        try:
            inner = self._server.submit(item)
        except ValueError as e:  # refused overrides or values: a typed error
            raise Qwen3TTSError(str(e)) from None

        class _ServiceFuture(Future):
            def cancel(self):
                inner.cancel()
                return super().cancel()

        outer = _ServiceFuture()

        def vocode(f):
            if f.cancelled():
                outer.cancel()
                return
            if not outer.set_running_or_notify_cancel():
                return
            try:
                out = f.result()
                if out.n_frames == 0:
                    outer.set_result(np.zeros((0,), np.float32))
                else:
                    outer.set_result(m._decode_codes_list([out.codes])[0])
            except BaseException as ex:  # noqa: BLE001  (handed to the caller)
                outer.set_exception(ex)

        inner.add_done_callback(vocode)
        return outer

    def submit_stream(
        self,
        text: str,
        speaker: str | None = None,
        instruct: str | None = None,
        language: str = "auto",
        seed: int = 0,
        max_tokens: int = 2048,
        audio_chunk_frames: int = 8,
        temperature: float | None = None,
        top_k: int | None = None,
        top_p: float | None = None,
        repetition_penalty: float | None = None,
        final_audio: bool = False,
    ) -> Iterator[TokenEvent | AudioChunkEvent | InfoEvent | AudioEvent]:
        """Streamed synthesis through the server's slots: the request
        decodes in lockstep with every other request in flight while this
        generator yields a ``TokenEvent`` per code-0 token and
        ``AudioChunkEvent``s about every ``audio_chunk_frames`` frames
        (windowed vocoding; the chunks tile the utterance), then one
        ``InfoEvent``; the whole utterance's ``AudioEvent`` only with
        ``final_audio``. The worker publishes coalesced snapshots between
        chunks, so a slow consumer never blocks it. Closing the generator,
        or dropping it unstarted, cancels the request: the slot is freed
        within one chunk (the JAX service's unstarted generator decoded to
        its cap). Validation and the prompt run at the call: a bad speaker
        raises here, before any event."""
        m = self._model
        if m.vocoder_params is None or m.tokenizer_config is None:
            raise Qwen3TTSError("Speech tokenizer not loaded")
        item = self._item(text, speaker, instruct, language, seed, max_tokens, temperature,
                          top_k, top_p, repetition_penalty)
        try:
            _, prog = self._server.submit_stream(item)
        except ValueError as e:
            raise Qwen3TTSError(str(e)) from None
        prompt_tokens = len(m.tokenizer.encode(text)) if m.tokenizer else 0
        gen = self._stream_slot_events(prog, prompt_tokens, audio_chunk_frames, final_audio)
        weakref.finalize(gen, prog.cancel)
        return gen

    def _stream_slot_events(self, prog, prompt_tokens, audio_chunk_frames, final_audio):
        m = self._model
        start = time.time()
        seen = 0  # frames whose TokenEvents have been yielded
        audio_emitted = 0  # frames whose PCM has been yielded
        codes, n = None, 0
        try:
            while True:
                codes, n, done = prog.wait_beyond(seen, timeout=600.0)
                for t in codes[seen:n, 0]:
                    yield TokenEvent(int(t))
                seen = n
                if audio_chunk_frames and n > 0:
                    upto = n if done else max(n - m.STREAM_LOOKAHEAD_FRAMES, 0)
                    if done:
                        need = 1
                    elif audio_emitted == 0:
                        need = min(audio_chunk_frames, m.STREAM_FIRST_AUDIO_FRAMES)
                    else:
                        need = audio_chunk_frames
                    if upto - audio_emitted >= need:
                        yield AudioChunkEvent(m._decode_audio_window(codes, audio_emitted, upto, n),
                                              audio_emitted)
                        audio_emitted = upto
                if done:
                    break
            if n == 0:
                raise Qwen3TTSError("No tokens generated")
            total = max(time.time() - start, 1e-9)
            yield InfoEvent(GenerationInfo(
                prompt_token_count=prompt_tokens, generation_token_count=n,
                prefill_time=0.0,  # folded into the shared admission
                generate_time=total, tokens_per_second=n / total,
                peak_memory_usage=_device_peak_memory_gb(m.device),
            ))
            if final_audio:
                yield AudioEvent(m._decode_codes_list([codes[:n]])[0])
        finally:
            # finished or abandoned: the slot must not decode on for nobody
            prog.cancel()

    def close(self, wait: bool = True):
        if self._server is not None:
            self._server.close(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
