"""Qwen3-TTS inference in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``qwen3tts_tpu`` (JAX/Pallas on a TPU). Module names mirror the
JAX package so each module's counterpart is easy to find; the JAX package
stays the reference the tests hold this one against. This package imports
``torch`` and never ``jax``.
"""

from .tts import (
    AsyncEventStream,
    AudioChunkEvent,
    AudioEvent,
    GenerationInfo,
    InfoEvent,
    Qwen3TTSError,
    Qwen3TTSModel,
    TokenEvent,
)

__all__ = [
    "AsyncEventStream", "AudioChunkEvent", "AudioEvent", "GenerationInfo", "InfoEvent",
    "Qwen3TTSError", "Qwen3TTSModel", "TokenEvent",
]
