"""16-bit PCM RIFF bytes of 24 kHz mono float32 audio (port of the byte
writers of qwen3tts_tpu/utils/audio.py; numpy only). The HTTP server
(``serving_http.py``) sends these."""

from __future__ import annotations

import struct

import numpy as np


def _fmt(sample_rate: int) -> bytes:
    """The "fmt " chunk of 16-bit mono PCM."""
    return b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)


def pcm16_bytes(samples: np.ndarray) -> bytes:
    """Mono float32 samples in [-1, 1] -> raw little-endian PCM16 bytes."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    return (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def wav_bytes(samples: np.ndarray, sample_rate: int = 24000) -> bytes:
    """Mono float32 samples in [-1, 1] -> 16-bit PCM RIFF bytes."""
    pcm = pcm16_bytes(samples)
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE" + _fmt(sample_rate)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def wav_stream_header(sample_rate: int = 24000) -> bytes:
    """RIFF header of a 16-bit mono PCM stream of unknown length: both chunk
    sizes 0xFFFFFFFF (the open-ended marker of live streams); raw PCM16
    frames follow it."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE" + _fmt(sample_rate)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))
