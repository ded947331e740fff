"""WAV audio I/O, 24 kHz mono float32 <-> RIFF PCM (port of
qwen3tts_tpu/utils/audio.py; numpy only). The HTTP server
(``serving_http.py``) sends the bytes of ``wav_bytes`` and
``wav_stream_header``; the CLI writes ``save_wav`` files and reads
reference audio with ``load_wav``."""

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


def save_wav(path: str, samples: np.ndarray, sample_rate: int = 24000) -> None:
    """Write mono float32 samples in [-1, 1] as 16-bit PCM RIFF."""
    with open(path, "wb") as f:
        f.write(wav_bytes(samples, sample_rate))


def load_wav(path: str) -> tuple[int, np.ndarray]:
    """Read a RIFF WAV; returns (sample_rate, float32 mono samples in [-1, 1]).

    PCM16/PCM24/PCM32 and IEEE float32, any channel count (averaged to
    mono), walking the chunks as the RIFF spec lays them out."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, raw = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 3 and bits == 32:
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    elif audio_format == 1 and bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 1 and bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / (1 << 23)
    else:
        raise ValueError(f"{path}: unsupported format {audio_format}/{bits}bit")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return sample_rate, x
