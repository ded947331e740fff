"""ECAPA-TDNN speaker encoder and its mel spectrogram, for voice cloning
(port of qwen3tts_tpu/models/speaker_encoder.py): 24 kHz reference audio ->
an x-vector (1024-d at the checkpoint's widths).

Mel: n_fft 1024, 128 mels, hop 256, fmax 12 kHz, log-clamped, from a framed
rFFT (``torch.fft.rfft``). Then TDNN (k 5) -> 3 SE-Res2Net blocks (scale 8,
dilations 2/3/4) -> multi-layer feature aggregation -> attentive statistics
pooling (mean || std) -> a 1x1 conv. Channels-last ([B, T, C]) throughout;
the convolutions are plain PyTorch (cuDNN on the card), in f32 without TF32
(``ops.conv.exact_f32``), as XLA computed them in the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SpeakerEncoderConfig
from ..ops.conv import conv1d, exact_f32

Params = dict[str, Any]


def hann_window(size: int) -> np.ndarray:
    n = np.arange(size, dtype=np.float32)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / (size - 1)))).astype(np.float32)


def mel_filterbank(
    n_fft: int, num_mels: int, sample_rate: int, f_min: float, f_max: float
) -> np.ndarray:
    """Triangular mel filterbank [n_fft // 2 + 1, num_mels] with integer-bin
    edges (numpy, the JAX package's own)."""

    def hz_to_mel(hz):
        return 2595.0 * np.log10(1.0 + hz / 700.0)

    def mel_to_hz(mel):
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), num_mels + 2)
    bins = np.floor((n_fft + 1) * mel_to_hz(mel_pts) / sample_rate).astype(int)
    num_freqs = n_fft // 2 + 1
    fb = np.zeros((num_freqs, num_mels), np.float32)
    for m in range(num_mels):
        left, center, right = bins[m], bins[m + 1], bins[m + 2]
        for k in range(left, center):
            if k < num_freqs and center > left:
                fb[k, m] = (k - left) / (center - left)
        for k in range(center, right):
            if k < num_freqs and right > center:
                fb[k, m] = (right - k) / (right - center)
    return fb


def mel_spectrogram(
    audio: torch.Tensor,
    *,
    n_fft: int = 1024,
    num_mels: int = 128,
    sample_rate: int = 24000,
    hop: int = 256,
    f_min: float = 0.0,
    f_max: float = 12000.0,
) -> torch.Tensor:
    """audio [samples] or [B, samples] -> log-mel [B, frames, mels] f32."""
    if audio.dim() == 1:
        audio = audio[None]
    pad = n_fft // 2
    x = F.pad(audio.float(), (pad, pad))
    num_frames = (x.shape[1] - n_fft) // hop + 1
    window = torch.from_numpy(hann_window(n_fft)).to(x.device)
    frames = x.unfold(1, n_fft, hop)[:, :num_frames] * window  # [B, frames, n_fft]
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2  # [B, frames, n_fft // 2 + 1]
    fb = torch.from_numpy(mel_filterbank(n_fft, num_mels, sample_rate, f_min, f_max)).to(x.device)
    return torch.log(torch.clamp_min(power @ fb, 1e-10))


def _reflect_pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return x
    return F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)


def tdnn_block(p: Params, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """Conv1d with reflect 'same' padding, then ReLU. x: [B, T, C]."""
    k = p["w"].shape[0]
    pad = (k - 1) * dilation // 2
    return torch.relu(conv1d(_reflect_pad_time(x, pad), p["w"], p["b"], dilation=dilation))


def res2net_block(p: Params, x: torch.Tensor, scale: int, dilation: int) -> torch.Tensor:
    """Multi-scale residual conv block. x: [B, T, C]."""
    chunk = x.shape[-1] // scale
    outs = []
    part = None
    for i in range(scale):
        piece = x[..., i * chunk : (i + 1) * chunk]
        if i == 0:
            part = piece
        elif i == 1:
            part = tdnn_block(p["blocks"][i - 1], piece, dilation)
        else:
            part = tdnn_block(p["blocks"][i - 1], piece + part, dilation)
        outs.append(part)
    return torch.cat(outs, dim=-1)


def se_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Squeeze-excitation channel attention. x: [B, T, C]."""
    s = x.mean(dim=1, keepdim=True)
    s = torch.relu(conv1d(s, p["conv1"]["w"], p["conv1"]["b"]))
    s = torch.sigmoid(conv1d(s, p["conv2"]["w"], p["conv2"]["b"]))
    return x * s


def se_res2net_block(p: Params, x: torch.Tensor, scale: int, dilation: int) -> torch.Tensor:
    h = tdnn_block(p["tdnn1"], x, 1)
    h = res2net_block(p["res2net_block"], h, scale, dilation)
    h = tdnn_block(p["tdnn2"], h, 1)
    return se_block(p["se_block"], h) + x


def attentive_stats_pooling(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Attention-weighted mean || std pooling. x: [B, T, C] -> [B, 1, 2C]."""
    eps = 1e-12
    mean = x.mean(dim=1, keepdim=True)
    std = torch.sqrt(x.var(dim=1, keepdim=True, unbiased=False) + eps)
    attn = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
    attn = torch.tanh(tdnn_block(p["tdnn"], attn, 1))
    attn = torch.softmax(conv1d(attn, p["conv"]["w"], p["conv"]["b"]), dim=1)  # over time
    w_mean = (attn * x).sum(dim=1, keepdim=True)
    w_var = (attn * (x - w_mean) ** 2).sum(dim=1, keepdim=True)
    w_std = torch.sqrt(torch.clamp_min(w_var, eps))
    return torch.cat([w_mean, w_std], dim=-1)


def forward(params: Params, cfg: SpeakerEncoderConfig, mels: torch.Tensor) -> torch.Tensor:
    """mels [B, T, mel_dim] -> x-vector [B, enc_dim]."""
    scale = cfg.enc_res2net_scale
    h0 = tdnn_block(params["blocks"][0], mels, cfg.enc_dilations[0])
    h1 = se_res2net_block(params["blocks"][1], h0, scale, cfg.enc_dilations[1])
    h2 = se_res2net_block(params["blocks"][2], h1, scale, cfg.enc_dilations[2])
    h3 = se_res2net_block(params["blocks"][3], h2, scale, cfg.enc_dilations[3])
    h = tdnn_block(params["mfa"], torch.cat([h1, h2, h3], dim=-1), cfg.enc_dilations[4])
    h = attentive_stats_pooling(params["asp"], h)
    return conv1d(h, params["fc"]["w"], params["fc"]["b"])[:, 0]  # [B, enc_dim]


def extract_embedding(params: Params, cfg: SpeakerEncoderConfig, audio: torch.Tensor):
    """audio [samples] at 24 kHz -> x-vector [1, enc_dim] f32."""
    with exact_f32():
        mels = mel_spectrogram(audio, n_fft=1024, num_mels=cfg.mel_dim,
                               sample_rate=cfg.sample_rate, hop=256, f_min=0.0, f_max=12000.0)
        return forward(params, cfg, mels)
