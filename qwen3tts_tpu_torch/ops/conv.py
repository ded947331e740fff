"""1-D convolutions with NWC activations (port of qwen3tts_tpu/ops/conv.py).

The public functions keep the JAX package's layouts — activations
[B, T, C] and kernels conv1d [W, I, O], conv1d_transpose [W, O, I] — and
transpose to PyTorch's NCW and [O, I, W] / [I, O, W] around
``torch.nn.functional.conv1d`` / ``conv_transpose1d`` (XLA computed these
convolutions in the JAX package).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F


# Held for an exact_f32 block: the TF32 flags are one for the process.
_EXACT = threading.RLock()


@contextlib.contextmanager
def exact_f32():
    """f32 convolutions and matmuls without TF32 for the block's calls.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which would change the f32 audio models' numbers against the
    reference; the matmul flag is cleared too so the linear layers stay
    f32. The caller's settings come back after the block. The flags belong
    to the process, so blocks on several host threads run one at a time:
    none turns TF32 back on under another, and the settings saved are
    always the caller's."""
    with _EXACT:
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
    padding=((0, 0),),
) -> torch.Tensor:
    """x: [B, T, C_in], w: [W, C_in/groups, C_out] -> [B, T', C_out]."""
    (left, right), = padding
    xc = F.pad(x.transpose(1, 2).float(), (left, right))
    y = F.conv1d(xc, w.permute(2, 1, 0).float(), stride=stride, dilation=dilation, groups=groups)
    y = y.transpose(1, 2).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def causal_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Left-padded causal conv."""
    pad = (w.shape[0] - 1) * dilation
    return conv1d(x, w, b, dilation=dilation, groups=groups, padding=((pad, 0),))


def conv1d_transpose(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    stride: int = 1,
) -> torch.Tensor:
    """PyTorch-semantics ConvTranspose1d (padding=0).

    x: [B, T, C_in], w: [W, C_out, C_in] -> [B, (T-1)*stride + W, C_out].
    """
    y = F.conv_transpose1d(x.transpose(1, 2).float(), w.permute(2, 1, 0).float(), stride=stride)
    y = y.transpose(1, 2).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def causal_conv1d_transpose(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *, stride: int = 1
) -> torch.Tensor:
    """Transpose conv trimmed to a causal output of exactly T*stride samples."""
    y = conv1d_transpose(x, w, b, stride=stride)
    trim = w.shape[0] - stride
    if trim > 0:
        y = y[:, :-trim]
    return y


def streamable_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    *,
    stride: int = 1,
    dilation: int = 1,
    causal: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Mimi-style conv with exact-frame extra padding: a left pad of
    (k_eff - stride) for causality (split around the centre when not
    ``causal``) and a right pad that completes the last frame, so that the
    strided conv consumes the input exactly. ``pad_mode`` "edge" repeats the
    boundary sample, else zeros. x: [B, T, C_in], w: [W, C_in, C_out]."""
    k = w.shape[0]
    k_eff = (k - 1) * dilation + 1
    length = x.shape[1]
    padding_total = k_eff - stride
    nframes = max(length + padding_total - k_eff, 0) / stride + 1.0
    ideal = (math.ceil(nframes) - 1) * stride + k_eff - padding_total
    extra = max(0, ideal - length)
    if causal:
        left, right = padding_total, extra
    else:
        right = padding_total // 2 + extra
        left = padding_total - padding_total // 2
    if pad_mode == "edge":
        x = F.pad(x.transpose(1, 2), (left, right), mode="replicate").transpose(1, 2)
        left = right = 0
    return conv1d(x, w, b, stride=stride, dilation=dilation, padding=((left, right),))
