"""What the experiment scripts of this package share: the card they need,
its name and power limit (printed beside every number), CUDA-event timing,
the bound of a memory-bound call, and the 0.6B int8 talker they stream."""

from __future__ import annotations

import subprocess

import torch

from ..config import CodePredictorConfig, TalkerConfig

HBM_BYTES_S = 3.35e12  # H100 SXM data sheet, at the 700 W power limit


def require_cuda(what: str) -> torch.device:
    """The first CUDA device; a script that measures the card has no CPU
    fallback."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda:0")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` over ``iters`` calls back to back, after
    one warm-up call (CUDA events on the current stream)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(n_bytes: int) -> float:
    """The least time to move ``n_bytes`` at the card's published rate."""
    return n_bytes / HBM_BYTES_S * 1e3


def talker_06b() -> TalkerConfig:
    """The 0.6B CustomVoice talker's widths (``__graft_entry__._flagship_06b``)."""
    return TalkerConfig(
        vocab_size=3072, text_vocab_size=151936, hidden_size=1024, text_hidden_size=1024,
        intermediate_size=3072, num_hidden_layers=28, num_attention_heads=16,
        num_key_value_heads=8, head_dim=128,
        code_predictor_config=CodePredictorConfig(
            vocab_size=2048, hidden_size=1024, intermediate_size=3072, num_hidden_layers=5,
            num_attention_heads=16, num_key_value_heads=8, head_dim=128,
        ),
    )


def int8_talker(cfg: TalkerConfig, device, seed: int = 0) -> dict:
    """host_init talker weights at ``cfg``'s widths, fused (qkv, gate_up) and
    quantized to int8 with per-channel scales, as bench.py serves them."""
    from ..models import talker as tk
    from ..ops.quant import quantize_decode_params_int8
    from ..utils import host_init as hi

    params = hi.to_device(hi.host_init_talker_params(seed, cfg), torch.bfloat16, device)
    params["layers"] = tk.fuse_layer_projections(params["layers"])
    return quantize_decode_params_int8(params, "codec_head")
