"""What the experiment scripts of this package share: the card they need,
its name and power limit (printed beside every number), CUDA-event,
queued and profiler timing, the bound of a memory-bound call, and the 0.6B int8 talker
they stream."""

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


def queued_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` over ``iters`` calls that wait queued on
    the card behind a spin kernel and then run back to back, whatever the
    host's launch path costs (CUDA events around them; ``fn`` must not wait
    on the card), after one warm-up call. No profiler: its windows can drop
    records. If the spin ended before the host had queued every call, the
    card waited on the host; the window is taken again with a spin twice as
    long (six tries)."""
    fn()
    torch.cuda.synchronize()
    spin = 1 << 24  # cycles, ~10 ms
    for _ in range(6):
        spun = torch.cuda.Event()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        spun.record()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        queued = not spun.query()
        torch.cuda.synchronize()
        if queued:
            return a.elapsed_time(b) / iters
        spin *= 2
    raise RuntimeError(f"the host did not queue {iters} calls within a spin of {spin // 2} cycles")


def _is_kernel(name: str) -> bool:
    """A device record of a kernel, not of a copy or a memset."""
    return not name.startswith(("Memcpy", "Memset"))


def device_ms(fn, iters: int, per_call: int | None = None) -> float:
    """Device ms per call of ``fn``: the sum of its device records' times
    (kernels, copies, memsets) over ``iters`` calls (torch.profiler),
    without the host time between them, after one warm-up call.

    A profiler window can drop records and then reads short (on an H100,
    1 window in ~200 recorded a part of its kernels, and three in a row
    recorded 0, 0 and 49 of 50). With ``per_call``, the kernels one call
    launches, a window is read only if it recorded exactly
    ``iters * per_call`` kernels; without it, from the third window on,
    only if another window recorded as many kernels, the most that two
    windows recorded (a count above 0). One window alone never sets the
    count: on an H100 ten windows of one run recorded 0, 0, 0, 20, 0, 20,
    20, 15, 20 and 20 kernels, and of another's ten, nine recorded 2246 and
    one 2270. Ten windows at most, then it raises."""
    return sum(device_ms_by_kernel(fn, iters, per_call).values())


def device_ms_by_kernel(fn, iters: int, per_call: int | None = None) -> dict[str, float]:
    """``device_ms`` split by record name: {kernel, copy or memset name:
    device ms per call}, from one window held to the same rule."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen, windows = [], []
    for i in range(10):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        recs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name: dict[str, float] = {}
        for e in recs:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1000 / iters
        kernels = sum(_is_kernel(e.name) for e in recs)
        seen.append(kernels)
        windows.append((kernels, by_name))
        if per_call is not None:
            if kernels == iters * per_call:
                return by_name
        elif i >= 2:
            twice = [k for k in set(seen) if k > 0 and seen.count(k) >= 2]
            for k, b in windows:
                if twice and k == max(twice) and sum(b.values()) > 0:
                    return b
    want = f"{iters * per_call}" if per_call is not None else "a count above 0 in two windows"
    raise RuntimeError(f"ten profiler windows recorded {seen} kernels, not {want}")


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
