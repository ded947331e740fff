"""The end-to-end and per-layer arithmetic on fixed records and spans."""

import pytest

import harness
from harness import Record, Run
from make_traffic import Request
from tracing import KernelCall, Span, device_busy


def req(frames):
    return Request(text="a b", speaker="aiden", frames=frames, seed=1, greedy=False)


def rec(t0, t1, frames, first_token=None, first_audio=None, unit=0):
    return Record(req(frames), unit, t0, t1, frames, [0.0] * (frames * 1920), None,
                  first_token, first_audio)


def metric(name, run):
    return harness.load_module("metrics", name).read(run)


def test_rtf_and_audio_rate():
    run = Run([rec(0.0, 1.0, 125), rec(1.0, 1.5, 25)], window_s=1.4, setup_s=9.0,
              units=[(0, 0.0, 1.0), (1, 1.0, 1.5)])
    assert metric("rtf", run) == pytest.approx(1.5 / 12.0)
    assert metric("audio_s_per_s", run) == pytest.approx(12.0 / 1.5)
    assert metric("setup_s", run) == 9.0


def test_latency_quantiles():
    recs = [rec(i, i + 1, 10, first_token=i + 0.01 * (j := i + 1), first_audio=i + 0.02 * j)
            for i in range(10)]
    run = Run(recs, 10.0, 1.0)
    # 20, 40, ..., 200 ms: the inclusive 90th percentile lies between 180 and 200
    assert metric("ttfa_p90_ms", run) == pytest.approx(182.0)
    assert metric("ttft_p50_ms.stream", run) == pytest.approx(55.0)
    assert metric("ttfa_p90_ms", Run([], 1.0, 1.0)) is None


def test_span_metrics():
    spans = [Span("frames", 0.0, 0.5, 0, 0, {"frames": 100}), Span("frames", 1.0, 1.25, 0, 0, {"frames": 50}),
             Span("vocoder", 0.5, 0.6, 0, 0), Span("lockstep", 2.0, 3.0, 0, 0, {"frames": 199, "rows": 64})]
    run = Run([rec(0, 1, 120), rec(0, 1, 40)], window_s=4.0, setup_s=1.0, spans=spans)
    assert metric("frame_ms.b1", run) == pytest.approx(750.0 / 150)
    assert metric("lockstep_frame_ms.b64", run) == pytest.approx(1000.0 / 199)
    assert metric("vocoder_pct.b1", run) == pytest.approx(2.5)
    assert metric("pad_waste_pct.b64", run) == pytest.approx(100 * (1 - 160 / (64 * 200)))
    assert metric("frame_ms.b1", Run([], 1.0, 1.0)) is None


def test_kernel_metrics():
    def call(entry, rows, n, fl, ms):
        c = KernelCall(entry, rows, n, fl, None, None)
        c.ms = ms
        return c
    calls = [call("qt_talker_frame", 1, 3.35e9, 0.0, 2.0), call("qt_talker_frame", 1, 3.35e9, 0.0, 2.0),
             call("qt_cp_loop", 1, 0.0, 989e9, 4.0), call("qt_talker_step", 64, 0.0, 989e10, 20.0)]
    run = Run([], window_s=2.0, setup_s=1.0, calls=calls)
    assert metric("k1_roofline.b1", run) == pytest.approx(50.0)  # 1 ms bound of 2
    assert metric("k2_roofline.b1", run) == pytest.approx(25.0)
    assert metric("k1_roofline.b64", run) == pytest.approx(50.0)
    assert metric("k2_roofline.b64", run) is None
    assert metric("step_mfu.b1", run) == pytest.approx(100 * 989e9 / (2.0 * 989e12))
    assert metric("step_mfu.b64", run) == pytest.approx(100 * 989e10 / (2.0 * 989e12))


def test_device_busy_adds_the_persistent_launches_the_profile_missed():
    c1 = KernelCall("qt_talker_frame", 1, 0, 0, None, None)
    c1.ms = 2.0
    c2 = KernelCall("qt_cp_loop", 1, 0, 0, None, None)
    c2.ms = 3.0
    recs = [("memcpy", 0, 1_000_000), ("gemm", 500_000, 2_000_000), ("cp_frame(FrameArgs)", 4_000_000, 7_000_000)]
    spans = [Span("frames", 0, 0, 0, 10_000_000)]
    busy, missed, top, gaps = device_busy(recs, [c1, c2], spans, (0, 10_000_000))
    # 2 ms merged + 3 ms recorded cp_frame + 2 ms talker_frame from its events
    assert busy == pytest.approx(0.007)
    assert missed == {"talker_frame": {"calls": 1, "recorded": 0}}
    assert dict(gaps) == {"frames": pytest.approx(0.005)}
    assert top[0][0] == "cp_frame(FrameArgs)"
    run = Run([], window_s=0.010, setup_s=0.0, busy_s=busy)
    assert metric("device_idle_pct.b1", run) == pytest.approx(30.0)


def test_finish_calls_counts_k1_from_its_widths_and_prefix():
    import torch

    from roofline import k1_io
    from tracing import Tracer

    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, end):
            return end.t - self.t

    w = dict(L=28, H=1024, NQ=16, NKV=8, D=128, I=3072, V=3072, kv_quant=False, w_bf16=False,
             head_bf16=False, sample=True)
    tr = Tracer(torch.device("cpu"))
    tr.calls = [KernelCall("qt_talker_frame", 1, 0, 0, Ev(0.0), Ev(1.5), widths=dict(w, B=1), prefix=40),
                KernelCall("qt_talker_step", 4, 0, 0, Ev(2.0), Ev(4.0), widths=dict(w, B=4),
                           prefix=torch.tensor(400))]
    tr.finish_calls()
    assert [c.ms for c in tr.calls] == [1.5, 2.0]
    args = [28, 1024, 16, 8, 128, 3072, 3072]
    assert (tr.calls[0].bytes, tr.calls[0].flops) == k1_io(*args, 1, 40, False, False, False)
    assert (tr.calls[1].bytes, tr.calls[1].flops) == k1_io(*args, 4, 400, False, False, False)
    assert tr.calls[1].widths is None and tr.calls[1].prefix is None
