"""Arithmetic shared by the metric readers (``metrics/<name>.py``). Each
returns None where the run holds nothing to read."""

from __future__ import annotations

from harness import quantile
from roofline import PEAK_BF16_FLOP_S
from tracing import kernel_summary

K1 = ("qt_talker_frame", "qt_talker_step")
K2 = ("qt_cp_loop",)


def per_frame_ms(run, span: str) -> float | None:
    """Span time over the frames the spans report, in ms a frame."""
    spans = [s for s in run.spans if s.name == span]
    frames = sum(s.info["frames"] for s in spans)
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / frames if frames else None


def span_share_pct(run, span: str) -> float | None:
    spans = [s for s in run.spans if s.name == span]
    return 100.0 * sum(s.t1 - s.t0 for s in spans) / run.window_s if spans else None


def roofline_pct(run, entries, batched: bool) -> float | None:
    """The calls' least time by their bytes and operations over their event
    time, in %."""
    k = kernel_summary(run.calls, batched, entries)
    return 100.0 * k["bound_s"] / k["event_s"] if k and k["event_s"] > 0 else None


def step_mfu_pct(run, batched: bool) -> float | None:
    """K1's and K2's operations over the window at the bf16 peak, in %."""
    ks = [kernel_summary(run.calls, batched, e) for e in (K1, K2)]
    if not any(ks):
        return None
    return 100.0 * sum(k["flops"] for k in ks if k) / (run.window_s * PEAK_BF16_FLOP_S)


def idle_pct(run) -> float | None:
    return None if run.busy_s is None else 100.0 * (1.0 - run.busy_s / run.window_s)


def latency_ms(run, attr: str, q: float) -> float | None:
    """The q-quantile over every request of the time from its call to the
    event ``attr`` records, in ms."""
    xs = [(getattr(r, attr) - r.t0) * 1e3 for r in run.records if getattr(r, attr) is not None]
    return quantile(xs, q)
