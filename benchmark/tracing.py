"""What a traced run (``--trace 1``) records, from the benchmark's own
files: host spans around the calls into the program's layers, CUDA events
around each K1 and K2 launch, and the profiler's device timeline.

Spans wrap module attributes that the program looks up at each call
(``generate.prefill_start``, ``generate.generate_chunk``,
``batch_generate.prefill_start_batch``, ``batch_generate.
generate_chunk_batch``, ``vocoder.decode``); each ends in a
``torch.cuda.synchronize()``, so its length holds the device work it
enqueued. K1 and K2 are timed by events recorded on the stream right
before and after their C entries (``qt_talker_frame``, ``qt_talker_step``,
``qt_cp_loop``), whose arguments give each call's widths and rows.
Everything is undone by ``close``.

The profiler does not record the persistent cooperative launches of K1's
and K2's one-row forms (``talker_frame``, ``cp_frame``). ``device_busy``
compares the launches it recorded under those names with the calls made
and adds the event-timed length of each call it missed.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from roofline import bound_s, k1_args, k1_io, k2_args, k2_io

PERSISTENT = {"qt_talker_frame": "talker_frame", "qt_cp_loop": "cp_frame"}


@dataclass
class Span:
    name: str
    t0: float  # perf_counter
    t1: float
    wall0_ns: int  # time.time_ns at the start, the profiler's clock
    wall1_ns: int
    info: dict = field(default_factory=dict)


@dataclass
class KernelCall:
    entry: str  # the C entry
    rows: int
    bytes: float
    flops: float
    start: object  # torch.cuda.Event
    end: object
    widths: dict | None = None  # K1: k1_args of the call, its bytes counted after the window
    prefix: object = None  # K1: the cache rows its rows read (at B > 1 a device scalar)
    ms: float = 0.0


class Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.spans: list[Span] = []
        self.calls: list[KernelCall] = []
        self._undo: list = []
        self._stack: list[str] = []
        self._prefix = None

    # -- spans ------------------------------------------------------------

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def wrap(self, module, attr: str, name: str, info=None):
        """Replace ``module.attr`` by a spanned call; ``info(args, kwargs,
        result)`` adds the span's counts."""
        fn = getattr(module, attr)
        tracer = self

        def spanned(*args, **kwargs):
            t0, w0 = time.perf_counter(), time.time_ns()
            tracer._stack.append(name)
            try:
                out = fn(*args, **kwargs)
                tracer._sync()
            finally:
                tracer._stack.pop()
            tracer.spans.append(Span(name, t0, time.perf_counter(), w0, time.time_ns(),
                                     info(args, kwargs, out) if info else {}))
            return out

        setattr(module, attr, spanned)
        self._undo.append((module, attr, fn))

    # -- kernels ------------------------------------------------------------

    def wrap_library(self, lib, talker_kernel_module):
        """Time every K1 and K2 C entry by events; K1 at B > 1 also notes
        its rows' summed offsets (read after the window)."""
        tracer = self
        for entry in ("qt_talker_frame", "qt_talker_step", "qt_cp_loop"):
            fn = getattr(lib, entry)

            def timed(*a, _fn=fn, _entry=entry):
                if _entry == "qt_cp_loop":
                    w = k2_args(a)
                    n, fl = k2_io(**{k: w[k] for k in ("L", "H", "NQ", "NKV", "D", "I", "V", "NCB",
                                                       "B", "TH", "w_bf16", "head_bf16")})
                    call = KernelCall(_entry, w["B"], n, fl, None, None)
                else:
                    w = k1_args(a, batched=_entry == "qt_talker_step")
                    call = KernelCall(_entry, w["B"], 0.0, 0.0, None, None, widths=w,
                                      prefix=w["pos"] if w["B"] == 1 else tracer._prefix)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                rc = _fn(*a)
                end.record()
                call.start, call.end = start, end
                tracer.calls.append(call)
                return rc

            setattr(lib, entry, timed)
            self._undo.append((lib, entry, fn))
        step = talker_kernel_module.talker_decode_step

        def noting(params, cfg, x, cache, offs, *args, **kwargs):
            if isinstance(offs, torch.Tensor):
                tracer._prefix = offs.to(torch.int64).sum()
            return step(params, cfg, x, cache, offs, *args, **kwargs)

        for attr in ("launches", "mode_launches", "persistent_launches"):
            setattr(noting, attr, getattr(step, attr))
        talker_kernel_module.talker_decode_step = noting
        self._undo.append((talker_kernel_module, "talker_decode_step", step))

    def finish_calls(self):
        """Read every call's event time and K1's byte counts (after a sync)."""
        self._sync()
        for c in self.calls:
            c.ms = c.start.elapsed_time(c.end)
            if c.widths is not None:
                w = c.widths
                c.bytes, c.flops = k1_io(
                    w["L"], w["H"], w["NQ"], w["NKV"], w["D"], w["I"], w["V"], w["B"],
                    int(c.prefix), w["kv_quant"], w["w_bf16"], w["head_bf16"], w["sample"])
                c.widths = c.prefix = None

    def close(self):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


def kernel_summary(calls: list[KernelCall], batched: bool, entries) -> dict | None:
    """{"bound_s", "event_s", "flops", "calls"} of the calls of ``entries``
    at one row (``batched`` False) or more."""
    sel = [c for c in calls if c.entry in entries and (c.rows > 1) == batched]
    if not sel:
        return None
    return dict(bound_s=sum(bound_s(c.bytes, c.flops) for c in sel),
                event_s=sum(c.ms for c in sel) / 1e3, flops=sum(c.flops for c in sel),
                calls=len(sel))


def _attr(e, name, scale=1):
    f = getattr(e, name, None)
    return f() * scale if f is not None else None


def device_records(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device record in the profiler's
    window: kernels, copies and memsets."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = _attr(e, "start_ns")
        if start is None:
            start = _attr(e, "start_us", 1000)
        dur = _attr(e, "duration_ns")
        if dur is None:
            dur = _attr(e, "duration_us", 1000)
        out.append((e.name(), int(start), int(start + dur)))
    return out


def device_busy(records, calls: list[KernelCall], spans: list[Span], window_ns: tuple[int, int]):
    """(busy seconds, missed persistent launches, top device operations,
    idle seconds by the host span it fell in) over the window."""
    lo, hi = window_ns
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in records if e > lo and s < hi)
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e9
    by_name: dict[str, float] = defaultdict(float)
    for name, s, e in records:
        by_name[name] += (e - s) / 1e9
    missed = {}
    for entry, kernel in PERSISTENT.items():
        made = [c for c in calls if c.entry == entry and c.rows == 1]
        seen = sum(1 for name, _, _ in records if kernel in name)
        if made and seen < len(made):
            gone = len(made) - seen
            extra = sum(c.ms for c in made) / 1e3 * gone / len(made)
            busy += extra
            by_name[f"{kernel} (event-timed, not in the profile)"] += extra
            missed[kernel] = dict(calls=len(made), recorded=seen)
    # idle gaps between merged intervals, labelled by the innermost host span
    gaps: dict[str, float] = defaultdict(float)
    edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
    ordered = sorted(spans, key=lambda s: s.wall1_ns - s.wall0_ns)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        label = next((s.name for s in ordered if s.wall0_ns <= mid <= s.wall1_ns), "between calls")
        gaps[label] += (b - a) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return busy, missed, top, sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
