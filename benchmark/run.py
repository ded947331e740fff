#!/usr/bin/env python3
"""The benchmark of qwen3tts_tpu_torch: one run of one cell on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes the configuration's weights on
the card from the seed, builds the program's int8 model, warms every shape
of the cell's traffic, then serves the traffic for ``--seconds`` seconds
and finishes the unit in flight. With ``--trace 0`` it prints the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (host spans,
CUDA events around K1 and K2, the profiler's device timeline). After the
window it checks a sample of what the window served against the plain
reference (``reference/``) and prints each number compared beside its limit,
last on standard error and last in the result, the JSON object on the last
line of standard output.

It exits with a code other than 0, printing no result, without a CUDA card
(or with fewer than the cell asks for), when the program is not in the
checkout, and when JAX or the JAX package is loaded once the window has
closed.
"""

import time

T0 = time.perf_counter()  # set-up counts from here: imports, build, weights, warm-up

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import harness  # noqa: E402
import make_traffic  # noqa: E402


def run_cell(spec: dict, cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
             cfg: dict | None = None, traffic: dict | None = None, limits: dict | None = None,
             fault=None):
    """One run of ``cell``; returns (result dict, stderr lines), or (None,
    lines) when the run may print no result. ``cfg``, ``traffic``, ``limits``
    and ``fault`` (a context manager around the window) are for tests."""
    import torch

    import qwen3tts_tpu_torch
    from qwen3tts_tpu_torch import tts

    if ROOT not in Path(qwen3tts_tpu_torch.__file__).resolve().parents:
        return None, [f"the program under test is not in this checkout: {qwen3tts_tpu_torch.__file__}"]
    cfg = cfg or harness.load_json("configs", cell["config"])
    traffic = traffic or harness.load_json("traffic", cell["traffic"])
    limits = limits or harness.load_json("limits", cell["name"])
    driver = harness.load_module("drivers", traffic["driver"])
    cuda = device.type == "cuda"
    if cuda:
        from qwen3tts_tpu_torch.ops import _cuda

        _cuda.library()
    bench = harness.Bench(cfg, traffic, device, seed)
    for unit in make_traffic.warm_units(traffic, bench.speakers, seed, tts.GEN_BUCKETS):
        driver.serve(bench, unit)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    tracer = prof = None
    if trace:
        import tracing as tr
        from qwen3tts_tpu_torch.models import batch_generate as bg
        from qwen3tts_tpu_torch.models import generate as gen
        from qwen3tts_tpu_torch.models import vocoder as vc

        tracer = tr.Tracer(device)
        frames = lambda a, k, out: {"frames": out.step - a[2].step}  # noqa: E731
        tracer.wrap(gen, "prefill_start", "prefill")
        tracer.wrap(gen, "generate_chunk", "frames", frames)
        tracer.wrap(bg, "prefill_start_batch", "prefill")
        tracer.wrap(bg, "generate_chunk_batch", "lockstep",
                    lambda a, k, out: {"frames": out.step - a[2].step, "rows": out.codes.shape[0]})
        tracer.wrap(vc, "decode", "vocoder")
        if cuda:
            from qwen3tts_tpu_torch.ops import talker_kernel

            tracer.wrap_library(_cuda.library(), talker_kernel)
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()

    units = make_traffic.units(traffic, bench.speakers, seed)
    records, walls, attempted, failed = [], [], 0, 0
    lines = []
    w0_ns, start = time.time_ns(), time.perf_counter()
    deadline = start + seconds
    with fault() if fault else contextlib.nullcontext():
        while time.perf_counter() < deadline:
            unit = next(units)
            attempted += len(unit.requests)
            u0 = time.perf_counter()
            try:
                records += driver.serve(bench, unit)
            except Exception as e:  # a failed unit ends the window: its state is unknown
                failed += len(unit.requests)
                lines.append(f"unit {unit.index} failed: {type(e).__name__}: {e}")
                break
            walls.append((unit.index, u0, time.perf_counter()))
    end = time.perf_counter()
    w1_ns = time.time_ns()
    window_s = end - start
    run = harness.Run(records, window_s, setup_s, units=walls)
    breakdown = None
    if tracer is not None:
        import tracing as tr

        records_dev = []
        if prof is not None:
            prof.__exit__(None, None, None)
            records_dev = tr.device_records(prof)
        tracer.close()
        tracer.finish_calls()
        run.spans, run.calls = tracer.spans, tracer.calls
        busy, missed, top, gaps = tr.device_busy(records_dev, tracer.calls, tracer.spans,
                                                 (w0_ns, w1_ns))
        run.busy_s = busy
        breakdown = {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}
        for kernel, m in missed.items():
            lines.append(f"profiler recorded {m['recorded']} of {m['calls']} {kernel} launches; "
                         "the rest are added by their event times")

    bad = harness.forbidden_modules()
    if bad:
        return None, lines + [f"loaded after the window: {', '.join(bad)}"]
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    bench.model = None  # the program's state goes before the reference runs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = harness.check_outputs(bench, records, seed, traffic["check_frames"])
    ok, shown = harness.judge(checks, limits)
    correct = ok and failed == 0 and bool(records)
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": attempted - len(records),
        "metrics": harness.read_metrics(harness.metric_names(spec, cell["name"], trace), run),
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"].update(busy_s=run.busy_s, window_s=window_s)
        result["breakdown"] = breakdown
    result["checks"] = shown
    lines += [f"checked frames {checks.get('checked_frames', 0):.0f}"]
    lines += [f"{k} {v['value']!r} limit {v['limit']!r}" for k, v in shown.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.env_dirs(ROOT)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded before the run: {', '.join(bad)}", file=sys.stderr)
        return 2
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    try:
        result, lines = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                                 torch.device("cuda:0"), T0)
    except ModuleNotFoundError as e:
        print(f"the program under test cannot be imported: {e}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    if result is None:
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
