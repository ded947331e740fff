#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own sizes, several seeds in one process (the benchmark's own runs do
not run this):

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--control <k>]

For each seed it makes the weights and the program's int8 model, serves the
cell's greedy units through the cell's driver until they hold the longest
greedy size of the mix and as many frames as a run compares, and prints,
as one JSON line, the numbers compared for the program (the lower
readings) and, for the first ``--control`` seeds, for the control: the
reference computed one step below the configuration's precision (int4
weights for the talker and the CP, TF32 for the vocoder) put in the
program's place (the upper readings).
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402
import make_traffic  # noqa: E402


def readings(cell: dict, seed: int, control: bool, device, cfg=None, traffic=None) -> dict:
    """The numbers compared for the program at ``seed`` and, with
    ``control``, for the control on the same served tokens."""
    import torch

    cfg = cfg or harness.load_json("configs", cell["config"])
    traffic = traffic or harness.load_json("traffic", cell["traffic"])
    driver = harness.load_module("drivers", traffic["driver"])
    bench = harness.Bench(cfg, traffic, device, seed)
    longest = max(f for _, f, g in make_traffic.sizes(traffic) if g or traffic["batch"] > 1)
    records = []
    for unit in make_traffic.units(traffic, bench.speakers, seed):
        if not unit.requests[0].greedy:
            continue
        records += driver.serve(bench, unit)
        frames = sum(r.frames for r in records)
        if max(r.frames for r in records) >= longest and frames >= traffic["check_frames"]:
            break
    bench.model = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "program": harness.check_outputs(bench, records, seed,
                                                          traffic["check_frames"])}
    if control:
        out["control"] = harness.check_outputs(bench, records, seed, traffic["check_frames"],
                                               control=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = ap.parse_args(argv)
    harness.env_dirs(HERE.parent)
    with open(HERE.parent / "BENCHMARK.json") as f:
        cell = next(w for w in json.load(f)["workloads"] if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    from qwen3tts_tpu_torch.ops import _cuda

    _cuda.library()
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        out = readings(cell, seed, i < args.control, torch.device("cuda:0"))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
