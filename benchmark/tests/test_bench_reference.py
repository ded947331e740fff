"""The plain reference against the port at tiny widths on the CPU: what the
port serves lies within its rounding of the reference, and the control (the
reference one precision step lower) does not."""

import json

import pytest
import torch

import control
import harness
from tiny import BENCH, tiny_cfg

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = {c["name"]: c for c in SPEC["workloads"]}
SMALL = dict(frames=[8, 20], words=[4, 12], greedy_every=2, check_frames=30)


def small_traffic(cell):
    t = harness.load_json("traffic", cell["traffic"])
    t.update(SMALL, pool=4 if t["batch"] > 1 else 8)
    if t["batch"] > 1:
        t["batch"] = 4
    return t


def cfg_of(cell):
    return tiny_cfg(cell["config"], projection=cell["config"].startswith("cv17"))


@pytest.mark.parametrize("name", list(CELLS))
def test_port_agrees_with_the_reference_and_the_control_does_not(name):
    cell = CELLS[name]
    torch.manual_seed(0)
    r = control.readings(cell, 2**31 + 5, True, torch.device("cpu"), cfg=cfg_of(cell),
                         traffic=small_traffic(cell))
    prog, ctrl = r["program"], r["control"]
    assert prog["short_requests"] == 0 and prog["checked_frames"] >= 20
    assert prog["code0_gap"] < 0.1 and prog["cp_gap"] < 0.2 and prog["wav_err"] < 5e-3
    assert ctrl["code0_gap"] > 3 * max(prog["code0_gap"], 0.05)
    assert ctrl["cp_gap"] > 3 * prog["cp_gap"]


def test_reference_prompt_matches_the_ports():
    from qwen3tts_tpu_torch import config as C
    from reference.model import CHAT_ASSISTANT, Reference

    cell = CELLS["cv06b-int8.single"]
    bench = harness.Bench(cfg_of(cell), small_traffic(cell), torch.device("cpu"), 3)
    rows, trailing, pad = Reference(bench.cfg, bench.talker_w, bench.cp_w, bench.voc_w).prompt(
        bench.model.tokenizer.encode(CHAT_ASSISTANT.format("one two three four five six")), "ryan")
    e, t, p = bench.model._prepare_generation_inputs("one two three four five six", "auto", "ryan")
    assert isinstance(bench.model.config, C.ModelConfig)
    assert rows.shape == e[0].shape and trailing.shape == t.shape
    for a, b in ((rows, e[0]), (trailing, t), (pad, p)):
        assert (a - b.float()).abs().max() <= 0.01 * b.float().abs().max()
