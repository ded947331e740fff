"""BENCHMARK.json and the files the harness finds by name."""

import json
import re

import pytest

import harness
from tiny import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    for cell in SPEC["workloads"]:
        cfg = harness.load_json("configs", cell["config"])
        traffic = harness.load_json("traffic", cell["traffic"])
        limits = harness.load_json("limits", cell["name"])
        assert harness.load_module("drivers", traffic["driver"]).serve
        assert set(limits) == {"short_requests", "code0_gap", "cp_gap", "wav_err"}
        assert cfg["name"] == cell["config"] and cell["chips"] == 1
        assert NAME.match(cell["name"]) and len(cell["why"]) <= 200


def test_every_metric_has_a_reader_and_its_cells_report_what_it_moves():
    cells = {c["name"] for c in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and hasattr(harness.load_module("metrics", m["name"]), "read")
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        assert {"setup_s"} < {m["name"] for m in harness.metric_names(SPEC, cell, False)}
        assert harness.metric_names(SPEC, cell, True)


def test_configs_keep_the_published_widths():
    for c in SPEC["configs"]:
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert c["reduced"] == [] and cfg["source"] == c["source"]
        t = cfg["talker_config"]
        assert (t["num_hidden_layers"], t["num_attention_heads"], t["num_key_value_heads"],
                t["head_dim"], t["vocab_size"], t["text_vocab_size"]) == (28, 16, 8, 128, 3072, 151936)
        assert (t["hidden_size"], t["intermediate_size"]) in ((1024, 3072), (2048, 6144))
        cp = t["code_predictor_config"]
        assert (cp["hidden_size"], cp["num_hidden_layers"], cp["vocab_size"]) == (1024, 5, 2048)


@pytest.mark.parametrize("name", ["rtf", "k1_roofline.b1"])
def test_a_metric_loads_by_a_dotted_name(name):
    assert harness.load_module("metrics", name).read(harness.Run([], 1.0, 1.0)) is None
