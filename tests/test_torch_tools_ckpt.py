"""The port's checkpoint tools against the JAX package's: the parity
harness (qwen3tts_tpu_torch/tools/parity_harness.py, whose dump the JAX
harness's ``--compare`` reads), the key-listing diagnostic
(qwen3tts_tpu_torch/tools/inspect_ckpt.py, the cases of
tests/test_inspect_ckpt.py mirrored), the port's own copy of the
checkpoint weight functions (tools/ckpt_layout.py), and the packaging of the port.

The harnesses run greedy at 6 frames on the CPU, the JAX one on the port's
synthetic checkpoint; ``--compare``'s own bounds hold them (stage
statistics within 1e-3 relative, greedy tokens equal, waveforms within
1e-3).
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tomllib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import synthetic_ckpt
from qwen3tts_tpu_torch.tools import ckpt_layout, inspect_ckpt, parity_harness
from qwen3tts_tpu_torch.utils.loader import read_safetensors, write_safetensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """A script of tools/ (the JAX package's tools) as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny shapes (restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---- the parity harness ----

@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """(port dump dir, JAX dump dir): the port's ``--synthetic --device
    cpu`` run, then the JAX harness's ``--synthetic`` run on the checkpoint
    the port's run wrote."""
    port = str(tmp_path_factory.mktemp("parity_port"))
    rc = parity_harness.main(["--synthetic", "--device", "cpu", "--out", port,
                              "--max-tokens", "6"])
    assert rc == 0
    jax_out = str(tmp_path_factory.mktemp("parity_jax"))
    jh = _jax_tool("parity_harness")
    args = SimpleNamespace(cpu=True, synthetic=True, model=None, out=jax_out, speaker=None,
                           temperature=0.0, top_k=50, top_p=1.0, repetition_penalty=1.0,
                           max_tokens=6, seed=0, ref_exact_top_p=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(synthetic_ckpt, "write_checkpoint",
                   lambda path: os.path.join(port, "checkpoint"))
        assert jh.run(args) == 0
    return port, jax_out


def test_port_and_jax_dumps_pass_compare(dumps):
    port, jax_out = dumps
    a = json.load(open(os.path.join(port, "parity.json")))
    b = json.load(open(os.path.join(jax_out, "parity.json")))
    assert a.keys() == b.keys() and a["stages"].keys() == b["stages"].keys()
    assert a["greedy"].keys() == b["greedy"].keys()
    assert a["greedy"]["n_tokens"] == 6 and a["greedy"]["tokens"] == b["greedy"]["tokens"]
    wa, wb = (np.load(os.path.join(d, "greedy_audio.npy")) for d in dumps)
    assert wa.shape == wb.shape == (6 * 1920,) and float(np.abs(wa - wb).max()) <= 1e-3
    assert os.path.getsize(os.path.join(port, "greedy.wav")) == 44 + 2 * 6 * 1920
    assert parity_harness.main(["--compare", os.path.join(port, "parity.json"),
                                os.path.join(jax_out, "parity.json")]) == 0


@pytest.mark.parametrize("change", ["stage", "tokens", "waveform"])
def test_compare_fails_on_a_perturbed_dump(dumps, tmp_path, change):
    port = dumps[0]
    bad = str(tmp_path / "bad")
    shutil.copytree(port, bad)
    rep = json.load(open(os.path.join(bad, "parity.json")))
    if change == "stage":
        rep["stages"]["pre_conv"]["std"] *= 1.01
    elif change == "tokens":
        rep["greedy"]["tokens"][2] += 1
    else:
        w = np.load(os.path.join(bad, "greedy_audio.npy"))
        np.save(os.path.join(bad, "greedy_audio.npy"), w + np.float32(2e-3))
    json.dump(rep, open(os.path.join(bad, "parity.json"), "w"))
    assert parity_harness.main(["--compare", os.path.join(port, "parity.json"),
                                os.path.join(bad, "parity.json")]) == 1


# ---- inspect_ckpt ----

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return ckpt_layout.write_checkpoint(str(tmp_path_factory.mktemp("inspect_ckpt")))


def test_clean_checkpoint_passes(ckpt):
    r = subprocess.run([sys.executable, "-m", "qwen3tts_tpu_torch.tools.inspect_ckpt", ckpt],
                       capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("OK: key sets and shapes match") == 2
    assert inspect_ckpt.main([]) == 2


@pytest.mark.parametrize("change", ["renamed", "missing", "extra"])
def test_reports_a_renamed_missing_or_extra_key(ckpt, tmp_path, capsys, change):
    broken = tmp_path / "broken"
    shutil.copytree(ckpt, broken)
    p = str(broken / "model.safetensors")
    w = {k: np.array(v) for k, v in read_safetensors(p).items()}
    if change == "renamed":  # a wrong prefix
        w["talker.model.wrong_prefix.norm.weight"] = w.pop("talker.model.norm.weight")
        want = ["MISSING    talker.model.norm.weight",
                "UNEXPECTED talker.model.wrong_prefix.norm.weight"]
    elif change == "missing":
        w.pop("talker.codec_head.weight")
        want = ["MISSING    talker.codec_head.weight"]
    else:
        w["talker.model.extra.weight"] = np.zeros(3, np.float32)
        want = ["UNEXPECTED talker.model.extra.weight"]
    write_safetensors(p, w)
    assert inspect_ckpt.main([str(broken)]) == 1
    out = capsys.readouterr().out
    for line in want:
        assert line in out
    assert out.count("OK: key sets and shapes match") == 1  # speech_tokenizer/


@pytest.mark.parametrize("quantize", [False, True], ids=["plain", "quantized"])
def test_expected_listing_matches_jax_tool(tmp_path, quantize):
    """The port's expected names and shapes equal the JAX tool's for the
    test checkpoint's tiny config, plain and MLX int4."""
    d = synthetic_ckpt.write_checkpoint(str(tmp_path / "c"), quantize=quantize)
    jt = _jax_tool("inspect_ckpt")
    assert inspect_ckpt.expected_listing(d) == jt.expected_listing(d)
    st = os.path.join(d, "speech_tokenizer")
    assert inspect_ckpt.expected_st_listing(st) == jt.expected_st_listing(st)
    assert inspect_ckpt.main([d]) == 0


def test_weight_functions_equal_the_test_checkpoints():
    """tools/ckpt_layout.py's copy of the weight functions gives the test
    checkpoint's tensors byte for byte (same names, same values)."""
    pairs = ((ckpt_layout.build_main_weights(ckpt_layout.TINY_CONFIG),
              synthetic_ckpt.build_main_weights(synthetic_ckpt.TINY_CONFIG)),
             (ckpt_layout.build_speech_tokenizer_weights(ckpt_layout.TINY_ST_CONFIG),
              synthetic_ckpt.build_speech_tokenizer_weights(synthetic_ckpt.TINY_ST_CONFIG)))
    for ours, theirs in pairs:
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k
    stub, theirs = ckpt_layout.StubTokenizer(), synthetic_ckpt.StubTokenizer()
    text = "<|im_start|>assistant\nHello world<|im_end|>\n"
    assert stub.encode(text) == theirs.encode(text)


# ---- packaging ----

def test_pyproject_lists_every_package_of_the_port():
    """Every directory of qwen3tts_tpu_torch/ that holds an __init__.py is a
    package of the wheel (a module imports qwen3tts_tpu_torch.parallel at
    import time), and the CLI is a script."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)
    listed = set(project["tool"]["setuptools"]["packages"])
    root = os.path.join(REPO, "qwen3tts_tpu_torch")
    found = {
        os.path.relpath(d, REPO).replace(os.sep, ".")
        for d, _, files in os.walk(root)
        if "__init__.py" in files
    }
    assert "qwen3tts_tpu_torch.parallel" in found
    assert found - listed == set()
    assert project["project"]["scripts"]["qwen3tts-torch"] == "qwen3tts_tpu_torch.cli:main"
