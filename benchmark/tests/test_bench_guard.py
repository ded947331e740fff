"""The import guard compares whole top-level names; the reference imports
nothing of the program."""

import ast
import subprocess
import sys
import types

import harness
from tiny import BENCH


def test_guard_flags_the_jax_package_and_not_the_port(monkeypatch):
    monkeypatch.setitem(sys.modules, "qwen3tts_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.delitem(sys.modules, "qwen3tts_tpu", raising=False)
    assert "qwen3tts_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "qwen3tts_tpu.models", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("z"))
    assert {"qwen3tts_tpu", "jaxlib"} <= set(harness.forbidden_modules())


def test_reference_sources_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] in ("__future__", "contextlib", "math", "torch") for n in names), path


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path[:0] = [%r]; import reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'qwen3tts_tpu_torch', 'qwen3tts_tpu', 'jax'}))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_run_loads_no_jax(tmp_path):
    """A run's modules (harness, drivers, the port) leave JAX unloaded."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import harness, make_traffic, tracing; "
            "import qwen3tts_tpu_torch.tts, qwen3tts_tpu_torch.models.batch_generate; "
            "[harness.load_module('drivers', d) for d in ('single', 'stream', 'batch')]; "
            "print(harness.forbidden_modules())" % (str(BENCH), str(BENCH.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
