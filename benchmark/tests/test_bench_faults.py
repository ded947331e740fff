"""A run with the timed path broken underneath comes out not correct: a step
that returns its state unchanged, half of a batch left out, a token altered
where it is produced. The look for a card is skipped: the run drives the
port's CPU path at tiny widths."""

import contextlib
import time

import pytest
import torch

import run as bench_run
from test_bench_reference import CELLS, SPEC, cfg_of, small_traffic

LIMITS = {"short_requests": 0, "code0_gap": 0.1, "cp_gap": 0.3, "wav_err": 5e-3}


def one_run(name, fault=None):
    cell = CELLS[name]
    res, lines = bench_run.run_cell(SPEC, cell, 2**31 + 21, 2.0, False, torch.device("cpu"),
                                    time.perf_counter(), cfg=cfg_of(cell),
                                    traffic=small_traffic(cell), limits=LIMITS, fault=fault)
    return res


@contextlib.contextmanager
def patched(module, attr, make):
    old = getattr(module, attr)
    setattr(module, attr, make(old))
    try:
        yield
    finally:
        setattr(module, attr, old)


def step_unchanged():
    from qwen3tts_tpu_torch.models import batch_generate as bg
    from qwen3tts_tpu_torch.models import generate as gen

    with patched(gen, "generate_chunk", lambda f: lambda tp, cp, carry, **k: carry), \
            patched(bg, "generate_chunk_batch", lambda f: lambda tp, cp, carry, **k: carry):
        yield


def half_batch_left_out():
    from qwen3tts_tpu_torch.models import batch_generate as bg

    def make(f):
        def half(*a, **k):
            res = f(*a, **k)
            n = res.n_frames.clone()
            n[n.shape[0] // 2:] = 0
            return res._replace(n_frames=n)
        return half

    with patched(bg, "generate_codes_batch", make):
        yield


def token_altered():
    from qwen3tts_tpu_torch.models import batch_generate as bg
    from qwen3tts_tpu_torch.models import generate as gen

    def make(f):
        return lambda *a, **k: (f(*a, **k) + 7) % 2048
    with patched(gen, "sample_token_inner", make), patched(bg, "sample_token_inner", make):
        yield


@pytest.mark.parametrize("name", list(CELLS))
def test_a_sound_run_is_correct(name):
    res = one_run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", list(CELLS))
@pytest.mark.parametrize("fault", [step_unchanged, token_altered])
def test_a_broken_step_is_caught(name, fault):
    assert not one_run(name, contextlib.contextmanager(fault))["correct"]


@pytest.mark.parametrize("name", [n for n, c in CELLS.items() if c["traffic"] == "batch64"])
def test_half_a_batch_left_out_is_caught(name):
    res = one_run(name, contextlib.contextmanager(half_batch_left_out))
    assert not res["correct"] and res["checks"]["short_requests"]["value"] > 0
