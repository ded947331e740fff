"""The benchmark's CPU tests: run with ``python -m pytest benchmark/tests``
from the root of a checkout. A test that needs the card takes the ``card``
fixture, which skips it where no CUDA device is present."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(Path(__file__).resolve().parent), str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; the test skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
