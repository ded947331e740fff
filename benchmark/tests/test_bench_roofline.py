"""K1's and K2's bytes and operations against counts made by hand at the
0.6B and 1.7B widths."""

import pytest

from roofline import bound_s, k1_io, k2_io

MB = 1e6


def test_k1_one_row_at_06b():
    # per layer: qkv 1024 x 4096, o 2048 x 1024, gate_up 1024 x 6144, down 3072 x 1024
    elems = 1024 * 4096 + 2048 * 1024 + 1024 * 6144 + 3072 * 1024  # 15,728,640
    assert elems == 15_728_640
    weights = 28 * (elems + 4 * (4096 + 1024 + 6144 + 1024))  # int8 and f32 scales
    norms = 28 * (2 * 1024 + 2 * 128) * 2 + 1024 * 2
    kv = 41 * 28 * 8 * 128 * 2 * 2  # 40 rows read, one written
    head = 1024 * 3072 + 3072 * 4 + 3072 + 3072 * 4 + 4  # int8 head, scales, seen, mask, code
    n, fl = k1_io(28, 1024, 16, 8, 128, 3072, 3072, 1, 40, False, False, False)
    assert n == weights + norms + 2 * 1024 * 2 + kv + head
    assert n / MB == pytest.approx(449.79, abs=0.01)
    assert fl == 2 * 28 * elems + 4 * 28 * 16 * 128 * 41 + 2 * 1024 * 3072
    assert bound_s(n, fl) * 1e3 == pytest.approx(0.1343, abs=1e-4)  # PERF.md's 0.134 ms


def test_k1_batched_at_17b():
    elems = 2048 * 4096 + 2048 * 2048 + 2048 * 12288 + 6144 * 2048
    n, fl = k1_io(28, 2048, 16, 8, 128, 6144, 3072, 64, 64 * 100, False, False, False)
    kv = (6400 + 64) * 28 * 8 * 128 * 4
    weights = 28 * (elems + 4 * (4096 + 2048 + 12288 + 2048))
    head = 2048 * 3072 + 3072 * 4 + 64 * 3072 + 3072 * 4 + 64 * 4
    assert n == weights + 28 * (2 * 2048 + 256) * 2 + 2048 * 2 + 2 * 64 * 2048 * 2 + kv + head
    assert fl == 2 * 64 * 28 * elems + 4 * 28 * 16 * 128 * 6464 + 2 * 64 * 2048 * 3072


def test_k2_at_06b_and_with_the_17b_projection():
    elems = 15_728_640
    stack = 5 * (elems + 4 * 12288) + 5 * (2 * 1024 + 256) * 2 + 1024 * 2
    heads = 15 * 1024 * 2048 + 15 * 2048 * 4
    n, fl = k2_io(5, 1024, 16, 8, 128, 3072, 2048, 15, 1, 1024, False, False)
    assert n == stack + heads + 2 * 1024 * 2 + 15 * 1024 * 2 + 15 * 4 + 1024 * 4
    assert fl == 2 * (16 * 5 * elems + 15 * 1024 * 2048) + 5 * 16 * 4 * 128 * 136
    n17, fl17 = k2_io(5, 1024, 16, 8, 128, 3072, 2048, 15, 64, 2048, False, False)
    proj = (2048 * 1024 + 1024) * 2
    assert n17 == stack + heads + proj + 64 * 2 * 2048 * 2 + 15 * 64 * 2048 * 2 + 64 * 15 * 4 + 64 * 2048 * 4
    assert fl17 == 2 * 64 * (16 * 5 * elems + 15 * 1024 * 2048 + 16 * 2048 * 1024) + 64 * 5 * 16 * 4 * 128 * 136
