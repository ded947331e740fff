"""The traffic generator: the same sizes for every seed, in a seeded order,
inside the mix's ranges."""

import itertools
import json
from collections import Counter

import pytest

import make_traffic as mt
from tiny import BENCH

MIXES = ("single", "stream", "batch64")
SPEAKERS = ["aiden", "vivian", "ryan"]


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def take(p, seed, n):
    return list(itertools.islice(mt.units(p, SPEAKERS, seed), n))


@pytest.mark.parametrize("name", MIXES)
def test_the_same_seed_gives_the_same_units(name):
    p = mix(name)
    assert take(p, 2**31 + 77, 5) == take(p, 2**31 + 77, 5)
    assert take(p, 2**31 + 77, 5) != take(p, 2**31 + 78, 5)


@pytest.mark.parametrize("name", MIXES)
def test_sizes_stay_in_range(name):
    p = mix(name)
    for w, f, _ in mt.sizes(p):
        assert p["words"][0] <= w <= p["words"][1]
        assert p["frames"][0] <= f <= p["frames"][1]
    for u in take(p, 5, 3):
        for r in u.requests:
            assert p["words"][0] <= len(r.text.split()) <= p["words"][1]
            assert r.speaker in SPEAKERS and 0 <= r.seed < 2**31


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_set_of_sizes(name):
    p = mix(name)
    n = p["pool"] // p["batch"]
    def sizes(seed):
        return Counter((len(r.text.split()), r.frames, r.greedy)
                       for u in take(p, seed, n) for r in u.requests)
    if p["batch"] == 1:
        assert sizes(1) == sizes(2**31 + 9) == Counter(mt.sizes(p))
    else:
        one = [Counter((len(r.text.split()), r.frames) for r in u.requests) for u in take(p, 3, 2)]
        assert one[0] == one[1] == Counter((w, f) for w, f, _ in mt.sizes(p))


def test_greedy_share_holds_the_longest():
    p = mix("single")
    pool = mt.sizes(p)
    greedy = [s for s in pool if s[2]]
    assert len(greedy) == p["pool"] // p["greedy_every"]
    assert max(f for _, f, _ in greedy) == max(f for _, f, _ in pool)
    b = mix("batch64")
    assert [u.requests[0].greedy for u in take(b, 11, 8)] == [i % 4 == 0 for i in range(8)]
    assert all(len({r.greedy for r in u.requests}) == 1 for u in take(b, 11, 3))


@pytest.mark.parametrize("name", ("single", "stream"))
def test_warm_units_cover_every_frame_bucket(name):
    p = mix(name)
    buckets = (72, 96, 128, 256, 512)
    warm = mt.warm_units(p, SPEAKERS, 4, buckets)
    used = {next(b for b in buckets if f <= b) for _, f, _ in mt.sizes(p)}
    warm_b = {next(b for b in buckets if u.requests[0].frames <= b) for u in warm}
    assert warm_b == used and any(u.requests[0].greedy for u in warm)
    assert max(u.requests[0].frames for u in warm) == p["frames"][1]
