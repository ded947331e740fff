"""The one traffic generator: reads a mix's parameters (``traffic/<name>.json``)
and yields its units of work from the seed.

A unit is one request (a closed loop of one client, ``batch`` 1) or one
lockstep batch of ``batch`` requests. Every seed gets the same set of sizes:
``pool`` word counts stratified over the mix's range, each with a frame count
of ``round(words * frames_per_word * u)`` clipped to the frame range, the
factors u stratified over the jitter range and paired with the word counts
by a fixed shuffle. The seed orders them (each cycle of the pool, or each
batch, a new permutation) and draws the words, the speakers and each
request's sampling seed. A fixed share of the work decodes greedily, so
that its tokens can be checked against the reference's logits: one size in
``greedy_every`` (the longest among them) at one request a unit, one batch
in ``greedy_every`` (the first) at more.
"""

from __future__ import annotations

import random
import string
from dataclasses import dataclass

SIZES_SEED = 20261019  # fixes the pairing of word counts and jitter factors


@dataclass(frozen=True)
class Request:
    text: str
    speaker: str
    frames: int  # frames decoded: EOS is forbidden, so exactly these
    seed: int
    greedy: bool


@dataclass(frozen=True)
class Unit:
    index: int
    requests: tuple[Request, ...]
    seed: int  # a lockstep batch's sampling seed


def sizes(p: dict) -> list[tuple[int, int, bool]]:
    """The pool's (words, frames, greedy) in ascending order of words."""
    n = p["pool"]
    (w_lo, w_hi), (f_lo, f_hi), (j_lo, j_hi) = p["words"], p["frames"], p["jitter"]
    perm = list(range(n))
    random.Random(SIZES_SEED).shuffle(perm)
    out = []
    for i in range(n):
        words = w_lo + int((i + 0.5) / n * (w_hi - w_lo + 1))
        u = j_lo + (perm[i] + 0.5) / n * (j_hi - j_lo)
        frames = min(max(round(words * p["frames_per_word"] * u), f_lo), f_hi)
        out.append((words, frames))
    longest = max(range(n), key=lambda i: (out[i][1], i))
    g = p["greedy_every"]
    return [(w, f, p["batch"] == 1 and (i - longest) % g == 0) for i, (w, f) in enumerate(out)]


def _word(rng: random.Random) -> str:
    return "".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(2, 9)))


def units(p: dict, speakers: list[str], seed: int, start: int = 0):
    """The mix's units from ``seed``, without end; ``start`` offsets the
    unit indices (warm-up units are drawn apart from the window's)."""
    rng = random.Random(seed)
    pool = sizes(p)
    order: list = []
    u = start
    while True:
        if p["batch"] == 1:
            if not order:
                order = rng.sample(pool, len(pool))
            picks, greedy_unit = [order.pop()], None
        else:
            picks = rng.sample(pool, len(pool))
            greedy_unit = u % p["greedy_every"] == 0
        reqs = tuple(
            Request(text=" ".join(_word(rng) for _ in range(w)), speaker=rng.choice(speakers),
                    frames=f, seed=rng.randrange(1 << 31),
                    greedy=g if greedy_unit is None else greedy_unit)
            for w, f, g in picks
        )
        yield Unit(index=u, requests=reqs, seed=rng.randrange(1 << 31))
        u += 1


def warm_units(p: dict, speakers: list[str], seed: int, buckets) -> list[Unit]:
    """Units that take every shape the mix uses, once: at one request a unit,
    the longest size of each of the program's frame ``buckets`` sampled and
    the shortest greedy; at more, one batch of the pool."""
    gen = units(p, speakers, seed ^ 0x5EED, start=-1)
    if p["batch"] != 1:
        return [next(gen)]
    pool = sizes(p)
    want = {}
    for w, f, _ in pool:
        b = next(x for x in buckets if f <= x)
        if f > want.get(b, (0, 0))[1]:
            want[b] = (w, f)
    shortest = min(pool, key=lambda s: s[1])
    picks = [(w, f, False) for w, f in want.values()] + [(shortest[0], shortest[1], True)]
    rng = random.Random(seed ^ 0x5EED)
    return [
        Unit(index=-1 - i, requests=(Request(
            text=" ".join(_word(rng) for _ in range(w)), speaker=rng.choice(speakers), frames=f,
            seed=rng.randrange(1 << 31), greedy=g),), seed=rng.randrange(1 << 31))
        for i, (w, f, g) in enumerate(picks)
    ]
