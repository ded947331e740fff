"""Streaming in the port (qwen3tts_tpu_torch/tts.py: ``generate_stream``,
``_stream_codes``, ``on_token``, ``generate_stream_async``) against the JAX
package's, on the CPU.

Both packages run the tiny f32 pair of tests/test_torch_batch.py::_models
(the JAX trees, vocoder included, carried across by
utils/convert.py::from_jax_params) greedily: the same event kinds in the same
order, equal tokens and chunk offsets, chunk PCM and the final audio within
``1e-5 * 40`` (the bound of test_model_generate_matches_jax_greedy: the
pre-clip signal stays below 40). Then the reference's own contracts
(tests/test_loader_api.py's streaming cases) on the port: the event
contract, tokens before any vocoder call, chunks that tile ``n * 1920``,
the stream with audio against the one without (the first read-back after
the first chunk, not after the prefill), ``on_token`` through ``generate``,
and the four ``AsyncEventStream`` cases. Last, the host state that threads
share: the devices' decode turns (``generate.device_turn``) with a stand-in
CUDA stream, and the TF32 flags of ``ops.conv.exact_f32`` under two vocoder
calls at once.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3tts_tpu_torch import tts as ttts
from qwen3tts_tpu_torch.models import generate as tgen
from qwen3tts_tpu_torch.ops import _cuda
from qwen3tts_tpu_torch.ops import talker_kernel as tkk

from test_torch_batch import _models

BOUND = 1e-5 * 40  # f32, |pre-clip signal| < 40 (test_model_generate_matches_jax_greedy)
TEXT = "stream me along now please"


@pytest.fixture(scope="module")
def pair():
    return _models()


@pytest.fixture
def tm(pair):
    m = pair[1]
    m.stream_chunk_frames = 25
    yield m
    m.stream_chunk_frames = 25


def _kinds(events):
    return [type(e).__name__ for e in events]


def _stream(m, chunk, **kw):
    m.stream_chunk_frames = chunk
    try:
        return list(m.generate_stream(TEXT, speaker="aiden", language="english",
                                      temperature=0.0, seed=0, **kw))
    finally:
        m.stream_chunk_frames = 25


def _assert_same_events(got, want, exact: bool):
    assert _kinds(got) == _kinds(want)
    for a, b in zip(got, want):
        if isinstance(a, ttts.TokenEvent):
            assert a.token == b.token
        elif isinstance(a, ttts.AudioChunkEvent):
            assert a.frame_offset == b.frame_offset
            assert a.audio.shape == np.asarray(b.audio).shape
            if exact:
                np.testing.assert_array_equal(a.audio, b.audio)
            else:
                assert np.abs(a.audio - np.asarray(b.audio)).max() <= BOUND
        elif isinstance(a, ttts.AudioEvent):
            assert a.audio.shape == np.asarray(b.audio).shape
            if exact:
                np.testing.assert_array_equal(a.audio, b.audio)
            else:
                assert np.abs(a.audio - np.asarray(b.audio)).max() <= BOUND
        else:
            assert a.info.generation_token_count == b.info.generation_token_count


@pytest.mark.parametrize("chunk,audio_chunk,frames", [(13, 2, 16), (3, 2, 16), (2, None, 9)])
def test_generate_stream_matches_jax_greedy(pair, chunk, audio_chunk, frames):
    """The port's stream against the JAX stream, greedy: the same events in
    the same order, equal tokens and chunk offsets, PCM within the f32
    bound. With ``audio_chunk_frames`` both read back first after the
    prefill and the first chunk (the JAX package's fused first window, the
    port's windowed vocoder on the same frames)."""
    jm, tm = pair
    kw = dict(max_tokens=frames, audio_chunk_frames=audio_chunk)
    got, want = _stream(tm, chunk, **kw), _stream(jm, chunk, **kw)
    assert sum(isinstance(e, ttts.TokenEvent) for e in got) >= 4
    if audio_chunk:
        assert sum(isinstance(e, ttts.AudioChunkEvent) for e in got) >= 2
    _assert_same_events(got, want, exact=False)


def test_on_token_matches_jax_and_generate(pair):
    """``generate(..., on_token=)``: the tokens JAX's hands to its callback,
    and the waveform of the port's own ``generate()`` without one."""
    jm, tm = pair
    kw = dict(speaker="aiden", language="english", temperature=0.0, max_tokens=8, seed=0)
    got, want = [], []
    tm.stream_chunk_frames = jm.stream_chunk_frames = 3
    try:
        wav_cb = tm.generate(TEXT, on_token=got.append, **kw)
        jm.generate(TEXT, on_token=want.append, **kw)
    finally:
        tm.stream_chunk_frames = jm.stream_chunk_frames = 25
    assert got == want and len(got) >= 4 and all(isinstance(t, int) for t in got)
    np.testing.assert_array_equal(wav_cb, tm.generate(TEXT, **kw))


def test_generate_vocodes_in_one_path(tm, monkeypatch):
    """``generate()`` without ``on_token`` decodes and vocodes in one call
    of ``_generate_and_decode`` and nothing else, and its waveform is the
    one ``_decode_audio`` makes of the same codes."""
    kw = dict(speaker="aiden", temperature=0.0, max_tokens=8, seed=0)
    calls = []
    orig = ttts._generate_and_decode
    monkeypatch.setattr(ttts, "_generate_and_decode",
                        lambda *a, **k: (calls.append("one call"), orig(*a, **k))[1])
    monkeypatch.setattr(tm, "_decode_audio", lambda *a: calls.append("_decode_audio"))
    wav = tm.generate(TEXT, **kw)
    assert calls == ["one call"]
    monkeypatch.undo()
    embeds, trailing, pad = tm._prepare_generation_inputs(TEXT, language="auto", speaker="aiden",
                                                          instruct=None)
    codes, n = tm._run_generation(embeds, trailing, pad, sampling=tm._sampling(0.0, 50, 1.0, 1.05),
                                  max_steps=tm._effective_max_tokens(TEXT, 8), seed=0)
    np.testing.assert_array_equal(tm._decode_audio(codes, n), wav)


def test_stream_event_contract(tm):
    """token* -> info -> audio, exactly."""
    events = list(tm.generate_stream("Stream me", speaker="aiden", max_tokens=6, seed=1))
    kinds = _kinds(events)
    assert kinds[-2:] == ["InfoEvent", "AudioEvent"] and len(kinds) >= 3
    assert all(k == "TokenEvent" for k in kinds[:-2])
    assert events[-2].info.generation_token_count == len(kinds) - 2
    assert events[-1].audio.shape[0] > 0


def test_stream_tokens_are_live(tm, monkeypatch):
    """The first TokenEvent arrives before any vocoder call and before the
    InfoEvent is built."""
    calls = []
    orig = ttts.vc_mod.decode
    monkeypatch.setattr(ttts.vc_mod, "decode", lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    tm.stream_chunk_frames = 2
    tm.last_info = None
    it = tm.generate_stream("Live stream check", speaker="aiden", max_tokens=8, seed=1)
    first = next(it)
    assert isinstance(first, ttts.TokenEvent)
    assert not calls and tm.last_info is None
    rest = list(it)
    assert _kinds([first] + rest)[-2:] == ["InfoEvent", "AudioEvent"] and calls


def test_stream_audio_chunks_tile_the_utterance(tm):
    """AudioChunkEvents tile n * 1920 samples contiguously from frame 0,
    before the final AudioEvent."""
    events = _stream(tm, 3, max_tokens=10, audio_chunk_frames=2)
    chunks = [e for e in events if isinstance(e, ttts.AudioChunkEvent)]
    assert chunks and events.index(chunks[0]) < len(events) - 1
    n = next(e for e in events if isinstance(e, ttts.InfoEvent)).info.generation_token_count
    pcm = np.concatenate([c.audio for c in chunks])
    assert pcm.shape[0] == n * 1920
    assert np.isfinite(pcm).all() and np.abs(pcm).max() <= 1.0
    assert chunks[0].frame_offset == 0
    for a, b in zip(chunks, chunks[1:]):
        assert b.frame_offset * 1920 == a.frame_offset * 1920 + a.audio.shape[0]


def test_stream_with_audio_reads_back_after_the_first_chunk(tm, monkeypatch):
    """With ``audio_chunk_frames`` the first read-back comes after the
    prefill and the first chunk (12 frames, or the utterance if shorter);
    without, after the prefill. Both give the same tokens and bit-equal
    final audio, and the first chunk starts at frame 0."""
    orig = tm._stream_codes
    steps = {}

    def spy(prep, sampling, max_steps, seed, audio=False):
        steps[audio] = []
        for out in orig(prep, sampling, max_steps, seed, audio=audio):
            steps[audio].append(out[1])
            yield out

    monkeypatch.setattr(tm, "_stream_codes", spy)
    with_audio = _stream(tm, 25, max_tokens=16, audio_chunk_frames=2)
    tokens_only = _stream(tm, 25, max_tokens=16)
    n = with_audio[-2].info.generation_token_count
    assert steps[True][0] == min(12, n) and steps[False][0] == 1
    assert steps[True][-1] == steps[False][-1] == n
    tok = lambda evs: [e.token for e in evs if isinstance(e, ttts.TokenEvent)]
    assert tok(with_audio) == tok(tokens_only) and len(tok(with_audio)) == n
    np.testing.assert_array_equal(with_audio[-1].audio, tokens_only[-1].audio)
    chunks = [e for e in with_audio if isinstance(e, ttts.AudioChunkEvent)]
    assert chunks and chunks[0].frame_offset == 0


def test_stream_validates_at_the_call(tm):
    """A bad speaker raises at ``generate_stream``'s call, before any event."""
    with pytest.raises(ttts.Qwen3TTSError, match="not found"):
        tm.generate_stream("hi", speaker="nobody")


def test_stream_async_produces_while_caller_sleeps(tm):
    """Events accumulate while the caller does not iterate."""
    stream = tm.generate_stream_async("Async stream check", speaker="aiden", max_tokens=6, seed=2)
    with stream:
        deadline = time.time() + 60
        while stream.pending() == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert stream.pending() > 0
        events = list(stream)
    kinds = _kinds(events)
    assert kinds[-2:] == ["InfoEvent", "AudioEvent"]
    assert all(k == "TokenEvent" for k in kinds[:-2])


def test_stream_async_gives_the_stream_events(tm):
    """The async stream's events are generate_stream's."""
    kw = dict(speaker="aiden", max_tokens=6, seed=2, temperature=0.0, audio_chunk_frames=2)
    _assert_same_events(list(tm.generate_stream_async(TEXT, **kw)),
                        list(tm.generate_stream(TEXT, **kw)), exact=True)


def test_stream_async_propagates_errors():
    def boom():
        raise ttts.Qwen3TTSError("boom")
        yield  # makes this a generator

    with pytest.raises(ttts.Qwen3TTSError, match="boom"):
        list(ttts.AsyncEventStream(boom()))


def test_stream_async_bounded_queue_backpressure():
    """A consumer that stops reading caps the queue at maxsize and blocks
    the producer before it advances the generator again."""
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    stream = ttts.AsyncEventStream(gen(), maxsize=8)
    deadline = time.time() + 10
    while stream.pending() < 8 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert stream.pending() == 8 and len(produced) <= 9
    for _ in range(4):
        next(stream)
    deadline = time.time() + 10
    while stream.pending() < 8 and time.time() < deadline:
        time.sleep(0.01)
    assert stream.pending() == 8
    stream.close()
    stream._thread.join(timeout=10)
    assert not stream._thread.is_alive()


def test_stream_async_close_stops_generator():
    """close() closes the generator on the producer thread (GeneratorExit at
    its yield): no item is produced after it."""
    state = {"dispatches": 0, "exited": False}

    def gen():
        try:
            for i in range(1000):
                state["dispatches"] += 1
                yield i
        except GeneratorExit:
            state["exited"] = True
            raise

    stream = ttts.AsyncEventStream(gen(), maxsize=4)
    next(stream)
    next(stream)
    stream.close()
    stream._thread.join(timeout=10)
    assert not stream._thread.is_alive() and state["exited"]
    high_water = state["dispatches"]
    assert high_water <= 7  # consumed (2) + queued (4) + one in flight
    time.sleep(0.1)
    assert state["dispatches"] == high_water


class _Stream:
    """A stand-in for ``torch.cuda.current_stream(device)``: the CPU build
    has no CUDA streams."""

    def __init__(self, log):
        self.log = log

    def synchronize(self):
        self.log.append("synchronize")


def test_device_turns_are_one_at_a_time(monkeypatch):
    """Eight threads take turns on each of two devices: never two at once
    on one device, while the two devices' turns overlap; each turn ends with
    its stream's synchronisation."""
    monkeypatch.setattr(tgen, "_TURNS", {})
    synced = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream(synced))
    inside = {0: 0, 1: 0}
    most = {0: 0, 1: 0, "both": 0}
    guard = threading.Lock()
    start = threading.Barrier(8)
    errors = []

    def run(index):
        try:
            start.wait(timeout=30)
            for _ in range(20):
                with tgen.device_turn(torch.device("cuda", index)):
                    with guard:
                        inside[index] += 1
                        most[index] = max(most[index], inside[index])
                        most["both"] = max(most["both"], inside[0] + inside[1])
                    time.sleep(0.001)
                    with guard:
                        inside[index] -= 1
        except BaseException as ex:  # noqa: BLE001  (reported by the assert below)
            errors.append(repr(ex))

    threads = [threading.Thread(target=run, args=(i % 2,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert most[0] == most[1] == 1 and most["both"] == 2
    assert len(synced) == 8 * 20 and sorted(tgen._TURNS) == [0, 1]


def test_a_fault_raises_at_the_end_of_its_turn(monkeypatch):
    """A fault flag set during a turn raises ``BarrierTimeout`` as the turn
    ends, after its stream's synchronisation, on the thread that took it;
    the flag is cleared and the device is free for the next turn."""
    monkeypatch.setattr(tgen, "_TURNS", {})
    log = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream(log))
    flag = torch.zeros(1, dtype=torch.int32)  # the pinned flag's stand-in
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(tkk, "_err_flags", {dev: flag})
    with pytest.raises(_cuda.BarrierTimeout, match="K1 persistent barrier timed out"):
        with tgen.device_turn(dev):
            flag.fill_(1)  # as the card writes it when a step's barrier waits too long
    assert log == ["synchronize"] and int(flag[0]) == 0
    with tgen.device_turn(dev):  # the lock was released
        pass
    assert log == ["synchronize"] * 2


def test_stream_decodes_run_in_turns(tm, monkeypatch):
    """The stream's prefill and each of its chunks run in a turn of the
    model's device, one turn before each read-back."""
    turns = []
    orig = tgen.device_turn
    monkeypatch.setattr(tgen, "device_turn", lambda dev: (turns.append(dev), orig(dev))[1])
    reads = []
    orig_codes = tm._stream_codes

    def spy(*a, **k):
        for out in orig_codes(*a, **k):
            reads.append(out[1])
            yield out

    monkeypatch.setattr(tm, "_stream_codes", spy)
    events = _stream(tm, 3, max_tokens=8)
    assert len(reads) >= 3 and reads[-1] == events[-2].info.generation_token_count
    assert turns == [tm.device] * len(reads)


def test_exact_f32_on_two_threads_keeps_the_callers_flags(tm, monkeypatch):
    """Two vocoder calls at once on two threads: each runs its whole
    decode with TF32 off, both give the waveform of a call alone, and the
    caller's TF32 settings are back afterwards."""
    codes = np.random.default_rng(0).integers(1, 64, (9, 16)).astype(np.int32)
    alone = tm._decode_audio(codes, 9)
    seen, errors = [], []
    orig = ttts.vc_mod.decode_latents
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def slow(*a, **k):
        seen.append(flags())
        time.sleep(0.05)  # the other thread's call starts meanwhile
        out = orig(*a, **k)
        seen.append(flags())
        return out

    monkeypatch.setattr(ttts.vc_mod, "decode_latents", slow)
    saved = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    out = {}

    def run(i):
        try:
            out[i] = tm._decode_audio(codes, 9)
        except BaseException as ex:  # noqa: BLE001  (reported by the assert below)
            errors.append(repr(ex))

    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        after = flags()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert not errors and len(seen) == 4 and all(f == (False, False) for f in seen)
    assert after == (True, True)
    for i in range(2):
        np.testing.assert_array_equal(out[i], alone)
