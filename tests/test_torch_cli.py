"""The port's CLI, activation profiler and WAV I/O against the JAX
package's (the cases of tests/test_cli_profiler.py, mirrored), on the
synthetic checkpoint of qwen3tts_tpu_torch/tools/ckpt_layout.py, which both
packages load (its tts special ids and vocoder codebooks are in range, so
no gather clamps in JAX where torch would raise).

Tolerances: WAV files hold int16 PCM, so two f32 waveforms a rounding apart
may differ by one step (2 / 32768 is allowed); the greedy frames are equal.
Per-neuron FFN maxima in f32: rtol 1e-4, atol 1e-5 (the same sums in
another order); int8 and packed int4 layouts take the same bound, their
weights being dequantized the same way in both packages.
"""

import contextlib
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from qwen3tts_tpu import cli as jcli
from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.ops.quant import quantize_decode_params_int8 as jquantize_int8
from qwen3tts_tpu.tts import Qwen3TTSModel as JModel
from qwen3tts_tpu.utils import audio as jaudio
from qwen3tts_tpu.utils.loader import Checkpoint as JCheckpoint
from qwen3tts_tpu.utils.profiler import ActivationProfiler as JProfiler
from qwen3tts_tpu_torch import cli
from qwen3tts_tpu_torch.config import ModelConfig as TModelConfig
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.parallel.mesh import make_mesh
from qwen3tts_tpu_torch.tools import ckpt_layout
from qwen3tts_tpu_torch.tts import Qwen3TTSModel
from qwen3tts_tpu_torch.utils.audio import load_wav, save_wav
from qwen3tts_tpu_torch.utils.convert import from_jax_params
from qwen3tts_tpu_torch.utils.profiler import ActivationProfiler

from synthetic_ckpt import StubTokenizer

PCM_TOL = 2 / 32768
ACT = dict(rtol=1e-4, atol=1e-5)
GREEDY = ["--max-tokens", "6", "--temperature", "0"]
_PORT_LOAD, _JAX_LOAD = Qwen3TTSModel.from_pretrained, JModel.from_pretrained  # unpatched


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite's workers share
    the cores (the setting is restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return ckpt_layout.write_checkpoint(str(tmp_path_factory.mktemp("ckpt_torch_cli")))


def _load_port(path, device=None):
    with warnings.catch_warnings():  # no tokenizer files: the stub takes their place
        warnings.simplefilter("ignore")
        m = _PORT_LOAD(path, dtype=torch.float32, device=device)
    m.tokenizer = StubTokenizer()
    return m


def _load_jax(path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = _JAX_LOAD(path, jnp.float32)
    m.tokenizer = StubTokenizer()
    return m


@contextlib.contextmanager
def _patched_loaders():
    """Both packages' ``from_pretrained`` in f32 with the stub tokenizer
    (the device is the port CLI's ``--device``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Qwen3TTSModel, "from_pretrained",
                   classmethod(lambda cls, path, device=None: _load_port(path, device)))
        mp.setattr(JModel, "from_pretrained", classmethod(lambda cls, path: _load_jax(path)))
        yield


def _run(main, argv):
    """(rc, stdout, stderr) of a CLI ``main``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


# ---- WAV I/O ----

def test_wav_roundtrip(tmp_path):
    x = (np.random.RandomState(0).rand(4800).astype(np.float32) - 0.5) * 1.5
    path = str(tmp_path / "t.wav")
    save_wav(path, x, 24000)
    sr, back = load_wav(path)
    assert sr == 24000
    # int16 quantization + the 32767/32768 scale asymmetry
    np.testing.assert_allclose(back, np.clip(x, -1, 1), atol=1e-4)


def test_load_rejects_garbage(tmp_path):
    p = tmp_path / "bad.wav"
    p.write_bytes(b"not a wav file at all")
    with pytest.raises(ValueError, match="RIFF"):
        load_wav(str(p))


def test_wav_files_match_jax(tmp_path):
    """The port's file is the JAX package's byte for byte, and each
    package's ``load_wav`` reads the other's file to the same samples."""
    x = np.random.RandomState(1).randn(3001).astype(np.float32)  # past [-1, 1] too
    ours, theirs = str(tmp_path / "ours.wav"), str(tmp_path / "theirs.wav")
    save_wav(ours, x, 16000)
    jaudio.save_wav(theirs, x, 16000)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for a, b in ((load_wav(theirs), jaudio.load_wav(ours)), (load_wav(ours), load_wav(theirs))):
        assert a[0] == b[0] == 16000
        np.testing.assert_array_equal(a[1], b[1])


def _riff(fmt_code: int, bits: int, channels: int, payload: bytes, rate=24000,
          extra: bytes = b"") -> bytes:
    """A RIFF WAV; ``extra``: a LIST chunk's body ahead of the data, padded
    to an even size as the spec lays chunks out."""
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_code, channels, rate, rate * block, block, bits)
    chunks = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if extra:
        chunks += b"LIST" + struct.pack("<I", len(extra)) + extra + b"\x00" * (len(extra) & 1)
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


@pytest.mark.parametrize("form", ["pcm24_stereo", "pcm32", "float32", "pcm16_odd_chunk_before"])
def test_load_wav_formats_match_jax(tmp_path, form):
    """Each format ``load_wav`` takes reads as the JAX package reads it."""
    rs = np.random.RandomState(2)
    if form == "pcm24_stereo":
        v = rs.randint(-(1 << 23), 1 << 23, size=2 * 301)
        data = b"".join(int(s).to_bytes(3, "little", signed=True) for s in v)
        raw = _riff(1, 24, 2, data)
    elif form == "pcm32":
        raw = _riff(1, 32, 1, rs.randint(-(2**31), 2**31 - 1, size=300).astype("<i4").tobytes())
    elif form == "float32":
        raw = _riff(3, 32, 1, rs.randn(300).astype("<f4").tobytes())
    else:  # an odd-sized chunk ahead of the data, with its pad byte
        raw = _riff(1, 16, 1, rs.randint(-32768, 32767, size=301).astype("<i2").tobytes(),
                    extra=b"INFOodd")
    p = tmp_path / f"{form}.wav"
    p.write_bytes(raw)
    (sr, a), (jsr, b) = load_wav(str(p)), jaudio.load_wav(str(p))
    assert sr == jsr == 24000 and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)


# ---- the CLI ----

def test_profiling_texts_match_jax():
    """The reference's 20 profiling fixtures with their language tags, as
    the JAX package lists them: 12 en, 5 chinese, 2 japanese, 1 korean."""
    assert cli.PROFILING_TEXTS == jcli.PROFILING_TEXTS
    langs = [lang for _, lang in cli.PROFILING_TEXTS]
    assert len(langs) == 20
    assert [langs.count(x) for x in ("en", "chinese", "japanese", "korean")] == [12, 5, 2, 1]
    assert cli.PROFILING_TEXTS[0] == ("Hello, my name is Aiden. Nice to meet you.", "en")


@pytest.fixture(scope="module")
def jax_cli_wav(ckpt_dir, tmp_path_factory):
    """The JAX CLI's greedy WAV of "Hello world" (6 frames at most)."""
    out = str(tmp_path_factory.mktemp("jax_cli") / "j.wav")
    with _patched_loaders():
        rc, stdout, _ = _run(jcli.main, ["--model", ckpt_dir, "--text", "Hello world",
                                         "--speaker", "Aiden", "--output", out] + GREEDY)
    assert rc == 0 and "RTF" in stdout
    return load_wav(out)


@pytest.mark.parametrize("flags", ["long", "short"])
def test_cli_greedy_wav_matches_jax(ckpt_dir, jax_cli_wav, tmp_path, flags):
    """``--temperature 0 --max-tokens 6 --device cpu`` writes the JAX CLI's
    WAV (within one PCM step a sample) and prints the same metric lines:
    generation time, RTF, tokens/s and peak memory from ``last_info``; the
    reference's short flags -m/-t/-s/-o/-l do the same."""
    out = str(tmp_path / "o.wav")
    if flags == "long":
        argv = ["--model", ckpt_dir, "--text", "Hello world", "--speaker", "Aiden",
                "--output", out]
    else:
        argv = ["-m", ckpt_dir, "-t", "Hello world", "-s", "Aiden", "-o", out, "-l", "auto"]
    with _patched_loaders():
        rc, stdout, _ = _run(cli.main, argv + GREEDY + ["--device", "cpu"])
    assert rc == 0
    for line in ("Model loaded in", "Speakers: aiden, eric, vivian", "Generated ",
                 "Generation time:", "RTF (gen_time/audio_duration", "Saved to:",
                 "Generation tokens/s:", "Peak memory:"):
        assert line in stdout, line
    sr, audio = load_wav(out)
    jsr, jaudio_ = jax_cli_wav
    assert sr == jsr == 24000 and audio.shape == jaudio_.shape and audio.shape[0] > 0
    np.testing.assert_allclose(audio, jaudio_, atol=PCM_TOL, rtol=0)


def test_profiling_loop_passes_language(ckpt_dir, tmp_path, monkeypatch):
    """--profile passes each fixture's language tag to generate."""
    seen = []

    def fake_generate(self, text, **kw):
        seen.append(kw.get("language"))
        return np.zeros(1920, np.float32)

    monkeypatch.setattr(Qwen3TTSModel, "generate", fake_generate)
    with _patched_loaders():
        rc, stdout, _ = _run(cli.main, ["--model", ckpt_dir, "--profile", "--speaker", "Aiden",
                                        "--device", "cpu", "--profile-output",
                                        str(tmp_path / "p.json")])
    assert rc == 0
    assert seen == [lang for _, lang in cli.PROFILING_TEXTS]


@pytest.mark.parametrize("case", ["missing_text", "reference_audio_without_text"])
def test_argument_errors_exit_2(ckpt_dir, tmp_path, case):
    ref = str(tmp_path / "ref.wav")
    save_wav(ref, np.zeros(24000, np.float32))
    argv, msg = {
        "missing_text": (["--speaker", "Aiden"], "--text is required"),
        "reference_audio_without_text": (["--text", "x", "--reference-audio", ref],
                                         "--reference-text"),
    }[case]
    with _patched_loaders():
        rc, _, err = _run(cli.main, ["--model", ckpt_dir, "--device", "cpu"] + argv)
    assert rc == 2
    assert msg in err


def test_clone_repetition_penalty_passthrough(ckpt_dir, tmp_path, monkeypatch):
    """--repetition-penalty reaches generate_voice_clone; unset, the clone
    path keeps its API default 1.5 (generate keeps 1.05)."""
    seen = {}

    def fake_clone(self, text, **kw):
        seen.update(kw)
        return np.zeros(1920, np.float32)

    monkeypatch.setattr(Qwen3TTSModel, "generate_voice_clone", fake_clone)
    ref = str(tmp_path / "ref.wav")
    save_wav(ref, np.zeros(24000, np.float32))
    base = ["--model", ckpt_dir, "--text", "x", "--reference-audio", ref,
            "--reference-text", "hi", "--output", str(tmp_path / "c.wav"), "--device", "cpu"]
    with _patched_loaders():
        assert _run(cli.main, base + ["--repetition-penalty", "2.5"])[0] == 0
        assert seen["repetition_penalty"] == 2.5
        assert _run(cli.main, base)[0] == 0
        assert seen["repetition_penalty"] == 1.5


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a CUDA device")
def test_cli_without_a_card_exits_1(ckpt_dir):
    """The CLI targets the card by default: with none present the load
    raises and the CLI exits 1, with no silent CPU fallback."""
    rc, _, err = _run(cli.main, ["--model", ckpt_dir, "--text", "x", "--speaker", "Aiden"])
    assert rc == 1
    assert "no CUDA device" in err


# ---- the profiler ----

def test_profiler_record_flush_summary_json_match_jax(tmp_path):
    """Record (a tensor here, an array there), flush, the printed table and
    the JSON equal the JAX profiler's."""
    acts = [np.asarray([[0.001, 0.2, 2.0, 0.0], [1.0, 1.0, 0.02, 0.003]], np.float32),
            np.asarray([[0.5, 0.1, 1.0, 0.0], [0.2, 3.0, 0.01, 0.001]], np.float32),
            np.asarray([[0.05, 0.7, 0.3, 0.02], [0.4, 0.1, 0.9, 0.0]], np.float32)]
    outs = {}
    for name, prof, wrap in (("port", ActivationProfiler(), torch.from_numpy),
                             ("jax", JProfiler(), np.asarray)):
        prof.enable(num_layers=2, intermediate_size=4)
        prof.record(wrap(acts[0]))
        prof.record(wrap(acts[1]))
        prof.flush_run()
        prof.record(wrap(acts[2]))
        prof.flush_run()
        path = str(tmp_path / f"{name}.json")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            prof.print_summary(thresholds=(0.01, 1.0))
            prof.save_json(path)
        outs[name] = (prof, text.getvalue().replace(path, "P"), open(path).read())
    port, jax_ = outs["port"], outs["jax"]
    assert port[0].run_count == 2
    np.testing.assert_allclose(port[0]._max[0], [0.5, 0.7, 2.0, 0.02])
    assert "ACTIVATION PROFILING RESULTS (2 runs)" in port[1]
    assert port[1:] == jax_[1:]
    data = json.loads(port[2])
    assert data["num_layers"] == 2 and len(data["layers"]) == 2


def _talker_trees(layout, ckpt_dir, tmp_path_factory):
    """(JAX talker tree, the port's copy, JAX config, the port's) in a layout."""
    if layout == "packed_int4":
        d = ckpt_layout.write_checkpoint(str(tmp_path_factory.mktemp("ckpt_q4")), quantize=True)
        j = JCheckpoint(d, jnp.float32, keep_packed=True)
    else:
        j = JCheckpoint(ckpt_dir, jnp.float32)
    tree = j.talker_params
    if layout == "fused_int8":
        tree = dict(tree, layers=jtk.fuse_layer_projections(tree["layers"]))
        tree = jquantize_int8(tree, "codec_head")
    tcfg = TModelConfig.from_json(os.path.join(j.model_dir, "config.json")).talker_config
    return tree, from_jax_params(tree, "cpu"), j.config.talker_config, tcfg


@pytest.mark.parametrize("layout", ["dense_f32", "fused_int8", "packed_int4"])
def test_activation_stats_matches_jax(ckpt_dir, tmp_path_factory, layout):
    """``talker.activation_stats`` against the JAX function on converted
    weights, a 21-token sequence (f32 activations)."""
    jtree, ttree, cfg, tcfg = _talker_trees(layout, ckpt_dir, tmp_path_factory)
    x = (np.random.default_rng(3).standard_normal((1, 21, cfg.hidden_size)) * 0.5).astype(np.float32)
    want = np.asarray(jtk.activation_stats(jtree, cfg, jnp.asarray(x)))
    got = ttk.activation_stats(ttree, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 128)
    assert want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, **ACT)


@pytest.fixture(scope="module")
def models(ckpt_dir):
    return _load_port(ckpt_dir, "cpu"), _load_jax(ckpt_dir)


def _profiled(model, prof_cls, on_token):
    prof = prof_cls()
    prof.enable(model.talker_cfg.num_hidden_layers, model.talker_cfg.intermediate_size)
    model.activation_profiler = prof
    try:
        model.generate("Hello world", speaker="Aiden", temperature=0.0, max_tokens=6, seed=0,
                       on_token=(lambda t: None) if on_token else None)
    finally:
        model.activation_profiler = None
    prof.flush_run()
    return prof


@pytest.mark.parametrize("path", ["one_call", "on_token"])
def test_profiled_generation_matches_jax(models, path):
    """A greedy ``generate`` with the profiler on, in both packages, on the
    one-call path (``_generate_and_decode``) and on the ``on_token`` path:
    one run each, the same frames, equal maxima and sums."""
    port, jax_ = models
    on_token = path == "on_token"
    a, b = _profiled(port, ActivationProfiler, on_token), _profiled(jax_, JProfiler, on_token)
    assert a.run_count == b.run_count == 1
    assert port.last_info.generation_token_count == jax_.last_info.generation_token_count
    assert a._max.shape == (2, 128) and a._max.max() > 0
    np.testing.assert_allclose(a._max, b._max, **ACT)
    np.testing.assert_allclose(a._sum, b._sum, **ACT)


def test_profile_replay_under_a_tp_mesh_matches_unsharded(models, ckpt_dir, monkeypatch):
    """The replay on a 2-position tensor-parallel model (``["cpu"] * 2``,
    the per-position step of ``_tp_stack``) records the unsharded replay's
    maxima."""
    port = models[0]
    calls = []
    real = port._profile_replay
    monkeypatch.setattr(port, "_profile_replay", lambda *a: (calls.append(a), real(*a))[1])
    unsharded = _profiled(port, ActivationProfiler, on_token=False)
    (args,) = calls
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tp = Qwen3TTSModel.from_pretrained(ckpt_dir, dtype=torch.float32, device="cpu",
                                           mesh=make_mesh(["cpu"] * 2, tp=2))
    prof = ActivationProfiler()
    prof.enable(2, 128)
    tp.activation_profiler = prof
    tp._profile_replay(*args)
    prof.flush_run()
    assert prof.run_count == 1
    np.testing.assert_allclose(prof._max, unsharded._max, **ACT)


def test_profile_json_matches_jax(ckpt_dir, tmp_path, monkeypatch):
    """``--profile`` (greedy, 6 frames, two of the fixtures) writes the JAX
    CLI's JSON: the same keys and run count, equal maxima and means."""
    texts = [("Hello world", "en"), ("Good morning friend", "english")]
    monkeypatch.setattr(cli, "PROFILING_TEXTS", texts)
    monkeypatch.setattr(jcli, "PROFILING_TEXTS", texts)
    dumps = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        path = str(tmp_path / f"{name}.json")
        argv = ["--model", ckpt_dir, "--profile", "--speaker", "Aiden", "--profile-output",
                path] + GREEDY + (["--device", "cpu"] if name == "port" else [])
        with _patched_loaders():
            rc, stdout, _ = _run(main, argv)
        assert rc == 0 and "ACTIVATION PROFILING RESULTS (2 runs)" in stdout
        dumps[name] = json.load(open(path))
    a, b = dumps["port"], dumps["jax"]
    assert a.keys() == b.keys() and a["run_count"] == b["run_count"] == 2
    assert (a["num_layers"], a["intermediate_size"]) == (2, 128)
    for la, lb in zip(a["layers"], b["layers"]):
        assert la["layer"] == lb["layer"]
        np.testing.assert_allclose(la["max_activations"], lb["max_activations"], **ACT)
        np.testing.assert_allclose(la["mean_activations"], lb["mean_activations"], **ACT)
