"""The port's lockstep batched decode and int8 KV cache against the JAX
package, on the same tiny float32 weights (the host_init functions, vocoder
weights moved across with the weight bridge), at temperature 0.

Tolerances:
* ``quantize_kv_rows`` / ``dequantize_kv``: bit-equal.
* float32 forwards (``forward_batched_step`` on bf16 and int8 caches at
  ragged offsets, ``forward`` on an int8 cache): max|a - b| / max(1, max|b|)
  <= 1e-5 on a bf16 cache (float32 rounding, as tests/test_numpy_oracle.py).
  On an int8 cache both packages attend over bf16 rows with probabilities
  rounded to bf16, where float32 noise flips single roundings (2^-8
  relative): 0.01, on the hidden state and on the row scales (layer l's
  rows inherit layer l-1's noise). int8 rows differ by at most 1, at no
  more than 1 % of the elements (a value that straddles a rounding
  boundary).
* Greedy codes, frame counts and per-sequence caps: equal.
* Waveforms: within 1e-5 of the pre-clip signal's scale (< 40 here), as
  tests/test_torch_vocoder.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu.models import batch_generate as jbg
from qwen3tts_tpu.models import generate as jgen
from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.models import vocoder as jvc
from qwen3tts_tpu.tts import Qwen3TTSModel as JModel
from qwen3tts_tpu.utils import host_init as jhi
from qwen3tts_tpu_torch import tts as ttts
from qwen3tts_tpu_torch.models import batch_generate as tbg
from qwen3tts_tpu_torch.models import generate as tgen
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.utils.convert import from_jax_params

from synthetic_ckpt import StubTokenizer
from test_models import TINY_CP, TINY_TALKER
from test_torch_generate import _tiny_model_configs

H = TINY_TALKER.hidden_size
GREEDY_J = jgen.SamplingConfig(0.0, 0, 1.0, 1.0)
GREEDY_T = tgen.SamplingConfig(0.0, 0, 1.0, 1.0)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.fixture(scope="module")
def params():
    jt = jhi.to_device(jhi.host_init_talker_params(0, TINY_TALKER), jnp.float32)
    jc = jhi.to_device(jhi.host_init_cp_params(1, TINY_CP, H), jnp.float32)
    return jt, jc, from_jax_params(jt, "cpu"), from_jax_params(jc, "cpu")


def test_quantize_kv_rows_bit_equal():
    x = rand(3, 4, 5, 16, seed=1, scale=2.0)
    x[0, 0, 0] = np.arange(16) - 7.5  # exact halves after scaling: round half to even
    x[0, 0, 1] = 0.0  # an all-zero row: the 1e-12 scale floor
    qj, sj = jtk.quantize_kv_rows(jnp.asarray(x))
    qt, st = ttk.quantize_kv_rows(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert (qt.numpy() == np.asarray(qj)).all()
    assert st.numpy().tobytes() == np.asarray(sj).tobytes()
    dj = jtk.dequantize_kv(qj, sj)
    dt = ttk.dequantize_kv(qt, st)
    assert dt.dtype == torch.bfloat16
    assert dt.view(torch.int16).numpy().tobytes() == np.asarray(dj).view(np.int16).tobytes()


def _prefilled(jt, tt, kv_quant: bool, B=3, T=32, P=8, seed=3):
    """Both packages' caches after one batched prefill of P rows."""
    pre = rand(B, P, H, seed=seed, scale=0.1)
    jc = jtk.make_cache(TINY_TALKER, B, T, jnp.float32, quantized=kv_quant)
    _, jc = jtk.forward(jt, TINY_TALKER, jnp.asarray(pre), jc, jnp.int32(0))
    tc = ttk.make_cache(TINY_TALKER, B, T, torch.float32, quantized=kv_quant)
    ttk.forward(tt, TINY_TALKER, torch.from_numpy(pre), tc, 0)
    return jc, tc


def _assert_caches_close(tc, jc):
    for a, b in zip(tc, jc):
        b = np.asarray(b)
        if b.dtype == np.int8:
            d = np.abs(a.numpy().astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and d.mean() <= 0.01
        elif tc.quantized:  # row scales, relative to the largest
            assert np.abs(a.numpy() - b).max() <= 0.01 * np.abs(b).max()
        else:
            assert scaled(a.float().numpy(), b.astype(np.float32)) <= 1e-5


@pytest.mark.parametrize("kv_quant", [False, True])
def test_forward_batched_step_matches_jax(params, kv_quant):
    """Two decode steps of three sequences at ragged offsets; the new rows
    land at each sequence's own offset (quantized first for int8)."""
    jt, _, tt, _ = params
    jc, tc = _prefilled(jt, tt, kv_quant)
    _assert_caches_close(tc, jc)
    tol = 0.01 if kv_quant else 1e-5
    offs = np.array([4, 8, 6], np.int32)
    for step in range(2):
        x = rand(3, 1, H, seed=10 + step, scale=0.1)
        hj, jc = jtk.forward_batched_step(jt, TINY_TALKER, jnp.asarray(x), jc, jnp.asarray(offs + step))
        ht, tc = ttk.forward_batched_step(tt, TINY_TALKER, torch.from_numpy(x), tc,
                                          torch.from_numpy(offs + step))
        assert ht.shape == (3, 1, H)
        assert scaled(ht.numpy(), np.asarray(hj)) <= tol, step
    assert type(tc) is (ttk.KVCacheQ if kv_quant else ttk.KVCache)
    _assert_caches_close(tc, jc)


def test_forward_int8_cache_prefill_then_decode(params):
    """``forward`` on a KVCacheQ: prefill rows quantized into the cache, the
    attention over the dequantized bf16 rows, then two decode steps."""
    jt, _, tt, _ = params
    jc, tc = _prefilled(jt, tt, True, B=1, P=9)
    assert tc.k.dtype == torch.int8 and tc.ks.dtype == torch.float32
    for off in (9, 10):
        x = rand(1, 1, H, seed=off, scale=0.1)
        hj, jc = jtk.forward(jt, TINY_TALKER, jnp.asarray(x), jc, jnp.int32(off))
        ht, tc = ttk.forward(tt, TINY_TALKER, torch.from_numpy(x), tc, off)
        assert scaled(ht.numpy(), np.asarray(hj)) <= 0.01, off
    _assert_caches_close(tc, jc)


def test_bridge_carries_a_quantized_cache(params):
    jt, _, tt, _ = params
    jc, _ = _prefilled(jt, tt, True)
    tc = from_jax_params(jc, "cpu")
    assert type(tc) is ttk.KVCacheQ and tc.quantized and tc.max_len == 32
    for a, b in zip(tc, jc):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    assert type(from_jax_params(jtk.make_cache(TINY_TALKER, 1, 8), "cpu")) is ttk.KVCache


def _batch_inputs():
    p0, p1 = rand(7, H, seed=4, scale=0.1), rand(5, H, seed=5, scale=0.1)
    t0, t1 = rand(4, H, seed=6, scale=0.1), rand(3, H, seed=7, scale=0.1)
    P, T = 8, 5
    prefill = np.stack([np.pad(p0, ((0, P - 7), (0, 0))), np.pad(p1, ((0, P - 5), (0, 0)))])
    trailing = np.stack([np.pad(t0, ((0, T - 4), (0, 0))), np.pad(t1, ((0, T - 3), (0, 0)))])
    return prefill, [7, 5], trailing, [4, 3]


def _both_batches(params, kv_quant: bool, caps, max_frames=12):
    jt, jc, tt, tc = params
    prefill, plens, trailing, tlens = _batch_inputs()
    rj = jbg.generate_codes_batch(
        jt, jc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=GREEDY_J,
        prefill_embeds=jnp.asarray(prefill), prefill_lens=jnp.asarray(plens),
        trailing_embeds=jnp.asarray(trailing), trailing_lens=jnp.asarray(tlens),
        tts_pad_embed=jnp.zeros((H,)),
        cache=jtk.make_cache(TINY_TALKER, 2, 64, jnp.float32, quantized=kv_quant),
        max_steps=jnp.asarray(caps), max_frames=max_frames, key=jax.random.PRNGKey(0),
    )
    rt = tbg.generate_codes_batch(
        tt, tc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=GREEDY_T,
        prefill_embeds=torch.from_numpy(prefill), prefill_lens=plens,
        trailing_embeds=torch.from_numpy(trailing), trailing_lens=tlens,
        tts_pad_embed=torch.zeros(H),
        cache=ttk.make_cache(TINY_TALKER, 2, 64, torch.float32, quantized=kv_quant),
        max_steps=caps, max_frames=max_frames, seed=0,
    )
    return rj, rt


@pytest.mark.parametrize("kv_quant", [False, True])
def test_generate_codes_batch_matches_jax(params, kv_quant):
    """B=2 lockstep greedy, prompts of 7 and 5, trailing 4 and 3, caps 6 and
    4: codes, tokens and frame counts equal, on either cache."""
    rj, rt = _both_batches(params, kv_quant, [6, 4])
    assert rt.n_frames.tolist() == np.asarray(rj.n_frames).tolist() == [6, 4]
    assert (rt.codes.numpy() == np.asarray(rj.codes)).all()
    assert (rt.tokens.numpy() == np.asarray(rj.tokens)).all()


def test_per_sequence_caps_match_jax(params):
    rj, rt = _both_batches(params, False, [2, 5], max_frames=8)
    assert rt.n_frames.tolist() == np.asarray(rj.n_frames).tolist() == [2, 5]
    assert (rt.codes.numpy() == np.asarray(rj.codes)).all()


def test_batch_row_matches_single_sequence(params):
    """Row 1 of the lockstep batch equals a B=1 run of its own prompt."""
    jt, jc, tt, tc = params
    prefill, plens, trailing, tlens = _batch_inputs()
    _, rt = _both_batches(params, False, [6, 4])
    single = tgen.generate_codes(
        tt, tc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=GREEDY_T,
        prefill_embeds=torch.from_numpy(prefill[1:]), prefill_len=5,
        trailing_embeds=torch.from_numpy(trailing[1]), trailing_len=3,
        tts_pad_embed=torch.zeros(H), max_steps=4, max_frames=12, seed=0, cache_len=64,
    )
    assert single.n_frames == 4
    assert (rt.codes[1].numpy() == single.codes.numpy()).all()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_admit_slot_matches_jax(params, kv_quant):
    """Two chunks of a B=2 batch with a new request admitted into slot 0 in
    between: every per-slot field and the codes equal JAX's."""
    jt, jc, tt, tc = params
    prefill, plens, trailing, tlens = _batch_inputs()
    new_p = np.pad(rand(6, H, seed=8, scale=0.1), ((0, 2), (0, 0)))
    new_t = np.pad(rand(2, H, seed=9, scale=0.1), ((0, 3), (0, 0)))
    caps = [3, 6]
    jkw = dict(talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=GREEDY_J)
    tkw = dict(talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=GREEDY_T)
    jcar = jbg.prefill_start_batch(
        jt, jc, **jkw, prefill_embeds=jnp.asarray(prefill), prefill_lens=jnp.asarray(plens),
        trailing_embeds=jnp.asarray(trailing), trailing_lens=jnp.asarray(tlens),
        tts_pad_embed=jnp.zeros((H,)),
        cache=jtk.make_cache(TINY_TALKER, 2, 64, jnp.float32, quantized=kv_quant),
        max_frames=12, key=jax.random.PRNGKey(0))
    tcar = tbg.prefill_start_batch(
        tt, tc, **tkw, prefill_embeds=torch.from_numpy(prefill), prefill_lens=torch.tensor(plens),
        trailing_embeds=torch.from_numpy(trailing), trailing_lens=torch.tensor(tlens),
        tts_pad_embed=torch.zeros(H),
        cache=ttk.make_cache(TINY_TALKER, 2, 64, torch.float32, quantized=kv_quant),
        max_frames=12, seed=0)
    j_trail, t_trail = jnp.asarray(trailing), torch.from_numpy(trailing.copy())

    def chunk(until, jcar, tcar, jl, tl):
        jcar = jbg.generate_chunk_batch(
            jt, jc, jcar, **jkw, trailing_embeds=j_trail, trailing_lens=jnp.asarray(jl),
            tts_pad_embed=jnp.zeros((H,)), max_steps=jnp.asarray(caps), until_step=jnp.int32(until))
        tcar = tbg.generate_chunk_batch(
            tt, tc, tcar, **tkw, trailing_embeds=t_trail, trailing_lens=torch.tensor(tl),
            tts_pad_embed=torch.zeros(H), max_steps=torch.tensor(caps), until_step=until)
        return jcar, tcar

    jcar, tcar = chunk(4, jcar, tcar, tlens, tlens)
    assert bool(tcar.done[0]) and bool(jcar.done[0])  # slot 0 reached its cap of 3
    jcar, j_trail = jbg.admit_slot(
        jt, jc, jcar, j_trail, **jkw, slot=jnp.int32(0), prefill_embeds=jnp.asarray(new_p[None]),
        prefill_len=jnp.int32(6), trailing_row=jnp.asarray(new_t), trailing_len=jnp.int32(2),
        tts_pad_embed=jnp.zeros((H,)), key=jax.random.PRNGKey(1))
    tcar, t_trail = tbg.admit_slot(
        tt, tc, tcar, t_trail, **tkw, slot=0, prefill_embeds=torch.from_numpy(new_p[None]),
        prefill_len=6, trailing_row=torch.from_numpy(new_t), trailing_len=2,
        tts_pad_embed=torch.zeros(H), seed=1)
    caps = [4, 6]
    jcar, tcar = chunk(12, jcar, tcar, [2, 3], [2, 3])
    for name in ("steps", "frames", "done", "offsets", "codes", "tokens"):
        assert (getattr(tcar, name).numpy() == np.asarray(getattr(jcar, name))).all(), name
    assert tcar.frames.tolist() == [4, 6]
    assert scaled(tcar.cur_input.numpy(), np.asarray(jcar.cur_input)) <= 1e-5
    for a, b in zip(tcar.cache, jcar.cache):
        assert scaled(a.float().numpy(), np.asarray(b, np.float32)) <= 1e-5


def test_generate_int8_kv_codes_match_jax(params):
    """``generate_codes`` on an int8 cache (what ``generate()`` runs under
    ``kv_cache_dtype="int8"``), greedy: codes equal JAX's on KVCacheQ."""
    jt, jc, tt, tc = params
    prefill, trailing, pad = rand(1, 64, H, seed=5, scale=0.1), rand(16, H, seed=6, scale=0.1), rand(H, seed=7, scale=0.1)
    rj = jgen.generate_codes(
        jt, jc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=GREEDY_J,
        prefill_embeds=jnp.asarray(prefill), prefill_len=jnp.int32(11),
        trailing_embeds=jnp.asarray(trailing), trailing_len=jnp.int32(6),
        tts_pad_embed=jnp.asarray(pad), max_steps=jnp.int32(8), max_frames=12,
        key=jax.random.PRNGKey(0),
        cache=jtk.make_cache(TINY_TALKER, 1, 128, jnp.float32, quantized=True),
    )
    rt = tgen.generate_codes(
        tt, tc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=GREEDY_T,
        prefill_embeds=torch.from_numpy(prefill), prefill_len=11,
        trailing_embeds=torch.from_numpy(trailing), trailing_len=6,
        tts_pad_embed=torch.from_numpy(pad), max_steps=8, max_frames=12, seed=0,
        cache_len=128, kv_quant=True,
    )
    assert rt.n_frames == int(rj.n_frames) == 8
    assert (rt.codes.numpy() == np.asarray(rj.codes)).all()


def _models(kv_cache_dtype="bf16"):
    jm_cfg, jtok = _tiny_model_configs(True)
    tm_cfg, ttok = _tiny_model_configs(False)
    tcfg = jm_cfg.talker_config
    jt = jhi.to_device(jhi.host_init_talker_params(3, tcfg), jnp.float32)
    jc = jhi.to_device(jhi.host_init_cp_params(4, tcfg.code_predictor_config, tcfg.hidden_size),
                       jnp.float32)
    jv = jax.jit(lambda k: jvc.init_vocoder_params(k, jtok.decoder_config, jnp.float32))(
        jax.random.PRNGKey(2))
    jm = JModel(jm_cfg, jt, jc, jv, tokenizer_config=jtok, tokenizer=StubTokenizer(512),
                dtype=jnp.float32, kv_cache_dtype=kv_cache_dtype)
    tm = ttts.Qwen3TTSModel(
        tm_cfg, from_jax_params(jt, "cpu"), from_jax_params(jc, "cpu"), from_jax_params(jv, "cpu"),
        tokenizer_config=ttok, tokenizer=StubTokenizer(512), dtype=torch.float32, device="cpu",
        kv_cache_dtype=kv_cache_dtype)
    return jm, tm


def test_generate_batch_matches_jax():
    """``generate_batch`` of both packages, three texts of different lengths
    and caps, greedy: same waveform lengths, same samples."""
    jm, tm = _models()
    texts = ["hello there world", "a much longer sentence for the second voice", "hi"]
    kw = dict(speakers=["aiden", "vivian", "aiden"], language="english", temperature=0.0,
              max_tokens=9, seed=0)
    wj = jm.generate_batch(texts, **kw)
    wt = tm.generate_batch(texts, **kw)
    assert len(wt) == 3
    for a, b in zip(wt, wj):
        assert a.shape == np.asarray(b).shape and a.dtype == np.float32 and len(a) > 0
        assert np.isfinite(a).all()
        assert np.abs(a - np.asarray(b)).max() <= 1e-5 * 40
    with pytest.raises(ttts.Qwen3TTSError, match="not ported"):
        tm.generate_batch(texts, dp_mesh=object())
    with pytest.raises(ttts.Qwen3TTSError, match="equal lengths"):
        tm.generate_batch(texts, speakers=["aiden"])


def test_generate_batch_splits_into_lockstep_groups(monkeypatch):
    """More texts than one lockstep call takes (MAX_BATCH, lowered to 2
    here) run as groups of at most MAX_BATCH, group g drawing from seed + g;
    greedy, the waveforms equal one undivided batch's."""
    _, tm = _models()
    texts = ["hello there world", "a much longer sentence for the second voice", "hi"]
    kw = dict(speakers=["aiden", "vivian", "aiden"], language="english", temperature=0.0,
              max_tokens=9, seed=5)
    whole = tm.generate_batch(texts, **kw)
    calls = []
    real = tbg.generate_codes_batch

    def spy(*a, **k):
        calls.append((k["prefill_embeds"].shape[0], k["seed"]))
        return real(*a, **k)

    monkeypatch.setattr(tbg, "generate_codes_batch", spy)
    monkeypatch.setattr(ttts, "MAX_BATCH", 2)
    parts = tm.generate_batch(texts, **kw)
    assert calls == [(2, 5), (1, 6)]
    assert len(parts) == 3
    for a, b in zip(parts, whole):
        assert a.shape == b.shape and len(a) > 0
        assert np.abs(a - b).max() <= 1e-5 * 40


def test_generate_int8_kv_matches_jax():
    """``Qwen3TTSModel(..., kv_cache_dtype="int8").generate``, greedy: the
    same frame count and waveform as the JAX package's."""
    jm, tm = _models("int8")
    assert tm.kv_quant
    kw = dict(speaker="vivian", language="english", temperature=0.0, max_tokens=7, seed=0)
    wj = np.asarray(jm.generate("int8 cache test", **kw))
    wt, info = tm.generate("int8 cache test", return_info=True, **kw)
    assert info.generation_token_count == jm.last_info.generation_token_count
    assert wt.shape == wj.shape and np.abs(wt - wj).max() <= 1e-5 * 40
    with pytest.raises(ttts.Qwen3TTSError, match="kv_cache_dtype"):
        ttts.Qwen3TTSModel(tm.config, {}, {}, device="cpu", kv_cache_dtype="fp8")


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without ``device=``, both entry points target CUDA and raise where no
    card is present (the card's presence is faked absent here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm_cfg, _ = _tiny_model_configs(False)
    with pytest.raises(ttts.Qwen3TTSError, match="no CUDA device"):
        ttts.Qwen3TTSModel(tm_cfg, {}, {})
    with pytest.raises(ttts.Qwen3TTSError, match="no CUDA device"):
        ttts.Qwen3TTSModel.from_pretrained(str(tmp_path))
    assert ttts.Qwen3TTSModel(tm_cfg, {}, {}, device="cpu").device.type == "cpu"
