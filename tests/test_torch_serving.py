"""The port's serving slice on the CPU: per-request sampling, the continuous
batcher against the JAX package's, the server and the service.

Same tiny float32 weights as tests/test_torch_batch.py (host_init, moved
across with the weight bridge). Tolerances:
* ``sample_token_vec`` against JAX's on the same logits, seen set and
  mask: greedy rows' tokens equal; every row's kept set equal, read as the
  ids 2000 draws at temperature 1e4 reach (each kept id is missed with
  probability < e^-30 there; the data keeps every cumulative mass
  more than 1e-5 from a top-p cut, so f32 rounding cannot move one).
  Against the port's scalar sampler on the same generator state: equal.
* The kernels' plain versions (``sample_row``, K1's and K2's) with per-row
  values: equal to the scalar calls with each row's values.
* ``generate_codes_batch`` with ``per_request``: a uniform table bit-equal
  to the scalar batch; a greedy row among sampled rows equal to the
  all-greedy run's row (which tests/test_torch_batch.py holds equal to
  JAX's).
* ``ContinuousBatcher.run`` (the server's loop; JAX's batcher prefills its
  first wave in one batch), greedy, against JAX's: codes and frame counts
  equal per request, on a bf16 cache, and on an int8 cache with
  per-request repetition penalties (greedy rows on sampled defaults).
* The server and the service (port only): greedy codes equal each
  request's single-sequence run; waveforms within 1e-5 of the pre-clip
  scale (< 40), as tests/test_torch_batch.py.

The service tests build the tiny model directly (``from_pretrained`` would
first import transformers for a text tokenizer, ~9 s);
tests/test_torch_serving_http.py serves a synthetic checkpoint through
``from_pretrained``.
"""

import dataclasses
import gc
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu import serving as jsrv
from qwen3tts_tpu.ops import sampling as jsamp
from qwen3tts_tpu_torch import serving as tsrv
from qwen3tts_tpu_torch import tts as ttts
from qwen3tts_tpu_torch.models import batch_generate as tbg
from qwen3tts_tpu_torch.models import generate as tgen
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.ops import cp_kernel as tcpk
from qwen3tts_tpu_torch.ops import talker_kernel as tkk
from qwen3tts_tpu_torch.ops.decode_blocks import row_sampling, samp_rows, sample_row
from qwen3tts_tpu_torch.ops.quant import quantize_decode_params_int8
from qwen3tts_tpu_torch.ops.rope import mrope_cos_sin
from qwen3tts_tpu_torch.ops.sampling import sample_token_inner, sample_token_vec
from qwen3tts_tpu_torch.utils import host_init as thi

from synthetic_ckpt import StubTokenizer, write_checkpoint
from test_models import TINY_CP, TINY_TALKER
from test_torch_batch import GREEDY_J, GREEDY_T, H, params, rand  # noqa: F401
from test_torch_generate import _tiny_model_configs

V = TINY_TALKER.vocab_size
EOS = TINY_TALKER.codec_eos_token_id
# (temperature, top_k, top_p, repetition_penalty): greedy, top_k 0 / 1 / 20,
# top_p 1 / 0.8, penalty 1 / 1.2
MIXED = np.asarray([
    [0.0, 0, 1.0, 1.0], [0.0, 20, 0.8, 1.2], [0.9, 0, 1.0, 1.0], [0.9, 1, 1.0, 1.2],
    [0.9, 20, 1.0, 1.0], [0.9, 20, 0.8, 1.2], [0.9, 0, 0.8, 1.0], [1.3, 7.9, 0.5, 1.05],
], np.float32)


def _sampler_case(B=8, V_=64, seed=0):
    g = np.random.default_rng(seed)
    logits = (g.standard_normal((B, V_)) * 3).astype(np.float32)
    logits[:, 5] = logits.min(axis=1) - 1.0  # EOS (id 5) below every top-k: restored
    seen = g.random((B, V_)) < 0.2
    mask = np.zeros(V_, bool)
    mask[-4:] = True
    return logits, seen, mask


def _kept_by_draws(fn, logits, rows, seen, n=2000):
    """The ids each row's draws reach at temperature 1e4 (sampled rows)."""
    B = logits.shape[0]
    vec = np.repeat(rows, n, axis=0)
    vec[:, 0] = np.where(vec[:, 0] > 0, 1e4, 0.0)
    toks = np.asarray(fn(np.repeat(logits, n, axis=0), vec, np.repeat(seen, n, axis=0)))
    return [set(t.tolist()) for t in toks.reshape(B, n)]


@pytest.mark.parametrize("ref_exact", [False, True])
def test_sample_token_vec_matches_jax(ref_exact):
    logits, seen, mask = _sampler_case()
    kw = dict(eos_token_id=5, ref_exact_top_p=ref_exact)

    def jax_fn(lg, vec, sn):
        return jsamp.sample_token_vec(
            jax.random.PRNGKey(3), jnp.asarray(lg), temperature=jnp.asarray(vec[:, 0]),
            top_k=jnp.asarray(vec[:, 1]).astype(jnp.int32), top_p=jnp.asarray(vec[:, 2]),
            repetition_penalty=jnp.asarray(vec[:, 3]), seen=jnp.asarray(sn),
            suppress_mask=jnp.asarray(mask), **kw)

    def port_fn(lg, vec, sn):
        return sample_token_vec(
            torch.Generator().manual_seed(3), torch.from_numpy(lg), temperature=vec[:, 0],
            top_k=vec[:, 1], top_p=vec[:, 2], repetition_penalty=vec[:, 3],
            seen=torch.from_numpy(sn), suppress_mask=torch.from_numpy(mask), **kw)

    greedy = MIXED[:, 0] <= 0
    assert (np.asarray(jax_fn(logits, MIXED, seen))[greedy]
            == port_fn(logits, MIXED, seen).numpy()[greedy]).all()
    # the cuts lie clear of f32 rounding (see the docstring)
    for b in np.nonzero((MIXED[:, 2] < 1) & ~greedy)[0]:
        z = torch.from_numpy(logits[b]).masked_fill(torch.from_numpy(mask), float("-inf"))
        k = int(MIXED[b, 1])
        if 0 < k < z.numel():
            z = torch.where(z >= torch.topk(z, k).values[-1], z, float("-inf"))
        mass = torch.exp(z) if ref_exact else torch.softmax(z, -1)
        cum = torch.cumsum(mass[torch.argsort(z)], 0)
        assert (cum - (1 - MIXED[b, 2])).abs().min() > 1e-5, b
    kj = _kept_by_draws(jax_fn, logits, MIXED, seen)
    kt = _kept_by_draws(port_fn, logits, MIXED, seen)
    for b in np.nonzero(~greedy)[0]:
        assert kj[b] == kt[b], b
        assert 5 in kt[b]  # EOS restored past the filters
    z = np.where(seen[3], np.where(logits[3] < 0, logits[3] * 1.2, logits[3] / 1.2), logits[3])
    assert kt[3] == {int(np.argmax(np.where(mask, -np.inf, z))), 5}  # top_k 1


def test_sample_token_vec_rows_equal_the_scalar_sampler():
    """Row b of ``sample_token_vec`` equals ``sample_token_inner`` with row
    b's scalars on the same logits and generator state."""
    logits, seen, mask = _sampler_case(seed=1)
    lt, st, mt = torch.from_numpy(logits), torch.from_numpy(seen), torch.from_numpy(mask)
    for seed in range(4):
        out = sample_token_vec(torch.Generator().manual_seed(seed), lt, temperature=MIXED[:, 0],
                               top_k=MIXED[:, 1], top_p=MIXED[:, 2],
                               repetition_penalty=MIXED[:, 3], seen=st, suppress_mask=mt,
                               eos_token_id=5)
        for b, row in enumerate(MIXED):
            kw = row_sampling(row)
            one = sample_token_inner(
                torch.Generator().manual_seed(seed), lt, temperature=kw["temperature"],
                top_k=kw["top_k"], top_p=kw["top_p"], repetition_penalty=kw["rep_penalty"],
                seen=st, suppress_mask=mt, eos_token_id=5)
            assert int(out[b]) == int(one[b]), (seed, b)


@pytest.fixture(scope="module")
def fused(params):
    """The tiny talker and CP, fused and int8 (the kernels' plain versions
    take fused layouts)."""
    _, _, tt, tc = params
    tp = dict(tt, layers=ttk.fuse_layer_projections(tt["layers"]))
    cp = dict(tc, layers=ttk.fuse_layer_projections(tc["layers"]))
    to_bf16 = lambda t: {k: to_bf16(v) if isinstance(v, dict) else v.bfloat16()  # noqa: E731
                         for k, v in t.items()}
    return (quantize_decode_params_int8(to_bf16(tp), "codec_head"),
            quantize_decode_params_int8(to_bf16(cp), "lm_head"))


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_plain_kernels_take_per_row_values(fused, kernel):
    """K1's and K2's plain versions (the kernels' sampler is ``sample_row``
    per row) with a per-row table: a uniform table equals the scalar call,
    each mixed row equals the scalar call with its values, and a greedy
    row among sampled rows equals the all-greedy call's row."""
    tp, cp = fused
    mixed_rows = MIXED if kernel == "K1" else MIXED[[0, 2, 5, 7]]  # K2's plain loop: 15 heads a row
    B = mixed_rows.shape[0]
    g = torch.Generator().manual_seed(4)
    if kernel == "K1":
        T = 32
        cache = ttk.make_cache(TINY_TALKER, B, T, torch.bfloat16, quantized=False)
        cache.k.copy_(torch.randn(cache.k.shape, generator=g))
        cache.v.copy_(torch.randn(cache.v.shape, generator=g))
        offs = torch.randint(4, T - 1, (B,), generator=g)
        cos, sin = mrope_cos_sin(offs[:, None], TINY_TALKER.head_dim, TINY_TALKER.rope_theta,
                                 TINY_TALKER.mrope_section, torch.bfloat16)
        x = torch.randn(B, 1, H, generator=g).bfloat16()
        supp = torch.zeros(V)
        supp[V - 1024:] = -1e30
        seen = torch.rand(B, V, generator=g) < 0.01

        def call(**kw):
            c = type(cache)(*(t.clone() for t in cache))
            return tkk.talker_decode_step_ref(
                tp, TINY_TALKER, x, c, offs, cos[:, 0], sin[:, 0], eos_id=EOS, seed=(3, 9),
                suppress_add=supp, seen=seen, **kw)[1]
    else:
        h = torch.randn(B, H, generator=g).bfloat16()
        code0 = torch.randint(0, 2048, (B,), generator=g, dtype=torch.int32)

        def call(**kw):
            kw.pop("rep_penalty", None)  # the CP applies no penalty
            return tcpk.predict_codes_fused_ref(cp, TINY_CP, tp, h, code0, (3, 9), **kw)[0]

    scalar = dict(temperature=0.9, top_k=20, top_p=0.8, rep_penalty=1.2)
    uniform = np.tile(np.asarray([0.9, 20, 0.8, 1.2], np.float32), (B, 1))
    assert torch.equal(call(**scalar), call(**scalar, rows=samp_rows(uniform, "cpu")))
    mixed = call(**scalar, rows=samp_rows(mixed_rows, "cpu"))
    for b, row in enumerate(mixed_rows):
        assert torch.equal(mixed[b], call(**row_sampling(row))[b]), b
    greedy = call(temperature=0.0, top_k=0, top_p=1.0, rep_penalty=1.0)
    assert torch.equal(mixed[0], greedy[0])


def test_samp_rows_derive_the_kernels_scalars():
    """The kernels' per-row table holds what the scalar path passes:
    f32(1/t), greedy for t <= 0, top_k truncated, f32(1 - p) or 0."""
    rows = samp_rows(MIXED, "cpu")
    t = rows.table.numpy()
    assert t.shape == (8, 5) and t.dtype == np.float32
    assert (t[:, 1] == (MIXED[:, 0] <= 0)).all()
    assert t[2, 2] == np.float32(1 / 0.9) and t[0, 2] == 0.0
    assert t[7, 3] == 7 and t[2, 4] == 0.0
    assert t[5, 4] == np.float32(1.0 - float(np.float32(0.8)))
    assert (t[:, 0] == MIXED[:, 3]).all()


def _batch(tt, tc, sampling, samp_vec=None, caps=(6, 4)):
    prefill = np.stack([np.pad(rand(7, H, seed=4, scale=0.1), ((0, 1), (0, 0))),
                        np.pad(rand(5, H, seed=5, scale=0.1), ((0, 3), (0, 0)))])
    trailing = np.stack([np.pad(rand(4, H, seed=6, scale=0.1), ((0, 1), (0, 0))),
                         np.pad(rand(3, H, seed=7, scale=0.1), ((0, 2), (0, 0)))])
    return tbg.generate_codes_batch(
        tt, tc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=sampling,
        prefill_embeds=torch.from_numpy(prefill), prefill_lens=[7, 5],
        trailing_embeds=torch.from_numpy(trailing), trailing_lens=[4, 3],
        tts_pad_embed=torch.zeros(H), cache=ttk.make_cache(TINY_TALKER, 2, 64, torch.float32),
        max_steps=list(caps), max_frames=12, seed=0, samp_vec=samp_vec)


def test_generate_codes_batch_uniform_samp_vec_is_the_scalar_batch(params):
    _, _, tt, tc = params
    scal = tgen.SamplingConfig(0.9, 8, 1.0, 1.05, forbid_eos=True)
    a = _batch(tt, tc, scal)
    b = _batch(tt, tc, scal._replace(per_request=True),
               np.asarray([[0.9, 8.0, 1.0, 1.05]] * 2, np.float32))
    assert torch.equal(a.n_frames, b.n_frames) and torch.equal(a.codes, b.codes)
    with pytest.raises(ValueError, match="samp_vec"):
        _batch(tt, tc, scal._replace(per_request=True))


def test_greedy_row_among_sampled_rows(params):
    """A temperature-0 row beside a row sampled at 0.9 equals the all-greedy
    run's row."""
    _, _, tt, tc = params
    ref = _batch(tt, tc, GREEDY_T)
    out = _batch(tt, tc, tgen.SamplingConfig(0.9, 50, 1.0, 1.05, per_request=True),
                 np.asarray([[0.0, 0.0, 1.0, 1.0], [0.9, 50.0, 1.0, 1.05]], np.float32))
    n = int(ref.n_frames[0])
    assert int(out.n_frames[0]) == n
    assert torch.equal(out.codes[0, :n], ref.codes[0, :n])


# ---- the continuous batcher against JAX's ----

EOS_ITEM = 3  # its prompt's last row points the final hidden at EOS: done on its first frame


def _items(params):
    """Five requests: ragged prompts (4..9 rows) and caps (2..6), request 3
    sampling EOS on its first frame; numpy prompts and trailing rows."""
    _, _, tt, _ = params
    w = tt["codec_head"][:, EOS]
    out = []
    for i, (plen, cap) in enumerate([(6, 4), (9, 6), (4, 3), (7, 5), (5, 2)]):
        p = rand(1, plen, H, seed=100 + i, scale=0.1)
        if i == EOS_ITEM:
            p[0, -1] = (w / w.norm()).numpy() * 5.0
        out.append((p, rand(3, H, seed=200 + i, scale=0.1), cap))
    return out


PENALTIES = [1.0, 1.3, 1.0, 1.1, 1.5]


def _run_batchers(params, kv_quant: bool, per_request: bool):
    jt, jc, tt, tc = params
    common = dict(talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, slots=2, chunk_frames=3,
                  max_frames=16, kv_quant=kv_quant)
    if per_request:  # greedy rows with their own penalties on sampled defaults
        over = [dict(temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=r)
                for r in PENALTIES]
        js = jsrv.ContinuousBatcher(jt, jc, sampling=jsamp_cfg(True),
                                    tts_pad_embed=jnp.zeros((H,)), dtype=jnp.float32, **common)
        ts = tsrv.ContinuousBatcher(tt, tc, sampling=tgen.SamplingConfig(0.9, 50, 1.0, 1.05,
                                                                          per_request=True),
                                    tts_pad_embed=torch.zeros(H), dtype=torch.float32, **common)
    else:
        over = [{}] * 5
        js = jsrv.ContinuousBatcher(jt, jc, sampling=GREEDY_J, tts_pad_embed=jnp.zeros((H,)),
                                    dtype=jnp.float32, **common)
        ts = tsrv.ContinuousBatcher(tt, tc, sampling=GREEDY_T, tts_pad_embed=torch.zeros(H),
                                    dtype=torch.float32, **common)
    items = _items(params)
    jo = js.run([jsrv.BatchItem(prefill_embeds=jnp.asarray(p), trailing=jnp.asarray(t),
                                max_steps=c, **o) for (p, t, c), o in zip(items, over)])
    to = ts.run([tsrv.BatchItem(prefill_embeds=torch.from_numpy(p), trailing=torch.from_numpy(t),
                                max_steps=c, **o) for (p, t, c), o in zip(items, over)])
    return jo, to, ts


def jsamp_cfg(per_request):
    from qwen3tts_tpu.models import generate as jgen

    return jgen.SamplingConfig(0.9, 50, 1.0, 1.05)._replace(per_request=per_request)


BATCHER_CASES = [(False, False), (True, True)]


@pytest.fixture(scope="module")
def batcher_runs(params):
    """Each JAX batcher runs once per module: its compiles are the cost."""
    return {key: _run_batchers(params, *key) for key in BATCHER_CASES}


@pytest.mark.parametrize("key", BATCHER_CASES,
                         ids=["bf16 cache", "int8 cache, per-request penalties"])
def test_batcher_matches_jax(batcher_runs, key):
    jo, to, ts = batcher_runs[key]
    assert [o.n_frames for o in to] == [o.n_frames for o in jo]
    assert to[EOS_ITEM].n_frames == 0 and all(o.n_frames > 0 for i, o in enumerate(to)
                                              if i != EOS_ITEM)
    for a, b in zip(to, jo):
        assert (a.codes == np.asarray(b.codes)).all()
    assert 0 < ts.total_iterations < sum(o.n_frames for o in to)  # slots shared


def test_batcher_run_follows_each_seed(params):
    """Sampled runs: the same seeds give equal runs (the worker takes the
    whole list at once, so thread timing cannot move an admission); another
    seed on item 1 changes item 1's codes (its seed keys its first frame)."""
    _, _, tt, tc = params
    items = _items(params)[:2]

    def run(seeds):
        b = tsrv.ContinuousBatcher(tt, tc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP,
                                   sampling=tgen.SamplingConfig(1.0, 0, 1.0, 1.0, forbid_eos=True),
                                   tts_pad_embed=torch.zeros(H), slots=2, chunk_frames=3,
                                   max_frames=16, dtype=torch.float32)
        return b.run([tsrv.BatchItem(prefill_embeds=torch.from_numpy(p),
                                     trailing=torch.from_numpy(t), max_steps=c, seed=s)
                      for (p, t, c), s in zip(items, seeds)])

    a, b, c = run([1, 2]), run([1, 2]), run([1, 3])
    assert all((x.codes == y.codes).all() for x, y in zip(a, b))
    assert not (a[1].codes == c[1].codes).all()
    assert [o.lockstep_iterations for o in a] == [o.n_frames - 1 for o in a]


# ---- the server (port only) ----

def _server(params, sampling=GREEDY_T, **kw):
    _, _, tt, tc = params
    kw = dict(dict(slots=2, chunk_frames=2, max_frames=16, prompt_bucket=16, trailing_bucket=8,
                   cache_len=64), **kw)
    return tsrv.Qwen3TTSServer(tt, tc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=sampling,
                               tts_pad_embed=torch.zeros(H), dtype=torch.float32, **kw)


def _item(i, **over):
    plen, cap = 4 + (i * 7) % 9, 2 + (i * 5) % 5
    return tsrv.BatchItem(prefill_embeds=torch.from_numpy(rand(1, plen, H, seed=1000 + i,
                                                               scale=0.1)),
                          trailing=torch.from_numpy(rand(3, H, seed=2000 + i, scale=0.1)),
                          max_steps=cap, **over)


def _single(params, it):
    _, _, tt, tc = params
    plen = it.prefill_embeds.shape[1]
    res = tgen.generate_codes(
        tt, tc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=GREEDY_T,
        prefill_embeds=torch.nn.functional.pad(it.prefill_embeds, (0, 0, 0, 16 - plen)),
        prefill_len=plen, trailing_embeds=it.trailing, trailing_len=3,
        tts_pad_embed=torch.zeros(H), max_steps=it.max_steps, max_frames=16, seed=0, cache_len=64)
    return res.codes[: res.n_frames].numpy()


def test_server_soak_threads(params):
    """Three threads submit nine greedy requests to one server: every
    future resolves, each request's codes equal its single-sequence run
    (per-slot isolation under concurrent admission)."""
    srv = _server(params)
    items = [_item(i) for i in range(9)]
    futs, lock, cursor = [None] * 9, threading.Lock(), [0]

    def submitter():
        while True:
            with lock:
                i = cursor[0]
                if i >= 9:
                    return
                cursor[0] += 1
            futs[i] = srv.submit(items[i])

    threads = [threading.Thread(target=submitter) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    outs = [f.result(timeout=600) for f in futs]
    srv.close()
    for i, (it, out) in enumerate(zip(items, outs)):
        ref = _single(params, it)
        assert out.n_frames == len(ref) and (out.codes == ref).all(), i


def test_server_per_request_overrides(params):
    """Greedy overrides on sampled per-request defaults equal single runs;
    a frozen server refuses overrides at submit."""
    srv = _server(params, tgen.SamplingConfig(0.9, 50, 1.0, 1.05, per_request=True))
    items = [_item(i, temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.0)
             for i in range(3)]
    outs = [f.result(timeout=600) for f in [srv.submit(it) for it in items]]
    srv.close()
    for it, out in zip(items, outs):
        assert (out.codes == _single(params, it)).all()
    frozen = _server(params)
    with pytest.raises(ValueError, match="per-request"):
        frozen.submit(_item(0, temperature=0.0))
    frozen.close()


BAD_VALUES = [dict(temperature=float("nan")), dict(top_p=float("nan")),
              dict(top_k=float("inf")), dict(repetition_penalty=0.0),
              dict(repetition_penalty=float("nan")), dict(seed=-1), dict(seed=2**64)]


@pytest.mark.parametrize("bad", BAD_VALUES, ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_bad_values_are_refused_at_submit(params, bad):
    """A sampling value that is not finite, a penalty <= 0 or a seed the
    generator cannot take fails its own submit: in the worker it would
    leave the sampler no winner (NaN) and fault every request in flight."""
    srv = _server(params, tgen.SamplingConfig(0.9, 50, 1.0, 1.05, per_request=True))
    with pytest.raises(ValueError, match="finite|> 0|seed"):
        srv.submit(_item(0, **bad))
    assert not srv._started  # no device work was queued
    srv.close()


def test_server_cancel_queue_and_close(params):
    """A request cancelled while queued never runs; ``max_queue`` raises
    ``ServiceOverloaded``; ``close()`` finishes what it took and then
    refuses."""
    srv = _server(params, slots=1, max_queue=2)
    entered, gate = threading.Event(), threading.Event()
    real = tbg.admit_slot

    def slow_admit(*a, **k):
        entered.set()
        gate.wait(30)
        return real(*a, **k)

    tsrv.bg.admit_slot = slow_admit
    try:
        first = srv.submit(_item(0))  # taken by the worker, held at its admission
        assert entered.wait(30)
        queued = [srv.submit(_item(1)), srv.submit(_item(2))]
        with pytest.raises(tsrv.ServiceOverloaded):
            srv.submit(_item(3))
        assert queued[0].cancel()
    finally:
        gate.set()
        tsrv.bg.admit_slot = real
    srv.close()
    assert first.result(timeout=60).n_frames > 0 and queued[1].result(timeout=60).n_frames > 0
    assert queued[0].cancelled()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(_item(4))


def test_a_worker_fault_fails_every_future(params, monkeypatch):
    srv = _server(params, slots=1)
    gate = threading.Event()

    def broken(*a, **k):
        gate.wait(30)  # the other requests are queued by then
        raise RuntimeError("device fault")

    monkeypatch.setattr(tsrv.bg, "admit_slot", broken)
    fut, prog = srv.submit_stream(_item(0))
    others = [srv.submit(_item(i)) for i in (1, 2)]
    gate.set()
    for f in [fut] + others:
        with pytest.raises(RuntimeError, match="device fault"):
            f.result(timeout=60)
    with pytest.raises(RuntimeError, match="device fault"):
        prog.wait_beyond(0, timeout=60)
    srv._thread.join(60)


def test_slot_progress_after_a_cancel_reports_done():
    """``wait_beyond`` after a cancel returns done (the JAX feed returned
    the same snapshot, not done, so a reader that did not cancel spun);
    publishing coalesces; a failure reaches the waiter; a timeout raises."""
    p = tsrv.SlotProgress()
    p.publish(np.zeros((2, 16), np.int32), 2, False)
    p.publish(np.zeros((5, 16), np.int32), 5, False)
    assert p.wait_beyond(0, timeout=1)[1:] == (5, False)
    threading.Thread(target=lambda: (time.sleep(0.05), p.cancel())).start()
    codes, n, done = p.wait_beyond(5, timeout=10)
    assert n == 5 and done and p.cancelled
    with pytest.raises(TimeoutError):
        tsrv.SlotProgress().wait_beyond(0, timeout=0.05)
    r = tsrv.SlotProgress()
    threading.Thread(target=lambda: (time.sleep(0.05), r.fail(RuntimeError("died")))).start()
    with pytest.raises(RuntimeError, match="died"):
        r.wait_beyond(0, timeout=10)


def test_lockstep_functions_take_the_turn(params, monkeypatch):
    """``prefill_start_batch``, ``generate_chunk_batch`` and ``admit_slot``
    each run in their device's turn (recorded with a stand-in
    ``device_turn``; off CUDA the real one holds nothing)."""
    import contextlib

    turns = []

    @contextlib.contextmanager
    def turn(dev):
        turns.append(("enter", dev.type))
        yield
        turns.append(("exit", dev.type))

    monkeypatch.setattr(tbg, "device_turn", turn)
    _, _, tt, tc = params
    ts = tsrv.ContinuousBatcher(tt, tc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP,
                                sampling=GREEDY_T, tts_pad_embed=torch.zeros(H), slots=1,
                                chunk_frames=8, max_frames=16, dtype=torch.float32)
    calls = {}
    for name in ("prefill_start_batch", "generate_chunk_batch", "admit_slot"):
        real = getattr(tbg, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.setdefault(_name, []).append(len(turns))
            out = _real(*a, **k)
            assert turns[-1] == ("exit", "cpu") and len(turns) == calls[_name][-1] + 2, _name
            return out

        monkeypatch.setattr(tsrv.bg, name, spy)
    ts.run([_item(0), _item(1)])  # the server's loop: admissions and chunks
    _batch(tt, tc, GREEDY_T)  # generate_codes_batch: a batched prefill, then a chunk
    assert set(calls) == {"prefill_start_batch", "generate_chunk_batch", "admit_slot"}


# ---- the service (a synthetic checkpoint, the stub tokenizer) ----

def service_model(tmp_path_factory):
    """``from_pretrained`` of a synthetic checkpoint on the CPU (the HTTP
    tests' model). torch's gathers raise where JAX's clamp: the tts special
    ids go inside the 512-entry text vocabulary and the vocoder takes full
    2048-entry codebooks (tests/test_torch_loader.py does the same)."""
    d = write_checkpoint(str(tmp_path_factory.mktemp("serve_ckpt")))
    with pytest.warns(UserWarning, match="tokenizer"):
        m = ttts.Qwen3TTSModel.from_pretrained(d, dtype=torch.float32, device="cpu")
    m.tokenizer = StubTokenizer()
    m.config = dataclasses.replace(m.config, tts_bos_token_id=500, tts_eos_token_id=501,
                                   tts_pad_token_id=502)
    m.tokenizer_config = _tiny_model_configs(False)[1]
    m.vocoder_params = thi.init_vocoder_params(
        torch.Generator().manual_seed(2), m.tokenizer_config.decoder_config, torch.float32, "cpu")
    return m


@pytest.fixture(scope="module")
def model():
    """The tiny CustomVoice model of tests/test_torch_batch.py, port only."""
    cfg, tok = _tiny_model_configs(False)
    tc = cfg.talker_config
    g = torch.Generator().manual_seed(3)
    return ttts.Qwen3TTSModel(
        cfg, thi.to_device(thi.host_init_talker_params(3, tc), torch.float32, "cpu"),
        thi.to_device(thi.host_init_cp_params(4, tc.code_predictor_config, tc.hidden_size),
                      torch.float32, "cpu"),
        thi.init_vocoder_params(g, tok.decoder_config, torch.float32, "cpu"),
        tokenizer_config=tok, tokenizer=StubTokenizer(512), dtype=torch.float32, device="cpu")


SERVE = dict(slots=2, chunk_frames=3, max_frames=16, prompt_bucket=64, trailing_bucket=16)
GREEDY_SERVE = dict(SERVE, temperature=0.0, top_k=0, repetition_penalty=1.0)


def test_service_submit_and_stream_events(model):
    """``submit`` resolves to a finite waveform; ``submit_stream`` yields
    the stream contract: tokens, audio chunks tiling the utterance, one
    InfoEvent, the opt-in final AudioEvent. Bad defaults raise at serve."""
    with model.serve(**GREEDY_SERVE) as svc:
        fut = svc.submit("Hello number one", speaker="aiden", max_tokens=6, seed=1)
        events = list(svc.submit_stream("Streaming through slots", speaker="aiden",
                                        max_tokens=16, audio_chunk_frames=2, final_audio=True))
        audio = fut.result(timeout=600)
    assert audio.ndim == 1 and audio.shape[0] > 0 and np.isfinite(audio).all()
    toks = [e for e in events if isinstance(e, ttts.TokenEvent)]
    chunks = [e for e in events if isinstance(e, ttts.AudioChunkEvent)]
    assert [type(e).__name__ for e in events[-2:]] == ["InfoEvent", "AudioEvent"]
    assert events[-2].info.generation_token_count == len(toks) >= 1
    assert [c.frame_offset for c in chunks] == sorted(c.frame_offset for c in chunks)
    assert chunks[0].frame_offset == 0
    total = sum(c.audio.shape[0] for c in chunks)
    assert total == len(toks) * 1920 == events[-1].audio.shape[0]
    with pytest.raises(ttts.Qwen3TTSError, match="NoSuch"):
        with model.serve(**SERVE) as svc:
            svc.submit("Hi", speaker="NoSuchSpeaker")
    with pytest.raises(ttts.Qwen3TTSError, match="per-request"):
        with model.serve(**SERVE) as svc:
            svc.submit("Hi", speaker="aiden", temperature=0.5)
    with pytest.raises(ttts.Qwen3TTSError, match="finite"):
        model.serve(**dict(SERVE, top_p=float("nan")))


@pytest.mark.parametrize("how", ["closed after a token", "dropped unstarted"])
def test_a_stream_let_go_frees_its_slot(model, how, monkeypatch):
    """A stream closed after its first token, or dropped before it was
    iterated (the JAX service then decoded it to its cap), frees its slot
    within a chunk: a follow-up request on the one slot completes and the
    server ran far fewer lockstep frames than the abandoned cap. The
    worker's second chunk waits until the stream is let go, so the count
    does not depend on how fast this thread runs."""
    real, calls, let_go = tbg.generate_chunk_batch, [], threading.Event()

    def gated(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            let_go.wait(30)
        return real(*a, **k)

    monkeypatch.setattr(tsrv.bg, "generate_chunk_batch", gated)
    with model.serve(**dict(GREEDY_SERVE, slots=1)) as svc:
        stream = svc.submit_stream("Abandon this long one", speaker="aiden", max_tokens=16,
                                   audio_chunk_frames=2)
        if how == "closed after a token":
            next(ev for ev in stream if isinstance(ev, ttts.TokenEvent))
            stream.close()
        else:
            del stream
            gc.collect()
        let_go.set()
        audio = svc.submit("Short follow-up", speaker="aiden", max_tokens=4).result(timeout=600)
        iters = svc._server.total_iterations
    assert audio.shape[0] > 0
    assert iters < 12, iters


def test_generate_batch_continuous(model):
    """N texts over fewer slots: one waveform each, whole frames; the
    per-text seeds make the first text's audio independent of the rest."""
    texts = ["Hello there", "A longer second sentence", "Three"]
    kw = dict(speakers=["aiden"] * 3, temperature=0.0, top_k=0, repetition_penalty=1.0,
              max_tokens=6, slots=2)
    out = model.generate_batch_continuous(texts, **kw)
    assert len(out) == 3 and all(a.shape[0] % 1920 == 0 and np.isfinite(a).all() for a in out)
    alone = model.generate_batch_continuous(texts[:1], **dict(kw, speakers=["aiden"]))
    assert out[0].shape == alone[0].shape and np.abs(out[0] - alone[0]).max() <= 1e-5 * 40
    with pytest.raises(ttts.Qwen3TTSError, match="dp_mesh must be"):
        model.generate_batch_continuous(texts, dp_mesh=object())
    with pytest.raises(ttts.Qwen3TTSError, match="dp_mesh must be"):
        model.serve(dp_mesh=object())
