"""The port's data-parallel decode and serving (qwen3tts_tpu_torch/parallel/dp.py,
``dp_mesh=`` of tts.py and serving.py) and the public mesh surfaces, on the
CPU: meshes of ``["cpu"] * n``, whose shards take turns on the one device.

Oracles:
* greedy: the port's ``generate_codes_batch_dp`` at dp = 2, B = 4 gives the
  codes, frame counts and tokens of JAX's ``generate_codes_batch_dp`` on a
  dp = 2 mesh of its virtual CPU devices (the same f32 weights; codes are
  argmaxes of f32 logits, so equal);
* sampled: each shard equals the port's ``generate_codes_batch`` run alone
  on that shard's rows with ``shard_seed(seed, s)`` (bit-equal: the same
  calls on the same device);
* continuous: the dp pipeline (prefill, chunks with per-shard bounds, an
  admission into shard 1) equals the same pipeline composed per shard;
* the public API at temperature 0: ``dp_mesh=`` and ``mesh=`` give the
  waveforms of the calls without them, within 1e-5 of the pre-clip signal's
  scale (< 40 here), as tests/test_torch_batch.py holds its waveforms.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu.models import generate as jgen
from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.parallel import dp as jdp
from qwen3tts_tpu.parallel import mesh as jpm
from qwen3tts_tpu.utils import host_init as jhi
from qwen3tts_tpu_torch import serving as tsv
from qwen3tts_tpu_torch import tts as ttts
from qwen3tts_tpu_torch.models import batch_generate as tbg
from qwen3tts_tpu_torch.models import generate as tgen
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.parallel import dp as pdp
from qwen3tts_tpu_torch.parallel import mesh as pm
from qwen3tts_tpu_torch.utils import host_init as thi
from qwen3tts_tpu_torch.utils.convert import from_jax_params

from synthetic_ckpt import StubTokenizer, write_checkpoint
from test_parallel import TP_TALKER
from test_torch_generate import _tiny_model_configs

CPC = TP_TALKER.code_predictor_config
H = TP_TALKER.hidden_size
SAMPLED = tgen.SamplingConfig(0.9, 50, 1.0, 1.05)
GREEDY = tgen.SamplingConfig(0.0, 0, 1.0, 1.0)
COMMON = dict(talker_cfg=TP_TALKER, cp_cfg=CPC)
WAVE_TOL = 1e-5 * 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite's workers share
    the cores, and torch's default of one thread a core makes each small op
    wait on the others (the setting is restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    jt = jhi.to_device(jhi.host_init_talker_params(0, TP_TALKER), jnp.float32)
    jc = jhi.to_device(jhi.host_init_cp_params(1, CPC, H), jnp.float32)
    return jt, jc, from_jax_params(jt, "cpu"), from_jax_params(jc, "cpu")


def _batch(B=4):
    return dict(
        prefill_embeds=rand(B, 16, H, seed=3, scale=0.2),
        prefill_lens=np.asarray([16, 12, 9, 13][:B], np.int32),
        trailing_embeds=rand(B, 8, H, seed=4, scale=0.2),
        trailing_lens=np.asarray([8, 3, 5, 2][:B], np.int32),
        tts_pad_embed=np.zeros((H,), np.float32),
    )


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_dp_greedy_matches_jax(params):
    """dp = 2, B = 4, greedy: the codes, frame counts and tokens of JAX's
    shard_map'd ``generate_codes_batch_dp``."""
    jt, jc, tt, tc = params
    b = _batch()
    caps = np.asarray([5, 6, 4, 6], np.int32)
    got = pdp.generate_codes_batch_dp(
        tt, tc, mesh=pm.make_mesh(["cpu"] * 2, tp=1), **COMMON, sampling=GREEDY, **_t(b),
        cache=ttk.make_cache(TP_TALKER, 4, 128, torch.float32, "cpu"),
        max_steps=torch.from_numpy(caps), max_frames=8, seed=7,
    )
    exp = jdp.generate_codes_batch_dp(
        jt, jc, mesh=jpm.make_mesh(jax.devices()[:2], tp=1), **COMMON,
        sampling=jgen.SamplingConfig(0.0, 0, 1.0, 1.0),
        **{k: jnp.asarray(v) for k, v in b.items()},
        cache=jtk.make_cache(TP_TALKER, 4, 128, jnp.float32), max_steps=jnp.asarray(caps),
        max_frames=8, key=jax.random.PRNGKey(7),
    )
    assert (got.n_frames.numpy() > 0).all()
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(exp.codes))
    np.testing.assert_array_equal(got.n_frames.numpy(), np.asarray(exp.n_frames))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(exp.tokens))


def test_dp_sampled_shards_match_their_single_device_runs(params):
    """Sampled, dp = 2: each shard's codes equal ``generate_codes_batch``
    alone on its rows with ``shard_seed(seed, s)``; the shard seeds differ
    pairwise (row 0 of each shard would otherwise draw the same streams)."""
    _, _, tt, tc = params
    b = _t(_batch())
    caps = torch.tensor([6, 6, 5, 6], dtype=torch.int32)
    got = pdp.generate_codes_batch_dp(
        tt, tc, mesh=pm.make_mesh(["cpu"] * 2, tp=1), **COMMON, sampling=SAMPLED, **b,
        cache=ttk.make_cache(TP_TALKER, 4, 128, torch.float32, "cpu"), max_steps=caps,
        max_frames=8, seed=11,
    )
    for s in range(2):
        rows = slice(2 * s, 2 * s + 2)
        exp = tbg.generate_codes_batch(
            tt, tc, **COMMON, sampling=SAMPLED,
            **{k: (v[rows] if v.dim() and v.shape[0] == 4 else v) for k, v in b.items()},
            cache=ttk.make_cache(TP_TALKER, 2, 128, torch.float32, "cpu"), max_steps=caps[rows],
            max_frames=8, seed=pdp.shard_seed(11, s),
        )
        assert torch.equal(got.codes[rows], exp.codes)
        assert torch.equal(got.n_frames[rows], exp.n_frames)
    seeds = [pdp.shard_seed(s0, s) for s0 in (0, 11, 2**40 + 5) for s in range(8)]
    assert len(set(seeds)) == len(seeds) and all(0 <= x < 2**63 for x in seeds)
    assert pdp.shard_seed(2**40 + 5, 3) >> 32 == 2**8
    assert pdp.shard_seed(11, 0) == 11  # shard 0, and so a one-shard server, keeps the seed


def _same_carry(a, b):
    for f in ("steps", "frames", "done", "offsets", "codes", "tokens", "cur_input", "seen"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.step == b.step and a.seed_words == b.seed_words


def test_dp_pipeline_matches_per_shard(params):
    """The counterpart of TestDpContinuous: prefill, a chunk to step 3, an
    admission into slot 3 (shard 1, local slot 1) that leaves shard 0 as it
    was, then a chunk with per-shard bounds (6 and 5); each shard equals the
    same pipeline composed on its own rows with its shard seeds."""
    _, _, tt, tc = params
    b = _t(_batch())
    mesh = pm.make_mesh(["cpu"] * 2, tp=1)
    kw = dict(**COMMON, sampling=SAMPLED)
    caps = torch.full((4,), 6, dtype=torch.int32)
    admit_pe = torch.from_numpy(rand(1, 16, H, seed=5, scale=0.2))
    admit_tr = torch.from_numpy(rand(8, H, seed=6, scale=0.2))
    carry = pdp.prefill_start_batch_dp(
        tt, tc, mesh=mesh, **kw, **{k: v for k, v in b.items()},
        cache=ttk.make_cache(TP_TALKER, 4, 128, torch.float32, "cpu"), max_frames=8, seed=21)
    assert [c.step for c in carry] == [1, 1]
    trail = [b["trailing_embeds"][:2].clone(), b["trailing_embeds"][2:].clone()]
    stream = dict(trailing_lens=b["trailing_lens"], tts_pad_embed=b["tts_pad_embed"],
                  max_steps=caps)
    carry = pdp.generate_chunk_batch_dp(tt, tc, carry, mesh=mesh, **kw, trailing_embeds=trail,
                                        **stream, until_step=3)
    assert pdp.global_step(carry) == 3
    before = carry[0]
    carry, trail = pdp.admit_slot_dp(
        tt, tc, carry, trail, mesh=mesh, **kw, slot=3, prefill_embeds=admit_pe, prefill_len=11,
        trailing_row=admit_tr, trailing_len=6, tts_pad_embed=b["tts_pad_embed"], seed=22)
    assert carry[0] is before  # the other shard is not touched
    lens = b["trailing_lens"].clone()
    lens[3] = 6
    carry = pdp.generate_chunk_batch_dp(
        tt, tc, carry, mesh=mesh, **kw, trailing_embeds=trail, trailing_lens=lens,
        tts_pad_embed=b["tts_pad_embed"], max_steps=caps, until_step=[6, 5])
    assert [c.step for c in carry] == [6, 5]
    for s in range(2):
        rows = slice(2 * s, 2 * s + 2)
        c = tbg.prefill_start_batch(
            tt, tc, **kw, prefill_embeds=b["prefill_embeds"][rows],
            prefill_lens=b["prefill_lens"][rows], trailing_embeds=b["trailing_embeds"][rows],
            trailing_lens=b["trailing_lens"][rows], tts_pad_embed=b["tts_pad_embed"],
            cache=ttk.make_cache(TP_TALKER, 2, 128, torch.float32, "cpu"), max_frames=8,
            seed=pdp.shard_seed(21, s))
        tr = b["trailing_embeds"][rows].clone()
        one = dict(trailing_lens=b["trailing_lens"][rows], tts_pad_embed=b["tts_pad_embed"],
                   max_steps=caps[rows])
        c = tbg.generate_chunk_batch(tt, tc, c, **kw, trailing_embeds=tr, **one, until_step=3)
        if s == 1:
            c, tr = tbg.admit_slot(
                tt, tc, c, tr, **kw, slot=1, prefill_embeds=admit_pe, prefill_len=11,
                trailing_row=admit_tr, trailing_len=6, tts_pad_embed=b["tts_pad_embed"],
                seed=pdp.shard_seed(22, 1))
        c = tbg.generate_chunk_batch(tt, tc, c, **kw, trailing_embeds=tr,
                                     **dict(one, trailing_lens=lens[rows]),
                                     until_step=[6, 5][s])
        _same_carry(carry[s], c)


def test_an_idle_shard_does_not_step(params):
    """A shard whose every row is capped at 0 is not called: its carry comes
    back as it was, while the other shard steps."""
    _, _, tt, tc = params
    b = _t(_batch())
    mesh = pm.make_mesh(["cpu"] * 2, tp=1)
    kw = dict(**COMMON, sampling=GREEDY)
    carry = pdp.prefill_start_batch_dp(
        tt, tc, mesh=mesh, **kw, **b, cache=ttk.make_cache(TP_TALKER, 4, 128, torch.float32,
                                                           "cpu"), max_frames=8, seed=0)
    out = pdp.generate_chunk_batch_dp(
        tt, tc, carry, mesh=mesh, **kw, trailing_embeds=b["trailing_embeds"],
        trailing_lens=b["trailing_lens"], tts_pad_embed=b["tts_pad_embed"],
        max_steps=torch.tensor([0, 0, 4, 4], dtype=torch.int32), until_step=[4, 4])
    assert out[0] is carry[0] and out[1].step == 4


def test_dp_size_and_routing_errors():
    """The JAX package's ValueErrors: a tp != 1 mesh, slots that dp does
    not divide, a dp mesh beside a TP mesh."""
    with pytest.raises(ValueError, match="tp=1 mesh"):
        pdp.dp_size(pm.make_mesh(["cpu"] * 4, tp=2))
    assert pdp.dp_size(pm.make_mesh(["cpu"] * 4, tp=1)) == 4
    dp2 = pm.make_mesh(["cpu"] * 2, tp=1)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="divisible by the dp size"):
        tsv._route_device_fns(dp2, None, 3, cpu)
    with pytest.raises(ValueError, match="does not compose with a TP mesh"):
        tsv._route_device_fns(dp2, pm.make_mesh(["cpu"] * 2, tp=2), 4, cpu)
    dp, one = tsv._route_device_fns(None, None, 3, cpu)  # the single device: one shard
    assert dp == 1 and one.devices == [[cpu]]
    assert tsv._route_device_fns(dp2, None, 4, cpu) == (2, dp2)
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        pdp.generate_codes_batch_dp(None, None, mesh=dp2, talker_cfg=None, cp_cfg=None,
                                    sampling=GREEDY, prefill_embeds=torch.zeros(3, 1, 1),
                                    prefill_lens=None, trailing_embeds=None, trailing_lens=None,
                                    tts_pad_embed=None, cache=None, max_steps=None,
                                    max_frames=1, seed=0)


def test_slot_placement_and_chunk_bounds():
    """``_pick_free_slot`` fills the least-loaded shard (ties: the lower
    shard) and the first free slot without dp; ``_until_step`` bounds each
    shard by its own counter."""
    occ = [False] * 8
    order = []
    for _ in range(8):
        s = tsv._pick_free_slot(occ, 2)
        occ[s] = True
        order.append(s)
    assert order == [0, 4, 1, 5, 2, 6, 3, 7]
    assert tsv._pick_free_slot(occ, 2) is None
    assert tsv._pick_free_slot([True, False, False, True], 2) == 1
    assert tsv._pick_free_slot([True, True, False, False], 2) == 2
    assert tsv._pick_free_slot([True, False, True], 1) == 1
    Fake = type("C", (), {})
    a, b = Fake(), Fake()
    a.step, b.step = 7, 3
    assert tsv._until_step([a, b], 5) == [12, 8]
    assert tsv._until_step([a], 5) == [12]


def test_replicas_are_made_once_per_device(params):
    """On the params' own device a replica is the tree itself; another
    device gets one copy, reused by later calls."""
    _, _, tt, _ = params
    assert pdp.replicas(tt, pm.make_mesh(["cpu"] * 3, tp=1)) == [tt] * 3
    meta = pm.make_mesh(["cpu", "meta"], tp=1)
    first = pdp.replicas(tt, meta)
    assert first[0] is tt and first[1]["layers"]["q_proj"].device.type == "meta"
    assert pdp.replicas(tt, meta)[1] is first[1]


# ---------------------------------------------------------------------------
# The public surfaces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """The tiny CustomVoice model of tests/test_torch_serving.py (its CP has
    one kv head, which tp = 2 does not divide: the TP path gathers its
    heads)."""
    cfg, tok = _tiny_model_configs(False)
    tc = cfg.talker_config
    g = torch.Generator().manual_seed(3)
    args = (cfg, thi.to_device(thi.host_init_talker_params(3, tc), torch.float32, "cpu"),
            thi.to_device(thi.host_init_cp_params(4, tc.code_predictor_config, tc.hidden_size),
                          torch.float32, "cpu"),
            thi.init_vocoder_params(g, tok.decoder_config, torch.float32, "cpu"))
    kw = dict(tokenizer_config=tok, tokenizer=StubTokenizer(512), dtype=torch.float32)
    return ttts.Qwen3TTSModel(*args, **kw, device="cpu"), (args, kw)


TEXTS = ["Hello there", "A longer second sentence", "Three", "And four"]
GREEDY_KW = dict(temperature=0.0, top_k=0, repetition_penalty=1.0, max_tokens=6)


def _close(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and len(x) > 0 and np.abs(x - y).max() <= WAVE_TOL


def test_generate_batch_dp_mesh(model):
    """``generate_batch(dp_mesh=)`` gives the greedy waveforms of the call
    without it; a batch dp does not divide, a tp != 1 mesh and a model
    loaded with ``mesh=`` raise ``Qwen3TTSError``."""
    m, (args, kw) = model
    dp2 = pm.make_mesh(["cpu"] * 2, tp=1)
    spk = ["aiden"] * 4
    _close(m.generate_batch(TEXTS, speakers=spk, **GREEDY_KW, dp_mesh=dp2),
           m.generate_batch(TEXTS, speakers=spk, **GREEDY_KW))
    with pytest.raises(ttts.Qwen3TTSError, match="not divisible"):
        m.generate_batch(TEXTS[:3], speakers=spk[:3], **GREEDY_KW, dp_mesh=dp2)
    with pytest.raises(ttts.Qwen3TTSError, match="tp=1 mesh"):
        m.generate_batch(TEXTS, speakers=spk, dp_mesh=pm.make_mesh(["cpu"] * 2, tp=2))
    m_tp = ttts.Qwen3TTSModel(*args, **kw, mesh=pm.make_mesh(["cpu"] * 2, tp=2))
    with pytest.raises(ttts.Qwen3TTSError, match="without"):
        m_tp.generate_batch(TEXTS, speakers=spk, dp_mesh=dp2)
    with pytest.raises(ttts.Qwen3TTSError, match="without"):
        m_tp.serve(dp_mesh=dp2, slots=2)


def test_generate_batch_continuous_and_serve_dp_mesh(model):
    """``generate_batch_continuous(dp_mesh=)`` and ``serve(dp_mesh=)`` (two
    requests through ``TTSService``, one a shard) give the greedy waveforms
    of the calls without dp; slots that dp does not divide raise."""
    m, _ = model
    dp2 = pm.make_mesh(["cpu"] * 2, tp=1)
    spk = ["aiden"] * 3
    kw = dict(GREEDY_KW, slots=2)
    _close(m.generate_batch_continuous(TEXTS[:3], speakers=spk, **kw, dp_mesh=dp2),
           m.generate_batch_continuous(TEXTS[:3], speakers=spk, **kw))
    with pytest.raises(ttts.Qwen3TTSError, match="slots 3 not divisible"):
        m.generate_batch_continuous(TEXTS[:3], speakers=spk, **dict(kw, slots=3), dp_mesh=dp2)
    with pytest.raises(ttts.Qwen3TTSError, match="slots 3 not divisible"):
        m.serve(slots=3, dp_mesh=dp2)
    serve_kw = dict(slots=2, chunk_frames=3, max_frames=16, prompt_bucket=64, trailing_bucket=16,
                    temperature=0.0, top_k=0, repetition_penalty=1.0)
    outs = {}
    for name, mesh in (("dp", dp2), ("one", None)):
        with m.serve(**serve_kw, dp_mesh=mesh) as svc:
            futs = [svc.submit(t, speaker="aiden", max_tokens=6) for t in TEXTS[:2]]
            outs[name] = [f.result(timeout=600) for f in futs]
            server = svc._server
        if mesh is not None:
            assert server._dp == 2 and isinstance(server.total_iterations, int)
    _close(outs["dp"], outs["one"])


def test_tp_model_generate_stream_and_batch(model):
    """``Qwen3TTSModel(..., mesh=make_mesh(["cpu"] * 2, tp=2))``: the layer
    leaves are sharded, the rest on the mesh's first device; ``generate``,
    ``generate_stream`` and ``generate_batch`` give the unsharded model's
    greedy tokens and waveforms."""
    m, (args, kw) = model
    m_tp = ttts.Qwen3TTSModel(*args, **kw, mesh=pm.make_mesh(["cpu"] * 2, tp=2))
    assert isinstance(m_tp.talker_params["layers"]["q_proj"], pm.Sharded)
    assert isinstance(m_tp.cp_params["layers"]["k_proj"], pm.Sharded)
    assert m_tp.device == torch.device("cpu")
    one = dict(speaker="aiden", **GREEDY_KW)
    _close([m_tp.generate(TEXTS[1], **one)], [m.generate(TEXTS[1], **one)])
    ev_tp = list(m_tp.generate_stream(TEXTS[0], **one))
    ev = list(m.generate_stream(TEXTS[0], **one))
    tok = lambda evs: [e.token for e in evs if type(e).__name__ == "TokenEvent"]  # noqa: E731
    assert tok(ev_tp) == tok(ev) and len(tok(ev)) > 0
    _close([ev_tp[-1].audio], [ev[-1].audio])
    spk = ["aiden", "aiden"]
    _close(m_tp.generate_batch(TEXTS[:2], speakers=spk, **GREEDY_KW),
           m.generate_batch(TEXTS[:2], speakers=spk, **GREEDY_KW))


def test_from_pretrained_with_a_mesh_loads_unfused(tmp_path):
    """``from_pretrained(dir, mesh=)`` of a synthetic checkpoint: nothing is
    fused, the layers are sharded; ``quantize='int8'`` gives unfused
    Int8Linear parts; a device other than the mesh's first and a mesh that
    is not a Mesh raise."""
    d = write_checkpoint(str(tmp_path / "ckpt"))
    mesh = pm.make_mesh(["cpu"] * 2, tp=2)
    with pytest.warns(UserWarning, match="tokenizer"):
        m = ttts.Qwen3TTSModel.from_pretrained(d, dtype=torch.float32, mesh=mesh)
    layers = m.talker_params["layers"]
    assert "q_proj" in layers and "qkv_proj" not in layers
    assert isinstance(layers["q_proj"], pm.Sharded) and m.mesh is mesh
    assert "q_proj" in m.cp_params["layers"]
    with pytest.warns(UserWarning, match="tokenizer"):
        m8 = ttts.Qwen3TTSModel.from_pretrained(d, dtype=torch.float32, mesh=mesh,
                                                quantize="int8")
    assert "qkv_proj" not in m8.talker_params["layers"]
    part = m8.talker_params["layers"]["q_proj"].parts[0][1]
    assert type(part).__name__ == "Int8Linear"
    with pytest.raises(ttts.Qwen3TTSError, match="first device"):
        ttts.Qwen3TTSModel.from_pretrained(d, mesh=mesh, device="meta")
    with pytest.raises(ttts.Qwen3TTSError, match="mesh must be"):
        ttts.Qwen3TTSModel.from_pretrained(d, device="cpu", mesh=dataclasses)
