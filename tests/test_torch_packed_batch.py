"""The lockstep batch and the service on packed weights, against the JAX
package, on tests/synthetic_ckpt.py's int4 checkpoint (MLX affine, group 32)
loaded packed by both loaders (the default on a quantized checkpoint; the
port's ``from_pretrained(..., keep_packed=True)``).

The JAX package decodes a packed tree in the plain lockstep (XLA's
``quant_matmul`` at every matmul of more than one row); so does the port,
whose packed matmuls of more than one row take ``quant_gemm`` (on the CPU
its plain version, ``quant_matmul``). Oracles:
* greedy f32 ``generate_codes_batch`` at B = 3 with ragged prompts, trailing
  texts and caps: codes, tokens and frame counts equal (argmaxes of f32
  logits);
* bf16: the port, teacher-forced on the JAX package's bf16 batch codes
  through its own batched steps, finds each code within 0.05 logit spreads
  of its best logit (tests/test_torch_loader.py's bound);
* ``Qwen3TTSModel.generate_batch`` of two texts on both packages, greedy:
  waveforms within 1e-5 of the pre-clip signal's scale (< 40 here), as
  tests/test_torch_batch.py;
* one request through ``serve(slots=2)``: the waveform of the same text's
  greedy ``generate_batch``, within the same bound;
* ``quant_matmul`` (the plain version of K4 and ``quant_gemm``) at M = 2,
  3, 16, 17, 64 and 512, four (bits, group) pairs, against the JAX
  package's, within 1e-5 scaled in f32, and ``quant_gemm`` on a CPU tensor
  equal to it; a bf16 x the same in f32 and, rounded to bf16 by
  ``talker._dense``, within one bf16 step of JAX's bf16 result; the packed
  ``_dense`` on a CPU tensor equal to the plain version.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu.models import batch_generate as jbg
from qwen3tts_tpu.models import generate as jgen
from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.ops import quant as jq
from qwen3tts_tpu.tts import Qwen3TTSModel as JModel
from qwen3tts_tpu.utils.loader import Checkpoint as JCheckpoint
from qwen3tts_tpu_torch import tts as ttts
from qwen3tts_tpu_torch.models import batch_generate as tbg
from qwen3tts_tpu_torch.models import code_predictor as tcp
from qwen3tts_tpu_torch.models import generate as tgen
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.ops import quant as tq
from qwen3tts_tpu_torch.ops.quant import PackedLinear
from qwen3tts_tpu_torch.utils import host_init as thi
from qwen3tts_tpu_torch.utils import loader as tl

from synthetic_ckpt import StubTokenizer, write_checkpoint
from test_torch_generate import _tiny_model_configs, _within_noise

GREEDY_J = jgen.SamplingConfig(0.0, 0, 1.0, 1.0, forbid_eos=True)
GREEDY_T = tgen.SamplingConfig(0.0, 0, 1.0, 1.0, forbid_eos=True)
CAPS = [6, 4, 5]
WAVE_TOL = 1e-5 * 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny shapes (the suite's workers share
    the cores), restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoint(str(tmp_path_factory.mktemp("int4")), quantize=True)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _batch_inputs(h):
    """Three right-padded prompts of 11, 7 and 9 rows and trailing texts of
    6, 3 and 4 rows."""
    plens, tlens = [11, 7, 9], [6, 3, 4]
    prefill = np.stack([np.pad(rand(n, h, seed=10 + i, scale=0.1), ((0, 16 - n), (0, 0)))
                        for i, n in enumerate(plens)])
    trailing = np.stack([np.pad(rand(n, h, seed=20 + i, scale=0.1), ((0, 8 - n), (0, 0)))
                         for i, n in enumerate(tlens)])
    return prefill, plens, trailing, tlens, rand(h, seed=30, scale=0.1)


def _jax_batch(path, dtype):
    j = JCheckpoint(path, dtype)
    cfg = j.config.talker_config
    prefill, plens, trailing, tlens, pad = _batch_inputs(cfg.hidden_size)
    return jbg.generate_codes_batch(
        j.talker_params, j.cp_params, talker_cfg=cfg, cp_cfg=cfg.code_predictor_config,
        sampling=GREEDY_J, prefill_embeds=jnp.asarray(prefill, dtype),
        prefill_lens=jnp.asarray(plens), trailing_embeds=jnp.asarray(trailing, dtype),
        trailing_lens=jnp.asarray(tlens), tts_pad_embed=jnp.asarray(pad, dtype),
        cache=jtk.make_cache(cfg, 3, 64, dtype), max_steps=jnp.asarray(CAPS), max_frames=8,
        key=jax.random.PRNGKey(0),
    )


def _port_tree(path, dtype):
    t = tl.Checkpoint(path, dtype)
    assert isinstance(t.talker_params["codec_head"], PackedLinear)
    assert isinstance(t.cp_params["layers"]["q_proj"], PackedLinear)
    return t, t.config.talker_config


def test_packed_generate_codes_batch_matches_jax_f32(ckpt):
    rj = _jax_batch(ckpt, jnp.float32)
    t, cfg = _port_tree(ckpt, torch.float32)
    assert tbg.kernels_take(t.talker_params, t.cp_params, cfg, cfg.code_predictor_config, 3, False)
    prefill, plens, trailing, tlens, pad = _batch_inputs(cfg.hidden_size)
    T = torch.from_numpy
    rt = tbg.generate_codes_batch(
        t.talker_params, t.cp_params, talker_cfg=cfg, cp_cfg=cfg.code_predictor_config,
        sampling=GREEDY_T, prefill_embeds=T(prefill), prefill_lens=plens,
        trailing_embeds=T(trailing), trailing_lens=tlens, tts_pad_embed=T(pad),
        cache=ttk.make_cache(cfg, 3, 64, torch.float32), max_steps=CAPS, max_frames=8, seed=0,
    )
    assert rt.n_frames.tolist() == np.asarray(rj.n_frames).tolist() == CAPS
    assert (rt.codes.numpy() == np.asarray(rj.codes)).all()
    assert (rt.tokens.numpy() == np.asarray(rj.tokens)).all()


def _replay_batch_gaps(tt, tc, cfg, codes: np.ndarray, n_frames) -> list[float]:
    """Feed a batch's codes [B, F, 16] back through the port's batched plain
    steps in bf16 (prefill, ``forward_batched_step``, the CP at B rows),
    frame by frame and codebook by codebook; for every position a row
    sampled (frame < its count), how far the fed code sits below the best
    logit, in logit spreads."""
    cpc = cfg.code_predictor_config
    prefill, plens, trailing, tlens, pad = _batch_inputs(cfg.hidden_size)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    B = len(plens)
    cache = ttk.make_cache(cfg, B, 64)
    hidden, cache = ttk.forward(tt, cfg, bf(prefill), cache, 0)
    offsets = torch.tensor(plens, dtype=torch.int32)
    h_last = hidden[torch.arange(B), offsets.long() - 1]
    gaps = []
    for f in range(max(n_frames)):
        live = [b for b in range(B) if f < n_frames[b]]
        logits = ttk.codec_logits(tt, h_last[:, None])[:, 0].float().numpy()[:, :2048]
        gaps += [_within_noise(logits[b], codes[b, f, 0]) for b in live]
        code0 = torch.from_numpy(codes[:, f, 0].astype(np.int32))
        rest = torch.from_numpy(codes[:, f, 1:].astype(np.int32))
        x0 = torch.stack([h_last, ttk.embed_codec(tt, code0).to(torch.bfloat16)], dim=1)
        h, cp_cache = tcp.forward(tc, cpc, x0, tcp.make_cp_cache(cpc, B, torch.bfloat16), 0)
        for j in range(15):
            lj = tcp.head_logits(tc, h[:, -1], j).float().numpy()
            gaps += [_within_noise(lj[b], codes[b, f, 1 + j]) for b in live]
            if j < 14:
                emb = tc["codec_embedding"][j][rest[:, j].long()].to(torch.bfloat16)
                h, cp_cache = tcp.forward(tc, cpc, emb[:, None], cp_cache, j + 2)
        steps = torch.full((B,), f, dtype=torch.int32)
        x = tbg._next_input_batch(tc, tt, bf(trailing), torch.tensor(tlens), bf(pad), steps,
                                  code0, rest)
        hidden, cache = ttk.forward_batched_step(tt, cfg, x, cache, offsets)
        h_last, offsets = hidden[:, 0], offsets + 1
    return gaps


def test_packed_batch_teacher_forced_bf16(ckpt):
    """bf16 packed weights: the port's batched steps, fed the JAX package's
    bf16 batch codes, find each within 0.05 logit spreads of the best."""
    rj = _jax_batch(ckpt, jnp.bfloat16)
    n = np.asarray(rj.n_frames).tolist()
    assert n == CAPS
    t, cfg = _port_tree(ckpt, torch.bfloat16)
    gaps = _replay_batch_gaps(t.talker_params, t.cp_params, cfg, np.asarray(rj.codes), n)
    assert len(gaps) == 16 * sum(CAPS)
    assert max(gaps) <= 0.05, max(gaps)
    assert sum(g == 0.0 for g in gaps) >= 0.9 * len(gaps)


@pytest.fixture(scope="module")
def models(ckpt):
    """Both packages' models on the packed checkpoint, f32. JAX's gathers
    clamp out-of-range ids, torch's raise: the tts special ids go inside
    the stub tokenizer's 512-entry text vocabulary, and both models get one
    vocoder with full 2048-entry codebooks."""
    jc, tc = JCheckpoint(ckpt, jnp.float32), tl.Checkpoint(ckpt, torch.float32)
    ids = dict(tts_bos_token_id=500, tts_eos_token_id=501, tts_pad_token_id=502)
    dec_j, dec_t = (_tiny_model_configs(side)[1].decoder_config for side in (True, False))
    voc = thi.init_vocoder_params(torch.Generator().manual_seed(2), dec_t)
    jm = JModel(dataclasses.replace(jc.config, **ids), jc.talker_params, jc.cp_params,
                jax.tree_util.tree_map(lambda v: jnp.asarray(v.numpy()), voc),
                tokenizer_config=dataclasses.replace(jc.tokenizer_config, decoder_config=dec_j),
                tokenizer=StubTokenizer(), dtype=jnp.float32)
    tm = ttts.Qwen3TTSModel(dataclasses.replace(tc.config, **ids), tc.talker_params,
                            tc.cp_params, voc,
                            tokenizer_config=dataclasses.replace(tc.tokenizer_config,
                                                                 decoder_config=dec_t),
                            tokenizer=StubTokenizer(), dtype=torch.float32, device="cpu")
    return jm, tm


TEXTS = ["Packed lockstep row one", "and a second, longer row of the packed batch"]
KW = dict(speakers=["aiden", "vivian"], language="english", temperature=0.0, max_tokens=6, seed=0)


def test_packed_generate_batch_matches_jax(models):
    jm, tm = models
    wj, wt = jm.generate_batch(TEXTS, **KW), tm.generate_batch(TEXTS, **KW)
    assert len(wt) == 2
    for a, b in zip(wt, wj):
        b = np.asarray(b)
        assert a.shape == b.shape and len(a) > 0 and len(a) % 1920 == 0
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= WAVE_TOL


def test_packed_serve_one_request(models):
    """One greedy request through ``serve(slots=2)`` on the packed model:
    the waveform of the same text's ``generate_batch``."""
    _, tm = models
    with tm.serve(slots=2, chunk_frames=3, max_frames=16, prompt_bucket=64, trailing_bucket=16,
                  temperature=0.0) as svc:
        got = svc.submit(TEXTS[0], speaker="aiden", language="english", max_tokens=6).result()
    want = tm.generate_batch(TEXTS[:1], speakers=["aiden"], language="english", temperature=0.0,
                             max_tokens=6, seed=0)[0]
    assert got.shape == want.shape and len(got) > 0 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= WAVE_TOL


GEMM_GROUPS = ((4, 32), (4, 64), (8, 64), (8, 32))  # (bits, group)


@pytest.mark.parametrize("M", [2, 3, 16, 17, 64, 512])
def test_quant_matmul_rows_match_jax(M):
    """The plain version of K4 and quant_gemm at M rows against the JAX
    package's XLA path, both bit widths and groups of 32 and 64."""
    for bits, group in GEMM_GROUPS:
        w = rand(96, 128, seed=M + bits, scale=0.2)
        packed, scales, biases = tq.pack_quantized(w, bits, group)
        x = rand(M, 128, seed=M)
        pw = tq.packed_from_numpy(packed, scales, biases, bits, group)
        args = (pw.q, pw.scales, pw.biases, bits, group)
        yt = tq.quant_matmul(torch.from_numpy(x), *args).numpy()
        yj = np.asarray(jq.quant_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                                        jnp.asarray(biases), bits=bits, group=group))
        assert yt.shape == yj.shape == (M, 96)
        assert np.abs(yt - yj).max() / max(1.0, np.abs(yj).max()) <= 1e-5, (bits, group)
        assert torch.equal(tq.quant_gemm(torch.from_numpy(x), *args), torch.from_numpy(yt))


@pytest.mark.parametrize("bits,group", GEMM_GROUPS)
@pytest.mark.parametrize("M", [2, 16])
def test_quant_matmul_bf16_rows_match_jax(M, bits, group):
    """A bf16 x beside the f32 one: quant_matmul of a bf16 tensor against
    the JAX package's quant_matmul of the same values in f32 (1e-5 scaled),
    and ``talker._dense`` on the packed weight (bf16 out) against the JAX
    path on the bf16 x (bf16 out) within one bf16 step of the scale (2^-7:
    the two round the same f32 sums, taken in another order)."""
    w = rand(96, 128, seed=M + bits + group, scale=0.2)
    packed, scales, biases = tq.pack_quantized(w, bits, group)
    xb = torch.from_numpy(rand(M, 128, seed=M + 1)).bfloat16()
    x32 = xb.float().numpy()
    pw = tq.packed_from_numpy(packed, scales, biases, bits, group)
    jargs = (jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(biases))
    yt = tq.quant_matmul(xb, pw.q, pw.scales, pw.biases, bits, group).numpy()
    yj = np.asarray(jq.quant_matmul(jnp.asarray(x32), *jargs, bits=bits, group=group))
    assert yt.dtype == np.float32 and yt.shape == yj.shape == (M, 96)
    assert np.abs(yt - yj).max() / max(1.0, np.abs(yj).max()) <= 1e-5
    yd = ttk._dense(xb, pw)
    yjb = jq.quant_matmul(jnp.asarray(x32, jnp.bfloat16), *jargs, bits=bits, group=group)
    yjb = np.asarray(yjb.astype(jnp.float32))
    assert yd.dtype == torch.bfloat16
    assert np.abs(yd.float().numpy() - yjb).max() / max(1.0, np.abs(yjb).max()) <= 2.0 ** -7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 2, 5])
def test_packed_dense_on_cpu_is_the_plain_version(rows, dtype):
    """On a CPU tensor the packed ``_dense`` (K4 for one row, quant_gemm for
    more) is the plain quant_matmul rounded to x's dtype, bit for bit, for
    a batch of rows of any leading shape."""
    for bits, group in GEMM_GROUPS:
        w = rand(40, 128, seed=rows + bits, scale=0.2)
        pw = tq.packed_from_numpy(*tq.pack_quantized(w, bits, group), bits, group)
        x = torch.from_numpy(rand(1, rows, 128, seed=rows)).to(dtype)
        y = ttk._dense(x, pw)
        want = tq.quant_matmul(x.reshape(rows, 128), pw.q, pw.scales, pw.biases, bits, group)
        assert y.shape == (1, rows, 40) and y.dtype == dtype
        assert torch.equal(y, want.reshape(1, rows, 40).to(dtype)), (bits, group)
