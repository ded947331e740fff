"""The top-p stage of the kernels' sampler (K1's sample mode, K2, K5's port).

The plain stage (``decode_blocks.top_k_filter`` then ``top_p_filter``, the
order of ``sample_row``) against the JAX sampler's ``apply_top_k`` then
``apply_top_p`` on the same numpy logits: the kept sets are equal, with top-k
off (0) and on (50), ``ref_exact`` off and on, p in {0.1, 0.8, 0.95, 1.0},
and on logits on a coarse grid, whose ties straddle the top-p boundary (the
stable ascending order puts the lower id first, so it gets the smaller
cumulative mass). Greedy sampling ignores top-p. The gates of ``generate``
admit any top_p on a CUDA device (checked without launching), and the
plain versions of K1 and K2 pass top-p to the sampler.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from qwen3tts_tpu.ops import sampling as js
from qwen3tts_tpu_torch.models import generate as tgen
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.ops import cp_kernel as tcpk
from qwen3tts_tpu_torch.ops import quant as tq
from qwen3tts_tpu_torch.ops import talker_kernel as tkk
from qwen3tts_tpu_torch.ops.decode_blocks import (
    NEG_BIG, sample_row, top_k_filter, top_p_filter, top_p_threshold,
)
from qwen3tts_tpu_torch.utils import host_init as thi

from test_torch_code_predictor import KCFG as CPC
from test_torch_talker import KCFG

V = 3072


def _logits(seed: int, grid: float | None = None) -> np.ndarray:
    z = np.random.default_rng(seed).standard_normal(V).astype(np.float32) * 3.0
    return (np.round(z / grid) * grid).astype(np.float32) if grid else z


def _kept_port(z: np.ndarray, top_k: int, p: float, ref_exact: bool) -> np.ndarray:
    out = top_p_filter(top_k_filter(torch.from_numpy(z), top_k), p, ref_exact)
    return (out > NEG_BIG / 2).numpy()


def _kept_jax(z: np.ndarray, top_k: int, p: float, ref_exact: bool) -> np.ndarray:
    out = js.apply_top_p(js.apply_top_k(jnp.asarray(z), top_k), p, ref_exact=ref_exact)
    return np.isfinite(np.asarray(out))


@pytest.mark.parametrize("ref_exact", [False, True])
@pytest.mark.parametrize("top_k", [0, 50])
@pytest.mark.parametrize("p", [0.1, 0.8, 0.95, 1.0])
def test_top_p_kept_set_matches_jax(p, top_k, ref_exact):
    for seed in range(3):
        z = _logits(seed)
        if ref_exact:  # unnormalized exp: a total mass of ~1 over the top-k, so p decides
            top = np.sort(z)[-top_k:] if top_k else z
            z = (z - np.log(np.exp(top.astype(np.float64)).sum())).astype(np.float32)
        got, want = _kept_port(z, top_k, p, ref_exact), _kept_jax(z, top_k, p, ref_exact)
        assert (got == want).all(), (seed, int(got.sum()), int(want.sum()))
        if p == 1.0:
            assert got.sum() == (V if top_k == 0 else top_k)
        else:
            assert 0 < got.sum() < (V if top_k == 0 else top_k)


@pytest.mark.parametrize("top_k,p", [(0, 0.8), (0, 0.95), (50, 0.8), (50, 0.5)])
def test_top_p_ties_across_the_boundary(top_k, p):
    """Logits on a grid of 0.5: the boundary falls in runs of equal values,
    split by id."""
    split = 0
    for seed in range(6):
        z = _logits(10 + seed, grid=0.5)
        got, want = _kept_port(z, top_k, p, False), _kept_jax(z, top_k, p, False)
        assert (got == want).all(), seed
        kept_vals = set(z[got].tolist())
        if top_k:  # the top-k cut keeps ties whole; only top-p splits them
            kept_vals &= set(z[top_k_filter(torch.from_numpy(z), top_k).numpy() > NEG_BIG / 2])
        split += bool(kept_vals & set(z[~got & (z > z[got].min() - 1)].tolist()))
        # within a split tie the higher ids stay (they come last in the order)
        for v in kept_vals:
            ids = np.flatnonzero(z == v)
            k = got[ids]
            assert (np.sort(k) == k).all()
    assert split >= 1  # the boundary did cut a run of equal logits


def test_threshold_is_jax_f32_of_one_minus_p():
    for p in (0.1, 0.8, 0.9, 0.95):
        assert top_p_threshold(p) == float(np.float32(1.0 - p))
    # not 1 - f32(p) in f32, which differs by ulps
    assert top_p_threshold(0.9) != float(np.float32(1.0) - np.float32(0.9))
    assert top_p_threshold(1.0) == top_p_threshold(0.0) == top_p_threshold(1.5) == 0.0


def test_greedy_ignores_top_p():
    z = torch.from_numpy(_logits(5))
    for p in (0.1, 0.8, 1.0):
        for ref_exact in (False, True):
            code = sample_row(z, temperature=0.0, top_k=50, top_p=p, ref_exact_top_p=ref_exact)
            assert int(code) == int(torch.argmax(z))


def test_sampled_code_lies_in_the_kept_set():
    z = torch.from_numpy(_logits(6))
    kept = top_p_filter(top_k_filter(z, 50), 0.5) > NEG_BIG / 2
    assert 1 < int(kept.sum()) < 50
    for s in range(16):
        code = int(sample_row(z, temperature=0.9, top_k=50, top_p=0.5, seed=(s, 3)))
        assert kept[code]


@pytest.fixture(scope="module")
def fused_int8():
    tt = thi.to_device(thi.host_init_talker_params(0, KCFG), torch.bfloat16, "cpu")
    tt["layers"] = ttk.fuse_layer_projections(tt["layers"])
    tt = tq.quantize_decode_params_int8(tt, "codec_head")
    tc = thi.to_device(thi.host_init_cp_params(1, CPC, KCFG.hidden_size), torch.bfloat16, "cpu")
    tc["layers"] = ttk.fuse_layer_projections(tc["layers"])
    tc = tq.quantize_decode_params_int8(tc, "lm_head")
    return tt, tc


@pytest.mark.parametrize("top_p,ref_exact", [(0.8, False), (0.95, True), (1.0, False)])
@pytest.mark.parametrize("batch", [1, 64])
def test_gates_admit_top_p_on_cuda(fused_int8, top_p, ref_exact, batch):
    tt, tc = fused_int8
    sampling = tgen.SamplingConfig(0.9, 50, top_p, 1.05, ref_exact_top_p=ref_exact)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tgen._use_cp_kernel(tc, CPC, KCFG, sampling, cuda, batch)
    assert tgen._use_talker_sample_kernel(tt, KCFG, sampling, cuda, batch, kv_quant=batch > 1)
    assert not tgen._use_cp_kernel(tc, CPC, KCFG, sampling, cpu, batch)
    assert not tgen._use_talker_sample_kernel(tt, KCFG, sampling, cpu, batch)


def test_k1_plain_version_samples_with_top_p(fused_int8):
    tt, _ = fused_int8
    H, Vt = KCFG.hidden_size, KCFG.vocab_size
    g = torch.Generator().manual_seed(0)
    cache = ttk.make_cache(KCFG, 1, 64, torch.bfloat16, "cpu")
    ttk.forward(tt, KCFG, torch.randn(1, 20, H, generator=g).mul(0.2).to(torch.bfloat16), cache, 0)
    x = torch.randn(1, 1, H, generator=g).mul(0.2).to(torch.bfloat16)
    cos, sin = torch.ones(128, dtype=torch.bfloat16), torch.zeros(128, dtype=torch.bfloat16)
    seen = torch.zeros(Vt, dtype=torch.bool)
    supp = torch.zeros(Vt)
    for top_p, ref_exact in ((0.3, False), (0.9, True)):
        for s in range(4):
            kw = dict(temperature=0.9, top_k=50, top_p=top_p, ref_exact_top_p=ref_exact,
                      rep_penalty=1.0, seed=(s, 1), suppress_add=supp, seen=seen)
            c = ttk.KVCache(cache.k.clone(), cache.v.clone())
            _, code, logits = tkk.talker_decode_step(tt, KCFG, x, c, 20, cos, sin,
                                                     return_logits=True, **kw)
            want = sample_row(logits, temperature=0.9, top_k=50, top_p=top_p,
                              ref_exact_top_p=ref_exact, seed=(s, 1), stream=0)
            assert int(code) == int(want)
    assert tkk.talker_decode_step.launches == 0  # CPU tensors never launch


def test_k2_plain_version_samples_inside_top_p(fused_int8):
    tt, tc = fused_int8
    g = torch.Generator().manual_seed(1)
    hidden = torch.randn(2, KCFG.hidden_size, generator=g).mul(0.3).to(torch.bfloat16)
    code0 = torch.tensor([3, 77], dtype=torch.int32)
    codes, _, logits = tcpk.predict_codes_fused(tc, CPC, tt, hidden, code0, (4, 5),
                                                temperature=0.9, top_k=50, top_p=0.4,
                                                return_logits=True)
    for b in range(2):
        for j in range(15):
            kept = top_p_filter(top_k_filter(logits[j, b], 50), 0.4) > NEG_BIG / 2
            assert kept[int(codes[b, j])]
