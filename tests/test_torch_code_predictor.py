"""Port code predictor against the JAX package: the plain ``predict_codes``
against ``cp.predict_codes`` (greedy), and K2's plain version against the
Pallas kernel ``predict_codes_fused`` in interpret mode, greedy and
teacher-forced: both are fed the Pallas kernel's codes, so one bf16 near-tie
cannot cascade, in the ``wo_bf16`` and ``dyn_int8`` modes. K5, the older
Pallas layout of the same function (ops/cp_kernel_old.py), is held against
its port, the module of the same name.

Tolerances:
* float32 weights: codes equal (greedy).
* K2 against the Pallas kernels: per-position logits within 0.06 of the
  logit spread in ``wo_bf16``, 0.25 in ``dyn_int8`` (the JAX kernel test's
  bounds, tests/test_cp_kernel.py); the code equal wherever the top-2 gap
  exceeds twice that position's noise; esum bit-equal (both sum the same
  bf16 rows in f32 in the same order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu.config import CodePredictorConfig
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.ops import cp_kernel as j_cpk
from qwen3tts_tpu.ops import cp_kernel_old as j_cpk_old
from qwen3tts_tpu.ops.quant import quantize_decode_params_int8 as jq8
from qwen3tts_tpu.utils import host_init as jhi
from qwen3tts_tpu_torch.models import code_predictor as tcp
from qwen3tts_tpu_torch.ops import cp_kernel as tcpk
from qwen3tts_tpu_torch.ops import cp_kernel_old as tcpk_old
from qwen3tts_tpu_torch.utils.convert import from_jax_params

from test_models import TINY_CP, TINY_TALKER

KCFG = CodePredictorConfig(  # tests/test_cp_kernel.py's config
    vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
    num_attention_heads=16, num_key_value_heads=8, head_dim=128,
)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_predict_codes_greedy_f32_equal():
    """Plain path, float32, with the small-to-MTP projection (talker 64 ->
    CP 32): the 15 greedy codes of several frames are equal."""
    jp = jhi.to_device(jhi.host_init_cp_params(2, TINY_CP, TINY_TALKER.hidden_size), jnp.float32)
    jt = {"codec_embedding": jnp.asarray(rand(TINY_TALKER.vocab_size, 64, seed=3, scale=0.3))}
    tp, tt = from_jax_params(jp, "cpu"), from_jax_params(jt, "cpu")
    assert "small_to_mtp_projection" in tp
    for frame in range(3):
        hidden = rand(1, 64, seed=10 + frame)
        code0 = np.array([frame * 97 + 5], np.int32)
        cj = jcp.predict_codes(
            jp, TINY_CP, jt, jnp.asarray(hidden), jnp.asarray(code0), jax.random.PRNGKey(0),
            temperature=0.0, top_k=50, top_p=1.0,
        )
        ct = tcp.predict_codes(
            tp, TINY_CP, tt, torch.from_numpy(hidden), torch.from_numpy(code0), None,
            temperature=0.0, top_k=50, top_p=1.0,
        )
        assert ct.dtype == torch.int32
        assert (ct.numpy() == np.asarray(cj)).all(), frame
        rest = np.array(cj)
        sj = jcp.sum_codec_embeddings(jp, jt, jnp.asarray(code0), jnp.asarray(rest))
        st = tcp.sum_codec_embeddings(tp, tt, torch.from_numpy(code0), torch.from_numpy(rest))
        assert np.abs(st.numpy() - np.asarray(sj)).max() <= 1e-5 * max(1.0, np.abs(sj).max())


@pytest.fixture(scope="module")
def kernel_setup():
    jp = jhi.to_device(jhi.host_init_cp_params(0, KCFG, 256), jnp.bfloat16)
    jp["layers"] = jtk.fuse_layer_projections(jp["layers"])
    jp = jq8(jp, "lm_head")
    jt = {"codec_embedding": jnp.asarray(rand(512, 256, seed=7, scale=0.02), jnp.bfloat16)}
    hidden = jnp.asarray(rand(1, 256, seed=3, scale=0.3), jnp.bfloat16)
    code0 = jnp.array([17], jnp.int32)
    port = (from_jax_params(jp, "cpu"), from_jax_params(jt, "cpu"),
            from_jax_params(hidden, "cpu"), torch.tensor([17], dtype=torch.int32))
    return (jp, jt, hidden, code0), port


@pytest.mark.parametrize("pallas,mode", [
    pytest.param("cp_kernel", "wo_bf16", id="cp_kernel"),
    pytest.param("cp_kernel_old", "wo_bf16", id="cp_kernel_old"),
    pytest.param("cp_kernel", "dyn_int8", id="cp_kernel-dyn_int8"),
    pytest.param("cp_kernel_old", "dyn_int8", id="cp_kernel_old-dyn_int8"),
])
def test_k2_plain_matches_pallas_interpret(kernel_setup, pallas, mode):
    """Each Pallas module against its port (ops/cp_kernel.py for K2,
    ops/cp_kernel_old.py for K5), in both int8 modes. dyn_int8's bounds are
    the JAX kernel test's own (tests/test_cp_kernel.py): logits within 0.25
    of the spread, at least 3 decisive positions."""
    (jp, jt, hidden, code0), (tp, tt, th, tc0) = kernel_setup
    fused = (j_cpk if pallas == "cp_kernel" else j_cpk_old).predict_codes_fused
    port = (tcpk if pallas == "cp_kernel" else tcpk_old).predict_codes_fused
    codes_j, esum_j, logits_j = fused(
        jp, KCFG, jt, hidden, code0, jax.random.PRNGKey(5), temperature=0.0, top_k=50,
        mode=mode, interpret=True, return_logits=True,
    )
    codes_j = np.array(codes_j)[0]  # a writable copy for torch.from_numpy
    codes_t, esum_t, logits_t = port(
        tp, KCFG, tt, th, tc0, (5, 6), temperature=0.0, top_k=50,
        force_codes=torch.from_numpy(codes_j), return_logits=True, mode=mode,
    )
    lj, lt = np.asarray(logits_j, np.float32), logits_t.numpy()
    spread = lj.std(axis=-1, keepdims=True) + 1e-6
    rel = np.abs(lt - lj) / spread
    assert rel.max() < (0.06 if mode == "wo_bf16" else 0.25), rel.max()
    top2 = np.sort(lj, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) / spread[:, 0] > 2 * rel.max(axis=1)
    assert decisive.sum() >= (8 if mode == "wo_bf16" else 3)
    assert (codes_t.numpy()[0][decisive] == codes_j[decisive]).all()
    assert esum_t.numpy().tobytes() == np.asarray(esum_j, np.float32).tobytes()
    assert tcpk.predict_codes_fused.launches == 0  # CPU tensors never launch
    assert tcpk_old.predict_codes_fused.launches == 0


def test_k2_sampled_codes_within_exact_top_k(kernel_setup):
    _, (tp, tt, th, tc0) = kernel_setup
    codes, esum, logits = tcpk.predict_codes_fused(
        tp, KCFG, tt, th, tc0, (11, 12), temperature=0.9, top_k=8, return_logits=True,
    )
    codes, logits = codes.numpy()[0], logits.numpy()
    for j in range(KCFG.num_code_groups - 1):
        assert logits[j, codes[j]] >= np.sort(logits[j])[-8], j
    per_cb = sum(tp["codec_embedding"][j][int(codes[j])].float() for j in range(15))
    assert torch.equal(esum[0], per_cb)
    codes2, _ = tcpk.predict_codes_fused(tp, KCFG, tt, th, tc0, (13, 12), temperature=0.9, top_k=8)
    assert (codes2.numpy()[0] != codes).any()
    assert tcpk.kernel_supported(tp, KCFG, 256)
    assert not tcpk.kernel_supported(dict(tp, small_to_mtp_projection={}), KCFG, 256)
