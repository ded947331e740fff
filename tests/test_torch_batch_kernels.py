"""The plain versions of K1 and K2 at B > 1 against the Pallas kernels in
interpret mode (tests/test_talker_kernel.py's and tests/test_cp_kernel.py's
configurations), on bf16 + int8 weights.

K1 (``talker_decode_step``) at B in {2, 5} with ragged offsets, in sample
mode (greedy) and non-sample mode, on a bf16 cache and on an int8 cache with
row scales. Bounds are the JAX kernel tests' own, scaled by the mean |value|
(tests/test_talker_kernel.py:178, :391, :546): hidden 0.15, new k/v rows 0.1
(an int8 cache's rows dequantized against the Pallas kernel's unquantized
rows); greedy code0 equal.

K2 (``predict_codes_fused``) at B in {2, 9}, greedy and teacher-forced on the
Pallas kernel's codes: logits within 0.06 of each row's logit spread, codes
equal wherever the top-2 gap exceeds twice that noise, esum bit-equal
(tests/test_cp_kernel.py:131, :168).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.ops import cp_kernel as j_cpk
from qwen3tts_tpu.ops.norms import rms_norm as j_rms
from qwen3tts_tpu.ops.rope import mrope_cos_sin as j_mrope
from qwen3tts_tpu.ops.talker_kernel import talker_decode_step as j_step
from qwen3tts_tpu.utils import host_init as jhi
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.ops import cp_kernel as tcpk
from qwen3tts_tpu_torch.ops import talker_kernel as tkk
from qwen3tts_tpu_torch.ops.rope import mrope_cos_sin
from qwen3tts_tpu_torch.utils.convert import from_jax_params

from test_torch_code_predictor import KCFG as CPC
from test_torch_talker import KCFG, _int8_params


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def mean_scaled(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).mean() + 1e-6))


@pytest.fixture(scope="module")
def k1_params():
    jp = _int8_params(KCFG, 0)
    return jp, from_jax_params(jp, "cpu")


OFFS = {2: [37, 90], 5: [37, 90, 5, 64, 1]}


@pytest.mark.parametrize("B,kv_quant,sample", [
    (2, False, True), (2, True, False), (5, False, False), (5, True, True),
])
def test_k1_plain_batched_matches_pallas_interpret(k1_params, B, kv_quant, sample):
    jp, tp = k1_params
    cfg, H, V = KCFG, KCFG.hidden_size, KCFG.vocab_size
    jcache = jtk.make_cache(cfg, B, 256, jnp.bfloat16, quantized=kv_quant)
    pre = jnp.asarray(rand(B, 90, H, seed=3, scale=0.2), jnp.bfloat16)
    _, jcache = jtk.forward(jp, cfg, pre, jcache, jnp.int32(0))
    offs = np.array(OFFS[B], np.int32)
    x = rand(B, 1, H, seed=5, scale=0.2)
    seen = np.zeros((B, V), bool)
    for b in range(B):
        seen[b, [3 + b, 100 + 7 * b]] = True
    supp = np.zeros(V, np.float32)
    supp[V - 64 :] = -1e30
    cos, sin = j_mrope(jnp.asarray(offs)[:, None], 128, cfg.rope_theta, cfg.mrope_section,
                       jnp.bfloat16)
    kw = dict(interpret=True)
    if kv_quant:
        kw.update(k_scale=jcache.ks, v_scale=jcache.vs)
    if sample:
        kw.update(sample=dict(temperature=0.0, top_k=8, rep_penalty=1.3, eos_id=-1),
                  seed=jnp.asarray((7, 13), jnp.int32), suppress_add=jnp.asarray(supp)[None],
                  seen=jnp.asarray(seen, jnp.float32))
    out = j_step(jp, cfg, jnp.asarray(x, jnp.bfloat16), jcache.k, jcache.v, jnp.asarray(offs),
                 cos, sin, **kw)
    h_j, k_j, v_j = out[:3]
    if not sample:
        h_j = j_rms(h_j, jp["norm"], cfg.rms_norm_eps)

    tcache = from_jax_params(jcache, "cpu")
    tcos, tsin = mrope_cos_sin(torch.from_numpy(offs)[:, None], 128, cfg.rope_theta,
                               cfg.mrope_section, torch.bfloat16)
    tkw = dict(sample=sample)
    if sample:
        tkw.update(temperature=0.0, top_k=8, rep_penalty=1.3, eos_id=-1, seed=(7, 13),
                   suppress_add=torch.from_numpy(supp), seen=torch.from_numpy(seen))
    res = tkk.talker_decode_step(tp, cfg, torch.from_numpy(x).to(torch.bfloat16), tcache,
                                 torch.from_numpy(offs), tcos[:, 0], tsin[:, 0], **tkw)
    h_t = res[0] if sample else res
    assert h_t.shape == (B, H)
    assert mean_scaled(h_t.float().numpy(), np.asarray(h_j, np.float32).reshape(B, H)) < 0.15
    rows = torch.arange(B)
    pos = torch.from_numpy(offs).long()
    for got, scale, ref in ((tcache.k, getattr(tcache, "ks", None), k_j),
                            (tcache.v, getattr(tcache, "vs", None), v_j)):
        new = got[:, rows, :, pos]  # [B, L, NKV, D]
        if kv_quant:
            new = ttk.dequantize_kv(new, scale[:, rows, :, pos])
        ref = np.asarray(ref, np.float32).transpose(1, 0, 2, 3)
        assert mean_scaled(new.float().numpy(), ref) < 0.1
    if sample:
        assert (res[1].numpy() == np.asarray(out[3])).all()
    assert tkk.talker_decode_step.launches == 0  # CPU tensors never launch


def test_k1_step_supported_batch_and_cache(k1_params):
    _, tp = k1_params
    for B in (1, 8, 48, 64, 65, 128, 256):
        assert tkk.step_supported(tp, KCFG, B, False) and tkk.step_supported(tp, KCFG, B, True)
    assert not tkk.step_supported(tp, KCFG, 257)


@pytest.fixture(scope="module")
def k2_setup():
    jp = jhi.to_device(jhi.host_init_cp_params(0, CPC, 256), jnp.bfloat16)
    jp["layers"] = jtk.fuse_layer_projections(jp["layers"])
    from qwen3tts_tpu.ops.quant import quantize_decode_params_int8 as jq8

    jp = jq8(jp, "lm_head")
    jt = {"codec_embedding": jnp.asarray(rand(512, 256, seed=7, scale=0.02), jnp.bfloat16)}
    return jp, jt, from_jax_params(jp, "cpu"), from_jax_params(jt, "cpu")


@pytest.mark.parametrize("B", [2, 9])
def test_k2_plain_batched_matches_pallas_interpret(k2_setup, B):
    jp, jt, tp, tt = k2_setup
    hidden = rand(B, 256, seed=3 + B, scale=0.3)
    code0 = np.array([(17 + 61 * b) % 512 for b in range(B)], np.int32)
    codes_j, esum_j, logits_j = j_cpk.predict_codes_fused(
        jp, CPC, jt, jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(code0), jax.random.PRNGKey(5),
        temperature=0.0, top_k=50, mode="wo_bf16", interpret=True, return_logits=True,
    )
    codes_j = np.array(codes_j)
    codes_t, esum_t, logits_t = tcpk.predict_codes_fused(
        tp, CPC, tt, torch.from_numpy(hidden).to(torch.bfloat16), torch.from_numpy(code0), (5, 6),
        temperature=0.0, top_k=50, force_codes=torch.from_numpy(codes_j), return_logits=True,
    )
    assert codes_t.shape == (B, 15) and esum_t.shape == (B, 256)
    lj, lt = np.asarray(logits_j, np.float32), logits_t.numpy()  # [15, B, V]
    assert lt.shape == lj.shape
    spread = lj.std(axis=-1, keepdims=True) + 1e-6
    rel = np.abs(lt - lj) / spread
    assert rel.max() < 0.06, rel.max()
    top2 = np.sort(lj, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) / spread[..., 0] > 2 * rel.max(axis=-1)  # [15, B]
    assert decisive.mean() >= 0.5
    assert (codes_t.numpy().T[decisive] == codes_j.T[decisive]).all()
    assert esum_t.numpy().tobytes() == np.asarray(esum_j, np.float32).tobytes()
    assert tcpk.kernel_supported(tp, CPC, 256, 256) and not tcpk.kernel_supported(tp, CPC, 256, 257)
    assert tcpk.predict_codes_fused.launches == 0


def test_k2_rows_draw_from_their_own_streams(k2_setup):
    """Sampled at B=3 with the same hidden and code0 in every row: row 0
    draws what a single-sequence call draws, the other rows draw their own
    codes (streams j + 1 + 16 b)."""
    _, _, tp, tt = k2_setup
    hidden = torch.from_numpy(rand(1, 256, seed=2, scale=0.3)).to(torch.bfloat16)
    code0 = torch.tensor([17], dtype=torch.int32)
    kw = dict(temperature=0.9, top_k=8)
    one, esum1 = tcpk.predict_codes_fused(tp, CPC, tt, hidden, code0, (11, 12), **kw)
    three, esum3 = tcpk.predict_codes_fused(tp, CPC, tt, hidden.expand(3, 256), code0.expand(3),
                                            (11, 12), **kw)
    assert torch.equal(three[0], one[0]) and torch.equal(esum3[0], esum1[0])
    assert (three[1] != three[0]).any() and (three[2] != three[1]).any()


def test_kernel_limits_come_from_the_header():
    """The wrappers' limits are csrc/common.cuh's own constants, read from
    the source: the most rows of one call, the partial-sum rows, the head
    size and the streams per row."""
    from qwen3tts_tpu_torch.ops import _cuda
    from qwen3tts_tpu_torch.ops.decode_blocks import STREAMS_PER_ROW

    lim = _cuda.LIMITS
    assert tkk.MAX_BATCH == tcpk.MAX_BATCH == lim["MAX_BATCH"] == 256
    assert (_cuda.workspace_rows(1), _cuda.workspace_rows(2)) == (
        lim["GEMV_MAX_SPLIT"], lim["TC_MAX_PARTS"]) == (64, 1024)
    assert (lim["HEAD_DIM"], lim["ATTN_MAX_GROUP"], STREAMS_PER_ROW) == (128, 4, 16)


@pytest.fixture(scope="module")
def packed_trees():
    """KCFG's talker and CPC's code predictor with every matmul packed (int4,
    group 64, the host_init packer), as from_pretrained(keep_packed=True)."""
    from qwen3tts_tpu_torch.utils import host_init as thi

    tp = thi.pack_linear_params(thi.host_init_talker_params(0, KCFG))
    cp = thi.pack_linear_params(thi.host_init_cp_params(1, CPC, KCFG.hidden_size))
    return thi.to_device(tp, torch.float32, "cpu"), thi.to_device(cp, torch.float32, "cpu")


@pytest.mark.parametrize("batch,fused,takes", [
    (1, True, True), (64, True, True), (65, True, True), (128, True, True), (256, True, True),
    (257, True, False), (8, False, False), (8, "packed", True),
])
def test_lockstep_on_cuda_takes_only_the_kernels(k1_params, k2_setup, packed_trees, batch, fused,
                                                 takes):
    """K1 and K2 take 1..256 rows of the fused int8 layout; a packed tree
    (every matmul a PackedLinear) takes the plain lockstep on K4 and
    quant_gemm. On a CUDA device the lockstep decode raises for any other
    batch or layout (no plain matmul on the card), naming the bound; on the
    CPU it takes them all."""
    from qwen3tts_tpu_torch.models import batch_generate as tbg

    _, tp = k1_params
    _, _, cp, _ = k2_setup
    if fused == "packed":
        tp, cp = packed_trees
        assert not tbg.kernels_take(tp, cp, KCFG, CPC, 257, True)
        # a mixed tree (one dense matmul) is neither layout
        mixed = dict(tp, codec_head=torch.zeros(KCFG.hidden_size, KCFG.vocab_size))
        assert not tbg.kernels_take(mixed, cp, KCFG, CPC, batch, True)
        with pytest.raises(ValueError, match=r"keep_packed=True\), every matmul packed"):
            tbg._require_kernels(mixed, cp, KCFG, CPC, torch.device("cuda"), batch, False)
    elif not fused:  # a dense qkv projection
        tp = dict(tp, layers=dict(tp["layers"], qkv_proj=tp["layers"]["qkv_proj"].q.float()))
    assert tbg.kernels_take(tp, cp, KCFG, CPC, batch, True) == takes
    args = (tp, cp, KCFG, CPC)
    tbg._require_kernels(*args, torch.device("cpu"), batch, False)
    if takes:
        tbg._require_kernels(*args, torch.device("cuda"), batch, False)
    else:
        with pytest.raises(ValueError, match="K1 and K2, which take 1..256 rows"):
            tbg._require_kernels(*args, torch.device("cuda"), batch, False)
