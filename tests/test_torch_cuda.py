"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import). This file imports no JAX, so it runs on a GPU
machine without it; there, run it without the repository's conftest (which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Small shapes (head_dim 128 as the kernels need). Bounds as in chip_smoke.py:
scaled max|a - b| / max(1, max|b|) < 0.05 for K1/K2's bf16 outputs (same
rounding points, f32 sums in another order), codes equal unless a logit
near-tie within twice the observed logit error explains the difference;
K4 (f32 out) <= 1e-4 scaled (at the seven packed 0.6B shapes in every
rows-a-warp form too), and so ``quant_gemm``, K4's function at M rows, at
every packed 0.6B and 1.7B shape, M 2-4096, bits 4 and 8, groups 32 and
64, bf16 and f32 x, with the packed lockstep and every batched entry
point of a packed model on it (K1 and K2 never launched); K1's persistent B = 1 step (csrc/talker_frame.cu)
in every mode it takes, at short and long prefixes, with its weights copied
ahead or read in place (bit-equal), and its faults raising; K3 (bf16 out)
<= 1e-2 scaled, also against
its plain split twin, and twice in a row bit-equal (its merge counters
reset). K2's batched GEMV alone in its tensor-core and CUDA-core forms:
dyn_int8 partials bit-equal, f32 sums within 1e-5 scaled of float64. K1 and K2 are
held so in both weight modes (int8, dense bf16) and K2 also with the
small-to-MTP projection of a CP narrower than its talker (the 1.7B shape);
both also in the ``dyn_int8`` matmul mode (selected for ``generate_codes``
by QWEN3TTS_TK_MODE / QWEN3TTS_CPK_MODE), K2 on unfused int8 layers, and
K5's port (ops/cp_kernel_old.py), which launches K2's kernel. The top-p
stage of K1's and K2's sampler against ``sample_row`` on the kernels' own
logits (equal but for a cut within rounding of the threshold), and
``generate_codes`` with top_p < 1 on the kernels. The experiment kernels of
qwen3tts_tpu_torch/tools (T7 ``weight_stream``, T6 ``variant_step``, T3
``colsum``, T1 ``attn_form``, T4 ``mxu_variant`` / ``plane_variant``, T5
``kv_append``, T2 ``probe``) against their plain versions. K1, K2 and
the batched GEMV up to MAX_BATCH (256) rows, where each GEMV takes the
batch in groups of 64: against the plain versions at B = 65, 128, 255 and
256 in every mode, at B = 8 and 64 against the digests the kernels gave
when the batch stopped at 64 rows (tools/batch_bits.py), and
``generate_batch`` of 256 texts as one lockstep.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qwen3tts_tpu_torch import config as C
from qwen3tts_tpu_torch.models import batch_generate as bg
from qwen3tts_tpu_torch.models import generate as gen
from qwen3tts_tpu_torch.models import talker as tk
from qwen3tts_tpu_torch.ops import cp_kernel as cpk
from qwen3tts_tpu_torch.ops import quant as q
from qwen3tts_tpu_torch.ops import talker_kernel as tkk
from qwen3tts_tpu_torch.ops.attention import (
    decode_attention_inner, decode_attention_ref, decode_attention_split_ref,
)
from qwen3tts_tpu_torch.ops.decode_blocks import (
    NEG_BIG, gumbel_noise, sample_row, top_k_filter, top_p_cum, top_p_threshold,
)
from qwen3tts_tpu_torch.ops.quant import quantize_decode_params_int8
from qwen3tts_tpu_torch.ops.rope import mrope_cos_sin
from qwen3tts_tpu_torch.utils import host_init as hi

pytestmark = pytest.mark.cuda

CPC = C.CodePredictorConfig(
    vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
    num_attention_heads=16, num_key_value_heads=8, head_dim=128,
)
CFG = C.TalkerConfig(
    vocab_size=3072, text_vocab_size=64, hidden_size=256, text_hidden_size=256,
    intermediate_size=512, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
    head_dim=128, code_predictor_config=CPC,
)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def weights(dev):
    tp = hi.to_device(hi.host_init_talker_params(0, CFG), torch.bfloat16, dev)
    tp["layers"] = tk.fuse_layer_projections(tp["layers"])
    tp = quantize_decode_params_int8(tp, "codec_head")
    cp = hi.to_device(hi.host_init_cp_params(1, CPC, CFG.hidden_size), torch.bfloat16, dev)
    cp["layers"] = tk.fuse_layer_projections(cp["layers"])
    cp = quantize_decode_params_int8(cp, "lm_head")
    return tp, cp


def scaled(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def _pen(logits, seen):
    return torch.where(seen, torch.where(logits < 0, logits * 1.05, logits / 1.05), logits)


def _k1_case(dev, tp, pos, T, random_cache):
    """x, a cache of T rows whose first ``pos`` rows are filled (by a prefill,
    or random when ``random_cache``), rope rows at ``pos``, mask and seen set."""
    g = torch.Generator(device=dev).manual_seed(pos)
    cache = tk.make_cache(CFG, 1, T, torch.bfloat16, dev)
    if random_cache:
        cache.k.copy_(torch.randn(cache.k.shape, generator=g, device=dev))
        cache.v.copy_(torch.randn(cache.v.shape, generator=g, device=dev).mul(0.5))
    else:
        prefill = torch.randn(1, pos, 256, generator=g, device=dev).mul(0.2).bfloat16()
        tk.forward(tp, CFG, prefill, cache, 0)
    x = torch.randn(1, 1, 256, generator=g, device=dev).mul(0.2).bfloat16()
    cos, sin = mrope_cos_sin(torch.full((1, 1), pos, device=dev), 128, CFG.rope_theta,
                             CFG.mrope_section, torch.bfloat16)
    V = CFG.vocab_size
    supp = torch.zeros(V, device=dev)
    supp[V - 1024:] = -1e30
    seen = torch.zeros(V, dtype=torch.bool, device=dev)
    seen[[3, 99]] = True
    return x, cache, cos[0, 0], sin[0, 0], supp, seen


def _k1(fn, tp, case, pos, **kw):
    x, cache0, cos, sin, supp, seen = case
    cache = tk.KVCache(cache0.k.clone(), cache0.v.clone())
    kw = dict(dict(top_k=50, rep_penalty=1.05, eos_id=-1, seed=(1, 2), suppress_add=supp,
                   seen=seen, return_logits=True), **kw)
    h, code, logits = fn(tp, CFG, x, cache, pos, cos, sin, **kw)
    return h, int(code), logits, cache


@pytest.mark.parametrize("top_k", [50, 1])
def test_k1_eos_restore_matches_plain(dev, weights, top_k):
    """EOS left unsuppressed 0.1 below the k-th logit of the other ids: only
    the sampler's EOS restore lets it be drawn. Kernel and plain version
    draw the same code0 over 32 seeds (a flip only on a non-EOS near-tie)."""
    tp, _ = weights
    pos, eos = 30, CFG.codec_eos_token_id
    case = _k1_case(dev, tp, pos, 64, random_cache=False)
    supp, seen = case[4], case[5]
    _, _, lr, _ = _k1(tkk.talker_decode_step_ref, tp, case, pos, temperature=0.0)
    kth = torch.topk(_pen(lr, seen) + supp, top_k).values[-1]
    supp_e = supp.clone()
    supp_e[eos] = kth - 0.1 - _pen(lr, seen)[eos]
    draws = 0
    for s in range(32):
        kw = dict(temperature=0.9, top_k=top_k, eos_id=eos, seed=(s, 3 * s + 1), suppress_add=supp_e)
        _, a, la, _ = _k1(tkk.talker_decode_step, tp, case, pos, **kw)
        _, b, lb, _ = _k1(tkk.talker_decode_step_ref, tp, case, pos, **kw)
        draws += b == eos
        if a != b:
            z = _pen(lb, seen) + supp_e
            err = 1.05 * float((la - lb).abs().max())
            kth_b = torch.topk(z, top_k).values[-1]
            noise = gumbel_noise(s, 3 * s + 1, 0, CFG.vocab_size, dev)
            edge = min(abs(float(z[a] - kth_b)), abs(float(z[b] - kth_b)))
            gap = abs(float((z[a] - z[b]) / 0.9 + noise[a] - noise[b]))
            assert eos not in (a, b), (s, a, b)
            assert edge <= 2 * err or gap <= 2 * err / 0.9 + 1e-6, (s, a, b)
    if top_k == 1:
        assert draws > 0  # P(no EOS in 32 draws) ~ 0.53^32


@pytest.mark.parametrize("pos,T,random_cache", [(70, 128, False), (700, 768, True)])
def test_k1_matches_plain_and_counts(dev, weights, pos, T, random_cache):
    """Greedy K1 step against its plain version: after a prefill, and at
    position 700 of a random 768-row cache, where the attention walks three
    tiles with an online softmax."""
    tp, _ = weights
    case = _k1_case(dev, tp, pos, T, random_cache)
    before = tkk.talker_decode_step.launches
    hk, ck, lk, cak = _k1(tkk.talker_decode_step, tp, case, pos, temperature=0.0)
    assert tkk.talker_decode_step.launches == before + 1
    hr, cr, lr, car = _k1(tkk.talker_decode_step_ref, tp, case, pos, temperature=0.0)
    assert scaled(hk, hr) < 0.05 and scaled(lk, lr) < 0.05
    assert scaled(cak.k[:, 0, :, pos], car.k[:, 0, :, pos]) < 0.05
    assert scaled(cak.v[:, 0, :, pos], car.v[:, 0, :, pos]) < 0.05
    z = _pen(lr, case[5]) + case[4]
    assert ck == cr or abs(float(z[ck] - z[cr])) <= 2 * float((lk - lr).abs().max())


def test_k2_matches_plain_and_counts(dev, weights):
    tp, cp = weights
    g = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn(1, 256, generator=g, device=dev).mul(0.3).bfloat16()
    code0 = torch.tensor([17], dtype=torch.int32, device=dev)
    cr, er, lr = cpk.predict_codes_fused_ref(cp, CPC, tp, h, code0, (5, 6), temperature=0.0,
                                             top_k=50, return_logits=True)
    before = cpk.predict_codes_fused.launches
    ck, ek, lk = cpk.predict_codes_fused(cp, CPC, tp, h, code0, (5, 6), temperature=0.0,
                                         top_k=50, force_codes=cr, return_logits=True)
    assert cpk.predict_codes_fused.launches == before + 1
    assert scaled(lk, lr) < 0.05
    assert torch.equal(ek, er)  # the same bf16 rows summed in f32 in the same order
    err = float((lk - lr).abs().max())
    for j in range(15):
        a, b = int(ck[0, j]), int(cr[0, j])
        assert a == b or abs(float(lr[j, a] - lr[j, b])) <= 2 * err, j
    # sampled: codes come from the exact top-k set
    cs, _, ls = cpk.predict_codes_fused(cp, CPC, tp, h, code0, (9, 9), temperature=0.9,
                                        top_k=8, return_logits=True)
    for j in range(15):
        assert ls[j, int(cs[0, j])] >= torch.topk(ls[j], 8).values[-1]


def test_generate_codes_runs_on_the_kernels(dev, weights):
    tp, cp = weights
    g = torch.Generator(device=dev).manual_seed(2)
    sampling = gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True)
    n1, n2 = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
    res = gen.generate_codes(
        tp, cp, talker_cfg=CFG, cp_cfg=CPC, sampling=sampling,
        prefill_embeds=torch.randn(1, 64, 256, generator=g, device=dev).mul(0.1).bfloat16(),
        prefill_len=20, trailing_embeds=torch.zeros(16, 256, dtype=torch.bfloat16, device=dev),
        trailing_len=4, tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev),
        max_steps=10, max_frames=12, seed=3, cache_len=128,
    )
    assert res.n_frames == 10
    assert tkk.talker_decode_step.launches - n1 == 9
    assert cpk.predict_codes_fused.launches - n2 == 10
    codes = res.codes[:10].cpu()
    assert (codes[:, 0] < 2048).all() and (codes[:, 1:] < CPC.vocab_size).all()


def _count_syncs(fn):
    """Host synchronisations that ``fn`` makes (torch's sync debug mode)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")  # its first call may warn by itself
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.parametrize("forbid_eos", [True, False])
def test_kernel_loop_syncs_once_per_frame(dev, weights, forbid_eos):
    """K1 + K2 frames read the device back once each (the EOS check), plus
    one copy of code 0's suppress mask per chunk and the stream
    synchronisation that ends the chunk's turn (``generate.device_turn``)."""
    tp, cp = weights
    g = torch.Generator(device=dev).manual_seed(5)
    common = dict(talker_cfg=CFG, cp_cfg=CPC,
                  sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=forbid_eos),
                  trailing_embeds=torch.zeros(16, 256, dtype=torch.bfloat16, device=dev),
                  trailing_len=4, tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev))
    carry = gen.prefill_start(
        tp, cp, **common, prefill_embeds=torch.randn(1, 64, 256, generator=g, device=dev)
        .mul(0.1).bfloat16(), prefill_len=20, cache=tk.make_cache(CFG, 1, 128, device=dev),
        max_frames=12, seed=3)
    n1 = tkk.talker_decode_step.launches
    carry, syncs = _count_syncs(lambda: gen.generate_chunk(tp, cp, carry, **common, until_step=9))
    frames = tkk.talker_decode_step.launches - n1
    assert frames >= 1 and syncs == frames + 2, (frames, syncs)


def _packed_weight(dev, O, I, bits, group, seed=0):
    w = np.random.default_rng(seed).standard_normal((O, I)).astype(np.float32) / np.sqrt(I)
    return q.packed_from_numpy(*q.pack_quantized(w, bits=bits, group=group), bits, group).to(dev)


@pytest.mark.parametrize("bits,group", [(4, 64), (4, 32), (8, 64)])
@pytest.mark.parametrize("O,I", [(1024, 1024), (3072, 1024), (1024, 3072)])
def test_k4_matches_plain(dev, bits, group, O, I):
    w = _packed_weight(dev, O, I, bits, group, seed=O + I)
    g = torch.Generator(device=dev).manual_seed(bits)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(1, I, generator=g, device=dev).to(dtype)
        before = q.quant_gemv.launches
        y = q.quant_gemv(x, w.q, w.scales, w.biases, bits, group)
        assert q.quant_gemv.launches == before + 1
        ref = q.quant_matmul(x, w.q, w.scales, w.biases, bits, group)
        assert y.dtype == torch.float32 and y.shape == (1, O)
        assert scaled(y, ref) <= 1e-4, dtype


def test_k4_unsupported_single_row_raises(dev):
    """6 words per row (48 int4 values) are not a multiple of the kernels'
    16-byte loads: one packed row (K4) and three (quant_gemm) raise on the
    card instead of taking the plain path; three rows at a shape the kernel
    takes run it, once."""
    w = _packed_weight(dev, 64, 48, 4, 16)
    x = torch.randn(1, 1, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4"):
        tk._dense(x, w)
    with pytest.raises(ValueError, match="quant_gemm: 6 words per row is not a multiple of 4"):
        tk._dense(x.expand(1, 3, 48), w)
    w = _packed_weight(dev, 64, 256, 4, 64)
    x = torch.randn(1, 3, 256, device=dev, dtype=torch.bfloat16)
    before = q.quant_gemm.launches
    y = tk._dense(x, w)
    assert q.quant_gemm.launches == before + 1 and y.shape == (1, 3, 64)
    ref = q.quant_matmul(x, w.q, w.scales, w.biases, 4, 64).to(torch.bfloat16)
    assert scaled(y, ref) <= 1e-2


# every (O, I) of the packed 0.6B and 1.7B trees: the talker's and the CP's
# projections, the codec head, the CP's lm_head and the 1.7B projection
GEMM_SHAPES = [(2048, 1024), (1024, 1024), (1024, 2048), (3072, 1024), (1024, 3072),
               (2048, 2048), (6144, 2048), (2048, 6144), (3072, 2048)]
# the most rows quant_gemm's stream form takes by itself, by x type
GEMM_CROSS = q._cuda.GEMM_CROSS
GEMM_ROWS = tuple(sorted({1, 2, 3, 4, 8, 16, 17, 64, 65, 256, 512, 4096}
                         | {c + d for c in GEMM_CROSS.values() for d in (-1, 0, 1)}))


@pytest.mark.parametrize("bits,group", [(4, 64), (4, 32), (8, 64), (8, 32)])
@pytest.mark.parametrize("O,I", GEMM_SHAPES)
def test_quant_gemm_matches_plain(dev, bits, group, O, I):
    """quant_gemm (csrc/quant_gemm.cu) against quant_matmul within K4's
    1e-4 scaled, one launch a call, at every row count the port sends it
    (the lockstep's 2-256 and the CP's 2 B, prefill's thousands), on bf16
    and f32 x."""
    w = _packed_weight(dev, O, I, bits, group, seed=O + I + bits)
    g = torch.Generator(device=dev).manual_seed(group)
    for M in GEMM_ROWS:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(M, I, generator=g, device=dev).to(dtype)
            before = q.quant_gemm.launches
            y = q.quant_gemm(x, w.q, w.scales, w.biases, bits, group)
            assert q.quant_gemm.launches == before + 1
            ref = q.quant_matmul(x, w.q, w.scales, w.biases, bits, group)
            assert y.dtype == torch.float32 and y.shape == (M, O)
            assert scaled(y, ref) <= 1e-4, (M, dtype)


def test_quant_gemm_forms_agree(dev):
    """Each form, forced (the stream form; the staged one in every row-tile
    form, with the rows of x in one block or split over blocks), within
    1e-5 scaled of the automatic call at the crossover rows of each x type
    and at 300; the automatic form is the stream one up to the crossover
    and the staged one past it, and gives the same bits in two calls; at
    the automatic row tiles a split gives the staged sums bit for bit (a
    row's slices meet in one order)."""
    w = _packed_weight(dev, 3072, 1024, 4, 64)
    g = torch.Generator(device=dev).manual_seed(19)
    args = (w.q, w.scales, w.biases, 4, 64)
    for dtype in (torch.bfloat16, torch.float32):
        cross = GEMM_CROSS[dtype]
        for M in (cross - 1, cross, cross + 1, 300):
            x = torch.randn(M, 1024, generator=g, device=dev).to(dtype)
            base = q.quant_gemm(x, *args)
            assert torch.equal(q.quant_gemm(x, *args), base), (M, dtype)
            want = "stream" if M <= cross else "staged"
            assert q.quant_gemm_form(M, 3072, 1024, 4, 64, dtype) == want, (M, dtype)
            assert scaled(q.quant_gemm(x, *args, form="stream"), base) <= 1e-5, (M, dtype)
            auto = q._cuda.library().qt_quant_gemm_tiles(M, 1024, 4, 64)
            for tiles in (1, 2, 4):
                for slices in (0, 1, 3):
                    y = q.quant_gemm(x, *args, form="staged", row_tiles=tiles, slices=slices)
                    assert scaled(y, base) <= 1e-5, (M, dtype, tiles, slices)
                    if tiles == auto and want == "staged":
                        assert torch.equal(y, base), (M, dtype, tiles, slices)
    assert q._cuda.library().qt_quant_gemm_tiles(300, 1024, 4, 64) == 4
    x = torch.randn(300, 1024, generator=g, device=dev).bfloat16()
    assert scaled(q.quant_gemm(x[:7], *args), q.quant_gemm(x, *args)[:7]) <= 1e-5
    with pytest.raises(ValueError, match="belong to the staged form"):
        q.quant_gemm(x, *args, form="stream", slices=2)


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_gemm_rows_form(dev, bits):
    """The rows form (K4 on the CUDA cores for one or two rows of a bf16 x)
    is the automatic form there (at int4 while a weight row holds at most 64
    16-byte chunks), gives the same bits in two calls and agrees with the
    stream and staged forms within 1e-5 scaled; it refuses an f32 x and
    three rows."""
    for O, I in ((3072, 1024), (1024, 2048), (1024, 3072)):
        w = _packed_weight(dev, O, I, bits, 64, seed=O + bits)
        args = (w.q, w.scales, w.biases, bits, 64)
        for M in (1, 2):
            x = torch.randn(M, I, generator=torch.Generator(device=dev).manual_seed(M),
                            device=dev).bfloat16()
            want = "rows" if bits == 8 or I // 32 <= 64 else "stream"
            assert q.quant_gemm_form(M, O, I, bits, 64, torch.bfloat16) == want, (O, I, M)
            assert q.quant_gemm_form(M, O, I, bits, 64, torch.float32) == "stream"
            y = q.quant_gemm(x, *args, form="rows")
            assert torch.equal(q.quant_gemm(x, *args, form="rows"), y)
            for form in ("stream", "staged"):
                assert scaled(q.quant_gemm(x, *args, form=form), y) <= 1e-5, (O, I, M, form)
    with pytest.raises(ValueError, match="one or two rows of a bf16 x"):
        q.quant_gemm(x.float(), *args, form="rows")
    with pytest.raises(ValueError, match="one or two rows of a bf16 x"):
        q.quant_gemm(torch.cat([x, x, x]), *args, form="rows")


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_gemm_wide_f32_small_rows(dev, bits):
    """The 1.7B (2048, 6144) down projection with an f32 x at the most rows
    the stream form takes by itself: the widest x a lane streams (its units
    in several batches and passes), within K4's 1e-4 scaled of quant_matmul."""
    M = GEMM_CROSS[torch.float32]
    w = _packed_weight(dev, 2048, 6144, bits, 64, seed=bits)
    x = torch.randn(M, 6144, generator=torch.Generator(device=dev).manual_seed(bits), device=dev)
    assert q.quant_gemm_form(M, 2048, 6144, bits, 64, torch.float32) == "stream"
    y = q.quant_gemm(x, w.q, w.scales, w.biases, bits, 64)
    ref = q.quant_matmul(x, w.q, w.scales, w.biases, bits, 64)
    assert y.shape == (M, 2048) and scaled(y, ref) <= 1e-4


def test_packed_lockstep_runs_quant_gemm_only(dev):
    """``generate_codes_batch`` at B = 4 on packed trees (host_init packer,
    int4, group 64) is the plain lockstep with every matmul on quant_gemm
    (4-row steps, the CP's 8-row first position, the prefill): F x (7 L + 1
    + 15 (7 Lc + 1)) launches for F frames, K4 none (no one-row matmul), K1
    and K2 none; the codes lie in the vocabularies."""
    tp = hi.to_device(hi.pack_linear_params(hi.host_init_talker_params(0, CFG)), torch.bfloat16, dev)
    cp = hi.to_device(hi.pack_linear_params(hi.host_init_cp_params(1, CPC, CFG.hidden_size)),
                      torch.bfloat16, dev)
    assert bg.kernels_take(tp, cp, CFG, CPC, 4, False)
    B, F = 4, 6
    g = torch.Generator(device=dev).manual_seed(5)
    n4, nm = q.quant_gemv.launches, q.quant_gemm.launches
    n1, n2 = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
    res = bg.generate_codes_batch(
        tp, cp, talker_cfg=CFG, cp_cfg=CPC,
        sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True),
        prefill_embeds=torch.randn(B, 16, 256, generator=g, device=dev).mul(0.1).bfloat16(),
        prefill_lens=[16, 9, 12, 5], trailing_embeds=torch.zeros(B, 4, 256, device=dev).bfloat16(),
        trailing_lens=[4, 2, 0, 3], tts_pad_embed=torch.zeros(256, device=dev).bfloat16(),
        cache=tk.make_cache(CFG, B, 64, torch.bfloat16, dev), max_steps=[F] * B, max_frames=F,
        seed=3)
    L, Lc = CFG.num_hidden_layers, CPC.num_hidden_layers
    assert q.quant_gemm.launches - nm == F * (7 * L + 1 + 15 * (7 * Lc + 1))
    assert q.quant_gemv.launches == n4
    assert tkk.talker_decode_step.launches == n1 and cpk.predict_codes_fused.launches == n2
    assert res.n_frames.tolist() == [F] * B
    codes = res.codes.cpu()
    assert (codes[..., 0] < CFG.vocab_size).all() and (codes[..., 1:] < CPC.vocab_size).all()
    assert (codes >= 0).all()



def test_packed_model_batched_entry_points_on_the_card(dev, tmp_path):
    """A ``keep_packed=True`` model on the card (an int4 group-32 checkpoint
    at CLI_TALKER's widths, whose CP is narrower than its talker, so its
    packed projection runs too): ``generate_batch``,
    ``generate_batch_continuous``, ``serve(slots=2)`` and ``generate_batch``
    over a dp mesh of cuda:0 named twice decode with K1 and K2 never
    launched and quant_gemm launched; every waveform finite and of whole
    frames."""
    from qwen3tts_tpu_torch.parallel.mesh import make_mesh
    from qwen3tts_tpu_torch.tools import ckpt_layout
    from qwen3tts_tpu_torch.tts import Qwen3TTSModel

    d = ckpt_layout.write_checkpoint(
        str(tmp_path / "ckpt"), quantize=True,
        config=dict(ckpt_layout.SYNTHETIC_CONFIG, talker_config=CLI_TALKER))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = Qwen3TTSModel.from_pretrained(d, keep_packed=True)
    m.tokenizer = ckpt_layout.StubTokenizer()
    assert m.device.type == "cuda"
    assert isinstance(m.cp_params["small_to_mtp_projection"]["w"], q.PackedLinear)
    texts, speakers = ["The packed lockstep on the card.", "A second row.", "Three."], [
        "aiden", "vivian", "aiden"]
    kw = dict(language="english", max_tokens=6, seed=2)

    def served():
        with m.serve(slots=2, chunk_frames=3, max_frames=16, prompt_bucket=64,
                     trailing_bucket=16) as svc:
            futs = [svc.submit(t, speaker=s, language="english", max_tokens=6)
                    for t, s in zip(texts, speakers)]
            return [f.result() for f in futs]

    runs = (lambda: m.generate_batch(texts, speakers=speakers, **kw),
            lambda: m.generate_batch_continuous(texts, speakers=speakers, slots=2, **kw),
            served,
            lambda: m.generate_batch(texts[:2], speakers=speakers[:2],
                                     dp_mesh=make_mesh(["cuda:0", "cuda:0"], tp=1), **kw))
    for run in runs:
        tkk.talker_decode_step.launches = cpk.predict_codes_fused.launches = 0
        n = q.quant_gemm.launches
        wavs = run()
        assert tkk.talker_decode_step.launches == 0 and cpk.predict_codes_fused.launches == 0
        assert q.quant_gemm.launches > n
        assert wavs and all(np.isfinite(w).all() and len(w) % 1920 == 0 for w in wavs)

def _k3_case(dev, T, pos, layered):
    g = torch.Generator(device=dev).manual_seed(pos)
    lead = (3, 1) if layered else (1,)
    k = torch.randn(*lead, 8, T, 128, generator=g, device=dev).bfloat16()
    v = torch.randn(*lead, 8, T, 128, generator=g, device=dev).bfloat16()
    qv = torch.randn(1, 16, 1, 128, generator=g, device=dev).bfloat16()
    return qv, k, v, 2 if layered else None


# pos 0 and the main path's short prefixes (one chunk); both sides of chunk
# edges (128-row chunks); 17 chunks (136 blocks, past one block per SM);
# pos 4000 and 6000; the last row of each cache; 49 / 50 chunks at 8 kv heads
# (392 / 400 blocks: one wave of 3 blocks per SM and the first past it)
K3_CASES = [(4096, 0), (4096, 40), (4096, 127), (4096, 128), (4096, 255), (4096, 256),
            (4096, 2047), (4096, 2048), (4096, 4000), (4096, 4095), (6144, 6000), (6144, 6143),
            (8192, 6271), (8192, 6272), (8192, 8191)]


@pytest.mark.parametrize("layered", [False, True])
@pytest.mark.parametrize("T,pos", K3_CASES)
def test_k3_matches_plain(dev, T, pos, layered):
    qv, k, v, layer = _k3_case(dev, T, pos, layered)
    before = decode_attention_inner.launches
    out = decode_attention_inner(qv, k, v, pos, 128**-0.5, layer=layer)
    assert decode_attention_inner.launches == before + 1
    ref = decode_attention_ref(qv, k, v, pos, 128**-0.5, layer=layer)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 16, 1, 128)
    assert scaled(out, ref) <= 1e-2
    # the kernel's merge is the plain split twin's arithmetic
    assert scaled(out, decode_attention_split_ref(qv, k, v, pos, 128**-0.5, layer=layer)) <= 1e-2


def test_k3_phase_profile_runs(dev):
    """K3's kernel stopped after each phase (the profile of
    tools/time_k3_k2.py and chip_smoke phase 8) launches, and leaves the
    merge counters at zero for the next full call."""
    from qwen3tts_tpu_torch.ops import attention as attn
    from qwen3tts_tpu_torch.tools import time_k3_k2 as tkt

    qv, k, v, _ = _k3_case(dev, 4096, 4000, True)
    kv = torch.stack([k, v])  # [2, L, 1, NKV, T, D]
    for cut in range(1, len(tkt.CUTS) + 1):
        tkt.k3_cut(qv, kv, 4000, cut, kv.shape[1])()
    torch.cuda.synchronize()
    assert not attn.head_counters(dev, 8).any()
    out = decode_attention_inner(qv, k, v, 4000, 128**-0.5, layer=2)
    assert scaled(out, decode_attention_ref(qv, k, v, 4000, 128**-0.5, layer=2)) <= 1e-2


@pytest.mark.parametrize("T,pos", [(4096, 100), (4096, 4000), (6144, 6000)])
def test_k3_twice_gives_the_same_result(dev, T, pos):
    """The per-kv-head merge counters are left at zero: a second call (and
    a call at another position in between) merges the same way."""
    from qwen3tts_tpu_torch.ops import attention as attn

    qv, k, v, _ = _k3_case(dev, T, pos, False)
    first = decode_attention_inner(qv, k, v, pos, 128**-0.5)
    decode_attention_inner(qv, k, v, pos // 2, 128**-0.5)
    second = decode_attention_inner(qv, k, v, pos, 128**-0.5)
    assert torch.equal(first, second)
    assert not attn.head_counters(dev, 8).any()


def test_packed_loop_runs_k4_k3_and_syncs_once_per_frame(dev):
    """Packed weights (host_init packer, int4, group 64) on a 4096-row cache:
    the plain loop of generate_chunk takes K4 for every single-row matmul and
    K3 for every decode step's attention, and reads the device back once per
    frame (the EOS check), plus once per chunk for the suppress mask and
    once as the chunk's turn ends (``generate.device_turn``)."""
    tp = hi.to_device(hi.pack_linear_params(hi.host_init_talker_params(0, CFG)), torch.bfloat16, dev)
    cp = hi.to_device(hi.pack_linear_params(hi.host_init_cp_params(1, CPC, CFG.hidden_size)),
                      torch.bfloat16, dev)
    sampling = gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True)
    g = torch.Generator(device=dev).manual_seed(4)
    common = dict(talker_cfg=CFG, cp_cfg=CPC, sampling=sampling,
                  trailing_embeds=torch.zeros(16, 256, dtype=torch.bfloat16, device=dev),
                  trailing_len=4, tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev))
    n4, n3 = q.quant_gemv.launches, decode_attention_inner.launches
    carry = gen.prefill_start(
        tp, cp, **common, prefill_embeds=torch.randn(1, 64, 256, generator=g, device=dev)
        .mul(0.1).bfloat16(), prefill_len=20, cache=tk.make_cache(CFG, 1, 4096, device=dev),
        max_frames=12, seed=3)
    L, Lc = CFG.num_hidden_layers, CPC.num_hidden_layers
    per_cp = 14 * (7 * Lc + 1) + 1
    assert q.quant_gemv.launches - n4 == 1 + per_cp  # codec head row + the CP
    carry, syncs = _count_syncs(lambda: gen.generate_chunk(tp, cp, carry, **common, until_step=9))
    assert carry.step == 9
    assert q.quant_gemv.launches - n4 == 1 + per_cp + 8 * (7 * L + 1 + per_cp)
    assert decode_attention_inner.launches - n3 == 8 * L
    assert syncs == 8 + 2, syncs


def _batched_case(dev, B, T, kv_quant, seed=0):
    """x [B, 1, H], a random cache of T rows (int8 with row scales, or bf16),
    ragged offsets, per-row rope rows and seen sets."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = tk.make_cache(CFG, B, T, torch.bfloat16, dev, quantized=kv_quant)
    if kv_quant:
        cache.k.copy_(torch.randint(-127, 128, cache.k.shape, generator=g, device=dev))
        cache.v.copy_(torch.randint(-127, 128, cache.v.shape, generator=g, device=dev))
        cache.ks.copy_(torch.rand(cache.ks.shape, generator=g, device=dev).mul(0.02))
        cache.vs.copy_(torch.rand(cache.vs.shape, generator=g, device=dev).mul(0.01))
    else:
        cache.k.copy_(torch.randn(cache.k.shape, generator=g, device=dev))
        cache.v.copy_(torch.randn(cache.v.shape, generator=g, device=dev).mul(0.5))
    offs = torch.randint(T // 4, T - 1, (B,), generator=g, device=dev, dtype=torch.int32)
    x = torch.randn(B, 1, 256, generator=g, device=dev).mul(0.2).bfloat16()
    rope = mrope_cos_sin(torch.arange(T, device=dev)[None], 128, CFG.rope_theta,
                         CFG.mrope_section, torch.bfloat16)
    cos, sin = rope[0][0][offs.long()], rope[1][0][offs.long()]
    V = CFG.vocab_size
    supp = torch.zeros(V, device=dev)
    supp[V - 1024:] = -1e30
    seen = torch.rand(B, V, generator=g, device=dev) < 0.01
    return x, cache, offs, cos, sin, supp, seen


def _clone(cache):
    return type(cache)(*(a.clone() for a in cache))


def _differing_rows(a, b):
    """The rows (first index) where two code tensors differ, read back once."""
    ne = (a.reshape(a.shape[0], -1) != b.reshape(b.shape[0], -1)).any(1)
    return ne.nonzero().flatten().tolist()


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("B", [2, 5, 8, 17, 33, 64, 65, 128, 255, 256])
def test_k1_batched_matches_plain(dev, weights, B, kv_quant):
    """K1 at B rows and ragged offsets, both modes, against its plain
    version: hidden, logits and the new k/v rows within the bf16 bound,
    greedy code0 equal but for near-ties, one launch per call."""
    tp, _ = weights
    T = 512 if kv_quant else 128
    x, cache, offs, cos, sin, supp, seen = _batched_case(dev, B, T, kv_quant, seed=B)
    kw = dict(temperature=0.0, top_k=50, rep_penalty=1.05, eos_id=-1, seed=(1, 2),
              suppress_add=supp, seen=seen, return_logits=True)
    ck, cr = _clone(cache), _clone(cache)
    before = tkk.talker_decode_step.launches
    hk, codek, lk = tkk.talker_decode_step(tp, CFG, x, ck, offs, cos, sin, **kw)
    assert tkk.talker_decode_step.launches == before + 1
    hr, coder, lr = tkk.talker_decode_step_ref(tp, CFG, x, cr, offs, cos, sin, **kw)
    assert hk.shape == (B, 256) and codek.shape == (B,) and lk.shape == (B, CFG.vocab_size)
    assert scaled(hk, hr) < 0.05 and scaled(lk, lr) < 0.05
    rows, pos = torch.arange(B, device=dev), offs.long()
    for i in range(2):  # k, then v: the new rows (dequantized for an int8 cache)
        new_a, new_b = ck[i][:, rows, :, pos], cr[i][:, rows, :, pos]
        if kv_quant:
            new_a = tk.dequantize_kv(new_a, ck[2 + i][:, rows, :, pos])
            new_b = tk.dequantize_kv(new_b, cr[2 + i][:, rows, :, pos])
        assert scaled(new_a, new_b) < 0.05
    err = float((lk - lr).abs().max())
    z = _pen(lr, seen) + supp
    for b in _differing_rows(codek, coder):
        a_, b_ = int(codek[b]), int(coder[b])
        assert abs(float(z[b, a_] - z[b, b_])) <= 2 * err + 1e-6, b
    hn = tkk.talker_decode_step(tp, CFG, x, _clone(cache), offs, cos, sin, sample=False)
    hn_r = tkk.talker_decode_step_ref(tp, CFG, x, _clone(cache), offs, cos, sin, sample=False)
    assert scaled(hn, hn_r) < 0.05 and torch.equal(hn, hk)


@pytest.mark.parametrize("B", [5, 64, 256])
def test_k1_int8_rows_written_bit_equal(dev, weights, B):
    """Layer 0's new k/v rows depend on x alone: the rows and scales that the
    int8 step writes in place equal quantize_kv_rows of the rows that the
    bf16 step writes, bit for bit."""
    tp, _ = weights
    x, cq, offs, cos, sin, _, _ = _batched_case(dev, B, 512, True, seed=3)
    cb = tk.make_cache(CFG, B, 512, torch.bfloat16, dev)
    tkk.talker_decode_step(tp, CFG, x, cq, offs, cos, sin, sample=False)
    tkk.talker_decode_step(tp, CFG, x, cb, offs, cos, sin, sample=False)
    rows, pos = torch.arange(B, device=dev), offs.long()
    for qc, sc, bc in ((cq.k, cq.ks, cb.k), (cq.v, cq.vs, cb.v)):
        q_ref, s_ref = tk.quantize_kv_rows(bc[0, rows, :, pos])
        assert torch.equal(qc[0, rows, :, pos], q_ref)
        assert torch.equal(sc[0, rows, :, pos], s_ref)


@pytest.mark.parametrize("B", [2, 3, 8, 17, 33, 48, 64, 65, 128, 255, 256])
def test_k2_batched_matches_plain(dev, weights, B):
    tp, cp = weights
    g = torch.Generator(device=dev).manual_seed(B)
    h = torch.randn(B, 256, generator=g, device=dev).mul(0.3).bfloat16()
    code0 = torch.randint(0, 2048, (B,), generator=g, device=dev, dtype=torch.int32)
    cr, er, lr = cpk.predict_codes_fused_ref(cp, CPC, tp, h, code0, (5, 6), temperature=0.0,
                                             top_k=50, return_logits=True)
    before = cpk.predict_codes_fused.launches
    ck, ek, lk = cpk.predict_codes_fused(cp, CPC, tp, h, code0, (5, 6), temperature=0.0,
                                         top_k=50, force_codes=cr, return_logits=True)
    assert cpk.predict_codes_fused.launches == before + 1
    assert ck.shape == (B, 15) and lk.shape == (15, B, CPC.vocab_size)
    assert scaled(lk, lr) < 0.05
    assert torch.equal(ek, er)  # the same bf16 rows summed in f32 in the same order
    err = float((lk - lr).abs().max())
    for b in _differing_rows(ck, cr):
        for j in range(15):
            a, c = int(ck[b, j]), int(cr[b, j])
            assert a == c or abs(float(lr[j, b, a] - lr[j, b, c])) <= 2 * err, (b, j)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_generate_codes_batch_runs_on_the_kernels(dev, weights, kv_quant):
    """B=6 lockstep decode: K1 once per lockstep frame after the first, K2
    once per frame, and one host sync per lockstep frame (plus the suppress
    mask's copy per chunk and the stream synchronisation that ends the
    chunk's turn, ``generate.device_turn``)."""
    tp, cp = weights
    B = 6
    g = torch.Generator(device=dev).manual_seed(7)
    sampling = gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True)
    common = dict(talker_cfg=CFG, cp_cfg=CPC, sampling=sampling,
                  trailing_embeds=torch.zeros(B, 16, 256, dtype=torch.bfloat16, device=dev),
                  trailing_lens=torch.full((B,), 4, dtype=torch.int32, device=dev),
                  tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev))
    n1, n2 = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
    carry = bg.prefill_start_batch(
        tp, cp, **common, prefill_embeds=torch.randn(B, 64, 256, generator=g, device=dev).mul(0.1).bfloat16(),
        prefill_lens=torch.tensor([20, 33, 9, 64, 40, 12], dtype=torch.int32, device=dev),
        cache=tk.make_cache(CFG, B, 256, device=dev, quantized=kv_quant), max_frames=16, seed=3)
    assert cpk.predict_codes_fused.launches - n2 == 1
    caps = torch.tensor([9, 12, 12, 5, 12, 12], dtype=torch.int32, device=dev)
    carry, syncs = _count_syncs(lambda: bg.generate_chunk_batch(
        tp, cp, carry, **common, max_steps=caps, until_step=10))
    assert carry.step == 10
    assert tkk.talker_decode_step.launches - n1 == 9
    assert cpk.predict_codes_fused.launches - n2 == 10
    assert syncs == 9 + 2, syncs
    assert carry.frames.tolist() == [9, 10, 10, 5, 10, 10]
    codes = carry.codes.cpu()
    assert (codes[:, :, 0] < 2048).all() and (codes[:, :, 1:] < CPC.vocab_size).all()


@pytest.mark.parametrize("case", ["257 rows", "f32 activations", "lockstep of 257"])
def test_step_the_kernels_do_not_take_raises(dev, weights, case):
    """No plain loop on the card for fused int8 weights: a batched step of
    257 rows (past MAX_BATCH) or of f32 activations raises in K1, and a
    lockstep decode of 257 rows raises before its prefill."""
    tp, cp = weights
    B = 3 if case == "f32 activations" else tkk.MAX_BATCH + 1
    x = torch.zeros(B, 1, 256, device=dev,
                    dtype=torch.float32 if case == "f32 activations" else torch.bfloat16)
    cache = tk.make_cache(CFG, B, 128, torch.bfloat16, dev)
    offs = torch.full((B,), 4, dtype=torch.int32, device=dev)
    n1 = tkk.talker_decode_step.launches
    if case == "lockstep of 257":
        with pytest.raises(ValueError, match="K1 and K2"):
            bg.prefill_start_batch(
                tp, cp, talker_cfg=CFG, cp_cfg=CPC, sampling=gen.SamplingConfig(),
                prefill_embeds=torch.zeros(B, 64, 256, dtype=torch.bfloat16, device=dev),
                prefill_lens=torch.full((B,), 8, dtype=torch.int32, device=dev),
                trailing_embeds=torch.zeros(B, 16, 256, dtype=torch.bfloat16, device=dev),
                trailing_lens=torch.full((B,), 4, dtype=torch.int32, device=dev),
                tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev),
                cache=cache, max_frames=16, seed=0)
    else:
        with pytest.raises(ValueError, match="talker_decode_step"):
            tk.forward_batched_step(tp, CFG, x, cache, offs)
    assert tkk.talker_decode_step.launches == n1
    assert not cache.k.any()  # nothing ran


CPC_N = C.CodePredictorConfig(  # narrower than the talker: the 1.7B shape, with the projection
    vocab_size=512, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
    num_attention_heads=16, num_key_value_heads=8, head_dim=128,
)


def _fused(tree, head=None):
    tree["layers"] = tk.fuse_layer_projections(tree["layers"])
    return tree if head is None else quantize_decode_params_int8(tree, head)


@pytest.fixture(scope="module")
def bf16_weights(dev):
    """Dense bf16 fused talker and CP, and the narrow CP (with its
    projection) in both weight modes."""
    tp = _fused(hi.to_device(hi.host_init_talker_params(0, CFG), torch.bfloat16, dev))
    cp = _fused(hi.to_device(hi.host_init_cp_params(1, CPC, 256), torch.bfloat16, dev))
    narrow = {
        mode: _fused(hi.to_device(hi.host_init_cp_params(2, CPC_N, 256), torch.bfloat16, dev),
                     "lm_head" if mode == "int8" else None)
        for mode in ("int8", "bf16")
    }
    return tp, cp, narrow


@pytest.mark.parametrize("B,kv_quant", [
    (1, False), (5, True), (64, False), (2, True), (8, False), (17, True), (33, False), (64, True),
    (65, False), (128, True), (255, False), (256, True), (256, False),
])
def test_k1_bf16_matches_plain(dev, bf16_weights, B, kv_quant):
    """K1 on dense bf16 weights against its plain version: hidden, logits
    and the new k/v rows within the bf16 bound, greedy code0 equal but for
    near-ties, one launch per call; the int-offset form at B=1."""
    tp = bf16_weights[0]
    assert tkk._layout(tp["layers"]) == "bf16"
    T = 512 if kv_quant else 128
    x, cache, offs, cos, sin, supp, seen = _batched_case(dev, B, T, kv_quant, seed=B + 1)
    off = int(offs[0]) if B == 1 else offs
    if B == 1:
        cos, sin, seen = cos[0], sin[0], seen[0]
    kw = dict(temperature=0.0, top_k=50, rep_penalty=1.05, eos_id=-1, seed=(1, 2),
              suppress_add=supp, seen=seen, return_logits=True)
    ck, cr = _clone(cache), _clone(cache)
    before = tkk.talker_decode_step.launches
    hk, codek, lk = tkk.talker_decode_step(tp, CFG, x, ck, off, cos, sin, **kw)
    assert tkk.talker_decode_step.launches == before + 1
    hr, coder, lr = tkk.talker_decode_step_ref(tp, CFG, x, cr, off, cos, sin, **kw)
    assert scaled(hk, hr) < 0.05 and scaled(lk, lr) < 0.05
    rows, pos = torch.arange(B, device=dev), offs.long()
    for i in range(2):
        new_a, new_b = ck[i][:, rows, :, pos], cr[i][:, rows, :, pos]
        if kv_quant:
            new_a = tk.dequantize_kv(new_a, ck[2 + i][:, rows, :, pos])
            new_b = tk.dequantize_kv(new_b, cr[2 + i][:, rows, :, pos])
        assert scaled(new_a, new_b) < 0.05
    err = float((lk - lr).abs().max())
    z = (_pen(lr, seen) + supp).reshape(B, -1)
    for b in _differing_rows(codek.reshape(B), coder.reshape(B)):
        a_, b_ = int(codek.reshape(-1)[b]), int(coder.reshape(-1)[b])
        assert abs(float(z[b, a_] - z[b, b_])) <= 2 * err + 1e-6, b


@pytest.mark.parametrize("mode,narrow,B", [
    ("bf16", False, 3), ("bf16", True, 1), ("int8", True, 64), ("bf16", False, 1), ("int8", True, 1),
    ("bf16", False, 2), ("bf16", False, 8), ("bf16", False, 17), ("bf16", False, 33),
    ("bf16", False, 48), ("bf16", False, 64), ("bf16", True, 17), ("bf16", True, 64),
    ("int8", True, 2), ("int8", True, 33), ("bf16", False, 65), ("bf16", False, 128),
    ("bf16", False, 255), ("bf16", False, 256), ("bf16", True, 128), ("bf16", True, 256),
    ("int8", True, 65), ("int8", True, 256),
])
def test_k2_bf16_and_projection_match_plain(dev, bf16_weights, mode, narrow, B):
    """K2 on dense bf16 layers and heads, and with the small-to-MTP
    projection in both weight modes, against its plain version:
    teacher-forced greedy logits within the bf16 bound, codes equal but for
    near-ties, esum (talker width) bit-equal."""
    tp, cp, narrow_cp = bf16_weights
    cpc, cpp = (CPC_N, narrow_cp[mode]) if narrow else (CPC, cp)
    assert ("small_to_mtp_projection" in cpp) == narrow
    g = torch.Generator(device=dev).manual_seed(B)
    h = torch.randn(B, 256, generator=g, device=dev).mul(0.3).bfloat16()
    code0 = torch.randint(0, 2048, (B,), generator=g, device=dev, dtype=torch.int32)
    cr, er, lr = cpk.predict_codes_fused_ref(cpp, cpc, tp, h, code0, (5, 6), temperature=0.0,
                                             top_k=50, return_logits=True)
    before = cpk.predict_codes_fused.launches
    ck, ek, lk = cpk.predict_codes_fused(cpp, cpc, tp, h, code0, (5, 6), temperature=0.0,
                                         top_k=50, force_codes=cr, return_logits=True)
    assert cpk.predict_codes_fused.launches == before + 1
    assert ek.shape == (B, 256) and scaled(lk, lr) < 0.05
    assert torch.equal(ek, er)  # the same bf16 rows summed in f32 in the same order
    err = float((lk - lr).abs().max())
    lr, ck, cr = lr.reshape(15, B, -1), ck.reshape(B, 15), cr.reshape(B, 15)
    for b in _differing_rows(ck, cr):
        for j in range(15):
            a, c = int(ck[b, j]), int(cr[b, j])
            assert a == c or abs(float(lr[j, b, a] - lr[j, b, c])) <= 2 * err, (b, j)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_generate_codes_with_projection_runs_on_the_kernels(dev, weights, bf16_weights, mode):
    """The narrow CP behind the talker, in each weight mode: K1 once per
    frame after the first, K2 once per frame; no plain CP loop."""
    tp = weights[0] if mode == "int8" else bf16_weights[0]
    cpp = bf16_weights[2][mode]
    assert gen._use_cp_kernel(cpp, CPC_N, CFG, gen.SamplingConfig(), dev)
    g = torch.Generator(device=dev).manual_seed(6)
    n1, n2 = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
    res = gen.generate_codes(
        tp, cpp, talker_cfg=CFG, cp_cfg=CPC_N,
        sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True),
        prefill_embeds=torch.randn(1, 64, 256, generator=g, device=dev).mul(0.1).bfloat16(),
        prefill_len=20, trailing_embeds=torch.zeros(16, 256, dtype=torch.bfloat16, device=dev),
        trailing_len=4, tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev),
        max_steps=8, max_frames=8, seed=3, cache_len=128,
    )
    assert res.n_frames == 8
    assert tkk.talker_decode_step.launches - n1 == 7
    assert cpk.predict_codes_fused.launches - n2 == 8
    codes = res.codes.cpu()
    assert (codes[:, 0] < 2048).all() and (codes[:, 1:] < CPC_N.vocab_size).all()


# --- dyn_int8 (per-row int8 activations, s8 x s8 -> s32), unfused K2, K5 ---


def _unfused_int8_cp(dev, cpc=CPC, seed=1):
    cp = hi.to_device(hi.host_init_cp_params(seed, cpc, CFG.hidden_size), torch.bfloat16, dev)
    return quantize_decode_params_int8(cp, "lm_head")


@pytest.mark.parametrize("B,kv_quant", [
    (1, False), (5, True), (64, False), (64, True), (2, False), (8, True), (17, False), (33, True),
    (65, True), (128, False), (255, True), (256, False), (256, True),
])
def test_k1_dyn_int8_matches_plain(dev, weights, B, kv_quant):
    """K1 in dyn_int8 against its plain version: hidden, logits and the new
    k/v rows within the bf16 bound, greedy code0 equal but for near-ties,
    the non-sample hidden equal to the sample-mode one; one launch per call,
    counted under dyn_int8; the int-offset form at B=1."""
    tp, _ = weights
    T = 512 if kv_quant else 128
    x, cache, offs, cos, sin, supp, seen = _batched_case(dev, B, T, kv_quant, seed=B + 7)
    off = int(offs[0]) if B == 1 else offs
    if B == 1:
        cos, sin, seen = cos[0], sin[0], seen[0]
    kw = dict(temperature=0.0, top_k=50, rep_penalty=1.05, eos_id=-1, seed=(1, 2),
              suppress_add=supp, seen=seen, return_logits=True, mode="dyn_int8")
    ck, cr = _clone(cache), _clone(cache)
    before = dict(tkk.talker_decode_step.mode_launches)
    hk, codek, lk = tkk.talker_decode_step(tp, CFG, x, ck, off, cos, sin, **kw)
    assert tkk.talker_decode_step.mode_launches["dyn_int8"] == before["dyn_int8"] + 1
    assert tkk.talker_decode_step.mode_launches["wo_bf16"] == before["wo_bf16"]
    hr, coder, lr = tkk.talker_decode_step_ref(tp, CFG, x, cr, off, cos, sin, **kw)
    assert scaled(hk, hr) < 0.05 and scaled(lk, lr) < 0.05
    rows, pos = torch.arange(B, device=dev), offs.long()
    for i in range(2):
        new_a, new_b = ck[i][:, rows, :, pos], cr[i][:, rows, :, pos]
        if kv_quant:
            new_a = tk.dequantize_kv(new_a, ck[2 + i][:, rows, :, pos])
            new_b = tk.dequantize_kv(new_b, cr[2 + i][:, rows, :, pos])
        assert scaled(new_a, new_b) < 0.05
    err = float((lk - lr).abs().max())
    z = (_pen(lr, seen) + supp).reshape(B, -1)
    for b in _differing_rows(codek.reshape(B), coder.reshape(B)):
        a_, b_ = int(codek.reshape(-1)[b]), int(coder.reshape(-1)[b])
        assert abs(float(z[b, a_] - z[b, b_])) <= 2 * err + 1e-6, b
    hn = tkk.talker_decode_step(tp, CFG, x, _clone(cache), off, cos, sin, sample=False,
                                mode="dyn_int8")
    assert torch.equal(hn, hk)


def _k2_check(cpc, cpp, tp, dev, B, mode, fn=None):
    """K2 (or ``fn``, K5) teacher-forced greedy against the plain version:
    logits within the bf16 bound, codes equal but for near-ties, esum
    bit-equal."""
    fn = fn or cpk.predict_codes_fused
    g = torch.Generator(device=dev).manual_seed(B)
    h = torch.randn(B, CFG.hidden_size, generator=g, device=dev).mul(0.3).bfloat16()
    code0 = torch.randint(0, 2048, (B,), generator=g, device=dev, dtype=torch.int32)
    cr, er, lr = cpk.predict_codes_fused_ref(cpp, cpc, tp, h, code0, (5, 6), temperature=0.0,
                                             top_k=50, return_logits=True, mode=mode)
    before = fn.launches
    ck, ek, lk = fn(cpp, cpc, tp, h, code0, (5, 6), temperature=0.0, top_k=50, force_codes=cr,
                    return_logits=True, mode=mode)
    assert fn.launches == before + 1
    assert scaled(lk, lr) < 0.05
    assert torch.equal(ek, er)  # the same bf16 rows summed in f32 in the same order
    err = float((lk - lr).abs().max())
    lr, ck, cr = lr.reshape(15, B, -1), ck.reshape(B, 15), cr.reshape(B, 15)
    for b in _differing_rows(ck, cr):
        for j in range(15):
            a, c = int(ck[b, j]), int(cr[b, j])
            assert a == c or abs(float(lr[j, b, a] - lr[j, b, c])) <= 2 * err, (b, j)


@pytest.mark.parametrize("mode,layers,B", [
    ("dyn_int8", "fused", 3), ("dyn_int8", "fused", 64), ("wo_bf16", "unfused", 1),
    ("dyn_int8", "unfused", 1), ("wo_bf16", "unfused", 64), ("dyn_int8", "unfused", 64),
    ("dyn_int8", "projection", 1), ("dyn_int8", "fused", 1),
    ("dyn_int8", "fused", 2), ("dyn_int8", "fused", 8), ("dyn_int8", "fused", 17),
    ("dyn_int8", "fused", 33), ("dyn_int8", "fused", 48), ("wo_bf16", "unfused", 17),
    ("dyn_int8", "unfused", 33), ("dyn_int8", "projection", 17), ("dyn_int8", "projection", 64),
    ("dyn_int8", "fused", 65), ("dyn_int8", "fused", 128), ("dyn_int8", "fused", 255),
    ("dyn_int8", "fused", 256), ("wo_bf16", "unfused", 128), ("wo_bf16", "unfused", 256),
    ("dyn_int8", "unfused", 256), ("dyn_int8", "projection", 256),
])
def test_k2_dyn_int8_and_unfused_match_plain(dev, weights, bf16_weights, mode, layers, B):
    """K2 in dyn_int8 (fused, unfused, and with the bf16 small-to-MTP
    projection, which stays a bf16 GEMV), and on unfused int8 layers in
    both modes, against its plain version; counted under its mode."""
    tp, cp = weights
    cpc, cpp = CPC, cp
    if layers == "unfused":
        cpp = _unfused_int8_cp(dev)
        assert "q_proj" in cpp["layers"] and cpk.kernel_supported(cpp, CPC, 256, B)
    elif layers == "projection":
        cpc, cpp = CPC_N, bf16_weights[2]["int8"]
    before = cpk.predict_codes_fused.mode_launches[mode]
    _k2_check(cpc, cpp, tp, dev, B, mode)
    assert cpk.predict_codes_fused.mode_launches[mode] == before + 1


# (I, O): the 0.6B CP's qkv, o, gate_up, down and head (the 0.6B talker
# layer has the same four shapes); the 1.7B talker layer's qkv, o, gate_up,
# down; the talker's V = 3072 codec head at 0.6B and 1.7B; a width of 272
# (not a multiple of 128 columns or of 32 rows: a half k32 step in dyn_int8)
GEMV_SHAPES = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 2048), (272, 272),
               (2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048), (1024, 3072),
               (2048, 3072)]


@pytest.mark.parametrize("mode", ["wo_bf16", "bf16", "dyn_int8"])
@pytest.mark.parametrize("B", [2, 8, 17, 33, 48, 64, 65, 128, 255, 256])
@pytest.mark.parametrize("I,O", GEMV_SHAPES)
def test_batched_gemv_tensor_cores_match_cuda_cores(dev, I, O, B, mode):
    """The batched GEMV of K1 and K2 alone in both forms (csrc/common.cuh),
    at K2's and K1's layer and head shapes: in dyn_int8
    the int32 partial sums of every split are bit-equal (integer sums are
    exact in any order); on int8 (wo_bf16) or bf16 weights both forms' f32
    sums lie within 1e-5 scaled of the float64 sum (the products are exact
    in f32; the sums are taken in other orders)."""
    g = torch.Generator(device=dev).manual_seed(B * 7 + I)
    x = torch.randn(B, I, generator=g, device=dev).mul(0.5).bfloat16()
    if mode == "bf16":
        w = torch.randn(I, O, generator=g, device=dev).mul(0.05).bfloat16()
    else:
        w = torch.randint(-127, 128, (I, O), generator=g, device=dev, dtype=torch.int8)
    amax = x.float().abs().amax(1) if mode == "dyn_int8" else None
    before = cpk.batched_gemv.launches
    tc = cpk.batched_gemv(x, w, amax)
    cc = cpk.batched_gemv(x, w, amax, tensor_cores=False)
    assert cpk.batched_gemv.launches == before + 2
    assert tc.shape == cc.shape and tc.shape[1:] == (B, O)
    ref = cpk.batched_gemv_ref(x.cpu(), w.cpu(), None if amax is None else amax.cpu())
    if mode == "dyn_int8":
        assert tc.dtype == torch.int32 and torch.equal(tc, cc)
        assert torch.equal(tc.sum(0, dtype=torch.int32).cpu(), ref)
    else:
        ref64 = x.cpu().double() @ w.cpu().double()
        for part in (tc, cc):
            assert scaled(part.sum(0).cpu().double(), ref64) <= 1e-5


@pytest.mark.parametrize("mode", ["wo_bf16", "dyn_int8"])
def test_k5_launches_the_cp_kernel(dev, weights, mode):
    """ops/cp_kernel_old.py (K5's port) launches K2's CUDA kernel, counted
    by its own counter, and matches the plain version."""
    from qwen3tts_tpu_torch.ops import cp_kernel_old as cpk_old

    tp, cp = weights
    assert cpk_old.kernel_supported(cp, CPC, 256)
    n2 = cpk.predict_codes_fused.launches
    _k2_check(CPC, cp, tp, dev, 1, mode, fn=cpk_old.predict_codes_fused)
    assert cpk.predict_codes_fused.launches == n2  # counted as K5's, not K2's


@pytest.mark.parametrize("mode", ["wo_bf16", "dyn_int8"])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K2 B=3"])
def test_library_launches_per_call(dev, weights, kernel, mode):
    """The operations one call enqueues, as the library counts them: K1 at
    B = 1 = the memset of the persistent step's barrier words + its one
    launch (the multi-launch step made 8 L + 3); K2 at B = 1 = the memset of
    the persistent frame's barrier words + its one launch; K2 at B > 1 = the
    esum memset + (rms_copy + 8 per layer) per position + (head GEMV +
    sampler) per code. dyn_int8 adds none (each row's amax comes from the
    kernel writing it, or from the block itself in the persistent frame)."""
    from qwen3tts_tpu_torch.ops import _cuda

    tp, cp = weights
    if kernel == "K1":
        case = _k1_case(dev, tp, 70, 128, False)
        call = lambda: _k1(tkk.talker_decode_step, tp, case, 70, temperature=0.9, mode=mode)
        expect = 2
    else:
        B = 1 if kernel == "K2" else 3
        g = torch.Generator(device=dev).manual_seed(2)
        h = torch.randn(B, CFG.hidden_size, generator=g, device=dev).mul(0.3).bfloat16()
        code0 = torch.full((B,), 5, dtype=torch.int32, device=dev)
        call = lambda: cpk.predict_codes_fused(cp, CPC, tp, h, code0, (5, 6), temperature=0.9,
                                               top_k=50, mode=mode)
        ncb = CPC.num_code_groups - 1
        expect = 2 if B == 1 else 1 + (ncb + 1) * (1 + 8 * CPC.num_hidden_layers) + 2 * ncb
    call()
    torch.cuda.synchronize()
    n0 = _cuda.launches()
    call()
    assert _cuda.launches() - n0 == expect


def _k2_b1_cases(dev, weights, bf16_weights):
    """(name, cp config, cp tree, mode, top_p) of every mode K2 takes at B = 1"""
    tp, cp = weights
    _, cp_bf16, narrow = bf16_weights
    unfused = _unfused_int8_cp(dev)
    return [
        ("int8 fused", CPC, cp, "wo_bf16", 1.0), ("int8 fused dyn", CPC, cp, "dyn_int8", 1.0),
        ("int8 unfused", CPC, unfused, "wo_bf16", 1.0),
        ("int8 unfused dyn", CPC, unfused, "dyn_int8", 1.0),
        ("bf16", CPC, cp_bf16, "wo_bf16", 1.0),
        ("projection int8", CPC_N, narrow["int8"], "wo_bf16", 1.0),
        ("projection int8 dyn", CPC_N, narrow["int8"], "dyn_int8", 1.0),
        ("projection bf16", CPC_N, narrow["bf16"], "wo_bf16", 1.0),
        ("top-p", CPC, cp, "wo_bf16", 0.8),
    ]


@pytest.mark.parametrize("k5", [False, True])
def test_k2_b1_is_two_operations_in_every_mode(dev, weights, bf16_weights, k5):
    """Every B = 1 call of K2 (and of K5's port), greedy or sampled, with
    forced codes and logits or without, in every weight mode: two operations
    by the library's count (the barrier words' memset and the persistent
    launch)."""
    from qwen3tts_tpu_torch.ops import _cuda
    from qwen3tts_tpu_torch.ops import cp_kernel_old as cpk_old

    tp = weights[0]
    fn = cpk_old.predict_codes_fused if k5 else cpk.predict_codes_fused
    h = torch.randn(1, CFG.hidden_size, device=dev).mul(0.3).bfloat16()
    code0 = torch.tensor([9], dtype=torch.int32, device=dev)
    force = torch.arange(15, dtype=torch.int32, device=dev).reshape(1, 15)
    for name, cpc, cpp, mode, top_p in _k2_b1_cases(dev, weights, bf16_weights):
        for kw in (dict(temperature=0.0, force_codes=force, return_logits=True),
                   dict(temperature=0.9)):
            fn(cpp, cpc, tp, h, code0, (1, 2), top_k=50, top_p=top_p, mode=mode, **kw)
            torch.cuda.synchronize()
            n0 = _cuda.launches()
            fn(cpp, cpc, tp, h, code0, (1, 2), top_k=50, top_p=top_p, mode=mode, **kw)
            assert _cuda.launches() - n0 == 2, (name, kw)


def test_k2_b1_back_to_back_calls_are_bit_equal(dev, weights):
    """200 greedy K2 calls at B = 1 on the same inputs, back to back with no
    synchronisation between them: codes, esum and logits bit-equal to the
    first call's (a race at a grid barrier of the persistent frame would
    show as a difference)."""
    tp, cp = weights
    g = torch.Generator(device=dev).manual_seed(4)
    h = torch.randn(1, CFG.hidden_size, generator=g, device=dev).mul(0.3).bfloat16()
    code0 = torch.tensor([21], dtype=torch.int32, device=dev)
    outs = [cpk.predict_codes_fused(cp, CPC, tp, h, code0, (5, 6), temperature=0.0, top_k=50,
                                    return_logits=True) for _ in range(200)]
    torch.cuda.synchronize()
    cpk.check_barrier(dev)
    for c, e, lg in outs[1:]:
        assert torch.equal(c, outs[0][0]) and torch.equal(e, outs[0][1])
        assert torch.equal(lg, outs[0][2])


def test_k2_b1_grid_and_barrier_faults_raise(dev, weights):
    """The persistent frame takes no other path: a grid that cannot be
    resident raises before anything is enqueued, and a barrier budget of
    1 ns times out at the first wait: the faulted call's codes are all -1,
    and it raises at ``check_barrier`` (after a synchronisation), at the
    decode loops' check (which synchronises first) and at the next call; a
    call after that runs and matches the plain version."""
    tp, cp = weights
    h = torch.randn(1, CFG.hidden_size, device=dev).mul(0.3).bfloat16()
    code0 = torch.tensor([3], dtype=torch.int32, device=dev)
    kw = dict(temperature=0.0, top_k=50, top_p=1.0, ref_exact_top_p=False, force_codes=None,
              return_logits=True, dyn=False)
    n = cpk.predict_codes_fused.launches
    with pytest.raises(cpk.CoResidencyError):
        cpk.launch(cp, CPC, tp, h, code0, (5, 6), blocks=100_000, **kw)
    faulted = cpk.launch(cp, CPC, tp, h, code0, (5, 6), budget_ns=1, **kw)[0]
    torch.cuda.synchronize()
    assert torch.equal(faulted, torch.full_like(faulted, -1))
    with pytest.raises(cpk.BarrierTimeout, match="K2 persistent barrier timed out"):
        cpk.check_barrier(dev)
    cpk.launch(cp, CPC, tp, h, code0, (5, 6), budget_ns=1, **kw)
    with pytest.raises(cpk.BarrierTimeout):
        gen.check_cp_frames(dev, sync=True)
    cpk.launch(cp, CPC, tp, h, code0, (5, 6), budget_ns=1, **kw)
    torch.cuda.synchronize()
    with pytest.raises(cpk.BarrierTimeout):
        cpk.launch(cp, CPC, tp, h, code0, (5, 6), **kw)
    assert cpk.predict_codes_fused.launches == n  # the entry point's count is not touched
    cr, er, lr = cpk.predict_codes_fused_ref(cp, CPC, tp, h, code0, (5, 6), temperature=0.0,
                                             top_k=50, return_logits=True)
    ck, ek, lk = cpk.predict_codes_fused(cp, CPC, tp, h, code0, (5, 6), temperature=0.0,
                                         top_k=50, force_codes=cr, return_logits=True)
    torch.cuda.synchronize()
    cpk.check_barrier(dev)
    assert scaled(lk, lr) < 0.05 and torch.equal(ek, er)


def test_generate_raises_on_a_faulted_frame(dev, weights, monkeypatch):
    """``generate_codes`` whose B = 1 K2 frames time out at a barrier (every
    launch given a 1 ns budget) raises ``BarrierTimeout`` at the next
    frame's host synchronisation; it returns no codes."""
    import functools

    tp, cp = weights
    monkeypatch.setattr(cpk, "launch", functools.partial(cpk.launch, budget_ns=1))
    g = torch.Generator(device=dev).manual_seed(2)
    with pytest.raises(cpk.BarrierTimeout, match="K2 persistent barrier timed out"):
        gen.generate_codes(
            tp, cp, talker_cfg=CFG, cp_cfg=CPC,
            sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True),
            prefill_embeds=torch.randn(1, 64, 256, generator=g, device=dev).mul(0.1).bfloat16(),
            prefill_len=20, trailing_embeds=torch.zeros(16, 256, dtype=torch.bfloat16, device=dev),
            trailing_len=4, tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev),
            max_steps=4, max_frames=8, seed=3, cache_len=128,
        )
    cpk.check_barrier(dev)  # the flag was cleared by the raise


CPC_V = dataclasses.replace(CPC, vocab_size=4096)


@pytest.fixture(scope="module")
def wide_vocab_cp(dev):
    """An int8 CP of CPC's widths with a vocabulary of 4096, the multi-launch
    sampler's limit (8 ids a thread of the persistent frame's sampler)."""
    cp = hi.to_device(hi.host_init_cp_params(3, CPC_V, CFG.hidden_size), torch.bfloat16, dev)
    cp["layers"] = tk.fuse_layer_projections(cp["layers"])
    return quantize_decode_params_int8(cp, "lm_head")


@pytest.mark.parametrize("mode", ["wo_bf16", "dyn_int8"])
def test_k2_b1_takes_a_4096_vocabulary(dev, weights, wide_vocab_cp, mode):
    """K2 at B = 1 on a vocabulary of 4096: greedy and teacher-forced against
    its plain version (``_k2_check``), then sampled with top-k 0 and top-p
    0.8 against ``sample_row`` on the kernel's own logits."""
    tp = weights[0]
    assert cpk.kernel_supported(wide_vocab_cp, CPC_V, CFG.hidden_size, 1)
    _k2_check(CPC_V, wide_vocab_cp, tp, dev, 1, mode)
    g = torch.Generator(device=dev).manual_seed(6)
    h = torch.randn(1, CFG.hidden_size, generator=g, device=dev).mul(0.3).bfloat16()
    code0 = torch.tensor([33], dtype=torch.int32, device=dev)
    codes, _, logits = cpk.predict_codes_fused(wide_vocab_cp, CPC_V, tp, h, code0, (7, 8),
                                               temperature=0.9, top_k=0, top_p=0.8,
                                               return_logits=True, mode=mode)
    flips = 0
    for j in range(15):
        want = int(sample_row(logits[j], temperature=0.9, top_k=0, top_p=0.8, seed=(7, 8),
                              stream=j + 1))
        a = int(codes[0, j])
        if a != want:
            flips += 1
            assert _top_p_flip_ok(top_k_filter(logits[j], 0), 0.8, False, a, want)
    assert flips <= 1


@pytest.mark.parametrize("B", [2, 17, 33, 64, 65, 128, 256])
def test_tensor_core_split_of_the_widest_gemv(dev, B):
    """The tensor-core split at the 1.7B talker's gate_up (2048 x 12288):
    splits x B within TC_MAX_PARTS (the workspace K1 allocates) and every
    split but the last whole 128-row passes."""
    from qwen3tts_tpu_torch.ops import _cuda

    lib = _cuda.library()
    I, O = 2048, 12288
    splits, rows = lib.qt_cp_gemv_splits(B, I, O), lib.qt_cp_gemv_rows(B, I, O)
    assert splits * B <= _cuda.LIMITS["TC_MAX_PARTS"]
    assert splits == -(-I // rows) and rows % _cuda.LIMITS["BG_ROWS"] == 0
    assert splits * B * O <= tkk.workspace_floats(B, 4096, 6144, 2048, 3072)


@pytest.mark.parametrize("cp_layers", ["fused", "unfused"])
def test_generate_codes_dyn_int8_runs_on_the_kernels(dev, weights, monkeypatch, cp_layers):
    """QWEN3TTS_TK_MODE / QWEN3TTS_CPK_MODE = dyn_int8: K1 once per frame
    after the first and K2 once per frame, all in dyn_int8, on a fused and
    on an unfused int8 CP; the plain CP loop never runs."""
    tp, cp = weights
    if cp_layers == "unfused":
        cp = _unfused_int8_cp(dev)
    for var in ("QWEN3TTS_TK_MODE", "QWEN3TTS_CPK_MODE"):
        monkeypatch.setenv(var, "dyn_int8")

    def plain_cp(*a, **k):
        raise AssertionError("the plain CP loop ran")

    monkeypatch.setattr(gen.cp, "predict_codes", plain_cp)
    g = torch.Generator(device=dev).manual_seed(2)
    n1 = dict(tkk.talker_decode_step.mode_launches)
    n2 = dict(cpk.predict_codes_fused.mode_launches)
    res = gen.generate_codes(
        tp, cp, talker_cfg=CFG, cp_cfg=CPC,
        sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True),
        prefill_embeds=torch.randn(1, 64, 256, generator=g, device=dev).mul(0.1).bfloat16(),
        prefill_len=20, trailing_embeds=torch.zeros(16, 256, dtype=torch.bfloat16, device=dev),
        trailing_len=4, tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev),
        max_steps=10, max_frames=12, seed=3, cache_len=128,
    )
    assert res.n_frames == 10
    k1 = {m: tkk.talker_decode_step.mode_launches[m] - n1[m] for m in n1}
    k2 = {m: cpk.predict_codes_fused.mode_launches[m] - n2[m] for m in n2}
    assert k1 == {"wo_bf16": 0, "bf16": 0, "dyn_int8": 9}
    assert k2 == {"wo_bf16": 0, "bf16": 0, "dyn_int8": 10}
    codes = res.codes[:10].cpu()
    assert (codes[:, 0] < 2048).all() and (codes[:, 1:] < CPC.vocab_size).all()


# ---- the sampler's top-p stage (K1 sample mode, K2) ----

def _top_p_flip_ok(z, p, ref_exact, a, b) -> bool:
    """Codes a (kernel) and b (``sample_row`` on the kernel's own logits)
    differ only where the top-p cut fell within rounding of one of them:
    the cumulative mass at a or b within n_terms x 2^-23 (x the total mass)
    of the threshold (f32 sums in another association)."""
    cum = top_p_cum(z, ref_exact)
    n = int((z > NEG_BIG / 2).sum())
    tol = n * 2.0**-23 * max(1.0, float(cum.max()))
    thr = top_p_threshold(p)
    return min(abs(float(cum[a]) - thr), abs(float(cum[b]) - thr)) <= tol


@pytest.mark.parametrize("top_k", [50, 0])
@pytest.mark.parametrize("p,ref_exact", [(0.8, False), (0.95, True), (0.5, False)])
@pytest.mark.parametrize("B", [1, 5])
def test_k1_top_p_matches_sample_row(dev, weights, B, p, ref_exact, top_k):
    """K1's sampled code0 with top-p against ``sample_row`` (the plain
    sampler, top-p stage included) on the kernel's own logits, same seed
    and stream: equal but for a cut within rounding of the threshold."""
    tp, _ = weights
    x, cache, offs, cos, sin, supp, seen = _batched_case(dev, B, 128, False, seed=40 + B)
    off = int(offs[0]) if B == 1 else offs
    if B == 1:
        cos, sin, seen = cos[0], sin[0], seen[0]
    flips = 0
    for s in range(6):
        kw = dict(temperature=0.9, top_k=top_k, top_p=p, ref_exact_top_p=ref_exact,
                  rep_penalty=1.05, eos_id=-1, seed=(s, 11), suppress_add=supp, seen=seen,
                  return_logits=True)
        _, code, logits = tkk.talker_decode_step(tp, CFG, x, _clone(cache), off, cos, sin, **kw)
        code, logits, seen_b = code.reshape(B), logits.reshape(B, -1), seen.reshape(B, -1)
        for b in range(B):
            want = int(sample_row(logits[b], temperature=0.9, top_k=top_k, top_p=p,
                                  ref_exact_top_p=ref_exact, rep_penalty=1.05, seen=seen_b[b],
                                  suppress_add=supp, seed=(s, 11), stream=16 * b))
            if int(code[b]) != want:
                flips += 1
                z = top_k_filter(_pen(logits[b], seen_b[b]) + supp, top_k)
                assert _top_p_flip_ok(z, p, ref_exact, int(code[b]), want), (s, b)
    assert flips <= B  # a cut within rounding is rare


@pytest.mark.parametrize("top_k", [50, 0])
@pytest.mark.parametrize("p,ref_exact", [(0.8, False), (0.95, True)])
@pytest.mark.parametrize("B", [1, 3])
def test_k2_top_p_matches_sample_row(dev, weights, B, p, ref_exact, top_k):
    """K2's 15 sampled codes with top-p against ``sample_row`` on the
    kernel's own logits of each position (stream j + 1 + 16 b)."""
    tp, cp = weights
    g = torch.Generator(device=dev).manual_seed(B)
    h = torch.randn(B, CFG.hidden_size, generator=g, device=dev).mul(0.3).bfloat16()
    code0 = torch.randint(0, 2048, (B,), generator=g, device=dev, dtype=torch.int32)
    before = cpk.predict_codes_fused.launches
    codes, _, logits = cpk.predict_codes_fused(cp, CPC, tp, h, code0, (7, 8), temperature=0.9,
                                               top_k=top_k, top_p=p, ref_exact_top_p=ref_exact,
                                               return_logits=True)
    assert cpk.predict_codes_fused.launches == before + 1
    logits = logits.reshape(15, B, -1)
    flips = 0
    for b in range(B):
        for j in range(15):
            want = int(sample_row(logits[j, b], temperature=0.9, top_k=top_k, top_p=p,
                                  ref_exact_top_p=ref_exact, seed=(7, 8), stream=j + 1 + 16 * b))
            a = int(codes[b, j])
            if a != want:
                flips += 1
                assert _top_p_flip_ok(top_k_filter(logits[j, b], top_k), p, ref_exact, a, want)
    assert flips <= 1


@pytest.mark.parametrize("ref_exact", [False, True])
def test_generate_codes_top_p_runs_on_the_kernels(dev, weights, monkeypatch, ref_exact):
    """top_p < 1 (and ref_exact_top_p): K1 in sample mode once per frame
    after the first, K2 once per frame; the plain CP loop never runs and the
    plain sampler only for the first frame's code 0."""
    tp, cp = weights

    def plain_cp(*a, **k):
        raise AssertionError("the plain CP loop ran")

    calls = []
    real = gen.sample_token_inner
    monkeypatch.setattr(gen.cp, "predict_codes", plain_cp)
    monkeypatch.setattr(gen, "sample_token_inner", lambda *a, **k: calls.append(1) or real(*a, **k))
    g = torch.Generator(device=dev).manual_seed(2)
    n1, n2 = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
    res = gen.generate_codes(
        tp, cp, talker_cfg=CFG, cp_cfg=CPC,
        sampling=gen.SamplingConfig(0.9, 50, 0.9, 1.05, forbid_eos=True,
                                    ref_exact_top_p=ref_exact),
        prefill_embeds=torch.randn(1, 64, 256, generator=g, device=dev).mul(0.1).bfloat16(),
        prefill_len=20, trailing_embeds=torch.zeros(16, 256, dtype=torch.bfloat16, device=dev),
        trailing_len=4, tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev),
        max_steps=10, max_frames=12, seed=3, cache_len=128,
    )
    assert res.n_frames == 10 and len(calls) == 1
    assert tkk.talker_decode_step.launches - n1 == 9
    assert cpk.predict_codes_fused.launches - n2 == 10


# ---- the experiment kernels: T7, T6, T3 (qwen3tts_tpu_torch/tools) ----

@pytest.mark.parametrize("variant", ["dma4", "dma12", "dma1", "t6 form"])
def test_weight_stream_matches_plain(dev, weights, variant):
    """T7: h bit-equal on int8 operands, within a bf16 step with the f32
    rows (their tiles summed in another order); checksums exact."""
    from qwen3tts_tpu_torch.tools import exp_weight_stream as tws

    tp, _ = weights
    big, small = tws.talker_operands(tp)
    ops = {"dma4": big, "dma12": big + small, "dma1": [tws.merged(big)], "t6 form": big}[variant]
    form = 1 if variant == "t6 form" else 0
    x = torch.randn(2, 256, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev).bfloat16()
    before = tws.weight_stream.launches
    h, sums = tws.weight_stream(ops, x, form)
    assert tws.weight_stream.launches == before + 1
    hr, sums_r = tws.weight_stream_ref(ops, x, form)
    if variant == "dma12":
        assert float((h.float() - hr.float()).abs().max()) <= 2.0**-7 * float(hr.float().abs().max())
    else:
        assert torch.equal(h, hr)
    for s, sr in zip(sums, sums_r):
        assert s.dtype == sr.dtype and torch.equal(s, sr)


@pytest.mark.parametrize("part", ["full", "noattn", "nomlp", "dma"])
def test_variant_step_matches_plain(dev, weights, part):
    """T6: h before the final norm and the new k/v rows within the bf16
    bound (dma bit-equal), one launch per call."""
    from qwen3tts_tpu_torch.tools import exp_tk_b1_ablate as tab

    tp, _ = weights
    x, cache, offs, cos, sin, _, _ = _batched_case(dev, 1, 128, False, seed=77)
    pos = int(offs[0])
    ck, cr = _clone(cache), _clone(cache)
    before = tab.variant_step.launches
    hk, kk, vk = tab.variant_step(tp, CFG, x, ck, pos, cos[0], sin[0], part)
    assert tab.variant_step.launches == before + 1
    hr, kr, vr = tab.variant_step_ref(tp, CFG, x, cr, pos, cos[0], sin[0], part)
    if part == "dma":
        assert torch.equal(hk, hr) and not kk.any() and not vk.any()
    else:
        assert scaled(hk, hr) < 0.05 and scaled(kk, kr) < 0.05 and scaled(vk, vr) < 0.05
    assert torch.equal(ck.k[:, :, :, :pos], cache.k[:, :, :, :pos])


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("blk_rows", [64, 1024])
def test_colsum_matches_plain(dev, off, blk_rows):
    """T3: the column sums of a moved window, exact."""
    from qwen3tts_tpu_torch.tools import exp_hbm_peak as thp

    rows = 8192
    x = torch.randint(-128, 127, (rows + 1024, thp.COLS), dtype=torch.int8, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(blk_rows))
    before = thp.colsum.launches
    got = thp.colsum(x, off * blk_rows, rows, blk_rows)
    assert thp.colsum.launches == before + 1
    assert torch.equal(got, thp.colsum_ref(x, off * blk_rows, rows, blk_rows))
    assert torch.equal(got, x[off * blk_rows : off * blk_rows + rows].sum(0, dtype=torch.int32))


# ---- the experiment kernels: T1, T4, T5, T2 (qwen3tts_tpu_torch/tools) ----

T1_EDGES = [(form, m, w) for m in (1, 2, 8, 9, 16, 17, 64, 65, 128) for form in ("b", "c2")
            for w in (128, 384)]  # both K layouts (b: pre-transposed, c2: natural)


@pytest.mark.parametrize("form,m,w", [("a", None, None), ("b", None, None), ("c", None, None),
                                      ("c2", None, None), ("b", 40, 384)]
                         + T1_EDGES)
def test_attn_form_matches_plain(dev, form, m, w):
    """T1: out within 1e-3 scaled of the plain version (the same f32
    products summed in another order; a score that rounds the other way
    to bf16 moves its product by one bf16 step), one launch per call, and a
    second call on the same inputs bit-equal (the partials are summed in a
    fixed order). At the script's shapes, or (m, w) m rows against w keys
    of 2 batches, at the edges of the kernel's paths: 1-8 rows are one
    8-column mma.sync tile, 9-16 two, 17-128 wgmma's two warpgroups of 64
    rows (17-64 and 40 rows check its zero rows past M)."""
    from qwen3tts_tpu_torch.tools import exp_attn_forms as taf

    if m is None:
        q, k, v = taf.inputs(form, 5, dev)
    else:
        g = torch.Generator(device=dev).manual_seed(m)
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).mul(0.1).bfloat16()
        q, v = rnd(2, m, 128), rnd(2, w, 128)
        k = rnd(2, 128, w) if taf.K_TRANSPOSED[form] else rnd(2, w, 128)
    before = taf.attn_form.launches[form]
    got = taf.attn_form(form, q, k, v, 3)
    assert taf.attn_form.launches[form] == before + 1
    assert scaled(got, taf.attn_form_ref(form, q, k, v, 3)) <= 1e-3
    assert torch.equal(taf.attn_form(form, q, k, v, 3), got)
    assert torch.equal(taf.attn_form(form, q, k, v, 0), torch.zeros(1, 128, device=dev))


@pytest.mark.parametrize("variant", ["mxu", "plane"])
@pytest.mark.parametrize("I,O", [(1024, 3072), (3072, 1024), (1024, 6144), (1024, 2048), (256, 40),
                                 (256, 17608)])
def test_int4_variants_match_plain(dev, variant, I, O):
    """T4: within 1e-4 scaled of the plain version (exact products, f32
    sums in another order), one launch per call; the mxu kernel on the
    fragment order, its plain version on the MLX words. At the script's four
    shapes (the plane's 768-1024 row groups dealt over one block a SM, 132
    on an H100, unevenly), at a last 16-row tile half full (O = 40) and at
    O = 17608, whose 1101 mxu tiles and 2201 plane row groups of 8 do not
    divide evenly over the grids (4 and 2 blocks an SM: 528 and 264)."""
    from qwen3tts_tpu_torch.tools import exp_int4_repack as tir

    w = tir.weights(I, O, 9, dev)
    fn, ref, args, ref_args = {
        "mxu": (tir.mxu_variant, tir.mxu_variant_ref, (w["x"], w["frag"], w["scales"], w["biases"]),
                (w["x"], w["packed"], w["scales"], w["biases"])),
        "plane": (tir.plane_variant, tir.plane_variant_ref, (w["x"], w["lo"], w["hi"], w["scales"]),
                  (w["x"], w["lo"], w["hi"], w["scales"])),
    }[variant]
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    assert scaled(got, ref(*ref_args)) <= 1e-4


def test_int4_mxu_takes_only_the_fragment_order_on_the_card(dev):
    from qwen3tts_tpu_torch.tools import exp_int4_repack as tir

    w = tir.weights(256, 32, 9, dev)
    with pytest.raises(ValueError, match="fragment order"):
        tir.mxu_variant(w["x"], w["packed"], w["scales"], w["biases"])
    with pytest.raises(ValueError):  # a fragment order for 32 rows, scales for 48
        tir.mxu_variant(w["x"], w["frag"], torch.cat([w["scales"]] * 2)[:48],
                        torch.cat([w["biases"]] * 2)[:48])


@pytest.mark.parametrize("L,B,H,T,D", [(3, 7, 8, 64, 128), (28, 33, 8, 32, 128), (3, 7, 1, 64, 128),
                                         (3, 7, 8, 64, 64), (3, 7, 8, 64, 256), (1, 5, 3, 24, 8)])
def test_kv_append_matches_plain(dev, L, B, H, T, D):
    """T5: the caches bit-equal to the plain version's, in place, offsets
    on both edges of the TPU's 8-row window and outside [0, T). Units (a
    layer and a sequence each) that fill the grid's warps unevenly (28 x 33),
    one kv head, rows of 64, 256 and 8 values (a lane then has no piece, or
    two rounds of them)."""
    from qwen3tts_tpu_torch.tools import exp_kv_append as tka

    g = torch.Generator(device=dev).manual_seed(5)
    rand = lambda *s: torch.randn(*s, generator=g, device=dev).bfloat16()
    k_new, v_new, kc, vc = rand(L, B, H, D), rand(L, B, H, D), rand(L, B, H, T, D), rand(L, B, H, T, D)
    edges = [0, 7, 8, T - 1, 23, -2, T + 9]
    offs = torch.tensor([edges[b % 7] + 8 * (b // 7) for b in range(B)], dtype=torch.int32,
                        device=dev)
    ref = tka.kv_append_ref(kc.clone(), vc.clone(), k_new, v_new, offs)
    in_range = offs.clamp(0, T - 1)
    lib = tka.kv_append_index_put(kc.clone(), vc.clone(), k_new, v_new, in_range)
    lib_k = tka.kv_append(kc.clone(), vc.clone(), k_new, v_new, in_range)
    before = tka.kv_append.launches
    got = tka.kv_append(kc, vc, k_new, v_new, offs)
    assert tka.kv_append.launches == before + 1
    assert got[0] is kc and torch.equal(kc, ref[0]) and torch.equal(vc, ref[1])
    assert torch.equal(lib[0], lib_k[0]) and torch.equal(lib[1], lib_k[1])  # the library call


@pytest.mark.parametrize("name", ["p1", "p2", "p3", "p4", "p5", "p6", "p3a", "p3b", "p3c", "p4a",
                                  "p4b", "p4c"])
def test_cpk_probe_matches_plain(dev, name):
    """T2: each probe on the script's inputs and on random ones, equal to
    its plain version (p6 within 1e-5 scaled), one launch per call."""
    from qwen3tts_tpu_torch.tools import exp_cpk as tcp

    cases = [tcp.probe_inputs(name, dev), tcp.probe_random_inputs(name, dev, seed=8)]
    for args in cases:
        before = tcp.probe.launches[name]
        got = tcp.probe(name, *args)
        assert tcp.probe.launches[name] == before + 1
        assert tcp.agree(name, got, tcp.probe_ref(name, *args)) <= 1e-5


@pytest.mark.parametrize("name,K,N", [("p2", 1028, 48), ("p6", 1000, 16), ("p6", 4096, 2064)])
def test_cpk_gemv_probes_at_uneven_shapes(dev, name, K, N):
    """T2's p2 (exact) and p6 (<= 1e-5 scaled) where K does not divide
    evenly over a block's 256 threads (p2's 257 four-row groups; p6's rows
    past 768 + t only for t < 232) and at 129 column blocks; a shape the
    kernels do not take raises."""
    from qwen3tts_tpu_torch.tools import exp_cpk as tcp

    g = torch.Generator(device=dev).manual_seed(K + N)
    w = torch.randint(-128, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    x = (torch.randint(-128, 128, (1, K), generator=g, device=dev, dtype=torch.int8) if name == "p2"
         else torch.randn(1, K, generator=g, device=dev).bfloat16())
    got, want = tcp.probe(name, x, w), tcp.probe_ref(name, x, w)
    if name == "p2":
        assert torch.equal(got, want)
    else:
        assert scaled(got, want) <= 1e-5
        assert torch.equal(got, tcp.probe(name, x, w))  # a fixed order: the same bits each run
    with pytest.raises(ValueError, match="the kernel takes"):
        tcp.probe(name, x, w[:, :N - 8].contiguous())


def test_queued_ms_times_the_card_not_the_host(dev):
    """``queued_ms`` reads a probe's launches queued behind a spin: well under
    the host-bound back-to-back time; a call that waits on the card cannot
    be queued and raises instead of reading the host."""
    from qwen3tts_tpu_torch.tools import exp_cpk as tcp
    from qwen3tts_tpu_torch.tools._card import event_ms, queued_ms

    args = tcp.probe_inputs("p1", dev)
    queued = queued_ms(lambda: tcp.probe("p1", *args), 200)
    assert 0 < queued < 0.5 * event_ms(lambda: tcp.probe("p1", *args), 200)
    with pytest.raises(RuntimeError, match="did not queue"):
        queued_ms(torch.cuda.synchronize, 2)


K4_SHAPES = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]  # (I, O)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("I,O", K4_SHAPES)
def test_k4_packed_shapes_in_every_row_form(dev, bits, I, O):
    """K4 at the seven packed 0.6B shapes (q, k/v, o, gate/up and down, the
    codec head, the CP's lm_head: five distinct (I, O)), int4 and int8,
    group 64, in the form the kernel picks and with 1, 2, 4 and 8 rows a
    warp: within 1e-4 scaled of the plain version, bf16 and f32 rows."""
    w = _packed_weight(dev, O, I, bits, 64, seed=O + 3 * I + bits)
    g = torch.Generator(device=dev).manual_seed(I + bits)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(1, I, generator=g, device=dev).to(dtype)
        ref = q.quant_matmul(x, w.q, w.scales, w.biases, bits, 64)
        for rpw in (0, 1, 2, 4, 8):
            y = q.quant_gemv(x, w.q, w.scales, w.biases, bits, 64, rows_per_warp=rpw)
            assert scaled(y, ref) <= 1e-4, (dtype, rpw)


def _b1_case(dev, T, pos, kv_quant, seed):
    """x [1, 1, H], a random cache of T rows (int8 with row scales, or
    bf16), the rope rows at ``pos``, mask and seen set."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = tk.make_cache(CFG, 1, T, torch.bfloat16, dev, quantized=kv_quant)
    if kv_quant:
        cache.k.copy_(torch.randint(-127, 128, cache.k.shape, generator=g, device=dev))
        cache.v.copy_(torch.randint(-127, 128, cache.v.shape, generator=g, device=dev))
        cache.ks.copy_(torch.rand(cache.ks.shape, generator=g, device=dev).mul(0.02))
        cache.vs.copy_(torch.rand(cache.vs.shape, generator=g, device=dev).mul(0.01))
    else:
        cache.k.copy_(torch.randn(cache.k.shape, generator=g, device=dev))
        cache.v.copy_(torch.randn(cache.v.shape, generator=g, device=dev).mul(0.5))
    x = torch.randn(1, 1, 256, generator=g, device=dev).mul(0.2).bfloat16()
    cos, sin = mrope_cos_sin(torch.full((1, 1), pos, device=dev), 128, CFG.rope_theta,
                             CFG.mrope_section, torch.bfloat16)
    V = CFG.vocab_size
    supp = torch.zeros(V, device=dev)
    supp[V - 1024:] = -1e30
    seen = torch.rand(V, generator=g, device=dev) < 0.01
    return x, cache, cos[0, 0], sin[0, 0], supp, seen


B1_CASES = {  # name: (weights, mode, kv_quant, T, pos, sample, top_p, tensor offset)
    "int8": ("int8", "wo_bf16", False, 128, 70, True, 1.0, False),
    "int8 cache": ("int8", "wo_bf16", True, 512, 300, True, 1.0, False),
    "dyn_int8": ("int8", "dyn_int8", False, 128, 70, True, 1.0, False),
    "dyn_int8 int8 cache": ("int8", "dyn_int8", True, 512, 300, True, 1.0, False),
    "bf16 weights": ("bf16", "wo_bf16", False, 128, 70, True, 1.0, False),
    "bf16 weights int8 cache": ("bf16", "wo_bf16", True, 512, 0, True, 1.0, False),
    "non-sample": ("int8", "wo_bf16", False, 128, 70, False, 1.0, False),
    "offset on the device": ("int8", "wo_bf16", True, 512, 200, True, 1.0, True),
    "top_p 0.9": ("int8", "wo_bf16", False, 128, 70, True, 0.9, False),
    "pos 4000": ("int8", "wo_bf16", False, 4096, 4000, True, 1.0, False),
    "pos 4000 int8 cache": ("int8", "dyn_int8", True, 4096, 4000, True, 1.0, False),
    "pos 6000 bf16 weights": ("bf16", "wo_bf16", False, 6144, 6000, True, 1.0, False),
}


@pytest.mark.parametrize("name", list(B1_CASES))
def test_k1_b1_persistent_step_matches_plain(dev, weights, bf16_weights, name):
    """Every B = 1 call takes the persistent step: two operations by the
    library's count (its barrier words' memset, its launch); hidden, logits
    and the new k/v row within the bf16 bound of the plain version, greedy
    code0 equal but for near-ties (sampled at top_p 0.9: a kept id); a
    second call on the same inputs gives the same bits."""
    from qwen3tts_tpu_torch.ops import _cuda

    wts, mode, kv_quant, T, pos, sample, top_p, on_dev = B1_CASES[name]
    tp = weights[0] if wts == "int8" else bf16_weights[0]
    x, cache, cos, sin, supp, seen = _b1_case(dev, T, pos, kv_quant, seed=pos + T)
    off = torch.tensor([pos], dtype=torch.int32, device=dev) if on_dev else pos
    if on_dev:
        cos, sin, seen = cos[None], sin[None], seen[None]
    temp = 0.9 if top_p < 1 else 0.0
    kw = dict(sample=sample, temperature=temp, top_k=50, top_p=top_p, rep_penalty=1.05,
              eos_id=-1, seed=(1, 2), suppress_add=supp, seen=seen, mode=mode)
    if sample:
        kw["return_logits"] = True
    ck, cr = _clone(cache), _clone(cache)
    before = tkk.talker_decode_step.launches
    n0 = _cuda.launches()
    out_k = tkk.talker_decode_step(tp, CFG, x, ck, off, cos, sin, **kw)
    assert _cuda.launches() - n0 == 2 and tkk.talker_decode_step.launches == before + 1
    out_r = tkk.talker_decode_step_ref(tp, CFG, x, cr, off, cos, sin, **kw)
    hk, hr = (out_k[0], out_r[0]) if sample else (out_k, out_r)
    assert scaled(hk, hr) < 0.05
    for i in range(2):
        new_a, new_b = ck[i][:, 0, :, pos], cr[i][:, 0, :, pos]
        if kv_quant:
            new_a = tk.dequantize_kv(new_a, ck[2 + i][:, 0, :, pos])
            new_b = tk.dequantize_kv(new_b, cr[2 + i][:, 0, :, pos])
        assert scaled(new_a, new_b) < 0.05
    if sample:
        (_, codek, lk), (_, coder, lr) = out_k, out_r
        assert scaled(lk, lr) < 0.05
        a_, b_ = int(codek.reshape(-1)[0]), int(coder.reshape(-1)[0])
        z = _pen(lr.reshape(-1), seen.reshape(-1)) + supp
        if top_p == 1.0:
            assert a_ == b_ or abs(float(z[a_] - z[b_])) <= 2 * float((lk - lr).abs().max()) + 1e-6
        if top_p < 1.0:
            assert 0 <= a_ < CFG.vocab_size and float(z[a_]) > -1e29
    again = tkk.talker_decode_step(tp, CFG, x, _clone(cache), off, cos, sin, **kw)
    for a, b in zip(out_k if sample else (out_k,), again if sample else (again,)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    tkk.check_barrier(dev)


def test_k1_b1_cut_profile_runs(dev, weights):
    """Each cut of the step (after the barriers, the GEMV tiles, the
    prologues, the attention, the sampler) runs to its end on a long
    prefix; the last is the whole step."""
    tp, _ = weights
    x, cache, cos, sin, supp, seen = _b1_case(dev, 4096, 4000, False, seed=5)
    kw = dict(sample=True, temperature=0.0, top_k=50, top_p=1.0, ref_exact_top_p=False,
              rep_penalty=1.05, eos_id=-1, seed=(1, 2), suppress_add=supp, seen=seen,
              return_logits=True, dyn=False)
    whole = tkk.launch(tp, CFG, x, _clone(cache), 4000, cos, sin, **kw)
    for cut in range(1, len(tkk.STEP_CUTS) + 1):
        out = tkk.launch(tp, CFG, x, _clone(cache), 4000, cos, sin, cut=cut, **kw)
        torch.cuda.synchronize()
        if cut == len(tkk.STEP_CUTS):
            assert all(torch.equal(a, b) for a, b in zip(out, whole))
    tkk.check_barrier(dev)


def test_k1_b1_grid_and_barrier_faults_raise(dev, weights):
    """The persistent step takes no other path: a grid that cannot be
    resident raises before anything is enqueued, and a barrier budget of
    1 ns times out at the first wait: the faulted call's code0 is -1 and its
    hidden NaN, and it raises at ``check_barrier`` (after a
    synchronisation), at the decode loops' check and at the next call; a
    call after that runs and matches the plain version."""
    tp, _ = weights
    case = _b1_case(dev, 128, 70, False, seed=3)
    x, cache, cos, sin, supp, seen = case
    kw = dict(sample=True, temperature=0.0, top_k=50, top_p=1.0, ref_exact_top_p=False,
              rep_penalty=1.05, eos_id=-1, seed=(1, 2), suppress_add=supp, seen=seen,
              return_logits=True, dyn=False)
    n = tkk.talker_decode_step.launches
    with pytest.raises(tkk.CoResidencyError):
        tkk.launch(tp, CFG, x, _clone(cache), 70, cos, sin, blocks=100_000, **kw)
    h, code, _ = tkk.launch(tp, CFG, x, _clone(cache), 70, cos, sin, budget_ns=1, **kw)
    torch.cuda.synchronize()
    assert int(code) == -1 and bool(torch.isnan(h.float()).all())
    with pytest.raises(tkk.BarrierTimeout, match="K1 persistent barrier timed out"):
        tkk.check_barrier(dev)
    tkk.launch(tp, CFG, x, _clone(cache), 70, cos, sin, budget_ns=1, **kw)
    with pytest.raises(tkk.BarrierTimeout):
        gen.check_cp_frames(dev, sync=True)
    tkk.launch(tp, CFG, x, _clone(cache), 70, cos, sin, budget_ns=1, **kw)
    torch.cuda.synchronize()
    with pytest.raises(tkk.BarrierTimeout):
        tkk.launch(tp, CFG, x, _clone(cache), 70, cos, sin, **kw)
    assert tkk.talker_decode_step.launches == n  # the entry point's count is not touched
    hk, ck, lk, _ = _k1(tkk.talker_decode_step, tp, case, 70, temperature=0.0)
    hr, cr, lr, _ = _k1(tkk.talker_decode_step_ref, tp, case, 70, temperature=0.0)
    torch.cuda.synchronize()
    tkk.check_barrier(dev)
    assert scaled(hk, hr) < 0.05 and scaled(lk, lr) < 0.05


def _stream_codes(dev, tp, cp, seed):
    """The codes of one B = 1 ``generate_codes`` run (K1 and K2 every frame)
    on the caller's current stream."""
    g = torch.Generator(device=dev).manual_seed(2)
    res = gen.generate_codes(
        tp, cp, talker_cfg=CFG, cp_cfg=CPC,
        sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True),
        prefill_embeds=torch.randn(1, 64, 256, generator=g, device=dev).mul(0.1).bfloat16(),
        prefill_len=20, trailing_embeds=torch.zeros(16, 256, dtype=torch.bfloat16, device=dev),
        trailing_len=4, tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev),
        max_steps=24, max_frames=32, seed=seed, cache_len=128,
    )
    return res.codes[: res.n_frames].cpu()


def test_two_threads_decode_in_turns(dev, weights):
    """Two B = 1 decodes from two host threads, each under its own
    ``torch.cuda.Stream``, give the codes of the same seeds run alone: their
    prefills and chunks take turns on the card (``generate.device_turn``),
    so K1's workspace and barrier words and both kernels' fault flags are
    never in use by both at once."""
    import threading

    tp, cp = weights
    alone = {s: _stream_codes(dev, tp, cp, s) for s in (3, 4)}
    out, streams, errors = {}, {}, []
    start = threading.Barrier(2)

    def run(seed):
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                streams[seed] = torch.cuda.current_stream(dev).cuda_stream
                start.wait()
                out[seed] = _stream_codes(dev, tp, cp, seed)
        except BaseException as ex:  # noqa: BLE001  (re-raised on the test's thread)
            errors.append(ex)

    threads = [threading.Thread(target=run, args=(s,)) for s in (3, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert streams[3] != streams[4]
    for s in (3, 4):
        assert torch.equal(out[s], alone[s]), s


def test_a_fault_raises_at_the_end_of_its_turn(dev, weights):
    """A K1 step that times out inside a turn raises as the turn ends, once;
    the next turn on the device passes."""
    tp, _ = weights
    x, cache, cos, sin, supp, seen = _b1_case(dev, 128, 70, False, seed=3)
    kw = dict(sample=True, temperature=0.0, top_k=50, top_p=1.0, ref_exact_top_p=False,
              rep_penalty=1.05, eos_id=-1, seed=(1, 2), suppress_add=supp, seen=seen,
              return_logits=False, dyn=False)
    with pytest.raises(tkk.BarrierTimeout, match="K1 persistent barrier timed out"):
        with gen.device_turn(dev):
            tkk.launch(tp, CFG, x, _clone(cache), 70, cos, sin, budget_ns=1, **kw)
    with gen.device_turn(dev):
        tkk.launch(tp, CFG, x, _clone(cache), 70, cos, sin, **kw)


# ---- per-row sampling (serving's per-request mode) in K1 and K2 ----

# (temperature, top_k, top_p, repetition_penalty) rows, cycled over the batch
PER_ROW = np.asarray([
    [0.0, 0, 1.0, 1.0], [0.9, 50, 1.0, 1.05], [0.7, 1, 1.0, 1.2], [1.1, 0, 0.8, 1.0],
    [0.9, 20, 0.9, 1.3], [0.0, 20, 0.8, 1.2], [1.3, 7.9, 0.5, 1.05], [0.8, 100, 0.95, 1.0],
], np.float32)


def _row_pen(logits, seen, rep):
    return torch.where(seen, torch.where(logits < 0, logits * rep, logits / rep), logits)


@pytest.mark.parametrize("B", [8, 64, 256])
def test_k1_per_row_sampling_matches_sample_row(dev, weights, B):
    """K1 with a per-row table (``decode_blocks.samp_rows``): each row's
    code0 equals ``sample_row`` with that row's values on the kernel's own
    logits, but for a top-p cut within rounding (counted); a uniform table
    equals the scalar call; one launch and the scalar call's operations."""
    from qwen3tts_tpu_torch.ops import _cuda
    from qwen3tts_tpu_torch.ops.decode_blocks import row_sampling, samp_rows

    tp, _ = weights
    x, cache, offs, cos, sin, supp, seen = _batched_case(dev, B, 128, False, seed=60 + B)
    vec = np.resize(PER_ROW, (B, 4))
    rows = samp_rows(vec, dev)
    kw = dict(eos_id=-1, suppress_add=supp, seen=seen, return_logits=True)
    scalar = dict(temperature=0.9, top_k=50, top_p=0.9, rep_penalty=1.05)

    def call(seed, **k):
        return tkk.talker_decode_step(tp, CFG, x, _clone(cache), offs, cos, sin, seed=seed,
                                      **kw, **k)

    _, c_scalar, _ = call((4, 4), **scalar)
    uniform = samp_rows(np.tile([[0.9, 50, 0.9, 1.05]], (B, 1)), dev)
    assert torch.equal(call((4, 4), **scalar, rows=uniform)[1], c_scalar)
    torch.cuda.synchronize()
    n0, before = _cuda.launches(), tkk.talker_decode_step.launches
    call((4, 4), **scalar)
    torch.cuda.synchronize()
    n_scalar = _cuda.launches() - n0
    call((4, 4), **scalar, rows=rows)
    torch.cuda.synchronize()
    assert _cuda.launches() - n0 == 2 * n_scalar and tkk.talker_decode_step.launches == before + 2
    flips = 0
    for s in range(4):
        _, code, logits = call((s, 21), **scalar, rows=rows)
        for b in range(B):
            r = row_sampling(vec[b])
            want = int(sample_row(logits[b], **r, seen=seen[b], suppress_add=supp,
                                  seed=(s, 21), stream=16 * b))
            if int(code[b]) != want:
                flips += 1
                assert r["temperature"] > 0 and 0 < r["top_p"] < 1, (s, b)
                z = top_k_filter(_row_pen(logits[b], seen[b], r["rep_penalty"]) + supp, r["top_k"])
                assert _top_p_flip_ok(z, r["top_p"], False, int(code[b]), want), (s, b)
    assert flips <= B // 8


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_a_row_with_no_winner_takes_id_0(dev, weights, kernel):
    """A row whose scores are all NaN (a NaN temperature; the service
    refuses one at submit) gets id 0 from K1's and K2's sampler, as argmax
    does, not an id past the table: no fault, and the other rows' codes
    are those of the call where that row is greedy."""
    from qwen3tts_tpu_torch.ops.decode_blocks import samp_rows

    tp, cp = weights
    B = 8
    vec = np.resize(PER_ROW, (B, 4))
    greedy = vec.copy()
    greedy[1] = [0.0, 0, 1.0, 1.0]
    nan = greedy.copy()
    nan[1, 0] = np.nan
    if kernel == "K1":
        x, cache, offs, cos, sin, supp, seen = _batched_case(dev, B, 128, False, seed=90)

        def call(v):
            return tkk.talker_decode_step(tp, CFG, x, _clone(cache), offs, cos, sin, seed=(4, 4),
                                          temperature=0.9, top_k=50, top_p=0.9, rep_penalty=1.05,
                                          eos_id=-1, suppress_add=supp, seen=seen,
                                          rows=samp_rows(v, dev))[1]
    else:
        g = torch.Generator(device=dev).manual_seed(91)
        h = torch.randn(B, CFG.hidden_size, generator=g, device=dev).mul(0.3).bfloat16()
        code0 = torch.randint(0, 2048, (B,), generator=g, device=dev, dtype=torch.int32)

        def call(v):
            return cpk.predict_codes_fused(cp, CPC, tp, h, code0, (7, 8), temperature=0.9,
                                           top_k=50, top_p=0.9, rows=samp_rows(v, dev))[0]

    out, ref = call(nan), call(greedy)
    torch.cuda.synchronize()
    assert (out[1] == 0).all()
    keep = torch.arange(B, device=dev) != 1
    assert torch.equal(out[keep], ref[keep])


@pytest.mark.parametrize("B", [8, 64, 256])
def test_k2_per_row_sampling_matches_sample_row(dev, weights, B):
    """K2 with a per-row table: each row's 15 codes equal ``sample_row``
    with its temperature, top-k and top-p (no penalty) on the kernel's own
    logits, but for counted top-p cuts; a uniform table equals the scalar
    call; the same operations as the scalar call."""
    from qwen3tts_tpu_torch.ops import _cuda
    from qwen3tts_tpu_torch.ops.decode_blocks import row_sampling, samp_rows

    tp, cp = weights
    g = torch.Generator(device=dev).manual_seed(B + 1)
    h = torch.randn(B, CFG.hidden_size, generator=g, device=dev).mul(0.3).bfloat16()
    code0 = torch.randint(0, 2048, (B,), generator=g, device=dev, dtype=torch.int32)
    vec = np.resize(PER_ROW, (B, 4))
    rows = samp_rows(vec, dev)

    def call(seed, **k):
        return cpk.predict_codes_fused(cp, CPC, tp, h, code0, seed, return_logits=True, **k)

    scalar = dict(temperature=0.9, top_k=50, top_p=0.9)
    uniform = samp_rows(np.tile([[0.9, 50, 0.9, 1.0]], (B, 1)), dev)
    assert torch.equal(call((7, 8), **scalar)[0], call((7, 8), **scalar, rows=uniform)[0])
    torch.cuda.synchronize()
    n0 = _cuda.launches()
    call((7, 8), **scalar)
    torch.cuda.synchronize()
    n_scalar = _cuda.launches() - n0
    codes, _, logits = call((7, 8), **scalar, rows=rows)
    torch.cuda.synchronize()
    assert _cuda.launches() - n0 == 2 * n_scalar
    logits = logits.reshape(15, B, -1)
    flips = 0
    for b in range(B):
        r = row_sampling(vec[b])
        r.pop("rep_penalty")
        for j in range(15):
            want = int(sample_row(logits[j, b], **r, seed=(7, 8), stream=j + 1 + 16 * b))
            a = int(codes[b, j])
            if a != want:
                flips += 1
                assert r["temperature"] > 0 and 0 < r["top_p"] < 1, (b, j)
                assert _top_p_flip_ok(top_k_filter(logits[j, b], r["top_k"]), r["top_p"], False,
                                      a, want), (b, j)
    assert flips <= max(1, B // 8)


def _lockstep_codes(dev, tp, cp, seed):
    """The codes of a one-row lockstep decode (``bg.generate_codes_batch``,
    what ``generate_batch`` of one text runs: K1's and K2's persistent B = 1
    forms) on per-request rows."""
    g = torch.Generator(device=dev).manual_seed(5)
    res = bg.generate_codes_batch(
        tp, cp, talker_cfg=CFG, cp_cfg=CPC,
        sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True, per_request=True),
        prefill_embeds=torch.randn(1, 64, 256, generator=g, device=dev).mul(0.1).bfloat16(),
        prefill_lens=[24], trailing_embeds=torch.zeros(1, 16, 256, dtype=torch.bfloat16, device=dev),
        trailing_lens=[4], tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev),
        cache=tk.make_cache(CFG, 1, 128, torch.bfloat16, dev), max_steps=[24], max_frames=32,
        seed=seed, samp_vec=np.asarray([[0.8, 40, 0.9, 1.1]], np.float32),
    )
    return res.codes[0, : int(res.n_frames[0])].cpu()


@pytest.mark.parametrize("fault", [False, True])
def test_lockstep_beside_a_b1_decode_takes_turns(dev, weights, monkeypatch, fault):
    """A one-row lockstep decode on one thread beside a B = 1
    ``generate_codes`` on another, each under its own CUDA stream: each
    equals its run alone (the lockstep functions hold the device's turn).
    With every K2 frame of the lockstep thread given a 1 ns barrier budget,
    its fault raises on that thread and the other decode is untouched."""
    import functools
    import threading

    tp, cp = weights
    alone = (_lockstep_codes(dev, tp, cp, 3), _stream_codes(dev, tp, cp, 4))
    out, errors = {}, {}
    start = threading.Barrier(2)
    lockstep_thread = []
    real = cpk.launch

    def launch(*a, **k):
        if threading.current_thread() in lockstep_thread:
            k = dict(k, budget_ns=1)
        return real(*a, **k)

    if fault:
        monkeypatch.setattr(cpk, "launch", launch)

    def run(name, fn, seed):
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                start.wait()
                out[name] = fn(dev, tp, cp, seed)
        except BaseException as ex:  # noqa: BLE001  (checked on the test's thread)
            errors[name] = ex

    threads = [threading.Thread(target=run, args=("lockstep", _lockstep_codes, 3)),
               threading.Thread(target=run, args=("b1", _stream_codes, 4))]
    lockstep_thread.append(threads[0])
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert torch.equal(out["b1"], alone[1])
    if fault:
        assert set(errors) == {"lockstep"}
        assert isinstance(errors["lockstep"], cpk.BarrierTimeout)
    else:
        assert not errors, errors
        assert torch.equal(out["lockstep"], alone[0])
    cpk.check_barrier(dev)
    tkk.check_barrier(dev)


def test_a_served_greedy_request_is_slot_independent(dev, weights):
    """At a fixed ``slots`` a served greedy request gives the same codes
    whichever slot and neighbours it gets: alone, then last after three
    sampled neighbours (a per-request server: the neighbours sample at
    their own values)."""
    from qwen3tts_tpu_torch.serving import BatchItem, Qwen3TTSServer

    tp, cp = weights
    g = torch.Generator(device=dev).manual_seed(9)

    def item(plen, cap, **over):
        return BatchItem(prefill_embeds=torch.randn(1, plen, 256, generator=g, device=dev)
                         .mul(0.1).bfloat16(),
                         trailing=torch.randn(5, 256, generator=g, device=dev).mul(0.1).bfloat16(),
                         max_steps=cap, **over)

    greedy = item(30, 20, temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.0)
    others = [item(20 + 7 * i, 12 + 5 * i, seed=i, temperature=0.9, top_k=30, top_p=0.9,
                   repetition_penalty=1.1 + 0.1 * i) for i in range(3)]
    srv = Qwen3TTSServer(tp, cp, talker_cfg=CFG, cp_cfg=CPC,
                         sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05, per_request=True),
                         tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev),
                         slots=4, chunk_frames=4, max_frames=32, prompt_bucket=64,
                         trailing_bucket=8)
    alone = srv.submit(greedy).result(timeout=300)
    futs = [srv.submit(it) for it in others] + [srv.submit(greedy)]
    outs = [f.result(timeout=300) for f in futs]
    srv.close()
    assert alone.n_frames > 0 and all(o.n_frames > 0 for o in outs)
    assert outs[-1].n_frames == alone.n_frames and (outs[-1].codes == alone.codes).all()


# ---------------------------------------------------------------------------
# Multi-device: the dp replicas and the TP mesh on one card named twice, the
# atomic launch counter, and the kernels on a second card
# ---------------------------------------------------------------------------


def _dp_inputs(dev, B):
    g = torch.Generator(device=dev).manual_seed(12)
    return dict(
        prefill_embeds=torch.randn(B, 64, 256, generator=g, device=dev).mul(0.1).bfloat16(),
        prefill_lens=[20 + 3 * b for b in range(B)],
        trailing_embeds=torch.randn(B, 16, 256, generator=g, device=dev).mul(0.1).bfloat16(),
        trailing_lens=[4 + b for b in range(B)],
        tts_pad_embed=torch.zeros(256, dtype=torch.bfloat16, device=dev),
    )


def test_dp_over_one_card_twice_equals_each_shard_alone(dev, weights):
    """``generate_codes_batch_dp`` over ``[cuda:0, cuda:0]`` (the shards take
    turns on the card) at B = 4, sampled: each shard's codes equal its rows
    run alone with ``shard_seed(seed, s)``, and K1 and K2 launched as many
    times as the two shards alone did, each shard at least once a frame."""
    from qwen3tts_tpu_torch.parallel import dp as pdp
    from qwen3tts_tpu_torch.parallel import mesh as pm

    tp, cp = weights
    B, caps = 4, [12, 16, 9, 16]
    inp = _dp_inputs(dev, B)
    sampling = gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True)
    common = dict(talker_cfg=CFG, cp_cfg=CPC, sampling=sampling, max_frames=16)
    counts = lambda: (tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches)  # noqa: E731
    alone, per_shard = [], []
    for s in range(2):
        rows = slice(2 * s, 2 * s + 2)
        n0 = counts()
        res = bg.generate_codes_batch(
            tp, cp, **common, **{k: v[rows] if k != "tts_pad_embed" else v for k, v in inp.items()},
            cache=tk.make_cache(CFG, 2, 128, torch.bfloat16, dev), max_steps=caps[rows],
            seed=pdp.shard_seed(31, s))
        torch.cuda.synchronize()
        per_shard.append([b - a for a, b in zip(n0, counts())])
        alone.append(res)
    assert all(k1 > 0 and k2 > k1 for k1, k2 in per_shard)  # K2 also serves each first frame
    n0 = counts()
    got = pdp.generate_codes_batch_dp(
        tp, cp, mesh=pm.make_mesh([dev, dev], tp=1), **common, **inp,
        cache=tk.make_cache(CFG, B, 128, torch.bfloat16, dev), max_steps=caps, seed=31)
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(n0, counts())] == [sum(c) for c in zip(*per_shard)]
    for s, res in enumerate(alone):
        rows = slice(2 * s, 2 * s + 2)
        assert torch.equal(got.codes[rows], res.codes)
        assert torch.equal(got.n_frames[rows], res.n_frames)


def test_tp_step_on_one_card_equals_the_k1_step(dev):
    """The TP step at tp = 2 on ``[cuda:0, cuda:0]``, bf16 unfused weights
    (the plain per-position step), equals K1's step on the fused copy of
    the same weights within 0.02 scaled: the counterpart of
    TestMeshKernelEquality.test_tp_xla_step_equals_kernel_step."""
    from qwen3tts_tpu_torch.parallel import mesh as pm

    tp = hi.to_device(hi.host_init_talker_params(0, CFG), torch.bfloat16, dev)
    fused = dict(tp, layers=tk.fuse_layer_projections(tp["layers"]))
    mesh = pm.make_mesh([dev, dev], tp=2)
    ts = pm.shard_talker(tp, mesh)
    g = torch.Generator(device=dev).manual_seed(21)
    pos = 21
    prefill = torch.randn(1, pos, 256, generator=g, device=dev).mul(0.2).bfloat16()
    x = torch.randn(1, 1, 256, generator=g, device=dev).mul(0.2).bfloat16()
    cache = tk.make_cache(CFG, 1, 128, torch.bfloat16, dev)
    tk.forward(fused, CFG, prefill, cache, 0)
    cache_s = tk.make_cache(CFG, 1, 128, torch.bfloat16, dev, mesh=mesh)
    tk.forward(ts, CFG, prefill, cache_s, 0)
    n = tkk.talker_decode_step.launches
    h_k, _ = tk.forward(fused, CFG, x, cache, pos)
    assert tkk.talker_decode_step.launches == n + 1
    h_tp, _ = tk.forward(ts, CFG, x, cache_s, pos)
    assert tkk.talker_decode_step.launches == n + 1  # the TP step is the plain one
    assert scaled(h_tp, h_k) < 0.02


def test_the_launch_counter_counts_two_threads_exactly(dev, weights):
    """Two host threads launching K2 at B = 8 (several operations a call) at
    once, each on its own stream: the library's count grows by exactly the
    two threads' operations (the counter is atomic)."""
    import threading

    from qwen3tts_tpu_torch.ops import _cuda

    tp, cp = weights
    g = torch.Generator(device=dev).manual_seed(8)
    h = torch.randn(8, 256, generator=g, device=dev).mul(0.3).bfloat16()
    code0 = torch.arange(8, dtype=torch.int32, device=dev)
    run = lambda: cpk.predict_codes_fused(cp, CPC, tp, h, code0, (1, 2), temperature=0.0,  # noqa: E731
                                          top_k=50)
    n0 = _cuda.launches()
    run()
    torch.cuda.synchronize()
    per_call, calls = _cuda.launches() - n0, 200
    assert per_call > 1
    start = threading.Barrier(2)

    def worker():
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            start.wait()
            for _ in range(calls):
                run()
            torch.cuda.synchronize()

    n0 = _cuda.launches()
    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _cuda.launches() - n0 == 2 * calls * per_call


@pytest.mark.skipif(not torch.cuda.is_available() or torch.cuda.device_count() < 2,
                    reason="needs two CUDA devices: the per-device shared-memory limits and "
                           "SM counts show only on a second card")
def test_kernels_on_a_second_card_after_the_first(weights):
    """K1 (the persistent B = 1 step and the B = 8 step), K2 (B = 1 and 8)
    and K3 on cuda:0, then on cuda:1 with copies of the same operands: each
    equals its plain version on both cards (a shared-memory limit set only
    on the first card would fail the second's launches)."""
    from qwen3tts_tpu_torch.parallel.mesh import tree_to

    tp0, cp0 = weights
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        tp, cp = tree_to(tp0, dev), tree_to(cp0, dev)
        for B in (1, 8):
            g = torch.Generator(device=dev).manual_seed(B)
            h = torch.randn(B, 256, generator=g, device=dev).mul(0.3).bfloat16()
            code0 = torch.arange(B, dtype=torch.int32, device=dev) + 5
            ck, ek = cpk.predict_codes_fused(cp, CPC, tp, h, code0, (1, 2), temperature=0.0,
                                             top_k=50)
            cr, er = cpk.predict_codes_fused_ref(cp, CPC, tp, h, code0, (1, 2), temperature=0.0,
                                                 top_k=50, force_codes=ck)
            assert scaled(ek, er) < 0.05
            cache = tk.make_cache(CFG, B, 128, torch.bfloat16, dev)
            cache.k.copy_(torch.randn(cache.k.shape, generator=g, device=dev))
            cache.v.copy_(torch.randn(cache.v.shape, generator=g, device=dev).mul(0.5))
            x = torch.randn(B, 1, 256, generator=g, device=dev).mul(0.2).bfloat16()
            offs = torch.full((B,), 70, dtype=torch.int32, device=dev)
            cos, sin = mrope_cos_sin(offs[:, None].long(), 128, CFG.rope_theta, CFG.mrope_section,
                                     torch.bfloat16)
            off = 70 if B == 1 else offs
            k_out = tkk.talker_decode_step(tp, CFG, x, _clone(cache), off, cos[:, 0], sin[:, 0],
                                           sample=False)
            r_out = tkk.talker_decode_step_ref(tp, CFG, x, _clone(cache), off, cos[:, 0],
                                               sin[:, 0], sample=False)
            assert scaled(k_out, r_out) < 0.05
        qv, k, v, layer = _k3_case(dev, 4096, 4000, True)
        out = decode_attention_inner(qv, k, v, 4000, 128**-0.5, layer=layer)
        assert scaled(out, decode_attention_ref(qv, k, v, 4000, 128**-0.5, layer=layer)) <= 1e-2
        torch.cuda.synchronize(dev)
        cpk.check_barrier(dev)
        tkk.check_barrier(dev)


# ---- the CLI and the activation profiler on the card ----

# a checkpoint the kernels take: head_dim 128, the CP narrower than the
# talker (K2 with the small-to-MTP projection); ids as tools/ckpt_layout.py's
CLI_TALKER = dict(
    vocab_size=3072, text_vocab_size=512, hidden_size=256, text_hidden_size=256,
    intermediate_size=512, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
    head_dim=128, rope_scaling={"interleaved": True, "mrope_section": [24, 20, 20]},
    spk_id={"aiden": 2001, "vivian": 2002}, codec_language_id={"english": 2050},
    code_predictor_config=dict(vocab_size=2048, hidden_size=128, intermediate_size=256,
                               num_hidden_layers=2, num_attention_heads=16,
                               num_key_value_heads=8, head_dim=128, num_code_groups=16),
)


def test_cli_on_the_card_decodes_on_k1_and_k2(dev, tmp_path, monkeypatch):
    """``cli.main`` on the card (the default device) loads an int4
    checkpoint as int8 fused and writes the greedy WAV; every frame ran on
    K1's persistent B = 1 step and K2, two library operations each."""
    from qwen3tts_tpu_torch import cli
    from qwen3tts_tpu_torch.ops import _cuda
    from qwen3tts_tpu_torch.tools import ckpt_layout
    from qwen3tts_tpu_torch.tts import Qwen3TTSModel
    from qwen3tts_tpu_torch.utils.audio import load_wav

    d = ckpt_layout.write_checkpoint(
        str(tmp_path / "ckpt"), quantize=True,
        config=dict(ckpt_layout.SYNTHETIC_CONFIG, talker_config=CLI_TALKER))
    load, models = Qwen3TTSModel.from_pretrained, []

    def with_stub(cls, path, device=None):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = load(path, device=device)
        m.tokenizer = ckpt_layout.StubTokenizer()
        models.append(m)
        return m

    monkeypatch.setattr(Qwen3TTSModel, "from_pretrained", classmethod(with_stub))
    tkk.talker_decode_step.launches = tkk.talker_decode_step.persistent_launches = 0
    cpk.predict_codes_fused.launches = 0
    n0 = _cuda.launches()
    out = str(tmp_path / "o.wav")
    rc = cli.main(["-m", d, "-t", "Hello from the card", "-s", "aiden", "-o", out,
                   "--max-tokens", "8", "--temperature", "0"])
    assert rc == 0
    (m,) = models
    assert m.device.type == "cuda" and isinstance(m.talker_params["layers"]["qkv_proj"],
                                                  q.Int8Linear)
    n = m.last_info.generation_token_count
    k1, k2 = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
    assert k2 == n and k1 == n - 1 + int(n < 8) and tkk.talker_decode_step.persistent_launches == k1
    assert _cuda.launches() - n0 == 2 * (k1 + k2)
    sr, audio = load_wav(out)
    assert sr == 24000 and audio.shape[0] == n * 1920 and np.isfinite(audio).all()


def test_generate_batch_of_256_is_one_lockstep(dev, tmp_path):
    """``generate_batch`` of MAX_BATCH (256) texts on the card is one
    lockstep decode at ``seed``: one ``generate_codes_batch`` call of 256
    rows, K1 once a lockstep frame after the first and K2 once a frame, and
    the plain versions and the plain CP loop never run; every waveform
    finite and of whole frames."""
    from qwen3tts_tpu_torch.models import code_predictor as cpm
    from qwen3tts_tpu_torch.tools import ckpt_layout
    from qwen3tts_tpu_torch.tts import Qwen3TTSModel

    assert tkk.MAX_BATCH == 256
    d = ckpt_layout.write_checkpoint(
        str(tmp_path / "ckpt"), quantize=True,
        config=dict(ckpt_layout.SYNTHETIC_CONFIG, talker_config=CLI_TALKER))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = Qwen3TTSModel.from_pretrained(d)
    m.tokenizer = ckpt_layout.StubTokenizer()
    assert m.device.type == "cuda"
    calls = []
    real = bg.generate_codes_batch

    def spy(*a, **k):
        calls.append((k["prefill_embeds"].shape[0], k["seed"]))
        return real(*a, **k)

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(bg, "generate_codes_batch", spy)
        for mod, name in ((tkk, "talker_decode_step_ref"), (cpk, "predict_codes_fused_ref"),
                          (cpm, "predict_codes")):
            mp.setattr(mod, name, plain)
        tkk.talker_decode_step.launches = cpk.predict_codes_fused.launches = 0
        texts = [f"Row {i} of the wide lockstep." for i in range(256)]
        wavs = m.generate_batch(texts, speakers=["aiden", "vivian"] * 128, language="english",
                                max_tokens=8, seed=11)
    finally:
        mp.undo()
    assert calls == [(256, 11)]
    k1, k2 = tkk.talker_decode_step.launches, cpk.predict_codes_fused.launches
    assert k1 >= 1 and k2 == k1 + 1 and k2 <= 8
    assert len(wavs) == 256
    assert all(np.isfinite(w).all() and len(w) % 1920 == 0 and len(w) <= k2 * 1920 for w in wavs)


def test_batches_up_to_64_rows_keep_the_bits(dev):
    """At B = 8 and 64 the batched GEMV (both forms, three weight modes, the
    CP's five shapes), K1 (0.6B int8 in both modes, dense bf16, both caches)
    and K2 (0.6B int8, both modes) give the outputs the kernels gave when
    the batch stopped at 64 rows (digests from tools/batch_bits.py of that
    tree, NVIDIA H100 80GB HBM3): the grouping past 64 rows leaves them to
    the bit."""
    from qwen3tts_tpu_torch.tools import batch_bits as bb

    out = {}
    for fn in (bb.gemv_cases, bb.k1_cases, bb.k2_cases):
        fn(dev, out)
    assert bb.group_digests(out) == B64_DIGESTS


# tools/batch_bits.py's group digests at B = 8 and 64, from the tree whose
# MAX_BATCH was 64
B64_DIGESTS = {
    "gemv": "1bdbf08f2519debdc80da844f23b2c7dda4bc1982ae41d4ced52b6b9fb566101",
    "k1": "44a6f837cea515b99179cae6ace2e607110aabde3dc156a3d7fda63a583353a2",
    "k2": "e4410fa53f2afef8a18d642e5673c568ad8148a635e119581f93abfe25990f24",
}


def _cpu_f32(tree):
    """A parameter tree on the CPU with its floating leaves in f32 (int8
    weights stay int8)."""
    if isinstance(tree, dict):
        return {k: _cpu_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_f32(v) for v in tree)
    if isinstance(tree, q.Int8Linear):
        return q.Int8Linear(tree.q.cpu(), tree.scale.cpu().float())
    return tree.cpu().float() if tree.is_floating_point() else tree.cpu()


def test_activation_stats_on_the_card_matches_cpu(dev, weights):
    """``talker.activation_stats`` on the card (int8 fused, bf16
    activations) against the same call in f32 on the CPU on the same
    weights: within phase 3's bf16 bound (0.05 scaled)."""
    tp, _ = weights
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(1, 40, 256, generator=g, device=dev).mul(0.3).bfloat16()
    card = tk.activation_stats(tp, CFG, x)
    cpu = tk.activation_stats(_cpu_f32(tp), CFG, x.cpu().float())
    assert card.device.type == "cuda" and card.dtype == torch.float32
    assert tuple(card.shape) == (CFG.num_hidden_layers, CFG.intermediate_size)
    assert scaled(card.cpu(), cpu) < 0.05
