"""K1's and K2's ``dyn_int8`` mode, K2 on unfused int8 layers, and the
selection of the mode by QWEN3TTS_TK_MODE / QWEN3TTS_CPK_MODE, on the CPU:
the port's plain versions against the Pallas kernels in interpret mode, at
small widths (head_dim 128 as the kernels need).

dyn_int8 quantizes the activation row of every int8 matvec (scale
max(amax * f32(1/127), 1e-12), an IEEE divide, round half to even) and sums
s8 x s8 exactly in int32. Both sides quantize alike: layer 0's new k/v rows,
which depend on x alone, are bit-equal to the Pallas kernel's. Past layer 0
the two sides differ as they do in ``wo_bf16`` (bf16 roundings in the
attention taken at other points, f32 sums in another order), and the
quantizer amplifies that: an activation that moves by one bf16 ulp changes
its int8 code by a whole step s ~ amax / 127 in a fraction ~ulp / s of
cases, which multiplies the RMS error by about sqrt(s / ulp), 2.5-4x the
``wo_bf16`` error on these seeds. Hence the bounds, each twice (K1) or four
times (K2, the JAX package's own dyn_int8 bound) the ``wo_bf16`` one:

* K1: hidden within 0.3 and new k/v rows within 0.25 of the mean |value|
  (tests/test_torch_batch_kernels.py: 0.15 and 0.1); greedy code0 equal
  wherever the top-2 gap of the Pallas kernel's logits exceeds twice the
  row's logit error.
* K2: logits within 0.25 of each position's logit spread
  (tests/test_cp_kernel.py's dyn_int8 bound; 0.06 in ``wo_bf16``), codes
  equal wherever the top-2 gap exceeds twice that noise, esum bit-equal.
* The slice: the port's greedy ``generate_codes`` in dyn_int8 (the kernel
  branch, through the plain versions) replayed frame by frame through the
  two Pallas kernels: every code within 0.3 logit spreads of the Pallas
  kernel's best, most of them its argmax.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.ops import cp_kernel as j_cpk
from qwen3tts_tpu.ops.norms import rms_norm as j_rms
from qwen3tts_tpu.ops.quant import quantize_decode_params_int8 as jq8
from qwen3tts_tpu.ops.rope import mrope_cos_sin as j_mrope
from qwen3tts_tpu.ops.talker_kernel import talker_decode_step as j_step
from qwen3tts_tpu.utils import host_init as jhi
from qwen3tts_tpu_torch import config as C
from qwen3tts_tpu_torch import tts as ttts
from qwen3tts_tpu_torch.models import code_predictor as tcp
from qwen3tts_tpu_torch.models import generate as tgen
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.ops import cp_kernel as tcpk
from qwen3tts_tpu_torch.ops import cp_kernel_old as tcpk_old
from qwen3tts_tpu_torch.ops import talker_kernel as tkk
from qwen3tts_tpu_torch.ops.decode_blocks import mv_f32, quantize_rows
from qwen3tts_tpu_torch.ops.quant import Int8Linear, quantize_decode_params_int8
from qwen3tts_tpu_torch.ops.rope import mrope_cos_sin
from qwen3tts_tpu_torch.utils import host_init as thi
from qwen3tts_tpu_torch.utils.convert import from_jax_params

from synthetic_ckpt import StubTokenizer
from test_torch_bf16 import CFG as SLICE_CFG
from test_torch_bf16 import CPC_EQ as SLICE_CPC
from test_torch_code_predictor import KCFG as CPC
from test_torch_generate import SPEAKERS
from test_torch_talker import KCFG, _int8_params

ENV = ("QWEN3TTS_TK_MODE", "QWEN3TTS_CPK_MODE")


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def mean_scaled(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).mean() + 1e-6))


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.fixture(scope="module")
def k1_params():
    jp = _int8_params(KCFG, 0)
    return jp, from_jax_params(jp, "cpu")


OFFS = [37, 90, 5, 64]


@pytest.mark.parametrize("B,kv_quant,sample", [(1, False, True), (4, True, True),
                                               (4, False, False)])
def test_k1_dyn_int8_plain_matches_pallas_interpret(k1_params, B, kv_quant, sample):
    jp, tp = k1_params
    cfg, H, V = KCFG, KCFG.hidden_size, KCFG.vocab_size
    jcache = jtk.make_cache(cfg, B, 256, jnp.bfloat16, quantized=kv_quant)
    pre = jnp.asarray(rand(B, 90, H, seed=3, scale=0.2), jnp.bfloat16)
    _, jcache = jtk.forward(jp, cfg, pre, jcache, jnp.int32(0))
    offs = np.array(OFFS[:B], np.int32)
    x = rand(B, 1, H, seed=5, scale=0.2)
    seen = np.zeros((B, V), bool)
    for b in range(B):
        seen[b, [3 + b, 100 + 7 * b]] = True
    supp = np.zeros(V, np.float32)
    supp[V - 64:] = -1e30
    cos, sin = j_mrope(jnp.asarray(offs)[:, None], 128, cfg.rope_theta, cfg.mrope_section,
                       jnp.bfloat16)
    kw = dict(interpret=True, mode="dyn_int8")
    if kv_quant:
        kw.update(k_scale=jcache.ks, v_scale=jcache.vs)
    if sample:
        kw.update(sample=dict(temperature=0.0, top_k=8, rep_penalty=1.3, eos_id=-1),
                  seed=jnp.asarray((7, 13), jnp.int32), suppress_add=jnp.asarray(supp)[None],
                  seen=jnp.asarray(seen, jnp.float32))
    out = j_step(jp, cfg, jnp.asarray(x, jnp.bfloat16), jcache.k, jcache.v, jnp.asarray(offs),
                 cos, sin, **kw)
    h_j, k_j, v_j = (np.asarray(t, np.float32) for t in out[:3])
    if not sample:
        h_j = np.asarray(j_rms(out[0], jp["norm"], cfg.rms_norm_eps), np.float32)
    h_j = h_j.reshape(B, H)

    tcache = from_jax_params(jcache, "cpu")
    tcos, tsin = mrope_cos_sin(torch.from_numpy(offs)[:, None], 128, cfg.rope_theta,
                               cfg.mrope_section, torch.bfloat16)
    tkw = dict(sample=sample, mode="dyn_int8")
    if sample:
        tkw.update(temperature=0.0, top_k=8, rep_penalty=1.3, eos_id=-1, seed=(7, 13),
                   suppress_add=torch.from_numpy(supp), seen=torch.from_numpy(seen),
                   return_logits=True)
    off = int(offs[0]) if B == 1 else torch.from_numpy(offs)  # both call forms
    res = tkk.talker_decode_step(tp, cfg, _bf16(x), tcache, off, tcos[:, 0], tsin[:, 0], **tkw)
    h_t = (res[0] if sample else res).reshape(B, H)
    assert mean_scaled(h_t.float().numpy(), h_j) < 0.3
    rows, pos = torch.arange(B), torch.from_numpy(offs).long()
    for i, ref in ((0, k_j), (1, v_j)):
        new = tcache[i][:, rows, :, pos]  # [B, L, NKV, D]
        if kv_quant:
            # layer 0: the rows quantized from the Pallas kernel's, bit for bit
            q0, s0 = quantize_rows(_bf16(ref[0]))
            assert torch.equal(new[:, 0], q0) and torch.equal(tcache[2 + i][0, rows, :, pos], s0)
            new = ttk.dequantize_kv(new, tcache[2 + i][:, rows, :, pos])
        else:
            assert torch.equal(new[:, 0], _bf16(ref[0]))  # layer 0, bit for bit
        assert mean_scaled(new.float().numpy(), ref.transpose(1, 0, 2, 3)) < 0.25
    if sample:
        # the Pallas kernel's logits from its post-norm hidden (the head's
        # dyn_int8 matvec, f32(acc) * (s * scale)), masked and penalised
        def z(logits):
            z = logits.numpy() + supp
            return np.where(seen, np.where(z < 0, z * 1.3, z / 1.3), z)

        zj = z(mv_f32(_bf16(h_j), tp["codec_head"], "dyn_int8"))
        zt = z(res[2].reshape(B, V))
        err = np.abs(zt - zj).max(axis=-1)
        top2 = np.sort(zj, axis=-1)[:, -2:]
        decisive = top2[:, 1] - top2[:, 0] > 2 * err
        codes_t, codes_j = res[1].numpy().reshape(-1), np.asarray(out[3]).reshape(-1)
        assert (codes_t[decisive] == codes_j[decisive]).all()
        assert (codes_j == zj.argmax(-1)).all()  # the logits are the kernel's own
    assert tkk.talker_decode_step.launches == 0  # CPU tensors never launch


def _unfused_cp():
    jp = jhi.to_device(jhi.host_init_cp_params(0, CPC, 256), jnp.bfloat16)
    return jq8(jp, "lm_head")


def _fuse_int8(layers):
    """The fused layout of unfused Int8Linear layers: q/k/v and gate/up
    side by side, each column keeping its weights and scale."""
    out = {k: v for k, v in layers.items() if k not in tcpk.UNFUSED_KEYS}
    for name, parts in (("qkv_proj", ("q_proj", "k_proj", "v_proj")), ("o_proj", ("o_proj",)),
                        ("gate_up_proj", ("gate_proj", "up_proj")), ("down_proj", ("down_proj",))):
        ws = [layers[k] for k in parts]
        out[name] = Int8Linear(torch.cat([w.q for w in ws], -1), torch.cat([w.scale for w in ws], -1))
    return out


@pytest.mark.parametrize("mode,tol", [("wo_bf16", 0.06), ("dyn_int8", 0.25)])
def test_k2_unfused_plain_matches_pallas_interpret(mode, tol):
    """K2 on unfused int8 layers (q/k/v and gate/up apart), B=3, against the
    Pallas kernel on the same unfused tree, greedy and teacher-forced; the
    port's fused version of the same weights gives bit-equal results."""
    jp = _unfused_cp()
    jt = {"codec_embedding": jnp.asarray(rand(512, 256, seed=7, scale=0.02), jnp.bfloat16)}
    tp, tt = from_jax_params(jp, "cpu"), from_jax_params(jt, "cpu")
    assert "q_proj" in tp["layers"] and tcpk.cp_layout(tp["layers"]) == "int8"
    assert tcpk.kernel_supported(tp, CPC, 256, 3)
    B = 3
    hidden = rand(B, 256, seed=4, scale=0.3)
    code0 = np.array([17, 78, 139], np.int32)
    codes_j, esum_j, lj = j_cpk.predict_codes_fused(
        jp, CPC, jt, jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(code0),
        jax.random.PRNGKey(5), temperature=0.0, top_k=50, mode=mode, interpret=True,
        return_logits=True,
    )
    codes_j, lj = np.array(codes_j), np.asarray(lj, np.float32)
    kw = dict(temperature=0.0, top_k=50, force_codes=torch.from_numpy(codes_j),
              return_logits=True, mode=mode)
    args = (CPC, tt, _bf16(hidden), torch.from_numpy(code0), (5, 6))
    codes_t, esum_t, lt = tcpk.predict_codes_fused(tp, *args, **kw)
    fused = dict(tp, layers=_fuse_int8(tp["layers"]))
    assert tcpk.cp_layout(fused["layers"]) == "int8"
    for a, b in zip((codes_t, esum_t, lt), tcpk.predict_codes_fused(fused, *args, **kw)):
        assert torch.equal(a, b)
    spread = lj.std(axis=-1, keepdims=True) + 1e-6
    rel = np.abs(lt.numpy() - lj) / spread
    assert rel.max() < tol, rel.max()
    top2 = np.sort(lj, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) / spread[..., 0] > 2 * rel.max(axis=-1)  # [15, B]
    assert decisive.sum() >= 3 * B
    assert (codes_t.numpy().T[decisive] == codes_j.T[decisive]).all()
    assert esum_t.numpy().tobytes() == np.asarray(esum_j, np.float32).tobytes()
    assert tcpk.predict_codes_fused.launches == 0


def _tiny_trees(seed=0, dense_talker=False, fused_cp=True):
    """Port trees at the slice's widths: an int8 (or dense bf16) fused
    talker and an int8 CP, fused or unfused."""
    tp = thi.to_device(thi.host_init_talker_params(seed, SLICE_CFG_T), torch.bfloat16, "cpu")
    tp["layers"] = ttk.fuse_layer_projections(tp["layers"])
    if not dense_talker:
        tp = quantize_decode_params_int8(tp, "codec_head")
    cp = thi.to_device(thi.host_init_cp_params(seed + 1, SLICE_CPC_T, 256), torch.bfloat16, "cpu")
    if fused_cp:
        cp["layers"] = ttk.fuse_layer_projections(cp["layers"])
    return tp, quantize_decode_params_int8(cp, "lm_head")


def _port_cfgs():
    cp = C.CodePredictorConfig(**{f: getattr(SLICE_CPC, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "head_dim")})
    talker = C.TalkerConfig(
        **{f: getattr(SLICE_CFG, f) for f in (
            "vocab_size", "hidden_size", "text_hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads", "num_key_value_heads", "head_dim")},
        text_vocab_size=512,  # the stub tokenizer's ids and the tts special ids 500-502
        spk_id=tuple(sorted(SPEAKERS.items())), code_predictor_config=cp)
    return talker, cp


SLICE_CFG_T, SLICE_CPC_T = _port_cfgs()


def test_modes_follow_the_jax_switches(monkeypatch):
    """``talker._kernel_mode`` and ``generate._cpk_mode`` as the JAX
    package's: ``wo_bf16`` unless the variable says ``dyn_int8``, "bf16" for
    dense layers whatever it says; an unknown value raises (the JAX package
    would run ``wo_bf16``)."""
    tp, cp = _tiny_trees()
    dense, unfused = _tiny_trees(dense_talker=True, fused_cp=False)
    dense_cp = thi.to_device(thi.host_init_cp_params(2, SLICE_CPC_T, 256), torch.bfloat16, "cpu")
    dense_cp["layers"] = ttk.fuse_layer_projections(dense_cp["layers"])
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert (ttk._kernel_mode(tp), ttk._kernel_mode(dense)) == ("wo_bf16", "bf16")
    assert [tgen._cpk_mode(c) for c in (cp, unfused, dense_cp)] == ["wo_bf16", "wo_bf16", "bf16"]
    for var in ENV:
        monkeypatch.setenv(var, "dyn_int8")
    assert (ttk._kernel_mode(tp), ttk._kernel_mode(dense)) == ("dyn_int8", "bf16")
    assert [tgen._cpk_mode(c) for c in (cp, unfused, dense_cp)] == ["dyn_int8", "dyn_int8", "bf16"]
    monkeypatch.setenv("QWEN3TTS_TK_MODE", "int4")
    with pytest.raises(ValueError, match="QWEN3TTS_TK_MODE='int4'"):
        ttk._kernel_mode(tp)
    monkeypatch.setenv("QWEN3TTS_CPK_MODE", "dyn")
    with pytest.raises(ValueError, match="QWEN3TTS_CPK_MODE='dyn'"):
        tgen._cpk_mode(cp)


def test_wrappers_refuse_unknown_and_mismatched_modes():
    """K1, K2 and K5 raise on a mode that is not the TPU kernels', on
    dyn_int8 over dense bf16 weights and on the bf16 mode over int8 ones."""
    tp, cp = _tiny_trees()
    dense, _ = _tiny_trees(dense_talker=True)
    H, V = 256, SLICE_CFG_T.vocab_size
    cache = ttk.make_cache(SLICE_CFG_T, 1, 16)
    cos = sin = torch.zeros(128, dtype=torch.bfloat16)
    x = torch.zeros(1, 1, H, dtype=torch.bfloat16)
    kw = dict(suppress_add=torch.zeros(V), seen=torch.zeros(V, dtype=torch.bool))
    for params, mode, match in ((tp, "int4", "unknown mode"), (dense, "dyn_int8", "int8 weights"),
                                (tp, "bf16", "dense bf16")):
        with pytest.raises(ValueError, match=match):
            tkk.talker_decode_step(params, SLICE_CFG_T, x, cache, 3, cos, sin, mode=mode, **kw)
    h, code0 = torch.zeros(1, H, dtype=torch.bfloat16), torch.zeros(1, dtype=torch.int32)
    for fn in (tcpk.predict_codes_fused, tcpk_old.predict_codes_fused):
        with pytest.raises(ValueError, match="unknown mode"):
            fn(cp, SLICE_CPC_T, tp, h, code0, (1, 2), temperature=0.0, top_k=5, mode="dyn")
    assert not cache.k.any()  # nothing ran


def _spy(monkeypatch, module, name, seen: list):
    """Record the ``mode`` of every call of ``module.name`` and call it."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        seen.append(k.get("mode", "wo_bf16"))
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


def _kernel_branch(monkeypatch, modes: dict):
    """generate's kernel branch on the CPU (K1/K2 through their plain
    versions), with the wrappers' calls recorded by mode."""
    monkeypatch.setattr(tgen, "_fused_ok", lambda sampling, device: sampling.top_p >= 1.0)
    _spy(monkeypatch, tkk, "talker_decode_step", modes.setdefault("k1", []))
    _spy(monkeypatch, tcpk, "predict_codes_fused", modes.setdefault("k2", []))


def _gap(logits, code) -> float:
    """How far ``code`` sits below the best logit, in logit spreads."""
    logits = np.asarray(logits, np.float32)
    return float((logits.max() - logits[code]) / logits.std())


def test_generate_codes_dyn_int8_replays_through_pallas(monkeypatch):
    """The port's greedy loop with both variables at dyn_int8 runs K1 (after
    the first frame) and K2 (every frame) in dyn_int8; its codes, fed back
    frame by frame through the Pallas kernels in dyn_int8 (interpret mode),
    sit within 0.3 logit spreads of their best logit, K2's compared up to a
    frame's first code the Pallas kernel does not pick itself."""
    jt = _int8_params(SLICE_CFG, 3)
    jc = jhi.to_device(jhi.host_init_cp_params(4, SLICE_CPC, 256), jnp.bfloat16)
    jc["layers"] = jtk.fuse_layer_projections(jc["layers"])
    jc = jq8(jc, "lm_head")
    tt, tc = from_jax_params(jt, "cpu"), from_jax_params(jc, "cpu")
    prefill, trailing, pad = (rand(1, 64, 256, seed=5, scale=0.1), rand(16, 256, seed=6, scale=0.1),
                              rand(256, seed=7, scale=0.1))
    plen, tlen, n = 11, 6, 3
    for var in ENV:
        monkeypatch.setenv(var, "dyn_int8")
    modes = {}
    _kernel_branch(monkeypatch, modes)
    res = tgen.generate_codes(
        tt, tc, talker_cfg=SLICE_CFG_T, cp_cfg=SLICE_CPC_T,
        sampling=tgen.SamplingConfig(0.0, 50, 1.0, 1.0, forbid_eos=True),
        prefill_embeds=_bf16(prefill), prefill_len=plen, trailing_embeds=_bf16(trailing),
        trailing_len=tlen, tts_pad_embed=_bf16(pad), max_steps=n, max_frames=8, seed=0,
        cache_len=128,
    )
    monkeypatch.undo()
    assert res.n_frames == n
    assert modes == {"k1": ["dyn_int8"] * (n - 1), "k2": ["dyn_int8"] * n}
    codes = res.codes.numpy()

    # the replay: the JAX prefill (XLA), then per frame the Pallas K2 on the
    # port's code 0 and the Pallas K1 on the input the port's codes make
    V = SLICE_CFG.vocab_size
    cache = jtk.make_cache(SLICE_CFG, 1, 128, jnp.bfloat16)
    hidden, cache = jtk.forward(jt, SLICE_CFG, jnp.asarray(prefill, jnp.bfloat16)[:, :plen], cache,
                                jnp.int32(0))
    h_last = hidden[:, plen - 1]
    logits = np.asarray(jtk.codec_logits(jt, h_last[:, None]), np.float32).reshape(-1)
    gaps = []
    for f in range(n):
        gaps.append(_gap(logits[:2048], codes[f, 0]))
        cj, _, lj = j_cpk.predict_codes_fused(
            jc, SLICE_CPC, jt, h_last, jnp.asarray(codes[f, :1]), jax.random.PRNGKey(0),
            temperature=0.0, top_k=50, mode="dyn_int8", interpret=True, return_logits=True)
        cj, lj = np.asarray(cj)[0], np.asarray(lj, np.float32)
        for j in range(15):
            gaps.append(_gap(lj[j], codes[f, 1 + j]))
            if cj[j] != codes[f, 1 + j]:
                break  # the Pallas kernel feeds its own code from here on
        rest = torch.from_numpy(codes[f:f + 1, 1:].copy())
        code0 = torch.from_numpy(codes[f, :1].copy())
        csum = tcp.sum_codec_embeddings(tc, tt, code0, rest)
        x = tgen._next_input(tc, tt, _bf16(trailing), tlen, _bf16(pad), f, code0, rest, csum)
        off = plen + f
        cos, sin = j_mrope(jnp.full((1, 1), off, jnp.int32), 128, SLICE_CFG.rope_theta,
                           SLICE_CFG.mrope_section, jnp.bfloat16)
        h, k_new, v_new, _ = j_step(
            jt, SLICE_CFG, jnp.asarray(x.float().numpy(), jnp.bfloat16), cache.k, cache.v,
            jnp.int32(off), cos, sin, mode="dyn_int8", interpret=True,
            sample=dict(temperature=0.0, top_k=50, rep_penalty=1.0, eos_id=-1),
            seed=jnp.asarray((0, 0), jnp.int32), suppress_add=jnp.zeros((1, V), jnp.float32),
            seen=jnp.zeros((1, V), jnp.float32))
        cache = jtk._append_cache_rows(cache, k_new, v_new, jnp.int32(off))
        h_last = h[:, 0]
        logits = mv_f32(_bf16(h_last), tt["codec_head"], "dyn_int8").numpy().reshape(-1)
    assert max(gaps) <= 0.3, max(gaps)
    assert sum(g == 0.0 for g in gaps) >= 0.8 * len(gaps)


@pytest.mark.parametrize("cp_fused", [True, False])
def test_model_generate_runs_dyn_int8_kernels_on_every_frame(monkeypatch, cp_fused):
    """``Qwen3TTSModel.generate`` with both variables at dyn_int8 and the
    kernel branch on (CPU, plain versions): K1 on every frame after the
    first and K2 on every frame, all in dyn_int8, for a fused and for an
    unfused int8 code predictor, and never the plain CP loop (which an
    unfused CP on the card used to run: ``_use_cp_kernel`` now takes it)."""
    tp, cp = _tiny_trees(seed=5, fused_cp=cp_fused)
    sampling = tgen.SamplingConfig(0.9, 50, 1.0, 1.05)
    assert tgen._use_cp_kernel(cp, SLICE_CPC_T, SLICE_CFG_T, sampling, torch.device("cuda"))
    model_cfg = C.ModelConfig(talker_config=SLICE_CFG_T, tts_model_type="custom_voice",
                              tts_bos_token_id=500, tts_eos_token_id=501, tts_pad_token_id=502)
    dec = C.TokenizerDecoderConfig(
        latent_dim=64, codebook_dim=32, decoder_dim=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2, head_dim=16)
    voc = thi.init_vocoder_params(torch.Generator().manual_seed(2), dec)
    model = ttts.Qwen3TTSModel(model_cfg, tp, cp, voc, tokenizer_config=C.TokenizerConfig(
        decoder_config=dec), tokenizer=StubTokenizer(512), device="cpu")
    for var in ENV:
        monkeypatch.setenv(var, "dyn_int8")
    modes = {}
    _kernel_branch(monkeypatch, modes)

    def plain_cp(*a, **k):
        raise AssertionError("the plain CP loop ran")

    monkeypatch.setattr(tcp, "predict_codes", plain_cp)
    wav = model.generate("hello there", speaker="aiden", language="english", max_tokens=6,
                         seed=0)
    frames = len(modes["k2"])
    assert frames >= 2 and len(wav) == frames * 1920 and np.isfinite(wav).all()
    assert modes == {"k1": ["dyn_int8"] * (frames - 1), "k2": ["dyn_int8"] * frames}
