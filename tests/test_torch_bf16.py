"""Dense-bf16 weights and the 1.7B shape (a CP narrower than its talker,
joined by the small-to-MTP projection) through the plain versions of K1
and K2, against the JAX package, at small widths: a 2-layer talker 256
wide (head_dim 128) over a CP 128 wide.

* K1's plain version in bf16 mode against the Pallas kernel
  ``talker_decode_step(mode="bf16", interpret=True)``, at B=1 and at B=3
  with ragged offsets: hidden within 0.15 and the new k/v rows within 0.1
  of the mean |value| (the JAX kernel tests' own bounds,
  tests/test_talker_kernel.py), greedy code0 equal.
* K2's plain version with dense bf16 layers and heads, and with the
  projection in both weight modes, against the JAX ``cp.predict_codes``
  (its XLA path: the TPU kernel takes neither), greedy and teacher-forced
  on the JAX codes: logits within 0.06 of each position's logit spread
  (tests/test_cp_kernel.py's bound), codes equal wherever the top-2 gap
  exceeds twice that noise, esum bit-equal to the f32 sum of the fed rows.
* The JAX ``generate_codes`` on fused bf16 weights with the projection,
  greedy: its codes, fed back through the port's K1 and K2 plain versions
  frame by frame, sit within 0.05 logit spreads of the best logit at every
  position (bf16 rounding points differ, e.g. attention probabilities);
  the port's loop takes K1 after the first frame and K2 every frame.
* ``from_pretrained``'s fusion rule on a checkpoint written as BF16, and the
  lockstep decode's refusal of float32 weights on a CUDA device.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu import config as jcfg
from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import generate as jgen
from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.ops.norms import rms_norm as j_rms
from qwen3tts_tpu.ops.quant import quantize_decode_params_int8 as jq8
from qwen3tts_tpu.ops.rope import mrope_cos_sin as j_mrope
from qwen3tts_tpu.ops.talker_kernel import _layout as j_layout
from qwen3tts_tpu.ops.talker_kernel import talker_decode_step as j_step
from qwen3tts_tpu.utils import host_init as jhi
from qwen3tts_tpu_torch import tts as ttts
from qwen3tts_tpu_torch.models import batch_generate as tbg
from qwen3tts_tpu_torch.models import generate as tgen
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.ops import cp_kernel as tcpk
from qwen3tts_tpu_torch.ops import talker_kernel as tkk
from qwen3tts_tpu_torch.ops.quant import Int8Linear
from qwen3tts_tpu_torch.ops.rope import mrope_cos_sin
from qwen3tts_tpu_torch.utils.convert import from_jax_params
from qwen3tts_tpu_torch.utils.loader import write_safetensors

from synthetic_ckpt import TINY_CONFIG, TINY_ST_CONFIG, build_main_weights, \
    build_speech_tokenizer_weights


def _cfgs(mod, cp_h):
    cp = mod.CodePredictorConfig(
        vocab_size=2048, hidden_size=cp_h, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, head_dim=128,
    )
    return mod.TalkerConfig(
        vocab_size=3072, text_vocab_size=64, hidden_size=256, text_hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=1, head_dim=128, code_predictor_config=cp,
    ), cp


CFG, CPC = _cfgs(jcfg, 128)  # the 1.7B shape: the CP narrower than the talker
_, CPC_EQ = _cfgs(jcfg, 256)  # the 0.6B shape: as wide, no projection
H = CFG.hidden_size


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def mean_scaled(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).mean() + 1e-6))


def _bf16_talker(seed=0):
    jp = jhi.to_device(jhi.host_init_talker_params(seed, CFG), jnp.bfloat16)
    jp["layers"] = jtk.fuse_layer_projections(jp["layers"])
    return jp


def _cp(mode: str, cpc, seed=1):
    jp = jhi.to_device(jhi.host_init_cp_params(seed, cpc, H), jnp.bfloat16)
    jp["layers"] = jtk.fuse_layer_projections(jp["layers"])
    return jq8(jp, "lm_head") if mode == "int8" else jp


@pytest.fixture(scope="module")
def talker():
    jp = _bf16_talker()
    return jp, from_jax_params(jp, "cpu")


OFFS = {1: [37], 3: [37, 90, 5]}


@pytest.mark.parametrize("B,sample", [(1, True), (3, True), (3, False)])
def test_k1_plain_bf16_matches_pallas_interpret(talker, B, sample):
    jp, tp = talker
    V = CFG.vocab_size
    assert j_layout(jp["layers"]) == "bf16" and tkk._layout(tp["layers"]) == "bf16"
    assert tkk.step_supported(tp, CFG, B)
    jcache = jtk.make_cache(CFG, B, 256, jnp.bfloat16)
    pre = jnp.asarray(rand(B, 90, H, seed=3, scale=0.2), jnp.bfloat16)
    _, jcache = jtk.forward(jp, CFG, pre, jcache, jnp.int32(0))
    offs = np.array(OFFS[B], np.int32)
    x = rand(B, 1, H, seed=5, scale=0.2)
    seen = np.zeros((B, V), bool)
    for b in range(B):
        seen[b, [3 + b, 100 + 7 * b]] = True
    supp = np.zeros(V, np.float32)
    supp[V - 1024 :] = -1e30
    cos, sin = j_mrope(jnp.asarray(offs)[:, None], 128, CFG.rope_theta, CFG.mrope_section,
                       jnp.bfloat16)
    kw = dict(mode="bf16", interpret=True)
    if sample:
        kw.update(sample=dict(temperature=0.0, top_k=8, rep_penalty=1.3, eos_id=-1),
                  seed=jnp.asarray((7, 13), jnp.int32), suppress_add=jnp.asarray(supp)[None],
                  seen=jnp.asarray(seen, jnp.float32))
    out = j_step(jp, CFG, jnp.asarray(x, jnp.bfloat16), jcache.k, jcache.v, jnp.asarray(offs),
                 cos, sin, **kw)
    h_j, k_j, v_j = out[:3]
    if not sample:
        h_j = j_rms(h_j, jp["norm"], CFG.rms_norm_eps)

    tcache = from_jax_params(jcache, "cpu")
    tcos, tsin = mrope_cos_sin(torch.from_numpy(offs)[:, None], 128, CFG.rope_theta,
                               CFG.mrope_section, torch.bfloat16)
    tkw = dict(sample=sample)
    if sample:
        tkw.update(temperature=0.0, top_k=8, rep_penalty=1.3, eos_id=-1, seed=(7, 13),
                   suppress_add=torch.from_numpy(supp), seen=torch.from_numpy(seen))
    off = int(offs[0]) if B == 1 else torch.from_numpy(offs)  # both call forms
    res = tkk.talker_decode_step(tp, CFG, torch.from_numpy(x).to(torch.bfloat16), tcache, off,
                                 tcos[:, 0], tsin[:, 0], **tkw)
    h_t = (res[0] if sample else res).reshape(B, H)
    assert mean_scaled(h_t.float().numpy(), np.asarray(h_j, np.float32).reshape(B, H)) < 0.15
    rows, pos = torch.arange(B), torch.from_numpy(offs).long()
    for got, ref in ((tcache.k, k_j), (tcache.v, v_j)):
        ref = np.asarray(ref, np.float32).transpose(1, 0, 2, 3)  # [B, L, NKV, D]
        assert mean_scaled(got[:, rows, :, pos].float().numpy(), ref) < 0.1
    if sample:
        assert (res[1].numpy().reshape(-1) == np.asarray(out[3]).reshape(-1)).all()
    assert tkk.talker_decode_step.launches == 0  # CPU tensors never launch


_cp_forward = jax.jit(jcp.forward, static_argnums=(1,))


def _jax_cp_logits(jp, cpc, jt, hidden, code0, codes):
    """The JAX XLA path's logits at the 15 positions, fed ``codes`` (its own
    greedy codes: the computation of ``cp.predict_codes``, teacher-forced)."""
    cache = jcp.make_cp_cache(cpc, hidden.shape[0], jnp.bfloat16)
    x0 = jnp.stack([hidden, jtk.embed_codec(jt, code0).astype(jnp.bfloat16)], axis=1)
    h, cache = _cp_forward(jp, cpc, x0, cache, jnp.int32(0))
    out = [jcp.head_logits(jp, h[:, -1], 0)]
    for j in range(1, 15):
        emb = jp["codec_embedding"][j - 1][codes[:, j - 1]].astype(jnp.bfloat16)
        h, cache = _cp_forward(jp, cpc, emb[:, None], cache, jnp.int32(j + 1))
        out.append(jcp.head_logits(jp, h[:, -1], j))
    return np.stack([np.asarray(o, np.float32) for o in out])  # [15, B, V]


@pytest.mark.parametrize("mode,proj", [("bf16", False), ("bf16", True), ("int8", True)])
def test_k2_plain_matches_jax_xla(mode, proj):
    cpc = CPC if proj else CPC_EQ
    jp = _cp(mode, cpc)
    assert ("small_to_mtp_projection" in jp) == proj
    jt = {"codec_embedding": jnp.asarray(rand(CFG.vocab_size, H, seed=7, scale=0.02), jnp.bfloat16)}
    tp, tt = from_jax_params(jp, "cpu"), from_jax_params(jt, "cpu")
    assert tcpk.kernel_supported(tp, cpc, H, 2)
    B = 2
    hidden = jnp.asarray(rand(B, H, seed=3, scale=0.3), jnp.bfloat16)
    code0 = jnp.asarray([17, 1029], jnp.int32)
    codes_j = np.array(jcp.predict_codes(jp, cpc, jt, hidden, code0, jax.random.PRNGKey(0),
                                         temperature=0.0, top_k=50, top_p=1.0))
    lj = _jax_cp_logits(jp, cpc, jt, hidden, code0, jnp.asarray(codes_j))
    codes_t, esum_t, lt = tcpk.predict_codes_fused(
        tp, cpc, tt, from_jax_params(hidden, "cpu"), torch.tensor([17, 1029], dtype=torch.int32),
        (5, 6), temperature=0.0, top_k=50, force_codes=torch.from_numpy(codes_j),
        return_logits=True,
    )
    assert codes_t.shape == (B, 15) and esum_t.shape == (B, H) and lt.shape == lj.shape
    spread = lj.std(axis=-1, keepdims=True) + 1e-6
    rel = np.abs(lt.numpy() - lj) / spread
    assert rel.max() < 0.06, rel.max()
    top2 = np.sort(lj, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) / spread[..., 0] > 2 * rel.max(axis=-1)  # [15, B]
    assert decisive.mean() >= 0.5
    assert (codes_t.numpy().T[decisive] == codes_j.T[decisive]).all()
    tables = tp["codec_embedding"]
    want = np.zeros((B, H), np.float32)
    for j in range(15):
        want += tables[j][torch.from_numpy(codes_j[:, j]).long()].float().numpy()
    assert esum_t.numpy().tobytes() == want.tobytes()
    assert tcpk.predict_codes_fused.launches == 0


def _inputs(seed=5):
    prefill = rand(1, 64, H, seed=seed, scale=0.1)
    trailing = rand(16, H, seed=seed + 1, scale=0.1)
    pad = rand(H, seed=seed + 2, scale=0.1)
    return prefill, 11, trailing, 6, pad


def _gap(logits, code) -> float:
    """How far ``code`` sits below the best logit, in logit spreads."""
    logits = np.asarray(logits, np.float32)
    return float((logits.max() - logits[code]) / logits.std())


def _kernel_replay_gaps(tt, tc, codes: np.ndarray, n: int) -> list[float]:
    """Feed ``codes`` frame by frame through the port's kernel path on the
    CPU (plain prefill, then K1's and K2's plain versions: K1 greedy in
    sample mode, K2 teacher-forced) and return each fed code's gap below the
    best logit (code 0 over the ids below 2048, which no mask suppresses)."""
    prefill, plen, trailing, tlen, pad = (
        torch.from_numpy(a).to(torch.bfloat16) if isinstance(a, np.ndarray) else a
        for a in _inputs()
    )
    V = CFG.vocab_size
    cache = ttk.make_cache(CFG, 1, 128)
    hidden, cache = ttk.forward(tt, CFG, prefill, cache, 0)
    h_last, off = hidden[:, plen - 1], plen
    logits = ttk.codec_logits(tt, h_last[:, None])[0, 0]
    cos, sin = mrope_cos_sin(torch.arange(128)[None], 128, CFG.rope_theta, CFG.mrope_section,
                             torch.bfloat16)
    gaps = []
    for f in range(n):
        gaps.append(_gap(logits[:2048], codes[f, 0]))
        code0 = torch.tensor(codes[f, :1], dtype=torch.int32)
        rest = torch.tensor(codes[f : f + 1, 1:], dtype=torch.int32)
        _, esum, lg = tcpk.predict_codes_fused(tc, CPC, tt, h_last, code0, (1, 2), temperature=0.0,
                                               top_k=50, force_codes=rest, return_logits=True)
        gaps += [_gap(lg[j], codes[f, 1 + j]) for j in range(15)]
        csum = ttk.embed_codec(tt, code0).float() + esum
        x = tgen._next_input(tc, tt, trailing, tlen, pad, f, code0, rest, csum)
        h, _, logits = tkk.talker_decode_step(
            tt, CFG, x, cache, off, cos[0, off], sin[0, off], temperature=0.0, top_k=50,
            rep_penalty=1.0, eos_id=-1, seed=(0, 0), suppress_add=torch.zeros(V),
            seen=torch.zeros(V, dtype=torch.bool), return_logits=True)
        h_last, off = h[None], off + 1
    return gaps


def test_generate_codes_bf16_projection_teacher_forced(monkeypatch):
    jt, jc = _bf16_talker(3), _cp("bf16", CPC, 4)
    tt, tc = from_jax_params(jt, "cpu"), from_jax_params(jc, "cpu")
    prefill, plen, trailing, tlen, pad = _inputs()
    n = 6
    rj = jgen.generate_codes(
        jt, jc, talker_cfg=CFG, cp_cfg=CPC,
        sampling=jgen.SamplingConfig(0.0, 50, 1.0, 1.0, forbid_eos=True),
        prefill_embeds=jnp.asarray(prefill, jnp.bfloat16), prefill_len=jnp.int32(plen),
        trailing_embeds=jnp.asarray(trailing, jnp.bfloat16), trailing_len=jnp.int32(tlen),
        tts_pad_embed=jnp.asarray(pad, jnp.bfloat16),
        cache=jtk.make_cache(CFG, 1, 128, jnp.bfloat16), max_steps=jnp.int32(n), max_frames=8,
        key=jax.random.PRNGKey(0),
    )
    assert int(rj.n_frames) == n
    gaps = _kernel_replay_gaps(tt, tc, np.asarray(rj.codes), n)
    assert max(gaps) <= 0.05, max(gaps)
    assert sum(g == 0.0 for g in gaps) >= 0.9 * len(gaps)

    # the port's loop on the same weights takes K1 after the first frame and
    # K2 every frame (the kernel branch, driven on the CPU through the plain
    # versions); its greedy codes are the replay's argmax at every position
    calls = {"k1": 0, "k2": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tgen, "_fused_ok", lambda sampling, device: sampling.top_p >= 1.0)
    monkeypatch.setattr(tkk, "talker_decode_step", count("k1", tkk.talker_decode_step))
    monkeypatch.setattr(tcpk, "predict_codes_fused", count("k2", tcpk.predict_codes_fused))
    res = tgen.generate_codes(
        tt, tc, talker_cfg=CFG, cp_cfg=CPC,
        sampling=tgen.SamplingConfig(0.0, 50, 1.0, 1.0, forbid_eos=True),
        prefill_embeds=torch.from_numpy(prefill).to(torch.bfloat16), prefill_len=plen,
        trailing_embeds=torch.from_numpy(trailing).to(torch.bfloat16), trailing_len=tlen,
        tts_pad_embed=torch.from_numpy(pad).to(torch.bfloat16), max_steps=n, max_frames=8,
        seed=0, cache_len=128,
    )
    assert calls == {"k1": n - 1, "k2": n} and res.n_frames == n
    monkeypatch.undo()
    assert max(_kernel_replay_gaps(tt, tc, res.codes.numpy(), n)) == 0.0


def _write_bf16_checkpoint(path: str) -> None:
    """tests/synthetic_ckpt.py's tiny checkpoint with its float tensors
    written as BF16, the dtype Qwen publishes."""
    os.makedirs(os.path.join(path, "speech_tokenizer"), exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(TINY_CONFIG, f)
    weights = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
               build_main_weights(TINY_CONFIG).items()}
    write_safetensors(os.path.join(path, "model.safetensors"), weights)
    with open(os.path.join(path, "speech_tokenizer", "config.json"), "w") as f:
        json.dump(TINY_ST_CONFIG, f)
    write_safetensors(os.path.join(path, "speech_tokenizer", "model.safetensors"),
                      build_speech_tokenizer_weights(TINY_ST_CONFIG))


def _load(path, **kw):
    with pytest.warns(UserWarning, match="tokenizer"):
        return ttts.Qwen3TTSModel.from_pretrained(path, device="cpu", **kw)


@pytest.fixture(scope="module")
def bf16_dir(tmp_path_factory):
    """The directory and its default load on the CPU (unfused)."""
    path = str(tmp_path_factory.mktemp("bf16"))
    _write_bf16_checkpoint(path)
    return path, _load(path)


@pytest.mark.parametrize("where", ["cuda", "cpu", "cuda int8", "cuda f32"])
def test_from_pretrained_fuses_bf16_on_the_card(bf16_dir, monkeypatch, where):
    """On the card (its branch reached here by counting the CPU as a kernel
    device), an unquantized checkpoint loaded as bf16 is fused, talker and
    CP, into the dense bf16 layout K1 and K2 read; each fused stack is the
    concatenation of the unfused ones, bit for bit. On the CPU it stays
    unfused, as in the JAX package; quantize='int8' gives the int8 layout;
    a float32 load is fused by no rule and stays unfused."""
    path, plain = bf16_dir
    monkeypatch.setattr(ttts, "_kernel_device", lambda device: where != "cpu")
    kw = {"cuda int8": dict(quantize="int8"), "cuda f32": dict(dtype=torch.float32)}.get(where, {})
    m = _load(path, **kw)
    tl, cl = m.talker_params["layers"], m.cp_params["layers"]
    want = {"cuda": "bf16", "cuda int8": "int8"}.get(where)
    assert tkk._layout(tl) == want and tkk._layout(cl) == want
    if want is None:
        assert "q_proj" in tl and "qkv_proj" not in tl
        return
    head = m.talker_params["codec_head"]
    assert isinstance(head, Int8Linear) == (want == "int8")
    if want == "bf16":
        p = plain.talker_params["layers"]
        assert head.dtype == torch.bfloat16 and "q_proj" not in tl
        assert torch.equal(tl["qkv_proj"], torch.cat([p["q_proj"], p["k_proj"], p["v_proj"]], -1))
        assert torch.equal(cl["gate_up_proj"], torch.cat(
            [plain.cp_params["layers"][k] for k in ("gate_proj", "up_proj")], -1))
        proj = m.cp_params["small_to_mtp_projection"]
        assert proj["w"].dtype == torch.bfloat16 and proj["w"].shape == (64, 32)
        # BF16 on disk crosses bit for bit
        raw = build_main_weights(TINY_CONFIG)["talker.model.layers.0.self_attn.q_proj.weight"]
        assert torch.equal(p["q_proj"][0], torch.from_numpy(raw).to(torch.bfloat16).T)


@pytest.mark.parametrize("dtype,takes", [(torch.bfloat16, True), (torch.float32, False)])
def test_lockstep_on_cuda_takes_bf16_and_refuses_f32(dtype, takes):
    """K1 and K2 take the fused dense bf16 layout (with the projection); on
    a CUDA device the lockstep decode refuses fused float32 weights, which
    neither kernel reads (no plain loop on the card)."""
    from qwen3tts_tpu_torch.utils import host_init as thi

    tp = thi.to_device(thi.host_init_talker_params(0, CFG), dtype, "cpu")
    tp["layers"] = ttk.fuse_layer_projections(tp["layers"])
    cp = thi.to_device(thi.host_init_cp_params(1, CPC, H), dtype, "cpu")
    cp["layers"] = ttk.fuse_layer_projections(cp["layers"])
    assert tbg.kernels_take(tp, cp, CFG, CPC, 8, False) == takes
    args = (tp, cp, CFG, CPC)
    tbg._require_kernels(*args, torch.device("cpu"), 8, False)
    if takes:
        tbg._require_kernels(*args, torch.device("cuda"), 64, True)
    else:
        with pytest.raises(ValueError, match="dense bf16"):
            tbg._require_kernels(*args, torch.device("cuda"), 8, False)
    # a projection the kernel does not take: the wrong width
    bad = dict(cp, small_to_mtp_projection=dict(cp["small_to_mtp_projection"],
                                                w=cp["small_to_mtp_projection"]["w"][:128]))
    assert not tcpk.kernel_supported(bad, CPC, H)
