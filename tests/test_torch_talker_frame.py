"""K1's persistent B = 1 step (csrc/talker_frame.cu), its host side on the CPU.

The step runs only on the card (tests/test_torch_cuda.py holds it against
its plain version). Here: the attention cut over the cache rows and merged
as the step merges it (``decode_blocks.split_attend``) against the one-pass
attention of the plain version and, through the plain step, against the
JAX package's K1 (the Pallas kernel in interpret mode) on a prefix longer
than one chunk, on bf16 and int8 caches; the chunk plan, the barrier count
and the shared-memory arithmetic read from the kernel's source; and the
barrier fault's report.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.ops.rope import mrope_cos_sin as j_mrope
from qwen3tts_tpu.ops.talker_kernel import talker_decode_step as j_step
from qwen3tts_tpu_torch.ops import _cuda
from qwen3tts_tpu_torch.ops import decode_blocks as db
from qwen3tts_tpu_torch.ops import talker_kernel as tkk
from qwen3tts_tpu_torch.ops.rope import mrope_cos_sin
from qwen3tts_tpu_torch.utils.convert import from_jax_params

from test_torch_talker import KCFG, _int8_params

TF = _cuda.TALKER_FRAME_LIMITS
LIM = _cuda.LIMITS


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def mean_scaled(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).mean() + 1e-6))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("pos,blocks", [(0, 8), (40, 132), (300, 8), (1000, 132), (1000, 8)])
def test_split_attend_matches_one_pass(quant, pos, blocks):
    """The chunks merged in order give the one-pass softmax's output but for
    f32 rounding: within one bf16 rounding (2^-7 of the output's largest
    value), on a bf16 cache and on an int8 cache, where the current token
    joins unquantized."""
    nq, nkv, d, T = 4, 2, 128, 1024
    q = torch.from_numpy(rand(1, nq, d, seed=1)).bfloat16()
    kn = torch.from_numpy(rand(1, nkv, d, seed=2)).bfloat16()
    vn = torch.from_numpy(rand(1, nkv, d, seed=3)).bfloat16()
    kc = torch.from_numpy(rand(1, nkv, T, d, seed=4)).bfloat16()
    vc = torch.from_numpy(rand(1, nkv, T, d, seed=5)).bfloat16()
    if quant:
        (kq, ks), (vq, vs) = db.quantize_rows(kc), db.quantize_rows(vc)
        cache = lambda: (kq.clone(), vq.clone(), ks.clone(), vs.clone())
    else:
        cache = lambda: (kc.clone(), vc.clone())
    p = torch.tensor([pos])
    c1, c2 = cache(), cache()
    one = db.attend(q, kn, vn, c1, p, d**-0.5, cp_form=False).float()
    split = db.split_attend(q, kn, vn, c2, p, d**-0.5, blocks).float()
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))  # the same new row written
    assert float((one - split).abs().max()) <= 2**-7 * float(one.abs().max())


@pytest.fixture(scope="module")
def k1_params():
    jp = _int8_params(KCFG, 0)
    return jp, from_jax_params(jp, "cpu")


@pytest.mark.parametrize("kv_quant", [False, True])
def test_split_step_matches_pallas_interpret(k1_params, kv_quant):
    """The plain step with the persistent step's chunks (3 chunks of 112
    rows at pos 300 on a grid of 8 blocks) against the JAX package's K1
    in interpret mode at B = 1: greedy code0 equal; the hidden within the
    bound the batched comparison holds (0.15 of the mean |h|); and against
    the plain step's one-pass attention, code0 and logits equal up to
    rounding order (hidden within 0.02 of the mean |h|, logits within 1e-2
    of their largest)."""
    jp, tp = k1_params
    cfg, H, V, pos = KCFG, KCFG.hidden_size, KCFG.vocab_size, 300
    assert db.chunk_plan(pos + 1, 8, cfg.num_key_value_heads) == (3, 112)
    jcache = jtk.make_cache(cfg, 1, 512, jnp.bfloat16, quantized=kv_quant)
    pre = jnp.asarray(rand(1, pos, H, seed=3, scale=0.2), jnp.bfloat16)
    _, jcache = jtk.forward(jp, cfg, pre, jcache, jnp.int32(0))
    x = rand(1, 1, H, seed=5, scale=0.2)
    seen = np.zeros((1, V), bool)
    seen[0, [3, 100]] = True
    supp = np.zeros(V, np.float32)
    supp[V - 64 :] = -1e30
    offs = np.array([pos], np.int32)
    cos, sin = j_mrope(jnp.asarray(offs)[:, None], 128, cfg.rope_theta, cfg.mrope_section,
                       jnp.bfloat16)
    kw = dict(interpret=True, sample=dict(temperature=0.0, top_k=8, rep_penalty=1.3, eos_id=-1),
              seed=jnp.asarray((7, 13), jnp.int32), suppress_add=jnp.asarray(supp)[None],
              seen=jnp.asarray(seen, jnp.float32))
    if kv_quant:
        kw.update(k_scale=jcache.ks, v_scale=jcache.vs)
    out = j_step(jp, cfg, jnp.asarray(x, jnp.bfloat16), jcache.k, jcache.v, jnp.asarray(offs),
                 cos, sin, **kw)
    h_j, code_j = np.asarray(out[0], np.float32).reshape(H), int(np.asarray(out[3])[0])

    tcos, tsin = mrope_cos_sin(torch.from_numpy(offs)[:, None], 128, cfg.rope_theta,
                               cfg.mrope_section, torch.bfloat16)
    tkw = dict(temperature=0.0, top_k=8, rep_penalty=1.3, eos_id=-1, seed=(7, 13),
               suppress_add=torch.from_numpy(supp), seen=torch.from_numpy(seen[0]),
               return_logits=True)
    res = {}
    for split in (8, None):
        tcache = from_jax_params(jcache, "cpu")
        res[split] = tkk.talker_decode_step_ref(tp, cfg, torch.from_numpy(x).bfloat16(), tcache,
                                                pos, tcos[0, 0], tsin[0, 0], split_blocks=split,
                                                **tkw)
    (h_s, code_s, lg_s), (h_1, code_1, lg_1) = res[8], res[None]
    assert int(code_s) == code_j == int(code_1)
    assert mean_scaled(h_s.float().numpy(), h_j) < 0.15
    assert mean_scaled(h_s.float().numpy(), h_1.float().numpy()) < 0.02
    assert float((lg_s - lg_1).abs().max()) <= 1e-2 * float(lg_1.abs().max())


def test_step_schedule_is_read_from_the_kernel():
    """Five barriers a layer and the head's: 141 a 28-layer sample step where
    the multi-launch step made 8 L + 3 = 227 launches, 140 without the head."""
    assert TF["TF_BARRIERS_PER_LAYER"] == 5
    assert tkk.step_barriers(28, True) == 141 < 8 * 28 + 3
    assert tkk.step_barriers(28, False) == 140
    assert TF["TF_SUB"] % 32 == 0 and TF["TF_CHUNK"] % 16 == 0


@pytest.mark.parametrize("pos,plan", [(40, (1, 48)), (255, (2, 128)), (4000, (16, 256)),
                                      (6000, (16, 384))])
def test_chunk_plan_at_the_main_paths_positions(pos, plan):
    """One chunk at the short prefixes of the main path; at pos 4000 and
    6000 every block of a 132-SM card but 4 takes one (kv head, chunk) item
    of the 0.6B and 1.7B talkers' 8 kv heads."""
    C, rows = db.chunk_plan(pos + 1, 132, 8)
    assert (C, rows) == plan
    assert 8 * C <= 132


@pytest.mark.parametrize("blocks,nkv", [(132, 8), (114, 8), (8, 2), (4, 8), (1, 1)])
def test_chunk_plan_covers_every_row_once(blocks, nkv):
    """For every n up to 16,384 rows: whole chunks of a multiple of 16 rows,
    the last one holding the current token, no chunk empty, and at most the
    chunks the wrapper's partial buffer holds (max(1, blocks // nkv))."""
    cmax = max(1, blocks // nkv)
    for n in range(1, 16385):
        C, rows = db.chunk_plan(n, blocks, nkv)
        assert rows % 16 == 0 and (C - 1) * rows < n <= C * rows and 1 <= C <= cmax, n


def _smem_bytes(H, NQ, NKV, I, V, L, blocks, w_bf16):
    """tf_smem's layout (csrc/talker_frame.cu) in bytes, sample mode."""
    D, G, pw = LIM["HEAD_DIM"], NQ // NKV, LIM["PF_THREADS"] // 32
    up4 = lambda x: -(-x // 4) * 4

    def split(K, O):
        tiles = -(-O // LIM["PF_TILE"])
        S = max(1, min(min(max(1, (blocks + tiles // 2) // tiles), LIM["PF_MAX_SPLIT"]),
                       K // LIM["PF_MIN_ROWS"]))
        rows = -(-(-(-K // S)) // 16) * 16
        return -(-K // rows)

    shapes = [(H, (NQ + 2 * NKV) * D), (NQ * D, H), (H, 2 * I), (I, H), (H, V)]
    pmax = max(split(K, O) * O for K, O in shapes)
    omax = max(O for _, O in shapes)
    kmax = max(H, NQ * D, I)
    keys = 2 * (1 << (V - 1).bit_length())  # 8-byte keys, in floats
    return 4 * (up4(H) + up4(kmax) + up4(kmax // 4) + up4(pw * 33) + up4(pmax)
                + (0 if w_bf16 else up4(omax)) + up4((G + 2) * D) + up4(G * TF["TF_SUB"])
                + pw * G * D + up4(H) + 3 * D + up4((4 * L + 1) * 8) + keys)


@pytest.mark.parametrize("name,H,I,w_bf16,kb", [("0.6B int8", 1024, 3072, False, 130),
                                                ("0.6B bf16", 1024, 3072, True, 106),
                                                ("1.7B int8", 2048, 6144, False, 201),
                                                ("1.7B bf16", 2048, 6144, True, 153)])
def test_one_block_per_sm_fits(name, H, I, w_bf16, kb):
    """The co-residency arithmetic: one block of PF_THREADS threads on each
    of 132 SMs, its shared memory within what a block may use (227 KB, less
    the sampler's ~1.3 KB of static arrays) at the 0.6B and 1.7B widths; the
    staged partials and column scales of the widest GEMV (gate_up: 2 I
    columns at one split) take most of it."""
    assert LIM["PF_THREADS"] == 512
    got = _smem_bytes(H, 16, 8, I, 3072, 28, 132, w_bf16)
    assert got // 1024 == kb, got
    assert got <= 232448 - 2048


def test_barrier_check_raises_once_and_clears(monkeypatch):
    """K1's own flag: ``check_barrier`` raises ``BarrierTimeout`` naming K1
    when the card set it, and clears it; the decode loops' check reads it
    beside K2's."""
    from qwen3tts_tpu_torch.models import generate as gen

    flag = torch.zeros(1, dtype=torch.int32)
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(tkk, "_err_flags", {dev: flag})
    tkk.check_barrier(dev)
    flag.fill_(1)
    with pytest.raises(tkk.BarrierTimeout, match="K1 persistent barrier timed out"):
        tkk.check_barrier(dev)
    assert int(flag[0]) == 0
    flag.fill_(1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    gen.check_cp_frames(torch.device("cpu"))
    assert int(flag[0]) == 1
    with pytest.raises(tkk.BarrierTimeout, match="K1"):
        gen.check_cp_frames(torch.device("cuda"), sync=True)
    assert int(flag[0]) == 0
