"""The plain versions of the port's experiment kernels (qwen3tts_tpu_torch/
tools: T7 ``weight_stream``, T6 ``variant_step``, T3 ``colsum``) against the
TPU scripts' Pallas kernels in interpret mode on the CPU, at small sizes.

* T7 (tools/exp_weight_stream.py): the script's own kernel body and
  BlockSpecs (its ``run_dma_variant`` builds the call inside a timed loop and
  returns no value, so the call is rebuilt here from ``_dma_kernel``, as
  :127-145 build it, with ``interpret=True``), 3 layers. h is bit-equal for
  int8 operands (the tile sums are exact integers) and within one bf16 step
  of |h| for the f32 scale and norm rows (f32 sums of 128 values in another
  order); the checksums equal ``torch.sum`` of the same bytes.
* T6 (tools/exp_tk_b1_ablate.py): the script's ``_variant_kernel`` in the
  call its ``variant_step`` builds (:202-264), rebuilt here with
  ``interpret=True`` and index maps that take the scalar-prefetch operand
  (the script's own fail at trace time), at tests/test_talker_kernel.py's
  configuration (3 layers, H 256): h and the new k/v rows within the JAX
  kernel tests' bounds (mean-scaled 0.15 and 0.1,
  tests/test_talker_kernel.py:178), ``dma`` bit-equal.
* T3 (tools/exp_hbm_peak.py): its kernel is local to ``main``, so a copy of
  ``kern`` (:78-90) runs here through ``pallas_call(interpret=True)`` with
  the script's grid spec at a small ROWS; the sums are exact.

The scripts read ``sys.argv[1]`` when imported, so they are imported with a
patched argv. No script is edited.
"""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.ops.rope import mrope_cos_sin as j_mrope
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.ops.rope import mrope_cos_sin
from qwen3tts_tpu_torch.tools import exp_hbm_peak as thp
from qwen3tts_tpu_torch.tools import exp_tk_b1_ablate as tab
from qwen3tts_tpu_torch.tools import exp_weight_stream as tws
from qwen3tts_tpu_torch.utils.convert import from_jax_params

from test_torch_talker import KCFG, _int8_params

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _script(name: str):
    """Import tools/<name>.py as a module, with argv holding no iteration count."""
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = [spec.origin]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


def mean_scaled(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).mean() + 1e-6))


@pytest.fixture(scope="module")
def weights():
    jp = _int8_params(KCFG, 0)
    return jp, from_jax_params(jp, "cpu")


# ---- T7 ----

def _t7_pallas(ws_mod, ops, x):
    """The call of tools/exp_weight_stream.py:127-145 with ``interpret=True``."""
    H, L = x.shape[-1], ops[0].shape[0]
    blk = lambda a: pl.BlockSpec((1,) + a.shape[1:], lambda l: (l,) + (0,) * (len(a.shape) - 1))
    call = pl.pallas_call(
        functools.partial(ws_mod._dma_kernel, len(ops), 0, H),
        grid=(L,),
        in_specs=[blk(a) for a in ops] + [pl.BlockSpec((1, H), lambda l: (0, 0))],
        out_specs=pl.BlockSpec((1, H), lambda l: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, H), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((1, H), jnp.bfloat16)],
        interpret=True,
    )
    return np.asarray(call(*ops, x), np.float32)


@pytest.mark.parametrize("variant", ["dma4", "dma12", "dma1"])
def test_t7_plain_matches_pallas_interpret(weights, variant):
    ws_mod = _script("exp_weight_stream")
    jp, tp = weights
    big, small = tws.talker_operands(tp)
    ops = {"dma4": big, "dma12": big + small, "dma1": [tws.merged(big)]}[variant]
    x = (np.random.default_rng(3).standard_normal((1, 1024)) * 0.5).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    jops = [jnp.asarray(o.numpy()) for o in ops]
    want = _t7_pallas(ws_mod, jops, jnp.asarray(xt.float().numpy(), jnp.bfloat16))
    h, sums = tws.weight_stream(ops, xt)
    got = h.float().numpy()
    if variant == "dma12":  # f32 tiles summed in another order: within a bf16 step
        assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()
    else:
        assert np.array_equal(got, want)
    assert len(sums) == len(ops)
    for op, s in zip(ops, sums):
        if op.dtype == torch.int8:
            assert s.dtype == torch.int64 and torch.equal(s, op.flatten(1).long().sum(1))
        else:
            assert s.dtype == torch.float32
            assert torch.equal(s, op.flatten(1).double().sum(1).float())
    assert tws.weight_stream.launches == 0  # CPU tensors never launch


# ---- T6 ----

def _t6_pallas(ab_mod, params, cfg, x, k_cache, v_cache, pos, cos, sin, variant):
    """tools/exp_tk_b1_ablate.py:202-264 ``variant_step`` with
    ``interpret=True``, its index maps taking the scalar-prefetch operand
    that its PrefetchScalarGridSpec passes them (the script's one-argument
    lambdas fail there at trace time: ROADMAP.md, queue 3)."""
    from qwen3tts_tpu.ops.talker_kernel import _pick_block_t, _shapes, _wq

    B = x.shape[0]
    s = _shapes(cfg)
    s["B"] = B
    L, H, D, NKV, NQ, I = s["L"], s["H"], s["D"], s["NKV"], s["NQ"], s["I"]
    block_t = _pick_block_t(k_cache.shape[3], B, NKV, D)
    layers = params["layers"]
    offs_arr = jnp.broadcast_to(jnp.asarray(pos, jnp.int32).reshape(-1), (B,))
    nrm = lambda w: w.astype(jnp.float32)[:, None, :]
    kernel = functools.partial(ab_mod._variant_kernel, s, float(cfg.rms_norm_eps), block_t,
                               variant)
    blk = lambda shape: pl.BlockSpec((1,) + shape[1:], lambda l, *_: (l,) + (0,) * (len(shape) - 1))
    const = lambda shape: pl.BlockSpec(shape, lambda l, *_: (0,) * len(shape))
    qkv_w, qkv_s = _wq(layers["qkv_proj"])
    o_w, o_s = _wq(layers["o_proj"])
    gu_w, gu_s = _wq(layers["gate_up_proj"])
    d_w, d_s = _wq(layers["down_proj"])
    in_specs = [
        blk((1, H, qkv_w.shape[-1])), blk((1, 1, qkv_w.shape[-1])),
        blk((1, NQ * D, H)), blk((1, 1, H)),
        blk((1, H, 2 * I)), blk((1, 1, 2 * I)),
        blk((1, I, H)), blk((1, 1, H)),
        blk((1, 1, H)), blk((1, 1, H)), blk((1, 1, D)), blk((1, 1, D)),
        const((B, D)), const((B, D)), const((B, H)), const((B, 128)),
    ]
    operands = [
        qkv_w, qkv_s, o_w, o_s, gu_w, gu_s, d_w, d_s,
        nrm(layers["input_layernorm"]), nrm(layers["post_attention_layernorm"]),
        nrm(layers["q_norm"]), nrm(layers["k_norm"]),
        cos[:, 0].astype(jnp.float32), sin[:, 0].astype(jnp.float32),
        x[:, 0].astype(jnp.bfloat16), jnp.broadcast_to(offs_arr[:, None], (B, 128)),
    ]
    out = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(L,),
            in_specs=in_specs + [pl.BlockSpec(memory_space=pl.ANY)] * 2,
            out_specs=[const((B, H)), blk((1, B, NKV, D)), blk((1, B, NKV, D))],
            scratch_shapes=[
                pltpu.VMEM((B, H), jnp.bfloat16),
                pltpu.VMEM((2, B, NKV, block_t, D), jnp.bfloat16),
                pltpu.VMEM((2, B, NKV, block_t, D), jnp.bfloat16),
                pltpu.SemaphoreType.DMA((2, 2)),
            ],
        ),
        out_shape=[
            jax.ShapeDtypeStruct((B, H), jnp.bfloat16),
            jax.ShapeDtypeStruct((L, B, NKV, D), jnp.bfloat16),
            jax.ShapeDtypeStruct((L, B, NKV, D), jnp.bfloat16),
        ],
        interpret=True,
    )(jnp.concatenate([offs_arr, jnp.max(offs_arr)[None]]), *operands, k_cache, v_cache)
    return out[0], out[1], out[2]


@pytest.mark.parametrize("part", ["full", "noattn", "nomlp", "dma"])
def test_t6_plain_matches_pallas_interpret(weights, part):
    ab_mod = _script("exp_tk_b1_ablate")
    jp, tp = weights
    cfg, H, pos, T = KCFG, KCFG.hidden_size, 37, 128
    jcache = jtk.make_cache(cfg, 1, T, jnp.bfloat16)
    pre = (np.random.default_rng(1).standard_normal((1, pos, H)) * 0.2).astype(np.float32)
    _, jcache = jtk.forward(jp, cfg, jnp.asarray(pre, jnp.bfloat16), jcache, jnp.int32(0))
    x = (np.random.default_rng(2).standard_normal((1, 1, H)) * 0.2).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    cos, sin = j_mrope(jnp.full((1, 1), pos, jnp.int32), cfg.head_dim, cfg.rope_theta,
                       cfg.mrope_section, jnp.bfloat16)
    h_j, k_j, v_j = _t6_pallas(ab_mod, jp, cfg, jx, jcache.k, jcache.v, jnp.int32(pos), cos,
                               sin, part)

    tcache = from_jax_params(jcache, "cpu")
    tcos, tsin = mrope_cos_sin(torch.full((1, 1), pos), cfg.head_dim, cfg.rope_theta,
                               cfg.mrope_section, torch.bfloat16)
    h_t, k_t, v_t = tab.variant_step(tp, cfg, torch.from_numpy(np.asarray(jx, np.float32))
                                     .to(torch.bfloat16), tcache, pos, tcos[0, 0], tsin[0, 0], part)
    h_j = np.asarray(h_j, np.float32).reshape(1, H)
    k_j, v_j = np.asarray(k_j, np.float32), np.asarray(v_j, np.float32)
    if part == "dma":
        assert np.array_equal(h_t.float().numpy(), h_j)
        assert not k_t.any() and not v_t.any() and not k_j.any() and not v_j.any()
    else:
        assert mean_scaled(h_t.float().numpy(), h_j) < 0.15
        assert mean_scaled(k_t.float().numpy(), k_j) < 0.1
        assert mean_scaled(v_t.float().numpy(), v_j) < 0.1
    # the rows went into the cache at pos; the prefix is untouched
    assert torch.equal(tcache.k[:, :, :, :pos],
                       torch.from_numpy(np.asarray(jcache.k, np.float32)[:, :, :, :pos])
                       .to(torch.bfloat16))
    assert tab.variant_step.launches == 0


def test_t6_parts_are_switches_of_the_persistent_step(weights):
    """T6's noattn and nomlp are switches of K1's persistent B = 1 step
    (csrc/talker_frame.cu's TF_PART_*, in the order of
    ``talker_kernel.STEP_PARTS``), so they take their parts away from the
    step that serves; only ``dma`` keeps a kernel of its own
    (csrc/talker_ablate.cu: T7's stream and the zero rows, no layer
    sequence). On a CPU tensor each part runs the plain version, which
    writes the new k/v rows in place."""
    import re

    from qwen3tts_tpu_torch.ops import _cuda
    from qwen3tts_tpu_torch.ops import talker_kernel as tkk

    enum = re.search(r"enum \{ (TF_PART_FULL = 0[^}]*)\}", (_cuda.CSRC / "talker_frame.cu").read_text())
    names = [p.strip().split()[0][len("TF_PART_"):].lower() for p in enum.group(1).split(",")]
    assert names == list(tkk.STEP_PARTS) == list(tab.PARTS[:3])
    ablate = (_cuda.CSRC / "talker_ablate.cu").read_text()
    assert "qt_talker_ablate_dma" in ablate and "layer_step" not in ablate
    cfg, H, pos, T = KCFG, KCFG.hidden_size, 9, 32
    tp = weights[1]
    x = torch.randn(1, 1, H, generator=torch.Generator().manual_seed(0)).mul(0.2).bfloat16()
    cos, sin = mrope_cos_sin(torch.full((1, 1), pos), cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_section, torch.bfloat16)
    for part in tkk.STEP_PARTS:
        cache = ttk.make_cache(cfg, 1, T, torch.bfloat16, "cpu")
        h, k, v = tab.variant_step(tp, cfg, x, cache, pos, cos[0, 0], sin[0, 0], part)
        assert h.shape == (1, H) and torch.isfinite(h.float()).all()
        assert k.abs().sum() > 0 and torch.equal(k, cache.k[:, :, :, pos])
        assert not cache.k[:, :, :, pos + 1 :].any()
    assert tab.variant_step.launches == 0


# ---- T3 ----

def _t3_kern(off_ref, x_ref, o_ref):
    """A copy of tools/exp_hbm_peak.py:78-90 ``kern`` (local to its main)."""
    step = pl.program_id(0)

    @pl.when(step == 0)
    def _():
        o_ref[...] = jnp.zeros_like(o_ref)

    o_ref[...] += jnp.sum(x_ref[...].astype(jnp.int32), axis=0, keepdims=True)


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("blk_rows", [16, 64])
def test_t3_plain_matches_pallas_interpret(off, blk_rows):
    rows, cols = 256, thp.COLS
    x = np.random.default_rng(off + blk_rows).integers(-128, 127, (rows + 64, cols),
                                                       dtype=np.int8)
    call = pl.pallas_call(  # the script's grid spec (:95-112)
        _t3_kern,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(rows // blk_rows,),
            in_specs=[pl.BlockSpec((blk_rows, cols), lambda i, o: (o[0] + i, 0))],
            out_specs=pl.BlockSpec((1, cols), lambda i, o: (0, 0)),
        ),
        out_shape=jax.ShapeDtypeStruct((1, cols), jnp.int32),
        interpret=True,
    )
    want = np.asarray(call(jnp.asarray([off], jnp.int32), jnp.asarray(x)))[0]
    got = thp.colsum(torch.from_numpy(x), off * blk_rows, rows, blk_rows)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert thp.colsum.launches == 0


def test_t3_padding_covers_the_largest_block():
    assert thp.PAD * thp.COLS == max(thp.BLOCK_MIB) << 20
    assert thp.group_for(thp.ROWS // 4096, 4096, 132) * (thp.ROWS // 4096) >= 2 * 132
