"""The plain versions of the port's experiment kernels T1, T4, T5 and T2
(qwen3tts_tpu_torch/tools: ``attn_form``, ``mxu_variant`` /
``plane_variant``, ``kv_append``, ``probe``) against the TPU scripts' own
functions on the CPU, the Pallas kernels in interpret mode.

* T1 (tools/exp_attn_forms.py): the script's ``make_kernel`` in the call its
  ``run_form`` builds (:87-93; ``run_form`` itself times the call and returns
  no value), at the script's full shapes for all four forms and n = 2 and 3.
  Bound: max|a - b| / max(1, max|b|) <= 1e-3. The two sum the same f32
  products in another order; where that moves a score across a bf16
  rounding boundary its product with V moves by one bf16 step.
* T4 (tools/exp_int4_repack.py): ``mxu_variant`` and ``plane_variant`` at two
  of the script's shapes, 1e-5 scaled (exact products, f32 sums in another
  order); the port's ``pack_quantized`` and ``plane_repack`` equal, byte for
  byte, the JAX package's ``pack_quantized`` and the script's inline repack
  (:176-192, copied below as ``_script_repack``). The mxu kernel's
  fragment order (``mxu_repack``) puts every nibble where its docstring
  says, once, and ``mxu_unrepack`` gives the MLX words back; the plain
  function on it equals ``mxu_variant_ref`` on the MLX words, exactly.
* T2's yardsticks (``library_call``): ``torch._int_mm`` on padded x gives
  p2 exactly, ``x @ w.to(bf16)`` gives p6 within its bf16 output's
  rounding.
* T5 (tools/exp_kv_append.py): ``_append_call(interpret=True)`` and
  qwen3tts_tpu/models/talker.py::_scatter_append_batched, exactly, with
  offsets 0, 7, 8, T-1 and 8k+7 (window edges of the TPU's 8-row window).
* T2 (tools/exp_cpk.py): all twelve probes, on the parts the interpret mode
  defines: p3a-p3c read a scratch of which only row p is written (NaN
  elsewhere there, 0 in the port), p4a writes element 0 of its codes only,
  and p5's core PRNG is not modelled (the interpret mode returns 0, 0, 0;
  the port's counter-based draws are held to [0, 1) and a mean within 4
  standard errors of 0.5).
* Every wrapper raises on a device other than CPU and CUDA and on a shape
  its kernel does not take.
* ``tools/_card.device_ms_by_kernel`` on stubbed profiler windows: a
  window is read only from the third on, with the most kernels that two
  windows recorded; a partial window after empty ones, or one window with
  extra records, is never read.

The scripts are imported with a patched argv; none is edited.
"""

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
from qwen3tts_tpu.ops.quant import pack_quantized as j_pack_quantized
from qwen3tts_tpu_torch.ops.quant import pack_quantized
from qwen3tts_tpu_torch.tools import exp_attn_forms as taf
from qwen3tts_tpu_torch.tools import exp_cpk as tcp
from qwen3tts_tpu_torch.tools import exp_int4_repack as tir
from qwen3tts_tpu_torch.tools import exp_kv_append as tka

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def _script(name: str):
    """Import tools/<name>.py as a module, with argv holding no arguments."""
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = [spec.origin]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


def scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def bf16_np(t: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


# ---- T1 ----

@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("form", taf.FORMS)
def test_t1_plain_matches_pallas_interpret(form, n):
    af = _script("exp_attn_forms")
    q, k, v = taf.inputs(form, 11, "cpu")
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(  # run_form's call (:87-93)
            af.make_kernel(form, n),
            out_shape=jax.ShapeDtypeStruct((1, af.D), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )
        want = np.asarray(call(bf16_np(q), bf16_np(k), bf16_np(v)))
    got = taf.attn_form(form, q, k, v, n)
    assert got.shape == (1, taf.D) and got.dtype == torch.float32
    assert scaled(got.numpy(), want) <= 1e-3
    assert taf.attn_form.launches[form] == 0


# ---- T4 ----

def _script_repack(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """tools/exp_int4_repack.py:181-192, as its main runs them."""
    O, W = packed.shape
    I, per_word = W * 8, 8
    qv = np.zeros((O, I), np.uint32)
    pw = np.asarray(packed)
    for j in range(per_word):
        qv[:, j::per_word] = (pw >> (4 * j)) & 15
    half = I // 2
    lo_vals, hi_vals = qv[:, :half], qv[:, half:]
    lo = np.zeros((O, half // 8), np.uint32)
    hi = np.zeros((O, half // 8), np.uint32)
    for j in range(8):
        lo |= lo_vals[:, j::8] << (4 * j)
        hi |= hi_vals[:, j::8] << (4 * j)
    return lo, hi


@pytest.mark.parametrize("I,O", [(1024, 3072), (3072, 1024)])
def test_t4_repack_equals_the_scripts(I, O):
    w = np.random.default_rng(I).standard_normal((O, I)).astype(np.float32) * 0.02
    packed, scales, biases = pack_quantized(w, 4, 64)
    for a, b in zip((packed, scales, biases), j_pack_quantized(w, 4, 64)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    for a, b in zip(tir.plane_repack(packed), _script_repack(packed)):
        assert a.dtype == b.dtype == np.uint32 and np.array_equal(a, b)


@pytest.mark.parametrize("variant", ["mxu", "plane"])
@pytest.mark.parametrize("I,O", [(1024, 3072), (3072, 1024)])
def test_t4_plain_matches_pallas_interpret(variant, I, O):
    ir = _script("exp_int4_repack")
    w = tir.weights(I, O, 5, "cpu")
    as_u32 = lambda t: jnp.asarray(t.numpy().view(np.uint32))
    jx = jnp.asarray(w["x"].numpy())
    with pltpu.force_tpu_interpret_mode():
        if variant == "mxu":
            want = ir.mxu_variant(jx, as_u32(w["packed"]), jnp.asarray(w["scales"].numpy()),
                                  jnp.asarray(w["biases"].numpy()))
        else:
            want = ir.plane_variant(jx, as_u32(w["lo"]), as_u32(w["hi"]),
                                    jnp.asarray(w["scales"].numpy()))
        want = np.asarray(want)
    if variant == "mxu":
        got = tir.mxu_variant(w["x"], w["packed"], w["scales"], w["biases"])
    else:
        got = tir.plane_variant(w["x"], w["lo"], w["hi"], w["scales"])
    assert got.shape == (1, O) and got.dtype == torch.float32
    assert scaled(got.numpy(), want) <= 1e-5
    assert tir.mxu_variant.launches == 0 and tir.plane_variant.launches == 0


@pytest.mark.parametrize("I,O", [(128, 24), (256, 32)])
def test_t4_mxu_repack_is_a_permutation_with_an_inverse(I, O):
    """Each (row, value) of the MLX words labelled k + 1 (k = row * I +
    value) in base 16, one digit a run: every nibble of the fragment order
    decodes to the label of the (row, value) its layout names (rows 16t + g
    + 8 (n & 1), values 64 ch + 16 c + 4 p + r(n)), so each label lands
    exactly once, and the rows past O (a tile of 16 not full at O = 24) to
    0; the inverse gives random words back."""
    tiles = -(-O // 16)
    label = np.arange(1, O * I + 1, dtype=np.int64).reshape(O, I)
    got = np.zeros((tiles, I // 64, 32, 4, 8), np.int64)
    for d in range(4):  # O * I < 16 ** 4
        digit = ((label >> (4 * d)) & 15).astype(np.uint32)
        words = np.zeros((O, I // 8), np.uint32)
        for j in range(8):
            words |= digit[:, j::8] << (4 * j)
        frag = tir.mxu_repack(words)
        assert frag.shape == (tiles, I // 64, 32, 4) and frag.dtype == np.uint32
        nibs = (frag[..., None] >> (4 * np.arange(8, dtype=np.uint32))) & 15
        got |= nibs.astype(np.int64) << (4 * d)
    t, ch, lane, p, n = np.meshgrid(*(np.arange(k) for k in got.shape), indexing="ij")
    row = 16 * t + lane // 4 + 8 * (n & 1)
    value = 64 * ch + 16 * (lane % 4) + 4 * p + ((n >> 2) & 1) + 2 * ((n >> 1) & 1)
    want = np.where(row < O, np.minimum(row, O - 1) * I + value + 1, 0)
    assert np.array_equal(got, want)
    assert np.array_equal(np.sort(got[got > 0]), label.ravel())
    words = np.random.default_rng(I + O).integers(0, 1 << 32, (O, I // 8), dtype=np.uint64)
    words = words.astype(np.uint32)
    assert np.array_equal(tir.mxu_unrepack(tir.mxu_repack(words), O), words)


@pytest.mark.parametrize("I,O", [(256, 40), (1024, 48)])
def test_t4_plain_mxu_on_the_fragment_order_equals_the_plain_version(I, O):
    w = tir.weights(I, O, 13, "cpu")
    got = tir.mxu_variant(w["x"], w["frag"], w["scales"], w["biases"])
    assert torch.equal(got, tir.mxu_variant_ref(w["x"], w["packed"], w["scales"], w["biases"]))
    assert tir.mxu_variant.launches == 0


# ---- T5 ----

@pytest.mark.parametrize("offsets", [(0, 7, 8, 63, 23), (15, 63, 0, 8, 39)])
def test_t5_plain_matches_pallas_interpret_and_the_dus_chain(offsets):
    ka = _script("exp_kv_append")
    L, B, H, T, D = 2, len(offsets), 8, 64, 128
    rng = np.random.default_rng(sum(offsets))
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
    k_new, v_new, k_cache, v_cache = mk(L, B, H, D), mk(L, B, H, D), mk(L, B, H, T, D), mk(L, B, H, T, D)
    offs = torch.tensor(offsets, dtype=torch.int32)
    jk, jv = bf16_np(k_cache), bf16_np(v_cache)
    jkn, jvn, joffs = bf16_np(k_new), bf16_np(v_new), jnp.asarray(offsets, jnp.int32)
    want = ka._append_call(jk, jv, jkn, jvn, joffs, interpret=True)
    chain = jtk._scatter_append_batched(jtk.KVCache(jk, jv), None, jkn, jvn, joffs)
    kc, vc = tka.kv_append(k_cache, v_cache, k_new, v_new, offs)
    assert kc is k_cache and vc is v_cache  # in place
    for got, w_pallas, w_chain in ((kc, want[0], chain.k), (vc, want[1], chain.v)):
        g = got.float().numpy()
        assert np.array_equal(g, np.asarray(w_pallas, np.float32))
        assert np.array_equal(g, np.asarray(w_chain, np.float32))
    assert tka.kv_append.launches == 0


# ---- T2 ----

def _jax_probe(cp, name):
    fns = dict(p1=cp.p1_reshape, p2=cp.p2_int8_dot, p3=cp.p3_dynrow, p4=cp.p4_argmax_dma,
               p5=cp.p5_prng, p6=cp.p6_convert_dot, p4c=cp.p4c_run)
    fn = fns.get(name) or cp._mk(name)
    with pltpu.force_tpu_interpret_mode():
        return jax.tree.map(np.asarray, fn())


@pytest.mark.parametrize("name", tcp.PROBES)
def test_t2_plain_matches_pallas_interpret(name):
    want = _jax_probe(_script("exp_cpk"), name)
    got = tcp.probe(name, *tcp.probe_inputs(name, "cpu"))
    f = lambda t: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if name in ("p1", "p2", "p3", "p6", "p4b", "p4c"):
        assert f(got).shape == want.shape and np.array_equal(f(got), np.asarray(want, f(got).dtype))
    elif name in ("p3a", "p3b", "p3c"):  # only row p is defined in interpret mode
        row = tcp.P_ROW
        assert f(got).shape == want.shape
        assert np.array_equal(f(got)[row], np.asarray(want, np.float32)[row])
        assert not np.delete(f(got), row, axis=0).any()  # the port's scratch starts at zero
    elif name == "p4":  # the script returns codes[:1], row[0, :1]
        codes, row = got
        assert codes[:1].tolist() == want[0].tolist() == [tcp.ARGMAX_AT]
        assert row[0, :1].tolist() == want[1].tolist()
        assert torch.equal(row[0], torch.full((256,), float(tcp.ARGMAX_AT)))
    elif name == "p4a":  # element 0 only is written in interpret mode
        assert got.shape == want.shape and int(got[0]) == int(want[0]) == tcp.ARGMAX_AT
        assert not got[1:].any()
    else:  # p5: the interpret mode returns 0, 0, 0; the port's draws are uniform
        stats = tcp.p5_stats(got)
        assert want.shape == tuple(stats.shape) == (3,)
        assert 0.0 <= float(stats[1]) and float(stats[2]) < 1.0
        assert abs(float(stats[0]) - 0.5) < 4 * (1 / 12) ** 0.5 / got.numel() ** 0.5
    assert tcp.probe.launches[name] == 0


def _mutant(name, args):
    """The probe's plain version with one plausible mapping fault: columns
    reversed (p1-p3c, p6), the last max gathered instead of the first (p4*)."""
    if name.startswith("p4"):
        z = args[0].flip(1)  # the first max of the flipped z is the last max of z
        c = z.shape[1] - 1 - tcp._argmax_first(z)
        if name == "p4a":
            return tcp._codes(c, z.device)
        row = args[1][c][None]
        return (tcp._codes(c, z.device), row) if name == "p4" else row
    if name in ("p2", "p6"):
        return tcp.probe_ref(name, args[0], args[1].flip(1))
    return tcp.probe_ref(name, *args[:-1], args[-1].flip(1))


@pytest.mark.parametrize("name", [n for n in tcp.PROBES if n != "p5"])
def test_t2_random_inputs_expose_a_wrong_mapping(name):
    """On the script's inputs (ones, constant rows, one max) a kernel with a
    reversed column map or the last max gives the plain result; on
    ``probe_random_inputs`` it does not."""
    rnd = tcp.probe_random_inputs(name, "cpu")
    want, bad = tcp.outputs(tcp.probe_ref(name, *rnd)), tcp.outputs(_mutant(name, rnd))
    assert any(not torch.equal(a, b) for a, b in zip(want, bad))
    if name.startswith("p4"):  # the max ties, so first and last max differ
        assert int((rnd[0] == rnd[0].max()).sum()) > 1
    if name in ("p2", "p3", "p3a", "p3b", "p3c", "p6", "p4", "p4b", "p4c"):
        scr = tcp.probe_inputs(name, "cpu")
        same = tcp.outputs(tcp.probe_ref(name, *scr)), tcp.outputs(_mutant(name, scr))
        assert all(torch.equal(a, b) for a, b in zip(*same))


def test_t2_p5_random_inputs_draw_other_bits():
    a = tcp.probe("p5", *tcp.probe_inputs("p5", "cpu"))
    b = tcp.probe("p5", *tcp.probe_random_inputs("p5", "cpu"))
    assert b.shape == (1, 4096) and not torch.equal(a, b[:, : a.shape[1]])


def test_t2_library_yardsticks_compute_p2_and_p6():
    x, w = tcp.probe_random_inputs("p2", "cpu")
    fn, what = tcp.library_call("p2", (x, w))
    assert "torch._int_mm" in what and torch.equal(fn()[:1], tcp.probe_ref("p2", x, w))
    x, w = tcp.probe_random_inputs("p6", "cpu")
    fn, what = tcp.library_call("p6", (x, w))
    got, want = fn(), tcp.probe_ref("p6", x, w)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert float((got.float() - want).abs().max()) <= 2.0 ** -8 * float(want.abs().max())


def test_t2_probe_bytes_count_only_the_gathered_row():
    z, emb = tcp.probe_inputs("p4", "cpu")
    codes, row = tcp.probe("p4", z, emb)
    assert tcp.probe_bytes("p4", (z, emb), (codes, row)) == (2048 + 2 * 256 + 16) * 4
    assert tcp.probe_bytes("p4b", (z, emb), row) == (2048 + 2 * 256) * 4
    x, w = tcp.probe_inputs("p2", "cpu")
    assert tcp.probe_bytes("p2", (x, w), tcp.probe("p2", x, w)) == 1024 + 1024 * 2048 + 2048 * 4


# ---- wrong device and wrong shape ----

def _calls(dev):
    """One call of each wrapper on ``dev`` at a shape it takes."""
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt, device=dev)
    return {
        "T1": lambda: taf.attn_form("a", z(2, 2, 128), z(2, 128, 128), z(2, 128, 128), 1),
        "T4 mxu": lambda: tir.mxu_variant(z(1, 128, dt=torch.float32), z(8, 16, dt=torch.int32),
                                          z(8, 2, dt=torch.float32), z(8, 2, dt=torch.float32)),
        "T4 plane": lambda: tir.plane_variant(z(1, 128, dt=torch.float32), z(8, 8, dt=torch.int32),
                                              z(8, 8, dt=torch.int32), z(8, 2, dt=torch.float32)),
        "T5": lambda: tka.kv_append(z(1, 2, 1, 4, 8), z(1, 2, 1, 4, 8), z(1, 2, 1, 8), z(1, 2, 1, 8),
                                    z(2, dt=torch.int32)),
        "T2": lambda: tcp.probe("p6", z(1, 64), z(64, 128, dt=torch.int8)),
    }


@pytest.mark.parametrize("which", ["T1", "T4 mxu", "T4 plane", "T5", "T2"])
def test_wrappers_raise_on_another_device(which):
    _calls("cpu")[which]()  # the shapes are ones the wrapper takes
    with pytest.raises(ValueError, match="unsupported device"):
        _calls("meta")[which]()


def test_wrappers_raise_on_a_shape_the_kernel_does_not_take():
    f32, bf = torch.float32, torch.bfloat16
    with pytest.raises(ValueError):  # W not a multiple of 128 keys
        taf.attn_form("a", torch.zeros(2, 2, 128, dtype=bf), torch.zeros(2, 64, 128, dtype=bf),
                      torch.zeros(2, 64, 128, dtype=bf), 1)
    with pytest.raises(ValueError):  # k not pre-transposed for form b
        taf.attn_form("b", torch.zeros(2, 16, 128, dtype=bf), torch.zeros(2, 128, 128, dtype=bf),
                      torch.zeros(2, 256, 128, dtype=bf), 1)
    with pytest.raises(ValueError):  # I not a multiple of 64
        tir.mxu_variant(torch.zeros(1, 32, dtype=f32), torch.zeros(8, 4, dtype=torch.int32),
                        torch.zeros(8, 1, dtype=f32), torch.zeros(8, 1, dtype=f32))
    with pytest.raises(ValueError):  # fragment order for 32 rows, scales for 40
        tir.mxu_variant(torch.zeros(1, 128, dtype=f32), torch.zeros(2, 2, 32, 4, dtype=torch.int32),
                        torch.zeros(40, 2, dtype=f32), torch.zeros(40, 2, dtype=f32))
    with pytest.raises(ValueError):  # offsets of the wrong length
        tka.kv_append(torch.zeros(1, 2, 1, 4, 8, dtype=bf), torch.zeros(1, 2, 1, 4, 8, dtype=bf),
                      torch.zeros(1, 2, 1, 8, dtype=bf), torch.zeros(1, 2, 1, 8, dtype=bf),
                      torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):  # p3's row outside the 16-row scratch
        tcp.probe("p3", 16, torch.ones(1, 1024, dtype=bf))


def test_t5_offsets_outside_the_cache_land_where_the_dus_chain_puts_them():
    L, B, H, T, D = 1, 3, 2, 16, 8
    rng = np.random.default_rng(3)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
    k_new, v_new, k_cache, v_cache = mk(L, B, H, D), mk(L, B, H, D), mk(L, B, H, T, D), mk(L, B, H, T, D)
    offsets = (-3, T + 5, -T - 4)  # from the end; clamped high; clamped low
    chain = jtk._scatter_append_batched(jtk.KVCache(bf16_np(k_cache), bf16_np(v_cache)), None,
                                        bf16_np(k_new), bf16_np(v_new), jnp.asarray(offsets, jnp.int32))
    kc, vc = tka.kv_append(k_cache, v_cache, k_new, v_new, torch.tensor(offsets, dtype=torch.int32))
    assert np.array_equal(kc.float().numpy(), np.asarray(chain.k, np.float32))
    assert np.array_equal(vc.float().numpy(), np.asarray(chain.v, np.float32))


class _Windows:
    """torch.profiler.profile stubbed: window i records counts[i] kernels
    named ``k{i}``, 1 us each."""

    def __init__(self, counts):
        self.counts, self.opened = list(counts), 0

    def __call__(self, activities=None):
        from types import SimpleNamespace as NS

        from torch.autograd import DeviceType

        i, outer = self.opened, self
        self.opened += 1

        class Prof:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                span = NS(start=0, end=1)  # us
                return [NS(device_type=DeviceType.CUDA, name=f"k{i}", time_range=span)
                        for _ in range(outer.counts[i])]

        return Prof()


@pytest.mark.parametrize("counts,read", [
    ([20, 20, 20], 0),  # a run with no dropped record: the third window decides
    ([0, 0, 0, 20, 0, 20, 20, 15, 20, 20], 3),  # the H100 run the rule was made for
    ([0, 0, 0, 15, 20, 20], 4),  # a partial window right after three empty ones
    ([2246, 2270] + [2246] * 8, 0),  # one window with extra records (an H100 run)
    ([15, 0, 20, 0, 20], 2),  # a partial window first, then the full count twice
    ([0, 0, 0, 15, 0, 0, 0, 0, 0, 0], None),  # one window alone never sets the count
    ([0] * 10, None),
])
def test_device_ms_reads_only_a_window_two_windows_confirm(monkeypatch, counts, read):
    import torch.profiler

    from qwen3tts_tpu_torch.tools import _card

    windows = _Windows(counts)
    monkeypatch.setattr(torch.profiler, "profile", windows)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    if read is None:
        with pytest.raises(RuntimeError, match="ten profiler windows"):
            _card.device_ms_by_kernel(lambda: None, 10)
        assert windows.opened == 10
        return
    got = _card.device_ms_by_kernel(lambda: None, 10)
    assert got == {f"k{read}": pytest.approx(counts[read] * 1e-3 / 10)}
    seen = counts[: windows.opened]
    assert seen.count(counts[read]) >= 2 and windows.opened >= 3
