"""The port's tensor-parallel model (qwen3tts_tpu_torch/parallel/mesh.py and
the per-position layer step of models/talker.py) against the JAX package's
mesh path on its 8 virtual CPU devices, and the per-device state of the
kernels' wrappers, without a card.

The TP configuration is the JAX test's own (tests/test_parallel.py: 2
layers, hidden 64, 16 q and 8 kv heads, head_dim 8), which tp = 2, 4 and 8
divide. The port runs on meshes of ``["cpu"] * tp``; the weights come from
the host_init functions (numpy, seeded) through the weight bridge.

Tolerances:
* f32 forwards (prefill and one step), the port's TP path against JAX's
  ``tk.forward`` under ``make_mesh(jax.devices()[:tp], tp=tp)`` and against
  the port's unsharded forward: atol 2e-4, the bound the JAX package holds
  its own TP path to (tests/test_parallel.py::test_tp_forward_matches_single_device).
* Int8Linear leaves (``quantize_decode_params_int8`` on unfused trees, the
  int8 trees of test_dp_with_int8_params): atol 2e-4 against the unsharded
  int8 forward of both packages (the partial sums are f32 sums of the same
  products).
* Greedy codes and the cache's rows: equal, or within the forward's bound.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu.models import code_predictor as jcp
from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.ops.quant import quantize_decode_params_int8 as jquant
from qwen3tts_tpu.parallel import mesh as jpm
from qwen3tts_tpu.utils import host_init as jhi
from qwen3tts_tpu_torch.models import code_predictor as tcp
from qwen3tts_tpu_torch.models import generate as tgen
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.ops import _cuda
from qwen3tts_tpu_torch.ops import attention as attn
from qwen3tts_tpu_torch.ops import cp_kernel as cpk
from qwen3tts_tpu_torch.ops import talker_kernel as tkk
from qwen3tts_tpu_torch.ops.quant import Int8Linear, quantize_decode_params_int8
from qwen3tts_tpu_torch.parallel import mesh as pm
from qwen3tts_tpu_torch.utils import host_init as thi
from qwen3tts_tpu_torch.utils.convert import from_jax_params

from test_parallel import TP_TALKER

CPC = TP_TALKER.code_predictor_config
H = TP_TALKER.hidden_size
ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite's workers share
    the cores, and torch's default of one thread a core makes each small op
    wait on the others (the setting is restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    jt = jhi.to_device(jhi.host_init_talker_params(0, TP_TALKER), jnp.float32)
    jc = jhi.to_device(jhi.host_init_cp_params(1, CPC, H), jnp.float32)
    return jt, jc, from_jax_params(jt, "cpu"), from_jax_params(jc, "cpu")


def _jax_mesh_forward(jt, tp, x, x1, pos):
    """JAX's prefill and one step under a tp mesh (jit with sharded params)."""
    mesh = jpm.make_mesh(jax.devices()[:tp], tp=tp)
    p = jpm.shard_talker(jt, mesh)
    cache = jpm.shard_cache(jtk.make_cache(TP_TALKER, x.shape[0], 16, jnp.float32), mesh)
    with jax.set_mesh(mesh):
        fwd = jax.jit(lambda p, e, c, o: jtk.forward(p, TP_TALKER, e, c, o))
        h, cache = fwd(p, jnp.asarray(x), cache, jnp.int32(0))
        h1, _ = fwd(p, jnp.asarray(x1), cache, jnp.int32(pos))
    return np.asarray(h), np.asarray(h1)


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_tp_forward_matches_jax_mesh_and_unsharded(params, tp):
    """The port's TP talker forward (a 6-row prefill, then one step) equals
    JAX's forward under a tp mesh and the port's unsharded forward; the
    sharded cache holds the unsharded cache's rows."""
    jt, _, tt, _ = params
    x, x1 = rand(1, 6, H, seed=2), rand(1, 1, H, seed=3, scale=0.5)
    hj, h1j = _jax_mesh_forward(jt, tp, x, x1, 6)
    mesh = pm.make_mesh(["cpu"] * tp, tp=tp)
    ts = pm.shard_talker(tt, mesh)
    cs = ttk.make_cache(TP_TALKER, 1, 16, torch.float32, "cpu", mesh=mesh)
    assert cs.heads_split and len(cs.parts[0]) == tp
    assert cs.parts[0][0].k.shape == (2, 1, 8 // tp, 16, 8)
    h, cs = ttk.forward(ts, TP_TALKER, torch.from_numpy(x), cs, 0)
    h1, cs = ttk.forward(ts, TP_TALKER, torch.from_numpy(x1), cs, 6)
    ref = ttk.make_cache(TP_TALKER, 1, 16, torch.float32, "cpu")
    hr, ref = ttk.forward(tt, TP_TALKER, torch.from_numpy(x), ref, 0)
    h1r, ref = ttk.forward(tt, TP_TALKER, torch.from_numpy(x1), ref, 6)
    np.testing.assert_allclose(h.numpy(), hj, atol=ATOL)
    np.testing.assert_allclose(h1.numpy(), h1j, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=ATOL)
    np.testing.assert_allclose(h1.numpy(), h1r.numpy(), atol=ATOL)
    for a, b in zip(cs.gather(), ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_tp_batched_step_over_dp_rows(params):
    """On a (dp=2, tp=4) mesh a batch of 2 splits over the dp rows and its
    heads over tp: the prefill and a batched step at ragged offsets equal
    the unsharded ones; an odd batch stays whole on dp row 0."""
    _, _, tt, _ = params
    mesh = pm.make_mesh(["cpu"] * 8, tp=4)
    assert mesh.shape == {"dp": 2, "tp": 4}
    ts = pm.shard_talker(tt, mesh)
    x = torch.from_numpy(rand(2, 6, H, seed=4))
    cs = ttk.make_cache(TP_TALKER, 2, 16, torch.float32, "cpu", mesh=mesh)
    assert cs.batch_split and cs.rows() == [(0, slice(0, 1)), (1, slice(1, 2))]
    ref = ttk.make_cache(TP_TALKER, 2, 16, torch.float32, "cpu")
    h, cs = ttk.forward(ts, TP_TALKER, x, cs, 0)
    hr, ref = ttk.forward(tt, TP_TALKER, x, ref, 0)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=ATOL)
    offs = torch.tensor([6, 4], dtype=torch.int32)
    x1 = torch.from_numpy(rand(2, 1, H, seed=5, scale=0.5))
    h1, cs = ttk.forward_batched_step(ts, TP_TALKER, x1, cs, offs)
    h1r, ref = ttk.forward_batched_step(tt, TP_TALKER, x1, ref, offs)
    np.testing.assert_allclose(h1.numpy(), h1r.numpy(), atol=ATOL)
    for a, b in zip(cs.gather(), ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    odd = ttk.make_cache(TP_TALKER, 3, 16, torch.float32, "cpu", mesh=mesh)
    assert not odd.batch_split and odd.rows() == [(0, slice(None))] and len(odd.parts) == 1


def test_tp_code_predictor_matches_jax_and_unsharded(params):
    """The CP's trunk at tp = 2 (a 2-token prefill) equals JAX's
    ``cp.forward`` and the port's unsharded one; greedy codes are equal."""
    jt, jc, tt, tc = params
    mesh = pm.make_mesh(["cpu"] * 2, tp=2)
    cs_p = pm.shard_cp(tc, mesh)
    x = rand(1, 2, H, seed=6)
    jcache = jcp.make_cp_cache(CPC, 1, jnp.float32)
    hj, _ = jcp.forward(jc, CPC, jnp.asarray(x), jcache, 0)
    cache = tcp.make_cp_cache(CPC, 1, torch.float32, "cpu", mesh=mesh)
    h, cache = tcp.forward(cs_p, CPC, torch.from_numpy(x), cache, 0)
    hr, _ = tcp.forward(tc, CPC, torch.from_numpy(x), tcp.make_cp_cache(CPC, 1, torch.float32,
                                                                        "cpu"), 0)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=ATOL)
    code0 = torch.tensor([17], dtype=torch.int32)
    last = torch.from_numpy(rand(1, H, seed=7))
    greedy = dict(temperature=0.0, top_k=0, top_p=1.0)
    a = tcp.predict_codes(tc, CPC, tt, last, code0, None, **greedy)
    b = tcp.predict_codes(cs_p, CPC, pm.shard_talker(tt, mesh), last, code0, None, **greedy)
    assert torch.equal(a, b)


def test_tp_int8_leaves(params):
    """``quantize_decode_params_int8`` on unfused trees gives Int8Linear
    leaves that shard with their scales (split on column-parallel leaves,
    whole on row-parallel ones); the TP forward equals both packages'
    unsharded int8 forwards."""
    jt, _, tt, _ = params
    tq = quantize_decode_params_int8(tt, "codec_head")
    mesh = pm.make_mesh(["cpu"] * 2, tp=2)
    ts = pm.shard_talker(tq, mesh)
    q, o = ts["layers"]["q_proj"], ts["layers"]["o_proj"]
    assert isinstance(q.parts[0][0], Int8Linear) and q.axis == -1 and o.axis == -2
    assert q.parts[0][0].scale.shape == (2, 1, 64) and o.parts[0][0].scale.shape == (2, 1, H)
    assert o.parts[0][0].q.shape == (2, 64, H)
    x = rand(1, 6, H, seed=8)
    h, _ = ttk.forward(ts, TP_TALKER, torch.from_numpy(x),
                       ttk.make_cache(TP_TALKER, 1, 16, torch.float32, "cpu", mesh=mesh), 0)
    hr, _ = ttk.forward(tq, TP_TALKER, torch.from_numpy(x),
                        ttk.make_cache(TP_TALKER, 1, 16, torch.float32, "cpu"), 0)
    hj, _ = jax.jit(lambda p, e, c: jtk.forward(p, TP_TALKER, e, c, jnp.int32(0)))(
        jquant(jt, "codec_head"), jnp.asarray(x), jtk.make_cache(TP_TALKER, 1, 16, jnp.float32))
    np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=ATOL)


def test_tp_heads_tp_does_not_divide():
    """kv heads that tp does not divide (the JAX cache spec's
    ``heads_sharded=False``): the cache stays whole on each row's first
    device and the positions' q/k/v columns are gathered there; the forward
    equals the unsharded one."""
    small = dataclasses.replace(TP_TALKER, num_attention_heads=4, num_key_value_heads=2,
                                head_dim=16)
    tt = thi.to_device(thi.host_init_talker_params(5, small), torch.float32, "cpu")
    mesh = pm.make_mesh(["cpu"] * 4, tp=4)
    cs = ttk.make_cache(small, 1, 16, torch.float32, "cpu", mesh=mesh)
    assert not cs.heads_split and len(cs.parts[0]) == 1
    x = torch.from_numpy(rand(1, 6, H, seed=9))
    h, cs = ttk.forward(pm.shard_talker(tt, mesh), small, x, cs, 0)
    ref = ttk.make_cache(small, 1, 16, torch.float32, "cpu")
    hr, ref = ttk.forward(tt, small, x, ref, 0)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=ATOL)
    for a, b in zip(cs.gather(), ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix


@pytest.mark.parametrize("layout", ["0.6B", "1.7B"])
def test_shard_specs_cover_all_leaves(layout):
    """Every leaf of a talker and a CP tree has a spec (the 1.7B layout's CP
    is narrower than the talker and carries ``small_to_mtp_projection``),
    with the JAX package's entries; sharding places every leaf."""
    cfg = TP_TALKER if layout == "0.6B" else dataclasses.replace(
        TP_TALKER, code_predictor_config=dataclasses.replace(CPC, hidden_size=32))
    tp_ = thi.to_device(thi.host_init_talker_params(0, cfg), torch.float32, "cpu")
    cp_ = thi.to_device(thi.host_init_cp_params(1, cfg.code_predictor_config, H), torch.float32,
                        "cpu")
    assert ("small_to_mtp_projection" in cp_) == (layout == "1.7B")
    jt = jhi.host_init_talker_params(0, cfg)
    for tree, specs, jspecs in (
            (tp_, pm.talker_param_specs(tp_), jpm.talker_param_specs(jt)),
            (cp_, pm.cp_param_specs(cp_), jpm.cp_param_specs(cp_))):
        paths = set(_leaf_paths(tree))
        spec_paths = set(_leaf_paths(specs))
        assert paths <= spec_paths, paths - spec_paths
        flat = lambda t: {p: tuple(_get(t, p)) for p in _leaf_paths(t)}  # noqa: E731
        assert flat(specs) == flat(jspecs)
    mesh = pm.make_mesh(["cpu"] * 2, tp=2)
    for tree, sharded in ((tp_, pm.shard_talker(tp_, mesh)), (cp_, pm.shard_cp(cp_, mesh))):
        for path in _leaf_paths(tree):
            leaf = _get(sharded, path)
            if path[0] == "layers":
                assert isinstance(leaf, pm.Sharded)
                np.testing.assert_array_equal(leaf.gather().numpy(), _get(tree, path).numpy())
            else:
                assert torch.equal(leaf, _get(tree, path))
        assert pm.tree_mesh(sharded) is mesh


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_fused_and_packed_trees_raise():
    """A fused tree raises with the JAX message; so does a packed leaf, in
    or outside the layer stack."""
    tt = thi.to_device(thi.host_init_talker_params(0, TP_TALKER), torch.float32, "cpu")
    mesh = pm.make_mesh(["cpu"] * 2, tp=2)
    fused = dict(tt, layers=ttk.fuse_layer_projections(tt["layers"]))
    with pytest.raises(ValueError, match="TP sharding requires unfused projections"):
        pm.shard_talker(fused, mesh)
    with pytest.raises(ValueError, match="TP sharding requires unfused projections"):
        pm.cp_param_specs({"layers": {"qkv_proj": None}})
    host = thi.host_init_talker_params(0, TP_TALKER)
    packed = thi.to_device(thi.pack_linear_params(host, names=("q_proj",)), torch.float32, "cpu")
    with pytest.raises(ValueError, match="MLX-packed"):
        pm.shard_talker(packed, mesh)
    head_only = thi.to_device(dict(thi.pack_linear_params(host, names=("q_proj",)),
                                   layers=host["layers"]), torch.float32, "cpu")
    with pytest.raises(ValueError, match="MLX-packed"):  # the packed codec_head
        pm.shard_talker(head_only, mesh)


def test_make_mesh_checks():
    """The JAX checks (tp divides the devices), the default of every card
    (none here: it raises), a device named twice, the cache spec."""
    m = pm.make_mesh(["cpu"] * 8, tp=4)
    assert m.shape == {"dp": 2, "tp": 4} and m.home == torch.device("cpu")
    assert pm.make_mesh(["cpu"] * 4).shape == {"dp": 1, "tp": 4}
    assert m.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="not divisible by tp=4"):
        pm.make_mesh(["cpu"] * 6, tp=4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            pm.make_mesh()
    twice = pm.make_mesh(["cuda:0", "cuda", "cuda:1"], tp=1)
    assert twice.distinct_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert pm.cache_spec() == (None, "dp", "tp", None, None)
    assert pm.cache_spec(False, False) == (None,) * 5


# ---------------------------------------------------------------------------
# The per-device state of the kernels' wrappers (no card: device objects and
# stand-ins for the pinned flags and the streams)
# ---------------------------------------------------------------------------


def test_a_fault_on_device_1_surfaces_at_device_1s_turn(monkeypatch):
    """Each device has its own K1 and K2 fault flags: a flag set on device 1
    raises at device 1's turn and not at device 0's."""
    monkeypatch.setattr(tgen, "_TURNS", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"synchronize": lambda self: None})())
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    flags = {d: torch.zeros(1, dtype=torch.int32) for d in (d0, d1)}
    monkeypatch.setattr(cpk, "_err_flags", dict(flags))
    monkeypatch.setattr(tkk, "_err_flags", {d: torch.zeros(1, dtype=torch.int32)
                                            for d in (d0, d1)})
    with tgen.device_turn(d0):
        flags[d1].fill_(1)  # as card 1 writes it
    assert int(flags[d1][0]) == 1
    with pytest.raises(_cuda.BarrierTimeout, match="K2 persistent barrier timed out on cuda:1"):
        with tgen.device_turn(d1):
            pass
    assert int(flags[d1][0]) == 0
    tkk._err_flags[d1].fill_(1)
    with pytest.raises(_cuda.BarrierTimeout, match="K1"):
        with tgen.device_turn([d1, d0]):  # a TP group: both devices' flags are read
            pass


def test_turns_over_several_devices_take_them_in_index_order(monkeypatch):
    """Two callers taking the same two devices in opposite orders do not
    deadlock: a group's turns are taken in index order."""
    monkeypatch.setattr(tgen, "_TURNS", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"synchronize": lambda self: None})())
    monkeypatch.setattr(cpk, "_err_flags", {})
    monkeypatch.setattr(tkk, "_err_flags", {})
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    done = []

    def run(order):
        for _ in range(200):
            with tgen.device_turn(order):
                pass
        done.append(order)

    import sys

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # thread switches inside the turns' lock handling
    try:
        threads = [threading.Thread(target=run, args=(o,)) for o in ([d0, d1], [d1, d0]) * 4]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(done) == 8 and sorted(tgen._TURNS) == [0, 1]


def test_cuda_and_cuda0_share_one_entry(monkeypatch):
    """``cuda`` (the current card, 0 here) and ``cuda:0`` name one device:
    K3's merge counters and K1's persistent workspace keep one entry for
    both, and another card gets its own."""
    real_zeros, real_empty = torch.zeros, torch.empty
    monkeypatch.setattr(torch, "zeros", lambda *a, device=None, **k: real_zeros(*a, **k))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: real_empty(*a, **k))
    monkeypatch.setattr(attn, "_counters", {})
    monkeypatch.setattr(tkk, "_WORKSPACES", {})
    c = attn.head_counters(torch.device("cuda"), 8)
    assert attn.head_counters(torch.device("cuda", 0), 8) is c
    assert attn.head_counters(torch.device("cuda", 1), 8) is not c
    assert list(attn._counters) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    w = tkk._frame_workspace(torch.device("cuda"), 64, 32)
    assert tkk._frame_workspace(torch.device("cuda", 0), 64, 32) is w
    assert tkk._frame_workspace(torch.device("cuda", 1), 64, 32) is not w
    assert len(tkk._WORKSPACES) == 2


def test_wrappers_enqueue_on_their_operands_device(monkeypatch):
    """``_cuda.on_device`` makes the operands' device current and hands out
    that device's current stream; every wrapper of ops/ and tools/ that
    calls into the library launches inside it (no stream is taken from
    whichever device happens to be current)."""
    import pathlib

    entered, streams = [], []

    class _Dev:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            entered.append(self.d)

        def __exit__(self, *a):
            entered.append("exit")

    monkeypatch.setattr(torch.cuda, "device", _Dev)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: (streams.append(device),
                                             type("S", (), {"cuda_stream": 77})())[1])
    with _cuda.on_device(torch.device("cuda", 1)) as s:
        assert s == 77
    assert entered == [torch.device("cuda", 1), "exit"] and streams == [torch.device("cuda", 1)]
    root = pathlib.Path(_cuda.__file__).resolve().parents[1]
    calls = 0
    for path in list((root / "ops").glob("*.py")) + list((root / "tools").glob("*.py")):
        src = path.read_text()
        assert "stream_ptr" not in src, path
        n = src.count("lib.qt_") + src.count("library().qt_")
        if n and path.name != "_cuda.py":
            calls += n
            assert "_cuda.on_device(" in src, path
    assert calls >= 12


def test_dryrun_multichip_phases(monkeypatch):
    """The dry run's three phases (qwen3tts_tpu_torch/tools/dryrun_multichip.py)
    at its tiny widths on CPU meshes: TP generation and the vocoder, the
    continuous entry points under a (dp=2, tp=4) mesh, the dp path with
    per-request sampling; each makes frames. Its devices are the cards
    unless ``--cpu`` is given: without a card the default raises."""
    from qwen3tts_tpu_torch.tools import dryrun_multichip as dry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dry.mesh_devices(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dry.main(["2"])
    devices = dry.mesh_devices(8, cpu=True)
    assert dry.phase_a(pm.make_mesh(devices, tp=8)) >= 1
    assert min(dry.phase_b(pm.make_mesh(devices, tp=4), dry.TINY, torch.float32)) >= 1
    assert min(dry.phase_c(devices[:2], dry.TINY)) >= 1
