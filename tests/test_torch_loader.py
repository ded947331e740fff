"""The port's checkpoint loader (utils/loader.py) and
``Qwen3TTSModel.from_pretrained`` against the JAX package's, on the
raw-format directories that tests/synthetic_ckpt.py writes: a dense one and
an MLX int4 one (group 32).

Tolerances: loaded trees are equal bit for bit (packed words, scales and
biases byte-equal; dense values exact, the same f32 dequantization and one
round-to-nearest-even cast). Greedy f32 audio: the packed model against the
dequantized-at-load one within 1e-5, as tests/test_quant.py holds the JAX
package. Codes: greedy f32 codes equal, port against JAX; in bf16 the
port, teacher-forced on the JAX codes, puts every JAX code within 0.05
logit spreads of its best logit (tests/test_torch_generate.py's bound).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from qwen3tts_tpu.models import generate as jgen
from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.ops import quant as jq
from qwen3tts_tpu.tts import Qwen3TTSModel as JModel
from qwen3tts_tpu.utils.loader import Checkpoint as JCheckpoint
from qwen3tts_tpu_torch.models import generate as tgen
from qwen3tts_tpu_torch.ops.quant import Int8Linear, PackedLinear
from qwen3tts_tpu_torch.tts import Qwen3TTSError
from qwen3tts_tpu_torch.tts import Qwen3TTSModel as TModel
from qwen3tts_tpu_torch.utils import host_init as thi
from qwen3tts_tpu_torch.utils import loader as tl
from qwen3tts_tpu_torch.utils.convert import to_numpy_tree

from synthetic_ckpt import StubTokenizer, write_checkpoint
from test_torch_generate import _inputs, _replay_gaps, _tiny_model_configs


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {
        "dense": write_checkpoint(str(tmp_path_factory.mktemp("dense"))),
        "int4": write_checkpoint(str(tmp_path_factory.mktemp("int4")), quantize=True),
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _jax_numpy(tree):
    """A JAX tree as numpy, its PackedLinear and Int8Linear as the dicts
    ``to_numpy_tree`` makes of the port's."""
    if isinstance(tree, dict):
        return {k: _jax_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_numpy(v) for v in tree)
    if hasattr(tree, "scales"):
        return {"q": np.asarray(tree.q), "scales": np.asarray(tree.scales),
                "biases": np.asarray(tree.biases), "bits": tree.bits, "group": tree.group}
    if hasattr(tree, "scale"):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale)}
    return np.asarray(tree)


def _assert_trees_equal(port_tree, jax_tree):
    a, b = list(_leaves(to_numpy_tree(port_tree))), list(_leaves(_jax_numpy(jax_tree)))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    rs = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rs.standard_normal((3, 5)).astype(np.float32)),
        "bf16": torch.from_numpy(rs.standard_normal((4, 2)).astype(np.float32)).bfloat16(),
        "u32": torch.from_numpy(rs.integers(0, 2**31, (2, 3)).astype(np.int64)).to(torch.int32),
        "i64": torch.arange(7),
        "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = tl.read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for k, t in tensors.items():
        want = t.float().numpy() if k == "bf16" else t.numpy()
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        assert got[k].tobytes() == want.tobytes(), k
    del tensors["bf16"]  # the package's numpy loader takes no bf16
    save_file(tensors, path)
    ref = load_file(path)
    for k, v in tl.read_safetensors(path).items():
        assert v.tobytes() == ref[k].tobytes() and v.dtype == ref[k].dtype, k


@pytest.mark.parametrize("which,keep_packed", [("dense", None), ("int4", None), ("int4", False)],
                         ids=["dense", "int4_packed", "int4_dequantized"])
def test_checkpoint_trees_equal_jax(dirs, which, keep_packed):
    j = JCheckpoint(dirs[which], jnp.bfloat16, keep_packed=keep_packed)
    t = tl.Checkpoint(dirs[which], torch.bfloat16, keep_packed=keep_packed)
    if which == "int4" and keep_packed is None:  # packed by default on a quantized checkpoint
        assert isinstance(t.talker_params["layers"]["q_proj"], PackedLinear)
        assert isinstance(t.cp_params["lm_head"], PackedLinear)
        assert isinstance(t.cp_params["small_to_mtp_projection"]["w"], PackedLinear)
    for attr in ("talker_params", "cp_params", "vocoder_params", "encoder_params",
                 "speaker_encoder_params"):
        _assert_trees_equal(getattr(t, attr), getattr(j, attr))
    assert repr(t.config) == repr(j.config)


def _jax_int8_eager(path):
    """The JAX package's quantize='int8' load with each weight quantized by
    the eager ``quantize_int8`` (from_pretrained jits it, see below)."""
    ck = JCheckpoint(path, jnp.bfloat16, keep_packed=False)
    out = []
    for params, head in ((ck.talker_params, "codec_head"), (ck.cp_params, "lm_head")):
        layers = jtk.fuse_layer_projections(params["layers"])
        for k in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
            layers[k] = jq.quantize_int8(layers[k])
        out.append(dict(params, layers=layers, **{head: jq.quantize_int8(params[head])}))
    return out


def test_from_pretrained_int8_equal_jax(dirs):
    """quantize='int8' on the int4 checkpoint: dequantize, fuse, requantize.
    Bit-equal to the JAX package's eager quantize_int8. Its from_pretrained
    jits the quantization, and XLA's division there rounds differently:
    its int8 values differ by 1 at a few elements (<= 0.1 %) and its scales
    by an ulp, which is all this test allows against it."""
    with pytest.warns(UserWarning, match="tokenizer"):
        tm = TModel.from_pretrained(dirs["int4"], dtype=torch.bfloat16, quantize="int8", device="cpu")
    assert isinstance(tm.talker_params["layers"]["qkv_proj"], Int8Linear)
    assert isinstance(tm.cp_params["lm_head"], Int8Linear)
    assert tm.tokenizer is None
    jt, jc = _jax_int8_eager(dirs["int4"])
    _assert_trees_equal(tm.talker_params, jt)
    _assert_trees_equal(tm.cp_params, jc)
    jm = JModel.from_pretrained(dirs["int4"], dtype=jnp.bfloat16, quantize="int8")
    for port, ref in ((tm.talker_params["codec_head"], jm.talker_params["codec_head"]),
                      (tm.cp_params["lm_head"], jm.cp_params["lm_head"])):
        dq = np.abs(port.q.numpy().astype(np.int32) - np.asarray(ref.q, np.int32))
        assert dq.max() <= 1 and dq.mean() <= 1e-3
        np.testing.assert_allclose(port.scale.numpy(), np.asarray(ref.scale), rtol=2**-22)


def test_from_pretrained_refuses_unported_options(dirs):
    for kw in (dict(quantize="int4"), dict(mesh=object()), dict(kv_cache_dtype="fp8")):
        with pytest.raises(Qwen3TTSError):
            TModel.from_pretrained(dirs["int4"], device="cpu", **kw)


def _port_model(path, keep_packed, dtype=torch.float32):
    with pytest.warns(UserWarning, match="tokenizer"):
        m = TModel.from_pretrained(path, dtype=dtype, keep_packed=keep_packed, device="cpu")
    m.tokenizer = StubTokenizer()
    # JAX's gathers clamp out-of-range ids, torch's raise: the tts special ids
    # go inside the tiny 512-entry text vocabulary, and the vocoder gets full
    # 2048-entry codebooks (the same seeded weights in every model)
    m.config = dataclasses.replace(m.config, tts_bos_token_id=500, tts_eos_token_id=501,
                                   tts_pad_token_id=502)
    m.tokenizer_config = _tiny_model_configs(False)[1]
    m.vocoder_params = thi.init_vocoder_params(
        torch.Generator().manual_seed(2), m.tokenizer_config.decoder_config, torch.float32, "cpu")
    return m


def test_packed_generation_matches_dequantized(dirs):
    """Greedy f32 audio: packed weights (CPU: plain quant_matmul) against the
    same checkpoint dequantized at load (tests/test_quant.py:98-106)."""
    packed, dense = _port_model(dirs["int4"], True), _port_model(dirs["int4"], False)
    assert isinstance(packed.talker_params["codec_head"], PackedLinear)
    assert not isinstance(dense.talker_params["codec_head"], PackedLinear)
    kw = dict(speaker="Aiden", temperature=0.0, max_tokens=5, seed=0)
    a1, a2 = packed.generate("Packed test", **kw), dense.generate("Packed test", **kw)
    assert a1.shape == a2.shape and np.isfinite(a1).all()
    np.testing.assert_allclose(a1, a2, atol=1e-5)


GREEDY_J = jgen.SamplingConfig(0.0, 50, 1.0, 1.0, forbid_eos=True)
GREEDY_T = tgen.SamplingConfig(0.0, 50, 1.0, 1.0, forbid_eos=True)


def _codes_both(path, jdt, tdt, frames):
    j = JCheckpoint(path, jdt)  # packed (default on a quantized checkpoint)
    t = tl.Checkpoint(path, tdt)
    cfg = t.config.talker_config
    prefill, plen, trailing, tlen, pad = _inputs(cfg.hidden_size)
    rj = jgen.generate_codes(
        j.talker_params, j.cp_params, talker_cfg=j.config.talker_config,
        cp_cfg=j.config.talker_config.code_predictor_config, sampling=GREEDY_J,
        prefill_embeds=jnp.asarray(prefill, jdt), prefill_len=jnp.int32(plen),
        trailing_embeds=jnp.asarray(trailing, jdt), trailing_len=jnp.int32(tlen),
        tts_pad_embed=jnp.asarray(pad, jdt),
        cache=jtk.make_cache(j.config.talker_config, 1, 128, jdt),
        max_steps=jnp.int32(frames), max_frames=12, key=__import__("jax").random.PRNGKey(0),
    )
    return rj, t, cfg, (prefill, plen, trailing, tlen, pad)


def test_packed_codes_match_jax_f32(dirs):
    rj, t, cfg, (prefill, plen, trailing, tlen, pad) = _codes_both(
        dirs["int4"], jnp.float32, torch.float32, 8)
    T = lambda a: torch.from_numpy(a)
    rt = tgen.generate_codes(
        t.talker_params, t.cp_params, talker_cfg=cfg, cp_cfg=cfg.code_predictor_config,
        sampling=GREEDY_T, prefill_embeds=T(prefill), prefill_len=plen, trailing_embeds=T(trailing),
        trailing_len=tlen, tts_pad_embed=T(pad), max_steps=8, max_frames=12, seed=0, cache_len=128,
    )
    assert rt.n_frames == int(rj.n_frames) == 8
    assert (rt.codes.numpy() == np.asarray(rj.codes)).all()


def test_packed_codes_teacher_forced_bf16(dirs):
    """bf16 packed weights: the port, fed the JAX codes, finds each of them
    within 0.05 logit spreads of its best logit (most exactly the argmax)."""
    rj, t, cfg, _ = _codes_both(dirs["int4"], jnp.bfloat16, torch.bfloat16, 6)
    assert int(rj.n_frames) == 6
    gaps = _replay_gaps(t.talker_params, t.cp_params, cfg, cfg.code_predictor_config,
                        np.asarray(rj.codes), 6)
    assert max(gaps) <= 0.05, max(gaps)
    assert sum(g == 0.0 for g in gaps) >= 0.9 * len(gaps)

