"""The PyTorch port as a package: it imports without JAX, its config copy
matches the JAX package's, its synthetic weights are byte-identical, and the
weight bridge round-trips JAX parameter trees bit for bit."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu import config as jcfg
from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.models import vocoder as jvc
from qwen3tts_tpu.ops.quant import quantize_decode_params_int8
from qwen3tts_tpu.utils import host_init as jhi
from qwen3tts_tpu_torch import config as tcfg
from qwen3tts_tpu_torch.ops.quant import Int8Linear
from qwen3tts_tpu_torch.utils import host_init as thi
from qwen3tts_tpu_torch.utils.convert import from_jax_params, to_numpy_tree

from test_models import TINY_CP, TINY_TALKER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUBMODULES = (
    "config", "tts",
    "models.talker", "models.code_predictor", "models.generate", "models.batch_generate",
    "models.vocoder",
    "ops.quant", "ops.norms", "ops.rope", "ops.sampling", "ops.conv", "ops.decode_blocks",
    "ops.talker_kernel", "ops.cp_kernel", "ops.cp_kernel_old", "ops._cuda", "ops.attention",
    "utils.host_init", "utils.convert", "utils.loader",
    "tools", "tools._card", "tools.exp_weight_stream", "tools.exp_tk_b1_ablate",
    "tools.exp_hbm_peak", "tools.exp_attn_forms", "tools.exp_int4_repack",
    "tools.exp_kv_append", "tools.exp_cpk",
)


def test_imports_every_module_without_jax():
    code = (
        "import importlib, sys\n"
        "import qwen3tts_tpu_torch\n"
        f"for m in {SUBMODULES!r}:\n"
        "    importlib.import_module('qwen3tts_tpu_torch.' + m)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(k.startswith('qwen3tts_tpu.') or k == 'qwen3tts_tpu' for k in sys.modules)\n"
        "assert 'safetensors' not in sys.modules, 'the loader imported safetensors'\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


CONFIG_CLASSES = (
    "SpeakerEncoderConfig", "CodePredictorConfig", "RopeScalingConfig", "TalkerConfig",
    "TokenizerDecoderConfig", "TokenizerEncoderConfig", "TokenizerConfig",
    "QuantizationConfig", "ModelConfig",
)


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_fields_and_defaults_match(name):
    a, b = getattr(jcfg, name), getattr(tcfg, name)
    fa = [(f.name, f.default, f.type) for f in dataclasses.fields(a)]
    fb = [(f.name, f.default, f.type) for f in dataclasses.fields(b)]
    assert fa == fb
    assert a.__dataclass_params__.frozen and b.__dataclass_params__.frozen
    # the JSON parsers agree on a non-default tree
    if name == "TalkerConfig":
        d = {"hidden_size": 64, "spk_id": {"Aiden": 7}, "rope_scaling": {"mrope_section": [3, 3, 2]},
             "code_predictor_config": {"hidden_size": 32}}
        assert dataclasses.asdict(a.from_dict(d)) == dataclasses.asdict(b.from_dict(d))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("which", ["talker", "code_predictor"])
def test_host_init_byte_equal(which):
    if which == "talker":
        a = jhi.host_init_talker_params(3, TINY_TALKER)
        b = thi.host_init_talker_params(3, TINY_TALKER)
    else:  # TINY_CP is narrower than the talker: covers small_to_mtp_projection
        a = jhi.host_init_cp_params(4, TINY_CP, TINY_TALKER.hidden_size)
        b = thi.host_init_cp_params(4, TINY_CP, TINY_TALKER.hidden_size)
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k
    # bf16 transfer: torch's cast equals the JAX package's ml_dtypes cast
    jd = jhi.to_device(a, jnp.bfloat16)
    td = thi.to_device(b, torch.bfloat16, "cpu")
    for (k, x), (_, y) in zip(_leaves(to_numpy_tree(td)), _leaves(jd)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), k


def _jax_trees():
    # numpy-built trees (eager jax.random inits compile op by op: ~30 s on CPU)
    tp = jhi.to_device(jhi.host_init_talker_params(0, TINY_TALKER), jnp.bfloat16)
    tp["layers"] = jtk.fuse_layer_projections(tp["layers"])
    tp = quantize_decode_params_int8(tp, "codec_head")
    cpp = jhi.to_device(
        jhi.host_init_cp_params(1, TINY_CP, TINY_TALKER.hidden_size), jnp.bfloat16
    )
    cpp = quantize_decode_params_int8(cpp, "lm_head")
    vcfg = jcfg.TokenizerDecoderConfig(
        latent_dim=32, codebook_dim=16, codebook_size=64, decoder_dim=64, hidden_size=16,
        intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, head_dim=8, semantic_codebook_size=128,
    )
    vp = jax.jit(lambda k: jvc.init_vocoder_params(k, vcfg, jnp.float32))(jax.random.PRNGKey(2))
    return {"talker": tp, "code_predictor": cpp, "vocoder": vp}


@pytest.fixture(scope="module")
def jax_trees():
    return _jax_trees()


def _as_numpy(tree):
    """JAX tree -> numpy tree, with the JAX Int8Linear as {"q", "scale"}."""
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_numpy(v) for v in tree)
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale)}
    return np.asarray(tree)


@pytest.mark.parametrize("which", ["talker", "code_predictor", "vocoder"])
def test_bridge_round_trips_bit_exact(jax_trees, which):
    tree = jax_trees[which]
    port = from_jax_params(tree, "cpu")
    if which != "vocoder":  # int8 weights arrive as the port's Int8Linear, bf16 as bf16
        assert isinstance(port["layers"]["o_proj"], Int8Linear)
        assert port["layers"]["o_proj"].q.dtype == torch.int8
        assert port["layers"]["input_layernorm"].dtype == torch.bfloat16
    back, ref = list(_leaves(to_numpy_tree(port))), list(_leaves(_as_numpy(tree)))
    assert [k for k, _ in back] == [k for k, _ in ref]
    for (k, x), (_, y) in zip(back, ref):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_vocoder_generator_init_matches_jax_tree(jax_trees):
    """The torch-Generator vocoder init builds the JAX init's tree and shapes."""
    vcfg = tcfg.TokenizerDecoderConfig(
        latent_dim=32, codebook_dim=16, codebook_size=64, decoder_dim=64, hidden_size=16,
        intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2, head_dim=8, semantic_codebook_size=128,
    )
    g = torch.Generator().manual_seed(0)
    port = thi.init_vocoder_params(g, vcfg, torch.float32, "cpu")
    a, b = list(_leaves(to_numpy_tree(port))), list(_leaves(_as_numpy(jax_trees["vocoder"])))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, k
