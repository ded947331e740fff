"""Port vocoder against the JAX package's ``vocoder.decode`` in float32, at
a small configuration, including the valid-frames
masking that makes bucketed decode exact on its prefix.

Tolerance: max|a - b| / max(1, max|pre-clip signal|) <= 1e-5, float32
rounding through the conv stack. The clipped audio inherits its error from
the pre-clip decoder output (|x| ~ 20 here), so it is scaled by that signal,
as tests/test_numpy_oracle.py does for the audio stage.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu.config import TokenizerDecoderConfig as JCfg
from qwen3tts_tpu.models import vocoder as jvc
from qwen3tts_tpu_torch.config import TokenizerDecoderConfig as TCfg
from qwen3tts_tpu_torch.models import vocoder as tvc
from qwen3tts_tpu_torch.ops.conv import causal_conv1d, causal_conv1d_transpose
from qwen3tts_tpu_torch.utils.convert import from_jax_params

SMALL = dict(  # narrow widths, 2 transformer layers, the default upsampling
    latent_dim=64, codebook_dim=32, decoder_dim=128, hidden_size=32, intermediate_size=64,
    num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2, head_dim=16,
)
F32_TOL = 1e-5


def scaled(a, b, signal) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(np.asarray(signal)).max()))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = JCfg(**SMALL), TCfg(**SMALL)
    jp = jax.jit(lambda k: jvc.init_vocoder_params(k, jcfg, jnp.float32))(jax.random.PRNGKey(2))
    # non-trivial snake parameters, so the activation's alpha/beta paths count
    blk = jp["decoder"]["blocks"][0]["res1"]["act1"]
    blk["alpha"] = jnp.linspace(-0.5, 0.5, blk["alpha"].shape[0])
    blk["beta"] = jnp.linspace(0.3, -0.3, blk["beta"].shape[0])
    rng = np.random.default_rng(0)
    codes = np.concatenate(
        [rng.integers(0, 4096, (1, 12, 1)), rng.integers(0, 2048, (1, 12, 15))], axis=-1
    ).astype(np.int32)
    codes[0, 4, 0] = 0  # a frame with code 0 does not count as valid
    tp = from_jax_params(jp, "cpu")
    return jcfg, tcfg, jp, tp, codes, _pre_clip(tp, tcfg, codes)


def _pre_clip(tp, tcfg, codes):
    """The decoder's output before the final clip (the port's stages)."""
    h = tvc.rvq_decode(tp, tcfg, torch.from_numpy(codes))
    h = causal_conv1d(h, tp["pre_conv"]["w"], tp["pre_conv"]["b"])
    h = tvc.pre_transformer(tp["pre_transformer"], tcfg, h)
    for stage, ratio in zip(tp["upsample"], tcfg.upsampling_ratios):
        h = causal_conv1d_transpose(h, stage["conv"]["w"], stage["conv"]["b"], stride=ratio)
        h = tvc.convnext_block(stage["convnext"], h)
    return tvc.main_decoder(tp["decoder"], tcfg, h).numpy()


def test_decode_matches_f32(setup):
    jcfg, tcfg, jp, tp, codes, signal = setup
    wj, lj = jvc.decode(jp, jcfg, jnp.asarray(codes))
    wt, lt = tvc.decode(tp, tcfg, torch.from_numpy(codes))
    assert wt.shape == (1, 12 * 1920) and wt.dtype == torch.float32
    assert scaled(wt.numpy(), wj, signal) <= F32_TOL
    assert lt.tolist() == np.asarray(lj).tolist() == [11 * 1920]


def test_bucketed_prefix_is_exact(setup):
    """Decoding 7 valid frames inside a 12-frame bucket equals decoding the
    7 frames alone on their prefix, and matches JAX's bucketed decode."""
    jcfg, tcfg, jp, tp, codes, signal = setup
    n = 7
    padded = codes.copy()
    padded[:, n:] = 1234 % 2048  # junk past the valid frames
    wt_b, lt_b = tvc.decode(tp, tcfg, torch.from_numpy(padded), n)
    wt_n, _ = tvc.decode(tp, tcfg, torch.from_numpy(codes[:, :n]))
    assert scaled(wt_b[:, : n * 1920].numpy(), wt_n.numpy(), signal) <= F32_TOL
    wj_b, lj_b = jvc.decode(jp, jcfg, jnp.asarray(padded), jnp.int32(n))
    assert scaled(wt_b[:, : n * 1920].numpy(), np.asarray(wj_b)[:, : n * 1920], signal) <= F32_TOL
    assert lt_b.tolist() == np.asarray(lj_b).tolist() == [(n - 1) * 1920]


@pytest.mark.parametrize("cudnn_tf32,matmul_tf32", [(True, True), (False, True), (True, False)])
def test_decode_restores_tf32_flags(setup, cudnn_tf32, matmul_tf32):
    """decode turns TF32 off only for itself: the caller's flags come back."""
    _, tcfg, _, tp, codes, _ = setup
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        tvc.decode(tp, tcfg, torch.from_numpy(codes[:, :2]))
        assert torch.backends.cudnn.allow_tf32 is cudnn_tf32
        assert torch.backends.cuda.matmul.allow_tf32 is matmul_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_per_row_frames_match_jax(setup):
    """frames [B] per row (the batched decode's ragged utterances): each row
    masked to its own valid frames, as JAX's decode does, and each row's
    prefix equal to decoding that row alone."""
    jcfg, tcfg, jp, tp, codes, signal = setup
    batch = np.concatenate([codes, codes[:, ::-1].copy()], axis=0)  # [2, 12, 16]
    frames = np.array([7, 10], np.int32)
    wt, lt = tvc.decode(tp, tcfg, torch.from_numpy(batch), torch.from_numpy(frames))
    wj, lj = jvc.decode(jp, jcfg, jnp.asarray(batch), jnp.asarray(frames))
    assert scaled(wt.numpy(), np.asarray(wj), signal) <= F32_TOL
    assert lt.tolist() == np.asarray(lj).tolist()
    for b, n in enumerate(frames):
        alone, _ = tvc.decode(tp, tcfg, torch.from_numpy(batch[b : b + 1]), int(n))
        assert scaled(wt[b, : n * 1920].numpy(), alone[0, : n * 1920].numpy(), signal) <= F32_TOL
