"""Voice cloning in the port (qwen3tts_tpu_torch: ops/conv.py
``streamable_conv1d``, models/encoder.py, models/speaker_encoder.py, the two
loaders of utils/loader.py, ``Qwen3TTSModel.generate_voice_clone``) against
the JAX package, on the CPU.

The encoders' weights come from the port's ``torch.Generator`` builders
(utils/host_init.py, whose trees match the JAX builders' in paths, shapes and
dtypes) and are copied into JAX arrays; the clone runs on
tests/synthetic_ckpt.py's directory loaded by both packages' ``Checkpoint``
(the same numpy weights). f32 bound: max|a - b| / max(1, max|b|) <= 1e-5
(tests/test_numpy_oracle.py); the codes, the frame count and the greedy
tokens equal; the waveform within ``1e-5 * 40`` (the bound of
test_model_generate_matches_jax_greedy).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu import config as jcfg
from qwen3tts_tpu.models import encoder as jenc
from qwen3tts_tpu.models import speaker_encoder as jspk
from qwen3tts_tpu.ops import conv as jconv
from qwen3tts_tpu.tts import Qwen3TTSModel as JModel
from qwen3tts_tpu.utils.loader import Checkpoint as JCheckpoint
from qwen3tts_tpu_torch import config as tcfg
from qwen3tts_tpu_torch import tts as ttts
from qwen3tts_tpu_torch.models import encoder as tenc
from qwen3tts_tpu_torch.models import speaker_encoder as tspk
from qwen3tts_tpu_torch.ops import conv as tconv
from qwen3tts_tpu_torch.utils import host_init as thi
from qwen3tts_tpu_torch.utils.loader import Checkpoint as TCheckpoint

from synthetic_ckpt import TINY_CONFIG, TINY_ST_CONFIG, StubTokenizer, write_checkpoint
from test_torch_generate import _tiny_model_configs

ENC = dict(TINY_ST_CONFIG["encoder_config"], upsampling_ratios=(8, 6, 5, 4))
SPK = dict(TINY_CONFIG["speaker_encoder_config"])
for k in ("enc_channels", "enc_kernel_sizes", "enc_dilations"):
    SPK[k] = tuple(SPK[k])
J_ENC, T_ENC = jcfg.TokenizerEncoderConfig(**ENC), tcfg.TokenizerEncoderConfig(**ENC)
J_SPK, T_SPK = jcfg.SpeakerEncoderConfig(**SPK), tcfg.SpeakerEncoderConfig(**SPK)
BOUND = 1e-5 * 40


def scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _audio(seed, n=24000):
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def enc_params():
    """The port's builder's tree (drawing it with jax.random takes tens of
    seconds at these shapes) and its JAX copy."""
    tp = thi.init_encoder_params(torch.Generator().manual_seed(0), T_ENC)
    return _to_jax(tp), tp


@pytest.fixture(scope="module")
def spk_params():
    tp = thi.init_speaker_encoder_params(torch.Generator().manual_seed(1), T_SPK)
    return _to_jax(tp), tp


@pytest.mark.parametrize("T", [29, 30, 31, 32, 64, 100])
@pytest.mark.parametrize("stride,dilation,causal,pad_mode", [
    (4, 1, True, "constant"), (1, 1, True, "constant"), (1, 3, False, "constant"),
    (2, 1, True, "edge"),
])
def test_streamable_conv1d_matches_jax(T, stride, dilation, causal, pad_mode):
    """``streamable_conv1d`` at tests/test_conv.py's shapes (k 8 at stride
    4 and k 7 at stride 1; a dilated centred form and the edge-padded
    downsample besides), within the f32 bound; the strided conv consumes
    the input exactly."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((1, T, 4)).astype(np.float32)
    k = 8 if stride == 4 else 7 if stride == 1 else 4
    w = rng.standard_normal((k, 4, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    kw = dict(stride=stride, dilation=dilation, causal=causal, pad_mode=pad_mode)
    want = np.asarray(jconv.streamable_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw))
    got = tconv.streamable_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                  **kw).numpy()
    assert got.shape == want.shape
    if stride == 4:
        assert got.shape[1] == -(-T // 4)
    assert scaled(got, want) <= 1e-5


def test_encoder_stages_match_jax(enc_params):
    """SEANet and the causal transformer within the f32 bound; the split RVQ
    codes and ``encode``'s equal (no near-tie at this seed)."""
    jp, tp = enc_params
    audio = np.stack([_audio(2, 3 * 24000), _audio(3, 3 * 24000)])
    x = audio[..., None]
    hj = np.array(jenc.seanet_encoder(jp["seanet"], J_ENC, jnp.asarray(x)))
    ht = tenc.seanet_encoder(tp["seanet"], T_ENC, torch.from_numpy(x))
    assert ht.shape == hj.shape and scaled(ht.numpy(), hj) <= 1e-5
    tj = np.array(jenc.encoder_transformer(jp["transformer"], J_ENC, jnp.asarray(hj)))
    tt = tenc.encoder_transformer(tp["transformer"], T_ENC, torch.from_numpy(hj))
    assert scaled(tt.numpy(), tj) <= 1e-5
    cj = np.asarray(jenc.split_rvq_encode(jp["quantizer"], J_ENC, jnp.asarray(tj)))
    ct = tenc.split_rvq_encode(tp["quantizer"], T_ENC, torch.from_numpy(tj))
    assert ct.dtype == torch.int32 and np.array_equal(ct.numpy(), cj)
    codes_j = np.asarray(jenc.encode(jp, J_ENC, jnp.asarray(audio)))
    codes_t = tenc.encode(tp, T_ENC, torch.from_numpy(audio))
    assert codes_t.shape == codes_j.shape == (2, 16, 38)
    assert np.array_equal(codes_t.numpy(), codes_j)


def test_speaker_encoder_matches_jax(spk_params):
    """The log-mel spectrogram (framed rFFT) and the x-vector within the f32
    bound."""
    jp, tp = spk_params
    audio = _audio(4, 3 * 24000)
    mj = np.asarray(jspk.mel_spectrogram(jnp.asarray(audio), num_mels=J_SPK.mel_dim))
    mt = tspk.mel_spectrogram(torch.from_numpy(audio), num_mels=T_SPK.mel_dim)
    assert mt.shape == mj.shape and scaled(mt.numpy(), mj) <= 1e-5
    np.testing.assert_array_equal(tspk.mel_filterbank(1024, 128, 24000, 0.0, 12000.0),
                                  jspk.mel_filterbank(1024, 128, 24000, 0.0, 12000.0))
    ej = np.asarray(jspk.extract_embedding(jp, J_SPK, jnp.asarray(audio)))
    et = tspk.extract_embedding(tp, T_SPK, torch.from_numpy(audio))
    assert et.shape == ej.shape == (1, J_SPK.enc_dim)
    assert scaled(et.numpy(), ej) <= 1e-5


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _same_tree(t, j):
    tl, jl = list(_leaves(t)), list(_leaves(j))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (p, a), (_, b) in zip(tl, jl):
        assert a.dtype == torch.float32, p
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=p)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = write_checkpoint(str(tmp_path_factory.mktemp("clone_ckpt")))
    return JCheckpoint(d, jnp.float32), TCheckpoint(d, torch.float32)


def test_loaders_match_jax_checkpoint(ckpts):
    """``load_encoder`` and ``load_speaker_encoder`` through ``Checkpoint``:
    the JAX Checkpoint's trees, leaf for leaf."""
    jc, tc = ckpts
    assert tc.encoder_params is not None and tc.speaker_encoder_params is not None
    _same_tree(tc.encoder_params, jc.encoder_params)
    _same_tree(tc.speaker_encoder_params, jc.speaker_encoder_params)


def test_host_init_builders_match_the_jax_trees():
    """``init_encoder_params`` / ``init_speaker_encoder_params`` build the
    JAX builders' trees: the same paths, shapes and dtypes."""
    for t, j in (
        (thi.init_encoder_params(torch.Generator().manual_seed(0), T_ENC),
         jax.eval_shape(lambda: jenc.init_encoder_params(jax.random.PRNGKey(0), J_ENC))),
        (thi.init_speaker_encoder_params(torch.Generator().manual_seed(0), T_SPK),
         jax.eval_shape(lambda: jspk.init_speaker_encoder_params(jax.random.PRNGKey(0), J_SPK))),
    ):
        tl, jl = list(_leaves(t)), list(_leaves(j))
        assert [p for p, _ in tl] == [p for p, _ in jl]
        for (p, a), (_, b) in zip(tl, jl):
            assert tuple(a.shape) == tuple(b.shape) and str(a.dtype)[6:] == str(b.dtype), p


def test_generate_voice_clone_matches_jax_greedy(ckpts):
    """Greedy ``generate_voice_clone`` of both packages on the same
    checkpoint: the same ICL prompt, frame count and tokens, the waveform
    within the f32 bound; and the speaker embedding."""
    jc, tc = ckpts
    # JAX's gathers clamp out-of-range ids, torch's raise: the tts special ids
    # go inside the stub tokenizer's 512-entry text vocabulary, and both
    # models get one vocoder with full 2048-entry codebooks
    ids = dict(tts_bos_token_id=500, tts_eos_token_id=501, tts_pad_token_id=502)
    dec_j, dec_t = (_tiny_model_configs(side)[1].decoder_config for side in (True, False))
    voc = thi.init_vocoder_params(torch.Generator().manual_seed(2), dec_t)
    common = dict(tokenizer=StubTokenizer())
    jm = JModel(dataclasses.replace(jc.config, **ids), jc.talker_params, jc.cp_params,
                _to_jax(voc),
                tokenizer_config=dataclasses.replace(jc.tokenizer_config, decoder_config=dec_j),
                encoder_params=jc.encoder_params,
                speaker_encoder_params=jc.speaker_encoder_params, dtype=jnp.float32, **common)
    tm = ttts.Qwen3TTSModel(dataclasses.replace(tc.config, **ids), tc.talker_params,
                            tc.cp_params, voc,
                            tokenizer_config=dataclasses.replace(tc.tokenizer_config,
                                                                 decoder_config=dec_t),
                            encoder_params=tc.encoder_params,
                            speaker_encoder_params=tc.speaker_encoder_params, dtype=torch.float32,
                            device="cpu", **common)
    assert tm.has_voice_cloning and tm.supports_voice_cloning == jm.supports_voice_cloning
    ref = _audio(5, 24000)
    ej, _, _, rj = jm._prepare_icl_generation_inputs("Clone my voice", ref, "a transcript")
    et, _, _, rt = tm._prepare_icl_generation_inputs("Clone my voice", ref, "a transcript")
    assert np.array_equal(rt.numpy(), np.asarray(rj))
    assert et.shape == ej.shape and scaled(et.numpy(), np.asarray(ej)) <= 1e-5
    kw = dict(reference_audio=ref, reference_text="a transcript", temperature=0.0, max_tokens=6,
              seed=0)
    got_t, got_j = [], []
    wt = tm.generate_voice_clone("Clone my voice", on_token=got_t.append, **kw)
    wj = np.asarray(jm.generate_voice_clone("Clone my voice", on_token=got_j.append, **kw))
    assert got_t == got_j and len(got_t) == tm.last_info.generation_token_count
    assert wt.shape == wj.shape and np.isfinite(wt).all()
    assert np.abs(wt - wj).max() <= BOUND
    np.testing.assert_array_equal(wt, tm.generate_voice_clone("Clone my voice", **kw))
    xv = tm.extract_speaker_embedding(ref)
    assert xv.shape == (1, 64) and scaled(xv.numpy(), np.asarray(jm.extract_speaker_embedding(ref))) <= 1e-5
    with pytest.raises(ttts.Qwen3TTSError, match="24kHz"):
        tm.extract_speaker_embedding(ref, sample_rate=16000)
