"""Golden-value integration tests of the port against REAL checkpoints
(env-gated; the counterpart of tests/test_golden_checkpoint.py).

Resource paths come from the same variables, and every test skips cleanly
when they are absent:

  QWEN3_TTS_VOICEDESIGN_MODEL_PATH  - VoiceDesign checkpoint dir
  QWEN3_TTS_BASE_MODEL_PATH         - Base checkpoint dir (encoder weights)
  QWEN3_TTS_REFERENCE_AUDIO_PATH    - 24 kHz reference WAV for cloning

Models load through the port's ``from_pretrained``: on the CUDA card where
one is present, else on the CPU. The decode test pushes the reference's
fixed [5, 16] code matrix (its golden test) through the vocoder and holds
the same per-stage statistics as the JAX test (quantizer std ~12.89, min
~-81.56, audio std ~0.1712, pinned from the Python implementation).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

requires_vd = pytest.mark.skipif(
    not os.environ.get("QWEN3_TTS_VOICEDESIGN_MODEL_PATH"),
    reason="QWEN3_TTS_VOICEDESIGN_MODEL_PATH not set",
)
requires_base = pytest.mark.skipif(
    not os.environ.get("QWEN3_TTS_BASE_MODEL_PATH"),
    reason="QWEN3_TTS_BASE_MODEL_PATH not set",
)

# fixed codes from the reference golden test, as tests/test_golden_checkpoint.py
GOLDEN_CODES = np.array(
    [
        [1342, 313, 975, 826, 309, 933, 1642, 28, 782, 1965, 1680, 1507, 258, 1349, 828, 1102],
        [1014, 17, 2016, 285, 1712, 470, 543, 176, 1087, 1963, 588, 1860, 889, 1874, 1121, 1319],
        [1119, 1122, 594, 89, 770, 1644, 331, 242, 1183, 1676, 129, 96, 123, 1840, 661, 285],
        [1119, 1135, 215, 1377, 88, 1611, 904, 1274, 1895, 1872, 1246, 335, 1141, 320, 694, 242],
        [46, 1952, 1023, 1871, 596, 491, 757, 422, 692, 683, 651, 395, 1235, 1300, 618, 1498],
    ],
    dtype=np.int32,
)


def _load(path_env):
    from qwen3tts_tpu_torch.tts import Qwen3TTSModel

    device = "cuda" if torch.cuda.is_available() else "cpu"
    return Qwen3TTSModel.from_pretrained(os.environ[path_env], device=device)


@requires_vd
class TestGoldenDecode:
    def test_speech_tokenizer_decode_stage_stats(self):
        """Fixed [5, 16] codes -> per-stage stats matching the Python
        implementation."""
        from qwen3tts_tpu_torch.models import vocoder as vc

        model = _load("QWEN3_TTS_VOICEDESIGN_MODEL_PATH")
        cfg = model.tokenizer_config.decoder_config
        codes = torch.from_numpy(GOLDEN_CODES)[None].to(model.device)  # [1, 5, 16]

        q = vc.rvq_decode(model.vocoder_params, cfg, codes).float().cpu().numpy()
        print(f"quantizer: std={q.std():.4f} min={q.min():.4f} (python: 12.889, -81.556)")
        assert q.std() > 10.0, "quantizer.decode std should be ~12.89"
        assert abs(q.min() + 81.5) < 5.0, "quantizer.decode min should be ~-81.56"

        wav, lengths = vc.decode(model.vocoder_params, cfg, codes)
        wav_np = wav[0].float().cpu().numpy()
        assert tuple(wav.shape) == (1, 5 * 1920)
        assert int(lengths[0]) == 5 * 1920
        # python final stats: min=-0.5261 max=0.5532 std=0.1712
        print(f"audio: min={wav_np.min():.4f} max={wav_np.max():.4f} std={wav_np.std():.4f}")
        assert abs(wav_np.std() - 0.1712) < 0.05

    def test_generate_voice_design_end_to_end(self):
        model = _load("QWEN3_TTS_VOICEDESIGN_MODEL_PATH")
        audio = model.generate(
            "Hello, this is a test of the text to speech model.",
            instruct="A clear female voice with a warm and friendly tone.",
            max_tokens=300,
        )
        assert audio.shape[0] > 0

    def test_stream_events(self):
        model = _load("QWEN3_TTS_VOICEDESIGN_MODEL_PATH")
        events = list(
            model.generate_stream(
                "Streaming test.",
                instruct="A calm narrator voice.",
                max_tokens=150,
            )
        )
        kinds = [type(e).__name__ for e in events]
        assert kinds[-2:] == ["InfoEvent", "AudioEvent"]
        assert len(kinds) > 2


@requires_base
class TestGoldenEncoder:
    def test_encode_dummy_audio(self):
        """Encoder availability and the codes' shape and range."""
        from qwen3tts_tpu_torch.models import encoder as enc

        model = _load("QWEN3_TTS_BASE_MODEL_PATH")
        assert model.encoder_params is not None
        audio = torch.from_numpy(
            np.random.RandomState(0).randn(1, 24000).astype(np.float32) * 0.1
        ).to(model.device)
        tok = model.tokenizer_config
        codes = enc.encode(model.encoder_params, tok.encoder_config, audio,
                           tok.encoder_valid_num_quantizers)
        assert codes.shape[1] == 16
        c = codes.cpu().numpy()
        assert (c >= 0).all() and (c < 2048).all()

    def test_voice_clone_with_reference(self):
        ref_path = os.environ.get("QWEN3_TTS_REFERENCE_AUDIO_PATH")
        if not ref_path:
            pytest.skip("QWEN3_TTS_REFERENCE_AUDIO_PATH not set")
        from qwen3tts_tpu_torch.utils.audio import load_wav

        model = _load("QWEN3_TTS_BASE_MODEL_PATH")
        sr, ref = load_wav(ref_path)
        assert sr == 24000
        audio = model.generate_voice_clone(
            "Cloning test sentence.",
            reference_audio=ref,
            reference_text="This is the reference transcript.",
            max_tokens=200,
        )
        assert audio.shape[0] > 0
