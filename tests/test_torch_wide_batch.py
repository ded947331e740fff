"""The lockstep decode past 64 rows, on the CPU: the port's plain lockstep
against the JAX package's ``generate_codes_batch`` at B = 70, and
``generate_batch`` of 70 texts as one lockstep at ``seed``.

K1 and K2 take up to MAX_BATCH (256) rows on the card; on the CPU the
lockstep runs their plain versions, which take any batch. Tolerances:

* greedy codes, tokens and frame counts of the two packages: equal
  (tests/test_torch_batch.py's bound at B = 2, here at a batch past the old
  64-row cap);
* ``generate_batch``'s codes: equal to one ``generate_codes_batch`` call of
  all 70 rows at ``seed`` (the same plain sampler and generator), and the
  last row's unlike a second group's at ``seed + 1``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from qwen3tts_tpu.models import batch_generate as jbg
from qwen3tts_tpu.models import talker as jtk
from qwen3tts_tpu.utils import host_init as jhi
from qwen3tts_tpu_torch import tts as ttts
from qwen3tts_tpu_torch.models import batch_generate as tbg
from qwen3tts_tpu_torch.models import talker as ttk
from qwen3tts_tpu_torch.ops import talker_kernel as tkk
from qwen3tts_tpu_torch.utils.convert import from_jax_params

from test_models import TINY_CP, TINY_TALKER
from test_torch_batch import GREEDY_J, GREEDY_T, _models

H = TINY_TALKER.hidden_size
B = 70  # past the 64 rows one K1 / K2 call took before


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny shapes (the suite's workers share
    the cores; the setting is restored after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def port_model():
    """tests/test_torch_batch.py's tiny pair; the port's model (f32, CPU)."""
    return _models()[1]


def test_max_batch_is_256():
    assert ttts.MAX_BATCH == tkk.MAX_BATCH == 256 and B <= ttts.MAX_BATCH


def test_lockstep_past_64_rows_matches_jax():
    """B = 70 rows, greedy, ragged prompts (3-8 rows), trailing streams (1-5)
    and caps (2-6): codes, tokens and frame counts equal JAX's."""
    rng = np.random.default_rng(70)
    plens = rng.integers(3, 9, B).tolist()
    tlens = rng.integers(1, 6, B).tolist()
    caps = rng.integers(2, 7, B).tolist()
    prefill = (rng.standard_normal((B, 8, H)) * 0.1).astype(np.float32)
    trailing = (rng.standard_normal((B, 5, H)) * 0.1).astype(np.float32)
    for b in range(B):  # pad rows past each stream's length
        prefill[b, plens[b]:] = 0
        trailing[b, tlens[b]:] = 0
    jt = jhi.to_device(jhi.host_init_talker_params(0, TINY_TALKER), jnp.float32)
    jc = jhi.to_device(jhi.host_init_cp_params(1, TINY_CP, H), jnp.float32)
    rj = jbg.generate_codes_batch(
        jt, jc, talker_cfg=TINY_TALKER, cp_cfg=TINY_CP, sampling=GREEDY_J,
        prefill_embeds=jnp.asarray(prefill), prefill_lens=jnp.asarray(plens),
        trailing_embeds=jnp.asarray(trailing), trailing_lens=jnp.asarray(tlens),
        tts_pad_embed=jnp.zeros((H,)), cache=jtk.make_cache(TINY_TALKER, B, 32, jnp.float32),
        max_steps=jnp.asarray(caps), max_frames=8, key=jax.random.PRNGKey(0),
    )
    rt = tbg.generate_codes_batch(
        from_jax_params(jt, "cpu"), from_jax_params(jc, "cpu"), talker_cfg=TINY_TALKER,
        cp_cfg=TINY_CP, sampling=GREEDY_T, prefill_embeds=torch.from_numpy(prefill),
        prefill_lens=plens, trailing_embeds=torch.from_numpy(trailing), trailing_lens=tlens,
        tts_pad_embed=torch.zeros(H), cache=ttk.make_cache(TINY_TALKER, B, 32, torch.float32),
        max_steps=caps, max_frames=8, seed=0,
    )
    assert rt.n_frames.tolist() == np.asarray(rj.n_frames).tolist() == caps
    assert (rt.codes.numpy() == np.asarray(rj.codes)).all()
    assert (rt.tokens.numpy() == np.asarray(rj.tokens)).all()


def test_generate_batch_of_70_texts_is_one_lockstep(monkeypatch, port_model):
    """``generate_batch`` of 70 texts, sampled (T = 0.9, top-k 50): one
    ``generate_codes_batch`` call of 70 rows at ``seed``, whose codes equal
    a fresh call's; row 69 is not the row a second group of 6 rows at
    ``seed + 1`` would give (the old 64-row groups)."""
    tm = port_model
    texts = [f"text number {i} of the wide batch" for i in range(B)]
    calls = []
    real = tbg.generate_codes_batch

    def spy(*a, **k):
        res = real(*a, **k)
        calls.append((a, k, res))
        return res

    monkeypatch.setattr(tbg, "generate_codes_batch", spy)
    # the vocoder is not what this test holds (70 waveforms cost ~30 s here)
    monkeypatch.setattr(tm, "_decode_audio_list",
                        lambda codes, n: [np.zeros(1920 * int(f), np.float32) for f in n])
    wavs = tm.generate_batch(texts, speakers=["aiden", "vivian"] * (B // 2), language="english",
                             temperature=0.9, top_k=50, max_tokens=5, seed=3)
    assert len(wavs) == B and len(calls) == 1
    a, k, res = calls[0]
    assert k["prefill_embeds"].shape[0] == B and k["seed"] == 3

    def fresh(rows, seed):
        kw = dict(k, seed=seed)
        for name in ("prefill_embeds", "prefill_lens", "trailing_embeds", "trailing_lens",
                     "max_steps"):
            kw[name] = k[name][rows]
        kw["cache"] = ttk.make_cache(tm.talker_cfg, kw["prefill_embeds"].shape[0],
                                     k["cache"].max_len, torch.float32)
        return real(*a, **kw)

    whole = fresh(slice(None), 3)
    assert torch.equal(whole.codes, res.codes) and torch.equal(whole.n_frames, res.n_frames)
    second = fresh(slice(64, None), 4)
    n = min(int(res.n_frames[B - 1]), int(second.n_frames[-1]))
    assert n > 0 and not torch.equal(res.codes[B - 1, :n], second.codes[-1, :n])


def test_vocoder_slices_give_the_batch_waveforms(monkeypatch, port_model):
    """``_decode_audio_list`` in slices of one row (``VOCODER_ROW_FRAMES``
    set to one 72-frame bucket) gives the waveforms of one call over the
    three rows: the vocoder decodes each row on its own. f32 on the CPU,
    within 1e-5 of the pre-clip signal's scale (< 40 here, as
    tests/test_torch_batch.py bounds its waveforms; the convolutions sum
    in another order at another batch)."""
    tm = port_model
    codes = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (3, 8, 16))).to(torch.int32)
    n = np.array([5, 3, 8])
    whole = tm._decode_audio_list(codes, n)
    monkeypatch.setattr(ttts, "VOCODER_ROW_FRAMES", 72)
    sliced = tm._decode_audio_list(codes, n)
    assert [len(w) for w in sliced] == [len(w) for w in whole] == [f * 1920 for f in n]
    for a, b in zip(sliced, whole):
        assert np.abs(a - b).max() <= 1e-5 * 40
