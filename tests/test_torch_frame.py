"""The host side of K2's persistent B = 1 frame (csrc/cp_loop.cu), on the CPU.

The frame itself runs only on the card (tests/test_torch_cuda.py holds it
against its plain version). Here: the limits the wrapper reads from the
kernel's source, the workspace that holds its two partial buffers, the
gate, which takes the same vocabularies at one row as at more, and the
barrier fault's report: ``check_barrier`` and the decode loops' check.
"""

import pytest

torch = pytest.importorskip("torch")

from qwen3tts_tpu_torch import config as C
from qwen3tts_tpu_torch.ops import _cuda
from qwen3tts_tpu_torch.ops import cp_kernel as cpk
from qwen3tts_tpu_torch.ops.quant import quantize_decode_params_int8
from qwen3tts_tpu_torch.utils import host_init as hi


def test_frame_limits_are_read_from_the_kernel():
    """The frame's constants come from the source (csrc/common.cuh, where
    the persistent kernels' building blocks sit since K1's B = 1 step shares
    them): its sampler block of 512 threads takes a whole number of ids a
    thread up to the multi-launch sampler's 4096, and the B = 1 workspace
    (GEMV_MAX_SPLIT rows) holds the two partial buffers of PF_MAX_SPLIT rows
    each."""
    fl = lim = _cuda.LIMITS
    per_thread, rest = divmod(lim["SAMPLE_THREADS"] * lim["SAMPLE_PER_THREAD"], fl["PF_THREADS"])
    assert (fl["PF_THREADS"], per_thread, rest) == (512, 8, 0)
    assert 2 * fl["PF_MAX_SPLIT"] <= _cuda.workspace_rows(1) == lim["GEMV_MAX_SPLIT"]
    assert fl["PF_TILE"] % 16 == 0


@pytest.mark.parametrize("vocab,batch,ok", [
    (2048, 1, True), (2048, 2, True), (4096, 1, True), (4096, 2, True), (4112, 1, False),
    (4112, 2, False),
])
def test_b1_gate_takes_the_frames_vocabulary(vocab, batch, ok):
    """The frame's sampler block takes the multi-launch form's vocabularies,
    up to 4096, at one row as at more; past that neither runs."""
    cfg = C.CodePredictorConfig(vocab_size=vocab, hidden_size=128, intermediate_size=256,
                                num_hidden_layers=1, num_attention_heads=2,
                                num_key_value_heads=1, head_dim=128)
    cp = hi.to_device(hi.host_init_cp_params(0, cfg, 128), torch.bfloat16, "cpu")
    cp = quantize_decode_params_int8(cp, "lm_head")
    assert cpk.kernel_supported(cp, cfg, 128, batch) is ok


def test_barrier_check_raises_once_and_clears(monkeypatch):
    """``check_barrier`` raises ``BarrierTimeout`` when the card set the
    device's pinned flag, and clears it; a clear flag passes."""
    flag = torch.zeros(1, dtype=torch.int32)  # the pinned flag's stand-in
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(cpk, "_err_flags", {dev: flag})
    cpk.check_barrier(dev)
    flag.fill_(1)
    with pytest.raises(cpk.BarrierTimeout, match="K2 persistent barrier timed out"):
        cpk.check_barrier(dev)
    assert int(flag[0]) == 0
    cpk.check_barrier(dev)


def test_barrier_check_without_a_frame_does_nothing(monkeypatch):
    """Before any B = 1 frame there is no flag: ``check_barrier`` returns
    without allocating one (pinned memory needs a CUDA build) and without
    synchronising."""
    monkeypatch.setattr(cpk, "_err_flags", {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronised"))
    cpk.check_barrier(torch.device("cuda"), sync=True)
    assert cpk._err_flags == {}


def test_barrier_check_synchronises_first_when_asked(monkeypatch):
    """With ``sync`` the host waits for the device before it reads the
    flag, so a frame still running is not missed."""
    flag = torch.zeros(1, dtype=torch.int32)
    monkeypatch.setattr(cpk, "_err_flags", {torch.device("cuda", 0): flag})
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: (synced.append(d),
                                                                   flag.fill_(1)))
    with pytest.raises(cpk.BarrierTimeout):
        cpk.check_barrier(torch.device("cuda", 0), sync=True)
    assert synced == [torch.device("cuda", 0)]


@pytest.mark.parametrize("sync", [False, True])
def test_decode_loops_check_the_frames_on_cuda_only(monkeypatch, sync):
    """``generate.check_cp_frames`` (each frame's host synchronisation, the
    end of an utterance) raises on a set flag for a CUDA device, synchronising
    first at the end; off CUDA it reads nothing."""
    from qwen3tts_tpu_torch.models import generate as gen

    flag = torch.ones(1, dtype=torch.int32)
    monkeypatch.setattr(cpk, "_err_flags", {torch.device("cuda", 0): flag})
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(d))
    gen.check_cp_frames(torch.device("cpu"), sync=sync)
    assert int(flag[0]) == 1 and synced == []
    with pytest.raises(cpk.BarrierTimeout, match="K2 persistent barrier timed out"):
        gen.check_cp_frames(torch.device("cuda"), sync=sync)
    assert int(flag[0]) == 0 and len(synced) == int(sync)
