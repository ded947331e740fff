"""The plain twins of K3's split form and of K2's batched GEMV (ops/attention.py,
ops/cp_kernel.py), on the CPU.

K3 on the card splits rows [0, pos] into 128-row chunks, keeps each chunk's
f32 (max m, sum l of exp(s - m), unnormalised PV sum) per query head and
merges them; ``decode_attention_split_ref`` repeats that arithmetic at the
chunk count the wrapper picks. Held against the Pallas kernel
``decode_attention_inner`` run with ``interpret=True`` (as
tests/test_attention_kernel.py runs it) in both cache layouts, at positions
on and next to chunk edges: scaled max|a - b| / max(1, max|b|) <= 1e-5 with
f32 caches (the same f32 arithmetic, merged in another order) and <= 1e-2
with bf16 caches (one bf16 rounding of the output). The host side: the
chunk count and the scratch sizes, and the merge counters.

K2's batched GEMV alone (``batched_gemv``) on a CPU tensor is its plain
version, whose sums are what the plain CP loop's matvecs (``mv_f32``)
compute before their scales: equal to the bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from qwen3tts_tpu.ops.attention import decode_attention_inner as jax_k3
from qwen3tts_tpu_torch.ops import _cuda
from qwen3tts_tpu_torch.ops import attention as attn
from qwen3tts_tpu_torch.ops import cp_kernel as cpk
from qwen3tts_tpu_torch.ops.decode_blocks import mv_f32, quantize_rows
from qwen3tts_tpu_torch.ops.quant import Int8Linear

HQ, HKV, D, L = 4, 2, 128, 3


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def scaled(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))


# pos 0; both sides of every chunk edge of a 256-row cache; the edges at 384
# and 512 and the last row of 640- and 1024-row caches (512-row TPU blocks)
CASES = [(256, 0), (256, 127), (256, 128), (256, 255), (640, 383), (640, 384), (640, 639),
         (1024, 511), (1024, 512), (1024, 1023)]


@pytest.mark.parametrize("layered", [False, True], ids=["one_layer", "layer_index"])
@pytest.mark.parametrize("T,pos", CASES)
def test_split_twin_matches_pallas_interpret(T, pos, layered):
    q = rand(1, HQ, 1, D, seed=T + pos, scale=2.0)
    lead = (L, 1) if layered else (1,)
    k = rand(*lead, HKV, T, D, seed=3)
    v = rand(*lead, HKV, T, D, seed=4)
    layer = 2 if layered else None
    scale = D**-0.5
    for dtype, jdt, tol in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 1e-2)):
        ref = jax_k3(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.int32(pos),
                     scale, layer=None if layer is None else jnp.int32(layer), interpret=True)
        tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
        got = attn.decode_attention_split_ref(tq, tk, tv, pos, scale, layer=layer)
        assert got.dtype == dtype and got.shape == (1, HQ, 1, D)
        assert scaled(got.float().numpy(), np.asarray(ref, np.float32)) <= tol, dtype
        plain = attn.decode_attention_ref(tq, tk, tv, pos, scale, layer=layer)
        assert scaled(got.float().numpy(), plain.float().numpy()) <= tol, dtype


def test_split_twin_reads_only_the_prefix():
    """Rows past pos (in the last chunk and past it) change nothing."""
    q = torch.from_numpy(rand(1, HQ, 1, D, seed=5))
    k, v = (torch.from_numpy(rand(1, HKV, 512, D, seed=s)) for s in (6, 7))
    a = attn.decode_attention_split_ref(q, k, v, 200, 0.1)
    k[:, :, 201:], v[:, :, 201:] = 1e4, float("nan")
    assert torch.equal(attn.decode_attention_split_ref(q, k, v, 200, 0.1), a)


def test_chunk_count_and_scratch_sizes():
    """128-row chunks, read from the kernel source; one block per chunk and
    kv head: one chunk up to pos 127, 32 at pos 4000 (256 blocks at 8 kv
    heads), 47 at pos 6000; 49 chunks (392 blocks, one wave at 3 blocks on
    each of 132 SMs) end at pos 6271."""
    assert attn.CHUNK_ROWS == 128
    assert _cuda.header_ints(_cuda.CSRC / "decode_attention.cu")["DA_CHUNK"] == attn.CHUNK_ROWS
    got = {p: attn.chunks(p) for p in (0, 127, 128, 255, 256, 4000, 4095, 6000, 6271, 6272)}
    assert got == {0: 1, 127: 1, 128: 2, 255: 2, 256: 3, 4000: 32, 4095: 32, 6000: 47,
                   6271: 49, 6272: 50}
    assert 8 * attn.chunks(6271) <= 3 * 132 < 8 * attn.chunks(6272)
    assert attn.scratch_floats(16, 4000, 128) == (16 * 32 * 4, 16 * 32 * 128)
    assert attn.scratch_floats(16, 40, 128) == (64, 16 * 128)


def test_merge_counters_are_zeroed_once_and_reused():
    dev = torch.device("cpu")
    c = attn.head_counters(dev, 8)
    assert c.dtype == torch.int32 and c.numel() >= 8 and not c.any()
    assert attn.head_counters(dev, 8) is c
    wide = attn.head_counters(dev, c.numel() + 1)
    assert wide.numel() > c.numel() and not wide.any()
    assert attn.head_counters(dev, 8) is wide


@pytest.mark.parametrize("B,I,O", [(2, 64, 48), (17, 272, 128), (64, 128, 272)])
def test_batched_gemv_plain_is_the_plain_matvec(B, I, O):
    """On CPU tensors the GEMV wrapper is its plain version (one split); its
    f32 sums times the column scales are ``mv_f32``'s wo_bf16 output and its
    dyn_int8 int32 sums are ``mv_f32``'s exact accumulator, to the bit."""
    g = torch.Generator().manual_seed(B + I)
    x = (torch.randn(B, I, generator=g) * 0.5).to(torch.bfloat16)
    q = torch.randint(-127, 128, (I, O), generator=g, dtype=torch.int8)
    scale = torch.rand(1, O, generator=g) * 0.01 + 1e-3
    w = Int8Linear(q, scale)
    part = cpk.batched_gemv(x, q)
    assert part.shape == (1, B, O) and part.dtype == torch.float32
    assert torch.equal(part[0] * scale.reshape(-1), mv_f32(x, w))
    amax = x.float().abs().amax(1)
    acc = cpk.batched_gemv(x, q, amax)
    assert acc.dtype == torch.int32 and acc.shape == (1, B, O)
    xq, s = quantize_rows(x)
    assert torch.equal(acc[0].float() * (s[:, None] * scale.reshape(-1)), mv_f32(x, w, "dyn_int8"))
    assert torch.equal(acc[0].long(), xq.long() @ q.long())
    wb = (torch.randn(I, O, generator=g) * 0.05).to(torch.bfloat16)
    assert torch.equal(cpk.batched_gemv(x, wb)[0], mv_f32(x, wb))


def test_batched_gemv_raises_off_the_card_and_cpu():
    x = torch.zeros(2, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cpk.batched_gemv(x, torch.zeros(16, 16, dtype=torch.int8, device="meta"))


def test_tensor_core_split_and_workspace():
    """K2's tensor-core GEMV may split twice as deep as the CUDA-core form
    (TC_MAX_PARTS, read from csrc/common.cuh): its workspace holds that many
    rows at B > 1, while K1's stays at GEMV_MAX_PARTS and B = 1 at
    GEMV_MAX_SPLIT."""
    lim = _cuda.LIMITS
    assert (lim["GEMV_MAX_PARTS"], lim["TC_MAX_PARTS"]) == (512, 1024)
    assert _cuda.workspace_rows(1, tensor_cores=True) == _cuda.workspace_rows(1) == 64
    assert _cuda.workspace_rows(2) == 512 and _cuda.workspace_rows(64, tensor_cores=True) == 1024
