"""T1: batched GQA decode-attention products in four forms, on the card.

The port of tools/exp_attn_forms.py. ``attn_form`` replaces its
``run_form`` (kernel ``make_kernel`` :42-83, pallas_call at :87): for n
loop iterations i, q_i = bf16(q + bf16(f32(i) * 1e-6)), scores s_i = q_i . K
over D with f32 sums, and out [1, D] f32 = the sum over i and over every
(batch, row) of bf16(s_i) . V. The forms (B 32, NQ 16, NKV 8, D 128, BT
128; the script's main :108-113):

  a   batched small, q [B*NKV, G, D], K natural [B*NKV, BT, D];
  b   per-sequence wide, q [B, NQ, D], K pre-transposed [B, D, NKV*BT];
  c   grouped wide, q [B/8, 8*NQ, D], K pre-transposed [B/8, D, 8*NKV*BT];
  c2  grouped wide, K natural [B/8, 8*NKV*BT, D];

V is [*, W, D] in every form. The wide forms' cross-sequence products are
part of the function. On a CUDA tensor it launches the hand-written kernel
in csrc/attn_forms.cu (tensor cores, each CTA holding a 128-key chunk of K
and V in shared memory across all n iterations); on a CPU tensor it runs
``attn_form_ref``, the plain version; any other device raises.

The script runs each form at n and 2n iterations (CUDA events, the best of 5
calls) and prints us per iteration, (t(2n) - t(n)) / n, the scale ratio
t(2n) / t(n) (~2.0 = the loop is timed, not the launch), the operation
bound of one iteration (989 TFLOP/s dense bf16) and, for ROADMAP item 20c,
one iteration as PyTorch calls: ``torch.bmm`` of q_i and K (its bf16
output is the f32 sum rounded once, the script's cast), then ``torch.bmm``
with V and a sum (back to back, CUDA events, and queued on the card
behind a spin so that the host's launches do not count). That is a
yardstick, not a one-call equivalent of the function. The card's name and power limit stand beside every number.

The JAX script draws q, k and v from one PRNGKey(0), so its k equals its v
(ROADMAP.md, queue 3); this port draws the three from a numpy seed.

Usage: python -m qwen3tts_tpu_torch.tools.exp_attn_forms [N]   (2000)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _cuda

B, NQ, NKV, D, BT = 32, 16, 8, 128, 128
G = NQ // NKV
FORMS = ("a", "b", "c", "c2")
K_TRANSPOSED = {"a": False, "b": True, "c": True, "c2": False}
CHUNK = 128  # keys per CTA (csrc/attn_forms.cu)
MAX_M = 128
PEAK_BF16_FLOP_S = 989e12  # H100 SXM data sheet, dense, at the 700 W power limit


def shapes(form: str) -> tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]:
    """(q, k, v) shapes of a form at the script's sizes."""
    return {
        "a": ((B * NKV, G, D), (B * NKV, BT, D), (B * NKV, BT, D)),
        "b": ((B, NQ, D), (B, D, NKV * BT), (B, NKV * BT, D)),
        "c": ((B // 8, 8 * NQ, D), (B // 8, D, 8 * NKV * BT), (B // 8, 8 * NKV * BT, D)),
        "c2": ((B // 8, 8 * NQ, D), (B // 8, 8 * NKV * BT, D), (B // 8, 8 * NKV * BT, D)),
    }[form]


def inputs(form: str, seed: int, device):
    """q, k, v of ``form``: numpy standard normals x 0.1, as bf16."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
                 .to(device=device, dtype=torch.bfloat16) for s in shapes(form))


def _dims(form, q, k, v) -> tuple[int, int, int]:
    """(Bt, M, W), raising on what the kernel does not take."""
    if form not in FORMS:
        raise ValueError(f"attn_form: unknown form {form!r} (one of {FORMS})")
    if any(t.dtype != torch.bfloat16 or t.dim() != 3 for t in (q, k, v)):
        raise ValueError("attn_form: q, k and v must be bf16 [batch, rows, cols]")
    bt, m, d = q.shape
    w = v.shape[1]
    want_k = (bt, d, w) if K_TRANSPOSED[form] else (bt, w, d)
    if d != D or tuple(v.shape) != (bt, w, D) or tuple(k.shape) != want_k:
        raise ValueError(f"attn_form {form}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (k must be {want_k}, D {D})")
    if not 1 <= m <= MAX_M or w < CHUNK or w % CHUNK:
        raise ValueError(f"attn_form: needs 1 <= M <= {MAX_M} and W a multiple of {CHUNK}, "
                         f"got M {m}, W {w}")
    return bt, m, w


def _shift(i: int) -> torch.Tensor:
    """bf16(f32(i) * 1e-6), the script's i-dependent term."""
    return (torch.tensor(i, dtype=torch.float32) * 1e-6).to(torch.bfloat16)


def attn_form_ref(form: str, q, k, v, n: int) -> torch.Tensor:
    """Plain version: out [1, D] f32, iteration by iteration (f32 products,
    the scores rounded to bf16 before the second product)."""
    _dims(form, q, k, v)
    kt = (k if K_TRANSPOSED[form] else k.transpose(1, 2)).float()
    vf = v.float()
    acc = torch.zeros(D, dtype=torch.float32, device=q.device)
    for i in range(n):
        qi = (q.float() + _shift(i).float().to(q.device)).to(torch.bfloat16)
        s = torch.matmul(qi.float(), kt).to(torch.bfloat16)
        acc += torch.matmul(s.float(), vf).reshape(-1, D).sum(0)
    return acc[None]


def attn_form(form: str, q, k, v, n: int) -> torch.Tensor:
    """out [1, D] f32 of ``form`` over n iterations. CUDA tensors launch the
    kernel (``attn_form.launches[form]``), CPU tensors run the plain
    version; any other device raises."""
    if q.device.type == "cpu":
        return attn_form_ref(form, q, k, v, n)
    if q.device.type != "cuda":
        raise ValueError(f"attn_form: unsupported device {q.device}")
    bt, m, w = _dims(form, q, k, v)
    if n < 0:
        raise ValueError(f"attn_form: n {n} < 0")
    part = torch.empty(bt * (w // CHUNK), D, dtype=torch.float32, device=q.device)
    out = torch.empty(1, D, dtype=torch.float32, device=q.device)
    rc = _cuda.library().qt_attn_form(
        int(K_TRANSPOSED[form]), bt, m, w, n, *(_cuda.ptr(t) for t in (q, k, v, part, out)),
        _cuda.stream_ptr(),
    )
    _cuda.check(rc, "attn_form")
    attn_form.launches[form] += 1
    return out


attn_form.launches = dict.fromkeys(FORMS, 0)  # kernel launches (CUDA calls), not plain runs


def iteration_flops(q, v) -> int:
    """Operations of one iteration: 2 products of 2 * Bt * M * W * D."""
    (bt, m, _), w = q.shape, v.shape[1]
    return 4 * bt * m * w * D


def call_bytes(q, k, v) -> int:
    """Bytes one call must move: q, k and v read once, the [1, D] f32 out."""
    return sum(t.numel() * t.element_size() for t in (q, k, v)) + D * 4


def bmm_iteration(form: str, q, k, v, shift: torch.Tensor) -> torch.Tensor:
    """One iteration as PyTorch calls (the yardstick): q_i = q + shift
    (``_shift(i)`` on q's device), torch.bmm with K (bf16 out), torch.bmm
    with V, the sum over rows."""
    qi = q + shift
    s = torch.bmm(qi, k if K_TRANSPOSED[form] else k.transpose(1, 2))
    return torch.bmm(s, v).reshape(-1, D).sum(0, dtype=torch.float32)


def main(argv: list[str]) -> dict:
    """Time every form; returns, by form, the call times at n and 2n (ms),
    us per iteration, its bound and the yardstick's us per iteration."""
    from ._card import bound_ms, card, event_ms, queued_ms, require_cuda

    n = int(argv[0]) if argv else 2000
    dev = require_cuda("exp_attn_forms")
    smi = card()

    def call_ms(fn) -> float:  # the best of 5 calls, CUDA events
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b))
        return best

    print(f"T1 attention forms, n={n} and {2 * n} iterations  [{smi}]", flush=True)
    res = {}
    for form in FORMS:
        q, k, v = inputs(form, 0, dev)
        t1 = call_ms(lambda: attn_form(form, q, k, v, n))
        t2 = call_ms(lambda: attn_form(form, q, k, v, 2 * n))
        per_us = (t2 - t1) / n * 1e3
        op_us = iteration_flops(q, v) / PEAK_BF16_FLOP_S * 1e6
        shifts = torch.stack([_shift(i) for i in range(64)]).to(dev)
        it = [0]

        def bmm_step():
            bmm_iteration(form, q, k, v, shifts[it[0] % 64])
            it[0] += 1

        bmm_us, bmm_dev_us = event_ms(bmm_step, 50) * 1e3, queued_ms(bmm_step, 50) * 1e3
        res[form] = dict(n=n, t1_ms=t1, t2_ms=t2, per_us=per_us, bound_us=op_us, bmm_us=bmm_us,
                         bmm_queued_us=bmm_dev_us)
        print(f"form {form:2s}: n={n} {t1:.3f} ms, n={2 * n} {t2:.3f} ms -> {per_us:.3f} us/iter "
              f"(scale {t2 / t1:.2f}x; ~2.0 = trustworthy); bound {op_us:.3f} us/iter "
              f"(operations; K+V read once {bound_ms(call_bytes(q, k, v)) * 1e3:.2f} us/call), "
              f"{op_us / per_us:.3f} of it; torch.bmm, cast, torch.bmm {bmm_us:.3f} us/iter back "
              f"to back, {bmm_dev_us:.3f} queued on the card  [{smi}]", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
