"""Bytes and operations of one call of K1 (the talker step) and K2 (the code
predictor's frame), and the card's published peaks.

Each input byte is counted once and each output byte written once, whatever
a kernel reads again: the weights with their scales, the norms, the rows
of the KV prefix that the step reads and the new row it writes, the
sampler's tables, the activations in and out. The operations are two per
weight element and row, plus attention's (``4 * heads * head_dim`` per
key). Both follow the arithmetic of the repository's chip smoke test
(``k1_io``, ``k2_io``), taken from the C entries' own arguments; K2's
attention counts each row's 16 positions over 1 + ... + 16 keys.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM data sheet, 700 W
PEAK_BF16_FLOP_S = 989e12  # dense bf16 tensor rate, the same sheet


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the bf16 rate, the larger (K1 and K2 at ``wo_bf16``
    compute in bf16)."""
    return max(n_bytes / HBM_BYTES_S, flops / PEAK_BF16_FLOP_S)


def _stack(L, H, NQ, NKV, D, I, w_bf16):
    """(weight elements, weight bytes with scales, norm bytes) of a fused
    layer stack: qkv, o, gate_up, down."""
    out_cols = (NQ + 2 * NKV) * D + H + 2 * I + H
    elems = H * (NQ + 2 * NKV) * D + NQ * D * H + 2 * H * I + I * H
    w_bytes = elems * (2 if w_bf16 else 1) + (0 if w_bf16 else 4 * out_cols)
    return L * elems, L * w_bytes, L * (2 * H + 2 * D) * 2


def k1_io(L, H, NQ, NKV, D, I, V, B, prefix_rows, kv_quant, w_bf16, head_bf16, sample=True):
    """(bytes, flops) of one K1 call over B rows whose prefixes hold
    ``prefix_rows`` cache rows in all."""
    elems, w_bytes, norm_bytes = _stack(L, H, NQ, NKV, D, I, w_bf16)
    per_row = L * NKV * D * 2 * (1 if kv_quant else 2) + (L * NKV * 2 * 4 if kv_quant else 0)
    n = w_bytes + norm_bytes + H * 2 + 2 * B * H * 2 + (prefix_rows + B) * per_row
    flops = 2 * B * elems + 4 * L * NQ * D * (prefix_rows + B)
    if sample:
        n += H * V * (2 if head_bf16 else 1) + (0 if head_bf16 else V * 4)
        n += B * V + V * 4 + B * 4
        flops += 2 * B * H * V
    return n, flops


def k2_io(L, H, NQ, NKV, D, I, V, NCB, B, TH, w_bf16, head_bf16):
    """(bytes, flops) of one K2 call over B rows: the stack, the NCB heads
    and the projection from the talker width TH where it differs, x0 (the
    talker hidden and code 0's embedding), the NCB sampled embedding rows of
    each row, codes and the embedding sum out; 16 positions per row."""
    elems, w_bytes, norm_bytes = _stack(L, H, NQ, NKV, D, I, w_bf16)
    proj = TH != H
    n = (w_bytes + norm_bytes + H * 2
         + NCB * H * V * (2 if head_bf16 else 1) + (0 if head_bf16 else NCB * V * 4)
         + ((TH * H + H) * 2 if proj else 0)
         + B * 2 * TH * 2 + NCB * B * TH * 2 + B * NCB * 4 + B * TH * 4)
    flops = (2 * B * (16 * elems + NCB * H * V + (16 * TH * H if proj else 0))
             + B * L * NQ * 4 * D * sum(range(1, 17)))
    return n, flops


def k1_args(a, batched: bool) -> dict:
    """K1's widths and flags from the arguments of the C entry
    ``qt_talker_step`` (``batched``) or ``qt_talker_frame`` (B = 1)."""
    if batched:  # B after T, rope_stride before the head
        L, H, NQ, NKV, D, I, V, _T, B, pos = a[:10]
        kv_quant, w_bf16, head_bf16 = a[11:14]
        head = a[38]
    else:
        L, H, NQ, NKV, D, I, V, _T, pos = a[:9]
        B = 1
        kv_quant, w_bf16, head_bf16 = a[10:13]
        head = a[36]
    return dict(L=L, H=H, NQ=NQ, NKV=NKV, D=D, I=I, V=V, B=B, pos=pos, kv_quant=bool(kv_quant),
                w_bf16=bool(w_bf16), head_bf16=bool(head_bf16), sample=bool(head))


def k2_args(a) -> dict:
    """K2's widths and flags from the arguments of ``qt_cp_loop``."""
    L, H, NQ, NKV, D, I, V, NCB, B, TH, w_bf16, head_bf16 = a[:12]
    return dict(L=L, H=H, NQ=NQ, NKV=NKV, D=D, I=I, V=V, NCB=NCB, B=B, TH=TH,
                w_bf16=bool(w_bf16), head_bf16=bool(head_bf16))
