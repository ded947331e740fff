"""K3: decode attention over the valid prefix of a bf16 KV cache
(port of qwen3tts_tpu/ops/attention.py).

``decode_attention_inner`` replaces the Pallas kernel of the same name:
single-token GQA attention at B=1 that reads only cache rows [0, pos], with
f32 scores ``(q * scale) . k``, f32 probabilities and one rounding of the
output to q's dtype. On a CUDA tensor it launches csrc/decode_attention.cu
once (flash-decoding: the prefix split into ``CHUNK_ROWS``-row chunks
across blocks, the last block of each kv head merging its chunks; see that
file's header for the bound) or raises; on a CPU tensor it runs
``decode_attention_ref``, the plain PyTorch version.
``decode_attention_split_ref`` repeats the kernel's split arithmetic (per
chunk f32 max, sum and unnormalised PV, then the merge) in plain PyTorch.

Two cache layouts, as in the JAX package:
  layer=None: k/v_cache [1, Hkv, T, D]
  layer=idx:  k/v_cache [L, 1, Hkv, T, D], the layer read in place (no copy)
"""

from __future__ import annotations

import torch

from . import _cuda

# the gate of models/talker.py: caches this long take K3 on the card
MIN_CACHE = 4096
# cache rows per block of the kernel (its DA_CHUNK, read from the source)
CHUNK_ROWS = _cuda.header_ints(_cuda.CSRC / "decode_attention.cu")["DA_CHUNK"]


def chunks(pos: int) -> int:
    """Blocks per kv head for rows [0, pos]: 128-row chunks, the last one
    partial (1 chunk to pos 127, 32 at pos 4000, 47 at pos 6000)."""
    return pos // CHUNK_ROWS + 1


def scratch_floats(Hq: int, pos: int, D: int) -> tuple[int, int]:
    """f32 elements of the kernel's per-chunk scratch, for every query head
    and chunk: (m, l) padded to 16 bytes (the merge copies them 16 bytes at
    a time), and the unnormalised PV sums."""
    nc = chunks(pos)
    return Hq * nc * 4, Hq * nc * D


_counters: dict[torch.device, torch.Tensor] = {}


def head_counters(device, nkv: int) -> torch.Tensor:
    """The per-kv-head merge counters of ``device``: zeroed once, reused by
    every call (the kernel leaves them zero)."""
    c = _counters.get(device)
    if c is None or c.numel() < nkv:
        c = torch.zeros(max(nkv, 64), dtype=torch.int32, device=device)
        _counters[device] = c
    return c


def _layer_cache(k_cache, v_cache, layer):
    """The [Hkv, T, D] k/v views of one layer (views, not copies)."""
    if layer is None:
        return k_cache[0], v_cache[0]
    return k_cache[layer, 0], v_cache[layer, 0]


def decode_attention_ref(q, k_cache, v_cache, pos: int, scale: float, layer=None):
    """Plain PyTorch version of K3. q [1, Hq, 1, D] -> [1, Hq, 1, D]."""
    k, v = _layer_cache(k_cache, v_cache, layer)
    _, Hq, _, D = q.shape
    Hkv = k.shape[0]
    qg = q[0, :, 0].float().reshape(Hkv, Hq // Hkv, D) * scale
    s = torch.einsum("hgd,htd->hgt", qg, k[:, : pos + 1].float())
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("hgt,htd->hgd", p, v[:, : pos + 1].float())
    return out.reshape(1, Hq, 1, D).to(q.dtype)


def decode_attention_split_ref(q, k_cache, v_cache, pos: int, scale: float, layer=None):
    """K3's split arithmetic in plain PyTorch: per ``CHUNK_ROWS``-row chunk
    of [0, pos] and query head the f32 max m of the scores, l = sum exp(s -
    m) and acc = sum exp(s - m) v; then out = sum_c e^(m_c - M) acc_c /
    sum_c e^(m_c - M) l_c (M the largest m_c), rounded once to q's dtype."""
    k, v = _layer_cache(k_cache, v_cache, layer)
    _, Hq, _, D = q.shape
    Hkv = k.shape[0]
    qg = q[0, :, 0].float().reshape(Hkv, Hq // Hkv, D) * scale
    ms, ls, accs = [], [], []
    for c in range(chunks(pos)):
        rows = slice(c * CHUNK_ROWS, min((c + 1) * CHUNK_ROWS, pos + 1))
        s = torch.einsum("hgd,htd->hgt", qg, k[:, rows].float())
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("hgt,htd->hgd", p, v[:, rows].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(0))
    out = (acc * w[..., None]).sum(0) / (l * w).sum(0)[..., None]
    return out.reshape(1, Hq, 1, D).to(q.dtype)


def decode_attention_inner(q, k_cache, v_cache, pos: int, scale: float, layer=None):
    """K3. q [1, Hq, 1, D] (QK-normed, rotary applied); the caches hold row
    ``pos`` already; ``pos`` and ``layer`` are host ints. Returns
    [1, Hq, 1, D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, scale, layer)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_inner: unsupported device {q.device}")
    _, Hq, _, D = q.shape
    lead = 1 if layer is None else 2
    Hkv, T = k_cache.shape[lead], k_cache.shape[lead + 1]
    if k_cache.shape != v_cache.shape or k_cache.shape[lead - 1] != 1 or k_cache.dim() != lead + 3:
        raise ValueError(f"decode_attention_inner: cache shape {tuple(k_cache.shape)} "
                         f"does not fit layer={layer}")
    if q.dtype != torch.bfloat16 or k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise ValueError("decode_attention_inner: q and the caches must be bf16")
    if q.shape != (1, Hq, 1, D) or k_cache.shape[-1] != D or Hq % Hkv:
        raise ValueError(f"decode_attention_inner: q {tuple(q.shape)} against cache "
                         f"{tuple(k_cache.shape)}")
    if not 0 <= pos < T:
        raise ValueError(f"decode_attention_inner: pos {pos} outside the cache of {T}")
    k, v = _layer_cache(k_cache, v_cache, layer)  # contiguous views of the cache
    q = q.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention_inner: q and the caches must be 16-byte aligned")
    n_ml, n_acc = scratch_floats(Hq, pos, D)
    part_ml = torch.empty(n_ml, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(n_acc, dtype=torch.float32, device=q.device)
    out = torch.empty(1, Hq, 1, D, dtype=torch.bfloat16, device=q.device)
    rc = _cuda.library().qt_decode_attention(
        Hq, Hkv, D, T, int(pos), float(scale), chunks(pos),
        *(_cuda.ptr(t) for t in (q, k, v, part_ml, part_acc, head_counters(q.device, Hkv), out)),
        _cuda.stream_ptr(),
    )
    _cuda.check(rc, "decode_attention_inner")
    decode_attention_inner.launches += 1
    return out


decode_attention_inner.launches = 0  # kernel launches (CUDA calls), not plain runs
