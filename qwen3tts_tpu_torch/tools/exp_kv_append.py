"""T5: batched in-place KV row append, on the card.

The port of tools/exp_kv_append.py. ``kv_append`` replaces its
``_append_call`` (kernel ``_append_kernel`` :57-87, pallas_call at :97): for
every sequence b, k_new[:, b] and v_new[:, b] ([L, Hkv, D] bf16) are written
at T index offsets[b] of the bf16 caches [L, B, Hkv, T, D], in place (an
offset outside [0, T) lands where dynamic_update_slice puts it: a negative
one counts from the end, then it is clamped into [0, T - 1]):
the function of qwen3tts_tpu/models/talker.py::_scatter_append_batched on a
bf16 cache, which the JAX script asserts (:151-154). On a CUDA tensor it
launches the hand-written kernel in csrc/kv_append.cu (one launch, the rows
themselves in 16-byte stores: the TPU's 8-row read-modify-write window
existed only for Mosaic's (8, 128) tiling); on a CPU tensor it runs
``kv_append_ref``, the plain version, one slice copy per sequence and cache
(the counterpart of the DUS chain); any other device raises. The port's
decode path does not use it: K1 writes its new rows into the cache itself.

The script checks the kernel against the plain version on a random cache,
then times loops of 66 appends at L 28, B 32, Hkv 8, T 256, D 128 (the
script's :138; 0.94 GB of caches; offsets 5b + 3, each append one further;
each append takes the next of 70 copies of the new rows, 257 MB, so none
finds them in the 50 MB L2, as K4 is timed) in the JAX script's order
(:171-186): the plain append first in the process
("fresh"), the kernel, the plain append again ("after"), and then one
``index_put_`` per cache (``cache[:, rows, :, offs] = new``, the library
call), as ms per append (CUDA events over the loops, which the host's
launch path bounds) and, for the kernel and the library call, ms per
append with the loop queued on the card behind a spin kernel (no host in
the way; the plain append reads its offsets to the host, so it cannot
queue), beside the bound (7.34 MB moved, the new rows
read once and written once, 2.19 us at 3.35 TB/s), with the card's name and
power limit. The JAX script found the DUS chain free when benched first and
~0.5 ms after other loops on the TPU; the fresh and after lines show
whether the card has such an order effect.

Usage: python -m qwen3tts_tpu_torch.tools.exp_kv_append [N_LOOPS]   (5)
"""

from __future__ import annotations

import sys

import torch

from ..ops import _cuda

L, B, HKV, T, D = 28, 32, 8, 256, 128
STEPS = 66
N_NEW = 70  # copies of the new rows the appends take in turn: 257 MB, 5x the 50 MB L2


def first_offsets(batch: int, device) -> torch.Tensor:
    """The script's offsets, 5 b + 3 (:145), int32 [B]."""
    return torch.arange(batch, dtype=torch.int32, device=device) * 5 + 3


def _check(k_cache, v_cache, k_new, v_new, offsets):
    if k_cache.dim() != 5 or k_cache.shape != v_cache.shape:
        raise ValueError("kv_append: caches must be two [L, B, Hkv, T, D] tensors of one shape")
    l, b, h, _, d = k_cache.shape
    if tuple(k_new.shape) != (l, b, h, d) or k_new.shape != v_new.shape:
        raise ValueError(f"kv_append: new rows must be [L, B, Hkv, D] = {(l, b, h, d)}, got "
                         f"{tuple(k_new.shape)} and {tuple(v_new.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (k_cache, v_cache, k_new, v_new)):
        raise ValueError("kv_append: caches and rows must be bf16")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (b,):
        raise ValueError(f"kv_append: offsets must be int32 [{b}]")
    if d % 8:
        raise ValueError(f"kv_append: head size {d} is not a multiple of 8 (16-byte rows)")


def kv_append_ref(k_cache, v_cache, k_new, v_new, offsets):
    """Plain version, in place: one slice copy per sequence and cache.
    Returns (k_cache, v_cache)."""
    _check(k_cache, v_cache, k_new, v_new, offsets)
    t_max = k_cache.shape[3]
    for b, off in enumerate(offsets.tolist()):
        off = min(max(off + t_max if off < 0 else off, 0), t_max - 1)
        k_cache[:, b, :, off] = k_new[:, b]
        v_cache[:, b, :, off] = v_new[:, b]
    return k_cache, v_cache


def kv_append(k_cache, v_cache, k_new, v_new, offsets):
    """Append each sequence's rows at its offset, in place; returns (k_cache,
    v_cache). CUDA tensors launch the kernel (``kv_append.launches``), CPU
    tensors run the plain version; any other device raises."""
    if k_cache.device.type == "cpu":
        return kv_append_ref(k_cache, v_cache, k_new, v_new, offsets)
    if k_cache.device.type != "cuda":
        raise ValueError(f"kv_append: unsupported device {k_cache.device}")
    _check(k_cache, v_cache, k_new, v_new, offsets)
    l, b, h, t_max, d = k_cache.shape
    rc = _cuda.library().qt_kv_append(
        l, b, h, t_max, d, *(_cuda.ptr(t) for t in (k_cache, v_cache, k_new, v_new, offsets)),
        _cuda.stream_ptr(),
    )
    _cuda.check(rc, "kv_append")
    kv_append.launches += 1
    return k_cache, v_cache


kv_append.launches = 0  # kernel launches (CUDA calls), not plain runs


def kv_append_index_put(k_cache, v_cache, k_new, v_new, offsets):
    """The library call: one ``index_put_`` per cache (offsets in range)."""
    rows = torch.arange(k_cache.shape[1], device=k_cache.device)
    offs = offsets.long()
    k_cache[:, rows, :, offs] = k_new.transpose(0, 1)
    v_cache[:, rows, :, offs] = v_new.transpose(0, 1)
    return k_cache, v_cache


def moved_bytes(k_new, v_new) -> int:
    """Bytes an append must move: the new rows read once and written once."""
    return 2 * (k_new.numel() * k_new.element_size() + v_new.numel() * v_new.element_size())


def main(argv: list[str]) -> dict:
    """Check the kernel, then time the four appends in order; returns, by
    case, ms per append back to back and (kernel, library) queued, and the
    bytes an append must move."""
    from ._card import bound_ms, card, queued_ms, require_cuda

    n_loops = int(argv[0]) if argv else 5
    dev = require_cuda("exp_kv_append")
    smi = card()
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    k_news, v_news = rand(N_NEW, L, B, HKV, D), rand(N_NEW, L, B, HKV, D)
    k_new, v_new = k_news[0], v_news[0]
    k_cache, v_cache = rand(L, B, HKV, T, D), rand(L, B, HKV, T, D)
    offs = first_offsets(B, dev)
    ref = kv_append_ref(k_cache.clone(), v_cache.clone(), k_new, v_new, offs)
    got = kv_append(k_cache.clone(), v_cache.clone(), k_new, v_new, offs)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise SystemExit("exp_kv_append: the kernel's caches differ from the plain version's")
    print(f"parity OK (non-zero base cache)  [{smi}]", flush=True)

    table = offs[None] + torch.arange(STEPS, dtype=torch.int32, device=dev)[:, None]  # [66, B]

    def loop(append):
        for i in range(STEPS):
            append(k_cache, v_cache, k_news[i % N_NEW], v_news[i % N_NEW], table[i])

    bound = bound_ms(moved_bytes(k_new, v_new))
    cases = (("plain append (fresh)", kv_append_ref), ("kernel", kv_append),
             ("plain append (after)", kv_append_ref), ("index_put_ (library)", kv_append_index_put))
    res = dict(bytes=moved_bytes(k_new, v_new))
    for name, append in cases:
        loop(append)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n_loops):
            loop(append)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / (n_loops * STEPS)
        res[name] = dict(ms=ms)
        queued = ""
        if append is not kv_append_ref:
            res[name]["queued_ms"] = q_ms = queued_ms(lambda: loop(append), 1) / STEPS
            queued = f", queued {q_ms:.4f} ms/append (bound / time {bound / q_ms:.3f})"
        print(f"{name}: {ms:.4f} ms/append{queued}; bound {bound:.4f} ms  [{smi}]", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
