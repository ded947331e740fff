"""Device times of K3 (long-prefix decode attention), K2 (the CP loop) and
K1 (the talker step) at the shapes of their redesigns, with their
yardsticks.

- K3 at pos 40 / 4000 / 6000 of 4096 / 4096 / 6144 rows, over the 0.6B
  talker's 28 layers in turn (no call finds the last one's bytes in the
  L2), beside ``scaled_dot_product_attention(enable_gqa=True)`` on the same
  prefix and the bound (the prefix's k/v bytes at 3.35 TB/s); where the
  tree has it, K3's profile: its kernel cut after the loads, the scores,
  the softmax, the PV sums, their sum over row groups and the partials
  written out (``qt_decode_attention_cut``).
- K2 at B in {2, 8, 16, 17, 33, 48, 64, 128, 256}, 0.6B int8 CP,
  ``wo_bf16`` and ``dyn_int8``: device ms per frame, and at B = 64 and 256
  that time split by kernel (GEMV, attention, sampler, finishing); from
  B = 64 up also events ms, the plain version's events ms and the bound
  (every input read once; operations over the bf16 or int8 rate).
- Where the tree has it, K2's batched GEMV alone at B = 64 and 256 at the
  CP's five shapes: the tensor-core form, the CUDA-core form and one
  library call (``torch.matmul`` on bf16 weights; ``torch._int_mm`` in
  dyn_int8).
- ``k1``: K1's step (sample mode, T = 0.9, top-k 50) at B in {1, 2, 8, 16,
  33, 48, 64} on the 0.6B int8 talker in ``wo_bf16`` and ``dyn_int8``, and
  the 1.7B int8 talker at B = 64, on a bf16 cache of 256 rows with the rows'
  offsets in [64, 192): device ms (profiler) and events ms per step; then
  the wide cells, B in {64, 128, 256} on a 128-row bf16 cache with offsets
  in [20, 120) (chip_smoke phase a's), 0.6B int8 in both modes and 1.7B
  int8 at B = 256: events ms, device ms, the plain version's events ms
  and the bound.
- ``k1b1``: K1 at B = 1 (sample mode, T = 0.9, top-k 50) on the 0.6B
  talker in int8 ``wo_bf16``, ``dyn_int8`` and dense bf16 and on the 1.7B
  int8 talker, on bf16 (and for 0.6B int8 also int8) caches of random rows,
  at pos 40 / 4000 / 6000 of 256 / 4096 / 6144 rows, and at top_p 0.9: ms
  per step by events (back to back) and queued (behind a spin kernel, the
  host out of the way), and the same call captured once in a CUDA graph
  and replayed (in a tree whose B = 1 step is the multi-launch loop, a
  graph of its 8 L + 3 launches); the bound (weights and the prefix's
  cache bytes once at 3.35 TB/s); the library's operations a call; the
  host ms of one call (the wrapper's Python and the launch, not waited
  for); where the tree has the persistent step, the step cut after each
  kind of phase.
- ``e2e``: the 0.6B int8 B=1 headline (66 frames, forbid_eos, T = 0.9,
  top-k 50, repetition 1.05, f32 vocoder: wall, RTF, decode ms per frame
  after the first) and the B=64 lockstep frame (``generate_codes_batch``,
  66 frames, 128-row bf16 cache: ms per frame, codec tokens/s), as
  chip_smoke phases 6 and d run them.
- ``int4lib``: the library yardstick of K4 and T4, ``torch._weight_int4pack_mm``
  (int4, group 64, M = 1) at the packed 0.6B shapes, on weights repacked
  with ``torch._convert_weight_to_int4pack`` (MLX's ``scale * q + bias``
  is int4pack's ``(q - 8) * scale + zero`` with ``zero = bias + 8 *
  scale``, both rounded to bf16), beside K4 on the same weights (int4 and
  int8, group 64), by the profiler and queued; where the tree's K4 takes
  it, K4 in each rows-a-warp form.
- ``qgemm``: ``quant_gemm``, K4's function at M rows, at the five distinct
  packed 0.6B (O, I), M = 2-4096 (each side of both crossovers), int4 and
  int8 at group 64, bf16 and f32 x: queued us over 64 MB of weight copies,
  the scaled error, the bound and (int4, bf16 x)
  ``torch._weight_int4pack_mm``; where the tree's wrapper takes ``form=``,
  the chosen form and each form forced up to 65 rows.
- ``k2b1``: K2 at B = 1 in every mode it takes (0.6B int8 fused and
  unfused in both matmul modes, dense bf16, the 1.7B CP with its
  projection in int8, dyn_int8 and bf16, top-p 0.9, K5's port): queued ms
  (torch.profiler records no cooperative launch) and events ms per frame,
  and events ms per frame of the same call
  captured once in a CUDA graph and replayed (a graph of the multi-launch
  loop in a tree that runs it at B = 1, of the persistent frame in one
  that has it); where the tree has the persistent frame, its time split
  by phase (the frame cut after each kind of phase).

Every device time of a multi-launch call is a profiler window held to the
kernels of its calls (``_card.device_ms``); a persistent B = 1 launch is
read queued (``_card.queued_ms``) or by events, as the profiler records
none. Needs a CUDA device. Run from a checkout's root:

    python -m qwen3tts_tpu_torch.tools.time_k3_k2 [--label L] [--rounds N] \
        [--parts k3,k2,gemv,k1,k1b1,k2b1,e2e,int4lib,qgemm] [--out DIR]

It uses only entry points older trees share, so two trees compare on one
card: copy this file and ``_card.py`` into the other tree's
``qwen3tts_tpu_torch/tools/`` and run both in turn (A, B, B, A). Each
result is one JSON line on stdout (and in ``DIR/time_k3_k2_L.jsonl`` with
``--out``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import CodePredictorConfig
from ..ops import _cuda
from ..ops import attention as attn
from ..ops import cp_kernel as cpk
from ..ops.quant import quantize_decode_params_int8
from ..utils import host_init as hi
from ._card import (
    HBM_BYTES_S, card, device_ms, device_ms_by_kernel, event_ms, int8_talker, queued_ms,
    require_cuda, talker_06b,
)

PEAK_BF16, PEAK_INT8 = 989e12, 1979e12  # H100 SXM dense tensor rates, 700 W
BATCHES = (2, 8, 16, 17, 33, 48, 64, 128, 256)
WIDE = (64, 128, 256)  # the batches K1 and K2 are also timed beside their plain versions at


def bound(n_bytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k3(dev, emit):
    L, NKV, NQ, D = 28, 8, 16, 128
    g = torch.Generator(device=dev).manual_seed(0)
    # one launch a call where the wrapper picks the chunks (chunks and merge
    # in one kernel); two in older trees (partials, then a combining pass)
    per_call = 1 if hasattr(attn, "chunks") else 2
    for T, pos in ((4096, 40), (4096, 4000), (6144, 6000)):
        kv = torch.randn(2, L, 1, NKV, T, D, generator=g, device=dev).to(torch.bfloat16)
        q = torch.randn(1, NQ, 1, D, generator=g, device=dev).to(torch.bfloat16)
        turn = iter(range(1 << 30))
        run_k = lambda: attn.decode_attention_inner(q, kv[0], kv[1], pos, D**-0.5,
                                                    layer=next(turn) % L)
        turn_s = iter(range(1 << 30))

        def run_s():
            l = next(turn_s) % L
            return torch.nn.functional.scaled_dot_product_attention(
                q, kv[0, l, :, :, : pos + 1], kv[1, l, :, :, : pos + 1], scale=D**-0.5,
                enable_gqa=True)

        ms = device_ms(run_k, 56, per_call)
        sdpa = device_ms(run_s, 56)
        n_bytes = 2 * NKV * (pos + 1) * D * 2 + 2 * NQ * D * 2
        b = bound(n_bytes, 4 * NQ * D * (pos + 1), PEAK_BF16)
        rec = dict(kernel="K3", T=T, pos=pos, ms=ms, sdpa_ms=sdpa, bound_ms=b[0], bound_by=b[1],
                   kernels_per_call=per_call)
        if hasattr(attn, "chunks"):
            rec["cut_ms"] = {name: device_ms(k3_cut(q, kv, pos, cut, L), 56, 1)
                             for cut, name in enumerate(CUTS, start=1)}
        emit(rec)
        del kv


CUTS = ("loads", "scores", "softmax", "pv", "reduce", "partials")  # csrc/decode_attention.cu's CUT_*


def k3_cut(q, kv, pos, cut, L):
    """K3's kernel over the layers in turn, stopped after phase ``cut``."""
    NQ, NKV, T, D = q.shape[1], kv.shape[3], kv.shape[4], q.shape[3]
    n_ml, n_acc = attn.scratch_floats(NQ, pos, D)
    ml = torch.empty(n_ml, device=q.device)
    acc = torch.empty(n_acc, device=q.device)
    out = torch.empty_like(q)
    turn = iter(range(1 << 30))
    lib = _cuda.library()

    def run():
        l = next(turn) % L
        with _cuda.on_device(q.device) as stream:
            rc = lib.qt_decode_attention_cut(
                cut, NQ, NKV, D, T, pos, D**-0.5, attn.chunks(pos),
                *(_cuda.ptr(t) for t in (q, kv[0, l, 0], kv[1, l, 0], ml, acc,
                                         attn.head_counters(q.device, NKV), out)),
                stream)
        _cuda.check(rc, "qt_decode_attention_cut")

    return run


def cp_weights(dev):
    cpc = CodePredictorConfig(vocab_size=2048, hidden_size=1024, intermediate_size=3072,
                              num_hidden_layers=5, num_attention_heads=16, num_key_value_heads=8,
                              head_dim=128)
    from ..models import talker as tk

    cp = hi.to_device(hi.host_init_cp_params(1, cpc, 1024), torch.bfloat16, dev)
    cp["layers"] = tk.fuse_layer_projections(cp["layers"])
    cp = quantize_decode_params_int8(cp, "lm_head")
    g = torch.Generator(device=dev).manual_seed(3)
    talker = {"codec_embedding": torch.randn(3072, 1024, generator=g, device=dev)
              .mul(0.05).to(torch.bfloat16)}
    return cpc, cp, talker


def kind_of(name: str) -> str:
    for key, kind in (("gemv", "gemv"), ("attn_step", "attention"), ("sample_kernel", "sampler"),
                      ("finish_", "finishing"), ("rms_copy", "finishing")):
        if key in name:
            return kind
    return "other"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def stack_io(layers) -> tuple[int, int]:
    """(bytes, weight elements) of a fused or unfused layer stack's
    projections and norms (int8 with scales, or dense bf16)."""
    from ..ops.quant import Int8Linear

    ws = [w for w in layers.values() if isinstance(w, (Int8Linear, torch.Tensor))]
    n_bytes = sum(nbytes(w.q, w.scale) if isinstance(w, Int8Linear) else nbytes(w) for w in ws)
    elems = sum(w.q.numel() for w in ws if isinstance(w, Int8Linear))
    elems += sum(w.numel() for w in ws if isinstance(w, torch.Tensor) and w.dim() == 3
                 and w.dtype == torch.bfloat16)
    return n_bytes, elems


def head_io(head) -> tuple[int, int]:
    from ..ops.quant import Int8Linear

    if isinstance(head, Int8Linear):
        return nbytes(head.q, head.scale), head.q.numel()
    return nbytes(head), head.numel()


def k2_bound(cp, cpc, B: int, th: int, dyn: bool) -> tuple[float, str]:
    """K2's bound at B rows: the stack, the 15 heads and the embedding rows
    read once, x0, codes and esum; 16 positions through the stack and 15
    heads a row (2 operations a weight), the attention over 16 slots."""
    NCB, H = cpc.num_code_groups - 1, cpc.hidden_size
    s_bytes, s_elems = stack_io(cp["layers"])
    h_bytes, h_elems = head_io(cp["lm_head"])
    n_bytes = (s_bytes + h_bytes + nbytes(cp["norm"]) + B * 2 * th * 2 + NCB * B * th * 2
               + B * NCB * 4 + B * th * 4)
    ops = (2 * B * (16 * s_elems + h_elems)
           + 16 * 4 * cpc.num_hidden_layers * cpc.num_attention_heads * cpc.head_dim * 16 * B)
    return bound(n_bytes, ops, PEAK_INT8 if dyn else PEAK_BF16)


def k2(dev, emit):
    cpc, cp, talker = cp_weights(dev)
    for B in BATCHES:
        g = torch.Generator(device=dev).manual_seed(B)
        h = torch.randn(B, 1024, generator=g, device=dev).mul(0.3).to(torch.bfloat16)
        c0 = torch.randint(0, 2048, (B,), generator=g, device=dev, dtype=torch.int32)
        for mode in ("wo_bf16", "dyn_int8"):
            fn = lambda: cpk.predict_codes_fused(cp, cpc, talker, h, c0, (3, 4), temperature=0.9,
                                                 top_k=50, mode=mode)
            # the windows hold the kernel library's launches and the
            # wrapper's few operand copies
            rec = dict(kernel="K2", B=B, mode=mode)
            if B in WIDE:
                ref = lambda: cpk.predict_codes_fused_ref(cp, cpc, talker, h, c0, (3, 4),
                                                          temperature=0.9, top_k=50, mode=mode)
                rec.update(events_ms=event_ms(fn, 10), plain_ms=event_ms(ref, 2))
                rec["bound_ms"], rec["bound_by"] = k2_bound(cp, cpc, B, 1024, mode == "dyn_int8")
            if B in (64, 256):
                split = device_ms_by_kernel(fn, 5)
                rec["ms"] = sum(split.values())
                by_kind: dict[str, float] = {}
                for name, t in split.items():
                    by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + t
                rec["by_kind"] = by_kind
            else:
                rec["ms"] = device_ms(fn, 5)
            emit(rec)


def gemv_alone(dev, emit, B=64):
    g = torch.Generator(device=dev).manual_seed(11)
    shapes = {"qkv": (1024, 4096), "o": (2048, 1024), "gate_up": (1024, 6144),
              "down": (3072, 1024), "head": (1024, 2048)}
    for name, (I, O) in shapes.items():
        x = torch.randn(B, I, generator=g, device=dev).mul(0.5).to(torch.bfloat16)
        w = torch.randint(-127, 128, (I, O), generator=g, device=dev, dtype=torch.int8)
        wb = w.to(torch.bfloat16)
        amax = x.float().abs().amax(1)
        xq = torch.round(x.float() / torch.clamp_min(amax * (1.0 / 127.0), 1e-12)[:, None]).to(torch.int8)
        for mode in ("wo_bf16", "dyn_int8"):
            a = amax if mode == "dyn_int8" else None
            t = {}
            for form, fn in (("mma", lambda: cpk.batched_gemv(x, w, a)),
                             ("fma", lambda: cpk.batched_gemv(x, w, a, tensor_cores=False)),
                             ("library", (lambda: torch._int_mm(xq, w)) if a is not None
                              else (lambda: torch.matmul(x, wb)))):
                try:
                    t[form] = device_ms(fn, 20)
                except RuntimeError as e:  # a yardstick this torch build does not offer
                    if form != "library":
                        raise
                    t[form] = f"not measured: {e}"
            n_bytes = I * O + B * I * 2 + B * O * 4
            b = bound(n_bytes, 2 * B * I * O, PEAK_INT8 if a is not None else PEAK_BF16)
            emit(dict(kernel="K2 batched GEMV", shape=name, I=I, O=O, B=B, mode=mode,
                      mma_ms=t["mma"], fma_ms=t["fma"], library_ms=t["library"],
                      library="torch._int_mm" if a is not None else "torch.matmul (bf16 weights)",
                      bound_ms=b[0], bound_by=b[1]))


K1_BATCHES = (1, 2, 8, 16, 33, 48, 64)


def talker_17b():
    """The 1.7B talker's widths (``__graft_entry__._flagship_17b``)."""
    import dataclasses

    return dataclasses.replace(talker_06b(), hidden_size=2048, text_hidden_size=2048,
                               intermediate_size=6144)


def k1(dev, emit):
    from ..models import talker as tk
    from ..ops import talker_kernel as tkk
    from ..ops.rope import mrope_cos_sin

    def run(cfg, tp, B, mode, label, T=256, lo=64, hi_=192):
        g = torch.Generator(device=dev).manual_seed(B)
        cache = tk.make_cache(cfg, B, T, torch.bfloat16, dev)
        cache.k.copy_(torch.randn(cache.k.shape, generator=g, device=dev).mul(0.5))
        cache.v.copy_(torch.randn(cache.v.shape, generator=g, device=dev).mul(0.5))
        offs = torch.randint(lo, hi_, (B,), generator=g, device=dev, dtype=torch.int32)
        x = torch.randn(B, 1, cfg.hidden_size, generator=g, device=dev).mul(0.2).bfloat16()
        cos, sin = mrope_cos_sin(offs.long()[None], cfg.head_dim, cfg.rope_theta,
                                 cfg.mrope_section, torch.bfloat16)
        cos, sin = cos[0], sin[0]
        supp = torch.zeros(cfg.vocab_size, device=dev)
        seen = torch.zeros(B, cfg.vocab_size, dtype=torch.bool, device=dev)
        one = B == 1
        off = int(offs[0]) if one else offs
        args = (cos[0], sin[0], seen[0]) if one else (cos, sin, seen)
        fn = lambda: tkk.talker_decode_step(tp, cfg, x, cache, off, args[0], args[1],
                                            temperature=0.9, top_k=50, rep_penalty=1.05,
                                            eos_id=-1, seed=(1, 2), suppress_add=supp,
                                            seen=args[2], mode=mode)
        rec = dict(kernel="K1", model=label, B=B, mode=mode, ms=device_ms(fn, 10),
                   events_ms=event_ms(fn, 10))
        if T != 256:  # a wide cell: the plain version and the bound beside it
            ref = lambda: tkk.talker_decode_step_ref(tp, cfg, x, cache, off, args[0], args[1],
                                                     temperature=0.9, top_k=50, rep_penalty=1.05,
                                                     eos_id=-1, seed=(1, 2), suppress_add=supp,
                                                     seen=args[2], mode=mode)
            rec.update(T=T, offsets=[lo, hi_], plain_ms=event_ms(ref, 2))
            rec["bound_ms"], rec["bound_by"] = k1_bound(tp, cfg, B, int(offs.sum()),
                                                        mode == "dyn_int8")
        emit(rec)
        del cache

    cfg = talker_06b()
    tp = int8_talker(cfg, dev)
    for B in K1_BATCHES:
        for mode in ("wo_bf16", "dyn_int8"):
            run(cfg, tp, B, mode, "0.6B int8")
    for B in WIDE:
        for mode in ("wo_bf16", "dyn_int8"):
            run(cfg, tp, B, mode, "0.6B int8", T=128, lo=20, hi_=120)
    del tp
    cfg17 = talker_17b()
    tp17 = int8_talker(cfg17, dev)
    run(cfg17, tp17, 64, "wo_bf16", "1.7B int8")
    run(cfg17, tp17, 256, "wo_bf16", "1.7B int8", T=128, lo=20, hi_=120)
    del tp17


def k1_bound(tp, cfg, B: int, prefix_rows: int, dyn: bool) -> tuple[float, str]:
    """K1's bound in sample mode on a bf16 cache: the weights once, x and
    the hidden, each row's prefix read and its new row written, the head,
    seen, mask and codes; 2 operations a weight a row and the attention's
    4 NQ D a cached row."""
    L, NKV, NQ, D = (cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.num_attention_heads,
                     cfg.head_dim)
    s_bytes, s_elems = stack_io(tp["layers"])
    h_bytes, h_elems = head_io(tp["codec_head"])
    V, H = cfg.vocab_size, cfg.hidden_size
    per_row = L * NKV * D * 2 * 2
    n_bytes = (s_bytes + h_bytes + nbytes(tp["norm"]) + 2 * B * H * 2
               + (prefix_rows + B) * per_row + B * V + V * 4 + B * 4)
    ops = 2 * B * (s_elems + h_elems) + 4 * L * NQ * D * (prefix_rows + B)
    return bound(n_bytes, ops, PEAK_INT8 if dyn else PEAK_BF16)


def k1b1_cases(dev):
    """(name, config, talker tree, mode, kv_quant, top_p) of the B = 1 cells:
    each weight mode at the three positions (the 0.6B int8 talker also on an
    int8 cache), and top_p 0.9."""
    from ..models import talker as tk

    cfg, cfg17 = talker_06b(), talker_17b()
    tp = int8_talker(cfg, dev)
    bf = hi.to_device(hi.host_init_talker_params(0, cfg), torch.bfloat16, dev)
    bf["layers"] = tk.fuse_layer_projections(bf["layers"])
    tp17 = int8_talker(cfg17, dev)
    return [
        ("0.6B int8", cfg, tp, "wo_bf16", False, 1.0),
        ("0.6B int8, int8 cache", cfg, tp, "wo_bf16", True, 1.0),
        ("0.6B dyn_int8", cfg, tp, "dyn_int8", False, 1.0),
        ("0.6B bf16 weights", cfg, bf, "wo_bf16", False, 1.0),
        ("1.7B int8", cfg17, tp17, "wo_bf16", False, 1.0),
        ("1.7B int8, int8 cache", cfg17, tp17, "wo_bf16", True, 1.0),
        ("0.6B int8, top_p 0.9", cfg, tp, "wo_bf16", False, 0.9),
    ]


K1B1_POSITIONS = ((256, 40), (4096, 4000), (6144, 6000))


def k1b1(dev, emit):
    import statistics
    import time

    from ..models import talker as tk
    from ..ops import talker_kernel as tkk
    from ..ops.rope import mrope_cos_sin

    persistent = hasattr(tkk, "STEP_CUTS")
    for name, cfg, tp, mode, kv_quant, top_p in k1b1_cases(dev):
        layers = tp["layers"]
        w_bytes = sum(t.numel() * t.element_size() for k in ("qkv_proj", "o_proj", "gate_up_proj",
                                                              "down_proj")
                      for t in ((layers[k].q, layers[k].scale) if hasattr(layers[k], "q")
                                else (layers[k],)))
        head = tp["codec_head"]
        w_bytes += sum(t.numel() * t.element_size()
                       for t in ((head.q, head.scale) if hasattr(head, "q") else (head,)))
        for T, pos in K1B1_POSITIONS if top_p == 1.0 else K1B1_POSITIONS[:1]:
            g = torch.Generator(device=dev).manual_seed(pos)
            cache = tk.make_cache(cfg, 1, T, torch.bfloat16, dev, quantized=kv_quant)
            if kv_quant:
                cache.k.copy_(torch.randint(-127, 128, cache.k.shape, generator=g, device=dev))
                cache.v.copy_(torch.randint(-127, 128, cache.v.shape, generator=g, device=dev))
                cache.ks.copy_(torch.rand(cache.ks.shape, generator=g, device=dev).mul(0.02))
                cache.vs.copy_(torch.rand(cache.vs.shape, generator=g, device=dev).mul(0.01))
            else:
                cache.k.copy_(torch.randn(cache.k.shape, generator=g, device=dev).mul(0.5))
                cache.v.copy_(torch.randn(cache.v.shape, generator=g, device=dev).mul(0.5))
            x = torch.randn(1, 1, cfg.hidden_size, generator=g, device=dev).mul(0.2).bfloat16()
            cos, sin = mrope_cos_sin(torch.full((1, 1), pos, device=dev), cfg.head_dim,
                                     cfg.rope_theta, cfg.mrope_section, torch.bfloat16)
            cos, sin = cos[0, 0], sin[0, 0]
            supp = torch.zeros(cfg.vocab_size, device=dev)
            seen = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=dev)
            kw = dict(temperature=0.9, top_k=50, top_p=top_p, rep_penalty=1.05, eos_id=-1,
                      seed=(1, 2), suppress_add=supp, seen=seen)
            call = lambda: tkk.talker_decode_step(tp, cfg, x, cache, pos, cos, sin, mode=mode,
                                                  **kw)
            # each cached row read once: k and v (with their row scales on an int8 cache)
            row = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads * (
                cfg.head_dim * (1 if kv_quant else 2) + (4 if kv_quant else 0))
            b = bound(w_bytes + pos * row, 0, PEAK_BF16)
            call()
            torch.cuda.synchronize()
            n0 = _cuda.launches()
            call()
            ops = _cuda.launches() - n0
            host = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                host.append((time.perf_counter() - t0) * 1e3)
            try:
                q_ms = queued_ms(call, 4)
            except RuntimeError as e:
                q_ms = f"not measured: {e}"[:200]
            rec = dict(kernel="K1", B=1, case=name, mode=mode, T=T, pos=pos, top_p=top_p,
                       events_ms=event_ms(call, 10), queued_ms=q_ms, graph_ms=graph_ms(call, 10),
                       bound_ms=b[0], bound_by=b[1], operations_per_call=ops,
                       host_ms=statistics.median(host), persistent=persistent)
            if persistent:
                lkw = dict(sample=True, temperature=0.9, top_k=50, top_p=top_p,
                           ref_exact_top_p=False, rep_penalty=1.05, eos_id=-1, seed=(1, 2),
                           suppress_add=supp, seen=seen, return_logits=False,
                           dyn=mode == "dyn_int8")
                if top_p == 1.0:
                    rec["cut_events_ms"] = {
                        cut_name: event_ms(lambda: tkk.launch(tp, cfg, x, cache, pos, cos, sin,
                                                              cut=cut, **lkw), 10)
                        for cut, cut_name in enumerate(tkk.STEP_CUTS, start=1)}
            emit(rec)
            del cache


def k2b1_cases(dev):
    """(name, CP config, CP tree, talker tree, mode, top_p, entry point) of
    every mode K2 takes at B = 1."""
    import dataclasses

    from ..models import talker as tk
    from ..ops import cp_kernel_old as cpk_old

    cpc, cp, talker = cp_weights(dev)
    bf = hi.to_device(hi.host_init_cp_params(1, cpc, 1024), torch.bfloat16, dev)
    bf["layers"] = tk.fuse_layer_projections(bf["layers"])
    unfused = quantize_decode_params_int8(
        hi.to_device(hi.host_init_cp_params(1, cpc, 1024), torch.bfloat16, dev), "lm_head")
    g = torch.Generator(device=dev).manual_seed(5)
    talker17 = {"codec_embedding": torch.randn(3072, 2048, generator=g, device=dev)
                .mul(0.05).to(torch.bfloat16)}
    p17 = {}
    for w in ("int8", "bf16"):
        t = hi.to_device(hi.host_init_cp_params(2, cpc, 2048), torch.bfloat16, dev)
        t["layers"] = tk.fuse_layer_projections(t["layers"])
        p17[w] = quantize_decode_params_int8(t, "lm_head") if w == "int8" else t
    k2 = cpk.predict_codes_fused
    return [
        ("int8 fused", cpc, cp, talker, "wo_bf16", 1.0, k2),
        ("int8 fused", cpc, cp, talker, "dyn_int8", 1.0, k2),
        ("int8 unfused", cpc, unfused, talker, "wo_bf16", 1.0, k2),
        ("int8 unfused", cpc, unfused, talker, "dyn_int8", 1.0, k2),
        ("bf16", cpc, bf, talker, "wo_bf16", 1.0, k2),
        ("1.7B projection int8", cpc, p17["int8"], talker17, "wo_bf16", 1.0, k2),
        ("1.7B projection int8", cpc, p17["int8"], talker17, "dyn_int8", 1.0, k2),
        ("1.7B projection bf16", cpc, p17["bf16"], talker17, "wo_bf16", 1.0, k2),
        ("int8 fused, top_p 0.9", cpc, cp, talker, "wo_bf16", 0.9, k2),
        ("K5's port, int8 fused", cpc, cp, talker, "wo_bf16", 1.0, cpk_old.predict_codes_fused),
    ]


def graph_ms(fn, iters: int = 20):
    """Events ms per call of ``fn`` captured once in a CUDA graph and
    replayed ``iters`` times back to back (warmed up on a side stream, as
    graph capture asks), or why it could not be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        return f"not captured: {e}"[:300]
    return event_ms(graph.replay, iters)


def k2b1(dev, emit):
    import inspect

    persistent = "cut" in inspect.signature(cpk.launch).parameters
    for name, cpc, cp, talker, mode, top_p, fn in k2b1_cases(dev):
        TH = talker["codec_embedding"].shape[1]
        g = torch.Generator(device=dev).manual_seed(1)
        h = torch.randn(1, TH, generator=g, device=dev).mul(0.3).to(torch.bfloat16)
        c0 = torch.tensor([17], dtype=torch.int32, device=dev)
        call = lambda: fn(cp, cpc, talker, h, c0, (3, 4), temperature=0.9, top_k=50, top_p=top_p,
                          mode=mode)
        rec = dict(kernel="K2", B=1, case=name, mode=mode, queued_ms=queued_ms(call, 10),
                   events_ms=event_ms(call, 20), graph_ms=graph_ms(call))
        if persistent and name in ("int8 fused", "1.7B projection int8") and top_p == 1.0:
            rec.update(frame_profile(cpc, cp, talker, h, c0, mode))
        emit(rec)


def frame_profile(cpc, cp, talker, h, c0, mode) -> dict:
    """The persistent frame's queued ms with its work cut after each kind of
    phase (``cp_kernel.FRAME_CUTS``)."""
    kw = dict(temperature=0.9, top_k=50, top_p=1.0, ref_exact_top_p=False, force_codes=None,
              return_logits=False, dyn=mode == "dyn_int8")
    args = (cp, cpc, talker, h, c0, (3, 4))
    return dict(cut_ms={name: queued_ms(lambda: cpk.launch(*args, cut=cut, **kw), 10)
                        for cut, name in enumerate(cpk.FRAME_CUTS, start=1)})


def e2e(dev, emit):
    import statistics
    import time

    from ..config import TokenizerDecoderConfig
    from ..models import batch_generate as bg
    from ..models import generate as gen
    from ..models import talker as tk
    from ..tts import _generate_and_decode

    cfg = talker_06b()
    cpc = cfg.code_predictor_config
    tp = int8_talker(cfg, dev)
    cp = hi.to_device(hi.host_init_cp_params(1, cpc, cfg.hidden_size), torch.bfloat16, dev)
    cp["layers"] = tk.fuse_layer_projections(cp["layers"])
    cp = quantize_decode_params_int8(cp, "lm_head")
    dec_cfg = TokenizerDecoderConfig()
    voc = hi.init_vocoder_params(torch.Generator(device=dev).manual_seed(2), dec_cfg,
                                 torch.float32, dev)
    H, frames, p_len = cfg.hidden_size, 66, 24
    sampling = gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True)
    p_bucket = gen.pad_to_bucket(p_len)
    g = torch.Generator(device=dev).manual_seed(0)
    prefill = torch.randn(1, p_bucket, H, generator=g, device=dev).mul(0.05).to(torch.bfloat16)
    trailing = torch.randn(64, H, generator=g, device=dev).mul(0.05).to(torch.bfloat16)
    pad = torch.zeros(H, dtype=torch.bfloat16, device=dev)
    run = dict(talker_cfg=cfg, cp_cfg=cpc, sampling=sampling, prefill_embeds=prefill,
               prefill_len=p_len, trailing_embeds=trailing, trailing_len=12, tts_pad_embed=pad,
               max_frames=128)
    cache_len = -(-(p_bucket + 128) // 128) * 128

    def wall(seed):
        torch.cuda.synchronize()
        t = time.time()
        _generate_and_decode(tp, cp, voc, dec_cfg=dec_cfg, **run, max_steps=frames, seed=seed,
                             cache_len=cache_len)
        torch.cuda.synchronize()
        return time.time() - t

    def decode_ms():
        c = gen.prefill_start(tp, cp, **run, cache=tk.make_cache(cfg, 1, cache_len,
                                                                 torch.bfloat16, dev), seed=9)
        torch.cuda.synchronize()
        t = time.time()
        gen.generate_chunk(tp, cp, c, talker_cfg=cfg, cp_cfg=cpc, sampling=sampling,
                           trailing_embeds=trailing, trailing_len=12, tts_pad_embed=pad,
                           until_step=frames)
        torch.cuda.synchronize()
        return (time.time() - t) * 1000 / (frames - 1)

    wall(0)
    w = statistics.median(wall(s) for s in (1, 2, 3))
    emit(dict(kernel="e2e", case="B=1 headline, 0.6B int8", wall_s=w, rtf=w / (frames / 12.5),
              decode_ms=statistics.median(decode_ms() for _ in range(3))))
    B = 64
    gb = torch.Generator(device=dev).manual_seed(0)
    pre = torch.randn(B, p_bucket, H, generator=gb, device=dev).mul(0.05).to(torch.bfloat16)
    trail = torch.randn(B, 64, H, generator=gb, device=dev).mul(0.05).to(torch.bfloat16)
    common = dict(talker_cfg=cfg, cp_cfg=cpc, sampling=sampling, trailing_embeds=trail,
                  trailing_lens=torch.full((B,), 12, dtype=torch.int32, device=dev),
                  tts_pad_embed=pad)

    def lockstep_ms():
        c = bg.prefill_start_batch(
            tp, cp, **common, prefill_embeds=pre,
            prefill_lens=torch.full((B,), p_len, dtype=torch.int32, device=dev),
            cache=tk.make_cache(cfg, B, 128, torch.bfloat16, dev), max_frames=72, seed=0)
        torch.cuda.synchronize()
        t = time.time()
        bg.generate_chunk_batch(tp, cp, c, **common,
                                max_steps=torch.full((B,), frames, dtype=torch.int32, device=dev),
                                until_step=72)
        torch.cuda.synchronize()
        return (time.time() - t) * 1000 / (frames - 1)

    lockstep_ms()
    ms = statistics.median(lockstep_ms() for _ in range(3))
    emit(dict(kernel="e2e", case="B=64 lockstep frame, 0.6B int8, 128-row bf16 cache",
              ms_per_frame=ms, codec_tokens_s=B * 16 * 1000 / ms))


def int4lib(dev, emit):
    import inspect

    from ..ops import quant as tq

    shapes = {"q": (1024, 2048), "k/v": (1024, 1024), "o": (2048, 1024), "gate/up": (1024, 3072),
              "down": (3072, 1024), "codec_head": (1024, 3072), "cp lm_head": (1024, 2048)}
    forms = "rows_per_warp" in inspect.signature(tq.quant_gemv).parameters
    rng = np.random.default_rng(4)
    for bits in (4, 8):
        for name, (I, O) in shapes.items():
            q, scales, biases = tq.pack_quantized(
                rng.standard_normal((O, I)).astype(np.float32) * 0.02, bits)
            w = tq.packed_from_numpy(q, scales, biases, bits, 64).to(dev)
            x = torch.from_numpy(rng.standard_normal((1, I)).astype(np.float32)).to(dev).bfloat16()
            ref = x.float() @ tq.dequantize(w.q, w.scales, w.biases, bits).T
            k4 = lambda: tq.quant_gemv(x, w.q, w.scales, w.biases, bits)
            n_bytes = sum(t.numel() * t.element_size() for t in (w.q, w.scales, w.biases, x))
            rec = dict(kernel="K4 and its library yardstick", bits=bits, shape=name, I=I, O=O,
                       k4_ms=device_ms(k4, 20), k4_queued_ms=queued_ms(k4, 20),
                       k4_scaled_err=float((k4() - ref).abs().max()
                                           / max(1.0, float(ref.abs().max()))),
                       bound_ms=n_bytes / HBM_BYTES_S * 1e3)
            if forms:
                rec["k4_queued_ms_by_rows_per_warp"] = {
                    r: queued_ms(lambda: tq.quant_gemv(x, w.q, w.scales, w.biases, bits,
                                                       rows_per_warp=r), 20)
                    for r in (1, 2, 4, 8)}
            if bits == 4:
                try:  # MLX codes as int4pack's operands (exp_int4_repack builds them)
                    from .exp_int4_repack import int4pack_operands

                    ops = int4pack_operands(dict(packed=w.q, scales=w.scales, biases=w.biases,
                                                 x=x), 64)
                    lib = lambda: torch._weight_int4pack_mm(*ops)
                    rec["library_ms"] = device_ms(lib, 20)
                    rec["library_queued_ms"] = queued_ms(lib, 20)
                    rec["library_scaled_err"] = float((lib().float() - ref).abs().max()
                                                      / max(1.0, float(ref.abs().max())))
                except (RuntimeError, AttributeError, TypeError) as e:  # a build without the op
                    rec["library_ms"] = f"not available: {e}"[:300]
            emit(rec)


QGEMM_SHAPES = [(2048, 1024), (1024, 1024), (1024, 2048), (3072, 1024), (1024, 3072)]  # (O, I)
QGEMM_ROWS = (2, 4, 8, 16, 24, 25, 64, 65, 256, 512, 4096)


def qgemm(dev, emit):
    """``quant_gemm`` (K4's function at M rows) at the five distinct packed
    0.6B (O, I), M rows, int4 and int8 at group 64, bf16 and f32 x: us a
    call queued behind a spin kernel over copies of the weight that hold
    64 MB (no call finds its weight in the 50 MB L2), the scaled error
    against ``quant_matmul``, the bound (words, scales, biases, x and y once
    over 3.35 TB/s, or 2 M O I operations, three times that for an f32 x,
    over 989 TFLOP/s: the larger) and, at int4 with a bf16 x,
    ``torch._weight_int4pack_mm`` on the same weights and M rows queued the
    same way. Where the tree's ``quant_gemm`` takes ``form=``, the form it
    picks, and each form that takes the case forced too up to 65 rows (the
    crossovers' neighbourhood)."""
    import inspect

    from ..ops import quant as tq
    from .exp_int4_repack import int4pack_operands

    forms = "form" in inspect.signature(tq.quant_gemm).parameters
    rs = np.random.default_rng(19)
    g = torch.Generator(device=dev).manual_seed(19)

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def walk(fn, copies):
        turn = iter(range(1 << 30))
        return lambda: fn(copies[next(turn) % len(copies)])

    for bits in (4, 8):
        for O, I in QGEMM_SHAPES:
            w = rs.standard_normal((O, I), dtype=np.float32) / np.float32(np.sqrt(I))
            pw = tq.packed_from_numpy(*tq.pack_quantized(w, bits, 64), bits, 64).to(dev)
            copies = [(pw.q.clone(), pw.scales.clone(), pw.biases.clone())
                      for _ in range(-(-(64 << 20) // nb(pw.q, pw.scales, pw.biases)))]
            lib = None
            if bits == 4:
                op = int4pack_operands(dict(packed=pw.q, scales=pw.scales, biases=pw.biases,
                                            x=torch.zeros(1, I, device=dev)), 64)
                lib = [(op[1].clone(), op[3].clone())
                       for _ in range(-(-(64 << 20) // nb(op[1], op[3])))]
            for M in QGEMM_ROWS:
                x32 = torch.randn(M, I, generator=g, device=dev)
                for xdt in (torch.bfloat16, torch.float32):
                    x = x32.to(xdt)
                    ref = tq.quant_matmul(x, pw.q, pw.scales, pw.biases, bits, 64)
                    yk = tq.quant_gemm(x, pw.q, pw.scales, pw.biases, bits, 64)
                    ops = 2 * M * O * I * (1 if xdt == torch.bfloat16 else 3)
                    t_b = nb(pw.q, pw.scales, pw.biases, x, yk) / HBM_BYTES_S * 1e3
                    t_o = ops / PEAK_BF16 * 1e3
                    rec = dict(kernel="quant_gemm", bits=bits, group=64, O=O, I=I, M=M,
                               x=str(xdt)[6:], scaled_err=float((yk - ref).abs().max()
                                                               / max(1.0, float(ref.abs().max()))),
                               queued_ms=queued_ms(walk(lambda c: tq.quant_gemm(
                                   x, *c, bits, 64), copies), 2 * len(copies)),
                               bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else
                               "operations")
                    if forms:
                        rec["form"] = tq.quant_gemm_form(M, O, I, bits, 64, xdt)
                        if M <= 65:
                            each = ("stream", "staged") + (
                                ("rows",) if M <= 2 and xdt == torch.bfloat16 else ())
                            rec["queued_ms_by_form"] = {f: queued_ms(walk(
                                lambda c, f=f: tq.quant_gemm(x, *c, bits, 64, form=f), copies),
                                2 * len(copies)) for f in each}
                    if lib is not None and xdt == torch.bfloat16:
                        xl = x.contiguous()
                        rec["library_queued_ms"] = queued_ms(walk(
                            lambda c: torch._weight_int4pack_mm(xl, c[0], 64, c[1]), lib),
                            2 * len(lib))
                    emit(rec)
            del copies, lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parts", default="k3,k2,gemv",
                    help="any of k3, k2, gemv, k1, k1b1, k2b1, e2e, int4lib, qgemm")
    ap.add_argument("--out", default=None, help="a directory for the JSON lines file too")
    args = ap.parse_args()
    parts = args.parts.split(",")
    dev = require_cuda("time_k3_k2")
    smi = card()
    out = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        out = open(os.path.join(args.out, f"time_k3_k2_{args.label}.jsonl"), "a")

    def emit(rec):
        line = json.dumps(dict(rec, label=args.label, card=smi))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for _ in range(args.rounds):
        if "k3" in parts:
            k3(dev, emit)
        if "k2" in parts:
            k2(dev, emit)
        if "gemv" in parts and hasattr(cpk, "batched_gemv"):
            for B in (64, 256):
                gemv_alone(dev, emit, B)
        if "k1" in parts:
            k1(dev, emit)
        if "k1b1" in parts:
            k1b1(dev, emit)
        if "k2b1" in parts:
            k2b1(dev, emit)
        if "e2e" in parts:
            e2e(dev, emit)
        if "int4lib" in parts:
            int4lib(dev, emit)
        if "qgemm" in parts:
            qgemm(dev, emit)
    if out:
        out.close()


if __name__ == "__main__":
    main()
