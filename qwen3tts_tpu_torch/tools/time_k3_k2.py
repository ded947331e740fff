"""Device times of K3 (long-prefix decode attention) and K2 (the CP loop)
at the shapes their eighth-slice redesign targets, with their yardsticks.

- K3 at pos 40 / 4000 / 6000 of 4096 / 4096 / 6144 rows, over the 0.6B
  talker's 28 layers in turn (no call finds the last one's bytes in the
  L2), beside ``scaled_dot_product_attention(enable_gqa=True)`` on the same
  prefix and the bound (the prefix's k/v bytes at 3.35 TB/s); where the
  tree has it, K3's profile: its kernel cut after the loads, the scores,
  the softmax, the PV sums, their sum over row groups and the partials
  written out (``qt_decode_attention_cut``).
- K2 at B in {2, 8, 16, 17, 33, 48, 64}, 0.6B int8 CP, ``wo_bf16`` and
  ``dyn_int8``: device ms per frame, and at B=64 that time split by kernel
  (GEMV, attention, sampler, finishing).
- Where the tree has it, K2's batched GEMV alone at B=64 at the CP's five
  shapes: the tensor-core form, the CUDA-core form and one library call
  (``torch.matmul`` on bf16 weights; ``torch._int_mm`` in dyn_int8).

Every device time is a profiler window held to the kernels of its calls
(``_card.device_ms``). Needs a CUDA device. Run from a checkout's root:

    python -m qwen3tts_tpu_torch.tools.time_k3_k2 [--label L] [--rounds N] \
        [--parts k3,k2,gemv] [--out DIR]

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

import torch

from ..config import CodePredictorConfig
from ..ops import _cuda
from ..ops import attention as attn
from ..ops import cp_kernel as cpk
from ..ops.quant import quantize_decode_params_int8
from ..utils import host_init as hi
from ._card import HBM_BYTES_S, card, device_ms, device_ms_by_kernel, require_cuda

PEAK_BF16, PEAK_INT8 = 989e12, 1979e12  # H100 SXM dense tensor rates, 700 W
BATCHES = (2, 8, 16, 17, 33, 48, 64)


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
        rc = lib.qt_decode_attention_cut(
            cut, NQ, NKV, D, T, pos, D**-0.5, attn.chunks(pos),
            *(_cuda.ptr(t) for t in (q, kv[0, l, 0], kv[1, l, 0], ml, acc,
                                     attn.head_counters(q.device, NKV), out)),
            _cuda.stream_ptr())
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
            if B == 64:
                split = device_ms_by_kernel(fn, 5)
                rec["ms"] = sum(split.values())
                by_kind: dict[str, float] = {}
                for name, t in split.items():
                    by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + t
                rec["by_kind"] = by_kind
            else:
                rec["ms"] = device_ms(fn, 5)
            emit(rec)


def gemv_alone(dev, emit):
    B = 64
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parts", default="k3,k2,gemv", help="any of k3, k2, gemv")
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
            gemv_alone(dev, emit)
    if out:
        out.close()


if __name__ == "__main__":
    main()
