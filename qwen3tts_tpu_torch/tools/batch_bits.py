"""Digests of K1's, K2's and the batched GEMV's outputs at B = 8 and 64, to
hold two trees' kernels to the bit on one card.

Each case runs once on fixed inputs (``torch.Generator`` seeds on the card,
host_init weights at the 0.6B widths) and its outputs are reduced to one
SHA-256 over their bytes:

- ``gemv``: the batched GEMV alone (``cp_kernel.batched_gemv``) at the CP's
  five shapes, on int8 (``wo_bf16``), dense bf16 and ``dyn_int8``, in its
  tensor-core and CUDA-core forms: the split partials;
- ``k1``: K1's step (sample mode, T = 0.9, top-k 50) on the 0.6B int8
  talker in ``wo_bf16`` and ``dyn_int8`` and on its dense bf16 copy, on a
  128-row bf16 and a 512-row int8 cache of random rows at ragged offsets:
  hidden, code0, logits and the cache after the call;
- ``k2``: K2's frame on the 0.6B int8 CP in both modes, greedy with its
  logits and sampled: codes, esum and logits.

Run from a checkout's root on a CUDA device:

    python -m qwen3tts_tpu_torch.tools.batch_bits --out DIR [--label L]
    python -m qwen3tts_tpu_torch.tools.batch_bits --compare A.json B.json

It uses only entry points older trees share, so it runs in another tree
copied beside ``_card.py``; ``--compare`` prints the cases that differ and
exits 1 if any does.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import torch

BATCHES = (8, 64)
GEMV_SHAPES = {"qkv": (1024, 4096), "o": (2048, 1024), "gate_up": (1024, 6144),
               "down": (3072, 1024), "head": (1024, 2048)}


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def gemv_cases(dev, out: dict) -> None:
    from ..ops import cp_kernel as cpk

    for B in BATCHES:
        for name, (I, O) in GEMV_SHAPES.items():
            g = torch.Generator(device=dev).manual_seed(B * 131 + I + O)
            x = torch.randn(B, I, generator=g, device=dev).mul(0.5).to(torch.bfloat16)
            w8 = torch.randint(-127, 128, (I, O), generator=g, device=dev, dtype=torch.int8)
            wb = torch.randn(I, O, generator=g, device=dev).mul(0.05).to(torch.bfloat16)
            amax = x.float().abs().amax(1)
            for mode, w, a in (("wo_bf16", w8, None), ("bf16", wb, None), ("dyn_int8", w8, amax)):
                for form in ("mma", "fma"):
                    part = cpk.batched_gemv(x, w, a, tensor_cores=form == "mma")
                    out[f"gemv B={B} {name} {mode} {form}"] = digest(part)


def k1_cases(dev, out: dict) -> None:
    from ..models import talker as tk
    from ..ops import talker_kernel as tkk
    from ..ops.rope import mrope_cos_sin
    from ..utils import host_init as hi
    from ._card import int8_talker, talker_06b

    cfg = talker_06b()
    t8 = int8_talker(cfg, dev)
    tb = hi.to_device(hi.host_init_talker_params(0, cfg), torch.bfloat16, dev)
    tb["layers"] = tk.fuse_layer_projections(tb["layers"])
    V, D = cfg.vocab_size, cfg.head_dim
    for B in BATCHES:
        for kv_quant, T in ((False, 128), (True, 512)):
            g = torch.Generator(device=dev).manual_seed(B + T)
            cache = tk.make_cache(cfg, B, T, torch.bfloat16, dev, quantized=kv_quant)
            if kv_quant:
                cache.k.copy_(torch.randint(-127, 128, cache.k.shape, generator=g, device=dev))
                cache.v.copy_(torch.randint(-127, 128, cache.v.shape, generator=g, device=dev))
                cache.ks.copy_(torch.rand(cache.ks.shape, generator=g, device=dev).mul(0.03))
                cache.vs.copy_(torch.rand(cache.vs.shape, generator=g, device=dev).mul(0.015))
            else:
                cache.k.copy_(torch.randn(cache.k.shape, generator=g, device=dev))
                cache.v.copy_(torch.randn(cache.v.shape, generator=g, device=dev).mul(0.5))
            offs = torch.randint(T // 8, T - 8, (B,), generator=g, device=dev, dtype=torch.int32)
            x = torch.randn(B, 1, cfg.hidden_size, generator=g, device=dev).mul(0.05).bfloat16()
            cos, sin = mrope_cos_sin(offs.long()[None], D, cfg.rope_theta, cfg.mrope_section,
                                     torch.bfloat16)
            supp = torch.zeros(V, device=dev)
            seen = torch.rand(B, V, generator=g, device=dev) < 0.005
            for label, tp, mode in (("int8 wo_bf16", t8, "wo_bf16"), ("int8 dyn_int8", t8, "dyn_int8"),
                                    ("bf16", tb, "wo_bf16")):
                c = type(cache)(*(t.clone() for t in cache))
                h, code, logits = tkk.talker_decode_step(
                    tp, cfg, x, c, offs, cos[0], sin[0], temperature=0.9, top_k=50,
                    rep_penalty=1.05, eos_id=-1, seed=(3, 4), suppress_add=supp, seen=seen,
                    return_logits=True, mode=mode)
                out[f"k1 B={B} {label} {'int8' if kv_quant else 'bf16'} cache of {T}"] = digest(
                    h, code, logits, *c)
            del cache


def k2_cases(dev, out: dict) -> None:
    from ..ops import cp_kernel as cpk
    from .time_k3_k2 import cp_weights

    cpc, cp, talker = cp_weights(dev)
    for B in BATCHES:
        g = torch.Generator(device=dev).manual_seed(B)
        h = torch.randn(B, 1024, generator=g, device=dev).mul(0.3).to(torch.bfloat16)
        c0 = torch.randint(0, 2048, (B,), generator=g, device=dev, dtype=torch.int32)
        for mode in ("wo_bf16", "dyn_int8"):
            greedy = cpk.predict_codes_fused(cp, cpc, talker, h, c0, (5, 6), temperature=0.0,
                                             top_k=50, return_logits=True, mode=mode)
            sampled = cpk.predict_codes_fused(cp, cpc, talker, h, c0, (7, 8), temperature=0.9,
                                              top_k=50, mode=mode)
            out[f"k2 B={B} {mode}"] = digest(*greedy, *sampled)


def group_digests(out: dict) -> dict[str, str]:
    """One SHA-256 a group of cases (``gemv``, ``k1``, ``k2``: the case
    name's first word) over its ``name=digest;`` pairs in name order."""
    groups: dict[str, str] = {}
    for k in sorted(out):
        groups[k.split()[0]] = groups.get(k.split()[0], "") + f"{k}={out[k]};"
    return {g: hashlib.sha256(j.encode()).hexdigest() for g, j in groups.items()}


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    differ = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
    for k in differ:
        print(f"differs: {k}")
    print(json.dumps(dict(cases=len(a.keys() | b.keys()), equal=len(a.keys() | b.keys()) - len(differ),
                          differ=len(differ))))
    return 1 if differ else 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="a directory for batch_bits_L.json")
    ap.add_argument("--compare", nargs=2, default=None, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        sys.exit(compare(*args.compare))
    from ._card import card, require_cuda

    dev = require_cuda("batch_bits")
    out: dict[str, str] = {}
    gemv_cases(dev, out)
    k1_cases(dev, out)
    k2_cases(dev, out)
    torch.cuda.synchronize()
    print(json.dumps(dict(label=args.label, card=card(), cases=len(out),
                          groups=group_digests(out))), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"batch_bits_{args.label}.json"), "w") as f:
            json.dump(out, f, indent=0, sort_keys=True)


if __name__ == "__main__":
    main()
