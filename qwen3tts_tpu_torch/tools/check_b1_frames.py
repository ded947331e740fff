"""Every persistent B = 1 launch of the port once, for a checker run around
the process.

K2's frame (csrc/cp_loop.cu, ``cp_frame``) in each mode it takes at B = 1
(int8 fused in ``wo_bf16`` and ``dyn_int8``, unfused int8, dense bf16, the
projection of a CP narrower than its talker, top-p), and K1's step
(csrc/talker_frame.cu, ``talker_frame``) in each mode it takes (int8 in
``wo_bf16`` and ``dyn_int8`` and dense bf16 weights, on bf16 and int8
caches, at one chunk and at several, sample mode with and without top-p,
and non-sample mode), each followed by a synchronisation, so that a fault
is reported at the launch that made it. The widths are small (a 256-wide
talker of 2 layers; the CP 256 wide) unless ``--full`` (the 0.6B widths).
Needs a CUDA device. Run from a checkout's root, for example:

    compute-sanitizer --tool memcheck python -m qwen3tts_tpu_torch.tools.check_b1_frames
    compute-sanitizer --tool racecheck python -m qwen3tts_tpu_torch.tools.check_b1_frames

It prints one line a launch and ``ok`` at the end.
"""

from __future__ import annotations

import argparse

import torch

from .. import config as C
from ..models import talker as tk
from ..ops import cp_kernel as cpk
from ..ops import talker_kernel as tkk
from ..ops.quant import quantize_decode_params_int8
from ..ops.rope import mrope_cos_sin
from ..utils import host_init as hi
from ._card import require_cuda, talker_06b


def _fused(tree, head=None):
    tree["layers"] = tk.fuse_layer_projections(tree["layers"])
    return tree if head is None else quantize_decode_params_int8(tree, head)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="the 0.6B widths")
    args = ap.parse_args()
    dev = require_cuda("check_b1_frames")
    if args.full:
        cfg = talker_06b()
        cpc = cfg.code_predictor_config
    else:
        cpc = C.CodePredictorConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                                    num_hidden_layers=2, num_attention_heads=16,
                                    num_key_value_heads=8, head_dim=128)
        cfg = C.TalkerConfig(vocab_size=3072, text_vocab_size=64, hidden_size=256,
                             text_hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2, head_dim=128,
                             code_predictor_config=cpc)
    H = cfg.hidden_size
    host = lambda tree: hi.to_device(tree, torch.bfloat16, dev)
    tp8 = _fused(host(hi.host_init_talker_params(0, cfg)), "codec_head")
    tpb = _fused(host(hi.host_init_talker_params(0, cfg)))
    cp8 = _fused(host(hi.host_init_cp_params(1, cpc, H)), "lm_head")
    cpb = _fused(host(hi.host_init_cp_params(1, cpc, H)))
    cpu = quantize_decode_params_int8(host(hi.host_init_cp_params(1, cpc, H)), "lm_head")
    cpn = _fused(host(hi.host_init_cp_params(2, cpc, 2 * H)), "lm_head")  # with its projection
    g = torch.Generator(device=dev).manual_seed(0)
    wide = {"codec_embedding": torch.randn(cfg.vocab_size, 2 * H, generator=g, device=dev)
            .mul(0.05).bfloat16()}
    h = torch.randn(1, H, generator=g, device=dev).mul(0.3).bfloat16()
    c0 = torch.tensor([5], dtype=torch.int32, device=dev)
    for name, cp, talker, hid, mode, top_p in (
        ("int8 fused", cp8, tp8, h, "wo_bf16", 1.0), ("int8 fused", cp8, tp8, h, "dyn_int8", 1.0),
        ("int8 unfused", cpu, tp8, h, "wo_bf16", 1.0), ("bf16", cpb, tp8, h, "wo_bf16", 1.0),
        ("projection int8", cpn, wide, torch.randn(1, 2 * H, generator=g, device=dev)
         .mul(0.3).bfloat16(), "wo_bf16", 1.0),
        ("int8 fused, top_p 0.8", cp8, tp8, h, "wo_bf16", 0.8),
    ):
        cpk.predict_codes_fused(cp, cpc, talker, hid, c0, (3, 4), temperature=0.9, top_k=50,
                                top_p=top_p, mode=mode)
        torch.cuda.synchronize()
        cpk.check_barrier(dev)
        print(f"K2 B=1 {name} {mode}", flush=True)
    V = cfg.vocab_size
    supp, seen = torch.zeros(V, device=dev), torch.zeros(V, dtype=torch.bool, device=dev)
    for name, tp, mode, quant, T, pos, sample, top_p in (
        ("int8", tp8, "wo_bf16", False, 512, 70, True, 1.0),
        ("int8", tp8, "wo_bf16", False, 512, 400, True, 1.0),
        ("int8", tp8, "dyn_int8", True, 512, 400, True, 1.0),
        ("int8", tp8, "wo_bf16", True, 512, 0, True, 1.0),
        ("bf16", tpb, "wo_bf16", False, 512, 300, True, 0.9),
        ("int8", tp8, "wo_bf16", False, 512, 300, False, 1.0),
    ):
        cache = tk.make_cache(cfg, 1, T, torch.bfloat16, dev, quantized=quant)
        if quant:
            cache.k.copy_(torch.randint(-127, 128, cache.k.shape, generator=g, device=dev))
            cache.v.copy_(torch.randint(-127, 128, cache.v.shape, generator=g, device=dev))
            cache.ks.fill_(0.01)
            cache.vs.fill_(0.01)
        else:
            cache.k.copy_(torch.randn(cache.k.shape, generator=g, device=dev))
            cache.v.copy_(torch.randn(cache.v.shape, generator=g, device=dev))
        x = torch.randn(1, 1, H, generator=g, device=dev).mul(0.2).bfloat16()
        cos, sin = mrope_cos_sin(torch.full((1, 1), pos, device=dev), cfg.head_dim,
                                 cfg.rope_theta, cfg.mrope_section, torch.bfloat16)
        tkk.talker_decode_step(tp, cfg, x, cache, pos, cos[0, 0], sin[0, 0], sample=sample,
                               temperature=0.9, top_k=50, top_p=top_p, rep_penalty=1.05,
                               eos_id=-1, seed=(1, 2), suppress_add=supp, seen=seen, mode=mode)
        torch.cuda.synchronize()
        tkk.check_barrier(dev)
        print(f"K1 B=1 {name} {mode} {'int8' if quant else 'bf16'} cache pos {pos} "
              f"{'sample' if sample else 'hidden'} top_p {top_p}", flush=True)
    print("ok", flush=True)


if __name__ == "__main__":
    main()
