"""Dry run of the port's multi-device paths, the counterpart of
``__graft_entry__.dryrun_multichip``:

    python -m qwen3tts_tpu_torch.tools.dryrun_multichip N [--cpu]

on a mesh of N devices: the cards, ``cuda:i % device_count()`` for i < N (a
card named more than once when there are fewer than N; no card raises), or
with ``--cpu`` ``["cpu"] * N`` (the positions take turns on the one CPU).
Three phases, as the JAX package's:

  A. tiny TP generation: ``generate_codes`` under a (dp, tp) mesh with tp =
     gcd(N, 8) on sharded f32 weights (16 q / 8 kv heads, so tp divides
     them), then the vocoder on the mesh's first device;
  B. the 0.6B continuous path under that mesh: two admissions
     (``admit_slot``) of heterogeneous prompts and two decode chunks
     (``generate_chunk_batch``) over 2 KV slots, at the real 0.6B widths
     and depth (f32 on the CPU, bf16 on the cards);
  C. the dp scale-out: ``generate_codes_batch_dp`` over a tp = 1 mesh of
     the N devices, one sequence a device, with per-request sampling, at
     the 0.6B widths with 2 layers (dp replicates the weights on every
     distinct device). On the cards the weights are fused and int8, so K1
     and K2 serve every shard; on the CPU they stay unfused f32.

Phase B's 0.6B f32 weights take ~5 GB of host memory on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from ..config import CodePredictorConfig, TalkerConfig, TokenizerDecoderConfig
from ..models import batch_generate as bg
from ..models import generate as gen
from ..models import talker as tk
from ..models import vocoder as vc
from ..parallel import dp as pdp
from ..parallel import mesh as pm
from ..serving import _one_carry
from ..utils import host_init as hi
from ._card import talker_06b

TINY = TalkerConfig(
    vocab_size=3072, text_vocab_size=256, hidden_size=128, text_hidden_size=128,
    intermediate_size=256, num_hidden_layers=2, num_attention_heads=16, num_key_value_heads=8,
    head_dim=8,
    code_predictor_config=CodePredictorConfig(
        vocab_size=2048, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=16, num_key_value_heads=8, head_dim=8,
    ),
)
# full 2048-entry codebooks: every generated code indexes in range
TINY_VOCODER = TokenizerDecoderConfig(
    latent_dim=32, codebook_dim=16, decoder_dim=64, hidden_size=16, intermediate_size=32,
    num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2, head_dim=8,
)


def mesh_devices(n: int, cpu: bool = False) -> list[torch.device]:
    """N mesh positions: the cards in turn, or with ``cpu`` the CPU N times."""
    if cpu:
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("dryrun_multichip: no CUDA device is available (pass --cpu to run "
                           "on the CPU)")
    return [torch.device("cuda", i % count) for i in range(n)]


def _trees(cfg: TalkerConfig, dtype, device, seed: int = 0):
    cpc = cfg.code_predictor_config
    return (hi.to_device(hi.host_init_talker_params(seed, cfg), dtype, device),
            hi.to_device(hi.host_init_cp_params(seed + 1, cpc, cfg.hidden_size), dtype, device))


def phase_a(mesh: pm.Mesh, cfg: TalkerConfig = TINY, voc_cfg=TINY_VOCODER) -> int:
    """Tiny TP generation and the vocoder; returns the frames generated."""
    home = mesh.home
    tkp, cpp = _trees(cfg, torch.float32, "cpu")
    tkp, cpp = pm.shard_talker(tkp, mesh), pm.shard_cp(cpp, mesh)
    g = torch.Generator().manual_seed(2)
    h = cfg.hidden_size
    res = gen.generate_codes(
        tkp, cpp, talker_cfg=cfg, cp_cfg=cfg.code_predictor_config,
        sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05),
        prefill_embeds=(torch.randn(1, 16, h, generator=g) * 0.1).to(home), prefill_len=12,
        trailing_embeds=torch.zeros(8, h, device=home), trailing_len=4,
        tts_pad_embed=torch.zeros(h, device=home), max_steps=3, max_frames=8, seed=3,
        cache=tk.make_cache(cfg, 1, 64, torch.float32, home, mesh=mesh),
    )
    n = res.n_frames
    if n < 1:
        raise RuntimeError("dryrun generated no frames")
    vp = hi.init_vocoder_params(torch.Generator(device=home).manual_seed(4), voc_cfg,
                                torch.float32, home)
    wav, lengths = vc.decode(vp, voc_cfg, res.codes[None], n)
    if int(lengths[0]) != n * voc_cfg.total_upsample or not bool(torch.isfinite(wav).all()):
        raise RuntimeError(f"vocoder gave {int(lengths[0])} samples for {n} frames")
    print(f"dryrun OK: {n} frames on {mesh} (tp={mesh.shape['tp']})", flush=True)
    return n


def phase_b(mesh: pm.Mesh, cfg: TalkerConfig, dtype) -> list[int]:
    """The continuous-batching entry points under the mesh over 2 slots;
    returns the frames of each slot."""
    home = mesh.home
    t0 = time.time()
    tkp, cpp = _trees(cfg, dtype, "cpu")
    tkp, cpp = pm.shard_talker(tkp, mesh), pm.shard_cp(cpp, mesh)
    print(f"phase B: params sharded in {time.time() - t0:.0f}s", flush=True)
    B, P_BUCKET, T_TRAIL, MAX_FRAMES, CACHE = 2, 16, 8, 4, 128
    h = cfg.hidden_size
    common = dict(talker_cfg=cfg, cp_cfg=cfg.code_predictor_config,
                  sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True))
    carry = _one_carry(cfg, B, MAX_FRAMES, CACHE, dtype, False, home, 0, mesh)
    trailing_all = torch.zeros(B, T_TRAIL, h, dtype=dtype, device=home)
    pad = torch.zeros(h, dtype=dtype, device=home)
    t0 = time.time()
    for s, plen in ((0, 9), (1, 13)):  # heterogeneous prompt lengths
        pe = torch.randn(1, P_BUCKET, h, generator=torch.Generator().manual_seed(10 + s)) * 0.05
        carry, trailing_all = bg.admit_slot(
            tkp, cpp, carry, trailing_all, **common, slot=s, prefill_embeds=pe.to(home, dtype),
            prefill_len=plen, trailing_row=torch.zeros(T_TRAIL, h, dtype=dtype, device=home),
            trailing_len=4, tts_pad_embed=pad, seed=20 + s,
        )
    print(f"phase B: 2 admits in {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    for until in (2, MAX_FRAMES):
        carry = bg.generate_chunk_batch(
            tkp, cpp, carry, **common, trailing_embeds=trailing_all,
            trailing_lens=torch.full((B,), 4, dtype=torch.int32), tts_pad_embed=pad,
            max_steps=torch.full((B,), MAX_FRAMES, dtype=torch.int32), until_step=until,
        )
    frames = carry.frames.cpu().tolist()
    print(f"phase B: decode chunks in {time.time() - t0:.0f}s", flush=True)
    if min(frames) < 1 or int(carry.codes[:, 0].max()) <= 0:
        raise RuntimeError(f"continuous batch produced no frames: {frames}")
    print(f"dryrun OK (phase B): continuous batching at {h} wide, {cfg.num_hidden_layers} "
          f"layers, {frames} frames/slot on {mesh}", flush=True)
    return frames


def phase_c(devices: list[torch.device], cfg: TalkerConfig) -> list[int]:
    """The dp path: one sequence a device, per-request sampling; returns the
    frames of each sequence."""
    mesh = pm.make_mesh(devices, tp=1)
    home = mesh.home
    on_cards = home.type == "cuda"
    t0 = time.time()
    tkp, cpp = _trees(cfg, torch.bfloat16 if on_cards else torch.float32, home, seed=2)
    if on_cards:  # the layout K1 and K2 take
        from ..ops.quant import quantize_decode_params_int8

        tkp["layers"] = tk.fuse_layer_projections(tkp["layers"])
        cpp["layers"] = tk.fuse_layer_projections(cpp["layers"])
        tkp = quantize_decode_params_int8(tkp, "codec_head")
        cpp = quantize_decode_params_int8(cpp, "lm_head")
    B, h = len(devices), cfg.hidden_size
    dtype = torch.bfloat16 if on_cards else torch.float32
    samp_vec = np.asarray([[0.5 + 0.05 * i, 20.0 + i, 1.0, 1.05] for i in range(B)], np.float32)
    g = torch.Generator().manual_seed(30)
    res = pdp.generate_codes_batch_dp(
        tkp, cpp, mesh=mesh, talker_cfg=cfg, cp_cfg=cfg.code_predictor_config,
        sampling=gen.SamplingConfig(0.9, 50, 1.0, 1.05, forbid_eos=True, per_request=True),
        prefill_embeds=(torch.randn(B, 16, h, generator=g) * 0.05).to(home, dtype),
        prefill_lens=[11] * B, trailing_embeds=torch.zeros(B, 8, h, dtype=dtype, device=home),
        trailing_lens=[4] * B, tts_pad_embed=torch.zeros(h, dtype=dtype, device=home),
        cache=[tk.make_cache(cfg, 1, 128, dtype, d) for d in pdp.shard_devices(mesh)],
        max_steps=[2] * B, max_frames=4, seed=31, samp_vec=samp_vec,
    )
    frames = res.n_frames.cpu().tolist()
    if min(frames) < 1:
        raise RuntimeError(f"dp shard produced no frames: {frames}")
    print(f"dryrun OK (phase C): dp={B} decode with per-request sampling, {frames} frames/seq "
          f"in {time.time() - t0:.0f}s ({h} wide, {cfg.num_hidden_layers} layers, local batch 1)",
          flush=True)
    return frames


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the cards")
    args = ap.parse_args(argv)
    devices = mesh_devices(args.n_devices, args.cpu)
    tp = math.gcd(args.n_devices, 8)
    mesh = pm.make_mesh(devices, tp=tp)
    print(f"dryrun mesh: {mesh.shape}", flush=True)
    phase_a(mesh)
    base = talker_06b()
    phase_b(mesh, base, torch.float32 if args.cpu else torch.bfloat16)
    cut = dataclasses.replace(
        base, num_hidden_layers=2, text_vocab_size=256,
        code_predictor_config=dataclasses.replace(base.code_predictor_config,
                                                  num_hidden_layers=2))
    phase_c(devices, cut)


if __name__ == "__main__":
    main()
