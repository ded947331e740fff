"""T6: K1's B=1 talker step split by part, on the card.

The port of tools/exp_tk_b1_ablate.py. ``variant_step`` replaces its
``variant_step`` (kernel body ``_variant_kernel``, pallas_call at :242): one
decode step of the int8 fused talker (wo_bf16, non-sample, bf16 cache) in one
of four parts:

  full    the whole step;
  noattn  the attention block writes the new k/v rows and returns q (after
          QK-norm and rope) in place of attention (the script's code, :138);
  nomlp   each layer ends after o_proj + residual (no gate_up, no down);
  dma     each layer's four weight matrices read in full, h += bf16(sum of
          their first rows), zero k/v rows.

It returns the script's value: h before the final norm [B, H] and the new
k/v rows [L, B, NKV, D], which it writes into the cache at ``pos`` in place
(K1's contract; the script writes them there after the call), returned as
views of the cache. On a CUDA tensor ``full``, ``noattn`` and ``nomlp``
(B = 1) launch K1's persistent step itself (csrc/talker_frame.cu) with that
part of each layer taken away (``talker_kernel.launch(..., part=)``), so
each part subtracts from the step that serves; ``dma`` launches
csrc/talker_ablate.cu (T7's kernel, csrc/weight_stream.cu, and the zero
rows). On a CPU tensor it runs ``variant_step_ref``, the plain version
(ops/decode_blocks.py's layer with its ``part``, T7's plain stream).

The script times each part over a 66-step loop at the 0.6B shapes (a
256-row bf16 cache, prefill offset 24), with ``full`` being K1 itself in
non-sample mode, as the JAX script times the production kernel; ms per
step and us per layer, beside the bytes and the bound, with the card's name
and power limit.

Usage: python -m qwen3tts_tpu_torch.tools.exp_tk_b1_ablate [full noattn nomlp dma]
"""

from __future__ import annotations

import sys
import time

import torch

from ..ops import _cuda
from ..ops import talker_kernel as tkk
from ..ops.decode_blocks import layer_step
from ..ops.talker_kernel import MAX_BATCH, _layout
from .exp_weight_stream import nbytes, weight_stream_ref

PARTS = ("full", "noattn", "nomlp", "dma")
FRAMES = 66
PREFILL_LEN = 24
CACHE_LEN = 256
_MATS = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")


def _new_rows(cache, pos: int):
    return cache.k[:, :, :, pos], cache.v[:, :, :, pos]


def _check(params, cfg, x, cache, pos, part):
    if part not in PARTS:
        raise ValueError(f"variant_step: unknown part {part!r} (expected one of {PARTS})")
    if _layout(params["layers"]) != "int8":
        raise ValueError("variant_step: takes the int8 fused layout (wo_bf16)")
    if len(cache) != 2 or cache.k.dtype != torch.bfloat16:
        raise ValueError("variant_step: takes a bf16 cache")
    B, T = x.shape[0], cache.k.shape[3]
    if x.dtype != torch.bfloat16 or x.shape != (B, 1, cfg.hidden_size) or not 1 <= B <= MAX_BATCH:
        raise ValueError(f"variant_step: x must be bf16 [B, 1, H] with 1 <= B <= {MAX_BATCH}")
    if cache.k.shape != (cfg.num_hidden_layers, B, cfg.num_key_value_heads, T, cfg.head_dim):
        raise ValueError("variant_step: cache must be [L, B, NKV, T, D]")
    if not 0 <= pos < T:
        raise ValueError(f"variant_step: position {pos} outside the cache of {T}")


def variant_step_ref(params, cfg, x, cache, pos: int, cos, sin, part: str):
    """Plain PyTorch version of ``variant_step`` (same rounding points as the
    kernel): (h [B, H] bf16 before the final norm, k_new, v_new)."""
    _check(params, cfg, x, cache, pos, part)
    B, H, D = x.shape[0], cfg.hidden_size, cfg.head_dim
    layers = params["layers"]
    if part == "dma":
        h = weight_stream_ref([layers[k].q for k in _MATS], x.reshape(B, H), form=1)[0]
        cache.k[:, :, :, pos] = 0
        cache.v[:, :, :, pos] = 0
        return (h, *_new_rows(cache, pos))
    posv = torch.full((B,), pos, dtype=torch.int64, device=x.device)
    cos, sin = (t.to(torch.bfloat16).reshape(1, D).expand(B, D) for t in (cos, sin))
    h = x.reshape(B, H).to(torch.bfloat16)
    for l in range(cfg.num_hidden_layers):
        h = layer_step(layers, l, cfg, h, cos, sin, (cache.k[l], cache.v[l]), posv,
                       cp_form=False, part=part)
    return (h, *_new_rows(cache, pos))


def variant_step(params, cfg, x, cache, pos: int, cos, sin, part: str):
    """One ablated step of B rows at cache position ``pos``: x [B, 1, H] bf16,
    cache a bf16 talker ``KVCache`` [L, B, NKV, T, D] (written in place),
    cos/sin one [D] rope row. Returns (h [B, H], k_new, v_new [L, B, NKV,
    D]). CUDA tensors launch the kernel (``variant_step.launches``), CPU
    tensors run the plain version; any other device raises."""
    if x.device.type == "cpu":
        return variant_step_ref(params, cfg, x, cache, pos, cos, sin, part)
    if x.device.type != "cuda":
        raise ValueError(f"variant_step: unsupported device {x.device}")
    _check(params, cfg, x, cache, pos, part)
    out = _launch(params, cfg, x, cache, pos, cos, sin, part)
    variant_step.launches += 1
    return out


def _launch(params, cfg, x, cache, pos, cos, sin, part):
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    NQ, NKV, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    B, T = x.shape[0], cache.k.shape[3]
    dev = x.device
    h = torch.empty(B, H, dtype=torch.bfloat16, device=dev)  # h before the final norm
    if part != "dma":  # K1's persistent step with the part taken away
        if B != 1:
            raise ValueError(f"variant_step: the {part} part runs K1's B = 1 step, not B = {B}")
        tkk.launch(params, cfg, x, cache, pos, cos, sin, sample=False, temperature=0.0,
                   top_k=0, top_p=1.0, ref_exact_top_p=False, rep_penalty=1.0, eos_id=-1,
                   seed=(0, 0), suppress_add=None, seen=None, return_logits=False, dyn=False,
                   part=part, h_out=h)
        return (h, *_new_rows(cache, pos))
    layers = params["layers"]
    I = layers["gate_up_proj"].q.shape[-1] // 2
    sums = torch.empty(4 * L + 1, dtype=torch.int64, device=dev)  # T7's checksums
    tiles = torch.empty(4 * L, dtype=torch.float32, device=dev)  # T7's tile sums
    x = x.contiguous()  # operands stay referenced until the launches are enqueued
    lib = _cuda.library()
    with _cuda.on_device(x.device) as stream:
        rc = lib.qt_talker_ablate_dma(
            L, H, NQ, NKV, D, I, T, B, pos, _cuda.ptr(x),
            *(_cuda.ptr(layers[k].q) for k in _MATS), _cuda.ptr(cache.k), _cuda.ptr(cache.v),
            _cuda.ptr(h), _cuda.ptr(sums), _cuda.ptr(tiles), stream,
        )
    _cuda.check(rc, "variant_step")
    return (h, *_new_rows(cache, pos))


variant_step.launches = 0  # kernel launches (CUDA calls), not plain runs


def part_bytes(params, part: str, prefix_rows: int, cfg) -> int:
    """Bytes one step of ``part`` must read at B=1: the int8 matrices it
    streams (all four; qkv and o for nomlp), full also its KV prefix."""
    layers = params["layers"]
    mats = _MATS[:2] if part == "nomlp" else _MATS
    n = nbytes([layers[k].q for k in mats])
    if part == "full":
        n += (prefix_rows + 1) * cfg.num_hidden_layers * cfg.num_key_value_heads * cfg.head_dim * 4
    return n


def main(argv: list[str]) -> None:
    from ..models import talker as tk
    from ..ops.rope import mrope_cos_sin
    from ._card import bound_ms, card, int8_talker, require_cuda, talker_06b

    which = argv or list(PARTS)
    dev = require_cuda("exp_tk_b1_ablate")
    smi = card()
    cfg = talker_06b()
    params = int8_talker(cfg, dev)
    H, L = cfg.hidden_size, cfg.num_hidden_layers
    cache = tk.make_cache(cfg, 1, CACHE_LEN, torch.bfloat16, dev)
    cos, sin = mrope_cos_sin(torch.arange(CACHE_LEN, device=dev)[None], cfg.head_dim,
                             cfg.rope_theta, cfg.mrope_section, torch.bfloat16)
    cos, sin = cos[0], sin[0]
    print(f"card: {smi}; {FRAMES}-step loop from offset {PREFILL_LEN}, cache {CACHE_LEN}",
          flush=True)

    def loop(part):
        x = torch.zeros(1, 1, H, dtype=torch.bfloat16, device=dev)
        for i in range(FRAMES):
            off = PREFILL_LEN + i
            if part == "full":  # K1 itself, the step that serves
                h = tkk.talker_decode_step(params, cfg, x, cache, off, cos[off], sin[off],
                                           sample=False)
            else:
                h = variant_step(params, cfg, x, cache, off, cos[off], sin[off], part)[0]
            x = h.reshape(1, 1, H)
        return x

    for part in which:
        t0 = time.time()
        loop(part)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        n = 3
        a.record()
        for _ in range(n):
            loop(part)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / n / FRAMES
        mean_prefix = PREFILL_LEN + (FRAMES - 1) / 2
        bnd = bound_ms(part_bytes(params, part, int(mean_prefix), cfg))
        print(f"{part:8s} x{FRAMES}: {ms * FRAMES:7.1f} ms total, {ms:6.3f} ms/frame, "
              f"{ms / L * 1e3:5.1f} us/layer; bound {bnd:.3f} ms/frame ({bnd / ms:.3f} of it) "
              f"(first run {first_s:.1f} s)  [{smi}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
