"""T7: the talker's weight stream with (almost) no compute, on the card.

The port of tools/exp_weight_stream.py. ``weight_stream`` replaces its
``run_dma_variant`` (kernel body ``_dma_kernel``, pallas_call at :132): over
L layers of [L, r, c] operands, h starts at x and at each layer becomes
bf16(f32(h) + the sum over operands, in order, of sum(w[l, 0, :128])). On a
CUDA tensor it launches the hand-written kernel in csrc/weight_stream.cu,
which also reads every byte of every operand and returns one checksum per
(operand, layer), what forces the read on a GPU; on a CPU tensor it runs
``weight_stream_ref``, the plain PyTorch version. ``form=1`` is T6's ``dma``
variant (tools/exp_tk_b1_ablate.py:100-114): the whole first row of each
matrix, summed into one f32 total, added to h as bf16.

The script times, at the 0.6B int8 talker's shapes:

  full    K1 (the production step, non-sample, wo_bf16) on a 256-row cache
          at offset 128;
  dma4    the four fused int8 weight matrices;
  dma12   those plus the four f32 scale rows and the four f32 norm rows;
  dma1    the four matrices merged into one [L, rows, 1024] int8 operand,

as ms per step over N steps back to back (CUDA events), the bytes a step
reads, the rate (decimal GB/s) and the share of the 3.35 TB/s bound, with
the card's name and power limit beside each line.

Usage: python -m qwen3tts_tpu_torch.tools.exp_weight_stream [N_STEPS]   (100)
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import _cuda

TILE = 128  # the JAX kernel's corner tile: w[l, 0, :128]
CACHE_LEN = 256
OFFSET = 128


def _tile(op: torch.Tensor, form: int) -> int:
    """Elements of each layer's row 0 that enter h."""
    c = op.shape[-1]
    return c if form == 1 else min(TILE, c)


def _check(ops, x, form):
    if form not in (0, 1):
        raise ValueError(f"weight_stream: form {form} (expected 0 or 1)")
    if not ops or any(o.dim() != 3 or o.shape[0] != ops[0].shape[0]
                      or o.dtype not in (torch.int8, torch.float32) for o in ops):
        raise ValueError("weight_stream: operands must be int8 or f32 [L, r, c] stacks of one L")
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError("weight_stream: x must be bf16 [B, H]")


def weight_stream_ref(ops: list[torch.Tensor], x: torch.Tensor, form: int = 0):
    """Plain PyTorch version of ``weight_stream``: (h [B, H] bf16, checksums,
    one [L] tensor per operand: int64 byte sums of an int8 operand, the f32
    rounding of the float64 sum of an f32 operand)."""
    _check(ops, x, form)
    L = ops[0].shape[0]
    h = x.to(torch.bfloat16)
    for l in range(L):
        tiles = [op[l, 0, : _tile(op, form)].float().sum() for op in ops]
        if form == 0:
            acc = h.float()
            for t in tiles:
                acc = acc + t
            h = acc.to(torch.bfloat16)
        else:
            tot = tiles[0]
            for t in tiles[1:]:
                tot = tot + t
            h = (h.float() + tot.to(torch.bfloat16).float()).to(torch.bfloat16)
    sums = [op.reshape(L, -1).sum(1, dtype=torch.int64) if op.dtype == torch.int8
            else op.reshape(L, -1).double().sum(1).float() for op in ops]
    return h, sums


def weight_stream(ops: list[torch.Tensor], x: torch.Tensor, form: int = 0):
    """The stream of ``ops`` for one step from x [B, H] bf16; returns what
    ``weight_stream_ref`` returns. CUDA tensors launch the kernel (counted
    in ``weight_stream.launches``), CPU tensors run the plain version; any
    other device raises."""
    if x.device.type == "cpu":
        return weight_stream_ref(ops, x, form)
    if x.device.type != "cuda":
        raise ValueError(f"weight_stream: unsupported device {x.device}")
    _check(ops, x, form)
    out = launch(ops, x, form)
    weight_stream.launches += 1
    return out


def launch(ops, x, form):
    """One call of csrc/weight_stream.cu on CUDA tensors."""
    n, L = len(ops), ops[0].shape[0]
    B, H = x.shape
    ops = [o.contiguous() for o in ops]
    x = x.contiguous()
    h = torch.empty_like(x)
    sums = torch.empty(n * L + 1, dtype=torch.int64, device=x.device)
    tiles = torch.empty(n * L, dtype=torch.float32, device=x.device)
    w = (ctypes.c_void_p * n)(*(_cuda.ptr(o) for o in ops))
    nbytes = (ctypes.c_longlong * n)(*(o.numel() // L * o.element_size() for o in ops))
    esz = (ctypes.c_int * n)(*(o.element_size() for o in ops))
    tile = (ctypes.c_int * n)(*(_tile(o, form) for o in ops))
    lib = _cuda.library()
    with _cuda.on_device(x.device) as stream:
        rc = lib.qt_weight_stream(
            n, ctypes.addressof(w), ctypes.addressof(nbytes), ctypes.addressof(esz),
            ctypes.addressof(tile), L, form, B, H, _cuda.ptr(x), _cuda.ptr(h), _cuda.ptr(sums),
            _cuda.ptr(tiles), stream,
        )
    _cuda.check(rc, "weight_stream")
    # views of the slots: int64 rows as they are, the f32 operands' float64
    # rows rounded to f32 in one conversion for all of them (no launch per row)
    per_op = sums[: n * L].view(n, L)
    f32 = per_op.view(torch.float64).float() if any(o.dtype != torch.int8 for o in ops) else None
    return h, [per_op[i] if o.dtype == torch.int8 else f32[i] for i, o in enumerate(ops)]


weight_stream.launches = 0  # kernel launches (CUDA calls), not plain runs


def talker_operands(params) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The script's operands of an int8 fused talker: the four weight
    matrices [L, in, out] and the eight f32 rows [L, 1, c] (four scales, the
    input, post-attention, q and k norms), as tools/exp_weight_stream.py
    builds them."""
    layers = params["layers"]
    keys = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
    big = [layers[k].q for k in keys]
    small = [layers[k].scale.float().contiguous() for k in keys] + [
        layers[k].float()[:, None, :].contiguous()
        for k in ("input_layernorm", "post_attention_layernorm", "q_norm", "k_norm")
    ]
    return big, small


def merged(big: list[torch.Tensor]) -> torch.Tensor:
    """The four matrices as one [L, rows, 1024] int8 operand (bytes equal,
    each layer's matrices one after another)."""
    L = big[0].shape[0]
    return torch.cat([a.reshape(L, -1, 1024) for a in big], dim=1).contiguous()


def nbytes(ops) -> int:
    return sum(o.numel() * o.element_size() for o in ops)


def main(argv: list[str]) -> None:
    from ..models import talker as tk
    from ..ops import talker_kernel as tkk
    from ._card import bound_ms, card, event_ms, int8_talker, require_cuda, talker_06b

    n_steps = int(argv[0]) if argv else 100
    dev = require_cuda("exp_weight_stream")
    smi = card()
    cfg = talker_06b()
    params = int8_talker(cfg, dev)
    big, small = talker_operands(params)
    H, D = cfg.hidden_size, cfg.head_dim
    print(f"card: {smi}; N={n_steps} steps per timing", flush=True)

    cache = tk.make_cache(cfg, 1, CACHE_LEN, torch.bfloat16, dev)
    cos = torch.ones(D, dtype=torch.bfloat16, device=dev)
    sin = torch.zeros(D, dtype=torch.bfloat16, device=dev)
    x = [torch.zeros(1, 1, H, dtype=torch.bfloat16, device=dev)]

    def full():
        x[0] = tkk.talker_decode_step(params, cfg, x[0], cache, OFFSET, cos, sin,
                                      sample=False).reshape(1, 1, H)

    rows = {}
    full_ms = event_ms(full, n_steps)
    w_bytes = nbytes(big + small)
    rows["full"] = full_ms
    print(f"full    : {full_ms:.3f} ms/step  ({w_bytes / 1e6:.1f} MB weights -> "
          f"{w_bytes / 1e6 / full_ms:.0f} GB/s effective incl. compute; bound "
          f"{bound_ms(w_bytes):.3f} ms)  [{smi}]", flush=True)
    for name, ops in (("dma4", big), ("dma12", big + small), ("dma1", [merged(big)])):
        h = [torch.zeros(1, H, dtype=torch.bfloat16, device=dev)]

        def step():
            h[0] = weight_stream(ops, h[0])[0]

        ms = event_ms(step, n_steps)
        rows[name] = ms
        b = nbytes(ops)
        print(f"{name:8s}: {ms:.3f} ms/step  ({b / 1e6:.1f} MB/step -> {b / 1e6 / ms:.0f} GB/s "
              f"effective; bound {bound_ms(b):.3f} ms, {bound_ms(b) / ms:.2f} of it)  [{smi}]",
              flush=True)
    print(f"\nsummary: full {rows['full']:.3f} | dma12 {rows['dma12']:.3f} | dma4 "
          f"{rows['dma4']:.3f} | dma1 {rows['dma1']:.3f} ms/step  [{smi}]")
    print("interpretation: (full - dma12) = compute and launches not hidden behind the stream; "
          "(dma12 - dma4) = the small operands' cost; (dma4 - dma1) = the cost of four operands "
          f"against one; dma1 vs {nbytes(big) / 1e9:.3f} GB / 3.35 TB/s = "
          f"{bound_ms(nbytes(big)):.3f} ms speed-of-light.", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
