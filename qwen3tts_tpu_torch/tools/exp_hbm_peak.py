"""T3: the card's sustained device-memory read rate.

The port of tools/exp_hbm_peak.py. ``colsum`` replaces the Pallas probe of
its ``main`` (kernel ``kern`` :78-90, pallas_call at :95): the int32 column
sums [1024] of a window of ``rows`` rows of an int8 [*, 1024] array read in
blocks of ``blk_rows`` rows. On a CUDA tensor it launches the hand-written
kernel in csrc/hbm_read.cu (a block is the unit of work of a group of CTAs);
on a CPU tensor it runs ``colsum_ref``, the plain version, which sums block by
block as the kernel does. Any other device raises.

The script reads a 512 MiB window (ROWS = 524,288 rows of 1024 int8) N times
per block size, 4, 8, 16 and 32 MiB, the window moving by one block every
other iteration, and prints ms per iteration and the rate (decimal GB/s)
against the published 3.35 TB/s, beside one PyTorch reduction of the same
window (``x[a:a + ROWS].sum(0, dtype=torch.int32)``, the counterpart of the
script's ``xla_red``), with the card's name and power limit.

The array has one largest block of padding rows past the window. The JAX
script's 8,192 padding rows are fewer than a 16 or 32 MiB block, so its
moved window reaches past the array's end there (ROADMAP.md, queue 3).

Usage: python -m qwen3tts_tpu_torch.tools.exp_hbm_peak [N_ITERS]   (50)
"""

from __future__ import annotations

import sys

import torch

from ..ops import _cuda

COLS = 1024
ROWS = 512 * 1024  # x 1024 int8 = 512 MiB read per iteration
BLOCK_MIB = (4, 8, 16, 32)
PAD = max(BLOCK_MIB) * (1 << 20) // COLS  # the window moves by up to one largest block


def _check(x, row0, rows, blk_rows):
    if x.dtype != torch.int8 or x.dim() != 2 or x.shape[1] != COLS:
        raise ValueError(f"colsum: x must be int8 [*, {COLS}]")
    if blk_rows <= 0 or blk_rows % 4 or rows <= 0 or rows % blk_rows:
        raise ValueError("colsum: rows must be whole blocks of a multiple of 4 rows")
    if row0 < 0 or row0 % 4 or row0 + rows > x.shape[0]:
        raise ValueError(f"colsum: window [{row0}, {row0 + rows}) outside the {x.shape[0]} rows")


def colsum_ref(x: torch.Tensor, row0: int, rows: int, blk_rows: int) -> torch.Tensor:
    """Plain version: int32 [COLS], the blocks' int32 column sums added in
    turn (the TPU kernel's accumulation over its grid)."""
    _check(x, row0, rows, blk_rows)
    blocks = x[row0 : row0 + rows].view(rows // blk_rows, blk_rows, COLS)
    out = torch.zeros(COLS, dtype=torch.int32, device=x.device)
    for blk in blocks:
        out += blk.sum(0, dtype=torch.int32)
    return out


def group_for(n_blocks: int, blk_rows: int, sms: int) -> int:
    """CTAs per block: about two CTAs on each SM at any block size."""
    return max(1, min(-(-2 * sms // n_blocks), blk_rows // 4))


def colsum(x: torch.Tensor, row0: int, rows: int, blk_rows: int) -> torch.Tensor:
    """The column sums of rows [row0, row0 + rows) of x, int32 [COLS]. CUDA
    tensors launch the kernel (``colsum.launches``), CPU tensors run the
    plain version; any other device raises."""
    if x.device.type == "cpu":
        return colsum_ref(x, row0, rows, blk_rows)
    if x.device.type != "cuda":
        raise ValueError(f"colsum: unsupported device {x.device}")
    _check(x, row0, rows, blk_rows)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    out = torch.empty(COLS, dtype=torch.int32, device=x.device)
    lib = _cuda.library()
    with _cuda.on_device(x.device) as stream:
        rc = lib.qt_hbm_colsum(
            _cuda.ptr(x), x.shape[0], row0, rows, blk_rows,
            group_for(rows // blk_rows, blk_rows, sms), _cuda.ptr(out), stream,
        )
    _cuda.check(rc, "colsum")
    colsum.launches += 1
    return out


colsum.launches = 0  # kernel launches (CUDA calls), not plain runs


def main(argv: list[str]) -> None:
    from ._card import HBM_BYTES_S, card, require_cuda

    n_iters = int(argv[0]) if argv else 50
    dev = require_cuda("exp_hbm_peak")
    smi = card()
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(-128, 127, (ROWS + PAD, COLS), generator=g, device=dev,
                      dtype=torch.int8)
    n = ROWS * COLS
    bound = n / HBM_BYTES_S * 1e3
    print(f"read/iter: {n / 2**30:.2f} GiB int8 ({n / 1e9:.3f} GB; bound {bound:.4f} ms at "
          f"3.35 TB/s), N={n_iters} iters per timing  [{smi}]", flush=True)

    def timed(fn):
        fn(0)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(n_iters):
            fn(i)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n_iters

    ms = timed(lambda i: x[i * 8 % PAD : i * 8 % PAD + ROWS].sum(0, dtype=torch.int32))
    print(f"torch_red      : {ms:7.3f} ms/iter -> {n / 1e6 / ms:7.1f} GB/s "
          f"({bound / ms:.3f} of the bound)  [{smi}]", flush=True)
    for blk_mb in BLOCK_MIB:
        blk_rows = blk_mb * (1 << 20) // COLS
        ms = timed(lambda i: colsum(x, (i % 2) * blk_rows, ROWS, blk_rows))
        print(f"cuda blk={blk_mb:3d}MB: {ms:7.3f} ms/iter -> {n / 1e6 / ms:7.1f} GB/s "
              f"({bound / ms:.3f} of the bound; {ROWS // blk_rows} blocks)  [{smi}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
