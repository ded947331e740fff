"""T2: unit probes of the code predictor kernel's building blocks, on the card.

The port of tools/exp_cpk.py, whose twelve tiny pallas_calls each asked
whether Mosaic lowers one construct of the CP megakernel. Here each probe is
a small hand-written kernel in csrc/cpk_probes.cu running the block that K2
(csrc/cp_loop.cu) builds from that construct, with a plain PyTorch version:

  p1   (1, 2048) -> (16, 128), times 2                     (script :39)
  p2   s8 x s8 -> s32 dot, (1, 1024) x (1024, 2048): __dp4a, as K2's
       dyn_int8 mode                                       (:51)
  p3   dynamic-row store into a (16, 1024) bf16 scratch, row read back (:66)
  p3a  the same in f32, the whole scratch read back        (:170)
  p3b  bf16, the whole scratch read back                   (:189)
  p3c  a where-select of row p over the whole scratch      (:208)
  p4   argmax (first max) -> codes[0] and the embedding row at it (:86)
  p4a  argmax -> codes[0] only                             (:229)
  p4b  argmax -> embedding row only                        (:245)
  p4c  argmax through a shared-memory scalar -> row        (:286)
  p5   random bits: the TPU core PRNG cannot be reproduced, so the port's
       counter-based generator (csrc/common.cuh::mix32, the plain
       ops/decode_blocks.py::counter_bits), u = (bits >> 8) * 2^-24 (:124)
  p6   int8 -> bf16 convert, then the dot, (1, 1024) x (1024, 3072) (:139)

``probe(name, *inputs)`` launches the probe's kernel on CUDA tensors and
counts it (``probe.launches[name]``), runs ``probe_ref`` on CPU tensors and
raises on any other device. ``probe_inputs(name, device)`` gives the JAX
script's inputs, ``probe_random_inputs`` random ones of the same shapes. The scratch of p3-p3c starts at zero, so its rows other
than p read 0 (the TPU's were never written); p4's and p4a's codes [16]
hold c at 0 and zeros after it (the TPU wrote element 0 only).

The script runs the probes named on the command line, or all of them, and
prints PASS (the kernel equals its plain version: exactly, p6 within 1e-5
scaled) or FAIL with the first values and the time per launch over 200
launches, queued on the card (the launches wait behind a spin kernel, then
run back to back: no host in the way) and back to back (CUDA events, which
the host's launch path bounds), as the JAX
script's ``probe`` (:28-36) prints PASS/FAIL, with the card's name and power
limit. Beside them, in the same run: an empty kernel queued (``empty``,
csrc/cpk_probes.cu's ``qt_cpk_empty``), the floor of any launch, and each
probe's time over it; for p2 ``torch._int_mm`` on x padded with zero rows
to the fewest it takes (``int_mm_operands``), for p6 ``x @ w.to(bf16)``
(two calls: the convert, then the product), queued.

Usage: python -m qwen3tts_tpu_torch.tools.exp_cpk [p1 p2 ...]
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import _cuda
from ..ops.decode_blocks import counter_bits

PROBES = ("p1", "p2", "p3", "p4", "p5", "p6", "p3a", "p3b", "p3c", "p4a", "p4b", "p4c")
ROWS = 16  # p1's output rows; p3's scratch rows; p4's codes
P_ROW, ARGMAX_AT, SEED = 5, 77, 123  # the script's row, argmax position and PRNG seed
FLOAT_PROBES = ("p6",)  # f32 sums in another order; the rest are exact
GV_COLS = _cuda.header_ints(_cuda.CSRC / "cpk_probes.cu")["GV_COLS"]  # columns of a p2 / p6 block


def probe_inputs(name: str, device) -> tuple:
    """The JAX script's inputs of probe ``name``."""
    ones = lambda shape, dtype: torch.ones(shape, dtype=dtype, device=device)
    if name == "p1":
        return (torch.arange(2048, dtype=torch.float32, device=device).reshape(1, 2048),)
    if name == "p2":
        return ones((1, 1024), torch.int8), ones((1024, 2048), torch.int8)
    if name in ("p3", "p3a", "p3b", "p3c"):
        return P_ROW, ones((1, 1024), torch.float32 if name == "p3a" else torch.bfloat16)
    if name.startswith("p4"):
        z = torch.zeros(1, 2048, dtype=torch.float32, device=device)
        z[0, ARGMAX_AT] = 5.0
        emb = torch.arange(2048, dtype=torch.float32, device=device)[:, None].expand(2048, 256)
        return (z,) if name == "p4a" else (z, emb.contiguous())
    if name == "p5":
        return (SEED, 2048, device)
    if name == "p6":
        return ones((1, 1024), torch.bfloat16), ones((1024, 3072), torch.int8)
    raise KeyError(name)


def probe_random_inputs(name: str, device, seed: int = 0) -> tuple:
    """Random inputs of probe ``name``, on which a wrong mapping of rows,
    columns or bytes changes the result (the script's all-ones and
    constant-row inputs hide it): random int8 x and w (p2, p6; p6's x
    bf16), a random row stored at p = 15 (p3*), a random embedding table and
    z in 0..49, so the max ties many times (p4*), another seed and length (p5)."""
    g = torch.Generator(device=device).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=g, device=device)
    int8 = lambda *s: torch.randint(-128, 128, s, generator=g, device=device, dtype=torch.int8)
    if name == "p1":
        return (randn(1, 2048),)
    if name == "p2":
        return int8(1, 1024), int8(1024, 2048)
    if name in ("p3", "p3a", "p3b", "p3c"):
        return ROWS - 1, randn(1, 1024).to(torch.float32 if name == "p3a" else torch.bfloat16)
    if name.startswith("p4"):
        z = torch.randint(0, 50, (1, 2048), generator=g, device=device).float()
        return (z,) if name == "p4a" else (z, randn(2048, 256))
    if name == "p5":
        return (SEED + 1000 + seed, 4096, device)
    if name == "p6":
        return randn(1, 1024).to(torch.bfloat16), int8(1024, 3072)
    raise KeyError(name)


# ---- the plain versions ----

def _argmax_first(z):
    """The first index of max(z [1, N]) (the script's min over where(z == m))."""
    n = z.shape[1]
    iota = torch.arange(n, device=z.device)
    return torch.where(z[0] == z[0].max(), iota, n).min()


def _codes(c, device):
    codes = torch.zeros(ROWS, dtype=torch.int32, device=device)
    codes[0] = c
    return codes


def _scratch(name, p, x):
    buf = torch.zeros(ROWS, x.shape[1], dtype=x.dtype, device=x.device)
    upd = (x.float() * 3.0).to(x.dtype)
    if name == "p3c":
        rows = torch.arange(ROWS, device=x.device)[:, None]
        return torch.where(rows == p, upd, buf)
    buf[p] = upd[0]
    return buf[p : p + 1] if name == "p3" else buf


def probe_ref(name: str, *args):
    """Plain version of probe ``name`` on its inputs."""
    _check(name, *args)
    if name == "p1":
        (x,) = args
        return x.reshape(ROWS, -1) * 2.0
    if name == "p2":
        x, w = args
        return (x[0].long()[:, None] * w.long()).sum(0).int()[None]
    if name in ("p3", "p3a", "p3b", "p3c"):
        return _scratch(name, *args)
    if name.startswith("p4"):
        z = args[0]
        c = _argmax_first(z)
        if name == "p4a":
            return _codes(c, z.device)
        row = args[1][c][None]
        return (_codes(c, z.device), row) if name == "p4" else row
    if name == "p5":
        seed, n, device = args
        return ((counter_bits(seed, 0, 0, n, device) >> 8).float() * (1.0 / (1 << 24)))[None]
    if name == "p6":
        x, w = args
        return (x[0].float() @ w.to(torch.bfloat16).float())[None]
    raise KeyError(name)


def p5_stats(u: torch.Tensor) -> torch.Tensor:
    """[mean, min, max] of p5's draws: what the JAX probe returns (:136)."""
    return torch.stack([u.mean(), u.min(), u.max()])


# ---- the kernels ----

def _check(name, *args):
    if name not in PROBES:
        raise KeyError(f"unknown probe {name!r} (one of {PROBES})")
    if name == "p1":
        (x,) = args
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != 1 or x.shape[1] % ROWS:
            raise ValueError(f"p1: x must be f32 [1, {ROWS} * C]")
    elif name in ("p2", "p6"):
        x, w = args
        want = torch.int8 if name == "p2" else torch.bfloat16
        if x.dtype != want or w.dtype != torch.int8 or x.dim() != 2 or x.shape[0] != 1 \
                or w.dim() != 2 or w.shape[0] != x.shape[1]:
            raise ValueError(f"{name}: x must be {want} [1, K] and w int8 [K, N]")
    elif name.startswith("p3"):
        p, x = args
        want = torch.float32 if name == "p3a" else torch.bfloat16
        if not 0 <= p < ROWS or x.dtype != want or x.dim() != 2 or x.shape[0] != 1:
            raise ValueError(f"{name}: needs 0 <= p < {ROWS} and x {want} [1, C]")
    elif name.startswith("p4"):
        z = args[0]
        if z.dtype != torch.float32 or z.dim() != 2 or z.shape[0] != 1:
            raise ValueError(f"{name}: z must be f32 [1, N]")
        if name != "p4a":
            emb = args[1]
            if emb.dtype != torch.float32 or emb.dim() != 2 or emb.shape[0] < z.shape[1]:
                raise ValueError(f"{name}: emb must be f32 [V, E] with V >= N")


def _launch_cuda(name, *args):
    lib = _cuda.library()
    with _cuda.on_device(_device(name, args)) as st:
        return _launch_on(lib, st, name, *args)


def _launch_on(lib, st, name, *args):
    ptr = _cuda.ptr
    if name == "p1":
        (x,) = args
        out = torch.empty(ROWS, x.shape[1] // ROWS, dtype=torch.float32, device=x.device)
        rc = lib.qt_cpk_p1_reshape(ROWS, out.shape[1], ptr(x), ptr(out), st)
    elif name == "p2":
        x, w = args
        out = torch.empty(1, w.shape[1], dtype=torch.int32, device=x.device)
        rc = lib.qt_cpk_p2_int8_dot(w.shape[0], w.shape[1], ptr(x), ptr(w), ptr(out), st)
    elif name.startswith("p3"):
        p, x = args
        out = torch.empty(1 if name == "p3" else ROWS, x.shape[1], dtype=x.dtype, device=x.device)
        entry = dict(p3=lib.qt_cpk_p3_dynrow, p3a=lib.qt_cpk_p3a_dynrow_f32,
                     p3b=lib.qt_cpk_p3b_dynrow_bf16, p3c=lib.qt_cpk_p3c_where_row)[name]
        rc = entry(p, x.shape[1], ptr(x), ptr(out), st)
    elif name == "p4a":
        (z,) = args
        out = torch.empty(ROWS, dtype=torch.int32, device=z.device)
        rc = lib.qt_cpk_p4a_argmax(z.shape[1], ptr(z), ptr(out), st)
    elif name.startswith("p4"):
        z, emb = args
        n, (v, e) = z.shape[1], emb.shape
        row = torch.empty(1, e, dtype=torch.float32, device=z.device)
        if name == "p4":
            codes = torch.empty(ROWS, dtype=torch.int32, device=z.device)
            rc = lib.qt_cpk_p4_argmax_row(n, v, e, ptr(z), ptr(emb), ptr(codes), ptr(row), st)
            out = (codes, row)
        else:
            entry = lib.qt_cpk_p4b_argmax_row if name == "p4b" else lib.qt_cpk_p4c_argmax_smem_row
            rc = entry(n, v, e, ptr(z), ptr(emb), ptr(row), st)
            out = row
    elif name == "p5":
        seed, n, device = args
        out = torch.empty(1, n, dtype=torch.float32, device=device)
        rc = lib.qt_cpk_p5_counter_bits(seed, n, ptr(out), st)
    else:  # p6
        x, w = args
        out = torch.empty(1, w.shape[1], dtype=torch.float32, device=x.device)
        rc = lib.qt_cpk_p6_convert_dot(w.shape[0], w.shape[1], ptr(x), ptr(w), ptr(out), st)
    _cuda.check(rc, f"probe {name}")
    return out


def _device(name, args) -> torch.device:
    if name == "p5":
        return torch.device(args[2])
    return next(a for a in args if isinstance(a, torch.Tensor)).device


def probe(name: str, *args):
    """Probe ``name`` on its inputs (``probe_inputs``). CUDA tensors launch
    its kernel (``probe.launches[name]``), CPU tensors run ``probe_ref``;
    any other device raises."""
    dev = _device(name, args)
    if dev.type == "cpu":
        return probe_ref(name, *args)
    if dev.type != "cuda":
        raise ValueError(f"probe {name}: unsupported device {dev}")
    _check(name, *args)
    if name in ("p2", "p6"):  # the kernels' 16-column blocks and p2's 4-row dp4a groups
        k, n = args[1].shape
        if n % GV_COLS or (name == "p2" and k % 4):
            raise ValueError(f"probe {name}: the kernel takes N % {GV_COLS} == 0"
                             + (" and K % 4 == 0" if name == "p2" else "") + f", got [{k}, {n}]")
    if name.startswith("p3") and args[1].shape[1] % 8:  # the scratch's 16-byte stores
        raise ValueError(f"probe {name}: the kernel takes C % 8 == 0, got {args[1].shape[1]}")
    out = _launch_cuda(name, *args)
    probe.launches[name] += 1
    return out


probe.launches = dict.fromkeys(PROBES, 0)  # kernel launches (CUDA calls), not plain runs


def outputs(out) -> tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


def agree(name: str, got, want) -> float:
    """The largest scaled difference of a probe's outputs (0.0 = equal);
    raises if an exact probe's outputs differ."""
    worst = 0.0
    for a, b in zip(outputs(got), outputs(want)):
        if name not in FLOAT_PROBES:
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"probe {name}: the kernel's output differs from the plain one")
            continue
        worst = max(worst, float((a.float() - b.float()).abs().max()
                                 / max(1.0, float(b.float().abs().max()))))
    return worst


def probe_bytes(name: str, args, out) -> int:
    """Bytes a probe must move: its outputs written once and what it reads
    once: every tensor input, but of p4's embedding table only the row it
    gathers."""
    ts = [a for a in args if isinstance(a, torch.Tensor)] + list(outputs(out))
    if name in ("p4", "p4b", "p4c"):
        ts[1] = ts[1][0]
    return sum(t.numel() * t.element_size() for t in ts)


def empty(device) -> None:
    """One launch of an empty kernel (one warp) on ``device``'s current
    stream: the floor of a probe's launch."""
    fn = _cuda.library().qt_cpk_empty
    fn.argtypes = [ctypes.c_void_p]
    with _cuda.on_device(torch.device(device)) as st:
        _cuda.check(fn(st), "empty kernel")


def int_mm_operands(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """p2's library yardstick ``torch._int_mm(xp, w)``: x [1, K] int8 padded
    with zero rows to the fewest ``_int_mm`` takes (it refuses 16 rows or
    fewer on the card; tried 1, 17, 24, 32); row 0 of its int32 product is
    p2's."""
    err = None
    for rows in (1, 17, 24, 32):
        xp = torch.zeros(rows, x.shape[1], dtype=torch.int8, device=x.device)
        xp[0] = x[0]
        try:
            torch._int_mm(xp, w)
            return xp, w
        except RuntimeError as e:
            err = e
    raise RuntimeError(f"torch._int_mm takes none of 1, 17, 24, 32 rows: {err}")


def library_call(name: str, args):
    """The PyTorch yardstick of p2 or p6 on the probe's inputs: (fn, what)."""
    if name == "p2":
        xp, w = int_mm_operands(*args)
        return (lambda: torch._int_mm(xp, w)), f"torch._int_mm on x padded to {xp.shape[0]} rows"
    x, w = args
    return (lambda: x @ w.to(torch.bfloat16)), "x @ w.to(torch.bfloat16), two calls"


def main(argv: list[str]) -> dict:
    """Run the probes; returns, by probe, its queued and back-to-back us per
    launch, the bytes it moves and its largest scaled error (p2 and p6 also
    their library call's queued us), and under ``empty`` the empty kernel's
    queued and back-to-back us."""
    from ._card import bound_ms, card, event_ms, queued_ms, require_cuda

    names = argv or list(PROBES)
    dev = require_cuda("exp_cpk")
    smi = card()
    floor = queued_ms(lambda: empty(dev), 200) * 1e3
    res = {"empty": dict(queued_us=floor, us=event_ms(lambda: empty(dev), 200) * 1e3)}
    print(f"empty kernel: queued {floor:.3f} us/launch, back to back {res['empty']['us']:.2f}  "
          f"[{smi}]", flush=True)
    failed = 0
    for name in names:
        args = probe_inputs(name, dev)
        got = probe(name, *args)
        try:
            err = agree(name, got, probe_ref(name, *args))
            if err > 1e-5:
                raise AssertionError(f"probe {name}: scaled error {err:.3g} > 1e-5")
        except AssertionError as e:
            failed += 1
            print(f"FAIL {name}: {e}  [{smi}]", flush=True)
            continue
        dev_us = queued_ms(lambda: probe(name, *args), 200) * 1e3
        us = event_ms(lambda: probe(name, *args), 200) * 1e3
        shown = p5_stats(got) if name == "p5" else torch.cat([o.flatten()[:4].float()
                                                              for o in outputs(got)])
        n_bytes = probe_bytes(name, args, got)
        res[name] = dict(queued_us=dev_us, us=us, bytes=n_bytes, err=err)
        lib = ""
        if name in ("p2", "p6"):
            fn, what = library_call(name, args)
            res[name].update(library_us=queued_ms(fn, 200) * 1e3, library=what)
            lib = f"; {what}: queued {res[name]['library_us']:.3f} us"
        print(f"PASS {name}: {shown.tolist()}; queued {dev_us:.3f} us/launch "
              f"({dev_us / floor:.2f}x the empty kernel), back to back {us:.2f} (bound {bound_ms(n_bytes) * 1e3:.3f} us, "
              f"bytes){lib}  [{smi}]", flush=True)
    if failed:
        raise SystemExit(f"exp_cpk: {failed} probe(s) failed")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
