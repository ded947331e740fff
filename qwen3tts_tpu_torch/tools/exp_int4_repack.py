"""T4: two alternatives to K4's packed-int4 matvec, on the card.

The port of tools/exp_int4_repack.py, which times K4 (the dequant-in-matmul
kernel, here ``ops/quant.py::quant_gemv`` on csrc/quant_matmul.cu) beside
two other forms of the same matvec at the 0.6B talker's shapes, group 64:

* ``mxu_variant`` replaces its ``mxu_variant`` (kernel ``_mxu_kernel``
  :48-69, pallas_call at :78): the nibbles dequantized to bf16, then a
  matmul with bf16(x) on the tensor cores (csrc/int4_repack.cu, x padded to
  the instruction's 16 rows). Its function is the TPU kernel's exactly:
  y = (sum_i bf16(x_i) * q[o, i]) * scales[o, 0] + sum_g biases[o, g], one
  per-row scale and the biases' plain sum, so it is not K4's function (the
  JAX script: "timing-faithful, numerics not", :65-68). The script prints
  that function's distance from K4's result at each shape, as a number.
* ``plane_variant`` replaces its ``plane_variant`` (kernel
  ``_plane_kernel`` :96-110, pallas_call at :116): the row's values split
  into two nibble planes, lo (values 0 .. I/2-1) and hi (I/2 .. I-1), value
  8w + j of a half at nibble j of word w, built on the host by
  ``plane_repack`` (a copy of the script's :181-192 over this package's own
  ``pack_quantized``); y = (sum_i q[o, i] * x_i) * scales[o, 0] in f32 on
  the CUDA cores, no bias.

Each launches its kernel on a CUDA tensor and counts it (``.launches``),
runs its plain version (``*_ref``) on a CPU tensor and raises on any other
device.

The script times K4, plane and mxu at (I, O) in (1024, 3072), (3072, 1024),
(1024, 6144) and (1024, 2048), each call on the next of enough copies of the
weights to fill 256 MB, five times the 50 MB L2, so no call finds its bytes
there (a walk over 64 MB still hit it in part), as K4's row of PERF.md is
timed: us per call queued on the card (the calls wait behind a spin
kernel, then run back to back: the card's time with no host in the way,
CUDA events) and us per call back to back (CUDA events, which the host's
launch path bounds at these sizes). It prints them beside the bytes' bound, then
the per-layer totals and x28 layers per frame of the queued times, as the
JAX script's main does (:159-212), with the card's name and power limit
beside every number.

Usage: python -m qwen3tts_tpu_torch.tools.exp_int4_repack [N_CALLS]   (200)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _cuda
from ..ops.quant import pack_quantized, quant_gemv, unpack_quantized

BITS, GROUP = 4, 64
SHAPES = ((1024, 3072), (3072, 1024), (1024, 6144), (1024, 2048))  # (I, O)
ROTATE_BYTES = 256 << 20  # copies of the weights a timing walks through: 5x the 50 MB L2


def plane_repack(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint32 [O, I/8] MLX words -> (lo, hi) uint32 [O, I/16] nibble planes:
    value k of the row pairs with value k + I/2 (the JAX script's :181-192)."""
    O, W = packed.shape
    I = W * 8
    qv = np.zeros((O, I), np.uint32)
    for j in range(8):
        qv[:, j::8] = (packed >> (4 * j)) & 15
    half = I // 2
    lo = np.zeros((O, half // 8), np.uint32)
    hi = np.zeros((O, half // 8), np.uint32)
    for j in range(8):
        lo |= qv[:, :half][:, j::8] << (4 * j)
        hi |= qv[:, half:][:, j::8] << (4 * j)
    return lo, hi


def weights(I: int, O: int, seed: int, device) -> dict:
    """The script's weights at (I, O): w = N(0, 1) x 0.02, packed int4 group
    64 (int32 views of the uint32 words), the planes, and x = N(0, 1) f32."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((O, I)).astype(np.float32) * 0.02
    packed, scales, biases = pack_quantized(w, BITS, GROUP)
    lo, hi = plane_repack(packed)
    x = rng.standard_normal((1, I)).astype(np.float32)

    def as_t(a):  # uint32 words as int32, as PackedLinear holds them
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)

    return dict(x=as_t(x), packed=as_t(packed), scales=as_t(scales), biases=as_t(biases),
                lo=as_t(lo), hi=as_t(hi))


def _check_x(x, I, what):
    if x.dtype != torch.float32 or tuple(x.shape) != (1, I):
        raise ValueError(f"{what}: x must be f32 [1, {I}], got {x.dtype} {tuple(x.shape)}")


def _check_mxu(x, packed, scales, biases):
    O, W = packed.shape
    I = W * 8
    _check_x(x, I, "mxu_variant")
    if packed.dtype != torch.int32 or O % 8 or I % 128:
        raise ValueError(f"mxu_variant: packed must be int32 [O, I/8] with O % 8 == 0 and "
                         f"I % 128 == 0, got {packed.dtype} {tuple(packed.shape)}")
    ng = scales.shape[-1]
    if (scales.dtype != torch.float32 or biases.dtype != torch.float32 or scales.shape != (O, ng)
            or biases.shape != (O, ng)):
        raise ValueError("mxu_variant: scales and biases must be f32 [O, groups]")
    return O, I, ng


def mxu_variant_ref(x, packed, scales, biases) -> torch.Tensor:
    """Plain version: [1, O] f32."""
    _check_mxu(x, packed, scales, biases)
    q = unpack_quantized(packed, BITS)  # [O, I] f32 levels
    acc = q @ x[0].to(torch.bfloat16).float()
    return (acc * scales[:, 0] + biases.sum(-1))[None]


def mxu_variant(x, packed, scales, biases) -> torch.Tensor:
    """The TPU ``mxu_variant``'s function, [1, O] f32; CUDA tensors launch
    csrc/int4_repack.cu's tensor-core kernel."""
    if x.device.type == "cpu":
        return mxu_variant_ref(x, packed, scales, biases)
    if x.device.type != "cuda":
        raise ValueError(f"mxu_variant: unsupported device {x.device}")
    O, I, ng = _check_mxu(x, packed, scales, biases)
    y = torch.empty(1, O, dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    with _cuda.on_device(x.device) as stream:
        rc = lib.qt_int4_mxu(
            O, I, ng, *(_cuda.ptr(t) for t in (x, packed, scales, biases, y)), stream)
    _cuda.check(rc, "mxu_variant")
    mxu_variant.launches += 1
    return y


mxu_variant.launches = 0  # kernel launches (CUDA calls), not plain runs


def _check_plane(x, lo, hi, scales):
    O, Wp = lo.shape
    I = Wp * 16
    _check_x(x, I, "plane_variant")
    if lo.dtype != torch.int32 or hi.dtype != torch.int32 or hi.shape != lo.shape or I % 64:
        raise ValueError(f"plane_variant: lo and hi must be int32 [O, I/16] with I % 64 == 0, "
                         f"got {tuple(lo.shape)} and {tuple(hi.shape)}")
    if scales.dtype != torch.float32 or scales.dim() != 2 or scales.shape[0] != O:
        raise ValueError("plane_variant: scales must be f32 [O, groups]")
    return O, I, scales.shape[1]


def plane_variant_ref(x, lo, hi, scales) -> torch.Tensor:
    """Plain version: [1, O] f32."""
    _, I, _ = _check_plane(x, lo, hi, scales)
    half = I // 2
    acc = unpack_quantized(lo, BITS) @ x[0, :half] + unpack_quantized(hi, BITS) @ x[0, half:]
    return (acc * scales[:, 0])[None]


def plane_variant(x, lo, hi, scales) -> torch.Tensor:
    """The TPU ``plane_variant``'s function, [1, O] f32; CUDA tensors launch
    csrc/int4_repack.cu's CUDA-core kernel."""
    if x.device.type == "cpu":
        return plane_variant_ref(x, lo, hi, scales)
    if x.device.type != "cuda":
        raise ValueError(f"plane_variant: unsupported device {x.device}")
    O, I, ng = _check_plane(x, lo, hi, scales)
    y = torch.empty(1, O, dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    with _cuda.on_device(x.device) as stream:
        rc = lib.qt_int4_plane(
            O, I, ng, *(_cuda.ptr(t) for t in (x, lo, hi, scales, y)), stream)
    _cuda.check(rc, "plane_variant")
    plane_variant.launches += 1
    return y


plane_variant.launches = 0  # kernel launches (CUDA calls), not plain runs


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def variant_bytes(w: dict) -> dict[str, int]:
    """Bytes each form must move, every input it reads once and its [1, O]
    f32 output: K4 the words, scales and biases; mxu the words, the scale
    column and the biases; plane the two planes and the scale column."""
    O = w["packed"].shape[0]
    col = O * 4
    return dict(packed=nbytes(w["x"], w["packed"], w["scales"], w["biases"]) + col,
                mxu=nbytes(w["x"], w["packed"], w["biases"]) + 2 * col,
                plane=nbytes(w["x"], w["lo"], w["hi"]) + 2 * col)


def rotating_calls(w: dict) -> dict:
    """For each form, a call on the next of enough weight copies to fill
    ROTATE_BYTES (every call misses the L2)."""
    n = max(1, -(-ROTATE_BYTES // nbytes(w["packed"], w["scales"], w["biases"])))
    cp = [{k: w[k].clone() for k in ("packed", "scales", "biases", "lo", "hi")} for _ in range(n)]
    it = iter(range(1 << 62))
    x = w["x"]

    def k4():
        c = cp[next(it) % n]
        return quant_gemv(x, c["packed"], c["scales"], c["biases"], BITS, GROUP)

    def plane():
        c = cp[next(it) % n]
        return plane_variant(x, c["lo"], c["hi"], c["scales"])

    def mxu():
        c = cp[next(it) % n]
        return mxu_variant(x, c["packed"], c["scales"], c["biases"])

    return dict(packed=k4, plane=plane, mxu=mxu)


def scaled(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def main(argv: list[str]) -> dict:
    """Time the three forms at every shape; returns, by (I, O), their queued
    and back-to-back us per call, the bytes each moves and mxu's distance
    from K4."""
    from ._card import bound_ms, card, event_ms, queued_ms, require_cuda

    n_calls = int(argv[0]) if argv else 200
    dev = require_cuda("exp_int4_repack")
    smi = card()
    total, res = dict(packed=0.0, plane=0.0, mxu=0.0), {}
    for I, O in SHAPES:
        w = weights(I, O, 0, dev)
        k4 = quant_gemv(w["x"], w["packed"], w["scales"], w["biases"], BITS, GROUP)
        dist = scaled(mxu_variant(w["x"], w["packed"], w["scales"], w["biases"]), k4)
        calls, nb = rotating_calls(w), variant_bytes(w)
        us = {name: queued_ms(fn, n_calls) * 1e3 for name, fn in calls.items()}
        b2b = {name: event_ms(fn, n_calls) * 1e3 for name, fn in calls.items()}
        res[(I, O)] = dict(queued_us=us, us=b2b, bytes=nb, dist=dist)
        for name in total:
            total[name] += us[name]
        print(f"I={I:5d} O={O:5d}: queued packed (K4) {us['packed']:.3f} us | plane "
              f"{us['plane']:.3f} us | mxu {us['mxu']:.3f} us; bounds {bound_ms(nb['packed']) * 1e3:.3f}"
              f" / {bound_ms(nb['plane']) * 1e3:.3f} / {bound_ms(nb['mxu']) * 1e3:.3f} us (bytes); "
              f"back to back {b2b['packed']:.2f} / {b2b['plane']:.2f} / {b2b['mxu']:.2f} us; "
              f"mxu's function from K4's result: {dist:.4g} (scaled)  [{smi}]", flush=True)
    print(f"per-layer totals (queued): packed {total['packed']:.3f} us, plane {total['plane']:.3f} "
          f"us, mxu {total['mxu']:.3f} us (x28 layers = {total['packed'] * 28e-3:.4f} / "
          f"{total['plane'] * 28e-3:.4f} / {total['mxu'] * 28e-3:.4f} ms/frame)  [{smi}]", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
