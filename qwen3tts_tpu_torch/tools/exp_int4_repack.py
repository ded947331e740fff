"""T4: two alternatives to K4's packed-int4 matvec, on the card.

The port of tools/exp_int4_repack.py, which times K4 (the dequant-in-matmul
kernel, here ``ops/quant.py::quant_gemv`` on csrc/quant_matmul.cu) beside
two other forms of the same matvec at the 0.6B talker's shapes, group 64:

* ``mxu_variant`` replaces its ``mxu_variant`` (kernel ``_mxu_kernel``
  :48-69, pallas_call at :78): the nibbles widened to bf16 in registers, then
  a matvec with bf16(x) on the tensor cores (csrc/int4_repack.cu: the
  weights as mma's A operand, 16 output rows an instruction, x column 0 of
  B). Its function is the TPU kernel's exactly:
  y = (sum_i bf16(x_i) * q[o, i]) * scales[o, 0] + sum_g biases[o, g], one
  per-row scale and the biases' plain sum, so it is not K4's function (the
  JAX script: "timing-faithful, numerics not", :65-68). The script prints
  that function's distance from K4's result at each shape, as a number. On
  the card it reads the words in the kernel's fragment order, built once on
  the host by ``mxu_repack`` when the script builds its weights (as the TPU
  script's plane form times its layout after its repack); on the CPU it
  takes those or the MLX words, and its plain version ``mxu_variant_ref``
  takes the MLX words.
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

The script times K4, plane and mxu, and ``torch._weight_int4pack_mm`` on the
same words (``int4pack_operands``: the operands ``tools/time_k3_k2.py``'s
``int4lib`` builds; K4's grouped function, the yardstick of both forms), at
(I, O) in (1024, 3072), (3072, 1024), (1024, 6144) and (1024, 2048), each
call on the next of enough copies of the weights to fill 256 MB, five times
the 50 MB L2, so no call finds its bytes there (a walk over 64 MB still hit
it in part), as K4's row of PERF.md is timed: us per call queued on the
card (the calls wait behind a spin kernel, then run back to back: the
card's time with no host in the way, CUDA events) and us per call back to
back (CUDA events, which the host's launch path bounds at these sizes). It
prints them beside the bytes' bound, then the per-layer totals and x28
layers per frame of the queued times, as the JAX script's main does
(:159-212), with the card's name and power limit beside every number.

Usage: python -m qwen3tts_tpu_torch.tools.exp_int4_repack [N_CALLS]   (200)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _cuda
from ..ops.quant import pack_quantized, quant_gemv, unpack_quantized

BITS, GROUP = 4, 64
MX_CHUNK = 64  # values of one fragment-order chunk: four k16 steps of mma.m16n8k16
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


# nibble n of a fragment word: row half (rows g or g + 8) and value r of the 4
# a lane takes at each k16 step (csrc/int4_repack.cu's nib_pair<n % 4>)
_NIB_HALF = tuple(n & 1 for n in range(8))
_NIB_VALUE = tuple(((n >> 2) & 1) + 2 * ((n >> 1) & 1) for n in range(8))


def _nibbles(packed: np.ndarray) -> np.ndarray:
    """uint32 [O, I/8] MLX words -> their values uint32 [O, I]."""
    O, W = packed.shape
    q = np.zeros((O, W * 8), np.uint32)
    for j in range(8):
        q[:, j::8] = (packed >> (4 * j)) & 15
    return q


def mxu_repack(packed: np.ndarray) -> np.ndarray:
    """uint32 [O, I/8] MLX words -> uint32 [ceil(O/16), I/64, 32, 4], the mxu
    kernel's fragment order: word [t, ch, lane, p] is lane (g, c) = (lane //
    4, lane % 4)'s mma.m16n8k16 A fragment of k16 step p of chunk ch, its
    nibbles 0, 4, 2, 6 row 16t + g's values 64 ch + 16 c + 4 p + 0, 1, 2, 3
    and nibbles 1, 5, 3, 7 row 16t + g + 8's. Rows past O are 0."""
    O, W = packed.shape
    tiles, I = -(-O // 16), W * 8
    q = np.zeros((16 * tiles, I), np.uint32)
    q[:O] = _nibbles(packed)
    # axes: tile, row half, g, chunk, c, step p, value r
    q = q.reshape(tiles, 2, 8, I // MX_CHUNK, 4, 4, 4)
    frag = np.zeros((tiles, I // MX_CHUNK, 8, 4, 4), np.uint32)
    for n in range(8):
        frag |= q[:, _NIB_HALF[n], :, :, :, :, _NIB_VALUE[n]].transpose(0, 2, 1, 3, 4) << (4 * n)
    return frag.reshape(tiles, I // MX_CHUNK, 32, 4)


def mxu_unrepack(frag: np.ndarray, O: int) -> np.ndarray:
    """The inverse of ``mxu_repack``: the MLX words uint32 [O, I/8]."""
    tiles, nc = frag.shape[:2]
    I = nc * MX_CHUNK
    f = frag.reshape(tiles, nc, 8, 4, 4)
    q = np.zeros((tiles, 2, 8, nc, 4, 4, 4), np.uint32)
    for n in range(8):
        nib = ((f >> (4 * n)) & 15).transpose(0, 2, 1, 3, 4)
        q[:, _NIB_HALF[n], :, :, :, :, _NIB_VALUE[n]] = nib
    q = q.reshape(16 * tiles, I)[:O]
    packed = np.zeros((O, I // 8), np.uint32)
    for j in range(8):
        packed |= q[:, j::8] << (4 * j)
    return packed


def weights(I: int, O: int, seed: int, device) -> dict:
    """The script's weights at (I, O): w = N(0, 1) x 0.02, packed int4 group
    64 (int32 views of the uint32 words), the planes, the mxu kernel's
    fragment order (``frag``) and x = N(0, 1) f32."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((O, I)).astype(np.float32) * 0.02
    packed, scales, biases = pack_quantized(w, BITS, GROUP)
    lo, hi = plane_repack(packed)
    x = rng.standard_normal((1, I)).astype(np.float32)

    def as_t(a):  # uint32 words as int32, as PackedLinear holds them
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)

    return dict(x=as_t(x), packed=as_t(packed), scales=as_t(scales), biases=as_t(biases),
                lo=as_t(lo), hi=as_t(hi), frag=as_t(mxu_repack(packed)))


def int4pack_operands(w: dict, group: int = GROUP) -> tuple:
    """``torch._weight_int4pack_mm``'s operands for the same weights, built as
    tools/time_k3_k2.py's ``int4lib`` builds them: the MLX nibbles as
    int4pack's [O, I/2] uint8 (even values in the high nibble), then
    ``_convert_weight_to_int4pack(.., 8)``, and bf16 scale and zero [I/group,
    O, 2] with zero = bias + 8 scale ((q - 8) scale + zero = q scale + bias);
    x as bf16. K4's grouped function, not the variants'."""
    q = w["packed"]
    O, I = q.shape[0], q.shape[1] * 8
    nib = torch.stack([(q >> (4 * i)) & 0xF for i in range(8)], -1).reshape(O, I)
    pairs = ((nib[:, ::2] << 4) | nib[:, 1::2]).to(torch.uint8)
    packed = torch._convert_weight_to_int4pack(pairs, 8)
    zero = w["biases"] + 8 * w["scales"]
    sz = torch.stack([w["scales"].bfloat16(), zero.bfloat16()], -1).transpose(0, 1).contiguous()
    return w["x"].bfloat16(), packed, group, sz


def _check_x(x, I, what):
    if x.dtype != torch.float32 or tuple(x.shape) != (1, I):
        raise ValueError(f"{what}: x must be f32 [1, {I}], got {x.dtype} {tuple(x.shape)}")


def _check_mxu(x, packed, scales, biases):
    """(O, I, groups) of an mxu call on MLX words [O, I/8] or on fragment-
    order words [ceil(O/16), I/64, 32, 4] (O from the scales)."""
    O = scales.shape[0]
    if packed.dim() == 2:
        I = packed.shape[1] * 8
        ok = packed.shape[0] == O
    else:
        I = packed.shape[1] * MX_CHUNK if packed.dim() == 4 else 0
        ok = packed.dim() == 4 and tuple(packed.shape) == (-(-O // 16), I // MX_CHUNK, 32, 4)
    _check_x(x, I, "mxu_variant")
    if packed.dtype != torch.int32 or not ok or I % MX_CHUNK:
        raise ValueError(f"mxu_variant: words must be int32 [O, I/8] (MLX) or [ceil(O/16), I/64, "
                         f"32, 4] (mxu_repack) with I % 64 == 0, got {packed.dtype} "
                         f"{tuple(packed.shape)} for O = {O}")
    ng = scales.shape[-1]
    if (scales.dtype != torch.float32 or biases.dtype != torch.float32 or scales.shape != (O, ng)
            or biases.shape != (O, ng)):
        raise ValueError("mxu_variant: scales and biases must be f32 [O, groups]")
    return O, I, ng


def mxu_variant_ref(x, packed, scales, biases) -> torch.Tensor:
    """Plain version, on the MLX words: [1, O] f32."""
    _check_mxu(x, packed, scales, biases)
    q = unpack_quantized(packed, BITS)  # [O, I] f32 levels
    acc = q @ x[0].to(torch.bfloat16).float()
    return (acc * scales[:, 0] + biases.sum(-1))[None]


def mxu_variant(x, words, scales, biases) -> torch.Tensor:
    """The TPU ``mxu_variant``'s function, [1, O] f32. CUDA tensors launch
    csrc/int4_repack.cu's tensor-core kernel on ``mxu_repack``'s fragment-
    order words (MLX words raise there); CPU tensors run the plain version on
    either layout."""
    if x.device.type == "cpu":
        O = scales.shape[0]
        _check_mxu(x, words, scales, biases)
        if words.dim() == 4:
            words = torch.from_numpy(mxu_unrepack(words.numpy().view(np.uint32), O).view(np.int32))
        return mxu_variant_ref(x, words, scales, biases)
    if x.device.type != "cuda":
        raise ValueError(f"mxu_variant: unsupported device {x.device}")
    O, I, ng = _check_mxu(x, words, scales, biases)
    if words.dim() != 4:
        raise ValueError("mxu_variant: on the card the words must be in mxu_repack's fragment "
                         "order [ceil(O/16), I/64, 32, 4]")
    y = torch.empty(1, O, dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    with _cuda.on_device(x.device) as stream:
        rc = lib.qt_int4_mxu(O, I, ng, *(_cuda.ptr(t) for t in (x, words, scales, biases, y)),
                             stream)
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
        rc = lib.qt_int4_plane(O, I, ng, *(_cuda.ptr(t) for t in (x, lo, hi, scales, y)), stream)
    _cuda.check(rc, "plane_variant")
    plane_variant.launches += 1
    return y


plane_variant.launches = 0  # kernel launches (CUDA calls), not plain runs


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def variant_bytes(w: dict, lib: tuple | None = None) -> dict[str, int]:
    """Bytes each form must move, every input it reads once and its [1, O]
    output: K4 the words, scales and biases; mxu the fragment-order words,
    the scale column and the biases; plane the two planes and the scale
    column; the library call its int4pack words, scales and zeros, bf16 x
    and bf16 y."""
    O = w["packed"].shape[0]
    col = O * 4
    nb = dict(packed=nbytes(w["x"], w["packed"], w["scales"], w["biases"]) + col,
              mxu=nbytes(w["x"], w["frag"], w["biases"]) + 2 * col,
              plane=nbytes(w["x"], w["lo"], w["hi"]) + 2 * col)
    if lib is not None:
        nb["library"] = nbytes(lib[0], lib[1], lib[3]) + O * 2
    return nb


def rotating_calls(w: dict, lib: tuple | None = None) -> dict:
    """For each form (and the library call, given its operands), a call on
    the next of enough weight copies to fill ROTATE_BYTES (every call misses
    the L2)."""
    n = max(1, -(-ROTATE_BYTES // nbytes(w["packed"], w["scales"], w["biases"])))
    cp = [{k: w[k].clone() for k in ("packed", "scales", "biases", "lo", "hi", "frag")}
          for _ in range(n)]
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
        return mxu_variant(x, c["frag"], c["scales"], c["biases"])

    calls = dict(packed=k4, plane=plane, mxu=mxu)
    if lib is not None:
        xb, wq, group, sz = lib
        lcp = [(wq.clone(), sz.clone()) for _ in range(n)]

        def library():
            wq_, sz_ = lcp[next(it) % n]
            return torch._weight_int4pack_mm(xb, wq_, group, sz_)

        calls["library"] = library
    return calls


def scaled(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def main(argv: list[str]) -> dict:
    """Time the three forms and the library call at every shape; returns, by
    (I, O), their queued and back-to-back us per call, the bytes each moves,
    mxu's distance from K4 and the library's (or why it could not run)."""
    from ._card import bound_ms, card, event_ms, queued_ms, require_cuda

    n_calls = int(argv[0]) if argv else 200
    dev = require_cuda("exp_int4_repack")
    smi = card()
    names = ("packed", "plane", "mxu", "library")
    total, res = dict.fromkeys(names, 0.0), {}
    for I, O in SHAPES:
        w = weights(I, O, 0, dev)
        k4 = quant_gemv(w["x"], w["packed"], w["scales"], w["biases"], BITS, GROUP)
        dist = scaled(mxu_variant(w["x"], w["frag"], w["scales"], w["biases"]), k4)
        try:
            lib = int4pack_operands(w)
            lib_dist = scaled(torch._weight_int4pack_mm(*lib).float(), k4)
        except (RuntimeError, AttributeError, TypeError) as e:  # a build without the op
            lib, lib_dist = None, f"not available: {e}"[:300]
        calls, nb = rotating_calls(w, lib), variant_bytes(w, lib)
        us = {name: queued_ms(fn, n_calls) * 1e3 for name, fn in calls.items()}
        b2b = {name: event_ms(fn, n_calls) * 1e3 for name, fn in calls.items()}
        res[(I, O)] = dict(queued_us=us, us=b2b, bytes=nb, dist=dist, library_dist=lib_dist)
        for name in names:
            total[name] += us.get(name, 0.0)
        shown = " / ".join(names if lib is not None else names[:3])
        print(f"I={I:5d} O={O:5d}: queued us {shown}: "
              + " / ".join(f"{us[k]:.3f}" for k in names if k in us)
              + "; bounds " + " / ".join(f"{bound_ms(nb[k]) * 1e3:.3f}" for k in names if k in nb)
              + " us (bytes); back to back "
              + " / ".join(f"{b2b[k]:.2f}" for k in names if k in b2b)
              + f" us; mxu's function from K4's result: {dist:.4g} (scaled), the library's: "
              + (f"{lib_dist:.4g}" if lib is not None else lib_dist) + f"  [{smi}]", flush=True)
    print("per-layer totals (queued): " + ", ".join(f"{k} {total[k]:.3f} us" for k in names)
          + " (x28 layers = " + " / ".join(f"{total[k] * 28e-3:.4f}" for k in names)
          + f" ms/frame)  [{smi}]", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
