"""Weight quantization (port of qwen3tts_tpu/ops/quant.py).

Two formats:

* ``Int8Linear`` — the serving format of the decode hot path: int8 weights
  [..., in, out] with a per-output-channel float32 scale [..., 1, out].
* ``PackedLinear`` — MLX affine group quantization, the format of quantized
  checkpoints, kept packed in the low-memory mode
  (``from_pretrained(keep_packed=True)``): 4- or 8-bit values packed
  little-endian into 32-bit words along the input dimension, with per-group
  float32 scales and biases,

      w[o, i] = scales[o, i // group] * q[o, i] + biases[o, i // group]

  Word k of a row holds columns k*(32/bits) .. k*(32/bits) + 32/bits - 1,
  value j at bit bits*j. torch keeps the words as **int32** with the bits of
  the ``np.uint32`` array (``arr.view(np.int32)``): torch's uint32 takes few
  operators, and ``(w >> bits*j) & mask`` gives the same value on int32
  because the mask drops the sign-extended bits.

K4: ``quant_gemv`` is the dequant-in-matmul for one row (replaces
``quant_matmul_pallas``); ``quant_gemm`` computes the same function at M
rows (csrc/quant_gemm.cu, three forms chosen by M; in the JAX package XLA's
``quant_matmul`` does).
``quant_matmul`` is the plain version of both. On a CUDA tensor each wrapper
launches its kernel or raises; on a CPU tensor it runs ``quant_matmul``.
``packed_supported`` says whether both take a packed weight's shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda


class Int8Linear:
    """Weight-only int8 linear: y = (x @ q) * scale.

    q: int8 [..., in, out]; scale: float32 [..., 1, out] (symmetric,
    per output channel). Indexing slices both leaves along leading axes.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def __getitem__(self, idx):
        return Int8Linear(self.q[idx], self.scale[idx])


class PackedLinear:
    """Packed MLX-affine weight. q: int32 [..., O, I*bits/32];
    scales/biases: float32 [..., O, I/group]. Indexing slices the three
    leaves along leading axes; ``bits`` and ``group`` stay."""

    def __init__(self, q, scales, biases, bits: int = 4, group: int = 64):
        self.q = q
        self.scales = scales
        self.biases = biases
        self.bits = bits
        self.group = group

    def __getitem__(self, idx):
        return PackedLinear(self.q[idx], self.scales[idx], self.biases[idx], self.bits, self.group)

    @property
    def in_features(self) -> int:
        return self.q.shape[-1] * (32 // self.bits)

    @property
    def out_features(self) -> int:
        return self.q.shape[-2]

    def to(self, device) -> "PackedLinear":
        return PackedLinear(
            self.q.to(device), self.scales.to(device), self.biases.to(device), self.bits, self.group
        )


def pack_quantized(w: np.ndarray, bits: int = 4, group: int = 64):
    """Quantize float [O, I] to the MLX affine layout (numpy, byte-identical
    to the JAX package's). Returns (packed uint32 [O, I*bits/32], scales
    [O, I/group], biases [O, I/group])."""
    O, I = w.shape
    if I % group:
        raise ValueError(f"input width {I} is not a multiple of the group {group}")
    per_word = 32 // bits
    levels = (1 << bits) - 1
    grouped = w.reshape(O, I // group, group).astype(np.float32)
    w_min = grouped.min(axis=-1)
    w_max = grouped.max(axis=-1)
    scales = ((w_max - w_min) / levels).astype(np.float32)
    scales = np.where(scales == 0, 1e-8, scales)
    biases = w_min.astype(np.float32)
    q = np.clip(
        np.round((grouped - biases[..., None]) / scales[..., None]), 0, levels
    ).astype(np.uint32)
    q = q.reshape(O, I)
    packed = np.zeros((O, I // per_word), np.uint32)
    for j in range(per_word):
        packed |= q[:, j::per_word] << (bits * j)
    return packed, scales, biases


def packed_from_numpy(packed: np.ndarray, scales, biases, bits: int, group: int) -> PackedLinear:
    """A CPU PackedLinear from numpy leaves (uint32 words viewed as int32)."""
    q = np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)
    return PackedLinear(
        torch.from_numpy(q.copy()),
        torch.from_numpy(np.asarray(scales, np.float32).copy()),
        torch.from_numpy(np.asarray(biases, np.float32).copy()),
        bits, group,
    )


def unpack_quantized(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 words [..., I/per_word] -> float32 levels [..., I]."""
    per_word = 32 // bits
    mask = (1 << bits) - 1
    shifts = torch.arange(per_word, dtype=torch.int32, device=packed.device) * bits
    q = (packed[..., None] >> shifts) & mask  # [..., I/pw, pw]
    return q.reshape(*packed.shape[:-1], packed.shape[-1] * per_word).float()


def dequantize(packed, scales, biases, bits: int = 4, group: int = 64) -> torch.Tensor:
    """Full dequantization to float32 [..., O, I]."""
    q = unpack_quantized(packed, bits)
    I = q.shape[-1]
    s = torch.repeat_interleave(scales.float(), group, dim=-1)[..., :I]
    b = torch.repeat_interleave(biases.float(), group, dim=-1)[..., :I]
    return q * s + b


def quant_matmul(x: torch.Tensor, packed, scales, biases, bits: int = 4, group: int = 64):
    """y = x @ dequant(w).T for x [..., I], packed [O, I/pw]: dequantize,
    then an f32 matmul. Returns float32 [..., O]. The plain version of K4
    and of ``quant_gemm``."""
    w = dequantize(packed, scales, biases, bits, group)  # [O, I] f32
    return torch.matmul(x.float(), w.transpose(-1, -2))


def _packed_error(packed, scales, biases, bits: int, group: int) -> str | None:
    """Why K4 and ``quant_gemm`` do not take a packed weight (int32 words
    [..., O, W], scales and biases [..., O, I/group]), or None if they do."""
    per_word = 32 // bits if bits in (4, 8) else 1
    O, W = packed.shape[-2:]
    I = W * per_word
    if bits not in (4, 8) or group % per_word or I % group:
        return f"bits {bits} / group {group} not supported at width {I}"
    if W % 4:
        return f"{W} words per row is not a multiple of 4 (16-byte loads)"
    if group % (4 * per_word):
        return (f"a group of {group} does not hold whole 16-byte chunks "
                f"({4 * per_word} values at {bits} bits)")
    ng = I // group
    if packed.dtype != torch.int32 or scales.shape[-2:] != (O, ng) or biases.shape[-2:] != (O, ng):
        return "packed must be int32 [O, W], scales/biases [O, I/group]"
    if scales.dtype != torch.float32 or biases.dtype != torch.float32:
        return "scales and biases must be float32"
    if packed.data_ptr() % 16:
        return "packed rows must be 16-byte aligned"
    return None


def packed_supported(w) -> bool:
    """Whether every matmul on ``w`` runs a kernel on the card: a
    :class:`PackedLinear` whose shapes K4 (one row) and ``quant_gemm`` (more
    rows) both take."""
    return isinstance(w, PackedLinear) and _packed_error(
        w.q, w.scales, w.biases, w.bits, w.group) is None


def _kernel_operands(what: str, x, packed, scales, biases, bits: int, group: int, rows: str):
    """Check a CUDA call's operands; returns (x contiguous and 16-byte
    aligned, O, I). ``rows`` names x's rows in the message ("1" or "M")."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    err = _packed_error(packed, scales, biases, bits, group)
    if err is not None:
        raise ValueError(f"{what}: {err}")
    O, W = packed.shape
    I = W * (32 // bits)
    if (x.dim() != 2 or x.shape[1] != I or x.shape[0] < 1 or (rows == "1" and x.shape[0] != 1)
            or x.dtype not in (torch.bfloat16, torch.float32)):
        raise ValueError(f"{what}: x must be bf16 or f32 [{rows}, {I}], got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernels read x 16 bytes a load
        x = x.clone()
    return x, O, I


def quant_gemv(x: torch.Tensor, packed, scales, biases, bits: int = 4, group: int = 64, *,
               rows_per_warp: int = 0):
    """K4: y [1, O] = x [1, I] @ dequant(w).T in float32, without an [O, I]
    matrix in memory. x is bf16 or f32. A CPU tensor runs the plain
    :func:`quant_matmul`; a CUDA tensor launches csrc/quant_matmul.cu or
    raises on a shape the kernel does not take. ``rows_per_warp`` (timing
    only): the rows a warp of the kernel owns, 1, 2, 4 or 8; 0 lets the
    kernel choose from O, as every call of the port does."""
    if x.device.type == "cpu":
        return quant_matmul(x, packed, scales, biases, bits, group)
    x, O, I = _kernel_operands("quant_gemv", x, packed, scales, biases, bits, group, "1")
    if rows_per_warp not in (0, 1, 2, 4, 8):
        raise ValueError(f"quant_gemv: rows_per_warp {rows_per_warp} is not 0, 1, 2, 4 or 8")
    y = torch.empty(1, O, dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    with _cuda.on_device(x.device) as stream:
        rc = lib.qt_quant_gemv(
            O, I, bits, group, int(x.dtype == torch.bfloat16),
            *(_cuda.ptr(t) for t in (x, packed, scales, biases, y)), int(rows_per_warp), stream,
        )
    _cuda.check(rc, "quant_gemv")
    quant_gemv.launches += 1
    return y


quant_gemv.launches = 0  # kernel launches (CUDA calls), not plain runs


GEMM_FORMS = ("auto", "stream", "staged", "rows")  # quant_gemm's forms (csrc/quant_gemm.cu)


def quant_gemm(x: torch.Tensor, packed, scales, biases, bits: int = 4, group: int = 64, *,
               form: str = "auto", row_tiles: int = 0, slices: int = 0):
    """K4's function at M rows: y [M, O] = x [M, I] @ dequant(w).T in
    float32, without an [O, I] matrix in memory; x is bf16 or f32 (an f32 x
    keeps its precision). A CPU tensor runs the plain :func:`quant_matmul`;
    a CUDA tensor launches csrc/quant_gemm.cu or raises on a shape the
    kernel does not take. The port sends one row to K4 (``quant_gemv``).

    ``form`` (timing and tests only): "rows" (K4 on the CUDA cores for one
    or two rows of a bf16 x), "stream" (the weights straight into registers,
    tensor cores, for up to a few dozen rows), "staged" (the weights staged
    in shared memory, for more) or "auto", the kernel's own choice by M, the
    x type and the width (:func:`quant_gemm_form`), as every call of the
    port makes.
    ``row_tiles`` and ``slices`` (timing only) set the staged form's 16-row
    tiles a block (1, 2 or 4) and blocks over the rows of x; either one
    non-zero selects the staged form, 0 lets the kernel choose."""
    if x.device.type == "cpu":
        return quant_matmul(x, packed, scales, biases, bits, group)
    x, O, I = _kernel_operands("quant_gemm", x, packed, scales, biases, bits, group, "M")
    if form not in GEMM_FORMS or row_tiles not in (0, 1, 2, 4) or slices < 0:
        raise ValueError(f"quant_gemm: form {form!r} is not one of {GEMM_FORMS}, row_tiles "
                         f"{row_tiles} is not 0, 1, 2 or 4, or slices {slices} < 0")
    if row_tiles or slices:
        if form in ("stream", "rows"):
            raise ValueError("quant_gemm: row_tiles and slices belong to the staged form")
        form = "staged"
    M = x.shape[0]
    if form == "rows" and (M > 2 or x.dtype != torch.bfloat16):
        raise ValueError("quant_gemm: the rows form takes one or two rows of a bf16 x")
    y = torch.empty(M, O, dtype=torch.float32, device=x.device)
    lib = _cuda.library()
    with _cuda.on_device(x.device) as stream:
        if form == "staged" and lib.qt_quant_gemm_tiles(M, I, bits, group) == 0:
            raise ValueError(f"quant_gemm: 16 rows of width {I} at {bits} bits do not fit the "
                             f"device's shared memory (the staged form)")
        rc = lib.qt_quant_gemm(
            M, O, I, bits, group, int(x.dtype == torch.bfloat16),
            *(_cuda.ptr(t) for t in (x, packed, scales, biases, y)), GEMM_FORMS.index(form),
            int(row_tiles), int(slices), stream,
        )
    _cuda.check(rc, "quant_gemm")
    quant_gemm.launches += 1
    return y


quant_gemm.launches = 0  # kernel launches (CUDA calls), not plain runs


def quant_gemm_form(M: int, O: int, I: int, bits: int = 4, group: int = 64,
                    x_dtype: torch.dtype = torch.bfloat16, device=None) -> str:
    """The form ``quant_gemm(form="auto")`` launches on the card at these
    shapes: "rows", "stream" or "staged" (csrc/quant_gemm.cu's
    qt_quant_gemm_form); raises on a shape no form takes."""
    lib = _cuda.library()
    with _cuda.on_device(torch.device(device or "cuda")):
        code = lib.qt_quant_gemm_form(M, O, I, bits, group, int(x_dtype == torch.bfloat16))
    if code == 0:
        raise ValueError(f"quant_gemm: no form takes M {M}, [{O} x {I}], bits {bits}, "
                         f"group {group}")
    return GEMM_FORMS[code]


def embed_lookup(table: PackedLinear, ids) -> torch.Tensor:
    """Row lookup in a packed embedding table: q [V, D/pw], scales/biases
    [V, D/group]; ``ids`` indexes the leading axes (a tensor, or a tuple of
    index tensors for stacked tables). Only the gathered rows are
    dequantized. Returns float32 [..., D]."""
    if isinstance(ids, torch.Tensor):
        ids = ids.long()
    rows = table[ids]
    return dequantize(rows.q, rows.scales, rows.biases, table.bits, table.group)


def quantize_int8(w: torch.Tensor) -> Int8Linear:
    """Per-output-channel symmetric int8 quantization of [..., in, out].

    ``torch.round`` rounds half to even, like ``jnp.round``.
    """
    w32 = w.float()
    a = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(a == 0, torch.ones_like(a), a / 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return Int8Linear(q, scale)


def int8_matmul(x: torch.Tensor, w: Int8Linear) -> torch.Tensor:
    """y = x @ dequant(w): an f32 product of exact upcasts, times the scale,
    rounded once to the activation dtype. [..., out]."""
    y = torch.matmul(x.float(), w.q.float())
    return (y * w.scale).to(x.dtype)


# layer-stack keys eligible for weight-only int8 (matmuls only — norms and
# embedding gathers stay in the activation dtype)
_INT8_LAYER_KEYS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj", "qkv_proj", "gate_up_proj",
)


def quantize_decode_params_int8(params: dict, head_key: str | None) -> dict:
    """Runtime int8 quantization of a talker/code-predictor param dict:
    the stacked per-layer matmul weights plus the output head
    (``codec_head`` / ``lm_head``). Needs dense weights."""
    layers = dict(params["layers"])
    out = dict(params)
    todo = [layers[k] for k in _INT8_LAYER_KEYS if k in layers]
    if head_key and head_key in params:
        todo.append(params[head_key])
    if any(isinstance(v, (Int8Linear, PackedLinear)) for v in todo):
        raise ValueError(
            "runtime int8 quantization needs dense weights; load the checkpoint "
            "with keep_packed=False"
        )
    for k in _INT8_LAYER_KEYS:
        if k in layers:
            layers[k] = quantize_int8(layers[k])
    if head_key and head_key in params:
        out[head_key] = quantize_int8(params[head_key])
    out["layers"] = layers
    return out
