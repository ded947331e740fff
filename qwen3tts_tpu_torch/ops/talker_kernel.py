"""K1: one talker decode step for B rows, with or without the codec head
and code0 sampler.

``talker_decode_step`` replaces qwen3tts_tpu/ops/talker_kernel.py::
talker_decode_step (the TPU kernel body is ``_talker_step_kernel``) for
1 <= B <= 64 rows at their own cache offsets, on a bf16 cache or an int8
cache with per-row f32 scales (``KVCacheQ``), in sample mode (the codec head
and the code0 sampler of every row) or non-sample mode (the post-norm hidden
only), on either fused layout (``_layout``): int8 weights with per-channel
scales (the TPU kernel's ``wo_bf16`` mode) or dense bf16 weights (its
``bf16`` mode, no scale). The codec head is int8 or dense bf16 by itself.
``mode="dyn_int8"`` (the TPU kernel's third mode, int8 layers only)
quantizes each matvec's activation row to int8 with its own scale and sums
s8 x s8 in int32: the layers give bf16(f32(acc) * (s * scale)), an int8
codec head f32(acc) * (s * scale); a dense head stays bf16. On a CUDA
tensor it launches a hand-written kernel: at B = 1 the persistent step of
csrc/talker_frame.cu (one cooperative launch a step after a memset of its
barrier words: 2 operations), at B > 1 the multi-launch step of
csrc/talker_step.cu (one C call, 8 L + 3 launches); each file's header
gives the bound and the design. The switch is the batch alone: every B = 1
call, sample mode or not, on either cache, in every mode, takes the
persistent step, and nothing falls back to the multi-launch form. If the
persistent grid cannot be resident at once the call raises
(``CoResidencyError``); a grid barrier that waits past
``BARRIER_BUDGET_NS`` sets a pinned host flag that ``check_barrier`` raises
on (``BarrierTimeout``; the decode loops check it with K2's at each
frame's host synchronisation, and the next B = 1 call checks it first),
and that step's code0 is -1 and its hidden NaN. On a CPU tensor it runs
``talker_decode_step_ref``, the plain PyTorch version of the same function.
Any other device raises. The plain version is never the CUDA path: on the
card it serves only comparisons and timings.

Per layer: RMSNorm -> fused qkv matvec -> QK-RMSNorm -> rope at each
row's offset -> GQA attention over the row's cache rows [0, offset] (the new
k/v row is written into the cache IN PLACE at the offset; an int8 cache
takes it quantized, while the current token attends with its own
unquantized k/v, as the TPU kernel does) -> o_proj + residual -> RMSNorm ->
gate_up, SwiGLU -> down + residual. Then the final RMSNorm and, in sample
mode, the codec head and the sampler (ops/decode_blocks.py ``sample_row``,
top-k and top-p included; row b draws from stream 16 b of the counter
generator, so row 0 draws what a single-sequence call draws). ``rows``
(``decode_blocks.SampRows``, serving's per-request sampling) gives each row
its own temperature, top-k, top-p and penalty in place of the scalars: at
B > 1 the kernel reads them from a device table, at B = 1 the persistent
step takes row 0's as its scalars; no launch is added.

Two call forms: ``offset`` an int (one sequence, x [1, 1, H], cos/sin one
[D] row; returns h [H], code0 [1], logits [V]) or an int tensor [B] on the
device of x (x [B, 1, H], cos/sin [B, D]; returns h [B, H], code0 [B],
logits [B, V]).
"""

from __future__ import annotations

import functools
import weakref

import torch

from . import _cuda
from ._cuda import BarrierTimeout, CoResidencyError
from .decode_blocks import (
    STREAMS_PER_ROW, inv_temperature, layer_step, mv_f32, out_dim, rms, row_sampling, sample_row,
    top_p_any, top_p_threshold,
)
from .quant import Int8Linear

_FUSED_KEYS = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
MAX_BATCH = _cuda.MAX_BATCH
MODES = ("wo_bf16", "bf16", "dyn_int8")  # the TPU kernels' matmul modes
BARRIER_BUDGET_NS = 2_000_000_000  # the longest a B = 1 step's block waits at one barrier
_COOP_TOO_LARGE = 720  # cudaErrorCooperativeLaunchTooLarge
# the B = 1 step cut after each kind of phase (csrc/talker_frame.cu's TF_CUT_*), for timing
STEP_CUTS = ("barriers", "gemv", "prologue", "attention", "sampler")
# the B = 1 step with a part of each layer taken away (TF_PART_*), T6's ablations
STEP_PARTS = ("full", "noattn", "nomlp")


def _dense_bf16(w) -> bool:
    return isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16


def _layout(layers) -> str | None:
    """The fused layout of a layer stack, as the JAX package's ``_layout``:
    "int8" (every fused projection an ``Int8Linear``), "bf16" (every one a
    dense bf16 stack) or None (unfused, mixed, packed or another dtype).
    K1 and K2 read both fused layouts."""
    ws = [layers.get(k) for k in _FUSED_KEYS]
    if all(isinstance(w, Int8Linear) for w in ws):
        return "int8"
    if all(_dense_bf16(w) for w in ws):
        return "bf16"
    return None


def _weight(w):
    """(weight, scale) operands of the kernels: an int8 weight with its f32
    scale, or a dense bf16 weight with none (the kernels then multiply by no
    scale)."""
    return (w.q, w.scale) if isinstance(w, Int8Linear) else (w.contiguous(), None)


def run_mode(mode: str, layout: str | None, what: str) -> str:
    """The mode a call runs in, checked against the weights' layout:
    ``wo_bf16`` (the default) multiplies the layout's own weights, int8 with
    scales or dense bf16 (the mode JAX names ``bf16``, which requires dense
    bf16 weights); ``dyn_int8`` requires int8 weights. Raises ValueError on
    any other mode or a mismatch."""
    if mode not in MODES:
        raise ValueError(f"{what}: unknown mode {mode!r} (expected one of {', '.join(MODES)})")
    if mode == "dyn_int8" and layout != "int8":
        raise ValueError(f"{what}: dyn_int8 takes int8 weights, not the {layout} layout")
    if mode == "bf16" and layout != "bf16":
        raise ValueError(f"{what}: the bf16 mode takes dense bf16 weights, not the {layout} layout")
    return "bf16" if layout == "bf16" else mode


def step_supported(params, cfg, batch: int = 1, kv_quant: bool = False) -> bool:
    """A fused layout (``_layout``) with an int8 or dense bf16 codec head, at
    shapes the kernel takes: any batch of 1..MAX_BATCH rows, a bf16 or an
    int8 cache (``kv_quant``)."""
    lim = _cuda.LIMITS
    G = cfg.num_attention_heads // cfg.num_key_value_heads
    head = params.get("codec_head")
    return (
        _layout(params["layers"]) is not None
        and (isinstance(head, Int8Linear) or _dense_bf16(head))
        and 1 <= batch <= MAX_BATCH
        and cfg.head_dim == lim["HEAD_DIM"]
        and cfg.num_attention_heads % cfg.num_key_value_heads == 0
        and G <= lim["ATTN_MAX_GROUP"]
        and cfg.hidden_size % 16 == 0
        and max(cfg.layer_intermediate_size(i) for i in range(cfg.num_hidden_layers)) % 16 == 0
        and cfg.vocab_size % 16 == 0
        and cfg.vocab_size <= lim["SAMPLE_THREADS"] * lim["SAMPLE_PER_THREAD"]
    )


def _one_row(out):
    """The results of an int-offset call: h, logits without the batch axis
    (code0 stays [1])."""
    if not isinstance(out, tuple):
        return out[0]
    return (out[0][0], out[1], *(None if t is None else t[0] for t in out[2:]))


def talker_decode_step_ref(
    params, cfg, x, cache, offset, cos, sin, *, sample: bool = True,
    temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0, ref_exact_top_p: bool = False,
    rep_penalty: float = 1.0, eos_id: int = -1, seed: tuple[int, int] = (0, 0),
    suppress_add=None, seen=None, return_logits: bool = False, mode: str = "wo_bf16",
    split_blocks: int | None = None, rows=None,
):
    """Plain PyTorch version of K1 (same rounding points as the kernel).
    ``rows``: row b samples with ``row_sampling(rows.vec[b])``.
    ``split_blocks``: the attention cut into the persistent B = 1 step's
    chunks for a grid of that many blocks and merged as it merges them
    (``decode_blocks.split_attend``); None, one softmax over the rows,
    which differs from it only in rounding order."""
    mode = run_mode(mode, _layout(params["layers"]), "talker_decode_step")
    if isinstance(offset, int):
        offs = torch.full((1,), offset, dtype=torch.int64, device=x.device)
        return _one_row(talker_decode_step_ref(
            params, cfg, x, cache, offs, cos, sin, sample=sample, temperature=temperature,
            top_k=top_k, top_p=top_p, ref_exact_top_p=ref_exact_top_p,
            rep_penalty=rep_penalty, eos_id=eos_id, seed=seed,
            suppress_add=suppress_add, seen=seen, return_logits=return_logits, mode=mode,
            split_blocks=split_blocks, rows=rows))
    B, D = x.shape[0], cfg.head_dim
    pos = offset.to(torch.int64)
    cos, sin = (t.to(torch.bfloat16).reshape(-1, D).expand(B, D) for t in (cos, sin))
    h = x.reshape(B, cfg.hidden_size).to(torch.bfloat16)
    for l in range(cfg.num_hidden_layers):
        h = layer_step(params["layers"], l, cfg, h, cos, sin, tuple(c[l] for c in cache), pos,
                       cp_form=False, mode=mode, split_blocks=split_blocks)
    hn = rms(h, params["norm"], cfg.rms_norm_eps)
    if not sample:
        return hn
    logits = mv_f32(hn, params["codec_head"], mode)
    seen = seen.reshape(-1, logits.shape[-1]).expand(B, -1)
    scalars = dict(temperature=temperature, top_k=top_k, top_p=top_p, rep_penalty=rep_penalty)
    code = torch.cat([
        sample_row(
            logits[b], **(scalars if rows is None else row_sampling(rows.vec[b])),
            ref_exact_top_p=ref_exact_top_p, seen=seen[b], suppress_add=suppress_add,
            eos_id=eos_id, seed=seed, stream=STREAMS_PER_ROW * b,
        )
        for b in range(B)
    ])
    return (hn, code, logits) if return_logits else (hn, code)


def talker_decode_step(
    params, cfg, x, cache, offset, cos, sin, *, sample: bool = True,
    temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0, ref_exact_top_p: bool = False,
    rep_penalty: float = 1.0, eos_id: int = -1, seed: tuple[int, int] = (0, 0),
    suppress_add=None, seen=None, return_logits: bool = False, mode: str = "wo_bf16",
    rows=None,
):
    """One decode step for B rows.

    x [B, 1, H] bf16; cache: talker ``KVCache`` bf16 [L, B, NKV, T, D] or
    ``KVCacheQ`` (int8 rows + f32 scales [L, B, NKV, T]); offset: valid cache
    rows of each sequence (its new row goes there), an int (B=1) or an int
    tensor [B]; cos/sin [B, D] rope rows at the offsets. Sample mode:
    suppress_add f32 [V] (shared), seen bool [B, V]; seed: two 32-bit words;
    top_p / ref_exact_top_p: the sampler's top-p stage (off at top_p >= 1);
    rows: per-row sampling values (``decode_blocks.SampRows`` of B rows) in
    place of temperature, top_k, top_p and rep_penalty. ``mode``: see
    ``run_mode``. Returns (h bf16 after the final norm, code0
    int32 [, logits f32 before mask and penalty]) in sample mode, else h;
    shapes in the module doc.
    """
    kw = dict(
        sample=sample, temperature=temperature, top_k=top_k, top_p=top_p,
        ref_exact_top_p=ref_exact_top_p, rep_penalty=rep_penalty,
        eos_id=eos_id, seed=seed, suppress_add=suppress_add, seen=seen,
        return_logits=return_logits, rows=rows,
    )
    if x.device.type == "cpu":
        return talker_decode_step_ref(params, cfg, x, cache, offset, cos, sin, mode=mode, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"talker_decode_step: unsupported device {x.device}")
    mode = run_mode(mode, _layout(params["layers"]), "talker_decode_step")
    out = launch(params, cfg, x, cache, offset, cos, sin, dyn=mode == "dyn_int8", **kw)
    talker_decode_step.launches += 1
    talker_decode_step.mode_launches[mode] += 1
    talker_decode_step.persistent_launches += x.shape[0] == 1
    return out


def launch(
    params, cfg, x, cache, offset, cos, sin, *, sample, temperature, top_k, top_p,
    ref_exact_top_p, rep_penalty, eos_id, seed, suppress_add, seen, return_logits, dyn,
    rows=None, blocks: int = 0, budget_ns: int = BARRIER_BUDGET_NS, cut: int = 0,
    part: str = "full", h_out=None,
):
    """One call of the kernel on CUDA tensors (``talker_decode_step`` counts
    it). At B = 1 (the persistent step): ``blocks`` the grid (0: one block
    per SM), ``budget_ns`` the longest wait at one barrier (tests shrink
    both); for timing only, ``cut`` stops the step after a kind of phase
    (``STEP_CUTS``; 0, the whole step, on every call of the port), and
    ``part`` takes a part of each layer away (``STEP_PARTS``, T6's
    ablations; "full" on every call of the port), with ``h_out`` (bf16 [H])
    taking h before the final norm."""
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    NQ, NKV, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    B = x.shape[0]
    quant = len(cache) == 4
    if not step_supported(params, cfg, B, quant):
        raise ValueError(f"talker_decode_step: weights in neither fused layout (int8, bf16), "
                         f"shapes it does not take, or batch {B} outside 1..{MAX_BATCH}")
    layers = params["layers"]
    head = params["codec_head"]
    w_bf16, head_bf16 = _layout(layers) == "bf16", not isinstance(head, Int8Linear)
    I = out_dim(layers["gate_up_proj"]) // 2
    V = out_dim(head)
    T = cache.k.shape[3]
    single = isinstance(offset, int)
    if x.dtype != torch.bfloat16 or x.shape != (B, 1, H):
        raise ValueError("talker_decode_step: x must be bf16 [B, 1, H]")
    want = torch.int8 if quant else torch.bfloat16
    if cache.k.dtype != want or cache.k.shape != (L, B, NKV, T, D):
        raise ValueError(f"talker_decode_step: cache must be {want} [L, B, NKV, T, D]")
    if quant and cache.ks.shape != (L, B, NKV, T):
        raise ValueError("talker_decode_step: cache scales must be f32 [L, B, NKV, T]")
    if single:
        if B != 1 or not 0 <= offset < T:
            raise ValueError(f"talker_decode_step: an int offset ({offset}) takes one sequence "
                             f"and a row inside the cache of {T}")
        offs = None
        if cos.numel() != D or sin.numel() != D:
            raise ValueError("talker_decode_step: cos/sin must be one [D] rope row")
    else:
        if offset.shape != (B,) or offset.device != x.device:
            raise ValueError("talker_decode_step: offsets must be [B] on the device of x")
        offs = offset.to(torch.int32).contiguous()
        if cos.shape != (B, D) or sin.shape != (B, D):
            raise ValueError("talker_decode_step: cos/sin must be [B, D] rope rows")
    dev = x.device
    bf16 = lambda t: _aligned(t.to(torch.bfloat16).contiguous())
    # converted operands stay referenced until every launch is enqueued
    ins = [
        _aligned(x.contiguous()),
        *(t for k in _FUSED_KEYS for t in _weight(layers[k])),
        *(_f32_once(t) for t in (layers["input_layernorm"], layers["post_attention_layernorm"],
                                 layers["q_norm"], layers["k_norm"], params["norm"])),
        cache.k, cache.v, cache.ks if quant else None, cache.vs if quant else None,
    ]
    rope = [bf16(cos), bf16(sin)]
    if sample:
        if suppress_add.numel() != V or seen.dtype != torch.bool or seen.numel() != B * V:
            raise ValueError("talker_decode_step: suppress_add must be [V], seen bool [B, V]")
        tail = [*_weight(head), _f32_once(suppress_add), seen.contiguous()]
    else:
        tail = [None] * 4
    oqkv = out_dim(layers["qkv_proj"])
    xn = torch.empty(B, H, dtype=torch.bfloat16, device=dev)
    code = torch.empty(B, dtype=torch.int32, device=dev) if sample else None
    logits = torch.empty(B, V, dtype=torch.float32, device=dev) if sample and return_logits else None
    table, top_p_thr = None, top_p_threshold(top_p)
    if rows is not None and sample:
        if rows.vec.shape[0] != B:
            raise ValueError(f"talker_decode_step: {rows.vec.shape[0]} sampling rows for {B} rows")
        # at B = 1 the persistent step takes row 0's values as its scalars
        row0 = row_sampling(rows.vec[0])
        temperature, top_k, rep_penalty = row0["temperature"], row0["top_k"], row0["rep_penalty"]
        table, top_p_thr = (rows.table if B > 1 else None), top_p_any(rows)
    sampling = (float(rep_penalty), int(temperature <= 0), inv_temperature(temperature),
                int(top_k), top_p_thr,
                int(ref_exact_top_p), int(eos_id), seed[0] & 0xFFFFFFFF, seed[1] & 0xFFFFFFFF)
    lib = _cuda.library()
    if B == 1:
        check_barrier()
        grid = blocks or _num_sms(dev)
        cmax = max(1, grid // NKV)
        ws, att, ctl = _frame_workspace(dev, workspace_floats(1, oqkv, I, H, V),
                                        NKV * cmax * (NQ // NKV) * (D + 4))
        rc = lib.qt_talker_frame(
            L, H, NQ, NKV, D, I, V, T, offset if single else 0, _cuda.ptr(offs), int(quant),
            int(w_bf16), int(head_bf16), int(dyn), cfg.rms_norm_eps, D**-0.5,
            *(_cuda.ptr(t) for t in ins), *(_cuda.ptr(t) for t in rope),
            *(_cuda.ptr(t) for t in tail), *sampling,
            _cuda.ptr(ws), _cuda.ptr(att), cmax, _cuda.ptr(xn), _cuda.ptr(code),
            _cuda.ptr(logits), _cuda.ptr(ctl), _barrier_flag().data_ptr(), int(blocks),
            int(budget_ns), int(cut), STEP_PARTS.index(part), _cuda.ptr(h_out),
            _cuda.stream_ptr(),
        )
        if rc == _COOP_TOO_LARGE:
            what = f"{blocks} blocks" if blocks else "one block per SM"
            raise CoResidencyError(f"talker_decode_step: the B = 1 step's grid ({what}) cannot "
                                   "be resident on the card at once")
    else:
        hres = torch.empty(B, H, dtype=torch.bfloat16, device=dev)
        attn = torch.empty(B, NQ * D, dtype=torch.bfloat16, device=dev)
        gated = torch.empty(B, I, dtype=torch.bfloat16, device=dev)
        ws = torch.empty(workspace_floats(B, oqkv, I, H, V), dtype=torch.float32, device=dev)
        amax = _cuda.amax_slots(B, dev) if dyn else None
        rc = lib.qt_talker_step(
            L, H, NQ, NKV, D, I, V, T, B, offset if single else 0, _cuda.ptr(offs), int(quant),
            int(w_bf16), int(head_bf16), int(dyn), cfg.rms_norm_eps, D**-0.5,
            *(_cuda.ptr(t) for t in ins),
            *(_cuda.ptr(t) for t in rope), 0 if single else D,
            *(_cuda.ptr(t) for t in tail), *sampling, _cuda.ptr(table),
            *(_cuda.ptr(t) for t in (hres, xn, attn, gated, ws, amax, code, logits)),
            _cuda.stream_ptr(),
        )
    _cuda.check(rc, "talker_decode_step")
    out = xn if not sample else (xn, code, logits) if return_logits else (xn, code)
    return _one_row(out) if single else out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    persistent step stages its vectors 16 bytes a copy)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# f32 copies of the norm weights (and the suppress mask), made once per
# source tensor and version rather than at every step; keyed by the
# source's id, dropped with it
_F32: dict = {}


def _f32_once(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    key = id(t)
    hit = _F32.get(key)
    if hit is None or hit[0]() is not t or hit[1] != t._version:
        hit = (weakref.ref(t, lambda _, k=key: _F32.pop(k, None)), t._version,
               t.float().contiguous())
        _F32[key] = hit
    return hit[2]


@functools.cache
def _num_sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# The persistent step's buffers, allocated once for each device and size:
# the two GEMV partial buffers, the attention items' partials, the barrier
# words (zeroed by the step itself). Steps on one stream reuse them in turn.
_WORKSPACES: dict = {}


def _frame_workspace(dev, n_ws: int, n_att: int):
    key = (dev, n_ws, n_att)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = (torch.empty(n_ws, dtype=torch.float32, device=dev),
                            torch.empty(n_att, dtype=torch.float32, device=dev),
                            torch.empty(2, dtype=torch.int32, device=dev))
    return _WORKSPACES[key]


_err_flag: torch.Tensor | None = None  # pinned int32 [1], written by the card on a timeout


def _barrier_flag() -> torch.Tensor:
    global _err_flag
    if _err_flag is None:
        _err_flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    return _err_flag


def check_barrier(sync_device=None) -> None:
    """Raise ``BarrierTimeout`` if a B = 1 step that has finished had a
    barrier (or its weight copies) wait past its budget (its code0 is then
    -1, its hidden NaN); the flag is cleared. With ``sync_device`` the host
    first waits for that device's work. No B = 1 step launched yet: nothing
    to check."""
    flag = _err_flag
    if flag is None:
        return
    if sync_device is not None:
        torch.cuda.synchronize(sync_device)
    if int(flag[0]) != 0:
        flag.zero_()
        raise BarrierTimeout("K1 persistent barrier timed out")


def step_barriers(L: int, sample: bool) -> int:
    """Grid barriers of one persistent B = 1 step: TF_BARRIERS_PER_LAYER a
    layer (qkv, attention, o, gate_up, down) and the codec head's in sample
    mode, where the multi-launch step made 8 L + 3 launches."""
    return _cuda.TALKER_FRAME_LIMITS["TF_BARRIERS_PER_LAYER"] * L + int(sample)


def workspace_floats(B: int, oqkv: int, I: int, H: int, V: int) -> int:
    """Floats of the GEMV partial sums of one step: the most splits x rows
    of the step's GEMVs (``_cuda.workspace_rows``: the tensor-core form at
    B > 1, which may split up to TC_MAX_PARTS rows deep) times the widest
    output (qkv, gate_up, the residual stream or the codec head). A smaller
    buffer would be written past its end without an error."""
    return _cuda.workspace_rows(B) * max(oqkv, 2 * I, H, V)


talker_decode_step.launches = 0  # kernel launches (CUDA calls), not plain runs
talker_decode_step.mode_launches = dict.fromkeys(MODES, 0)  # the same, by the mode run
talker_decode_step.persistent_launches = 0  # the same, of the persistent B = 1 step
