"""K2: the code predictor's whole inner loop for one frame.

``predict_codes_fused`` replaces qwen3tts_tpu/ops/cp_kernel.py::
predict_codes_fused for 1 <= B <= 64 rows (the TPU kernel body is
``_cp_kernel``). On a CUDA tensor it launches the hand-written kernel in
csrc/cp_loop.cu (one C call per frame; that file's header gives the bound
and the design); on a CPU tensor it runs ``predict_codes_fused_ref``, the
plain PyTorch version. Any other device raises.

At B = 1 the frame is one persistent cooperative kernel (two operations: a
memset of its barrier words and the launch). If its grid cannot be
resident at once the call raises (``CoResidencyError``), and a grid barrier
that waits past ``BARRIER_BUDGET_NS`` sets a flag in pinned host memory
that ``check_barrier`` raises on (``BarrierTimeout``): the decode loops
(models/generate.py, models/batch_generate.py) check it at each frame's
host synchronisation and at the end of a chunk, and the next B = 1 call
checks it first. The faulted frame's codes are -1. Neither takes another
path.

It takes the layers int8 with per-channel scales, fused or unfused (q/k/v
and gate/up apart, as the TPU kernel's gate allows, cp_kernel.py:466-474;
the kernel reads the separate matrices as column segments of one weight,
with no copy), or fused dense bf16; int8 or dense bf16 heads; and the
small-to-MTP projection of a CP narrower than its talker (the 1.7B model:
``small_to_mtp_projection`` {"w": bf16 [talker_h, H], "b": bf16 [H]}),
which maps each position's talker-width input x to bf16(bf16(x @ w) + b)
before the first layer. The TPU kernel took int8 layers without a
projection and left the rest to XLA. ``mode`` is the TPU kernel's:
``wo_bf16`` (the port's default; the JAX wrapper's is ``dyn_int8``, which
no JAX caller relies on) or ``dyn_int8`` (int8 layers and heads meet each
activation row quantized to int8, summed s8 x s8 in int32; the layers give
bf16(f32(acc) * (s * scale)), the heads (f32(acc) * s) * scale; the
projection stays a bf16 matvec).

The loop: positions 0 and 1 take [talker hidden, talker codec_embedding
(code0)]; positions 2..15 take the previous position's sampled code through
its ``codec_embedding[j]`` row. Positions 1..15 apply ``lm_head[j]``
(j = position - 1), then the sampler (exact top-k, top-p where top_p < 1,
Gumbel-max on stream j + 1 + 16 b of the counter generator for row b, so
row 0 draws what a single-sequence call draws; no penalty, mask or EOS).
Each row attends over its own 16 slots (the TPU kernel's block-diagonal
mask over one flat cache). ``rows`` (``decode_blocks.SampRows``, serving's
per-request sampling) gives each row its own temperature, top-k and top-p
(columns 0-2; the CP applies no penalty, as the JAX
``code_predictor.predict_codes`` says): at B > 1 the kernel reads them from
a device table, at B = 1 the persistent frame takes row 0's as its
scalars; no launch is added.
Returns the 15 codes and ``esum``, the f32 sum of the 15 sampled embedding
rows, of every row.

``force_codes`` (tests and comparisons) feeds the given codes forward in
place of the sampled ones, which makes a greedy comparison teacher-forced;
the returned codes stay the sampled ones.

``batched_gemv`` runs the kernel's batched GEMV (B > 1) alone, in its
tensor-core form (K2's) or its CUDA-core form (K1's), for tests and timing;
the port's decode never calls it. ``batched_gemv_ref`` is its plain version.
"""

from __future__ import annotations

import functools

import torch

from ..models.talker import _embed
from . import _cuda
from ._cuda import BarrierTimeout, CoResidencyError
from .decode_blocks import (
    STREAMS_PER_ROW, inv_temperature, layer_step, mv, mv_f32, rms, row_sampling, sample_row,
    top_p_any, top_p_threshold,
)
from .quant import Int8Linear
from .rope import rope_cos_sin
from .talker_kernel import MODES, _dense_bf16, _layout, _weight, run_mode

MAX_BATCH = _cuda.MAX_BATCH
PROJ = "small_to_mtp_projection"
BARRIER_BUDGET_NS = 2_000_000_000  # the longest a B = 1 frame's block waits at one barrier
_COOP_TOO_LARGE = 720  # cudaErrorCooperativeLaunchTooLarge
# the B = 1 frame cut after each kind of phase (csrc/cp_loop.cu's CUT_*), for timing
FRAME_CUTS = ("barriers", "gemv", "prologue", "attention", "sampler")
UNFUSED_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
# the kernel's seven weight operands: fused stacks fill q (qkv) and gate (gate_up)
_FUSED_AS_SEVEN = ("qkv_proj", None, None, "o_proj", "gate_up_proj", None, "down_proj")


def cp_layout(layers) -> str | None:
    """"int8" (fused, or the seven unfused projections all ``Int8Linear``),
    "bf16" (fused dense bf16) or None: the layer layouts K2 reads."""
    if "qkv_proj" not in layers and all(isinstance(layers.get(k), Int8Linear)
                                        for k in UNFUSED_KEYS):
        return "int8"
    return _layout(layers)


def _projection_ok(cp_params, cp_cfg, talker_h: int) -> bool:
    """No projection with equal widths, or a dense bf16 one from the talker
    width to the CP's."""
    proj = cp_params.get(PROJ)
    if proj is None:
        return cp_cfg.hidden_size == talker_h
    w, b = proj.get("w"), proj.get("b")
    return (_dense_bf16(w) and _dense_bf16(b)
            and tuple(w.shape) == (talker_h, cp_cfg.hidden_size)
            and tuple(b.shape) == (cp_cfg.hidden_size,))


def kernel_supported(cp_params, cp_cfg, talker_h: int, batch: int = 1) -> bool:
    """Layers in a layout of ``cp_layout``, int8 or dense bf16 heads, dense
    embedding tables, the projection where the widths differ, 1..MAX_BATCH
    rows."""
    if cp_layout(cp_params["layers"]) is None or not _projection_ok(cp_params, cp_cfg, talker_h):
        return False
    head = cp_params.get("lm_head")
    if not (isinstance(head, Int8Linear) or _dense_bf16(head)):
        return False
    if not isinstance(cp_params.get("codec_embedding"), torch.Tensor):
        return False
    lim = _cuda.LIMITS
    G = cp_cfg.num_attention_heads // cp_cfg.num_key_value_heads
    return (
        1 <= batch <= MAX_BATCH
        and talker_h % 16 == 0
        and cp_cfg.head_dim == lim["HEAD_DIM"]
        and cp_cfg.num_attention_heads % cp_cfg.num_key_value_heads == 0
        and G <= lim["ATTN_MAX_GROUP"]
        and cp_cfg.hidden_size % 16 == 0
        and cp_cfg.intermediate_size % 16 == 0
        and cp_cfg.vocab_size % 16 == 0
        and cp_cfg.vocab_size <= lim["SAMPLE_THREADS"] * lim["SAMPLE_PER_THREAD"]
    )


def _x0(talker_params, last_hidden, code0) -> torch.Tensor:
    """[B, 2, talker_h] bf16: each row's talker hidden and talker embedding
    of code0."""
    emb = _embed(talker_params["codec_embedding"], code0.reshape(-1))
    return torch.stack([last_hidden, emb.to(last_hidden.dtype)], dim=1).to(torch.bfloat16)


def _head(heads, j: int):
    """Head j of the stacked int8 or dense heads [15, H, V]."""
    return Int8Linear(heads.q[j], heads.scale[j]) if isinstance(heads, Int8Linear) else heads[j]


@functools.lru_cache(maxsize=8)
def _rope_tables(cp_cfg, device):
    """cos/sin [16, D] bf16 of the 16 slots (cached: the per-frame path does
    no host-to-device copy)."""
    pos = torch.arange(cp_cfg.num_code_groups, device=device)[None]
    cos, sin = rope_cos_sin(pos, cp_cfg.head_dim, cp_cfg.rope_theta, torch.bfloat16)
    return cos[0].contiguous(), sin[0].contiguous()


def predict_codes_fused_ref(
    cp_params, cp_cfg, talker_params, last_hidden, code0, seed: tuple[int, int], *,
    temperature: float, top_k: int, top_p: float = 1.0, ref_exact_top_p: bool = False,
    force_codes=None, return_logits: bool = False, mode: str = "wo_bf16", rows=None,
):
    """Plain PyTorch version of K2 (same rounding points as the kernel).
    ``rows``: row b samples with ``_cp_sampling(rows, b)``."""
    mode = run_mode(mode, cp_layout(cp_params["layers"]), "predict_codes_fused")
    L = cp_cfg.num_hidden_layers
    NKV, D = cp_cfg.num_key_value_heads, cp_cfg.head_dim
    NCB, SLOTS = cp_cfg.num_code_groups - 1, cp_cfg.num_code_groups
    B = last_hidden.shape[0]
    dev = last_hidden.device
    cos_t, sin_t = _rope_tables(cp_cfg, dev)
    kc = torch.zeros(L, B, NKV, SLOTS, D, dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    tables = cp_params["codec_embedding"]
    x0 = _x0(talker_params, last_hidden, code0)
    proj = cp_params.get(PROJ)
    esum = torch.zeros(B, x0.shape[-1], dtype=torch.float32, device=dev)  # talker width
    forced = None if force_codes is None else force_codes.reshape(B, NCB).long()
    scalars = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    per_row = [scalars if rows is None else _cp_sampling(rows, b) for b in range(B)]
    codes, all_logits = [], []
    x = x0[:, 0]
    for p in range(SLOTS):
        if p == 1:
            x = x0[:, 1]
        h = x if proj is None else mv(x, proj["w"]) + proj["b"]
        pos = torch.full((B,), p, dtype=torch.int64, device=dev)
        cos, sin = cos_t[p].expand(B, D), sin_t[p].expand(B, D)
        for l in range(L):
            h = layer_step(cp_params["layers"], l, cp_cfg, h, cos, sin, (kc[l], vc[l]), pos,
                           cp_form=True, mode=mode)
        if p == 0:
            continue
        j = p - 1
        hn = rms(h, cp_params["norm"], cp_cfg.rms_norm_eps)
        logits = mv_f32(hn, _head(cp_params["lm_head"], j), mode, cp_head=True)
        code = torch.cat([
            sample_row(logits[b], **per_row[b], ref_exact_top_p=ref_exact_top_p, seed=seed,
                       stream=j + 1 + STREAMS_PER_ROW * b)
            for b in range(B)
        ])
        codes.append(code)
        all_logits.append(logits)
        fed = code.long() if forced is None else forced[:, j]
        x = tables[j][fed].to(torch.bfloat16)
        esum = esum + x.float()
    out = torch.stack(codes, dim=1)
    if return_logits:
        lg = torch.stack(all_logits)  # [NCB, B, V]
        return out, esum, lg[:, 0] if B == 1 else lg
    return out, esum


def predict_codes_fused(
    cp_params, cp_cfg, talker_params, last_hidden, code0, seed: tuple[int, int], *,
    temperature: float, top_k: int, top_p: float = 1.0, ref_exact_top_p: bool = False,
    force_codes=None, return_logits: bool = False, mode: str = "wo_bf16", rows=None,
):
    """The CP inner loop for one frame of B rows.

    last_hidden [B, talker_h]; code0 [B] int32; seed: two 32-bit words;
    force_codes [B, 15]; top_p / ref_exact_top_p: the sampler's top-p stage
    (off at top_p >= 1); rows: per-row sampling values
    (``decode_blocks.SampRows`` of B rows) in place of temperature, top_k
    and top_p; mode: see ``talker_kernel.run_mode``. Returns
    (codes [B, 15] int32, esum [B, talker_h] f32[, logits f32 [15, V] at
    B=1, else [15, B, V]]).
    """
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
              ref_exact_top_p=ref_exact_top_p, force_codes=force_codes,
              return_logits=return_logits, rows=rows)
    if last_hidden.device.type == "cpu":
        return predict_codes_fused_ref(cp_params, cp_cfg, talker_params, last_hidden, code0, seed,
                                       mode=mode, **kw)
    if last_hidden.device.type != "cuda":
        raise ValueError(f"predict_codes_fused: unsupported device {last_hidden.device}")
    mode = run_mode(mode, cp_layout(cp_params["layers"]), "predict_codes_fused")
    out = launch(cp_params, cp_cfg, talker_params, last_hidden, code0, seed,
                 dyn=mode == "dyn_int8", **kw)
    predict_codes_fused.launches += 1
    predict_codes_fused.mode_launches[mode] += 1
    return out


_err_flag: torch.Tensor | None = None  # pinned int32 [1], written by the card on a timeout


def _barrier_flag() -> torch.Tensor:
    global _err_flag
    if _err_flag is None:
        _err_flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    return _err_flag


def check_barrier(sync_device=None) -> None:
    """Raise ``BarrierTimeout`` if a B = 1 frame that has finished had a
    barrier run past its budget (its codes are then -1); the flag is
    cleared. The frames enqueued before the caller's last synchronisation
    have finished; with ``sync_device`` (a CUDA device) the host first waits
    for all of that device's work. No B = 1 frame launched yet: nothing to
    check."""
    flag = _err_flag
    if flag is None:
        return
    if sync_device is not None:
        torch.cuda.synchronize(sync_device)
    if int(flag[0]) != 0:
        flag.zero_()
        raise BarrierTimeout("K2 persistent barrier timed out")


def _cp_sampling(rows, b: int) -> dict:
    """Row b's temperature, top_k and top_p (the CP applies no penalty)."""
    kw = row_sampling(rows.vec[b])
    del kw["rep_penalty"]
    return kw


def launch(cp_params, cp_cfg, talker_params, last_hidden, code0, seed, *, temperature, top_k,
           top_p, ref_exact_top_p, force_codes, return_logits, dyn, rows=None, blocks: int = 0,
           budget_ns: int = BARRIER_BUDGET_NS, cut: int = 0):
    """One call of the kernel in csrc/cp_loop.cu on CUDA tensors (the
    wrappers count it: this one and ops/cp_kernel_old.py's). At B = 1:
    ``blocks`` the persistent grid (0: one block per SM), ``budget_ns`` the
    longest wait at one barrier (tests shrink both); for timing only, ``cut``
    a cut of the frame (``FRAME_CUTS``; 0, the whole frame, on every call of
    the port)."""
    H, TH = cp_cfg.hidden_size, last_hidden.shape[-1]
    B = last_hidden.shape[0]
    if not kernel_supported(cp_params, cp_cfg, TH, B):
        raise ValueError(f"predict_codes_fused: weights in no layout it reads (int8 fused or "
                         f"unfused, fused bf16), a projection it does not take, or batch {B} "
                         f"outside 1..{MAX_BATCH}")
    if last_hidden.dim() != 2 or code0.numel() != B:
        raise ValueError("predict_codes_fused: last_hidden must be [B, talker_h] and code0 [B]")
    if force_codes is not None and force_codes.numel() != B * (cp_cfg.num_code_groups - 1):
        raise ValueError("predict_codes_fused: force_codes must hold one code per codebook and row")
    L, NQ, NKV, D = (cp_cfg.num_hidden_layers, cp_cfg.num_attention_heads,
                     cp_cfg.num_key_value_heads, cp_cfg.head_dim)
    NCB, SLOTS, V = cp_cfg.num_code_groups - 1, cp_cfg.num_code_groups, cp_cfg.vocab_size
    if tuple(cp_params["codec_embedding"].shape) != (NCB, V, TH):
        raise ValueError(f"predict_codes_fused: codec_embedding must be [{NCB}, {V}, {TH}]")
    layers = cp_params["layers"]
    head = cp_params["lm_head"]
    w_bf16, head_bf16 = cp_layout(layers) == "bf16", not isinstance(head, Int8Linear)
    proj = cp_params.get(PROJ)
    I = _weight(layers["down_proj"])[0].shape[-2]  # down_proj [L, I, H]
    dev = last_hidden.device
    f32 = lambda t: t.float().contiguous()
    cos_t, sin_t = _rope_tables(cp_cfg, dev)
    kc = torch.empty(L, B, NKV, SLOTS, D, dtype=torch.bfloat16, device=dev)
    vc = torch.empty_like(kc)
    # converted operands stay referenced until every launch is enqueued
    ins = [
        _x0(talker_params, last_hidden, code0).transpose(0, 1).contiguous(),  # [2, B, TH]
        *(t for k in (_FUSED_AS_SEVEN if "qkv_proj" in layers else UNFUSED_KEYS)
          for t in (_weight(layers[k]) if k else (None, None))),
        f32(layers["input_layernorm"]), f32(layers["post_attention_layernorm"]),
        f32(layers["q_norm"]), f32(layers["k_norm"]), f32(cp_params["norm"]),
        *_weight(head),
        cp_params["codec_embedding"].to(torch.bfloat16).contiguous(),
        None if proj is None else proj["w"].contiguous(),
        None if proj is None else proj["b"].contiguous(),
        cos_t, sin_t, kc, vc,
    ]
    force = None if force_codes is None else force_codes.to(torch.int32).reshape(-1).contiguous()
    oqkv = (NQ + 2 * NKV) * D
    single = B == 1  # the persistent frame keeps its activations on chip
    act = lambda n: None if single else torch.empty(B, n, dtype=torch.bfloat16, device=dev)
    bufs = [
        act(H),  # residual stream
        act(H),  # normed input
        act(NQ * D),  # attention out
        act(I),  # SwiGLU out
        torch.empty(_cuda.workspace_rows(B) * max(oqkv, 2 * I, H, V),
                    dtype=torch.float32, device=dev),
        torch.empty(B, TH, dtype=torch.bfloat16, device=dev),  # next position's input
        _cuda.amax_slots(B, dev) if dyn and not single else None,
    ]
    if single:
        check_barrier()
        ctl = torch.empty(2, dtype=torch.int32, device=dev)  # the barrier's words
        flag = _barrier_flag()
    else:
        ctl = flag = None
    codes = torch.empty(B, NCB, dtype=torch.int32, device=dev)
    esum = torch.empty(B, TH, dtype=torch.float32, device=dev)
    logits = torch.empty(NCB, B, V, dtype=torch.float32, device=dev) if return_logits else None
    table, top_p_thr = None, top_p_threshold(top_p)
    if rows is not None:
        if rows.vec.shape[0] != B:
            raise ValueError(f"predict_codes_fused: {rows.vec.shape[0]} sampling rows for {B} rows")
        # at B = 1 the persistent frame takes row 0's values as its scalars
        row0 = _cp_sampling(rows, 0)
        temperature, top_k = row0["temperature"], row0["top_k"]
        table, top_p_thr = (rows.table if B > 1 else None), top_p_any(rows)
    rc = _cuda.library().qt_cp_loop(
        L, H, NQ, NKV, D, I, V, NCB, B, TH, int(w_bf16), int(head_bf16), int(dyn),
        cp_cfg.rms_norm_eps, D**-0.5,
        *(_cuda.ptr(t) for t in ins),
        int(temperature <= 0), inv_temperature(temperature), int(top_k), top_p_thr,
        int(ref_exact_top_p),
        seed[0] & 0xFFFFFFFF, seed[1] & 0xFFFFFFFF, _cuda.ptr(table),
        _cuda.ptr(force),
        *(_cuda.ptr(t) for t in bufs),
        _cuda.ptr(codes), _cuda.ptr(esum), _cuda.ptr(logits), _cuda.ptr(ctl),
        None if flag is None else flag.data_ptr(), int(blocks), int(budget_ns), int(cut),
        _cuda.stream_ptr(),
    )
    if single and rc == _COOP_TOO_LARGE:
        grid = f"{blocks} blocks" if blocks else "one block per SM"
        raise CoResidencyError(f"predict_codes_fused: the B = 1 frame's grid ({grid}) cannot be "
                               "resident on the card at once")
    _cuda.check(rc, "predict_codes_fused")
    if return_logits:
        return codes, esum, logits[:, 0] if B == 1 else logits
    return codes, esum


predict_codes_fused.launches = 0  # kernel launches (CUDA calls), not plain runs
predict_codes_fused.mode_launches = dict.fromkeys(MODES, 0)  # the same, by the mode run


def batched_gemv_ref(x, w, amax=None) -> torch.Tensor:
    """Plain version of K2's batched GEMV, its split partials summed: x bf16
    [B, I] @ w [I, O] (int8 values or bf16) in f32, unscaled; with ``amax``
    (dyn_int8, f32 [B]) x quantized per row with s = max(amax * f32(1/127),
    1e-12) and the exact int32 sum. Returns [B, O] f32 or int32."""
    if amax is None:
        return x.float() @ w.float()
    s = torch.clamp_min(amax.float() * (1.0 / 127.0), 1e-12)
    xq = torch.round(x.float() / s[:, None])
    return (xq.double() @ w.double()).to(torch.int32)


def batched_gemv(x, w, amax=None, *, tensor_cores: bool = True) -> torch.Tensor:
    """The first pass of K2's batched GEMV alone: x bf16 [B, I] (2 <= B <=
    64) @ w [I, O] (int8 or bf16; I, O multiples of 16), with ``amax`` the
    dyn_int8 form. Returns the split partials [splits, B, O] (f32, or int32
    in dyn_int8) of the tensor-core form K2 runs (``tensor_cores``) or of
    the CUDA-core form K1 runs; on a CPU tensor the plain version's sum as
    one split."""
    if x.device.type == "cpu":
        return batched_gemv_ref(x, w, amax)[None]
    if x.device.type != "cuda":
        raise ValueError(f"batched_gemv: unsupported device {x.device}")
    (B, I), O = x.shape, w.shape[-1]
    if x.dtype != torch.bfloat16 or w.dtype not in (torch.int8, torch.bfloat16) or w.shape[0] != I:
        raise ValueError(f"batched_gemv: x {tuple(x.shape)} {x.dtype} against w {tuple(w.shape)} "
                         f"{w.dtype}")
    if amax is not None and (w.dtype != torch.int8 or amax.shape != (B,)):
        raise ValueError("batched_gemv: dyn_int8 takes int8 weights and one amax per row")
    lib = _cuda.library()
    splits = lib.qt_cp_gemv_splits(B, I, O)
    part = torch.empty(splits, B, O, dtype=torch.float32 if amax is None else torch.int32,
                       device=x.device)
    # operands stay referenced until the launch is enqueued
    w, x = w.contiguous(), x.contiguous()
    amax = None if amax is None else amax.float().contiguous()
    rc = lib.qt_cp_gemv(int(tensor_cores), int(w.dtype == torch.bfloat16), int(amax is not None),
                        B, I, O, *(_cuda.ptr(t) for t in (w, x, amax, part)), _cuda.stream_ptr())
    _cuda.check(rc, "batched_gemv")
    batched_gemv.launches += 1
    return part


batched_gemv.launches = 0  # kernel launches (CUDA calls), not plain runs
