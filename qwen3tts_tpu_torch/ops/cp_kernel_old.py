"""K5: the older TPU layout of K2's function.

``predict_codes_fused`` replaces qwen3tts_tpu/ops/cp_kernel_old.py::
predict_codes_fused (body ``_cp_kernel``, pallas_call at :533), which
computes exactly what K2 (qwen3tts_tpu/ops/cp_kernel.py) computes: the code
predictor's 16-position inner loop for one frame of B rows. The two TPU
kernels differ only in how the B rows' 16-slot KV scratch sits in VMEM
(row-major there, slot-major in K2) and in K2's batch-aware VMEM gate.
Both are answers to where one flat cache of all rows fits in a TPU core's
VMEM; on Hopper K2's kernel (csrc/cp_loop.cu) keeps each row's 16 slots
apart in device memory with one attention block per (kv head, row), which
replaces both layouts. So on a CUDA tensor this module launches that
kernel, counted by its own ``launches``; on a CPU tensor it runs K2's plain
version. Any other device raises.

The signatures are the old module's (cp_kernel_old.py:447, 598), with the
port's seed words and ``force_codes`` in place of the PRNG key, as K2's
wrapper has them; ``mode`` defaults to ``wo_bf16`` as K2's does.
"""

from __future__ import annotations

from . import cp_kernel as cpk
from .talker_kernel import run_mode


def kernel_supported(cp_params, cp_cfg, talker_h: int) -> bool:
    """K2's gate for one row."""
    return cpk.kernel_supported(cp_params, cp_cfg, talker_h)


def predict_codes_fused(
    cp_params, cp_cfg, talker_params, last_hidden, code0, seed: tuple[int, int], *,
    temperature: float, top_k: int, top_p: float = 1.0, ref_exact_top_p: bool = False,
    mode: str = "wo_bf16", force_codes=None, return_logits: bool = False,
):
    """The CP inner loop for one frame of B rows; arguments and results as
    ``cp_kernel.predict_codes_fused``'s."""
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
              ref_exact_top_p=ref_exact_top_p, force_codes=force_codes,
              return_logits=return_logits)
    if last_hidden.device.type == "cpu":
        return cpk.predict_codes_fused_ref(cp_params, cp_cfg, talker_params, last_hidden, code0,
                                           seed, mode=mode, **kw)
    if last_hidden.device.type != "cuda":
        raise ValueError(f"predict_codes_fused: unsupported device {last_hidden.device}")
    mode = run_mode(mode, cpk.cp_layout(cp_params["layers"]), "predict_codes_fused")
    out = cpk.launch(cp_params, cp_cfg, talker_params, last_hidden, code0, seed,
                     dyn=mode == "dyn_int8", **kw)
    predict_codes_fused.launches += 1
    return out


predict_codes_fused.launches = 0  # kernel launches (CUDA calls), not plain runs
