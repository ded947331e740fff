"""Token sampling (port of qwen3tts_tpu/ops/sampling.py).

The plain sampler of the unfused path, in the reference order:

  1. suppress invalid tokens (-inf through a boolean mask)
  2. repetition penalty over previously generated ids (``seen``)
  3. greedy argmax when temperature <= 0
  4. save the raw EOS logit
  5. top-k filter (exact k-th value), 6. top-p nucleus filter
  7. restore the raw EOS logit
  8. categorical draw of logits * (1/temperature) by the Gumbel-max trick,
     with noise from an explicit ``torch.Generator``.

``sample_token_vec`` is the same sampler with per-row parameters
(serving's per-request sampling). The samplers inside the kernels
(ops/decode_blocks.py) draw from a
counter-based generator instead, so that a kernel and its plain version
draw the same noise.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep every logit >= the k-th largest, set the rest to -inf."""
    v = logits.shape[-1]
    if k <= 0 or k >= v:
        return logits
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= thresh, logits, torch.full_like(logits, NEG_INF))


def apply_top_p(logits: torch.Tensor, p: float, ref_exact: bool = False) -> torch.Tensor:
    """Nucleus filter: keep the smallest set of tokens with mass >= p.

    ``ref_exact`` cumulates unnormalized exp(logits) as the reference does.
    """
    if p <= 0.0 or p >= 1.0:
        return logits
    lf = logits.float()
    probs = torch.exp(lf) if ref_exact else torch.softmax(lf, dim=-1)
    order = torch.argsort(logits, dim=-1, stable=True)  # ascending
    cum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    cum_orig = torch.empty_like(cum).scatter_(-1, order, cum)
    return torch.where(cum_orig > (1.0 - p), logits, torch.full_like(logits, NEG_INF))


def apply_repetition_penalty(
    logits: torch.Tensor, seen: torch.Tensor, penalty: float
) -> torch.Tensor:
    """Penalize every vocab id marked in ``seen`` (bool [V])."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(
        logits < 0, logits * penalty, logits / torch.full_like(logits, penalty)
    )
    return torch.where(seen, penalized, logits)


def sample_token_inner(
    generator: torch.Generator | None,
    logits: torch.Tensor,
    *,
    temperature: float,
    top_k: int,
    top_p: float,
    repetition_penalty: float = 1.0,
    seen: torch.Tensor | None = None,
    suppress_mask: torch.Tensor | None = None,
    eos_token_id: int | None = None,
    ref_exact_top_p: bool = False,
) -> torch.Tensor:
    """Sample token ids from logits [..., V] -> int32 [...]."""
    logits = logits.float()
    if suppress_mask is not None:
        logits = torch.where(suppress_mask, torch.full_like(logits, NEG_INF), logits)
    if seen is not None:
        logits = apply_repetition_penalty(logits, seen, repetition_penalty)

    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)

    if eos_token_id is not None:
        eos_logit = logits[..., eos_token_id].clone()
    logits = apply_top_k(logits, top_k)
    logits = apply_top_p(logits, top_p, ref_exact=ref_exact_top_p)
    if eos_token_id is not None:
        logits = logits.clone()
        logits[..., eos_token_id] = eos_logit

    u = torch.rand(
        logits.shape, generator=generator, device=logits.device, dtype=torch.float32
    )
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits * (1.0 / temperature) + gumbel, dim=-1).to(torch.int32)


def sample_token_vec(
    generator: torch.Generator | None,
    logits: torch.Tensor,  # [B, V]
    *,
    temperature,  # [B] float32
    top_k,  # [B], truncated to ints
    top_p=None,  # [B] float32 (None: the filter is off)
    repetition_penalty=None,  # [B] float32
    seen: torch.Tensor | None = None,  # [B, V] bool
    suppress_mask: torch.Tensor | None = None,  # [V] bool
    eos_token_id: int | None = None,
    ref_exact_top_p: bool = False,
) -> torch.Tensor:
    """The sampler with per-row parameters (serving's per-request
    sampling): row b follows ``sample_token_inner`` with that row's
    scalars, in the same filter order and with the same disable rules
    (temperature <= 0 greedy, top_k outside (0, V) off, top_p outside
    (0, 1) off), and the same float32 values: 1 / temperature and 1 - top_p
    are taken in double and rounded to float32, as the scalar path's Python
    floats are. The k-th largest of each row comes from one ascending sort;
    the noise is one draw of [B, V] uniforms, as the scalar path's, made
    when any row samples. Returns int32 [B]."""
    logits = logits.float()
    B, V = logits.shape
    dev = logits.device

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32).reshape(B).to(dev)

    t = col(temperature)
    if suppress_mask is not None:
        logits = torch.where(suppress_mask, torch.full_like(logits, NEG_INF), logits)
    if repetition_penalty is not None and seen is not None:
        pen = col(repetition_penalty)[:, None]
        penalized = torch.where(logits < 0, logits * pen, logits / pen)
        logits = torch.where(seen, penalized, logits)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if not bool((t > 0).any()):
        return greedy_tok
    if eos_token_id is not None:
        eos_logit = logits[:, eos_token_id].clone()

    k = col(top_k).to(torch.int64)
    kth = torch.sort(logits, dim=-1).values.gather(-1, (V - k.clamp(1, V))[:, None])
    keep = ((k <= 0) | (k >= V))[:, None] | (logits >= kth)
    logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))

    if top_p is not None:
        p = col(top_p)
        probs = torch.exp(logits) if ref_exact_top_p else torch.softmax(logits, dim=-1)
        order = torch.argsort(logits, dim=-1, stable=True)
        cum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
        cum_orig = torch.empty_like(cum).scatter_(-1, order, cum)
        thr = (1.0 - p.double()).float()
        keep = ((p <= 0.0) | (p >= 1.0))[:, None] | (cum_orig > thr[:, None])
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))

    if eos_token_id is not None:
        logits = logits.clone()
        logits[:, eos_token_id] = eos_logit
    inv_t = torch.where(t > 0, 1.0 / t.double(), 1.0).float()
    u = torch.rand(logits.shape, generator=generator, device=dev, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(logits * inv_t[:, None] + gumbel, dim=-1).to(torch.int32)
    return torch.where(t > 0, sampled, greedy_tok)


def build_suppress_mask(
    vocab_size: int, eos_token_id: int, n_special: int = 1024, device=None
) -> torch.Tensor:
    """Mask over the last ``n_special`` vocab ids except EOS."""
    mask = np.zeros((vocab_size,), dtype=bool)
    mask[vocab_size - n_special :] = True
    mask[eos_token_id] = False
    return torch.from_numpy(mask).to(device)
