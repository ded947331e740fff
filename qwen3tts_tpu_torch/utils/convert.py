"""The weight bridge: JAX-package parameter trees to the port's tensors.

``from_jax_params`` walks a tree of dicts/lists/tuples whose leaves are
arrays (numpy, or anything ``np.asarray`` accepts), int8 weights (any
object with ``q`` and ``scale`` leaves, such as ``qwen3tts_tpu``'s
``Int8Linear``) or packed weights (``q``, ``scales``, ``biases``, ``bits``,
``group``, as ``qwen3tts_tpu``'s ``PackedLinear``; the uint32 words cross as
int32 with the same bits). Layouts are kept: linears stay [in, out] (packed
ones [out, in/pw]), convolutions stay [W, C_in, C_out]. bfloat16 arrays
(``ml_dtypes.bfloat16``) cross bit for bit through a 16-bit view.
``to_numpy_tree`` is the inverse, for tests.

This module imports no JAX: it only reads the leaves through numpy.
``ml_dtypes`` (which ships with JAX) is imported where a bf16 leaf needs it,
so the module imports on machines without it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.talker import KVCache, KVCacheQ
from ..ops.quant import Int8Linear, PackedLinear


def _bf16() -> np.dtype:
    import ml_dtypes

    return np.dtype(ml_dtypes.bfloat16)


def _tensor(x, device) -> torch.Tensor:
    a = np.array(x)  # a writable copy: torch does not wrap read-only arrays
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype == np.uint32:  # packed words: torch keeps them as int32
        t = torch.from_numpy(a.view(np.int32))
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(tree, device=None):
    """Convert a JAX-package parameter tree to torch tensors on ``device``.
    A talker KV cache (``KVCache``, or ``KVCacheQ`` with its row scales)
    becomes the port's cache of the same kind."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    fields = getattr(tree, "_fields", None)
    for cache_type in (KVCache, KVCacheQ):
        if fields == cache_type._fields:
            return cache_type(*(_tensor(a, device) for a in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return Int8Linear(_tensor(tree.q, device), _tensor(tree.scale, device))
    if hasattr(tree, "q") and hasattr(tree, "scales"):
        return PackedLinear(
            _tensor(tree.q, device), _tensor(tree.scales, device), _tensor(tree.biases, device),
            tree.bits, tree.group,
        )
    return _tensor(tree, device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bf16())
    return t.numpy()


def to_numpy_tree(tree):
    """Inverse of :func:`from_jax_params`; ``Int8Linear`` becomes a
    ``{"q", "scale"}`` dict, ``PackedLinear`` a ``{"q" (uint32), "scales",
    "biases", "bits", "group"}`` dict."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, Int8Linear):
        return {"q": _array(tree.q), "scale": _array(tree.scale)}
    if isinstance(tree, PackedLinear):
        return {"q": _array(tree.q).view(np.uint32), "scales": _array(tree.scales),
                "biases": _array(tree.biases), "bits": tree.bits, "group": tree.group}
    return _array(tree)
