"""Data-parallel scale-out of the lockstep decode over replicas
(port of qwen3tts_tpu/parallel/dp.py).

``parallel/mesh.py`` covers tensor parallelism. This module covers the
other production axis, serving throughput, the way a model that fits one
card is deployed on several: replicate the single-card configuration
(fused projections, int8 weights, K1 and K2) on each device and shard the
*requests*, not the layers.

One process drives every shard, as the JAX package's single controller
does (its ``shard_map`` over "dp"):

  - weights replicated: one copy of the fused tree on each distinct device
    of the mesh (``replicas``), each shard streaming its own copy;
  - every per-sequence buffer (prompts, lengths, caps, the KV cache's batch
    rows, the sampling table) split into B/dp rows a shard;
  - each shard runs the port's UNMODIFIED single-device functions of
    models/batch_generate.py on its rows, so K1 and K2 (or, on packed
    weights, K4 and ``quant_gemm``) serve every lockstep frame of every
    shard at the shard's B/dp rows, or the call raises
    (``batch_generate._require_kernels``). Shards on distinct
    devices run at once, each in a host thread of its own under
    ``torch.cuda.device`` (the lockstep loop reads its device back once a
    frame, so one host thread would run them one after another); shards
    that name the same device take turns on it in one thread.

Decode is embarrassingly parallel over sequences: no collective in the
steady state. A shard whose sequences are all done does not step
(the per-shard early exit of ``generate_chunk_batch``'s loop; a shard whose
every row is capped at 0 is not called at all).

The "distributed carry" is a list of per-shard ``BatchCarry``, each on its
device with its own generator and seed words: the torch form of JAX's
[dp]-leading ``step`` and ``key``. Shard s decodes with
``shard_seed(seed, s)``, the counterpart of ``fold_in(key, s)`` (shard 0
keeps ``seed``): rows of a B > 1 call draw from streams 16 b + j of their
seed words, so without the fold row 0 of every shard would draw the same
streams. Slots keep their global indices at the API: slot s lives on shard
s // (B/dp). The single-device server is the one-shard case of the same
functions.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from ..models import batch_generate as bg
from ..ops.decode_blocks import MASK32, stream_key
from .mesh import Mesh, tree_mesh, tree_to


def dp_size(mesh: Mesh) -> int:
    """Usable data-parallel width of a ("dp", "tp") mesh (tp must be 1:
    the fast path replicates whole-model weights per device)."""
    if mesh.shape.get("tp", 1) != 1:
        raise ValueError(
            "generate_codes_batch_dp replicates full weights per device; "
            f"use a tp=1 mesh (got tp={mesh.shape['tp']}). For models too "
            "big for one chip, use the TP path (parallel/mesh.py)."
        )
    if "dp" not in mesh.shape:
        raise ValueError(
            f"dp mesh needs a 'dp' axis (got axes {tuple(mesh.shape)}); "
            "build it with parallel.mesh.make_mesh(devices, tp=1)"
        )
    return mesh.shape["dp"]


def shard_devices(mesh: Mesh) -> list[torch.device]:
    """Shard s's device (a tp=1 mesh's column)."""
    dp_size(mesh)
    return [row[0] for row in mesh.devices]


def shard_seed(seed: int, s: int) -> int:
    """Shard s's seed: ``seed`` itself for shard 0 (so a one-shard run, the
    single-device server, draws what it drew before dp existed), else the
    low 32 bits of ``seed`` folded with s through the kernels' 32-bit mixer
    (``decode_blocks.stream_key``, ``mix32`` and ``stream_key`` in
    csrc/common.cuh), the high bits kept. Shards 1.. get distinct seeds (the
    mixer is a bijection in s)."""
    if s == 0:
        return seed
    lo, hi = seed & MASK32, (seed >> 32) & MASK32
    return (hi << 32) | stream_key(lo, hi, s)


# one copy of a tree on each device, made once: keyed by the id of the
# tree's first tensor (dropped with it), checked against the ids of all its
# leaves
_REPLICAS: dict[int, tuple] = {}
_REPLICAS_LOCK = threading.Lock()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for t in vars(tree).values() if isinstance(t, torch.Tensor)]


def replicas(params, mesh: Mesh) -> list:
    """``params`` on each shard's device: the tree itself where it already
    lies there, else one copy for each distinct device, made at the first
    call and reused while ``params`` lives. A tensor-parallel tree lies on
    its mesh's first device (the one-shard mesh of a server over a TP
    model); it is never copied."""
    tm = tree_mesh(params)
    home = tm.home if tm is not None else _leaves(params)[0].device
    devices = shard_devices(mesh)
    if all(dev == home for dev in devices):
        return [params] * len(devices)
    if tm is not None:
        raise ValueError("a tensor-parallel tree is not replicated over a dp mesh")
    leaves = _leaves(params)
    ids = tuple(map(id, leaves))
    with _REPLICAS_LOCK:
        entry = _REPLICAS.get(ids[0])
        if entry is None or entry[0] != ids:
            entry = (ids, {})
            _REPLICAS[ids[0]] = entry
            weakref.finalize(leaves[0], _REPLICAS.pop, ids[0], None)
        copies = entry[1]
        out = []
        for dev in devices:
            if dev == home:
                out.append(params)
                continue
            if str(dev) not in copies:
                copies[str(dev)] = tree_to(params, dev)
            out.append(copies[str(dev)])
    return out


def run_shards(mesh: Mesh, fn) -> list:
    """``fn(s, device)`` for every shard s, in shard order of the results.
    Shards on distinct devices run at once, one host thread a device under
    ``torch.cuda.device``; shards that name the same device run one after
    another in its thread. The first shard's exception (in shard order)
    is raised after every thread has ended."""
    devices = shard_devices(mesh)
    by_device: dict[str, list[int]] = {}
    for s, dev in enumerate(devices):
        by_device.setdefault(str(dev), []).append(s)
    results: list = [None] * len(devices)
    errors: list = [None] * len(devices)

    def run(shards):
        for s in shards:
            dev = devices[s]
            try:
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        results[s] = fn(s, dev)
                else:
                    results[s] = fn(s, dev)
            except BaseException as ex:  # noqa: BLE001  (raised below, in shard order)
                errors[s] = ex
                return

    groups = list(by_device.values())
    threads = [threading.Thread(target=run, args=(g,), name=f"qwen3tts-dp-{g[0]}")
               for g in groups[1:]]
    for t in threads:
        t.start()
    run(groups[0])
    for t in threads:
        t.join()
    for ex in errors:
        if ex is not None:
            raise ex
    return results


def _rows(x, s: int, dp: int, device):
    """Shard s's rows of a per-sequence argument: a list holds one entry a
    shard already; a tensor or array is split on its first axis (a tensor
    moved to ``device``); None stays None."""
    if x is None or isinstance(x, list):
        return None if x is None else x[s]
    n = x.shape[0] // dp
    part = x[s * n:(s + 1) * n]
    return part.to(device) if isinstance(part, torch.Tensor) else part


def _cache_rows(cache, s: int, dp: int, device):
    """Shard s's cache: from a list of per-shard caches, or shard s's batch
    rows of a whole cache copied to ``device``."""
    if isinstance(cache, list):
        return cache[s]
    n = cache.k.shape[1] // dp
    return type(cache)(*(a[:, s * n:(s + 1) * n].contiguous().to(device) for a in cache))


def _check_batch(B: int, dp: int) -> None:
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp={dp}")


def _gather(parts: list[torch.Tensor], device) -> torch.Tensor:
    return torch.cat([p.to(device) for p in parts])


def generate_codes_batch_dp(
    talker_params, cp_params, *, mesh: Mesh, talker_cfg, cp_cfg, sampling, prefill_embeds,
    prefill_lens, trailing_embeds, trailing_lens, tts_pad_embed, cache, max_steps,
    max_frames: int, seed: int, samp_vec=None,
) -> bg.BatchResult:
    """Lockstep batch synthesis sharded over the mesh's "dp" axis: shard s
    of B/dp rows runs ``batch_generate.generate_codes_batch`` with
    ``shard_seed(seed, s)``. ``cache`` is a whole cache (its rows are split)
    or a list of per-shard caches. B must divide by the dp size. The result
    is gathered on the first shard's device."""
    dp = dp_size(mesh)
    _check_batch(prefill_embeds.shape[0], dp)
    tks, cps = replicas(talker_params, mesh), replicas(cp_params, mesh)
    lens = [torch.as_tensor(x, dtype=torch.int32) for x in (prefill_lens, trailing_lens, max_steps)]

    def shard(s, dev):
        return bg.generate_codes_batch(
            tks[s], cps[s], talker_cfg=talker_cfg, cp_cfg=cp_cfg, sampling=sampling,
            prefill_embeds=_rows(prefill_embeds, s, dp, dev),
            prefill_lens=_rows(lens[0], s, dp, dev),
            trailing_embeds=_rows(trailing_embeds, s, dp, dev),
            trailing_lens=_rows(lens[1], s, dp, dev), tts_pad_embed=tts_pad_embed.to(dev),
            cache=_cache_rows(cache, s, dp, dev), max_steps=_rows(lens[2], s, dp, dev),
            max_frames=max_frames, seed=shard_seed(seed, s),
            samp_vec=_rows(samp_vec, s, dp, dev),
        )

    out = run_shards(mesh, shard)
    home = mesh.home
    return bg.BatchResult(codes=_gather([r.codes for r in out], home),
                          n_frames=_gather([r.n_frames for r in out], home),
                          tokens=_gather([r.tokens for r in out], home))


# ---------------------------------------------------------------------------
# Continuous batching under dp: the three serving entry points of
# models/batch_generate.py (prefill_start_batch, generate_chunk_batch,
# admit_slot) run per shard over a distributed carry (a list of per-shard
# BatchCarry). Slots keep their global indices at the API: slot s lives on
# shard s // (B/dp).
# ---------------------------------------------------------------------------


def prefill_start_batch_dp(
    talker_params, cp_params, *, mesh: Mesh, talker_cfg, cp_cfg, sampling, prefill_embeds,
    prefill_lens, trailing_embeds, trailing_lens, tts_pad_embed, cache, max_frames: int,
    seed: int, samp_vec=None,
) -> list[bg.BatchCarry]:
    """Sharded prefill and first frame; returns the distributed carry.
    ``samp_vec`` [B, 4] (sampling.per_request): per-slot sampling values,
    split with the slots."""
    dp = dp_size(mesh)
    _check_batch(prefill_embeds.shape[0], dp)
    tks, cps = replicas(talker_params, mesh), replicas(cp_params, mesh)
    lens = [torch.as_tensor(x, dtype=torch.int32) for x in (prefill_lens, trailing_lens)]
    return run_shards(mesh, lambda s, dev: bg.prefill_start_batch(
        tks[s], cps[s], talker_cfg=talker_cfg, cp_cfg=cp_cfg, sampling=sampling,
        prefill_embeds=_rows(prefill_embeds, s, dp, dev), prefill_lens=_rows(lens[0], s, dp, dev),
        trailing_embeds=_rows(trailing_embeds, s, dp, dev),
        trailing_lens=_rows(lens[1], s, dp, dev), tts_pad_embed=tts_pad_embed.to(dev),
        cache=_cache_rows(cache, s, dp, dev), max_frames=max_frames, seed=shard_seed(seed, s),
        samp_vec=_rows(samp_vec, s, dp, dev),
    ))


def generate_chunk_batch_dp(
    talker_params, cp_params, carry: list[bg.BatchCarry], *, mesh: Mesh, talker_cfg, cp_cfg,
    sampling, trailing_embeds, trailing_lens, tts_pad_embed, max_steps, until_step,
    samp_vec=None,
) -> list[bg.BatchCarry]:
    """One decode chunk per shard (distributed carry in and out).
    ``until_step`` bounds each shard's lockstep counter: an int applies to
    every shard, a sequence of dp ints gives each its own bound (the serving
    loop passes each shard's own step + chunk, so a shard that idled keeps
    chunk-granular harvest and admission). ``trailing_embeds`` is a whole
    [B, T, h] buffer or a list of per-shard ones. A shard whose every row is
    capped at 0 steps is not called: its carry stays as it was."""
    dp = dp_size(mesh)
    tks, cps = replicas(talker_params, mesh), replicas(cp_params, mesh)
    until = [int(until_step)] * dp if np.ndim(until_step) == 0 else [int(u) for u in until_step]
    if len(until) != dp or len(carry) != dp:
        raise ValueError(f"{len(carry)} shard carries and {len(until)} bounds for dp={dp}")
    caps = torch.as_tensor(max_steps, dtype=torch.int32)
    lens = torch.as_tensor(trailing_lens, dtype=torch.int32)

    def shard(s, dev):
        cap = _rows(caps, s, dp, torch.device("cpu"))
        if not bool((cap > 0).any()):
            return carry[s]
        return bg.generate_chunk_batch(
            tks[s], cps[s], carry[s], talker_cfg=talker_cfg, cp_cfg=cp_cfg, sampling=sampling,
            trailing_embeds=_rows(trailing_embeds, s, dp, dev),
            trailing_lens=_rows(lens, s, dp, dev), tts_pad_embed=tts_pad_embed.to(dev),
            max_steps=cap.to(dev), until_step=until[s], samp_vec=_rows(samp_vec, s, dp, dev),
        )

    return run_shards(mesh, shard)


def admit_slot_dp(
    talker_params, cp_params, carry: list[bg.BatchCarry], trailing_all: list[torch.Tensor], *,
    mesh: Mesh, talker_cfg, cp_cfg, sampling, slot: int, prefill_embeds, prefill_len: int,
    trailing_row, trailing_len: int, tts_pad_embed, seed: int, samp_row=None,
) -> tuple[list[bg.BatchCarry], list[torch.Tensor]]:
    """Admit a request into GLOBAL slot ``slot`` between decode chunks: the
    owner shard (slot // local B) runs ``batch_generate.admit_slot`` on its
    local slot with ``shard_seed(seed, owner)``; every other shard is not
    touched. The JAX package computes the prefill on every shard and
    commits it on the owner's, as one SPMD program must; here the owner
    alone runs it. ``trailing_all`` is the list of per-shard trailing
    buffers."""
    dp = dp_size(mesh)
    local_b = carry[0].codes.shape[0]
    owner = slot // local_b
    if not 0 <= owner < dp:
        raise ValueError(f"slot {slot} outside the {dp * local_b} slots")
    dev = shard_devices(mesh)[owner]
    tks, cps = replicas(talker_params, mesh), replicas(cp_params, mesh)

    def admit():
        return bg.admit_slot(
            tks[owner], cps[owner], carry[owner], trailing_all[owner], talker_cfg=talker_cfg,
            cp_cfg=cp_cfg, sampling=sampling, slot=slot - owner * local_b,
            prefill_embeds=prefill_embeds.to(dev), prefill_len=prefill_len,
            trailing_row=trailing_row.to(dev), trailing_len=trailing_len,
            tts_pad_embed=tts_pad_embed.to(dev), seed=shard_seed(seed, owner), samp_row=samp_row,
        )

    if dev.type == "cuda":
        with torch.cuda.device(dev):
            c, tr = admit()
    else:
        c, tr = admit()
    carry, trailing_all = list(carry), list(trailing_all)
    carry[owner], trailing_all[owner] = c, tr
    return carry, trailing_all


def global_step(carry: list[bg.BatchCarry]) -> int:
    """The largest lockstep counter of a distributed carry (the right chunk
    base: lagging shards are all-done ones)."""
    return max(c.step for c in carry)
