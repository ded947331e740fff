"""Device meshes and tensor-parallel sharding
(port of qwen3tts_tpu/parallel/mesh.py).

One Python process drives every device, as the JAX package's single
controller does: a :class:`Mesh` is a [dp, tp] grid of ``torch.device``,
and ``Qwen3TTSModel(..., mesh=)`` / ``generate_batch(dp_mesh=)`` take one as
they would run on a single device. It is not ``torch.distributed``'s
``DeviceMesh``, which needs a process group: no collective library is
involved, the host issues each position's work on its device's current
stream and moves the partial sums itself.

Sharding layout (Megatron-style column/row parallel), the JAX package's:
  q/k/v projections  [L, h, heads*hd]   -> shard heads over "tp"
  o projection       [L, heads*hd, h]   -> shard the contracting dim ("tp")
  gate/up            [L, h, inter]      -> shard inter over "tp"
  down               [L, inter, h]      -> shard the contracting dim ("tp")
  KV cache           [L, B, Hkv, T, D]  -> batch over "dp", Hkv over "tp"
  embeddings / norms / heads            -> replicated
Attention heads stay local to a position, so a layer's only reductions are
the two sums after o_proj and down_proj (models/talker.py ``_tp_stack``).

A sharded leaf (:class:`Sharded`) holds one part for each mesh position:
``parts[i][t]`` on ``mesh.devices[i][t]``, split along ``axis`` over the tp
positions and the same on every dp row. A replicated leaf inside ``layers``
(the norms) is a :class:`Sharded` whose parts are whole copies. A
replicated leaf outside ``layers`` (the embeddings, the final norm, the
heads, the text projection, the CP's small-to-MTP projection) is read only
by the host-side code between layer stacks, which runs on the mesh's first
device (``Mesh.home``), where each layer stack's sums are gathered: it
stays whole there. The JAX package computes those parts on every device
and keeps one result.

A device may appear in a mesh more than once: the positions that name it
share that device's memory and take turns on it. The CPU tests run meshes
of ``["cpu"] * n`` and a one-card check ``["cuda:0"] * 2``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops._cuda import device_key
from ..ops.quant import Int8Linear, PackedLinear


class Mesh:
    """A ("dp", "tp") grid of devices: ``devices[i][t]`` is position
    (i, t); ``shape`` is ``{"dp": .., "tp": ..}``."""

    def __init__(self, devices: list[list[torch.device]]):
        # "cuda" names the current card: keep its index, as tensors do
        self.devices = [[device_key(d) for d in row] for row in devices]
        if not self.devices or not self.devices[0] or any(
                len(row) != len(self.devices[0]) for row in self.devices):
            raise ValueError("a mesh is a non-empty [dp, tp] grid of devices")
        self.shape = {"dp": len(self.devices), "tp": len(self.devices[0])}

    @property
    def home(self) -> torch.device:
        """Position (0, 0): where the host-side code of a sharded model runs."""
        return self.devices[0][0]

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the mesh once, CUDA devices in index order (the
        order a decode takes their turns in, so two callers cannot
        deadlock)."""
        seen: dict[str, torch.device] = {}
        for row in self.devices:
            for d in row:
                seen.setdefault(str(d), d)
        return sorted(seen.values(), key=lambda d: (d.type, -1 if d.index is None else d.index))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]})"


def make_mesh(devices=None, tp: int | None = None) -> Mesh:
    """Build a ("dp", "tp") mesh over the given devices, or every CUDA
    device of ``torch.cuda.device_count()``; tp defaults to all of them."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise ValueError("make_mesh: no CUDA device is available; pass devices "
                             "(e.g. ['cpu'] * n)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if tp is None:
        tp = n
    if tp <= 0 or n % tp != 0:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return Mesh([devices[r * tp:(r + 1) * tp] for r in range(n // tp)])


class Spec(tuple):
    """A partition spec (the JAX ``PartitionSpec``): one entry per axis,
    "tp" where the axis is split over the tp positions, None elsewhere;
    ``Spec()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def split_axis(self) -> int | None:
        """The split axis, counted from the end (None: replicated)."""
        return self.index("tp") - len(self) if "tp" in self else None


P = Spec


class Sharded:
    """One leaf of a tensor-parallel tree: ``parts[i][t]`` (a tensor or an
    ``Int8Linear``) on ``mesh.devices[i][t]``, the t-th of tp slices along
    ``axis`` (from the end; None: each part is the whole leaf). Indexing
    slices every part along its leading axes, as the layer loops index a
    stacked leaf by layer."""

    def __init__(self, parts, axis: int | None, mesh: Mesh):
        self.parts = parts
        self.axis = axis
        self.mesh = mesh

    def __getitem__(self, idx) -> "Sharded":
        return Sharded([[p[idx] for p in row] for row in self.parts], self.axis, self.mesh)

    def gather(self) -> torch.Tensor:
        """The whole leaf (dense, or an int8 leaf dequantized) on the mesh's
        first device, from dp row 0's parts."""
        row = [_dequant(p).to(self.mesh.home) for p in self.parts[0]]
        return row[0] if self.axis is None else torch.cat(row, dim=self.axis)


def _dequant(p):
    return p.q.float() * p.scale if isinstance(p, Int8Linear) else p


def _split(x: torch.Tensor, axis: int, tp: int) -> list[torch.Tensor]:
    if x.shape[axis] % tp:
        raise ValueError(f"an axis of {x.shape[axis]} does not split over tp={tp}")
    return list(torch.chunk(x, tp, dim=axis))


def _shard_leaf(x, s: Spec, mesh: Mesh):
    """The parts of one layer leaf: split along the spec's axis over tp,
    copied to every dp row."""
    if isinstance(x, PackedLinear):
        raise ValueError(
            "TP sharding of MLX-packed int4 weights is not supported (the "
            "packed [O, I/8] layout does not match the dense specs); load "
            "with keep_packed=False or quantize='int8'"
        )
    tp, axis = mesh.shape["tp"], s.split_axis()
    if axis is None:
        return replicate(x, mesh)
    if isinstance(x, Int8Linear):
        # q follows the dense spec; scale is [..., 1, out], so an axis of
        # size 1 (the contracted dim) is not split: each part keeps it whole
        qs = _split(x.q, axis, tp)
        ss = _split(x.scale, axis, tp) if x.scale.shape[axis] != 1 else [x.scale] * tp
        slices = [Int8Linear(q.contiguous(), sc.contiguous()) for q, sc in zip(qs, ss)]
    else:
        slices = [p.contiguous() for p in _split(x, axis, tp)]
    parts = [[_to(p, d) for p, d in zip(slices, row)] for row in mesh.devices]
    return Sharded(parts, axis, mesh)


def _to(x, device):
    if isinstance(x, Int8Linear):
        return Int8Linear(x.q.to(device), x.scale.to(device))
    return x.to(device)


def tree_to(tree, device):
    """A parameter tree (dicts and lists of tensors, ``Int8Linear`` and
    ``PackedLinear`` leaves, None) on ``device``; leaves already there are
    not copied."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return None if tree is None else _to(tree, device)


_LAYER_SPECS = {
    "q_proj": P(None, None, "tp"),
    "k_proj": P(None, None, "tp"),
    "v_proj": P(None, None, "tp"),
    "o_proj": P(None, "tp", None),
    "q_norm": P(),
    "k_norm": P(),
    "gate_proj": P(None, None, "tp"),
    "up_proj": P(None, None, "tp"),
    "down_proj": P(None, "tp", None),
    "input_layernorm": P(),
    "post_attention_layernorm": P(),
}


def talker_param_specs(params: Any) -> Any:
    """Spec tree matching models/talker.py's param structure."""
    if "qkv_proj" in params.get("layers", {}):
        raise ValueError(
            "TP sharding requires unfused projections: load with fuse=False "
            "(fused qkv concat would split q/k/v head groups across shards)"
        )
    specs = {
        "codec_embedding": P(),
        "text_embedding": P(),
        "layers": dict(_LAYER_SPECS),
        "norm": P(),
        "text_projection": {"fc1": {"w": P(), "b": P()}, "fc2": {"w": P(), "b": P()}},
        "codec_head": P(),
    }
    if "text_token_map" in params:
        specs["text_token_map"] = P()
    return specs


def cp_param_specs(params: Any) -> Any:
    """Spec tree matching models/code_predictor.py's param structure."""
    if "qkv_proj" in params.get("layers", {}):
        raise ValueError(
            "TP sharding requires unfused projections: load with fuse=False "
            "(fused qkv concat would split q/k/v head groups across shards)"
        )
    specs = {
        "codec_embedding": P(),
        "layers": dict(_LAYER_SPECS),
        "norm": P(),
        "lm_head": P(),
    }
    if "small_to_mtp_projection" in params:
        specs["small_to_mtp_projection"] = {"w": P(), "b": P()}
    return specs


def cache_spec(batch_sharded: bool = True, heads_sharded: bool = True) -> Spec:
    """KV cache [L, B, Hkv, T, D]: batch over dp (if divisible), kv heads
    over tp (if divisible)."""
    return P(None, "dp" if batch_sharded else None, "tp" if heads_sharded else None, None, None)


def shard_params(params: Any, specs: Any, mesh: Mesh) -> Any:
    """Every leaf placed by its spec: the leaves under ``layers`` as
    :class:`Sharded` parts, the rest whole on ``mesh.home``. A leaf without
    a spec raises (no silent replication gaps)."""
    out = {}
    for key, value in params.items():
        if key not in specs:
            raise ValueError(f"no sharding spec for {key!r}")
        if key == "layers":
            out[key] = {k: _shard_leaf(v, specs[key][k], mesh) for k, v in value.items()}
        elif isinstance(value, dict):
            out[key] = {k: _home_leaf(v, specs[key][k], mesh) for k, v in value.items()}
        else:
            out[key] = _home_leaf(value, specs[key], mesh)
    return out


def _home_leaf(x, s, mesh: Mesh):
    if isinstance(s, dict):
        return {k: _home_leaf(v, s[k], mesh) for k, v in x.items()}
    if isinstance(x, PackedLinear):
        raise ValueError(
            "TP sharding of MLX-packed int4 weights is not supported (the "
            "packed [O, I/8] layout does not match the dense specs); load "
            "with keep_packed=False or quantize='int8'"
        )
    return _to(x, mesh.home)


def shard_talker(params: Any, mesh: Mesh) -> Any:
    return shard_params(params, talker_param_specs(params), mesh)


def shard_cp(params: Any, mesh: Mesh) -> Any:
    return shard_params(params, cp_param_specs(params), mesh)


def tree_mesh(params) -> Mesh | None:
    """The mesh a talker or CP tree is sharded over (None: unsharded)."""
    if not isinstance(params, dict):
        return None
    for leaf in params.get("layers", {}).values():
        if isinstance(leaf, Sharded):
            return leaf.mesh
    return None


class ShardedCache:
    """A KV cache ([L, B, Hkv, T, D] leaves, and [L, B, Hkv, T] row scales
    for an int8 one) split over a mesh: ``parts[i][t]`` is a cache of the
    same type on ``mesh.devices[i][t]`` holding dp row i's batch rows (every
    row when the batch is not split) and kv heads t Hkv/tp .. (t+1) Hkv/tp.
    A batch that dp does not divide stays whole on dp row 0, and kv heads
    that tp does not divide stay whole on each row's first device
    (``parts[i]`` then holds that one cache): the JAX package replicates
    such a cache instead, which computes the same rows again."""

    def __init__(self, parts, mesh: Mesh, batch: int, batch_split: bool, heads_split: bool):
        self.parts = parts
        self.mesh = mesh
        self.batch = batch
        self.batch_split = batch_split
        self.heads_split = heads_split

    @property
    def max_len(self) -> int:
        return self.parts[0][0].k.shape[3]

    @property
    def quantized(self) -> bool:
        return len(self.parts[0][0]) == 4

    def rows(self) -> list[tuple[int, slice]]:
        """(dp row, its slice of the batch) for each dp row that holds rows."""
        if not self.batch_split:
            return [(0, slice(None))]
        lb = self.batch // len(self.parts)
        return [(i, slice(i * lb, (i + 1) * lb)) for i in range(len(self.parts))]

    def gather(self):
        """The whole cache on the mesh's first device (the tests read it)."""
        home = self.mesh.home
        rows = [type(r[0])(*(torch.cat([getattr(c, f).to(home) for c in r], dim=2)
                             for f in r[0]._fields)) for r in self.parts]
        return type(rows[0])(*(torch.cat([getattr(r, f) for r in rows], dim=1)
                               for f in rows[0]._fields))


def shard_cache(cache, mesh: Mesh) -> ShardedCache:
    """Split a whole cache over ``mesh`` (``cache_spec``): batch over dp when
    dp > 1 divides it, kv heads over tp when tp divides them."""
    batch, hkv = cache.k.shape[1], cache.k.shape[2]
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    batch_split = dp > 1 and batch % dp == 0
    heads_split = hkv % tp == 0
    n_rows, n_heads = (dp if batch_split else 1), (tp if heads_split else 1)
    lb, hb = batch // n_rows, hkv // n_heads
    parts = []
    for i in range(n_rows):
        row = []
        for t in range(n_heads):
            rows, heads = slice(i * lb, (i + 1) * lb), slice(t * hb, (t + 1) * hb)
            row.append(type(cache)(*(a[:, rows, heads].contiguous().to(mesh.devices[i][t])
                                     for a in cache)))
        parts.append(row)
    return ShardedCache(parts, mesh, batch, batch_split, heads_split)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor leaf as a :class:`Sharded` of whole copies, one on each
    mesh position."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return Sharded([[_to(tree, d) for d in row] for row in mesh.devices], None, mesh)
