"""Sharding rules for the production mesh (twin of
``repro.distributed.sharding``), and the placing of tensors on a mesh.

Axes: ``data`` (DP), ``model`` (TP/SP/EP), optional ``pod`` (cross-pod DP, or
PP when pipeline parallelism is enabled).

The spec functions are the reference's, rule for rule. They walk the
parameter / cache tree with key paths (dict keys; tuple indices), so
optional leaves (biases, qk-norm, MoE) are handled uniformly across all 10
archs, and return a tree of ``PartitionSpec`` of the same nesting. They read
only ``mesh.shape``. A leaf that is no tensor (the cache's ``length``, a
host int) gets ``P()``.

The reference hands its specs to GSPMD. The port places and splits itself,
in one process: ``device_put`` gives each leaf as a ``ShardedTensor``, one
owned copy of its slice per mesh coordinate on that coordinate's device. A
mesh may name one card in every entry, so each slice is cloned: a
full-extent slice would otherwise be a view of the one storage, and an
in-place update would write it once per coordinate.

The tensor-parallel step computes on the slices where they lie:
``group_view`` gives each model shard of one data index its local tree
(``local``: its own shards), where a leaf also cut over the data axes
(FSDP, ``fsdp_dim``) is a ``DataSlices`` of its data group's shards,
gathered one layer at a time where it is used (``materialize``,
``gather_layer``). ``model_groups`` / ``data_groups`` name the coordinates
each split runs over. ``gather`` (``ShardedTensor.full``) concatenates the
slices back into full tensors, for checkpoints and tests.

The decode split reads a cache placed by ``cache_specs`` where it lies:
``seq_groups`` names the coordinates that share a sequence split,
``row_block`` the rows each data index computes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import collectives
from repro_torch.launch.op_walk import collective

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"


class PartitionSpec(tuple):
    """Twin of ``jax.sharding.PartitionSpec``: per dim an axis name, a
    tuple of axis names (the dim cut over their product, major to minor), or
    None (not cut); dims past its length are not cut. As there, a tuple of
    one name is that name and an empty tuple is None."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, (tuple, list)):
                return None if not p else p[0] if len(p) == 1 else tuple(p)
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def data_axes(mesh):
    """DP axes: ('pod', 'data') on the multi-pod mesh, ('data',) otherwise."""
    return (POD_AXIS, DATA_AXIS) if POD_AXIS in mesh.shape else (DATA_AXIS,)


def data_ways(mesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in data_axes(mesh))


def _spec(ndim: int, dims: dict) -> P:
    """P(...) with named dims at (possibly negative) positions."""
    axes = [None] * ndim
    for pos, name in dims.items():
        if name is not None:
            axes[int(pos)] = name
    return P(*axes)


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list)) and (
        not isinstance(x, tuple) or isinstance(x, PartitionSpec))


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over dicts, tuples and lists (``PartitionSpec``,
    ``NamedSharding`` and ``ShardedTensor`` are leaves); a path entry is a
    dict key or a sequence index."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if not _is_leaf(tree):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves at the same path of rest)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if not _is_leaf(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _ndim(leaf) -> int:
    return leaf.dim() if isinstance(leaf, (torch.Tensor, ShardedTensor)) \
        else 0


FSDP_THRESHOLD = 5e9  # params; above this, shard params over data too


def param_specs(params, cfg: ArchConfig, mesh, fsdp: Optional[bool] = None):
    """PartitionSpec tree mirroring ``init_params`` output.

    ``fsdp`` (auto: params >= 5B) additionally shards every large matrix over
    the data axes on a dim the model axis doesn't use (ZeRO-3 style)."""
    tp = _axis_size(mesh, MODEL_AXIS)
    kv_ok = cfg.kv_shardable(tp)
    ep = cfg.n_experts > 0 and cfg.n_experts % tp == 0  # EP when E divides
    if fsdp is None:
        fsdp = cfg.n_params() >= FSDP_THRESHOLD
    da = data_axes(mesh)
    dp = data_ways(mesh)

    def _fsdp_dim(leaf, spec: P) -> P:
        """Add data-axis sharding on the largest free divisible dim."""
        nd = _ndim(leaf)
        if not fsdp or nd < 2 or leaf.numel() < 2**22:
            return spec
        axes = list(spec) + [None] * (nd - len(spec))
        cands = sorted(range(nd), key=lambda i: -leaf.shape[i])
        for i in cands:
            if axes[i] is None and leaf.shape[i] % dp == 0 \
                    and leaf.shape[i] >= dp:
                axes[i] = da if len(da) > 1 else da[0]
                return P(*axes)
        return spec

    def rule(path, leaf) -> P:
        names = [k if isinstance(k, str) else f"[{k}]" for k in path]
        key = names[-1]
        nd = _ndim(leaf)
        joined = "/".join(names)
        if cfg.xlstm_pattern and ("mlstm" in names or "slstm" in names):
            return P()  # xlstm-125m: replicate (tiny model, odd head shapes)
        if key in ("w",) and "embed" in names:
            return _spec(nd, {-1: MODEL_AXIS})
        if key == "w" and "lm_head" in names:
            return _spec(nd, {-1: MODEL_AXIS})
        # attention
        if key in ("wq",):
            return _spec(nd, {-1: MODEL_AXIS})
        if key in ("wk", "wv"):
            return _spec(nd, {-1: MODEL_AXIS}) if kv_ok else P()
        if key == "wo" and "attn" in joined:
            return _spec(nd, {-2: MODEL_AXIS})
        if key == "bq":
            return _spec(nd, {-1: MODEL_AXIS})
        if key in ("bk", "bv"):
            return _spec(nd, {-1: MODEL_AXIS}) if kv_ok else P()
        # MoE
        if "moe" in names:
            if key == "router":
                return P()
            if key in ("w1", "w3"):  # [L, E, d, ff]
                return _spec(nd, ({-3: MODEL_AXIS} if ep else {-1: MODEL_AXIS}))
            if key == "w2":          # [L, E, ff, d]
                return _spec(nd, ({-3: MODEL_AXIS} if ep else {-2: MODEL_AXIS}))
        # dense MLP
        if key in ("w1", "w3"):
            return _spec(nd, {-1: MODEL_AXIS})
        if key == "w2":
            return _spec(nd, {-2: MODEL_AXIS})
        # Mamba2
        if key in ("w_z", "w_x", "w_dt"):
            return _spec(nd, {-1: MODEL_AXIS})
        if key in ("w_B", "w_C", "conv_B", "conv_C", "conv_bB", "conv_bC"):
            return P()
        if key in ("conv_x", "conv_bx"):
            return _spec(nd, {-2: MODEL_AXIS} if key == "conv_x"
                         else {-1: MODEL_AXIS})
        if key in ("A_log", "D", "dt_bias"):
            return _spec(nd, {-1: MODEL_AXIS}) if cfg.ssm_heads % tp == 0 else P()
        if key == "norm" and ("mamba" in names):
            return _spec(nd, {-1: MODEL_AXIS}) if cfg.d_inner % tp == 0 else P()
        if key == "out_proj":
            return _spec(nd, {-2: MODEL_AXIS})
        # norms / scalars / anything else: replicate
        return P()

    return tree_map_with_path(
        lambda path, leaf: _fsdp_dim(leaf, rule(path, leaf)), params)


def method_specs(sp, cfg: ArchConfig, mesh):
    """Specs for sparse-method (indexer) params."""
    def rule(path, leaf) -> P:
        key = path[-1] if isinstance(path[-1], str) else f"[{path[-1]}]"
        if key in ("wq_idx", "w_wgt"):
            return _spec(_ndim(leaf), {-1: MODEL_AXIS})
        return P()

    return tree_map_with_path(rule, sp)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Dict[str, P]:
    """Input shardings per (arch, shape)."""
    da = data_axes(mesh)
    dp = data_ways(mesh)
    bdim = da if shape.global_batch % max(dp, 1) == 0 and shape.global_batch >= dp else None
    specs: Dict[str, P] = {}
    if shape.kind == "train":
        specs["tokens"] = P(bdim, None)
        specs["labels"] = P(bdim, None)
    elif shape.kind == "prefill":
        specs["tokens"] = P(bdim, None)
    else:  # decode: one token per sequence
        specs["token"] = P(bdim)
    if cfg.rope_style == "mrope":
        specs["positions3"] = P(None, bdim, None)
    if cfg.frontend == "vision_stub":
        specs["img_embeds"] = P(bdim, None, None)
    return specs


def cache_specs(cache, cfg: ArchConfig, shape: ShapeConfig, mesh):
    """KV cache / state shardings.

    decode_32k: batch on data axes, sequence on model (SP).
    long_500k (batch 1): sequence sharded over (data, model) jointly — every
    chip owns a context slice; the distributed top-k merges across all of
    them."""
    da = data_axes(mesh)
    dp = data_ways(mesh)
    big_batch = shape.global_batch >= dp and shape.global_batch % max(dp, 1) == 0
    bdim = da if big_batch else None
    seq_axes = MODEL_AXIS if big_batch else (da + (MODEL_AXIS,))

    def rule(path, leaf) -> P:
        names = [str(k) for k in path]
        joined = "/".join(names)
        key = names[0] if names else ""   # top-level cache entry name
        nd = _ndim(leaf)
        if key in ("k", "v", "shared_k", "shared_v"):  # [L, B, S, KV, hd]
            return P(None, bdim, seq_axes, None, None)
        if "ssm" in joined:                # [..., B, H, P, N]
            if cfg.ssm_heads % _axis_size(mesh, MODEL_AXIS) == 0:
                return _spec(nd, {-4: bdim, -3: MODEL_AXIS}) if bdim else \
                    _spec(nd, {-3: MODEL_AXIS})
            return _spec(nd, {-4: bdim}) if bdim else P()
        if "conv" in joined:               # [..., B, C, K-1]
            return _spec(nd, {-3: bdim}) if bdim else P()
        if key in ("length", "states"):    # xlstm states: replicate (tiny)
            return P()
        if nd >= 2 and bdim:
            return _spec(nd, {1: bdim})
        return P()

    return tree_map_with_path(rule, cache)


def sparse_cache_specs(sp, cfg: ArchConfig, shape: ShapeConfig, mesh):
    """Specs of a stateful sparse method's ``{"p": indexer weights,
    "kidx_sum": pooled index cache [L, B, n_pages, di]}``: the weights by
    ``method_specs``, the index cache's rows and pages placed as K's rows
    and sequence (the reference's dry run, ``launch/dryrun.py:204-208``)."""
    kspec = cache_specs({"k": sp["kidx_sum"]}, cfg, shape, mesh)["k"]
    return {"p": method_specs(sp["p"], cfg, mesh),
            "kidx_sum": P(None, kspec[1], kspec[2], None)}


def big_batch(mesh, batch: int) -> bool:
    """Whether ``cache_specs`` cuts a decode batch of ``batch`` rows over
    the data axes (decode_32k) rather than the sequence over (data, model)
    jointly (long_500k)."""
    dp = data_ways(mesh)
    return batch >= dp and batch % max(dp, 1) == 0


def seq_groups(mesh, batch: int) -> List[List[int]]:
    """The coordinates that share one sequence split of a decode cache of
    ``batch`` rows, each group in the order its sequence blocks run:
    decode_32k's model groups (rows on the data axes, the sequence on
    ``model``), or long_500k's whole mesh, data-major (the sequence over
    ``data_axes + ("model",)``, raveled as the reference cuts it)."""
    if big_batch(mesh, batch):
        return model_groups(mesh)
    return [[c for g in model_groups(mesh) for c in g]]


def row_block(mesh, batch: int, d: int) -> slice:
    """The rows of a decode batch that data index ``d`` computes: its block
    where the batch is cut over the data axes, else every row (each data
    index then computes them, as GSPMD replicates an uncut batch)."""
    if not big_batch(mesh, batch):
        return slice(0, batch)
    n = batch // data_ways(mesh)
    return slice(d * n, (d + 1) * n)


# ---------------------------------------------------------------------------
# placing tensors on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Twin of ``jax.sharding.NamedSharding``: a mesh and a spec. It names
    each mesh coordinate's slice of a tensor."""
    mesh: object
    spec: PartitionSpec

    def slices(self, shape: Sequence[int]) -> List[tuple]:
        """Per flat mesh coordinate, the tuple of slices it holds of a
        tensor of ``shape``. A dim cut over axes (a, b) gives coordinate
        (i_a, i_b) block i_a * |b| + i_b. An uneven cut raises, as jit's
        in_shardings do."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dims than {shape}")
        names = self.mesh.axis_names
        dims = []
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            ways = math.prod(self.mesh.shape[a] for a in axes)
            if shape[d] % ways:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"{ways} ways ({self.spec})")
            dims.append((d, [names.index(a) for a in axes],
                         [self.mesh.shape[a] for a in axes], shape[d] // ways))
        out = []
        for idx in np.ndindex(self.mesh.devices.shape):
            sl = [slice(None)] * len(shape)
            for d, pos, sizes, block in dims:
                k = 0
                for p, n in zip(pos, sizes):
                    k = k * n + idx[p]
                sl[d] = slice(k * block, (k + 1) * block)
            out.append(tuple(sl))
        return out


class ShardedTensor:
    """A tensor placed on a mesh: its global ``shape`` and ``dtype``, its
    ``sharding``, and ``shards`` (one owned tensor per flat mesh
    coordinate, that coordinate's slice, on its device); ``slices`` names
    each shard's place in the global tensor."""

    def __init__(self, shards: List[torch.Tensor], sharding: NamedSharding,
                 shape, dtype):
        self.shards = shards
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.slices = sharding.slices(self.shape)
        self._blocks = [tuple((s.start, s.stop) for s in sl)
                        for sl in self.slices]

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def full(self, device=None, order: Optional[Sequence[int]] = None
             ) -> torch.Tensor:
        """The global tensor on ``device`` (default: shard 0's), each block
        copied from the first coordinate in ``order`` (default: coordinate
        order) that holds it."""
        dev = device if device is not None else self.shards[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        seen = set()
        with collective("all-gather"):
            for i in (order if order is not None
                      else range(len(self.shards))):
                if self._blocks[i] not in seen:
                    seen.add(self._blocks[i])
                    out[self.slices[i]].copy_(self.shards[i])
        if len(seen) != len(set(self._blocks)):
            raise ValueError("gather: the order leaves blocks uncovered")
        return out

    def __repr__(self):
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec})")


def make_shardings(tree_specs, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), tree_specs)


def _place(x, s: NamedSharding):
    if isinstance(x, ShardedTensor):
        x = x.full()
    if not isinstance(x, torch.Tensor):
        return x
    shards = [x.detach()[sl].to(s.mesh.device(i), copy=True).contiguous()
              for i, sl in enumerate(s.slices(x.shape))]
    return ShardedTensor(shards, s, x.shape, x.dtype)


def device_put(tree, shardings):
    """Twin of ``jax.device_put`` onto shardings: every tensor leaf as a
    ``ShardedTensor`` (an owned clone of each coordinate's slice on its
    device); ``shardings`` is one ``NamedSharding`` for every leaf or a tree
    of them. A sharded leaf is gathered and placed anew (resharding)."""
    if isinstance(shardings, NamedSharding):
        return tree_map(lambda x: _place(x, shardings), tree)
    return tree_map(_place, tree, shardings)


def gather(tree, device=None):
    """Twin of ``np.asarray`` of a sharded tree: each ``ShardedTensor`` as
    its full tensor on ``device`` (default: its first shard's); other
    leaves moved to ``device`` if given."""
    def one(x):
        if isinstance(x, ShardedTensor):
            return x.full(device)
        if isinstance(x, torch.Tensor) and device is not None:
            return x.to(device)
        return x

    return tree_map(one, tree)


def zeros_like(x, dtype=None):
    """Zeros of ``x``'s shape (and placement, for a ``ShardedTensor``)."""
    if isinstance(x, ShardedTensor):
        dt = dtype or x.dtype
        return ShardedTensor([torch.zeros(s.shape, dtype=dt, device=s.device)
                              for s in x.shards], x.sharding, x.shape, dt)
    return torch.zeros(x.shape, dtype=dtype or x.dtype, device=x.device)


@torch.no_grad()
def copy_(dst, src: torch.Tensor):
    """Write the global tensor ``src`` into ``dst`` in place: into every
    shard of a ``ShardedTensor``, its own slice."""
    if isinstance(dst, ShardedTensor):
        for shard, sl in zip(dst.shards, dst.slices):
            shard.copy_(src[sl])
    else:
        dst.copy_(src)


# ---------------------------------------------------------------------------
# the tensor-parallel split's views of a placed tree
# ---------------------------------------------------------------------------


def _present(mesh, axes) -> List[str]:
    return [a for a in axes if a in mesh.shape]


def model_groups(mesh) -> List[List[int]]:
    """Per data index (the data axes raveled major to minor), its mesh
    coordinates in model-index order: the group one data index's
    tensor-parallel step runs over."""
    axes = _present(mesh, data_axes(mesh))
    return mesh.groups(axes) if axes else [list(range(mesh.size))]


def data_groups(mesh) -> List[List[int]]:
    """Per model index, its mesh coordinates in data-index order: the group
    a gradient slice is reduced over, and an FSDP leaf gathered over."""
    if MODEL_AXIS not in mesh.shape:
        return [list(range(mesh.size))]
    return mesh.groups((MODEL_AXIS,))


def local(tree, i: int):
    """The tree as mesh coordinate ``i`` holds it: each ``ShardedTensor`` as
    its shard there."""
    return tree_map(lambda x: x.shards[i] if isinstance(x, ShardedTensor)
                    else x, tree)


def cut_dim(x, axes) -> Optional[int]:
    """The dim of a placed leaf cut over any of the mesh axes ``axes``, or
    None."""
    if not isinstance(x, ShardedTensor):
        return None
    for d, entry in enumerate(x.sharding.spec):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if set(axes) & set(names):
            return d
    return None


def fsdp_dim(x) -> Optional[int]:
    """The dim of a placed leaf cut over the data axes (FSDP), or None."""
    return (cut_dim(x, data_axes(x.sharding.mesh))
            if isinstance(x, ShardedTensor) else None)


@dataclasses.dataclass
class DataSlices:
    """One model shard's view of an FSDP leaf: its data group's shards
    (``parts``, in data-index order, each on its coordinate's device), cut
    on ``dim``. ``materialize`` gathers it where it is used."""
    parts: List[torch.Tensor]
    dim: int

    def layers(self, n: int) -> List["DataSlices"]:
        """Per layer of a stacked leaf, the parts' slices of that layer
        (``torch.unbind``: under autograd their gradients meet in one stack
        per part)."""
        if self.dim == 0:
            raise ValueError("an FSDP leaf cut over the data axes on its "
                             "layer dim cannot be gathered one layer at a "
                             "time")
        per = [torch.unbind(p, 0) for p in self.parts]
        return [DataSlices([u[i] for u in per], self.dim - 1)
                for i in range(n)]


def group_view(params, mesh, d: int) -> List:
    """Data index ``d``'s model group's local trees, in model-index order:
    each ``ShardedTensor`` leaf as that coordinate's shard, or, for an FSDP
    leaf, a ``DataSlices`` of the shards of the coordinates that share its
    model index."""
    by_model = {c: g for g in data_groups(mesh) for c in g}

    def view(x, own, c):
        if fsdp_dim(x) is None:
            return own
        return DataSlices([x.shards[j] for j in by_model[c]], fsdp_dim(x))

    return [tree_map(lambda x, own, c=c: view(x, own, c), params,
                     local(params, c)) for c in model_groups(mesh)[d]]


def gather_layer(parts: Sequence[torch.Tensor], dim: int, device
                 ) -> torch.Tensor:
    """One layer's slice of an FSDP leaf gathered over its data group onto
    ``device``: the parts concatenated on ``dim`` (an all-gather; backward:
    each part's slice of the gradient, sent back to its coordinate)."""
    return collectives.group_all_gather(list(parts), dim, [device])[0]


def materialize(tree, device):
    """The tree with each ``DataSlices`` gathered onto ``device``."""
    return tree_map(lambda x: gather_layer(x.parts, x.dim, device)
                    if isinstance(x, DataSlices) else x, tree)
