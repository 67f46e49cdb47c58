"""AdamW with a cosine schedule, global-norm clipping, and fp32 moments over
bf16 params (twin of ``repro.train.optimizer``).

Parameters, gradients and moments are nested dicts of tensors with the
parameters' nesting; leaves are visited in sorted-key order, as
``jax.tree.leaves`` visits a dict. The step arithmetic is the reference's,
in fp32. Unlike the reference, which returns new arrays, ``adamw_update``
writes the parameters and the moments IN PLACE under ``torch.no_grad()``
(one model's worth of fp32 temporaries at most, one leaf at a time) and
returns the same tensors.

Sharded parameters (``distributed.sharding.ShardedTensor`` leaves) get
moments sharded like them; each mesh coordinate updates its own slice of
the parameter and of the moments from its slice of the gradient (its shard
of a gradient placed like the parameter, the tensor-parallel step's, or its
slice of a full gradient, the gathered step's). The clip's norm is the
single-device norm: of the full gradients, or of each distinct block of the
placed ones once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardedTensor, zeros_like
from repro_torch.launch.op_walk import collective


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: int
    m: Any
    v: Any
    residual: Any  # gradient-compression error feedback (or None)


def leaves(tree):
    """The tensors of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params, compress: str = "none") -> OptState:
    """Zero fp32 moments (sharded like sharded parameters); for int8
    compression a zero fp32 residual of the full shapes, on the device the
    sharded step reduces the gradients on (the first coordinate's)."""
    zeros = lambda p: zeros_like(p, torch.float32)
    full_zeros = lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.shards[0].device
        if isinstance(p, ShardedTensor) else p.device)
    residual = tree_map(full_zeros, params) if compress == "int8" else None
    return OptState(step=0, m=tree_map(zeros, params),
                    v=tree_map(zeros, params), residual=residual)


def schedule(oc: OptConfig, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of ``lr``; fp32
    arithmetic, as the reference's."""
    f = np.float32
    s = f(step)
    warm = np.minimum(s / f(max(oc.warmup_steps, 1)), f(1.0))
    prog = np.clip((s - f(oc.warmup_steps))
                   / f(max(oc.total_steps - oc.warmup_steps, 1)), f(0), f(1))
    cos = f(0.5) * (f(1) + np.cos(f(math.pi) * prog))
    return float(f(oc.lr) * warm
                 * (f(oc.min_lr_frac) + f(1 - oc.min_lr_frac) * cos))


def _sq_sum(g) -> torch.Tensor:
    """fp32 sum of squares of a leaf: of a placed one, each distinct block
    once (in coordinate order), summed on its first shard's device."""
    if not isinstance(g, ShardedTensor):
        return torch.sum(g.float() ** 2)
    seen, total = set(), None
    dev = g.shards[0].device
    with collective("all-reduce"):
        for shard, sl in zip(g.shards, g.slices):
            block = tuple((s.start, s.stop) for s in sl)
            if block in seen:
                continue
            seen.add(block)
            sq = torch.sum(shard.float() ** 2).to(dev)
            total = sq if total is None else total + sq
    return total


def global_norm(tree) -> torch.Tensor:
    """fp32 L2 norm over every leaf (a 0-d tensor on the leaves' device; a
    placed tree's: on its first coordinate's)."""
    return torch.sqrt(sum(_sq_sum(g) for g in leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: OptState, params, oc: OptConfig):
    """Returns (params, new_state, stats): ``params`` and the moments are
    updated in place. stats: {"lr": float, "grad_norm": 0-d tensor}."""
    step = state.step + 1
    lr = schedule(oc, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / (gnorm + 1e-9), max=1.0)
    f = np.float32
    bc1 = float(f(1) - f(oc.b1) ** f(step))
    bc2 = float(f(1) - f(oc.b2) ** f(step))

    scales = {}

    def scale_on(dev):
        if dev not in scales:
            with collective("all-reduce"):
                scales[dev] = scale.to(dev)
        return scales[dev]

    def upd(g, m, v, p, decay: bool):
        g = g.float() * scale_on(g.device)
        m.mul_(oc.b1).add_((1 - oc.b1) * g)
        v.mul_(oc.b2).add_((1 - oc.b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
        if decay:  # decoupled weight decay on matrices only
            delta += oc.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          leaves(params)):
        if isinstance(p, ShardedTensor):
            for i, sl in enumerate(p.slices):
                gi = (g.shards[i] if isinstance(g, ShardedTensor)
                      else g[sl].to(p.shards[i].device))
                upd(gi, m.shards[i], v.shards[i], p.shards[i], p.dim() >= 2)
        else:
            upd(g, m, v, p, p.dim() >= 2)
    stats = {"lr": lr, "grad_norm": gnorm}
    return params, state._replace(step=step), stats
