"""GPipe-style pipeline parallelism over the 'pod' axis (twin of
``repro.distributed.pipeline_parallel``).

At multi-pod scale the cross-pod links are the thin pipe; PP turns them into
point-to-point boundary-activation transfers instead of full gradient
all-reduces. The schedule is classic GPipe: M microbatches flow through
``n_stages`` stage groups; bubble fraction (n_stages-1)/(M + n_stages - 1).

The reference's schedule, tick for tick: each stage owns a layer-contiguous
slice of the (stacked) layer params; over M + n_stages - 1 ticks every stage
runs every tick, an inactive stage's output is zeroed, and boundary
activations move one stage a tick (``collectives.ring_shift``, the twin of
``lax.ppermute``). One process drives the stages in turn; on a mesh whose
pod entries are one card they run there one after another.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import ShardedTensor, tree_map


def gpipe_forward(layer_group_fn: Callable, mesh, axis: str = "pod"):
    """Build fn(stage_params_stacked, x_microbatches) -> y_microbatches.

    ``layer_group_fn(stage_params, x) -> x``. ``stage_params_stacked``:
    leaves with leading dim n_stages = ``mesh.shape[axis]``; stage s takes
    slice s on the device of pod index s (from its shard when the leaf is a
    ``ShardedTensor`` cut over ``axis``). ``x_microbatches`` [M, mb, ...];
    the output, from the LAST stage, lands on its device."""
    n_stages = mesh.shape[axis]
    groups = mesh.groups((axis,))
    devs = [mesh.device(g[0]) for g in groups]

    def stage_slice(a, s):
        if isinstance(a, ShardedTensor):
            return a.shards[groups[s][0]][0]
        return a[s].to(devs[s])

    def fn(stage_params, xs: torch.Tensor) -> torch.Tensor:
        sps = [tree_map(lambda a: stage_slice(a, s), stage_params)
               for s in range(n_stages)]
        M = xs.shape[0]
        bufs = [torch.zeros_like(xs, device=d) for d in devs]
        inflight = [torch.zeros_like(xs[0], device=d) for d in devs]
        for t in range(M + n_stages - 1):
            ys = []
            for s in range(n_stages):
                mb = t - s
                x_in = xs[min(max(t, 0), M - 1)].to(devs[0]) if s == 0 \
                    else inflight[s]
                y = layer_group_fn(sps[s], x_in)
                if 0 <= mb < M:
                    bufs[s][mb] = y
                else:
                    y = torch.zeros_like(y)
                ys.append(y)
            inflight = collectives.ring_shift(ys)
        return bufs[-1].to(xs.device)

    return fn


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
