"""Plain-torch bitonic compare-exchange network (twin of
``repro.kernels.bitonic``).

The CUDA top-c kernels (``csrc/relevancy_topk.cu``, ``csrc/bm25_topk.cu``)
run the same network only on a warp's 128 pairs, in registers and shuffles
(``csrc/topk.cuh`` ``warp_sort_desc``), and merge the warps' and CTAs' runs
by rank; this module is the reference's network and the tests' oracle. The
compare rule is a strict total order, key descending then payload
ascending, so exchanges stay consistent and no payload is duplicated or
dropped.
"""
from __future__ import annotations

import torch


def _partner_swap(x: torch.Tensor, j: int) -> torch.Tensor:
    """Return y with y[..., i] = x[..., i ^ j] (j a power of two)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    y = x.reshape(lead + (n // (2 * j), 2, j)).flip(-2)
    return y.reshape(lead + (n,))


def bitonic_sort_desc(keys: torch.Tensor, vals: torch.Tensor):
    """Sort descending along the last axis; ties by ascending ``vals``.

    Shapes [..., n] with n a power of two. Returns (keys_sorted, vals_sorted).
    """
    n = keys.shape[-1]
    if n & (n - 1):
        raise ValueError(f"bitonic sort needs power-of-two n, got {n}")
    i = torch.arange(n, device=keys.device)
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            pk = _partner_swap(keys, j)
            pv = _partner_swap(vals, j)
            # runs with (i & k) == 0 sort descending; in such a run the lower
            # index of a pair takes the larger element
            take_max = ((i & k) == 0) == ((i & j) == 0)
            self_gt = (keys > pk) | ((keys == pk) & (vals < pv))
            sel_self = torch.where(take_max, self_gt, ~self_gt)
            keys = torch.where(sel_self, keys, pk)
            vals = torch.where(sel_self, vals, pv)
            j //= 2
        k *= 2
    return keys, vals


def bitonic_topk(keys: torch.Tensor, vals: torch.Tensor, k: int):
    """Top-k by full descending sort + slice (exact when k <= n)."""
    ks, vs = bitonic_sort_desc(keys, vals)
    return ks[..., :k], vs[..., :k]
