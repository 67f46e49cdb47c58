"""Placement policy (twin of ``repro.core.placement``): the dynamic fallback
window of the paper (§5.2 / Appendix F).

The reference decides the dense/sparse branch inside its jitted decode step
with a traced ``lax.cond``. The port's engine knows every slot's length on
the host, so it decides there, with the same predicate and no device sync.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import MemoryConfig


def in_sparse_window(context: int, mem: MemoryConfig) -> bool:
    """Host-side dynamic-fallback window: below min_context the pipeline's
    overhead dominates; above fallback_context the compressed index spills."""
    if mem.method in ("none", "ttt"):
        return False
    return mem.min_context <= context <= mem.fallback_context


def use_sparse(length, mem: MemoryConfig) -> bool:
    """Host twin of ``repro.core.placement.traced_use_sparse``: take the
    sparse pipeline iff the max context over slots sits inside
    [min_context, fallback_context]. ``length`` is a scalar or per-slot
    vector (pooled decode passes the masked lengths + 1)."""
    lmax = int(np.max(np.asarray(length)))
    return mem.min_context <= lmax <= mem.fallback_context
