"""Carry a parameter tree of the JAX package over to the port.

``from_jax_params`` takes the tree as **numpy arrays** (``jax.tree.map(
np.asarray, params)`` on the JAX side), so this module imports neither JAX
nor ``repro``. Layer-stacked ``[L, ...]`` leaves stay stacked, dead-head
padding is kept as it is, and bf16 leaves are carried bit for bit: their
bytes are viewed as uint16 and then as ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16 numpy dtype
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def from_jax_params(tree, device="cuda"):
    """Nested dict of numpy arrays -> the same nesting of torch tensors on
    ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_jax_params(v, dev) for k, v in tree.items()}
    return _leaf(tree, dev)
