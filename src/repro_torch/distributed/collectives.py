"""Distributed-optimization helpers (twin of
``repro.distributed.collectives``): compressed gradient sync with error
feedback, the ring-collective cost formulas, and the in-process collectives
the sharded train step and GPipe run on.

Cross-pod DP links are the scarcest bandwidth at scale; compressing the
gradient all-reduce (bf16 or int8 + error feedback) cuts the collective term
proportionally while error feedback keeps convergence unbiased in the long
run (Karimireddy et al., arXiv:1901.09847).

The in-process collectives take one tensor per participant (each on its
participant's device) and reduce in participant order, so a run is
bit-reproducible. The all-gather over a mesh axis is
``sharding.ShardedTensor.full``. Each labels its copies between devices
for an op walk (``launch.op_walk.collective``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core.placement import NVLINK_BW
from repro_torch.launch.op_walk import collective


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization -> (q, scale); rounds half to
    even, as ``jnp.round``."""
    scale = g.abs().max().float() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_grads_with_feedback(grads, residual, mode: str = "bf16"):
    """Lossy compression of a gradient tree (nested dicts) with error
    feedback -> (decompressed grads in the gradients' dtype, new fp32
    residual). mode: 'none' | 'bf16' | 'int8'. ``residual=None`` starts from
    zeros."""
    if mode == "none":
        return grads, residual
    if mode not in ("bf16", "int8"):
        raise ValueError(f"compress mode {mode!r}: none | bf16 | int8")
    if residual is None:
        residual = _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)

    def one(g, r):
        gf = g.float() + r
        if mode == "bf16":
            back = gf.to(torch.bfloat16).float()
        else:
            back = decompress_int8(*compress_int8(gf))
        return back.to(g.dtype), gf - back

    pairs = _map(one, grads, residual)
    return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and the same paths of
    ``rest``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# analytic collective costs (ring algorithms) — napkin-math utilities
# ---------------------------------------------------------------------------


def all_reduce_seconds(bytes_per_dev: float, n: int, links: float = NVLINK_BW):
    """Ring all-reduce: 2 (n-1)/n * bytes over the slowest link."""
    return 2.0 * (n - 1) / max(n, 1) * bytes_per_dev / links


def all_gather_seconds(bytes_per_dev: float, n: int, links: float = NVLINK_BW):
    return (n - 1) / max(n, 1) * bytes_per_dev * n / links


def reduce_scatter_seconds(bytes_per_dev: float, n: int,
                           links: float = NVLINK_BW):
    return (n - 1) / max(n, 1) * bytes_per_dev / links


# ---------------------------------------------------------------------------
# in-process collectives over one mesh axis
# ---------------------------------------------------------------------------


def all_reduce(xs: Sequence[torch.Tensor], op: str = "sum") -> torch.Tensor:
    """Sum (or mean) of the participants' tensors on the first participant's
    device: accumulated in fp32 in participant order, then cast to the
    inputs' dtype."""
    if op not in ("sum", "mean"):
        raise ValueError(f"all_reduce op {op!r}: sum | mean")
    acc = xs[0].to(torch.float32, copy=True)
    with collective("all-reduce"):
        for x in xs[1:]:
            acc += x.to(acc.device, torch.float32)
    if op == "mean":
        acc /= len(xs)
    return acc.to(xs[0].dtype)


def ring_shift(xs: Sequence[torch.Tensor], shift: int = 1
               ) -> List[torch.Tensor]:
    """Twin of ``lax.ppermute`` with pairs (i, (i + shift) % n): participant
    (i + shift) % n receives participant i's tensor, on its own device."""
    n = len(xs)
    out = [None] * n
    with collective("collective-permute"):
        for i, x in enumerate(xs):
            j = (i + shift) % n
            out[j] = x.to(xs[j].device)
    return out
