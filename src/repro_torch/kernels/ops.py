"""Public kernel API (twin of ``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
kernel's plain version. ``use_kernels(False)`` routes every op through the
``ref`` oracles instead, which is the only way to run a plain version on the
card (the kernel-vs-plain comparison of ``chip_smoke.py``). There is no
fallback from a kernel that fails: it raises.
"""
from __future__ import annotations

from typing import Dict

import torch.nn.functional as F

from repro_torch.kernels import page_pool as _pp
from repro_torch.kernels import ref
from repro_torch.kernels import relevancy_topk as _rt
from repro_torch.kernels import sparse_decode_attention as _sda

_STATE = {"kernels": True}

#: the wrappers whose launches are counted, by kernel name
KERNELS = {
    "relevancy_topk_candidates": _rt.relevancy_topk_candidates,
    "paged_decode_attention": _sda.paged_decode_attention,
    "page_minmax": _pp.page_minmax,
}


def use_kernels(flag: bool) -> None:
    _STATE["kernels"] = flag


def kernels_enabled() -> bool:
    return _STATE["kernels"]


def launch_counts() -> Dict[str, int]:
    return {n: fn.launches for n, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _pow2_block(n: int, want: int) -> int:
    """Largest power-of-two block <= want that is also >= 2."""
    b = 1
    while b * 2 <= min(n, want):
        b *= 2
    return max(b, 2)


def relevancy_topk(q, keys, weights, k: int, *, block: int = 2048,
                   c: int = 0):
    """Fused score + top-k. Exact when c = 0 (c -> min(block, S)).

    Pads the key axis to a power-of-two block multiple (masked to -inf via
    valid_len), so any context length is accepted; k is clamped to S.
    """
    if not _STATE["kernels"]:
        return ref.relevancy_topk(q, keys, weights, k)
    B, S, dk = keys.shape
    blk = _pow2_block(max(S, 2), block)
    pad = (-S) % blk
    if pad:
        keys = F.pad(keys, (0, 0, 0, pad))
    if q.dtype != keys.dtype:   # the kernel takes one dtype for both
        q, keys = q.float(), keys.float()
    vals, idx = _rt.relevancy_topk_candidates(q, keys, weights, block=blk,
                                              c=c, valid_len=S)
    return _rt.merge_candidates(vals, idx, min(k, S))


def paged_decode_attention(q, k_cache, v_cache, page_ids, length, *,
                           page_size: int = 64):
    if not _STATE["kernels"]:
        return ref.paged_decode_attention(q, k_cache, v_cache, page_ids,
                                          page_size, length)
    return _sda.paged_decode_attention(q, k_cache, v_cache, page_ids, length,
                                       page_size=page_size)


lse_merge = _sda.lse_merge


def page_minmax(k_cache, *, page_size: int = 64):
    if not _STATE["kernels"]:
        return ref.page_minmax(k_cache, page_size)
    return _pp.page_minmax(k_cache, page_size=page_size)
