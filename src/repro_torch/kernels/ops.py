"""Public kernel API (twin of ``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel; a CPU tensor runs the
kernel's plain version. ``use_kernels(False)`` routes every op through the
``ref`` oracles instead, which is the only way to run a plain version on the
card (the kernel-vs-plain comparison of ``chip_smoke.py``). There is no
fallback from a kernel that fails: it raises.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import bm25_topk as _bm
from repro_torch.kernels import flash_attention as _fa
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
    "bm25_topk_candidates": _bm.bm25_topk_candidates,
    "flash_attention": _fa.flash_attention,
}


def use_kernels(flag: bool) -> None:
    _STATE["kernels"] = flag


def kernels_enabled() -> bool:
    return _STATE["kernels"]


def launch_counts() -> Dict[str, int]:
    return {n: fn.launches for n, fn in KERNELS.items()}


def add_launches(counts: Dict[str, int], sign: int = 1) -> None:
    """Add (``sign=-1``: take back) launches that did not pass through the
    wrappers: the kernels of a CUDA graph's replay, the launches a capture
    recorded without running them (``serving.fused.GraphRunner``)."""
    for n, c in counts.items():
        KERNELS[n].launches += sign * c


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for route in _fa.ROUTE_LAUNCHES:
        _fa.ROUTE_LAUNCHES[route] = 0


def flash_route_counts() -> Dict[str, int]:
    """``flash_attention``'s launches by route (tensor cores, CUDA cores)."""
    return dict(_fa.ROUTE_LAUNCHES)


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


def flash_attention(q, k, v, *, window: int = 0, bq: int = 512,
                    bk: int = 512):
    """Causal GQA attention, differentiable. ``bq`` / ``bk`` are the
    reference's tile sizes, kept for its signature: the CUDA kernel tiles
    at 64 x 64 whatever they are, and the result does not depend on them."""
    if not _STATE["kernels"]:
        return ref.flash_attention(q, k, v, window=window or None)
    return _fa.FlashAttention.apply(q, k, v, window)


def page_minmax(k_cache, *, page_size: int = 64):
    if not _STATE["kernels"]:
        return ref.page_minmax(k_cache, page_size)
    return _pp.page_minmax(k_cache, page_size=page_size)


def bm25_topk(tf, doc_len, idf, k: int, *, block: int = 4096, c: int = 0,
              k1: float = 1.5, b: float = 0.75, avgdl: float = 100.0,
              valid=None):
    """Fused BM25 score + top-k. ``valid`` (an int or a 0-d int32 tensor)
    restricts scoring to the first ``valid`` documents, so the serving
    corpus store passes its live count; None scores all D docs.

    Pads D to a power-of-two block multiple (tf with 0, doc_len with 1.0);
    k is clamped to D.
    """
    B, D, T = tf.shape
    if not _STATE["kernels"]:
        if valid is None:
            return ref.bm25_topk(tf, doc_len, idf, k, k1=k1, b=b, avgdl=avgdl)
        scores = ref.bm25_scores(tf, doc_len, idf, k1=k1, b=b, avgdl=avgdl)
        scores = torch.where(torch.arange(D, device=tf.device)[None] < valid,
                             scores, torch.full_like(scores, float("-inf")))
        return ref.topk_stable(scores, min(k, D))
    blk = _pow2_block(max(D, 2), block)
    pad = (-D) % blk
    if pad:
        tf = F.pad(tf, (0, 0, 0, pad))
        doc_len = F.pad(doc_len, (0, pad), value=1.0)
    c = c or min(k, blk)
    vals, idx = _bm.bm25_topk_candidates(
        tf.float(), doc_len.float(), idf.float(), block=blk, c=c, k1=k1, b=b,
        avgdl=avgdl, valid=D if valid is None else valid)
    return _rt.merge_candidates(vals, idx, min(k, D))
