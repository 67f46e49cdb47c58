"""Fused Compute-Relevancy + Retrieval (twin of ``repro.kernels.relevancy_topk``).

Per key block: multi-head inner product against the compressed index keys,
head-weighted ReLU reduction, then an exact top-c of the block, so only
(c values, c indices) per block leave the kernel. ``merge_candidates`` then
takes the global top-k of the nb * c candidates; the result is exact when
c >= min(k, block).

``relevancy_topk_candidates`` launches the CUDA kernel
(``csrc/relevancy_topk.cu``) for CUDA tensors and runs
``relevancy_topk_candidates_plain`` for CPU tensors; it never falls back from
one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def _check_args(q, keys, weights, block, c):
    B, S, dk = keys.shape
    if q.shape[0] != B or q.shape[2] != dk or weights.shape != q.shape[:2]:
        raise ValueError(f"shapes q {tuple(q.shape)} keys {tuple(keys.shape)} "
                         f"weights {tuple(weights.shape)} do not agree")
    block = min(block, S)
    if S % block:
        raise ValueError(f"S={S} is not a multiple of block={block}")
    c = min(c or block, block)
    return B, S, dk, block, c


def relevancy_topk_candidates_plain(q, keys, weights, *, block: int = 2048,
                                    c: int = 0, valid_len: int = 0):
    """Plain-torch version: per-block candidates (vals [B,nb,c] fp32,
    idx [B,nb,c] int32), each block sorted by (value desc, index asc)."""
    B, S, _, block, c = _check_args(q, keys, weights, block, c)
    nb = S // block
    valid_len = valid_len or S
    scores = ref.relevancy_scores(q, keys, weights)
    pos = torch.arange(S, device=keys.device)
    scores = torch.where(pos < valid_len, scores,
                         torch.full_like(scores, float("-inf")))
    vals, within = ref.topk_stable(scores.reshape(B, nb, block), c)
    base = (torch.arange(nb, device=keys.device, dtype=torch.int32)
            * block)[None, :, None]
    return vals, within + base


def relevancy_topk_candidates(q, keys, weights, *, block: int = 2048,
                              c: int = 0, valid_len: int = 0):
    """Per-block candidates: (vals [B, nb, c] fp32, idx [B, nb, c] int32).

    q [B,Hq,dk] and keys [B,S,dk] share one dtype (fp32 or bf16); weights
    [B,Hq]. ``block`` must be a power of two dividing S (``ops`` pads);
    c = 0 -> block; valid_len = 0 -> S (keys at or past it score -inf).
    """
    if not keys.is_cuda:
        return relevancy_topk_candidates_plain(q, keys, weights, block=block,
                                               c=c, valid_len=valid_len)
    B, S, dk, block, c = _check_args(q, keys, weights, block, c)
    if block & (block - 1):
        raise ValueError(f"block={block} must be a power of two")
    if q.dtype != keys.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q/keys must share fp32 or bf16, got {q.dtype}/"
                        f"{keys.dtype}")
    if not (q.is_cuda and weights.is_cuda and q.device == keys.device):
        raise ValueError("q, keys and weights must be on one CUDA device")
    q, keys = q.contiguous(), keys.contiguous()
    weights = weights.float().contiguous()
    nb = S // block
    vals = torch.empty((B, nb, c), dtype=torch.float32, device=keys.device)
    idx = torch.empty((B, nb, c), dtype=torch.int32, device=keys.device)
    lib = _build.load("relevancy_topk")
    fn = lib.relevancy_topk_candidates_cuda
    fn.restype = _I
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = fn(q.data_ptr(), keys.data_ptr(), weights.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), B, q.shape[1], dk, S, block, c,
             valid_len or S, int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "relevancy_topk_candidates")
    relevancy_topk_candidates.launches += 1
    return vals, idx


relevancy_topk_candidates.launches = 0


def merge_candidates(vals, idx, k: int):
    """Global merge: [B, nb, c] -> top-k over all candidates. A stable sort
    keeps equal values in candidate order (block, then index ascending),
    which is the reference's ``lax.top_k`` tie order."""
    B = vals.shape[0]
    top_v, pos = ref.topk_stable(vals.reshape(B, -1), k)
    return top_v, torch.gather(idx.reshape(B, -1), 1, pos.long())
