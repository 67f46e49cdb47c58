"""Fused BM25 scoring + top-k over gathered term columns (twin of
``repro.kernels.bm25_topk``), the RAG relevancy + retrieve stages.

BM25's irregular per-term lookups stay outside the kernel: the caller
gathers the query's term-frequency columns into a dense [B, D, T] panel.
Per block of docs the kernel scores every doc and keeps the block's exact
top-c, so only (c values, c indices) per block leave it;
``relevancy_topk.merge_candidates`` then takes the global top-k.

The live document count ``valid`` is a runtime value (a Python int or a
0-d int32 tensor on the panel's device, read by the kernel itself), never a
compile-time one: the serving corpus grows between queries. Docs at or past
it score -inf; 0 means D.

``bm25_topk_candidates`` launches the CUDA kernel (``csrc/bm25_topk.cu``)
for CUDA tensors and runs ``bm25_topk_candidates_plain`` for CPU tensors; it
never falls back from one to the other. The kernel runs each block as a
thread-block cluster of ``relevancy_topk.split_plan`` CTAs, as the relevancy
kernel does; ``bm25_topk_candidates_split`` is that schedule in plain torch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import ref
from repro_torch.kernels.relevancy_topk import split_plan, split_topk
from repro_torch.kernels.sparse_decode_attention import _aligned16, _sm_count

#: threads of the BM25 kernel's CTA (``kThreads``)
THREADS = 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _check_args(tf, doc_len, idf, block, c):
    B, D, T = tf.shape
    if tuple(doc_len.shape) != (B, D) or tuple(idf.shape) != (B, T):
        raise ValueError(f"shapes tf {tuple(tf.shape)} doc_len "
                         f"{tuple(doc_len.shape)} idf {tuple(idf.shape)} do "
                         f"not agree")
    block = min(block, D)
    if D % block:
        raise ValueError(f"D={D} is not a multiple of block={block}")
    return B, D, T, block, min(c, block)


def _live_count(valid, D: int):
    """The live count as the kernel reads it: ``valid``, or D where it is
    0 (an int, or a tensor when ``valid`` is one)."""
    if isinstance(valid, torch.Tensor):
        return torch.where(valid > 0, valid, torch.full_like(valid, D))
    return int(valid) if int(valid) > 0 else D


def bm25_topk_candidates_plain(tf, doc_len, idf, *, block: int = 4096,
                               c: int = 64, k1: float = 1.5, b: float = 0.75,
                               avgdl: float = 100.0, valid=0):
    """Plain-torch version: per-block candidates (vals [B,nb,c] fp32,
    idx [B,nb,c] int32), each block sorted by (value desc, index asc)."""
    B, D, _, block, c = _check_args(tf, doc_len, idf, block, c)
    nb = D // block
    scores = _masked_scores(tf, doc_len, idf, k1, b, avgdl, valid)
    vals, within = ref.topk_stable(scores.reshape(B, nb, block), c)
    base = (torch.arange(nb, device=tf.device, dtype=torch.int32)
            * block)[None, :, None]
    return vals, within + base


def _masked_scores(tf, doc_len, idf, k1, b, avgdl, valid):
    D = tf.shape[1]
    scores = ref.bm25_scores(tf, doc_len, idf, k1=k1, b=b, avgdl=avgdl)
    pos = torch.arange(D, device=tf.device)
    return torch.where(pos < _live_count(valid, D), scores,
                       torch.full_like(scores, float("-inf")))


def bm25_topk_candidates_split(tf, doc_len, idf, *, block: int = 4096,
                               c: int = 64, k1: float = 1.5, b: float = 0.75,
                               avgdl: float = 100.0, valid=0, n: int = 0):
    """The kernel's schedule (``relevancy_topk.split_topk``) in plain torch,
    on the plain version's scores: clusters of ``n`` CTAs a block (0:
    ``split_plan`` on a 132-SM card). Same result as
    ``bm25_topk_candidates_plain``."""
    B, D, _, block, c = _check_args(tf, doc_len, idf, block, c)
    n = n or split_plan(B, D // block, block, c)
    return split_topk(_masked_scores(tf, doc_len, idf, k1, b, avgdl, valid),
                      block, c, n, THREADS)


def cost(tf, doc_len, idf, *, block: int = 4096, c: int = 64,
         valid=0) -> _cost.KernelCost:
    """The work of one candidates call. Per live doc: 4 operations for the
    length norm, 5 per term (multiply, add, divide, fused multiply-add),
    one compare to select it, on the fp32 cores; the kernel reads tf and
    doc_len of the live docs only (a doc at or past the live count scores
    -inf unread), idf, and writes the candidates. A tensor ``valid`` (read
    by the kernel itself) counts every doc: a walk counts shapes only, and
    the kernel phase passes the store's live count as an int."""
    B, D, T, block, c = _check_args(tf, doc_len, idf, block, c)
    nd = D
    if not isinstance(valid, torch.Tensor) and int(valid) > 0:
        nd = min(int(valid), D)
    n_bytes = (B * nd * (T + 1) + idf.numel()) * 4 \
        + B * (D // block) * c * 8
    return _cost.KernelCost(((B * nd * (4 + 5 * T + 1), "fp32"),), n_bytes)


def bm25_topk_candidates(tf, doc_len, idf, *, block: int = 4096, c: int = 64,
                         k1: float = 1.5, b: float = 0.75,
                         avgdl: float = 100.0, valid=0):
    """Per-block BM25 top-c: (vals [B, nb, c] fp32, idx [B, nb, c] int32).

    tf [B,D,T], doc_len [B,D], idf [B,T], fp32. ``block`` must be a power of
    two dividing D (``ops.bm25_topk`` pads); c is clamped to the block. A
    chunk too large for one CTA's shared memory makes the launch fail, and
    the call raises. Under an op walk the call records its ``cost``.
    """
    if not tf.is_cuda:
        return bm25_topk_candidates_plain(tf, doc_len, idf, block=block, c=c,
                                          k1=k1, b=b, avgdl=avgdl,
                                          valid=valid)
    walk = _cost.ACTIVE["walk"]
    if walk is not None:
        return walk.kernel(
            "bm25_topk_candidates", tf,
            cost(tf, doc_len, idf, block=block, c=c, valid=valid),
            lambda: _launch(tf, doc_len, idf, block, c, k1, b, avgdl, valid))
    return _launch(tf, doc_len, idf, block, c, k1, b, avgdl, valid)


def _launch(tf, doc_len, idf, block, c, k1, b, avgdl, valid):
    B, D, T, block, c = _check_args(tf, doc_len, idf, block, c)
    if block & (block - 1):
        raise ValueError(f"block={block} must be a power of two")
    for name, x in (("tf", tf), ("doc_len", doc_len), ("idf", idf)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != tf.device:
            raise ValueError("tf, doc_len and idf must be on one CUDA device")
    nb = D // block
    vals = tf.new_empty((B, nb, c), dtype=torch.float32)
    idx = tf.new_empty((B, nb, c), dtype=torch.int32)
    if _cost.is_fake(tf):
        return vals, idx
    nd_ptr, nd = None, 0
    if isinstance(valid, torch.Tensor):
        if (valid.dtype != torch.int32 or valid.numel() != 1
                or valid.device != tf.device):
            raise ValueError("a tensor valid must be one int32 on tf's device")
        valid = valid.contiguous()
        nd_ptr = valid.data_ptr()
    else:
        nd = int(valid)
    tf, doc_len = _aligned16(tf), _aligned16(doc_len)
    idf = idf.contiguous()
    n_cta = split_plan(B, nb, block, c, n_sm=_sm_count(tf.device))
    lib = _build.load("bm25_topk")
    fn = lib.bm25_topk_candidates_cuda
    fn.restype = _I
    fn.argtypes = [_P] * 6 + [_I] * 6 + [_F] * 3 + [_I, _P]
    stream = torch.cuda.current_stream(tf.device).cuda_stream
    err = fn(tf.data_ptr(), doc_len.data_ptr(), idf.data_ptr(), nd_ptr,
             vals.data_ptr(), idx.data_ptr(), B, D, T, block, c, nd, k1, b,
             avgdl, n_cta, stream)
    _build.check(lib, err, "bm25_topk_candidates")
    bm25_topk_candidates.launches += 1
    return vals, idx


bm25_topk_candidates.launches = 0
