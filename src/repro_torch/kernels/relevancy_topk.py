"""Fused Compute-Relevancy + Retrieval (twin of ``repro.kernels.relevancy_topk``).

Per key block: multi-head inner product against the compressed index keys,
head-weighted ReLU reduction, then an exact top-c of the block, so only
(c values, c indices) per block leave the kernel. ``merge_candidates`` then
takes the global top-k of the nb * c candidates; the result is exact when
c >= min(k, block).

``relevancy_topk_candidates`` launches the CUDA kernel
(``csrc/relevancy_topk.cu``) for CUDA tensors and runs
``relevancy_topk_candidates_plain`` for CPU tensors; it never falls back from
one to the other. The kernel runs each block as a thread-block cluster of
``split_plan`` CTAs, each scoring a contiguous chunk; the chunks' sorted runs
are merged by rank (``csrc/topk.cuh``). ``split_topk`` is that schedule in
plain torch, and ``relevancy_topk_candidates_split`` runs it on this
module's scores; the tests hold it against the reference.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import ref
from repro_torch.kernels.sparse_decode_attention import _aligned16, _sm_count

_P = ctypes.c_void_p
_I = ctypes.c_int

#: scores ranked against each other in a CTA (the kernels' ``topk::kSeg``)
SEG = 128
#: largest c of the register route (``topk::kMaxRegC``)
MAX_REG_C = 16
#: threads of the relevancy kernel's CTA (``kThreads``)
THREADS = 128
#: CTAs a cluster may hold: the portable limit (16, the non-portable one,
#: scheduled but did not help at DSA's or Fig. 10's shape)
MAX_CLUSTER = 8
#: the fewest keys (or docs) a CTA of a split block scores
MIN_CHUNK = 64


def split_plan(B: int, nb: int, block: int, c: int, *,
               n_sm: int = 132) -> int:
    """CTAs in the cluster of one block: the largest power of two N <=
    MAX_CLUSTER that divides ``block``, leaves every CTA at least MIN_CHUNK
    candidates, and keeps B x nb x N CTAs within one wave of ``n_sm`` SMs.
    N = 1 for blocks of MIN_CHUNK or fewer. ``c`` sets each CTA's run
    length, min(c, block / N), and does not change N."""
    del c   # every N is exact for every c: the runs are min(c, chunk) long
    n = 1
    while (2 * n <= MAX_CLUSTER and block % (2 * n) == 0
           and block // (2 * n) >= MIN_CHUNK and B * nb * 2 * n <= n_sm):
        n *= 2
    return n


def _sorted_runs(v, i, keep: int):
    """Sort each run of the last axis by (value desc, index asc) and keep
    its first ``keep`` pairs. ``i`` ascends along the axis, so a stable
    descending sort gives the index order on ties."""
    v, pos = torch.sort(v, dim=-1, descending=True, stable=True)
    return v[..., :keep], torch.gather(i, -1, pos)[..., :keep]


def rank_merge(rv, ri, keep: int):
    """Merge R sorted runs [..., R, L] by rank: a pair's place is its index
    in its run plus, for every other run, the pairs there that go before
    it; the pairs placed below ``keep`` form the result [..., keep]."""
    R, L = rv.shape[-2:]
    xv, xi = rv[..., :, :, None, None], ri[..., :, :, None, None]
    ev, ei = rv[..., None, None, :, :], ri[..., None, None, :, :]
    before = (ev > xv) | ((ev == xv) & (ei < xi))       # [..., R, L, R, L]
    other = ~torch.eye(R, dtype=torch.bool, device=rv.device)
    rank = torch.arange(L, device=rv.device) + (
        before & other[:, None, :, None]).sum((-1, -2))
    lead = rv.shape[:-2]
    out_v = torch.empty(lead + (keep,), dtype=rv.dtype, device=rv.device)
    out_i = torch.empty(lead + (keep,), dtype=ri.dtype, device=rv.device)
    sel = rank < keep
    flat = rank.reshape(-1, R * L)
    rows = torch.arange(flat.shape[0], device=rv.device)[:, None] \
        .expand(-1, R * L)
    m = sel.reshape(-1, R * L)
    out_v.reshape(-1, keep)[rows[m], flat[m]] = rv.reshape(-1, R * L)[m]
    out_i.reshape(-1, keep)[rows[m], flat[m]] = ri.reshape(-1, R * L)[m]
    if int(m.sum()) != out_v.numel():
        raise AssertionError("rank merge: the places are not a permutation")
    return out_v, out_i


def cta_runs(x, i, c: int, threads: int):
    """``cta_top_run`` on chunks x, i [..., chunk] (indices ascending):
    sorted runs [..., R, L] to merge. For c <= MAX_REG_C and a chunk longer
    than SEG, one run a warp: score s goes to thread s % threads, so warp w
    holds the scores with (s % threads) // 32 == w, and keeps its top
    min(c, its scores) (the kernel merges these by shuffles in one warp,
    not by rank; the result is the same). Otherwise one run a segment of
    SEG scores, its top min(c, SEG)."""
    chunk = x.shape[-1]
    if c <= MAX_REG_C and chunk > SEG:
        if chunk >= threads:           # [..., k, warp, lane] -> warp-major
            shape = x.shape[:-1] + (chunk // threads, threads // 32, 32)
            x, i = (t.reshape(shape).transpose(-3, -2) for t in (x, i))
        else:                          # the first chunk / 32 warps, a score a lane
            shape = x.shape[:-1] + (chunk // 32, 1, 32)
            x, i = (t.reshape(shape) for t in (x, i))
        x, i = (t.reshape(t.shape[:-2] + (-1,)) for t in (x, i))
    else:
        seg = min(SEG, chunk)
        x, i = (t.reshape(t.shape[:-1] + (chunk // seg, seg)) for t in (x, i))
    return _sorted_runs(x, i, min(c, x.shape[-1]))


def split_topk(scores, block: int, c: int, n: int, threads: int):
    """The kernels' schedule on masked scores [B, S]: each block of
    ``block`` split into ``n`` chunks, one a CTA of ``threads`` threads;
    each chunk's runs (``cta_runs``) merged by rank to min(c, chunk)
    (``cta_top_run``); the chunks' runs merged by rank to c
    (``cluster_top_write``). -> (vals [B, nb, c] fp32, idx [B, nb, c]
    int32, global)."""
    B, S = scores.shape
    nb, chunk = S // block, block // n
    x = scores.reshape(B, nb, n, chunk)
    i = torch.arange(block, dtype=torch.int32, device=scores.device) \
        .reshape(n, chunk).expand_as(x)
    rv, ri = cta_runs(x, i, c, threads)
    run = min(c, chunk)
    rv, ri = rank_merge(rv, ri, run) if rv.shape[-2] > 1 \
        else (rv[..., 0, :], ri[..., 0, :])
    rv, ri = rank_merge(rv, ri, c) if n > 1 else (rv[..., 0, :], ri[..., 0, :])
    base = (torch.arange(nb, device=scores.device, dtype=torch.int32)
            * block)[None, :, None]
    return rv, ri + base


def uses_tensor_cores(dtype, dk: int) -> bool:
    """The kernel scores on the tensor cores (mma.sync bf16) for bf16 with
    dk % 16 == 0, any head count, else on the CUDA cores in fp32."""
    return dtype == torch.bfloat16 and dk % 16 == 0


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
    scores = _masked_scores(q, keys, weights, valid_len)
    vals, within = ref.topk_stable(scores.reshape(B, nb, block), c)
    base = (torch.arange(nb, device=keys.device, dtype=torch.int32)
            * block)[None, :, None]
    return vals, within + base


def _masked_scores(q, keys, weights, valid_len):
    S = keys.shape[1]
    scores = ref.relevancy_scores(q, keys, weights)
    pos = torch.arange(S, device=keys.device)
    return torch.where(pos < (valid_len or S), scores,
                       torch.full_like(scores, float("-inf")))


def relevancy_topk_candidates_split(q, keys, weights, *, block: int = 2048,
                                    c: int = 0, valid_len: int = 0,
                                    n: int = 0):
    """The kernel's schedule (``split_topk``) in plain torch, on the plain
    version's scores: clusters of ``n`` CTAs a block (0: ``split_plan`` on
    a 132-SM card). Same result as ``relevancy_topk_candidates_plain``."""
    B, S, _, block, c = _check_args(q, keys, weights, block, c)
    n = n or split_plan(B, S // block, block, c)
    return split_topk(_masked_scores(q, keys, weights, valid_len), block, c,
                      n, THREADS)


def cost(q, keys, weights, *, block: int = 2048,
         c: int = 0) -> _cost.KernelCost:
    """The work of one candidates call: q.k products (on the tensor cores
    for bf16 inputs), then on the fp32 cores the relu.w terms and the
    log2(block) compares a key that ordering a block by comparisons needs
    at least; q, keys and weights read once, the candidates written once."""
    B, S, dk, block, c = _check_args(q, keys, weights, block, c)
    Hq = q.shape[1]
    n_bytes = (q.numel() + keys.numel()) * q.element_size() \
        + weights.numel() * 4 + B * (S // block) * c * 8
    dots = 2 * B * S * Hq * dk
    rest = 2 * B * S * Hq + B * S * max(1, int(math.log2(block)))
    return _cost.KernelCost(((dots, _cost.dot_key(q, keys)),
                             (rest, "fp32")), n_bytes)


def relevancy_topk_candidates(q, keys, weights, *, block: int = 2048,
                              c: int = 0, valid_len: int = 0):
    """Per-block candidates: (vals [B, nb, c] fp32, idx [B, nb, c] int32).

    q [B,Hq,dk] and keys [B,S,dk] share one dtype (fp32 or bf16); weights
    [B,Hq]. ``block`` must be a power of two dividing S (``ops`` pads);
    c = 0 -> block; valid_len = 0 -> S (keys at or past it score -inf).
    Under an op walk the call records its ``cost``.
    """
    if not keys.is_cuda:
        return relevancy_topk_candidates_plain(q, keys, weights, block=block,
                                               c=c, valid_len=valid_len)
    walk = _cost.ACTIVE["walk"]
    if walk is not None:
        return walk.kernel("relevancy_topk_candidates", keys,
                           cost(q, keys, weights, block=block, c=c),
                           lambda: _launch(q, keys, weights, block, c,
                                           valid_len))
    return _launch(q, keys, weights, block, c, valid_len)


def _launch(q, keys, weights, block, c, valid_len):
    B, S, dk, block, c = _check_args(q, keys, weights, block, c)
    if block & (block - 1):
        raise ValueError(f"block={block} must be a power of two")
    if q.dtype != keys.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q/keys must share fp32 or bf16, got {q.dtype}/"
                        f"{keys.dtype}")
    if not (q.is_cuda and weights.is_cuda and q.device == keys.device):
        raise ValueError("q, keys and weights must be on one CUDA device")
    nb = S // block
    vals = keys.new_empty((B, nb, c), dtype=torch.float32)
    idx = keys.new_empty((B, nb, c), dtype=torch.int32)
    if _cost.is_fake(keys):
        return vals, idx
    q, keys = _aligned16(q), _aligned16(keys)
    weights = weights.float().contiguous()
    Hq = q.shape[1]
    n_cta = split_plan(B, nb, block, c, n_sm=_sm_count(keys.device))
    lib = _build.load("relevancy_topk")
    fn = lib.relevancy_topk_candidates_cuda
    fn.restype = _I
    fn.argtypes = [_P] * 5 + [_I] * 10 + [_P]
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = fn(q.data_ptr(), keys.data_ptr(), weights.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), B, Hq, dk, S, block, c,
             valid_len or S, int(q.dtype == torch.bfloat16),
             int(uses_tensor_cores(q.dtype, dk)), n_cta, stream)
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
