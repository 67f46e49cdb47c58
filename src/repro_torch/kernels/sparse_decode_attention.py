"""Paged sparse decode attention, the Apply-to-Inference stage (twin of
``repro.kernels.sparse_decode_attention``).

One query per slot attends over the retrieved KV pages only, with an fp32
online softmax, and returns (out, lse) so partial results can be LSE-merged.

``paged_decode_attention`` launches the CUDA kernel
(``csrc/paged_decode_attention.cu``) for CUDA tensors and runs
``paged_decode_attention_plain`` for CPU tensors; it never falls back from one
to the other. The kernel cuts each slot's selection into runs of whole pages
(``split_plan``), one CTA each, and folds the runs' (m, l, acc) partials in
a second pass; ``paged_decode_attention_split`` is that algorithm in plain
torch, held against the reference by the tests.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import ref

_P = ctypes.c_void_p
_I = ctypes.c_int


#: tokens a split aims at: 2 x 8 KB of bf16 K/V rows at head dim 64
SPLIT_TOKENS = 256
HEADS_PER_CTA = 4      # the kernel's kGT
_SM_COUNT = {}


def split_plan(B: int, KV: int, G: int, n_sel: int, ps: int,
               n_sm: int) -> Tuple[int, int]:
    """(pages per split, splits) for ``n_sel`` selected pages of ``ps``
    tokens: about SPLIT_TOKENS tokens a split, and at least enough splits
    that B x KV x head groups x splits CTAs fill ``n_sm`` SMs once, at most
    one split a page. Every split holds at least one page; the last may hold
    fewer than the others."""
    n_sel = max(n_sel, 1)
    ctas = B * KV * -(-G // HEADS_PER_CTA)
    want = max(-(-n_sel * ps // SPLIT_TOKENS), -(-n_sm // max(ctas, 1)))
    pps = max(n_sel // want, 1)
    return pps, -(-n_sel // pps)


def split_partials(q, k_cache, v_cache, page_ids, length, *, page_size: int,
                   pages_per_split: int):
    """Per split of ``pages_per_split`` pages: (m, l, acc) of each query
    head, m the max masked score, l = sum e^(s - m), acc = sum e^(s - m) v,
    all fp32: m, l [N, B, Hq], acc [N, B, Hq, dh]. Masks as the reference:
    -1e30 for a -1 page (which reads page 0) or a token at or past
    ``length``."""
    B, S, KV, dh = k_cache.shape
    Hq = q.shape[1]
    G, ps = Hq // KV, page_size
    n_sel = page_ids.shape[1]
    qg = q.reshape(B, KV, G, dh).float() / math.sqrt(dh)
    lb = torch.as_tensor(length, device=q.device).reshape(-1).expand(B)
    rows = torch.arange(B, device=q.device)[:, None]
    out = []
    for p0 in range(0, n_sel, pages_per_split):
        ids = page_ids[:, p0:p0 + pages_per_split]
        safe = ids.clamp(min=0).long()
        n = ids.shape[1] * ps
        kg = k_cache.reshape(B, S // ps, ps, KV, dh)[rows, safe] \
            .reshape(B, n, KV, dh).float()
        vg = v_cache.reshape(B, S // ps, ps, KV, dh)[rows, safe] \
            .reshape(B, n, KV, dh).float()
        pos = (safe[:, :, None] * ps + torch.arange(ps, device=q.device)) \
            .reshape(B, n)
        valid = (ids[:, :, None] >= 0).expand(-1, -1, ps).reshape(B, n) \
            & (pos < lb[:, None])
        sc = torch.einsum("bkgd,bnkd->bkgn", qg, kg)
        sc = torch.where(valid[:, None, None], sc,
                         torch.full_like(sc, ref.NEG_INF))
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        acc = torch.einsum("bkgn,bnkd->bkgd", p, vg)
        out.append((m.reshape(B, Hq), p.sum(-1).reshape(B, Hq),
                    acc.reshape(B, Hq, dh)))
    m, l, acc = (torch.stack(t) for t in zip(*out))
    return m, l, acc


def combine_partials(m, l, acc):
    """Fold split partials (``split_partials``) in split order: M = max m_i,
    L = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) / max(L, 1e-30),
    lse = M + log(max(L, 1e-30)). The counts stay in l, so a slot with no
    valid token gets the mean of v over every token it loaded, as the
    reference does; an (out, lse) merge (``lse_merge``) would not."""
    M = m.amax(0)
    w = torch.exp(m - M[None])
    L = (l * w).sum(0).clamp(min=1e-30)
    out = (acc * w[..., None]).sum(0) / L[..., None]
    return out, M + torch.log(L)


def paged_decode_attention_split(q, k_cache, v_cache, page_ids, length, *,
                                 page_size: int = 64,
                                 pages_per_split: int = 1):
    """The kernel's algorithm in plain torch: per-split (m, l, acc), then the
    combine. -> (out [B,Hq,dh] fp32, lse [B,Hq] fp32)."""
    return combine_partials(*split_partials(
        q, k_cache, v_cache, page_ids, length, page_size=page_size,
        pages_per_split=pages_per_split))


def _sm_count(dev) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def _row_chunks_ok(dh: int, itemsize: int) -> bool:
    """The kernel reads a token row as 16-byte chunks, at most 32 of them."""
    return dh * itemsize % 16 == 0 and dh * itemsize <= 512


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte-aligned base (cp.async's rule)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _lengths(length, B: int, device) -> torch.Tensor:
    return torch.as_tensor(length, dtype=torch.int32,
                           device=device).reshape(-1).expand(B).contiguous()


def paged_decode_attention_plain(q, k_cache, v_cache, page_ids, length, *,
                                 page_size: int = 64):
    """Plain-torch version: gathers the selected pages and runs one exact
    softmax over them (``ref.paged_decode_attention``)."""
    return ref.paged_decode_attention(q, k_cache, v_cache, page_ids,
                                      page_size, length)


def cost(q, k_cache, v_cache, page_ids, length, *, page_size: int = 64,
         valid_tokens=None, pages_read=None) -> _cost.KernelCost:
    """The work of one call: q.k over the valid selected tokens (on the
    tensor cores for bf16 inputs) and p.v on the fp32 cores (fp32
    weights); q, the K/V rows of the pages read, the page ids and lengths
    read once, out and lse written once. ``valid_tokens`` (the (slot,
    token) pairs inside a selected page and below the slot's length) and
    ``pages_read`` (the selected pages, at least one a slot) are the
    data's counts; None counts every selected token and page (shapes
    only, as a walk does)."""
    B, S, KV, dh = k_cache.shape
    Hq, n_sel = q.shape[1], page_ids.shape[1]
    if valid_tokens is None:
        valid_tokens = B * n_sel * page_size
    if pages_read is None:
        pages_read = B * max(n_sel, 1)
    n_bytes = (q.numel() * q.element_size()
               + pages_read * page_size * KV * dh * k_cache.element_size() * 2
               + page_ids.numel() * 4 + B * 4 + B * Hq * dh * 4 + B * Hq * 4)
    qk = pv = 2 * valid_tokens * Hq * dh
    return _cost.KernelCost(((qk, _cost.dot_key(q, k_cache)), (pv, "fp32")),
                            n_bytes)


def paged_decode_attention(q, k_cache, v_cache, page_ids, length, *,
                           page_size: int = 64):
    """q [B,Hq,dh]; k/v [B,S,KV,dh]; page_ids [B,P] (-1 = hole); length [B]
    or [] -> (out [B,Hq,dh] fp32, lse [B,Hq] fp32). Under an op walk the
    call records its ``cost``."""
    if not k_cache.is_cuda:
        return paged_decode_attention_plain(q, k_cache, v_cache, page_ids,
                                            length, page_size=page_size)
    walk = _cost.ACTIVE["walk"]
    if walk is not None:
        return walk.kernel(
            "paged_decode_attention", k_cache,
            cost(q, k_cache, v_cache, page_ids, length, page_size=page_size),
            lambda: _launch(q, k_cache, v_cache, page_ids, length, page_size))
    return _launch(q, k_cache, v_cache, page_ids, length, page_size)


def _launch(q, k_cache, v_cache, page_ids, length, ps):
    B, S, KV, dh = k_cache.shape
    Hq = q.shape[1]
    if (q.shape != (B, Hq, dh) or v_cache.shape != k_cache.shape
            or page_ids.dim() != 2 or page_ids.shape[0] != B):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)}"
                         f" v {tuple(v_cache.shape)} pages "
                         f"{tuple(page_ids.shape)} do not agree")
    if Hq % KV or S % ps:
        raise ValueError(f"need Hq % KV == 0 and S % page_size == 0, got "
                         f"Hq={Hq} KV={KV} S={S} page_size={ps}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype
            and q.dtype in (torch.float32, torch.bfloat16)):
        raise TypeError(f"q/k/v must share fp32 or bf16, got {q.dtype}/"
                        f"{k_cache.dtype}/{v_cache.dtype}")
    if not _row_chunks_ok(dh, q.element_size()):
        raise ValueError(f"head dim {dh} x {q.element_size()} bytes must be "
                         f"a multiple of 16 bytes, at most 512")
    dev = k_cache.device
    if not (q.device == v_cache.device == page_ids.device == dev):
        raise ValueError("q, k, v and page_ids must be on one CUDA device")
    out = k_cache.new_empty((B, Hq, dh), dtype=torch.float32)
    lse = k_cache.new_empty((B, Hq), dtype=torch.float32)
    if _cost.is_fake(k_cache):
        return out, lse
    q, k_cache, v_cache = (_aligned16(t) for t in (q, k_cache, v_cache))
    pages = page_ids.to(torch.int32).contiguous()
    n_sel = pages.shape[1]
    lens = _lengths(length, B, dev)
    pps, n_split = split_plan(B, KV, Hq // KV, n_sel, ps, _sm_count(dev))
    part_ml = torch.empty((B, Hq, n_split, 2), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((B, Hq, n_split, dh), dtype=torch.float32,
                           device=dev)
    lib = _build.load("paged_decode_attention")
    fn = lib.paged_decode_attention_cuda
    fn.restype = _I
    fn.argtypes = [_P] * 9 + [_I] * 9 + [ctypes.c_float, _I, _P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             pages.data_ptr(), lens.data_ptr(), part_ml.data_ptr(),
             part_acc.data_ptr(), out.data_ptr(), lse.data_ptr(),
             B, S, KV, Hq // KV, dh, ps, n_sel, pps, n_split, math.sqrt(dh),
             int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out, lse


paged_decode_attention.launches = 0


def lse_merge(outs: torch.Tensor, lses: torch.Tensor):
    """Merge N partial attention results: outs [N, B, H, dh], lses [N, B, H].

    FlashDecoding combine: a softmax over the shard LSEs reweights the shard
    outputs.
    """
    m = lses.amax(0)
    w = torch.exp(lses - m[None])
    den = w.sum(0)
    out = (outs * w[..., None]).sum(0) / den[..., None].clamp(min=1e-30)
    return out, m + torch.log(den.clamp(min=1e-30))
