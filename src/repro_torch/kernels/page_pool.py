"""Paged KV-pool access and LServe's page min/max (twin of
``repro.kernels.page_pool``).

The serving engine stores KV in a shared pool of fixed-size physical pages
``[n_pages, page_size, KV, dh]`` addressed through per-slot page tables.
Physical page 0 is the reserved zero page: unallocated table entries point
at it, and dead-slot or padding writes are routed to it ZEROED, so it stays
zero and pooled decode equals per-request decode.

The reference returns new arrays (and the engine donates the old buffers);
here the scatters write the pool in place with ``index_put_`` and return it.

``page_minmax`` (LServe's prepare stage) launches the CUDA kernel
(``csrc/page_minmax.cu``) for CUDA tensors and runs ``page_minmax_plain``
for CPU tensors; it never falls back from one to the other. Its bulk route
follows ``minmax_plan``, a pure function of the shape and the SM count.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def pool_gather(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pages [P, ps, KV, dh]; page_table [B, NP] -> views [B, NP * ps, KV, dh]."""
    _, ps, KV, dh = pages.shape
    B, NP = page_table.shape
    return pages[page_table.long()].reshape(B, NP * ps, KV, dh)


def pool_scatter_token(pages, page_table, positions, values, live):
    """Write one new token per slot, in place.

    positions [B] (logical position written); values [B, KV, dh]; live [B]
    bool. Dead slots write zeros to page 0.
    """
    ps = pages.shape[1]
    NP = page_table.shape[1]
    positions = positions.long()
    logical = (positions // ps).clamp(0, NP - 1)   # dead slots can sit at NP
    dest = torch.gather(page_table.long(), 1, logical[:, None])[:, 0]
    dest = torch.where(live, dest, torch.zeros_like(dest))
    vals = values * live[:, None, None].to(values.dtype)
    pages.index_put_((dest, positions % ps), vals.to(pages.dtype))
    return pages


def pool_scatter_span(pages, page_table, start, values, n_valid):
    """Write a span of C new tokens per slot (chunked prefill), in place.

    start [B] (first logical position); values [B, C, KV, dh]; n_valid [B]
    (real tokens of the span; the rest are padding, written zeroed to page 0).
    """
    ps = pages.shape[1]
    B, C = values.shape[:2]
    ar = torch.arange(C, device=values.device)
    tok_pos = start.long()[:, None] + ar[None, :]                 # [B, C]
    valid = ar[None, :] < n_valid.long()[:, None]                  # [B, C]
    logical = (tok_pos // ps).clamp(0, page_table.shape[1] - 1)
    dest = torch.gather(page_table.long(), 1, logical)
    dest = torch.where(valid, dest, torch.zeros_like(dest))
    vals = values * valid[:, :, None, None].to(values.dtype)
    pages.index_put_((dest, tok_pos % ps), vals.to(pages.dtype))
    return pages


def _check_page_size(k_cache, page_size: int):
    if k_cache.dim() != 4:
        raise ValueError(f"k_cache must be [B,S,KV,dh], got "
                         f"{tuple(k_cache.shape)}")
    S = k_cache.shape[1]
    if page_size < 1 or S % page_size:
        raise ValueError(f"S={S} is not a multiple of page_size={page_size}")


def page_minmax_plain(k_cache, *, page_size: int = 64):
    """Plain-torch version (``ref.page_minmax``): fp32 min and max of each
    page's keys, per channel."""
    _check_page_size(k_cache, page_size)
    return ref.page_minmax(k_cache, page_size)


def cost(k_cache, *, page_size: int = 64) -> _cost.KernelCost:
    """The work of one call: one compare for the min and one for the max
    per key element, on the fp32 cores; the keys read once, the two fp32
    [B, S/ps, KV, dh] outputs written once."""
    B, S, KV, dh = k_cache.shape
    n_out = B * (S // page_size) * KV * dh
    return _cost.KernelCost(((2 * k_cache.numel(), "fp32"),),
                            k_cache.numel() * k_cache.element_size()
                            + 2 * n_out * 4)


#: ``csrc/page_minmax.cu``'s threads a CTA
THREADS = 256
#: the bulk route's sizes, picked on an H100 at LServe's shapes: one CTA an
#: SM holds a ring of up to RING_BYTES in stages of up to STAGE_BYTES, 2 to
#: MAX_STAGES of them; where every tile of whole rows fits in two CTAs an
#: SM, two CTAs an SM hold half of each, so all of a small input is asked
#: for at once. Rows of more than THREADS 16-byte vectors are cut into equal
#: pieces read one copy a row, through 2 stages: more copies in flight
#: slowed those strided reads
STAGE_BYTES = 64 * 1024
RING_BYTES = 192 * 1024
MAX_STAGES = 8


class MinmaxPlan(NamedTuple):
    """The bulk route's tiling of k [B, S, C] in pages of ``ps`` rows: a
    tile is one (slot, page, piece of ``W`` 16-byte vectors of a row; a
    row's last piece may be narrower), streamed in ``bands`` of ``rows``
    rows (a page's last band may be shorter) through a ring of ``stages``
    stages of rows x W vectors. ``grid`` persistent CTAs take tiles
    ``cta, cta + grid, ...``; ``smem`` is a CTA's dynamic shared memory:
    the ring, two tiles' (min, max) partials of THREADS vectors, one 8-byte
    mbarrier a stage."""
    W: int
    pieces: int
    rows: int
    bands: int
    stages: int
    tiles: int
    grid: int
    smem: int


def minmax_plan(B: int, S: int, C: int, elem_bytes: int, ps: int,
                n_sm: int) -> MinmaxPlan:
    """The bulk route's plan for k [B, S, C] of ``elem_bytes`` elements
    (``C * elem_bytes`` a multiple of 16) in pages of ``ps``, on a card of
    ``n_sm`` SMs. The grid is one CTA a tile where there are fewer tiles
    than CTAs fit, so the CTAs' tile counts differ by at most one."""
    G = C * elem_bytes // 16                     # vectors in a row
    pieces = -(-G // THREADS)
    W = -(-G // pieces)
    pieces = -(-G // W)
    tiles = B * (S // ps) * pieces
    per_sm = 2 if pieces == 1 and tiles <= 2 * n_sm else 1
    bands = -(-ps // max(1, STAGE_BYTES // per_sm // (16 * W)))
    rows = -(-ps // bands)
    stages = 2 if pieces > 1 else max(2, min(
        MAX_STAGES, RING_BYTES // per_sm // (16 * rows * W)))
    smem = 16 * (stages * rows * W + 4 * THREADS) + 8 * stages
    return MinmaxPlan(W, pieces, rows, bands, stages, tiles,
                      min(tiles, per_sm * n_sm), smem)


def page_minmax(k_cache, *, page_size: int = 64):
    """k_cache [B,S,KV,dh] (fp32 or bf16) -> (min, max) [B,S/ps,KV,dh]
    fp32. Raises when S is not a multiple of ``page_size``. Under an op
    walk the call records its ``cost``."""
    if not k_cache.is_cuda:
        return page_minmax_plain(k_cache, page_size=page_size)
    walk = _cost.ACTIVE["walk"]
    if walk is not None:
        return walk.kernel("page_minmax", k_cache,
                           cost(k_cache, page_size=page_size),
                           lambda: _launch(k_cache, page_size))
    return _launch(k_cache, page_size)


def _launch(k_cache, page_size):
    _check_page_size(k_cache, page_size)
    if k_cache.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"k_cache must be fp32 or bf16, got {k_cache.dtype}")
    B, S, KV, dh = k_cache.shape
    dev = k_cache.device
    mn = k_cache.new_empty((B, S // page_size, KV, dh), dtype=torch.float32)
    mx = torch.empty_like(mn)
    if mn.numel() == 0 or _cost.is_fake(k_cache):
        return mn, mx
    k = k_cache.contiguous()
    C = KV * dh
    # the bulk route takes 16-byte vectors; the scalar route (W = 0) the rest
    plan = (0, 0, 0, 0, 0)
    if C * k.element_size() % 16 == 0 and k.data_ptr() % 16 == 0:
        p = minmax_plan(B, S, C, k.element_size(), page_size,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
        plan = (p.W, p.rows, p.stages, p.grid, p.smem)
    lib = _build.load("page_minmax")
    fn = lib.page_minmax_cuda
    fn.restype = _I
    fn.argtypes = [_P, _P, _P] + [_I] * 10 + [_P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(k.data_ptr(), mn.data_ptr(), mx.data_ptr(), B, S, C, page_size,
             int(k.dtype == torch.bfloat16), *plan, stream)
    _build.check(lib, err, "page_minmax")
    page_minmax.launches += 1
    return mn, mx


page_minmax.launches = 0
