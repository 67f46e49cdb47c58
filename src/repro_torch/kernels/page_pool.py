"""Paged KV-pool access (twin of the pool ops in ``repro.kernels.page_pool``).

The serving engine stores KV in a shared pool of fixed-size physical pages
``[n_pages, page_size, KV, dh]`` addressed through per-slot page tables.
Physical page 0 is the reserved zero page: unallocated table entries point
at it, and dead-slot or padding writes are routed to it ZEROED, so it stays
zero and pooled decode equals per-request decode.

The reference returns new arrays (and the engine donates the old buffers);
here the scatters write the pool in place with ``index_put_`` and return it.
"""
from __future__ import annotations

import torch


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
