"""LServe (twin of ``repro.core.methods.lserve``), paper Table 1 row 3.

  prepare   page-wise channel min/max of the key cache (the page_minmax
            kernel); logical pages of ``block_size`` grouped into physical
            pages of ``pages_per_physical``
  relevancy per-channel max(q*min, q*max) bound, max-reduced over the
            logical pages of each physical page
  retrieve  top-k physical pages (ties by ascending index)
  apply     block-sparse attention over the logical pages of the selected
            physical pages

As in the reference, the bound takes the MAX over kv heads of both the
per-head minima and maxima, and averages the query heads including the dead
TP heads (their q is zero).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, MemoryConfig
from repro_torch.core.methods.dsa import (_repad_partial, repad_dead_heads,
                                          strip_dead_heads)
from repro_torch.core.pipeline import MemoryPipeline
from repro_torch.kernels import ops, ref

Params = Dict

# The page min/max summaries are the only inputs to relevancy / retrieve;
# the sparse apply stays with the KV pool.
OFFLOAD_STAGES = ("prepare", "relevancy", "retrieve")


def lserve_init(cfg: ArchConfig, mem: MemoryConfig, seed: int = 0, *,
                stacked: bool = True, device="cuda") -> Params:
    """LServe learns nothing: a dummy per-layer leaf, as in the reference."""
    dev = resolve_device(device)
    shape = (cfg.n_layers,) if stacked else ()
    return {"_": torch.zeros(shape, dtype=torch.int32, device=dev)}


def _page_bounds(kc, ps: int, kernel: bool = True):
    """prepare: kc [B,S,KV,dh] -> (pmin, pmax) [B, S/ps, dh], each the max
    over kv heads of the per-head page minima / maxima."""
    pmin, pmax = (ops.page_minmax(kc, page_size=ps) if kernel
                  else ref.page_minmax(kc, ps))
    return pmin.amax(dim=2), pmax.amax(dim=2)


def _physical_scores(q, pmin, pmax, ppp: int):
    """Logical page scores max-reduced to physical pages -> [B, n_phys];
    a ragged last physical page is padded with -1e30."""
    sc = ref.lserve_page_scores(q, pmin, pmax)            # [B, n_logical]
    B, nl = sc.shape
    pad = (-nl) % ppp
    if pad:
        sc = F.pad(sc, (0, pad), value=-1e30)
    return sc.reshape(B, (nl + pad) // ppp, ppp).amax(dim=-1)


def _logical_pages(phys, ppp: int):
    """[B, n] physical page ids -> [B, n*ppp] logical page ids."""
    B = phys.shape[0]
    ar = torch.arange(ppp, device=phys.device)
    return (phys.long()[..., None] * ppp + ar).reshape(B, -1)


def make_sparse_fn(cfg: ArchConfig, mem: MemoryConfig, *, tp: int = 16):
    """Returns sparse_fn(q, kc, vc, length, sp, k_new=None) for
    ``model.decode_step_paged`` / ``model.decode_step``."""
    ps = mem.block_size                   # logical page size
    ppp = mem.pages_per_physical
    n_phys_sel = max(mem.token_budget // (ps * ppp), 1)

    def sparse_fn(q, kc, vc, length, sp, k_new=None):
        B, S = q.shape[0], kc.shape[1]
        # --- prepare: page min/max (kernel) ---
        pmin, pmax = _page_bounds(kc, ps)
        # --- relevancy (bound) + retrieve the top physical pages ---
        sc = _physical_scores(q[:, 0], pmin[:, :, None], pmax[:, :, None],
                              ppp)
        n_sel = min(n_phys_sel, sc.shape[1])   # small caches: take them all
        _, phys = ref.topk_stable(sc, n_sel)
        logical = _logical_pages(phys, ppp)
        lb = torch.as_tensor(length, dtype=torch.int32,
                             device=q.device).reshape(-1).expand(B)
        live = (logical * ps < lb[:, None]) & (logical < S // ps)
        logical = torch.where(live, logical, torch.full_like(logical, -1))
        # --- apply: attention over the selected logical pages ---
        out, _ = ops.paged_decode_attention(strip_dead_heads(q, cfg), kc, vc,
                                            logical.to(torch.int32), lb,
                                            page_size=ps)
        return repad_dead_heads(out, q, cfg)

    return sparse_fn


class SplitLServe:
    """LServe over a sequence-split cache, for
    ``models.model.decode_step_tp`` (``make_sparse_fn`` as GSPMD partitions
    it over ``cache_specs``), with ``dsa.SplitDSA``'s protocol. It learns
    nothing and its query side is the whole gathered q every shard already
    holds; no KV page, page bound or raw score crosses.

      prepare    per shard the page min / max of its own slice (the
                 ``page_minmax`` kernel), max-reduced over kv heads there
                 (the decode layouts cut the cache by sequence only);
      relevancy  per shard its physical pages' bounds (``_physical_
                 scores``: every query head, the dead ones included, as one
                 device); a physical page (``pages_per_physical`` logical
                 pages) never straddles two shards;
      retrieve   per shard its stable top-min(k, local physical pages),
                 merged on the sequence group's first device
                 (``topk.merge_shard_topk``), cut to one device's count
                 (at most the physical pages there are), the physical page
                 ids delivered to every shard; each expands them to
                 logical pages and drops those from ``length`` on;
      apply      ``ops.paged_decode_attention`` per shard over the selected
                 logical pages it owns -> (out, lse) per shard.

    ``record=True`` keeps each call's logical page ids (``selected``)."""

    stateful = False

    def __init__(self, cfg: ArchConfig, mem: MemoryConfig, *,
                 record: bool = False):
        self.cfg, self.record = cfg, record
        self.page, self.ppp = mem.block_size, mem.pages_per_physical
        self.n_sel = max(mem.token_budget // (self.page * self.ppp), 1)
        self.selected = []

    def index_query(self, sps, qs):
        """Nothing to project: the shards score with the gathered q."""
        return [() for _ in qs]

    def __call__(self, shards, length):
        """One sequence group, as ``SplitDSA.__call__`` -> each shard's
        (out [B,Hp,hd], lse [B,Hp]) fp32 on its device."""
        from repro_torch.distributed import topk

        ps, ppp = self.page, self.ppp
        devices = [s["kc"].device for s in shards]
        Sl = shards[0]["kc"].shape[1]
        if Sl % (ps * ppp):
            raise ValueError(
                f"a shard's {Sl} tokens hold no whole number of "
                f"{ps * ppp}-token physical pages ({ppp} pages of {ps}): a "
                f"physical page would straddle two shards")
        n_local = Sl // (ps * ppp)
        n_sel = min(self.n_sel, n_local * len(shards))

        def shard_topk(i, k_local):
            s = shards[i]
            pmin, pmax = _page_bounds(s["kc"], ps)
            sc = _physical_scores(s["q"][:, 0], pmin[:, :, None],
                                  pmax[:, :, None], ppp)
            return ref.topk_stable(sc, k_local)

        _, phys = topk.merge_shard_topk(
            shard_topk, n_local, self.n_sel, devices, deliver=devices,
            keep=lambda vals, idx: idx[:, :n_sel])
        pages = []
        for p in phys:
            logical = _logical_pages(p, ppp)
            lb = torch.as_tensor(length, device=p.device).reshape(-1, 1)
            live = (logical * ps < lb) & (logical < Sl * len(shards) // ps)
            pages.append(torch.where(live, logical, torch.full_like(
                logical, -1)).to(torch.int32))
        if self.record:
            self.selected.append(pages[0])
        parts = topk.sparse_decode_partials(
            [strip_dead_heads(s["q"], self.cfg) for s in shards],
            [s["kc"] for s in shards], [s["vc"] for s in shards], pages,
            length, devices, page_size=ps)
        return [_repad_partial(o, lse, s["q"]) for (o, lse), s in
                zip(parts, shards)]


def build_pipeline(cfg: ArchConfig, mem: MemoryConfig, sp: Params, *,
                   fused: bool = False) -> MemoryPipeline:
    """The four stages over (memory=(kc, vc), query=q [B,1,Hp,hd]);
    ``fused=True`` runs prepare in the page_minmax kernel, ``fused=False``
    in the plain op."""
    ps = mem.block_size
    ppp = mem.pages_per_physical
    n_phys_sel = max(mem.token_budget // (ps * ppp), 1)

    def prepare(M):
        kc, _ = M
        return _page_bounds(kc, ps, kernel=fused)

    def relevancy(I, q):
        pmin, pmax = I
        return _physical_scores(q[:, 0], pmin[:, :, None], pmax[:, :, None],
                                ppp)

    def retrieve(M, sc):
        kc, vc = M
        _, phys = ref.topk_stable(sc, n_phys_sel)
        return (kc, vc, _logical_pages(phys, ppp))

    def apply(Mp, q):
        kc, vc, logical = Mp
        length = torch.full((q.shape[0],), kc.shape[1], dtype=torch.int32,
                            device=kc.device)
        out, _ = ops.paged_decode_attention(q[:, 0], kc, vc,
                                            logical.to(torch.int32), length,
                                            page_size=ps)
        return out

    return MemoryPipeline(
        name="lserve-fused" if fused else "lserve",
        prepare=prepare, relevancy=relevancy, retrieve=retrieve, apply=apply,
    )
