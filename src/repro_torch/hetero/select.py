"""Offload-side memory index + selection (twin of ``repro.hetero.select``).

For each sparse method the offload side keeps a compact, incrementally
maintained SUMMARY of the key cache in logical (slot, page) space and
answers lookahead queries with top-k page indices:

  dsa    : per-micro-page SUM of lightning-indexer key projections (mean
           recovered at score time; score = w-weighted ReLU inner product,
           the inline relevancy kernel's math);
  seer   : per-block SUM of gate-projected keys, optional threshold
           selection on softmax-normalized scores;
  lserve : per-logical-page channel-wise MIN/MAX of raw keys, max-reduced
           over physical-page groups.

Summaries are updated from the same per-layer keys the main side writes
into the KV pool, so summary state is a pure function of the token stream,
which is what makes the overlapped executor equal its synchronous schedule.

Every function returns NEW tensors and leaves its inputs as they were: the
reference's arrays are immutable, and the executor relies on the same
property, since a selection in flight on the offload stream reads the
summary pinned before the step while the next ingest builds its successor.
The selection math is plain tensor code, as the reference's is (its
``jax.lax.top_k`` here is ``kernels.ref.topk_stable``, ties by ascending
index, never ``torch.topk``).

Every bundle is built over a WINDOW ``(tok_lo, n_tok)`` of the logical
token space, the full window unless given; ``select_partial`` returns the
window's top candidates as (vals, idx) in global page coordinates and
``finalize`` merges candidate lists (``merge_shard_topk``), so ``select =
finalize o select_partial``. The sharded executor (``hetero.sharded``)
builds one bundle per shard window.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, MemoryConfig
from repro_torch.kernels.ref import topk_stable

NEG_INF = -1e30
BIG = 3e30  # finite min/max sentinel (inf would poison 0 * inf -> nan)


class OffloadSelect(NamedTuple):
    """Per-method offload-side implementation bundle (one per window)."""

    method: str
    page: int                 # selection granularity (tokens per page)
    n_sel: int                # width of the final merged index vector
    n_pages: int              # logical pages in this bundle's window
    summary_init: Callable    # () -> summary dict
    reset: Callable           # (summary, slot_ids) -> summary
    ingest: Callable          # (summary, sp, k_new, pos, live) -> summary
    ingest_span: Optional[Callable]
    #   (summary, sp, k_span, slots, start, n_valid) -> summary
    select: Callable          # (sp, summary, q_layers, lengths) -> pidx
    # --- sharded protocol ---
    select_partial: Optional[Callable] = None
    #   (sp, summary, q_layers, lengths) -> (vals [L,B,n_part],
    #   idx [L,B,n_part] in global page / physical-page coordinates)
    finalize: Optional[Callable] = None
    #   (vals [L,B,K], idx [L,B,K], lengths [B]) -> pidx [L,B,n_sel]
    n_part: int = 0           # candidate width of select_partial
    tok_lo: int = 0           # global token offset of the window
    n_tok: int = 0            # tokens covered by the window


def _qf_layers(q_layers: torch.Tensor, n_in: int) -> torch.Tensor:
    """[L, B, Hp, hd] -> [L, B, n_in]: flatten heads, strip TP dead-head
    padding (the inline ``qf[:, :n_in]`` slice)."""
    L, B = q_layers.shape[:2]
    return q_layers.reshape(L, B, -1)[:, :, :n_in]


def _win_mask(P: int, page: int, tok_lo: int, lengths: torch.Tensor):
    """[1, B, P] page liveness for a window starting at ``tok_lo``: page p
    covers global tokens [tok_lo + p*page, ...), live iff its first token
    is inside the slot's live region."""
    first = tok_lo + torch.arange(P, device=lengths.device) * page
    return first[None, None, :] < lengths.long()[None, :, None]


def _promoted_bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[L, ..., F] @ [L, F, E] -> [L, ..., E] in the dtype JAX's promotion
    gives (fp32 @ bf16 -> fp32, bf16 @ bf16 -> bf16)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    L, F = a.shape[0], a.shape[-1]
    out = a.to(dt).reshape(L, -1, F) @ w.to(dt)
    return out.reshape(*a.shape[:-1], w.shape[-1])


def merge_shard_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Top-k over (shard-ordered) candidate lists. Candidates within a
    shard are index-ascending among ties and shards concatenate in
    ascending-window order, so the stable top-k here breaks ties as a
    global top-k does."""
    k = min(k, vals.shape[-1])
    top_v, pos = topk_stable(vals, k)
    return top_v, torch.gather(idx, -1, pos.long())


def _span_pages(start, n_valid, S: int, page: int, P: int, tok_lo: int,
                tok_hi: int):
    """[Bg, S] (clipped window page of each span token, live mask)."""
    ar = torch.arange(S, device=start.device)
    gpos = start.long()[:, None] + ar[None, :]
    valid = ((ar[None, :] < n_valid.long()[:, None])
             & (gpos >= tok_lo) & (gpos < tok_hi))
    return ((gpos - tok_lo) // page).clamp(0, P - 1), valid


# ---------------------------------------------------------------------------
# shared per-page SUM summary (dsa indexer projections / seer gate
# projections differ only in page size and projection-weight key)
# ---------------------------------------------------------------------------


def _sum_summary(key: str, weight: str, page: int, L: int, n_slots: int,
                 P: int, di: int, tok_lo: int, device):
    """(summary_init, reset, ingest, ingest_span) for a summary that holds,
    per logical page of the window [tok_lo, tok_lo + P*page), the SUM of
    ``k @ sp[weight]`` over its live tokens. Tokens outside the window add
    an exact zero."""
    tok_hi = tok_lo + P * page

    def summary_init():
        return {key: torch.zeros((L, n_slots, P, di), dtype=torch.float32,
                                 device=device)}

    def reset(s, slot_ids):
        out = s[key].clone()
        out[:, slot_ids.long()] = 0.0
        return {key: out}

    def _contrib(sp, k):  # [L, ..., KV, hd] -> [L, ..., di] fp32
        return _promoted_bmm(k.reshape(*k.shape[:-2], -1),
                             sp[weight]).float()

    def ingest(s, sp, k_new, pos, live):
        B = pos.shape[0]
        pos = pos.long()
        own = live.bool() & (pos >= tok_lo) & (pos < tok_hi)
        c = _contrib(sp, k_new) * own.float()[None, :, None]
        pages = ((pos - tok_lo) // page).clamp(0, P - 1)
        b = torch.arange(B, device=pos.device)
        out = s[key].clone()
        out[:, b, pages] += c            # one (slot, page) per row
        return {key: out}

    def ingest_span(s, sp, k_span, slot_ids, start, n_valid):
        Lk, Bg, S = k_span.shape[:3]
        pages, valid = _span_pages(start, n_valid, S, page, P, tok_lo,
                                   tok_hi)
        c = _contrib(sp, k_span) * valid[None, :, :, None].float()
        lidx = torch.arange(Lk, device=c.device)[:, None, None]
        sidx = slot_ids.long()[None, :, None]
        out = s[key].clone()
        # tokens of one page accumulate in span order, as the reference's
        # scatter-add does
        out.index_put_((lidx, sidx, pages[None]), c, accumulate=True)
        return {key: out}

    return summary_init, reset, ingest, ingest_span


# ---------------------------------------------------------------------------
# dsa: lightning-indexer micro-page sums
# ---------------------------------------------------------------------------


def _dsa(cfg: ArchConfig, mem: MemoryConfig, page: int, n_slots: int,
         max_len: int, window: Optional[Tuple[int, int]], device
         ) -> OffloadSelect:
    tok_lo, n_tok = window or (0, max_len)
    P = n_tok // page
    n_sel = min(max(mem.top_k // page, 1), max_len // page)
    n_part = min(n_sel, P)
    L = cfg.n_layers
    di = mem.index_dim
    n_in = cfg.n_heads * cfg.hd
    summary_init, reset, ingest, ingest_span = _sum_summary(
        "kidx_sum", "wk_idx", page, L, n_slots, P, di, tok_lo, device)

    def select_partial(sp, s, q_layers, lengths):
        qf = _qf_layers(q_layers, n_in)
        q_idx = _promoted_bmm(qf, sp["wq_idx"])
        q_idx = q_idx.reshape(*q_idx.shape[:2], -1, di).float()
        w = torch.softmax(_promoted_bmm(qf.float(), sp["w_wgt"]), dim=-1)
        kp = s["kidx_sum"] * (1.0 / page)        # page means [L, B, P, di]
        dots = torch.einsum("lbhd,lbpd->lbhp", q_idx, kp)
        scores = torch.einsum("lbh,lbhp->lbp", w.float(), torch.relu(dots))
        scores = torch.where(_win_mask(P, page, tok_lo, lengths), scores,
                             torch.full_like(scores, NEG_INF))
        vals, idx = topk_stable(scores, n_part)
        return vals, (idx + tok_lo // page).to(torch.int32)

    def finalize(vals, idx, lengths):
        top_v, top_i = merge_shard_topk(vals, idx, n_sel)
        return torch.where(top_v > NEG_INF / 2, top_i,
                           torch.full_like(top_i, -1)).to(torch.int32)

    def select(sp, s, q_layers, lengths):
        return finalize(*select_partial(sp, s, q_layers, lengths), lengths)

    return OffloadSelect("dsa", page, n_sel, P, summary_init, reset, ingest,
                         ingest_span, select, select_partial, finalize,
                         n_part, tok_lo, n_tok)


# ---------------------------------------------------------------------------
# seer: gate-projected block sums (+ threshold selection)
# ---------------------------------------------------------------------------


def _seer(cfg: ArchConfig, mem: MemoryConfig, n_slots: int, max_len: int,
          window: Optional[Tuple[int, int]], device) -> OffloadSelect:
    bs = mem.block_size
    tok_lo, n_tok = window or (0, max_len)
    P = n_tok // bs
    n_sel = min(max(mem.token_budget // bs, 1), max_len // bs)
    n_part = min(n_sel, P)
    L = cfg.n_layers
    di = mem.index_dim
    n_in = cfg.n_heads * cfg.hd
    summary_init, reset, ingest, ingest_span = _sum_summary(
        "kgate_sum", "wk_gate", bs, L, n_slots, P, di, tok_lo, device)

    def select_partial(sp, s, q_layers, lengths):
        qf = _qf_layers(q_layers, n_in)
        q_gate = _promoted_bmm(qf, sp["wq_gate"]).float()
        k_blk = s["kgate_sum"] * (1.0 / bs)                # block means
        scores = torch.relu(torch.einsum("lbd,lbpd->lbp", q_gate, k_blk))
        scores = torch.where(_win_mask(P, bs, tok_lo, lengths), scores,
                             torch.full_like(scores, NEG_INF))
        vals, idx = topk_stable(scores, n_part)
        return vals, (idx + tok_lo // bs).to(torch.int32)

    def finalize(vals, idx, lengths):
        top_v, top_i = merge_shard_topk(vals, idx, n_sel)
        out = torch.where(top_v > NEG_INF / 2, top_i,
                          torch.full_like(top_i, -1))
        if mem.selection == "threshold":
            probs = torch.softmax(top_v, dim=-1)
            out = torch.where(probs >= mem.threshold, out,
                              torch.full_like(out, -1))
        return out.to(torch.int32)

    def select(sp, s, q_layers, lengths):
        return finalize(*select_partial(sp, s, q_layers, lengths), lengths)

    return OffloadSelect("seer", bs, n_sel, P, summary_init, reset, ingest,
                         ingest_span, select, select_partial, finalize,
                         n_part, tok_lo, n_tok)


# ---------------------------------------------------------------------------
# lserve: per-page channel min/max bounds, physical-page grouping
# ---------------------------------------------------------------------------


def _lserve(cfg: ArchConfig, mem: MemoryConfig, n_slots: int, max_len: int,
            window: Optional[Tuple[int, int]], device) -> OffloadSelect:
    ps = mem.block_size
    ppp = mem.pages_per_physical
    tok_lo, n_tok = window or (0, max_len)
    P = n_tok // ps
    Pphys = max(P // ppp, 1)
    Pphys_full = max(max_len // ps // ppp, 1)
    n_phys = min(max(mem.token_budget // (ps * ppp), 1), Pphys_full)
    n_sel = n_phys * ppp
    n_part = min(n_phys, Pphys)               # candidates are PHYSICAL pages
    if P % ppp or tok_lo % (ps * ppp):
        raise ValueError("lserve windows must align to physical-page groups")
    L = cfg.n_layers
    kv, hd = cfg.n_kv_heads, cfg.hd
    tok_hi = tok_lo + n_tok

    def summary_init():
        shape = (L, n_slots, P, kv, hd)
        return {"pmin": torch.full(shape, BIG, dtype=torch.float32,
                                   device=device),
                "pmax": torch.full(shape, -BIG, dtype=torch.float32,
                                   device=device)}

    def reset(s, slot_ids):
        pmin, pmax = s["pmin"].clone(), s["pmax"].clone()
        pmin[:, slot_ids.long()] = BIG
        pmax[:, slot_ids.long()] = -BIG
        return {"pmin": pmin, "pmax": pmax}

    def ingest(s, sp, k_new, pos, live):
        B = pos.shape[0]
        pos = pos.long()
        kf = k_new.float()
        own = live.bool() & (pos >= tok_lo) & (pos < tok_hi)
        m = own[None, :, None, None]
        lo = torch.where(m, kf, torch.full_like(kf, BIG))
        hi = torch.where(m, kf, torch.full_like(kf, -BIG))
        pages = ((pos - tok_lo) // ps).clamp(0, P - 1)
        b = torch.arange(B, device=pos.device)
        pmin, pmax = s["pmin"].clone(), s["pmax"].clone()
        pmin[:, b, pages] = torch.minimum(pmin[:, b, pages], lo)
        pmax[:, b, pages] = torch.maximum(pmax[:, b, pages], hi)
        return {"pmin": pmin, "pmax": pmax}

    def ingest_span(s, sp, k_span, slot_ids, start, n_valid):
        Lk, Bg, S = k_span.shape[:3]
        kf = k_span.float()
        pages, valid = _span_pages(start, n_valid, S, ps, P, tok_lo, tok_hi)
        v = valid[None, :, :, None, None]
        lo = torch.where(v, kf, torch.full_like(kf, BIG))
        hi = torch.where(v, kf, torch.full_like(kf, -BIG))
        # (slot, page) flattened: one index per span token
        flat = (slot_ids.long()[:, None] * P + pages).reshape(-1)
        idx = flat[None, :, None, None].expand(Lk, Bg * S, kv, hd)
        out = {}
        for name, src, red in (("pmin", lo, "amin"), ("pmax", hi, "amax")):
            t = s[name].clone()
            t.view(Lk, n_slots * P, kv, hd).scatter_reduce_(
                1, idx, src.reshape(Lk, Bg * S, kv, hd), red)
            out[name] = t
        return out

    def select_partial(sp, s, q_layers, lengths):
        # reduce the kv-head axis for the bound (as the inline path does)
        pmin = s["pmin"].amax(dim=3)                       # [L, B, P, hd]
        pmax = s["pmax"].amax(dim=3)
        qf = q_layers.float()[:, :, :, None, :]            # [L,B,Hp,1,hd]
        pm = torch.maximum(qf * pmin[:, :, None], qf * pmax[:, :, None])
        sc = pm.sum(-1).mean(dim=2)                        # [L, B, P]
        sc = torch.where(_win_mask(P, ps, tok_lo, lengths), sc,
                         torch.full_like(sc, NEG_INF))
        phys = sc.reshape(*sc.shape[:2], Pphys, ppp).amax(-1)
        vals, pidx = topk_stable(phys, n_part)             # [L, B, n_part]
        return vals, (pidx + tok_lo // (ps * ppp)).to(torch.int32)

    def finalize(vals, idx, lengths):
        top_v, top_i = merge_shard_topk(vals, idx, n_phys)
        ar = torch.arange(ppp, device=top_i.device)
        logical = (top_i.long()[..., None] * ppp + ar).reshape(
            *top_i.shape[:2], -1)                           # [L, B, n_sel]
        ok = (top_v > NEG_INF / 2)[..., None].expand(*top_v.shape, ppp)
        live = ((logical * ps < lengths.long()[None, :, None])
                & ok.reshape(logical.shape))
        return torch.where(live, logical,
                           torch.full_like(logical, -1)).to(torch.int32)

    def select(sp, s, q_layers, lengths):
        return finalize(*select_partial(sp, s, q_layers, lengths), lengths)

    return OffloadSelect("lserve", ps, n_sel, P, summary_init, reset, ingest,
                         ingest_span, select, select_partial, finalize,
                         n_part, tok_lo, n_tok)


# ---------------------------------------------------------------------------


def make_offload_select(method: str, cfg: ArchConfig, mem: MemoryConfig, *,
                        dsa_page: int, n_slots: int, max_len: int,
                        corpus=None, mac=None, rag_k: int = 4,
                        capacity: int = 0,
                        window: Optional[Tuple[int, int]] = None,
                        device="cuda") -> OffloadSelect:
    """One bundle per OFFLOAD_STAGES declarer. The sparse-attention family
    (dsa / seer / lserve) keeps KV-page summaries on ``device``; the
    document-memory family (rag / mac, built by
    ``retrieval.select.make_retrieval_select``) keeps the corpus store or
    the per-slot banks: the same protocol over other state. ``corpus`` /
    ``mac`` configure the retrieval builders and are ignored by the sparse
    ones; ``window=(tok_lo, n_tok)`` builds a sparse bundle over one
    KV-sequence shard."""
    dev = resolve_device(device)
    builders: Dict[str, Callable] = {
        "dsa": lambda: _dsa(cfg, mem, dsa_page, n_slots, max_len, window,
                            dev),
        "seer": lambda: _seer(cfg, mem, n_slots, max_len, window, dev),
        "lserve": lambda: _lserve(cfg, mem, n_slots, max_len, window, dev),
    }
    if method in ("rag", "mac"):
        if window is not None:
            raise ValueError("document-memory bundles do not shard")
        from repro_torch.retrieval.select import make_retrieval_select
        return make_retrieval_select(method, cfg, n_slots=n_slots,
                                     corpus=corpus, mac=mac, k=rag_k,
                                     capacity=capacity, device=dev)
    if method not in builders:
        raise KeyError(f"method {method!r} has no offload-side selection: "
                       f"{sorted(builders) + ['rag', 'mac']}")
    return builders[method]()
