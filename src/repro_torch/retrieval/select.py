"""Offload-side retrieval implementations for the document-memory family
(twin of ``repro.retrieval.select``).

RAG and MaC declare ``OFFLOAD_STAGES = (prepare, relevancy, retrieve)``
like the sparse-attention methods (paper Table 1 rows 4-6 and 8, Fig. 6b/c
data placement), but their offload-resident state is not a KV-page summary:

  rag : the corpus index (TF stats, document lengths, running document
        frequencies / IDF, doc token payloads, optional doc embeddings),
        capacity-padded so documents are appended incrementally in blocks
        of a fixed size;
  mac : per-slot Titans/HMT memory banks, FIFO segment-summary embeddings
        plus live counts.

Both are ``hetero.select.OffloadSelect`` bundles, the type the
sparse-attention bundles share. The callables keep the reference's roles
and signatures; the stateful wrappers that place them on a device and a
stream are ``retrieval.service`` and ``retrieval.bank``.

Where the reference returns a new state, rag's ``ingest`` writes the
doc-axis arrays of the store in place (the reference's jitted update copies
nothing either once donated; here no copy of the 1 GB term-frequency store
is made per block) and returns a dict holding the same tensors with new
``df`` / ``idf`` / ``n_docs``. mac's ``ingest`` and ``reset`` build new
bank tensors, as the reference does, so a query in flight keeps the bank it
was launched on.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.methods.mac import (MacConfig, compute_relevancy,
                                          prepare_memory)
from repro_torch.core.methods.rag import Corpus, idf_from_df
from repro_torch.hetero.select import OffloadSelect
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L

NEG_INF = -1e30


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _bm25_panel(s, terms):
    """Gather the query's term panel from the store state: (tfq [B, C, T],
    idf [B, T], dl/avgdl [B, C]). The running avgdl is folded into the doc
    lengths on the device, so scoring takes avgdl = 1 whatever the live
    count."""
    B, cap = terms.shape[0], s["doc_len"].shape[0]
    q = terms.long()
    tfq = s["tf"][:, q].permute(1, 0, 2).float()
    idf = s["idf"][q]
    dl = s["doc_len"][None].expand(B, cap)
    avgdl = s["doc_len"].sum() / torch.clamp(s["n_docs"].float(), min=1.0)
    return tfq, idf, dl / avgdl


# ---------------------------------------------------------------------------
# rag: corpus index with incremental ingest + fused BM25 selection
# ---------------------------------------------------------------------------


def _rag(corpus: Corpus, *, k: int, capacity: int = 0,
         ingest_block: int = 64):
    """RAG OffloadSelect. Signatures (B = queries, C = capacity):

      summary_init()                    -> corpus state (capacity-padded)
      reset(s, slot_ids)                -> s (corpus is global; identity)
      ingest(s, tf, dl, toks, emb, m)   -> s with ``m`` new docs appended
                                           (ingest_block rows; rows >= m
                                           must be zero)
      select(sp, s, terms [B, T])       -> (scores [B, k], doc_ids [B, k])

    ``sp`` is unused (BM25 has no learned parameters), kept for the
    reference's signature.
    """
    D0, Vr = corpus.tf.shape
    C = max(capacity or _next_pow2(D0), _next_pow2(D0))
    de = 0 if corpus.doc_embeds is None else corpus.doc_embeds.shape[1]
    mb = ingest_block

    def pad_rows(x, pad):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    def summary_init():
        pad = C - D0
        dev = corpus.tf.device
        df = (corpus.tf > 0).sum(dim=0).to(torch.int32)
        n_docs = torch.tensor(D0, dtype=torch.int32, device=dev)
        s = {
            "tf": pad_rows(corpus.tf, pad),
            "doc_len": pad_rows(corpus.doc_len.float(), pad),
            "doc_tokens": pad_rows(corpus.doc_tokens, pad),
            "df": df,
            "idf": idf_from_df(df, n_docs),
            "n_docs": n_docs,
        }
        if de:
            s["doc_embeds"] = pad_rows(corpus.doc_embeds, pad)
        return s

    def reset(s, slot_ids):
        return s

    def ingest(s, tf_new, dl_new, toks_new, emb_new, m: int):
        """Append up to ``ingest_block`` docs at the live watermark: a
        masked scatter-add onto rows that are zero by the pad invariant
        (add == set), pad rows clipped to the last row of the store where
        they add zero, so a final partial block near the capacity never
        writes out of bounds and the store grows only when the LIVE docs
        overflow it."""
        start = s["n_docs"]
        cap = s["doc_len"].shape[0]
        ar = torch.arange(mb, device=start.device)
        live = ar < m
        rows = torch.clamp(start + ar, 0, cap - 1).long()
        tf_new = tf_new * live[:, None]
        s["tf"].index_put_((rows,), tf_new, accumulate=True)
        s["doc_len"].index_put_((rows,), dl_new * live, accumulate=True)
        s["doc_tokens"].index_put_((rows,), toks_new * live[:, None],
                                   accumulate=True)
        if de:
            s["doc_embeds"].index_put_((rows,), emb_new * live[:, None],
                                       accumulate=True)
        out = dict(s)
        out["df"] = s["df"] + (tf_new > 0).sum(dim=0).to(torch.int32)
        out["n_docs"] = start + m
        out["idf"] = idf_from_df(out["df"], out["n_docs"])
        return out

    def select(sp, s, terms):
        tfq, idf, dln = _bm25_panel(s, terms)
        return ops.bm25_topk(tfq, dln, idf, k, block=min(4096, dln.shape[1]),
                             avgdl=1.0, valid=s["n_docs"])

    return OffloadSelect("rag", 1, k, C, summary_init, reset, ingest,
                         None, select)


def rag_hybrid_scores(s, terms, q_embed, alpha: float = 0.5):
    """Two-stage first pass on the store state: live-masked z-scored BM25 +
    dense-embedding hybrid (paper Table 1 row 5). -> [B, C]."""
    C = s["tf"].shape[0]
    tfq, idf, dln = _bm25_panel(s, terms)
    lex = kref.bm25_scores(tfq, dln, idf, avgdl=1.0)
    sem = q_embed.float() @ s["doc_embeds"].float().T            # [B, C]
    live = (torch.arange(C, device=lex.device)[None]
            < s["n_docs"]).float()
    n = torch.clamp(live.sum(-1, keepdim=True), min=1.0)

    def z(x):
        x = x * live
        mu = x.sum(-1, keepdim=True) / n
        var = (((x - mu) * live) ** 2).sum(-1, keepdim=True) / n
        return (x - mu) / (torch.sqrt(var) + 1e-6)

    mix = alpha * z(lex) + (1 - alpha) * z(sem)
    return torch.where(live > 0, mix, torch.full_like(mix, NEG_INF))


# ---------------------------------------------------------------------------
# mac: per-slot FIFO memory banks of segment-summary embeddings
# ---------------------------------------------------------------------------


def _mac(cfg: ArchConfig, mc: MacConfig, n_slots: int, device):
    """MaC OffloadSelect. Signatures:

      summary_init()                     -> {bank [n_slots, M, d], count}
      reset(s, slot_ids)                 -> s with those banks cleared
      ingest(s, sp, slot, seg_tokens)    -> s with the segment summary
                                            FIFO-pushed into ``slot``'s bank
      select(sp, s, q_tokens [W], slot)  -> (idx [r], embeds [r, d])

    ``sp = {"embed": token embedding params, "mac": mac_init params}``:
    segment summaries and relevancy queries are computed from token
    embeddings on the retrieval device, so only token-id windows go down
    and only [r, d] retrieved embeddings come back (paper Fig. 6c).
    """
    M, r, d = mc.memory_slots, mc.retrieve_k, cfg.d_model
    if mc.mode != "topk":
        raise ValueError("the serving bank supports topk retrieval")

    def summary_init():
        return {"bank": torch.zeros((n_slots, M, d), dtype=torch.float32,
                                    device=device),
                "count": torch.zeros((n_slots,), dtype=torch.int32,
                                     device=device)}

    def reset(s, slot_ids):
        bank, count = s["bank"].clone(), s["count"].clone()
        bank[slot_ids] = 0.0
        count[slot_ids] = 0
        return {"bank": bank, "count": count}

    def ingest(s, sp, slot: int, seg_tokens):
        emb = L.embed(sp["embed"], seg_tokens[None])        # [1, S, d]
        memv = prepare_memory(sp["mac"], emb)[0]            # [d]
        bank, count = s["bank"].clone(), s["count"].clone()
        bank[slot] = torch.roll(s["bank"][slot], -1, dims=0)
        bank[slot, -1] = memv
        count[slot] = torch.clamp(count[slot] + 1, max=M)
        return {"bank": bank, "count": count}

    def select(sp, s, q_tokens, slot: int):
        emb = L.embed(sp["embed"], q_tokens[None])          # [1, W, d]
        row = s["bank"][slot][None]                         # [1, M, d]
        scores = compute_relevancy(sp["mac"], emb, row)     # [1, M]
        live = torch.arange(M, device=scores.device)[None] < s["count"][slot]
        masked = torch.where(live, scores, torch.full_like(scores, NEG_INF))
        vals, idx = kref.topk_stable(masked, r)
        got = torch.gather(row, 1, idx.long()[..., None].expand(-1, -1, d))
        idx = torch.where(vals > NEG_INF / 2, idx, torch.full_like(idx, -1))
        return idx[0], got[0]

    return OffloadSelect("mac", mc.segment_len, r, M, summary_init, reset,
                         ingest, None, select)


# ---------------------------------------------------------------------------


def make_retrieval_select(method: str, cfg: Optional[ArchConfig] = None, *,
                          n_slots: int = 0, corpus: Optional[Corpus] = None,
                          mac: Optional[MacConfig] = None, k: int = 4,
                          capacity: int = 0, ingest_block: int = 64,
                          device="cuda"):
    """The rag or mac bundle. ``device`` places mac's bank (rag's store
    follows its corpus); it defaults to the card and raises without one."""
    if method == "rag":
        if corpus is None:
            raise ValueError("rag offload selection needs a corpus")
        return _rag(corpus, k=k, capacity=capacity,
                    ingest_block=ingest_block)
    if method == "mac":
        if cfg is None or mac is None or n_slots <= 0:
            raise ValueError("mac offload selection needs (cfg, mac config, "
                             "n_slots)")
        return _mac(cfg, mac, n_slots, resolve_device(device))
    raise KeyError(f"method {method!r} has no retrieval-side selection")
