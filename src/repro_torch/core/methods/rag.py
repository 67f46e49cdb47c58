"""RAG (twin of ``repro.core.methods.rag``), paper Table 1 rows 4-6
(two-stage, fixed-sentence, dynamic).

  prepare   corpus indexing: term-frequency stats + doc embeddings
            (one-time, amortized; paper §3.1)
  relevancy BM25 (single-stage) or hybrid BM25 + embedding then a
            cross-encoder reranker (two-stage)
  retrieve  top-k documents
  apply     append the retrieved documents to the query (no FLOPs)

Dynamic-RAG trigger policies (DRAGIN-style attention uncertainty,
FLARE-style confidence) run over the generator's decode logits.

The query's term columns are gathered once into a dense [B, D, T] panel in
plain torch; the fused BM25 kernel (``kernels.ops.bm25_topk``) then scores
and keeps the top-k. Every top-k breaks ties by ascending index
(``ref.topk_stable``), as the reference's ``lax.top_k`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.pipeline import MemoryPipeline
from repro_torch.kernels import ops, ref as kref

# Hetero offload metadata: the document index (TF stats, embeddings) lives
# with the retrieval engine; apply is pure prompt assembly on the generator.
OFFLOAD_STAGES = ("prepare", "relevancy", "retrieve")


@dataclasses.dataclass
class Corpus:
    """Dense retrieval-side corpus statistics (synthetic Zipf, data/)."""

    tf: torch.Tensor          # [D, Vr] term frequencies (int32)
    doc_len: torch.Tensor     # [D]
    idf: torch.Tensor         # [Vr]
    doc_tokens: torch.Tensor  # [D, doc_max] generator-vocab token ids
    doc_embeds: Optional[torch.Tensor] = None  # [D, de] (two-stage)

    @property
    def n_docs(self) -> int:
        return self.tf.shape[0]

    @property
    def avgdl(self) -> float:
        return float(torch.mean(self.doc_len.float()))


def idf_from_df(df, n_docs):
    """BM25 idf from document frequencies (the one smoothing formula, shared
    by corpus building, slicing and the serving store's running refresh).
    ``n_docs`` is an int or a tensor on ``df``'s device."""
    df = torch.as_tensor(df)
    nf = torch.as_tensor(n_docs, device=df.device).float()
    dff = df.float()
    return torch.log((nf - dff + 0.5) / (dff + 0.5) + 1.0)


def corpus_slice(corpus: Corpus, lo: int, hi: int) -> Corpus:
    """Row slice [lo, hi) as a standalone Corpus: the unit of incremental
    ingest into ``retrieval.RetrievalService`` (its store recomputes df/idf
    over the running corpus, so the slice's own idf is only local)."""
    tf = corpus.tf[lo:hi]
    idf = idf_from_df((tf > 0).sum(dim=0), tf.shape[0])
    return Corpus(
        tf=tf, doc_len=corpus.doc_len[lo:hi], idf=idf,
        doc_tokens=corpus.doc_tokens[lo:hi],
        doc_embeds=None if corpus.doc_embeds is None
        else corpus.doc_embeds[lo:hi])


def gather_term_panel(corpus: Corpus, query_terms: torch.Tensor):
    """query_terms [B, T] -> (tf_panel [B, D, T] fp32, idf [B, T]).

    The one irregular gather, kept outside the kernel."""
    q = query_terms.long()
    tfq = corpus.tf[:, q].permute(1, 0, 2).float()     # [D,B,T] -> [B,D,T]
    return tfq, corpus.idf[q]


def _doc_len_rows(corpus: Corpus, B: int):
    return corpus.doc_len.float()[None].expand(B, corpus.n_docs)


def bm25_retrieve(corpus: Corpus, query_terms: torch.Tensor, k: int,
                  *, fused: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores [B,k], doc_ids [B,k])."""
    tfq, idf = gather_term_panel(corpus, query_terms)
    B, D, _ = tfq.shape
    dl = _doc_len_rows(corpus, B)
    if fused:
        return ops.bm25_topk(tfq, dl, idf, k, block=min(4096, D),
                             avgdl=corpus.avgdl)
    return kref.bm25_topk(tfq, dl, idf, k, avgdl=corpus.avgdl)


def hybrid_retrieve(corpus: Corpus, query_terms: torch.Tensor,
                    query_embed: torch.Tensor, n_first: int,
                    alpha: float = 0.5):
    """Two-stage first pass: BM25 + dense-embedding hybrid -> top-N.
    z-scores use the population standard deviation, as ``jnp.std``."""
    tfq, idf = gather_term_panel(corpus, query_terms)
    B = tfq.shape[0]
    lex = kref.bm25_scores(tfq, _doc_len_rows(corpus, B), idf,
                           avgdl=corpus.avgdl)
    sem = query_embed.float() @ corpus.doc_embeds.float().T      # [B, D]

    def z(s):
        return (s - s.mean(-1, keepdim=True)) / (
            s.std(-1, keepdim=True, unbiased=False) + 1e-6)

    return kref.topk_stable(alpha * z(lex) + (1 - alpha) * z(sem), n_first)


def rerank(score_fn, corpus: Corpus, query_tokens: torch.Tensor,
           cand_ids: torch.Tensor, k: int):
    """Cross-encoder second stage. score_fn(query_tokens, doc_tokens) ->
    [B, N]."""
    docs = corpus.doc_tokens[cand_ids.long()]           # [B, N, doc_max]
    top, pos = kref.topk_stable(score_fn(query_tokens, docs), k)
    return top, torch.gather(cand_ids, 1, pos.long())


def append_to_query(corpus: Corpus, query_tokens: torch.Tensor,
                    doc_ids: torch.Tensor, max_len: int):
    """Apply-to-inference: concat retrieved docs before the query (no
    math)."""
    B = doc_ids.shape[0]
    docs = corpus.doc_tokens[doc_ids.long()].reshape(B, -1)
    out = torch.cat([docs, query_tokens.to(docs.dtype)], dim=1)
    return out[:, -max_len:] if out.shape[1] > max_len else out


# --- dynamic-RAG trigger policies over generator logits --------------------


def flare_trigger(logits: torch.Tensor, tau: float = 0.4) -> torch.Tensor:
    """FLARE: retrieve when token confidence drops below tau. [B,V] -> [B]."""
    p = torch.softmax(logits.float(), dim=-1)
    return p.amax(dim=-1) < tau


def dragin_trigger(logits: torch.Tensor, attn_entropy: torch.Tensor,
                   tau: float = 2.0) -> torch.Tensor:
    """DRAGIN: information need = token entropy weighted by the attention
    statistics of the pending token."""
    p = torch.softmax(logits.float(), dim=-1)
    ent = -(p * torch.log(p + 1e-9)).sum(-1)
    return ent * torch.clamp(attn_entropy, min=1e-3) > tau


def build_pipeline(corpus: Corpus, k: int, *, fused: bool = False,
                   max_len: int = 4096) -> MemoryPipeline:
    """Four-stage descriptor over (memory = corpus stats, query = term
    ids); ``fused`` runs relevancy + retrieve in the BM25 kernel."""

    def prepare(M):
        return M  # corpus indexing is one-time/amortized; identity at runtime

    def relevancy(I, q):
        tfq, idf = gather_term_panel(corpus, q)
        B, D, _ = tfq.shape
        dl = _doc_len_rows(corpus, B)
        if fused:
            _, ids = ops.bm25_topk(tfq, dl, idf, k, block=min(4096, D),
                                   avgdl=corpus.avgdl)
            return ("fused", ids)
        return ("scores", kref.bm25_scores(tfq, dl, idf, avgdl=corpus.avgdl))

    def retrieve(M, S):
        tag, val = S
        if tag == "fused":
            return val
        return kref.topk_stable(val, k)[1]

    def apply(doc_ids, q):
        return corpus.doc_tokens[doc_ids.long()]

    return MemoryPipeline(
        name="rag-fused" if fused else "rag",
        prepare=prepare, relevancy=relevancy, retrieve=retrieve, apply=apply,
        fused={"relevancy": ("relevancy", "retrieve")} if fused else {},
    )
