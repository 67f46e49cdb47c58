"""Synthetic retrieval corpus for RAG (twin of ``repro.data.pipeline``'s
``build_corpus`` and ``sample_queries``; the token stream and packing wait
for ROADMAP Queue 1 item 14).

Both functions make the reference's numpy RNG calls in the reference's
order, so one seed gives bit-identical arrays on either side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def build_corpus(n_docs: int, retrieval_vocab: int = 2048,
                 doc_max: int = 64, gen_vocab: int = 32000,
                 embed_dim: int = 0, seed: int = 0, device="cuda"):
    """Synthetic Zipf corpus (doc-term frequency matrix, doc lengths, IDF,
    doc token payloads, optional doc embeddings), matching the
    computational shape of the paper's Wikipedia BM25 setup. Returns a
    ``core.methods.rag.Corpus`` on ``device``."""
    from repro_torch.core.methods.rag import Corpus

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lens = rng.integers(doc_max // 4, doc_max, size=n_docs)
    ranks = np.arange(1, retrieval_vocab + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    tf = np.zeros((n_docs, retrieval_vocab), np.int32)
    doc_tokens = np.zeros((n_docs, doc_max), np.int32)
    for i in range(n_docs):
        terms = rng.choice(retrieval_vocab, size=lens[i], p=p)
        np.add.at(tf[i], terms, 1)
        doc_tokens[i, : lens[i]] = terms % gen_vocab
    df = (tf > 0).sum(axis=0)
    idf = np.log((n_docs - df + 0.5) / (df + 0.5) + 1.0).astype(np.float32)
    emb = None
    if embed_dim:
        emb = rng.standard_normal((n_docs, embed_dim)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    to = lambda a: torch.from_numpy(a).to(dev)
    return Corpus(tf=to(tf), doc_len=to(lens.astype(np.float32)),
                  idf=to(idf), doc_tokens=to(doc_tokens),
                  doc_embeds=None if emb is None else to(emb))


def sample_queries(corpus, batch: int, n_terms: int,
                   seed: int = 0) -> torch.Tensor:
    """Query term ids [batch, n_terms] int32 on the corpus's device, biased
    toward corpus terms (so BM25 has signal)."""
    rng = np.random.default_rng(seed)
    vocab = corpus.tf.shape[1]
    docs = rng.integers(0, corpus.tf.shape[0], size=batch)
    # only the sampled docs' rows come to the host
    rows = corpus.tf[torch.as_tensor(docs, device=corpus.tf.device)].cpu()
    out = np.zeros((batch, n_terms), np.int32)
    for i in range(batch):
        terms = np.flatnonzero(rows[i].numpy())
        if len(terms) >= n_terms:
            out[i] = rng.choice(terms, size=n_terms, replace=False)
        else:
            out[i] = rng.integers(0, vocab, size=n_terms)
    return torch.from_numpy(out).to(corpus.tf.device)
