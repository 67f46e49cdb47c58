"""Deterministic synthetic data (twin of ``repro.data.pipeline``).

* ``TokenStream`` — seeded Zipf-ish token sequences with local structure
  (Markov bigram mixing) so losses decrease measurably in smoke training;
  per-host sharding by (host_index, num_hosts). Batches are numpy arrays.
* ``pack_documents`` — greedy packing of documents into fixed-length rows.
* ``build_corpus`` / ``sample_queries`` — the synthetic retrieval corpus of
  the RAG methods.

Every function makes the reference's numpy RNG calls in the reference's
order, so one seed gives bit-identical arrays on either side.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    host_index: int = 0
    num_hosts: int = 1
    zipf_a: float = 1.2

    def __post_init__(self):
        self._rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_index]))
        v = self.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = ranks ** (-self.zipf_a)
        self._probs /= self._probs.sum()
        # bigram structure: token t prefers (t*7+3) % v next — learnable signal
        self._next = (np.arange(v) * 7 + 3) % v

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        B, S, v = self.batch_size, self.seq_len, self.vocab_size
        base = self._rng.choice(v, size=(B, S), p=self._probs)
        toks = base.copy()
        # 60% of positions follow the deterministic bigram of the previous tok
        follow = self._rng.random((B, S)) < 0.6
        toks[:, 1:] = np.where(follow[:, 1:], self._next[toks[:, :-1]],
                               base[:, 1:])
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = toks[:, 0]
        return {"tokens": toks.astype(np.int32),
                "labels": labels.astype(np.int32)}


def pack_documents(docs, seq_len: int, pad_id: int = 0) -> np.ndarray:
    """Greedy packing of variable-length docs into fixed seq_len rows."""
    rows, cur = [], []
    for d in docs:
        d = list(d)
        while d:
            space = seq_len - len(cur)
            cur.extend(d[:space])
            d = d[space:]
            if len(cur) == seq_len:
                rows.append(cur)
                cur = []
    if cur:
        rows.append(cur + [pad_id] * (seq_len - len(cur)))
    return np.asarray(rows, dtype=np.int32)


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
