"""RAG document-memory service (twin of ``repro.retrieval.service``).

``RetrievalService`` hosts the corpus index (TF stats, IDF, doc lengths,
embeddings, doc token payloads) as capacity-padded tensors on one device
and answers term-id queries with the fused BM25 kernel there. Only
``[B, k]`` doc ids come back (index-only exchange); the doc token spans the
generator splices are assembled from a host-side token mirror and counted
apart as span traffic.

Streams. With ``side_stream=True`` on a CUDA device the service owns a
``torch.cuda.Stream``: ``query`` and ``ingest`` are enqueued there after the
stream waits on the caller's stream, each query records an event, and
``collect`` makes the caller's stream wait on that event before the ids
come to the host. Without it (the inline mode, or any CPU tensor) the work
runs on the caller's stream in program order.

Incremental ingest appends documents in blocks of ``ingest_block`` rows,
writing the store in place (see ``select._rag``): no store tensor is
reallocated while the capacity holds; when it does not, the capacity
doubles. Each query handle holds the gathered term panel and live count it
was scored from, so ``replay`` re-scores exactly what the query saw even if
an ingest has written the store since.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.methods.rag import Corpus
from repro_torch.hetero.transfer import TransferLedger
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.retrieval.select import (_bm25_panel, make_retrieval_select,
                                          rag_hybrid_scores)


class SideStream:
    """The CUDA stream a retrieval service enqueues its work on, or nothing
    (caller's stream) on the CPU or when not asked for."""

    def __init__(self, device: torch.device, enabled: bool):
        self.device = device
        self.stream = (torch.cuda.Stream(device)
                       if enabled and device.type == "cuda" else None)

    def enter(self):
        """Context for work on the side stream, ordered after the caller's
        stream's work so far."""
        if self.stream is None:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    def record(self) -> Optional[torch.cuda.Event]:
        """An event after the work enqueued so far (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream if self.stream is not None
                  else torch.cuda.current_stream(self.device))
        return ev

    @staticmethod
    def wait_host(event) -> None:
        """Block the host until ``event`` (a query's) has completed."""
        if event is not None:
            event.synchronize()

    @staticmethod
    def join(event, device) -> None:
        """Order the caller's stream on ``device`` after ``event``."""
        if event is not None:
            torch.cuda.current_stream(device).wait_event(event)


class RetrievalService:
    def __init__(self, corpus: Corpus, *, k: int, device="cuda",
                 capacity: int = 0, ingest_block: int = 64,
                 ledger: Optional[TransferLedger] = None,
                 side_stream: bool = False):
        if corpus.n_docs < k:
            raise ValueError("corpus smaller than the retrieval k")
        self.k = k
        self.device = resolve_device(device)
        self.ingest_block = ingest_block
        self.ledger = ledger or TransferLedger()
        self.side = SideStream(self.device, side_stream)
        with self.side.enter():
            corpus_dev = Corpus(*(None if x is None else x.to(self.device)
                                  for x in (corpus.tf, corpus.doc_len,
                                            corpus.idf, corpus.doc_tokens,
                                            corpus.doc_embeds)))
            self.sel = make_retrieval_select(
                "rag", corpus=corpus_dev, k=k, capacity=capacity,
                ingest_block=ingest_block)
            self.state = self.sel.summary_init()
        self.n_docs = corpus.n_docs
        self.capacity = self.sel.n_pages
        # host mirror of the token payloads for span assembly
        dmax = corpus.doc_tokens.shape[1]
        self._tokens = np.zeros((self.capacity, dmax), np.int32)
        self._tokens[: self.n_docs] = corpus.doc_tokens.cpu().numpy()
        self._tok_len = np.zeros((self.capacity,), np.int32)
        self._tok_len[: self.n_docs] = corpus.doc_len.cpu().numpy().astype(
            np.int32)
        self.vocab = corpus.tf.shape[1]

    # -- incremental ingest --------------------------------------------

    # the doc-axis tensors of the store (df / idf / n_docs are not padded on
    # growth: they run over the retrieval vocab, which can equal the
    # capacity by shape alone)
    DOC_AXIS = ("tf", "doc_len", "doc_tokens", "doc_embeds")

    def _grow(self, need: int) -> None:
        """Double the store until it holds ``need`` docs (new tensors; the
        select and ingest read the capacity from the state's shapes)."""
        cap = self.capacity
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        pad = new_cap - cap
        self.state = {
            k: (torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
                if k in self.DOC_AXIS else v)
            for k, v in self.state.items()}
        self._tokens = np.pad(self._tokens, ((0, pad), (0, 0)))
        self._tok_len = np.pad(self._tok_len, (0, pad))
        self.capacity = new_cap

    def ingest(self, corpus: Corpus) -> None:
        """Append ``corpus``'s documents to the store (incremental prepare
        stage: df/idf refresh on the device, token mirror on the host)."""
        tf = corpus.tf.cpu()
        dl = corpus.doc_len.cpu().float()
        toks = corpus.doc_tokens.cpu()
        emb = None if corpus.doc_embeds is None else corpus.doc_embeds.cpu()
        if tf.shape[1] != self.vocab:
            raise ValueError("retrieval vocab mismatch")
        if toks.shape[1] != self._tokens.shape[1]:
            raise ValueError("doc_max mismatch")
        de = self.state.get("doc_embeds")
        if de is not None and (emb is None or emb.shape[1] != de.shape[1]):
            raise ValueError("the store keeps doc embeddings: the ingested "
                             "corpus must carry doc_embeds of their width")
        mb = self.ingest_block

        def block(x, lo, hi):
            out = x.new_zeros((mb,) + tuple(x.shape[1:]))
            out[: hi - lo] = x[lo:hi]
            return out

        with self.side.enter():
            for lo in range(0, tf.shape[0], mb):
                hi = min(lo + mb, tf.shape[0])
                m = hi - lo
                if self.n_docs + m > self.capacity:   # live docs overflow
                    self._grow(self.n_docs + m)
                eb = torch.zeros((mb, 1)) if de is None else block(emb, lo, hi)
                args = self.ledger.ship_down(
                    (block(tf, lo, hi), block(dl, lo, hi),
                     block(toks, lo, hi), eb), self.device, bulk=True)
                self.state = self.sel.ingest(self.state, *args, m)
                self._tokens[self.n_docs: self.n_docs + m] = \
                    toks[lo:hi].numpy()
                self._tok_len[self.n_docs: self.n_docs + m] = \
                    dl[lo:hi].numpy().astype(np.int32)
                self.n_docs += m

    # -- queries --------------------------------------------------------

    def query(self, terms) -> Dict:
        """Launch a BM25 top-k query for ``terms [B, T]`` (async: collect
        with ``collect``). The handle holds the panel it was scored from
        (for ``replay``) and keeps every tensor of the query alive until it
        is collected."""
        with self.side.enter():
            t = self.ledger.ship_down(int32(terms), self.device)
            s = self.state
            tfq, idf, dln = _bm25_panel(s, t)
            scores, ids = ops.bm25_topk(tfq, dln, idf, self.k,
                                        block=min(4096, self.capacity),
                                        avgdl=1.0, valid=s["n_docs"])
            event = self.side.record()
        return {"scores": scores, "ids": ids, "event": event,
                "inputs": (tfq, dln, idf, s["n_docs"])}

    def wait(self, handle: Dict) -> None:
        """Block the host until the query has run."""
        self.side.wait_host(handle["event"])

    def collect(self, handle: Dict, device=None
                ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Block on a query: -> (doc_ids [B, k], spans) where ``spans[b]``
        is the concatenated token payload of row b's retrieved docs."""
        device = torch.device(device) if device is not None else self.device
        self.side.join(handle["event"], device)
        ids = self.ledger.ship_up(handle["ids"], device).cpu().numpy()
        spans = []
        for row in ids:
            parts = [self._tokens[i, : self._tok_len[i]]
                     for i in row if i >= 0]
            span = np.concatenate(parts) if parts else \
                np.zeros((0,), np.int32)
            self.ledger.count_span(span.nbytes)
            spans.append(span.astype(np.int32))
        return ids, spans

    def replay(self, handle: Dict) -> bool:
        """Re-score the pinned panel synchronously on the caller's stream;
        True iff the consumed ids are bit-identical (validation mode)."""
        self.side.join(handle["event"], self.device)
        tfq, dln, idf, nd = handle["inputs"]
        _, ref = ops.bm25_topk(tfq, dln, idf, self.k,
                               block=min(4096, tfq.shape[1]), avgdl=1.0,
                               valid=nd)
        return bool(torch.equal(ref.cpu(), handle["ids"].cpu()))

    def query_hybrid(self, terms, q_embed, n_first: int, alpha: float = 0.5):
        """Two-stage first pass (BM25 + embedding hybrid) -> top-n_first
        (scores, ids) on the hosting device."""
        if self.state.get("doc_embeds") is None:
            raise ValueError("hybrid retrieval needs doc embeddings in the "
                             "store")
        with self.side.enter():
            t = self.ledger.ship_down(int32(terms), self.device)
            qe = self.ledger.ship_down(
                torch.as_tensor(q_embed, dtype=torch.float32), self.device)
            out = kref.topk_stable(
                rag_hybrid_scores(self.state, t, qe, alpha=alpha), n_first)
        self.side.join(self.side.record(), self.device)
        return out


def int32(x) -> torch.Tensor:
    """Token or term ids (numpy, list or tensor) as an int32 tensor, where
    they lie."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.as_tensor(np.asarray(x), dtype=torch.int32)
