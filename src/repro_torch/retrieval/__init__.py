"""Serving-integrated retrieval subsystem of the port (twin of
``repro.retrieval``; paper Table 1 rows 4-6 and 8).

Dynamic RAG and MaC memory banks as an engine service: the document memory
(corpus index / per-slot banks) lives on the retrieval device, on a CUDA
stream of its own unless inline; FLARE/DRAGIN triggers fire per slot over
the pooled decode logits; retrieved payloads are spliced into the paged KV
pool through the chunked-prefill path, overlapped against decode of the
other slots under ``RetrievalConfig(mode="overlap")`` and bit-matching the
inline stop-retrieve-resume schedule.
"""
from repro_torch.retrieval.bank import MacBankService
from repro_torch.retrieval.executor import RetrievalConfig, RetrievalExecutor
from repro_torch.retrieval.select import (OffloadSelect, make_retrieval_select,
                                          rag_hybrid_scores)
from repro_torch.retrieval.service import RetrievalService

__all__ = [
    "MacBankService", "OffloadSelect", "RetrievalConfig", "RetrievalExecutor",
    "RetrievalService", "make_retrieval_select", "rag_hybrid_scores",
]
