"""Dynamic RAG through the serving-integrated retrieval subsystem (twin of
``examples/rag_pipeline.py``).

The corpus lives in a ``RetrievalService`` (the retrieval engine): fused
BM25 scoring runs on the device hosting the index (the BM25 kernel on the
card), documents are appended incrementally into the capacity-padded
store, and at serve time per-slot FLARE triggers splice retrieved documents
into the paged KV pool mid-decode, overlapped against the other slots'
decode steps (the service on a CUDA stream of its own).

    PYTHONPATH=src python -m repro_torch.examples.rag_pipeline --docs 2048
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.methods import rag
from repro_torch.data import build_corpus, sample_queries
from repro_torch.models import init_params
from repro_torch.retrieval import RetrievalConfig, RetrievalService
from repro_torch.serving import Request, Router, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--mode", default="overlap",
                    choices=["inline", "sync", "overlap"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch("llama3.2-1b").smoke()

    # --- the document-memory service: fused BM25 on the hosting device ---
    half = args.docs // 2
    corpus = build_corpus(args.docs, retrieval_vocab=1024, doc_max=16,
                          gen_vocab=cfg.vocab_size, embed_dim=32, seed=0,
                          device=args.device)
    svc = RetrievalService(rag.corpus_slice(corpus, 0, half), k=args.k,
                           device=args.device)
    q_terms = sample_queries(corpus, args.batch, 8, seed=1)
    t0 = time.perf_counter()
    ids, spans = svc.collect(svc.query(q_terms))
    print(f"service: {svc.n_docs} docs, top-{args.k} in "
          f"{time.perf_counter() - t0:.3f}s; top ids {ids[:, 0]}")

    # --- incremental ingest: the second half appends into the store ---
    t0 = time.perf_counter()
    svc.ingest(rag.corpus_slice(corpus, half, args.docs))
    ids2, _ = svc.collect(svc.query(q_terms))
    print(f"ingest +{args.docs - half} docs in {time.perf_counter()-t0:.3f}s "
          f"-> {svc.n_docs} docs; top ids now {ids2[:, 0]}")

    # --- two-stage first pass: hybrid BM25+embedding scoring on-store ---
    q_emb = np.ones((args.batch, 32), np.float32) / np.sqrt(32)
    _, cand = svc.query_hybrid(q_terms, q_emb, n_first=16)
    print(f"hybrid first-pass candidates: {cand[:, :4].cpu().numpy()}...")

    # --- serve time: a 2-replica fleet sharing THIS service; per-slot
    # FLARE triggers splice docs mid-decode on whichever replica serves ---
    params = init_params(cfg, 0, tp=4, device=args.device)
    rcfg = RetrievalConfig(kind="rag", mode=args.mode, corpus=corpus,
                           k=2, trigger="flare", tau=0.9,
                           min_interval=4, max_retrievals=2,
                           service=svc)       # fleet-shared corpus
    sc = ServeConfig(max_len=256, n_slots=args.batch, method="none",
                     tp=4, retrieval=rcfg)
    router = Router.build(cfg, params, sc, n_replicas=2, seed=1,
                          device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    handles = [router.submit(Request(
        i, rng.integers(0, cfg.vocab_size, size=24), 16, retrieval=True,
        session=f"user{i % 2}")) for i in range(args.batch)]
    done = router.drain()
    wall = time.perf_counter() - t0
    toks = sum(len(h.tokens) for h in handles)
    n_ret = sum(r.engine.retrieval.report()["retrievals"]
                for r in router.replicas)
    rep = router.report()
    print(f"fleet of {rep['n_replicas']} replicas served {len(done)} "
          f"requests ({toks} tokens) in {wall:.2f}s, mode={args.mode}: "
          f"{n_ret} retrievals from the shared "
          f"{rep['shared_corpus']['n_docs']}-doc corpus, "
          f"mean TTFT {1e3 * rep['ttft_s']['mean']:.1f}ms, placements "
          f"{[h.replica for h in handles]}")
    return rep


if __name__ == "__main__":
    main()
