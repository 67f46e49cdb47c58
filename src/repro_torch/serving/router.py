"""Router over a fleet of Engine replicas (twin of
``repro.serving.router``).

The paper's end-to-end claim (memory processing is 22%-97% of serving) is a
fleet claim: N engines behind a router, mixed traffic, TTFT. The router is
the fleet's request-level front:

  * it owns ``EngineReplica`` workers, each an Engine on its own device
    group (``hetero.policy.pick_devices_replicas``); on one card they share
    it, each with its own pool and streams;
  * it routes each :class:`Request` by SESSION AFFINITY (every request of a
    session stays on one replica), then ELIGIBILITY (a ``method_overrides
    ["method"]`` pin, a retrieval opt-in), then LEAST LOAD with the replica
    index breaking ties;
  * it shares ONE ``RetrievalService`` among the replicas (capacity-padded,
    ingesting incrementally: a document ingested through the router is
    visible to every replica's next trigger);
  * it holds no decode state: that lives in the replicas' engines.

``submit(Request) -> ResponseHandle`` and ``drain()`` are the engine's
surface at fleet scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

from repro_torch.serving.api import Request, ResponseHandle
from repro_torch.serving.engine import ServeConfig
from repro_torch.serving.events import StepEvents
from repro_torch.serving.replica import EngineReplica


class Router:
    def __init__(self, replicas: Sequence[EngineReplica], *, service=None):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        self.replicas = list(replicas)
        self.service = service          # shared RetrievalService (or None)
        self._affinity: Dict = {}       # session -> replica index
        self._handles: Dict[int, ResponseHandle] = {}

    # ------------------------------------------------------------------
    # fleet construction
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, cfg, params,
              sc: Union[ServeConfig, Sequence[ServeConfig]],
              n_replicas: Optional[int] = None, *, seed: int = 0, mem=None,
              device="cuda", sparse_params=None,
              retrieval_params=None) -> "Router":
        """One ServeConfig replicated ``n_replicas`` times, or a list of
        per-replica configs (a heterogeneous fleet). Device groups come from
        ``pick_devices_replicas(.., device)``; every replica with a rag
        retrieval config is rewired onto ONE shared service. ``seed``,
        ``sparse_params`` and ``retrieval_params`` go to every engine (the
        reference passes ``key=``)."""
        from repro_torch.hetero import policy as hpolicy

        if isinstance(sc, ServeConfig):
            if n_replicas is None or n_replicas < 1:
                raise ValueError("one ServeConfig needs n_replicas >= 1")
            cfgs = [sc] * n_replicas
        else:
            cfgs = list(sc)
            if n_replicas is not None and n_replicas != len(cfgs):
                raise ValueError(f"n_replicas {n_replicas} != "
                                 f"{len(cfgs)} configs")
        groups = hpolicy.pick_devices_replicas(len(cfgs), device)
        service = cls._build_shared_service(cfgs, groups)
        replicas = []
        for i, rsc in enumerate(cfgs):
            if service is not None and rsc.retrieval is not None \
                    and rsc.retrieval.kind == "rag":
                rsc = dataclasses.replace(
                    rsc, retrieval=dataclasses.replace(rsc.retrieval,
                                                       service=service))
            replicas.append(EngineReplica(
                i, cfg, params, rsc, seed=seed, mem=mem, devices=groups[i],
                device=device, sparse_params=sparse_params,
                retrieval_params=retrieval_params))
        return cls(replicas, service=service)

    @staticmethod
    def _build_shared_service(cfgs, groups):
        """One corpus service for the whole fleet, on the last device of
        the last group (an offload-side device when there are several; the
        one card otherwise), on a stream of its own unless the first rag
        config asks for inline retrieval."""
        rcfgs = [c.retrieval for c in cfgs
                 if c.retrieval is not None and c.retrieval.kind == "rag"]
        if not rcfgs:
            return None
        from repro_torch.retrieval.service import RetrievalService
        r = rcfgs[0]
        if r.service is not None:       # the caller built one
            return r.service
        if r.corpus is None:
            raise ValueError("kind='rag' needs a corpus")
        return RetrievalService(r.corpus, k=r.k, device=groups[-1][-1],
                                capacity=r.capacity,
                                ingest_block=r.ingest_block,
                                side_stream=r.mode != "inline")

    # ------------------------------------------------------------------
    # request-level API (the engine's submit / poll / drain)
    # ------------------------------------------------------------------

    def _route(self, req: Request) -> EngineReplica:
        if req.session is not None and req.session in self._affinity:
            return self.replicas[self._affinity[req.session]]
        cands = [r for r in self.replicas if r.can_serve(req)]
        if not cands:
            cands = self.replicas      # no eligible replica: best effort
        best = min(cands, key=lambda r: (r.load(), r.index))
        if req.session is not None:
            self._affinity[req.session] = best.index
        return best

    def submit(self, req: Request) -> ResponseHandle:
        """Route by affinity / eligibility / load and enqueue on the
        replica; the handle's ``replica`` records the placement."""
        if req.rid in self._handles and not self._handles[req.rid].done:
            raise ValueError(f"request id {req.rid} already in flight")
        h = self._route(req).submit(req)
        self._handles[req.rid] = h
        return h

    def poll(self) -> StepEvents:
        """One fleet turn: every replica polled once (their device work
        overlaps on their streams), the events merged. The merged
        ``finished`` / ``fired`` slot ids are replica-local, kept for
        counting; emissions carry the fleet-unique rids."""
        ev = StepEvents()
        for r in self.replicas:
            rev = r.poll()
            ev.emissions.extend(rev.emissions)
            ev.finished.extend(rev.finished)
            ev.fired.extend(rev.fired)
            ev.steps += rev.steps
        return ev

    def drain(self, max_steps: int = 100_000) -> Dict[int, ResponseHandle]:
        """Pump until every replica's queue and pool are empty (or stuck);
        returns every completed handle by rid."""
        steps = 0
        while steps < max_steps:
            busy = [r for r in self.replicas if r.busy()]
            if not busy:
                break
            alive = False
            for r in busy:
                rev = r.poll()
                steps += max(1, rev.steps)
                if r.made_progress(rev):
                    alive = True
                elif r.engine.queue and r.engine._inflight_h:
                    alive = True       # admission deferred; retry next turn
            if not alive:
                break                  # every busy replica is stuck
        return self.done()

    def done(self) -> Dict[int, ResponseHandle]:
        out: Dict[int, ResponseHandle] = {}
        for r in self.replicas:
            out.update(r.engine.done)
        return out

    def busy(self) -> bool:
        return any(r.busy() for r in self.replicas)

    def ingest(self, corpus) -> None:
        """Append documents to the fleet's shared corpus (visible to every
        replica's triggers from the next retrieval on)."""
        if self.service is None:
            raise ValueError("no shared retrieval service")
        self.service.ingest(corpus)

    # ------------------------------------------------------------------

    def report(self) -> Dict:
        done = self.done()
        ttfts = [h.ttft_s() for h in done.values()
                 if h.ttft_s() is not None]
        out = {
            "n_replicas": len(self.replicas),
            "requests_done": len(done),
            "sessions": len(self._affinity),
            "replicas": [r.report() for r in self.replicas],
        }
        if ttfts:
            out["ttft_s"] = {"mean": float(sum(ttfts) / len(ttfts)),
                             "max": float(max(ttfts))}
        if self.service is not None:
            out["shared_corpus"] = {"n_docs": int(self.service.n_docs),
                                    "capacity": int(self.service.capacity),
                                    "device": str(self.service.device)}
        return out
