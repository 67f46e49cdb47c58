"""One fleet worker: an Engine pinned to a device group, plus a monitor
(twin of ``repro.serving.replica``).

An :class:`EngineReplica` wraps an :class:`~repro_torch.serving.engine.
Engine` that runs on the first device of the replica's group
(``hetero.policy.pick_devices_replicas``); the group's other devices serve
its offload / retrieval side. On one card every replica runs there, each
with its own pool, streams and CUDA graph cache, and all of them share the
weights (``Engine`` does not copy a tensor already on the device). One
``poll()`` per fleet turn runs the engine's continuous-batching loop
unchanged: admission, chunked prefill, one decode dispatch.

The monitor samples the admission queue and the slot pool at every poll:
the load signals the router routes by.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.serving.api import Request, ResponseHandle
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.events import StepEvents


@dataclasses.dataclass
class ReplicaMonitor:
    """Per-poll samples of the admission queue and the slot pool."""

    queue_depth: List[int] = dataclasses.field(default_factory=list)
    live_slots: List[int] = dataclasses.field(default_factory=list)
    n_slots: int = 0
    polls: int = 0
    tokens: int = 0

    def sample(self, engine: Engine, emitted: int) -> None:
        self.polls += 1
        self.tokens += emitted
        self.queue_depth.append(engine.queue_depth())
        self.live_slots.append(int(engine.slots.live_mask().sum()))

    def utilization(self) -> float:
        """Mean fraction of slots decoding, over the polled lifetime."""
        if not self.live_slots or not self.n_slots:
            return 0.0
        return float(np.mean(self.live_slots)) / self.n_slots

    def as_dict(self) -> Dict:
        qd = self.queue_depth or [0]
        return {
            "polls": self.polls,
            "tokens": self.tokens,
            "utilization": self.utilization(),
            "queue_depth": {"mean": float(np.mean(qd)),
                            "max": int(np.max(qd))},
        }


class EngineReplica:
    def __init__(self, index: int, cfg, params, sc: ServeConfig, *,
                 seed: int = 0, mem=None, devices=None, device="cuda",
                 sparse_params=None, retrieval_params=None):
        self.index = index
        self.engine = Engine(cfg, params, sc, seed=seed, mem=mem,
                             device=device, devices=devices,
                             sparse_params=sparse_params,
                             retrieval_params=retrieval_params)
        self.monitor = ReplicaMonitor(n_slots=sc.n_slots)
        self.sessions = set()          # affinity keys pinned here

    @property
    def method(self) -> str:
        return self.engine.sc.method

    @property
    def devices(self):
        return self.engine.devices

    def load(self) -> int:
        """Queued + resident requests: the router's routing signal."""
        return self.engine.queue_depth() + len(self.engine._inflight_h)

    def busy(self) -> bool:
        return self.engine.busy()

    def can_serve(self, req: Request) -> bool:
        """Static eligibility: a per-request method override routes to a
        replica serving that method; a retrieval opt-in needs the
        retrieval service."""
        want = req.override("method")
        if want is not None and want != self.method:
            return False
        if req.retrieval and self.engine.retrieval is None:
            return False
        return True

    def submit(self, req: Request) -> ResponseHandle:
        if req.session is not None:
            self.sessions.add(req.session)
        h = self.engine.submit(req)
        h.replica = self.index
        return h

    def poll(self) -> StepEvents:
        ev = self.engine.poll()
        self.monitor.sample(self.engine, len(ev.emissions))
        return ev

    def made_progress(self, ev: StepEvents) -> bool:
        """Did the last poll move this replica forward (or can the next)?"""
        return bool(ev.emissions) or self.engine._polled_prefill \
            or self.engine.has_prefill_work() \
            or self.engine.has_retrieval_work()

    def report(self) -> Dict:
        eng = self.engine
        out = {
            "replica": self.index,
            "method": self.method,
            "devices": [str(d) for d in (eng.devices or [eng.device])],
            "sessions": len(self.sessions),
            "done": len(eng.done),
            **self.monitor.as_dict(),
        }
        if eng.retrieval is not None:
            out["retrievals"] = len(eng.retrieval.events)
        return out
