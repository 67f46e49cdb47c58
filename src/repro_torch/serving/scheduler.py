"""Single-engine compatibility shim over the request-level serving API
(twin of ``repro.serving.scheduler``).

The continuous-batching logic this module used to own — FCFS admission
under a prefill token budget, chunked admission for long prompts, the
drain loop with its starvation brake — now lives INSIDE the engine behind
``Engine.submit(Request) -> ResponseHandle`` / ``poll()`` / ``drain()``
(serving/api.py), where the fleet router shares it. ``Scheduler`` remains
as the thin positional-prompt front the launchers and older tests grew up
with: it mints sequential rids, wraps prompts into :class:`Request`, and
proxies queue/inflight/done straight from the engine.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.serving.api import Request, ResponseHandle
from repro_torch.serving.engine import Engine


class Scheduler:
    def __init__(self, engine: Engine, prefill_token_budget: int = 2048):
        self.engine = engine
        engine.prefill_token_budget = prefill_token_budget
        self._next_id = 0

    @property
    def prefill_token_budget(self) -> int:
        return self.engine.prefill_token_budget

    @property
    def queue(self):
        return self.engine.queue

    @property
    def inflight(self) -> Dict[int, ResponseHandle]:
        return self.engine._inflight_h

    @property
    def done(self) -> Dict[int, ResponseHandle]:
        return self.engine.done

    def submit(self, prompt: np.ndarray, max_new: int,
               retrieval: Optional[bool] = None) -> int:
        rid = self._next_id
        self._next_id += 1
        self.engine.submit(Request(rid, np.asarray(prompt), max_new,
                                   retrieval=retrieval))
        return rid

    def run(self, max_steps: int = 10_000) -> Dict[int, ResponseHandle]:
        """Drain the queue; returns completed requests by rid."""
        return self.engine.drain(max_steps)

    def throughput_tokens_per_s(self) -> float:
        return self.engine.throughput_tokens_per_s()
