"""Request-level serving API — the ONE admission surface of the engine.

The port's own copy of ``repro.serving.api`` (importing that package pulls
in JAX through its engine).

Every way into the serving stack (single engine, compatibility scheduler,
fleet router) admits work as a frozen :class:`Request` through
``Engine.submit`` and reads results back through the :class:`ResponseHandle`
the submit returned. The positional ``(request_id, prompt, max_new)`` tuple
plumbing that used to thread through tests, scheduler and engine is gone —
the tuple layout was an implementation detail of the old batched-admit call
and every caller re-invented timing/stream bookkeeping around it.

``Request`` is immutable (it may sit in an admission queue, be re-queued at
the front after a rejection, or be routed between replicas — nobody gets to
mutate it in flight). ``ResponseHandle`` is the mutable side: the engine
appends tokens as they are emitted and stamps the timing fields the serving
benchmarks report (TTFT, per-token latency).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

#: recognised ``Request.method_overrides`` keys.
#:   chunked  force chunked admission on (True) / off (False) regardless of
#:            the ``chunk_threshold`` length heuristic
#:   method   route to a replica serving this sparse method (router-level;
#:            a single engine ignores it)
METHOD_OVERRIDE_KEYS = ("chunked", "method")


@dataclasses.dataclass(frozen=True, eq=False)
class Request:
    """One generation request.

    rid               caller-chosen id; unique among requests concurrently
                      known to the engine/router it is submitted to.
    tokens            prompt token ids (any int sequence; stored int32).
    max_new           tokens to generate (greedy).
    retrieval         opt the request in/out of the engine's retrieval
                      service (None = service default: on when configured).
    method_overrides  per-request knobs, see ``METHOD_OVERRIDE_KEYS``.
    session           affinity key: the router keeps every request of one
                      session on one replica (KV/retrieval locality).
    """

    rid: int
    tokens: np.ndarray
    max_new: int
    retrieval: Optional[bool] = None
    method_overrides: Optional[Mapping[str, Any]] = None
    session: Optional[Any] = None

    def __post_init__(self):
        toks = np.asarray(self.tokens, np.int32)
        if toks.ndim != 1:
            raise ValueError(f"Request.tokens must be 1-D, got {toks.shape}")
        toks.setflags(write=False)
        object.__setattr__(self, "tokens", toks)
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.method_overrides is not None:
            mo = dict(self.method_overrides)
            bad = set(mo) - set(METHOD_OVERRIDE_KEYS)
            if bad:
                raise ValueError(
                    f"unknown method_overrides {sorted(bad)}; "
                    f"known: {METHOD_OVERRIDE_KEYS}")
            object.__setattr__(self, "method_overrides", mo)

    def override(self, key: str, default=None):
        if self.method_overrides is None:
            return default
        return self.method_overrides.get(key, default)

    def __len__(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass
class ResponseHandle:
    """Live view of one submitted request: the growing token stream plus the
    timing marks serving metrics are made of. Engine-owned fields are
    written by ``Engine.poll``; callers read."""

    request: Request
    submitted: float = dataclasses.field(default_factory=time.perf_counter)
    tokens: List[int] = dataclasses.field(default_factory=list)
    admitted: Optional[float] = None       # left the queue, entered a slot
    first_token_t: Optional[float] = None  # first emission surfaced
    finished: Optional[float] = None       # max_new tokens emitted
    replica: Optional[int] = None          # router: replica index served on

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return self.finished is not None

    @property
    def text(self) -> str:
        """Final text. The repo serves synthetic token streams (there is no
        tokenizer); the canonical detokenization is space-joined ids."""
        return " ".join(str(t) for t in self.tokens)

    def ttft_s(self) -> Optional[float]:
        """Submit -> first token (queueing + admission prefill + 1 step)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submitted

    def per_token_s(self) -> Optional[float]:
        """Mean inter-token latency over the decode tail."""
        if not self.done or len(self.tokens) < 2:
            return None
        return (self.finished - self.first_token_t) / (len(self.tokens) - 1)

    def result(self) -> np.ndarray:
        assert self.done, f"request {self.rid} still in flight"
        return np.asarray(self.tokens, np.int32)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rid": self.rid, "n_tokens": len(self.tokens),
            "ttft_s": self.ttft_s(), "per_token_s": self.per_token_s(),
            "replica": self.replica, "done": self.done,
        }
