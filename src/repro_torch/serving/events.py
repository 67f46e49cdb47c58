"""Typed stepping result of ``Engine.step_pool`` (legacy AND fused paths).

The port's own copy of ``repro.serving.events``.

``step_pool`` used to return a bare ``List[Tuple[request_id, slot, token]]``;
with the fused multi-step decode loop one host call can consume several
device steps, finish slots, and fire retrieval triggers — the caller needs
all of that, not just the token tuples. ``StepEvents`` carries:

  emissions  [(request_id, slot, token)] in step-major order (the exact
             sequence K separate ``step_pool()`` calls would have emitted);
  finished   slots released during the call (their pages are already back
             on the free list);
  fired      slots whose FLARE/DRAGIN trigger fired (retrieval launched or
             suppressed — either way the slot charged its cooldown);
  steps      device decode steps consumed (1 for the legacy path, up to
             ``ServeConfig.fused_steps`` for the fused path).

Tuple-style access (``for rid, slot, tok in engine.step_pool()``) keeps
working through ``__iter__``/``__len__``/``__getitem__`` — the deprecation
shim for one release while callers migrate to the named fields.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple


@dataclasses.dataclass
class StepEvents:
    emissions: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)
    finished: List[int] = dataclasses.field(default_factory=list)
    fired: List[int] = dataclasses.field(default_factory=list)
    steps: int = 0

    # -- legacy list-of-tuples shim ------------------------------------

    def __iter__(self) -> Iterator[Tuple[int, int, int]]:
        return iter(self.emissions)

    def __len__(self) -> int:
        return len(self.emissions)

    def __bool__(self) -> bool:
        return bool(self.emissions)

    def __getitem__(self, i):
        return self.emissions[i]
