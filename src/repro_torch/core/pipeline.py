"""The paper's four-stage memory processing pipeline (twin of
``repro.core.pipeline``, Definition 3.1 / §3.1).

  prepare(M)          -> I      index / compressed memory
  relevancy(I, x)     -> S      importance scores
  retrieve(M, S)      -> M'     selected subset / refined memory
  apply(M', x)        -> O      integrate into inference

A stage set to ``None`` is a zero-cost bypass. A fused callable (relevancy
and retrieve in one kernel) occupies the earlier slot, the later slot is
None, and the profiler splits its time over both stages for the paper's
Fig. 3-5 breakdowns.

The reference blocks on the stage's result with ``jax.block_until_ready``
before it reads the clock; here a stage whose result holds CUDA tensors is
closed with ``torch.cuda.synchronize`` on their device, and a CPU result
needs nothing (eager torch has finished it).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

STAGES = ("prepare", "relevancy", "retrieve", "apply")


def _cuda_device(tree):
    """The device of the first CUDA tensor in a nest of tuples, lists and
    dicts, or None."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for t in tree:
            dev = _cuda_device(t)
            if dev is not None:
                return dev
    return None


def block_until_ready(res):
    """The twin of ``jax.block_until_ready``: synchronizes the device of the
    first CUDA tensor in ``res`` (nothing for CPU results); returns
    ``res``."""
    dev = _cuda_device(res)
    if dev is not None:
        torch.cuda.synchronize(dev)
    return res


@dataclasses.dataclass
class MemoryPipeline:
    """A concrete memory-processing method (one row of the paper's Table 1)."""

    name: str
    prepare: Optional[Callable] = None
    relevancy: Optional[Callable] = None
    retrieve: Optional[Callable] = None
    apply: Optional[Callable] = None
    # which stages each callable covers (fusion bookkeeping)
    fused: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def stages(self):
        for s in STAGES:
            fn = getattr(self, s)
            if fn is not None:
                yield s, fn, self.fused.get(s, (s,))

    def run(self, memory: Any, query: Any, profiler: "StageProfiler" = None):
        """Execute the pipeline: prepare sees M; relevancy sees (I, x);
        retrieve sees (M, S); apply sees (M', x)."""
        M, x = memory, query
        I = M
        sel = M
        out = None
        for s, fn, covers in self.stages():
            t0 = time.perf_counter() if profiler else None
            if s == "prepare":
                I = fn(M)
                res = I
            elif s == "relevancy":
                res = fn(I, x)
                sel = res
            elif s == "retrieve":
                sel = fn(M, sel)
                res = sel
            else:
                out = fn(sel, x)
                res = out
            if profiler:
                block_until_ready(res)
                profiler.record(self.name, covers, time.perf_counter() - t0)
        return out if out is not None else sel


class StageProfiler:
    """Wall-clock stage attribution, the paper's Fig. 3-5 methodology
    (fraction of latency spent in memory processing)."""

    def __init__(self):
        self.stage_seconds: Dict[str, Dict[str, float]] = {}
        self.total_seconds: Dict[str, float] = {}

    def record(self, method: str, covers: tuple, seconds: float):
        d = self.stage_seconds.setdefault(method, {s: 0.0 for s in STAGES})
        for s in covers:  # fused stages split time evenly for attribution
            d[s] += seconds / len(covers)

    def record_total(self, method: str, seconds: float):
        self.total_seconds[method] = self.total_seconds.get(method, 0.0) \
            + seconds

    def memory_fraction(self, method: str) -> float:
        mem = sum(self.stage_seconds.get(method, {}).values())
        tot = self.total_seconds.get(method, 0.0)
        return mem / tot if tot else float("nan")

    def breakdown(self, method: str) -> Dict[str, float]:
        d = self.stage_seconds.get(method, {})
        tot = sum(d.values()) or 1.0
        return {s: v / tot for s, v in d.items()}
