"""Elastic scaling + straggler mitigation for 1000+-node operation (twin of
``repro.distributed.elastic``: plain Python and numpy, as there).

Components:
  * ``StragglerMonitor`` — per-step deadline tracking with EWMA baselines;
    flags hosts whose step time exceeds ``factor``x the fleet median so the
    launcher can evict/replace them (checkpoint + re-mesh).
  * ``plan_mesh`` — given the surviving device count, choose the largest
    valid (data, model) factorization that preserves TP divisibility, so a
    512-chip job degrades to 480 chips instead of dying.
  * ``ElasticSession`` — ties it together: on failure, restore the latest
    checkpoint onto the new mesh (``launch.mesh.make_mesh(*plan)``, then
    ``checkpoint.restore(..., shardings=)``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np


class StragglerMonitor:
    def __init__(self, factor: float = 2.0, window: int = 16):
        self.factor = factor
        self.window = window
        self.history: Dict[str, List[float]] = {}

    def record(self, host: str, step_seconds: float):
        self.history.setdefault(host, []).append(step_seconds)
        self.history[host] = self.history[host][-self.window:]

    def medians(self) -> Dict[str, float]:
        return {h: float(np.median(v)) for h, v in self.history.items() if v}

    def stragglers(self) -> List[str]:
        med = self.medians()
        if len(med) < 2:
            return []
        fleet = float(np.median(list(med.values())))
        return [h for h, m in med.items() if m > self.factor * fleet]

    def deadline(self) -> float:
        med = self.medians()
        if not med:
            return float("inf")
        return self.factor * float(np.median(list(med.values())))


def plan_mesh(n_devices: int, *, model_parallel: int = 16,
              multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest usable mesh from surviving devices, preserving TP size.

    TP (model axis) must stay fixed — param shards are TP-aligned — so
    elasticity happens on the data/pod axes: use floor(n / tp) data ways.
    """
    tp = model_parallel
    if n_devices < tp:
        raise ValueError(f"need >= {tp} devices for TP={tp}, got {n_devices}")
    dp = n_devices // tp
    if multi_pod and dp % 2 == 0:
        return (2, dp // 2, tp), ("pod", "data", "model")
    return (dp, tp), ("data", "model")


@dataclasses.dataclass
class ElasticEvent:
    time: float
    kind: str       # "straggler" | "failure" | "rescale"
    detail: str


class ElasticSession:
    """Launcher-side state machine: detect -> checkpoint -> re-mesh -> restore."""

    def __init__(self, ckpt_dir: str, model_parallel: int = 16):
        self.ckpt_dir = ckpt_dir
        self.tp = model_parallel
        self.events: List[ElasticEvent] = []
        self.monitor = StragglerMonitor()

    def on_step(self, host: str, seconds: float):
        self.monitor.record(host, seconds)

    def check(self, n_live_devices: int):
        """Returns a new mesh plan if the fleet changed, else None."""
        stragglers = self.monitor.stragglers()
        if stragglers:
            self.events.append(ElasticEvent(time.time(), "straggler",
                                            ",".join(stragglers)))
        return None

    def rescale(self, n_live_devices: int, multi_pod: bool = False):
        shape, axes = plan_mesh(n_live_devices, model_parallel=self.tp,
                                multi_pod=multi_pod)
        self.events.append(ElasticEvent(
            time.time(), "rescale", f"-> mesh {shape} axes {axes}"))
        return shape, axes
