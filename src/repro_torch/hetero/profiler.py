"""Per-stage timeline of the hetero offload executor (twin of
``repro.hetero.profiler``, paper Fig. 3-5).

The synchronous two-phase schedule exposes the phase walls directly (select
/ apply); the overlapped schedule hides the select phase under apply by
construction, so the profiler reports what is observable there, the
per-step wall, plus the analytic decomposition. Phase walls are attributed
to the paper's stages with the roofline stage costs
(``placement.sparse_attention_stage_costs``) as weights: the select phase
covers prepare + relevancy + retrieve, the apply phase apply + rest.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig, MemoryConfig
from repro_torch.core import placement

SELECT_STAGES = ("prepare", "relevancy", "retrieve")
APPLY_STAGES = ("apply", "rest")


class HeteroProfiler:
    def __init__(self, cfg: ArchConfig, mem: MemoryConfig, mode: str):
        self.cfg, self.mem, self.mode = cfg, mem, mode
        self.steps = 0
        self.tokens = 0
        self.step_s = 0.0
        self.select_s = 0.0       # sync mode only (hidden under overlap)
        self.apply_s = 0.0
        self.max_context = 1
        self.offload_steps = 0    # steps that ran the offload path
        self.local_steps = 0      # dynamic-fallback steps (main side only)
        # lookahead health: a step reuses the pending overlapped selection
        # (a hit, possibly patching the rows of slots whose membership
        # changed) or cold-starts a fresh one on the critical path
        self.lookahead_hits = 0
        self.lookahead_cold = 0
        self.lookahead_patched = 0
        # fused multi-step windows: one host dispatch per window
        self.fused_windows = 0
        self.fused_steps = 0

    def record_step(self, n_live: int, context: int, step_s: float,
                    select_s: Optional[float] = None,
                    apply_s: Optional[float] = None,
                    offloaded: bool = True):
        self.steps += 1
        self.tokens += n_live
        self.step_s += step_s
        self.max_context = max(self.max_context, context)
        if select_s is not None:
            self.select_s += select_s
        if apply_s is not None:
            self.apply_s += apply_s
        if offloaded:
            self.offload_steps += 1
        else:
            self.local_steps += 1

    def record_fused(self, n_steps: int, n_tokens: int, context: int,
                     step_s: float, *, offload_steps: int,
                     local_steps: int):
        """One fused window of ``n_steps`` device steps behind a single
        host dispatch."""
        self.steps += n_steps
        self.tokens += n_tokens
        self.step_s += step_s
        self.max_context = max(self.max_context,
                               context + max(n_steps - 1, 0))
        self.offload_steps += offload_steps
        self.local_steps += local_steps
        self.fused_windows += 1
        self.fused_steps += n_steps

    # -- Fig. 3-style decomposition ------------------------------------

    def _weights(self) -> Dict[str, float]:
        costs = placement.sparse_attention_stage_costs(
            self.cfg, self.mem, max(self.max_context, 1))
        return {s: c.seconds() for s, c in costs.items()}

    def stage_seconds(self) -> Dict[str, float]:
        """Measured phase walls apportioned to the pipeline stages."""
        w = self._weights()
        out: Dict[str, float] = {}
        for group, total in ((SELECT_STAGES, self.select_s),
                             (APPLY_STAGES, self.apply_s)):
            gw = sum(w[s] for s in group) or 1.0
            for s in group:
                out[s] = total * w[s] / gw
        return out

    def fractions(self) -> Dict[str, float]:
        ss = self.stage_seconds()
        tot = sum(ss.values()) or 1.0
        return {s: v / tot for s, v in ss.items()}

    def memory_fraction(self) -> float:
        """Fraction of phase time in memory processing (all but 'rest'),
        the paper's headline metric."""
        ss = self.stage_seconds()
        tot = sum(ss.values())
        return (tot - ss.get("rest", 0.0)) / tot if tot else float("nan")

    # -- reporting ------------------------------------------------------

    def summary(self, ledger=None, **transfer_kw) -> Dict:
        d = {
            "mode": self.mode,
            "method": self.mem.method,
            "steps": self.steps,
            "tokens": self.tokens,
            "offload_steps": self.offload_steps,
            "local_fallback_steps": self.local_steps,
            "lookahead": {"hits": self.lookahead_hits,
                          "cold_starts": self.lookahead_cold,
                          "patched": self.lookahead_patched},
            "max_context": self.max_context,
            "fused": {"windows": self.fused_windows,
                      "steps": self.fused_steps,
                      "steps_per_dispatch": self.fused_steps
                      / max(self.fused_windows, 1)},
            "step_s_total": self.step_s,
            "us_per_step": 1e6 * self.step_s / max(self.steps, 1),
            "tokens_per_s": self.tokens / self.step_s if self.step_s else 0.0,
            "apply_s": self.apply_s,
        }
        if self.mode == "sync":
            d["select_s"] = self.select_s
            d["stage_fractions"] = self.fractions()
            d["memory_fraction"] = self.memory_fraction()
        else:
            d["select_hidden"] = True   # overlapped under apply
        if ledger is not None:
            d["transfer"] = ledger.as_dict(**transfer_kw)
        return d

    def to_json(self, path: Optional[str] = None, ledger=None,
                **transfer_kw) -> str:
        s = json.dumps(self.summary(ledger, **transfer_kw), indent=2,
                       sort_keys=True)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s
