"""Roofline terms of a walked step (twin of ``repro.launch.roofline``).

  compute term    = sum over dtypes of the busiest device's FLOPs of that
                    dtype / the card's peak for it (bf16 on the tensor
                    cores 989 TFLOP/s, fp32 outside them 67 TFLOP/s:
                    ``core.placement.PEAK_BY_DTYPE``)
  memory term     = its bytes / HBM 3.35 TB/s
  collective term = its collective bytes / NVLink 450 GB/s a direction

The counts come from ``launch.op_walk`` (the reference's from its HLO
walk), per device; the terms are the busiest device's, the one whose
largest term is largest. The compute term splits by dtype where the
reference's divides everything by one peak: on this card the attention
backward's plain fp32 recompute runs at 67 TFLOP/s, not 989. ``mfu`` keeps
the reference's definition, model FLOPs over (step x chips x the bf16
peak).

The collective term is a lower bound: one NVLink domain holds 8 H100s, so
a 16-wide mesh axis spans two domains and part of its traffic crosses the
slower network between hosts, which the term does not model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.placement import (HBM_BW, NVLINK_BW, PEAK_BY_DTYPE,
                                        PEAK_FLOPS)
from repro_torch.launch.op_walk import COLLECTIVES, Costs


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """Each dtype's FLOPs over its own peak, summed."""
    return sum(n / PEAK_BY_DTYPE.get(k, PEAK_BY_DTYPE["fp32"])
               for k, n in flops_by_dtype.items())


def device_seconds(c: Costs) -> float:
    """A device's lower-bound time: the largest of its three terms."""
    return max(compute_seconds(c.flops_by_dtype), c.bytes / HBM_BW,
               c.coll_bytes / NVLINK_BW)


def collective_bytes(costs: Dict[str, Costs]) -> Dict[str, float]:
    """Per-collective byte totals over every device of a walk (the twin of
    the reference's totals from its HLO text)."""
    out = {k: 0.0 for k in COLLECTIVES}
    for c in costs.values():
        for k, v in c.per_collective.items():
            out[k] = out.get(k, 0.0) + v
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                 # the busiest device's FLOPs
    hbm_bytes: float             # its bytes accessed
    coll_bytes: float            # its collective bytes (received)
    chips: int
    model_flops: float = 0.0     # 6*N*D useful flops (global)
    per_collective: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    device: str = ""             # which device is the busiest
    # over every device of the walk (the reference's ``xla_*`` cross-check)
    total_flops: float = 0.0
    total_bytes: float = 0.0

    @property
    def compute_s(self) -> float:
        return compute_seconds(self.flops_by_dtype)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / the FLOPs of every device (remat/redundancy)."""
        total = self.total_flops
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline lower bound."""
        denom = self.step_s * self.chips * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_dev": self.flops, "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "flops_by_dtype": dict(sorted(self.flops_by_dtype.items())),
            "device": self.device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "step_s": self.step_s,
            "useful_ratio": self.useful_ratio, "mfu": self.mfu,
            "per_collective": self.per_collective,
            "total_flops": self.total_flops, "total_bytes": self.total_bytes,
        }


def from_walk(costs: Dict[str, Costs], chips: int,
              model_flops: float = 0.0) -> Roofline:
    """Roofline terms of the busiest device of a walk (``OpWalk.costs``),
    the twin of the reference's ``from_compiled``."""
    cards = [d for d in costs if d.startswith("cuda")] or list(costs)
    dev = max(cards, key=lambda d: device_seconds(costs[d])) if cards \
        else ""
    c = costs[dev] if dev else Costs()
    return Roofline(
        flops=c.flops, hbm_bytes=c.bytes, coll_bytes=c.coll_bytes,
        chips=chips, model_flops=model_flops,
        per_collective={k: int(v) for k, v in c.per_collective.items()},
        flops_by_dtype=dict(c.flops_by_dtype), device=dev,
        total_flops=sum(x.flops for x in costs.values()),
        total_bytes=sum(x.bytes for x in costs.values()))


def ideal_memory_bytes(cfg, shape, chips: int) -> float:
    """Analytic LOWER BOUND on per-device HBM traffic per step (perfect
    fusion). The walker's bytes term is the UPPER bound of eager execution
    (every op's operands and results); the report shows both. Components:
    weight reads (fwd+bwd+remat), optimizer read/write, residual
    activations, KV/index traffic for decode."""
    P = cfg.n_params()
    Pa = cfg.n_active_params()
    tokens = shape.global_batch * shape.seq_len
    d, L = cfg.d_model, cfg.n_layers
    act = 4 * tokens * d * L * 2  # residual write+read, fwd+bwd, bf16
    if shape.kind == "train":
        total = 3 * 2 * Pa * max(tokens / (tokens), 1) + 16 * P + act
        # 3 weight passes (fwd/bwd/remat) bf16 + grads/m/v fp32 rw
    elif shape.kind == "prefill":
        kv = L * tokens * cfg.n_kv_heads * cfg.hd * 2 * 2
        total = 2 * Pa + act / 4 + kv
    else:
        B = shape.global_batch
        ctx = shape.seq_len
        if cfg.family == "ssm":
            state = L * B * 2 * cfg.d_model * cfg.d_model // max(cfg.n_heads, 1)
            total = 2 * Pa * 1 + state * 2
        else:
            k = cfg.memory.top_k
            idx = B * ctx * cfg.memory.index_dim * 2 * L      # stream index
            gather = B * k * cfg.n_kv_heads * cfg.hd * 2 * 2 * L
            total = 2 * Pa + idx + gather
    return total / chips


def model_flops_for(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode D = batch tokens (1 step)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
