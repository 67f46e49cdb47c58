"""Placement policy (twin of ``repro.core.placement``): the heterogeneity
analysis of the paper (§4, Table 2), a roofline stage-cost model, and the
dynamic fallback window (§5.2 / Appendix F).

The reference decides the dense/sparse branch inside its jitted decode step
with a traced ``lax.cond``. The port's engine knows every slot's length on
the host, so it decides there, with the same predicate and no device sync;
a fused window (``serving/fused.py``) ends where the predicate would flip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ArchConfig, MemoryConfig

# Hardware constants of one NVIDIA H100 SXM5, from NVIDIA's data sheet
# (https://www.nvidia.com/en-us/data-center/h100/), dense rates without
# sparsity. The reference's are a TPU v5e's. The one table of the card's
# rates: the kernels' bounds (``kernels.cost``), the roofline
# (``launch.roofline``) and ``chip_smoke.py`` read them here.
PEAK_FLOPS = 989e12      # bf16 FLOP/s on the tensor cores (fp32 accumulate)
PEAK_FLOPS_FP32 = 67e12  # fp32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12         # B/s, HBM3
#: peak FLOP/s by the dtype key of ``kernels.cost.dtype_key``
PEAK_BY_DTYPE = {"bf16": PEAK_FLOPS, "fp32": PEAK_FLOPS_FP32}
HBM_BYTES = 80 * 2**30   # device memory of one card: 80 GB of HBM3 as
                         # NVIDIA counts it (2^30 bytes a GB)
NVLINK_BW = 450e9        # B/s one direction of NVLink 4 to the host's
                         # other cards (the sheet's 900 GB/s is both ways)
SMEM_BYTES = 227 * 2**10  # shared memory one block can use

# Power model for derived-energy estimates: the card's 700 W limit for
# compute-bound stages, and, for memory-bound ones, the reference's ratio
# of memory-bound to compute watts (120 / 200 = 0.6). A model, not a
# measurement.
POWER_COMPUTE_W = 700.0
POWER_MEMBOUND_W = 0.6 * POWER_COMPUTE_W


@dataclasses.dataclass(frozen=True)
class StageCost:
    flops: float
    bytes: float

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)

    @property
    def memory_bound(self) -> bool:
        """Roofline: HBM streaming, not FLOPs, sets this stage's time."""
        return self.bytes / HBM_BW >= self.flops / PEAK_FLOPS

    def seconds(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / HBM_BW)

    def watts(self) -> float:
        return POWER_MEMBOUND_W if self.memory_bound else POWER_COMPUTE_W


def sparse_attention_stage_costs(cfg: ArchConfig, mem: MemoryConfig,
                                 context: int, batch: int = 1
                                 ) -> Dict[str, StageCost]:
    """Analytic per-stage cost of the sparse-attention pipeline (one layer,
    one decode step), the paper's Table 2 / Appendix B accounting."""
    hd, kv = cfg.hd, cfg.n_kv_heads
    hi, di = mem.index_heads, mem.index_dim
    k = mem.top_k
    B = batch
    prepare = StageCost(  # index projection for the new token
        flops=2 * B * cfg.d_model * (hi * di + di),
        bytes=2 * B * (cfg.d_model * (hi * di + di)),
    )
    relevancy = StageCost(  # q_idx . k_idx over the full context
        flops=2 * B * hi * di * context,
        bytes=B * context * di * 2,  # stream compressed keys once (bf16)
    )
    retrieve = StageCost(  # top-k compare network over scores
        flops=B * context * 1.0,     # ~one compare-exchange per element
        bytes=B * context * 8,       # score + index streams
    )
    apply = StageCost(  # attention over k selected tokens
        flops=2 * B * cfg.n_heads * hd * k * 2,
        bytes=B * k * kv * hd * 2 * 2,
    )
    rest = StageCost(  # dense transformer step (projections + FFN)
        flops=2 * B * cfg.n_active_params() / cfg.n_layers,
        bytes=2 * cfg.n_active_params() / cfg.n_layers,
    )
    return {"prepare": prepare, "relevancy": relevancy, "retrieve": retrieve,
            "apply": apply, "rest": rest}


def dense_decode_cost(cfg: ArchConfig, context: int,
                      batch: int = 1) -> StageCost:
    hd, kv = cfg.hd, cfg.n_kv_heads
    return StageCost(
        flops=2 * batch * cfg.n_heads * hd * context * 2,
        bytes=batch * context * kv * hd * 2 * 2,
    )


def in_sparse_window(context: int, mem: MemoryConfig) -> bool:
    """Host-side dynamic-fallback window: below min_context the pipeline's
    overhead dominates; above fallback_context the compressed index spills.
    The one owner of the window: ``use_sparse`` and the hetero policy's
    ``dynamic_mode`` both read it."""
    if mem.method in ("none", "ttt"):
        return False
    return mem.min_context <= context <= mem.fallback_context


def choose_path(cfg: ArchConfig, mem: MemoryConfig, context: int,
                batch: int = 1) -> str:
    """'dense' | 'sparse': the paper's dynamic fallback, roofline-driven."""
    if not in_sparse_window(context, mem):
        return "dense"
    costs = sparse_attention_stage_costs(cfg, mem, context, batch)
    sparse_s = sum(c.seconds() for c in costs.values()) \
        - costs["rest"].seconds()
    dense_s = dense_decode_cost(cfg, context, batch).seconds()
    return "sparse" if sparse_s < dense_s else "dense"


def use_sparse(length, mem: MemoryConfig) -> bool:
    """Host twin of ``repro.core.placement.traced_use_sparse``: take the
    sparse pipeline iff the max context over slots sits inside
    [min_context, fallback_context]. ``length`` is a scalar or per-slot
    vector (pooled decode passes the masked lengths + 1)."""
    lmax = int(np.max(np.asarray(length)))
    return mem.min_context <= lmax <= mem.fallback_context


# Paper Table 2 (orders of magnitude of arithmetic intensity), used to check
# that measured intensities land in the right decade.
PAPER_TABLE2 = {
    "sparse_attention": {"prepare": (10, 100), "relevancy": (1, 10),
                         "retrieve": (0.1, 1), "apply": (10, 100),
                         "rest": (1, 10)},
    "rag": {"prepare": (1, 100), "relevancy": (1, 10), "retrieve": (0.1, 1),
            "apply": (0, 0), "rest": (100, 1e9)},
    "synthesized_memory": {"prepare": (1, 10), "apply": (100, 1e9),
                           "rest": (100, 1e9)},
    "memory_as_context": {"prepare": (100, 1e9), "relevancy": (1, 10),
                          "retrieve": (0.1, 1), "apply": (0, 0),
                          "rest": (100, 1e9)},
    "ttt": {"prepare": (100, 1e9), "relevancy": (1, 10),
            "apply": (100, 1e9), "rest": (100, 1e9)},
}
