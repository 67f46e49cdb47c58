"""Heterogeneous offload subsystem of the port (twin of ``repro.hetero``,
paper §4-§5).

The sparse, memory-bound memory-processing stages (prepare / relevancy /
retrieve) run on the offload side, one step of lookahead ahead, and
exchange only page indices with the main side, which keeps the KV pool and
the compute-dense decode (apply + rest). The offload side is a second CUDA
device when there is one, else a CUDA stream of its own on the engine's
card; on the CPU both sides run in program order. ``ShardedHeteroExecutor``
cuts the offload side into KV-sequence shards, one device or stream each,
and merges their candidates; the ``pick_devices_*`` policies lay out mesh,
shards and fleet replicas over the local devices.
"""
from repro_torch.hetero.executor import HeteroExecutor
from repro_torch.hetero.policy import (OffloadPlan, dynamic_mode, pick_devices,
                                       pick_devices_mesh,
                                       pick_devices_replicas,
                                       pick_devices_sharded,
                                       plan_stage_placement,
                                       resolve_cli_offload,
                                       resolve_cli_retrieval)
from repro_torch.hetero.profiler import HeteroProfiler
from repro_torch.hetero.select import (OffloadSelect, make_offload_select,
                                       merge_shard_topk)
from repro_torch.hetero.sharded import ShardedHeteroExecutor
from repro_torch.hetero.transfer import TransferLedger, pytree_bytes

__all__ = [
    "HeteroExecutor", "HeteroProfiler", "OffloadPlan", "OffloadSelect",
    "ShardedHeteroExecutor", "TransferLedger", "dynamic_mode",
    "make_offload_select", "merge_shard_topk", "pick_devices",
    "pick_devices_mesh", "pick_devices_replicas", "pick_devices_sharded",
    "plan_stage_placement", "pytree_bytes", "resolve_cli_offload",
    "resolve_cli_retrieval",
]
