"""Checkpointing, elastic planning and sequence-parallel top-k / sparse
decode of the port (twin of ``repro.distributed``'s ``checkpoint``,
``elastic`` and ``topk``; the collectives, sharding and pipeline
parallelism wait for ROADMAP Queue 1 item 10b)."""
from repro_torch.distributed import checkpoint, elastic, topk

__all__ = ["checkpoint", "elastic", "topk"]
