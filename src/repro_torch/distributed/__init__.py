"""Checkpointing and elastic planning of the port (twin of
``repro.distributed``'s ``checkpoint`` and ``elastic``; the collectives,
sharding and pipeline parallelism wait for ROADMAP Queue 1 item 10)."""
from repro_torch.distributed import checkpoint, elastic

__all__ = ["checkpoint", "elastic"]
