"""Serving stack of the port: paged continuous batching behind the
request-level API, stepped or fused decode, the hetero offload (twin of
``repro.serving``; one engine, one offload shard)."""
from repro_torch.serving.api import Request, ResponseHandle
from repro_torch.serving.engine import Engine, OffloadConfig, ServeConfig
from repro_torch.serving.events import StepEvents
from repro_torch.serving.kv_cache import PagedKVPool, SlotManager
from repro_torch.serving.scheduler import Scheduler

__all__ = [
    "Engine",
    "OffloadConfig",
    "PagedKVPool",
    "Request",
    "ResponseHandle",
    "Scheduler",
    "ServeConfig",
    "SlotManager",
    "StepEvents",
]
