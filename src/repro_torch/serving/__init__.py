"""Serving stack of the port: paged continuous batching behind the
request-level API (twin of ``repro.serving``, main path only)."""
from repro_torch.serving.api import Request, ResponseHandle
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.events import StepEvents
from repro_torch.serving.kv_cache import PagedKVPool, SlotManager
from repro_torch.serving.scheduler import Scheduler

__all__ = [
    "Engine",
    "PagedKVPool",
    "Request",
    "ResponseHandle",
    "Scheduler",
    "ServeConfig",
    "SlotManager",
    "StepEvents",
]
