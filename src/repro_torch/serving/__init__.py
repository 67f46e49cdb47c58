"""Serving stack of the port: paged continuous batching behind the
request-level API, stepped or fused decode, the hetero offload (sharded
selection, a main mesh), and the router over engine replicas (twin of
``repro.serving``)."""
from repro_torch.serving.api import Request, ResponseHandle
from repro_torch.serving.engine import Engine, OffloadConfig, ServeConfig
from repro_torch.serving.events import StepEvents
from repro_torch.serving.kv_cache import PagedKVPool, SlotManager
from repro_torch.serving.replica import EngineReplica, ReplicaMonitor
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import Scheduler

__all__ = [
    "Engine",
    "EngineReplica",
    "OffloadConfig",
    "PagedKVPool",
    "ReplicaMonitor",
    "Request",
    "ResponseHandle",
    "Router",
    "Scheduler",
    "ServeConfig",
    "SlotManager",
    "StepEvents",
]
