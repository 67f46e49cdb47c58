"""Placement policy of the heterogeneous offload subsystem (twin of
``repro.hetero.policy``, paper §4 Table 2 + §5.2).

Per memory-pipeline stage, which side runs it. Two rules compose:

  1. KV ownership: a stage that reads the raw KV values (apply) stays with
     the device that owns the KV pool; shipping pages over the link is what
     the paper's index-only design avoids (``core.methods.offload_stages``).
  2. Roofline: among the offloadable stages only the memory-bound ones move
     (``placement.StageCost`` on the card's constants).

On top of the static plan sits the dynamic fallback: outside
``[min_context, fallback_context]`` the step runs dense on the main side and
the executor launches no offload work. ``dynamic_mode`` reads the one owner
of that window, ``placement.in_sparse_window``.

Devices: the offload role takes a second CUDA device when there is one,
else a CUDA stream of its own on the engine's card; on the CPU both roles
run on the CPU. The multi-device policies (``pick_devices_mesh`` /
``_replicas`` / ``_sharded``) follow the reference's rules over the local
CUDA devices (the CPU's one device in tests): contiguous groups, devices
shared round-robin when there are fewer than asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, MemoryConfig
from repro_torch.core import placement
from repro_torch.core.methods import offload_stages

MAIN = "main"
OFFLOAD = "offload"


@dataclasses.dataclass(frozen=True)
class OffloadPlan:
    """Static stage -> side plan plus the roofline evidence behind it."""

    method: str
    stages: Dict[str, str]            # stage -> MAIN | OFFLOAD
    intensity: Dict[str, float]       # stage -> FLOP/byte
    memory_bound: Dict[str, bool]

    def offloaded(self) -> Tuple[str, ...]:
        return tuple(s for s, d in self.stages.items() if d == OFFLOAD)


def plan_stage_placement(cfg: ArchConfig, mem: MemoryConfig, context: int,
                         batch: int = 1) -> OffloadPlan:
    """Static placement for the sparse-attention pipeline at ``context``."""
    costs = placement.sparse_attention_stage_costs(cfg, mem, context, batch)
    allowed = set(offload_stages(mem.method))
    stages, intensity, membound = {}, {}, {}
    for name, c in costs.items():
        intensity[name] = c.intensity
        membound[name] = c.memory_bound
        stages[name] = OFFLOAD if (name in allowed and c.memory_bound) \
            else MAIN
    return OffloadPlan(mem.method, stages, intensity, membound)


def dynamic_mode(context: int, mem: MemoryConfig) -> str:
    """'offload' | 'local'. ``context`` is the max live context of the step
    including the token being decoded (``lengths.max() + 1``)."""
    return "offload" if placement.in_sparse_window(context, mem) else "local"


def resolve_cli_offload(value: str, method: str) -> str:
    """Map ``--offload on|off|sync|overlap`` to an ``OffloadConfig.mode``.
    Raises ValueError when offload is asked for without a sparse method."""
    mode = {"on": "overlap", "off": "off"}.get(value, value)
    if mode != "off" and method == "none":
        raise ValueError(
            "--offload needs a sparse --method (dsa | seer | lserve)")
    return mode


def resolve_cli_retrieval(value: str) -> str:
    """Map ``--retrieval off|on|inline|sync|overlap`` to a
    ``retrieval.RetrievalConfig.mode`` ('on' = the overlapped service;
    'off' returns '' meaning no retrieval service)."""
    mode = {"on": "overlap", "off": ""}.get(value, value)
    if mode and mode not in ("inline", "sync", "overlap"):
        raise ValueError(f"unknown retrieval mode {value!r}")
    return mode


def pick_devices(device="cuda"):
    """(main, offload) torch devices for an engine on ``device``.

    With a second CUDA device the offload side gets it, as the reference
    takes its second JAX device; on one card (or the CPU) both are the
    engine's device, and the offload executor and the retrieval service
    keep their work apart on CUDA streams of their own instead."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        return torch.device("cuda", 0), torch.device("cuda", 1)
    if dev.type == "cuda" and dev.index is None:
        # indexed, as a tensor's device is: the executors compare them to
        # decide when a tensor read on the other stream must be recorded
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev, dev


def local_devices(device="cuda") -> List[torch.device]:
    """The distinct devices the multi-device policies split: every visible
    CUDA device for ``device`` on the card, else ``device`` alone."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def pick_devices_mesh(n_main: int, n_shards: int = 1, device="cuda"):
    """(main mesh devices, offload shard devices) for the fully sharded
    topology: mesh devices are [0, n), offload shards round-robin over the
    remainder (over every device when they run short).

    A mesh names each device once, so with fewer than ``n_main`` distinct
    devices it clamps to the largest DIVISOR of the request that fits: the
    engine's view granule is a multiple of the REQUESTED mesh, and a
    divisor keeps ``S % (n_shards * page_size) == 0`` for the clamped
    count. On one card (or the CPU) the mesh is that one device."""
    devs = local_devices(device)
    n = max(d for d in range(1, n_main + 1)
            if n_main % d == 0 and d <= len(devs))
    mains = tuple(devs[:n])
    pool = devs[n:] if len(devs) > n else devs
    return mains, tuple(pool[i % len(pool)] for i in range(n_shards))


def pick_devices_replicas(n_replicas: int, device="cuda"):
    """Contiguous device GROUPS, one per fleet replica (``serving.router``):
    each group's first device is the replica's main device, the rest its
    offload / retrieval side. ``N >= n_replicas`` devices give every replica
    ``N // n_replicas`` of them; fewer are shared round-robin (one card:
    every replica on it, each with streams of its own)."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    devs = local_devices(device)
    if len(devs) >= n_replicas:
        per = len(devs) // n_replicas
        return [tuple(devs[i * per:(i + 1) * per])
                for i in range(n_replicas)]
    return [(devs[i % len(devs)],) for i in range(n_replicas)]


def pick_devices_sharded(n_shards: int, device="cuda"):
    """(main, (offload_0, ..., offload_{n-1})) for the sharded executor:
    shards on devices 1..N-1 round-robin, or all on the one device there
    is (each shard then keeps a CUDA stream of its own)."""
    devs = local_devices(device)
    pool = devs[1:] if len(devs) >= 2 else devs
    return devs[0], tuple(pool[i % len(pool)] for i in range(n_shards))
