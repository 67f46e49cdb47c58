"""Device meshes of the port (twin of ``repro.launch.mesh``'s
``mesh_from_devices`` and ``split_mesh_roles``).

A mesh here is a tuple of ``torch.device``: the sequence-parallel functions
of ``distributed.topk`` cut their sequence axis into one shard per entry,
run each shard on its device and merge on the first. A tuple may name one
device more than once (its shards then run there in turn), which is how one
card runs 2 or 4 shards, or both roles of ``split_mesh_roles``.
``make_production_mesh`` (the reference's 16 x 16 TPU mesh for XLA
dry-runs) stays unported with ``dryrun`` (ROADMAP Queue 1 item 14b).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def mesh_from_devices(devices: Sequence) -> Tuple[torch.device, ...]:
    """A 1-D mesh over an explicit device list (the serving engine's main
    mesh claims specific devices so offload shards can round-robin over the
    rest)."""
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def split_mesh_roles(mesh: Sequence, prefill_fraction: float = 0.5):
    """Prefill/decode disaggregation (paper Fig. 6b): the first
    ``max(1, int(n * prefill_fraction))`` devices of the mesh prefill, the
    rest decode, as the reference cuts its mesh's data axis. Returns
    (prefill, decode) meshes; an empty role raises."""
    cut = max(1, int(len(mesh) * prefill_fraction))
    return mesh_from_devices(mesh[:cut]), mesh_from_devices(mesh[cut:])
