"""Device meshes of the port (twin of ``repro.launch.mesh``'s
``mesh_from_devices``).

A mesh here is a tuple of ``torch.device``: the sequence-parallel functions
of ``distributed.topk`` cut their sequence axis into one shard per entry,
run each shard on its device and merge on the first. A tuple may name one
device more than once (its shards then run there in turn), which is how one
card runs 2 or 4 shards. ``make_production_mesh`` and ``split_mesh_roles``
are not ported (ROADMAP Queue 1 item 14).
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
