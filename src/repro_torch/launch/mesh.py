"""Device meshes of the port (twin of ``repro.launch.mesh``'s ``make_mesh``,
``mesh_from_devices`` and ``split_mesh_roles``).

Two forms, each for its callers:

* ``make_mesh`` gives a named mesh (``Mesh``), the form the sharding rules,
  the sharded train step, GPipe and checkpoint resharding take: one process
  drives every entry of the mesh, as one JAX program drives every device of
  its mesh. An entry is a ``torch.device``, and one card may fill many
  entries (one card gives eight ``cuda:0`` entries on a (2, 4) mesh).
* The serving code takes a tuple of ``torch.device``: the sequence-parallel
  functions of ``distributed.topk`` cut their sequence axis into one shard
  per entry, run each shard on its device and merge on the first. A tuple
  may name one device more than once (its shards then run there in turn),
  which is how one card runs 2 or 4 shards, or both roles of
  ``split_mesh_roles``.

``make_production_mesh`` gives the reference's production meshes, 16 x 16
("data", "model") or 2 x 16 x 16 ("pod", "data", "model"), over distinct
device names ``cuda:0 .. cuda:n-1``. Naming a device needs no card: the dry
run (``launch.dryrun``) places fake tensors there under
``op_walk.placeholders()``. The reference's ``use_mesh`` (``jax.set_mesh``,
the mesh context its jitted steps read for sharding constraints) has no
twin: nothing in the port reads a current mesh, every function that needs
one takes it as an argument (ROADMAP Queue 1 item 14b).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.op_walk import Card, cards


class Mesh:
    """A named mesh: ``shape`` ({axis: size} in axis order, as JAX's
    ``Mesh.shape``), ``axis_names`` and ``devices`` (an object array of
    ``torch.device`` of that shape). Coordinates are numbered in C order of
    ``devices`` (``np.ndindex``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, i: int) -> torch.device:
        """The device of flat coordinate ``i``."""
        return self.devices.flat[i]

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """The flat coordinates grouped by their indices along ``axes``
        (raveled major to minor, as a dim sharded over ``axes`` is cut):
        group k holds, in coordinate order, every coordinate whose indices
        along ``axes`` ravel to k."""
        pos = [self.axis_names.index(a) for a in axes]
        sizes = [self.devices.shape[p] for p in pos]
        out: List[List[int]] = [[] for _ in range(math.prod(sizes))]
        for i, idx in enumerate(np.ndindex(self.devices.shape)):
            out[int(np.ravel_multi_index([idx[p] for p in pos],
                                         sizes))].append(i)
        return out


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes`` over ``devices`` (each
    entry a ``torch.device``, its name, or a placeholder ``op_walk.Card``),
    taken round-robin when there are
    fewer devices than entries. ``devices=None`` takes the visible CUDA
    devices and raises when there is none (tests pass ``devices=["cpu"]``).
    ``elastic.plan_mesh``'s ``(shape, axes)`` go in as they are."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} vs axes {axes}")
    if devices is None:
        n = torch.cuda.device_count()
        if not n:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=['cpu'] for a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = [d if isinstance(d, Card) else torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    arr = np.empty(math.prod(shape), dtype=object)
    for i in range(arr.size):
        arr[i] = devs[i % len(devs)]
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) on ("data", "model"), or (2, 16, 16) on ("pod", "data",
    "model") with ``multi_pod``, one distinct ``cuda:k`` per entry in C
    order, each an ``op_walk.Card`` (torch's own device index stops at
    127); they name no card, and ``op_walk.placeholders()`` places on
    them."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=cards(math.prod(shape)))


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
