"""Device and CLI policy of the retrieval subsystem (twin of
``repro.hetero.policy``'s ``pick_devices`` and ``resolve_cli_retrieval``;
the placement policy of the offload executor waits for ROADMAP Queue 1
item 8)."""
from __future__ import annotations

import torch

from repro_torch import resolve_device


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
    engine's device, and the retrieval service keeps its work apart on a
    CUDA stream of its own instead."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        return torch.device("cuda", 0), torch.device("cuda", 1)
    return dev, dev
