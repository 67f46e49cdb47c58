"""PyTorch / CUDA port of the memory-processing pipeline in ``repro``.

The layout mirrors ``src/repro``: each module here has its counterpart at
the same path there. Plain tensor code is PyTorch; the Pallas kernels of the
reference become CUDA C++ kernels for Hopper (``csrc/``), built at first use
and bound with ``ctypes`` (``kernels/_build.py``).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; a missing card raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    this process has no CUDA device (never a silent move to the CPU)."""
    dev = torch.device(device)
    # a placeholder card of a dry run (``launch.op_walk.Card``) needs none
    if isinstance(dev, torch.device) and dev.type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain PyTorch path")
    return dev

