"""The work of one kernel call (``KernelCost``), and the hook through which
a kernel wrapper reports it to an active op walk (``launch.op_walk``).

Each kernel module has a ``cost(...)`` beside its wrapper: the work of the
TPU kernel's function at a call's shapes, as operations by dtype and bytes
moved (each input read once, each output written once). One formula serves
every route: ``chip_smoke.py``'s bound column, and a walk's record of a
call on the kernel route (a CUDA tensor with kernels on, or a fake one),
where the kernel's work is invisible to torch's dispatcher (the launch goes
through ctypes). Where the work depends on the data (the tokens a paged
attention call finds valid), ``cost`` takes the counts as arguments and
counts every selected token without them: a walk passes shapes only, so
the same call counts the same on the card and on placeholder devices.

``ACTIVE["walk"]`` is the active walk, or None: a wrapper looks it up once
a call and does nothing else for it when there is none.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core.placement import HBM_BW, PEAK_BY_DTYPE

#: the active ``launch.op_walk.OpWalk``, or None
ACTIVE = {"walk": None}


def dtype_key(dtype: torch.dtype) -> str:
    """The rate a product of ``dtype`` inputs runs at: "bf16" (the tensor
    cores, bf16 or fp16 in, fp32 accumulate) or "fp32" (outside them)."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "fp32"


def dot_key(a: torch.Tensor, b: torch.Tensor) -> str:
    """Dot products of ``a`` by ``b`` computed in fp32: on the tensor cores
    when both are bf16, else on the fp32 cores."""
    both = a.dtype == b.dtype == torch.bfloat16
    return "bf16" if both else "fp32"


def is_fake(t: torch.Tensor) -> bool:
    """A tensor with no data (``FakeTensorMode``): a wrapper returns empty
    outputs of its kernel's shapes for it and launches nothing."""
    return isinstance(t, FakeTensor)


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """``terms``: (operations, dtype key) pairs, each type of operation at
    its own peak rate (``core.placement.PEAK_BY_DTYPE``); ``bytes``: the
    bytes the call must move."""
    terms: Tuple[Tuple[float, str], ...]
    bytes: float

    @property
    def flops(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, key in self.terms:
            out[key] = out.get(key, 0.0) + n
        return out

    @property
    def operations(self) -> float:
        return sum(n for n, _ in self.terms)

    def bound(self) -> Dict:
        """The least time for the call (ms): the larger of the bytes over
        the HBM rate and the operations over their peak rates, the types
        in turn."""
        t_b = self.bytes / HBM_BW * 1e3
        t_o = sum(n / PEAK_BY_DTYPE[key] for n, key in self.terms) * 1e3
        return {"bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "bytes": self.bytes, "operations": self.operations}
