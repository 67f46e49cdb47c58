"""Blockwise causal flash attention, the train / prefill path (twin of
``repro.kernels.flash_attention``).

Causal softmax attention with GQA (query head h reads kv head h // G, G =
H // KV) and an optional sliding window, in fp32, output in q's dtype.
``flash_attention`` launches a CUDA kernel for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors; it never falls back from one to
the other. On the card ``_route`` picks the kernel by dtype and head dim
alone: bf16 at head dim 64, 112 or 128 goes to the tensor-core kernel
(``csrc/flash_attention_sm90.cu``: TMA loads, wgmma, P split into bf16 high
and low parts; dh 112 in two 64-channel boxes, zero past 112), everything
else, fp32 at every head dim included, to the CUDA-core kernel
(``csrc/flash_attention.cu``: every product an fp32 FMA), the exact route.
``ROUTE_LAUNCHES`` counts the launches of each route.

``FlashAttention`` makes it differentiable. The JAX package has no backward
kernel: its training differentiates XLA's ``attention_full`` outside any
Pallas kernel. So the port writes none either: the backward recomputes
attention through the chunked plain code of ``models.attention`` under
``torch.enable_grad()`` and takes ``torch.autograd.grad`` of it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.kernels import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (32, 64, 112, 128)  # the CUDA-core kernel's template cases
TC_HEAD_DIMS = (64, 112, 128)  # the tensor-core kernel's
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
#: launches of each route since the last reset (``ops.reset_launch_counts``)
ROUTE_LAUNCHES = {TENSOR_CORES: 0, CUDA_CORES: 0}


def flash_attention_plain(q, k, v, *, window: int = 0):
    """Plain-torch version: one exact softmax over the whole [S, S] score
    matrix (``ref.flash_attention``)."""
    return ref.flash_attention(q, k, v, window=window or None)


def _route(dtype: torch.dtype, dh: int) -> str:
    """The kernel a CUDA call takes, by dtype and head dim only."""
    if dtype == torch.bfloat16 and dh in TC_HEAD_DIMS:
        return TENSOR_CORES
    return CUDA_CORES


def _readable(strides, ptr: int, itemsize: int, route: str) -> bool:
    """Whether a kernel can read a tensor in place: channel stride 1, and
    the base and every other stride a multiple of 16 bytes for the
    tensor-core route (TMA's rule), of 4 elements for the CUDA-core one."""
    align = 16 if route == TENSOR_CORES else 4 * itemsize
    return (strides[-1] == 1 and ptr % align == 0
            and all(s * itemsize % align == 0 for s in strides[:-1]))


def _aligned(x: torch.Tensor, route: str) -> torch.Tensor:
    """``x`` if the route's kernel can read it through its strides, else a
    contiguous copy."""
    if _readable(x.stride(), x.data_ptr(), x.element_size(), route):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def causal_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs the causal band keeps, under a window if given."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def cost(q, k, v, *, window: int = 0) -> _cost.KernelCost:
    """The work of one call: q.k and p.v over the causal band's pairs only
    (not the full S x S tile), 4 B H dh FLOPs a pair, on the tensor cores
    for bf16; q, k, v read once, out written once."""
    B, S, H, dh = q.shape
    es = q.element_size()
    return _cost.KernelCost(
        ((4 * B * H * dh * causal_pairs(S, window),
          _cost.dtype_key(q.dtype)),),
        (q.numel() + 2 * k.numel()) * es + q.numel() * es)


def flash_attention(q, k, v, *, window: int = 0):
    """q [B,S,H,dh]; k/v [B,S,KV,dh] (H % KV == 0) -> [B,S,H,dh] in q's
    dtype. ``window`` 0 is causal only. No gradient: see ``FlashAttention``.
    Under an op walk the call records its ``cost``."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, window=window)
    walk = _cost.ACTIVE["walk"]
    if walk is not None:
        return walk.kernel("flash_attention", q, cost(q, k, v, window=window),
                           lambda: _launch(q, k, v, window))
    return _launch(q, k, v, window)


def _launch(q, k, v, window):
    B, S, H, dh = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, dh) or v.shape != k.shape or H % KV:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} do not agree (need H % KV == 0)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.float32, torch.bfloat16)):
        raise TypeError(f"q/k/v must share fp32 or bf16, got {q.dtype}/"
                        f"{k.dtype}/{v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one CUDA device")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    out = q.new_empty((B, S, H, dh))
    if out.numel() == 0 or _cost.is_fake(q):
        return out
    route = _route(q.dtype, dh)
    q, k, v = (_aligned(t, route) for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, out)
                                         for s in t.stride()[:3]])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, H // KV, dh, window, 1.0 / math.sqrt(dh))
    if route == TENSOR_CORES:
        lib = _build.load("flash_attention_sm90")
        fn = lib.flash_attention_sm90_cuda
        fn.restype = _I
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _P, _P]
        err = fn(*args, strides, stream)
    else:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_cuda
        fn.restype = _I
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _P, _P]
        err = fn(*args, int(q.dtype == torch.bfloat16), strides, stream)
    _build.check(lib, err, f"flash_attention ({route})")
    flash_attention.launches += 1
    ROUTE_LAUNCHES[route] += 1
    return out


flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward launches the kernel
    (on the card), the backward recomputes the plain chunked attention of
    ``models.attention`` and differentiates it."""

    @staticmethod
    def forward(ctx, q, k, v, window: int = 0):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return flash_attention(q, k, v, window=window)

    @staticmethod
    def backward(ctx, grad):
        from repro_torch.launch.op_walk import placing
        from repro_torch.models.attention import attend_causal

        q, k, v = ctx.saved_tensors
        G = q.shape[2] // k.shape[2]
        # a named range, so a profile can tell the recompute's device time;
        # under placeholders the recompute's tensors go on q's card
        with torch.enable_grad(), placing(), torch.profiler.record_function(
                "flash_attention.backward"):
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = attend_causal(q, k.repeat_interleave(G, dim=2),
                                v.repeat_interleave(G, dim=2),
                                window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None
