"""Blockwise causal flash attention, the train / prefill path (twin of
``repro.kernels.flash_attention``).

Causal softmax attention with GQA (query head h reads kv head h // G, G =
H // KV) and an optional sliding window, in fp32, output in q's dtype.
``flash_attention`` launches the CUDA kernel (``csrc/flash_attention.cu``)
for CUDA tensors and runs ``flash_attention_plain`` for CPU tensors; it never
falls back from one to the other.

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
from repro_torch.kernels import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (32, 64, 128)     # the kernel's template cases


def flash_attention_plain(q, k, v, *, window: int = 0):
    """Plain-torch version: one exact softmax over the whole [S, S] score
    matrix (``ref.flash_attention``)."""
    return ref.flash_attention(q, k, v, window=window or None)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernel can read it through its strides (channel stride 1,
    every stride and the base a multiple of 4 elements), else a contiguous
    copy."""
    ok = (x.stride(-1) == 1 and all(s % 4 == 0 for s in x.stride()[:-1])
          and x.data_ptr() % (4 * x.element_size()) == 0)
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def flash_attention(q, k, v, *, window: int = 0):
    """q [B,S,H,dh]; k/v [B,S,KV,dh] (H % KV == 0) -> [B,S,H,dh] in q's
    dtype. ``window`` 0 is causal only. No gradient: see ``FlashAttention``."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, window=window)
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
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, out)
                                         for s in t.stride()[:3]])
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_cuda
    fn.restype = _I
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                   _I, _P, _P]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
             H, H // KV, dh, window, 1.0 / math.sqrt(dh),
             int(q.dtype == torch.bfloat16), strides, stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
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
        from repro_torch.models.attention import attend_causal

        q, k, v = ctx.saved_tensors
        G = q.shape[2] // k.shape[2]
        # a named range, so a profile can tell the recompute's device time
        with torch.enable_grad(), torch.profiler.record_function(
                "flash_attention.backward"):
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            out = attend_causal(q, k.repeat_interleave(G, dim=2),
                                v.repeat_interleave(G, dim=2),
                                window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), grad)
        return dq, dk, dv, None
