"""Paged sparse decode attention, the Apply-to-Inference stage (twin of
``repro.kernels.sparse_decode_attention``).

One query per slot attends over the retrieved KV pages only, with an fp32
online softmax, and returns (out, lse) so partial results can be LSE-merged.

``paged_decode_attention`` launches the CUDA kernel
(``csrc/paged_decode_attention.cu``) for CUDA tensors and runs
``paged_decode_attention_plain`` for CPU tensors; it never falls back from one
to the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lengths(length, B: int, device) -> torch.Tensor:
    return torch.as_tensor(length, dtype=torch.int32,
                           device=device).reshape(-1).expand(B).contiguous()


def paged_decode_attention_plain(q, k_cache, v_cache, page_ids, length, *,
                                 page_size: int = 64):
    """Plain-torch version: gathers the selected pages and runs one exact
    softmax over them (``ref.paged_decode_attention``)."""
    return ref.paged_decode_attention(q, k_cache, v_cache, page_ids,
                                      page_size, length)


def paged_decode_attention(q, k_cache, v_cache, page_ids, length, *,
                           page_size: int = 64):
    """q [B,Hq,dh]; k/v [B,S,KV,dh]; page_ids [B,P] (-1 = hole); length [B]
    or [] -> (out [B,Hq,dh] fp32, lse [B,Hq] fp32)."""
    if not k_cache.is_cuda:
        return paged_decode_attention_plain(q, k_cache, v_cache, page_ids,
                                            length, page_size=page_size)
    B, S, KV, dh = k_cache.shape
    Hq = q.shape[1]
    ps = page_size
    if (q.shape != (B, Hq, dh) or v_cache.shape != k_cache.shape
            or page_ids.dim() != 2 or page_ids.shape[0] != B):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)}"
                         f" v {tuple(v_cache.shape)} pages "
                         f"{tuple(page_ids.shape)} do not agree")
    if Hq % KV or S % ps:
        raise ValueError(f"need Hq % KV == 0 and S % page_size == 0, got "
                         f"Hq={Hq} KV={KV} S={S} page_size={ps}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype
            and q.dtype in (torch.float32, torch.bfloat16)):
        raise TypeError(f"q/k/v must share fp32 or bf16, got {q.dtype}/"
                        f"{k_cache.dtype}/{v_cache.dtype}")
    dev = k_cache.device
    if not (q.device == v_cache.device == page_ids.device == dev):
        raise ValueError("q, k, v and page_ids must be on one CUDA device")
    q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), \
        v_cache.contiguous()
    pages = page_ids.to(torch.int32).contiguous()
    lens = _lengths(length, B, dev)
    out = torch.empty((B, Hq, dh), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=dev)
    lib = _build.load("paged_decode_attention")
    fn = lib.paged_decode_attention_cuda
    fn.restype = _I
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I, _P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             pages.data_ptr(), lens.data_ptr(), out.data_ptr(), lse.data_ptr(),
             B, S, KV, Hq // KV, dh, ps, pages.shape[1], math.sqrt(dh),
             int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out, lse


paged_decode_attention.launches = 0


def lse_merge(outs: torch.Tensor, lses: torch.Tensor):
    """Merge N partial attention results: outs [N, B, H, dh], lses [N, B, H].

    FlashDecoding combine: a softmax over the shard LSEs reweights the shard
    outputs.
    """
    m = lses.amax(0)
    w = torch.exp(lses - m[None])
    den = w.sum(0)
    out = (outs * w[..., None]).sum(0) / den[..., None].clamp(min=1e-30)
    return out, m + torch.log(den.clamp(min=1e-30))
