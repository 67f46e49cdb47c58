"""Core layers (twin of ``repro.models.layers``): RMSNorm, RoPE and M-RoPE,
SwiGLU MLP, embedding, LM head and the cross-entropy loss, as plain
functions over parameter dicts.

Weights are stored in ``cfg.dtype`` (bf16 by default); norms and RoPE run in
fp32 and cast back, matmuls run in the weights' dtype.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as col

Params = Dict[str, torch.Tensor]


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)          # "bfloat16" -> torch.bfloat16


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None, lead: Tuple[int, ...] = ()):
    """N(0, 1) * scale in fp32, cast to ``dtype``; scale 1/sqrt(d_in) by
    default. ``lead`` prepends stacked axes (one draw per layer)."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn(lead + (d_in, d_out), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["w"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, rotary_dim: Optional[int] = None):
    """Inverse frequencies for the rotary embedding (fp32 numpy)."""
    rd = rotary_dim or head_dim
    return 1.0 / (theta ** (np.arange(0, rd, 2, dtype=np.float32) / rd))


@functools.lru_cache(maxsize=16)
def _inv_freq_on(head_dim: int, theta: float, rotary_dim, device):
    """``rope_freqs`` as a tensor on ``device``, made once: a copy from the
    host inside a decode step would stall it, and cannot be captured in a
    CUDA graph. Callers only read it."""
    return torch.as_tensor(rope_freqs(head_dim, theta, rotary_dim),
                           device=device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 rotary_dim: Optional[int] = None):
    """positions [..., S] -> cos/sin [..., S, rd//2] in fp32."""
    inv = _inv_freq_on(head_dim, theta, rotary_dim, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=16)
def _mrope_owner_on(sections: Tuple[int, int, int], device):
    """[hd//2] long: the position stream (0 temporal, 1 height, 2 width)
    that owns each frequency channel, made once per device like
    ``_inv_freq_on``."""
    return torch.as_tensor(np.repeat(np.arange(3), np.asarray(sections)),
                           device=device).long()


def mrope_cos_sin(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, int, int]):
    """Qwen2-VL M-RoPE. positions3 [3, B, S] (temporal, height, width) ->
    cos/sin [B, S, hd//2] fp32: each stream owns a contiguous slice of the
    frequency channels (``sections`` sum to hd//2)."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} do not sum to "
                         f"head_dim // 2 = {head_dim // 2}")
    inv = _inv_freq_on(head_dim, theta, None, positions3.device)
    ang = positions3.float()[..., None] * inv           # [3, B, S, hd//2]
    owner = _mrope_owner_on(tuple(sections), positions3.device)
    ang = torch.gather(ang.movedim(0, -1), -1,
                       owner[:, None].expand(ang.shape[1:]
                                             + (1,)))[..., 0]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, S, H, hd]; cos/sin [B, S, rd//2] (broadcast over heads).
    Rotates the first ``2 * cos.shape[-1]`` channels."""
    rd2 = cos.shape[-1]
    xf = x.float()
    x1, x2, rest = xf[..., :rd2], xf[..., rd2:2 * rd2], xf[..., 2 * rd2:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, rest], dim=-1)
    return out.to(x.dtype)


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W1) * x W3) W2."""
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["w"][tokens.long()]


def lm_head(p: Params, x: torch.Tensor, cfg: ArchConfig,
            vocab_start: int = 0) -> torch.Tensor:
    """Logits over the PADDED vocab; pad rows masked to fp32's minimum. A
    model shard's weight holds the vocabulary's columns from
    ``vocab_start``, and masks its slice of the pad rows."""
    logits = x @ p["w"]
    first_pad = cfg.vocab_size - vocab_start      # in this slice's columns
    if first_pad < logits.shape[-1]:
        mask = torch.zeros((logits.shape[-1],), dtype=logits.dtype,
                           device=logits.device)
        mask[max(first_pad, 0):] = torch.finfo(torch.float32).min
        logits = logits + mask
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, fp32 logsumexp."""
    lf = logits.float()
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(lf, dim=-1) - gold).mean()


def cross_entropy_tp(logits, labels, starts) -> torch.Tensor:
    """``cross_entropy`` of logits cut over the vocabulary across a model
    group: member j's ``logits[j]`` hold the columns from ``starts[j]``,
    ``labels[j]`` is its copy of the labels. The max (no gradient), the sum
    of exps and the gold logit are all-reduced over the group in fp32; the
    loss is member 0's, one scalar."""
    lf = [x.float() for x in logits]
    mx = col.group_max([x.max(-1).values for x in lf])
    sums = col.group_all_reduce([torch.exp(x - m[..., None]).sum(-1)
                                 for x, m in zip(lf, mx)])
    golds = []
    for x, lab, s in zip(lf, labels, starts):
        i = lab.long() - s
        inside = (i >= 0) & (i < x.shape[-1])
        g = torch.gather(x, -1, i.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
        golds.append(torch.where(inside, g, torch.zeros_like(g)))
    gold = col.group_all_reduce(golds)
    return (torch.log(sums[0]) + mx[0] - gold[0]).mean()
