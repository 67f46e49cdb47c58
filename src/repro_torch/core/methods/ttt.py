"""Test-time training, TTT / LaCT (twin of ``repro.core.methods.ttt``),
paper Table 1 row 9.

  prepare   backward pass (fast-weight gradient step over a chunk)
  relevancy compute reconstruction loss
  retrieve  N/A (parameterized memory, bypassed)
  apply     forward pass through the updated fast weights

Paper §4: "the heterogeneity is insufficient ... we do NOT deploy it on the
heterogeneous system". The reference mirrors that (``ttt.py:8-11``): the
layer always runs the dense path, with no Pallas kernel and no offload, so
that the profiler can still measure its stage breakdown for Fig. 5 /
Table 2. The port does the same: its products are ``torch.bmm`` /
``einsum`` over the chunks, in order (the reference's ``lax.scan``).

LaCT-style batched (chunked) update: W <- W - lr * phi(K)^T (phi(K) W - V).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline import MemoryPipeline
from repro_torch.models import layers as L

Params = Dict

# Hetero offload metadata: paper §4; every stage stays on the main device.
OFFLOAD_STAGES = ()


def ttt_init(cfg: ArchConfig, seed: int = 0, *, fast_dim: int = 0,
             device="cuda") -> Params:
    """Seeded fp32 projections wq / wk / wv [d, f] and out [f, d] (scale
    1/sqrt(d_in)) drawn from one ``torch.Generator`` in that order, and the
    fast-weight step size ``lr`` = 0.1 (0-d fp32); the draws differ from
    ``jax.random``'s. As in the reference, ``lr`` does not scale with the
    width: a chunk's step is stable while lr x the largest eigenvalue of
    k^T k / chunk stays below 2, which holds at fast_dim 32 and fails at
    2048 (silu keys have a mean, so that eigenvalue grows with f)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = cfg.d_model
    f = fast_dim or d
    return {"wq": L.dense_init(gen, d, f, torch.float32),
            "wk": L.dense_init(gen, d, f, torch.float32),
            "wv": L.dense_init(gen, d, f, torch.float32),
            "out": L.dense_init(gen, f, d, torch.float32),
            "lr": torch.tensor(0.1, dtype=torch.float32, device=dev)}


def fast_state_init(cfg: ArchConfig, batch: int, fast_dim: int = 0, *,
                    device="cuda") -> torch.Tensor:
    f = fast_dim or cfg.d_model
    return torch.zeros((batch, f, f), dtype=torch.float32,
                       device=resolve_device(device))


def ttt_forward(p: Params, x: torch.Tensor, state: torch.Tensor,
                chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d]; state W [B, f, f] -> (y [B, S, d] in x's dtype, W')."""
    B, S, d = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of chunk {chunk}")
    nc = S // chunk
    xf = x.float()
    q = torch.nn.functional.silu(xf @ p["wq"]).reshape(B, nc, chunk, -1)
    k = torch.nn.functional.silu(xf @ p["wk"]).reshape(B, nc, chunk, -1)
    v = (xf @ p["wv"]).reshape(B, nc, chunk, -1)
    W, ys = state, []
    for c in range(nc):
        qc, kc, vc = q[:, c], k[:, c], v[:, c]       # [B, chunk, f]
        # relevancy: reconstruction residual (loss gradient)
        resid = torch.bmm(kc, W) - vc
        # prepare: batched gradient step on the fast weights (LaCT)
        W = W - p["lr"] / chunk * torch.bmm(kc.transpose(1, 2), resid)
        # apply: forward through the updated weights
        ys.append(torch.bmm(qc, W))
    y = torch.stack(ys, dim=1).reshape(B, S, -1)
    return (y @ p["out"]).to(x.dtype), W


def build_pipeline(p: Params, chunk: int = 256) -> MemoryPipeline:
    """The reference's three stages over one chunk: prepare((W, kc, vc)) ->
    W', relevancy(W, (kc, vc)) -> the scalar loss, apply(W', qc) -> y. As in
    the reference, ``run`` hands relevancy's loss to apply as the fast
    weights, so it raises; callers time the stages directly."""

    def prepare(M):
        W, kc, vc = M
        resid = torch.einsum("bcf,bfg->bcg", kc, W) - vc
        return W - p["lr"] / kc.shape[1] * torch.einsum("bcf,bcg->bfg", kc,
                                                          resid)

    def relevancy(W, x):
        kc, vc = x
        resid = torch.einsum("bcf,bfg->bcg", kc, W) - vc
        return 0.5 * torch.mean(resid * resid)

    def apply(Mp, x):
        W = Mp if isinstance(Mp, torch.Tensor) else Mp[0]
        qc = x[0] if isinstance(x, tuple) else x
        return torch.einsum("bcf,bfg->bcg", qc, W)

    return MemoryPipeline(name="ttt", prepare=prepare, relevancy=relevancy,
                          retrieve=None, apply=apply)
