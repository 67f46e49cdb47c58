"""Mamba2 (SSD) block (twin of ``repro.models.ssm``): the chunked matmul form
for train and prefill, the O(1) recurrent state update for decode. One B/C
group (``ssm_groups == 1``); the z / x / B / C / dt projections are separate
weights, as in the reference.

The intra-chunk decay ``exp(cum_i - cum_j)`` is formed per (chunk, head
group of ``HEAD_GROUP``) only, bounding the live intermediate to [B, cs, cs,
hg]. It keeps the difference form (exponent <= 0 under the causal mask): the
factorised ``exp(cum_i) * exp(-cum_j)`` overflows fp32 for fast-decaying
heads even at init. The upper triangle's exponent (>= 0) can overflow, so
it is set to -inf before the ``exp``, which gives exactly 0 there. The
reference zeroes it after the ``exp`` instead (``where(mask, exp(diff),
0)``): the same forward, bit for bit, but its backward multiplies the
masked zeros by ``exp(diff)`` = inf, so every gradient turns NaN once a
chunk's decay passes fp32's range (zamba2 at full width at init: 112 heads
with A down to -112, 128-token chunks). The port's gradient is the
reference's wherever that is finite, and finite where it is not.

Dtypes follow the reference's promotion op for op: a causal conv over a
model-dtype input with no state stays in the model dtype (its new state
too); one continuing from an fp32 state (``mamba_state_init``'s) runs in
fp32. The SSM state and the scan are fp32.

State: ssm [B, H, P, N]; conv (x [B, di, K-1], B [B, N, K-1], C [B, N,
K-1]).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = Dict

HEAD_GROUP = 16  # heads per intra-chunk block


def mamba_init(gen: torch.Generator, cfg: ArchConfig, lead=()) -> Params:
    """The reference's distributions and scales, with ``lead`` stacked axes
    first (the draws differ from ``jax.random``)."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    K = cfg.ssm_conv
    dt = L.dtype_of(cfg)
    lead = tuple(lead)
    dev = gen.device

    def full(shape, value, dtype):
        return torch.full(lead + shape, value, dtype=dtype, device=dev)

    u = torch.rand(lead + (H,), generator=gen, device=dev)
    dt0 = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    conv = lambda c: (torch.randn(lead + (c, K), generator=gen, device=dev)
                      / np.sqrt(K)).to(dt)
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "w_z": L.dense_init(gen, d, di, dt, lead=lead),
        "w_x": L.dense_init(gen, d, di, dt, lead=lead),
        "w_B": L.dense_init(gen, d, N, dt, lead=lead),
        "w_C": L.dense_init(gen, d, N, dt, lead=lead),
        "w_dt": L.dense_init(gen, d, H, dt, lead=lead),
        "conv_x": conv(di),
        "conv_B": conv(N),
        "conv_C": conv(N),
        "conv_bx": full((di,), 0.0, dt),
        "conv_bB": full((N,), 0.0, dt),
        "conv_bC": full((N,), 0.0, dt),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": full((H,), 1.0, torch.float32),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),  # inverse softplus
        "norm": full((di,), 1.0, torch.float32),
        "out_proj": L.dense_init(gen, di, d, dt, lead=lead,
                                 scale=1.0 / np.sqrt(2 * cfg.n_layers * di)),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor = None):
    """Depthwise causal conv over S, then silu. x [B, S, C]; w [C, K];
    state [B, C, K-1] -> (out [B, S, C], new state [B, C, K-1])."""
    S = x.shape[1]
    K = w.shape[1]
    if state is None:
        padded = F.pad(x, (0, 0, K - 1, 0))
    else:
        dt = torch.promote_types(state.dtype, x.dtype)
        padded = torch.cat([state.transpose(1, 2).to(dt), x.to(dt)], dim=1)
    out = padded[:, 0:S] * w[:, 0]
    for k in range(1, K):
        out = out + padded[:, k:k + S] * w[:, k]
    new_state = padded[:, S:].transpose(1, 2) if K > 1 else None
    return F.silu(out + b), new_state


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                eps: float) -> torch.Tensor:
    y = y * F.silu(z.float())
    var = (y * y).mean(-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * w


def _project(p: Params, x: torch.Tensor, cfg: ArchConfig, conv_state=None):
    """Shared prologue: projections, causal convs, dt and A."""
    cs_x, cs_B, cs_C = conv_state if conv_state else (None, None, None)
    z = x @ p["w_z"]
    xr, ns_x = _causal_conv(x @ p["w_x"], p["conv_x"], p["conv_bx"], cs_x)
    Br, ns_B = _causal_conv(x @ p["w_B"], p["conv_B"], p["conv_bB"], cs_B)
    Cr, ns_C = _causal_conv(x @ p["w_C"], p["conv_C"], p["conv_bC"], cs_C)
    dt = _softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return z, xr, Br, Cr, dt, A, (ns_x, ns_B, ns_C)


def _intra_chunk(scores, cum, x_c, mask):
    """One chunk's intra term, head-grouped. scores [B, i, j]; cum [B, cs,
    H]; x_c [B, cs, H, P]; mask [cs, cs] bool -> [B, cs, H, P]."""
    H = cum.shape[2]
    hg = min(HEAD_GROUP, H)
    out = []
    for h0 in range(0, H, hg):
        cg = cum[:, :, h0:h0 + hg]
        diff = cg[:, :, None, :] - cg[:, None, :, :]            # [B,i,j,hg]
        Lm = torch.exp(torch.where(mask[None, :, :, None], diff,
                                   torch.full((), -torch.inf,
                                              dtype=diff.dtype,
                                              device=diff.device)))
        out.append(torch.einsum("bijh,bjhp->bihp", scores[..., None] * Lm,
                                x_c[:, :, h0:h0 + hg]))
    return torch.cat(out, dim=2)


def mamba_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                  init_state: Tuple = None):
    """x [B, S, d] -> (y [B, S, d], (ssm_state, conv_states)); chunked SSD
    over chunks of min(ssm_chunk, S) tokens (S must be a multiple)."""
    B, S, _ = x.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    cs = min(cfg.ssm_chunk, S)
    if S % cs:
        raise ValueError(f"sequence {S} is not a multiple of the SSD chunk "
                         f"{cs}")
    conv_in = None if init_state is None else init_state[1]
    z, xr, Br, Cr, dt, A, conv_state = _project(p, x, cfg, conv_in)
    xs = xr.reshape(B, S, H, P).float()
    Bm, Cm = Br.float(), Cr.float()
    dA = dt * A                                                  # [B, S, H]
    xdt = xs * dt[..., None]
    mask = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                 device=x.device))
    state = (torch.zeros((B, H, P, cfg.ssm_state), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state[0].float())
    ys = []
    for c0 in range(0, S, cs):
        sl = slice(c0, c0 + cs)
        x_c, B_c, C_c = xdt[:, sl], Bm[:, sl], Cm[:, sl]
        cum = torch.cumsum(dA[:, sl], dim=1)                    # [B, cs, H]
        scores = torch.einsum("bin,bjn->bij", C_c, B_c)
        y = _intra_chunk(scores, cum, x_c, mask)
        y = y + torch.einsum("bin,bhpn->bihp", C_c, state) \
            * torch.exp(cum)[..., None]
        y = y + xs[:, sl] * p["D"][None, None, :, None]
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)
        state = (state * torch.exp(cum[:, -1, :])[:, :, None, None]
                 + torch.einsum("bjn,bjhp->bhpn", B_c,
                                decay_to_end[..., None] * x_c))
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, S, di)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    return y.to(x.dtype) @ p["out_proj"], (state, conv_state)


def mamba_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, state: Tuple):
    """Single-token step. x [B, 1, d]; state (ssm, conv_states) -> (y [B, 1,
    d], new state)."""
    B = x.shape[0]
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    ssm_state, conv_in = state
    z, xr, Br, Cr, dt, A, conv_state = _project(p, x, cfg, conv_in)
    xs = xr[:, 0].reshape(B, H, P).float()
    Bm, Cm = Br[:, 0].float(), Cr[:, 0].float()
    dt = dt[:, 0]                                                # [B, H]
    decay = torch.exp(dt * A)
    ssm_state = (ssm_state.float() * decay[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xs * dt[..., None], Bm))
    y = torch.einsum("bhpn,bn->bhp", ssm_state, Cm) \
        + xs * p["D"][None, :, None]
    y = _gated_norm(y.reshape(B, 1, di), z, p["norm"], cfg.norm_eps)
    return y.to(x.dtype) @ p["out_proj"], (ssm_state, conv_state)


def mamba_state_init(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device="cuda"):
    """Zero (ssm [B, H, P, N], (conv x [B, di, K-1], B, C [B, N, K-1]))."""
    dev = resolve_device(device)
    K = cfg.ssm_conv
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    return (z(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            (z(batch, cfg.d_inner, K - 1), z(batch, cfg.ssm_state, K - 1),
             z(batch, cfg.ssm_state, K - 1)))
