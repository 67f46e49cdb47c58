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

A model shard (``shard=(m, n)``: the reference's ``param_specs`` slice,
as GSPMD cuts the block) projects its columns of z / x / dt (its
d_inner / n channels, which are its ssm_heads / n heads: the x reshape is
head-major), convolves its channels of x, runs the replicated B / C convs
in full, and scans its heads. ``mamba_tp`` runs a model group in
lockstep: the gated norm's variance is over all of d_inner, each member's
fp32 sum of squares all-reduced over the group (``norm_sums``, an
autograd op, so the backward crosses members too), and ``out_proj`` is
row-parallel: each member returns its partial, which the caller
all-reduces.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as col
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


def shard_widths(cfg: ArchConfig, shard=None) -> Tuple[int, int]:
    """(d_inner, ssm_heads) that model shard ``shard = (m, n)`` computes
    (None: all). ``param_specs`` cuts ``w_dt``'s columns over ``model``,
    so heads that do not split n ways cannot be placed (jit's
    in_shardings refuse the uneven cut too)."""
    if shard is None:
        return cfg.d_inner, cfg.ssm_heads
    n = shard[1]
    if cfg.ssm_heads % n:
        raise ValueError(f"{cfg.name}: {cfg.ssm_heads} SSM heads do not split "
                         f"{n} ways over the model axis (param_specs cuts "
                         f"w_dt's columns: an uneven cut)")
    return cfg.d_inner // n, cfg.ssm_heads // n


def _project(p: Params, x: torch.Tensor, cfg: ArchConfig, conv_state=None,
             shard=None):
    """Shared prologue: projections, causal convs, dt and A. A model
    shard's ``p`` is its slice; a conv state of x that holds every channel
    (the decode layout keeps the conv states whole on every member) is
    narrowed to the shard's."""
    cs_x, cs_B, cs_C = conv_state if conv_state else (None, None, None)
    if shard is not None and cs_x is not None:
        di = shard_widths(cfg, shard)[0]
        if cs_x.shape[1] != di:
            cs_x = cs_x.narrow(1, shard[0] * di, di)
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


def _chunks(p: Params, x: torch.Tensor, cfg: ArchConfig,
            init_state: Tuple = None, shard=None):
    """The chunked SSD before the gated norm -> (y [B, S, di] fp32, z,
    (ssm_state, conv_states)); a model shard's over its channels."""
    B, S, _ = x.shape
    di, H = shard_widths(cfg, shard)
    P = cfg.ssm_head_dim
    cs = min(cfg.ssm_chunk, S)
    if S % cs:
        raise ValueError(f"sequence {S} is not a multiple of the SSD chunk "
                         f"{cs}")
    conv_in = None if init_state is None else init_state[1]
    z, xr, Br, Cr, dt, A, conv_state = _project(p, x, cfg, conv_in, shard)
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
    return torch.cat(ys, dim=1).reshape(B, S, di), z, (state, conv_state)


def mamba_forward(p: Params, x: torch.Tensor, cfg: ArchConfig,
                  init_state: Tuple = None):
    """x [B, S, d] -> (y [B, S, d], (ssm_state, conv_states)); chunked SSD
    over chunks of min(ssm_chunk, S) tokens (S must be a multiple)."""
    y, z, st = _chunks(p, x, cfg, init_state)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    return y.to(x.dtype) @ p["out_proj"], st


def _step(p: Params, x: torch.Tensor, cfg: ArchConfig, state: Tuple,
          shard=None):
    """One decode step before the gated norm -> (y [B, 1, di] fp32, z, new
    state); a model shard's over its heads."""
    B = x.shape[0]
    di, H = shard_widths(cfg, shard)
    P = cfg.ssm_head_dim
    ssm_state, conv_in = state
    z, xr, Br, Cr, dt, A, conv_state = _project(p, x, cfg, conv_in, shard)
    xs = xr[:, 0].reshape(B, H, P).float()
    Bm, Cm = Br[:, 0].float(), Cr[:, 0].float()
    dt = dt[:, 0]                                                # [B, H]
    decay = torch.exp(dt * A)
    ssm_state = (ssm_state.float() * decay[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xs * dt[..., None], Bm))
    y = torch.einsum("bhpn,bn->bhp", ssm_state, Cm) \
        + xs * p["D"][None, :, None]
    return y.reshape(B, 1, di), z, (ssm_state, conv_state)


def mamba_decode(p: Params, x: torch.Tensor, cfg: ArchConfig, state: Tuple):
    """Single-token step. x [B, 1, d]; state (ssm, conv_states) -> (y [B, 1,
    d], new state)."""
    y, z, st = _step(p, x, cfg, state)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    return y.to(x.dtype) @ p["out_proj"], st


def norm_sums(sums):
    """The members' fp32 sums of squares of the gated output, summed over
    the model group onto every member (forward and backward: a ring
    all-reduce in member order)."""
    return col.group_all_reduce(sums)


def _norm_out_tp(ps, pre, cfg: ArchConfig, dtype):
    """The gated norm over a model group, each member's (y, z) over its
    channels, the variance over all of d_inner; then each member's
    row-parallel ``out_proj`` partial [B, S, d] in ``dtype``."""
    gs = [y * F.silu(z.float()) for y, z, _ in pre]
    tot = norm_sums([(g * g).sum(-1, keepdim=True) for g in gs])
    return [(g * torch.rsqrt(t / cfg.d_inner + cfg.norm_eps)
             * p["norm"]).to(dtype) @ p["out_proj"]
            for p, g, t in zip(ps, gs, tot)]


def mamba_tp(ps, xs, cfg: ArchConfig, states=None):
    """A model group's Mamba2 blocks in lockstep: ``ps`` the members'
    block slices, ``xs`` each member's normed input [B, S, d]; the chunked
    forward from zero states (``mamba_forward``'s), or from ``states``
    (each member's SSM state of its heads and conv states, x's whole or
    its channels) one decode step (``mamba_decode``'s). -> (each member's
    ``out_proj`` partial, each member's new state: its heads, x's conv
    state of its channels, B's and C's whole)."""
    n = len(ps)
    if states is None:
        pre = [_chunks(p, x, cfg, None, (m, n))
               for m, (p, x) in enumerate(zip(ps, xs))]
    else:
        pre = [_step(p, x, cfg, st, (m, n))
               for m, (p, x, st) in enumerate(zip(ps, xs, states))]
    return _norm_out_tp(ps, pre, cfg, xs[0].dtype), [r[2] for r in pre]


def mamba_state_init(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device="cuda"):
    """Zero (ssm [B, H, P, N], (conv x [B, di, K-1], B, C [B, N, K-1]))."""
    dev = resolve_device(device)
    K = cfg.ssm_conv
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    return (z(batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            (z(batch, cfg.d_inner, K - 1), z(batch, cfg.ssm_state, K - 1),
             z(batch, cfg.ssm_state, K - 1)))
