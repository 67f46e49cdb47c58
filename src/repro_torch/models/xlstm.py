"""xLSTM blocks (twin of ``repro.models.xlstm``): mLSTM (matrix memory,
exponential gating) and sLSTM (scalar memory, block-diagonal recurrence)
[arXiv:2405.04517].

Both run the stabilised recurrence (running max ``m``) as a Python loop over
time in fp32, as the reference's ``lax.scan``: exact, and O(1) state for
decode. In eager PyTorch that is some 25 launches a token a block; it is
recorded, not sped up. sLSTM rounds its input product to the model dtype
before the fp32 gate bias is added, where the reference does.

States:
  mLSTM: (C [B, H, dk, dv], n [B, H, dk], m [B, H])
  sLSTM: (c [B, H, dh], n [B, H, dh], h [B, H, dh], m [B, H, dh])
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def mlstm_init(gen: torch.Generator, cfg: ArchConfig, lead=()) -> Params:
    d = cfg.d_model
    di = 2 * d                               # expansion 2
    H = cfg.n_heads
    dt = L.dtype_of(cfg)
    lead = tuple(lead)
    full = lambda shape, v: torch.full(lead + shape, v, dtype=torch.float32,
                                       device=gen.device)
    return {
        "up": L.dense_init(gen, d, 2 * di, dt, lead=lead),  # (inner, z)
        "wq": L.dense_init(gen, di, di, dt, lead=lead),
        "wk": L.dense_init(gen, di, di, dt, lead=lead),
        "wv": L.dense_init(gen, di, di, dt, lead=lead),
        "wi": L.dense_init(gen, di, H, torch.float32, scale=0.02, lead=lead),
        "wf": L.dense_init(gen, di, H, torch.float32, scale=0.02, lead=lead),
        "bi": full((H,), 0.0),
        "bf": full((H,), 3.0),               # forget-dominant init
        "norm": full((di,), 1.0),
        "down": L.dense_init(gen, di, d, dt, lead=lead,
                             scale=1.0 / np.sqrt(2 * cfg.n_layers * di)),
    }


def mlstm_state_init(cfg: ArchConfig, batch: int, device="cuda"):
    dev = resolve_device(device)
    H = cfg.n_heads
    dh = 2 * cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.zeros((batch, H, dh, dh), **f32),
            torch.zeros((batch, H, dh), **f32),
            torch.full((batch, H), -1e30, **f32))


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ArchConfig, state=None):
    """x [B, S, d] -> (y [B, S, d], state)."""
    B, S, d = x.shape
    H = cfg.n_heads
    di = 2 * d
    dh = di // H
    up = x @ p["up"]
    inner, z = up[..., :di], up[..., di:]
    q = (inner @ p["wq"]).reshape(B, S, H, dh).float() / np.sqrt(dh)
    k = (inner @ p["wk"]).reshape(B, S, H, dh).float() / np.sqrt(dh)
    v = (inner @ p["wv"]).reshape(B, S, H, dh).float()
    logi = inner.float() @ p["wi"] + p["bi"]                     # [B, S, H]
    logf = F.logsigmoid(inner.float() @ p["wf"] + p["bf"])
    if state is None:
        state = mlstm_state_init(cfg, B, device=x.device)
    C, n, m = state
    hs = []
    for t in range(S):
        qt, kt, vt = q[:, t], k[:, t], v[:, t]
        it, ft = logi[:, t], logf[:, t]
        m_new = torch.maximum(ft + m, it)                        # [B, H]
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(ft + m - m_new)
        C = f_s[..., None, None] * C + i_s[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])                 # [B,H,dk,dv]
        n = f_s[..., None] * n + i_s[..., None] * kt
        num = torch.einsum("bhkv,bhk->bhv", C, qt)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qt).abs(),
                            torch.exp(-m_new))[..., None]
        m = m_new
        hs.append(num / den)
    h = torch.stack(hs, dim=1).reshape(B, S, di)
    h = L.rms_norm({"w": p["norm"]}, h.to(x.dtype), cfg.norm_eps)
    h = h * F.silu(z)
    return h @ p["down"], (C, n, m)


def slstm_init(gen: torch.Generator, cfg: ArchConfig, lead=()) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    dt = L.dtype_of(cfg)
    lead = tuple(lead)
    dev = gen.device
    w = torch.randn(lead + (4, d, d), generator=gen, device=dev) / np.sqrt(d)
    r = torch.randn(lead + (4, H, dh, dh), generator=gen, device=dev) \
        / np.sqrt(dh)
    b = torch.zeros(lead + (4, d), dtype=torch.float32, device=dev)
    b[..., 1, :] = 3.0                                           # forget bias
    return {
        "w": w.to(dt),                       # input weights (i, f, z, o)
        "r": r,                              # block-diagonal recurrence
        "b": b,
        "norm": torch.ones(lead + (d,), dtype=torch.float32, device=dev),
        "out": L.dense_init(gen, d, d, dt, lead=lead,
                            scale=1.0 / np.sqrt(2 * cfg.n_layers * d)),
    }


def slstm_state_init(cfg: ArchConfig, batch: int, device="cuda"):
    """(c, n, h, m) = (0, 1e-6, 0, -10), each [B, H, dh] fp32."""
    dev = resolve_device(device)
    H = cfg.n_heads
    z = torch.zeros((batch, H, cfg.d_model // H), dtype=torch.float32,
                    device=dev)
    return (z, z + 1e-6, z.clone(), z - 10.0)


def slstm_forward(p: Params, x: torch.Tensor, cfg: ArchConfig, state=None):
    """x [B, S, d] -> (y [B, S, d], state)."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    # the input product in the model dtype, then the fp32 bias
    gates_in = torch.einsum("bsd,gde->gbse", x, p["w"].to(x.dtype))
    gates_in = gates_in.float() + p["b"][:, None, None, :]
    gates_in = gates_in.reshape(4, B, S, H, dh)
    if state is None:
        state = slstm_state_init(cfg, B, device=x.device)
    c, n, h, m = state
    hs = []
    for t in range(S):
        rec = torch.einsum("ghkl,bhk->gbhl", p["r"], h)          # [4,B,H,dh]
        gi, gf, gz, go = gates_in[:, :, t] + rec
        lf = F.logsigmoid(gf)
        m_new = torch.maximum(lf + m, gi)
        i_s = torch.exp(gi - m_new)
        f_s = torch.exp(lf + m - m_new)
        c = f_s * c + i_s * torch.tanh(gz)
        n = f_s * n + i_s
        h = torch.sigmoid(go) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, d)
    y = L.rms_norm({"w": p["norm"]}, y.to(x.dtype), cfg.norm_eps)
    return y @ p["out"], (c, n, h, m)
