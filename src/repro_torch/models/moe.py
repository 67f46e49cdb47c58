"""Top-k MoE with GShard / Switch-style capacity dispatch (twin of
``repro.models.moe``).

The semantics are the reference's, step for step. Tokens are flattened in
b-major order and cut into groups of ``group_size`` (the last group padded
with zero rows, which take router capacity like any token). Per group:
router softmax in fp32, top-k (ties to the lower expert index), weights
renormalised, each token's place in an expert's buffer is ``cumsum(assign)
- assign`` in token order, tokens past ``cap`` are dropped, and the aux loss
is the Switch load-balance loss, averaged over groups.

The reference dispatches with a dense ``[t, E, C]`` one-hot einsum (the TPU
idiom; its GSPMD expert-sharding hook ``EP_CONSTRAINT`` is the ``local``
route below). Here the dispatch is by index: each kept (token,
expert) pair writes its row into ``[E, C, d]`` at ``expert * C + place``,
the experts run as ``torch.bmm``, and each token gathers its k outputs back.
The same function, without the one-hot (2048 x 32 x 640 x 4 B = 168 MB a
group at granite's prefill). Every shape is fixed by (t, E, k, C): no host
sync, no boolean indexing, so a decode step with MoE can be captured in a
CUDA graph.

A model shard of the tensor-parallel split (``shard=(m, n)``) runs the
router, the dispatch, the capacity and the aux like every shard, then
either its E/n experts (expert-parallel, when n divides E) or its 1/n of
every expert's d_ff; its combine is a row-parallel partial in fp32, which
the model group sums. An expert-parallel shard writes all t x k (token,
expert) rows into its buffer (another shard's pairs into a trash row) and
reads t x k rows back; with ``local`` (the reference's
``set_ep_constraint``: each shard builds only its experts' slices of the
dispatch) it moves only its own El x C slots instead (``_Dispatch``,
``_Combine``, each the other's adjoint). The d_ff split is the same
either way. A decode step whose rows are cut over the data axes gathers
the router's inputs over the data indices first (``moe_apply_gathered``),
so the dispatch group is the whole batch's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ref import topk_stable
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def moe_init(gen: torch.Generator, cfg: ArchConfig, lead=()) -> Params:
    """Router [d, E] fp32 (scale 0.02) and expert stacks w1/w3 [E, d, ff],
    w2 [E, ff, d] in the model dtype, with ``lead`` stacked axes first; the
    reference's scales (the draws differ from ``jax.random``)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = L.dtype_of(cfg)
    lead = tuple(lead)
    return {
        "router": L.dense_init(gen, d, E, torch.float32, scale=0.02,
                               lead=lead),
        "w1": L.dense_init(gen, d, ff, dt, lead=lead + (E,)),
        "w3": L.dense_init(gen, d, ff, dt, lead=lead + (E,)),
        "w2": L.dense_init(gen, ff, d, dt, lead=lead + (E,),
                           scale=1.0 / np.sqrt(2 * cfg.n_layers * ff)),
    }


def capacity(t: int, cfg: ArchConfig) -> int:
    """Slots per expert for a group of t tokens: ceil(t k / E x factor),
    rounded up to a multiple of 4, at least 4."""
    c = int(np.ceil(t * cfg.experts_per_token / cfg.n_experts
                    * cfg.capacity_factor))
    return max(4 * ((c + 3) // 4), 4)


def expert_parallel(cfg: ArchConfig, n: int) -> bool:
    """A model split n ways runs whole experts (E / n each) when n divides
    E, as ``param_specs`` cuts the expert stacks; else a slice of every
    expert's d_ff."""
    return cfg.n_experts % n == 0


def _slot_tokens(row, vals, n_slots: int, fill):
    """Each of ``n_slots`` buffer slots' value of ``vals`` (one a (token,
    expert) pair) scattered by ``row`` (the pair's slot, or the trash slot
    ``n_slots``, which any number of pairs may hit and nothing reads);
    ``fill`` where no pair lands."""
    out = torch.full((n_slots + 1,), fill, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_(0, row.reshape(-1), vals.reshape(-1))[:n_slots]


def _gather_slots(x, tok):
    """Slot (e, c) of ``tok`` [El, C] gets row ``tok[e, c]`` of x [t, d], or
    zeros where no token is kept there (``tok`` = t)."""
    t = x.shape[0]
    out = x.index_select(0, tok.clamp_max(t - 1).reshape(-1))
    return out.view(tok.shape + (x.shape[1],)).masked_fill_(
        (tok == t)[..., None], 0)


def _add_slots(ys, tok, t: int):
    """The adjoint of ``_gather_slots``: ys [El, C, d] added in fp32 onto
    rows ``tok`` of a [t, d] sum, one expert after another. Within one
    expert a token has at most one slot, so each add has distinct rows (the
    empty slots' aside, which land on row t and are dropped): every
    element is one fixed-order sum, whatever order a call's adds land in,
    and two runs are bit-equal."""
    out = ys.new_zeros((t + 1, ys.shape[-1]), dtype=torch.float32)
    for e in range(ys.shape[0]):
        out.index_add_(0, tok[e], ys[e].float())
    return out[:t]


class _Dispatch(torch.autograd.Function):
    """The shard's expert inputs [El, C, d] gathered from x [t, d] by its
    slots' token ids; backward: their gradients added onto the tokens'
    rows (``_add_slots``), in the inputs' dtype."""

    @staticmethod
    def forward(ctx, x, tok):
        ctx.save_for_backward(tok)
        ctx.t = x.shape[0]
        return _gather_slots(x, tok)

    @staticmethod
    def backward(ctx, g):
        tok, = ctx.saved_tensors
        return _add_slots(g, tok, ctx.t).to(g.dtype), None


class _Combine(torch.autograd.Function):
    """The shard's fp32 partial [t, d]: its weighted expert outputs [El, C,
    d] added onto their tokens' rows (``_add_slots``); backward: each
    slot gathers its token's gradient (``_gather_slots``)."""

    @staticmethod
    def forward(ctx, ys, tok, t):
        ctx.save_for_backward(tok)
        return _add_slots(ys, tok, t)

    @staticmethod
    def backward(ctx, g):
        tok, = ctx.saved_tensors
        return _gather_slots(g, tok), None, None


def _moe_group(p: Params, x: torch.Tensor, cfg: ArchConfig, cap: int,
               shard=None, local: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [t, d] -> (y [t, d], aux scalar fp32). One dispatch group; a model
    shard's (``shard=(m, n)``) y is its fp32 partial, with ``local`` on
    the expert-parallel route dispatched and combined over its own slots
    alone."""
    t, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ p["router"], dim=-1)        # [t, E]
    wgt, widx = topk_stable(probs, k)                             # [t, k]
    widx = widx.long()
    wgt = wgt / wgt.sum(-1, keepdim=True).clamp_min(1e-9)
    # assignment [t, E] (the k experts are distinct) and each token's place
    # in its experts' buffers, in token order
    assign = torch.zeros_like(probs).scatter_(1, widx, 1.0)
    pos = torch.cumsum(assign, dim=0) - assign
    pos_k = pos.gather(1, widx)                                   # [t, k]
    keep = pos_k < cap
    # the experts this shard runs: [e0, e0 + El)
    e0, El = 0, E
    if shard is not None and expert_parallel(cfg, shard[1]):
        El = E // shard[1]
        e0 = shard[0] * El
    mine = keep & (widx >= e0) & (widx < e0 + El)
    # buffer row of each (token, expert) pair; dropped pairs (and another
    # shard's experts) write the trash row El * cap, which no expert reads
    row = torch.where(mine, (widx - e0) * cap + pos_k.long(),
                      torch.full_like(widx, El * cap))
    # the combine weights in the model dtype, as the reference rounds them
    comb = (wgt * keep).to(x.dtype).float()
    # Switch load-balance aux: E * sum_e f_e * mean_prob_e
    aux = E * (assign.mean(0) * probs.mean(0)).sum()
    if local and El < E:
        # each slot's token id and combine weight, scattered by the pairs
        # (ids, not rows); then the shard's El x C rows alone move
        ids = torch.arange(t, device=x.device)[:, None].expand(t, k)
        tok = _slot_tokens(row, ids, El * cap, t).view(El, cap)
        w = _slot_tokens(row, comb, El * cap, 0.0).view(El, cap)
        xe = _Dispatch.apply(x, tok)
        h = F.silu(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
        ye = w[..., None] * torch.bmm(h, p["w2"]).float()
        return _Combine.apply(ye, tok, t), aux
    buf = x.new_zeros((El * cap + 1, d))
    buf[row.reshape(-1)] = x.repeat_interleave(k, dim=0)
    xe = buf[:El * cap].view(El, cap, d)
    h = F.silu(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
    ye = torch.bmm(h, p["w2"]).reshape(El * cap, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])                    # + trash
    # a token's k expert outputs summed in fp32, cast once (a shard's
    # partial stays fp32 until the group's sum)
    y = (comb[..., None] * ye[row].float()).sum(1)
    if shard is None:
        y = y.to(x.dtype)
    return y, aux


GROUP_SIZE = 2048   # tokens of a dispatch group (the last one padded)


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
              group_size: int = GROUP_SIZE, shard=None, local: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux fp32 scalar, the mean over the
    groups of the flattened tokens); a model shard's (``shard=(m, n)``) y
    is its fp32 partial (``local``: the expert-parallel shard's own slots
    alone, ``_moe_group``)."""
    B, S, d = x.shape
    tokens = B * S
    g = min(group_size, tokens)
    n_groups = (tokens + g - 1) // g
    flat = x.reshape(tokens, d)
    pad = n_groups * g - tokens
    if pad:
        flat = F.pad(flat, (0, 0, 0, pad))
    cap = capacity(g, cfg)
    ys = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_groups):
        y, a = _moe_group(p, flat[i * g:(i + 1) * g], cfg, cap, shard,
                          local)
        ys.append(y)
        aux = aux + a
    y = torch.cat(ys)[:tokens].reshape(B, S, d)
    return y, aux / n_groups


def moe_apply_gathered(p: Params, parts, d: int, device, cfg: ArchConfig,
                       shard=None) -> torch.Tensor:
    """``moe_apply`` of data index ``d``'s rows with the dispatch group
    taken over the whole batch: ``parts``, every data index's router inputs
    [B_d, S, d_model] in data-index order, all-gathered onto ``device``,
    so capacity and drops are decided as on one device (a decode step's
    one token a row would otherwise cut the reference's dispatch group).
    -> data index ``d``'s rows of y (a model shard's fp32 partial)."""
    from repro_torch.distributed import collectives as col

    x = col.group_all_gather(list(parts), 0, [device])[0]
    y, _ = moe_apply(p, x, cfg, shard=shard)
    n = parts[d].shape[0]
    return y[d * n:(d + 1) * n]

