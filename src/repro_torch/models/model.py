"""Model (twin of ``repro.models.model``), dense family only: init, forward
(with per-layer remat), the training loss, prefill and decode over a
per-request cache, prefill over length buckets, chunked extend and decode
over the paged pool.

Parameters are nested dicts of tensors with layer-stacked ``[L, ...]``
leaves, the reference's layout, so ``weights.from_jax_params`` carries a JAX
parameter tree over unchanged. Layers run as a Python loop over the stack.
The pool ops write the KV pages in place; the reference donated those
buffers to its jitted steps instead (``repro/serving/engine.py:342-356``).
``decode_step`` likewise writes the new token's K/V into the cache tensors
it is given, where the reference returns updated copies.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.page_pool import (pool_gather, pool_scatter_span,
                                           pool_scatter_token)
from repro_torch.models import attention as A
from repro_torch.models import layers as L

Params = Dict


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch serves the dense family only; {cfg.name} is "
            f"{cfg.family!r} (ROADMAP Queue 1 item 13)")


def init_params(cfg: ArchConfig, seed: int = 0, *, tp: int = 16,
                device="cuda") -> Params:
    """Seeded init with the reference's distributions, scales, dtypes and
    dead-head zeroing (the draws themselves differ from ``jax.random``)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = L.dtype_of(cfg)
    n, d, ff, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=dev)
    lead = (n,)
    return {
        "embed": {"w": L.dense_init(gen, V, d, dt, scale=0.02)},
        "final_norm": {"w": ones(d)},
        "lm_head": {"w": L.dense_init(gen, d, V, dt)},
        "layers": {
            "attn": A.attn_init(gen, cfg, tp, n),
            "attn_norm": {"w": ones(n, d)},
            "mlp_norm": {"w": ones(n, d)},
            "mlp": {
                "w1": L.dense_init(gen, d, ff, dt, lead=lead),
                "w3": L.dense_init(gen, d, ff, dt, lead=lead),
                "w2": L.dense_init(gen, ff, d, dt, lead=lead,
                                   scale=1.0 / np.sqrt(2 * n * ff)),
            },
        },
    }


def layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def _rope_tables(cfg: ArchConfig, positions):
    if cfg.rope_style == "none":
        return None, None
    if cfg.rope_style != "rope":
        raise NotImplementedError(f"rope_style {cfg.rope_style!r}")
    return L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)


def _attn_out(lp: Params, out, cfg: ArchConfig, tp: int):
    """Dead-head mask, then the o-projection. out [B,S,Hp,hd] -> [B,S,d]."""
    hm = A.head_mask(cfg, tp, device=out.device).to(out.dtype)
    out = out * hm[None, None, :, None]
    B, Sq, HP, hd = out.shape
    return out.reshape(B, Sq, HP * hd) @ lp["wo"]


def _mlp_block(lp, x, cfg):
    return x + L.mlp(lp["mlp"], L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps))


def _unstack(tree, n: int):
    """A layer-stacked tree -> n per-layer trees of views (``torch.unbind``:
    under autograd the layers' gradients meet in one stack, not in n
    full-size scatters into the stacked leaf)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return torch.unbind(tree, 0)


def _layer_full(lp, x, cos, sin, cfg: ArchConfig, tp: int):
    """One full-sequence transformer layer -> (x, k, v, q)."""
    h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    q, k, v = A.project_qkv(lp["attn"], h, cos, sin, cfg, tp)
    attn = A.attention_full(q, k, v, cfg, tp=tp)
    x = _mlp_block(lp, x + _attn_out(lp["attn"], attn, cfg, tp), cfg)
    return x, k, v, q


def forward(params: Params, cfg: ArchConfig, tokens, *, positions=None,
            collect_cache: bool = False, collect_q: bool = False,
            remat: bool = False, tp: int = 16):
    """tokens [B, S] -> (hidden [B,S,d], caches-or-None); caches hold the
    stacked k/v [L, B, S, KV, hd], and with ``collect_q`` the per-layer
    queries ``caches["q"]`` [L, B, S, Hp, hd] (prefill only: the hetero
    offload executor seeds its lookahead query with them). ``remat`` runs
    each layer under ``torch.utils.checkpoint`` (the twin of the
    reference's ``jax.checkpoint``): its activations are recomputed in the
    backward."""
    _require_dense(cfg)
    B, Sq = tokens.shape
    x = L.embed(params["embed"], tokens)
    if positions is None:
        positions = torch.arange(Sq, device=x.device)[None].expand(B, Sq)
    cos, sin = _rope_tables(cfg, positions)
    ks, vs, qs = [], [], []
    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x, k, v, q = checkpoint(_layer_full, lp, x, cos, sin, cfg, tp,
                                    use_reentrant=False)
        else:
            x, k, v, q = _layer_full(lp, x, cos, sin, cfg, tp)
        if collect_cache:
            ks.append(k)
            vs.append(v)
            if collect_q:
                qs.append(q)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    caches = None
    if collect_cache:
        caches = {"k": torch.stack(ks), "v": torch.stack(vs), "length": Sq}
        if collect_q:
            caches["q"] = torch.stack(qs)
    return x, caches


def train_loss(params: Params, cfg: ArchConfig, batch: Dict, *,
               remat: bool = True, tp: int = 16) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"} [B,
    S]); the reference's MoE aux term is 0 for the dense family."""
    x, _ = forward(params, cfg, batch["tokens"], remat=remat, tp=tp)
    logits = L.lm_head(params["lm_head"], x, cfg)
    return L.cross_entropy(logits, batch["labels"])


def last_logits(params, cfg: ArchConfig, x):
    return L.lm_head(params["lm_head"], x[:, -1:], cfg)[:, 0]


def make_cache(cfg: ArchConfig, batch: int, max_len: int, tp: int = 16,
               dtype=None, device="cuda") -> Dict:
    """Per-request KV cache: k/v [L, B, max_len, KV, hd] zeros and the
    shared ``length`` (a host int)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    dt = dtype or L.dtype_of(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev), "length": 0}


def prefill(params, cfg: ArchConfig, tokens, *, max_len=None, tp: int = 16):
    """Full prompt pass -> (last logits [B, V], caches), the caches zero-
    padded to ``max_len`` (>= S) so decode can continue in place."""
    Sq = tokens.shape[1]
    max_len = max_len or Sq
    x, caches = forward(params, cfg, tokens, collect_cache=True, tp=tp)
    if max_len > Sq:
        pad = (0, 0, 0, 0, 0, max_len - Sq)      # the sequence axis, dim 2
        caches["k"] = torch.nn.functional.pad(caches["k"], pad)
        caches["v"] = torch.nn.functional.pad(caches["v"], pad)
    return last_logits(params, cfg, x), caches


def _stack_layers(trees):
    """Per-layer parameter trees -> one layer-stacked tree."""
    if isinstance(trees[0], dict):
        return {k: _stack_layers([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def decode_step(params, cfg: ArchConfig, token, caches, *, tp: int = 16,
                sparse_fn=None, sparse_params=None, sparse_stateful=False):
    """token [B] + caches -> (logits [B, V], caches), every row at the
    shared ``caches["length"]``.

    ``sparse_fn(q, kc, vc, length, sp_layer, k_new=)`` replaces dense
    decode attention; ``sparse_params`` is layer-stacked. With
    ``sparse_stateful=True`` the sparse_fn returns (attn, new sp_layer) and
    this returns (logits, caches, new sparse_params). The new K/V are
    written into ``caches["k"]`` / ``["v"]`` in place.
    """
    _require_dense(cfg)
    B = token.shape[0]
    length = int(caches["length"])
    if length >= caches["k"].shape[2]:
        raise ValueError(f"cache full: length {length} of "
                         f"{caches['k'].shape[2]}")
    x = L.embed(params["embed"], token[:, None])
    positions = torch.full((B, 1), length, dtype=torch.long, device=x.device)
    cos, sin = _rope_tables(cfg, positions)
    sp_new = []
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        kc, vc = caches["k"][i], caches["v"][i]
        sp = None if sparse_params is None else layer(sparse_params, i)
        h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q, k, v = A.project_qkv(lp["attn"], h, cos, sin, cfg, tp)
        kc[:, length] = k[:, 0].to(kc.dtype)
        vc[:, length] = v[:, 0].to(vc.dtype)
        if sparse_fn is not None:
            res = sparse_fn(q, kc, vc, length + 1, sp, k_new=k)
            attn, sp = res if isinstance(res, tuple) else (res, sp)
        else:
            attn = A.attention_decode(q, kc, vc, length + 1, cfg, tp=tp)
        sp_new.append(sp)
        x = _mlp_block(lp, x + _attn_out(lp["attn"], attn, cfg, tp), cfg)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    caches = dict(caches, length=length + 1)
    logits = last_logits(params, cfg, x)
    if sparse_stateful:
        return logits, caches, _stack_layers(sp_new)
    return logits, caches


def make_page_pool(cfg: ArchConfig, n_slots: int, max_len: int, *,
                   page_size: int, total_pages: int, tp: int = 16,
                   dtype=None, device="cuda") -> Dict:
    """Paged KV pool. Physical page 0 is the reserved zero/trash page: every
    unallocated table entry points at it, dead-slot writes land on it zeroed,
    and it must stay zero so pooled decode equals per-request decode."""
    dev = resolve_device(device)
    dt = dtype or L.dtype_of(cfg)
    kv, hd = cfg.n_kv_heads, cfg.hd
    if max_len % page_size:
        raise ValueError(f"max_len {max_len} % page_size {page_size} != 0")
    shape = (cfg.n_layers, total_pages, page_size, kv, hd)
    return {
        "k_pages": torch.zeros(shape, dtype=dt, device=dev),
        "v_pages": torch.zeros(shape, dtype=dt, device=dev),
        "page_table": torch.zeros((n_slots, max_len // page_size),
                                  dtype=torch.int32, device=dev),
        "lengths": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
    }


def decode_step_paged(params, cfg: ArchConfig, token, pool, live, *,
                      tp: int = 16, sparse_fn=None, sparse_params=None,
                      collect_qk: bool = False):
    """One decode step over the paged pool with PER-SLOT lengths.

    token [B]; pool from ``make_page_pool`` (``lengths`` pre-masked to 0 for
    dead slots; ``page_table`` may be a view narrower than max_len); live [B]
    bool. ``sparse_fn(q, kc, vc, length, sp_layer, k_new=)`` replaces dense
    attention; the engine passes it only when the sparse window holds (the
    reference's fallback cond, decided on the host). Writes the new K/V into
    the pool in place; returns (logits [B, V], pool with lengths advanced),
    and with ``collect_qk`` this step's per-layer queries [L, B, Hp, hd] and
    keys [L, B, KV, hd] (the hetero offload's index inputs).
    """
    _require_dense(cfg)
    lengths = pool["lengths"]
    table = pool["page_table"]
    live = live.bool()
    x = L.embed(params["embed"], token[:, None])
    cos, sin = _rope_tables(cfg, lengths[:, None])
    qs, ks = [], []
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        kp, vp = pool["k_pages"][i], pool["v_pages"][i]
        h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q, k, v = A.project_qkv(lp["attn"], h, cos, sin, cfg, tp)
        pool_scatter_token(kp, table, lengths, k[:, 0], live)
        pool_scatter_token(vp, table, lengths, v[:, 0], live)
        kc, vc = pool_gather(kp, table), pool_gather(vp, table)
        if sparse_fn is not None:
            attn = sparse_fn(q, kc, vc, lengths + 1, layer(sparse_params, i),
                             k_new=k)
        else:
            attn = A.attention_decode(q, kc, vc, lengths + 1, cfg, tp=tp)
        x = _mlp_block(lp, x + _attn_out(lp["attn"], attn, cfg, tp), cfg)
        if collect_qk:
            qs.append(q[:, 0])
            ks.append(k[:, 0])
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    pool = dict(pool, lengths=lengths + live.to(lengths.dtype))
    if not collect_qk:
        return last_logits(params, cfg, x), pool
    return last_logits(params, cfg, x), pool, torch.stack(qs), torch.stack(ks)


def decode_step_paged_presel(params, cfg: ArchConfig, token, pool, live,
                             pidx, *, sparse: bool, page_size: int,
                             tp: int = 16):
    """Apply-phase decode over the paged pool with PRE-SELECTED pages (the
    hetero offload split, paper §5): prepare / relevancy / retrieve ran on
    the offload side one step ahead and handed back page indices only.
    ``pidx [L, B, n_sel]`` holds per-layer selected page ids in logical
    (per-slot) space, -1 = no selection.

    Semantics, as the reference's:
      * the page being written (``lengths // page_size``) is always
        included, so the newest tokens are never invisible to a stale
        selection; a stale pick of the same page is dropped (no double
        softmax mass);
      * indices outside the live region are dropped;
      * ``sparse=False`` (the dynamic fallback) runs dense attention and
        ignores the selection.

    The reference takes that branch with a traced ``lax.cond`` on the
    lengths; here the caller decides it on the host (``use_sparse``), as
    ``decode_step_paged``'s caller does.

    Returns (logits [B, V], pool with lengths advanced, q_layers [L, B, Hp,
    hd], k_layers [L, B, KV, hd]): this step's per-layer query and key feed
    the next lookahead selection and the offload-side index.
    """
    from repro_torch.core.methods.dsa import (repad_dead_heads,
                                              strip_dead_heads)
    from repro_torch.kernels import ops

    ps = page_size

    def presel_attention(q, kc, vc, lb, sp, k_new=None):
        sel = sp["pidx"]
        cur_page = ((lb - 1) // ps).to(torch.int32)
        neg = torch.full_like(sel, -1)
        s = torch.where(sel == cur_page[:, None], neg, sel)
        s = torch.where(s.long() * ps < lb.long()[:, None], s, neg)
        s_full = torch.cat([s, cur_page[:, None]], dim=1)
        out, _ = ops.paged_decode_attention(
            strip_dead_heads(q, cfg), kc, vc, s_full.to(torch.int32), lb,
            page_size=ps)
        return repad_dead_heads(out, q, cfg)

    return decode_step_paged(
        params, cfg, token, pool, live, tp=tp,
        sparse_fn=presel_attention if sparse else None,
        sparse_params={"pidx": pidx}, collect_qk=True)


def extend_paged(params, cfg: ArchConfig, tokens, pool, n_valid, *,
                 tp: int = 16, collect_kq: bool = False, x_embeds=None,
                 emb_rows=None):
    """Chunked prefill: append a span of C tokens per slot to the paged pool.

    tokens [B, C] (rows padded past ``n_valid[b]``); n_valid [B] (0 = slot not
    prefilling this step). Queries attend causally to the existing prefix
    plus the chunk. Returns (logits [B, V] at each row's last valid token,
    pool with lengths advanced); the pages are written in place.

    With ``collect_kq`` two more outputs follow: k_span [L, B, C, KV, hd]
    (the span's new keys, unmasked past ``n_valid``; consumers mask) and
    q_last [L, B, Hp, hd] (the query at each row's last valid token), which
    keep the hetero offload executor's index coherent with the pool.

    ``x_embeds [B, C, d]`` + ``emb_rows [B]`` feed rows with pre-embedded
    context instead of token ids (cast to the model dtype): the MaC
    retrieval service splices retrieved memory embeddings into a slot's
    context through the same chunked path its documents would take.
    """
    _require_dense(cfg)
    B, C = tokens.shape
    ks, qs = [], []
    lengths = pool["lengths"]
    table = pool["page_table"]
    x = L.embed(params["embed"], tokens)
    if x_embeds is not None:
        x = torch.where(emb_rows[:, None, None], x_embeds.to(x.dtype), x)
    positions = lengths.long()[:, None] + torch.arange(C, device=x.device)
    cos, sin = _rope_tables(cfg, positions)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        kp, vp = pool["k_pages"][i], pool["v_pages"][i]
        h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
        q, k, v = A.project_qkv(lp["attn"], h, cos, sin, cfg, tp)
        pool_scatter_span(kp, table, lengths, k, n_valid)
        pool_scatter_span(vp, table, lengths, v, n_valid)
        kc, vc = pool_gather(kp, table), pool_gather(vp, table)
        attn = A.attention_decode_chunk(q, kc, vc, lengths, cfg, tp=tp)
        x = _mlp_block(lp, x + _attn_out(lp["attn"], attn, cfg, tp), cfg)
        if collect_kq:
            ks.append(k)
            qs.append(q)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    last = (n_valid.long() - 1).clamp(0, C - 1)
    rows = torch.arange(B, device=x.device)
    xg = x[rows, last][:, None]                                  # [B, 1, d]
    logits = L.lm_head(params["lm_head"], xg, cfg)[:, 0]
    pool = dict(pool, lengths=lengths + n_valid.to(lengths.dtype))
    if not collect_kq:
        return logits, pool
    return logits, pool, torch.stack(ks), torch.stack(qs)[:, rows, last]


def prefill_bucketed(params, cfg: ArchConfig, tokens, true_lens, *,
                     tp: int = 16, collect_q: bool = False):
    """Batched admission prefill over a length bucket.

    tokens [B, Sb] right-padded prompts; true_lens [B]. Returns (logits [B, V]
    at each row's last REAL token, k, v) with k/v [L, B, Sb, KV, hd] zeroed
    past ``true_lens``, so splicing them into the pool leaves the dead region
    exactly zero. With ``collect_q`` a fourth output q_last [L, B, Hp, hd]
    holds each row's queries at its last real token: the hetero offload
    executor's first lookahead selects with it.
    """
    B, Sb = tokens.shape
    x, caches = forward(params, cfg, tokens, collect_cache=True,
                        collect_q=collect_q, tp=tp)
    last = (true_lens.long() - 1).clamp(0, Sb - 1)
    rows = torch.arange(B, device=x.device)
    xg = x[rows, last][:, None]
    logits = L.lm_head(params["lm_head"], xg, cfg)[:, 0]
    mask = torch.arange(Sb, device=x.device)[None, :] < true_lens[:, None]
    m = mask[None, :, :, None, None]
    k = caches["k"] * m.to(caches["k"].dtype)
    v = caches["v"] * m.to(caches["v"].dtype)
    if not collect_q:
        return logits, k, v
    return logits, k, v, caches["q"][:, rows, last]
