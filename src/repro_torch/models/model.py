"""Model (twin of ``repro.models.model``) for all ten architectures: init,
forward (with per-layer remat), the training loss, prefill and decode over a
per-request cache; and, for the transformer families, prefill over length
buckets, chunked extend and decode over the paged pool.

Families:
  dense | moe | audio | vlm : transformer (GQA attention + SwiGLU or MoE
                              FFN; vlm with M-RoPE)
  hybrid (zamba2)           : n_super x (``shared_attn_every`` Mamba2 layers
                              + one weight-shared attention/MLP block), then
                              the tail's Mamba2 layers
  ssm (xlstm)               : (mLSTM, sLSTM) pairs

Parameters are nested dicts of tensors with layer-stacked ``[L, ...]``
leaves, the reference's layout (the hybrid's body double-stacked ``[n_super,
per, ...]``), so ``weights.from_jax_params`` carries a JAX parameter tree
over unchanged. Layers run as a Python loop over the stack. The pool ops
write the KV pages in place; the reference donated those buffers to its
jitted steps instead (``repro/serving/engine.py:342-356``). ``decode_step``
likewise writes the new token's K/V into the cache tensors it is given,
where the reference returns updated copies; recurrent states come back as
new tensors, as in the reference.

M-RoPE without ``positions3`` uses the 1-D positions on all three streams
(a text token's rule in Qwen2-VL). The reference does so in its decode and
extend steps and asserts in ``forward``; the port applies the rule in
``forward`` too, so the bucketed prefill serves the vlm family.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import topk
from repro_torch.launch import op_walk
from repro_torch.kernels.page_pool import (pool_gather, pool_scatter_span,
                                           pool_scatter_token)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X

Params = Dict

MOE_AUX_COEF = 0.01


def _hybrid_shape(cfg: ArchConfig):
    """(n_super, per, tail) of the hybrid: n_super applications of the
    shared block, each after ``per`` Mamba2 layers, then ``tail`` more."""
    per = cfg.shared_attn_every
    n_super = cfg.n_layers // per
    return n_super, per, cfg.n_layers - n_super * per


def _tf_layers_init(gen, cfg: ArchConfig, tp: int, n: int) -> Params:
    """n stacked transformer layers: attention, norms, SwiGLU or MoE."""
    d, ff = cfg.d_model, cfg.d_ff
    dt = L.dtype_of(cfg)
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32,
                                     device=gen.device)
    lead = (n,)
    p = {"attn": A.attn_init(gen, cfg, tp, n), "attn_norm": {"w": ones(n, d)},
         "mlp_norm": {"w": ones(n, d)}}
    if cfg.n_experts:
        p["moe"] = MOE.moe_init(gen, cfg, lead)
    else:
        p["mlp"] = {
            "w1": L.dense_init(gen, d, ff, dt, lead=lead),
            "w3": L.dense_init(gen, d, ff, dt, lead=lead),
            "w2": L.dense_init(gen, ff, d, dt, lead=lead,
                               scale=1.0 / np.sqrt(2 * cfg.n_layers * ff)),
        }
    return p


def _mamba_layers_init(gen, cfg: ArchConfig, lead) -> Params:
    return {"norm": {"w": torch.ones(tuple(lead) + (cfg.d_model,),
                                     dtype=torch.float32, device=gen.device)},
            "mamba": S.mamba_init(gen, cfg, lead)}


def init_params(cfg: ArchConfig, seed: int = 0, *, tp: int = 16,
                device="cuda") -> Params:
    """Seeded init with the reference's layout, distributions, scales,
    dtypes and dead-head zeroing (the draws themselves differ from
    ``jax.random``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = L.dtype_of(cfg)
    d, V = cfg.d_model, cfg.padded_vocab
    params = {
        "embed": {"w": L.dense_init(gen, V, d, dt, scale=0.02)},
        "final_norm": {"w": torch.ones((d,), dtype=torch.float32,
                                       device=dev)},
        "lm_head": {"w": L.dense_init(gen, d, V, dt)},
    }
    if cfg.family == "hybrid":
        n_super, per, tail = _hybrid_shape(cfg)
        params["body"] = _mamba_layers_init(gen, cfg, (n_super, per))
        params["tail"] = _mamba_layers_init(gen, cfg, (tail,))
        params["shared"] = layer(_tf_layers_init(gen, cfg, tp, 1), 0)
    elif cfg.xlstm_pattern:
        nb = cfg.n_layers // len(cfg.xlstm_pattern)
        pre = lambda: {"w": torch.ones((nb, d), dtype=torch.float32,
                                       device=dev)}
        params["mlstm"] = {"pre": pre(),
                           "blk": X.mlstm_init(gen, cfg, (nb,))}
        params["slstm"] = {"pre": pre(),
                           "blk": X.slstm_init(gen, cfg, (nb,))}
    else:
        params["layers"] = _tf_layers_init(gen, cfg, tp, cfg.n_layers)
    return params


def layer(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter tree (views, no copies). A
    list holds per-shard stacks (the cached DSA index's ``kidx_sum``):
    layer ``i`` of each."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [layer(v, i) for v in tree]
    return tree[i]


def _rope_tables(cfg: ArchConfig, positions, positions3=None):
    if cfg.rope_style == "none":
        return None, None
    if cfg.rope_style == "mrope":
        if positions3 is None:       # text tokens: one position, 3 streams
            positions3 = positions[None].expand((3,) + positions.shape)
        return L.mrope_cos_sin(positions3, cfg.hd, cfg.rope_theta,
                               cfg.mrope_sections)
    if cfg.rope_style != "rope":
        raise ValueError(f"rope_style {cfg.rope_style!r}")
    return L.rope_cos_sin(positions, cfg.hd, cfg.rope_theta)


def _attn_out(lp: Params, out, cfg: ArchConfig, tp: int, shard=None):
    """Dead-head mask, then the o-projection. out [B,S,Hp,hd] -> [B,S,d]
    (a model shard's: its heads, a row-parallel partial)."""
    hm = A.head_mask(cfg, tp, device=out.device, shard=shard).to(out.dtype)
    out = out * hm[None, None, :, None]
    B, Sq, HP, hd = out.shape
    return out.reshape(B, Sq, HP * hd) @ lp["wo"]


def _ffn_part(lp, x, cfg: ArchConfig):
    """The FFN half of a transformer layer on the residual x -> (its output
    before the residual add, MoE aux or None)."""
    return _ffn_mix(lp, L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps), cfg)


def _ffn_mix(lp, h, cfg: ArchConfig, shard=None, ep_local: bool = False):
    """``_ffn_part`` after its norm, on the normed h; a model shard's
    (``shard=(m, n)``) is a row-parallel partial (``ep_local``: an
    expert-parallel shard's own dispatch, ``moe.moe_apply``'s ``local``)."""
    if cfg.n_experts:
        return MOE.moe_apply(lp["moe"], h, cfg, shard=shard, local=ep_local)
    return L.mlp(lp["mlp"], h), None


def _attn_part(lp, x, cos, sin, cfg: ArchConfig, tp: int):
    """The attention half of a transformer layer on the residual x -> (its
    output before the residual add, k, v, q)."""
    return _attn_mix(lp, L.rms_norm(lp["attn_norm"], x, cfg.norm_eps), cos,
                     sin, cfg, tp)


def _attn_mix(lp, h, cos, sin, cfg: ArchConfig, tp: int, shard=None,
              all_kv: bool = False):
    """``_attn_part`` after its norm, on the normed h. A model shard's
    (``shard=(m, n)``) attends over its heads and gives a row-parallel
    partial; a shard whose kv heads do not shard projects those its q heads
    read, or, with ``all_kv``, all of them."""
    ap, lo = lp["attn"], 0
    if shard is not None:
        ap = A.shard_kv_params(ap, cfg, tp, shard, all_kv)
        lo = A.shard_kv_heads(cfg, tp, shard, all_kv)[0]
    q, k, v = A.project_qkv(ap, h, cos, sin, cfg, tp)
    attn = A.attention_full(q, k, v, cfg, tp=tp, shard=shard, kv_lo=lo)
    return _attn_out(lp["attn"], attn, cfg, tp, shard=shard), k, v, q


def _mlp_block(lp, x, cfg):
    return x + _ffn_part(lp, x, cfg)[0]


def _unstack(tree, n: int):
    """A layer-stacked tree -> n per-layer trees of views (``torch.unbind``:
    under autograd the layers' gradients meet in one stack, not in n
    full-size scatters into the stacked leaf); an FSDP leaf's
    ``DataSlices`` -> one per layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    if isinstance(tree, sh.DataSlices):
        return tree.layers(n)
    return torch.unbind(tree, 0)


def _layer_full(lp, x, cos, sin, cfg: ArchConfig, tp: int):
    """One full-sequence transformer layer -> (x, aux or None, k, v, q)."""
    y, k, v, q = _attn_part(lp, x, cos, sin, cfg, tp)
    x = x + y
    y, aux = _ffn_part(lp, x, cfg)
    return x + y, aux, k, v, q


def run_layers(layers: Params, cfg: ArchConfig, x, *, tp: int = 16):
    """x [B, S, d] through a stack of transformer layers (the leading dim of
    ``layers``' leaves) at positions 0..S-1, without the final norm: the
    stage function of a pipeline over slices of ``params["layers"]``
    (``distributed.pipeline_parallel.gpipe_forward``)."""
    B, Sq = x.shape[:2]
    positions = torch.arange(Sq, device=x.device)[None].expand(B, Sq)
    cos, sin = _rope_tables(cfg, positions)
    n = layers["attn_norm"]["w"].shape[0]
    for lp in _unstack(layers, n):
        x = _layer_full(lp, x, cos, sin, cfg, tp)[0]
    return x


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (the twin of
    ``jax.checkpoint``): its activations are recomputed in the backward.
    The layers draw no random numbers, so no RNG state is saved and
    restored around the recompute. Under ``op_walk.placeholders()`` the
    recompute places its tensors on their cards as the forward did
    (``op_walk.placing``)."""
    def run(*a):
        with op_walk.placing():
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _add_aux(aux, aux_l):
    return aux if aux_l is None else aux + aux_l


def forward(params: Params, cfg: ArchConfig, tokens, *, positions=None,
            positions3=None, img_embeds=None, collect_cache: bool = False,
            collect_q: bool = False, remat: bool = False, tp: int = 16):
    """tokens [B, S] -> (hidden [B,S,d], aux fp32 scalar, caches-or-None).

    ``img_embeds [B, n, d]`` (the vlm stub) overwrite the first n token
    embeddings. ``aux`` is the MoE load-balance loss summed over the layers
    (0 without experts). A transformer's caches hold the stacked k/v [L, B,
    S, KV, hd], and with ``collect_q`` the per-layer queries ``caches["q"]``
    [L, B, S, Hp, hd] (prefill only: the hetero offload executor seeds its
    lookahead query with them); the hybrid's and xLSTM's are
    ``make_cache``'s trees. ``remat`` runs each layer (the hybrid: each
    super block and tail layer; xLSTM: each pair) under
    ``torch.utils.checkpoint`` (the twin of the reference's
    ``jax.checkpoint``): its activations are recomputed in the backward."""
    B, Sq = tokens.shape
    x = L.embed(params["embed"], tokens)
    if img_embeds is not None:
        n = img_embeds.shape[1]
        x = torch.cat([img_embeds.to(x.dtype), x[:, n:]], dim=1)
    if positions is None:
        positions = torch.arange(Sq, device=x.device)[None].expand(B, Sq)
    cos, sin = _rope_tables(cfg, positions, positions3)
    if cfg.family == "hybrid":
        return _hybrid_forward(params, cfg, x, cos, sin, collect_cache,
                               remat, tp)
    if cfg.xlstm_pattern:
        return _xlstm_forward(params, cfg, x, collect_cache, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs, qs = [], [], []
    for lp in _unstack(params["layers"], cfg.n_layers):
        if remat:
            x, aux_l, k, v, q = _remat(_layer_full, lp, x, cos, sin, cfg,
                                       tp)
        else:
            x, aux_l, k, v, q = _layer_full(lp, x, cos, sin, cfg, tp)
        aux = _add_aux(aux, aux_l)
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
    return x, aux, caches


def _stack_mamba(states, lead, empty):
    """Per-layer (ssm, (conv x, B, C)) states, flattened in layer order ->
    the same tree stacked [*lead, ...]; with no layer (a zero-length body
    or tail) the already stacked ``empty``."""
    if not states:
        return empty
    lead = tuple(lead)
    ssm = torch.stack([s[0] for s in states])
    conv = [torch.stack([s[1][i] for s in states]) for i in range(3)]
    return (ssm.reshape(lead + ssm.shape[1:]),
            tuple(c.reshape(lead + c.shape[1:]) for c in conv))


def _mamba_layer(lp, x, cfg: ArchConfig, state=None):
    """One Mamba2 layer (pre-norm, residual): the chunked forward when
    ``state`` is None, else one decode step from it. -> (x, new state)."""
    h = L.rms_norm(lp["norm"], x, cfg.norm_eps)
    if state is None:
        y, st = S.mamba_forward(lp["mamba"], h, cfg)
    else:
        y, st = S.mamba_decode(lp["mamba"], h, cfg, state)
    return x + y, st


def _mamba_layers(lps, x, cfg: ArchConfig, n: int, states=None):
    """n stacked Mamba2 layers over x, forward or (from the stacked
    ``states``: ssm [n, ...], conv (x, B, C) [n, ...]) one decode step ->
    (x, per-layer states)."""
    out = []
    for i, lp in enumerate(_unstack(lps, n)):
        st = None if states is None else (
            states[0][i], tuple(c[i] for c in states[1]))
        x, st = _mamba_layer(lp, x, cfg, st)
        out.append(st)
    return x, out


def _hybrid_forward(params, cfg, x, cos, sin, collect_cache, remat, tp):
    n_super, per, tail = _hybrid_shape(cfg)
    B, Sq = x.shape[:2]

    def super_fn(blp, x):
        x, st = _mamba_layers(blp, x, cfg, per)
        x, aux_l, k, v, _ = _layer_full(params["shared"], x, cos, sin, cfg,
                                        tp)
        return x, aux_l, st, k, v

    def run(fn, *a):
        return _remat(fn, *a) if remat else fn(*a)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body_st, ks, vs, tail_st = [], [], [], []
    for blp in _unstack(params["body"], n_super):
        x, aux_l, st, k, v = run(super_fn, blp, x)
        aux = _add_aux(aux, aux_l)
        body_st += st
        ks.append(k)
        vs.append(v)
    for lp in _unstack(params["tail"], tail):
        x, st = run(_mamba_layer, lp, x, cfg)
        tail_st.append(st)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    caches = None
    if collect_cache:
        # an empty body's or tail's stacks: fp32 ssm, conv states in the
        # model dtype (a forward's conv states are)
        ssm0, conv0 = S.mamba_state_init(cfg, B, device=x.device)
        empty = lambda lead: (ssm0.new_zeros(lead + ssm0.shape), tuple(
            c.new_zeros(lead + c.shape, dtype=x.dtype) for c in conv0))
        bs, bc = _stack_mamba(body_st, (n_super, per), empty((0, per)))
        ts, tc = _stack_mamba(tail_st, (tail,), empty((0,)))
        kv0 = x.new_zeros((0, B, Sq, cfg.n_kv_heads, cfg.hd))
        caches = {"body_ssm": bs, "body_conv": bc, "tail_ssm": ts,
                  "tail_conv": tc, "shared_k": _stack_or(ks, kv0),
                  "shared_v": _stack_or(vs, kv0), "length": Sq}
    return x, aux, caches


def _stack_or(ts, empty):
    """``torch.stack(ts)``, or ``empty`` (a zero-length stack) when there
    is nothing to stack (a hybrid with no shared-block site)."""
    return torch.stack(ts) if ts else empty


def _xlstm_forward(params, cfg, x, collect_cache, remat, states=None):
    """(mLSTM, sLSTM) pairs over x, from ``states`` (``make_cache``'s
    ``"states"``) or each block's initial state; the final norm applied."""
    nb = cfg.n_layers // 2

    def pair_fn(mlp, slp, x, st_m, st_s):
        y, ms = X.mlstm_forward(
            mlp["blk"], L.rms_norm(mlp["pre"], x, cfg.norm_eps), cfg, st_m)
        x = x + y
        y, ss = X.slstm_forward(
            slp["blk"], L.rms_norm(slp["pre"], x, cfg.norm_eps), cfg, st_s)
        return x + y, ms, ss

    new_m, new_s = [], []
    for i, (mlp, slp) in enumerate(zip(_unstack(params["mlstm"], nb),
                                       _unstack(params["slstm"], nb))):
        st_m = st_s = None
        if states is not None:
            st_m = tuple(a[i] for a in states[0])
            st_s = tuple(a[i] for a in states[1])
        if remat:
            x, ms, ss = _remat(pair_fn, mlp, slp, x, st_m, st_s)
        else:
            x, ms, ss = pair_fn(mlp, slp, x, st_m, st_s)
        new_m.append(ms)
        new_s.append(ss)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    caches = None
    if collect_cache:
        stack = lambda sts: tuple(torch.stack(a) for a in zip(*sts))
        caches = {"states": (stack(new_m), stack(new_s)),
                  "length": x.shape[1]}
    return x, torch.zeros((), dtype=torch.float32, device=x.device), caches


def train_loss(params: Params, cfg: ArchConfig, batch: Dict, *,
               remat: bool = True, tp: int = 16) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"} [B,
    S], optional "positions3" and "img_embeds") plus ``MOE_AUX_COEF`` x the
    MoE load-balance aux (0 without experts)."""
    x, aux, _ = forward(params, cfg, batch["tokens"],
                        positions3=batch.get("positions3"),
                        img_embeds=batch.get("img_embeds"), remat=remat,
                        tp=tp)
    logits = L.lm_head(params["lm_head"], x, cfg)
    return L.cross_entropy(logits, batch["labels"]) + MOE_AUX_COEF * aux


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's model axis
# ---------------------------------------------------------------------------


def _tp_devices(group):
    return [g["final_norm"]["w"].device for g in group]


def _tp_layer(lps, xs, cos, sin, cfg: ArchConfig, tp: int,
              all_kv: bool = False, sp: bool = False,
              ep_local: bool = False):
    """One transformer layer over a model group in lockstep. ``lps``, the
    members' local layer trees (an FSDP leaf's ``DataSlices`` gathered here,
    inside the remat, so the recompute gathers again); ``xs``, each
    member's copy of the residual stream. Each member runs its shard of the
    attention half and of the FFN half (``_attn_mix``, ``_ffn_mix``);
    each half's row-parallel partials are all-reduced over the group before
    the residual add. With ``sp`` (the Megatron-SP residual, the
    reference's ``set_sp_residual``) ``xs`` are the members' sequence
    slices: each member norms its slice, the normed slices are all-gathered
    over the sequence before the projections (the reference's
    ``_sp_gather``), and each half's partials are reduce-scattered into
    the slices (the same fp32 sums in member order as the all-reduce's).
    ``ep_local``: the MoE's shard-local dispatch. -> (xs, member 0's MoE
    aux or None, ks, vs per member)."""
    n = len(xs)
    lps = [sh.materialize(lp, x.device) for lp, x in zip(lps, xs)]

    def normed(key, xs):
        hs = [L.rms_norm(lp[key], x, cfg.norm_eps) for lp, x in zip(lps, xs)]
        return col.group_all_gather(hs, 1) if sp else hs

    def add(xs, ys):
        ys = col.group_reduce_scatter(ys, 1) if sp else \
            col.group_all_reduce(ys)
        return [x + y.to(x.dtype) for x, y in zip(xs, ys)]

    att = [_attn_mix(lp, h, cos[m], sin[m], cfg, tp, (m, n), all_kv)[:3]
           for m, (lp, h) in enumerate(zip(lps, normed("attn_norm", xs)))]
    xs = add(xs, [a[0] for a in att])
    ffn = [_ffn_mix(lp, h, cfg, (m, n), ep_local)
           for m, (lp, h) in enumerate(zip(lps, normed("mlp_norm", xs)))]
    xs = add(xs, [f[0] for f in ffn])
    return xs, ffn[0][1], [a[1] for a in att], [a[2] for a in att]


def _seq_slices(xs, sp: bool):
    """Each member's sequence slice of its copy of the residual (views);
    ``xs`` itself without ``sp``."""
    if not sp:
        return xs
    s = xs[0].shape[1] // len(xs)
    return [x[:, m * s:(m + 1) * s] for m, x in enumerate(xs)]


def _mamba_tp(lps, xs, cfg: ArchConfig, states=None):
    """One Mamba2 layer over a model group in lockstep (pre-norm,
    residual): each member its block shard (``ssm.mamba_tp``: the chunked
    forward, or from ``states`` one decode step), its ``out_proj``
    partials all-reduced before the residual add. An FSDP leaf's
    ``DataSlices`` is gathered here. -> (xs, each member's new state)."""
    lps = [sh.materialize(lp, x.device) for lp, x in zip(lps, xs)]
    hs = [L.rms_norm(lp["norm"], x, cfg.norm_eps) for lp, x in zip(lps, xs)]
    ys, sts = S.mamba_tp([lp["mamba"] for lp in lps], hs, cfg, states)
    return [x + y for x, y in zip(xs, col.group_all_reduce(ys))], sts


def _split_families(cfg: ArchConfig, n: int):
    """Raise for a family the tensor-parallel split does not cover (xLSTM:
    the reference replicates its parameters) or a hybrid whose SSM heads
    do not split ``n`` ways."""
    if cfg.xlstm_pattern:
        raise ValueError(f"{cfg.name}: the tensor-parallel split covers the "
                         f"transformer families and the hybrid, not "
                         f"{cfg.family} (the reference replicates xLSTM's "
                         f"parameters)")
    if cfg.family == "hybrid":
        S.shard_widths(cfg, (0, n))


def forward_tp(group, cfg: ArchConfig, tokens, *, positions3=None,
               img_embeds=None, collect_cache: bool = False,
               remat: bool = False, tp: int = 16, sp: bool = False,
               ep_local: bool = False):
    """``forward`` over one model group: ``group`` holds each model shard's
    local parameter tree (``sharding.group_view``), in model-index order,
    each on its member's device. -> (each member's hidden [B,S,d], member
    0's aux, each member's caches or None).

    The inputs are broadcast to the members. Each member looks up its
    d-slice of the embedding, and an all-gather on d gives every member the
    residual stream (vlm's ``img_embeds`` then overwrite the first rows).
    The layers run in lockstep (``_tp_layer``, under remat as one function
    of the whole group; the hybrid's ``_hybrid_forward_tp``). A member's
    caches hold its own kv heads when ``kv_shardable``, else all of them
    (the hybrid's also its heads of the SSM states and its channels of x's
    conv states). Not xLSTM.

    ``sp`` runs the Megatron-SP residual (the reference's
    ``set_sp_residual``): after the embedding each member keeps its S / n
    slice of the residual (a view), the layers run on the slices
    (``_tp_layer``; the hybrid's shared block alone, as the reference's
    ``_sp`` sites lie only in its transformer layer), the final norm runs
    on the slice and one all-gather over the sequence gives every member
    the whole hidden state back. It needs S % n == 0. ``ep_local`` runs
    the MoE's shard-local dispatch (the reference's
    ``set_ep_constraint``). Neither changes the result."""
    _split_families(cfg, len(group))
    devs = _tp_devices(group)
    B, Sq = tokens.shape
    if sp and Sq % len(group):
        raise ValueError(f"{cfg.name}: the sequence-parallel residual needs "
                         f"the sequence length {Sq} to divide over the "
                         f"{len(group)} model shards (S % n == 0)")
    toks = col.group_broadcast(tokens, devs)
    xs = col.group_all_gather(
        [L.embed(sh.materialize(g["embed"], d), t)
         for g, t, d in zip(group, toks, devs)], -1)
    if img_embeds is not None:
        k = img_embeds.shape[1]
        xs = [torch.cat([im.to(x.dtype), x[:, k:]], dim=1) for x, im in
              zip(xs, col.group_broadcast(img_embeds, devs))]
    p3 = (col.group_broadcast(positions3, devs) if positions3 is not None
          else [None] * len(devs))
    tables = [_rope_tables(cfg, torch.arange(Sq, device=d)[None]
                           .expand(B, Sq), p) for d, p in zip(devs, p3)]
    cos, sin = [t[0] for t in tables], [t[1] for t in tables]
    if cfg.family == "hybrid":
        return _hybrid_forward_tp(group, cfg, xs, cos, sin, collect_cache,
                                  remat, tp, sp)
    per = [_unstack(g["layers"], cfg.n_layers) for g in group]
    aux = torch.zeros((), dtype=torch.float32, device=devs[0])
    ks, vs = [], []
    xs = _seq_slices(xs, sp)
    for i in range(cfg.n_layers):
        args = ([p[i] for p in per], xs, cos, sin, cfg, tp, collect_cache,
                sp, ep_local)
        xs, aux_l, k, v = (_remat(_tp_layer, *args) if remat
                           else _tp_layer(*args))
        aux = _add_aux(aux, aux_l)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    xs = [L.rms_norm(g["final_norm"], x, cfg.norm_eps)
          for g, x in zip(group, xs)]
    if sp:
        xs = col.group_all_gather(xs, 1)
    caches = None
    if collect_cache:
        caches = [{"k": torch.stack([k[m] for k in ks]),
                   "v": torch.stack([v[m] for v in vs]), "length": Sq}
                  for m in range(len(devs))]
    return xs, aux, caches


def _member_empty(cfg: ArchConfig, B: int, n: int, device, dtype,
                  lead=(0,)):
    """A zero-length stack ``[*lead, B, ...]`` of a member's Mamba2 states
    (an empty tail's, or an empty body's at ``lead`` (0, per)): fp32 ssm
    of its heads, conv states in the model dtype (x's of its channels)."""
    di, H = S.shard_widths(cfg, (0, n))
    K = cfg.ssm_conv
    z = lambda *shape, dt=dtype: torch.zeros(tuple(lead) + (B,) + shape,
                                              dtype=dt, device=device)
    return (z(H, cfg.ssm_head_dim, cfg.ssm_state, dt=torch.float32),
            (z(di, K - 1), z(cfg.ssm_state, K - 1), z(cfg.ssm_state, K - 1)))


def _hybrid_forward_tp(group, cfg, xs, cos, sin, collect_cache, remat, tp,
                       sp: bool = False):
    """The split twin of ``_hybrid_forward``: per super block each Mamba2
    layer's shard (``_mamba_tp``), then the shared attention + MLP block at
    that site through ``_tp_layer``, under remat as one function of the
    group (the group ops inside it, so the recompute reduces again); then
    the tail's layers. An FSDP leaf of the double-stacked body is gathered
    one Mamba2 layer at a time (``DataSlices.layers`` twice). With ``sp``
    the shared block enters on each member's sequence slice of the
    replicated residual and leaves by an all-gather over the sequence; the
    Mamba2 layers run on the whole residual as without it."""
    n_super, per, tail = _hybrid_shape(cfg)
    n = len(group)
    B = xs[0].shape[0]
    shared = [g["shared"] for g in group]
    bodies = [_unstack(g["body"], n_super) for g in group]
    tails = [_unstack(g["tail"], tail) for g in group]

    def super_fn(blps, xs):
        sts = []
        for lps in zip(*[_unstack(b, per) for b in blps]):
            xs, st = _mamba_tp(list(lps), xs, cfg)
            sts.append(st)
        xs, _, ks, vs = _tp_layer(shared, _seq_slices(xs, sp), cos, sin,
                                  cfg, tp, collect_cache, sp)
        if sp:
            xs = col.group_all_gather(xs, 1)
        return xs, sts, ks, vs

    def run(fn, *a):
        return _remat(fn, *a) if remat else fn(*a)

    body_st, ks, vs, tail_st = [], [], [], []
    for s in range(n_super):
        xs, sts, k, v = run(super_fn, [b[s] for b in bodies], xs)
        body_st += sts
        ks.append(k)
        vs.append(v)
    for t in range(tail):
        xs, st = run(_mamba_tp, [tl[t] for tl in tails], xs, cfg)
        tail_st.append(st)
    xs = [L.rms_norm(g["final_norm"], x, cfg.norm_eps)
          for g, x in zip(group, xs)]
    caches = None
    if collect_cache:
        caches = []
        kv = cfg.n_kv_heads // n if cfg.kv_shardable(n) else cfg.n_kv_heads
        for m, x in enumerate(xs):
            bs, bc = _stack_mamba([st[m] for st in body_st], (n_super, per),
                                  _member_empty(cfg, B, n, x.device,
                                                x.dtype, (0, per)))
            ts, tc = _stack_mamba([st[m] for st in tail_st], (tail,),
                                  _member_empty(cfg, B, n, x.device,
                                                x.dtype))
            kv0 = x.new_zeros((0, B, x.shape[1], kv, cfg.hd))
            caches.append({"body_ssm": bs, "body_conv": bc, "tail_ssm": ts,
                           "tail_conv": tc,
                           "shared_k": _stack_or([k[m] for k in ks], kv0),
                           "shared_v": _stack_or([v[m] for v in vs], kv0),
                           "length": x.shape[1]})
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    return xs, aux, caches


def _tp_logits(group, cfg: ArchConfig, xs):
    """Each member's vocabulary slice of the logits, and its first
    column."""
    devs = _tp_devices(group)
    vl = cfg.padded_vocab // len(group)
    starts = [m * vl for m in range(len(group))]
    return [L.lm_head(sh.materialize(g["lm_head"], d), x, cfg, s)
            for g, x, d, s in zip(group, xs, devs, starts)], starts


def train_loss_tp(group, cfg: ArchConfig, batch: Dict, *, remat: bool = True,
                  tp: int = 16, sp: bool = False,
                  ep_local: bool = False) -> torch.Tensor:
    """``train_loss`` over one model group (``forward_tp``, with its ``sp``
    and ``ep_local``): the logits cut over the vocabulary, the
    vocabulary-parallel cross-entropy (``layers.cross_entropy_tp``); one
    scalar, on member 0's device."""
    xs, aux, _ = forward_tp(group, cfg, batch["tokens"],
                            positions3=batch.get("positions3"),
                            img_embeds=batch.get("img_embeds"), remat=remat,
                            tp=tp, sp=sp, ep_local=ep_local)
    logits, starts = _tp_logits(group, cfg, xs)
    labels = col.group_broadcast(batch["labels"], _tp_devices(group))
    return L.cross_entropy_tp(logits, labels, starts) + MOE_AUX_COEF * aux


def prefill_tp(group, cfg: ArchConfig, tokens, *, max_len=None,
               positions3=None, img_embeds=None, tp: int = 16):
    """``prefill`` over one model group -> (the last logits [B, V] on member
    0's device, gathered from the members' vocabulary slices; each member's
    caches, zero-padded to ``max_len``)."""
    Sq = tokens.shape[1]
    max_len = max_len or Sq
    xs, _, caches = forward_tp(group, cfg, tokens, positions3=positions3,
                               img_embeds=img_embeds, collect_cache=True,
                               tp=tp)
    pad = (0, 0, 0, 0, 0, max_len - Sq)          # the sequence axis, dim 2
    for c in caches:
        for name in ("k", "v", "shared_k", "shared_v"):
            if name in c and max_len > Sq:
                c[name] = torch.nn.functional.pad(c[name], pad)
    logits, _ = _tp_logits(group, cfg, [x[:, -1:] for x in xs])
    last = col.group_all_gather(logits, -1, _tp_devices(group)[:1])[0]
    return last[:, 0], caches


# ---------------------------------------------------------------------------
# decode over a sequence-split cache (the mesh's decode layout)
# ---------------------------------------------------------------------------


def reshard_prefill_caches(parts, cfg: ArchConfig, mesh) -> Dict:
    """``prefill_tp``'s caches -> the decode split's, placed by
    ``cache_specs``. ``parts``: per data index, its model group's caches
    (each member's kv heads over the whole sequence, or all kv heads where
    they do not shard); long_500k's layout (a batch the data axes do not
    cut) takes one part, its group's. Each coordinate gets every kv head
    over its sequence slice: an all-to-all over the group (each member
    keeps 1/n of its part and sends the rest), or, where every member
    already holds every kv head, its own slice of its copy. The hybrid's
    ``shared_k`` / ``shared_v`` go as k / v, and its recurrent states as
    ``_reshard_states`` places them. -> {"k", "v" (the hybrid's
    "shared_k", "shared_v", and its states): ``ShardedTensor``,
    "length"}."""
    from repro_torch.configs.base import ShapeConfig

    hybrid = "shared_k" in parts[0][0]
    names = ("shared_k", "shared_v") if hybrid else ("k", "v")
    groups = sh.model_groups(mesh)
    n = len(groups[0])
    B = sum(p[0][names[0]].shape[1] for p in parts)
    S = parts[0][0][names[0]].shape[2]
    big = sh.big_batch(mesh, B)
    seqs = sh.seq_groups(mesh, B)
    if len(parts) != (len(groups) if big else 1):
        raise ValueError(f"{len(parts)} prefill parts for the decode layout "
                         f"of {B} rows on {dict(mesh.shape)}")
    out = {name: [None] * mesh.size for name in names}
    for g, seq in enumerate(seqs):
        src = parts[g if big else 0]
        devs = [mesh.device(c) for c in seq]
        Sl = S // len(seq)
        for name in names:
            if cfg.kv_shardable(n):
                got = col.all_to_all([p[name] for p in src], 2, 3, devs)
            else:
                with op_walk.collective("collective-permute"):
                    got = [src[j % n][name].narrow(2, j * Sl, Sl).to(
                        dev, copy=True) for j, dev in enumerate(devs)]
            for c, t in zip(seq, got):
                out[name][c] = t
    full = list(parts[0][0][names[0]].shape)
    full[1], full[3] = B, cfg.n_kv_heads
    length = parts[0][0]["length"]
    shape = ShapeConfig("decode", S, B, "decode")
    spec = sh.cache_specs({"k": 0}, cfg, shape, mesh)["k"]
    ns = sh.NamedSharding(mesh, spec)
    res = {name: sh.ShardedTensor(out[name], ns, full, out[name][0].dtype)
           for name in names}
    if hybrid:
        res.update(_reshard_states(parts, cfg, mesh, shape, big))
    return res | {"length": length}


def _state_tree(per_coord, cfg, mesh, shape):
    """Per coordinate (ssm, (conv x, B, C)) -> those trees as
    ``ShardedTensor``s placed by ``cache_specs``."""
    def full(t, axes):
        out = list(t.shape)
        for dim, size in axes.items():
            out[dim] = size
        return out

    B = shape.global_batch
    ssm0, conv0 = per_coord[0]
    specs = sh.cache_specs({"ssm": ssm0, "conv": conv0}, cfg, shape, mesh)

    def place(spec, get, axes):
        shards = [get(per_coord[c]) for c in range(mesh.size)]
        return sh.ShardedTensor(shards, sh.NamedSharding(mesh, spec),
                                full(shards[0], axes), shards[0].dtype)

    return (place(specs["ssm"], lambda t: t[0], {-4: B, -3: cfg.ssm_heads}),
            tuple(place(specs["conv"][k], lambda t, k=k: t[1][k], {-3: B})
                  for k in range(3)))


def _reshard_states(parts, cfg: ArchConfig, mesh, shape, big: bool) -> Dict:
    """The hybrid's recurrent states from ``prefill_tp``'s caches into
    ``cache_specs``' layout: the SSM states cut by heads over ``model``
    (each member's already are), rows over the data axes where the batch
    is cut, else replicated over them (long_500k: data index 0's states
    copied to the other data indices' coordinates); the conv states whole
    on every model member (x's channels all-gathered over the group)."""
    groups = sh.model_groups(mesh)
    out = {}
    for part in ("body", "tail"):
        per_coord = {}
        for d, grp in enumerate(groups):
            src = parts[d if big else 0]
            devs = [mesh.device(c) for c in grp]
            conv = [p[f"{part}_conv"] for p in src]
            with op_walk.collective("collective-permute"):
                ssm = [p[f"{part}_ssm"].to(dv) for p, dv in zip(src, devs)]
                bc = [tuple(c[k].to(dv) for k in (1, 2))
                      for c, dv in zip(conv, devs)]
            cx = col.group_all_gather([c[0] for c in conv], -2, devs)
            for m, c in enumerate(grp):
                per_coord[c] = (ssm[m], (cx[m],) + bc[m])
        out[f"{part}_ssm"], out[f"{part}_conv"] = _state_tree(
            per_coord, cfg, mesh, shape)
    return out


def decode_step_tp(params, cfg: ArchConfig, token, caches, mesh, *,
                   tp: int = 16, sparse=None, sparse_params=None,
                   positions3=None):
    """``decode_step`` over the mesh's decode layout: token [B] + caches
    placed by ``cache_specs`` (``ShardedTensor`` k / v, the hybrid's
    ``shared_k`` / ``shared_v``: decode_32k's rows on the data axes and
    sequence on ``model``; long_500k's sequence over (data, model),
    data-major; the hybrid's SSM states by heads over ``model`` and its
    conv states whole on every model member) -> (logits [B, V] on the
    first coordinate's device, the caches; with a stateful ``sparse``,
    the sparse params too). ``params``: placed by ``param_specs``;
    ``sparse``: a split method (``core.methods.split_sparse``:
    ``dsa.SplitDSA``, ``seer.SplitSeer`` in top-k or threshold mode,
    ``lserve.SplitLServe``) or None (dense); ``sparse_params``: its
    weights placed by ``method_specs`` (DSA's indexer, Seer's gate,
    LServe's dummy leaf; the hybrid's: one set, used at every site of its
    shared block; stateful DSA: ``{"p": those, "kidx_sum": placed like
    K}``).

    Each computing data index runs its ``DecodeGroup`` (decode_32k: every
    data index over its rows; long_500k, a batch the data axes do not cut:
    data index 0 over the whole batch), the groups a layer at a time
    (``_decode_layers``): the attention half of each, then the FFN half of
    each, with the MoE router's inputs of every data index
    (``moe.moe_apply_gathered``: the batch's one dispatch group, as on one
    device); the hybrid's Mamba2 layers between its sites. The logits are
    gathered onto each group's first device, then the rows onto the first
    coordinate's. The new K/V (and a stateful index cache) are written in
    place; the hybrid's new states come back as new ``ShardedTensor``s
    placed as before (``_place_states``). Not xLSTM."""
    _split_families(cfg, mesh.shape.get(sh.MODEL_AXIS, 1))
    B = token.shape[0]
    big = sh.big_batch(mesh, B)
    dis = range(len(sh.model_groups(mesh))) if big else [0]
    groups = [DecodeGroup(params, cfg, token, caches, mesh, d, tp=tp,
                          sparse=sparse, sparse_params=sparse_params,
                          positions3=positions3) for d in dis]
    _decode_layers(groups, cfg)
    lasts = [g.logits() for g in groups]
    dev0 = lasts[0].device
    with op_walk.collective("all-gather"):
        logits = torch.cat([t.to(dev0) for t in lasts], 0)
    caches = dict(caches, length=int(caches["length"]) + 1)
    if cfg.family == "hybrid":
        caches.update(_place_states(groups, caches, cfg, mesh))
    if sparse is not None and sparse.stateful:
        return logits, caches, sparse_params
    return logits, caches


def _decode_layers(groups, cfg: ArchConfig, router=lambda hs: hs) -> None:
    """Every layer of a split step over the computing groups in lockstep:
    a transformer's attention half of each group, then the FFN half of
    each with ``router(hs)`` (every data index's FFN inputs: the dry run
    stands the groups it does not walk in); the hybrid's Mamba2 layers of
    each super block, its shared block's site, then the tail."""
    def site(i):
        hs = router([g.attention(i) for g in groups])
        for g in groups:
            g.ffn(i, hs)

    if cfg.family != "hybrid":
        for i in range(cfg.n_layers):
            site(i)
        return
    n_super, per, tail = _hybrid_shape(cfg)
    for s in range(n_super):
        for j in range(per):
            for g in groups:
                g.mamba("body", (s, j))
        site(s)
    for t in range(tail):
        for g in groups:
            g.mamba("tail", (t,))


def _place_states(groups, caches, cfg: ArchConfig, mesh) -> Dict:
    """The hybrid's new recurrent states, placed as ``caches``' old ones:
    each computing group's members give their coordinates'; a coordinate
    of a data index that did not compute (long_500k's layout) gets a copy
    of its model index's member's, so every shard stays equal to its
    slice."""
    from repro_torch.configs.base import ShapeConfig

    n_super, per, tail = _hybrid_shape(cfg)
    out = {}
    shape = ShapeConfig("decode", caches["shared_k"].shape[2],
                        caches["shared_k"].shape[1], "decode")
    member = groups[0].member
    for part, lead in (("body", (n_super, per)), ("tail", (tail,))):
        if not int(np.prod(lead)):
            continue
        per_coord = {}
        for g in groups:
            for m, c in enumerate(g.group):
                per_coord[c] = _stack_mamba(
                    [st[m] for st in g.new_states[part]], lead, None)
        for c in range(mesh.size):
            if c not in per_coord:
                src, dev = per_coord[member[c]], mesh.device(c)
                with op_walk.collective("collective-permute"):
                    per_coord[c] = (src[0].to(dev, copy=True),
                                    tuple(t.to(dev, copy=True)
                                          for t in src[1]))
        out[f"{part}_ssm"], out[f"{part}_conv"] = _state_tree(
            per_coord, cfg, mesh, shape)
    return out


class DecodeGroup:
    """One computing data index's share of ``decode_step_tp``: its model
    group's parameter slices and activations, its sequence group's caches
    (decode_32k: its model group's; long_500k: the whole mesh's). A layer
    is ``attention(i)`` then ``ffn(i, router)``; ``logits()`` ends the
    step.

    Attention: the members project the new token on their head slices and
    all-gather q (and k / v where the kv heads shard); the coordinate
    owning position ``length`` writes k / v into its slice; every
    coordinate of the sequence group attends over its own slice
    (``sparse``: its selection's candidates and page ids cross too; or
    dense ``attention_decode_partial``) and only (out, lse) pairs cross:
    member m's head slice merged by ``lse_merge``, into its row-parallel
    ``wo``, all-reduced. Under long_500k a coordinate of
    another data index attends with the query of the member of its model
    index (sent to it, with the new k / v to the owner). The FFN is
    ``prefill_tp``'s. The hybrid's sites read its shared block and
    ``shared_k`` / ``shared_v``, with one set of the method's weights at
    every site (its ``decode_step``'s); between them ``mamba`` runs a Mamba2
    layer's decode shard, and ``new_states`` keeps each member's new
    states."""

    def __init__(self, params, cfg: ArchConfig, token, caches, mesh, d: int,
                 *, tp: int = 16, sparse=None, sparse_params=None,
                 positions3=None):
        self.hybrid = hybrid = cfg.family == "hybrid"
        _split_families(cfg, mesh.shape.get(sh.MODEL_AXIS, 1))
        if hybrid and sparse is not None and sparse.stateful:
            raise ValueError(f"{cfg.name}: the hybrid's decode_step carries "
                             f"no index cache (its shared block's sites "
                             f"share one indexer)")
        B = token.shape[0]
        self.length = length = int(caches["length"])
        self.caches = caches
        self.kc = caches["shared_k" if hybrid else "k"]
        self.vc = caches["shared_v" if hybrid else "v"]
        S = self.kc.shape[2]
        if length >= S:
            raise ValueError(f"cache full: length {length} of {S}")
        groups = sh.model_groups(mesh)
        dp = len(groups)
        self.n = n = len(groups[0])
        big = sh.big_batch(mesh, B)
        if not (big or d == 0):
            raise ValueError("long_500k's layout: data index 0 computes for "
                             "all")
        self.seq = sh.seq_groups(mesh, B)[d if big else 0]
        self.Sl = S // len(self.seq)
        if self.kc.shards[self.seq[0]].shape[1:3] != (
                (B // dp if big else B), self.Sl):
            raise ValueError("the caches are not placed by cache_specs")
        self.cfg, self.mesh, self.d, self.tp = cfg, mesh, d, tp
        self.sparse, self.group = sparse, groups[d]
        self.view = sh.group_view(params, mesh, d)
        self.devs = _tp_devices(self.view)
        # the coordinate -> the member of its model index in this group
        self.member = {c: self.group[m] for g in groups
                       for m, c in enumerate(g)}
        self.sp = ({c: sh.local(sparse_params, c) for c in self.seq}
                   if sparse is not None else {})
        self.heads = [A.shard_heads(cfg, tp, (m, n)) for m in range(n)]
        self.moe_gather = bool(cfg.n_experts) and big and dp > 1
        rows = sh.row_block(mesh, B, d)
        toks = col.group_broadcast(token[rows], self.devs)
        self.xs = col.group_all_gather(
            [L.embed(sh.materialize(g["embed"], dv), t[:, None])
             for g, t, dv in zip(self.view, toks, self.devs)], -1)
        p3 = (col.group_broadcast(positions3[:, rows], self.devs)
              if positions3 is not None else [None] * n)
        tables = [_rope_tables(cfg, torch.full(
            (t.shape[0], 1), length, dtype=torch.long, device=dv), p)
            for t, dv, p in zip(toks, self.devs, p3)]
        self.cos, self.sin = zip(*tables)
        if hybrid:
            n_super, per, tail = _hybrid_shape(cfg)
            self.per = [[g["shared"]] * n_super for g in self.view]
            self.body = [[_unstack(b, per) for b in _unstack(g["body"],
                                                             n_super)]
                         for g in self.view]
            self.tail = [_unstack(g["tail"], tail) for g in self.view]
            self.new_states = {"body": [], "tail": []}
        else:
            self.per = [_unstack(g["layers"], cfg.n_layers)
                        for g in self.view]

    def _sp(self, c: int, i: int):
        """Coordinate c's indexer weights at layer (the hybrid: site) i."""
        return self.sp[c] if self.hybrid else layer(self.sp[c], i)

    def mamba(self, part: str, idx: tuple) -> None:
        """One Mamba2 layer's decode shard (``part`` "body" at (site,
        layer), "tail" at (layer,)): each member from its coordinate's
        heads of the SSM state and its channels of the conv state of x
        (``ssm.mamba_tp``); its new x channels are all-gathered over
        the group, as the layout keeps the conv states whole on every
        member."""
        lps = [self.body[m][idx[0]][idx[1]] if part == "body" else
               self.tail[m][idx[0]] for m in range(self.n)]
        ssm, conv = self.caches[f"{part}_ssm"], self.caches[f"{part}_conv"]
        states = [(ssm.shards[c][idx], tuple(t.shards[c][idx] for t in conv))
                  for c in self.group]
        self.xs, new = _mamba_tp(lps, self.xs, self.cfg, states)
        cx = col.group_all_gather([st[1][0] for st in new], 1)
        self.new_states[part].append(
            [(st[0], (x,) + st[1][1:]) for st, x in zip(new, cx)])

    def attention(self, i: int) -> List[torch.Tensor]:
        """Layer ``i``'s attention half -> each member's FFN input (the
        normed residual)."""
        cfg, tp, n, mesh = self.cfg, self.tp, self.n, self.mesh
        self.lps = [sh.materialize(p[i], dv)
                    for p, dv in zip(self.per, self.devs)]
        qkv = [A.project_qkv_shard(
            lp["attn"], L.rms_norm(lp["attn_norm"], x, cfg.norm_eps),
            self.cos[m], self.sin[m], cfg, tp, (m, n))
            for m, (lp, x) in enumerate(zip(self.lps, self.xs))]
        q = col.group_all_gather([t[0] for t in qkv], 2)
        if cfg.kv_shardable(n):
            k = col.group_all_gather([t[1] for t in qkv], 2)
            v = col.group_all_gather([t[2] for t in qkv], 2)
        else:
            k, v = [t[1] for t in qkv], [t[2] for t in qkv]
        iq = (self.sparse.index_query([self._sp(c, i) for c in self.group],
                                      q)
              if self.sparse is not None else [None] * n)
        new = {c: (q[m], k[m], v[m], iq[m]) for m, c in enumerate(self.group)}
        owner = self.seq[self.length // self.Sl]
        loc = self.length % self.Sl
        shards = []
        for c in self.seq:
            dev = mesh.device(c)
            if c not in new:        # long_500k: its model index's query
                src = new[self.member[c]]
                with op_walk.collective("collective-permute"):
                    qc = src[0].to(dev)
                    iqc = (None if src[3] is None else
                           tuple(t.to(dev) for t in src[3]))
                    kv = ((src[1].to(dev), src[2].to(dev))
                          if c == owner else (None, None))
                new[c] = (qc, *kv, iqc)
            qc, kn, vn, iqc = new[c]
            kc, vc = self.kc.shards[c][i], self.vc.shards[c][i]
            if c == owner:
                kc[:, loc] = kn[:, 0].to(kc.dtype)
                vc[:, loc] = vn[:, 0].to(vc.dtype)
            s = {"q": qc, "kc": kc, "vc": vc,
                 "k_new": kn if c == owner else None}
            if self.sparse is not None:
                s["iq"], s["sp"] = iqc, self._sp(c, i)
            shards.append(s)
        if self.sparse is not None:
            parts = self.sparse(shards, self.length + 1)
        else:
            parts = [A.attention_decode_partial(
                s["q"], s["kc"], s["vc"], self.length + 1, j * self.Sl, cfg,
                tp=tp) for j, s in enumerate(shards)]
        merged = topk.merge_partials(parts, [
            (mesh.device(c), hs) for c, hs in zip(self.group, self.heads)])
        ys = [_attn_out(lp["attn"], o[:, None].to(qm.dtype), cfg, tp,
                        shard=(m, n))
              for m, (lp, (o, _), qm) in enumerate(zip(self.lps, merged, q))]
        self.xs = [x + y for x, y in zip(self.xs, col.group_all_reduce(ys))]
        return [L.rms_norm(lp["mlp_norm"], x, cfg.norm_eps)
                for lp, x in zip(self.lps, self.xs)]

    def ffn(self, i: int, router) -> None:
        """Layer ``i``'s FFN half. ``router``: every data index's
        ``attention`` outputs, in data-index order (this group's at its
        own index); a gathered MoE dispatch (``moe_gather``) reads them
        all, anything else only its own."""
        cfg, n = self.cfg, self.n
        hs = router[self.d]
        ys = []
        for m, lp in enumerate(self.lps):
            if not cfg.n_experts:
                ys.append(L.mlp(lp["mlp"], hs[m]))
            elif self.moe_gather:      # the batch's one dispatch group
                ys.append(MOE.moe_apply_gathered(
                    lp["moe"], [h[m] for h in router], self.d, self.devs[m],
                    cfg, shard=(m, n)))
            else:
                ys.append(MOE.moe_apply(lp["moe"], hs[m], cfg,
                                        shard=(m, n))[0])
        self.xs = [x + y.to(x.dtype) for x, y in zip(
            self.xs, col.group_all_reduce(ys))]

    def logits(self) -> torch.Tensor:
        """The group's rows' logits [B_d, V] on its first device."""
        xs = [L.rms_norm(g["final_norm"], x, self.cfg.norm_eps)
              for g, x in zip(self.view, self.xs)]
        logits, _ = _tp_logits(self.view, self.cfg, xs)
        return col.group_all_gather(logits, -1, self.devs[:1])[0][:, 0]


def last_logits(params, cfg: ArchConfig, x):
    return L.lm_head(params["lm_head"], x[:, -1:], cfg)[:, 0]


def make_cache(cfg: ArchConfig, batch: int, max_len: int, tp: int = 16,
               dtype=None, device="cuda") -> Dict:
    """Per-request cache with the shared ``length`` (a host int): a
    transformer's k/v [L, B, max_len, KV, hd] zeros; the hybrid's Mamba2
    states (fp32 zeros, ``[n_super, per]`` and ``[tail]`` stacked) and the
    shared block's k/v per site [n_super, B, max_len, KV, hd]; xLSTM's
    (mLSTM, sLSTM) states [nb, ...], all zeros as in the reference."""
    dev = resolve_device(device)
    dt = dtype or L.dtype_of(cfg)
    kv_shape = lambda n: (n, batch, max_len, cfg.n_kv_heads, cfg.hd)
    zeros = lambda lead, a: torch.zeros(tuple(lead) + a.shape,
                                        dtype=a.dtype, device=dev)
    if cfg.family == "hybrid":
        n_super, per, tail = _hybrid_shape(cfg)
        ssm, conv = S.mamba_state_init(cfg, batch, device=dev)
        return {
            "body_ssm": zeros((n_super, per), ssm),
            "body_conv": tuple(zeros((n_super, per), c) for c in conv),
            "tail_ssm": zeros((tail,), ssm),
            "tail_conv": tuple(zeros((tail,), c) for c in conv),
            "shared_k": torch.zeros(kv_shape(n_super), dtype=dt, device=dev),
            "shared_v": torch.zeros(kv_shape(n_super), dtype=dt, device=dev),
            "length": 0}
    if cfg.xlstm_pattern:
        nb = cfg.n_layers // 2
        m = X.mlstm_state_init(cfg, batch, device=dev)
        s = X.slstm_state_init(cfg, batch, device=dev)
        return {"states": (tuple(zeros((nb,), a) for a in m),
                           tuple(zeros((nb,), a) for a in s)),
                "length": 0}
    return {"k": torch.zeros(kv_shape(cfg.n_layers), dtype=dt, device=dev),
            "v": torch.zeros(kv_shape(cfg.n_layers), dtype=dt, device=dev),
            "length": 0}


def prefill(params, cfg: ArchConfig, tokens, *, max_len=None,
            positions3=None, img_embeds=None, tp: int = 16):
    """Full prompt pass -> (last logits [B, V], caches), the KV caches zero-
    padded to ``max_len`` (>= S) so decode can continue in place."""
    Sq = tokens.shape[1]
    max_len = max_len or Sq
    x, _, caches = forward(params, cfg, tokens, positions3=positions3,
                           img_embeds=img_embeds, collect_cache=True, tp=tp)
    pad = (0, 0, 0, 0, 0, max_len - Sq)          # the sequence axis, dim 2
    for name in ("k", "v", "shared_k", "shared_v"):
        if name in caches and max_len > Sq:
            caches[name] = torch.nn.functional.pad(caches[name], pad)
    return last_logits(params, cfg, x), caches


def _stack_layers(trees):
    """Per-layer parameter trees -> one layer-stacked tree (a list of
    per-shard tensors -> a list of per-shard stacks)."""
    if isinstance(trees[0], dict):
        return {k: _stack_layers([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack_layers([t[s] for t in trees])
                for s in range(len(trees[0]))]
    return torch.stack(trees)


def _tf_layer_decode(lp, x, cos, sin, cfg: ArchConfig, tp: int, kc, vc,
                     length: int, sparse_fn=None, sp=None):
    """One token through one transformer layer against its cache (kc / vc
    [B, Smax, KV, hd], the new K/V written at ``length`` in place) -> (x,
    sp): a stateful ``sparse_fn`` returns (attn, new sp)."""
    h = L.rms_norm(lp["attn_norm"], x, cfg.norm_eps)
    q, k, v = A.project_qkv(lp["attn"], h, cos, sin, cfg, tp)
    kc[:, length] = k[:, 0].to(kc.dtype)
    vc[:, length] = v[:, 0].to(vc.dtype)
    if sparse_fn is not None:
        res = sparse_fn(q, kc, vc, length + 1, sp, k_new=k)
        attn, sp = res if isinstance(res, tuple) else (res, sp)
    else:
        attn = A.attention_decode(q, kc, vc, length + 1, cfg, tp=tp)
    return _mlp_block(lp, x + _attn_out(lp["attn"], attn, cfg, tp), cfg), sp


def decode_step(params, cfg: ArchConfig, token, caches, *, tp: int = 16,
                sparse_fn=None, sparse_params=None, sparse_stateful=False,
                positions3=None):
    """token [B] + caches -> (logits [B, V], caches), every row at the
    shared ``caches["length"]``.

    ``sparse_fn(q, kc, vc, length, sp_layer, k_new=)`` replaces dense
    decode attention; ``sparse_params`` is layer-stacked (the hybrid's: one
    set for the shared block, used at each of its sites). With
    ``sparse_stateful=True`` (transformers) the sparse_fn returns (attn,
    new sp_layer) and this returns (logits, caches, new sparse_params). The
    new K/V are written into the cache's k/v (the hybrid's ``shared_k`` /
    ``shared_v``) in place; recurrent states come back as new tensors.
    """
    B = token.shape[0]
    length = int(caches["length"])
    kc_all = caches.get("k", caches.get("shared_k"))
    if kc_all is not None and length >= kc_all.shape[2]:
        raise ValueError(f"cache full: length {length} of "
                         f"{kc_all.shape[2]}")
    x = L.embed(params["embed"], token[:, None])
    positions = torch.full((B, 1), length, dtype=torch.long, device=x.device)
    cos, sin = _rope_tables(cfg, positions, positions3)
    if cfg.family == "hybrid":
        x, caches = _hybrid_decode(params, cfg, x, cos, sin, caches, tp,
                                   sparse_fn, sparse_params)
        x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return last_logits(params, cfg, x), caches
    if cfg.xlstm_pattern:
        # _xlstm_forward applies the final norm itself
        x, _, new = _xlstm_forward(params, cfg, x, True, False,
                                   states=caches["states"])
        return last_logits(params, cfg, x), dict(
            caches, states=new["states"], length=length + 1)
    sp_new = []
    for i in range(cfg.n_layers):
        sp = None if sparse_params is None else layer(sparse_params, i)
        x, sp = _tf_layer_decode(layer(params["layers"], i), x, cos, sin,
                                 cfg, tp, caches["k"][i], caches["v"][i],
                                 length, sparse_fn, sp)
        sp_new.append(sp)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    caches = dict(caches, length=length + 1)
    logits = last_logits(params, cfg, x)
    if sparse_stateful:
        return logits, caches, _stack_layers(sp_new)
    return logits, caches


def _hybrid_decode(params, cfg, x, cos, sin, caches, tp, sparse_fn,
                   sparse_params=None):
    """One token through the hybrid: per super block its Mamba2 layers'
    decode steps, then the shared block against that site's cache."""
    n_super, per, tail = _hybrid_shape(cfg)
    length = int(caches["length"])
    body = []
    for s, blp in enumerate(_unstack(params["body"], n_super)):
        x, st = _mamba_layers(blp, x, cfg, per, states=(
            caches["body_ssm"][s], tuple(c[s] for c in caches["body_conv"])))
        body += st
        x, _ = _tf_layer_decode(params["shared"], x, cos, sin, cfg, tp,
                                caches["shared_k"][s], caches["shared_v"][s],
                                length, sparse_fn, sparse_params)
    x, tail_st = _mamba_layers(params["tail"], x, cfg, tail, states=(
        caches["tail_ssm"], caches["tail_conv"]))
    bs, bc = _stack_mamba(body, (n_super, per),
                          (caches["body_ssm"], caches["body_conv"]))
    ts, tc = _stack_mamba(tail_st, (tail,),
                          (caches["tail_ssm"], caches["tail_conv"]))
    return x, dict(caches, body_ssm=bs, body_conv=bc, tail_ssm=ts,
                   tail_conv=tc, length=length + 1)


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
                             tp: int = 16, page_attn=None):
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

    ``page_attn`` replaces the selected-page attention (``ops.paged_decode_
    attention``'s contract: (q, kc, vc, pids, lengths, page_size=) -> (out,
    lse)); the main mesh installs ``distributed_paged_sparse_decode``. With
    it installed the dense branch runs through the same seam, every page of
    the view selected (``lb`` masks the live region), so neither branch
    leaves the mesh, as in the reference.

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
        out, _ = attn(strip_dead_heads(q, cfg), kc, vc,
                      s_full.to(torch.int32), lb, page_size=ps)
        return repad_dead_heads(out, q, cfg)

    def all_pages_attention(q, kc, vc, lb, sp, k_new=None):
        B, n_pages = q.shape[0], kc.shape[1] // ps
        allp = torch.arange(n_pages, dtype=torch.int32,
                            device=kc.device).expand(B, n_pages)
        out, _ = attn(strip_dead_heads(q, cfg), kc, vc, allp, lb,
                      page_size=ps)
        return repad_dead_heads(out, q, cfg)

    attn = page_attn or ops.paged_decode_attention
    sparse_fn = presel_attention if sparse else \
        all_pages_attention if page_attn is not None else None
    return decode_step_paged(
        params, cfg, token, pool, live, tp=tp, sparse_fn=sparse_fn,
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
    x, _, caches = forward(params, cfg, tokens, collect_cache=True,
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
