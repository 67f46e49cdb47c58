"""DeepSeek Sparse Attention, lightning indexer (twin of
``repro.core.methods.dsa``), paper Table 1 row 1.

  prepare   project the query and the cached keys into compact index vectors
  relevancy 64-head inner product, per-head ReLU, query-weighted sum
  retrieve  top-k, quantized to micro-pages of ``page`` tokens
  apply     attention restricted to the retrieved pages

Relevancy + retrieve run in the fused relevancy kernel, apply in the paged
decode attention kernel (``repro_torch.kernels``). ``build_pipeline`` gives
the same method as a four-stage ``MemoryPipeline``, unfused (plain scores
and a stable top-k) or fused (the relevancy kernel).

PyTorch does not promote mixed dtypes in ``@``; JAX does. Every cast below
that JAX's promotion made implicitly is written out.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, MemoryConfig
from repro_torch.core.pipeline import MemoryPipeline
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

Params = Dict

# Stages that may leave the KV-owning device (paper §5.2): the indexer reads
# only compressed index vectors; apply gathers raw KV pages and stays.
OFFLOAD_STAGES = ("prepare", "relevancy", "retrieve")


def dsa_init(cfg: ArchConfig, mem: MemoryConfig, seed: int = 0, *,
             stacked: bool = True, device="cuda") -> Params:
    """Per-layer lightning-indexer weights, stacked [L, ...]. ``wq_idx`` and
    ``wk_idx`` are always bf16, ``w_wgt`` fp32, as in the reference."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hd = cfg.hd
    hp_in = cfg.n_heads * hd
    kv_in = cfg.n_kv_heads * hd
    lead = (cfg.n_layers if stacked else 1,)
    p = {
        "wq_idx": L.dense_init(gen, hp_in, mem.index_heads * mem.index_dim,
                               torch.bfloat16, lead=lead),
        "wk_idx": L.dense_init(gen, kv_in, mem.index_dim, torch.bfloat16,
                               lead=lead),
        "w_wgt": L.dense_init(gen, hp_in, mem.index_heads, torch.float32,
                              scale=0.02, lead=lead),
    }
    return p if stacked else {k: v[0] for k, v in p.items()}


def _matmul_promoted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype JAX's promotion gives (fp32 @ bf16 -> fp32,
    bf16 @ bf16 -> bf16)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _index_qw(sp: Params, q: torch.Tensor):
    """q [B,Hp,hd] -> (q_idx [B,Hi,di], w [B,Hi] fp32); the dead-head
    columns of q are dropped first."""
    B = q.shape[0]
    qf = q.reshape(B, -1)[:, : sp["wq_idx"].shape[0]]
    # qf is in the model dtype, wq_idx bf16: JAX promotes, torch must be told
    q_idx = _matmul_promoted(qf, sp["wq_idx"]).reshape(
        B, -1, sp["wk_idx"].shape[1])
    # the weights are fp32; qf.float() is the reference's own cast
    w = torch.softmax(qf.float() @ sp["w_wgt"], dim=-1)
    return q_idx, w


def _index_k(sp: Params, k_cache: torch.Tensor, page: int):
    """k_cache [B,S,KV,hd] -> index keys mean-pooled per micro-page
    [B, S/page, di]."""
    B, S = k_cache.shape[:2]
    k_idx = _matmul_promoted(k_cache.reshape(B, S, -1), sp["wk_idx"])
    return k_idx.reshape(B, S // page, page, -1).mean(dim=2)


def strip_dead_heads(q: torch.Tensor, cfg: ArchConfig):
    """[B, 1, Hp, hd] -> [B, n_heads, hd]: drop TP dead-head padding before
    the paged attention kernel (it needs Hq % KV == 0)."""
    return q[:, 0, : cfg.n_heads]


def repad_dead_heads(out: torch.Tensor, q_like: torch.Tensor,
                     cfg: ArchConfig):
    """[B, n_heads, hd] -> [B, 1, Hp, hd] (zeros in the dead-head slots),
    in q's dtype."""
    B, _, HP, hd = q_like.shape
    full = torch.zeros((B, HP, hd), dtype=q_like.dtype, device=out.device)
    full[:, : cfg.n_heads] = out.to(q_like.dtype)
    return full[:, None]


def select_pages(sp: Params, q, kc, lb, mem: MemoryConfig, page: int):
    """prepare + relevancy + retrieve for one layer: q [B,1,Hp,hd], kc
    [B,S,KV,hd], lb [B] live lengths -> selected page ids [B, top_k // page]
    int32, -1 past each slot's live context."""
    S = kc.shape[1]
    n_pages_sel = max(mem.top_k // page, 1)
    # --- prepare: index projection of the query and the cached keys;
    # page-level scores through mean-pooled index keys per micro-page ---
    q_idx, w = _index_qw(sp, q[:, 0])
    kp = _index_k(sp, kc, page)
    # --- fused relevancy + retrieve (kernel) ---
    _, pidx = ops.relevancy_topk(q_idx, kp, w, n_pages_sel,
                                 block=max(min(4096, S // page), n_pages_sel))
    # mask pages beyond each slot's live context
    return torch.where(pidx * page < lb[:, None], pidx,
                       torch.full_like(pidx, -1)).to(torch.int32)


def make_sparse_fn(cfg: ArchConfig, mem: MemoryConfig, *, tp: int = 16,
                   page: int = 16, max_context: int = 0):
    """Returns sparse_fn(q, kc, vc, length, sp, k_new=None) for
    ``model.decode_step_paged``."""

    def sparse_fn(q, kc, vc, length, sp, k_new=None):
        lb = torch.as_tensor(length, dtype=torch.int32,
                             device=q.device).reshape(-1).expand(q.shape[0])
        pidx = select_pages(sp, q, kc, lb, mem, page)
        # --- apply: paged sparse attention over the retrieved pages ---
        out, _ = ops.paged_decode_attention(strip_dead_heads(q, cfg), kc, vc,
                                            pidx, lb, page_size=page)
        return repad_dead_heads(out, q, cfg)

    return sparse_fn


def make_sparse_fn_distributed(cfg: ArchConfig, mem: MemoryConfig, devices,
                               *, tp: int = 16, page: int = 64):
    """Sequence-parallel sparse decode over the device tuple ``devices``
    (``launch.mesh``): ``SplitDSA`` over the cache cut into one slice per
    device (distributed top-k with an index-only exchange, per-shard paged
    attention), its (out, lse) pairs merged onto ``devices[0]``."""
    split = SplitDSA(cfg, mem, page=page)

    def sparse_fn(q, kc, vc, length, sp, k_new=None):
        return _split_over(split, devices, q, kc, vc, length, sp)

    return sparse_fn


def idx_cache_init(cfg: ArchConfig, mem: MemoryConfig, batch: int,
                   max_len: int, *, page: int = 64, stacked: bool = True,
                   device="cuda") -> torch.Tensor:
    """Incremental pooled-index cache: per-page SUM of index vectors (the
    mean is recovered at score time from ``length``), so the prepare stage
    projects one token a step instead of the whole context."""
    shape = (batch, max_len // page, mem.index_dim)
    if stacked:
        shape = (cfg.n_layers,) + shape
    return torch.zeros(shape, dtype=torch.float32,
                       device=resolve_device(device))


def make_sparse_fn_cached(cfg: ArchConfig, mem: MemoryConfig, devices, *,
                          tp: int = 16, page: int = 64):
    """Stateful sequence-parallel sparse decode: ``sp = {"p": indexer
    weights, "kidx_sum": pooled index cache}`` (one tensor, or its per-shard
    tensors). Per step it projects ONLY the new token's key, adds it into
    the owning shard's page (``sharded_page_add``), then runs the stateful
    ``SplitDSA`` over the per-shard caches, merged onto ``devices[0]``.
    ``length`` is the step's context length (an int or a 0-d tensor).
    Returns (out, sp with ``kidx_sum`` as per-shard tensors)."""
    from repro_torch.distributed.topk import sharded_page_add

    split = SplitDSA(cfg, mem, page=page, stateful=True)

    def sparse_fn(q, kc, vc, length, sp, k_new=None):
        B = q.shape[0]
        # prepare, incremental: index the ONE key written this step; the
        # page update stays on the shard that owns the page
        k_idx_new = _matmul_promoted(k_new.reshape(B, -1),
                                     sp["p"]["wk_idx"]).float()
        kidx_sum = sharded_page_add(sp["kidx_sum"], k_idx_new,
                                    (length - 1) // page, devices)
        out = _split_over(split, devices, q, kc, vc, length,
                          [dict(sp, kidx_sum=kx) for kx in kidx_sum])
        return out, dict(sp, kidx_sum=kidx_sum)

    return sparse_fn


def _split_over(split, devices, q, kc, vc, length, sp):
    """The one-device sparse fn's contract over ``split``: q [B,1,Hp,hd]
    on ``devices[0]``, the caches whole (cut here, a slice to each device)
    or per-shard, ``sp`` this layer's indexer weights or per-shard dicts
    -> out [B,1,Hp,hd] merged onto ``devices[0]``."""
    from repro_torch.distributed.topk import (_per_shard, _shards,
                                              merge_partials)

    n = len(devices)
    sps = _per_shard(sp, n)
    iq = _index_qw(sps[0]["p"] if split.stateful else sps[0], q[:, 0])
    shards = [{"q": q, "iq": iq, "kc": k.to(d), "vc": v.to(d),
               "sp": s if split.stateful else
               {name: w.to(d) for name, w in s.items()}}
              for d, k, v, s in zip(devices, _shards(kc, n), _shards(vc, n),
                                    sps)]
    (out, _), = merge_partials(split(shards, length),
                               [(devices[0], slice(None))])
    return out[:, None].to(q.dtype)


class SplitDSA:
    """DSA over a sequence-split cache, for ``models.model.decode_step_tp``
    (the reference's ``make_sparse_fn_distributed`` / ``_cached`` as GSPMD
    partitions them over ``cache_specs``): every shard holds its own slice
    of K/V and, stateful, of the pooled index cache ``kidx_sum``; no KV
    page and no raw score crosses between shards.

      prepare    the query side per model group (``index_query``: each
                 member's columns of ``wq_idx`` / ``w_wgt``, all-gathered);
                 the key side per shard over its own slice (``_index_k``),
                 or, stateful, the new token's index key added into the
                 owning shard's page and each shard's page means;
      relevancy  + retrieve: ``ops.relevancy_topk`` per shard, the (value,
                 index) candidates merged on the sequence group's first
                 device (``distributed_relevancy_topk``), the page ids
                 delivered to every shard;
      apply      ``ops.paged_decode_attention`` per shard over the selected
                 pages it owns -> (out, lse) per shard
                 (``sparse_decode_partials``), merged by the caller for
                 each member's heads.

    ``make_sparse_fn_distributed`` / ``_cached`` run it over one device
    tuple with the one-device sparse fn's contract. ``record=True`` keeps
    each call's merged page ids (``selected``)."""

    def __init__(self, cfg: ArchConfig, mem: MemoryConfig, *,
                 page: int = 64, stateful: bool = False,
                 record: bool = False):
        self.cfg, self.page = cfg, page
        self.stateful, self.record = stateful, record
        self.n_sel = max(mem.top_k // page, 1)
        self.selected = []

    def index_query(self, sps, qs):
        """One model group: each member's indexer weights (its columns of
        ``wq_idx`` / ``w_wgt``; stateful: ``sp["p"]``) and its gathered
        query [B,1,Hp,hd] -> each member's (q_idx [B,Hi,di], w [B,Hi])."""
        from repro_torch.distributed import collectives as col

        sps = [sp["p"] if self.stateful else sp for sp in sps]
        di = sps[0]["wk_idx"].shape[1]
        qis, lgs = [], []
        for sp, q in zip(sps, qs):
            qf = q[:, 0].reshape(q.shape[0], -1)[:, : sp["wq_idx"].shape[0]]
            qis.append(_matmul_promoted(qf, sp["wq_idx"]))
            lgs.append(qf.float() @ sp["w_wgt"])
        qis = col.group_all_gather(qis, -1)
        lgs = col.group_all_gather(lgs, -1)
        return [(qi.reshape(qi.shape[0], -1, di), torch.softmax(lg, dim=-1))
                for qi, lg in zip(qis, lgs)]

    def __call__(self, shards, length):
        """One sequence group. ``shards``: per shard, in sequence order, a
        dict of its q [B,1,Hp,hd], (q_idx, w) ``iq``, cache slices ``kc``
        / ``vc`` [B,S_l,KV,hd] (the new token written), indexer weights
        ``sp`` (stateful: ``{"p", "kidx_sum" [B,n_l,di]}``, this layer's)
        and, on the shard owning the new token, ``k_new`` [B,1,KV,hd];
        ``length`` the context length with it (an int or a 0-d tensor;
        stateless also per row, [B]). -> each shard's (out
        [B,Hp,hd], lse [B,Hp]) fp32 on its device, zero for dead heads
        (stateful: the owner's ``kidx_sum`` page updated in place)."""
        from repro_torch.distributed.topk import (distributed_relevancy_topk,
                                                  page_add_,
                                                  sparse_decode_partials)

        page, cfg = self.page, self.cfg
        devices = [s["kc"].device for s in shards]
        Sl = shards[0]["kc"].shape[1]
        if Sl % page:
            raise ValueError(f"a shard's {Sl} tokens hold no whole number "
                             f"of {page}-token pages")
        n_l = Sl // page
        kp = []
        if self.stateful:
            for i, s in enumerate(shards):
                kx = s["sp"]["kidx_sum"]
                if s.get("k_new") is not None:   # the owner: one page add
                    B = s["k_new"].shape[0]
                    new = _matmul_promoted(s["k_new"].reshape(B, -1),
                                           s["sp"]["p"]["wk_idx"]).float()
                    page_add_(kx, new, (length - 1) // page - i * n_l)
                first = (i * n_l + torch.arange(n_l, device=kx.device)) * page
                counts = (torch.as_tensor(length, device=kx.device)
                          - first).clamp(0, page)
                kp.append(kx * (1.0 / counts.clamp(min=1).float())[None, :,
                                                                   None])
        else:
            kp = [_index_k(s["sp"], s["kc"], page) for s in shards]
        _, pids = distributed_relevancy_topk(
            [s["iq"][0] for s in shards], kp, [s["iq"][1] for s in shards],
            self.n_sel, devices, block=2048, deliver=devices)
        pids = [torch.where(p * page < torch.as_tensor(
            length, device=p.device).reshape(-1, 1), p,
            torch.full_like(p, -1)).to(torch.int32) for p in pids]
        if self.record:
            self.selected.append(pids[0])
        parts = sparse_decode_partials(
            [strip_dead_heads(s["q"], cfg) for s in shards],
            [s["kc"] for s in shards], [s["vc"] for s in shards], pids,
            length, devices, page_size=page)
        return [_repad_partial(o, lse, s["q"]) for (o, lse), s in
                zip(parts, shards)]


def _repad_partial(out, lse, q_like):
    """A shard's (out [B,H,hd], lse [B,H]) over the live heads -> over the
    padded heads Hp of ``q_like`` [B,1,Hp,hd]: dead heads out 0, lse 0."""
    B, _, HP, hd = q_like.shape
    H = out.shape[1]
    if H == HP:
        return out, lse
    return (torch.cat([out, out.new_zeros((B, HP - H, hd))], 1),
            torch.cat([lse, lse.new_zeros((B, HP - H))], 1))


def build_pipeline(cfg: ArchConfig, mem: MemoryConfig, sp: Params, *,
                   page: int = 16, fused: bool = False) -> MemoryPipeline:
    """The four stages over (memory=(kc, vc), query=q [B,1,Hp,hd]), one
    layer's ``sp``. ``fused=False`` scores with the plain op and takes a
    stable top-k (the paper's GPU baseline); ``fused=True`` runs relevancy +
    retrieve in the relevancy kernel (the paper's Fig. 9 comparison)."""
    n_pages_sel = max(mem.top_k // page, 1)

    def prepare(M):
        kc, _ = M
        return _index_k(sp, kc, page)

    def relevancy(kp, q):
        q_idx, w = _index_qw(sp, q[:, 0])
        if fused:
            _, pidx = ops.relevancy_topk(
                q_idx, kp, w, n_pages_sel,
                block=max(min(4096, kp.shape[1]), n_pages_sel))
            return ("fused", pidx)
        return ("scores", ref.relevancy_scores(q_idx, kp, w))

    def retrieve(M, S):
        """The refined memory is (KV, selected page ids)."""
        kc, vc = M
        tag, val = S
        if tag == "fused":
            return (kc, vc, val)
        _, pidx = ref.topk_stable(val, n_pages_sel)
        return (kc, vc, pidx)

    def apply(Mp, q):
        kc, vc, pidx = Mp
        length = torch.full((q.shape[0],), kc.shape[1], dtype=torch.int32,
                            device=kc.device)
        out, _ = ops.paged_decode_attention(q[:, 0], kc, vc,
                                            pidx.to(torch.int32), length,
                                            page_size=page)
        return out

    return MemoryPipeline(
        name="dsa-fused" if fused else "dsa",
        prepare=prepare, relevancy=relevancy, retrieve=retrieve, apply=apply,
        fused={"relevancy": ("relevancy", "retrieve")} if fused else {},
    )
