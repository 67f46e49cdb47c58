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
    (``launch.mesh``): distributed top-k with an index-only exchange, then
    per-shard paged attention with the LSE merge (``distributed.topk``)."""
    from repro_torch.distributed.topk import (distributed_relevancy_topk,
                                              distributed_sparse_decode)

    n_pages_sel = max(mem.top_k // page, 1)

    def sparse_fn(q, kc, vc, length, sp, k_new=None):
        B = q.shape[0]
        q_idx, w = _index_qw(sp, q[:, 0])
        kp = _index_k(sp, kc, page)
        _, pidx = distributed_relevancy_topk(q_idx, kp, w, n_pages_sel,
                                             devices, block=2048)
        lb = torch.as_tensor(length, dtype=torch.int32,
                             device=q.device).reshape(-1).expand(B)
        pidx = torch.where(pidx * page < lb[:, None], pidx,
                           torch.full_like(pidx, -1)).to(torch.int32)
        out = distributed_sparse_decode(strip_dead_heads(q, cfg), kc, vc,
                                        pidx, lb, devices, page_size=page)
        return repad_dead_heads(out, q, cfg)

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
    the owning shard's page (``sharded_page_add``), scores the pooled index
    and runs the distributed top-k and LSE-merged paged attention. ``length``
    is the step's context length (an int or a 0-d tensor). Returns (out,
    sp with ``kidx_sum`` as per-shard tensors)."""
    from repro_torch.distributed.topk import (_shards,
                                              distributed_relevancy_topk,
                                              distributed_sparse_decode,
                                              sharded_page_add)

    n_pages_sel = max(mem.top_k // page, 1)

    def sparse_fn(q, kc, vc, length, sp, k_new=None):
        B = q.shape[0]
        p = sp["p"]
        # prepare, incremental: index the ONE key written this step; the
        # page update stays on the shard that owns the page
        k_idx_new = _matmul_promoted(k_new.reshape(B, -1),
                                     p["wk_idx"]).float()
        kidx_sum = sharded_page_add(sp["kidx_sum"], k_idx_new,
                                    (length - 1) // page, devices)
        q_idx, w = _index_qw(p, q[:, 0])
        # page means over each shard's own pages (its token counts)
        local_np = kidx_sum[0].shape[1]
        kp = []
        for s, kx in enumerate(_shards(kidx_sum, len(devices))):
            first = (s * local_np + torch.arange(local_np,
                                                 device=kx.device)) * page
            counts = (torch.as_tensor(length, device=kx.device)
                      - first).clamp(0, page)
            kp.append(kx * (1.0 / counts.clamp(min=1).float())[None, :,
                                                               None])
        _, pidx = distributed_relevancy_topk(q_idx, kp, w, n_pages_sel,
                                             devices, block=2048)
        pidx = torch.where(pidx * page < torch.as_tensor(
            length, device=pidx.device), pidx, torch.full_like(pidx, -1))
        lb = torch.as_tensor(length, dtype=torch.int32,
                             device=q.device).reshape(-1).expand(B)
        out = distributed_sparse_decode(strip_dead_heads(q, cfg), kc, vc,
                                        pidx.to(torch.int32), lb, devices,
                                        page_size=page)
        return repad_dead_heads(out, q, cfg), dict(sp, kidx_sum=kidx_sum)

    return sparse_fn


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
