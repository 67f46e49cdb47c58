"""SeerAttention-R (twin of ``repro.core.methods.seer``), paper Table 1 row 2.

  prepare   linear down-projection of the query, keys projected and
            mean-pooled over blocks of ``block_size`` (64)
  relevancy inner product of the gated query with each pooled block key
  retrieve  top-k blocks (token budget 4096), or threshold mode: the blocks
            whose softmax over the selected candidates' scores is >=
            ``threshold`` (5e-4), the rest set to -1
  apply     block-sparse attention over the selected blocks

Relevancy + retrieve run in the relevancy kernel with one query head and
unit weight; apply in the paged decode attention kernel with ``block_size``
pages. Like the reference, the gate multiplies the whole padded query
``[B, Hp*hd]`` by ``wq_gate [n_heads*hd, di]``: with dead TP heads
(``padded_heads(tp) != n_heads``) the product raises, on both sides.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, MemoryConfig
from repro_torch.core.methods.dsa import (_matmul_promoted, _repad_partial,
                                          repad_dead_heads, strip_dead_heads)
from repro_torch.core.pipeline import MemoryPipeline
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

Params = Dict

# Gate pooling and block scoring touch only the pooled gate keys; the
# block-sparse apply stays with the KV pool.
OFFLOAD_STAGES = ("prepare", "relevancy", "retrieve")


def seer_init(cfg: ArchConfig, mem: MemoryConfig, seed: int = 0, *,
              stacked: bool = True, device="cuda") -> Params:
    """Per-layer gate weights, stacked [L, ...], both bf16 as in the
    reference."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    hd = cfg.hd
    lead = (cfg.n_layers if stacked else 1,)
    p = {
        "wq_gate": L.dense_init(gen, cfg.n_heads * hd, mem.index_dim,
                                torch.bfloat16, lead=lead),
        "wk_gate": L.dense_init(gen, cfg.n_kv_heads * hd, mem.index_dim,
                                torch.bfloat16, lead=lead),
    }
    return p if stacked else {k: v[0] for k, v in p.items()}


def _gate_k(sp: Params, kc: torch.Tensor, bs: int):
    """prepare: kc [B,S,KV,hd] -> gated keys mean-pooled per block
    [B, S/bs, di]."""
    B, S = kc.shape[:2]
    k_gate = _matmul_promoted(kc.reshape(B, S, -1), sp["wk_gate"])
    return k_gate.reshape(B, S // bs, bs, -1).mean(dim=2)


def _gate_q(sp: Params, q: torch.Tensor):
    """q [B,1,Hp,hd] -> (gated query [B,1,di], unit weight [B,1] fp32)."""
    B = q.shape[0]
    q_gate = _matmul_promoted(q[:, 0].reshape(B, -1), sp["wq_gate"])
    return q_gate[:, None, :], torch.ones((B, 1), dtype=torch.float32,
                                          device=q.device)


def make_sparse_fn(cfg: ArchConfig, mem: MemoryConfig, *, tp: int = 16):
    """Returns sparse_fn(q, kc, vc, length, sp, k_new=None) for
    ``model.decode_step_paged`` / ``model.decode_step``."""
    bs = mem.block_size
    n_sel = max(mem.token_budget // bs, 1)

    def sparse_fn(q, kc, vc, length, sp, k_new=None):
        B, S = q.shape[0], kc.shape[1]
        # --- prepare: pooled block keys + gated query ---
        k_blk = _gate_k(sp, kc, bs)
        q_gate, w = _gate_q(sp, q)
        # --- fused relevancy + retrieve (kernel); every block is scored,
        # the ones past the live length are dropped below ---
        vals, bidx = ops.relevancy_topk(q_gate, k_blk, w, n_sel,
                                        block=max(min(4096, S // bs), n_sel))
        lb = torch.as_tensor(length, dtype=torch.int32,
                             device=q.device).reshape(-1).expand(B)
        live = bidx * bs < lb[:, None]
        if mem.selection == "threshold":
            # normalize over the selected candidates, drop those < tau
            live &= torch.softmax(vals, dim=-1) >= mem.threshold
        bidx = torch.where(live, bidx, torch.full_like(bidx, -1))
        # --- apply: block-sparse attention over the selected blocks ---
        out, _ = ops.paged_decode_attention(strip_dead_heads(q, cfg), kc, vc,
                                            bidx.to(torch.int32), lb,
                                            page_size=bs)
        return repad_dead_heads(out, q, cfg)

    return sparse_fn


class SplitSeer:
    """Seer over a sequence-split cache, for ``models.model.decode_step_tp``
    (``make_sparse_fn`` as GSPMD partitions it over ``cache_specs``), with
    ``dsa.SplitDSA``'s protocol. The gate weights are replicated
    (``method_specs``); no KV page, pooled key or raw score crosses.

      prepare    the query side per member from its gathered q
                 (``index_query``: ``_gate_q``, nothing exchanged); the key
                 side per shard, its own slice's gated keys pooled per
                 ``block_size`` block (``_gate_k``);
      relevancy  + retrieve: ``ops.relevancy_topk`` per shard (one head,
                 unit weight), the (value, index) candidates merged on the
                 sequence group's first device (``topk.merge_shard_topk``:
                 ReLU ties at 0 go to the lower global block, as one
                 device's kernel orders them). There, as one device does
                 after its top-k, blocks from ``length`` on are dropped
                 and, in threshold mode, those whose softmax over the
                 merged values (the -inf padding included) is below
                 ``threshold``; then the block ids go to every shard;
      apply      ``ops.paged_decode_attention`` per shard over the selected
                 blocks it owns -> (out, lse) per shard.

    ``record=True`` keeps each call's block ids (``selected``). As on one
    device, a query with dead TP heads does not multiply ``wq_gate``: it
    raises."""

    stateful = False

    def __init__(self, cfg: ArchConfig, mem: MemoryConfig, *,
                 record: bool = False):
        self.cfg, self.mem, self.record = cfg, mem, record
        self.page = mem.block_size
        self.n_sel = max(mem.token_budget // self.page, 1)
        self.selected = []

    def index_query(self, sps, qs):
        """One model group: each member's gate weights and its gathered
        query [B,1,Hp,hd] -> each member's (gated query [B,1,di], unit
        weight [B,1])."""
        return [_gate_q(sp, q) for sp, q in zip(sps, qs)]

    def __call__(self, shards, length):
        """One sequence group, as ``SplitDSA.__call__`` (``iq`` each
        shard's ``index_query`` pair, ``sp`` its gate weights) -> each
        shard's (out [B,Hp,hd], lse [B,Hp]) fp32 on its device."""
        from repro_torch.distributed import topk

        bs, mem = self.page, self.mem
        devices = [s["kc"].device for s in shards]
        Sl = shards[0]["kc"].shape[1]
        if Sl % bs:
            raise ValueError(f"a shard's {Sl} tokens hold no whole number "
                             f"of {bs}-token blocks")
        k_blk = [_gate_k(s["sp"], s["kc"], bs) for s in shards]

        def keep(vals, bidx):
            lb = torch.as_tensor(length, device=bidx.device).reshape(-1, 1)
            live = bidx * bs < lb
            if mem.selection == "threshold":
                live &= torch.softmax(vals, dim=-1) >= mem.threshold
            return torch.where(live, bidx, torch.full_like(bidx, -1)).to(
                torch.int32)

        _, bids = topk.distributed_relevancy_topk(
            [s["iq"][0] for s in shards], k_blk, [s["iq"][1] for s in shards],
            self.n_sel, devices, block=4096, deliver=devices, keep=keep)
        if self.record:
            self.selected.append(bids[0])
        parts = topk.sparse_decode_partials(
            [strip_dead_heads(s["q"], self.cfg) for s in shards],
            [s["kc"] for s in shards], [s["vc"] for s in shards], bids,
            length, devices, page_size=bs)
        return [_repad_partial(o, lse, s["q"]) for (o, lse), s in
                zip(parts, shards)]


def build_pipeline(cfg: ArchConfig, mem: MemoryConfig, sp: Params, *,
                   fused: bool = False) -> MemoryPipeline:
    """The four stages over (memory=(kc, vc), query=q [B,1,Hp,hd]), one
    layer's ``sp``; ``fused=True`` runs relevancy + retrieve in the
    relevancy kernel."""
    bs = mem.block_size
    n_sel = max(mem.token_budget // bs, 1)

    def prepare(M):
        kc, _ = M
        return _gate_k(sp, kc, bs)

    def relevancy(k_blk, q):
        qg, w = _gate_q(sp, q)
        if fused:
            _, bidx = ops.relevancy_topk(
                qg, k_blk, w, n_sel, block=max(min(4096, k_blk.shape[1]),
                                               n_sel))
            return ("fused", bidx)
        return ("scores", ref.relevancy_scores(qg, k_blk, w))

    def retrieve(M, S):
        kc, vc = M
        tag, val = S
        if tag == "fused":
            return (kc, vc, val)
        _, bidx = ref.topk_stable(val, n_sel)
        return (kc, vc, bidx)

    def apply(Mp, q):
        kc, vc, bidx = Mp
        length = torch.full((q.shape[0],), kc.shape[1], dtype=torch.int32,
                            device=kc.device)
        out, _ = ops.paged_decode_attention(q[:, 0], kc, vc,
                                            bidx.to(torch.int32), length,
                                            page_size=bs)
        return out

    return MemoryPipeline(
        name="seer-fused" if fused else "seer",
        prepare=prepare, relevancy=relevancy, retrieve=retrieve, apply=apply,
        fused={"relevancy": ("relevancy", "retrieve")} if fused else {},
    )
