"""Memory-as-Context, Titans / HMT (twin of ``repro.core.methods.mac``),
paper Table 1 row 8.

  prepare   a latent memory embedding per segment (Titans-style linear
            projection of the segment's mean representation)
  relevancy linear projection of the current segment to a query + inner
            product with the memory bank
  retrieve  top-k memory embeddings, or a softmax-weighted sum
  apply     prepend the retrieved embeddings to the segment

Paper Fig. 6c data placement: the memory bank lives with the retrieval
engine and only retrieved embeddings move. Top-k breaks ties by ascending
index (``ref.topk_stable``), as the reference's ``lax.top_k`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline import MemoryPipeline
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L

Params = Dict

# Hetero offload metadata (paper Fig. 6c): the memory bank lives with the
# retrieval engine; only retrieved embeddings move to the generator.
OFFLOAD_STAGES = ("prepare", "relevancy", "retrieve")


@dataclasses.dataclass
class MacConfig:
    segment_len: int = 1024   # paper Appendix D
    memory_slots: int = 64    # bank capacity (FIFO)
    retrieve_k: int = 8
    mode: str = "topk"        # topk | weighted (Titans weighted-sum variant)


def mac_init(cfg: ArchConfig, seed: int = 0, *, device="cuda") -> Params:
    """Seeded fp32 query and memory projections [d, d], scale 1/sqrt(d),
    drawn from one ``torch.Generator`` (w_query first); the draws differ
    from ``jax.random``'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = cfg.d_model
    return {"w_query": L.dense_init(gen, d, d, torch.float32),
            "w_mem": L.dense_init(gen, d, d, torch.float32)}


def bank_init(cfg: ArchConfig, mc: MacConfig, batch: int, *, device="cuda"):
    dev = resolve_device(device)
    return {"bank": torch.zeros((batch, mc.memory_slots, cfg.d_model),
                                dtype=torch.float32, device=dev),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def prepare_memory(mp: Params, segment_hidden: torch.Tensor) -> torch.Tensor:
    """Segment hidden states [B, S, d] -> memory embedding [B, d]."""
    return segment_hidden.float().mean(dim=1) @ mp["w_mem"]


def compute_relevancy(mp: Params, segment_embeds: torch.Tensor,
                      bank: torch.Tensor) -> torch.Tensor:
    """Query generation (a fusable linear projection, paper §4) + inner
    product with the bank -> [B, M]."""
    q = segment_embeds.float().mean(dim=1) @ mp["w_query"]
    return torch.einsum("bd,bmd->bm", q, bank)


def retrieve(bank: torch.Tensor, scores: torch.Tensor, count,
             mc: MacConfig) -> torch.Tensor:
    """-> retrieved embeddings [B, r, d] (only these cross devices)."""
    B, M, d = bank.shape
    live = torch.arange(M, device=bank.device)[None] < count
    masked = torch.where(live, scores, torch.full_like(scores, -1e30))
    if mc.mode == "weighted":
        w = torch.softmax(masked, dim=-1)
        out = torch.einsum("bm,bmd->bd", w, bank)[:, None]
        return out.expand(B, mc.retrieve_k, d)
    _, idx = kref.topk_stable(masked, mc.retrieve_k)
    return torch.gather(bank, 1, idx.long()[..., None].expand(-1, -1, d))


def push(bank_state: Dict, new_mem: torch.Tensor) -> Dict:
    """FIFO append of the new segment memory."""
    bank = torch.roll(bank_state["bank"], -1, dims=1).clone()
    bank[:, -1] = new_mem
    return {"bank": bank,
            "count": torch.clamp(bank_state["count"] + 1,
                                 max=bank_state["bank"].shape[1])}


def segment_step(mp: Params, bank_state: Dict, segment_embeds: torch.Tensor,
                 mc: MacConfig) -> Tuple[torch.Tensor, Dict]:
    """Full pipeline for one segment: segment_embeds [B, S, d] -> (context
    [B, r+S, d], bank state). The caller runs the backbone on the context,
    then ``prepare_memory`` + ``push`` with the resulting hidden states."""
    scores = compute_relevancy(mp, segment_embeds, bank_state["bank"])
    got = retrieve(bank_state["bank"], scores, bank_state["count"], mc)
    context = torch.cat([got.to(segment_embeds.dtype), segment_embeds], dim=1)
    return context, bank_state


def build_pipeline(mp: Params, mc: MacConfig) -> MemoryPipeline:
    """Stage descriptor over M = (segment_hidden, bank_state), x = segment
    embeddings. Relevancy scores the bank once and retrieve consumes the
    scores, so the stage profiler attributes score time to relevancy and
    only the gather to retrieve."""

    def prepare(M):
        hidden, bank_state = M
        return (prepare_memory(mp, hidden), bank_state)

    def relevancy(I, seg):
        _, bank_state = I
        return compute_relevancy(mp, seg, bank_state["bank"])

    def retrieve_stage(M, S):
        _, bank_state = M
        return retrieve(bank_state["bank"], S, bank_state["count"], mc)

    def apply(got, seg):
        return torch.cat([got.to(seg.dtype), seg], dim=1)

    return MemoryPipeline(name="mac", prepare=prepare, relevancy=relevancy,
                          retrieve=retrieve_stage, apply=apply)
