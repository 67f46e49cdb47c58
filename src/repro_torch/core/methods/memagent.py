"""MemAgent, synthesized textual memory (twin of
``repro.core.methods.memagent``), paper Table 1 row 7.

  prepare   model decoding: generate a textual memory of ``mem_len`` tokens
            conditioned on (previous memory, current segment)
  relevancy N/A (bypassed; always uses the preceding segment's memory)
  retrieve  nearest (previous) memory: a copy, no math
  apply     model prefilling: consume [memory; next segment]

Prefill/decode disaggregation (paper Fig. 6b): ``prefill_fn`` and
``decode_fn`` are injected, so a server can place them on different device
roles (``launch.mesh.split_mesh_roles``; ``role_fns`` builds the pair from
the model's ``prefill`` / ``decode_step``). On the card the prefill's
attention is the flash kernel; decode is the unpaged dense ``decode_step``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline import (MemoryPipeline,
                                       block_until_ready)
from repro_torch.models import model as M

# Hetero offload metadata: both active stages ARE model passes (decode /
# prefill); nothing leaves the compute engine.
OFFLOAD_STAGES = ()


@dataclasses.dataclass
class MemAgentConfig:
    segment_len: int = 5000   # paper Appendix D
    mem_len: int = 1024
    max_answer: int = 32


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The first maximal index (``jnp.argmax``'s tie rule) as int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def run_memagent(params, cfg: ArchConfig, doc_tokens: torch.Tensor,
                 question: torch.Tensor, ma: MemAgentConfig, *,
                 prefill_fn: Callable, decode_fn: Callable, profiler=None):
    """Segment loop -> answer tokens [B, max_answer] int32.

    doc_tokens [B, n_seg * segment_len], question [B, q_len];
    ``prefill_fn(params, tokens, max_len) -> (logits, caches)`` and
    ``decode_fn(params, token, caches) -> (logits, caches)``. The first
    memory is ``mem_len`` zero tokens. Each segment prefills [memory;
    segment] into a cache of ``ctx + mem_len`` and decodes ``mem_len``
    tokens (the last call's token is dropped, so the cache fills exactly);
    the answer prefills [memory; question] and decodes ``max_answer - 1``
    more. ``profiler`` records ("prepare",) per segment and ("apply",) for
    the answer's prefill, each once the device has finished."""
    B, total = doc_tokens.shape
    n_seg = total // ma.segment_len
    memory = torch.zeros((B, ma.mem_len), dtype=torch.int32,
                         device=doc_tokens.device)

    def synthesize(memory, segment):
        """prepare-memory: decode mem_len tokens from [memory; segment]."""
        ctx = torch.cat([memory, segment.to(torch.int32)], dim=1)
        logits, caches = prefill_fn(params, ctx, ctx.shape[1] + ma.mem_len)
        tok = _greedy(logits)
        out = []
        for _ in range(ma.mem_len):
            out.append(tok)
            logits, caches = decode_fn(params, tok, caches)
            tok = _greedy(logits)
        return torch.stack(out, dim=1)

    for s in range(n_seg):
        seg = doc_tokens[:, s * ma.segment_len:(s + 1) * ma.segment_len]
        t0 = time.perf_counter()
        memory = block_until_ready(synthesize(memory, seg))
        if profiler:  # decoding-to-memory == prepare (paper App. B)
            profiler.record("memagent", ("prepare",),
                            time.perf_counter() - t0)

    ctx = torch.cat([memory, question.to(torch.int32)], dim=1)
    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, ctx, ctx.shape[1] + ma.max_answer)
    if profiler:
        block_until_ready(logits)
        profiler.record("memagent", ("apply",), time.perf_counter() - t0)
    tok = _greedy(logits)
    answer = [tok]
    for _ in range(ma.max_answer - 1):
        logits, caches = decode_fn(params, tok, caches)
        tok = _greedy(logits)
        answer.append(tok)
    return torch.stack(answer, dim=1)


def role_fns(params, cfg: ArchConfig, prefill_device, decode_device, *,
             tp: int = 16):
    """(params, prefill_fn, decode_fn) over the model's ``prefill`` and
    ``decode_step``: prefills run on ``prefill_device``, decodes on
    ``decode_device`` (a role of ``split_mesh_roles`` each). The caches
    move to the decode role after the prefill; when the roles differ, the
    weights are copied there once. On one device nothing moves."""
    pre, dec = torch.device(prefill_device), torch.device(decode_device)
    pre_w = _to(params, pre)
    dec_w = pre_w if dec == pre else _to(params, dec)

    def prefill_fn(_, tokens, max_len):
        logits, caches = M.prefill(pre_w, cfg, tokens.to(pre),
                                   max_len=max_len, tp=tp)
        return logits, _to(caches, dec)

    def decode_fn(_, token, caches):
        return M.decode_step(dec_w, cfg, token.to(dec), caches, tp=tp)

    return pre_w, prefill_fn, decode_fn


def _to(tree, device):
    """A nest of dicts of tensors on ``device`` (tensors already there are
    kept, not copied)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def build_pipeline(synthesize_fn, prefill_fn) -> MemoryPipeline:
    """The stage descriptor, with the reference's data flow: relevancy is
    bypassed, so ``run``'s selection stays the raw memory M and apply
    prefills on it, not on the memory ``prepare`` synthesized
    (``run_memagent``'s own loop carries the new memory)."""
    return MemoryPipeline(
        name="memagent",
        prepare=lambda M_: synthesize_fn(M_),   # model decoding
        relevancy=None,                          # bypassed (paper §3.1)
        retrieve=lambda M_, S: S,                # nearest = previous memory
        apply=lambda Mp, x: prefill_fn(Mp, x),
    )
