"""Plain-torch oracles for the ported kernels and the plain ops beside them
(twins of ``repro.kernels.ref``).

All oracles use fp32 math. Top-k breaks ties by ascending index, as the
reference's ``lax.top_k`` and bitonic network do: a stable descending sort
followed by a slice (``torch.topk`` promises no tie order).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, ties by ascending index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


# ---------------------------------------------------------------------------
# 1. Fused relevancy scoring + top-k (DeepSeek lightning-indexer style)
# ---------------------------------------------------------------------------


def relevancy_scores(q: torch.Tensor, keys: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """q [B,Hq,dk]; keys [B,S,dk]; weights [B,Hq] -> scores [B,S].

    score_s = sum_h w_h * relu(q_h . k_s)   (DSA indexer, paper App. D)
    """
    dots = torch.einsum("bhd,bsd->bhs", q.float(), keys.float())
    return torch.einsum("bh,bhs->bs", weights.float(), torch.relu(dots))


def relevancy_topk(q, keys, weights, k: int):
    """Exact oracle: (vals [B,k], idx [B,k]) sorted descending, ``k``
    clamped to the key count."""
    return topk_stable(relevancy_scores(q, keys, weights),
                       min(k, keys.shape[1]))


# ---------------------------------------------------------------------------
# 2. Paged sparse decode attention (apply-to-inference stage)
# ---------------------------------------------------------------------------


def paged_decode_attention(q, k_cache, v_cache, page_ids, page_size: int,
                           length):
    """Attention of one query over the selected pages.

    q [B,Hq,dh]; k/v [B,S,KV,dh]; page_ids [B,P] (-1 = hole); length [] or
    [B] -> (out [B,Hq,dh] fp32, lse [B,Hq] fp32). A -1 page reads page 0 and
    is masked, so a row with no valid token averages v over page 0 (every
    masked score is -1e30 and the softmax is uniform), as the reference does.
    """
    B, S, KV, dh = k_cache.shape
    Hq = q.shape[1]
    G = Hq // KV
    P = page_ids.shape[1]
    ps = page_size
    safe = page_ids.clamp(min=0).long()
    rows = torch.arange(B, device=q.device)[:, None]
    kg = k_cache.reshape(B, S // ps, ps, KV, dh)[rows, safe]  # [B,P,ps,KV,dh]
    vg = v_cache.reshape(B, S // ps, ps, KV, dh)[rows, safe]
    qg = q.reshape(B, KV, G, dh).float() / math.sqrt(dh)
    sc = torch.einsum("bkgd,bptkd->bkgpt", qg, kg.float())
    tok_pos = safe[:, :, None] * ps + torch.arange(ps, device=q.device)
    lb = torch.as_tensor(length, device=q.device).reshape(-1).expand(B)
    valid = (page_ids[:, :, None] >= 0) & (tok_pos < lb[:, None, None])
    sc = torch.where(valid[:, None, None], sc, torch.full_like(sc, NEG_INF))
    sc = sc.reshape(B, KV, G, P * ps)
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(-1)
    out = torch.einsum("bkgn,bnkd->bkgd", p,
                       vg.reshape(B, P * ps, KV, dh).float())
    out = out / l[..., None]
    lse = m + torch.log(l)
    return out.reshape(B, Hq, dh), lse.reshape(B, Hq)


# ---------------------------------------------------------------------------
# 3. LServe page-wise min/max pooling (prepare-memory stage) and its bound
# ---------------------------------------------------------------------------


def page_minmax(k_cache: torch.Tensor, page_size: int):
    """[B, S, KV, dh] -> (min, max) [B, S/ps, KV, dh] fp32."""
    B, S, KV, dh = k_cache.shape
    kp = k_cache.reshape(B, S // page_size, page_size, KV, dh).float()
    return kp.amin(dim=2), kp.amax(dim=2)


def lserve_page_scores(q: torch.Tensor, pmin: torch.Tensor,
                       pmax: torch.Tensor) -> torch.Tensor:
    """LServe relevancy: per page, sum over channels of max(q*min, q*max).

    q [B,Hq,dh]; pmin/pmax [B,P,KV,dh] -> scores [B, P]: the max over kv
    heads, then the mean over all Hq query heads passed in.
    """
    qf = q.float()[:, :, None, None, :]                  # [B,H,1,1,dh]
    prod_min = qf * pmin.float()[:, None]                # [B,H,P,KV,dh]
    prod_max = qf * pmax.float()[:, None]
    sc = torch.maximum(prod_min, prod_max).sum(-1)       # [B,H,P,KV]
    return sc.amax(-1).mean(1)


# ---------------------------------------------------------------------------
# 4. BM25 scoring + top-k (RAG relevancy + retrieval)
# ---------------------------------------------------------------------------


def bm25_scores(tf: torch.Tensor, doc_len: torch.Tensor, idf: torch.Tensor,
                *, k1: float = 1.5, b: float = 0.75, avgdl: float = 100.0):
    """tf [B, D, T] term counts; doc_len [B, D]; idf [B, T] -> scores [B, D]
    fp32."""
    tff = tf.float()
    denom = tff + k1 * (1.0 - b + b * doc_len.float()[..., None] / avgdl)
    return torch.einsum("bt,bdt->bd", idf.float(), tff * (k1 + 1.0) / denom)


def bm25_topk(tf, doc_len, idf, k: int, **kw):
    """Exact oracle: (vals [B,k], idx [B,k]), k clamped to D."""
    scores = bm25_scores(tf, doc_len, idf, **kw)
    return topk_stable(scores, min(k, scores.shape[-1]))


# ---------------------------------------------------------------------------
# 5. Causal flash attention (train / prefill)
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window=None) -> torch.Tensor:
    """q [B,S,H,dh]; k/v [B,S,KV,dh] -> [B,S,H,dh] in q's dtype: one exact
    fp32 softmax over the [S, S] scores, masked causally (and to the last
    ``window`` keys when given); query head h reads kv head h // (H // KV)."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    kexp = k.repeat_interleave(G, dim=2).float()
    vexp = v.repeat_interleave(G, dim=2).float()
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float() / math.sqrt(dh), kexp)
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    p = torch.softmax(sc.masked_fill(~mask[None, None], NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vexp).to(q.dtype)
