"""Sequence-parallel relevancy top-k and sparse decode over a device tuple
(twin of ``repro.distributed.topk``).

The paper's link principle, "transfer only the top-k indices" (§5.2): each
shard runs the relevancy kernel over ITS slice of the compressed keys and
sends back only (value, index) pairs, 8 bytes a candidate, which the first
device merges (``merge_shard_topk``: one merge for the split's DSA, Seer
and LServe, whose candidates are block or physical page scores); the
apply runs the paged attention kernel per shard over its slice of the
view and sends back only (out, lse) pairs, merged by ``ops.lse_merge``.
Raw scores (O(S)) and KV pages never cross.

``devices`` is a mesh (``launch.mesh.mesh_from_devices``): one shard per
entry, in order, the sequence axis cut into equal contiguous slices, the
results merged on ``devices[0]``. An entry may repeat a device: the shards
then run there one after another (one card runs 2 or 4 shards that way).
Each shard body calls ``ops.relevancy_topk`` / ``ops.paged_decode_attention``:
the kernels on the card, their plain versions on the CPU.

A sharded input is either one tensor, cut here (each shard's slice copied
to its device), or a list of per-shard tensors already resident. The
decode split (``models.model.decode_step_tp``) passes resident lists
throughout: its queries per shard, each shard's own cache slice and index
keys; it has the selected page ids delivered to every shard
(``deliver``), and the (out, lse) pairs of ``sparse_decode_partials``
merged for each member that applies ``wo``, on its head slice
(``merge_partials``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_stable
from repro_torch.launch.op_walk import collective


def _shards(x, n: int, axis: int = 1) -> List[torch.Tensor]:
    """``x`` as ``n`` contiguous slices along ``axis`` (a list of per-shard
    tensors passes through)."""
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError(f"{len(x)} shards for a mesh of {n}")
        return list(x)
    S = x.shape[axis]
    assert S % n == 0, (S, n)
    local = S // n
    return [x.narrow(axis, s * local, local) for s in range(n)]


def _per_shard(x, n: int) -> List:
    """A per-shard list as it is, or one tensor for every shard."""
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError(f"{len(x)} shards for a mesh of {n}")
        return list(x)
    return [x] * n


def gather_shards(parts, device=None, axis: int = 1) -> torch.Tensor:
    """Per-shard tensors -> one tensor on ``device`` (default: the first
    shard's)."""
    device = device or parts[0].device
    return torch.cat([p.to(device) for p in parts], dim=axis)


def merge_shard_topk(shard_topk, n_local: int, k: int,
                     devices: Sequence[torch.device], *, deliver=None,
                     keep=None):
    """One merge of the shards' candidates into the exact global top-k,
    shared by the split's methods (DSA's and Seer's relevancy kernel,
    LServe's physical page scores). ``shard_topk(s, k_local)`` -> shard
    s's own exact top-``k_local`` (vals [B, k_local], LOCAL idx), sorted
    descending with ties by ascending index, on its device; every shard
    holds ``n_local`` scored items, and ``k_local = min(k, n_local)``.

    Only the (value, index) pairs cross, onto ``devices[0]``: each offset
    to global indices, concatenated in shard order, so a stable sort by
    descending value breaks ties by ascending global index, as one
    device's top-k does (never ``torch.topk``). Past ``n_shards *
    k_local`` candidates the result is padded with (-inf, -1). ``keep(vals,
    idx) -> idx`` runs on ``devices[0]`` before the ids leave it (Seer's
    threshold over the merged values, LServe's count). Returns (vals [B,
    k], idx) on ``devices[0]``; with ``deliver`` (a list of devices) (vals,
    [idx on each of them])."""
    n = len(devices)
    main = devices[0]
    k_local = min(k, n_local)
    vals, idx = [], []
    for s in range(n):
        v, i = shard_topk(s, k_local)
        with collective("all-gather"):          # (value, index) pairs only
            vals.append(v.to(main))
            idx.append((i + s * n_local).to(main))
    top_v, pos = topk_stable(torch.cat(vals, dim=1), min(k, n * k_local))
    top_i = torch.gather(torch.cat(idx, dim=1), 1, pos.long())
    if top_v.shape[1] < k:           # cannot select more than exist
        pad = k - top_v.shape[1]
        top_v = torch.cat([top_v, top_v.new_full((top_v.shape[0], pad),
                                                 float("-inf"))], dim=1)
        top_i = torch.cat([top_i, top_i.new_full((top_i.shape[0], pad),
                                                 -1)], dim=1)
    if keep is not None:
        top_i = keep(top_v, top_i)
    if deliver is None:
        return top_v, top_i
    with collective("collective-permute"):      # the ids, to each
        return top_v, [top_i.to(d) for d in deliver]


def distributed_relevancy_topk(q, keys, weights, k: int,
                               devices: Sequence[torch.device], *,
                               block: int = 2048, deliver=None, keep=None):
    """Exact global top-k with an index-only exchange. q [B, Hq, dk];
    keys [B, S, dk] sharded on S; weights [B, Hq] (q and weights may also
    be per-shard lists, resident). Each shard runs ``ops.relevancy_topk``
    over its slice; ``merge_shard_topk`` merges (and, with ``keep`` and
    ``deliver``, filters and delivers) the candidates. Returns (vals,
    idx) [B, k] in GLOBAL sequence coordinates on ``devices[0]``, padded
    with (-inf, -1) past ``n_shards * min(k, S / n_shards)`` candidates;
    with ``deliver`` (vals, [idx on each of those devices])."""
    n = len(devices)
    parts = _shards(keys, n)
    qs, ws = _per_shard(q, n), _per_shard(weights, n)

    def shard_topk(s, k_local):
        dev = devices[s]
        return ops.relevancy_topk(qs[s].to(dev), parts[s].to(dev),
                                  ws[s].to(dev), k_local, block=block)

    return merge_shard_topk(shard_topk, parts[0].shape[1], k, devices,
                            deliver=deliver, keep=keep)


def page_add_(kx, delta, lpg) -> torch.Tensor:
    """In place: add ``delta`` [B, di] into local page ``lpg`` (an int or a
    0-d tensor) of one shard's index cache ``kx`` [B, n_l, di]; nothing
    where the page lies outside the shard (the reference's masked local
    update). Returns ``kx``."""
    n_l = kx.shape[1]
    lpg = torch.as_tensor(lpg, device=kx.device).reshape(1).long()
    ok = ((lpg >= 0) & (lpg < n_l)).to(torch.float32)
    return kx.index_add_(1, lpg.clamp(0, n_l - 1),
                         (ok * delta.to(kx.device))[:, None].to(kx.dtype))


def sharded_page_add(kidx, delta, pg, devices: Sequence[torch.device]
                     ) -> List[torch.Tensor]:
    """Add ``delta`` [B, di] into page ``pg`` (an int or a 0-d tensor) of
    the page-sharded index cache ``kidx`` [B, n_pages, di] without
    gathering it: every shard runs ``page_add_`` on a copy of its slice,
    and only the one owning the page changes. Returns the per-shard
    tensors (new tensors; the inputs stay as they were)."""
    parts = _shards(kidx, len(devices))
    local_np = parts[0].shape[1]
    return [page_add_(kx.to(dev, copy=True), delta, pg - s * local_np)
            for s, (dev, kx) in enumerate(zip(devices, parts))]


def distributed_sparse_decode(q, k_cache, v_cache, page_ids, length,
                              devices: Sequence[torch.device], *,
                              page_size: int = 64):
    """Sequence-parallel sparse decode, the dense per-request contract:
    ``distributed_paged_sparse_decode`` (ONE shard body) with its lse
    dropped."""
    out, _ = distributed_paged_sparse_decode(
        q, k_cache, v_cache, page_ids, length, devices, page_size=page_size)
    return out


def distributed_paged_sparse_decode(q, k_cache, v_cache, page_ids, lengths,
                                    devices: Sequence[torch.device], *,
                                    page_size: int = 64):
    """The LSE-merged sequence-parallel apply over the paged-pool view
    (paper Fig. 6a). q [B, Hq, dh]; k_cache / v_cache [B, S, KV, dh] (the
    gathered view, zero outside each slot's live region), sharded on S;
    page_ids [B, P] GLOBAL logical page ids, -1 anywhere; lengths [B] (or a
    scalar) per-slot live lengths, each shard clipping them to its window.

    Each shard attends to the selected pages it owns over its own slice of
    the view (``.contiguous()`` in the kernel's wrapper copies a slice of a
    view with B > 1); only (out, lse) pairs come back. Returns (out
    [B, Hq, dh], lse [B, Hq]) on ``devices[0]``, ``ops.paged_decode_
    attention``'s contract, so it drops into ``models.decode_step_paged_
    presel``'s ``page_attn`` seam.

    The merge is the reference's ``lse_merge``: a slot with no valid token
    in any shard gets the equal-weight mean of each shard's degenerate
    output (the mean of v over the first page of its slice), not the
    unsharded kernel's; the engine always selects the current page, so
    serving never meets that case."""
    parts = sparse_decode_partials(q, k_cache, v_cache, page_ids, lengths,
                                   devices, page_size=page_size)
    return merge_partials(parts, [(devices[0], slice(None))])[0]


def sparse_decode_partials(q, k_cache, v_cache, page_ids, lengths,
                           devices: Sequence[torch.device], *,
                           page_size: int = 64) -> List[Tuple]:
    """The ONE shard body of the sequence-parallel apply: each shard's
    (out [B, Hq, dh], lse [B, Hq]) fp32 on its device, over the selected
    pages it owns. q and page_ids may be per-shard lists (resident); the
    caches one tensor sharded on S or per-shard slices."""
    n = len(devices)
    ks, vs = _shards(k_cache, n), _shards(v_cache, n)
    local_S = ks[0].shape[1]
    assert local_S % page_size == 0, (local_S, n, page_size)
    local_pages = local_S // page_size
    qs, pids_s = _per_shard(q, n), _per_shard(page_ids, n)
    B = qs[0].shape[0]
    out = []
    for s, dev in enumerate(devices):
        pids = pids_s[s].to(dev)
        local = pids - s * local_pages
        mine = (pids >= 0) & (local >= 0) & (local < local_pages)
        local = torch.where(mine, local, torch.full_like(local, -1))
        len_g = torch.as_tensor(lengths, device=dev).reshape(-1).expand(B)
        len_l = (len_g - s * local_S).clamp(0, local_S).to(torch.int32)
        out.append(ops.paged_decode_attention(
            qs[s].to(dev), ks[s].to(dev), vs[s].to(dev),
            local.to(torch.int32), len_l, page_size=page_size))
    return out


def merge_partials(parts, targets) -> List[Tuple]:
    """Per target ``(device, head slice)``: every shard's (out, lse) on
    those heads, brought to the device and merged by ``ops.lse_merge``
    (shard order). One target gathers; one a member, each its own heads,
    is an all-to-all of the heads."""
    kind = "all-gather" if len(targets) == 1 else "all-to-all"
    res = []
    for dev, heads in targets:
        with collective(kind):
            outs = [o[:, heads].to(dev) for o, _ in parts]
            lses = [lse[:, heads].to(dev) for _, lse in parts]
        res.append(ops.lse_merge(torch.stack(outs), torch.stack(lses)))
    return res
