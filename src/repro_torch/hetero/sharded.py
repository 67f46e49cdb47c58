"""Sharded hetero offload: one offload side per KV-sequence shard (twin of
``repro.hetero.sharded``, §5.2 / Fig. 6a at scale).

``ShardedHeteroExecutor`` generalizes ``HeteroExecutor`` to a ``(main,
offload_0..offload_{n-1})`` topology. The logical token space [0, max_len)
is cut into ``n_shards`` contiguous windows; each offload side keeps the
incremental page summary of ITS window only (``hetero.select`` bundles
built with ``window=``) and answers the lookahead query with its local
top candidates.

What crosses which link, per decode step:

  main -> shard_s   this step's per-layer queries and new keys (the shard
                    drops what it does not own: index upkeep);
  shard_s -> main   (vals, idx) candidate pairs in GLOBAL page coordinates,
                    8 bytes a candidate, ``n_part <= n_sel`` of them: the
                    index-only exchange, O(k * shards), never a score
                    vector and never a KV page;
  main              the candidate merge (``finalize``: a stable top-k over
                    the shard-ordered lists) and the apply.

Per-page summary scores do not depend on the window's extent and the merge
breaks ties by ascending global index, so the merged selection is the
single-shard executor's: ``offload_shards=2`` serves the tokens of
``offload_shards=1`` in both scheduling modes. Each shard keeps its own
``TransferLedger`` (the report shows each link's traffic) and, on a CUDA
device, its own stream: on one card the shards' selections run on streams
of their own beside the main stream, on several cards one shard a card.

A fused window runs over the shard summaries concatenated along the page
axis, which is the full window's summary (windowed ingest writes only the
pages a shard owns), and scatters them back after.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, MemoryConfig
from repro_torch.hetero import policy as hpolicy
from repro_torch.hetero.executor import HeteroExecutor
from repro_torch.hetero.select import make_offload_select
from repro_torch.hetero.transfer import TransferLedger, pytree_bytes


class _ShardSel:
    """A sharded selection handle: each shard's (vals, idx, event) and the
    lengths it was computed from, on the main side (``finalize`` reads
    them). ``ready`` is False: ``_to_apply`` merges it."""

    __slots__ = ("parts", "lengths")
    ready = False

    def __init__(self, parts, lengths):
        self.parts, self.lengths = parts, lengths


class ShardedHeteroExecutor(HeteroExecutor):
    def __init__(self, cfg: ArchConfig, mem: MemoryConfig, sc,
                 sparse_params, *, mode: str = "overlap",
                 validate: bool = False, n_shards: int = 2, device="cuda",
                 devices=None, main_mesh=None):
        """``devices=(main, (offload_0, ..))`` overrides
        ``pick_devices_sharded(n_shards, device)``; an offload device may
        repeat (shards share it, each on a stream of its own)."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if sc.max_len % n_shards:
            raise ValueError(f"max_len {sc.max_len} does not split into "
                             f"{n_shards} shards")
        self.n_shards = n_shards
        if devices is None:
            main, offs = hpolicy.pick_devices_sharded(n_shards, device)
        else:
            main, offs = devices
            offs = tuple(offs)
            if len(offs) != n_shards:
                raise ValueError(f"{len(offs)} offload devices for "
                                 f"{n_shards} shards")
        self._shard_devs = tuple(torch.device(d) for d in offs)
        super().__init__(cfg, mem, sc, sparse_params, mode=mode,
                         validate=validate, devices=(main, offs[0]),
                         main_mesh=main_mesh)
        local = sc.max_len // n_shards
        if local % self.sel.page:
            raise ValueError(f"shard window {local} must align to the "
                             f"selection page ({self.sel.page})")

    # ------------------------------------------------------------------
    # offload-resident state: one summary shard per offload side
    # ------------------------------------------------------------------

    def _init_offload_state(self, sparse_params) -> None:
        cfg, sc = self.cfg, self.sc
        n = self.n_shards
        local = sc.max_len // n
        self.off_devs = self._shard_devs
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.off_devs]
        self.stream = self.streams[0]
        self.shards = [
            make_offload_select(sc.method, cfg, self.mem, dsa_page=sc.page,
                                n_slots=sc.n_slots, max_len=sc.max_len,
                                window=(s * local, local), device=d)
            for s, d in enumerate(self.off_devs)]
        self.ledgers = [TransferLedger() for _ in range(n)]
        self.sp_offs = [{k: v.to(d) for k, v in sparse_params.items()}
                        for d in self.off_devs]
        self.summaries = [sh.summary_init() for sh in self.shards]
        self.q_bufs = [self._q_init(d) for d in self.off_devs]

    # ------------------------------------------------------------------
    # selection-state primitives
    # ------------------------------------------------------------------

    def _launch_select(self, lengths_np: np.ndarray):
        """Queue each shard's partial selection on its side (the shards'
        streams run them concurrently). Handle = per-shard (vals, idx)
        candidates in global page coordinates."""
        parts = []
        for s in range(self.n_shards):
            with self._on_off(s):
                lengths = torch.as_tensor(lengths_np, dtype=torch.int32,
                                          device=self.off_devs[s])
                v, i = self.shards[s].select_partial(
                    self.sp_offs[s], self.summaries[s], self.q_bufs[s],
                    lengths)
                parts.append((v, i, self._event(s)))
        lengths = torch.tensor(np.asarray(lengths_np), dtype=torch.int32)
        inputs = ("raw", list(self.summaries), list(self.q_bufs), lengths)
        return _ShardSel(parts, lengths.to(self.main_dev)), inputs

    def _to_apply(self, handle) -> torch.Tensor:
        """Index-only up exchange: each shard's (vals, idx) pairs, 8 bytes
        a candidate, merged on the main side in ascending window order (a
        ready handle is merged already)."""
        if handle.ready:
            return handle.pidx
        vals, idx = [], []
        for s, (v, i, ev) in enumerate(handle.parts):
            v, i = self._off_to_main(v, ev, s), self._off_to_main(i, ev, s)
            self.ledgers[s].up_bytes += pytree_bytes((v, i))
            vals.append(v)
            idx.append(i)
        return self._merge(vals, idx, handle.lengths)

    def _merge(self, vals, idx, lengths) -> torch.Tensor:
        """The shards' candidate lists, in ascending window order, merged
        into the final pidx (the full bundle's ``finalize``: ties break as
        a global top-k's)."""
        return self.sel.finalize(torch.cat(vals, dim=-1),
                                 torch.cat(idx, dim=-1), lengths)

    def _patch_handle(self, old, fresh, dirty_np: np.ndarray):
        """Dirty rows patched on each shard's side, candidates and lengths
        alike (the merge is per row: patching before it equals patching
        after), so a patched step still ships one candidate list a shard;
        a ready handle (a fused window's exit lookahead) is patched on the
        main side."""
        if old.ready:
            return super()._patch_handle(old, fresh, dirty_np)
        parts = []
        for s, ((ov, oi, _), (fv, fi, _)) in enumerate(zip(old.parts,
                                                           fresh.parts)):
            with self._on_off(s):
                d = torch.as_tensor(dirty_np, device=ov.device)[None, :,
                                                                 None]
                parts.append((torch.where(d, fv, ov), torch.where(d, fi, oi),
                              self._event(s)))
        rows = torch.as_tensor(dirty_np, device=old.lengths.device)
        return _ShardSel(parts, torch.where(rows, fresh.lengths,
                                            old.lengths))

    def _select_from_pinned(self, inputs) -> torch.Tensor:
        _, sums, qs, lengths = inputs
        vals, idx = [], []
        for s in range(self.n_shards):
            with self._on_off(s):
                v, i = self.shards[s].select_partial(
                    self.sp_offs[s], sums[s], qs[s],
                    lengths.to(self.off_devs[s]))
                vals.append(v.cpu())
                idx.append(i.cpu())
        return self._merge(vals, idx, lengths)

    def _pin_state(self):
        return list(self.summaries), list(self.q_bufs)

    def _ingest_step(self, pinned, q_t, k_t, lengths, live) -> None:
        sums, qs = pinned
        for s in range(self.n_shards):
            led, dev = self.ledgers[s], self.off_devs[s]
            with self._on_off(s):
                q_off = led.ship_down(self._to_off(q_t, s), dev)
                k_off = led.ship_down(self._to_off(k_t, s), dev)
                ln, lv = self._to_off(lengths, s), self._to_off(live, s)
                self.summaries[s] = self.shards[s].ingest(
                    sums[s], self.sp_offs[s], k_off, ln, lv)
                self.q_bufs[s] = self._blend_q(qs[s], q_off, None, lv)

    def _tick(self) -> None:
        for led in self.ledgers:
            led.tick()

    # ------------------------------------------------------------------
    # fused multi-step windows
    # ------------------------------------------------------------------

    def _fused_state_up(self):
        """The shard summaries concatenated along the PAGE axis (axis 2:
        windows are contiguous and ascending, so the concatenation IS the
        full window's summary) on the main side, with shard 0's query
        buffer (every shard blends the same inputs)."""
        parts = []
        for s in range(self.n_shards):
            part = {k: self._off_to_main(v, s=s)
                    for k, v in self.summaries[s].items()}
            self.ledgers[s].bulk_bytes += pytree_bytes(part)
            parts.append(part)
        summary = {k: torch.cat([p[k] for p in parts], dim=2)
                   for k in parts[0]}
        qbuf = self._off_to_main(self.q_bufs[0], s=0)
        self.ledgers[0].bulk_bytes += pytree_bytes(qbuf)
        return summary, qbuf

    def _fused_state_down(self, summary, qbuf) -> None:
        """Each shard takes its page window of the post-window summary;
        every shard's query buffer takes the whole blended buffer."""
        for s, sh in enumerate(self.shards):
            lo = sh.tok_lo // sh.page
            with self._on_off(s):
                self.summaries[s] = {
                    k: self._to_off(v[:, :, lo:lo + sh.n_pages].contiguous(),
                                    s) for k, v in summary.items()}
                self.q_bufs[s] = self._to_off(qbuf, s)
            self.ledgers[s].bulk_bytes += pytree_bytes(
                (self.summaries[s], self.q_bufs[s]))

    # ------------------------------------------------------------------
    # admission / prefill hooks
    # ------------------------------------------------------------------

    def _reset_slots(self, slot_ids: List[int]) -> None:
        for s in range(self.n_shards):
            with self._on_off(s):
                sid = torch.as_tensor(slot_ids, dtype=torch.long,
                                      device=self.off_devs[s])
                self.summaries[s] = self.shards[s].reset(self.summaries[s],
                                                         sid)

    def _clear_q(self, slot_ids: List[int]) -> None:
        for s in range(self.n_shards):
            with self._on_off(s):
                q = self.q_bufs[s].clone()
                q[:, slot_ids] = 0.0
                self.q_bufs[s] = q

    def _seed_span(self, slot_ids, k_span, start_np, n_valid_np, q_last, *,
                   keep_q: Optional[np.ndarray] = None) -> None:
        """The span goes to every shard; each shard's windowed ingest keeps
        exactly the pages it owns (splices and chunked extends land on the
        owning shard's index)."""
        for s in range(self.n_shards):
            led, dev = self.ledgers[s], self.off_devs[s]
            with self._on_off(s):
                k_off = led.ship_down(self._to_off(k_span, s), dev,
                                      bulk=True)
                q_off = led.ship_down(self._to_off(q_last, s), dev,
                                      bulk=True)
                sid = torch.as_tensor(slot_ids, dtype=torch.long, device=dev)
                self.summaries[s] = self.shards[s].ingest_span(
                    self.summaries[s], self.sp_offs[s], k_off, sid,
                    torch.as_tensor(start_np, dtype=torch.int32, device=dev),
                    torch.as_tensor(n_valid_np, dtype=torch.int32,
                                    device=dev))
                keep = None if keep_q is None else torch.as_tensor(
                    keep_q, device=dev)
                self.q_bufs[s] = self._blend_q(self.q_bufs[s], q_off, sid,
                                               keep)

    # ------------------------------------------------------------------

    def report(self) -> Dict:
        self.ledger = TransferLedger.combine(self.ledgers)
        d = super().report()
        d["devices"].update(
            offload=[str(x) for x in self.off_devs],
            distinct=any(x != self.main_dev for x in self.off_devs),
            offload_streams=sum(st is not None for st in self.streams))
        del d["devices"]["offload_stream"]
        d["shards"] = {
            "n_shards": self.n_shards,
            "window_tokens": self.sc.max_len // self.n_shards,
            "windows": [[sh.tok_lo, sh.tok_lo + sh.n_tok]
                        for sh in self.shards],
            "candidates_per_shard": self.shards[0].n_part,
            "per_shard_transfer": [led.as_dict() for led in self.ledgers],
            "distinct_offload_devices": len({str(x)
                                             for x in self.off_devs}),
        }
        return d
