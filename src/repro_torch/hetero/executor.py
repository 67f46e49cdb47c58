"""Offload executor: memory processing beside decode (twin of
``repro.hetero.executor``, paper §5).

Two-phase decode with ONE STEP OF LOOKAHEAD, double-buffered:

  main side      apply_t (sparse attention over preselected pages + the
                 dense remainder), then hands this step's per-layer
                 queries / keys to the offload side;
  offload side   select_{t+1} (prepare / relevancy / retrieve over its
                 incrementally maintained index summary) CONCURRENTLY with
                 apply_t, then ingests step t's keys.

The selection serving step t saw the queries of step t-2 and the keys
through step t-2, the stale lookahead the paper accepts to hide the
memory-bound stages (the page being written is always included at apply).

Where the offload side runs: on a second CUDA device when there is one;
on one card, on a CUDA stream of its own, events the only barriers
between the two streams; on the CPU, in program order.

Scheduling modes share ONE dataflow, the same operations on the same
streams with the same inputs, and differ only in barriers:

  "overlap"  select_{t+1} is queued on the offload stream before apply_t
             on the main stream; nothing waits on the host;
  "sync"     the device is synchronized between phases (select, apply,
             ingest run one after another): the single-timeline baseline,
             which also times the phases.

So the two modes are bitwise equal; ``validate=True`` replays every
consumed selection from its pinned inputs and checks bitwise equality and
stale-index validity.

Pinning: the reference pins the pre-step summary and query buffer by
holding the old (immutable) arrays. The selection bundles here return new
tensors and never write their inputs, so holding the old tensors pins them
too; a tensor made on one stream and read on the other is marked with
``record_stream`` so the caching allocator does not reuse its memory while
the other stream may still read it.

Invalidation is per slot: a finished admission or a landed retrieval
splice marks only that slot's rows dirty; the next step keeps the clean
rows of the overlapped lookahead and patches the dirty ones from a fresh
selection (``profiler.lookahead_patched``).

The main side may be a MESH (``main_mesh``, a device tuple): the apply then
runs ``distributed_paged_sparse_decode`` behind ``decode_step_paged_
presel``'s ``page_attn`` seam, the dense fallback through the same seam.

The selection-state methods (``_launch_select`` / ``_to_apply`` /
``_ingest_step`` / ``_select_from_pinned`` / ``_seed_span`` / the fused
window's ``_fused_state_up`` / ``_fused_state_down``) are the override
surface of ``hetero.sharded.ShardedHeteroExecutor``; the stream helpers take
the index of the offload side they serve (one here, one per shard there).
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, MemoryConfig
from repro_torch.hetero import policy as hpolicy
from repro_torch.hetero.profiler import HeteroProfiler
from repro_torch.hetero.select import make_offload_select
from repro_torch.hetero.transfer import TransferLedger, pytree_bytes
from repro_torch.models import layers as L
from repro_torch.models import model as M

PATCHED = "patched"   # tag of composite pinned-input records
FUSED = "fused"       # tag of pinned inputs produced by a fused window


class _Sel:
    """A selection handle: pidx [L, B, n_sel] int32 and, on a CUDA offload
    stream, the event recorded after it (None: ready in program order).
    ``ready`` marks a selection already on the main side (a fused
    window's exit lookahead)."""

    __slots__ = ("pidx", "event", "ready")

    def __init__(self, pidx, event=None, ready=False):
        self.pidx, self.event, self.ready = pidx, event, ready


def _pinned_len(inputs) -> torch.Tensor:
    """The lengths a (possibly patched) selection was computed from, on the
    CPU. Pinned inputs are (tag, summary, qbuf, lengths), tag "raw" or
    FUSED, or (PATCHED, old inputs, fresh inputs, dirty rows)."""
    if inputs[0] == PATCHED:
        _, old, fresh, dirty = inputs
        return torch.where(torch.as_tensor(dirty), _pinned_len(fresh),
                           _pinned_len(old))
    return inputs[3].cpu()


class HeteroExecutor:
    def __init__(self, cfg: ArchConfig, mem: MemoryConfig, sc,
                 sparse_params, *, mode: str = "overlap",
                 validate: bool = False, device="cuda", devices=None,
                 main_mesh=None):
        """``devices=(main, offload)`` overrides ``pick_devices(device)``
        (a fleet replica's group); ``main_mesh`` (a device tuple whose
        first entry is the main device) runs the apply sequence-parallel
        over it."""
        if mode not in ("sync", "overlap"):
            raise ValueError(f"offload mode {mode!r}")
        self.cfg, self.mem, self.sc, self.mode = cfg, mem, sc, mode
        self.validate = validate
        if devices is not None:
            self.main_dev, self.off_dev = (torch.device(devices[0]),
                                           torch.device(devices[1]))
        else:
            self.main_dev, self.off_dev = hpolicy.pick_devices(device)
        self.main_mesh = None if main_mesh is None else tuple(main_mesh)
        self._page_attn = None
        if self.main_mesh is not None:
            from repro_torch.distributed.topk import \
                distributed_paged_sparse_decode
            self._page_attn = functools.partial(
                distributed_paged_sparse_decode, devices=self.main_mesh)
        self.sel = make_offload_select(sc.method, cfg, mem,
                                       dsa_page=sc.page, n_slots=sc.n_slots,
                                       max_len=sc.max_len,
                                       device=self.off_dev)
        self.plan = hpolicy.plan_stage_placement(cfg, mem, sc.max_len)
        self.ledger = TransferLedger()
        self.profiler = HeteroProfiler(cfg, mem, mode)

        self.sel_buf: Optional[_Sel] = None   # selection for the NEXT step
        self._sel_inputs = None               # its pinned inputs
        self._dirty = np.zeros((sc.n_slots,), bool)   # rows to patch
        self._neg_sel = torch.full(
            (cfg.n_layers, sc.n_slots, self.sel.n_sel), -1,
            dtype=torch.int32, device=self.main_dev)
        self._sp_main = {k: v.to(self.main_dev)
                         for k, v in sparse_params.items()}
        self._init_offload_state(sparse_params)

    def _q_init(self, device) -> torch.Tensor:
        cfg, sc = self.cfg, self.sc
        return torch.zeros(
            (cfg.n_layers, sc.n_slots, cfg.padded_heads(sc.tp), cfg.hd),
            dtype=L.dtype_of(cfg), device=device)

    def _init_offload_state(self, sparse_params) -> None:
        """Offload-resident state, one copy on the one offload side: the
        method params, the index summary, the stale-query buffer, and on a
        CUDA device the side's stream."""
        self.off_devs = (self.off_dev,)
        self.stream = (torch.cuda.Stream(self.off_dev)
                       if self.off_dev.type == "cuda" else None)
        self.streams = [self.stream]
        self.sp_off = {k: v.to(self.off_dev)
                       for k, v in sparse_params.items()}
        self.summary = self.sel.summary_init()
        self.q_buf = self._q_init(self.off_dev)

    @property
    def devices(self) -> Tuple[torch.device, torch.device]:
        return self.main_dev, self.off_dev

    # ------------------------------------------------------------------
    # streams
    # ------------------------------------------------------------------

    def _main_stream(self):
        return (torch.cuda.current_stream(self.main_dev)
                if self.main_dev.type == "cuda" else None)

    def _on_off(self, s: int = 0):
        """Context of work on offload side ``s``, after the main stream's
        work so far (what it reads from the main side is then complete)."""
        stream = self.streams[s]
        if stream is None:
            return contextlib.nullcontext()
        stream.wait_stream(self._main_stream())
        return torch.cuda.stream(stream)

    def _to_off(self, t: torch.Tensor, s: int = 0) -> torch.Tensor:
        """A main-side tensor read on offload side ``s`` (inside
        ``_on_off(s)``)."""
        if self.streams[s] is not None and t.device == self.off_devs[s]:
            t.record_stream(self.streams[s])
        return t.to(self.off_devs[s], non_blocking=True)

    def _off_to_main(self, t: torch.Tensor, event=None,
                     s: int = 0) -> torch.Tensor:
        """A tensor of offload side ``s`` read on the main stream."""
        main = self._main_stream()
        if self.streams[s] is not None:
            if event is not None:
                main.wait_event(event)
            else:
                main.wait_stream(self.streams[s])
            if t.device == self.main_dev:
                t.record_stream(main)
        return t.to(self.main_dev, non_blocking=True)

    def _event(self, s: int = 0):
        if self.streams[s] is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.streams[s])
        return ev

    def _sync(self):
        for d in {self.main_dev, *self.off_devs, *(self.main_mesh or ())}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # ------------------------------------------------------------------
    # selection-state primitives
    # ------------------------------------------------------------------

    def _launch_select(self, lengths_np: np.ndarray):
        """Queue a selection on the offload side from the CURRENT summary
        and stale-query buffers -> (handle, pinned inputs)."""
        with self._on_off():
            lengths = torch.as_tensor(lengths_np, dtype=torch.int32,
                                      device=self.off_dev)
            inputs = ("raw", self.summary, self.q_buf, lengths)
            pidx = self.sel.select(self.sp_off, self.summary, self.q_buf,
                                   lengths)
            return _Sel(pidx, self._event()), inputs

    def _to_apply(self, handle: _Sel) -> torch.Tensor:
        """The consumable selection on the main side (the index-only up
        exchange)."""
        if handle.ready:
            return handle.pidx
        pidx = self._off_to_main(handle.pidx, handle.event)
        self.ledger.up_bytes += pytree_bytes(pidx)
        return pidx

    @staticmethod
    def _patch_pidx(old, fresh, dirty_np: np.ndarray):
        d = torch.as_tensor(dirty_np, device=old.device)[None, :, None]
        return torch.where(d, fresh, old)

    def _patch_handle(self, old, fresh, dirty_np: np.ndarray):
        """The pending selection with the dirty rows taken from ``fresh``,
        patched on the main side (both are shipped there)."""
        return _Sel(self._patch_pidx(self._to_apply(old),
                                     self._to_apply(fresh), dirty_np),
                    ready=True)

    def _pin_state(self):
        """The pre-step offload state: the overlapped select must not see
        this step's keys / queries."""
        return self.summary, self.q_buf

    def _ingest_step(self, pinned, q_t, k_t, lengths, live) -> None:
        """Ship this step's queries / keys down; fold them into the index
        summary and the stale-query buffer (new tensors)."""
        summary_prev, q_prev = pinned
        with self._on_off():
            q_off = self.ledger.ship_down(self._to_off(q_t), self.off_dev)
            k_off = self.ledger.ship_down(self._to_off(k_t), self.off_dev)
            lengths, live = self._to_off(lengths), self._to_off(live)
            self.summary = self.sel.ingest(summary_prev, self.sp_off, k_off,
                                           lengths, live)
            self.q_buf = self._blend_q(q_prev, q_off, None, live)

    def _tick(self) -> None:
        self.ledger.tick()

    # -- pinned-input replay -------------------------------------------

    def _replay_pidx(self, inputs) -> torch.Tensor:
        """Recompute, synchronously, the selection a consumed buffer was
        produced from, recursing through row patches; FUSED pins replay as
        one select from the pinned pre-ingest state on the main side."""
        tag = inputs[0]
        if tag == PATCHED:
            _, old, fresh, dirty = inputs
            return self._patch_pidx(self._replay_pidx(old).cpu(),
                                    self._replay_pidx(fresh).cpu(), dirty)
        if tag == FUSED:
            _, summary, qbuf, la_len = inputs
            return self.sel.select(self._sp_main, summary, qbuf,
                                   la_len).cpu()
        return self._select_from_pinned(inputs)

    def _select_from_pinned(self, inputs) -> torch.Tensor:
        """The selection of raw pinned inputs, recomputed synchronously and
        returned on the CPU."""
        _, summary, qbuf, lengths = inputs
        with self._on_off():
            return self.sel.select(self.sp_off, summary, qbuf,
                                   lengths).cpu()

    # ------------------------------------------------------------------
    # admission / prefill hooks (keep the offload index coherent)
    # ------------------------------------------------------------------

    @staticmethod
    def _blend_q(q_buf, q_off, sid, keep_q):
        """Stale-query refresh: ``keep_q=None`` overwrites the rows
        ``sid`` (admission); else only rows whose slot advanced
        (``keep_q`` mask) take the new query."""
        if keep_q is None:
            out = q_buf.clone()
            out[:, sid.long()] = q_off.to(q_buf.dtype)
            return out
        return torch.where(keep_q[None, :, None, None],
                           q_off.to(q_buf.dtype), q_buf)

    def _reset_slots(self, slot_ids: List[int]) -> None:
        with self._on_off():
            sid = torch.as_tensor(slot_ids, dtype=torch.long,
                                  device=self.off_dev)
            self.summary = self.sel.reset(self.summary, sid)

    def _seed_span(self, slot_ids, k_span, start_np, n_valid_np, q_last, *,
                   keep_q: Optional[np.ndarray] = None) -> None:
        """Ship a prompt / chunk key span down (bulk prefill traffic), fold
        it into the summary, refresh the stale-query buffer (the seeded
        rows, or only ``keep_q`` rows of a chunk where some slots idled)."""
        with self._on_off():
            dev = self.off_dev
            k_off = self.ledger.ship_down(self._to_off(k_span), dev,
                                          bulk=True)
            q_off = self.ledger.ship_down(self._to_off(q_last), dev,
                                          bulk=True)
            sid = torch.as_tensor(slot_ids, dtype=torch.long, device=dev)
            self.summary = self.sel.ingest_span(
                self.summary, self.sp_off, k_off, sid,
                torch.as_tensor(start_np, dtype=torch.int32, device=dev),
                torch.as_tensor(n_valid_np, dtype=torch.int32, device=dev))
            keep = None if keep_q is None else torch.as_tensor(
                keep_q, device=dev)
            self.q_buf = self._blend_q(self.q_buf, q_off, sid, keep)

    def on_admit(self, slot_ids: List[int], k_masked, true_lens: np.ndarray,
                 q_last) -> None:
        """Bucketed admission: reset the slots' summary rows, bulk-ship the
        prompt keys, seed the stale-query buffer with the last prompt
        token's queries."""
        self._reset_slots(slot_ids)
        self._seed_span(slot_ids, k_masked,
                        np.zeros((len(slot_ids),), np.int32), true_lens,
                        q_last)
        self.invalidate(slot_ids)

    def on_admit_slot(self, slot: int) -> None:
        """Chunked admission: clear the slot's rows; keys arrive per chunk."""
        self._reset_slots([slot])
        self._clear_q([slot])
        self.invalidate([slot])

    def _clear_q(self, slot_ids: List[int]) -> None:
        with self._on_off():
            q = self.q_buf.clone()
            q[:, slot_ids] = 0.0
            self.q_buf = q

    def on_extend(self, k_span, q_last, start_np: np.ndarray,
                  n_valid_np: np.ndarray, finished: List[int]) -> None:
        """A chunked-prefill chunk landed: ingest the span, refresh the
        stale query of every advancing slot; only the slots whose payload
        (admission prompt or retrieval splice) completed go dirty."""
        self._seed_span(list(range(k_span.shape[1])), k_span, start_np,
                        n_valid_np, q_last, keep_q=n_valid_np > 0)
        if finished:
            self.invalidate(finished)

    def invalidate(self, slots: Optional[List[int]] = None) -> None:
        """``slots=None`` drops the whole pending lookahead (the offload
        window itself changed: dynamic fallback); a slot list marks only
        those rows dirty."""
        if slots is None:
            self.sel_buf = None
            self._sel_inputs = None
            self._dirty[:] = False
        else:
            self._dirty[list(slots)] = True

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _resolve_sel(self, lengths_np: np.ndarray, live_np: np.ndarray, *,
                     sync: bool):
        """The selection the NEXT apply consumes: a cold start when no
        lookahead is pending, else the lookahead with the rows of slots
        whose membership changed patched. Shared by the stepped schedule
        and the fused-window entry. -> (pinned inputs, pidx, select s)."""
        t_sel = 0.0
        if self.sel_buf is None:                          # cold start
            t0 = time.perf_counter()
            self.sel_buf, self._sel_inputs = self._launch_select(lengths_np)
            self._dirty &= ~live_np
            self.profiler.lookahead_cold += 1
            if sync:
                self._sync()
                t_sel += time.perf_counter() - t0
        else:
            self.profiler.lookahead_hits += 1
            patch_rows = self._dirty & live_np
            if patch_rows.any():
                t0 = time.perf_counter()
                fresh, fresh_inputs = self._launch_select(lengths_np)
                self.sel_buf = self._patch_handle(self.sel_buf, fresh,
                                                  patch_rows)
                self._sel_inputs = (PATCHED, self._sel_inputs,
                                    fresh_inputs, patch_rows.copy())
                self._dirty &= ~patch_rows
                self.profiler.lookahead_patched += 1
                if sync:
                    self._sync()
                    t_sel += time.perf_counter() - t0
        return self._sel_inputs, self._to_apply(self.sel_buf), t_sel

    def _offloaded(self, lengths_np, live_np) -> Tuple[bool, int]:
        context = int(lengths_np.max()) + 1 if live_np.any() else 1
        return hpolicy.dynamic_mode(context, self.mem) == "offload", context

    def decode(self, params, tok, pool_device: Dict, table,
               lengths_np: np.ndarray, live_np: np.ndarray):
        """One pooled decode step -> logits [B, V]; the pool pages are
        written in place."""
        sync = self.mode == "sync"
        t_step = time.perf_counter()
        dev = self.main_dev
        lengths = torch.as_tensor(lengths_np, dtype=torch.int32, device=dev)
        live = torch.as_tensor(live_np, device=dev)
        offloaded, context = self._offloaded(lengths_np, live_np)

        t_sel = 0.0
        if offloaded:
            pidx_inputs, pidx, t_sel = self._resolve_sel(lengths_np, live_np,
                                                         sync=sync)
        else:
            # dynamic fallback: main side only, no offload work
            pidx_inputs, pidx = None, self._neg_sel
            self.invalidate()

        pinned = self._pin_state()
        next_sel = next_inputs = None
        if offloaded and not sync:
            # select_{t+1} queued on the offload stream BEFORE apply_t
            next_sel, next_inputs = self._launch_select(lengths_np + live_np)

        if sync:
            self._sync()
        t0 = time.perf_counter()
        pool = dict(pool_device, page_table=table, lengths=lengths)
        logits, _, q_t, k_t = M.decode_step_paged_presel(
            params, self.cfg, tok, pool, live, pidx, sparse=offloaded,
            page_size=self.sel.page, tp=self.sc.tp,
            page_attn=self._page_attn)
        t_apply = None
        if sync:
            self._sync()
            t_apply = time.perf_counter() - t0

        if offloaded and sync:
            t0 = time.perf_counter()
            next_sel, next_inputs = self._launch_select(lengths_np + live_np)
            self._sync()
            t_sel += time.perf_counter() - t0

        # ingest (also during local fallback: the index must stay coherent
        # for when the context re-enters the offload window)
        self._tick()
        t0 = time.perf_counter()
        self._ingest_step(pinned, q_t, k_t, lengths, live)
        if sync:
            self._sync()
            if offloaded:   # local-fallback ingest is pool upkeep
                t_sel += time.perf_counter() - t0
        self.sel_buf, self._sel_inputs = next_sel, next_inputs

        if self.validate and offloaded and pidx_inputs is not None:
            self._validate(pidx, pidx_inputs)
        self.profiler.record_step(
            int(live_np.sum()), context, time.perf_counter() - t_step,
            select_s=t_sel if sync else None, apply_s=t_apply,
            offloaded=offloaded)
        return logits

    # ------------------------------------------------------------------
    # fused multi-step windows (serving.fused)
    # ------------------------------------------------------------------

    def _fused_state_up(self):
        """The offload-resident index state on the main side for a window
        (bulk traffic: a state migration, not the per-step exchange).
        -> (summary, qbuf)."""
        summary = {k: self._off_to_main(v) for k, v in self.summary.items()}
        qbuf = self._off_to_main(self.q_buf)
        self.ledger.bulk_bytes += pytree_bytes((summary, qbuf))
        return summary, qbuf

    def _fused_state_down(self, summary, qbuf) -> None:
        """The post-window index state back to the offload side."""
        with self._on_off():
            self.summary = {k: self._to_off(v) for k, v in summary.items()}
            self.q_buf = self._to_off(qbuf)
        self.ledger.bulk_bytes += pytree_bytes((self.summary, self.q_buf))

    def decode_fused(self, runner, params, pool_device: Dict, ins: Dict,
                     lengths_np: np.ndarray, live_np: np.ndarray, K: int,
                     trigger):
        """Up to ``ins["budget"]`` (<= K) pooled decode steps in one window
        on the main side: the two-phase apply and the lookahead double
        buffer, with masked early exit when a slot finishes or a trigger
        fires (``serving.fused.make_fused_presel``; ``ins`` holds the
        window's host inputs and table view, ``runner`` the engine's
        ``GraphRunner``). The window enters from the selection the stepped
        schedule would consume and exits with its lookahead installed (a
        ready pidx + FUSED pins), so stepped and fused schedules interleave
        exactly. The engine's budget keeps the window on one side of the
        fallback window. -> (nsteps, pending [B], emits [K, B], fired
        [K, B])."""
        from repro_torch.serving import fused as F

        sync = self.mode == "sync"
        t_step = time.perf_counter()
        offloaded, context = self._offloaded(lengths_np, live_np)
        if offloaded:
            pidx_inputs, pidx, _ = self._resolve_sel(lengths_np, live_np,
                                                     sync=sync)
            if self.validate and pidx_inputs is not None:
                self._validate(pidx, pidx_inputs)
        else:
            pidx = self._neg_sel
            self.invalidate()
        summary, qbuf = self._fused_state_up()
        B = self.sc.n_slots
        ins = dict(ins, sel=pidx, qbuf=qbuf,
                   **{"summary." + k: v for k, v in summary.items()})
        table = ins["table"]
        key = ("presel", offloaded, int(table.shape[1]), K, trigger)
        fn = F.make_fused_presel(
            self.cfg, self.sc, self.sel, K=K, trigger=trigger,
            offl=offloaded, sparse_params=self._sp_main, params=params,
            pool_device=pool_device, page_attn=self._page_attn)
        host, outs = runner.run(key, fn, ins)
        if sync:
            self._sync()
        nsteps, pending, emits, fired = F.unpack_host(host, K, B)
        for _ in range(nsteps):
            self._tick()
        self._fused_state_down(
            {k[len("summary."):]: v for k, v in outs.items()
             if k.startswith("summary.")}, outs["qbuf"])
        if offloaded:
            self.sel_buf = _Sel(outs["sel"], ready=True)
            prev = {k[len("prev_summary."):]: v for k, v in outs.items()
                    if k.startswith("prev_summary.")}
            self._sel_inputs = (FUSED, prev, outs["prev_q"],
                                outs["prev_len"])
        else:
            # the stepped schedule invalidates on every fallback step,
            # which clears the dirty rows too
            self.invalidate()
        self.profiler.record_fused(
            nsteps, int((emits[:nsteps] >= 0).sum()), context,
            time.perf_counter() - t_step,
            offload_steps=nsteps if offloaded else 0,
            local_steps=0 if offloaded else nsteps)
        return nsteps, pending, emits, fired

    # ------------------------------------------------------------------
    # validation mode
    # ------------------------------------------------------------------

    def _validate(self, pidx, inputs) -> None:
        """Re-run the consumed selection synchronously from its pinned
        inputs: it must be bitwise equal, and every index a valid stale
        pick (inside the live region it was computed from)."""
        ref = self._replay_pidx(inputs)
        got = pidx.cpu()
        if not torch.equal(got, ref):
            raise AssertionError(
                "overlapped selection diverged from its synchronous replay")
        lens = _pinned_len(inputs).long()
        ok = (got == -1) | ((got >= 0)
                            & (got.long() * self.sel.page
                               < lens[None, :, None]))
        if not bool(ok.all()):
            raise AssertionError("stale lookahead produced out-of-window "
                                 "page indices")

    # ------------------------------------------------------------------

    def report(self) -> Dict:
        d = self.profiler.summary(self.ledger, cfg=self.cfg,
                                  n_sel=self.sel.n_sel, page=self.sel.page,
                                  batch=self.sc.n_slots)
        d["devices"] = {"main": str(self.main_dev),
                        "offload": str(self.off_dev),
                        "distinct": self.main_dev != self.off_dev,
                        "offload_stream": self.stream is not None}
        if self.main_mesh is not None:
            d["devices"]["main_mesh"] = [str(x) for x in self.main_mesh]
        d["plan"] = {"stages": dict(self.plan.stages),
                     "offloaded": list(self.plan.offloaded())}
        return d
