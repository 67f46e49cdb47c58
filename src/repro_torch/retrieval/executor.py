"""Serving-side retrieval executor (twin of ``repro.retrieval.executor``):
dynamic triggers, async queries, splice scheduling.

Per decode step the engine hands this executor the pooled decode logits;
FLARE / DRAGIN triggers fire PER SLOT, and a fired slot's query (a window
of its recent context tokens) goes to the retrieval service:

  inline   the service works on the engine's stream; the query is resolved
           at the trigger step (the stop-retrieve-resume oracle every other
           mode must bit-match);
  sync     the service works on its own CUDA stream (or the second card),
           still resolved at the trigger step (the serialized baseline);
  overlap  the query runs on the service's stream WHILE the engine's stream
           decodes the other slots; the fired slot pauses (it leaves the
           live mask) and its result is consumed one step later.

On the CPU all three run in program order. The fired slot pauses exactly
one step in every mode: one dataflow, the modes differ only in where the
host waits.

The retrieved payload (doc token spans for rag, memory embeddings for mac)
is spliced into the slot's paged KV context by the ENGINE through the
chunked ``extend_paged`` path; this module decides when to fire, runs the
queries and keeps the per-slot bookkeeping deterministic, so every mode
emits identical tokens.

For fused multi-step decode (``serving/fused.py``) the trigger runs on the
device: ``traced_trigger`` is the predicate on tensors, and
``fused_gates`` compiles the host gates into per-slot scalars a window
evaluates without a host turn.

``RetrievalConfig(service=...)`` hands the executor a service built
elsewhere: the fleet router's one corpus shared by its replicas.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.methods import rag as rag_m
from repro_torch.core.methods.mac import MacConfig
from repro_torch.hetero import policy as hpolicy
from repro_torch.hetero.transfer import TransferLedger
from repro_torch.retrieval.bank import MacBankService
from repro_torch.retrieval.service import RetrievalService

MODES = ("inline", "sync", "overlap")


def traced_trigger(kind: str, tau: float, logits: torch.Tensor, lengths):
    """FLARE/DRAGIN trigger predicate on tensors, with no host read: the
    per-step evaluation inside a fused window. ``lengths`` is the pre-step
    masked length vector (the array the host ``trigger_slots`` gets), so
    the DRAGIN context weight is the stepped path's."""
    if kind == "flare":
        return rag_m.flare_trigger(logits, tau=tau)
    if kind == "dragin":
        ent_w = torch.log1p(torch.as_tensor(lengths, dtype=torch.float32,
                                            device=logits.device))
        return rag_m.dragin_trigger(logits, ent_w, tau=tau)
    raise KeyError(f"unknown trigger {kind!r}")


@dataclasses.dataclass
class RetrievalConfig:
    """``ServeConfig(retrieval=...)``: the document-memory service knobs."""

    kind: str = "rag"            # rag | mac
    mode: str = "inline"         # inline | sync | overlap
    corpus: Any = None           # rag.Corpus (required for kind=rag)
    k: int = 4                   # docs per retrieval (rag)
    capacity: int = 0            # corpus store size (0 = pow2 fit)
    ingest_block: int = 64       # docs per appended block
    mac: Optional[MacConfig] = None   # bank shape (kind=mac)
    trigger: str = "flare"       # flare | dragin
    tau: float = 0.4             # trigger threshold
    query_window: int = 8        # context tokens forming the query
    min_interval: int = 8        # context growth required between triggers
    max_retrievals: int = 2      # per request
    validate: bool = False       # replay every consumed query synchronously
    # a RetrievalService built elsewhere and SHARED by executors (the fleet
    # router's one corpus for many replicas: the store is capacity-padded
    # and ingests incrementally, so a document ingested through any replica
    # is visible to every replica's triggers). kind='rag' only; None = the
    # executor builds its own service.
    service: Optional[RetrievalService] = None


class RetrievalExecutor:
    def __init__(self, cfg: ArchConfig, sc, rcfg: RetrievalConfig, params,
                 *, mac_params=None, seed: int = 0, device="cuda",
                 devices=None):
        """``params`` are the model's (MaC embeds its token windows with
        them); ``mac_params`` the MaC projections (default ``mac_init`` at
        ``seed``). The service runs on ``policy.pick_devices(device)``'s
        offload device (the engine's on one card), or on ``devices=(main,
        offload)``'s; a shared ``rcfg.service`` keeps its own."""
        if rcfg.mode not in MODES:
            raise ValueError(f"retrieval mode {rcfg.mode!r} not in {MODES}")
        if rcfg.kind not in ("rag", "mac"):
            raise ValueError(f"retrieval kind {rcfg.kind!r}")
        self.cfg, self.sc, self.rcfg = cfg, sc, rcfg
        self.mode = rcfg.mode
        if devices is not None:
            self.main_dev, self.off_dev = (torch.device(devices[0]),
                                           torch.device(devices[1]))
        else:
            self.main_dev, self.off_dev = hpolicy.pick_devices(device)
        inline = rcfg.mode == "inline"
        dev = self.main_dev if inline else self.off_dev
        self.ledger = TransferLedger()
        self.service: Optional[RetrievalService] = None
        self.bank: Optional[MacBankService] = None
        if rcfg.kind == "rag" and rcfg.service is not None:
            # the fleet's shared corpus: adopt the service and its ledger,
            # so the replicas' transfers pool in one place
            self.service = rcfg.service
            self.ledger = self.service.ledger
            self.off_dev = self.service.device
        elif rcfg.kind == "rag":
            if rcfg.corpus is None:
                raise ValueError("kind='rag' needs a corpus")
            self.service = RetrievalService(
                rcfg.corpus, k=rcfg.k, device=dev, capacity=rcfg.capacity,
                ingest_block=rcfg.ingest_block, ledger=self.ledger,
                side_stream=not inline)
        else:
            mc = rcfg.mac or MacConfig()
            # summaries push at page boundaries: segment = page multiple
            seg = max(mc.segment_len, sc.kv_page_size)
            seg = ((seg + sc.kv_page_size - 1)
                   // sc.kv_page_size) * sc.kv_page_size
            if seg != mc.segment_len:
                mc = dataclasses.replace(mc, segment_len=seg)
            self.mc = mc
            self.bank = MacBankService(cfg, mc, sc.n_slots, params["embed"],
                                       mac_params=mac_params, seed=seed,
                                       device=dev, ledger=self.ledger,
                                       side_stream=not inline)
        self._svc = self.service if self.service is not None else self.bank
        n = sc.n_slots
        self._enabled = np.zeros((n,), bool)
        self._hist: List[List[int]] = [[] for _ in range(n)]
        self._pushed = np.zeros((n,), np.int64)    # mac: tokens summarized
        self._n_ret = np.zeros((n,), np.int32)
        self._last_len = np.zeros((n,), np.int64)  # context len @ last fire
        self._waiting = np.zeros((n,), bool)
        self._inflight: Dict[int, Dict] = {}       # slot -> handle + age
        self.events: List[Dict] = []
        self.suppressed = 0

    # ------------------------------------------------------------------
    # slot lifecycle (engine hooks)
    # ------------------------------------------------------------------

    def on_admit(self, slot: int, prompt: np.ndarray,
                 enabled: Optional[bool]) -> None:
        if slot in self._inflight:
            raise RuntimeError(f"slot {slot} admitted mid-retrieval")
        self._enabled[slot] = True if enabled is None else bool(enabled)
        self._hist[slot] = [int(t) for t in np.asarray(prompt)]
        self._pushed[slot] = 0
        self._n_ret[slot] = 0
        self._last_len[slot] = len(self._hist[slot])
        self._waiting[slot] = False
        if self.bank is not None:
            self.bank.reset([slot])
            if self._enabled[slot]:
                self._push_segments(slot)

    def on_release(self, slot: int) -> None:
        if slot in self._inflight:
            raise RuntimeError(f"slot {slot} released mid-retrieval")
        self._enabled[slot] = False
        self._hist[slot] = []
        self._waiting[slot] = False
        if self.bank is not None:
            self.bank.reset([slot])

    def note_token(self, slot: int, tok: int) -> None:
        """One decode token fed to ``slot`` (entered its KV context)."""
        self._hist[slot].append(int(tok))
        if self.bank is not None and self._enabled[slot]:
            self._push_segments(slot)

    def note_splice(self, slot: int, payload) -> None:
        """Retrieved payload queued into the slot's context: doc tokens for
        rag, ``n`` placeholder rows for mac embeddings (the history tracks
        positions; embedding rows have no token ids)."""
        if isinstance(payload, (int, np.integer)):
            self._hist[slot].extend([0] * int(payload))
        else:
            self._hist[slot].extend(int(t) for t in np.asarray(payload))
        self._last_len[slot] = len(self._hist[slot])
        if self.bank is not None and self._enabled[slot]:
            self._push_segments(slot)

    def _push_segments(self, slot: int) -> None:
        seg = self.mc.segment_len
        hist = self._hist[slot]
        while len(hist) - self._pushed[slot] >= seg:
            lo = int(self._pushed[slot])
            self.bank.push(slot, np.asarray(hist[lo: lo + seg], np.int32))
            self._pushed[slot] += seg

    # ------------------------------------------------------------------
    # triggers
    # ------------------------------------------------------------------

    def trigger_slots(self, logits: torch.Tensor, live_np: np.ndarray,
                      lengths_np: np.ndarray, slots) -> List[int]:
        """Slots whose dynamic-retrieval trigger fires on this step's
        logits, after the deterministic host-side gates (enabled, cooldown,
        retrieval budget, bank occupancy, not already in flight)."""
        r = self.rcfg
        # DRAGIN's attention-statistics proxy is the log-context weight
        fire = traced_trigger(r.trigger, r.tau, logits,
                              lengths_np).cpu().numpy()
        out = []
        for i in np.flatnonzero(fire & live_np & self._enabled):
            s = slots[i]
            if s.done or self._waiting[i] or i in self._inflight:
                continue
            if self._n_ret[i] >= r.max_retrievals:
                continue
            if len(self._hist[i]) - self._last_len[i] < r.min_interval:
                continue
            if self.bank is not None and self.bank.counts[i] == 0:
                continue
            out.append(int(i))
        return out

    def fused_gates(self):
        """The host gates of ``trigger_slots`` as per-slot scalars a fused
        window evaluates on the device.

        ``armed [B] bool`` folds the static gates (enabled, not waiting,
        retrieval budget, not in flight); the countdown gates become
        ``arm_after [B] int32``, the in-window emitted-token count at which
        they open. That holds because a slot's history grows by exactly one
        token per emitted token while no splice lands (the engine opens a
        window only with the service quiescent):

          cooldown   len(hist) - last_len >= min_interval
                     -> emitted >= min_interval - (len(hist0) - last_len)
          mac bank   counts[i] > 0 after the next segment push
                     -> emitted >= segment_len - (len(hist0) - pushed)
        """
        r = self.rcfg
        armed = (self._enabled & ~self._waiting
                 & (self._n_ret < r.max_retrievals))
        for i in self._inflight:
            armed[i] = False
        h0 = np.asarray([len(h) for h in self._hist], np.int64)
        arm_after = (r.min_interval - (h0 - self._last_len)).astype(np.int32)
        if self.bank is not None:
            bank_need = np.where(
                self.bank.counts > 0, np.int32(-(1 << 30)),
                (self.mc.segment_len - (h0 - self._pushed)).astype(np.int32))
            arm_after = np.maximum(arm_after, bank_need)
        return armed, arm_after

    def splice_bound(self) -> int:
        """Upper bound on spliced tokens per retrieval: pages are reserved
        at the trigger step, so the pool accounting is the same under every
        mode."""
        if self.service is not None:
            return self.rcfg.k * self.service._tokens.shape[1]
        return self.mc.retrieve_k

    def note_suppressed(self, slot: int) -> None:
        """Trigger fired but the pool cannot take the splice; charge the
        cooldown so the slot does not re-fire every step."""
        self.suppressed += 1
        self._last_len[slot] = len(self._hist[slot])

    # ------------------------------------------------------------------
    # query launch / collection
    # ------------------------------------------------------------------

    def _query_window(self, slot: int) -> np.ndarray:
        W = self.rcfg.query_window
        h = self._hist[slot][-W:]
        if len(h) < W:
            h = [0] * (W - len(h)) + h
        return np.asarray(h, np.int32)

    def launch(self, slot: int) -> None:
        """Dispatch the fired slot's query. One dataflow for every mode: the
        slot pauses and its splice queues on the NEXT step regardless;
        inline and sync wait here for the query, overlap lets it run under
        the next decode step."""
        toks = self._query_window(slot)
        t0 = time.perf_counter()
        if self.service is not None:
            handle = self.service.query(toks[None] % self.service.vocab)
        else:
            handle = self.bank.query(slot, toks)
        if self.mode != "overlap":
            self._svc.wait(handle)
        self._inflight[slot] = {"handle": handle, "age": 0, "t0": t0,
                                "hist_len": len(self._hist[slot])}
        self._waiting[slot] = True
        self._n_ret[slot] += 1
        self._last_len[slot] = len(self._hist[slot])

    def tick(self) -> None:
        for rec in self._inflight.values():
            rec["age"] += 1

    def collect_ready(self, min_age: int = 1) -> List:
        """Consume finished queries: -> [(slot, tokens|None, embeds|None,
        ids)], for the queries at least ``min_age`` steps old."""
        out = []
        for slot in sorted(self._inflight):
            rec = self._inflight[slot]
            if rec["age"] < min_age:
                continue
            h = rec["handle"]
            if self.service is not None:
                ids, spans = self.service.collect(h, device=self.main_dev)
                toks, embeds, ids = spans[0], None, ids[0]
            else:
                ids, embeds = self.bank.collect(h, device=self.main_dev)
                toks = None
            if self.rcfg.validate and not self._svc.replay(h):
                raise AssertionError(f"overlapped {self.rcfg.kind} query "
                                     f"diverged from its replay")
            del self._inflight[slot]
            self._waiting[slot] = False
            self.events.append({
                "slot": slot, "ids": np.asarray(ids).tolist(),
                "hist_len": rec["hist_len"],
                "spliced": int(len(toks) if toks is not None
                               else len(embeds)),
                "latency_s": time.perf_counter() - rec["t0"],
            })
            out.append((slot, toks, embeds, ids))
        return out

    # ------------------------------------------------------------------

    def waiting_mask(self) -> np.ndarray:
        return self._waiting.copy()

    def busy(self) -> bool:
        return bool(self._inflight) or bool(self._waiting.any())

    def report(self) -> Dict:
        lat = [e["latency_s"] for e in self.events]
        return {
            "kind": self.rcfg.kind,
            "mode": self.mode,
            "trigger": self.rcfg.trigger,
            "retrievals": len(self.events),
            "suppressed": self.suppressed,
            "spliced_tokens": int(sum(e["spliced"] for e in self.events)),
            "trigger_to_splice_s": {
                "mean": float(np.mean(lat)) if lat else 0.0,
                "max": float(np.max(lat)) if lat else 0.0,
            },
            "transfer": self.ledger.as_dict(),
            "devices": {"main": str(self.main_dev),
                        "retrieval": str(self.off_dev
                                         if self.mode != "inline"
                                         else self.main_dev),
                        "distinct": self.mode != "inline"
                        and self.main_dev != self.off_dev,
                        "side_stream": self._svc.side.stream is not None},
        }
