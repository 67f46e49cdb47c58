"""Per-slot MaC memory-bank service (twin of ``repro.retrieval.bank``;
paper Table 1 row 8, Fig. 6c).

The banks (FIFO segment-summary embeddings per serving slot) live on the
retrieval device with the token-embedding table and the MaC projection
weights, so the whole prepare / relevancy / retrieve side runs there:
segment pushes ship only the segment's token ids down, relevancy queries
only a token window, and only the ``[r, d]`` retrieved embeddings come back
(spliced into the generator's context by the engine).

Segment summaries are Titans-style projections of the segment's token
embeddings (``mac.prepare_memory`` over ``layers.embed`` rows): a pure
function of the slot's token stream, which is what makes the overlapped
schedule bit-match its synchronous counterpart. Streams as in
``retrieval.service``: ``reset``, ``push`` and ``query`` go to the side
stream when there is one.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.methods.mac import MacConfig, mac_init
from repro_torch.hetero.transfer import TransferLedger
from repro_torch.retrieval.select import make_retrieval_select
from repro_torch.retrieval.service import SideStream, int32


class MacBankService:
    def __init__(self, cfg: ArchConfig, mc: MacConfig, n_slots: int,
                 embed_params, *, mac_params=None, seed: int = 0,
                 device="cuda", ledger: Optional[TransferLedger] = None,
                 side_stream: bool = False):
        """``mac_params`` (the MaC projections) default to ``mac_init`` at
        ``seed`` on ``device``."""
        self.cfg, self.mc, self.n_slots = cfg, mc, n_slots
        self.device = resolve_device(device)
        self.ledger = ledger or TransferLedger()
        self.side = SideStream(self.device, side_stream)
        self.sel = make_retrieval_select("mac", cfg, n_slots=n_slots, mac=mc,
                                         device=self.device)
        with self.side.enter():
            mp = mac_params if mac_params is not None else mac_init(
                cfg, seed, device=self.device)
            self.sp = {"embed": {k: v.to(self.device)
                                 for k, v in embed_params.items()},
                       "mac": {k: v.to(self.device) for k, v in mp.items()}}
            self.state = self.sel.summary_init()
        # host mirror of per-slot bank occupancy (trigger gating)
        self.counts = np.zeros((n_slots,), np.int32)

    def reset(self, slots) -> None:
        with self.side.enter():
            sid = self.ledger.ship_down(int32(slots), self.device).long()
            self.state = self.sel.reset(self.state, sid)
        self.counts[np.asarray(slots)] = 0

    def push(self, slot: int, seg_tokens) -> None:
        """FIFO-push the summary of one segment's tokens into ``slot``'s
        bank (prepare stage, on the retrieval device; async)."""
        with self.side.enter():
            toks = self.ledger.ship_down(int32(seg_tokens), self.device)
            self.state = self.sel.ingest(self.state, self.sp, slot, toks)
        self.counts[slot] = min(self.counts[slot] + 1, self.mc.memory_slots)

    def query(self, slot: int, q_tokens) -> Dict:
        """Launch relevancy + retrieve for ``slot`` from a token window
        (async: collect with ``collect``). The handle pins the bank state it
        read (banks are replaced, never written in place)."""
        with self.side.enter():
            toks = self.ledger.ship_down(int32(q_tokens), self.device)
            state = self.state
            idx, embeds = self.sel.select(self.sp, state, toks, slot)
            event = self.side.record()
        return {"ids": idx, "embeds": embeds, "event": event,
                "inputs": (state, toks, slot)}

    def wait(self, handle: Dict) -> None:
        """Block the host until the query has run."""
        self.side.wait_host(handle["event"])

    def collect(self, handle: Dict, device=None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Block: -> (idx [r], embeds [r', d] fp32) with invalid picks
        trimmed."""
        device = torch.device(device) if device is not None else self.device
        self.side.join(handle["event"], device)
        ids = self.ledger.ship_up(handle["ids"], device).cpu().numpy()
        embeds = self.ledger.ship_up(handle["embeds"], device).cpu().numpy()
        embeds = embeds.astype(np.float32)
        keep = ids >= 0
        self.ledger.count_span(embeds[keep].nbytes)
        return ids[keep], embeds[keep]

    def replay(self, handle: Dict) -> bool:
        """Re-run the pinned selection synchronously; True iff bit-equal."""
        self.side.join(handle["event"], self.device)
        state, toks, slot = handle["inputs"]
        ref_idx, ref_emb = self.sel.select(self.sp, state, toks, slot)
        return bool(torch.equal(ref_idx, handle["ids"])
                    and torch.equal(ref_emb, handle["embeds"]))
