"""Slot + page managers for continuous batching (twin of
``repro.serving.kv_cache``).

``SlotManager`` is the host-side bookkeeping of slot liveness, per-slot
lengths, admission and release. ``PagedKVPool`` is the host-side allocator
over the device tensors of the paged KV pool (``models.make_page_pool``):
slots reserve ``ceil((prompt + max_new) / page_size)`` pages at admission and
give them back at release. Physical page 0 is the permanent zero page:
unallocated table entries point at it and freed pages are scrubbed back to
zero, which is what makes pooled decode match per-request decode.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Slot:
    request_id: Optional[int] = None
    length: int = 0
    generated: int = 0
    max_new: int = 0
    done: bool = True


class SlotManager:
    def __init__(self, n_slots: int, max_len: int):
        self.n_slots = n_slots
        self.max_len = max_len
        self.slots: List[Slot] = [Slot() for _ in range(n_slots)]

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.done]

    def admit(self, request_id: int, prompt_len: int,
              max_new: int) -> Optional[int]:
        free = self.free_slots()
        if not free or prompt_len + max_new > self.max_len:
            return None
        i = free[0]
        self.slots[i] = Slot(request_id, prompt_len, 0, max_new, False)
        return i

    def step(self, live_mask: np.ndarray):
        """Advance all live slots by one generated token."""
        for i, s in enumerate(self.slots):
            if not s.done and live_mask[i]:
                s.length += 1
                s.generated += 1
                if s.generated >= s.max_new or s.length >= self.max_len:
                    s.done = True

    def live_mask(self) -> np.ndarray:
        return np.asarray([not s.done for s in self.slots])

    def lengths(self) -> np.ndarray:
        return np.asarray([s.length for s in self.slots], np.int32)

    def utilization(self) -> float:
        return 1.0 - len(self.free_slots()) / self.n_slots


class PagedKVPool:
    """Host-side page allocator over the device tensors of a paged KV pool.

    ``device`` holds ``{k_pages, v_pages, page_table, lengths}``; this class
    owns the free list and the authoritative host page table.
    """

    def __init__(self, cfg, n_slots: int, max_len: int, *,
                 page_size: int = 16, total_pages: int = 0, tp: int = 16,
                 device="cuda"):
        from repro_torch.models import model as M

        if max_len % page_size:
            raise ValueError(f"max_len {max_len} % page_size {page_size} != 0")
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        # +1 for the reserved zero page 0; 0 -> full backing
        full = n_slots * self.pages_per_slot + 1
        self.total_pages = total_pages or full
        if self.total_pages < 2:
            raise ValueError("need at least one allocatable page")
        self.device = M.make_page_pool(cfg, n_slots, max_len,
                                       page_size=page_size,
                                       total_pages=self.total_pages, tp=tp,
                                       device=device)
        self.table = np.zeros((n_slots, self.pages_per_slot), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(n_slots)]
        # LIFO free list; page 0 is never handed out
        self.free: List[int] = list(range(self.total_pages - 1, 0, -1))
        # bumped on every host-table push; the engine keys its sliced
        # table-view cache on it
        self.table_version = 0

    def pages_needed(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))

    def can_alloc(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= len(self.free)

    def alloc(self, slot: int, n_tokens: int) -> bool:
        """Reserve pages for ``n_tokens`` logical tokens in ``slot``."""
        need = self.pages_needed(n_tokens)
        if need > len(self.free) or need > self.pages_per_slot:
            return False
        if self.owned[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        got = [self.free.pop() for _ in range(need)]
        self.owned[slot] = got
        self.table[slot, :need] = got
        self._push_table()
        return True

    def grow(self, slot: int, n_tokens: int) -> bool:
        """Extend a LIVE slot's reservation to cover ``n_tokens`` logical
        tokens (a retrieval splice needs room for the retrieved payload on
        top of the admission-time reservation). Existing pages are kept;
        False when the arena or the per-slot page table cannot take it."""
        need = self.pages_needed(n_tokens)
        have = len(self.owned[slot])
        if not have:
            raise RuntimeError(f"slot {slot} holds no pages")
        extra = need - have
        if extra <= 0:
            return True
        if extra > len(self.free) or need > self.pages_per_slot:
            return False
        got = [self.free.pop() for _ in range(extra)]
        self.owned[slot].extend(got)
        self.table[slot, have:need] = got
        self._push_table()
        return True

    def release(self, slot: int) -> None:
        """Return a slot's pages to the free list and scrub them to zero
        (in place; the reference zeroes a donated copy)."""
        got = self.owned[slot]
        if not got:
            return
        idx = torch.as_tensor(got, dtype=torch.long,
                              device=self.device["k_pages"].device)
        self.device["k_pages"][:, idx] = 0
        self.device["v_pages"][:, idx] = 0
        self.free.extend(reversed(got))
        self.owned[slot] = []
        self.table[slot] = 0
        self._push_table()

    def _push_table(self) -> None:
        # a copy: on the CPU as_tensor would alias the host table
        self.device["page_table"] = torch.tensor(
            self.table, device=self.device["k_pages"].device)
        self.table_version += 1

    def shard_owners(self, n_shards: int) -> np.ndarray:
        """Logical page -> owning offload shard, [pages_per_slot]: the
        sharded executor cuts the token space into ``n_shards`` contiguous
        windows, so page ``p`` belongs to ``p // (pages_per_slot //
        n_shards)``; its ingest windows agree with this map."""
        if self.pages_per_slot % n_shards:
            raise ValueError(f"{self.pages_per_slot} pages per slot do not "
                             f"split into {n_shards} shards")
        return np.repeat(np.arange(n_shards),
                         self.pages_per_slot // n_shards)

    def shard_table_view(self, n_shards: int, shard: int) -> np.ndarray:
        """The part of every slot's page table that ``shard`` owns:
        [n_slots, pages_per_slot // n_shards] physical page ids (0, the
        zero page, where nothing is allocated)."""
        return self.table[:, self.shard_owners(n_shards) == shard]

    def pages_in_use(self) -> int:
        return sum(len(o) for o in self.owned)

    def n_free(self) -> int:
        return len(self.free)

    def tokens_capacity(self) -> int:
        return (self.total_pages - 1) * self.page_size
