"""Index-only device exchange + transfer-bytes accounting (twin of
``repro.hetero.transfer``, paper §5.2).

The paper's PCIe-minimizing design ships three things and nothing else:

  down (main -> offload): what keeps the offload-resident index coherent and
      the relevancy inputs (token windows for retrieval);
  bulk (main -> offload): whole blocks at once (documents ingested into the
      corpus store);
  up (offload -> main): top-k indices, never the memory itself; retrieved
      payloads (doc tokens, MaC embeddings) are counted apart as spans.

``TransferLedger`` wraps the moves, counted ``.to(device,
non_blocking=True)`` calls, so every exchange is counted. A move to the
tensor's own device copies nothing and is still counted: the bytes describe
the logical link, as the reference counts its no-op same-device puts.
"""
from __future__ import annotations

from typing import Dict

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def pytree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


class TransferLedger:
    def __init__(self):
        self.down_bytes = 0      # per-step index maintenance / query inputs
        self.bulk_bytes = 0      # block shipping (corpus ingest)
        self.up_bytes = 0        # selection indices coming back
        self.span_bytes = 0      # retrieved doc-token / embedding payloads
        self.steps = 0

    @staticmethod
    def combine(ledgers) -> "TransferLedger":
        """Aggregate per-link ledgers: bytes sum, steps are the shared step
        clock (max)."""
        out = TransferLedger()
        for led in ledgers:
            out.down_bytes += led.down_bytes
            out.bulk_bytes += led.bulk_bytes
            out.up_bytes += led.up_bytes
            out.span_bytes += led.span_bytes
            out.steps = max(out.steps, led.steps)
        return out

    # -- counted moves ---------------------------------------------------

    def ship_down(self, tree, device, *, bulk: bool = False):
        n = pytree_bytes(tree)
        if bulk:
            self.bulk_bytes += n
        else:
            self.down_bytes += n
        return _to(tree, device)

    def ship_up(self, tree, device):
        self.up_bytes += pytree_bytes(tree)
        return _to(tree, device)

    def count_span(self, nbytes: int):
        """Retrieved payload returned by the retrieval engine (token spans /
        MaC embeddings): the part of the ``up`` exchange that is data, not
        indices, tracked apart so the index-only comparison stays honest."""
        self.span_bytes += int(nbytes)

    def tick(self):
        self.steps += 1

    # -- analytic comparator -------------------------------------------

    @staticmethod
    def kv_pages_bytes_per_step(cfg, n_sel: int, page: int,
                                batch: int = 1) -> int:
        """Bytes/step a naive design would move: the retrieved K AND V
        pages for every layer (what the index-only exchange avoids)."""
        itemsize = 2  # bf16 cache
        return (cfg.n_layers * batch * n_sel * page *
                cfg.n_kv_heads * cfg.hd * itemsize * 2)

    def as_dict(self, cfg=None, n_sel: int = 0, page: int = 0,
                batch: int = 1) -> Dict:
        d = {
            "down_bytes": int(self.down_bytes),
            "bulk_prefill_bytes": int(self.bulk_bytes),
            "up_bytes": int(self.up_bytes),
            "span_bytes": int(self.span_bytes),
            "steps": int(self.steps),
        }
        if self.steps:
            d["down_bytes_per_step"] = self.down_bytes / self.steps
            d["up_bytes_per_step"] = self.up_bytes / self.steps
        if cfg is not None and n_sel and self.steps:
            kv = self.kv_pages_bytes_per_step(cfg, n_sel, page, batch)
            d["kv_pages_bytes_per_step_avoided"] = kv
            moved = (self.down_bytes + self.up_bytes) / self.steps
            d["exchange_reduction_x"] = kv / max(moved, 1.0)
        return d
