"""Paged continuous-batching engine with the memory pipeline (twin of
``repro.serving.engine``).

* Requests enter through ``submit(Request)``; ``poll`` admits from the queue
  (short prompts batched per pow2 length bucket, long prompts in chunks
  interleaved with decode), runs one pooled decode step and routes the
  emitted tokens into their ``ResponseHandle``s.
* Every slot decodes at its own RoPE position, cache offset and attention
  mask over the paged KV pool; the decode view covers the longest live slot,
  bucketed to pow2 multiples of the alignment granule.
* The paper's dynamic fallback: the reference takes a traced ``lax.cond`` on
  the max over the slots' lengths; here the host holds those lengths and
  picks the branch itself (``placement.use_sparse``), dense attention below
  ``min_context`` and the sparse method's pipeline inside the window: DSA
  and SeerAttention-R through the relevancy-top-k and paged decode
  attention kernels, LServe through the page-min/max and paged decode
  attention kernels.
* ``ServeConfig(retrieval=RetrievalConfig(...))`` adds the retrieval service
  (``repro_torch.retrieval``): dynamic RAG over a BM25 corpus store (the
  BM25 kernel) or MaC memory banks, FLARE/DRAGIN triggers per slot after
  each decode step, retrieved payloads spliced through chunked extend.
* ``ServeConfig(offload_cfg=OffloadConfig(mode="sync"|"overlap"))`` routes
  the memory-processing stages through the hetero offload executor
  (``repro_torch.hetero``): lookahead selection on the offload side (a
  second card, or a CUDA stream of its own), overlapped with decode,
  exchanging page indices only; ``shards=N`` cuts the offload side into N
  KV-sequence shards (``hetero.sharded``), ``main_mesh=N`` runs the apply
  sequence-parallel over a device mesh (``distributed.topk``).
* ``Engine(devices=...)`` pins the engine to a fleet replica's device group
  (``serving.router``): the first device is main, the rest serve the
  offload and retrieval side.
* ``ServeConfig(fused_steps=K)`` runs up to K decode steps per host
  dispatch (``serving/fused.py``), replayed as CUDA graphs on the card,
  with or without retrieval and offload.
* The pool serves the transformer families (``POOL_FAMILIES``: dense, moe,
  audio, vlm). ``ServeConfig(paged=False)`` keeps the legacy dense pool
  (``n_slots x max_len`` caches, the shared ``lengths.max()`` watermark as
  every slot's length), the reference's benchmark baseline. ``generate``
  serves what the pool cannot (the hybrid and ssm families, ``paged=False``,
  prompts too long for the pool, a pool already mid-flight) through the
  batched dense-cache loop, as the reference does.

The pool is updated in place; the reference donates the pool buffers to its
jitted steps instead (``repro/serving/engine.py:342-356``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, MemoryConfig
from repro_torch.core import placement
from repro_torch.core.methods import get_sparse_method, sparse_kwargs
from repro_torch.models import model as M
from repro_torch.serving import fused as F
from repro_torch.serving.api import Request, ResponseHandle
from repro_torch.serving.events import StepEvents
from repro_torch.serving.kv_cache import PagedKVPool, SlotManager

POOL_FAMILIES = ("dense", "moe", "audio", "vlm")


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass
class OffloadConfig:
    """Heterogeneous-offload topology as one nested config
    (``ServeConfig(offload_cfg=OffloadConfig(...))``).

    mode       "off" = inline sparse pipeline; "sync" = two-phase
               select -> apply on the offload side, serialized; "overlap" =
               double-buffered lookahead selection overlapped with decode
               (the paper's heterogeneous execution).
    validate   replay each consumed selection and check it bit for bit.
    shards     >1 = one offload side per KV-sequence shard
               (``hetero.sharded``), index-only candidate merge.
    main_mesh  >1 = an N-device main mesh running the apply phase
               sequence-parallel (clamped to a divisor of N that fits the
               distinct devices, one on one card). Composes with shards.
    """
    mode: str = "off"
    validate: bool = False
    shards: int = 1
    main_mesh: int = 1

    def __post_init__(self):
        if self.mode not in ("off", "sync", "overlap"):
            raise ValueError(
                f"offload mode must be 'off', 'sync' or 'overlap', "
                f"got {self.mode!r}")
        if self.shards < 1:
            raise ValueError(f"offload shards must be >= 1, "
                             f"got {self.shards}")
        if self.main_mesh < 1:
            raise ValueError(f"main_mesh must be >= 1, got {self.main_mesh}")
        if self.mode == "off" and (self.shards > 1 or self.main_mesh > 1):
            raise ValueError("shards/main_mesh need "
                             "OffloadConfig(mode='sync'|'overlap')")


@dataclasses.dataclass
class ServeConfig:
    """The reference's fields. The port serves the paged pool, stepped or
    fused (``fused_steps``), with or without retrieval and the hetero
    offload (``offload_cfg``: sharded selection, a main mesh), and the
    legacy dense pool (``paged=False``).

    ``offload_cfg`` is the offload topology's surface; the flat
    ``offload`` / ``offload_validate`` / ``offload_shards`` / ``main_mesh``
    fields are deprecated aliases that warn when set. Flat non-default
    values win; otherwise the nested config fills the flat fields, and
    ``dataclasses.replace`` on either surface keeps the two in step."""
    max_len: int = 4096
    n_slots: int = 8
    method: str = "none"       # none | dsa | seer | lserve
    tp: int = 16
    page: int = 16             # dsa micro-page size
    greedy: bool = True
    paged: bool = True         # False = legacy dense pool + watermark
    kv_page_size: int = 16     # physical KV page (pool granule)
    pool_pages: int = 0        # 0 = full backing; else arena size
    prefill_chunk: int = 128   # chunk span for chunked prefill
    chunk_threshold: int = 512 # prompts longer than this prefill in chunks
    view_buckets: bool = True  # size the decode view by max live length
    offload: str = "off"
    offload_validate: bool = False
    offload_shards: int = 1
    main_mesh: int = 1
    retrieval: Optional[object] = None   # retrieval.RetrievalConfig
    offload_cfg: Optional[OffloadConfig] = None
    # decode steps per host dispatch (serving/fused.py); 1 = stepped loop
    fused_steps: int = 1

    _FLAT_OFFLOAD_DEFAULT = ("off", False, 1, 1)

    def __post_init__(self):
        flat = (self.offload, self.offload_validate, self.offload_shards,
                self.main_mesh)
        if self.offload_cfg is not None and flat == self._FLAT_OFFLOAD_DEFAULT:
            oc = self.offload_cfg
            self.offload = oc.mode
            self.offload_validate = oc.validate
            self.offload_shards = oc.shards
            self.main_mesh = oc.main_mesh
        else:
            nested = None if self.offload_cfg is None else (
                self.offload_cfg.mode, self.offload_cfg.validate,
                self.offload_cfg.shards, self.offload_cfg.main_mesh)
            if flat != self._FLAT_OFFLOAD_DEFAULT and nested != flat:
                # an explicitly set flat kwarg (not the mirror of a coherent
                # nested config carried through replace())
                warnings.warn(
                    "flat ServeConfig offload kwargs (offload=, "
                    "offload_validate=, offload_shards=, main_mesh=) are "
                    "deprecated; use ServeConfig(offload_cfg="
                    "OffloadConfig(mode=..., validate=..., shards=..., "
                    "main_mesh=...))", DeprecationWarning, stacklevel=3)
            # (re)derive the nested view; this validates the flat fields
            self.offload_cfg = OffloadConfig(
                mode=self.offload, validate=self.offload_validate,
                shards=self.offload_shards, main_mesh=self.main_mesh)
        if self.fused_steps < 1:
            raise ValueError(
                f"fused_steps must be >= 1, got {self.fused_steps}")
        if self.fused_steps > 1 and not self.paged:
            raise ValueError("fused_steps > 1 fuses the PAGED decode loop "
                             "(ServeConfig(paged=True))")


def _check_supported(cfg: ArchConfig, sc: ServeConfig) -> None:
    if sc.offload != "off":
        if sc.method not in ("dsa", "seer", "lserve"):
            raise ValueError("hetero offload needs a sparse memory-"
                             "processing method (dsa | seer | lserve)")
        if not sc.paged or cfg.family not in POOL_FAMILIES:
            raise ValueError("hetero offload runs over the paged pool of a "
                             f"transformer family ({POOL_FAMILIES})")
    if sc.retrieval is not None and (not sc.paged
                                     or cfg.family not in POOL_FAMILIES):
        raise ValueError("the retrieval subsystem serves the paged pool of "
                         f"a transformer family ({POOL_FAMILIES})")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class Engine:
    def __init__(self, cfg: ArchConfig, params, sc: ServeConfig, *,
                 seed: int = 0, mem: Optional[MemoryConfig] = None,
                 device="cuda", sparse_params=None, retrieval_params=None,
                 devices=None):
        """``params`` from ``models.init_params`` or
        ``weights.from_jax_params``. ``sparse_params`` (the method's
        per-layer weights: DSA's indexer, Seer's gates) and
        ``retrieval_params`` (MaC's projections, for
        ``RetrievalConfig(kind="mac")``) default to their inits at
        ``seed``; pass the reference engine's to compare the two.
        ``devices`` pins the engine to a device group (a fleet replica's,
        ``hetero.policy.pick_devices_replicas``): the engine runs on its
        first device, the offload and retrieval side on the rest (on the
        first too when the group has one). Tensors already on the device
        are not copied, so replicas on one card share the weights."""
        _check_supported(cfg, sc)
        self.devices = None if devices is None else tuple(
            torch.device(d) for d in devices)
        self.device = resolve_device(
            device if self.devices is None else self.devices[0])
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.mem = mem or cfg.memory.replace(method=sc.method)
        # the sparse pipeline needs the view page-aligned (LServe: whole
        # physical pages), the pool kv-page aligned
        gran = 1 if sc.method == "none" else max(
            sc.page, self.mem.block_size,
            self.mem.block_size * self.mem.pages_per_physical
            if sc.method == "lserve" else 1)
        gran = math.lcm(gran, sc.kv_page_size if sc.paged else 1)
        # every offload shard's window covers whole selection and kv pages
        gran *= max(sc.offload_shards, 1)
        # pow2-bucketed views are multiples of the granule: with the
        # REQUESTED mesh folded in, every view splits into main_mesh shards
        # of whole pages (distributed_paged_sparse_decode's contract)
        gran *= max(sc.main_mesh, 1)
        if sc.max_len % gran:
            sc = dataclasses.replace(
                sc, max_len=((sc.max_len + gran - 1) // gran) * gran)
        self.sc = sc
        self._gran = gran
        self.sparse_params = None
        self._sparse_fn = None
        if sc.method != "none" and cfg.family != "ssm":
            # the hybrid: one set for the shared block, used at every site
            init_fn, mk = get_sparse_method(sc.method)
            self.sparse_params = _to_device(
                sparse_params if sparse_params is not None
                else init_fn(cfg, self.mem, seed,
                             stacked=cfg.family != "hybrid",
                             device=self.device),
                self.device)
            self._sparse_fn = mk(cfg, self.mem, tp=sc.tp,
                                 **sparse_kwargs(sc.method, sc.page))
        exec_devs = self._layout_devices()
        self.hetero = None
        if sc.offload != "off":
            from repro_torch.hetero import (HeteroExecutor,
                                            ShardedHeteroExecutor)
            kw = dict(mode=sc.offload, validate=sc.offload_validate,
                      device=self.device, main_mesh=self.main_mesh)
            if sc.offload_shards > 1:
                self.hetero = ShardedHeteroExecutor(
                    cfg, self.mem, self.sc, self.sparse_params,
                    n_shards=sc.offload_shards, devices=exec_devs, **kw)
            else:
                self.hetero = HeteroExecutor(
                    cfg, self.mem, self.sc, self.sparse_params,
                    devices=exec_devs, **kw)
        self.retrieval = None
        if sc.retrieval is not None:
            from repro_torch.retrieval import RetrievalExecutor
            rdevs = self.hetero.devices if self.hetero is not None else None
            if rdevs is None and exec_devs is not None:
                off = exec_devs[1]
                rdevs = (exec_devs[0],
                         off[0] if isinstance(off, tuple) else off)
            self.retrieval = RetrievalExecutor(
                cfg, self.sc, sc.retrieval, self.params,
                mac_params=retrieval_params, seed=seed, device=self.device,
                devices=rdevs)

        self.slots = SlotManager(sc.n_slots, sc.max_len)
        self.pool: Optional[PagedKVPool] = None
        self.caches = None            # the legacy dense pool
        # chunked-prefill state, admission prompts and retrieval splices:
        # slot -> [request_id, payload (tokens or embedding rows), next_pos,
        # is_embeddings]
        self._chunks: Dict[int, list] = {}
        self._table_view_cache = None  # ((npv, table_version), view)
        # host_steps: host dispatches of the decode loop; decode_steps /
        # sparse_steps: the device steps behind them that ran (all / the
        # sparse branch); device_steps / sparse_device_steps: the steps the
        # device computed, with a fused window's masked no-op steps and its
        # graph's warm-up; step_s: wall seconds of the latest decode steps
        # (a window's wall less a capture in it, spread over its steps;
        # bounded); window_s: the
        # walls of the fused windows; bucket_prefills: admission prefills
        # run (one per length bucket); graph_captures / graph_capture_s:
        # CUDA graphs captured, and the seconds their warm-ups and captures
        # took; dense_prefills: unpaged prefills (the legacy pool's
        # admissions, the batched loop's)
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0,
                      "host_steps": 0, "decode_steps": 0, "sparse_steps": 0,
                      "device_steps": 0, "sparse_device_steps": 0,
                      "bucket_prefills": 0, "dense_prefills": 0,
                      "graph_captures": 0,
                      "graph_capture_s": 0.0,
                      "step_s": collections.deque(maxlen=4096),
                      "window_s": collections.deque(maxlen=4096)}
        self._runner = F.GraphRunner(self.device, self.stats)
        # logits of the latest decode step and whether it took the sparse
        # branch (read by chip_smoke's kernel-vs-plain comparison)
        self.last_logits: Optional[torch.Tensor] = None
        self.last_sparse = False

        self.prefill_token_budget = 2048   # per-poll admission budget
        self.queue: collections.deque = collections.deque()
        self._handles: Dict[int, ResponseHandle] = {}
        self._inflight_h: Dict[int, ResponseHandle] = {}
        self.done: Dict[int, ResponseHandle] = {}
        self._auto_rid = 0                 # generate() uses negative rids
        self._polled_prefill = False

    def _layout_devices(self):
        """The main mesh (``self.main_mesh``) and the executors' placement:
        None (the policies' defaults), or (main, offload) with a tuple of
        offload devices under sharding. The mesh picks its own devices, so
        it does not compose with a replica's ``devices``."""
        sc = self.sc
        self.main_mesh = None
        if sc.main_mesh > 1:
            if self.devices is not None:
                raise ValueError(
                    "Engine(devices=...) pins a replica's device group; it "
                    "does not compose with main_mesh, which picks its own "
                    "devices (hetero.policy.pick_devices_mesh)")
            from repro_torch.hetero.policy import pick_devices_mesh
            from repro_torch.launch.mesh import mesh_from_devices
            mains, offs = pick_devices_mesh(
                sc.main_mesh, max(sc.offload_shards, 1), device=self.device)
            self.main_mesh = mesh_from_devices(mains)
            return mains[0], offs if sc.offload_shards > 1 else offs[0]
        if self.devices is None:
            return None
        # a replica's group: main first, the offload side round-robin over
        # the rest (over the whole group when it holds one device)
        pool = self.devices[1:] or self.devices
        if sc.offload_shards > 1:
            return self.devices[0], tuple(pool[i % len(pool)]
                                          for i in range(sc.offload_shards))
        return self.devices[0], pool[0]

    # ------------------------------------------------------------------
    # request-level serving API (submit / poll / drain)
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> ResponseHandle:
        """Enqueue one :class:`Request`; admission happens inside ``poll``."""
        if not isinstance(req, Request):
            raise TypeError(
                f"submit() takes a serving.Request, got {type(req)!r}")
        if req.rid in self._handles and not self._handles[req.rid].done:
            raise ValueError(f"request id {req.rid} already in flight")
        h = ResponseHandle(req)
        self._handles[req.rid] = h
        self.queue.append(req)
        return h

    def queue_depth(self) -> int:
        return len(self.queue)

    def busy(self) -> bool:
        return bool(self.queue or self._inflight_h)

    def _next_rid(self) -> int:
        self._auto_rid -= 1
        return self._auto_rid

    def _mark_admitted(self, req: Request) -> None:
        h = self._handles[req.rid]
        h.admitted = time.perf_counter()
        self._inflight_h[req.rid] = h

    def _admit_from_queue(self) -> None:
        """FCFS batch admission within the per-poll prefill token budget:
        short prompts admit together (one bucketed prefill per bucket),
        long prompts switch to chunked mode, rejections re-queue at the
        FRONT."""
        if not self.queue:
            return
        budget = self.prefill_token_budget
        batch: List[Request] = []
        while self.queue and budget > 0:
            req = self.queue[0]
            plen = len(req)
            if self.sc.paged and req.override(
                    "chunked", plen > self.sc.chunk_threshold):
                if not self._admit_chunked(req.rid, req.tokens, req.max_new,
                                           retrieval=req.retrieval):
                    break
                self.queue.popleft()
                self._mark_admitted(req)
                continue
            if batch and plen > budget:
                break
            batch.append(req)
            self.queue.popleft()
            budget -= plen
        if not batch:
            return
        oks = self._admit_many([(r.rid, r.tokens, r.max_new) for r in batch],
                               retrieval=[r.retrieval for r in batch])
        for r, ok in zip(reversed(batch), reversed(oks)):
            if ok:
                self._mark_admitted(r)
            else:
                self.queue.appendleft(r)

    def _dispatch(self, ev: StepEvents) -> None:
        now = time.perf_counter()
        for rid, _slot, tok in ev.emissions:
            h = self._inflight_h.get(rid)
            if h is None:
                continue
            if h.first_token_t is None:
                h.first_token_t = now
            h.tokens.append(int(tok))
            if len(h.tokens) >= h.request.max_new:
                h.finished = now
                self.done[rid] = h
                del self._inflight_h[rid]

    def poll(self) -> StepEvents:
        """One serving turn: admit, advance chunked prefill, one pooled
        decode step, route the emissions."""
        self._ensure_pool()
        self._admit_from_queue()
        self._polled_prefill = bool(self.has_prefill_work()
                                    and self.prefill_step())
        ev = self.step_pool()
        self._dispatch(ev)
        return ev

    def drain(self, max_steps: int = 10_000) -> Dict[int, ResponseHandle]:
        """Pump ``poll`` until queue and pool are empty (or the head request
        can never admit); returns completed handles by rid."""
        steps = 0
        while (self.queue or self._inflight_h) and steps < max_steps:
            ev = self.poll()
            steps += max(1, ev.steps)
            if not ev and not self._polled_prefill:
                if self.has_retrieval_work() or self.has_prefill_work():
                    continue   # retrieval in flight, or a splice chunk
                               # was queued during this step's decode
                if not self.queue or not self._inflight_h:
                    break      # idle, or the head request can never admit
        return dict(self.done)

    def throughput_tokens_per_s(self) -> float:
        if not self.done:
            return 0.0
        toks = sum(len(h.tokens) for h in self.done.values())
        t0 = min(h.submitted for h in self.done.values())
        t1 = max(h.finished for h in self.done.values())
        return toks / max(t1 - t0, 1e-9)

    def generate(self, prompts, max_new: int) -> np.ndarray:
        """prompts [B, S] -> generated [B, max_new] (greedy).

        Each row becomes a :class:`Request` through ``submit`` + ``drain``
        on the paged pool. What the pool cannot serve (the hybrid and ssm
        families, ``paged=False``, prompts that do not fit, a pool already
        mid-flight) takes the batched dense-cache loop
        (``_generate_batched``) instead, as in the reference; the pooled
        streams equal that loop's."""
        prompts_np = np.asarray(prompts)
        B, S = prompts_np.shape
        poolable = (self.sc.paged and self.cfg.family in POOL_FAMILIES
                    and S + max_new <= self.sc.max_len
                    and not self.busy()
                    and not self.slots.live_mask().any())
        if not poolable:
            return self._generate_batched(prompts_np, max_new)
        handles = [self.submit(Request(self._next_rid(), row, max_new,
                                       retrieval=False))
                   for row in prompts_np]
        self.drain()
        for h in handles:
            self.done.pop(h.rid, None)
            self._handles.pop(h.rid, None)
        if not all(h.done for h in handles):
            raise RuntimeError(f"requests did not complete: "
                               f"{[h.rid for h in handles if not h.done]}")
        return np.stack([np.asarray(h.tokens, np.int32) for h in handles])

    # ------------------------------------------------------------------
    # the unpaged path: the batched dense-cache loop, the legacy pool
    # ------------------------------------------------------------------

    def _prefill(self, tokens: torch.Tensor):
        """Unpaged prefill of tokens [B, S] -> (logits [B, V], caches padded
        to ``max_len``)."""
        self.stats["dense_prefills"] += 1
        return M.prefill(self.params, self.cfg, tokens,
                         max_len=self.sc.max_len, tp=self.sc.tp)

    def _decode(self, tok: torch.Tensor, caches):
        """One unpaged decode step at ``caches["length"]``; the reference's
        fallback cond on that (batch-level) length, decided on the host.
        Returns (logits, caches)."""
        sparse = self._sparse_at(int(caches["length"]) + 1)
        logits, caches = M.decode_step(
            self.params, self.cfg, tok, caches, tp=self.sc.tp,
            sparse_fn=self._sparse_fn if sparse else None,
            sparse_params=self.sparse_params)
        self._count_steps(1, 1, sparse)
        self.last_logits, self.last_sparse = logits, sparse
        return logits, caches

    def _generate_batched(self, prompts, max_new: int) -> np.ndarray:
        """The batched dense-cache loop: one prefill of the whole batch,
        then ``max_new`` greedy decode steps at the shared length."""
        dev = self.device
        t0 = time.perf_counter()
        logits, caches = self._prefill(
            torch.as_tensor(np.asarray(prompts), device=dev).long())
        tok = logits.argmax(-1)
        self.stats["prefill_s"] += time.perf_counter() - t0
        out = []
        t0 = time.perf_counter()
        for _ in range(max_new):
            out.append(tok)
            t1 = time.perf_counter()
            logits, caches = self._decode(tok, caches)
            tok = logits.argmax(-1)
            self.stats["step_s"].append(time.perf_counter() - t1)
        gen = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["tokens"] += gen.size
        return gen

    def _step_pool_dense(self) -> StepEvents:
        """The legacy pool's decode step: every slot at the shared watermark
        ``lengths.max()`` (a short slot attends over the zero rows up to the
        longest slot's length, and the fallback cond sees the watermark,
        not true lengths), dead slots included; the reference's
        behaviour."""
        live = self.slots.live_mask()
        if not live.any():
            return StepEvents()
        lengths = self.slots.lengths()
        self.caches = dict(self.caches, length=int(lengths.max()))
        t0 = time.perf_counter()
        tok = torch.as_tensor(self._pending, device=self.device).long()
        logits, self.caches = self._decode(tok, self.caches)
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["decode_s"] += dt
        self.stats["step_s"].append(dt)
        ev = StepEvents(steps=1)
        for i in np.flatnonzero(live):
            rid = self.slots.slots[i].request_id
            ev.emissions.append((rid, int(i), int(self._pending[i])))
            self._pending[i] = nxt[i]
        self.stats["tokens"] += len(ev.emissions)
        self.slots.step(live)
        for i in np.flatnonzero(live):
            if self.slots.slots[i].done:
                ev.finished.append(int(i))
        return ev

    def _admit_one(self, request_id: int, prompt: np.ndarray,
                   max_new: int) -> bool:
        """The legacy pool's admission: prefill one prompt and splice its
        cache (zero-padded to ``max_len``) into the slot."""
        slot = self.slots.admit(request_id, len(prompt), max_new)
        if slot is None:
            return False
        t0 = time.perf_counter()
        logits, c1 = self._prefill(torch.as_tensor(
            np.array(prompt, np.int64), device=self.device)[None])
        self.caches["k"][:, slot] = c1["k"][:, 0]
        self.caches["v"][:, slot] = c1["v"][:, 0]
        self._pending[slot] = int(logits[0].argmax())
        self.stats["prefill_s"] += time.perf_counter() - t0
        return True

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _ensure_pool(self):
        if self.pool is not None or self.caches is not None:
            return
        if self.cfg.family not in POOL_FAMILIES:
            raise ValueError(
                f"continuous batching needs KV caches: the "
                f"{self.cfg.family!r} family serves through generate()")
        if self.sc.paged:
            self.pool = PagedKVPool(
                self.cfg, self.sc.n_slots, self.sc.max_len,
                page_size=self.sc.kv_page_size,
                total_pages=self.sc.pool_pages, tp=self.sc.tp,
                device=self.device)
        else:
            self.caches = M.make_cache(self.cfg, self.sc.n_slots,
                                       self.sc.max_len, tp=self.sc.tp,
                                       device=self.device)
        self._pending = np.zeros((self.sc.n_slots,), np.int32)

    def _bucket_len(self, prompt_len: int) -> int:
        ps = self.sc.kv_page_size
        b = _next_pow2(max(prompt_len, ps))
        b = ((b + ps - 1) // ps) * ps
        return min(b, self.sc.max_len)

    def _admit_many(self, requests: List[Tuple[int, np.ndarray, int]],
                    retrieval: Optional[List] = None) -> List[bool]:
        """Admit a batch of (request_id, prompt, max_new): one bucketed
        prefill per distinct bucket length. ``retrieval[i]`` opts request i
        in or out of the retrieval service (None: on when configured)."""
        self._ensure_pool()
        if not self.sc.paged:
            return [self._admit_one(rid, np.asarray(p), mn)
                    for rid, p, mn in requests]
        admitted: Dict[int, List] = {}   # bucket_len -> [(slot, prompt)]
        ok: List[bool] = []
        for i, (rid, prompt, max_new) in enumerate(requests):
            prompt = np.asarray(prompt)
            total = len(prompt) + max_new
            if total > self.sc.max_len or not self.pool.can_alloc(total):
                ok.append(False)
                break                    # FCFS: later requests wait too
            slot = self.slots.admit(rid, len(prompt), max_new)
            if slot is None:
                ok.append(False)
                break
            self.pool.alloc(slot, total)
            admitted.setdefault(self._bucket_len(len(prompt)), []).append(
                (slot, prompt))
            ok.append(True)
            if self.retrieval is not None:
                self.retrieval.on_admit(
                    slot, prompt,
                    retrieval[i] if retrieval is not None else None)
        ok.extend([False] * (len(requests) - len(ok)))
        t0 = time.perf_counter()
        for Sb, group in admitted.items():
            self._prefill_bucket(Sb, group)
        self.stats["prefill_s"] += time.perf_counter() - t0
        return ok

    def _prefill_bucket(self, Sb: int, group: List[Tuple[int, np.ndarray]]):
        """One prefill over a length bucket + one page splice."""
        ps = self.sc.kv_page_size
        B = len(group)
        toks = np.zeros((B, Sb), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, (_, prompt) in enumerate(group):
            toks[i, : len(prompt)] = prompt
            lens[i] = len(prompt)
        dev = self.device
        out = M.prefill_bucketed(
            self.params, self.cfg, torch.as_tensor(toks, device=dev),
            torch.as_tensor(lens, device=dev), tp=self.sc.tp,
            collect_q=self.hetero is not None)
        logits, k, v = out[:3]
        if self.hetero is not None:
            self.hetero.on_admit([slot for slot, _ in group], k, lens, out[3])
        self.stats["bucket_prefills"] += 1
        n_pages = Sb // ps
        dest = np.stack([self.pool.table[slot, :n_pages]
                         for slot, _ in group]).reshape(-1)
        # k/v [L, B, Sb, KV, hd] -> pages [L, B*n_pages, ps, KV, hd]; entries
        # past a slot's reservation point at page 0 and carry zeros
        dest_t = torch.as_tensor(dest, dtype=torch.long, device=dev)
        Lc = k.shape[0]
        self.pool.device["k_pages"][:, dest_t] = k.reshape(
            Lc, B * n_pages, ps, *k.shape[3:])
        self.pool.device["v_pages"][:, dest_t] = v.reshape(
            Lc, B * n_pages, ps, *v.shape[3:])
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()
        for i, (slot, _) in enumerate(group):
            self._pending[slot] = nxt[i]

    def _admit_chunked(self, request_id: int, prompt: np.ndarray,
                       max_new: int, retrieval: Optional[bool] = None
                       ) -> bool:
        """Allocate slot + pages now; ``prefill_step`` streams the prompt in
        ``prefill_chunk`` spans interleaved with decode."""
        self._ensure_pool()
        prompt = np.asarray(prompt)
        total = len(prompt) + max_new
        if total > self.sc.max_len or not self.pool.can_alloc(total):
            return False
        slot = self.slots.admit(request_id, len(prompt), max_new)
        if slot is None:
            return False
        self.pool.alloc(slot, total)
        self.slots.slots[slot].length = 0      # grows as chunks land
        self._chunks[slot] = [request_id, prompt, 0, False]
        if self.hetero is not None:
            self.hetero.on_admit_slot(slot)
        if self.retrieval is not None:
            self.retrieval.on_admit(slot, prompt, retrieval)
        return True

    def has_prefill_work(self) -> bool:
        return bool(self._chunks)

    def prefill_step(self) -> bool:
        """Advance every mid-prefill slot by one chunk: admission prompts
        and retrieval splices alike (retrieved documents / MaC embeddings
        take the same chunked extend under the same budget). Returns True
        if any chunk work was done."""
        if not self._chunks:
            return False
        self._ensure_pool()
        C = self.sc.prefill_chunk
        n = self.sc.n_slots
        toks = np.zeros((n, C), np.int32)
        n_valid = np.zeros((n,), np.int32)
        emb_rows = np.zeros((n,), bool)
        x_embeds = None
        for slot, (_rid, payload, pos, is_emb) in self._chunks.items():
            take = min(C, len(payload) - pos)
            if is_emb:
                if x_embeds is None:
                    x_embeds = np.zeros((n, C, self.cfg.d_model), np.float32)
                x_embeds[slot, :take] = payload[pos: pos + take]
                emb_rows[slot] = True
            else:
                toks[slot, :take] = payload[pos: pos + take]
            n_valid[slot] = take
        lengths = np.asarray([s.length for s in self.slots.slots], np.int32)
        lengths = np.where(n_valid > 0, lengths, 0)
        t0 = time.perf_counter()
        dev = self.device
        pool = dict(self.pool.device,
                    page_table=self._table_view(lengths, extra=C),
                    lengths=torch.as_tensor(lengths, device=dev))
        emb = {} if x_embeds is None else {
            "x_embeds": torch.as_tensor(x_embeds, device=dev),
            "emb_rows": torch.as_tensor(emb_rows, device=dev)}
        out = M.extend_paged(self.params, self.cfg,
                             torch.as_tensor(toks, device=dev), pool,
                             torch.as_tensor(n_valid, device=dev),
                             tp=self.sc.tp,
                             collect_kq=self.hetero is not None, **emb)
        nxt = out[0].argmax(-1).to(torch.int32).cpu().numpy()
        self.stats["prefill_s"] += time.perf_counter() - t0
        finished: List[int] = []   # slots whose payload (admission prompt
        for slot in list(self._chunks):          # or splice) completed
            _rid, payload, pos, _is_emb = self._chunks[slot]
            take = int(n_valid[slot])
            self.slots.slots[slot].length += take
            if pos + take >= len(payload):
                self._pending[slot] = nxt[slot]
                del self._chunks[slot]
                finished.append(slot)
            else:
                self._chunks[slot][2] = pos + take
        if self.hetero is not None:
            # only the finishing slots' lookahead rows go dirty
            self.hetero.on_extend(out[2], out[3], lengths, n_valid, finished)
        return True

    # ------------------------------------------------------------------
    # pooled decode
    # ------------------------------------------------------------------

    def _view_len(self, needed: int) -> int:
        """Logical length of the gathered decode view: enough pages for the
        longest live slot, bucketed to pow2 multiples of the granule."""
        if not self.sc.view_buckets:
            return self.sc.max_len
        g = self._gran
        units = _next_pow2(max(1, -(-needed // g)))
        return min(g * units, self.sc.max_len)

    def _table_view(self, lengths: np.ndarray, extra: int = 1):
        """Page table restricted to the bucketed view length, cached on
        (view pages, pool.table_version)."""
        needed = int(lengths.max()) + extra if lengths.size else 1
        npv = self._view_len(needed) // self.sc.kv_page_size
        key = (npv, self.pool.table_version)
        if self._table_view_cache is None or self._table_view_cache[0] != key:
            view = self.pool.device["page_table"][:, :npv].long().contiguous()
            self._table_view_cache = (key, view)
        return self._table_view_cache[1]

    def _decode_live(self) -> np.ndarray:
        """Slots that decode this step: live, not mid-prefill, and not
        paused awaiting a retrieval result."""
        live = self.slots.live_mask()
        for slot in self._chunks:
            live[slot] = False
        if self.retrieval is not None:
            live &= ~self.retrieval.waiting_mask()
        return live

    def _sparse_at(self, context: int) -> bool:
        """The branch of a step whose longest live context (this step's
        token included) is ``context``: the reference's fallback cond, on
        the host."""
        return (self._sparse_fn is not None
                and placement.use_sparse(context, self.mem))

    def _fused_window(self) -> int:
        """Width of the next fused decode window; 1 = the stepped loop.
        Windows open only when the host has nothing to interleave: no
        chunked prefill pending and the retrieval service quiescent
        (queries in flight and waiting slots need per-step host turns)."""
        K = self.sc.fused_steps
        if K <= 1 or self._chunks:
            return 1
        if self.retrieval is not None and self.retrieval.busy():
            return 1
        return K

    def _window_budget(self, lmax: int, K: int) -> int:
        """Steps a window entered at longest live length ``lmax`` may run
        before the stepped loop would take the other branch or a wider
        table view (every slot live at entry stays live until the window
        stops, so step j's longest context is lmax + j + 1)."""
        def at(j):
            ctx = lmax + j + 1
            return self._sparse_at(ctx), self._view_len(ctx)
        first = at(0)
        return next((j for j in range(1, K) if at(j) != first), K)

    def step_pool(self) -> StepEvents:
        """One host dispatch of the decode loop: one decode step for every
        live slot, each at its own length, or (``fused_steps`` K > 1) up to
        K steps in one fused window whose event log the host replays."""
        self._ensure_pool()
        if not self.sc.paged:
            return self._step_pool_dense()
        live = self._decode_live()
        if not live.any():
            if self.retrieval is not None:
                self._retrieval_idle()
            return StepEvents()
        K = self._fused_window()
        if K > 1:
            return self._step_pool_fused(live, K)
        lengths = np.where(live, self.slots.lengths(), 0).astype(np.int32)
        sparse = self._sparse_at(int(lengths.max()) + 1)
        dev = self.device
        t0 = time.perf_counter()
        table = self._table_view(lengths)
        tok = torch.as_tensor(self._pending, device=dev)
        if self.hetero is not None:
            logits = self.hetero.decode(self.params, tok, self.pool.device,
                                        table, lengths, live)
        else:
            pool = dict(self.pool.device, page_table=table,
                        lengths=torch.as_tensor(lengths, device=dev))
            logits, _ = M.decode_step_paged(
                self.params, self.cfg, tok, pool,
                torch.as_tensor(live, device=dev), tp=self.sc.tp,
                sparse_fn=self._sparse_fn if sparse else None,
                sparse_params=self.sparse_params)
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()
        dt = time.perf_counter() - t0
        self.last_logits, self.last_sparse = logits, sparse
        self.stats["decode_s"] += dt
        self.stats["step_s"].append(dt)
        self._count_steps(1, 1, sparse)
        ev = StepEvents(steps=1)
        for i in np.flatnonzero(live):
            rid = self.slots.slots[i].request_id
            ev.emissions.append((rid, int(i), int(self._pending[i])))
            if self.retrieval is not None:
                self.retrieval.note_token(int(i), int(self._pending[i]))
            self._pending[i] = nxt[i]
        self.stats["tokens"] += len(ev.emissions)
        self.slots.step(live)
        for i in np.flatnonzero(live):
            if self.slots.slots[i].done:
                ev.finished.append(int(i))
                self.pool.release(int(i))
                if self.retrieval is not None:
                    self.retrieval.on_release(int(i))
        if self.retrieval is not None:
            ev.fired.extend(self._retrieval_step(logits, live, lengths))
        return ev

    def _count_steps(self, ran: int, computed: int, sparse: bool) -> None:
        st = self.stats
        st["host_steps"] += 1
        st["decode_steps"] += ran
        st["sparse_steps"] += ran * sparse
        st["device_steps"] += computed
        st["sparse_device_steps"] += computed * sparse

    # -- fused multi-step decode (serving/fused.py) ---------------------

    def _decode_fused_inline(self, ins, K: int, sparse: bool, trigger):
        fn = F.make_fused_paged(
            self.cfg, self.sc, K=K, trigger=trigger,
            sparse_fn=self._sparse_fn if sparse else None,
            sparse_params=self.sparse_params, params=self.params,
            pool_device=self.pool.device)
        key = ("inline", sparse, int(ins["table"].shape[1]), K, trigger)
        host, _ = self._runner.run(key, fn, ins)
        return F.unpack_host(host, K, self.sc.n_slots)

    def _step_pool_fused(self, live: np.ndarray, K: int) -> StepEvents:
        """Run up to K decode steps in one window, then replay its per-step
        event log through the stepped path's bookkeeping: the same
        emissions, finish order, retrieval launches and pool accounting,
        token for token. The window stops early (masked no-ops; ``nsteps``
        is the real count) when a slot finishes or fires a trigger, handing
        the host the step boundary the stepped loop would have had."""
        sl = self.slots.slots
        lengths = np.where(live, self.slots.lengths(), 0).astype(np.int32)
        gen = np.asarray([s.generated for s in sl], np.int32)
        maxnew = np.asarray([s.max_new for s in sl], np.int32)
        rx = self.retrieval
        if rx is not None:
            armed, arm_after = rx.fused_gates()
            trigger = (rx.rcfg.trigger, rx.rcfg.tau)
        else:
            armed = np.zeros((self.sc.n_slots,), bool)
            arm_after = np.zeros((self.sc.n_slots,), np.int32)
            trigger = None
        lmax = int(lengths.max())
        budget = self._window_budget(lmax, K)
        sparse = self._sparse_at(lmax + 1)
        captures = self.stats["graph_captures"]
        capture_s = self.stats["graph_capture_s"]
        t0 = time.perf_counter()
        ins = {k: torch.as_tensor(np.asarray(a, np.int32)) for k, a in (
            ("tok", self._pending), ("lengths", lengths), ("live", live),
            ("gen", gen), ("maxnew", maxnew), ("armed", armed),
            ("arm_after", arm_after), ("budget", budget))}
        ins["table"] = self._table_view(lengths)
        if self.hetero is not None:
            nsteps, pending, emits, fired = self.hetero.decode_fused(
                self._runner, self.params, self.pool.device, ins, lengths,
                live, K, trigger)
        else:
            nsteps, pending, emits, fired = self._decode_fused_inline(
                ins, K, sparse, trigger)
        self._pending = np.asarray(pending, np.int32).copy()
        dt = time.perf_counter() - t0
        st = self.stats
        st["decode_s"] += dt
        st["window_s"].append(dt)
        # per-step walls of the steady state: a capture's seconds apart
        steady = dt - (st["graph_capture_s"] - capture_s)
        st["step_s"].extend([steady / nsteps] * nsteps)
        # a capture's warm-up computes K (dead) steps too
        self._count_steps(
            nsteps, K * (1 + st["graph_captures"] - captures), sparse)
        self.last_logits, self.last_sparse = None, sparse
        ev = StepEvents(steps=nsteps)
        for j in range(nsteps):
            step_live = emits[j] >= 0
            for i in np.flatnonzero(step_live):
                ev.emissions.append((sl[i].request_id, int(i),
                                     int(emits[j, i])))
                if rx is not None:
                    rx.note_token(int(i), int(emits[j, i]))
            st["tokens"] += int(step_live.sum())
            self.slots.step(step_live)
            for i in np.flatnonzero(step_live):
                if sl[i].done:
                    ev.finished.append(int(i))
                    self.pool.release(int(i))
                    if rx is not None:
                        rx.on_release(int(i))
            if rx is not None:
                rx.tick()
                for job in rx.collect_ready(min_age=1):
                    self._queue_splice(*job)
                for i in np.flatnonzero(fired[j]):
                    if not self._reserve_splice(int(i)):
                        rx.note_suppressed(int(i))
                        continue
                    rx.launch(int(i))
                    ev.fired.append(int(i))
        return ev

    # -- retrieval service hooks (repro_torch.retrieval) ----------------

    def has_retrieval_work(self) -> bool:
        """True while a retrieval is in flight or a slot awaits its result
        (the drain loop must keep stepping an otherwise idle pool)."""
        return self.retrieval is not None and self.retrieval.busy()

    def _retrieval_idle(self) -> None:
        """No decodable slot this step: still age and drain the queries in
        flight, so paused slots get their splice queued."""
        rx = self.retrieval
        rx.tick()
        for job in rx.collect_ready(min_age=1):
            self._queue_splice(*job)

    def _retrieval_step(self, logits, live_np: np.ndarray,
                        lengths_np: np.ndarray) -> List[int]:
        """Post-decode retrieval phase: consume the queries launched on
        earlier steps (the fired slot pauses exactly one step in every
        mode), then evaluate this step's triggers, reserve pages and
        launch. Returns the slots whose queries launched this step."""
        rx = self.retrieval
        rx.tick()
        for job in rx.collect_ready(min_age=1):
            self._queue_splice(*job)
        launched: List[int] = []
        for slot in rx.trigger_slots(logits, live_np, lengths_np,
                                     self.slots.slots):
            if not self._reserve_splice(slot):
                rx.note_suppressed(slot)
                continue
            rx.launch(slot)
            launched.append(slot)
        return launched

    def _reserve_splice(self, slot: int) -> bool:
        """Grow the slot's page reservation for the retrieval upper bound at
        the trigger step, so the pool accounting is the same in every
        mode."""
        s = self.slots.slots[slot]
        need = s.length + self.retrieval.splice_bound() + \
            (s.max_new - s.generated)
        if need > self.sc.max_len:
            return False
        return self.pool.grow(slot, need)

    def _queue_splice(self, slot: int, tokens, embeds, ids) -> None:
        """Queue a retrieved payload for chunked extend; the slot rejoins
        decode once the splice drains, its pending token regenerated from
        the augmented context (FLARE semantics)."""
        payload = tokens if tokens is not None else embeds
        if payload is None or len(payload) == 0:
            return
        s = self.slots.slots[slot]
        self._chunks[slot] = [s.request_id, payload, 0, embeds is not None]
        self.retrieval.note_splice(
            slot, tokens if tokens is not None else len(embeds))
