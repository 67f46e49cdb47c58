"""Fused multi-step decode: up to K decode steps per host dispatch (twin of
``repro.serving.fused``), replayed as CUDA graphs on the card.

The stepped loop pays one host round trip per token: some 40 launches a
layer, then the logits' argmax back to the host. A window runs K steps in
one dispatch instead: decode, greedy sampling, the pool write, the
FLARE/DRAGIN trigger predicate and, under the hetero offload, the
lookahead double buffer (select_{t+1} from the pre-ingest state while
apply_t runs) all stay on the device, and the window's emissions, fired
flags and new pending tokens come back in ONE device-to-host copy at its
end.

Early exit is masked, not structural (the reference wraps its scan body in
``lax.cond(stop, idle, step)``): step j runs with ``live_j = live & ~stop &
(j < budget)``. Once a slot finishes or fires a trigger, ``stop`` is set
and every later step is an exact no-op: its rows are all dead, dead rows
write zeros to the reserved page 0 and emit -1, and no carried state moves.
``nsteps`` reports the steps that ran; the host replays the event log
through the stepped path's bookkeeping, so ``fused(K)`` emits token for
token what K ``step_pool()`` calls emit.

The dense/sparse branch (the reference's traced cond) is decided on the
host: every slot live at entry stays live until the window stops, so the
longest live slot at step j is ``lmax0 + j`` and the host knows the step
at which ``placement.use_sparse`` would flip, and the step at which the
stepped loop's pow2-bucketed table view would widen. The engine sets
``budget`` to the first of those (at most K) and runs the window of that
branch over that view, so every step sees the shapes and the branch the
stepped loop gives it. Window widths may then differ from the reference's;
emissions, fired slots and finish order do not.

On the card each (pipeline, branch, view pages, K, trigger) is captured
once into a ``torch.cuda.CUDAGraph`` (all graphs share one memory pool)
after a warm-up run whose slots are all dead (a real run would write the
pool), and replayed with its static inputs filled from the host. A
failed capture raises: nothing steps eagerly in its place. On the CPU the
same window function runs eagerly; that is the CPU's mode, not a fallback.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import model as M

# inputs that the warm-up run before a capture zeroes: no slot is live and
# no step runs, so the run leaves the pool and every output as they were
IDLE_INPUTS = ("live", "budget")


def _advance(c: Dict, logits, lengths_m, live_j, active, maxnew,
             max_len: int, armed, arm_after, trigger):
    """Post-decode bookkeeping of one window step: greedy sampling,
    emission, slot advance, finish detection, trigger predicate, stop flag.
    Mirrors ``SlotManager.step`` + the engine's retrieval step. Updates
    ``c`` and returns (emit [B], fired [B])."""
    adv = live_j.to(torch.int32)
    nxt = logits.argmax(-1).to(torch.int32)
    emit = torch.where(live_j, c["pending"], torch.full_like(nxt, -1))
    c["pending"] = torch.where(live_j, nxt, c["pending"])
    c["gen"] = c["gen"] + adv
    c["emitted"] = c["emitted"] + adv
    c["lengths"] = c["lengths"] + adv
    fin = live_j & ((c["gen"] >= maxnew) | (c["lengths"] >= max_len))
    if trigger is None:
        fired = torch.zeros_like(live_j)
    else:
        from repro_torch.retrieval.executor import traced_trigger
        pred = traced_trigger(trigger[0], trigger[1], logits, lengths_m)
        # the host gates folded into armed / arm_after (fused_gates)
        fired = pred & live_j & ~fin & armed & (c["emitted"] >= arm_after)
    c["stop"] = c["stop"] | fin.any() | fired.any()
    c["live"] = c["live"] & ~fin
    c["nsteps"] = c["nsteps"] + active.to(torch.int32)
    return emit, fired


def _carry(ins: Dict) -> Dict:
    """The per-window carry from the static inputs (never written in
    place: a replay must find its inputs as the host left them)."""
    return {"pending": ins["tok"], "lengths": ins["lengths"],
            "live": ins["live"].bool(), "gen": ins["gen"],
            "emitted": torch.zeros_like(ins["gen"]),
            "stop": torch.zeros((), dtype=torch.bool,
                                device=ins["tok"].device),
            "nsteps": torch.zeros((), dtype=torch.int32,
                                  device=ins["tok"].device)}


def _step_masks(c: Dict, j: int, budget):
    """(active, live_j, lengths_m) of window step j."""
    active = ~c["stop"] & (budget > j)
    live_j = c["live"] & active
    lengths_m = torch.where(live_j, c["lengths"],
                            torch.zeros_like(c["lengths"]))
    return active, live_j, lengths_m


def _host_out(c: Dict, emits, fired) -> torch.Tensor:
    """The window's host-bound results packed into one int32 vector:
    [nsteps, pending (B), emits (K*B), fired (K*B)]."""
    return torch.cat([c["nsteps"].reshape(1), c["pending"],
                      torch.stack(emits).reshape(-1),
                      torch.stack(fired).to(torch.int32).reshape(-1)])


def unpack_host(host: np.ndarray, K: int, B: int):
    """``_host_out``'s vector -> (nsteps, pending [B], emits [K, B],
    fired [K, B] bool)."""
    nsteps = int(host[0])
    pending = host[1:1 + B]
    emits = host[1 + B:1 + B + K * B].reshape(K, B)
    fired = host[1 + B + K * B:].reshape(K, B).astype(bool)
    return nsteps, pending, emits, fired


def make_fused_paged(cfg, sc, *, K: int, trigger, sparse_fn,
                     sparse_params, params, pool_device) -> Callable:
    """Window of the INLINE pipeline (no offload): K steps of
    ``decode_step_paged``, with ``sparse_fn`` (the method's pipeline) when
    the window is sparse, else dense attention.

    Returns ``fn(ins) -> {"host": int32 vector}``; ``ins`` holds tok,
    lengths, live, gen, maxnew, armed, arm_after [B], budget [] and the
    table view [B, npv]. The pool pages are written in place."""

    def fused(ins):
        c = _carry(ins)
        emits, fired = [], []
        for j in range(K):
            active, live_j, lengths_m = _step_masks(c, j, ins["budget"])
            pool = dict(pool_device, page_table=ins["table"],
                        lengths=lengths_m)
            logits, _ = M.decode_step_paged(
                params, cfg, c["pending"], pool, live_j, tp=sc.tp,
                sparse_fn=sparse_fn, sparse_params=sparse_params)
            e, f = _advance(c, logits, lengths_m, live_j, active,
                            ins["maxnew"], sc.max_len, ins["armed"].bool(),
                            ins["arm_after"], trigger)
            emits.append(e)
            fired.append(f)
        return {"host": _host_out(c, emits, fired)}

    return fused


def make_fused_presel(cfg, sc, sel, *, K: int, trigger, offl: bool,
                      sparse_params, params, pool_device,
                      page_attn=None) -> Callable:
    """Window of the HETERO two-phase pipeline: apply over preselected
    pages plus the selection double buffer, on the main side.

    Per step, from the carry's (summary, qbuf, sel):

      consume   pidx = the pending lookahead (the window enters with the
                selection the stepped schedule would consume);
      lookahead nxt_sel = select(summary_pre, qbuf_pre, lengths + live),
                the inputs ``_launch_select(lengths + live)`` pins in the
                stepped schedule;
      apply     ``decode_step_paged_presel``, this step's q/k out;
      ingest    fold q/k into summary / qbuf for the next step.

    ``offl=False`` is a dynamic-fallback window: dense apply, no select,
    ingest only (the index stays coherent). The exit lookahead and the
    pre-ingest pins of the last executed step (``prev_*``) come back so the
    stepped double buffer resumes without a cold start and ``validate`` can
    replay the exit lookahead.

    ``ins`` adds to ``make_fused_paged``'s: sel [L, B, n_sel], qbuf, and
    the summary's tensors as ``summary.<name>``. ``page_attn`` is the main
    mesh's sequence-parallel apply (``decode_step_paged_presel``)."""
    from repro_torch.hetero.executor import HeteroExecutor

    blend_q = HeteroExecutor._blend_q     # the stepped schedule's refresh

    def fused(ins):
        c = _carry(ins)
        summary = {k[len("summary."):]: v for k, v in ins.items()
                   if k.startswith("summary.")}
        qbuf, cur_sel = ins["qbuf"], ins["sel"]
        prev_summary, prev_q = summary, qbuf
        prev_len = ins["lengths"]
        emits, fired = [], []
        for j in range(K):
            active, live_j, lengths_m = _step_masks(c, j, ins["budget"])
            if offl:
                la_len = lengths_m + live_j.to(torch.int32)
                nxt_sel = sel.select(sparse_params, summary, qbuf, la_len)
                # the pins move only on a step that runs
                prev_summary = {k: torch.where(active, summary[k],
                                               prev_summary[k])
                                for k in summary}
                prev_q = torch.where(active, qbuf, prev_q)
                prev_len = torch.where(active, la_len, prev_len)
            pool = dict(pool_device, page_table=ins["table"],
                        lengths=lengths_m)
            # a dense (offl=False) step ignores the selection
            logits, _, q_t, k_t = M.decode_step_paged_presel(
                params, cfg, c["pending"], pool, live_j, cur_sel,
                sparse=offl, page_size=sel.page, tp=sc.tp,
                page_attn=page_attn)
            # a step with no live row adds +0.0 / leaves min and max as
            # they are: exact no-ops on the index
            summary = sel.ingest(summary, sparse_params, k_t, lengths_m,
                                 live_j)
            qbuf = blend_q(qbuf, q_t, None, live_j)
            if offl:
                cur_sel = torch.where(active, nxt_sel, cur_sel)
            e, f = _advance(c, logits, lengths_m, live_j, active,
                            ins["maxnew"], sc.max_len, ins["armed"].bool(),
                            ins["arm_after"], trigger)
            emits.append(e)
            fired.append(f)
        out = {"host": _host_out(c, emits, fired), "qbuf": qbuf,
               "sel": cur_sel, "prev_q": prev_q, "prev_len": prev_len}
        for k in summary:
            out["summary." + k] = summary[k]
            out["prev_summary." + k] = prev_summary[k]
        return out

    return fused


class GraphRunner:
    """Runs window functions: on a CUDA device each key is captured once
    into a CUDA graph and replayed; on the CPU the function runs eagerly.

    Every graph shares one memory pool. Inputs are copied into the graph's
    static input tensors before each replay; the graph's outputs are
    overwritten by its next replay, so ``run`` hands out copies of the
    device outputs and the host vector as numpy. Kernel launches inside a
    replay do not pass through the wrappers' counters: the launches a
    capture records are taken back from the counters and added again at
    every replay (``ops.add_launches``), so the counts stay those of the
    kernels the device ran. ``stats`` (the engine's) gets ``graph_captures``
    and ``graph_capture_s``."""

    def __init__(self, device: torch.device, stats: Dict):
        self.device = device
        self.stats = stats
        self._graphs: Dict[Hashable, Tuple] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def run(self, key: Hashable, fn: Callable, ins: Dict[str, torch.Tensor]
            ) -> Tuple[np.ndarray, Dict[str, torch.Tensor]]:
        if self.device.type != "cuda":
            out = fn({k: v.to(self.device) for k, v in ins.items()})
            host = out.pop("host")
            return host.numpy(), out
        if key not in self._graphs:
            self._graphs[key] = self._capture(fn, ins)
        graph, static_in, static_out, launches = self._graphs[key]
        for k, v in ins.items():
            static_in[k].copy_(v, non_blocking=True)
        graph.replay()
        ops.add_launches(launches)
        dev = {k: v.clone() for k, v in static_out.items() if k != "host"}
        return static_out["host"].cpu().numpy(), dev

    def _capture(self, fn: Callable, ins: Dict[str, torch.Tensor]):
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        static_in = {k: torch.empty(v.shape, dtype=v.dtype,
                                    device=self.device)
                     for k, v in ins.items()}
        for k, v in ins.items():
            if k in IDLE_INPUTS:
                static_in[k].zero_()
            else:
                static_in[k].copy_(v)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            fn(static_in)                        # warm-up: every slot dead
        main.wait_stream(self._stream)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            static_out = fn(static_in)
        after = ops.launch_counts()
        launches = {n: after[n] - before[n] for n in after}
        ops.add_launches(launches, sign=-1)      # the capture launched none
        torch.cuda.synchronize(self.device)
        self.stats["graph_captures"] += 1
        self.stats["graph_capture_s"] += time.perf_counter() - t0
        return graph, static_in, static_out, launches
