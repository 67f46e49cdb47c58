"""End-to-end serving example (twin of ``examples/serve_sparse_attention.py``):
a small model serving batched requests through the continuous-batching
scheduler with the memory-processing pipeline; compare methods:

    PYTHONPATH=src python -m repro_torch.examples.serve_sparse_attention \\
        --method dsa --requests 12 --prompt-len 48 --max-new 16

Methods: none (dense baseline) | dsa | seer | lserve. The engine falls back
to dense attention below ``min_context`` / above ``fallback_context``.
``--offload on`` routes the memory-processing stages through the hetero
executor (selection one step ahead on a CUDA stream of its own) and prints
its per-stage overhead breakdown.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.hetero import resolve_cli_offload
from repro_torch.models import init_params
from repro_torch.serving import Engine, OffloadConfig, Request, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--method", default="dsa",
                    choices=["none", "dsa", "seer", "lserve"])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--offload", default="off",
                    choices=["on", "off", "sync", "overlap"],
                    help="hetero offload executor (on = overlap)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        offload = resolve_cli_offload(args.offload, args.method)
    except ValueError as e:
        ap.error(str(e))

    cfg = get_arch(args.arch).smoke()
    params = init_params(cfg, 0, tp=4, device=args.device)
    eng = Engine(cfg, params,
                 ServeConfig(max_len=args.prompt_len + args.max_new + 16,
                             n_slots=args.slots, method=args.method, tp=4,
                             page=8,
                             offload_cfg=OffloadConfig(mode=offload)),
                 seed=1, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    handles = [eng.submit(Request(
        i, rng.integers(0, cfg.vocab_size, size=args.prompt_len),
        args.max_new)) for i in range(args.requests)]
    done = eng.drain()
    wall = time.perf_counter() - t0
    toks = sum(len(h.tokens) for h in handles)
    ttft = [h.ttft_s() for h in handles if h.ttft_s() is not None]
    lat = [h.finished - h.submitted for h in handles if h.done]
    print(f"method={args.method} offload={offload} "
          f"completed={len(done)}/{args.requests} tokens={toks}")
    print(f"wall={wall:.2f}s throughput={toks / wall:.1f} tok/s "
          f"p50_ttft={np.median(ttft):.2f}s "
          f"p50_latency={np.median(lat):.2f}s p95={np.quantile(lat, .95):.2f}s")
    print(f"slot utilization={eng.slots.utilization():.2f}")
    if eng.hetero is not None:
        print("hetero per-stage breakdown (Fig. 3 style):")
        print(json.dumps(eng.hetero.report(), indent=2, sort_keys=True))
    return handles


if __name__ == "__main__":
    main()
