"""Serving launcher for the port's main path (twin of ``repro.launch.serve``):
random prompts through the paged continuous-batching engine, with the
method's memory pipeline when ``--method`` is dsa, seer or lserve.

    PYTHONPATH=src python -m repro_torch.launch.serve --method dsa --device cuda

Like the reference CLI it serves the architecture's ``.smoke()`` config with
seeded random weights. ``--device cpu`` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.models import init_params
from repro_torch.serving import Engine, Request, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--method", default="dsa", choices=["none", "dsa", "seer", "lserve"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).smoke()
    params = init_params(cfg, 0, tp=args.tp, device=args.device)
    sc = ServeConfig(max_len=args.prompt_len + args.max_new + 16,
                     n_slots=args.slots, method=args.method, tp=args.tp,
                     page=8)
    eng = Engine(cfg, params, sc, seed=1, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=args.prompt_len),
                    args.max_new) for i in range(args.requests)]
    handles = [eng.submit(r) for r in reqs]
    done = eng.drain()
    toks = sum(len(h.tokens) for h in handles)
    ttft = [h.ttft_s() for h in handles if h.ttft_s() is not None]
    print(f"method={args.method} device={eng.device}: "
          f"{len(done)}/{args.requests} requests, {toks} tokens, "
          f"{eng.throughput_tokens_per_s():.1f} tok/s, "
          f"p50 TTFT {1e3 * float(np.median(ttft)):.1f}ms, "
          f"{eng.stats['sparse_steps']}/{eng.stats['decode_steps']} decode "
          f"steps sparse")


if __name__ == "__main__":
    main()
