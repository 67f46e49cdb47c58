"""Serving launcher for the port (twin of ``repro.launch.serve``): random
prompts through the paged continuous-batching engine, with the method's
memory pipeline when ``--method`` is dsa, seer or lserve, and the retrieval
service with ``--retrieval``. ``--arch`` takes every name of
``repro_torch.configs.ARCHS``; the hybrid (zamba2) and ssm (xLSTM) families
have no KV pool and serve through ``Engine.generate``'s batched dense-cache
loop (xLSTM ignores the method).

    PYTHONPATH=src python -m repro_torch.launch.serve --method dsa --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --retrieval on \\
        --retrieval-kind rag --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --offload on \\
        --fused-steps 8 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \\
        --retrieval on --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --offload on \\
        --offload-shards 2 --main-mesh 2 --device cuda

Like the reference CLI it serves the architecture's ``.smoke()`` config with
seeded random weights. ``--device cpu`` runs the plain PyTorch path.
``--retrieval on`` (= overlap; inline and sync also) turns on per-slot FLARE
triggers over the decode logits and splices retrieved documents (``rag``,
over a synthetic ``--docs``-document corpus) or MaC memory embeddings
(``mac``) into the paged pool, and prints the service's report.
``--offload on`` (= overlap; sync also) routes selection through the hetero
offload executor and prints its per-stage report (``--offload-validate``
replays every consumed selection); ``--fused-steps K`` runs up to K decode
steps per host dispatch (CUDA graphs on the card) and prints the steps per
dispatch. ``--offload-shards N`` cuts the offload side into N KV-sequence
shards and ``--main-mesh N`` runs the apply sequence-parallel over a mesh of
up to N devices (both need ``--offload``; on one card the shards share it,
each on a stream of its own, and the mesh clamps to the card).
``--replicas N`` serves through a ``Router`` over N engine replicas (on one
card all of them on it), rag retrieval sharing one corpus, and prints the
router's report. ``--disaggregate`` shows the paper's prefill/decode role
split (Fig. 6b): with two or more cards their mesh is cut into a prefill
and a decode role (``launch.mesh.split_mesh_roles``) and the split is
printed; on one device it does nothing, as in the reference.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.hetero import resolve_cli_offload, resolve_cli_retrieval
from repro_torch.launch.mesh import mesh_from_devices, split_mesh_roles
from repro_torch.models import init_params
from repro_torch.serving import (Engine, OffloadConfig, Request, Router,
                                 ServeConfig)
from repro_torch.serving.engine import POOL_FAMILIES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--method", default="dsa", choices=["none", "dsa", "seer", "lserve"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--disaggregate", action="store_true")
    ap.add_argument("--offload", default="off",
                    choices=["on", "off", "sync", "overlap"],
                    help="hetero offload executor (on = overlap)")
    ap.add_argument("--offload-shards", type=int, default=1,
                    help="KV-sequence shards on the offload side (one "
                         "device each, or streams of their own on one "
                         "card); needs --offload")
    ap.add_argument("--main-mesh", type=int, default=1,
                    help="devices of the main apply mesh (sequence-"
                         "parallel, LSE-merged; clamps to the devices "
                         "there are); needs --offload")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a Router over N engine replicas, "
                         "each on its own device group (on one card all on "
                         "it); rag retrieval shares ONE corpus")
    ap.add_argument("--offload-validate", action="store_true",
                    help="replay every consumed lookahead selection "
                         "synchronously and bit-check it")
    ap.add_argument("--fused-steps", type=int, default=1,
                    help="decode steps per host dispatch (1 = stepped "
                         "loop; CUDA graphs on the card)")
    ap.add_argument("--retrieval", default="off",
                    choices=["on", "off", "inline", "sync", "overlap"],
                    help="document-memory service (on = overlap)")
    ap.add_argument("--retrieval-kind", default="rag", choices=["rag", "mac"])
    ap.add_argument("--docs", type=int, default=2048,
                    help="synthetic corpus size for --retrieval-kind rag")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        offload = resolve_cli_offload(args.offload, args.method)
        ret_mode = resolve_cli_retrieval(args.retrieval)
    except ValueError as e:
        ap.error(str(e))

    cfg = get_arch(args.arch).smoke()
    params = init_params(cfg, 0, tp=args.tp, device=args.device)
    if args.disaggregate:
        print_roles(args.device)
    retrieval = None
    if ret_mode:
        from repro_torch.core.methods.mac import MacConfig
        from repro_torch.retrieval import RetrievalConfig
        if args.retrieval_kind == "rag":
            from repro_torch.data import build_corpus
            corpus = build_corpus(args.docs, retrieval_vocab=1024,
                                  doc_max=16, gen_vocab=cfg.vocab_size,
                                  seed=0, device=args.device)
            retrieval = RetrievalConfig(kind="rag", mode=ret_mode,
                                        corpus=corpus, k=2, min_interval=4,
                                        max_retrievals=2)
        else:
            retrieval = RetrievalConfig(
                kind="mac", mode=ret_mode, min_interval=4, max_retrievals=2,
                mac=MacConfig(segment_len=16, memory_slots=8, retrieve_k=2))
    extra = 96 if retrieval is not None else 16
    # shards and the mesh apply only under an offload mode
    shards = args.offload_shards if offload != "off" else 1
    mesh_n = args.main_mesh if offload != "off" else 1
    sc = ServeConfig(max_len=args.prompt_len + args.max_new + extra,
                     n_slots=args.slots, method=args.method, tp=args.tp,
                     page=8, retrieval=retrieval,
                     offload_cfg=OffloadConfig(
                         mode=offload, validate=args.offload_validate,
                         shards=shards, main_mesh=mesh_n),
                     fused_steps=args.fused_steps)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=args.prompt_len),
                    args.max_new) for i in range(args.requests)]
    if args.replicas > 1:
        if cfg.family not in POOL_FAMILIES:
            ap.error(f"--replicas serves the paged pool ({POOL_FAMILIES})")
        if mesh_n > 1:
            ap.error("--main-mesh picks its own devices; it does not "
                     "compose with --replicas' device groups")
        serve_fleet(args, cfg, params, sc, reqs, ret_mode)
        return
    eng = Engine(cfg, params, sc, seed=1, device=args.device)
    if cfg.family not in POOL_FAMILIES:
        t0 = time.perf_counter()
        gen = eng.generate(np.stack([r.tokens for r in reqs]), args.max_new)
        wall = time.perf_counter() - t0
        print(f"arch={args.arch} ({cfg.family}, generate: batched "
              f"dense-cache loop) method={args.method} device={eng.device}: "
              f"{len(gen)}/{args.requests} requests, {gen.size} tokens, "
              f"{gen.size / wall:.1f} tok/s, "
              f"{eng.stats['sparse_steps']}/{eng.stats['decode_steps']} "
              f"decode steps sparse")
        return
    handles = [eng.submit(r) for r in reqs]
    done = eng.drain()
    toks = sum(len(h.tokens) for h in handles)
    ttft = [h.ttft_s() for h in handles if h.ttft_s() is not None]
    print(f"method={args.method} offload={_offload_label(sc)} "
          f"retrieval={ret_mode or 'off'} device={eng.device}: "
          f"{len(done)}/{args.requests} requests, {toks} tokens, "
          f"{eng.throughput_tokens_per_s():.1f} tok/s, "
          f"p50 TTFT {1e3 * float(np.median(ttft)):.1f}ms, "
          f"{eng.stats['sparse_steps']}/{eng.stats['decode_steps']} decode "
          f"steps sparse")
    report_engines(args, [eng])


def print_roles(device):
    """The prefill/decode split of every card's mesh, when there are two or
    more (the reference's ``jax.device_count() >= 2``)."""
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    if n >= 2:
        pre, dec = split_mesh_roles(mesh_from_devices(
            [f"cuda:{i}" for i in range(n)]))
        print(f"disaggregated roles: prefill={len(pre)} devices, "
              f"decode={len(dec)} devices")


def _offload_label(sc) -> str:
    """``mode[/shards=N][/mesh=M]`` of the run's offload topology."""
    label = sc.offload
    if sc.offload_shards > 1:
        label += f"/shards={sc.offload_shards}"
    if sc.main_mesh > 1:
        label += f"/mesh={sc.main_mesh}"
    return label


def serve_fleet(args, cfg, params, sc, reqs, ret_mode):
    """``--replicas N``: the requests through a ``Router``; prints the
    totals, the router's report and each replica's engine reports."""
    router = Router.build(cfg, params, sc, n_replicas=args.replicas,
                          seed=1, device=args.device)
    t0 = time.perf_counter()
    handles = [router.submit(r) for r in reqs]
    done = router.drain()
    wall = time.perf_counter() - t0
    toks = sum(len(h.tokens) for h in handles)
    ttft = [h.ttft_s() for h in handles if h.ttft_s() is not None]
    print(f"method={args.method} offload={_offload_label(sc)} "
          f"retrieval={ret_mode or 'off'} replicas={args.replicas} "
          f"device={args.device}: {len(done)}/{args.requests} requests, "
          f"{toks} tokens, {toks / wall:.1f} tok/s, "
          f"p50 TTFT {1e3 * float(np.median(ttft)):.1f}ms")
    print("router report:")
    print(json.dumps(router.report(), indent=2, sort_keys=True))
    report_engines(args, [r.engine for r in router.replicas])


def report_engines(args, engines):
    """The fused-decode line and each engine's offload and retrieval
    reports."""
    if args.fused_steps > 1:
        hs = sum(e.stats["host_steps"] for e in engines)
        ds = sum(e.stats["decode_steps"] for e in engines)
        gc = sum(e.stats["graph_captures"] for e in engines)
        print(f"fused decode: {ds} device steps in {hs} host dispatches "
              f"({ds / max(hs, 1):.1f} steps/dispatch), "
              f"{gc} CUDA graphs captured")
    for i, eng in enumerate(engines):
        tag = f" (replica {i})" if len(engines) > 1 else ""
        if eng.hetero is not None:
            print(f"hetero per-stage breakdown{tag} (Fig. 3 style):")
            print(json.dumps(eng.hetero.report(), indent=2, sort_keys=True))
        if eng.retrieval is not None:
            print(f"retrieval service report{tag}:")
            print(json.dumps(eng.retrieval.report(), indent=2,
                             sort_keys=True))


if __name__ == "__main__":
    main()
