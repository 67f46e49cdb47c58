#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port serves and trains on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (an H100: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX or of the JAX package. Phases, each raising on
failure (the script then exits non-zero):

1. device: the card's name and power limit (nvidia-smi), then the kernels of
   the paths built from ``src/repro_torch/csrc`` (one nvcc per source, all
   at once);
2. kernels vs their plain versions on the card, with kernel / plain /
   library times and the roofline bound: relevancy-top-k and paged decode
   attention at the DSA path's shapes (llama3.2-1b, 4 slots, an 8192-token
   view, 16-token pages, DSA top-2048) and at Seer's / LServe's (one gated
   head, 64-token blocks, a 4096-token budget), page min/max at LServe's
   (k [4, 8192, 8, 64] bf16, 64-token pages), BM25 + top-k at RAG's (one
   8-term query over a 250,000-doc corpus padded to 262,144, top 4) and at
   the paper's Fig. 10 shape, flash attention at the training shape
   (llama3.2-1b, B 4, S 2048, bf16), the serve runs' bucketed prefill
   (B 2, S 512), mixtral's at S 8192 (dh 128, window 4096) and the
   families' prefills (granite's bucketed one at G = 2, the legacy pool's
   whole 4500-token prompt, mixtral's and qwen2-vl's bucketed ones at dh
   128, zamba2's at dh 112), MemAgent's segment and answer prefills (B 2,
   S 6024 and 1088), and its gradients at fp32; each also at edge cases (-1 holes, a
   length cut mid-page, an all-masked row, S or D not a multiple of the
   block, S below the tile, a window below the tile, G = 1, all-zero
   scores, equal scores, fewer live docs than k, fp32 and bf16, a single
   page, scalar loads); paged attention also at one slot, a selection
   that is no multiple of its split, and a slot whose selected pages all
   lie past its length in splits of unequal size (the mean of v over every
   loaded token); flash attention on both routes (bf16 at head dim 64, 112
   and 128 through the tensor cores, including views that TMA cannot read
   in place; fp32 and head dim 32 through the CUDA cores), with the route
   each shape took, the HGMMA instructions in the tensor-core library's
   SASS (the 64x112 ones of dh 112's P.V among them)
   and each new kernel's ptxas registers, shared memory and spills;
   relevancy and BM25 with each timed shape's cluster split (CTAs a block,
   the scoring route), the HMMA instructions in the relevancy library's
   SASS, both sources' ptxas reports, and the split's own edges (nb > 1
   with B > 1, valid_len inside a chunk, c below the block, a live count
   inside a cluster's first CTA);
3. train: full-width llama3.2-1b in bf16 with seeded random weights,
   ``TokenStream`` data, remat, B 4 x S 2048, lr 3e-3 with 5 warm-up steps:
   6 steps with finite, falling loss and 2 flash launches per layer per
   step (forward and remat recompute), every one on the tensor-core
   route, a checkpoint at step 3 that a fresh
   ``Trainer`` restores to reproduce step 4's loss, two steps under
   ``torch.profiler`` (busy share, the flash kernel in situ, the attention
   backward's plain recompute), a step with accum 2, and one fp32 step (B 1
   x S 1024) through the kernel against the plain path; one ``train`` line;
3b. train_families: granite-moe-1b-a400m, musicgen-medium, zamba2-7b and
   xlstm-125m (``TRAIN_FAMILIES``) trained the same way at their published
   widths at a constant lr (1e-5; musicgen 3e-6, xLSTM 3e-4), zamba2 cut
   to 6 layers (1 shared-block site at dh 112) and xLSTM to 2 of its 12
   layers and S 128 (its token loops): batch 0's loss after one step at the train phase's
   schedule and at the family's (the lr probe); 4 steps with finite,
   falling loss, 2 flash launches per attention layer per step, all on the
   tensor cores (none for xLSTM), one profiled step (busy share), and one
   fp32 step (B 1 x S 512; xLSTM S 32) through the kernels against the
   plain path; one ``train`` line each;
3c. train_sharded: multi-device training on the one card, one process over
   a mesh whose entries are all ``cuda:0``: llama3.2-1b at full width,
   bf16, B 4 x S 2048, remat, tp 4, lr 1e-5; 3 single-device steps, then 3
   of the gathered step on a (2, 1) mesh (each data index gathers the
   parameters and runs its rows: losses within 2e-2, the worst leaf within
   its bf16 bound, 64 flash launches a step), then 3 of the
   tensor-parallel step on a (2, 4) ("data", "model") mesh from the
   same weights and batches (each coordinate computes its slice: 8 q / 2
   kv heads, a quarter of the MLP and of the vocabulary; losses within
   2e-2, the worst leaf within its bf16 bound, 256 flash launches a step on
   the tensor cores: 2 data indices x 4 model shards x 16 layers x 2; step
   ms, peak memory, one profiled step's busy share beside the gathered
   step's (on (2, 1), and its earlier figures on (2, 4): 936.9 ms, 46.46
   GB), the device
   ops of a profiled step against one device's, the data-axis gradient
   reduction's and the sharded AdamW's ms, which on one card are
   device-local); the
   params saved from the mesh (at 4 layers), restored onto a (4,) model
   mesh and onto one device, bit-equal; 3 of the same step with the
   Megatron-SP
   residual (``TrainConfig.sp``: each member its S / 4 slice of the
   residual, the normed inputs all-gathered, the partials
   reduce-scattered) from the same weights and batches, against the TP
   step's (losses, bit-equal where the card's norms and sums run in the
   same order, within 2e-2 in any case; the worst leaf within its bf16
   bound; 256 flash launches a step on the tensor cores; step ms, peak
   memory, a profiled step's busy share and device ops); one fp32 step
   (S 512, lr 1e-3) sharded against single device within the CPU tests'
   tolerances, its data replicas agreeing, without and with SP;
   granite-moe-1b-a400m at full width cut to 4 layers, one
   expert-parallel step on a (1, 4) mesh (32 experts, 8 a shard) against
   one device's, and one with the shard-local dispatch
   (``TrainConfig.ep_local``) against it (loss within 1e-5 relative, step
   ms); the compressed pod sync on (2, 2, 2) ("pod", "data",
   "model") at 4 layers, int8 and bf16 (step 1's loss bit-equal to the
   uncompressed step's, each residual held against one recomputed from
   the reduced gradients, int8's non-zero);
   GPipe: 4 stages of 4 layers, 8 microbatches of [1, 2048], 176 flash
   launches, equal to the unpipelined forward; the seconds each part took;
   one ``train_sharded`` line;
3e. decode_sharded: decode over a sequence-split cache
   (``models.model.decode_step_tp``), llama3.2-1b at full width, seeded
   weights, DSA at 64-token pages through ``SplitDSA`` (each shard's
   relevancy top-k and paged attention over its own slice; only (value,
   index) candidates, page ids and (out, lse) pairs cross), one process
   over meshes of ``cuda:0`` entries: (a) decode_32k's layout on (2, 4),
   bf16, B 4: ``prefill_tp`` of 32,760 tokens a row, its caches
   resharded onto the mesh (``reshard_prefill_caches``), 8 greedy steps
   against one device's ``prefill`` + ``decode_step``; (b) long_500k's
   layout on (2, 4), bf16, B 1: a seeded cache of 524,284 tokens in
   524,288 (65,536 a coordinate), 4 steps against one device's; the
   logits of (a) and (b) within DECODE_BF16_TOL, prefill_tp's last
   logits within PREFILL_BF16_TOL of prefill's; (c) one fp32 step on an
   8192-token cache in each layout (B 2 on (1, 4), B 2 and B 1 on
   (2, 2)): logits within LOGIT_TOL, the selected pages equal. Tokens
   equal (a near-tie, its top-2 margin below DECODE_BF16_TOL, reported
   with its margin), 128 launches of each kernel a split step in (a), the
   two kernels at each layout's per-shard shape against their plain
   versions and timed (rows of the kernels line), step ms of both in the
   same call, peak memory, a profiled step's busy share and device ops,
   the bytes a split step exchanges (counted on placeholder cards), the
   phase's seconds; one ``decode_sharded`` line;
3g. hybrid_sharded: the hybrid's Mamba2 split over the model axis
   (``models.ssm.mamba_tp``: each member its
   heads, the gated norm's variance all-reduced, ``out_proj``
   row-parallel), zamba2-7b at full width with seeded weights, one process
   over a (2, 4) mesh of ``cuda:0`` entries, depth cut for memory and time
   (``HYBRID_*``): (t) one tensor-parallel train step at 6 layers (bf16,
   B 4 x S 2048, remat, lr 1e-5) against one device's from the same
   weights and batch (losses within 2e-2, the worst leaf within its bf16
   bound, 16 flash launches a step on the tensor cores, step ms, peak
   memory, a profiled step's busy share and device ops of each) and an
   fp32 step (S 512) within the CPU tests' tolerances; (p) ``prefill_tp``
   of B 4 x 4096 at 27 layers against ``prefill`` (HYBRID_PREFILL_TOL);
   (a) decode_32k's layout at 27 layers, B 4, a cache of 32,760 tokens in
   32,768 drawn from ``--seed`` (``shared_k`` / ``shared_v``, SSM and conv
   states), DSA at 64-token pages, 8 greedy steps, and (b) long_500k's at
   13 layers, B 1, 524,284 in 524,288, 4 steps, each against one device's
   (logits within HYBRID_DECODE_TOL, tokens, every shard of the states,
   32 / 16 launches of each kernel a split step, a profiled step in (a),
   the bytes a card receives on placeholder cards, the kernels at the
   per-shard shapes: rows 1h / 2h); (c) one fp32 step at 7 layers on an
   8192-token cache in each of ``DECODE_C_CASES``' layouts (logits and
   states within LOGIT_TOL, pages equal); the seconds by part; one
   ``hybrid_sharded`` line;
3d. roofline: the dry-run and roofline tools (``launch.op_walk``,
   ``launch.roofline``, ``launch.dryrun``): one train step of full-width
   llama3.2-1b (bf16, B 4 x S 2048, remat, one card) and one DSA
   ``decode_step`` (B 4, a cache of 8191 tokens in 16-token pages), each
   walked on the card and dry-run on placeholder cuda:0, the two walks
   equal in FLOPs per dtype, bytes and kernel records (32 flash records a
   train step; 16 relevancy and 16 paged attention a decode step), with
   the walk's terms, its bound, the median of 3 timed steps, MFU, and the
   walk's peak live bytes beside ``max_memory_allocated``; then the dry
   run of llama3.2-1b's decode_32k cell, cut to 2 layers (the decode
   split walks 16 coordinates a layer), on the 16 x 16 mesh of
   placeholder cards (its record under ``chiprun_out/dryrun/``); one
   ``roofline`` line;
4. serve: full-width llama3.2-1b in bf16 with seeded random weights,
   ``ServeConfig(method=m, max_len=8192, n_slots=4)`` for m in dsa, lserve
   and seer, seer in both its top-k and its threshold selection, and dsa
   with the retrieval service, RAG over the corpus (``dsa-rag``) and MaC
   memory banks (``dsa-mac``), FLARE firing in every slot; then dsa and
   dsa-rag with 8 decode steps per host dispatch (``dsa-fused8``,
   ``dsa-rag-fused8``: every window a CUDA graph replay, the trigger in
   the graph), and dsa through the hetero offload executor, its offload
   side on a CUDA stream of its own, in sync, in overlap, in overlap with
   8-step windows, and in that with every consumed selection replayed
   (``dsa-offload-*``; ``RUNS``); 2 prompts past ``min_context`` (chunked
   prefill) and 2 short ones (bucketed prefill); every request completes
   and each kernel of the run's path launches once per layer per sparse
   decode step the device computes (a window's masked steps and its
   graph's warm-up included; the launches inside graph replays counted;
   the offload runs launch paged attention only, their selection is plain
   tensor code), bm25 once per query, flash once per layer per bucketed
   prefill, on the tensor-core route, every other kernel never; every
   request retrieves in the rag runs, only the long ones (whose prompts
   fill MaC's 1024-token segments) in dsa-mac; then the same requests
   again with four steady sparse decode polls (host dispatches) under
   ``torch.profiler``, for the device's busy share and each kernel's
   in-situ time (tables under ``chiprun_out/``); one ``serve`` line per
   run, with the retrieval service's report, the host dispatches, steps
   per dispatch, graph captures and their seconds, the steady decode ms
   per step, and the offload's lookahead hits / cold starts / patches,
   offload and local steps and (sync) select and apply seconds; then one
   ``equal_runs`` line: each fused run's greedy tokens and retrieval
   events equal its stepped run's, overlap equals sync, the validate run
   equals overlap;
5. modes: dsa-rag with the service inline (the engine's stream), sync and
   overlap (a stream of its own; both replaying every query): equal greedy
   tokens and retrieval events, one ``modes`` line;
6. compare: the same requests at float32 for each run but dsa-mac, once
   through the kernels and once through the plain versions
   (``ops.use_kernels(False)``): the first sparse decode step's logits
   agree, the retrievals are equal, and the greedy tokens are equal (or
   differ only where the plain top-2 margin is within the tolerance);
7. pipeline: each method's four-stage ``build_pipeline``, unfused and
   fused, on one layer's full-width tensors, and RAG's over the corpus:
   equal outputs; MaC's at d = 2048, equal to ``segment_step``'s; a
   ``{"pipeline": ...}`` line each with the ``StageProfiler`` stage times
   and shares (the paper's Fig. 3-5 breakdown);
8. families: the rest of the model zoo through the entry points a user
   calls (``FAMILY_RUNS``), bf16, seeded weights, the serve phase's
   ``ServeConfig`` and requests: granite-moe-1b-a400m at full width with
   DSA on the paged pool, stepped (``granite-dsa``, also in the fp32
   compare) and in 8-step windows (``granite-dsa-fused8``, equal to it);
   musicgen-medium at full width cut to 24 of its 48 layers (paged
   attention at G = 1); llama3.2-1b on the legacy dense pool
   (``paged=False``: the shared watermark); zamba2-7b at full width cut to
   27 of its 81 layers (4 of the shared block's 13 sites at dh 112, and the
   3-layer tail) and xlstm-125m at full width through ``Engine.generate``
   (2 prompts of 4480 and of 512 tokens); mixtral-8x7b and qwen2-vl-72b at
   their published widths cut to 2 layers (neither fits the card at full
   depth; MoE with a 4096-token window, M-RoPE at sections (16, 24, 24));
   the musicgen and zamba2 cuts hold ``chip_smoke.py``'s time. Launch counts as in
   the serve phase, per attention layer (the hybrid's sites; none for
   xLSTM), flash per bucketed or unpaged prefill on the route its head
   dim takes; one ``serve`` line per run;
9. fleet: multi-device serving on the one card, full-width llama3.2-1b
   bf16 with seeded weights and the serve phase's ``ServeConfig``:
   dsa through the offload with 2 selection shards (each on a CUDA stream
   of its own), stepped and in 8-step windows, and with the main mesh
   (``main_mesh=2``, clamped to the card; the granule still 2 x 64);
   each equal to its one-shard run (run first when the serve phase did
   not); ``fleet-dsa-2``: ``Router.build`` of 2 dsa replicas on the card
   with dsa-rag's retrieval over ONE shared service (the replicas hold the
   same object, and the weights once), 8 requests (the serve phase's 4 and
   4 more; sessions "a" and "b" of 2 requests, 4 without; 4 opting into
   retrieval), launch counts as in the serve phase over both replicas,
   both replicas serving, each session on one replica, each replica's
   tokens and retrieval events equal to a fresh single ``Engine`` fed its
   requests in the same order (one ``fleet`` line); the sequence-parallel
   functions at DSA's shape (B 4, 32 / 8 KV heads, dh 64, view 8192,
   16-token pages) over 2 and 4 shards of ``(cuda:0,) * n``: the paged
   apply against the single kernel and the plain version, the relevancy
   top-k bit-equal to ``ops.relevancy_topk``, n launches of each a call,
   the calls' and the shard view copy's times, the two kernels at the
   shard-local shapes (view 4096 and 2048, beside their bounds and library
   times), DSA's cached against its stateless distributed decode for one
   layer at fp32 (one ``fleet_direct`` line);
10. methods: MemAgent at full width (llama3.2-1b bf16 cut to 8 of its 16
   layers, seeded weights,
   Appendix D's segments of 5000, 1024-token memory and 32-token answer,
   B 2, a 10,000-token document and a 64-token question) through
   ``run_memagent`` with ``prefill`` / ``decode_step`` placed by
   ``split_mesh_roles`` (the card takes both roles): each segment's
   prefill and 1024 decode steps timed apart (the paper's Fig. 12), 24
   flash launches on the tensor cores and no other kernel, an int32
   answer in the vocab, segment 1's prefill logits at fp32 through the
   kernel against the plain path (one ``memagent`` line); its
   ``build_pipeline`` through ``run``, apply handed the raw memory as in
   the reference (a ``pipeline`` line); ``ttt_forward`` at d 2048,
   fast_dim 2048, B 4, S 8192, chunk 256 (x bf16): the reconstruction
   loss diverging at the reference's lr 0.1 (lr x lambda_max > 2 at this
   width) and falling at lr 0.1 x 32 / 2048, where it also gives ms a
   call and its three pipeline stages timed over the chunks, their W'
   equal to the forward's (one ``ttt`` line);
11. examples: each ``repro_torch.examples`` module's ``main`` at its
   defaults on the card, launching its path's kernels (one ``examples``
   line), then ``train_mac_100m --full`` for 10 steps (d 768, 12 layers,
   vocab 32000, 2 segments of 256, B 4): finite, falling loss, 24 flash
   launches a step on the tensor cores (one ``train_mac`` line);
12. a ``{"kernels": [...]}`` line (flash's ``launches`` from the train
   phase, the train_families phase's by family and the train_sharded
   phase's gathered and tensor-parallel steps, granite's expert-parallel
   step and pipelined forward (``gathered``, ``train_sharded``,
   ``granite_tp``, ``gpipe``) in ``launches_by_path``, flash also checked
   and timed at those paths' shapes (a gathered data index's: bf16 [2,
   2048] over 32 q / 8 kv heads; a model shard's: over 8 / 2, granite's
   [4, 2048] over 4 / 2, the pod sync's [1, 2048] over 16 / 4; GPipe's [1,
   2048] over 32 / 8), and at the fp32 sharded step's [2, 512] over 8 / 2;
   paged attention and flash also at the families' shapes: G = 1,
   2, 4 and 8, dh 112 and 128; relevancy and paged attention at the fleet
   phase's shard-local shapes and at decode_sharded's and
   hybrid_sharded's per-shard shapes (their launches in
   ``launches_by_path``); flash at a model shard of the hybrid's train
   step ([2, 2048] over 8 / 8 heads at dh 112); flash at MemAgent's prefills,
   with the methods phase's launches), the card line, and ``{"ok": true,
   ...}``
   as the last line.

``--phases`` runs a subset of kernels, train, train_families,
train_sharded, decode_sharded, hybrid_sharded, roofline, serve, modes,
compare, pipeline, families, fleet, methods and examples (the default is
all fifteen); ``--phases decode_bounds`` takes the readings behind
DECODE_BF16_TOL (``phase_decode_bounds``: one device's bf16 logits against
fp32 at (a)'s and (b)'s shapes, and the split's with its merge right and
deliberately wrong) and behind the hybrid's HYBRID_DECODE_TOL and
HYBRID_PREFILL_TOL (``_hybrid_bounds``: the same at the hybrid_sharded
phase's shapes, and with a per-member gated norm), a phase that runs only
when named; ``--seed`` seeds the hybrid_sharded phase's caches;
``--runs`` a subset of the serve runs, ``--family-runs`` of the families
phase's.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# the card's rates (H100 SXM, NVIDIA data sheet) are the package's table,
# ``repro_torch.core.placement``; each kernel's bound is its wrapper's
# ``cost(...).bound()``
L2_BYTES = 50 * 2**20
SERVE_ARCH = "llama3.2-1b"
PROMPT_LENS = (4500, 4400, 300, 260)     # two past min_context, two short
SHORT_LENS = tuple(n for n in PROMPT_LENS if n < 1024)
PREFILL_BUCKET = 512     # the short prompts' length bucket (Engine._bucket_len)
TRAIN_ARCH = "llama3.2-1b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 6
CLI_TP, CLI_TOTAL_STEPS = 4, 20          # launch/train.py's --tp, --steps
# the train_families phase: arch -> (depth cut to, 0 for none; B; S; lr; S
# of the fp32 kernel-vs-plain step at B 1), at published widths. zamba2-7b's
# 81 layers do not fit 80 GB with fp32 AdamW moments (~12 bytes a
# parameter): 6 layers keep 1 shared-block site (12, 2 sites, until the
# script's time grew past its limit's reach). xLSTM's token loops (one
# step of host code per token) cut its S, and its depth to 2 of 12 layers
# (one pair: the script's time, since the hybrid_sharded phase and the SP
# step); no kernel
# is on its path, so its fp32 step is a short one. The lr is constant (one warm-up step): Adam's
# first steps move every parameter by about lr, and at 1.4-1.8 B parameters
# the train phase's schedule (lr 3e-3, 5 warm-up steps: 6e-4 at step 1)
# overshoots, musicgen's even at 1e-5 (``_lr_probe``).
TRAIN_FAMILIES = {"granite-moe-1b-a400m": (0, TRAIN_B, TRAIN_S, 1e-5, 512),
                  "musicgen-medium": (0, TRAIN_B, TRAIN_S, 3e-6, 512),
                  "zamba2-7b": (6, TRAIN_B, TRAIN_S, 1e-5, 512),
                  "xlstm-125m": (2, TRAIN_B, 128, 3e-4, 32)}
TRAIN_FAMILY_STEPS = 4
# the train_sharded phase: llama3.2-1b at full width on a (2, 4) mesh of the
# card. The pod sync's (2, 2, 2) mesh holds 4 copies of every leaf and of
# its fp32 moments: at full depth that is past 80 GB, so it runs at
# POD_LAYERS layers. GPipe: 4 stages of 4 layers, 8 microbatches.
SHARDED_STEPS, SHARDED_LR = 3, 1e-5
SHARDED_FP32_S, SHARDED_FP32_LR = 512, 1e-3
SHARDED_MESH = ((2, 4), ("data", "model"))
POD_MESH = ((2, 2, 2), ("pod", "data", "model"))
POD_LAYERS = 4
# granite-moe's expert-parallel step: (1, 4) splits its 32 experts 8 a
# shard; its depth cut to 4 layers, its lr the train_families phase's
GRANITE_TP, GRANITE_TP_MESH, GRANITE_TP_LAYERS = ("granite-moe-1b-a400m",
                                                  ((1, 4), ("data", "model")),
                                                  4)
# the gathered sharded step measured on the (2, 4) mesh of one NVIDIA H100
# 80GB HBM3 at 700 W, before the model-axis split: the figures the
# tensor-parallel step is printed beside. The
# gathered step still runs (the hybrid's and xLSTM's, and every family's on
# a model axis of 1): llama on a (2, 1) mesh
GATHERED_STEP_MS, GATHERED_PEAK_GB = 936.9, 46.46
GATHERED_MESH = ((2, 1), ("data", "model"))
GPIPE_STAGES, GPIPE_MICRO, GPIPE_PAIRS = 4, 8, 6
MAX_NEW = 16
VIEW = 8192
PAGE = 16                                # DSA micro-page, kv pool page
BLOCK = 64                               # Seer block / LServe logical page
BUDGET = 4096                            # Seer / LServe token budget
SLOTS = 4
METHODS = ("dsa", "lserve", "seer")
_DSA = ("relevancy_topk_candidates", "paged_decode_attention")


@dataclass(frozen=True)
class Run:
    """A serve run: its method and MemoryConfig overrides, the retrieval
    service's kind (None: no service), the kernels its path launches (once
    per attention layer per sparse decode step the device computes, bm25
    once per retrieval query), whether it joins the kernel-vs-plain compare
    at fp32, its decode steps per host dispatch (``fused``: each window a
    CUDA graph replay), its hetero offload mode and validation, and the run
    whose greedy tokens (and retrieval events) it must equal (``equals``);
    the architecture (``arch``, at its published widths; ``layers`` > 0
    cuts its depth to that many layers), the pool (``paged=False``: the
    legacy dense pool), and for a run through ``Engine.generate`` (the
    batched dense-cache loop) its batch and prompt length (``generate``);
    the offload's selection shards and main mesh (``shards``, ``mesh``)."""
    method: str
    mem: dict = field(default_factory=dict)
    retrieval: str | None = None
    kernels: tuple = _DSA
    compare: bool = True
    fused: int = 1
    offload: str = "off"
    validate: bool = False
    equals: str | None = None
    arch: str = SERVE_ARCH
    layers: int = 0
    paged: bool = True
    generate: tuple | None = None
    shards: int = 1
    mesh: int = 1


# the offload runs select with plain tensor ops on the offload stream: the
# main stream's apply launches paged attention only
_APPLY = ("paged_decode_attention",)
RUNS = {"dsa": Run("dsa"),
        "lserve": Run("lserve", kernels=("page_minmax",
                                         "paged_decode_attention")),
        "seer": Run("seer"),
        "seer-threshold": Run("seer", {"selection": "threshold"}),
        "dsa-rag": Run("dsa", retrieval="rag",
                       kernels=_DSA + ("bm25_topk_candidates",)),
        # MaC's path adds no kernel
        "dsa-mac": Run("dsa", retrieval="mac", compare=False),
        "dsa-fused8": Run("dsa", compare=False, fused=8, equals="dsa"),
        "dsa-rag-fused8": Run("dsa", retrieval="rag",
                              kernels=_DSA + ("bm25_topk_candidates",),
                              compare=False, fused=8, equals="dsa-rag"),
        "dsa-offload-sync": Run("dsa", kernels=_APPLY, compare=False,
                                offload="sync"),
        "dsa-offload-overlap": Run("dsa", kernels=_APPLY, compare=False,
                                   offload="overlap",
                                   equals="dsa-offload-sync"),
        "dsa-offload-overlap-fused8": Run(
            "dsa", kernels=_APPLY, compare=False, fused=8,
            offload="overlap", equals="dsa-offload-overlap"),
        # every consumed selection replayed and bit-checked
        "dsa-offload-validate": Run(
            "dsa", kernels=_APPLY, compare=False, fused=8, offload="overlap",
            validate=True, equals="dsa-offload-overlap")}
# the families phase: the rest of the model zoo on the card, each run at
# its published widths, at full depth but mixtral's and qwen2-vl's (cut to
# 2 layers: 47 B and 73 B parameters do not fit 80 GB in bf16), musicgen's
# and zamba2's (cut for the script's time)
GRANITE, ZAMBA2 = "granite-moe-1b-a400m", "zamba2-7b"
FAMILY_RUNS = {
    "granite-dsa": Run("dsa", arch=GRANITE),
    "granite-dsa-fused8": Run("dsa", arch=GRANITE, compare=False, fused=8,
                              equals="granite-dsa"),
    # 24 heads over 24 KV heads: paged attention at G = 1; 24 of its 48
    # layers, for chip_smoke.py's time
    "musicgen-dsa": Run("dsa", arch="musicgen-medium", layers=24,
                        compare=False),
    # the watermark differs from per-slot lengths by design: no equals
    "llama-dsa-legacy": Run("dsa", compare=False, paged=False),
    # 35 x 128 tokens (Mamba2's chunk), past min_context; flash, relevancy
    # and paged attention at each shared-block site, dh 112; 27 of its 81
    # layers (4 sites of 6 Mamba2 layers and the 3-layer tail, the published
    # model's shape), for chip_smoke.py's time
    "zamba2-dsa-generate": Run("dsa", arch=ZAMBA2, layers=27, compare=False,
                               generate=(2, 4480)),
    # attention-free: the method does not apply, no kernel on the path
    "xlstm-generate": Run("none", arch="xlstm-125m", kernels=(),
                          compare=False, generate=(2, 512)),
    # top-2 of 8 experts at ff 14336, window 4096 (the long prompts decode
    # past it), flash on the tensor cores at dh 128
    "mixtral-dsa": Run("dsa", arch="mixtral-8x7b", layers=2, compare=False),
    # M-RoPE at its published sections (16, 24, 24), 64 heads over 8 KV
    "qwen2vl-dsa": Run("dsa", arch="qwen2-vl-72b", layers=2,
                       compare=False)}
# the fleet phase's offload runs (besides its router): two selection shards,
# each on a CUDA stream of its own, stepped and in 8-step windows, and the
# main mesh (clamped to the card: one shard, the apply through the mesh's
# seam); each equals its one-shard run
FLEET_RUNS = {
    "dsa-offload-shards2-overlap": Run(
        "dsa", kernels=_APPLY, compare=False, offload="overlap", shards=2,
        equals="dsa-offload-overlap"),
    "dsa-offload-shards2-overlap-fused8": Run(
        "dsa", kernels=_APPLY, compare=False, fused=8, offload="overlap",
        shards=2, equals="dsa-offload-overlap-fused8"),
    "dsa-mesh2": Run("dsa", kernels=_APPLY, compare=False, offload="overlap",
                     mesh=2, equals="dsa-offload-overlap")}
ALL_RUNS = {**RUNS, **FAMILY_RUNS, **FLEET_RUNS}
PHASES = ("kernels", "train", "train_families", "train_sharded",
          "decode_sharded", "hybrid_sharded", "roofline", "serve", "modes",
          "compare", "pipeline", "families", "fleet", "methods", "examples")
EXTRA_PHASES = ("decode_bounds",)        # run only when named
# the run whose serve phase gives a kernel's launches and in-situ time in
# its row: the first run that launches it
HOME_PATH = {name: label for label, run in reversed(RUNS.items())
             for name in run.kernels}

# the retrieval runs: the card corpus and the rag / mac knobs
CORPUS_DOCS = 250_000
RETRIEVAL_VOCAB = 1024                   # the reference CLI's
DOC_MAX = 64
RAG_K = 4
_CACHE = {}

# tolerances (kernel vs plain on the card); both sides compute in fp32, so
# the differences are summation order only, at bf16 inputs as at fp32 ones
TOPK_VAL_TOL = 1e-4          # relative to the largest |score| of the row
ATTN_TOL = 1e-4              # abs, on out (|out| <= max|v|) and on lse
BF16_ULP = (2.0 ** -7, 2.0 ** -8)   # (rtol, atol): one bf16 ulp
LOGIT_TOL = 2e-3             # abs, fp32 logits after 16 layers


def log(*a):
    print(*a, file=sys.stderr, flush=True)


T_START = time.perf_counter()


def mark(msg: str):
    """A phase's header in the log, with the seconds since the start."""
    log(f"{msg} (at {time.perf_counter() - T_START:.1f} s)")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fns, n: int = 20) -> float:
    """Device time of one call: n calls captured in a CUDA graph and replayed
    between two events, so host launch overhead is not counted. ``fns`` is
    one callable (its inputs stay L2-resident across the calls) or a list of
    callables on copies of the inputs, called in turn (see ``cold_copies``)."""
    import torch

    fns = fns if isinstance(fns, list) else [fns]
    n = max(n, 2 * len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n):
            fns[i % len(fns)]()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def cold_copies(per_call_bytes: int) -> int:
    """Copies of a call's inputs to rotate through in ``time_ms`` so that each
    call finds its data out of L2: between two uses of one copy the others
    touch at least twice the L2's size."""
    return max(2, math.ceil(2 * L2_BYTES / per_call_bytes) + 1)


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------


def _topk_check(name, kv, ki, pv, pi):
    """Values within TOPK_VAL_TOL of the row's scale; indices equal wherever
    the plain value is isolated from its neighbours by more than that."""
    import torch

    scale = pv.abs().amax(-1, keepdim=True).clamp(min=1.0)
    finite = torch.isfinite(pv)
    if not torch.equal(finite, torch.isfinite(kv)):
        raise AssertionError(f"{name}: -inf pattern differs")
    err = ((kv - pv).abs() / scale)[finite]
    max_err = float(err.max()) if err.numel() else 0.0
    if max_err > TOPK_VAL_TOL:
        raise AssertionError(f"{name}: value err {max_err} > {TOPK_VAL_TOL}")
    band = TOPK_VAL_TOL * scale
    gap = torch.full_like(pv, float("inf"))
    d = (pv[..., 1:] - pv[..., :-1]).abs()
    gap[..., 1:] = torch.minimum(gap[..., 1:], d)
    gap[..., :-1] = torch.minimum(gap[..., :-1], d)
    exact = (pv == pv.roll(1, -1)) | (pv == pv.roll(-1, -1))
    isolated = (gap > band) | exact     # exact ties must order identically
    if not torch.equal(ki[isolated], pi[isolated]):
        raise AssertionError(f"{name}: indices differ outside the tie band")
    log(f"  {name}: max rel err {max_err:.3g} (tol {TOPK_VAL_TOL}), "
        f"{int(isolated.sum())}/{isolated.numel()} indices compared, equal")
    return float((kv - pv).abs()[finite].max()) if finite.any() else 0.0


def _attn_check(name, ko, kl, po, pl_):
    import torch

    e_out = float((ko - po).abs().max())
    e_lse = float(((kl - pl_).abs() / pl_.abs().clamp(min=1.0)).max())
    if not (e_out <= ATTN_TOL and e_lse <= ATTN_TOL):
        raise AssertionError(f"{name}: out err {e_out}, lse rel err {e_lse}"
                             f" > {ATTN_TOL}")
    if not (torch.isfinite(ko).all() and torch.isfinite(kl).all()):
        raise AssertionError(f"{name}: non-finite output")
    log(f"  {name}: out max abs err {e_out:.3g}, lse rel err {e_lse:.3g} "
        f"(tol {ATTN_TOL})")
    return e_out


def _main_path_lengths():
    return [n + MAX_NEW // 2 for n in PROMPT_LENS]   # mid-decode lengths


def check_relevancy(dev):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import relevancy_topk as rt

    g = torch.Generator(device=dev).manual_seed(0)
    B, Hq, dk = SLOTS, 64, 128                 # DSA index heads / dim
    S = VIEW // PAGE                           # pooled keys: one per page
    k_sel = 2048 // PAGE
    block = max(min(4096, S), k_sel)
    q = torch.randn(B, Hq, dk, generator=g, device=dev).bfloat16()
    keys = torch.randn(B, S, dk, generator=g, device=dev).bfloat16()
    for b, n in enumerate(_main_path_lengths()):   # pooled zeros past live
        keys[b, -(-n // PAGE):] = 0
    w = torch.softmax(torch.randn(B, Hq, generator=g, device=dev), -1)
    kv, ki = rt.relevancy_topk_candidates(q, keys, w, block=block)
    pv, pi = rt.relevancy_topk_candidates_plain(q, keys, w, block=block)
    err = _topk_check("relevancy main path bf16", kv, ki, pv, pi)

    # edge cases through the public op (padding, clamping, ties, fp32)
    cases = [
        ("S=300 padded to 384", 300, 128, 20, torch.bfloat16, False),
        ("k > S clamped", 48, 64, 100, torch.float32, False),
        ("all-zero scores", 512, 512, 128, torch.bfloat16, True),
        ("fp32", 512, 512, 128, torch.float32, False),
    ]
    for name, s, blk, k, dt, zero in cases:
        qq = torch.randn(2, Hq, dk, generator=g, device=dev).to(dt)
        kk = torch.zeros(2, s, dk, device=dev, dtype=dt) if zero else \
            torch.randn(2, s, dk, generator=g, device=dev).to(dt)
        ww = torch.softmax(torch.randn(2, Hq, generator=g, device=dev), -1)
        a = ops.relevancy_topk(qq, kk, ww, k, block=blk)
        b = ref.relevancy_topk(qq, kk, ww, k)
        if a[1].shape != (2, min(k, s)):
            raise AssertionError(f"{name}: shape {tuple(a[1].shape)}")
        if zero and not torch.equal(a[1].long(), torch.arange(
                k, device=dev).expand(2, k)):
            raise AssertionError(f"{name}: ties not by ascending index")
        err = max(err, _topk_check(f"relevancy {name}", a[0], a[1], b[0],
                                   b[1]))

    # the cluster split's own edges, through the candidates: nb > 1 with
    # B > 1, valid_len inside a chunk, c below the block (a CTA's run
    # shorter than c), each at fp32 and bf16
    for name, b, s, blk, c, vl in [("nb 4 x B 3", 3, 2048, 512, 0, 0),
                                   ("valid_len mid-chunk", 2, 512, 512, 0,
                                    300),
                                   ("c 40 < block", 2, 1024, 512, 40, 700)]:
        for dt in (torch.bfloat16, torch.float32):
            qq = torch.randn(b, Hq, dk, generator=g, device=dev).to(dt)
            kk = torch.randn(b, s, dk, generator=g, device=dev).to(dt)
            kk[-1, s // 4:] = 0                  # exact ties at zero
            ww = torch.softmax(torch.randn(b, Hq, generator=g, device=dev), -1)
            a = rt.relevancy_topk_candidates(qq, kk, ww, block=blk, c=c,
                                             valid_len=vl)
            r = rt.relevancy_topk_candidates_plain(qq, kk, ww, block=blk, c=c,
                                                   valid_len=vl)
            err = max(err, _topk_check(f"relevancy {name} {dt}, "
                                       f"{_relevancy_plan(kk, blk, c)}",
                                       *a, *r))

    # Seer's shape: one gated query head (dk = index_dim 128), unit weight,
    # the view's 128 pooled 64-token blocks (zero past the live length),
    # top-64 of one 128-key block
    nblk, n_sel = VIEW // BLOCK, BUDGET // BLOCK
    qs = torch.randn(B, 1, dk, generator=g, device=dev).bfloat16()
    ks = torch.randn(B, nblk, dk, generator=g, device=dev).bfloat16()
    for b, n in enumerate(_main_path_lengths()):
        ks[b, -(-n // BLOCK):] = 0
    ws = torch.ones(B, 1, device=dev)
    sblk = max(min(4096, nblk), n_sel)
    a = rt.relevancy_topk_candidates(qs, ks, ws, block=sblk)
    b_ = rt.relevancy_topk_candidates_plain(qs, ks, ws, block=sblk)
    seer_err = _topk_check("relevancy seer shape bf16", *a, *b_)
    a = ops.relevancy_topk(qs, ks, ws, n_sel, block=sblk)
    b_ = ref.relevancy_topk(qs, ks, ws, n_sel)
    seer_err = max(seer_err, _topk_check("relevancy seer top-64", *a, *b_))

    # L2-warm timing: on the path, q_idx and the pooled keys are written by
    # the ops just before the kernel
    row = _relevancy_timing(q, keys, w, block)
    seer = _relevancy_timing(qs, ks, ws, sblk)
    plans = {"DSA": _relevancy_plan(keys, block, 0),
             "Seer": _relevancy_plan(ks, sblk, 0)}
    for name, plan in plans.items():
        log(f"  relevancy split plan at {name}'s shape: {plan}")
    hmma = _sass_count("relevancy_topk", "HMMA")
    log(f"  relevancy library: {hmma} HMMA instructions in its SASS")
    if not hmma:
        raise AssertionError("no HMMA in the relevancy library")
    return {
        "name": "relevancy_topk_candidates", "route": "cuda",
        "source": "src/repro_torch/csrc/relevancy_topk.cu",
        "replaces": "src/repro/kernels/relevancy_topk.py:55",
        "launches": None, "max_abs_err": err, **row, "library_ms": None,
        "timing": "L2-warm (on the path its inputs are written just before)",
        "tolerance": f"values {TOPK_VAL_TOL} x row max|score|; indices "
                     f"equal outside the tie band",
        "split_plan": plans, "ptxas": _ptxas("relevancy_topk"),
        "hmma_in_sass": hmma,
        "shape": f"DSA: q [{B},{Hq},{dk}] bf16, keys [{B},{S},{dk}] bf16, "
                 f"block {block}, c {block}",
        "other_shapes": [dict(
            seer, path="seer", max_abs_err=seer_err, library_ms=None,
            shape=f"q [{B},1,{dk}] bf16, keys [{B},{nblk},{dk}] bf16, "
                  f"w ones, block {sblk}, c {sblk}, top-{n_sel}")],
    }


def _split(x, block, c):
    """The cluster split of a top-c kernel's call on x [B, S or D, ...]."""
    import torch
    from repro_torch.kernels import relevancy_topk as rt

    B, S = x.shape[:2]
    nb = S // block
    n = rt.split_plan(B, nb, block, c, n_sm=torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    return {"n_cta": n, "ctas": B * nb * n, "chunk": block // n}


def _relevancy_plan(keys, block, c):
    """The relevancy kernel's cluster split and scoring route for a call."""
    from repro_torch.kernels import relevancy_topk as rt

    tc = rt.uses_tensor_cores(keys.dtype, keys.shape[2])
    return dict(_split(keys, block, c or block),
                route="tensor cores (mma.sync bf16)" if tc else "CUDA cores")


def _relevancy_timing(q, keys, w, block):
    """Kernel and plain times (L2-warm) and the bound of one candidates
    call."""
    from repro_torch.kernels import relevancy_topk as rt

    ms = time_ms(lambda: rt.relevancy_topk_candidates(q, keys, w,
                                                      block=block))
    plain_ms = time_ms(lambda: rt.relevancy_topk_candidates_plain(
        q, keys, w, block=block))
    return {"ms": ms, "plain_ms": plain_ms,
            **rt.cost(q, keys, w, block=block).bound()}


def _ptxas(source):
    """Each kernel of a source's build: its registers, shared memory and
    spills as ptxas reported them, and any performance warning
    (``_build.BUILD_LOGS``; empty when the library was built by an earlier
    run and only loaded)."""
    from repro_torch.kernels import _build

    out, name = [], None
    for line in _build.BUILD_LOGS.get(source, "").splitlines():
        if "Potential Performance Loss" in line:   # e.g. wgmma serialised
            out.append({"warning": line.strip()})
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes stack frame" in line and name:
            out.append({"kernel": name, "spills": line.strip()})
        elif "Used" in line and "registers" in line and out:
            out[-1]["usage"] = line.split(":", 1)[1].strip()
    return out


def _sass_count(source, mnemonic):
    """Instructions of a mnemonic (HGMMA: wgmma, HMMA: mma.sync) in a built
    library's SASS (``cuobjdump -sass``)."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sum(line.count(mnemonic) for line in sass.splitlines())


def _selected_pages(lengths, n_sel, ps, g, dev):
    """Selections as the sparse methods make them: distinct live pages of
    ``ps`` tokens in score order, -1 where a slot has fewer live pages than
    n_sel."""
    import torch

    rows = []
    for n in lengths:
        live = -(-n // ps)
        perm = torch.randperm(live, generator=g, device=dev)[:n_sel]
        row = torch.full((n_sel,), -1, dtype=torch.int32, device=dev)
        row[: perm.numel()] = perm.to(torch.int32)
        rows.append(row)
    return torch.stack(rows)


def check_paged_attention(dev):
    import torch
    from repro_torch.kernels import sparse_decode_attention as sda

    g = torch.Generator(device=dev).manual_seed(1)
    B, KV, G, dh = SLOTS, 8, 4, 64              # llama3.2-1b GQA
    Hq = KV * G
    lengths = _main_path_lengths()
    q = torch.randn(B, Hq, dh, generator=g, device=dev).bfloat16()
    kc = torch.randn(B, VIEW, KV, dh, generator=g, device=dev).bfloat16()
    vc = torch.randn(B, VIEW, KV, dh, generator=g, device=dev).bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    # DSA: 128 pages of 16; Seer / LServe: 64 pages of 64 (a 4096 budget)
    dsa_pages = _selected_pages(lengths, 2048 // PAGE, PAGE, g, dev)
    blk_pages = _selected_pages(lengths, BUDGET // BLOCK, BLOCK, g, dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    errs, plans = {}, {}
    for name, pages, ps in [("DSA", dsa_pages, PAGE),
                            ("Seer/LServe", blk_pages, BLOCK)]:
        ko, kl = sda.paged_decode_attention(q, kc, vc, pages, lens,
                                            page_size=ps)
        po, pl_ = sda.paged_decode_attention_plain(q, kc, vc, pages, lens,
                                                   page_size=ps)
        errs[name] = _attn_check(f"paged attention {name} shape bf16", ko,
                                 kl, po, pl_)
        pps, n_split = sda.split_plan(B, KV, G, pages.shape[1], ps, n_sm)
        plans[name] = {"pages_per_split": pps, "splits": n_split,
                       "ctas": B * KV * n_split}
    err, blk_err = errs["DSA"], errs["Seer/LServe"]

    # the split's own edges at the DSA shape: one slot; a selection that is
    # no multiple of the split (100 pages in splits of 14)
    for name, rows, n_sel in [("one slot", [0], 2048 // PAGE),
                              ("100 pages, ragged split", [0, 1, 2, 3],
                               100)]:
        pp = dsa_pages[rows, :n_sel].contiguous()
        ll = lens[rows].contiguous()
        a = sda.paged_decode_attention(q[rows], kc[rows], vc[rows], pp, ll,
                                       page_size=PAGE)
        r = sda.paged_decode_attention_plain(q[rows], kc[rows], vc[rows], pp,
                                             ll, page_size=PAGE)
        err = max(err, _attn_check(f"paged attention {name}", *a, *r))
    # a slot whose selected pages all lie at or past its length, in splits
    # of unequal size: out is the mean of v over every loaded token
    n_sel = 13
    pps, n_split = sda.split_plan(3, KV, G, n_sel, PAGE, n_sm)
    if n_sel % pps == 0:
        raise AssertionError(f"all-masked case: splits of {pps} pages are "
                             f"not ragged")
    pp = torch.arange(20, 20 + n_sel, dtype=torch.int32,
                      device=dev).repeat(3, 1)
    ll = torch.tensor([100, 0, 20 * PAGE], dtype=torch.int32, device=dev)
    a = sda.paged_decode_attention(q[:3], kc[:3], vc[:3], pp, ll,
                                   page_size=PAGE)
    r = sda.paged_decode_attention_plain(q[:3], kc[:3], vc[:3], pp, ll,
                                         page_size=PAGE)
    err = max(err, _attn_check(f"paged attention all masked, splits of "
                               f"{pps} pages and {n_sel % pps}", *a, *r))
    want = vc[:3, 20 * PAGE:(20 + n_sel) * PAGE].float().mean(1)
    got = a[0].reshape(3, KV, G, dh)
    if float((got - want[:, :, None]).abs().max()) > ATTN_TOL:
        raise AssertionError("all-masked slot in ragged splits is not the "
                             "mean of v over its loaded tokens")

    # edge cases: fp32, a hole, an all-masked row, a length cut mid-page,
    # pages larger than the kernel's token tile, a ragged last tile
    for name, dt, ps, nsel, S in [("fp32 edge rows", torch.float32, 16, 9,
                                   512),
                                  ("bf16 ps=128", torch.bfloat16, 128, 3,
                                   1024),
                                  ("fp32 ps=4 ragged tile", torch.float32, 4,
                                   7, 256),
                                  ("bf16 ps=64", torch.bfloat16, 64, 12,
                                   1024)]:
        b = 3
        qq = torch.randn(b, Hq, dh, generator=g, device=dev).to(dt)
        kk = torch.randn(b, S, KV, dh, generator=g, device=dev).to(dt)
        vv = torch.randn(b, S, KV, dh, generator=g, device=dev).to(dt)
        pp = torch.stack([torch.randperm(S // ps, generator=g, device=dev)
                          [:nsel] for _ in range(b)]).to(torch.int32)
        pp[0, 1] = -1                              # hole
        pp[2, :] = -1                              # all masked
        ll = torch.tensor([S - ps // 2 - 1, S // 2 + 1, S], dtype=torch.int32,
                          device=dev)
        a = sda.paged_decode_attention(qq, kk, vv, pp, ll, page_size=ps)
        r = sda.paged_decode_attention_plain(qq, kk, vv, pp, ll, page_size=ps)
        err = max(err, _attn_check(f"paged attention {name}", *a, *r))
        want = vv[2, :ps].float().mean(0)          # all-masked row: mean v
        got = a[0][2].reshape(KV, G, dh)
        if float((got - want[:, None]).abs().max()) > ATTN_TOL:
            raise AssertionError("all-masked row is not the page-0 mean of v")

    # the families' shapes on their main paths, DSA's 128 pages of 16:
    # granite's 16 heads over 8 KV heads (G = 2), musicgen's 24 over 24
    # (G = 1), mixtral's 32 over 8 and qwen2-vl's 64 over 8 at head dim 128,
    # zamba2's 32 over 32 at head dim 112 (2 rows, its generate batch)
    family_rows = []
    for path, b, hq_n, kv_n, dh_n in [
            ("granite-dsa: G = 2", SLOTS, 16, 8, 64),
            ("musicgen-dsa: G = 1", SLOTS, 24, 24, 64),
            ("mixtral-dsa: G = 4, dh 128", SLOTS, 32, 8, 128),
            ("qwen2vl-dsa: G = 8, dh 128", SLOTS, 64, 8, 128),
            ("zamba2-dsa-generate: G = 1, dh 112", 2, 32, 32, 112)]:
        qn = torch.randn(b, hq_n, dh_n, generator=g, device=dev).bfloat16()
        kn, vn = (torch.randn(b, VIEW, kv_n, dh_n, generator=g,
                              device=dev).bfloat16() for _ in range(2))
        pn, ln = dsa_pages[:b].contiguous(), lens[:b].contiguous()
        e = _attn_check(f"paged attention {path}", *sda.paged_decode_attention(
            qn, kn, vn, pn, ln, page_size=PAGE),
            *sda.paged_decode_attention_plain(qn, kn, vn, pn, ln,
                                              page_size=PAGE))
        err = max(err, e)
        family_rows.append(dict(
            _paged_timing(qn, kn, vn, pn, ln, PAGE), path=path,
            max_abs_err=e,
            shape=f"q [{b},{hq_n},{dh_n}] bf16, k/v [{b},{VIEW},{kv_n},"
                  f"{dh_n}] bf16, {2048 // PAGE} pages of {PAGE}"))
        del qn, kn, vn

    row = _paged_timing(q, kc, vc, dsa_pages, lens, PAGE)
    blk = _paged_timing(q, kc, vc, blk_pages, lens, BLOCK)
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/sparse_decode_attention.py:66",
        "launches": None, "max_abs_err": err, **row,
        "tolerance": f"out abs {ATTN_TOL}, lse rel {ATTN_TOL}",
        "split_plan": plans, "ptxas": _ptxas("paged_decode_attention"),
        "library": "scaled_dot_product_attention over the pre-gathered "
                   "selected pages with the validity mask (gather not timed)",
        "shape": f"DSA: q [{B},{Hq},{dh}] bf16, k/v [{B},{VIEW},{KV},{dh}] "
                 f"bf16, {2048 // PAGE} pages of {PAGE}",
        "other_shapes": [dict(
            blk, path="seer, lserve", max_abs_err=blk_err,
            shape=f"q [{B},{Hq},{dh}] bf16, k/v [{B},{VIEW},{KV},{dh}] bf16,"
                  f" {BUDGET // BLOCK} pages of {BLOCK}")] + family_rows,
    }


def _paged_timing(q, kc, vc, pages, lens, ps):
    """Kernel, plain and library times of one paged attention call, and its
    bound. On the path the kernel runs right after pool_gather has written
    the whole view (67 MB of K/V per layer), so its pages are mostly out of
    L2: it is timed on copies of k/v rotated past the L2 (cold), and once on
    one copy (warm) beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import sparse_decode_attention as sda

    B, S, KV, dh = kc.shape
    Hq = q.shape[1]
    G = Hq // KV
    n_sel = pages.shape[1]
    # library yardstick: SDPA over the pre-gathered selected pages with the
    # validity mask (gather and GQA expansion not timed)
    safe = pages.clamp(min=0).long()
    rows = torch.arange(B, device=kc.device)[:, None]
    kg = kc.reshape(B, S // ps, ps, KV, dh)[rows, safe]
    vg = vc.reshape(B, S // ps, ps, KV, dh)[rows, safe]
    n_tok = n_sel * ps
    kg = kg.reshape(B, n_tok, KV, dh).permute(0, 2, 1, 3) \
        .repeat_interleave(G, 1).contiguous()
    vg = vg.reshape(B, n_tok, KV, dh).permute(0, 2, 1, 3) \
        .repeat_interleave(G, 1).contiguous()
    tok = safe[:, :, None] * ps + torch.arange(ps, device=kc.device)
    valid = ((pages[:, :, None] >= 0) & (tok < lens[:, None, None])) \
        .reshape(B, 1, 1, n_tok)
    qs = q[:, :, None]
    po, _ = sda.paged_decode_attention_plain(q, kc, vc, pages, lens,
                                             page_size=ps)
    lib_out = F.scaled_dot_product_attention(qs, kg, vg, attn_mask=valid)
    lib_err = float((lib_out[:, :, 0].float() - po).abs().max())
    log(f"  SDPA yardstick vs plain (pages of {ps}): max abs err "
        f"{lib_err:.3g} (bf16 output)")

    # the work this call's data needs: its valid tokens, its pages read
    cost = sda.cost(q, kc, vc, pages, lens, page_size=ps,
                    valid_tokens=int(valid.sum()),
                    pages_read=sum(max(int((r >= 0).sum()), 1)
                                   for r in pages))
    n_bytes = cost.bytes

    n = cold_copies(n_bytes)
    ks = [kc] + [kc.clone() for _ in range(n - 1)]
    vs = [vc] + [vc.clone() for _ in range(n - 1)]
    ms = time_ms([lambda k=k, v=v: sda.paged_decode_attention(
        q, k, v, pages, lens, page_size=ps) for k, v in zip(ks, vs)])
    ms_warm = time_ms(lambda: sda.paged_decode_attention(
        q, kc, vc, pages, lens, page_size=ps))
    plain_ms = time_ms([lambda k=k, v=v: sda.paged_decode_attention_plain(
        q, k, v, pages, lens, page_size=ps) for k, v in zip(ks, vs)])
    del ks, vs
    n_lib = cold_copies(2 * kg.numel() * kg.element_size())
    kgs = [kg] + [kg.clone() for _ in range(n_lib - 1)]
    vgs = [vg] + [vg.clone() for _ in range(n_lib - 1)]
    library_ms = time_ms([lambda k=k, v=v: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=valid) for k, v in zip(kgs, vgs)])
    del kgs, vgs
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **cost.bound(), "ms_l2_warm": ms_warm,
            "timing": f"cold L2: ms, plain_ms and library_ms rotate over {n}, "
                      f"{n}, {n_lib} copies of their k/v; ms_l2_warm on one "
                      f"copy"}


def _exact(name, a, b):
    """Bit-for-bit equality of two fp32 tensors (NaN-free inputs)."""
    import torch

    if a.shape != b.shape or not torch.equal(a.view(torch.int32),
                                             b.view(torch.int32)):
        raise AssertionError(f"{name}: not bit-exact")


def _exact_nan(name, a, b):
    """NaN exactly where ``b`` has NaN, every other element bit-exact (a
    NaN's payload is free)."""
    import torch

    nan = b.isnan()
    if a.shape != b.shape or not torch.equal(a.isnan(), nan):
        raise AssertionError(f"{name}: NaN positions differ")
    _exact(name, a.masked_fill(nan, 0), b.masked_fill(nan, 0))


def _plan_note(k, ps):
    """The bulk route's plan for ``k`` on its card, or that it takes the
    scalar one."""
    import torch
    from repro_torch.kernels import page_pool as pp

    B, S, KV, dh = k.shape
    if KV * dh * k.element_size() % 16:
        return "scalar route"
    n_sm = torch.cuda.get_device_properties(k.device).multi_processor_count
    p = pp.minmax_plan(B, S, KV * dh, k.element_size(), ps, n_sm)
    return (f"{p.tiles} tiles of {p.rows} x {16 * p.W} B in {p.bands} "
            f"band(s) on {p.grid} CTAs, {p.stages} stages, {p.smem} B")


def check_page_minmax(dev):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import page_pool as pp

    g = torch.Generator(device=dev).manual_seed(4)
    B, KV, dh, ps = SLOTS, 8, 64, BLOCK
    k = torch.randn(B, VIEW, KV, dh, generator=g, device=dev).bfloat16()
    for b, n in enumerate(_main_path_lengths()):   # the view: zeros past live
        k[b, n:] = 0
    mn, mx = pp.page_minmax(k, page_size=ps)
    pmn, pmx = pp.page_minmax_plain(k, page_size=ps)
    _exact("page_minmax main path min", mn, pmn)
    _exact("page_minmax main path max", mx, pmx)
    log(f"  page_minmax LServe shape bf16: bit-exact ({mn.numel()} x 2)")
    # edge cases through the public op: fp32, 16-token pages, one page,
    # all-negative and mixed-sign values, scalar loads (KV x dh = 15); the
    # bulk route's plans: 4 pieces a row (the hybrid's C = 3584 fp32),
    # fewer tiles than SMs (8), more than 2 x SMs (2048), two CTAs an SM
    # (ps 16's 256 tiles), bands a page (ps 128), uneven pieces (4176-byte
    # rows: 131 + 130 vectors)
    cases = [("fp32", torch.float32, 4, 1024, 8, 64, 64, False),
             ("bf16 ps=16", torch.bfloat16, 4, 1024, 8, 64, 16, False),
             ("one page", torch.bfloat16, 2, 64, 8, 64, 64, False),
             ("all negative", torch.bfloat16, 2, 256, 8, 64, 64, True),
             ("mixed sign fp32", torch.float32, 2, 256, 8, 64, 16, False),
             ("scalar loads bf16", torch.bfloat16, 2, 128, 3, 5, 64, False),
             ("scalar loads fp32", torch.float32, 2, 128, 3, 5, 16, False),
             ("C 3584 fp32", torch.float32, 2, 2048, 32, 112, 64, False),
             ("8 tiles bf16", torch.bfloat16, 1, 512, 8, 64, 64, False),
             ("2048 tiles fp32 ps=16", torch.float32, 4, 4096, 8, 64, 16,
              False),
             ("two bands bf16 ps=128", torch.bfloat16, 2, 1024, 8, 64, 128,
              False),
             ("uneven pieces bf16", torch.bfloat16, 2, 1024, 8, 261, 64,
              False)]
    for name, dt, b, S, kv, d, p, negative in cases:
        kk = torch.randn(b, S, kv, d, generator=g, device=dev) * 3 - 0.5
        if negative:
            kk = -kk.abs() - 0.1
        kk = kk.to(dt)
        a = ops.page_minmax(kk, page_size=p)
        r = pp.page_minmax_plain(kk, page_size=p)
        _exact(f"page_minmax {name} min", a[0], r[0])
        _exact(f"page_minmax {name} max", a[1], r[1])
        log(f"  page_minmax {name}: bit-exact ({_plan_note(kk, p)})")
    # NaN and +-inf in some pages: NaN where the plain version has NaN,
    # every other element bit-exact
    for dt, kv, d in ((torch.float32, 8, 64), (torch.bfloat16, 8, 64),
                      (torch.float32, 32, 112)):
        kk = torch.randn(2, 512, kv, d, generator=g, device=dev) * 3 - 0.5
        kk[0, 70, 1, 3] = kk[1, 5, 7, 63] = float("nan")     # pages 1, 0
        kk[0, 130:140, 2] = float("inf")                     # page 2
        kk[1, 200, :, 10:20] = -float("inf")                 # page 3
        kk[1, 260, 0] = float("nan")                         # page 4: both
        kk[1, 261, 0] = float("inf")
        kk[1, 300:320, 4:6] = float("nan")                   # whole columns
        kk = kk.to(dt)
        a = ops.page_minmax(kk, page_size=64)
        r = pp.page_minmax_plain(kk, page_size=64)
        for i, what in enumerate(("min", "max")):
            _exact_nan(f"page_minmax NaN/inf {dt} C {kv * d} {what}", a[i],
                       r[i])
        log(f"  page_minmax NaN and inf, {dt}, C {kv * d}: NaN where the "
            f"plain version's, the rest bit-exact")
    try:
        pp.page_minmax(k[:, : ps + 1], page_size=ps)
    except ValueError:
        pass
    else:
        raise AssertionError("page_minmax accepted S % page_size != 0")

    # on the path it reads the view pool_gather has just written (67 MB of
    # K and V per layer), so its keys are mostly out of L2: cold timing
    n = cold_copies(pp.cost(k, page_size=ps).bytes)
    ks = [k] + [k.clone() for _ in range(n - 1)]
    ms = time_ms([lambda x=x: pp.page_minmax(x, page_size=ps) for x in ks])
    ms_warm = time_ms(lambda: pp.page_minmax(k, page_size=ps))
    plain_ms = time_ms([lambda x=x: pp.page_minmax_plain(x, page_size=ps)
                        for x in ks])

    def library(x):
        lo, hi = torch.aminmax(x.view(B, VIEW // ps, ps, KV, dh), dim=2)
        return lo.float(), hi.float()

    lo, hi = library(k)
    _exact("aminmax yardstick min", lo, pmn)
    library_ms = time_ms([lambda x=x: library(x) for x in ks])
    del ks
    log(f"  page_minmax main path: {ms:.5f} ms cold (warm {ms_warm:.5f}), "
        f"plain {plain_ms:.5f}, aminmax {library_ms:.5f}")
    return {
        "name": "page_minmax", "route": "cuda",
        "source": "src/repro_torch/csrc/page_minmax.cu",
        "replaces": "src/repro/kernels/page_pool.py:99",
        "launches": None, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, **pp.cost(k, page_size=ps).bound(),
        "ms_l2_warm": ms_warm,
        "timing": f"cold L2: ms, plain_ms and library_ms rotate over {n} "
                  f"copies of k; ms_l2_warm on one copy",
        "tolerance": "bit-exact",
        "library": "torch.aminmax over the page axis, then .float()",
        "shape": f"k [{B},{VIEW},{KV},{dh}] bf16, pages of {ps}",
        "plan": _plan_note(k, ps),
    }


def card_corpus(dev):
    """The serving runs' corpus, built once per process: 250,000 synthetic
    Zipf docs over the reference CLI's 1024-term retrieval vocab, up to 64
    tokens each (``build_corpus``; the store pads it to 262,144 rows)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import build_corpus

    if "corpus" not in _CACHE:
        t0 = time.perf_counter()
        _CACHE["corpus"] = build_corpus(
            CORPUS_DOCS, retrieval_vocab=RETRIEVAL_VOCAB, doc_max=DOC_MAX,
            gen_vocab=get_arch(SERVE_ARCH).vocab_size, seed=0, device=dev)
        log(f"  corpus of {CORPUS_DOCS} docs built in "
            f"{time.perf_counter() - t0:.1f} s")
    return _CACHE["corpus"]


def check_bm25(dev):
    """The BM25 kernel against its plain version at the serving shape (one
    query of 8 terms over the card corpus's 262,144-row store, 250,000 live,
    k = 4, block 4096), at the paper's Fig. 10 shape
    (``benchmarks/bench_kernel_speedup.py:60``: D 16384, T 16, k 64) and at
    edge cases."""
    import numpy as np
    import torch
    from repro_torch.data import sample_queries
    from repro_torch.kernels import bm25_topk as bm
    from repro_torch.kernels import ops, ref
    from repro_torch.retrieval.select import _bm25_panel, make_retrieval_select

    corpus = card_corpus(dev)
    state = make_retrieval_select("rag", corpus=corpus, k=RAG_K).summary_init()
    terms = sample_queries(corpus, 1, 8, seed=1)
    tfq, idf, dln = _bm25_panel(state, terms)
    nd = state["n_docs"]
    D = tfq.shape[1]
    blk = 4096
    kv, ki = bm.bm25_topk_candidates(tfq, dln, idf, block=blk, c=RAG_K,
                                     avgdl=1.0, valid=nd)
    pv, pi = bm.bm25_topk_candidates_plain(tfq, dln, idf, block=blk, c=RAG_K,
                                           avgdl=1.0, valid=nd)
    err = _topk_check("bm25 serving shape", kv, ki, pv, pi)
    a = ops.bm25_topk(tfq, dln, idf, RAG_K, block=blk, avgdl=1.0, valid=nd)
    scores = ref.bm25_scores(tfq, dln, idf, avgdl=1.0)
    live = torch.arange(D, device=dev)[None] < nd
    b_ = ref.topk_stable(torch.where(live, scores, torch.full_like(
        scores, float("-inf"))), RAG_K)
    err = max(err, _topk_check("bm25 serving top-4", *a, *b_))

    rng = np.random.default_rng(7)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    # Fig. 10 (right): tf ~ Poisson(1), doc lengths 20..199, idf in [0, 1)
    F, FT, FK = 16384, 16, 64
    f_tf = t(rng.poisson(1.0, (1, F, FT)))
    f_dl = t(rng.integers(20, 200, (1, F)))
    f_idf = t(rng.random((1, FT)))
    fig = _topk_check("bm25 Fig. 10 shape",
                      *bm.bm25_topk_candidates(f_tf, f_dl, f_idf, block=blk,
                                               c=FK),
                      *bm.bm25_topk_candidates_plain(f_tf, f_dl, f_idf,
                                                     block=blk, c=FK))
    fig = max(fig, _topk_check("bm25 Fig. 10 top-64",
                               *ops.bm25_topk(f_tf, f_dl, f_idf, FK,
                                              block=blk),
                               *ref.bm25_topk(f_tf, f_dl, f_idf, FK)))

    def panel(B, n, T, zero=False, dup=False):
        tf = np.zeros((B, n, T)) if zero else rng.poisson(0.7, (B, n, T))
        dl = rng.integers(16, 64, (B, n)).astype(np.float64)
        if dup:             # rows in equal pairs: equal nonzero scores
            tf[:, 1::2], dl[:, 1::2] = tf[:, ::2], dl[:, ::2]
        return t(tf), t(dl), t(rng.random((B, T)) + 0.1)

    # edge cases: (name, panel, k, block, valid, ties must match exactly)
    cases = [("D=5000 padded to 8192", panel(1, 5000, 8), 16, blk, None,
              False),
             ("valid=0 means D", panel(2, 2048, 8), 8, 512, 0, False),
             ("all-zero panel", panel(2, 1024, 8, zero=True), 8, 256, None,
              True),
             ("duplicated rows", panel(2, 1024, 8, dup=True), 32, 256, None,
              False),
             ("B=4, T=1", panel(4, 4096, 1), 16, 1024, None, False),
             ("3 live docs < c", panel(1, 1024, 8), 8, 256, 3, True),
             # 8192 + 100 live: the count falls in block 2's first CTA
             ("nd in a cluster's first CTA", panel(1, 16384, 8), 16, blk,
              8292, False)]
    for name, (a_tf, a_dl, a_idf), k, b, valid, exact in cases:
        if valid is not None and a_tf.shape[1] % b == 0:
            kc = bm.bm25_topk_candidates(a_tf, a_dl, a_idf, block=b, c=k,
                                         valid=valid)
            pc = bm.bm25_topk_candidates_plain(a_tf, a_dl, a_idf, block=b,
                                               c=k, valid=valid)
            err = max(err, _topk_check(f"bm25 {name} candidates", *kc, *pc))
            if exact and not torch.equal(kc[1], pc[1]):
                raise AssertionError(f"bm25 {name}: tie order differs")
        v = None if valid == 0 else valid     # ops: None means all D
        got = ops.bm25_topk(a_tf, a_dl, a_idf, k, block=b, valid=v)
        want = ops_plain_bm25(a_tf, a_dl, a_idf, k, v)
        err = max(err, _topk_check(f"bm25 {name}", *got, *want))
        if name == "duplicated rows" and not bool(
                (want[0][:, 1:] == want[0][:, :-1]).any()):
            raise AssertionError("bm25 duplicated rows: no tie compared")
        if exact and not torch.equal(got[1], want[1]):
            raise AssertionError(f"bm25 {name}: tie order differs")
        if name == "all-zero panel" and not torch.equal(
                got[1].long(), torch.arange(k, device=dev).expand(2, k)):
            raise AssertionError("bm25 all-zero panel: ids are not 0..k-1")

    row = _bm25_timing(state, terms, tfq, dln, idf, nd, blk)
    plans = {"serving": _split(tfq, blk, RAG_K),
             "Fig. 10": _split(f_tf, blk, FK)}
    for name, plan in plans.items():
        log(f"  bm25 split plan at the {name} shape: {plan}")
    return {
        "name": "bm25_topk_candidates", "route": "cuda",
        "source": "src/repro_torch/csrc/bm25_topk.cu",
        "replaces": "src/repro/kernels/bm25_topk.py:47",
        "launches": None, "max_abs_err": err, **row, "library_ms": None,
        "library": "none: no one PyTorch call computes BM25 and a top-k",
        "tolerance": f"values {TOPK_VAL_TOL} x row max|score|; indices "
                     f"equal outside the tie band, exactly equal in the tie "
                     f"cases",
        "split_plan": plans, "ptxas": _ptxas("bm25_topk"),
        "shape": f"serving: tf panel [1,{D},8] fp32 (gathered from the "
                 f"[{D},{RETRIEVAL_VOCAB}] int32 store), {int(nd)} live, "
                 f"block {blk}, c {RAG_K}",
        "other_shapes": [dict(
            _bm25_kernel_times(f_tf, f_dl, f_idf, blk, FK, 100.0, 0),
            path="Fig. 10", max_abs_err=fig, library_ms=None,
            shape=f"tf [1,{F},{FT}] fp32, block {blk}, c {FK}, k {FK}")],
    }


def ops_plain_bm25(tf, dl, idf, k, valid):
    """``ops.bm25_topk`` through the plain path (``use_kernels(False)``)."""
    from repro_torch.kernels import ops

    ops.use_kernels(False)
    try:
        return ops.bm25_topk(tf, dl, idf, k, valid=valid)
    finally:
        ops.use_kernels(True)


def _bm25_kernel_times(tf, dl, idf, block, c, avgdl, valid):
    """Kernel (L2-warm and cold) and plain times of one candidates call and
    its bound. On the path the gather writes the panel just before the
    kernel reads it, so ``ms`` is L2-warm; ``ms_cold`` rotates over copies
    of the panel that together pass twice the L2."""
    import torch
    from repro_torch.kernels import bm25_topk as bm

    kw = dict(block=block, c=c, avgdl=avgdl, valid=valid)
    ms = time_ms(lambda: bm.bm25_topk_candidates(tf, dl, idf, **kw))
    plain_ms = time_ms(lambda: bm.bm25_topk_candidates_plain(tf, dl, idf,
                                                             **kw))
    n = cold_copies((tf.numel() + dl.numel()) * 4)
    tfs = [tf] + [tf.clone() for _ in range(n - 1)]
    dls = [dl] + [dl.clone() for _ in range(n - 1)]
    ms_cold = time_ms([lambda x=x, y=y: bm.bm25_topk_candidates(x, y, idf,
                                                                **kw)
                       for x, y in zip(tfs, dls)])
    del tfs, dls
    return {"ms": ms, "plain_ms": plain_ms, "ms_cold": ms_cold,
            # the live docs this run's data holds (the store's count)
            **bm.cost(tf, dl, idf, block=block, c=c,
                      valid=int(valid)).bound(),
            "timing": f"ms and plain_ms L2-warm; ms_cold rotates over {n} "
                      f"copies of the panel and doc lengths"}


def _bm25_timing(state, terms, tfq, dln, idf, nd, block):
    """The serving shape's kernel times, and the time of the panel gather
    before it (plain torch, as in the reference: eight strided int32
    columns of the 1 GB store)."""
    from repro_torch.retrieval.select import _bm25_panel

    row = _bm25_kernel_times(tfq, dln, idf, block, RAG_K, 1.0, nd)
    row["gather_ms"] = time_ms(lambda: _bm25_panel(state, terms))
    return row


def _flash_check(name, got, want):
    """fp32: within ATTN_TOL; bf16: within one bf16 ulp of the plain version
    (both round an fp32 result to bf16)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    rtol, atol = (0.0, ATTN_TOL) if got.dtype == torch.float32 else BF16_ULP
    bad = diff > atol + rtol * want.float().abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: {int(bad.sum())} values off, max abs "
                             f"err {err}")
    log(f"  {name}: max abs err {err:.3g} "
        f"({'abs ' + str(ATTN_TOL) if rtol == 0 else 'one bf16 ulp'})")
    return err


def ops_plain_flash(q, k, v, window):
    """``ops.flash_attention`` through the plain path (``use_kernels(False)``:
    ``ref.flash_attention``)."""
    from repro_torch.kernels import ops

    ops.use_kernels(False)
    try:
        return ops.flash_attention(q, k, v, window=window)
    finally:
        ops.use_kernels(True)


def _kernel_names(fn):
    """The CUDA kernels one call of ``fn`` launches (torch.profiler)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    return sorted({e.key[:120] for e in prof.key_averages()
                   if e.device_type != cpu})


def _flash_timing(q, k, v, window, plain_n=20):
    """Kernel (cold and L2-warm), plain and library times of one call, the
    bound, and the kernels the library call lands on. Cold: copies of q, k,
    v rotated past twice the L2; the plain version and SDPA are timed on
    the same copies."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    B, S, H, dh = q.shape
    in_bytes = (q.numel() + 2 * k.numel()) * q.element_size()
    n = cold_copies(in_bytes)
    cp = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v))
                        for _ in range(n - 1)]
    ms = time_ms([lambda a=a: fa.flash_attention(*a, window=window)
                  for a in cp])
    ms_warm = time_ms(lambda: fa.flash_attention(q, k, v, window=window))
    plain_ms = time_ms([lambda a=a: ops_plain_flash(*a, window) for a in cp],
                       n=plain_n)
    # SDPA on the [B, H, S, dh] views; a boolean band mask under a window
    mask = None
    if window:
        pos = torch.arange(S, device=q.device)
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :]
                                                 < window)

    def lib(a):
        qt, kt, vt = (t.transpose(1, 2) for t in a)
        if mask is None:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    lib_err = float((lib(cp[0]).transpose(1, 2).float()
                     - ops_plain_flash(q, k, v, window).float()).abs().max())
    log(f"  SDPA yardstick vs plain: max abs err {lib_err:.3g}")
    library_ms = time_ms([lambda a=a: lib(a) for a in cp])
    backend = _kernel_names(lambda: lib(cp[0]))
    del cp
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **fa.cost(q, k, v, window=window).bound(),
            "ms_l2_warm": ms_warm, "library_kernels": backend,
            "library": "scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True)" if not window else
                       "scaled_dot_product_attention(attn_mask=bool band, "
                       "enable_gqa=True)",
            "timing": f"cold L2: ms, plain_ms and library_ms rotate over {n} "
                      f"copies of q/k/v; ms_l2_warm on one copy"}


def check_flash_attention(dev):
    """The flash kernel against its plain version at the training shape,
    the serve runs' bucketed-prefill shape, mixtral's attention at S 8192,
    the families' prefill shapes and edge cases;
    its gradients (``FlashAttention``) against autograd through the plain
    version at fp32."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(7)

    def qkv(B, S, H, KV, dh, dt=torch.bfloat16):
        return [torch.randn(B, S, n, dh, generator=g, device=dev).to(dt)
                for n in (H, KV, KV)]

    shapes = {  # path: (B, S, H, KV, dh, window, plain timing calls)
        "train": (TRAIN_B, TRAIN_S, 32, 8, 64, 0, 20),
        "serve bucketed prefill": (len(SHORT_LENS), PREFILL_BUCKET, 32, 8,
                                   64, 0, 20),
        "mixtral attention": (1, 8192, 32, 8, 128, 4096, 2),
        # the families' prefills on their main paths: granite's bucketed
        # one (G = 2); the legacy pool's whole prompt (B 1, the longest);
        # mixtral's and qwen2-vl's bucketed ones (dh 128, mixtral's window
        # passed to the kernel, G = 4 and 8); zamba2's shared block at its
        # generate prefill (dh 112, G = 1, on the tensor cores: two
        # 64-channel boxes a tile, zero past 112; its first version ran on
        # the CUDA cores)
        "granite prefill": (len(SHORT_LENS), PREFILL_BUCKET, 16, 8, 64, 0,
                            20),
        "legacy whole-prompt prefill": (1, max(PROMPT_LENS), 32, 8, 64, 0,
                                        2),
        "mixtral bucketed prefill": (len(SHORT_LENS), PREFILL_BUCKET, 32, 8,
                                     128, 4096, 20),
        "qwen2-vl bucketed prefill": (len(SHORT_LENS), PREFILL_BUCKET, 64,
                                      8, 128, 0, 20),
        "zamba2 prefill": (2, 4480, 32, 32, 112, 0, 2),
        # MemAgent's prefills (Appendix D): [memory 1024; segment 5000] and
        # [memory 1024; question 64], B 2 (rows 3f and 3g)
        "memagent segment prefill": (2, 6024, 32, 8, 64, 0, 2),
        "memagent answer prefill": (2, 1088, 32, 8, 64, 0, 20),
        # the train_sharded phase: each of the gathered step's 2 data
        # indices (B 4 / 2, all heads); a model shard of each of the
        # sharded step's 2 data indices (B 4 / 2; 32 / 4 q and 8 / 4 kv
        # heads);
        # granite's expert-parallel step (16 / 4 and 8 / 4); a model shard
        # of each of the pod sync's 4 data indices (B 4 / 4; 32 / 2 and
        # 8 / 2); a GPipe microbatch (no model split)
        "gathered": (TRAIN_B // 2, TRAIN_S, 32, 8, 64, 0, 20),
        "train_sharded": (TRAIN_B // 2, TRAIN_S, 32 // CLI_TP, 8 // CLI_TP,
                          64, 0, 20),
        "granite_tp": (TRAIN_B, TRAIN_S, 16 // CLI_TP, 8 // CLI_TP, 64, 0,
                       20),
        "pod sync": (TRAIN_B // 4, TRAIN_S, 16, 4, 64, 0, 2),
        "gpipe": (1, TRAIN_S, 32, 8, 64, 0, 20),
        # the hybrid_sharded phase's train step: a model shard of zamba2's
        # shared block (B 4 / 2; 32 / 4 q and kv heads, dh 112)
        "hybrid_sharded": (TRAIN_B // 2, TRAIN_S, 32 // CLI_TP, 32 // CLI_TP,
                           112, 0, 2),
    }
    def routed(name, fn, want_route):
        """``fn()``, checked to launch once on ``want_route``."""
        n0 = ops.flash_route_counts()
        out = fn()
        n1 = ops.flash_route_counts()
        took = [r for r in n1 if n1[r] != n0[r]]
        if took != [want_route] or n1[want_route] != n0[want_route] + 1:
            raise AssertionError(f"flash {name}: routes {n0} -> {n1}, "
                                 f"expected one {want_route} launch")
        return out

    rows, err, routes = {}, 0.0, {}
    for path, (B, S, H, KV, dh, w, pn) in shapes.items():
        q, k, v = qkv(B, S, H, KV, dh)
        routes[path] = fa._route(torch.bfloat16, dh)
        got = routed(path, lambda: fa.flash_attention(q, k, v, window=w),
                     routes[path])
        e = _flash_check(f"flash {path} bf16", got,
                         ops_plain_flash(q, k, v, w))
        err = max(err, e)
        rows[path] = r = dict(_flash_timing(q, k, v, w, plain_n=pn),
                              path=path, max_abs_err=e, route=routes[path],
                              shape=f"q [{B},{S},{H},{dh}] bf16, k/v [{B},"
                                    f"{S},{KV},{dh}] bf16, window "
                                    f"{w or 'none'}")
        log(f"  flash {path} ({r['route']}): {r['ms']:.4g} ms, bound "
            f"{r['bound_ms']:.4g} ({r['bound_by']}), SDPA "
            f"{r['library_ms']:.4g}, plain {r['plain_ms']:.4g}")
        del q, k, v
        torch.cuda.empty_cache()

    # edge cases through the public op: ragged S, S below the tile, a
    # window below the tile, G = 1, fp32, dh 32, 112 and 128; bf16 at dh
    # 64, 112 and 128 on the tensor cores, the rest on the CUDA cores
    f32, bf16 = torch.float32, torch.bfloat16
    for name, B, S, H, KV, dh, w, dt in [
            ("S=200 ragged", 2, 200, 8, 2, 64, 0, bf16),
            ("S=37 below the tile", 2, 37, 8, 8, 128, 0, f32),
            ("bf16 S=37 below the tile", 2, 37, 8, 8, 128, 0, bf16),
            ("window 48 below the tile", 2, 256, 8, 2, 64, 48, bf16),
            ("G=1", 1, 300, 4, 4, 32, 0, f32),
            ("bf16 G=1", 1, 300, 4, 4, 64, 0, bf16),
            ("bf16 dh 32", 1, 300, 4, 2, 32, 0, bf16),
            ("fp32 training heads", 1, 1024, 32, 8, 64, 0, f32),
            ("fp32 sharded step's model shard", TRAIN_B // 2,
             SHARDED_FP32_S, 32 // CLI_TP, 8 // CLI_TP, 64, 0, f32),
            ("fp32 window 96", 1, 700, 8, 2, 128, 96, f32),
            ("bf16 window 96", 1, 700, 8, 2, 128, 96, bf16),
            ("bf16 dh 112 G=1 ragged", 1, 300, 4, 4, 112, 0, bf16),
            ("bf16 dh 112 G=4 S=200 ragged", 2, 200, 8, 2, 112, 0, bf16),
            ("bf16 dh 112 S=37 below the tile", 2, 37, 8, 8, 112, 0, bf16),
            ("bf16 dh 112 window 48 below the tile", 2, 256, 8, 4, 112, 48,
             bf16),
            ("bf16 dh 112 window 96", 1, 700, 8, 2, 112, 96, bf16),
            ("fp32 dh 112 G=1 ragged", 1, 300, 4, 4, 112, 0, f32),
            ("fp32 dh 112 window 96", 1, 700, 8, 2, 112, 96, f32)]:
        q, k, v = qkv(B, S, H, KV, dh, dt)
        routes[name] = fa._route(dt, dh)
        got = routed(name, lambda: ops.flash_attention(q, k, v, window=w),
                     routes[name])
        err = max(err, _flash_check(f"flash {name} ({routes[name]})", got,
                                    ops_plain_flash(q, k, v, w)))
    # bf16 views TMA cannot read in place (base 2 bytes off 16): copied
    B, S, H, KV = 2, 130, 8, 2
    for dh in (64, 112):
        qkv_ = torch.randn(B * S * (H + 2 * KV) * dh + 1, generator=g,
                           device=dev).bfloat16()[1:].view(B, S, H + 2 * KV,
                                                           dh)
        q, k, v = qkv_[:, :, :H], qkv_[:, :, H:H + KV], qkv_[:, :, H + KV:]
        if q.data_ptr() % 16 == 0:
            raise AssertionError("the misaligned view is aligned")
        name = f"bf16 dh {dh} view 2 bytes off 16"
        got = routed(name, lambda: fa.flash_attention(q, k, v, window=50),
                     fa.TENSOR_CORES)
        routes[name] = fa.TENSOR_CORES
        err = max(err, _flash_check(f"flash {name}", got, ops_plain_flash(
            q.contiguous(), k.contiguous(), v.contiguous(), 50)))
    hgmma = _sass_count("flash_attention_sm90", "HGMMA")
    hgmma112 = _sass_count("flash_attention_sm90", "HGMMA.64x112")
    log(f"  flash tensor-core library: {hgmma} HGMMA instructions in its "
        f"SASS, {hgmma112} of them 64x112 (dh 112's P.V)")
    if not hgmma or not hgmma112:
        raise AssertionError("no HGMMA (or none of N 112) in the "
                             "tensor-core flash library")

    # gradients: B 1, S 1024, llama's heads, fp32, a random cotangent
    q, k, v = qkv(1, 1024, 32, 8, 64, f32)
    cot = torch.randn(q.shape, generator=g, device=dev)
    grads = []
    for fn in (lambda *a: fa.FlashAttention.apply(*a, 0),
               lambda *a: ref.flash_attention(*a)):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*ts).backward(cot)
        grads.append([t.grad for t in ts])
    grad_err = 0.0
    for name, a, b in zip("qkv", *grads):
        e = float((a - b).abs().max())
        tol = ATTN_TOL * max(1.0, float(b.abs().max()))
        if not e <= tol:
            raise AssertionError(f"flash d{name}: err {e} > {tol}")
        grad_err = max(grad_err, e)
    log(f"  flash gradients fp32 [1,1024,32,64]: dq/dk/dv max abs err "
        f"{grad_err:.3g} (tol {ATTN_TOL} x max(1, max|g|))")

    head = rows.pop("train")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:70",
        "launches": None, **head, "max_abs_err": err,
        "grad_max_abs_err": grad_err, "routes": routes,
        "sources_by_route": {
            fa.TENSOR_CORES: "src/repro_torch/csrc/flash_attention_sm90.cu",
            fa.CUDA_CORES: "src/repro_torch/csrc/flash_attention.cu"},
        "hgmma_instructions": hgmma, "hgmma_64x112_instructions": hgmma112,
        "ptxas": {src: _ptxas(src) for src in ("flash_attention_sm90",
                                               "flash_attention")},
        "tolerance": f"fp32 out abs {ATTN_TOL}; bf16 out within one bf16 "
                     f"ulp (rtol {BF16_ULP[0]}, atol {BF16_ULP[1]}); "
                     f"gradients abs {ATTN_TOL} x max(1, max|g|)",
        "other_shapes": list(rows.values()),
    }


# ---------------------------------------------------------------------------
# phase 3: training
# ---------------------------------------------------------------------------


def _train_batches(cfg, dev, n: int, B: int, S: int, seed: int = 0):
    """n ``TokenStream`` batches on the card."""
    import torch
    from repro_torch.data import TokenStream

    it = iter(TokenStream(cfg.vocab_size, S, B, seed=seed))
    return [{k: torch.as_tensor(v, device=dev) for k, v in next(it).items()}
            for _ in range(n)]


def _profile_steps(tr, batches):
    """Train steps under torch.profiler: wall and device-busy time, the flash
    kernel's mean in-situ time, and the device time of the attention
    backward's plain recompute (the ``flash_attention.backward`` ranges).
    Writes chiprun_out/profile_train.{txt,json.gz}."""
    import torch

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    for b in batches:
        tr.train_step(b)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    prof.stop()
    cpu = torch.autograd.DeviceType.CPU
    rng = "flash_attention.backward"
    # kernels, copies and sets; the device side of a record_function range
    # is a span over kernels counted already
    dev_us = sum(e.self_device_time_total for e in prof.events()
                 if e.device_type != cpu and e.name != rng
                 and not getattr(e, "is_user_annotation", False))
    avgs = prof.key_averages()
    hits = [e for e in avgs if KERNEL_SYMBOLS["flash_attention"] in e.key]
    if not hits:
        raise AssertionError("profile: no flash kernel in the train steps")
    flash_ms = sum(e.self_device_time_total for e in hits) / sum(
        e.count for e in hits) / 1e3
    # the host-side ranges: the device time of the kernels under them
    bwd = [e for e in prof.events() if e.name == rng and e.device_type == cpu]
    if not bwd:
        raise AssertionError(f"profile: no {rng} range")
    bwd_us = sum(e.device_time_total for e in bwd)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    stem = os.path.join(out, "profile_train")
    with open(stem + ".txt", "w") as f:
        f.write(f"card: {card_line()}\n{len(batches)} steps: wall "
                f"{wall_us:.0f} us, device busy {dev_us:.0f} us "
                f"({100 * dev_us / wall_us:.1f}%), attention backward "
                f"recompute {bwd_us:.0f} us\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=40))
    prof.export_chrome_trace(stem + ".json.gz")
    return {"steps": len(batches), "wall_us": wall_us,
            "device_busy_us": dev_us, "device_busy_share": dev_us / wall_us,
            "flash_ms_in_situ": flash_ms,
            "attn_backward_recompute_us": bwd_us,
            "attn_backward_recompute_share_of_busy": bwd_us / dev_us}


def _profile_busy(tr, batches):
    """Train steps under torch.profiler (CUDA activity only): wall and
    device-busy time, the flash kernel's mean in-situ time and the device
    ops (kernels, copies, fills) a step, from the raw kineto events. No ``FunctionEvent`` tree is built: for eager
    loops of many small ops (the SSD chunks, xLSTM's tokens) that tree costs
    tens of seconds a step."""
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    losses = [tr.train_step(b)["loss"] for b in batches]
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    busy_ns = flash_ns = n_flash = n_events = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        busy_ns += e.duration_ns()
        n_events += 1
        if KERNEL_SYMBOLS["flash_attention"] in e.name():
            flash_ns += e.duration_ns()
            n_flash += 1
    dev_us = busy_ns / 1e3
    return {"steps": len(batches), "wall_us": wall_us, "losses": losses,
            "device_busy_us": dev_us, "device_busy_share": dev_us / wall_us,
            "flash_ms_in_situ": flash_ns / n_flash / 1e6 if n_flash else None,
            "flash_launches_profiled": n_flash,
            "device_ops_per_step": n_events / len(batches)}


def phase_train(dev):
    """Full-width llama3.2-1b in bf16 (seeded random weights, ``TokenStream``
    data, remat, B 4 x S 2048, lr 3e-3 with 5 warm-up steps): 6 steps with
    finite, falling loss and 2 flash launches per layer per step (forward and
    remat recompute; counts reset just before and read just after); two
    profiled steps; one step with accum 2; a checkpoint round trip
    (``_resume_check``, at POD_LAYERS layers); then at fp32, B 1 x S 1024,
    one step's loss and gradients through the kernel against the plain
    path. Returns the flash launches of the 6 steps."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.train import (OptConfig, Trainer, TrainConfig,
                                   make_train_step)

    cfg = get_arch(TRAIN_ARCH)
    B, S, L = TRAIN_B, TRAIN_S, cfg.n_layers
    batches = _train_batches(cfg, dev, TRAIN_STEPS + 3, B, S)
    tc = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5,
                                   total_steps=TRAIN_STEPS),
                     remat=True, tp=16)
    tr = Trainer(cfg, tc, init_params(cfg, 0, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, per_step = [], [], []
    ops.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        n0 = ops.launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        losses.append(tr.train_step(batches[i])["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(ops.launch_counts()["flash_attention"] - n0)
    counts = ops.launch_counts()
    routes = ops.flash_route_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  losses {[round(x, 4) for x in losses]}, step s "
        f"{[round(x, 3) for x in step_s]}, flash launches per step "
        f"{per_step} (expected {L} layers x 1 microbatch x 2)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    if per_step != [2 * L] * TRAIN_STEPS:
        raise AssertionError(f"train: flash launches per step {per_step}")
    if routes != {"tensor_cores": counts["flash_attention"],
                  "cuda_cores": 0}:
        raise AssertionError(f"train bf16: flash routes {routes}")
    if any(n for name, n in counts.items() if name != "flash_attention"):
        raise AssertionError(f"train: other kernels launched {counts}")

    profile = _profile_steps(tr, batches[TRAIN_STEPS:TRAIN_STEPS + 2])
    n0 = ops.launch_counts()["flash_attention"]
    accum_step = make_train_step(cfg, dataclasses.replace(tc, accum=2))
    mb = {k: v.reshape(2, B // 2, S) for k, v in batches[-1].items()}
    _, _, st = accum_step(tr.params, tr.opt_state, mb)
    accum_launches = ops.launch_counts()["flash_attention"] - n0
    if not math.isfinite(float(st["loss"])) or accum_launches != 4 * L:
        raise AssertionError(f"train accum=2: loss {float(st['loss'])}, "
                             f"{accum_launches} flash launches")
    log(f"  accum=2 step: loss {float(st['loss']):.4f}, flash launches "
        f"{accum_launches} (= {L} x 2 microbatches x 2)")
    del tr, st, accum_step
    torch.cuda.empty_cache()

    resume = _resume_check(cfg, batches, dev)

    compare = _train_compare(dev, cfg)
    toks = B * S
    step_med = statistics.median(step_s)
    print(json.dumps({"train": {
        "card": card_line(), "arch": TRAIN_ARCH, "dtype": "bfloat16",
        "batch": B, "seq": S, "remat": True, "steps": TRAIN_STEPS,
        "lr": 3e-3, "warmup_steps": 5, "losses": losses, "step_s": step_s,
        "step_ms_median": 1e3 * step_med, "tokens_per_s": toks / step_med,
        "peak_memory_bytes": peak,
        "flash_launches": counts["flash_attention"],
        "flash_launches_by_route": routes,
        "flash_launches_per_step": per_step,
        "accum2_flash_launches": accum_launches,
        "resume": resume, "profiled_steps": profile,
        "fp32_compare": compare}}), flush=True)
    return counts["flash_attention"], profile["flash_ms_in_situ"], routes


def _resume_check(cfg, batches, dev):
    """The checkpoint round trip, at POD_LAYERS layers (at full depth it
    writes and reads 12 GB of parameters and fp32 moments: the disk's
    time, not the step's): 4 steps of ``cfg`` cut to POD_LAYERS, the
    train phase's schedule, a save at step 3; a fresh Trainer (other
    init) restores step 3 on construction and its step 4 on step 4's
    batch reproduces the loss within 1e-3 relative."""
    import shutil
    import tempfile

    import torch
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, Trainer, TrainConfig

    cut = cfg.replace(n_layers=POD_LAYERS)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tc = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5,
                                       total_steps=TRAIN_STEPS),
                         remat=True, tp=16, ckpt_dir=ckdir, ckpt_every=10**9)
        tr = Trainer(cut, tc, init_params(cut, 0, device=dev))
        losses = []
        for b in batches[:4]:
            losses.append(tr.train_step(b)["loss"])
            if tr.step == 3:
                t0 = time.perf_counter()
                tr.save()
                save_s = time.perf_counter() - t0
        del tr
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tr = Trainer(cut, tc, init_params(cut, 1, device=dev))
        restore_s = time.perf_counter() - t0
        if tr.step != 3:
            raise AssertionError(f"restored step {tr.step}, expected 3")
        resumed = tr.train_step(batches[3])["loss"]
        del tr
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    rel = abs(resumed - losses[3]) / abs(losses[3])
    log(f"  resume ({POD_LAYERS} layers) from step 3: step 4 loss "
        f"{resumed:.6f} vs {losses[3]:.6f} (rel {rel:.3g}, tol 1e-3); save "
        f"{save_s:.1f} s, restore {restore_s:.1f} s")
    if not rel <= 1e-3:
        raise AssertionError(f"resumed loss {resumed} != {losses[3]}")
    return {"layers": POD_LAYERS, "ckpt_save_s": save_s,
            "ckpt_restore_s": restore_s, "step4_loss": losses[3],
            "resumed_step4_loss": resumed, "rel_err": rel}


def _train_compare(dev, cfg, B: int = 1, S: int = 1024, tp: int = 16):
    """One fp32 step's loss and gradients (B x S, remat) through the flash
    kernel and through the plain path: 2 flash launches per attention layer
    (forward and recompute; none for xLSTM), loss within 1e-5 relative,
    each gradient leaf within 1e-4 of its largest |g|, the gradient norm
    within 1e-4 relative."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.train import TrainConfig, loss_and_grads
    from repro_torch.train.optimizer import global_norm, leaves

    cfg32 = cfg.replace(dtype="float32")
    params = init_params(cfg32, 2, tp=tp, device=dev)
    batch = _train_batches(cfg32, dev, 1, B, S, seed=1)[0]
    tc = TrainConfig(remat=True, tp=tp)
    n0 = ops.launch_counts()["flash_attention"]
    loss_k, g_k = loss_and_grads(params, cfg32, tc, batch)
    launched = ops.launch_counts()["flash_attention"] - n0
    if launched != 2 * attention_layers(cfg):
        raise AssertionError(f"train fp32 {cfg.name}: {launched} flash "
                             f"launches")
    ops.use_kernels(False)
    try:
        loss_p, g_p = loss_and_grads(params, cfg32, tc, batch)
    finally:
        ops.use_kernels(True)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    leaf_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                    1e-30)
                   for a, b in zip(leaves(g_k), leaves(g_p)) if b.numel())
    nk, np_ = float(global_norm(g_k)), float(global_norm(g_p))
    norm_rel = abs(nk - np_) / np_
    log(f"  fp32 kernel vs plain step: loss rel {loss_rel:.3g} (tol 1e-5), "
        f"worst leaf {leaf_rel:.3g} of its max|g| (tol 1e-4), grad norm rel "
        f"{norm_rel:.3g} (tol 1e-4)")
    if not (loss_rel <= 1e-5 and leaf_rel <= 1e-4 and norm_rel <= 1e-4):
        raise AssertionError(f"train fp32 {cfg.name}: kernel path != plain "
                             f"path")
    del params, g_k, g_p
    torch.cuda.empty_cache()
    return {"batch": B, "seq": S, "flash_launches": launched,
            "loss_kernel": float(loss_k),
            "loss_plain": float(loss_p), "loss_rel_err": loss_rel,
            "worst_leaf_err_of_max": leaf_rel, "grad_norm_kernel": nk,
            "grad_norm_plain": np_, "grad_norm_rel_err": norm_rel}


def _lr_probe(cfg, tc, batch, dev):
    """Batch 0's loss from the seeded weights, and after one step on it at
    the train phase's schedule (lr 3e-3, 5 warm-up steps) and at ``tc``'s:
    how far one of Adam's first steps moves the loss."""
    import dataclasses

    import torch
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    from repro_torch.train import OptConfig, Trainer

    out = {}
    for name, oc in (("train_phase", OptConfig(lr=3e-3, warmup_steps=5,
                                              total_steps=TRAIN_STEPS)),
                     ("family", tc.opt)):
        tr = Trainer(cfg, dataclasses.replace(tc, opt=oc),
                     init_params(cfg, 0, tp=tc.tp, device=dev))
        st = tr.train_step(batch)
        with torch.no_grad():
            after = float(M.train_loss(tr.params, cfg, batch, remat=False,
                                       tp=tc.tp))
        out["before"] = st["loss"]
        out[f"after_{name}_step"] = after
        out[f"{name}_step_lr"] = st["lr"]
        del tr
        torch.cuda.empty_cache()
    log(f"  lr probe: batch 0 loss {out['before']:.4f}; after one step at "
        f"lr {out['train_phase_step_lr']:.3g} "
        f"{out['after_train_phase_step']:.4f}, at lr "
        f"{out['family_step_lr']:.3g} {out['after_family_step']:.4f}")
    return out


def phase_train_family(dev, arch: str):
    """One family of ``TRAIN_FAMILIES`` trained as the train phase trains
    llama: bf16 seeded weights, fp32 AdamW moments, ``TokenStream`` data,
    remat, the training CLI's tp, at the family's constant lr (the lr
    probe first: batch 0's loss after one step at the train phase's
    schedule and at the family's); ``TRAIN_FAMILY_STEPS`` steps with
    finite, falling loss and 2 flash launches per attention layer per step
    (forward and remat recompute; counts reset just before and read just
    after), on the tensor-core route (bf16 at dh 64 and 112), no other
    kernel; one profiled step (busy share); then one fp32 step at B 1
    through the kernels against the plain path. One ``train`` line.
    Returns (flash launches, by route)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, Trainer, TrainConfig
    from repro_torch.train.optimizer import leaves

    layers, B, S, lr, compare_S = TRAIN_FAMILIES[arch]
    cfg = get_arch(arch)
    cut = []
    if layers:
        cut.append(f"n_layers {cfg.n_layers} -> {layers}")
        cfg = cfg.replace(n_layers=layers)
    if S != TRAIN_S:
        cut.append(f"seq {TRAIN_S} -> {S}")
    n_attn, steps = attention_layers(cfg), TRAIN_FAMILY_STEPS
    batches = _train_batches(cfg, dev, steps + 1, B, S)
    tc = TrainConfig(opt=OptConfig(lr=lr, warmup_steps=1,
                                   total_steps=CLI_TOTAL_STEPS),
                     remat=True, tp=CLI_TP)
    probe = _lr_probe(cfg, tc, batches[0], dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, init_params(cfg, 0, tp=tc.tp, device=dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(tr.params))
    losses, step_s, per_step = [], [], []
    ops.reset_launch_counts()
    for b in batches[:steps]:
        n0 = ops.launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        losses.append(tr.train_step(b)["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(ops.launch_counts()["flash_attention"] - n0)
    counts = ops.launch_counts()
    routes = ops.flash_route_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  {arch}: {n_params / 1e9:.3f} B parameters, losses "
        f"{[round(x, 4) for x in losses]}, step s "
        f"{[round(x, 3) for x in step_s]}, flash launches per step "
        f"{per_step} (expected {n_attn} attention layers x 2)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {arch}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train {arch}: loss did not fall: {losses}")
    if per_step != [2 * n_attn] * steps:
        raise AssertionError(f"train {arch}: flash launches per step "
                             f"{per_step}")
    if routes != {fa.TENSOR_CORES: counts["flash_attention"],
                  fa.CUDA_CORES: 0}:
        raise AssertionError(f"train {arch} bf16: flash routes {routes}")
    if any(n for name, n in counts.items() if name != "flash_attention"):
        raise AssertionError(f"train {arch}: other kernels launched {counts}")
    t0 = time.perf_counter()
    profile = _profile_busy(tr, batches[steps:])
    profile_s = time.perf_counter() - t0
    if profile["flash_launches_profiled"] != 2 * n_attn:
        raise AssertionError(f"train {arch}: {profile} in the profiled step")
    del tr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    compare = _train_compare(dev, cfg, B=1, S=compare_S, tp=tc.tp)
    log(f"  {arch}: init {init_s:.1f} s, profiled steps {profile_s:.1f} s, "
        f"fp32 compare {time.perf_counter() - t0:.1f} s")
    step_med = statistics.median(step_s)
    print(json.dumps({"train": {
        "card": card_line(), "arch": arch, "dtype": "bfloat16",
        "layers": cfg.n_layers, "cut": cut or None,
        "attention_layers": n_attn, "head_dim": cfg.hd,
        "parameters": n_params, "batch": B, "seq": S, "remat": True,
        "tp": tc.tp, "steps": steps, "lr": lr, "warmup_steps": 1,
        "lr_probe": probe,
        "init_s": init_s, "losses": losses, "step_s": step_s,
        "step_ms_median": 1e3 * step_med, "tokens_per_s": B * S / step_med,
        "peak_memory_bytes": peak,
        "flash_launches": counts["flash_attention"],
        "flash_launches_by_route": routes,
        "flash_launches_per_step": per_step,
        "profiled_steps": profile, "fp32_compare": compare}}), flush=True)
    return counts["flash_attention"], routes


def _event_ms(fn, n: int = 3) -> float:
    """Median device time of ``fn`` over n calls, each between two CUDA
    events (for calls that allocate or update in place, which ``time_ms``'s
    graphs do not take)."""
    import torch

    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def _place(params, cfg, mesh):
    from repro_torch.distributed import sharding as sh

    return sh.device_put(params, sh.make_shardings(
        sh.param_specs(params, cfg, mesh), mesh))


def _steps(tr, batches):
    """Train steps: (losses, step seconds, flash launches per step)."""
    import torch
    from repro_torch.kernels import ops

    losses, step_s, per_step = [], [], []
    for b in batches:
        n0 = ops.launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        losses.append(tr.train_step(b)["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(ops.launch_counts()["flash_attention"] - n0)
    return losses, step_s, per_step


def _worst_leaf(placed, host):
    """Max |a - b| over the leaves: a sharded tree on the card against full
    tensors on the host (a leaf of no elements, as zamba2's empty tail,
    has none)."""
    from repro_torch.train.optimizer import leaves

    return max(float((p.full().float() - h.to(p.shards[0].device).float())
                     .abs().max()) for p, h in zip(leaves(placed), host)
               if h.numel())


def _bf16_leaf_bound(placed, host, steps, lr):
    """(worst |a - b| / bound over the leaves, its leaf's bound): two bf16
    runs whose gradients differ by rounding part by at most 2 lr a step
    (Adam's normalized step is about lr on each side; twice that as
    margin) plus one bf16 rounding of the leaf's largest value a step,
    2^(floor(log2 max|p|) - 7)."""
    from repro_torch.train.optimizer import leaves

    worst, at = 0.0, None
    for p, h in zip(leaves(placed), host):
        if not h.numel():
            continue
        big = float(h.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(big)) - 7) if big > 0 else 0.0
        bound = steps * (4 * lr + ulp)
        diff = float((p.full().float() - h.to(p.shards[0].device).float())
                     .abs().max())
        if diff / bound >= worst:
            worst, at = diff / bound, bound
    return worst, at


def _sharded_parts(tr, dev):
    """The tensor-parallel step's two exchange and update parts, each timed
    alone at the step's shapes on the card: the gradient reduction
    (``trainer._reduce_tp_grads``: each replicated leaf's copies summed over
    its model group, every slice ring all-reduced over the data indices,
    bf16), and the sharded AdamW (in place: it moves the parameters)."""
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.optimizer import adamw_update, leaves
    from repro_torch.train.trainer import (_differentiated, _reduce_tp_grads,
                                           _unflatten)

    mesh = tr.mesh
    ps = leaves(tr.params)
    dp = len(sh.model_groups(mesh))
    per_d = [{(i, c): torch.full(ps[i].shards[c].shape, 1e-3 * (d + 1),
                                 dtype=ps[i].dtype, device=dev)
              for i, c in _differentiated(ps, mesh, d)} for d in range(dp)]
    reduce_ms = _event_ms(lambda: _reduce_tp_grads(ps, mesh, per_d, dp))
    gtree = _unflatten(tr.params, _reduce_tp_grads(ps, mesh, per_d, dp))
    del per_d
    adamw_ms = _event_ms(lambda: adamw_update(gtree, tr.opt_state, tr.params,
                                              tr.tc.opt), n=2)
    del gtree
    return {"grad_reduce_ms": reduce_ms, "sharded_adamw_ms": adamw_ms}


def _granite_tp(dev):
    """granite-moe-1b-a400m at full width cut to GRANITE_TP_LAYERS layers,
    bf16, B 4 x S 2048, remat, lr 1e-5 (the train_families phase's): two
    single-device steps, then two expert-parallel steps on a (1, 4) mesh
    of the card (32 experts, 8 a shard; the router, the dispatch, the
    capacity and the aux on every shard) from the same weights and
    batches: losses within 2e-2 relative, the worst leaf within its bf16
    bound, tp x layers x 2 flash launches a step on the tensor cores, step
    ms (the second, warm); then two steps with the shard-local dispatch
    (``TrainConfig.ep_local``) from the same weights and batches: losses
    within 1e-5 relative of the expert-parallel steps', as many flash
    launches, step ms."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.moe import expert_parallel
    from repro_torch.train import OptConfig, Trainer, TrainConfig
    from repro_torch.train.optimizer import leaves

    cfg = get_arch(GRANITE_TP).replace(n_layers=GRANITE_TP_LAYERS)
    lr = TRAIN_FAMILIES[GRANITE_TP][3]
    tc = TrainConfig(opt=OptConfig(lr=lr, warmup_steps=1,
                                   total_steps=CLI_TOTAL_STEPS),
                     remat=True, tp=CLI_TP)
    mesh = make_mesh(*GRANITE_TP_MESH)
    n = mesh.shape["model"]
    batches = _train_batches(cfg, dev, 2, TRAIN_B, TRAIN_S, seed=2)
    tr = Trainer(cfg, tc, init_params(cfg, 0, tp=tc.tp, device=dev))
    single, single_s, _ = _steps(tr, batches)
    host = [p.detach().cpu() for p in leaves(tr.params)]
    del tr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, _place(init_params(cfg, 0, tp=tc.tp, device=dev),
                                 cfg, mesh), mesh)
    ops.reset_launch_counts()
    losses, step_s, per_step = _steps(tr, batches)
    routes = ops.flash_route_counts()
    peak = torch.cuda.max_memory_allocated()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, single)]
    worst, bound = _bf16_leaf_bound(tr.params, host, len(batches), lr)
    del tr, host
    torch.cuda.empty_cache()
    # the shard-local dispatch (``TrainConfig.ep_local``) from the same
    # weights and batch
    tr = Trainer(cfg, dataclasses.replace(tc, ep_local=True),
                 _place(init_params(cfg, 0, tp=tc.tp, device=dev), cfg,
                        mesh), mesh)
    ops.reset_launch_counts()
    local, local_s, local_per_step = _steps(tr, batches)
    local_routes = ops.flash_route_counts()
    local_rel = [abs(a - b) / abs(b) for a, b in zip(local, losses)]
    del tr
    torch.cuda.empty_cache()
    log(f"  granite local dispatch: losses {local} against the current "
        f"dispatch's {losses} (rel {max(local_rel):.3g}, tol 1e-5); step ms "
        f"{1e3 * local_s[-1]:.1f} vs {1e3 * step_s[-1]:.1f}; flash launches "
        f"a step {local_per_step}")
    if max(local_rel) > 1e-5 or local_per_step != per_step or \
            local_routes[fa.CUDA_CORES]:
        raise AssertionError(f"granite local dispatch: {local} vs {losses},"
                             f" flash {local_per_step}, {local_routes}")
    log(f"  granite expert-parallel ({GRANITE_TP_LAYERS} layers, "
        f"{dict(mesh.shape)}, {cfg.n_experts // n} experts a shard): losses "
        f"{[round(x, 5) for x in losses]} vs one device "
        f"{[round(x, 5) for x in single]} (rel {max(rel):.3g}, tol 2e-2); "
        f"worst leaf {worst:.3g} of its bf16 bound; step ms "
        f"{1e3 * single_s[-1]:.1f} vs {1e3 * step_s[-1]:.1f}; flash "
        f"launches a step {per_step}")
    if not (expert_parallel(cfg, n) and all(map(math.isfinite, losses))
            and max(rel) <= 2e-2 and worst <= 1.0):
        raise AssertionError(f"granite expert-parallel: {losses} vs {single}"
                             f", worst leaf {worst} of its bound")
    if per_step != [n * GRANITE_TP_LAYERS * 2] * len(batches) or \
            routes[fa.CUDA_CORES]:
        raise AssertionError(f"granite expert-parallel: flash {per_step}, "
                             f"{routes}")
    return {"arch": GRANITE_TP, "layers": GRANITE_TP_LAYERS,
            "mesh": dict(mesh.shape), "experts_per_shard": cfg.n_experts // n,
            "batch": TRAIN_B, "seq": TRAIN_S, "lr": lr,
            "single_losses": single, "tp_losses": losses,
            "loss_rel_err": rel, "loss_tol": 2e-2,
            "worst_leaf_of_bf16_bound": worst, "leaf_bound": bound,
            "single_step_s": single_s, "tp_step_s": step_s,
            "tp_peak_memory_bytes": peak, "flash_launches_per_step": per_step,
            "flash_launches_by_route": routes,
            "local_dispatch": {"losses": local, "loss_rel_err": local_rel,
                               "loss_tol": 1e-5, "step_s": local_s,
                               "flash_launches_per_step": local_per_step},
            "local_launches": (sum(local_per_step), local_routes)}, \
        sum(per_step), routes


def _gathered_step(cfg, tc, batches, single, host, dev):
    """The gathered sharded step on a GATHERED_MESH of the card (a model
    axis of 1: each data index gathers the parameters onto its device and
    runs its B / 2 rows, the gradients averaged onto the first) from the
    same weights and batches as the single-device steps (``single``: their
    losses; ``host``: their final parameters): losses within 2e-2
    relative, the worst leaf within its bf16 bound, data indices x layers
    x 2 flash launches a step on the tensor cores, step ms, peak memory."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.train import Trainer
    from repro_torch.train.trainer import splits_model

    mesh = make_mesh(*GATHERED_MESH)
    dp, L = mesh.shape["data"], cfg.n_layers
    if splits_model(cfg, mesh):
        raise AssertionError("gathered: the mesh splits the model axis")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, _place(init_params(cfg, 0, tp=tc.tp, device=dev),
                                 cfg, mesh), mesh)
    ops.reset_launch_counts()
    losses, step_s, per_step = _steps(tr, batches)
    counts = ops.launch_counts()
    routes = ops.flash_route_counts()
    peak = torch.cuda.max_memory_allocated()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, single)]
    worst, bound = _bf16_leaf_bound(tr.params, host, len(batches),
                                    tc.opt.lr)
    del tr
    torch.cuda.empty_cache()
    log(f"  gathered step on {dict(mesh.shape)}: losses "
        f"{[round(x, 5) for x in losses]} (rel {max(rel):.3g}, tol 2e-2); "
        f"worst leaf {worst:.3g} of its bf16 bound; step ms "
        f"{1e3 * statistics.median(step_s):.1f}; peak {peak / 1e9:.2f} GB; "
        f"flash launches a step {per_step} (expected {dp} x {L} x 2)")
    if not (all(map(math.isfinite, losses)) and max(rel) <= 2e-2
            and worst <= 1.0):
        raise AssertionError(f"gathered: {losses} vs {single}, worst leaf "
                             f"{worst} of its bound")
    if per_step != [dp * L * 2] * len(batches) or routes[fa.CUDA_CORES] or \
            any(c for name, c in counts.items() if name != "flash_attention"):
        raise AssertionError(f"gathered: flash {per_step}, {routes}, "
                             f"{counts}")
    return {"mesh": dict(mesh.shape), "losses": losses, "loss_rel_err": rel,
            "loss_tol": 2e-2, "worst_leaf_of_bf16_bound": worst,
            "leaf_bound": bound, "step_s": step_s,
            "step_ms_median": 1e3 * statistics.median(step_s),
            "peak_memory_bytes": peak, "flash_launches_per_step": per_step,
            "flash_launches_by_route": routes}, sum(per_step), routes


def _reshard(params, cfg, dev):
    """The params tree saved from its mesh, restored onto a (4,) model mesh
    and onto one device: bit-equal leaves (the train_sharded phase's at
    POD_LAYERS layers: at full depth the round trips are the disk's time,
    not the step's)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.distributed import checkpoint as ckpt, sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import leaves

    d = tempfile.mkdtemp(prefix="chip_smoke_reshard_")
    try:
        like = {"params": params}
        t0 = time.perf_counter()
        ckpt.save(d, 1, like)
        save_s = time.perf_counter() - t0
        nbytes = ckpt.read_manifest(d, 1)["bytes"]
        mesh4 = make_mesh((4,), ("model",))
        one = make_mesh((1,), ("model",))
        out = {"checkpoint_bytes": nbytes, "save_s": save_s}
        for name, shardings in (
                ("model4", {"params": sh.make_shardings(
                    sh.param_specs(params, cfg, mesh4), mesh4)}),
                ("one_device", sh.NamedSharding(one, sh.P()))):
            t0 = time.perf_counter()
            back = ckpt.restore(d, 1, like, shardings=shardings)
            torch.cuda.synchronize()
            out[f"restore_{name}_s"] = time.perf_counter() - t0
            equal = all(torch.equal(a.full(), b.full()) for a, b in
                        zip(leaves(back["params"]), leaves(params)))
            if not equal:
                raise AssertionError(f"reshard onto {name}: leaves differ")
            out[f"{name}_bit_equal"] = equal
            del back
        log(f"  reshard: {nbytes / 1e9:.2f} GB saved from "
            f"{dict(next(iter(leaves(params))).sharding.mesh.shape)} in "
            f"{save_s:.1f} s, restored onto (4,) model in "
            f"{out['restore_model4_s']:.1f} s and onto one device in "
            f"{out['restore_one_device_s']:.1f} s, bit-equal")
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _gpipe(cfg, tc, dev):
    """llama's 16 layers as GPIPE_STAGES stages of 4 over a (4,) pod mesh of
    the card, the model's own layer loop (``run_layers``) as the stage
    function, GPIPE_MICRO microbatches of [1, S]: the pipelined hidden
    states against the unpipelined forward of each microbatch (the same
    GEMM shapes), flash launches = ticks x layers."""
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.pipeline_parallel import (bubble_fraction,
                                                           gpipe_forward)
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    n, m, L_ = GPIPE_STAGES, GPIPE_MICRO, cfg.n_layers
    params = init_params(cfg, 0, tp=tc.tp, device=dev)
    stages = sh.tree_map(lambda a: a.reshape((n, L_ // n) + a.shape[1:]),
                         params["layers"])
    tokens = torch.cat([b["tokens"] for b in _train_batches(
        cfg, dev, -(-m // TRAIN_B), TRAIN_B, TRAIN_S, seed=3)])[:m]
    fn = gpipe_forward(lambda sp, x: M.run_layers(sp, cfg, x, tp=tc.tp),
                       make_mesh((n,), ("pod",)))

    def piped():
        xs = L.embed(params["embed"], tokens)[:, None]
        return L.rms_norm(params["final_norm"], fn(stages, xs)[:, 0],
                          cfg.norm_eps)

    def unpiped():
        return torch.cat([M.forward(params, cfg, tokens[i:i + 1],
                                    tp=tc.tp)[0] for i in range(m)])

    with torch.no_grad():
        ops.reset_launch_counts()
        got = piped()
        torch.cuda.synchronize()
        launches = ops.launch_counts()["flash_attention"]
        routes = ops.flash_route_counts()
        want = unpiped()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        # in turns (piped, unpiped, unpiped, piped, ...): the two share the
        # card's state and the host's load
        times = {piped: [], unpiped: []}
        for i in range(GPIPE_PAIRS):
            for run in ((piped, unpiped) if i % 2 == 0 else
                        (unpiped, piped)):
                times[run].append(_event_ms(run, n=1))
        piped_ms = statistics.median(times[piped])
        unpiped_ms = statistics.median(times[unpiped])
    ticks = m + n - 1
    log(f"  gpipe: {n} stages x {L_ // n} layers, {m} microbatches of [1, "
        f"{TRAIN_S}]: {launches} flash launches (expected {ticks} ticks x "
        f"{L_}), max abs err {err:.3g} vs the unpipelined forward (max |h| "
        f"{scale:.3g}); median of {GPIPE_PAIRS} in turns {piped_ms:.1f} ms "
        f"(range {min(times[piped]):.1f}-{max(times[piped]):.1f}) vs "
        f"{unpiped_ms:.1f} ms ({min(times[unpiped]):.1f}-"
        f"{max(times[unpiped]):.1f}): {piped_ms / unpiped_ms:.3f}x; "
        f"{ticks}/{m} = {ticks / m:.3f}")
    if launches != ticks * L_ or routes[fa.CUDA_CORES]:
        raise AssertionError(f"gpipe: {launches} flash launches, {routes}")
    if not (math.isfinite(err) and err <= BF16_ULP[0] * max(1.0, scale)):
        raise AssertionError(f"gpipe: pipelined != unpipelined ({err})")
    del params, stages, got, want
    torch.cuda.empty_cache()
    return {"stages": n, "layers_per_stage": L_ // n, "microbatches": m,
            "microbatch_shape": [1, TRAIN_S], "ticks": ticks,
            "bubble_fraction": bubble_fraction(n, m),
            "flash_launches": launches, "flash_launches_by_route": routes,
            "max_abs_err": err, "max_abs_hidden": scale,
            "tolerance": f"abs {BF16_ULP[0]} x max(1, max|h|)",
            "bit_equal": err == 0.0, "pipelined_ms": piped_ms,
            "unpipelined_ms": unpiped_ms, "pipelined_ms_runs": times[piped],
            "unpipelined_ms_runs": times[unpiped],
            "ratio": piped_ms / unpiped_ms}, launches, routes


def phase_train_sharded(dev):
    """Multi-device training on the one card, one process over meshes whose
    entries are all ``cuda:0``: llama3.2-1b at full width, bf16, seeded
    weights, ``TokenStream`` batches, B 4 x S 2048, remat, tp 4, lr 1e-5.
    SHARDED_STEPS single-device steps first (the final parameters kept on
    the host, then freed; one more step profiled), then as many of the
    gathered step on a (2, 1) mesh (``_gathered_step``), then of the
    tensor-parallel step on a (2, 4) ("data", "model") mesh, all from the
    same weights and batches: losses within 2e-2 relative, all finite, the
    worst leaf within its bf16 bound (``_bf16_leaf_bound``), 2 data indices
    x 4 model shards x 16 layers x 2 flash launches a step on the tensor
    cores; step ms and peak memory beside the gathered step's earlier
    figures on (2, 4)
    (GATHERED_*), one profiled step's busy share and device ops against one
    device's, the gradient reduction's and the sharded AdamW's ms; the
    params saved from the mesh and restored onto a (4,) model mesh and onto
    one device bit-equal (at POD_LAYERS layers); the same step with the
    Megatron-SP residual
    (``_sp_step``); one fp32 step without and with SP
    (``_sharded_fp32``); granite's expert-parallel step, and with the
    shard-local dispatch (``_granite_tp``); the compressed pod sync
    (``_pod_sync``); GPipe (``_gpipe``). The seconds each part took. One
    ``train_sharded`` line. Returns {path: (flash launches, routes)} of the
    gathered and the tensor-parallel steps, the SP step, granite's steps
    and the pipelined forward."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, Trainer, TrainConfig
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.trainer import splits_model

    split_s, t_part = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        split_s[name] = now - t_part[0]
        t_part[0] = now

    cfg = get_arch(TRAIN_ARCH)
    B, S, L, n = TRAIN_B, TRAIN_S, cfg.n_layers, SHARDED_STEPS
    tc = TrainConfig(opt=OptConfig(lr=SHARDED_LR, warmup_steps=1,
                                   total_steps=CLI_TOTAL_STEPS),
                     remat=True, tp=CLI_TP)
    batches = _train_batches(cfg, dev, n + 1, B, S)
    mesh = make_mesh(*SHARDED_MESH)
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    if not (splits_model(cfg, mesh) and cfg.kv_shardable(tp)):
        raise AssertionError("train_sharded: the mesh does not split llama "
                             "over the model axis with its kv heads")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, init_params(cfg, 0, tp=tc.tp, device=dev))
    single_losses, single_s, _ = _steps(tr, batches[:n])
    single_peak = torch.cuda.max_memory_allocated()
    host = [p.detach().cpu() for p in leaves(tr.params)]
    single_profile = _profile_busy(tr, batches[n:])
    del tr
    torch.cuda.empty_cache()
    lap("single_device")

    gathered, ga_launches, ga_routes = _gathered_step(
        cfg, tc, batches[:n], single_losses, host, dev)
    lap("gathered")

    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, _place(init_params(cfg, 0, tp=tc.tp, device=dev),
                                 cfg, mesh), mesh)
    ops.reset_launch_counts()
    losses, step_s, per_step = _steps(tr, batches[:n])
    counts = ops.launch_counts()
    routes = ops.flash_route_counts()
    peak = torch.cuda.max_memory_allocated()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, single_losses)]
    worst = _worst_leaf(tr.params, host)
    worst_of_bound, bound = _bf16_leaf_bound(tr.params, host, n, SHARDED_LR)
    del host
    want = dp * tp * L * 2
    log(f"  single-device losses {[round(x, 5) for x in single_losses]}, "
        f"tensor-parallel {[round(x, 5) for x in losses]} (rel "
        f"{max(rel):.3g}, tol 2e-2); worst leaf |diff| after step {n} "
        f"{worst:.3g}, at most {worst_of_bound:.3g} of its leaf's bf16 bound "
        f"(that leaf's {bound:.3g}); step ms "
        f"{1e3 * statistics.median(single_s):.1f} vs "
        f"{1e3 * statistics.median(step_s):.1f} (the gathered step: on "
        f"(2, 1) {gathered['step_ms_median']:.1f}, earlier on (2, 4) "
        f"{GATHERED_STEP_MS}); peak {single_peak / 1e9:.2f} vs "
        f"{peak / 1e9:.2f} GB (gathered: on (2, 1) "
        f"{gathered['peak_memory_bytes'] / 1e9:.2f}, earlier on (2, 4) "
        f"{GATHERED_PEAK_GB}); flash launches per step {per_step} (expected "
        f"{dp} x {tp} x {L} x 2)")
    if not all(math.isfinite(x) for x in losses + single_losses):
        raise AssertionError(f"train_sharded: non-finite loss {losses}")
    if max(rel) > 2e-2:
        raise AssertionError(f"train_sharded: sharded {losses} vs single "
                             f"{single_losses}")
    if per_step != [want] * n:
        raise AssertionError(f"train_sharded: flash launches {per_step}")
    if not worst_of_bound <= 1.0:
        raise AssertionError(f"train_sharded: a leaf {worst_of_bound} of its "
                             f"bf16 bound apart")
    if routes != {fa.TENSOR_CORES: counts["flash_attention"],
                  fa.CUDA_CORES: 0}:
        raise AssertionError(f"train_sharded bf16: flash routes {routes}")
    if any(c for name, c in counts.items() if name != "flash_attention"):
        raise AssertionError(f"train_sharded: other kernels {counts}")
    lap("tensor_parallel_steps")
    profile = _profile_busy(tr, batches[n:])
    if profile["flash_launches_profiled"] != want:
        raise AssertionError(f"train_sharded: {profile} in the profiled step")
    lap("tensor_parallel_profiled_step")
    cut = cfg.replace(n_layers=POD_LAYERS)
    reshard = _reshard(_place(init_params(cut, 0, tp=tc.tp, device=dev), cut,
                              mesh), cut, dev)
    lap("reshard")
    parts = _sharded_parts(tr, dev)
    log(f"  one profiled tensor-parallel step: busy "
        f"{100 * profile['device_busy_share']:.1f} % (one device's "
        f"{100 * single_profile['device_busy_share']:.1f} %); gradient "
        f"reduction {parts['grad_reduce_ms']:.2f} ms, sharded AdamW "
        f"{parts['sharded_adamw_ms']:.2f} ms; device ops a step (profiler) "
        f"{profile['device_ops_per_step']:.0f} against one device's "
        f"{single_profile['device_ops_per_step']:.0f}")
    tp_host = [p.full().cpu() for p in leaves(tr.params)]
    del tr
    torch.cuda.empty_cache()
    lap("exchange_parts")

    sp, sp_launches, sp_routes = _sp_step(cfg, tc, mesh, batches, losses,
                                          step_s, peak, profile, tp_host,
                                          dev)
    del tp_host
    lap("sp_steps")
    fp32 = _sharded_fp32(cfg, mesh, dev, variants={"sp": {"sp": True}})
    lap("fp32")
    granite, gr_launches, gr_routes = _granite_tp(dev)
    gl_launches = granite.pop("local_launches")
    lap("granite_expert_parallel")
    pod = _pod_sync(cfg, tc, batches[0], dev)
    lap("pod_sync")
    gpipe, gp_launches, gp_routes = _gpipe(cfg, tc, dev)
    lap("gpipe")
    log(f"  seconds by part: "
        f"{ {k: round(v, 1) for k, v in split_s.items()} }")
    print(json.dumps({"train_sharded": {
        "card": card_line(), "arch": TRAIN_ARCH, "dtype": "bfloat16",
        "batch": B, "seq": S, "remat": True, "tp": tc.tp, "lr": SHARDED_LR,
        "step": "tensor-parallel: each (data, model) coordinate computes its "
                "slice",
        "mesh": dict(mesh.shape), "mesh_devices": sorted(
            set(map(str, mesh.devices.flat))), "steps": n,
        "single_losses": single_losses, "sharded_losses": losses,
        "loss_rel_err": rel, "loss_tol": 2e-2,
        "worst_leaf_abs_diff": worst,
        "worst_leaf_of_bf16_bound": worst_of_bound,
        "leaf_bound": f"{n} steps x (4 lr + one bf16 ulp of the leaf's "
                      f"max |p|)",
        "single_step_s": single_s, "sharded_step_s": step_s,
        "single_step_ms_median": 1e3 * statistics.median(single_s),
        "sharded_step_ms_median": 1e3 * statistics.median(step_s),
        "gathered_step_ms_pr22": GATHERED_STEP_MS,
        "single_tokens_per_s": B * S / statistics.median(single_s),
        "sharded_tokens_per_s": B * S / statistics.median(step_s),
        "single_peak_memory_bytes": single_peak,
        "sharded_peak_memory_bytes": peak,
        "gathered_peak_gb_pr22": GATHERED_PEAK_GB,
        "flash_launches": counts["flash_attention"],
        "flash_launches_by_route": routes,
        "flash_launches_per_step": per_step,
        "profiled_step": profile, "single_profiled_step": single_profile,
        **parts,
        "collectives_note": "one card: every mesh entry is cuda:0, so the "
                            "all-reduces and gathers are device-local "
                            "copies and adds, not interconnect transfers",
        "gathered": gathered, "reshard": reshard, "sp": sp, "fp32": fp32,
        "granite_expert_parallel": granite, "pod_sync": pod, "gpipe": gpipe,
        "seconds_by_part": split_s}}), flush=True)
    return {"gathered": (ga_launches, ga_routes),
            "train_sharded": (counts["flash_attention"], routes),
            "train_sharded_sp": (sp_launches, sp_routes),
            "granite_tp": (gr_launches, gr_routes),
            "granite_tp_local": gl_launches,
            "gpipe": (gp_launches, gp_routes)}


def _sp_step(cfg, tc, mesh, batches, tp_losses, tp_s, tp_peak, tp_profile,
             tp_host, dev):
    """The tensor-parallel step with the Megatron-SP residual
    (``TrainConfig.sp``) on ``mesh`` from the same weights and batches as
    the TP step's (its losses, step seconds, peak, profiled step and final
    parameters on the host: ``tp_*``): losses against the TP step's
    (bit-equal where the card's norms and sums run in the same order;
    within 2e-2 relative in any case), the worst leaf within its bf16
    bound of the TP step's, 256 flash launches a step on the tensor cores,
    step ms, peak memory, one profiled step's busy share and device ops.
    -> (the line's dict, flash launches, by route)."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.models import init_params
    from repro_torch.train import Trainer

    n = SHARDED_STEPS
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    want = dp * tp * cfg.n_layers * 2
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, dataclasses.replace(tc, sp=True),
                 _place(init_params(cfg, 0, tp=tc.tp, device=dev), cfg,
                        mesh), mesh)
    ops.reset_launch_counts()
    losses, step_s, per_step = _steps(tr, batches[:n])
    counts = ops.launch_counts()
    routes = ops.flash_route_counts()
    peak = torch.cuda.max_memory_allocated()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, tp_losses)]
    worst, bound = _bf16_leaf_bound(tr.params, tp_host, n, SHARDED_LR)
    profile = _profile_busy(tr, batches[n:])
    del tr
    torch.cuda.empty_cache()
    equal = losses == list(tp_losses)
    log(f"  SP: losses {[round(x, 5) for x in losses]} against the TP "
        f"step's {[round(x, 5) for x in tp_losses]} (bit-equal: {equal}; "
        f"rel {max(rel):.3g}, tol 2e-2); worst leaf {worst:.3g} of its bf16 "
        f"bound; step ms {1e3 * statistics.median(step_s):.1f} vs the TP "
        f"step's {1e3 * statistics.median(tp_s):.1f}; peak "
        f"{peak / 1e9:.2f} vs {tp_peak / 1e9:.2f} GB; busy "
        f"{100 * profile['device_busy_share']:.1f} vs "
        f"{100 * tp_profile['device_busy_share']:.1f} %; device ops a step "
        f"{profile['device_ops_per_step']:.0f} vs "
        f"{tp_profile['device_ops_per_step']:.0f}; flash launches per step "
        f"{per_step} (expected {want})")
    if not all(math.isfinite(x) for x in losses) or max(rel) > 2e-2:
        raise AssertionError(f"train_sharded SP: {losses} vs {tp_losses}")
    if not worst <= 1.0:
        raise AssertionError(f"train_sharded SP: a leaf {worst} of its bf16 "
                             f"bound apart")
    if per_step != [want] * n or profile["flash_launches_profiled"] != want:
        raise AssertionError(f"train_sharded SP: flash launches {per_step}, "
                             f"profiled {profile['flash_launches_profiled']}")
    if routes != {fa.TENSOR_CORES: counts["flash_attention"],
                  fa.CUDA_CORES: 0} or any(
            c for name, c in counts.items() if name != "flash_attention"):
        raise AssertionError(f"train_sharded SP: launches {counts}, flash "
                             f"routes {routes}")
    return {"steps": n, "losses": losses, "tp_losses": list(tp_losses),
            "losses_bit_equal": equal, "loss_rel_err": rel,
            "loss_tol": 2e-2, "worst_leaf_of_bf16_bound": worst,
            "leaf_bound": bound, "step_s": step_s,
            "step_ms_median": 1e3 * statistics.median(step_s),
            "tp_step_ms_median": 1e3 * statistics.median(tp_s),
            "peak_memory_bytes": peak, "tp_peak_memory_bytes": tp_peak,
            "flash_launches_per_step": per_step,
            "flash_launches_by_route": routes, "profiled_step": profile}, \
        counts["flash_attention"], routes


def _sharded_fp32(cfg, mesh, dev, label="train_sharded fp32",
                  variants=None):
    """One fp32 step (B 4 x S SHARDED_FP32_S, lr SHARDED_FP32_LR from step
    1, so that an update is 100 x the tolerance) on one device and on
    ``mesh``: loss within 1e-5 relative, every shard equal to its slice of
    the gathered leaf, every leaf moved by at least lr / 2, and every
    parameter and first moment within 1e-5 abs, except the parameters
    where the clipped gradient is below 100 eps = 1e-6: there Adam's first
    step, lr g / (|g| + eps), turns fp32 rounding in g into up to 2 lr
    (the CPU tests' rule; at most 0.1 % of the elements). ``variants``
    ({name: TrainConfig changes}): one more step on ``mesh`` each, from
    the same weights, held to the same rules against the same one-device
    step (its dict under its name)."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.train import OptConfig, Trainer, TrainConfig
    from repro_torch.train.optimizer import leaves

    cfg32 = cfg.replace(dtype="float32")
    lr = SHARDED_FP32_LR
    tc32 = TrainConfig(opt=OptConfig(lr=lr, warmup_steps=1), remat=True,
                       tp=CLI_TP)
    batch = _train_batches(cfg32, dev, 1, TRAIN_B, SHARDED_FP32_S, seed=1)[0]
    tr = Trainer(cfg32, tc32, init_params(cfg32, 2, tp=tc32.tp, device=dev))
    # the single-device results stay on the card (15 GB beside the mesh's
    # 40): copies through the host cost seconds
    p0 = [p.detach().clone() for p in leaves(tr.params)]
    single = tr.train_step(batch)["loss"]
    host = [p.detach() for p in leaves(tr.params)]
    host_m = list(leaves(tr.opt_state.m))
    del tr
    torch.cuda.empty_cache()
    out = _fp32_split(cfg32, tc32, mesh, dev, label, batch, single, host,
                      host_m, p0)
    for name, kw in (variants or {}).items():
        out[name] = _fp32_split(cfg32, dataclasses.replace(tc32, **kw), mesh,
                                dev, f"{label} {name}", batch, single, host,
                                host_m, p0)
    del host, host_m, p0
    torch.cuda.empty_cache()
    return out


def _fp32_split(cfg32, tc32, mesh, dev, label, batch, single, host, host_m,
                p0):
    """``_sharded_fp32``'s step on ``mesh`` under ``tc32``, against the
    one-device step's loss ``single``, parameters ``host``, first moments
    ``host_m`` and starting parameters ``p0``."""
    import torch
    from repro_torch.models import init_params
    from repro_torch.train import Trainer
    from repro_torch.train.optimizer import leaves

    lr, oc = tc32.opt.lr, tc32.opt
    tr = Trainer(cfg32, tc32, _place(init_params(cfg32, 2, tp=tc32.tp,
                                                 device=dev), cfg32, mesh),
                 mesh)
    sharded = tr.train_step(batch)["loss"]
    rel = abs(sharded - single) / abs(single)
    worst = worst_m = worst_loose = 0.0
    loose = total = 0
    moved = math.inf
    replicas = True
    for p, m, h, hm, h0 in zip(leaves(tr.params), leaves(tr.opt_state.m),
                               host, host_m, p0):
        if not h.numel():           # zamba2's empty tail
            continue
        for t in (p, m):
            full = t.full()
            replicas &= all(torch.equal(sd, full[sl])
                            for sd, sl in zip(t.shards, t.slices))
        full = p.full()
        d = (full - h).abs()
        moved = min(moved, float((full - h0).abs().max()))
        worst = max(worst, float(d.max()))
        worst_m = max(worst_m, float((m.full() - hm).abs().max()))
        off = d > 1e-5
        if bool((off & (hm.abs() / (1 - oc.b1) >= 100 * oc.eps)).any()):
            raise AssertionError(f"{label}: a parameter whose gradient is "
                                 f"above 100 eps is 1e-5 apart")
        if off.any():
            worst_loose = max(worst_loose, float(d[off].max()))
        loose += int(off.sum())
        total += d.numel()
        del full, hm, d, off
    del tr
    torch.cuda.empty_cache()
    log(f"  {label} (B {TRAIN_B} x S {SHARDED_FP32_S}, lr {lr}): loss "
        f"{sharded:.6f} vs {single:.6f} (rel {rel:.3g}, tol 1e-5), worst "
        f"leaf {worst:.3g}: {loose} of {total} parameters beyond 1e-5, all "
        f"with clipped |g| < 100 eps (worst {worst_loose:.3g}, tol 2 lr); "
        f"worst first moment {worst_m:.3g} (tol 1e-5); least leaf move "
        f"{moved:.3g}; replicas agree: {replicas}")
    if not (rel <= 1e-5 and worst_m <= 1e-5 and worst_loose <= 2 * lr
            and loose <= 1e-3 * total and moved >= lr / 2 and replicas):
        raise AssertionError(f"{label}: sharded != single")
    return {"batch": TRAIN_B, "seq": SHARDED_FP32_S, "lr": lr,
            "single_loss": single, "sharded_loss": sharded,
            "loss_rel_err": rel, "worst_leaf_abs_diff": worst,
            "params_beyond_1e-5": loose, "params": total,
            "worst_beyond_1e-5": worst_loose,
            "worst_first_moment_abs_diff": worst_m,
            "least_leaf_move": moved, "replicas_agree": replicas,
            "tolerance": "loss rel 1e-5; parameters and first moments abs "
                         "1e-5, parameters whose clipped |g| < 100 eps "
                         "within 2 lr (at most 0.1 %); every leaf moved by "
                         "lr / 2; every shard equal to its slice"}


def _expected_residual(g, mode):
    """The pod sync's residual after its first step, recomputed here from
    the reduced gradient ``g``: g - decompress(compress(g)) in fp32, int8
    per tensor at scale max|g| / 127 + 1e-12 with half-to-even rounding,
    or the bf16 round trip."""
    import torch

    gf = g.float()
    if mode == "bf16":
        return gf - gf.to(torch.bfloat16).float()
    scale = gf.abs().max() / 127.0 + 1e-12
    return gf - torch.clamp(torch.round(gf / scale), -127, 127) * scale


def _pod_sync(cfg, tc, batch, dev):
    """One step on a (2, 2, 2) ("pod", "data", "model") mesh of the card
    from the same weights with compress none, int8 and bf16, at POD_LAYERS
    layers: step 1's loss bit-equal across the three (the forward is the
    same, so this shows only that the path runs); each mode's residual held
    against ``_expected_residual`` of the reduced gradients, taken from the
    same placed weights before the uncompressed step: within 1e-6 abs, or
    one quantum (int8: the leaf's scale; bf16: one bf16 ulp of |g|) at
    elements where rounding puts g on the other side of a boundary, at most
    0.1 % of them (the CPU tests' rule). The int8 residual is non-zero;
    bf16 gradients pass the bf16 wire exactly, so for bf16 only the fp32
    leaves, the norms, leave one."""
    import dataclasses

    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.train import Trainer
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.trainer import sharded_loss_and_grads

    cut = cfg.replace(n_layers=POD_LAYERS)
    mesh = make_mesh(*POD_MESH)
    out = {"layers": POD_LAYERS, "mesh": dict(mesh.shape)}
    grads = None
    for mode in ("none", "int8", "bf16"):
        tcm = dataclasses.replace(tc, compress=mode)
        tr = Trainer(cut, tcm, _place(init_params(cut, 0, tp=tc.tp,
                                                  device=dev), cut, mesh),
                     mesh)
        if grads is None:
            grads = [g.detach() for g in leaves(sh.gather(
                sharded_loss_and_grads(tr.params, cut, tcm, batch, mesh)[1]))]
        t0 = time.perf_counter()
        loss = tr.train_step(batch)["loss"]
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        out[mode] = {"loss": loss, "step_ms": step_ms}
        if mode != "none":
            res = leaves(tr.opt_state.residual)
            flips = total = 0
            worst = 0.0
            for r, g in zip(res, grads):
                want = _expected_residual(g, mode)
                diff = (r.to(want.device) - want).abs()
                gf = g.float().abs()
                quantum = ((gf.max() / 127).expand_as(gf) if mode == "int8"
                           else 2.0 ** -7 * gf)
                off = diff > 1e-6
                if not bool((diff[off] <= 1.01 * quantum[off] + 1e-6).all()):
                    raise AssertionError(f"pod sync {mode}: residual off by "
                                         f"more than a quantum")
                flips += int(off.sum())
                total += diff.numel()
                worst = max(worst, float(diff.max()))
            out[mode].update(
                residual_finite=all(bool(torch.isfinite(r).all())
                                    for r in res),
                residual_max_abs=max(float(r.abs().max()) for r in res),
                residual_vs_recomputed_max_abs=worst,
                residual_elements_a_quantum_off=flips,
                residual_elements=total)
            if flips > 1e-3 * total:
                raise AssertionError(f"pod sync {mode}: {flips} of {total} "
                                     f"residual elements a quantum off")
            del res
        del tr
        torch.cuda.empty_cache()
    del grads
    base = out["none"]["loss"]
    log(f"  pod sync ({POD_LAYERS} layers, {out['mesh']}): loss none "
        f"{base!r}, int8 {out['int8']['loss']!r}, bf16 "
        f"{out['bf16']['loss']!r}; residual max |r| int8 "
        f"{out['int8']['residual_max_abs']:.3g}, bf16 "
        f"{out['bf16']['residual_max_abs']:.3g}; against the residual "
        f"recomputed from the reduced gradients: int8 max |diff| "
        f"{out['int8']['residual_vs_recomputed_max_abs']:.3g} "
        f"({out['int8']['residual_elements_a_quantum_off']} of "
        f"{out['int8']['residual_elements']} a quantum off), bf16 "
        f"{out['bf16']['residual_vs_recomputed_max_abs']:.3g} "
        f"({out['bf16']['residual_elements_a_quantum_off']} a quantum off)")
    for mode in ("int8", "bf16"):
        if out[mode]["loss"] != base or not out[mode]["residual_finite"]:
            raise AssertionError(f"pod sync {mode}: {out[mode]} vs {base}")
    if not out["int8"]["residual_max_abs"] > 0:
        raise AssertionError("pod sync int8: zero residual")
    return out


# ---------------------------------------------------------------------------
# phase 3d: the roofline tools on the card
# ---------------------------------------------------------------------------

ROOFLINE_DECODE_B = 4
ROOFLINE_DECODE_LEN = VIEW - 1      # inside [min_context, fallback_context]
ROOFLINE_TIMED = 3


def _walks_equal(name, real, fake):
    """Raise unless two walks count the same: FLOPs per dtype, bytes and
    collective bytes per device, and the kernel records in order. The
    message names the ops whose counts differ."""
    a = {d: c.as_dict() for d, c in real.costs.items()}
    b = {d: c.as_dict() for d, c in fake.costs.items()}
    if a == b and real.kernel_keys() == fake.kernel_keys():
        return
    rows = {op: (real.by_op.get(op), fake.by_op.get(op))
            for op in set(real.by_op) | set(fake.by_op)
            if real.by_op.get(op) != fake.by_op.get(op)}
    raise AssertionError(
        f"roofline {name}: the card's walk {a} != the placeholder walk {b}; "
        f"kernel records {len(real.kernels)} vs {len(fake.kernels)} "
        f"(equal: {real.kernel_keys() == fake.kernel_keys()}); ops "
        f"[calls, flops, bytes] card vs placeholder: {rows}")


def _roofline_row(name, real, fake, step_ms, model_flops, t_real, t_fake,
                  memory):
    """The walk's terms on cuda:0, the bound (the largest), the measured
    step and MFU (model FLOPs over the step at the bf16 peak), and the
    walk's peak live bytes beside ``memory``: the card's allocated bytes
    when its peak was reset (before the walked step) and its peak
    during the step."""
    import torch
    from repro_torch.core.placement import PEAK_FLOPS
    from repro_torch.launch import roofline as RL

    _walks_equal(name, real, fake)
    rl = RL.from_walk(real.costs, 1, model_flops)
    counts = {}
    for r in real.kernels:
        counts[r.name] = counts.get(r.name, 0) + 1
    row = {"device": rl.device, "flops_by_dtype": rl.flops_by_dtype,
           "bytes": rl.hbm_bytes, "compute_s": rl.compute_s,
           "memory_s": rl.memory_s, "collective_s": rl.collective_s,
           "bound_ms": rl.step_s * 1e3, "bound_by": rl.bottleneck,
           "step_ms_median": step_ms,
           "bound_over_step": rl.step_s * 1e3 / step_ms,
           "model_flops": model_flops,
           "mfu": model_flops / (step_ms / 1e3 * PEAK_FLOPS),
           "mfu_at_bound": rl.mfu, "kernel_records": counts,
           "walks_equal": True,
           "peak_live_bytes": real.peak_live.get(rl.device, 0),
           "argument_bytes": real.argument_bytes.get(rl.device, 0),
           "allocated_at_reset": memory[0],
           "max_memory_allocated": memory[1],
           "card_total_memory": torch.cuda.get_device_properties(
               0).total_memory,
           "walk_s_card": t_real, "walk_s_placeholder": t_fake,
           "top_ops_by_bytes": sorted(
               ([op, *v] for op, v in real.by_op.items()),
               key=lambda r: -r[3])[:8]}
    log(f"  roofline {name}: compute {row['compute_s'] * 1e3:.4g} ms "
        f"({rl.flops_by_dtype}), memory {row['memory_s'] * 1e3:.4g} ms, "
        f"bound {row['bound_ms']:.4g} ms ({rl.bottleneck}); step "
        f"{step_ms:.4g} ms, bound/step {row['bound_over_step']:.3f}, MFU "
        f"{row['mfu']:.4f}; peak live {row['peak_live_bytes'] / 1e9:.2f} GB "
        f"vs max_memory_allocated "
        f"{row['max_memory_allocated'] / 1e9:.2f} GB (allocated at its "
        f"reset {memory[0] / 1e9:.2f} GB); kernels {counts}; "
        f"walks {t_real:.1f} s (card) / {t_fake:.1f} s (placeholders)")
    return row


def _timed_ms(fn, n=ROOFLINE_TIMED):
    """Median wall ms of ``fn`` over n calls, each closed by a sync."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _roofline_train(dev):
    """One train step of full-width llama3.2-1b (bf16, B 4 x S 2048, remat,
    one device, flash on the tensor cores) walked on the card and on
    placeholder cuda:0: equal counts, 32 flash records; then 3 steps timed
    without a walk."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import op_walk
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.specs import param_structs
    from repro_torch.models import init_params, model as M
    from repro_torch.train import OptConfig, TrainConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state, tree_map

    cfg = get_arch(TRAIN_ARCH)
    B, S = TRAIN_B, TRAIN_S
    tc = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5,
                                   total_steps=TRAIN_STEPS), remat=True,
                     tp=16)
    step = make_train_step(cfg, tc)
    batch = _train_batches(cfg, dev, 1, B, S)[0]
    params = init_params(cfg, 0, device=dev)
    opt = init_opt_state(params)
    step(params, opt, batch)                 # warm: caches, cuBLAS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_reset = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with op_walk.OpWalk() as real:
        real.track(params, opt.m, opt.v, batch)
        step(params, opt, batch)
        torch.cuda.synchronize()
    t_real = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    with op_walk.placeholders():
        fp = tree_map(lambda t: t.to("cuda:0"), param_structs(cfg, tc.tp))
        fo = init_opt_state(fp)
        fb = {k: torch.empty(v.shape, dtype=v.dtype).to("cuda:0")
              for k, v in batch.items()}
        with torch.no_grad():               # warm the placeholder caches
            M.train_loss(fp, cfg, fb, remat=True, tp=tc.tp)
        with op_walk.OpWalk() as fake:
            fake.track(fp, fo.m, fo.v, fb)
            step(fp, fo, fb)
    t_fake = time.perf_counter() - t0
    n_flash = sum(r.name == "flash_attention" for r in real.kernels)
    if n_flash != 2 * cfg.n_layers or len(real.kernels) != n_flash:
        raise AssertionError(f"roofline train: kernel records "
                             f"{[r.name for r in real.kernels]}")
    step_ms = _timed_ms(lambda: step(params, opt, batch))
    row = _roofline_row("train", real, fake, step_ms, RL.model_flops_for(
        cfg, ShapeConfig("train", S, B, "train")), t_real, t_fake,
        (at_reset, peak))
    del params, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(row, arch=TRAIN_ARCH, batch=B, seq=S, remat=True,
                dtype="bfloat16")


def _roofline_decode(dev):
    """One DSA ``decode_step`` of full-width llama3.2-1b (B 4, a cache of
    8191 tokens, 16-token pages) walked on the card and on placeholder
    cuda:0: equal counts, relevancy and paged attention recorded once a
    layer each; then 3 steps timed without a walk."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.methods import dsa
    from repro_torch.launch import op_walk
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.specs import (cache_structs, param_structs,
                                          sparse_structs)
    from repro_torch.models import init_params, model as M
    from repro_torch.train.optimizer import tree_map

    cfg = get_arch(SERVE_ARCH)
    B, n = ROOFLINE_DECODE_B, ROOFLINE_DECODE_LEN
    mem = cfg.memory
    if not mem.min_context <= n + 1 <= mem.fallback_context:
        raise AssertionError(f"decode length {n + 1} outside the window")
    fn = dsa.make_sparse_fn(cfg, mem, tp=16, page=PAGE)
    g = torch.Generator(device=dev).manual_seed(11)
    params = init_params(cfg, 0, device=dev)
    sp = dsa.dsa_init(cfg, mem, 0, device=dev)
    caches = M.make_cache(cfg, B, VIEW, device=dev)
    for name in ("k", "v"):
        caches[name].normal_(generator=g)
    caches["length"] = n
    token = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=dev,
                          dtype=torch.int32)

    def decode(p, c, t, s):
        with torch.no_grad():
            return M.decode_step(p, cfg, t, c, tp=16, sparse_fn=fn,
                                 sparse_params=s)

    decode(params, caches, token, sp)        # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_reset = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with op_walk.OpWalk() as real:
        real.track(params, caches, token, sp)
        decode(params, caches, token, sp)
        torch.cuda.synchronize()
    t_real = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    with op_walk.placeholders():
        on = lambda tree: tree_map(  # noqa: E731
            lambda t: t.to("cuda:0") if isinstance(t, torch.Tensor) else t,
            tree)
        fp, fs = on(param_structs(cfg, 16)), on(sparse_structs(cfg, 16))
        fc = on(cache_structs(cfg, B, VIEW, 16))
        fc["length"] = n
        ft = torch.empty(B, dtype=token.dtype).to("cuda:0")
        decode(fp, fc, ft, fs)               # warm the placeholder caches
        with op_walk.OpWalk() as fake:
            fake.track(fp, fc, ft, fs)
            decode(fp, fc, ft, fs)
    t_fake = time.perf_counter() - t0
    names = [r.name for r in real.kernels]
    want = {"relevancy_topk_candidates": cfg.n_layers,
            "paged_decode_attention": cfg.n_layers}
    if {k: names.count(k) for k in set(names)} != want:
        raise AssertionError(f"roofline decode: kernel records {names}")
    step_ms = _timed_ms(lambda: decode(params, caches, token, sp))
    row = _roofline_row("decode", real, fake, step_ms, RL.model_flops_for(
        cfg, ShapeConfig("decode", n + 1, B, "decode")), t_real, t_fake,
        (at_reset, peak))
    del params, caches, sp
    gc.collect()
    torch.cuda.empty_cache()
    return dict(row, arch=SERVE_ARCH, batch=B, context=n + 1, page=PAGE,
                method="dsa", dtype="bfloat16")


def phase_roofline(dev):
    """The dry-run and roofline tools on the card (``launch.op_walk``,
    ``launch.roofline``, ``launch.dryrun``): (a) one full-width llama3.2-1b
    train step and (b) one DSA decode step, each walked on the card and
    dry-run on placeholder cuda:0, the two walks equal in FLOPs per dtype,
    bytes and kernel records (collectives are compared on placeholder
    meshes only: a mesh of one card's entries aliases ``.to``), with the
    terms, the bound, the measured step and MFU, and the walk's peak live
    bytes beside ``max_memory_allocated``; (c) the dry run of llama3.2-1b's
    decode_32k cell on the 16 x 16 mesh of placeholder cards at all 16
    layers, trip-count scaled (``dryrun.trip_scale``: walks at 2 and 3
    layers, solved for 16; the whole depth walked takes a minute). One
    ``roofline`` line."""
    from repro_torch.launch import dryrun

    out = {"card": card_line(), "train": _roofline_train(dev),
           "decode": _roofline_decode(dev)}
    t0 = time.perf_counter()
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", force=True,
                          out_dir=os.path.join(ROOT, "chiprun_out", "dryrun"))
    if not rec.get("ok"):
        raise AssertionError(f"roofline dry run: {rec.get('error')}")
    if rec["cut"]["units"] != {"layers": {"full": 16, "walked": [2, 3]}}:
        raise AssertionError(f"roofline dry run: cut {rec['cut']}")
    rl, ma = rec["roofline"], rec["memory_analysis"]
    out["dryrun"] = {
        "cell": "llama3.2-1b decode_32k 16x16 baseline, 16 layers, "
                "trip-count scaled", "wall_s":
        time.perf_counter() - t0, "walks": rec["walks"], "cut": rec["cut"],
        "device": rl["device"],
        "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
        "collective_s": rl["collective_s"], "bottleneck": rl["bottleneck"],
        "mfu_at_bound": rl["mfu"], "flops_by_dtype": rl["flops_by_dtype"],
        "ideal_memory_s": rl["ideal_memory_s"],
        "peak_live_bytes": ma["peak_live_bytes"], "fits_80gb": ma["fits"],
        "kernel_calls": rec["kernel_calls"], "walked": rec["walked"]}
    log(f"  dry run decode_32k 16x16: {out['dryrun']}")
    print(json.dumps({"roofline": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3e: decode over a sequence-split cache
# ---------------------------------------------------------------------------

DECODE_MESH = ((2, 4), ("data", "model"))
DECODE_PAGE = 64                    # DSA's micro-page in the decode cells
DECODE_A = (4, 32768, 8)            # decode_32k's layout: B, cache, steps
DECODE_B = (1, 524288, 4)           # long_500k's: B, cache, steps
# the fp32 steps: (mesh, B) on an 8192-token cache, one step each: the
# sequence on model (B 2 on (1, 4)), rows on data (B 2 on (2, 2)), the
# sequence over (data, model) (B 1 on (2, 2))
DECODE_C = (8192, 1)
DECODE_C_CASES = ((((1, 4), ("data", "model")), 2),
                  (((2, 2), ("data", "model")), 2),
                  (((2, 2), ("data", "model")), 1))
# abs bound on the split's bf16 logits against one device's in (a) and
# (b), and on the top-2 margin below which a differing greedy token
# counts as a near-tie. From ``--phases decode_bounds`` (PERF.md): one
# device's bf16 logits against fp32 reach 1.14 (a page picked otherwise
# near a selection tie); the split with a faulty (out, lse) merge is off
# by 1.58 or more at every step of (b) but one and 2.06 or more in (a)
DECODE_BF16_TOL = 1.5
# abs bound on prefill_tp's last bf16 logits against prefill's: five times
# prefill's bf16-against-fp32 reading, 0.10 (dense attention: no page
# selection adds to its noise)
PREFILL_BF16_TOL = 0.5
# deliberate faults in the merge of the shards' (out, lse) pairs, for the
# decode_bounds readings
DECODE_WRONG_MERGES = ("the last shard's pair dropped",
                       "the pairs weighed equally")
# Seer (top-k and threshold) and LServe over the split, beside DSA: their
# BLOCK-token blocks and BUDGET-token budget (the config's, the serve
# runs'); (a) and (c) run all three, (b) SPLIT_METHODS_B
SPLIT_METHODS = ("seer", "seer-threshold", "lserve")
SPLIT_METHODS_B = ("seer", "lserve")
# abs bound on those methods' split bf16 logits against one device's in
# (a) and (b), and their near-tie margin, set as DECODE_BF16_TOL is, from
# ``--phases decode_bounds`` (its ``methods`` readings, PERF.md): the right
# split reaches 0.477, one device's bf16 against fp32 1.30; every step of
# every fault at (a) reads 1.15 or more, the candidate fault 1.48 or more
# at (a) and (b), and each (out, lse) fault at (b) passes 1.0 at some step
METHOD_BF16_TOL = 1.0
# the deliberate fault in the merge of the shards' (value, index)
# candidates (``topk.merge_shard_topk``): (c)'s fp32 check must fail under
# it, and decode_bounds reads what it does to the bf16 logits
CANDIDATE_FAULT = "the last shard's candidates dropped"


def _profile_call(fn):
    """``fn()`` under torch.profiler (CUDA activity only): wall and device
    busy time and the device ops, from the raw kineto events."""
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    busy_ns = n_events = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            busy_ns += e.duration_ns()
            n_events += 1
    return {"wall_us": wall_us, "device_busy_us": busy_ns / 1e3,
            "device_busy_share": busy_ns / 1e3 / wall_us,
            "device_ops": n_events}


class _FirstCall:
    """Keeps a clone of the arguments of the first call of ``ops.<name>``
    that ``pick`` accepts while installed (the kernel at the shape the main
    path gives it), and passes every call through."""

    def __init__(self, name, pick=lambda *a: True):
        from repro_torch.kernels import ops

        self.name, self.real, self.args = name, getattr(ops, name), None
        self.pick = pick

    def __enter__(self):
        from repro_torch.kernels import ops

        def call(*a, **kw):
            if self.args is None and self.pick(*a):
                self.args = ([x.clone() if hasattr(x, "clone") else x
                              for x in a], dict(kw))
            return self.real(*a, **kw)
        setattr(ops, self.name, call)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        setattr(ops, self.name, self.real)


def _place_cache(c, cfg, mesh, B, S):
    """A cache tree (k / v, or the hybrid's) placed by ``cache_specs`` on
    ``mesh``'s devices; its ``length`` kept."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh

    shp = ShapeConfig("decode", S, B, "decode")
    out = sh.device_put(c, sh.make_shardings(
        sh.cache_specs(c, cfg, shp, mesh), mesh))
    out["length"] = c.get("length", 0)
    return out


def _method_mem(cfg, method: str):
    """``cfg.memory`` with ``method`` ("dsa", "seer", "seer-threshold",
    "lserve")."""
    if method == "seer-threshold":
        return cfg.memory.replace(method="seer", selection="threshold")
    return cfg.memory.replace(method=method)


def _kernels_of(method: str):
    """The two kernels a split step of ``method`` launches."""
    return (("page_minmax", "paged_decode_attention") if method == "lserve"
            else _DSA)


def _split_fns(cfg, tp, method="dsa", record=False):
    """(one device's sparse fn, the split's method) of ``method``: DSA at
    DECODE_PAGE-token micro-pages; Seer and LServe through
    ``core.methods.split_sparse`` at their blocks."""
    from repro_torch.core.methods import dsa, get_sparse_method, split_sparse

    mem = _method_mem(cfg, method)
    if method == "dsa":
        return (dsa.make_sparse_fn(cfg, mem, tp=tp, page=DECODE_PAGE),
                dsa.SplitDSA(cfg, mem, page=DECODE_PAGE, record=record))
    _, mk = get_sparse_method(mem.method)
    return (mk(cfg, mem, tp=tp),
            split_sparse(cfg, mem, page=DECODE_PAGE, record=record))


def _method_params(cfg, method, mesh, dev, stacked=True):
    """One device's weights of ``method`` (seeded; the hybrid's one set
    unstacked) and the same placed by ``method_specs`` on ``mesh``."""
    from repro_torch.core.methods import get_sparse_method
    from repro_torch.distributed import sharding as sh

    mem = _method_mem(cfg, method)
    init, _ = get_sparse_method(mem.method)
    sp1 = init(cfg, mem, 1, stacked=stacked, device=dev)
    return sp1, sh.device_put(sp1, sh.make_shardings(
        sh.method_specs(sp1, cfg, mesh), mesh))


def _dropped_candidates():
    """``topk.merge_shard_topk`` with CANDIDATE_FAULT: the last shard's
    (value, index) candidates left out of the merge (its ids still
    delivered to every shard)."""
    from repro_torch.distributed import topk

    real = topk.merge_shard_topk
    return lambda shard_topk, n_local, k, devices, **kw: real(
        shard_topk, n_local, k, devices[:-1], **kw)


class _PageIds:
    """While on, keeps the page ids of every ``ops.paged_decode_attention``
    call (one device's selections)."""

    def __init__(self):
        from repro_torch.kernels import ops

        self.real, self.pages, self.on = ops.paged_decode_attention, [], False

    def __enter__(self):
        from repro_torch.kernels import ops

        def call(q, kc, vc, page_ids, *a, **kw):
            if self.on:
                self.pages.append(page_ids.clone())
            return self.real(q, kc, vc, page_ids, *a, **kw)
        ops.paged_decode_attention = call
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.paged_decode_attention = self.real


def _decode_pair(cfg, tp, one, placed, mesh, c1, c2, tok, steps, sp1, sp2,
                 record=False, method="dsa"):
    """``steps`` greedy steps of one device's ``decode_step`` (``method``'s
    ``make_sparse_fn``) and of ``decode_step_tp`` (its split), both fed
    one device's tokens. -> per step (ms one, ms split, max |logit diff|,
    one device's tokens, the split's, one device's top-2 margins), the
    split's launches of the method's two kernels, the first shard's
    inputs of each (``ops`` name -> args), the split, the caches, the next
    token; with ``record`` also one device's page ids a call (the split
    keeps its own in ``split.selected``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    sfn, split = _split_fns(cfg, tp, method, record)
    names = _kernels_of(method)
    rows, launches = [], {k: 0 for k in names}
    caps = None
    # the selection kernel's wrapper as ``ops`` names it
    select = "page_minmax" if method == "lserve" else "relevancy_topk"
    with _PageIds() as picked:
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            picked.on = record
            l1, c1 = M.decode_step(one, cfg, tok, c1, tp=tp, sparse_fn=sfn,
                                   sparse_params=sp1)
            picked.on = False
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            c0 = ops.launch_counts()
            if i == 0:
                # the first shard that owns selected pages
                owns = lambda q, kc, vc, pages, *a: bool((pages >= 0).any())
                with _FirstCall(select) as sel, \
                        _FirstCall("paged_decode_attention", owns) as pda:
                    l2, c2 = M.decode_step_tp(placed, cfg, tok, c2, mesh,
                                              tp=tp, sparse=split,
                                              sparse_params=sp2)
                caps = {select: sel.args, "paged_decode_attention": pda.args}
            else:
                l2, c2 = M.decode_step_tp(placed, cfg, tok, c2, mesh, tp=tp,
                                          sparse=split, sparse_params=sp2)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            cn = ops.launch_counts()
            for k in names:
                launches[k] += cn[k] - c0[k]
            top2 = l1.float().topk(2, dim=-1).values
            rows.append({"ms_one": 1e3 * (t1 - t0),
                         "ms_split": 1e3 * (t2 - t1),
                         "err": float((l1.float() - l2.float()).abs().max()),
                         "tok_one": l1.argmax(-1).tolist(),
                         "tok_split": l2.argmax(-1).tolist(),
                         "margin": (top2[:, 0] - top2[:, 1]).tolist()})
            tok = l1.argmax(-1)
    if record:
        split.picked = picked.pages
    return rows, launches, caps, split, c1, c2, tok


def _pages_equal(split, sites):
    """The split's merged selections (one a computing group a site, in
    data-index order) equal one device's (``split.picked``, one a site),
    as sets of ids: the split's padding is -1."""
    import torch

    picked = split.picked
    G = len(split.selected) // max(sites, 1)
    if not (len(picked) == sites and len(split.selected) == G * sites):
        return False
    for i, b in enumerate(picked):
        got = torch.sort(torch.cat(split.selected[G * i:G * i + G]).long(),
                         1).values
        w = b.shape[1]
        if not (torch.equal(got[:, got.shape[1] - w:],
                            torch.sort(b.long(), 1).values)
                and bool((got[:, :got.shape[1] - w] == -1).all())):
            return False
    return True


def _tokens_check(name, rows, tol=None):
    """Every step's logits within ``tol`` (default DECODE_BF16_TOL) of one
    device's; equal greedy tokens, a differing one only where one device's
    top-2 margin is below ``tol`` (a near-tie), reported with its
    margin."""
    tol = DECODE_BF16_TOL if tol is None else tol
    ties, near = [], min(min(r["margin"]) for r in rows)
    for i, r in enumerate(rows):
        if not r["err"] <= tol:
            raise AssertionError(f"{name}: step {i} logits differ by "
                                 f"{r['err']} > {tol}")
        for b, (a, c) in enumerate(zip(r["tok_one"], r["tok_split"])):
            if a != c:
                if not r["margin"][b] < tol:
                    raise AssertionError(
                        f"{name}: step {i} row {b} token {c} against one "
                        f"device's {a}, margin {r['margin'][b]} >= {tol}")
                ties.append({"step": i, "row": b, "margin": r["margin"][b]})
    log(f"  {name}: tokens equal but {len(ties)} near-ties {ties}; smallest "
        f"top-2 margin {near:.4g}; logits max abs diff "
        f"{max(r['err'] for r in rows):.4g} (bound {tol})")
    return ties, near


def _shard_rows(label, caps, launches, steps, phase="decode_sharded"):
    """The kernels at the first shard's shapes as the main path gave them
    (``caps``, by ``ops`` name): kernel against plain (the relevancy top-k
    through ``ops.relevancy_topk`` with kernels on and off; paged
    attention against ``paged_decode_attention_plain``; page_minmax
    bit-exact), then times, bound and library time (``_relevancy_timing``,
    ``_paged_timing``, ``_minmax_timing``). -> {kernel name: row}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_decode_attention as sda

    out = {}
    note = "a split step (all shards, all layers)"
    if "relevancy_topk" in caps:
        (rq, rk, rw, rkk), rkw = caps["relevancy_topk"][0][:4], \
            caps["relevancy_topk"][1]
        kv, ki = ops.relevancy_topk(rq, rk, rw, rkk, **rkw)
        ops.use_kernels(False)
        try:
            pv, pi = ops.relevancy_topk(rq, rk, rw, rkk, **rkw)
        finally:
            ops.use_kernels(True)
        rel_err = _topk_check(f"relevancy, {label}", kv, ki, pv, pi)
        blk = ops._pow2_block(max(rk.shape[1], 2), rkw.get("block", 2048))
        out["relevancy_topk_candidates"] = dict(
            _relevancy_timing(rq, rk, rw, blk), path=f"{phase} {label}",
            library_ms=None, max_abs_err=rel_err,
            launches=launches["relevancy_topk_candidates"] // steps,
            launches_note=note,
            shape=f"q [{', '.join(map(str, rq.shape))}] {rq.dtype}, keys "
                  f"[{', '.join(map(str, rk.shape))}] (a shard's blocks), "
                  f"top {rkk}, block {blk}")
    if "page_minmax" in caps:
        (k,), kw = caps["page_minmax"][0][:1], caps["page_minmax"][1]
        ps = kw.get("page_size", 64)
        out["page_minmax"] = dict(
            _minmax_timing(f"page_minmax, {label}", k, ps),
            path=f"{phase} {label}", max_abs_err=0.0,
            launches=launches["page_minmax"] // steps, launches_note=note,
            shape=f"k [{', '.join(map(str, k.shape))}] {k.dtype} (a shard's "
                  f"slice), pages of {ps}, C = {k.shape[2] * k.shape[3]}")
    if "paged_decode_attention" not in caps:
        return out
    (q, kc, vc, pages, lens), pkw = caps["paged_decode_attention"][0][:5], \
        caps["paged_decode_attention"][1]
    ps = pkw.get("page_size", DECODE_PAGE)
    ko, kl = sda.paged_decode_attention(q, kc, vc, pages, lens, page_size=ps)
    po, pl_ = sda.paged_decode_attention_plain(q, kc, vc, pages, lens,
                                               page_size=ps)
    err = _attn_check(f"paged attention, {label}", ko, kl, po, pl_)
    out["paged_decode_attention"] = dict(
        _paged_timing(q, kc, vc, pages, lens, ps), path=f"{phase} {label}",
        max_abs_err=err, launches=launches["paged_decode_attention"] // steps,
        launches_note=note,
        shape=f"q [{', '.join(map(str, q.shape))}] {q.dtype}, k/v "
              f"[{', '.join(map(str, kc.shape))}] (a shard's slice), "
              f"{int((pages >= 0).sum())} of {pages.numel()} selected "
              f"{ps}-token pages its own")
    return out


def _minmax_timing(name, k, ps):
    """page_minmax on ``k``: bit-exact against its plain version; kernel
    (cold L2, and warm), plain and library (``torch.aminmax`` + ``.float()``)
    times and its bound."""
    import torch
    from repro_torch.kernels import page_pool as pp

    mn, mx = pp.page_minmax(k, page_size=ps)
    pmn, pmx = pp.page_minmax_plain(k, page_size=ps)
    _exact(f"{name} min", mn, pmn)
    _exact(f"{name} max", mx, pmx)
    B, S, KV, dh = k.shape
    n = cold_copies(pp.cost(k, page_size=ps).bytes)
    ks = [k] + [k.clone() for _ in range(n - 1)]
    ms = time_ms([lambda x=x: pp.page_minmax(x, page_size=ps) for x in ks])
    ms_warm = time_ms(lambda: pp.page_minmax(k, page_size=ps))
    plain_ms = time_ms([lambda x=x: pp.page_minmax_plain(x, page_size=ps)
                        for x in ks])

    def library(x):
        lo, hi = torch.aminmax(x.view(B, S // ps, ps, KV, dh), dim=2)
        return lo.float(), hi.float()

    _exact(f"{name}: aminmax yardstick min", library(k)[0], pmn)
    library_ms = time_ms([lambda x=x: library(x) for x in ks])
    del ks
    log(f"  {name}: bit-exact, {ms:.5f} ms cold (warm {ms_warm:.5f}), plain "
        f"{plain_ms:.5f}, aminmax {library_ms:.5f}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **pp.cost(k, page_size=ps).bound(), "ms_l2_warm": ms_warm,
            "timing": f"cold L2: ms, plain_ms and library_ms rotate over {n} "
                      f"copies of k; ms_l2_warm on one copy",
            "tolerance": "bit-exact",
            "library": "torch.aminmax over the page axis, then .float()",
            "plan": _plan_note(k, ps)}


def _exchange_walk(cfg, B, S, tp):
    """One split step's bytes between cards, counted on 8 placeholder
    cards at the same shapes (the dry run's walk; the hybrid's states and
    its one set of indexer weights too): per card, by kind."""
    import torch
    from repro_torch.core.methods import dsa
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import op_walk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import (cache_structs, param_structs,
                                          sparse_structs)
    from repro_torch.models import model as M

    shape, axes = DECODE_MESH
    mesh = make_mesh(shape, axes, devices=op_walk.cards(8))
    with op_walk.placeholders():
        p = param_structs(cfg, tp)
        placed = sh.device_put(p, sh.make_shardings(
            sh.param_specs(p, cfg, mesh), mesh))
        sp = sparse_structs(cfg, tp)
        sp = sh.device_put(sp, sh.make_shardings(
            sh.method_specs(sp, cfg, mesh), mesh))
        c = cache_structs(cfg, B, S, tp)
        c["length"] = S - 1
        caches = _place_cache(c, cfg, mesh, B, S)
        tok = torch.zeros(B, dtype=torch.int32).to("cuda:0")
        with torch.no_grad(), op_walk.OpWalk() as w:
            M.decode_step_tp(placed, cfg, tok, caches, mesh, tp=tp,
                             sparse=dsa.SplitDSA(cfg, cfg.memory,
                                                 page=DECODE_PAGE),
                             sparse_params=sp)
    cards = {d: c for d, c in w.costs.items() if d.startswith("cuda")}
    return {"per_card_bytes_in": {d: int(c.coll_bytes)
                                  for d, c in sorted(cards.items())},
            "by_kind_all_cards": {k: int(sum(c.per_collective[k]
                                             for c in cards.values()))
                                  for k in op_walk.COLLECTIVES},
            "how": "counted on 8 placeholder cards (op_walk), the same "
                   "shapes and mesh"}


def _rewind(c, ctx, mesh=None):
    """A cache back to ``ctx`` tokens: every position from ``ctx`` on
    zeroed, as the seeded and prefilled caches hold them (one device's, or
    the split's with ``mesh``)."""
    from repro_torch.distributed import sharding as sh

    for t in (c["k"], c["v"]):
        if mesh is None:
            t[:, :, ctx:] = 0
            continue
        B, S = t.shape[1], t.shape[2]
        for seq in sh.seq_groups(mesh, B):
            Sl = S // len(seq)
            for j, coord in enumerate(seq):
                t.shards[coord][:, :, min(max(ctx - j * Sl, 0), Sl):] = 0
    c["length"] = ctx


def _forced(step, c, feed):
    """fp32 logits of ``step(token, caches) -> (logits, caches)`` a step,
    fed the tokens ``feed`` [steps, B]."""
    out = []
    for t in feed:
        lg, c = step(t, c)
        out.append(lg.float())
    return out


def _wrong_merge(kind):
    """``topk.merge_partials`` with the fault ``kind`` (one of
    DECODE_WRONG_MERGES)."""
    import torch
    from repro_torch.distributed import topk

    real = topk.merge_partials
    if kind == DECODE_WRONG_MERGES[0]:
        return lambda parts, targets: real(parts[:-1], targets)
    return lambda parts, targets: real(
        [(o, torch.zeros_like(lse)) for o, lse in parts], targets)


def phase_decode_bounds(dev):
    """The readings behind DECODE_BF16_TOL and METHOD_BF16_TOL
    (``--phases decode_bounds``, not a default phase). At (a)'s and (b)'s
    shapes and mesh, for DSA and each method the phase runs there
    (SPLIT_METHODS, SPLIT_METHODS_B), every run fed the same seeded
    tokens: (1) one device's bf16 logits against the fp32 logits of the
    same weights (the bf16 ones cast) on the same cache (at (a) also
    prefill's last logits, bf16 against fp32); (2) the split's bf16 logits
    against one device's on a copy of its cache, with the merges right,
    with each fault of DECODE_WRONG_MERGES in the merge of the (out, lse)
    pairs and with CANDIDATE_FAULT in the merge of the candidates. One
    ``decode_bounds`` line (the methods' under each layout's
    ``methods``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.methods import dsa
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import topk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import tree_map

    t_start = time.perf_counter()
    cfg = get_arch(SERVE_ARCH)
    cfg32 = cfg.replace(dtype="float32")
    mesh = make_mesh(*DECODE_MESH)
    tp = mesh.shape["model"]
    one = init_params(cfg, 0, tp=tp, device=dev)
    one32 = tree_map(lambda t: t.float(), one)
    placed = _place(init_params(cfg, 0, tp=tp, device=dev), cfg, mesh)
    sp1 = dsa.dsa_init(cfg, cfg.memory, 1, device=dev)
    sp2 = sh.device_put(sp1, sh.make_shardings(
        sh.method_specs(sp1, cfg, mesh), mesh))
    g = torch.Generator(device=dev).manual_seed(13)

    def diffs(a, b):
        return [float((x - y).abs().max()) for x, y in zip(a, b)]

    out = {"card": card_line(), "arch": SERVE_ARCH, "mesh": dict(mesh.shape),
           "page": DECODE_PAGE,
           "faults": list(DECODE_WRONG_MERGES) + [CANDIDATE_FAULT],
           "tolerance_in_use": DECODE_BF16_TOL,
           "methods_tolerance_in_use": METHOD_BF16_TOL}
    for label, (B, S, steps) in (("a", DECODE_A), ("b", DECODE_B)):
        ctx = S - steps
        feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=g,
                             device=dev, dtype=torch.int32)
        r = {"batch": B, "cache": S, "context": ctx, "steps": steps}
        with torch.no_grad():
            c32 = None
            if label == "a":
                toks = torch.randint(0, cfg.vocab_size, (B, ctx),
                                     generator=g, device=dev,
                                     dtype=torch.int32)
                l1, c1 = M.prefill(one, cfg, toks, max_len=S, tp=tp)
                l32, c32 = M.prefill(one32, cfg32, toks, max_len=S, tp=tp)
                r["prefill_bf16_vs_fp32"] = float(
                    (l1.float() - l32).abs().max())
                del toks, l1, l32
            else:
                shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
                k = torch.randn(shape, generator=g, device=dev,
                                dtype=torch.bfloat16)
                v = torch.randn(shape, generator=g, device=dev,
                                dtype=torch.bfloat16)
                _rewind({"k": k, "v": v}, ctx)
                c1 = {"k": k, "v": v, "length": ctx}
                del k, v
            methods = SPLIT_METHODS if label == "a" else SPLIT_METHODS_B
            for method in ("dsa",) + methods:
                m = r if method == "dsa" else \
                    r.setdefault("methods", {}).setdefault(method, {})
                sfn, split = _split_fns(cfg, tp, method)
                if method == "dsa":
                    sp1_m, sp2_m = sp1, sp2
                else:
                    sp1_m, sp2_m = _method_params(cfg, method, mesh, dev)

                def one_step(params, c_cfg):
                    return lambda t, c: M.decode_step(
                        params, c_cfg, t, c, tp=tp, sparse_fn=sfn,
                        sparse_params=sp1_m)

                def split_step(t, c):
                    return M.decode_step_tp(placed, cfg, t, c, mesh, tp=tp,
                                            sparse=split,
                                            sparse_params=sp2_m)

                _rewind(c1, ctx)
                ref = _forced(one_step(one, cfg), c1, feed)
                _rewind(c1, ctx)
                if label == "a":
                    _rewind(c32, ctx)
                    cf = c32
                else:       # one device's cache, cast (34 GB: made anew)
                    cf = {"k": c1["k"].float(), "v": c1["v"].float(),
                          "length": ctx}
                m["bf16_vs_fp32"] = diffs(
                    ref, _forced(one_step(one32, cfg32), cf, feed))
                del cf
                torch.cuda.empty_cache()
                c2 = _place_cache({"k": c1["k"], "v": c1["v"]}, cfg, mesh, B,
                                  S)
                c2["length"] = ctx
                m["split_vs_one"] = diffs(_forced(split_step, c2, feed), ref)
                real, real_c = topk.merge_partials, topk.merge_shard_topk
                for kind in DECODE_WRONG_MERGES + (CANDIDATE_FAULT,):
                    _rewind(c2, ctx, mesh)
                    if kind == CANDIDATE_FAULT:
                        topk.merge_shard_topk = _dropped_candidates()
                    else:
                        topk.merge_partials = _wrong_merge(kind)
                    try:
                        m[f"wrong merge, {kind}"] = diffs(
                            _forced(split_step, c2, feed), ref)
                    finally:
                        topk.merge_partials = real
                        topk.merge_shard_topk = real_c
                del c2
                torch.cuda.empty_cache()
                if method != "dsa":
                    log(f"  ({label}) {method} {json.dumps(m)}")
            del c1, c32
            torch.cuda.empty_cache()
        out[label] = r
        log(f"  ({label}) "
            f"{json.dumps({k: v for k, v in r.items() if k != 'methods'})}")
    del one, one32, placed, sp1, sp2
    torch.cuda.empty_cache()
    out["hybrid"] = _hybrid_bounds(dev)
    out["seconds"] = time.perf_counter() - t_start
    print(json.dumps({"decode_bounds": out}), flush=True)


def _hybrid_bounds(dev):
    """The readings behind HYBRID_DECODE_TOL, HYBRID_STATE_TOL and
    HYBRID_PREFILL_TOL, at the hybrid_sharded phase's (p), (a) and (b)
    shapes on its mesh, every run fed the same seeded tokens from the same
    seeded cache: (1) one device's bf16 logits (and final recurrent
    states) against the fp32 ones of the same weights (the bf16 ones
    cast); (2) the split's against one device's, right, with each fault of
    DECODE_WRONG_MERGES (decode), and with the gated norm's variance over
    each member's channels alone (each its sum of squares times n, in
    place of the all-reduce). (3) At (c)'s fp32 shape on its first
    layout, one step of the split right and with each fault: what
    LOGIT_TOL holds there."""
    import torch
    from repro_torch.core.methods import dsa
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import topk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.train.optimizer import tree_map

    g = torch.Generator(device=dev).manual_seed(17)
    real_merge, real_norm = topk.merge_partials, ssm.norm_sums
    faults = {f"wrong merge, {k}": (_wrong_merge(k), real_norm)
              for k in DECODE_WRONG_MERGES}
    faults["per-member gated norm"] = (
        real_merge, lambda xs: [x * len(xs) for x in xs])

    def diffs(a, b):
        return [float((x - y).abs().max()) for x, y in zip(a, b)]

    out = {"mesh": dict(make_mesh(*HYBRID_MESH).shape), "tolerance_in_use": {
        "decode": HYBRID_DECODE_TOL, "states": HYBRID_STATE_TOL,
        "prefill": HYBRID_PREFILL_TOL, "fp32 (c)": LOGIT_TOL}}
    layouts = (("a", HYBRID_A, HYBRID_MESH, None),
               ("b", HYBRID_B, HYBRID_MESH, None),
               ("c", (HYBRID_C[0], DECODE_C_CASES[0][1], HYBRID_C[1], 1),
                DECODE_C_CASES[0][0], "float32"))
    for label, (layers, B, S, steps), mesh_l, dtype in layouts:
        mesh = make_mesh(*mesh_l)
        tp = mesh.shape["model"]
        cfg, one, placed, sp1, sp2 = _hybrid_params(layers, dev, mesh,
                                                    dtype)
        sfn = dsa.make_sparse_fn(cfg, cfg.memory, tp=tp, page=DECODE_PAGE)
        split = dsa.SplitDSA(cfg, cfg.memory, page=DECODE_PAGE)
        r = {"layers": layers, "batch": B, "cache": S, "steps": steps,
             "dtype": cfg.dtype, "mesh": dict(mesh.shape)}
        with torch.no_grad():
            if label == "a":     # (p) at its shape, on (a)'s weights
                _, Bp, Sp = HYBRID_PREFILL
                toks = torch.randint(0, cfg.vocab_size, (Bp, Sp),
                                     generator=g, device=dev,
                                     dtype=torch.int32)
                ref = M.prefill(one, cfg, toks, tp=tp)[0].float()
                one32 = tree_map(lambda t: t.float(), one)
                p = {"bf16_vs_fp32": float((M.prefill(
                    one32, cfg.replace(dtype="float32"), toks, tp=tp)[0]
                    - ref).abs().max())}
                del one32

                def split_prefill():
                    return torch.cat([M.prefill_tp(
                        sh.group_view(placed, mesh, d), cfg,
                        toks[sh.row_block(mesh, Bp, d)], tp=tp)[0]
                        for d in range(mesh.shape["data"])]).float()

                p["split_vs_one"] = float((split_prefill() - ref).abs().max())
                ssm.norm_sums = faults["per-member gated norm"][1]
                try:
                    p["per-member gated norm"] = float(
                        (split_prefill() - ref).abs().max())
                finally:
                    ssm.norm_sums = real_norm
                out["p"] = p
                log(f"  (hybrid p) {json.dumps(p)}")
                del toks, ref
            ctx = S - steps
            c0 = _hybrid_cache(cfg, B, S, ctx, g, dev)
            feed = torch.randint(0, cfg.vocab_size, (steps, B), generator=g,
                                 device=dev, dtype=torch.int32)

            def forced(step, c):
                """fp32 logits a step and the final recurrent states (the
                K / V, 15 GB a copy at (b), dropped)."""
                got = []
                for t in feed:
                    lg, c = step(t, c)
                    got.append(lg.float())
                return got, {k: v for k, v in c.items()
                             if k not in ("shared_k", "shared_v")}

            ref, c_ref = forced(lambda t, c: M.decode_step(
                one, cfg, t, c, tp=tp, sparse_fn=sfn, sparse_params=sp1),
                _copy_cache(c0))
            if dtype is None:
                one32 = tree_map(lambda t: t.float(), one)
                got, c32 = forced(lambda t, c: M.decode_step(
                    one32, cfg.replace(dtype="float32"), t, c, tp=tp,
                    sparse_fn=sfn, sparse_params=sp1),
                    _copy_cache(c0, torch.float32))
                r["bf16_vs_fp32"] = diffs(ref, got)
                r["states_bf16_vs_fp32"] = _states_gap(c_ref, c32)
                del one32, c32, got
                torch.cuda.empty_cache()

            def split_run(name):
                got, c2 = forced(lambda t, c: M.decode_step_tp(
                    placed, cfg, t, c, mesh, tp=tp, sparse=split,
                    sparse_params=sp2), _place_cache(c0, cfg, mesh, B, S))
                r[name] = diffs(got, ref)
                r[f"states, {name}"] = _states_gap(c2, c_ref)

            split_run("split_vs_one")
            for name, (merge, norm) in faults.items():
                topk.merge_partials, ssm.norm_sums = merge, norm
                try:
                    split_run(name)
                finally:
                    topk.merge_partials, ssm.norm_sums = real_merge, real_norm
            del c0, c_ref
        del one, placed
        torch.cuda.empty_cache()
        out[label] = r
        log(f"  (hybrid {label}) {json.dumps(r)}")
    return out


def _states_gap(got, want):
    """Max |got - want| over the hybrid's recurrent states: ``want`` one
    device's cache, ``got`` another's or the split's (each shard against
    its slice)."""
    from repro_torch.distributed import sharding as sh

    worst = 0.0
    for name in ("body_ssm", "body_conv", "tail_ssm", "tail_conv"):
        tup = lambda t: t if isinstance(t, tuple) else (t,)
        for x, y in zip(tup(got[name]), tup(want[name])):
            pairs = (zip(x.shards, (y[sl] for sl in x.slices))
                     if isinstance(x, sh.ShardedTensor) else [(x, y)])
            for a, b in pairs:
                if a.numel():
                    worst = max(worst, float((a.float() - b.float()).abs()
                                             .max()))
    return worst


def _method_runs(tag, methods, cfg, tp, one, placed, mesh, c1, c2, ctx, tok,
                 steps, want, dev, rows=None, phase="decode_sharded"):
    """``steps`` greedy bf16 steps of each of ``methods`` (Seer, Seer's
    threshold, LServe) on the caches of ``tag``'s DSA run, each from the
    same ``ctx`` tokens (``_rewind``) and first token ``tok``: the split
    against one device's (``_decode_pair``), tokens and logits within
    METHOD_BF16_TOL, ``want`` launches of each of the method's kernels a
    split step. ``rows``: {method: its kernels to time at the first shard's
    shapes (``_shard_rows``)}. -> (the line's dict, the kernel rows by
    name, launches by path)."""
    import torch

    out, rows_out, launches_out = {}, {}, {}
    for method in methods:
        t0 = time.perf_counter()
        _rewind(c1, ctx)
        _rewind(c2, ctx, mesh)
        sp1, sp2 = _method_params(cfg, method, mesh, dev)
        with torch.no_grad():
            got, launches, caps, _, c1, c2, _ = _decode_pair(
                cfg, tp, one, placed, mesh, c1, c2, tok, steps, sp1, sp2,
                method=method)
        t1 = time.perf_counter()
        ties, near = _tokens_check(f"{tag} {method}", got, METHOD_BF16_TOL)
        if launches != {k: want * steps for k in _kernels_of(method)}:
            raise AssertionError(f"{phase} {tag} {method}: launches "
                                 f"{launches}, want {want} a step")
        launches_out[f"{phase} {tag} {method}"] = launches
        out[method] = {
            "step_ms_one_device_median": statistics.median(
                r["ms_one"] for r in got[1:]),
            "step_ms_split_median": statistics.median(
                r["ms_split"] for r in got[1:]),
            "logits_max_abs_diff": [r["err"] for r in got],
            "logits_tolerance": METHOD_BF16_TOL, "near_ties": ties,
            "smallest_top2_margin": near,
            "launches_per_step": {k: v // steps for k, v in launches.items()},
            "seconds": t1 - t0}
        log(f"  {tag} {method}: step ms one device "
            f"{out[method]['step_ms_one_device_median']:.2f}, split "
            f"{out[method]['step_ms_split_median']:.2f}; {t1 - t0:.1f} s")
        if rows and method in rows:
            label = f"{tag} {method}: a shard of {len(_first_seq(mesh, c2))}"
            got_rows = _shard_rows(label, {
                k: v for k, v in caps.items()
                if _ROW_KERNEL[k] in rows[method]}, launches, steps, phase)
            for name, row in got_rows.items():
                rows_out.setdefault(name, []).append(row)
            out[method]["rows_seconds"] = time.perf_counter() - t1
    return out, rows_out, launches_out


# the ``ops`` name of each kernel's wrapper call that ``_decode_pair`` keeps
_ROW_KERNEL = {"relevancy_topk": "relevancy_topk_candidates",
               "page_minmax": "page_minmax",
               "paged_decode_attention": "paged_decode_attention"}


def _first_seq(mesh, caches):
    """The first sequence group of ``caches``' layout on ``mesh``."""
    from repro_torch.distributed import sharding as sh

    kname = "shared_k" if "shared_k" in caches else "k"
    return sh.seq_groups(mesh, caches[kname].shape[1])[0]


def _fp32_methods(cfg, tp, one, placed, mesh, c0, ctx, dev, sites, tag,
                  methods, fault=True, hybrid=False, rows=None,
                  phase="decode_sharded"):
    """(c): one fp32 step of each of ``methods`` from the cache ``c0`` (a
    one-device tree kept as it is), the split against one device's:
    logits within LOGIT_TOL and the selected ids equal; with ``fault``,
    the same step with CANDIDATE_FAULT must fail that check. ``rows`` as
    ``_method_runs``'. -> (per method dict, rows by name, launches by
    path)."""
    import torch
    from repro_torch.distributed import topk

    out, rows_out, launches_out = {}, {}, {}
    B, S = c0["shared_k" if hybrid else "k"].shape[1:3]
    tok = torch.randint(0, cfg.vocab_size, (B,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5),
                        dtype=torch.int32)
    for method in methods:
        sp1, sp2 = _method_params(cfg, method, mesh, dev, stacked=not hybrid)
        res = {}
        for name in (("right", "fault") if fault else ("right",)):
            c1 = _copy_cache(c0)
            c2 = _place_cache(c1, cfg, mesh, B, S)
            real = topk.merge_shard_topk
            if name == "fault":
                topk.merge_shard_topk = _dropped_candidates()
            try:
                with torch.no_grad():
                    got, launches, caps, split, c1, c2, _ = _decode_pair(
                        cfg, tp, one, placed, mesh, c1, c2, tok, 1, sp1, sp2,
                        record=True, method=method)
            finally:
                topk.merge_shard_topk = real
            res[name] = (got[0]["err"], _pages_equal(split, sites),
                         _states_gap(c2, c1) if hybrid else 0.0)
            if name == "right":
                path = (f"{phase} {tag} {method} on "
                        f"{mesh.shape['data']} x {mesh.shape['model']} B {B}")
                launches_out[path] = launches
                if rows and method in rows:
                    n_seq = len(_first_seq(mesh, c2))
                    got_rows = _shard_rows(
                        f"{tag} {method}: a shard of {n_seq}",
                        {k: v for k, v in caps.items()
                         if _ROW_KERNEL[k] in rows[method]}, launches, 1,
                        phase)
                    for k, row in got_rows.items():
                        rows_out.setdefault(k, []).append(row)
            del c1, c2
        err, same, states = res["right"]
        r = {"logits_max_abs_diff": err, "selected_ids_equal": same,
             "tolerance": LOGIT_TOL}
        if hybrid:
            r["states_max_abs_diff"] = states
        if fault:
            f_err, f_same, _ = res["fault"]
            r["candidate_fault"] = {"fault": CANDIDATE_FAULT,
                                    "logits_max_abs_diff": f_err,
                                    "selected_ids_equal": f_same,
                                    "fails_the_check": not (
                                        f_err <= LOGIT_TOL and f_same)}
        log(f"  {tag} {method} fp32 on {mesh.shape['data']} x "
            f"{mesh.shape['model']}, B {B}: logits within {err:.3g} (tol "
            f"{LOGIT_TOL}), ids equal {same}"
            + (f"; {CANDIDATE_FAULT}: "
               f"{r['candidate_fault']['logits_max_abs_diff']:.3g}, ids "
               f"equal {r['candidate_fault']['selected_ids_equal']}"
               if fault else ""))
        if not (err <= LOGIT_TOL and same and states <= LOGIT_TOL):
            raise AssertionError(f"{phase} {tag} {method} "
                                 f"{dict(mesh.shape)} B {B}: err {err}, ids "
                                 f"equal {same}, states {states}")
        if fault and not r["candidate_fault"]["fails_the_check"]:
            raise AssertionError(f"{phase} {tag} {method}: the check passes "
                                 f"with {CANDIDATE_FAULT}")
        out[method] = r
    return out, rows_out, launches_out


def _merge_rows(into, rows):
    """Kernel rows ({name: a row, or a list of them}) added to ``into``'s
    lists."""
    for k, v in rows.items():
        into.setdefault(k, []).extend(v if isinstance(v, list) else [v])


def phase_decode_sharded(dev):
    """Decode over a sequence-split cache (``models.model.decode_step_tp``)
    on the one card, one process over meshes whose entries are all
    ``cuda:0``: llama3.2-1b at full width with seeded weights, DSA at
    64-token pages (``SplitDSA``: per shard the relevancy top-k and paged
    attention kernels; only (value, index) candidates, page ids and (out,
    lse) pairs cross). (a) decode_32k's layout, bf16: B 4, ``prefill_tp``
    of 32,760 tokens a row over each data index's model group (the flash
    kernel), resharded (``reshard_prefill_caches``) onto a (2, 4) mesh,
    then 8 greedy steps against one device's ``prefill`` +
    ``decode_step``; (b) long_500k's layout, bf16: B 1, a seeded cache of
    524,284 tokens in 524,288 on (2, 4) (65,536 a coordinate), 4 steps
    against one device's on the same cache; the bf16 logits of (a) and
    (b) within DECODE_BF16_TOL, prefill_tp's last logits within
    PREFILL_BF16_TOL; (c) fp32: a
    seeded 8192-token cache, one step in each of ``DECODE_C_CASES``'
    layouts, logits within LOGIT_TOL and the selected page ids equal.
    Tokens equal (a near-tie, its top-2 margin below DECODE_BF16_TOL,
    reported with its margin); 2 x 4 x 16 = 128 launches of each kernel a
    split step; the
    two kernels at each layout's per-shard shape against their plain
    versions, timed beside their bound and library time; step ms of both
    in the same call, peak memory, a profiled step's busy share and device
    ops against one device's, the bytes a split step exchanges (counted on
    placeholder cards). One ``decode_sharded`` line; returns the kernel
    rows and launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.methods import dsa
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models import model as M

    t_start = time.perf_counter()
    cfg = get_arch(SERVE_ARCH)
    mesh = make_mesh(*DECODE_MESH)
    tp = mesh.shape["model"]
    dp = mesh.shape["data"]
    L = cfg.n_layers
    want = dp * tp * L
    out = {"card": card_line(), "arch": SERVE_ARCH, "mesh": dict(mesh.shape),
           "mesh_devices": sorted(set(map(str, mesh.devices.flat))),
           "page": DECODE_PAGE, "top_k": cfg.memory.top_k}
    rows_out = {k: [] for k in _DSA}
    launches_out = {}
    one = init_params(cfg, 0, tp=tp, device=dev)
    placed = _place(init_params(cfg, 0, tp=tp, device=dev), cfg, mesh)
    sp1 = dsa.dsa_init(cfg, cfg.memory, 1, device=dev)
    sp2 = sh.device_put(sp1, sh.make_shardings(
        sh.method_specs(sp1, cfg, mesh), mesh))
    g = torch.Generator(device=dev).manual_seed(11)
    out["methods"] = {"block": cfg.memory.block_size,
                      "token_budget": cfg.memory.token_budget,
                      "pages_per_physical": cfg.memory.pages_per_physical,
                      "threshold": cfg.memory.threshold}

    # (a) decode_32k's layout: prefill_tp, reshard, 8 steps
    B, S, steps = DECODE_A
    ctx = S - steps
    toks = torch.randint(0, cfg.vocab_size, (B, ctx), generator=g,
                         device=dev, dtype=torch.int32)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l1, c1 = M.prefill(one, cfg, toks, max_len=S, tp=tp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        parts, lasts = [], []
        for d in range(dp):
            last, part = M.prefill_tp(sh.group_view(placed, mesh, d), cfg,
                                      toks[sh.row_block(mesh, B, d)],
                                      max_len=S, tp=tp)
            parts.append(part)
            lasts.append(last)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        c2 = M.reshard_prefill_caches(parts, cfg, mesh)
        del parts
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pre_err = float((torch.cat(lasts).float() - l1.float()).abs().max())
        if not pre_err <= PREFILL_BF16_TOL:
            raise AssertionError(f"decode_sharded (a): prefill_tp's last "
                                 f"logits differ from prefill's by {pre_err}"
                                 f" > {PREFILL_BF16_TOL}")
        torch.cuda.reset_peak_memory_stats()
        tok_a = l1.argmax(-1)
        rows, launches, caps, _, c1, c2, tok = _decode_pair(
            cfg, tp, one, placed, mesh, c1, c2, tok_a, steps, sp1, sp2)
        peak = torch.cuda.max_memory_allocated()
    ties, near = _tokens_check("(a) decode_32k layout", rows)
    if launches != {k: want * steps for k in _DSA}:
        raise AssertionError(f"decode_sharded (a): launches {launches}, "
                             f"want {want} a step")
    _merge_rows(rows_out, _shard_rows("(a) decode_32k: a shard of 4", caps,
                                      launches, steps))
    launches_out["decode_sharded (a)"] = launches
    out["a"] = {
        "layout": "decode_32k: rows on data, the sequence on model",
        "batch": B, "cache": S, "prompt": ctx, "steps": steps,
        "dtype": "bfloat16",
        "prefill_s_one_device": t1 - t0, "prefill_tp_s": t2 - t1,
        "reshard_s": t3 - t2, "prefill_logits_max_abs_diff": pre_err,
        "prefill_logits_tolerance": PREFILL_BF16_TOL,
        "logits_tolerance": DECODE_BF16_TOL,
        "step_ms_one_device": [r["ms_one"] for r in rows],
        "step_ms_split": [r["ms_split"] for r in rows],
        "step_ms_one_device_median": statistics.median(
            r["ms_one"] for r in rows[1:]),
        "step_ms_split_median": statistics.median(
            r["ms_split"] for r in rows[1:]),
        "logits_max_abs_diff": [r["err"] for r in rows],
        "near_ties": ties, "smallest_top2_margin": near,
        "launches": launches, "launches_per_step": {
            k: v // steps for k, v in launches.items()},
        "peak_memory_bytes": peak,
        "peak_note": "one device's and the split's caches and weights "
                     "both resident"}
    log(f"  (a) prefill {t1 - t0:.2f} s one device, {t2 - t1:.2f} s "
        f"prefill_tp, reshard {t3 - t2:.2f} s (last logits within "
        f"{pre_err:.3g}); step ms one device "
        f"{out['a']['step_ms_one_device_median']:.2f}, split "
        f"{out['a']['step_ms_split_median']:.2f}; peak {peak / 1e9:.2f} GB")

    # the profiled step of each, on (a)'s caches
    sfn = dsa.make_sparse_fn(cfg, cfg.memory, tp=tp, page=DECODE_PAGE)
    split = dsa.SplitDSA(cfg, cfg.memory, page=DECODE_PAGE)
    c1["length"] = c2["length"] = S - 1     # re-run the last position
    with torch.no_grad():
        p_one = _profile_call(lambda: M.decode_step(
            one, cfg, tok, dict(c1), tp=tp, sparse_fn=sfn,
            sparse_params=sp1))
        p_split = _profile_call(lambda: M.decode_step_tp(
            placed, cfg, tok, dict(c2), mesh, tp=tp, sparse=split,
            sparse_params=sp2))
    out["a"]["profiled_step_one_device"] = p_one
    out["a"]["profiled_step_split"] = p_split
    log(f"  (a) profiled step: split busy "
        f"{100 * p_split['device_busy_share']:.1f} % with "
        f"{p_split['device_ops']} device ops, one device "
        f"{100 * p_one['device_busy_share']:.1f} % with "
        f"{p_one['device_ops']}")
    out["a"]["exchange_per_step"] = _exchange_walk(cfg, B, S, tp)
    # Seer (top-k, threshold) and LServe on the same prefilled cache
    t_m = time.perf_counter()
    out["methods"]["a"], got_rows, got_launches = _method_runs(
        "(a)", SPLIT_METHODS, cfg, tp, one, placed, mesh, c1, c2, ctx, tok_a,
        steps, want, dev, rows={"seer": ("relevancy_topk_candidates",
                                         "paged_decode_attention"),
                                "lserve": ("page_minmax",)})
    out["methods"]["a_seconds"] = time.perf_counter() - t_m
    _merge_rows(rows_out, got_rows)
    launches_out.update(got_launches)
    del c1, c2
    torch.cuda.empty_cache()

    # (b) long_500k's layout: a seeded cache, the sequence over the mesh
    B, S, steps = DECODE_B
    ctx = S - steps
    shape = (L, B, S, cfg.n_kv_heads, cfg.hd)
    k = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    v = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
    k[:, :, ctx:] = 0
    v[:, :, ctx:] = 0
    c2 = _place_cache({"k": k, "v": v}, cfg, mesh, B, S)
    c1 = {"k": k, "v": v, "length": ctx}
    c2["length"] = ctx
    del k, v
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        tok = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        rows, launches, caps, _, c1, c2, _ = _decode_pair(
            cfg, tp, one, placed, mesh, c1, c2, tok, steps, sp1, sp2)
        peak = torch.cuda.max_memory_allocated()
    t_m = time.perf_counter()
    out["methods"]["b"], _, got_launches = _method_runs(
        "(b)", SPLIT_METHODS_B, cfg, tp, one, placed, mesh, c1, c2, ctx, tok,
        steps, mesh.size * L, dev)
    out["methods"]["b_seconds"] = time.perf_counter() - t_m
    launches_out.update(got_launches)
    del c1, c2          # the kernel rows' cold copies need the room
    torch.cuda.empty_cache()
    ties, near = _tokens_check("(b) long_500k layout", rows)
    if launches != {k: mesh.size * L * steps for k in _DSA}:
        raise AssertionError(f"decode_sharded (b): launches {launches}")
    _merge_rows(rows_out, _shard_rows("(b) long_500k: a shard of 8", caps,
                                      launches, steps))
    launches_out["decode_sharded (b)"] = launches
    out["b"] = {
        "layout": "long_500k: the sequence over (data, model), data-major",
        "batch": B, "cache": S, "seeded_tokens": ctx, "steps": steps,
        "tokens_a_coordinate": S // mesh.size, "dtype": "bfloat16",
        "step_ms_one_device": [r["ms_one"] for r in rows],
        "step_ms_split": [r["ms_split"] for r in rows],
        "step_ms_one_device_median": statistics.median(
            r["ms_one"] for r in rows[1:]),
        "step_ms_split_median": statistics.median(
            r["ms_split"] for r in rows[1:]),
        "logits_max_abs_diff": [r["err"] for r in rows],
        "logits_tolerance": DECODE_BF16_TOL,
        "near_ties": ties, "smallest_top2_margin": near,
        "launches": launches, "peak_memory_bytes": peak,
        "exchange_per_step": _exchange_walk(cfg, B, S, tp)}
    log(f"  (b) step ms one device {out['b']['step_ms_one_device_median']:.2f}"
        f", split {out['b']['step_ms_split_median']:.2f}; peak "
        f"{peak / 1e9:.2f} GB (both copies)")
    del one, placed
    torch.cuda.empty_cache()

    # (c) one fp32 step in each layout: logits and the selected pages, for
    # DSA and each method; the candidate-merge fault fails that check
    S, steps = DECODE_C
    cfg32 = cfg.replace(dtype="float32")
    out["c"] = []
    t_m, t_dsa = time.perf_counter(), 0.0
    for mesh_c, B in DECODE_C_CASES:
        meshc = make_mesh(*mesh_c)
        one = init_params(cfg32, 0, tp=tp, device=dev)
        placed = _place(init_params(cfg32, 0, tp=tp, device=dev), cfg32,
                        meshc)
        shape = (L, B, S, cfg.n_kv_heads, cfg.hd)
        ctx = S - 1
        k = torch.randn(shape, generator=g, device=dev)
        v = torch.randn(shape, generator=g, device=dev)
        k[:, :, ctx:] = 0
        v[:, :, ctx:] = 0
        c0 = {"k": k, "v": v, "length": ctx}
        t0 = time.perf_counter()
        got, _, _ = _fp32_methods(cfg32, tp, one, placed, meshc, c0, ctx,
                                  dev, L, "(c)", ("dsa",))
        t_dsa += time.perf_counter() - t0
        err, same = got["dsa"]["logits_max_abs_diff"], \
            got["dsa"]["selected_ids_equal"]
        methods, _, got_launches = _fp32_methods(
            cfg32, tp, one, placed, meshc, c0, ctx, dev, L, "(c)",
            SPLIT_METHODS)
        launches_out.update(got_launches)
        out["c"].append({"batch": B, "cache": S, "mesh": dict(meshc.shape),
                         "dtype": "float32", "logits_max_abs_diff": err,
                         "tolerance": LOGIT_TOL,
                         "selected_pages_equal": same,
                         "candidate_fault": got["dsa"]["candidate_fault"],
                         "methods": methods})
        del c0, one, placed, k, v
        torch.cuda.empty_cache()
    out["methods"]["c_seconds"] = time.perf_counter() - t_m - t_dsa
    out["seconds"] = time.perf_counter() - t_start
    out["kernel_rows"] = rows_out
    print(json.dumps({"decode_sharded": out}), flush=True)
    return rows_out, launches_out


# ---------------------------------------------------------------------------
# phase 3g: the hybrid's Mamba2 split over the model axis
# ---------------------------------------------------------------------------

# zamba2-7b at full width (32 q / 32 kv heads at dh 112, 112 SSM heads of
# 64 channels, d_inner 7168) on a (2, 4) mesh of the card, its depth cut for
# memory and time: the train step at 6 layers (1 shared-block site and no
# tail; train_families runs 12, 2 sites), the prefill and decode_32k's
# layout at 27 (4
# sites and the 3-layer tail, as zamba2-dsa-generate), long_500k's layout at
# 13 (2 sites and a 1-layer tail: one site's shared_k + shared_v hold 7.5
# GB at 524,288 tokens, and the phase keeps one device's copy beside the
# split's), the fp32 checks at 7 (1 site and a 1-layer tail)
HYBRID_ARCH = "zamba2-7b"
HYBRID_MESH = ((2, 4), ("data", "model"))
HYBRID_TRAIN = (6, 1e-5)                # layers (1 site), lr (the train step)
HYBRID_PREFILL = (27, 4, 4096)          # layers, B, S
HYBRID_A = (27, 4, 32768, 8)            # decode_32k's: layers, B, cache, steps
HYBRID_B = (13, 1, 524288, 4)           # long_500k's
HYBRID_C = (7, 8192)                    # fp32: layers, cache (DECODE_C_CASES)
# abs bounds on the split's bf16 logits against one device's: decode ((a)
# and (b)), its final recurrent states, and prefill ((p)); from the
# hybrid's own readings (``--phases decode_bounds``, PERF.md): the right
# split and one device's bf16 against fp32 reach 0.203 / 0.109 at (a) /
# (b) and 0.223 at (p), their states 0.420; a per-member gated norm moves
# the logits by 1.77 or more, the states by 4.05 or more. The (out, lse)
# merge faults move the bf16 logits no more than rounding does here
# (attention is 4 of 27 layers, over a random cache): (c)'s fp32 check
# holds them (they move its logits by 0.0245 or more)
HYBRID_DECODE_TOL = 0.5
HYBRID_STATE_TOL = 1.0
HYBRID_PREFILL_TOL = 0.5


def _hybrid_cache(cfg, B, S, ctx, g, dev, dtype=None):
    """The hybrid's decode cache drawn from ``g``: ``shared_k`` /
    ``shared_v`` N(0, 1) in the model dtype (or ``dtype``), zero from
    ``ctx`` on; the SSM and conv states N(0, 1) in ``make_cache``'s fp32.
    ``length`` = ctx."""
    import torch
    from repro_torch.models import model as M

    c = M.make_cache(cfg, B, S, dtype=dtype, device=dev)
    for name, t in list(c.items()):
        for x in (t if isinstance(t, tuple) else (t,)):
            if isinstance(x, torch.Tensor):
                x.copy_(torch.randn(x.shape, generator=g, device=dev))
    c["shared_k"][:, :, ctx:] = 0
    c["shared_v"][:, :, ctx:] = 0
    c["length"] = ctx
    return c


def _copy_cache(c, dtype=None):
    """A copy of a one-device cache tree; ``shared_k`` / ``shared_v`` cast
    to ``dtype`` if given (the states keep theirs)."""
    out = {}
    for name, t in c.items():
        if isinstance(t, tuple):
            out[name] = tuple(x.clone() for x in t)
        elif hasattr(t, "clone"):
            out[name] = t.to(dtype, copy=True) if dtype and name in (
                "shared_k", "shared_v") else t.clone()
        else:
            out[name] = t
    return out


def _hybrid_params(layers, dev, mesh, dtype=None):
    """zamba2-7b cut to ``layers``: (cfg, one device's seeded weights, the
    same placed by ``param_specs``, one set of DSA indexer weights and
    that placed by ``method_specs``)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.methods import dsa
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import init_params

    cfg = get_arch(HYBRID_ARCH).replace(n_layers=layers)
    if dtype:
        cfg = cfg.replace(dtype=dtype)
    tp = mesh.shape["model"]
    one = init_params(cfg, 0, tp=tp, device=dev)
    placed = _place(init_params(cfg, 0, tp=tp, device=dev), cfg, mesh)
    sp1 = dsa.dsa_init(cfg, cfg.memory, 1, stacked=False, device=dev)
    sp2 = sh.device_put(sp1, sh.make_shardings(
        sh.method_specs(sp1, cfg, mesh), mesh))
    return cfg, one, placed, sp1, sp2


def _hybrid_train(dev, mesh):
    """(t): one step of one device, its final parameters kept on the host
    and its copies freed, then one tensor-parallel step on ``mesh`` from the
    same weights and batch; each also profiled on a second batch. -> (the
    line's dict, flash launches of the split step, by route)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.models import init_params
    from repro_torch.models.model import _hybrid_shape
    from repro_torch.train import OptConfig, Trainer, TrainConfig
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.trainer import splits_model

    layers, lr = HYBRID_TRAIN
    cfg = get_arch(HYBRID_ARCH).replace(n_layers=layers)
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    if not (splits_model(cfg, mesh) and cfg.kv_shardable(tp)):
        raise AssertionError("hybrid_sharded: the mesh does not split "
                             "zamba2 over the model axis")
    B, S = TRAIN_B, TRAIN_S
    tc = TrainConfig(opt=OptConfig(lr=lr, warmup_steps=1,
                                   total_steps=CLI_TOTAL_STEPS),
                     remat=True, tp=CLI_TP)
    batches = _train_batches(cfg, dev, 2, B, S)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, init_params(cfg, 0, tp=tc.tp, device=dev))
    single_losses, single_s, _ = _steps(tr, batches[:1])
    single_peak = torch.cuda.max_memory_allocated()
    host = [p.detach().cpu() for p in leaves(tr.params)]
    single_profile = _profile_busy(tr, batches[1:])
    del tr
    torch.cuda.empty_cache()

    # the split's one step, profiled (host-bound: its wall under the
    # profiler is its unprofiled wall, 13.8-15.3 s against 14.6-19.2 s)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, _place(init_params(cfg, 0, tp=tc.tp, device=dev),
                                 cfg, mesh), mesh)
    ops.reset_launch_counts()
    profile = _profile_busy(tr, batches[:1])
    losses, step_s = profile["losses"], [profile["wall_us"] / 1e6]
    counts = ops.launch_counts()
    routes = ops.flash_route_counts()
    per_step = [counts["flash_attention"]]
    peak = torch.cuda.max_memory_allocated()
    rel = abs(losses[0] - single_losses[0]) / abs(single_losses[0])
    worst = _worst_leaf(tr.params, host)
    worst_of_bound, bound = _bf16_leaf_bound(tr.params, host, 1, lr)
    del host
    sites = _hybrid_shape(cfg)[0]
    want = sites * 2 * tp * dp
    del tr
    torch.cuda.empty_cache()
    log(f"  (t) losses one device {single_losses[0]:.5f}, split "
        f"{losses[0]:.5f} (rel {rel:.3g}, tol 2e-2); worst leaf {worst:.3g},"
        f" {worst_of_bound:.3g} of its bf16 bound; step ms "
        f"{1e3 * single_s[0]:.1f} (warm, profiled: "
        f"{single_profile['wall_us'] / 1e3:.1f}) vs {1e3 * step_s[0]:.1f} "
        f"(profiled); peak "
        f"{single_peak / 1e9:.2f} vs {peak / 1e9:.2f} GB; flash {per_step} "
        f"a step (want {want}); busy {profile['device_busy_share']:.3f} "
        f"with {profile['device_ops_per_step']:.0f} device ops (one device "
        f"{single_profile['device_busy_share']:.3f}, "
        f"{single_profile['device_ops_per_step']:.0f})")
    if not all(math.isfinite(x) for x in losses + single_losses):
        raise AssertionError(f"hybrid_sharded (t): non-finite loss {losses}")
    if rel > 2e-2:
        raise AssertionError(f"hybrid_sharded (t): split {losses} vs one "
                             f"device {single_losses}")
    if per_step != [want] or profile["flash_launches_profiled"] != want:
        raise AssertionError(f"hybrid_sharded (t): flash launches "
                             f"{per_step}, profiled "
                             f"{profile['flash_launches_profiled']}")
    if not worst_of_bound <= 1.0:
        raise AssertionError(f"hybrid_sharded (t): a leaf {worst_of_bound} "
                             f"of its bf16 bound apart")
    if routes != {fa.TENSOR_CORES: counts["flash_attention"],
                  fa.CUDA_CORES: 0}:
        raise AssertionError(f"hybrid_sharded (t): flash routes {routes}")
    if any(c for name, c in counts.items() if name != "flash_attention"):
        raise AssertionError(f"hybrid_sharded (t): other kernels {counts}")
    fp32 = _sharded_fp32(cfg, mesh, dev, label="hybrid_sharded (t) fp32")
    return {
        "layers": layers, "sites": sites, "batch": B, "seq": S, "lr": lr,
        "remat": True, "tp": tc.tp, "dtype": "bfloat16",
        "single_loss": single_losses[0], "split_loss": losses[0],
        "loss_rel_err": rel, "loss_tol": 2e-2,
        "worst_leaf_abs_diff": worst,
        "worst_leaf_of_bf16_bound": worst_of_bound,
        "leaf_bound": "1 step x (4 lr + one bf16 ulp of the leaf's max |p|)",
        "single_step_ms": 1e3 * single_s[0],
        "single_warm_step_ms": single_profile["wall_us"] / 1e3,
        "split_step_ms": 1e3 * step_s[0],
        "step_ms_note": "one device's first step unprofiled, its second "
                        "profiled (warm); the split's one step profiled",
        "single_peak_memory_bytes": single_peak,
        "split_peak_memory_bytes": peak,
        "flash_launches_per_step": per_step, "flash_launches_by_route": routes,
        "profiled_step": profile, "single_profiled_step": single_profile,
        "fp32": fp32}, counts["flash_attention"], routes


def _hybrid_prefill(dev, mesh, cfg, one, placed, g):
    """(p): ``prefill_tp`` over each data index's model group against one
    device's ``prefill``: the last logits within HYBRID_PREFILL_TOL."""
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    _, B, S = HYBRID_PREFILL
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev,
                         dtype=torch.int32)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l1, _ = M.prefill(one, cfg, toks, tp=tp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n0 = ops.launch_counts()["flash_attention"]
        lasts = [M.prefill_tp(sh.group_view(placed, mesh, d), cfg,
                              toks[sh.row_block(mesh, B, d)], tp=tp)[0]
                 for d in range(dp)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        flash = ops.launch_counts()["flash_attention"] - n0
    err = float((torch.cat(lasts).float() - l1.float()).abs().max())
    sites = M._hybrid_shape(cfg)[0]
    log(f"  (p) prefill {B} x {S}: one device {t1 - t0:.2f} s, split "
        f"{t2 - t1:.2f} s; last logits within {err:.4g} (bound "
        f"{HYBRID_PREFILL_TOL}); flash {flash} (want {sites * tp * dp})")
    if not err <= HYBRID_PREFILL_TOL:
        raise AssertionError(f"hybrid_sharded (p): prefill_tp's last logits "
                             f"{err} from prefill's > {HYBRID_PREFILL_TOL}")
    if flash != sites * tp * dp:
        raise AssertionError(f"hybrid_sharded (p): {flash} flash launches")
    return {"layers": cfg.n_layers, "batch": B, "seq": S,
            "prefill_s_one_device": t1 - t0, "prefill_tp_s": t2 - t1,
            "logits_max_abs_diff": err, "tolerance": HYBRID_PREFILL_TOL,
            "flash_launches": flash}


def _hybrid_decode(dev, mesh, label, cfg, one, placed, sp1, sp2, B, S,
                   steps, g):
    """(a) / (b): a seeded cache of S - steps tokens in S, placed by
    ``cache_specs`` on ``mesh``, ``steps`` greedy steps of the split
    against one device's (``_decode_pair``); tokens and logits within
    HYBRID_DECODE_TOL, launches, the shard kernel rows, the states' gap."""
    import torch
    from repro_torch.core.methods import dsa
    from repro_torch.models import model as M

    ctx = S - steps
    c1 = _hybrid_cache(cfg, B, S, ctx, g, dev)
    c2 = _place_cache(c1, cfg, mesh, B, S)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    tp = mesh.shape["model"]
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        rows, launches, caps, _, c1, c2, tok = _decode_pair(
            cfg, tp, one, placed, mesh, c1, c2, tok, steps, sp1, sp2)
        peak = torch.cuda.max_memory_allocated()
    states = _states_gap(c2, c1)
    sites = M._hybrid_shape(cfg)[0]
    want = sites * mesh.size
    out = {"layers": cfg.n_layers, "sites": sites, "batch": B, "cache": S,
           "seeded_tokens": ctx, "steps": steps, "dtype": "bfloat16",
           "tokens_a_coordinate": S // (mesh.size if B == 1
                                        else mesh.shape["model"]),
           "step_ms_one_device": [r["ms_one"] for r in rows],
           "step_ms_split": [r["ms_split"] for r in rows],
           "step_ms_one_device_median": statistics.median(
               r["ms_one"] for r in rows[1:]),
           "step_ms_split_median": statistics.median(
               r["ms_split"] for r in rows[1:]),
           "logits_max_abs_diff": [r["err"] for r in rows],
           "logits_tolerance": HYBRID_DECODE_TOL,
           "states_max_abs_diff": states,
           "states_tolerance": HYBRID_STATE_TOL, "launches": launches,
           "launches_per_step": {k: v // steps for k, v in launches.items()},
           "peak_memory_bytes": peak}
    ties, near = _tokens_check(f"hybrid_sharded ({label})", rows,
                               HYBRID_DECODE_TOL)
    out["near_ties"], out["smallest_top2_margin"] = ties, near
    if launches != {k: want * steps for k in _DSA}:
        raise AssertionError(f"hybrid_sharded ({label}): launches "
                             f"{launches}, want {want} a step")
    if label == "a":     # a profiled step of each, re-running the last one
        split = dsa.SplitDSA(cfg, cfg.memory, page=DECODE_PAGE)
        one_fn = dsa.make_sparse_fn(cfg, cfg.memory, tp=tp, page=DECODE_PAGE)
        c1["length"] = c2["length"] = S - 1
        with torch.no_grad():
            out["profiled_step_one_device"] = _profile_call(
                lambda: M.decode_step(one, cfg, tok, dict(c1), tp=tp,
                                      sparse_fn=one_fn, sparse_params=sp1))
            out["profiled_step_split"] = _profile_call(
                lambda: M.decode_step_tp(placed, cfg, tok, dict(c2), mesh,
                                         tp=tp, sparse=split,
                                         sparse_params=sp2))
    del c1, c2
    torch.cuda.empty_cache()
    log(f"  ({label}) {B} x {S}, {cfg.n_layers} layers: step ms one device "
        f"{out['step_ms_one_device_median']:.2f}, split "
        f"{out['step_ms_split_median']:.2f}; states within {states:.3g}; "
        f"peak {peak / 1e9:.2f} GB (both copies)")
    if not states <= HYBRID_STATE_TOL:
        raise AssertionError(f"hybrid_sharded ({label}): the split's states "
                             f"{states} from one device's > "
                             f"{HYBRID_STATE_TOL}")
    out["exchange_per_step"] = _exchange_walk(cfg, B, S, tp)
    got = _shard_rows(f"({label}) zamba2: a shard of "
                      f"{mesh.size if B == 1 else tp}", caps, launches, steps,
                      phase="hybrid_sharded")
    return out, got, launches


# the methods (c) runs beside DSA on the hybrid: paged attention at dh 112
# over 64-token blocks, page_minmax at C = 32 x 112
HYBRID_C_METHODS = ("seer", "lserve")


def _hybrid_fp32(dev, g):
    """(c): one fp32 step in each of DECODE_C_CASES' layouts at
    HYBRID_C's depth and cache, DSA and each of HYBRID_C_METHODS: logits
    within LOGIT_TOL of one device's, the selected ids equal, the states
    within LOGIT_TOL; the methods' kernels at the first layout's shard
    shapes. -> (per layout dicts, kernel rows, launches by path, the
    methods' seconds)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M

    layers, S = HYBRID_C
    out, rows, launches = [], {}, {}
    t_m = 0.0
    for i, (mesh_c, B) in enumerate(DECODE_C_CASES):
        meshc = make_mesh(*mesh_c)
        tp = meshc.shape["model"]
        cfg, one, placed, _, _ = _hybrid_params(layers, dev, meshc,
                                                "float32")
        c0 = _hybrid_cache(cfg, B, S, S - 1, g, dev)
        sites = M._hybrid_shape(cfg)[0]
        got, _, _ = _fp32_methods(cfg, tp, one, placed, meshc, c0, S - 1,
                                  dev, sites, "(c)", ("dsa",), fault=False,
                                  hybrid=True, phase="hybrid_sharded")
        t0 = time.perf_counter()
        methods, got_rows, got_launches = _fp32_methods(
            cfg, tp, one, placed, meshc, c0, S - 1, dev, sites, "(c)",
            HYBRID_C_METHODS, fault=False, hybrid=True,
            rows={"seer": ("paged_decode_attention",),
                  "lserve": ("page_minmax",)} if i == 0 else None,
            phase="hybrid_sharded")
        t_m += time.perf_counter() - t0
        _merge_rows(rows, got_rows)
        launches.update(got_launches)
        r = got["dsa"]
        out.append({"layers": layers, "batch": B, "cache": S,
                    "mesh": dict(meshc.shape), "dtype": "float32",
                    "logits_max_abs_diff": r["logits_max_abs_diff"],
                    "states_max_abs_diff": r["states_max_abs_diff"],
                    "tolerance": LOGIT_TOL,
                    "selected_pages_equal": r["selected_ids_equal"],
                    "methods": methods})
        del c0, one, placed
        torch.cuda.empty_cache()
    return out, rows, launches, t_m


def phase_hybrid_sharded(dev, seed: int = 0):
    """The hybrid's Mamba2 split on the one card, one process over meshes
    whose entries are all ``cuda:0``: zamba2-7b at full width, seeded
    weights, depth cut as HYBRID_* say. (t) one tensor-parallel train step
    on (2, 4) against one device's from the same weights and batch (bf16,
    B 4 x S 2048, remat, lr 1e-5): losses within 2e-2, the worst leaf
    within its bf16 bound, 1 site x 2 x 4 members x 2 data indices = 16
    flash launches a step on the tensor cores, step ms, peak memory, a
    profiled step's busy share and device ops of each, one fp32 step (S
    512) within the CPU tests' tolerances; (p) ``prefill_tp`` of B 4 x
    4096 against ``prefill``, within HYBRID_PREFILL_TOL; (a) decode_32k's
    layout: B 4, a cache of 32,760 tokens in 32,768 (``shared_k`` /
    ``shared_v``, SSM and conv states drawn from ``seed``), DSA at 64-token
    pages, 8 greedy steps against one device's, 4 sites x 8 coordinates =
    32 launches of each kernel a split step; (b) long_500k's: B 1,
    524,284 tokens in 524,288, 4 steps; the logits of (a) and (b) within
    HYBRID_DECODE_TOL; (c) fp32, 8192 tokens, one step in each of
    DECODE_C_CASES' layouts. Peaks, the bytes a card receives a split step
    (placeholder cards), the phase's seconds. One ``hybrid_sharded`` line;
    returns the kernel rows, launches by path and the train step's flash
    launches."""
    import torch
    from repro_torch.launch.mesh import make_mesh

    t_start = time.perf_counter()
    mesh = make_mesh(*HYBRID_MESH)
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {"card": card_line(), "arch": HYBRID_ARCH, "seed": seed,
           "mesh": dict(mesh.shape),
           "mesh_devices": sorted(set(map(str, mesh.devices.flat))),
           "page": DECODE_PAGE}
    seconds = {}

    def lap(name, t=[t_start]):
        now = time.perf_counter()
        seconds[name] = now - t[0]
        t[0] = now

    out["t"], flash, flash_routes = _hybrid_train(dev, mesh)
    lap("t")
    rows = {k: [] for k in _DSA}
    launches = {}
    cfg, one, placed, sp1, sp2 = _hybrid_params(HYBRID_A[0], dev, mesh)
    out["p"] = _hybrid_prefill(dev, mesh, cfg, one, placed, g)
    lap("p")
    _, B, S, steps = HYBRID_A
    out["a"], got, launches["hybrid_sharded (a)"] = _hybrid_decode(
        dev, mesh, "a", cfg, one, placed, sp1, sp2, B, S, steps, g)
    _merge_rows(rows, got)
    del one, placed
    torch.cuda.empty_cache()
    lap("a")
    layers, B, S, steps = HYBRID_B
    cfg, one, placed, sp1, sp2 = _hybrid_params(layers, dev, mesh)
    out["b"], got, launches["hybrid_sharded (b)"] = _hybrid_decode(
        dev, mesh, "b", cfg, one, placed, sp1, sp2, B, S, steps, g)
    _merge_rows(rows, got)
    del one, placed
    torch.cuda.empty_cache()
    lap("b")
    out["c"], got_rows, got_launches, out["c_methods_seconds"] = \
        _hybrid_fp32(dev, g)
    _merge_rows(rows, got_rows)
    launches.update(got_launches)
    lap("c")
    out["seconds_by_part"] = seconds
    out["seconds"] = time.perf_counter() - t_start
    out["kernel_rows"] = rows
    log(f"  seconds by part {json.dumps(seconds)}")
    print(json.dumps({"hybrid_sharded": out}), flush=True)
    return rows, launches, (flash, flash_routes)


# ---------------------------------------------------------------------------
# phases 3 and 4: serving
# ---------------------------------------------------------------------------


def _requests(vocab: int):
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, vocab, size=n), MAX_NEW)
            for i, n in enumerate(PROMPT_LENS)]


def retrieval_config(dev, run: str, mode: str = "overlap",
                     validate: bool = False):
    """The retrieval service of run ``run`` (None for the runs without):
    every slot's FLARE trigger fires at tau 1.1, at most twice per request,
    4 context tokens apart; rag retrieves 4 docs of the card corpus, mac
    the paper's bank (MacConfig defaults: 1024-token segments, 64 bank
    slots, top 8)."""
    from repro_torch.core.methods.mac import MacConfig
    from repro_torch.retrieval import RetrievalConfig

    kind = ALL_RUNS[run].retrieval
    if kind is None:
        return None
    kw = dict(kind=kind, mode=mode, trigger="flare", tau=1.1,
              min_interval=4, max_retrievals=2, query_window=8,
              validate=validate)
    if kind == "rag":
        return RetrievalConfig(corpus=card_corpus(dev), k=RAG_K, **kw)
    return RetrievalConfig(mac=MacConfig(), **kw)


def run_config(r: Run, dtype: str):
    """The run's architecture config at ``dtype``, its depth cut to
    ``r.layers`` where that is set."""
    from repro_torch.configs import get_arch

    cfg = get_arch(r.arch).replace(dtype=dtype)
    return cfg.replace(n_layers=r.layers) if r.layers else cfg


def attention_layers(cfg) -> int:
    """Layers that run attention (and so the attention kernels) once per
    step: every layer of a transformer, the shared block's sites of the
    hybrid, none of xLSTM."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return 0 if cfg.xlstm_pattern else cfg.n_layers


def _engine(dev, run: str, dtype: str, **sc_kw):
    """The run's engine: seeded weights at its config, the serve phase's
    ``ServeConfig`` with ``sc_kw`` on top. Returns (engine, config)."""
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    r = ALL_RUNS[run]
    cfg = run_config(r, dtype)
    sc = ServeConfig(method=r.method, max_len=VIEW, n_slots=SLOTS,
                     kv_page_size=PAGE, page=PAGE, **sc_kw)
    eng = Engine(cfg, init_params(cfg, 0, device=dev), sc, seed=1,
                 device=dev, mem=cfg.memory.replace(method=r.method, **r.mem))
    return eng, cfg


def _check_served(run: str, eng, cfg, tokens):
    """Every request's ``MAX_NEW`` tokens (``tokens``: rid -> tokens) lie in
    the vocab, the last logits are finite, and a run with kernels on its
    path took a sparse decode step."""
    import torch

    for rid, toks in tokens.items():
        if len(toks) != MAX_NEW:
            raise AssertionError(f"{run}: request {rid} incomplete: {toks}")
        if not all(0 <= int(t) < cfg.vocab_size for t in toks):
            raise AssertionError(f"{run}: request {rid}: token out of vocab")
    # the padded vocab's columns are -inf by design (lm_head's mask)
    if eng.last_logits is not None and not torch.isfinite(
            eng.last_logits[:, :cfg.vocab_size]).all():
        raise AssertionError(f"{run}: non-finite logits")
    if ALL_RUNS[run].kernels and eng.stats["sparse_steps"] == 0:
        raise AssertionError(f"{run}: no decode step crossed min_context")


def serve_generate(dtype: str, dev, run: str, profile_polls: int = 0):
    """A ``generate`` run (the hybrid and ssm families: the batched
    dense-cache loop): ``Engine.generate`` on its batch of seeded prompts,
    ``MAX_NEW`` new tokens each. With ``profile_polls`` > 0, a fresh prefill
    and that many decode steps (after one untraced) under torch.profiler
    instead (``_Profile``)."""
    import numpy as np
    import torch

    eng, cfg = _engine(dev, run, dtype)
    n, S = ALL_RUNS[run].generate
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (n, S))
    if profile_polls:
        logits, caches = eng._prefill(torch.as_tensor(prompts, device=dev))
        logits, caches = eng._decode(logits.argmax(-1), caches)
        prof = _Profile(profile_polls, run)
        for _ in range(profile_polls):
            logits, caches = eng._decode(logits.argmax(-1), caches)
            prof.tick()
        return SimpleNamespace(profile=prof.result)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = eng.generate(prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if gen.shape != (n, MAX_NEW):
        raise AssertionError(f"{run}: generated {gen.shape}")
    _check_served(run, eng, cfg, dict(enumerate(gen)))
    return SimpleNamespace(gen=gen, wall=wall, eng=eng, cfg=cfg, events=[],
                           prompt_lens=[S] * n, profile=None)


def serve(dtype: str, dev, run: str, record: bool = False,
          profile_polls: int = 0, mode: str = "overlap",
          validate: bool = False):
    """Serve the requests as ``RUNS[run]`` says: the long ones first; the
    short ones join in the poll of the long ones' last prefill chunk, so
    all four share the sparse steps, and the step at which they join is
    the same whatever the run's decode steps per dispatch. Returns the
    engine, handles, wall seconds and (with ``record``) the logits row that
    produced each of a request's tokens after the first, plus the first
    sparse step's logits. ``profile_polls`` > 0 traces that many polls of
    steady sparse decode with ``torch.profiler`` (``profile``: see
    ``_Profile``); a fused run first serves the requests once untraced, so
    its graphs are captured before the traced pass. The retrieval runs
    serve with their service in ``mode``."""
    from repro_torch.serving import OffloadConfig

    r = ALL_RUNS[run]
    eng, cfg = _engine(dev, run, dtype, paged=r.paged,
                       retrieval=retrieval_config(dev, run, mode, validate),
                       fused_steps=r.fused,
                       offload_cfg=OffloadConfig(mode=r.offload,
                                                 validate=r.validate,
                                                 shards=r.shards,
                                                 main_mesh=r.mesh))
    reqs = _requests(cfg.vocab_size)
    if profile_polls and r.fused > 1:
        _drive(eng, reqs, run)                  # captures the graphs
    n_ev0 = 0 if eng.retrieval is None else len(eng.retrieval.events)
    res = _drive(eng, reqs, run, record=record, profile_polls=profile_polls)
    if not all(h.done for h in res.handles):
        raise AssertionError(f"{run}: a request did not finish")
    _check_served(run, eng, cfg, {h.rid: h.tokens for h in res.handles})
    if r.fused > 1 and eng.stats["graph_captures"] == 0:
        raise AssertionError(f"{run}: no CUDA graph was captured")
    if eng.sc.max_len != VIEW:
        raise AssertionError(f"{run}: max_len {eng.sc.max_len} != {VIEW}")
    if profile_polls and res.profile is None:
        raise AssertionError("the profiled polls did not complete")
    res.events = []
    if eng.retrieval is not None:
        res.events = [(e["slot"], tuple(e["ids"]), e["spliced"])
                      for e in eng.retrieval.events[n_ev0:]]
        _check_retrievals(run, res.events, res.slot_of)
    res.eng, res.cfg = eng, cfg
    res.prompt_lens = list(PROMPT_LENS)
    return res


# the poll of the long prompts' last prefill chunk (ServeConfig's
# prefill_chunk of 128 tokens a poll): the short prompts join then. The
# legacy pool prefills a whole prompt at its admission, in poll 0, and the
# long ones finish their 16 tokens before poll 35: there all four join at
# once, so that they share the sparse steps there too
LATE_POLL = -(-max(PROMPT_LENS) // 128) - 1


def _drive(eng, reqs, run: str, record: bool = False,
           profile_polls: int = 0):
    """One pass of the requests through ``eng`` (see ``serve``)."""
    import torch

    rows, first_sparse, slot_of = {r.rid: [] for r in reqs}, None, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    late_poll = LATE_POLL if eng.sc.paged else 0
    handles = [eng.submit(r) for r in reqs[:2]]
    late = reqs[2:]
    polls, prof, sparse0 = 0, None, eng.stats["sparse_steps"]
    while eng.busy() or late:
        if late and polls >= late_poll:
            handles += [eng.submit(r) for r in late]
            late = []
        if (profile_polls and prof is None
                and eng.stats["sparse_steps"] > sparse0 and not late and not eng.queue_depth()
                and not eng.has_prefill_work()):
            prof = _Profile(profile_polls, run)   # steady, 4 slots
        ev = eng.poll()
        for rid, slot, _tok in ev.emissions:
            slot_of[rid] = slot
        if prof is not None and prof.result is None:
            prof.tick()
        polls += 1
        if polls > 1000:
            raise RuntimeError("serving did not finish in 1000 polls")
        if record and ev.steps:
            for rid, slot, _tok in ev.emissions:
                rows[rid].append(eng.last_logits[slot])
            if eng.last_sparse and first_sparse is None:
                first_sparse = eng.last_logits.clone()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None and prof.result is None:
        prof.finish()          # a fused run may end inside the profile
    return SimpleNamespace(handles=handles, wall=wall, rows=rows,
                           first_sparse=first_sparse, slot_of=slot_of,
                           profile=prof and prof.result)


def _check_retrievals(run: str, events, slot_of):
    """dsa-rag: every request retrieved (twice at most); dsa-mac: the two
    long requests retrieved from their banks, the short ones never (their
    prompts fill no 1024-token segment: the bank gate holds)."""
    per_slot = {}
    for slot, _ids, spliced in events:
        per_slot[slot] = per_slot.get(slot, 0) + 1
        if spliced <= 0:
            raise AssertionError(f"{run}: an empty splice in slot {slot}")
    long_ = {slot_of[r] for r, n in enumerate(PROMPT_LENS) if n > 1024}
    want = set(slot_of.values()) if ALL_RUNS[run].retrieval == "rag" \
        else long_
    if set(per_slot) != want or max(per_slot.values()) > 2:
        raise AssertionError(f"{run}: retrievals per slot {per_slot}, "
                             f"expected 1-2 for the slots {sorted(want)}")


# the CUDA symbol of each kernel, as the profiler names it
KERNEL_SYMBOLS = {"relevancy_topk_candidates": "relevancy_topk_kernel",
                  "paged_decode_attention": "paged_decode_kernel",
                  # both routes: page_minmax_bulk<T>, page_minmax_scalar<T>
                  "page_minmax": "page_minmax_",
                  "bm25_topk_candidates": "bm25_topk_kernel",
                  # both routes: flash_attention_kernel<T, DH>,
                  # flash_attention_sm90_kernel<DH>
                  "flash_attention": "flash_attention_"}
# a kernel a call launches after its first, counted in its in-situ time
FOLLOWERS = {"paged_decode_attention": "paged_decode_combine_kernel"}


class _Profile:
    """torch.profiler over the next ``n`` polls of serve run ``run`` (fewer
    when a fused run ends first: ``finish``). On the last one, sets
    ``result`` (wall and device-busy time, the busy share, the mean in-situ
    device time of each kernel of the run's path; a kernel replayed inside
    a CUDA graph that the trace does not show is None) and writes the
    per-op table (device time first) and a gzipped chrome trace to
    chiprun_out/profile_decode_<run>.{txt,json.gz}."""

    def __init__(self, n: int, run: str):
        import torch

        self.n, self.polls, self.result = n, n, None
        self.run = run
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def tick(self):
        self.n -= 1
        if not self.n:
            self.finish()

    def finish(self):
        import torch

        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        self.prof.stop()
        avgs = self.prof.key_averages()
        cpu = torch.autograd.DeviceType.CPU
        dev_us = sum(e.self_device_time_total for e in self.prof.events()
                     if e.device_type != cpu)
        out = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        stem = os.path.join(out, f"profile_decode_{self.run}")
        with open(stem + ".txt", "w") as f:
            f.write(f"card: {card_line()}\nwall {wall_us:.0f} us, device "
                    f"busy {dev_us:.0f} us ({100 * dev_us / wall_us:.1f}%)\n")
            f.write(avgs.table(sort_by="self_device_time_total",
                               row_limit=40))
        # the chrome trace, gzipped (each run's is tens of MB as JSON)
        self.prof.export_chrome_trace(stem + ".json.gz")
        in_situ = {}
        for name in ALL_RUNS[self.run].kernels:
            sym = KERNEL_SYMBOLS[name]
            hits = [e for e in avgs if sym in e.key]
            if not hits and ALL_RUNS[self.run].fused > 1:
                in_situ[name] = None
                continue
            if not hits:
                raise AssertionError(f"profile: no {sym} in the decode polls")
            n = sum(e.count for e in hits)   # one per call
            if name in FOLLOWERS:
                hits += [e for e in avgs if FOLLOWERS[name] in e.key]
            in_situ[name] = sum(e.self_device_time_total for e in hits) \
                / n / 1e3
        self.result = {"polls": self.polls - self.n, "wall_us": wall_us,
                       "device_busy_us": dev_us,
                       "device_busy_share": dev_us / wall_us,
                       "kernel_ms_in_situ": in_situ}
        log(f"  profiled {self.run}: wall {wall_us:.0f} us, device busy "
            f"{dev_us:.0f} us")


def _fused_offload_summary(eng):
    """A run's host dispatches, graphs and, under the offload, the hetero
    executor's lookahead, step split and (sync) phase seconds."""
    st = eng.stats
    steady = st["decode_s"] - st["graph_capture_s"]
    d = {"host_dispatches": st["host_steps"],
         "steps_per_dispatch": st["decode_steps"] / max(st["host_steps"], 1),
         "device_steps": st["device_steps"],
         "sparse_device_steps": st["sparse_device_steps"],
         "graph_captures": st["graph_captures"],
         "graph_capture_s": st["graph_capture_s"],
         "decode_s": st["decode_s"],
         "window_ms": [1e3 * w for w in st["window_s"]],
         "decode_ms_per_step_steady": 1e3 * steady / max(
             st["decode_steps"], 1),
         "decode_tok_per_s_steady": st["tokens"] / steady
         if steady > 0 else None}
    if eng.hetero is not None:
        rep = eng.hetero.report()
        d["hetero"] = {k: rep[k] for k in (
            "mode", "lookahead", "offload_steps", "local_fallback_steps",
            "fused", "apply_s", "devices", "transfer")}
        for k in ("select_s", "shards"):   # shards: each shard's ledger
            if k in rep:
                d["hetero"][k] = rep[k]
        if eng.hetero.main_mesh is not None:
            d["hetero"]["granule"] = eng._gran
    return d


def phase_serve(dev, label: str):
    """The run's path (launch counts reset just before it and read just
    after), then the same requests again with four profiled decode polls
    (host dispatches under fused decode; decode steps for a generate
    run)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    r = ALL_RUNS[label]
    drive = serve_generate if r.generate else serve
    ops.reset_launch_counts()
    run = drive("bfloat16", dev, label)
    counts = ops.launch_counts()
    routes = ops.flash_route_counts()
    eng, wall, cfg = run.eng, run.wall, run.cfg
    stats = eng.stats
    n_attn = attention_layers(cfg)
    prefills = stats["bucket_prefills"] + stats["dense_prefills"]
    # per sparse step the device computed: a fused window's masked steps
    # and its graph's warm-up launch too (the replays' launches are counted)
    want = n_attn * stats["sparse_device_steps"]
    if r.mesh > 1:
        # the mesh's seam takes the dense branch's attention too (all
        # pages of the view through paged attention)
        want = n_attn * stats["device_steps"]
    queries = len(run.events)      # every launched query was collected
    # flash: once per attention layer per prefill (bucketed, or unpaged)
    expect = {name: want if name in r.kernels else 0 for name in counts}
    expect["flash_attention"] = n_attn * prefills
    if "bm25_topk_candidates" in r.kernels:
        expect["bm25_topk_candidates"] = queries
    log(f"  launches {counts}, sparse steps {stats['sparse_steps']} of "
        f"{stats['decode_steps']} ({stats['sparse_device_steps']} "
        f"computed), prefills {stats['bucket_prefills']} bucketed, "
        f"{stats['dense_prefills']} unpaged; expected {expect}")
    if set(counts) != set(KERNEL_SYMBOLS):
        raise AssertionError(f"counted kernels {sorted(counts)}")
    if not prefills or (r.paged and not r.generate
                        and not stats["bucket_prefills"]):
        raise AssertionError(f"{label}: no bucketed or unpaged prefill ran")
    for name, n in counts.items():
        if n != expect[name]:
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"expected {expect[name]}")
    route = fa._route(torch.bfloat16, cfg.hd)
    want_routes = {rt: counts["flash_attention"] if rt == route else 0
                   for rt in (fa.TENSOR_CORES, fa.CUDA_CORES)}
    if routes != want_routes:
        raise AssertionError(f"{label}: bf16 flash routes {routes}, "
                             f"expected {want_routes}")
    fo = _fused_offload_summary(eng)
    if r.generate:
        gen = run.gen
        toks = int(gen.size)
        tokens = {str(i): [int(t) for t in row] for i, row in enumerate(gen)}
        # every row's first token comes out of the one batched prefill
        ttft = {k: stats["prefill_s"] for k in tokens}
        out = {"tokens": [list(v) for v in tokens.values()], "events": []}
    else:
        handles = run.handles
        toks = sum(len(h.tokens) for h in handles)
        tokens = {str(h.rid): [int(t) for t in h.tokens] for h in handles}
        ttft = {str(h.rid): h.ttft_s() for h in handles}
        out = {"tokens": [list(h.tokens) for h in handles],
               "events": run.events}
    retrieval = None if eng.retrieval is None else dict(
        eng.retrieval.report(), events=[
            {"slot": sl, "ids": [int(i) for i in ids], "spliced": n}
            for sl, ids, n in run.events])
    prompt_lens = run.prompt_lens
    del run, eng
    profile = drive("bfloat16", dev, label, profile_polls=4).profile
    summary = {
        "run": label, "method": r.method, **r.mem,
        "card": card_line(), "arch": r.arch,
        "width": "full", "family": cfg.family,
        "layers": cfg.n_layers, "attention_layers": n_attn,
        "pool": "generate (batched dense-cache loop)" if r.generate
        else "paged" if r.paged else "legacy dense (watermark)",
        "kernels_on_path": list(r.kernels),
        "dtype": "bfloat16", "requests": len(tokens),
        "prompt_lens": prompt_lens, "max_new": MAX_NEW,
        "tokens": toks, "wall_s": wall, "tok_per_s": toks / wall,
        # the wall without the graph captures (a server captures a window
        # once and replays it for every later request)
        "tok_per_s_steady": toks / (wall - fo["graph_capture_s"]),
        "greedy_tokens": tokens, "ttft_s": ttft,
        "ttft_p50_s": statistics.median(ttft.values()),
        "decode_steps": stats["decode_steps"],
        "sparse_steps": stats["sparse_steps"],
        "decode_step_ms_median": 1e3 * statistics.median(stats["step_s"]),
        "prefill_s": stats["prefill_s"],
        "bucket_prefills": stats["bucket_prefills"],
        "dense_prefills": stats["dense_prefills"], "launches": counts,
        "flash_launches_by_route": routes,
        "profiled_decode": profile,
        "fused_steps": r.fused, "offload": r.offload,
        "offload_shards": r.shards, "main_mesh": r.mesh,
        **fo,
    }
    if retrieval is not None:
        summary["retrieval"] = retrieval
    print(json.dumps({"serve": summary}), flush=True)
    return counts, profile, routes, out


def check_equal_runs(runs):
    """Each run with ``equals`` set against that run: equal greedy tokens
    and retrieval events (a fused run against its stepped run, overlap
    against sync, the validate run against overlap). One ``equal_runs``
    line."""
    pairs = {}
    for label, r in ALL_RUNS.items():
        if r.equals is None or label not in runs or r.equals not in runs:
            continue
        got, want = runs[label][3], runs[r.equals][3]
        if got["tokens"] != want["tokens"] or \
                got["events"] != want["events"]:
            raise AssertionError(f"{label} differs from {r.equals}: "
                                 f"{got} vs {want}")
        pairs[label] = r.equals
        log(f"  {label} == {r.equals}: tokens and "
            f"{len(got['events'])} retrieval events equal")
    print(json.dumps({"equal_runs": {"card": card_line(), "pairs": pairs}}),
          flush=True)


def phase_compare(dev, label: str):
    import torch
    from repro_torch.kernels import ops

    ops.use_kernels(True)
    k = serve("float32", dev, label, record=True)
    k_h, k_first, k_events = k.handles, k.first_sparse, k.events
    del k
    ops.use_kernels(False)
    try:
        p = serve("float32", dev, label, record=True)
    finally:
        ops.use_kernels(True)
    p_h, p_rows, p_first = p.handles, p.rows, p.first_sparse
    p_events = p.events
    del p
    if k_events != p_events:
        raise AssertionError(f"{label}: retrievals differ, kernels "
                             f"{k_events} vs plain {p_events}")
    if k_events:
        log(f"  {label}: {len(k_events)} retrievals, doc ids and splices "
            f"equal")
    err = float((k_first - p_first).abs().max())
    log(f"  {label} first sparse step logits: max abs diff {err:.3g} "
        f"(tol {LOGIT_TOL})")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"{label}: kernel vs plain logits differ by "
                             f"{err}")
    for a, b in zip(k_h, p_h):
        if a.tokens == b.tokens:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens))
                 if x != y)
        if i == 0:
            raise AssertionError(f"{label} request {a.rid}: first token "
                                 f"differs")
        top2 = torch.topk(p_rows[b.rid][i - 1].float(), 2).values
        margin = float(top2[0] - top2[1])
        log(f"  request {a.rid}: tokens differ at {i}, top-2 margin "
            f"{margin:.3g}")
        if margin > LOGIT_TOL:
            raise AssertionError(f"{label} request {a.rid}: greedy tokens "
                                 f"differ at {i} with margin {margin} > "
                                 f"{LOGIT_TOL}")
    log(f"  {label} greedy tokens: {[len(h.tokens) for h in k_h]} compared")
    return err


def phase_modes(dev, label: str = "dsa-rag"):
    """The retrieval run in its three modes (bf16): inline on the engine's
    stream, sync and overlap on the service's own stream, each of the two
    replaying every consumed query. Greedy tokens and retrieval events
    (slot, doc ids, spliced count) must be equal across the three."""
    res = {}
    for mode in ("inline", "sync", "overlap"):
        r = serve("bfloat16", dev, label, mode=mode,
                  validate=mode != "inline")
        res[mode] = ([list(h.tokens) for h in r.handles], r.events, r.wall,
                     r.eng.retrieval.report()["devices"])
        del r
    base = res["inline"]
    for mode, (toks, events, wall, devs) in res.items():
        if toks != base[0] or events != base[1]:
            raise AssertionError(f"{label}: {mode} differs from inline")
        log(f"  {label} {mode}: {len(events)} retrievals, wall {wall:.2f} s,"
            f" side stream {devs['side_stream']}")
    print(json.dumps({"modes": {
        "run": label, "card": card_line(), "equal": True,
        "retrievals": len(base[1]),
        "wall_s": {m: r[2] for m, r in res.items()},
        "greedy_tokens": base[0],
        "events": [{"slot": sl, "ids": [int(i) for i in ids], "spliced": n}
                   for sl, ids, n in base[1]]}}), flush=True)


def _profile_pipeline(pipe, memory, query):
    """One warm-up run, then one run under a StageProfiler: (output, the
    stage ms / total / shares)."""
    from repro_torch.core.pipeline import StageProfiler

    pipe.run(memory, query)
    prof = StageProfiler()
    out = pipe.run(memory, query, profiler=prof)
    sec = prof.stage_seconds[pipe.name]
    return out, {"stage_ms": {s: 1e3 * v for s, v in sec.items()},
                 "total_ms": 1e3 * sum(sec.values()),
                 "breakdown": prof.breakdown(pipe.name)}


def phase_pipeline_rag(dev):
    """RAG's four-stage pipeline over the card corpus (250,000 docs, 8-term
    queries, 4 queries, top 4), unfused (plain scores and a stable top-k)
    and fused (the BM25 kernel): equal retrieved doc tokens."""
    import torch
    from repro_torch.core.methods import rag
    from repro_torch.data import sample_queries

    corpus = card_corpus(dev)
    q = sample_queries(corpus, 4, 8, seed=3)
    outs, res = {}, {}
    for fused in (False, True):
        pipe = rag.build_pipeline(corpus, RAG_K, fused=fused)
        outs[fused], res[pipe.name] = _profile_pipeline(pipe, None, q)
    if not torch.equal(outs[True], outs[False]):
        raise AssertionError("pipeline rag: fused != unfused")
    log("  pipeline rag: fused and unfused doc tokens equal")
    print(json.dumps({"pipeline": {
        "method": "rag", "card": card_line(),
        "shape": f"{corpus.n_docs} docs x {RETRIEVAL_VOCAB} terms, queries "
                 f"[4, 8], top {RAG_K}",
        "fused_vs_unfused_equal": True, **res}}), flush=True)


def phase_pipeline_mac(dev):
    """MaC's pipeline at llama3.2-1b's width (d 2048), the paper's bank (64
    slots, 1024-token segments, top 8), 4 slots, bf16 segments: one run
    profiled, its output equal to ``segment_step``'s."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.methods import mac

    cfg = get_arch(SERVE_ARCH)
    mc = mac.MacConfig()
    g = torch.Generator(device=dev).manual_seed(6)
    d, S, M = cfg.d_model, mc.segment_len, mc.memory_slots
    mp = mac.mac_init(cfg, 4, device=dev)
    hidden = torch.randn(SLOTS, S, d, generator=g, device=dev).bfloat16()
    seg = torch.randn(SLOTS, S, d, generator=g, device=dev).bfloat16()
    bank = {"bank": torch.randn(SLOTS, M, d, generator=g, device=dev),
            "count": torch.tensor(48, dtype=torch.int32, device=dev)}
    out, res = _profile_pipeline(mac.build_pipeline(mp, mc), (hidden, bank),
                                 seg)
    want, _ = mac.segment_step(mp, bank, seg, mc)
    if out.shape != (SLOTS, mc.retrieve_k + S, d) or not torch.equal(out,
                                                                    want):
        raise AssertionError("pipeline mac: output != segment_step")
    log("  pipeline mac: output equals segment_step")
    print(json.dumps({"pipeline": {
        "method": "mac", "card": card_line(),
        "shape": f"segments [{SLOTS},{S},{d}] bf16, bank [{SLOTS},{M},{d}] "
                 f"fp32 (48 live), top {mc.retrieve_k}", "mac": res}}),
          flush=True)


def phase_pipeline(dev, method: str):
    """The method's four-stage pipeline, unfused and fused, on one layer's
    full-width tensors (4 slots, the 8192-token view, bf16): one warm-up
    run, then one run under a StageProfiler; the two outputs agree."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import methods
    from repro_torch.core.pipeline import StageProfiler

    cfg = get_arch(SERVE_ARCH)
    mem = cfg.memory.replace(method=method)
    g = torch.Generator(device=dev).manual_seed(5)
    KV, hd = cfg.n_kv_heads, cfg.hd
    kc = torch.randn(SLOTS, VIEW, KV, hd, generator=g, device=dev).bfloat16()
    vc = torch.randn(SLOTS, VIEW, KV, hd, generator=g, device=dev).bfloat16()
    q = torch.randn(SLOTS, 1, cfg.padded_heads(16), hd, generator=g,
                    device=dev).bfloat16()
    init, _ = methods.get_sparse_method(method)
    sp = init(cfg, mem, 3, stacked=False, device=dev)
    outs, res = {}, {}
    for fused in (False, True):
        pipe = methods.module(method).build_pipeline(
            cfg, mem, sp, fused=fused, **methods.sparse_kwargs(method, PAGE))
        pipe.run((kc, vc), q)
        prof = StageProfiler()
        outs[fused] = pipe.run((kc, vc), q, profiler=prof)
        sec = prof.stage_seconds[pipe.name]
        res[pipe.name] = {"stage_ms": {s: 1e3 * v for s, v in sec.items()},
                          "total_ms": 1e3 * sum(sec.values()),
                          "breakdown": prof.breakdown(pipe.name)}
    diff = float((outs[True] - outs[False]).abs().max())
    log(f"  pipeline {method}: fused vs unfused max abs diff {diff:.3g} "
        f"(tol {ATTN_TOL})")
    if not diff <= ATTN_TOL:
        raise AssertionError(f"pipeline {method}: fused != unfused ({diff})")
    print(json.dumps({"pipeline": {
        "method": method, "card": card_line(),
        "shape": f"k/v [{SLOTS},{VIEW},{KV},{hd}] bf16, q [{SLOTS},1,"
                 f"{cfg.padded_heads(16)},{hd}] bf16, one layer",
        "fused_vs_unfused_max_abs_diff": diff, **res}}), flush=True)


# ---------------------------------------------------------------------------
# phase 9: the fleet and multi-device serving on one card
# ---------------------------------------------------------------------------

# the fleet's traffic: the serve phase's 4 requests and 4 more; two
# sessions of 2 requests, 4 without one; rids 0, 3, 5, 6 opt into retrieval.
# Submitted at once, they route (least load, index breaking ties) to two
# long and two short prompts a replica
FLEET_LENS = PROMPT_LENS + (4300, 4200, 280, 320)
FLEET_SESSIONS = ("a", "b", None, None, "a", "b", None, None)
FLEET_RETRIEVAL = (True, False, False, True, False, True, True, False)


def _fleet_requests(vocab: int):
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, vocab, size=n), MAX_NEW, session=s,
                    retrieval=r)
            for i, (n, s, r) in enumerate(zip(FLEET_LENS, FLEET_SESSIONS,
                                              FLEET_RETRIEVAL))]


def _expect_launches(engs, n_attn: int, queries: int):
    """The launches a dsa path with rag retrieval makes: relevancy and
    paged attention once per layer per sparse step the device computed,
    flash once per layer per bucketed prefill, bm25 once per query."""
    sparse = sum(e.stats["sparse_device_steps"] for e in engs)
    return {"relevancy_topk_candidates": n_attn * sparse,
            "paged_decode_attention": n_attn * sparse,
            "page_minmax": 0, "bm25_topk_candidates": queries,
            "flash_attention": n_attn * sum(e.stats["bucket_prefills"]
                                            for e in engs)}


def fleet_router(dev):
    """``fleet-dsa-2``: ``Router.build`` of two dsa replicas on the card,
    dsa-rag's retrieval over the one shared corpus service, the fleet's
    8 requests (launch counts reset just before ``drain``, read after);
    then each replica's requests again through a fresh single ``Engine``
    on the same service, in the same submit order: equal tokens and
    retrieval events. One ``fleet`` line. Returns the path's counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, Router, ServeConfig

    r = RUNS["dsa-rag"]
    cfg = run_config(r, "bfloat16")
    mem = cfg.memory.replace(method="dsa")
    params = init_params(cfg, 0, device=dev)
    sc = ServeConfig(method="dsa", max_len=VIEW, n_slots=SLOTS,
                     kv_page_size=PAGE, page=PAGE,
                     retrieval=retrieval_config(dev, "dsa-rag"))
    mem0 = torch.cuda.memory_allocated(dev)
    router = Router.build(cfg, params, sc, n_replicas=2, seed=1, mem=mem,
                          device=dev)
    built = torch.cuda.memory_allocated(dev) - mem0
    svc = router.service
    engs = [rep.engine for rep in router.replicas]
    if svc is None or any(e.retrieval.service is not svc for e in engs):
        raise AssertionError("fleet: the replicas do not share one service")
    if any(e.params["lm_head"]["w"].data_ptr()
           != params["lm_head"]["w"].data_ptr() for e in engs):
        raise AssertionError("fleet: a replica copied the weights")
    store = sum(t.numel() * t.element_size() for t in svc.state.values()
                if isinstance(t, torch.Tensor))
    reqs = _fleet_requests(cfg.vocab_size)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [router.submit(q) for q in reqs]
    router.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_ev = [len(e.retrieval.events) for e in engs]
    want = _expect_launches(engs, attention_layers(cfg), sum(n_ev))
    log(f"  fleet launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"fleet: launches {counts} != {want}")
    if not all(h.done and len(h.tokens) == MAX_NEW for h in handles):
        raise AssertionError("fleet: a request did not finish")
    placed = {h.rid: h.replica for h in handles}
    if set(placed.values()) != {0, 1}:
        raise AssertionError(f"fleet: not both replicas served: {placed}")
    for sess in set(FLEET_SESSIONS) - {None}:
        if len({placed[i] for i, x in enumerate(FLEET_SESSIONS)
                if x == sess}) != 1:
            raise AssertionError(f"fleet: session {sess} split: {placed}")
    for e in engs:
        if e.last_logits is not None and not torch.isfinite(
                e.last_logits[:, :cfg.vocab_size]).all():
            raise AssertionError("fleet: non-finite logits")
    if not all(e.stats["sparse_steps"] for e in engs):
        raise AssertionError("fleet: a replica took no sparse step")
    if not all(n_ev):
        raise AssertionError(f"fleet: retrieval events per replica {n_ev}")
    tokens = {h.rid: [int(t) for t in h.tokens] for h in handles}
    per_replica = []
    for rep_, e in zip(router.replicas, engs):
        rids = [h.rid for h in handles if h.replica == rep_.index]
        events = [(ev["slot"], [int(i) for i in ev["ids"]])
                  for ev in e.retrieval.events]
        per_replica.append(dict(rep_.report(), rids=rids, events=events,
                                sparse_steps=e.stats["sparse_steps"],
                                decode_steps=e.stats["decode_steps"]))
    report = router.report()
    del router, engs, handles
    # the oracle: each replica's requests through one fresh engine
    for row in per_replica:
        lone = Engine(cfg, params, dataclasses.replace(
            sc, retrieval=dataclasses.replace(sc.retrieval, service=svc)),
            seed=1, mem=mem, device=dev)
        hs = [lone.submit(reqs[i]) for i in row["rids"]]
        lone.drain()
        got = {h.rid: [int(t) for t in h.tokens] for h in hs}
        ev = [(x["slot"], [int(i) for i in x["ids"]])
              for x in lone.retrieval.events]
        if got != {i: tokens[i] for i in row["rids"]} or ev != row["events"]:
            raise AssertionError(f"fleet: replica {row['replica']} differs "
                                 f"from its lone engine")
        row["equals_lone_engine"] = True
        del lone
    toks = sum(len(v) for v in tokens.values())
    print(json.dumps({"fleet": {
        "run": "fleet-dsa-2", "card": card_line(), "arch": SERVE_ARCH,
        "width": "full", "dtype": "bfloat16", "replicas": 2,
        "device_groups": [r_["devices"] for r_ in per_replica],
        "prompt_lens": list(FLEET_LENS), "sessions": list(FLEET_SESSIONS),
        "retrieval_opt_in": list(FLEET_RETRIEVAL), "placement": placed,
        "max_new": MAX_NEW, "tokens": toks, "wall_s": wall,
        "tok_per_s": toks / wall, "greedy_tokens": tokens,
        "launches": counts, "per_replica": per_replica,
        "router_report": report, "shared_service": {
            "one_object": True, "store_bytes": store,
            "built_bytes": built, "n_docs": svc.n_docs}}}), flush=True)
    return counts


def _sharded_selection(lengths, n_sel, g, dev):
    """DSA-shaped selections: distinct live pages with -1 holes, the page
    of the last live token always in (the engine's force-included page;
    no row is empty)."""
    import torch

    pages = _selected_pages(lengths, n_sel, PAGE, g, dev)
    pages[:, 1::5] = -1                            # holes
    cur = torch.tensor([(n - 1) // PAGE for n in lengths],
                       dtype=torch.int32, device=dev)
    pages = torch.where(pages == cur[:, None], -1, pages)
    pages[:, -1] = cur
    return pages


def fleet_direct(dev, kernels):
    """The sequence-parallel functions at DSA's full-width shape on
    ``(cuda:0,) * n``: ``distributed_paged_sparse_decode`` over 2 and 4
    shards against the single kernel and the plain version,
    ``distributed_relevancy_topk`` against ``ops.relevancy_topk`` (bit for
    bit), ``make_sparse_fn_cached`` against ``make_sparse_fn_distributed``
    for one layer; n launches of each kernel a call; the times of each call,
    of a shard's view copy, and of the kernels at the shard-local shapes
    (rows 1f / 2f beside their bounds and library times, appended to
    ``kernels``' rows when that phase ran). Returns the ``fleet_direct``
    line's dict."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.methods import dsa
    from repro_torch.distributed.topk import (distributed_paged_sparse_decode,
                                              distributed_relevancy_topk,
                                              gather_shards)
    from repro_torch.kernels import ops
    from repro_torch.kernels import sparse_decode_attention as sda

    card = torch.empty(0, device=dev).device       # indexed: cuda:0
    g = torch.Generator(device=dev).manual_seed(9)
    B, KV, G, dh = SLOTS, 8, 4, 64
    lengths = _main_path_lengths()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn(B, KV * G, dh, generator=g, device=dev).bfloat16()
    kc = torch.randn(B, VIEW, KV, dh, generator=g, device=dev).bfloat16()
    vc = torch.randn(B, VIEW, KV, dh, generator=g, device=dev).bfloat16()
    pages = _sharded_selection(lengths, 2048 // PAGE, g, dev)
    po, pl_ = sda.paged_decode_attention_plain(q, kc, vc, pages, lens,
                                               page_size=PAGE)
    ko, kl = ops.paged_decode_attention(q, kc, vc, pages, lens,
                                        page_size=PAGE)
    Hq, dk, S_idx = 64, 128, VIEW // PAGE          # DSA's index heads / dim
    qi = torch.randn(B, Hq, dk, generator=g, device=dev).bfloat16()
    keys = torch.randn(B, S_idx, dk, generator=g, device=dev).bfloat16()
    for b, n in enumerate(lengths):
        keys[b, -(-n // PAGE):] = 0                # pooled zeros past live
    w = torch.softmax(torch.randn(B, Hq, generator=g, device=dev), -1)
    rv, ri = ops.relevancy_topk(qi, keys, w, 2048 // PAGE)
    out = {"card": card_line(), "shape": f"q [{B},{KV * G},{dh}] bf16, "
           f"k/v [{B},{VIEW},{KV},{dh}] bf16, {2048 // PAGE} pages of "
           f"{PAGE} with -1 holes; relevancy q [{B},{Hq},{dk}], keys "
           f"[{B},{S_idx},{dk}] bf16, top {2048 // PAGE}",
           "tolerance": f"out abs {ATTN_TOL}, lse rel {ATTN_TOL}; top-k "
                        f"values and indices bit-equal", "shards": {}}
    for n in (2, 4):
        mesh = (card,) * n
        c0 = ops.launch_counts()
        do, dl = distributed_paged_sparse_decode(q, kc, vc, pages, lens,
                                                 mesh, page_size=PAGE)
        dv, di = distributed_relevancy_topk(qi, keys, w, 2048 // PAGE, mesh)
        c1 = ops.launch_counts()
        launched = tuple(c1[k] - c0[k] for k in _DSA[::-1])
        if launched != (n, n):
            raise AssertionError(f"{n} shards launched {launched}")
        errs = [_attn_check(f"distributed paged attention, {n} shards vs "
                            f"the kernel", do, dl, ko, kl),
                _attn_check(f"distributed paged attention, {n} shards vs "
                            f"plain", do, dl, po, pl_)]
        if not (torch.equal(dv, rv) and torch.equal(di, ri)):
            raise AssertionError(f"distributed relevancy, {n} shards: not "
                                 f"bit-equal to ops.relevancy_topk")
        local = VIEW // n
        copy_ms = time_ms(lambda: (kc[:, :local].contiguous(),
                                   vc[:, :local].contiguous()))
        out["shards"][n] = {
            "paged_max_abs_err": max(errs), "relevancy_equal": True,
            "launches_per_call": {"paged_decode_attention": n,
                                  "relevancy_topk_candidates": n},
            "paged_call_ms": time_ms(lambda: distributed_paged_sparse_decode(
                q, kc, vc, pages, lens, mesh, page_size=PAGE)),
            "relevancy_call_ms": time_ms(lambda: distributed_relevancy_topk(
                qi, keys, w, 2048 // PAGE, mesh)),
            "view_copy_ms": copy_ms,
            "view_copy_bytes": 2 * kc[:, :local].numel() * 2}
        log(f"  {n} shards: paged call {out['shards'][n]['paged_call_ms']:.4f}"
            f" ms, relevancy call {out['shards'][n]['relevancy_call_ms']:.4f}"
            f" ms, one shard's view copy {copy_ms:.4f} ms")
    out["single_kernel_ms"] = {
        "paged_decode_attention": time_ms(lambda: ops.paged_decode_attention(
            q, kc, vc, pages, lens, page_size=PAGE)),
        "relevancy_topk": time_ms(lambda: ops.relevancy_topk(
            qi, keys, w, 2048 // PAGE))}

    # rows 1f / 2f: the kernels at shard 0's local shapes
    rows_rel, rows_paged = [], []
    for n in (2, 4):
        local, lp = VIEW // n, VIEW // n // PAGE
        kl_, vl_ = kc[:, :local].contiguous(), vc[:, :local].contiguous()
        loc = torch.where((pages >= 0) & (pages < lp), pages,
                          torch.full_like(pages, -1))
        ll = lens.clamp(max=local)
        if not (loc >= 0).any(1).all():
            raise AssertionError("a shard-local row selects nothing")
        rows_paged.append(dict(
            _paged_timing(q, kl_, vl_, loc, ll, PAGE),
            path=f"fleet: shard 0 of {n}",
            shape=f"q [{B},{KV * G},{dh}] bf16, k/v [{B},{local},{KV},{dh}]"
                  f" bf16, the selection's pages in [0, {lp})"))
        keys_l = keys[:, :S_idx // n].contiguous()
        blk = max(min(4096, S_idx // n), 2)
        rows_rel.append(dict(
            _relevancy_timing(qi, keys_l, w, blk),
            path=f"fleet: shard 0 of {n}", library_ms=None,
            shape=f"q [{B},{Hq},{dk}] bf16, keys [{B},{S_idx // n},{dk}] "
                  f"bf16, block {blk}"))
        del kl_, vl_
    out["rows"] = {"relevancy_topk_candidates": rows_rel,
                   "paged_decode_attention": rows_paged}
    for k in kernels:
        k.setdefault("other_shapes", []).extend(out["rows"].get(k["name"],
                                                                []))

    # DSA's stateful (cached) against its stateless sequence-parallel path,
    # one layer at full width, fp32 (the reference's test)
    cfg = get_arch(SERVE_ARCH)
    mem = cfg.memory.replace(method="dsa")
    sp = dsa.dsa_init(cfg, mem, 1, stacked=False, device=dev)
    kc32 = torch.randn(B, VIEW, KV, dh, generator=g, device=dev)
    vc32 = torch.randn(B, VIEW, KV, dh, generator=g, device=dev)
    q32 = torch.randn(B, 1, cfg.padded_heads(16), dh, generator=g,
                      device=dev)
    mesh = (card, card)
    stateless = dsa.make_sparse_fn_distributed(cfg, mem, mesh, tp=16,
                                               page=PAGE)
    out_d = stateless(q32, kc32, vc32, VIEW, sp)
    k_idx = dsa._matmul_promoted(kc32.reshape(B, VIEW, -1),
                                 sp["wk_idx"]).float()
    k_idx[:, VIEW - 1] = 0.0
    cache = k_idx.reshape(B, VIEW // PAGE, PAGE, -1).sum(2)
    cached = dsa.make_sparse_fn_cached(cfg, mem, mesh, tp=16, page=PAGE)
    out_c, sp_new = cached(q32, kc32, vc32, VIEW, {"p": sp,
                                                   "kidx_sum": cache},
                           k_new=kc32[:, VIEW - 1][:, None])
    err = float((out_c - out_d).abs().max())
    full = dsa._matmul_promoted(kc32.reshape(B, VIEW, -1),
                                sp["wk_idx"]).float()
    full = full.reshape(B, VIEW // PAGE, PAGE, -1).sum(2)
    upd = float((gather_shards(sp_new["kidx_sum"]) - full).abs().max())
    log(f"  cached vs stateless DSA (2 shards, fp32): out max abs err "
        f"{err:.3g}, index cache err {upd:.3g}")
    if err > ATTN_TOL or upd > 1e-3:
        raise AssertionError(f"cached DSA: out err {err}, cache err {upd}")
    out["cached_vs_stateless"] = {"out_max_abs_err": err,
                                  "cache_max_abs_err": upd,
                                  "tolerance": f"out {ATTN_TOL}, cache 1e-3",
                                  "dtype": "float32", "shards": 2}
    print(json.dumps({"fleet_direct": out}), flush=True)
    return out


def phase_fleet(dev, runs, kernels):
    """Phase 9: the new offload runs (``FLEET_RUNS``, each with the run it
    must equal when the serve phase did not run it), the fleet's router
    (``fleet_router``) and the direct checks (``fleet_direct``). Adds the
    runs to ``runs``."""
    for label, r in FLEET_RUNS.items():
        if r.equals not in runs:
            log(f"[9] {r.equals} (the run {label} must equal)")
            runs[r.equals] = phase_serve(dev, r.equals)
        log(f"[9] {label}")
        runs[label] = phase_serve(dev, label)
    log("[9] fleet-dsa-2: a router over 2 dsa replicas, one shared corpus")
    counts = fleet_router(dev)
    runs["fleet-dsa-2"] = (counts, {"kernel_ms_in_situ": {}}, {}, None)
    log("[9] the sequence-parallel functions at DSA's shape")
    fleet_direct(dev, kernels)


# ---------------------------------------------------------------------------
# phase 10: the paper's last two memory methods, MemAgent and TTT
# ---------------------------------------------------------------------------

MEMAGENT_B = 2
MEMAGENT_SEGMENTS = 2     # the fewest that carry a memory to the next segment
# llama3.2-1b's depth cut to 6 of 16 layers for the script's time: the
# segments' 2 x 1024 decode steps are host-bound, about 40 ms a step at 16
MEMAGENT_LAYERS = 6
MEMAGENT_Q = 64
TTT_B, TTT_S, TTT_CHUNK = 4, 8192, 256


def _memagent_inputs(cfg, ma, dev):
    """A seeded document of MEMAGENT_SEGMENTS segments and a question."""
    import torch

    g = torch.Generator(device=dev).manual_seed(11)
    draw = lambda n: torch.randint(0, cfg.vocab_size, (MEMAGENT_B, n),
                                   generator=g, device=dev,
                                   dtype=torch.int32)
    return draw(MEMAGENT_SEGMENTS * ma.segment_len), draw(MEMAGENT_Q)


def phase_memagent(dev):
    """MemAgent at full width (llama3.2-1b bf16 cut to MEMAGENT_LAYERS
    layers, seeded weights) with the
    paper's Appendix D config (segments of 5000, a 1024-token memory, 32
    answer tokens), B 2, a 2-segment document and a 64-token question:
    ``run_memagent`` with the model's ``prefill`` / ``decode_step`` placed
    through ``split_mesh_roles`` (one card takes both roles). Each prefill
    is closed by a synchronize on both sides, which splits every segment
    into its prefill and its 1024 decode steps (the paper's Fig. 12).
    MEMAGENT_LAYERS x 3 prefills flash launches, all on the tensor cores, and
    no other kernel; then segment 1's prefill logits at fp32 through the
    kernel against the plain path; then MemAgent's ``build_pipeline``
    through ``run`` under a StageProfiler, apply handed the raw memory.
    Returns the main run's flash launches in the segments' prefills and in
    the answer's."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.methods import memagent
    from repro_torch.core.pipeline import StageProfiler
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import mesh_from_devices, split_mesh_roles
    from repro_torch.models import init_params, model as M

    cfg = get_arch(SERVE_ARCH).replace(n_layers=MEMAGENT_LAYERS)
    ma = memagent.MemAgentConfig()
    # one card takes both roles: the mesh names it twice
    pre, dec = split_mesh_roles(mesh_from_devices([dev] * 2))
    params = init_params(cfg, 0, device=dev)
    p, prefill_fn, decode_fn = memagent.role_fns(params, cfg, pre[0], dec[0])
    doc, question = _memagent_inputs(cfg, ma, dev)
    # warm-up at the answer's shape: one prefill, one decode step
    ctx = torch.cat([doc[:, :ma.mem_len], question], 1)
    _, c = prefill_fn(p, ctx, ctx.shape[1] + 1)
    decode_fn(p, question[:, 0], c)
    del c

    marks, shapes = [], []

    def timed_prefill(params_, tokens, max_len):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        n0 = ops.flash_route_counts()[fa.TENSOR_CORES]
        out = prefill_fn(params_, tokens, max_len)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        shapes.append((tuple(tokens.shape),
                       ops.flash_route_counts()[fa.TENSOR_CORES] - n0))
        return out

    prof = StageProfiler()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    answer = memagent.run_memagent(p, cfg, doc, question, ma,
                                   prefill_fn=timed_prefill,
                                   decode_fn=decode_fn, profiler=prof)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts, routes = ops.launch_counts(), ops.flash_route_counts()
    n_pre = MEMAGENT_SEGMENTS + 1
    want_routes = {fa.TENSOR_CORES: cfg.n_layers * n_pre, fa.CUDA_CORES: 0}
    others = {k: v for k, v in counts.items() if k != "flash_attention" and v}
    if routes != want_routes or counts["flash_attention"] != sum(
            want_routes.values()) or others:
        raise AssertionError(f"memagent: flash routes {routes} (want "
                             f"{want_routes}), other kernels {others}")
    if answer.shape != (MEMAGENT_B, ma.max_answer) or \
            answer.dtype != torch.int32 or not bool(
                ((answer >= 0) & (answer < cfg.vocab_size)).all()):
        raise AssertionError(f"memagent: answer {answer.dtype} "
                             f"{tuple(answer.shape)} out of the vocab")
    stage_s = prof.stage_seconds["memagent"]
    if not (stage_s["prepare"] > 0 and stage_s["apply"] > 0):
        raise AssertionError(f"memagent: profiler stages {stage_s}")
    ms = lambda a, b: 1e3 * (b - a)
    segs = []
    for i in range(MEMAGENT_SEGMENTS):
        pf, dc = ms(marks[2 * i], marks[2 * i + 1]), ms(marks[2 * i + 1],
                                                        marks[2 * i + 2])
        segs.append({"prefill_ms": pf, "decode_ms": dc,
                     "decode_steps": ma.mem_len,
                     "decode_ms_per_step": dc / ma.mem_len,
                     "decode_share": dc / (pf + dc)})
    ans = {"prefill_ms": ms(marks[-2], marks[-1]),
           "decode_ms": ms(marks[-1], t_end),
           "decode_steps": ma.max_answer - 1}
    log(f"  memagent: segments {[round(s['prefill_ms'], 1) for s in segs]} "
        f"ms prefill, {[round(s['decode_ms'], 1) for s in segs]} ms decode; "
        f"answer {ans['prefill_ms']:.1f} + {ans['decode_ms']:.1f} ms")

    # kernel vs plain: segment 1's prefill at fp32 (the CUDA-core route)
    cfg32 = cfg.replace(dtype="float32")
    p32 = init_params(cfg32, 0, device=dev)
    ctx = torch.cat([torch.zeros(MEMAGENT_B, ma.mem_len, dtype=torch.int32,
                                 device=dev), doc[:, :ma.segment_len]], 1)
    got, _ = M.prefill(p32, cfg32, ctx)
    ops.use_kernels(False)
    try:
        want, _ = M.prefill(p32, cfg32, ctx)
    finally:
        ops.use_kernels(True)
    logit_err = float((got - want).abs().max())
    log(f"  memagent segment-1 prefill logits fp32, kernel vs plain: max abs "
        f"err {logit_err:.3g} (tol {LOGIT_TOL})")
    if not (logit_err <= LOGIT_TOL and bool(torch.isfinite(got).all())):
        raise AssertionError(f"memagent prefill logits: err {logit_err}")
    del p32, got, want
    torch.cuda.empty_cache()
    profile = _profile_memagent_decode(p, prefill_fn, decode_fn, ctx)

    print(json.dumps({"memagent": {
        "card": card_line(), "arch": SERVE_ARCH, "dtype": "bfloat16",
        "layers": MEMAGENT_LAYERS,
        "config": dataclasses.asdict(ma), "batch": MEMAGENT_B,
        "segments": MEMAGENT_SEGMENTS, "question_len": MEMAGENT_Q,
        "roles": {"prefill": [str(d) for d in pre],
                  "decode": [str(d) for d in dec]},
        "segment": segs, "answer": ans, "total_s": t_end - t0,
        "stage_ms": {s: 1e3 * v for s, v in stage_s.items()},
        "flash_launches_by_route": routes,
        "flash_launches_by_prefill": [
            {"tokens": list(sh), "launches": n} for sh, n in shapes],
        "answer_shape": list(answer.shape),
        "answer_range": [int(answer.min()), int(answer.max())],
        "prefill_logits_fp32_kernel_vs_plain_max_abs_err": logit_err,
        "logit_tol": LOGIT_TOL, "decode_profile": profile}}), flush=True)
    phase_pipeline_memagent(dev, cfg, ma, p, prefill_fn, decode_fn, doc,
                            question)
    return {"segment": sum(n for _, n in shapes[:-1]),
            "answer": shapes[-1][1]}


def _profile_memagent_decode(p, prefill_fn, decode_fn, ctx, steps=4):
    """torch.profiler over ``steps`` decode steps after a prefill of ``ctx``
    (segment 1's context): wall, device busy time and share a step, the
    five ops with the most device time; the per-op table goes to
    chiprun_out/profile_decode_memagent.txt."""
    import torch

    logits, caches = prefill_fn(p, ctx, ctx.shape[1] + steps + 1)
    tok = torch.argmax(logits, -1).to(torch.int32)
    logits, caches = decode_fn(p, tok, caches)          # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, caches = decode_fn(p, tok, caches)
            tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cpu = torch.autograd.DeviceType.CPU
    dev_us = sum(e.self_device_time_total for e in prof.events()
                 if e.device_type != cpu)
    avgs = prof.key_averages()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "profile_decode_memagent.txt"), "w") as f:
        f.write(f"card: {card_line()}\nwall {wall_us:.0f} us, device busy "
                f"{dev_us:.0f} us ({100 * dev_us / wall_us:.1f}%) over "
                f"{steps} decode steps\n")
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=30))
    top = sorted(avgs, key=lambda e: -e.self_device_time_total)[:5]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": dev_us / steps / 1e3,
            "device_busy_share": dev_us / wall_us,
            "top_device_ops_ms_per_step": {
                e.key[:80]: e.self_device_time_total / steps / 1e3
                for e in top}}


PIPELINE_MEM_LEN = 128      # the memagent pipeline's synthesized memory


def phase_pipeline_memagent(dev, cfg, ma, p, prefill_fn, decode_fn, doc,
                            question):
    """MemAgent's ``build_pipeline`` through ``run`` under a StageProfiler
    at full width: M = (the zero first memory of 1024 tokens, segment 1),
    x = the question; prepare synthesizes a memory (PIPELINE_MEM_LEN decode
    steps: the main run times the 1024-step ones), relevancy is bypassed,
    and, as in the reference, apply prefills [M's raw memory; x], not the
    synthesized memory."""
    import torch
    from repro_torch.core.methods import memagent
    from repro_torch.core.pipeline import StageProfiler

    ma = dataclasses.replace(ma, mem_len=PIPELINE_MEM_LEN)

    def synthesize(M):
        memory, segment = M
        ctx = torch.cat([memory, segment], 1)
        logits, caches = prefill_fn(p, ctx, ctx.shape[1] + ma.mem_len)
        out = []
        for _ in range(ma.mem_len):
            out.append(torch.argmax(logits, -1).to(torch.int32))
            logits, caches = decode_fn(p, out[-1], caches)
        return torch.stack(out, 1)

    seen = []

    def answer_prefill(Mp, x):
        seen.append(Mp[0])
        ctx = torch.cat([Mp[0], x], 1)
        return prefill_fn(p, ctx, ctx.shape[1] + ma.max_answer)[0]

    memory0 = torch.zeros(MEMAGENT_B, memagent.MemAgentConfig().mem_len,
                          dtype=torch.int32, device=dev)
    pipe = memagent.build_pipeline(synthesize, answer_prefill)
    prof = StageProfiler()
    out = pipe.run((memory0, doc[:, :ma.segment_len]), question,
                   profiler=prof)
    if len(seen) != 1 or seen[0] is not memory0 or out.shape != (
            MEMAGENT_B, cfg.padded_vocab) or not bool(
                torch.isfinite(out).all()):
        raise AssertionError("pipeline memagent: apply did not prefill the "
                             "raw memory")
    sec = prof.stage_seconds["memagent"]
    log(f"  pipeline memagent: apply prefilled the raw memory (the "
        f"reference's data flow)")
    print(json.dumps({"pipeline": {
        "method": "memagent", "card": card_line(),
        "shape": f"M = (memory [{MEMAGENT_B},{memory0.shape[1]}], segment "
                 f"[{MEMAGENT_B},{ma.segment_len}]) int32, x = question "
                 f"[{MEMAGENT_B},{MEMAGENT_Q}]; llama3.2-1b bf16; prepare "
                 f"decodes {ma.mem_len} tokens",
        "apply_saw_raw_memory": True,
        "memagent": {"stage_ms": {s: 1e3 * v for s, v in sec.items()},
                     "total_ms": 1e3 * sum(sec.values()),
                     "breakdown": prof.breakdown("memagent")}}}),
          flush=True)


TTT_SMOKE_FAST_DIM = 32     # the reference test's fast_dim, at lr 0.1


def _ttt_losses(p, k, v, W0, W1, chunk):
    """The reconstruction loss mean((k W - v)^2) under W0 and W1, and lr
    times the largest eigenvalue of the first chunk's k^T k / chunk (the
    step's stability number: above 2 a gradient step on this quadratic
    grows the error)."""
    import torch

    loss = lambda W: float(((torch.bmm(k, W) - v) ** 2).mean())
    kc = k[:, :chunk]
    lam = float(torch.linalg.eigvalsh(kc.transpose(1, 2) @ kc / chunk).max())
    return loss(W0), loss(W1), float(p["lr"]) * lam


def phase_ttt(dev):
    """``ttt_forward`` at llama3.2-1b's width (d 2048, fast_dim 2048), B 4,
    S 8192, chunk 256, x bf16. At the reference's fixed lr 0.1 the update
    diverges at this width (lr x lambda_max of k^T k / chunk ~ 9 > 2, as
    the JAX package does on the CPU): loss0 and the infinite loss1 are
    reported, and the divergence is checked to be that one. At lr 0.1 x 32
    / fast_dim (the reference test's step per fast dimension, its fast_dim
    32 at lr 0.1) loss1 < loss0 must hold, the reference test's property;
    there: ms a call (CUDA-graph replays), and ``build_pipeline``'s three
    stages called directly over the chunks in order under a StageProfiler
    (``run`` raises, as the reference's does), their W' against
    ``ttt_forward``'s within 1e-4 of max |W'|."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.core.methods import ttt
    from repro_torch.core.pipeline import StageProfiler

    cfg = get_arch(SERVE_ARCH)
    d = cfg.d_model
    p = ttt.ttt_init(cfg, 0, fast_dim=d, device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(TTT_B, TTT_S, d, generator=g, device=dev).bfloat16()
    W0 = ttt.fast_state_init(cfg, TTT_B, fast_dim=d, device=dev)
    xf = x.float()
    q, k, v = F.silu(xf @ p["wq"]), F.silu(xf @ p["wk"]), xf @ p["wv"]
    ref_lr = float(p["lr"])
    runs = {}
    for label, lr in (("reference_lr", ref_lr),
                      ("width_scaled_lr", ref_lr * TTT_SMOKE_FAST_DIM / d)):
        p["lr"] = torch.tensor(lr, dtype=torch.float32, device=dev)
        y, W1 = ttt.ttt_forward(p, x, W0, chunk=TTT_CHUNK)
        loss0, loss1, stab = _ttt_losses(p, k, v, W0, W1, TTT_CHUNK)
        runs[label] = {"lr": lr, "loss0": loss0, "loss1": loss1,
                       "lr_x_lambda_max": stab}
        log(f"  ttt {label} (lr {lr:.6g}): loss {loss0:.4g} -> {loss1:.4g},"
            f" lr x lambda_max {stab:.3g}")
    div, ok = runs["reference_lr"], runs["width_scaled_lr"]
    if not (div["lr_x_lambda_max"] > 2 and not div["loss1"] < div["loss0"]):
        raise AssertionError(f"ttt at lr {ref_lr}: expected the divergence "
                             f"of lr x lambda_max > 2, got {div}")
    if not (y.shape == x.shape and y.dtype == x.dtype and bool(
            torch.isfinite(y).all()) and ok["lr_x_lambda_max"] < 2
            and ok["loss1"] < ok["loss0"]):
        raise AssertionError(f"ttt: y {y.dtype} {tuple(y.shape)}, {ok}")
    call_ms = time_ms(lambda: ttt.ttt_forward(p, x, W0, chunk=TTT_CHUNK),
                      n=3)

    pipe = ttt.build_pipeline(p, TTT_CHUNK)
    prof = StageProfiler()

    def timed(stage, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        prof.record("ttt", (stage,), time.perf_counter() - t0)
        return out

    chunks = [(q[:, c:c + TTT_CHUNK], k[:, c:c + TTT_CHUNK],
               v[:, c:c + TTT_CHUNK]) for c in range(0, TTT_S, TTT_CHUNK)]
    qc, kc, vc = chunks[0]                         # warm-up
    pipe.apply(pipe.prepare((W0, kc, vc)), qc), pipe.relevancy(W0, (kc, vc))
    W = W0
    for qc, kc, vc in chunks:
        timed("relevancy", pipe.relevancy, W, (kc, vc))
        W = timed("prepare", pipe.prepare, (W, kc, vc))
        timed("apply", pipe.apply, W, qc)
    w_err = float((W - W1).abs().max())
    w_tol = 1e-4 * max(1.0, float(W1.abs().max()))
    if not w_err <= w_tol:
        raise AssertionError(f"ttt stages: W' err {w_err} > {w_tol}")
    sec = prof.stage_seconds["ttt"]
    log(f"  ttt: {call_ms:.3f} ms a call, stages' W' within {w_err:.3g} of "
        f"the forward's")
    print(json.dumps({"ttt": {
        "card": card_line(), "shape": f"x [{TTT_B},{TTT_S},{d}] bf16, "
                                      f"fast_dim {d}, chunk {TTT_CHUNK}",
        "ms": call_ms, "timing": "3 calls in a CUDA graph, replayed, at "
                                 "width_scaled_lr",
        **runs,
        "stage_ms": {s: 1e3 * t for s, t in sec.items()},
        "stage_total_ms": 1e3 * sum(sec.values()),
        "breakdown": prof.breakdown("ttt"),
        "stages_vs_forward_w_max_abs_err": w_err}}), flush=True)


# ---------------------------------------------------------------------------
# phase 11: the examples
# ---------------------------------------------------------------------------

# the kernels each example's main path must launch on the card
EXAMPLE_KERNELS = {
    "quickstart": ("flash_attention",) + _DSA,
    "serve_sparse_attention": ("flash_attention",) + _DSA,
    "rag_pipeline": ("flash_attention", "bm25_topk_candidates"),
    "train_mac_100m": ("flash_attention",)}
TRAIN_MAC_STEPS = 10


def phase_examples(dev):
    """Each example's ``main`` on the card at its defaults (their output to
    stderr), each launching the kernels of ``EXAMPLE_KERNELS``; then
    ``train_mac_100m --full`` (d 768, 12 layers, 12 / 12 heads, vocab
    32000, segments of 256, B 4, 2 segments) for TRAIN_MAC_STEPS steps:
    finite, falling loss, 2 x 12 flash launches a step on the tensor cores
    (the backward recomputes the plain attention); one ``examples`` and one
    ``train_mac`` line. Returns train_mac's flash launches."""
    import contextlib

    import torch
    from repro_torch.examples import (quickstart, rag_pipeline,
                                      serve_sparse_attention, train_mac_100m)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    res = {}
    for mod in (quickstart, serve_sparse_attention, rag_pipeline,
                train_mac_100m):
        name = mod.__name__.rsplit(".", 1)[1]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        missing = [k for k in EXAMPLE_KERNELS[name] if not counts[k]]
        if missing:
            raise AssertionError(f"example {name}: no launch of {missing}")
        res[name] = {"s": time.perf_counter() - t0,
                     "launches": {k: c for k, c in counts.items() if c},
                     "flash_launches_by_route": ops.flash_route_counts()}
        log(f"  example {name}: {res[name]['s']:.1f} s, launches "
            f"{res[name]['launches']}")
    print(json.dumps({"examples": {"card": card_line(), **res}}), flush=True)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        out = train_mac_100m.main(["--full", "--steps", str(TRAIN_MAC_STEPS),
                                   "--device", "cuda"])
    routes = ops.flash_route_counts()
    cfg, mc, B = train_mac_100m.setup(full=True)
    per_step = 2 * cfg.n_layers
    losses = out["losses"]
    if routes != {fa.TENSOR_CORES: per_step * TRAIN_MAC_STEPS,
                  fa.CUDA_CORES: 0} or not all(
                      math.isfinite(x) for x in losses) or not \
            losses[-1] < losses[0]:
        raise AssertionError(f"train_mac: routes {routes}, losses {losses}")
    step_ms = [1e3 * s for s in out["step_s"]]
    print(json.dumps({"train_mac": {
        "card": card_line(), "params": out["params"],
        "config": f"d {cfg.d_model}, {cfg.n_layers} layers, {cfg.n_heads} / "
                  f"{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, bf16; "
                  f"segments 2 x {mc.segment_len} (+{mc.retrieve_k} "
                  f"memories), B {B}",
        "steps": TRAIN_MAC_STEPS, "step_ms_median": statistics.median(step_ms),
        "step_ms": step_ms, "loss_first": losses[0], "loss_last": losses[-1],
        "flash_launches_per_step_by_route": {
            r: n / TRAIN_MAC_STEPS for r, n in routes.items()},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}}),
          flush=True)
    return routes[fa.TENSOR_CORES]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--runs", default=",".join(RUNS),
                    help="the serve phase's runs (default: all of RUNS)")
    ap.add_argument("--family-runs", default=",".join(FAMILY_RUNS),
                    help="the families phase's runs (default: all of "
                         "FAMILY_RUNS)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the hybrid_sharded phase's seeded caches")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES + EXTRA_PHASES):
        raise ValueError(f"unknown phases "
                         f"{sorted(phases - set(PHASES + EXTRA_PHASES))}: "
                         f"choose from {PHASES + EXTRA_PHASES}")
    serve_runs = args.runs.split(",")
    if not set(serve_runs) <= set(RUNS):
        raise ValueError(f"unknown runs {sorted(set(serve_runs) - set(RUNS))}"
                         f": choose from {list(RUNS)}")
    family_runs = args.family_runs.split(",")
    if not set(family_runs) <= set(FAMILY_RUNS):
        raise ValueError(f"unknown family runs "
                         f"{sorted(set(family_runs) - set(FAMILY_RUNS))}: "
                         f"choose from {list(FAMILY_RUNS)}")

    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    from repro_torch.kernels import _build

    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    mark(f"[1] built {list(_build.SOURCES)} in {time.perf_counter() - t0:.1f}"
        f" s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    kernels = []
    if "kernels" in phases:
        mark("[2] kernels vs plain versions")
        kernels = [check_relevancy(dev), check_paged_attention(dev),
                   check_page_minmax(dev), check_bm25(dev),
                   check_flash_attention(dev)]
    flash = None
    if "train" in phases:
        mark("[3] train llama3.2-1b bf16")
        flash = phase_train(dev)
    trained = {}
    if "train_families" in phases:
        for arch in TRAIN_FAMILIES:
            mark(f"[3b] train {arch} bf16")
            trained[f"train {arch}"] = phase_train_family(dev, arch)
    if "train_sharded" in phases:
        mark("[3c] train llama3.2-1b bf16 sharded on one card; pod sync; "
             "GPipe; reshard")
        got = phase_train_sharded(dev)
        trained.update(got)
    if "decode_bounds" in phases:
        mark("[3f] the readings behind DECODE_BF16_TOL: bf16 against fp32 "
             "on one device, the split's merge right and wrong")
        phase_decode_bounds(dev)
    decode_rows = decode_launches = None
    if "decode_sharded" in phases:
        mark("[3e] decode over a sequence-split cache: llama3.2-1b on (2, 4)"
             ", decode_32k's and long_500k's layouts; fp32 on (1, 4) and "
             "(2, 2)")
        decode_rows, decode_launches = phase_decode_sharded(dev)
    if "hybrid_sharded" in phases:
        mark("[3g] the hybrid's Mamba2 split: zamba2-7b on (2, 4), train, "
             "prefill, decode_32k's and long_500k's layouts; fp32")
        hybrid_rows, hybrid_launches, trained["hybrid_sharded"] = \
            phase_hybrid_sharded(dev, args.seed)
        decode_rows = {k: (decode_rows or {}).get(k, []) + v
                       for k, v in hybrid_rows.items()}
        decode_launches = dict(decode_launches or {}, **hybrid_launches)
    if "roofline" in phases:
        mark("[3d] roofline: walks on the card and on placeholders; the dry "
             "run")
        phase_roofline(dev)
    runs = {}
    if "serve" in phases:
        for r in serve_runs:
            mark(f"[4] serve llama3.2-1b bf16, {r}")
            runs[r] = phase_serve(dev, r)
    if "families" in phases:
        for r in family_runs:
            run = FAMILY_RUNS[r]
            cut = f" ({run.layers} layers)" if run.layers else ""
            mark(f"[8] {r}: {run.arch}{cut} bf16, method {run.method}")
            runs[r] = phase_serve(dev, r)
    if "fleet" in phases:
        phase_fleet(dev, runs, kernels)
    if runs:
        check_equal_runs(runs)
        for k in kernels:
            if k["name"] == "flash_attention":
                continue
            # launches: the count of the kernel's home path's own run
            by_path = {m: c[k["name"]] for m, (c, _, _, _) in runs.items()}
            k["launches"] = by_path.get(HOME_PATH[k["name"]])
            k["launches_by_path"] = by_path
            k["ms_in_situ_by_path"] = {
                m: p["kernel_ms_in_situ"][k["name"]]
                for m, (_, p, _, _) in runs.items()
                if p["kernel_ms_in_situ"].get(k["name"]) is not None}
            k["ms_in_situ"] = k["ms_in_situ_by_path"].get(HOME_PATH[k["name"]])
    for k in kernels:
        if decode_rows and k["name"] in decode_rows:
            k.setdefault("other_shapes", []).extend(decode_rows[k["name"]])
            k.setdefault("launches_by_path", {}).update(
                {path: c[k["name"]] for path, c in decode_launches.items()
                 if k["name"] in c})
    for k in kernels:
        if k["name"] != "flash_attention":
            continue
        # the train phase is its home path; serve runs prefill through it
        by_path = {m: c["flash_attention"]
                   for m, (c, _, _, _) in runs.items()}
        by_route = {m: r for m, (_, _, r, _) in runs.items()}
        if flash is not None:
            k["launches"], k["ms_in_situ"], by_route["train"] = flash
            by_path["train"] = flash[0]
        for m, (n, r) in trained.items():
            by_path[m], by_route[m] = n, r
        k["launches_by_path"] = by_path
        k["launches_by_route_by_path"] = by_route
    if "modes" in phases:
        mark("[5] dsa-rag: retrieval inline vs sync vs overlap")
        phase_modes(dev)
    if "compare" in phases:
        for r in (r for r, run in ALL_RUNS.items() if run.compare):
            mark(f"[6] {r}: kernel path vs plain path, fp32")
            phase_compare(dev, r)
    if "pipeline" in phases:
        for m in METHODS:
            mark(f"[7] {m}: build_pipeline unfused vs fused")
            phase_pipeline(dev, m)
        mark("[7] rag: build_pipeline unfused vs fused; mac")
        phase_pipeline_rag(dev)
        phase_pipeline_mac(dev)
    flash_paths = {}
    if "methods" in phases:
        mark("[10] memagent: llama3.2-1b bf16, Appendix D's config; ttt")
        by_prefill = phase_memagent(dev)
        flash_paths["memagent"] = sum(by_prefill.values())
        phase_ttt(dev)
    if "examples" in phases:
        mark("[11] the examples; train_mac_100m --full")
        flash_paths["train_mac"] = phase_examples(dev)
    for k in kernels:
        if k["name"] == "flash_attention" and flash_paths:
            k["launches_by_path"].update(flash_paths)
            if "methods" in phases:   # rows 3f and 3g: the main run's counts
                for row in k["other_shapes"]:
                    if row["path"] == "memagent segment prefill":
                        row["launches"] = by_prefill["segment"]
                    elif row["path"] == "memagent answer prefill":
                        row["launches"] = by_prefill["answer"]
    for k in kernels:
        if k["name"] == "flash_attention":
            for row in k["other_shapes"]:
                if row["path"] in ("gathered", "train_sharded",
                                   "granite_tp", "gpipe",
                                   "hybrid_sharded") and \
                        row["path"] in trained:
                    row["launches"] = trained[row["path"]][0]
    torch.cuda.synchronize()
    mark("[12] the kernels line")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
