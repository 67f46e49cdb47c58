"""Dry run: walk every (architecture x input-shape x mesh) cell's step on
placeholder devices, and write its memory, roofline terms and collective
bytes (twin of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod] [--both-meshes] [--variant baseline]
        [--force] [--full] [--tally N]

The reference lowers and compiles each cell's jitted step on 512
placeholder CPU devices and reads XLA's memory analysis and HLO. The port
builds the cell's structs under ``op_walk.placeholders()`` (fake tensors:
nothing is allocated, ``cuda:0 .. cuda:511`` need no card), runs the step
eagerly under ``op_walk.OpWalk`` and reads the walk. It runs on any
machine, with or without a card; on the card it touches none.

  * train cells walk the port's own sharded step over the production mesh,
    with ``pick_accum``'s accumulation. For the transformer families and
    the hybrid it is the tensor-parallel step
    (``train.trainer.sharded_loss_and_grads``):
    256 coordinates' ops would take hours to dispatch here, so data index
    0's model group runs its part of the batch
    (``train.trainer._tp_group_grads``), and the other data indices stand
    in (``_StandIn``): their gradients are zeros of their shapes, reduced
    over the data axes as the step reduces them
    (``train.trainer._reduce_tp_grads``: the ring all-reduce and the FSDP
    sums, walked), and the FSDP gradients they send data index 0's
    coordinates are counted from what data index 1's received from data
    index 0 (by symmetry); then every coordinate's AdamW. xLSTM walks the
    gathered step (every data index gathers the parameters onto its first
    device; the gradients are reduced onto the mesh's first device);
  * prefill cells of the transformer families and the hybrid walk data
    index 0's part of the batch over its model group
    (``models.model.prefill_tp``, each coordinate computing its slice,
    FSDP leaves gathered a layer at a time; the hybrid's Mamba2 blocks cut
    by heads); xLSTM's on the first device of its group, its parameters
    there in full;
  * decode cells of the transformer families and the hybrid walk the
    decode split (``models.model.decode_step_tp``): the cache placed by
    ``cache_specs`` (the hybrid's SSM states by heads, its conv states
    whole on every model member),
    the parameters by ``param_specs``; the baseline runs the config's
    ``memory.method`` (``core.methods.split_sparse``: DSA at 64-token
    pages, Seer or LServe at their ``block_size``), the optimized variants
    DSA whatever the method (stateless for ``optimized-spdecode``, the
    index cache for ``optimized-idxcache``), as the reference's
    ``dryrun.py:109-131``, with the weights TP-resident (no FSDP), as its
    ``dryrun.py:166-167``. decode_32k walks data index 0's
    model group (its rows, the sequence over its members); the other data
    indices' work is the same by symmetry, and their MoE router inputs
    stand in as zeros. long_500k walks every coordinate: the sequence runs
    over the whole mesh, data index 0's model group computes the row and
    every coordinate attends over its slice. The hybrid's step carries no
    index cache, so its idxcache cell fails. xLSTM's decode cells (and any
    on a ``model`` axis of 1) walk data index 0's part of the batch on the
    first device of its group, its parameters and cache there in full;
    there the variants ``optimized-spdecode`` and ``optimized-idxcache``
    run DSA through ``make_sparse_fn_distributed`` /
    ``make_sparse_fn_cached`` over that group's ``model`` devices (the
    hybrid's idxcache cell fails there too). A decode cell's cache holds
    ``seq_len - 1`` tokens (the shape's length, a host int).

A train cell under an optimized variant applies the reference's hints
under its conditions (``dryrun.py:55-61``): ``set_ep_constraint`` when the
variant starts with ``optimized`` and the model's experts split over the
model axis (``TrainConfig.ep_local``: each expert-parallel shard
dispatches and combines its own slots), ``set_sp_residual`` when ``sp`` is
one of the variant's words and the sequence splits over the model axis
(``TrainConfig.sp``: the Megatron-SP residual, reduce-scatters and
all-gathers in place of each layer's all-reduces). The record lists them
(``hints_applied``). As in the reference, a hint meets no site where the
step has none: xLSTM's gathered step, a model axis of 1.

Trip counts, as the reference's (its HLO walk scales each ``lax.scan``
body by its trip count): by default a cell is cut. Its repeated units (the
layer stack; the hybrid's super blocks and tail; the micro-steps; xLSTM's
time loop) are walked at small counts (``trip_scale``), each walk in
placeholders of its own with the full cell's pins (FSDP, ``pick_accum``,
the hints, the parameters' specs), and every count of every card is
solved for the full counts, exactly (``op_walk.TripScale``); the busiest
card is chosen after. ``--full`` (``run_cell(..., cut=False)``) walks the
whole step. ``--tally N`` prints the busiest card's N ops that move the
most bytes.

Each record (``build/dryrun/<arch>__<shape>__<mesh>__<variant>.json``)
holds the reference's keys: ``memory_analysis`` (argument and peak live
bytes of the busiest device, whether they fit in the card's 80 GB),
``roofline`` (``launch.roofline``: the busiest device's terms), ``ok`` or
``error``; and ``walks`` (each walk's unit counts and seconds) and
``cut`` (the units, their full counts and walk counts, and whether the
solved peak is exact; None for an uncut walk).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.core.placement import HBM_BW, HBM_BYTES
from repro_torch.distributed import sharding as sh
from repro_torch.launch import op_walk
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (batch_structs, cache_structs,
                                      input_specs, param_structs,
                                      pick_accum, sparse_structs)
from repro_torch.models import model as M
from repro_torch.train.optimizer import (adamw_update, init_opt_state,
                                         leaves, tree_map)
from repro_torch.train.trainer import (TrainConfig, _reduce_tp_grads,
                                       _tp_group_grads, _unflatten,
                                       data_parts, make_train_step,
                                       splits_model)

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "build", "dryrun")
PAGE = 64            # DSA's micro-page in the reference's decode cells


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.devices.shape)


def _cell_path(arch: str, shape: str, mesh: str, variant: str,
               out_dir: Optional[str] = None) -> str:
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    tag = "pod" + mesh if mesh.count("x") == 2 else mesh
    return os.path.join(out_dir, f"{arch}__{shape}__{tag}__{variant}.json")


def train_hints(cfg, shape, tp: int, variant: str):
    """The reference's hints this variant turns on for a train cell
    (``dryrun.py:55-61``), by the reference's names."""
    out = []
    if variant.startswith("optimized") and cfg.n_experts \
            and cfg.n_experts % tp == 0:
        out.append("set_ep_constraint")
    if "sp" in variant.split("-") and shape.seq_len % tp == 0:
        out.append("set_sp_residual")
    return out


def _place(tree, dev):
    return tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                    else t, tree)


def _first_part(mesh, batch: int):
    """Data index 0's coordinates and first device, and its rows of a batch
    of ``batch`` (all of it when the batch does not split over the data
    axes)."""
    groups = sh.model_groups(mesh)
    dp = len(groups)
    rows = batch // dp if batch >= dp and batch % dp == 0 else batch
    return groups[0], mesh.device(groups[0][0]), rows


# ---------------------------------------------------------------------------
# the cells' steps
# ---------------------------------------------------------------------------


class _StandIn:
    """A stand-in data index's gradients for ``trainer._reduce_tp_grads``:
    zeros of each shard's shape (fp32 when accumulated), made on its card
    when the exchange reads them."""

    def __init__(self, ps, fp32: bool):
        self.ps, self.fp32 = ps, fp32

    def __getitem__(self, key):
        i, c = key
        s = self.ps[i].shards[c]
        return torch.zeros(s.shape, device=s.device,
                           dtype=torch.float32 if self.fp32 else s.dtype)


def _fsdp_symmetry(w: op_walk.OpWalk, mesh):
    """The FSDP gradients the stand-in data indices send data index 0's
    coordinates: each receives from every other data index what data index
    1's coordinate of the same model index received from data index 0 (the
    FSDP gathers' backward; nothing else reaches it as a reduce-scatter)."""
    dp = len(sh.model_groups(mesh))
    if dp < 2:
        return
    for m0, m1 in zip(sh.model_groups(mesh)[0], sh.model_groups(mesh)[1]):
        src = w.costs[str(mesh.device(m1))]
        got = src.per_collective["reduce-scatter"] * (dp - 1)
        dst = w.costs[str(mesh.device(m0))]
        dst.per_collective["reduce-scatter"] += got
        dst.coll_bytes += got
        dst.bytes += got
        w.by_device_op[str(mesh.device(m0))][
            "reduce-scatter (the stand-ins', by symmetry)"][2] += got


def walk_train(cfg, shape, mesh, tp: int, rec: Dict,
               variant: str = "baseline", *, accum: Optional[int] = None,
               hints: Optional[List[str]] = None,
               pspecs=None) -> op_walk.OpWalk:
    """One sharded train step over ``mesh`` (inside placeholders), with the
    variant's hints (``train_hints``). ``accum``, ``hints`` and ``pspecs``
    (a tree of the parameters' ``PartitionSpec``) pin what ``pick_accum``,
    ``train_hints`` and ``param_specs`` would choose for this config and
    shape (a cut walk takes the full cell's)."""
    if accum is None:
        accum = pick_accum(cfg, shape, mesh.size // tp)
    rec["accum"] = accum
    if hints is None:
        hints = train_hints(cfg, shape, tp, variant)
    if hints:
        rec["hints_applied"] = hints
    specs = input_specs(cfg, shape, mesh, tp=tp)
    params = sh.device_put(specs["params"], specs["params_sharding"]
                           if pspecs is None else
                           sh.make_shardings(pspecs, mesh))
    opt = init_opt_state(params)
    batch = specs["batch"]
    if accum > 1:
        mb = shape.global_batch // accum
        batch = {k: (x.reshape((3, accum, mb) + x.shape[2:]).movedim(0, 1)
                     if k == "positions3" else
                     x.reshape((accum, mb) + x.shape[1:]))
                 for k, x in batch.items()}
    tc = TrainConfig(accum=accum, tp=tp, remat=True,
                     sp="set_sp_residual" in hints,
                     ep_local="set_ep_constraint" in hints)
    dp = len(sh.model_groups(mesh))
    if not splits_model(cfg, mesh):
        step = make_train_step(cfg, tc, mesh)
        rec["walked"] = f"the gathered sharded Trainer step: {dp} data indices"
        with op_walk.OpWalk() as w:
            w.track(params, opt.m, opt.v, batch)
            step(params, opt, batch)
        return w
    rec["walked"] = (
        f"the tensor-parallel step: data index 0's model group "
        f"({mesh.size // dp} coordinates); the other "
        f"{dp - 1} data indices stand in (zero gradients reduced over the "
        f"data axes as walked; the FSDP gradients they send data index 0's "
        f"coordinates counted from data index 1's by symmetry); every "
        f"coordinate's AdamW")
    ps = leaves(params)
    parts = data_parts(batch, cfg, tc, mesh)
    with op_walk.OpWalk() as w:
        w.track(params, opt.m, opt.v, batch)
        _, mine = _tp_group_grads(params, cfg, tc, parts[0], mesh, 0)
        per_d = [mine] + [_StandIn(ps, accum > 1) for _ in parts[1:]]
        grads = _unflatten(params, _reduce_tp_grads(ps, mesh, per_d,
                                                    len(parts)))
        del per_d, mine
        adamw_update(grads, opt, params, tc.opt)
        del grads
    _fsdp_symmetry(w, mesh)
    rec["grad_reduce"] = _grad_reduce(w, mesh, params, accum)
    return w


def _grad_reduce(w: op_walk.OpWalk, mesh, params, accum: int) -> Dict:
    """What data index 1's first coordinate (a stand-in: it computes
    nothing, so all it receives is the gradient exchange) receives, against
    its gradient slice (fp32 when accumulated): the slice it owns, or an
    FSDP leaf's whole data extent, which it computes and reduce-scatters.
    Of what it receives, the ring all-reduce over the model axis of the
    leaves replicated there (2 (n - 1) / n of their shards) is set apart;
    the rest is the data-axis reduction."""
    groups = sh.model_groups(mesh)
    if len(groups) < 2:
        return {}
    c, n, tp = groups[1][0], len(groups), len(groups[1])
    slice_bytes = model_axis = 0
    for x in leaves(params):
        nbytes = x.shards[c].numel() * (4 if accum > 1 else
                                        x.shards[c].element_size())
        slice_bytes += nbytes * (1 if sh.fsdp_dim(x) is None else n)
        if sh.cut_dim(x, (sh.MODEL_AXIS,)) is None:
            model_axis += 2 * (tp - 1) * nbytes // tp
    got = w.costs[str(mesh.device(c))].per_collective
    data_axis = got["all-reduce"] + got["reduce-scatter"] * (n - 1) \
        - model_axis
    return {"card": str(mesh.device(c)), "slice_bytes": slice_bytes,
            "data_axis_bytes_in": data_axis,
            "model_axis_bytes_in": model_axis,
            "ratio": data_axis / slice_bytes, "ring_ratio": 2 * (n - 1) / n}


def walk_prefill(cfg, shape, mesh, tp: int, rec: Dict,
                 pspecs=None) -> op_walk.OpWalk:
    group, dev, rows = _first_part(mesh, shape.global_batch)
    batch = _place(batch_structs(cfg, shape.__class__(
        shape.name, shape.seq_len, rows, shape.kind)), dev)
    kw = dict(max_len=shape.seq_len, positions3=batch.get("positions3"),
              img_embeds=batch.get("img_embeds"), tp=tp)
    if splits_model(cfg, mesh):
        structs = param_structs(cfg, tp)
        params = sh.device_put(structs, sh.make_shardings(
            pspecs or sh.param_specs(structs, cfg, mesh), mesh))
        rec["walked"] = (f"data index 0's {rows} rows over its model group "
                         f"({len(group)} coordinates)")
        with torch.no_grad(), op_walk.OpWalk() as w:
            w.track(params, batch)
            M.prefill_tp(sh.group_view(params, mesh, 0), cfg,
                         batch["tokens"], **kw)
        return w
    params = _place(param_structs(cfg, tp), dev)
    rec["walked"] = f"data index 0's {rows} rows on {dev}"
    with torch.no_grad(), op_walk.OpWalk() as w:
        w.track(params, batch)
        M.prefill(params, cfg, batch["tokens"], **kw)
    return w


def walk_decode(cfg, shape, mesh, tp: int, variant: str, rec: Dict,
                pspecs=None) -> op_walk.OpWalk:
    if splits_model(cfg, mesh):
        return _walk_decode_split(cfg, shape, mesh, tp, variant, rec, pspecs)
    group, dev, rows = _first_part(mesh, shape.global_batch)
    S = shape.seq_len
    params = _place(param_structs(cfg, tp), dev)
    caches = _place(cache_structs(cfg, rows, S, tp), dev)
    caches["length"] = S - 1
    token = _place(batch_structs(cfg, shape.__class__(
        shape.name, S, rows, shape.kind))["token"], dev)
    sparse_fn = sp = None
    stateful = False
    if cfg.family != "ssm" and S >= cfg.memory.min_context:
        from repro_torch.core.methods import (dsa, get_sparse_method,
                                              sparse_kwargs)
        opt = variant.startswith("optimized")      # DSA, any method
        sp = _place(sparse_structs(cfg.replace(memory=cfg.memory.replace(
            method="dsa")) if opt else cfg, tp), dev)
        devices = tuple(mesh.device(i) for i in group)
        if variant == "optimized-spdecode":
            sparse_fn = dsa.make_sparse_fn_distributed(
                cfg, cfg.memory, devices, tp=tp, page=PAGE)
        elif variant == "optimized-idxcache":
            if cfg.family == "hybrid":
                raise ValueError(f"{cfg.name}: the hybrid's decode_step "
                                 f"carries no index cache (its shared "
                                 f"block's sites share one indexer)")
            sparse_fn = dsa.make_sparse_fn_cached(cfg, cfg.memory, devices,
                                                  tp=tp, page=PAGE)
            stateful = True
            sp = {"p": sp, "kidx_sum": dsa.idx_cache_init(
                cfg, cfg.memory, rows, S, page=PAGE, device="cpu").to(dev)}
        else:
            _, mk = get_sparse_method(cfg.memory.method)
            sparse_fn = mk(cfg, cfg.memory, tp=tp,
                           **sparse_kwargs(cfg.memory.method, PAGE))
    rec["walked"] = (f"data index 0's {rows} rows on {dev}, a cache of "
                     f"{S - 1} tokens (no model-axis split for "
                     f"{cfg.family})")
    with torch.no_grad(), op_walk.OpWalk() as w:
        w.track(params, caches, token, sp)
        M.decode_step(params, cfg, token, caches, tp=tp,
                      sparse_fn=sparse_fn, sparse_params=sp,
                      sparse_stateful=stateful)
    return w


def _fsdp(shape, variant: str) -> Optional[bool]:
    """The cell's ``param_specs(fsdp=...)``: the optimized decode variants
    keep the weights TP-resident (the reference's ``dryrun.py:166-167``);
    elsewhere the rule (None: FSDP from 5e9 counted parameters)."""
    return False if shape.kind == "decode" and variant.startswith(
        "optimized") else None


def _walk_decode_split(cfg, shape, mesh, tp: int, variant: str, rec: Dict,
                       pspecs=None) -> op_walk.OpWalk:
    """One step of the decode split over ``mesh`` (inside placeholders)."""
    from repro_torch.core.methods import dsa, split_sparse

    S, B = shape.seq_len, shape.global_batch
    structs = param_structs(cfg, tp)
    params = sh.device_put(structs, sh.make_shardings(
        pspecs or sh.param_specs(structs, cfg, mesh,
                                 fsdp=_fsdp(shape, variant)), mesh))
    c = cache_structs(cfg, B, S, tp)
    caches = sh.device_put(c, sh.make_shardings(
        sh.cache_specs(c, cfg, shape, mesh), mesh))
    caches["length"] = S - 1
    token = batch_structs(cfg, shape)["token"].to(mesh.device(0))
    sparse = sp = None
    if S >= cfg.memory.min_context:
        # the baseline: the config's method, as the reference's
        # ``make_sparse_fn`` for any method (DSA at PAGE-token micro-pages,
        # Seer and LServe at their blocks); the optimized variants: DSA
        # whatever the method (the reference's dryrun.py:118-127)
        mem = cfg.memory
        if variant.startswith("optimized"):
            mem = mem.replace(method="dsa")
        stateful = variant == "optimized-idxcache"
        sparse = split_sparse(cfg, mem, page=PAGE, stateful=stateful)
        sp = sparse_structs(cfg.replace(memory=mem), tp)
        if stateful:
            sp = {"p": sp, "kidx_sum": dsa.idx_cache_init(
                cfg, mem, B, S, page=PAGE, device="cpu")}
            specs = sh.sparse_cache_specs(sp, cfg, shape, mesh)
        else:
            specs = sh.method_specs(sp, cfg, mesh)
        sp = sh.device_put(sp, sh.make_shardings(specs, mesh))
    big = sh.big_batch(mesh, B)
    groups = sh.model_groups(mesh)
    seq = len(sh.seq_groups(mesh, B)[0])
    rows = B // len(groups) if big else B
    rec["sparse"] = None if sparse is None else _sparse_name(sparse, mem)
    rec["walked"] = (
        f"the decode split: data index 0's model group ({len(groups[0])} "
        f"coordinates, {rows} rows, {S // seq} tokens of the cache each); "
        f"the other {len(groups) - 1} data indices' work is the same by "
        f"symmetry (their MoE router inputs stand in as zeros)" if big else
        f"the decode split: every coordinate ({mesh.size}), the sequence "
        f"over (data, model), {S // seq} tokens each; data index 0's model "
        f"group computes the {B} row(s)")
    with torch.no_grad(), op_walk.OpWalk() as w:
        w.track(params, caches, token, sp)
        if not big:
            M.decode_step_tp(params, cfg, token, caches, mesh, tp=tp,
                             sparse=sparse, sparse_params=sp)
            return w
        g = M.DecodeGroup(params, cfg, token, caches, mesh, 0, tp=tp,
                          sparse=sparse, sparse_params=sp)

        def router(hs):
            if g.moe_gather:   # the other data indices' inputs: zeros
                hs = hs + [[torch.zeros_like(h, device=mesh.device(c))
                            for h, c in zip(hs[0], grp)]
                           for grp in groups[1:]]
            return hs

        M._decode_layers([g], cfg, router)
        g.logits()
    return w


def _sparse_name(sparse, mem) -> str:
    """The record's name of a split method: the method, its page size and
    (DSA) its state or (Seer) its selection mode."""
    if mem.method == "dsa":
        return (f"DSA, {sparse.page}-token pages, "
                f"{'index cache' if sparse.stateful else 'stateless'}")
    if mem.method == "seer":
        return (f"Seer, {sparse.page}-token blocks, {mem.selection}"
                + (f" {mem.threshold:g}" if mem.selection == "threshold"
                   else f" {sparse.n_sel}"))
    return (f"LServe, {sparse.page}-token pages, {sparse.ppp} a physical "
            f"page, top {sparse.n_sel}")


# ---------------------------------------------------------------------------
# trip counts: the cut walks
# ---------------------------------------------------------------------------

LAYERS, SUPER, TAIL, ACCUM, LENGTH = ("layers", "super blocks", "tail layers",
                                      "accum", "seq_len")


def pins(cfg, shape, mesh, variant: str = "baseline") -> Dict:
    """What a train walk decides from the config's depth and the shape's
    length, taken from the full cell so that a cut walk keeps its program:
    ``pick_accum`` (it reads both) and the variant's hints. (The FSDP rule,
    ``sharding.FSDP_THRESHOLD`` on the counted parameters, is pinned with
    the parameters' specs in ``cell_counts``: zamba2's 6.7e9 against 5e9
    would fall under it at a few layers.)"""
    tp = mesh.shape["model"]
    if shape.kind != "train":
        return {}
    return {"accum": pick_accum(cfg, shape, mesh.size // tp),
            "hints": train_hints(cfg, shape, tp, variant)}


def trip_scale(cfg, shape, accum: int = 1) -> op_walk.TripScale:
    """The cell's repeated units, cut where the reference's scans are
    (``models/model.py``'s layer scans, the micro-step scan, xLSTM's scans
    over time), each walked at the least counts at which its program and
    the site of its peak live bytes are the full cell's (the smoke tests,
    ``tests/test_torch_dryrun_cut.py``, hold each cut walk to the uncut
    one):

      * the transformer families: the layer stack, at 2 and 3 layers (at
        1 the one layer is the first and the last: the peak misses what a
        layer carries into the next);
      * the hybrid: its super blocks (``shared_attn_every`` Mamba2 layers
        and one site of the shared block) and its tail layers, each at 2
        and 3 (no count of 0: a hybrid with no site or no tail is another
        program);
      * xLSTM: the time loop of a train or prefill cell, its depth kept;
        a prefill at lengths 2 and 3 (at length 1 its products move other
        bytes, the tests find); a train step at 4, 5 and 6: the
        backward of each step's slice is a zero tensor of the whole
        sequence, so its bytes grow with the square of the length, and
        its peak lies on one line from length 4 on;
      * a train cell's micro-steps, at accum 2 and 3 and the full
        micro-batch (accum 1 keeps the gradients in the model dtype and
        accumulates nothing: another program); the work of every other
        unit is done once a micro-step, so those terms multiply.

    A unit whose full count is no more than its last walk's is walked at
    its full count, not cut."""
    units, powers = [], {}
    if cfg.xlstm_pattern:
        if shape.kind == "train":
            units.append(op_walk.Unit(LENGTH, shape.seq_len, 4, 5))
            powers[LENGTH] = 2
        elif shape.kind == "prefill":
            units.append(op_walk.Unit(LENGTH, shape.seq_len, 2, 3))
    elif cfg.family == "hybrid":
        n_super, _, tail = M._hybrid_shape(cfg)
        units += [op_walk.Unit(SUPER, n_super, 2, 3),
                  op_walk.Unit(TAIL, tail, 2, 3)]
    else:
        units.append(op_walk.Unit(LAYERS, cfg.n_layers, 2, 3))
    if shape.kind == "train":
        units.append(op_walk.Unit(ACCUM, accum, 2, 3))
    units = [u for u in units if u.full > u.lo + powers.get(u.name, 1) * (
        u.hi - u.lo)]
    terms = [()]
    for u in units:
        if u.name != ACCUM:
            terms += [(u.name,) * k for k in range(1, powers.get(u.name, 1)
                                                   + 1)]
    if any(u.name == ACCUM for u in units):
        terms += [t + (ACCUM,) for t in terms]
    return op_walk.TripScale(units, terms)


#: the smoke tests' bound on a solved peak that is not exact
PEAK_BOUND = 0.02


def peak_exact(cfg, shape) -> bool:
    """Whether a cut walk's peak live bytes are exact: the smoke tests hold
    them equal to the uncut walk's in every family and kind but the
    hybrid's prefill and decode, whose peaks move between sites (a super
    block's Mamba2 layers, its site, the tail, on other cards) up to 4
    super blocks; there the solved peak is under the uncut walk's by at
    most ``PEAK_BOUND`` of it in those tests."""
    return not (cfg.family == "hybrid" and shape.kind != "train")


def _cut(cfg, shape, accum: int, counts: Dict[str, int]):
    """(cfg, shape, accum) of the walk at ``counts`` ({unit: count}; the
    other units at their full counts). The micro-batch stays the full
    cell's, so each data index's part of it, and the MoE dispatch groups
    ``trainer.data_parts`` cuts it into, stay too."""
    if LAYERS in counts:
        cfg = cfg.replace(n_layers=counts[LAYERS])
    if SUPER in counts or TAIL in counts:
        n_super, per, tail = M._hybrid_shape(cfg)
        cfg = cfg.replace(n_layers=counts.get(SUPER, n_super) * per
                          + counts.get(TAIL, tail))
    if LENGTH in counts:
        shape = dataclasses.replace(shape, seq_len=counts[LENGTH])
    if ACCUM in counts:
        mb = shape.global_batch // accum
        accum = counts[ACCUM]
        shape = dataclasses.replace(shape, global_batch=mb * accum)
    return cfg, shape, accum


def _by_path(tree) -> Dict:
    out = {}
    sh.tree_map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _check_cut(full, cut, specs, counts: Dict[str, int]):
    """Raise unless the full config's parameter specs cut the walk's
    parameters on dims of the full sizes: a spec never cuts a dim that a
    trip count sizes (the stacked layers)."""
    full, cut = _by_path(full), _by_path(cut)
    for path, spec in _by_path(specs).items():
        for i, axes in enumerate(spec):
            if axes is not None and full[path].shape[i] != cut[path].shape[i]:
                raise ValueError(
                    f"{', '.join(counts)}: the full config cuts parameter "
                    f"{'/'.join(map(str, path))} over {axes} on dim {i} "
                    f"({full[path].shape[i]}); the walk at {counts} has "
                    f"{cut[path].shape[i]} there")


def _walk(cfg, shape, mesh, tp: int, variant: str, rec: Dict,
          pin: Dict) -> op_walk.OpWalk:
    """One walk of the cell's step (inside placeholders)."""
    pspecs = pin.get("pspecs")
    if shape.kind == "train":
        return walk_train(cfg, shape, mesh, tp, rec, variant,
                          accum=pin["accum"], hints=pin["hints"],
                          pspecs=pspecs)
    if shape.kind == "prefill":
        return walk_prefill(cfg, shape, mesh, tp, rec, pspecs)
    return walk_decode(cfg, shape, mesh, tp, variant, rec, pspecs)


GRAD_REDUCE = ("slice_bytes", "data_axis_bytes_in", "model_axis_bytes_in")


def _counts(w: op_walk.OpWalk, rec: Dict) -> Dict[Tuple, float]:
    """Every count of a walk, flat: per device its FLOPs by dtype, bytes,
    bytes by collective, peak live and argument bytes, and its [calls,
    flops, bytes] by op; the kernel calls by name; the gradient exchange's
    bytes (``grad_reduce``)."""
    out: Dict[Tuple, float] = {}
    for dev, c in w.costs.items():
        out[("bytes", dev)] = c.bytes
        for k, v in c.flops_by_dtype.items():
            out[("flops", dev, k)] = v
        for k, v in c.per_collective.items():
            out[("collective", dev, k)] = v
    for dev, n in w.peak_live.items():
        out[("peak", dev)] = n
    for dev, n in w.argument_bytes.items():
        out[("arguments", dev)] = n
    for r in w.kernels:
        out[("kernel", r.name)] = out.get(("kernel", r.name), 0) + 1
    for dev, ops in w.by_device_op.items():
        for name, row in ops.items():
            for i, v in enumerate(row):
                out[("op", dev, name, i)] = v
    for k in GRAD_REDUCE:
        if k in rec.get("grad_reduce", {}):
            out[("grad_reduce", k)] = rec["grad_reduce"][k]
    return out


def costs_of(counts: Dict[Tuple, float]) -> Dict[str, op_walk.Costs]:
    """The per-device ``Costs`` of flat counts (``cell_counts``)."""
    costs: Dict[str, op_walk.Costs] = {}

    def get(dev):
        if dev not in costs:      # whole numbers stay whole
            costs[dev] = op_walk.Costs(0, 0, 0, {k: 0 for k in
                                                 op_walk.COLLECTIVES})
        return costs[dev]

    for key, v in counts.items():
        if key[0] == "bytes":
            get(key[1]).bytes = v
        elif key[0] == "flops":
            get(key[1]).add_flops(key[2], v)
        elif key[0] == "collective":
            c = get(key[1])
            c.per_collective[key[2]] = v
            c.coll_bytes += v
    return costs


def cell_counts(cfg, shape, mesh, variant: str = "baseline",
                cut: bool = True) -> Tuple[Dict[Tuple, float], Dict]:
    """A cell's counts (``_counts``' keys): with ``cut``, solved from walks
    at small trip counts (``trip_scale``) for the full ones, each walk in
    placeholders of its own over structs of its own config and shape, with
    the full cell's ``pins`` and, where the depth is cut, the full config's
    parameter specs (its FSDP rule; and FSDP cuts a leaf of 2**22 elements
    or more: zamba2's stacked ``w_B`` is one at 13 super blocks, not at 2,
    and its 6.7e9 counted parameters, 5e9 or more, would be under 5e9 at
    a few layers); else one walk of
    the whole step. Returns the counts and {"rec": the first walk's record
    keys, "walks": [{"counts": the units' counts, "seconds"}], "scale":
    the ``TripScale``}. Raises where a cut would change the program (a
    spec that cuts a dim a trip count sizes) or a count cannot be fit."""
    tp = mesh.shape["model"]
    pin = pins(cfg, shape, mesh, variant)
    accum = pin.get("accum", 1)
    ts = trip_scale(cfg, shape, accum) if cut else op_walk.TripScale([])
    depth = any(u.name in (LAYERS, SUPER, TAIL) for u in ts.units)
    if depth:
        full = param_structs(cfg, tp)
        pin["pspecs"] = sh.param_specs(full, cfg, mesh,
                                       fsdp=_fsdp(shape, variant))
    samples, walks, first = {}, [], None
    for point in ts.points():
        counts = {u.name: n for u, n in zip(ts.units, point)}
        c_cfg, c_shape, c_accum = _cut(cfg, shape, accum, counts)
        if depth:
            _check_cut(full, param_structs(c_cfg, tp), pin["pspecs"], counts)
        t0 = time.time()
        rec: Dict = {}
        with op_walk.placeholders():
            w = _walk(c_cfg, c_shape, mesh, tp, variant, rec,
                      dict(pin, accum=c_accum))
        samples[point] = _counts(w, rec)
        del w
        walks.append({"counts": counts, "seconds": time.time() - t0})
        if first is None:
            first = rec
    if pin.get("accum") is not None:
        first["accum"] = pin["accum"]
    return ts.fit(samples), {"rec": first, "walks": walks, "scale": ts}


def top_ops(counts: Dict[Tuple, float], device: str, n: int = 10) -> List:
    """The ``n`` ops that move the most bytes on ``device``: [op, calls,
    flops, bytes], most bytes first."""
    rows: Dict[str, List] = {}
    for key, v in counts.items():
        if key[0] == "op" and key[1] == device:
            rows.setdefault(key[2], [key[2], 0, 0, 0])[key[3] + 1] = v
    return sorted(rows.values(), key=lambda r: -r[3])[:n]


# ---------------------------------------------------------------------------
# dry-run one cell
# ---------------------------------------------------------------------------


def memory_analysis(peak: Dict[str, int], args: Dict[str, int],
                    device: str) -> Dict:
    """Argument and peak live bytes of ``device`` (the busiest), whether
    its peak fits in one card's memory, and the largest peak of any
    card."""
    cards = {d: n for d, n in peak.items() if d.startswith("cuda")}
    top = max(cards, key=cards.get) if cards else device
    mine = peak.get(device, 0)
    return {"device": device,
            "argument_size_in_bytes": int(args.get(device, 0)),
            "peak_live_bytes": int(mine), "fits": mine <= HBM_BYTES,
            "max_peak_device": top,
            "max_peak_live_bytes": int(cards.get(top, 0)),
            "max_fits": cards.get(top, 0) <= HBM_BYTES,
            "card_bytes": HBM_BYTES}


def _cut_text(ts: op_walk.TripScale) -> str:
    walked = ts.walked()
    return "; ".join(f"{u.name} walked at "
                     f"{', '.join(str(n) for n in walked[u.name])}, solved "
                     f"for {u.full}" for u in ts.units)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             variant: str = "baseline", force: bool = False, *, cfg=None,
             shape=None, mesh=None, out_dir: Optional[str] = None,
             cut: bool = True, tally: int = 0) -> Dict:
    """Walk one cell and write its record. ``cfg``, ``shape`` and ``mesh``
    replace the arch's config, ``SHAPES[shape_name]`` and the production
    mesh (a test's smoke cell on a small mesh of ``op_walk.cards``).
    ``cut`` (the default, as trip-count scaling is the reference's):
    walk the repeated units at small counts and solve for the full ones
    (``cell_counts``); ``cut=False`` walks the whole step. ``tally``: print
    the busiest card's ``tally`` ops that move the most bytes."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(mesh)
    path = _cell_path(arch, shape_name, name, variant, out_dir)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    chips = mesh.size
    t0 = time.time()
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": name,
                 "variant": variant, "ok": False}
    try:
        counts, info = cell_counts(cfg, shape, mesh, variant, cut)
        ts, walked = info["scale"], info["rec"]
        rec.update({k: v for k, v in walked.items() if k != "grad_reduce"})
        if ts.units:
            rec["walked"] += (f"; trip-count scaled from {len(ts.terms)} "
                              f"walks: {_cut_text(ts)}")
        rec["walk_s"] = time.time() - t0
        rec["walks"] = info["walks"]
        rec["cut"] = None if not cut else {
            "units": {u.name: {"full": u.full, "walked": ts.walked()[u.name]}
                      for u in ts.units},
            "peak": "exact" if not ts.units or peak_exact(cfg, shape) else
            f"not exact: the smoke tests find it under the uncut walk's "
            f"by at most {PEAK_BOUND:.0%}"}
        costs = costs_of(counts)
        rl = RL.from_walk(costs, chips, RL.model_flops_for(cfg, shape))
        per = lambda kind: {k[1]: v for k, v in counts.items()  # noqa: E731
                            if k[0] == kind}
        rec["memory_analysis"] = memory_analysis(per("peak"),
                                                 per("arguments"), rl.device)
        rec["roofline"] = rl.to_dict()
        rec["roofline"]["ideal_memory_s"] = (
            RL.ideal_memory_bytes(cfg, shape, chips) / HBM_BW)
        rec["collective_bytes"] = RL.collective_bytes(costs)
        rec["kernel_calls"] = per("kernel")
        if walked.get("grad_reduce"):
            g = {k: per("grad_reduce").get(k, 0) for k in GRAD_REDUCE}
            rec["grad_reduce"] = dict(
                card=walked["grad_reduce"]["card"], **g,
                ratio=g["data_axis_bytes_in"] / g["slice_bytes"],
                ring_ratio=walked["grad_reduce"]["ring_ratio"])
        rec["ok"] = True
        ma = rec["memory_analysis"]
        print(f"[dryrun] {arch} {shape_name} {name} {variant}: "
              f"compute={rl.compute_s*1e3:.2f}ms "
              f"memory={rl.memory_s*1e3:.2f}ms "
              f"collective={rl.collective_s*1e3:.2f}ms "
              f"bottleneck={rl.bottleneck} mfu={rl.mfu:.3f} on {rl.device} "
              f"(walk {rec['walk_s']:.0f}s, {len(rec['walks'])} walk(s))")
        print(f"  memory: arguments {ma['argument_size_in_bytes']/2**30:.2f}"
              f"GiB, peak live {ma['peak_live_bytes']/2**30:.2f}GiB on "
              f"{ma['device']} (fits 80 GB: {ma['fits']}); largest peak "
              f"{ma['max_peak_live_bytes']/2**30:.2f}GiB on "
              f"{ma['max_peak_device']}")
        print(f"  walk: flops/dev={rl.flops:.3e} bytes/dev={rl.hbm_bytes:.3e}"
              f" {rl.flops_by_dtype}")
        print(f"  collectives: { {k: f'{v/2**20:.1f}MiB' for k, v in rl.per_collective.items() if v} }")
        for op, calls, flops, nbytes in top_ops(counts, rl.device, tally):
            print(f"  op {op}: {calls} calls, {flops:.4g} flops, "
                  f"{nbytes:.6g} bytes ({nbytes / HBM_BW * 1e3:.4f} ms)")
    except Exception as e:  # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch} {shape_name} {name} FAILED: "
              f"{rec['error'][:300]}")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="walk the whole step (no trip-count scaling)")
    ap.add_argument("--tally", type=int, default=0,
                    help="print the busiest card's N ops by bytes")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_ok = n_fail = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, mp, args.variant, args.force,
                               cut=not args.full, tally=args.tally)
                n_ok += rec.get("ok", False)
                n_fail += not rec.get("ok", False)
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
