"""Training loop (twin of ``repro.train.trainer``): a train step with
per-layer remat, microbatch gradient accumulation, the compressed cross-pod
gradient sync with error feedback, the sharded step, and checkpoint /
restart.

Fault tolerance: the Trainer saves every ``ckpt_every`` steps (atomic),
restores the latest checkpoint on construction, and exposes
``emergency_save`` for the launcher's signal handler.

The pod sync: when ``compress`` is not "none" and the mesh has a ``pod``
axis of size > 1, the gradients pass through
``collectives.compressed_grads_with_feedback`` (bf16 mode casts to bf16 and
back once more, as the reference does) and the residual lives in
``opt_state.residual``. Without a pod axis ``compress`` changes nothing, as
in the reference.

The sharded step: with parameters placed by ``sharding.device_put``, the
step computes what the reference's ``jax.jit(step)`` computes under GSPMD,
the single-device step's result, and each mesh coordinate computes its own
slice of it. The batch is split over the data axes as ``batch_specs`` says
(not split when it does not divide). For the transformer families (dense,
moe, audio, vlm) and the hybrid on a mesh whose ``model`` axis is > 1,
each data index's model group runs the tensor-parallel ``loss_and_grads``
(``models.model.train_loss_tp`` over ``sharding.group_view``: attention
split by heads, the MLP and the vocabulary by columns, MoE by experts or
d_ff, the hybrid's Mamba2 blocks by heads, FSDP leaves gathered one layer
at a time); each coordinate gets the
gradient of its own shards. ``TrainConfig.sp`` and ``ep_local`` turn on
the reference's optimized train variants there (the Megatron-SP residual;
the MoE's shard-local dispatch); they change no result, and the gathered
step has nothing for them to change. Then a leaf replicated over
``model`` sums its copies' gradients over the model group (each copy
reaches the loss only through its own shard), and each slice's gradient
is averaged over the data
indices onto the coordinates that own it: a ring all-reduce for leaves
replicated over the data axes, a reduce-scatter (the FSDP gather's
backward) for FSDP leaves. xLSTM (the reference replicates its
parameters), and every family on a mesh whose ``model`` axis is 1, take the
gathered step instead: each
data index gathers the full parameters onto its first device and runs
``loss_and_grads`` there, and the gradients are averaged over the data
indices in index order (``collectives.all_reduce``). Then the pod sync, if
on (on the full gradients: the split step's slices are gathered first);
then each mesh coordinate updates its own slices of the parameters and of
the fp32 moments (``optimizer.adamw_update``). The loss is the mean over
the data indices. MoE layers dispatch in groups of ``moe.GROUP_SIZE``
tokens, with capacity and the aux loss per group, so a split keeps the
single-device result only where each data index's tokens are a whole
number of the global group; elsewhere the step raises (GSPMD has no such
limit: ROADMAP Queue 3).

The reference jits and donates; the port runs eagerly and updates the
parameters and moments in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.sharding import ShardedTensor
from repro_torch.launch import op_walk
from repro_torch.models import model as M
from repro_torch.models.moe import GROUP_SIZE
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         init_opt_state, leaves, tree_map)


@dataclasses.dataclass
class TrainConfig:
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    accum: int = 1                 # microbatch gradient accumulation
    compress: str = "none"         # none | bf16 | int8 (cross-pod sync)
    remat: bool = True
    ckpt_dir: str = ""
    ckpt_every: int = 100
    tp: int = 16
    # the reference's optimized train variants, on the tensor-parallel
    # step (``models.model.forward_tp``): the Megatron-SP residual
    # (``set_sp_residual``) and the MoE's shard-local expert dispatch
    # (``set_ep_constraint``); off, as the reference's CLI leaves them
    sp: bool = False
    ep_local: bool = False


def _unflatten(like, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def loss_and_grads(params, cfg: ArchConfig, tc: TrainConfig, batch):
    """(loss, grads) of one step's batch, before the optimizer. With accum >
    1 the batch's leading axis is [accum, mb, S]: the microbatches run in
    turn (the twin of the reference's ``lax.scan``) and the loss and the
    gradients (fp32) are their means. The parameter leaves are marked to
    require grad. A leaf the loss does not reach (the hybrid's unused shared
    pieces, experts no token is routed to) gets a zero gradient, as
    ``jax.grad`` gives it."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)

    def one(b):
        with torch.enable_grad():
            loss = M.train_loss(params, cfg, b, remat=tc.remat, tp=tc.tp)
            got = torch.autograd.grad(loss, ps, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(ps, got)]

    if tc.accum <= 1:
        loss, grads = one(batch)
        return loss, _unflatten(params, grads)
    loss = torch.zeros((), dtype=torch.float32, device=ps[0].device)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in ps]
    for i in range(tc.accum):
        l, g = one({k: v[i] for k, v in batch.items()})
        loss = loss + l / tc.accum
        for a, gi in zip(acc, g):
            a += gi / tc.accum
    return loss, _unflatten(params, acc)


def placed_mesh(params):
    """The mesh a parameter tree is placed on (None: not sharded)."""
    for p in leaves(params):
        if isinstance(p, ShardedTensor):
            return p.sharding.mesh
    return None


# the batch dim of each train input, where ``batch_specs`` cuts it
BATCH_DIMS = {"tokens": 0, "labels": 0, "positions3": 1, "img_embeds": 0}


def data_parts(batch, cfg: ArchConfig, tc: TrainConfig, mesh) -> List[Dict]:
    """The batch cut over the mesh's data axes as ``batch_specs`` cuts it,
    one part per data index; the whole batch as the one part when it does
    not divide. An input ``batch_specs`` does not name for the arch (vlm
    smoke configs have no ``vision_stub`` frontend, yet take
    ``img_embeds``) is cut on its batch dim all the same: GSPMD slices a
    replicated input to the rows each device computes. With accum > 1 the
    cut dims sit one further right (the leading axis is the
    microbatch's). Raises where the cut would split an MoE dispatch
    group."""
    lead = 1 if tc.accum > 1 else 0
    B, S = batch["tokens"].shape[lead:lead + 2]
    specs = sharding.batch_specs(cfg, ShapeConfig("step", S, B, "train"),
                                 mesh)
    if specs["tokens"][0] is None:
        return [batch]
    dp = sharding.data_ways(mesh)
    group = min(GROUP_SIZE, B * S)
    if cfg.n_experts and (B // dp) * S % group:
        raise ValueError(
            f"{cfg.name}: {dp} data ways give each a batch of {B // dp} x "
            f"{S} = {(B // dp) * S} tokens, no whole number of the "
            f"{group}-token MoE dispatch group of the {B} x {S} batch: "
            f"capacity and the aux loss would differ from one device's")
    parts = [{} for _ in range(dp)]
    for k, v in batch.items():
        spec = specs.get(k)
        dim = lead + (BATCH_DIMS[k] if spec is None else
                      next(i for i, e in enumerate(spec) if e is not None))
        n = v.shape[dim] // dp
        for d in range(dp):
            parts[d][k] = v.narrow(dim, d * n, n)
    return parts


def splits_model(cfg: ArchConfig, mesh) -> bool:
    """Whether the sharded step splits compute over the mesh's ``model``
    axis: the transformer families and the hybrid on a ``model`` axis >
    1."""
    return (mesh.shape.get(sharding.MODEL_AXIS, 1) > 1
            and not cfg.xlstm_pattern)


def _gathered_loss_and_grads(params, cfg, tc, batch, mesh):
    """Each data index gathers the full parameters onto its first device
    (blocks from its own coordinates first) and runs its part of the batch;
    the loss and the gradients are their mean over the data indices, on the
    mesh's first coordinate's device."""
    groups = sharding.model_groups(mesh)
    losses, grads = [], []
    for d, part in enumerate(data_parts(batch, cfg, tc, mesh)):
        dev = mesh.device(groups[d][0])
        own = set(groups[d])
        order = groups[d] + [i for i in range(mesh.size) if i not in own]
        full = tree_map(lambda p: p.full(dev, order)
                        if isinstance(p, ShardedTensor) else p.to(dev),
                        params)
        loss, g = loss_and_grads(full, cfg, tc,
                                 {k: v.to(dev) for k, v in part.items()})
        del full
        losses.append(loss)
        grads.append(leaves(g))
    reduced = []
    for i in range(len(grads[0])):
        reduced.append(collectives.all_reduce([g[i] for g in grads],
                                              "mean"))
        for g in grads:
            g[i] = None
    return collectives.all_reduce(losses, "mean"), _unflatten(params, reduced)


def _differentiated(ps, mesh, d: int):
    """(leaf index, coordinate) of every shard data index ``d``'s model
    group differentiates: its own coordinates' shards, and an FSDP leaf's
    shards on every coordinate (its gathers read them all)."""
    own = sharding.model_groups(mesh)[d]
    return [(i, c) for i, x in enumerate(ps)
            for c in (own if sharding.fsdp_dim(x) is None
                      else range(mesh.size))]


def _tp_group_grads(params, cfg, tc, part, mesh, d: int):
    """Data index ``d``'s tensor-parallel (loss, {(leaf, coordinate):
    gradient of that shard}), its microbatches in turn with accum > 1 (the
    loss and the gradients, fp32, their means)."""
    ps = leaves(params)
    group = sharding.group_view(params, mesh, d)
    pairs = _differentiated(ps, mesh, d)
    ts = [ps[i].shards[c] for i, c in pairs]
    for t in ts:
        t.requires_grad_(True)
    dev = mesh.device(sharding.model_groups(mesh)[d][0])
    part = {k: v.to(dev) for k, v in part.items()}

    def one(b):
        with torch.enable_grad():
            loss = M.train_loss_tp(group, cfg, b, remat=tc.remat, tp=tc.tp,
                                   sp=tc.sp, ep_local=tc.ep_local)
            got = torch.autograd.grad(loss, ts, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(ts, got)]

    try:
        if tc.accum <= 1:
            loss, grads = one(part)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = [torch.zeros(t.shape, dtype=torch.float32,
                                 device=t.device) for t in ts]
            for k in range(tc.accum):
                l, g = one({n: v[k] for n, v in part.items()})
                loss = loss + l / tc.accum
                for a, gi in zip(grads, g):
                    a += gi / tc.accum
    finally:
        for t in ts:
            t.requires_grad_(False)
    return loss, dict(zip(pairs, grads))


def _reduce_tp_grads(ps, mesh, per_d, n_parts: int):
    """Per leaf, its gradient's shards: ``per_d[d]`` is data index d's
    {(leaf, coordinate): gradient}. A leaf replicated over
    ``model`` first sums its copies over the model group; then the data
    indices' gradients are averaged onto each owner: the ring all-reduce
    over the data group (a copy from data index 0 when the batch was not
    split), or, for an FSDP leaf, the sum of the contributions its
    coordinate received (the gather's backward sent them there)."""
    mgroups, dgroups = sharding.model_groups(mesh), sharding.data_groups(mesh)
    out = []
    for i, x in enumerate(ps):
        shards = [None] * mesh.size
        rep = sharding.cut_dim(x, (sharding.MODEL_AXIS,)) is None
        if sharding.fsdp_dim(x) is None:
            for d in range(n_parts):
                gs = [per_d[d][(i, c)] for c in mgroups[d]]
                if rep and len(gs) > 1:
                    gs = collectives.ring_all_reduce(gs)
                for c, g in zip(mgroups[d], gs):
                    shards[c] = g
            for dg in dgroups:
                if n_parts > 1:
                    red = collectives.ring_all_reduce([shards[c] for c in dg],
                                                      "mean")
                else:
                    with op_walk.collective("collective-permute"):
                        red = [shards[dg[0]].to(mesh.device(c)) for c in dg]
                for c, g in zip(dg, red):
                    shards[c] = g
        else:
            for c in range(mesh.size):
                acc = None
                for g in per_d[:n_parts]:
                    acc = (g[(i, c)].to(torch.float32, copy=True)
                           if acc is None else acc + g[(i, c)].float())
                shards[c] = (acc / n_parts).to(per_d[0][(i, c)].dtype)
            if rep:
                for mg in mgroups:
                    for c, g in zip(mg, collectives.ring_all_reduce(
                            [shards[c] for c in mg])):
                        shards[c] = g
        out.append(ShardedTensor(shards, x.sharding, x.shape,
                                 shards[0].dtype))
    return out


def sharded_loss_and_grads(params, cfg: ArchConfig, tc: TrainConfig, batch,
                           mesh):
    """``loss_and_grads`` of a sharded parameter tree -> (the loss, the mean
    over the data indices, on the mesh's first coordinate's device; the
    gradients): with ``splits_model``, a tree of ``ShardedTensor``
    gradients placed like the parameters (the tensor-parallel step), else
    full gradients on the first coordinate's device (the gathered step)."""
    if not splits_model(cfg, mesh):
        return _gathered_loss_and_grads(params, cfg, tc, batch, mesh)
    ps = leaves(params)
    if not all(isinstance(p, ShardedTensor) for p in ps):
        raise ValueError("the tensor-parallel step needs every parameter "
                         "placed on the mesh (sharding.device_put)")
    parts = data_parts(batch, cfg, tc, mesh)
    losses, per_d = [], []
    for d, part in enumerate(parts):
        loss, g = _tp_group_grads(params, cfg, tc, part, mesh, d)
        losses.append(loss)
        per_d.append(g)
    grads = _reduce_tp_grads(ps, mesh, per_d, len(parts))
    del per_d
    return (collectives.all_reduce(losses, "mean"),
            _unflatten(params, grads))


def make_train_step(cfg: ArchConfig, tc: TrainConfig, mesh=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, stats), the params
    and moments updated in place. stats: loss, lr, grad_norm. Parameters
    placed on a mesh (``sharding.device_put``) take the sharded step;
    ``mesh`` with a ``pod`` axis of size > 1 turns on the compressed pod
    sync when ``tc.compress`` asks for it."""
    pod_sync = (tc.compress != "none" and mesh is not None
                and "pod" in mesh.shape and mesh.shape["pod"] > 1)

    def step_fn(params, opt_state: OptState, batch):
        placed = placed_mesh(params)
        if placed is None:
            loss, grads = loss_and_grads(params, cfg, tc, batch)
        else:
            loss, grads = sharded_loss_and_grads(params, cfg, tc, batch,
                                                 placed)
        residual = opt_state.residual
        if pod_sync:
            grads = sharding.gather(grads)
            grads, residual = collectives.compressed_grads_with_feedback(
                grads, residual, tc.compress)
            if tc.compress == "bf16":
                grads = tree_map(lambda g: g.to(torch.bfloat16).float(),
                                 grads)
        params, opt_state, stats = adamw_update(
            grads, opt_state._replace(residual=residual), params, tc.opt)
        stats["loss"] = loss
        return params, opt_state, stats

    return step_fn


class Trainer:
    def __init__(self, cfg: ArchConfig, tc: TrainConfig, params, mesh=None):
        self.cfg, self.tc = cfg, tc
        self.params = params
        self.opt_state = init_opt_state(params, tc.compress)
        self.step_fn = make_train_step(cfg, tc, mesh)
        self.step = 0
        self.mesh = mesh
        if tc.ckpt_dir:
            last = ckpt.latest_step(tc.ckpt_dir)
            if last is not None:
                self.restore(last)

    def train_step(self, batch) -> Dict[str, float]:
        self.params, self.opt_state, stats = self.step_fn(
            self.params, self.opt_state, batch)
        self.step += 1
        if self.tc.ckpt_dir and self.step % self.tc.ckpt_every == 0:
            self.save()
        return {k: float(v) for k, v in stats.items()}

    def save(self):
        ckpt.save(self.tc.ckpt_dir, self.step,
                  {"params": self.params, "m": self.opt_state.m,
                   "v": self.opt_state.v},
                  extra={"opt_step": int(self.opt_state.step)})

    def emergency_save(self):
        """Preemption / straggler-eviction hook (atomic, safe to call
        anytime)."""
        if self.tc.ckpt_dir:
            self.save()

    def restore(self, step: int):
        """Copies the checkpoint into the parameters and moments in place:
        into each slice of a sharded tree, whatever mesh wrote it."""
        like = {"params": self.params, "m": self.opt_state.m,
                "v": self.opt_state.v}
        tree = ckpt.restore(self.tc.ckpt_dir, step, like)
        for dst, src in zip(leaves(like), leaves(tree)):
            sharding.copy_(dst, src)
        man = ckpt.read_manifest(self.tc.ckpt_dir, step)
        self.opt_state = self.opt_state._replace(
            step=int(man["extra"].get("opt_step", step)))
        self.step = step
