"""Training loop (twin of ``repro.train.trainer``): a train step with
per-layer remat, microbatch gradient accumulation, and checkpoint / restart.

Fault tolerance: the Trainer saves every ``ckpt_every`` steps (atomic),
restores the latest checkpoint on construction, and exposes
``emergency_save`` for the launcher's signal handler.

``compress`` is accepted and, as in the reference on one device, has no
effect: the reference compresses only its cross-pod gradient sync, which
needs a mesh with a ``pod`` axis. The port's collectives wait for ROADMAP
Queue 1 item 10b. The reference jits and donates; the port runs eagerly and
updates the parameters and moments in place (``optimizer.adamw_update``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.models import model as M
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         init_opt_state, leaves)


@dataclasses.dataclass
class TrainConfig:
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    accum: int = 1                 # microbatch gradient accumulation
    compress: str = "none"         # none | bf16 | int8 (cross-pod sync)
    remat: bool = True
    ckpt_dir: str = ""
    ckpt_every: int = 100
    tp: int = 16


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


def make_train_step(cfg: ArchConfig, tc: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, stats), the params
    and moments updated in place. stats: loss, lr, grad_norm."""

    def step_fn(params, opt_state: OptState, batch):
        loss, grads = loss_and_grads(params, cfg, tc, batch)
        params, opt_state, stats = adamw_update(grads, opt_state, params,
                                                tc.opt)
        stats["loss"] = loss
        return params, opt_state, stats

    return step_fn


class Trainer:
    def __init__(self, cfg: ArchConfig, tc: TrainConfig, params):
        self.cfg, self.tc = cfg, tc
        self.params = params
        self.opt_state = init_opt_state(params, tc.compress)
        self.step_fn = make_train_step(cfg, tc)
        self.step = 0
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
        like = {"params": self.params, "m": self.opt_state.m,
                "v": self.opt_state.v}
        tree = ckpt.restore(self.tc.ckpt_dir, step, like)
        with torch.no_grad():
            for dst, src in zip(leaves(like), leaves(tree)):
                dst.copy_(src)
        man = ckpt.read_manifest(self.tc.ckpt_dir, step)
        self.opt_state = self.opt_state._replace(
            step=int(man["extra"].get("opt_step", step)))
        self.step = step
