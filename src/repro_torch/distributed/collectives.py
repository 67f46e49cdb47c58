"""Distributed-optimization helpers (twin of
``repro.distributed.collectives``): compressed gradient sync with error
feedback, the ring-collective cost formulas, and the in-process collectives
the sharded train step, its tensor-parallel split and GPipe run on.

Cross-pod DP links are the scarcest bandwidth at scale; compressing the
gradient all-reduce (bf16 or int8 + error feedback) cuts the collective term
proportionally while error feedback keeps convergence unbiased in the long
run (Karimireddy et al., arXiv:1901.09847).

The in-process collectives take one tensor per participant (each on its
participant's device) and reduce in participant order, accumulating in
fp32, so a run is bit-reproducible. ``all_reduce`` sums onto the first
participant, for a caller that needs the one result (the gathered step).
``ring_all_reduce`` is a reduce-scatter of one chunk per participant
followed by an all-gather, for callers whose every participant needs the
result (the tensor-parallel step's gradients): each participant sends and
receives 2 (n-1)/n of the tensor's bytes, as ``all_reduce_seconds``
reckons. ``all_to_all`` turns the tensor-parallel prefill's caches (a
member's kv heads over the whole sequence) into the decode split's (every
kv head over a member's sequence slice). The group operations of the
tensor-parallel split (``group_broadcast``, ``group_all_reduce``,
``group_all_gather``, ``group_reduce_scatter``) are ``autograd.Function``s
over the members' tensors; each backward is the exact adjoint of its
forward (a broadcast's is a sum onto the source, an all-reduce's an
all-reduce, an all-gather's a reduce-scatter and a reduce-scatter's an
all-gather), so one scalar loss taken on one member differentiates
through the whole group. Each labels its copies between devices for an op
walk (``launch.op_walk.collective``), in the backward too.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core.placement import NVLINK_BW
from repro_torch.launch.op_walk import collective, placing


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization -> (q, scale); rounds half to
    even, as ``jnp.round``."""
    scale = g.abs().max().float() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_grads_with_feedback(grads, residual, mode: str = "bf16"):
    """Lossy compression of a gradient tree (nested dicts) with error
    feedback -> (decompressed grads in the gradients' dtype, new fp32
    residual). mode: 'none' | 'bf16' | 'int8'. ``residual=None`` starts from
    zeros."""
    if mode == "none":
        return grads, residual
    if mode not in ("bf16", "int8"):
        raise ValueError(f"compress mode {mode!r}: none | bf16 | int8")
    if residual is None:
        residual = _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)

    def one(g, r):
        gf = g.float() + r
        if mode == "bf16":
            back = gf.to(torch.bfloat16).float()
        else:
            back = decompress_int8(*compress_int8(gf))
        return back.to(g.dtype), gf - back

    pairs = _map(one, grads, residual)
    return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and the same paths of
    ``rest``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# analytic collective costs (ring algorithms) — napkin-math utilities
# ---------------------------------------------------------------------------


def all_reduce_seconds(bytes_per_dev: float, n: int, links: float = NVLINK_BW):
    """Ring all-reduce: 2 (n-1)/n * bytes over the slowest link."""
    return 2.0 * (n - 1) / max(n, 1) * bytes_per_dev / links


def all_gather_seconds(bytes_per_dev: float, n: int, links: float = NVLINK_BW):
    return (n - 1) / max(n, 1) * bytes_per_dev * n / links


def reduce_scatter_seconds(bytes_per_dev: float, n: int,
                           links: float = NVLINK_BW):
    return (n - 1) / max(n, 1) * bytes_per_dev / links


def all_to_all_seconds(bytes_per_dev: float, n: int,
                       links: float = NVLINK_BW):
    """All-to-all: each participant keeps 1/n of its tensor and sends the
    other (n-1)/n, one block to each peer."""
    return (n - 1) / max(n, 1) * bytes_per_dev / links


# ---------------------------------------------------------------------------
# in-process collectives over one mesh axis
# ---------------------------------------------------------------------------


def _sizes(n: int, parts: int) -> List[int]:
    """``torch.tensor_split``'s sizes: n cut into ``parts`` near-equal
    blocks, the first n % parts one longer."""
    return [n // parts + (i < n % parts) for i in range(parts)]


def _reduce_blocks(xs: Sequence[torch.Tensor], dim: int, sizes, devices,
                   op: str = "sum") -> List[torch.Tensor]:
    """Block k of dim ``dim`` (``sizes[k]`` long) reduced over the
    participants onto ``devices[k]``: each block copied there in the inputs'
    dtype, accumulated in fp32 (fp64 inputs in fp64) in participant order,
    cast back."""
    outs, off = [], 0
    acc_dt = torch.promote_types(xs[0].dtype, torch.float32)
    for size, dev in zip(sizes, devices):
        acc = None
        for x in xs:
            part = x.narrow(dim, off, size).to(dev)
            if acc is None:
                acc = part.to(acc_dt, copy=True)
            elif op == "max":
                torch.maximum(acc, part.to(acc_dt), out=acc)
            else:
                acc += part.to(acc_dt)
        if op == "mean":
            acc /= len(xs)
        outs.append(acc.to(xs[0].dtype))
        off += size
    return outs


def _gather_blocks(blocks: Sequence[torch.Tensor], dim: int, devices
                   ) -> List[torch.Tensor]:
    """The blocks concatenated on ``dim``, one copy on each of ``devices``
    (a block already there is not copied; members that share a device
    share its copy, as views)."""
    made = {}
    out = []
    for dev in devices:
        if dev not in made:
            made[dev] = torch.cat([b.to(dev) for b in blocks], dim)
        out.append(made[dev].view_as(made[dev]))
    return out


def ring_all_reduce(xs: Sequence[torch.Tensor], op: str = "sum"
                    ) -> List[torch.Tensor]:
    """The sum (mean, max) of the participants' equal-shaped tensors, one
    copy on each participant's device: the flattened tensors are cut into
    one chunk per participant, participant k reduces chunk k (fp32, in
    participant order, so every element equals the index-order sum), then
    every participant gathers the reduced chunks. Participants that all
    share one device, where a ring moves nothing, reduce the same sums as
    one chunk and share the result (as views)."""
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"ring_all_reduce op {op!r}: sum | mean | max")
    n = len(xs)
    devs = [x.device for x in xs]
    flat = [x.reshape(-1) for x in xs]
    one = len(set(devs)) == 1
    with collective("all-reduce"):
        chunks = _reduce_blocks(
            flat, 0, [flat[0].numel()] if one else _sizes(flat[0].numel(), n),
            devs[:1] if one else devs, op)
        outs = _gather_blocks(chunks, 0, devs)
    return [o.view(xs[0].shape) for o in outs]


def all_reduce(xs: Sequence[torch.Tensor], op: str = "sum") -> torch.Tensor:
    """Sum (or mean) of the participants' tensors on the first participant's
    device: accumulated in fp32 in participant order, then cast to the
    inputs' dtype. For a caller that needs the one result; where every
    participant needs it, ``ring_all_reduce``."""
    if op not in ("sum", "mean"):
        raise ValueError(f"all_reduce op {op!r}: sum | mean")
    acc = xs[0].to(torch.float32, copy=True)
    with collective("all-reduce"):
        for x in xs[1:]:
            acc += x.to(acc.device, torch.float32)
    if op == "mean":
        acc /= len(xs)
    return acc.to(xs[0].dtype)


def reduce_scatter(xs: Sequence[torch.Tensor], dim: int, sizes=None,
                   devices=None) -> List[torch.Tensor]:
    """Block k of ``dim`` summed over the participants onto ``devices[k]``
    (default: participant k's device; ``sizes``: equal blocks, one per
    participant), in fp32 in participant order, cast back."""
    devices = list(devices) if devices is not None else [x.device
                                                         for x in xs]
    if sizes is None:
        sizes = _sizes(xs[0].shape[dim], len(devices))
    with collective("reduce-scatter"):
        return _reduce_blocks(xs, dim, sizes, devices)


def _grads(ctx, gs):
    """A backward's output gradients, an unused output's as zeros on its
    own device (autograd would make them where it last ran, which under
    placeholders is not that output's card)."""
    with placing():
        return [torch.zeros(shape, dtype=dt, device=dev) if g is None else g
                for g, (shape, dt, dev) in zip(gs, ctx.outs)]


def _saw_outputs(ctx, outs):
    ctx.set_materialize_grads(False)
    ctx.outs = [(o.shape, o.dtype, o.device) for o in outs]
    return tuple(outs)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.device = x.device
        with collective("collective-permute"):
            return _saw_outputs(ctx, [x.to(d) for d in devices])

    @staticmethod
    def backward(ctx, *gs):
        flat = [g.reshape(-1) for g in _grads(ctx, gs)]
        out = reduce_scatter(flat, 0, [flat[0].numel()], [ctx.device])
        return out[0].view(ctx.outs[0][0]), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        return _saw_outputs(ctx, ring_all_reduce(xs))

    @staticmethod
    def backward(ctx, *gs):
        return tuple(ring_all_reduce(_grads(ctx, gs)))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *xs):
        ctx.dim, ctx.devices = dim, [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        with collective("all-gather"):
            return _saw_outputs(ctx, _gather_blocks(xs, dim, devices))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(reduce_scatter(
            _grads(ctx, gs), ctx.dim, ctx.sizes, ctx.devices))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim = dim
        return _saw_outputs(ctx, reduce_scatter(xs, dim))

    @staticmethod
    def backward(ctx, *gs):
        gs = _grads(ctx, gs)
        with placing(), collective("all-gather"):
            return (None,) + tuple(_gather_blocks(gs, ctx.dim,
                                                  [g.device for g in gs]))


def group_broadcast(x: torch.Tensor, devices) -> List[torch.Tensor]:
    """One copy of ``x`` on each of ``devices`` (forward: a copy; backward:
    the copies' gradients summed onto ``x``'s device in member order)."""
    return list(_Broadcast.apply(x, list(devices)))


def group_all_reduce(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The row-parallel partials summed onto every member (forward: a ring
    all-reduce; backward: the ring all-reduce of the outputs' gradients,
    since each partial reaches every member's sum). One member alone gets
    its tensor back."""
    if len(xs) == 1:
        return list(xs)
    return list(_AllReduce.apply(*xs))


def group_all_gather(xs: Sequence[torch.Tensor], dim: int, devices=None
                     ) -> List[torch.Tensor]:
    """The members' slices concatenated on ``dim``, one copy on each of
    ``devices`` (default: each member's own device). Backward: each
    member's slice of the copies' gradients, summed over the copies onto
    its device (a reduce-scatter)."""
    devices = [x.device for x in xs] if devices is None else list(devices)
    if len(xs) == 1 and devices == [xs[0].device]:
        return list(xs)
    return list(_AllGather.apply(dim, devices, *xs))


def group_reduce_scatter(xs: Sequence[torch.Tensor], dim: int
                         ) -> List[torch.Tensor]:
    """Member k's block of ``dim`` (``torch.tensor_split``'s sizes) of the
    sum of the members' equal-shaped partials, on its own device: summed in
    fp32 in member order and cast back, so each element equals the
    index-order sum ``group_all_reduce`` gives. Backward: the blocks'
    gradients all-gathered onto every member (each partial reaches every
    block). One member alone gets its tensor back."""
    if len(xs) == 1:
        return list(xs)
    return list(_ReduceScatter.apply(dim, *xs))


def group_max(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise max over the members onto every member, without a
    gradient (a softmax's stabilizer)."""
    with torch.no_grad():
        return ring_all_reduce([x.detach() for x in xs], "max")


def all_to_all(xs: Sequence[torch.Tensor], split_dim: int, cat_dim: int,
               devices=None) -> List[torch.Tensor]:
    """Twin of ``lax.all_to_all``: each participant's tensor cut into one
    equal block per destination on ``split_dim``; destination j gets block
    j of every participant, concatenated on ``cat_dim`` in participant
    order, on ``devices[j]`` (default: the participants' own devices).
    Each participant sends the blocks of the others, (n - 1) / n of its
    tensor when the destinations are the participants; a block already on
    its destination's device is not copied."""
    devices = [x.device for x in xs] if devices is None else list(devices)
    n = len(devices)
    if xs[0].shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of "
                         f"{tuple(xs[0].shape)} does not split {n} ways")
    blocks = [torch.chunk(x, n, split_dim) for x in xs]
    with collective("all-to-all"):
        return [torch.cat([b[j].to(dev) for b in blocks], cat_dim)
                for j, dev in enumerate(devices)]


def ring_shift(xs: Sequence[torch.Tensor], shift: int = 1
               ) -> List[torch.Tensor]:
    """Twin of ``lax.ppermute`` with pairs (i, (i + shift) % n): participant
    (i + shift) % n receives participant i's tensor, on its own device."""
    n = len(xs)
    out = [None] * n
    with collective("collective-permute"):
        for i, x in enumerate(xs):
            j = (i + shift) % n
            out[j] = x.to(xs[j].device)
    return out
