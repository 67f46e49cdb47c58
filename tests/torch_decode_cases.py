"""Shared by ``test_torch_decode_split.py`` and
``test_torch_decode_split_methods.py``: the decode split's smoke setup
(configs in both packages, seeded caches, the placed caches' shard check,
the one-device step's recorded page ids, the op walk that keeps the copies
between placeholder cards)."""
import numpy as np
import torch

from repro.configs import get_arch as jget_arch
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops
from repro_torch.launch import op_walk
from repro_torch.models import model as M
from repro_torch.train.optimizer import leaves

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
HYBRID_TAIL = {"n_layers": 3, "shared_attn_every": 2}   # a 1-layer tail
LOGIT_TOL, CACHE_TOL, JAX_TOL = 2e-5, 1e-5, 1e-4
S, CTX, STEPS, PAGE = 64, 37, 4, 4


def _cfgs(arch, kw):
    return (jget_arch(arch).smoke().replace(dtype="float32", **kw),
            get_arch(arch).smoke().replace(dtype="float32", **kw))


def _cache(cfg, B, seed=0, ctx=CTX):
    """k / v [L, B, S, KV, hd] from a numpy seed, zero past ``ctx``
    tokens."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    k[:, :, ctx:] = 0
    v[:, :, ctx:] = 0
    return k, v


def _caches(cfg, B, seed=0, ctx=CTX):
    """A cache tree of numpy arrays from a seed: a transformer's k / v
    (``_cache``); the hybrid's ``make_cache`` tree, shared_k / shared_v
    zero past ``ctx`` tokens, every recurrent state drawn."""
    if cfg.family != "hybrid":
        k, v = _cache(cfg, B, seed, ctx)
        return {"k": k, "v": v}
    rng = np.random.default_rng(seed)
    draw = lambda t: rng.standard_normal(tuple(t.shape)).astype(np.float32)
    out = {}
    for name, t in M.make_cache(cfg, B, S, device="cpu").items():
        if name != "length":
            out[name] = tuple(map(draw, t)) if isinstance(t, tuple) \
                else draw(t)
    for name in ("shared_k", "shared_v"):
        out[name][:, :, ctx:] = 0
    return out


def _tree(c, fn):
    return {k: tuple(map(fn, v)) if isinstance(v, tuple) else fn(v)
            for k, v in c.items()}


def _shards_agree(c2, c1):
    """Every shard of every placed cache leaf (K / V, the hybrid's SSM and
    conv states) within CACHE_TOL of its slice of one device's."""
    for x, want in zip(leaves(c2), leaves(c1)):
        if isinstance(x, sh.ShardedTensor):
            assert tuple(x.shape) == tuple(want.shape)
            for s_, sl in zip(x.shards, x.slices):
                if s_.numel():
                    assert float((s_ - want[sl]).abs().max()) <= CACHE_TOL


class _Recorded:
    """``ops.paged_decode_attention`` recording the page ids of the
    one-device step's calls (the split records its own merged ids)."""

    def __init__(self, monkeypatch):
        self.pages, self.on = [], False
        real = ops.paged_decode_attention

        def rec(q, kc, vc, page_ids, length, **kw):
            if self.on:
                self.pages.append(page_ids.clone())
            return real(q, kc, vc, page_ids, length, **kw)
        monkeypatch.setattr(ops, "paged_decode_attention", rec)


def _sorted_pages(p):
    return torch.sort(p.long(), dim=1).values


class _Copies(op_walk.OpWalk):
    """An op walk that also keeps every copy between two cards (its
    receiving card, shape and bytes) and the shape of every tensor an op
    makes on a card."""

    def __init__(self):
        super().__init__()
        self.copies, self.shapes = [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for t in torch.utils._pytree.tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and op_walk.device_of(t) \
                    .startswith("cuda"):
                self.shapes.add(tuple(t.shape))
        if func is torch.ops.aten._to_copy.default:
            src, dst = op_walk.device_of(args[0]), op_walk.device_of(out)
            if src != dst and src.startswith("cuda"):
                self.copies.append((dst, tuple(out.shape),
                                    op_walk.nbytes(out)))
        return out
