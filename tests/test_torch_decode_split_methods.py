"""Seer (top-k and threshold) and LServe over a sequence-split KV cache:
``models.model.decode_step_tp`` with ``core.methods.split_sparse``
(``seer.SplitSeer``, ``lserve.SplitLServe``) on meshes of CPU entries, each
(data, model) coordinate holding its ``cache_specs`` slice of K/V.

Each case (llama with kv heads sharded and replicated, a data axis, the
long_500k layout, a ``pod`` axis, granite expert-parallel, the Mamba2
hybrid in both layouts, a cache with fewer blocks than the selection takes,
a cache whose keys are zero in most blocks, so that most scores tie at 0)
runs for each method 4 greedy fp32 steps from a seeded cache (smoke
configs, 4-token blocks, LServe's physical pages of 2 blocks: every shard
holds several blocks and whole physical pages), held
- against the port's one-device ``decode_step`` with the method's
  ``make_sparse_fn`` at the same weights and cache: logits within 2e-5 abs,
  the selected block / page ids equal, each shard's cache slice (the
  hybrid's states too) within 1e-5 abs of its slice of one device's,
  greedy tokens equal (``tests/test_torch_decode_split.py``'s
  tolerances);
- against the JAX package's jitted ``decode_step`` with the reference's
  ``make_sparse_fn`` (its Pallas kernels in interpret mode): 1e-4.

Also: ``topk.merge_shard_topk`` against one device's stable top-k over the
concatenated scores (ties across shard boundaries, -inf padding, delivered
ids); LServe refuses a shard slice that is not whole physical pages; only
DSA has a stateful split; Seer raises with dead TP heads, as the reference
does; a hybrid with no shared-block site prefills (``prefill``,
``prefill_tp``) and decodes with zero-length stacks equal to the JAX
package's; on placeholder cards each card's K/V is its 1/n of the sequence
and the bytes that cross are only the named small tensors, to the byte; in
a subprocess with 4 host devices the reference's jitted ``decode_step``
under ``cache_specs`` (GSPMD) gives the split's logits within 1e-4, llama's
and zamba2's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.methods import get_sparse_method as jget_method  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.methods import (get_sparse_method, lserve,  # noqa: E402
                                      seer, split_sparse)
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import topk  # noqa: E402
from repro_torch.kernels import page_pool, ref  # noqa: E402
from repro_torch.launch import op_walk  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

from torch_decode_cases import (AXES, CTX, HYBRID_TAIL, JAX_TOL,  # noqa: E402
                                LOGIT_TOL, STEPS, S, _caches, _cfgs,
                                _Copies, _Recorded, _shards_agree,
                                _sorted_pages, _tree)

torch.set_num_threads(2)
# 4-token blocks: 16 in the 64-token cache, 4 selected by Seer; LServe's
# physical pages of 2 blocks, 2 selected; a shard of 16 tokens holds 4
# blocks, 2 physical pages
MEM = {"block_size": 4, "token_budget": 16, "pages_per_physical": 2}
METHODS = {"seer": {"method": "seer"},
           "seer-threshold": {"method": "seer", "selection": "threshold",
                              "threshold": 0.1},
           "lserve": {"method": "lserve"}}
# Seer's 32 blocks and LServe's 16 physical pages of the 16 / 8 there are
SMALL = {"token_budget": 128}
# the live keys zero but in blocks 5 and 8: every other block (past the
# context too) scores 0 and ties
TIE_BLOCKS = (5, 8)
# name: (arch, mesh shape, batch, config changes, memory changes, cache)
CASES = {
    "llama-1x2-kv-sharded": ("llama3.2-1b", (1, 2), 2, {}, {}, "seeded"),
    "llama-1x4-kv-replicated": ("llama3.2-1b", (1, 4), 2, {}, {},
                                "seeded"),
    "llama-2x2-data": ("llama3.2-1b", (2, 2), 4, {}, {}, "seeded"),
    "llama-long-2x2": ("llama3.2-1b", (2, 2), 1, {}, {}, "seeded"),
    "llama-pod-2x2x2": ("llama3.2-1b", (2, 2, 2), 4, {}, {}, "seeded"),
    "granite-1x4-expert-parallel": ("granite-moe-1b-a400m", (1, 4), 2, {},
                                    {}, "seeded"),
    "zamba2-2x2-data": ("zamba2-7b", (2, 2), 4, {}, {}, "seeded"),
    "zamba2-long-2x2": ("zamba2-7b", (2, 2), 1, HYBRID_TAIL, {}, "seeded"),
    "llama-small-cache-1x4": ("llama3.2-1b", (1, 4), 2, {}, SMALL,
                              "seeded"),
    "llama-ties-1x4": ("llama3.2-1b", (1, 4), 2, {}, {}, "ties"),
}


def _with_mem(cfg, method, mem_kw):
    return cfg.replace(memory=cfg.memory.replace(
        **{**MEM, **METHODS[method], **mem_kw}))


def _tied(npc):
    """Zero every live key outside ``TIE_BLOCKS`` (values kept)."""
    k = npc["k"]
    bs = MEM["block_size"]
    for t in range(CTX):
        if t // bs not in TIE_BLOCKS:
            k[:, :, t] = 0
    return npc


def _sp_init(jcfg, hybrid):
    """The method's weights from the JAX package's init: (numpy tree, the
    port's tree). The hybrid's one set (its sites share it)."""
    init, _ = jget_method(jcfg.memory.method)
    np_sp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(7), jcfg,
                                          jcfg.memory, stacked=not hybrid))
    return np_sp, from_jax_params(np_sp, "cpu")


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("case", list(CASES))
def test_split_method_matches_one_device_and_jax(case, method, monkeypatch):
    arch, shape, B, kw, mem_kw, kind = CASES[case]
    jcfg, tcfg = _cfgs(arch, kw)
    jcfg, tcfg = _with_mem(jcfg, method, mem_kw), _with_mem(tcfg, method,
                                                            mem_kw)
    tp = shape[-1]
    mesh = make_mesh(shape, AXES[len(shape)], devices=["cpu"])
    np_params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), tp=tp))
    one = from_jax_params(np_params, "cpu")
    placed = sh.device_put(from_jax_params(np_params, "cpu"),
                           sh.make_shardings(sh.param_specs(
                               one, tcfg, mesh), mesh))
    hybrid = tcfg.family == "hybrid"
    sites = M._hybrid_shape(tcfg)[0] if hybrid else tcfg.n_layers
    npc = _caches(tcfg, B)
    if kind == "ties":
        npc = _tied(npc)
    shp = ShapeConfig("decode", S, B, "decode")
    c1 = _tree(npc, lambda a: torch.from_numpy(a.copy()))
    c1["length"] = CTX
    c2 = _tree(npc, torch.from_numpy)
    c2 = sh.device_put(c2, sh.make_shardings(sh.cache_specs(
        c2, tcfg, shp, mesh), mesh))
    c2["length"] = CTX
    jc = _tree(npc, jnp.asarray)
    jc["length"] = jnp.asarray(CTX, jnp.int32)

    np_sp, sp1 = _sp_init(jcfg, hybrid)
    sp2 = sh.device_put(from_jax_params(np_sp, "cpu"), sh.make_shardings(
        sh.method_specs(sp1, tcfg, mesh), mesh))
    _, mk = get_sparse_method(tcfg.memory.method)
    sfn = mk(tcfg, tcfg.memory, tp=tp)
    split = split_sparse(tcfg, tcfg.memory, page=tcfg.memory.block_size,
                         record=True)
    assert type(split) is (seer.SplitSeer if method.startswith("seer")
                           else lserve.SplitLServe)
    _, jmk = jget_method(jcfg.memory.method)
    jfn = jmk(jcfg, jcfg.memory, tp=tp)
    jstep = jax.jit(lambda p, t, c, s: JM.decode_step(
        p, jcfg, t, c, tp=tp, sparse_fn=jfn, sparse_params=s))
    rec = _Recorded(monkeypatch)
    tok = np.random.default_rng(3).integers(0, tcfg.vocab_size, B) \
        .astype(np.int32)
    dropped = 0
    with torch.no_grad():
        for step in range(STEPS):
            t = torch.from_numpy(tok)
            rec.on, rec.pages = True, []
            l1, c1 = M.decode_step(one, tcfg, t, c1, tp=tp, sparse_fn=sfn,
                                   sparse_params=sp1)
            rec.on = False
            split.selected.clear()
            l2, c2 = M.decode_step_tp(placed, tcfg, t, c2, mesh, tp=tp,
                                      sparse=split, sparse_params=sp2)
            jl, jc = jstep(np_params, jnp.asarray(tok), jc, np_sp)
            assert l2.shape == (B, tcfg.padded_vocab)
            err = float((l2 - l1).abs().max())
            assert err <= LOGIT_TOL, (step, err)
            assert float(np.abs(l2.numpy() - np.asarray(jl)).max()) <= \
                JAX_TOL
            assert c2["length"] == c1["length"] == CTX + step + 1
            _shards_agree(c2, c1)
            # one selection a sequence group a site, the rows of each
            # data index in turn
            ng = len(sh.seq_groups(mesh, B))
            assert len(split.selected) == ng * sites
            assert len(rec.pages) == sites
            for i, want in enumerate(rec.pages):
                got = _sorted_pages(torch.cat(
                    split.selected[i * ng:(i + 1) * ng]))
                want = _sorted_pages(want)
                assert got.shape[1] >= want.shape[1] > 1
                assert torch.equal(got[:, -want.shape[1]:], want)
                assert (got[:, :-want.shape[1]] == -1).all()
                dropped += int((want == -1).sum())
            assert torch.equal(l2.argmax(-1), l1.argmax(-1))
            tok = l1.argmax(-1).numpy().astype(np.int32)
    if method == "seer-threshold":      # the threshold drops some blocks
        assert dropped > 0


# ---------------------------------------------------------------------------
# the merge, the slice rule, the stateful refusal, dead heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,n_local,k", [(4, 8, 5), (4, 2, 16), (3, 4, 4),
                                         (2, 6, 12)],
                         ids=["ties", "fewer-than-k", "k-per-shard",
                              "all-of-them"])
def test_merge_shard_topk_matches_one_device(n, n_local, k):
    """The merge of per-shard stable top-min(k, local) equals one device's
    stable top-k over the concatenated scores: values, indices (ties by
    ascending global index, across shard boundaries), padded with (-inf,
    -1) past the candidates there are; ``keep`` runs on the first device
    before the ids are delivered, one copy to each device."""
    rng = np.random.default_rng(n * 100 + k)
    # few distinct values: ties within and across the shards
    scores = torch.from_numpy(rng.integers(0, 3, (3, n * n_local))
                              .astype(np.float32))
    devices = [torch.device("cpu")] * n
    parts = scores.split(n_local, dim=1)
    vals, idx = topk.merge_shard_topk(
        lambda s, kl: ref.topk_stable(parts[s], kl), n_local, k, devices)
    want_v, want_i = ref.topk_stable(scores, min(k, n * n_local))
    m = want_v.shape[1]
    assert vals.shape == idx.shape == (3, k)
    assert torch.equal(vals[:, :m], want_v)
    assert torch.equal(idx[:, :m].long(), want_i.long())
    assert (vals[:, m:] == float("-inf")).all() and (idx[:, m:] == -1).all()
    _, got = topk.merge_shard_topk(
        lambda s, kl: ref.topk_stable(parts[s], kl), n_local, k, devices,
        deliver=devices, keep=lambda v, i: torch.where(v >= 1, i, -1))
    assert len(got) == n
    for g in got:
        assert torch.equal(g[:, :m].long(), torch.where(
            want_v >= 1, want_i, -1).long())


def test_dsa_topk_goes_through_the_merge(monkeypatch):
    """``distributed_relevancy_topk`` (SplitDSA's selection) is one call
    of ``merge_shard_topk``."""
    calls = []
    real = topk.merge_shard_topk
    monkeypatch.setattr(topk, "merge_shard_topk",
                        lambda *a, **kw: calls.append(a[1:3]) or
                        real(*a, **kw))
    g = torch.Generator().manual_seed(0)
    q, keys = torch.randn(2, 3, 8, generator=g), torch.randn(2, 32, 8,
                                                             generator=g)
    w = torch.rand(2, 3, generator=g)
    v, i = topk.distributed_relevancy_topk(q, keys, w, 6,
                                           [torch.device("cpu")] * 4)
    wv, wi = ref.relevancy_topk(q, keys, w, 6)
    assert calls == [(8, 6)]
    assert torch.equal(i.long(), wi.long()) and torch.allclose(v, wv)


def _split_setup(shape, B, mem_kw, n_heads=None):
    cfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    if n_heads:
        cfg = cfg.replace(n_heads=n_heads)
    cfg = cfg.replace(memory=cfg.memory.replace(**mem_kw))
    mesh = make_mesh(shape, AXES[2], devices=["cpu"])
    tp = shape[-1]
    p = M.init_params(cfg, 0, tp=tp, device="cpu")
    placed = sh.device_put(p, sh.make_shardings(sh.param_specs(p, cfg, mesh),
                                                mesh))
    init, _ = get_sparse_method(cfg.memory.method)
    sp = init(cfg, cfg.memory, 1, device="cpu")
    sp = sh.device_put(sp, sh.make_shardings(sh.method_specs(sp, cfg, mesh),
                                             mesh))
    c = {k: torch.from_numpy(a) for k, a in _caches(cfg, B).items()}
    c = sh.device_put(c, sh.make_shardings(sh.cache_specs(
        c, cfg, ShapeConfig("decode", S, B, "decode"), mesh), mesh))
    c["length"] = CTX
    return cfg, mesh, placed, sp, c


def test_lserve_refuses_a_shard_of_no_whole_physical_pages():
    """A physical page (block_size x pages_per_physical = 32 tokens here)
    would straddle two of four 16-token shards: LServe's split raises,
    naming the condition."""
    cfg, mesh, placed, sp, c = _split_setup(
        (1, 4), 2, {"method": "lserve", "block_size": 8,
                    "pages_per_physical": 4})
    split = split_sparse(cfg, cfg.memory, page=8)
    with pytest.raises(ValueError, match="physical page would straddle"):
        M.decode_step_tp(placed, cfg, torch.zeros(2, dtype=torch.int32), c,
                         mesh, tp=4, sparse=split, sparse_params=sp)


@pytest.mark.parametrize("method", ["seer", "lserve"])
def test_only_dsa_has_a_stateful_split(method):
    cfg = get_arch("llama3.2-1b").smoke()
    mem = cfg.memory.replace(method=method)
    with pytest.raises(ValueError, match="only DSA keeps an index cache"):
        split_sparse(cfg, mem, page=64, stateful=True)
    assert split_sparse(cfg, cfg.memory.replace(method="dsa"), page=64,
                        stateful=True).stateful


def test_seer_split_raises_with_dead_heads():
    """3 q heads padded to 4 at tp 4: the gate's product with the padded
    query raises on one device, in the reference as in the port, and in
    the split."""
    cfg, mesh, placed, sp, c = _split_setup((1, 4), 2, {"method": "seer"},
                                            n_heads=3)
    assert cfg.padded_heads(4) != cfg.n_heads
    q = torch.zeros(2, 1, cfg.padded_heads(4), cfg.hd)
    one_sp = seer.seer_init(cfg, cfg.memory, 1, stacked=False, device="cpu")
    with pytest.raises(RuntimeError):
        seer._gate_q(one_sp, q)
    split = split_sparse(cfg, cfg.memory, page=cfg.memory.block_size)
    with pytest.raises(RuntimeError):
        M.decode_step_tp(placed, cfg, torch.zeros(2, dtype=torch.int32), c,
                         mesh, tp=4, sparse=split, sparse_params=sp)


# ---------------------------------------------------------------------------
# the hybrid with no shared-block site
# ---------------------------------------------------------------------------

NO_SITE = {"n_layers": 1, "shared_attn_every": 2}


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("shape,B", [((1, 2), 2), ((2, 2), 4), ((2, 2), 1)],
                         ids=["1x2", "2x2-data", "long-2x2"])
def test_hybrid_without_a_site_prefills_and_decodes(shape, B):
    """zamba2 with 1 layer at every 2: no shared-block site, so the body's
    states and ``shared_k`` / ``shared_v`` are zero-length stacks, as the
    reference's scan returns them. ``prefill`` and one ``decode_step``
    equal the JAX package's (logits and every cache leaf, shapes and
    dtypes included); ``prefill_tp`` over each data index's group equals
    one device's, and its caches, resharded, decode with
    ``decode_step_tp`` as one device does."""
    jcfg, tcfg = _cfgs("zamba2-7b", NO_SITE)
    assert M._hybrid_shape(tcfg)[0] == 0
    tp = shape[-1]
    np_params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), tp=tp))
    one = from_jax_params(np_params, "cpu")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, 32)) \
        .astype(np.int32)
    jl, jc = JM.prefill(np_params, jcfg, jnp.asarray(toks), max_len=S, tp=tp)
    with torch.no_grad():
        l1, c1 = M.prefill(one, tcfg, torch.from_numpy(toks), max_len=S,
                           tp=tp)
    assert float(np.abs(l1.numpy() - np.asarray(jl)).max()) <= JAX_TOL

    def same(tc, jtree):
        want = {k: v for k, v in jtree.items() if k != "length"}
        got = [x for k in sorted(want) for x in jax.tree.leaves(tc[k])]
        ref_ = [x for k in sorted(want) for x in _np_leaves(want[k])]
        assert len(got) == len(ref_)
        for a, b in zip(got, ref_):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            if a.numel():
                assert float(np.abs(a.numpy() - b).max()) <= JAX_TOL

    same(c1, jc)
    assert c1["shared_k"].shape[0] == c1["body_ssm"].shape[0] == 0
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    jl2, jc2 = JM.decode_step(np_params, jcfg, jnp.asarray(tok), jc, tp=tp)
    mesh = make_mesh(shape, AXES[2], devices=["cpu"])
    placed = sh.device_put(from_jax_params(np_params, "cpu"),
                           sh.make_shardings(sh.param_specs(
                               one, tcfg, mesh), mesh))
    big = sh.big_batch(mesh, B)
    with torch.no_grad():
        parts, lasts = [], []
        for d in range(len(sh.model_groups(mesh)) if big else 1):
            rows = sh.row_block(mesh, B, d)
            last, part = M.prefill_tp(sh.group_view(placed, mesh, d), tcfg,
                                      torch.from_numpy(toks)[rows],
                                      max_len=S, tp=tp)
            parts.append(part)
            lasts.append(last)
            for m in part:
                assert m["shared_k"].shape[0] == m["body_ssm"].shape[0] == 0
        assert float((torch.cat(lasts) - l1).abs().max()) <= LOGIT_TOL
        c2 = M.reshard_prefill_caches(parts, tcfg, mesh)
        _shards_agree(c2, c1)
        t = torch.from_numpy(tok)
        l1b, c1 = M.decode_step(one, tcfg, t, c1, tp=tp)
        l2b, c2 = M.decode_step_tp(placed, tcfg, t, c2, mesh, tp=tp)
    assert float(np.abs(l1b.numpy() - np.asarray(jl2)).max()) <= JAX_TOL
    same(c1, jc2)
    assert float((l2b - l1b).abs().max()) <= LOGIT_TOL
    _shards_agree(c2, c1)
    assert c2["length"] == c1["length"] == 33


# ---------------------------------------------------------------------------
# on placeholder cards: the layout and the exchange
# ---------------------------------------------------------------------------

WS = 1024          # 4 blocks of 64 a shard at 4 shards, 1 physical page


def _walk(shape, B, method):
    # 8 q heads, ff 384, vocab 1280 (as test_torch_decode_split.py's walk);
    # 64-token blocks, a budget of 512 tokens
    cfg = get_arch("llama3.2-1b").smoke()
    cfg = cfg.replace(dtype="float32", n_heads=8, d_ff=384, vocab_size=1280,
                      memory=cfg.memory.replace(
                          block_size=64, token_budget=512,
                          pages_per_physical=4, **METHODS[method]))
    n = shape[-1]
    mesh = make_mesh(shape, AXES[2], devices=op_walk.cards(
        int(np.prod(shape))))
    shp = ShapeConfig("decode", WS, B, "decode")
    init, _ = get_sparse_method(cfg.memory.method)
    with op_walk.placeholders():
        p = M.init_params(cfg, 0, tp=n, device="cpu")
        placed = sh.device_put(p, sh.make_shardings(
            sh.param_specs(p, cfg, mesh), mesh))
        sp = init(cfg, cfg.memory, 1, device="cpu")
        sp = sh.device_put(sp, sh.make_shardings(
            sh.method_specs(sp, cfg, mesh), mesh))
        c = M.make_cache(cfg, B, WS, tp=n, device="cpu")
        caches = sh.device_put({"k": c["k"], "v": c["v"]}, sh.make_shardings(
            sh.cache_specs(c, cfg, shp, mesh), mesh))
        caches["length"] = WS - 100
        token = torch.zeros(B, dtype=torch.int32).to("cuda:0")
        split = split_sparse(cfg, cfg.memory, page=64)
        with _Copies() as w:
            M.decode_step_tp(placed, cfg, token, caches, mesh, tp=n,
                             sparse=split, sparse_params=sp)
        kv = [tuple(s.shape) for s in caches["k"].shards]
    return cfg, mesh, w, kv, split


def _expected(cfg, mesh, B, split):
    """The bytes each card receives in one fp32 step: the token, the
    embedding's d-slices, per layer the new token's q (and k / v where the
    kv heads shard), the (value, index) candidates onto the sequence
    group's first card, the block / physical page ids from it, the (out,
    lse) pairs of each member's heads and the two row-parallel partials'
    all-reduces; the logits' vocabulary slices and rows. Seer's gated
    query and LServe's scores are computed where they are read: nothing of
    theirs crosses."""
    groups = sh.model_groups(mesh)
    dp, n = len(groups), len(groups[0])
    seqs = sh.seq_groups(mesh, B)
    ns = len(seqs[0])
    Bd = B // dp if sh.big_batch(mesh, B) else B
    d, hd, L_ = cfg.d_model, cfg.hd, cfg.n_layers
    hp, kv, V = cfg.padded_heads(n), cfg.n_kv_heads, cfg.padded_vocab
    items = WS // ns // split.page            # blocks a shard
    if isinstance(split, lserve.SplitLServe):
        items //= split.ppp                   # physical pages a shard
    k_local = min(split.n_sel, items)
    sent = min(split.n_sel, items * ns)       # the ids delivered
    ring = 2 * (n - 1) * Bd * d * 4 // n
    want = {}
    for grp in groups:
        for m, c in enumerate(grp):
            got = 0
            if c != 0:
                got += Bd * 4                                  # the token
            got += (n - 1) * Bd * d // n * 4                   # embedding
            per = (n - 1) * Bd * hp // n * hd * 4              # q
            if cfg.kv_shardable(n):
                per += 2 * (n - 1) * Bd * kv // n * hd * 4     # k, v
            seq = next(s for s in seqs if c in s)
            if c == seq[0]:                # candidates: fp32, int32
                per += (ns - 1) * Bd * k_local * (4 + 4)
            else:                          # the ids, int32
                per += Bd * sent * 4
            per += (ns - 1) * Bd * hp // n * (hd + 1) * 4      # out, lse
            per += 2 * ring                                    # wo, ffn
            got += L_ * per
            if m == 0:
                got += (n - 1) * Bd * V // n * 4               # logits
            if c == 0:
                got += (dp - 1) * Bd * V * 4                   # the rows
            want[f"cuda:{c}"] = got
    return want


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("shape,B", [((1, 4), 2), ((2, 2), 4)],
                         ids=["1x4", "2x2"])
def test_placeholder_cards_hold_slices_and_exchange_small_tensors(
        shape, B, method):
    cfg, mesh, w, kv, split = _walk(shape, B, method)
    n_seq = len(sh.seq_groups(mesh, B)[0])
    rows = B // len(sh.model_groups(mesh))
    # each card's K/V: its rows, 1/n of the sequence, every kv head
    assert set(kv) == {(cfg.n_layers, rows, WS // n_seq, cfg.n_kv_heads,
                        cfg.hd)}
    # no card makes a full-length K / V, nor the whole sequence's pooled
    # gate keys or page bounds
    whole = [(WS, cfg.n_kv_heads, cfg.hd), (WS // 64, cfg.memory.index_dim),
             (WS // 64, cfg.hd)]
    bad = [s for s in w.shapes for f in whole
           if any(s[i:i + len(f)] == f for i in range(len(s)))]
    assert not bad, bad
    got = {}
    for dst, _, nb in w.copies:
        got[dst] = got.get(dst, 0) + nb
    assert got == _expected(cfg, mesh, B, split)
    # the selection kernel's work is counted per shard, each over its own
    # slice (LServe's page_minmax: a shard's keys, not the whole cache)
    kernel = "page_minmax" if method == "lserve" else \
        "relevancy_topk_candidates"
    recs = [r for r in w.kernels if r.name == kernel]
    cards = n_seq * (B // rows)          # every computing coordinate
    assert len(recs) == cfg.n_layers * cards
    assert len({r.device for r in recs}) == cards
    if method == "lserve":
        shard = torch.empty((rows, WS // n_seq, cfg.n_kv_heads, cfg.hd),
                            device="meta")
        assert {r.cost.bytes for r in recs} == {
            page_pool.cost(shard, page_size=64).bytes}


# ---------------------------------------------------------------------------
# against the reference's GSPMD-partitioned step on 4 host devices
# ---------------------------------------------------------------------------

_GSPMD = r"""
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_arch
from repro.configs.base import ShapeConfig
from repro.core.methods import get_sparse_method
from repro.distributed.sharding import cache_specs, method_specs, param_specs
from repro.kernels import ops
from repro.launch.mesh import make_mesh
from repro.models import model as JM
ops.use_pallas(False)
mesh = make_mesh((1, N), ("data", "model"))
z = np.load(PATH)
caches = {}
for name in z.files:
    if name == "tok":
        continue
    key, _, i = name.partition(":")
    if i:
        caches[key] = caches.get(key, ()) + (jnp.asarray(z[name]),)
    else:
        caches[key] = jnp.asarray(z[name])
caches["length"] = jnp.asarray(CTX, jnp.int32)
put = lambda t, s: jax.tree.map(
    lambda x, y: jax.device_put(x, NamedSharding(mesh, y)), t, s)
out = {}
for name, kw in METHODS.items():
    cfg = get_arch(ARCH).smoke().replace(dtype="float32", **KW)
    cfg = cfg.replace(memory=cfg.memory.replace(**MEM, **kw))
    init, mk = get_sparse_method(cfg.memory.method)
    p = JM.init_params(cfg, jax.random.PRNGKey(0), tp=N)
    sp = init(jax.random.PRNGKey(7), cfg, cfg.memory,
              stacked=cfg.family != "hybrid")
    p = put(p, param_specs(p, cfg, mesh))
    sp = put(sp, method_specs(sp, cfg, mesh))
    c = put(caches, cache_specs(caches, cfg, ShapeConfig(
        "d", z[KNAME].shape[2], B, "decode"), mesh))
    fn = mk(cfg, cfg.memory, tp=N)
    step = jax.jit(lambda p, t, c, s: JM.decode_step(
        p, cfg, t, c, tp=N, sparse_fn=fn, sparse_params=s))
    logits, _ = step(p, jnp.asarray(z["tok"]), c, sp)
    assert "model" in str(c[KNAME].sharding.spec)
    out[name] = np.asarray(logits).tolist()
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-7b"])
def test_split_methods_agree_with_gspmd(arch, tmp_path):
    """The reference's jitted ``decode_step`` with Seer's (top-k and
    threshold) and LServe's ``make_sparse_fn``, ``param_specs``,
    ``method_specs`` and ``cache_specs`` on a (1, 4) mesh of host devices
    (GSPMD partitions it: the cache's sequence on ``model``), against the
    port's split at the same weights and cache (zamba2 with a tail
    layer)."""
    n, B = 4, 2
    kw = HYBRID_TAIL if arch == "zamba2-7b" else {}
    jcfg, tcfg = _cfgs(arch, kw)
    npc = _caches(tcfg, B, seed=2)
    tok = np.random.default_rng(4).integers(0, tcfg.vocab_size, B) \
        .astype(np.int32)
    path = tmp_path / "decode.npz"
    flat = {}
    for name, a in npc.items():
        if isinstance(a, tuple):
            flat.update({f"{name}:{i}": t for i, t in enumerate(a)})
        else:
            flat[name] = a
    np.savez(path, tok=tok, **flat)
    hybrid = tcfg.family == "hybrid"
    kname = "shared_k" if hybrid else "k"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + "/src",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        JAX_PLATFORMS="cpu")
    code = (f"N, B, CTX = {n}, {B}, {CTX}\n"
            f"ARCH, KW, KNAME = {arch!r}, {kw!r}, {kname!r}\n"
            f"MEM, METHODS = {MEM!r}, {METHODS!r}\n"
            f"PATH = {str(path)!r}\n" + _GSPMD)
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    want = json.loads(run.stdout.strip().splitlines()[-1])
    mesh = make_mesh((1, n), AXES[2], devices=["cpu"])
    shp = ShapeConfig("decode", S, B, "decode")
    for name in METHODS:
        jm, tm = _with_mem(jcfg, name, {}), _with_mem(tcfg, name, {})
        np_params = jax.tree.map(np.asarray, JM.init_params(
            jm, jax.random.PRNGKey(0), tp=n))
        params = from_jax_params(np_params, "cpu")
        placed = sh.device_put(params, sh.make_shardings(
            sh.param_specs(params, tm, mesh), mesh))
        np_sp, sp = _sp_init(jm, hybrid)
        sp = sh.device_put(sp, sh.make_shardings(
            sh.method_specs(sp, tm, mesh), mesh))
        caches = _tree(npc, lambda a: torch.from_numpy(a.copy()))
        caches = sh.device_put(caches, sh.make_shardings(
            sh.cache_specs(caches, tm, shp, mesh), mesh))
        caches["length"] = CTX
        split = split_sparse(tm, tm.memory, page=tm.memory.block_size)
        with torch.no_grad():
            logits, _ = M.decode_step_tp(placed, tm, torch.from_numpy(tok),
                                         caches, mesh, tp=n, sparse=split,
                                         sparse_params=sp)
        err = float(np.abs(logits.numpy() - np.asarray(want[name])).max())
        assert err <= JAX_TOL, (name, err)
