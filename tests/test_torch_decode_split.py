"""The decode step over a sequence-split KV cache
(``models.model.decode_step_tp``), on meshes of CPU entries: each (data,
model) coordinate holds its ``cache_specs`` slice of K/V (decode_32k's rows
on the data axes and sequence on ``model``; long_500k's sequence over
(data, model)) and its ``param_specs`` / ``method_specs`` slice of the
weights, and computes its part.

Each case (llama with kv heads sharded and replicated, a data axis, the
long_500k layout, a ``pod`` axis, MoE expert-parallel and d_ff-split and
on (2, 2) through the gathered dispatch group, audio, vlm with M-RoPE,
FSDP, the Mamba2 hybrid in both layouts (its SSM states cut by heads, its
conv states whole on every member); DSA stateless, DSA's index cache, the
dense branch) runs 4 greedy fp32 steps from a seeded cache (smoke
configs, DSA pages of 4 tokens: each shard owns several pages and several
are selected), held
- against the port's one-device ``decode_step`` at the same weights and
  cache: logits within 2e-5 abs (the split's sums run in another order, as
  ``prefill_tp``'s in ``tests/test_torch_tp.py``), the selected page ids
  equal, each shard's cache slice (the hybrid's states too) within 1e-5
  abs of its slice of one device's, greedy tokens equal;
- against the JAX package's ``decode_step`` (plain route): logits within
  1e-4 (``tests/test_torch_methods.py``'s ``LOGIT_TOL``).

Also: ``prefill_tp`` -> ``reshard_prefill_caches`` -> ``decode_step_tp``
equals ``prefill`` -> ``decode_step``; on placeholder cards, each card's
K/V is its 1/n of the sequence, no card holds a full-shape tensor of a
leaf cut over ``model``, and the bytes that cross between cards are only
the named small tensors, to the byte; in a subprocess with 4 host devices
the reference's jitted ``decode_step`` with ``cache_specs`` on a (1, 4)
mesh (GSPMD) gives the split's logits within 1e-4, llama's and zamba2's.
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

from repro.core.methods import dsa as jdsa  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.methods import dsa  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import op_walk  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

from torch_decode_cases import (AXES, CACHE_TOL, CTX, HYBRID_TAIL,  # noqa: E402
                                JAX_TOL, LOGIT_TOL, PAGE, STEPS, S, _caches,
                                _cfgs, _Copies, _Recorded, _shards_agree,
                                _sorted_pages, _tree)

torch.set_num_threads(2)
FSDP_WIDTH = {"d_ff": 16384, "vocab_size": 32768}   # leaves of 2^22
# name: (arch, mesh shape, batch, config changes, fsdp, method)
CASES = {
    "llama-1x2-kv-sharded": ("llama3.2-1b", (1, 2), 2, {}, None, "dsa"),
    "llama-1x4-kv-replicated": ("llama3.2-1b", (1, 4), 2, {}, None,
                                "dense"),
    "llama-2x2-data": ("llama3.2-1b", (2, 2), 4, {}, None, "idxcache"),
    "llama-long-2x2": ("llama3.2-1b", (2, 2), 1, {}, None, "dsa"),
    "llama-long-2x2-idxcache": ("llama3.2-1b", (2, 2), 1, {}, None,
                                "idxcache"),
    "llama-pod-2x2x2": ("llama3.2-1b", (2, 2, 2), 4, {}, None, "dsa"),
    "granite-1x4-expert-parallel": ("granite-moe-1b-a400m", (1, 4), 2, {},
                                    None, "dsa"),
    "granite-1x8-ff-split": ("granite-moe-1b-a400m", (1, 8), 2, {}, None,
                             "dense"),
    # 32 rows a step: 16 tokens an expert at capacity 16, so tokens drop
    # and a dispatch group cut over the data axes would drop others
    "granite-2x2-gathered": ("granite-moe-1b-a400m", (2, 2), 32,
                             {"capacity_factor": 1.0}, None, "dsa"),
    "musicgen-2x2": ("musicgen-medium", (2, 2), 4, {}, None, "dsa"),
    "qwen2vl-1x4": ("qwen2-vl-72b", (1, 4), 2, {}, None, "dsa"),
    "llama-fsdp-2x2": ("llama3.2-1b", (2, 2), 4, FSDP_WIDTH, True,
                       "idxcache"),
    # the hybrid: its shared block's sites over shared_k / shared_v (one
    # set of indexer weights), its Mamba2 layers from the SSM states cut
    # by heads and the conv states whole on every member
    "zamba2-2x2-data": ("zamba2-7b", (2, 2), 4, {}, None, "dsa"),
    "zamba2-1x4-dense": ("zamba2-7b", (1, 4), 2, HYBRID_TAIL, None,
                         "dense"),
    "zamba2-long-2x2": ("zamba2-7b", (2, 2), 1, HYBRID_TAIL, None, "dsa"),
    "zamba2-long-2x2-dense": ("zamba2-7b", (2, 2), 1, {}, None, "dense"),
}


def _kidx(sp, k):
    """The pooled index cache of a cache's k: per page, the sum of its
    tokens' index keys [L, B, S / PAGE, di] (zero keys add nothing)."""
    kk = torch.from_numpy(k)
    L_, B = k.shape[:2]
    return torch.stack([dsa._matmul_promoted(
        kk[i].reshape(B, S, -1), sp["wk_idx"][i]).float().reshape(
        B, S // PAGE, PAGE, -1).sum(2) for i in range(L_)])


def _jax_step(jcfg, tp, method, mem):
    fn = None
    if method == "dsa":
        fn = jdsa.make_sparse_fn(jcfg, mem, tp=tp, page=PAGE)
    elif method == "idxcache":
        mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("model",))
        fn = jdsa.make_sparse_fn_cached(jcfg, mem, mesh1, axis="model",
                                        tp=tp, page=PAGE)
    return jax.jit(lambda p, t, c, sp: JM.decode_step(
        p, jcfg, t, c, tp=tp, sparse_fn=fn, sparse_params=sp,
        sparse_stateful=method == "idxcache"))


@pytest.mark.parametrize("case", list(CASES))
def test_split_decode_matches_one_device_and_jax(case, monkeypatch):
    arch, shape, B, kw, fsdp, method = CASES[case]
    jcfg, tcfg = _cfgs(arch, kw)
    tp = shape[-1]
    mesh = make_mesh(shape, AXES[len(shape)], devices=["cpu"])
    np_params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), tp=tp))
    one = from_jax_params(np_params, "cpu")
    placed = sh.device_put(from_jax_params(np_params, "cpu"),
                           sh.make_shardings(sh.param_specs(
                               one, tcfg, mesh, fsdp=fsdp), mesh))
    assert any(sh.fsdp_dim(x) is not None for x in leaves(placed)) == \
        bool(fsdp)
    hybrid = tcfg.family == "hybrid"
    kname = "shared_k" if hybrid else "k"
    sites = M._hybrid_shape(tcfg)[0] if hybrid else tcfg.n_layers
    npc = _caches(tcfg, B)
    k = npc.get("k")
    shp = ShapeConfig("decode", S, B, "decode")
    c1 = _tree(npc, lambda a: torch.from_numpy(a.copy()))
    c1["length"] = CTX
    c2 = _tree(npc, torch.from_numpy)
    c2 = sh.device_put(c2, sh.make_shardings(sh.cache_specs(
        c2, tcfg, shp, mesh), mesh))
    c2["length"] = CTX
    jc = _tree(npc, jnp.asarray)
    jc["length"] = jnp.asarray(CTX, jnp.int32)
    # each coordinate holds its rows and its sequence slice, every kv head
    n_seq = len(sh.seq_groups(mesh, B)[0])
    rows = B // sh.data_ways(mesh) if sh.big_batch(mesh, B) else B
    for s in c2[kname].shards:
        assert s.shape == (sites, rows, S // n_seq, tcfg.n_kv_heads, tcfg.hd)
    if hybrid:      # the SSM states' heads cut over model, conv rows only
        n = shape[-1]
        for s in c2["body_ssm"].shards:
            assert s.shape[-4:-2] == (rows, tcfg.ssm_heads // n)
        for s in c2["body_conv"][0].shards:
            assert s.shape[-3:-1] == (rows, tcfg.d_inner)

    sfn = split = sp1 = sp2 = jsp = None
    stateful = method == "idxcache"
    if method != "dense":
        np_sp = jax.tree.map(np.asarray, jdsa.dsa_init(
            jax.random.PRNGKey(7), jcfg, jcfg.memory, stacked=not hybrid))
        sp = from_jax_params(np_sp, "cpu")
        split = dsa.SplitDSA(tcfg, tcfg.memory, page=PAGE,
                             stateful=stateful, record=True)
        if stateful:
            kidx = _kidx(sp, k)
            sfn = dsa.make_sparse_fn_cached(tcfg, tcfg.memory,
                                            (torch.device("cpu"),), tp=tp,
                                            page=PAGE)
            sp1 = {"p": sp, "kidx_sum": kidx.clone()}
            sp2 = {"p": from_jax_params(np_sp, "cpu"),
                   "kidx_sum": kidx.clone()}
            sp2 = sh.device_put(sp2, sh.make_shardings(
                sh.sparse_cache_specs(sp2, tcfg, shp, mesh), mesh))
            jsp = {"p": np_sp, "kidx_sum": kidx.numpy()}
        else:
            sfn = dsa.make_sparse_fn(tcfg, tcfg.memory, tp=tp, page=PAGE)
            sp1 = sp
            sp2 = sh.device_put(from_jax_params(np_sp, "cpu"),
                                sh.make_shardings(sh.method_specs(
                                    sp, tcfg, mesh), mesh))
            jsp = np_sp
    jstep = _jax_step(jcfg, tp, method, jcfg.memory)
    rec = _Recorded(monkeypatch)
    tok = np.random.default_rng(3).integers(0, tcfg.vocab_size, B) \
        .astype(np.int32)
    with torch.no_grad():
        for step in range(STEPS):
            t = torch.from_numpy(tok)
            rec.on, rec.pages = True, []
            out1 = M.decode_step(one, tcfg, t, c1, tp=tp, sparse_fn=sfn,
                                 sparse_params=sp1, sparse_stateful=stateful)
            rec.on = False
            split.selected.clear() if split else None
            out2 = M.decode_step_tp(placed, tcfg, t, c2, mesh, tp=tp,
                                    sparse=split, sparse_params=sp2)
            jout = jstep(np_params, jnp.asarray(tok), jc, jsp)
            (l1, c1), (l2, c2), (jl, jc) = out1[:2], out2[:2], jout[:2]
            if stateful:
                sp1, jsp = out1[2], jout[2]
            assert l2.shape == (B, tcfg.padded_vocab)
            err = float((l2 - l1).abs().max())
            assert err <= LOGIT_TOL, (step, err)
            assert float(np.abs(l2.numpy() - np.asarray(jl)).max()) <= \
                JAX_TOL
            assert c2["length"] == c1["length"] == CTX + step + 1
            _shards_agree(c2, c1)
            if split is not None:
                # one selection a sequence group an attention layer (the
                # hybrid: a site): the rows of each data index in turn
                ng = len(sh.seq_groups(mesh, B))
                sel = [torch.cat(split.selected[i * ng:(i + 1) * ng])
                       for i in range(sites)]
                assert len(split.selected) == ng * sites
                assert len(rec.pages) == sites
                for a, b in zip(sel, rec.pages):
                    got, want = _sorted_pages(a), _sorted_pages(b)
                    assert got.shape[1] >= want.shape[1] > 1
                    assert torch.equal(got[:, -want.shape[1]:], want)
                    assert (got[:, :-want.shape[1]] == -1).all()
            assert torch.equal(l2.argmax(-1), l1.argmax(-1))
            tok = l1.argmax(-1).numpy().astype(np.int32)
    if stateful:     # the index caches agree, each shard its slice
        full = sp1["kidx_sum"][0]
        kx = sp2["kidx_sum"]
        for s, sl in zip(kx.shards, kx.slices):
            assert float((s - full[sl]).abs().max()) <= CACHE_TOL


@pytest.mark.parametrize("arch,shape,B", [
    ("llama3.2-1b", (1, 4), 2), ("llama3.2-1b", (2, 2), 4),
    ("zamba2-7b", (2, 2), 4), ("zamba2-7b", (2, 2), 1)],
    ids=["1x4-kv-replicated", "2x2-kv-sharded", "zamba2-2x2",
         "zamba2-long-2x2"])
def test_prefill_tp_reshard_decode_matches_one_device(arch, shape, B):
    """``prefill_tp`` over each data index's model group (long_500k's
    layout: data index 0's), its caches resharded to the decode layout (an
    all-to-all where the kv heads shard, each member's own slice where they
    do not; the hybrid's SSM states by heads, its conv states' x channels
    all-gathered, copied to the other data indices where the batch is not
    cut), then two split steps: equal to ``prefill`` + ``decode_step`` on
    one device."""
    kw = HYBRID_TAIL if arch == "zamba2-7b" else {}
    jcfg, tcfg = _cfgs(arch, kw)
    tp = shape[-1]
    mesh = make_mesh(shape, AXES[2], devices=["cpu"])
    np_params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), tp=tp))
    one = from_jax_params(np_params, "cpu")
    placed = sh.device_put(from_jax_params(np_params, "cpu"),
                           sh.make_shardings(sh.param_specs(
                               one, tcfg, mesh), mesh))
    # the hybrid's prompt: whole SSD chunks of 16
    P_ = 32 if tcfg.family == "hybrid" else 24
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (B, P_)).astype(np.int32))
    dp = len(sh.model_groups(mesh)) if sh.big_batch(mesh, B) else 1
    with torch.no_grad():
        l1, c1 = M.prefill(one, tcfg, toks, max_len=S, tp=tp)
        parts, lasts = [], []
        for d in range(dp):
            rows = sh.row_block(mesh, B, d)
            last, part = M.prefill_tp(sh.group_view(placed, mesh, d), tcfg,
                                      toks[rows], max_len=S, tp=tp)
            parts.append(part)
            lasts.append(last)
        assert float((torch.cat(lasts) - l1).abs().max()) <= LOGIT_TOL
        c2 = M.reshard_prefill_caches(parts, tcfg, mesh)
        assert c2["length"] == P_
        kname = "shared_k" if tcfg.family == "hybrid" else "k"
        for s_ in c2[kname].shards:
            assert s_.shape[2] == S // len(sh.seq_groups(mesh, B)[0])
        _shards_agree(c2, c1)
        tok = l1.argmax(-1)
        for _ in range(2):
            a, c1 = M.decode_step(one, tcfg, tok, c1, tp=tp)
            b, c2 = M.decode_step_tp(placed, tcfg, tok, c2, mesh, tp=tp)
            assert float((a - b).abs().max()) <= LOGIT_TOL
            assert torch.equal(a.argmax(-1), b.argmax(-1))
            _shards_agree(c2, c1)
            tok = a.argmax(-1)


def test_all_to_all_moves_n_minus_1_over_n():
    """Destination j gets block j of every participant in participant
    order; each participant sends (n - 1) / n of its tensor."""
    n = 4
    xs = [torch.arange(48, dtype=torch.float32).reshape(4, 12) + 100 * i
          for i in range(n)]
    out = col.all_to_all(xs, 1, 0, ["cpu"] * n)
    for j in range(n):
        assert torch.equal(out[j], torch.cat([x[:, 3 * j:3 * j + 3]
                                              for x in xs], 0))
    with op_walk.placeholders():
        xs = [torch.empty(8, 16, dtype=torch.bfloat16).to(f"cuda:{i}")
              for i in range(n)]
        with op_walk.OpWalk() as w:
            col.all_to_all(xs, 1, 0)
    for i in range(n):
        c = w.costs[f"cuda:{i}"]
        assert c.per_collective["all-to-all"] == c.coll_bytes \
            == (n - 1) * 8 * 16 * 2 // n


# ---------------------------------------------------------------------------
# on placeholder cards: the layout and the exchange
# ---------------------------------------------------------------------------

WS = 1024          # 16 pages of 64 a shard at 4 shards


def _walk(shape, B):
    # widths at which no model-cut leaf's shard has another leaf's full
    # shape: 8 q heads (wq 256 wide), ff 384, vocab 1280, an index of 24
    cfg = get_arch("llama3.2-1b").smoke()
    cfg = cfg.replace(dtype="float32", n_heads=8, d_ff=384, vocab_size=1280,
                      memory=cfg.memory.replace(index_dim=24))
    n = shape[-1]
    mesh = make_mesh(shape, AXES[2], devices=op_walk.cards(
        int(np.prod(shape))))
    shp = ShapeConfig("decode", WS, B, "decode")
    with op_walk.placeholders():
        p = M.init_params(cfg, 0, tp=n, device="cpu")
        placed = sh.device_put(p, sh.make_shardings(
            sh.param_specs(p, cfg, mesh), mesh))
        sp = dsa.dsa_init(cfg, cfg.memory, 1, device="cpu")
        sp = sh.device_put(sp, sh.make_shardings(
            sh.method_specs(sp, cfg, mesh), mesh))
        c = M.make_cache(cfg, B, WS, tp=n, device="cpu")
        caches = sh.device_put({"k": c["k"], "v": c["v"]}, sh.make_shardings(
            sh.cache_specs(c, cfg, shp, mesh), mesh))
        caches["length"] = WS - 100
        token = torch.zeros(B, dtype=torch.int32).to("cuda:0")
        split = dsa.SplitDSA(cfg, cfg.memory, page=64)
        with _Copies() as w:
            M.decode_step_tp(placed, cfg, token, caches, mesh, tp=n,
                             sparse=split, sparse_params=sp)
        kv = [tuple(s.shape) for s in caches["k"].shards]
        cut = [(tuple(x.shape), x.dim() == 3) for x in leaves(placed)
               if "model" in x.sharding.spec]
    return cfg, mesh, w, kv, cut, split


def _expected(cfg, mesh, B, split):
    """The bytes each card receives in one fp32 step, by what crosses: the
    token, the embedding's d-slices, per layer the new token's q (and k /
    v where the kv heads shard), the index query's columns and weight
    logits, the (value, index) candidates, the page ids, the (out, lse)
    pairs of each member's heads and the two row-parallel partials'
    all-reduces; the logits' vocabulary slices and rows."""
    groups = sh.model_groups(mesh)
    dp, n = len(groups), len(groups[0])
    seqs = sh.seq_groups(mesh, B)
    ns = len(seqs[0])
    Bd = B // dp if sh.big_batch(mesh, B) else B
    d, hd, L_ = cfg.d_model, cfg.hd, cfg.n_layers
    hp, kv, V = cfg.padded_heads(n), cfg.n_kv_heads, cfg.padded_vocab
    mem = cfg.memory
    k_local = min(split.n_sel, WS // ns // 64)
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
            per += (n - 1) * Bd * (mem.index_heads * mem.index_dim // n
                                   + mem.index_heads // n) * 4
            seq = next(s for s in seqs if c in s)
            if c == seq[0]:                # candidates: fp32, int32
                per += (ns - 1) * Bd * k_local * (4 + 4)
            else:                          # the page ids, int32
                per += Bd * split.n_sel * 4
            per += (ns - 1) * Bd * hp // n * (hd + 1) * 4      # out, lse
            per += 2 * ring                                    # wo, ffn
            got += L_ * per
            if m == 0:
                got += (n - 1) * Bd * V // n * 4               # logits
            if c == 0:
                got += (dp - 1) * Bd * V * 4                   # the rows
            want[f"cuda:{c}"] = got
    return want


@pytest.mark.parametrize("shape,B", [((1, 4), 2), ((2, 2), 4)],
                         ids=["1x4", "2x2"])
def test_placeholder_cards_hold_slices_and_exchange_small_tensors(shape, B):
    cfg, mesh, w, kv, cut, split = _walk(shape, B)
    n_seq = len(sh.seq_groups(mesh, B)[0])
    rows = B // len(sh.model_groups(mesh))
    # each card's K/V: its rows, 1/n of the sequence, every kv head
    assert set(kv) == {(cfg.n_layers, rows, WS // n_seq, cfg.n_kv_heads,
                        cfg.hd)}
    # no card makes a full-length K / V, nor the whole sequence's pooled
    # index keys
    whole = [(WS, cfg.n_kv_heads, cfg.hd), (WS // 64, cfg.memory.index_dim)]
    bad = [s for s in w.shapes for f in whole
           if any(s[i:i + len(f)] == f for i in range(len(s)))]
    assert not bad, bad
    # no card holds a full-shape tensor of a leaf cut over the model axis
    full = {s for s, _ in cut} | {s[1:] for s, stacked in cut if stacked}
    assert not (w.shapes & full), w.shapes & full
    # what crosses: the named small tensors, to the byte
    got = {}
    for dst, _, nb in w.copies:
        got[dst] = got.get(dst, 0) + nb
    assert got == _expected(cfg, mesh, B, split)
    biggest = max(nb for _, _, nb in w.copies)
    assert biggest <= rows * cfg.padded_vocab * 4      # a group's logits


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
from repro.core.methods import dsa
from repro.distributed.sharding import cache_specs, method_specs, param_specs
from repro.kernels import ops
from repro.launch.mesh import make_mesh
from repro.models import model as JM
ops.use_pallas(False)
cfg = get_arch(ARCH).smoke().replace(dtype="float32", **KW)
mesh = make_mesh((1, N), ("data", "model"))
z = np.load(PATH)
p = JM.init_params(cfg, jax.random.PRNGKey(0), tp=N)
sp = dsa.dsa_init(jax.random.PRNGKey(7), cfg, cfg.memory,
                  stacked=cfg.family != "hybrid")
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
p = put(p, param_specs(p, cfg, mesh))
sp = put(sp, method_specs(sp, cfg, mesh))
cs = cache_specs(caches, cfg, ShapeConfig("d", z[KNAME].shape[2], B,
                                          "decode"), mesh)
caches = put(caches, cs)
out = {}
for name, fn in (("dense", None),
                 ("dsa", dsa.make_sparse_fn(cfg, cfg.memory, tp=N,
                                            page=PAGE))):
    step = jax.jit(lambda p, t, c, s: JM.decode_step(
        p, cfg, t, c, tp=N, sparse_fn=fn, sparse_params=s))
    logits, _ = step(p, jnp.asarray(z["tok"]), caches, sp)
    assert "model" in str(caches[KNAME].sharding.spec)
    out[name] = np.asarray(logits).tolist()
print(json.dumps(out))
"""


def test_split_decode_agrees_with_gspmd(tmp_path):
    """The reference's jitted ``decode_step`` with ``param_specs``,
    ``method_specs`` and ``cache_specs`` on a (1, 4) mesh of host devices
    (GSPMD partitions it: the cache's sequence on ``model``), dense and
    DSA, against the port's split at the same weights and cache."""
    _against_gspmd("llama3.2-1b", tmp_path)


def test_hybrid_split_decode_agrees_with_gspmd(tmp_path):
    """As above for zamba2 with a tail layer: GSPMD cuts the SSM states by
    heads and the Mamba2 weights as ``param_specs`` says, the shared
    block's caches' sequence on ``model``."""
    _against_gspmd("zamba2-7b", tmp_path)


def _against_gspmd(arch, tmp_path):
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
    kname = "shared_k" if tcfg.family == "hybrid" else "k"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + "/src",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        JAX_PLATFORMS="cpu")
    code = (f"N, B, CTX, PAGE = {n}, {B}, {CTX}, {PAGE}\n"
            f"ARCH, KW, KNAME = {arch!r}, {kw!r}, {kname!r}\n"
            f"PATH = {str(path)!r}\n" + _GSPMD)
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    mesh = make_mesh((1, n), AXES[2], devices=["cpu"])
    np_params = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0), tp=n))
    params = from_jax_params(np_params, "cpu")
    placed = sh.device_put(params, sh.make_shardings(
        sh.param_specs(params, tcfg, mesh), mesh))
    np_sp = jax.tree.map(np.asarray, jdsa.dsa_init(
        jax.random.PRNGKey(7), jcfg, jcfg.memory,
        stacked=tcfg.family != "hybrid"))
    sp = sh.device_put(from_jax_params(np_sp, "cpu"), sh.make_shardings(
        sh.method_specs(from_jax_params(np_sp, "cpu"), tcfg, mesh), mesh))
    shp = ShapeConfig("decode", S, B, "decode")
    for name in ("dense", "dsa"):
        caches = _tree(npc, torch.from_numpy)
        caches = sh.device_put(caches, sh.make_shardings(
            sh.cache_specs(caches, tcfg, shp, mesh), mesh))
        caches["length"] = CTX
        split = (dsa.SplitDSA(tcfg, tcfg.memory, page=PAGE)
                 if name == "dsa" else None)
        with torch.no_grad():
            logits, _ = M.decode_step_tp(placed, tcfg, torch.from_numpy(tok),
                                         caches, mesh, tp=n, sparse=split,
                                         sparse_params=sp)
        err = float(np.abs(logits.numpy() - np.asarray(ref[name])).max())
        assert err <= JAX_TOL, (name, err)
