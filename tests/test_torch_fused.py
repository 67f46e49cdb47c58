"""The port's fused multi-step decode (``ServeConfig(fused_steps=K)``,
``repro_torch/serving/fused.py``) on the CPU, ports of the single-shard
cases of ``tests/test_fused_decode.py``:

  * every row of its MATRIX (each method inline, and the hetero offload in
    sync / overlap, with validate): the port's fused(K) emits token for
    token what the port's stepped loop emits, in fewer host dispatches,
    and the port's emissions equal the JAX engine's for the same weights;
  * early exit at the finishing step, and at the trigger step in the
    retrieval service's inline / sync / overlap modes (same fired slots and
    doc ids as the stepped loop), and with the offload; a window ends at
    the dense / sparse flip, inline and offloaded;
  * ``OffloadConfig`` validation and the flat / nested precedence, the
    table-view cache, and a hypothesis property over window widths and
    slot lengths.

Smoke config at dtype float32 (tokens equal exactly), tp=4. On the CPU the
window function runs eagerly; on the card the same function is replayed as
a CUDA graph (``tests/test_torch_cuda.py``).
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data import build_corpus as jbuild_corpus  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import OffloadConfig as JOffloadConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import build_corpus  # noqa: E402
from repro_torch.retrieval import RetrievalConfig  # noqa: E402
from repro_torch.serving import (Engine, OffloadConfig, Request,  # noqa: E402
                                 ServeConfig)
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TP = 4
BASE = dict(max_len=128, n_slots=2, tp=TP, page=8, kv_page_size=16)
CORPUS_KW = dict(retrieval_vocab=128, doc_max=8, embed_dim=16, seed=0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jget_arch("llama3.2-1b").smoke().replace(dtype="float32")
    tcfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    jparams = jinit(jcfg, jax.random.PRNGKey(0), tp=TP)
    tparams = from_jax_params(_np_tree(jparams), "cpu")
    jc = jbuild_corpus(48, gen_vocab=jcfg.vocab_size, **CORPUS_KW)
    tc = build_corpus(48, gen_vocab=tcfg.vocab_size, device="cpu",
                      **CORPUS_KW)
    return jcfg, tcfg, jparams, tparams, jc, tc


@functools.lru_cache(maxsize=None)
def _jax_sparse_params(method):
    """The JAX engine's method weights (key PRNGKey(0)), for both sides."""
    jcfg, _, jparams = _setup()[:3]
    jeng = JEngine(jcfg, jparams, JServeConfig(method=method, **BASE),
                   key=jax.random.PRNGKey(0))
    if jeng.sparse_params is None:
        return None, None
    return jeng.sparse_params, from_jax_params(
        _np_tree(jeng.sparse_params), "cpu")


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    vocab = _setup()[0].vocab_size
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in sizes]


def _port_engine(method, **kw):
    tcfg, tparams = _setup()[1], _setup()[3]
    return Engine(tcfg, tparams, ServeConfig(method=method, **dict(BASE, **kw)),
                  device="cpu", sparse_params=_jax_sparse_params(method)[1])


def _run(eng, prompts, max_new, max_dispatches=200):
    """Drive the engine to drain: (streams, fired, window steps, engine)."""
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        eng.submit(Request(i, p, mn))
    streams, fired, windows = {}, [], []
    for _ in range(max_dispatches):
        ev = eng.poll()
        for rid, _slot, tok in ev:
            streams.setdefault(rid, []).append(int(tok))
        fired.extend(ev.fired)
        if ev.steps:
            windows.append(ev.steps)
        if all(s.done for s in eng.slots.slots) and \
                not eng.has_prefill_work() and not eng.has_retrieval_work():
            break
    return streams, fired, windows, eng


def _jax_run(method, prompts, max_new, offload=None, rcfg=None):
    """The JAX engine's stepped streams and fired slots for the same
    requests (its own fused(K) equals them: tests/test_fused_decode.py)."""
    jcfg, _, jparams = _setup()[:3]
    kw = {} if offload is None else {"offload_cfg": JOffloadConfig(
        mode=offload.mode, validate=offload.validate)}
    eng = JEngine(jcfg, jparams, JServeConfig(method=method, retrieval=rcfg,
                                              **kw, **BASE),
                  key=jax.random.PRNGKey(0))
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        eng.submit(JRequest(i, p, mn))
    streams, fired = {}, []
    for _ in range(200):
        ev = eng.poll()
        for rid, _slot, tok in ev:
            streams.setdefault(rid, []).append(int(tok))
        fired.extend(ev.fired)
        if all(s.done for s in eng.slots.slots) and \
                not eng.has_prefill_work() and not eng.has_retrieval_work():
            break
    return streams, fired, eng


# ---------------------------------------------------------------------------
# the matrix: fused(K) == K x step_pool() == the JAX engine
# ---------------------------------------------------------------------------


MATRIX = [
    ("none", None),
    ("dsa", None),
    ("seer", None),
    ("lserve", None),
    ("dsa", OffloadConfig(mode="sync", validate=True)),
    ("dsa", OffloadConfig(mode="overlap")),
    ("seer", OffloadConfig(mode="overlap", validate=True)),
    ("lserve", OffloadConfig(mode="sync")),
]


@pytest.mark.parametrize("method,offload", MATRIX)
def test_fused_matches_stepped(method, offload):
    prompts = _prompts((16, 9))
    max_new = (6, 9)
    kw = {} if offload is None else {"offload_cfg": offload}
    ref, _, _, _ = _run(_port_engine(method, **kw), prompts, max_new)
    got, _, windows, eng = _run(_port_engine(method, fused_steps=4, **kw),
                                prompts, max_new)
    assert got == ref
    # the windows amortized host dispatches
    assert eng.stats["host_steps"] < eng.stats["decode_steps"]
    assert max(windows) > 1
    assert eng.pool.pages_in_use() == 0
    jstreams, _, _ = _jax_run(method, prompts, max_new, offload)
    assert got == jstreams
    if offload is not None:
        f = eng.hetero.profiler.summary()["fused"]
        assert f["windows"] >= 1 and f["steps_per_dispatch"] > 1


# ---------------------------------------------------------------------------
# early exit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offload", [None, "sync", "overlap"])
def test_early_exit_on_finish(offload):
    """Staggered max_new: the first window stops AT the finishing step
    (3), not after K=4, and wastes no step, inline or offloaded."""
    kw = {} if offload is None else {
        "offload_cfg": OffloadConfig(mode=offload)}
    prompts = _prompts((16, 9), seed=2)
    ref, _, _, _ = _run(_port_engine("dsa", **kw), prompts, (3, 7))
    got, _, windows, _ = _run(_port_engine("dsa", fused_steps=4, **kw),
                              prompts, (3, 7))
    assert got == ref
    assert windows[0] == 3          # early exit at slot 0's last token
    assert sum(windows) == 7        # no wasted device steps


def _rcfg(side, mode, **kw):
    corpus = _setup()[4] if side == "jax" else _setup()[5]
    cls = RetrievalConfig
    if side == "jax":
        from repro.retrieval import RetrievalConfig as cls
    base = dict(kind="rag", mode=mode, corpus=corpus, k=2, trigger="flare",
                tau=1.1, min_interval=3, max_retrievals=1, query_window=6)
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("rmode", ["inline", "sync", "overlap"])
def test_early_exit_on_trigger(rmode):
    """tau=1.1 FLARE fires as soon as the cooldown opens; the window exits
    at the trigger step so the retrieval launches on the step the stepped
    loop launches it: the same fired slots, doc ids and spliced streams,
    and the JAX engine's."""
    prompts = _prompts((16, 9), seed=3)
    ref, rfired, _, reng = _run(
        _port_engine("dsa", retrieval=_rcfg("port", rmode)), prompts,
        (10, 10))
    got, gfired, _, geng = _run(
        _port_engine("dsa", retrieval=_rcfg("port", rmode), fused_steps=4),
        prompts, (10, 10))
    assert got == ref
    assert gfired == rfired and gfired
    ids = [e["ids"] for e in geng.retrieval.events]
    assert ids == [e["ids"] for e in reng.retrieval.events]
    if rmode == "inline":
        jstreams, jfired, jeng = _jax_run(
            "dsa", prompts, (10, 10), rcfg=_rcfg("jax", "inline"))
        assert got == jstreams and gfired == jfired
        assert ids == [list(map(int, e["ids"]))
                       for e in jeng.retrieval.events]


def test_trigger_composed_with_offload():
    """Retrieval triggers + the hetero offload inside fused windows: the
    armed / arm_after gates reproduce the host gate decisions when both
    services share the pool."""
    prompts = _prompts((16, 9), seed=4)
    oc = OffloadConfig(mode="overlap")
    ref, rf, _, _ = _run(
        _port_engine("dsa", retrieval=_rcfg("port", "overlap"),
                     offload_cfg=oc), prompts, (10, 10))
    got, gf, _, _ = _run(
        _port_engine("dsa", retrieval=_rcfg("port", "overlap"),
                     offload_cfg=oc, fused_steps=4), prompts, (10, 10))
    assert got == ref and gf == rf and gf


@pytest.mark.parametrize("offload", [None, "sync"])
def test_window_stops_where_the_branch_flips(offload):
    """min_context inside the run: a window never crosses the dense/sparse
    flip (the budget ends it there; under the offload the first window is
    a local one, the next enters with a cold start), and the streams equal
    the stepped loop's and the JAX engine's, whose traced cond takes the
    flip per step."""
    mem = _setup()[1].memory.replace(method="dsa", min_context=20)
    prompts = _prompts((16, 9), seed=7)
    tcfg, tparams = _setup()[1], _setup()[3]
    sp = _jax_sparse_params("dsa")[1]
    kw = {} if offload is None else {
        "offload_cfg": OffloadConfig(mode=offload)}
    engs = [Engine(tcfg, tparams, ServeConfig(method="dsa", fused_steps=K,
                                              **kw, **BASE),
                   device="cpu", sparse_params=sp, mem=mem) for K in (1, 8)]
    ref, _, _, _ = _run(engs[0], prompts, (9, 9))
    got, _, windows, eng = _run(engs[1], prompts, (9, 9))
    assert got == ref
    assert 0 < eng.stats["sparse_steps"] < eng.stats["decode_steps"]
    assert windows[0] == 3          # lengths 16..18 dense, 19 + 1 sparse
    if offload is not None:
        prof = eng.hetero.profiler
        assert prof.local_steps == 3 and prof.offload_steps > 0
    jcfg, _, jparams = _setup()[:3]
    jmem = jcfg.memory.replace(method="dsa", min_context=20)
    jkw = {} if offload is None else {
        "offload_cfg": JOffloadConfig(mode=offload)}
    jeng = JEngine(jcfg, jparams, JServeConfig(method="dsa", **jkw, **BASE),
                   key=jax.random.PRNGKey(0), mem=jmem)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(i, p, 9))
    jeng.drain()
    assert got == {rid: [int(t) for t in h.tokens]
                   for rid, h in jeng.done.items()}


# ---------------------------------------------------------------------------
# API surface: OffloadConfig validation and precedence, the view cache
# ---------------------------------------------------------------------------


def test_offload_config_validation():
    with pytest.raises(ValueError):
        OffloadConfig(mode="bogus")
    with pytest.raises(ValueError):
        OffloadConfig(shards=0)
    with pytest.raises(ValueError):
        OffloadConfig(mode="off", shards=2)
    with pytest.raises(ValueError):
        OffloadConfig(mode="off", main_mesh=2)
    with pytest.raises(ValueError), pytest.warns(DeprecationWarning):
        ServeConfig(offload="nope")
    with pytest.raises(ValueError):
        ServeConfig(fused_steps=0)
    with pytest.raises(ValueError):
        ServeConfig(fused_steps=4, paged=False)
    with pytest.raises(ValueError):     # offload needs a sparse method
        _port_engine("none", offload_cfg=OffloadConfig(mode="sync"))


def test_offload_config_precedence_and_replace():
    # nested populates the flat mirror, silently
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sc = ServeConfig(offload_cfg=OffloadConfig(mode="overlap",
                                                   shards=2))
    assert (sc.offload, sc.offload_shards) == ("overlap", 2)
    # flat kwargs are deprecated: they warn, and win over a conflicting
    # nested config
    with pytest.warns(DeprecationWarning, match="offload_cfg"):
        sc = ServeConfig(offload="sync",
                         offload_cfg=OffloadConfig(mode="overlap"))
    assert sc.offload == "sync" and sc.offload_cfg.mode == "sync"
    with pytest.warns(DeprecationWarning, match="deprecated"):
        sc = ServeConfig(offload="overlap", offload_shards=2)
    assert sc.offload_cfg == OffloadConfig(mode="overlap", shards=2)
    with pytest.warns(DeprecationWarning):
        sc = dataclasses.replace(ServeConfig(), offload="overlap")
    assert sc.offload_cfg.mode == "overlap"
    # replace on the nested surface updates the flat mirror silently, and
    # an unrelated replace() carries the coherent pair without warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sc = dataclasses.replace(ServeConfig(),
                                 offload_cfg=OffloadConfig(mode="sync"))
        assert sc.offload == "sync"
        sc2 = dataclasses.replace(sc, fused_steps=2)
    assert sc2.offload_cfg.mode == "sync" and sc2.offload == "sync"
    assert sc2.fused_steps == 2
    # the same outcomes as the reference's ServeConfig
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for kw in (dict(offload="sync"), dict(offload_validate=True,
                                               offload="overlap")):
            a = ServeConfig(**kw).offload_cfg
            b = JServeConfig(**kw).offload_cfg
            assert (a.mode, a.validate, a.shards, a.main_mesh) == \
                (b.mode, b.validate, b.shards, b.main_mesh)


def test_table_view_cache():
    """Steady-state decode reuses the sliced table view; admissions and
    releases (host-table pushes) invalidate it."""
    eng = _port_engine("none")
    prompts = _prompts((16, 9), seed=6)
    eng.submit(Request(0, prompts[0], 4))
    eng.submit(Request(1, prompts[1], 4))
    eng.poll()                             # admit both (one decode step)
    lengths = np.where(eng._decode_live(), eng.slots.lengths(),
                       0).astype(np.int32)
    v1 = eng._table_view(lengths)
    v2 = eng._table_view(lengths)
    assert v1 is v2                        # cache hit: the same tensor
    ver = eng.pool.table_version
    eng.step_pool()                        # decode does not edit the table
    assert eng.pool.table_version == ver
    for _ in range(8):                     # drain to release (table push)
        eng.step_pool()
    assert eng.pool.table_version > ver
    v3 = eng._table_view(lengths)
    assert v3 is not v1                    # the version bump invalidated it


# ---------------------------------------------------------------------------
# property: arbitrary window widths x slot-length mixes
# ---------------------------------------------------------------------------


@settings(deadline=None, max_examples=3)
@given(st.integers(2, 6), st.integers(4, 20), st.integers(4, 20),
       st.integers(1, 7), st.integers(1, 7))
def test_fused_property_bitmatch(K, n1, n2, m1, m2):
    prompts = _prompts((n1, n2), seed=n1 * 29 + n2)
    ref, _, _, _ = _run(_port_engine("dsa"), prompts, (m1, m2))
    got, _, _, _ = _run(_port_engine("dsa", fused_steps=K), prompts,
                        (m1, m2))
    assert got == ref
