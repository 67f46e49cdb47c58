"""The port's heterogeneous offload subsystem (``repro_torch.hetero``) on
the CPU, ports of ``tests/test_hetero.py`` plus the hetero cases of
``tests/test_retrieval.py``:

  * the OVERLAPPED schedule emits what the SYNCHRONOUS schedule of the same
    two-phase dataflow emits, token for token, for dsa / seer / lserve, also
    under the scheduler with chunked admission, and equals the JAX engine's
    under ``offload="sync"``; pages come back clean;
  * Seer's threshold selection; stale-lookahead validity; the stage split;
    the dynamic fallback window and serving below ``min_context``;
  * each ``OffloadSelect`` bundle against the JAX package's: the summary
    after a span ingest and a step ingest (within 1e-5, fp32 sums in
    another order), the selected pages (equal), ties (ascending index);
  * ``make_offload_select`` covers every declarer; a retrieval slot and a
    sparse slot share the pool under the offload.

Smoke config at dtype float32, tp=4. On the CPU both sides run in program
order; the card runs the offload side on its own CUDA stream
(``tests/test_torch_cuda.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import placement as jplacement  # noqa: E402
from repro.hetero import plan_stage_placement as jplan  # noqa: E402
from repro.hetero.select import make_offload_select as jmake  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import OffloadConfig as JOffloadConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.core.methods import mac as tmac  # noqa: E402
from repro_torch.core.methods import offload_stages  # noqa: E402
from repro_torch.data import build_corpus  # noqa: E402
from repro_torch.hetero import (dynamic_mode, make_offload_select,  # noqa: E402
                                merge_shard_topk, pick_devices,
                                plan_stage_placement, resolve_cli_offload)
from repro_torch.retrieval import RetrievalConfig  # noqa: E402
from repro_torch.serving import (Engine, OffloadConfig, Request,  # noqa: E402
                                 Scheduler, ServeConfig)
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TP = 4
TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jget_arch("llama3.2-1b").smoke().replace(dtype="float32")
    tcfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    jparams = jinit(jcfg, jax.random.PRNGKey(0), tp=TP)
    return jcfg, tcfg, jparams, from_jax_params(_np_tree(jparams), "cpu")


@functools.lru_cache(maxsize=None)
def _sparse_params(method):
    """The JAX engine's method weights at key PRNGKey(0): (jax, port)."""
    jcfg, _, jparams, _ = _setup()
    jeng = JEngine(jcfg, jparams, JServeConfig(method=method, max_len=64,
                                               n_slots=2, tp=TP),
                   key=jax.random.PRNGKey(0))
    return jeng.sparse_params, from_jax_params(
        _np_tree(jeng.sparse_params), "cpu")


def _engine(method, mode, mem=None, **kw):
    _, tcfg, _, tparams = _setup()
    sc = dict(dict(max_len=64, n_slots=2, tp=TP, page=8, kv_page_size=16),
              **kw)
    return Engine(tcfg, tparams, ServeConfig(
        method=method, offload_cfg=OffloadConfig(
            mode=mode, validate=mode == "overlap"), **sc),
        device="cpu", sparse_params=_sparse_params(method)[1], mem=mem)


def _drain(eng, n_steps):
    got = {}
    for _ in range(n_steps):
        for rid, _slot, tok in eng.poll():
            got.setdefault(rid, []).append(int(tok))
    return got


def _free_pages_zero(pool) -> bool:
    """Every page on the free list (and the reserved page 0) is zero."""
    idx = torch.as_tensor([0] + pool.free, dtype=torch.long)
    return not pool.device["k_pages"][:, idx].any() and \
        not pool.device["v_pages"][:, idx].any()


def _prompts(sizes, seed):
    rng = np.random.default_rng(seed)
    vocab = _setup()[0].vocab_size
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in sizes]


# ---------------------------------------------------------------------------
# overlap == sync == the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["dsa", "seer", "lserve"])
def test_overlap_bitmatches_sync(method):
    """Overlapped offload decode == synchronous two-phase decode, token for
    token, for every sparse method, and == the JAX engine under sync; pages
    come back clean."""
    prompts = _prompts((16, 9), seed=0)
    streams = {}
    for mode in ("sync", "overlap"):
        eng = _engine(method, mode)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, 5))
        streams[mode] = _drain(eng, 6)
        assert eng.pool.pages_in_use() == 0
        assert _free_pages_zero(eng.pool)
        assert eng.hetero.profiler.offload_steps > 0
    assert streams["sync"] == streams["overlap"]
    jcfg, _, jparams, _ = _setup()
    jeng = JEngine(jcfg, jparams, JServeConfig(
        method=method, max_len=64, n_slots=2, tp=TP, page=8,
        kv_page_size=16, offload_cfg=JOffloadConfig(mode="sync")),
        key=jax.random.PRNGKey(0))
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(i, p, 5))
    jstreams = {rid: [int(t) for t in toks]
                for rid, toks in _drain(jeng, 6).items()}
    assert streams["sync"] == jstreams


def test_overlap_bitmatches_sync_under_scheduler():
    """Mixed workload (bucketed + chunked admission, staggered completion,
    per-slot lookahead invalidation) stays equal between the two schedules
    end to end, with lookahead hits and patches on the way."""
    prompts = _prompts((10, 40, 16, 33), seed=5)
    streams = {}
    for mode in ("sync", "overlap"):
        eng = _engine("dsa", mode, max_len=128, prefill_chunk=16,
                      chunk_threshold=32)
        sch = Scheduler(eng, prefill_token_budget=32)
        rids = [sch.submit(p, max_new=4) for p in prompts]
        done = sch.run()
        assert sorted(done) == sorted(rids)
        streams[mode] = {r: done[r].tokens for r in done}
        assert eng.pool.pages_in_use() == 0
        assert _free_pages_zero(eng.pool)
        la = eng.hetero.report()["lookahead"]
        assert la["hits"] > 0 and la["cold_starts"] > 0
    assert streams["sync"] == streams["overlap"]


def test_seer_threshold_selection_offloads():
    """Seer's threshold selection runs through the offload select and
    stays schedule-invariant."""
    mem = _setup()[1].memory.replace(method="seer", selection="threshold")
    prompt = _prompts((20,), seed=7)[0]
    streams = {}
    for mode in ("sync", "overlap"):
        eng = _engine("seer", mode, mem=mem)
        eng.submit(Request(0, prompt, 5))
        streams[mode] = _drain(eng, 6)
    assert streams["sync"] == streams["overlap"] and len(streams["sync"][0])


def test_stale_lookahead_validity():
    """validate=True replays every consumed selection inside the executor;
    on top, the pending lookahead holds only indices inside the live region
    it was computed from."""
    eng = _engine("dsa", "overlap", max_len=96)
    rng = np.random.default_rng(3)
    vocab = _setup()[0].vocab_size
    eng.submit(Request(0, rng.integers(0, vocab, size=24), 6))
    got = {}
    for step in range(8):
        for rid, _s, tok in eng.poll():
            got.setdefault(rid, []).append(tok)
        if step == 2:   # staggered admission forces a lookahead patch
            eng.submit(Request(1, rng.integers(0, vocab, size=12), 4))
        hx = eng.hetero
        if hx.sel_buf is not None:
            sel = hx.sel_buf.pidx.cpu().numpy()
            lens = hx._sel_inputs[3].cpu().numpy()
            ok = (sel == -1) | ((sel >= 0)
                                & (sel * hx.sel.page < lens[None, :, None]))
            assert ok.all(), "lookahead selected pages past the live region"
    assert len(got[0]) == 6 and len(got[1]) == 4
    assert eng.hetero.profiler.offload_steps > 0


def test_placement_policy_stage_split():
    """Paper §4/§5.2: the memory-bound index stages offload, the
    KV-touching apply and the compute-dense rest stay; on the H100's
    constants the plan is the reference's."""
    cfg = get_arch("llama3.2-1b")
    plan = plan_stage_placement(cfg, cfg.memory, context=65536)
    assert plan.stages["relevancy"] == "offload"
    assert plan.stages["retrieve"] == "offload"
    assert plan.stages["apply"] == "main"       # reads raw KV pages
    assert plan.stages["rest"] == "main"        # compute-dense remainder
    assert plan.memory_bound["retrieve"]
    jcfg = jget_arch("llama3.2-1b")
    jp = jplan(jcfg, jcfg.memory, context=65536)
    assert plan.stages == jp.stages
    for s, v in plan.intensity.items():         # the same cost model
        assert v == pytest.approx(jp.intensity[s], rel=1e-12)
    assert offload_stages("ttt") == ()
    assert offload_stages("memagent") == ()
    assert offload_stages("none") == ()
    assert "relevancy" in offload_stages("rag")
    # the roofline path choice: dense below min_context, then the model's
    assert placement.choose_path(cfg, cfg.memory, 1024) == "dense"
    for ctx in (4096, 65536, 1 << 20):
        assert placement.choose_path(cfg, cfg.memory, ctx) == \
            jplacement.choose_path(jcfg, jcfg.memory, ctx)
    assert placement.PAPER_TABLE2 == jplacement.PAPER_TABLE2


def test_dynamic_fallback_window():
    """The host-side fallback mirror: outside [min_context,
    fallback_context] the executor runs on the main side only."""
    mem = get_arch("llama3.2-1b").memory
    assert dynamic_mode(mem.min_context - 1, mem) == "local"
    assert dynamic_mode(mem.min_context, mem) == "offload"
    assert dynamic_mode(mem.fallback_context, mem) == "offload"
    assert dynamic_mode(mem.fallback_context + 1, mem) == "local"
    assert dynamic_mode(65536, mem.replace(method="ttt")) == "local"
    main, off = pick_devices("cpu")
    assert main == off == torch.device("cpu")
    assert resolve_cli_offload("on", "dsa") == "overlap"
    assert resolve_cli_offload("sync", "dsa") == "sync"
    with pytest.raises(ValueError):
        resolve_cli_offload("on", "none")


def test_dynamic_fallback_serves_below_min_context():
    """With min_context above the workload every step takes the local
    (dense) path, and the two schedules still agree."""
    mem = _setup()[1].memory.replace(method="dsa", min_context=1 << 16)
    prompt = _prompts((16,), seed=9)[0]
    streams = {}
    for mode in ("sync", "overlap"):
        eng = _engine("dsa", mode, mem=mem)
        eng.submit(Request(0, prompt, 4))
        streams[mode] = _drain(eng, 5)
        assert eng.hetero.profiler.local_steps > 0
        assert eng.hetero.profiler.offload_steps == 0
    assert streams["sync"] == streams["overlap"]


# ---------------------------------------------------------------------------
# the OffloadSelect bundles against the JAX package's
# ---------------------------------------------------------------------------


def _bundle_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    Hp = cfg.padded_heads(TP)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        k_span=f(L, 2, 24, KV, hd), slots=np.asarray([1, 0], np.int32),
        start=np.asarray([0, 5], np.int32),
        n_valid=np.asarray([24, 17], np.int32),
        k_new=f(L, 2, KV, hd), pos=np.asarray([24, 22], np.int32),
        live=np.asarray([True, False]), q=f(L, 2, Hp, hd),
        lengths=np.asarray([25, 22], np.int32))


@pytest.mark.parametrize("method", ["dsa", "seer", "seer-threshold",
                                    "lserve"])
def test_offload_select_bundles_match_reference(method):
    jcfg, tcfg = _setup()[:2]
    name = method.split("-")[0]
    kw = {"selection": "threshold", "threshold": 0.05} \
        if method == "seer-threshold" else {}
    jmem = jcfg.memory.replace(method=name, **kw)
    tmem = tcfg.memory.replace(method=name, **kw)
    jsp, tsp = _sparse_params(name)
    jsel = jmake(name, jcfg, jmem, dsa_page=8, n_slots=2, max_len=64)
    tsel = make_offload_select(name, tcfg, tmem, dsa_page=8, n_slots=2,
                               max_len=64, device="cpu")
    assert (tsel.page, tsel.n_sel, tsel.n_pages, tsel.n_part) == \
        (jsel.page, jsel.n_sel, jsel.n_pages, jsel.n_part)
    x = _bundle_inputs(tcfg, seed=11)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    # ties: the zero / sentinel summary scores every live page alike, and
    # the picks go by ascending page index on both sides
    js, ts = jsel.summary_init(), tsel.summary_init()
    tie = tsel.select(tsp, ts, t["q"], t["lengths"]).numpy()
    np.testing.assert_array_equal(
        tie, np.asarray(jsel.select(jsp, js, j["q"], j["lengths"])))
    live_tie = tie[0, 0][tie[0, 0] >= 0]
    assert (np.diff(live_tie) > 0).all()
    # a span ingest (admission / chunk), a reset, a step ingest
    js = jsel.ingest_span(js, jsp, j["k_span"], j["slots"], j["start"],
                          j["n_valid"])
    ts = tsel.ingest_span(ts, tsp, t["k_span"], t["slots"], t["start"],
                          t["n_valid"])
    js = jsel.reset(js, jnp.asarray([1]))
    ts = tsel.reset(ts, torch.tensor([1]))
    js = jsel.ingest_span(js, jsp, j["k_span"][:, :1], j["slots"][:1],
                          j["start"][:1], j["n_valid"][:1])
    ts = tsel.ingest_span(ts, tsp, t["k_span"][:, :1], t["slots"][:1],
                          t["start"][:1], t["n_valid"][:1])
    js = jsel.ingest(js, jsp, j["k_new"], j["pos"], j["live"])
    ts = tsel.ingest(ts, tsp, t["k_new"], t["pos"], t["live"])
    assert sorted(ts) == sorted(js)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=TOL, atol=TOL)
    got = tsel.select(tsp, ts, t["q"], t["lengths"])
    want = np.asarray(jsel.select(jsp, js, j["q"], j["lengths"]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).any()
    # inputs left as they were (the executor pins them)
    t2 = tsel.ingest(ts, tsp, t["k_new"], t["pos"], t["live"])
    for k in ts:
        assert t2[k] is not ts[k]


def test_merge_shard_topk_breaks_ties_by_index():
    vals = torch.tensor([[[1.0, 3.0, 3.0, 0.0, 3.0]]])
    idx = torch.tensor([[[7, 2, 5, 9, 11]]], dtype=torch.int32)
    v, i = merge_shard_topk(vals, idx, 3)
    assert v.tolist() == [[[3.0, 3.0, 3.0]]]
    assert i.tolist() == [[[2, 5, 11]]]


def test_make_offload_select_covers_all_declarers():
    """Every method that declares OFFLOAD_STAGES has an offload-side
    implementation reachable through make_offload_select."""
    tcfg = _setup()[1]
    corpus = build_corpus(48, retrieval_vocab=128, doc_max=8,
                          gen_vocab=tcfg.vocab_size, embed_dim=16, seed=0,
                          device="cpu")
    declarers = [m for m in ("dsa", "seer", "lserve", "rag", "mac",
                             "memagent", "ttt", "none")
                 if offload_stages(m)]
    assert set(declarers) == {"dsa", "seer", "lserve", "rag", "mac"}
    for m in declarers:
        sel = make_offload_select(
            m, tcfg, tcfg.memory, dsa_page=8, n_slots=2, max_len=64,
            corpus=corpus, rag_k=3,
            mac=tmac.MacConfig(segment_len=16, memory_slots=4,
                               retrieve_k=2), device="cpu")
        assert sel.method == m and sel.n_sel >= 1
    with pytest.raises(KeyError):
        make_offload_select("ttt", tcfg, tcfg.memory, dsa_page=8,
                            n_slots=2, max_len=64, device="cpu")


# ---------------------------------------------------------------------------
# mixed pool: a retrieval slot + an offloaded sparse-attention slot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["dsa", "lserve"])
def test_mixed_pool_with_hetero_offload(method):
    """A retrieval-enabled slot and a sparse-attention slot share the pool
    while the offload executor selects: the fully overlapped configuration
    equals the fully synchronous one."""
    tcfg = _setup()[1]
    corpus = build_corpus(48, retrieval_vocab=128, doc_max=8,
                          gen_vocab=tcfg.vocab_size, embed_dim=16, seed=0,
                          device="cpu")
    prompts = _prompts((16, 24), seed=5)
    streams = {}
    for off, rmode in (("sync", "inline"), ("overlap", "overlap")):
        rcfg = RetrievalConfig(kind="rag", mode=rmode, corpus=corpus, k=2,
                               trigger="flare", tau=1.1, min_interval=3,
                               max_retrievals=1, query_window=6)
        eng = _engine(method, off, max_len=128, retrieval=rcfg)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, 6, retrieval=[True, False][i]))
        streams[(off, rmode)] = _drain(eng, 24)
        assert eng.retrieval.events and \
            eng.retrieval.events[0]["slot"] == 0
        assert eng.hetero.profiler.offload_steps > 0
        assert eng.pool.pages_in_use() == 0
        assert _free_pages_zero(eng.pool)
    assert streams[("sync", "inline")] == streams[("overlap", "overlap")]


def test_report_and_ledger():
    """The executor's report: per-stage breakdown in sync mode, the
    index-only exchange (selection bytes up, keys / queries down) far below
    the KV pages a naive design would move."""
    eng = _engine("dsa", "sync")
    for i, p in enumerate(_prompts((16, 9), seed=1)):
        eng.submit(Request(i, p, 4))
    eng.drain()
    rep = eng.hetero.report()
    assert rep["mode"] == "sync" and rep["steps"] == rep["offload_steps"]
    assert set(rep["stage_fractions"]) == {"prepare", "relevancy",
                                           "retrieve", "apply", "rest"}
    tr = rep["transfer"]
    assert tr["up_bytes"] > 0 and tr["down_bytes"] > 0
    assert tr["bulk_prefill_bytes"] > 0
    assert rep["devices"] == {"main": "cpu", "offload": "cpu",
                              "distinct": False, "offload_stream": False}
