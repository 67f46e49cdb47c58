"""The port's retrieval slice on the CPU against the JAX package's: BM25
candidates and top-k, the synthetic corpus, the RAG and MaC method
functions and pipelines, the corpus store and the MaC banks, and the
serving engine with retrieval (ports of ``tests/test_retrieval.py``), each
held inside the port and against the JAX engine's token streams and
retrieval events.

Same seeded numpy inputs on both sides; Pallas runs in interpret mode
through ``repro.kernels``. Smoke config at dtype float32 (at bf16 the two
frameworks round at other places, and a late greedy token of a spliced
request can flip), tp=4, the reference's fixture sizes (48 docs, retrieval
vocab 128, doc_max 8, embeddings of 16). Tolerances: scores within 1e-5
relative (fp32 on both sides; summation order, ``log`` and the ``avgdl``
mean may differ by an ulp), ids, tokens and events exactly. The port's modes run on
the CPU in program order; their streams are compared with the JAX engine's
inline run, which the reference's own test holds equal to its other modes.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.methods import mac as jmac  # noqa: E402
from repro.core.methods import rag as jrag  # noqa: E402
from repro.data import build_corpus as jbuild_corpus  # noqa: E402
from repro.data import sample_queries as jsample_queries  # noqa: E402
from repro.kernels import bm25_topk as jbm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.retrieval import RetrievalConfig as JRetrievalConfig  # noqa: E402
from repro.retrieval import RetrievalService as JRetrievalService  # noqa: E402
from repro.retrieval import rag_hybrid_scores as jhybrid  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.methods import mac as tmac  # noqa: E402
from repro_torch.core.methods import offload_stages  # noqa: E402
from repro_torch.core.methods import rag as trag  # noqa: E402
from repro_torch.data import build_corpus, sample_queries  # noqa: E402
from repro_torch.hetero import TransferLedger, resolve_cli_retrieval  # noqa: E402,E501
from repro_torch.kernels import bm25_topk as tbm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.retrieval import (RetrievalConfig, RetrievalService,  # noqa: E402
                                   make_retrieval_select, rag_hybrid_scores)
from repro_torch.serving import Engine, Request, Scheduler, ServeConfig  # noqa: E402,E501
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-5
TP = 4
MODES = ("inline", "sync", "overlap")
CORPUS_KW = dict(retrieval_vocab=128, doc_max=8, embed_dim=16, seed=0)


def _t(a):
    return torch.from_numpy(np.array(a))


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
    # the JAX engine's MaC weights (its key is PRNGKey(0))
    mp = from_jax_params(_np_tree(jmac.mac_init(jax.random.PRNGKey(0), jcfg)),
                         "cpu")
    return jcfg, tcfg, jparams, tparams, jc, tc, mp


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL)


def _free_pages_zero(pool) -> bool:
    """Every page on the free list (and the reserved page 0) is zero."""
    idx = torch.as_tensor([0] + pool.free, dtype=torch.long)
    return not pool.device["k_pages"][:, idx].any() and \
        not pool.device["v_pages"][:, idx].any()


def _drain(eng, n_steps):
    got = {}
    for _ in range(n_steps):
        for rid, _slot, tok in eng.poll():
            got.setdefault(rid, []).append(int(tok))
    return got


def _events(eng, spliced=True):
    return [(e["slot"], tuple(e["ids"])) + ((e["spliced"],) if spliced
                                            else ())
            for e in eng.retrieval.events]


def _rag_kw(**kw):
    base = dict(kind="rag", k=2, trigger="flare", tau=1.1, min_interval=3,
                max_retrievals=1, query_window=6)
    base.update(kw)
    return base


def _mac_kw(**kw):
    base = dict(kind="mac", trigger="flare", tau=1.1, min_interval=2,
                max_retrievals=2, query_window=8)
    base.update(kw)
    return base


MAC_SHAPE = dict(segment_len=16, memory_slots=4, retrieve_k=2)
SC = dict(max_len=128, n_slots=2, method="none", tp=TP, kv_page_size=16)


def _engines(setup, rkw, mode, sc_kw=None, validate=True):
    """The JAX engine and the port's engine with the same retrieval config
    (the corpus / MaC bank shape made on each side)."""
    jcfg, tcfg, jparams, tparams, jc, tc, mp = setup
    sc_kw = dict(SC, **(sc_kw or {}))
    jr, tr = dict(rkw), dict(rkw)
    if rkw["kind"] == "rag":
        jr["corpus"], tr["corpus"] = jc, tc
    else:
        jr["mac"] = jmac.MacConfig(**MAC_SHAPE)
        tr["mac"] = tmac.MacConfig(**MAC_SHAPE)
    jeng = JEngine(jcfg, jparams, JServeConfig(
        retrieval=JRetrievalConfig(mode=mode, validate=validate, **jr),
        **sc_kw), key=jax.random.PRNGKey(0))
    teng = Engine(tcfg, tparams, ServeConfig(
        retrieval=RetrievalConfig(mode=mode, validate=validate, **tr),
        **sc_kw), device="cpu", retrieval_params=mp)
    return jeng, teng


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """One JAX engine run per named case, shared by the tests."""
    setup = _setup()
    jcfg = setup[0]
    if name == "rag":
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
                   for n in (16, 9)]
        jeng, _ = _engines(setup, _rag_kw(), "inline")
        for i, p in enumerate(prompts):
            jeng.submit(JRequest(i, p, 8))
        return prompts, _drain(jeng, 26), _events(jeng)
    if name == "mac":
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
                   for n in (40, 22)]
        jeng, _ = _engines(setup, _mac_kw(), "inline")
        for i, p in enumerate(prompts):
            jeng.submit(JRequest(i, p, 8))
        return prompts, _drain(jeng, 34), _events(jeng, spliced=False)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# kernels: BM25 candidates and the public op
# ---------------------------------------------------------------------------


def _panel(B, D, T, seed, kind="poisson"):
    rng = np.random.default_rng(seed)
    tf = np.zeros((B, D, T)) if kind == "zero" else rng.poisson(0.8, (B, D, T))
    dl = rng.integers(8, 64, (B, D)).astype(np.float64)
    if kind == "dup":                      # rows in equal pairs: exact ties
        tf[:, 1::2], dl[:, 1::2] = tf[:, ::2], dl[:, ::2]
    idf = rng.random((B, T)) + 0.1
    return [a.astype(np.float32) for a in (tf, dl, idf)]


@pytest.mark.parametrize("B,D,T,block,c,valid,kind", [
    (1, 64, 4, 16, 4, 0, "poisson"),
    (2, 128, 8, 32, 8, 100, "poisson"),   # live count mid-block
    (3, 32, 1, 8, 8, 7, "poisson"),       # T=1, fewer live docs than c
    (2, 64, 4, 64, 64, 0, "zero"),        # every score 0: ids 0..c-1
    (2, 64, 6, 16, 16, 0, "dup"),         # equal nonzero scores
])
def test_bm25_candidates_match_pallas(B, D, T, block, c, valid, kind):
    tf, dl, idf = _panel(B, D, T, seed=D + T, kind=kind)
    jv, ji = jbm.bm25_topk_candidates(
        jnp.asarray(tf), jnp.asarray(dl), jnp.asarray(idf), block=block, c=c,
        avgdl=30.0, valid=valid, interpret=True)
    tv, ti = tbm.bm25_topk_candidates(_t(tf), _t(dl), _t(idf), block=block,
                                      c=c, avgdl=30.0, valid=valid)
    assert tv.shape == (B, D // block, min(c, block)) and ti.dtype == torch.int32
    np.testing.assert_array_equal(np.isfinite(tv.numpy()),
                                  np.isfinite(np.asarray(jv)))
    fin = np.isfinite(np.asarray(jv))
    _close(tv.numpy()[fin], np.asarray(jv)[fin])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if kind == "zero":
        np.testing.assert_array_equal(ti.numpy()[:, 0], np.arange(c)[None]
                                      .repeat(B, 0))
    # a 0-d int32 tensor live count reads as the int
    tv2, ti2 = tbm.bm25_topk_candidates(
        _t(tf), _t(dl), _t(idf), block=block, c=c, avgdl=30.0,
        valid=torch.tensor(valid, dtype=torch.int32))
    assert torch.equal(ti2, ti) and torch.equal(tv2, tv)


@pytest.mark.parametrize("D,k,block,valid", [
    (100, 6, 32, None),     # D not a power of two: padded with tf 0, dl 1
    (100, 6, 32, 37),
    (48, 64, 4096, None),   # k > D: clamped
    (300, 5, 4096, 250),
])
def test_ops_bm25_topk_matches_reference(D, k, block, valid):
    tf, dl, idf = _panel(2, D, 6, seed=D)
    args = [jnp.asarray(x) for x in (tf, dl, idf)]
    jv, ji = jops.bm25_topk(*args, k, block=block, avgdl=25.0, valid=valid)
    targs = [_t(x) for x in (tf, dl, idf)]
    for kernels in (True, False):
        tops.use_kernels(kernels)
        try:
            tv, ti = tops.bm25_topk(*targs, k, block=block, avgdl=25.0,
                                    valid=valid)
        finally:
            tops.use_kernels(True)
        assert ti.shape == (2, min(k, D))
        fin = np.isfinite(np.asarray(jv))
        _close(tv.numpy()[fin], np.asarray(jv)[fin])
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_bm25_candidates_check_their_arguments():
    tf, dl, idf = (_t(x) for x in _panel(1, 64, 4, seed=0))
    with pytest.raises(ValueError):
        tbm.bm25_topk_candidates(tf, dl, idf, block=48)       # 64 % 48
    with pytest.raises(ValueError):
        tbm.bm25_topk_candidates(tf, dl[:, :32], idf, block=16)


# ---------------------------------------------------------------------------
# corpus, RAG functions and pipelines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,embed_dim,seed", [(48, 16, 0), (37, 0, 5)])
def test_corpus_and_queries_bit_equal(n, embed_dim, seed):
    kw = dict(retrieval_vocab=128, doc_max=8, gen_vocab=512,
              embed_dim=embed_dim, seed=seed)
    jc, tc = jbuild_corpus(n, **kw), build_corpus(n, device="cpu", **kw)
    for f in ("tf", "doc_len", "idf", "doc_tokens", "doc_embeds"):
        a, b = getattr(jc, f), getattr(tc, f)
        if a is None:
            assert b is None
            continue
        assert b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        sample_queries(tc, 5, 6, seed=seed + 1).numpy(),
        np.asarray(jsample_queries(jc, 5, 6, seed=seed + 1)))
    assert tc.n_docs == jc.n_docs
    assert tc.avgdl == pytest.approx(jc.avgdl, rel=TOL)


def test_idf_and_corpus_slice(setup):
    jc, tc = setup[4], setup[5]
    df = np.arange(0, 40, 3)
    _close(trag.idf_from_df(_t(df), 48), jrag.idf_from_df(jnp.asarray(df),
                                                          48))
    _close(trag.idf_from_df(_t(df), torch.tensor(45, dtype=torch.int32)),
           jrag.idf_from_df(jnp.asarray(df), jnp.asarray(45, jnp.int32)))
    js, ts = jrag.corpus_slice(jc, 5, 21), trag.corpus_slice(tc, 5, 21)
    np.testing.assert_array_equal(ts.tf.numpy(), np.asarray(js.tf))
    np.testing.assert_array_equal(ts.doc_embeds.numpy(),
                                  np.asarray(js.doc_embeds))
    _close(ts.idf, js.idf)


@pytest.mark.parametrize("fused", [True, False])
def test_bm25_retrieve_matches_reference(setup, fused):
    jc, tc = setup[4], setup[5]
    q = np.asarray(jsample_queries(jc, 4, 6, seed=2))
    jv, ji = jrag.bm25_retrieve(jc, jnp.asarray(q), 5, fused=fused)
    tv, ti = trag.bm25_retrieve(tc, _t(q), 5, fused=fused)
    _close(tv, jv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_hybrid_rerank_and_append(setup):
    jc, tc = setup[4], setup[5]
    q = np.asarray(jsample_queries(jc, 3, 6, seed=4))
    qe = np.random.default_rng(4).standard_normal((3, 16)).astype(np.float32)
    jv, ji = jrag.hybrid_retrieve(jc, jnp.asarray(q), jnp.asarray(qe), 8)
    tv, ti = trag.hybrid_retrieve(tc, _t(q), _t(qe), 8)
    _close(tv, jv)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    def score(qt, docs):            # overlap of query and doc token sums
        return (docs.sum(-1) % 7) * 1.0 + qt.sum(-1, keepdims=True) * 0.0

    jr = jrag.rerank(lambda a, b: score(a, b).astype(jnp.float32), jc,
                     jnp.asarray(q), ji, 3)
    tr = trag.rerank(lambda a, b: score(a, b).float(), tc, _t(q), ti, 3)
    _close(tr[0], jr[0])
    np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]))
    for max_len in (12, 100):
        np.testing.assert_array_equal(
            trag.append_to_query(tc, _t(q), ti[:, :2], max_len).numpy(),
            np.asarray(jrag.append_to_query(jc, jnp.asarray(q), ji[:, :2],
                                            max_len)))


def test_triggers_match_reference():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((5, 64)) * np.array(
        [0.1, 1, 3, 6, 12])[:, None]).astype(np.float32)
    w = np.log1p(np.array([3, 10, 40, 100, 400], np.float32))
    for tau in (0.05, 0.2, 0.5, 0.9):
        np.testing.assert_array_equal(
            trag.flare_trigger(_t(logits), tau).numpy(),
            np.asarray(jrag.flare_trigger(jnp.asarray(logits), tau)))
    for tau in (1.0, 5.0, 20.0):
        np.testing.assert_array_equal(
            trag.dragin_trigger(_t(logits), _t(w), tau).numpy(),
            np.asarray(jrag.dragin_trigger(jnp.asarray(logits),
                                           jnp.asarray(w), tau)))


@pytest.mark.parametrize("fused", [False, True])
def test_rag_pipeline_matches_reference(setup, fused):
    jc, tc = setup[4], setup[5]
    q = np.asarray(jsample_queries(jc, 3, 6, seed=8))
    jp = jrag.build_pipeline(jc, 4, fused=fused)
    tp = trag.build_pipeline(tc, 4, fused=fused)
    assert tp.name == jp.name and tp.fused == jp.fused
    np.testing.assert_array_equal(tp.run(None, _t(q)).numpy(),
                                  np.asarray(jp.run(None, jnp.asarray(q))))


# ---------------------------------------------------------------------------
# MaC functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["topk", "weighted"])
def test_mac_functions_match_reference(setup, mode):
    jcfg, mp = setup[0], setup[6]
    jmp = jmac.mac_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(9)
    d = jcfg.d_model
    hidden = rng.standard_normal((2, 12, d)).astype(np.float32)
    seg = rng.standard_normal((2, 10, d)).astype(np.float32)
    bank = rng.standard_normal((2, 6, d)).astype(np.float32)
    bank[:, 4] = bank[:, 1]                # a tie in the bank scores
    jmc = jmac.MacConfig(memory_slots=6, retrieve_k=3, mode=mode)
    tmc = tmac.MacConfig(memory_slots=6, retrieve_k=3, mode=mode)
    _close(tmac.prepare_memory(mp, _t(hidden)),
           jmac.prepare_memory(jmp, jnp.asarray(hidden)))
    jsc = jmac.compute_relevancy(jmp, jnp.asarray(seg), jnp.asarray(bank))
    tsc = tmac.compute_relevancy(mp, _t(seg), _t(bank))
    _close(tsc, jsc)
    for count in (2, 5, 6):
        _close(tmac.retrieve(_t(bank), tsc, torch.tensor(count), tmc),
               jmac.retrieve(jnp.asarray(bank), jsc, jnp.asarray(count), jmc))
    jstate = {"bank": jnp.asarray(bank), "count": jnp.asarray(5, jnp.int32)}
    tstate = {"bank": _t(bank), "count": torch.tensor(5, dtype=torch.int32)}
    new = rng.standard_normal((2, d)).astype(np.float32)
    for _ in range(2):                     # the count saturates at M
        jstate = jmac.push(jstate, jnp.asarray(new))
        tstate = tmac.push(tstate, _t(new))
        np.testing.assert_array_equal(tstate["bank"].numpy(),
                                      np.asarray(jstate["bank"]))
        assert int(tstate["count"]) == int(jstate["count"])
    empty = tmac.push(tmac.bank_init(setup[1], tmc, 2, device="cpu"),
                      _t(new))
    jempty = jmac.push(jmac.bank_init(jcfg, jmc, 2), jnp.asarray(new))
    np.testing.assert_array_equal(empty["bank"].numpy(),
                                  np.asarray(jempty["bank"]))
    assert int(empty["count"]) == int(jempty["count"]) == 1
    jctx, _ = jmac.segment_step(jmp, jstate, jnp.asarray(seg), jmc)
    tctx, _ = tmac.segment_step(mp, tstate, _t(seg), tmc)
    _close(tctx, jctx)
    jpipe = jmac.build_pipeline(jmp, jmc).run((jnp.asarray(hidden), jstate),
                                              jnp.asarray(seg))
    tpipe = tmac.build_pipeline(mp, tmc).run((_t(hidden), tstate), _t(seg))
    _close(tpipe, jpipe)


def test_extend_paged_with_embeddings_matches_reference(setup):
    """Chunked extend with pre-embedded rows (the MaC splice): logits and
    the written pages equal the JAX model's; rows without embeddings read
    their tokens."""
    from repro.models import model as JM
    from repro_torch.models import model as TM

    jcfg, tcfg, jparams, tparams = setup[:4]
    B, C, ps, max_len = 3, 8, 16, 64
    rng = np.random.default_rng(10)
    toks = rng.integers(0, jcfg.vocab_size, (B, C)).astype(np.int32)
    xe = rng.standard_normal((B, C, jcfg.d_model)).astype(np.float32)
    rows = np.array([True, False, True])
    n_valid = np.array([8, 5, 2], np.int32)
    lengths = np.array([16, 3, 0], np.int32)
    NP = max_len // ps
    table = np.arange(1, B * NP + 1, dtype=np.int32).reshape(B, NP)
    jpool = JM.make_page_pool(jcfg, B, max_len, page_size=ps,
                              total_pages=B * NP + 1, tp=TP)
    tpool = TM.make_page_pool(tcfg, B, max_len, page_size=ps,
                              total_pages=B * NP + 1, tp=TP, device="cpu")
    jpool.update(page_table=jnp.asarray(table), lengths=jnp.asarray(lengths))
    tpool.update(page_table=_t(table), lengths=_t(lengths))
    jl, jpool = JM.extend_paged(jparams, jcfg, jnp.asarray(toks), jpool,
                                jnp.asarray(n_valid), tp=TP,
                                x_embeds=jnp.asarray(xe),
                                emb_rows=jnp.asarray(rows))
    tl, tpool = TM.extend_paged(tparams, tcfg, _t(toks), tpool, _t(n_valid),
                                tp=TP, x_embeds=_t(xe), emb_rows=_t(rows))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tpool["k_pages"].numpy(),
                               np.asarray(jpool["k_pages"]), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# ports of tests/test_retrieval.py: corpus store / service
# ---------------------------------------------------------------------------


def test_store_matches_inline_bm25(setup):
    """The store's fused query returns the same doc ids as the inline BM25
    path (and as the JAX service), spans are the docs' true-length
    payloads, and the ledger counts the exchange."""
    jc, tc = setup[4], setup[5]
    svc = RetrievalService(tc, k=4, device="cpu")
    q = sample_queries(tc, 3, 6, seed=1).numpy()
    ids, spans = svc.collect(svc.query(q))
    _, ref = trag.bm25_retrieve(tc, _t(q), k=4, fused=True)
    np.testing.assert_array_equal(ids, ref.numpy())
    jsvc = JRetrievalService(jc, k=4)
    jids, _ = jsvc.collect(jsvc.query(q))
    np.testing.assert_array_equal(ids, jids)
    doc_toks, doc_len = tc.doc_tokens.numpy(), tc.doc_len.numpy().astype(int)
    want = np.concatenate([doc_toks[i, : doc_len[i]] for i in ids[0]])
    np.testing.assert_array_equal(spans[0], want)
    led = svc.ledger.as_dict()
    assert led["down_bytes"] == q.size * 4 and led["up_bytes"] == ids.size * 4
    assert led["span_bytes"] == sum(s.nbytes for s in spans)
    # the hybrid first pass over the store, against the JAX store's
    qe = np.random.default_rng(2).standard_normal((3, 16)).astype(np.float32)
    hv, hi = svc.query_hybrid(q, qe, 6)
    jv, ji = jax.lax.top_k(jhybrid(jsvc.state, jnp.asarray(q),
                                   jnp.asarray(qe)), 6)
    _close(hv, jv)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(ji))
    _close(rag_hybrid_scores(svc.state, _t(q), _t(qe))[:, :48],
           jhybrid(jsvc.state, jnp.asarray(q), jnp.asarray(qe))[:, :48])


def test_incremental_ingest_appends_without_rejit(setup):
    """New docs append in fixed blocks: while the capacity holds, an ingest
    allocates no new store tensor (the port's counterpart of the
    reference's "no re-jit"); queries see the new docs, as the JAX
    service's do."""
    jc, tc = setup[4], setup[5]
    svc = RetrievalService(tc, k=4, capacity=256, device="cpu")
    jsvc = JRetrievalService(jc, k=4, capacity=256)
    q = sample_queries(tc, 2, 6, seed=2).numpy()
    svc.collect(svc.query(q))
    ptrs = {k: svc.state[k].data_ptr() for k in svc.DOC_AXIS}
    kw = dict(retrieval_vocab=128, doc_max=8, gen_vocab=512, embed_dim=16,
              seed=11)
    extra, jextra = build_corpus(40, device="cpu", **kw), \
        jbuild_corpus(40, **kw)
    svc.ingest(extra)
    svc.ingest(trag.corpus_slice(extra, 0, 16))
    jsvc.ingest(jextra)
    jsvc.ingest(jrag.corpus_slice(jextra, 0, 16))
    assert svc.n_docs == tc.n_docs + 56 == jsvc.n_docs
    assert {k: svc.state[k].data_ptr() for k in svc.DOC_AXIS} == ptrs
    assert svc.capacity == 256
    for k in ("tf", "doc_len", "doc_tokens", "df", "n_docs"):
        np.testing.assert_array_equal(svc.state[k].numpy(),
                                      np.asarray(jsvc.state[k]))
    ids, _ = svc.collect(svc.query(q))
    assert (ids < svc.n_docs).all() and (ids >= 0).all()
    np.testing.assert_array_equal(ids, jsvc.collect(jsvc.query(q))[0])
    q2 = sample_queries(extra, 2, 6, seed=3).numpy()
    ids2, _ = svc.collect(svc.query(q2))
    assert (ids2 >= tc.n_docs).any()
    np.testing.assert_array_equal(ids2, jsvc.collect(jsvc.query(q2))[0])


def test_ingest_grow_and_partial_block():
    """Growth pads only the doc-axis tensors (df/idf run over the retrieval
    vocab, which equals the capacity by shape here) and reallocates them; a
    partial final block at the capacity edge appends without growing."""
    kw = dict(retrieval_vocab=128, doc_max=8, gen_vocab=512)
    c = build_corpus(128, seed=2, device="cpu", **kw)
    jcorp = jbuild_corpus(128, seed=2, **kw)
    svc = RetrievalService(c, k=4, device="cpu")  # capacity == vocab == 128
    jsvc = JRetrievalService(jcorp, k=4)
    ptr = svc.state["tf"].data_ptr()
    svc.ingest(trag.corpus_slice(c, 0, 40))
    jsvc.ingest(jrag.corpus_slice(jcorp, 0, 40))
    assert svc.capacity == 256 and svc.n_docs == 168
    assert svc.state["tf"].data_ptr() != ptr
    assert svc.state["df"].shape == (128,)
    q = sample_queries(c, 2, 6, seed=4).numpy()
    ids, _ = svc.collect(svc.query(q))
    assert (ids >= 0).all() and (ids < svc.n_docs).all()
    np.testing.assert_array_equal(ids, jsvc.collect(jsvc.query(q))[0])
    c2 = build_corpus(120, seed=3, device="cpu", **kw)
    s2 = RetrievalService(c2, k=4, capacity=128, ingest_block=64,
                          device="cpu")
    s2.ingest(trag.corpus_slice(c2, 0, 8))  # 120 + 8 == capacity: no grow
    assert s2.capacity == 128 and s2.n_docs == 128
    np.testing.assert_array_equal(s2.state["tf"][120:].numpy(),
                                  c2.tf[:8].numpy())
    np.testing.assert_array_equal(s2.state["tf"][:120].numpy(),
                                  c2.tf.numpy())


def test_replay_sees_the_store_of_its_query(setup):
    """A query pinned before an ingest replays against the panel it was
    scored from, although the ingest wrote the store in place."""
    tc = setup[5]
    svc = RetrievalService(tc, k=4, capacity=128, device="cpu")
    q = sample_queries(tc, 2, 6, seed=5).numpy()
    h = svc.query(q)
    svc.ingest(build_corpus(30, retrieval_vocab=128, doc_max=8,
                            gen_vocab=512, embed_dim=16, seed=12,
                            device="cpu"))
    assert svc.replay(h)
    ids, _ = svc.collect(h)
    assert (ids < tc.n_docs).all()


def test_make_offload_select_covers_rag_and_mac(setup):
    """The document-memory declarers of OFFLOAD_STAGES have their
    offload-side bundles (the sparse-attention ones wait for the hetero
    offload port)."""
    jcfg, tcfg, tc = setup[0], setup[1], setup[5]
    declarers = [m for m in ("dsa", "seer", "lserve", "rag", "mac",
                             "memagent", "ttt", "none") if offload_stages(m)]
    assert set(declarers) == {"dsa", "seer", "lserve", "rag", "mac"}
    for m in ("rag", "mac"):
        sel = make_retrieval_select(
            m, tcfg, n_slots=2, corpus=tc, k=3,
            mac=tmac.MacConfig(segment_len=16, memory_slots=4, retrieve_k=2),
            device="cpu")
        assert sel.method == m and sel.n_sel >= 1
        assert sel.reset(sel.summary_init(), torch.tensor([0])) is not None
    with pytest.raises(KeyError):
        make_retrieval_select("dsa", tcfg)
    if not torch.cuda.is_available():      # the bank defaults to the card
        with pytest.raises(RuntimeError, match="cuda"):
            make_retrieval_select("mac", tcfg, n_slots=2,
                                  mac=tmac.MacConfig(segment_len=16))
    assert resolve_cli_retrieval("on") == "overlap"
    assert resolve_cli_retrieval("off") == ""
    with pytest.raises(ValueError):
        resolve_cli_retrieval("eager")
    led = TransferLedger()
    led.ship_down((torch.zeros(3), {"a": torch.zeros(2, dtype=torch.int32)}),
                  "cpu", bulk=True)
    assert led.as_dict()["bulk_prefill_bytes"] == 20


# ---------------------------------------------------------------------------
# ports of tests/test_retrieval.py: dynamic RAG in the serving loop
# ---------------------------------------------------------------------------


def test_rag_trigger_modes_bitmatch(setup):
    """FLARE firing mid-decode on pooled slots: doc splice through chunked
    extend; inline == sync == overlap token for token with the same doc
    ids, each equal to the JAX engine's; pages come back clean."""
    prompts, jstream, jevents = _jax_run("rag")
    for mode in MODES:
        _, eng = _engines(setup, _rag_kw(), mode)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, 8))
        assert _drain(eng, 26) == jstream, mode
        assert _events(eng) == jevents, mode
        assert len(jevents) == 2                  # one retrieval per slot
        assert eng.pool.pages_in_use() == 0
        assert _free_pages_zero(eng.pool)         # zero-page invariant
        assert eng.retrieval.report()["retrievals"] == 2


def test_inline_matches_stop_retrieve_resume_oracle(setup):
    """The pooled inline schedule == a hand-rolled oracle: stop at the
    trigger, retrieve with the standalone BM25 path, append the docs to the
    context, regenerate the pending token, resume per-request decode. The
    stream also equals the JAX engine's."""
    jcfg, tcfg, _, tparams, _, tc, _ = setup
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, jcfg.vocab_size, size=12).astype(np.int32)
    max_new = 10
    jeng, eng = _engines(setup, _rag_kw(min_interval=4), "inline",
                         validate=False)
    eng.submit(Request(0, prompt, max_new))
    stream = _drain(eng, 30)[0]
    jeng.submit(JRequest(0, prompt, max_new))
    assert _drain(jeng, 30)[0] == stream
    assert _events(eng) == _events(jeng)
    assert len(stream) == max_new
    [event] = eng.retrieval.events
    n_before = event["hist_len"] - len(prompt)   # tokens fed pre-trigger
    ctx = np.concatenate([prompt, np.asarray(stream[:n_before], np.int32)])
    q = (ctx[-6:] % tc.tf.shape[1]).astype(np.int32)
    _, ids = trag.bm25_retrieve(tc, _t(q)[None], k=2, fused=True)
    np.testing.assert_array_equal(ids[0].numpy(), event["ids"])
    doc_toks, doc_len = tc.doc_tokens.numpy(), tc.doc_len.numpy().astype(int)
    span = np.concatenate([doc_toks[i, : doc_len[i]] for i in ids[0].numpy()])
    prompt2 = np.concatenate([ctx, span]).astype(np.int32)
    eng2 = Engine(tcfg, tparams, ServeConfig(**SC), device="cpu")
    cont = eng2.generate(prompt2[None], max_new - n_before)[0]
    np.testing.assert_array_equal(np.asarray(stream[n_before:]), cont)


def test_trigger_gating(setup):
    """tau below any confidence never fires; the per-request retrieval
    budget and the per-request opt-out are honored, as in the JAX
    engine."""
    jcfg = setup[0]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, size=10).astype(np.int32)
               for _ in range(2)]
    _, eng = _engines(setup, _rag_kw(tau=0.0), "inline", validate=False)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, 6))
    _drain(eng, 10)
    assert eng.retrieval.events == []          # never fires at tau=0
    jeng2, eng2 = _engines(setup, _rag_kw(tau=1.1, min_interval=2,
                                          max_retrievals=2), "inline",
                           validate=False)
    for e, R in ((eng2, Request), (jeng2, JRequest)):
        for i, (p, opt) in enumerate(zip(prompts, (True, False))):
            e.submit(R(i, p, 10, retrieval=opt))
    streams = [_drain(e, 40) for e in (eng2, jeng2)]
    assert streams[0] == streams[1]
    assert _events(eng2) == _events(jeng2)
    per_slot = {}
    for e in eng2.retrieval.events:
        per_slot[e["slot"]] = per_slot.get(e["slot"], 0) + 1
    assert per_slot.get(0, 0) == 2             # budget reached
    assert 1 not in per_slot                   # opted out


# ---------------------------------------------------------------------------
# ports of tests/test_retrieval.py: MaC memory banks, scheduler
# ---------------------------------------------------------------------------


def test_mac_bank_modes_bitmatch(setup):
    """Segment summaries pushed at page boundaries, retrieved embeddings
    spliced through chunked extend: the three modes bit-match and report
    the same bank indices, each equal to the JAX engine's (MaC weights from
    its key)."""
    prompts, jstream, jevents = _jax_run("mac")
    assert jevents, "no MaC retrieval fired"
    for mode in MODES:
        _, eng = _engines(setup, _mac_kw(), mode)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, 8))
        assert _drain(eng, 34) == jstream, mode
        assert _events(eng, spliced=False) == jevents, mode
        assert eng.pool.pages_in_use() == 0
        assert _free_pages_zero(eng.pool)
        assert eng.retrieval.mc.segment_len == 16


def test_scheduler_serves_retrieval_requests(setup):
    """Overlapped retrieval under the scheduler: paused slots do not trip
    the drain loop's brake, all requests finish, DRAGIN triggers fire; the
    token streams equal the JAX scheduler's."""
    jcfg = setup[0]
    rng = np.random.default_rng(9)
    sc = dict(prefill_chunk=16, chunk_threshold=32)
    rkw = _rag_kw(trigger="dragin", tau=0.0, min_interval=4)
    jeng, eng = _engines(setup, rkw, "overlap", sc_kw=sc, validate=False)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (10, 40, 16)]
    out = []
    for e, S in ((eng, Scheduler), (jeng, JScheduler)):
        sch = S(e, prefill_token_budget=32)
        rids = [sch.submit(p, max_new=6) for p in prompts]
        done = sch.run()
        assert sorted(done) == sorted(rids)
        assert all(len(done[r].tokens) == 6 for r in rids)
        out.append({r: list(done[r].tokens) for r in rids})
    assert out[0] == out[1]
    assert eng.retrieval.events and _events(eng) == _events(jeng)
    assert eng.pool.pages_in_use() == 0
    assert _free_pages_zero(eng.pool)
