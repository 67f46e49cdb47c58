"""The port's memory-pipeline methods on the CPU against the JAX package's,
on the same numpy inputs and JAX-initialized weights: SeerAttention-R (top-k
and threshold) and LServe ``make_sparse_fn``, the page min/max op, LServe's
page bound, every method's four-stage ``build_pipeline`` (fused and
unfused), the unpaged ``prefill`` / ``decode_step``, and the ports of
``tests/test_pipeline.py``'s invariants.

Smoke config at dtype float32. Tolerances: 1e-5 abs on attention outputs and
scores (fp32 on both sides, different summation order), 1e-4 on logits
after two layers; page min/max and selections exactly. Seer runs at tp=4:
with dead TP heads (tp=16 at smoke width) the reference's seer gate does not
type-check, and the port's raises the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import methods as jmethods  # noqa: E402
from repro.core.methods import dsa as jdsa  # noqa: E402
from repro.core.methods import lserve as jlserve  # noqa: E402
from repro.core.methods import seer as jseer  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import methods as tmethods  # noqa: E402
from repro_torch.core.methods import lserve as tlserve  # noqa: E402
from repro_torch.core.methods import seer as tseer  # noqa: E402
from repro_torch.core.pipeline import MemoryPipeline, StageProfiler  # noqa: E402,E501
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import page_pool as tpool  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-5
LOGIT_TOL = 1e-4
JMOD = {"dsa": jdsa, "seer": jseer, "lserve": jlserve}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**mem):
    jcfg = jget_arch("llama3.2-1b").smoke().replace(dtype="float32")
    tcfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    return (jcfg.replace(memory=jcfg.memory.replace(**mem)),
            tcfg.replace(memory=tcfg.memory.replace(**mem)))


def _sparse_params(method, jcfg, seed=7):
    """One layer's weights of ``method`` from the JAX init, on both sides."""
    init, _ = jmethods.get_sparse_method(method)
    jsp = jax.tree.map(lambda a: a[0],
                       init(jax.random.PRNGKey(seed), jcfg, jcfg.memory))
    return jsp, from_jax_params(_np_tree(jsp), "cpu")


def _decode_inputs(cfg, tp, B=3, S=128, seed=0):
    """q [B,1,Hp,hd] with zero dead heads (their wq columns are zero), k/v
    [B,S,KV,hd] zero past each ragged length (as the pool view is)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, cfg.padded_heads(tp), cfg.hd),
                            dtype=np.float32)
    q[:, :, cfg.n_heads:] = 0
    kc = rng.standard_normal((B, S, cfg.n_kv_heads, cfg.hd), dtype=np.float32)
    vc = rng.standard_normal((B, S, cfg.n_kv_heads, cfg.hd), dtype=np.float32)
    lengths = np.array([S, 45, 9][:B], np.int32)
    for b, n in enumerate(lengths):
        kc[b, n:] = 0
        vc[b, n:] = 0
    return q, kc, vc, lengths


# ---------------------------------------------------------------------------
# make_sparse_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,tp,mem", [
    ("seer", 4, {}),
    ("seer", 4, {"selection": "threshold", "threshold": 0.2}),
    ("lserve", 4, {}),
    ("lserve", 16, {}),                      # dead TP heads in the mean
    ("lserve", 4, {"token_budget": 64}),     # two physical pages selected
], ids=["seer-topk", "seer-threshold", "lserve", "lserve-dead-heads",
        "lserve-budget64"])
def test_sparse_fn_matches_jax(method, tp, mem):
    jcfg, tcfg = _cfgs(**mem)
    jsp, tsp = _sparse_params(method, jcfg)
    q, kc, vc, lengths = _decode_inputs(jcfg, tp)
    jfn = JMOD[method].make_sparse_fn(jcfg, jcfg.memory, tp=tp)
    tfn = tmethods.module(method).make_sparse_fn(tcfg, tcfg.memory, tp=tp)
    want = jfn(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
               jnp.asarray(lengths), jsp)
    got = tfn(_t(q), _t(kc), _t(vc), _t(lengths), tsp)
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_seer_threshold_drops_blocks_that_topk_keeps():
    """The threshold case above really drops blocks: its output differs
    from top-k mode's on the same inputs (on both sides)."""
    outs = []
    for mem in ({}, {"selection": "threshold", "threshold": 0.2}):
        jcfg, tcfg = _cfgs(**mem)
        _, tsp = _sparse_params("seer", jcfg)
        q, kc, vc, lengths = _decode_inputs(tcfg, 4)
        fn = tseer.make_sparse_fn(tcfg, tcfg.memory, tp=4)
        outs.append(fn(_t(q), _t(kc), _t(vc), _t(lengths), tsp))
    assert not torch.allclose(outs[0], outs[1])


def test_seer_with_dead_heads_raises_like_the_reference():
    jcfg, tcfg = _cfgs()
    jsp, tsp = _sparse_params("seer", jcfg)
    q, kc, vc, lengths = _decode_inputs(jcfg, 16)
    with pytest.raises(TypeError):
        jseer.make_sparse_fn(jcfg, jcfg.memory, tp=16)(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(lengths), jsp)
    with pytest.raises(RuntimeError):
        tseer.make_sparse_fn(tcfg, tcfg.memory, tp=16)(
            _t(q), _t(kc), _t(vc), _t(lengths), tsp)


def test_lserve_dead_pages_tie_and_are_masked():
    """Pages past a short slot's length pool to min = max = 0 and score
    exactly 0; they tie, win the top-k by ascending index over negatively
    scored live pages, and are then masked to -1 (the reference's order)."""
    _, tcfg = _cfgs()
    mem = tcfg.memory
    ps, ppp = mem.block_size, mem.pages_per_physical
    q, kc, _, _ = _decode_inputs(tcfg, 4)
    rng = np.random.default_rng(1)
    kc = np.abs(rng.standard_normal(kc.shape, dtype=np.float32)) + 0.1
    q = -np.abs(q)                           # every live page scores < 0
    n = 2 * ps * ppp                         # slot 1 holds 2 physical pages
    kc[1, n:] = 0
    pmin, pmax = tlserve._page_bounds(_t(kc), ps, kernel=False)
    sc = tlserve._physical_scores(_t(q)[:, 0], pmin[:, :, None],
                                  pmax[:, :, None], ppp)
    assert (sc[1, 2:] == 0).all() and (sc[1, :2] < 0).all()
    _, phys = tref.topk_stable(sc, 2)
    assert phys[1].tolist() == [2, 3]
    logical = tlserve._logical_pages(phys, ppp)
    assert (logical[1] * ps >= n).all()      # all masked to -1 downstream


# ---------------------------------------------------------------------------
# page min/max and LServe's bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [8, 16])
def test_page_minmax_matches_jax(dtype, ps):
    """Exactly equal to the Pallas kernel (interpret mode) and to the JAX
    oracle, on mixed-sign values."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 64, 2, 32)).astype(np.float32) * 3 - 0.5
    k_j = k.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else k
    k_t = from_jax_params(k_j, "cpu")
    kern = jops.page_minmax(jnp.asarray(k_j), page_size=ps)
    orac = jref.page_minmax(jnp.asarray(k_j), ps)
    got = tops.page_minmax(k_t, page_size=ps)
    for g, a, b in zip(got, kern, orac):
        assert g.dtype == torch.float32 and g.shape == (2, 64 // ps, 2, 32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(a))
        np.testing.assert_array_equal(g.numpy(), np.asarray(b))


def test_page_minmax_rejects_ragged_pages():
    k = torch.zeros(1, 40, 2, 8)
    with pytest.raises(ValueError):
        tpool.page_minmax(k, page_size=16)
    with pytest.raises(ValueError):
        tpool.page_minmax_plain(k, page_size=16)


@pytest.mark.parametrize("KV", [1, 2])
def test_lserve_page_scores_match_jax(KV):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 16, 32)).astype(np.float32)
    q[:, 4:] = 0                                 # dead heads count in the mean
    pmin = rng.standard_normal((2, 8, KV, 32)).astype(np.float32)
    pmax = pmin + np.abs(rng.standard_normal((2, 8, KV, 32))).astype(
        np.float32)
    want = jref.lserve_page_scores(jnp.asarray(q), jnp.asarray(pmin),
                                   jnp.asarray(pmax))
    got = tref.lserve_page_scores(_t(q), _t(pmin), _t(pmax))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------


def _pipes(method, jcfg, tcfg, jsp, tsp, fused):
    kw = tmethods.sparse_kwargs(method, 8)
    tmod = tmethods.module(method)
    return (JMOD[method].build_pipeline(jcfg, jcfg.memory, jsp, fused=fused,
                                        **kw),
            tmod.build_pipeline(tcfg, tcfg.memory, tsp, fused=fused, **kw))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("method", ["dsa", "seer", "lserve"])
def test_build_pipeline_matches_jax(method, fused):
    """Each stage's output and the pipeline's result equal the reference's,
    over a full cache (the pipeline's apply attends to every position)."""
    jcfg, tcfg = _cfgs()
    jsp, tsp = _sparse_params(method, jcfg)
    q, kc, vc, _ = _decode_inputs(jcfg, 4, B=2, S=64, seed=5)
    kc = np.random.default_rng(6).standard_normal(kc.shape, dtype=np.float32)
    jp, tp_ = _pipes(method, jcfg, tcfg, jsp, tsp, fused)
    assert tp_.name == jp.name and tp_.fused == jp.fused
    jM, tM = (jnp.asarray(kc), jnp.asarray(vc)), (_t(kc), _t(vc))
    jI, tI = jp.prepare(jM), tp_.prepare(tM)
    for a, b in zip(jax.tree.leaves(tI), jax.tree.leaves(jI)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    jsel = jp.retrieve(jM, jp.relevancy(jI, jnp.asarray(q)))
    tsel = tp_.retrieve(tM, tp_.relevancy(tI, _t(q)))
    np.testing.assert_array_equal(tsel[2].numpy(), np.asarray(jsel[2]))
    want = jp.run(jM, jnp.asarray(q))
    got = tp_.run(tM, _t(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("method", ["dsa", "seer", "lserve"])
def test_fused_equals_unfused_pipeline(method):
    """Port of test_pipeline.py's test: the kernel-fused stages == the
    unfused ones (there for DSA, here for each method), at that test's
    tolerance of 1e-4."""
    jcfg, tcfg = _cfgs(top_k=32)
    _, tsp = _sparse_params(method, jcfg)
    q, kc, vc, _ = _decode_inputs(tcfg, 4, B=2, S=64, seed=8)
    M = (_t(kc), _t(vc))
    kw = tmethods.sparse_kwargs(method, 8)
    tmod = tmethods.module(method)
    out_u = tmod.build_pipeline(tcfg, tcfg.memory, tsp, fused=False,
                                **kw).run(M, _t(q))
    out_f = tmod.build_pipeline(tcfg, tcfg.memory, tsp, fused=True,
                                **kw).run(M, _t(q))
    np.testing.assert_allclose(out_u.numpy(), out_f.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_stage_bypass_is_identity():
    """§3.1: a skipped stage costs nothing and passes data through."""
    pipe = MemoryPipeline("id-test", prepare=None, relevancy=None,
                          retrieve=None, apply=lambda Mp, x: Mp + x)
    assert float(pipe.run(torch.tensor(2.0), torch.tensor(3.0))) == 5.0
    assert float(MemoryPipeline("empty").run(torch.tensor(7.0), None)) == 7.0


def test_profiler_attribution():
    prof = StageProfiler()
    pipe = MemoryPipeline(
        "p", prepare=lambda M: M, relevancy=lambda I, x: I,
        retrieve=lambda M, S: S, apply=lambda Mp, x: Mp,
        fused={"relevancy": ("relevancy", "retrieve")})
    pipe.run(torch.zeros(4), torch.zeros(4), profiler=prof)
    prof.record_total("p", sum(prof.stage_seconds["p"].values()) * 2)
    bd = prof.breakdown("p")
    assert abs(sum(bd.values()) - 1.0) < 1e-6
    assert 0.0 < prof.memory_fraction("p") <= 0.5 + 1e-9
    assert np.isnan(prof.memory_fraction("other"))
    # a fused callable's time is split evenly over the stages it covers
    prof2 = StageProfiler()
    prof2.record("f", ("relevancy", "retrieve"), 2.0)
    assert prof2.stage_seconds["f"] == {"prepare": 0.0, "relevancy": 1.0,
                                        "retrieve": 1.0, "apply": 0.0}


def test_offload_stages_and_methods_match_reference():
    for name in ("dsa", "seer", "lserve", "rag", "mac", "memagent", "ttt",
                 "none", "nope"):
        assert tmethods.offload_stages(name) == jmethods.offload_stages(name)
    assert sorted(tmethods.SPARSE_METHODS) == sorted(jmethods.SPARSE_METHODS)
    for name in ("seer", "lserve"):
        init, mk = tmethods.get_sparse_method(name)
        assert callable(init) and callable(mk)
    with pytest.raises(KeyError):
        tmethods.get_sparse_method("rag")
    with pytest.raises(KeyError):
        tmethods.module("lserv")
    assert tmethods.sparse_kwargs("dsa", 8) == {"page": 8}
    assert tmethods.sparse_kwargs("seer", 8) == {} == \
        tmethods.sparse_kwargs("lserve", 8)
    # every method module of the reference resolves in the port, memagent
    # and ttt included, with the same offload stages and a build_pipeline
    assert sorted(tmethods._METHOD_MODULES) == sorted(
        jmethods._METHOD_MODULES)
    for name in ("memagent", "ttt"):
        mod = tmethods.module(name)
        assert mod.__name__ == f"repro_torch.core.methods.{name}"
        assert mod.OFFLOAD_STAGES == jmethods._METHOD_MODULES[
            name].OFFLOAD_STAGES == ()
        assert callable(mod.build_pipeline)
        with pytest.raises(KeyError):
            tmethods.get_sparse_method(name)


# ---------------------------------------------------------------------------
# unpaged prefill / decode_step
# ---------------------------------------------------------------------------

TP = 4


@pytest.fixture(scope="module")
def unpaged():
    """Both models from the same JAX weights, prefilled on the same prompt
    (B=2, S=64, caches padded to 72): the setup of test_pipeline.py."""
    jcfg, tcfg = _cfgs()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    tparams = from_jax_params(_np_tree(jparams), "cpu")
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size,
                                             (2, 64)).astype(np.int32)
    jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), max_len=72, tp=TP)
    tl, tc = TM.prefill(tparams, tcfg, _t(toks), max_len=72, tp=TP)
    return jcfg, tcfg, jparams, tparams, toks, (jl, jc), (tl, tc)


def _caches_copy(c):
    return dict(c, k=c["k"].clone(), v=c["v"].clone())


def test_prefill_matches_jax(unpaged):
    *_, (jl, jc), (tl, tc) = unpaged
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert tc["k"].shape == jc["k"].shape and tc["length"] == 64
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert not tc["v"][:, :, 64:].any()


def _decode_pair(unpaged, method, mem):
    jcfg, tcfg, jparams, tparams, toks, (_, jc), (_, tc) = unpaged
    jkw, tkw = {}, {}
    if method != "none":
        jcfg = jcfg.replace(memory=jcfg.memory.replace(**mem))
        tcfg = tcfg.replace(memory=tcfg.memory.replace(**mem))
        init, jmk = jmethods.get_sparse_method(method)
        jsp = init(jax.random.PRNGKey(7), jcfg, jcfg.memory)
        kw = tmethods.sparse_kwargs(method, 8)
        jkw = dict(sparse_fn=jmk(jcfg, jcfg.memory, tp=TP, **kw),
                   sparse_params=jsp)
        tkw = dict(sparse_fn=tmethods.get_sparse_method(method)[1](
            tcfg, tcfg.memory, tp=TP, **kw),
            sparse_params=from_jax_params(_np_tree(jsp), "cpu"))
    tok = toks[:, 0]
    jl, jc2 = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jc, tp=TP, **jkw)
    tl, tc2 = TM.decode_step(tparams, tcfg, _t(tok), _caches_copy(tc), tp=TP,
                             **tkw)
    return jl, jc2, tl, tc2


@pytest.mark.parametrize("method", ["none", "dsa", "seer", "lserve"])
def test_decode_step_matches_jax(unpaged, method):
    jl, jc, tl, tc = _decode_pair(unpaged, method, {})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert tc["length"] == int(jc["length"]) == 65
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("method", ["dsa", "seer", "lserve"])
def test_full_budget_sparse_equals_dense(unpaged, method):
    """When the budget covers the whole context, the sparse pipeline is
    dense attention (retrieval selects everything), on the port's own
    ``decode_step``; and equal to the reference's sparse step."""
    mem = dict(method=method, top_k=128, token_budget=128, selection="topk",
               min_context=0)
    _, _, dense, _ = _decode_pair(unpaged, "none", {})
    jl, _, tl, _ = _decode_pair(unpaged, method, mem)
    np.testing.assert_allclose(tl.numpy(), dense.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_threshold_mode_subset_of_topk(unpaged):
    """Seer threshold retrieval only ever drops blocks vs top-k mode:
    tau = 1.0 drops everything, so the logits must differ."""
    base = dict(method="seer", token_budget=32, block_size=8, min_context=0)
    _, _, l_topk, _ = _decode_pair(unpaged, "seer",
                                   dict(base, selection="topk"))
    _, _, l_thr, _ = _decode_pair(unpaged, "seer",
                                  dict(base, selection="threshold",
                                       threshold=1.0))
    assert not torch.allclose(l_topk, l_thr)


def test_decode_step_stateful_restacks_sparse_params(unpaged):
    """``sparse_stateful``: the per-layer state a sparse_fn returns comes
    back layer-stacked."""
    jcfg, tcfg, _, tparams, toks, _, (_, tc) = unpaged

    def fn(q, kc, vc, length, sp, k_new=None):
        return torch.zeros_like(q), {"n": sp["n"] + length}

    sp = {"n": torch.zeros(tcfg.n_layers, dtype=torch.long)}
    _, c2, sp2 = TM.decode_step(tparams, tcfg, _t(toks[:, 0]),
                                _caches_copy(tc), tp=TP, sparse_fn=fn,
                                sparse_params=sp, sparse_stateful=True)
    assert sp2["n"].tolist() == [65] * tcfg.n_layers and c2["length"] == 65
