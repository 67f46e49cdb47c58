"""The port's fleet (``repro_torch.serving.router`` / ``.replica``) on the
CPU, ports of ``tests/test_router.py``'s seven tests:

  * replica device groups: contiguous, round-robin when devices run short
    (the CPU's one device: every replica on it);
  * 2 replicas serving mixed traffic (dsa, retrieval opt-ins) emit, per
    request, the tokens of one engine fed the requests one at a time, and
    of the JAX package's 2-replica router (one run per module); both
    replicas serve and share ONE retrieval service;
  * the offload topology behind the router == one engine's ``generate``;
  * session affinity and least-load spreading; method-override pins in a
    heterogeneous fleet; a corpus ingested through the router is seen by
    every replica, and a fleet on the shared service == one engine on it;
  * the request surface's validation.

Smoke config at float32, tp=4, the JAX weights on both sides.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_serving_cases as C  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Router as JRouter  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.data import build_corpus  # noqa: E402
from repro_torch.hetero import pick_devices_replicas  # noqa: E402
from repro_torch.serving import (Engine, EngineReplica,  # noqa: E402
                                 OffloadConfig, ReplicaMonitor, Request,
                                 Router, ServeConfig)

torch.set_num_threads(2)
CPU = torch.device("cpu")
BASE = dict(n_slots=2, tp=C.TP, kv_page_size=16)


def _build(sc, n_replicas=None, method="dsa"):
    _, tcfg, _, tparams = C.setup()
    return Router.build(tcfg, tparams, sc, n_replicas, device="cpu",
                        sparse_params=C.sparse_params(method)[1])


def _engine(sc, method="dsa"):
    _, tcfg, _, tparams = C.setup()
    return Engine(tcfg, tparams, sc, device="cpu",
                  sparse_params=C.sparse_params(method)[1])


def _mixed():
    prompts = C.prompts((16, 24, 9, 32, 12, 20), seed=1)
    return [(i, p, i % 3 == 0) for i, p in enumerate(prompts)]


@functools.lru_cache(maxsize=None)
def _jax_router_tokens():
    """The JAX package's 2-replica router on the mixed traffic."""
    jcfg, _, jparams, _ = C.setup()
    sc = JServeConfig(max_len=128, method="dsa", page=8, **BASE,
                      retrieval=C.rcfg("sync", jax_side=True))
    router = JRouter.build(jcfg, jparams, sc, n_replicas=2,
                           key=jax.random.PRNGKey(0))
    hs = [router.submit(JRequest(i, p, 6, retrieval=r))
          for i, p, r in _mixed()]
    router.drain()
    return {h.rid: [int(t) for t in h.tokens] for h in hs}


def test_replica_device_groups():
    """Contiguous groups, never empty; with one device every replica takes
    it."""
    groups = pick_devices_replicas(2, "cpu")
    assert groups == [(CPU,), (CPU,)]
    assert pick_devices_replicas(3, "cpu") == [(CPU,)] * 3
    with pytest.raises(ValueError):
        pick_devices_replicas(0, "cpu")


def test_router_bitmatches_single_engine():
    """Mixed dsa + retrieval traffic through 2 replicas == the requests
    through one engine one at a time == the JAX router, token for token."""
    sc = ServeConfig(max_len=128, method="dsa", page=8, **BASE,
                     retrieval=C.rcfg("sync"))
    ref_eng = _engine(sc)
    refs = {}
    for i, p, r in _mixed():        # one at a time: the per-request oracle
        ref_eng.submit(Request(i, p, 6, retrieval=r))
        ref_eng.drain()
        refs[i] = [int(t) for t in ref_eng.done.pop(i).tokens]
    router = _build(sc, 2)
    assert len(router.replicas) == 2
    assert router.service is not None          # ONE corpus for the fleet
    svcs = {id(r.engine.retrieval.service) for r in router.replicas}
    assert svcs == {id(router.service)}
    # the replicas share the weights (no copy onto the device they are on)
    e0, e1 = (r.engine for r in router.replicas)
    assert e0.params["lm_head"]["w"].data_ptr() == \
        e1.params["lm_head"]["w"].data_ptr()
    hs = [router.submit(Request(i, p, 6, retrieval=r))
          for i, p, r in _mixed()]
    done = router.drain()
    assert sorted(done) == sorted(refs)
    got = {h.rid: [int(t) for t in h.tokens] for h in hs}
    for h in hs:
        assert h.done and h.replica is not None
        assert h.ttft_s() is not None and h.ttft_s() >= 0
    assert got == refs
    assert got == _jax_router_tokens()
    assert {h.replica for h in hs} == {0, 1}
    assert any(r.engine.retrieval.events for r in router.replicas)


def test_router_bitmatches_with_hetero_offload():
    """Each replica runs the overlapped offload executor on its group and
    still serves the single engine's streams."""
    sc = ServeConfig(max_len=64, method="dsa", page=8, **BASE,
                     offload_cfg=OffloadConfig(mode="overlap"))
    prompts = C.prompts((16, 9, 24, 12), seed=2)
    ref_eng = _engine(sc)
    refs = [ref_eng.generate(p[None], 5)[0] for p in prompts]
    router = _build(sc, 2)
    hs = [router.submit(Request(i, p, 5)) for i, p in enumerate(prompts)]
    router.drain()
    for h, want in zip(hs, refs):
        assert h.done
        np.testing.assert_array_equal(np.asarray(h.tokens, np.int32), want)
    for r in router.replicas:
        assert r.engine.pool.pages_in_use() == 0
        assert r.engine.hetero.report()["devices"]["main"] == "cpu"


def test_session_affinity_and_load_balance():
    sc = ServeConfig(max_len=64, method="none", **BASE)
    router = _build(sc, 2, method="dsa")
    prompts = C.prompts((8,) * 6, seed=3)
    sessions = ["a", "b", "a", None, "b", "a"]
    hs = [router.submit(Request(i, p, 3, session=s))
          for i, (p, s) in enumerate(zip(prompts, sessions))]
    by_session = {}
    for h, s in zip(hs, sessions):
        if s is not None:
            by_session.setdefault(s, set()).add(h.replica)
    assert all(len(v) == 1 for v in by_session.values())
    assert len({h.replica for h in hs}) == 2     # the load spread
    done = router.drain()
    assert len(done) == len(hs) and all(h.done for h in hs)
    rep = router.report()
    assert rep["requests_done"] == 6 and rep["sessions"] == 2
    assert all(r["polls"] > 0 for r in rep["replicas"])
    assert all(r["devices"] == ["cpu"] for r in rep["replicas"])
    with pytest.raises(ValueError):
        router.submit(Request(7, prompts[0], 3))
        router.submit(Request(7, prompts[0], 3))   # same rid in flight


def test_method_override_pins_replica():
    """A heterogeneous fleet (none + dsa) routes method pins to the replica
    serving that method."""
    cfgs = [ServeConfig(method="none", max_len=64, **BASE),
            ServeConfig(method="dsa", page=8, max_len=64, **BASE)]
    router = _build(cfgs)
    prompts = C.prompts((8,) * 4, seed=4)
    hs = [router.submit(Request(i, p, 3, method_overrides={"method": m}))
          for i, (p, m) in enumerate(zip(prompts, ["dsa", "none", "dsa",
                                                   "none"]))]
    assert [h.replica for h in hs] == [1, 0, 1, 0]
    router.drain()
    assert all(h.done for h in hs)
    with pytest.raises(ValueError):
        _build(cfgs, n_replicas=3)


def test_shared_corpus_ingest_visible_to_all_replicas():
    """Documents ingested through the router join the one shared corpus;
    the fleet on it serves the splices of one engine on the same service,
    after the ingest."""
    sc = ServeConfig(max_len=128, method="none", **BASE,
                     retrieval=C.rcfg("sync"))
    router = _build(sc, 2)
    n0 = router.service.n_docs
    extra = build_corpus(16, gen_vocab=C.setup()[1].vocab_size,
                         device="cpu", **dict(C.CORPUS_KW, seed=9))
    router.ingest(extra)
    assert router.service.n_docs == n0 + 16
    for r in router.replicas:
        assert r.engine.retrieval.service.n_docs == n0 + 16
    ref_sc = dataclasses.replace(sc, retrieval=C.rcfg(
        "sync", service=router.service))
    ref_eng = _engine(ref_sc)
    assert ref_eng.retrieval.service is router.service
    prompts = C.prompts((16, 24), seed=5)
    refs = {}
    for i, p in enumerate(prompts):
        ref_eng.submit(Request(i, p, 8, retrieval=True))
        ref_eng.drain()
        refs[i] = list(ref_eng.done.pop(i).tokens)
    hs = [router.submit(Request(i, p, 8, retrieval=True))
          for i, p in enumerate(prompts)]
    router.drain()
    for h in hs:
        assert h.done and list(h.tokens) == refs[h.rid]
    assert any(r.engine.retrieval.events for r in router.replicas)
    rep = router.report()
    assert rep["shared_corpus"]["n_docs"] == n0 + 16
    with pytest.raises(ValueError):
        Router.build(C.setup()[1], C.setup()[3], ServeConfig(
            max_len=64, method="none", **BASE), 1, device="cpu").ingest(extra)


def test_request_surface_validation():
    """The typed admission surface rejects malformed requests; a replica
    and its monitor report their load."""
    tok = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError):
        Request(0, tok, 0)                          # max_new < 1
    with pytest.raises(ValueError):
        Request(0, np.zeros((2, 2), np.int32), 3)   # not 1-D
    with pytest.raises(ValueError):
        Request(0, tok, 3, method_overrides={"bogus": 1})
    r = Request(1, tok, 3, method_overrides={"chunked": True})
    assert r.override("chunked") and r.override("method") is None
    assert len(r) == 4
    with pytest.raises(ValueError):
        r.tokens[0] = 5                             # frozen token buffer
    _, tcfg, _, tparams = C.setup()
    rep = EngineReplica(0, tcfg, tparams, ServeConfig(
        max_len=64, method="none", **BASE), device="cpu")
    assert not rep.can_serve(Request(2, tok, 3, retrieval=True))
    assert rep.can_serve(Request(2, tok, 3))
    rep.submit(Request(2, tok, 3))
    assert rep.load() == 1
    while rep.busy():
        rep.poll()
    mon = rep.monitor.as_dict()
    assert mon["tokens"] == 3 and mon["polls"] == rep.monitor.polls
    assert 0 < rep.monitor.utilization() <= 1
    assert ReplicaMonitor().utilization() == 0.0
    with pytest.raises(ValueError):
        Router([])
