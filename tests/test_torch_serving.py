"""The port's serving engine on the CPU: the same greedy tokens and the same
aligned ``max_len`` as the JAX ``Engine`` for a mixed batch (short bucketed
prompts plus one chunked prompt, more requests than slots), for
``method="none"``, ``"dsa"``, ``"seer"`` (top-k and threshold) and
``"lserve"``, from the same JAX-initialized weights; pooled == one-at-a-time
inside the port; the pool back at zero after release; selection shards
and a main mesh build their executors, and a mesh with a replica's device
group raises.

Smoke config at dtype float32. Tokens must be equal exactly. Seer runs at
tp=4: with dead TP heads the reference's seer gate does not type-check.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import MemoryConfig as JMemoryConfig  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import MemoryConfig  # noqa: E402
from repro_torch.serving import (Engine, OffloadConfig, Request,  # noqa: E402
                                 ServeConfig)
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TP = 16
# page=4 selects 4 of the view's pages; a low chunk threshold sends the
# 40-token prompt through chunked prefill at smoke size
SC = dict(max_len=64, n_slots=2, tp=TP, page=4, kv_page_size=16,
          prefill_chunk=16, chunk_threshold=24)
LENS = (16, 9, 40, 20)
MAX_NEW = 5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _weights(tp):
    jcfg = jget_arch("llama3.2-1b").smoke().replace(dtype="float32")
    tcfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    jparams = jinit(jcfg, jax.random.PRNGKey(0), tp=tp)
    return jcfg, tcfg, jparams, from_jax_params(_np_tree(jparams), "cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights(TP)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in LENS]


def _port_engine(weights, method, jeng=None, mem=None, **kw):
    _, tcfg, _, tparams = weights
    sp = None
    if jeng is not None and jeng.sparse_params is not None:
        sp = from_jax_params(_np_tree(jeng.sparse_params), "cpu")
    return Engine(tcfg, tparams, ServeConfig(method=method, **dict(SC, **kw)),
                  device="cpu", sparse_params=sp, mem=mem)


# per case: ServeConfig overrides and MemoryConfig overrides. lserve's
# max_len of 80 is not a multiple of its 32-token physical page, so the
# engine must align it as the reference does (to 96).
ENGINE_CASES = {
    "none": ("none", {}, {}),
    "dsa": ("dsa", {}, {}),
    "seer": ("seer", {"tp": 4}, {}),
    "seer-threshold": ("seer", {"tp": 4},
                       {"selection": "threshold", "threshold": 0.3}),
    "lserve": ("lserve", {"max_len": 80}, {}),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_tokens_match_jax_engine(case):
    method, sc_kw, mem_kw = ENGINE_CASES[case]
    weights = _weights(sc_kw.get("tp", TP))
    jcfg, tcfg, jparams, _ = weights
    jmem = tmem = None
    if mem_kw:
        fields = dict(vars(jcfg.memory), method=method, **mem_kw)
        jmem, tmem = JMemoryConfig(**fields), MemoryConfig(**fields)
    jeng = JEngine(jcfg, jparams, JServeConfig(method=method,
                                               **dict(SC, **sc_kw)),
                   key=jax.random.PRNGKey(1), mem=jmem)
    teng = _port_engine(weights, method, jeng, mem=tmem, **sc_kw)
    assert teng.sc.max_len == jeng.sc.max_len
    prompts = _prompts(jcfg.vocab_size)
    jh = [jeng.submit(JRequest(i, p, MAX_NEW)) for i, p in enumerate(prompts)]
    th = [teng.submit(Request(i, p, MAX_NEW)) for i, p in enumerate(prompts)]
    jeng.drain()
    teng.drain()
    for a, b in zip(jh, th):
        assert a.done and b.done
        np.testing.assert_array_equal(b.result(), a.result())
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
    if method != "none":     # smoke min_context = 0: every step is sparse
        assert teng.stats["sparse_steps"] == teng.stats["decode_steps"] > 0


def test_pooled_matches_one_at_a_time_and_pool_scrubbed(weights):
    jcfg = weights[0]
    prompts = _prompts(jcfg.vocab_size)
    pooled = _port_engine(weights, "dsa")
    hs = [pooled.submit(Request(i, p, MAX_NEW)) for i, p in enumerate(prompts)]
    pooled.drain()
    single = _port_engine(weights, "dsa")
    for h, p in zip(hs, prompts):
        np.testing.assert_array_equal(h.result(),
                                      single.generate(p[None], MAX_NEW)[0])
    for eng in (pooled, single):
        assert eng.pool.pages_in_use() == 0
        assert not eng.pool.device["k_pages"].any()
        assert not eng.pool.device["v_pages"].any()


@pytest.mark.parametrize("kw", [
    dict(offload_cfg=OffloadConfig(mode="sync", shards=2)),
    dict(offload_cfg=OffloadConfig(mode="sync", main_mesh=2)),
])
def test_unported_features_raise(weights, kw):
    """Selection shards and the main mesh were unported and raised
    NotImplementedError; now ported, they build their executors, and what
    still raises is the combination the reference refuses: a main mesh
    with a replica's device group (``Engine(devices=...)``)."""
    kw = dict(kw)
    method = kw.pop("method", "dsa")
    eng = _port_engine(weights, method, **kw)
    oc = kw["offload_cfg"]
    assert (getattr(eng.hetero, "n_shards", 1), eng.main_mesh is not None) \
        == (oc.shards, oc.main_mesh > 1)
    _, tcfg, _, tparams = weights
    sc = ServeConfig(method=method, **dict(SC, offload_cfg=OffloadConfig(
        mode="sync", shards=oc.shards, main_mesh=2)))
    with pytest.raises(ValueError):
        Engine(tcfg, tparams, sc, device="cpu", devices=["cpu"])


def test_default_device_needs_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(weights[1], weights[3], ServeConfig(**SC))
