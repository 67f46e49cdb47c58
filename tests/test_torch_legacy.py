"""The port's unpaged serving paths and the non-dense families through the
engine, on the CPU:

  * ports of ``test_legacy_watermark_pool_still_serves``
    (``tests/test_serving_paged.py``), and of
    ``test_generate_wrapper_bitmatches_dense_loop`` and
    ``test_generate_falls_back_when_pool_busy``
    (``tests/test_serving_api.py``);
  * the legacy dense pool (``ServeConfig(paged=False)``, the shared
    ``lengths.max()`` watermark) against the JAX engine's: the same greedy
    tokens for a mixed batch, more requests than slots;
  * zamba2 (hybrid: Mamba2 + the shared attention block, with DSA at each
    of its sites) and xLSTM ``generate`` (the batched dense-cache loop)
    against the JAX engine's.

Smoke configs at dtype float32, tp=4, the weights carried over from JAX by
``weights.from_jax_params``; tokens must be equal exactly.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import Engine, Request, Scheduler, \
    ServeConfig  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TP = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _weights(name):
    jcfg = jget_arch(name).smoke().replace(dtype="float32")
    tcfg = get_arch(name).smoke().replace(dtype="float32")
    jparams = jinit(jcfg, jax.random.PRNGKey(0), tp=TP)
    return jcfg, tcfg, jparams, from_jax_params(_np_tree(jparams), "cpu")


def _engines(name, method, **sc_kw):
    """The JAX engine and the port's over the same weights and the same
    sparse params."""
    jcfg, tcfg, jparams, tparams = _weights(name)
    jeng = JEngine(jcfg, jparams, JServeConfig(method=method, tp=TP, **sc_kw),
                   key=jax.random.PRNGKey(1))
    sp = None if jeng.sparse_params is None else from_jax_params(
        _np_tree(jeng.sparse_params), "cpu")
    teng = Engine(tcfg, tparams, ServeConfig(method=method, tp=TP, **sc_kw),
                  device="cpu", sparse_params=sp)
    assert teng.sc.max_len == jeng.sc.max_len
    return jeng, teng


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve_both(jeng, teng, prompts, max_new):
    jh = [jeng.submit(JRequest(i, p, max_new)) for i, p in enumerate(prompts)]
    th = [teng.submit(Request(i, p, max_new)) for i, p in enumerate(prompts)]
    jeng.drain()
    teng.drain()
    for a, b in zip(jh, th):
        assert a.done and b.done
        np.testing.assert_array_equal(b.result(), a.result())
    return jh, th


@functools.lru_cache(maxsize=None)
def _seeded(name="llama3.2-1b"):
    cfg = get_arch(name).smoke().replace(dtype="float32")
    return cfg, init_params(cfg, 0, tp=TP, device="cpu")


def test_legacy_watermark_pool_still_serves():
    """The paged=False baseline (dense pool, shared watermark) stays a
    working scheduler target: the reference's benchmark comparison point."""
    cfg, params = _seeded()
    eng = Engine(cfg, params, ServeConfig(max_len=64, n_slots=3,
                                          method="none", tp=TP, paged=False),
                 device="cpu")
    sch = Scheduler(eng)
    rng = np.random.default_rng(6)
    rids = [sch.submit(rng.integers(0, cfg.vocab_size, size=10), max_new=4)
            for _ in range(5)]
    done = sch.run()
    assert sorted(done) == sorted(rids)
    assert all(len(r.tokens) == 4 for r in done.values())
    assert eng.pool is None and eng.caches is not None


@pytest.mark.parametrize("method", ["none", "dsa"])
def test_generate_wrapper_bitmatches_dense_loop(method):
    cfg, params = _seeded()
    sc = ServeConfig(max_len=64, n_slots=3, method=method, tp=TP, page=8,
                     kv_page_size=16)
    eng = Engine(cfg, params, sc, device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    want = eng._generate_batched(prompts, 5)       # the dense loop
    got = eng.generate(prompts, 5)                 # through the pool
    np.testing.assert_array_equal(got, want)
    assert not eng.busy() and not eng.done and not eng._handles
    assert eng.pool.pages_in_use() == 0


def test_generate_falls_back_when_pool_busy():
    """generate() while requests are resident leaves the pool alone: it
    takes the dense-cache loop and the resident stream finishes unchanged."""
    cfg, params = _seeded()
    sc = ServeConfig(max_len=64, n_slots=2, method="none", tp=TP,
                     kv_page_size=16)
    eng = Engine(cfg, params, sc, device="cpu")
    ref = Engine(cfg, params, sc, device="cpu")
    rng = np.random.default_rng(1)
    resident = rng.integers(0, cfg.vocab_size, size=12).astype(np.int32)
    want_resident = ref.generate(resident[None], 6)[0]
    other = rng.integers(0, cfg.vocab_size, size=(1, 8)).astype(np.int32)
    want_other = ref.generate(other, 4)
    h = eng.submit(Request(0, resident, 6))
    eng.poll()                                     # resident mid-decode
    dense0 = eng.stats["dense_prefills"]
    np.testing.assert_array_equal(eng.generate(other, 4), want_other)
    assert eng.stats["dense_prefills"] == dense0 + 1
    eng.drain()
    assert h.done
    np.testing.assert_array_equal(h.result(), want_resident)


@pytest.mark.parametrize("method", ["none", "dsa"])
def test_legacy_pool_matches_jax_engine(method):
    """paged=False: the watermark decode, dead slots included, and the
    batch-level fallback on the watermark, token for token."""
    jeng, teng = _engines("llama3.2-1b", method, max_len=64, n_slots=2,
                          page=4, paged=False)
    prompts = _prompts(512, (16, 9, 20, 5))
    _serve_both(jeng, teng, prompts, 5)
    assert teng.stats["dense_prefills"] == len(prompts)
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
    if method == "dsa":     # smoke min_context = 0: every step is sparse
        assert teng.stats["sparse_steps"] == teng.stats["decode_steps"]


@pytest.mark.parametrize("name,method", [("zamba2-7b", "dsa"),
                                         ("xlstm-125m", "none")])
def test_recurrent_generate_matches_jax_engine(name, method):
    """The hybrid and ssm families serve through generate's batched loop;
    zamba2 runs DSA at each shared-block site."""
    jeng, teng = _engines(name, method, max_len=64, n_slots=2, page=4)
    prompts = np.stack(_prompts(512, (32, 32), seed=3))
    want = np.asarray(jeng.generate(jnp.asarray(prompts), 5))
    got = teng.generate(prompts, 5)
    np.testing.assert_array_equal(got, want)
    assert teng.pool is None and teng.stats["dense_prefills"] == 1
    if method == "dsa":
        assert teng.sparse_params["wq_idx"].dim() == 2     # one set
        assert teng.stats["sparse_steps"] == 5


def test_recurrent_family_needs_generate():
    cfg, params = _seeded("xlstm-125m")
    eng = Engine(cfg, params, ServeConfig(max_len=64, n_slots=2, tp=TP),
                 device="cpu")
    eng.submit(Request(0, np.zeros(8, np.int32), 2))
    with pytest.raises(ValueError, match="generate"):
        eng.poll()
