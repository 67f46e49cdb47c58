"""Ports of ``tests/test_serving_paged.py`` and ``tests/test_serving_api.py``
to the port's engine, on the CPU (no JAX): staggered admission and page
reuse keep token streams exact, pages never leak, an oversubscribed arena
blocks then admits, chunked prefill == one-shot prefill, the scheduler
drains mixed lengths, and the request API's checks and timing marks.

Smoke config at dtype float32 with seeded torch weights; tokens must be
equal exactly. Where the pool is busy, ``generate`` takes the batched
dense-cache loop, as the reference's does (the loop's own tests:
``tests/test_torch_legacy.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import Engine, Request, Scheduler, \
    ServeConfig  # noqa: E402

torch.set_num_threads(2)
TP = 4


@pytest.fixture(scope="module")
def setup():
    cfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    return cfg, init_params(cfg, 0, tp=TP, device="cpu")


def _engine(setup, **kw):
    cfg, params = setup
    kw = dict(dict(max_len=64, n_slots=2, method="none", tp=TP,
                   kv_page_size=16), **kw)
    return Engine(cfg, params, ServeConfig(**kw), device="cpu")


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _drain(eng, n_steps):
    got = {}
    for _ in range(n_steps):
        for rid, _slot, tok in eng.poll():
            got.setdefault(rid, []).append(tok)
    return got


def test_staggered_admission_and_page_reuse(setup):
    """Requests beyond the slot count queue and admit as slots free,
    reusing released pages; every stream equals per-request generate."""
    cfg, _ = setup
    kw = dict(max_len=96, pool_pages=2 * (96 // 16) + 1)
    eng, ref = _engine(setup, **kw), _engine(setup, **kw)
    prompts = _prompts(cfg, 1, (16, 24, 40, 8))
    refs = [ref.generate(p[None], 5)[0] for p in prompts]
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, 5))
    got = _drain(eng, 1)
    assert eng.queue_depth() == 2 and sorted(got) == [0, 1]
    for rid, toks in _drain(eng, 15).items():
        got.setdefault(rid, []).extend(toks)
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(got[i][:5]), refs[i])
    assert eng.pool.pages_in_use() == 0


def test_pages_do_not_leak_across_admit_release_cycles(setup):
    cfg, _ = setup
    eng = _engine(setup)
    rid = 0
    for cycle in range(3):
        for p in _prompts(cfg, 2 + cycle, (10, 20)):
            eng.submit(Request(rid, p, 3))
            rid += 1
        eng.poll()
        assert eng.queue_depth() == 0
        assert eng.pool.pages_in_use() == eng.pool.pages_needed(13) + \
            eng.pool.pages_needed(23)
        _drain(eng, 3)
        assert eng.pool.pages_in_use() == 0
        free = eng.pool.free
        assert len(free) == len(set(free)) == eng.pool.total_pages - 1
        assert 0 not in free


def test_pool_oversubscription_blocks_then_admits(setup):
    cfg, _ = setup
    eng = _engine(setup, pool_pages=4)       # 3 allocatable pages of 16
    p0, p1 = _prompts(cfg, 3, (40, 10))
    h0, h1 = eng.submit(Request(0, p0, 4)), eng.submit(Request(1, p1, 4))
    eng.poll()
    assert eng.pool.n_free() == 0 and eng.slots.free_slots()
    assert eng.queue_depth() == 1 and not h1.tokens
    assert sorted(eng.drain()) == [0, 1] and h0.done and h1.done
    assert eng.pool.n_free() == 3


@pytest.mark.parametrize("method", ["none", "dsa", "seer", "lserve"])
def test_chunked_prefill_matches_one_shot(setup, method):
    """A long prompt streamed in chunks (interleaved with another slot's
    decode, forced by ``method_overrides``) == one-shot generate: pooled
    decode equals per-request decode under each sparse method."""
    cfg, _ = setup
    kw = dict(max_len=128, method=method, page=8, prefill_chunk=16,
              chunk_threshold=24)
    eng, ref = _engine(setup, **kw), _engine(setup, **kw)
    long_prompt, short = _prompts(cfg, 4, (50, 16))
    r_long = ref.generate(long_prompt[None], 5)[0]
    r_short = ref.generate(short[None], 5)[0]
    eng.submit(Request(0, long_prompt, 5, method_overrides={"chunked": True}))
    eng.submit(Request(1, short, 5))
    got = _drain(eng, 12)
    np.testing.assert_array_equal(np.asarray(got[0][:5]), r_long)
    np.testing.assert_array_equal(np.asarray(got[1][:5]), r_short)
    assert eng.pool.pages_in_use() == 0


def test_scheduler_paged_mixed_lengths(setup):
    cfg, _ = setup
    eng = _engine(setup, max_len=128, n_slots=3, prefill_chunk=16,
                  chunk_threshold=32, pool_pages=3 * (128 // 16) + 1)
    sch = Scheduler(eng, prefill_token_budget=64)
    rids = [sch.submit(p, max_new=4)
            for p in _prompts(cfg, 5, (10, 40, 16, 33, 8, 50, 12))]
    done = sch.run()
    assert sorted(done) == sorted(rids)
    assert all(len(r.tokens) == 4 for r in done.values())
    assert sch.throughput_tokens_per_s() > 0
    assert eng.pool.pages_in_use() == 0


def test_generate_leaves_no_residue_and_needs_idle_engine(setup):
    cfg, _ = setup
    eng = _engine(setup, n_slots=3)
    prompts = np.stack(_prompts(cfg, 6, (16, 16, 16)))
    got = eng.generate(prompts, 5)
    assert got.shape == (3, 5)
    assert not eng.busy() and not eng.done and not eng._handles
    assert eng.pool.pages_in_use() == 0
    h = eng.submit(Request(0, prompts[0], 6))
    eng.poll()                                     # resident mid-decode
    # a busy engine: generate takes the dense-cache loop, not the pool
    np.testing.assert_array_equal(eng.generate(prompts[:1], 4),
                                  got[:1, :4])
    assert eng.stats["dense_prefills"] == 1
    eng.drain()
    np.testing.assert_array_equal(h.result()[:5], got[0])


def test_submit_rejects_duplicates_and_wrong_types(setup):
    cfg, _ = setup
    eng = _engine(setup)
    (p,) = _prompts(cfg, 7, (8,))
    with pytest.raises(TypeError):
        eng.submit((0, p, 3))
    eng.submit(Request(0, p, 3))
    with pytest.raises(ValueError):
        eng.submit(Request(0, p, 3))
    eng.drain()
    eng.submit(Request(0, p, 3))                   # done rids are reusable
    assert sorted(eng.drain()) == [0]


def test_handle_timing_and_result(setup):
    cfg, _ = setup
    eng = _engine(setup)
    h = eng.submit(Request(0, _prompts(cfg, 8, (8,))[0], 4))
    assert not h.done and h.ttft_s() is None
    eng.drain()
    assert h.done and len(h.tokens) == 4
    assert h.finished >= h.first_token_t >= h.submitted
    assert h.ttft_s() >= 0 and h.per_token_s() >= 0
    assert h.as_dict()["n_tokens"] == 4
    np.testing.assert_array_equal(h.result(), np.asarray(h.tokens, np.int32))
