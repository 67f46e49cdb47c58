"""The port's sharded hetero offload (``repro_torch.hetero.sharded``) on the
CPU, ports of ``tests/test_hetero_sharded.py``:

  * a mixed pool (one retrieval slot, one sparse slot) served with
    ``offload_shards=2`` in sync and in overlap emits what ``shards=1`` with
    inline retrieval emits, token for token and retrieval for retrieval,
    for dsa / seer / lserve; for dsa also what the JAX package's
    ``ShardedHeteroExecutor`` emits; each shard's up link moves 8 bytes a
    candidate a step at most, less than one KV page;
  * the same under the scheduler (chunked admission, staggered finishes);
    the pool's page -> shard map agrees with the shards' windows; per-slot
    lookahead patches survive membership events over 2 shards;
  * the sharded top-k merge equals the reference's global top-k (values,
    indices and tie order) for ragged, empty and all-masked shards; windowed
    bundles merged == the full bundle's selection;
  * a fused 8-step window over 2 shards == the stepped schedule == 1 shard
    (the window selects over the shard summaries concatenated along the
    page axis).

Smoke config at float32, tp=4; the JAX reference runs once per module. On
the CPU the shards run in program order; on the card each has a CUDA
stream of its own (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import torch_serving_cases as C  # noqa: E402
from repro.hetero.select import merge_shard_topk as jmerge  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import OffloadConfig as JOffloadConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.core.methods import get_sparse_method  # noqa: E402
from repro_torch.hetero import (ShardedHeteroExecutor,  # noqa: E402
                                make_offload_select, merge_shard_topk,
                                pick_devices_sharded)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.serving import (Engine, OffloadConfig, Request,  # noqa: E402
                                 Scheduler, ServeConfig)

torch.set_num_threads(2)
NEG_INF = -1e30
SC = dict(max_len=128, n_slots=2, tp=C.TP, page=8, kv_page_size=16)


def _engine(method, off, shards, rmode=None, validate=False, fused=1, **kw):
    _, tcfg, _, tparams = C.setup()
    sc = ServeConfig(method=method, **dict(SC, **kw), fused_steps=fused,
                     offload_cfg=OffloadConfig(mode=off, shards=shards,
                                               validate=validate),
                     retrieval=None if rmode is None else C.rcfg(rmode))
    return Engine(tcfg, tparams, sc, device="cpu",
                  sparse_params=C.sparse_params(method)[1])


@functools.lru_cache(maxsize=None)
def _jax_sharded_dsa():
    """The JAX package's 2-shard overlapped executor on the mixed pool:
    (tokens, retrieval events)."""
    jcfg, _, jparams, _ = C.setup()
    jeng = JEngine(jcfg, jparams, JServeConfig(
        method="dsa", **SC, offload_cfg=JOffloadConfig(mode="overlap",
                                                       shards=2),
        retrieval=C.rcfg("overlap", jax_side=True)),
        key=jax.random.PRNGKey(0))
    for i, p in enumerate(C.prompts((16, 24), seed=5)):
        jeng.submit(JRequest(i, p, 6, retrieval=(i == 0)))
    return C.drain(jeng, 24), C.events(jeng)


# ---------------------------------------------------------------------------
# serving: shards=2 == shards=1 == inline retrieval (== JAX for dsa)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["dsa", "seer", "lserve"])
def test_sharded_bitmatches_single_and_inline(method):
    prompts = C.prompts((16, 24), seed=5)
    streams, events = {}, {}
    sharded = None
    for off, rmode, shards in (("sync", "inline", 1), ("sync", "sync", 2),
                               ("overlap", "overlap", 2)):
        eng = _engine(method, off, shards, rmode,
                      validate=off == "overlap")
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, 6, retrieval=(i == 0)))
        key = (off, rmode, shards)
        streams[key] = C.drain(eng, 24)
        events[key] = C.events(eng)
        assert events[key], "no retrieval fired"
        assert eng.pool.pages_in_use() == 0
        assert C.free_pages_zero(eng.pool)
        if shards == 2:
            sharded = eng
            assert isinstance(eng.hetero, ShardedHeteroExecutor)
    first = streams[("sync", "inline", 1)]
    assert all(s == first for s in streams.values())
    assert len(set(map(tuple, events.values()))) == 1
    if method == "dsa":
        assert (first, events[("sync", "inline", 1)]) == _jax_sharded_dsa()

    # index-only: per shard, at most n_part (val, idx) pairs of 8 bytes a
    # layer and slot each offloaded step, less than one KV page
    hx = sharded.hetero
    cfg = C.setup()[1]
    L, B = cfg.n_layers, SC["n_slots"]
    kv_page = SC["kv_page_size"] * cfg.n_kv_heads * cfg.hd * 2 * 2
    for led, shard in zip(hx.ledgers, hx.shards):
        assert 0 < led.up_bytes <= led.steps * 8 * L * B * shard.n_part
        assert led.up_bytes / led.steps < kv_page
    rep = hx.report()
    assert rep["shards"]["n_shards"] == 2
    assert rep["shards"]["windows"] == [[0, 64], [64, 128]]
    assert len(rep["shards"]["per_shard_transfer"]) == 2
    assert rep["devices"]["offload"] == ["cpu", "cpu"]


def test_sharded_under_scheduler():
    """Chunked admission + staggered completion: overlapped 2-shard serving
    == the synchronous single-shard executor."""
    prompts = C.prompts((10, 40, 16, 33), seed=7)
    streams = {}
    for off, shards in (("sync", 1), ("overlap", 2)):
        eng = _engine("dsa", off, shards, prefill_chunk=16,
                      chunk_threshold=32)
        sch = Scheduler(eng, prefill_token_budget=32)
        rids = [sch.submit(p, max_new=4) for p in prompts]
        done = sch.run()
        assert sorted(done) == sorted(rids)
        streams[(off, shards)] = {r: done[r].tokens for r in done}
        assert eng.pool.pages_in_use() == 0
        assert C.free_pages_zero(eng.pool)
    assert streams[("sync", 1)] == streams[("overlap", 2)]


def test_shard_ownership_alignment():
    """The pool's page -> shard map agrees with the shards' ingest windows,
    and the engine aligns max_len to whole selection and KV pages per
    shard."""
    eng = _engine("dsa", "sync", 2, max_len=100)
    assert eng.sc.max_len % (2 * 16) == 0 and eng.sc.max_len >= 100
    eng._ensure_pool()
    owners = eng.pool.shard_owners(2)
    local = eng.sc.max_len // 2
    for s, shard in enumerate(eng.hetero.shards):
        assert shard.tok_lo == s * local and shard.n_tok == local
        pages = np.flatnonzero(owners == s) * SC["kv_page_size"]
        assert pages.min() == shard.tok_lo
        assert pages.max() + SC["kv_page_size"] == shard.tok_lo + \
            shard.n_tok
        view = eng.pool.shard_table_view(2, s)
        assert view.shape == (SC["n_slots"], local // SC["kv_page_size"])
    main, offs = pick_devices_sharded(3, "cpu")
    assert main == torch.device("cpu") and offs == (main,) * 3


@pytest.mark.parametrize("shards", [1, 2])
def test_lookahead_survives_membership_events(shards):
    """A staggered admission and a retrieval splice patch only the affected
    rows of the pending lookahead: one cold start for the run, every other
    step reuses the overlapped selection (validate replays each)."""
    rng = np.random.default_rng(3)
    vocab = C.setup()[0].vocab_size
    eng = _engine("dsa", "overlap", shards, "overlap", validate=True)
    eng.submit(Request(0, rng.integers(0, vocab, size=16), 8,
                       retrieval=True))
    got = {}
    for step in range(26):
        for rid, _s, tok in eng.poll():
            got.setdefault(rid, []).append(tok)
        if step == 2:
            eng.submit(Request(1, rng.integers(0, vocab, size=12), 6,
                               retrieval=False))
    assert len(got[0]) == 8 and len(got[1]) == 6
    assert eng.retrieval.events, "no splice landed"
    p = eng.hetero.profiler
    assert p.lookahead_cold == 1
    assert p.lookahead_patched >= 2
    assert p.lookahead_hits + p.lookahead_cold == p.offload_steps
    assert p.lookahead_hits > p.lookahead_patched


def test_fused_window_over_shards_matches_stepped():
    """An 8-step fused window over 2 shards (the concatenated summary,
    scattered back after) == the stepped 2-shard schedule == 1 shard, with
    the exit lookahead replayed at consumption (validate)."""
    prompts = C.prompts((16, 24), seed=5)
    streams = {}
    for shards, fused in ((1, 1), (2, 1), (2, 8)):
        eng = _engine("dsa", "overlap", shards, validate=True, fused=fused)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, 12))
        streams[(shards, fused)] = C.drain(eng, 14)
        if fused > 1:
            assert eng.stats["host_steps"] < eng.stats["decode_steps"]
            rep = eng.hetero.report()["shards"]["per_shard_transfer"]
            assert all(r["bulk_prefill_bytes"] > 0 for r in rep)
    assert streams[(1, 1)] == streams[(2, 1)] == streams[(2, 8)]
    assert all(len(v) == 12 for v in streams[(1, 1)].values())


# ---------------------------------------------------------------------------
# the sharded top-k merge and the windowed bundles
# ---------------------------------------------------------------------------


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 5), st.integers(1, 24),
       st.booleans())
def test_sharded_topk_merge_matches_ref(seed, n_shards, k, masked):
    """Per-shard exact top-k over ragged contiguous slices of one score row
    (empty and all-masked shards included), merged, == the global stable
    top-k, values, indices and tie order, and == the JAX package's merge of
    the same candidates."""
    rng = np.random.default_rng(seed)
    B, Hq, dk = int(rng.integers(1, 4)), 2, 8
    S = int(rng.integers(n_shards, 40))
    q = torch.from_numpy(rng.normal(size=(B, Hq, dk)).astype(np.float32))
    keys = torch.from_numpy(rng.normal(size=(B, S, dk)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 1, size=(B, Hq)).astype(np.float32))
    length = int(rng.integers(0, S + 1)) if masked else S
    scores = ref.relevancy_scores(q, keys, w)
    scores = torch.where(torch.arange(S)[None] < length, scores,
                         torch.full_like(scores, NEG_INF))
    want_v, want_i = ref.topk_stable(scores, min(k, S))
    bounds = [0] + sorted(rng.integers(0, S + 1,
                                       size=n_shards - 1).tolist()) + [S]
    vals, idx = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi == lo:
            continue                      # an empty shard sends nothing
        v, i = ref.topk_stable(scores[:, lo:hi], min(k, hi - lo))
        vals.append(v)
        idx.append(i + lo)                # global coordinates
    mv, mi = merge_shard_topk(torch.cat(vals, -1), torch.cat(idx, -1),
                              min(k, S))
    assert torch.equal(mi, want_i) and torch.equal(mv, want_v)
    jv, ji = jmerge(jnp.asarray(torch.cat(vals, -1).numpy()),
                    jnp.asarray(torch.cat(idx, -1).numpy()), min(k, S))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 4))
def test_windowed_bundles_match_full_select(seed, n_shards):
    """One key stream ingested through ragged window bundles, their partial
    selections merged == the full bundle's selection."""
    cfg = C.setup()[1]
    mem = cfg.memory
    rng = np.random.default_rng(seed)
    page, max_len, n_slots = 8, 64, 2
    sp = get_sparse_method("dsa")[0](cfg, mem, seed % 97, stacked=True,
                                     device="cpu")
    full = make_offload_select("dsa", cfg, mem, dsa_page=page,
                               n_slots=n_slots, max_len=max_len,
                               device="cpu")
    P = max_len // page
    cuts = sorted(set([0, P] + rng.integers(0, P + 1,
                                            size=n_shards - 1).tolist()))
    windows = [(lo * page, (hi - lo) * page)
               for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]
    shards = [make_offload_select("dsa", cfg, mem, dsa_page=page,
                                  n_slots=n_slots, max_len=max_len,
                                  window=w, device="cpu") for w in windows]
    lens = rng.integers(1, max_len + 1, size=n_slots).astype(np.int32)
    S = int(lens.max())
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    k_span = f(cfg.n_layers, n_slots, S, cfg.n_kv_heads, cfg.hd)
    q = f(cfg.n_layers, n_slots, cfg.padded_heads(C.TP), cfg.hd)
    slot_ids = torch.arange(n_slots)
    start = torch.zeros(n_slots, dtype=torch.int32)
    lengths = torch.from_numpy(lens)
    s_full = full.ingest_span(full.summary_init(), sp, k_span, slot_ids,
                              start, lengths)
    want = full.select(sp, s_full, q, lengths)
    vals, idx = [], []
    for sh in shards:
        s_sh = sh.ingest_span(sh.summary_init(), sp, k_span, slot_ids,
                              start, lengths)
        v, i = sh.select_partial(sp, s_sh, q, lengths)
        vals.append(v)
        idx.append(i)
    got = full.finalize(torch.cat(vals, -1), torch.cat(idx, -1), lengths)
    assert torch.equal(got, want)
