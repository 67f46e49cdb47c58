"""The port's kernel API on the CPU (plain versions) against the JAX
package's kernels (Pallas in interpret mode through ``repro.kernels.ops``),
on the same numpy inputs.

Tolerances: fp32 values within 1e-5 (both sides compute in fp32 and differ
only in summation order); indices, sort orders and pool contents exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import bitonic as jbitonic  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import page_pool as jpool  # noqa: E402
from repro.kernels import relevancy_topk as jrt  # noqa: E402
from repro_torch.kernels import bitonic as tbitonic  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import page_pool as tpool  # noqa: E402
from repro_torch.kernels import relevancy_topk as trt  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# relevancy + top-k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Hq,dk,S,k,block,zero_keys", [
    (2, 4, 16, 128, 8, 32, False),
    (2, 8, 32, 96, 16, 64, False),      # S not a block multiple: pow2 pad
    (1, 4, 16, 24, 40, 16, False),      # k > S: clamped to S
    (2, 4, 16, 64, 12, 32, True),       # all-zero scores: ties by index
])
def test_relevancy_topk_matches_jax(B, Hq, dk, S, k, block, zero_keys):
    q = _np((B, Hq, dk), 1)
    keys = np.zeros((B, S, dk), np.float32) if zero_keys else _np((B, S, dk), 2)
    w = np.abs(_np((B, Hq), 3))
    jv, ji = jops.relevancy_topk(jnp.asarray(q), jnp.asarray(keys),
                                 jnp.asarray(w), k, block=block)
    tv, ti = tops.relevancy_topk(_t(q), _t(keys), _t(w), k, block=block)
    assert ti.dtype == torch.int32 and ti.shape == (B, min(k, S))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("block,c,valid_len", [(32, 0, 0), (32, 8, 100)])
def test_relevancy_candidates_match_jax(block, c, valid_len):
    """Per-block candidates of the plain version == the Pallas kernel's."""
    B, Hq, dk, S = 2, 4, 16, 128
    q, keys, w = _np((B, Hq, dk), 4), _np((B, S, dk), 5), np.abs(_np((B, Hq), 6))
    jv, ji = jrt.relevancy_topk_candidates(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(w), block=block, c=c,
        valid_len=valid_len, interpret=True)
    tv, ti = trt.relevancy_topk_candidates(_t(q), _t(keys), _t(w),
                                           block=block, c=c,
                                           valid_len=valid_len)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n,seed", [(8, 0), (64, 1), (256, 2)])
def test_bitonic_sort_matches_jax(n, seed):
    """Same network, same compare rule: identical keys and payload order,
    with many duplicate keys."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-4, 4, (3, n)).astype(np.float32)
    vals = np.tile(np.arange(n, dtype=np.int32), (3, 1))
    jk, jv = jbitonic.bitonic_sort_desc(jnp.asarray(keys), jnp.asarray(vals))
    tk, tv = tbitonic.bitonic_sort_desc(_t(keys), _t(vals))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    tk5, tv5 = tbitonic.bitonic_topk(_t(keys), _t(vals), 5)
    np.testing.assert_array_equal(tv5.numpy(), np.asarray(jv)[:, :5])


def test_bitonic_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tbitonic.bitonic_sort_desc(torch.zeros(6), torch.zeros(6))


@pytest.mark.parametrize("k", [3, 7])
def test_merge_candidates_tie_order(k):
    """Equal values keep candidate order (lax.top_k's lower-index-first)."""
    vals = np.array([[[3., 1., 1., 0.], [3., 1., 0., 0.]]], np.float32)
    idx = np.array([[[0, 2, 3, 1], [4, 6, 5, 7]]], np.int32)
    jv, ji = jrt.merge_candidates(jnp.asarray(vals), jnp.asarray(idx), k)
    tv, ti = trt.merge_candidates(_t(vals), _t(idx), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,KV,G,dh,S,ps,nsel", [
    (3, 2, 2, 32, 128, 16, 4),
    (3, 1, 4, 16, 64, 4, 6),
])
def test_paged_decode_attention_matches_jax(B, KV, G, dh, S, ps, nsel):
    """-1 holes, a length cut mid-page, and a row whose pages are all -1
    (out = mean of v over page 0 of the view, lse ~ -1e30)."""
    rng = np.random.default_rng(7)
    Hq = KV * G
    q = _np((B, Hq, dh), 8)
    kc, vc = _np((B, S, KV, dh), 9), _np((B, S, KV, dh), 10)
    pages = np.stack([rng.choice(S // ps, nsel, replace=False)
                      for _ in range(B)]).astype(np.int32)
    pages[0, 1] = -1                       # hole
    pages[2, :] = -1                       # all masked
    length = np.array([S - ps // 2, S // 2 + 1, S], np.int32)   # mid-page
    jo, jl = jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pages),
        jnp.asarray(length), page_size=ps)
    to, tl = tops.paged_decode_attention(_t(q), _t(kc), _t(vc), _t(pages),
                                         _t(length), page_size=ps)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    # the all-masked row averages v over page 0 of its view
    want = vc[2, :ps].mean(0)                              # [KV, dh]
    np.testing.assert_allclose(to.numpy()[2].reshape(KV, G, dh),
                               np.repeat(want[:, None], G, 1), atol=TOL)
    assert (tl.numpy()[2] < -1e29).all()


def test_lse_merge_equals_joint_attention():
    """Two disjoint page sets LSE-merged == attention over their union."""
    B, KV, G, dh, S, ps = 1, 2, 2, 16, 128, 16
    q, kc, vc = _np((B, KV * G, dh), 11), _np((B, S, KV, dh), 12), \
        _np((B, S, KV, dh), 13)
    allp = torch.arange(S // ps, dtype=torch.int32)[None]
    length = torch.tensor([S], dtype=torch.int32)
    args = (_t(q), _t(kc), _t(vc))
    o_all, _ = tops.paged_decode_attention(*args, allp, length, page_size=ps)
    o1, l1 = tops.paged_decode_attention(*args, allp[:, :4], length,
                                         page_size=ps)
    o2, l2 = tops.paged_decode_attention(*args, allp[:, 4:], length,
                                         page_size=ps)
    merged, _ = tops.lse_merge(torch.stack([o1, o2]), torch.stack([l1, l2]))
    np.testing.assert_allclose(merged.numpy(), o_all.numpy(), atol=TOL)


# ---------------------------------------------------------------------------
# page pool
# ---------------------------------------------------------------------------


def _pool_inputs():
    rng = np.random.default_rng(14)
    P, ps, KV, dh, B, NP = 12, 4, 2, 8, 3, 3
    pages = np.zeros((P, ps, KV, dh), np.float32)
    pages[1:] = _np((P - 1, ps, KV, dh), 15)
    table = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0]], np.int32)
    return rng, pages, table, B, NP, ps, KV, dh


@pytest.mark.parametrize("op", ["gather", "token", "span"])
def test_pool_ops_match_jax(op):
    """Pool gather/scatter == repro.kernels.page_pool; dead and padding
    writes land zeroed on page 0."""
    rng, pages, table, B, NP, ps, KV, dh = _pool_inputs()
    tp = _t(pages.copy())
    if op == "gather":
        want = jpool.pool_gather(jnp.asarray(pages), jnp.asarray(table))
        got = tpool.pool_gather(tp, _t(table))
    elif op == "token":
        pos = np.array([5, 2, 12], np.int32)           # slot 2 dead, at NP*ps
        live = np.array([True, True, False])
        vals = _np((B, KV, dh), 16)
        want = jpool.pool_scatter_token(jnp.asarray(pages), jnp.asarray(table),
                                        jnp.asarray(pos), jnp.asarray(vals),
                                        jnp.asarray(live))
        got = tpool.pool_scatter_token(tp, _t(table), _t(pos), _t(vals),
                                       _t(live))
    else:
        C = 5
        start = np.array([2, 1, 0], np.int32)
        n_valid = np.array([5, 3, 0], np.int32)
        vals = _np((B, C, KV, dh), 17)
        want = jpool.pool_scatter_span(jnp.asarray(pages), jnp.asarray(table),
                                       jnp.asarray(start), jnp.asarray(vals),
                                       jnp.asarray(n_valid))
        got = tpool.pool_scatter_span(tp, _t(table), _t(start), _t(vals),
                                      _t(n_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if op != "gather":
        assert got is tp                              # written in place
        assert not got[0].any()                       # zero page stays zero


def test_use_kernels_false_routes_to_ref():
    q, keys, w = _np((1, 4, 8), 18), _np((1, 32, 8), 19), np.abs(_np((1, 4), 20))
    want = tops.relevancy_topk(_t(q), _t(keys), _t(w), 5, block=8)
    tops.use_kernels(False)
    try:
        got = tops.relevancy_topk(_t(q), _t(keys), _t(w), 5, block=8)
    finally:
        tops.use_kernels(True)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=TOL)
