"""The split top-c of the relevancy and BM25 kernels on the CPU: the plain
version of the CUDA kernels' schedule (``relevancy_topk.split_topk``: per
CTA chunk, runs of 128-score segments or, for c <= 16, of the warps'
register lists, merged by rank to min(c, chunk); the chunks' runs merged
by rank to c)
against the JAX package's ``relevancy_topk_candidates`` and
``bm25_topk_candidates`` (Pallas in interpret mode) and the port's plain
versions, on the same numpy inputs; and the split plan.

Tolerance: values within 1e-5 (fp32 on both sides; only the order of the
sums differs from JAX's); indices equal to the plain version's everywhere
(the same scores), and to JAX's wherever JAX's value is isolated from its
neighbours by more than 1e-5 or exactly tied with one, and exactly equal
in the tie cases (all-zero keys, duplicated rows, all -inf).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import bm25_topk as jbm  # noqa: E402
from repro.kernels import relevancy_topk as jrt  # noqa: E402
from repro_torch.kernels import bm25_topk as tbm  # noqa: E402
from repro_torch.kernels import relevancy_topk as trt  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _check(v, i, jv, ji, pv, pi, exact):
    """(v, i) of the split model against JAX's (jv, ji) and the plain
    version's (pv, pi)."""
    v, i = v.numpy(), i.numpy()
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert i.dtype == np.int32 and v.shape == jv.shape == pv.shape
    np.testing.assert_array_equal(v, pv.numpy())
    np.testing.assert_array_equal(i, pi.numpy())
    np.testing.assert_array_equal(np.isfinite(v), np.isfinite(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(v[fin], jv[fin], rtol=TOL, atol=TOL)
    if exact:
        np.testing.assert_array_equal(i, ji)
        return
    with np.errstate(invalid="ignore"):
        d = np.abs(np.diff(jv, axis=-1))
    d = np.where(np.isnan(d), 0.0, d)          # -inf - -inf: an exact tie
    gap = np.full(jv.shape, np.inf)
    gap[..., 1:] = np.minimum(gap[..., 1:], d)
    gap[..., :-1] = np.minimum(gap[..., :-1], d)
    tied = np.zeros(jv.shape, bool)
    tied[..., 1:] |= jv[..., 1:] == jv[..., :-1]
    tied[..., :-1] |= jv[..., 1:] == jv[..., :-1]
    compared = (gap > TOL * np.maximum(1.0, np.abs(jv))) | tied
    np.testing.assert_array_equal(i[compared], ji[compared])


# ---------------------------------------------------------------------------
# relevancy: q [B, Hq, dk] . keys [B, S, dk], relu, weights over heads
# ---------------------------------------------------------------------------

# (name, S, block, c, valid_len, n CTAs a block (0: split_plan), keys)
RELEVANCY_CASES = [
    ("two blocks, two CTAs of two warp segments", 1024, 512, 0, 0, 2,
     "randn"),
    ("plan (8 CTAs of 64)", 1024, 512, 0, 0, 0, "randn"),
    ("all-zero keys: every score tied", 512, 512, 0, 0, 4, "zero"),
    ("valid_len mid-chunk, a chunk wholly masked", 512, 512, 0, 300, 4,
     "randn"),
    ("c 20, not a power of two", 1024, 256, 20, 0, 4, "randn"),
    ("c = block, N 1", 256, 128, 128, 0, 1, "randn"),
    ("c < a warp segment's run, valid_len in the second block", 1024, 512,
     40, 700, 2, "randn"),
    ("chunk below a segment, fewer live keys than c", 256, 256, 64,
     10, 8, "randn"),
    ("c 8: warps' register lists, two scores a thread", 1024, 512, 8, 0, 2,
     "randn"),
    ("c 16, all-zero keys: register lists of ties", 512, 512, 16, 0, 2,
     "zero"),
]

_JAX = {}


def _relevancy_inputs(S, keys_kind, seed=0):
    rng = np.random.default_rng(seed + S)
    B, Hq, dk = 2, 4, 16
    q = rng.standard_normal((B, Hq, dk)).astype(np.float32)
    keys = (np.zeros((B, S, dk)) if keys_kind == "zero"
            else rng.standard_normal((B, S, dk))).astype(np.float32)
    w = np.abs(rng.standard_normal((B, Hq))).astype(np.float32)
    return q, keys, w


@pytest.mark.parametrize("case", RELEVANCY_CASES, ids=[c[0] for c in
                                                       RELEVANCY_CASES])
def test_relevancy_split_matches_jax_and_plain(case):
    name, S, block, c, valid_len, n, kind = case
    q, keys, w = _relevancy_inputs(S, kind)
    if name not in _JAX:
        _JAX[name] = jrt.relevancy_topk_candidates(
            jnp.asarray(q), jnp.asarray(keys), jnp.asarray(w), block=block,
            c=c, valid_len=valid_len, interpret=True)
    args = (_t(q), _t(keys), _t(w))
    kw = dict(block=block, c=c, valid_len=valid_len)
    v, i = trt.relevancy_topk_candidates_split(*args, n=n, **kw)
    pv, pi = trt.relevancy_topk_candidates_plain(*args, **kw)
    _check(v, i, *_JAX[name], pv, pi, exact=kind == "zero")
    if kind == "zero":    # every score 0: the block's first c indices
        nb = S // block
        want = np.arange(block)[: v.shape[-1]] + block * np.arange(nb)[:, None]
        np.testing.assert_array_equal(i.numpy(), np.broadcast_to(
            want, i.shape))
    if valid_len:
        # a block's -inf entries are its lowest masked indices, ascending
        masked = ~np.isfinite(v.numpy())
        for j in range(v.shape[1]):
            live = min(max(valid_len - j * block, 0), block)
            lo = j * block + live
            want = np.arange(lo, lo + max(v.shape[-1] - live, 0))
            for b in range(v.shape[0]):
                np.testing.assert_array_equal(i.numpy()[b, j][masked[b, j]],
                                              want)


# ---------------------------------------------------------------------------
# BM25 over a gathered [B, D, T] panel with a runtime live count
# ---------------------------------------------------------------------------

# (name, B, D, T, block, c, valid, n, panel kind)
BM25_CASES = [
    ("serving-like: c 4, two CTAs, register lists", 1, 4096, 8, 2048, 4,
     4000, 2, "poisson"),
    ("c 16, duplicated rows, register lists of 8 warps", 2, 1024, 8, 512,
     16, 0, 2, "dup"),
    ("duplicated rows", 2, 1024, 8, 512, 32, 0, 4, "dup"),
    ("nd mid-chunk, chunks wholly masked", 2, 1024, 4, 512, 16, 600, 4,
     "poisson"),
    ("fewer live docs than c", 1, 512, 8, 512, 8, 3, 4, "poisson"),
    ("3 live docs over two CTAs of 2", 1, 64, 8, 8, 8, 3, 4, "poisson"),
    ("c 24, not a power of two, Fig. 10-like T 16", 1, 2048, 16, 1024, 24, 0,
     8, "poisson"),
    ("c = block", 2, 512, 4, 128, 128, 0, 2, "poisson"),
    ("all-zero panel, N 1", 2, 256, 8, 128, 8, 0, 1, "zero"),
    ("nothing live in the second row's blocks", 2, 512, 8, 256, 8, 100, 0,
     "poisson"),
]


def _bm25_inputs(B, D, T, kind, seed=0):
    rng = np.random.default_rng(seed + D + T)
    tf = np.zeros((B, D, T)) if kind == "zero" else rng.poisson(0.7, (B, D, T))
    dl = rng.integers(16, 64, (B, D)).astype(np.float64)
    if kind == "dup":                      # rows in equal pairs: exact ties
        tf[:, 1::2], dl[:, 1::2] = tf[:, ::2], dl[:, ::2]
    idf = rng.random((B, T)) + 0.1
    return [a.astype(np.float32) for a in (tf, dl, idf)]


@pytest.mark.parametrize("case", BM25_CASES, ids=[c[0] for c in BM25_CASES])
def test_bm25_split_matches_jax_and_plain(case):
    name, B, D, T, block, c, valid, n, kind = case
    tf, dl, idf = _bm25_inputs(B, D, T, kind)
    if name not in _JAX:
        _JAX[name] = jbm.bm25_topk_candidates(
            jnp.asarray(tf), jnp.asarray(dl), jnp.asarray(idf), block=block,
            c=c, avgdl=40.0, valid=valid, interpret=True)
    args = (_t(tf), _t(dl), _t(idf))
    kw = dict(block=block, c=c, avgdl=40.0, valid=valid)
    v, i = tbm.bm25_topk_candidates_split(*args, n=n, **kw)
    pv, pi = tbm.bm25_topk_candidates_plain(*args, **kw)
    _check(v, i, *_JAX[name], pv, pi, exact=kind in ("zero", "dup"))
    if kind == "dup":
        jv = np.asarray(_JAX[name][0])
        assert (jv[..., 1:] == jv[..., :-1]).any(), "no tie compared"
    # a 0-d int32 tensor live count reads as the int
    v2, i2 = tbm.bm25_topk_candidates_split(
        *args, n=n, **dict(kw, valid=torch.tensor(valid, dtype=torch.int32)))
    assert torch.equal(i2, i) and torch.equal(v2, v)


# ---------------------------------------------------------------------------
# the rank merge and the split plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R,L,keep", [(2, 4, 4), (8, 16, 128), (4, 8, 5),
                                      (16, 2, 3)])
def test_rank_merge_equals_a_full_sort(R, L, keep):
    """Sorted runs with values drawn from a few levels (many exact ties,
    -inf among them) merge to the stable full sort's prefix."""
    rng = np.random.default_rng(R * L + keep)
    v = rng.choice([-np.inf, 0.0, 0.5, 1.0], size=(3, R * L)).astype(np.float32)
    i = np.stack([rng.permutation(R * L) for _ in range(3)]).astype(np.int32)
    order = np.lexsort((i, -v), axis=-1)
    want_v = np.take_along_axis(v, order, -1)[:, :keep]
    want_i = np.take_along_axis(i, order, -1)[:, :keep]
    # _sorted_runs wants ascending indices along the axis: order them first
    runs = []
    for r in range(R):
        seg_v, seg_i = v[:, r * L:(r + 1) * L], i[:, r * L:(r + 1) * L]
        o = np.argsort(seg_i, axis=-1, kind="stable")
        runs.append(trt._sorted_runs(_t(np.take_along_axis(seg_v, o, -1)),
                                     _t(np.take_along_axis(seg_i, o, -1)), L))
    rv = torch.stack([r[0] for r in runs], 1)
    ri = torch.stack([r[1] for r in runs], 1)
    mv, mi = trt.rank_merge(rv, ri, keep)
    np.testing.assert_array_equal(mv.numpy(), want_v)
    np.testing.assert_array_equal(mi.numpy(), want_i)


@pytest.mark.parametrize("B,nb,block,c,want", [
    (4, 1, 512, 512, 8),       # DSA: 32 CTAs of 64 keys
    (4, 1, 128, 128, 2),       # Seer: 8 CTAs of 64 keys
    (1, 64, 4096, 4, 2),       # BM25 serving: 128 CTAs of 2048 docs
    (1, 4, 4096, 64, 8),       # Fig. 10: 32 CTAs of 512 docs
    (2, 2, 64, 64, 1),         # tiny blocks: one CTA
    (2, 4, 32, 8, 1),
    (33, 4, 512, 512, 1),      # 132 blocks already fill the card
    (16, 2, 512, 16, 4),       # 128 CTAs
])
def test_split_plan(B, nb, block, c, want):
    n = trt.split_plan(B, nb, block, c, n_sm=132)
    assert n == want
    assert n & (n - 1) == 0 and block % n == 0 and n <= trt.MAX_CLUSTER
    assert n == 1 or (block // n >= trt.MIN_CHUNK and B * nb * n <= 132)


@pytest.mark.parametrize("block", [2048, 4096])
def test_split_plan_stays_portable(block):
    """One block of 2048 or 4096 could take 16 CTAs of 128 or more; the
    plan stops at the portable 8."""
    assert trt.split_plan(1, 1, block, 8) == trt.MAX_CLUSTER == 8
