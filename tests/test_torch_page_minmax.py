"""``page_minmax``'s bulk-route plan (``kernels.page_pool.minmax_plan``) and
its NaN / inf semantics, on the CPU.

The plan is walked as ``csrc/page_minmax.cu`` walks it (CTA ``c`` takes
tiles ``c, c + grid, ...``; a tile is one (slot, page, piece of a row),
streamed in bands of rows) at the LServe shapes the card runs: the main
path's k [4,8192,8,64] bf16, a decode-split shard's [2,8192,8,64] and the
hybrid's fp32 shard [2,2048,32,112], at 64-token pages, at 16, at one page,
at 128 (bands), with uneven pieces, on 132 and 114 SMs. Every key is covered
exactly once, pieces are whole 16-byte vectors, the ring fits in a CTA's 227
KB of shared memory (twice in an SM's 228 KB where two CTAs share it), and
the CTAs' tile counts differ by at most one. Folding the walk's units in numpy
gives the plain version's result exactly, NaN included. The port's page
min / max equals the Pallas kernel (interpret mode) and the JAX oracle
exactly, with NaN where they have NaN.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import page_pool as pp  # noqa: E402

#: a CTA's shared memory on sm_90 (the opt-in maximum, 227 KB)
SMEM_MAX = 232448

# (B, S, KV, dh, element bytes, page size)
SHAPES = {
    "lserve main path": (4, 8192, 8, 64, 2, 64),
    "decode-split shard": (2, 8192, 8, 64, 2, 64),
    "hybrid fp32 shard": (2, 2048, 32, 112, 4, 64),
    "ps 16": (4, 1024, 8, 64, 2, 16),
    "one page": (2, 64, 8, 64, 2, 64),
    "two bands (ps 128)": (2, 1024, 8, 64, 2, 128),
    "uneven pieces (4176-byte rows)": (2, 1024, 8, 261, 2, 64),
    "2048 tiles (ps 16, fp32)": (4, 4096, 8, 64, 4, 16),
    "one vector a row": (1, 128, 1, 8, 2, 64),
}


def _units(plan, G, ps):
    """The kernel's units in its order: (cta, tile ordinal, slot x page,
    first vector, vectors, first row, rows)."""
    for cta in range(plan.grid):
        for i, tile in enumerate(range(cta, plan.tiles, plan.grid)):
            bp, g0 = tile // plan.pieces, (tile % plan.pieces) * plan.W
            for band in range(plan.bands):
                r = band * plan.rows
                yield (cta, i, bp, g0, min(plan.W, G - g0), r,
                       min(plan.rows, ps - r))


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_covers_every_key_once(shape, n_sm):
    B, S, KV, dh, elem, ps = SHAPES[shape]
    C = KV * dh
    G = C * elem // 16
    plan = pp.minmax_plan(B, S, C, elem, ps, n_sm)
    assert plan.smem <= SMEM_MAX
    stage = plan.rows * plan.W * 16
    assert plan.stages >= 2
    assert plan.smem >= plan.stages * stage
    # one CTA an SM, or two where both fit in an SM's 228 KB (1 KB of each
    # CTA's shared memory is the system's)
    per_sm = 2 if plan.grid > n_sm else 1
    assert plan.grid == min(plan.tiles, per_sm * n_sm)
    assert per_sm * (plan.smem + 1024) <= 228 * 1024
    assert plan.tiles == B * (S // ps) * plan.pieces
    cover = np.zeros((B * (S // ps), ps, G), np.uint8)   # per 16-byte vector
    tiles_of = np.zeros(plan.grid, np.int64)
    for cta, i, bp, g0, w, r, nr in _units(plan, G, ps):
        assert 0 < w <= plan.W and 0 < nr <= plan.rows
        assert nr * w * 16 <= stage
        cover[bp, r:r + nr, g0:g0 + w] += 1
        tiles_of[cta] = max(tiles_of[cta], i + 1)
    assert (cover == 1).all()
    assert tiles_of.max() - tiles_of.min() <= 1
    assert tiles_of.sum() == plan.tiles
    # a row's pieces: equal but the last, none empty, each whole vectors,
    # at most one vector a thread
    assert (plan.pieces - 1) * plan.W < G <= plan.pieces * plan.W
    assert plan.W <= pp.THREADS


@pytest.mark.parametrize("n_sm", [132, 114])
def test_plan_at_the_lserve_rows(n_sm):
    """Rows 4 and 4a take whole 1 KB rows (a page's contiguous 64 KB is a
    tile), 4b's 14,336-byte rows 4 pieces of 3,584 bytes; 4a's 256 tiles
    fit two CTAs an SM on 132 SMs, one tile each. Every row keeps at least
    64 KB an SM in flight."""
    for shape, pieces, W in (("lserve main path", 1, 64),
                             ("decode-split shard", 1, 64),
                             ("hybrid fp32 shard", 4, 224)):
        B, S, KV, dh, elem, ps = SHAPES[shape]
        plan = pp.minmax_plan(B, S, KV * dh, elem, ps, n_sm)
        assert (plan.pieces, plan.W) == (pieces, W)
        per_sm = 2 if plan.grid > n_sm else 1
        assert per_sm == (2 if shape == "decode-split shard" and n_sm == 132
                          else 1)
        assert plan.grid == min(plan.tiles, per_sm * n_sm)
        assert per_sm * plan.stages * plan.rows * plan.W * 16 >= 64 * 1024
        assert per_sm * (plan.smem + 1024) <= 228 * 1024


def _nan_keys(shape, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(shape).astype(np.float32) * 3 - 0.5
    k[0, 3, 0, 1] = np.nan                      # slot 0, page 0
    k[1, -1, -1, :] = np.nan                    # slot 1, last page
    k[0, -2, 1, 2:5] = np.inf
    k[1, 1, 0, :] = -np.inf
    k[1, 2, 0, 3] = np.nan                      # NaN beside -inf
    return k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,ps", [((2, 64, 2, 32), 16),
                                      ((2, 256, 8, 261), 64),
                                      ((2, 256, 32, 112), 128)])
def test_plan_walk_folds_to_the_plain_version(dtype, shape, ps):
    """The walk's units, folded as the kernel folds them (per band into a
    tile's running min / max, written at the tile's place in the output),
    give the plain version's result, NaN where it has NaN."""
    k = _nan_keys(shape, 5)
    kt = torch.from_numpy(k).to(getattr(torch, dtype))
    B, S, KV, dh = shape
    C, elem = KV * dh, kt.element_size()
    G, vec = C * elem // 16, 16 // elem
    plan = pp.minmax_plan(B, S, C, elem, ps, 7)
    rows = kt.float().reshape(B * S, C).numpy()
    out = np.full((2, B * (S // ps) * C), 7.0, np.float32)
    lo = hi = None
    for _, _, bp, g0, w, r, nr in _units(plan, G, ps):
        blk = rows[bp * ps + r:bp * ps + r + nr, g0 * vec:(g0 + w) * vec]
        if r == 0:
            lo, hi = blk.min(0), blk.max(0)
        else:
            lo, hi = np.minimum(lo, blk.min(0)), np.maximum(hi, blk.max(0))
        if r + nr == ps:
            out[:, bp * C + g0 * vec:bp * C + (g0 + w) * vec] = lo, hi
    want = pp.page_minmax_plain(kt, page_size=ps)
    for got, ref in zip(out, want):
        ref = ref.reshape(-1).numpy()
        assert np.isnan(ref).any()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [8, 16])
def test_page_minmax_nan_and_inf_match_jax(dtype, ps):
    """NaN where the Pallas kernel (interpret mode) and the JAX oracle have
    NaN, every other element equal to both; a CPU tensor never launches."""
    k = _nan_keys((2, 64, 2, 32), 3)
    k_j = k.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else k
    k_t = torch.from_numpy(np.asarray(k_j, np.float32)).to(
        getattr(torch, dtype))
    kern = jops.page_minmax(jnp.asarray(k_j), page_size=ps)
    orac = jref.page_minmax(jnp.asarray(k_j), ps)
    n0 = pp.page_minmax.launches
    got = pp.page_minmax(k_t, page_size=ps)
    assert pp.page_minmax.launches == n0
    for g, a, b in zip(got, kern, orac):
        a, b = np.asarray(a), np.asarray(b)
        assert g.dtype == torch.float32 and g.shape == (2, 64 // ps, 2, 32)
        assert np.isnan(a).any() and np.isinf(a).any()
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(a))
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(b))
        np.testing.assert_array_equal(g.numpy(), a)
        np.testing.assert_array_equal(g.numpy(), b)
