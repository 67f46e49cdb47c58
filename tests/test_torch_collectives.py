"""The port's gradient compression and collectives against the reference's
``repro.distributed.collectives`` on the same numpy inputs: int8 and bf16
compression with error feedback bit for bit (three rounds of feedback), the
ring-cost formulas at the same link bandwidth, and ports of
``tests/test_train.py``'s compression tests; the in-process collectives
against numpy."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.placement import ICI_BW  # noqa: E402
from repro.distributed import collectives as jcol  # noqa: E402
from repro_torch.core.placement import NVLINK_BW  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

SHAPES = {"w": (37, 19), "b": (64,), "u": {"x": (3, 4, 5)}}


def _tree(rng, shapes=SHAPES, scale=1.0):
    return {k: _tree(rng, v, scale) if isinstance(v, dict)
            else (rng.standard_normal(v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _pairs(a, b):
    if isinstance(a, dict):
        return [p for k in sorted(a) for p in _pairs(a[k], b[k])]
    return [(a, b)]


def _bits(t):
    return np.asarray(t, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((257, 33)) * 10 ** rng.uniform(-6, 2)
         ).astype(np.float32)
    # values on the half-quantum boundaries: rounding half to even
    g[0, :8] = np.float32(np.abs(g).max()) / 127 * np.arange(8) + \
        np.float32(np.abs(g).max()) / 254
    q, s = col.compress_int8(torch.from_numpy(g))
    jq, js = jcol.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _bits(s.numpy()) == _bits(np.asarray(js))
    np.testing.assert_array_equal(
        _bits(col.decompress_int8(q, s).numpy()),
        _bits(jcol.decompress_int8(jq, js)))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compressed_grads_with_feedback_bit_equal_to_jax(mode):
    rng = np.random.default_rng(7)
    r_t = r_j = None
    for _ in range(3):
        g = _tree(rng, scale=1e-3)
        sent_t, r_t = col.compressed_grads_with_feedback(_torch(g), r_t,
                                                         mode)
        sent_j, r_j = jcol.compressed_grads_with_feedback(
            jax.tree.map(jnp.asarray, g), r_j, mode)
        for a, b in _pairs(sent_t, sent_j) + _pairs(r_t, r_j):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    assert any(float(r.abs().max()) > 0 for r, _ in _pairs(r_t, r_j))


def test_compress_none_passes_through():
    g = _torch(_tree(np.random.default_rng(0)))
    sent, r = col.compressed_grads_with_feedback(g, None, "none")
    assert sent is g and r is None
    with pytest.raises(ValueError):
        col.compressed_grads_with_feedback(g, None, "fp8")


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(-1e3, 1e3, width=32), min_size=1, max_size=64))
def test_int8_compression_bounded_error(vals):
    g = torch.tensor(vals, dtype=torch.float32)
    q, s = col.compress_int8(g)
    back = col.decompress_int8(q, s)
    assert float((back - g).abs().max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_accumulates_residual():
    g = {"w": torch.tensor([1e-4, 1.0])}
    sent, resid = col.compressed_grads_with_feedback(g, None, "int8")
    # small component lost this round, kept in residual
    assert float(resid["w"][0].abs()) > 0
    # after enough rounds the residual feeds back into what is sent
    total_sent = torch.zeros(2)
    r = None
    for _ in range(300):
        sent, r = col.compressed_grads_with_feedback(g, r, "int8")
        total_sent = total_sent + sent["w"]
    np.testing.assert_allclose((total_sent / 300).numpy(), g["w"].numpy(),
                               rtol=0.05, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 4, 16, 256])
def test_cost_formulas_match_reference(n):
    nbytes = 3.7e9
    for name in ("all_reduce_seconds", "all_gather_seconds",
                 "reduce_scatter_seconds"):
        ours, ref = getattr(col, name), getattr(jcol, name)
        for links in (ICI_BW, NVLINK_BW, 1e9):
            assert ours(nbytes, n, links=links) == ref(nbytes, n, links=links)
        # the defaults: the H100's NVLink 4, one direction, not the TPU's ICI
        assert ours(nbytes, n) == ref(nbytes, n, links=450e9)
    assert NVLINK_BW == 450e9


def test_all_reduce_fixed_order():
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(4)]
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    got = col.all_reduce([torch.from_numpy(x) for x in xs])
    np.testing.assert_array_equal(got.numpy(), want)
    mean = col.all_reduce([torch.from_numpy(x) for x in xs], "mean")
    np.testing.assert_array_equal(mean.numpy(), want / np.float32(4))
    bf = [torch.from_numpy(x).bfloat16() for x in xs]
    got = col.all_reduce(bf, "mean")
    assert got.dtype == torch.bfloat16
    want = sum(x.float() for x in bf) / 4
    assert torch.equal(got, want.bfloat16())
    with pytest.raises(ValueError):
        col.all_reduce(bf, "max")


def test_all_gather_and_ring_shift():
    """The all-gather over one mesh axis (``ShardedTensor.full`` of a leaf
    cut on that axis) and the ring shift."""
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"])
    w = torch.arange(24, dtype=torch.float32).reshape(2, 12)
    placed = sh.device_put(w, sh.NamedSharding(mesh, sh.P(None, "model")))
    assert [tuple(s.shape) for s in placed.shards] == [(2, 3)] * 8
    assert torch.equal(placed.full(), w)
    xs = [torch.full((2, 3), float(i)) for i in range(4)]
    for shift, src in ((1, [3, 0, 1, 2]), (2, [2, 3, 0, 1])):
        got = col.ring_shift(xs, shift)
        assert all(torch.equal(g, xs[i]) for g, i in zip(got, src))
