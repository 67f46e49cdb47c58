"""The split paged decode attention on the CPU: the plain version of the
CUDA kernel's algorithm (per-split (m, l, acc), then the combine;
``sparse_decode_attention.paged_decode_attention_split``) against the JAX
package's ``paged_decode_attention`` (Pallas in interpret mode) and the
port's ``ref.paged_decode_attention``, on the same numpy inputs; the split
plan; and why the kernel does not merge per-split (out, lse) pairs.

Tolerance: 1e-5 (fp32 on both sides, bf16 inputs cast exactly to fp32;
only the order of the sums differs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sparse_decode_attention as sda  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-5
N_SEL = 7


def _inputs(ps, G, dtype, seed=0):
    """Four slots of KV 2, dh 16, 16 pages of ``ps`` tokens, 7 selected:
    slot 0 a -1 hole and a length cut mid-page; slot 1 every selected page
    at or past its length (all masked); slot 2 length 0; slot 3 pages 3-5
    all -1 (a whole split of holes at 3 pages a split)."""
    rng = np.random.default_rng(seed)
    B, KV, dh, n_pages = 4, 2, 16, 16
    S = n_pages * ps
    q = rng.standard_normal((B, KV * G, dh)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    pages = np.stack([rng.choice(n_pages, N_SEL, replace=False)
                      for _ in range(B)]).astype(np.int32)
    pages[0, 1] = -1
    pages[1] = rng.choice(np.arange(2, n_pages), N_SEL, replace=False)
    pages[3, 3:6] = -1
    length = np.array([S - ps // 2 - 1 if ps > 1 else S - 1, 2 * ps, 0, S],
                      np.int32)
    if dtype == "bfloat16":   # round once, so both sides read equal values
        q, kc, vc = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                     for a in (q, kc, vc))
    return q, kc, vc, pages, length


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


_JAX = {}


def _jax_out(ps, G, dtype):
    """JAX paged_decode_attention (Pallas, interpret mode), once per case."""
    key = (ps, G, dtype)
    if key not in _JAX:
        q, kc, vc, pages, length = _inputs(ps, G, dtype)
        jd = getattr(jnp, dtype)
        jo, jl = jops.paged_decode_attention(
            jnp.asarray(q, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd),
            jnp.asarray(pages), jnp.asarray(length), page_size=ps)
        _JAX[key] = (np.asarray(jo, np.float32), np.asarray(jl, np.float32))
    return _JAX[key]


@pytest.mark.parametrize("pps", [3, 2, N_SEL])     # ragged / ragged / one
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("ps", [4, 16, 64, 128])
def test_split_combine_matches_jax_and_ref(ps, G, dtype, pps):
    q, kc, vc, pages, length = _inputs(ps, G, dtype)
    args = [_torch(a, dtype) for a in (q, kc, vc)] + [
        torch.from_numpy(pages), torch.from_numpy(length)]
    out, lse = sda.paged_decode_attention_split(
        *args, page_size=ps, pages_per_split=pps)
    assert out.dtype == lse.dtype == torch.float32
    jo, jl = _jax_out(ps, G, dtype)
    ro, rl = tref.paged_decode_attention(*args[:4], ps, args[4])
    for want_o, want_l in ((jo, jl), (ro.numpy(), rl.numpy())):
        np.testing.assert_allclose(out.numpy(), want_o, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lse.numpy(), want_l, rtol=TOL, atol=TOL)
    # slots 1 and 2 have no valid token: the mean of v over every token
    # the selection loaded (page 0 for a -1 hole, none here)
    KV, dh = kc.shape[2], kc.shape[3]
    for b in (1, 2):
        rows = (pages[b][:, None] * ps + np.arange(ps)).reshape(-1)
        want = vc[b, rows].mean(0)                         # [KV, dh]
        np.testing.assert_allclose(out.numpy()[b].reshape(KV, G, dh),
                                   np.repeat(want[:, None], G, 1), atol=TOL)


def test_lse_merge_of_splits_misses_the_all_masked_mean():
    """Why the kernel folds (m, l, acc): a slot whose pages all lie past
    its length, in splits of 3 and 2 pages. Every split's lse rounds to
    -1e30, so merging the splits' (out, lse) pairs weights their means
    equally; the (m, l, acc) combine keeps the counts and gives the
    reference's mean over all loaded tokens."""
    rng = np.random.default_rng(3)
    ps, KV, G, dh = 8, 1, 2, 16
    q = torch.from_numpy(rng.standard_normal((1, KV * G, dh), np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((1, 128, KV, dh),
                                                   np.float32))
              for _ in range(2))
    pages = torch.tensor([[5, 6, 7, 8, 9]], dtype=torch.int32)
    length = torch.tensor([16], dtype=torch.int32)
    ro, _ = tref.paged_decode_attention(q, kc, vc, pages, ps, length)
    m, l, acc = sda.split_partials(q, kc, vc, pages, length, page_size=ps,
                                   pages_per_split=3)
    out, _ = sda.combine_partials(m, l, acc)
    merged, _ = sda.lse_merge(acc / l[..., None], m + torch.log(l))
    np.testing.assert_allclose(out.numpy(), ro.numpy(), atol=TOL)
    assert float((merged - ro).abs().max()) > 100 * TOL


@pytest.mark.parametrize("B,KV,G,n_sel,ps,want", [
    (4, 8, 4, 128, 16, (16, 8)),     # DSA on llama3.2-1b: 256 CTAs
    (4, 8, 4, 64, 64, (4, 16)),      # Seer / LServe: 512 CTAs
    (1, 8, 4, 128, 16, (7, 19)),     # one slot: 152 CTAs, the last 2 pages
    (4, 8, 4, 100, 16, (14, 8)),     # a ragged last split of 2 pages
    (3, 8, 4, 9, 16, (1, 9)),
    (3, 8, 4, 3, 128, (1, 3)),
    (2, 2, 8, 5, 16, (1, 5)),        # G 8: two head groups a kv head
    (1, 1, 1, 1, 4, (1, 1)),
])
def test_split_plan(B, KV, G, n_sel, ps, want):
    pps, n_split = sda.split_plan(B, KV, G, n_sel, ps, n_sm=132)
    assert (pps, n_split) == want
    # every page in exactly one split, every split non-empty
    assert (n_split - 1) * pps < n_sel <= n_split * pps
    ctas = B * KV * -(-G // sda.HEADS_PER_CTA) * n_split
    assert ctas >= 132 or n_split == n_sel


@pytest.mark.parametrize("dh,itemsize,ok", [
    (64, 2, True), (32, 2, True), (128, 4, True), (256, 2, True),
    (256, 4, False), (12, 2, False), (6, 4, False)])
def test_row_chunks_rule(dh, itemsize, ok):
    assert sda._row_chunks_ok(dh, itemsize) == ok


def test_aligned16_copies_only_a_misaligned_base():
    x = torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)
    a = x[:256].view(4, 64)
    assert sda._aligned16(a).data_ptr() == a.data_ptr()
    b = x[1:].view(4, 64)                       # base 2 bytes off
    c = sda._aligned16(b)
    assert c.data_ptr() % 16 == 0 and torch.equal(c, b)


def test_cpu_wrapper_runs_the_plain_version():
    q, kc, vc, pages, length = _inputs(16, 4, "float32")
    args = [torch.from_numpy(a) for a in (q, kc, vc, pages, length)]
    n0 = sda.paged_decode_attention.launches
    out, lse = sda.paged_decode_attention(*args, page_size=16)
    ro, rl = tref.paged_decode_attention(*args[:4], 16, args[4])
    assert sda.paged_decode_attention.launches == n0
    assert torch.equal(out, ro) and torch.equal(lse, rl)
