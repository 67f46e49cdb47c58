"""The port's causal attention on the CPU against the JAX package's, on the
same numpy inputs: the flash kernel's plain version (``ref`` and the
CPU route of the kernel's wrapper) against JAX ``ref.flash_attention`` and
the Pallas kernel in interpret mode (``ops.flash_attention``), and the
model's ``attention_full`` (plain, and through ``FlashAttention`` as the
card runs it) with its gradient against ``jax.grad`` of the reference's;
a model of the bf16 tensor-core route's numerics (tile-wise online softmax,
P split into bf16 high and low parts) against the Pallas kernel and JAX's
oracle within one bf16 ulp (``chip_smoke.py``'s ``BF16_ULP``); and the
wrapper's routing and alignment rules.

Tolerances: the kernel shapes as ``tests/test_kernels.py`` holds the Pallas
kernel to its oracle (2e-5 fp32, 6e-2 bf16: bf16 outputs differ by a
rounding step); ``attention_full`` and its gradients within 1e-5 (fp32 on
both sides, different summation order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-5


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("B,S,H,KV,dh,bq,window", [
    (1, 128, 4, 4, 32, 64, 0),
    (2, 200, 8, 2, 64, 64, 0),      # GQA + ragged block
    (2, 256, 4, 4, 32, 64, 48),     # sliding window (Mixtral)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(B, S, H, KV, dh, bq, window, dtype):
    q, k, v = _np((B, S, H, dh), 1), _np((B, S, KV, dh), 2), \
        _np((B, S, KV, dh), 3)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    want_ref = jref.flash_attention(jq, jk, jv, window=window or None)
    want_kernel = jops.flash_attention(jq, jk, jv, bq=bq, bk=bq,
                                       window=window)
    got_ref = tref.flash_attention(tq, tk, tv, window=window or None)
    got_op = tops.flash_attention(tq, tk, tv, window=window, bq=bq, bk=bq)
    got_wrapper = tfa.flash_attention(tq, tk, tv, window=window)
    tol = 2e-5 if dtype == "float32" else 6e-2
    for got in (got_ref, got_op, got_wrapper):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        for want in (want_ref, want_kernel):
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                       atol=tol)
    assert tfa.flash_attention.launches == 0     # the CPU runs no kernel


def _cfgs(tp, gather):
    """Smoke llama at fp32; ``gather``: 3 kv heads under 8 padded query
    heads, so expand_kv gathers (Hp % KV != 0) instead of repeating."""
    kw = dict(dtype="float32")
    if gather:
        kw.update(n_heads=6, n_kv_heads=3)
    return (jget_arch("llama3.2-1b").smoke().replace(**kw),
            get_arch("llama3.2-1b").smoke().replace(**kw))


@pytest.mark.parametrize("tp,gather", [(4, False), (16, False), (4, True)])
@pytest.mark.parametrize("window", [None, 24])
def test_attention_full_and_grad_match_jax(tp, gather, window):
    jcfg, tcfg = _cfgs(tp, gather)
    hp, kv, hd = tcfg.padded_heads(tp), tcfg.n_kv_heads, tcfg.hd
    assert (hp % kv != 0) == gather
    B, S = 2, 72
    q, k, v = _np((B, S, hp, hd), 4), _np((B, S, kv, hd), 5), \
        _np((B, S, kv, hd), 6)
    w = _np((B, S, hp, hd), 7)          # a random cotangent

    def jloss(q, k, v):
        return jnp.sum(JA.attention_full(q, k, v, jcfg, window=window, tp=tp)
                       * w)

    jout = JA.attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jcfg, window=window, tp=tp)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for fn in (TA.attention_full, TA.attention_full_flash):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = fn(tq, tk, tv, tcfg, window=window, tp=tp)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=TOL, atol=TOL)
        (out * torch.from_numpy(w)).sum().backward()
        for t, jg in zip((tq, tk, tv), jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                       rtol=1e-4, atol=TOL)


def test_flash_backward_is_plain_autograd():
    """``FlashAttention``'s recomputed backward equals autograd through the
    plain oracle, with a window and GQA (fp32)."""
    q, k, v = _np((2, 80, 8, 32), 8), _np((2, 80, 2, 32), 9), \
        _np((2, 80, 2, 32), 10)
    g = torch.from_numpy(_np((2, 80, 8, 32), 11))
    grads = []
    for fn in (lambda *a: tfa.FlashAttention.apply(*a, 16),
               lambda *a: tref.flash_attention(*a, window=16)):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        fn(*ts).backward(g)
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=TOL)


# ---------------------------------------------------------------------------
# the tensor-core route (csrc/flash_attention_sm90.cu): a model of its
# numerics, and the routing and alignment rules of the wrapper
# ---------------------------------------------------------------------------

BF16_ULP = (2.0 ** -7, 2.0 ** -8)   # chip_smoke.py's bf16 (rtol, atol)


def _tensor_core_model(q, k, v, window=0, bn=64):
    """The bf16 tensor-core kernel's arithmetic in torch: per tile of ``bn``
    keys, S = (q . k^T in fp32) * 1/sqrt(dh), masked to -1e30 (causal,
    window, key >= S); an fp32 online softmax (m, l, acc); P split into a
    bf16 high part and a bf16 low part, both multiplied by V into the fp32
    accumulator; out = acc / max(l, 1e-30) rounded to bf16."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    qf = q.float()
    kf = k.repeat_interleave(G, dim=2).float()
    vf = v.repeat_interleave(G, dim=2).float()
    pos = torch.arange(S)
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, dh)
    for k0 in range(0, S, bn):
        kp = pos[k0:k0 + bn]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k0 + bn]) \
            / np.sqrt(dh)
        ok = kp[None] <= pos[:, None]
        if window:
            ok &= pos[:, None] - kp[None] < window
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vt = vf[:, k0:k0 + bn]
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", hi, vt) \
            + torch.einsum("bhqk,bkhd->bhqd", lo, vt)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).bfloat16()


@pytest.mark.parametrize("S,window", [(200, 0), (200, 48), (37, 0),
                                      (130, 100)])
@pytest.mark.parametrize("dh", [64, 128])
def test_tensor_core_numerics_match_jax(S, window, dh):
    """The model against the Pallas kernel (interpret mode) and JAX's
    ``ref.flash_attention`` at bf16, within one bf16 ulp (chip_smoke.py's
    BF16_ULP): ragged S, S below a tile, windows below and above it, GQA."""
    B, H, KV = 1, 4, 2
    q, k, v = (np.asarray(jnp.asarray(_np((B, S, n, dh), seed),
                                      jnp.bfloat16), np.float32)
               for n, seed in ((H, 20), (KV, 21), (KV, 22)))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = _tensor_core_model(*(torch.from_numpy(np.ascontiguousarray(a))
                               .bfloat16() for a in (q, k, v)), window)
    rtol, atol = BF16_ULP
    for want in (jref.flash_attention(jq, jk, jv, window=window or None),
                 jops.flash_attention(jq, jk, jv, bq=64, bk=64,
                                      window=window)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol)


def test_tensor_core_model_is_fp32_accurate():
    """P split into two bf16 parts keeps P.V within 1e-4 of fp32 (before
    the output's bf16 rounding), where P in bf16 alone does not."""
    q, k, v = (torch.from_numpy(_np((1, 256, n, 64), seed)).bfloat16()
               for n, seed in ((4, 30), (2, 31), (2, 32)))
    want = tref.flash_attention(q.float(), k.float(), v.float())
    G = 2
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.repeat_interleave(G, 2).float()) / 8.0
    s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool).tril(), -1e30)
    p = torch.softmax(s, -1)
    vf = v.repeat_interleave(G, 2).float()
    hi = p.bfloat16().float()
    two = torch.einsum("bhqk,bkhd->bqhd", hi, vf) + torch.einsum(
        "bhqk,bkhd->bqhd", (p - hi).bfloat16().float(), vf)
    one = torch.einsum("bhqk,bkhd->bqhd", hi, vf)
    assert float((two - want).abs().max()) < 1e-4
    assert float((one - want).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 64, tfa.TENSOR_CORES),
    (torch.bfloat16, 128, tfa.TENSOR_CORES),
    (torch.bfloat16, 112, tfa.TENSOR_CORES),
    (torch.bfloat16, 32, tfa.CUDA_CORES),
    (torch.float32, 112, tfa.CUDA_CORES),
    (torch.float32, 64, tfa.CUDA_CORES),
    (torch.float32, 128, tfa.CUDA_CORES),
    (torch.float16, 64, tfa.CUDA_CORES),
])
def test_route_by_dtype_and_head_dim(dtype, dh, route):
    assert tfa._route(dtype, dh) == route


@pytest.mark.parametrize("offset,seq_stride,tc_ok,cc_ok", [
    (0, 64 * 13, True, True),     # q of a packed [B, S, 13 heads, 64] view
    (64, 64 * 13, True, True),    # k: a head in, 128 bytes
    (112, 112 * 13, True, True),  # dh 112: a head in, 224 bytes
    (4, 64 * 13, False, True),    # base 8 bytes off: no TMA
    (0, 68, False, True),         # a seq stride of 136 bytes: no TMA
    (2, 64 * 13, False, False),   # base 4 bytes off: neither
])
def test_alignment_rules(offset, seq_stride, tc_ok, cc_ok):
    """Which inputs each route reads in place (bf16): TMA wants a 16-byte
    base and 16-byte strides, the CUDA-core kernel 4 elements; a view the
    route cannot read is copied to a contiguous tensor."""
    buf = torch.zeros(2 * 40 * seq_stride + 4096, dtype=torch.bfloat16)
    x = buf[offset:offset + 2 * 40 * seq_stride].as_strided(
        (2, 40, 1, 64), (40 * seq_stride, seq_stride, 64, 1))
    for route, ok in ((tfa.TENSOR_CORES, tc_ok), (tfa.CUDA_CORES, cc_ok)):
        assert tfa._readable(x.stride(), x.data_ptr(), 2, route) == ok
        y = tfa._aligned(x, route)
        assert (y.data_ptr() == x.data_ptr()) == ok and torch.equal(y, x)
        assert tfa._readable(y.stride(), y.data_ptr(), 2, route)
