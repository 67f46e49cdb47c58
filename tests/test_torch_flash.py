"""The port's causal attention on the CPU against the JAX package's, on the
same numpy inputs: the flash kernel's plain version (``ref`` and the
CPU route of the kernel's wrapper) against JAX ``ref.flash_attention`` and
the Pallas kernel in interpret mode (``ops.flash_attention``), and the
model's ``attention_full`` (plain, and through ``FlashAttention`` as the
card runs it) with its gradient against ``jax.grad`` of the reference's.

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
