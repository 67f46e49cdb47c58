"""The port's test-time training layer (``repro_torch.core.methods.ttt``)
on the CPU against the JAX package's, from JAX-initialized weights
(``from_jax_params``) on the same numpy inputs.

xlstm-125m ``.smoke()`` (d 128), fast_dim 32, B 2, S 128. ``ttt_forward``'s
output and final fast weights within 1e-5 (fp32 on both sides, different
summation order; a bf16 input's output within one bf16 rounding step),
each ``build_pipeline`` stage called directly likewise; the chunk rule
(``S % chunk`` raises, a chunk past S is clamped) and ``run``'s failure are
the reference's: ``run`` hands relevancy's scalar loss to apply as the
fast weights (ROADMAP Queue 3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.methods import ttt as jttt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import methods as tmethods  # noqa: E402
from repro_torch.core.methods import ttt  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-5
F, B, S = 32, 2, 128


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_arch("xlstm-125m").smoke()
    tcfg = get_arch("xlstm-125m").smoke()
    jp = jttt.ttt_init(jax.random.PRNGKey(0), jcfg, fast_dim=F)
    tp_ = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp_, x


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("chunk", [32, 64, 256])
@pytest.mark.parametrize("w0", ["zeros", "random"])
def test_ttt_forward_matches_jax(setup, chunk, w0):
    """256 > S runs as one chunk of S on both sides."""
    jcfg, tcfg, jp, tp_, x = setup
    W0 = np.zeros((B, F, F), np.float32) if w0 == "zeros" else \
        0.1 * np.random.default_rng(2).standard_normal((B, F, F)).astype(
            np.float32)
    jy, jW = jttt.ttt_forward(jp, jnp.asarray(x), jnp.asarray(W0),
                              chunk=chunk)
    ty, tW = ttt.ttt_forward(tp_, torch.from_numpy(x), torch.from_numpy(W0),
                             chunk=chunk)
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    _close(ty, jy)
    _close(tW, jW)


def test_ttt_forward_bf16_input_matches_jax(setup):
    jcfg, tcfg, jp, tp_, x = setup
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = from_jax_params({"x": np.asarray(jx)}, "cpu")["x"]
    W0 = np.zeros((B, F, F), np.float32)
    jy, jW = jttt.ttt_forward(jp, jx, jnp.asarray(W0), chunk=32)
    ty, tW = ttt.ttt_forward(tp_, tx, torch.from_numpy(W0), chunk=32)
    assert ty.dtype == torch.bfloat16
    _close(tW, jW)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), rtol=2.0 ** -7,
                               atol=2.0 ** -8)


def test_chunk_not_dividing_s_raises_on_both_sides(setup):
    jcfg, tcfg, jp, tp_, x = setup
    W0 = np.zeros((B, F, F), np.float32)
    with pytest.raises(AssertionError):
        jttt.ttt_forward(jp, jnp.asarray(x), jnp.asarray(W0), chunk=48)
    with pytest.raises(ValueError):
        ttt.ttt_forward(tp_, torch.from_numpy(x), torch.from_numpy(W0),
                        chunk=48)


def test_ttt_reduces_reconstruction_loss():
    """Port of ``tests/test_methods.py::test_ttt_reduces_reconstruction_
    loss``: the fast-weight update must reduce the reconstruction loss
    within a sequence (that is what test-time training is), from the
    port's own seeded init."""
    cfg = get_arch("xlstm-125m").smoke()
    p = ttt.ttt_init(cfg, 0, fast_dim=F, device="cpu")
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    W0 = ttt.fast_state_init(cfg, B, fast_dim=F, device="cpu")
    _, W1 = ttt.ttt_forward(p, x, W0, chunk=32)
    k = torch.nn.functional.silu(x.float() @ p["wk"])
    v = x.float() @ p["wv"]
    loss0 = float(((torch.einsum("bsf,bfg->bsg", k, W0) - v) ** 2).mean())
    loss1 = float(((torch.einsum("bsf,bfg->bsg", k, W1) - v) ** 2).mean())
    assert loss1 < loss0


def test_init_matches_reference_layout(setup):
    jcfg, tcfg, jp, _, _ = setup
    p = ttt.ttt_init(tcfg, 3, fast_dim=F, device="cpu")
    assert sorted(p) == sorted(jp)
    for k in p:
        assert tuple(p[k].shape) == tuple(jp[k].shape)
        assert p[k].dtype == torch.float32
    assert float(p["lr"]) == pytest.approx(float(jp["lr"]))
    again = ttt.ttt_init(tcfg, 3, fast_dim=F, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert ttt.ttt_init(tcfg, 3, device="cpu")["wq"].shape == (
        tcfg.d_model, tcfg.d_model)
    W = ttt.fast_state_init(tcfg, B, fast_dim=F, device="cpu")
    np.testing.assert_array_equal(W.numpy(), np.asarray(
        jttt.fast_state_init(jcfg, B, fast_dim=F)))
    assert tmethods.module("ttt") is ttt
    assert tmethods.offload_stages("ttt") == ttt.OFFLOAD_STAGES == ()


def _stage_inputs(seed=3, c=32):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return 0.1 * n(B, F, F), n(B, c, F), n(B, c, F), n(B, c, F)


@pytest.mark.parametrize("stage", ["prepare", "relevancy", "apply"])
def test_pipeline_stages_match_jax(setup, stage):
    _, _, jp, tp_, _ = setup
    W, qc, kc, vc = _stage_inputs()
    jpipe, tpipe = jttt.build_pipeline(jp), ttt.build_pipeline(tp_)
    J = lambda *a: tuple(jnp.asarray(x) for x in a)
    T = lambda *a: tuple(torch.from_numpy(x) for x in a)
    if stage == "prepare":
        want, got = jpipe.prepare(J(W, kc, vc)), tpipe.prepare(T(W, kc, vc))
    elif stage == "relevancy":
        want = jpipe.relevancy(jnp.asarray(W), J(kc, vc))
        got = tpipe.relevancy(torch.from_numpy(W), T(kc, vc))
        assert got.dim() == 0
    else:
        want = jpipe.apply(jnp.asarray(W), jnp.asarray(qc))
        got = tpipe.apply(torch.from_numpy(W), torch.from_numpy(qc))
        _close(tpipe.apply(T(W, kc), T(qc, kc)), want)
    _close(got, want)
    assert [s for s, _, _ in tpipe.stages()] == \
        [s for s, _, _ in jpipe.stages()] == ["prepare", "relevancy",
                                              "apply"]


def test_pipeline_stages_compose_to_ttt_forward(setup):
    """relevancy, prepare, apply over the chunks in order reproduce
    ``ttt_forward``'s y (before ``out``) and W'."""
    _, tcfg, _, tp_, x = setup
    xf = torch.from_numpy(x)
    silu = torch.nn.functional.silu
    q, k, v = (silu(xf @ tp_["wq"]), silu(xf @ tp_["wk"]), xf @ tp_["wv"])
    pipe = ttt.build_pipeline(tp_)
    W = torch.zeros(B, F, F)
    ys = []
    for c in range(0, S, 32):
        qc, kc, vc = q[:, c:c + 32], k[:, c:c + 32], v[:, c:c + 32]
        assert pipe.relevancy(W, (kc, vc)) >= 0
        W = pipe.prepare((W, kc, vc))
        ys.append(pipe.apply(W, qc))
    y, W1 = ttt.ttt_forward(tp_, xf, torch.zeros(B, F, F), chunk=32)
    torch.testing.assert_close(torch.cat(ys, 1) @ tp_["out"], y, rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(W, W1, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("query", ["kv", "q"])
def test_run_raises_as_the_reference_does(setup, query):
    """``run`` passes relevancy's scalar loss on as apply's fast weights:
    the reference's einsum raises ValueError, the port's RuntimeError, with
    x = (kc, vc) and with x = qc."""
    _, _, jp, tp_, _ = setup
    W, qc, kc, vc = _stage_inputs()
    jx = (jnp.asarray(kc), jnp.asarray(vc)) if query == "kv" else \
        jnp.asarray(qc)
    tx = (torch.from_numpy(kc), torch.from_numpy(vc)) if query == "kv" else \
        torch.from_numpy(qc)
    jM = tuple(jnp.asarray(a) for a in (W, kc, vc))
    tM = tuple(torch.from_numpy(a) for a in (W, kc, vc))
    with pytest.raises(ValueError):
        jttt.build_pipeline(jp).run(jM, jx)
    with pytest.raises(RuntimeError):
        ttt.build_pipeline(tp_).run(tM, tx)


def test_reference_lr_diverges_at_full_width():
    """At llama3.2-1b's width (d 2048, fast_dim 2048) the reference's fixed
    lr 0.1 makes each chunk's step unstable (lr x the largest eigenvalue of
    k^T k / chunk above 2): the reconstruction loss grows in both packages,
    and the port's W' follows JAX's (2 chunks of 256, B 1)."""
    jcfg, tcfg = jget_arch("llama3.2-1b"), get_arch("llama3.2-1b")
    jp = jttt.ttt_init(jax.random.PRNGKey(0), jcfg)
    tp_ = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(4).standard_normal(
        (1, 512, jcfg.d_model)).astype(np.float32)
    W0 = np.zeros((1, jcfg.d_model, jcfg.d_model), np.float32)
    _, jW = jttt.ttt_forward(jp, jnp.asarray(x), jnp.asarray(W0), chunk=256)
    _, tW = ttt.ttt_forward(tp_, torch.from_numpy(x), torch.from_numpy(W0),
                            chunk=256)
    scale = float(np.abs(np.asarray(jW)).max())
    assert float(np.abs(tW.numpy() - np.asarray(jW)).max()) <= 1e-4 * scale
    xf = torch.from_numpy(x)
    k = torch.nn.functional.silu(xf @ tp_["wk"])
    v = xf @ tp_["wv"]
    loss = lambda W: float(((torch.bmm(k, W) - v) ** 2).mean())
    assert loss(tW) > loss(torch.from_numpy(W0))
    assert loss(torch.from_numpy(np.asarray(jW))) > loss(
        torch.from_numpy(W0))
    kc = k[0, :256]
    assert float(tp_["lr"]) * float(torch.linalg.eigvalsh(
        kc.T @ kc / 256).max()) > 2
