"""The port's model on the CPU against the JAX package's, from the same
JAX-initialized weights (carried over by ``weights.from_jax_params``) on the
same inputs: the layers, bucketed prefill, chunked extend, and paged decode
dense and through DSA's sparse_fn, plus DSA's selected pages per layer.

Smoke config at dtype float32 with tp=16 (4 live query heads padded to 16).
Tolerances: logits and activations within 1e-4 (fp32 on both sides,
different summation order); page ids and bf16 bits exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.methods import dsa as jdsa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.page_pool import pool_gather as jgather  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.methods import dsa as tdsa  # noqa: E402
from repro_torch.kernels.page_pool import pool_gather as tgather  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4
TP = 16
PAGE = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_arch("llama3.2-1b").smoke().replace(dtype="float32")
    tcfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    jsp = jdsa.dsa_init(jax.random.PRNGKey(1), jcfg, jcfg.memory)
    tparams = from_jax_params(_np_tree(jparams), device="cpu")
    tsp = from_jax_params(_np_tree(jsp), device="cpu")
    return jcfg, tcfg, jparams, jsp, tparams, tsp


def test_from_jax_params_carries_bf16_bits():
    """bf16 leaves bit-exact, stacked shapes and dead-head zeros kept."""
    cfg = jget_arch("llama3.2-1b").smoke()                  # bf16 weights
    jp = _np_tree(JM.init_params(cfg, jax.random.PRNGKey(3), tp=TP))
    tp_ = from_jax_params(jp, device="cpu")
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(tp_)):
        assert tuple(b.shape) == a.shape, path
        if a.dtype.name == "bfloat16":
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    wq = tp_["layers"]["attn"]["wq"].float().reshape(cfg.n_layers,
                                                     cfg.d_model, -1, cfg.hd)
    assert wq.shape[2] == cfg.padded_heads(TP)
    assert not wq[:, :, cfg.n_heads:].any()


@pytest.mark.parametrize("fn", ["rms_norm", "rope", "mlp", "embed",
                                "lm_head"])
def test_layers_match_jax(setup, fn):
    jcfg, tcfg, jparams, _, tparams, _ = setup
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[0], jparams["layers"])
    lp_t = TM.layer(tparams["layers"], 0)
    if fn == "rms_norm":
        want = JL.rms_norm(lp_j["attn_norm"], jnp.asarray(x), 1e-5)
        got = TL.rms_norm(lp_t["attn_norm"], _t(x), 1e-5)
    elif fn == "rope":
        pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
        xr = rng.standard_normal((2, 5, 3, jcfg.hd)).astype(np.float32)
        jc, js = JL.rope_cos_sin(jnp.asarray(pos), jcfg.hd, jcfg.rope_theta)
        tc, ts = TL.rope_cos_sin(_t(pos), jcfg.hd, jcfg.rope_theta)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=TOL)
        want = JL.apply_rope(jnp.asarray(xr), jc, js)
        got = TL.apply_rope(_t(xr), tc, ts)
    elif fn == "mlp":
        want = JL.mlp(lp_j["mlp"], jnp.asarray(x))
        got = TL.mlp(lp_t["mlp"], _t(x))
    elif fn == "embed":
        toks = rng.integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
        want = JL.embed(jparams["embed"], jnp.asarray(toks))
        got = TL.embed(tparams["embed"], _t(toks))
    else:                               # vocab 500 pads to 512: masked rows
        jc2, tc2 = jcfg.replace(vocab_size=500), tcfg.replace(vocab_size=500)
        want = JL.lm_head(jparams["lm_head"], jnp.asarray(x), jc2)
        got = TL.lm_head(tparams["lm_head"], _t(x), tc2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _pools(jcfg, tcfg, B, max_len, ps):
    NP = max_len // ps
    table = np.arange(1, B * NP + 1, dtype=np.int32).reshape(B, NP)
    jpool = JM.make_page_pool(jcfg, B, max_len, page_size=ps,
                              total_pages=B * NP + 1, tp=TP)
    tpool = TM.make_page_pool(tcfg, B, max_len, page_size=ps,
                              total_pages=B * NP + 1, tp=TP, device="cpu")
    jpool["page_table"] = jnp.asarray(table)
    tpool["page_table"] = _t(table)
    return jpool, tpool, table


def _splice(jpool, tpool, table, jk, jv, tk, tv, ps):
    """Write bucketed-prefill k/v [L,B,Sb,KV,hd] into each side's pool."""
    L_, B, Sb = jk.shape[:3]
    n = Sb // ps
    dest = table[:, :n].reshape(-1)
    jpool["k_pages"] = jpool["k_pages"].at[:, dest].set(
        jk.reshape(L_, B * n, ps, *jk.shape[3:]))
    jpool["v_pages"] = jpool["v_pages"].at[:, dest].set(
        jv.reshape(L_, B * n, ps, *jv.shape[3:]))
    tpool["k_pages"][:, _t(dest).long()] = tk.reshape(L_, B * n, ps,
                                                      *tk.shape[3:])
    tpool["v_pages"][:, _t(dest).long()] = tv.reshape(L_, B * n, ps,
                                                      *tv.shape[3:])


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def served(setup):
    """Prefill (bucketed) -> splice -> chunked extend on both sides; returns
    the two pools and the state after each stage, compared in the tests."""
    jcfg, tcfg, jparams, _, tparams, _ = setup
    B, max_len, ps = 3, 64, 16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, 16)).astype(np.int32)
    lens = np.array([16, 9, 5], np.int32)
    jl, jk, jv = JM.prefill_bucketed(jparams, jcfg, jnp.asarray(toks),
                                     jnp.asarray(lens), tp=TP)
    tl, tk, tv = TM.prefill_bucketed(tparams, tcfg, _t(toks), _t(lens), tp=TP)
    jpool, tpool, table = _pools(jcfg, tcfg, B, max_len, ps)
    _splice(jpool, tpool, table, jk, jv, tk, tv, ps)
    out = {"prefill": (tl, jl, tk, jk)}
    # chunked extend: slot 1 is not prefilling (n_valid 0, length masked)
    C = 8
    ext = rng.integers(0, jcfg.vocab_size, (B, C)).astype(np.int32)
    n_valid = np.array([8, 0, 3], np.int32)
    starts = np.array([16, 0, 5], np.int32)
    jpool["lengths"] = jnp.asarray(starts)
    tpool["lengths"] = _t(starts)
    jl, jpool = JM.extend_paged(jparams, jcfg, jnp.asarray(ext), jpool,
                                jnp.asarray(n_valid), tp=TP)
    tl, tpool = TM.extend_paged(tparams, tcfg, _t(ext), tpool, _t(n_valid),
                                tp=TP)
    out["extend"] = (tl, jl, n_valid)
    lengths = np.array([24, 9, 8], np.int32)
    jpool["lengths"] = jnp.asarray(lengths)
    tpool["lengths"] = _t(lengths)
    return jpool, tpool, out


def test_prefill_bucketed_matches_jax(served):
    _, _, out = served
    tl, jl, tk, jk = out["prefill"]
    _close(tl, jl)
    _close(tk, jk)


def test_extend_paged_matches_jax(served):
    jpool, tpool, out = served
    tl, jl, n_valid = out["extend"]
    rows = n_valid > 0
    _close(tl[rows], np.asarray(jl)[rows])
    _close(tpool["k_pages"], jpool["k_pages"])
    _close(tpool["v_pages"], jpool["v_pages"])
    assert not tpool["k_pages"][:, 0].any()      # zero page stays zero


@pytest.mark.parametrize("sparse", [False, True])
def test_decode_step_paged_matches_jax(setup, served, sparse):
    jcfg, tcfg, jparams, jsp, tparams, tsp = setup
    jpool, tpool, _ = served
    B = 3
    tok = np.array([3, 100, 7], np.int32)
    live = np.array([True, True, True])
    jkw = tkw = {}
    if sparse:
        jkw = dict(sparse_fn=jdsa.make_sparse_fn(jcfg, jcfg.memory, tp=TP,
                                                 page=PAGE),
                   sparse_params=jsp)
        tkw = dict(sparse_fn=tdsa.make_sparse_fn(tcfg, tcfg.memory, tp=TP,
                                                 page=PAGE),
                   sparse_params=tsp)
    tpool_c = {k: v.clone() for k, v in tpool.items()}   # decode is in place
    jl, jpool2 = JM.decode_step_paged(jparams, jcfg, jnp.asarray(tok), jpool,
                                      jnp.asarray(live), tp=TP, **jkw)
    tl, tpool2 = TM.decode_step_paged(tparams, tcfg, _t(tok), tpool_c,
                                      _t(live), tp=TP, **tkw)
    assert tl.shape == (B, jcfg.padded_vocab)
    _close(tl, jl)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))
    _close(tpool2["k_pages"], jpool2["k_pages"])
    np.testing.assert_array_equal(tpool2["lengths"].numpy(),
                                  np.asarray(jpool2["lengths"]))


def _jax_select(sp, q, kc, lb, mem):
    """The reference's selection (repro/core/methods/dsa.py:101-112)."""
    B, S = q.shape[0], kc.shape[1]
    n_sel = max(mem.top_k // PAGE, 1)
    q_idx, k_idx, w = jdsa._index_qkw(sp, q[:, 0], kc, mem)
    kp = k_idx.reshape(B, S // PAGE, PAGE, -1).mean(axis=2)
    _, pidx = jops.relevancy_topk(q_idx, kp, w, n_sel,
                                  block=max(min(4096, S // PAGE), n_sel))
    return jnp.where(pidx * PAGE < lb[:, None], pidx, -1)


def test_dsa_selected_pages_match_jax_per_layer(setup, served):
    """Every layer's indexer picks the same page ids on both sides, over
    the pool view the decode step reads (including -1 past short slots)."""
    jcfg, tcfg, _, jsp, _, tsp = setup
    jpool, tpool, _ = served
    rng = np.random.default_rng(2)
    lb = np.array([25, 10, 9], np.int32)
    for layer in range(jcfg.n_layers):
        q = rng.standard_normal((3, 1, jcfg.padded_heads(TP),
                                 jcfg.hd)).astype(np.float32)
        q[:, :, jcfg.n_heads:] = 0
        jkc = jgather(jpool["k_pages"][layer], jpool["page_table"])
        tkc = tgather(tpool["k_pages"][layer], tpool["page_table"])
        jsp_l = jax.tree.map(lambda a: a[layer], jsp)
        tsp_l = TM.layer(tsp, layer)
        want = _jax_select(jsp_l, jnp.asarray(q), jkc, jnp.asarray(lb),
                           jcfg.memory)
        got = tdsa.select_pages(tsp_l, _t(q), tkc, _t(lb), tcfg.memory, PAGE)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy() == -1).any()          # short slots mask pages
