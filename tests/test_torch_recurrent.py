"""The port's recurrent blocks against the JAX package's, on the CPU: Mamba2
(``models/ssm.py``: the chunked SSD forward and the stepped decode, with a
carried state, head groups that do not divide the heads) and xLSTM
(``models/xlstm.py``: mLSTM and sLSTM, from their initial state and from a
carried one); the port's chunked forward equals its stepped decode; the
hybrid model with an empty tail (the smoke config: one Mamba2 layer and the
shared block) and with a one-layer tail, prefill and decode.

Smoke configs at dtype float32 (and bf16 for the states' dtypes).
Tolerances: outputs and states within 1e-4 (fp32 on both sides, different
summation order; 1e-3 where a chunked forward meets S stepped updates).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TOL = 1e-4
TP = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return from_jax_params(_np_tree(tree), "cpu")


def _close(t, j, tol=TOL):
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(j)),
                    jax.tree_util.tree_leaves(
                        jax.tree.map(lambda x: x.detach().float().numpy(),
                                     t, is_leaf=torch.is_tensor))):
        np.testing.assert_allclose(b, np.asarray(a, np.float32), rtol=tol,
                                   atol=tol)


def _cfgs(name, **kw):
    return (jget_arch(name).smoke().replace(dtype="float32", **kw),
            get_arch(name).smoke().replace(dtype="float32", **kw))


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


# 8 heads of 32 (one group); 20 heads of 16 (groups of 16 and 4)
MAMBA_CASES = {"8-heads": {}, "20-heads": dict(d_model=160,
                                               ssm_head_dim=16)}


@pytest.mark.parametrize("case", list(MAMBA_CASES))
def test_mamba_forward_and_decode_match_jax(case):
    jcfg, tcfg = _cfgs("zamba2-7b", **MAMBA_CASES[case])
    jp = JS.mamba_init(jax.random.PRNGKey(0), jcfg)
    tp = _t(jp)
    B, S = 2, 32                                   # two chunks of 16
    x = _x(jcfg, B, S, 0)
    jy, jst = JS.mamba_forward(jp, jnp.asarray(x), jcfg)
    ty, tst = TS.mamba_forward(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(tst, jst)
    # a carried state: the next 16 tokens chunked, then 3 stepped tokens
    x2 = _x(jcfg, B, 16, 1)
    jy2, jst2 = JS.mamba_forward(jp, jnp.asarray(x2), jcfg, jst)
    ty2, tst2 = TS.mamba_forward(tp, torch.from_numpy(x2), tcfg, tst)
    _close(ty2, jy2)
    _close(tst2, jst2)
    for i in range(3):
        xs = _x(jcfg, B, 1, 2 + i)
        jyd, jst2 = JS.mamba_decode(jp, jnp.asarray(xs), jcfg, jst2)
        tyd, tst2 = TS.mamba_decode(tp, torch.from_numpy(xs), tcfg, tst2)
        _close(tyd, jyd)
        _close(tst2, jst2)


def test_mamba_chunked_equals_stepped():
    _, tcfg = _cfgs("zamba2-7b")
    gen = torch.Generator().manual_seed(0)
    tp = TS.mamba_init(gen, tcfg)
    B, S = 2, 32
    x = torch.from_numpy(_x(tcfg, B, S, 4))
    y, st = TS.mamba_forward(tp, x, tcfg)
    state = TS.mamba_state_init(tcfg, B, device="cpu")
    ys = []
    for t in range(S):
        yt, state = TS.mamba_decode(tp, x[:, t:t + 1], tcfg, state)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(state[0].numpy(), st[0].numpy(), rtol=1e-3,
                               atol=1e-3)


def test_mamba_state_dtypes():
    """A bf16 forward keeps its conv states in bf16 and its SSM state in
    fp32; a step from fp32 zero states runs the conv in fp32."""
    cfg = get_arch("zamba2-7b").smoke()
    tp = TS.mamba_init(torch.Generator().manual_seed(1), cfg)
    x = torch.from_numpy(_x(cfg, 1, 16, 5)).bfloat16()
    _, (ssm, conv) = TS.mamba_forward(tp, x, cfg)
    assert ssm.dtype == torch.float32
    assert all(c.dtype == torch.bfloat16 for c in conv)
    _, (ssm, conv) = TS.mamba_decode(
        tp, x[:, :1], cfg, TS.mamba_state_init(cfg, 1, device="cpu"))
    assert all(c.dtype == torch.float32 for c in conv)


def test_mamba_rejects_ragged_chunks():
    _, tcfg = _cfgs("zamba2-7b")
    tp = TS.mamba_init(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="chunk"):
        TS.mamba_forward(tp, torch.zeros((1, 24, tcfg.d_model)), tcfg)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_blocks_match_jax(block):
    jcfg, tcfg = _cfgs("xlstm-125m")
    jinit, jfwd = getattr(JX, f"{block}_init"), getattr(JX, f"{block}_forward")
    tfwd = getattr(TX, f"{block}_forward")
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = _t(jp)
    B = 2
    x = _x(jcfg, B, 12, 0)
    jy, jst = jfwd(jp, jnp.asarray(x), jcfg)
    ty, tst = tfwd(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(tst, jst)
    # carried state: chunked (4 tokens) and stepped (one at a time)
    x2 = _x(jcfg, B, 4, 1)
    jy2, jst2 = jfwd(jp, jnp.asarray(x2), jcfg, jst)
    ty2, tst2 = tfwd(tp, torch.from_numpy(x2), tcfg, tst)
    _close(ty2, jy2)
    _close(tst2, jst2)
    st, ys = tst, []
    for t in range(4):
        yt, st = tfwd(tp, torch.from_numpy(x2[:, t:t + 1]), tcfg, st)
        ys.append(yt)
    _close(torch.cat(ys, 1), jy2)
    _close(st, jst2)


def test_xlstm_initial_states_match_jax():
    jcfg, tcfg = _cfgs("xlstm-125m")
    _close(TX.mlstm_state_init(tcfg, 2, device="cpu"),
           JX.mlstm_state_init(jcfg, 2))
    _close(TX.slstm_state_init(tcfg, 2, device="cpu"),
           JX.slstm_state_init(jcfg, 2))


@pytest.mark.parametrize("tail", [0, 1])
def test_hybrid_prefill_decode_match_jax(tail):
    """tail 0: the smoke config (n_layers 2, shared_attn_every 1: two super
    blocks, no tail); tail 1: n_layers 3, shared_attn_every 2."""
    kw = {} if tail == 0 else dict(n_layers=3, shared_attn_every=2)
    jcfg, tcfg = _cfgs("zamba2-7b", **kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    tparams = _t(jparams)
    assert tparams["tail"]["norm"]["w"].shape[0] == tail
    B, S, max_len = 2, 16, 24
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc = JM.prefill(jparams, jcfg, jnp.asarray(toks), max_len=max_len,
                        tp=TP)
    tl, tc = TM.prefill(tparams, tcfg, torch.from_numpy(toks),
                        max_len=max_len, tp=TP)
    _close(tl, jl)
    assert tc["tail_ssm"].shape[0] == tail and tc["length"] == S
    for name in ("body_ssm", "body_conv", "tail_ssm", "tail_conv",
                 "shared_k", "shared_v"):
        assert jax.tree.map(np.shape, _np_tree(jc[name])) == jax.tree.map(
            lambda a: tuple(a.shape), tc[name], is_leaf=torch.is_tensor)
        _close(tc[name], jc[name])
    for i in range(3):
        tok = toks[:, i]
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jc, tp=TP)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(tok), tc,
                                tp=TP)
        _close(tl, jl)
    for name in ("body_ssm", "body_conv", "tail_ssm", "tail_conv",
                 "shared_k"):
        _close(tc[name], jc[name])
    assert tc["length"] == S + 3


def test_make_cache_trees_match_jax():
    for name in ("zamba2-7b", "xlstm-125m"):
        jcfg, tcfg = _cfgs(name)
        jc = JM.make_cache(jcfg, 2, 32, tp=TP)
        tc = TM.make_cache(tcfg, 2, 32, tp=TP, device="cpu")
        jl = {k: v for k, v in jc.items() if k != "length"}
        tl = {k: v for k, v in tc.items() if k != "length"}
        _close(tl, jl)
        for a, b in zip(jax.tree_util.tree_leaves(_np_tree(jl)),
                        jax.tree_util.tree_leaves(
                            tl, is_leaf=torch.is_tensor)):
            assert tuple(b.shape) == a.shape
        assert tc["length"] == 0
