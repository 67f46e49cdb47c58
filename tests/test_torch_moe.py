"""The port's MoE (``repro_torch/models/moe.py``: index dispatch into
``[E, C, d]`` buffers, ``torch.bmm`` experts, gather back) against the JAX
package's one-hot dispatch (``repro/models/moe.py``), on the CPU:

  * ``moe_apply``'s output and aux loss where tokens drop (the load past
    ``cap``), where nothing drops (decode's ``cap = 4`` at 4 slots), where
    router probabilities tie (broken toward the lower expert index, as
    ``jax.lax.top_k`` does), over several groups with the last one padded;
  * granite's bucketed prefill with padded rows (token id 0 past each
    row's length takes router capacity in b-major order) and paged decode
    with a dead slot, logits and KV pages;
  * granite served by the engine through the paged pool, stepped, fused
    (K = 4, the window function a CUDA graph captures, run eagerly here)
    and through the hetero offload in sync, against the JAX engine's
    tokens.

Smoke config (4 experts, top 2) at dtype float32 with tp=4. Tolerances:
outputs and logits within 1e-5 (fp32 on both sides, different summation
order), tokens exactly.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import OffloadConfig as JOffloadConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.serving import (Engine, OffloadConfig, Request,  # noqa: E402
                                 ServeConfig)
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TP = 4
TOL = 1e-5
NAME = "granite-moe-1b-a400m"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(**kw):
    return (jget_arch(NAME).smoke().replace(dtype="float32", **kw),
            get_arch(NAME).smoke().replace(dtype="float32", **kw))


def _moe_params(jcfg, seed=0):
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, from_jax_params(_np_tree(jp), "cpu")


def _load(tp, x, cfg, group):
    """Per (group, expert) assignment count of x [B, S, d] (the port's
    router and stable top-k)."""
    flat = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(flat.float() @ tp["router"], -1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][
        :, :cfg.experts_per_token]
    return [np.bincount(idx[g0:g0 + group].reshape(-1).numpy(),
                        minlength=cfg.n_experts)
            for g0 in range(0, flat.shape[0], group)]


def _compare(jp, tp, x, jcfg, tcfg, group=2048):
    jy, jaux = JMOE.moe_apply(jp, jnp.asarray(x), jcfg, group_size=group)
    ty, taux = TMOE.moe_apply(tp, torch.from_numpy(x), tcfg,
                              group_size=group)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL, atol=TOL)
    return ty


def test_capacity_matches_jax():
    for name in (NAME, "mixtral-8x7b"):
        jc, tc = jget_arch(name), get_arch(name)
        for t in (1, 4, 8, 512, 1024, 2048):
            assert TMOE.capacity(t, tc) == JMOE.capacity(t, jc)
    assert TMOE.capacity(4, get_arch(NAME)) == 4
    assert TMOE.capacity(2048, get_arch(NAME)) == 640


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_apply_drops_tokens_like_jax(cf):
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    x = np.random.default_rng(0).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    _compare(jp, tp, x, jcfg, tcfg)
    load = _load(tp, torch.from_numpy(x), tcfg, 48)[0]
    assert load.max() > TMOE.capacity(48, tcfg)          # tokens drop


def test_moe_apply_no_drop_at_decode():
    """4 slots, one token each: cap = 4 >= any load."""
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg, seed=1)
    x = np.random.default_rng(1).standard_normal(
        (4, 1, jcfg.d_model)).astype(np.float32)
    _compare(jp, tp, x, jcfg, tcfg)
    assert TMOE.capacity(4, tcfg) == 4


def test_router_ties_break_by_index():
    """Equal router columns tie exactly: the lower expert index wins, and
    capacity goes in token order."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    jp, _ = _moe_params(jcfg, seed=2)
    r = np.asarray(jp["router"]).copy()
    r[:, 1] = r[:, 0]
    r[:, 3] = r[:, 2]
    jp = dict(jp, router=jnp.asarray(r))
    tp = from_jax_params(_np_tree(jp), "cpu")
    x = np.random.default_rng(2).standard_normal(
        (1, 16, jcfg.d_model)).astype(np.float32)
    x[0, 8:] = 0.0                    # all four experts tie on these rows
    _compare(jp, tp, x, jcfg, tcfg)


def test_groups_with_padded_last_group():
    """40 tokens in groups of 16: the last group is padded with 8 zero rows
    that take router capacity; aux is the mean over 3 groups."""
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg, seed=3)
    x = np.random.default_rng(3).standard_normal(
        (2, 20, jcfg.d_model)).astype(np.float32)
    _compare(jp, tp, x, jcfg, tcfg, group=16)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = jinit(jcfg, jax.random.PRNGKey(0), tp=TP)
    return jcfg, tcfg, jparams, from_jax_params(_np_tree(jparams), "cpu")


def test_bucketed_prefill_padded_rows_and_dead_slot_decode(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(4)
    B, Sb, ps = 3, 16, 16
    toks = rng.integers(1, jcfg.vocab_size, (B, Sb)).astype(np.int32)
    lens = np.array([16, 9, 5], np.int32)
    toks[np.arange(Sb)[None] >= lens[:, None]] = 0      # the padding
    jl, jk, jv = JM.prefill_bucketed(jparams, jcfg, jnp.asarray(toks),
                                     jnp.asarray(lens), tp=TP)
    tl, tk, tv = TM.prefill_bucketed(tparams, tcfg, torch.from_numpy(toks),
                                     torch.from_numpy(lens), tp=TP)
    for t, j in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)
    # paged decode from those pages, slot 1 dead (its token still routes)
    max_len = 32
    NP = max_len // ps
    table = np.arange(1, B * NP + 1, dtype=np.int32).reshape(B, NP)
    kw = dict(page_size=ps, total_pages=B * NP + 1, tp=TP)
    jpool = JM.make_page_pool(jcfg, B, max_len, **kw)
    tpool = TM.make_page_pool(tcfg, B, max_len, device="cpu", **kw)
    dest = table[:, :1].reshape(-1)
    L_ = jk.shape[0]
    jpool["k_pages"] = jpool["k_pages"].at[:, dest].set(
        jk.reshape(L_, B, ps, *jk.shape[3:]))
    jpool["v_pages"] = jpool["v_pages"].at[:, dest].set(
        jv.reshape(L_, B, ps, *jv.shape[3:]))
    tpool["k_pages"][:, torch.from_numpy(dest).long()] = tk.reshape(
        L_, B, ps, *tk.shape[3:])
    tpool["v_pages"][:, torch.from_numpy(dest).long()] = tv.reshape(
        L_, B, ps, *tv.shape[3:])
    live = np.array([True, False, True])
    lengths = np.where(live, lens, 0).astype(np.int32)
    jpool.update(page_table=jnp.asarray(table), lengths=jnp.asarray(lengths))
    tpool.update(page_table=torch.from_numpy(table).long(),
                 lengths=torch.from_numpy(lengths))
    tok = np.array([3, 7, 11], np.int32)
    jd, jpool = JM.decode_step_paged(jparams, jcfg, jnp.asarray(tok), jpool,
                                     jnp.asarray(live), tp=TP)
    td, tpool = TM.decode_step_paged(tparams, tcfg, torch.from_numpy(tok),
                                     tpool, torch.from_numpy(live), tp=TP)
    np.testing.assert_allclose(td.numpy()[live], np.asarray(jd)[live],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tpool["k_pages"].numpy(),
                               np.asarray(jpool["k_pages"]), rtol=TOL,
                               atol=TOL)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg, tcfg = _cfgs()
    jparams = jinit(jcfg, jax.random.PRNGKey(0), tp=TP)
    return jcfg, tcfg, jparams, from_jax_params(_np_tree(jparams), "cpu")


GRANITE_MODES = {
    "stepped": {},
    "fused4": {"fused_steps": 4},
    "offload-sync": {"offload_cfg": OffloadConfig(mode="sync")},
}


@pytest.mark.parametrize("mode", list(GRANITE_MODES))
def test_granite_paged_matches_jax_engine(mode):
    """MoE through the paged pool: bucketed prefill, chunked prefill,
    decode with dead slots, sparse DSA; the JAX engine with the same
    ServeConfig (its fused loop, its offload in sync)."""
    jcfg, tcfg, jparams, tparams = _weights()
    kw = dict(method="dsa", max_len=64, n_slots=2, tp=TP, page=4,
              kv_page_size=16, prefill_chunk=16, chunk_threshold=24)
    extra = GRANITE_MODES[mode]
    jextra = dict(extra)
    if "offload_cfg" in jextra:
        jextra["offload_cfg"] = JOffloadConfig(mode="sync")
    jeng = JEngine(jcfg, jparams, JServeConfig(**kw, **jextra),
                   key=jax.random.PRNGKey(1))
    sp = from_jax_params(_np_tree(jeng.sparse_params), "cpu")
    teng = Engine(tcfg, tparams, ServeConfig(**kw, **extra), device="cpu",
                  sparse_params=sp)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (16, 9, 40, 20)]
    jh = [jeng.submit(JRequest(i, p, 6)) for i, p in enumerate(prompts)]
    th = [teng.submit(Request(i, p, 6)) for i, p in enumerate(prompts)]
    jeng.drain()
    teng.drain()
    for a, b in zip(jh, th):
        assert a.done and b.done
        np.testing.assert_array_equal(b.result(), a.result())
    if mode == "fused4":
        assert teng.stats["host_steps"] < teng.stats["decode_steps"]
    if mode == "offload-sync":
        assert teng.hetero.report()["offload_steps"] > 0
