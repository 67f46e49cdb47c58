"""The port's training substrate on the CPU: ports of the single-device
tests of ``tests/test_train.py`` (optimizer, checkpoints, trainer restart,
data, elastic planning), and parity with the JAX package on the same
numpy inputs and JAX-initialized weights (``from_jax_params``).

Tolerances: the loss within 1e-5 relative and each gradient leaf within
1e-4 of its largest |g| (fp32 on both sides, different summation order);
``adamw_update`` within 1e-6 on the same gradients; three trainer steps'
losses within 1e-4 relative (Adam's first steps map a near-zero gradient
to +-lr, so parameters are compared through the loss, not leaf by leaf);
checkpoints bit for bit.
"""
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.distributed import checkpoint as jckpt  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import adamw_update as jadamw  # noqa: E402
from repro.train import init_opt_state as jinit_opt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import TokenStream, pack_documents  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed.elastic import (StragglerMonitor,  # noqa: E402
                                             plan_mesh)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train import (OptConfig, Trainer, TrainConfig,  # noqa: E402
                               adamw_update, init_opt_state, loss_and_grads)
from repro_torch.train.optimizer import leaves  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402
from torch_family_cases import grad_close  # noqa: E402

torch.set_num_threads(2)
TP = 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seq=32, batch=2, seed=0):
    return TokenStream(512, seq, batch, seed=seed).next_batch()


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# ports of tests/test_train.py (single device)
# ---------------------------------------------------------------------------


def test_adamw_minimizes_quadratic():
    oc = OptConfig(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(grads, state, params, oc)
    assert float(params["w"].abs().max()) < 0.3


@settings(max_examples=30, deadline=None)
@given(st.floats(0.1, 100.0))
def test_grad_clip_bounds_update(scale):
    oc = OptConfig(lr=1e-2, warmup_steps=0, clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params)
    grads = {"w": torch.full((4,), scale)}
    new, _, stats = adamw_update(grads, state, params, oc)
    assert float(stats["grad_norm"]) == pytest.approx(scale * 2.0, rel=1e-4)
    assert float(new["w"].abs().max()) <= oc.lr * 1.1


def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg = get_arch("llama3.2-1b").smoke()
    params = init_params(cfg, 0, tp=TP, device="cpu")
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, {"params": params})
    assert ckpt.latest_step(d) == 7
    like = {"params": {k: v for k, v in params.items()}}
    back = ckpt.restore(d, 7, like)
    for a, b in zip(leaves(params), leaves(back["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention_and_atomicity(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(5):
        ckpt.save(d, s, {"x": torch.ones(3) * s}, keep=2)
    steps = sorted(p for p in os.listdir(d) if p.startswith("step_"))
    assert len(steps) == 2 and ckpt.latest_step(d) == 4
    assert not [p for p in os.listdir(d) if p.startswith(".tmp")]


def test_trainer_restores_after_crash(tmp_path):
    cfg = get_arch("llama3.2-1b").smoke()
    params = init_params(cfg, 0, tp=TP, device="cpu")
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=50),
                     tp=TP, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
    tr = Trainer(cfg, tc, params)
    it = iter(TokenStream(cfg.vocab_size, 32, 2, seed=0))
    for _ in range(4):
        tr.train_step(_tb(next(it)))
    step_before = tr.step
    loss_ref = tr.train_step(_tb(next(it)))["loss"]
    # "crash": a new Trainer from fresh params restores the checkpoint
    tr2 = Trainer(cfg, tc, init_params(cfg, 9, tp=TP, device="cpu"))
    assert tr2.step == step_before
    it2 = iter(TokenStream(cfg.vocab_size, 32, 2, seed=0))
    for _ in range(4):
        next(it2)
    loss_resumed = tr2.train_step(_tb(next(it2)))["loss"]
    assert loss_resumed == pytest.approx(loss_ref, rel=1e-3)


def test_data_determinism_and_host_sharding():
    a = TokenStream(512, 64, 4, seed=1, host_index=0, num_hosts=2).next_batch()
    b = TokenStream(512, 64, 4, seed=1, host_index=0, num_hosts=2).next_batch()
    c = TokenStream(512, 64, 4, seed=1, host_index=1, num_hosts=2).next_batch()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].max() < 512


def test_pack_documents():
    docs = [[1] * 5, [2] * 9, [3] * 3]
    rows = pack_documents(docs, seq_len=8, pad_id=0)
    assert rows.shape[1] == 8
    assert rows.sum() == 5 + 18 + 9  # nothing lost


def test_straggler_and_elastic_plan():
    mon = StragglerMonitor(factor=2.0)
    for i in range(8):
        for _ in range(4):
            mon.record(f"host{i}", 1.0 if i else 5.0)  # host0 is slow
    assert mon.stragglers() == ["host0"]
    shape, axes = plan_mesh(512, model_parallel=16, multi_pod=True)
    assert shape == (2, 16, 16) and axes == ("pod", "data", "model")
    shape, axes = plan_mesh(480, model_parallel=16)  # 2 hosts lost
    assert shape == (30, 16)
    with pytest.raises(ValueError):
        plan_mesh(8, model_parallel=16)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def test_data_matches_jax():
    from repro.data import TokenStream as JStream
    from repro.data import pack_documents as jpack

    for kw in (dict(seed=3), dict(seed=3, host_index=1, num_hosts=2)):
        a, b = TokenStream(512, 48, 3, **kw), JStream(512, 48, 3, **kw)
        for _ in range(2):
            x, y = a.next_batch(), b.next_batch()
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(x[k], y[k])
    docs = [[1, 2, 3], list(range(11)), [7] * 4]
    np.testing.assert_array_equal(pack_documents(docs, 5, pad_id=9),
                                  jpack(docs, 5, pad_id=9))


@pytest.fixture(scope="module")
def smoke32():
    jcfg = jget_arch("llama3.2-1b").smoke().replace(dtype="float32")
    tcfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    return jcfg, tcfg, jparams


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_loss_and_grads_match_jax(smoke32, remat, accum):
    jcfg, tcfg, jparams = smoke32
    b = _batch(seq=32, batch=2 * accum, seed=accum)
    mbs = [{k: v[i::accum] for k, v in b.items()} for i in range(accum)]

    def jloss(p, mb):
        return JM.train_loss(p, jcfg, mb, remat=remat, tp=TP)

    jl, jg = 0.0, None
    for mb in mbs:
        l, g = jax.value_and_grad(jloss)(jparams, {
            k: jnp.asarray(v) for k, v in mb.items()})
        jl = jl + float(l) / accum
        g = jax.tree.map(lambda x: x / accum, g)
        jg = g if jg is None else jax.tree.map(jnp.add, jg, g)
    tparams = from_jax_params(_np_tree(jparams), device="cpu")
    tc = TrainConfig(remat=remat, accum=accum, tp=TP)
    batch = _tb(b) if accum == 1 else {
        k: torch.from_numpy(np.stack([mb[k] for mb in mbs])) for k in b}
    loss, grads = loss_and_grads(tparams, tcfg, tc, batch)
    assert float(loss) == pytest.approx(jl, rel=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat) == len(leaves(grads))
    for (path, want), got in zip(flat, leaves(grads)):
        grad_close(got, want, jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Three updates on the same numpy gradients; bf16 parameters within one
    bf16 rounding step (2^-8 relative), fp32 ones and the moments within
    1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"b": (7,), "w": (5, 6), "u": {"x": (3, 4, 2)}}

    def make(fn, tree=shapes):
        return {k: make(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}

    p0 = make(lambda s: rng.standard_normal(s).astype(np.float32))
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              clip_norm=0.5)
    jp = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), p0)
    tp_ = from_jax_params(_np_tree(jp), device="cpu")
    js, ts = jinit_opt(jp), init_opt_state(tp_)
    for _ in range(3):
        g = make(lambda s: (rng.standard_normal(s) * 0.3).astype(np.float32))
        jp, js, jst = jadamw(jax.tree.map(jnp.asarray, g), js, jp,
                             JOptConfig(**oc))
        tp_, ts, tst = adamw_update(from_jax_params(g, device="cpu"), ts,
                                    tp_, OptConfig(**oc))
        assert tst["lr"] == pytest.approx(float(jst["lr"]), rel=1e-6)
        assert float(tst["grad_norm"]) == pytest.approx(
            float(jst["grad_norm"]), rel=1e-6)
    assert ts.step == int(js.step) == 3
    ptol = 1e-6 if dtype == "float32" else 2.0 ** -8
    for got, want, tol in ([(a, b, ptol) for a, b in zip(
            leaves(tp_), jax.tree.leaves(jp))]
            + [(a, b, 1e-6) for a, b in zip(leaves(ts.m) + leaves(ts.v),
                                            jax.tree.leaves(js.m)
                                            + jax.tree.leaves(js.v))]):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_trainer_losses_match_jax(smoke32):
    jcfg, tcfg, jparams = smoke32
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=50)
    tparams = from_jax_params(_np_tree(jparams), device="cpu")
    jtr = JTrainer(jcfg, JTrainConfig(opt=JOptConfig(**oc), tp=TP), jparams)
    ttr = Trainer(tcfg, TrainConfig(opt=OptConfig(**oc), tp=TP), tparams)
    it = iter(TokenStream(tcfg.vocab_size, 32, 2, seed=0))
    for _ in range(3):
        b = next(it)
        jl = jtr.train_step({k: jnp.asarray(v) for k, v in b.items()})["loss"]
        tl = ttr.train_step(_tb(b))["loss"]
        assert tl == pytest.approx(jl, rel=1e-4)


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint written by the JAX package restores in the port equal
    to ``from_jax_params`` of the same tree (bf16 bits included), and one
    written by the port restores in the JAX package."""
    cfg = jget_arch("llama3.2-1b").smoke()                  # bf16 weights
    jp = JM.init_params(cfg, jax.random.PRNGKey(2), tp=TP)
    want = from_jax_params(_np_tree(jp), device="cpu")
    jckpt.save(str(tmp_path / "j"), 3, {"params": jp}, extra={"opt_step": 3})
    like = {"params": init_params(get_arch("llama3.2-1b").smoke(), 1, tp=TP,
                                  device="cpu")}
    got = ckpt.restore(str(tmp_path / "j"), 3, like)["params"]
    assert ckpt.read_manifest(str(tmp_path / "j"), 3)["extra"] == {
        "opt_step": 3}
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ckpt.save(str(tmp_path / "t"), 5, {"params": want})
    back = jckpt.restore(str(tmp_path / "t"), 5, {"params": jax.tree.map(
        jnp.zeros_like, jp)})["params"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
