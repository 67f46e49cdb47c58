"""The port's training gradient for every non-dense family against
``jax.value_and_grad`` of the reference's ``train_loss``, on the CPU:
granite-moe (the MoE aux through the index dispatch; capacity drops are
constants on both sides), qwen2-vl (M-RoPE's three position streams and
the vlm stub's image embeddings), musicgen, zamba2 (the Mamba2 SSD chunks
and the shared block) and xlstm-125m (the mLSTM / sLSTM loops), each at
``.smoke()`` in fp32, with and without per-layer remat, from the same
JAX-initialized weights (``from_jax_params``) on the same seeded batch.

Tolerances as ``tests/test_torch_train.py``'s dense case: the loss within
1e-5 relative, each gradient leaf within 1e-4 of its largest |g| (fp32 on
both sides, different summation order), the leaf count equal. A leaf the
loss does not reach (zamba2's empty tail stack) gets zeros, as ``jax.grad``
gives it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.train import TrainConfig, loss_and_grads  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402
from torch_family_cases import TP, batch, grad_close  # noqa: E402

torch.set_num_threads(2)
FAMILIES = ("granite-moe-1b-a400m", "qwen2-vl-72b", "musicgen-medium",
            "zamba2-7b", "xlstm-125m")


def _check(name, remat, **over):
    """loss_and_grads of the port against jax.value_and_grad of the
    reference's train_loss, ``over`` replacing config fields on both."""
    jcfg = jget_arch(name).smoke().replace(dtype="float32", **over)
    tcfg = get_arch(name).smoke().replace(dtype="float32", **over)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    b = batch(jcfg)
    jl, jg = jax.value_and_grad(lambda p, x: JM.train_loss(
        p, jcfg, x, remat=remat, tp=TP))(
            jparams, {k: jnp.asarray(v) for k, v in b.items()})
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    loss, grads = loss_and_grads(
        tparams, tcfg, TrainConfig(remat=remat, tp=TP),
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    got = leaves(grads)
    assert len(flat) == len(got)
    for (path, want), g in zip(flat, got):
        grad_close(g, want, f"{name} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_grads_match_jax(name, remat):
    _check(name, remat)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_grads_with_capacity_drops_match_jax(remat):
    """granite-moe at capacity factor 0.5 (16 slots an expert for 64 tokens
    routed 2 ways; layer 0 routes 26-37 to each expert): tokens past an
    expert's capacity are dropped on both sides, and the gradient flows
    through the kept tokens' gates only."""
    _check("granite-moe-1b-a400m", remat, capacity_factor=0.5)


def test_mamba2_grads_finite_where_the_reference_overflows():
    """zamba2 at smoke with dt_bias 3 (a chunk's decay reaches e^-380, past
    fp32's range, as zamba2's 112 heads do at full width at init): the
    reference's loss is finite but its gradient NaN (it zeroes the SSD's
    upper triangle after the exp, and 0 x inf = NaN in the backward); the
    port's loss equals it and its gradient is finite. One Mamba2 layer at
    that setting: the chunked forward's gradient equals the recurrent
    (token by token) form's, which forms no upper triangle."""
    from repro_torch.models import ssm as TS

    name, remat = "zamba2-7b", False
    jcfg = jget_arch(name).smoke().replace(dtype="float32")
    tcfg = get_arch(name).smoke().replace(dtype="float32")
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.full_like(a, 3.0)
        if "dt_bias" in jax.tree_util.keystr(path) else a,
        JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP))
    b = batch(jcfg)
    jl, jg = jax.value_and_grad(lambda p, x: JM.train_loss(
        p, jcfg, x, remat=remat, tp=TP))(
            jparams, {k: jnp.asarray(v) for k, v in b.items()})
    assert np.isfinite(float(jl))
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(jg))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    loss, grads = loss_and_grads(
        tparams, tcfg, TrainConfig(remat=remat, tp=TP),
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in leaves(grads))

    gen = torch.Generator().manual_seed(0)
    p = TS.mamba_init(gen, tcfg)
    p["dt_bias"] = torch.full_like(p["dt_bias"], 3.0)
    x = torch.randn(2, 32, tcfg.d_model, generator=gen)
    w = torch.randn(2, 32, tcfg.d_model, generator=gen)
    ps = list(p.values())

    def grads_of(y):
        return torch.autograd.grad((y * w).sum(), ps)

    for t in ps:
        t.requires_grad_(True)
    chunked = grads_of(TS.mamba_forward(p, x, tcfg)[0])
    state = TS.mamba_state_init(tcfg, 2, device="cpu")
    ys = []
    for t in range(x.shape[1]):
        y, state = TS.mamba_decode(p, x[:, t:t + 1], tcfg, state)
        ys.append(y)
    stepped = grads_of(torch.cat(ys, dim=1))
    for k, a, s in zip(p, chunked, stepped):
        assert bool(torch.isfinite(a).all()), k
        grad_close(a, s.numpy(), f"mamba {k}")
