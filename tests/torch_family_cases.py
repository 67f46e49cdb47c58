"""Shared by ``test_torch_families.py``, ``test_torch_families_bf16.py`` and
``test_torch_family_grads.py``: one architecture's smoke config through the
JAX package and the port from the same JAX-initialized weights on the same
seeded inputs; ``grad_close`` also serves ``test_torch_train.py``."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.models import model as JM
from repro_torch.configs import get_arch
from repro_torch.models import model as TM
from repro_torch.weights import from_jax_params

TP = 4
B, S = 2, 32


def batch(cfg, seed=0):
    """Tokens and labels [B, S]; for M-RoPE also the three position streams
    and 4 image-patch embeddings (the vlm stub), as the reference's
    ``tests/test_models.py`` feeds them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": toks}
    if cfg.rope_style == "mrope":
        b["positions3"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S)))
        b["img_embeds"] = rng.standard_normal(
            (B, 4, cfg.d_model)).astype(np.float32)
    return b


def parity(name: str, dtype: str, tol: float):
    """train_loss, prefill's last logits and two decode steps' logits, JAX
    against the port; each within ``tol`` (absolute)."""
    jcfg = jget_arch(name).smoke().replace(dtype=dtype)
    tcfg = get_arch(name).smoke().replace(dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    b = batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jl = jax.jit(lambda p, x: JM.train_loss(p, jcfg, x, remat=False,
                                            tp=TP))(jp, jb)
    tl = TM.train_loss(tp, tcfg, tb, remat=False, tp=TP)
    assert abs(float(tl) - float(jl)) < tol, (name, float(tl), float(jl))
    p3 = {"positions3": jb["positions3"]} if "positions3" in jb else {}
    t3 = {"positions3": tb["positions3"]} if "positions3" in tb else {}
    jlog, jc = jax.jit(lambda p, t: JM.prefill(p, jcfg, t, max_len=S + 4,
                                               tp=TP, **p3))(jp, jb["tokens"])
    tlog, tc = TM.prefill(tp, tcfg, tb["tokens"], max_len=S + 4, tp=TP, **t3)
    _close(tlog, jlog, tol, name)
    step = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c, tp=TP))
    for i in range(2):
        tok = b["tokens"][:, i]
        jlog, jc = step(jp, jnp.asarray(tok), jc)
        tlog, tc = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tc, tp=TP)
        _close(tlog, jlog, tol, name)
    assert tc["length"] == S + 2


def _close(t, j, tol, name):
    err = np.abs(t.float().numpy() - np.asarray(j, np.float32)).max()
    assert err < tol, (name, err)


def grad_close(got, want, name):
    """A gradient leaf of the port against JAX's: the same shape, and within
    1e-4 of JAX's largest |g| (an empty leaf: the shape alone)."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (name, tuple(got.shape),
                                            want.shape)
    if want.size == 0:
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 1e-4 * scale, f"{name}: err {err} vs max|g| {scale}"
