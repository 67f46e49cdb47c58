"""Every architecture of ``repro_torch.configs.ARCHS`` in the port against
the JAX package, on the CPU (ports of ``tests/test_models.py``'s smoke and
consistency tests): ``train_loss`` (with the MoE aux and the vlm stub's
image embeddings and M-RoPE positions), ``prefill``'s last logits and
``decode_step``'s logits from the same JAX-initialized weights; the port's
own prefill(S) == prefill(S/2) + S/2 decode steps for every family (MoE at
``capacity_factor=4.0``, as the reference, so the groupings drop nothing);
``weights.from_jax_params`` carries the hybrid's double-stacked body, the
MoE expert stacks and the xLSTM trees bit for bit; the port's seeded
``init_params`` builds the reference's tree.

Smoke configs at float32 here: within 1e-4 (fp32 on both sides, different
summation order). The bf16 configs: ``test_torch_families_bf16.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402
from torch_family_cases import TP, parity  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_family_matches_jax_fp32(name):
    parity(name, "float32", 1e-4)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_decode_consistency(name):
    """prefill(S) last logits == prefill(S/2) + S/2 decode steps (KV caches,
    Mamba2 states, xLSTM states, the shared-attention hybrid, M-RoPE), in
    bf16 within the reference's 0.25."""
    cfg = get_arch(name).smoke()
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=4.0)
    params = TM.init_params(cfg, 3, tp=TP, device="cpu")
    B, S = 2, 32
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)))
    ref, _ = TM.prefill(params, cfg, toks, max_len=S, tp=TP)
    half = S // 2
    logits, caches = TM.prefill(params, cfg, toks[:, :half], max_len=S,
                                tp=TP)
    for i in range(half, S):
        logits, caches = TM.decode_step(params, cfg, toks[:, i], caches,
                                        tp=TP)
    err = float((ref.float() - logits.float()).abs().max())
    assert err < 0.25, (name, err)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "zamba2-7b",
                                  "xlstm-125m"])
def test_from_jax_params_bit_exact_and_seeded_tree(name):
    """bf16 leaves carried bit for bit, shapes kept (the [n_super, per]
    body, [E, d, ff] experts, xLSTM pairs); the port's own init builds the
    same tree (keys, shapes, dtypes)."""
    cfg = jget_arch(name).smoke()
    jp = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(1),
                                                 tp=TP))
    tp = from_jax_params(jp, "cpu")
    seeded = TM.init_params(get_arch(name).smoke(), 0, tp=TP, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    for tree in (tp, seeded):
        tleaves = jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=torch.is_tensor)
        assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
        for (path, a), (_, b) in zip(jleaves, tleaves):
            assert tuple(b.shape) == a.shape, path
            assert str(b.dtype).split(".")[-1] == a.dtype.name, path
    for (path, a), b in zip(jleaves, jax.tree_util.tree_leaves(
            tp, is_leaf=torch.is_tensor)):
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)


def _three_streams(B, S):
    """Three distinct M-RoPE position streams [3, B, S], as an image's
    patches give them: the temporal one constant, height and width
    varying, each row of the batch offset."""
    s = np.arange(S)
    rows = np.arange(B)[:, None]
    return np.stack([np.full((B, S), 5), s // 4 + rows,
                     (3 * s) % 7 + 2 * rows]).astype(np.int32)


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128),
                                         ((2, 3, 3), 16)])
def test_mrope_cos_sin_distinct_streams_match_jax(sections, hd):
    """``layers.mrope_cos_sin`` against JAX's at fp32 within 1e-6 on three
    distinct streams, at qwen2-vl-72b's sections and at smoke's; the
    streams are distinct enough that one stream's angles alone differ."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    p3 = _three_streams(2, 24)
    jc, js = JL.mrope_cos_sin(jax.numpy.asarray(p3), hd, 1e6, sections)
    tc, ts = TL.mrope_cos_sin(torch.from_numpy(p3), hd, 1e6, sections)
    for t, j in ((tc, jc), (ts, js)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6,
                                   rtol=0)
    for k in range(3):
        one, _ = TL.mrope_cos_sin(torch.from_numpy(
            np.ascontiguousarray(np.broadcast_to(p3[k], p3.shape))), hd,
            1e6, sections)
        assert float((one - tc).abs().max()) > 1e-2, k


@pytest.mark.parametrize("what", ["train_loss", "prefill"])
def test_qwen2vl_distinct_streams_match_jax(what):
    """qwen2-vl's ``train_loss`` and ``prefill`` last logits (then two
    decode steps) against JAX's at fp32 within 1e-4, the three M-RoPE
    position streams distinct (temporal constant, height and width
    varying), from the same JAX-initialized weights."""
    from torch_family_cases import B, S, _close, batch

    name = "qwen2-vl-72b"
    jcfg = jget_arch(name).smoke().replace(dtype="float32")
    tcfg = get_arch(name).smoke().replace(dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    b = dict(batch(jcfg), positions3=_three_streams(B, S))
    jb = {k: jax.numpy.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    if what == "train_loss":
        jl = JM.train_loss(jp, jcfg, jb, remat=False, tp=TP)
        tl = TM.train_loss(tp, tcfg, tb, remat=False, tp=TP)
        assert abs(float(tl) - float(jl)) < 1e-4, (float(tl), float(jl))
        return
    jlog, jc = JM.prefill(jp, jcfg, jb["tokens"], max_len=S + 4, tp=TP,
                          positions3=jb["positions3"])
    tlog, tc = TM.prefill(tp, tcfg, tb["tokens"], max_len=S + 4, tp=TP,
                          positions3=tb["positions3"])
    _close(tlog, jlog, 1e-4, name)
    for i in range(2):
        tok = b["tokens"][:, i]
        jlog, jc = JM.decode_step(jp, jcfg, jax.numpy.asarray(tok), jc,
                                  tp=TP)
        tlog, tc = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  tp=TP)
        _close(tlog, jlog, 1e-4, name)
