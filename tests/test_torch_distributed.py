"""The port's sequence-parallel functions (``repro_torch.distributed.topk``),
DSA's distributed sparse decode and the main mesh on the CPU, ports of
``tests/test_distributed.py``'s top-k / decode / cached-index cases and of
``tests/test_main_mesh.py``:

  * ``distributed_paged_sparse_decode`` and ``distributed_relevancy_topk``
    over 1, 2 and 4 shards of ``(cpu,) * n`` == the single-device ``ops``
    (non-empty selections with -1 holes, ragged lengths; out and lse within
    rtol 2e-5 / atol 2e-6, the reference's own bound for the LSE merge;
    top-k indices equal, values within 1e-6) and == the JAX package's
    functions on meshes of 1, 2 and 4 host devices (one subprocess under
    ``--xla_force_host_platform_device_count=4``, as
    ``tests/test_distributed.py`` runs them; same bounds; top-k values
    within 1e-5, indices equal); the empty-selection case, where the LSE
    merge departs from the unsharded kernel in both packages, equal to
    JAX's;
  * ``make_sparse_fn_cached`` == ``make_sparse_fn_distributed`` (and the
    latter == JAX's), the cache update in the owning shard's page;
  * the ``page_attn`` seam of ``decode_step_paged_presel``;
  * ``main_mesh=2`` serving == ``main_mesh=1`` == inline retrieval for dsa /
    seer / lserve, composed with 2 selection shards, == the JAX engine's
    ``main_mesh=2`` for dsa (both clamp to one device); under the
    scheduler; across the dense-fallback window; view buckets aligned to
    ``main_mesh * page``; the shard-size assert.

Empty effective selections (every page -1 or past the length) are left out
of the sharded == unsharded checks, as the reference's own property test
leaves them out (``tests/test_main_mesh.py``): the softmax is degenerate
there and the LSE merge averages each shard's mean of v (ROADMAP Queue 3).
The engine always selects the page being written, so serving never meets
it.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import torch_serving_cases as C  # noqa: E402
from repro.core.methods.dsa import dsa_init as jdsa_init  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import OffloadConfig as JOffloadConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeConfig as JServeConfig  # noqa: E402
from repro_torch.core.methods import dsa  # noqa: E402
from repro_torch.distributed.topk import (  # noqa: E402
    distributed_paged_sparse_decode, distributed_relevancy_topk,
    distributed_sparse_decode, gather_shards, sharded_page_add)
from repro_torch.hetero import pick_devices_mesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import (mesh_from_devices,  # noqa: E402
                                     split_mesh_roles)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import (Engine, OffloadConfig, Request,  # noqa: E402
                                 Scheduler, ServeConfig)
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL, ATOL = 2e-5, 2e-6
CPU = torch.device("cpu")
SHARDS = (1, 2, 4)


def _mesh(n):
    return mesh_from_devices([CPU] * n)


def _decode_case(seed, B=3, S=256, KV=2, G=2, dh=16, ps=8, n_sel=10,
                 empty_row=False):
    """Zero-page view (exact zeros past each length), ragged lengths,
    duplicate-free picks with -1 holes plus the page of the last live token
    (the engine's force-included page); ``empty_row`` makes row 0's
    selection all -1."""
    rng = np.random.default_rng(seed)
    P = S // ps
    lengths = rng.integers(ps + 1, S + 1, size=B).astype(np.int32)
    lengths[-1] = S // 2 + 3                  # a length cut mid-page
    k = np.zeros((B, S, KV, dh), np.float32)
    v = np.zeros((B, S, KV, dh), np.float32)
    for b in range(B):
        k[b, :lengths[b]] = rng.normal(size=(lengths[b], KV, dh))
        v[b, :lengths[b]] = rng.normal(size=(lengths[b], KV, dh))
    q = rng.normal(size=(B, KV * G, dh)).astype(np.float32)
    pids = np.full((B, n_sel + 1), -1, np.int32)
    for b in range(B):
        cur = (lengths[b] - 1) // ps
        picks = rng.choice(P, size=n_sel, replace=False)
        picks = np.where(rng.random(n_sel) < 0.3, -1, picks)   # holes
        pids[b, :n_sel] = np.where(picks == cur, -1, picks)
        pids[b, n_sel] = cur
    if empty_row:
        pids[0] = -1
    return dict(q=q, k=k, v=v, pids=pids, lengths=lengths, ps=ps)


def _topk_case(seed, B=2, Hq=4, dk=32, S=256, k=16):
    rng = np.random.default_rng(seed)
    return dict(q=rng.standard_normal((B, Hq, dk)).astype(np.float32),
                keys=rng.standard_normal((B, S, dk)).astype(np.float32),
                w=np.abs(rng.standard_normal((B, Hq))).astype(np.float32),
                k=k)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the JAX package's functions on 1, 2 and 4 host devices (one subprocess)
# ---------------------------------------------------------------------------

_JAX_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_arch
from repro.core.methods import dsa
from repro.distributed.topk import (distributed_paged_sparse_decode,
                                    distributed_relevancy_topk)
from repro.launch.mesh import make_mesh, split_mesh_roles
d = dict(np.load(sys.argv[1]))
out = {}
for f in (0.25, 0.5, 0.75):
    roles = split_mesh_roles(make_mesh((4, 1), ("data", "model")), f)
    for name, m in zip(("pre", "dec"), roles):
        out[f"roles_{name}_{f}"] = [dev.id for dev in m.devices.flat]
for n in (1, 2, 4):
    mesh = make_mesh((n,), ("seq",))
    for case in ("dec", "empty"):
        o, l = distributed_paged_sparse_decode(
            *(jnp.asarray(d[f"{case}_{x}"]) for x in
              ("q", "k", "v", "pids", "lengths")), mesh, "seq",
            page_size=int(d["ps"]))
        out[f"{case}_out_{n}"], out[f"{case}_lse_{n}"] = o, l
    v, i = distributed_relevancy_topk(
        jnp.asarray(d["tk_q"]), jnp.asarray(d["tk_keys"]),
        jnp.asarray(d["tk_w"]), int(d["tk_k"]), mesh, "seq", block=64)
    out[f"tk_vals_{n}"], out[f"tk_idx_{n}"] = v, i
cfg = get_arch("llama3.2-1b").smoke()
mem = cfg.memory.replace(top_k=32, index_heads=4, index_dim=32)
sp = {k[3:]: jnp.asarray(v, jnp.float32 if k == "sp_w_wgt" else jnp.bfloat16)
      for k, v in d.items() if k.startswith("sp_")}     # dsa_init's dtypes
fn = dsa.make_sparse_fn_distributed(cfg, mem, make_mesh((4,), ("model",)),
                                    axis="model", tp=4, page=8)
out["dsa_out"] = fn(jnp.asarray(d["dsa_q"]), jnp.asarray(d["dsa_kc"]),
                    jnp.asarray(d["dsa_vc"]), jnp.asarray(64, jnp.int32), sp)
np.savez(sys.argv[2], **{k: np.asarray(v, np.float32) for k, v in out.items()})
print("OK")
"""


def _dsa_inputs():
    """The cached-index case of ``tests/test_distributed.py``: B 2, S 64,
    page 8, top_k 32, 4 index heads of 32; JAX's indexer weights."""
    cfg = C.setup()[1]
    mem = cfg.memory.replace(top_k=32, index_heads=4, index_dim=32)
    rng = np.random.default_rng(0)
    B, S = 2, 64
    KV, hd, HP = cfg.n_kv_heads, cfg.hd, cfg.padded_heads(C.TP)
    jcfg = C.setup()[0]
    jsp = jax.tree.map(lambda a: np.asarray(a[0]),
                       jdsa_init(jax.random.PRNGKey(1), jcfg, mem))
    return dict(cfg=cfg, mem=mem, sp=jsp,
                kc=rng.standard_normal((B, S, KV, hd)).astype(np.float32),
                vc=rng.standard_normal((B, S, KV, hd)).astype(np.float32),
                q=rng.standard_normal((B, 1, HP, hd)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's distributed functions over meshes of 1, 2 and 4
    host devices, on the inputs of ``_decode_case(0)``, ``_decode_case(1,
    empty_row=True)``, ``_topk_case(0)`` and ``_dsa_inputs()``."""
    d = tmp_path_factory.mktemp("jax_ref")
    dec, emp, tk, di = (_decode_case(0), _decode_case(1, empty_row=True),
                        _topk_case(0), _dsa_inputs())
    arrays = {"ps": dec["ps"]}
    for name, case in (("dec", dec), ("empty", emp)):
        arrays.update({f"{name}_{x}": case[x] for x in
                       ("q", "k", "v", "pids", "lengths")})
    arrays.update(tk_q=tk["q"], tk_keys=tk["keys"], tk_w=tk["w"],
                  tk_k=tk["k"], dsa_q=di["q"], dsa_kc=di["kc"],
                  dsa_vc=di["vc"],
                  **{f"sp_{k}": np.asarray(v, np.float32)
                     for k, v in di["sp"].items()})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                          str(d / "in.npz"), str(d / "out.npz")], env=env,
                         cwd=str(d), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


# ---------------------------------------------------------------------------
# distributed_paged_sparse_decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SHARDS)
def test_distributed_paged_decode_matches_single_and_jax(n, jax_ref):
    c = _decode_case(0)
    args = [_t(c[x]) for x in ("q", "k", "v", "pids", "lengths")]
    want_out, want_lse = ops.paged_decode_attention(*args,
                                                    page_size=c["ps"])
    out, lse = distributed_paged_sparse_decode(*args, _mesh(n),
                                               page_size=c["ps"])
    _close(out, want_out)
    _close(lse, want_lse)
    _close(out, jax_ref[f"dec_out_{n}"])
    _close(lse, jax_ref[f"dec_lse_{n}"])
    # the dense contract is the same shard body, its lse dropped
    assert torch.equal(distributed_sparse_decode(
        *args, _mesh(n), page_size=c["ps"]), out)


@pytest.mark.parametrize("n", SHARDS)
def test_empty_selection_lse_merge_matches_jax(n, jax_ref):
    """Row 0 selects nothing: each shard returns the mean of v over the
    first page of its slice with lse ~ -1e30, and the merge averages them.
    That is the reference's result too; for one shard it is the unsharded
    kernel's."""
    c = _decode_case(1, empty_row=True)
    args = [_t(c[x]) for x in ("q", "k", "v", "pids", "lengths")]
    out, lse = distributed_paged_sparse_decode(*args, _mesh(n),
                                               page_size=c["ps"])
    _close(out, jax_ref[f"empty_out_{n}"])
    _close(lse, jax_ref[f"empty_lse_{n}"])
    ps, S, KV, G = c["ps"], c["k"].shape[1], c["k"].shape[2], 2
    firsts = [c["v"][0, s * (S // n): s * (S // n) + ps].mean(0)
              for s in range(n)]
    want = np.repeat(np.mean(firsts, 0), G, axis=0)        # [KV*G, dh]
    np.testing.assert_allclose(out[0].numpy(), want, rtol=1e-5, atol=1e-6)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.sampled_from((2, 3, 4)))
def test_lse_merge_core_property(seed, n):
    """Ragged lengths, holes anywhere, every row keeping its force-included
    live page: n shards == the single-device kernel's plain version."""
    rng = np.random.default_rng(seed)
    ps = 8
    S = int(rng.integers(1, 4)) * n * ps * 2
    c = _decode_case(seed, B=int(rng.integers(1, 4)), S=S, ps=ps,
                     n_sel=int(rng.integers(1, S // ps)))
    args = [_t(c[x]) for x in ("q", "k", "v", "pids", "lengths")]
    want = ops.paged_decode_attention(*args, page_size=ps)
    got = distributed_paged_sparse_decode(*args, _mesh(n), page_size=ps)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_unaligned_view_trips_shard_assert():
    """A view that is no multiple of n_shards * page_size is refused, not
    mis-sharded (one device, two shards)."""
    q = torch.zeros(1, 2, 8)
    kc = torch.zeros(1, 24, 1, 8)                 # 24 % (2 * 8) != 0
    with pytest.raises(AssertionError):
        distributed_paged_sparse_decode(
            q, kc, kc, torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), _mesh(2), page_size=8)


def test_presel_page_attn_seam():
    """The serving apply step takes the sequence-parallel apply through its
    ``page_attn`` seam and gives the same logits (sparse branch), and its
    dense branch through the same seam agrees with dense attention."""
    _, cfg, _, params = C.setup()
    pool = M.make_page_pool(cfg, 2, 64, page_size=8, total_pages=17,
                            tp=C.TP, device="cpu")
    g = torch.Generator().manual_seed(0)
    for name in ("k_pages", "v_pages"):
        pool[name] = torch.randn(pool[name].shape, generator=g)
        pool[name][:, 0] = 0                      # the zero page
    table = torch.zeros(2, 8, dtype=torch.int32)
    table[0, :4] = torch.tensor([1, 2, 3, 4])
    table[1, :2] = torch.tensor([5, 6])
    pool["page_table"] = table
    pool["lengths"] = torch.tensor([20, 9], dtype=torch.int32)
    tok, live = torch.tensor([3, 7]), torch.tensor([True, True])
    pidx = torch.tensor([[[0, 1, -1]]], dtype=torch.int32).expand(
        cfg.n_layers, 2, 3).contiguous()
    for sparse in (True, False):
        got = []
        for mesh in (None, _mesh(2)):
            attn = None if mesh is None else functools.partial(
                distributed_paged_sparse_decode, devices=mesh)
            kp, vp = pool["k_pages"].clone(), pool["v_pages"].clone()
            got.append(M.decode_step_paged_presel(
                params, cfg, tok, dict(pool, k_pages=kp, v_pages=vp), live,
                pidx, sparse=sparse, page_size=8, tp=C.TP,
                page_attn=attn)[0])
        np.testing.assert_allclose(got[1].numpy(), got[0].numpy(),
                                   rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# distributed_relevancy_topk, sharded_page_add, DSA's distributed fns
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SHARDS)
def test_distributed_relevancy_topk_matches_single_and_jax(n, jax_ref):
    c = _topk_case(0)
    q, keys, w = _t(c["q"]), _t(c["keys"]), _t(c["w"])
    want_v, want_i = ops.relevancy_topk(q, keys, w, c["k"])
    v, i = distributed_relevancy_topk(q, keys, w, c["k"], _mesh(n),
                                      block=64)
    # the plain scores' matmul may round the last bit otherwise at another
    # key count: values within 1e-6, indices equal (bit-equal on the card)
    assert torch.equal(i, want_i)
    np.testing.assert_allclose(v.numpy(), want_v.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(v.numpy(), jax_ref[f"tk_vals_{n}"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), jax_ref[f"tk_idx_{n}"])
    # more than a shard holds: padded past n * local with (-inf, -1)
    v, i = distributed_relevancy_topk(q[:, :, :], keys[:, :8], w, 8,
                                      _mesh(4) if n == 4 else _mesh(n))
    assert v.shape == i.shape == (2, 8)
    assert (i >= 0).all() and torch.isfinite(v).all()


def test_distributed_topk_ties_by_ascending_index():
    """All-zero keys: every score ties at 0, and the merged picks go by
    ascending global index across the shards."""
    q, w = torch.randn(2, 4, 8), torch.rand(2, 4)
    keys = torch.zeros(2, 64, 8)
    _, i = distributed_relevancy_topk(q, keys, w, 20, _mesh(4))
    assert i.tolist() == [list(range(20))] * 2


def test_sharded_page_add_updates_owner_only():
    kidx = torch.randn(2, 8, 4)
    before = kidx.clone()
    delta = torch.randn(2, 4)
    parts = sharded_page_add(kidx, delta, 5, _mesh(4))
    assert [p.shape[1] for p in parts] == [2, 2, 2, 2]
    want = kidx.clone()
    want[:, 5] += delta
    assert torch.equal(gather_shards(parts), want)
    assert torch.equal(kidx, before)                     # input untouched
    again = sharded_page_add(parts, delta, torch.tensor(0), _mesh(4))
    want[:, 0] += delta
    assert torch.equal(gather_shards(again), want)


def test_cached_index_decode_matches_stateless(jax_ref):
    """The incremental index cache (one new key projected a step, added to
    the owning shard's page) == the stateless distributed path that
    projects the whole context, == JAX's stateless path; the update lands
    in the right page."""
    di = _dsa_inputs()
    cfg, mem = di["cfg"], di["mem"]
    page, mesh = 8, _mesh(4)
    sp = from_jax_params(di["sp"], "cpu")
    kc, vc, q = _t(di["kc"]), _t(di["vc"]), _t(di["q"])
    B, S = kc.shape[:2]
    stateless = dsa.make_sparse_fn_distributed(cfg, mem, mesh, tp=C.TP,
                                               page=page)
    out_d = stateless(q, kc, vc, S, sp)
    np.testing.assert_allclose(out_d.numpy(), jax_ref["dsa_out"],
                               rtol=1e-4, atol=1e-5)
    k_idx = dsa._matmul_promoted(kc.reshape(B, S, -1), sp["wk_idx"]).float()
    full_sum = k_idx.reshape(B, S // page, page, -1).sum(2)
    k_idx[:, S - 1] = 0.0
    cache = k_idx.reshape(B, S // page, page, -1).sum(2)
    assert dsa.idx_cache_init(cfg, mem, B, S, page=page, stacked=False,
                              device="cpu").shape == cache.shape
    cached = dsa.make_sparse_fn_cached(cfg, mem, mesh, tp=C.TP, page=page)
    out_c, sp_new = cached(q, kc, vc, S, {"p": sp, "kidx_sum": cache},
                           k_new=kc[:, S - 1][:, None])
    assert float((out_c - out_d).abs().max()) < 1e-4
    assert len(sp_new["kidx_sum"]) == 4
    np.testing.assert_allclose(gather_shards(sp_new["kidx_sum"]).numpy(),
                               full_sum.numpy(), atol=1e-3)
    # the single-shard stateless fn is the inline method's math
    inline = dsa.make_sparse_fn(cfg, mem, tp=C.TP, page=page)
    assert float((inline(q, kc, vc, S, sp) - out_d).abs().max()) < 1e-4


def test_mesh_policies():
    """The mesh clamps to a divisor of the request that fits the distinct
    devices (the CPU's one); offload shards round-robin over the rest (all
    of them when they run short)."""
    mains, offs = pick_devices_mesh(4, 3, "cpu")
    assert mains == (CPU,) and offs == (CPU,) * 3
    assert mesh_from_devices(["cpu", "cpu"]) == (CPU, CPU)
    with pytest.raises(ValueError):
        mesh_from_devices([])


@pytest.mark.parametrize("fraction", [0.25, 0.5, 0.75])
def test_split_mesh_roles_matches_jax(fraction, jax_ref):
    """The prefill role takes the first ``max(1, int(4 * fraction))`` of 4
    devices and the decode role the rest, as the reference cuts its mesh's
    data axis (4 host devices, ids compared with the card indexes)."""
    mesh = mesh_from_devices([f"cuda:{i}" for i in range(4)])
    pre, dec = split_mesh_roles(mesh, fraction)
    assert [d.index for d in pre] == list(jax_ref[f"roles_pre_{fraction}"])
    assert [d.index for d in dec] == list(jax_ref[f"roles_dec_{fraction}"])
    assert pre + dec == mesh


def test_split_mesh_roles_on_one_card():
    """One card takes both roles when the mesh names it twice; a one-entry
    mesh leaves the decode role empty, which raises."""
    assert split_mesh_roles(mesh_from_devices(["cuda:0"] * 2)) == (
        (torch.device("cuda:0"),), (torch.device("cuda:0"),))
    with pytest.raises(ValueError):
        split_mesh_roles(mesh_from_devices(["cuda:0"]))


def test_serve_cli_disaggregate(capsys, monkeypatch):
    """``--disaggregate`` on one device serves and prints no split (the
    reference's one-device behaviour); with 4 cards it prints 2 + 2."""
    tserve.main(["--disaggregate", "--device", "cpu", "--requests", "2",
                 "--max-new", "2"])
    out = capsys.readouterr().out
    assert "disaggregated roles" not in out and "2/2 requests" in out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    tserve.print_roles("cuda")
    assert capsys.readouterr().out.strip() == \
        "disaggregated roles: prefill=2 devices, decode=2 devices"


# ---------------------------------------------------------------------------
# the main mesh in the engine
# ---------------------------------------------------------------------------


SC = dict(max_len=128, n_slots=2, tp=C.TP, page=8, kv_page_size=16)


def _engine(method, off, shards=1, mesh=1, rmode=None, validate=False,
            mem=None, **kw):
    _, tcfg, _, tparams = C.setup()
    sc = ServeConfig(method=method, **dict(SC, **kw),
                     offload_cfg=OffloadConfig(mode=off, shards=shards,
                                               main_mesh=mesh,
                                               validate=validate),
                     retrieval=None if rmode is None else C.rcfg(rmode))
    return Engine(tcfg, tparams, sc, device="cpu", mem=mem,
                  sparse_params=C.sparse_params(method)[1])


@functools.lru_cache(maxsize=None)
def _jax_mesh_dsa():
    jcfg, _, jparams, _ = C.setup()
    jeng = JEngine(jcfg, jparams, JServeConfig(
        method="dsa", **SC, offload_cfg=JOffloadConfig(mode="sync",
                                                       main_mesh=2),
        retrieval=C.rcfg("sync", jax_side=True)), key=jax.random.PRNGKey(0))
    for i, p in enumerate(C.prompts((16, 24), seed=5)):
        jeng.submit(JRequest(i, p, 6, retrieval=(i == 0)))
    return C.drain(jeng, 24), C.events(jeng)


@pytest.mark.parametrize("method", ["dsa", "seer", "lserve"])
def test_main_mesh_bitmatches_single(method):
    """Mixed pool (a retrieval slot and a sparse slot): the apply mesh
    serves the tokens of the single-device apply, alone and composed with
    2 selection shards; for dsa also the JAX engine's main_mesh=2."""
    prompts = C.prompts((16, 24), seed=5)
    streams, events = {}, {}
    for off, rmode, shards, mesh_n in (("sync", "inline", 1, 1),
                                       ("sync", "sync", 1, 2),
                                       ("overlap", "overlap", 2, 2)):
        eng = _engine(method, off, shards, mesh_n, rmode,
                      validate=off == "overlap")
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, 6, retrieval=(i == 0)))
        key = (off, rmode, shards, mesh_n)
        streams[key] = C.drain(eng, 24)
        events[key] = C.events(eng)
        assert events[key], "no retrieval fired"
        assert eng.pool.pages_in_use() == 0
        if mesh_n > 1:
            rep = eng.hetero.report()
            assert rep["devices"]["main_mesh"] == ["cpu"]   # clamped
            assert eng.hetero.main_mesh == (CPU,)
    first = streams[("sync", "inline", 1, 1)]
    assert all(s == first for s in streams.values())
    assert len(set(map(tuple, events.values()))) == 1
    if method == "dsa":
        assert (first, events[("sync", "inline", 1, 1)]) == _jax_mesh_dsa()


def test_main_mesh_under_scheduler():
    prompts = C.prompts((10, 40, 16, 33), seed=7)
    streams = {}
    for off, shards, mesh_n in (("sync", 1, 1), ("overlap", 2, 2)):
        eng = _engine("dsa", off, shards, mesh_n, prefill_chunk=16,
                      chunk_threshold=32)
        sch = Scheduler(eng, prefill_token_budget=32)
        rids = [sch.submit(p, max_new=4) for p in prompts]
        done = sch.run()
        assert sorted(done) == sorted(rids)
        streams[(off, shards, mesh_n)] = {r: done[r].tokens for r in done}
        assert eng.pool.pages_in_use() == 0
    assert streams[("sync", 1, 1)] == streams[("overlap", 2, 2)]


def test_main_mesh_dense_fallback_window():
    """A run that starts below min_context (the dense branch through the
    mesh's seam) and crosses into the sparse window == the single-device
    engine."""
    mem = C.setup()[1].memory.replace(method="dsa", min_context=48)
    prompts = C.prompts((40, 16), seed=11)
    streams = {}
    for mesh_n in (1, 2):
        eng = _engine("dsa", "sync", mesh=mesh_n, mem=mem)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, 12))
        streams[mesh_n] = C.drain(eng, 14)
        assert eng.hetero.profiler.offload_steps > 0
        assert eng.hetero.profiler.local_steps > 0
    assert streams[1] == streams[2]
    assert all(len(v) == 12 for v in streams[1].values())


def test_view_buckets_align_to_mesh_granularity():
    """pow2-bucketed views are multiples of main_mesh * page (the granule
    takes the requested mesh, 4, though it clamps to one device), and the
    smallest bucket decodes through the mesh."""
    eng = _engine("dsa", "sync", mesh=4, max_len=512)
    ps = eng.hetero.sel.page
    assert (eng._gran // 4) % (4 * ps) != 0       # the bucket it would trip
    for needed in range(1, eng.sc.max_len + 1, 7):
        vl = eng._view_len(needed)
        assert vl % (4 * ps) == 0 and vl % (4 * SC["kv_page_size"]) == 0
    rng = np.random.default_rng(0)
    eng.submit(Request(0, rng.integers(0, C.setup()[0].vocab_size, size=8),
                       4))
    assert len(C.drain(eng, 6)[0]) == 4
    with pytest.raises(ValueError):
        Engine(C.setup()[1], C.setup()[3], ServeConfig(
            method="dsa", **SC, offload_cfg=OffloadConfig(
                mode="sync", main_mesh=2)), device="cpu", devices=[CPU])
