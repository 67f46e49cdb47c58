"""The port's op walker (``repro_torch.launch.op_walk``) against the
reference's HLO walker (``repro.launch.hlo_walk``), on the CPU.

The ports of ``tests/test_hlo_walk.py``'s six tests build each program in
torch, walk it, and walk the jitted JAX twin with ``hlo_walk``; the FLOP
counts are equal, and equal to the reference test's expectation. Python
loops have no trip counts: a 17-iteration loop is 17 ops. Then llama3.2-1b
``.smoke()``'s ``train_loss`` (tp 16, B 2 x S 64, the same tokens): the
forward, the gradient and the remat gradient, FLOP for FLOP against the
reference's walk; and the same remat step on placeholder CUDA devices
(the kernel route), which differs from the reference by exactly the
flash kernel's causal-pairs records and the backward's extra plain
forward. Bytes, collectives per device on a placeholder (2, 4) mesh, peak
live bytes, and the kernel wrappers' records on both routes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import hlo_walk  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import collectives, sharding as sh  # noqa: E402
from repro_torch.kernels import bm25_topk as bm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import page_pool as pp  # noqa: E402
from repro_torch.kernels import relevancy_topk as rt  # noqa: E402
from repro_torch.kernels import sparse_decode_attention as sda  # noqa: E402
from repro_torch.launch import op_walk  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.optimizer import tree_map  # noqa: E402
from repro_torch.train.trainer import TrainConfig, loss_and_grads  # noqa: E402

L, N, B = 8, 128, 4
EXPECT_FWD = L * 2 * B * N * N  # flops of the matmul chain


# ---------------------------------------------------------------------------
# the ports of tests/test_hlo_walk.py
# ---------------------------------------------------------------------------


def _jchain(remat: bool):
    def f(ws, x):
        def body(x, w):
            fn = (jax.checkpoint(lambda x, w: jnp.tanh(x @ w)) if remat
                  else (lambda x, w: jnp.tanh(x @ w)))
            return fn(x, w), None
        x, _ = jax.lax.scan(body, x, ws)
        return jnp.sum(x)
    return f


def _chain(ws, x, remat: bool = False):
    """The torch twin: L layers of tanh(x @ w) in a Python loop."""
    from torch.utils.checkpoint import checkpoint

    for w in ws:
        if remat:
            x = checkpoint(lambda x, w: torch.tanh(x @ w), x, w,
                           use_reentrant=False)
        else:
            x = torch.tanh(x @ w)
    return x.sum()


@pytest.fixture(scope="module")
def jarrs():
    return jnp.zeros((L, N, N), jnp.float32), jnp.zeros((B, N), jnp.float32)


def _tarrs(x_grad: bool = False):
    ws = torch.zeros(L, N, N, requires_grad=True)
    x = torch.zeros(B, N, requires_grad=x_grad)
    return ws, x


def _jflops(fn, *a):
    return hlo_walk.walk(jax.jit(fn).lower(*a).compile().as_text()).flops


def _walk_flops(fn):
    with op_walk.OpWalk() as w:
        fn()
    return w.total().flops


def test_fwd_flops_exact(jarrs):
    ws, x = _tarrs()
    got = _walk_flops(lambda: _chain(torch.unbind(ws), x))
    assert got == _jflops(_jchain(False), *jarrs) == EXPECT_FWD


def test_grad_flops_3x(jarrs):
    """jax.grad of the scan computes the first layer's dx; torch's autograd
    computes it only when x requires grad: with it the counts are equal,
    without it one dx product is skipped."""
    want = _jflops(jax.grad(_jchain(False)), *jarrs)
    assert want == pytest.approx(3 * EXPECT_FWD, rel=1e-6)
    ws, x = _tarrs(x_grad=True)
    got = _walk_flops(lambda: torch.autograd.grad(
        _chain(torch.unbind(ws), x), (ws, x)))
    assert got == want
    ws, x = _tarrs()
    got = _walk_flops(lambda: torch.autograd.grad(
        _chain(torch.unbind(ws), x), (ws,)))
    assert got == (3 * L - 1) * 2 * B * N * N


def test_remat_grad_flops_4x(jarrs):
    want = _jflops(jax.grad(_jchain(True)), *jarrs)
    assert want == pytest.approx(4 * EXPECT_FWD, rel=1e-6)
    ws, x = _tarrs(x_grad=True)
    got = _walk_flops(lambda: torch.autograd.grad(
        _chain(torch.unbind(ws), x, remat=True), (ws, x)))
    assert got == want


def test_nested_loop_product(jarrs):
    """The reference multiplies nested trip counts; the port's nested
    Python loops run each body as often as they run."""
    outer = 5

    def jf(ws, x):
        def o(x, _):
            def body(x, w):
                return jnp.tanh(x @ w), None
            x, _ = jax.lax.scan(body, x, ws)
            return x, None
        x, _ = jax.lax.scan(o, x, None, length=outer)
        return x

    def tf():
        ws, x = _tarrs()
        for _ in range(outer):
            for w in torch.unbind(ws):
                x = torch.tanh(x @ w)

    got = _walk_flops(tf)
    assert got == _jflops(jf, *jarrs) == outer * EXPECT_FWD


def test_trip_count_is_the_loop_run():
    """The reference recovers a fori_loop's 17 from its HLO; the port's
    17-iteration loop is 17 counted ops."""
    hlo = jax.jit(lambda x: jax.lax.fori_loop(
        0, 17, lambda i, x: x * 1.5, x)).lower(
        jnp.zeros((4,))).compile().as_text()
    comps = hlo_walk.parse_computations(hlo)
    conds = [hlo_walk._attr_comp(i.rest, "condition")
             for c in comps.values() for i in c.instrs if i.op == "while"]
    trips = hlo_walk.trip_count(comps[conds[0]])
    x = torch.zeros(4)
    with op_walk.OpWalk() as w:
        for _ in range(17):
            x = x * 1.5
    assert w.by_op["mul"][0] == trips == 17
    assert w.total().bytes == 17 * 2 * 4 * 4     # read and write 4 fp32


def test_shape_bytes():
    cases = [("bf16[8,4]{1,0}", [((8, 4), torch.bfloat16)]),
             ("(f32[2,2]{1,0}, s32[3]{0})", [((2, 2), torch.float32),
                                             ((3,), torch.int32)]),
             ("pred[10]", [((10,), torch.bool)])]
    for spec, tensors in cases:
        got = sum(op_walk.nbytes(torch.empty(s, dtype=d))
                  for s, d in tensors)
        assert got == hlo_walk._spec_bytes(spec)
    assert op_walk.nbytes(torch.empty(8, 4, dtype=torch.bfloat16)[:, :2]) \
        == 32                                      # a view: its own extent


# ---------------------------------------------------------------------------
# llama3.2-1b smoke train_loss against the reference's walk
# ---------------------------------------------------------------------------

ARCH, TP, SB, SS = "llama3.2-1b", 16, 2, 64
WANT = {"forward": 176_160_768, "grad": 528_482_304,
        "remat grad": 671_088_640}


@pytest.fixture(scope="module")
def llama():
    cfg = get_arch(ARCH).smoke()
    jcfg = jget_arch(ARCH).smoke()
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (SB, SS),
                                            dtype=np.int32)
    return cfg, jcfg, tok


@pytest.fixture(scope="module")
def jcounts(llama):
    _, jcfg, tok = llama
    p = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    batch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    loss = lambda remat: (lambda p, b: JM.train_loss(  # noqa: E731
        p, jcfg, b, remat=remat, tp=TP))
    return {"forward": _jflops(loss(False), p, batch),
            "grad": _jflops(jax.grad(loss(False)), p, batch),
            "remat grad": _jflops(jax.grad(loss(True)), p, batch)}


def _batch(tok, dev=None):
    t = torch.as_tensor(tok)
    t = t if dev is None else t.to(dev)
    return {"tokens": t, "labels": t}


@pytest.mark.parametrize("what", list(WANT))
def test_llama_train_loss_flops_equal_the_reference(llama, jcounts, what):
    cfg, _, tok = llama
    p = M.init_params(cfg, 0, tp=TP, device="cpu")
    batch = _batch(tok)
    with op_walk.OpWalk() as w:
        if what == "forward":
            with torch.no_grad():
                M.train_loss(p, cfg, batch, remat=False, tp=TP)
        else:
            loss_and_grads(p, cfg, TrainConfig(remat=what == "remat grad",
                                               tp=TP), batch)
    assert w.total().flops == jcounts[what] == WANT[what]
    assert not w.kernels                 # the plain route records nothing
    assert list(w.costs) == ["cpu"]


def _fake_step(cfg, tok, remat=True):
    with op_walk.placeholders():
        p = tree_map(lambda t: t.to("cuda:0"),
                     M.init_params(cfg, 0, tp=TP, device="cpu"))
        batch = _batch(tok, "cuda:0")
        with op_walk.OpWalk() as w:
            loss_and_grads(p, cfg, TrainConfig(remat=remat, tp=TP), batch)
    return w


def test_llama_placeholder_step_differs_by_the_flash_formula(llama,
                                                             jcounts):
    """On placeholder cuda:0 the step takes the kernel route: each flash
    call, in the forward and in its remat recompute, records its
    causal-pairs cost where the reference's plain path counts the full
    S x S tile, and ``FlashAttention.backward`` recomputes one more plain
    forward a layer before it differentiates."""
    cfg, _, tok = llama
    w = _fake_step(cfg, tok)
    Hp, hd, n_layers = cfg.padded_heads(TP), cfg.hd, cfg.n_layers
    full = 4 * SB * Hp * SS * SS * hd            # one plain forward's tile
    pairs = 4 * SB * Hp * hd * SS * (SS + 1) // 2
    want = jcounts["remat grad"] + n_layers * (2 * (pairs - full) + full)
    assert w.total().flops == want
    assert [r.name for r in w.kernels] == ["flash_attention"] * 2 * n_layers
    assert {r.device for r in w.kernels} == {"cuda:0"}
    assert set(w.costs) == {"cuda:0"}
    # the backward's recompute runs in fp32, the flash records at bf16
    assert w.total().flops_by_dtype["fp32"] == n_layers * 3 * full


def test_placeholder_walk_repeats_exactly(llama):
    """Two walks of one step count the same, kernel records included (the
    equality the card's roofline phase holds its real walk to)."""
    cfg, _, tok = llama
    a, b = _fake_step(cfg, tok), _fake_step(cfg, tok)
    assert a.total().as_dict() == b.total().as_dict()
    assert a.kernel_keys() == b.kernel_keys()


# ---------------------------------------------------------------------------
# bytes, collectives, live bytes
# ---------------------------------------------------------------------------


def test_views_and_factories_cost_nothing():
    x = torch.zeros(64, 64)
    with op_walk.OpWalk() as w:
        y = x[1:].reshape(-1)
        x.t().unsqueeze(0).expand(3, 64, 64)
        torch.empty(1000)
        torch.arange(100)
        x.view(4096)
    assert w.total().bytes == 0
    with op_walk.OpWalk() as w:
        z = y + 1.0
        x.t().reshape(-1)                # not contiguous: a copy
    assert w.total().bytes == 2 * op_walk.nbytes(z) + 2 * op_walk.nbytes(x)


def test_collectives_per_device_on_a_placeholder_mesh():
    """On a (2, 4) mesh of placeholder cards: the all-gather of a sharded
    tensor lands its remote blocks on the receiving card, an all-reduce
    the other participants' tensors on the first, a ring shift each
    tensor on the next card; a copy from the host counts nothing."""
    mesh = make_mesh((2, 4), ("data", "model"), devices=op_walk.cards(8))
    with op_walk.placeholders():
        x = torch.empty(8, 16, dtype=torch.float32)        # 512 bytes
        st = sh.device_put(x, sh.NamedSharding(mesh, sh.P("model")))
        xs = [torch.empty(32, dtype=torch.bfloat16).to(f"cuda:{i}")
              for i in range(4)]
        with op_walk.OpWalk() as w:
            full = st.full(mesh.device(0))
            red = collectives.all_reduce(xs, "sum")
            shifted = collectives.ring_shift(xs)
            host = torch.empty(8).to(mesh.device(5))
        assert str(full.device) == str(red.device) == "cuda:0"
        # participant j receives participant j - 1's tensor, on its card
        assert [str(t.device) for t in shifted] == ["cuda:0", "cuda:1",
                                                    "cuda:2", "cuda:3"]
        assert str(host.device) == "cuda:5"
    c = w.costs
    block = 2 * 16 * 4                   # a quarter of x's rows
    assert c["cuda:0"].per_collective["all-gather"] == 3 * block
    # the first participant receives the three others, cast to fp32
    assert c["cuda:0"].per_collective["all-reduce"] == 3 * 32 * 4
    for i in range(4):
        assert c[f"cuda:{i}"].per_collective["collective-permute"] == 64
    assert "cuda:5" not in c or c["cuda:5"].coll_bytes == 0
    assert c["cuda:0"].coll_bytes == 3 * block + 3 * 128 + 64
    assert sum(v.coll_bytes for v in c.values()) == \
        sum(sum(v.per_collective.values()) for v in c.values())


def test_peak_live_bytes():
    """Storages count once across views and leave with their last
    tensor: a (1 MiB), b (2 MiB), a view of b, a freed, c (1 MiB)."""
    MiB = 2 ** 20
    with op_walk.OpWalk() as w:
        a = torch.zeros(MiB, dtype=torch.uint8)
        b = torch.zeros(2 * MiB, dtype=torch.uint8)
        v = b[: MiB]
        assert w.live["cpu"] == 3 * MiB
        del a
        c = torch.zeros(MiB, dtype=torch.uint8)
        assert w.live["cpu"] == 3 * MiB
        del b
        assert w.live["cpu"] == 3 * MiB     # the view keeps b's storage
        del v
        assert w.live["cpu"] == MiB
    assert w.peak_live["cpu"] == 3 * MiB
    assert c.numel() == MiB


def test_track_counts_arguments():
    with op_walk.placeholders():
        p = {"w": torch.empty(1000, dtype=torch.bfloat16).to("cuda:2"),
             "b": torch.empty(10).to("cuda:2")}
        with op_walk.OpWalk() as w:
            w.track(p)
    assert w.argument_bytes["cuda:2"] == 2000 + 40
    assert w.peak_live["cuda:2"] >= 2040


# ---------------------------------------------------------------------------
# the kernel wrappers' records
# ---------------------------------------------------------------------------


def _kernel_calls(dev):
    """One call of each wrapper at small shapes, on ``dev``."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.bfloat16: torch.randn(  # noqa: E731
        *s, generator=g).to(dt).to(dev)
    q, keys, w = r(2, 4, 32), r(2, 256, 32), r(2, 4, dt=torch.float32)
    qa, kc, vc = r(2, 8, 64), r(2, 256, 2, 64), r(2, 256, 2, 64)
    pages = torch.tensor([[0, 3, -1], [1, 2, 5]], dtype=torch.int32).to(dev)
    lens = torch.tensor([200, 256], dtype=torch.int32).to(dev)
    tf, dl = r(1, 512, 4, dt=torch.float32), r(1, 512, dt=torch.float32)
    idf = r(1, 4, dt=torch.float32)
    fq, fk = r(2, 96, 8, 64), r(2, 96, 2, 64)
    return {
        "relevancy_topk_candidates": (
            lambda: rt.relevancy_topk_candidates(q, keys, w, block=128),
            rt.cost(q, keys, w, block=128), ((2, 2, 128), (2, 2, 128))),
        "paged_decode_attention": (
            lambda: sda.paged_decode_attention(qa, kc, vc, pages, lens,
                                               page_size=16),
            sda.cost(qa, kc, vc, pages, lens, page_size=16),
            ((2, 8, 64), (2, 8))),
        "page_minmax": (lambda: pp.page_minmax(kc, page_size=16),
                        pp.cost(kc, page_size=16),
                        ((2, 16, 2, 64), (2, 16, 2, 64))),
        "bm25_topk_candidates": (
            lambda: bm.bm25_topk_candidates(tf, dl, idf, block=256, c=8,
                                            valid=300),
            bm.cost(tf, dl, idf, block=256, c=8, valid=300),
            ((1, 2, 8), (1, 2, 8))),
        "flash_attention": (lambda: fa.flash_attention(fq, fk, fk, window=0),
                            fa.cost(fq, fk, fk), ((2, 96, 8, 64),)),
    }


def test_kernel_route_records_cost_and_returns_empty_outputs():
    with op_walk.placeholders():
        calls = _kernel_calls("cuda:1")
        with op_walk.OpWalk() as w:
            outs = {n: f() for n, (f, _, _) in calls.items()}
        devices = {str(t.device) for out in outs.values()
                   for t in (out if isinstance(out, tuple) else (out,))}
    assert devices == {"cuda:1"}
    assert [r.name for r in w.kernels] == list(calls)
    for r, (name, (_, cost, shapes)) in zip(w.kernels, calls.items()):
        assert r.device == "cuda:1" and r.cost == cost
        out = outs[name]
        out = out if isinstance(out, tuple) else (out,)
        assert tuple(tuple(t.shape) for t in out) == shapes
    c = w.costs["cuda:1"]
    assert c.bytes == sum(k.cost.bytes for k in w.kernels)  # nothing else
    assert c.flops == sum(k.cost.operations for k in w.kernels)
    assert sum(fn.launches for fn in ops.KERNELS.values()) == 0


def test_plain_route_records_nothing():
    calls = _kernel_calls("cpu")
    with op_walk.OpWalk() as w:
        for f, _, _ in calls.values():
            f()
    assert not w.kernels and w.total().bytes > 0


def test_kernel_costs_follow_their_formulas():
    """The formulas of ``chip_smoke.py``'s bound column, now the
    wrappers' ``cost``."""
    calls = _kernel_calls("cpu")
    flash = calls["flash_attention"][1]
    assert flash.terms == ((4 * 2 * 8 * 64 * 96 * 97 // 2, "bf16"),)
    assert flash.bytes == (2 * 96 * 8 * 64 * 2 + 2 * 2 * 96 * 2 * 64) * 2
    assert fa.causal_pairs(700, 96) == 96 * 97 // 2 + (700 - 96) * 96
    rel = calls["relevancy_topk_candidates"][1]
    assert rel.terms == ((2 * 2 * 256 * 4 * 32, "bf16"),
                         (2 * 2 * 256 * 4 + 2 * 256 * 7, "fp32"))
    paged = calls["paged_decode_attention"][1]
    assert paged.flops == {"bf16": 2 * 2 * 3 * 16 * 8 * 64,
                           "fp32": 2 * 2 * 3 * 16 * 8 * 64}
    kv = torch.zeros(2, 256, 2, 64, dtype=torch.bfloat16)
    data = sda.cost(torch.zeros(2, 8, 64, dtype=torch.bfloat16), kv, kv,
                    torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2),
                    page_size=16, valid_tokens=40, pages_read=5)
    assert data.terms[0][0] == 2 * 40 * 8 * 64
    assert data.bytes == paged.bytes - (6 - 5) * 16 * 2 * 64 * 2 * 2
    bm25 = calls["bm25_topk_candidates"][1]
    assert bm25.terms == ((300 * (4 + 5 * 4 + 1), "fp32"),)
    assert calls["page_minmax"][1].terms == ((2 * 2 * 256 * 2 * 64, "fp32"),)
    b = flash.bound()
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(
        flash.bytes / 3.35e12 * 1e3)
