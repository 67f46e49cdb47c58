"""The reference's optimized train variants in the port's tensor-parallel
step: the Megatron-SP residual (``TrainConfig.sp``, the reference's
``set_sp_residual``) and the MoE's shard-local expert dispatch
(``TrainConfig.ep_local``, its ``set_ep_constraint``), on meshes of CPU
entries and of placeholder cards.

``collectives.group_reduce_scatter`` gives each member its block of the
index-order fp32 sum, and its backward is the all-gather adjoint (fp64
gradcheck over 2 and 4 members). For every case of
``tests/test_torch_tp.py`` the SP step equals the step without it: the
same sums in the same member order, so the loss within 1e-7 relative
(observed: bit-equal), the gradients within 1e-5 of each leaf's largest
|g|, and the parameters after the step within 1e-5 abs of one device's
AdamW of the step's own gradients (``tests/test_torch_tp.py``'s rule);
and it
matches the JAX package's step under ``set_sp_residual(P(("data",),
"model", None))`` (with ``set_ep_constraint("model")`` where the experts
split) in a subprocess with 4 host devices, at
``tests/test_torch_tp.py``'s JAX tolerances (loss 2e-3 abs, parameters
rtol 3e-2 / atol 3e-3). S % n != 0 raises by name; xLSTM and a model
axis of 1 have no SP site and run unchanged. The
shard-local dispatch equals the current route (partials within fp32
rounding, their group sum within 1e-6, the same again on a second run),
with capacity drops and a padded last group, and moves the shard's El x C
rows of d, not t x k.

Against GSPMD: llama smoke on (1, 4) under ``set_sp_residual`` all-gathers
and reduce-scatters as the port's walk does, layer for layer, with no
activation all-reduce on either side; granite smoke's expert products
under ``set_ep_constraint`` have the port's FLOPs. ~60 s in one process.
"""
import contextlib
import json
import os
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_sharded_train as T  # noqa: E402
import test_torch_tp as TP  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import op_walk  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.train import TrainConfig, init_opt_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402
from repro_torch.train.trainer import (_tp_group_grads,  # noqa: E402
                                       sharded_loss_and_grads)
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
SRC = T.__file__.rsplit("/tests/", 1)[0] + "/src"


def _env(n: int):
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")


def _run(code: str, n: int = 4):
    run = subprocess.run([sys.executable, "-c", code], env=_env(n),
                         cwd="/tmp", capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# group_reduce_scatter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_reduce_scatter_is_the_index_order_sum(n, dtype):
    rng = np.random.default_rng(n)
    xs = [torch.from_numpy(rng.standard_normal((2, 3 * n, 5))
                           .astype(np.float32)).to(dtype) for _ in range(n)]
    want = xs[0].float().clone()
    for x in xs[1:]:
        want += x.float()
    outs = col.group_reduce_scatter(xs, 1)
    whole = col.group_all_reduce(xs)
    assert len(outs) == n
    for k, o in enumerate(outs):
        assert o.dtype == dtype and o.shape == (2, 3, 5)
        assert torch.equal(o, want.to(dtype)[:, 3 * k:3 * (k + 1)])
        # each element the all-reduce's, bit for bit
        assert torch.equal(o, whole[k][:, 3 * k:3 * (k + 1)])
    if n == 1:
        assert outs[0] is xs[0]


@pytest.mark.parametrize("n", [2, 4])
def test_group_reduce_scatter_backward_is_the_all_gather(n):
    """fp64 gradcheck, and the gradients against the all-gather adjoint
    written with plain ops: each member's partial reaches every block."""
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((2, 2 * n, 3)))
          .requires_grad_() for _ in range(n)]
    assert torch.autograd.gradcheck(
        lambda *a: tuple(col.group_reduce_scatter(list(a), 1)), xs)
    ws = [torch.from_numpy(rng.standard_normal((2, 2, 3))) for _ in range(n)]
    loss = sum((o * w).sum() for o, w in zip(
        col.group_reduce_scatter(xs, 1), ws))
    got = torch.autograd.grad(loss, xs)
    for g in got:
        assert torch.equal(g, torch.cat(ws, 1))


def test_group_reduce_scatter_walk_labels():
    """Forward: each card receives (n - 1) / n of a partial, labelled
    "reduce-scatter"; backward (its adjoint): as much again, labelled
    "all-gather"."""
    n = 4
    with op_walk.placeholders():
        xs = [torch.empty(2, 8, 16).to(f"cuda:{i}").requires_grad_()
              for i in range(n)]
        with op_walk.OpWalk() as fwd:
            outs = col.group_reduce_scatter(xs, 1)
        with op_walk.OpWalk() as bwd:
            torch.autograd.grad(outs, xs, [torch.ones_like(o) for o in outs])
    got = (n - 1) * 2 * 8 * 16 * 4 // n
    for i in range(n):
        f, b = fwd.costs[f"cuda:{i}"], bwd.costs[f"cuda:{i}"]
        assert f.per_collective["reduce-scatter"] == f.coll_bytes == got
        assert b.per_collective["all-gather"] == b.coll_bytes == got


# ---------------------------------------------------------------------------
# the SP step against the step without it
# ---------------------------------------------------------------------------


def _sp_step(case, **kw):
    """One step of ``case`` (``tests/test_torch_tp.py``'s) with TrainConfig
    changes ``kw`` -> (loss, gradients gathered, parameters gathered after
    the step), the parameters held within 1e-5 abs of one device's AdamW
    of those gradients from the same start (``_applied``, as
    ``tests/test_torch_tp.py`` holds the split: Adam's first step, lr g /
    (|g| + eps), turns rounding in a gradient near eps into up to 2 lr, so
    two steps whose gradients differ by rounding are compared by their
    gradients)."""
    _, tcfg, np_params, mesh, tp, placed = TP._case(case)
    batch = T._tb(TP._batch(tcfg))
    tc = TrainConfig(opt=T.OPT, tp=tp, **kw)
    _, g = sharded_loss_and_grads(placed, tcfg, tc, batch, mesh)
    g = sh.gather(g)
    p, _, st = make_train_step(tcfg, tc, mesh)(placed, init_opt_state(placed),
                                               batch)
    T._replicas_agree(p)
    p = sh.gather(p)
    assert T._max_abs(p, T._applied(from_jax_params(np_params, "cpu"),
                                    g)[0]) <= 1e-5
    return float(st["loss"]), g, p


def _close(got, want):
    """SP against without: loss within 1e-7 relative, each gradient leaf
    within 1e-5 of its largest |g|."""
    (l1, g1, _), (l2, g2, _) = got, want
    assert abs(l1 - l2) <= 1e-7 * abs(l2), (l1, l2)
    for a, b in zip(leaves(g1), leaves(g2)):
        assert a.shape == b.shape
        if b.numel():
            assert float((a - b).abs().max()) <= 1e-5 * float(
                b.abs().max()), a.shape


@pytest.mark.parametrize("case", list(TP.CASES))
def test_sp_step_equals_the_tp_step(case):
    _close(_sp_step(case, sp=True), _sp_step(case))


@pytest.mark.parametrize("case", ["granite-1x4-expert-parallel",
                                  "granite-1x8-ff-split"])
def test_local_dispatch_step_equals_the_tp_step(case):
    """Both hints, as the reference's ``optimized-sp`` cell sets them; on
    the d_ff split the dispatch is the current one (``ep_local`` has no
    expert-parallel shard to act on)."""
    _close(_sp_step(case, sp=True, ep_local=True), _sp_step(case))


def test_sp_needs_the_sequence_to_divide():
    _, tcfg, _, mesh, tp, placed = TP._case("llama-1x4-kv-replicated")
    batch = {k: torch.zeros(2, 30, dtype=torch.int32)
             for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match=r"sequence length 30 .* 4 model "
                                         r"shards \(S % n == 0\)"):
        sharded_loss_and_grads(placed, tcfg, TrainConfig(tp=tp, sp=True),
                               batch, mesh)


@pytest.mark.parametrize("arch,shape", [("xlstm-125m", (2, 2)),
                                        ("llama3.2-1b", (4, 1))],
                         ids=["xlstm", "model-axis-1"])
def test_sp_without_a_site_changes_nothing(arch, shape):
    """xLSTM (the reference's forward has no ``_sp`` site in it) and a
    model axis of 1 take the gathered step: with ``sp`` bit-equal."""
    cfg = get_arch(arch).smoke().replace(dtype="float32")
    mesh = make_mesh(shape, TP.AXES[2], devices=["cpu"])
    params = M.init_params(cfg, 0, tp=shape[1], device="cpu")
    batch = T._tb(TP._batch(cfg))
    out = []
    for kw in ({}, {"sp": True, "ep_local": True}):
        placed = sh.device_put(params, sh.make_shardings(
            sh.param_specs(params, cfg, mesh), mesh))
        p, _, st = make_train_step(cfg, TrainConfig(tp=shape[1], **kw),
                                   mesh)(placed, init_opt_state(placed),
                                         batch)
        out.append((float(st["loss"]), sh.gather(p)))
        params = M.init_params(cfg, 0, tp=shape[1], device="cpu")
    assert out[0][0] == out[1][0]
    assert T._max_abs(out[0][1], out[1][1]) == 0.0


# ---------------------------------------------------------------------------
# against the JAX package's step under the hints
# ---------------------------------------------------------------------------

JAX_CASES = ("llama-1x4-kv-replicated", "llama-2x2-kv-sharded",
             "granite-1x4-expert-parallel", "musicgen-2x2", "qwen2vl-1x4",
             "zamba2-1x4", "zamba2-2x2")

_JAX_SP = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.distributed.sharding import param_specs
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import model as JM, moe as JMOE
from repro.train import TrainConfig, init_opt_state, make_train_step
from repro.train.optimizer import OptConfig
out = {}
for name, (arch, shape, tp, kw, ep) in CASES.items():
    cfg = get_arch(arch).smoke().replace(dtype="float32", **kw)
    axes = ("data", "model")
    mesh = make_mesh(shape, axes)
    p = JM.init_params(cfg, jax.random.PRNGKey(0), tp=tp)
    p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                     p, param_specs(p, cfg, mesh))
    b = {k: jnp.asarray(v) for k, v in np.load(f"{DIR}/{name}.npz").items()}
    JM.set_sp_residual(P(("data",), "model", None))
    JMOE.set_ep_constraint("model" if ep else None)
    tc = TrainConfig(opt=OptConfig(lr=LR, warmup_steps=1), tp=tp)
    with use_mesh(mesh):
        new, _, st = make_train_step(cfg, tc, mesh)(p, init_opt_state(p), b)
    np.savez(f"{DIR}/{name}_out.npz",
             *[np.asarray(x, np.float32) for x in jax.tree.leaves(new)])
    out[name] = float(st["loss"])
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_sp(tmp_path_factory):
    """The JAX package's step of each ``JAX_CASES`` case under the hints,
    on 4 host devices in one subprocess -> (losses, the output dir)."""
    d = tmp_path_factory.mktemp("jax_sp")
    cases = {}
    for name in JAX_CASES:
        arch, shape, tp, kw, _ = TP.CASES[name]
        cfg = get_arch(arch).smoke()
        np.savez(d / f"{name}.npz", **TP._batch(cfg))
        cases[name] = (arch, shape, tp, kw, MOE.expert_parallel(cfg, tp)
                       if cfg.n_experts else False)
    code = (f"CASES = {cases!r}\nDIR = {str(d)!r}\nLR = {T.LR!r}\n"
            + _JAX_SP)
    return _run(code), d


@pytest.mark.parametrize("case", JAX_CASES)
def test_sp_step_matches_jax_under_the_hints(case, jax_sp):
    losses, d = jax_sp
    loss, _, got = _sp_step(case, sp=True, ep_local=True)
    assert abs(losses[case] - loss) < 2e-3, (losses[case], loss)
    want = np.load(d / f"{case}_out.npz")
    got = leaves(got)
    assert len(want.files) == len(got)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), want[f"arr_{i}"], rtol=3e-2,
                                   atol=3e-3, err_msg=str(i))


# ---------------------------------------------------------------------------
# the shard-local dispatch against the current route
# ---------------------------------------------------------------------------

# (E, k, model ways, capacity factor, tokens): 3 groups of 64, the last
# padded; a factor of 0.5 drops pairs past capacity; at E 8 k 4 over 2
# ways a token sums up to 4 of its shard's experts
DISPATCH = {"E4-k2-n2": (4, 2, 2, 1.25, 150),
            "E4-k2-n4-drops": (4, 2, 4, 0.5, 150),
            "E8-k4-n2": (8, 4, 2, 1.25, 150),
            "E8-k4-n4-drops": (8, 4, 4, 0.5, 150)}


def _dispatch_case(name):
    E, k, n, cf, t = DISPATCH[name]
    cfg = get_arch("granite-moe-1b-a400m").smoke().replace(
        dtype="float32", n_experts=E, experts_per_token=k,
        capacity_factor=cf)
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, t // 3, cfg.d_model)).astype(np.float32))
    return cfg, p, x, n


def _shard(p, m, n):
    El = p["w1"].shape[0] // n
    return {k: v if k == "router" else v[m * El:(m + 1) * El]
            for k, v in p.items()}


def _partials(cfg, p, x, n, local):
    """Each shard's partial and its gradient wrt x (a fixed weighting of the
    partial), in group size 64."""
    out = []
    for m in range(n):
        xx = x.clone().requires_grad_()
        y, _ = MOE.moe_apply(_shard(p, m, n), xx, cfg, group_size=64,
                             shard=(m, n), local=local)
        w = torch.linspace(-1, 1, y.numel()).view_as(y)
        out.append((y.detach(), torch.autograd.grad((y * w).sum(), xx)[0]))
    return out


@pytest.mark.parametrize("name", list(DISPATCH))
def test_local_dispatch_equals_the_current_route(name, monkeypatch):
    cfg, p, x, n = _dispatch_case(name)
    cap = MOE.capacity(64, cfg)
    if name.endswith("drops"):   # some pairs do land past capacity
        probs = torch.softmax(x.reshape(-1, cfg.d_model)[:64] @ p["router"],
                              -1)
        idx = MOE.topk_stable(probs, cfg.experts_per_token)[1].long()
        assert int(torch.bincount(idx.reshape(-1)).max()) > cap
    calls = []
    real = MOE._Dispatch.apply
    monkeypatch.setattr(MOE._Dispatch, "apply",
                        lambda *a: calls.append(1) or real(*a))
    want = _partials(cfg, p, x, n, False)
    assert not calls
    got = _partials(cfg, p, x, n, True)
    assert len(calls) == 3 * n                 # 3 groups a shard
    again = _partials(cfg, p, x, n, True)
    scale = float(sum(y for y, _ in want).abs().max())
    for (a, ga), (b, gb), (c, gc) in zip(got, want, again):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-6 * scale
        assert float((ga - gb).abs().max()) <= 1e-6 * float(gb.abs().max())
        assert torch.equal(a, c) and torch.equal(ga, gc)
    total = sum(y for y, _ in got) - sum(y for y, _ in want)
    assert float(total.abs().max()) <= 1e-6 * scale


def _dispatch_bytes(cfg, k, cf, local, shapes=None):
    """Bytes one card's walk counts for one expert-parallel shard's
    forward (a 128-token group, 4 experts over 4 ways)."""
    c = cfg.replace(experts_per_token=k, capacity_factor=cf)
    with op_walk.placeholders():
        p = {n: v.to("cuda:0") for n, v in _shard(MOE.moe_init(
            torch.Generator().manual_seed(0), c), 0, 4).items()}
        x = torch.empty(1, 128, c.d_model).to("cuda:0")
        with (shapes or op_walk.OpWalk()) as w:
            MOE.moe_apply(p, x, c, shard=(0, 4), local=local)
    return w.costs["cuda:0"].bytes, MOE.capacity(128, c)


def test_local_dispatch_moves_its_slots():
    """At the same capacity C (k 1, factor 2 against k 2, factor 1) the
    local route's bytes grow only by the pairs' ids and weights (under 16
    bytes a pair); the current route's by rows of d (its t x k buffer
    writes and gathers). At k 1, doubling C grows the local route by
    rows of the shard's El x C slots. No tensor the local route makes has
    t x k rows of d."""
    cfg = get_arch("granite-moe-1b-a400m").smoke().replace(
        dtype="float32", n_experts=4)
    d, t = cfg.d_model, 128
    b1, c1 = _dispatch_bytes(cfg, 1, 2.0, True)
    b2, c2 = _dispatch_bytes(cfg, 2, 1.0, True)
    assert c1 == c2 == 64
    assert 0 < b2 - b1 < 16 * t * 64     # of the t x k terms: no row of d
    o1, _ = _dispatch_bytes(cfg, 1, 2.0, False)
    o2, _ = _dispatch_bytes(cfg, 2, 1.0, False)
    assert o2 - o1 >= 3 * t * d * 4      # rows of d for each added pair
    b3, c3 = _dispatch_bytes(cfg, 1, 4.0, True)
    assert c3 == 128
    assert b3 - b1 >= 2 * (c3 - c1) * d * 4      # the slots' rows
    walk = TP._Shapes()
    _dispatch_bytes(cfg, 2, 1.0, True, walk)
    assert (t * 2, d) not in walk.shapes and (t, 2, d) not in walk.shapes
    walk = TP._Shapes()
    _dispatch_bytes(cfg, 2, 1.0, False, walk)
    assert (t, 2, d) in walk.shapes          # the current route's gather


# ---------------------------------------------------------------------------
# the work against GSPMD's
# ---------------------------------------------------------------------------

# llama smoke, 4 kv heads (they shard 4 ways, as the q heads: with 2,
# GSPMD's replicated wk / wv add all-reduces over pairs the port has not,
# a difference ``tests/test_torch_tp.py`` names), fp32
SP_CFG = dict(dtype="float32", d_ff=384, vocab_size=768, n_kv_heads=4)
SB, SS, SN = 2, 40, 4

_GSPMD_SP = r"""
import json, re
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.distributed.sharding import param_specs
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import model as JM
from repro.train import TrainConfig, init_opt_state, make_train_step
cfg = get_arch("llama3.2-1b").smoke().replace(**CFG)
mesh = make_mesh((1, N), ("data", "model"))
p = JM.init_params(cfg, jax.random.PRNGKey(0), tp=N)
p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), p,
                 param_specs(p, cfg, mesh))
batch = {k: jnp.zeros((WB, WS), jnp.int32) for k in ("tokens", "labels")}
JM.set_sp_residual(P(("data",), "model", None))
step = make_train_step(cfg, TrainConfig(tp=N), mesh)
with use_mesh(mesh):
    hlo = step.lower(p, init_opt_state(p), batch).compile().as_text()
print(json.dumps(hlo))
"""

_COLL = re.compile(r"^\s*(?:ROOT )?(%\S+) = (.*?) (all-gather|all-reduce|"
                   r"reduce-scatter|all-to-all|collective-permute)\(")
_SHAPE = re.compile(r"[a-z]+\d*\[([\d,]*)\]")


def _shapes(spec):
    return [tuple(int(x) for x in m.split(",") if x)
            for m in _SHAPE.findall(spec)]


def _gspmd_layer(hlo, full, shard):
    """The collectives of the scanned layer's body (forward, remat
    recompute, backward): per kind, the ops and their activation-sized
    result tensors ``full`` ([B, S, d]). An all-reduce of such a tensor
    whose every reader keeps only the sequence shard (``shard``, [B, S / n,
    d]) or reduces it away is GSPMD's reduce-scatter into the shard: XLA's
    CPU compiler does not rewrite all-reduce + dynamic-slice as a
    reduce-scatter. -> {kind: [ops, tensors]}, the activation all-reduces
    read at full length."""
    lines = hlo.splitlines()
    out = {"all-gather": [0, 0], "reduce-scatter": [0, 0]}
    whole = 0

    def readers(name):
        got = []
        for ln in lines:
            m = re.match(r"^\s*(?:ROOT )?(%\S+) = (\(.*?\)|\S+) ", ln)
            if m and re.search(re.escape(name) + r"[,)]", ln.split("=", 1)[1]):
                if "get-tuple-element(" in ln:
                    got += readers(m.group(1))
                else:
                    got.append(_shapes(m.group(2)))
        return got

    for ln in lines:
        m = _COLL.match(ln)
        if not m or "while/body" not in ln:
            continue
        name, spec, kind = m.groups()
        n_full = sum(s == full for s in _shapes(spec))
        if not n_full:
            continue
        if kind == "all-gather":
            out[kind][0] += 1
            out[kind][1] += n_full
        elif kind == "all-reduce":
            if any(full in r for r in readers(name)):
                whole += n_full
            else:
                out["reduce-scatter"][0] += 1
                out["reduce-scatter"][1] += n_full
    return out, whole


def _port_layer(L):
    """The port's SP step (llama smoke, ``SP_CFG``, ``L`` layers) on 4
    placeholder cards -> (group ops by kind, card 1's collective bytes by
    kind)."""
    cfg = get_arch("llama3.2-1b").smoke().replace(n_layers=L, **SP_CFG)
    mesh = make_mesh((1, SN), TP.AXES[2], devices=op_walk.cards(SN))
    calls = Counter()
    real = col.collective

    @contextlib.contextmanager
    def counted(kind):
        calls[kind] += 1
        with real(kind):
            yield

    col.collective = counted
    try:
        with op_walk.placeholders():
            p = M.init_params(cfg, 0, tp=SN, device="cpu")
            placed = sh.device_put(p, sh.make_shardings(
                sh.param_specs(p, cfg, mesh), mesh))
            batch = {k: torch.zeros(SB, SS, dtype=torch.int32)
                     for k in ("tokens", "labels")}
            with op_walk.OpWalk() as w:
                _tp_group_grads(placed, cfg, TrainConfig(tp=SN, sp=True),
                                batch, mesh, 0)
    finally:
        col.collective = real
    return calls, dict(w.costs["cuda:1"].per_collective)


def test_sp_collectives_agree_with_gspmd():
    """The reference's jitted step under ``set_sp_residual`` on a (1, 4)
    mesh of host devices, its scanned layer's collectives from the HLO,
    against one layer of the port's walk (3 layers' less 2's). Per layer
    both all-gather 6 times (the normed inputs of the two halves, forward
    and in the recompute; the residual gradient's slices, backward) and
    reduce-scatter 5 times (the two partials forward, one in the
    recompute, the two input gradients backward), and neither all-reduces
    an activation it reads whole. The bytes agree once converted (the HLO
    counts each result, the gathered or reduced [B, S, d]; the walk what a
    card receives, (n - 1) / n of it) and one difference is named and
    taken out: GSPMD reduces the input gradient of each projection on its
    own (q, k, v; w1, w3: five tensors in two ops), the port their sum a
    half (two)."""
    code = f"CFG = {SP_CFG!r}\nN, WB, WS = {SN}, {SB}, {SS}\n" + _GSPMD_SP
    hlo = _run(code)
    cfg = get_arch("llama3.2-1b").smoke().replace(**SP_CFG)
    full, shard = (SB, SS, cfg.d_model), (SB, SS // SN, cfg.d_model)
    ref, whole = _gspmd_layer(hlo, full, shard)
    assert whole == 0
    c2, b2 = _port_layer(2)
    c3, b3 = _port_layer(3)
    ops = {k: c3[k] - c2[k] for k in ("all-gather", "reduce-scatter",
                                      "all-reduce")}
    got = {k: b3[k] - b2[k] for k in b3}
    assert ops == {"all-gather": ref["all-gather"][0],
                   "reduce-scatter": ref["reduce-scatter"][0],
                   "all-reduce": 0}, (ops, ref)
    assert ops == {"all-gather": 6, "reduce-scatter": 5, "all-reduce": 0}
    x = SB * SS * cfg.d_model * 4
    per = (SN - 1) / SN
    assert abs(got["all-gather"] - per * ref["all-gather"][1] * x) \
        <= 0.05 * got["all-gather"], (got, ref)
    separate = 3                  # 5 input gradients reduced, against 2
    assert abs(got["reduce-scatter"] - per * (ref["reduce-scatter"][1]
                                              - separate) * x) \
        <= 0.05 * got["reduce-scatter"], (got, ref)
    assert got["all-reduce"] == 0
    # the whole step: the port all-reduces only the replicated leaves'
    # gradients (the norms' weights) and the loss's [B, S] statistics
    assert b3["all-reduce"] < x


_GSPMD_EP = r"""
import json, re
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_arch
from repro.distributed.sharding import param_specs
from repro.launch import hlo_walk
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import model as JM, moe as JMOE
from repro.train import TrainConfig, init_opt_state, make_train_step
cfg = get_arch("granite-moe-1b-a400m").smoke().replace(dtype="float32")
mesh = make_mesh((1, N), ("data", "model"))
p = JM.init_params(cfg, jax.random.PRNGKey(0), tp=N)
p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), p,
                 param_specs(p, cfg, mesh))
batch = {k: jnp.zeros((WB, WS), jnp.int32) for k in ("tokens", "labels")}
JMOE.set_ep_constraint("model")
step = make_train_step(cfg, TrainConfig(tp=N), mesh)
with use_mesh(mesh):
    hlo = step.lower(p, init_opt_state(p), batch).compile().as_text()
dot = hlo_walk._dot_flops

def dims(spec):
    m = re.search(r"\[([\d,]*)\]", spec or "")
    return [int(x) for x in m.group(1).split(",") if x] if m else []

def expert(ins, shapes):
    ds = [dims(ins.result_spec)] + [dims(shapes.get(o, ""))
                                    for o in hlo_walk._operand_names(ins.rest)]
    return any(cfg.d_ff in x for x in ds)

hlo_walk._dot_flops = lambda ins, sh: dot(ins, sh) if expert(ins, sh) else 0.0
print(json.dumps({"experts": hlo_walk.walk(hlo).flops}))
"""


class _ExpertMatMuls(op_walk.OpWalk):
    """An op walk that also sums, per card, the FLOPs of the batched
    products with d_ff in a shape (the experts'; the flash backward's
    products are batched too)."""

    def __init__(self, ff):
        super().__init__()
        self.ff, self.mm = ff, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dev = op_walk.device_of(args[0]) if args and isinstance(
            args[0], torch.Tensor) else None
        before = self.costs[dev].flops if dev else 0.0
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func is torch.ops.aten.bmm.default and any(
                self.ff in t.shape for t in (args[0], args[1], out)):
            self.mm[dev] = self.mm.get(dev, 0.0) + \
                self.costs[dev].flops - before
        return out


def test_expert_products_agree_with_gspmd():
    """granite smoke (E 4, k 2) on a (1, 4) mesh under
    ``set_ep_constraint("model")``: each device's expert products (the
    dots with d_ff in a shape: forward, the remat's recompute and the two
    gradients) equal each of the port's cards' under ``ep_local``,
    exactly: one expert a shard over its C slots, the same C."""
    WB, WS = 2, 64
    code = f"N, WB, WS = {SN}, {WB}, {WS}\n" + _GSPMD_EP
    ref = _run(code)["experts"]
    cfg = get_arch("granite-moe-1b-a400m").smoke().replace(dtype="float32")
    mesh = make_mesh((1, SN), TP.AXES[2], devices=op_walk.cards(SN))
    with op_walk.placeholders():
        p = M.init_params(cfg, 0, tp=SN, device="cpu")
        placed = sh.device_put(p, sh.make_shardings(
            sh.param_specs(p, cfg, mesh), mesh))
        batch = {k: torch.zeros(WB, WS, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        with _ExpertMatMuls(cfg.d_ff) as w:
            _tp_group_grads(placed, cfg, TrainConfig(tp=SN, ep_local=True),
                            batch, mesh, 0)
    C = MOE.capacity(WB * WS, cfg)
    one = 2 * (cfg.n_experts // SN) * C * cfg.d_model * cfg.d_ff
    assert ref == cfg.n_layers * 3 * one * 4      # forward, recompute, 2 grads
    assert len(w.mm) == SN and all(v == ref for v in w.mm.values()), \
        (w.mm, ref)
