"""The port's sharded train step, compressed pod sync and resharding
checkpoints on meshes of CPU entries, held against the port's own
single-device step and against the JAX package.

Tolerances (fp32 throughout; ``OPT``'s lr of 1e-3 from step 1, so an
update is two orders of magnitude above the parameter tolerance and a step
that skipped a shard or a replica fails; at 1e-2 Adam's first step,
g / (|g| + eps), turns fp32 rounding in gradients near eps into parameter
differences of 3e-5):
- sharded vs the port's single-device step: loss within 1e-5 relative,
  every parameter and moment leaf within 1e-5 abs, every leaf moved by at
  least lr / 2 somewhere, and every shard equal to its slice of the gathered
  tensor (the data replicas of a leaf agree). Where the step splits its
  products over the ``model`` axis (tensor parallelism: llama, MoE, vlm
  and the hybrid on a ``model`` axis > 1), its fp32 sums run in another
  order than one device's, and Adam's first step, lr g / (|g| + eps), turns that rounding
  into up to 3e-4 where |g| < eps. There the split is held where it
  differs, before Adam (``_tp_grads``): every gradient leaf, at the same
  parameters as one device's, within 1e-5 of that leaf's largest |g|; and
  its update after (``_applied``): every parameter within 1e-5 abs of one
  device's AdamW of the split's gradients. Loss, grad norm and moments keep
  1e-5 against one device's step. The gathered step (xLSTM, and every
  family on a ``model`` axis of 1) computes each data index's
  rows as one device does, and is held to 1e-5 on its parameters against
  one device's step (``test_gathered_step_matches_single_device``);
- sharded vs the JAX single-device step: the reference test's own
  tolerances (``tests/test_distributed.py``): loss 2e-3 abs, parameters
  rtol 3e-2 / atol 3e-3;
- the pod sync vs the reference's ``make_train_step(cfg, tc, mesh)``: loss
  within 1e-5 relative; the residual within 1e-6 abs except where a
  gradient element sits within rounding distance of a quantization boundary
  on one side and not the other: at most 0.1 % of all elements, each by at
  most one quantum (int8: the leaf's scale, max|g| / 127; bf16: one bf16
  ulp, 2^-7 |g|); parameters within 1e-5 abs except at two kinds of
  element where Adam's first step, lr g / (|g| + eps), does not follow the
  gradient smoothly: the flipped ones (a compressed gradient of 0 on one
  side and one quantum on the other turns the step on or off) and those
  whose clipped gradient is below 100 eps = 1e-6 (there the two packages'
  fp32 rounding moves g / (|g| + eps) by up to 6 %). There within 2 lr; the
  parameters more than 1e-5 apart are at most 0.1 % of the elements.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import init_opt_state as jinit_opt  # noqa: E402
from repro.train import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.elastic import plan_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig,  # noqa: E402
                               Trainer, init_opt_state, loss_and_grads,
                               make_train_step)
from repro_torch.train.optimizer import adamw_update, leaves  # noqa: E402
from repro_torch.train.trainer import (data_parts,  # noqa: E402
                                       sharded_loss_and_grads, splits_model)
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
TP = 4
LR = 1e-3
OPT, JOPT = (OptConfig(lr=LR, warmup_steps=1),
             JOptConfig(lr=LR, warmup_steps=1))
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


class FakeMesh:
    """Shape-only mesh: the reference's step reads only ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = shape


def _mesh(name):
    return make_mesh(*MESHES[name], devices=["cpu"])


@pytest.fixture(scope="module")
def smoke32():
    jcfg = jget_arch("llama3.2-1b").smoke().replace(dtype="float32")
    tcfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    return jcfg, tcfg, jax.tree.map(np.asarray, jparams)


def _batch(vocab, B, S=32, accum=1, seed=0):
    b = TokenStream(vocab, S, B, seed=seed).next_batch()
    if accum > 1:
        b = {k: v.reshape(accum, B // accum, S) for k, v in b.items()}
    return b


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def _placed(np_params, cfg, mesh):
    params = from_jax_params(np_params, device="cpu")
    return sh.device_put(params, sh.make_shardings(
        sh.param_specs(params, cfg, mesh), mesh))


def _replicas_agree(*trees):
    """Every shard of every ``ShardedTensor`` equals its slice of the
    gathered tensor: no data replica was left behind by an update."""
    for tree in trees:
        for x in leaves(tree):
            if isinstance(x, sh.ShardedTensor):
                full = x.full()
                for shard, sl in zip(x.shards, x.slices):
                    assert torch.equal(shard, full[sl]), x


def _moved(after, before, lr=LR):
    """Every leaf moved by at least lr / 2 somewhere: the step wrote it (a
    leaf of no elements, as zamba2 smoke's empty tail, has nothing to
    move)."""
    for a, b in zip(leaves(after), leaves(before)):
        if not a.numel():
            continue
        assert float((a.float() - b.float()).abs().max()) >= lr / 2, a.shape


def _port_step(cfg, tc, params, batch, mesh=None):
    step = make_train_step(cfg, tc, mesh)
    p, state, stats = step(params, init_opt_state(params, tc.compress),
                           _tb(batch))
    _replicas_agree(p, state.m, state.v)
    return sh.gather(p), state, stats


def _jax_step(jcfg, jtc, np_params, batch, mesh=None):
    jp = jax.tree.map(jnp.asarray, np_params)
    step = jmake_step(jcfg, jtc, mesh)
    p, state, stats = step(jp, jinit_opt(jp, jtc.compress),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    return p, state, stats


def _max_abs(a, b):
    return max((float((x.float() - y.float()).abs().max())
                for x, y in zip(leaves(a), leaves(b)) if x.numel()),
               default=0.0)


def _tp_grads(cfg, tc, placed, batch, mesh):
    """The split step's gradients at ``placed``, gathered, held against one
    device's gradients at the same parameters: every leaf within 1e-5 of
    its largest |g| (measured: at most 1e-6; a leaf of no elements, as
    zamba2 smoke's empty tail, has none to hold)."""
    _, want = loss_and_grads(sh.gather(placed), cfg, tc, batch)
    _, got = sharded_loss_and_grads(placed, cfg, tc, batch, mesh)
    got = sh.gather(got)
    for a, b in zip(leaves(got), leaves(want)):
        assert a.shape == b.shape
        if not b.numel():
            continue
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), \
            a.shape
    return got


def _applied(before, grads, state=None):
    """One device's AdamW of ``grads`` from ``before`` (a copy), from
    ``state`` or a fresh one -> (params, state)."""
    p = _clone(before)
    p, state, _ = adamw_update(grads, state or init_opt_state(p), p, OPT)
    return p, state


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_step_matches_single_device(smoke32, mesh_name, accum):
    """One step on a (2, 4) / (2, 2, 2) mesh == the same step on one device:
    the port's, and the JAX package's within the reference test's
    tolerances."""
    jcfg, tcfg, np_params = smoke32
    mesh = _mesh(mesh_name)
    batch = _batch(tcfg.vocab_size, 4 * accum, accum=accum)
    tc = TrainConfig(opt=OPT, tp=TP, accum=accum)
    single = from_jax_params(np_params, device="cpu")
    p1, s1, st1 = _port_step(tcfg, tc, single, batch)
    placed = _placed(np_params, tcfg, mesh)
    g2 = _tp_grads(tcfg, tc, placed, _tb(batch), mesh)
    p2, s2, st2 = _port_step(tcfg, tc, placed, batch, mesh)
    l1, l2 = float(st1["loss"]), float(st2["loss"])
    assert abs(l2 - l1) / abs(l1) <= 1e-5, (l1, l2)
    assert float(st2["grad_norm"]) == pytest.approx(float(st1["grad_norm"]),
                                                    rel=1e-5)
    assert _max_abs(p2, _applied(from_jax_params(np_params, "cpu"),
                                 g2)[0]) <= 1e-5
    _moved(p2, from_jax_params(np_params, device="cpu"))
    assert _max_abs(sh.gather(s2.m), s1.m) <= 1e-5
    assert _max_abs(sh.gather(s2.v), s1.v) <= 1e-5
    jp, _, jst = _jax_step(jcfg, JTrainConfig(opt=JOPT, tp=TP, accum=accum),
                           np_params, batch)
    assert abs(float(jst["loss"]) - l2) < 2e-3, (float(jst["loss"]), l2)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(leaves(p2))
    for (path, want), got in zip(flat, leaves(p2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=3e-2, atol=3e-3,
                                   err_msg=jax.tree_util.keystr(path))


# name: (arch, mesh shape, accum): the gathered step's cases
GATHERED = {"llama-4x1": ("llama3.2-1b", (4, 1), 1),
            "llama-2x1-accum2": ("llama3.2-1b", (2, 1), 2),
            "zamba2-2x1": ("zamba2-7b", (2, 1), 1),
            "xlstm-2x2": ("xlstm-125m", (2, 2), 1)}


@pytest.mark.parametrize("case", list(GATHERED))
def test_gathered_step_matches_single_device(case):
    """The gathered step (llama and the hybrid on a ``model`` axis of 1;
    xLSTM on any mesh): each data index gathers the parameters onto its
    first device and runs its rows as one device does; the gradients are
    averaged onto the mesh's first device. One step == one device's:
    every parameter and moment within 1e-5 abs."""
    arch, shape, accum = GATHERED[case]
    cfg, params = _family(arch)
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"])
    assert not splits_model(cfg, mesh)
    batch = _tb(_batch(cfg.vocab_size, 4 * accum, accum=accum))
    tc = TrainConfig(opt=OPT, tp=TP, accum=accum)
    assert len(data_parts(batch, cfg, tc, mesh)) == shape[0]
    p1, s1, st1 = make_train_step(cfg, tc)(_clone(params),
                                           init_opt_state(params), batch)
    placed = sh.device_put(_clone(params), sh.make_shardings(
        sh.param_specs(params, cfg, mesh), mesh))
    p2, s2, st2 = make_train_step(cfg, tc, mesh)(
        placed, init_opt_state(placed), batch)
    _replicas_agree(p2, s2.m, s2.v)
    l1, l2 = float(st1["loss"]), float(st2["loss"])
    assert abs(l2 - l1) / abs(l1) <= 1e-5, (l1, l2)
    assert float(st2["grad_norm"]) == pytest.approx(float(st1["grad_norm"]),
                                                    rel=1e-5)
    assert _max_abs(sh.gather(p2), p1) <= 1e-5
    assert _max_abs(sh.gather(s2.m), s1.m) <= 1e-5
    assert _max_abs(sh.gather(s2.v), s1.v) <= 1e-5
    _moved(p1, params)


def _quantum(mode, g):
    if mode == "int8":
        return torch.full_like(g, float(g.abs().max()) / 127)
    return 2.0 ** -7 * g.abs()


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_pod_sync_matches_reference(smoke32, mode):
    """The compressed pod sync on a (2, 2, 2) mesh against the reference's
    step with a ``pod`` axis of 2."""
    jcfg, tcfg, np_params = smoke32
    mesh = _mesh("2x2x2")
    batch = _batch(tcfg.vocab_size, 4)
    tc = TrainConfig(opt=OPT, tp=TP, compress=mode)
    p, state, st = _port_step(tcfg, tc, _placed(np_params, tcfg, mesh),
                              batch, mesh)
    _moved(p, from_jax_params(np_params, device="cpu"))
    jp, jstate, jst = _jax_step(
        jcfg, JTrainConfig(opt=JOPT, tp=TP, compress=mode), np_params, batch,
        FakeMesh({"pod": 2, "data": 2, "model": 2}))
    assert float(st["loss"]) == pytest.approx(float(jst["loss"]), rel=1e-5)
    # the residual, element by element, against one quantum of the
    # gradient; the parameters, 1e-5 off the flipped elements
    _, g = loss_and_grads(from_jax_params(np_params, device="cpu"), tcfg,
                          tc, _tb(batch))
    flips = loose = total = 0
    for r, jr, gl, pl, jpl, jm in zip(
            leaves(state.residual), jax.tree.leaves(jstate.residual),
            leaves(g), leaves(p), jax.tree.leaves(jp),
            jax.tree.leaves(jstate.m)):
        assert r.dtype == torch.float32 and torch.isfinite(r).all()
        diff = (r - torch.from_numpy(np.array(jr))).abs()
        off = diff > 1e-6
        assert bool((diff[off] <= _quantum(mode, gl.detach())[off] * 1.01
                     + 1e-6).all())
        near_eps = (torch.from_numpy(np.array(jm)).abs() / (1 - OPT.b1)
                    < 100 * OPT.eps)
        pdiff = (pl - torch.from_numpy(np.array(jpl))).abs()
        assert float(pdiff[~(off | near_eps)].max()) <= 1e-5
        assert bool((pdiff[off | near_eps] <= 2 * LR).all())
        flips += int(off.sum())
        loose += int((pdiff > 1e-5).sum())
        total += r.numel()
    assert flips <= 1e-3 * total, (flips, total)
    assert loose <= 1e-3 * total, (loose, total)
    assert any(float(r.abs().max()) > 0 for r in leaves(state.residual))


def test_compress_without_pod_axis_changes_nothing(smoke32):
    _, tcfg, np_params = smoke32
    mesh = _mesh("2x4")
    batch = _batch(tcfg.vocab_size, 4)
    plain, _, st0 = _port_step(tcfg, TrainConfig(opt=OPT, tp=TP),
                               _placed(np_params, tcfg, mesh), batch, mesh)
    comp, state, st1 = _port_step(
        tcfg, TrainConfig(opt=OPT, tp=TP, compress="int8"),
        _placed(np_params, tcfg, mesh), batch, mesh)
    assert float(st0["loss"]) == float(st1["loss"])
    assert all(torch.equal(a, b) for a, b in zip(leaves(plain), leaves(comp)))
    assert all(float(r.abs().max()) == 0 for r in leaves(state.residual))


def test_unsplit_batch_runs_whole(smoke32):
    """A batch that does not divide over the data ways is not split (as
    ``batch_specs`` says) and the step still equals one device's."""
    _, tcfg, np_params = smoke32
    mesh = _mesh("2x2x2")
    batch = _batch(tcfg.vocab_size, 3)
    assert len(data_parts(_tb(batch), tcfg, TrainConfig(), mesh)) == 1
    tc = TrainConfig(opt=OPT, tp=TP)
    p1, _, st1 = _port_step(tcfg, tc, from_jax_params(np_params, "cpu"),
                            batch)
    placed = _placed(np_params, tcfg, mesh)
    g2 = _tp_grads(tcfg, tc, placed, _tb(batch), mesh)
    p2, _, st2 = _port_step(tcfg, tc, placed, batch, mesh)
    assert float(st2["loss"]) == pytest.approx(float(st1["loss"]), rel=1e-5)
    assert _max_abs(p2, _applied(from_jax_params(np_params, "cpu"),
                                 g2)[0]) <= 1e-5


def _family(arch):
    cfg = get_arch(arch).smoke().replace(dtype="float32")
    return cfg, init_params(cfg, 0, tp=TP, device="cpu")


def _clone(tree):
    return sh.tree_map(lambda t: t.detach().clone(), tree)


def test_moe_split_keeps_whole_groups():
    """granite-moe at a batch whose data split keeps whole 2048-token
    dispatch groups (2 x 1024 tokens a data index) equals one device."""
    cfg, params = _family("granite-moe-1b-a400m")
    mesh = _mesh("2x4")
    batch = _tb(_batch(cfg.vocab_size, 4, S=1024))
    tc = TrainConfig(opt=OPT, tp=TP)
    s1 = make_train_step(cfg, tc)
    p1, _, st1 = s1(_clone(params), init_opt_state(params), batch)
    placed = sh.device_put(_clone(params), sh.make_shardings(
        sh.param_specs(params, cfg, mesh), mesh))
    g2 = _tp_grads(cfg, tc, placed, batch, mesh)
    p2, s2, st2 = make_train_step(cfg, tc, mesh)(
        placed, init_opt_state(placed), batch)
    _replicas_agree(p2, s2.m, s2.v)
    assert float(st2["loss"]) == pytest.approx(float(st1["loss"]), rel=1e-5)
    assert _max_abs(sh.gather(p2), _applied(params, g2)[0]) <= 1e-5
    _moved(p1, params)


def test_moe_split_cutting_a_group_raises():
    cfg, params = _family("granite-moe-1b-a400m")
    mesh = _mesh("2x4")
    placed = sh.device_put(params, sh.make_shardings(
        sh.param_specs(params, cfg, mesh), mesh))
    step = make_train_step(cfg, TrainConfig(tp=TP), mesh)
    with pytest.raises(ValueError, match="MoE dispatch group"):
        step(placed, init_opt_state(placed),
             _tb(_batch(cfg.vocab_size, 2, S=32)))


def test_vlm_batch_split():
    """qwen2-vl's positions3 is cut on dim 1 and img_embeds on dim 0 (as
    ``batch_specs`` says); the sharded step equals one device's."""
    cfg, params = _family("qwen2-vl-72b")
    mesh = _mesh("2x2x2")
    rng = np.random.default_rng(0)
    B, S = 4, 32
    batch = _tb(_batch(cfg.vocab_size, B, S))
    batch["positions3"] = torch.from_numpy(
        rng.integers(0, S, (3, B, S)).astype(np.int32))
    batch["img_embeds"] = torch.from_numpy(
        rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32))
    parts = data_parts(batch, cfg, TrainConfig(), mesh)
    assert len(parts) == 4
    assert torch.equal(parts[1]["positions3"], batch["positions3"][:, 1:2])
    assert torch.equal(parts[2]["img_embeds"], batch["img_embeds"][2:3])
    tc = TrainConfig(opt=OPT, tp=TP)
    p1, _, st1 = make_train_step(cfg, tc)(_clone(params),
                                          init_opt_state(params), batch)
    placed = sh.device_put(_clone(params), sh.make_shardings(
        sh.param_specs(params, cfg, mesh), mesh))
    g2 = _tp_grads(cfg, tc, placed, batch, mesh)
    p2, s2, st2 = make_train_step(cfg, tc, mesh)(
        placed, init_opt_state(placed), batch)
    _replicas_agree(p2, s2.m, s2.v)
    assert float(st2["loss"]) == pytest.approx(float(st1["loss"]), rel=1e-5)
    assert _max_abs(sh.gather(p2), _applied(params, g2)[0]) <= 1e-5
    _moved(p1, params)


def test_checkpoint_elastic_reshard(tmp_path):
    """A checkpoint written from a (2, 4) mesh restores onto a (4,) mesh."""
    mesh8 = make_mesh((2, 4), ("data", "model"), devices=["cpu"])
    w = sh.device_put(torch.arange(64, dtype=torch.float32).reshape(8, 8),
                      sh.NamedSharding(mesh8, sh.P("data", "model")))
    d = str(tmp_path)
    ckpt.save(d, 1, {"w": w})
    mesh4 = make_mesh((4,), ("model",), devices=["cpu"])
    tgt = sh.NamedSharding(mesh4, sh.P(None, "model"))
    back = ckpt.restore(d, 1, {"w": torch.zeros(8, 8)}, shardings={"w": tgt})
    assert back["w"].sharding == tgt
    assert torch.equal(back["w"].full(), w.full())
    for i, shard in enumerate(back["w"].shards):
        assert torch.equal(shard, w.full()[:, 2 * i:2 * i + 2])
    # the sharded tree as the structure to restore into
    again = ckpt.restore(d, 1, {"w": w})
    assert torch.equal(again["w"], w.full())


def test_trainer_resumes_on_another_mesh(smoke32, tmp_path):
    """A Trainer on (2, 4) saves at step 2; a fresh one on plan_mesh's
    smaller (1, 2) mesh restores and takes step 3, equal to an
    uninterrupted single-device run's step 3."""
    _, tcfg, np_params = smoke32
    batches = [_tb(_batch(tcfg.vocab_size, 4, seed=s)) for s in range(3)]
    ref = Trainer(tcfg, TrainConfig(opt=OPT, tp=TP),
                  from_jax_params(np_params, device="cpu"))
    want = [ref.train_step(b)["loss"] for b in batches]
    # one device's AdamW of the split steps' gradients
    shadow, shadow_state = from_jax_params(np_params, device="cpu"), None
    tc = TrainConfig(opt=OPT, tp=TP, ckpt_dir=str(tmp_path / "ck"),
                     ckpt_every=2)
    mesh8 = _mesh("2x4")
    tr = Trainer(tcfg, tc, _placed(np_params, tcfg, mesh8), mesh8)
    for b in batches[:2]:
        shadow, shadow_state = _applied(shadow, _tp_grads(
            tcfg, tc, tr.params, b, mesh8), shadow_state)
        tr.train_step(b)
        _replicas_agree(tr.params, tr.opt_state.m, tr.opt_state.v)
    assert ckpt.latest_step(tc.ckpt_dir) == 2
    shape, axes = plan_mesh(2, model_parallel=2)
    mesh2 = make_mesh(shape, axes, devices=["cpu"])
    assert mesh2.shape == {"data": 1, "model": 2}
    fresh = init_params(tcfg, 9, tp=TP, device="cpu")
    tr2 = Trainer(tcfg, tc, sh.device_put(fresh, sh.make_shardings(
        sh.param_specs(fresh, tcfg, mesh2), mesh2)), mesh2)
    assert tr2.step == 2 and tr2.opt_state.step == 2
    shadow, shadow_state = _applied(shadow, _tp_grads(
        tcfg, tc, tr2.params, batches[2], mesh2), shadow_state)
    got = tr2.train_step(batches[2])["loss"]
    _replicas_agree(tr2.params, tr2.opt_state.m, tr2.opt_state.v)
    assert got == pytest.approx(want[2], rel=1e-5)
    assert _max_abs(sh.gather(tr2.params), shadow) <= 1e-5
    assert _max_abs(sh.gather(tr2.opt_state.m), ref.opt_state.m) <= 1e-5
