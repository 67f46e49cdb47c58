"""The dry run's trip-count scaling (``repro_torch.launch.dryrun`` with
``cut``, ``op_walk.TripScale``), the twin of ``hlo_walk``'s scaling of a
while body by its trip count, on the CPU.

At smoke widths on a (2, 4) mesh of placeholder cards, a cell solved from
walks at small trip counts equals the uncut walk in every count of every
card (FLOPs by dtype, bytes, bytes by collective, argument and peak live
bytes, bytes by op, kernel calls, the gradient exchange) and in its
roofline terms: train, prefill and decode at decode_32k's and long_500k's
layouts for dense (llama), MoE (granite) and the hybrid (zamba2 with four
super blocks and a tail; its prefill and decode peaks within the bound the
record names), xLSTM's train and prefill at two lengths, and a train cell
of 4 micro-steps from 2 and 3. A count that cannot be fit, and a cut that
would shard a parameter otherwise, are refused by name. The depth-scaled
FLOPs of llama's gradient and the length-scaled FLOPs of xLSTM's forward
equal the reference's ``hlo_walk``, which scales the scans by their trip
counts.
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
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun, op_walk  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.trainer import TrainConfig, loss_and_grads  # noqa: E402

TP = 16


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((2, 4), ("data", "model"), devices=op_walk.cards(8))


def _cfg(arch):
    cfg = get_arch(arch).smoke()
    if cfg.family == "hybrid":          # 4 super blocks of 2, a tail of 1
        return cfg.replace(shared_attn_every=2, n_layers=9)
    if cfg.xlstm_pattern:
        return cfg
    return cfg.replace(n_layers=4)


# (arch, kind): (seq_len, batch); decode_32k's layout splits the rows over
# the data axes, long_500k's one row's sequence over the whole mesh
SHAPES = {"train": (64, 2), "prefill": (64, 2), "decode_32k": (1024, 2),
          "long_500k": (8192, 1)}
SMALL = {"train": (16, 2), "prefill": (16, 2)}          # Mamba2: one chunk
CASES = [(a, k) for a in ("llama3.2-1b", "granite-moe-1b-a400m",
                          "zamba2-7b") for k in SHAPES]


def _shape(arch, kind):
    S, B = (SMALL if arch.startswith("zamba2") else {}).get(kind,
                                                             SHAPES[kind])
    if arch.startswith("granite") and kind == "train":
        B = 64                           # whole MoE dispatch groups
    return ShapeConfig("smoke", S, B, "decode" if kind in (
        "decode_32k", "long_500k") else kind)


def _roofline(counts, cfg, shape, chips=8):
    return RL.from_walk(dryrun.costs_of(counts), chips,
                        RL.model_flops_for(cfg, shape)).to_dict()


def _assert_equal(cut, full, exact_peak=True):
    peaks = {k for k in set(cut) | set(full) if k[0] == "peak"}
    diff = {k: (cut.get(k, 0), full.get(k, 0)) for k in set(cut) | set(full)
            if cut.get(k, 0) != full.get(k, 0)
            and (exact_peak or k not in peaks)}
    assert not diff, sorted(diff.items(), key=str)[:12]
    assert all(type(v) is int for v in cut.values())
    if not exact_peak:
        for k in peaks:
            assert full[k] * (1 - dryrun.PEAK_BOUND) <= cut[k] <= full[k], k


@pytest.mark.parametrize("arch,kind", CASES,
                         ids=[f"{a.split('-')[0]}-{k}" for a, k in CASES])
def test_cut_equals_the_uncut_walk(mesh, arch, kind):
    cfg, shape = _cfg(arch), _shape(arch, kind)
    cut, info = dryrun.cell_counts(cfg, shape, mesh, cut=True)
    full, whole = dryrun.cell_counts(cfg, shape, mesh, cut=False)
    assert info["scale"].units, "the case cuts nothing"
    assert len(info["walks"]) == len(info["scale"].terms)
    assert len(whole["walks"]) == 1
    _assert_equal(cut, full, dryrun.peak_exact(cfg, shape))
    a, b = _roofline(cut, cfg, shape), _roofline(full, cfg, shape)
    for k in ("compute_s", "memory_s", "collective_s", "flops_by_dtype",
              "device", "per_collective", "total_flops", "total_bytes"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_xlstm_cut_equals_the_uncut_walk_at_two_lengths(mesh, monkeypatch,
                                                       kind):
    """xLSTM's time loop, its depth kept: the walks at the cut lengths
    (train 4, 5, 6: its backward's bytes grow with the square of the
    length; prefill 2, 3) solve for lengths 8 and 10, each equal to the
    uncut walk."""
    cfg = get_arch("xlstm-125m").smoke()
    seen = []
    real = dryrun._counts
    monkeypatch.setattr(dryrun, "_counts", lambda w, rec: seen.append(
        real(w, rec)) or seen[-1])
    for S in (8, 10):
        shape = ShapeConfig("smoke", S, 2, kind)
        ts = dryrun.trip_scale(cfg, shape)
        assert ts.points() == ([(4,), (5,), (6,)] if kind == "train" else
                               [(2,), (3,)])
        if not seen:
            dryrun.cell_counts(cfg, shape, mesh, cut=True)
        cut = ts.fit(dict(zip(ts.points(), seen)))
        full, _ = dryrun.cell_counts(cfg, shape, mesh, cut=False)
        _assert_equal(cut, full)


def test_accumulation_is_fit_from_two_and_three(mesh, monkeypatch, tmp_path):
    """4 micro-steps from walks at accum 2 and 3, the micro-batch the full
    cell's (accum 1 keeps bf16 gradients and accumulates nothing: another
    program, never a walk point); the record names the cut and its walks."""
    monkeypatch.setattr(dryrun, "pick_accum", lambda *a, **k: 4)
    cfg = get_arch("llama3.2-1b").smoke().replace(n_layers=1)   # not cut
    shape = ShapeConfig("smoke_train", 64, 8, "train")
    full, _ = dryrun.cell_counts(cfg, shape, mesh, cut=False)
    seen = []
    real = dryrun._counts
    monkeypatch.setattr(dryrun, "_counts", lambda w, rec: seen.append(
        real(w, rec)) or seen[-1])
    rec = dryrun.run_cell("llama3.2-1b", "smoke_train", cfg=cfg, shape=shape,
                          mesh=mesh, out_dir=str(tmp_path), force=True)
    assert rec["ok"], rec.get("error")
    ts = dryrun.trip_scale(cfg, shape, 4)
    _assert_equal(ts.fit(dict(zip(ts.points(), seen))), full)
    assert rec["accum"] == 4
    assert rec["cut"] == {"units": {"accum": {"full": 4, "walked": [2, 3]}},
                          "peak": "exact"}
    assert [w["counts"] for w in rec["walks"]] == [{"accum": 2},
                                                    {"accum": 3}]
    assert "trip-count scaled from 2 walks: accum walked at 2, 3, solved " \
        "for 4" in rec["walked"]
    assert rec["grad_reduce"]["data_axis_bytes_in"] == \
        full[("grad_reduce", "data_axis_bytes_in")]
    assert rec["memory_analysis"]["peak_live_bytes"] == full[("peak",
                                                              "cuda:0")]


def test_a_count_that_cannot_be_fit_is_refused_by_name():
    ts = op_walk.TripScale([op_walk.Unit("layers", 5, 2, 4)])
    assert ts.points() == [(2,), (4,)]
    with pytest.raises(ValueError, match="^layers: 'x' cannot be fit"):
        ts.fit({(2,): {"x": 3}, (4,): {"x": 4}})        # 4.5 at 5
    ts = op_walk.TripScale([op_walk.Unit("layers", 16, 2, 3),
                            op_walk.Unit("accum", 8, 2, 3)],
                           [(), ("layers",), ("accum",)])
    with pytest.raises(ValueError, match="^accum: 'y' cannot be fit"):
        ts.fit({(2, 2): {"y": 10}, (3, 2): {"y": 10}, (2, 3): {"y": 8}})
    with pytest.raises(ValueError, match="without"):
        op_walk.TripScale([op_walk.Unit("accum", 8, 2, 3)], [("accum",)])


def test_a_cut_keeps_the_full_configs_parameter_specs(mesh, monkeypatch):
    """FSDP cuts a leaf of 2**22 elements or more: llama's stacked 1024 x
    1024 ``mlp/w1`` is one at 4 layers and not at 2 or 3, so each cut walk
    takes the full config's specs and equals the uncut walk; a spec that
    cuts a dim a trip count sizes is refused, naming the unit."""
    monkeypatch.setattr(sh, "FSDP_THRESHOLD", 0)
    cfg = get_arch("llama3.2-1b").smoke().replace(
        n_layers=4, d_model=1024, d_ff=1024, n_heads=8, n_kv_heads=8,
        head_dim=128)
    shape = ShapeConfig("smoke", 64, 2, "prefill")
    cut, _ = dryrun.cell_counts(cfg, shape, mesh, cut=True)
    full, _ = dryrun.cell_counts(cfg, shape, mesh, cut=False)
    _assert_equal(cut, full)
    assert cut[("collective", "cuda:0", "all-gather")] > 0      # the FSDP
    real = sh.param_specs

    def layer_axis(params, *a, **k):
        specs = real(params, *a, **k)
        specs["layers"]["mlp"]["w1"] = sh.P("data", None, "model")
        return specs

    monkeypatch.setattr(sh, "param_specs", layer_axis)
    with pytest.raises(ValueError, match="^layers: the full config cuts "
                                         "parameter layers/mlp/w1 over "
                                         "data on dim 0"):
        dryrun.cell_counts(cfg, shape, mesh, cut=True)


def test_units_follow_the_reference_scans():
    """The units of zamba2-7b's train_4k (13 super blocks of 6 and a tail
    of 3: the tail is walked whole) and xLSTM's (the time loop, with its
    square), as the full cells' ``trip_scale`` cuts them."""
    z = dryrun.trip_scale(get_arch("zamba2-7b"), dryrun.SHAPES["train_4k"],
                          16)
    assert [(u.name, u.full) for u in z.units] == [("super blocks", 13),
                                                   ("accum", 16)]
    assert z.points() == [(2, 2), (3, 2), (2, 3), (3, 3)]
    # a longer tail is a unit of its own, beside the super blocks
    h = get_arch("zamba2-7b").replace(n_layers=6 * 13 + 5)
    t = dryrun.trip_scale(h, dryrun.SHAPES["prefill_32k"])
    assert [(u.name, u.full) for u in t.units] == [("super blocks", 13),
                                                   ("tail layers", 5)]
    assert t.points() == [(2, 2), (3, 2), (2, 3)]
    assert dryrun._cut(h, dryrun.SHAPES["prefill_32k"], 1, {
        "super blocks": 2, "tail layers": 3})[0].n_layers == 6 * 2 + 3
    x = dryrun.trip_scale(get_arch("xlstm-125m"), dryrun.SHAPES["train_4k"])
    assert x.points() == [(4,), (5,), (6,)]
    assert not dryrun.trip_scale(get_arch("xlstm-125m"),
                                 dryrun.SHAPES["decode_32k"]).units


# ---------------------------------------------------------------------------
# the reference's trip counts
# ---------------------------------------------------------------------------

def _jflops(fn, *a):
    return hlo_walk.walk(jax.jit(fn).lower(*a).compile().as_text()).flops


def _scaled(unit, full, flops_at):
    ts = op_walk.TripScale([op_walk.Unit(unit, full, 2, 3)])
    return ts.fit({p: {"flops": flops_at(*p)} for p in ts.points()})["flops"]


def test_depth_scaled_llama_gradient_flops_equal_the_reference():
    depth, B, S = 4, 2, 64
    cfg = get_arch("llama3.2-1b").smoke()
    jcfg = jget_arch("llama3.2-1b").smoke().replace(n_layers=depth)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S),
                                            dtype=np.int32)

    def port(n):
        p = M.init_params(cfg.replace(n_layers=n), 0, tp=TP, device="cpu")
        t = torch.as_tensor(tok)
        with op_walk.OpWalk() as w:
            loss_and_grads(p, cfg.replace(n_layers=n),
                           TrainConfig(remat=False, tp=TP),
                           {"tokens": t, "labels": t})
        return w.total().flops

    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}
    ref = _jflops(jax.grad(lambda p, b: JM.train_loss(
        p, jcfg, b, remat=False, tp=TP)), jp, jb)
    assert _scaled("layers", depth, port) == ref


def test_length_scaled_xlstm_forward_flops_equal_the_reference():
    S, B = 12, 2
    cfg = get_arch("xlstm-125m").smoke()
    jcfg = jget_arch("xlstm-125m").smoke()

    def port(n):
        p = M.init_params(cfg, 0, tp=TP, device="cpu")
        t = torch.zeros((B, n), dtype=torch.int32)
        with torch.no_grad(), op_walk.OpWalk() as w:
            M.train_loss(p, cfg, {"tokens": t, "labels": t}, remat=False,
                         tp=TP)
        return w.total().flops

    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), tp=TP)
    jb = {k: jnp.zeros((B, S), jnp.int32) for k in ("tokens", "labels")}
    ref = _jflops(lambda p, b: JM.train_loss(p, jcfg, b, remat=False, tp=TP),
                  jp, jb)
    assert _scaled("seq_len", S, port) == ref
