"""The tensor-parallel split of the port's sharded train step and prefill
over the mesh's ``model`` axis (``train.trainer.sharded_loss_and_grads``,
``models.model.train_loss_tp`` / ``prefill_tp`` over
``sharding.group_view``), on meshes of CPU entries.

Each case (dense with kv sharded and replicated, a ``pod`` axis, MoE
expert-parallel and d_ff-split, audio, vlm with ``positions3`` and
``img_embeds``, FSDP; the Mamba2 hybrid on (1, 4) and (2, 2), with a tail
layer, and with FSDP on its double-stacked body) takes one fp32 step held
against the port's
single-device step and the JAX package's, at
``tests/test_torch_sharded_train.py``'s stated tolerances (loss within
1e-5 relative, moments within 1e-5 abs, the data replicas agreeing; the
split's gradients within 1e-5 of each leaf's largest |g| of one device's at
the same parameters (``_tp_grads``) and its parameters within 1e-5 abs of
one device's AdamW of those gradients (``_applied``); against JAX loss
2e-3 abs, parameters rtol 3e-2 / atol 3e-3), with no ``ShardedTensor.full``
inside the step. The TP
prefill's last logits are held against the single-device prefill within
2e-5 abs (fp32 after two layers whose sums run in another order: observed
4e-6) and each shard's caches against its kv heads of the single-device
caches within 1e-5 abs (the hybrid's SSM states against its heads, x's
conv states against its channels). A split whose gated norm takes each
member's channels alone is caught by more than 100 x those tolerances.

On placeholder cards: the busiest card's FLOPs of one llama smoke step on
(1, 4) equal a formula of the config's shapes, exactly; no card holds a
full-shape tensor of a leaf cut over ``model``; the only all-gather is the
embedding's activations. In a subprocess with 4 host devices the same
step's per-device dot FLOPs under GSPMD (``repro.launch.hlo_walk``) agree
with the port's within 5 %, once three differences are named and taken
out; zamba2's too, once its own three are (the mixers, the replicated
``w_B`` / ``w_C`` products GSPMD cuts over ``model``, the remat's
``w2``). The ring all-reduce is bit-equal to the index-order sum, and
each member sends and receives 2 (n - 1) / n of the tensor.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_sharded_train as T  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.kernels.flash_attention import causal_pairs  # noqa: E402
from repro_torch.launch import op_walk  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.train import TrainConfig, init_opt_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402
from repro_torch.train.trainer import (_tp_group_grads,  # noqa: E402
                                       sharded_loss_and_grads, splits_model)
from repro_torch.weights import from_jax_params  # noqa: E402

torch.set_num_threads(2)
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
FSDP_WIDTH = {"d_ff": 16384, "vocab_size": 32768}   # leaves of 2^22
# zamba2 with a tail: 2 super blocks of 1 Mamba2 layer, then 1 more
HYBRID_TAIL = {"n_layers": 3, "shared_attn_every": 2}
# zamba2's Mamba2 leaves at 2^22: w_x / w_z [2, 4, 512, 1024] (2 super
# blocks of 4 layers), out_proj [2, 4, 1024, 512]; 8 SSM heads of 128, as
# many as smoke's (at 32 the reference's SSD gradient overflows to NaN:
# ROADMAP, "The Mamba2 SSD's masked exponent")
HYBRID_FSDP = {"d_model": 512, "n_layers": 8, "shared_attn_every": 4,
               "ssm_head_dim": 128}
# name: (arch, mesh shape, tp, config changes, fsdp)
CASES = {
    "llama-1x4-kv-replicated": ("llama3.2-1b", (1, 4), 4, {}, None),
    "llama-2x2-kv-sharded": ("llama3.2-1b", (2, 2), 2, {}, None),
    "llama-pod-2x2x2": ("llama3.2-1b", (2, 2, 2), 2, {}, None),
    "granite-1x4-expert-parallel": ("granite-moe-1b-a400m", (1, 4), 4, {},
                                    None),
    "granite-1x8-ff-split": ("granite-moe-1b-a400m", (1, 8), 8, {}, None),
    "musicgen-2x2": ("musicgen-medium", (2, 2), 2, {}, None),
    "qwen2vl-1x4": ("qwen2-vl-72b", (1, 4), 4, {}, None),
    "llama-fsdp-2x2": ("llama3.2-1b", (2, 2), 2, FSDP_WIDTH, True),
    "zamba2-1x4": ("zamba2-7b", (1, 4), 4, {}, None),
    "zamba2-2x2": ("zamba2-7b", (2, 2), 2, {}, None),
    "zamba2-tail-2x2": ("zamba2-7b", (2, 2), 2, HYBRID_TAIL, None),
    "zamba2-fsdp-2x2": ("zamba2-7b", (2, 2), 2, HYBRID_FSDP, True),
}
PREFILL = ("llama-1x4-kv-replicated", "llama-2x2-kv-sharded",
           "granite-1x8-ff-split", "qwen2vl-1x4", "llama-fsdp-2x2",
           "zamba2-1x4", "zamba2-tail-2x2", "zamba2-fsdp-2x2")
B, S = 4, 32


def _case(name):
    arch, shape, tp, kw, fsdp = CASES[name]
    jcfg = jget_arch(arch).smoke().replace(dtype="float32", **kw)
    tcfg = get_arch(arch).smoke().replace(dtype="float32", **kw)
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jcfg, jax.random.PRNGKey(0),
                                            tp=tp))
    mesh = make_mesh(shape, AXES[len(shape)], devices=["cpu"])
    placed = from_jax_params(np_params, device="cpu")
    placed = sh.device_put(placed, sh.make_shardings(
        sh.param_specs(placed, tcfg, mesh, fsdp=fsdp), mesh))
    return jcfg, tcfg, np_params, mesh, tp, placed


def _batch(cfg, seed=0):
    b = T._batch(cfg.vocab_size, B, S, seed=seed)
    if cfg.rope_style == "mrope":
        rng = np.random.default_rng(seed)
        b["positions3"] = rng.integers(0, S, (3, B, S)).astype(np.int32)
        b["img_embeds"] = rng.standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32)
    return b


def _fsdp_leaves(placed):
    return [x for x in leaves(placed) if sh.fsdp_dim(x) is not None]


@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_matches_single_device(case, monkeypatch):
    jcfg, tcfg, np_params, mesh, tp, placed = _case(case)
    assert splits_model(tcfg, mesh)
    assert bool(_fsdp_leaves(placed)) == (CASES[case][4] is True)
    if tcfg.family == "hybrid" and CASES[case][4]:
        # the double-stacked body's FSDP cut lies on d, not a layer axis
        mb = placed["body"]["mamba"]
        assert sh.fsdp_dim(mb["w_x"]) == sh.fsdp_dim(mb["w_z"]) == 2
        assert sh.fsdp_dim(mb["out_proj"]) == 3
    batch = _batch(tcfg)
    tc = TrainConfig(opt=T.OPT, tp=tp)
    p1, s1, st1 = T._port_step(tcfg, tc, from_jax_params(np_params, "cpu"),
                               batch)
    g2 = T._tp_grads(tcfg, tc, placed, T._tb(batch), mesh)
    # the step reads each coordinate's slices where they lie: no
    # ShardedTensor is gathered inside it
    gathered = []
    full = sh.ShardedTensor.full
    monkeypatch.setattr(sh.ShardedTensor, "full",
                        lambda self, *a, **k: gathered.append(self)
                        or full(self, *a, **k))
    p2, s2, st2 = make_train_step(tcfg, tc, mesh)(
        placed, init_opt_state(placed), T._tb(batch))
    monkeypatch.undo()
    assert not gathered
    T._replicas_agree(p2, s2.m, s2.v)
    l1, l2 = float(st1["loss"]), float(st2["loss"])
    assert abs(l2 - l1) / abs(l1) <= 1e-5, (l1, l2)
    assert float(st2["grad_norm"]) == pytest.approx(float(st1["grad_norm"]),
                                                    rel=1e-5)
    got = sh.gather(p2)
    assert T._max_abs(got, T._applied(from_jax_params(np_params, "cpu"),
                                      g2)[0]) <= 1e-5
    assert T._max_abs(sh.gather(s2.m), s1.m) <= 1e-5
    assert T._max_abs(sh.gather(s2.v), s1.v) <= 1e-5
    T._moved(got, from_jax_params(np_params, "cpu"))
    jp, _, jst = T._jax_step(jcfg, JTrainConfig(opt=T.JOPT, tp=tp),
                             np_params, batch)
    assert abs(float(jst["loss"]) - l2) < 2e-3, (float(jst["loss"]), l2)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(leaves(got))
    for (path, want), g in zip(flat, leaves(got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want, np.float32),
                                   rtol=3e-2, atol=3e-3,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", PREFILL)
def test_tp_prefill_matches_single_device(case):
    _, tcfg, np_params, mesh, tp, placed = _case(case)
    b = _batch(tcfg, seed=1)
    kw = {k: torch.from_numpy(b[k]) for k in ("positions3", "img_embeds")
          if k in b}
    tokens = torch.from_numpy(b["tokens"])
    n = mesh.shape["model"]
    with torch.no_grad():
        want, caches = M.prefill(from_jax_params(np_params, "cpu"), tcfg,
                                 tokens, max_len=S + 8, tp=tp, **kw)
        got, parts = M.prefill_tp(sh.group_view(placed, mesh, 0), tcfg,
                                  tokens, max_len=S + 8, tp=tp, **kw)
    assert got.shape == want.shape == (B, tcfg.padded_vocab)
    assert float((got - want).abs().max()) <= 2e-5
    assert len(parts) == n
    hybrid = tcfg.family == "hybrid"
    for m, c in enumerate(parts):
        lo, hi = A.shard_kv_heads(tcfg, tp, (m, n), all_kv=True)
        assert (hi - lo) == (tcfg.n_kv_heads // n if tcfg.kv_shardable(n)
                             else tcfg.n_kv_heads)
        assert c["length"] == S
        for name in (("shared_k", "shared_v") if hybrid else ("k", "v")):
            assert c[name].shape[2] == S + 8
            assert float((c[name] - caches[name][..., lo:hi, :]).abs()
                         .max()) <= 1e-5
        if hybrid:      # the member's heads / x's channels, B and C whole
            _member_states_agree(tcfg, c, caches, m, n)


def _member_states_agree(cfg, part, full, m, n):
    """A member's SSM states (its heads) and conv states (x's: its
    channels; B's and C's whole) within 1e-5 of one device's."""
    H, di = cfg.ssm_heads // n, cfg.d_inner // n
    for name in ("body", "tail"):
        ssm = full[f"{name}_ssm"][..., m * H:(m + 1) * H, :, :]
        conv = full[f"{name}_conv"]
        pairs = [(part[f"{name}_ssm"], ssm),
                 (part[f"{name}_conv"][0],
                  conv[0][..., m * di:(m + 1) * di, :])] + [
            (part[f"{name}_conv"][k], conv[k]) for k in (1, 2)]
        for a, b in pairs:
            assert a.shape == b.shape
            if b.numel():
                assert float((a - b).abs().max()) <= 1e-5


def test_unsplit_families_raise():
    """xLSTM keeps the gathered step (the reference replicates its
    parameters); its TP forward and its split decode step name the
    condition. The hybrid splits."""
    cfg = get_arch("xlstm-125m").smoke()
    with pytest.raises(ValueError, match="transformer families"):
        M.forward_tp([{}], cfg, torch.zeros(1, 4, dtype=torch.int32))
    mesh = make_mesh((1, 2), AXES[2], devices=["cpu"])
    with pytest.raises(ValueError, match="transformer families"):
        M.decode_step_tp({}, cfg, torch.zeros(1, dtype=torch.int32),
                         {"k": None, "v": None, "length": 0}, mesh)
    assert not splits_model(cfg, mesh)
    assert splits_model(get_arch("zamba2-7b").smoke(), mesh)
    assert not splits_model(get_arch("llama3.2-1b").smoke(),
                            make_mesh((2, 1), AXES[2], devices=["cpu"]))


def test_uneven_ssm_heads_raise():
    """zamba2 smoke's 8 SSM heads do not split 3 ways: ``param_specs``
    cuts ``w_dt``'s columns over ``model``, so the placement raises, as
    jit's in_shardings do, and so does the split itself, by name, rather
    than gather."""
    cfg = get_arch("zamba2-7b").smoke()
    mesh = make_mesh((1, 3), AXES[2], devices=["cpu"])
    p = M.init_params(cfg, 0, tp=3, device="cpu")
    with pytest.raises(ValueError, match="does not split 3 ways"):
        sh.device_put(p, sh.make_shardings(sh.param_specs(p, cfg, mesh),
                                           mesh))
    with pytest.raises(ValueError, match="8 SSM heads do not split 3 ways"):
        M.forward_tp([{}] * 3, cfg, torch.zeros(1, 4, dtype=torch.int32))


@pytest.mark.parametrize("case", ["zamba2-1x4", "zamba2-2x2"])
def test_per_member_gated_norm_is_caught(case, monkeypatch):
    """The gated norm's variance runs over all of d_inner. A split whose
    members normalise their own channels alone (each its sum of squares
    times n, in place of the all-reduce) is another model: its prefill
    logits and its loss leave one device's by more than 100 x the parity
    tests' tolerances (2e-5 abs; 1e-5 relative), so those tests can
    fail."""
    _, tcfg, np_params, mesh, tp, placed = _case(case)
    b = _batch(tcfg, seed=1)
    tokens = torch.from_numpy(b["tokens"])
    one = from_jax_params(np_params, "cpu")
    group = sh.group_view(placed, mesh, 0)
    with torch.no_grad():
        want, _ = M.prefill(one, tcfg, tokens, tp=tp)
        loss1 = float(M.train_loss(one, tcfg, T._tb(b), tp=tp))
        right, _ = M.prefill_tp(group, tcfg, tokens, tp=tp)
        monkeypatch.setattr(SSM, "norm_sums",
                            lambda xs: [x * len(xs) for x in xs])
        wrong, _ = M.prefill_tp(group, tcfg, tokens, tp=tp)
        loss2 = float(M.train_loss_tp(group, tcfg, T._tb(b), tp=tp))
    assert float((right - want).abs().max()) <= 2e-5
    assert float((wrong - want).abs().max()) > 100 * 2e-5
    assert abs(loss2 - loss1) / abs(loss1) > 100 * 1e-5


# ---------------------------------------------------------------------------
# the work of one card
# ---------------------------------------------------------------------------

# llama smoke, widths that no two products share (d 128, hd 32, ff / 4 96,
# V / 4 192, kv 64, T 80)
WORK_CFG = dict(dtype="float32", d_ff=384, vocab_size=768)
WB, WS, WN = 2, 40, 4


class _Shapes(op_walk.OpWalk):
    """An op walk that also keeps the shape of every tensor an op makes on
    a card."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for t in torch.utils._pytree.tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and op_walk.device_of(t) \
                    .startswith("cuda"):
                self.shapes.add(tuple(t.shape))
        return out


def _port_walk():
    cfg = get_arch("llama3.2-1b").smoke().replace(**WORK_CFG)
    mesh = make_mesh((1, WN), AXES[2], devices=op_walk.cards(WN))
    with op_walk.placeholders():
        p = M.init_params(cfg, 0, tp=WN, device="cpu")
        placed = sh.device_put(p, sh.make_shardings(
            sh.param_specs(p, cfg, mesh), mesh))
        batch = {k: torch.zeros(WB, WS, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        with _Shapes() as w:
            sharded_loss_and_grads(placed, cfg, TrainConfig(tp=WN), batch,
                                   mesh)
        cut = [(tuple(x.shape), x.dim() == 3) for x in leaves(placed)
               if "model" in x.sharding.spec]
    return cfg, w, cut


def _work(cfg):
    """The busiest card's FLOPs of one step, by term: every weight product
    forward, in the remat's recompute and twice in the backward (its input's
    and its weight's gradient), the lm_head's three times (no remat); the
    flash kernel's causal band forward and in the recompute, its backward a
    plain recompute (two products) and four gradient products of the full
    tile."""
    T_, d, hd, L = WB * WS, cfg.d_model, cfg.hd, cfg.n_layers
    ff, V = cfg.d_ff // WN, cfg.padded_vocab // WN
    H = cfg.padded_heads(WN) // WN
    kv_read = 1          # a shard's q head reads one of the 2 kv heads
    q = o = 2 * T_ * d * H * hd
    kv = 2 * (2 * T_ * d * kv_read * hd)
    w13 = 2 * (2 * T_ * d * ff)
    w2 = 2 * T_ * ff * d
    attn = (2 * 4 * WB * H * hd * causal_pairs(WS)
            + 6 * 2 * WB * H * WS * WS * hd)
    return {"q_o_w13": L * 4 * (q + o + w13), "w2": L * 4 * w2,
            "kv": L * 4 * kv, "attention": L * attn,
            "lm_head": 3 * 2 * T_ * d * V,
            # of the terms above, the ones GSPMD does otherwise
            "w2_recompute": L * w2, "kv_weight_grad": L * kv}


def test_busiest_card_work_is_the_shard_formula():
    cfg, w, cut = _port_walk()
    work = _work(cfg)
    total = sum(v for k, v in work.items()
                if k not in ("w2_recompute", "kv_weight_grad"))
    flops = {d: c.flops for d, c in w.costs.items() if d.startswith("cuda")}
    assert len(flops) == WN
    # shards 0-2 recompute their w2 in the remat; the last one's recompute
    # stops before it (the last tensor its backward saves)
    assert max(flops.values()) == total
    assert flops[f"cuda:{WN - 1}"] == total - work["w2_recompute"]
    # no card holds a full-shape tensor of a leaf cut over the model axis,
    # nor one layer of it
    full = {s for s, _ in cut} | {s[1:] for s, stacked in cut if stacked}
    assert not (w.shapes & full), w.shapes & full
    # no parameter is gathered: the one all-gather is the embedding's
    # d-slices, (n - 1) / n of [T, d] fp32 on each card
    for d in flops:
        assert w.costs[d].per_collective["all-gather"] == \
            (WN - 1) * WB * WS * cfg.d_model // WN * 4


_GSPMD = r"""
import json, re
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_arch
from repro.distributed.sharding import param_specs
from repro.launch import hlo_walk
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.train import TrainConfig, init_opt_state, make_train_step
cfg = get_arch("llama3.2-1b").smoke().replace(**CFG)
mesh = make_mesh((1, N), ("data", "model"))
p = JM.init_params(cfg, jax.random.PRNGKey(0), tp=N)
p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), p,
                 param_specs(p, cfg, mesh))
batch = {k: jnp.zeros((WB, WS), jnp.int32) for k in ("tokens", "labels")}
step = make_train_step(cfg, TrainConfig(tp=N), mesh)
hlo = step.lower(p, init_opt_state(p), batch).compile().as_text()
dot = hlo_walk._dot_flops
kv = cfg.n_kv_heads * cfg.hd

def dims(spec):
    m = re.search(r"\[([\d,]*)\]", spec or "")
    return [int(x) for x in m.group(1).split(",") if x] if m else []

def kind(ins, shapes):
    ds = [dims(ins.result_spec)] + [dims(shapes.get(o, ""))
                                    for o in hlo_walk._operand_names(ins.rest)]
    return ("attention" if len(ds[0]) == 3 else
            "kv" if any(kv in x for x in ds) else "rest")

out = {"total": hlo_walk.walk(hlo).flops}
for k in ("attention", "kv"):
    hlo_walk._dot_flops = lambda ins, sh, k=k: (dot(ins, sh)
                                                if kind(ins, sh) == k else 0.0)
    out[k] = hlo_walk.walk(hlo).flops
print(json.dumps(out))
"""


def test_card_work_agrees_with_gspmd():
    """The reference's jitted step on a (1, 4) mesh of host devices, its
    per-device dot FLOPs from ``hlo_walk``, against the port's busiest
    card. Three products differ and are named, then taken out of both:
    the attention (the flash kernel's forward counts the causal band, the
    reference's einsums the full tile), the remat's w2 (XLA drops every
    recomputed product the backward does not read; torch's checkpoint
    stops at the last saved tensor, so every shard but the last recomputes
    its w2), and the gradient of the replicated wk / wv (GSPMD all-gathers
    dk / dv and computes a quarter of the weight's rows; the port the
    columns of the kv head its shard reads, a view of its copy). The rest
    (q, wo, w1, w3, w2, their gradients, the lm_head, the k / v forward)
    agrees within 5 %."""
    cfg, w, _ = _port_walk()
    work = _work(cfg)
    busiest = max(c.flops for d, c in w.costs.items()
                  if d.startswith("cuda"))
    port_rest = (busiest - work["attention"] - work["w2_recompute"]
                 - work["kv_weight_grad"])
    env = dict(os.environ, PYTHONPATH=T.__file__.rsplit("/tests/", 1)[0]
               + "/src", XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = (f"CFG = {WORK_CFG!r}\nN, WB, WS = {WN}, {WB}, {WS}\n" + _GSPMD)
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd="/tmp",
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    # the named differences, as the two sides count them
    T_, d = WB * WS, cfg.d_model
    kv = cfg.n_kv_heads * cfg.hd
    assert ref["kv"] == cfg.n_layers * 2 * (2 * (d // WN) * T_ * kv)
    assert ref["attention"] == cfg.n_layers * 8 * (
        2 * WB * (cfg.padded_heads(WN) // WN) * WS * WS * cfg.hd)
    ref_rest = ref["total"] - ref["attention"] - ref["kv"]
    assert abs(port_rest - ref_rest) <= 0.05 * ref_rest, (port_rest, ref)


# zamba2 smoke at 3 rows of 32 (2 SSD chunks): no product of the chunk
# loop or of attention, however XLA flattens it, has d_model (128) in its
# shape, and every weight product has
HYBRID_WORK = dict(dtype="float32")
HB, HS = 3, 32


class _MatMuls(_Shapes):
    """An op walk that also sums, per card, the FLOPs of the 2-D matmuls
    (the weight products; the SSD's and attention's products run as bmm
    and the flash kernel)."""

    def __init__(self):
        super().__init__()
        self.mm = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dev = op_walk.device_of(args[0]) if args and isinstance(
            args[0], torch.Tensor) else None
        before = self.costs[dev].flops if dev else 0.0
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func is torch.ops.aten.mm.default:
            self.mm[dev] = self.mm.get(dev, 0.0) + \
                self.costs[dev].flops - before
        return out


_GSPMD_HYBRID = r"""
import json, re
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import get_arch
from repro.distributed.sharding import param_specs
from repro.launch import hlo_walk
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.train import TrainConfig, init_opt_state, make_train_step
cfg = get_arch("zamba2-7b").smoke().replace(**CFG)
mesh = make_mesh((1, N), ("data", "model"))
p = JM.init_params(cfg, jax.random.PRNGKey(0), tp=N)
p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), p,
                 param_specs(p, cfg, mesh))
batch = {k: jnp.zeros((WB, WS), jnp.int32) for k in ("tokens", "labels")}
step = make_train_step(cfg, TrainConfig(tp=N), mesh)
hlo = step.lower(p, init_opt_state(p), batch).compile().as_text()
dot = hlo_walk._dot_flops

def dims(spec):
    m = re.search(r"\[([\d,]*)\]", spec or "")
    return [int(x) for x in m.group(1).split(",") if x] if m else []

def weights(ins, shapes):
    ds = [dims(ins.result_spec)] + [dims(shapes.get(o, ""))
                                    for o in hlo_walk._operand_names(ins.rest)]
    return any(cfg.d_model in x for x in ds)

out = {"total": hlo_walk.walk(hlo).flops}
hlo_walk._dot_flops = lambda ins, sh: dot(ins, sh) if weights(ins, sh) else 0.0
out["weights"] = hlo_walk.walk(hlo).flops
print(json.dumps(out))
"""


def _hybrid_port_walk():
    cfg = get_arch("zamba2-7b").smoke().replace(**HYBRID_WORK)
    mesh = make_mesh((1, WN), AXES[2], devices=op_walk.cards(WN))
    with op_walk.placeholders():
        p = M.init_params(cfg, 0, tp=WN, device="cpu")
        placed = sh.device_put(p, sh.make_shardings(
            sh.param_specs(p, cfg, mesh), mesh))
        batch = {k: torch.zeros(HB, HS, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        # the step's compute: its one data index's loss and gradients (the
        # gradient reduction after it cuts flat chunks, whose lengths say
        # nothing of a leaf's cut)
        with _MatMuls() as w:
            _tp_group_grads(placed, cfg, TrainConfig(tp=WN), batch, mesh, 0)
        lead = {"body": 2, "tail": 1}
        cut = [tuple(x.shape)[lead[k]:] for k in lead
               for x in leaves(placed[k]["mamba"])
               if "model" in x.sharding.spec]
    return cfg, w, cut


def test_hybrid_card_work_agrees_with_gspmd():
    """zamba2 smoke's step on a (1, 4) mesh: the reference's jitted step
    under GSPMD on 4 host devices (``hlo_walk``'s dot FLOPs) against the
    port's busiest card. Three products differ and are named, then taken
    out of both: the mixers (the SSD chunk loop's and attention's
    products, which XLA contracts and batches otherwise and the flash
    kernel counts by its causal band: on GSPMD's side every dot without
    d_model in its shapes), the replicated ``w_B`` / ``w_C`` products
    (GSPMD cuts their contraction over ``model``, a quarter of d a device
    and an all-reduce of the [T, N] result; the port's members compute
    them whole, as the replicated convs after them), and the remat's
    ``w2`` (torch's checkpoint recomputes up to the last saved tensor;
    XLA drops the product the backward does not read). The rest (every
    other weight product forward, in the recompute and its two gradients,
    and the lm_head) agrees within 5 %. No card holds a full-shape tensor
    of a Mamba2 leaf ``param_specs`` cuts over ``model``."""
    cfg, w, cut = _hybrid_port_walk()
    T_, d, N_ = HB * HS, cfg.d_model, cfg.ssm_state
    n_super, per, tail = M._hybrid_shape(cfg)
    flops = {c: f for c, f in w.mm.items() if c.startswith("cuda")}
    busiest = max(flops, key=lambda c: w.costs[c].flops)
    w2 = 2 * T_ * (cfg.d_ff // WN) * d
    bc = (n_super * per + tail) * 4 * 2 * (2 * T_ * d * N_)
    # shards 0-2 recompute their w2; the last one's recompute stops
    # before it, as llama's
    assert w.costs[f"cuda:{WN - 1}"].flops == \
        w.costs[busiest].flops - n_super * w2
    port_rest = flops[busiest] - n_super * w2 - bc
    env = dict(os.environ, PYTHONPATH=T.__file__.rsplit("/tests/", 1)[0]
               + "/src", XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = (f"CFG = {HYBRID_WORK!r}\nN, WB, WS = {WN}, {HB}, {HS}\n"
            + _GSPMD_HYBRID)
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd="/tmp",
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = json.loads(run.stdout.strip().splitlines()[-1])
    assert abs(port_rest - ref["weights"]) <= 0.05 * ref["weights"], \
        (port_rest, ref)
    # the mixers: the port's busiest card does more of them (the flash
    # backward's plain recompute, the chunk loop's remat), but of the
    # same order
    mixers = w.costs[busiest].flops - flops[busiest]
    assert 0.5 * (ref["total"] - ref["weights"]) < mixers < \
        4 * (ref["total"] - ref["weights"])
    full = set(cut)
    assert full and not (w.shapes & full), w.shapes & full


# ---------------------------------------------------------------------------
# the ring all-reduce and the group operations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_all_reduce_is_the_index_order_sum(n, dtype):
    rng = np.random.default_rng(n)
    xs = [torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
          .to(dtype) for _ in range(n)]
    want = xs[0].float().clone()
    for x in xs[1:]:
        want += x.float()
    outs = col.ring_all_reduce(xs)
    assert len(outs) == n
    for o in outs:
        assert o.dtype == dtype and torch.equal(o, want.to(dtype))
    mean = col.ring_all_reduce(xs, "mean")[n - 1]
    assert torch.equal(mean, (want / n).to(dtype))
    assert torch.equal(col.all_reduce(xs, "mean"), (want / n).to(dtype))
    big = torch.stack(xs).float().amax(0)
    assert torch.equal(col.ring_all_reduce(xs, "max")[0], big.to(dtype))


class _Copies(op_walk.OpWalk):
    """An op walk that also sums the bytes each card sends to another."""

    def __init__(self):
        super().__init__()
        self.sent = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func is torch.ops.aten._to_copy.default:
            src, dst = op_walk.device_of(args[0]), op_walk.device_of(out)
            if src != dst:
                self.sent[src] = self.sent.get(src, 0) + op_walk.nbytes(
                    args[0])
        return out


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_all_reduce_moves_2_n_minus_1_over_n(n):
    with op_walk.placeholders():
        xs = [torch.empty(64, 48, dtype=torch.bfloat16).to(f"cuda:{i}")
              for i in range(n)]
        with _Copies() as w:
            col.ring_all_reduce(xs)
    nbytes = 64 * 48 * 2
    for i in range(n):
        c = w.costs[f"cuda:{i}"]
        assert c.per_collective["all-reduce"] == c.coll_bytes \
            == 2 * (n - 1) * nbytes // n
        assert w.sent[f"cuda:{i}"] == 2 * (n - 1) * nbytes // n


def test_group_operations_are_their_adjoints():
    """Each group operation's backward is its forward's exact adjoint:
    the broadcast's a sum onto the source, the all-reduce's an all-reduce,
    the all-gather's a reduce-scatter (against autograd of the same
    function written with plain ops)."""
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
          for _ in range(3)]
    ws = [torch.from_numpy(rng.standard_normal((3, 12)).astype(np.float32))
          for _ in range(3)]

    def grads(fn):
        ins = [x.clone().requires_grad_() for x in xs]
        return torch.autograd.grad(fn(ins), ins)

    ops = {
        "all_reduce": (lambda a: sum((y * w[:, :4]).sum() for y, w in zip(
            col.group_all_reduce(a), ws)),
            lambda a: sum((sum(a) * w[:, :4]).sum() for w in ws)),
        "all_gather": (lambda a: sum((y * w).sum() for y, w in zip(
            col.group_all_gather(a, -1), ws)),
            lambda a: sum((torch.cat(a, -1) * w).sum() for w in ws)),
        "broadcast": (lambda a: sum((y * w[:, :4]).sum() for y, w in zip(
            col.group_broadcast(a[0], ["cpu"] * 3), ws)) + 0 * sum(
            x.sum() for x in a),
            lambda a: sum((a[0] * w[:, :4]).sum() for w in ws)
            + 0 * sum(x.sum() for x in a)),
    }
    for name, (group, plain) in ops.items():
        for g, p in zip(grads(group), grads(plain)):
            assert torch.allclose(g, p, atol=1e-6), name
    # an unused member's output still reaches every input (a zero gradient)
    ins = [x.clone().requires_grad_() for x in xs]
    got = torch.autograd.grad(col.group_all_reduce(ins)[0].sum(), ins)
    assert all(torch.equal(g, torch.ones(3, 4)) for g in got)
