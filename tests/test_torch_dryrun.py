"""The port's dry-run tools (``repro_torch.launch.{specs,roofline,mesh,
dryrun,report}``) against the reference's, on the CPU.

On all ten archs at full width, tp 16: every leaf's shape and dtype from
``param_structs``, ``cache_structs`` (decode_32k's batch and length),
``sparse_structs`` and ``batch_structs`` (each of the four ``SHAPES``);
``pick_accum``, ``model_flops_for`` and ``ideal_memory_bytes`` for each
shape on both production meshes; ``make_production_mesh``'s shape, axes
and distinct devices. Then ``run_cell`` end to end on llama3.2-1b's smoke
config over a (2, 4) mesh of placeholder cards, and ``report`` over the
records it writes.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import roofline as JRL  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig, smoke_shape  # noqa: E402,E501
from repro_torch.launch import dryrun, op_walk, report, specs  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402,E501
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.optimizer import tree_map  # noqa: E402
from repro_torch.train.trainer import TrainConfig, loss_and_grads  # noqa: E402

TP = 16
ALL = sorted(ARCHS)


def _jleaves(tree):
    """{path: (shape, dtype)} of a JAX struct tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _tleaves(tree, path=()):
    """{path: (shape, dtype)} of the port's tree (dicts, tuples, lists);
    a host int leaf (the cache's ``length``) as ((), "int")."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _tleaves(tree[key], path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _tleaves(t, path + (i,)).items()}
    if isinstance(tree, torch.Tensor):
        return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    return {path: ((), type(tree).__name__)}


def _same(port, ref):
    """Equal leaves; the cache's ``length`` is a host int in the port, a
    0-d int32 in the reference."""
    p, r = _tleaves(port), _jleaves(ref)
    if ("length",) in r:
        assert p.pop(("length",)) == ((), "int")
        assert r.pop(("length",)) == ((), "int32")
    assert p == r


@pytest.mark.parametrize("arch", ALL)
def test_param_structs_match(arch):
    _same(specs.param_structs(get_arch(arch), TP),
          jspecs.param_structs(jget_arch(arch), TP))


@pytest.mark.parametrize("arch", ALL)
def test_cache_structs_match(arch):
    sh = SHAPES["decode_32k"]
    _same(specs.cache_structs(get_arch(arch), sh.global_batch, sh.seq_len,
                              TP),
          jspecs.cache_structs(jget_arch(arch), sh.global_batch, sh.seq_len,
                               TP))


@pytest.mark.parametrize("arch", ALL)
def test_sparse_structs_match(arch):
    port = specs.sparse_structs(get_arch(arch), TP)
    ref = jspecs.sparse_structs(jget_arch(arch), TP)
    assert (port is None) == (ref is None)
    if ref is not None:
        _same(port, ref)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ALL)
def test_batch_structs_and_numbers_match(arch, shape):
    """Batch structs, ``pick_accum`` on both production meshes' data
    ways, ``model_flops_for`` and ``ideal_memory_bytes`` at 256 and 512
    chips."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    sh, jsh = TSHAPES[shape], SHAPES[shape]
    _same(specs.batch_structs(cfg, sh), jspecs.batch_structs(jcfg, jsh))
    for dp in (16, 32):
        assert specs.pick_accum(cfg, sh, dp) == jspecs.pick_accum(jcfg, jsh,
                                                                   dp)
    assert RL.model_flops_for(cfg, sh) == JRL.model_flops_for(jcfg, jsh)
    for chips in (256, 512):
        assert RL.ideal_memory_bytes(cfg, sh, chips) == \
            JRL.ideal_memory_bytes(jcfg, jsh, chips)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches(multi_pod, monkeypatch):
    """The reference asks ``jax.make_mesh`` for its shape and axes (512
    host devices would be needed to build it here): the port's mesh has
    them, over that many distinct placeholder cards ``cuda:0 ..``."""
    asked = {}
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes, **kw: asked.update(
                            shape=tuple(shape), axes=tuple(axes)))
    jmesh.make_production_mesh(multi_pod=multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.devices.shape == asked["shape"]
    assert mesh.axis_names == asked["axes"]
    names = [str(d) for d in mesh.devices.flat]
    assert names == [f"cuda:{i}" for i in range(mesh.size)]
    assert len(set(mesh.devices.flat)) == mesh.size
    assert all(d.type == "cuda" for d in mesh.devices.flat)


# ---------------------------------------------------------------------------
# run_cell end to end on a smoke config, and the report
# ---------------------------------------------------------------------------

SMOKE = "llama3.2-1b"


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    cfg = get_arch(SMOKE).smoke()
    mesh = make_mesh((2, 4), ("data", "model"), devices=op_walk.cards(8))
    # the decode cell's cache splits 4 ways into whole 64-token pages
    shapes = {"train": smoke_shape("train"),
              "prefill": smoke_shape("prefill"),
              "decode": ShapeConfig("smoke_decode", 1024, 2, "decode")}
    recs = {kind: dryrun.run_cell(SMOKE, f"smoke_{kind}", cfg=cfg,
                                  shape=shapes[kind], mesh=mesh,
                                  out_dir=str(out), force=True)
            for kind in ("train", "prefill", "decode")}
    return out, cfg, mesh, recs


REF_KEYS = {"flops_per_dev", "hbm_bytes_per_dev", "coll_bytes_per_dev",
            "chips", "model_flops", "compute_s", "memory_s", "collective_s",
            "bottleneck", "useful_ratio", "mfu", "per_collective",
            "ideal_memory_s"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_run_cell_writes_an_ok_record(cells, kind):
    out, _, _, recs = cells
    rec = recs[kind]
    assert rec["ok"], rec.get("error")
    path = out / f"{SMOKE}__smoke_{kind}__2x4__baseline.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(
        rec, default=str))
    assert REF_KEYS <= set(rec["roofline"])
    assert rec["roofline"]["chips"] == 8 and rec["roofline"]["mfu"] > 0
    ma = rec["memory_analysis"]
    assert ma["device"] == "cuda:0" and ma["fits"]
    assert ma["peak_live_bytes"] >= ma["argument_size_in_bytes"] > 0
    # data index 0's model group, one launch per shard a layer (train:
    # forward and recompute; decode: each shard's relevancy and apply over
    # its slice of the cache)
    want = {"train": {"flash_attention": 4 * 2 * 2}, "prefill": {
        "flash_attention": 4 * 2}, "decode": {
            "relevancy_topk_candidates": 4 * 2,
            "paged_decode_attention": 4 * 2}}
    assert rec["kernel_calls"] == want[kind]


def test_train_cell_is_the_sharded_step(cells):
    """The train cell walks the tensor-parallel step: data index 0's model
    group does one device's step of its half of the batch, plus the k/v
    projections the shards repeat (2 kv heads do not split 4 ways: each
    shard projects the one its q head reads, so 4 heads' worth against one
    device's 2; forward, recompute and a backward of twice the FLOPs),
    plus the w2 products of all shards but the last in the remat's
    recompute (the recompute stops at the last tensor the backward saves:
    one device skips its w2, a group only its last shard's); the
    embedding's d-slices are all-gathered (the only all-gather: no
    parameter is gathered), the gradients all-reduced over the data
    axes, each coordinate receiving 2 (n - 1) / n of its slice."""
    _, cfg, mesh, recs = cells
    rec = recs["train"]
    coll = rec["collective_bytes"]
    assert coll["all-reduce"] > 0 and coll["reduce-scatter"] > 0
    sh = smoke_shape("train")
    tokens = sh.global_batch // 2 * sh.seq_len
    n = mesh.shape["model"]
    assert coll["all-gather"] == (n - 1) * tokens * cfg.d_model * 2
    assert rec["roofline"]["device"] == "cuda:0"
    with op_walk.placeholders():
        p = tree_map(lambda t: t.to("cuda:0"),
                     M.init_params(cfg, 0, tp=n, device="cpu"))
        b = {k: torch.zeros(sh.global_batch // 2, sh.seq_len,
                            dtype=torch.int32).to("cuda:0")
             for k in ("tokens", "labels")}
        with op_walk.OpWalk() as w:
            loss_and_grads(p, cfg, TrainConfig(tp=n), b)
    # data index 1's coordinates receive 2 (n - 1) / n of their gradient
    # slices over the data axis, and one fp32 scalar (the clip scale; the
    # loss's mean goes to the first card alone)
    gr = rec["grad_reduce"]
    assert gr["ring_ratio"] == 1.0 and gr["model_axis_bytes_in"] > 0
    assert gr["data_axis_bytes_in"] == gr["slice_bytes"] + 4
    kv_head = 2 * tokens * cfg.d_model * 2 * cfg.hd      # k and v, a head
    w2 = 2 * tokens * cfg.d_ff // n * cfg.d_model
    assert rec["roofline"]["total_flops"] == w.total().flops + cfg.n_layers * (
        4 * kv_head * (n - cfg.n_kv_heads) + (n - 1) * w2)


@pytest.mark.parametrize("variant,arch", [
    ("optimized-spdecode", SMOKE), ("optimized-idxcache", SMOKE),
    ("optimized-spdecode", "zamba2-7b"), ("optimized-idxcache", "zamba2-7b")],
    ids=["optimized-spdecode", "optimized-idxcache",
         "optimized-spdecode-zamba2", "optimized-idxcache-zamba2"])
def test_decode_variants_run_over_the_model_devices(cells, variant, arch,
                                                    tmp_path):
    """The optimized decode variants run DSA sequence-parallel over data
    index 0's 4 model devices through the decode split (llama, and the
    hybrid at its shared block's sites), one paged launch per shard an
    attention site. The hybrid's step carries no index cache, so its
    idxcache cell fails rather than walk another variant."""
    out, _, mesh, _ = cells
    cfg = get_arch(arch).smoke()
    # 16 pages of 64 tokens: 4 a model device
    rec = dryrun.run_cell(arch, "smoke_decode_1k", variant=variant,
                          cfg=cfg, shape=ShapeConfig("smoke_decode_1k", 1024,
                                                     2, "decode"),
                          mesh=mesh, out_dir=str(tmp_path), force=True)
    assert rec["variant"] == variant
    if arch != SMOKE and variant == "optimized-idxcache":
        assert not rec["ok"] and "no index cache" in rec["error"]
        return
    assert rec["ok"], rec.get("error")
    sites = cfg.n_layers if arch == SMOKE else M._hybrid_shape(cfg)[0]
    # the sequence-parallel top-k and apply: one launch per shard a site
    assert rec["kernel_calls"] == {"relevancy_topk_candidates": 4 * sites,
                                   "paged_decode_attention": 4 * sites}
    assert rec["walked"].startswith("the decode split")


@pytest.mark.parametrize("B,coords", [(2, 4), (1, 8)],
                         ids=["decode_32k-layout", "long_500k-layout"])
def test_decode_cells_walk_the_split(cells, B, coords, tmp_path):
    """A decode cell walks the decode split: with the rows cut over the
    data axes (decode_32k) data index 0's model group, each of its 4
    coordinates over a quarter of the sequence; with one row (long_500k)
    all 8 coordinates, the sequence over (data, model). One relevancy and
    one paged attention launch a coordinate a layer, and the busiest
    card's peak holds its slice of the cache, not the whole."""
    _, cfg, mesh, _ = cells
    S = 8192
    rec = dryrun.run_cell(SMOKE, "smoke_decode_split", cfg=cfg,
                          shape=ShapeConfig("smoke_decode_split", S, B,
                                            "decode"),
                          mesh=mesh, out_dir=str(tmp_path), force=True)
    assert rec["ok"], rec.get("error")
    assert rec["walked"].startswith("the decode split")
    assert rec["kernel_calls"] == {
        "relevancy_topk_candidates": coords * cfg.n_layers,
        "paged_decode_attention": coords * cfg.n_layers}
    whole = 2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd * 2
    ma = rec["memory_analysis"]
    assert whole // 8 <= ma["max_peak_live_bytes"] < whole // 2
    assert rec["collective_bytes"]["all-to-all"] > 0   # the (out, lse)


# the baseline decode cell runs the config's method, as the reference's
# make_sparse_fn for any method (the smoke config's 8-token blocks and
# budget of 32 tokens): the kernel it selects with, and its record's name
METHOD_CELLS = {
    "seer": ({"method": "seer"}, "relevancy_topk_candidates",
             "Seer, 8-token blocks, topk 4"),
    "seer-threshold": ({"method": "seer", "selection": "threshold"},
                       "relevancy_topk_candidates",
                       "Seer, 8-token blocks, threshold 0.0005"),
    "lserve": ({"method": "lserve"}, "page_minmax",
               "LServe, 8-token pages, 4 a physical page, top 1")}


@pytest.mark.parametrize("method", list(METHOD_CELLS))
@pytest.mark.parametrize("B,coords", [(2, 4), (1, 8)],
                         ids=["decode_32k-layout", "long_500k-layout"])
def test_decode_cells_walk_seer_and_lserve(cells, method, B, coords,
                                           tmp_path):
    """A Seer (top-k or threshold) or LServe decode cell walks the decode
    split with that method (``core.methods.split_sparse``): its record
    names the method, each coordinate of the sequence group launches its
    selection kernel (relevancy; LServe's page_minmax) and paged attention
    once a layer over its slice, and the busiest card's peak holds its
    slice of the cache. The optimized variants run DSA whatever the
    method, as the reference's."""
    _, cfg, mesh, _ = cells
    kw, kernel, name = METHOD_CELLS[method]
    cfg = cfg.replace(memory=cfg.memory.replace(**kw))
    S = 8192
    shape = ShapeConfig("smoke_decode_split", S, B, "decode")
    rec = dryrun.run_cell(SMOKE, "smoke_decode_split", cfg=cfg, shape=shape,
                          mesh=mesh, out_dir=str(tmp_path), force=True)
    assert rec["ok"], rec.get("error")
    assert rec["walked"].startswith("the decode split")
    assert rec["sparse"] == name
    assert rec["kernel_calls"] == {kernel: coords * cfg.n_layers,
                                   "paged_decode_attention":
                                       coords * cfg.n_layers}
    whole = 2 * cfg.n_layers * B * S * cfg.n_kv_heads * cfg.hd * 2
    ma = rec["memory_analysis"]
    assert whole // 8 <= ma["max_peak_live_bytes"] < whole // 2
    rec = dryrun.run_cell(SMOKE, "smoke_decode_split",
                          variant="optimized-spdecode", cfg=cfg, shape=shape,
                          mesh=mesh, out_dir=str(tmp_path), force=True)
    assert rec["ok"] and rec["sparse"] == "DSA, 64-token pages, stateless"


@pytest.mark.parametrize("method", ["seer", "lserve"])
def test_llama_decode_32k_cell_walks_seer_and_lserve(method, tmp_path):
    """llama3.2-1b's decode_32k cell on the 16 x 16 production mesh with
    the config's method Seer or LServe (a config change: the reference's
    dry run has no method flag either): data index 0's model group walks
    the split, one selection kernel and one paged attention launch a
    coordinate a layer, the busiest card holding its 8 rows' 1/16 of the
    sequence. ``pytest -s`` prints the record's summary (terms, peak)."""
    cfg = get_arch(SMOKE)
    cfg = cfg.replace(memory=cfg.memory.replace(method=method))
    rec = dryrun.run_cell(SMOKE, "decode_32k", cfg=cfg,
                          out_dir=str(tmp_path), force=True)
    assert rec["ok"], rec.get("error")
    assert rec["mesh"] == "16x16" and rec["sparse"].startswith(
        {"seer": "Seer", "lserve": "LServe"}[method])
    kernel = "relevancy_topk_candidates" if method == "seer" else \
        "page_minmax"
    assert rec["kernel_calls"] == {kernel: 16 * cfg.n_layers,
                                   "paged_decode_attention":
                                       16 * cfg.n_layers}
    # a card's K / V: 8 rows x 2048 tokens x 8 kv heads x 64, 16 layers
    kv = 2 * cfg.n_layers * 8 * 2048 * cfg.n_kv_heads * cfg.hd * 2
    ma = rec["memory_analysis"]
    assert ma["device"] == "cuda:0" and kv < ma["peak_live_bytes"] < 2 ** 30
    rl = rec["roofline"]
    print(json.dumps({"method": method, "sparse": rec["sparse"],
                      "compute_ms": rl["compute_s"] * 1e3,
                      "memory_ms": rl["memory_s"] * 1e3,
                      "collective_ms": rl["collective_s"] * 1e3,
                      "peak_live_gib": ma["peak_live_bytes"] / 2 ** 30,
                      "walk_s": rec["walk_s"]}))


def test_moe_decode_walk_stands_in_for_the_other_data_indices(cells,
                                                              tmp_path):
    """MoE on decode_32k's layout: the walk runs data index 0's
    ``DecodeGroup``; its dispatch group is the whole batch's, and the other
    data index's router inputs stand in as zeros on its cards."""
    _, _, mesh, _ = cells
    arch = "granite-moe-1b-a400m"
    cfg = get_arch(arch).smoke()
    rec = dryrun.run_cell(arch, "smoke_decode_moe", cfg=cfg,
                          shape=ShapeConfig("smoke_decode_moe", 1024, 2,
                                            "decode"),
                          mesh=mesh, out_dir=str(tmp_path), force=True)
    assert rec["ok"], rec.get("error")
    assert "stand in as zeros" in rec["walked"]
    assert rec["kernel_calls"] == {
        "relevancy_topk_candidates": 4 * cfg.n_layers,
        "paged_decode_attention": 4 * cfg.n_layers}


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b",
                                  "granite-moe-1b-a400m"])
def test_run_cell_other_families(cells, arch, tmp_path):
    """The recurrent families (their states made on the placeholder card:
    ``resolve_device`` lets a card through) and MoE (capacity dispatch
    static under placeholders) walk a prefill cell."""
    _, _, mesh, _ = cells
    rec = dryrun.run_cell(arch, "smoke_prefill", cfg=get_arch(arch).smoke(),
                          shape=smoke_shape("prefill"), mesh=mesh,
                          out_dir=str(tmp_path), force=True)
    assert rec["ok"], rec.get("error")
    assert rec["roofline"]["device"] == "cuda:0"


def test_variant_hints_are_recorded_not_applied(cells):
    """The ``optimized-sp`` train cell records the hint it applies
    (``hints_applied``: the Megatron-SP residual; no experts, so no
    dispatch hint) and walks it: the activations' all-reduces become
    reduce-scatters and all-gathers, so every all-reduce byte left is the
    gradient exchange (each of the 8 cards receiving what data index 1's
    first one does, by symmetry) or the loss's [B, S] statistics, under
    one activation's bytes; the FLOPs and the flash launches are the
    baseline's, the bytes fewer."""
    out, cfg, mesh, recs = cells
    rec = dryrun.run_cell(SMOKE, "smoke_train", variant="optimized-sp",
                          cfg=cfg, shape=smoke_shape("train"), mesh=mesh,
                          out_dir=str(out), force=True)
    assert rec["ok"] and rec["hints_applied"] == ["set_sp_residual"]
    assert "hints_not_applied" not in rec
    base, sh = recs["train"], smoke_shape("train")
    gr = rec["grad_reduce"]
    left = rec["collective_bytes"]["all-reduce"] - mesh.size * (
        gr["data_axis_bytes_in"] + gr["model_axis_bytes_in"])
    act = sh.global_batch // 2 * sh.seq_len * cfg.d_model * 2
    assert 0 <= left < act
    assert base["collective_bytes"]["all-reduce"] - \
        rec["collective_bytes"]["all-reduce"] >= cfg.n_layers * act
    assert rec["collective_bytes"]["reduce-scatter"] > \
        base["collective_bytes"]["reduce-scatter"]
    assert rec["roofline"]["flops_per_dev"] == \
        base["roofline"]["flops_per_dev"]
    assert rec["roofline"]["hbm_bytes_per_dev"] < \
        base["roofline"]["hbm_bytes_per_dev"]
    assert rec["kernel_calls"] == base["kernel_calls"]


def test_moe_optimized_cell_walks_the_local_dispatch(cells, tmp_path,
                                                     monkeypatch):
    """granite smoke's ``optimized`` train cell (4 experts over the 4 model
    shards: one each) applies the shard-local dispatch: every MoE group of
    every shard dispatches through it (2 layers, forward and recompute, 4
    shards, 1 group), with the baseline's FLOPs and collectives and fewer
    bytes and a lower peak."""
    from repro_torch.models import moe

    _, _, mesh, _ = cells
    arch = "granite-moe-1b-a400m"
    cfg = get_arch(arch).smoke()
    shape = ShapeConfig("smoke_train", 64, 64, "train")   # whole groups
    recs, calls = {}, []
    real = moe._Dispatch.apply
    monkeypatch.setattr(moe._Dispatch, "apply",
                        lambda *a: calls.append(1) or real(*a))
    for variant in ("baseline", "optimized"):
        recs[variant] = dryrun.run_cell(arch, "smoke_train", variant=variant,
                                        cfg=cfg, shape=shape, mesh=mesh,
                                        out_dir=str(tmp_path), force=True)
        assert recs[variant]["ok"], recs[variant].get("error")
        if variant == "baseline":
            assert not calls and "hints_applied" not in recs[variant]
    base, opt = recs["baseline"], recs["optimized"]
    assert opt["hints_applied"] == ["set_ep_constraint"]
    assert len(calls) == cfg.n_layers * 2 * mesh.shape["model"]
    assert opt["collective_bytes"] == base["collective_bytes"]
    assert opt["roofline"]["flops_per_dev"] == \
        base["roofline"]["flops_per_dev"]
    assert opt["roofline"]["hbm_bytes_per_dev"] < \
        base["roofline"]["hbm_bytes_per_dev"]
    assert opt["memory_analysis"]["peak_live_bytes"] < \
        base["memory_analysis"]["peak_live_bytes"]


def test_report_reads_the_records(cells, capsys):
    out, _, _, _ = cells
    rows = report.load("2x4", "baseline", str(out))
    assert sorted(r["shape"] for r in rows) == [
        "smoke_decode", "smoke_prefill", "smoke_train"]
    assert report.summary(rows).startswith("3 ok / 0 failed")
    worst, collective, paperish = report.pick_hillclimb(rows)
    assert worst is None and paperish is None
    # the prefill now splits over the model axis: two all-reduces of the
    # activations a layer against a forward's FLOPs
    assert collective["shape"] == "smoke_prefill"
    report.main(["--mesh", "2x4", "--dir", str(out)])
    text = capsys.readouterr().out
    for kind in ("train", "prefill", "decode"):
        assert f"| {SMOKE} | smoke_{kind} |" in text


def test_stateful_cached_decode_steps_equal_the_stateless():
    """The idxcache variant's path, with values: ``decode_step`` with
    ``make_sparse_fn_cached`` (its index cache kept as per-shard stacks
    across steps) gives the logits of the stateless
    ``make_sparse_fn_distributed`` over two steps on two CPU shards, at
    one-token pages (the cached fn averages a partial page over its live
    tokens, the stateless one over the whole page, in both packages).
    Before the dry run walked it, the stateful step could not stack the
    per-shard caches it returns."""
    import dataclasses

    from repro_torch.core.methods import dsa
    from repro_torch.launch.mesh import mesh_from_devices

    cfg = dataclasses.replace(get_arch(SMOKE).smoke(), dtype="float32")
    mem, tp, page, S = cfg.memory, 4, 1, 64
    p = M.init_params(cfg, 0, tp=tp, device="cpu")
    sp = dsa.dsa_init(cfg, mem, 1, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (2, 21), generator=gen)
    _, ca = M.prefill(p, cfg, tok, max_len=S, tp=tp)
    cb = dict(ca, k=ca["k"].clone(), v=ca["v"].clone())
    kidx = torch.stack([dsa._matmul_promoted(
        ca["k"][i].reshape(2, S, -1), sp["wk_idx"][i]).float().reshape(
        2, S // page, page, -1).sum(2) for i in range(cfg.n_layers)])
    devs = mesh_from_devices(["cpu", "cpu"])
    stateless = dsa.make_sparse_fn_distributed(cfg, mem, devs, tp=tp,
                                               page=page)
    cached = dsa.make_sparse_fn_cached(cfg, mem, devs, tp=tp, page=page)
    state = {"p": sp, "kidx_sum": kidx}
    for _ in range(2):
        t = torch.randint(0, cfg.vocab_size, (2,), generator=gen)
        la, ca = M.decode_step(p, cfg, t, ca, tp=tp, sparse_fn=stateless,
                               sparse_params=sp)
        lb, cb, state = M.decode_step(p, cfg, t, cb, tp=tp,
                                      sparse_fn=cached, sparse_params=state,
                                      sparse_stateful=True)
        assert float((la - lb).abs().max()) < 1e-4
        assert len(state["kidx_sum"]) == 2
        assert state["kidx_sum"][0].shape == (cfg.n_layers, 2,
                                              S // page // 2, mem.index_dim)
