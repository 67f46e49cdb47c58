"""The port's sharding rules against the reference's, spec for spec, for all
10 archs on the two production mesh shapes (shape-only meshes, as
``tests/test_sharding.py`` uses), and the placing of tensors on a named mesh
of CPU entries.

The stand-ins are meta tensors of the reference's ``param_structs`` /
``cache_structs`` / ``sparse_structs`` shapes and dtypes; the smoke-width
test shows the port's own ``init_params`` / ``make_cache`` trees have the
stand-ins' key paths, so the specs apply to the real trees. Specs compare
exactly; placed shards are bit-equal slices.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.methods import get_sparse_method as jget_sparse  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch.specs import cache_structs, param_structs  # noqa: E402
from repro_torch.configs import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.elastic import plan_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.model import make_cache  # noqa: E402
from repro_torch.train.trainer import BATCH_DIMS  # noqa: E402


class FakeMesh:
    """Shape-only stand-in (the reference test's): the spec functions of
    both packages read only ``mesh.shape``."""

    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
}
DECODE = [n for n, s in SHAPES.items() if s.kind == "decode"]
ARCH_LIST = sorted(ARCHS)


def _meta(structs):
    """The reference's ShapeDtypeStructs as meta tensors, same nesting."""
    return jax.tree.map(lambda s: torch.empty(
        s.shape, dtype=getattr(torch, np.dtype(s.dtype).name), device="meta"),
        structs)


@functools.lru_cache(maxsize=None)
def _params(arch, tp):
    structs = param_structs(jget_arch(arch), tp=tp)
    return structs, _meta(structs)


@functools.lru_cache(maxsize=None)
def _caches(arch, shape_name, tp):
    s = SHAPES[shape_name]
    structs = cache_structs(jget_arch(arch), s.global_batch, s.seq_len, tp=tp)
    return structs, _meta(structs)


def _flat_jax(specs):
    return jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]


def _flat_port(specs):
    return jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, sh.P))[0]


def _same_specs(port, ref, where):
    a, b = _flat_port(port), _flat_jax(ref)
    assert [p for p, _ in a] == [p for p, _ in b], where
    for (path, got), (_, want) in zip(a, b):
        assert isinstance(got, sh.P), (where, path, got)
        assert tuple(got) == tuple(want), (where, jax.tree_util.keystr(path),
                                           got, want)


def _check_divisible(structs, specs, mesh, where):
    flat_s = jax.tree_util.tree_flatten_with_path(structs)[0]
    flat_p = [p for _, p in _flat_port(specs)]
    assert len(flat_s) == len(flat_p), where
    for (path, leaf), spec in zip(flat_s, flat_p):
        for dim, names in enumerate(spec):
            if names is None:
                continue
            names = (names,) if isinstance(names, str) else names
            ways = int(np.prod([mesh.shape[n] for n in names]))
            assert leaf.shape[dim] % ways == 0, (
                where, path, leaf.shape, dim, spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_param_specs_match_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    structs, meta = _params(arch, mesh.shape["model"])
    _same_specs(sh.param_specs(meta, get_arch(arch), mesh),
                jsh.param_specs(structs, jget_arch(arch), mesh),
                (arch, mesh_name))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_param_specs_divisible(arch, mesh_name):
    mesh = MESHES[mesh_name]
    structs, meta = _params(arch, mesh.shape["model"])
    _check_divisible(structs, sh.param_specs(meta, get_arch(arch), mesh),
                     mesh, (arch, mesh_name, "params"))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", DECODE)
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_cache_specs_match_reference(arch, shape_name, mesh_name):
    mesh = MESHES[mesh_name]
    structs, meta = _caches(arch, shape_name, 16)
    _same_specs(sh.cache_specs(meta, get_arch(arch), TSHAPES[shape_name],
                               mesh),
                jsh.cache_specs(structs, jget_arch(arch), SHAPES[shape_name],
                                mesh),
                (arch, shape_name, mesh_name))


@pytest.mark.parametrize("shape_name", DECODE)
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_cache_specs_divisible(arch, shape_name):
    mesh = MESHES["16x16"]
    structs, meta = _caches(arch, shape_name, mesh.shape["model"])
    specs = sh.cache_specs(meta, get_arch(arch), TSHAPES[shape_name], mesh)
    _check_divisible(structs, specs, mesh, (arch, shape_name, "caches"))


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_batch_specs_match_reference(arch):
    for mesh_name, mesh in MESHES.items():
        for name, shape in SHAPES.items():
            got = sh.batch_specs(get_arch(arch), TSHAPES[name], mesh)
            want = jsh.batch_specs(jget_arch(arch), shape, mesh)
            assert list(got) == list(want), (arch, name, mesh_name)
            for k in want:
                assert isinstance(got[k], sh.P)
                assert tuple(got[k]) == tuple(want[k]), (arch, name, k)
                cut = [i for i, e in enumerate(got[k]) if e is not None]
                if shape.kind == "train" and cut:   # the sharded step's cut
                    assert cut == [BATCH_DIMS[k]], (arch, name, k)


@pytest.mark.parametrize("method", ["dsa", "seer", "lserve"])
@pytest.mark.parametrize("arch", [a for a in ARCH_LIST
                                  if jget_arch(a).family != "ssm"])
def test_method_specs_match_reference(arch, method):
    cfg = jget_arch(arch)
    init_fn, _ = jget_sparse(method)
    structs = jax.eval_shape(lambda: init_fn(
        jax.random.PRNGKey(0), cfg, cfg.memory,
        stacked=cfg.family != "hybrid"))
    for mesh_name, mesh in MESHES.items():
        _same_specs(sh.method_specs(_meta(structs), get_arch(arch), mesh),
                    jsh.method_specs(structs, cfg, mesh),
                    (arch, method, mesh_name))


def test_fsdp_threshold():
    mesh = MESHES["16x16"]
    has_data = lambda specs: any("data" in str(s) for _, s in
                                 _flat_port(specs))
    big = sh.param_specs(_params("qwen2-vl-72b", 16)[1],
                         get_arch("qwen2-vl-72b"), mesh)
    small = sh.param_specs(_params("llama3.2-1b", 16)[1],
                           get_arch("llama3.2-1b"), mesh)
    assert has_data(big)        # 72B: FSDP engaged
    assert not has_data(small)  # 1.5B: TP only


def _struct_paths(tree):
    return [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_paths(tree):
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), str(x.dtype).replace("torch.", ""))
        return ((), "int32")          # the host int ``length``
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: not isinstance(x, (dict, tuple, list)))[0]
    return [(jax.tree_util.keystr(p),) + leaf(x) for p, x in flat]


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_smoke_trees_have_reference_paths(arch):
    """The port's own trees at smoke width carry the reference's key paths,
    shapes and dtypes, and get the reference's specs."""
    jcfg, cfg = jget_arch(arch).smoke(), get_arch(arch).smoke()
    mesh = FakeMesh({"pod": 2, "data": 2, "model": 4})
    tparams = init_params(cfg, 0, tp=4, device="cpu")
    jparams = param_structs(jcfg, tp=4)
    assert _port_paths(tparams) == _struct_paths(jparams)
    _same_specs(sh.param_specs(tparams, cfg, mesh),
                jsh.param_specs(jparams, jcfg, mesh), arch)
    tcache = make_cache(cfg, 4, 64, tp=4, device="cpu")
    jcache = cache_structs(jcfg, 4, 64, tp=4)
    assert _port_paths(tcache) == _struct_paths(jcache)
    shape = TSHAPES["decode_32k"]
    _same_specs(sh.cache_specs(tcache, cfg, shape, mesh),
                jsh.cache_specs(jcache, jcfg, SHAPES["decode_32k"], mesh),
                arch)


# ---------------------------------------------------------------------------
# the named mesh and placing on it
# ---------------------------------------------------------------------------


def test_make_mesh_round_robin_and_groups():
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"])
    assert mesh.shape == {"data": 2, "model": 4}
    assert list(mesh.shape) == ["data", "model"]
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.groups(("data",)) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups(("model",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    m3 = make_mesh((2, 2, 2), ("pod", "data", "model"),
                   devices=["cpu", "meta"])
    assert [str(d) for d in m3.devices.flat] == ["cpu", "meta"] * 4
    assert m3.groups(("pod", "data")) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    shape, axes = plan_mesh(32, model_parallel=16, multi_pod=True)
    assert make_mesh(shape, axes, devices=["cpu"]).shape == {
        "pod": 2, "data": 1, "model": 16}
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("data",), devices=["cpu"])


def test_make_mesh_defaults_to_the_visible_cards():
    if torch.cuda.device_count():
        n = torch.cuda.device_count()
        mesh = make_mesh((2, 4), ("data", "model"))
        assert [d.index for d in mesh.devices.flat] == [
            i % n for i in range(8)]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((2, 4), ("data", "model"))


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_device_put_owned_slices(shape, axes):
    """Every shard is an owned copy of exactly its spec's slice; gather
    gives the tree back bit for bit."""
    cfg = get_arch("llama3.2-1b").smoke()
    params = init_params(cfg, 0, tp=4, device="cpu")
    mesh = make_mesh(shape, axes, devices=["cpu"])
    specs = sh.param_specs(params, cfg, mesh)
    placed = sh.device_put(params, sh.make_shardings(specs, mesh))
    flat_p = [x for _, x in _flat_port(params)]
    flat_s = [s for _, s in _flat_port(specs)]
    flat_x = jax.tree_util.tree_leaves(
        placed, is_leaf=lambda x: isinstance(x, sh.ShardedTensor))
    assert len(flat_x) == len(flat_p)
    for full, spec, st in zip(flat_p, flat_s, flat_x):
        assert isinstance(st, sh.ShardedTensor) and len(st.shards) == 8
        ptrs = {s.data_ptr() for s in st.shards}
        assert len(ptrs) == 8 and full.data_ptr() not in ptrs
        for i, shard in enumerate(st.shards):
            want = full[st.slices[i]]
            ways = [1] * full.dim()
            for d, names in enumerate(spec):
                if names is not None:
                    names = (names,) if isinstance(names, str) else names
                    ways[d] = int(np.prod([mesh.shape[n] for n in names]))
            assert tuple(shard.shape) == tuple(
                n // w for n, w in zip(full.shape, ways))
            assert shard.is_contiguous() and torch.equal(shard, want)
    back = sh.gather(placed)
    for a, b in zip(jax.tree_util.tree_leaves(back), flat_p):
        assert torch.equal(a, b)


def test_named_sharding_cuts_major_to_minor():
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"])
    x = torch.arange(64.0).reshape(8, 8)
    st = sh.device_put(x, sh.NamedSharding(mesh, sh.P(("data", "model"))))
    for i, shard in enumerate(st.shards):   # coordinate (d, m): block 4d + m
        assert torch.equal(shard, x[i:i + 1])
    st = sh.device_put(x, sh.NamedSharding(mesh, sh.P("model", "data")))
    assert torch.equal(st.shards[1], x[2:4, 0:4])    # coordinate (0, 1)
    assert torch.equal(st.shards[4], x[0:2, 4:8])    # coordinate (1, 0)
    with pytest.raises(ValueError, match="does not split"):
        sh.device_put(torch.zeros(6, 8),
                      sh.NamedSharding(mesh, sh.P(("data", "model"))))
