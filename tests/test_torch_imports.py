"""The port stands alone: no file of ``src/repro_torch`` nor ``chip_smoke.py``
imports JAX or the JAX package, and ``import repro_torch`` works on a machine
without nvcc, triton or a GPU (kernels are built and loaded at first use)."""
import ast
import importlib
import pathlib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in BANNED, f"{path.name} imports {name}"


@pytest.mark.parametrize("mod", [
    "repro_torch", "repro_torch.kernels.ops", "repro_torch.serving",
    "repro_torch.launch.serve", "repro_torch.weights",
    "repro_torch.retrieval", "repro_torch.data", "repro_torch.hetero",
    "repro_torch.kernels.bm25_topk", "repro_torch.core.methods.rag",
    "repro_torch.core.methods.mac", "repro_torch.kernels.flash_attention",
    "repro_torch.train", "repro_torch.distributed", "repro_torch.launch.train",
    "repro_torch.distributed.topk", "repro_torch.hetero.sharded",
    "repro_torch.serving.router", "repro_torch.serving.replica",
    "repro_torch.launch.mesh", "repro_torch.core.methods.memagent",
    "repro_torch.core.methods.ttt", "repro_torch.examples.quickstart",
    "repro_torch.examples.serve_sparse_attention",
    "repro_torch.examples.rag_pipeline",
    "repro_torch.examples.train_mac_100m",
    "repro_torch.distributed.sharding", "repro_torch.distributed.collectives",
    "repro_torch.distributed.pipeline_parallel",
    "repro_torch.kernels.cost", "repro_torch.launch.op_walk",
    "repro_torch.launch.roofline", "repro_torch.launch.specs",
    "repro_torch.launch.dryrun", "repro_torch.launch.report",
])
def test_port_imports_without_cuda_toolchain(mod):
    importlib.import_module(mod)


def test_make_mesh_is_the_ports_own():
    """``make_mesh`` comes from the port's ``launch/mesh.py``, which imports
    neither JAX nor the reference (checked file by file above)."""
    from repro_torch.launch import mesh

    assert mesh.make_mesh.__module__ == "repro_torch.launch.mesh"
    assert not {"jax", "repro"} & set(vars(mesh))
