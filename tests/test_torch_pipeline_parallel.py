"""The port's GPipe schedule against the JAX package's ``gpipe_forward``,
run as ``tests/test_distributed.py`` runs it (a subprocess with 4 host
devices, the same ``tanh(x @ w)`` stages): equal within 1e-5 on the same
numpy inputs; the schedule's tick count and the bubble; and a pipeline over
a model's layer stack (``models.model.run_layers`` as the stage function)
equal to the unpipelined forward within 1e-5 (fp32)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.pipeline_parallel import (  # noqa: E402
    bubble_fraction, gpipe_forward)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N_STAGES, MICRO, MB, D = 4, 8, 2, 16

JAX_GPIPE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.distributed.pipeline_parallel import gpipe_forward
d = np.load(sys.argv[1])
mesh = make_mesh((4,), ("pod",))
fn = gpipe_forward(lambda w, x: jnp.tanh(x @ w), mesh, "pod")
np.save(sys.argv[2], np.asarray(fn(jnp.asarray(d["ws"]), jnp.asarray(d["xs"]))))
"""


def _inputs():
    ws = (np.random.default_rng(0).standard_normal((N_STAGES, D, D)) / 4
          ).astype(np.float32)
    xs = np.random.default_rng(1).standard_normal((MICRO, MB, D)).astype(
        np.float32)
    return ws, xs


def test_gpipe_matches_jax(tmp_path):
    ws, xs = _inputs()
    np.savez(tmp_path / "in.npz", ws=ws, xs=xs)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", JAX_GPIPE, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npy")], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(tmp_path / "out.npy")
    mesh = make_mesh((4,), ("pod",), devices=["cpu"])
    calls = []

    def group(w, x):
        calls.append(1)
        return torch.tanh(x @ w)

    got = gpipe_forward(group, mesh, "pod")(torch.from_numpy(ws),
                                           torch.from_numpy(xs))
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) < 1e-5
    # every stage runs every tick: M + n_stages - 1 ticks
    assert len(calls) == (MICRO + N_STAGES - 1) * N_STAGES
    ref = torch.from_numpy(xs)
    for s in range(N_STAGES):
        ref = torch.tanh(ref @ torch.from_numpy(ws[s]))
    assert float((got - ref).abs().max()) < 1e-5


def test_bubble_fraction():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-9
    assert bubble_fraction(1, 8) == 0.0


def test_gpipe_sharded_stage_params_on_a_pod_mesh():
    """Stage params placed by ``device_put`` over the pod axis of a
    (pod, data, model) mesh: each stage reads its own shard."""
    ws, xs = _inputs()
    mesh = make_mesh((4, 1, 2), ("pod", "data", "model"), devices=["cpu"])
    placed = sh.device_put(torch.from_numpy(ws),
                           sh.NamedSharding(mesh, sh.P("pod")))
    fn = gpipe_forward(lambda w, x: torch.tanh(x @ w), mesh)
    plain = fn(torch.from_numpy(ws), torch.from_numpy(xs))
    assert torch.equal(fn(placed, torch.from_numpy(xs)), plain)


def test_gpipe_over_the_model_layers():
    """llama smoke at 4 layers in 2 stages of 2 (the stacked layer leaves
    reshaped to [2, 2, ...]), run_layers as the stage function, 4
    microbatches: the final-normed hidden states equal ``forward``'s."""
    cfg = get_arch("llama3.2-1b").smoke().replace(dtype="float32",
                                                   n_layers=4)
    params = init_params(cfg, 0, tp=4, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int64))
    stages = sh.tree_map(lambda a: a.reshape((2, 2) + a.shape[1:]),
                         params["layers"])
    mesh = make_mesh((2,), ("pod",), devices=["cpu"])
    fn = gpipe_forward(lambda sp, x: M.run_layers(sp, cfg, x, tp=4), mesh)
    with torch.no_grad():
        xs = L.embed(params["embed"], tokens)[:, None]      # [M, 1, S, d]
        got = L.rms_norm(params["final_norm"], fn(stages, xs)[:, 0],
                         cfg.norm_eps)
        want, _, _ = M.forward(params, cfg, tokens, tp=4)
    assert float((got - want).abs().max()) < 1e-5
