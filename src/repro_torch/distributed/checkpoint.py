"""Fault-tolerant checkpointing (twin of ``repro.distributed.checkpoint``),
in the reference's on-disk format, so a checkpoint written by either
package restores in the other:

    <ckpt_dir>/step_XXXXXXXX/params.npz     one array per leaf
    <ckpt_dir>/step_XXXXXXXX/manifest.json  step, time, leaf count, bytes,
                                            each leaf's dtype, extra

Leaves are keyed by their "/"-joined dict path ("params/layers/attn/wq");
bf16 leaves are stored as their uint16 bit patterns (npz has no bf16) and
named "bfloat16" in the manifest. A write goes to a temporary directory that
is renamed into place; ``keep`` newest steps are retained.

Elastic restarts: a tree of sharded leaves (``sharding.ShardedTensor``) is
saved as its gathered full arrays, so the files do not depend on the mesh,
and ``restore(..., shardings=)`` places the restored tree onto any mesh
(``plan_mesh``'s smaller one after a host is lost, or one device).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardedTensor, device_put


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"/"-joined path: leaf} in sorted-key order (``jax.tree`` order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(t: torch.Tensor):
    """(array as stored, dtype name for the manifest)."""
    t = t.full("cpu") if isinstance(t, ShardedTensor) else t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save(ckpt_dir: str, step: int, params, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomic checkpoint write: tmp dir + rename. Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    arrays, dtypes = {}, {}
    for k, v in _flatten(params).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    np.savez(os.path.join(tmp, "params.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "n_leaves": len(arrays),
        "bytes": int(sum(a.nbytes for a in arrays.values())),
        "dtypes": dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """A tree of the structure of ``like``, each leaf a new tensor on the
    device of ``like``'s leaf at the same path (the CPU for a sharded one);
    placed onto ``shardings`` (one ``NamedSharding`` or a tree of them, any
    mesh) when given: the elastic-restart path."""
    data = np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "params.npz"))
    dtypes = read_manifest(ckpt_dir, step).get("dtypes", {})
    flat_like = _flatten(like)
    missing = [k for k in flat_like if k not in data.files]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")

    def load(key, ref):
        a = data[key]
        if dtypes.get(key) == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return t if isinstance(ref, ShardedTensor) else t.to(ref.device)

    def build(t, prefix=""):
        if isinstance(t, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in t.items()}
        return load(prefix[:-1], t)

    tree = build(like)
    return tree if shardings is None else device_put(tree, shardings)


def read_manifest(ckpt_dir: str, step: int) -> Dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)
