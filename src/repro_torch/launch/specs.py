"""Stand-ins and shardings for every (arch x shape) cell (twin of
``repro.launch.specs``).

The reference builds ``jax.ShapeDtypeStruct``s with ``jax.eval_shape`` over
its real builders. The port's structs are fake tensors: the real builders
(``init_params``, ``make_cache``, the methods' inits) run on ``"cpu"``
under ``op_walk.placeholders()``, which allocates nothing, and a struct
is placed on a mesh's placeholder devices with ``sharding.device_put`` or
``.to``. The shardings are the port's own (``distributed.sharding``).
Every function here enters ``placeholders()`` itself when none is active;
its structs keep their shapes and dtypes after it exits.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.methods import get_sparse_method
from repro_torch.distributed import sharding as sh
from repro_torch.launch import op_walk
from repro_torch.models import model as M


def _fake():
    """``placeholders()`` unless one is active."""
    return contextlib.nullcontext() if op_walk._PLACE["mode"] is not None \
        else op_walk.placeholders()


def sds(shape, dtype) -> torch.Tensor:
    """A struct: a fake tensor of ``shape`` and ``dtype`` on the host."""
    with _fake():
        return torch.empty(tuple(shape), dtype=dtype)


def pick_accum(cfg: ArchConfig, shape: ShapeConfig, data_par: int,
               budget_bytes: float = 4e9) -> int:
    """Gradient-accumulation factor bounding per-device remat residuals
    (L x tokens_dev x d_model x 2B) to ~budget."""
    tokens_dev = shape.global_batch * shape.seq_len / max(data_par, 1)
    resid = cfg.n_layers * tokens_dev * cfg.d_model * 2
    accum = 1
    while resid / accum > budget_bytes and accum < shape.global_batch:
        accum *= 2
    while shape.global_batch % accum:
        accum //= 2
    return max(accum, 1)


def param_structs(cfg: ArchConfig, tp: int = 16):
    with _fake():
        return M.init_params(cfg, 0, tp=tp, device="cpu")


def cache_structs(cfg: ArchConfig, batch: int, max_len: int, tp: int = 16):
    with _fake():
        return M.make_cache(cfg, batch, max_len, tp=tp, device="cpu")


def sparse_structs(cfg: ArchConfig, tp: int = 16):
    if cfg.family == "ssm":
        return None
    init_fn, _ = get_sparse_method(cfg.memory.method if cfg.memory.method in
                                   ("dsa", "seer", "lserve") else "dsa")
    with _fake():
        return init_fn(cfg, cfg.memory, 0, stacked=cfg.family != "hybrid",
                       device="cpu")


def batch_structs(cfg: ArchConfig, shape: ShapeConfig) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    out: Dict = {}
    if shape.kind == "train":
        out["tokens"] = sds((B, S), torch.int32)
        out["labels"] = sds((B, S), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = sds((B, S), torch.int32)
    else:
        out["token"] = sds((B,), torch.int32)
    if cfg.rope_style == "mrope" and shape.kind != "decode":
        out["positions3"] = sds((3, B, S), torch.int32)
    if cfg.frontend == "vision_stub" and shape.kind != "decode":
        out["img_embeds"] = sds((B, min(256, S // 4), cfg.d_model),
                                torch.bfloat16)
    return out


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                tp: int = 16, fsdp: Optional[bool] = None) -> Dict:
    """Everything the dry run needs: structs + shardings per cell.

    ``fsdp``: None = auto (params >= 5B). The optimized decode variant passes
    False — weights stay TP-resident instead of being re-gathered every
    step."""
    out: Dict = {"kind": shape.kind}
    out["params"] = param_structs(cfg, tp)
    pspec = sh.param_specs(out["params"], cfg, mesh, fsdp=fsdp)
    out["params_sharding"] = sh.make_shardings(pspec, mesh)
    out["batch"] = batch_structs(cfg, shape)
    bspec = sh.batch_specs(cfg, shape, mesh)
    out["batch_sharding"] = {
        k: sh.NamedSharding(mesh, bspec[k]) for k in out["batch"]
        if k in bspec
    }
    # decode shapes carry the KV cache / state
    if shape.kind == "decode":
        caches = cache_structs(cfg, shape.global_batch, shape.seq_len, tp)
        out["caches"] = caches
        cspec = sh.cache_specs(caches, cfg, shape, mesh)
        out["caches_sharding"] = sh.make_shardings(cspec, mesh)
        sp = sparse_structs(cfg, tp)
        if sp is not None:
            out["sparse_params"] = sp
            out["sparse_sharding"] = sh.make_shardings(
                sh.method_specs(sp, cfg, mesh), mesh)
    return out
