"""Architecture registry: ``get_arch(name)`` / ``ARCHS``."""
from repro_torch.configs.base import (
    ArchConfig,
    MemoryConfig,
    ShapeConfig,
    SHAPES,
    smoke_shape,
)
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3_32b
from repro_torch.configs.llama3_2_1b import CONFIG as _llama3_2_1b
from repro_torch.configs.glm4_9b import CONFIG as _glm4_9b
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2_7b
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.zamba2_7b import CONFIG as _zamba2
from repro_torch.configs.qwen2_vl_72b import CONFIG as _qwen2_vl
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm

ARCHS = {
    c.name: c
    for c in [
        _qwen3_32b,
        _llama3_2_1b,
        _glm4_9b,
        _qwen2_7b,
        _granite,
        _mixtral,
        _musicgen,
        _zamba2,
        _qwen2_vl,
        _xlstm,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ArchConfig",
    "MemoryConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCHS",
    "get_arch",
    "smoke_shape",
]
