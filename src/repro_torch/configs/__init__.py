"""Architecture registry: ``--arch <id>`` resolves through here."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from repro_torch.configs.jamba_1_5_large import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.llama4_maverick_400b import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.mamba2_780m import CONFIG as MAMBA2_780M
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI
from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN2_5_3B
from repro_torch.configs.qwen2_vl_72b import CONFIG as QWEN2_VL_72B
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
from repro_torch.configs.qwen3_8b import CONFIG as QWEN3_8B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL

ARCHS = {
    c.name: c
    for c in [
        QWEN2_VL_72B,
        MAMBA2_780M,
        OLMOE_1B_7B,
        LLAMA4_MAVERICK,
        JAMBA_1_5_LARGE,
        QWEN3_32B,
        QWEN2_5_3B,
        QWEN3_8B,
        PHI4_MINI,
        WHISPER_SMALL,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_arch",
    "get_shape",
    "shape_applicable",
]
