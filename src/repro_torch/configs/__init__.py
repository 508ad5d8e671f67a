"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)``. Lists only the archs the port runs. The
paper's LeNet-5 (``lenet5.CONFIG``) is exported beside it, as in the
reference."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (LM_SHAPES, LONG_CONTEXT_ARCHS,
                                      ArchConfig, ShapeSpec,
                                      shape_applicable)
from repro_torch.configs.lenet5 import CONFIG as LENET5, LeNetConfig

ARCH_IDS = ("qwen3-32b", "chatglm3-6b", "llama3-8b", "qwen2.5-32b",
            "musicgen-medium", "qwen2-vl-2b", "granite-moe-1b-a400m",
            "llama4-maverick-400b-a17b", "xlstm-350m", "zamba2-7b")

_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "chatglm3-6b": "chatglm3_6b",
    "llama3-8b": "llama3_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "granite-moe-1b-a400m": "granite_moe",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "xlstm-350m": "xlstm_350m",
    "zamba2-7b": "zamba2_7b",
}


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.smoke_config()


__all__ = ["ARCH_IDS", "ArchConfig", "LENET5", "LM_SHAPES",
           "LONG_CONTEXT_ARCHS", "LeNetConfig", "ShapeSpec", "get_config",
           "get_smoke_config", "shape_applicable"]
