"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)``. Lists only the archs the port runs. The
paper's LeNet-5 (``lenet5.CONFIG``) is exported beside it, as in the
reference."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.lenet5 import CONFIG as LENET5, LeNetConfig

ARCH_IDS = ("llama3-8b",)

_MODULES = {
    "llama3-8b": "llama3_8b",
}


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.smoke_config()


__all__ = ["ARCH_IDS", "ArchConfig", "LENET5", "LeNetConfig", "get_config",
           "get_smoke_config"]
