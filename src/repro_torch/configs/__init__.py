"""Architecture registry of the port: ``get_config(name)`` / ``list_archs()``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                      torch_dtype)

_ARCH_MODULES = {
    "stablelm-1.6b": "stablelm_1p6b",
    "llava-onevision-0.5b": "llava_onevision_0p5b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mamba2-1.3b": "mamba2_1p3b",
    "stablelm-12b": "stablelm_12b",
    "nemotron-4-15b": "nemotron_4_15b",
    "deepseek-67b": "deepseek_67b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "dbrx-132b": "dbrx_132b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
}


def list_archs():
    return list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "get_config",
           "list_archs", "torch_dtype"]
