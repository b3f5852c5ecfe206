"""Config registry: ``get_config(arch_id)`` + the assigned-architecture list."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, SSMConfig

# arch-id -> module (one file per assigned architecture, + the paper's two)
_MODULES = {
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    # the paper's own evaluation subjects
    "llava15-13b": "repro_torch.configs.llava15_13b",
    "llama3.2-1b": "repro_torch.configs.llama32_1b",
}

ASSIGNED_ARCHS: List[str] = [
    "deepseek-v2-236b", "arctic-480b", "gemma3-1b", "command-r-plus-104b",
    "qwen2.5-3b", "yi-6b", "mamba2-130m", "whisper-medium", "paligemma-3b",
    "zamba2-2.7b",
]

PAPER_ARCHS: List[str] = ["llava15-13b", "llama3.2-1b"]


def get_config(arch_id: str) -> ArchConfig:
    if arch_id == "llama3.2-1b-gqa":
        mod = importlib.import_module("repro_torch.configs.llama32_1b")
        return mod.CONFIG_GQA
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in (*ASSIGNED_ARCHS, *PAPER_ARCHS)}


__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "get_config",
           "all_configs", "ASSIGNED_ARCHS", "PAPER_ARCHS"]
