"""Assigned architecture configurations (``--arch <id>``).

One module per architecture with the exact published config; ``get(name)``
returns the ArchConfig, ``ARCHS`` lists all ids.  A copy, as data, of the
JAX package's configurations; the model (:mod:`repro_torch.models.model`)
runs every one of them.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

ARCHS: List[str] = [
    "minicpm-2b", "tinyllama-1.1b", "qwen3-4b", "stablelm-1.6b",
    "dbrx-132b", "deepseek-v2-236b", "zamba2-1.2b", "seamless-m4t-medium",
    "qwen2-vl-2b", "xlstm-125m",
]

# the paper's own model (§5.4) — selectable but not in the assigned pool
PAPER_ARCHS = ["llama2-7b"]

_MODULES = {
    "llama2-7b": "llama2_7b",
    "minicpm-2b": "minicpm_2b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen3-4b": "qwen3_4b",
    "stablelm-1.6b": "stablelm_1_6b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "zamba2-1.2b": "zamba2_1_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "xlstm-125m": "xlstm_125m",
}


def get(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {name: get(name) for name in ARCHS}
