"""Config registry of the port: one module per assigned architecture (+ the
paper's own rmat_coloring workload), copies of ``repro.configs`` with the
same (published) widths. Each module exposes ``get_config()`` (exact assigned
dims) and ``get_smoke_config()`` (same family switches, tiny dims).

Usage: ``from repro_torch.configs import get_config; cfg = get_config("qwen3-4b")``
or via launchers: ``--arch qwen3-4b``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

_ARCH_MODULES: Dict[str, str] = {
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-3b": "starcoder2_3b",
    "gemma2-2b": "gemma2_2b",
    "mamba2-130m": "mamba2_130m",
    "whisper-medium": "whisper_medium",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "grok-1-314b": "grok1_314b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "rmat-coloring": "rmat_coloring",
}

ARCH_IDS: List[str] = [a for a in _ARCH_MODULES if a != "rmat-coloring"]


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)


def get_config(arch: str):
    return _module(arch).get_config()


def get_smoke_config(arch: str):
    return _module(arch).get_smoke_config()
