"""Architecture registry: ``--arch <id>`` resolution (counterpart of
``repro.configs.registry``): every configuration of the reference."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
}

ALL_ARCHS: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_ARCHS}")
    cfg = importlib.import_module(_MODULES[name]).config()
    return cfg.reduced() if smoke else cfg
