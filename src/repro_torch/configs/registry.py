"""Architecture registry: ``--arch <id>`` resolution (counterpart of
``repro.configs.registry``).  Only the configurations this slice of the port
serves are registered; the others arrive with their families."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
}

ALL_ARCHS: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"ported: {ALL_ARCHS}")
    cfg = importlib.import_module(_MODULES[name]).config()
    return cfg.reduced() if smoke else cfg
