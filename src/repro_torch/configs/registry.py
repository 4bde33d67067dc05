"""``--arch <id>`` resolution for the paper's three retrievers."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "colsmol": "repro_torch.configs.colsmol",
    "colpali": "repro_torch.configs.colpali",
    "colqwen": "repro_torch.configs.colqwen",
}

PAPER_ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG
