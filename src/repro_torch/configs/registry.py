"""``--arch <id>`` resolution: the paper's three retrievers and the
decoder-LM family."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    # decoder-only LM family
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    # the paper's late-interaction retrievers
    "colsmol": "repro_torch.configs.colsmol",
    "colpali": "repro_torch.configs.colpali",
    "colqwen": "repro_torch.configs.colqwen",
}

LM_ARCHS = tuple(list(_ARCH_MODULES)[:5])
PAPER_ARCHS = tuple(list(_ARCH_MODULES)[5:])


def get_config(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG
