"""``--arch <id>`` resolution: the paper's three retrievers, the
decoder-LM family, the recsys family and the GNN family, and the
(arch, shape) cells of ``launch/cells.py``."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    # decoder-only LM family
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    # recsys family
    "dcn-v2": "repro_torch.configs.dcn_v2",
    "autoint": "repro_torch.configs.autoint",
    "bert4rec": "repro_torch.configs.bert4rec",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    # the paper's late-interaction retrievers
    "colsmol": "repro_torch.configs.colsmol",
    "colpali": "repro_torch.configs.colpali",
    "colqwen": "repro_torch.configs.colqwen",
    # GNN family
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
}

LM_ARCHS = tuple(list(_ARCH_MODULES)[:5])
RECSYS_ARCHS = tuple(list(_ARCH_MODULES)[5:9])
PAPER_ARCHS = tuple(list(_ARCH_MODULES)[9:12])
GNN_ARCHS = tuple(list(_ARCH_MODULES)[12:])
# ``repro``'s order: its registry lists the GNN before the recsys family
ASSIGNED_ARCHS = ("gemma2-9b", "gemma3-4b", "minicpm-2b",
                  "granite-moe-1b-a400m", "olmoe-1b-7b", "equiformer-v2",
                  "dcn-v2", "autoint", "bert4rec", "dlrm-mlperf")
ALL_ARCHS = ASSIGNED_ARCHS + PAPER_ARCHS


def get_config(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_shapes(arch: str) -> dict:
    """{shape name: ShapeSpec} of ``arch``'s cells."""
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return {s.name: s for s in mod.SHAPES}


def get_cells(archs=None) -> list:
    """All (arch, shape name) cells of ``archs`` (default
    ``ASSIGNED_ARCHS``)."""
    return [(a, s) for a in (archs or ASSIGNED_ARCHS) for s in get_shapes(a)]
