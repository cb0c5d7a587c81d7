"""Architecture config registry (port of ``repro.configs``).

``get_config(arch_id)`` returns the published configuration and
``get_smoke_config(arch_id)`` a reduced same-family config for CPU smoke
runs. Only icd-mf is ported; icd-fm raises until its model is.
"""
from __future__ import annotations

from repro_torch.configs import icd_mf

ARCH_IDS = ["icd-mf", "icd-fm"]

_PORTED = {"icd-mf": icd_mf}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in _PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not yet ported to repro_torch")
    return _PORTED[arch_id]


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE_CONFIG
