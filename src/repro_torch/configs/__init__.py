"""Architecture config registry (port of ``repro.configs``).

``get_config(arch_id)`` returns the published configuration,
``get_smoke_config(arch_id)`` a reduced same-family config for CPU smoke
runs and ``get_shapes(arch_id)`` the arch's input shapes.
"""
from __future__ import annotations

from repro_torch.configs import icd_fm, icd_mf

ARCH_IDS = ["icd-mf", "icd-fm"]

_MODULES = {"icd-mf": icd_mf, "icd-fm": icd_fm}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id]


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).SMOKE_CONFIG


def get_shapes(arch_id: str):
    """dict shape_name -> ShapeSpec for this arch."""
    return _module(arch_id).SHAPES
