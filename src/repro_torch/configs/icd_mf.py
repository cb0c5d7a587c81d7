"""The paper's own iCD-MF at the §6 scale (200k users × 68k videos)."""
import dataclasses

from repro_torch.configs.base import ICD_SHAPES, ICDConfig

CONFIG = ICDConfig(
    name="icd-mf",
    model="mf",
    n_ctx=200_000,
    n_items=68_000,
    k=128,
    alpha0=1.0,
    l2=0.1,
)

SMOKE_CONFIG = dataclasses.replace(CONFIG, n_ctx=60, n_items=40, k=8)

SHAPES = ICD_SHAPES
