"""Config dataclass for the paper's own iCD models (port of
``repro.configs.base``; only what the serving path reads)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ICDConfig:
    """Production config for the paper's own models."""

    name: str
    model: str            # 'mf' | 'fm'
    n_ctx: int
    n_items: int
    k: int
    alpha0: float = 1.0
    l2: float = 0.1
