"""Config dataclasses for the paper's own iCD models and their input
shapes (port of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (arch × input-shape) cell of the assignment."""

    name: str
    kind: str                    # 'train' | 'prefill' | 'decode' | 'serve' | ...
    seq_len: int = 0
    global_batch: int = 0
    extras: Tuple[Tuple[str, object], ...] = ()
    skip: Optional[str] = None   # reason string ⇒ documented skip

    def extra(self, key, default=None):
        return dict(self.extras).get(key, default)


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
    # fm extras
    p_ctx: int = 0
    p_item: int = 0


ICD_SHAPES = {
    "epoch_youtube": ShapeSpec(
        "epoch_youtube", "train",
        extras=(("n_ctx", 200_000), ("n_items", 68_000), ("nnz", 20_000_000)),
    ),
    "epoch_web": ShapeSpec(
        "epoch_web", "train",
        extras=(("n_ctx", 10_000_000), ("n_items", 1_000_000),
                ("nnz", 500_000_000)),
    ),
    "retrieval": ShapeSpec(
        "retrieval", "retrieval", global_batch=4096,
        extras=(("n_candidates", 1_000_000),),
    ),
}
