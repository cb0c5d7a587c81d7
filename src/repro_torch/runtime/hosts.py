"""This host's place among the hosts of a run: the port's stand-in for
``jax.process_index()`` and ``jax.process_count()``.

With ``torch.distributed`` initialised they are its rank and world size;
without it a run is one host, index 0 of 1. The data loaders and the
trainer call these through the module (``hosts.process_index()``), so a
test can monkeypatch them here for every caller at once.
"""
from __future__ import annotations

import torch.distributed as dist


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if _distributed() else 1
