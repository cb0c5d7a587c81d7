"""Gradient clipping (port of ``repro.optim.clip``)."""
from __future__ import annotations

import torch

from repro_torch.optim.base import global_norm, tree_map


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
