"""Observed-interaction container for implicit-feedback learning (port of
``repro.sparse.interactions``).

Holds the rescaled positive set S̄ of Lemma 1 in COO layout sorted by
context, plus the item-major view for the item-side sweeps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class Interactions:
    """Rescaled observed feedback S̄ (Lemma 1, eq. 8) in dual COO layout.

    Context-major tensors (sorted by ``ctx``, then ``item``):
      ctx, item:  (nnz,) int64
      y:          (nnz,) f32 — rescaled targets ȳ = α/(α−α₀)·y
      alpha:      (nnz,) f32 — rescaled confidences ᾱ = α−α₀

    Item-major view of the same triplets (sorted by item, then ctx):
      t_ctx, t_item, t_perm — ``t_perm`` maps item-major position →
      context-major position, so residual caches move between sweeps.

    CSR row offsets of the two orders, int64, for the sums by sorted row
    (``segment.segment_sum_sorted``):
      ctx_ptr:  (n_ctx + 1,) — context c's entries are [ctx_ptr[c], ctx_ptr[c+1])
      item_ptr: (n_items + 1,) — item i's, in the item-major view

    Index tensors are int64 (torch's index type); the reference keeps
    int32, with the same values.
    """

    ctx: torch.Tensor
    item: torch.Tensor
    y: torch.Tensor
    alpha: torch.Tensor
    t_ctx: torch.Tensor
    t_item: torch.Tensor
    t_perm: torch.Tensor
    ctx_ptr: torch.Tensor
    item_ptr: torch.Tensor
    n_ctx: int
    n_items: int

    @property
    def nnz(self) -> int:
        return int(self.ctx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.ctx.device


def with_weights(data: Interactions, weights) -> Interactions:
    """``data`` with an optional (nnz,) context-major weight vector folded
    into α (a weighted epoch is exactly an epoch over α·w); ``data`` as it
    came when ``weights`` is None."""
    return data if weights is None else dataclasses.replace(
        data, alpha=data.alpha * weights)


def build_interactions(ctx, item, y, alpha, n_ctx: int, n_items: int,
                       alpha0: float = 1.0, rescale: bool = True, *,
                       device=None) -> Interactions:
    """Build the dual-layout container, applying the Lemma 1 rescaling, on
    ``device`` (the GPU unless the caller names the CPU).

    Args:
      ctx, item: observed (context, item) pairs (numpy-like).
      y, alpha: raw scores and confidences (α must exceed α₀).
      alpha0: the implicit confidence α₀ of the zero set S⁰.
      rescale: apply eq. (8); disable when the caller pre-rescaled.
    """
    device = resolve_device(device)
    ctx = np.asarray(ctx, dtype=np.int64)
    item = np.asarray(item, dtype=np.int64)
    y = np.asarray(y, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)
    if rescale:
        if np.any(alpha <= alpha0):
            raise ValueError("Lemma 1 rescaling needs alpha > alpha0 on S+")
        y = alpha / (alpha - alpha0) * y
        alpha = alpha - alpha0

    order = np.lexsort((item, ctx))
    ctx, item, y, alpha = ctx[order], item[order], y[order], alpha[order]
    t_order = np.lexsort((ctx, item))
    t_item = item[t_order]

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return Interactions(
        ctx=dev(ctx, torch.int64), item=dev(item, torch.int64),
        y=dev(y.astype(np.float32), torch.float32),
        alpha=dev(alpha.astype(np.float32), torch.float32),
        t_ctx=dev(ctx[t_order], torch.int64),
        t_item=dev(t_item, torch.int64),
        t_perm=dev(t_order, torch.int64),
        ctx_ptr=dev(np.searchsorted(ctx, np.arange(n_ctx + 1)), torch.int64),
        item_ptr=dev(np.searchsorted(t_item, np.arange(n_items + 1)), torch.int64),
        n_ctx=int(n_ctx), n_items=int(n_items),
    )
