"""Segment reductions and EmbeddingBag (port of ``repro.sparse.segment``).

``index_add_`` and ``scatter_reduce_`` are PyTorch's scatter-reduces. On
CUDA the sum uses atomics, so its order, and the last bits of a float
result, can change from run to run: hold it to a tolerance, not to bit
equality."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.obs.trace import span


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    with span("segment_sum"):
        out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                          device=data.device)
        return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(torch.ones(segment_ids.shape, dtype=data.dtype,
                                    device=data.device),
                         segment_ids, num_segments)
    counts = torch.clamp(counts, min=1)
    if data.dim() > 1:
        counts = counts.reshape(counts.shape + (1,) * (data.dim() - 1))
    return total / counts


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; an empty segment holds the identity of max (−inf
    for floats, the type's least value for integers), as in the
    reference."""
    lowest = (-float("inf") if data.is_floating_point()
              else torch.iinfo(data.dtype).min)
    out = torch.full((num_segments, *data.shape[1:]), lowest,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return out.scatter_reduce_(0, idx, data, "amax", include_self=True)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
                  n_rows: int, weights: Optional[torch.Tensor] = None,
                  combiner: str = "sum") -> torch.Tensor:
    """Ragged EmbeddingBag: ``out[r] = combine_{j: rows[j]==r} w_j *
    table[ids[j]]``.

    Args:
      table:   (vocab, dim) embedding table.
      ids:     (nnz,) feature ids (gather indices into ``table``).
      rows:    (nnz,) output row per lookup, sorted or not.
      n_rows:  number of output rows (batch).
      weights: optional (nnz,) per-lookup weights.
      combiner: 'sum' | 'mean' | 'max'.

    Returns:
      (n_rows, dim).
    """
    gathered = table[ids]
    if weights is not None:
        gathered = gathered * weights[:, None].to(gathered.dtype)
    if combiner == "sum":
        return segment_sum(gathered, rows, n_rows)
    if combiner == "mean":
        return segment_mean(gathered, rows, n_rows)
    if combiner == "max":
        return segment_max(gathered, rows, n_rows)
    raise ValueError(f"unknown combiner {combiner!r}")


def multi_hot_lookup(table: torch.Tensor, ids: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     combiner: str = "sum") -> torch.Tensor:
    """Fixed-shape EmbeddingBag for padded multi-hot batches.

    Args:
      table: (vocab, dim).
      ids:   (batch, bag), padded with arbitrary ids where masked.
      mask:  (batch, bag) bool/float — 1 for valid entries; None = all valid.
      combiner: 'sum' | 'mean'.

    Returns:
      (batch, dim).
    """
    gathered = table[ids]  # (batch, bag, dim)
    if mask is not None:
        gathered = gathered * mask[..., None].to(gathered.dtype)
    summed = torch.sum(gathered, dim=1)
    if combiner == "sum":
        return summed
    if combiner == "mean":
        denom = (torch.sum(mask.to(gathered.dtype), dim=1, keepdim=True)
                 if mask is not None
                 else torch.full((ids.shape[0], 1), ids.shape[1],
                                 dtype=gathered.dtype, device=gathered.device))
        return summed / torch.clamp(denom, min=1)
    raise ValueError(f"unknown combiner {combiner!r}")
