"""Segment reductions (port of ``repro.sparse.segment``; the EmbeddingBag
helpers wait for slice 7).

``index_add_`` and ``scatter_reduce_`` are PyTorch's scatter-reduces. On
CUDA the sum uses atomics, so its order, and the last bits of a float
result, can change from run to run: hold it to a tolerance, not to bit
equality."""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
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
