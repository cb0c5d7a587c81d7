"""Public wrapper for the sorted segment sum (no JAX counterpart kernel:
the JAX package sums with ``jax.ops.segment_sum`` under XLA).

A CUDA tensor launches the hand-written kernel (``csrc/segment_sum.cu``);
a CPU tensor takes the plain version (``ref.segment_sum_sorted_ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.segment_sum import kernel
from repro_torch.kernels.segment_sum.ref import segment_sum_sorted_ref

MAX_VALUES = 4


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"segment_sum_sorted: {msg}")


def segment_sum_sorted(values, offsets: torch.Tensor) -> tuple:
    """Per-row sums of 1 to 4 (nnz,) value vectors whose entries are sorted
    by row: ``out_v[r] = Σ values[v][offsets[r]:offsets[r + 1]]``. Returns
    one (n,) sum a vector, n = len(offsets) − 1; an empty row sums to 0.

    ``offsets`` is the (n + 1,) int64 CSR row pointer, non-decreasing from
    0 to nnz. On CUDA the values are contiguous float32 vectors (any
    16-byte alignment) and the result is the same bits on every run: each
    sum is taken in an order fixed by the offsets, never by atomics."""
    values = tuple(values)
    _check(1 <= len(values) <= MAX_VALUES,
           f"takes 1 to {MAX_VALUES} value vectors, got {len(values)}")
    if not on_cuda(offsets, *values):
        return segment_sum_sorted_ref(values, offsets)
    _check(offsets.dtype == torch.int64 and offsets.dim() == 1
           and offsets.shape[0] >= 1 and offsets.is_contiguous(),
           "offsets must be a contiguous int64 (n + 1,) vector")
    nnz = values[0].shape[0]
    for v in values:
        _check(v.dtype == torch.float32 and v.dim() == 1 and v.shape[0] == nnz
               and v.is_contiguous(),
               f"values must be contiguous float32 ({nnz},) vectors")
    n = offsets.shape[0] - 1
    outs = torch.empty((len(values), n), dtype=torch.float32,
                       device=offsets.device)
    if n == 0:
        return tuple(outs)
    blocks = min(kernel.max_blocks(offsets.device, len(values)),
                 -(-(n + nnz) // kernel.TILE))
    scratch = torch.empty(kernel.scratch_bytes(blocks, len(values)),
                          dtype=torch.uint8, device=offsets.device)
    kernel.launch(values, offsets, outs, blocks, scratch)
    segment_sum_sorted.launches += 2
    return tuple(outs)


segment_sum_sorted.launches = 0  # CUDA kernel launches: 2 a call (pass 1, pass 2)
