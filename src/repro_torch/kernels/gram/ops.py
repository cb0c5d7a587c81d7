"""Public wrapper for the Gram kernel (port of ``repro.kernels.gram.ops``).

A CUDA tensor launches the hand-written kernel (``csrc/gram.cu``); a CPU
tensor takes the plain version (``ref.gram_ref``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda, vmem
from repro_torch.kernels.gram import kernel
from repro_torch.kernels.gram.ref import gram_ref


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gram: {msg}")


def gram(x: torch.Tensor, *, weights=None) -> torch.Tensor:
    """J = xᵀx, or the confidence-weighted xᵀ·diag(w)·x when ``weights``
    (per row, shape (rows,)) is given: (k, k) fp32 with fp32 accumulation.

    On CUDA ``x`` is fp32 with contiguous columns (any row stride, so a
    column slice of a wider matrix is read in place) and ``weights`` a
    contiguous fp32 vector. The result is the same on every run: the row
    splits are summed in a fixed order."""
    if not on_cuda(x, weights):
        return gram_ref(x, weights)
    _check(x.dtype == torch.float32, f"x must be float32, got {x.dtype}")
    _check(x.dim() == 2 and x.shape[1] >= 1, f"x must be (rows, k), got "
           f"{tuple(x.shape)}")
    rows, k = x.shape
    _check(rows == 0 or x.stride(1) == 1, "x's columns must be contiguous")
    if weights is not None:
        _check(weights.dtype == torch.float32 and weights.shape == (rows,)
               and weights.is_contiguous(),
               f"weights must be a contiguous float32 ({rows},) vector")
    splits, rows_per_split = vmem.gram_row_splits(rows, k)
    partial = torch.empty((splits, k, k), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((k, k), dtype=torch.float32, device=x.device)
    kernel.launch(x, weights, splits, rows_per_split, partial, out)
    gram.launches += 1
    return out


gram.launches = 0  # CUDA kernel launches (chip_smoke.py reads it)
