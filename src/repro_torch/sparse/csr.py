"""CSR sparse-matrix container (port of ``repro.sparse.csr``).

Row-major traversal structure (per-context interaction lists, per-node
adjacency) with converters. Values are optional (pattern-only CSR is used
for adjacency structure). Index tensors are int64 (torch's index type);
the reference keeps int32, with the same values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix.

    Attributes:
      indptr:  (n_rows + 1,) int64 — row start offsets into ``indices``.
      indices: (nnz,) int64 — column ids, row-major sorted.
      data:    (nnz,) values; None for pattern-only matrices.
      n_rows, n_cols: ints.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    data: Optional[torch.Tensor]
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def with_data(self, data: torch.Tensor) -> "CSR":
        return dataclasses.replace(self, data=data)


def coo_to_csr(row, col, data, n_rows: int, n_cols: int, *,
               device=None) -> CSR:
    """Build a CSR from (unsorted) COO triplets on the host (numpy), then
    put it on ``device`` (the GPU unless the caller names the CPU)."""
    device = resolve_device(device)
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    order = np.argsort(row, kind="stable")
    row, col = row[order], col[order]
    if data is not None:
        data = np.asarray(data)[order]
    counts = np.bincount(row, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(
        indptr=torch.as_tensor(indptr, device=device),
        indices=torch.as_tensor(col, device=device),
        data=None if data is None else torch.as_tensor(data, device=device),
        n_rows=int(n_rows),
        n_cols=int(n_cols),
    )


def csr_row_ids(csr: CSR) -> torch.Tensor:
    """Expand indptr to per-nnz row ids: the COO row vector, by a
    searchsorted over indptr (O(nnz log rows))."""
    positions = torch.arange(csr.nnz, dtype=torch.int64,
                             device=csr.indptr.device)
    # row r owns positions [indptr[r], indptr[r+1]) — find r per position.
    return torch.searchsorted(csr.indptr, positions, right=True) - 1


def transpose_csr_host(csr: CSR) -> CSR:
    """CSR transpose through the host (CSC view of the same matrix as
    CSR), on the input's device."""
    row_ids = csr_row_ids(csr).cpu().numpy()
    col_ids = csr.indices.cpu().numpy()
    data = None if csr.data is None else csr.data.cpu().numpy()
    return coo_to_csr(col_ids, row_ids, data, csr.n_cols, csr.n_rows,
                      device=csr.indptr.device)
