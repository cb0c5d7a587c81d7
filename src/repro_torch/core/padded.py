"""Generic padded nnz-grouping for the fused block sweeps (port of
``repro.core.padded``).

``mf_padded`` hard-codes the two groupings MF needs (by context and by
item). The tensor models sweep over OTHER groupings — by c1, by c2, by
item of the pair list — so this module factors the layout out: a
:class:`PaddedGroup` maps the flat observation list onto an
``(n_rows, d_pad)`` grid (one row per group, slots padded to the maximum
group degree rounded up to 128, the reference's lane width, so the
layouts are equal array for array), with α scattered once at build time
(0 on padding, so padded slots are inert in every reduction).

Scatter and gather keep the ORIGINAL flat nnz order; transferring the
residual cache between two groupings is ``g2.scatter(g1.gather(e_grid))``.

Pseudo-ψ routing: the fused tensor sweeps evaluate per-block pseudo-ψ
values on the FLAT nnz list (``(nnz, m)``) and the kernels need them per
padded slot. Two routes exist:

  * ``flat_ids`` (default) — the ``(n_rows, d_pad)`` grid of flat nnz
    indices (padding → the sentinel row ``nnz``). The gather forms of
    ``kernels/cd_sweep`` read the flat ``(nnz+1, m)`` slab
    (:func:`append_sentinel_row`) through this grid, so the
    ``(n_rows, m, d_pad)`` tile never exists in device memory.
  * :meth:`PaddedGroup.scatter_blk` — the scatter into that tile for the
    pre-gathered forms, m× the residual grid, built per block dispatch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class PaddedGroup:
    """One grouping of the flat observation list onto a padded grid."""

    rows: torch.Tensor       # (nnz,) int64 — group row per observation
    cols: torch.Tensor       # (nnz,) int64 — slot within the row
    alpha_pad: torch.Tensor  # (n_rows, d_pad) f32 — confidences, 0 on padding
    flat_ids: torch.Tensor   # (n_rows, d_pad) int32 — flat nnz index per
    #                          slot; padding holds the sentinel nnz (one past
    #                          the last observation, see append_sentinel_row)
    n_rows: int
    d_pad: int

    def scatter(self, vals: torch.Tensor, dtype=None) -> torch.Tensor:
        """Flat per-nnz vector → (n_rows, d_pad) grid (0 on padding)."""
        out = torch.zeros((self.n_rows, self.d_pad), dtype=dtype or vals.dtype,
                          device=vals.device)
        out[self.rows, self.cols] = vals.to(out.dtype)
        return out

    def scatter_blk(self, vals_blk: torch.Tensor) -> torch.Tensor:
        """Flat (nnz, m) block → contiguous (n_rows, m, d_pad) pseudo-ψ
        tile (pre-gathered route only)."""
        out = torch.zeros((self.n_rows, vals_blk.shape[1], self.d_pad),
                          dtype=vals_blk.dtype, device=vals_blk.device)
        out[self.rows, :, self.cols] = vals_blk
        return out

    def gather(self, grid: torch.Tensor) -> torch.Tensor:
        """(n_rows, d_pad) grid → flat per-nnz vector."""
        return grid[self.rows, self.cols]

    def with_alpha(self, alpha_flat: torch.Tensor) -> "PaddedGroup":
        """Rebuild the α grid from a flat per-nnz confidence vector (the
        nnz order the group was built with; padding stays 0): how
        per-interaction weights fold into an existing layout."""
        return dataclasses.replace(
            self, alpha_pad=self.scatter(alpha_flat, torch.float32))


def append_sentinel_row(vals_blk: torch.Tensor) -> torch.Tensor:
    """Flat (nnz, m) pseudo-ψ block → (nnz+1, m) slab whose last row is the
    zero sentinel that ``PaddedGroup.flat_ids`` points padding slots at, so
    the gather forms reproduce :meth:`PaddedGroup.scatter_blk`'s zeros."""
    return torch.nn.functional.pad(vals_blk, (0, 0, 0, 1))


def group_slots(rows: np.ndarray, n_rows: int, lane: int = 128):
    """``(d_pad, slot)``: each observation's rank among the observations
    of its row, in their order (first occurrence → slot 0), and the row
    width, the maximum degree rounded up to ``lane`` (at least ``lane``).
    Vectorised: a stable argsort groups each row's observations, and the
    rank is the position past the row's start."""
    deg = np.bincount(rows, minlength=n_rows)
    d_pad = max(lane, int(-(-max(1, int(deg.max(initial=0))) // lane) * lane))
    order = np.argsort(rows, kind="stable")
    start = np.cumsum(deg) - deg
    slot = np.empty(len(rows), np.int64)
    slot[order] = np.arange(len(rows)) - start[rows[order]]
    return d_pad, slot


def build_group(group_of_nnz, alpha, n_rows: int, lane: int = 128, *,
                device=None) -> PaddedGroup:
    """Build one grouping on ``device`` (the GPU unless the caller names
    the CPU). The layout is the reference's, array for array."""
    device = resolve_device(device)
    group_of_nnz = np.asarray(group_of_nnz, np.int64)
    alpha = np.asarray(alpha, np.float32)
    nnz = len(group_of_nnz)
    d_pad, slot = group_slots(group_of_nnz, n_rows, lane)
    alpha_pad = np.zeros((n_rows, d_pad), np.float32)
    alpha_pad[group_of_nnz, slot] = alpha
    flat_ids = np.full((n_rows, d_pad), nnz, np.int32)  # sentinel: zero row
    flat_ids[group_of_nnz, slot] = np.arange(nnz, dtype=np.int32)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return PaddedGroup(rows=dev(group_of_nnz), cols=dev(slot),
                       alpha_pad=dev(alpha_pad), flat_ids=dev(flat_ids),
                       n_rows=int(n_rows), d_pad=d_pad)
