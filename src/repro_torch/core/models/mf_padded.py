"""Kernel-fused iCD-MF over the padded observation layout (port of
``repro.core.models.mf_padded``).

The same Newton steps in the same order as ``mf.epoch``, laid out for the
hand-written kernels:

  * observations padded per row to the maximum degree (α = 0 on padding),
    so the explicit reductions are dense (C, D_pad) rows, no segment ops;
  * J through the Gram kernel (``kernels/gram``);
  * the dimension sweep through ``sweeps.sweep_columns``: blocks of
    ``hp.block_k`` columns run in the fused block-sweep kernel
    (``kernels/cd_sweep``: e and α stay on chip across the block, one pass
    over the (C, D_pad) grids per block instead of one per column);
    ``hp.block_k=1`` runs the per-column update (``kernels/cd_update``,
    the block kernel at k_b = 1).

Ψ routing (``hp.psi_dispatch``): ``'gather'`` (default) passes the ψ slab
``other[:, f0:f0+k_b]`` and the (C, D_pad) id grid, and the kernel
gathers; ``'pregather'`` builds the (C, k_b, D_pad) Ψ tile first (one
copy per dispatch, k_b× the residual grid in device memory).

The residual grid ``e_pad`` is updated in place, as the reference donates
it: callers rebind (``params, e_pad = epoch(...)``) and do not reuse the
tensor they passed. Rows are not padded to the kernel's tile: the kernel
checks its bounds.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import sweeps
from repro_torch.core.gram import full_fp32
from repro_torch.core.models.mf import MFHyperParams, MFParams
from repro_torch.core.padded import group_slots
from repro_torch.kernels import vmem
from repro_torch.kernels.cd_sweep.ops import cd_block_sweep, cd_block_sweep_gather
from repro_torch.kernels.cd_update.ops import cd_column_update
from repro_torch.kernels.gram.ops import gram as gram_kernel
from repro_torch.sparse.interactions import Interactions

# rows of the residual computation at a time: its (rows, D_pad, k)
# product stays under ~256 MB at any width
_RESID_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class PaddedInteractions:
    """Dual padded layout of the rescaled observed set S̄."""

    # context-major: (n_ctx, d_ctx)
    item_ids: torch.Tensor  # int32, padding → 0
    alpha_c: torch.Tensor   # 0 on padding
    y_c: torch.Tensor
    # item-major: (n_items, d_item)
    ctx_ids: torch.Tensor
    alpha_i: torch.Tensor
    y_i: torch.Tensor
    # flat (ctx-major nnz) <-> padded coordinates, for residual transfer
    c_rows: torch.Tensor    # (nnz,) row in the ctx-major grid
    c_cols: torch.Tensor    # (nnz,) slot in the ctx-major grid
    i_rows: torch.Tensor    # (nnz,) row in the item-major grid (ctx-major order)
    i_cols: torch.Tensor
    n_ctx: int
    n_items: int


def pad_interactions(data: Interactions, lane: int = 128) -> PaddedInteractions:
    """Build the dual padded layout on the data's device (degrees padded
    to the maximum, the slot dimension rounded up to ``lane``). Equal,
    array for array, to the reference's; the slots come from a vectorised
    rank instead of its per-observation loop."""
    ctx = data.ctx.cpu().numpy()
    item = data.item.cpu().numpy()
    alpha = data.alpha.cpu().numpy()
    y = data.y.cpu().numpy()
    d_c, slot_c = group_slots(ctx, data.n_ctx, lane)
    d_i, slot_i = group_slots(item, data.n_items, lane)

    def grid(shape, rows, cols, vals, dtype):
        out = np.zeros(shape, dtype)
        out[rows, cols] = vals
        return torch.as_tensor(out, device=data.device)

    def flat(a):
        return torch.as_tensor(a, dtype=torch.int64, device=data.device)

    return PaddedInteractions(
        item_ids=grid((data.n_ctx, d_c), ctx, slot_c, item, np.int32),
        alpha_c=grid((data.n_ctx, d_c), ctx, slot_c, alpha, np.float32),
        y_c=grid((data.n_ctx, d_c), ctx, slot_c, y, np.float32),
        ctx_ids=grid((data.n_items, d_i), item, slot_i, ctx, np.int32),
        alpha_i=grid((data.n_items, d_i), item, slot_i, alpha, np.float32),
        y_i=grid((data.n_items, d_i), item, slot_i, y, np.float32),
        c_rows=flat(ctx), c_cols=flat(slot_c),
        i_rows=flat(item), i_cols=flat(slot_i),
        n_ctx=data.n_ctx, n_items=data.n_items,
    )


def scatter_ctx_major(pdata: PaddedInteractions, e_flat) -> torch.Tensor:
    """Flat per-nnz vector (ctx-major order) → ctx-major padded grid."""
    out = torch.zeros_like(pdata.alpha_c)
    out[pdata.c_rows, pdata.c_cols] = e_flat
    return out


def transfer_ctx_to_item(pdata: PaddedInteractions, e_pad) -> torch.Tensor:
    """Residual grid ctx-major → item-major through the flat nnz order."""
    out = torch.zeros_like(pdata.alpha_i)
    out[pdata.i_rows, pdata.i_cols] = e_pad[pdata.c_rows, pdata.c_cols]
    return out


def transfer_item_to_ctx(pdata: PaddedInteractions, e_pad_i) -> torch.Tensor:
    """Inverse of :func:`transfer_ctx_to_item`."""
    out = torch.zeros_like(pdata.alpha_c)
    out[pdata.c_rows, pdata.c_cols] = e_pad_i[pdata.i_rows, pdata.i_cols]
    return out


def _padded_side_sweep(side, other, other_j, ids_pad, alpha_pad, e_pad,
                       hp: MFHyperParams):
    """One side's sweep; ``side`` and ``e_pad`` are updated in place."""
    k = side.shape[1]
    k_b = sweeps.resolve_block_k(hp.block_k, k)
    use_block = k_b > 1 and not hp.unroll  # unroll = explicit per-column ask
    use_gather = vmem.resolve_cd_sweep_dispatch(
        ids_pad.shape[1], k_b,
        prefer_gather=sweeps.resolve_psi_dispatch(hp.psi_dispatch))
    ids_long = None

    def body(f, carry):
        nonlocal ids_long
        side_m, e_pad = carry
        if ids_long is None:
            ids_long = ids_pad.long()
        psi_pad = sweeps.take_col(other, f)[ids_long]        # (n, d_pad)
        r1 = side_m @ sweeps.take_col(other_j, f)
        w_new, e_pad = cd_column_update(
            psi_pad, alpha_pad, e_pad, sweeps.take_col(side_m, f), r1,
            other_j[f, f], alpha0=hp.alpha0, l2=hp.l2, eta=hp.eta)
        return sweeps.put_col(side_m, f, w_new), e_pad

    def block_body(f0, kb, carry):
        nonlocal ids_long
        side_m, e_pad = carry
        cols = slice(f0, f0 + kb)
        r1_blk = side_m @ other_j[:, cols]                  # R'/2 slab
        if use_gather:
            # ψ slab (n_src, kb) + id grid: the kernel gathers Ψ rows
            w_new, e_pad = cd_block_sweep_gather(
                other[:, cols], ids_pad, alpha_pad, e_pad, side_m[:, cols],
                r1_blk, other_j[cols, cols], alpha0=hp.alpha0, l2=hp.l2,
                eta=hp.eta)
        else:
            # pre-gathered Ψ tile (n, kb, d_pad)
            if ids_long is None:
                ids_long = ids_pad.long()
            psi_blk = other[:, cols][ids_long].movedim(-1, 1).contiguous()
            w_new, e_pad = cd_block_sweep(
                psi_blk, alpha_pad, e_pad, side_m[:, cols], r1_blk,
                other_j[cols, cols], alpha0=hp.alpha0, l2=hp.l2, eta=hp.eta)
        side_m[:, cols] = w_new
        return side_m, e_pad

    return sweeps.sweep_columns(
        k, body, (side, e_pad), unroll=hp.unroll, block=k_b,
        block_body=block_body if use_block else None)


def reweight_padded(pdata: PaddedInteractions, weights) -> PaddedInteractions:
    """Fold per-interaction weights (flat nnz, ctx-major order) into both
    padded α grids: α_eff = α·w on real slots; padding stays α = 0."""
    w_c = torch.ones_like(pdata.alpha_c)
    w_c[pdata.c_rows, pdata.c_cols] = weights
    w_i = torch.ones_like(pdata.alpha_i)
    w_i[pdata.i_rows, pdata.i_cols] = weights
    return dataclasses.replace(pdata, alpha_c=pdata.alpha_c * w_c,
                               alpha_i=pdata.alpha_i * w_i)


def epoch(params: MFParams, pdata: PaddedInteractions, e_pad: torch.Tensor,
          hp: MFHyperParams, weights=None) -> Tuple[MFParams, torch.Tensor]:
    """Kernel-fused iCD epoch; carries the ctx-major padded residual grid.

    ``e_pad`` is consumed (updated in place, as the reference donates it);
    ``params`` are left as they were. ``weights`` (optional, flat nnz
    ctx-major) folds per-interaction confidence into both α grids."""
    if weights is not None:
        pdata = reweight_padded(pdata, weights)
    w, h = params.w.clone(), params.h.clone()
    with full_fp32():
        j_i = gram_kernel(h)
        w, e_pad = _padded_side_sweep(w, h, j_i, pdata.item_ids,
                                      pdata.alpha_c, e_pad, hp)
        e_pad_i = transfer_ctx_to_item(pdata, e_pad)
        j_c = gram_kernel(w)
        h, e_pad_i = _padded_side_sweep(h, w, j_c, pdata.ctx_ids,
                                        pdata.alpha_i, e_pad_i, hp)
    return MFParams(w, h), transfer_item_to_ctx(pdata, e_pad_i)


def residuals(params: MFParams, pdata: PaddedInteractions) -> torch.Tensor:
    """ŷ−ȳ on the ctx-major padded grid (padding holds ⟨w_c, h_0⟩, which
    α = 0 cancels). Computed a band of rows at a time."""
    n, d_pad = pdata.item_ids.shape
    k = params.w.shape[1]
    step = max(1, _RESID_BYTES // max(1, 4 * d_pad * k))
    out = torch.empty_like(pdata.y_c)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        h_rows = params.h[pdata.item_ids[lo:hi].long()]    # (rows, d_pad, k)
        out[lo:hi] = torch.sum(params.w[lo:hi, None, :] * h_rows, dim=-1)
    return out - pdata.y_c


def fit(params: MFParams, pdata: PaddedInteractions, hp: MFHyperParams,
        n_epochs: int, weights=None, callback=None) -> MFParams:
    """Run ``n_epochs`` fused epochs; ``callback(epoch, params)`` after
    each (the reference's ``fit`` takes none)."""
    e_pad = residuals(params, pdata)
    for ep in range(n_epochs):
        params, e_pad = epoch(params, pdata, e_pad, hp, weights)
        if callback is not None:
            callback(ep, params)
    return params
