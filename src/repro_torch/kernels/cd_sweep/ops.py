"""Public wrappers for the fused multi-column CD block-sweep family (port
of ``repro.kernels.cd_sweep.ops``).

A CUDA tensor launches a hand-written kernel: ``csrc/cd_sweep.cu`` for
:func:`cd_block_sweep`, :func:`cd_block_sweep_gather`,
:func:`cd_block_sweep_rowpatch` and :func:`cd_block_sweep_rowpatch_gather`,
``csrc/cd_slab.cu`` for the feature models' :func:`cd_slab_reduce`,
:func:`cd_slab_reduce_gather`, :func:`cd_resid_patch` and
:func:`cd_resid_patch_gather`. A CPU tensor takes the plain version
(``ref.py``) in every entry point.

Each block-sweep launch takes the form :func:`~repro_torch.kernels.vmem.cd_sweep_form`
picks: the warp-row form when one row fits a block's shared memory, else
the block-row form (one thread block a row). A wrapper's ``launches``
counts its kernel launches; ``launches_block_row`` counts those of them in
the block-row form.

``e`` is updated in place, as the reference donates it: the returned
``e`` is the caller's tensor on either device, and callers rebind
(``w, e = cd_block_sweep(...)``). The ψ slab, the W and R' slabs, the Gram
block and the per-row patch may be slices of wider tensors (the slabs and
the Gram block with contiguous columns, the patch with any strides, a row
stride of 0 included): the kernel reads them where they lie, without a
copy. The slab reduce and residual patch take any D_pad and any number m
of block columns; their ψ slab and Δφ slab may likewise be column slices.

Per-interaction confidence weights: every entry point takes an optional
``weights`` shaped like ``alpha``. The observed confidence enters the
sweep purely multiplicatively (L'/2 = Σ ᾱ·e·ψ, L''/2 = Σ ᾱ·ψ²; the Gram
part uses the uniform ``alpha0``), so a weighted sweep is exactly a sweep
over ``alpha·w``, folded here before the launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda, vmem
from repro_torch.kernels.cd_sweep import kernel, ref


def _fold_weights(alpha, weights):
    return alpha if weights is None else alpha * weights


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"cd_sweep: {msg}")


def _check_slab(name, t, rows, cols):
    _check(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
    _check(t.dim() == 2 and tuple(t.shape) == (rows, cols),
           f"{name} must be ({rows}, {cols}), got {tuple(t.shape)}")
    _check(cols <= 1 or t.stride(1) == 1,
           f"{name}'s columns must be contiguous")


def _check_grid(name, t, shape, dtype=torch.float32):
    _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _check(tuple(t.shape) == shape and t.is_contiguous(),
           f"{name} must be a contiguous {shape} tensor, got "
           f"{tuple(t.shape)}")


def _check_patch(t, c, kb):
    _check(t.dtype == torch.float32, f"p_blk must be float32, got {t.dtype}")
    _check(t.dim() == 3 and tuple(t.shape) == (c, kb, kb),
           f"p_blk must be ({c}, {kb}, {kb}), got {tuple(t.shape)}")


def _check_ids_slab(psi_tab, ids, c, d, m):
    _check_slab("psi_tab", psi_tab, psi_tab.shape[0], m)
    _check(psi_tab.shape[0] >= 1, "psi_tab needs at least one row")
    _check_grid("ids", ids, (c, d), torch.int32)


def _launch(psi_blk, psi_tab, ids, alpha, e, w_blk, r1_blk, cpl, *,
            alpha0, l2, eta):
    """Check, size and launch one sweep; returns ``(w_new, e, form)``.
    ``cpl`` is the shared (k_b, k_b) Gram block or the (C, k_b, k_b)
    per-row patch; a patch with row stride 0 is one block for every row
    and runs as the shared form."""
    c, d = alpha.shape
    kb = w_blk.shape[1]
    gather = psi_tab is not None
    _check_grid("alpha", alpha, (c, d))
    _check_grid("e", e, (c, d))
    _check_slab("w_blk", w_blk, c, kb)
    _check_slab("r1_blk", r1_blk, c, kb)
    if cpl.dim() == 3:
        _check_patch(cpl, c, kb)
    else:
        _check_slab("j_blk", cpl, kb, kb)
    if gather:
        _check_ids_slab(psi_tab, ids, c, d, kb)
    else:
        _check_grid("psi_blk", psi_blk, (c, kb, d))
    rowpatch = cpl.dim() == 3 and c > 1 and cpl.stride(0) != 0
    if cpl.dim() == 3 and not rowpatch:
        cpl = cpl[0]  # one block for every row: the shared form
    form = vmem.cd_sweep_form(d, kb, gather=gather, rowpatch=rowpatch)
    rows = 0
    if form == vmem.WARP_ROW:
        rows = (vmem.cd_sweep_gather_block_ctx if gather else
                vmem.cd_sweep_block_ctx)(d, kb, n_rows=c, rowpatch=rowpatch)
    w_out = torch.empty((c, kb), dtype=torch.float32, device=e.device)
    if c:
        kernel.launch(psi_blk, psi_tab, ids, alpha, e, w_blk, r1_blk, cpl,
                      w_out, alpha0=alpha0, l2=l2, eta=eta,
                      rows_per_block=rows)
    return w_out, e, form


def _counted(fn, form):
    fn.launches += 1
    if form == vmem.BLOCK_ROW:
        fn.launches_block_row += 1


def _in_place(e, result):
    """Plain-version result with ``e`` written back into the caller's
    tensor, so both devices share one contract."""
    w_new, e_new = result
    e.copy_(e_new)
    return w_new, e


def cd_block_sweep(psi_blk, alpha, e, w_blk, r1_blk, j_blk, *, alpha0, l2,
                   eta=1.0, weights=None):
    """k_b Newton steps per row over a pre-gathered (C, k_b, D_pad) Ψ tile
    with one shared (k_b, k_b) Gram block: ``(W slab (C, k_b), e)``."""
    alpha = _fold_weights(alpha, weights)
    if not on_cuda(psi_blk, alpha, e, w_blk, r1_blk, j_blk):
        return _in_place(e, ref.cd_block_sweep_ref(
            psi_blk, alpha, e, w_blk, r1_blk, j_blk, alpha0=alpha0, l2=l2,
            eta=eta))
    w, e, form = _launch(psi_blk, None, None, alpha, e, w_blk, r1_blk, j_blk,
                         alpha0=alpha0, l2=l2, eta=eta)
    _counted(cd_block_sweep, form)
    return w, e


def cd_block_sweep_gather(psi_tab, ids, alpha, e, w_blk, r1_blk, j_blk, *,
                          alpha0, l2, eta=1.0, weights=None):
    """:func:`cd_block_sweep` with ψ gathered in the kernel from the
    (n_src, k_b) slab through the (C, D_pad) int32 id grid (ids clipped
    to the slab; padding points at row 0 with α = 0)."""
    alpha = _fold_weights(alpha, weights)
    if not on_cuda(psi_tab, ids, alpha, e, w_blk, r1_blk, j_blk):
        return _in_place(e, ref.cd_block_sweep_gather_ref(
            psi_tab, ids, alpha, e, w_blk, r1_blk, j_blk, alpha0=alpha0,
            l2=l2, eta=eta))
    w, e, form = _launch(None, psi_tab, ids, alpha, e, w_blk, r1_blk, j_blk,
                         alpha0=alpha0, l2=l2, eta=eta)
    _counted(cd_block_sweep_gather, form)
    return w, e


def cd_block_sweep_rowpatch(psi_blk, alpha, e, w_blk, r1_blk, p_blk, *,
                            alpha0, l2, eta=1.0, weights=None):
    """:func:`cd_block_sweep` with a per-row (C, k_b, k_b) patch P in place
    of the shared Gram block: the denominator takes P[r, j, j] (R''/2) and
    the Gauss–Seidel patch is R' += Δ·P[r, j, :] (the context modes of the
    tensor models, eqs. 37–38)."""
    alpha = _fold_weights(alpha, weights)
    if not on_cuda(psi_blk, alpha, e, w_blk, r1_blk, p_blk):
        return _in_place(e, ref.cd_block_sweep_rowpatch_ref(
            psi_blk, alpha, e, w_blk, r1_blk, p_blk, alpha0=alpha0, l2=l2,
            eta=eta))
    w, e, form = _launch(psi_blk, None, None, alpha, e, w_blk, r1_blk, p_blk,
                         alpha0=alpha0, l2=l2, eta=eta)
    _counted(cd_block_sweep_rowpatch, form)
    return w, e


def cd_block_sweep_rowpatch_gather(psi_tab, ids, alpha, e, w_blk, r1_blk,
                                   p_blk, *, alpha0, l2, eta=1.0,
                                   weights=None):
    """:func:`cd_block_sweep_rowpatch` with ψ gathered in the kernel from
    a flat (nnz + 1, k_b) pseudo-ψ slab through the (C, D_pad) id grid;
    padding slots point at the zero sentinel row ``nnz``."""
    alpha = _fold_weights(alpha, weights)
    if not on_cuda(psi_tab, ids, alpha, e, w_blk, r1_blk, p_blk):
        return _in_place(e, ref.cd_block_sweep_rowpatch_gather_ref(
            psi_tab, ids, alpha, e, w_blk, r1_blk, p_blk, alpha0=alpha0,
            l2=l2, eta=eta))
    w, e, form = _launch(None, psi_tab, ids, alpha, e, w_blk, r1_blk, p_blk,
                         alpha0=alpha0, l2=l2, eta=eta)
    _counted(cd_block_sweep_rowpatch_gather, form)
    return w, e


# CUDA kernel launches, and those of them in the block-row form
# (chip_smoke.py reads both)
for _fn in (cd_block_sweep, cd_block_sweep_gather, cd_block_sweep_rowpatch,
            cd_block_sweep_rowpatch_gather):
    _fn.launches = 0
    _fn.launches_block_row = 0
del _fn


def _slab_launch(psi_blk, psi_tab, ids, alpha, e, m):
    _check(alpha.dim() == 2, f"alpha must be (C, D_pad), got "
           f"{tuple(alpha.shape)}")
    c, d = alpha.shape
    _check_grid("alpha", alpha, (c, d))
    _check_grid("e", e, (c, d))
    if psi_tab is not None:
        _check_ids_slab(psi_tab, ids, c, d, m)
    else:
        _check_grid("psi_blk", psi_blk, (c, m, d))
    q = torch.empty((c, m), dtype=torch.float32, device=e.device)
    p = torch.empty((c, m, m), dtype=torch.float32, device=e.device)
    if c:
        kernel.slab_reduce(psi_blk, psi_tab, ids, alpha, e, q, p)
    return q, p


def cd_slab_reduce(psi_blk, alpha, e, *, weights=None):
    """Per-row moments of a pre-gathered (C, m, D_pad) Ψ tile in one e/α
    pass: ``(Q (C, m), P (C, m, m))`` with Q[r, j] = Σ_d α·e·ψ_j and
    P[r, i, j] = Σ_d α·ψ_i·ψ_j (the feature models' q, p2 and coupling
    caches, Algorithm 3)."""
    alpha = _fold_weights(alpha, weights)
    if not on_cuda(psi_blk, alpha, e):
        return ref.cd_slab_reduce_ref(psi_blk, alpha, e)
    _check(psi_blk.dim() == 3, f"psi_blk must be (C, m, D_pad), got "
           f"{tuple(psi_blk.shape)}")
    q, p = _slab_launch(psi_blk, None, None, alpha, e, psi_blk.shape[1])
    cd_slab_reduce.launches += int(e.shape[0] > 0)
    return q, p


def cd_slab_reduce_gather(psi_tab, ids, alpha, e, *, weights=None):
    """:func:`cd_slab_reduce` with ψ gathered in the kernel from the
    (n_src, m) slab through the (C, D_pad) int32 id grid (ids clipped to
    the slab; padding slots carry α = 0)."""
    alpha = _fold_weights(alpha, weights)
    if not on_cuda(psi_tab, ids, alpha, e):
        return ref.cd_slab_reduce_gather_ref(psi_tab, ids, alpha, e)
    _check(psi_tab.dim() == 2, f"psi_tab must be (n_src, m), got "
           f"{tuple(psi_tab.shape)}")
    q, p = _slab_launch(None, psi_tab, ids, alpha, e, psi_tab.shape[1])
    cd_slab_reduce_gather.launches += int(e.shape[0] > 0)
    return q, p


def _patch_launch(psi_blk, psi_tab, ids, e, dphi_blk):
    _check(e.dim() == 2, f"e must be (C, D_pad), got {tuple(e.shape)}")
    c, d = e.shape
    _check_grid("e", e, (c, d))
    _check(dphi_blk.dim() == 2, f"dphi_blk must be (C, m), got "
           f"{tuple(dphi_blk.shape)}")
    m = dphi_blk.shape[1]
    _check_slab("dphi_blk", dphi_blk, c, m)
    if psi_tab is not None:
        _check_ids_slab(psi_tab, ids, c, d, m)
    else:
        _check_grid("psi_blk", psi_blk, (c, m, d))
    if c:
        kernel.resid_patch(psi_blk, psi_tab, ids, e, dphi_blk)
    return e


def cd_resid_patch(psi_blk, e, dphi_blk):
    """Rank-m residual patch e += Σ_j Δφ_j·ψ_j over a pre-gathered (C, m,
    D_pad) Ψ tile, on ``e`` in place; returns ``e``."""
    if not on_cuda(psi_blk, e, dphi_blk):
        e.copy_(ref.cd_resid_patch_ref(psi_blk, e, dphi_blk))
        return e
    e = _patch_launch(psi_blk, None, None, e, dphi_blk)
    cd_resid_patch.launches += int(e.shape[0] > 0)
    return e


def cd_resid_patch_gather(psi_tab, ids, e, dphi_blk):
    """:func:`cd_resid_patch` with ψ gathered in the kernel from the
    (n_src, m) slab through the (C, D_pad) id grid (ids clipped)."""
    if not on_cuda(psi_tab, ids, e, dphi_blk):
        e.copy_(ref.cd_resid_patch_gather_ref(psi_tab, ids, e, dphi_blk))
        return e
    e = _patch_launch(None, psi_tab, ids, e, dphi_blk)
    cd_resid_patch_gather.launches += int(e.shape[0] > 0)
    return e


# CUDA kernel launches (chip_smoke.py reads them)
for _fn in (cd_slab_reduce, cd_slab_reduce_gather, cd_resid_patch,
            cd_resid_patch_gather):
    _fn.launches = 0
del _fn
