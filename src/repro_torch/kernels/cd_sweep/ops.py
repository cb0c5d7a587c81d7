"""Public wrappers for the fused multi-column CD block-sweep family (port
of ``repro.kernels.cd_sweep.ops``).

A CUDA tensor launches the hand-written kernel (``csrc/cd_sweep.cu``) for
:func:`cd_block_sweep` and :func:`cd_block_sweep_gather`; the per-row-patch
(slice 3), slab-reduce and residual-patch (slice 4) entry points are not
ported to the card yet and raise ``NotImplementedError`` there. A CPU
tensor takes the plain version (``ref.py``) in every entry point.

``e`` is updated in place, as the reference donates it: the returned
``e`` is the caller's tensor on either device, and callers rebind
(``w, e = cd_block_sweep(...)``). The ψ slab, the W and R' slabs and the
Gram block may be column slices of wider matrices (any row stride, columns
contiguous): the kernel reads them where they lie, without a copy.

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
    _check(rows <= 1 or cols <= 1 or t.stride(1) == 1,
           f"{name}'s columns must be contiguous")


def _check_grid(name, t, shape, dtype=torch.float32):
    _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _check(tuple(t.shape) == shape and t.is_contiguous(),
           f"{name} must be a contiguous {shape} tensor, got "
           f"{tuple(t.shape)}")


def _launch(psi_blk, psi_tab, ids, alpha, e, w_blk, r1_blk, j_blk, *,
            alpha0, l2, eta):
    c, d = alpha.shape
    kb = w_blk.shape[1]
    _check_grid("alpha", alpha, (c, d))
    _check_grid("e", e, (c, d))
    _check_slab("w_blk", w_blk, c, kb)
    _check_slab("r1_blk", r1_blk, c, kb)
    _check_slab("j_blk", j_blk, kb, kb)
    if psi_tab is not None:
        _check_slab("psi_tab", psi_tab, psi_tab.shape[0], kb)
        _check(psi_tab.shape[0] >= 1, "psi_tab needs at least one row")
        _check_grid("ids", ids, (c, d), torch.int32)
    else:
        _check_grid("psi_blk", psi_blk, (c, kb, d))
    rows = (vmem.cd_sweep_gather_block_ctx(d, kb, n_rows=c)
            if psi_tab is not None else vmem.cd_sweep_block_ctx(d, kb, n_rows=c))
    w_out = torch.empty((c, kb), dtype=torch.float32, device=e.device)
    if c:
        kernel.launch(psi_blk, psi_tab, ids, alpha, e, w_blk, r1_blk, j_blk,
                      w_out, alpha0=alpha0, l2=l2, eta=eta,
                      rows_per_block=rows)
    return w_out, e


def _in_place(e, result):
    """Plain-version result with ``e`` written back into the caller's
    tensor, so both devices share one contract."""
    w_new, e_new = result
    e.copy_(e_new)
    return w_new, e


def cd_block_sweep(psi_blk, alpha, e, w_blk, r1_blk, j_blk, *, alpha0, l2,
                   eta=1.0, weights=None):
    """k_b Newton steps per row over a pre-gathered (C, k_b, D_pad) Ψ tile:
    ``(W slab (C, k_b), e)``. The rows per CUDA block come from
    :func:`~repro_torch.kernels.vmem.cd_sweep_block_ctx`."""
    alpha = _fold_weights(alpha, weights)
    if not on_cuda(psi_blk, alpha, e, w_blk, r1_blk, j_blk):
        return _in_place(e, ref.cd_block_sweep_ref(
            psi_blk, alpha, e, w_blk, r1_blk, j_blk, alpha0=alpha0, l2=l2,
            eta=eta))
    out = _launch(psi_blk, None, None, alpha, e, w_blk, r1_blk, j_blk,
                  alpha0=alpha0, l2=l2, eta=eta)
    cd_block_sweep.launches += 1
    return out


cd_block_sweep.launches = 0  # CUDA kernel launches (chip_smoke.py reads it)


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
    out = _launch(None, psi_tab, ids, alpha, e, w_blk, r1_blk, j_blk,
                  alpha0=alpha0, l2=l2, eta=eta)
    cd_block_sweep_gather.launches += 1
    return out


cd_block_sweep_gather.launches = 0


def _not_on_card(name: str, where: str, *tensors) -> None:
    if on_cuda(*tensors):
        raise NotImplementedError(
            f"{name} is not ported to the card yet: {where}")


def cd_block_sweep_rowpatch(psi_blk, alpha, e, w_blk, r1_blk, p_blk, *,
                            alpha0, l2, eta=1.0, weights=None):
    _not_on_card("cd_block_sweep_rowpatch", "slice 3", psi_blk, alpha, e)
    return _in_place(e, ref.cd_block_sweep_rowpatch_ref(
        psi_blk, _fold_weights(alpha, weights), e, w_blk, r1_blk, p_blk,
        alpha0=alpha0, l2=l2, eta=eta))


def cd_block_sweep_rowpatch_gather(psi_tab, ids, alpha, e, w_blk, r1_blk,
                                   p_blk, *, alpha0, l2, eta=1.0,
                                   weights=None):
    _not_on_card("cd_block_sweep_rowpatch_gather", "slice 3", psi_tab, ids,
                 alpha, e)
    return _in_place(e, ref.cd_block_sweep_rowpatch_gather_ref(
        psi_tab, ids, _fold_weights(alpha, weights), e, w_blk, r1_blk,
        p_blk, alpha0=alpha0, l2=l2, eta=eta))


def cd_slab_reduce(psi_blk, alpha, e, *, weights=None):
    _not_on_card("cd_slab_reduce", "slice 4", psi_blk, alpha, e)
    return ref.cd_slab_reduce_ref(psi_blk, _fold_weights(alpha, weights), e)


def cd_slab_reduce_gather(psi_tab, ids, alpha, e, *, weights=None):
    _not_on_card("cd_slab_reduce_gather", "slice 4", psi_tab, ids, alpha, e)
    return ref.cd_slab_reduce_gather_ref(
        psi_tab, ids, _fold_weights(alpha, weights), e)


def cd_resid_patch(psi_blk, e, dphi_blk):
    _not_on_card("cd_resid_patch", "slice 4", psi_blk, e, dphi_blk)
    e.copy_(ref.cd_resid_patch_ref(psi_blk, e, dphi_blk))
    return e


def cd_resid_patch_gather(psi_tab, ids, e, dphi_blk):
    _not_on_card("cd_resid_patch_gather", "slice 4", psi_tab, ids, e,
                 dphi_blk)
    e.copy_(ref.cd_resid_patch_gather_ref(psi_tab, ids, e, dphi_blk))
    return e
