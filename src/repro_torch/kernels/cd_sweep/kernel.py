"""Bind the hand-written CUDA kernels of the block-sweep family, built by
:mod:`repro_torch.kernels.build` at their first launch, one library a
source (so ``build_all`` compiles them at once):

  * ``csrc/cd_sweep.cu`` (:data:`LIB`) — the block sweep. One entry point
    serves both ψ routings (a pre-gathered (C, k_b, D_pad) tile, or the
    (n_src, k_b) ψ slab plus the (C, D_pad) id grid), both couplings (one
    shared (k_b, k_b) Gram block, or a per-row (C, k_b, k_b) patch) and
    both launch forms (warp-row, block-row; ``kernels/vmem.cd_sweep_form``).
  * ``csrc/cd_slab.cu`` (:data:`SLAB_LIB`) — the feature models' slab
    reduce and rank-m residual patch, each in both ψ routings."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import vmem
from repro_torch.kernels.build import CudaLibrary


def _bind(lib) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.cd_sweep_f32.argtypes = [p, p, ll, i, p, p, p, p, ll, p, ll, p, ll, ll,
                                 ll, p, i, i, i, f, f, f, i, p]
    lib.cd_sweep_f32.restype = i


LIB = CudaLibrary(
    "cd_sweep", Path(__file__).resolve().parent / "csrc" / "cd_sweep.cu",
    defines={"CD_BLOCK_ROW_THREADS": vmem.CD_BLOCK_ROW_THREADS},
    bind=_bind,
)


def _bind_slab(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cd_slab_reduce_f32.argtypes = [p, p, ll, i, p, p, p, p, p, i, i, i, p]
    lib.cd_slab_reduce_f32.restype = i
    lib.cd_resid_patch_f32.argtypes = [p, p, ll, i, p, p, p, ll, i, i, i, p]
    lib.cd_resid_patch_f32.restype = i


SLAB_LIB = CudaLibrary(
    "cd_slab", Path(__file__).resolve().parent / "csrc" / "cd_slab.cu",
    bind=_bind_slab,
)


def _ptr(t):
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _ld(t):
    """Row stride of a 2-D slab whose columns are contiguous (the wrappers
    check that); a one-row slab is read as contiguous."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(psi_blk, psi_tab, ids, alpha, e, w_blk, r1_blk, cpl, w_out, *,
           alpha0: float, l2: float, eta: float, rows_per_block: int) -> None:
    """Enqueue one sweep on the current stream; ``e`` is updated in place
    and the new W slab goes to ``w_out``. Exactly one of ``psi_blk`` and
    ``psi_tab`` is given. ``cpl`` is the (k_b, k_b) Gram block shared by
    every row, or the (C, k_b, k_b) per-row patch, read with its strides
    (a row stride of 0 is one block for every row). ``rows_per_block`` 0
    launches the block-row form. The caller has checked shapes, dtypes,
    device and strides (``ops``)."""
    lib = LIB.load()
    c, d = alpha.shape
    kb = w_out.shape[1]

    s0, s1, s2 = (0, *cpl.stride()) if cpl.dim() == 2 else cpl.stride()
    gather = psi_tab is not None
    with torch.cuda.device(alpha.device):
        rc = lib.cd_sweep_f32(
            _ptr(psi_blk), _ptr(psi_tab), _ld(psi_tab) if gather else 0,
            psi_tab.shape[0] if gather else 0, _ptr(ids), _ptr(alpha),
            _ptr(e), _ptr(w_blk), _ld(w_blk), _ptr(r1_blk), _ld(r1_blk),
            cpl.data_ptr(), s0, s1, s2, _ptr(w_out), c, d, kb,
            float(alpha0), float(l2), float(eta), rows_per_block,
            _stream(alpha))
    LIB.check(rc, "cd_sweep")


def slab_reduce(psi_blk, psi_tab, ids, alpha, e, q_out, p_out) -> None:
    """Enqueue one slab reduce: Q into ``q_out`` (C, m), P into ``p_out``
    (C, m, m). Exactly one of ``psi_blk`` and ``psi_tab`` is given; the
    caller has checked shapes, dtypes, device and strides (``ops``)."""
    lib = SLAB_LIB.load()
    c, d = alpha.shape
    m = q_out.shape[1]
    gather = psi_tab is not None
    with torch.cuda.device(alpha.device):
        rc = lib.cd_slab_reduce_f32(
            _ptr(psi_blk), _ptr(psi_tab), _ld(psi_tab) if gather else 0,
            psi_tab.shape[0] if gather else 0, _ptr(ids), _ptr(alpha),
            _ptr(e), _ptr(q_out), _ptr(p_out), c, d, m, _stream(alpha))
    SLAB_LIB.check(rc, "cd_slab_reduce")


def resid_patch(psi_blk, psi_tab, ids, e, dphi) -> None:
    """Enqueue one residual patch e += Σ_j Δφ_j·ψ_j on ``e`` in place. As
    :func:`slab_reduce` for ``psi_blk``/``psi_tab``; ``dphi`` is (C, m)
    with contiguous columns."""
    lib = SLAB_LIB.load()
    c, d = e.shape
    m = dphi.shape[1]
    gather = psi_tab is not None
    with torch.cuda.device(e.device):
        rc = lib.cd_resid_patch_f32(
            _ptr(psi_blk), _ptr(psi_tab), _ld(psi_tab) if gather else 0,
            psi_tab.shape[0] if gather else 0, _ptr(ids), _ptr(e), _ptr(dphi),
            _ld(dphi), c, d, m, _stream(e))
    SLAB_LIB.check(rc, "cd_resid_patch")
