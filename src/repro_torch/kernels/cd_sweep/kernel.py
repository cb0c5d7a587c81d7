"""Bind the hand-written CUDA kernels of the block-sweep family, built by
:mod:`repro_torch.kernels.build` at their first launch, one library a
source (so ``build_all`` compiles them at once):

  * ``csrc/cd_sweep.cu`` (:data:`LIB`) — the block sweep. One entry point
    serves both ψ routings (a pre-gathered (C, k_b, D_pad) tile, or the
    (n_src, k_b) ψ slab plus the (C, D_pad) id grid), both couplings (one
    shared (k_b, k_b) Gram block, or a per-row (C, k_b, k_b) patch) and
    both launch forms (warp-row, block-row; ``kernels/vmem.cd_sweep_form``).
  * ``csrc/cd_slab.cu`` (:data:`SLAB_LIB`) — the feature models' slab
    reduce and rank-m residual patch, each in both ψ routings.
  * ``csrc/cd_gather.cu`` (:data:`GATHER_LIB`) — the redesigned forms: the
    block sweep's register-row form and split-row form (long rows, three
    launches), gathered (shared J or per-row patch) or, for the row patch,
    from the pre-gathered tile; the slab reduce's one-tile form (m ≤ 9:
    an instance at m ≤ 8 and one at m = 9) and the residual patch's
    register-slot form (m ≤ 8), each in both ψ routings; their sizes come
    from ``kernels/vmem`` as ``-D`` flags."""
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


def _bind_gather(lib) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.cd_sweep_reg_f32.argtypes = [p, p, ll, i, p, p, p, p, ll, p, ll, p,
                                     ll, ll, ll, p, i, i, i, f, f, f, i, i, p]
    lib.cd_sweep_reg_f32.restype = i
    lib.cd_sweep_split_row_f32.argtypes = [p, p, ll, i, p, p, p, p, ll, p, ll,
                                           p, ll, ll, ll, p, p, p, i, i, i, f,
                                           f, f, i, p]
    lib.cd_sweep_split_row_f32.restype = i
    lib.cd_slab_reduce_reg_f32.argtypes = [p, p, ll, i, p, p, p, p, p, i, i,
                                           i, i, p]
    lib.cd_slab_reduce_reg_f32.restype = i
    lib.cd_resid_patch_reg_f32.argtypes = [p, p, ll, i, p, p, p, ll, i, i, i,
                                           p]
    lib.cd_resid_patch_reg_f32.restype = i


GATHER_DEFINES = {
    "CDG_THREADS": vmem.CDG_THREADS,
    "CDG_SWEEP_MIN_BLOCKS": vmem.CDG_SWEEP_MIN_BLOCKS,
    "CDG_SWEEP_REG_SLOTS": vmem.CDG_SWEEP_REG_SLOTS,
    "CDG_SLAB_MIN_BLOCKS": vmem.CDG_SLAB_MIN_BLOCKS,
    "CDG_SLAB_INFLIGHT": vmem.CDG_SLAB_INFLIGHT,
    "CDG_PATCH_SLOTS": vmem.CDG_PATCH_SLOTS,
    "CDG_SLAB_WIDE_MIN_BLOCKS": vmem.CDG_SLAB_WIDE_MIN_BLOCKS,
    "CDG_SLAB_WIDE_INFLIGHT": vmem.CDG_SLAB_WIDE_INFLIGHT,
}

GATHER_LIB = CudaLibrary(
    "cd_gather", Path(__file__).resolve().parent / "csrc" / "cd_gather.cu",
    defines=GATHER_DEFINES, bind=_bind_gather,
)


def _ptr(t):
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _ld(t):
    """Row stride of a 2-D slab whose columns are contiguous (the wrappers
    check that); a one-row slab is read as contiguous."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _cpl_strides(cpl):
    """(row, i, f) strides of a coupling block: a 2-D J is one block for
    every row (row stride 0)."""
    return (0, *cpl.stride()) if cpl.dim() == 2 else cpl.stride()


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

    s0, s1, s2 = _cpl_strides(cpl)
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


def _source(psi_tab, ids, psi_blk):
    """(psi_blk, slab, slab row stride, slab rows, ids) pointers and sizes
    of a ψ source: the pre-gathered tile or the gathered slab."""
    if psi_blk is not None:
        return _ptr(psi_blk), None, 0, 0, None
    return None, _ptr(psi_tab), _ld(psi_tab), psi_tab.shape[0], _ptr(ids)


def launch_reg(psi_tab, ids, alpha, e, w_blk, r1_blk, cpl, w_out, *,
               alpha0: float, l2: float, eta: float, lanes: int, slots: int,
               psi_blk=None, lib=None) -> None:
    """Enqueue one sweep in the register-row form: ``lanes`` threads a
    row, ``slots`` slots a thread (``vmem.cd_sweep_reg_group``); ``e`` in
    place, W into ``w_out``. ψ is gathered from ``psi_tab`` through
    ``ids``, or, with ``psi_blk`` (C, k_b, D_pad) given (``psi_tab`` and
    ``ids`` None; the per-row patch only), read from the pre-gathered
    tile. ``cpl`` is the shared (k_b, k_b) J or the (C, k_b, k_b) per-row
    patch, read with its strides. ``lib`` is :data:`GATHER_LIB` or a
    variant build of its source. The caller has checked shapes, dtypes,
    device and strides (``ops``)."""
    lib = lib or GATHER_LIB
    fn = lib.load().cd_sweep_reg_f32
    c, d = alpha.shape
    kb = w_out.shape[1]
    with torch.cuda.device(alpha.device):
        rc = fn(*_source(psi_tab, ids, psi_blk), _ptr(alpha), _ptr(e),
                _ptr(w_blk), _ld(w_blk), _ptr(r1_blk), _ld(r1_blk),
                cpl.data_ptr(), *_cpl_strides(cpl), _ptr(w_out), c, d, kb,
                float(alpha0), float(l2), float(eta), lanes, slots,
                _stream(alpha))
    lib.check(rc, "cd_sweep_reg")


def launch_split(psi_tab, ids, alpha, e, w_blk, r1_blk, cpl, w_out, part,
                 delta, *, alpha0: float, l2: float, eta: float, chunk: int,
                 psi_blk=None, lib=None) -> None:
    """Enqueue one sweep in the split-row form, three launches: pass 1
    (one block a ``chunk``-slot chunk of a row) writes each chunk's 44
    moments to ``part`` (C, ⌈D_pad/chunk⌉, 44), the solve writes W to
    ``w_out`` and Δ to ``delta`` (C, k_b), pass 2 patches ``e`` in place.
    ``cpl`` and the ψ source (``psi_tab`` and ``ids``, or ``psi_blk``) as
    in :func:`launch_reg`, the tile here with either coupling; the caller
    has checked the rest and allocated the scratch (``ops``)."""
    lib = lib or GATHER_LIB
    fn = lib.load().cd_sweep_split_row_f32
    c, d = alpha.shape
    kb = w_out.shape[1]
    with torch.cuda.device(alpha.device):
        rc = fn(*_source(psi_tab, ids, psi_blk), _ptr(alpha), _ptr(e),
                _ptr(w_blk), _ld(w_blk), _ptr(r1_blk), _ld(r1_blk),
                cpl.data_ptr(), *_cpl_strides(cpl), _ptr(w_out), _ptr(part),
                _ptr(delta), c, d, kb, float(alpha0), float(l2), float(eta),
                chunk, _stream(alpha))
    lib.check(rc, "cd_sweep_split_row")


def slab_reduce_reg(psi_tab, ids, alpha, e, q_out, p_out, *, lanes: int,
                    psi_blk=None, lib=None) -> None:
    """Enqueue one slab reduce in the one-tile form (m ≤ 9: the instance
    at m ≤ 8, or at m = 9 the one of 54 sums, 32 lanes only), ``lanes``
    threads a row (``vmem.cd_slab_reduce_lanes``): ψ gathered from
    ``psi_tab`` through ``ids``, or, with ``psi_blk`` (C, m, D_pad) given
    (``psi_tab`` and ``ids`` None), read from the pre-gathered tile; as
    :func:`slab_reduce` otherwise."""
    lib = lib or GATHER_LIB
    fn = lib.load().cd_slab_reduce_reg_f32
    c, d = alpha.shape
    with torch.cuda.device(alpha.device):
        rc = fn(*_source(psi_tab, ids, psi_blk), _ptr(alpha), _ptr(e),
                _ptr(q_out), _ptr(p_out), c, d, q_out.shape[1], lanes,
                _stream(alpha))
    lib.check(rc, "cd_slab_reduce_reg")


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


def resid_patch_reg(psi_tab, ids, e, dphi, *, psi_blk=None, lib=None) -> None:
    """Enqueue one residual patch in the register-slot form (m ≤ 8,
    ``vmem.CDG_PATCH_SLOTS`` slots a thread): ψ gathered from ``psi_tab``
    through ``ids``, or, with ``psi_blk`` (C, m, D_pad) given (``psi_tab``
    and ``ids`` None), read from the pre-gathered tile; as
    :func:`resid_patch` otherwise."""
    lib = lib or GATHER_LIB
    fn = lib.load().cd_resid_patch_reg_f32
    c, d = e.shape
    with torch.cuda.device(e.device):
        rc = fn(*_source(psi_tab, ids, psi_blk), _ptr(e), _ptr(dphi),
                _ld(dphi), c, d, dphi.shape[1], _stream(e))
    lib.check(rc, "cd_resid_patch_reg")


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
