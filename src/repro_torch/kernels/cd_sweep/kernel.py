"""Bind the hand-written CUDA block-sweep kernel (``csrc/cd_sweep.cu``),
built by :mod:`repro_torch.kernels.build` at its first launch. One entry
point serves both ψ routings (a pre-gathered (C, k_b, D_pad) tile, or the
(n_src, k_b) ψ slab plus the (C, D_pad) id grid), both couplings (one
shared (k_b, k_b) Gram block, or a per-row (C, k_b, k_b) patch) and both
launch forms (warp-row, block-row; ``kernels/vmem.cd_sweep_form``)."""
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

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    def ld(t):
        return t.stride(0) if t.shape[0] > 1 else t.shape[1]

    s0, s1, s2 = (0, *cpl.stride()) if cpl.dim() == 2 else cpl.stride()
    gather = psi_tab is not None
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream(alpha.device).cuda_stream
        rc = lib.cd_sweep_f32(
            ptr(psi_blk), ptr(psi_tab), ld(psi_tab) if gather else 0,
            psi_tab.shape[0] if gather else 0, ptr(ids), ptr(alpha), ptr(e),
            ptr(w_blk), ld(w_blk), ptr(r1_blk), ld(r1_blk), cpl.data_ptr(),
            s0, s1, s2, ptr(w_out), c, d, kb, float(alpha0), float(l2),
            float(eta), rows_per_block, stream)
    LIB.check(rc, "cd_sweep")
