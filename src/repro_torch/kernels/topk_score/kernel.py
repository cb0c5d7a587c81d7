"""Bind the hand-written CUDA top-K kernel (``csrc/topk_score.cu``).

The source is built by :mod:`repro_torch.kernels.build` at the first
launch, with the tile sizes of :mod:`repro_torch.kernels.vmem` passed as
``-D`` flags, and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import vmem
from repro_torch.kernels.build import CudaLibrary


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_score_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i,
                                   p, p, p, p, p]
    lib.topk_score_f32.restype = i
    lib.topk_score_wide_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i,
                                        ctypes.c_longlong, p, p, p, p, p]
    lib.topk_score_wide_f32.restype = i


LIB = CudaLibrary(
    "topk_score", Path(__file__).resolve().parent / "csrc" / "topk_score.cu",
    defines={
        "TOPK_ROWS": vmem.TOPK_ROW_BLOCK,
        "TOPK_DSLAB": vmem.TOPK_D_SLAB,
        "TOPK_MAX_CHUNK": vmem.TOPK_MAX_CHUNK,
        "TOPK_MERGE_SLOTS": vmem.TOPK_MERGE_SLOTS,
        "TOPK_MERGE_THREADS": vmem.TOPK_MERGE_THREADS,
        "TOPK_WIDE_KEYS": vmem.TOPK_WIDE_KEYS,
    },
    bind=_bind,
)


def launch(phi: torch.Tensor, psi: torch.Tensor, exclude_ids, k: int,
           k_pad: int, chunk: int, id_offset: int, n_valid: int,
           scores: torch.Tensor, ids: torch.Tensor,
           cand: torch.Tensor, cand2: torch.Tensor, *, wide: bool) -> None:
    """Enqueue both passes on the current stream. ``cand`` holds
    (chunks, B, k_pad) candidate keys and ``cand2`` (⌈chunks/16⌉, B,
    k_pad), the merge levels' other buffer; on the large-K path
    (``wide``, chosen by the caller) each holds B·chunks·chunk keys. The
    caller has checked every shape, dtype, device and contiguity
    (``ops.topk_score``)."""
    lib = LIB.load()
    b, d = phi.shape
    n_rows = psi.shape[0]
    n_excl = 0 if exclude_ids is None else exclude_ids.shape[1]
    excl_ptr = None if n_excl == 0 else exclude_ids.data_ptr()
    # the launches go to the current device, which is φ's only for the
    # call: the caller's current device is left as it was
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        args = (phi.data_ptr(), psi.data_ptr() if n_rows else None, excl_ptr,
                b, n_rows, d, n_excl, id_offset, n_valid, k, k_pad, chunk)
        bufs = (cand.data_ptr() if cand.numel() else None,
                cand2.data_ptr() if cand2.numel() else None,
                scores.data_ptr(), ids.data_ptr(), stream)
        if wide:
            rc = lib.topk_score_wide_f32(*args, cand.numel() // b, *bufs)
        else:
            rc = lib.topk_score_f32(*args, *bufs)
    LIB.check(rc, "topk_score")
