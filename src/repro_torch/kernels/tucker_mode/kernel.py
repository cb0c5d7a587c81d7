"""Bind the hand-written CUDA kernels of Tucker's mode sweeps by column
(``csrc/tucker_mode.cu``), built by :mod:`repro_torch.kernels.build` at the
first launch of a width: one library a width, passed as a ``-D`` flag."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

WIDTHS = (8, 16, 32, 64, 128)  # the kernel's widths: the smallest ≥ k3 is built
SOURCE = Path(__file__).resolve().parent / "csrc" / "tucker_mode.cu"


def _bind(lib) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.tucker_mode_sweep_f32.argtypes = [
        p, i, p, ll, ll, i, p, p, p, p, p, p, i, p, ll, p, p, p, p, p, p, ll, p, i,
        p, i, p, p, p, p, f, f, f, p]
    lib.tucker_mode_sweep_f32.restype = i
    lib.tucker_mode_chunk.argtypes = []
    lib.tucker_mode_chunk.restype = i


_LIBS = {}  # width → CudaLibrary


def width_of(k3: int) -> int:
    return next(w for w in WIDTHS if w >= k3)


def library(width: int) -> CudaLibrary:
    if width not in _LIBS:
        _LIBS[width] = CudaLibrary("tucker_mode", SOURCE,
                                   defines={"TMODE_WIDTH": width}, bind=_bind)
    return _LIBS[width]


def chunk(width: int) -> int:
    """The pairs a warp of the pass takes, in the library of ``width``."""
    return library(width).load().tucker_mode_chunk()


def launch(side, b_slices, partner, partner_of_pair, group_of_pair, order, group_ptr,
           phi, j_i, w, ctx_ptr, item32, alpha, e_in, e, s, columns, delta, head, tail,
           out, alpha0: float, l2: float, eta: float) -> None:
    """Enqueue a sweep's 2·len(columns) + 1 launches on the current stream.
    The caller has checked shapes, dtypes, device and contiguity
    (``ops.mode_sweep``)."""
    k3, k_o = w.shape[1], b_slices.shape[1]
    lib = library(width_of(k3))
    so = lib.load()
    cols = (ctypes.c_int * max(1, len(columns)))(*columns)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = so.tucker_mode_sweep_f32(
            w.data_ptr(), k3, b_slices.data_ptr(), b_slices.stride(0), b_slices.stride(1),
            k_o, j_i.data_ptr(), partner.data_ptr(), partner_of_pair.data_ptr(),
            group_of_pair.data_ptr(), None if order is None else order.data_ptr(),
            group_ptr.data_ptr(), side.shape[0], phi.data_ptr(), phi.shape[0],
            ctx_ptr.data_ptr(), item32.data_ptr(), alpha.data_ptr(), e_in.data_ptr(),
            e.data_ptr(), s.data_ptr(), e.shape[0], side.data_ptr(), side.shape[1], cols,
            len(columns), delta.data_ptr(), head.data_ptr(), tail.data_ptr(),
            out.data_ptr(), alpha0, l2, eta, stream)
    lib.check(rc, "tucker_mode")
