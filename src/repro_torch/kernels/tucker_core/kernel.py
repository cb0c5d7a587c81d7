"""Bind the hand-written CUDA kernels of Tucker's blocked core sweep
(``csrc/tucker_core.cu``), built by :mod:`repro_torch.kernels.build` at the
first launch of a width: one library a width, passed as a ``-D`` flag."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

WIDTHS = (8, 16, 32, 64, 128)  # the kernel's widths: the smallest ≥ k3 is built
GROUPS = 8                      # warps a block of the pass, each its own tile
SOURCE = Path(__file__).resolve().parent / "csrc" / "tucker_core.cu"


def _bind(lib) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.tucker_core_sweep_f32.argtypes = [
        p, i, p, ll, p, i, p, p, p, p, p, p, p, ll, p, p, i, f, f, f, p]
    lib.tucker_core_sweep_f32.restype = i
    lib.tucker_core_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.tucker_core_layout.restype = i


_LIBS = {}    # width → CudaLibrary
_LAYOUT = {}  # (device index, width) → (pass blocks, a block's partials, its tile)


def width_of(k3: int) -> int:
    return next(w for w in WIDTHS if w >= k3)


def library(width: int) -> CudaLibrary:
    if width not in _LIBS:
        _LIBS[width] = CudaLibrary(
            "tucker_core", SOURCE,
            defines={"TCORE_WIDTH": width, "TCORE_GROUPS": GROUPS}, bind=_bind)
    return _LIBS[width]


def layout(device: torch.device, width: int) -> tuple:
    """For the library of ``width`` on ``device``: the most blocks the pass
    keeps resident, the floats of one block's partial sums, and the
    interactions a block's tile holds."""
    key = (device.index, width)
    if key not in _LAYOUT:
        lib = library(width)
        so = lib.load()
        out = [ctypes.c_int(0) for _ in range(3)]
        with torch.cuda.device(device):
            lib.check(so.tucker_core_layout(*map(ctypes.byref, out)), "tucker_core")
        _LAYOUT[key] = tuple(x.value for x in out)
    return _LAYOUT[key]


def launch(w, gp, gram_g, r, b, j_i, ctx_ptr, item32, alpha, e, delta, part,
           blocks: int, alpha0: float, l2_core: float, eta: float) -> None:
    """Enqueue the sweep's 2·k1·k2 + 1 launches on the current stream. The
    caller has checked shapes, dtypes, device and contiguity
    (``ops.core_sweep_slabs``)."""
    k3 = w.shape[1]
    lib = library(width_of(k3))
    so = lib.load()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = so.tucker_core_sweep_f32(
            w.data_ptr(), k3, gp.data_ptr(), gp.shape[1], gram_g.data_ptr(),
            gp.shape[0], r.data_ptr(), b.data_ptr(), j_i.data_ptr(),
            ctx_ptr.data_ptr(), item32.data_ptr(), alpha.data_ptr(), e.data_ptr(),
            item32.shape[0], delta.data_ptr(), part.data_ptr(), blocks,
            alpha0, l2_core, eta, stream)
    lib.check(rc, "tucker_core")
