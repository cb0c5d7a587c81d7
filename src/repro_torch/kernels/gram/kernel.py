"""Bind the hand-written CUDA Gram kernel (``csrc/gram.cu``), built by
:mod:`repro_torch.kernels.build` at its first launch with the tile sizes
of :mod:`repro_torch.kernels.vmem` as ``-D`` flags."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import vmem
from repro_torch.kernels.build import CudaLibrary


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gram_f32.argtypes = [p, i, p, i, i, i, i, p, p, p]
    lib.gram_f32.restype = i


LIB = CudaLibrary(
    "gram", Path(__file__).resolve().parent / "csrc" / "gram.cu",
    defines={"GRAM_TILE": vmem.GRAM_TILE, "GRAM_CHUNK": vmem.GRAM_CHUNK},
    bind=_bind,
)


def launch(x: torch.Tensor, weights, splits: int, rows_per_split: int,
           partial: torch.Tensor, out: torch.Tensor) -> None:
    """Enqueue both passes on the current stream. The caller has checked
    shapes, dtypes, device and strides (``ops.gram``)."""
    lib = LIB.load()
    rows, k = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gram_f32(
            x.data_ptr() if rows else None, x.stride(0) if rows > 1 else k,
            None if weights is None else weights.data_ptr(), rows, k,
            splits, rows_per_split, partial.data_ptr(), out.data_ptr(),
            stream)
    LIB.check(rc, "gram")
