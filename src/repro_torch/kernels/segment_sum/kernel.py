"""Bind the hand-written CUDA segment-sum kernel (``csrc/segment_sum.cu``),
built by :mod:`repro_torch.kernels.build` at its first launch with its tile
size as ``-D`` flags."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary

THREADS = 128  # a block of pass 1: THREADS / 32 warps, each its own slice of the path
ITEMS = 23     # path items a lane walks in a warp's tile (odd: no bank conflicts)
TILE = THREADS * ITEMS  # path items of a block's warps' tiles


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segment_sum_f32.argtypes = [p, ll, ll, i, p, p, p, p, p, p, p, p, i, p, p]
    lib.segment_sum_f32.restype = i
    lib.segment_sum_blocks.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.segment_sum_blocks.restype = i


LIB = CudaLibrary(
    "segment_sum", Path(__file__).resolve().parent / "csrc" / "segment_sum.cu",
    defines={"SEGSUM_THREADS": THREADS, "SEGSUM_ITEMS": ITEMS},
    bind=_bind,
)

_BLOCKS = {}  # (device index, number of values) → pass 1's resident blocks


def max_blocks(device: torch.device, n_values: int) -> int:
    """The most blocks pass 1 keeps resident on ``device`` for
    ``n_values`` vectors: the grid of a call with at least that many tiles."""
    key = (device.index, n_values)
    if key not in _BLOCKS:
        lib = LIB.load()
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            LIB.check(lib.segment_sum_blocks(n_values, ctypes.byref(out)),
                      "segment_sum")
        _BLOCKS[key] = out.value
    return _BLOCKS[key]


def scratch_bytes(blocks: int, n_values: int) -> int:
    """Pass 1's partials: a row id, a flag and two sums a value, a warp."""
    return blocks * THREADS // 32 * (12 + 8 * n_values)


def launch(values, offsets: torch.Tensor, outs, blocks: int,
           scratch: torch.Tensor) -> None:
    """Enqueue both passes on the current stream. The caller has checked
    shapes, dtypes, device and contiguity (``ops.segment_sum_sorted``)."""
    lib = LIB.load()
    n, nnz = offsets.shape[0] - 1, values[0].shape[0]
    ins = [v.data_ptr() for v in values] + [None] * (4 - len(values))
    res = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    with torch.cuda.device(offsets.device):
        stream = torch.cuda.current_stream(offsets.device).cuda_stream
        rc = lib.segment_sum_f32(offsets.data_ptr(), n, nnz, len(values), *ins,
                                 *res, blocks, scratch.data_ptr(), stream)
    LIB.check(rc, "segment_sum")
