"""Bind the hand-written CUDA kernels of iCD-MFSI's field layer
(``csrc/mfsi_layer.cu``), built by :mod:`repro_torch.kernels.build` at
their first launch."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary


def _bind(lib) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.mfsi_layer_step_f32.argtypes = [p, p, p, ll, ll, i, ll, p, p, ll, p, ll, p, p, p,
                                        p, p, p, p, p, f, f, f, i, p]
    lib.mfsi_layer_step_f32.restype = i


LIB = CudaLibrary("mfsi_layer", Path(__file__).resolve().parent / "csrc" / "mfsi_layer.cu",
                  bind=_bind)

_SMS = {}  # device index → multiprocessors


def launch(layer, table_col, phi_col, q, r_vec, p2, jff, scratch, alpha0: float, l2: float,
           eta: float) -> None:
    """Enqueue a layer's launches on the current stream. The caller has
    checked shapes, dtypes, device and strides (``ops.field_layer``)."""
    lib = LIB.load()
    dev = q.device
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mfsi_layer_step_f32(
            layer.ids.data_ptr(), layer.xw.data_ptr(),
            None if layer.identity else layer.rows.data_ptr(), layer.ids.shape[0],
            layer.offset, layer.vocab, q.shape[0], layer.cnt.data_ptr(),
            table_col.data_ptr(), table_col.stride(0), phi_col.data_ptr(), phi_col.stride(0),
            q.data_ptr(), r_vec.data_ptr(), p2.data_ptr(), jff.data_ptr(),
            scratch.sums.data_ptr(), scratch.delta.data_ptr(),
            None if scratch.acc is None else scratch.acc.data_ptr(), scratch.dphi.data_ptr(),
            alpha0, l2, eta, _SMS[dev.index], stream)
    LIB.check(rc, "mfsi_layer")
