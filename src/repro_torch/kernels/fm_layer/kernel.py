"""Bind the hand-written CUDA kernels of iCD-FM's embedding field layer
(``csrc/fm_layer.cu``), built by :mod:`repro_torch.kernels.build` at their
first launch."""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary


def _bind(lib) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.fm_layer_step_f32.argtypes = [
        p, p, p, i, ll, ll, i, ll,  # ids, xw, rows, identity, n, offset, vocab, n_rows
        p, ll, p, p, ll,          # table, ld_t, phi_f, phi_s, ld_p
        p, p, p, p, p, p, p,      # q, u, r_a, r_b, p2, p1, p0
        p, p, p,                  # jff, jfs, jss
        p, p, p, p,               # sums, step, acc, dphi
        f, f, f, i, p]            # alpha0, l2, eta, sms, stream
    lib.fm_layer_step_f32.restype = i


LIB = CudaLibrary("fm_layer", Path(__file__).resolve().parent / "csrc" / "fm_layer.cu",
                  bind=_bind)

_SMS = {}  # device index → multiprocessors


def launch(layer, table_col, phi_f, phi_s, caches, j, scratch, alpha0: float, l2: float,
           eta: float) -> None:
    """Enqueue a layer's launches on the current stream. The caller has
    checked shapes, dtypes, device and strides (``ops.field_layer``)."""
    lib = LIB.load()
    dev = phi_f.device
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    c = caches
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_layer_step_f32(
            layer.ids.data_ptr(), layer.xw.data_ptr(), layer.rows.data_ptr(),
            int(layer.identity), layer.ids.shape[0], layer.offset, layer.vocab, phi_f.shape[0],
            table_col.data_ptr(), table_col.stride(0), phi_f.data_ptr(), phi_s.data_ptr(),
            phi_f.stride(0), c.q.data_ptr(), c.u.data_ptr(), c.r_a.data_ptr(), c.r_b.data_ptr(),
            c.p2.data_ptr(), c.p1.data_ptr(), c.p0.data_ptr(),
            *(t.data_ptr() for t in j),
            scratch.sums.data_ptr(), scratch.step.data_ptr(),
            None if scratch.acc is None else scratch.acc.data_ptr(), scratch.dphi.data_ptr(),
            alpha0, l2, eta, _SMS[dev.index], stream)
    LIB.check(rc, "fm_layer")
