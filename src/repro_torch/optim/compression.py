"""int8 error-feedback gradient compression for the data-parallel
all-reduce (port of ``repro.optim.compression``).

A 1-byte quantized all-reduce cuts the data-parallel collective 4× (fp32)
or 2× (bf16). Error feedback (Seide et al.; Karimireddy et al.) keeps the
quantization residual locally, so the compressed SGD trajectory
converges to the uncompressed one.

The quantizer is the shared symmetric int8 code of
:mod:`repro_torch.core.quant` (one scale-fitting rule for gradients here
and for quantized ψ storage in ``serve/ann.py``), re-exported under the
reference's ``int8_compress``/``int8_decompress`` names. One step on a
rank of ``group``::

    g_hat_mean, err = compressed_psum(g, err, group)
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import (  # noqa: F401  (re-exported names)
    int8_dequantize as int8_decompress,
    int8_dequantize_rows,
    int8_quantize as int8_compress,
    int8_quantize_rows,
)
from repro_torch.runtime import collectives


def ef_compress_update(g: torch.Tensor, err: torch.Tensor):
    """One error-feedback step: quantize (g + err), return
    (q, scale, new_err)."""
    corrected = g.float() + err
    q, scale = int8_compress(corrected)
    new_err = corrected - int8_decompress(q, scale)
    return q, scale, new_err


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group):
    """Error-feedback int8 all-reduce over ``group`` (as
    ``collectives.group_of`` takes it), called on every rank of it:
    two all-reduces, the dequantised sum and the rank count. Returns
    (g_hat_mean, new_err)."""
    q, scale, new_err = ef_compress_update(g, err)
    total = collectives.all_reduce(q.float() * scale, group)
    n = collectives.all_reduce(torch.ones((), device=g.device), group)
    return total / n, new_err
