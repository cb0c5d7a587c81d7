"""Symmetric int8 quantization, per tensor and per row (port of
``repro.core.quant``).

The ψ serving storage of the IVF tier (``serve/ann.py``) uses the per-ROW
form: catalogue rows span orders of magnitude in norm (head against tail
items), so one scale for the whole table would crush the tail rows to
zero. Each row gets its own scale and the top-K kernel dequantizes a row
as ``q·scale[row]`` before its fp32 products.

The code is symmetric (no zero point): ``scale = absmax / 127`` and
``q = clip(round(x / scale), -127, 127)``. Division by the scale, not
multiplication by its inverse, and ``torch.round``'s half-to-even rule
keep ``q`` array-equal to the reference's. bf16 storage needs no helper
(a dtype cast).
"""
from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-12  # scale floor: keeps all-zero inputs from dividing by zero


def int8_quantize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: ``(q int8, scale f32 ())``."""
    x = torch.as_tensor(x).float()
    absmax = torch.clamp(x.abs().max(), min=_EPS)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q, scale) -> torch.Tensor:
    """Per-tensor inverse: ``q·scale`` in fp32."""
    return torch.as_tensor(q).float() * scale


def int8_quantize_rows(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-ROW int8 quantization of a 2-D table:
    ``(q (n, d) int8, scales (n,) f32)``, each row fitted to its own
    absmax. All-zero rows get the floor scale and quantize to zeros."""
    x = torch.as_tensor(x).float()
    if x.dim() != 2:
        raise ValueError(
            f"per-row quantization needs a 2-D table, got {tuple(x.shape)}")
    absmax = torch.clamp(x.abs().amax(dim=1), min=_EPS)     # (n,)
    scales = absmax / 127.0
    q = torch.clamp(torch.round(x / scales[:, None]), -127, 127)
    return q.to(torch.int8), scales


def int8_dequantize_rows(q, scales) -> torch.Tensor:
    """Per-row inverse, ``q·scales[:, None]`` in fp32: what the top-K
    kernel computes for each ψ row before its products."""
    q = torch.as_tensor(q)
    return q.float() * torch.as_tensor(scales, dtype=torch.float32,
                                       device=q.device)[:, None]
