"""Arithmetic and helpers shared by the references."""
from __future__ import annotations

import numpy as np
import torch

# rows of a chunked (rows, k) gather: 2^21 rows of 130 float64 ≈ 2.2 GB
CHUNK = 1 << 21


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as a tensor core reads float32 operands: the low
    13 of the 23 mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


class Arith:
    """The precision a reference runs in: ``dtype`` for every tensor, and
    matrix products (Grams and the R' products) either in that dtype or,
    with ``tf32``, float32 products of TF32-rounded operands."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 products take float32 operands")
        self.dtype = dtype
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return tf32(a) @ tf32(b)
        return a @ b


REFERENCE = Arith(torch.float64)
CONTROL = Arith(torch.float32, tf32=True)


def no_tf32():
    """Full-precision float32 products everywhere in this process (the
    reference rounds its own operands where it wants TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def seg(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Σ of ``vals`` by segment ``idx`` into ``n`` segments."""
    return torch.zeros((n,), dtype=vals.dtype, device=vals.device).index_add_(0, idx, vals)


class Log:
    """The observed set S̄ after Lemma 1 (ȳ = α/(α−α₀)·y, ᾱ = α−α₀),
    sorted by (ctx, item), on ``device``, in float64."""

    def __init__(self, inputs, alpha0: float, device):
        key = np.asarray(inputs.ctx, np.int64) * inputs.n_items + np.asarray(inputs.item, np.int64)
        order = torch.argsort(torch.as_tensor(key, device=device))
        ctx = torch.as_tensor(np.asarray(inputs.ctx, np.int64), device=device)[order]
        item = torch.as_tensor(np.asarray(inputs.item, np.int64), device=device)[order]
        y = torch.as_tensor(np.asarray(inputs.y, np.float64), device=device)[order]
        alpha = torch.as_tensor(np.asarray(inputs.alpha, np.float64), device=device)[order]
        if bool(torch.any(alpha <= alpha0)):
            raise ValueError("Lemma 1 needs α > α₀ on every observed pair")
        self.ctx, self.item = ctx, item
        self.ybar = alpha / (alpha - alpha0) * y
        self.abar = alpha - alpha0
        self.n_ctx, self.n_items = inputs.n_ctx, inputs.n_items


def scores(phi: torch.Tensor, psi: torch.Tensor, ctx, item) -> torch.Tensor:
    """⟨φ(c), ψ(i)⟩ on the observed pairs, CHUNK pairs at a time."""
    out = torch.empty(ctx.shape, dtype=phi.dtype, device=phi.device)
    for lo in range(0, len(ctx), CHUNK):
        hi = lo + CHUNK
        out[lo:hi] = torch.sum(phi[ctx[lo:hi]] * psi[item[lo:hi]], dim=1)
    return out


def newton(num, den, eta: float):
    """η-damped Newton step on a 1-D quadratic; an empty row with λ = 0
    has den = 0, clamped."""
    return -eta * num / torch.clamp(den, min=1e-12)
