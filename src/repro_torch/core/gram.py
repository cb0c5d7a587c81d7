"""Gram matrices J = MᵀM, the engine of Lemma 2 (port of
``repro.core.gram``; ``sharded_gram`` waits for slice 7).

For any k-separable model the implicit regularizer collapses to
``R(Θ) = Σ_{f,f'} J_C(f,f') · J_I(f,f')`` (paper eq. 12) with ``J_C = ΦᵀΦ``
and ``J_I = ΨᵀΨ``: tall-skinny products whose k×k results are tiny.

``implementation="xla"`` (the default, named as in the reference) is one
plain ``torch.mm`` in full fp32, as the JAX package leaves it to XLA
outside any Pallas kernel; ``implementation="pallas"`` is the hand-written
Gram kernel (``repro_torch.kernels.gram``).
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Run fp32 matrix products in full fp32 (no TF32) inside the block,
    as the reference's ``preferred_element_type=float32`` does; the
    caller's setting comes back after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def gram(m: torch.Tensor, *, implementation: str = "xla",
         weights=None) -> torch.Tensor:
    """J = mᵀm (or mᵀ·diag(w)·m) with fp32 accumulation; m: (rows, k) →
    (k, k)."""
    if implementation == "pallas":
        from repro_torch.kernels.gram import ops as gram_ops

        return gram_ops.gram(m, weights=weights)
    if implementation != "xla":
        raise ValueError(
            f"implementation must be 'xla' or 'pallas', got {implementation!r}")
    if weights is not None:
        return weighted_gram(m, weights)
    mf = m.float()
    with full_fp32():
        return mf.T @ mf


def gram_pair(phi: torch.Tensor, psi: torch.Tensor, *,
              implementation: str = "xla"):
    """(J_C, J_I) for the two sides of a k-separable model."""
    return (gram(phi, implementation=implementation),
            gram(psi, implementation=implementation))


def weighted_gram(m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """J = mᵀ diag(w) m — for confidence-weighted variants. w: (rows,)."""
    mf = m.float()
    with full_fp32():
        return (mf.T * w.float()[None, :]) @ mf
