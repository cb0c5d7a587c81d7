"""Lemma 1: the implicit objective as explicit loss + implicit regularizer
(port of ``repro.core.implicit``).

``L(Θ|S_impl) = L(Θ|S̄) + α₀·R(Θ) + const`` where ``S̄`` rescales the
observed feedback (ȳ = α/(α−α₀)·y, ᾱ = α−α₀; paper eq. 7–8) and
``R(Θ) = Σ_{c∈C} Σ_{i∈I} ŷ(c,i)²`` penalizes non-zero predictions anywhere.
Both the Lemma 2 (Gram) evaluation and the brute-force O(|C||I|) oracle
are here.
"""
from __future__ import annotations

import torch

from repro_torch.core.gram import full_fp32, gram
from repro_torch.sparse.interactions import Interactions


def rescale_observed(y, alpha, alpha0: float):
    """Eq. (8): collapse each (c,i,y,α) ∈ S⁺ with its (c,i,0,−α₀)
    counterpart."""
    return alpha / (alpha - alpha0) * y, alpha - alpha0


def frequency_confidence(count, *, beta: float = 1.0, mode: str = "linear",
                         eps: float = 1.0):
    """Hu et al. 2008 confidence from interaction frequency.

    ``linear``: α = 1 + β·count       (eq. 2 of Hu et al.)
    ``log``:    α = 1 + β·log(1 + count/ε)   (their eq. 3 variant)

    Returns the RAW observed confidence α (float32), for
    :func:`~repro_torch.sparse.interactions.build_interactions` to rescale,
    or to divide by a baseline α for the ``weights=`` epoch paths."""
    count = torch.as_tensor(count, dtype=torch.float32)
    if mode == "linear":
        return 1.0 + beta * count
    if mode == "log":
        return 1.0 + beta * torch.log1p(count / eps)
    raise ValueError(f"unknown frequency confidence mode {mode!r}")


def confidence_weights(alpha_raw, *, base: float = 1.0):
    """Per-interaction weights w = α/base for the ``weights=`` epoch paths:
    training with ``(alpha=base·1, weights=w)`` equals training with
    ``alpha=α`` directly (α is purely multiplicative in the explicit
    loss)."""
    return torch.as_tensor(alpha_raw, dtype=torch.float32) / base


def implicit_regularizer_gram(phi, psi) -> torch.Tensor:
    """Lemma 2: R(Θ) = Σ_{f,f'} J_C(f,f')·J_I(f,f') in O((|C|+|I|)k²)."""
    return torch.sum(gram(phi) * gram(psi))


def implicit_regularizer_naive(phi, psi) -> torch.Tensor:
    """Brute force O(|C||I|): R(Θ) = Σ_c Σ_i ⟨φ(c),ψ(i)⟩². Oracle."""
    with full_fp32():
        scores = phi.float() @ psi.float().T
    return torch.sum(scores * scores)


def explicit_loss(e, alpha) -> torch.Tensor:
    """Rescaled explicit part Σ ᾱ·(ŷ−ȳ)² given cached residuals e = ŷ−ȳ."""
    return torch.sum(alpha * e * e)


def implicit_objective(phi, psi, e, data: Interactions, alpha0: float,
                       l2: float, params_sq_norm) -> torch.Tensor:
    """Full Lemma-1 objective (up to the additive constant of the proof):
    Σ_S̄ ᾱ(ŷ−ȳ)² + α₀·R(Θ) + λ‖Θ‖²."""
    return (explicit_loss(e, data.alpha)
            + alpha0 * implicit_regularizer_gram(phi, psi)
            + l2 * params_sq_norm)


def dense_implicit_objective(scores, y_dense, alpha_dense, l2: float,
                             params_sq_norm) -> torch.Tensor:
    """The pre-Lemma-1 objective over the FULL |C|×|I| grid (eq. 1 over
    S_impl), for exactness checks."""
    diff = scores - y_dense
    return torch.sum(alpha_dense * diff * diff) + l2 * params_sq_norm
