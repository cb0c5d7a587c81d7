"""iCD for Matrix Factorization (paper §5.1), serving part (port of
``repro.core.models.mf``).

Model: ŷ(c,i) = ⟨w_c, h_i⟩ with Θ = {W ∈ R^{C×k}, H ∈ R^{I×k}}, so
φ(c) = w_c and ψ(i) = h_i: retrieval is a top-K over W·Hᵀ.

This slice ports what serving needs: the parameters, a seeded ``init``,
the φ/ψ exports, ``predict`` and ``scores_all``, plus
:func:`params_from_numpy`, which carries the JAX package's trained
``MFParams`` over as numpy arrays. Training (``epoch``, ``fit``,
``objective`` and the residual cache) waits for slice 2, with the Gram and
CD-sweep kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import resolve_device


class MFParams(NamedTuple):
    w: torch.Tensor  # (n_ctx, k)   context embeddings
    h: torch.Tensor  # (n_items, k) item embeddings


def init(n_ctx: int, n_items: int, k: int, *, generator: torch.Generator,
         sigma: float = 0.1) -> MFParams:
    """N(0, σ²) factors on the generator's device. A ``torch.Generator``
    draws other numbers than a JAX key of the same seed; to compare the
    two packages, build one set of numpy factors and use
    :func:`params_from_numpy`."""
    device = generator.device
    return MFParams(
        w=sigma * torch.randn((n_ctx, k), generator=generator, device=device),
        h=sigma * torch.randn((n_items, k), generator=generator,
                              device=device),
    )


def params_from_numpy(w, h, *, device="cuda") -> MFParams:
    """The port's params from (n_ctx, k) and (n_items, k) numpy factors,
    e.g. ``np.asarray(jax_params.w)`` of a model the JAX package trained.
    They go to ``device``, the GPU unless the caller names the CPU; with
    no GPU present the default raises."""
    device = resolve_device(device)
    return MFParams(
        w=torch.tensor(np.asarray(w, np.float32), device=device),
        h=torch.tensor(np.asarray(h, np.float32), device=device),
    )


def export_psi(params: MFParams) -> torch.Tensor:
    """ψ table for the serve tier: (n_items, k)."""
    return params.h


def build_phi(params: MFParams, ctx) -> torch.Tensor:
    """φ rows for a batch of context ids: (B, k); ⟨φ, ψ_i⟩ = ŷ(c, i)."""
    ctx = torch.as_tensor(ctx, dtype=torch.long, device=params.w.device)
    return params.w.index_select(0, ctx)


def predict(params: MFParams, ctx, item) -> torch.Tensor:
    dev = params.w.device
    ctx = torch.as_tensor(ctx, dtype=torch.long, device=dev)
    item = torch.as_tensor(item, dtype=torch.long, device=dev)
    return (params.w[ctx] * params.h[item]).sum(dim=-1)


def scores_all(params: MFParams) -> torch.Tensor:
    """Full |C|×|I| score matrix — only for tests and small-scale checks."""
    return params.w @ params.h.T
