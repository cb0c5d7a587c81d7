"""iCD for Matrix Factorization (paper §5.1, Algorithm 2; port of
``repro.core.models.mf``).

Model: ŷ(c,i) = ⟨w_c, h_i⟩ with Θ = {W ∈ R^{C×k}, H ∈ R^{I×k}}, so
φ(c) = w_c and ψ(i) = h_i: retrieval is a top-K over W·Hᵀ. Gradients are
one-hot (eq. 17), so the regularizer derivatives collapse to
R'(w_{c*,f*}) = 2 Σ_f J_I(f,f*)·w_{c*,f} and R''(w_{c*,f*}) = 2 J_I(f*,f*)
(eqs. 18–19): an epoch costs O((|C|+|I|)k² + |S|k).

The epoch here is the segment-sum form over the flat COO layout: each
column update is a gather, two segment sums, a mat-vec with the opposite
Gram, the Newton step and a rank-1 residual patch, all in PyTorch. The
kernel-fused form over the padded layout is ``mf_padded``.
:func:`params_from_numpy` carries the JAX package's ``MFParams`` over as
numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sweeps
from repro_torch.core.gram import full_fp32, gram
from repro_torch.core.implicit import implicit_objective
from repro_torch.kernels import resolve_device
from repro_torch.obs.trace import span
from repro_torch.sparse.interactions import Interactions
from repro_torch.sparse.segment import segment_sum


class MFParams(NamedTuple):
    w: torch.Tensor  # (n_ctx, k)   context embeddings
    h: torch.Tensor  # (n_items, k) item embeddings


@dataclasses.dataclass(frozen=True)
class MFHyperParams:
    k: int
    alpha0: float = 1.0
    l2: float = 0.1
    eta: float = 1.0  # full Newton step, exact for bilinear models
    implementation: str = "xla"  # Gram of mf.epoch: 'xla' = torch.mm,
    #                              'pallas' = the hand-written Gram kernel
    unroll: bool = False  # per-column sweep even where a fused block
    #                       body exists (the loop is a host loop anyway)
    block_k: int = 0  # columns per fused cd_sweep dispatch on the padded
    #                   layout: 0 = auto (min(k, 8)), 1 = per column
    psi_dispatch: str = "gather"  # fused-path Ψ routing: 'gather' = ψ
    #                   gathered in the kernel from the ψ slab, 'pregather'
    #                   = a (C, k_b, D_pad) Ψ tile gathered before launch


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


def phi(params: MFParams) -> torch.Tensor:
    return params.w


def psi(params: MFParams) -> torch.Tensor:
    return params.h


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
    with full_fp32():
        return params.w @ params.h.T


def _side_sweep(side, other_j, other_cols_nnz, rows_nnz, alpha, e,
                n_rows: int, hp: MFHyperParams,
                schedule: Optional[sweeps.SweepSchedule] = None,
                sweep_index: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dimension sweep over one side; returns (side, new_e). ``side``
    is updated in place. With a ``schedule`` the sweep covers only the
    scheduled blocks for this ``sweep_index``."""

    def body(f, carry):
        side_m, e = carry
        o_col = other_cols_nnz(f)                      # (nnz,)
        s_col = sweeps.take_col(side_m, f)             # (n,)
        # explicit parts (L'/2, L''/2) from the residual cache
        lp = segment_sum(alpha * e * o_col, rows_nnz, n_rows)
        lpp = segment_sum(alpha * o_col * o_col, rows_nnz, n_rows)
        # implicit parts (R'/2, R''/2) via the opposite Gram (Lemma 3)
        rp = side_m @ sweeps.take_col(other_j, f)
        rpp = other_j[f, f]
        delta = sweeps.newton_delta(
            sweeps.NewtonParts(lp + hp.alpha0 * rp, lpp + hp.alpha0 * rpp),
            s_col, hp.l2, hp.eta)
        with span("mf.patch"):                         # rank-1 residual patch
            e = e + delta[rows_nnz] * o_col
        return sweeps.put_col(side_m, f, s_col + delta), e

    return sweeps.sweep_columns(
        side.shape[1], body, (side, e), unroll=hp.unroll,
        schedule=schedule, sweep_index=sweep_index)


def epoch(params: MFParams, data: Interactions, e: torch.Tensor,
          hp: MFHyperParams, schedule: Optional[sweeps.SweepSchedule] = None,
          sweep_index: int = 0,
          weights: Optional[torch.Tensor] = None) -> Tuple[MFParams, torch.Tensor]:
    """One iCD epoch: W sweep then H sweep over the scheduled columns.

    ``e`` is the context-major residual cache (ŷ−ȳ per observation, from
    :func:`residuals`); the result carries a new one and new factors, and
    ``params`` and ``e`` are left as they were. ``weights`` is an optional
    (nnz,) per-interaction confidence weight in context-major order: a
    weighted epoch is exactly an epoch over ``alpha·w``."""
    if weights is not None:
        data = dataclasses.replace(data, alpha=data.alpha * weights)
    w, h = params.w.clone(), params.h.clone()
    with span("mf.epoch"), full_fp32():
        # context side: J_I from the fixed item factors
        j_i = gram(h, implementation=hp.implementation)
        w, e = _side_sweep(
            w, j_i, lambda f: sweeps.take_col(h, f)[data.item], data.ctx,
            data.alpha, e, data.n_ctx, hp, schedule, sweep_index)

        # item side: J_C from the just-updated context factors
        j_c = gram(w, implementation=hp.implementation)
        e_t = sweeps.to_item_major(e, data.t_perm)
        alpha_t = sweeps.to_item_major(data.alpha, data.t_perm)
        h, e_t = _side_sweep(
            h, j_c, lambda f: sweeps.take_col(w, f)[data.t_ctx], data.t_item,
            alpha_t, e_t, data.n_items, hp, schedule, sweep_index)
        e = sweeps.to_ctx_major(e_t, data.t_perm)
    return MFParams(w, h), e


def residuals(params: MFParams, data: Interactions) -> torch.Tensor:
    return sweeps.residuals_from_factors(params.w, params.h, data.ctx,
                                         data.item, data.y)


def objective(params: MFParams, data: Interactions,
              hp: MFHyperParams) -> torch.Tensor:
    e = residuals(params, data)
    sq = torch.sum(params.w ** 2) + torch.sum(params.h ** 2)
    with full_fp32():
        return implicit_objective(params.w, params.h, e, data, hp.alpha0,
                                  hp.l2, sq)


def fit(params: MFParams, data: Interactions, hp: MFHyperParams,
        n_epochs: int, callback=None,
        schedule: Optional[sweeps.SweepSchedule] = None,
        weights: Optional[torch.Tensor] = None) -> MFParams:
    """Run ``n_epochs`` iCD epochs; ``callback(epoch, params)`` after each.
    With a ``schedule``, epoch ``ep`` sweeps the schedule's blocks for
    ``sweep_index=ep``."""
    e = residuals(params, data)
    for ep in range(n_epochs):
        params, e = epoch(params, data, e, hp, schedule, ep, weights)
        if callback is not None:
            callback(ep, params)
    return params
