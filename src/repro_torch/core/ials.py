"""iALS baseline — Hu, Koren, Volinsky [5], vector-wise ALS for implicit MF
(port of ``repro.core.ials``).

Where iCD updates one coordinate at a time (k scalar Newton steps per
embedding), iALS solves each k-vector in closed form:

    w_c = (α₀ HᵀH + Σ_{i∈S_c} ᾱ_ci h_i h_iᵀ + λI)⁻¹ (Σ_{i∈S_c} ᾱ_ci ȳ_ci h_i)

using the same Lemma-1 "α₀·Gram + sparse correction" structure (Hu et al.'s
original trick, which Lemma 1/2 generalize).

The reference segment-sums (nnz, k, k) outer products in one tensor: at
icd-mf width (nnz ≈ 3.4 M, k = 128) that is ≈ 223 GB. Here the systems are
built and solved a block of rows at a time: the observations are sorted by
this side's row (the ctx-major and item-major layouts of
:class:`Interactions`), so a block of rows owns one contiguous run of them,
whose outer products are summed into the block's (rows, k, k) systems a
slice of at most ``_OBS_CHUNK`` observations at a time. Peak memory is the
block's systems and one slice's outer products, not nnz·k². The Gram is the
reference's default ``implementation="xla"``: one ``torch.mm``; the solve is
``torch.linalg.solve``, as the reference's is ``jnp.linalg.solve``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.gram import full_fp32, gram
from repro_torch.core.models.mf import MFParams
from repro_torch.sparse.interactions import Interactions

# rows a block of systems (16,384 × 128 × 128 fp32 = 1 GiB) and
# observations a slice of outer products (8,192 × 128 × 128 fp32 = 512 MiB)
_ROW_CHUNK = 16_384
_OBS_CHUNK = 8_192


@dataclasses.dataclass(frozen=True)
class IALSHyperParams:
    k: int
    alpha0: float = 1.0
    l2: float = 0.1


def _solve_side(
    other: torch.Tensor,    # (m, k) fixed factors
    rows: torch.Tensor,     # (nnz,) this side's row per observation, sorted
    cols: torch.Tensor,     # (nnz,) other side's row per observation
    y: torch.Tensor,
    alpha: torch.Tensor,
    n_rows: int,
    hp: IALSHyperParams,
) -> torch.Tensor:
    k = other.shape[1]
    base = hp.alpha0 * gram(other) + hp.l2 * torch.eye(
        k, dtype=torch.float32, device=other.device)
    bounds = torch.searchsorted(
        rows, torch.arange(0, n_rows + _ROW_CHUNK, _ROW_CHUNK,
                           device=rows.device).clamp(max=n_rows)).tolist()
    out = torch.empty((n_rows, k), dtype=torch.float32, device=other.device)
    for b, r0 in enumerate(range(0, n_rows, _ROW_CHUNK)):
        r1 = min(r0 + _ROW_CHUNK, n_rows)
        a_sys = base.expand(r1 - r0, k, k).clone()
        rhs = torch.zeros((r1 - r0, k), dtype=torch.float32,
                          device=other.device)
        for o0 in range(bounds[b], bounds[b + 1], _OBS_CHUNK):
            o1 = min(o0 + _OBS_CHUNK, bounds[b + 1])
            h = other[cols[o0:o1]]                           # (n, k)
            ah = alpha[o0:o1, None] * h
            local = rows[o0:o1] - r0
            a_sys.index_add_(0, local, ah[:, :, None] * h[:, None, :])
            rhs.index_add_(0, local, y[o0:o1, None] * ah)
        out[r0:r1] = torch.linalg.solve(a_sys, rhs[..., None])[..., 0]
    return out


def epoch(params: MFParams, data: Interactions,
          hp: IALSHyperParams) -> MFParams:
    """One ALS epoch: every context row solved against the fixed item
    factors, then every item row against the new context factors."""
    with full_fp32():
        w = _solve_side(params.h, data.ctx, data.item, data.y, data.alpha,
                        data.n_ctx, hp)
        y_t = data.y[data.t_perm]
        a_t = data.alpha[data.t_perm]
        h = _solve_side(w, data.t_item, data.t_ctx, y_t, a_t, data.n_items,
                        hp)
    return MFParams(w, h)


def fit(params: MFParams, data: Interactions, hp: IALSHyperParams,
        n_epochs: int) -> MFParams:
    for _ in range(n_epochs):
        params = epoch(params, data, hp)
    return params
