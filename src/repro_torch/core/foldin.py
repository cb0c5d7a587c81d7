"""Closed-form fold-in: single-row iCD solves for rows that arrive after
training (Rendle 2021, *Item Recommendation from Implicit Feedback*,
§serving; port of ``repro.core.foldin``).

Every zoo model scores through the k-separable product ŷ = ⟨φ(ctx),
ψ(item)⟩, so a NEW user (or item) is one unknown D-vector θ against the
FROZEN other side's export table T, the per-row subproblem the training
sweeps solve, restricted to one row:

    minimize_θ   Σ_j α_j (θ·t_j − y_j)²  +  α₀ θᵀGθ  +  λ‖θ‖²,   G = TᵀT

:func:`fold_in_row` runs the same per-coordinate Newton updates as
``sweeps.side_sweep`` (η-damped, the ``newton_delta`` denominator clamp, so
λ=0 with an empty history stays finite), sweep after sweep until
converged; :func:`fold_in_exact` solves the normal equations directly in
float64 and is the oracle the tests hold it to.

The solve stays on the table's device. On a quadratic, a cyclic sweep of
exact coordinate Newton steps over the free coordinates is one
Gauss–Seidel (η = 1) or SOR (ω = η) sweep of the normal system
M θ = b, M = A + α₀G + λI, A = Σ α t tᵀ, b = Σ α y t: each coordinate's
step is −η·(Mθ − b)_f / max(M_ff, 1e-12), with the coordinates before it
already moved. So a whole sweep is ONE lower-triangular solve, and the
host reads back one number a sweep (the largest |Δθ|, for ``tol``), not
one a coordinate. G comes from ``core/gram.gram(implementation="pallas")``,
the Gram kernel on the card.

FM's ``φ_ext``/``ψ_ext`` carry structurally fixed columns (the constant-1
slots), so the solver takes a ``free`` mask: fixed coordinates keep their
``init`` value and only ride along through M. The per-model entry points
(which side is frozen, which coordinates are free) live on the
:class:`repro_torch.core.models.api.Model` adapters as ``fold_in_user`` /
``fold_in_item``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.gram import full_fp32, gram as gram_fn
from repro_torch.kernels import resolve_device


class FoldInResult(NamedTuple):
    row: torch.Tensor     # (D,) solved embedding row, float32, on T's device
    n_sweeps: int         # CD sweeps actually run
    delta_max: float      # last sweep's max |Δθ| (convergence certificate)


def _vec(x, n: int, dev, name: str) -> torch.Tensor:
    """A float32 (n,) vector on ``dev``, default ones."""
    if x is None:
        return torch.ones((n,), dtype=torch.float32, device=dev)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    t = torch.as_tensor(x).to(dev, torch.float32)
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name} must match ids shape")
    return t


def _prepare(table, ids, y, alpha, free, init, weights, device):
    # a tensor stays on its own device; host data goes to ``device``
    # (CUDA unless the caller names the CPU)
    dev = (table.device if isinstance(table, torch.Tensor) and device is None
           else resolve_device(device))
    table = torch.as_tensor(table, dtype=torch.float32, device=dev)
    n, d = table.shape
    ids = torch.as_tensor(np.asarray(ids, np.int64).reshape(-1)
                          if not isinstance(ids, torch.Tensor) else ids,
                          dtype=torch.long, device=dev).reshape(-1)
    if ids.numel():
        lo, hi = (int(v) for v in torch.aminmax(ids))
        if lo < 0 or hi >= n:
            raise ValueError(f"fold-in ids out of range [0, {n}) : {ids.tolist()!r}")
    m = int(ids.numel())
    y = _vec(y, m, dev, "y/alpha")
    alpha = _vec(alpha, m, dev, "y/alpha")
    if weights is not None:
        # per-interaction confidence folds into α exactly (α is purely
        # multiplicative in the explicit parts of the row subproblem)
        alpha = alpha * _vec(weights, m, dev, "weights")
    free = (torch.ones(d, dtype=torch.bool) if free is None
            else torch.as_tensor(np.asarray(free, bool)))
    if tuple(free.shape) != (d,):
        raise ValueError(f"free mask must be ({d},), got {tuple(free.shape)}")
    theta = (torch.zeros(d, dtype=torch.float32, device=dev) if init is None
             else torch.as_tensor(np.asarray(init, np.float32), device=dev).clone())
    if tuple(theta.shape) != (d,):
        raise ValueError(f"init must be ({d},), got {tuple(theta.shape)}")
    return table, ids, y, alpha, free.to(dev), theta


def fold_in_row(table, ids, y=None, alpha=None, *, alpha0: float, l2: float,
                eta: float = 1.0, weights=None, free=None, init=None,
                gram: Optional[torch.Tensor] = None, n_sweeps: int = 64,
                tol: float = 1e-6, device=None) -> FoldInResult:
    """Solve one embedding row by coordinate descent against a frozen table.

    ``table`` (n, D)
        the frozen other side in export coordinates (``export_psi`` for a
        user fold-in; the full φ table for an item fold-in). The solve runs
        on a tensor's own device; host data goes to ``device``, CUDA unless
        the caller names the CPU.
    ``ids`` (m,)
        table rows the new entity interacted with (may be empty: the pure
        implicit-prior solve, which with l2=0 relies on the Newton clamp).
    ``y`` / ``alpha`` (m,)
        targets and confidences; default 1 (plain implicit feedback).
    ``weights`` (m,)
        optional per-interaction confidence weights, multiplied into α.
    ``free`` (D,) bool
        solvable coordinates; fixed ones keep their ``init`` value (FM's
        constant-1 extended columns).
    ``gram``
        optional precomputed TᵀT: pass it when folding many rows against
        the same frozen table.

    Iterates full free-coordinate sweeps until ``max|Δθ| < tol·(1 +
    max|θ|)`` or ``n_sweeps`` is hit; one host read-back a sweep."""
    table, ids, y, alpha, free, theta = _prepare(
        table, ids, y, alpha, free, init, weights, device)
    g = (gram_fn(table.contiguous(), implementation="pallas") if gram is None
         else torch.as_tensor(gram, dtype=torch.float32, device=table.device))
    t_rows = table[ids]                                     # (m, D)
    fr = torch.nonzero(free).reshape(-1)
    fx = torch.nonzero(~free).reshape(-1)
    with full_fp32():
        at = t_rows.T * alpha[None, :]                      # (D, m)
        mat = at @ t_rows + alpha0 * g                      # A + α₀G
        b = at @ y
        # restrict to the free coordinates; the fixed ones ride in the rhs
        m_ff = mat[fr][:, fr] + l2 * torch.eye(len(fr), device=table.device)
        rhs = b[fr] - mat[fr][:, fx] @ theta[fx]
        # SOR, ω = η: (Dc + ηL) θ' = Dc θ − η ((D + U) θ − b), Dc the
        # clamped diagonal each coordinate's step divides by
        dc = torch.clamp(torch.diagonal(m_ff), min=1e-12)
        lower = torch.tril(m_ff, -1)
        left = torch.diag(dc) + eta * lower
        upper = m_ff - lower                                # D + U
        th = theta[fr]
        sweeps_run, delta_max = 1, 0.0
        for s in range(max(1, n_sweeps) if len(fr) else 0):
            new = torch.linalg.solve_triangular(
                left, (dc * th - eta * (upper @ th - rhs))[:, None],
                upper=False)[:, 0]
            step = torch.max(torch.abs(new - th))
            th = new
            theta[fr] = th
            delta_max, th_max = torch.stack(
                [step, torch.max(torch.abs(theta))]).tolist()
            sweeps_run = s + 1
            if delta_max < tol * (1.0 + th_max):
                break
    return FoldInResult(theta, sweeps_run, float(delta_max))


def fold_in_exact(table, ids, y=None, alpha=None, *, alpha0: float, l2: float,
                  weights=None, free=None, init=None,
                  device=None) -> torch.Tensor:
    """Normal-equations oracle for :func:`fold_in_row` (float64 direct
    solve).

    Solves ``(A + α₀G + λI)[free,free] θ_free = b_free − M[free,fixed]·θ_fixed``;
    the unique minimizer the CD iteration converges to. The (D, D) system
    is built in float64 on the table's device and solved on the host with
    ``lstsq`` (``gelsd``), so the λ=0 empty-history corner (singular)
    returns the minimum-norm solution instead of raising. Returns a float32
    (D,) row on the table's device (``device`` as for :func:`fold_in_row`)."""
    table, ids, y, alpha, free, theta = _prepare(
        table, ids, y, alpha, free, init, weights, device)
    t64 = table.double()
    g = t64.T @ t64
    t_rows = t64[ids]
    a64 = alpha.double()
    d = t64.shape[1]
    m = t_rows.T @ (a64[:, None] * t_rows) + alpha0 * g + l2 * torch.eye(
        d, dtype=torch.float64, device=t64.device)
    b = t_rows.T @ (a64 * y.double())
    fr = torch.nonzero(free).reshape(-1)
    fx = torch.nonzero(~free).reshape(-1)
    rhs = b[fr] - m[fr][:, fx] @ theta[fx].double()
    sol = torch.linalg.lstsq(m[fr][:, fr].cpu(), rhs.cpu()[:, None],
                             driver="gelsd").solution[:, 0]
    out = theta.double()
    out[fr] = sol.to(out.device)
    return out.float()
