"""Shared machinery for iCD column sweeps (port of ``repro.core.sweeps``).

For a fixed embedding dimension f* the Newton updates of all coordinates on
one side are independent, so each inner loop of the paper's Algorithms
2/3 is ONE vectorized column update: gather → segment-reduce (explicit
part from the residual cache), a k-vector contraction with the opposite
Gram (implicit part, Lemma 3), the Newton step, the rank-1 residual patch.
:func:`sweep_columns` runs the f*-loop, per column or through a fused
block body (the ``kernels/cd_sweep`` path). PyTorch runs eagerly, so the
loop is a host loop where the reference had ``lax.fori_loop``.

:func:`side_sweep` is that column update for one-hot gradients (a side's
row is its own coordinate: MF's two sides, the item side of PARAFAC, CtxMF
and Tucker), over the flat log with its sums by sorted row;
:func:`item_side_sweep` runs it on the item-major view.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.obs.trace import span
from repro_torch.sparse.interactions import Interactions
from repro_torch.sparse.segment import segment_sum_sorted


class NewtonParts(NamedTuple):
    """Halved derivative pieces; the common factor 2 of eqs. (2,3,13,14)
    cancels in the Newton ratio, so L'/2 etc. are carried throughout."""

    grad: torch.Tensor  # L'/2 + α₀·R'/2   (no L2 term yet)
    hess: torch.Tensor  # L''/2 + α₀·R''/2 (no L2 term yet)


def newton_delta(parts: NewtonParts, theta: torch.Tensor, l2: float,
                 eta: float) -> torch.Tensor:
    """η-damped Newton step on the 1-D quadratic (exact at η=1 for
    multilinear models, paper §3.2). Returns Δθ. The denominator is
    clamped at 1e-12 as the kernels clamp it: with l2=0 an empty context
    has L''=R''=0."""
    num = parts.grad + l2 * theta
    den = parts.hess + l2
    return -eta * num / torch.clamp(den, min=1e-12)


@dataclasses.dataclass(frozen=True)
class SweepSchedule:
    """Subspace schedule for :func:`sweep_columns` (iALS++-style).

    ``kind``: ``'full'`` (every block, ascending ``f0``), ``'rotating'``
    (order rotated by ``sweep_index``) or ``'randomized'`` (a permutation
    seeded by ``(seed, sweep_index)``). ``block`` is the columns per
    scheduled block (0 = the caller's ``block``); ``blocks_per_sweep``
    truncates the ordered list (0 = all); ``repeats`` is an int for every
    block or a tuple indexed by the block's ordinal ``f0 // block``
    (cycled). Same plans as the reference, block for block."""

    kind: str = "full"
    block: int = 0
    blocks_per_sweep: int = 0
    repeats: Union[int, Tuple[int, ...]] = 1
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("full", "rotating", "randomized"):
            raise ValueError(
                "SweepSchedule.kind must be 'full' | 'rotating' | "
                f"'randomized', got {self.kind!r}")
        reps = self.repeats if isinstance(self.repeats, tuple) else (self.repeats,)
        if not reps or any(int(r) < 1 for r in reps):
            raise ValueError(f"repeats must be >= 1, got {self.repeats!r}")

    def _repeat(self, ordinal: int) -> int:
        if isinstance(self.repeats, tuple):
            return int(self.repeats[ordinal % len(self.repeats)])
        return int(self.repeats)

    def blocks(self, n_dims: int, sweep_index: int = 0,
               block: int = 0) -> Tuple[Tuple[int, int], ...]:
        """Resolve to a ``((f0, size), ...)`` sequence for one sweep."""
        b = self.block if self.block >= 1 else (block if block >= 1 else n_dims)
        b = min(b, n_dims)
        base = [(f0, min(b, n_dims - f0)) for f0 in range(0, n_dims, b)]
        if self.kind == "rotating" and base:
            r = sweep_index % len(base)
            order = base[r:] + base[:r]
        elif self.kind == "randomized":
            rng = np.random.default_rng((self.seed, sweep_index))
            order = [base[i] for i in rng.permutation(len(base))]
        else:
            order = base
        if self.blocks_per_sweep >= 1:
            order = order[: self.blocks_per_sweep]
        out = []
        for f0, size in order:
            out.extend([(f0, size)] * self._repeat(f0 // b))
        return tuple(out)

    def n_column_updates(self, n_dims: int, sweep_index: int = 0,
                         block: int = 0) -> int:
        """Column-updates this sweep performs (the updates-to-quality
        unit)."""
        return sum(size for _, size in self.blocks(n_dims, sweep_index, block))


FULL_SCHEDULE = SweepSchedule()


def sweep_columns(n_dims: int, body: Callable, carry, *, unroll: bool = False,
                  block: int = 1, block_body: Optional[Callable] = None,
                  schedule: Optional[SweepSchedule] = None,
                  sweep_index: int = 0):
    """Single entry point for the f*-sweep of Algorithms 2/3.

    ``body(f, carry) -> carry`` is the per-column Newton update;
    ``block_body(f0, size, carry) -> carry`` an optional fused update of
    columns ``[f0, f0+size)`` in one dispatch. With a block body (and
    ``block >= 1``, and no ``unroll``) blocks of ``block`` columns run
    fused with a shorter tail; ``block=1`` is a per-column loop through the
    block path. Otherwise ``body`` runs per column. A ``schedule`` replaces
    the plain ascending pass with its block plan for ``sweep_index``; a
    plan that is one plain in-order pass is the unscheduled sweep.
    ``unroll`` is kept for the reference's signature: the loop is a host
    loop either way, and ``unroll=True`` asks for the per-column body."""
    if schedule is not None:
        plan = schedule.blocks(n_dims, sweep_index, block)
        trivial = [f for f0, size in plan for f in range(f0, f0 + size)]
        if trivial == list(range(n_dims)) and (
            block_body is None or plan == SweepSchedule(block=block).blocks(n_dims)
        ):
            schedule = None
    if schedule is not None:
        if block_body is not None and not unroll:
            for f0, size in plan:
                carry = block_body(f0, size, carry)
            return carry
        for f0, size in plan:
            for f in range(f0, f0 + size):
                carry = body(f, carry)
        return carry
    if block_body is not None and block >= 1 and not unroll:
        f0 = 0
        while f0 < n_dims:
            size = min(block, n_dims - f0)
            carry = block_body(f0, size, carry)
            f0 += size
        return carry
    for f in range(n_dims):
        carry = body(f, carry)
    return carry


def side_sweep(side, other_j, other_col_nnz, rows_nnz, row_ptr, alpha, e, *,
               alpha0: float, l2: float, eta: float,
               schedule: Optional[SweepSchedule] = None,
               sweep_index: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-hot column sweep over one side; returns (side, new_e).
    ``side`` is updated in place. ``other_col_nnz(f)`` is the opposite
    factor's column f over the entries, ``other_j`` the opposite Gram,
    ``rows_nnz`` the entries' rows, sorted, and ``row_ptr`` their (n + 1,)
    CSR offsets. With a ``schedule`` the sweep covers only the scheduled
    blocks for this ``sweep_index``. The rank-1 residual patch runs under
    the span ``mf.patch``, whichever model's sweep it is: the benchmark's
    span tool reads it by that name."""

    def body(f, carry):
        side_m, e = carry
        o_col = other_col_nnz(f)                       # (nnz,)
        s_col = take_col(side_m, f)                    # (n,)
        # explicit parts (L'/2, L''/2) from the residual cache
        lp, lpp = segment_sum_sorted((alpha * e * o_col, alpha * o_col * o_col),
                                     row_ptr)
        # implicit parts (R'/2, R''/2) via the opposite Gram (Lemma 3)
        rp = side_m @ take_col(other_j, f)
        rpp = other_j[f, f]
        delta = newton_delta(NewtonParts(lp + alpha0 * rp, lpp + alpha0 * rpp),
                             s_col, l2, eta)
        with span("mf.patch"):                         # rank-1 residual patch
            e = e + delta[rows_nnz] * o_col
        return put_col(side_m, f, s_col + delta), e

    return sweep_columns(side.shape[1], body, (side, e), schedule=schedule,
                         sweep_index=sweep_index)


def item_side_sweep(h, j_c, ctx_col, data: Interactions, e, *, alpha0: float,
                    l2: float, eta: float, schedule: Optional[SweepSchedule] = None,
                    sweep_index: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`side_sweep` over the item factors ``h`` (updated in place):
    ``ctx_col(f)`` is the context side's column f, one value a context row
    of the log, and ``j_c`` its Gram. ``e`` comes and goes in context-major
    order; the sweep runs on the item-major view."""
    e_t = to_item_major(e, data.t_perm)
    alpha_t = to_item_major(data.alpha, data.t_perm)
    h, e_t = side_sweep(h, j_c, lambda f: ctx_col(f)[data.t_ctx], data.t_item,
                        data.item_ptr, alpha_t, e_t, alpha0=alpha0, l2=l2,
                        eta=eta, schedule=schedule, sweep_index=sweep_index)
    return h, to_ctx_major(e_t, data.t_perm)


def resolve_block_k(block_k: int, k: int) -> int:
    """Shared ``hp.block_k`` policy of the fused epochs: 0 = auto
    (min(k, 8)), otherwise clamp to [1, k]."""
    return min(k, 8) if block_k == 0 else max(1, min(block_k, k))


def resolve_psi_dispatch(psi_dispatch: str) -> bool:
    """Shared ``hp.psi_dispatch`` policy: returns ``prefer_gather`` for
    ``kernels.vmem.resolve_cd_sweep_dispatch``. Anything outside the two
    known routings raises."""
    if psi_dispatch not in ("gather", "pregather"):
        raise ValueError(
            f"psi_dispatch must be 'gather' or 'pregather', got {psi_dispatch!r}")
    return psi_dispatch == "gather"


def take_col(m: torch.Tensor, f: int) -> torch.Tensor:
    """m[:, f] (a view)."""
    return m[:, f]


def put_col(m: torch.Tensor, f: int, col: torch.Tensor) -> torch.Tensor:
    """m with column f replaced, IN PLACE (the epochs own their copy of
    the factors); returns ``m``."""
    m[:, f] = col
    return m


def residuals_from_factors(phi, psi, ctx, item, y) -> torch.Tensor:
    """e = ŷ − ȳ on observed pairs: Σ_f φ_f(c)ψ_f(i) − ȳ, per nnz."""
    scores = torch.sum(phi[ctx] * psi[item], dim=-1)
    return scores - y


def to_item_major(e_ctx_major: torch.Tensor, t_perm: torch.Tensor) -> torch.Tensor:
    """Permute a per-nnz vector from context-major to item-major order."""
    with span("reorder"):
        return e_ctx_major[t_perm]


def to_ctx_major(e_item_major: torch.Tensor, t_perm: torch.Tensor) -> torch.Tensor:
    """Inverse permutation of :func:`to_item_major`."""
    with span("reorder"):
        out = torch.empty_like(e_item_major)
        out[t_perm] = e_item_major
        return out
