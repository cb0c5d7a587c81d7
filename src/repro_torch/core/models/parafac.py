"""iCD for PARAFAC tensor factorization (paper §5.3.1; port of
``repro.core.models.parafac``).

Model (eq. 34): ŷ(c1,c2,i) = Σ_f u_{c1,f} v_{c2,f} w_{i,f}, the 3-mode
extension of MF. k-separable with φ_f(c1,c2) = u_{c1,f}·v_{c2,f} and
ψ_f(i) = w_{i,f} (eq. 35). The regularizer derivatives (eqs. 37–38) reduce
to per-c1 reductions over that context's *partner* c2 values:

    R'(u_{c1*,f*})  = 2 Σ_f J_I(f,f*) u_{c1*,f} K_{c1*}(f,f*)
    R''(u_{c1*,f*}) = 2 J_I(f*,f*) K_{c1*}(f*,f*)
    K_{c1}(f,f*)    = Σ_{c2:(c1,c2)∈C} v_{c2,f} v_{c2,f*}

Context modes:
  * ``sparse`` — C ⊂ C1×C2 is exactly the provided pair list; K is a
    segment sum over pairs.
  * ``dense``  — C = C1×C2; K is J_{C2} (eq. 39), the same for every c1,
    and J_C = J_{C1} ⊙ J_{C2} for the item sweep.

The item sweep is MF's (§5.1): ``sweeps.item_side_sweep``, its sums over
the log's item-major rows by ``segment.segment_sum_sorted`` (a
hand-written kernel on CUDA, in a fixed order).

Fused padded path (:func:`epoch_padded`, dispatched by ``hp.block_k`` as
in ``mf_padded``): each side's sweep runs on a
:class:`~repro_torch.core.padded.PaddedGroup` grid (nnz grouped by c1, by
c2, by item) through ``sweeps.sweep_columns`` block bodies. The context
modes launch the row-patch block sweep (``cd_block_sweep_rowpatch*``):
their R'/R'' coupling is ROW-dependent (P[r, j, f] = J(j,f)·K_r(j,f)), so
the Gauss–Seidel patch rides per row; the item sweep is MF-like and
launches the shared-Gram sweep. A context mode with a few long rows
(CtxMF's 24 hour-of-day buckets) takes the block-row launch form.

PyTorch runs eagerly, so each block's host-side products (Φ over the pair
list, the R'/2 slab, the K segment sums, the pseudo-ψ slab) are plain
PyTorch in full fp32 between the kernel launches, as the reference leaves
them to XLA. On CUDA the context modes' segment sums (``index_add_``) use
atomics: their last bits can change from run to run.
:func:`params_from_numpy` carries the JAX package's ``PARAFACParams`` over
as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sweeps
from repro_torch.core.gram import full_fp32, gram
from repro_torch.core.implicit import explicit_loss
from repro_torch.core.padded import (
    PaddedGroup,
    append_sentinel_row,
    build_group,
    group_slots,
)
from repro_torch.kernels import resolve_device, vmem
from repro_torch.kernels.cd_sweep.ops import (
    cd_block_sweep,
    cd_block_sweep_gather,
    cd_block_sweep_rowpatch,
    cd_block_sweep_rowpatch_gather,
)
from repro_torch.sparse.interactions import Interactions, with_weights
from repro_torch.sparse.segment import segment_sum


class PARAFACParams(NamedTuple):
    u: torch.Tensor  # (n_c1, k)
    v: torch.Tensor  # (n_c2, k)
    w: torch.Tensor  # (n_items, k)


class PairGroups(NamedTuple):
    """The pairs grouped by one mode's id: ``order`` (n_ctx,) int32 lists
    the pairs group by group, each group's in pair order (None where the
    pair list already is in that order), and ``ptr`` (n + 1,) int64 gives
    group g's slice ``order[ptr[g]:ptr[g + 1]]``."""

    order: Optional[torch.Tensor]
    ptr: torch.Tensor


def pair_groups(ids: torch.Tensor, n: int) -> PairGroups:
    """:class:`PairGroups` of the pairs by ``ids`` (n_ctx,) in [0, n)."""
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
    ptr[1:] = torch.cumsum(torch.bincount(ids, minlength=n), 0)
    if bool(torch.all(ids[1:] >= ids[:-1])):
        return PairGroups(None, ptr)
    return PairGroups(torch.argsort(ids, stable=True).to(torch.int32), ptr)


@dataclasses.dataclass(frozen=True)
class TensorContext:
    """Observed context pairs C ⊆ C1×C2 (int64 tensors; the reference keeps
    int32, with the same values). ``Interactions.ctx`` indexes rows of this
    pair list. ``c1_groups`` and ``c2_groups``, the pairs grouped by each
    mode, are built at their first use and kept."""

    c1: torch.Tensor  # (n_ctx,)
    c2: torch.Tensor  # (n_ctx,)
    n_c1: int
    n_c2: int

    @property
    def n_ctx(self) -> int:
        return int(self.c1.shape[0])

    @functools.cached_property
    def c1_groups(self) -> PairGroups:
        return pair_groups(self.c1, self.n_c1)

    @functools.cached_property
    def c2_groups(self) -> PairGroups:
        return pair_groups(self.c2, self.n_c2)


@dataclasses.dataclass(frozen=True)
class PARAFACHyperParams:
    k: int
    alpha0: float = 1.0
    l2: float = 0.1
    eta: float = 1.0
    dense_context: bool = False  # True ⇒ regularizer universe is C1×C2
    implementation: str = "xla"  # Gram J_I: 'xla' = torch.mm, 'pallas' =
    #                              the hand-written Gram kernel
    block_k: int = 0  # columns per fused cd_sweep dispatch on the padded
    #                   layout (epoch_padded): 0 = auto (min(k, 8)),
    #                   1 = per-column baseline through the block path
    psi_dispatch: str = "gather"  # fused-path Ψ routing: 'gather' = the
    #                   kernel gathers the flat pseudo-ψ slab, 'pregather'
    #                   = a (n, k_b, D_pad) scatter_blk tile first


@dataclasses.dataclass(frozen=True)
class TensorPadded:
    """Padded layouts for the fused tensor-model sweeps: the flat nnz list
    grouped by c1, by c2 and by item, plus the item-major pair-id grid the
    MF-like item sweep gathers Φ rows through."""

    g1: PaddedGroup
    g2: PaddedGroup
    gi: PaddedGroup
    pair_ids_item: torch.Tensor  # (n_items, gi.d_pad) int32; 0 on padding


def pad_tensor_groups(tc: TensorContext, data: Interactions,
                      lane: int = 128) -> TensorPadded:
    """Build the three padded groupings of the observed set on the data's
    device. Equal, array for array, to the reference's."""
    pair_of_nnz = data.ctx.cpu().numpy()
    alpha = data.alpha.cpu().numpy()
    item = data.item.cpu().numpy()
    dev = data.device
    g1 = build_group(tc.c1.cpu().numpy()[pair_of_nnz], alpha, tc.n_c1, lane,
                     device=dev)
    g2 = build_group(tc.c2.cpu().numpy()[pair_of_nnz], alpha, tc.n_c2, lane,
                     device=dev)
    gi = build_group(item, alpha, data.n_items, lane, device=dev)
    d_pad, slot = group_slots(item, data.n_items, lane)
    pair_ids_item = np.zeros((data.n_items, d_pad), np.int32)
    pair_ids_item[item, slot] = pair_of_nnz
    return TensorPadded(g1=g1, g2=g2, gi=gi,
                        pair_ids_item=torch.as_tensor(pair_ids_item, device=dev))


def init(n_c1: int, n_c2: int, n_items: int, k: int, *,
         generator: torch.Generator, sigma: float = 0.1) -> PARAFACParams:
    """N(0, σ²) factors on the generator's device. To compare with the JAX
    package, build one set of numpy factors and use
    :func:`params_from_numpy`."""
    dev = generator.device
    return PARAFACParams(*(
        sigma * torch.randn((n, k), generator=generator, device=dev)
        for n in (n_c1, n_c2, n_items)))


def params_from_numpy(u, v, w, *, device="cuda") -> PARAFACParams:
    """The port's params from numpy factors, e.g. ``np.asarray`` of the JAX
    package's ``PARAFACParams``; on ``device``, the GPU unless the caller
    names the CPU."""
    device = resolve_device(device)
    return PARAFACParams(*(torch.tensor(np.asarray(x, np.float32), device=device)
                           for x in (u, v, w)))


def phi(params: PARAFACParams, tc: TensorContext) -> torch.Tensor:
    """Φ over the observed pair list (sparse-context materialization)."""
    return params.u[tc.c1] * params.v[tc.c2]


def psi(params: PARAFACParams) -> torch.Tensor:
    return params.w


def export_psi(params: PARAFACParams) -> torch.Tensor:
    """ψ table for the retrieval engine: (n_items, k)."""
    return params.w


def _ids(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.long, device=dev)


def build_phi(params: PARAFACParams, c1, c2) -> torch.Tensor:
    """φ rows for query context pairs: φ_f = u_{c1,f}·v_{c2,f} (eq. 35)."""
    dev = params.u.device
    return params.u[_ids(c1, dev)] * params.v[_ids(c2, dev)]


def predict(params: PARAFACParams, c1, c2, item) -> torch.Tensor:
    dev = params.u.device
    return torch.sum(params.u[_ids(c1, dev)] * params.v[_ids(c2, dev)]
                     * params.w[_ids(item, dev)], dim=-1)


def _context_mode_sweep(side, partner, group_of_pair, partner_of_pair, j_i,
                        data: Interactions, w_items, e, n_side: int,
                        hp: PARAFACHyperParams, schedule=None,
                        sweep_index: int = 0):
    """Sweep one context mode (U or V) over the flat pairs. Sparse-context
    K via segment sums; dense-context K via the partner Gram (eq. 39).
    ``side`` is updated in place."""
    pair_of_nnz = data.ctx
    grp_nnz = group_of_pair[pair_of_nnz]
    pp = None if hp.dense_context else partner[partner_of_pair]  # (n_ctx, k)

    def body(f, carry):
        side_m, e = carry
        s_col = sweeps.take_col(side_m, f)
        p_col_pair = sweeps.take_col(partner, f)[partner_of_pair]  # (n_ctx,)
        w_col_nnz = sweeps.take_col(w_items, f)[data.item]
        other_nnz = p_col_pair[pair_of_nnz] * w_col_nnz          # ∂ŷ per nnz
        lp = segment_sum(data.alpha * e * other_nnz, grp_nnz, n_side)
        lpp = segment_sum(data.alpha * other_nnz * other_nnz, grp_nnz, n_side)
        if hp.dense_context:
            # K_{c1}(·,f*) = J_partner[:, f*], the same for every group row
            j_p_col = partner.T @ sweeps.take_col(partner, f)    # (k,)
            kmat = j_p_col[None, :].expand(side_m.shape)
        else:
            kmat = segment_sum(pp * p_col_pair[:, None], group_of_pair, n_side)
        rp = torch.sum(kmat * side_m * sweeps.take_col(j_i, f)[None, :], dim=1)
        rpp = j_i[f, f] * sweeps.take_col(kmat, f)
        delta = sweeps.newton_delta(
            sweeps.NewtonParts(lp + hp.alpha0 * rp, lpp + hp.alpha0 * rpp),
            s_col, hp.l2, hp.eta)
        e = e + delta[grp_nnz] * other_nnz
        return sweeps.put_col(side_m, f, s_col + delta), e

    return sweeps.sweep_columns(hp.k, body, (side, e), schedule=schedule,
                                sweep_index=sweep_index)


def _context_mode_sweep_padded(side, partner, group_of_pair, partner_of_pair,
                               j_i, data: Interactions, w_items,
                               pg: PaddedGroup, e_pad, n_side: int,
                               hp: PARAFACHyperParams, k_b: int):
    """Fused context-mode sweep: ``k_b`` columns per row-patch launch.
    Slab state per block: R'/2 ``(n, k_b)`` via Φ·J over pairs and the
    per-row patch P = J ⊙ K (diagonal = R''/2, eqs. 37–38); the kernel's
    Gauss–Seidel R' patch keeps later block columns exact. The flat
    pseudo-ψ ``s_nnz (nnz, k_b)`` rides into the gather form as a slab
    (+ zero sentinel row) with ``pg.flat_ids``; ``scatter_blk``'s tile
    exists only on the ``'pregather'`` route. ``side`` and ``e_pad`` are
    updated in place."""
    pair_of_nnz = data.ctx
    w_nnz = w_items[data.item]                                  # (nnz, k)
    use_gather = sweeps.resolve_psi_dispatch(hp.psi_dispatch)
    # sized once, before the sweep: a row too long for shared memory takes
    # the block-row form; only a k_b neither form fits raises
    vmem.cd_sweep_form(pg.d_pad, k_b, gather=use_gather, rowpatch=True)
    pp = partner[partner_of_pair]                               # (n_pairs, k)
    j_p = partner.T @ partner if hp.dense_context else None     # eq. 39 K

    def block_body(f0, kb, carry):
        side_m, e_pad = carry
        blk = slice(f0, f0 + kb)
        v_pair = pp[:, blk]                                     # (n_pairs, kb)
        if hp.dense_context:
            # K = J_partner for EVERY row (regularizer universe C1×C2): R'
            # collapses to a dense product, and P is one block for all rows
            r1_blk = side_m @ (j_p[:, blk] * j_i[:, blk])
            p_blk = (j_p[blk, blk] * j_i[blk, blk]).expand(n_side, kb, kb)
        else:
            phi_full = side_m[group_of_pair] * pp               # (n_pairs, k)
            r1_blk = segment_sum(v_pair * (phi_full @ j_i[:, blk]),
                                 group_of_pair, n_side)
            k_blk = segment_sum(v_pair[:, :, None] * v_pair[:, None, :],
                                group_of_pair, n_side)
            p_blk = k_blk * j_i[blk, blk][None, :, :]           # J ⊙ K
        s_nnz = v_pair[pair_of_nnz] * w_nnz[:, blk]
        kw = dict(alpha0=hp.alpha0, l2=hp.l2, eta=hp.eta)
        if use_gather:
            w_new, e_pad = cd_block_sweep_rowpatch_gather(
                append_sentinel_row(s_nnz), pg.flat_ids, pg.alpha_pad, e_pad,
                side_m[:, blk], r1_blk, p_blk, **kw)
        else:
            w_new, e_pad = cd_block_sweep_rowpatch(
                pg.scatter_blk(s_nnz), pg.alpha_pad, e_pad, side_m[:, blk],
                r1_blk, p_blk, **kw)
        side_m[:, blk] = w_new
        return side_m, e_pad

    return sweeps.sweep_columns(hp.k, None, (side, e_pad), block=k_b,
                                block_body=block_body)


def _padded_item_sweep(w_m, j_c, phi_pairs, padded: TensorPadded, e_pad, hp,
                       k_b: int):
    """MF-like fused item sweep (shared-Gram block sweep): ψ rows gathered
    from Φ through the item-major pair-id grid — in the kernel by default
    (the ψ slab is ``phi_pairs[:, f0:f0+k_b]``, read where it lies),
    pre-gathered on the ``'pregather'`` route. ``w_m`` and ``e_pad`` are
    updated in place."""
    use_gather = vmem.resolve_cd_sweep_dispatch(
        padded.gi.d_pad, k_b,
        prefer_gather=sweeps.resolve_psi_dispatch(hp.psi_dispatch))

    def block_body(f0, kb, carry):
        w_m, e_pad = carry
        blk = slice(f0, f0 + kb)
        r1_blk = w_m @ j_c[:, blk]
        kw = dict(alpha0=hp.alpha0, l2=hp.l2, eta=hp.eta)
        if use_gather:
            w_new, e_pad = cd_block_sweep_gather(
                phi_pairs[:, blk], padded.pair_ids_item, padded.gi.alpha_pad,
                e_pad, w_m[:, blk], r1_blk, j_c[blk, blk], **kw)
        else:
            psi_blk = phi_pairs[:, blk][padded.pair_ids_item.long()]
            w_new, e_pad = cd_block_sweep(
                psi_blk.movedim(-1, 1).contiguous(), padded.gi.alpha_pad,
                e_pad, w_m[:, blk], r1_blk, j_c[blk, blk], **kw)
        w_m[:, blk] = w_new
        return w_m, e_pad

    return sweeps.sweep_columns(hp.k, None, (w_m, e_pad), block=k_b,
                                block_body=block_body)


def epoch(params: PARAFACParams, tc: TensorContext, data: Interactions,
          e: torch.Tensor, hp: PARAFACHyperParams, schedule=None,
          sweep_index: int = 0,
          weights=None) -> Tuple[PARAFACParams, torch.Tensor]:
    """One iCD epoch over the flat pairs: U sweep → V sweep → item (W)
    sweep (scheduled columns; ``schedule=None`` = full pass). Returns new
    factors and a new residual cache; ``params`` and ``e`` are left as
    they were. ``weights`` (optional, (nnz,) ctx-major) folds
    per-interaction confidence into α exactly."""
    data = with_weights(data, weights)
    u, v, w = (t.clone() for t in params)
    with full_fp32():
        j_i = gram(w, implementation=hp.implementation)
        u, e = _context_mode_sweep(u, v, tc.c1, tc.c2, j_i, data, w, e,
                                   u.shape[0], hp, schedule, sweep_index)
        v, e = _context_mode_sweep(v, u, tc.c2, tc.c1, j_i, data, w, e,
                                   v.shape[0], hp, schedule, sweep_index)
        if hp.dense_context:
            j_c = gram(u) * gram(v)  # eq. (39): J_C = J_{C1} ⊙ J_{C2}
        else:
            j_c = gram(u[tc.c1] * v[tc.c2])
        w, e = sweeps.item_side_sweep(
            w, j_c, lambda f: u[:, f][tc.c1] * v[:, f][tc.c2], data, e,
            alpha0=hp.alpha0, l2=hp.l2, eta=hp.eta, schedule=schedule,
            sweep_index=sweep_index)
    return PARAFACParams(u, v, w), e


def _reweight_padded(padded: TensorPadded, alpha_eff) -> TensorPadded:
    return dataclasses.replace(
        padded, g1=padded.g1.with_alpha(alpha_eff),
        g2=padded.g2.with_alpha(alpha_eff), gi=padded.gi.with_alpha(alpha_eff))


def epoch_padded(params: PARAFACParams, tc: TensorContext, data: Interactions,
                 padded: TensorPadded, e: torch.Tensor, hp: PARAFACHyperParams,
                 weights=None) -> Tuple[PARAFACParams, torch.Tensor]:
    """Fused-kernel iCD epoch on the padded layouts; the same sweep order
    and fixed point as :func:`epoch`. The flat residual cache is re-grouped
    per sweep (scatter in, gather out). Returns new factors and a new flat
    residual cache; ``params`` and ``e`` are left as they were.
    ``weights`` rebuilds all three group α grids."""
    if weights is not None:
        data = with_weights(data, weights)
        padded = _reweight_padded(padded, data.alpha)
    u, v, w = (t.clone() for t in params)
    k_b = sweeps.resolve_block_k(hp.block_k, hp.k)
    with full_fp32():
        j_i = gram(w, implementation=hp.implementation)
        e_g = padded.g1.scatter(e)
        u, e_g = _context_mode_sweep_padded(u, v, tc.c1, tc.c2, j_i, data, w,
                                            padded.g1, e_g, u.shape[0], hp, k_b)
        e = padded.g1.gather(e_g)

        e_g = padded.g2.scatter(e)
        v, e_g = _context_mode_sweep_padded(v, u, tc.c2, tc.c1, j_i, data, w,
                                            padded.g2, e_g, v.shape[0], hp, k_b)
        e = padded.g2.gather(e_g)

        phi_pairs = u[tc.c1] * v[tc.c2]
        if hp.dense_context:
            j_c = gram(u) * gram(v)  # eq. (39): J_C = J_{C1} ⊙ J_{C2}
        else:
            j_c = gram(phi_pairs)
        e_g = padded.gi.scatter(e)
        w, e_g = _padded_item_sweep(w, j_c, phi_pairs, padded, e_g, hp, k_b)
        e = padded.gi.gather(e_g)
    return PARAFACParams(u, v, w), e


def residuals(params: PARAFACParams, tc: TensorContext,
              data: Interactions) -> torch.Tensor:
    return sweeps.residuals_from_factors(phi(params, tc), params.w, data.ctx,
                                         data.item, data.y)


def objective(params: PARAFACParams, tc: TensorContext, data: Interactions,
              hp: PARAFACHyperParams) -> torch.Tensor:
    e = residuals(params, tc, data)
    with full_fp32():
        if hp.dense_context:
            reg = torch.sum(gram(params.u) * gram(params.v) * gram(params.w))
        else:
            reg = torch.sum(gram(phi(params, tc)) * gram(params.w))
    sq = sum(torch.sum(p ** 2) for p in params)
    return explicit_loss(e, data.alpha) + hp.alpha0 * reg + hp.l2 * sq


def fit(params: PARAFACParams, tc: TensorContext, data: Interactions,
        hp: PARAFACHyperParams, n_epochs: int, callback=None, schedule=None,
        weights=None) -> PARAFACParams:
    """Run ``n_epochs`` flat epochs (as the reference's ``fit``);
    ``callback(epoch, params)`` after each."""
    e = residuals(params, tc, data)
    for ep in range(n_epochs):
        params, e = epoch(params, tc, data, e, hp, schedule, ep, weights)
        if callback is not None:
            callback(ep, params)
    return params
