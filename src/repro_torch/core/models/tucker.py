"""iCD for Tucker Decomposition (paper §5.3.2; port of
``repro.core.models.tucker``).

Model (eq. 40): ŷ(c1,c2,i) = Σ_{f1,f2,f3} b_{f1,f2,f3} u_{c1,f1} v_{c2,f2} w_{i,f3}
with core tensor B ∈ R^{k1×k2×k3}. k3-separable:

    φ_f(c1,c2) = Σ_{f1,f2} b_{f1,f2,f} u_{c1,f1} v_{c2,f2},   ψ_f(i) = w_{i,f}

∂φ_f/∂u is non-zero for EVERY f (eq. 41), so the sweep keeps dense
k3-dimensional contractions per context row:

    U mode, dim f1*:  D(pair,f) = Σ_{f2} b_{f1*,f2,f} v_{c2,f2}
        R'/2  = segment_{c1}( Σ_f D_f · (Φ J_I)_f )
        R''/2 = segment_{c1}( Σ_f D_f · (D J_I)_f )
        L'/2  = segment_{c1}( ᾱ e s ),  s = Σ_f D_f w_{i,f}  per observation

The flat epoch sweeps a mode column with one pass over the pairs and the
log and one solve of every row's step (``kernels.tucker_mode``): D, its
(nnz, k3) gather and the sums are never formed in device memory.

Core coordinates b_{f1,f2,f3} all interact through Φ, so they are swept
strictly in sequence: k1·k2·k3 scalar Newton steps, as the reference's
``lax.fori_loop``. The k3 steps of a slab (f1, f2) share g = u_{f1}·v_{f2},
so one pass over the log a slab gives all of them
(``kernels.tucker_core``: K = Σ ᾱ g² w wᵀ, L'⁰ = Σ ᾱ e g w, Φᵀg from the
Gram of the g rows).

Context universe: the observed pair list. The item sweep is MF's
(``sweeps.item_side_sweep``) over the materialized Φ.

Fused padded path (:func:`epoch_padded`): the U/V mode sweeps run blocked
on :class:`~repro_torch.core.models.parafac.TensorPadded` grids through
the row-patch block sweep, whose per-row patch P[r, j, f] =
segment_r(Σ_g D^f_g (D^j J_I)_g) is how R' moves when mode coordinate j
takes a Newton step (Φ += Δ·D^j); Φ itself is patched between blocks from
the returned deltas. The core sweep stays on the flat path; the item sweep
is PARAFAC's fused MF-like sweep.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import sweeps
from repro_torch.core.gram import full_fp32, gram
from repro_torch.core.implicit import explicit_loss
from repro_torch.core.models.parafac import (
    TensorContext,
    TensorPadded,
    _padded_item_sweep,
    _reweight_padded,
    pad_tensor_groups,
)
from repro_torch.core.padded import PaddedGroup, append_sentinel_row
from repro_torch.kernels import resolve_device, vmem
from repro_torch.kernels.cd_sweep.ops import (
    cd_block_sweep_rowpatch,
    cd_block_sweep_rowpatch_gather,
)
from repro_torch.kernels.tucker_core import core_sweep_slabs
from repro_torch.kernels.tucker_mode import mode_sweep
from repro_torch.obs.trace import span
from repro_torch.sparse.interactions import Interactions, with_weights
from repro_torch.sparse.segment import segment_sum

__all__ = ["TuckerParams", "TuckerHyperParams", "pad_tensor_groups",
           "init", "params_from_numpy", "phi", "export_psi", "build_phi",
           "predict", "core_sweep_inputs", "core_sweep", "epoch", "epoch_padded", "residuals",
           "objective", "fit"]


class TuckerParams(NamedTuple):
    u: torch.Tensor  # (n_c1, k1)
    v: torch.Tensor  # (n_c2, k2)
    w: torch.Tensor  # (n_items, k3)
    b: torch.Tensor  # (k1, k2, k3) core tensor


@dataclasses.dataclass(frozen=True)
class TuckerHyperParams:
    k1: int
    k2: int
    k3: int
    alpha0: float = 1.0
    l2: float = 0.1
    l2_core: float = 0.1
    eta: float = 1.0
    implementation: str = "xla"  # Gram J_I: 'xla' = torch.mm, 'pallas' =
    #                              the hand-written Gram kernel
    block_k: int = 0  # columns per fused cd_sweep dispatch (epoch_padded):
    #                   0 = auto (min(mode k, 8)), 1 = per-column baseline
    psi_dispatch: str = "gather"  # fused-path Ψ routing: 'gather' = the
    #                   kernel gathers the flat pseudo-ψ slab, 'pregather'
    #                   = a (n, k_b, D_pad) scatter_blk tile first

    # the padded item sweep (parafac's) reads hp.k
    @property
    def k(self) -> int:
        return self.k3


def init(n_c1: int, n_c2: int, n_items: int, k1: int, k2: int, k3: int, *,
         generator: torch.Generator, sigma: float = 0.1) -> TuckerParams:
    """N(0, σ²) factors and core on the generator's device."""
    dev = generator.device
    return TuckerParams(*(
        sigma * torch.randn(shape, generator=generator, device=dev)
        for shape in ((n_c1, k1), (n_c2, k2), (n_items, k3), (k1, k2, k3))))


def params_from_numpy(u, v, w, b, *, device="cuda") -> TuckerParams:
    """The port's params from numpy factors and core (e.g. ``np.asarray``
    of the JAX package's ``TuckerParams``); on ``device``, the GPU unless
    the caller names the CPU."""
    device = resolve_device(device)
    return TuckerParams(*(torch.tensor(np.asarray(x, np.float32), device=device)
                          for x in (u, v, w, b)))


def _contract(up, vp, b) -> torch.Tensor:
    return torch.einsum("na,nb,abf->nf", up, vp, b)


def phi(params: TuckerParams, tc: TensorContext) -> torch.Tensor:
    """Φ (n_ctx, k3) over the observed pair list."""
    with full_fp32():
        return _contract(params.u[tc.c1], params.v[tc.c2], params.b)


def _ids(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.long, device=dev)


def predict(params: TuckerParams, c1, c2, item) -> torch.Tensor:
    dev = params.u.device
    with full_fp32():
        return torch.einsum("na,nb,nf,abf->n", params.u[_ids(c1, dev)],
                            params.v[_ids(c2, dev)], params.w[_ids(item, dev)],
                            params.b)


def export_psi(params: TuckerParams) -> torch.Tensor:
    """ψ table for the retrieval engine: (n_items, k3); Tucker is
    k3-separable with ψ_f(i) = w_{i,f}."""
    return params.w


def build_phi(params: TuckerParams, c1, c2) -> torch.Tensor:
    """φ rows for query context pairs: the core-contracted
    φ_f = Σ_{f1,f2} b_{f1,f2,f} u_{c1,f1} v_{c2,f2} (B, k3)."""
    dev = params.u.device
    with full_fp32():
        return _contract(params.u[_ids(c1, dev)], params.v[_ids(c2, dev)],
                         params.b)


def _mode_sweep(name, side, b_slices, partner_of_pair, partner, group_of_pair,
                groups, phi_m, j_i, data: Interactions, w_items, e, hp, schedule=None,
                sweep_index: int = 0):
    """Flat mode sweep of ``side`` (u or v, ``name``) under the span
    ``tucker.mode``: its columns in the order ``sweeps.sweep_columns``
    gives, by ``kernels.tucker_mode`` (one pass over the pairs and the log
    and one solve a column, then a closing patch). ``side`` and ``phi_m``
    are updated in place."""
    columns = sweeps.sweep_columns(side.shape[1], lambda f, cols: (*cols, f), (),
                                   schedule=schedule, sweep_index=sweep_index)
    with span("tucker.mode", side=name, columns=len(columns),
              passes=len(columns) + 1 if columns else 0):
        return mode_sweep(side, b_slices, partner, partner_of_pair, group_of_pair,
                          groups.order, groups.ptr, phi_m, j_i, w_items, data.ctx_ptr,
                          data.item, data.alpha, e, columns=columns, alpha0=hp.alpha0,
                          l2=hp.l2, eta=hp.eta)


def _mode_sweep_padded(side, b_blk_fn, partner_of_pair, partner,
                       group_of_pair, n_side: int, k_side: int, phi_m, j_i,
                       data: Interactions, w_items, pg: PaddedGroup, e_pad,
                       hp, k_b: int):
    """Fused Tucker mode sweep: k_b columns per row-patch launch. Per block
    the pseudo-ψ s^f = Σ_g D^f_g w_{i,g} goes to the kernel as a flat slab
    (or a ``scatter_blk`` tile on the ``'pregather'`` route); the slab
    state is R'/2 = segment(Σ_g D^f_g (Φ J)_g) and the per-row patch
    P[r, j, f] = segment(Σ_g D^f_g (D^j J)_g) (diagonal = R''/2). D^f is
    fixed during the sweep, so only Φ (patched from the returned deltas)
    and the kernel's e/R' state move. ``side``, ``phi_m`` and ``e_pad`` are
    updated in place."""
    pair_of_nnz = data.ctx
    w_nnz = w_items[data.item]                                  # (nnz, k3)
    use_gather = sweeps.resolve_psi_dispatch(hp.psi_dispatch)
    # sized once, before the sweep: a row too long for shared memory takes
    # the block-row form; only a k_b neither form fits raises
    vmem.cd_sweep_form(pg.d_pad, k_b, gather=use_gather, rowpatch=True)
    pp = partner[partner_of_pair]                               # (n_pairs, k_other)

    def block_body(f0, kb, carry):
        side_m, phi_m, e_pad = carry
        blk = slice(f0, f0 + kb)
        d_blk = torch.einsum("no,jof->njf", pp, b_blk_fn(f0, kb))  # (n, kb, k3)
        r1_blk = segment_sum(torch.einsum("njf,nf->nj", d_blk, phi_m @ j_i),
                             group_of_pair, n_side)
        dj = torch.einsum("njf,fg->njg", d_blk, j_i)
        p_blk = segment_sum(torch.einsum("njg,nig->nji", dj, d_blk),
                            group_of_pair, n_side)
        s_nnz = torch.einsum("njf,nf->nj", d_blk[pair_of_nnz], w_nnz)
        kw = dict(alpha0=hp.alpha0, l2=hp.l2, eta=hp.eta)
        if use_gather:
            w_new, e_pad = cd_block_sweep_rowpatch_gather(
                append_sentinel_row(s_nnz), pg.flat_ids, pg.alpha_pad, e_pad,
                side_m[:, blk], r1_blk, p_blk, **kw)
        else:
            w_new, e_pad = cd_block_sweep_rowpatch(
                pg.scatter_blk(s_nnz), pg.alpha_pad, e_pad, side_m[:, blk],
                r1_blk, p_blk, **kw)
        delta = w_new - side_m[:, blk]
        phi_m += torch.einsum("nj,njf->nf", delta[group_of_pair], d_blk)
        side_m[:, blk] = w_new
        return side_m, phi_m, e_pad

    return sweeps.sweep_columns(k_side, None, (side, phi_m, e_pad), block=k_b,
                                block_body=block_body)


def core_sweep_inputs(params: TuckerParams, phi_m, j_i, tc: TensorContext,
                      data: Interactions, e) -> tuple:
    """The arguments of ``kernels.tucker_core.core_sweep_slabs`` for a core
    sweep from ``params``, Φ (``phi_m``), J_I and the residuals ``e``: the
    g rows g_ab = u[c1, f1]·v[c2, f2] (k1·k2, n_pairs), their Gram G and
    R = Gₚ·Φ. Products in the caller's precision (``full_fp32`` for
    the reference's)."""
    u, v, w, b = params
    k1, k2, k3 = b.shape
    up, vp = u[tc.c1].T.contiguous(), v[tc.c2].T.contiguous()
    gp = (up[:, None, :] * vp[None, :, :]).reshape(k1 * k2, -1)
    return (w, gp, gp @ gp.T, gp @ phi_m, b.reshape(k1 * k2, k3), j_i, data.ctx_ptr,
            data.item, data.alpha, e)


def core_sweep(params: TuckerParams, phi_m, j_i, tc: TensorContext,
               data: Interactions, e, hp):
    """Sequential core-tensor sweep: one scalar Newton step per
    b_{f1,f2,f3}, in order, a slab (f1, f2) at a time
    (``kernels.tucker_core``: one pass over the log a slab). Returns
    ``(b, phi_m, e)``; ``phi_m`` is updated in place and ``params.b`` is
    left as it was."""
    with full_fp32():
        args = core_sweep_inputs(params, phi_m, j_i, tc, data, e)
        delta, e = core_sweep_slabs(*args, alpha0=hp.alpha0, l2_core=hp.l2_core,
                                    eta=hp.eta)
        phi_m.addmm_(args[1].T, delta)
    return params.b + delta.reshape(params.b.shape), phi_m, e


def epoch(params: TuckerParams, tc: TensorContext, data: Interactions, e,
          hp: TuckerHyperParams, schedule=None, sweep_index: int = 0,
          weights=None) -> Tuple[TuckerParams, torch.Tensor]:
    """One iCD epoch: U sweep → V sweep → core sweep → item (W) sweep,
    under the spans ``tucker.epoch`` (root), ``tucker.mode`` (``side`` u or
    v, ``columns`` swept, ``passes`` = columns + 1 over the log),
    ``tucker.core`` (``steps`` = k1·k2·k3, ``passes`` = k1·k2 + 1 over the
    log) and ``tucker.item``.

    A ``schedule`` restricts the FACTOR-mode sweeps; the scalar core sweep
    always runs in full. Returns new params and a new residual cache;
    ``params`` and ``e`` are left as they were. ``weights`` (optional,
    (nnz,) ctx-major) folds per-interaction confidence into α exactly."""
    data = with_weights(data, weights)
    u, v, w, b = (t.clone() for t in params)
    with span("tucker.epoch"), full_fp32():
        j_i = gram(w, implementation=hp.implementation)
        phi_m = phi(params, tc).contiguous()
        u, phi_m, e = _mode_sweep("u", u, b, tc.c2, v, tc.c1, tc.c1_groups, phi_m, j_i,
                                  data, w, e, hp, schedule, sweep_index)
        v, phi_m, e = _mode_sweep("v", v, b.transpose(0, 1), tc.c1, u, tc.c2,
                                  tc.c2_groups, phi_m, j_i, data, w, e, hp, schedule,
                                  sweep_index)
        with span("tucker.core", steps=hp.k1 * hp.k2 * hp.k3,
                  passes=hp.k1 * hp.k2 + 1):
            b, phi_m, e = core_sweep(TuckerParams(u, v, w, b), phi_m, j_i, tc,
                                     data, e, hp)
        with span("tucker.item"):
            w, e = sweeps.item_side_sweep(
                w, gram(phi_m), lambda f: phi_m[:, f], data, e, alpha0=hp.alpha0,
                l2=hp.l2, eta=hp.eta, schedule=schedule, sweep_index=sweep_index)
    return TuckerParams(u, v, w, b), e


def epoch_padded(params: TuckerParams, tc: TensorContext, data: Interactions,
                 padded: TensorPadded, e, hp: TuckerHyperParams,
                 weights=None) -> Tuple[TuckerParams, torch.Tensor]:
    """Fused-kernel iCD epoch on the padded layouts; the same sweep order
    and fixed point as :func:`epoch`. U/V mode sweeps and the MF-like item
    sweep run blocked; the core sweep stays on the flat path. ``weights``
    rebuilds all three group α grids (and the flat α the core sweep
    reads). Returns new params and a new flat residual cache."""
    if weights is not None:
        data = with_weights(data, weights)
        padded = _reweight_padded(padded, data.alpha)
    u, v, w, b = (t.clone() for t in params)
    with full_fp32():
        j_i = gram(w, implementation=hp.implementation)
        phi_m = phi(params, tc)

        e_g = padded.g1.scatter(e)
        u, phi_m, e_g = _mode_sweep_padded(
            u, lambda f0, kb: b[f0:f0 + kb], tc.c2, v, tc.c1, u.shape[0],
            hp.k1, phi_m, j_i, data, w, padded.g1, e_g, hp,
            sweeps.resolve_block_k(hp.block_k, hp.k1))
        e = padded.g1.gather(e_g)

        e_g = padded.g2.scatter(e)
        v, phi_m, e_g = _mode_sweep_padded(
            v, lambda f0, kb: b[:, f0:f0 + kb].movedim(1, 0), tc.c1, u, tc.c2,
            v.shape[0], hp.k2, phi_m, j_i, data, w, padded.g2, e_g, hp,
            sweeps.resolve_block_k(hp.block_k, hp.k2))
        e = padded.g2.gather(e_g)

        b, phi_m, e = core_sweep(TuckerParams(u, v, w, b), phi_m, j_i, tc,
                                 data, e, hp)
        j_c = gram(phi_m)
        e_g = padded.gi.scatter(e)
        w, e_g = _padded_item_sweep(w, j_c, phi_m, padded, e_g, hp,
                                    sweeps.resolve_block_k(hp.block_k, hp.k3))
        e = padded.gi.gather(e_g)
    return TuckerParams(u, v, w, b), e


def residuals(params: TuckerParams, tc: TensorContext,
              data: Interactions) -> torch.Tensor:
    return sweeps.residuals_from_factors(phi(params, tc), params.w, data.ctx,
                                         data.item, data.y)


def objective(params: TuckerParams, tc: TensorContext, data: Interactions,
              hp: TuckerHyperParams) -> torch.Tensor:
    e = residuals(params, tc, data)
    with full_fp32():
        reg = torch.sum(gram(phi(params, tc)) * gram(params.w))
    sq = (torch.sum(params.u ** 2) + torch.sum(params.v ** 2)
          + torch.sum(params.w ** 2))
    return (explicit_loss(e, data.alpha) + hp.alpha0 * reg + hp.l2 * sq
            + hp.l2_core * torch.sum(params.b ** 2))


def fit(params: TuckerParams, tc: TensorContext, data: Interactions,
        hp: TuckerHyperParams, n_epochs: int, callback=None, schedule=None,
        weights=None) -> TuckerParams:
    """Run ``n_epochs`` flat epochs (as the reference's ``fit``);
    ``callback(epoch, params)`` after each."""
    e = residuals(params, tc, data)
    for ep in range(n_epochs):
        params, e = epoch(params, tc, data, e, hp, schedule, ep, weights)
        if callback is not None:
            callback(ep, params)
    return params
