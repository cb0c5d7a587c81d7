"""iCD for Matrix Factorization with Side Information (paper §5.2.1,
Algorithm 3; port of ``repro.core.models.mfsi``).

Model (eq. 20): ŷ(c,i) = x_c W (z_i H)ᵀ with feature embeddings
W ∈ R^{p×k}, H ∈ R^{p'×k}. k-separable via φ_f(c) = Σ_l x_{c,l} w_{l,f}
(eq. 21); gradients are sparse in f (eq. 22), so

    R'(w_{l*,f*})  = 2 Σ_f J_I(f,f*) Σ_c x_{c,l*} φ_f(c)        (eq. 23)
    R''(w_{l*,f*}) = 2 J_I(f*,f*) Σ_c x_{c,l*}²                 (eq. 24)

and Φ is kept in sync with the eq. (25) incremental update. Coordinates
of a one-hot field never share a row, so a whole field × one dimension
updates as one vectorized Newton step. The explicit part uses three
per-context caches, patched instead of recomputed:

    q_c  = Σ_{i∈S_c} ᾱ e ψ_{f*}(i)     (patched: Δq = Δφ_{f*}·p2)
    p2_c = Σ_{i∈S_c} ᾱ ψ_{f*}(i)²      (constant during the side sweep)
    r_c  = Σ_f J(f,f*) φ_f(c)          (patched: Δr = Δφ_{f*}·J(f*,f*))

One-hot fields update EXACTLY. Features of a multi-hot (bag) field share
rows, so two modes: ``jacobi`` (default; one damped, η≈0.5, parallel
Newton step per field with full row sums) and ``slot`` (sequential over
bag slots, each slot a one-hot-like layer with fresh residuals).

Fused padded path (:func:`epoch_padded` over ``mf_padded``'s
``PaddedInteractions``, dispatched by ``hp.block_k``): per block of k_b
dimensions ONE slab-reduce launch (``kernels/cd_sweep``, ``cd_slab.cu``)
streams e/α and yields the q/p2 caches of every block column plus the
coupling slab P (q_f' moves by Δφ_j·P[·,j,f'] when dimension j's features
step), the field-level Newton steps run in PyTorch on those slabs, and
ONE residual-patch launch applies the rank-k_b patch. Ψ routing
(``hp.psi_dispatch``): ``'gather'`` passes the ψ slab ``other_psi[:, blk]``
and the id grid, and the kernels gather; ``'pregather'`` builds the
(C, k_b, D_pad) tile first. Both kernels take any D_pad, so no row length
is refused (the reference's VMEM residency check has no counterpart here).

Flat path (:func:`epoch`): each field layer of a dimension is one call of
the hand-written field-layer kernels (``kernels/mfsi_layer``: sums, steps
and cache patches in three launches, four for a bag); the moments and the
residual patch stay PyTorch. On the padded path the field layers are host
loops of gathers and ``index_add_`` segment sums. Both run in full fp32,
and on CUDA both sum by atomics, so their last bits can change from run
to run. The padded residual grid ``e_pad`` is updated in place, as the
reference donates it: callers rebind. :func:`params_from_numpy` carries
the JAX package's ``MFSIParams`` over as numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import sweeps
from repro_torch.core.design import Design, design_matmul, take_rows
from repro_torch.core.gram import full_fp32, gram
from repro_torch.core.implicit import implicit_objective
from repro_torch.core.models.mf_padded import (
    PaddedInteractions,
    pad_interactions,
    reweight_padded,
    scatter_ctx_major,
    transfer_ctx_to_item,
    transfer_item_to_ctx,
)
from repro_torch.kernels import resolve_device
from repro_torch.kernels.cd_sweep.ops import (
    cd_resid_patch,
    cd_resid_patch_gather,
    cd_slab_reduce,
    cd_slab_reduce_gather,
)
from repro_torch.kernels.mfsi_layer import ops as field_layer_ops
from repro_torch.obs.trace import span
from repro_torch.sparse.interactions import Interactions, with_weights
from repro_torch.sparse.segment import segment_sum, segment_sum_sorted

__all__ = ["MFSIParams", "MFSIHyperParams", "pad_interactions", "init",
           "params_from_numpy", "phi", "psi", "export_psi", "build_phi",
           "predict", "epoch", "epoch_padded", "residuals",
           "residuals_padded", "objective", "fit"]


class MFSIParams(NamedTuple):
    w: torch.Tensor  # (p_ctx, k)  stacked context-feature embeddings
    h: torch.Tensor  # (p_item, k) stacked item-feature embeddings


@dataclasses.dataclass(frozen=True)
class MFSIHyperParams:
    k: int
    alpha0: float = 1.0
    l2: float = 0.1
    eta: float = 1.0
    multi_hot_mode: str = "jacobi"  # 'jacobi' | 'slot'
    jacobi_eta: float = 0.5
    implementation: str = "xla"  # Grams: 'xla' = torch.mm, 'pallas' = the
    #                              hand-written Gram kernel
    block_k: int = 0  # dims per fused slab-reduce/resid-patch dispatch on
    #                   the padded layout (epoch_padded): 0 = auto
    #                   (min(k, 8)), 1 = per-dimension baseline
    psi_dispatch: str = "gather"  # fused-path Ψ routing: 'gather' = the
    #                   kernels gather from the ψ slab, 'pregather' = a
    #                   (C, k_b, D_pad) Ψ tile gathered before the launch


def init(p_ctx: int, p_item: int, k: int, *, generator: torch.Generator,
         sigma: float = 0.1) -> MFSIParams:
    """N(0, σ²) embeddings on the generator's device. To compare with the
    JAX package, build one set of numpy embeddings and use
    :func:`params_from_numpy`."""
    dev = generator.device
    return MFSIParams(*(sigma * torch.randn((n, k), generator=generator,
                                            device=dev)
                        for n in (p_ctx, p_item)))


def params_from_numpy(w, h, *, device="cuda") -> MFSIParams:
    """The port's params from numpy embeddings, e.g. ``np.asarray`` of the
    JAX package's ``MFSIParams``; on ``device``, the GPU unless the caller
    names the CPU."""
    device = resolve_device(device)
    return MFSIParams(*(torch.tensor(np.asarray(x, np.float32), device=device)
                        for x in (w, h)))


def phi(params: MFSIParams, x: Design) -> torch.Tensor:
    return design_matmul(x, params.w)


def psi(params: MFSIParams, z: Design) -> torch.Tensor:
    return design_matmul(z, params.h)


def export_psi(params: MFSIParams, z: Design) -> torch.Tensor:
    """ψ table for the retrieval engine: Ψ = Z·H (n_items, k), one row per
    catalogue item of the item design ``z``."""
    return psi(params, z)


def build_phi(params: MFSIParams, x: Design, rows=None) -> torch.Tensor:
    """φ rows for query contexts: Φ = X·W over ``rows`` of the context
    design ``x`` (rows are gathered BEFORE the product, so a query batch
    is O(B·k)); ⟨φ, ψ_i⟩ = ŷ (eq. 20)."""
    return phi(params, x if rows is None else take_rows(x, rows))


def predict(params: MFSIParams, x: Design, z: Design, ctx, item) -> torch.Tensor:
    dev = params.w.device
    ph, ps = phi(params, x), psi(params, z)
    ctx = torch.as_tensor(ctx, dtype=torch.long, device=dev)
    item = torch.as_tensor(item, dtype=torch.long, device=dev)
    return torch.sum(ph[ctx] * ps[item], dim=-1)


def _field_layer_update(table_col, phi_col, q, r_vec, p2, jff, ids_g, xw,
                        rows, vocab, offset, hp, eta):
    """One vectorized Newton update of a one-hot layer (field or bag slot).

    ids_g:  (n,) global feature ids for this layer (offset applied)
    xw:     (n,) feature values x_{c,l} (0 ⇒ row inactive in this layer)
    rows:   (n,) context row per entry (identity for bag=1 fields)

    Returns new tensors; patches the per-context caches (eq. 25) but NOT
    the residual cache — the caller owns the e layout (flat per-nnz or
    padded grid) and applies ``dphi_rows`` there."""
    local = ids_g - offset
    lp = segment_sum(xw * q[rows], local, vocab)
    lpp = segment_sum(xw * xw * p2[rows], local, vocab)
    rp = segment_sum(xw * r_vec[rows], local, vocab)
    rpp = jff * segment_sum(xw * xw, local, vocab)
    delta = sweeps.newton_delta(
        sweeps.NewtonParts(lp + hp.alpha0 * rp, lpp + hp.alpha0 * rpp),
        table_col[offset:offset + vocab], hp.l2, eta)

    table_col = table_col.clone()
    table_col[offset:offset + vocab] += delta
    dphi_rows = segment_sum(xw * delta[local], rows, q.shape[0])
    return (table_col, phi_col + dphi_rows, q + dphi_rows * p2,
            r_vec + dphi_rows * jff, dphi_rows)


def _field_layers(design: Design, hp) -> list:
    """Flatten the field loop into (ids, weights, rows, vocab, offset, eta)
    layers: one-hot fields (and 'slot' mode bags) update per slot — exact
    CD; 'jacobi' bags update whole-bag in one damped parallel step."""
    dev = design.fields[0].ids.device
    row_idx = torch.arange(design.n_rows, device=dev)
    layers = []
    for field in design.fields:
        gids = design.global_ids(field)
        if field.one_hot or hp.multi_hot_mode == "slot":
            for j in range(field.bag):
                layers.append((gids[:, j], field.weights[:, j], row_idx,
                               field.vocab, field.offset, hp.eta))
        else:
            layers.append((gids.reshape(-1), field.weights.reshape(-1),
                           row_idx.repeat_interleave(field.bag),
                           field.vocab, field.offset, hp.jacobi_eta))
    return layers


def _side_sweep(table, phi_m, other_psi, other_j, design: Design, rows_nnz,
                row_ptr, other_nnz_ids, alpha, e, hp: MFSIHyperParams,
                schedule=None, sweep_index: int = 0, *, side: str):
    """One side's per-dimension sweep over the flat observations;
    ``rows_nnz`` are the entries' rows, sorted, and ``row_ptr`` their
    (n + 1,) CSR offsets. ``table`` and ``phi_m`` are updated in place,
    ``e`` comes back new. ``side`` ('ctx' or 'item') labels the spans.
    Each field layer is one ``kernels.mfsi_layer.field_layer`` call, which
    moves the table's and Φ's column f* and the caches q and r in place."""
    layers, scratch = field_layer_ops.prepare(_field_layers(design, hp), design.n_rows)

    def dim_body(f, carry):
        table, phi_m, e = carry
        with span("mfsi.moments"):
            psi_nnz = sweeps.take_col(other_psi, f)[other_nnz_ids]
            p2, q = segment_sum_sorted((alpha * psi_nnz * psi_nnz, alpha * e * psi_nnz),
                                       row_ptr)
        r_vec = phi_m @ sweeps.take_col(other_j, f)
        jff = other_j[f, f]
        table_col = sweeps.take_col(table, f)
        phi_col = sweeps.take_col(phi_m, f)
        for layer in layers:
            with span("mfsi.field_layer", side=side, dim=f, offset=layer.offset):
                dphi_rows = field_layer_ops.field_layer(
                    layer, table_col, phi_col, q, r_vec, p2, jff, scratch,
                    alpha0=hp.alpha0, l2=hp.l2)
            with span("mfsi.patch"):
                e = e + dphi_rows[rows_nnz] * psi_nnz
        return table, phi_m, e

    return sweeps.sweep_columns(hp.k, dim_body, (table, phi_m, e),
                                schedule=schedule, sweep_index=sweep_index)


def _side_sweep_padded(table, phi_m, other_psi, other_j, design: Design,
                       ids_pad, alpha_pad, e_pad, hp: MFSIHyperParams,
                       k_b: int):
    """Fused side sweep: one slab reduce a block feeds the field-level
    Newton steps of all k_b dimensions (q patched across block columns
    through the coupling slab P), one residual patch closes the block. The
    same fixed point as :func:`_side_sweep`. ``table``, ``phi_m`` and
    ``e_pad`` are updated in place."""
    n_rows = design.n_rows
    layers = _field_layers(design, hp)
    use_gather = sweeps.resolve_psi_dispatch(hp.psi_dispatch)
    ids_long = None if use_gather else ids_pad.long()

    def block_body(f0, kb, carry):
        table, phi_m, e_pad = carry
        blk = slice(f0, f0 + kb)
        if use_gather:
            psi_tab = other_psi[:, blk]                    # (n_other, kb)
            q_slab, p_slab = cd_slab_reduce_gather(psi_tab, ids_pad,
                                                   alpha_pad, e_pad)
        else:
            psi_blk = other_psi[:, blk][ids_long].movedim(-1, 1).contiguous()
            q_slab, p_slab = cd_slab_reduce(psi_blk, alpha_pad, e_pad)
        dphi_blk = torch.empty((n_rows, kb), dtype=torch.float32,
                               device=e_pad.device)
        for j in range(kb):
            f = f0 + j
            q = q_slab[:, j]
            p2 = p_slab[:, j, j]
            r_vec = phi_m @ other_j[:, f]
            jff = other_j[f, f]
            table_col, phi_col = table[:, f], phi_m[:, f]
            dphi_tot = torch.zeros((n_rows,), dtype=torch.float32,
                                   device=e_pad.device)
            for ids_g, xw, rows, vocab, offset, eta in layers:
                table_col, phi_col, q, r_vec, dphi_rows = _field_layer_update(
                    table_col, phi_col, q, r_vec, p2, jff, ids_g, xw, rows,
                    vocab, offset, hp, eta)
                dphi_tot = dphi_tot + dphi_rows
            table[:, f] = table_col
            phi_m[:, f] = phi_col
            if j + 1 < kb:  # Δe = Δφ_j·ψ_j moves later columns' q caches
                q_slab[:, j + 1:kb] += dphi_tot[:, None] * p_slab[:, j, j + 1:kb]
            dphi_blk[:, j] = dphi_tot
        if use_gather:
            e_pad = cd_resid_patch_gather(psi_tab, ids_pad, e_pad, dphi_blk)
        else:
            e_pad = cd_resid_patch(psi_blk, e_pad, dphi_blk)
        return table, phi_m, e_pad

    return sweeps.sweep_columns(hp.k, None, (table, phi_m, e_pad), block=k_b,
                                block_body=block_body)


def epoch(params: MFSIParams, x: Design, z: Design, data: Interactions,
          e: torch.Tensor, hp: MFSIHyperParams, schedule=None,
          sweep_index: int = 0,
          weights=None) -> Tuple[MFSIParams, torch.Tensor]:
    """One iCD epoch: context-feature sweep, then item-feature sweep, over
    the scheduled columns (``schedule=None`` = full pass). Returns new
    params and a new residual cache; ``params`` and ``e`` are left as they
    were. ``weights`` (optional, (nnz,) ctx-major) folds per-interaction
    confidence into α exactly. Runs under the spans ``mfsi.epoch`` (root),
    ``mfsi.moments`` (a dimension's gathered ψ column and its two sorted
    sums), ``mfsi.field_layer`` (``side``, ``dim``, ``offset``) and
    ``mfsi.patch`` (each residual patch), no-ops with no tracer installed."""
    data = with_weights(data, weights)
    w, h = params.w.clone(), params.h.clone()
    with span("mfsi.epoch"), full_fp32():
        phi_m = design_matmul(x, w)
        psi_m = design_matmul(z, h)
        j_i = gram(psi_m, implementation=hp.implementation)
        w, phi_m, e = _side_sweep(w, phi_m, psi_m, j_i, x, data.ctx,
                                  data.ctx_ptr, data.item, data.alpha, e, hp,
                                  schedule, sweep_index, side="ctx")
        j_c = gram(phi_m, implementation=hp.implementation)
        e_t = sweeps.to_item_major(e, data.t_perm)
        alpha_t = sweeps.to_item_major(data.alpha, data.t_perm)
        h, psi_m, e_t = _side_sweep(h, psi_m, phi_m, j_c, z, data.t_item,
                                    data.item_ptr, data.t_ctx, alpha_t, e_t,
                                    hp, schedule, sweep_index, side="item")
        e = sweeps.to_ctx_major(e_t, data.t_perm)
    return MFSIParams(w, h), e


def epoch_padded(params: MFSIParams, x: Design, z: Design,
                 pdata: PaddedInteractions, e_pad: torch.Tensor,
                 hp: MFSIHyperParams,
                 weights=None) -> Tuple[MFSIParams, torch.Tensor]:
    """Fused iCD epoch over the dual padded layout; carries the ctx-major
    padded residual grid, which it consumes (updated in place). The same
    sweep order and fixed point as :func:`epoch`. ``weights`` folds into
    both padded α grids (``mf_padded.reweight_padded``)."""
    if weights is not None:
        pdata = reweight_padded(pdata, weights)
    w, h = params.w.clone(), params.h.clone()
    k_b = sweeps.resolve_block_k(hp.block_k, hp.k)
    with full_fp32():
        phi_m = design_matmul(x, w)
        psi_m = design_matmul(z, h)
        j_i = gram(psi_m, implementation=hp.implementation)
        w, phi_m, e_pad = _side_sweep_padded(
            w, phi_m, psi_m, j_i, x, pdata.item_ids, pdata.alpha_c, e_pad,
            hp, k_b)
        e_pad_i = transfer_ctx_to_item(pdata, e_pad)
        j_c = gram(phi_m, implementation=hp.implementation)
        h, psi_m, e_pad_i = _side_sweep_padded(
            h, psi_m, phi_m, j_c, z, pdata.ctx_ids, pdata.alpha_i, e_pad_i,
            hp, k_b)
    return MFSIParams(w, h), transfer_item_to_ctx(pdata, e_pad_i)


def residuals(params: MFSIParams, x: Design, z: Design,
              data: Interactions) -> torch.Tensor:
    return sweeps.residuals_from_factors(phi(params, x), psi(params, z),
                                         data.ctx, data.item, data.y)


def residuals_padded(params: MFSIParams, x: Design, z: Design,
                     data: Interactions,
                     pdata: PaddedInteractions) -> torch.Tensor:
    """ŷ−ȳ on the ctx-major padded grid (0 on padding)."""
    return scatter_ctx_major(pdata, residuals(params, x, z, data))


def objective(params: MFSIParams, x: Design, z: Design, data: Interactions,
              hp: MFSIHyperParams) -> torch.Tensor:
    e = residuals(params, x, z, data)
    sq = torch.sum(params.w ** 2) + torch.sum(params.h ** 2)
    return implicit_objective(phi(params, x), psi(params, z), e, data,
                              hp.alpha0, hp.l2, sq)


def fit(params: MFSIParams, x: Design, z: Design, data: Interactions,
        hp: MFSIHyperParams, n_epochs: int, callback=None, schedule=None,
        weights=None) -> MFSIParams:
    """Run ``n_epochs`` flat epochs (as the reference's ``fit``);
    ``callback(epoch, params)`` after each."""
    e = residuals(params, x, z, data)
    for ep in range(n_epochs):
        params, e = epoch(params, x, z, data, e, hp, schedule, ep, weights)
        if callback is not None:
            callback(ep, params)
    return params
