"""iCD for Factorization Machines (paper §5.2.2; port of
``repro.core.models.fm``).

FM (eq. 26) over the concatenated feature vector x = (x_c, z_i):

    ŷ(x) = b + Σ_l x_l w̃_l + Σ_{l<l'} ⟨w_l, w_l'⟩ x_l x_l'

is (k+2)-separable (eqs. 27–31). The extended components are laid out as
aligned columns of Φe ∈ R^{C×(k+2)} and Ψe ∈ R^{I×(k+2)}:

    column f < k : φ_f = Σ_l x_l w_{l,f}          ψ_f = Σ_l z_l h_{l,f}
    column k     : φ_spec (ctx bias+linear+pairs)  ones
    column k+1   : ones                            ψ_spec (item side)

so ŷ = ⟨Φe(c), Ψe(i)⟩ exactly. Gradients are sparse (eqs. 32–33): a
context embedding w_{l*,f*} feeds component f* (value x) and the
ctx-special component (value x·g, g = φ_{f*} − x·w_{l*,f*}); FM stays
linear in every single coordinate, so full Newton steps (η=1) are exact.

Sweep order per side: all k embedding dims (field-vectorized as in MFSI,
through ``mfsi._field_layers``), then the linear weights, then (context
side only) the global bias. One-hot fields are exact; multi-hot fields use
damped Jacobi or the ``slot`` scan, as in MFSI.

Fused padded path (:func:`epoch_padded` over ``mf_padded``'s
``PaddedInteractions``, dispatched by ``hp.block_k``): per block of k_b
dimensions one slab reduce over the k_b ψ columns PLUS the ψ_spec column
(m = k_b + 1) yields every per-context cache the layer updates need — q/u
from Q, p2/p1/p0 from the moment slab P — and the cross-dimension coupling
that patches q for later block columns (Δe = Δφ_j·ψ_j + Δφ_s·ψ_spec ⇒
Δq_f = Δφ_j·P[·,j,f] + Δφ_s·P[·,s,f]); one rank-(k_b+1) residual patch
closes the block. Ψ routing (``hp.psi_dispatch``) as in MFSI: ``'gather'``
passes the slab ``[Ψe[:, blk] | ψ_spec]`` and the id grid to the kernels,
``'pregather'`` builds the (C, k_b+1, D_pad) tile first. The launch form
for each m is chosen inside ``kernels/cd_sweep/ops.py``.

Flat path (:func:`epoch`): each embedding field layer of a dimension is one
call of the hand-written field-layer kernels (``kernels/fm_layer``: the
four sums, the steps and the patches of Φe and the six caches in three
launches, four for a bag); the moments, the residual patch, the linear
layers and the bias stay PyTorch. On the padded path the embedding layers
are host loops of gathers and ``index_add_`` segment sums. Both run in full
fp32, and on CUDA both sum by atomics, so their last bits can change from
run to run. The flat epoch's sums over the log's sorted rows (p0, the
moments p2, p1, q, u, and u for the linear layers and the bias) go to
``segment.segment_sum_sorted``, a hand-written kernel on CUDA that sums in
a fixed order. ``e_pad`` is updated in place, as the
reference donates it. Where ``use_linear``/``use_bias`` is off, the epochs
return the parameter as it came (the reference returns ``None`` there).
:func:`params_from_numpy` carries the JAX package's ``FMParams`` over.
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
from repro_torch.core.models.mfsi import _field_layers
from repro_torch.kernels import resolve_device
from repro_torch.kernels.cd_sweep.ops import (
    cd_resid_patch,
    cd_resid_patch_gather,
    cd_slab_reduce,
    cd_slab_reduce_gather,
)
from repro_torch.kernels.fm_layer import ops as field_layer_ops
from repro_torch.obs.trace import span
from repro_torch.sparse.interactions import Interactions, with_weights
from repro_torch.sparse.segment import segment_sum, segment_sum_sorted

__all__ = ["FMParams", "FMHyperParams", "pad_interactions", "init",
           "params_from_numpy", "phi_ext", "psi_ext", "export_psi",
           "build_phi", "predict", "epoch", "epoch_padded", "residuals",
           "residuals_padded", "objective", "fit"]


class FMParams(NamedTuple):
    b: torch.Tensor       # () global bias
    w_lin: torch.Tensor   # (p,)  context linear weights  (paper w̃)
    w: torch.Tensor       # (p, k) context embeddings
    h_lin: torch.Tensor   # (p',) item linear weights     (paper h̃)
    h: torch.Tensor       # (p', k) item embeddings


@dataclasses.dataclass(frozen=True)
class FMHyperParams:
    k: int
    alpha0: float = 1.0
    l2: float = 0.1
    l2_lin: float = 0.1
    eta: float = 1.0
    use_linear: bool = True
    use_bias: bool = True
    multi_hot_mode: str = "jacobi"  # 'jacobi' | 'slot'
    jacobi_eta: float = 0.5
    implementation: str = "xla"  # Grams: 'xla' = torch.mm, 'pallas' = the
    #                              hand-written Gram kernel
    block_k: int = 0  # dims per fused slab-reduce/resid-patch dispatch on
    #                   the padded layout (epoch_padded): 0 = auto
    #                   (min(k, 8)), 1 = per-dimension baseline
    psi_dispatch: str = "gather"  # fused-path Ψ routing: 'gather' = the
    #                   kernels gather from the [Ψe[:, blk] | ψ_spec] slab,
    #                   'pregather' = a (C, k_b+1, D_pad) tile first


def init(p_ctx: int, p_item: int, k: int, *, generator: torch.Generator,
         sigma: float = 0.1) -> FMParams:
    """Zero bias and linear weights, N(0, σ²) embeddings, on the
    generator's device. To compare with the JAX package, build one set of
    numpy params and use :func:`params_from_numpy`."""
    dev = generator.device
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
    return FMParams(
        b=zeros(), w_lin=zeros(p_ctx),
        w=sigma * torch.randn((p_ctx, k), generator=generator, device=dev),
        h_lin=zeros(p_item),
        h=sigma * torch.randn((p_item, k), generator=generator, device=dev))


def params_from_numpy(b, w_lin, w, h_lin, h, *, device="cuda") -> FMParams:
    """The port's params from numpy arrays, e.g. ``np.asarray`` of the JAX
    package's ``FMParams``; on ``device``, the GPU unless the caller names
    the CPU."""
    device = resolve_device(device)
    return FMParams(*(torch.tensor(np.asarray(x, np.float32), device=device)
                      for x in (b, w_lin, w, h_lin, h)))


def _self_pairwise(design: Design, table: torch.Tensor,
                   phi_m: torch.Tensor) -> torch.Tensor:
    """Σ_{l<l'} ⟨w_l,w_l'⟩ x_l x_l' = ½ Σ_f (φ_f² − Σ_l x_l² w_{l,f}²).
    ‖w_l‖² is taken once a feature and gathered, not a (n, bag, k) tile."""
    wsq = torch.sum(table * table, dim=-1)                  # (p,)
    sq_sum = torch.zeros((design.n_rows,), dtype=torch.float32,
                         device=table.device)
    for field in design.fields:
        sq_sum = sq_sum + torch.sum(
            wsq[design.global_ids(field)] * field.weights * field.weights,
            dim=-1)
    return 0.5 * (torch.sum(phi_m * phi_m, dim=-1) - sq_sum)


def phi_ext(params: FMParams, x: Design, hp: FMHyperParams) -> torch.Tensor:
    """Φe (C, k+2): [Φ | φ_spec | 1]."""
    phi_m = design_matmul(x, params.w)
    spec = _self_pairwise(x, params.w, phi_m)
    if hp.use_linear:
        spec = spec + design_matmul(x, params.w_lin[:, None])[:, 0]
    if hp.use_bias:
        spec = spec + params.b
    ones = torch.ones((x.n_rows, 1), dtype=torch.float32, device=phi_m.device)
    return torch.cat([phi_m, spec[:, None], ones], dim=1)


def psi_ext(params: FMParams, z: Design, hp: FMHyperParams) -> torch.Tensor:
    """Ψe (I, k+2): [Ψ | 1 | ψ_spec]."""
    psi_m = design_matmul(z, params.h)
    spec = _self_pairwise(z, params.h, psi_m)
    if hp.use_linear:
        spec = spec + design_matmul(z, params.h_lin[:, None])[:, 0]
    ones = torch.ones((z.n_rows, 1), dtype=torch.float32, device=psi_m.device)
    return torch.cat([psi_m, ones, spec[:, None]], dim=1)


def predict(params: FMParams, x: Design, z: Design, ctx, item,
            hp: FMHyperParams) -> torch.Tensor:
    pe, se = phi_ext(params, x, hp), psi_ext(params, z, hp)
    ctx = torch.as_tensor(ctx, dtype=torch.long, device=pe.device)
    item = torch.as_tensor(item, dtype=torch.long, device=pe.device)
    return torch.sum(pe[ctx] * se[item], dim=-1)


def export_psi(params: FMParams, z: Design, hp: FMHyperParams) -> torch.Tensor:
    """ψ table for the retrieval engine: Ψe (n_items, k+2) with the FM
    column convention [Ψ | 1 | ψ_spec], aligned so ⟨Φe, Ψe⟩ = ŷ (eq. 26)
    with Φe's [Φ | φ_spec | 1] ordering."""
    return psi_ext(params, z, hp)


def build_phi(params: FMParams, x: Design, hp: FMHyperParams,
              rows=None) -> torch.Tensor:
    """φ rows for query contexts: Φe = [Φ | φ_spec | 1] (B, k+2) over
    ``rows`` of the context design ``x`` (rows are gathered before the
    products, so a query batch is O(B·k))."""
    return phi_ext(params, x if rows is None else take_rows(x, rows), hp)


def _embed_layer_update(table_col, self_ext, q, u, r_a, r_b, p2, p1, p0,
                        j_ff, j_fs, j_ss, ids_g, xw, rows, vocab, offset, f,
                        spec_col, hp, eta):
    """Vectorized Newton update of one embedding layer (field × dim f*) on
    the padded path; the flat path runs the same algebra in
    ``kernels/fm_layer`` (whose ``ref`` gives these bits in place).

    Patches the per-context caches and ``self_ext`` (in place) but NOT
    the residual cache: the caller applies (Δφ_{f*}, Δφ_spec) to the
    padded grid, one fused rank-(k_b+1) residual patch a block."""
    local = ids_g - offset
    w_rows = table_col[ids_g]                                # w_{l,f*} per entry
    g = self_ext[:, f][rows] - xw * w_rows
    lp = segment_sum(xw * (q[rows] + g * u[rows]), local, vocab)
    lpp = segment_sum(
        xw * xw * (p2[rows] + 2 * g * p1[rows] + g * g * p0[rows]), local, vocab)
    rp = segment_sum(xw * (r_a[rows] + g * r_b[rows]), local, vocab)
    rpp = segment_sum(xw * xw * (j_ff + 2 * g * j_fs + g * g * j_ss), local,
                      vocab)
    delta = sweeps.newton_delta(
        sweeps.NewtonParts(lp + hp.alpha0 * rp, lpp + hp.alpha0 * rpp),
        table_col[offset:offset + vocab], hp.l2, eta)
    table_col = table_col.clone()
    table_col[offset:offset + vocab] += delta

    d_entry = xw * delta[local]                              # per-entry Δ(xw)
    n_rows = self_ext.shape[0]
    dphi_f = segment_sum(d_entry, rows, n_rows)              # Δφ_{f*}
    dphi_s = segment_sum(d_entry * g, rows, n_rows)          # Δφ_spec
    self_ext[:, f] += dphi_f
    self_ext[:, spec_col] += dphi_s
    q = q + dphi_f * p2 + dphi_s * p1
    u = u + dphi_f * p1 + dphi_s * p0
    r_a = r_a + dphi_f * j_ff + dphi_s * j_fs
    r_b = r_b + dphi_f * j_fs + dphi_s * j_ss
    return table_col, q, u, r_a, r_b, dphi_f, dphi_s


def _linear_layer_update(lin, self_ext, u, r_b, p0, j_ss, ids_g, xw, rows,
                         vocab, offset, spec_col, hp, eta):
    """Newton step of one linear-weight layer; ``self_ext`` patched in
    place, the e patch left to the caller."""
    n_rows = self_ext.shape[0]
    local = ids_g - offset
    lp = segment_sum(xw * u[rows], local, vocab)
    lpp = segment_sum(xw * xw * p0[rows], local, vocab)
    rp = segment_sum(xw * r_b[rows], local, vocab)
    rpp = j_ss * segment_sum(xw * xw, local, vocab)
    delta = sweeps.newton_delta(
        sweeps.NewtonParts(lp + hp.alpha0 * rp, lpp + hp.alpha0 * rpp),
        lin[offset:offset + vocab], hp.l2_lin, eta)
    lin = lin.clone()
    lin[offset:offset + vocab] += delta
    dspec = segment_sum(xw * delta[local], rows, n_rows)
    self_ext[:, spec_col] += dspec
    return lin, u + dspec * p0, r_b + dspec * j_ss, dspec


def _bias_update(bias, self_ext, u, r_b, p0, j_ss, n_rows, spec_col, hp):
    """Global-bias Newton step; ``self_ext`` patched in place, the e patch
    left to the caller."""
    lp = torch.sum(u)
    lpp = torch.sum(p0)
    rp = torch.sum(r_b)
    rpp = j_ss * n_rows
    delta = sweeps.newton_delta(
        sweeps.NewtonParts(lp + hp.alpha0 * rp, lpp + hp.alpha0 * rpp), bias,
        0.0, hp.eta)  # the bias carries no L2 term
    self_ext[:, spec_col] += delta
    return bias + delta, delta


def _linear_and_bias(lin, bias, self_ext, other_j, layers, e, u_of, patch,
                     p0, j_ss, n_rows, spec_col, hp):
    """The linear-weight layers, then the global bias, of one side.
    ``u_of(e)`` is Σ α·e·ψ_spec a row and ``patch(e, Δspec)`` returns e
    with Δspec·ψ_spec added, per row (a (n,) Δspec) or to all rows (a
    scalar one). Returns (lin, bias, e)."""
    side = "ctx" if spec_col == hp.k else "item"
    if hp.use_linear and lin is not None:
        u = u_of(e)
        r_b = self_ext @ other_j[:, spec_col]
        for ids_g, xw, rows, vocab, offset, eta in layers:
            with span("fm.field_layer", side=side, dim="linear", offset=offset):
                lin, u, r_b, dspec = _linear_layer_update(
                    lin, self_ext, u, r_b, p0, j_ss, ids_g, xw, rows, vocab,
                    offset, spec_col, hp, eta)
            with span("fm.patch"):
                e = patch(e, dspec)
    if hp.use_bias and bias is not None:
        with span("fm.bias"):
            r_b = self_ext @ other_j[:, spec_col]
            bias, delta = _bias_update(bias, self_ext, u_of(e), r_b, p0, j_ss,
                                       n_rows, spec_col, hp)
        with span("fm.patch"):
            e = patch(e, delta)
    return lin, bias, e


def _side_sweep(table, lin, bias, self_ext, other_ext, other_j,
                design: Design, rows_nnz, row_ptr, other_nnz_ids, alpha, e,
                spec_col, hp: FMHyperParams, schedule=None,
                sweep_index: int = 0):
    """One side's sweep over the flat observations: dims, linear weights,
    bias. ``rows_nnz`` are the entries' rows, sorted, and ``row_ptr`` their
    (n + 1,) CSR offsets. ``table`` and ``self_ext`` are updated in place;
    returns (table, lin, bias, self_ext, e) with a new ``e``. Each
    embedding field layer is one ``kernels.fm_layer.field_layer`` call,
    which moves the table's column f*, Φe's columns f* and spec and the
    caches q, u, r_a, r_b in place."""
    n_rows = design.n_rows
    side = "ctx" if spec_col == hp.k else "item"
    layers = _field_layers(design, hp)
    embed_layers, scratch = field_layer_ops.prepare(layers, n_rows)
    o_spec_nnz = other_ext[:, spec_col][other_nnz_ids]     # ones, kept generic
    p0, = segment_sum_sorted((alpha * o_spec_nnz * o_spec_nnz,), row_ptr)
    j_ss = other_j[spec_col, spec_col]

    def dim_body(f, carry):
        table, self_ext, e = carry
        with span("fm.moments"):
            other_f_nnz = other_ext[:, f][other_nnz_ids]
            a_f, a_e = alpha * other_f_nnz, alpha * e  # α·ψ_f and α·e, each once
            p2, p1, q, u = segment_sum_sorted(
                (a_f * other_f_nnz, a_f * o_spec_nnz, a_e * other_f_nnz,
                 a_e * o_spec_nnz), row_ptr)
        caches = field_layer_ops.Caches(
            q, u, self_ext @ other_j[:, f], self_ext @ other_j[:, spec_col], p2, p1, p0)
        j = (other_j[f, f], other_j[f, spec_col], j_ss)
        table_col = sweeps.take_col(table, f)
        phi_f, phi_s = sweeps.take_col(self_ext, f), sweeps.take_col(self_ext, spec_col)
        for layer in embed_layers:
            with span("fm.field_layer", side=side, dim=f, offset=layer.offset):
                dphi_f, dphi_s = field_layer_ops.field_layer(
                    layer, table_col, phi_f, phi_s, caches, j, scratch,
                    alpha0=hp.alpha0, l2=hp.l2)
            with span("fm.patch"):
                e = e + dphi_f[rows_nnz] * other_f_nnz + dphi_s[rows_nnz] * o_spec_nnz
        return table, self_ext, e

    table, self_ext, e = sweeps.sweep_columns(
        hp.k, dim_body, (table, self_ext, e), schedule=schedule,
        sweep_index=sweep_index)

    lin, bias, e = _linear_and_bias(
        lin, bias, self_ext, other_j, layers, e,
        lambda e: segment_sum_sorted((alpha * e * o_spec_nnz,), row_ptr)[0],
        lambda e, d: e + (d[rows_nnz] if d.dim() else d) * o_spec_nnz,
        p0, j_ss, n_rows, spec_col, hp)
    return table, lin, bias, self_ext, e


def _side_sweep_padded(table, lin, bias, self_ext, other_ext, other_j,
                       design: Design, ids_pad, alpha_pad, e_pad, spec_col,
                       hp: FMHyperParams, k_b: int):
    """Fused FM side sweep on the padded grid: per block one slab reduce
    over [ψ_{f0..f0+k_b} | ψ_spec] feeds all per-context caches (q, u,
    p2, p1 and the cross-dim coupling), the field-level Newton steps run
    in PyTorch, one rank-(k_b+1) residual patch closes the block. The same
    fixed point as :func:`_side_sweep`. ``table``, ``self_ext`` and
    ``e_pad`` are updated in place."""
    n_rows = design.n_rows
    layers = _field_layers(design, hp)
    ids_long = ids_pad.long()
    psi_spec_pad = other_ext[:, spec_col][ids_long]          # (n, d_pad)
    p0 = torch.sum(alpha_pad * psi_spec_pad * psi_spec_pad, dim=1)
    j_ss = other_j[spec_col, spec_col]
    use_gather = sweeps.resolve_psi_dispatch(hp.psi_dispatch)
    spec = other_ext[:, spec_col:spec_col + 1]

    def block_body(f0, kb, carry):
        table, self_ext, e_pad = carry
        blk = slice(f0, f0 + kb)
        if use_gather:
            # ψ slab [Ψe[:, blk] | ψ_spec] (n_other, kb+1): the kernels gather
            psi_tab = torch.cat([other_ext[:, blk], spec], dim=1)
            q_slab, p_slab = cd_slab_reduce_gather(psi_tab, ids_pad,
                                                   alpha_pad, e_pad)
        else:
            psi_blk = torch.cat([other_ext[:, blk][ids_long].movedim(-1, 1),
                                 psi_spec_pad[:, None, :]], dim=1)
            q_slab, p_slab = cd_slab_reduce(psi_blk, alpha_pad, e_pad)
        u = q_slab[:, -1]
        dphi_blk = torch.empty((n_rows, kb + 1), dtype=torch.float32,
                               device=e_pad.device)
        dphi_s_tot = torch.zeros((n_rows,), dtype=torch.float32,
                                 device=e_pad.device)
        for j in range(kb):
            f = f0 + j
            q = q_slab[:, j]
            p2, p1 = p_slab[:, j, j], p_slab[:, j, -1]
            r_a = self_ext @ other_j[:, f]
            r_b = self_ext @ other_j[:, spec_col]
            j_ff, j_fs = other_j[f, f], other_j[f, spec_col]
            table_col = table[:, f]
            dphi_f_tot = torch.zeros((n_rows,), dtype=torch.float32,
                                     device=e_pad.device)
            dphi_s_dim = torch.zeros_like(dphi_f_tot)
            for ids_g, xw, rows, vocab, offset, eta in layers:
                table_col, q, u, r_a, r_b, dphi_f, dphi_s = _embed_layer_update(
                    table_col, self_ext, q, u, r_a, r_b, p2, p1, p0, j_ff,
                    j_fs, j_ss, ids_g, xw, rows, vocab, offset, f, spec_col,
                    hp, eta)
                dphi_f_tot = dphi_f_tot + dphi_f
                dphi_s_dim = dphi_s_dim + dphi_s
            table[:, f] = table_col
            if j + 1 < kb:  # Δe = Δφ_j·ψ_j + Δφ_s·ψ_spec moves later q's
                q_slab[:, j + 1:kb] += (dphi_f_tot[:, None] * p_slab[:, j, j + 1:kb]
                                        + dphi_s_dim[:, None] * p_slab[:, -1, j + 1:kb])
            dphi_blk[:, j] = dphi_f_tot
            dphi_s_tot = dphi_s_tot + dphi_s_dim
        dphi_blk[:, kb] = dphi_s_tot
        if use_gather:
            e_pad = cd_resid_patch_gather(psi_tab, ids_pad, e_pad, dphi_blk)
        else:
            e_pad = cd_resid_patch(psi_blk, e_pad, dphi_blk)
        return table, self_ext, e_pad

    table, self_ext, e_pad = sweeps.sweep_columns(
        hp.k, None, (table, self_ext, e_pad), block=k_b, block_body=block_body)

    lin, bias, e_pad = _linear_and_bias(
        lin, bias, self_ext, other_j, layers, e_pad,
        lambda e: torch.sum(alpha_pad * e * psi_spec_pad, dim=1),
        lambda e, d: e.add_((d[:, None] if d.dim() else d) * psi_spec_pad),
        p0, j_ss, n_rows, spec_col, hp)
    return table, lin, bias, self_ext, e_pad


def _trained(params: FMParams, hp: FMHyperParams):
    """The epoch's own copies: (b, w_lin, w, h_lin, h), with the linear
    weights and the bias left out (None) where ``hp`` switches them off."""
    return (params.b.clone() if hp.use_bias else None,
            params.w_lin.clone() if hp.use_linear else None,
            params.w.clone(),
            params.h_lin.clone() if hp.use_linear else None,
            params.h.clone())


def _params(params: FMParams, b, w_lin, w, h_lin, h) -> FMParams:
    return FMParams(params.b if b is None else b,
                    params.w_lin if w_lin is None else w_lin, w,
                    params.h_lin if h_lin is None else h_lin, h)


def epoch(params: FMParams, x: Design, z: Design, data: Interactions,
          e: torch.Tensor, hp: FMHyperParams, schedule=None,
          sweep_index: int = 0,
          weights=None) -> Tuple[FMParams, torch.Tensor]:
    """One iCD epoch: context side (dims, linear, bias), then item side
    (dims, linear), over the scheduled columns. Returns new params and a
    new residual cache; ``params`` and ``e`` are left as they were.
    ``weights`` (optional, (nnz,) ctx-major) folds into α exactly."""
    data = with_weights(data, weights)
    b, w_lin, w, h_lin, h = _trained(params, hp)
    with span("fm.epoch"), full_fp32():
        pe = phi_ext(params, x, hp)
        se = psi_ext(params, z, hp)
        j_i = gram(se, implementation=hp.implementation)
        w, w_lin, b, pe, e = _side_sweep(
            w, w_lin, b, pe, se, j_i, x, data.ctx, data.ctx_ptr, data.item,
            data.alpha, e, spec_col=hp.k, hp=hp, schedule=schedule,
            sweep_index=sweep_index)
        j_c = gram(pe, implementation=hp.implementation)
        e_t = sweeps.to_item_major(e, data.t_perm)
        alpha_t = sweeps.to_item_major(data.alpha, data.t_perm)
        h, h_lin, _, se, e_t = _side_sweep(
            h, h_lin, None, se, pe, j_c, z, data.t_item, data.item_ptr,
            data.t_ctx, alpha_t, e_t, spec_col=hp.k + 1, hp=hp, schedule=schedule,
            sweep_index=sweep_index)
        e = sweeps.to_ctx_major(e_t, data.t_perm)
    return _params(params, b, w_lin, w, h_lin, h), e


def epoch_padded(params: FMParams, x: Design, z: Design,
                 pdata: PaddedInteractions, e_pad: torch.Tensor,
                 hp: FMHyperParams,
                 weights=None) -> Tuple[FMParams, torch.Tensor]:
    """Fused iCD epoch over the dual padded layout; carries the ctx-major
    padded residual grid, which it consumes (updated in place). The same
    sweep order and fixed point as :func:`epoch`. ``weights`` folds into
    both padded α grids."""
    if weights is not None:
        pdata = reweight_padded(pdata, weights)
    b, w_lin, w, h_lin, h = _trained(params, hp)
    k_b = sweeps.resolve_block_k(hp.block_k, hp.k)
    with full_fp32():
        pe = phi_ext(params, x, hp)
        se = psi_ext(params, z, hp)
        j_i = gram(se, implementation=hp.implementation)
        w, w_lin, b, pe, e_pad = _side_sweep_padded(
            w, w_lin, b, pe, se, j_i, x, pdata.item_ids, pdata.alpha_c,
            e_pad, spec_col=hp.k, hp=hp, k_b=k_b)
        e_pad_i = transfer_ctx_to_item(pdata, e_pad)
        j_c = gram(pe, implementation=hp.implementation)
        h, h_lin, _, se, e_pad_i = _side_sweep_padded(
            h, h_lin, None, se, pe, j_c, z, pdata.ctx_ids, pdata.alpha_i,
            e_pad_i, spec_col=hp.k + 1, hp=hp, k_b=k_b)
    return (_params(params, b, w_lin, w, h_lin, h),
            transfer_item_to_ctx(pdata, e_pad_i))


def residuals(params: FMParams, x: Design, z: Design, data: Interactions,
              hp: FMHyperParams) -> torch.Tensor:
    return sweeps.residuals_from_factors(
        phi_ext(params, x, hp), psi_ext(params, z, hp), data.ctx, data.item,
        data.y)


def residuals_padded(params: FMParams, x: Design, z: Design,
                     data: Interactions, pdata: PaddedInteractions,
                     hp: FMHyperParams) -> torch.Tensor:
    """ŷ−ȳ on the ctx-major padded grid (0 on padding)."""
    return scatter_ctx_major(pdata, residuals(params, x, z, data, hp))


def objective(params: FMParams, x: Design, z: Design, data: Interactions,
              hp: FMHyperParams) -> torch.Tensor:
    e = residuals(params, x, z, data, hp)
    sq = torch.sum(params.w ** 2) + torch.sum(params.h ** 2)
    sq_lin = torch.sum(params.w_lin ** 2) + torch.sum(params.h_lin ** 2)
    pe, se = phi_ext(params, x, hp), psi_ext(params, z, hp)
    # φ_spec/ψ_spec are model components, not free parameters: only the L2
    # on true parameters enters; the implicit R covers the rest
    return implicit_objective(pe, se, e, data, hp.alpha0, 0.0,
                              torch.zeros((), device=e.device)) \
        + hp.l2 * sq + hp.l2_lin * sq_lin


def fit(params: FMParams, x: Design, z: Design, data: Interactions,
        hp: FMHyperParams, n_epochs: int, callback=None,
        refresh_residuals: bool = True, schedule=None,
        weights=None) -> FMParams:
    """Run ``n_epochs`` flat epochs, the residual cache recomputed before
    each after the first (it bounds the multi-hot drift);
    ``callback(epoch, params)`` after each."""
    e = residuals(params, x, z, data, hp)
    for ep in range(n_epochs):
        if refresh_residuals and ep > 0:
            e = residuals(params, x, z, data, hp)
        params, e = epoch(params, x, z, data, e, hp, schedule, ep, weights)
        if callback is not None:
            callback(ep, params)
    return params
