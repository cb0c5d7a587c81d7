"""The port's FM (``repro_torch.core.models.fm``) and the icd-fm config
held against the JAX package from the same numpy inputs: the (k+2)-
separability identity, the Newton trajectory (against the JAX epoch and
against an autodiff Newton oracle over the dense objective, computed in
torch), gather against pregather, fused against per-column, weights, fit
and the serving surface.

On the CPU the port's kernel wrappers run their plain versions and the JAX
package runs its Pallas kernels in interpret mode (toy sizes). Tolerances
are the reference's own (``tests/test_icd_fm.py``): the identity to
rtol/atol 1e-5; the Newton trajectory to rtol 5e-4 / atol 5e-5; gather
against pregather to rtol 5e-5 / atol 1e-5; fused against per-column to
rtol 5e-4 / atol 1e-5 and the padded residual cache to rtol 5e-4 / atol
5e-5; the residual cache against a recompute to rtol 2e-4 / atol 2e-5.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core import design as jdesign
from repro.core.models import fm as jfm
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import design
from repro_torch.core.models import fm
from repro_torch.sparse.interactions import build_interactions
from repro_torch.sparse.segment import segment_sum

torch.set_num_threads(1)

IDENT = 1e-5
TRAJ_RTOL, TRAJ_ATOL = 5e-4, 5e-5
ROUTE_RTOL, ROUTE_ATOL = 5e-5, 1e-5
FUSED_RTOL, FUSED_ATOL, E_ATOL = 5e-4, 1e-5, 5e-5
CACHE_RTOL, CACHE_ATOL = 2e-4, 2e-5


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _problem(seed=0, n_ctx=8, n_items=6, nnz=20, alpha0=0.3, with_bag=False,
             k=3, lin=True):
    """tests/test_icd_fm.py's problem in both packages, with numpy start
    params (a non-zero bias and linear weights when ``lin``)."""
    rng = np.random.default_rng(seed)
    fields = [dict(name="country", ids=rng.integers(0, 3, n_ctx), vocab=3),
              dict(name="age", ids=rng.integers(0, 2, n_ctx), vocab=2)]
    if with_bag:
        fields.append(dict(
            name="hist", vocab=5, weights=np.full((n_ctx, 2), 0.5, np.float32),
            ids=np.stack([rng.choice(5, 2, replace=False) for _ in range(n_ctx)])))
    items = [dict(name="item_id", ids=np.arange(n_items), vocab=n_items)]
    pairs = rng.choice(n_ctx * n_items, size=nnz, replace=False)
    ctx, item = pairs // n_items, pairs % n_items
    y = rng.integers(1, 4, size=nnz).astype(np.float64)
    alpha = alpha0 + 1.0 + rng.random(nnz)
    jx, jz = jdesign.make_design(fields, n_ctx), jdesign.make_design(items, n_items)
    arrays = (np.float32(0.2 if lin else 0.0),
              (0.01 * np.arange(jx.p) if lin else np.zeros(jx.p)).astype(np.float32),
              (0.1 * rng.normal(size=(jx.p, k))).astype(np.float32),
              (0.05 * rng.normal(size=jz.p) if lin else np.zeros(jz.p)).astype(np.float32),
              (0.1 * rng.normal(size=(jz.p, k))).astype(np.float32))
    return dict(
        jx=jx, jz=jz, arrays=arrays, ctx=ctx, item=item, y=y, alpha=alpha,
        tx=design.make_design(fields, n_ctx, device="cpu"),
        tz=design.make_design(items, n_items, device="cpu"),
        jd=jbuild(ctx, item, y, alpha, n_ctx, n_items, alpha0=alpha0),
        td=build_interactions(ctx, item, y, alpha, n_ctx, n_items,
                              alpha0=alpha0, device="cpu"),
        jp=jfm.FMParams(*map(jnp.asarray, arrays)),
        tp=fm.params_from_numpy(*arrays, device="cpu"))


def _close_params(got, want, rtol, atol, fields=fm.FMParams._fields):
    for f in fields:
        _close(getattr(got, f), getattr(want, f), rtol, atol)


def _dense_scores(p, xd, zd, hp):
    """Direct eq. (26) on materialized features (torch)."""
    phi, psi = xd @ p.w, zd @ p.h
    ctx_pair = 0.5 * ((phi ** 2).sum(1) - ((xd ** 2) @ (p.w ** 2)).sum(1))
    item_pair = 0.5 * ((psi ** 2).sum(1) - ((zd ** 2) @ (p.h ** 2)).sum(1))
    s = phi @ psi.T + ctx_pair[:, None] + item_pair[None, :]
    if hp.use_linear:
        s = s + (xd @ p.w_lin)[:, None] + (zd @ p.h_lin)[None, :]
    if hp.use_bias:
        s = s + p.b
    return s


# ------------------------------------------------------------ the config ---
def test_icd_fm_config_matches_reference():
    for got, want in ((get_config("icd-fm"), jget_config("icd-fm")),
                      (get_smoke_config("icd-fm"), jget_smoke_config("icd-fm"))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = get_config("icd-fm")
    assert (cfg.n_ctx, cfg.n_items, cfg.k, cfg.p_ctx, cfg.p_item) == \
        (200_000, 68_000, 128, 336_091, 68_000)
    assert get_config("icd-mf").p_ctx == jget_config("icd-mf").p_ctx == 0


# -------------------------------------------------- the identity, exports ---
def test_separability_identity_and_exports_match_reference():
    pb = _problem(seed=1, with_bag=True)
    hp, jhp = fm.FMHyperParams(k=3, alpha0=0.3), jfm.FMHyperParams(k=3, alpha0=0.3)
    tp = pb["tp"]
    sep = fm.phi_ext(tp, pb["tx"], hp) @ fm.psi_ext(tp, pb["tz"], hp).T
    direct = _dense_scores(tp, design.to_dense(pb["tx"]),
                           design.to_dense(pb["tz"]), hp)
    _close(sep, direct, IDENT, IDENT)
    _close(fm.phi_ext(tp, pb["tx"], hp), jfm.phi_ext(pb["jp"], pb["jx"], jhp),
           IDENT, IDENT)
    _close(fm.export_psi(tp, pb["tz"], hp),
           jfm.export_psi(pb["jp"], pb["jz"], jhp), IDENT, IDENT)
    rows = np.array([5, 0, 7, 5], np.int32)
    _close(fm.build_phi(tp, pb["tx"], hp, torch.as_tensor(rows)),
           jfm.build_phi(pb["jp"], pb["jx"], jhp, jnp.asarray(rows)), IDENT, IDENT)
    ctx, item = np.array([0, 3, 7]), np.array([5, 0, 2])
    _close(fm.predict(tp, pb["tx"], pb["tz"], ctx, item, hp),
           jfm.predict(pb["jp"], pb["jx"], pb["jz"], jnp.asarray(ctx),
                       jnp.asarray(item), jhp), IDENT, IDENT)
    for use_linear, use_bias in ((False, False), (True, False)):
        hp2 = dataclasses.replace(hp, use_linear=use_linear, use_bias=use_bias)
        jhp2 = dataclasses.replace(jhp, use_linear=use_linear, use_bias=use_bias)
        _close(fm.phi_ext(tp, pb["tx"], hp2),
               jfm.phi_ext(pb["jp"], pb["jx"], jhp2), IDENT, IDENT)


# --------------------------------------------------- the Newton trajectory ---
def _newton_layer(loss_fn, params, path, mask, eta):
    """Parallel Newton step on the masked coordinates of params[path], the
    diagonal of the Hessian by autodiff."""
    theta = getattr(params, path).detach()
    flat = theta.reshape(-1)

    def f(t):
        return loss_fn(params._replace(**{path: t.reshape(theta.shape)}))

    g = torch.autograd.functional.jacobian(f, flat)
    diag = torch.diagonal(torch.autograd.functional.hessian(f, flat))
    step = torch.where(mask.reshape(-1), -eta * g / torch.clamp(diag, min=1e-12),
                       torch.zeros_like(g))
    return params._replace(**{path: (flat + step).reshape(theta.shape)})


@pytest.mark.parametrize("use_linear,use_bias", [(False, False), (True, True)])
def test_newton_trajectory_matches_autodiff_and_reference(use_linear, use_bias):
    pb = _problem(seed=2, k=2, lin=False)
    k = 2
    kw = dict(k=k, alpha0=0.3, l2=0.05, l2_lin=0.02, use_linear=use_linear,
              use_bias=use_bias)
    hp, jhp = fm.FMHyperParams(**kw), jfm.FMHyperParams(**kw)
    x, z, tp = pb["tx"], pb["tz"], pb["tp"]
    xd, zd = design.to_dense(x).double(), design.to_dense(z).double()
    y_dense = torch.zeros((x.n_rows, z.n_rows), dtype=torch.float64)
    a_dense = torch.full_like(y_dense, 0.3)
    y_dense[pb["ctx"], pb["item"]] = torch.as_tensor(pb["y"])
    a_dense[pb["ctx"], pb["item"]] = torch.as_tensor(pb["alpha"])

    def dense_loss(p):
        s = _dense_scores(p, xd, zd, hp)
        reg = hp.l2 * ((p.w ** 2).sum() + (p.h ** 2).sum())
        reg = reg + hp.l2_lin * ((p.w_lin ** 2).sum() + (p.h_lin ** 2).sum())
        return (a_dense * (s - y_dense) ** 2).sum() + reg

    oracle = fm.FMParams(*(t.double() for t in tp))
    for path, design_, lin_path in (("w", x, "w_lin"), ("h", z, "h_lin")):
        p = design_.p
        for f in range(k):
            for fld in design_.fields:
                m = torch.zeros((p, k), dtype=torch.bool)
                m[fld.offset:fld.offset + fld.vocab, f] = True
                oracle = _newton_layer(dense_loss, oracle, path, m, hp.eta)
        if use_linear:
            for fld in design_.fields:
                m = torch.zeros((p,), dtype=torch.bool)
                m[fld.offset:fld.offset + fld.vocab] = True
                oracle = _newton_layer(dense_loss, oracle, lin_path, m, hp.eta)
        if use_bias and path == "w":
            oracle = _newton_layer(dense_loss, oracle, "b",
                                   torch.tensor(True), hp.eta)

    got, _ = fm.epoch(tp, x, z, pb["td"], fm.residuals(tp, x, z, pb["td"], hp), hp)
    jgot, _ = jfm.epoch(pb["jp"], pb["jx"], pb["jz"], pb["jd"],
                        jfm.residuals(pb["jp"], pb["jx"], pb["jz"], pb["jd"], jhp),
                        jhp)
    trained = ("w", "h") + (("w_lin", "h_lin") if use_linear else ()) + \
        (("b",) if use_bias else ())
    _close_params(got, fm.FMParams(*(t.float() for t in oracle)), TRAJ_RTOL,
                  TRAJ_ATOL, trained)
    _close_params(got, jgot, TRAJ_RTOL, TRAJ_ATOL, trained)
    # what the epoch does not train comes back as it went in
    for f in set(fm.FMParams._fields) - set(trained):
        assert torch.equal(getattr(got, f), getattr(tp, f))


def test_objective_fit_and_cache_match_reference():
    pb = _problem(seed=3, n_ctx=12, n_items=9, nnz=30, with_bag=True)
    kw = dict(k=3, alpha0=0.3, l2=0.05)
    hp, jhp = fm.FMHyperParams(**kw), jfm.FMHyperParams(**kw)
    args, jargs = (pb["tx"], pb["tz"], pb["td"]), (pb["jx"], pb["jz"], pb["jd"])
    start = float(fm.objective(pb["tp"], *args, hp))
    _close(start, jfm.objective(pb["jp"], *jargs, jhp), 1e-6, 0)
    seen = []
    tp = fm.fit(pb["tp"], *args, hp, 3, callback=lambda ep, p: seen.append(ep))
    jp = jfm.fit(pb["jp"], *jargs, jhp, 3)
    assert seen == [0, 1, 2]
    _close_params(tp, jp, FUSED_RTOL, FUSED_ATOL)
    end = float(fm.objective(tp, *args, hp))
    _close(end, jfm.objective(jp, *jargs, jhp), 1e-5, 0)
    assert end < 0.8 * start
    # the one-hot residual cache stays consistent with a recompute
    pb = _problem(seed=4, k=2)
    hp = fm.FMHyperParams(k=2, alpha0=0.3, l2=0.05)
    p, e = pb["tp"], fm.residuals(pb["tp"], pb["tx"], pb["tz"], pb["td"], hp)
    for _ in range(2):
        p, e = fm.epoch(p, pb["tx"], pb["tz"], pb["td"], e, hp)
    _close(e, fm.residuals(p, pb["tx"], pb["tz"], pb["td"], hp), CACHE_RTOL,
           CACHE_ATOL)


# ------------------------------------------------------ the fused epochs ---
@functools.lru_cache(maxsize=None)
def _reference_flat(with_bag, mode, k):
    """Two JAX flat epochs on the fused tests' problem (cached: the
    reference's flat epoch does not read block_k)."""
    pb = _problem(seed=6, with_bag=with_bag, k=k)
    jhp = jfm.FMHyperParams(k=k, alpha0=0.3, l2=0.05, multi_hot_mode=mode)
    jp, je = pb["jp"], jfm.residuals(pb["jp"], pb["jx"], pb["jz"], pb["jd"], jhp)
    for _ in range(2):
        jp, je = jfm.epoch(jp, pb["jx"], pb["jz"], pb["jd"], je, jhp)
    return jp, np.asarray(je)


@pytest.mark.parametrize("block_k", [1, 3, 8])
@pytest.mark.parametrize("with_bag,mode", [(False, "jacobi"), (True, "jacobi"),
                                           (True, "slot")])
def test_fused_matches_per_column_and_reference(with_bag, mode, block_k):
    """epoch_padded (slab reduce over [ψ_blk | ψ_spec] + rank-(k_b+1)
    residual patch) against the per-dimension epoch of the port and of the
    JAX package: k = 9, so block_k 8 leaves a 1-column tail."""
    k = 9
    pb = _problem(seed=6, with_bag=with_bag, k=k)
    hp = fm.FMHyperParams(k=k, alpha0=0.3, l2=0.05, multi_hot_mode=mode,
                          block_k=block_k)
    x, z, d = pb["tx"], pb["tz"], pb["td"]
    pdata = fm.pad_interactions(d)
    ref, got = pb["tp"], pb["tp"]
    e = fm.residuals(ref, x, z, d, hp)
    e_pad = fm.residuals_padded(got, x, z, d, pdata, hp)
    for _ in range(2):
        ref, e = fm.epoch(ref, x, z, d, e, hp)
        got, e_pad = fm.epoch_padded(got, x, z, pdata, e_pad, hp)
    jp, je = _reference_flat(with_bag, mode, k)
    _close_params(got, ref, FUSED_RTOL, FUSED_ATOL)
    _close_params(got, jp, FUSED_RTOL, FUSED_ATOL)
    _close_params(ref, jp, FUSED_RTOL, FUSED_ATOL)
    _close(e_pad[pdata.c_rows, pdata.c_cols], e, FUSED_RTOL, E_ATOL)
    _close(e, je, FUSED_RTOL, E_ATOL)
    # a bag's parallel step moves features that share a row, whose pairwise
    # cross terms Δw_l·Δw_l' the linear cache patch leaves out (FM's
    # documented multi-hot drift, in the reference as here): only a one-hot
    # design keeps the cache equal to a recompute
    if not with_bag:
        _close(e_pad, fm.residuals_padded(got, x, z, d, pdata, hp),
               CACHE_RTOL, CACHE_ATOL)


def test_gather_matches_pregather_and_reference():
    """Both Ψ routings of the port, and the JAX package's gather routing
    (its Pallas kernels in interpret mode): non-divisible k = 3 / block_k
    = 2, linear weights and bias included."""
    pb = _problem(seed=9, with_bag=True)
    base = dict(k=3, alpha0=0.3, l2=0.05, block_k=2)
    pdata = fm.pad_interactions(pb["td"])
    finals = {}
    for disp in ("gather", "pregather"):
        hp = fm.FMHyperParams(**base, psi_dispatch=disp)
        p = pb["tp"]
        e_pad = fm.residuals_padded(p, pb["tx"], pb["tz"], pb["td"], pdata, hp)
        for _ in range(2):
            p, e_pad = fm.epoch_padded(p, pb["tx"], pb["tz"], pdata, e_pad, hp)
        finals[disp] = (p, e_pad)
    _close_params(finals["gather"][0], finals["pregather"][0], ROUTE_RTOL,
                  ROUTE_ATOL)
    _close(finals["gather"][1], finals["pregather"][1], ROUTE_RTOL, ROUTE_ATOL)
    jhp = jfm.FMHyperParams(**base)
    jpd = jfm.pad_interactions(pb["jd"])
    jp = pb["jp"]
    je = jfm.residuals_padded(jp, pb["jx"], pb["jz"], pb["jd"], jpd, jhp)
    for _ in range(2):
        jp, je = jfm.epoch_padded(jp, pb["jx"], pb["jz"], jpd, je, jhp)
    _close_params(finals["gather"][0], jp, ROUTE_RTOL, ROUTE_ATOL)
    _close(finals["gather"][1], je, ROUTE_RTOL, ROUTE_ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_weights_none_is_ones_and_weighted_matches_reference(fused):
    pb = _problem(seed=8, with_bag=True)
    hp = fm.FMHyperParams(k=3, alpha0=0.3, l2=0.05, block_k=2)
    wts = (0.5 + np.random.default_rng(9).random(pb["td"].nnz)).astype(np.float32)
    x, z, d = pb["tx"], pb["tz"], pb["td"]
    pdata = fm.pad_interactions(d)

    def run(weights):
        p = pb["tp"]
        e = (fm.residuals_padded(p, x, z, d, pdata, hp) if fused
             else fm.residuals(p, x, z, d, hp))
        for _ in range(2):
            p, e = (fm.epoch_padded(p, x, z, pdata, e, hp, weights=weights)
                    if fused else fm.epoch(p, x, z, d, e, hp, weights=weights))
        return p, e

    (p0, e0), (p1, e1) = run(None), run(torch.ones(d.nnz))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1)) and torch.equal(e0, e1)
    p, _ = run(torch.as_tensor(wts))
    jhp = jfm.FMHyperParams(k=3, alpha0=0.3, l2=0.05)
    jp = pb["jp"]
    je = jfm.residuals(jp, pb["jx"], pb["jz"], pb["jd"], jhp)
    for _ in range(2):
        jp, je = jfm.epoch(jp, pb["jx"], pb["jz"], pb["jd"], je, jhp,
                           weights=jnp.asarray(wts))
    _close_params(p, jp, FUSED_RTOL, FUSED_ATOL)


# -------------------------------------------------- the package surface ---
def test_init_params_and_dataclass_mirror_the_reference():
    gen = torch.Generator().manual_seed(0)
    p = fm.init(7, 5, 3, generator=gen)
    assert [tuple(t.shape) for t in p] == [(), (7,), (7, 3), (5,), (5, 3)]
    assert all(t.device.type == "cpu" for t in p)
    assert float(p.b) == 0 and not p.w_lin.any() and not p.h_lin.any()
    assert 0.01 < float(p.w.std()) < 1.0
    assert fm.FMParams._fields == jfm.FMParams._fields
    names = [f.name for f in dataclasses.fields(fm.FMHyperParams)]
    assert names == [f.name for f in dataclasses.fields(jfm.FMHyperParams)]
    assert fm.FMHyperParams(k=3) == fm.FMHyperParams(
        **{n: getattr(jfm.FMHyperParams(k=3), n) for n in names})
    arrays = (np.float32(1), np.zeros(4), np.zeros((4, 2)), np.zeros(3),
              np.zeros((3, 2)))
    assert fm.params_from_numpy(*arrays, device="cpu").w.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fm.params_from_numpy(*arrays)


def _inline_step(lp, lpp, rp, rpp, theta, l2, eta, alpha0):
    """The Newton step as the layers wrote it before ``sweeps.newton_delta``."""
    num = lp + alpha0 * rp + l2 * theta
    den = lpp + alpha0 * rpp + l2
    return -eta * num / torch.clamp(den, min=1e-12)


@pytest.mark.parametrize("l2", [0.0, 0.05])
@pytest.mark.parametrize("layer", ["embed", "linear", "bias"])
def test_layer_step_is_the_inline_newton_step_bit_for_bit(layer, l2):
    """Each FM layer's Δ through ``sweeps.newton_delta`` equals the inline
    formula's, bit for bit; the last id of the layer has no entry, so at
    λ = 0 its denominator is clamped."""
    gen = torch.Generator().manual_seed(3)
    n_rows, vocab, offset, k, f, eta = 9, 4, 2, 3, 1, 0.7
    hp = fm.FMHyperParams(k=k, alpha0=0.3, l2=l2, l2_lin=l2 + 0.01, eta=0.9)
    spec_col = hp.k
    ids_g = offset + torch.randint(0, vocab - 1, (n_rows,), generator=gen)
    xw = 0.5 + torch.rand(n_rows, generator=gen)
    rows = torch.arange(n_rows)
    local = ids_g - offset
    table_col, lin = torch.randn(8, generator=gen), torch.randn(8, generator=gen)
    self_ext = torch.randn((n_rows, k + 2), generator=gen)
    q, u, r_a, r_b, p1 = torch.randn((5, n_rows), generator=gen)
    p2, p0 = torch.rand((2, n_rows), generator=gen)
    j_ff, j_fs, j_ss = torch.tensor(1.3), torch.tensor(-0.2), torch.tensor(0.8)
    if layer == "embed":
        g = self_ext[:, f][rows] - xw * table_col[ids_g]
        delta = _inline_step(
            segment_sum(xw * (q[rows] + g * u[rows]), local, vocab),
            segment_sum(xw * xw * (p2[rows] + 2 * g * p1[rows] + g * g * p0[rows]),
                        local, vocab),
            segment_sum(xw * (r_a[rows] + g * r_b[rows]), local, vocab),
            segment_sum(xw * xw * (j_ff + 2 * g * j_fs + g * g * j_ss), local, vocab),
            table_col[offset:offset + vocab], hp.l2, eta, hp.alpha0)
        want = table_col.clone()
        want[offset:offset + vocab] += delta
        got = fm._embed_layer_update(
            table_col, self_ext.clone(), q, u, r_a, r_b, p2, p1, p0, j_ff, j_fs, j_ss,
            ids_g, xw, rows, vocab, offset, f, spec_col, hp, eta)[0]
    elif layer == "linear":
        delta = _inline_step(
            segment_sum(xw * u[rows], local, vocab),
            segment_sum(xw * xw * p0[rows], local, vocab),
            segment_sum(xw * r_b[rows], local, vocab),
            j_ss * segment_sum(xw * xw, local, vocab),
            lin[offset:offset + vocab], hp.l2_lin, eta, hp.alpha0)
        want = lin.clone()
        want[offset:offset + vocab] += delta
        got = fm._linear_layer_update(lin, self_ext.clone(), u, r_b, p0, j_ss, ids_g,
                                      xw, rows, vocab, offset, spec_col, hp, eta)[0]
    else:
        want = -hp.eta * (torch.sum(u) + hp.alpha0 * torch.sum(r_b)) / torch.clamp(
            torch.sum(p0) + hp.alpha0 * (j_ss * n_rows), min=1e-12)
        got = fm._bias_update(torch.tensor(0.4), self_ext.clone(), u, r_b, p0, j_ss,
                              n_rows, spec_col, hp)[1]
    assert torch.equal(got, want)
