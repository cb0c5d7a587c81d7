"""The port's fielded design matrix and MFSI held against the JAX package
from the same numpy inputs: design layouts and products, the flat and
fused epochs, the residual cache, weights, the serving surface, and the
plain versions of the slab-reduce and residual-patch kernels.

On the CPU the port's kernel wrappers run their plain versions and the JAX
package runs its Pallas kernels in interpret mode (toy sizes). Tolerances
are the reference's own (``tests/test_icd_mfsi.py``): parameters to rtol
5e-4 / atol 1e-5 and the padded residual grid to atol 5e-5 after two
epochs (fp32 sums in another order compound over dimensions and layers);
the residual cache against a recompute to rtol 2e-4 / atol 2e-5; the
kernels' plain versions to the kernel-vs-oracle rtol 2e-5 / atol 2e-6
(``tests/test_kernels.py``); design products to 1e-6; layouts, offsets and
ids exactly; and weights=None against weights=ones exactly within the
port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import design as jdesign
from repro.core.models import mfsi as jmfsi
from repro.kernels.cd_sweep import ref as jref
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.core import design
from repro_torch.core.models import mfsi
from repro_torch.kernels.cd_sweep import ops, ref
from repro_torch.sparse.interactions import build_interactions
from repro_torch.sparse.segment import segment_sum

torch.set_num_threads(1)

RTOL, ATOL, E_ATOL = 5e-4, 1e-5, 5e-5
CACHE_RTOL, CACHE_ATOL = 2e-4, 2e-5
KERNEL_RTOL, KERNEL_ATOL = 2e-5, 2e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _specs(rng, n_ctx, n_items, with_bag):
    """Field specs of tests/test_icd_mfsi.py's problem; the bag holds 3
    distinct ids a row, the last slot of every third row zero-weighted."""
    ctx_fields = [dict(name="country", ids=rng.integers(0, 4, n_ctx), vocab=4),
                  dict(name="age", ids=rng.integers(0, 3, n_ctx), vocab=3)]
    if with_bag:
        w = np.full((n_ctx, 3), 1 / 3, np.float32)
        w[::3, 2] = 0
        ctx_fields.append(dict(
            name="hist", vocab=6, weights=w,
            ids=np.stack([rng.choice(6, 3, replace=False) for _ in range(n_ctx)])))
    item_fields = [dict(name="item_id", ids=np.arange(n_items), vocab=n_items),
                   dict(name="genre", ids=rng.integers(0, 5, n_items), vocab=5)]
    return ctx_fields, item_fields


def _problem(seed=0, n_ctx=14, n_items=10, nnz=40, alpha0=0.3, with_bag=False,
             k=5):
    """One MFSI problem in both packages, with numpy start embeddings."""
    rng = np.random.default_rng(seed)
    cf, itf = _specs(rng, n_ctx, n_items, with_bag)
    pairs = rng.choice(n_ctx * n_items, size=nnz, replace=False)
    ctx, item = pairs // n_items, pairs % n_items
    y = rng.integers(1, 5, size=nnz).astype(np.float64)
    alpha = alpha0 + 1.0 + rng.random(nnz)
    jx, jz = jdesign.make_design(cf, n_ctx), jdesign.make_design(itf, n_items)
    tx = design.make_design(cf, n_ctx, device="cpu")
    tz = design.make_design(itf, n_items, device="cpu")
    w0 = (0.1 * rng.normal(size=(jx.p, k))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(jz.p, k))).astype(np.float32)
    return dict(
        jx=jx, jz=jz, tx=tx, tz=tz, w0=w0, h0=h0,
        jd=jbuild(ctx, item, y, alpha, n_ctx, n_items, alpha0=alpha0),
        td=build_interactions(ctx, item, y, alpha, n_ctx, n_items,
                              alpha0=alpha0, device="cpu"),
        jp=jmfsi.MFSIParams(jnp.asarray(w0), jnp.asarray(h0)),
        tp=mfsi.params_from_numpy(w0, h0, device="cpu"))


# ------------------------------------------------------------ the design ---
@pytest.mark.parametrize("with_bag", [False, True])
def test_design_matches_reference(with_bag):
    rng = np.random.default_rng(3)
    cf, _ = _specs(rng, 11, 7, with_bag)
    jx = jdesign.make_design(cf, 11)
    tx = design.make_design(cf, 11, device="cpu")
    assert (tx.n_rows, tx.p) == (jx.n_rows, jx.p)
    for tf, jf in zip(tx.fields, jx.fields):
        assert (tf.vocab, tf.offset, tf.one_hot, tf.name, tf.bag) == \
            (jf.vocab, jf.offset, jf.one_hot, jf.name, jf.bag)
        np.testing.assert_array_equal(tf.ids.numpy(), np.asarray(jf.ids))
        np.testing.assert_array_equal(tf.weights.numpy(), np.asarray(jf.weights))
        np.testing.assert_array_equal(tx.global_ids(tf).numpy(),
                                      np.asarray(jx.global_ids(jf)))
    table = rng.normal(size=(jx.p, 4)).astype(np.float32)
    _close(design.design_matmul(tx, _t(table)),
           jdesign.design_matmul(jx, jnp.asarray(table)), rtol=1e-6, atol=1e-6)
    _close(design.design_col_sq_sums(tx), jdesign.design_col_sq_sums(jx),
           rtol=1e-6, atol=1e-6)
    _close(design.to_dense(tx), jdesign.to_dense(jx), rtol=1e-6, atol=1e-6)
    rows = np.array([4, 0, 4, 10], np.int32)
    tsub = design.take_rows(tx, _t(rows))
    jsub = jdesign.take_rows(jx, jnp.asarray(rows))
    assert (tsub.n_rows, tsub.p) == (jsub.n_rows, jsub.p)
    _close(design.to_dense(tsub), jdesign.to_dense(jsub), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["active_dup", "inactive_dup", "clean"])
def test_duplicate_bag_ids_raise_on_the_same_row(case):
    """The reference checks row by row; the port's vectorised check must
    raise on the same first row, and not where a duplicate is inactive."""
    rng = np.random.default_rng(4)
    n = 9
    ids = np.stack([rng.choice(20, 4, replace=False) for _ in range(n)])
    w = np.ones((n, 4), np.float32)
    w[:, 3] = 0
    if case == "active_dup":
        ids[6, 2] = ids[6, 0]
        ids[2, 1] = ids[2, 2]
        ids[4, 3] = ids[4, 0]  # inactive duplicate: not a fault
    elif case == "inactive_dup":
        ids[5, 3] = ids[5, 1]
    spec = [dict(name="hist", ids=ids, weights=w, vocab=20)]
    if case == "active_dup":
        with pytest.raises(ValueError, match=r"duplicate ids in row 2;") as want:
            jdesign.make_design(spec, n)
        with pytest.raises(ValueError) as got:
            design.make_design(spec, n, device="cpu")
        assert str(got.value) == str(want.value)
    else:
        jdesign.make_design(spec, n)
        assert design.make_design(spec, n, device="cpu").p == 20


# --------------------------------------------------------------- epochs ---
def _flat_epochs(pb, hp_kw, weights=None, n=2):
    jhp = jmfsi.MFSIHyperParams(**hp_kw)
    thp = mfsi.MFSIHyperParams(**hp_kw)
    jp, tp = pb["jp"], pb["tp"]
    je = jmfsi.residuals(jp, pb["jx"], pb["jz"], pb["jd"])
    te = mfsi.residuals(tp, pb["tx"], pb["tz"], pb["td"])
    jw = None if weights is None else jnp.asarray(weights)
    tw = None if weights is None else _t(weights)
    for _ in range(n):
        jp, je = jmfsi.epoch(jp, pb["jx"], pb["jz"], pb["jd"], je, jhp,
                             weights=jw)
        tp, te = mfsi.epoch(tp, pb["tx"], pb["tz"], pb["td"], te, thp,
                            weights=tw)
    return (jp, je), (tp, te)


@pytest.mark.parametrize("k,with_bag,mode", [(2, False, "jacobi"),
                                             (5, False, "jacobi"),
                                             (3, True, "jacobi"),
                                             (3, True, "slot")])
def test_flat_epoch_matches_reference(k, with_bag, mode):
    pb = _problem(seed=1, with_bag=with_bag, k=k)
    (jp, je), (tp, te) = _flat_epochs(
        pb, dict(k=k, alpha0=0.3, l2=0.05, multi_hot_mode=mode))
    _close(tp.w, jp.w)
    _close(tp.h, jp.h)
    _close(te, je, atol=E_ATOL)
    hp = mfsi.MFSIHyperParams(k=k, alpha0=0.3, l2=0.05, multi_hot_mode=mode)
    _close(mfsi.objective(tp, pb["tx"], pb["tz"], pb["td"], hp),
           jmfsi.objective(jp, pb["jx"], pb["jz"], pb["jd"],
                           jmfsi.MFSIHyperParams(k=k, alpha0=0.3, l2=0.05,
                                                 multi_hot_mode=mode)))
    # the residual cache stays consistent with a recompute, except in
    # 'slot' mode: a slot layer moves w_l but patches Φ and e only on the
    # rows where l sits in that slot, in the reference as in the port
    if mode != "slot":
        _close(te, mfsi.residuals(tp, pb["tx"], pb["tz"], pb["td"]),
               rtol=CACHE_RTOL, atol=CACHE_ATOL)


@pytest.mark.parametrize("block_k", [1, 3, 5])
@pytest.mark.parametrize("psi_dispatch", ["gather", "pregather"])
def test_epoch_padded_matches_reference(block_k, psi_dispatch):
    """k = 5 with a jacobi bag: block_k 3 leaves a 2-column tail. Two fused
    epochs of the port against two of the JAX package (its Pallas kernels
    in interpret mode), and the padded grid against the flat cache."""
    pb = _problem(seed=6, with_bag=True)
    hp_kw = dict(k=5, alpha0=0.3, l2=0.05, block_k=block_k,
                 psi_dispatch=psi_dispatch)
    jhp, thp = jmfsi.MFSIHyperParams(**hp_kw), mfsi.MFSIHyperParams(**hp_kw)
    jpd = jmfsi.pad_interactions(pb["jd"])
    tpd = mfsi.pad_interactions(pb["td"])
    jp, tp = pb["jp"], pb["tp"]
    je = jmfsi.residuals_padded(jp, pb["jx"], pb["jz"], pb["jd"], jpd)
    te = mfsi.residuals_padded(tp, pb["tx"], pb["tz"], pb["td"], tpd)
    _close(te, je, rtol=1e-6, atol=1e-6)
    for _ in range(2):
        jp, je = jmfsi.epoch_padded(jp, pb["jx"], pb["jz"], jpd, je, jhp)
        tp, te = mfsi.epoch_padded(tp, pb["tx"], pb["tz"], tpd, te, thp)
    _close(tp.w, jp.w)
    _close(tp.h, jp.h)
    _close(te, je, atol=E_ATOL)
    # the residual cache against a recompute on the padded grid
    _close(te, mfsi.residuals_padded(tp, pb["tx"], pb["tz"], pb["td"], tpd),
           rtol=CACHE_RTOL, atol=CACHE_ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_weights_none_is_ones_and_weighted_matches_reference(fused):
    pb = _problem(seed=8, with_bag=True, k=3)
    hp = mfsi.MFSIHyperParams(k=3, alpha0=0.3, l2=0.05, block_k=2)
    ones = torch.ones(pb["td"].nnz)
    wts = (0.5 + np.random.default_rng(9).random(pb["td"].nnz)).astype(np.float32)
    if fused:
        tpd = mfsi.pad_interactions(pb["td"])
        outs = []
        for w in (None, ones):
            p = pb["tp"]
            e = mfsi.residuals_padded(p, pb["tx"], pb["tz"], pb["td"], tpd)
            for _ in range(2):
                p, e = mfsi.epoch_padded(p, pb["tx"], pb["tz"], tpd, e, hp,
                                         weights=w)
            outs.append((p, e))
        (p0, e0), (p1, e1) = outs
        assert torch.equal(p0.w, p1.w) and torch.equal(p0.h, p1.h)
        assert torch.equal(e0, e1)
        # weighted fused against the JAX package's weighted flat epoch
        jhp = jmfsi.MFSIHyperParams(k=3, alpha0=0.3, l2=0.05)
        jp = pb["jp"]
        je = jmfsi.residuals(jp, pb["jx"], pb["jz"], pb["jd"])
        p = pb["tp"]
        e = mfsi.residuals_padded(p, pb["tx"], pb["tz"], pb["td"], tpd)
        for _ in range(2):
            jp, je = jmfsi.epoch(jp, pb["jx"], pb["jz"], pb["jd"], je, jhp,
                                 weights=jnp.asarray(wts))
            p, e = mfsi.epoch_padded(p, pb["tx"], pb["tz"], tpd, e, hp,
                                     weights=_t(wts))
        _close(p.w, jp.w)
        _close(p.h, jp.h)
        return
    kw = dict(k=3, alpha0=0.3, l2=0.05)
    outs = []
    for w in (None, ones):
        p = pb["tp"]
        e = mfsi.residuals(p, pb["tx"], pb["tz"], pb["td"])
        for _ in range(2):
            p, e = mfsi.epoch(p, pb["tx"], pb["tz"], pb["td"], e,
                              mfsi.MFSIHyperParams(**kw), weights=w)
        outs.append((p, e))
    (t0, e0), (t1, e1) = outs
    assert torch.equal(t0.w, t1.w) and torch.equal(t0.h, t1.h)
    assert torch.equal(e0, e1)
    (jp, je), (tp, te) = _flat_epochs(pb, kw, weights=wts)
    _close(tp.w, jp.w)
    _close(tp.h, jp.h)
    _close(te, je, atol=E_ATOL)


def test_fit_and_serving_surface_match_reference():
    pb = _problem(seed=2, with_bag=True, k=4)
    kw = dict(k=4, alpha0=0.3, l2=0.05)
    jp = jmfsi.fit(pb["jp"], pb["jx"], pb["jz"], pb["jd"],
                   jmfsi.MFSIHyperParams(**kw), 2)
    seen = []
    tp = mfsi.fit(pb["tp"], pb["tx"], pb["tz"], pb["td"],
                  mfsi.MFSIHyperParams(**kw), 2,
                  callback=lambda ep, p: seen.append(ep))
    assert seen == [0, 1]
    _close(tp.w, jp.w)
    _close(tp.h, jp.h)
    rows = np.array([3, 0, 13, 3], np.int32)
    _close(mfsi.build_phi(tp, pb["tx"], rows),
           jmfsi.build_phi(jp, pb["jx"], jnp.asarray(rows)))
    _close(mfsi.build_phi(tp, pb["tx"]), jmfsi.build_phi(jp, pb["jx"]))
    _close(mfsi.export_psi(tp, pb["tz"]), jmfsi.export_psi(jp, pb["jz"]))
    ctx, item = np.array([0, 5, 13]), np.array([9, 0, 4])
    _close(mfsi.predict(tp, pb["tx"], pb["tz"], ctx, item),
           jmfsi.predict(jp, pb["jx"], pb["jz"], jnp.asarray(ctx),
                         jnp.asarray(item)))


def test_init_draws_on_the_generators_device():
    gen = torch.Generator().manual_seed(0)
    p = mfsi.init(7, 5, 3, generator=gen)
    assert p.w.shape == (7, 3) and p.h.shape == (5, 3)
    assert p.w.device.type == "cpu"
    assert 0.01 < float(p.w.std()) < 1.0


# ----------------------------------------- kernels 6–9, plain versions ---
@pytest.mark.parametrize("m", [1, 3, 8, 9, 17])
def test_slab_and_patch_plain_versions_match_jax(m):
    """The plain versions of the slab reduce and residual patch, both
    routings, against the JAX package's: the ψ slab a column slice of a
    wider table (row stride > m), ids past both ends of the slab."""
    rng = np.random.default_rng(m)
    c, d, n_src = 6, 40, 25
    wide = rng.normal(size=(n_src, m + 3)).astype(np.float32)
    tab = _t(wide)[:, 2:2 + m]
    ids = rng.integers(0, n_src, (c, d)).astype(np.int32)
    ids[:, :4] = [-3, n_src, 10 * n_src, -1]
    alpha = rng.random((c, d)).astype(np.float32)
    alpha[:, -5:] = 0
    e = rng.normal(size=(c, d)).astype(np.float32)
    dphi = rng.normal(size=(c, m)).astype(np.float32)
    jtab = jnp.asarray(wide[:, 2:2 + m])
    jargs = (jnp.asarray(ids), jnp.asarray(alpha), jnp.asarray(e))
    want_q, want_p = jref.cd_slab_reduce_gather_ref(jtab, *jargs)
    q, p = ops.cd_slab_reduce_gather(tab, _t(ids), _t(alpha), _t(e))
    _close(q, want_q, KERNEL_RTOL, KERNEL_ATOL)
    _close(p, want_p, KERNEL_RTOL, KERNEL_ATOL)
    psi_blk = jref.gather_psi_blk(jtab, jnp.asarray(ids))
    q2, p2 = ops.cd_slab_reduce(_t(psi_blk), _t(alpha), _t(e))
    _close(q2, want_q, KERNEL_RTOL, KERNEL_ATOL)
    _close(p2, want_p, KERNEL_RTOL, KERNEL_ATOL)
    want_e = jref.cd_resid_patch_gather_ref(jtab, jnp.asarray(ids),
                                            jnp.asarray(e), jnp.asarray(dphi))
    e1 = _t(e).clone()
    assert ops.cd_resid_patch_gather(tab, _t(ids), e1, _t(dphi)) is e1
    _close(e1, want_e, KERNEL_RTOL, KERNEL_ATOL)
    e2 = _t(e).clone()
    assert ops.cd_resid_patch(_t(psi_blk), e2, _t(dphi)) is e2
    _close(e2, want_e, KERNEL_RTOL, KERNEL_ATOL)
    # the port's own gather helper clips as jnp.take(mode="clip") does
    np.testing.assert_array_equal(ref.gather_psi_blk(tab, _t(ids)).numpy(),
                                  np.asarray(psi_blk))


def test_slab_reduce_weights_fold_into_alpha():
    rng = np.random.default_rng(5)
    c, m, d = 4, 3, 16
    psi = _t(rng.normal(size=(c, m, d)).astype(np.float32))
    alpha = _t(rng.random((c, d)).astype(np.float32))
    e = _t(rng.normal(size=(c, d)).astype(np.float32))
    w = _t(rng.random((c, d)).astype(np.float32))
    got = ops.cd_slab_reduce(psi, alpha, e, weights=w)
    want = ops.cd_slab_reduce(psi, alpha * w, e)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_mfsi_interpret_kernels_match_plain_versions():
    """The JAX package's Pallas slab-reduce and residual-patch kernels in
    interpret mode against the port's plain versions (m = 3, a strided
    slab, negative ids; the Pallas kernel pads the slab with zero rows, so
    ids past its end are not clipped there as ``jnp.take`` clips them)."""
    from repro.kernels.cd_sweep.kernel import (
        cd_resid_patch_gather_pallas,
        cd_slab_reduce_gather_pallas,
    )

    rng = np.random.default_rng(11)
    c, d, n_src, m = 9, 16, 12, 3
    wide = rng.normal(size=(n_src, 5)).astype(np.float32)
    ids = rng.integers(-2, n_src, (c, d)).astype(np.int32)
    alpha = rng.random((c, d)).astype(np.float32)
    e = rng.normal(size=(c, d)).astype(np.float32)
    dphi = rng.normal(size=(c, m)).astype(np.float32)
    jtab = jnp.asarray(wide[:, 1:1 + m])
    jq, jp = cd_slab_reduce_gather_pallas(
        jtab, jnp.asarray(ids), jnp.asarray(alpha), jnp.asarray(e),
        block_ctx=8, interpret=True)
    q, p = ops.cd_slab_reduce_gather(_t(wide)[:, 1:1 + m], _t(ids), _t(alpha),
                                     _t(e))
    _close(q, jq, KERNEL_RTOL, KERNEL_ATOL)
    _close(p, jp, KERNEL_RTOL, KERNEL_ATOL)
    je = cd_resid_patch_gather_pallas(jtab, jnp.asarray(ids), jnp.asarray(e),
                                      jnp.asarray(dphi), block_ctx=8,
                                      interpret=True)
    te = ops.cd_resid_patch_gather(_t(wide)[:, 1:1 + m], _t(ids), _t(e).clone(),
                                   _t(dphi))
    _close(te, je, KERNEL_RTOL, KERNEL_ATOL)
    jax.clear_caches()


def test_mfsi_entry_points_want_a_card_unless_cpu_is_named():
    w, h = np.zeros((4, 2), np.float32), np.zeros((3, 2), np.float32)
    spec = [dict(name="u", ids=np.arange(2), vocab=4)]
    assert mfsi.params_from_numpy(w, h, device="cpu").w.device.type == "cpu"
    assert design.make_design(spec, 2, device="cpu").fields[0].ids.device.type == "cpu"
    if torch.cuda.is_available():
        assert mfsi.params_from_numpy(w, h).w.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfsi.params_from_numpy(w, h)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        design.make_design(spec, 2)


def test_dataclass_fields_mirror_the_reference():
    names = [f.name for f in dataclasses.fields(mfsi.MFSIHyperParams)]
    jnames = [f.name for f in dataclasses.fields(jmfsi.MFSIHyperParams)]
    assert names == jnames
    assert mfsi.MFSIHyperParams(k=3) == mfsi.MFSIHyperParams(
        **{n: getattr(jmfsi.MFSIHyperParams(k=3), n) for n in jnames})
    assert [f.name for f in dataclasses.fields(design.Field)] == \
        [f.name for f in dataclasses.fields(jdesign.Field)]


@pytest.mark.parametrize("l2", [0.0, 0.05])
def test_field_layer_step_is_the_inline_newton_step_bit_for_bit(l2):
    """A field layer's Δ through ``sweeps.newton_delta`` equals the inline
    formula's, bit for bit; the last id of the layer has no entry, so at
    λ = 0 its denominator is clamped."""
    gen = torch.Generator().manual_seed(4)
    n_rows, vocab, offset, eta = 9, 4, 2, 0.7
    hp = mfsi.MFSIHyperParams(k=3, alpha0=0.3, l2=l2)
    ids_g = offset + torch.randint(0, vocab - 1, (n_rows,), generator=gen)
    xw = 0.5 + torch.rand(n_rows, generator=gen)
    rows = torch.arange(n_rows)
    local = ids_g - offset
    table_col, phi_col = torch.randn(8, generator=gen), torch.randn(n_rows, generator=gen)
    q, r_vec = torch.randn((2, n_rows), generator=gen)
    p2, jff = torch.rand(n_rows, generator=gen), torch.tensor(1.3)
    num = (segment_sum(xw * q[rows], local, vocab)
           + hp.alpha0 * segment_sum(xw * r_vec[rows], local, vocab)
           + hp.l2 * table_col[offset:offset + vocab])
    den = (segment_sum(xw * xw * p2[rows], local, vocab)
           + hp.alpha0 * (jff * segment_sum(xw * xw, local, vocab)) + hp.l2)
    want = table_col.clone()
    want[offset:offset + vocab] += -eta * num / torch.clamp(den, min=1e-12)
    got = mfsi._field_layer_update(table_col, phi_col, q, r_vec, p2, jff, ids_g, xw,
                                   rows, vocab, offset, hp, eta)[0]
    assert torch.equal(got, want)
