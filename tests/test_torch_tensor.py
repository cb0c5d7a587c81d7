"""The port's tensor models (PARAFAC, Tucker, CtxMF) and their row-patch
block sweeps held against the JAX package from the same numpy inputs: the
padded groupings, the context-bucket helpers, the flat and fused epochs,
and the row-patch kernel wrappers.

On the CPU the port's kernel wrappers run their plain versions and the JAX
package runs its Pallas kernels in interpret mode (toy sizes). Tolerances
are the reference's own (``tests/test_icd_tensor.py``,
``tests/test_ctxmf.py``): parameters to rtol 5e-4 / atol 1e-5 and the
residual cache to rtol 5e-4 / atol 5e-5 after two epochs (fp32 sums in
another order compound over columns and modes); Tucker, whose core sweep
chains k1·k2·k3 scalar steps, to rtol 1e-3 / atol 1e-4, the reference's
autodiff tolerance for it; the row-patch sweeps to the kernel-vs-oracle
rtol 2e-5 / atol 2e-6 (``tests/test_kernels.py``); layouts, bucket ids and
pair lists exactly; and weights=None against weights=ones exactly within
the port. The split-row sweep's two-pass algebra, stated here in torch,
is held to the row-patch sweeps' tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import padded as jpadded
from repro.core import sweeps as jsweeps
from repro.core.models import ctxmf as jctxmf
from repro.core.models import parafac as jpf
from repro.core.models import tucker as jtk
from repro.kernels.cd_sweep.kernel import (
    cd_block_sweep_rowpatch_gather_pallas,
    cd_block_sweep_rowpatch_pallas,
)
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.core import padded, sweeps
from repro_torch.core.models import ctxmf, parafac, tucker
from repro_torch.kernels import vmem
from repro_torch.kernels.cd_sweep import ops, ref
from repro_torch.sparse.interactions import build_interactions

torch.set_num_threads(1)

RTOL, ATOL, E_ATOL = 5e-4, 1e-5, 5e-5
TUCKER_RTOL, TUCKER_ATOL = 1e-3, 1e-4
SWEEP_RTOL, SWEEP_ATOL = 2e-5, 2e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _problem(seed=0, n_c1=5, n_c2=4, n_items=6, n_pairs=12, nnz=25,
             alpha0=0.3, pair_list=None, obs_pairs=None):
    """A tensor problem in both packages: (jax tc, jax data, port tc, port
    data). ``pair_list`` fixes the pairs; ``obs_pairs`` limits the
    observations to the first pairs (so later pairs have none)."""
    rng = np.random.default_rng(seed)
    if pair_list is None:
        chosen = rng.choice(n_c1 * n_c2, size=n_pairs, replace=False)
        pair_list = np.stack([chosen // n_c2, chosen % n_c2], 1)
    n_pairs = len(pair_list)
    cells = rng.choice((obs_pairs or n_pairs) * n_items, size=nnz,
                       replace=False)
    ctx, item = cells // n_items, cells % n_items
    y = rng.integers(1, 4, size=nnz).astype(np.float64)
    alpha = alpha0 + 1.0 + rng.random(nnz)
    jtc = jpf.TensorContext(c1=jnp.asarray(pair_list[:, 0], jnp.int32),
                            c2=jnp.asarray(pair_list[:, 1], jnp.int32),
                            n_c1=n_c1, n_c2=n_c2)
    ttc = parafac.TensorContext(c1=_t(pair_list[:, 0]), c2=_t(pair_list[:, 1]),
                                n_c1=n_c1, n_c2=n_c2)
    jd = jbuild(ctx, item, y, alpha, n_pairs, n_items, alpha0=alpha0)
    td = build_interactions(ctx, item, y, alpha, n_pairs, n_items,
                            alpha0=alpha0, device="cpu")
    return jtc, jd, ttc, td


def _factors(seed, shapes):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=s)).astype(np.float32) for s in shapes]


def _parafac_params(seed, tc, n_items, k):
    f = _factors(seed, [(tc.n_c1, k), (tc.n_c2, k), (n_items, k)])
    return (jpf.PARAFACParams(*map(jnp.asarray, f)),
            parafac.params_from_numpy(*f, device="cpu"))


# ------------------------------------------------------------ layouts ---
@pytest.mark.parametrize("lane", [128, 8])
def test_build_group_matches_reference(lane):
    rng = np.random.default_rng(1)
    groups = rng.integers(0, 9, 300)
    groups[groups == 4] = 5               # an empty row
    alpha = rng.random(300).astype(np.float32) + 0.1
    got = padded.build_group(groups, alpha, 10, lane, device="cpu")
    want = jpadded.build_group(groups, alpha, 10, lane)
    assert (got.n_rows, got.d_pad) == (want.n_rows, want.d_pad)
    for name in ("rows", "cols", "alpha_pad", "flat_ids"):
        _eq(getattr(got, name), getattr(want, name))
    assert got.flat_ids.dtype == torch.int32
    empty = padded.build_group(np.zeros(0, np.int64), np.zeros(0), 3, lane,
                               device="cpu")
    ref_empty = jpadded.build_group(np.zeros(0, np.int64), np.zeros(0), 3, lane)
    assert empty.d_pad == ref_empty.d_pad
    _eq(empty.flat_ids, ref_empty.flat_ids)


def test_padded_group_ops_match_reference():
    rng = np.random.default_rng(2)
    groups = rng.integers(0, 6, 50)
    alpha = rng.random(50).astype(np.float32)
    got = padded.build_group(groups, alpha, 6, device="cpu")
    want = jpadded.build_group(groups, alpha, 6)
    vals = rng.normal(size=50).astype(np.float32)
    blk = rng.normal(size=(50, 3)).astype(np.float32)
    _eq(got.scatter(_t(vals)), want.scatter(jnp.asarray(vals)))
    _eq(got.scatter_blk(_t(blk)), want.scatter_blk(jnp.asarray(blk)))
    assert got.scatter_blk(_t(blk)).is_contiguous()
    grid = got.scatter(_t(vals))
    _eq(got.gather(grid), vals)
    _eq(got.with_alpha(_t(vals)).alpha_pad,
        want.with_alpha(jnp.asarray(vals)).alpha_pad)
    slab = padded.append_sentinel_row(_t(blk))
    _eq(slab, jpadded.append_sentinel_row(jnp.asarray(blk)))
    # the sentinel gather reproduces the scatter's zeros on padding
    tile = slab[got.flat_ids.long()].movedim(-1, 1)
    _eq(tile, got.scatter_blk(_t(blk)))


@pytest.mark.parametrize("seed", [0, 5])
def test_pad_tensor_groups_matches_reference(seed):
    jtc, jd, ttc, td = _problem(seed=seed, n_c1=7, n_c2=3, n_items=9, nnz=40)
    got = parafac.pad_tensor_groups(ttc, td)
    want = jpf.pad_tensor_groups(jtc, jd)
    for g in ("g1", "g2", "gi"):
        a, b = getattr(got, g), getattr(want, g)
        assert (a.n_rows, a.d_pad) == (b.n_rows, b.d_pad)
        for name in ("rows", "cols", "alpha_pad", "flat_ids"):
            _eq(getattr(a, name), getattr(b, name))
        assert int(a.flat_ids.max()) == td.nnz  # the sentinel row
    _eq(got.pair_ids_item, want.pair_ids_item)


# ------------------------------------------------------ ctxmf plumbing ---
def test_bucket_helpers_match_reference():
    rng = np.random.default_rng(3)
    t = rng.uniform(0, 5 * 86400, 500)
    for kw in (dict(period=86400.0), dict(period=3600.0, t0=12.5), {}):
        _eq(ctxmf.seasonal_buckets(t, 24, **kw),
            jctxmf.seasonal_buckets(t, 24, **kw))
    assert ctxmf.seasonal_buckets(t, 24).dtype == np.int32
    assert ctxmf.seasonal_buckets([], 4).size == 0
    for gap, n in ((600.0, 8), (60.0, 3)):
        _eq(ctxmf.session_buckets(t, gap, n), jctxmf.session_buckets(t, gap, n))
    assert ctxmf.session_buckets([], 5.0, 3).size == 0


def test_build_context_matches_reference():
    rng = np.random.default_rng(4)
    user = rng.integers(0, 30, 400)
    bucket = ctxmf.seasonal_buckets(rng.uniform(0, 1e5, 400), 6,
                                    period=86400.0)
    tc, pair = ctxmf.build_context(user, bucket, 30, 6, device="cpu")
    jtc, jpair = jctxmf.build_context(user, bucket, 30, 6)
    _eq(tc.c1, jtc.c1)
    _eq(tc.c2, jtc.c2)
    _eq(pair, jpair)
    assert (tc.n_c1, tc.n_c2, tc.n_ctx) == (jtc.n_c1, jtc.n_c2, jtc.n_ctx)
    with pytest.raises(ValueError):
        ctxmf.build_context(user, bucket, 20, 6, device="cpu")
    with pytest.raises(ValueError):
        ctxmf.build_context(user, bucket, 30, 3, device="cpu")


# ------------------------------------------------------------ PARAFAC ---
# each Ψ routing at the defaults, at η 0.7, and at l2 0 with η 0.5
ROUTES = [pytest.param(route, extra, id=route + tag)
          for tag, extra in (("", {}), ("-eta0.7", dict(eta=0.7)),
                             ("-l2_0", dict(eta=0.5, l2=0.0)))
          for route in ("gather", "pregather")]


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("block_k", [0, 1, 2])
@pytest.mark.parametrize("psi_dispatch,extra", ROUTES)
def test_parafac_epoch_padded_matches_reference(dense, block_k, psi_dispatch,
                                                extra):
    """Two fused epochs at a non-divisible k = 3, in each Ψ routing, at
    η 1 and 0.7 and at l2 0."""
    jtc, jd, ttc, td = _problem(seed=6)
    k = 3
    kw = dict(k=k, alpha0=0.3, l2=0.05, dense_context=dense, block_k=block_k,
              psi_dispatch=psi_dispatch)
    kw.update(extra)
    jhp, thp = jpf.PARAFACHyperParams(**kw), parafac.PARAFACHyperParams(**kw)
    jp, tp = _parafac_params(7, jtc, jd.n_items, k)
    jpad, tpad = jpf.pad_tensor_groups(jtc, jd), parafac.pad_tensor_groups(ttc, td)
    je, te = jpf.residuals(jp, jtc, jd), parafac.residuals(tp, ttc, td)
    _close(te, je, atol=E_ATOL)
    for _ in range(2):
        jp, je = jpf.epoch_padded(jp, jtc, jd, jpad, je, jhp)
        tp, te = parafac.epoch_padded(tp, ttc, td, tpad, te, thp)
    for a, b in zip(tp, jp):
        _close(a, b)
    _close(te, je, atol=E_ATOL)


@pytest.mark.parametrize("dense", [False, True])
def test_parafac_flat_epoch_and_objective_match_reference(dense):
    jtc, jd, ttc, td = _problem(seed=8)
    kw = dict(k=4, alpha0=0.3, l2=0.05, dense_context=dense)
    jhp, thp = jpf.PARAFACHyperParams(**kw), parafac.PARAFACHyperParams(**kw)
    jp, tp = _parafac_params(9, jtc, jd.n_items, 4)
    _close(parafac.objective(tp, ttc, td, thp), jpf.objective(jp, jtc, jd, jhp),
           rtol=1e-5)
    je, te = jpf.residuals(jp, jtc, jd), parafac.residuals(tp, ttc, td)
    for _ in range(2):
        jp, je = jpf.epoch(jp, jtc, jd, je, jhp)
        tp, te = parafac.epoch(tp, ttc, td, te, thp)
    for a, b in zip(tp, jp):
        _close(a, b)
    _close(te, je, atol=E_ATOL)
    _close(parafac.objective(tp, ttc, td, thp), jpf.objective(jp, jtc, jd, jhp),
           rtol=RTOL)


@pytest.mark.parametrize("l2", [0.0, 0.05])
def test_parafac_empty_context_rows_match_reference(l2):
    """c1 = 3 has a pair but no observations, c1 = 4 and c2 = 3 no pair at
    all: at l2 = 0 a fully empty row's Newton denominator is 0 and only the
    1e-12 clamp keeps it finite."""
    pairs = np.array([[0, 0], [0, 1], [1, 0], [1, 2], [2, 1], [3, 2]])
    jtc, jd, ttc, td = _problem(seed=10, pair_list=pairs, obs_pairs=5, nnz=10)
    kw = dict(k=3, alpha0=0.3, l2=l2, block_k=2)
    jhp, thp = jpf.PARAFACHyperParams(**kw), parafac.PARAFACHyperParams(**kw)
    jp, tp = _parafac_params(11, jtc, jd.n_items, 3)
    got, _ = parafac.epoch_padded(tp, ttc, td, parafac.pad_tensor_groups(ttc, td),
                                  parafac.residuals(tp, ttc, td), thp)
    want, _ = jpf.epoch_padded(jp, jtc, jd, jpf.pad_tensor_groups(jtc, jd),
                               jpf.residuals(jp, jtc, jd), jhp)
    flat, _ = parafac.epoch(tp, ttc, td, parafac.residuals(tp, ttc, td), thp)
    for a, b, c in zip(got, want, flat):
        assert bool(torch.isfinite(a).all())
        _close(a, b)
        _close(a, c)
    if l2 == 0.0:  # the row of no pair keeps its value exactly
        _eq(got.u[4], tp.u[4])


def test_parafac_serving_surface_matches_reference():
    jtc, jd, ttc, td = _problem(seed=12)
    jp, tp = _parafac_params(13, jtc, jd.n_items, 4)
    c1, c2, it = np.array([0, 2, 4]), np.array([1, 3, 0]), np.array([5, 0, 2])
    _close(parafac.build_phi(tp, c1, c2), jpf.build_phi(jp, c1, c2), rtol=1e-6)
    _close(parafac.predict(tp, c1, c2, it), jpf.predict(jp, c1, c2, it),
           rtol=1e-6)
    _close(parafac.phi(tp, ttc), jpf.phi(jp, jtc), rtol=1e-6)
    assert parafac.export_psi(tp) is tp.w and parafac.psi(tp) is tp.w
    gen = torch.Generator().manual_seed(0)
    p = parafac.init(5, 4, 6, 3, generator=gen)
    assert [tuple(x.shape) for x in p] == [(5, 3), (4, 3), (6, 3)]


def test_parafac_fit_matches_reference():
    jtc, jd, ttc, td = _problem(seed=14)
    kw = dict(k=3, alpha0=0.3, l2=0.05)
    jp, tp = _parafac_params(15, jtc, jd.n_items, 3)
    seen = []
    got = parafac.fit(tp, ttc, td, parafac.PARAFACHyperParams(**kw), 3,
                      callback=lambda ep, p: seen.append(ep))
    want = jpf.fit(jp, jtc, jd, jpf.PARAFACHyperParams(**kw), 3)
    assert seen == [0, 1, 2]
    for a, b in zip(got, want):
        _close(a, b)


def _weights(seed, nnz):
    return np.random.default_rng(seed).uniform(0.3, 2.5, nnz).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_parafac_weighted_epochs_match_reference(fused, dense):
    """Non-uniform per-interaction weights through two flat or fused
    epochs, sparse and dense context."""
    jtc, jd, ttc, td = _problem(seed=50)
    kw = dict(k=3, alpha0=0.3, l2=0.05, dense_context=dense, block_k=2)
    jhp, thp = jpf.PARAFACHyperParams(**kw), parafac.PARAFACHyperParams(**kw)
    jp, tp = _parafac_params(51, jtc, jd.n_items, 3)
    wts = _weights(52, jd.nnz)
    jw, tw = jnp.asarray(wts), _t(wts)
    je, te = jpf.residuals(jp, jtc, jd), parafac.residuals(tp, ttc, td)
    jpad, tpad = jpf.pad_tensor_groups(jtc, jd), parafac.pad_tensor_groups(ttc, td)
    for _ in range(2):
        if fused:
            jp, je = jpf.epoch_padded(jp, jtc, jd, jpad, je, jhp, weights=jw)
            tp, te = parafac.epoch_padded(tp, ttc, td, tpad, te, thp, weights=tw)
        else:
            jp, je = jpf.epoch(jp, jtc, jd, je, jhp, weights=jw)
            tp, te = parafac.epoch(tp, ttc, td, te, thp, weights=tw)
    for a, b in zip(tp, jp):
        _close(a, b)
    _close(te, je, atol=E_ATOL)


@pytest.mark.parametrize("fused", [False, True])
def test_tucker_weighted_epochs_match_reference(fused):
    jtc, jd, ttc, td = _problem(seed=53)
    kw = dict(k1=2, k2=3, k3=2, alpha0=0.3, l2=0.05, l2_core=0.02, block_k=2)
    jhp, thp = jtk.TuckerHyperParams(**kw), tucker.TuckerHyperParams(**kw)
    f = _factors(54, [(5, 2), (4, 3), (6, 2), (2, 3, 2)])
    jp = jtk.TuckerParams(*map(jnp.asarray, f))
    tp = tucker.params_from_numpy(*f, device="cpu")
    wts = _weights(55, jd.nnz)
    jw, tw = jnp.asarray(wts), _t(wts)
    je, te = jtk.residuals(jp, jtc, jd), tucker.residuals(tp, ttc, td)
    jpad, tpad = jtk.pad_tensor_groups(jtc, jd), tucker.pad_tensor_groups(ttc, td)
    for _ in range(2):
        if fused:
            jp, je = jtk.epoch_padded(jp, jtc, jd, jpad, je, jhp, weights=jw)
            tp, te = tucker.epoch_padded(tp, ttc, td, tpad, te, thp, weights=tw)
        else:
            jp, je = jtk.epoch(jp, jtc, jd, je, jhp, weights=jw)
            tp, te = tucker.epoch(tp, ttc, td, te, thp, weights=tw)
    for a, b in zip(tp, jp):
        _close(a, b, TUCKER_RTOL, TUCKER_ATOL)
    _close(te, je, TUCKER_RTOL, TUCKER_ATOL)


@pytest.mark.parametrize("kind", ["rotating", "randomized"])
@pytest.mark.parametrize("model", ["parafac", "tucker"])
def test_scheduled_epochs_match_reference(model, kind):
    """Two flat epochs (sweep index 0 and 1) under a rotating or a
    randomized schedule of 1-column blocks, repeats (1, 2)."""
    jtc, jd, ttc, td = _problem(seed=56)
    sched = dict(kind=kind, block=1, repeats=(1, 2), seed=3)
    js, ts = jsweeps.SweepSchedule(**sched), sweeps.SweepSchedule(**sched)
    if model == "parafac":
        jm, tm, rtol, atol = jpf, parafac, RTOL, ATOL
        kw = dict(k=3, alpha0=0.3, l2=0.05)
        jhp, thp = jpf.PARAFACHyperParams(**kw), parafac.PARAFACHyperParams(**kw)
        jp, tp = _parafac_params(57, jtc, jd.n_items, 3)
    else:
        jm, tm, rtol, atol = jtk, tucker, TUCKER_RTOL, TUCKER_ATOL
        kw = dict(k1=2, k2=2, k3=3, alpha0=0.3, l2=0.05, l2_core=0.02)
        jhp, thp = jtk.TuckerHyperParams(**kw), tucker.TuckerHyperParams(**kw)
        f = _factors(57, [(5, 2), (4, 2), (6, 3), (2, 2, 3)])
        jp = jtk.TuckerParams(*map(jnp.asarray, f))
        tp = tucker.params_from_numpy(*f, device="cpu")
    je, te = jm.residuals(jp, jtc, jd), tm.residuals(tp, ttc, td)
    for sweep in range(2):
        jp, je = jm.epoch(jp, jtc, jd, je, jhp, js, sweep)
        tp, te = tm.epoch(tp, ttc, td, te, thp, ts, sweep)
    for a, b in zip(tp, jp):
        _close(a, b, rtol, atol)
    _close(te, je, rtol, atol if model == "tucker" else E_ATOL)


def test_parafac_fit_with_schedule_and_weights_matches_reference():
    jtc, jd, ttc, td = _problem(seed=58)
    kw = dict(k=3, alpha0=0.3, l2=0.05)
    jp, tp = _parafac_params(59, jtc, jd.n_items, 3)
    sched = dict(kind="rotating", block=2)
    wts = _weights(60, jd.nnz)
    got = parafac.fit(tp, ttc, td, parafac.PARAFACHyperParams(**kw), 3,
                      schedule=sweeps.SweepSchedule(**sched), weights=_t(wts))
    want = jpf.fit(jp, jtc, jd, jpf.PARAFACHyperParams(**kw), 3,
                   schedule=jsweeps.SweepSchedule(**sched),
                   weights=jnp.asarray(wts))
    for a, b in zip(got, want):
        _close(a, b)


# ------------------------------------------------------------- Tucker ---
@pytest.mark.parametrize("fused,extra", [
    pytest.param(False, {}, id="False"),
    pytest.param(True, {}, id="True"),
    *(pytest.param(True, dict(extra, psi_dispatch=route),
                   id=f"True-{route}-{tag}")
      for tag, extra in (("eta0.7", dict(eta=0.7)),
                         ("l2_core0", dict(l2_core=0.0)))
      for route in ("gather", "pregather"))])
@pytest.mark.parametrize("block_k", [0, 2])
def test_tucker_epochs_match_reference(fused, extra, block_k):
    """Two epochs at non-divisible mode ranks (k1, k2, k3) = (3, 2, 4); the
    fused ones also in each Ψ routing at η 0.7 and at l2_core 0."""
    jtc, jd, ttc, td = _problem(seed=16)
    k1, k2, k3 = 3, 2, 4
    kw = dict(k1=k1, k2=k2, k3=k3, alpha0=0.3, l2=0.05, l2_core=0.02,
              block_k=block_k)
    kw.update(extra)
    jhp, thp = jtk.TuckerHyperParams(**kw), tucker.TuckerHyperParams(**kw)
    f = _factors(17, [(5, k1), (4, k2), (6, k3), (k1, k2, k3)])
    jp = jtk.TuckerParams(*map(jnp.asarray, f))
    tp = tucker.params_from_numpy(*f, device="cpu")
    je, te = jtk.residuals(jp, jtc, jd), tucker.residuals(tp, ttc, td)
    jpad, tpad = jtk.pad_tensor_groups(jtc, jd), tucker.pad_tensor_groups(ttc, td)
    for _ in range(2):
        if fused:
            jp, je = jtk.epoch_padded(jp, jtc, jd, jpad, je, jhp)
            tp, te = tucker.epoch_padded(tp, ttc, td, tpad, te, thp)
        else:
            jp, je = jtk.epoch(jp, jtc, jd, je, jhp)
            tp, te = tucker.epoch(tp, ttc, td, te, thp)
    for a, b in zip(tp, jp):
        _close(a, b, TUCKER_RTOL, TUCKER_ATOL)
    _close(te, je, TUCKER_RTOL, TUCKER_ATOL)
    _close(tucker.objective(tp, ttc, td, thp), jtk.objective(jp, jtc, jd, jhp),
           rtol=TUCKER_RTOL)
    c1, c2, it = np.array([0, 4]), np.array([3, 1]), np.array([2, 5])
    _close(tucker.build_phi(tp, c1, c2), jtk.build_phi(jp, c1, c2),
           TUCKER_RTOL, TUCKER_ATOL)
    _close(tucker.predict(tp, c1, c2, it), jtk.predict(jp, c1, c2, it),
           TUCKER_RTOL, TUCKER_ATOL)


def _index_add_item_sweep(h, j_c, ctx_col, data, e, *, alpha0, l2, eta,
                          schedule=None, sweep_index=0):
    """The tensor models' item sweep as it was before the sums by sorted
    row: each of the two sums ``zeros`` + ``index_add_`` over
    ``data.t_item``."""
    e_t = sweeps.to_item_major(e, data.t_perm)
    alpha_t = sweeps.to_item_major(data.alpha, data.t_perm)

    def body(f, carry):
        w_m, e_t = carry
        o_col = ctx_col(f)[data.t_ctx]
        w_col = w_m[:, f]
        lp = torch.zeros(data.n_items).index_add_(0, data.t_item, alpha_t * e_t * o_col)
        lpp = torch.zeros(data.n_items).index_add_(0, data.t_item,
                                                   alpha_t * o_col * o_col)
        rp = w_m @ j_c[:, f]
        delta = sweeps.newton_delta(
            sweeps.NewtonParts(lp + alpha0 * rp, lpp + alpha0 * j_c[f, f]), w_col,
            l2, eta)
        e_t = e_t + delta[data.t_item] * o_col
        w_m[:, f] = w_col + delta
        return w_m, e_t

    h, e_t = sweeps.sweep_columns(h.shape[1], body, (h, e_t), schedule=schedule,
                                  sweep_index=sweep_index)
    return h, sweeps.to_ctx_major(e_t, data.t_perm)


@pytest.mark.parametrize("schedule", [None, sweeps.SweepSchedule(kind="rotating", block=1,
                                                                 repeats=(1, 2))])
@pytest.mark.parametrize("model", ["parafac", "parafac-dense", "tucker"])
def test_flat_epochs_equal_the_index_add_item_sweep_bit_for_bit(model, schedule,
                                                                monkeypatch):
    """On the CPU the sums by sorted row are ``index_add_`` over the same
    rows, so two weighted flat epochs through ``sweeps.item_side_sweep``
    equal, bit for bit, the same epochs through the item sweep the tensor
    models had before it."""
    _, _, tc, data = _problem(seed=60)
    wts = _t(_weights(61, data.nnz))
    if model == "tucker":
        hp = tucker.TuckerHyperParams(k1=3, k2=2, k3=4, alpha0=0.3, l2=0.05,
                                      l2_core=0.02)
        mod, params = tucker, tucker.params_from_numpy(
            *_factors(62, [(5, 3), (4, 2), (6, 4), (3, 2, 4)]), device="cpu")
    else:
        hp = parafac.PARAFACHyperParams(k=4, alpha0=0.3, l2=0.05,
                                        dense_context=model == "parafac-dense")
        mod, params = parafac, _parafac_params(62, tc, data.n_items, 4)[1]

    def run():
        p, e = params, mod.residuals(params, tc, data)
        for ep in range(2):
            p, e = mod.epoch(p, tc, data, e, hp, schedule, ep, weights=wts)
        return (*p, e)

    got = run()
    monkeypatch.setattr(sweeps, "item_side_sweep", _index_add_item_sweep)
    want = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -------------------------------------------------------------- CtxMF ---
def _ctx_problem(seed=20, n_users=9, n_items=11, n_events=60, n_buckets=4):
    rng = np.random.default_rng(seed)
    cells = rng.choice(n_users * n_items, size=n_events, replace=False)
    user, item = cells // n_items, cells % n_items
    bucket = ctxmf.seasonal_buckets(rng.uniform(0.0, 1000.0, n_events),
                                    n_buckets, period=250.0)
    y = rng.integers(1, 4, size=n_events).astype(np.float64)
    alpha = 1.3 + rng.random(n_events)
    tc, pair = ctxmf.build_context(user, bucket, n_users, n_buckets,
                                   device="cpu")
    jtc, _ = jctxmf.build_context(user, bucket, n_users, n_buckets)
    args = (pair, item, y, alpha, tc.n_ctx, n_items)
    return (jtc, jbuild(*args, alpha0=0.3), tc,
            build_interactions(*args, alpha0=0.3, device="cpu"))


def test_ctxmf_epoch_padded_matches_reference():
    jtc, jd, ttc, td = _ctx_problem()
    kw = dict(k=3, alpha0=0.3, l2=0.05, block_k=2)
    jhp, thp = jctxmf.CtxMFHyperParams(**kw), ctxmf.CtxMFHyperParams(**kw)
    jp, tp = _parafac_params(21, jtc, jd.n_items, 3)
    jpad, tpad = jctxmf.pad_tensor_groups(jtc, jd), ctxmf.pad_tensor_groups(ttc, td)
    je, te = jctxmf.residuals(jp, jtc, jd), ctxmf.residuals(tp, ttc, td)
    for _ in range(2):
        jp, je = jctxmf.epoch_padded(jp, jtc, jd, jpad, je, jhp)
        tp, te = ctxmf.epoch_padded(tp, ttc, td, tpad, te, thp)
    for a, b in zip(tp, jp):
        _close(a, b)
    _close(te, je, atol=E_ATOL)
    _close(ctxmf.objective(tp, ttc, td, thp), jctxmf.objective(jp, jtc, jd, jhp),
           rtol=RTOL)
    u, b = np.array([0, 3]), np.array([1, 0])
    _close(ctxmf.build_phi(tp, u, b), jctxmf.build_phi(jp, u, b), rtol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_ctxmf_weights_within_the_port(fused):
    """weights=w equals training on α·w, and weights=None equals
    weights=ones, exactly."""
    _, _, tc, data = _ctx_problem(seed=22)
    hp = ctxmf.CtxMFHyperParams(k=3, alpha0=0.3, l2=0.05, block_k=2)
    _, params = _parafac_params(23, tc, data.n_items, 3)
    w = torch.as_tensor(np.random.default_rng(7).uniform(0.5, 2.0, data.nnz),
                        dtype=torch.float32)
    data_pre = dataclasses.replace(data, alpha=data.alpha * w)

    def run(d, **kw):
        e = ctxmf.residuals(params, tc, d)
        if fused:
            return ctxmf.epoch_padded(params, tc, d,
                                      ctxmf.pad_tensor_groups(tc, d), e, hp,
                                      **kw)[0]
        return ctxmf.epoch(params, tc, d, e, hp, **kw)[0]

    got, ref = run(data, weights=w), run(data_pre)
    ones, none = run(data, weights=torch.ones(data.nnz)), run(data)
    for a, b, c, d in zip(got, ref, ones, none):
        assert torch.equal(a, b) and torch.equal(c, d)


# -------------------------------------------- row-patch kernel wrappers ---
def _rowpatch_case(seed, c=13, d=40, kb=3, n_src=30):
    rng = np.random.default_rng(seed)
    alpha = (rng.random((c, d)) * 3 + 0.5).astype(np.float32)
    ids = rng.integers(0, n_src, (c, d)).astype(np.int32)
    pad = rng.random((c, d)) < 0.4
    alpha[pad], ids[pad] = 0, n_src - 1
    tab = (0.3 * rng.normal(size=(n_src, kb))).astype(np.float32)
    tab[-1] = 0  # the zero sentinel row
    k = rng.normal(size=(c, kb, kb)).astype(np.float32)
    p = (k @ k.transpose(0, 2, 1) + np.eye(kb, dtype=np.float32)).astype(np.float32)
    return dict(tab=tab, ids=ids, alpha=alpha, p=p,
                e=rng.normal(size=(c, d)).astype(np.float32),
                w=(0.3 * rng.normal(size=(c, kb))).astype(np.float32),
                r1=rng.normal(size=(c, kb)).astype(np.float32),
                wts=rng.uniform(0.5, 2.0, (c, d)).astype(np.float32))


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_rowpatch_wrappers_match_jax_kernels(gather, weighted):
    """The port's row-patch wrappers (plain versions on the CPU) against
    the JAX package's Pallas kernels in interpret mode, both routings, with
    and without per-interaction weights folded into α."""
    x = _rowpatch_case(30 + 2 * gather + weighted)
    kw = dict(alpha0=0.6, l2=0.1, eta=0.9)
    alpha_j = x["alpha"] * x["wts"] if weighted else x["alpha"]
    wts = _t(x["wts"]) if weighted else None
    psi = x["tab"][x["ids"]].transpose(0, 2, 1).copy()
    e = _t(x["e"]).clone()
    if gather:
        w, e2 = ops.cd_block_sweep_rowpatch_gather(
            _t(x["tab"]), _t(x["ids"]), _t(x["alpha"]), e, _t(x["w"]),
            _t(x["r1"]), _t(x["p"]), weights=wts, **kw)
        jw, je = cd_block_sweep_rowpatch_gather_pallas(
            *map(jnp.asarray, (x["tab"], x["ids"], alpha_j, x["e"], x["w"],
                               x["r1"], x["p"])), block_ctx=8, interpret=True,
            **kw)
    else:
        w, e2 = ops.cd_block_sweep_rowpatch(
            _t(psi), _t(x["alpha"]), e, _t(x["w"]), _t(x["r1"]), _t(x["p"]),
            weights=wts, **kw)
        jw, je = cd_block_sweep_rowpatch_pallas(
            *map(jnp.asarray, (psi, alpha_j, x["e"], x["w"], x["r1"], x["p"])),
            block_ctx=8, interpret=True, **kw)
    assert e2 is e  # in place on every device
    _close(w, jw, SWEEP_RTOL, SWEEP_ATOL)
    _close(e, je, SWEEP_RTOL, SWEEP_ATOL)


def test_rowpatch_with_one_patch_for_every_row_is_the_shared_sweep():
    """A patch of row stride 0 (dense context) is the shared-Gram sweep."""
    x = _rowpatch_case(40)
    p0 = _t(x["p"][0])
    args = (_t(x["tab"]), _t(x["ids"]), _t(x["alpha"]))
    kw = dict(alpha0=0.6, l2=0.1)
    e1, e2 = _t(x["e"]).clone(), _t(x["e"]).clone()
    w1, _ = ops.cd_block_sweep_rowpatch_gather(
        *args, e1, _t(x["w"]), _t(x["r1"]), p0.expand(13, 3, 3), **kw)
    w2, _ = ops.cd_block_sweep_gather(*args, e2, _t(x["w"]), _t(x["r1"]), p0,
                                      **kw)
    assert torch.equal(w1, w2) and torch.equal(e1, e2)


# ------------------------------------------ split-row sweep, the algebra ---
def _split_row_sweep(psi_tab, ids, alpha, e, w, r1, cpl, *, alpha0, l2, eta,
                     chunk):
    """The split-row form of ``csrc/cd_gather.cu`` in torch, from its
    contract: pass 1 sums Q_j = Σ_d α·e·ψ_j and G_ij = Σ_d α·ψ_i·ψ_j chunk
    by chunk (``chunk`` slots each) and adds the chunks in order; the solve
    runs L'_j/2 = Q_j + Σ_{i<j} Δ_i·G_ij, L''_j/2 = G_jj, R'_j = R'_j +
    Σ_{i<j} Δ_i·P(i, j) and Δ_j = −η·(L'_j/2 + α₀R'_j + λw_j) /
    max(L''_j/2 + α₀P(j, j) + λ, 1e-12); pass 2 adds Σ_j Δ_j·ψ_j to e once,
    in j order. ``cpl`` is the (C, k_b, k_b) patch or one (k_b, k_b) J."""
    psi = ref.gather_psi_blk(psi_tab, ids)                  # (C, k_b, D)
    c, kb, d = psi.shape
    p = cpl.expand(c, kb, kb) if cpl.dim() == 2 else cpl
    q = torch.zeros((c, kb))
    g = torch.zeros((c, kb, kb))
    for d0 in range(0, d, chunk):
        sl = slice(d0, d0 + chunk)
        a, ps = alpha[:, None, sl], psi[:, :, sl]
        q = q + (a * e[:, None, sl] * ps).sum(-1)
        g = g + torch.einsum("cid,cjd->cij", a * ps, ps)
    deltas, w_new = [], w.clone()
    for j in range(kb):
        lp, r1j = q[:, j].clone(), r1[:, j].clone()
        for i in range(j):
            lp = lp + deltas[i] * g[:, i, j]
            r1j = r1j + deltas[i] * p[:, i, j]
        num = lp + alpha0 * r1j + l2 * w[:, j]
        den = g[:, j, j] + alpha0 * p[:, j, j] + l2
        deltas.append(-eta * num / torch.clamp(den, min=1e-12))
        w_new[:, j] = w[:, j] + deltas[j]
    e_new = e.clone()
    for j in range(kb):
        e_new = e_new + deltas[j][:, None] * psi[:, j, :]
    return w_new, e_new


@pytest.mark.parametrize("kb,d,chunk,shared", [
    (3, 40, 16, False),    # rows of 2½ chunks
    (8, 37, 8, False),     # k_b = 8, a chunk of 5 slots last
    (1, 50, 64, False),    # k_b = 1, one chunk
    (4, 33, 10, True),     # one J for every row (cs0 = 0)
])
def test_split_row_algebra_matches_the_sweep(kb, d, chunk, shared):
    """The two-pass algebra against the plain row-patch sweep and the
    reference's Pallas kernel (interpret mode) on the same inputs, rows
    with α = 0 and P = 0 keeping W at l2 = α₀ = 0, and ids past the slab
    clipped: to the row-patch sweeps' rtol 2e-5 / atol 2e-6."""
    x = _rowpatch_case(70 + kb + d, d=d, kb=kb)
    x["alpha"][:3] = 0
    x["p"][:3] = 0
    x["ids"][3:, :2] = [-5, 1000]
    args = [_t(x[n]) for n in ("tab", "ids", "alpha", "e", "w", "r1", "p")]
    if shared:
        args[-1] = args[-1][5]
    for alpha0, l2 in ((0.6, 0.1), (0.0, 0.0)):
        kw = dict(alpha0=alpha0, l2=l2, eta=0.9)
        w, e = _split_row_sweep(*args, chunk=chunk, **kw)
        plain = (ref.cd_block_sweep_gather_ref if shared else
                 ref.cd_block_sweep_rowpatch_gather_ref)
        rw, re = plain(*args, **kw)
        _close(w, rw, SWEEP_RTOL, SWEEP_ATOL)
        _close(e, re, SWEEP_RTOL, SWEEP_ATOL)
        p = x["p"][5:6].repeat(len(x["p"]), 0) if shared else x["p"]
        jw, je = cd_block_sweep_rowpatch_gather_pallas(
            *map(jnp.asarray, (x["tab"], x["ids"], x["alpha"], x["e"], x["w"],
                               x["r1"], p)), block_ctx=8, interpret=True, **kw)
        _close(w, jw, SWEEP_RTOL, SWEEP_ATOL)
        _close(e, je, SWEEP_RTOL, SWEEP_ATOL)
        if l2 == 0 and not shared:
            _eq(w[:3], x["w"][:3])


def test_split_row_form_takes_the_long_gather_rows():
    """The tensor models' long context rows (CtxMF's hour-of-day buckets)
    take the split-row form in both routings, the gather one and the
    pre-gathered one; short rows take the register-row form; the shared-J
    pre-gathered sweep (one J for every row) keeps the block-row form."""
    assert vmem.cd_sweep_form(142_464, 8, gather=True, rowpatch=True) == vmem.SPLIT_ROW
    assert vmem.cd_sweep_form(142_464, 8, gather=False, rowpatch=True) == vmem.SPLIT_ROW
    assert vmem.cd_sweep_form(142_464, 8, gather=False) == vmem.BLOCK_ROW
    assert vmem.cd_sweep_form(128, 8, gather=True, rowpatch=True) == vmem.REG_ROW
    assert vmem.cd_sweep_form(128, 8, gather=False, rowpatch=True) == vmem.REG_ROW
