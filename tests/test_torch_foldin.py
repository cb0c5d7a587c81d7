"""The port's closed-form fold-in (``repro_torch.core.foldin`` and the Model
adapters) and its conventional-CD oracle (``repro_torch.core.naive_cd``)
held against the JAX package from the same numpy inputs.

Every zoo model is built in both packages from the same numpy seed, with
the reference's params carried over through each module's
``params_from_numpy``. Tolerances are the reference's own
(``tests/test_foldin.py``, ``tests/test_icd_exact.py``): a converged
fold-in row to rtol 2e-4 / atol 2e-5 of the float64 oracle and of the
reference's row; one sweep against MF's side sweep to rtol 2e-5 / atol
2e-6; the empty-history solve to atol 1e-6; ``mf.epoch`` against
``naive_cd.epoch_dense`` to rtol 2e-4 / atol 2e-5. The two packages'
float64 oracles agree to 1e-6, and their dense CD epochs to rtol 1e-5 /
atol 1e-6 (fp32 products in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import foldin as jfoldin
from repro.core import naive_cd as jnaive
from repro.core.gram import gram as jgram
from repro.core.models import mf as jmf
from repro.core.models import zoo as jzoo
from repro.core.models.mf import _side_sweep as j_side_sweep
from repro_torch.core import foldin, naive_cd, sweeps
from repro_torch.core.models import fm, mf, mfsi, parafac, tucker, zoo
from repro_torch.sparse.interactions import build_interactions

torch.set_num_threads(1)

FOLD_RTOL, FOLD_ATOL = 2e-4, 2e-5
SWEEP_RTOL, SWEEP_ATOL = 2e-5, 2e-6
EXACT_TRAJ_RTOL, EXACT_TRAJ_ATOL = 2e-4, 2e-5
MODULES = dict(mf=mf, mfsi=mfsi, fm=fm, parafac=parafac, tucker=tucker)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def zoo_pair(name, seed=3):
    """The reference's zoo model and the port's, on the same data and
    params."""
    jmodel, jparams, jquery = jzoo.zoo_model(name, np.random.default_rng(seed))
    model, _, query = zoo.zoo_model(name, np.random.default_rng(seed),
                                    device="cpu")
    params = MODULES[name].params_from_numpy(
        *(np.asarray(a) for a in jparams), device="cpu")
    return (jmodel, jparams, jquery), (model, params, query)


def _history(rng, n, m=7):
    return rng.choice(n, size=min(m, n), replace=False)


@pytest.mark.parametrize("name", zoo.ZOO)
def test_zoo_exports_match_reference(name):
    (jm, jp, jq), (m, p, q) = zoo_pair(name)
    _close(m.export_psi(p), jm.export_psi(jp), 1e-5, 1e-6)
    _close(m.build_phi(p, q), jm.build_phi(jp, jq), 1e-5, 1e-6)
    _close(m.phi_table(p), jm.phi_table(jp), 1e-5, 1e-6)
    assert m._user_free_init().__repr__() == jm._user_free_init().__repr__()
    assert m._item_free_init().__repr__() == jm._item_free_init().__repr__()
    phi, psi = zoo.model_phi_psi(name, np.random.default_rng(3), device="cpu")
    assert phi.shape == tuple(jm.build_phi(jp, jq).shape)
    assert psi.shape == tuple(jm.export_psi(jp).shape)


@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("name", zoo.ZOO)
def test_fold_in_matches_exact_oracle_and_reference(name, side):
    (jm, jp, _), (m, p, _) = zoo_pair(name)
    rng = np.random.default_rng(17 if side == "user" else 23)
    if side == "user":
        table, jtable = m.export_psi(p), np.asarray(jm.export_psi(jp))
        free, init = m._user_free_init()
    else:
        table, jtable = m.phi_table(p), np.asarray(jm.phi_table(jp))
        free, init = m._item_free_init()
    ids = _history(rng, table.shape[0])
    y = rng.integers(1, 4, ids.size).astype(np.float32)
    alpha = (1.0 + rng.random(ids.size)).astype(np.float32)
    fold = m.fold_in_user if side == "user" else m.fold_in_item
    jfold = jm.fold_in_user if side == "user" else jm.fold_in_item
    row = fold(p, ids, y, alpha, n_sweeps=512, tol=1e-9)
    assert row.shape == (table.shape[1],) and row.device.type == "cpu"
    hp = m._foldin_hp()
    exact = foldin.fold_in_exact(table, ids, y, alpha, alpha0=hp["alpha0"],
                                 l2=hp["l2"], free=free, init=init)
    jexact = jfoldin.fold_in_exact(jtable, ids, y, alpha, alpha0=hp["alpha0"],
                                   l2=hp["l2"], free=free, init=init)
    _close(exact, jexact, 1e-6, 1e-6)
    _close(row, exact, FOLD_RTOL, FOLD_ATOL)
    _close(row, jfold(jp, ids, y, alpha, n_sweeps=512, tol=1e-9), FOLD_RTOL,
           FOLD_ATOL)


def test_fold_in_options_match_reference():
    """weights, η < 1, a precomputed Gram, a free mask and the sweep count
    and certificate, against the reference's fold_in_row."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(19, 6)).astype(np.float32)
    ids = rng.choice(19, 9, replace=False)
    y = rng.integers(1, 4, 9).astype(np.float32)
    wts = (0.5 + rng.random(9)).astype(np.float32)
    free = np.array([1, 1, 0, 1, 1, 1], bool)
    init = np.array([0, 0, 0.7, 0, 0, 0], np.float32)
    kw = dict(alpha0=0.4, l2=0.05, eta=0.8, weights=wts, free=free, init=init,
              n_sweeps=200, tol=1e-7)
    want = jfoldin.fold_in_row(table, ids, y, **kw)
    got = foldin.fold_in_row(torch.as_tensor(table), ids, y, **kw)
    g = torch.as_tensor(table).T @ torch.as_tensor(table)
    with_g = foldin.fold_in_row(torch.as_tensor(table), ids, y, gram=g, **kw)
    _close(got.row, want.row, FOLD_RTOL, FOLD_ATOL)
    _close(with_g.row, got.row, 1e-6, 1e-7)
    assert float(got.row[2]) == np.float32(0.7)
    assert got.n_sweeps < 200 and got.delta_max < 1e-7 * (1 + float(got.row.abs().max()))
    assert abs(got.n_sweeps - want.n_sweeps) <= 3
    _close(got.row, foldin.fold_in_exact(table, ids, y, alpha0=0.4, l2=0.05,
                                         weights=wts, free=free, init=init,
                                         device="cpu"),
           FOLD_RTOL, FOLD_ATOL)


def test_fm_fixed_columns_hold():
    """The constant-1 column that pairs with the other side's spec column
    comes out exactly 1 on a folded row; the free spec coordinate moves."""
    (jm, jp, _), (m, p, _) = zoo_pair("fm")
    k = m.hp.k
    u = m.fold_in_user(p, [0, 4, 9])
    i = m.fold_in_item(p, [1, 2])
    assert u.shape == (k + 2,) and i.shape == (k + 2,)
    assert float(u[k + 1]) == 1.0 and float(i[k]) == 1.0
    assert float(u[k]) != 0.0 and float(i[k + 1]) != 0.0
    _close(u, jm.fold_in_user(jp, [0, 4, 9]), FOLD_RTOL, FOLD_ATOL)
    _close(i, jm.fold_in_item(jp, [1, 2]), FOLD_RTOL, FOLD_ATOL)


def test_empty_history_l2_zero_stays_finite():
    """m=0, λ=0: the normal system is singular; the clamp keeps the solve
    finite (the all-zero implicit-prior solution)."""
    table = np.random.default_rng(0).normal(size=(11, 5)).astype(np.float32)
    res = foldin.fold_in_row(table, [], alpha0=0.5, l2=0.0, device="cpu")
    assert bool(torch.isfinite(res.row).all())
    _close(res.row, np.zeros(5), 0, 1e-7)
    _close(res.row, jfoldin.fold_in_row(table, [], alpha0=0.5, l2=0.0).row, 0, 1e-7)
    exact = foldin.fold_in_exact(table, [], alpha0=0.5, l2=0.1, device="cpu")
    _close(exact, jfoldin.fold_in_exact(table, [], alpha0=0.5, l2=0.1), 0, 1e-6)
    _close(foldin.fold_in_row(table, [], alpha0=0.5, l2=0.1, device="cpu").row,
           exact, 0, 1e-6)
    # a table with a zero column at λ = 0: that coordinate's step is 0/clamp
    table[:, 2] = 0
    res = foldin.fold_in_row(table, [1, 3], alpha0=0.5, l2=0.0, device="cpu")
    assert bool(torch.isfinite(res.row).all()) and float(res.row[2]) == 0.0


def test_one_sweep_matches_mf_side_sweep_single_row():
    """fold_in_row with n_sweeps=1 IS ``sweeps.side_sweep`` on a (1, k) side:
    the port's fold-in against the port's and the reference's side sweeps
    and the reference's one-sweep fold-in."""
    rng = np.random.default_rng(5)
    n_items, k, m = 13, 6, 8
    h = rng.normal(size=(n_items, k)).astype(np.float32)
    ids = rng.choice(n_items, size=m, replace=False)
    y = rng.integers(1, 4, m).astype(np.float32)
    alpha = (1.0 + rng.random(m)).astype(np.float32)
    hp = mf.MFHyperParams(k=k, alpha0=0.4, l2=0.07)
    got = foldin.fold_in_row(h, ids, y, alpha, alpha0=hp.alpha0, l2=hp.l2,
                             eta=hp.eta, n_sweeps=1, device="cpu")
    assert got.n_sweeps == 1
    th = torch.as_tensor(h)
    side, _ = sweeps.side_sweep(
        torch.zeros((1, k)), th.T @ th, lambda f: th[torch.as_tensor(ids), f],
        torch.zeros(m, dtype=torch.long), torch.tensor([0, m]),
        torch.as_tensor(alpha), torch.as_tensor(-y), alpha0=hp.alpha0, l2=hp.l2,
        eta=hp.eta)
    _close(got.row, side[0], SWEEP_RTOL, SWEEP_ATOL)
    hj = jnp.asarray(h)
    jside, _ = j_side_sweep(
        jnp.zeros((1, k), jnp.float32), jgram(hj),
        lambda f: hj[jnp.asarray(ids), f], jnp.zeros(m, jnp.int32),
        jnp.asarray(alpha), jnp.asarray(-y), 1, jmf.MFHyperParams(k=k, alpha0=0.4,
                                                                 l2=0.07))
    _close(got.row, jside[0], SWEEP_RTOL, SWEEP_ATOL)
    _close(got.row, jfoldin.fold_in_row(h, ids, y, alpha, alpha0=0.4, l2=0.07,
                                        n_sweeps=1).row, SWEEP_RTOL, SWEEP_ATOL)


def test_fold_in_validation():
    table = np.zeros((4, 3), np.float32)
    cases = [dict(ids=[4]), dict(ids=[-1]), dict(ids=[0], y=np.ones(2)),
             dict(ids=[0], alpha=np.ones(3)), dict(ids=[0], weights=np.ones(2)),
             dict(ids=[0], free=np.ones(2, bool)),
             dict(ids=[0], init=np.zeros(4, np.float32))]
    for kw in cases:
        ids = kw.pop("ids")
        with pytest.raises(ValueError) as want:
            jfoldin.fold_in_row(table, ids, alpha0=1.0, l2=0.1, **kw)
        with pytest.raises(ValueError) as got:
            foldin.fold_in_row(table, ids, alpha0=1.0, l2=0.1, device="cpu",
                               **kw)
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
        with pytest.raises(ValueError):
            foldin.fold_in_exact(table, ids, alpha0=1.0, l2=0.1, device="cpu",
                                 **kw)


# ------------------------------------------------------------ naive_cd ---
def _exact_problem(seed=0, n_ctx=13, n_items=9, nnz=37, alpha0=0.4):
    rng = np.random.default_rng(seed)
    pairs = rng.choice(n_ctx * n_items, size=nnz, replace=False)
    ctx, item = pairs // n_items, pairs % n_items
    y = rng.integers(1, 5, size=nnz).astype(np.float64)
    alpha = alpha0 + 1.0 + rng.random(nnz)
    return ctx, item, y, alpha, n_ctx, n_items, alpha0


@pytest.mark.parametrize("k", [1, 3, 8])
def test_mf_epoch_matches_naive_cd_and_reference(k):
    ctx, item, y, alpha, n_ctx, n_items, a0 = _exact_problem()
    data = build_interactions(ctx, item, y, alpha, n_ctx, n_items, alpha0=a0,
                              device="cpu")
    yd, ad = naive_cd.dense_from_observed(
        ctx, item, torch.as_tensor(y, dtype=torch.float32), alpha, n_ctx,
        n_items, a0)
    jyd, jad = jnaive.dense_from_observed(
        jnp.asarray(ctx), jnp.asarray(item), jnp.asarray(y, jnp.float32),
        jnp.asarray(alpha, jnp.float32), n_ctx, n_items, a0)
    _close(yd, jyd, 0, 0)
    _close(ad, jad, 0, 0)
    rng = np.random.default_rng(k)
    w0 = (0.1 * rng.normal(size=(n_ctx, k))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(n_items, k))).astype(np.float32)
    hp = mf.MFHyperParams(k=k, alpha0=a0, l2=0.05)
    params = naive = mf.params_from_numpy(w0, h0, device="cpu")
    jnaive_p = jmf.MFParams(jnp.asarray(w0), jnp.asarray(h0))
    e = mf.residuals(params, data)
    for _ in range(3):
        params, e = mf.epoch(params, data, e, hp)
        naive = naive_cd.epoch_dense(naive, yd, ad, hp)
        jnaive_p = jnaive.epoch_dense(jnaive_p, jyd, jad,
                                      jmf.MFHyperParams(k=k, alpha0=a0, l2=0.05))
        _close(params.w, naive.w, EXACT_TRAJ_RTOL, EXACT_TRAJ_ATOL)
        _close(params.h, naive.h, EXACT_TRAJ_RTOL, EXACT_TRAJ_ATOL)
        _close(naive.w, jnaive_p.w, 1e-5, 1e-6)
        _close(naive.h, jnaive_p.h, 1e-5, 1e-6)


def test_naive_cd_mfsi_and_flops_match_reference():
    from repro.core import design as jdesign
    from repro.core.models import mfsi as jmfsi
    from repro_torch.core import design

    rng = np.random.default_rng(2)
    n_ctx, n_items, k = 7, 5, 2
    cf = [dict(name="a", ids=rng.integers(0, 3, n_ctx), vocab=3),
          dict(name="b", ids=rng.integers(0, 2, n_ctx), vocab=2)]
    itf = [dict(name="i", ids=np.arange(n_items), vocab=n_items)]
    jx, jz = jdesign.make_design(cf, n_ctx), jdesign.make_design(itf, n_items)
    x = design.make_design(cf, n_ctx, device="cpu")
    z = design.make_design(itf, n_items, device="cpu")
    yd = rng.integers(0, 3, (n_ctx, n_items)).astype(np.float32)
    ad = (0.3 + rng.random((n_ctx, n_items))).astype(np.float32)
    w0 = (0.1 * rng.normal(size=(x.p, k))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(z.p, k))).astype(np.float32)
    slices = tuple((f.offset, f.vocab) for f in x.fields)
    islices = tuple((f.offset, f.vocab) for f in z.fields)
    got = naive_cd.epoch_dense_mfsi(
        mfsi.params_from_numpy(w0, h0, device="cpu"), design.to_dense(x),
        design.to_dense(z), slices, islices, torch.as_tensor(yd),
        torch.as_tensor(ad), mfsi.MFSIHyperParams(k=k, l2=0.05))
    want = jnaive.epoch_dense_mfsi(
        jmfsi.MFSIParams(jnp.asarray(w0), jnp.asarray(h0)), jdesign.to_dense(jx),
        jdesign.to_dense(jz), slices, islices, jnp.asarray(yd), jnp.asarray(ad),
        jmfsi.MFSIHyperParams(k=k, l2=0.05))
    _close(got.w, want.w, 1e-5, 1e-6)
    _close(got.h, want.h, 1e-5, 1e-6)
    for args in ((200_000, 68_000, 128), (13, 9, 3)):
        assert naive_cd.flops_per_epoch_dense(*args) == jnaive.flops_per_epoch_dense(*args)
    assert naive_cd.flops_per_epoch_icd(200_000, 68_000, 3_399_385, 128) == \
        jnaive.flops_per_epoch_icd(200_000, 68_000, 3_399_385, 128)
