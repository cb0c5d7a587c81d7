"""The port's baselines (``repro_torch.core.ials``, ``repro_torch.core.bpr``)
held against the JAX package from the same numpy factors and draws: an
iALS epoch to rtol 1e-4 / atol 1e-5 (the port builds the systems a block
of rows at a time, the reference from one (nnz, k, k) tensor), iALS within
5% of iCD's objective after 25 epochs (the reference test's claim), BPR
steps array-close (rtol 1e-5, atol 1e-6), a batch of repeated ids that
``index_add_`` must sum, and ``bpr.fit``'s numpy draws."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bpr as jbpr
from repro.core import ials as jials
from repro.core.models import mf as jmf
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.core import bpr, ials
from repro_torch.core.models import mf
from repro_torch.sparse.interactions import build_interactions

torch.set_num_threads(1)

IALS_RTOL, IALS_ATOL = 1e-4, 1e-5
BPR_RTOL, BPR_ATOL = 1e-5, 1e-6


def make_problem(seed=0, n_ctx=40, n_items=30, k_true=4, nnz=300, alpha0=0.5):
    """tests/test_baselines.py's problem: consumption where ⟨w,h⟩ is large."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(n_ctx, k_true)) @ rng.normal(size=(n_items, k_true)).T
    flat = np.argsort(-s.ravel())[:nnz]
    ctx, item = flat // n_items, flat % n_items
    args = (ctx, item, np.ones(nnz), np.full(nnz, alpha0 + 2.0), n_ctx, n_items)
    return (build_interactions(*args, alpha0=alpha0, device="cpu"),
            jbuild(*args, alpha0=alpha0), ctx, item)


def _factors(seed, n_ctx, n_items, k):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=(n_ctx, k)).astype(np.float32),
            0.1 * rng.normal(size=(n_items, k)).astype(np.float32))


def _close(got, want, rtol, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("k,l2,alpha0", [(6, 0.1, 0.5), (3, 0.0, 0.5), (8, 0.05, 0.25)])
def test_ials_epoch_equals_reference(k, l2, alpha0):
    data, jdata, _, _ = make_problem(alpha0=max(alpha0, 0.5))
    w, h = _factors(1, data.n_ctx, data.n_items, k)
    hp = ials.IALSHyperParams(k=k, alpha0=alpha0, l2=l2)
    jhp = jials.IALSHyperParams(k=k, alpha0=alpha0, l2=l2)
    got = mf.params_from_numpy(w, h, device="cpu")
    want = jmf.MFParams(jnp.asarray(w), jnp.asarray(h))
    for _ in range(2):
        got, want = ials.epoch(got, data, hp), jials.epoch(want, jdata, jhp)
        _close(got, want, IALS_RTOL, IALS_ATOL)


def _ials_side64(other, rows, cols, y, alpha, n_rows, alpha0, l2):
    """One side's exact solve in float64, row by row (the oracle)."""
    k = other.shape[1]
    out = np.zeros((n_rows, k))
    for r in range(n_rows):
        sel = rows == r
        hh = other[cols[sel]]
        a = alpha0 * other.T @ other + l2 * np.eye(k) + (alpha[sel, None] * hh).T @ hh
        out[r] = np.linalg.solve(a, (alpha[sel] * y[sel]) @ hh)
    return out


def test_ials_ill_conditioned_side_as_close_to_float64_as_reference():
    """α₀ = 0 leaves an item row with fewer interactions than k nearly
    singular (cond ≈ 2e4 here): fp32 solves then land ≈ 4e-5 from the
    float64 solution, the port's as far as the reference's, so the two
    are held to that oracle, not to each other."""
    data, jdata, _, _ = make_problem()
    w, h = _factors(1, data.n_ctx, data.n_items, 8)
    hp = ials.IALSHyperParams(k=8, alpha0=0.0, l2=0.05)
    got = ials.epoch(mf.params_from_numpy(w, h, device="cpu"), data, hp)
    want = jials.epoch(jmf.MFParams(jnp.asarray(w), jnp.asarray(h)), jdata,
                       jials.IALSHyperParams(k=8, alpha0=0.0, l2=0.05))
    t = data.t_perm.numpy()
    y, a = data.y.double().numpy(), data.alpha.double().numpy()
    errs = []
    for p in (got, want):
        pw = np.asarray(p.w, np.float64)
        w64 = _ials_side64(h.astype(np.float64), data.ctx.numpy(), data.item.numpy(),
                           y, a, data.n_ctx, 0.0, 0.05)
        h64 = _ials_side64(pw, data.t_item.numpy(), data.t_ctx.numpy(), y[t], a[t],
                           data.n_items, 0.0, 0.05)
        errs.append((np.abs(pw - w64).max(), np.abs(np.asarray(p.h) - h64).max()))
    (port_w, port_h), (ref_w, ref_h) = errs
    assert port_w <= 2 * ref_w + 1e-6 and port_h <= 2 * ref_h + 1e-6, errs


def test_ials_blocks_of_rows_equal_one_block(monkeypatch):
    """Blocks of rows and slices of observations that split rows between
    them give the systems of one block."""
    data, _, _, _ = make_problem(seed=2)
    w, h = _factors(3, data.n_ctx, data.n_items, 5)
    hp = ials.IALSHyperParams(k=5, alpha0=0.5, l2=0.1)
    one = ials.epoch(mf.params_from_numpy(w, h, device="cpu"), data, hp)
    monkeypatch.setattr(ials, "_ROW_CHUNK", 7)
    monkeypatch.setattr(ials, "_OBS_CHUNK", 5)
    many = ials.epoch(mf.params_from_numpy(w, h, device="cpu"), data, hp)
    for a, b in zip(many, one):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_ials_and_icd_reach_similar_objective():
    """The reference test's claim, on the port: from one start, 25 epochs
    of iALS and of iCD reach objectives within 5%; the port's iALS also
    stays within IALS_RTOL of the reference's there."""
    data, jdata, _, _ = make_problem()
    k = 6
    w, h = _factors(0, data.n_ctx, data.n_items, k)
    hp_cd = mf.MFHyperParams(k=k, alpha0=0.5, l2=0.1)
    p0 = mf.params_from_numpy(w, h, device="cpu")
    p_cd = mf.fit(p0, data, hp_cd, n_epochs=25)
    p_als = ials.fit(p0, data, ials.IALSHyperParams(k=k, alpha0=0.5, l2=0.1), 25)
    o_cd = float(mf.objective(p_cd, data, hp_cd))
    o_als = float(mf.objective(p_als, data, hp_cd))
    assert abs(o_cd - o_als) / max(o_als, 1e-9) < 0.05, (o_cd, o_als)
    j_als = jials.fit(jmf.MFParams(jnp.asarray(w), jnp.asarray(h)), jdata,
                      jials.IALSHyperParams(k=k, alpha0=0.5, l2=0.1), 25)
    o_ref = float(jmf.objective(j_als, jdata, jmf.MFHyperParams(k=k, alpha0=0.5,
                                                                l2=0.1)))
    assert o_als == pytest.approx(o_ref, rel=IALS_RTOL)


def _bpr_batch(rng, n_ctx, n_items, b):
    return (rng.integers(0, n_ctx, b), rng.integers(0, n_items, b),
            rng.integers(0, n_items, b))


@pytest.mark.parametrize("k,lr,l2", [(8, 0.1, 0.002), (4, 0.05, 0.0)])
def test_bpr_steps_equal_reference(k, lr, l2):
    n_ctx, n_items = 40, 30
    w, h = _factors(4, n_ctx, n_items, k)
    hp = bpr.BPRHyperParams(k=k, lr=lr, l2=l2, batch=64)
    jhp = jbpr.BPRHyperParams(k=k, lr=lr, l2=l2, batch=64)
    got = mf.params_from_numpy(w, h, device="cpu")
    want = jmf.MFParams(jnp.asarray(w), jnp.asarray(h))
    rng = np.random.default_rng(5)
    for _ in range(10):
        c, p, n = _bpr_batch(rng, n_ctx, n_items, 64)
        got, loss = bpr.step(got, torch.as_tensor(c), torch.as_tensor(p),
                             torch.as_tensor(n), hp)
        want, jloss = jbpr.step(want, jnp.asarray(c), jnp.asarray(p),
                                jnp.asarray(n), jhp)
        _close(got, want, BPR_RTOL, BPR_ATOL)
        assert float(loss) == pytest.approx(float(jloss), rel=BPR_RTOL)


def test_bpr_repeated_ids_add_up():
    """One context, one positive and one negative, each repeated: every
    copy's update counts (``index_add_``), as the reference's
    ``.at[].add`` sums them; the negative's gradient comes from its row
    before the positive update, also where pos and neg coincide."""
    w, h = _factors(6, 3, 4, 5)
    hp = bpr.BPRHyperParams(k=5, lr=0.3, l2=0.01, batch=6)
    jhp = jbpr.BPRHyperParams(k=5, lr=0.3, l2=0.01, batch=6)
    c, p, n = np.array([1] * 6), np.array([2] * 5 + [0]), np.array([3] * 4 + [2, 2])
    got, _ = bpr.step(mf.params_from_numpy(w, h, device="cpu"),
                      torch.as_tensor(c), torch.as_tensor(p), torch.as_tensor(n), hp)
    want, _ = jbpr.step(jmf.MFParams(jnp.asarray(w), jnp.asarray(h)),
                        jnp.asarray(c), jnp.asarray(p), jnp.asarray(n), jhp)
    _close(got, want, BPR_RTOL, BPR_ATOL)
    # one copy's worth would leave row 1 of W far from the reference's
    once = w[1] - 0.3 * (np.asarray(want.w)[1] - w[1]) / (-0.3 * 6)
    assert not np.allclose(got.w[1].numpy(), once, rtol=1e-3)


def test_bpr_fit_draws_the_reference_batches():
    data, jdata, ctx, item = make_problem(seed=1)
    w, h = _factors(7, data.n_ctx, data.n_items, 8)
    pairs = np.stack([ctx, item], 1)
    hp = bpr.BPRHyperParams(k=8, lr=0.1, batch=128)
    got = bpr.fit(mf.params_from_numpy(w, h, device="cpu"), pairs, data.n_items,
                  hp, n_steps=20, seed=2)
    want = jbpr.fit(jmf.MFParams(jnp.asarray(w), jnp.asarray(h)), pairs,
                    data.n_items, jbpr.BPRHyperParams(k=8, lr=0.1, batch=128),
                    n_steps=20, seed=2)
    _close(got, want, BPR_RTOL, BPR_ATOL)
    # and it learns: training positives outrank random cells on average
    scores = mf.scores_all(bpr.fit(got, pairs, data.n_items, hp, 300, seed=3))
    rng = np.random.default_rng(3)
    rnd = scores[rng.integers(0, data.n_ctx, 500), rng.integers(0, data.n_items, 500)]
    assert float(scores[ctx, item].mean()) > float(rnd.mean()) + 0.3


def test_bpr_init_shapes_and_device():
    gen = torch.Generator().manual_seed(0)
    p = bpr.init(5, 7, 3, generator=gen)
    assert p.w.shape == (5, 3) and p.h.shape == (7, 3)
    assert p.w.device.type == "cpu" and 0.0 < float(p.w.std()) < 0.3
