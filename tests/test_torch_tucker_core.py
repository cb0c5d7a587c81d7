"""Tucker's core sweep by core slab (``kernels/tucker_core``): the blocked
algebra (``ref.core_sweep_slabs_ref``, the CPU path of
``tucker.core_sweep``) against the per-coordinate loop it replaced, kept
here as the oracle, in float64; and on the card the hand-written kernels
against the blocked plain form. This module imports no JAX, so its ``gpu``
tests run on a machine with a card and no JAX:
``pytest -m gpu tests/test_torch_tucker_core.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import sweeps
from repro_torch.core.models import tucker
from repro_torch.core.models.parafac import TensorContext
from repro_torch.sparse.interactions import build_interactions

ALPHA0, L2_CORE = 0.4, 0.05
REL = 1e-10  # the blocked form against the loop, float64: only the order of sums differs


def per_coordinate_core_sweep(params, phi_m, j_i, tc, data, e, hp):
    """The core sweep as one scalar Newton step a coordinate, each a pass
    over the log: the port's form before the blocked sweep, and the JAX
    package's ``lax.fori_loop`` body. ``phi_m`` is updated in place."""
    u, v, w, b = params
    b = b.clone()
    k1, k2, k3 = b.shape
    pair_of_nnz = data.ctx
    up, vp, w_nnz = u[tc.c1], v[tc.c2], w[data.item]
    for idx in range(k1 * k2 * k3):
        f1, f2, f3 = idx // (k2 * k3), (idx // k3) % k2, idx % k3
        g = up[:, f1] * vp[:, f2]                               # (n_ctx,)
        w_col = w_nnz[:, f3]                                    # (nnz,)
        g_nnz = g[pair_of_nnz]
        lp = torch.sum(data.alpha * e * g_nnz * w_col)
        lpp = torch.sum(data.alpha * (g_nnz * w_col) ** 2)
        rp = torch.dot(phi_m.T @ g, sweeps.take_col(j_i, f3))
        rpp = j_i[f3, f3] * torch.sum(g * g)
        num = lp + hp.alpha0 * rp + hp.l2_core * b[f1, f2, f3]
        den = lpp + hp.alpha0 * rpp + hp.l2_core
        delta = -hp.eta * num / torch.clamp(den, min=1e-12)
        b[f1, f2, f3] += delta
        phi_m[:, f3] += delta * g
        e = e + delta * g_nnz * w_col
    return b, phi_m, e


def make_problem(ranks, *, n_users, n_buckets, n_items, nnz, seed, device,
                 dtype=torch.float64, weights=False, edge_pairs=False):
    """A log with an hour on each interaction (each user a home hour, the
    hour home + round(N(0, 3²)) mod n_buckets), its (user, hour) pairs, and
    random factors, core, residuals and ᾱ in ``dtype``. ``edge_pairs`` adds
    a pair with no interaction (in the middle of the pair list) and one
    whose five interactions are all in one item; ``weights`` folds random
    per-interaction weights into ᾱ."""
    rng = np.random.default_rng(seed)
    user = rng.integers(0, n_users, nnz)
    home = rng.integers(0, n_buckets, n_users)
    hour = (home[user] + np.rint(rng.normal(0, 3, nnz)).astype(np.int64)) % n_buckets
    item = np.minimum((n_items * rng.random(nnz) ** 2).astype(np.int64), n_items - 1)
    key = user * n_buckets + hour
    keys = np.unique(key)
    if edge_pairs:
        free = np.setdiff1d(np.arange(n_users * n_buckets), keys)
        keys = np.sort(np.concatenate([keys, [free[len(free) // 2]]]))
        lone = np.setdiff1d(np.arange(n_users * n_buckets), keys)[0]
        keys = np.sort(np.concatenate([keys, [lone]]))
        key = np.concatenate([key, np.full(5, lone)])
        item = np.concatenate([item, np.full(5, 7 % n_items)])
    pair = np.searchsorted(keys, key)
    n = len(pair)
    y = rng.integers(1, 4, n).astype(np.float64)
    alpha = ALPHA0 + 0.5 + rng.random(n)
    tc = TensorContext(c1=torch.as_tensor(keys // n_buckets, device=device),
                       c2=torch.as_tensor(keys % n_buckets, device=device),
                       n_c1=n_users, n_c2=n_buckets)
    data = build_interactions(pair, item, y, alpha, len(keys), n_items, alpha0=ALPHA0,
                              device=device)
    alpha_t = data.alpha.to(dtype)
    if weights:
        alpha_t = alpha_t * torch.as_tensor(0.5 + rng.random(n), dtype=dtype, device=device)
    data = dataclasses.replace(data, alpha=alpha_t)
    k1, k2, k3 = ranks

    def rand(*shape, scale=0.5):
        return torch.as_tensor(scale * rng.normal(size=shape), dtype=dtype, device=device)

    params = tucker.TuckerParams(rand(n_users, k1), rand(n_buckets, k2), rand(n_items, k3),
                                 rand(k1, k2, k3))
    phi_m = tucker.phi(params, tc)
    j_i = params.w.T @ params.w
    e = rand(n, scale=1.0)
    return params, phi_m, j_i, tc, data, e


def _assert_close(got, want, rel):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rel, atol=rel * scale)


CASES = [((3, 2, 4), 1.0, False), ((3, 2, 4), 0.7, True), ((2, 1, 3), 1.0, True),
         ((2, 1, 3), 0.7, False), ((2, 2, 1), 1.0, False), ((2, 2, 1), 0.7, True)]


@pytest.mark.parametrize("edge_pairs", [False, True], ids=["pairs", "edge-pairs"])
@pytest.mark.parametrize("ranks,eta,weights", CASES,
                         ids=[f"{'-'.join(map(str, r))}-eta{eta}{'-w' if w else ''}"
                              for r, eta, w in CASES])
def test_blocked_core_sweep_matches_the_per_coordinate_loop(ranks, eta, weights,
                                                            edge_pairs):
    """``tucker.core_sweep`` on CPU tensors (the blocked plain form: a pass
    a slab) against the loop of one pass a coordinate, in float64: b, Φ and
    e within 1e-10 relative."""
    params, phi_m, j_i, tc, data, e = make_problem(
        ranks, n_users=12, n_buckets=8, n_items=11, nnz=160, seed=sum(ranks) + int(10 * eta),
        device="cpu", weights=weights, edge_pairs=edge_pairs)
    k1, k2, k3 = ranks
    hp = tucker.TuckerHyperParams(k1=k1, k2=k2, k3=k3, alpha0=ALPHA0, l2_core=L2_CORE,
                                  eta=eta)
    b0, e0, phi0 = params.b.clone(), e.clone(), phi_m.clone()
    b, phi_got, e_got = tucker.core_sweep(params, phi_m, j_i, tc, data, e, hp)
    assert phi_got is phi_m  # updated in place, as before
    assert torch.equal(params.b, b0) and torch.equal(e, e0)  # left as they were
    b_want, phi_want, e_want = per_coordinate_core_sweep(params, phi0, j_i, tc, data, e0, hp)
    assert float((b_want - b0).abs().max()) > 1e-3  # the steps moved the core
    _assert_close(b, b_want, REL)
    _assert_close(phi_got, phi_want, REL)
    _assert_close(e_got, e_want, REL)


def test_blocked_core_sweep_of_one_slab_and_an_empty_log():
    """k1 = k2 = 1 (one slab: the steps' L' and R inside one slab only), and
    a log with no interaction at all (only the α₀ and λ terms move b)."""
    params, phi_m, j_i, tc, data, e = make_problem(
        (1, 1, 5), n_users=6, n_buckets=3, n_items=8, nnz=60, seed=5, device="cpu")
    hp = tucker.TuckerHyperParams(k1=1, k2=1, k3=5, alpha0=ALPHA0, l2_core=L2_CORE)
    want = per_coordinate_core_sweep(params, phi_m.clone(), j_i, tc, data, e.clone(), hp)
    for got, w in zip(tucker.core_sweep(params, phi_m, j_i, tc, data, e, hp), want):
        _assert_close(got, w, REL)
    empty = dataclasses.replace(
        data, ctx=data.ctx[:0], item=data.item[:0], y=data.y[:0], alpha=data.alpha[:0],
        ctx_ptr=torch.zeros_like(data.ctx_ptr))
    phi_m = tucker.phi(params, tc)
    want = per_coordinate_core_sweep(params, phi_m.clone(), j_i, tc, empty, e[:0], hp)
    for got, w in zip(tucker.core_sweep(params, phi_m, j_i, tc, empty, e[:0], hp), want):
        _assert_close(got, w, REL)


# --------------------------------------------------------------------------
# On the card: the kernels against the blocked plain form.
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _slab_inputs(problem, dtype):
    """The wrapper's inputs in ``dtype``, as ``tucker.core_sweep`` forms them."""
    params, phi_m, j_i, tc, data, e = problem
    return tucker.core_sweep_inputs(
        tucker.TuckerParams(*(t.to(dtype) for t in params)), phi_m.to(dtype),
        j_i.to(dtype), tc, dataclasses.replace(data, alpha=data.alpha.to(dtype)),
        e.to(dtype))


def _gap(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


KERNEL_CASES = [((16, 4, 32), 200_000, 2000, 24, 3000, False),
                ((3, 2, 4), 20_000, 300, 24, 500, True),
                ((2, 3, 13), 30_000, 400, 12, 700, True),
                ((2, 2, 64), 30_000, 400, 12, 700, False),
                ((1, 2, 100), 20_000, 300, 24, 500, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("ranks,nnz,n_users,n_buckets,n_items,weights", KERNEL_CASES,
                         ids=["16-4-32", "3-2-4", "2-3-13", "2-2-64", "1-2-100"])
def test_core_sweep_kernel_matches_the_plain_form_on_cuda(cuda, ranks, nnz, n_users,
                                                          n_buckets, n_items, weights):
    """The kernels (float32) against the blocked plain form in float64 on the
    same inputs, beside the plain form in float32: the steps Δ and the
    residuals within 2e-5 (norm-relative); two calls give the same bits;
    2·k1·k2 + 1 launches and k1·k2 slabs a call."""
    from repro_torch.core.gram import full_fp32
    from repro_torch.kernels.tucker_core import ops, ref

    problem = make_problem(ranks, n_users=n_users, n_buckets=n_buckets, n_items=n_items,
                           nnz=nnz, seed=33, device=cuda, weights=weights,
                           edge_pairs=True)
    kw = dict(alpha0=ALPHA0, l2_core=L2_CORE, eta=0.9)
    k1, k2, _ = ranks
    with full_fp32():
        x32, x64 = _slab_inputs(problem, torch.float32), _slab_inputs(problem, torch.float64)
        want = ref.core_sweep_slabs_ref(*x64, **kw)
        plain = ref.core_sweep_slabs_ref(*x32, **kw)
        launches, slabs = ops.core_sweep_slabs.launches, ops.core_sweep_slabs.slabs
        got = ops.core_sweep_slabs(*x32, **kw)
        again = ops.core_sweep_slabs(*x32, **kw)
    torch.cuda.synchronize()
    assert ops.core_sweep_slabs.launches == launches + 2 * (2 * k1 * k2 + 1)
    assert ops.core_sweep_slabs.slabs == slabs + 2 * k1 * k2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    gaps = [_gap(g, w) for g, w in zip(got, want)]
    plain_gaps = [_gap(p, w) for p, w in zip(plain, want)]
    print(f"ranks {ranks}: kernel gaps (delta, e) {gaps}, plain float32 {plain_gaps}")
    assert max(gaps) <= 2e-5, (gaps, plain_gaps)


@pytest.mark.gpu
def test_core_sweep_kernel_edges_on_cuda(cuda):
    """A log with no interaction (only the α₀ and λ terms move the core)
    matches the plain form; what the kernel does not take raises: k3 above
    128, a float64 or strided tensor, int32 offsets."""
    from repro_torch.kernels.tucker_core import ops, ref

    problem = make_problem((2, 1, 3), n_users=20, n_buckets=4, n_items=30, nnz=300,
                           seed=3, device=cuda)
    x = list(_slab_inputs(problem, torch.float32))
    kw = dict(alpha0=ALPHA0, l2_core=L2_CORE, eta=1.0)
    empty = list(x)
    empty[6] = torch.zeros_like(x[6])
    empty[7], empty[8], empty[9] = x[7][:0], x[8][:0], x[9][:0]
    got, want = ops.core_sweep_slabs(*empty, **kw), ref.core_sweep_slabs_ref(*empty, **kw)
    assert got[1].shape == (0,) and _gap(got[0], want[0]) <= 1e-6
    wide = list(x)
    wide[0] = torch.zeros((30, 129), device=cuda)
    wide[3], wide[4] = torch.zeros((2, 129), device=cuda), torch.zeros((2, 129), device=cuda)
    wide[5] = torch.zeros((129, 129), device=cuda)
    with pytest.raises(ValueError, match="k3 from 1 to 128"):
        ops.core_sweep_slabs(*wide, **kw)
    bad = list(x)
    bad[9] = x[9].double()
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.core_sweep_slabs(*bad, **kw)
    bad = list(x)
    bad[1] = torch.zeros((x[1].shape[0], 2 * x[1].shape[1]), device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.core_sweep_slabs(*bad, **kw)
    bad = list(x)
    bad[6] = x[6].int()
    with pytest.raises(ValueError, match="int64"):
        ops.core_sweep_slabs(*bad, **kw)


@pytest.mark.gpu
def test_tucker_epoch_on_cuda_matches_cpu(cuda):
    """Two ``tucker.epoch`` calls at ranks (3, 2, 4), weighted, on the card
    (the core sweep and the mode sweeps by the kernels) against the same on
    the CPU (the plain forms), float32; the kernels' counters: 6 slabs, and
    3 + 2 mode columns in 2·5 + 2 launches, an epoch."""
    from repro_torch.kernels.tucker_core import ops
    from repro_torch.kernels.tucker_mode import ops as mode_ops

    out = []
    for dev in ("cpu", cuda):
        params, _, _, tc, data, _ = make_problem(
            (3, 2, 4), n_users=300, n_buckets=24, n_items=500, nnz=20_000, seed=7,
            device=dev, dtype=torch.float32, weights=True)
        hp = tucker.TuckerHyperParams(k1=3, k2=2, k3=4, alpha0=ALPHA0, l2_core=L2_CORE)
        e = tucker.residuals(params, tc, data)
        slabs = ops.core_sweep_slabs.slabs
        launches, columns = mode_ops.mode_sweep.launches, mode_ops.mode_sweep.columns
        for _ in range(2):
            params, e = tucker.epoch(params, tc, data, e, hp)
        if dev != "cpu":
            assert ops.core_sweep_slabs.slabs == slabs + 2 * 6
            assert mode_ops.mode_sweep.columns == columns + 2 * (3 + 2)
            assert mode_ops.mode_sweep.launches == launches + 2 * (2 * (3 + 2) + 2)
        out.append([t.cpu() for t in (*params, e)])
    for a, b in zip(*out):
        assert _gap(b, a) <= 2e-5, _gap(b, a)
