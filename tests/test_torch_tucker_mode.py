"""Tucker's mode sweeps by column (``kernels/tucker_mode``): the plain form
(``ref.mode_sweep_ref``, the CPU path of ``tucker._mode_sweep``) against the
per-column PyTorch body it replaced, kept here as the oracle, in float64, on
both sides; and on the card the hand-written kernels against the plain form.
This module imports no JAX, so its ``gpu`` tests run on a machine with a card
and no JAX: ``pytest -m gpu tests/test_torch_tucker_mode.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import sweeps
from repro_torch.core.models import tucker
from repro_torch.core.models.parafac import TensorContext, pair_groups
from repro_torch.sparse.interactions import build_interactions
from repro_torch.sparse.segment import segment_sum

ALPHA0, L2 = 0.4, 0.05
REL = 1e-10  # the plain form against the per-column body, float64: only the order of sums differs


def per_column_mode_sweep(side, b_slice_fn, partner_of_pair, partner, group_of_pair,
                          n_side: int, k_side: int, phi_m, j_i, data, w_items, e, hp,
                          schedule=None, sweep_index: int = 0):
    """The flat mode sweep as the port ran it before ``kernels.tucker_mode``:
    per column D over the pairs, its (nnz, k3) gather and four ``index_add_``
    sums. ``side`` and ``phi_m`` are updated in place."""
    pair_of_nnz = data.ctx
    grp_nnz = group_of_pair[pair_of_nnz]
    pp = partner[partner_of_pair]                              # (n_ctx, k_other)
    w_nnz = w_items[data.item]                                 # (nnz, k3)

    def body(fs, carry):
        side_m, phi_m, e = carry
        d = pp @ b_slice_fn(fs)                                # (n_ctx, k3)
        s = torch.sum(d[pair_of_nnz] * w_nnz, dim=1)           # (nnz,)
        lp = segment_sum(data.alpha * e * s, grp_nnz, n_side)
        lpp = segment_sum(data.alpha * s * s, grp_nnz, n_side)
        rp = segment_sum(torch.sum(d * (phi_m @ j_i), dim=1), group_of_pair,
                         n_side)
        rpp = segment_sum(torch.sum(d * (d @ j_i), dim=1), group_of_pair,
                          n_side)
        s_col = sweeps.take_col(side_m, fs)
        delta = sweeps.newton_delta(
            sweeps.NewtonParts(lp + hp.alpha0 * rp, lpp + hp.alpha0 * rpp),
            s_col, hp.l2, hp.eta)
        phi_m += delta[group_of_pair][:, None] * d
        e = e + delta[grp_nnz] * s
        return sweeps.put_col(side_m, fs, s_col + delta), phi_m, e

    return sweeps.sweep_columns(k_side, body, (side, phi_m, e),
                                schedule=schedule, sweep_index=sweep_index)


def mode_problem(ranks, *, n_users, n_buckets, n_items, nnz, seed, device,
                 dtype=torch.float64, weights=False, edges=False, shuffle=False):
    """A log with an hour on each interaction (each user a home hour, the
    hour home + round(N(0, 3²)) mod n_buckets), its (user, hour) pairs and
    random factors, core, residuals and ᾱ in ``dtype``. The last user has no
    interaction. ``edges``: user 0 has one pair, the last hour no
    interaction, and one pair none; ``shuffle`` lists the pairs in a random
    order (so neither mode's groups are contiguous); ``weights`` folds random
    per-interaction weights into ᾱ."""
    rng = np.random.default_rng(seed)
    user = rng.integers(0, n_users - 1, nnz)
    home = rng.integers(0, n_buckets, n_users)
    hour = (home[user] + np.rint(rng.normal(0, 3, nnz)).astype(np.int64)) % n_buckets
    item = np.minimum((n_items * rng.random(nnz) ** 2).astype(np.int64), n_items - 1)
    if edges:
        hour[hour == n_buckets - 1] = 0
        hour[user == 0] = 1
    key = user * n_buckets + hour
    keys = np.unique(key)
    if edges:
        free = [k for k in np.setdiff1d(np.arange(n_users * n_buckets), keys)
                if 0 < k % n_buckets < n_buckets - 1 and k // n_buckets > 0]
        keys = np.sort(np.concatenate([keys, [free[len(free) // 2]]]))
    if shuffle:
        keys = keys[rng.permutation(len(keys))]
    pair = np.argsort(keys)[np.searchsorted(keys[np.argsort(keys)], key)]
    y = rng.integers(1, 4, nnz).astype(np.float64)
    alpha = ALPHA0 + 0.5 + rng.random(nnz)
    tc = TensorContext(c1=torch.as_tensor(keys // n_buckets, device=device),
                       c2=torch.as_tensor(keys % n_buckets, device=device),
                       n_c1=n_users, n_c2=n_buckets)
    data = build_interactions(pair, item, y, alpha, len(keys), n_items, alpha0=ALPHA0,
                              device=device)
    alpha_t = data.alpha.to(dtype)
    if weights:
        alpha_t = alpha_t * torch.as_tensor(0.5 + rng.random(nnz), dtype=dtype, device=device)
    data = dataclasses.replace(data, alpha=alpha_t)
    k1, k2, k3 = ranks

    def rand(*shape, scale=0.5):
        return torch.as_tensor(scale * rng.normal(size=shape), dtype=dtype, device=device)

    params = tucker.TuckerParams(rand(n_users, k1), rand(n_buckets, k2), rand(n_items, k3),
                                 rand(k1, k2, k3))
    return params, tucker.phi(params, tc), params.w.T @ params.w, tc, data, rand(nnz, scale=1.0)


def side_args(side, params, tc):
    """The side's factor, its core slices, partner and groups, as
    ``tucker.epoch`` passes them; and the oracle's slice function."""
    u, v, _, b = params
    if side == "u":
        return (u, b, tc.c2, v, tc.c1, tc.c1_groups), (lambda f1: b[f1]), tc.n_c1
    return (v, b.transpose(0, 1), tc.c1, u, tc.c2, tc.c2_groups), (lambda f2: b[:, f2]), tc.n_c2


def run_both(side, problem, hp, schedule=None, sweep_index=0):
    """(the plain form through ``tucker._mode_sweep``, the oracle): each
    side factor, Φ and e after one mode sweep from the same start."""
    params, phi_m, j_i, tc, data, e = problem
    (fac, b_s, pop, partner, gop, groups), slice_fn, n_side = side_args(side, params, tc)
    e0, phi0 = e.clone(), phi_m.clone()
    got = tucker._mode_sweep(side, fac.clone(), b_s, pop, partner, gop, groups, phi0.clone(),
                             j_i, data, params.w, e0, hp, schedule, sweep_index)
    assert torch.equal(e0, e)  # the caller's residuals are left as they were
    want = per_column_mode_sweep(fac.clone(), slice_fn, pop, partner, gop, n_side,
                                 fac.shape[1], phi0.clone(), j_i, data, params.w, e, hp,
                                 schedule, sweep_index)
    return got, want


def _assert_close(got, want, rel):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rel, atol=rel * scale)


CASES = [((3, 2, 4), 1.0, False, False, False), ((3, 2, 4), 0.7, True, True, False),
         ((2, 3, 5), 1.0, True, False, True), ((4, 2, 12), 0.8, False, True, True),
         ((5, 1, 3), 1.0, False, True, False), ((1, 4, 6), 0.9, True, False, True)]


@pytest.mark.parametrize("side", ["u", "v"])
@pytest.mark.parametrize("ranks,eta,weights,edges,shuffle", CASES,
                         ids=[f"{'-'.join(map(str, r))}-eta{eta}{'-w' if w else ''}"
                              f"{'-edges' if ed else ''}{'-shuffled' if sh else ''}"
                              for r, eta, w, ed, sh in CASES])
def test_plain_mode_sweep_matches_the_per_column_body(side, ranks, eta, weights, edges,
                                                      shuffle):
    """``tucker._mode_sweep`` on CPU tensors (the plain form: sums by pair,
    then by group in the group order; the step reaching Φ and e at the next
    column's pass) against the per-column body, in float64: the side, Φ and
    e within 1e-10 relative. k3 5 and 12, a user with one pair, a user with
    none, an hour with no interaction, a pair with none, the pairs in a
    random order."""
    problem = mode_problem(ranks, n_users=14, n_buckets=8, n_items=11, nnz=180,
                           seed=sum(ranks) + int(10 * eta), device="cpu", weights=weights,
                           edges=edges, shuffle=shuffle)
    k1, k2, k3 = ranks
    hp = tucker.TuckerHyperParams(k1=k1, k2=k2, k3=k3, alpha0=ALPHA0, l2=L2, eta=eta)
    got, want = run_both(side, problem, hp)
    fac0 = problem[0].u if side == "u" else problem[0].v
    assert float((want[0] - fac0).abs().max()) > 1e-3  # the steps moved the side
    for g, w in zip(got, want):
        _assert_close(g, w, REL)


SCHEDULES = {
    "rotating": (sweeps.SweepSchedule(kind="rotating"), 1),
    "randomized-repeats": (sweeps.SweepSchedule(kind="randomized", repeats=(1, 2), seed=5), 3),
    "truncated-repeats": (sweeps.SweepSchedule(block=1, blocks_per_sweep=2, repeats=2), 0),
    "rotating-blocks": (sweeps.SweepSchedule(kind="rotating", block=2, repeats=(2, 1)), 2),
}


@pytest.mark.parametrize("side", ["u", "v"])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_plain_mode_sweep_follows_the_schedule(side, name):
    """Scheduled sweeps (rotated, randomized, truncated, columns repeated, a
    column twice in a row) take the columns in the order
    ``sweeps.sweep_columns`` gives: the same side, Φ and e as the
    per-column body under the same schedule, weighted ᾱ."""
    schedule, sweep_index = SCHEDULES[name]
    problem = mode_problem((4, 3, 5), n_users=12, n_buckets=6, n_items=9, nnz=150, seed=11,
                           device="cpu", weights=True)
    hp = tucker.TuckerHyperParams(k1=4, k2=3, k3=5, alpha0=ALPHA0, l2=L2, eta=0.8)
    got, want = run_both(side, problem, hp, schedule, sweep_index)
    for g, w in zip(got, want):
        _assert_close(g, w, REL)


@pytest.mark.parametrize("side", ["u", "v"])
def test_plain_mode_sweep_of_an_empty_log(side):
    """A log with no interaction (only the α₀ and λ terms move the side):
    the same side and Φ as the per-column body, and an empty e."""
    params, phi_m, j_i, tc, data, e = mode_problem(
        (3, 2, 4), n_users=6, n_buckets=3, n_items=8, nnz=60, seed=5, device="cpu")
    empty = dataclasses.replace(
        data, ctx=data.ctx[:0], item=data.item[:0], y=data.y[:0], alpha=data.alpha[:0],
        ctx_ptr=torch.zeros_like(data.ctx_ptr))
    hp = tucker.TuckerHyperParams(k1=3, k2=2, k3=4, alpha0=ALPHA0, l2=L2)
    got, want = run_both(side, (params, phi_m, j_i, tc, empty, e[:0]), hp)
    assert got[2].shape == (0,)
    for g, w in zip(got, want):
        _assert_close(g, w, REL)


def test_pair_groups_lists_the_pairs_group_by_group():
    """``pair_groups``: no order for ids already sorted, else the stable
    order by id; the offsets count each id, empty groups included; the
    ``TensorContext`` keeps what it built."""
    sorted_ids = torch.tensor([0, 0, 2, 2, 2, 4])
    g = pair_groups(sorted_ids, 6)
    assert g.order is None and g.ptr.tolist() == [0, 2, 2, 5, 5, 6, 6]
    ids = torch.tensor([3, 1, 3, 0, 1, 3])
    g = pair_groups(ids, 5)
    assert g.order.dtype == torch.int32 and g.order.tolist() == [3, 1, 4, 0, 2, 5]
    assert g.ptr.tolist() == [0, 1, 3, 3, 6, 6]
    tc = TensorContext(c1=sorted_ids, c2=ids, n_c1=6, n_c2=5)
    assert tc.c1_groups is tc.c1_groups and tc.c2_groups.order.tolist() == g.order.tolist()


# --------------------------------------------------------------------------
# On the card: the kernels against the plain form.
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _gap(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    den = torch.linalg.vector_norm(b)
    return float(torch.linalg.vector_norm(a - b) / den) if den > 0 else float(a.abs().max())


def kernel_inputs(side, problem, dtype, device):
    """``ops.mode_sweep``'s arguments for ``side``, in ``dtype`` on ``device``;
    the side and Φ, which the sweep moves in place, copied."""
    params, phi_m, j_i, tc, data, e = problem
    to = (lambda t: t.to(device=device, dtype=dtype))
    params = tucker.TuckerParams(*map(to, params))
    tc = TensorContext(c1=tc.c1.to(device), c2=tc.c2.to(device), n_c1=tc.n_c1, n_c2=tc.n_c2)
    (fac, b_s, pop, partner, gop, groups), _, _ = side_args(side, params, tc)
    return ((fac.clone(), b_s, partner, pop, gop, groups.order, groups.ptr,
             to(phi_m).clone(memory_format=torch.contiguous_format), to(j_i), params.w,
             data.ctx_ptr.to(device), data.item.to(device), to(data.alpha), to(e)))


KERNEL_CASES = [((3, 2, 4), 20_000, 300, 24, 500, True, False, False),
                ((16, 4, 32), 200_000, 2000, 24, 3000, False, False, False),
                ((2, 3, 5), 30_000, 400, 12, 700, True, True, True),
                ((4, 2, 12), 30_000, 400, 12, 700, False, True, False),
                ((2, 1, 100), 20_000, 300, 24, 500, True, False, True),
                ((1, 40, 64), 30_000, 400, 48, 700, False, True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("side", ["u", "v"])
@pytest.mark.parametrize("ranks,nnz,n_users,n_buckets,n_items,weights,edges,shuffle",
                         KERNEL_CASES,
                         ids=["3-2-4", "16-4-32", "2-3-5-shuffled", "4-2-12", "2-1-100",
                              "1-40-64"])
def test_mode_sweep_kernel_matches_the_plain_form_on_cuda(cuda, side, ranks, nnz, n_users,
                                                          n_buckets, n_items, weights, edges,
                                                          shuffle):
    """The kernels (float32) against the plain form in float64 on the same
    inputs, beside the plain form in float32: the side, Φ and e within 2e-5
    (norm-relative); two calls give the same bits; 2·columns + 1 launches
    and the columns a call. A scheduled sweep with a repeated column too."""
    from repro_torch.core.gram import full_fp32
    from repro_torch.kernels.tucker_mode import ops, ref

    problem = mode_problem(ranks, n_users=n_users, n_buckets=n_buckets, n_items=n_items,
                           nnz=nnz, seed=35, device="cpu", weights=weights, edges=edges,
                           shuffle=shuffle)
    k_side = ranks[0] if side == "u" else ranks[1]
    plans = [tuple(range(k_side)), (k_side - 1, 0, 0, k_side - 1)]
    for columns in plans:
        kw = dict(columns=columns, alpha0=ALPHA0, l2=L2, eta=0.9)
        with full_fp32():
            want = ref.mode_sweep_ref(*kernel_inputs(side, problem, torch.float64, "cpu"), **kw)
            plain = ref.mode_sweep_ref(*kernel_inputs(side, problem, torch.float32, "cpu"), **kw)
            launches, cols = ops.mode_sweep.launches, ops.mode_sweep.columns
            got = ops.mode_sweep(*kernel_inputs(side, problem, torch.float32, cuda), **kw)
            again = ops.mode_sweep(*kernel_inputs(side, problem, torch.float32, cuda), **kw)
        torch.cuda.synchronize()
        assert ops.mode_sweep.launches == launches + 2 * (2 * len(columns) + 1)
        assert ops.mode_sweep.columns == cols + 2 * len(columns)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        gaps = [_gap(g, w) for g, w in zip(got, want)]
        plain_gaps = [_gap(p, w) for p, w in zip(plain, want)]
        print(f"{side} {ranks} {columns}: kernel gaps (side, phi, e) {gaps}, "
              f"plain float32 {plain_gaps}")
        assert max(gaps) <= 2e-5, (gaps, plain_gaps)


@pytest.mark.gpu
def test_mode_sweep_kernel_edges_on_cuda(cuda):
    """A log with no interaction matches the plain form; a sweep of no
    column launches nothing; what the kernel does not take raises: k3
    above 128, k_other above 64, a float64 or strided tensor, int32
    offsets."""
    from repro_torch.kernels.tucker_mode import ops, ref

    problem = mode_problem((2, 3, 4), n_users=20, n_buckets=4, n_items=30, nnz=300, seed=3,
                           device="cpu")
    params, phi_m, j_i, tc, data, e = problem
    empty = dataclasses.replace(
        data, ctx=data.ctx[:0], item=data.item[:0], y=data.y[:0], alpha=data.alpha[:0],
        ctx_ptr=torch.zeros_like(data.ctx_ptr))
    kw = dict(columns=(0, 1), alpha0=ALPHA0, l2=L2, eta=1.0)
    for side in ("u", "v"):
        x = (params, phi_m, j_i, tc, empty, e[:0])
        got = ops.mode_sweep(*kernel_inputs(side, x, torch.float32, cuda), **kw)
        want = ref.mode_sweep_ref(*kernel_inputs(side, x, torch.float64, "cpu"), **kw)
        assert got[2].shape == (0,) and max(_gap(g, w) for g, w in zip(got[:2], want)) <= 1e-6
    x = list(kernel_inputs("u", problem, torch.float32, cuda))
    launches = ops.mode_sweep.launches
    assert ops.mode_sweep(*x, **dict(kw, columns=()))[2] is x[13]
    assert ops.mode_sweep.launches == launches
    wide = list(x)
    wide[8] = torch.zeros((129, 129), device=cuda)
    wide[9] = torch.zeros((30, 129), device=cuda)
    wide[7] = torch.zeros((x[7].shape[0], 129), device=cuda)
    wide[1] = torch.zeros((2, 3, 129), device=cuda)
    with pytest.raises(ValueError, match="k3 from 1 to 128"):
        ops.mode_sweep(*wide, **kw)
    many = list(x)
    many[1] = torch.zeros((2, 65, 4), device=cuda)
    many[2] = torch.zeros((4, 65), device=cuda)
    with pytest.raises(ValueError, match="k_other from 1 to 64"):
        ops.mode_sweep(*many, **kw)
    bad = list(x)
    bad[13] = x[13].double()
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.mode_sweep(*bad, **kw)
    bad = list(x)
    bad[0] = torch.zeros((x[0].shape[0], 2 * x[0].shape[1]), device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous float32"):
        ops.mode_sweep(*bad, **kw)
    bad = list(x)
    bad[10] = x[10].int()
    with pytest.raises(ValueError, match="int64"):
        ops.mode_sweep(*bad, **kw)


@pytest.mark.gpu
def test_tucker_mode_sweeps_launch_only_the_kernels_on_cuda(cuda):
    """Under ``tucker.mode`` a CUDA epoch runs the mode sweeps by the
    kernels alone: no ``aten::index_add_`` and no (nnz, k3) gather, the pass
    kernel columns + 1 times and the solve kernel once a column."""
    from torch.profiler import ProfilerActivity, profile

    params, _, _, tc, data, _ = mode_problem(
        (3, 2, 4), n_users=300, n_buckets=24, n_items=500, nnz=20_000, seed=9,
        device=cuda, dtype=torch.float32, weights=True)
    hp = tucker.TuckerHyperParams(k1=3, k2=2, k3=4, alpha0=ALPHA0, l2=L2)
    e = tucker.residuals(params, tc, data)
    j_i = params.w.T @ params.w
    phi_m = tucker.phi(params, tc).contiguous()
    u, v = params.u.clone(), params.v.clone()
    _ = (tc.c1_groups, tc.c2_groups)  # built outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        u, phi_m, e = tucker._mode_sweep("u", u, params.b, tc.c2, v, tc.c1, tc.c1_groups,
                                         phi_m, j_i, data, params.w, e, hp)
        v, phi_m, e = tucker._mode_sweep("v", v, params.b.transpose(0, 1), tc.c1, u, tc.c2,
                                         tc.c2_groups, phi_m, j_i, data, params.w, e, hp)
        torch.cuda.synchronize()
    events = prof.key_averages()
    names = {ev.key for ev in events}
    assert not names & {"aten::index_add_", "aten::index", "aten::index_select"}, sorted(names)
    counts = {ev.key: ev.count for ev in events if ev.device_type.name == "CUDA"}
    passes = sum(c for k, c in counts.items() if "tucker_mode_pass_kernel" in k)
    solves = sum(c for k, c in counts.items() if "tucker_mode_solve_kernel" in k)
    assert (passes, solves) == (3 + 1 + 2 + 1, 3 + 2), counts
