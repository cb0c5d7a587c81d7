"""The port's training substrate held against the JAX package on the same
numpy inputs: interactions, segment ops, the Lemma 1/2 objective pieces,
``core.gram``, the sweep helpers and schedules, the padded layout, the
ranking metrics, the synthetic generator and the training cost model.

Tolerances: integer layouts and index arrays exactly; fp32 reductions to
rtol 1e-5 / atol 1e-6 (the two packages sum in different orders); the
generator's arrays exactly (the same seeded numpy).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gram as jgram
from repro.core import implicit as jimp
from repro.core import metrics as jmetrics
from repro.core import sweeps as jsweeps
from repro.core.models import mf_padded as jmfp
from repro.data.synthetic import make_implicit_dataset as j_make
from repro.sparse import segment as jseg
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.core import gram, implicit, metrics, sweeps
from repro_torch.core.models import mf_padded
from repro_torch.data.synthetic import make_implicit_dataset
from repro_torch.obs.costs import KernelCostRecorder, cd_sweep_cost
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.train import compose_callbacks, fit_metrics_callback
from repro_torch.sparse import segment
from repro_torch.sparse.interactions import build_interactions

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("ctx", "item", "y", "alpha", "t_ctx", "t_item", "t_perm")
PADDED = ("item_ids", "alpha_c", "y_c", "ctx_ids", "alpha_i", "y_i",
          "c_rows", "c_cols", "i_rows", "i_cols")


def _raw(seed=0, n_ctx=30, n_items=20, nnz=150, alpha0=0.4, empty_tail=0):
    rng = np.random.default_rng(seed)
    cells = rng.choice((n_ctx - empty_tail) * n_items, size=nnz, replace=False)
    cells = rng.permutation(cells)  # unsorted input
    y = rng.integers(1, 5, size=nnz).astype(np.float64)
    alpha = alpha0 + 1.0 + rng.random(nnz)
    return cells // n_items, cells % n_items, y, alpha, n_ctx, n_items, alpha0


def _both(**kw):
    ctx, item, y, alpha, n_ctx, n_items, a0 = _raw(**kw)
    return (jbuild(ctx, item, y, alpha, n_ctx, n_items, alpha0=a0),
            build_interactions(ctx, item, y, alpha, n_ctx, n_items,
                               alpha0=a0, device="cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("rescale", [True, False])
def test_interactions_array_equal(rescale):
    ctx, item, y, alpha, n_ctx, n_items, a0 = _raw(seed=1)
    j = jbuild(ctx, item, y, alpha, n_ctx, n_items, alpha0=a0, rescale=rescale)
    t = build_interactions(ctx, item, y, alpha, n_ctx, n_items, alpha0=a0,
                           rescale=rescale, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(t, f)), _np(getattr(j, f)), f)
    assert (t.n_ctx, t.n_items, t.nnz) == (j.n_ctx, j.n_items, j.nnz)
    with pytest.raises(ValueError, match="alpha > alpha0"):
        build_interactions(ctx, item, y, np.full(len(y), a0), n_ctx, n_items,
                           alpha0=a0, device="cpu")


@pytest.mark.parametrize("empty_tail", [0, 3])
def test_pad_interactions_array_equal(empty_tail):
    jd, td = _both(seed=2, empty_tail=empty_tail)
    jp, tp = jmfp.pad_interactions(jd), mf_padded.pad_interactions(td)
    for f in PADDED:
        np.testing.assert_array_equal(_np(getattr(tp, f)), _np(getattr(jp, f)), f)
    e = np.random.default_rng(3).normal(size=jd.nnz).astype(np.float32)
    g = mf_padded.scatter_ctx_major(tp, torch.from_numpy(e))
    np.testing.assert_array_equal(g.numpy(), np.asarray(
        jmfp.scatter_ctx_major(jp, jnp.asarray(e))))
    gi = mf_padded.transfer_ctx_to_item(tp, g)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(
        jmfp.transfer_ctx_to_item(jp, jnp.asarray(g.numpy()))))
    np.testing.assert_array_equal(mf_padded.transfer_item_to_ctx(tp, gi).numpy(),
                                  g.numpy())
    w = torch.from_numpy(e + 2)
    rw, jrw = mf_padded.reweight_padded(tp, w), jmfp.reweight_padded(
        jp, jnp.asarray(e + 2))
    np.testing.assert_array_equal(rw.alpha_c.numpy(), np.asarray(jrw.alpha_c))
    np.testing.assert_array_equal(rw.alpha_i.numpy(), np.asarray(jrw.alpha_i))


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max"])
@pytest.mark.parametrize("shape", [(60,), (60, 3)])
def test_segment_ops_match_jax(op, shape):
    rng = np.random.default_rng(4)
    data = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(0, 9, shape[0])  # segment 9 stays empty
    got = getattr(segment, op)(torch.from_numpy(data), torch.from_numpy(ids), 10)
    want = getattr(jseg, op)(jnp.asarray(data), jnp.asarray(ids), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# row lengths of the sorted sums' layouts: empty rows first, in the middle
# and last, one row holding most entries, all rows empty
SORTED_LAYOUTS = {
    "empty_head": [0, 0, 3, 1, 4, 2],
    "empty_middle": [2, 5, 0, 0, 0, 1, 3],
    "empty_tail": [4, 1, 2, 0, 0],
    "one_heavy": [1, 0, 57, 2, 0, 1],
    "all_empty": [0, 0, 0],
}


@pytest.mark.parametrize("n_values", [1, 2, 3, 4])
@pytest.mark.parametrize("layout", sorted(SORTED_LAYOUTS))
def test_segment_sum_sorted_matches_jax(layout, n_values):
    lengths = np.array(SORTED_LAYOUTS[layout])
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    ids = np.repeat(np.arange(len(lengths)), lengths)
    rng = np.random.default_rng(len(lengths) + n_values)
    values = [rng.normal(size=len(ids)).astype(np.float32) for _ in range(n_values)]
    got = segment.segment_sum_sorted([torch.from_numpy(v) for v in values],
                                     torch.from_numpy(offsets))
    assert len(got) == n_values
    for g, v in zip(got, values):
        want = jseg.segment_sum(jnp.asarray(v), jnp.asarray(ids), len(lengths))
        assert g.shape == (len(lengths),)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        # the plain version is the scatter over the same rows, bit for bit
        np.testing.assert_array_equal(
            g.numpy(), segment.segment_sum(torch.from_numpy(v), torch.from_numpy(ids),
                                           len(lengths)).numpy())


@pytest.mark.parametrize("n_values", [0, 5])
def test_segment_sum_sorted_takes_one_to_four_vectors(n_values):
    with pytest.raises(ValueError, match="1 to 4 value vectors"):
        segment.segment_sum_sorted([torch.zeros(3)] * n_values,
                                   torch.tensor([0, 3]))


@pytest.mark.parametrize("empty_tail", [0, 3])
def test_interactions_csr_offsets(empty_tail):
    """``ctx_ptr`` and ``item_ptr`` are the CSR offsets of the two sorted
    orders (rows with no entries included), and a weighted epoch's
    ``dataclasses.replace`` keeps them."""
    jd, td = _both(seed=7, empty_tail=empty_tail)
    ctx, t_item = np.asarray(jd.ctx), np.asarray(jd.t_item)
    np.testing.assert_array_equal(td.ctx_ptr.numpy(),
                                  np.searchsorted(ctx, np.arange(td.n_ctx + 1)))
    np.testing.assert_array_equal(td.item_ptr.numpy(),
                                  np.searchsorted(t_item, np.arange(td.n_items + 1)))
    assert td.ctx_ptr.dtype == td.item_ptr.dtype == torch.int64
    assert int(td.ctx_ptr[-1]) == int(td.item_ptr[-1]) == td.nnz
    weighted = dataclasses.replace(td, alpha=td.alpha * 2)
    assert weighted.ctx_ptr is td.ctx_ptr and weighted.item_ptr is td.item_ptr


def test_segment_max_of_integers_matches_jax():
    ids = np.array([0, 0, 2, 2, 2])
    data = np.array([3, -1, 7, 2, 9], np.int32)
    got = segment.segment_max(torch.from_numpy(data), torch.from_numpy(ids), 4)
    want = jseg.segment_max(jnp.asarray(data), jnp.asarray(ids), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_implicit_objective_pieces_match_jax():
    jd, td = _both(seed=5)
    rng = np.random.default_rng(6)
    phi = rng.normal(size=(jd.n_ctx, 6)).astype(np.float32)
    psi = rng.normal(size=(jd.n_items, 6)).astype(np.float32)
    e = rng.normal(size=jd.nnz).astype(np.float32)
    sq = float((phi ** 2).sum() + (psi ** 2).sum())
    tp, tq, te = map(torch.from_numpy, (phi, psi, e))
    jp, jq, je = map(jnp.asarray, (phi, psi, e))
    pairs = [
        (implicit.implicit_regularizer_gram(tp, tq),
         jimp.implicit_regularizer_gram(jp, jq)),
        (implicit.implicit_regularizer_naive(tp, tq),
         jimp.implicit_regularizer_naive(jp, jq)),
        (implicit.explicit_loss(te, td.alpha), jimp.explicit_loss(je, jd.alpha)),
        (implicit.implicit_objective(tp, tq, te, td, 0.4, 0.1, sq),
         jimp.implicit_objective(jp, jq, je, jd, 0.4, 0.1, sq)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    # Lemma 2: the Gram form equals the brute-force regularizer
    np.testing.assert_allclose(float(pairs[0][0]), float(pairs[1][0]), rtol=1e-5)
    y, a = np.array([1.0, 3.0]), np.array([2.0, 5.0])
    for got, want in zip(implicit.rescale_observed(torch.tensor(y), torch.tensor(a), 0.5),
                         jimp.rescale_observed(jnp.asarray(y), jnp.asarray(a), 0.5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    cnt = np.array([0.0, 1.0, 4.0, 10.0])
    for mode in ("linear", "log"):
        np.testing.assert_allclose(
            implicit.frequency_confidence(cnt, beta=0.5, mode=mode).numpy(),
            np.asarray(jimp.frequency_confidence(cnt, beta=0.5, mode=mode)),
            rtol=1e-6)
    np.testing.assert_allclose(
        implicit.confidence_weights(cnt + 1, base=2.0).numpy(),
        np.asarray(jimp.confidence_weights(cnt + 1, base=2.0)), rtol=1e-7)
    with pytest.raises(ValueError):
        implicit.frequency_confidence(cnt, mode="sqrt")


@pytest.mark.parametrize("implementation", ["xla", "pallas"])
@pytest.mark.parametrize("weighted", [False, True])
def test_core_gram_matches_jax(implementation, weighted):
    """'xla' is torch.mm; 'pallas' on the CPU is the Gram kernel's plain
    version; both against the JAX package's same-named paths (its Pallas
    kernel in interpret mode)."""
    rng = np.random.default_rng(7)
    m = rng.normal(size=(70, 10)).astype(np.float32)
    w = rng.random(70).astype(np.float32) if weighted else None
    got = gram.gram(torch.from_numpy(m), implementation=implementation,
                    weights=None if w is None else torch.from_numpy(w))
    want = jgram.gram(jnp.asarray(m), implementation=implementation,
                      weights=None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    pair = gram.gram_pair(torch.from_numpy(m), torch.from_numpy(m[:20]))
    np.testing.assert_allclose(pair[1].numpy(), np.asarray(jgram.gram(jnp.asarray(m[:20]))),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        gram.gram(torch.from_numpy(m), implementation="mosaic")


def test_full_fp32_restores_the_callers_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with gram.full_fp32():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


SCHEDULES = [
    jsweeps.SweepSchedule(),
    jsweeps.SweepSchedule(kind="rotating", blocks_per_sweep=1),
    jsweeps.SweepSchedule(kind="randomized", seed=3, repeats=(1, 2)),
    jsweeps.SweepSchedule(kind="rotating", block=3, repeats=2),
    jsweeps.SweepSchedule(kind="full", block=5, blocks_per_sweep=2),
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: f"{s.kind}-{s.block}")
def test_schedule_blocks_equal_reference(sched):
    port = sweeps.SweepSchedule(**dataclasses.asdict(sched))
    for n_dims, block in ((8, 0), (13, 4), (16, 8), (3, 1)):
        for sweep_index in range(4):
            assert port.blocks(n_dims, sweep_index, block) == \
                sched.blocks(n_dims, sweep_index, block)
            assert port.n_column_updates(n_dims, sweep_index, block) == \
                sched.n_column_updates(n_dims, sweep_index, block)
    with pytest.raises(ValueError):
        sweeps.SweepSchedule(kind="cyclic")
    with pytest.raises(ValueError):
        sweeps.SweepSchedule(repeats=0)


def test_sweep_helpers_match_jax():
    jd, td = _both(seed=8)
    rng = np.random.default_rng(9)
    phi = rng.normal(size=(jd.n_ctx, 4)).astype(np.float32)
    psi = rng.normal(size=(jd.n_items, 4)).astype(np.float32)
    got = sweeps.residuals_from_factors(torch.from_numpy(phi), torch.from_numpy(psi),
                                        td.ctx, td.item, td.y)
    want = jsweeps.residuals_from_factors(jnp.asarray(phi), jnp.asarray(psi),
                                          jd.ctx, jd.item, jd.y)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    t = sweeps.to_item_major(got, td.t_perm)
    np.testing.assert_array_equal(t.numpy(), np.asarray(
        jsweeps.to_item_major(jnp.asarray(got.numpy()), jd.t_perm)))
    np.testing.assert_array_equal(sweeps.to_ctx_major(t, td.t_perm).numpy(),
                                  got.numpy())
    g, h, th = (rng.normal(size=5).astype(np.float32) for _ in range(3))
    h = np.abs(h)
    h[0] = -1.0  # clamped denominator
    got = sweeps.newton_delta(sweeps.NewtonParts(torch.tensor(g), torch.tensor(h)),
                              torch.tensor(th), 0.0, 0.9)
    want = jsweeps.newton_delta(jsweeps.NewtonParts(jnp.asarray(g), jnp.asarray(h)),
                                jnp.asarray(th), 0.0, 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for bk, k in ((0, 16), (0, 5), (3, 8), (40, 8), (-2, 8)):
        assert sweeps.resolve_block_k(bk, k) == jsweeps.resolve_block_k(bk, k)
    assert sweeps.resolve_psi_dispatch("gather") and \
        not sweeps.resolve_psi_dispatch("pregather")
    with pytest.raises(ValueError):
        sweeps.resolve_psi_dispatch("gathered")


def test_sweep_columns_dispatch_order():
    seen = []
    body = lambda f, c: seen.append(("col", f)) or c  # noqa: E731
    block_body = lambda f0, s, c: seen.append(("blk", f0, s)) or c  # noqa: E731
    sweeps.sweep_columns(7, body, None, block=3, block_body=block_body)
    assert seen == [("blk", 0, 3), ("blk", 3, 3), ("blk", 6, 1)]
    seen.clear()
    sweeps.sweep_columns(3, body, None, block=3, block_body=block_body, unroll=True)
    assert seen == [("col", 0), ("col", 1), ("col", 2)]
    seen.clear()
    sweeps.sweep_columns(6, body, None, block=2, block_body=block_body,
                         schedule=sweeps.SweepSchedule("rotating"), sweep_index=1)
    assert seen == [("blk", 2, 2), ("blk", 4, 2), ("blk", 0, 2)]


def test_ranking_metrics_match_jax():
    rng = np.random.default_rng(10)
    scores = rng.integers(0, 4, (12, 30)).astype(np.float32)  # many ties
    truth = rng.integers(0, 30, 12)
    mask = rng.random((12, 30)) < 0.2
    ts, tt = torch.from_numpy(scores), torch.from_numpy(truth)
    js, jt = jnp.asarray(scores), jnp.asarray(truth)
    np.testing.assert_array_equal(
        metrics.topk_items(ts, 7, torch.from_numpy(mask)).numpy(),
        np.asarray(jmetrics.topk_items(js, 7, jnp.asarray(mask))))
    for fn in ("recall_at_k", "ndcg_at_k"):
        np.testing.assert_allclose(
            float(getattr(metrics, fn)(ts, tt, 5, torch.from_numpy(mask))),
            float(getattr(jmetrics, fn)(js, jt, 5, jnp.asarray(mask))), rtol=1e-6)
    ids = rng.integers(-1, 30, (12, 6))
    for fn in ("recall_from_topk", "ndcg_from_topk"):
        np.testing.assert_allclose(
            float(getattr(metrics, fn)(torch.from_numpy(ids), tt)),
            float(getattr(jmetrics, fn)(jnp.asarray(ids), jt)), rtol=1e-6)
    held = [rng.choice(30, size=int(rng.integers(0, 4)), replace=False)
            for _ in range(12)]
    assert metrics.recall_ndcg_multi(scores, held, 5, mask) == \
        jmetrics.recall_ndcg_multi(scores, held, 5, mask)


def test_synthetic_dataset_array_equal():
    kw = dict(n_users=60, n_items=50, pop_strength=0.4, taste_strength=2.5, seed=4)
    a, b = make_implicit_dataset(**kw), j_make(**kw)
    for f in ("events", "age", "country", "gender", "device"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [len(h) for h in a.user_histories()] == [len(h) for h in b.user_histories()]


def test_training_cost_model_and_callback():
    """The sweep's byte model is the one chip_smoke.py bounds with: per
    launch C·D_pad·16 B + C·k_b·12 B + n_src·k_b·4 B (gather form)."""
    c, d, kb, n_src = 1000, 128, 8, 300
    cost = cd_sweep_cost(c, d, kb, kb, n_src=n_src)
    assert cost["hbm_bytes"] == 16 * c * d + 12 * c * kb + 4 * n_src * kb
    pre = cd_sweep_cost(c, d, 16, kb, gather=False)
    assert pre["hbm_bytes"] == 2 * 12 * c * d + 12 * c * 16 + 4 * c * d * 16
    assert cost["smem_bytes"] > 0 and cost["flops"] == 8 * c * d * kb
    reg = MetricsRegistry(clock=iter(range(100)).__next__)
    cb = fit_metrics_callback(registry=reg, objective=lambda p: 2.5, n_dims=16,
                              block=8, cd_shape=(c, d, 16))
    seen = []
    both = compose_callbacks(cb, None, lambda ep, p: seen.append(ep))
    for ep in range(3):
        both(ep, None)
    assert seen == [0, 1, 2] and [h[0] for h in cb.history] == [0, 1, 2]
    assert all(h[2] == 2.5 for h in cb.history)
    KernelCostRecorder(reg).record_cd_sweep(c, d, 16, kb, sweeps=2)
    per_side = cd_sweep_cost(c, d, 16, kb)["hbm_bytes"]
    assert reg.get("kernel_hbm_bytes_total", kernel="cd_sweep") == \
        pytest.approx(8 * per_side)  # 3 epochs x 2 sides, then 2 more


def test_jax_side_runs_on_the_cpu():
    assert jax.default_backend() == "cpu"
