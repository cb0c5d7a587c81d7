"""The port's iCD-MF training slice held against the JAX package from the
same carried-over weights: the segment-sum ``mf.epoch``, the kernel-fused
``mf_padded.epoch`` (every block size and both Ψ routings), weights and
schedules, the streaming ranking evaluation, and the quickstart twin.

On the CPU the port's kernel wrappers run their plain versions and the JAX
package runs its Pallas kernels in interpret mode. Tolerances: parameters
after two epochs to rtol 5e-4 / atol 5e-5 (the reference's own
distributed-vs-single-device tolerance, ``tests/test_mf_dist.py``; fp32
sums in different orders compound over the columns and both sides), the
fused-vs-flat pair within the port to the reference's rtol 3e-4 / atol
3e-5 (``tests/test_mf_padded.py``), weights=ones against weights=None
exactly, and ranked ids exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sweeps as jsweeps
from repro.core.metrics import recall_at_k as j_recall_at_k
from repro.core.models import mf as jmf
from repro.core.models import mf_padded as jmfp
from repro.eval.ranking import fit_eval_callback as j_fit_eval_callback
from repro.eval.ranking import ranking_eval as j_ranking_eval
from repro.serve.engine import RetrievalEngine as JEngine
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.core import sweeps
from repro_torch.core.models import mf, mf_padded
from repro_torch.eval.ranking import fit_eval_callback, overlap_recall, ranking_eval
from repro_torch.examples import quickstart
from repro_torch.kernels.cd_sweep import ops as cd_ops
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.serve.engine import (
    RetrievalEngine,
    bulk_score,
    exclude_ids_from_lists,
    exclude_mask_from_lists,
    mf_retrieval_score_fn,
)
from repro_torch.sparse.interactions import build_interactions

torch.set_num_threads(1)

RTOL, ATOL = 5e-4, 5e-5
PAIR_RTOL, PAIR_ATOL = 3e-4, 3e-5


def _problem(seed=0, n_ctx=40, n_items=25, nnz=200, alpha0=0.4, k=8,
             empty_tail=2):
    rng = np.random.default_rng(seed)
    cells = rng.choice((n_ctx - empty_tail) * n_items, size=nnz, replace=False)
    ctx, item = cells // n_items, cells % n_items
    y = rng.integers(1, 5, size=nnz).astype(np.float64)
    alpha = alpha0 + 1.0 + rng.random(nnz)
    w0 = (0.1 * rng.normal(size=(n_ctx, k))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(n_items, k))).astype(np.float32)
    jd = jbuild(ctx, item, y, alpha, n_ctx, n_items, alpha0=alpha0)
    td = build_interactions(ctx, item, y, alpha, n_ctx, n_items,
                            alpha0=alpha0, device="cpu")
    jp = jmf.MFParams(jnp.asarray(w0), jnp.asarray(h0))
    tp = mf.params_from_numpy(w0, h0, device="cpu")
    return jd, td, jp, tp


def _close(tp, jp, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(tp.w.numpy(), np.asarray(jp.w), rtol=rtol, atol=atol)
    np.testing.assert_allclose(tp.h.numpy(), np.asarray(jp.h), rtol=rtol, atol=atol)


def _hps(**kw):
    return (jmf.MFHyperParams(k=8, alpha0=0.4, l2=0.05, **kw),
            mf.MFHyperParams(k=8, alpha0=0.4, l2=0.05, **kw))


@pytest.mark.parametrize("implementation", ["xla", "pallas"])
def test_mf_epochs_match_reference(implementation):
    jd, td, jp, tp = _problem()
    jhp, thp = _hps(implementation=implementation)
    je, te = jmf.residuals(jp, jd), mf.residuals(tp, td)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    for _ in range(2):
        jp, je = jmf.epoch(jp, jd, je, jhp)
        w_in, e_in = tp.w.clone(), te.clone()
        tp2, te2 = mf.epoch(tp, td, te, thp)
        # the segment-sum epoch leaves its inputs as they were
        assert torch.equal(tp.w, w_in) and torch.equal(te, e_in)
        tp, te = tp2, te2
        _close(tp, jp)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(mf.objective(tp, td, thp)),
                               float(jmf.objective(jp, jd, jhp)), rtol=1e-5)


@pytest.mark.parametrize("block_k,psi_dispatch", [
    (1, "gather"), (0, "gather"), (0, "pregather"), (3, "gather"),
    (3, "pregather")])
def test_mf_padded_epochs_match_reference(block_k, psi_dispatch):
    """k = 8: block_k 1 (per column), 0 (auto, one block of 8), 3 (two
    blocks and a tail of 2), with empty-context rows in the grid."""
    jd, td, jp, tp = _problem(seed=11)
    jhp, thp = _hps(block_k=block_k, psi_dispatch=psi_dispatch)
    jpd, tpd = jmfp.pad_interactions(jd), mf_padded.pad_interactions(td)
    je, te = jmfp.residuals(jp, jpd), mf_padded.residuals(tp, tpd)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    for _ in range(2):
        jp, je = jmfp.epoch(jp, jpd, je, jhp)
        tp, te = mf_padded.epoch(tp, tpd, te, thp)
        _close(tp, jp)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=RTOL, atol=ATOL)
    assert cd_ops.cd_block_sweep.launches == 0 and gram_ops.gram.launches == 0


def test_port_mf_padded_matches_port_mf():
    _, td, _, tp = _problem(seed=12)
    _, thp = _hps(block_k=3)
    tpd = mf_padded.pad_interactions(td)
    p_ref, e_ref = tp, mf.residuals(tp, td)
    p_pad, e_pad = tp, mf_padded.residuals(tp, tpd)
    for _ in range(3):
        p_ref, e_ref = mf.epoch(p_ref, td, e_ref, thp)
        p_pad, e_pad = mf_padded.epoch(p_pad, tpd, e_pad, thp)
        np.testing.assert_allclose(p_pad.w.numpy(), p_ref.w.numpy(),
                                   rtol=PAIR_RTOL, atol=PAIR_ATOL)
        np.testing.assert_allclose(p_pad.h.numpy(), p_ref.h.numpy(),
                                   rtol=PAIR_RTOL, atol=PAIR_ATOL)
    # the padded grid's real slots hold the flat residuals
    np.testing.assert_allclose(
        e_pad[tpd.c_rows, tpd.c_cols].numpy(), e_ref.numpy(),
        rtol=PAIR_RTOL, atol=PAIR_ATOL)


def test_gather_and_pregather_agree_to_roundoff():
    _, td, _, tp = _problem(seed=13)
    tpd = mf_padded.pad_interactions(td)
    finals = []
    for disp in ("gather", "pregather"):
        _, thp = _hps(block_k=3, psi_dispatch=disp)
        p, e = tp, mf_padded.residuals(tp, tpd)
        for _ in range(2):
            p, e = mf_padded.epoch(p, tpd, e, thp)
        finals.append((p, e))
    (pa, ea), (pb, eb) = finals
    for a, b in ((pa.w, pb.w), (pa.h, pb.h), (ea, eb)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_weights_ones_is_unweighted_and_weights_match_reference():
    jd, td, jp, tp = _problem(seed=14)
    jhp, thp = _hps(block_k=3)
    wts = np.random.default_rng(1).random(td.nnz).astype(np.float32) + 0.5
    e = mf.residuals(tp, td)
    p_none, e_none = mf.epoch(tp, td, e, thp)
    p_ones, e_ones = mf.epoch(tp, td, e, thp, weights=torch.ones(td.nnz))
    assert torch.equal(p_none.w, p_ones.w) and torch.equal(e_none, e_ones)
    p_w, _ = mf.epoch(tp, td, e, thp, weights=torch.from_numpy(wts))
    jp_w, _ = jmf.epoch(jp, jd, jmf.residuals(jp, jd), jhp,
                        weights=jnp.asarray(wts))
    _close(p_w, jp_w)
    tpd, jpd = mf_padded.pad_interactions(td), jmfp.pad_interactions(jd)
    pa, _ = mf_padded.epoch(tp, tpd, mf_padded.residuals(tp, tpd), thp)
    pb, _ = mf_padded.epoch(tp, tpd, mf_padded.residuals(tp, tpd), thp,
                            weights=torch.ones(td.nnz))
    assert torch.equal(pa.w, pb.w) and torch.equal(pa.h, pb.h)
    pw, _ = mf_padded.epoch(tp, tpd, mf_padded.residuals(tp, tpd), thp,
                            weights=torch.from_numpy(wts))
    jw, _ = jmfp.epoch(jp, jpd, jmfp.residuals(jp, jpd), jhp,
                       weights=jnp.asarray(wts))
    _close(pw, jw)


@pytest.mark.parametrize("kind,bps", [("rotating", 1), ("randomized", 0)])
def test_scheduled_epochs_match_reference(kind, bps):
    jd, td, jp, tp = _problem(seed=15)
    jhp, thp = _hps()
    js = jsweeps.SweepSchedule(kind=kind, block=3, blocks_per_sweep=bps, seed=2)
    ts = sweeps.SweepSchedule(kind=kind, block=3, blocks_per_sweep=bps, seed=2)
    je, te = jmf.residuals(jp, jd), mf.residuals(tp, td)
    for ep in range(2):
        jp, je = jmf.epoch(jp, jd, je, jhp, js, ep)
        tp, te = mf.epoch(tp, td, te, thp, ts, ep)
        _close(tp, jp)


def test_fit_runs_the_callback_and_lowers_the_objective():
    jd, td, jp, tp = _problem(seed=16)
    _, thp = _hps()
    seen = []
    out = mf.fit(tp, td, thp, 3, callback=lambda ep, p: seen.append(
        float(mf.objective(p, td, thp))))
    assert len(seen) == 3 and all(b < a for a, b in zip(seen, seen[1:]))
    assert float(mf.objective(out, td, thp)) == pytest.approx(seen[-1])
    jout = jmf.fit(jp, jd, jmf.MFHyperParams(k=8, alpha0=0.4, l2=0.05), 3)
    _close(out, jout)
    tpd = mf_padded.pad_interactions(td)
    padded = mf_padded.fit(tp, tpd, thp, 3, callback=lambda ep, p: None)
    np.testing.assert_allclose(padded.w.numpy(), out.w.numpy(),
                               rtol=PAIR_RTOL, atol=PAIR_ATOL)


def _eval_setup(seed=0, n_ctx=40, n_items=120, k=8):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.normal(size=(n_ctx, k))).astype(np.float32)
    h = (0.3 * rng.normal(size=(n_items, k))).astype(np.float32)
    truth = rng.integers(0, n_items, size=n_ctx)
    excl = [rng.choice(n_items, size=int(rng.integers(0, 6)), replace=False)
            for _ in range(n_ctx)]
    return w, h, truth, excl


def test_ranking_eval_and_engine_match_reference():
    w, h, truth, excl = _eval_setup()
    tp = mf.params_from_numpy(w, h, device="cpu")
    jp = jmf.MFParams(jnp.asarray(w), jnp.asarray(h))
    phi = mf.build_phi(tp, torch.arange(40))
    res = ranking_eval(phi, mf.export_psi(tp), truth, k=10, batch_rows=13,
                       exclude=excl)
    jres = j_ranking_eval(jmf.build_phi(jp, jnp.arange(40)), jmf.export_psi(jp),
                          truth, k=10, batch_rows=13, exclude=excl,
                          block_items=128)
    for key in ("recall@10", "ndcg@10"):
        np.testing.assert_allclose(res[key], jres[key], atol=1e-6)
    assert res["n_eval"] == 40 and res["coverage"] == 1.0
    eng = RetrievalEngine(mf.export_psi(tp), lambda c: mf.build_phi(tp, c), k=10)
    jeng = JEngine(jmf.export_psi(jp), lambda c: jmf.build_phi(jp, c), k=10,
                   block_items=128)
    eids = exclude_ids_from_lists(excl, device="cpu")
    s, i = eng.topk(torch.arange(40), exclude_ids=eids)
    js, ji = jeng.topk(jnp.arange(40), exclude_ids=jnp.asarray(eids.numpy()))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    mask = exclude_mask_from_lists(excl, 120, device="cpu")
    _, im = eng.topk(torch.arange(40), exclude_mask=mask)
    np.testing.assert_array_equal(im.numpy(), i.numpy())
    assert eng.n_items == 120 and eng.scores(phi[:2]).shape == (2, 120)
    assert overlap_recall(i, i) == 1.0
    with pytest.raises(RuntimeError, match="from_model"):
        eng.fold_in_phi([1, 2])
    # the IVF tier: probing every cluster is the exact engine's answer,
    # and the dense mask form is refused there, as in the reference
    from repro_torch.serve.ann import AnnConfig

    ivf = RetrievalEngine(mf.export_psi(tp), lambda c: mf.build_phi(tp, c),
                          k=10, retrieval="ivf",
                          ann=AnnConfig(n_clusters=4, n_probe=4))
    si, ii = ivf.topk(torch.arange(40), exclude_ids=eids)
    np.testing.assert_array_equal(ii.numpy(), i.numpy())
    np.testing.assert_allclose(si.numpy(), s.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="exclude_mask"):
        ivf.topk(torch.arange(40), exclude_mask=mask)
    psi = mf.export_psi(tp)
    out = bulk_score(mf_retrieval_score_fn(phi[0], psi), torch.arange(120),
                     chunk=50)
    np.testing.assert_allclose(out.numpy(), (psi @ phi[0]).numpy(), rtol=1e-6)
    batch = mf_retrieval_score_fn(phi[:3], psi)(torch.arange(7))
    np.testing.assert_allclose(batch.numpy(), (phi[:3] @ psi[:7].T).numpy(),
                               rtol=1e-6)


def test_ranking_eval_through_the_mesh():
    """cluster= streams the same batches through the fault-tolerant mesh:
    with every range live the metrics equal the single-table path at any
    shard count; with one unreplicated shard dead the result says so."""
    from repro_torch.serve.mesh import FaultInjector, FaultTolerantRetrievalMesh

    w, h, truth, excl = _eval_setup(seed=6)
    phi, psi = torch.from_numpy(w), torch.from_numpy(h)
    single = ranking_eval(phi, psi, truth, k=10, batch_rows=13, exclude=excl)
    for n_shards in (1, 3):
        mesh = FaultTolerantRetrievalMesh(n_shards=n_shards, n_replicas=2, k=10,
                                          psi_table=psi)
        res = ranking_eval(phi, None, truth, k=10, batch_rows=13, exclude=excl,
                           cluster=mesh)
        assert res["recall@10"] == single["recall@10"]
        assert res["ndcg@10"] == single["ndcg@10"] and res["coverage"] == 1.0
    inj = FaultInjector()
    inj.fail(1, 0)
    mesh = FaultTolerantRetrievalMesh(n_shards=3, n_replicas=1, k=10,
                                      psi_table=psi, injector=inj)
    res = ranking_eval(phi, None, truth, k=10, exclude=excl, cluster=mesh)
    assert res["coverage"] < 1.0 and res["dead_ranges"] == ((40, 80),)


def test_fit_eval_callback_matches_reference():
    jd, td, jp, tp = _problem(seed=17, n_ctx=30, n_items=40)
    jhp, thp = _hps()
    truth = np.random.default_rng(2).integers(0, 40, 30)
    cb = fit_eval_callback(lambda p: (mf.build_phi(p, torch.arange(30)),
                                      mf.export_psi(p)), truth, k=5)
    jcb = j_fit_eval_callback(lambda p: (jmf.build_phi(p, jnp.arange(30)),
                                         jmf.export_psi(p)), truth, k=5)
    mf.fit(tp, td, thp, 2, callback=cb)
    jmf.fit(jp, jd, jhp, 2, callback=jcb)
    assert [h["epoch"] for h in cb.history] == [0, 1]
    for got, want in zip(cb.history, jcb.history):
        np.testing.assert_allclose(got["recall@5"], want["recall@5"], atol=1e-6)


def test_quickstart_twin_recall_matches_reference_quickstart():
    """The quickstart on the same data from the same initial factors (the
    JAX quickstart's ``mf.init(PRNGKey(0))`` carried over): Recall@10 of
    iCD-MF within 1/400 (one of the 400 users) of the reference's, and
    popularity's equal. 10 epochs instead of 20, for test time."""
    from repro.sparse.interactions import build_interactions as jbuild_

    ds, train, users, truth = quickstart.leave_one_out()
    params0 = jmf.init(jax.random.PRNGKey(0), ds.n_users, ds.n_items, quickstart.K)
    pairs = np.unique(train[:, :2], axis=0)
    jdata = jbuild_(pairs[:, 0], pairs[:, 1], np.ones(len(pairs)),
                    np.full(len(pairs), quickstart.ALPHA0 + 4.0),
                    ds.n_users, ds.n_items, alpha0=quickstart.ALPHA0)
    jhp = jmf.MFHyperParams(k=quickstart.K, alpha0=quickstart.ALPHA0, l2=quickstart.L2)
    jparams = jmf.fit(params0, jdata, jhp, n_epochs=10)
    j_r = float(j_recall_at_k(jmf.scores_all(jparams)[users], truth, 10))
    out = quickstart.run(device="cpu", n_epochs=10, log=lambda m: None,
                         init=(np.asarray(params0.w), np.asarray(params0.h)))
    pop = np.bincount(train[:, 1], minlength=ds.n_items)
    j_pop = float(j_recall_at_k(np.tile(pop, (len(users), 1)), truth, 10))
    assert abs(out["recall"] - j_r) <= 1 / 400 + 1e-9
    assert out["recall_pop"] == pytest.approx(j_pop)
    assert out["recall"] > out["recall_pop"]
    np.testing.assert_allclose(out["params"].w.numpy(), np.asarray(jparams.w),
                               rtol=5e-3, atol=5e-4)


def test_quickstart_twin_cli_on_cpu():
    out = quickstart.main(["--device", "cpu"])
    assert out["recall"] > out["recall_pop"]
    objs = out["objectives"]
    assert len(objs) == 4 and all(b < a for a, b in zip(objs, objs[1:]))
