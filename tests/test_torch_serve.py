"""The port's serve tier (``repro_torch.serve``) held against the JAX
package's on the same MF factors: cluster and mesh results at several
shard and replica counts, failover and degradation, the micro-batcher on a
simulated clock, and one request trace through both whole stacks.

Factors come from the JAX package's ``mf.init`` and cross to the port as
numpy arrays (``mf.params_from_numpy``). Ids must match exactly; fp32
scores to rtol 1e-5 / atol 1e-6 (the two packages sum in different
orders). Within the port, failover must be bit-invisible."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.models import mf as jax_mf
from repro.serve.batcher import MicroBatcher as JaxBatcher
from repro.serve.cluster import cluster_topk as jax_cluster_topk
from repro.serve.cluster import shard_psi as jax_shard_psi
from repro.serve.mesh import FaultInjector as JaxInjector
from repro.serve.mesh import FaultTolerantRetrievalMesh as JaxMesh
from repro.serve.mesh import RetryPolicy as JaxRetry
from repro_torch.core.models import mf
from repro_torch.kernels.topk_score.ref import topk_score_ref
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.cluster import cluster_topk, shard_psi
from repro_torch.serve.mesh import (
    FaultInjector,
    FaultTolerantRetrievalMesh,
    RetryPolicy,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N_CTX, N_ITEMS, K_DIM = 40, 77, 8


def _params(seed=0):
    jp = jax_mf.init(jax.random.PRNGKey(seed), N_CTX, N_ITEMS, K_DIM)
    return jp, mf.params_from_numpy(np.asarray(jp.w), np.asarray(jp.h),
                                    device="cpu")


def _same(port_res, jax_res):
    ps, pi = port_res
    js, ji = jax_res
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(ji))
    np.testing.assert_allclose(np.asarray(ps), np.asarray(js),
                               rtol=RTOL, atol=ATOL)


def _exclude(b, seed, width=5):
    rng = np.random.default_rng(seed)
    out = np.full((b, width), -1, np.int32)
    for r in range(b):
        n = int(rng.integers(0, width + 1))
        out[r, :n] = rng.choice(N_ITEMS, size=n, replace=False)
    return out


def test_params_carry_over_and_serving_functions():
    jp, tp = _params(1)
    ctx = np.array([3, 0, 39, 7])
    np.testing.assert_array_equal(mf.build_phi(tp, ctx).numpy(),
                                  np.asarray(jax_mf.build_phi(jp, ctx)))
    np.testing.assert_array_equal(mf.export_psi(tp).numpy(),
                                  np.asarray(jax_mf.export_psi(jp)))
    item = np.array([1, 76, 5, 5])
    np.testing.assert_allclose(mf.predict(tp, ctx, item).numpy(),
                               np.asarray(jax_mf.predict(jp, ctx, item)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mf.scores_all(tp).numpy(),
                               np.asarray(jax_mf.scores_all(jp)),
                               rtol=RTOL, atol=ATOL)
    g = torch.Generator().manual_seed(0)
    p = mf.init(5, 6, 3, generator=g)
    assert p.w.shape == (5, 3) and p.h.shape == (6, 3)
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(mf.init(5, 6, 3, generator=g2).w, p.w)


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_cluster_topk_matches_jax(n_shards):
    jp, tp = _params(2)
    ctx = np.arange(0, N_CTX, 3)
    eids = _exclude(len(ctx), 3)
    jt = jax_shard_psi(jax_mf.export_psi(jp), n_shards)
    pt = shard_psi(mf.export_psi(tp), n_shards)
    for kw_j, kw_p in (({}, {}), ({"exclude_ids": jnp.asarray(eids)},
                                  {"exclude_ids": torch.from_numpy(eids)})):
        jr = jax_cluster_topk(jt, jax_mf.build_phi(jp, ctx), 12,
                              block_items=128, **kw_j)
        pr = cluster_topk(pt, mf.build_phi(tp, ctx), 12, **kw_p)
        _same(pr, jr)
        assert pr.coverage == 1.0 and pr.dead_ranges == ()
    # shard-count invariance is bit-exact within the port
    one = cluster_topk(shard_psi(mf.export_psi(tp), 1), mf.build_phi(tp, ctx), 12)
    pr = cluster_topk(pt, mf.build_phi(tp, ctx), 12)
    assert torch.equal(pr.ids, one.ids) and torch.equal(pr.scores, one.scores)
    dead = cluster_topk(pt, mf.build_phi(tp, ctx), 12, dead_shards=[0])
    jdead = jax_cluster_topk(jt, jax_mf.build_phi(jp, ctx), 12,
                             block_items=128, dead_shards=[0])
    assert dead.coverage == jdead.coverage
    assert dead.dead_ranges == jdead.dead_ranges


def _meshes(jp, tp, n_shards, n_replicas, k=13):
    common = dict(n_shards=n_shards, n_replicas=n_replicas, k=k)
    jm = JaxMesh(lambda c: jax_mf.build_phi(jp, c), injector=JaxInjector(),
                 retry=JaxRetry(max_attempts=3, backoff_base=1e-4),
                 block_items=128, **common)
    pm = FaultTolerantRetrievalMesh(
        lambda c: mf.build_phi(tp, c), injector=FaultInjector(),
        retry=RetryPolicy(max_attempts=3, backoff_base=1e-4), **common)
    jm.publish(jax_mf.export_psi(jp))
    pm.publish(mf.export_psi(tp))
    return jm, pm


@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("n_replicas", [1, 2])
def test_mesh_topk_phi_matches_jax_with_faults(n_shards, n_replicas):
    jp, tp = _params(4)
    jm, pm = _meshes(jp, tp, n_shards, n_replicas)
    ctx = np.arange(1, N_CTX, 4)
    eids = _exclude(len(ctx), 5)
    phi_j, phi_p = jax_mf.build_phi(jp, ctx), mf.build_phi(tp, ctx)
    healthy = pm.topk_phi(phi_p, exclude_ids=eids)
    _same(healthy, jm.topk_phi(phi_j, exclude_ids=jnp.asarray(eids)))
    if n_replicas == 2:
        # kill one replica of the last shard: failover is invisible
        pm.injector.fail(n_shards - 1, 0, "error")
        for _ in range(2):   # round robin reaches the killed replica once
            res = pm.topk_phi(phi_p, exclude_ids=eids)
            assert res.coverage == 1.0 and res.dead_ranges == ()
            assert torch.equal(res.ids, healthy.ids)
            assert torch.equal(res.scores, healthy.scores)
        assert pm.injector.triggered == 1 and pm.stats["failovers"] == 1
    # kill every replica of shard 0: degrade exactly like the JAX mesh
    for r in range(n_replicas):
        pm.injector.fail(0, r, "error")
        jm.injector.fail(0, r, "error")
    pres = pm.topk_phi(phi_p, exclude_ids=eids)
    jres = jm.topk_phi(phi_j, exclude_ids=jnp.asarray(eids))
    assert pres.coverage == pytest.approx(jres.coverage)
    assert pres.dead_ranges == jres.dead_ranges
    assert (pres.coverage < 1.0) == (jres.coverage < 1.0)
    _same(pres, jres)
    # heal re-places the dead range and full coverage returns
    pm.injector.heal()
    assert pm.heal()
    assert pm.topk_phi(phi_p, exclude_ids=eids).coverage == 1.0


def test_mesh_deadline_budget_and_stale_refusal():
    _, tp = _params(6)
    inj = FaultInjector()
    pm = FaultTolerantRetrievalMesh(
        lambda c: mf.build_phi(tp, c), n_shards=2, n_replicas=1, k=5,
        injector=inj, retry=RetryPolicy(max_attempts=3, deadline=2e-3))
    pm.publish(mf.export_psi(tp))
    inj.fail(1, 0, "timeout", latency=4e-3)      # burns the whole budget
    res = pm.topk_phi(mf.build_phi(tp, [0, 1]))
    assert res.degraded and pm.stats["deadline_gaveups"] == 1
    assert pm.stats["fault_burned_s"] >= 4e-3
    inj.heal()
    pm.replica_set.mark_live(1, 0)
    pm.replica_set.replicas[0][0].version = 0   # stuck on an old table
    res = pm.topk_phi(mf.build_phi(tp, [0, 1]))
    assert res.dead_ranges == ((0, 39),)


def test_unported_mesh_parts_raise():
    """The mesh's IVF tier, delta publish and canary, once refused, now
    serve (held against the JAX mesh in ``test_torch_ann.py``), and so
    does the cluster's one-program ``mesh=`` path: in a world of one on
    the CPU, bit for bit the host-loop ``cluster_topk`` (several ranks:
    ``test_torch_dist.py``)."""
    from repro_torch.serve.ann import AnnConfig
    from repro_torch.serve.cluster import ShardedRetrievalCluster

    jp, tp = _params(12)
    phi = mf.build_phi(tp, np.arange(6))
    pm = FaultTolerantRetrievalMesh(n_shards=2, n_replicas=1, k=7,
                                    retrieval="ivf",
                                    ann=AnnConfig(n_clusters=3, n_probe=3))
    pm.publish(mf.export_psi(tp))
    _same(pm.topk_phi(phi), topk_score_ref(phi, tp.h, 7))
    row = torch.full((K_DIM,), 3.0)
    assert pm.publish_delta(row, [N_ITEMS]) == 2 and pm.n_items == N_ITEMS + 1
    assert int(pm.topk_phi(row[None]).ids[0, 0]) == N_ITEMS
    assert pm.begin_canary(mf.export_psi(tp)) == 3
    pm.rollback_canary()
    assert pm.begin_canary(mf.export_psi(tp)) == 3
    assert pm.promote_canary() == 3 and pm.n_items == N_ITEMS
    from repro_torch.core.models.mf_dist import make_shard_mesh
    from repro_torch.runtime.collectives import world_of_one

    cluster = ShardedRetrievalCluster(lambda c: mf.build_phi(tp, c),
                                      n_shards=1, k=3, psi_table=tp.h)
    eids = torch.tensor([[0, 5, -1]] * 6, dtype=torch.int32)
    with world_of_one("gloo"):
        mesh = make_shard_mesh(1, device_type="cpu")
        for ex in (None, eids):
            got = cluster.topk(np.arange(6), mesh=mesh, exclude_ids=ex)
            want = cluster_topk(cluster.table, phi, 3, exclude_ids=ex)
            assert torch.equal(got.ids, want.ids)
            assert torch.equal(got.scores, want.scores)
        with pytest.raises(ValueError, match="2 shards"):
            ShardedRetrievalCluster(n_shards=2, k=3, psi_table=tp.h).topk_phi(
                phi, mesh=mesh)


# ------------------------------------------------------------- batcher ---
def _stack(seed=0, n_shards=2, k=10):
    _, tp = _params(seed)
    mesh = FaultTolerantRetrievalMesh(lambda c: mf.build_phi(tp, c),
                                      n_shards=n_shards, n_replicas=1, k=k)
    mesh.publish(mf.export_psi(tp))
    clock = {"t": 0.0}
    batcher = MicroBatcher(
        lambda phi, eids: mesh.topk_phi(phi, exclude_ids=eids),
        max_batch=4, max_delay=1.0, pad_to=8, clock=lambda: clock["t"],
        version_fn=lambda: mesh.version)
    return tp, mesh, clock, batcher, mf.build_phi(tp, np.arange(N_CTX)).numpy()


def _oracle(tp, phi_row, k=10, exclude=None):
    eids = None if exclude is None else torch.tensor([exclude], dtype=torch.int32)
    s, i = topk_score_ref(torch.from_numpy(phi_row[None]), tp.h, k,
                          exclude_ids=eids)
    return s[0].numpy(), i[0].numpy()


def test_batcher_routes_out_of_order_requests_under_simulated_clock():
    tp, _, clock, batcher, phi_all = _stack()
    rng = np.random.default_rng(1)
    users = [31, 4, 17, 2, 25, 9, 11]
    excls = {u: rng.choice(N_ITEMS, size=int(rng.integers(1, 6)),
                           replace=False).tolist() for u in users}
    tickets = {}
    for j, u in enumerate(users[:3]):
        clock["t"] = 0.01 * j
        tickets[u] = batcher.submit(phi_all[u], exclude=excls[u])
    assert batcher.n_queued == 3
    assert all(batcher.result(t, pop=False) is None for t in tickets.values())
    clock["t"] = 5.0
    assert batcher.step() and batcher.stats["flush_by_deadline"] == 1
    for u in users[3:]:
        tickets[u] = batcher.submit(phi_all[u], exclude=excls[u])
    assert batcher.stats["flush_by_size"] == 1 and batcher.n_queued == 0
    for u in users:
        scores, ids = batcher.result(tickets[u])
        rs, ri = _oracle(tp, phi_all[u], exclude=excls[u])
        np.testing.assert_array_equal(ids, ri)
        np.testing.assert_allclose(scores, rs, rtol=RTOL, atol=ATOL)
        assert not np.isin(ids[ids >= 0], excls[u]).any()


def test_batcher_cache_version_and_exclude_keys():
    tp, mesh, clock, batcher, phi_all = _stack(seed=3)
    t1 = batcher.submit(phi_all[7], key=("user", 7))
    batcher.flush()
    _, i1 = batcher.result(t1)
    t2 = batcher.submit(phi_all[7], key=("user", 7))
    assert batcher.stats["cache_hits"] == 1 and batcher.n_queued == 0
    np.testing.assert_array_equal(batcher.result(t2)[1], i1)
    t3 = batcher.submit(phi_all[7], exclude=[int(i1[0])], key=("user", 7))
    assert batcher.result(t3, pop=False) is None   # exclusion is in the key
    batcher.flush()
    assert int(i1[0]) not in batcher.result(t3)[1].tolist()
    mesh.publish(torch.zeros((N_ITEMS, K_DIM)))    # version bump
    t4 = batcher.submit(phi_all[7], key=("user", 7))
    assert batcher.stats["cache_evicted_stale"] == 2
    batcher.flush()
    np.testing.assert_array_equal(batcher.result(t4)[1], np.arange(10))


def test_batcher_drain_and_pad_rows():
    tp, _, _, batcher, phi_all = _stack(seed=6)
    t1 = batcher.submit(phi_all[2])
    t2 = batcher.submit(phi_all[8])
    leftovers = batcher.drain()
    assert set(leftovers) == {t1, t2} and batcher.stats["drained"] == 1
    assert batcher.stats["flushed_rows"] == 2
    np.testing.assert_array_equal(leftovers[t2].ids, _oracle(tp, phi_all[8])[1])
    assert batcher.closed and batcher.n_queued == 0
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(phi_all[0])
    assert batcher.drain() == {}
    assert batcher.result(999) is None


def test_batcher_degraded_results_are_not_cached():
    tp, mesh, clock, batcher, phi_all = _stack(seed=7)
    mesh.injector = FaultInjector()
    mesh.injector.fail(0, 0, "error")              # shard 0 has no replica left
    t1 = batcher.submit(phi_all[5], key=("user", 5))
    batcher.flush()
    res = batcher.result(t1)
    assert res.degraded and res.dead_ranges == ((0, 39),)
    assert batcher.stats["degraded_results"] == 1 and not batcher._cache
    assert (res.ids[res.ids >= 0] >= 39).all()


def test_whole_slice_request_trace_matches_jax():
    """One open-loop trace of keyed single-row requests, with exclusions
    and a killed replica, through the JAX mesh + batcher and the port's,
    both on simulated clocks: every ticket's top-K agrees."""
    jp, tp = _params(9)
    jm, pm = _meshes(jp, tp, n_shards=2, n_replicas=2, k=10)
    jm.injector.fail(0, 0, "error")
    pm.injector.fail(0, 0, "error")
    stacks = []
    for mesh, batcher_cls in ((jm, JaxBatcher), (pm, MicroBatcher)):
        clock = {"t": 0.0}
        stacks.append((clock, batcher_cls(
            lambda phi, eids, m=mesh: m.topk_phi(phi, exclude_ids=eids),
            max_batch=8, max_delay=2e-3, clock=lambda c=clock: c["t"],
            version_fn=lambda m=mesh: m.version)))
    phi_all = np.asarray(jax_mf.build_phi(jp, jnp.arange(N_CTX)))
    rng = np.random.default_rng(10)
    arrivals = np.cumsum(rng.exponential(4e-4, size=48))
    users = rng.integers(0, N_CTX, size=48)
    excl = [rng.choice(N_ITEMS, size=int(rng.integers(0, 4)), replace=False)
            .tolist() for _ in range(48)]
    tickets = [[], []]
    for t, u, e in zip(arrivals, users, excl):
        for side, (clock, batcher) in enumerate(stacks):
            clock["t"] = float(t)
            tickets[side].append(batcher.submit(
                phi_all[u], exclude=e or None, key=("user", int(u))))
            batcher.step()
    for side, (clock, batcher) in enumerate(stacks):
        clock["t"] = float(arrivals[-1]) + 1.0
        batcher.flush()
    (_, jb), (_, pb) = stacks
    assert pb.stats["flushes"] == jb.stats["flushes"]
    assert pb.stats["cache_hits"] == jb.stats["cache_hits"]
    for tj, tpk in zip(*tickets):
        jr, pr = jb.result(tj), pb.result(tpk)
        _same(pr, jr)
        assert pr.coverage == jr.coverage == 1.0
    assert pm.stats["faults"] == jm.stats["faults"] == 1
    assert pm.stats["dispatches"] == jm.stats["dispatches"]


def test_mesh_records_kernel_cost_per_successful_dispatch():
    """Each dispatch that reaches the kernel records the Hopper byte
    model: the ψ shard once per 16-row φ block, φ, the (B, k) outputs and
    the exclude lists; FLOPs are 2·B·rows·D."""
    from repro_torch.obs import MetricsRegistry, topk_score_cost

    _, tp = _params(11)
    reg = MetricsRegistry()
    pm = FaultTolerantRetrievalMesh(lambda c: mf.build_phi(tp, c), n_shards=2,
                                    n_replicas=2, k=7, registry=reg,
                                    injector=FaultInjector())
    pm.publish(mf.export_psi(tp))
    pm.injector.fail(0, 0, "error")          # a failed dispatch costs nothing
    eids = _exclude(20, 12, width=3)
    pm.topk_phi(mf.build_phi(tp, np.arange(20)), exclude_ids=eids)
    rows = pm.table.rows_per
    cost = topk_score_cost(20, rows, K_DIM, 7, excl_l=3)
    assert cost["hbm_bytes"] == 4 * (2 * rows * K_DIM + 20 * K_DIM + 20 * 3) + 8 * 20 * 7
    assert cost["flops"] == 2 * 20 * rows * K_DIM
    assert reg.get("kernel_calls_total", kernel="topk_score") == 2
    assert reg.get("kernel_hbm_bytes_total", kernel="topk_score") == 2 * cost["hbm_bytes"]
    assert reg.get("kernel_smem_bytes", kernel="topk_score") == cost["smem_bytes"]
    assert pm.stats["dispatches"] == 3 and pm.stats["faults"] == 1
