"""Serving: the sharded online retrieval service end to end (port of
``examples/serve_retrieval.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_retrieval [--device cpu]

Train iCD-MF (1,000 users × 50,000 items, k = 64, 20,000 interactions, 2
``mf.fit`` epochs) while a :class:`PsiPublisher` publishes its ψ table into
a 4-shard cluster at every epoch boundary; answer batched and
micro-batched single-row queries over the sharded table; run the streaming
leave-one-out ranking eval through it; then harden it: replicate the
shards into a fault-tolerant mesh, kill replicas (failover, labelled
degradation, heal), gate a ψ publish behind the canary staged rollout,
and serve through the IVF tier with fp32 and int8 ψ. Each section asserts
what the reference example asserts.

It runs on the GPU unless ``--device cpu`` is given. On the card every
top-K is the hand-written kernel, whose per-row fp32 dot does not depend
on the table's size, so the cluster, the engine and the IVF oracle agree
bit for bit. On the CPU the plain version's matrix product may round a
few scores differently for tables of different row counts, so there ids
must be equal and scores agree to rtol 1e-6.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.models import mf
from repro_torch.eval.ranking import ann_recall_curve, overlap_recall, ranking_eval
from repro_torch.kernels import resolve_device
from repro_torch.kernels.topk_score.ref import topk_score_ref
from repro_torch.serve.ann import AnnConfig
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.cluster import ShardedRetrievalCluster
from repro_torch.serve.engine import RetrievalEngine
from repro_torch.serve.mesh import (
    FaultInjector,
    FaultTolerantRetrievalMesh,
    RetryPolicy,
)
from repro_torch.serve.publish import PsiPublisher, StagedRollout
from repro_torch.sparse.interactions import build_interactions

N_USERS, N_ITEMS, K, N_SHARDS, NNZ = 1000, 50_000, 64, 4, 20_000
CPU_RTOL = 1e-6


def _same(a, b, exact: bool) -> None:
    """Equal ids, and scores equal bit for bit (``exact``) or to
    CPU_RTOL."""
    (sa, ia), (sb, ib) = a, b
    assert torch.equal(ia, ib), "ids differ"
    if exact:
        assert torch.equal(sa, sb), "scores differ"
    else:
        torch.testing.assert_close(sa, sb, rtol=CPU_RTOL, atol=0.0)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(*, device=None, log=print) -> dict:
    device = resolve_device(device)
    exact = device.type == "cuda"
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    params = mf.init(N_USERS, N_ITEMS, K, generator=gen)

    def arange(n):
        return torch.arange(n, device=device)

    # --- train → publish: live ψ refresh at every epoch boundary ---------
    cells = rng.choice(N_USERS * N_ITEMS, size=NNZ, replace=False)
    data = build_interactions(
        cells // N_ITEMS, cells % N_ITEMS, rng.integers(1, 5, NNZ),
        1.0 + rng.random(NNZ), N_USERS, N_ITEMS, alpha0=0.1, device=device)
    cluster = ShardedRetrievalCluster(
        lambda ctx: mf.build_phi(params, ctx), n_shards=N_SHARDS, k=100)
    pub = PsiPublisher(cluster, mf.export_psi, every=1)
    hp = mf.MFHyperParams(k=K, alpha0=0.1, l2=0.05)
    params = mf.fit(params, data, hp, n_epochs=2, callback=pub)
    cluster.phi_fn = lambda ctx: mf.build_phi(params, ctx)
    versions = [v for _, v in pub.versions]
    assert versions == [1, 2], versions
    log(f"published versions {versions}: {N_ITEMS} items over {N_SHARDS} "
        f"shards (rows_per={cluster.table.rows_per})")

    # --- batched online queries over the sharded table -------------------
    for batch in (8, 64):
        ctx = arange(batch)
        cluster.topk(ctx)  # warmup
        _sync(device)
        t0 = time.perf_counter()
        cluster.topk(ctx)
        _sync(device)
        dt = time.perf_counter() - t0
        log(f"batch={batch:3d}: {dt * 1e3:7.2f} ms "
            f"({batch * N_ITEMS / dt / 1e6:.1f} M cand/s over {N_SHARDS} "
            "shards)")

    # --- sharded cluster vs single-device engine vs the plain version ----
    engine = RetrievalEngine(mf.export_psi(params),
                             lambda ctx: mf.build_phi(params, ctx), k=100)
    cres = cluster.topk(arange(8))
    eres = engine.topk(arange(8))
    _same(cres, eres, exact)
    dense = topk_score_ref(params.w[:8], params.h, 100)
    assert torch.equal(cres.ids, dense[1])
    log("cluster top-k == engine top-k == plain top-k ✓")

    # --- micro-batched single-row requests (the online p99 path) ---------
    batcher = MicroBatcher(
        lambda phi, eids: cluster.topk_phi(phi, exclude_ids=eids),
        max_batch=16, max_delay=2e-3, version_fn=lambda: cluster.version)
    users = rng.integers(0, N_USERS, size=48)
    phi_all = mf.build_phi(params, arange(N_USERS)).cpu().numpy()
    t0 = time.perf_counter()
    tickets = [batcher.submit(phi_all[u], exclude=rng.choice(N_ITEMS, size=5),
                              key=("user", int(u))) for u in users]
    batcher.flush()
    dt = time.perf_counter() - t0
    assert all(batcher.result(t) is not None for t in tickets)
    log(f"batcher: {len(users)} single-row requests in {dt * 1e3:.1f} ms, "
        f"{batcher.stats['flushes']} flushes "
        f"(size={batcher.stats['flush_by_size']} "
        f"forced={batcher.stats['flush_forced']}), "
        f"cache_hits={batcher.stats['cache_hits']} ✓")

    # --- streaming sharded eval: full catalogue, no (n_eval, n_items) ----
    n_eval = 512
    true_items = rng.integers(0, N_ITEMS, size=n_eval)
    res = ranking_eval(
        mf.build_phi(params, arange(n_eval)), None, true_items, k=100,
        batch_rows=256, cluster=cluster,
        exclude=[rng.choice(N_ITEMS, size=20, replace=False)
                 for _ in range(n_eval)])
    log(f"streaming sharded eval: recall@100={res['recall@100']:.4f} "
        f"ndcg@100={res['ndcg@100']:.4f} over {res['n_eval']} contexts")

    # --- fault tolerance: replication, failover, graceful degradation ----
    inj = FaultInjector()
    mesh = FaultTolerantRetrievalMesh(
        lambda ctx: mf.build_phi(params, ctx), n_shards=N_SHARDS,
        n_replicas=2, k=100, injector=inj,
        retry=RetryPolicy(max_attempts=3, deadline=2e-3))
    mesh.publish(mf.export_psi(params))
    base = mesh.topk(arange(8))
    inj.fail(1, 0, "error")  # kill one replica of shard 1 mid-traffic
    ft = mesh.topk(arange(8))
    assert ft.coverage == 1.0
    assert torch.equal(ft.ids, base.ids) and torch.equal(ft.scores, base.scores)
    log("replica kill under R=2: failover bit-identical ✓")
    inj.fail(1, 1, "error")  # kill the other copy: the row range is gone
    deg = mesh.topk(arange(8))
    assert deg.coverage < 1.0
    log(f"both replicas dead: query still completes, "
        f"coverage={deg.coverage:.4f}, dead item ranges={deg.dead_ranges}")
    inj.heal()
    mesh.heal()  # re-place the orphaned range from the authoritative copy
    healed = mesh.topk(arange(8))
    assert healed.coverage == 1.0 and torch.equal(healed.ids, base.ids)
    log("heal(): replicas re-placed, full coverage restored ✓")

    # --- staged rollout: canary + mirrored traffic gate the ψ publish ----
    rollout = StagedRollout(mesh, mirror_phi=mf.build_phi(params, arange(16)))
    ok, _ = rollout.publish(mf.export_psi(params))
    bad = torch.full((N_ITEMS, K), float("nan"), device=device)  # broken export
    ok_bad, report = rollout.publish(bad)
    assert ok and not ok_bad and mesh.version == 2
    log(f"staged rollout: good table promoted (v{mesh.version}), NaN "
        f"table rolled back (checks={report['checks']}) ✓")

    # --- IVF approximate tier + quantized ψ (serve/ann.py) ---------------
    n_c = 32
    ivf = RetrievalEngine(
        mf.export_psi(params), lambda ctx: mf.build_phi(params, ctx), k=100,
        retrieval="ivf", ann=AnnConfig(n_clusters=n_c, n_probe=n_c,
                                       quant="none"))
    ores = ivf.topk(arange(8))
    _same(ores, eres, exact)
    log(f"ivf oracle (n_probe=n_clusters={n_c}): identical to exact ✓")
    curve = ann_recall_curve(
        ivf.index, mf.build_phi(params, arange(8)), mf.export_psi(params),
        k=100, n_probes=(2, 4, 8, n_c))
    assert curve[-1]["recall@100"] == 1.0, curve
    log("ivf recall-vs-probe: "
        f"{ {pt['n_probe']: round(pt['recall@100'], 3) for pt in curve} }")
    q8 = RetrievalEngine(
        mf.export_psi(params), lambda ctx: mf.build_phi(params, ctx), k=100,
        retrieval="ivf", ann=AnnConfig(n_clusters=n_c, n_probe=n_c,
                                       quant="int8"))
    _, qi = q8.topk(arange(8))
    recall8 = overlap_recall(qi, eres.ids)
    log(f"int8 ψ (per-row scales): id recall vs exact = {recall8:.3f}, "
        "~3.9x rows per shard at D=128 ✓")
    return {"versions": versions, "eval": res, "recall_curve": curve,
            "int8_recall": recall8, "mesh_version": mesh.version,
            "degraded_coverage": deg.coverage}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
