"""Continual learning under traffic (port of
``examples/continual_learning.py``): train a warm model on the head of an
interaction log, go live, then replay the tail as arriving traffic and
absorb it WITHOUT retraining:

  * an unseen user gets a φ row at request time (closed-form fold-in of
    their history against the frozen ψ snapshot — ``core/foldin.py``, one
    Gram launch of ψ and a few sweeps on the table's device),
  * a brand-new item gets a ψ row folded in from its first interactions and
    enters the live catalogue through an incremental ``publish_delta``
    (version bump, no full-table republish),
  * the warm side keeps improving with subspace-scheduled sweeps
    (``SweepSchedule``): each refresh updates only a rotating k_b-column
    block and republishes with the fold-in rows composed on top.

Everything runs through the unified ``Model`` protocol
(``core/models/api.py``).

    PYTHONPATH=src python -m repro_torch.examples.continual_learning [--device cpu]

:func:`main` keeps the example's sizes (300 users × 200 items, k = 16,
the seeded generator at attr_strength 0.8) and prints its lines;
:func:`run` takes any time-ordered event log, the sizes, how many tail
batches to replay, how many users to evaluate and the device. The factors
start from a seeded CPU ``torch.Generator`` (other numbers than the
reference's JAX key; the same on every device). It runs on the GPU unless
the CPU is named.
"""
from __future__ import annotations

import argparse
import itertools
import time
import types
from typing import Optional

import numpy as np
import torch

from repro_torch.core.models import mf
from repro_torch.core.models.api import Dataset, build_model
from repro_torch.core.sweeps import SweepSchedule
from repro_torch.data.loader import interaction_stream
from repro_torch.data.synthetic import make_implicit_dataset
from repro_torch.eval.ranking import foldin_ranking_eval
from repro_torch.kernels import resolve_device
from repro_torch.serve.cluster import ShardedRetrievalCluster
from repro_torch.serve.publish import PsiPublisher
from repro_torch.sparse.interactions import build_interactions

N_USERS, N_ITEMS, K = 300, 200, 16
ALPHA0, L2, WARM_EPOCHS, N_COLD, BATCH_EVENTS = 0.3, 0.05, 6, 4, 64
N_HOLD = 8    # user queries whose inputs and results run() returns


def user_histories(events: np.ndarray, n_users: int) -> list:
    """Each user's items in log order (``SyntheticImplicitDataset.
    user_histories`` for any event log, without a Python loop over it)."""
    order = np.argsort(events[:, 0], kind="stable")
    bounds = np.searchsorted(events[order, 0], np.arange(n_users + 1))
    items = events[order, 1].astype(np.int64)
    return [items[bounds[u]:bounds[u + 1]] for u in range(n_users)]


def popularity_recall(train_items: np.ndarray, n_items: int, observed,
                      true_items, k: int = 10) -> float:
    """Recall@k of ranking by training popularity (ties by id), each
    user's observed items excluded as the fold-in eval excludes them."""
    order = np.argsort(-np.bincount(train_items, minlength=n_items),
                       kind="stable")
    hits = 0
    for seen, truth in zip(observed, true_items):
        top = order[~np.isin(order, seen)][:k]
        hits += int(truth in top)
    return hits / max(len(true_items), 1)


def run(events: np.ndarray, n_users: int, n_items: int, k: int, *,
        tail_batches: Optional[int] = None, n_eval: Optional[int] = None,
        device=None, log=print) -> dict:
    """The continual-learning loop on a time-ordered ``events`` log
    ((n, 3): user, item, t): warm-train MF on the first 80% with the last
    ``N_COLD`` item ids held out, go live on a 2-shard cluster (K = 10),
    replay ``tail_batches`` batches of ``BATCH_EVENTS`` tail events (all
    when None), then the cold-start eval over the first ``n_eval`` users
    (all when None).

    Returns the counts the example prints, the fold-in eval and the
    popularity baseline on the same users, each query's wall seconds,
    and, for the first ``N_HOLD`` user queries, what a check needs to
    recompute them: the user's history, the params and the live table
    (``PsiShardSet``) the query ran against, its φ row and its result."""
    device = resolve_device(device)
    split = int(0.8 * len(events))
    # the last N_COLD items are COLD: they never enter the warm training set
    head, n_warm_items = events[:split], n_items - N_COLD
    hists = user_histories(events, n_users)

    # --- warm phase: batch-train on the head of the log ------------------
    warm = head[head[:, 1] < n_warm_items]
    hp = mf.MFHyperParams(k=k, alpha0=ALPHA0, l2=L2)
    data = build_interactions(
        warm[:, 0], warm[:, 1], np.ones(len(warm)), np.full(len(warm), 2.0),
        n_users, n_warm_items, alpha0=hp.alpha0, device=device,
    )
    model = build_model("mf", hp=hp, dataset=Dataset(data=data))
    # drawn on the CPU and moved, so every device starts from one set
    params = mf.MFParams(*(t.to(device) for t in
                           model.init(torch.Generator().manual_seed(0))))
    t0 = time.perf_counter()
    params = model.fit(params, n_epochs=WARM_EPOCHS)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    warm_s = time.perf_counter() - t0
    warm_params = params
    log(f"warm: trained on {len(warm)} events, "
        f"{n_warm_items}/{n_items} items")

    # --- go live ---------------------------------------------------------
    # the published table composes the warm export with the fold-in rows,
    # so a full republish after a warm refresh keeps cold items live
    extra: dict = {}          # folded-in item id -> psi row

    def export(p):
        psi = model.export_psi(p)
        if extra:
            psi = torch.cat([psi, torch.stack([extra[i] for i in sorted(extra)])])
        return psi

    cluster = ShardedRetrievalCluster(
        lambda ctx: model.build_phi(params, ctx), n_shards=2, k=10,
    )
    pub = PsiPublisher(cluster, export, every=1)
    pub(0, params)
    log(f"live: psi v{cluster.version}, {cluster.n_items} items")

    # --- continual phase: replay the tail as arriving traffic ------------
    # cold items were OBSERVED in the head (just excluded from training),
    # so their early interactions are available to fold from
    item_hist: dict = {}      # interactions of not-yet-served items
    for u, i in head[head[:, 1] >= n_warm_items][:, :2]:
        item_hist.setdefault(int(i), []).append(int(u))
    folded_items = 0

    def flush_cold():
        # delta-append every cold item whose id is next in line and has
        # any history — appends must stay hole-free (see apply_delta)
        nonlocal folded_items
        while item_hist.get(cluster.n_items):
            i = cluster.n_items
            row = model.fold_in_item(params, item_hist[i])
            extra[i] = row
            pub.publish_delta(row, i)
            folded_items += 1

    folded_users, query_s, held = 0, [], []
    stream = interaction_stream(types.SimpleNamespace(events=events),
                                batch_events=BATCH_EVENTS, start=split)
    for batch in itertools.islice(stream, tail_batches):
        for u, i in zip(batch["ctx"], batch["item"]):
            u, i = int(u), int(i)
            if i >= n_warm_items:
                # new item: buffer its interactions, then fold in a psi
                # row and delta-publish it (no full-table republish)
                item_hist.setdefault(i, []).append(u)
                flush_cold()
            else:
                # request-time φ for the arriving user: closed-form against
                # the frozen warm ψ — no training state touched
                hist = hists[u][hists[u] < n_warm_items][:3]
                t = time.perf_counter()
                phi = model.fold_in_user(params, hist)
                res = cluster.topk_phi(phi.float()[None])
                query_s.append(time.perf_counter() - t)
                assert res.ids.shape[1] == 10
                if len(held) < N_HOLD:
                    held.append(dict(user=u, history=hist, params=params,
                                     table=cluster.table, phi=phi, result=res))
                folded_users += 1
        # subspace-scheduled warm refresh: ONE rotating k_b-block per
        # publish — a k_b/k fraction of a full epoch's column updates
        sched = SweepSchedule(kind="rotating", block=4, blocks_per_sweep=1)
        params, _ = model.epoch(params, model.residuals(params),
                                schedule=sched, sweep_index=cluster.version)
        pub(cluster.version, params)
    versions = [v for v, _ in pub.deltas]
    log(f"continual: {folded_users} fold-in queries answered, "
        f"{folded_items} items delta-published "
        f"(versions {versions}), now at "
        f"v{cluster.version} with {cluster.n_items} items")

    # --- cold-start eval: every eval user folded in from scratch ---------
    observed, true_items = [], []
    for h in hists[:n_eval]:
        seen = np.unique(h[:-1])
        seen = seen[seen < n_warm_items]
        if len(seen) and h[-1] < n_warm_items:
            observed.append(seen)
            true_items.append(int(h[-1]))
    res = foldin_ranking_eval(model, params, observed, true_items, k=10)
    log(f"fold-in eval: recall@10={res['recall@10']:.4f} "
        f"ndcg@10={res['ndcg@10']:.4f} over {res['n_eval']} users")
    return {
        "warm_events": len(warm), "n_warm_items": n_warm_items,
        "folded_users": folded_users, "folded_items": folded_items,
        "versions": versions, "version": cluster.version,
        "n_items_live": cluster.n_items, "recall": res["recall@10"],
        "ndcg": res["ndcg@10"], "n_eval": res["n_eval"],
        "recall_pop": popularity_recall(warm[:, 1], n_warm_items, observed,
                                        true_items),
        "query_s": query_s, "warm_s": warm_s, "held": held,
        "warm_params": warm_params, "params": params, "model": model,
        "cluster": cluster,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    ds = make_implicit_dataset(n_users=N_USERS, n_items=N_ITEMS,
                               attr_strength=0.8, seed=0)
    return run(ds.events, N_USERS, N_ITEMS, K, device=args.device)


if __name__ == "__main__":
    main()
