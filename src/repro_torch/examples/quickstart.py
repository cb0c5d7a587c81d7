"""Quickstart: train iCD-MF on synthetic implicit feedback and evaluate
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

400 users × 800 items from the seeded generator, a leave-one-out split
(each user's last event held out), 20 epochs of ``mf.fit`` at k = 16, then
Recall@10 of iCD-MF against item popularity; the script asserts that
iCD-MF wins. It runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.metrics import recall_at_k
from repro_torch.core.models import mf
from repro_torch.data.synthetic import make_implicit_dataset
from repro_torch.kernels import resolve_device
from repro_torch.sparse.interactions import build_interactions

K, ALPHA0, L2, EPOCHS = 16, 0.5, 0.05, 20


def leave_one_out():
    """The quickstart's data: ``(dataset, train events, users, held-out
    item per user)``, each user's last event held out."""
    ds = make_implicit_dataset(n_users=400, n_items=800, pop_strength=0.4,
                               taste_strength=2.5, seed=0)
    events = ds.events
    last = {}
    for idx, (u, _i, _t) in enumerate(events):
        last[u] = idx
    held = np.zeros(len(events), bool)
    held[list(last.values())] = True
    users = np.asarray(sorted(last))
    truth = np.asarray([events[last[u]][1] for u in users])
    return ds, events[~held], users, truth


def run(*, device=None, n_epochs: int = EPOCHS, init=None, log=print) -> dict:
    """Train and evaluate; returns Recall@10 of iCD-MF and of popularity,
    and the objective every 5 epochs. ``init`` = numpy ``(w, h)`` starts
    from given factors instead of the seeded ``mf.init``."""
    device = resolve_device(device)
    ds, train, users, truth = leave_one_out()
    # Lemma 1: rescale observed feedback, keep α₀ for the implicit zeros
    pairs = np.unique(train[:, :2], axis=0)
    data = build_interactions(
        pairs[:, 0], pairs[:, 1], np.ones(len(pairs)),
        np.full(len(pairs), ALPHA0 + 4.0), ds.n_users, ds.n_items,
        alpha0=ALPHA0, device=device)
    hp = mf.MFHyperParams(k=K, alpha0=ALPHA0, l2=L2)
    if init is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = mf.init(ds.n_users, ds.n_items, K, generator=gen)
    else:
        params = mf.params_from_numpy(*init, device=device)

    objectives = []

    def on_epoch(ep, p):
        if (ep + 1) % 5 == 0:
            objectives.append(float(mf.objective(p, data, hp)))
            log(f"epoch {ep + 1:3d}  objective {objectives[-1]:.2f}")

    params = mf.fit(params, data, hp, n_epochs=n_epochs, callback=on_epoch)

    # Recall@10 on the held-out last items
    scores = mf.scores_all(params)[torch.as_tensor(users, device=device)]
    r = float(recall_at_k(scores, torch.as_tensor(truth, device=device), 10))
    pop = torch.as_tensor(np.bincount(train[:, 1], minlength=ds.n_items),
                          dtype=torch.float32, device=device)
    r_pop = float(recall_at_k(pop.expand(len(users), -1),
                              torch.as_tensor(truth, device=device), 10))
    log(f"\nRecall@10: iCD-MF {r:.3f}  vs popularity {r_pop:.3f}")
    return {"recall": r, "recall_pop": r_pop, "objectives": objectives,
            "params": params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    assert out["recall"] > out["recall_pop"], \
        "iCD-MF should beat popularity on this data"
    return out


if __name__ == "__main__":
    main()
