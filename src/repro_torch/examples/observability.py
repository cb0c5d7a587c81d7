"""End-to-end observability (port of ``examples/observability.py``): train
-> publish -> serve under injected faults -> export metrics (JSONL +
Prometheus text) and a Perfetto trace.

One registry and one tracer (``repro_torch.obs``) thread through every
layer:

  * training — ``fit_metrics_callback`` records epoch wall time, the loss
    trajectory, SweepSchedule block visits, and the analytic cd_sweep
    kernel cost, composed with a ``PsiPublisher`` that snapshots ψ into
    the live mesh at each epoch boundary;
  * serving — the ``MicroBatcher`` and ``FaultTolerantRetrievalMesh``
    share the registry and the tracer, so one batched request under an
    injected replica kill exports as a single correlated trace:
    submit -> queue -> flush -> dispatch -> failover -> merge;
  * export — ``metrics.jsonl``, ``metrics.prom`` and ``trace.json`` in the
    output directory (``results/obs`` by default; open the trace in
    Perfetto / chrome://tracing).

    PYTHONPATH=src python -m repro_torch.examples.observability [--device cpu] [--out DIR]

It runs on the GPU unless the CPU is named; the factors start from a
seeded ``torch.Generator``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core.models.api import Dataset, build_model
from repro_torch.core.models.mf import MFHyperParams
from repro_torch.core.sweeps import SweepSchedule
from repro_torch.data.synthetic import make_implicit_dataset
from repro_torch.kernels import resolve_device
from repro_torch.obs import (
    MetricsRegistry,
    Tracer,
    compose_callbacks,
    fit_metrics_callback,
    metrics_jsonl,
    trace_for_ticket,
    write_metrics,
    write_trace,
)
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.mesh import (
    FaultInjector,
    FaultTolerantRetrievalMesh,
    RetryPolicy,
)
from repro_torch.serve.publish import PsiPublisher
from repro_torch.sparse.interactions import build_interactions

OUT_DIR = os.path.join("results", "obs")


def run(*, out_dir: str = OUT_DIR, device=None, log=print) -> dict:
    """Train, serve under a replica kill and export; returns the losses,
    published versions, mesh counters, the first ticket's span names and
    the three files' paths."""
    device = resolve_device(device)
    registry = MetricsRegistry(clock=time.perf_counter)
    tracer = Tracer(clock=time.perf_counter)

    # --- train: metrics callback + live psi publishes --------------------
    n_users, n_items, k, k_b = 200, 120, 16, 4
    ds = make_implicit_dataset(n_users=n_users, n_items=n_items, seed=0)
    ev = ds.events
    data = build_interactions(
        ev[:, 0], ev[:, 1], np.ones(len(ev)), np.full(len(ev), 2.0),
        n_users, n_items, alpha0=0.3, device=device,
    )
    hp = MFHyperParams(k=k, alpha0=0.3, l2=0.05)
    model = build_model("mf", hp=hp, dataset=Dataset(data=data))
    params = model.init(torch.Generator(device=device).manual_seed(0))

    injector = FaultInjector()
    mesh = FaultTolerantRetrievalMesh(
        lambda ctx: model.build_phi(params, ctx),
        n_shards=2, n_replicas=2, k=10, injector=injector,
        retry=RetryPolicy(max_attempts=3, deadline=5e-3),
        registry=registry, tracer=tracer,
    )
    schedule = SweepSchedule(kind="rotating", block=k_b)
    publisher = PsiPublisher(mesh, model.export_psi, every=1,
                             registry=registry)
    d_pad = -(-n_items // 128) * 128
    cb = compose_callbacks(
        fit_metrics_callback(
            registry=registry, objective=model.objective,
            schedule=schedule, n_dims=k, block=k_b,
            cd_shape=(n_users, d_pad, k),
        ),
        publisher,
    )
    params = model.fit(params, n_epochs=4, callback=cb, schedule=schedule)
    metrics_cb = cb.callbacks[0]
    losses = [loss for _, _, loss in metrics_cb.history]
    versions = [v for _, v in publisher.versions]
    log(f"train: {len(metrics_cb.history)} epochs, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"psi versions published: {versions}")

    # --- serve under an injected replica kill ----------------------------
    injector.fail(0, 0, "error")     # sticky: replica (0,0) dies; R=2
    batcher = MicroBatcher(
        lambda phi, eids: mesh.topk_phi(phi, exclude_ids=eids),
        max_batch=8, max_delay=5e-3, clock=time.perf_counter,
        version_fn=lambda: mesh.version,
        registry=registry, tracer=tracer,
    )
    phi_all = model.build_phi(params, np.arange(n_users)).cpu().numpy()
    tickets = [batcher.submit(phi_all[u], key=("user", int(u)))
               for u in range(8)]
    batcher.step()
    batcher.flush()
    res = batcher.result(tickets[0])
    batcher.drain()
    ms = mesh.stats
    log(f"serve: {ms['dispatches']} dispatches, {ms['faults']} fault(s), "
        f"{ms['failovers']} failover(s), "
        f"coverage={res.coverage:.4f} (kill was invisible: R=2)")
    assert ms["faults"] >= 1 and ms["failovers"] >= 1
    assert res.coverage == 1.0

    # one ticket's whole story, correlated across layers
    span_names = {s.name for s in trace_for_ticket(tracer, tickets[0])}
    log(f"trace[ticket {tickets[0]}]: spans {sorted(span_names)}")
    assert {"request", "queue", "flush", "dispatch", "merge"} <= span_names

    # --- export ----------------------------------------------------------
    os.makedirs(out_dir, exist_ok=True)
    jsonl_path = os.path.join(out_dir, "metrics.jsonl")
    prom_path = os.path.join(out_dir, "metrics.prom")
    trace_path = os.path.join(out_dir, "trace.json")
    write_metrics(jsonl_path, registry)
    write_metrics(prom_path, registry)
    write_trace(trace_path, tracer)
    n_lines = len(metrics_jsonl(registry).splitlines())
    with open(trace_path) as fh:
        n_events = len(json.load(fh)["traceEvents"])
    log(f"export: {n_lines} metric series -> {jsonl_path} / {prom_path}; "
        f"{n_events} trace events -> {trace_path} "
        "(open in Perfetto / chrome://tracing)")
    return {"losses": losses, "versions": versions, "mesh_stats": dict(ms),
            "spans": sorted(span_names), "n_series": n_lines,
            "n_trace_events": n_events,
            "files": {"jsonl": jsonl_path, "prom": prom_path,
                      "trace": trace_path}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions)")
    ap.add_argument("--out", default=OUT_DIR,
                    help=f"output directory (default {OUT_DIR})")
    args = ap.parse_args(argv)
    return run(out_dir=args.out, device=args.device)


if __name__ == "__main__":
    main()
