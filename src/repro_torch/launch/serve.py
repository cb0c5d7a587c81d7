"""Serving driver: fault-tolerant replicated retrieval with micro-batched
online requests (port of ``repro.launch.serve``).

  python -m repro_torch.launch.serve --arch icd-mf --smoke --device cpu \
      --requests 64 --shards 2 --replicas 2

Builds MF factors of the registry config's size from a seeded
``torch.Generator``, publishes the ψ table into a
:class:`~repro_torch.serve.mesh.FaultTolerantRetrievalMesh` (each row range
on ``--replicas`` replica slabs, failover, graceful degradation), and
replays an open-loop single-row request trace through the
:class:`~repro_torch.serve.batcher.MicroBatcher`, printing throughput,
completion-latency percentiles, coverage and the mesh's failover counters.
The retry deadline is wired to ``--max-delay``.

``--device`` defaults to ``cuda``, where every shard dispatch launches the
hand-written top-K kernel; ``--device cpu`` runs the plain PyTorch version.
With no GPU the default raises rather than falling back.

``--kill S:R`` arms a sticky injected fault on replica R of shard S before
the trace (repeatable). ``--metrics-out FILE`` exports the metrics registry
on exit (``.prom`` → Prometheus text, else JSONL), ``--trace-out FILE`` the
request trace as Chrome-trace JSON, and ``--stats-every N`` prints a live
stats line every N requests. ``--continual`` (fold-in under traffic) waits
for slice 2.

:func:`main` takes an argv list and returns a report (params, users,
per-request results, coverage, counters), so callers can drive the whole
path in-process.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import resolve_device


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the ψ slabs and kernels "
                         "(default cuda; cpu runs the plain versions)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--policy", default="round_robin",
                    choices=("round_robin", "least_outstanding"))
    ap.add_argument("--topk", type=int, default=100)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-delay", type=float, default=2e-3)
    ap.add_argument("--kill", action="append", default=[], metavar="S:R",
                    help="inject a sticky fault on replica R of shard S "
                         "(repeatable), e.g. --kill 0:0 --kill 0:1")
    ap.add_argument("--continual", action="store_true",
                    help="fold-in under traffic (not ported yet: slice 2)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="export the metrics registry on exit (.prom -> "
                         "Prometheus text exposition, else JSONL)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="export the request trace as Chrome-trace JSON "
                         "(Perfetto / chrome://tracing)")
    ap.add_argument("--stats-every", type=int, default=0, metavar="N",
                    help="print a live registry stats line every N requests")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = _parse(argv)
    if args.continual:
        raise NotImplementedError(
            "--continual is not ported yet: slice 2 (fold-in)")
    if not args.arch.startswith("icd"):
        raise SystemExit(
            f"unknown serving arch {args.arch!r}: the serve driver hosts the "
            "k-separable retrieval registry (icd-*)"
        )
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)

    from repro_torch.core.models import mf
    from repro_torch.obs import (
        MetricsRegistry,
        Tracer,
        write_metrics,
        write_trace,
    )
    from repro_torch.serve.batcher import MicroBatcher
    from repro_torch.serve.mesh import (
        FaultInjector,
        FaultTolerantRetrievalMesh,
        RetryPolicy,
    )

    # one registry + tracer for the whole serving stack, on the SAME clock
    # as the batcher so queue latencies and span times line up
    registry = MetricsRegistry(clock=time.perf_counter)
    tracer = Tracer(clock=time.perf_counter) if args.trace_out else None

    gen = torch.Generator(device=device).manual_seed(0)
    params = mf.init(cfg.n_ctx, cfg.n_items, cfg.k, generator=gen)
    k = min(args.topk, cfg.n_items)
    injector = FaultInjector()
    mesh = FaultTolerantRetrievalMesh(
        lambda ctx: mf.build_phi(params, ctx),
        n_shards=args.shards, n_replicas=args.replicas, k=k,
        policy=args.policy, injector=injector,
        # a shard's retries share the batcher's latency bound: a request
        # can burn at most max_delay on backoff before degrading instead
        retry=RetryPolicy(max_attempts=3, deadline=args.max_delay),
        registry=registry, tracer=tracer,
    )
    version = mesh.publish(mf.export_psi(params))
    print(f"[serve] published psi v{version}: {cfg.n_items} items over "
          f"{args.shards} shard(s) x {args.replicas} replica(s), top-{k}")
    for spec in args.kill:
        s, r = (int(x) for x in spec.split(":"))
        injector.fail(s, r, "error")
        print(f"[serve] chaos: armed sticky fault on replica ({s}, {r})")

    batcher = MicroBatcher(
        lambda phi, eids: mesh.topk_phi(phi, exclude_ids=eids),
        max_batch=args.max_batch, max_delay=args.max_delay,
        # same clock as t0 below: completed_at − t0 must be well-defined
        clock=time.perf_counter,
        version_fn=lambda: mesh.version,
        registry=registry, tracer=tracer,
    )
    phi_all = mf.build_phi(params, torch.arange(cfg.n_ctx)).cpu().numpy()
    rng = np.random.default_rng(0)
    users = rng.integers(0, cfg.n_ctx, size=args.requests)
    t0 = time.perf_counter()
    tickets = []
    for n, u in enumerate(users, start=1):
        tickets.append((u, batcher.submit(phi_all[u], key=("user", int(u)))))
        batcher.step()
        if args.stats_every and n % args.stats_every == 0:
            bs, ms = batcher.stats, mesh.stats
            print(f"[serve] stats @ {n}/{args.requests}: "
                  f"submitted={bs['submitted']} "
                  f"flushes={bs['flushes']} hits={bs['cache_hits']} "
                  f"dispatches={ms['dispatches']} faults={ms['faults']} "
                  f"failovers={ms['failovers']}")
    batcher.flush()  # retire the sub-batch tail
    dt = time.perf_counter() - t0
    lat, top_id, coverage, dead_ranges = [], None, 1.0, set()
    results = []
    for u, t in tickets:
        done_at = batcher.completed_at(t)
        res = batcher.result(t)
        scores, ids = res
        assert ids.shape == (k,)
        results.append(res)
        if done_at is not None:
            lat.append(done_at - t0)
        coverage = min(coverage, res.coverage)
        dead_ranges.update(res.dead_ranges)
        if top_id is None:
            top_id = int(ids[0])
    leftovers = batcher.drain()  # close admission; nothing may be stranded
    assert not leftovers and batcher.closed
    print(f"[serve] {args.requests} requests in {dt:.3f}s "
          f"({args.requests / dt:.1f} req/s), "
          f"{batcher.stats['flushes']} flushes "
          f"(size={batcher.stats['flush_by_size']} "
          f"deadline={batcher.stats['flush_by_deadline']} "
          f"forced={batcher.stats['flush_forced']}), "
          f"cache_hits={batcher.stats['cache_hits']}")
    ms = mesh.stats
    print(f"[serve] mesh: {ms['dispatches']} dispatches, "
          f"{ms['faults']} faults, {ms['failovers']} failovers, "
          f"{ms['retries']} retries "
          f"(backoff {ms['backoff_slept_s'] * 1e3:.2f} ms, "
          f"gaveups={ms['deadline_gaveups']}), "
          f"{ms['degraded_queries']} degraded queries")
    if coverage < 1.0:
        print(f"[serve] DEGRADED: coverage={coverage:.4f}, dead item "
              f"ranges={sorted(dead_ranges)} — heal() or restart replicas")
    else:
        print("[serve] coverage=1.0000 (full catalogue served)")
    print(f"[serve] completion p50={_percentile(lat, 50):.4f}s "
          f"p99={_percentile(lat, 99):.4f}s after start; "
          f"top id for user {int(users[0])}: {top_id}")

    if args.metrics_out:
        write_metrics(args.metrics_out, registry)
        print(f"[serve] metrics -> {args.metrics_out}")
    if args.trace_out:
        write_trace(args.trace_out, tracer)
        print(f"[serve] trace ({len(tracer.spans)} spans) -> "
              f"{args.trace_out}")
    return {
        "params": params, "k": k, "users": users, "results": results,
        "coverage": coverage,
        "seconds": dt, "completion_s": lat,
        "batcher_stats": dict(batcher.stats), "mesh_stats": dict(mesh.stats),
    }


if __name__ == "__main__":
    main()
