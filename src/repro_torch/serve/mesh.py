"""Fault-tolerant serving mesh: replication, health-checked failover and
graceful degradation over the sharded cluster (port of
``repro.serve.mesh``).

  replication — :class:`ReplicaSet` places each ψ row range on R replica
    slabs (round-robin across ``devices`` so copies of one shard land on
    different devices; on one card every slab is its own copy on that
    card), with per-replica health state and two routing policies,
    ``round_robin`` and ``least_outstanding``. Every replica runs the same
    kernel call (``cluster.shard_topk``) with the same
    ``id_offset``/``n_valid`` meta, so which replica answered is
    unobservable in the results: failover is bit-invisible.

  failure detection — a dispatch that raises (or that the injectable
    :class:`FaultInjector` makes raise); per-replica latencies streamed
    into a :class:`ShardHealthMonitor`; and a replica still on an old
    table version, refused before dispatch.

  failover + re-placement — a failed dispatch fails over to the next live
    replica of the same range; a replica struck out ``fail_threshold``
    times is marked dead, and :meth:`FaultTolerantRetrievalMesh.heal`
    re-places the orphaned range from the authoritative copy.

  bounded, deadline-aware retries — :class:`RetryPolicy` caps dispatches
    per shard and every backoff sleep by the request's remaining
    ``deadline`` budget (wire it to the batcher's ``max_delay``).

  graceful degradation — a row range with NO live replica does not hang
    or raise: the query completes over the surviving shards and the
    :class:`~repro_torch.serve.cluster.TopKResult` reports
    ``coverage < 1.0`` and the dead global-id ranges.

  staged rollout — ``publish.StagedRollout`` drives the canary protocol
    (:meth:`~FaultTolerantRetrievalMesh.begin_canary` →
    :meth:`~FaultTolerantRetrievalMesh.mirror_check` →
    :meth:`~FaultTolerantRetrievalMesh.promote_canary` /
    :meth:`~FaultTolerantRetrievalMesh.rollback_canary`): the next ψ table
    is installed on ONE canary replica per shard, off the routing path,
    health-checked under mirrored traffic, and promoted or dropped.

  IVF tier — ``retrieval='ivf'`` serves each shard through its
    ``serve.ann.PsiIndex`` (built lazily per table version and shared by
    the shard's replicas, which hold the same content); the failover,
    retry and health machinery wraps both paths alike. ``publish_delta``
    folds a delta into the live indexes.

Everything is single-process and clock-injectable, so tests drive
simulated clocks and the :class:`FaultInjector` instead of killing
processes.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.topk_score.ops import topk_merge_shards
from repro_torch.obs.costs import KernelCostRecorder
from repro_torch.obs.metrics import StatsView, next_instance_id, resolve_registry
from repro_torch.runtime.health import StragglerWatchdog
from repro_torch.serve.cluster import (
    PsiShardSet,
    TopKResult,
    colocate_parts,
    coverage_fraction,
    dead_item_ranges,
    empty_topk,
    resolve_cluster_block_items,
    shard_psi,
    shard_topk,
)


# ------------------------------------------------------------------ failures
class ReplicaFailure(RuntimeError):
    """A single replica failed one dispatch (crash, injected error)."""

    def __init__(self, msg: str = "replica failure", latency: float = 0.0):
        super().__init__(msg)
        self.latency = float(latency)


class ReplicaTimeout(ReplicaFailure):
    """A dispatch exceeded its time allowance; ``latency`` is what it
    burned from the request's deadline budget before being abandoned."""


class StaleReplicaError(ReplicaFailure):
    """The replica's installed table version lags the live version — it
    must not answer (a stale ψ would silently serve old scores)."""


class FaultInjector:
    """Injectable failure source — the chaos-testing hook.

    ``fail(shard, replica, mode)`` arms a fault on one replica:

      * ``"error"``   — its next dispatches raise :class:`ReplicaFailure`;
      * ``"timeout"`` — raise :class:`ReplicaTimeout` carrying ``latency``
        seconds of burned deadline budget;
      * ``"stale"``   — raise :class:`StaleReplicaError` (simulates a
        replica stuck on an old table version).

    Faults are sticky until :meth:`heal`; ``count=n`` makes a fault
    transient (auto-disarms after n dispatches — the retry-path test)."""

    def __init__(self):
        self._faults: Dict[Tuple[int, int], dict] = {}
        self.triggered = 0

    def fail(self, shard: int, replica: int, mode: str = "error", *,
             latency: float = 0.0, count: Optional[int] = None) -> None:
        if mode not in ("error", "timeout", "stale"):
            raise ValueError(f"unknown fault mode {mode!r}")
        self._faults[(shard, replica)] = {
            "mode": mode, "latency": float(latency), "count": count,
        }

    def heal(self, shard: Optional[int] = None,
             replica: Optional[int] = None) -> None:
        """Disarm faults: all of them, one shard's, or one replica's."""
        if shard is None:
            self._faults.clear()
            return
        for key in list(self._faults):
            if key[0] == shard and (replica is None or key[1] == replica):
                del self._faults[key]

    def before_dispatch(self, shard: int, replica: int) -> None:
        f = self._faults.get((shard, replica))
        if f is None:
            return
        if f["count"] is not None:
            f["count"] -= 1
            if f["count"] < 0:
                del self._faults[(shard, replica)]
                return
        self.triggered += 1
        if f["mode"] == "timeout":
            raise ReplicaTimeout(
                f"injected timeout on replica ({shard}, {replica})",
                latency=f["latency"],
            )
        if f["mode"] == "stale":
            raise StaleReplicaError(
                f"injected stale table on replica ({shard}, {replica})"
            )
        raise ReplicaFailure(
            f"injected error on replica ({shard}, {replica})",
            latency=f["latency"],
        )


# ------------------------------------------------------------------- policy
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with deadline-aware exponential backoff.

    ``max_attempts`` caps dispatches per shard per request. ``backoff_base``
    seconds doubles per retry (attempt i sleeps ``base · 2^(i-1)``), but a
    sleep is only taken when it FITS the remaining ``deadline`` budget —
    otherwise the shard gives up immediately (degrade beats blowing the
    caller's latency contract). ``deadline=None`` means unbudgeted (retries
    still bounded by ``max_attempts``). Set ``deadline`` to the
    micro-batcher's ``max_delay`` so queue wait + retries share one bound.
    """

    max_attempts: int = 3
    backoff_base: float = 1e-4
    deadline: Optional[float] = None

    def backoff(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (1-based)."""
        return self.backoff_base * (2.0 ** max(0, attempt - 1))


# ------------------------------------------------------------------ replicas
@dataclasses.dataclass
class Replica:
    """One placed copy of one ψ row-range, with live health state."""

    shard: int
    idx: int                      # replica slot within the shard
    slab: torch.Tensor            # (rows_per, D)
    device: Optional[object]
    version: int
    alive: bool = True
    canary: bool = False          # staged next-version copy; not routed
    outstanding: int = 0          # in-flight dispatches (least_outstanding)
    served: int = 0
    failures: int = 0             # consecutive failures (reset on success)
    dead_reason: Optional[str] = None

    @property
    def key(self) -> Tuple[int, int]:
        return (self.shard, self.idx)


class ReplicaSet:
    """R health-tracked replicas of every shard of one table snapshot.

    Placement: replica r of shard s goes on ``devices[(s + r) % D]`` — the
    rotation guarantees (whenever R ≤ D) that copies of the SAME row range
    live on DIFFERENT devices, so one device loss never kills a range.

    Routing (:meth:`pick`): ``round_robin`` cycles the live replicas of a
    shard (throughput); ``least_outstanding`` picks the live replica with
    the fewest in-flight dispatches (tail latency). Dead replicas are
    never picked; a shard with zero live replicas has no route and the
    query layer degrades.
    """

    def __init__(
        self,
        table: PsiShardSet,
        n_replicas: int = 2,
        *,
        devices: Optional[Sequence] = None,
        policy: str = "round_robin",
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if policy not in ("round_robin", "least_outstanding"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.table = table              # authoritative source copy
        self.n_replicas = int(n_replicas)
        self.devices = list(devices) if devices is not None else None
        self.policy = policy
        self._rr = [0] * table.n_shards
        self.replicas: List[List[Replica]] = [
            [self._place(s, r) for r in range(self.n_replicas)]
            for s in range(table.n_shards)
        ]

    # ----------------------------------------------------------- placement
    def _device_for(self, s: int, r: int):
        if not self.devices:
            return None
        return self.devices[(s + r) % len(self.devices)]

    def _place(self, s: int, r: int, device=None) -> Replica:
        dev = device if device is not None else self._device_for(s, r)
        src = self.table.shards[s]
        # every replica is its own copy of the range, also on one device
        slab = src.to(dev if dev is not None else src.device, copy=True)
        return Replica(shard=s, idx=r, slab=slab, device=dev,
                       version=self.table.version)

    # ------------------------------------------------------------- health
    @property
    def n_shards(self) -> int:
        return self.table.n_shards

    @property
    def version(self) -> int:
        return self.table.version

    def live(self, s: int) -> List[Replica]:
        return [r for r in self.replicas[s] if r.alive and not r.canary]

    def dead_shards(self) -> List[int]:
        return [s for s in range(self.n_shards) if not self.live(s)]

    def mark_dead(self, s: int, idx: int, reason: str = "failed") -> None:
        for rep in self.replicas[s]:
            if rep.idx == idx and rep.alive:
                rep.alive = False
                rep.dead_reason = reason

    def mark_live(self, s: int, idx: int) -> None:
        for rep in self.replicas[s]:
            if rep.idx == idx:
                rep.alive = True
                rep.failures = 0
                rep.dead_reason = None

    # ------------------------------------------------------------- routing
    def pick(self, s: int) -> Replica:
        live = self.live(s)
        if not live:
            raise ReplicaFailure(f"shard {s} has no live replica")
        if self.policy == "least_outstanding":
            return min(live, key=lambda r: (r.outstanding, r.idx))
        rep = live[self._rr[s] % len(live)]
        self._rr[s] += 1
        return rep

    # ----------------------------------------------------- re-placement
    def replace(self, s: int, *, device=None) -> Replica:
        """Re-place shard ``s``'s orphaned row range as a fresh replica
        built from the authoritative table copy, on a SURVIVING device
        (placement rebuilt over the device set minus the casualties). The
        new replica takes the lowest free slot index."""
        if device is None and self.devices:
            tainted = {id(r.device) for r in self.replicas[s]
                       if not r.alive and r.device is not None}
            candidates = [d for d in self.devices if id(d) not in tainted]
            if not candidates:       # every device saw a death: any port
                candidates = list(self.devices)
            loads: Dict[int, int] = {}
            for row in self.replicas:
                for rep in row:
                    if rep.alive and rep.device is not None:
                        loads[id(rep.device)] = loads.get(id(rep.device), 0) + 1
            device = min(candidates, key=lambda d: loads.get(id(d), 0))
        used = {r.idx for r in self.replicas[s]}
        idx = next(i for i in itertools.count() if i not in used)
        rep = self._place(s, idx, device=device)
        self.replicas[s].append(rep)
        return rep


# ------------------------------------------------------------------- health
class ShardHealthMonitor:
    """Per-replica query-latency watchdog for the serving mesh.

    Wraps :class:`repro_torch.runtime.health.StragglerWatchdog` with
    ``(shard, replica)`` keys and query wall-times as the reported step
    times: a replica whose median latency exceeds the fleet median by
    ``threshold``× for ``patience`` consecutive checks comes back from
    :meth:`flagged` — the mesh then routes around it exactly like a hard
    failure (health-checked failover). Quiet (dead) replicas drop out of
    the baseline automatically (the watchdog's staleness horizon)."""

    def __init__(self, threshold: float = 3.0, patience: int = 3,
                 window: int = 16):
        self._wd = StragglerWatchdog(
            threshold=threshold, patience=patience, window=window
        )

    def observe(self, key: Tuple[int, int], latency: float) -> None:
        self._wd.report(key, latency)

    def flagged(self) -> List[Tuple[int, int]]:
        return list(self._wd.check())


# --------------------------------------------------------------------- mesh
class FaultTolerantRetrievalMesh:
    """Replicated, health-checked, degradation-aware retrieval service::

        mesh = FaultTolerantRetrievalMesh(
            lambda ctx: mf.build_phi(params, ctx),
            n_shards=2, n_replicas=2, k=100,
            retry=RetryPolicy(max_attempts=3, deadline=batcher.max_delay))
        mesh.publish(mf.export_psi(params))
        res = mesh.topk(user_ids)          # TopKResult
        res.coverage, res.dead_ranges      # the degradation contract

    Query semantics: bit-identical to the unreplicated ``cluster_topk``
    whenever every row range has a live replica — replicas are exact
    copies running the same kernel call, so a replica kill under R ≥ 2 is
    invisible in the results. When a range has NO live replica the query
    completes over the survivors with ``coverage < 1.0`` and the dead
    ranges reported. ``publish`` snapshots are versioned, double-buffered
    ReplicaSets.
    """

    def __init__(
        self,
        phi_fn: Optional[Callable[..., torch.Tensor]] = None,
        *,
        n_shards: int = 2,
        n_replicas: int = 2,
        k: int = 100,
        block_items: Optional[int] = None,
        devices: Optional[Sequence] = None,
        policy: str = "round_robin",
        retry: Optional[RetryPolicy] = None,
        injector: Optional[FaultInjector] = None,
        monitor: Optional[ShardHealthMonitor] = None,
        fail_threshold: int = 1,
        auto_heal: bool = False,
        clock: Callable[[], float] = time.monotonic,
        sleep: Optional[Callable[[float], None]] = None,
        psi_table: Optional[torch.Tensor] = None,
        retrieval: str = "exact",
        ann=None,                                  # serve.ann.AnnConfig
        registry=None,
        tracer=None,
    ):
        from repro_torch.serve.publish import VersionedTable

        if retrieval not in ("exact", "ivf"):
            raise ValueError(f"retrieval must be 'exact' or 'ivf', got {retrieval!r}")
        self.retrieval = retrieval
        self.ann = ann
        self._ivf: Dict[int, tuple] = {}   # table version → per-shard indexes
        self.phi_fn = phi_fn
        self.n_shards = int(n_shards)
        self.n_replicas = int(n_replicas)
        self.k = int(k)
        self.block_items = block_items
        self.devices = devices
        self.policy = policy
        self.retry = retry or RetryPolicy()
        self.injector = injector
        self.monitor = monitor or ShardHealthMonitor()
        self.fail_threshold = int(fail_threshold)
        self.auto_heal = bool(auto_heal)
        self.clock = clock
        self.sleep = sleep if sleep is not None else (lambda dt: None)
        self._set = VersionedTable()
        self._canary: Optional[PsiShardSet] = None
        # counters live on the metrics registry with a per-instance label;
        # ``self.stats`` is the live read-only view. ``tracer`` opts into
        # dispatch/retry/failover/merge spans under the batcher's flush span.
        self.registry = resolve_registry(registry)
        self.tracer = tracer
        reg, inst = self.registry, next_instance_id()
        self._inst = inst
        lab = ("instance",)

        def _c(name, help_text):
            return reg.counter(name, help_text, labels=lab).labels(
                instance=inst)

        counter_specs = {
            "queries": ("serve_mesh_queries_total", "topk_phi requests"),
            "dispatches": ("serve_mesh_dispatches_total",
                           "per-replica dispatch attempts"),
            "failovers": ("serve_mesh_failovers_total",
                          "failovers to another live replica"),
            "retries": ("serve_mesh_retries_total",
                        "same-set retries (after backoff)"),
            "faults": ("serve_mesh_faults_total",
                       "dispatches that raised (real or injected)"),
            "replicas_died": ("serve_mesh_replicas_died_total",
                              "replicas marked dead"),
            "replicas_replaced": ("serve_mesh_replicas_replaced_total",
                                  "replicas re-placed by heal()"),
            "degraded_queries": ("serve_mesh_degraded_queries_total",
                                 "queries answered with coverage < 1"),
            "backoff_slept_s": ("serve_mesh_backoff_slept_seconds_total",
                                "total backoff sleep"),
            "deadline_gaveups": ("serve_mesh_deadline_gaveups_total",
                                 "shards given up on over the deadline "
                                 "budget"),
            "fault_burned_s": ("serve_mesh_fault_burned_seconds_total",
                               "deadline budget burned by failed "
                               "dispatches (real wall time + injected "
                               "fault latency)"),
            "heals": ("serve_mesh_heals_total", "heal() invocations"),
            "canary_staged": ("serve_mesh_canary_staged_total",
                              "canary tables staged"),
            "canary_promoted": ("serve_mesh_canary_promoted_total",
                                "canaries promoted live"),
            "canary_rolled_back": ("serve_mesh_canary_rolled_back_total",
                                   "canaries rolled back"),
        }
        self._m = {key: _c(name, help_text)
                   for key, (name, help_text) in counter_specs.items()}
        _float_keys = ("backoff_slept_s", "fault_burned_s")
        self.stats = StatsView({
            key: (lambda ch=ch: ch.value) if key in _float_keys
            else (lambda ch=ch: int(ch.value))
            for key, ch in self._m.items()
        })
        self._m_version = reg.gauge(
            "serve_mesh_version", "live table version", labels=lab,
        ).labels(instance=inst)
        self._m_coverage = reg.gauge(
            "serve_mesh_coverage", "coverage of the last query", labels=lab,
        ).labels(instance=inst)
        self._lat_fam = reg.histogram(
            "serve_mesh_replica_latency_seconds",
            "per-(shard,replica) dispatch wall time (the health monitor's "
            "own observations)", labels=("instance", "shard", "replica"))
        self._lat_children: Dict[Tuple[int, int], object] = {}
        self._costs = KernelCostRecorder(reg)
        if psi_table is not None:
            self.publish(psi_table)

    # ------------------------------------------------------------- publish
    def publish(self, psi_table) -> int:
        """Shard, replicate, version, and atomically flip a ψ snapshot
        live (the unstaged path — see :meth:`begin_canary` for the staged
        rollout). Returns the new version."""
        version = self._set.publish(
            lambda version: ReplicaSet(
                shard_psi(psi_table, self.n_shards, version=version),
                self.n_replicas, devices=self.devices, policy=self.policy,
            )
        )
        self._m_version.set(version)
        return version

    def publish_delta(self, rows, ids) -> int:
        """Incremental publish: patch/append ψ ``rows`` at global item
        ``ids`` onto the authoritative table copy and flip the rebuilt
        ReplicaSet live under a normal version bump. Every replica is
        rebuilt at the new version, so the stale-refusal guard keeps
        holding; a staged canary must be resolved first (its row geometry
        may no longer match after an append). Under ``retrieval='ivf'``
        the delta folds into the live indexes unless the shard geometry
        changed. Returns the new version."""
        from repro_torch.serve.publish import apply_delta, dense_table

        if self._canary is not None:
            raise RuntimeError(
                "cannot delta-publish with a canary staged — promote or "
                "roll it back first")
        old_table = self.table
        old_indexes = self._ivf.get(old_table.version)
        version = self.publish(apply_delta(dense_table(old_table), rows, ids))
        if self.retrieval == "ivf" and old_indexes is not None:
            from repro_torch.serve.ann import fold_delta_indexes

            new_table = self.table
            if (new_table.rows_per == old_table.rows_per
                    and new_table.n_shards == old_table.n_shards):
                self._ivf = {version: fold_delta_indexes(
                    old_indexes, new_table, rows, ids, self._ann_cfg(),
                    registry=self.registry)}
        return version

    def _ann_cfg(self):
        from repro_torch.serve.ann import AnnConfig

        return self.ann or AnnConfig()

    def _ivf_indexes(self, table: PsiShardSet) -> tuple:
        """Per-shard IVF indexes for one snapshot, built lazily and keyed
        on the publish version. Shared by every replica of a shard: the
        index is a function of the shard's content, which replicas mirror
        exactly, so failover never changes the index either."""
        cached = self._ivf.get(table.version)
        if cached is None:
            from repro_torch.serve.ann import build_shard_indexes

            cached = build_shard_indexes(table, self._ann_cfg())
            self._ivf = {table.version: cached}
        return cached

    @property
    def replica_set(self) -> ReplicaSet:
        return self._set.active

    @property
    def table(self) -> PsiShardSet:
        return self.replica_set.table

    @property
    def version(self) -> int:
        return self._set.version

    @property
    def n_items(self) -> int:
        return self.table.n_items

    # -------------------------------------------------------------- health
    def apply_health_check(self) -> List[Tuple[int, int]]:
        """Route around latency stragglers: every replica the monitor
        flags is marked dead (reason ``"slow"``). Returns the casualties."""
        reaped = []
        rs = self._set.active
        for (s, idx) in self.monitor.flagged():
            live = {r.idx for r in rs.live(s)}
            if idx in live:
                rs.mark_dead(s, idx, reason="slow")
                self._m["replicas_died"].inc()
                reaped.append((s, idx))
        if reaped and self.auto_heal:
            self.heal()
        return reaped

    def heal(self) -> List[Tuple[int, int]]:
        """Re-place orphaned capacity: every shard below its replication
        target gets fresh replicas rebuilt from the authoritative table
        copy on surviving devices. Returns the new (shard, idx) pairs."""
        rs = self._set.active
        self._m["heals"].inc()
        placed = []
        for s in range(rs.n_shards):
            while len(rs.live(s)) < self.n_replicas:
                rep = rs.replace(s)
                self._m["replicas_replaced"].inc()
                placed.append(rep.key)
        return placed

    def _replica_latency(self, s: int, idx: int):
        ch = self._lat_children.get((s, idx))
        if ch is None:
            ch = self._lat_fam.labels(
                instance=self._inst, shard=str(s), replica=str(idx))
            self._lat_children[(s, idx)] = ch
        return ch

    # --------------------------------------------------------------- query
    def phi(self, *query) -> torch.Tensor:
        return torch.as_tensor(self.phi_fn(*query), dtype=torch.float32)

    def topk(self, *query, k: Optional[int] = None, exclude_mask=None,
             exclude_ids=None, budget: Optional[float] = None) -> TopKResult:
        return self.topk_phi(
            self.phi(*query), k=k, exclude_mask=exclude_mask,
            exclude_ids=exclude_ids, budget=budget,
        )

    def topk_phi(
        self,
        phi_rows,
        *,
        k: Optional[int] = None,
        exclude_mask=None,
        exclude_ids=None,
        budget: Optional[float] = None,
    ) -> TopKResult:
        """(B, k) :class:`TopKResult` with the degradation contract.

        ``budget`` (seconds) overrides ``retry.deadline`` as this request's
        retry allowance. The whole request is served from ONE ReplicaSet
        snapshot (version-consistent). φ and the exclusion move to the
        table's device once, here."""
        rs = self._set.active  # one snapshot end-to-end
        table = rs.table
        k = k or self.k
        dev = table.shards[0].device
        phi_rows = torch.as_tensor(phi_rows, dtype=torch.float32).to(dev)
        if exclude_ids is not None:
            exclude_ids = torch.as_tensor(exclude_ids, dtype=torch.int32).to(dev)
        b = int(phi_rows.shape[0])
        indexes = None
        block_items = self.block_items
        if self.retrieval == "ivf":
            if exclude_mask is not None:
                raise ValueError(
                    "retrieval='ivf' takes exclude_ids (global id lists), "
                    "not a dense exclude_mask")
            # IVF blocks size their own chunks; the replica failover,
            # retry and health machinery below is retrieval-agnostic
            indexes = self._ivf_indexes(table)
        elif block_items is None:
            block_items = resolve_cluster_block_items(table, k)
        self._m["queries"].inc()
        budget = self.retry.deadline if budget is None else budget
        parts_s, parts_i, dead = [], [], []
        for s in range(table.n_shards):
            out = self._query_shard(
                rs, s, phi_rows, k, exclude_mask, exclude_ids,
                block_items, budget, indexes=indexes,
            )
            if out is None:
                dead.append(s)
            else:
                parts_s.append(out[0])
                parts_i.append(out[1])
        if dead:
            self._m["degraded_queries"].inc()
        coverage = coverage_fraction(table, dead)
        ranges = dead_item_ranges(table, dead)
        self._m_coverage.set(coverage)
        if not parts_s:
            es, ei = empty_topk(b, k, device=dev)
            return TopKResult(es, ei, coverage, ranges)
        if len(parts_s) == 1:
            return TopKResult(parts_s[0], parts_i[0], coverage, ranges)
        merge_span = None
        if self.tracer is not None:
            merge_span = self.tracer.begin(
                "merge", shards=len(parts_s), k=k)
        ms, mi = topk_merge_shards(
            torch.stack(colocate_parts(parts_s)),
            torch.stack(colocate_parts(parts_i)), k,
        )
        if merge_span is not None:
            self.tracer.end(merge_span)
        return TopKResult(ms, mi, coverage, ranges)

    # ----------------------------------------------------------- internals
    def _query_shard(self, rs, s, phi_rows, k, exclude_mask, exclude_ids,
                     block_items, budget, indexes=None):
        """One shard's dispatch with failover + bounded deadline-aware
        retries. Returns (scores, ids) or None (shard unavailable for this
        request — the degradation path). ``indexes`` (IVF) swaps the exact
        slab call for the shard's index, shared by its replicas."""
        spent = 0.0       # latency burned: real + injected + backoff
        attempt = 0
        tr = self.tracer
        while attempt < self.retry.max_attempts:
            live = rs.live(s)
            if not live:
                return None
            attempt += 1
            rep = rs.pick(s)
            rep.outstanding += 1
            sp = None
            if tr is not None:
                sp = tr.begin("dispatch", shard=s, replica=rep.idx,
                              attempt=attempt)
            # On CUDA the kernel launch is asynchronous, so this latency is
            # launch-side (enqueue) time, as it was under JAX's async
            # dispatch in the reference: the device work is waited for
            # where the batcher copies the merged result to the host.
            t0 = self.clock()
            try:
                if self.injector is not None:
                    self.injector.before_dispatch(s, rep.idx)
                if rep.version != rs.version:
                    raise StaleReplicaError(
                        f"replica ({s}, {rep.idx}) serves table v"
                        f"{rep.version}, live is v{rs.version}"
                    )
                if indexes is not None:
                    if indexes[s] is None:   # shard owns no valid rows
                        ss, ii = empty_topk(int(phi_rows.shape[0]), k,
                                            device=phi_rows.device)
                    else:
                        ss, ii = indexes[s].topk(
                            phi_rows, k, exclude_ids=exclude_ids,
                            registry=self.registry)
                else:
                    self._costs.record_topk(
                        int(phi_rows.shape[0]), rs.table.rows_per,
                        int(rep.slab.shape[1]), k,
                        excl_l=0 if exclude_ids is None
                        else int(exclude_ids.shape[1]),
                        mask=exclude_mask is not None,
                    )
                    ss, ii = shard_topk(
                        rs.table, s, phi_rows, k, slab=rep.slab,
                        exclude_mask=exclude_mask, exclude_ids=exclude_ids,
                        block_items=block_items,
                    )
                lat = self.clock() - t0
                self.monitor.observe(rep.key, lat)
                self._replica_latency(s, rep.idx).observe(lat)
                rep.served += 1
                rep.failures = 0
                self._m["dispatches"].inc()
                if sp is not None:
                    tr.end(sp, outcome="ok")
                return ss, ii
            except ReplicaFailure as e:
                lat = max(self.clock() - t0, e.latency)
                spent += lat
                self._m["dispatches"].inc()
                self._m["faults"].inc()
                # burned deadline budget: real wall time or the injected
                # fault's declared latency, whichever the loop charged
                self._m["fault_burned_s"].inc(lat)
                if sp is not None:
                    tr.end(sp, outcome=type(e).__name__, burned_s=lat)
                rep.failures += 1
                if isinstance(e, ReplicaTimeout):
                    self.monitor.observe(rep.key, lat)
                    self._replica_latency(s, rep.idx).observe(lat)
                if rep.failures >= self.fail_threshold:
                    rs.mark_dead(s, rep.idx, reason=type(e).__name__)
                    self._m["replicas_died"].inc()
                    if self.auto_heal:
                        self.heal()
            finally:
                rep.outstanding -= 1
            # burned latency already exhausted the budget: even a free
            # failover dispatch would answer late
            if budget is not None and spent >= budget:
                self._m["deadline_gaveups"].inc()
                return None
            # failover beats backoff: another live replica is already warm
            if any(r.idx != rep.idx for r in rs.live(s)):
                self._m["failovers"].inc()
                if tr is not None:
                    tr.end(tr.begin("failover", shard=s,
                                    from_replica=rep.idx))
                continue
            # same (possibly healed) set again: exponential backoff, but
            # only if the sleep FITS the remaining deadline budget
            if attempt >= self.retry.max_attempts:
                break
            back = self.retry.backoff(attempt)
            if budget is not None:
                remaining = budget - spent
                if remaining <= 0.0 or back >= remaining:
                    self._m["deadline_gaveups"].inc()
                    return None
            self._m["retries"].inc()
            self._m["backoff_slept_s"].inc(back)
            if tr is not None:
                tr.end(tr.begin("retry", shard=s, backoff_s=back))
            spent += back
            self.sleep(back)
        return None

    # ----------------------------------------------------- staged rollout
    def begin_canary(self, psi_table) -> int:
        """Stage the next ψ table on ONE canary replica per shard (off the
        routing path). Readers keep hitting the live version; nothing
        observable changes until :meth:`promote_canary`. Returns the
        staged version number."""
        if self._canary is not None:
            raise RuntimeError(
                "a canary is already staged — promote or roll it back first")
        rs = self._set.active
        staged = shard_psi(psi_table, self.n_shards, version=self.version + 1)
        self._canary = staged
        for s in range(staged.n_shards):
            dev = rs._device_for(s, self.n_replicas)
            src = staged.shards[s]
            slab = src if dev is None else src.to(dev)
            rs.replicas[s].append(Replica(
                shard=s, idx=max(r.idx for r in rs.replicas[s]) + 1,
                slab=slab, device=dev, version=staged.version, canary=True))
        self._m["canary_staged"].inc()
        return staged.version

    def canary_topk_phi(self, phi_rows, *, k=None,
                        exclude_ids=None) -> TopKResult:
        """Query the CANARY replicas only (mirrored traffic, never routed
        to users), so the rollout can check the staged table under real
        query shapes before anyone sees it."""
        if self._canary is None:
            raise RuntimeError("no canary staged")
        staged = self._canary
        k = k or self.k
        dev = staged.shards[0].device
        phi_rows = torch.as_tensor(phi_rows, dtype=torch.float32).to(dev)
        if exclude_ids is not None:
            exclude_ids = torch.as_tensor(exclude_ids, dtype=torch.int32).to(dev)
        block_items = self.block_items
        if block_items is None:
            block_items = resolve_cluster_block_items(staged, k)
        parts_s, parts_i = [], []
        rs = self._set.active
        for s in range(staged.n_shards):
            canaries = [r for r in rs.replicas[s] if r.canary]
            slab = canaries[0].slab if canaries else staged.shards[s]
            ss, ii = shard_topk(staged, s, phi_rows, k, slab=slab,
                                exclude_ids=exclude_ids,
                                block_items=block_items)
            parts_s.append(ss)
            parts_i.append(ii)
        if len(parts_s) == 1:
            return TopKResult(parts_s[0], parts_i[0])
        ms, mi = topk_merge_shards(
            torch.stack(colocate_parts(parts_s)),
            torch.stack(colocate_parts(parts_i)), k)
        return TopKResult(ms, mi)

    def mirror_check(self, phi_rows, *, k: Optional[int] = None,
                     validate: Optional[Callable[[TopKResult, TopKResult],
                                                 bool]] = None) -> dict:
        """Health-check the canary under mirrored traffic: run ``phi_rows``
        against BOTH the live table and the canary replicas and judge the
        canary's answers. Built-in checks: well-formed shapes, no NaN or
        ±inf score on an admissible slot, ids in catalogue range, not all
        empty. ``validate(live_result, canary_result)`` adds a caller
        policy. ``report["healthy"]`` is the promote/rollback verdict."""
        if self._canary is None:
            raise RuntimeError("no canary staged")
        k = k or self.k
        live_res = self.topk_phi(phi_rows, k=k)
        t0 = self.clock()
        canary_res = self.canary_topk_phi(phi_rows, k=k)
        latency = self.clock() - t0
        ids = canary_res.ids.cpu().numpy()
        scores = canary_res.scores.cpu().numpy()
        n_items = self._canary.n_items
        admissible = ids >= 0
        checks = {
            "shape_ok": ids.shape == tuple(live_res.ids.shape),
            "ids_in_range": bool(((ids >= -1) & (ids < n_items)).all()),
            "scores_finite": bool(
                np.isfinite(scores[admissible]).all()
                if admissible.any() else True),
            "not_all_empty": bool(admissible.any()),
        }
        if validate is not None:
            checks["validate_ok"] = bool(validate(live_res, canary_res))
        return {
            "healthy": all(checks.values()),
            "checks": checks,
            "staged_version": self._canary.version,
            "live_version": self.version,
            "mirror_rows": int(phi_rows.shape[0]),
            "canary_latency_s": latency,
        }

    def promote_canary(self) -> int:
        """Flip the staged table live everywhere: the staged slabs seed a
        fresh ReplicaSet — one atomic swap; in-flight queries finish on
        the old snapshot."""
        if self._canary is None:
            raise RuntimeError("no canary staged")
        staged = self._canary

        def build(version: int) -> ReplicaSet:
            table = PsiShardSet(shards=staged.shards, n_items=staged.n_items,
                                rows_per=staged.rows_per, version=version)
            return ReplicaSet(table, self.n_replicas, devices=self.devices,
                              policy=self.policy)

        version = self._set.publish(build)
        self._canary = None
        self._m["canary_promoted"].inc()
        self._m_version.set(version)
        return version

    def rollback_canary(self) -> None:
        """Drop the staged table: remove the canary replicas and keep
        serving the live version untouched."""
        if self._canary is None:
            raise RuntimeError("no canary staged")
        rs = self._set.active
        for s in range(rs.n_shards):
            rs.replicas[s] = [r for r in rs.replicas[s] if not r.canary]
        self._canary = None
        self._m["canary_rolled_back"].inc()
