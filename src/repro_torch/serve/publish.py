"""Live ψ refresh: double-buffered, versioned publish from training to
serving (port of ``repro.serve.publish``).

``publish`` builds the NEXT snapshot entirely off to the side while
readers still see the old one, then flips it live with ONE reference
assignment of the (snapshot, version) pair — atomic under the interpreter,
so a reader grabbing the active snapshot gets either the complete old one
or the complete new one. The version rides on the snapshot and the request
cache (``serve/batcher.py``) keys on it, so a publish invalidates every
cached result with no flush traffic.

:class:`PsiPublisher` adapts this to the models' ``fit(callback=...)``
hook: at each epoch boundary it publishes ``export_psi(params)`` into the
cluster. **Delta publish**: ``publish_delta(rows, ids)`` (on the cluster,
the mesh and :class:`PsiPublisher`) patches rows and/or appends ids onto
the authoritative table and flips the result live under a normal version
bump; :func:`apply_delta` is the pure patch/append helper.

:class:`StagedRollout` is the operated form of publish for the
fault-tolerant mesh: the table is staged on one canary replica per shard,
health-checked under mirrored traffic (live against canary answers on the
same φ rows), and only then promoted; a bad table (NaNs, wrong geometry)
rolls back with no query served from it.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.metrics import next_instance_id, resolve_registry


def dense_table(shard_set) -> torch.Tensor:
    """The dense (n_items, D) ψ table of a
    :class:`~repro_torch.serve.cluster.PsiShardSet` (the last shard's
    padding rows dropped), on its shards' device — the authoritative base
    a delta patches."""
    stacked = shard_set.stacked()                      # (S, rows_per, D)
    return stacked.reshape(-1, stacked.shape[-1])[: shard_set.n_items]


def apply_delta(psi, rows, ids) -> torch.Tensor:
    """Pure delta: patch/append ψ ``rows`` at global item ``ids``.

    ``ids < n_items`` overwrite existing rows; ``ids >= n_items`` grow the
    catalogue and must cover the appended range ``[n_items, max(ids)]``
    without holes — a hole would silently serve an all-zero embedding for
    a real item id, so it raises instead, as do duplicate and negative ids.
    Returns a NEW dense table on ``psi``'s device (the input is not
    changed)."""
    psi = torch.as_tensor(psi)
    rows = torch.as_tensor(rows).to(psi.device, psi.dtype)
    ids = np.atleast_1d(np.asarray(ids, np.int64))
    if rows.dim() == 1:
        rows = rows[None, :]
    n, d = psi.shape
    if tuple(rows.shape) != (ids.size, d):
        raise ValueError(
            f"delta rows must be ({ids.size}, {d}), got {tuple(rows.shape)}")
    if ids.size == 0:
        return psi.clone()
    if ids.min() < 0:
        raise ValueError(f"negative item id in delta: {ids.min()}")
    if np.unique(ids).size != ids.size:
        raise ValueError("duplicate item ids in one delta")
    n_new = max(int(ids.max()) + 1 - n, 0)
    if n_new:
        appended = set(int(i) for i in ids[ids >= n])
        missing = [i for i in range(n, n + n_new) if i not in appended]
        if missing:
            raise ValueError(
                f"append hole: ids {missing} in [{n}, {n + n_new}) carry no "
                "row — a hole would serve a zero embedding for a real item")
    out = torch.cat([psi, psi.new_zeros((n_new, d))], dim=0)
    out[torch.as_tensor(ids, device=psi.device)] = rows
    return out


class VersionedTable:
    """Double-buffered holder of the active snapshot.

    ``publish(build)`` calls ``build(next_version)`` to construct the new
    snapshot into the back buffer, then flips it live with one atomic
    reference swap. ``active`` raises until the first publish — a serving
    path must never silently answer from an empty catalogue.
    """

    def __init__(self):
        self._buffers = [None, None]  # [back, live] payloads
        self._state = (None, 0)       # (live snapshot, version) — ONE ref

    @property
    def version(self) -> int:
        return self._state[1]

    @property
    def active(self):
        snapshot, version = self._state  # single read: consistent pair
        if snapshot is None:
            raise RuntimeError(
                "no table published yet — call publish() before serving"
            )
        return snapshot

    def publish(self, build: Callable[[int], object]) -> int:
        """Build the next snapshot with ``build(version)``, then flip."""
        _, version = self._state
        nxt = build(version + 1)
        # the back buffer keeps the previous snapshot alive for readers
        # that grabbed it before the flip
        self._buffers = [self._state[0], nxt]
        self._state = (nxt, version + 1)
        return version + 1


class PsiPublisher:
    """``fit(callback=...)`` adapter: publish ψ snapshots at epoch boundaries.

    ::

        cluster = ShardedRetrievalCluster(phi_fn, n_shards=4, k=100)
        pub = PsiPublisher(cluster, mf.export_psi, every=1)
        mf.fit(params, data, hp, n_epochs, callback=pub)
        pub.versions   # [(epoch, version), ...] — the refresh trajectory

    ``export`` maps the training params to the (n_items, D) ψ table;
    ``every`` throttles the refresh cadence.

    Registry metrics (labels ``instance``): ``serve_psi_version`` (gauge:
    last published version), ``serve_psi_last_publish_time`` (gauge:
    registry-clock time of the last publish), ``serve_psi_publishes_total``,
    ``serve_psi_delta_publishes_total`` and ``serve_psi_delta_rows_total``.
    """

    def __init__(self, cluster, export: Callable, *, every: int = 1,
                 log: Optional[Callable[[str], None]] = None, registry=None):
        self.cluster = cluster
        self.export = export
        self.every = int(every)
        self.log = log
        self.versions: list = []  # [(epoch, version), ...]
        self.deltas: list = []    # [(version, n_rows), ...] delta publishes
        reg = resolve_registry(registry)
        self.registry = reg
        inst = {"instance": next_instance_id()}
        lab = ("instance",)
        self._g_version = reg.gauge(
            "serve_psi_version", "last published psi table version",
            labels=lab).labels(**inst)
        self._g_pub_time = reg.gauge(
            "serve_psi_last_publish_time",
            "registry-clock timestamp of the last publish (staleness age "
            "= clock() - value)", labels=lab).labels(**inst)
        self._c_publishes = reg.counter(
            "serve_psi_publishes_total", "full-table publishes",
            labels=lab).labels(**inst)
        self._c_deltas = reg.counter(
            "serve_psi_delta_publishes_total", "delta publishes",
            labels=lab).labels(**inst)
        self._c_delta_rows = reg.counter(
            "serve_psi_delta_rows_total",
            "psi rows patched/appended by delta publishes",
            labels=lab).labels(**inst)

    def _mark(self, version: int) -> None:
        self._g_version.set(version)
        self._g_pub_time.set(self.registry.clock())

    def __call__(self, epoch: int, params) -> None:
        if epoch % self.every:
            return
        version = self.cluster.publish(self.export(params))
        self.versions.append((epoch, version))
        self._c_publishes.inc()
        self._mark(version)
        if self.log is not None:
            self.log(f"epoch {epoch}: published psi table version {version}")

    def publish_delta(self, rows, ids) -> int:
        """Incremental publish between epochs: patch/append ``rows`` at
        item ``ids`` (see :func:`apply_delta`) without a full export.
        Returns the new version and records it in ``deltas``."""
        version = self.cluster.publish_delta(rows, ids)
        n_rows = int(np.atleast_1d(ids).size)
        self.deltas.append((version, n_rows))
        self._c_deltas.inc()
        self._c_delta_rows.inc(n_rows)
        self._mark(version)
        if self.log is not None:
            self.log(f"delta: {n_rows} psi row(s) -> version {version}")
        return version


class StagedRollout:
    """Canary-gated ψ publish for the fault-tolerant mesh: stage → mirror →
    promote (or roll back), never a straight flip.

    ::

        rollout = StagedRollout(mesh, mirror_phi=phi_probe_rows)
        promoted, report = rollout.publish(new_psi_table)

      1. ``mesh.begin_canary(table)`` — the staged table lands on ONE extra
         replica per shard, off the routing path;
      2. ``mesh.mirror_check(mirror_phi)`` — the probe φ rows run against
         the live table and the canary; structural checks (shapes, finite
         scores, ids in range) plus the optional ``validate(live_result,
         canary_result)`` policy;
      3. healthy → ``mesh.promote_canary()`` (one atomic ReplicaSet flip);
         unhealthy → ``mesh.rollback_canary()`` (the staged table is
         dropped, version unchanged, nothing served it).

    ``history`` records every attempt as ``(staged_version, promoted,
    report)``; ``serve_rollout_attempts_total{outcome}`` counts them.
    """

    def __init__(self, mesh, *, mirror_phi: Optional[Sequence] = None,
                 validate: Optional[Callable] = None, k: Optional[int] = None,
                 log: Optional[Callable[[str], None]] = None, registry=None):
        self.mesh = mesh
        self.mirror_phi = mirror_phi
        self.validate = validate
        self.k = k
        self.log = log
        self.history: list = []  # [(staged_version, promoted, report), ...]
        reg = resolve_registry(registry)
        inst = {"instance": next_instance_id()}
        fam = reg.counter(
            "serve_rollout_attempts_total",
            "staged rollout attempts by outcome",
            labels=("instance", "outcome"))
        self._c_outcome = {
            out: fam.labels(**inst, outcome=out)
            for out in ("promoted", "rolled_back")
        }

    def publish(self, psi_table, *, mirror_phi=None) -> tuple:
        """Stage ``psi_table``, mirror-check it, and promote iff healthy.
        Returns ``(promoted: bool, report: dict)``."""
        phi = mirror_phi if mirror_phi is not None else self.mirror_phi
        if phi is None:
            raise ValueError(
                "StagedRollout needs mirror traffic: pass mirror_phi "
                "(probe φ rows) at construction or per publish")
        staged = self.mesh.begin_canary(psi_table)
        report = self.mesh.mirror_check(phi, k=self.k, validate=self.validate)
        promoted = bool(report["healthy"])
        self._c_outcome["promoted" if promoted else "rolled_back"].inc()
        if promoted:
            version = self.mesh.promote_canary()
            report = {**report, "promoted_version": version}
            if self.log is not None:
                self.log(f"staged v{staged} healthy: promoted as v{version}")
        else:
            self.mesh.rollback_canary()
            if self.log is not None:
                self.log(f"staged v{staged} UNHEALTHY: rolled back "
                         f"({report['checks']})")
        self.history.append((staged, promoted, report))
        return promoted, report
