"""Request micro-batching for the online retrieval p99 path.

Port of ``repro.serve.batcher``. The fused ``topk_score`` kernel is
efficient at kernel-shaped batches and terrible at B=1: a single-row query
pays the whole ψ-table stream by itself. Online traffic, however, ARRIVES
one row at a time. The :class:`MicroBatcher` closes that gap with the
standard serving trick — an admission queue that coalesces single-row
queries into one padded batch per kernel dispatch:

  flush policy (deadline/size):
    * SIZE — the queue reaching ``max_batch`` rows flushes immediately
      (admission of the triggering request included);
    * DEADLINE — otherwise a flush happens once ``now`` passes
      ``oldest.t_submit + max_delay``: no request waits longer than
      ``max_delay`` in the queue, bounding the batching-induced latency
      (the p99 knob);
    * callers drive time explicitly via :meth:`step` (or implicitly on
      every :meth:`submit`) — the batcher never sleeps or spawns threads,
      so tests run it under a SIMULATED clock.

  batch shaping: flushed rows are stacked and padded up to a multiple of
  ``pad_to`` φ rows (zero rows; results discarded), and the per-request
  exclude-id lists are right-padded with −1 to the widest list in the batch
  — exactly the (B, L) global-id form the kernel's exclude variant takes,
  so no (B, n_items) mask is built per request.

  routing: every request gets a ticket id at admission; after the flush the
  (k,) score/id rows are routed back to their tickets, so out-of-order
  submission, mixed flushes, and pad rows can never cross results between
  requests (parity-pinned in tests under a simulated clock).

  caching: an LRU φ→result cache keyed on ``(key, table_version,
  exclude_list)``. The version comes from the serving table
  (``cluster.version`` — bumped by every ``publish``), so a live ψ refresh
  implicitly invalidates the whole cache without any flush traffic; on the
  first admission AFTER a version bump every entry keyed on a superseded
  version is EVICTED outright (dead weight would otherwise squat in the
  LRU until capacity pressure aged it out, evicting live entries first).
  The exclude list is folded in by the batcher itself, so a caller key
  only has to identify the φ row. Only requests that carry an explicit
  hashable ``key`` participate (an unkeyed φ row has no cheap identity),
  and only full-coverage results are cached — a degraded answer
  (``coverage < 1``, see below) must not outlive the failure that caused
  it.

  degraded results: when the backing executor is the fault-tolerant mesh
  (``serve/mesh.py``), a flush's results may carry ``coverage < 1.0`` and
  dead item ranges. The batcher forwards that contract per ticket: each
  routed result is a single-row :class:`~repro_torch.serve.cluster.TopKResult`
  (still unpackable as ``(scores, ids)``) tagged with the flush's
  coverage/dead ranges — a caller can always tell a full answer from a
  partial one.

  shutdown: :meth:`drain` flushes everything queued and closes the
  batcher — queued requests are never stranded; admissions after close
  raise. The serving driver calls it on the way out (and on SIGTERM in a
  real deployment).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import StatsView, next_instance_id, resolve_registry
from repro_torch.serve.cluster import TopKResult

_FLUSH_REASONS = ("size", "deadline", "forced", "drained")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class _Pending:
    ticket: int
    phi_row: np.ndarray            # (D,)
    exclude: Optional[np.ndarray]  # (L,) global ids or None
    key: Optional[object]
    t_submit: float


class MicroBatcher:
    """Coalesce single-row top-K queries into kernel-shaped batches.

    ``topk_phi(phi_rows (B, D), exclude_ids (B, L) | None) -> (scores, ids)``
    is the backing batch executor — typically
    ``mesh.topk_phi`` with exclusion passed through. It receives CPU
    tensors; the executor moves them to its device, and the results come
    back to host numpy here.

    ::

        batcher = MicroBatcher(
            lambda phi, eids: mesh.topk_phi(phi, exclude_ids=eids),
            max_batch=32, max_delay=2e-3, version_fn=lambda: mesh.version)
        t1 = batcher.submit(phi_row, exclude=[3, 7], key=("user", 17))
        ...
        batcher.step()            # deadline check; flush if due
        scores, ids = batcher.result(t1)   # None until flushed

    The batcher is deliberately single-threaded and clock-injected: the
    serving loop owns the cadence (call ``step`` between admissions), and
    the unit tests replay traces under a simulated clock.
    """

    def __init__(
        self,
        topk_phi: Callable,
        *,
        max_batch: int = 64,
        max_delay: float = 2e-3,
        pad_to: int = 8,
        clock: Callable[[], float] = time.monotonic,
        cache_size: int = 4096,
        version_fn: Optional[Callable[[], int]] = None,
        registry=None,
        tracer=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.topk_phi = topk_phi
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay)
        self.pad_to = int(pad_to)
        self.clock = clock
        self.version_fn = version_fn or (lambda: 0)
        self._queue: List[_Pending] = []
        self._results: Dict[int, TopKResult] = {}
        self._completed_at: Dict[int, float] = {}
        self._next_ticket = 0
        self._cache: OrderedDict = OrderedDict()
        self._cache_size = int(cache_size)
        self._cache_version = self.version_fn()
        self._closed = False
        # counters live on the metrics registry (obs/metrics.py);
        # ``self.stats`` stays a live read-only view over them so every
        # pre-registry caller (tests, benches, drivers) keeps working.
        # ``registry=None`` → the process default (per-instance labels
        # keep two batchers' counters apart); NULL_REGISTRY → bare mode.
        # ``tracer`` (obs/trace.py) opts into per-request spans.
        self.registry = resolve_registry(registry)
        self.tracer = tracer
        self._spans: Dict[int, tuple] = {}   # ticket -> (request, queue) spans
        reg, inst = self.registry, next_instance_id()
        lab = ("instance",)

        def _c(name, help_text):
            return reg.counter(name, help_text, labels=lab).labels(
                instance=inst)

        self._m_submitted = _c(
            "serve_batcher_submitted_total", "requests admitted")
        self._m_flushed_rows = _c(
            "serve_batcher_flushed_rows_total", "real (non-pad) rows flushed")
        self._m_cache_hits = _c(
            "serve_batcher_cache_hits_total", "keyed-result cache hits")
        self._m_cache_misses = _c(
            "serve_batcher_cache_misses_total", "keyed-result cache misses")
        self._m_cache_evicted = _c(
            "serve_batcher_cache_evicted_stale_total",
            "cache entries evicted on a table-version bump")
        self._m_degraded = _c(
            "serve_batcher_degraded_results_total",
            "routed results with coverage < 1")
        flush_fam = reg.counter(
            "serve_batcher_flushes_total", "flushes by trigger reason",
            labels=("instance", "reason"))
        self._m_flush = {r: flush_fam.labels(instance=inst, reason=r)
                         for r in _FLUSH_REASONS}
        self._m_queue_depth = reg.gauge(
            "serve_batcher_queue_depth", "requests waiting in the admission "
            "queue", labels=lab).labels(instance=inst)
        self._m_queue_lat = reg.histogram(
            "serve_batcher_queue_latency_seconds",
            "per-ticket submit->flush wait", labels=lab).labels(instance=inst)
        self.stats = StatsView({
            "submitted": lambda: int(self._m_submitted.value),
            "flushes": lambda: int(sum(
                ch.value for ch in self._m_flush.values())),
            "flushed_rows": lambda: int(self._m_flushed_rows.value),
            "flush_by_size": lambda: int(self._m_flush["size"].value),
            "flush_by_deadline":
                lambda: int(self._m_flush["deadline"].value),
            "flush_forced": lambda: int(self._m_flush["forced"].value),
            "drained": lambda: int(self._m_flush["drained"].value),
            "cache_hits": lambda: int(self._m_cache_hits.value),
            "cache_misses": lambda: int(self._m_cache_misses.value),
            "cache_evicted_stale":
                lambda: int(self._m_cache_evicted.value),
            "degraded_results": lambda: int(self._m_degraded.value),
        })

    # ----------------------------------------------------------- admission
    def submit(
        self,
        phi_row,
        *,
        exclude=None,
        key: Optional[object] = None,
        now: Optional[float] = None,
    ) -> int:
        """Admit one single-row query; returns its ticket id.

        ``exclude`` is this request's global excluded-id list (seen items).
        ``key`` opts into the result cache and only has to identify the φ
        row (e.g. the user id): the exclude list and the table version are
        folded into the cache key here, so a request with a different
        exclusion set or against a newer ψ table can never be served a
        stale cached result."""
        if self._closed:
            raise RuntimeError(
                "batcher is closed (drained); no new admissions"
            )
        now = self.clock() if now is None else now
        self._evict_superseded()
        ticket = self._next_ticket
        self._next_ticket += 1
        self._m_submitted.inc()
        rq = None
        if self.tracer is not None:
            rq = self.tracer.begin("request", parent=None, ticket=ticket)
        excl = None
        if exclude is not None:
            excl = np.asarray(exclude, np.int32).reshape(-1)
        if key is not None:
            hit = self._cache_get(self._cache_key(key, excl))
            if hit is not None:
                self._m_cache_hits.inc()
                self._results[ticket] = hit
                self._completed_at[ticket] = now
                if rq is not None:
                    self.tracer.end(rq, cache="hit")
                self.step(now)  # a hit must still retire queue deadlines
                return ticket
            self._m_cache_misses.inc()
        if rq is not None:
            qs = self.tracer.begin("queue", parent=rq, ticket=ticket)
            self._spans[ticket] = (rq, qs)
        self._queue.append(_Pending(
            ticket=ticket,
            phi_row=np.asarray(phi_row, np.float32).reshape(-1),
            exclude=excl, key=key, t_submit=now,
        ))
        self._m_queue_depth.set(len(self._queue))
        if len(self._queue) >= self.max_batch:
            self._flush(now, "size")
        else:
            self.step(now)  # admission also retires an overdue deadline
        return ticket

    # ---------------------------------------------------------------- time
    def step(self, now: Optional[float] = None) -> bool:
        """Flush iff the oldest queued request's deadline has passed.
        Returns whether a flush happened."""
        if not self._queue:
            return False
        now = self.clock() if now is None else now
        if now - self._queue[0].t_submit >= self.max_delay:
            self._flush(now, "deadline")
            return True
        return False

    def flush(self, now: Optional[float] = None) -> None:
        """Force-flush everything queued."""
        now = self.clock() if now is None else now
        while self._queue:
            self._flush(now, "forced")

    # ------------------------------------------------------------- shutdown
    def drain(self, now: Optional[float] = None) -> Dict[int, TopKResult]:
        """Graceful shutdown: flush every queued request so none is
        stranded, CLOSE the batcher (subsequent ``submit`` raises), and
        return all still-unclaimed results keyed by ticket so the caller
        can deliver them before exiting. Idempotent. Flushes performed
        here count under the ``drained`` reason (``stats["drained"]``) so
        a shutdown flush is distinguishable from a deadline one."""
        now = self.clock() if now is None else now
        while self._queue:
            self._flush(now, "drained")
        self._closed = True
        out = dict(self._results)
        self._results.clear()
        self._completed_at.clear()
        return out

    @property
    def closed(self) -> bool:
        return self._closed

    # -------------------------------------------------------------- results
    def result(
        self, ticket: int, *, pop: bool = True
    ) -> Optional[TopKResult]:
        """Single-row :class:`~repro_torch.serve.cluster.TopKResult` for a ticket
        (unpacks as ``scores (k,), ids (k,)``; carries the flush's
        ``coverage``/``dead_ranges``), or None while queued."""
        if ticket not in self._results:
            return None
        out = self._results.pop(ticket) if pop else self._results[ticket]
        if pop:
            self._completed_at.pop(ticket, None)
        return out

    def completed_at(self, ticket: int) -> Optional[float]:
        """Completion timestamp of a finished ticket (latency accounting)."""
        return self._completed_at.get(ticket)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------ internals
    def _flush(self, now: float, reason: str) -> None:
        batch, self._queue = self._queue[: self.max_batch], self._queue[self.max_batch:]
        self._m_queue_depth.set(len(self._queue))
        b = len(batch)
        b_pad = -(-b // self.pad_to) * self.pad_to
        phi = np.zeros((b_pad, batch[0].phi_row.shape[0]), np.float32)
        for r, req in enumerate(batch):
            phi[r] = req.phi_row
        excl_ids = None
        l_max = max((req.exclude.shape[0] for req in batch
                     if req.exclude is not None), default=0)
        if l_max > 0:
            excl_ids = np.full((b_pad, l_max), -1, np.int32)
            for r, req in enumerate(batch):
                if req.exclude is not None:
                    excl_ids[r, : req.exclude.shape[0]] = req.exclude
            excl_ids = torch.from_numpy(excl_ids)
        fs = None
        if self.tracer is not None:
            # explicit begin/end (not a context manager): _flush is
            # non-reentrant via the trailing step() and the span must
            # close before that follow-up flush opens its own
            fs = self.tracer.begin("flush", parent=None, reason=reason,
                                   batch=b, batch_padded=b_pad)
            with self.tracer.activate(fs):   # mesh spans nest under it
                res = self.topk_phi(torch.from_numpy(phi), excl_ids)
        else:
            res = self.topk_phi(torch.from_numpy(phi), excl_ids)
        scores, ids = res  # TopKResult or a bare (scores, ids) tuple
        coverage = float(getattr(res, "coverage", 1.0))
        dead_ranges = tuple(getattr(res, "dead_ranges", ()))
        # the copy to the host waits for the device work of this flush
        scores = _to_numpy(scores)
        ids = _to_numpy(ids)
        if coverage < 1.0:
            self._m_degraded.inc(len(batch))
        for r, req in enumerate(batch):  # route rows back to their tickets
            out = TopKResult(scores[r], ids[r], coverage, dead_ranges)
            self._results[req.ticket] = out
            self._completed_at[req.ticket] = now
            self._m_queue_lat.observe(now - req.t_submit)
            spans = self._spans.pop(req.ticket, None)
            if spans is not None:
                rq, qs = spans
                self.tracer.end(qs)
                self.tracer.end(rq, flush_span=fs.span_id,
                                coverage=coverage)
            # degraded answers are never cached: the hole they carry must
            # not outlive the replica failure that caused it
            if req.key is not None and coverage == 1.0:
                self._cache_put(self._cache_key(req.key, req.exclude), out)
        if fs is not None:
            self.tracer.end(fs, coverage=coverage)
        self._m_flushed_rows.inc(b)
        self._m_flush[reason].inc()
        if self._queue:  # drain backlog left by a size-capped flush
            self.step(now)

    def _cache_key(self, key, excl: Optional[np.ndarray]):
        """(caller key, table version, exclude list) — version comes from
        the live table so a publish implicitly invalidates every entry."""
        excl_key = () if excl is None else tuple(excl.tolist())
        return (key, self.version_fn(), excl_key)

    def _evict_superseded(self) -> None:
        """Drop cache entries keyed on a superseded table version the
        moment a publish is observed — they can never hit again (the key
        embeds the version), so letting them age out of the LRU would only
        crowd out live entries."""
        version = self.version_fn()
        if version == self._cache_version:
            return
        self._cache_version = version
        stale = [k for k in self._cache if k[1] != version]
        for k in stale:
            del self._cache[k]
        self._m_cache_evicted.inc(len(stale))

    def _cache_get(self, key):
        if key not in self._cache:
            return None
        self._cache.move_to_end(key)
        return self._cache[key]

    def _cache_put(self, key, value) -> None:
        self._cache[key] = value
        self._cache.move_to_end(key)
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
