"""Label-aware metrics registry: Counter / Gauge / Histogram families.

The measurement spine every serving layer of the PyTorch port reports
through; a plain-Python copy of ``repro.obs.metrics`` with the same metric
names, so both packages export the same series. Design constraints, in the
order they shaped the module:

  * **Injectable clock** — like ``MicroBatcher`` and the mesh, the
    registry never calls ``time.*`` behind the caller's back: the clock
    is a constructor argument, so the simulated-clock tests drive
    histograms and staleness gauges deterministically.
  * **Label children resolved once** — ``family.labels(**kv)`` returns a
    cached child whose ``inc``/``observe``/``set`` are plain attribute
    ops; hot paths (the batcher admission loop, the mesh retry loop)
    resolve their children at construction and pay ~a float add per
    event.
  * **Per-instance isolation on a process-global default** — components
    default to the process registry (so drivers get metrics for free)
    but label every family with a unique ``instance`` id, so two
    batchers in one process (or two tests in one session) never bleed
    counters into each other. Tests can also inject a private
    :class:`MetricsRegistry`, and :data:`NULL_REGISTRY` is the zero-cost
    bare mode (every op a no-op — the baseline side of the overhead
    gate).
  * **Fixed-bucket histograms** — cumulative-bucket counts with
    p50/p90/p99 estimates by linear interpolation inside the owning
    bucket (the Prometheus estimation rule), so quantiles need no
    sample retention and export is O(buckets).

Exposition (JSONL + Prometheus text) lives in ``obs/export.py``; spans
and request tracing in ``obs/trace.py``.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections.abc import Mapping
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

# default latency buckets (seconds): ~10us .. 10s, roughly 2.5x steps —
# wide enough for slow CPU runs AND sub-ms simulated clocks
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_instance_ids = itertools.count()


def next_instance_id() -> str:
    """Process-unique ``instance`` label value. Components stamp their
    families with it so a global default registry still gives every
    batcher/mesh/publisher object its own counters."""
    return str(next(_instance_ids))


class Counter:
    """Monotonically increasing float value."""

    __slots__ = ("labels_kv", "_value")

    def __init__(self, labels_kv: Tuple[Tuple[str, str], ...]):
        self.labels_kv = labels_kv
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self._value += v

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Settable value (versions, queue depths, timestamps)."""

    __slots__ = ("labels_kv", "_value")

    def __init__(self, labels_kv: Tuple[Tuple[str, str], ...]):
        self.labels_kv = labels_kv
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self._value += v

    def dec(self, v: float = 1.0) -> None:
        self._value -= v

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket cumulative histogram with interpolated quantiles.

    ``buckets`` are the upper bucket EDGES (ascending); one overflow
    bucket past the last edge is implicit. Quantile estimation follows
    the Prometheus rule: find the bucket holding rank ``q·count`` and
    interpolate linearly inside it (the overflow bucket clamps to the
    last finite edge — a known, documented bias; pick edges that cover
    the signal). No samples are retained."""

    __slots__ = ("labels_kv", "edges", "counts", "_sum", "_count")

    def __init__(
        self,
        labels_kv: Tuple[Tuple[str, str], ...],
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        edges = tuple(float(e) for e in buckets)
        if not edges or list(edges) != sorted(edges):
            raise ValueError(f"bucket edges must be ascending, got {edges}")
        self.labels_kv = labels_kv
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)  # +1: overflow bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self._sum += v
        self._count += 1
        for i, edge in enumerate(self.edges):
            if v <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def value(self) -> float:
        """Mean observation — the scalar a stats view reports."""
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); NaN on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self._count == 0:
            return float("nan")
        rank = q * self._count
        cum = 0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            if cum + n >= rank:
                if i >= len(self.edges):       # overflow: clamp to last edge
                    return self.edges[-1]
                lo = 0.0 if i == 0 else self.edges[i - 1]
                hi = self.edges[i]
                return lo + (hi - lo) * max(rank - cum, 0.0) / n
            cum += n
        return self.edges[-1]

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.5), "p90": self.quantile(0.9),
                "p99": self.quantile(0.99)}


class Family:
    """One named metric family; ``labels(**kv)`` returns the cached child
    for that label combination (creating it on first use)."""

    def __init__(self, name: str, kind: str, help_text: str,
                 labelnames: Tuple[str, ...], make: Callable):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.labelnames = labelnames
        self._make = make
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **kv):
        if tuple(sorted(kv)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(kv)}"
            )
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._make(tuple(zip(self.labelnames, key)))
            self._children[key] = child
        return child

    # label-less convenience: proxy the child API on the family itself
    def _default(self):
        return self.labels()

    def inc(self, v: float = 1.0) -> None:
        self._default().inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._default().dec(v)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self) -> float:
        return self._default().value

    def children(self) -> Iterable:
        return self._children.values()


class MetricsRegistry:
    """Process- or test-scoped home for metric families.

    ::

        reg = MetricsRegistry(clock=lambda: clock["t"])   # simulated time
        flushes = reg.counter("serve_batcher_flushes_total",
                              "flushes by reason", labels=("reason",))
        flushes.labels(reason="deadline").inc()
        lat = reg.histogram("queue_latency_seconds", "submit->flush wait")
        lat.observe(0.0013); lat.quantile(0.99)
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    def _family(self, name: str, kind: str, help_text: str,
                labelnames: Tuple[str, ...], make: Callable) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.labelnames}; requested {kind} "
                        f"with {labelnames}"
                    )
                return fam
            fam = Family(name, kind, help_text, labelnames, make)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._family(name, "counter", help_text, tuple(labels), Counter)

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._family(name, "gauge", help_text, tuple(labels), Gauge)

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
        return self._family(
            name, "histogram", help_text, tuple(labels),
            lambda kv: Histogram(kv, buckets),
        )

    def families(self) -> Iterable[Family]:
        return list(self._families.values())

    def get(self, name: str, **kv) -> float:
        """Test/inspection convenience: the scalar value of one child
        (counter/gauge value; histogram mean). Raises on unknown name."""
        return self._families[name].labels(**kv).value

    @contextmanager
    def timer(self, hist):
        """Observe the wall time of a ``with`` block into ``hist`` (a
        histogram child or family), using THIS registry's clock."""
        t0 = self.clock()
        try:
            yield
        finally:
            hist.observe(self.clock() - t0)


# -------------------------------------------------------------- null mode
class _NullMetric:
    """Absorbs the whole child/family API as no-ops — the bare-mode
    singleton behind :data:`NULL_REGISTRY`."""

    def labels(self, **kv):
        return self

    def inc(self, v: float = 1.0) -> None:
        pass

    def dec(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return float("nan")

    def percentiles(self) -> Dict[str, float]:
        nan = float("nan")
        return {"p50": nan, "p90": nan, "p99": nan}

    @property
    def value(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    @property
    def sum(self) -> float:
        return 0.0

    def children(self) -> tuple:
        return ()


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Every family it hands out is the shared no-op metric; instrumented
    code runs unchanged with zero bookkeeping. ``bool(NULL_REGISTRY)`` is
    False so call sites can gate optional work (span/recording setup)."""

    clock = staticmethod(time.monotonic)

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()):
        return _NULL_METRIC

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()):
        return _NULL_METRIC

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (), buckets=DEFAULT_BUCKETS):
        return _NULL_METRIC

    def families(self) -> tuple:
        return ()

    def get(self, name: str, **kv) -> float:
        return 0.0

    @contextmanager
    def timer(self, hist):
        yield

    def __bool__(self) -> bool:
        return False


NULL_REGISTRY = NullRegistry()

# ----------------------------------------------------------- default wiring
_default_registry: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The lazily created process-global registry (what components use
    when no explicit registry is injected)."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry


def set_default_registry(reg: Optional[MetricsRegistry]) -> None:
    """Swap (or with ``None`` reset) the process-global registry."""
    global _default_registry
    with _default_lock:
        _default_registry = reg


def resolve_registry(registry=None):
    """``None`` → the process default; anything else passes through
    (including :data:`NULL_REGISTRY` for bare mode)."""
    return default_registry() if registry is None else registry


class StatsView(Mapping):
    """Live read-only mapping over registry-backed counters.

    The back-compat shim for ``MicroBatcher.stats`` / ``mesh.stats``:
    every read (``stats["flushes"]``, ``dict(stats)``, ``.items()``)
    pulls the CURRENT registry values, so code written against the old
    plain-dict stats keeps working while the registry is the single
    source of truth."""

    def __init__(self, readers: Dict[str, Callable[[], float]]):
        self._readers = dict(readers)

    def __getitem__(self, key: str) -> float:
        return self._readers[key]()

    def __iter__(self):
        return iter(self._readers)

    def __len__(self) -> int:
        return len(self._readers)

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"
