"""Lightweight request tracing: spans with parent/child links, correlated
to batcher tickets.

One request's life through the serving stack —

  submit → queue (admission wait) → flush(reason) → mesh dispatch →
  per-replica attempt/retry/failover → shard kernel call → cross-shard
  merge → result (or degraded)

— is a single trace. Two API shapes coexist because the batcher's flush
path is non-reentrant (a size-capped flush can trigger a follow-up
deadline flush from inside ``_flush``; a context manager per request
would entangle their lifetimes):

  * ``with tracer.span("merge", shard=s):`` — scoped work; the span
    auto-parents to the innermost active span and pushes itself while
    the block runs, so nested instrumented calls (mesh inside a flush)
    link up without any plumbing.
  * ``sp = tracer.begin("queue", ticket=t)`` / ``tracer.end(sp)`` —
    explicit lifetimes for spans that outlive a call frame (a request
    span lives from submit to routing; flush spans route many tickets).
    ``tracer.activate(sp)`` temporarily makes an explicitly begun span
    the parent for nested ``span()`` calls.

Ticket correlation: the batcher stamps each request span with its
``ticket`` attr and, at flush time, a ``flush_span`` attr pointing at the
flush span's id. :func:`trace_for_ticket` walks both links — the request
span's subtree plus every referenced flush subtree (which contains the
mesh's dispatch/retry/failover/merge spans) — so out-of-order and mixed
flushes still yield one coherent per-request trace. Chrome-trace JSON
export (open in ``chrome://tracing`` or https://ui.perfetto.dev) lives
in ``obs/export.py``.

Like everything in this repo's serving tier, the tracer takes an
injectable clock so tests drive it under simulated time; tracing is
OPT-IN per component (``tracer=None`` skips every span) and never
touches result values.

Training code does not thread a tracer through its calls: it opens
spans with the module-level :func:`span`, which reaches the tracer that
:func:`installed` put in place, and returns one shared no-op context
when none is (no ``Span`` built, no profiler call). A tracer made with
``profiler_ranges=True`` also enters a ``torch.profiler.record_function``
range of the same name for each span, so under ``torch.profiler`` the
span is a ``user_annotation`` event on the clock of the kernels and
the ops it encloses; its attributes stay on the in-memory ``Span``::

    with installed(Tracer(clock=time.perf_counter)) as tracer:
        params = mf.fit(params, data, hp, n_epochs=4)
    write_trace("train_trace.json", tracer, process_name="train")
"""
from __future__ import annotations

import contextlib
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional


class Span:
    """One timed operation. ``t1 is None`` while still open."""

    __slots__ = ("span_id", "parent_id", "name", "t0", "t1", "attrs")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 t0: float, attrs: Dict[str, object]):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def __repr__(self) -> str:
        state = "open" if self.t1 is None else f"{self.duration:.6f}s"
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, {state}, {self.attrs})")


_AUTO_PARENT = object()  # sentinel: parent defaults to the active span


class Tracer:
    """Collects spans; single-threaded like the serving loop it traces."""

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 profiler_ranges: bool = False):
        self.clock = clock
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self._next_id = 0
        self._profiler = None
        if profiler_ranges:
            import torch.profiler

            self._profiler = torch.profiler

    @property
    def current(self) -> Optional[Span]:
        """Innermost active span (``span()``/``activate()`` scope)."""
        return self._stack[-1] if self._stack else None

    def begin(self, name: str, *, parent=_AUTO_PARENT, **attrs) -> Span:
        """Open a span explicitly (the non-reentrant-flush shape). The
        caller owns its lifetime: pair with :meth:`end`. ``parent``
        overrides the default (the innermost active span); pass ``None``
        to force a root span, or a :class:`Span` to link explicitly."""
        return self._open(name, parent, attrs)

    def _open(self, name: str, parent, attrs: dict) -> Span:
        if parent is _AUTO_PARENT:
            parent = self._stack[-1] if self._stack else None
        sp = Span(
            self._next_id,
            parent.span_id if isinstance(parent, Span) else parent,
            name, self.clock(), attrs,
        )
        self._next_id += 1
        self.spans.append(sp)
        return sp

    def end(self, span: Span, **attrs) -> Span:
        span.t1 = self.clock()
        if attrs:
            span.attrs.update(attrs)
        return span

    def span(self, name: str, *, parent=_AUTO_PARENT, **attrs):
        """Scoped span: begins, becomes the active parent, ends; inside a
        ``record_function`` range of the same name where the tracer was
        made with ``profiler_ranges``."""
        return _Scope(self, name, parent, attrs)

    @contextmanager
    def activate(self, span: Span):
        """Make an explicitly begun span the active parent for the block
        (used by the batcher so mesh spans nest under its flush span)."""
        self._stack.append(span)
        try:
            yield span
        finally:
            self._stack.pop()

    # ----------------------------------------------------------- queries
    def children_index(self) -> Dict[Optional[int], List[Span]]:
        by_parent: Dict[Optional[int], List[Span]] = {}
        for sp in self.spans:
            by_parent.setdefault(sp.parent_id, []).append(sp)
        return by_parent

    def subtree(self, root: Span) -> List[Span]:
        """``root`` plus every transitive child, in discovery order."""
        by_parent = self.children_index()
        out, frontier = [], [root]
        while frontier:
            sp = frontier.pop()
            out.append(sp)
            frontier.extend(by_parent.get(sp.span_id, ()))
        return out


class _Scope:
    """The context :meth:`Tracer.span` returns (a class, not a generator:
    an epoch opens ≈ 10⁴ of them)."""

    __slots__ = ("tracer", "name", "parent", "attrs", "span", "range")

    def __init__(self, tracer: Tracer, name: str, parent, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.parent = parent
        self.attrs = attrs
        self.span: Optional[Span] = None
        self.range = None

    def __enter__(self) -> Span:
        tracer = self.tracer
        if tracer._profiler is not None:
            self.range = tracer._profiler.record_function(self.name)
            self.range.__enter__()
        self.span = tracer._open(self.name, self.parent, self.attrs)
        tracer._stack.append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        tracer = self.tracer
        tracer._stack.pop()
        self.span.t1 = tracer.clock()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_NO_SPAN = contextlib.nullcontext()
_installed: Optional[Tracer] = None


@contextmanager
def installed(tracer: Tracer):
    """Make ``tracer`` the one :func:`span` reaches for the block; the one
    installed before (or none) comes back after."""
    global _installed
    prev, _installed = _installed, tracer
    try:
        yield tracer
    finally:
        _installed = prev


def span(name: str, **attrs):
    """A span of the installed tracer (parented to its innermost open
    span), or, with none installed, one shared no-op context. ``name`` is
    a static string: readers of the profiler's trace group by it."""
    tracer = _installed
    if tracer is None:
        return _NO_SPAN
    return tracer.span(name, **attrs)


def trace_for_ticket(tracer: Tracer, ticket: int) -> List[Span]:
    """Every span belonging to one batcher ticket's request, sorted by
    start time: the spans stamped with ``ticket`` (request/queue), their
    subtrees, and the full subtree of every flush span a request span
    references via ``flush_span`` — which is where the mesh's
    dispatch/attempt/retry/failover/merge spans live. Spans a flush
    shares across tickets (the flush itself, the kernel dispatches)
    appear in each of its tickets' traces: a batched request's cost IS
    shared, and the trace says so."""
    by_id = {sp.span_id: sp for sp in tracer.spans}
    seen: Dict[int, Span] = {}
    for sp in tracer.spans:
        if sp.attrs.get("ticket") != ticket:
            continue
        for member in tracer.subtree(sp):
            seen[member.span_id] = member
        flush_id = sp.attrs.get("flush_span")
        if flush_id is not None and flush_id in by_id:
            for member in tracer.subtree(by_id[flush_id]):
                seen[member.span_id] = member
    return sorted(seen.values(), key=lambda s: (s.t0, s.span_id))
