"""Device time, host time and idle gaps by the program's own spans.

Two passes of a cell's step, each of ``n`` epochs, after its profiled
window:

  (a) the port's tracer installed with the profiler off: the host time of
      each span on ``time.perf_counter``, with no synchronise inside an
      epoch;
  (b) the tracer installed with profiler ranges on, inside a
      ``torch.profiler`` window: each span is a ``user_annotation`` event on
      the clock of the kernels and of the ``cpu_op`` events it encloses.

:func:`attribute` reads pass (b)'s chrome trace. Each kernel goes to the
innermost span around the host event that launched it: the ``cpu_op`` of
the kernel's ``External id``, else its runtime launch by ``correlation``,
then by time on that event's thread. Each idle gap between device events
goes to the innermost span around the launch of the event that ends it.
Kernels no span encloses go under :data:`NO_SPAN`. Spans are grouped by
their static names.

Nothing here imports the port: the tracer comes in through
``install(profiler_ranges)``, a context that yields the port's tracer, or
None where the port has none (``models/tracing.py``); the passes then read
nothing.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from bench.harness.profile import DEVICE_CATS

NO_SPAN = "(no span)"


def _innermost(intervals: list, points: list) -> list:
    """For each point, the intervals that hold it, outermost first.

    ``intervals`` are (start, end, index) on one thread, nested or apart;
    ``points`` are (time, query); returns (query, (index, ...)) pairs. A
    point holds in [start, end)."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, i = [], [], 0
    for t, q in sorted(points, key=lambda p: p[0]):
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] <= ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append((q, tuple(iv[2] for iv in stack)))
    return out


def _thread(ev) -> tuple:
    return (ev.get("pid"), ev.get("tid"))


def _annotations(events: list) -> tuple:
    """The spans' ``user_annotation`` events: their names and, by thread,
    their (start, end, index) intervals."""
    names, by_thread = [], defaultdict(list)
    for ev in events:
        if ev.get("cat") == "user_annotation" and "dur" in ev:
            s = float(ev["ts"])
            by_thread[_thread(ev)].append((s, s + float(ev["dur"]), len(names)))
            names.append(ev["name"])
    return names, by_thread


def _stacks(names: list, by_thread: dict, points_of: dict) -> dict:
    """query -> the names of the spans around it, outermost first, where
    ``points_of`` maps each thread to its (time, query) points."""
    out = {}
    for thread, points in points_of.items():
        for q, idx in _innermost(by_thread.get(thread, []), points):
            out[q] = tuple(names[i] for i in idx)
    return out


def attribute(events: list) -> dict:
    """Kernel time, launches and idle gaps by span, from a chrome trace's
    events (times in microseconds; sums in seconds).

    ``self`` holds, a span name each, what its innermost spans got:
    ``device_s`` (kernel time), ``launches`` and ``idle_s`` (gaps closed);
    ``inclusive`` the same for every kernel with the name anywhere around
    its launch. ``calls`` counts the spans; ``kernel_s`` and ``idle_s``
    are the totals."""
    names, by_thread = _annotations(events)
    by_ext, by_corr = {}, {}
    for ev in events:
        cat, args = ev.get("cat"), ev.get("args") or {}
        if cat == "cpu_op" and "External id" in args:
            by_ext[args["External id"]] = ev
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            by_corr[args["correlation"]] = ev
    device, points = [], defaultdict(list)
    for ev in events:
        if ev.get("cat") not in DEVICE_CATS or "dur" not in ev:
            continue
        args = ev.get("args") or {}
        host = by_ext.get(args.get("External id")) or by_corr.get(args.get("correlation"))
        q = len(device)
        s = float(ev["ts"])
        device.append((s, s + float(ev["dur"]), ev["cat"] == "kernel"))
        if host is not None:
            points[_thread(host)].append((float(host["ts"]), q))
    stacks = _stacks(names, by_thread, points)

    zero = lambda: {"device_s": 0.0, "launches": 0, "idle_s": 0.0}  # noqa: E731
    own, incl = defaultdict(zero), defaultdict(zero)

    def add(q, key, value):
        stack = stacks.get(q, ())
        own[stack[-1] if stack else NO_SPAN][key] += value
        for name in set(stack) or (NO_SPAN,):
            incl[name][key] += value

    kernel_s = idle_s = 0.0
    for q, (s, e, is_kernel) in enumerate(device):
        if is_kernel:
            kernel_s += (e - s) * 1e-6
            add(q, "device_s", (e - s) * 1e-6)
            add(q, "launches", 1)
    order = sorted(range(len(device)), key=lambda q: device[q][0])
    end = device[order[0]][1] if order else 0.0
    for q in order[1:]:
        s, e, _ = device[q]
        if s > end:
            idle_s += (s - end) * 1e-6
            add(q, "idle_s", (s - end) * 1e-6)
        end = max(end, e)
    calls = defaultdict(int)
    for name in names:
        calls[name] += 1
    return {"self": dict(own), "inclusive": dict(incl), "calls": dict(calls),
            "kernel_s": kernel_s, "idle_s": idle_s}


def host_times(spans) -> dict:
    """Calls, inclusive and self host seconds a span name, from the port's
    closed ``Span`` records (self: less the time of the spans directly
    inside)."""
    child_s = defaultdict(float)
    for sp in spans:
        if sp.parent_id is not None and sp.t1 is not None:
            child_s[sp.parent_id] += sp.t1 - sp.t0
    out = defaultdict(lambda: {"calls": 0, "host_s": 0.0, "self_s": 0.0})
    for sp in spans:
        if sp.t1 is None:
            continue
        row = out[sp.name]
        row["calls"] += 1
        row["host_s"] += sp.t1 - sp.t0
        row["self_s"] += sp.t1 - sp.t0 - child_s[sp.span_id]
    return dict(out)


def outside(events: list, op: str, span: str) -> int:
    """How many ``cpu_op`` events named ``op`` no ``span`` annotation on
    their thread encloses."""
    names, by_thread = _annotations(events)
    points = defaultdict(list)
    for i, ev in enumerate(events):
        if ev.get("cat") == "cpu_op" and ev.get("name") == op:
            points[_thread(ev)].append((float(ev["ts"]), i))
    stacks = _stacks(names, by_thread, points)
    return sum(span not in stacks[q] for q in stacks)


def _chrome_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def passes(step, n: int, sync, install) -> dict | None:
    """Passes (a) and (b) of ``n`` steps each; None where ``install``
    yields no tracer. The events of pass (b) are read and dropped, but for
    the count of ``aten::index_add_`` ops outside a ``segment_sum`` span."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with install(False) as tracer:
        if tracer is None:
            return None
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync()
        a_s = time.perf_counter() - t0
    host = host_times(tracer.spans)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with install(True), profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync()
        b_s = time.perf_counter() - t0
    events = _chrome_events(prof)
    return {"epochs": n, "pass_a_s": a_s, "pass_b_s": b_s, "host": host,
            "device": attribute(events),
            "index_add_outside_segment_sum": outside(events, "aten::index_add_",
                                                     "segment_sum")}


def metrics(model: str, p: dict | None) -> dict:
    """The per-layer numbers of the spans, for ``model`` (``mf`` or ``fm``):
    a name each, None where nothing was read (no tracer, or no kernel)."""
    out = {f"segment_sum_span_ms.{model}": None, f"resid_patch_ms.{model}": None}
    if model == "fm":
        out.update({"field_layer_host_ms.fm": None, "field_layer_idle_share.fm": None})
    if p is None:
        return out
    n, incl = p["epochs"], p["device"]["inclusive"]

    def device_ms(name):
        row = incl.get(name)
        return 1e3 * row["device_s"] / n if row and row["launches"] else None

    out[f"segment_sum_span_ms.{model}"] = device_ms("segment_sum")
    out[f"resid_patch_ms.{model}"] = device_ms(f"{model}.patch")
    if model == "fm":
        layer = p["host"].get("fm.field_layer")
        out["field_layer_host_ms.fm"] = 1e3 * layer["host_s"] / n if layer else None
        idle = p["device"]["idle_s"]
        row = incl.get("fm.field_layer")
        if idle > 0 and row and row["launches"]:
            out["field_layer_idle_share.fm"] = 100.0 * row["idle_s"] / idle
    return out


def table(p: dict) -> list:
    """Lines of a table, a span name each: calls, launches, device ms,
    self host ms and idle ms closed, all an epoch; device and idle by the
    innermost span."""
    n, own = p["epochs"], p["device"]["self"]
    host, calls = p["host"], p["device"]["calls"]
    names = sorted(set(own) | set(host), key=lambda k: -own.get(k, {}).get("device_s", 0.0))
    lines = [f"{'span':<16} {'calls':>9} {'launches':>9} {'device ms':>10} "
             f"{'self host ms':>12} {'idle ms':>9}"]
    for name in names:
        d = own.get(name, {"device_s": 0.0, "launches": 0, "idle_s": 0.0})
        h = host.get(name, {"self_s": 0.0})
        lines.append(f"{name:<16} {calls.get(name, 0) / n:>9.1f} {d['launches'] / n:>9.1f} "
                     f"{1e3 * d['device_s'] / n:>10.3f} {1e3 * h['self_s'] / n:>12.3f} "
                     f"{1e3 * d['idle_s'] / n:>9.3f}")
    return lines
