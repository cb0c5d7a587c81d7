"""Exposition: registry → JSONL / Prometheus text, tracer → Chrome trace.

Formats:

  * **JSONL** (``metrics_jsonl`` / ``write_metrics`` on a ``.jsonl``
    path): one JSON object per metric child per line — ``{"name", "type",
    "labels", "value"}``; histograms add ``count``/``sum``/``buckets``
    (cumulative, keyed by upper edge) and ``p50``/``p90``/``p99``. Line
    oriented so a long-running driver can append snapshots and ``jq``
    stays trivial.
  * **Prometheus text** (``prometheus_text`` / ``write_metrics`` on a
    ``.prom`` path): the standard ``# HELP``/``# TYPE`` + sample-line
    exposition; histograms emit the ``_bucket{le=...}`` cumulative
    series, ``_sum`` and ``_count``, so the files scrape-parse with
    stock tooling.
  * **Chrome trace** (``chrome_trace`` / ``write_trace``): the tracer's
    spans as ``ph: "X"`` complete events (ts/dur in microseconds, span
    attrs under ``args``), loadable in ``chrome://tracing`` or
    https://ui.perfetto.dev. Parent/child nesting renders by time
    containment on one track; the explicit ids ride along in ``args``
    for programmatic consumers.
"""
from __future__ import annotations

import json
from typing import List

from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.trace import Tracer


def _label_str(labels_kv) -> str:
    if not labels_kv:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels_kv)
    return "{" + inner + "}"


def metrics_jsonl(registry: MetricsRegistry) -> str:
    """One JSON object per metric child per line."""
    lines: List[str] = []
    for fam in registry.families():
        for child in fam.children():
            rec = {
                "name": fam.name,
                "type": fam.kind,
                "labels": dict(child.labels_kv),
            }
            if isinstance(child, Histogram):
                cum = 0
                buckets = {}
                for edge, n in zip(child.edges, child.counts):
                    cum += n
                    buckets[f"{edge:g}"] = cum
                buckets["+Inf"] = child.count
                rec.update(
                    count=child.count, sum=child.sum, buckets=buckets,
                    # NaN percentiles (empty histograms) must not break
                    # strict JSON readers: NaN -> null
                    **{q: (None if v != v else v)
                       for q, v in child.percentiles().items()},
                )
            else:
                rec["value"] = child.value
            lines.append(json.dumps(rec, allow_nan=False))
    return "\n".join(lines) + ("\n" if lines else "")


def prometheus_text(registry: MetricsRegistry) -> str:
    lines: List[str] = []
    for fam in registry.families():
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for child in fam.children():
            base = dict(child.labels_kv)
            if isinstance(child, Histogram):
                cum = 0
                for edge, n in zip(child.edges, child.counts):
                    cum += n
                    kv = tuple({**base, "le": f"{edge:g}"}.items())
                    lines.append(f"{fam.name}_bucket{_label_str(kv)} {cum}")
                kv = tuple({**base, "le": "+Inf"}.items())
                lines.append(f"{fam.name}_bucket{_label_str(kv)} {child.count}")
                lines.append(
                    f"{fam.name}_sum{_label_str(child.labels_kv)} {child.sum}")
                lines.append(
                    f"{fam.name}_count{_label_str(child.labels_kv)} {child.count}")
            else:
                lines.append(
                    f"{fam.name}{_label_str(child.labels_kv)} {child.value}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_metrics(path: str, registry: MetricsRegistry) -> str:
    """Write the registry to ``path``: Prometheus text for ``.prom``,
    JSONL otherwise. Returns the path."""
    text = (prometheus_text(registry) if path.endswith(".prom")
            else metrics_jsonl(registry))
    with open(path, "w") as f:
        f.write(text)
    return path


# ------------------------------------------------------------ chrome trace
def chrome_trace(tracer: Tracer, *, process_name: str = "repro-serve") -> dict:
    """Tracer spans as a Chrome trace event object (Perfetto-openable)."""
    t_base = min((sp.t0 for sp in tracer.spans), default=0.0)
    events = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": process_name},
    }]
    for sp in tracer.spans:
        end = sp.t1 if sp.t1 is not None else sp.t0
        args = {k: _jsonable(v) for k, v in sp.attrs.items()}
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        events.append({
            "name": sp.name,
            "ph": "X",
            "ts": (sp.t0 - t_base) * 1e6,          # microseconds
            "dur": max(end - sp.t0, 0.0) * 1e6,
            "pid": 1,
            "tid": 1,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def write_trace(path: str, tracer: Tracer, *,
                process_name: str = "repro-serve") -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, process_name=process_name), f)
    return path
