"""Observability spine of the port: metrics, request tracing, kernel cost
accounting (port of ``repro.obs``; same metric and span names).

  metrics.py  label-aware Counter/Gauge/Histogram registry
  trace.py    spans with parent/child links and batcher-ticket correlation
  export.py   JSONL + Prometheus text exposition; Chrome-trace JSON
  costs.py    per-dispatch bytes / FLOPs / shared memory of the kernels
  train.py    the ``fit(callback=...)`` metrics adapter of the training loop
"""
from repro_torch.obs.costs import (
    KernelCostRecorder,
    cd_sweep_cost,
    topk_score_cost,
)
from repro_torch.obs.export import (
    chrome_trace,
    metrics_jsonl,
    prometheus_text,
    write_metrics,
    write_trace,
)
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    NULL_REGISTRY,
    MetricsRegistry,
    StatsView,
    default_registry,
    next_instance_id,
    resolve_registry,
    set_default_registry,
)
from repro_torch.obs.trace import Span, Tracer, trace_for_ticket
from repro_torch.obs.train import compose_callbacks, fit_metrics_callback

__all__ = [
    "DEFAULT_BUCKETS",
    "KernelCostRecorder",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "Span",
    "StatsView",
    "Tracer",
    "cd_sweep_cost",
    "chrome_trace",
    "compose_callbacks",
    "default_registry",
    "fit_metrics_callback",
    "metrics_jsonl",
    "next_instance_id",
    "prometheus_text",
    "resolve_registry",
    "set_default_registry",
    "topk_score_cost",
    "trace_for_ticket",
    "write_metrics",
    "write_trace",
]
