"""The port's tracer for the span passes (``harness/spans.py``): installed
with ``repro_torch.obs.trace.installed`` around the epochs, on
``time.perf_counter``, with or without profiler ranges. A port without an
installable tracer yields None, and the passes read nothing."""
from __future__ import annotations

import contextlib
import time

from repro_torch.obs import trace


@contextlib.contextmanager
def install(profiler_ranges: bool):
    if not hasattr(trace, "installed"):
        yield None
        return
    tracer = trace.Tracer(clock=time.perf_counter, profiler_ranges=profiler_ranges)
    with trace.installed(tracer):
        yield tracer
