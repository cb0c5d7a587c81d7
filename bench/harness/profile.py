"""Read a short profiled sub-window: kernel time by name, device busy time,
launches, device time by the PyTorch op that launched it, and the idle
gaps by what the host was about to launch.

``torch.profiler`` (CPU and CUDA activities) writes its trace to a file
in ``TMPDIR``; the file is read once, summed, and deleted, so no timeline
outlives the run.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize(events: list, window_s: float) -> dict:
    """Sums over a chrome trace's events (times in microseconds)."""
    ops = {}   # External id -> cpu op name
    for ev in events:
        if ev.get("cat") == "cpu_op":
            ext = ev.get("args", {}).get("External id")
            if ext is not None:
                ops[ext] = ev["name"]
    kernels, by_op, device = {}, {}, []
    n_launch = 0
    for ev in events:
        if ev.get("cat") not in DEVICE_CATS or "dur" not in ev:
            continue
        s, d = float(ev["ts"]), float(ev["dur"])
        op = ops.get(ev.get("args", {}).get("External id"), "(no op)")
        device.append((s, s + d, op))
        if ev["cat"] == "kernel":
            n_launch += 1
            kernels[ev["name"]] = kernels.get(ev["name"], 0.0) + d * 1e-6
            by_op[op] = by_op.get(op, 0.0) + d * 1e-6
    device.sort()
    gaps = {}
    end = device[0][1] if device else 0.0
    for s, e, op in device[1:]:
        if s > end:
            gaps[op] = gaps.get(op, 0.0) + (s - end) * 1e-6
        end = max(end, e)
    busy = _union((s, e) for s, e, _ in device) * 1e-6
    return {"kernels": kernels, "op_device_s": by_op, "launches": n_launch,
            "busy_s": busy, "window_s": window_s, "idle_gaps": gaps}


def profile_steps(step, n: int, sync) -> dict:
    """Run ``step`` ``n`` times under the profiler and summarise; the
    window is the host time from the first launch to the synchronised end
    of the last step."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = summarize(events, window)
    out["steps"] = n
    return out


def idle_share(m: dict):
    """1 − the device's busy time a traced epoch ÷ the time an epoch of
    the untraced window took, in %: the profiler slows the host, so the
    traced window's own length would read its overhead as idle time."""
    tr = m.get("trace")
    if tr is None or tr["busy_s"] <= 0 or m["epochs"] <= 0:
        return None
    return 100.0 * (1.0 - (tr["busy_s"] / tr["steps"]) / (m["window_s"] / m["epochs"]))


def op_ms_per_step(m: dict, op: str):
    """Device time of the kernels that host op ``op`` launched, in ms a
    traced epoch; None where it launched none."""
    tr = m.get("trace")
    s = 0.0 if tr is None else tr["op_device_s"].get(op, 0.0)
    return 1e3 * s / tr["steps"] if s > 0 else None


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest entries of a name → seconds dict, as [name, s]."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
