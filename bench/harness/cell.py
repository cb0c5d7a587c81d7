"""One run of one cell: the driver's run, the metric readers, the limits
and the result line."""
from __future__ import annotations

import math
import subprocess
import sys
import time

import torch

from bench.harness import profile
from bench.harness.spec import ROOT, Cell

# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden, the part before
    the first dot compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return proc.stdout.strip() or proc.stderr.strip()


def device_info(device, out: dict) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    tr = out.get("trace")
    if tr is not None:
        info["busy_s"] = tr["busy_s"]
        info["window_s"] = tr["window_s"]
    return info


def run_cell(name: str, *, seed: int, seconds: float, trace: bool,
             device=None, root=ROOT, t_start=None, wrap=None) -> dict:
    """Run cell ``name`` once and return its result (the line's object).
    ``device`` defaults to the first card; ``wrap`` is for tests."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    cell = Cell(name, root)
    out = cell.driver().run(cell, seed=seed, seconds=seconds, trace=trace,
                            device=device, t_start=t_start, note=note, wrap=wrap)
    device_line = device_info(device, out)
    out["device_kind"] = device_line["kind"]
    if device.type == "cuda":
        note(f"card: {card_line()}")
    metrics = {}
    for spec in cell.per_layer if trace else cell.end_to_end:
        value = cell.reader(spec["name"]).read(out)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    limits = cell.workload["checks"]
    checks = {k: {"value": out["checks"][k], "limit": limits[k]} for k in limits}
    correct = (out["failed"] == 0 and out["attempted"] > 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_line}
    tr = out.get("trace")
    if tr is not None:
        result["breakdown"] = {"device_ops": profile.top(tr["kernels"]),
                               "idle_gaps": profile.top(tr["idle_gaps"])}
    result["checks"] = checks
    return result


def report(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for k, c in result["checks"].items():
        note(f"check {k} {c['value']!r} limit {c['limit']!r}")
