"""Driver for training cells whose step is one iCD epoch, with the
program's spans: ``icd_epoch``'s run, its inputs drawn by
``harness/hours.make_inputs`` (the generator's, with an hour on each
interaction where the mix has an hour law), and in a traced run the two
span passes of ``harness/spans.passes`` after the profiled window, each
over ``trace_epochs`` epochs, returned as ``"spans"``.

Set-up draws the inputs, builds the program and runs the workload's
``check_epochs`` epochs, keeping the leaves and carried residuals after
each. The window runs complete epochs back to back, synchronised after
each, until ``seconds`` have passed; the rate is real interactions ×
epochs ÷ the time to the end of the last. A traced run then profiles
``trace_epochs`` more and runs the span passes. Once the memory peak is
read and the program is freed, the reference runs the checked epochs
from the same start, and ``checks.compare`` gives the numbers that decide
``correct``.
"""
from __future__ import annotations

import time

import torch

from bench.harness import checks, hours, profile, spans, traffic
from bench.reference import common


def run(cell, *, seed: int, seconds: float, trace: bool, device, t_start: float,
        note, wrap=None) -> dict:
    """One run; ``wrap(program)`` (tests only) breaks the program's step
    underneath the driver."""
    base = cell.module("drivers", "icd_epoch")
    cfg, wl = cell.config, cell.workload
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    stages = {"start": time.perf_counter() - t_start}
    inputs = hours.make_inputs(cfg, cell.traffic, seed, device)
    theta0 = base._host(inputs.factors)
    sync()
    stages["inputs"] = time.perf_counter() - t_start
    prog = cell.program().Program(cfg, inputs, device)
    if wrap is not None:
        wrap(prog)
    sync()
    stages["program"] = time.perf_counter() - t_start
    snaps, resids = [], []
    for _ in range(int(wl["check_epochs"])):
        prog.step()
        snaps.append(base._host(prog.leaves()))
        resids.append(prog.residual().to("cpu", copy=True))
    sync()
    setup_s = time.perf_counter() - t_start
    stages["checked_epochs"] = setup_s
    note(f"set-up stages, s from the start: {stages}")

    t0 = time.perf_counter()
    ends = []
    while True:
        prog.step()
        sync()
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    n, window = len(ends), ends[-1]
    each = sorted(b - a for a, b in zip([0.0] + ends, ends))
    note(f"window: {n} epochs in {window:.6f} s; an epoch min {each[0]:.6f} "
         f"median {each[n // 2]:.6f} max {each[-1]:.6f} s; epoch ends, s: "
         f"{[round(t, 4) for t in ends]}")
    finite = base._finite(prog.residual(), *prog.leaves().values())
    summary = passes = None
    if trace:
        n_trace = int(wl["trace_epochs"])
        summary = profile.profile_steps(prog.step, n_trace, sync)
        passes = spans.passes(prog.step, n_trace, sync,
                              cell.module("models", "tracing").install)
        for line in spans.table(passes) if passes is not None else ():
            note(line)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    counters = dict(prog.counters(), **traffic.max_degrees(inputs))
    note(f"counters {counters}")
    del prog
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    common.no_tf32()
    ref = cell.reference().Reference(inputs, cfg, theta0, common.REFERENCE, device)
    numbers, info = checks.compare(snaps, resids, theta0, ref, device)
    note(f"reference: {len(snaps)} epochs and the comparison in "
         f"{time.perf_counter() - t_ref:.3f} s")
    note(f"numbers: {numbers}; reported: {info}")
    return {
        "model": cfg["model"], "config": cfg, "traffic": cell.traffic,
        "setup_s": setup_s, "window_s": window, "epochs": n,
        "nnz": inputs.nnz, "nnz_per_s": inputs.nnz * n / window,
        "counters": counters, "trace": summary, "spans": passes,
        "memory_peak_bytes": peak, "attempted": n, "failed": 0 if finite else n,
        "checks": numbers, "info": info,
    }
