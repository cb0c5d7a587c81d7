"""Driver for training cells whose step is one iCD epoch.

Set-up draws the inputs from the seed, builds the program (layout,
factors, residuals) and drives it through the workload's
``check_epochs`` epochs by the window's own call, keeping the leaves and
the carried residuals after each (the reference follows those epochs
later). The window then runs complete epochs back to back
until ``seconds`` have passed, synchronising after each, and the rate is
real interactions × epochs ÷ the time to the end of the last. A traced
run then profiles ``trace_epochs`` more. Once the memory peak is read and
the program is freed, the reference runs the checked epochs from the same
start, and ``checks.compare`` gives the numbers that decide ``correct``.
"""
from __future__ import annotations

import time

import torch

from bench.harness import checks, profile, traffic
from bench.reference import common


def _host(leaves: dict) -> dict:
    return {n: t.detach().to("cpu", copy=True) for n, t in leaves.items()}


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def run(cell, *, seed: int, seconds: float, trace: bool, device, t_start: float,
        note, wrap=None) -> dict:
    """One run; ``wrap(program)`` (tests only) breaks the program's step
    underneath the driver."""
    cfg, wl = cell.config, cell.workload
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    stages = {"start": time.perf_counter() - t_start}
    inputs = traffic.make_inputs(cfg, cell.traffic, seed, device)
    theta0 = _host(inputs.factors)
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
        snaps.append(_host(prog.leaves()))
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
    finite = _finite(prog.residual(), *prog.leaves().values())
    summary = profile.profile_steps(prog.step, int(wl["trace_epochs"]), sync) if trace else None
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
        "counters": counters, "trace": summary, "memory_peak_bytes": peak,
        "attempted": n, "failed": 0 if finite else n,
        "checks": numbers, "info": info,
    }
