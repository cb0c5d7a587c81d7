"""Driver for the distributed training cell: one process a card, a world
of the cell's ``chips`` ranks (NCCL on the cards, gloo on the CPU), each
running the program of ``models/mf_dist.py`` back to back.

Rank 0 is the run's own process; it starts ranks 1 … W−1 as

    python3 bench/drivers/mf_dist_epoch.py ROOT CELL SEED SECONDS TRACE RANK WORLD PORT DEVICE_TYPE

and meets them at ``tcp://localhost:PORT``. Every rank draws the cell's
inputs from the seed (the same on every rank), shards the log and keeps
its own blocks. Set-up runs the workload's ``check_epochs`` epochs; after
each, rank 0 gathers the unsharded factors and residuals. The window runs
epochs back to back on every rank; rank 0 synchronises its card after
each, reads its clock and tells the others, by an all-reduce of a flag,
whether the window has closed; the rate is real interactions × epochs ÷
rank 0's time to the end of the last. A traced run profiles
``trace_epochs`` more on rank 0. The memory peak is the fullest card's.
Rank 0 then leaves the world and runs the reference on the unsharded
inputs, as ``icd_epoch`` does.
"""
from __future__ import annotations

import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

FILE = Path(__file__).resolve()
JOIN_S = 600  # how long rank 0 waits for the other ranks to leave


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(cell, seed: int, seconds: float, trace: bool, rank: int, world: int,
          port: int, device_type: str, t_start: float, note, wrap=None):
    """One rank's run; rank 0 returns what the reference and the readers
    need, the others None. ``wrap`` (tests only) reaches rank 0's program
    alone."""
    import torch.distributed as dist

    from bench.harness import profile, traffic

    cuda = device_type == "cuda"
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    lead = rank == 0

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    try:
        cfg, wl = cell.config, cell.workload
        inputs = traffic.make_inputs(cfg, cell.traffic, seed, device)
        theta0 = {n: t.to("cpu", copy=True) for n, t in inputs.factors.items()}
        prog = cell.module("models", "mf_dist").Program(cfg, inputs, device, rank, world)
        if wrap is not None:
            wrap(prog)
        snaps, resids = [], []
        for _ in range(int(wl["check_epochs"])):
            prog.step()
            leaves, resid = prog.leaves(), prog.residual()
            if lead:
                snaps.append({n: t.to("cpu", copy=True) for n, t in leaves.items()})
                resids.append(resid.to("cpu", copy=True))
        sync()
        setup_s = time.perf_counter() - t_start
        flag = torch.zeros(1, device=device)
        t0 = time.perf_counter()
        ends = []
        while True:
            prog.step()
            sync()
            ends.append(time.perf_counter() - t0)
            flag.fill_(float(lead and ends[-1] >= seconds))
            dist.all_reduce(flag)
            if flag.item() > 0:
                break
        n, window = len(ends), ends[-1]
        finite = torch.tensor([float(all(bool(torch.isfinite(t).all())
                                         for t in (prog.w, prog.h, prog.e)))], device=device)
        dist.all_reduce(finite, op=dist.ReduceOp.MIN)
        summary = None
        if trace:
            n_trace = int(wl["trace_epochs"])
            if lead:
                summary = profile.profile_steps(prog.step, n_trace, sync)
            else:
                for _ in range(n_trace):
                    prog.step()
        peaks = torch.tensor([float(torch.cuda.max_memory_allocated(device) if cuda else 0)],
                             device=device)
        dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
        counters = prog.counters()
        del prog
    finally:
        dist.destroy_process_group()
    if not lead:
        return None
    if cuda:
        torch.cuda.empty_cache()
    each = sorted(b - a for a, b in zip([0.0] + ends, ends))
    note(f"window: {n} epochs in {window:.6f} s over {world} rank(s); an epoch min "
         f"{each[0]:.6f} median {each[n // 2]:.6f} max {each[-1]:.6f} s")
    note(f"counters {counters}")
    return dict(inputs=inputs, theta0=theta0, snaps=snaps, resids=resids, setup_s=setup_s,
                window=window, n=n, finite=bool(finite.item() > 0), summary=summary,
                peak=int(peaks.item()), counters=counters, device=device)


def run(cell, *, seed: int, seconds: float, trace: bool, device, t_start: float,
        note, wrap=None) -> dict:
    from bench.harness import checks, traffic
    from bench.reference import common

    world, port = int(cell.chips), _free_port()
    others = [subprocess.Popen([sys.executable, str(FILE), str(cell.root), cell.name,
                                str(seed), str(seconds), str(int(trace)), str(r), str(world),
                                str(port), device.type])
              for r in range(1, world)]
    try:
        got = _rank(cell, seed, seconds, trace, 0, world, port, device.type, t_start,
                    note, wrap)
    except BaseException:
        for p in others:
            p.kill()
        raise
    codes = [p.wait(timeout=JOIN_S) for p in others]
    if any(codes):
        raise RuntimeError(f"ranks 1..{world - 1} exited with {codes}")

    t_ref = time.perf_counter()
    common.no_tf32()
    inputs, dev = got["inputs"], got["device"]
    ref = cell.reference().Reference(inputs, cell.config, got["theta0"], common.REFERENCE, dev)
    numbers, info = checks.compare(got["snaps"], got["resids"], got["theta0"], ref, dev)
    note(f"reference: {len(got['snaps'])} epochs and the comparison in "
         f"{time.perf_counter() - t_ref:.3f} s")
    note(f"numbers: {numbers}; reported: {info}")
    n = got["n"]
    return {
        "model": cell.config["model"], "config": cell.config, "traffic": cell.traffic,
        "setup_s": got["setup_s"], "window_s": got["window"], "epochs": n,
        "nnz": inputs.nnz, "nnz_per_s": inputs.nnz * n / got["window"],
        "counters": dict(got["counters"], **traffic.max_degrees(inputs)),
        "trace": got["summary"], "memory_peak_bytes": got["peak"],
        "attempted": n, "failed": 0 if got["finite"] else n,
        "checks": numbers, "info": info,
    }


def main(argv) -> int:
    root, name, seed, seconds, trace, rank, world, port, device_type = argv
    for path in (Path(root) / "src", Path(root)):
        sys.path.insert(0, str(path))
    from bench.harness.spec import Cell

    _rank(Cell(name, Path(root)), int(seed), float(seconds), bool(int(trace)), int(rank),
          int(world), int(port), device_type, time.perf_counter(), note=lambda msg: None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
