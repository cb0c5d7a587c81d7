"""The control and the planted faults of a training cell, read on the chip
at the cell's own size (the benchmark's runs never run this).

    python3 bench/tools/control.py --workload <cell> --seeds 1 2 3 [--kinds control half]

For each seed it draws the cell's inputs as a run does, puts a stand-in
in the program's place, and prints the numbers ``checks.compare`` gives
against the float64 reference, one JSON line a seed and kind:

  control  the reference in float32 with TF32 matrix products (the
           precision below the configuration's float32 with TF32 off)
  fp32     the reference in float32, TF32 off: the configuration's own
           precision, a witness beside the program
  half     the reference with half of the interactions left out (every
           other one in (ctx, item) order)
  frozen   a step that returns its state unchanged
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


class StandIn:
    """A reference run in the program's place: steps in ``arith``, over
    ``weights`` (None: every interaction), or not at all (``frozen``)."""

    def __init__(self, ref_cls, inputs, config, theta0, arith, device,
                 weights=None, frozen=False):
        self.ref = ref_cls(inputs, config, theta0, arith, device, weights)
        self.frozen = frozen

    def step(self):
        if not self.frozen:
            self.ref.epoch()

    def leaves(self):
        return {n: t.to("cpu", torch.float32, copy=True)
                for n, t in self.ref.leaves().items()}

    def residual(self):
        return self.ref.residual().to("cpu", torch.float32, copy=True)


def readings(cell, seed: int, kinds, device) -> dict:
    """{kind: (compared numbers, reported numbers)} for one seed."""
    from bench.harness import checks, traffic
    from bench.reference import common

    common.no_tf32()
    cfg, n_check = cell.config, int(cell.workload["check_epochs"])
    ref_cls = cell.reference().Reference
    inputs = traffic.make_inputs(cfg, cell.traffic, seed, device)
    theta0 = {n: t.detach().to("cpu", copy=True) for n, t in inputs.factors.items()}
    half = torch.ones(inputs.nnz, dtype=torch.float64)
    half[1::2] = 0.0
    stand_ins = {
        "control": dict(arith=common.CONTROL),
        "fp32": dict(arith=common.Arith(torch.float32)),
        "half": dict(arith=common.REFERENCE, weights=half),
        "frozen": dict(arith=common.REFERENCE, frozen=True),
    }
    out = {}
    for kind in kinds:
        prog = StandIn(ref_cls, inputs, cfg, theta0, device=device, **stand_ins[kind])
        snaps, resids = [], []
        for _ in range(n_check):
            prog.step()
            snaps.append(prog.leaves())
            resids.append(prog.residual())
        del prog
        ref = ref_cls(inputs, cfg, theta0, common.REFERENCE, device)
        out[kind] = checks.compare(snaps, resids, theta0, ref, device)
        del ref
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=["control", "half"],
                    choices=["control", "fp32", "half", "frozen"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        sys.path.insert(0, str(path))
    from bench.harness.spec import Cell

    cell = Cell(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for kind, (numbers, info) in readings(cell, seed, args.kinds,
                                              torch.device(args.device)).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers, "info": info,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
