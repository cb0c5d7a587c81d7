"""A cell's epochs by the program's spans: device time, host time and
idle gaps a span, with what tracing costs when it is on.

    python3 bench/tools/spans.py --workload <cell> --seed <n> [--epochs <n>]

Set-up as a run of the cell makes it (inputs from the seed, the program,
the workload's checked epochs, untimed), then, each over ``--epochs``
epochs (default: the workload's ``trace_epochs``): the epochs untraced,
synchronised after each; the profiled window of a traced run
(``profile.profile_steps``, no tracer); pass (a) and pass (b) of
``harness/spans.py``. Prints the table of spans on standard error and one
JSON line on standard output: the epochs' times, the profiled window's
``segment_sum_ms`` (kernels under ``aten::index_add_``), the span
metrics of ``spans.metrics``, the share of the epochs' device time no
span holds, and the ``aten::index_add_`` ops outside a ``segment_sum``
span. No correctness check runs: that is the cell's own run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import torch  # noqa: E402

from bench.harness import profile, spans, traffic  # noqa: E402
from bench.harness.spec import Cell  # noqa: E402


def measure(name: str, seed: int, epochs: int | None = None, device=None,
            root=ROOT, note=print) -> dict:
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    cell = Cell(name, root)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    n = int(cell.workload["trace_epochs"] if epochs is None else epochs)
    inputs = traffic.make_inputs(cell.config, cell.traffic, seed, device)
    prog = cell.program().Program(cell.config, inputs, device)
    for _ in range(int(cell.workload["check_epochs"])):
        prog.step()
    sync()
    untraced = []
    for _ in range(n):
        t0 = time.perf_counter()
        prog.step()
        sync()
        untraced.append(time.perf_counter() - t0)
    window = profile.profile_steps(prog.step, n, sync)
    p = spans.passes(prog.step, n, sync, cell.module("models", "tracing").install)
    model = cell.config["model"]
    out = {"workload": name, "seed": seed, "epochs": n,
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "untraced_epoch_s": untraced, "profiled_window_s": window["window_s"],
           "profiled_busy_s": window["busy_s"], "profiled_launches": window["launches"],
           "segment_sum_ms": profile.op_ms_per_step({"trace": window}, "aten::index_add_"),
           "metrics": spans.metrics(model, p)}
    if p is not None:
        dev = p["device"]
        roots = dev["inclusive"].get(f"{model}.epoch", {"device_s": 0.0})["device_s"]
        out.update(pass_a_epoch_s=p["pass_a_s"] / n, pass_b_window_s=p["pass_b_s"],
                   kernel_s=dev["kernel_s"], idle_s=dev["idle_s"],
                   no_span_share=(100.0 * dev["self"].get(spans.NO_SPAN, {"device_s": 0.0})
                                  ["device_s"] / roots if roots > 0 else None),
                   index_add_outside_segment_sum=p["index_add_outside_segment_sum"],
                   spans={k: {key: v[key] / n for key in ("device_s", "launches", "idle_s")}
                          for k, v in dev["self"].items()},
                   host={k: {key: v[key] / n for key in ("calls", "host_s", "self_s")}
                         for k, v in p["host"].items()})
        for line in spans.table(p):
            note(line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--epochs", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[spans] needs a CUDA device", file=sys.stderr)
        return 2
    out = measure(args.workload, args.seed, args.epochs,
                  note=lambda msg: print(f"[spans] {msg}", file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
