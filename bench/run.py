"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m bench.run ...``) from the root of a checkout. It needs
the cards the cell asks for, and exits non-zero, printing no result,
without them, or where a module of ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` was loaded. The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, which also close standard error.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here, before the imports

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.harness import cell as harness
    from bench.harness.spec import Cell

    chips = Cell(args.workload, ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), root=ROOT, t_start=T_START)
    found = harness.foreign_modules()
    if found:
        print(f"[bench] forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    harness.report(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
