"""``tools/control.py`` for cells whose mix has an hour law: the same
readings, with each seed's inputs drawn by ``harness/hours.make_inputs``
(the generator's, with the hours) in place of the generator's own.

    python3 bench/tools/control_hours.py --workload <cell> --seeds 1 2 3 [--kinds control half]
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from bench.harness import hours, traffic  # noqa: E402
from bench.tools import control  # noqa: E402


@contextlib.contextmanager
def hourly_inputs():
    """``traffic.make_inputs`` is ``hours.make_inputs`` for the block."""
    base = traffic.make_inputs
    traffic.make_inputs = hours.make_inputs
    try:
        yield
    finally:
        traffic.make_inputs = base


def readings(cell, seed: int, kinds, device) -> dict:
    with hourly_inputs():
        return control.readings(cell, seed, kinds, device)


def main(argv=None) -> int:
    with hourly_inputs():
        return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
