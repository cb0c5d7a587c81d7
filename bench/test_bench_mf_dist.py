"""CPU test of the distributed training driver (``drivers/mf_dist_epoch``):
the toy iCD-MF cell run as a world of 4 gloo ranks on the CPU, one process
a rank, against the float64 reference of ``mf-train-youtube``. The cell
is added to a toy checkout's ``BENCHMARK.json`` as a new entry, with the
workload file ``bench/workloads/mf-dist-train-youtube.json``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench.tools import toy

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 7
NAME = "mf-dist-train-youtube-toy"


@pytest.fixture(scope="module")
def dist_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_dist")
    toy.make(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = json.loads((ROOT / "bench/workloads/mf-dist-train-youtube.json").read_text())
    wl["checks"] = {k: toy.TOY_LOSS_LIMIT if k.startswith("loss_gap") else v
                    for k, v in wl["checks"].items()}
    (root / "bench/workloads" / f"{NAME}.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": NAME, "config": "icd-mf-toy", "traffic": "youtube-toy",
                               "chips": 4, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append(NAME)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_four_gloo_ranks_agree_with_the_reference(dist_root, trace):
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from bench.harness import cell as h\n"
            f"r = h.run_cell({NAME!r}, seed={SEED}, seconds=0.3, trace={trace},"
            " device='cpu', root=sys.argv[2])\n"
            "print(json.dumps(r))")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT / "src"), str(dist_root)],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().split("\n")[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    # the cell asks no per-layer metric; the end-to-end ones are on the clock
    assert set(line["metrics"]) == (set() if trace else {"setup_s", "factor_train_nnz_per_s"})
    assert ("breakdown" in line) == trace
    # float32 over 4 ranks against float64 at toy size: rounding alone
    assert all(c["value"] < 1e-5 for c in line["checks"].values()), line["checks"]
    assert "window: " in proc.stderr and "over 4 rank(s)" in proc.stderr
