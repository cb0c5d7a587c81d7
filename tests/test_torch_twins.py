"""The continual-learning and observability twins
(``repro_torch.examples.{continual_learning,observability}``) on the CPU,
beside the JAX package's examples run as they ship: the same counts of
fold-in queries, delta-published items and versions, and the same report
lines; the twin's cold-start recall@10 beats popularity on the same
users; the observability files parse."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import continual_learning, observability

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _template(line: str) -> str:
    return re.sub(r"-?\d+(\.\d+)?", "#", line)


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Both reference examples at once, each in its own process (the
    observability one writes ``results/obs`` under its working directory,
    here a temporary one)."""
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    cwd = tmp_path_factory.mktemp("ref_obs")
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py")], cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in ("continual_learning", "observability")}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stdout[-1500:] + stderr[-1500:]
        out[name] = stdout.splitlines()
    out["obs_dir"] = cwd / "results" / "obs"
    return out


def test_continual_twin_counts_equal_reference(reference_runs):
    lines = []
    out = continual_learning.run(*_example_log(), device="cpu", log=lines.append)
    want = reference_runs["continual_learning"]
    assert [_template(x) for x in lines] == [_template(x) for x in want]
    assert lines[:3] == want[:3]   # warm, live and continual lines: counts only
    assert out["folded_items"] == 4 and out["versions"] == [4, 5, 6, 9]
    assert out["folded_users"] == 1005 and out["version"] == 21
    assert out["n_items_live"] == continual_learning.N_ITEMS
    assert out["recall"] > out["recall_pop"], out
    assert len(out["query_s"]) == out["folded_users"]
    assert out["n_eval"] == int(re.search(r"over (\d+) users", want[3]).group(1))


def _example_log():
    from repro_torch.data.synthetic import make_implicit_dataset

    c = continual_learning
    ds = make_implicit_dataset(n_users=c.N_USERS, n_items=c.N_ITEMS,
                               attr_strength=0.8, seed=0)
    return ds.events, c.N_USERS, c.N_ITEMS, c.K


def test_continual_twin_pieces():
    events, n_users, n_items, _ = _example_log()
    hists = continual_learning.user_histories(events, n_users)
    loop = [[] for _ in range(n_users)]
    for u, i, _t in events:
        loop[u].append(i)
    assert all(np.array_equal(h, np.asarray(x, np.int64)) for h, x in zip(hists, loop))
    # popularity: the most-seen item first, ties by id, history excluded
    assert continual_learning.popularity_recall(
        np.array([2, 2, 1, 1, 0]), 4, [np.array([2])], [1], k=1) == 1.0
    # a bounded replay answers fewer queries with the same counting
    out = continual_learning.run(events, n_users, n_items, 8, tail_batches=2,
                                 n_eval=20, device="cpu", log=lambda s: None)
    tail = events[int(0.8 * len(events)):][:128]
    assert out["folded_users"] == int((tail[:, 1] < n_items - 4).sum())
    assert len(out["held"]) == 8 and out["version"] == 1 + len(out["versions"]) + 2


def test_observability_twin_equals_reference(reference_runs, tmp_path):
    lines = []
    out = observability.run(out_dir=str(tmp_path), device="cpu", log=lines.append)
    want = reference_runs["observability"]
    lines = [x.replace(str(tmp_path), os.path.join("results", "obs")) for x in lines]
    assert [_template(x) for x in lines] == [_template(x) for x in want]
    assert lines[1:3] == want[1:3]         # serve counters, the ticket's spans
    assert out["versions"] == [1, 2, 3, 4] and out["losses"][-1] < out["losses"][0]
    # the three files parse, with the reference's series and event counts
    rows = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == out["n_series"] == len(
        (reference_runs["obs_dir"] / "metrics.jsonl").read_text().splitlines())
    prom = (tmp_path / "metrics.prom").read_text()
    assert "serve_mesh_failovers_total" in prom and "train_epoch_seconds" in prom
    assert all(ln.startswith("#") or re.match(r"^[a-z_]+(\{.*\})? \S+$", ln)
               for ln in prom.splitlines() if ln)
    trace = json.loads((tmp_path / "trace.json").read_text())
    ref_trace = json.loads((reference_runs["obs_dir"] / "trace.json").read_text())
    assert len(trace["traceEvents"]) == len(ref_trace["traceEvents"]) == out["n_trace_events"]
    assert sorted({e["name"] for e in trace["traceEvents"]}) == sorted(
        {e["name"] for e in ref_trace["traceEvents"]})
