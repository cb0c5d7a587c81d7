"""CPU tests of the harness: each cell at the smoke sizes through the
kernels' plain versions, the result line's keys, the reference against
the port, ``correct`` under planted faults and under the control, no
forbidden module in a run, and a new cell and metric added as new files
only. The ``gpu`` test runs a cell on the card and skips here."""
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench.harness import cell as harness
from bench.harness import spec
from bench.reference import common
from bench.tools import control, toy

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 7  # past 32 signed bits, as the driver's are
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    toy.make(root)
    return root


def _run(root, name, trace=False, wrap=None, seed=SEED):
    return harness.run_cell(name, seed=seed, seconds=0.2, trace=trace,
                            device="cpu", root=root, wrap=wrap)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", ["mf-train-youtube-toy", "fm-train-youtube-toy"])
def test_cell_line_has_the_contract_keys_and_agrees(toy_root, name, trace):
    result = _run(toy_root, name, trace)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert set(line) == set(KEYS) | {"checks"} | ({"breakdown"} if trace else set())
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    cell = spec.Cell(name, toy_root)
    asked = {m["name"]: m["unit"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert {k: v["unit"] for k, v in line["metrics"].items()}.items() <= asked.items()
    if not trace:  # the clock's metrics are there on the CPU too
        assert set(line["metrics"]) == set(asked)
        assert all(v["value"] > 0 for v in line["metrics"].values())
    # the port's epochs against the float64 reference, at toy size
    assert all(c["value"] < 1e-5 for c in line["checks"].values()), line["checks"]
    assert line["device"]["platform"] == "cpu"


def test_same_seed_same_inputs_and_every_seed_the_same_sizes(toy_root):
    from bench.harness import traffic

    cell = spec.Cell("fm-train-youtube-toy", toy_root)
    a, b = (traffic.make_inputs(cell.config, cell.traffic, SEED, torch.device("cpu"))
            for _ in range(2))
    c = traffic.make_inputs(cell.config, cell.traffic, SEED + 1, torch.device("cpu"))
    assert (a.ctx == b.ctx).all() and (a.item == b.item).all()
    assert all(torch.equal(a.factors[n], b.factors[n]) for n in a.factors)
    assert not (a.ctx == c.ctx).all() or not (a.item == c.item).all()
    assert a.nnz == c.nnz
    for x, y in ((a.ctx, c.ctx), (a.item, c.item)):  # the same degrees, relabelled
        assert sorted(torch.bincount(torch.as_tensor(x)).tolist()) == \
            sorted(torch.bincount(torch.as_tensor(y)).tolist())
    assert [f["name"] for f in a.ctx_fields] == [n for n, _ in cell.config["context_fields"]]


def _expected_log(n_ctx, n_items, law):
    """The law's expected interactions a user and share of users that hold
    the most popular item, summed over the degree's distribution."""
    import numpy as np

    p = np.arange(1, n_items + 1, dtype=np.float64) ** -law["popularity_exponent"]
    p /= p.sum()
    q = 1.0 / (1.0 + law["mean_excess"])
    draws = law["min_degree"] + np.arange(int(40 * law["mean_excess"]))
    pmf = q * (1 - q) ** (draws - law["min_degree"])
    held = -np.expm1(draws[:, None] * np.log1p(-p)[None, :])  # (draws, items)
    return float(pmf @ held.sum(axis=1)), float(pmf @ held[:, 0])


@pytest.mark.parametrize("min_degree, mean_excess", [(20, 30.0), (5, 12.0)])
def test_the_log_keeps_to_its_law(min_degree, mean_excess):
    from bench.harness import traffic

    law = {"base_seed": 11, "min_degree": min_degree, "mean_excess": mean_excess,
           "popularity_exponent": 0.6624}
    n_ctx, n_items = 4000, 1500
    ctx, item = traffic.draw_log(n_ctx, n_items, law, torch.device("cpu"))
    mean, top = _expected_log(n_ctx, n_items, law)
    assert len(ctx) / n_ctx == pytest.approx(mean, rel=0.03)
    # no pair twice, and duplicates only take a user below its floor by a few
    assert len(torch.unique(ctx * n_items + item)) == len(ctx)
    assert int(torch.bincount(ctx, minlength=n_ctx).min()) >= min_degree - 3
    held = torch.bincount(item, minlength=n_items).max().item() / n_ctx
    assert held == pytest.approx(top, abs=0.03)


def _frozen(prog):
    prog.step = lambda weights=None: None


def _half(prog):
    step, w = prog.step, torch.ones(prog.nnz)
    w[1::2] = 0.0
    prog.step = lambda weights=None: step(weights=w)


@pytest.mark.parametrize("fault", [_frozen, _half], ids=["unchanged", "half"])
@pytest.mark.parametrize("name", ["mf-train-youtube-toy", "fm-train-youtube-toy"])
def test_a_broken_step_is_not_correct(toy_root, name, fault):
    """The run as it is, the look for a card aside, with the timed path
    broken underneath: a step that returns its state unchanged, or one
    that leaves half of the interactions out."""
    result = _run(toy_root, name, wrap=fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("name", ["mf-train-youtube-toy", "fm-train-youtube-toy"])
def test_the_control_is_not_correct(toy_root, name):
    """The reference in the program's place, in float32 with TF32
    products, or frozen, fails the cell's limits; in float32 with TF32 off
    it reads as the program does."""
    cell = spec.Cell(name, toy_root)
    limits = cell.workload["checks"]
    got = control.readings(cell, SEED, ["control", "frozen", "fp32"], torch.device("cpu"))
    for kind in ("control", "frozen"):
        numbers = got[kind][0]
        assert any(numbers[k] > limits[k] for k in limits), (kind, numbers)
    assert all(got["fp32"][0][k] <= limits[k] for k in limits), got["fp32"][0]


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, -3.0 - 2**-12])
    assert common.tf32(x).tolist() == [1.0 + 2**-10, 1.0, -3.0]


def test_forbidden_names_are_compared_whole():
    found = harness.foreign_modules(["repro_torch", "repro_torch.core", "repro",
                                     "repro.core.models", "jax", "jaxlib.xla_client",
                                     "flax", "flaxen", "jaxtyping", "torch"])
    assert found == ["flax", "jax", "jaxlib.xla_client", "repro", "repro.core.models"]


IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|flax|repro|repro_torch)\b", re.M)


def test_reference_and_yardstick_import_nothing_of_the_port():
    files = [p for d in ("reference", "costs", "harness", "metrics")
             for p in (ROOT / "bench" / d).glob("*.py")]
    assert len(files) > 15
    offenders = {str(p.relative_to(ROOT)): m.group(0).strip()
                 for p in files for m in [IMPORT.search(p.read_text())] if m}
    assert offenders == {}
    # only models/ import the port, and nothing imports jax or the JAX package
    for p in (ROOT / "bench").rglob("*.py"):
        for m in IMPORT.finditer(p.read_text()):
            assert m.group(1) == "repro_torch" and p.parent.name == "models", (p, m.group(0))


def test_a_run_loads_no_forbidden_module(toy_root):
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from bench.harness import cell as h\n"
            "r = h.run_cell('fm-train-youtube-toy', seed=5, seconds=0.2, trace=True,"
            " device='cpu', root=sys.argv[2])\n"
            "import bench.reference.mf, bench.reference.fm\n"
            "print(r['correct'], h.foreign_modules())")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT / "src"), str(toy_root)],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "True []" in proc.stdout.splitlines()


def test_the_command_refuses_without_a_card_and_outside_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    args = ["--workload", "mf-train-youtube", "--seed", str(SEED), "--seconds", "1",
            "--trace", "0"]
    proc = subprocess.run([sys.executable, str(ROOT / "bench/run.py"), *args],
                          capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    # a directory that holds only BENCHMARK.json and the benchmark's paths
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "bench/run.py", *args], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and proc.stdout == ""


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_config_mix_and_metric_are_new_files_only(tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric,
    added as new files and new BENCHMARK.json entries, run with no file of
    the benchmark edited."""
    toy.make(tmp_path)
    before = _digests(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "bench/configs/icd-mf-toy.json").read_text())
    cfg.update(k=4, n_items=30)
    (tmp_path / "bench/configs/tiny-mf.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-mf", "source": "a test", "reduced": ["k"],
                             "file": "bench/configs/tiny-mf.json", "why": "a test"})
    mix = json.loads((tmp_path / "bench/traffic/youtube-toy.json").read_text())
    mix["log"]["min_degree"] = 2
    (tmp_path / "bench/traffic/sparse-toy.json").write_text(json.dumps(mix))
    wl = json.loads((tmp_path / "bench/workloads/mf-train-youtube-toy.json").read_text())
    (tmp_path / "bench/workloads/tiny-train.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": "tiny-train", "config": "tiny-mf",
                               "traffic": "sparse-toy", "chips": 1, "why": "a test"})
    (tmp_path / "bench/metrics/nnz_seen.tiny.py").write_text(
        "def read(m):\n    return float(m['nnz'] * m['epochs'])\n")
    bench["per_layer"].append({"name": "nnz_seen.tiny", "unit": "interactions",
                               "better": "higher", "source": "program_counter",
                               "layer": "a test", "moves": "factor_train_nnz_per_s",
                               "workloads": ["tiny-train"]})
    bench["end_to_end"][1]["workloads"].append("tiny-train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result = _run(tmp_path, "tiny-train", trace=True)
    assert result["correct"] is True
    assert result["metrics"]["nnz_seen.tiny"]["value"] > 0
    assert "segment_sum_ms.mf" not in result["metrics"]  # not asked of this cell
    line = _run(tmp_path, "tiny-train")
    assert set(line["metrics"]) == {"setup_s", "factor_train_nnz_per_s"}
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_benchmark_json_keeps_to_its_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"] and 1 <= bench["run_seconds"] <= 51
    assert (ROOT / bench["command"][1]).is_file()
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        names.add(c["name"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        cell = spec.Cell(w["name"], ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)
        assert (ROOT / "bench/traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "bench/metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert e2e["setup_s"]["bound"] <= 0.25
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_mf_cell_on_the_card(cuda):
    proc = subprocess.run([sys.executable, str(ROOT / "bench/run.py"), "--workload",
                           "mf-train-youtube", "--seed", str(SEED), "--seconds", "2",
                           "--trace", "0"], capture_output=True, text=True, timeout=1200,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().split("\n")[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
