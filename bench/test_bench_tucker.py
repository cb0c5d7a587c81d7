"""CPU tests of the Tucker cell (``tucker-train-youtube-hourly``) at the toy
size, through the kernels' plain versions: the result line and its
agreement with the float64 reference, ``correct`` under planted faults and
under the control, the hours' law, the cost count by hand and the span
metrics' readers. The toy sizes are ``conftest.py``'s."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench.costs import kernels, tensor
from bench.harness import cell as harness
from bench.harness import hours, spec
from bench.harness.spec import load_module
from bench.tools import control_hours, toy

SEED = 2**31 + 7
NAME = "tucker-train-youtube-hourly-toy"


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_tucker")
    toy.make(root)
    return root


def _run(root, trace=False, wrap=None, seed=SEED):
    return harness.run_cell(NAME, seed=seed, seconds=0.2, trace=trace, device="cpu",
                            root=root, wrap=wrap)


@pytest.mark.parametrize("trace", [False, True])
def test_the_toy_cell_runs_and_agrees_with_the_reference(toy_root, trace):
    line = json.loads(json.dumps(_run(toy_root, trace)))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    cell = spec.Cell(NAME, toy_root)
    asked = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:  # no kernel and no peak on the CPU: the device's numbers read nothing
        assert line["metrics"] == {}
        assert {"core_sweep_ms.tucker", "tensor_train_mfu"} <= asked
    else:
        assert set(line["metrics"]) == asked == {"setup_s", "factor_train_nnz_per_s"}
    # float32 against float64 after 3 epochs at toy size: rounding alone
    assert all(c["value"] < 1e-5 for c in line["checks"].values()), line["checks"]


def test_a_traced_toy_run_carries_the_span_passes(toy_root):
    seen = {}

    def keep(prog):
        seen["prog"] = prog

    cell = spec.Cell(NAME, toy_root)
    out = cell.driver().run(cell, seed=SEED, seconds=0.1, trace=True,
                            device=torch.device("cpu"), t_start=0.0,
                            note=lambda msg: None, wrap=keep)
    p = out["spans"]
    assert p["epochs"] == cell.workload["trace_epochs"]
    assert p["host"]["tucker.core"]["calls"] == p["epochs"]
    assert p["host"]["tucker.mode"]["calls"] == 2 * p["epochs"]
    assert out["counters"]["pairs"] == seen["prog"].tc.n_ctx
    assert out["counters"]["core_steps"] == 3 * 2 * 4


def _frozen(prog):
    prog.step = lambda weights=None: None


def _half(prog):
    step, w = prog.step, torch.ones(prog.nnz)
    w[1::2] = 0.0
    prog.step = lambda weights=None: step(weights=w)


@pytest.mark.parametrize("fault", [_frozen, _half], ids=["unchanged", "half"])
def test_a_broken_step_is_not_correct(toy_root, fault):
    result = _run(toy_root, wrap=fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_the_control_is_not_correct(toy_root):
    """The reference in the program's place, in float32 with TF32
    products, or frozen, fails the cell's limits; in float32 with TF32 off
    it reads as the program does."""
    cell = spec.Cell(NAME, toy_root)
    limits = cell.workload["checks"]
    got = control_hours.readings(cell, SEED, ["control", "frozen", "fp32"],
                                 torch.device("cpu"))
    for kind in ("control", "frozen"):
        numbers = got[kind][0]
        assert any(numbers[k] > limits[k] for k in limits), (kind, numbers)
    assert all(got["fp32"][0][k] <= limits[k] for k in limits), got["fp32"][0]


def test_the_hours_keep_to_their_law():
    n_users, nnz, n_buckets, sigma = 3000, 300_000, 24, 3.0
    rng = np.random.default_rng(5)
    inputs = SimpleNamespace(n_ctx=n_users, nnz=nnz, ctx=np.sort(rng.integers(0, n_users, nnz)))
    law = {"seed": 11, "sigma": sigma}
    got = hours.draw(inputs, n_buckets, law)
    assert np.array_equal(got, hours.draw(inputs, n_buckets, law))   # seeded by the law
    assert got.min() >= 0 and got.max() < n_buckets
    home = np.random.default_rng(11).integers(0, n_buckets, n_users)
    # each hour is its user's home hour plus a rounded N(0, σ²) offset, mod 24
    off = (got - home[inputs.ctx] + n_buckets // 2) % n_buckets - n_buckets // 2
    assert abs(off.mean()) < 0.02 and off.std() == pytest.approx(sigma, rel=0.02)
    assert np.all(off == np.rint(off))
    # home hours uniform over the buckets: each within 25% of its share
    counts = np.bincount(home, minlength=n_buckets)
    assert counts.min() > 0.75 * n_users / n_buckets
    assert counts.max() < 1.25 * n_users / n_buckets


def test_hours_are_added_only_where_the_mix_has_a_law(toy_root):
    cell = spec.Cell(NAME, toy_root)
    a = hours.make_inputs(cell.config, cell.traffic, SEED, torch.device("cpu"))
    assert isinstance(a, hours.HourlyInputs) and a.hour.shape == (a.nnz,)
    assert a.n_buckets == cell.config["n_buckets"]
    plain = dict(cell.traffic)
    del plain["hours"]
    b = hours.make_inputs(cell.config, plain, SEED, torch.device("cpu"))
    assert not isinstance(b, hours.HourlyInputs)
    assert np.array_equal(a.ctx, b.ctx) and np.array_equal(a.item, b.item)


def test_tucker_counts_by_hand():
    cfg = dict(k1=2, k2=1, k3=3, n_ctx=3, n_buckets=2, n_items=5)
    n, p = 7, 4
    phi = 4 * 2 * 1 * (1 + 6) + kernels.gram(5, 3)[0] + kernels.gram(4, 3)[0]
    u_col = 4 * (2 * 1 * 3 + 36 + 18) + 7 * (6 + 8) + 10 * 3      # k1 = 2 of them
    v_col = 4 * (2 * 2 * 3 + 36 + 18) + 7 * (6 + 8) + 10 * 2      # k2 = 1
    core = 7 * 9 + 4 * (6 + 5) + 6 + 10                            # 6 coordinates
    item = 7 * 8 + 5 * (6 + 10)                                    # k3 = 3 columns
    want = phi + 2 * u_col + v_col + 6 * core + 3 * item
    assert tensor.tucker_epoch_flops(n, p, cfg) == want


def _reader(name):
    return load_module(spec.ROOT / "bench/metrics" / f"{name}.py", name.replace(".", "_"))


def test_the_span_readers_read_the_passes_or_nothing():
    incl = {"tucker.core": {"device_s": 3.0, "launches": 70_000, "idle_s": 0.1},
            "tucker.mode": {"device_s": 0.2, "launches": 900, "idle_s": 0.0}}
    m = {"model": "tucker", "spans": {"epochs": 2, "device": {"inclusive": incl}}}
    assert _reader("core_sweep_ms.tucker").read(m) == pytest.approx(1500.0)
    assert _reader("mode_sweep_ms.tucker").read(m) == pytest.approx(100.0)
    # a port without the spans, a run without the passes, another model
    for other in ({"model": "tucker", "spans": {"epochs": 2, "device": {"inclusive": {}}}},
                  {"model": "tucker", "spans": None}, {"model": "tucker"},
                  dict(m, model="mf")):
        assert _reader("core_sweep_ms.tucker").read(other) is None
        assert _reader("mode_sweep_ms.tucker").read(other) is None
    tr = {"launches": 140_000, "steps": 2, "busy_s": 6.0, "window_s": 7.0}
    m = {"model": "tucker", "trace": tr, "epochs": 3, "window_s": 10.5}
    assert _reader("launches_per_epoch.tucker").read(m) == 70_000
    assert _reader("device_idle_share.tensor_train").read(m) == pytest.approx(100 / 7)
    assert _reader("launches_per_epoch.tucker").read(dict(m, model="fm")) is None
    cfg = dict(k1=2, k2=1, k3=3, n_ctx=3, n_buckets=2, n_items=5)
    run = {"model": "tucker", "device_kind": "NVIDIA H100 80GB HBM3", "nnz": 7,
           "counters": {"pairs": 4}, "config": cfg, "epochs": 2, "window_s": 1.0}
    flops = tensor.tucker_epoch_flops(7, 4, cfg)
    assert _reader("tensor_train_mfu").read(run) == pytest.approx(100 * 2 * flops / 67e12)
    assert _reader("tensor_train_mfu").read(dict(run, device_kind="cpu")) is None
