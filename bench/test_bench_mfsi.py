"""CPU tests of the MFSI cell (``mfsi-train-youtube``) at the toy size,
through the kernels' plain versions: the result line and its agreement
with the float64 reference, ``correct`` under planted faults and under the
control, the span passes, the cost count by hand and the metric readers.
The toy sizes are FM's (the root ``conftest.py``)."""
import json

import pytest
import torch

from bench.costs import kernels
from bench.costs import mfsi as costs
from bench.harness import cell as harness
from bench.harness import spec
from bench.harness.spec import load_module
from bench.tools import control, toy

SEED = 2**31 + 7
NAME = "mfsi-train-youtube-toy"
SPANS = {"mfsi.epoch", "mfsi.moments", "mfsi.field_layer", "mfsi.patch"}


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_mfsi")
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
        assert asked == {"field_layer_ms.mfsi", "resid_patch_ms.mfsi",
                         "launches_per_epoch.mfsi", "mfsi_train_mfu",
                         "device_idle_share.mfsi_train", "mfsi_layer_roofline"}
    else:
        assert set(line["metrics"]) == asked == {"setup_s", "feature_train_nnz_per_s"}
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
    n, k = p["epochs"], cell.config["k"]
    assert n == cell.workload["trace_epochs"]
    assert SPANS <= set(p["host"])
    layers = out["counters"]["field_layers_ctx"] + out["counters"]["field_layers_item"]
    # the toy's context fields: user, age, gender, previous video, the bag
    assert (out["counters"]["field_layers_ctx"], out["counters"]["field_layers_item"]) == (5, 1)
    assert p["host"]["mfsi.epoch"]["calls"] == n
    assert p["host"]["mfsi.moments"]["calls"] == 2 * k * n
    assert p["host"]["mfsi.field_layer"]["calls"] == k * layers * n
    assert p["host"]["mfsi.patch"]["calls"] == k * layers * n
    assert out["counters"]["p_ctx"] == seen["prog"].x.p == cell.config["p_ctx"]


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
    got = control.readings(cell, SEED, ["control", "frozen", "fp32"], torch.device("cpu"))
    for kind in ("control", "frozen"):
        numbers = got[kind][0]
        assert any(numbers[k] > limits[k] for k in limits), (kind, numbers)
    assert all(got["fp32"][0][k] <= limits[k] for k in limits), got["fp32"][0]


def test_mfsi_counts_by_hand():
    cfg = dict(n_ctx=4, n_items=6, k=3, multi_hot_mode="jacobi", bag_fields=["hist"],
               context_fields=[["user", 4], ["hist", 5]], item_fields=[["video", 6]])
    n = 7
    # context side: layers (4 entries, 4 features) and the bag (4 × 2, 5); item (6, 6)
    ctx = (2 * 3 * 12 + kernels.gram(6, 3)[0]
           + 3 * (2 * 4 * 3 + 6 * n + (11 * 4 + 12 * 4 + 5 * 4 + 2 * n)
                  + (11 * 8 + 12 * 5 + 5 * 4 + 2 * n)))
    item = (2 * 3 * 6 + kernels.gram(4, 3)[0]
            + 3 * (2 * 6 * 3 + 6 * n + (11 * 6 + 12 * 6 + 5 * 6 + 2 * n)))
    assert costs.mfsi_epoch_flops(n, cfg, 2) == ctx + item
    with pytest.raises(ValueError):
        costs.mfsi_epoch_flops(n, dict(cfg, multi_hot_mode="slot"), 2)
    # the field layers alone: user (4 entries, 4 rows, 4 features), the bag
    # (8 entries over 4 rows, 5 features), video (6, 6, 6); 3 columns
    flops = 3 * ((11 * 4 + 12 * 4 + 5 * 4) + (11 * 8 + 12 * 5 + 5 * 4)
                 + (11 * 6 + 12 * 6 + 5 * 6))
    nbytes = 3 * ((24 * 4 + 44 * 4 + 56 * 4) + (24 * 8 + 44 * 4 + 56 * 5 + 16 * 8 + 12 * 4)
                  + (24 * 6 + 44 * 6 + 56 * 6))
    assert costs.field_layer_cost(cfg, 2) == (flops, nbytes)


def _reader(name):
    return load_module(spec.ROOT / "bench/metrics" / f"{name}.py", name.replace(".", "_"))


def test_the_readers_read_their_numbers_or_nothing():
    incl = {"mfsi.field_layer": {"device_s": 0.6, "launches": 70_000, "idle_s": 0.1},
            "mfsi.patch": {"device_s": 0.5, "launches": 3_000, "idle_s": 0.0}}
    m = {"model": "mfsi", "spans": {"epochs": 2, "device": {"inclusive": incl}}}
    assert _reader("field_layer_ms.mfsi").read(m) == pytest.approx(300.0)
    assert _reader("resid_patch_ms.mfsi").read(m) == pytest.approx(250.0)
    # a port without the spans, a run without the passes, another model
    for other in ({"model": "mfsi", "spans": {"epochs": 2, "device": {"inclusive": {}}}},
                  {"model": "mfsi", "spans": None}, {"model": "mfsi"},
                  dict(m, model="fm")):
        assert _reader("field_layer_ms.mfsi").read(other) is None
        assert _reader("resid_patch_ms.mfsi").read(other) is None
    tr = {"launches": 90_000, "steps": 2, "busy_s": 1.2, "window_s": 1.5}
    m = {"model": "mfsi", "trace": tr, "epochs": 10, "window_s": 8.0}
    assert _reader("launches_per_epoch.mfsi").read(m) == 45_000
    cfg = dict(n_ctx=4, n_items=6, k=3, multi_hot_mode="jacobi", bag_fields=["hist"],
               context_fields=[["user", 4], ["hist", 5]], item_fields=[["video", 6]])
    spans = {"epochs": 2, "device": {"inclusive": {
        "mfsi.field_layer": {"device_s": 2e-6, "launches": 60, "idle_s": 0.0}}}}
    m_roof = {"model": "mfsi", "spans": spans, "config": cfg,
              "device_kind": "NVIDIA H100 80GB HBM3", "traffic": {"history_length": 2}}
    flops, nbytes = costs.field_layer_cost(cfg, 2)
    want = 100 * max(flops / 67e12, nbytes / 3.35e12) / 1e-6
    assert _reader("mfsi_layer_roofline").read(m_roof) == pytest.approx(want)
    for other in (dict(m_roof, device_kind="cpu"), dict(m_roof, model="fm"),
                  dict(m_roof, spans=None),
                  dict(m_roof, spans={"epochs": 2, "device": {"inclusive": {}}})):
        assert _reader("mfsi_layer_roofline").read(other) is None
    assert _reader("device_idle_share.mfsi_train").read(m) == pytest.approx(25.0)
    for name in ("launches_per_epoch.mfsi", "device_idle_share.mfsi_train"):
        assert _reader(name).read(dict(m, model="fm")) is None
    assert _reader("launches_per_epoch.mfsi").read(dict(m, trace=None)) is None
    cfg = dict(n_ctx=4, n_items=6, k=3, multi_hot_mode="jacobi", bag_fields=["hist"],
               context_fields=[["user", 4], ["hist", 5]], item_fields=[["video", 6]])
    run = {"model": "mfsi", "device_kind": "NVIDIA H100 80GB HBM3", "nnz": 7,
           "config": cfg, "traffic": {"history_length": 2}, "epochs": 2, "window_s": 1.0}
    flops = costs.mfsi_epoch_flops(7, cfg, 2)
    assert _reader("mfsi_train_mfu").read(run) == pytest.approx(100 * 2 * flops / 67e12)
    assert _reader("mfsi_train_mfu").read(dict(run, device_kind="cpu")) is None
    assert _reader("mfsi_train_mfu").read(dict(run, model="fm")) is None
    # and the readers of the other cells read nothing of an MFSI run
    fm_run = dict(run, trace=tr)
    assert _reader("feature_train_mfu").read(fm_run) is None
    assert _reader("launches_per_epoch.fm").read(fm_run) is None
    assert _reader("device_idle_share.feature_train").read(dict(fm_run, epochs=2)) is None
