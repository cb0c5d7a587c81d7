"""CPU tests of the span reader (``harness/spans.py``) and the span tool
(``tools/spans.py``): kernels and idle gaps on a hand-built trace, the
toy cells' passes, and a port without an installable tracer. The ``gpu``
test runs a cell with ``--trace 1`` and the span tool on the card, and
skips here."""
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench.harness import spans
from bench.tools import spans as tool
from bench.tools import toy

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 7


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7,
            "tid": tid, "args": args}


def _events():
    """A toy timeline: an epoch span holding a layer
    span holding a segment sum; ops launch kernels by External id, one by
    its runtime launch's correlation alone, one outside every span."""
    return [
        _x("user_annotation", "fm.epoch", 0, 100),
        _x("user_annotation", "fm.field_layer", 10, 50),
        _x("user_annotation", "segment_sum", 20, 10),
        _x("cpu_op", "aten::mul", 12, 2, **{"External id": 1}),
        _x("cpu_op", "aten::index_add_", 22, 3, **{"External id": 2}),
        _x("cpu_op", "aten::add", 40, 2, **{"External id": 3}),
        _x("cpu_op", "aten::add", 70, 2, **{"External id": 4}),
        _x("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=55),
        _x("cpu_op", "aten::fill_", 120, 2, **{"External id": 6}),
        _x("cpu_op", "aten::index_add_", 200, 2, tid=2, **{"External id": 8}),
        # device: (start, dur) µs on the stream
        _x("kernel", "k_mul", 100, 10, tid=99, **{"External id": 1}),
        _x("kernel", "k_index_add", 115, 20, tid=99, **{"External id": 2}),   # gap 5
        _x("kernel", "k_add", 135, 5, tid=99, **{"External id": 3}),
        _x("gpu_memset", "Memset", 150, 2, tid=99, **{"External id": 4}),     # gap 10
        _x("kernel", "k_raw", 160, 4, tid=99, correlation=55),                # gap 8
        _x("kernel", "k_fill", 170, 6, tid=99, **{"External id": 6}),         # gap 6
    ]


def test_kernels_and_gaps_go_to_the_innermost_span_of_their_launch():
    got = spans.attribute(_events())
    own, incl = got["self"], got["inclusive"]
    us = 1e-6
    assert own["fm.field_layer"]["device_s"] == pytest.approx(15 * us)   # mul + add
    assert own["segment_sum"]["device_s"] == pytest.approx(20 * us)
    assert own["fm.epoch"]["device_s"] == pytest.approx(4 * us)          # by correlation
    assert own[spans.NO_SPAN]["device_s"] == pytest.approx(6 * us)       # fill at 120 µs
    assert own["segment_sum"]["idle_s"] == pytest.approx(5 * us)
    assert own["fm.epoch"]["idle_s"] == pytest.approx(18 * us)           # memset, raw
    assert own[spans.NO_SPAN]["idle_s"] == pytest.approx(6 * us)
    assert incl["fm.field_layer"]["device_s"] == pytest.approx(35 * us)
    assert incl["fm.field_layer"]["idle_s"] == pytest.approx(5 * us)
    assert incl["fm.epoch"]["launches"] == 4 and own["segment_sum"]["launches"] == 1
    # the sums: device time by span is the kernels' total, idle the gaps'
    assert sum(v["device_s"] for v in own.values()) == pytest.approx(got["kernel_s"])
    assert got["kernel_s"] == pytest.approx(45 * us)
    assert sum(v["idle_s"] for v in own.values()) == pytest.approx(got["idle_s"])
    assert got["idle_s"] == pytest.approx(29 * us)
    assert got["calls"] == {"fm.epoch": 1, "fm.field_layer": 1, "segment_sum": 1}
    # the index_add_ on another thread is outside every span of that thread
    assert spans.outside(_events(), "aten::index_add_", "segment_sum") == 1


def test_the_metrics_read_the_passes():
    dev = spans.attribute(_events())
    host = {"fm.field_layer": {"calls": 2, "host_s": 0.004, "self_s": 0.003}}
    p = {"epochs": 2, "host": host, "device": dev}
    got = spans.metrics("fm", p)
    assert got["segment_sum_span_ms.fm"] == pytest.approx(1e3 * 20e-6 / 2)
    assert got["resid_patch_ms.fm"] is None                  # no fm.patch kernel
    assert got["field_layer_host_ms.fm"] == pytest.approx(2.0)
    assert got["field_layer_idle_share.fm"] == pytest.approx(100 * 5 / 29)
    assert spans.metrics("mf", None) == {"segment_sum_span_ms.mf": None,
                                         "resid_patch_ms.mf": None}
    assert len(spans.table(p)) == 1 + 4


def test_innermost_over_nested_and_apart_intervals():
    ivs = [(0, 100, 0), (10, 20, 1), (12, 15, 2), (30, 40, 3), (100, 120, 4)]
    pts = [(t, t) for t in (0, 11, 13, 15, 25, 35, 99, 100, 130)]
    got = dict(spans._innermost(ivs, pts))
    assert got == {0: (0,), 11: (0, 1), 13: (0, 1, 2), 15: (0, 1), 25: (0,),
                   35: (0, 3), 99: (0,), 100: (4,), 130: ()}


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy_spans")
    toy.make(root)
    return root


FIELDS = {"mf": {"segment_sum_span_ms.mf", "resid_patch_ms.mf"},
          "fm": {"segment_sum_span_ms.fm", "resid_patch_ms.fm", "field_layer_host_ms.fm",
                 "field_layer_idle_share.fm"}}


@pytest.mark.parametrize("model", ["mf", "fm"])
def test_the_span_tool_on_a_toy_cell(toy_root, model):
    out = tool.measure(f"{model}-train-youtube-toy", SEED, 1, device="cpu", root=toy_root,
                       note=lambda msg: None)
    assert set(out["metrics"]) == FIELDS[model]
    # no kernel runs on the CPU: the device's numbers read nothing, host time does
    for name, value in out["metrics"].items():
        assert (value is not None and value > 0) == (name == "field_layer_host_ms.fm"), name
    assert out["index_add_outside_segment_sum"] == 0 and out["kernel_s"] == 0.0
    assert out["host"][f"{model}.epoch"]["calls"] == 1
    assert out["pass_a_epoch_s"] > 0 and out["pass_b_window_s"] > 0


def test_a_port_without_an_installable_tracer_reads_nothing():
    @contextlib.contextmanager
    def none(profiler_ranges):
        yield None

    ran = []
    assert spans.passes(lambda: ran.append(1), 2, lambda: None, none) is None
    assert ran == []
    assert all(v is None for v in spans.metrics("fm", None).values())


@pytest.mark.gpu
def test_spans_of_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    args = ["--workload", "mf-train-youtube", "--seed", str(SEED)]
    proc = subprocess.run([sys.executable, str(ROOT / "bench/run.py"), *args,
                           "--seconds", "2", "--trace", "1"], capture_output=True,
                          text=True, timeout=1200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().split("\n")[-1])
    assert line["correct"] is True and "segment_sum_ms.mf" in line["metrics"]
    proc = subprocess.run([sys.executable, str(ROOT / "bench/tools/spans.py"), *args,
                           "--epochs", "1"], capture_output=True, text=True,
                          timeout=1200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().split("\n")[-1])
    assert out["index_add_outside_segment_sum"] == 0
    assert all(v is not None and v > 0 for v in out["metrics"].values()), out["metrics"]
    assert out["no_span_share"] < 1.0
    ratio = out["metrics"]["segment_sum_span_ms.mf"] / out["segment_sum_ms"]
    assert 0.97 < ratio < 1.03, (out["metrics"], out["segment_sum_ms"])
