"""CPU tests of the yardstick: the cost counts against hand counts at toy
shapes, the trace reader on a made-up trace, and the metric readers on
what they find or do not find."""
import json
from pathlib import Path

import pytest

from bench.costs import bound_s, epochs, kernels, peaks
from bench.harness import profile
from bench.harness.spec import load_module

ROOT = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"


def test_kernel_counts_by_hand():
    # Gram of (5, 3): 6 distinct entries, 5 multiply-adds each; 15 + 9 floats
    assert kernels.gram(5, 3) == (60, 4 * 24)
    # sweep block: 7 slots, 4 rows, 6 source rows, k_b 2:
    # 8·2·7 + 4·(10·2 + 2·1) FLOPs; 4·(4·7 + 6·2 + 3·4·2 + 4) bytes
    assert kernels.sweep_block(7, 4, 6, 2) == (112 + 88, 4 * (28 + 12 + 24 + 4))
    # slab reduce, m 3: (1 + 9 + 12) a slot; id, α, e a slot, slab, q and P
    assert kernels.slab_reduce(7, 4, 6, 3) == (7 * 22, 4 * (21 + 18 + 4 * 12))
    assert kernels.resid_patch(7, 4, 6, 3) == (42, 4 * (21 + 18 + 12))
    assert kernels.matmul(4, 3, 2) == (48, 4 * (12 + 6 + 8))


def test_epoch_counts_by_hand():
    cfg = dict(n_ctx=4, n_items=6, k=3, block_k=2)  # blocks of 2 and 1
    sweeps = [kernels.sweep_block(7, n, o, kb) for n, o in ((4, 6), (6, 4)) for kb in (2, 1)]
    assert epochs.mf_sweeps(7, cfg) == (sum(f for f, _ in sweeps), sum(b for _, b in sweeps))
    extra = (kernels.gram(6, 3)[0] + kernels.gram(4, 3)[0]
             + 2 * 4 * 3 * 3 + 2 * 6 * 3 * 3)  # Grams and the R' products
    assert epochs.mf_epoch_flops(7, cfg) == sum(f for f, _ in sweeps) + extra
    fm = dict(cfg, p_ctx=9, p_item=6, multi_hot_mode="jacobi", bag_fields=["hist"],
              context_fields=[["user", 4], ["hist", 5]], item_fields=[["video", 6]])
    slabs = [f(7, n, o, kb + 1) for n, o in ((4, 6), (6, 4)) for kb in (2, 1)
             for f in (kernels.slab_reduce, kernels.resid_patch)]
    assert epochs.fm_slabs(7, fm) == (sum(f for f, _ in slabs), sum(b for _, b in slabs))
    assert epochs.fm_layers(fm, 2) == [[(4, 4), (8, 5)], [(6, 6)]]
    # context side (n 4, 12 entries, p 9), item side (n 6, 6 entries, p 6), D = 5
    ctx = (2 * 3 * 12 + 2 * 3 * 9 + 36 + kernels.gram(6, 5)[0] + 3 * 2 * 2 * 4 * 5
           + 3 * (36 * 4 + 8 * 4 + 64 + 36 * 8 + 8 * 5 + 64) + 4 * 4 * 1
           + (12 * 4 + 8 * 4 + 16 + 12 * 8 + 8 * 5 + 16) + 6 * 4)
    item = (2 * 3 * 6 + 2 * 3 * 6 + 18 + kernels.gram(4, 5)[0] + 3 * 2 * 2 * 6 * 5
            + 3 * (36 * 6 + 8 * 6 + 96) + 4 * 6 * 1 + (12 * 6 + 8 * 6 + 24))
    assert epochs.fm_epoch_flops(7, fm, 2) == sum(f for f, _ in slabs) + ctx + item
    fm["multi_hot_mode"] = "slot"
    with pytest.raises(ValueError):
        epochs.fm_layers(fm, 2)


def test_peaks_and_bound():
    peak = peaks(H100)
    assert peak == {"fp32_flops": 67e12, "bytes_per_s": 3.35e12}
    assert peaks("cpu") is None
    assert bound_s(67e12, 1.0, peak) == pytest.approx(1.0)
    assert bound_s(1.0, 6.7e12, peak) == pytest.approx(2.0)


def _trace():
    """Two ops launching three kernels; the device idles 5 µs before the
    second op's kernel and 10 µs before the third."""
    cpu = [{"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50,
            "args": {"External id": 1}},
           {"cat": "cpu_op", "name": "aten::index_add_", "ts": 60, "dur": 50,
            "args": {"External id": 2}}]
    dev = [{"cat": "kernel", "name": "gemm", "ts": 10, "dur": 20, "args": {"External id": 1}},
           {"cat": "kernel", "name": "indexFuncLargeIndex", "ts": 35, "dur": 10,
            "args": {"External id": 2}},
           {"cat": "gpu_memset", "name": "Memset", "ts": 40, "dur": 10, "args": {}},
           {"cat": "kernel", "name": "indexFuncLargeIndex", "ts": 60, "dur": 20,
            "args": {"External id": 2}}]
    return cpu + dev


def test_trace_summary():
    s = profile.summarize(_trace(), window_s=100e-6)
    assert s["launches"] == 3
    assert s["kernels"] == pytest.approx({"gemm": 20e-6, "indexFuncLargeIndex": 30e-6})
    assert s["op_device_s"] == pytest.approx({"aten::mm": 20e-6, "aten::index_add_": 30e-6})
    assert s["busy_s"] == pytest.approx(55e-6)  # [10, 30] ∪ [35, 50] ∪ [60, 80]
    assert s["idle_gaps"] == pytest.approx({"aten::index_add_": 15e-6})
    assert profile.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]


def _context(model, trace=None, kind=H100):
    cfg = json.loads((ROOT / "bench/configs" / f"icd-{model}.json").read_text())
    traffic = json.loads((ROOT / "bench/traffic/youtube.json").read_text())
    return {"model": model, "config": cfg, "traffic": traffic, "device_kind": kind,
            "setup_s": 30.0, "window_s": 10.0, "epochs": 5, "nnz": 19_980_000,
            "nnz_per_s": 1e7, "counters": {"nnz": 19_980_000}, "trace": trace}


def _reader(name):
    return load_module(ROOT / "bench/metrics" / f"{name}.py", f"reader_{name}")


@pytest.mark.parametrize("name", [m["name"] for m in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["per_layer"]])
def test_readers_report_nothing_where_nothing_was_read(name):
    """Without a trace, on a device the table lacks, or where the trace
    holds none of the metric's kernels, a device reader returns None:
    never 0 for a share."""
    reader = _reader(name)
    empty = {"kernels": {"vectorized_elementwise_kernel": 1e-3}, "op_device_s": {},
             "launches": 0, "busy_s": 0.0, "window_s": 1.0, "steps": 1, "idle_gaps": {}}
    for model in ("mf", "fm"):
        for ctx in (_context(model, empty), _context(model, None, "cpu")):
            value = reader.read(ctx)
            if value is not None:  # only the clock's readers
                assert name.startswith(("factor_train_mfu", "feature_train_mfu"))
                assert value > 0


def test_readers_at_the_cells_shapes():
    tr = {"kernels": {"void at::native::indexFuncLargeIndex<float>(x)": 0.3,
                      "gemv": 0.05},
          "op_device_s": {"aten::index_add_": 0.3, "aten::mm": 0.05}, "launches": 55_000,
          "busy_s": 1.2, "window_s": 3.0, "steps": 2, "idle_gaps": {}}
    mf, fm = _context("mf", tr), _context("fm", tr)
    assert _reader("segment_sum_ms.mf").read(mf) == pytest.approx(150.0)
    assert _reader("segment_sum_ms.fm").read(fm) == pytest.approx(150.0)
    assert _reader("segment_sum_ms.fm").read(mf) is None
    assert _reader("launches_per_epoch.fm").read(fm) == 27_500
    # 0.6 s busy a traced epoch against 2 s an epoch untraced (10 s, 5 epochs);
    # the traced window's own 1.5 s an epoch is not read
    assert _reader("device_idle_share.feature_train").read(fm) == pytest.approx(70.0)
    assert _reader("device_idle_share.factor_train").read(mf) == pytest.approx(70.0)
    assert _reader("device_idle_share.factor_train").read(fm) is None
    mfu = _reader("factor_train_mfu").read(mf)
    assert mfu == pytest.approx(100 * epochs.mf_epoch_flops(19_980_000, mf["config"])
                                * 5 / 10 / 67e12)
    assert 0 < mfu < 100 and _reader("factor_train_mfu").read(fm) is None
    fmu = _reader("feature_train_mfu").read(fm)
    assert fmu == pytest.approx(100 * epochs.fm_epoch_flops(19_980_000, fm["config"], 10)
                                * 5 / 10 / 67e12)
    assert 0 < fmu < 100 and _reader("feature_train_mfu").read(mf) is None
