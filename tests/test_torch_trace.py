"""The port's spans in its training epochs (``obs/trace``: ``installed``,
the module-level ``span``, profiler ranges) and the synchronised epoch
clock of ``obs/train``, on toy MF, FM, Tucker and MFSI problems on the CPU."""
import json
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import design
from repro_torch.core.models import ctxmf, fm, mf, mfsi, tucker
from repro_torch.obs import trace
from repro_torch.obs import train as obs_train
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.sparse import segment
from repro_torch.sparse.interactions import build_interactions

N_CTX, N_ITEMS, NNZ = 9, 7, 30


def _log(seed=0):
    rng = np.random.default_rng(seed)
    pairs = rng.choice(N_CTX * N_ITEMS, size=NNZ, replace=False)
    ctx, item = pairs // N_ITEMS, pairs % N_ITEMS
    y = rng.integers(1, 4, size=NNZ).astype(np.float64)
    alpha = 1.3 + rng.random(NNZ)
    return ctx, item, build_interactions(ctx, item, y, alpha, N_CTX, N_ITEMS,
                                         alpha0=0.3, device="cpu")


def _mf_epoch(k=3):
    _, _, data = _log()
    hp = mf.MFHyperParams(k=k, alpha0=0.3)
    params = mf.init(N_CTX, N_ITEMS, k, generator=torch.Generator().manual_seed(0))
    e = mf.residuals(params, data)
    return lambda: mf.epoch(params, data, e, hp)


def _designs():
    rng = np.random.default_rng(1)
    fields = [dict(name="user", ids=np.arange(N_CTX), vocab=N_CTX),
              dict(name="age", ids=rng.integers(0, 3, N_CTX), vocab=3),
              dict(name="hist", vocab=N_ITEMS, weights=np.full((N_CTX, 2), 0.5, np.float32),
                   ids=np.stack([rng.choice(N_ITEMS, 2, replace=False)
                                 for _ in range(N_CTX)]))]
    items = [dict(name="item_id", ids=np.arange(N_ITEMS), vocab=N_ITEMS)]
    return (design.make_design(fields, N_CTX, device="cpu"),
            design.make_design(items, N_ITEMS, device="cpu"))


def _fm_epoch(k=3):
    _, _, data = _log()
    x, z = _designs()
    hp = fm.FMHyperParams(k=k, alpha0=0.3)
    params = fm.init(x.p, z.p, k, generator=torch.Generator().manual_seed(0))
    e = fm.residuals(params, x, z, data, hp)
    return lambda: fm.epoch(params, x, z, data, e, hp)


def _tucker_epoch(k1=3, k2=2, k3=3):
    ctx, item, _ = _log()
    rng = np.random.default_rng(2)
    n_buckets = 4
    tc, pair = ctxmf.build_context(ctx, rng.integers(0, n_buckets, NNZ), N_CTX, n_buckets,
                                   device="cpu")
    y = rng.integers(1, 4, size=NNZ).astype(np.float64)
    data = build_interactions(pair, item, y, 1.3 + rng.random(NNZ), tc.n_ctx, N_ITEMS,
                              alpha0=0.3, device="cpu")
    hp = tucker.TuckerHyperParams(k1=k1, k2=k2, k3=k3, alpha0=0.3)
    params = tucker.init(N_CTX, n_buckets, N_ITEMS, k1, k2, k3,
                         generator=torch.Generator().manual_seed(0))
    e = tucker.residuals(params, tc, data)
    return lambda: tucker.epoch(params, tc, data, e, hp)


def _mfsi_epoch(k=3):
    _, _, data = _log()
    x, z = _designs()
    hp = mfsi.MFSIHyperParams(k=k, alpha0=0.3)
    params = mfsi.init(x.p, z.p, k, generator=torch.Generator().manual_seed(0))
    e = mfsi.residuals(params, x, z, data)
    return lambda: mfsi.epoch(params, x, z, data, e, hp)


EPOCHS = {"mf": _mf_epoch, "fm": _fm_epoch, "tucker": _tucker_epoch, "mfsi": _mfsi_epoch}
NAMES = {
    "mf": {"mf.epoch", "mf.patch", "segment_sum", "gram", "reorder"},
    "fm": {"fm.epoch", "fm.moments", "fm.field_layer", "fm.patch", "fm.bias",
           "segment_sum", "gram", "reorder"},
    "tucker": {"tucker.epoch", "tucker.mode", "tucker.core", "tucker.item",
               "mf.patch", "segment_sum", "gram", "reorder"},
    "mfsi": {"mfsi.epoch", "mfsi.moments", "mfsi.field_layer", "mfsi.patch",
             "segment_sum", "gram", "reorder"},
}
PARENTS = {  # span -> the names its parent may have
    "mf.patch": {"mf.epoch", "tucker.item"}, "gram": {"mf.epoch", "fm.epoch", "tucker.epoch", "tucker.item",
                                                      "mfsi.epoch"},
    "reorder": {"mf.epoch", "fm.epoch", "tucker.item", "mfsi.epoch"}, "fm.moments": {"fm.epoch"},
    "fm.field_layer": {"fm.epoch"}, "fm.patch": {"fm.epoch"}, "fm.bias": {"fm.epoch"},
    "segment_sum": {"mf.epoch", "fm.epoch", "fm.moments", "fm.field_layer", "fm.bias",
                    "tucker.mode", "tucker.item", "mfsi.epoch", "mfsi.moments",
                    "mfsi.field_layer"},
    "tucker.mode": {"tucker.epoch"}, "tucker.core": {"tucker.epoch"},
    "tucker.item": {"tucker.epoch"},
    "mfsi.moments": {"mfsi.epoch"}, "mfsi.field_layer": {"mfsi.epoch"},
    "mfsi.patch": {"mfsi.epoch"},
}


def _no_profiler(*args, **kwargs):
    raise AssertionError("record_function called with no tracer installed")


@pytest.mark.parametrize("model", ["mf", "fm", "tucker", "mfsi"])
def test_without_a_tracer_an_epoch_reaches_no_profiler_and_builds_no_span(model, monkeypatch):
    step = EPOCHS[model]()
    monkeypatch.setattr(torch.profiler, "record_function", _no_profiler)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _no_profiler)
    monkeypatch.setattr(trace, "Span", _no_profiler)
    assert trace._installed is None
    assert trace.span("segment_sum") is trace.span("fm.field_layer", side="ctx")
    step()


def _count_calls(fns, run):
    """Calls of the Python functions ``fns`` while ``run()`` runs."""
    codes = {fn.__code__ for fn in fns}
    n = [0]

    def prof(frame, event, arg):
        if event == "call" and frame.f_code in codes:
            n[0] += 1

    sys.setprofile(prof)
    try:
        run()
    finally:
        sys.setprofile(None)
    return n[0]


@pytest.mark.parametrize("model", ["mf", "fm", "tucker", "mfsi"])
def test_an_installed_tracer_gets_the_epochs_spans_with_their_parents(model):
    step = EPOCHS[model]()
    tracer = trace.Tracer()
    with trace.installed(tracer) as got:
        assert got is tracer and trace._installed is tracer
        calls = _count_calls((segment.segment_sum, segment.segment_sum_sorted), step)
    assert trace._installed is None
    by_id = {sp.span_id: sp for sp in tracer.spans}
    assert {sp.name for sp in tracer.spans} == NAMES[model]
    roots = [sp for sp in tracer.spans if sp.parent_id is None]
    assert [sp.name for sp in roots] == [f"{model}.epoch"]
    for sp in tracer.spans:
        assert sp.t1 is not None and sp.t1 >= sp.t0
        if sp.parent_id is not None:
            assert by_id[sp.parent_id].name in PARENTS[sp.name], sp
    assert calls > 0 and sum(sp.name == "segment_sum" for sp in tracer.spans) == calls
    if model == "tucker":
        modes = [sp for sp in tracer.spans if sp.name == "tucker.mode"]
        assert [sp.attrs["side"] for sp in modes] == ["u", "v"]
        assert [(sp.attrs["columns"], sp.attrs["passes"]) for sp in modes] == [(3, 4), (2, 3)]
        cores = [sp for sp in tracer.spans if sp.name == "tucker.core"]
        assert [sp.attrs["steps"] for sp in cores] == [3 * 2 * 3]
    if model == "fm":
        layers = [sp for sp in tracer.spans if sp.name == "fm.field_layer"]
        assert {sp.attrs["side"] for sp in layers} == {"ctx", "item"}
        assert {sp.attrs["dim"] for sp in layers} == {0, 1, 2, "linear"}
        assert all(isinstance(sp.attrs["offset"], int) for sp in layers)
    if model == "mfsi":
        layers = [sp for sp in tracer.spans if sp.name == "mfsi.field_layer"]
        # 3 dims × (3 context layers: user, age, the Jacobi bag; 1 item layer)
        assert [sp.attrs["side"] for sp in layers] == ["ctx"] * 9 + ["item"] * 3
        assert [sp.attrs["dim"] for sp in layers] == [0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 1, 2]
        assert [sp.attrs["offset"] for sp in layers[:3]] == [0, N_CTX, N_CTX + 3]
        assert sum(sp.name == "mfsi.patch" for sp in tracer.spans) == len(layers)
        assert sum(sp.name == "mfsi.moments" for sp in tracer.spans) == 2 * 3


@pytest.mark.parametrize("model", ["mf", "fm", "tucker", "mfsi"])
@pytest.mark.parametrize("ranges", [False, True])
def test_an_installed_tracer_leaves_the_epochs_bits_alone(model, ranges):
    """The same epoch with no tracer and with one installed (with or
    without profiler ranges) gives the same parameters and residuals, bit
    for bit."""
    step = EPOCHS[model]()
    plain = step()
    with trace.installed(trace.Tracer(profiler_ranges=ranges)) as tracer:
        traced = step()
    assert tracer.spans
    flat = [(a, b) for x, y in zip(plain, traced)
            for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)])]
    assert len(flat) >= 3
    for a, b in flat:
        assert torch.equal(a, b)


def test_installed_tracers_nest_and_come_back():
    outer, inner = trace.Tracer(), trace.Tracer()
    with trace.installed(outer):
        with trace.span("a", x=1):
            with trace.installed(inner):
                with trace.span("b"):
                    pass
            with trace.span("c"):
                pass
    assert trace._installed is None
    assert [(sp.name, sp.parent_id, sp.attrs) for sp in outer.spans] == [
        ("a", None, {"x": 1}), ("c", 0, {})]
    assert [(sp.name, sp.parent_id) for sp in inner.spans] == [("b", None)]


def test_a_span_ends_and_unwinds_when_its_block_raises():
    tracer = trace.Tracer(profiler_ranges=True)
    with pytest.raises(ValueError), trace.installed(tracer):
        with trace.span("outer"):
            with trace.span("inner"):
                raise ValueError("x")
    assert tracer.current is None and all(sp.t1 is not None for sp in tracer.spans)


@pytest.mark.parametrize("model", ["mf", "fm", "tucker", "mfsi"])
def test_profiler_ranges_hold_every_index_add(model, tmp_path):
    """Each ``aten::index_add_`` of an epoch lies inside a ``segment_sum``
    ``user_annotation`` of the profiler's trace, on its thread."""
    from torch.profiler import ProfilerActivity, profile

    step = EPOCHS[model]()
    with trace.installed(trace.Tracer(profiler_ranges=True)) as tracer, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(ev["pid"], ev["tid"], ev["ts"], ev["ts"] + ev["dur"]) for ev in events
              if ev.get("cat") == "user_annotation" and ev["name"] == "segment_sum"]
    ops = [ev for ev in events if ev.get("cat") == "cpu_op" and ev["name"] == "aten::index_add_"]
    assert ops and len(ranges) == sum(sp.name == "segment_sum" for sp in tracer.spans)
    for op in ops:
        assert any(p == op["pid"] and t == op["tid"] and s <= op["ts"] < e
                   for p, t, s, e in ranges), op
    names = {ev["name"] for ev in events if ev.get("cat") == "user_annotation"}
    assert names == NAMES[model]


def test_the_epoch_clock_reads_after_the_cuda_sync(monkeypatch):
    order = []
    monkeypatch.setattr(obs_train, "_cuda_device", lambda params: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: order.append("sync"))

    def clock():
        order.append("clock")
        return float(len(order))

    cb = obs_train.fit_metrics_callback(registry=MetricsRegistry(clock=clock), clock=clock)
    order.clear()
    cb(0, mf.MFParams(torch.zeros(2, 2), torch.zeros(3, 2)))
    cb(1, mf.MFParams(torch.zeros(2, 2), torch.zeros(3, 2)))
    assert order == ["sync", "clock", "sync", "clock"]
    assert [ep for ep, _, _ in cb.history] == [0, 1]


def test_the_epoch_clock_finds_the_params_cuda_device():
    cpu = torch.zeros(2)
    assert obs_train._cuda_device(mf.MFParams(cpu, cpu)) is None
    assert obs_train._cuda_device({"w": cpu, "b": None}) is None
    assert obs_train._cuda_device(cpu) is None
    if torch.cuda.is_available():
        cuda = torch.zeros(2, device="cuda")
        assert obs_train._cuda_device((None, cpu, cuda)) == cuda.device
