"""The port's data loader (``repro_torch.data.loader``) and its config
shapes, held against the JAX package from the same inputs: batches and
host slices array-equal (each package's own host count monkeypatched),
the synthetic fallback's cache file byte-identical, ``split_by_time`` and
``frequency_interactions`` array-equal (the confidence weights to rtol
1e-6: the two ``log1p`` may differ in the last bit)."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import loader as jloader
from repro.data.synthetic import make_implicit_dataset as jmake
from repro_torch import configs
from repro_torch.data import loader
from repro_torch.data.synthetic import make_implicit_dataset
from repro_torch.runtime import hosts

torch.set_num_threads(1)


def _set_hosts(monkeypatch, n_hosts, i):
    monkeypatch.setattr(jax, "process_count", lambda: n_hosts)
    monkeypatch.setattr(jax, "process_index", lambda: i)
    monkeypatch.setattr(hosts, "process_count", lambda: n_hosts)
    monkeypatch.setattr(hosts, "process_index", lambda: i)


def test_hosts_default_to_one_process():
    assert (hosts.process_index(), hosts.process_count()) == (0, 1)


@pytest.mark.parametrize("n_hosts,n", [(1, 10), (4, 10), (3, 7), (4, 3),
                                       (2, 64), (5, 5)])
def test_host_slices_equal_reference(monkeypatch, n_hosts, n):
    got, want = [], []
    for i in range(n_hosts):
        _set_hosts(monkeypatch, n_hosts, i)
        got.append(loader._host_slice(n))
        want.append(jloader._host_slice(n))
    assert got == want
    covered = np.concatenate([np.arange(n)[s] for s in got])
    np.testing.assert_array_equal(covered, np.arange(n))


@pytest.mark.parametrize("n_hosts", [1, 3])
@pytest.mark.parametrize("batch_events,start", [(64, 0), (50, 37)])
def test_interaction_stream_equals_reference(monkeypatch, n_hosts,
                                             batch_events, start):
    ds = make_implicit_dataset(n_users=30, n_items=20, seed=11)
    jds = jmake(n_users=30, n_items=20, seed=11)
    np.testing.assert_array_equal(ds.events, jds.events)
    for i in range(n_hosts):
        _set_hosts(monkeypatch, n_hosts, i)
        got = list(loader.interaction_stream(ds, batch_events=batch_events,
                                             start=start))
        want = list(jloader.interaction_stream(jds, batch_events=batch_events,
                                               start=start))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("n_hosts,i", [(1, 0), (4, 2)])
def test_sharded_batches_equal_reference(monkeypatch, n_hosts, i):
    _set_hosts(monkeypatch, n_hosts, i)

    def make_batch(rng, n):
        return {"x": rng.normal(size=(n, 3)), "id": rng.integers(0, 9, n)}

    got = loader.sharded_batches(make_batch, 10, seed=5)
    want = jloader.sharded_batches(make_batch, 10, seed=5)
    for _ in range(3):
        g, w = next(got), next(want)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


def test_synthetic_fallback_cache_file_byte_identical(tmp_path):
    kw = dict(n_users=30, n_items=25, seed=4)
    log = loader.load_movielens(cache_dir=str(tmp_path / "port"), **kw)
    jlog = jloader.load_movielens(cache_dir=str(tmp_path / "ref"), **kw)
    port_file = tmp_path / "port" / "ml-synth.data"
    assert port_file.read_bytes() == (tmp_path / "ref" / "ml-synth.data").read_bytes()
    for f in ("user", "item", "value", "t"):
        np.testing.assert_array_equal(getattr(log, f), getattr(jlog, f))
    assert (log.n_users, log.n_items) == (jlog.n_users, jlog.n_items)
    # a second load reads the cache, which REPRO_DATA_DIR also finds
    again = loader.load_movielens(cache_dir=str(tmp_path / "port"))
    np.testing.assert_array_equal(again.item, log.item)


def test_cache_dir_from_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    assert loader._cache_path(None) == jloader._cache_path(None) == str(
        tmp_path / "ml-synth.data")
    log = loader.load_movielens(n_users=12, n_items=10, seed=1)
    assert (tmp_path / "ml-synth.data").exists() and log.n_events > 0


@pytest.mark.parametrize("text", ["1\t5\t3\t100\n2\t5\t4\t50\n1\t9\t1\t75\n",
                                  "7 9 2\n3 9 1\n7 4 5\n"])
def test_parse_ratings_file_equals_reference(tmp_path, text):
    f = tmp_path / "u.data"
    f.write_text(text)
    got, want = loader.load_movielens(str(f)), jloader.load_movielens(str(f))
    for fld in ("user", "item", "value", "t"):
        np.testing.assert_array_equal(getattr(got, fld), getattr(want, fld))
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    with pytest.raises(FileNotFoundError):
        loader.load_movielens(str(tmp_path / "missing.data"))


@pytest.mark.parametrize("frac", [0.2, 0.5])
def test_split_by_time_equals_reference(tmp_path, frac):
    log = loader.load_movielens(cache_dir=str(tmp_path), n_users=30,
                                n_items=25, seed=5)
    jlog = jloader.load_movielens(cache_dir=str(tmp_path))
    for (g, w) in zip(loader.split_by_time(log, frac),
                      jloader.split_by_time(jlog, frac)):
        for fld in ("user", "item", "value", "t"):
            np.testing.assert_array_equal(getattr(g, fld), getattr(w, fld))
    with pytest.raises(ValueError):
        loader.split_by_time(log, 1.0)


@pytest.mark.parametrize("mode,beta", [("log", 1.0), ("linear", 0.5)])
def test_frequency_interactions_equal_reference(tmp_path, mode, beta):
    log = loader.load_movielens(cache_dir=str(tmp_path), n_users=25,
                                n_items=20, seed=6)
    # repeats, so counts above 1 exist
    log = loader.ImplicitLog(
        user=np.concatenate([log.user, log.user[:15]]),
        item=np.concatenate([log.item, log.item[:15]]),
        value=np.concatenate([log.value, log.value[:15]]),
        t=np.concatenate([log.t, log.t[:15]]),
        n_users=log.n_users, n_items=log.n_items)
    kw = dict(alpha0=0.5, base_alpha=2.0, beta=beta, mode=mode)
    data, weights, counts = loader.frequency_interactions(log, device="cpu", **kw)
    jdata, jweights, jcounts = jloader.frequency_interactions(log, **kw)
    for f in ("ctx", "item", "t_ctx", "t_item", "t_perm"):
        np.testing.assert_array_equal(getattr(data, f).numpy(),
                                      np.asarray(getattr(jdata, f)))
    for f in ("y", "alpha"):
        np.testing.assert_array_equal(getattr(data, f).numpy(),
                                      np.asarray(getattr(jdata, f)))
    assert (data.n_ctx, data.n_items) == (jdata.n_ctx, jdata.n_items)
    assert counts.max() > 1
    np.testing.assert_array_equal(counts, jcounts)
    assert weights.dtype == torch.float32 and weights.device.type == "cpu"
    np.testing.assert_allclose(weights.numpy(), jweights, rtol=1e-6, atol=0)


def test_frequency_interactions_go_to_cuda_unless_cpu_is_named(tmp_path):
    log = loader.load_movielens(cache_dir=str(tmp_path), n_users=8,
                                n_items=6, seed=2)
    if torch.cuda.is_available():
        assert loader.frequency_interactions(log)[1].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.frequency_interactions(log)


@pytest.mark.parametrize("arch", ["icd-mf", "icd-fm"])
def test_shapes_equal_reference(arch):
    got, want = configs.get_shapes(arch), jconfigs.get_shapes(arch)
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name], want[name]
        assert (g.name, g.kind, g.seq_len, g.global_batch, g.extras, g.skip) == (
            w.name, w.kind, w.seq_len, w.global_batch, w.extras, w.skip)
        assert g.extra("n_ctx", -1) == w.extra("n_ctx", -1)
