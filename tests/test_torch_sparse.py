"""The port's sparse helpers held against the JAX package on the same numpy
inputs: CSR construction, row ids and transpose array-equal; the neighbor
sampler's validity, self-loops and exact output on degree-1 rows (the two
packages' generators draw different numbers, so only what does not depend
on the draw is compared exactly); ``embedding_bag`` and
``multi_hot_lookup`` to rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import csr as jcsr
from repro.sparse import sampler as jsampler
from repro.sparse import segment as jsegment
from repro_torch.sparse import csr, sampler, segment

torch.set_num_threads(1)


def _coo(seed, n_rows=9, n_cols=7, nnz=30):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_rows, nnz), rng.integers(0, n_cols, nnz),
            rng.normal(size=nnz).astype(np.float32), n_rows, n_cols)


@pytest.mark.parametrize("seed,with_data", [(0, True), (1, False), (2, True)])
def test_csr_equals_reference(seed, with_data):
    row, col, data, n_rows, n_cols = _coo(seed)
    data = data if with_data else None
    got = csr.coo_to_csr(row, col, data, n_rows, n_cols, device="cpu")
    want = jcsr.coo_to_csr(row, col, data, n_rows, n_cols)
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    if with_data:
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    else:
        assert got.data is None
    assert (got.nnz, got.n_rows, got.n_cols) == (want.nnz, want.n_rows, want.n_cols)
    np.testing.assert_array_equal(got.row_degrees().numpy(),
                                  np.asarray(want.row_degrees()))
    np.testing.assert_array_equal(csr.csr_row_ids(got).numpy(),
                                  np.asarray(jcsr.csr_row_ids(want)))
    gt, wt = csr.transpose_csr_host(got), jcsr.transpose_csr_host(want)
    np.testing.assert_array_equal(gt.indptr.numpy(), np.asarray(wt.indptr))
    np.testing.assert_array_equal(gt.indices.numpy(), np.asarray(wt.indices))
    assert (gt.n_rows, gt.n_cols) == (n_cols, n_rows)
    assert got.with_data(torch.ones(got.nnz)).data.shape == (got.nnz,)


def test_csr_goes_to_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        assert csr.coo_to_csr([0], [1], None, 2, 2).indptr.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        csr.coo_to_csr([0], [1], None, 2, 2)


def test_adjacency_equals_reference():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 20, 60), rng.integers(0, 20, 60)
    for sym in (True, False):
        got = sampler.build_adjacency(src, dst, 20, sym, device="cpu")
        want = jsampler.build_adjacency(src, dst, 20, sym)
        np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_neighbor_sampler_validity():
    rng = np.random.default_rng(0)
    n_nodes = 50
    src, dst = rng.integers(0, n_nodes, 200), rng.integers(0, n_nodes, 200)
    adj = sampler.build_adjacency(src, dst, n_nodes, device="cpu")
    seeds = torch.arange(10)
    gen = torch.Generator().manual_seed(0)
    frontiers = sampler.neighbor_sampler(gen, adj, seeds, [5, 3])
    jfront = jsampler.neighbor_sampler(
        jax.random.PRNGKey(0), jsampler.build_adjacency(src, dst, n_nodes),
        jnp.arange(10, dtype=jnp.int32), [5, 3])
    assert [tuple(f.shape) for f in frontiers] == [tuple(f.shape) for f in jfront]
    indptr, indices = adj.indptr.numpy(), adj.indices.numpy()
    for h in (1, 2):
        parent = frontiers[h - 1].numpy()
        child = frontiers[h].numpy().reshape(len(parent), -1)
        for p, kids in zip(parent, child):
            nb = set(indices[indptr[p]:indptr[p + 1]].tolist()) or {p}
            assert set(kids.tolist()) <= nb


def test_sampler_self_loops_and_degree_one_rows_exact():
    """Isolated nodes (the last one too) sample themselves and a node of
    degree 1 samples its one neighbor: no draw changes these, so both
    packages give the same ids."""
    adj = csr.coo_to_csr(np.array([0, 1]), np.array([1, 2]), None, 4, 4,
                         device="cpu")           # nodes 2 and 3 isolated
    jadj = jcsr.coo_to_csr(np.array([0, 1]), np.array([1, 2]), None, 4, 4)
    seeds = np.array([0, 1, 2, 3, 3, 0])
    got = sampler.sample_neighbors(torch.Generator().manual_seed(3), adj,
                                   torch.as_tensor(seeds), 4)
    want = jsampler.sample_neighbors(jax.random.PRNGKey(3), jadj,
                                     jnp.asarray(seeds, jnp.int32), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.array(
        [[1] * 4, [2] * 4, [2] * 4, [3] * 4, [3] * 4, [1] * 4]))
    empty = csr.coo_to_csr(np.array([], np.int64), np.array([], np.int64),
                           None, 3, 3, device="cpu")
    np.testing.assert_array_equal(
        sampler.sample_neighbors(torch.Generator(), empty, torch.arange(3), 2).numpy(),
        [[0, 0], [1, 1], [2, 2]])


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_equals_reference(combiner, weighted):
    rng = np.random.default_rng(7)
    vocab, dim, nnz, n_rows = 13, 5, 40, 9
    table = rng.normal(size=(vocab, dim)).astype(np.float32)
    ids, rows = rng.integers(0, vocab, nnz), rng.integers(0, n_rows - 1, nnz)
    w = rng.uniform(0.5, 2.0, nnz).astype(np.float32) if weighted else None
    got = segment.embedding_bag(
        torch.as_tensor(table), torch.as_tensor(ids), torch.as_tensor(rows),
        n_rows, None if w is None else torch.as_tensor(w), combiner)
    want = jsegment.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids, jnp.int32),
        jnp.asarray(rows, jnp.int32), n_rows,
        None if w is None else jnp.asarray(w), combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        segment.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                              torch.as_tensor(rows), n_rows, combiner="median")


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_multi_hot_lookup_equals_reference(combiner, masked):
    rng = np.random.default_rng(8)
    table = rng.normal(size=(11, 4)).astype(np.float32)
    ids = rng.integers(0, 11, (6, 5))
    mask = rng.random((6, 5)) < 0.6 if masked else None
    if masked:
        mask[0] = False                          # an empty bag
    got = segment.multi_hot_lookup(
        torch.as_tensor(table), torch.as_tensor(ids),
        None if mask is None else torch.as_tensor(mask), combiner)
    want = jsegment.multi_hot_lookup(
        jnp.asarray(table), jnp.asarray(ids, jnp.int32),
        None if mask is None else jnp.asarray(mask), combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
