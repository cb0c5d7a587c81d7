"""iCD-MFSI's field layer (``kernels/mfsi_layer``): the plain form
(``ref.field_layer_ref``, the CPU path of ``mfsi.epoch``) against
``mfsi._field_layer_update``, the padded epoch's layer, bit for bit; and on
the card the hand-written kernels against the plain form and the flat epoch
against the CPU's. This module imports no JAX, so its ``gpu`` tests run on a
machine with a card and no JAX: ``pytest -m gpu tests/test_torch_mfsi_layer.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import design
from repro_torch.core.models import mfsi
from repro_torch.kernels.mfsi_layer import ops
from repro_torch.sparse.interactions import build_interactions

ALPHA0 = 0.3
# float32 sums by atomics against the same sums in index order: a few
# ulps of the largest partial sum, not of the result
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _design(n_rows, fields, seed, dev, zero_share=0.3):
    """A design of ``fields`` — (name, vocab, bag) — with weights 1 on
    one-hot fields and 1/bag on bags, a ``zero_share`` of bag slots
    empty (weight 0)."""
    rng = np.random.default_rng(seed)
    specs = []
    for name, vocab, bag in fields:
        if bag == 1:
            specs.append(dict(name=name, vocab=vocab, ids=rng.integers(0, vocab, n_rows)))
            continue
        ids = np.stack([rng.choice(vocab, bag, replace=False) for _ in range(n_rows)])
        w = np.where(rng.random((n_rows, bag)) < zero_share, 0.0, 1.0 / bag).astype(np.float32)
        specs.append(dict(name=name, vocab=vocab, ids=ids, weights=w))
    return design.make_design(specs, n_rows, device=dev)


def _caches(n_rows, p, k, f, seed, dev):
    """The table and Φ (p, k) and (n_rows, k), whose column f the layer
    moves (strided views), and the caches q, r, p2 and jff."""
    g = torch.Generator().manual_seed(seed)
    table, phi_m = torch.randn((p, k), generator=g), torch.randn((n_rows, k), generator=g)
    q, r = torch.randn((2, n_rows), generator=g)
    p2 = torch.rand(n_rows, generator=g) * 3
    jff = torch.rand((k, k), generator=g) + 0.5
    return [t.to(dev) for t in (table, phi_m, q, r, p2, jff)]


FIELDS = [("user", 300, 1), ("age", 5, 1), ("hist", 90, 6)]


@pytest.mark.parametrize("l2", [0.0, 0.05])
@pytest.mark.parametrize("mode", ["jacobi", "slot"])
def test_plain_form_is_the_padded_epochs_layer_bit_for_bit(l2, mode):
    """Each layer of a design with a one-hot field, a small one and a bag
    (a Jacobi layer, or one layer a slot): the plain form, in place, against
    ``mfsi._field_layer_update``, which returns new tensors. The bag's last
    ids have no entry, so at λ = 0 their denominators are clamped."""
    n_rows, k, f = 300, 4, 2
    x = _design(n_rows, FIELDS, 3, "cpu")
    hp = mfsi.MFSIHyperParams(k=k, alpha0=ALPHA0, l2=l2, multi_hot_mode=mode)
    raw = mfsi._field_layers(x, hp)
    layers, _ = ops.prepare(raw, n_rows)
    assert [lay.identity for lay in layers] == [len(r[2]) == n_rows for r in raw]
    table, phi_m, q, r, p2, jff = _caches(n_rows, x.p, k, f, 5, "cpu")
    for (ids_g, xw, rows, vocab, offset, eta), layer in zip(raw, layers):
        want = mfsi._field_layer_update(table[:, f], phi_m[:, f], q, r, p2, jff[f, f], ids_g,
                                        xw, rows, vocab, offset, hp, eta)
        q, r = q.clone(), r.clone()
        dphi = ops.field_layer(layer, table[:, f], phi_m[:, f], q, r, p2, jff[f, f], None,
                               alpha0=ALPHA0, l2=l2)
        for got, w in zip((table[:, f], phi_m[:, f], q, r, dphi), want):
            assert torch.equal(got, w)


def test_prepare_counts_the_squared_weights_and_sizes_the_scratch():
    n_rows = 300
    x = _design(n_rows, FIELDS, 4, "cpu")
    hp = mfsi.MFSIHyperParams(k=2)
    layers, scratch = ops.prepare(mfsi._field_layers(x, hp), n_rows)
    assert [(lay.vocab, lay.offset, lay.identity) for lay in layers] == \
        [(300, 0, True), (5, 300, True), (90, 305, False)]
    assert [lay.eta for lay in layers] == [hp.eta, hp.eta, hp.jacobi_eta]
    bag = x.fields[2]
    want = torch.zeros(90).index_add_(0, bag.ids.reshape(-1), bag.weights.reshape(-1) ** 2)
    assert torch.equal(layers[2].cnt, want)
    assert scratch.sums.shape == (900,) and scratch.delta.shape == (300,)
    assert scratch.acc.shape == scratch.dphi.shape == (n_rows,)
    one_hot, s1 = ops.prepare(mfsi._field_layers(x, hp)[:2], n_rows)
    assert s1.acc is None and all(lay.identity for lay in one_hot)


def test_prepare_refuses_ids_that_are_not_int64():
    ids = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        ops.prepare([(ids, torch.ones(4), torch.arange(4), 4, 0, 1.0)], 4)


@pytest.mark.gpu
@pytest.mark.parametrize("fields,n_rows", [
    ([("user", 5000, 1)], 5000),                       # one-hot, sums in device memory
    ([("age", 8, 1), ("gender", 3, 1)], 20000),        # few features: shared-memory sums
    ([("country", 1024, 1), ("dev", 1025, 1)], 7000),  # either side of the shared limit
    ([("hist", 2000, 10)], 3000),                      # a Jacobi bag: scattered by row
])
@pytest.mark.parametrize("l2", [0.0, 0.1])
def test_kernels_match_the_plain_form_on_cuda(cuda, fields, n_rows, l2):
    """Every layer in turn, on strided columns of a (p, 8) table and an
    (n_rows, 8) Φ: the kernels against the plain form on the CPU, and the
    scratch's sums and row sums zero again after each layer."""
    k, f = 8, 5
    hp = mfsi.MFSIHyperParams(k=k, alpha0=ALPHA0, l2=l2)
    out = {}
    for where in ("cpu", cuda):
        x = _design(n_rows, fields, 11, where)
        layers, scratch = ops.prepare(mfsi._field_layers(x, hp), n_rows)
        table, phi_m, q, r, p2, jff = _caches(n_rows, x.p, k, f, 12, where)
        before = ops.field_layer.launches
        dphis = []
        for layer in layers:
            dphi = ops.field_layer(layer, table[:, f], phi_m[:, f], q, r, p2, jff[f, f],
                                   scratch, alpha0=ALPHA0, l2=l2)
            dphis.append(dphi.cpu().clone())
            if where != "cpu":
                assert not scratch.sums.any()
                assert scratch.acc is None or not scratch.acc.any()
        launched = ops.field_layer.launches - before
        if where == "cpu":
            assert launched == 0
        else:
            assert launched == sum(3 + (not lay.identity) for lay in layers)
        out[str(where)] = [t.cpu() for t in (table, phi_m, q, r, *dphis)]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_kernels_refuse_a_cache_of_the_wrong_length(cuda):
    x = _design(50, [("user", 50, 1)], 2, cuda)
    layers, scratch = ops.prepare(mfsi._field_layers(x, mfsi.MFSIHyperParams(k=2)), 50)
    table, phi_m, q, r, p2, jff = _caches(50, x.p, 2, 0, 3, cuda)
    with pytest.raises(ValueError, match="n_rows"):
        ops.field_layer(layers[0], table[:, 0], phi_m[:, 0], q, r[:40], p2, jff[0, 0],
                        scratch, alpha0=ALPHA0, l2=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["jacobi", "slot"])
def test_flat_epoch_on_cuda_matches_cpu(cuda, mode):
    """Two flat MFSI epochs on the card, the field layers through the
    kernels (3 launches a one-hot layer, 4 a Jacobi bag's, a layer a side
    and dimension), against the same epochs on the CPU: the sums' order
    alone differs (rtol 1e-4, atol 1e-5; e atol 5e-5)."""
    rng = np.random.default_rng(9)
    n_ctx, n_items, nnz, k = 400, 150, 6000, 6
    hp = mfsi.MFSIHyperParams(k=k, alpha0=ALPHA0, l2=0.05, multi_hot_mode=mode)
    cells = rng.choice(n_ctx * n_items, size=nnz, replace=False)
    y, alpha = rng.integers(1, 4, nnz).astype(np.float64), 1.3 + rng.random(nnz)
    out = {}
    for where in ("cpu", cuda):
        x = _design(n_ctx, [("user", n_ctx, 1), ("age", 6, 1), ("hist", n_items, 5)], 21, where)
        z = _design(n_items, [("item", n_items, 1), ("genre", 7, 1)], 22, where)
        data = build_interactions(cells // n_items, cells % n_items, y, alpha, n_ctx, n_items,
                                  alpha0=ALPHA0, device=where)
        if not out:
            w0 = (0.1 * rng.normal(size=(x.p, k))).astype(np.float32)
            h0 = (0.1 * rng.normal(size=(z.p, k))).astype(np.float32)
        p = mfsi.params_from_numpy(w0, h0, device=where)
        e = mfsi.residuals(p, x, z, data)
        before = ops.field_layer.launches
        for _ in range(2):
            p, e = mfsi.epoch(p, x, z, data, e, hp)
        per_dim = (3 + 3 + (4 if mode == "jacobi" else 3 * 5)) + 3 + 3
        assert ops.field_layer.launches - before == (0 if where == "cpu" else 2 * k * per_dim)
        out[str(where)] = [t.cpu() for t in (*p, e)]
    for i, (a, b) in enumerate(zip(out[str(cuda)], out["cpu"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=5e-5 if i == 2 else 1e-5)
