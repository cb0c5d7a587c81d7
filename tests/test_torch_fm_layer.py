"""iCD-FM's embedding field layer (``kernels/fm_layer``): the plain form
(``ref.field_layer_ref``, the CPU path of ``fm.epoch``) against
``fm._embed_layer_update``, the padded epoch's layer, bit for bit; and on the
card the hand-written kernels against the plain form and the flat epoch
against the CPU's. This module imports no JAX, so its ``gpu`` tests run on a
machine with a card and no JAX: ``pytest -m gpu tests/test_torch_fm_layer.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import design
from repro_torch.core.models import fm, mfsi
from repro_torch.kernels.fm_layer import ops
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


def _design(n_rows, fields, seed, dev, zero_share=0.3, slot_ranges=False):
    """A design of ``fields`` — (name, vocab, bag) — with weights 1 on
    one-hot fields and 1/bag on bags, a ``zero_share`` of bag slots
    empty (weight 0). ``slot_ranges``: slot j of a bag draws from its own
    j-th of the vocabulary, so that a 'slot' layer holds every entry of
    its features and each of its steps is exact."""
    rng = np.random.default_rng(seed)
    specs = []
    for name, vocab, bag in fields:
        if bag == 1:
            specs.append(dict(name=name, vocab=vocab, ids=rng.integers(0, vocab, n_rows)))
            continue
        if slot_ranges:
            ids = np.arange(bag) * (vocab // bag) + rng.integers(0, vocab // bag, (n_rows, bag))
        else:
            ids = np.stack([rng.choice(vocab, bag, replace=False) for _ in range(n_rows)])
        w = np.where(rng.random((n_rows, bag)) < zero_share, 0.0, 1.0 / bag).astype(np.float32)
        specs.append(dict(name=name, vocab=vocab, ids=ids, weights=w))
    return design.make_design(specs, n_rows, device=dev)


def _state(n_rows, p, k, seed, dev):
    """The table (p, k) and Φe (n_rows, k + 2), whose columns the layer
    moves (strided views), the caches of a dimension and J (k + 2, k + 2).
    The moments and J are of real data's form (p1² ≤ p2·p0, J a Gram), so
    every Hessian is positive, as an epoch's are."""
    g = torch.Generator().manual_seed(seed)
    table, phi_e = torch.randn((p, k), generator=g), torch.randn((n_rows, k + 2), generator=g)
    q, u, r_a, r_b = torch.randn((4, n_rows), generator=g)
    p2, p0 = torch.rand((2, n_rows), generator=g) * 3
    p1 = (2 * torch.rand(n_rows, generator=g) - 1) * 0.9 * torch.sqrt(p2 * p0)
    m = torch.randn((k + 2, 3 * (k + 2)), generator=g)
    jm = m @ m.T / (3 * (k + 2)) + 0.1 * torch.eye(k + 2)
    return [t.to(dev) for t in (table, phi_e, q, u, r_a, r_b, p2, p1, p0, jm)]


def _call(layer, state, f, spec, scratch, l2):
    """One ``ops.field_layer`` call on ``state`` (moved in place)."""
    table, phi_e, q, u, r_a, r_b, p2, p1, p0, jm = state
    return ops.field_layer(layer, table[:, f], phi_e[:, f], phi_e[:, spec],
                           ops.Caches(q, u, r_a, r_b, p2, p1, p0),
                           (jm[f, f], jm[f, spec], jm[spec, spec]), scratch,
                           alpha0=ALPHA0, l2=l2)


FIELDS = [("user", 300, 1), ("age", 5, 1), ("hist", 90, 6)]


@pytest.mark.parametrize("l2", [0.0, 0.05])
@pytest.mark.parametrize("mode", ["jacobi", "slot"])
def test_plain_form_is_the_padded_epochs_layer_bit_for_bit(l2, mode):
    """Each layer of a design with a one-hot field, a small one and a bag
    (a Jacobi layer, or one layer a slot): the plain form, in place, against
    ``fm._embed_layer_update``, which returns new tensors. The bag's last
    ids have no entry, so at λ = 0 their denominators are clamped."""
    n_rows, k, f = 300, 4, 2
    spec = k
    x = _design(n_rows, FIELDS, 3, "cpu")
    hp = fm.FMHyperParams(k=k, alpha0=ALPHA0, l2=l2, multi_hot_mode=mode)
    raw = mfsi._field_layers(x, hp)
    layers, _ = ops.prepare(raw, n_rows)
    assert [lay.identity for lay in layers] == [len(r[2]) == n_rows for r in raw]
    state = _state(n_rows, x.p, k, 5, "cpu")
    table, phi_e, q, u, r_a, r_b, p2, p1, p0, jm = state
    for (ids_g, xw, rows, vocab, offset, eta), layer in zip(raw, layers):
        phi_want = phi_e.clone()
        want = fm._embed_layer_update(table[:, f], phi_want, q, u, r_a, r_b, p2, p1, p0,
                                      jm[f, f], jm[f, spec], jm[spec, spec], ids_g, xw, rows,
                                      vocab, offset, f, spec, hp, eta)
        dphi_f, dphi_s = _call(layer, state, f, spec, None, l2)
        got = (table[:, f], q, u, r_a, r_b, dphi_f, dphi_s)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert torch.equal(phi_e, phi_want)


def test_prepare_keeps_the_layers_and_sizes_the_scratch():
    n_rows = 300
    x = _design(n_rows, FIELDS, 4, "cpu")
    hp = fm.FMHyperParams(k=2)
    layers, scratch = ops.prepare(mfsi._field_layers(x, hp), n_rows)
    assert [(lay.vocab, lay.offset, lay.identity) for lay in layers] == \
        [(300, 0, True), (5, 300, True), (90, 305, False)]
    assert [lay.eta for lay in layers] == [hp.eta, hp.eta, hp.jacobi_eta]
    assert layers[2].ids.shape == (n_rows * 6,) and layers[2].ids.is_contiguous()
    assert scratch.sums.shape == (1200,) and not scratch.sums.any()
    assert scratch.step.shape == (600,)
    assert scratch.acc.shape == (2 * n_rows,) and not scratch.acc.any()
    assert scratch.dphi.shape == (2, n_rows)
    one_hot, s1 = ops.prepare(mfsi._field_layers(x, hp)[:2], n_rows)
    assert s1.acc is None and all(lay.identity for lay in one_hot)


@pytest.mark.parametrize("bad", ["ids", "rows", "xw", "length"])
def test_prepare_refuses_a_layer_of_the_wrong_types(bad):
    ids, xw, rows = torch.arange(4), torch.ones(4), torch.arange(4)
    ids = ids.int() if bad == "ids" else ids
    rows = rows.int() if bad == "rows" else rows
    xw = xw.double() if bad == "xw" else (xw[:3] if bad == "length" else xw)
    with pytest.raises(ValueError, match="int64 ids and rows and float32 weights"):
        ops.prepare([(ids, xw, rows, 4, 0, 1.0)], 4)


def test_flat_epoch_on_the_cpu_launches_nothing_and_takes_the_plain_form():
    """The CPU's flat epoch goes through the plain form (the counter stays),
    and the objective falls."""
    rng = np.random.default_rng(8)
    n_ctx, n_items, nnz, k = 120, 60, 1500, 3
    hp = fm.FMHyperParams(k=k, alpha0=ALPHA0, l2=0.05)
    x = _design(n_ctx, [("user", n_ctx, 1), ("age", 4, 1), ("hist", n_items, 4)], 1, "cpu")
    z = _design(n_items, [("item", n_items, 1)], 2, "cpu")
    cells = rng.choice(n_ctx * n_items, size=nnz, replace=False)
    data = build_interactions(cells // n_items, cells % n_items, np.ones(nnz),
                              1.0 + rng.random(nnz), n_ctx, n_items, alpha0=ALPHA0,
                              device="cpu")
    p = fm.init(x.p, z.p, k, generator=torch.Generator().manual_seed(3))
    before, obj0 = ops.field_layer.launches, float(fm.objective(p, x, z, data, hp))
    p, _ = fm.epoch(p, x, z, data, fm.residuals(p, x, z, data, hp), hp)
    assert ops.field_layer.launches == before
    assert float(fm.objective(p, x, z, data, hp)) < obj0


def _dup_bag_layer(n_rows, vocab, offset, bag, seed, dev):
    """A Jacobi layer whose rows repeat features, within a row too (drawn
    with replacement from a small vocabulary), a quarter of its weights 0."""
    rng = np.random.default_rng(seed)
    ids = offset + rng.integers(0, vocab, (n_rows, bag))
    w = np.where(rng.random((n_rows, bag)) < 0.25, 0.0, 1.0 / bag).astype(np.float32)
    rows = np.repeat(np.arange(n_rows), bag)
    return (torch.as_tensor(ids.reshape(-1), device=dev), torch.as_tensor(w.reshape(-1), device=dev),
            torch.as_tensor(rows, device=dev), vocab, offset, 0.5)


def _layers_of(case, n_rows, where):
    """(raw layers, p) of a kernel test case."""
    hp = fm.FMHyperParams(k=8)
    if case == "dup_bag":
        return [_dup_bag_layer(n_rows, 40, 0, 8, 13, where)], 40
    if case == "zero_and_empty":
        x = _design(n_rows, [("user", n_rows, 1)], 14, where)
        ids, xw, rows, vocab, offset, eta = mfsi._field_layers(x, hp)[0]
        xw = torch.where(torch.arange(n_rows, device=where) % 3 == 0, 0.0, xw)
        empty = (ids[:0] + vocab, xw[:0], rows[:0], 7, vocab, 0.5)
        return [(ids, xw, rows, vocab, offset, eta), empty], vocab + 7
    fields = {"one_hot": [("user", 5000, 1)],
              "small": [("age", 8, 1), ("gender", 3, 1)],
              "shared_limit": [("country", 1024, 1), ("dev", 1025, 1)],
              "bag": [("hist", 2000, 10)]}[case]
    x = _design(n_rows, fields, 11, where)
    return mfsi._field_layers(x, hp), x.p


@pytest.mark.gpu
@pytest.mark.parametrize("case,n_rows", [
    ("one_hot", 5000),         # one-hot identity layer, sums in device memory
    ("small", 20000),          # few features: shared-memory sums
    ("shared_limit", 7000),    # either side of the shared limit
    ("bag", 3000),             # a Jacobi bag: scattered by row
    ("dup_bag", 4000),         # a bag repeating features within and across rows
    ("zero_and_empty", 900),   # zero weights; a layer with no entries (a bag of none)
])
@pytest.mark.parametrize("l2", [0.0, 0.1])
def test_kernels_match_the_plain_form_on_cuda(cuda, case, n_rows, l2):
    """Every layer in turn, on strided columns of a (p, 8) table and an
    (n_rows, 10) Φe: the kernels against the plain form on the CPU, the
    scratch's sums and row sums zero again after each layer, and 3 launches
    a one-hot layer, 4 a bag's."""
    k, f = 8, 5
    out = {}
    for where in ("cpu", cuda):
        raw, p = _layers_of(case, n_rows, where)
        layers, scratch = ops.prepare(raw, n_rows)
        state = _state(n_rows, p, k, 12, where)
        before = ops.field_layer.launches
        dphis = []
        for layer in layers:
            dphis += [d.cpu().clone() for d in _call(layer, state, f, k, scratch, l2)]
            if where != "cpu":
                assert not scratch.sums.any()
                assert scratch.acc is None or not scratch.acc.any()
        launched = ops.field_layer.launches - before
        if where == "cpu":
            assert launched == 0
        else:
            assert launched == sum(1 + 2 * (lay.ids.shape[0] > 0) + (not lay.identity)
                                   for lay in layers)
            assert case not in ("one_hot", "small", "shared_limit") or launched == 3 * len(layers)
            assert case not in ("bag", "dup_bag") or launched == 4
        out[str(where)] = [t.cpu() for t in state[:6]] + dphis
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["q", "p0", "phi_s"])
def test_kernels_refuse_a_cache_of_the_wrong_length(cuda, which):
    x = _design(50, [("user", 50, 1)], 2, cuda)
    layers, scratch = ops.prepare(mfsi._field_layers(x, fm.FMHyperParams(k=2)), 50)
    table, phi_e, q, u, r_a, r_b, p2, p1, p0, jm = _state(50, x.p, 2, 3, cuda)
    q = q[:40] if which == "q" else q
    p0 = p0[:40] if which == "p0" else p0
    phi_s = phi_e[:40, 2] if which == "phi_s" else phi_e[:, 2]
    with pytest.raises(ValueError, match="n_rows"):
        ops.field_layer(layers[0], table[:, 0], phi_e[:, 0], phi_s,
                        ops.Caches(q, u, r_a, r_b, p2, p1, p0), (jm[0, 0], jm[0, 2], jm[2, 2]),
                        scratch, alpha0=ALPHA0, l2=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["jacobi", "slot"])
def test_flat_epoch_on_cuda_matches_cpu(cuda, mode):
    """Two flat FM epochs on the card, the embedding layers through the
    kernels (3 launches a one-hot layer, 4 a Jacobi bag's, a layer a side
    and dimension), against the same epochs on the CPU: the sums' order
    alone differs (rtol 1e-4, atol 1e-5; e atol 5e-5). Each slot of the bag
    draws from its own ids: where a feature sits in several slots, a 'slot'
    layer steps it on part of its gradient, the objective can rise, and
    1e-7 of noise in the start moves w by 2e-3 after two epochs."""
    rng = np.random.default_rng(9)
    n_ctx, n_items, nnz, k = 400, 150, 6000, 6
    hp = fm.FMHyperParams(k=k, alpha0=ALPHA0, l2=0.05, multi_hot_mode=mode)
    cells = rng.choice(n_ctx * n_items, size=nnz, replace=False)
    y, alpha = rng.integers(1, 4, nnz).astype(np.float64), 1.3 + rng.random(nnz)
    out = {}
    for where in ("cpu", cuda):
        x = _design(n_ctx, [("user", n_ctx, 1), ("age", 6, 1), ("hist", n_items, 5)], 21, where,
                    slot_ranges=True)
        z = _design(n_items, [("item", n_items, 1), ("genre", 7, 1)], 22, where)
        data = build_interactions(cells // n_items, cells % n_items, y, alpha, n_ctx, n_items,
                                  alpha0=ALPHA0, device=where)
        if not out:
            leaves = [(0.1 * rng.normal(size=s)).astype(np.float32)
                      for s in ((), (x.p,), (x.p, k), (z.p,), (z.p, k))]
        p = fm.params_from_numpy(*leaves, device=where)
        e = fm.residuals(p, x, z, data, hp)
        before = ops.field_layer.launches
        for _ in range(2):
            p, e = fm.epoch(p, x, z, data, e, hp)
        per_dim = (3 + 3 + (4 if mode == "jacobi" else 3 * 5)) + 3 + 3
        assert ops.field_layer.launches - before == (0 if where == "cpu" else 2 * k * per_dim)
        out[str(where)] = [t.cpu() for t in (*p, e)]
    for i, (a, b) in enumerate(zip(out[str(cuda)], out["cpu"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=5e-5 if i == 5 else 1e-5)
