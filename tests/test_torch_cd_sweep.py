"""The port's Gram and block-sweep kernel packages held against the JAX
package's (``repro.kernels.{gram,cd_sweep,cd_update}``) on the same numpy
inputs.

On the CPU the port's wrappers run their plain versions (``ref.py``); the
JAX side runs its jnp oracles and, at toy sizes, its Pallas kernels in
interpret mode. The hand kernels run only on the card: their tests are in
``test_torch_launch.py``, which imports no JAX.

Tolerances: the reference's own kernel-vs-oracle tolerance for the sweeps
(rtol 2e-5, atol 2e-6, ``tests/test_kernels.py``), since the two sum the
D_pad slots in different orders; the Gram to rtol 1e-5 / atol 1e-5, and
small-integer inputs, whose sums are exact in any order, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cd_sweep import ref as jref
from repro.kernels.cd_sweep.kernel import (
    cd_block_sweep_gather_pallas,
    cd_block_sweep_pallas,
)
from repro.kernels.cd_update.kernel import cd_column_update_pallas
from repro.kernels.cd_update.ref import cd_column_update_ref as j_column_ref
from repro.kernels.gram.kernel import gram_pallas
from repro_torch.kernels import vmem
from repro_torch.kernels.cd_sweep import ops, ref
from repro_torch.kernels.cd_update import ops as cu_ops
from repro_torch.kernels.cd_update.ref import cd_column_update_ref
from repro_torch.kernels.gram import ops as gram_ops

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _n(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _sweep_case(seed, c, d, kb, n_src=20, k=None, pad_frac=0.4):
    """Random sweep operands: padding slots have id 0 and α = 0; W is a
    column slice of a wider (C, k) matrix, as the epochs pass it."""
    rng = np.random.default_rng(seed)
    k = k or kb
    alpha = (rng.random((c, d)) * 4 + 0.5).astype(np.float32)
    pad = rng.random((c, d)) < pad_frac
    alpha[pad] = 0
    ids = rng.integers(0, n_src, (c, d)).astype(np.int32)
    ids[pad] = 0
    tab = (0.3 * rng.normal(size=(n_src, k))).astype(np.float32)
    j = (tab.T @ tab + np.eye(k, dtype=np.float32))[:kb, :kb].copy()
    return dict(
        tab=tab[:, :kb], ids=ids, alpha=alpha,
        e=rng.normal(size=(c, d)).astype(np.float32),
        w=(0.3 * rng.normal(size=(c, k))).astype(np.float32)[:, :kb],
        r1=rng.normal(size=(c, kb)).astype(np.float32), j=j)


def _port_gather(x, **kw):
    e = _t(x["e"]).clone()
    w, e2 = ops.cd_block_sweep_gather(
        _t(x["tab"]), _t(x["ids"]), _t(x["alpha"]), e, _t(x["w"]),
        _t(x["r1"]), _t(x["j"]), **kw)
    assert e2 is e  # in place on every device
    return w.numpy(), e.numpy()


def _port_pregather(x, **kw):
    psi = ref.gather_psi_blk(_t(x["tab"]), _t(x["ids"])).contiguous()
    e = _t(x["e"]).clone()
    w, e2 = ops.cd_block_sweep(psi, _t(x["alpha"]), e, _t(x["w"]),
                               _t(x["r1"]), _t(x["j"]), **kw)
    assert e2 is e
    return w.numpy(), e.numpy()


def _jax_gather_ref(x, **kw):
    w, e = jref.cd_block_sweep_gather_ref(
        jnp.asarray(x["tab"]), jnp.asarray(x["ids"]), jnp.asarray(x["alpha"]),
        jnp.asarray(x["e"]), jnp.asarray(x["w"]), jnp.asarray(x["r1"]),
        jnp.asarray(x["j"]), **kw)
    return np.asarray(w), np.asarray(e)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ gram ---
@pytest.mark.parametrize("rows,k", [(300, 16), (257, 12), (33, 130)])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_gram_matches_jax_gram(rows, k, weighted):
    rng = np.random.default_rng(rows + k)
    x = rng.normal(size=(rows, k)).astype(np.float32)
    w = rng.random(rows).astype(np.float32) * 3 if weighted else None
    got = gram_ops.gram(_t(x), weights=None if w is None else _t(w)).numpy()
    want = np.asarray(gram_pallas(jnp.asarray(x), None if w is None
                                  else jnp.asarray(w), block_rows=128,
                                  interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert gram_ops.gram.launches == 0  # CPU tensors never launch


def test_plain_gram_small_integers_exact():
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, (500, 9)).astype(np.float32)
    w = rng.integers(0, 3, 500).astype(np.float32)
    want = np.asarray(gram_pallas(jnp.asarray(x), jnp.asarray(w),
                                  block_rows=256, interpret=True))
    np.testing.assert_array_equal(
        gram_ops.gram(_t(x), weights=_t(w)).numpy(), want)


def test_gram_row_splits_cover_every_row():
    for rows, k in [(0, 4), (1, 1), (31, 8), (200_000, 128), (68_000, 128),
                    (5_000, 200)]:
        splits, per = vmem.gram_row_splits(rows, k)
        assert per % vmem.GRAM_CHUNK == 0 and 1 <= splits <= 65535
        assert splits * per >= rows and (splits - 1) * per < max(rows, 1)


# ------------------------------------------------------------- cd_sweep ---
@pytest.mark.parametrize("c,d,kb", [(37, 24, 4), (8, 128, 8), (5, 33, 1)])
def test_block_sweeps_match_jax_oracles(c, d, kb):
    x = _sweep_case(c * d + kb, c, d, kb, k=kb + 3)
    want = _jax_gather_ref(x, alpha0=0.7, l2=0.05)
    _close(_port_gather(x, alpha0=0.7, l2=0.05), want)
    _close(_port_pregather(x, alpha0=0.7, l2=0.05), want)
    assert ops.cd_block_sweep.launches == 0
    assert ops.cd_block_sweep_gather.launches == 0


def test_block_sweeps_match_pallas_interpret():
    """Toy size: the port's plain versions against the TPU kernels
    themselves, run in interpret mode, with C off the row tile."""
    x = _sweep_case(9, 19, 128, 3, n_src=11)
    kw = dict(alpha0=0.4, l2=0.1, eta=0.8)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    pw, pe = cd_block_sweep_pallas(
        jnp.moveaxis(jnp.take(j["tab"], j["ids"], axis=0), -1, 1), j["alpha"],
        j["e"], j["w"], j["r1"], j["j"], block_ctx=8, interpret=True, **kw)
    gw, ge = cd_block_sweep_gather_pallas(
        j["tab"], j["ids"], j["alpha"], j["e"], j["w"], j["r1"], j["j"],
        block_ctx=8, interpret=True, **kw)
    _close(_port_pregather(x, **kw), (np.asarray(pw), np.asarray(pe)))
    _close(_port_gather(x, **kw), (np.asarray(gw), np.asarray(ge)))


@pytest.mark.parametrize("eta", [1.0, 0.6, 1.4])
def test_sweep_eta_matches_jax(eta):
    x = _sweep_case(40, 16, 40, 5, k=9)
    _close(_port_gather(x, alpha0=1.0, l2=0.1, eta=eta),
           _jax_gather_ref(x, alpha0=1.0, l2=0.1, eta=eta))


def test_padding_ids_are_clipped_like_the_reference():
    """Ids past either end of the slab read its last or first row, as
    ``jnp.take(mode="clip")`` does."""
    x = _sweep_case(41, 6, 16, 4, n_src=7)
    x["ids"][:, :4] = np.array([-5, 6, 7, 1000], np.int32)
    x["alpha"][:, :4] = 1.0
    _close(_port_gather(x, alpha0=0.5, l2=0.1),
           _jax_gather_ref(x, alpha0=0.5, l2=0.1))


def test_empty_rows_with_l2_zero_hit_the_clamp():
    """All-α=0 rows with l2 = 0 and α₀ = 0: the denominator is 0 and the
    1e-12 clamp keeps Δ = 0 (no NaN), in both packages."""
    x = _sweep_case(42, 9, 32, 3)
    x["alpha"][:4] = 0
    got = _port_gather(x, alpha0=0.0, l2=0.0)
    want = _jax_gather_ref(x, alpha0=0.0, l2=0.0)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    np.testing.assert_array_equal(got[0][:4], x["w"][:4])
    _close(got, want)


def test_weights_fold_into_alpha_exactly():
    x = _sweep_case(43, 12, 24, 4)
    kw = dict(alpha0=0.5, l2=0.1)
    ones = torch.ones(x["alpha"].shape)
    base = _port_gather(x, **kw)
    e = _t(x["e"]).clone()
    w1, _ = ops.cd_block_sweep_gather(
        _t(x["tab"]), _t(x["ids"]), _t(x["alpha"]), e, _t(x["w"]),
        _t(x["r1"]), _t(x["j"]), weights=ones, **kw)
    np.testing.assert_array_equal(w1.numpy(), base[0])
    np.testing.assert_array_equal(e.numpy(), base[1])
    wts = np.random.default_rng(1).random(x["alpha"].shape).astype(np.float32) + 0.5
    e = _t(x["e"]).clone()
    w2, _ = ops.cd_block_sweep_gather(
        _t(x["tab"]), _t(x["ids"]), _t(x["alpha"]), e, _t(x["w"]),
        _t(x["r1"]), _t(x["j"]), weights=_t(wts), **kw)
    want = _jax_gather_ref(dict(x, alpha=x["alpha"] * wts), **kw)
    _close((w2.numpy(), e.numpy()), want)


# ------------------------------------------------------------ cd_update ---
def test_column_update_is_the_kb1_sweep_and_matches_jax():
    x = _sweep_case(44, 21, 128, 1, n_src=13)
    psi = ref.gather_psi_blk(_t(x["tab"]), _t(x["ids"]))[:, 0, :].contiguous()
    args = (psi, _t(x["alpha"]), _t(x["e"]).clone(), _t(x["w"][:, 0]),
            _t(x["r1"][:, 0]), float(x["j"][0, 0]))
    kw = dict(alpha0=0.6, l2=0.2, eta=0.9)
    w, e = cu_ops.cd_column_update(*args, **kw)
    pw, pe = cd_column_update_ref(psi, _t(x["alpha"]), _t(x["e"]),
                                  _t(x["w"][:, 0]), _t(x["r1"][:, 0]),
                                  float(x["j"][0, 0]), **kw)
    jargs = (jnp.asarray(psi.numpy()), jnp.asarray(x["alpha"]),
             jnp.asarray(x["e"]), jnp.asarray(x["w"][:, 0]),
             jnp.asarray(x["r1"][:, 0]), float(x["j"][0, 0]))
    jw, je = j_column_ref(*jargs, **kw)
    kw_, ke = cd_column_update_pallas(*jargs, block_ctx=8, interpret=True, **kw)
    for got in ((w.numpy(), e.numpy()), (pw.numpy(), pe.numpy())):
        _close(got, (np.asarray(jw), np.asarray(je)))
        _close(got, (np.asarray(kw_), np.asarray(ke)))


# ------------------------------------- slice 3/4 plain versions on the CPU ---
def test_rowpatch_slab_and_patch_plain_versions_match_jax():
    rng = np.random.default_rng(45)
    c, m, d = 7, 3, 16
    psi = rng.normal(size=(c, m, d)).astype(np.float32)
    alpha = rng.random((c, d)).astype(np.float32)
    e = rng.normal(size=(c, d)).astype(np.float32)
    w = rng.normal(size=(c, m)).astype(np.float32)
    r1 = rng.normal(size=(c, m)).astype(np.float32)
    p = rng.random((c, m, m)).astype(np.float32) + np.eye(m, dtype=np.float32)
    dphi = rng.normal(size=(c, m)).astype(np.float32)
    kw = dict(alpha0=0.5, l2=0.1)
    ew = _t(e).clone()
    got = ops.cd_block_sweep_rowpatch(_t(psi), _t(alpha), ew, _t(w), _t(r1),
                                      _t(p), **kw)
    want = jref.cd_block_sweep_rowpatch_ref(*map(jnp.asarray, (psi, alpha, e, w,
                                                               r1, p)), **kw)
    _close((got[0].numpy(), got[1].numpy()), tuple(map(np.asarray, want)))
    q, pp = ops.cd_slab_reduce(_t(psi), _t(alpha), _t(e))
    jq, jp = jref.cd_slab_reduce_ref(*map(jnp.asarray, (psi, alpha, e)))
    _close((q.numpy(), pp.numpy()), (np.asarray(jq), np.asarray(jp)))
    got_e = ops.cd_resid_patch(_t(psi), _t(e).clone(), _t(dphi))
    _close((got_e.numpy(),), (np.asarray(jref.cd_resid_patch_ref(
        *map(jnp.asarray, (psi, e, dphi)))),))


def test_sweep_budget_raises_rather_than_shrinking():
    """A row that cannot stay resident in one block's shared memory
    raises; a fitting row gets whole rows per block."""
    assert vmem.resolve_cd_sweep_dispatch(128, 8) is True
    assert vmem.cd_sweep_gather_block_ctx(128, 8, n_rows=200_000) == 8
    assert vmem.resolve_cd_sweep_dispatch(1024, 8) is True
    rows = vmem.cd_sweep_gather_block_ctx(1024, 8, n_rows=68_000)
    assert rows >= 1
    assert vmem.cd_sweep_smem_bytes(1024, 8, rows, gather=True) \
        <= vmem.SMEM_BLOCK_MAX
    assert vmem.resolve_cd_sweep_dispatch(128, 8, prefer_gather=False) \
        is False
    assert vmem.cd_sweep_block_ctx(128, 8, n_rows=3) == 3
    with pytest.raises(vmem.VmemBudgetError):
        vmem.cd_sweep_gather_block_ctx(20_000, 8)
    with pytest.raises(vmem.VmemBudgetError):
        vmem.resolve_cd_sweep_dispatch(20_000, 8)
    with pytest.raises(vmem.VmemBudgetError):
        vmem.cd_sweep_block_ctx(128, 240)


def test_slab_check_refuses_strided_columns_whatever_the_row_count():
    """A slab whose columns are not contiguous is refused also when it has
    one row: the binding reads a one-row slab as contiguous."""
    one_row = torch.zeros(8, 3).T[:1]          # (1, 8), strides (1, 3)
    assert one_row.stride(1) != 1
    for check in (lambda t: ops._check_slab("w_blk", t, 1, 8),
                  lambda t: ops._check_ids_slab(
                      t, torch.zeros((2, 4), dtype=torch.int32), 2, 4, 8)):
        with pytest.raises(ValueError, match="columns must be contiguous"):
            check(one_row)
        check(one_row.contiguous())
    ops._check_slab("w_blk", torch.zeros(3, 8).T[:, :1], 8, 1)  # one column
    ops._check_slab("w_blk", torch.zeros(4, 12)[:, 2:10], 4, 8)  # a column slice
