"""Long item rows held against the JAX package (ROADMAP fault 3.3): MF's
fused epoch and PARAFAC's fused epoch with one item row of 16,000 slots,
on both Ψ routings.

Such a row is too long for one block's shared memory in the warp-row
form; the port's dispatch sizes the sweep by its launch form
(``vmem.cd_sweep_form``), so on the card the gather route takes the
split-row form and the pre-gathered route the block-row form, and only a
k_b that no form can launch raises. On the CPU the port's wrappers run
their plain versions and the JAX package runs its Pallas kernels in
interpret mode. Tolerances are the reference's: MF parameters and
residuals after two epochs to rtol 5e-4 / atol 5e-5
(``tests/test_torch_mf_train.py``), PARAFAC parameters to rtol 5e-4 /
atol 1e-5 and residuals to atol 5e-5 (``tests/test_torch_tensor.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.models import mf as jmf
from repro.core.models import mf_padded as jmfp
from repro.core.models import parafac as jpf
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.core.models import mf, mf_padded, parafac
from repro_torch.kernels import vmem
from repro_torch.sparse.interactions import build_interactions

torch.set_num_threads(1)

LONG = 16_000          # slots of the long item row (every context on item 0)
K, BLOCK_K = 2, 2


def _long_row_log(n_ctx, n_items, seed):
    """Every context on item 0, and a few more cells on the other items."""
    rng = np.random.default_rng(seed)
    ctx = np.concatenate([np.arange(n_ctx), rng.integers(0, n_ctx, 40)])
    item = np.concatenate([np.zeros(n_ctx, np.int64),
                           rng.integers(1, n_items, 40)])
    cells = np.unique(ctx * n_items + item)
    ctx, item = cells // n_items, cells % n_items
    y = rng.integers(1, 5, len(cells)).astype(np.float64)
    alpha = 1.3 + rng.random(len(cells))
    return ctx, item, y, alpha


@pytest.mark.parametrize("psi_dispatch,block_k", [("gather", BLOCK_K),
                                                  ("pregather", BLOCK_K),
                                                  ("gather", 1)])
def test_mf_long_item_row_matches_reference(psi_dispatch, block_k):
    """block_k 1 is the per-column path: one k_b = 1 launch a column
    (``cd_column_update``), sized by the same dispatch."""
    n_ctx, n_items = LONG, 3
    ctx, item, y, alpha = _long_row_log(n_ctx, n_items, 1)
    rng = np.random.default_rng(2)
    w0 = (0.1 * rng.normal(size=(n_ctx, K))).astype(np.float32)
    h0 = (0.1 * rng.normal(size=(n_items, K))).astype(np.float32)
    jd = jbuild(ctx, item, y, alpha, n_ctx, n_items, alpha0=0.4)
    td = build_interactions(ctx, item, y, alpha, n_ctx, n_items, alpha0=0.4,
                            device="cpu")
    kw = dict(k=K, alpha0=0.4, l2=0.05, block_k=block_k, psi_dispatch=psi_dispatch)
    jhp, thp = jmf.MFHyperParams(**kw), mf.MFHyperParams(**kw)
    jpd, tpd = jmfp.pad_interactions(jd), mf_padded.pad_interactions(td)
    d_item = tpd.ctx_ids.shape[1]
    assert d_item >= LONG
    # the warp-row form cannot hold the row; the dispatch now takes it
    with pytest.raises(vmem.VmemBudgetError):
        vmem.cd_sweep_gather_block_ctx(d_item, BLOCK_K)
    assert vmem.resolve_cd_sweep_dispatch(
        d_item, block_k, prefer_gather=psi_dispatch == "gather") is (
            psi_dispatch == "gather")
    jp = jmf.MFParams(jnp.asarray(w0), jnp.asarray(h0))
    tp = mf.params_from_numpy(w0, h0, device="cpu")
    je, te = jmfp.residuals(jp, jpd), mf_padded.residuals(tp, tpd)
    for _ in range(2):
        jp, je = jmfp.epoch(jp, jpd, je, jhp)
        tp, te = mf_padded.epoch(tp, tpd, te, thp)
    for got, want in ((tp.w, jp.w), (tp.h, jp.h), (te, je)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                                   atol=5e-5)


@pytest.mark.parametrize("psi_dispatch", ["gather", "pregather"])
def test_parafac_long_item_row_matches_reference(psi_dispatch):
    n_c1, n_c2, n_items = 200, 80, 3
    pairs = np.stack(np.divmod(np.arange(n_c1 * n_c2), n_c2), 1)
    ctx, item, y, alpha = _long_row_log(len(pairs), n_items, 3)
    jtc = jpf.TensorContext(c1=jnp.asarray(pairs[:, 0], jnp.int32),
                            c2=jnp.asarray(pairs[:, 1], jnp.int32),
                            n_c1=n_c1, n_c2=n_c2)
    ttc = parafac.TensorContext(c1=torch.from_numpy(pairs[:, 0].copy()),
                                c2=torch.from_numpy(pairs[:, 1].copy()),
                                n_c1=n_c1, n_c2=n_c2)
    jd = jbuild(ctx, item, y, alpha, len(pairs), n_items, alpha0=0.3)
    td = build_interactions(ctx, item, y, alpha, len(pairs), n_items,
                            alpha0=0.3, device="cpu")
    rng = np.random.default_rng(4)
    f = [(0.3 * rng.normal(size=s)).astype(np.float32)
         for s in ((n_c1, K), (n_c2, K), (n_items, K))]
    jp = jpf.PARAFACParams(*map(jnp.asarray, f))
    tp = parafac.params_from_numpy(*f, device="cpu")
    kw = dict(k=K, alpha0=0.3, l2=0.05, block_k=BLOCK_K, psi_dispatch=psi_dispatch)
    jhp, thp = jpf.PARAFACHyperParams(**kw), parafac.PARAFACHyperParams(**kw)
    jpad, tpad = jpf.pad_tensor_groups(jtc, jd), parafac.pad_tensor_groups(ttc, td)
    assert tpad.gi.d_pad >= LONG
    je, te = jpf.residuals(jp, jtc, jd), parafac.residuals(tp, ttc, td)
    for _ in range(2):
        jp, je = jpf.epoch_padded(jp, jtc, jd, jpad, je, jhp)
        tp, te = parafac.epoch_padded(tp, ttc, td, tpad, te, thp)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=5e-4, atol=5e-5)
