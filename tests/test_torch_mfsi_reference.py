"""The benchmark's float64 plain reference of iCD-MFSI
(``bench/reference/mfsi.py``) against the port's flat epoch
(``core/models/mfsi.epoch``, CPU tensors) and the JAX package's
(``repro.core.models.mfsi.epoch``), with a Jacobi bag field among the
context fields. After two epochs from the same seeded factors: the
leaves, the carried residuals and Lemma 1's objective."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench.reference import common
from bench.reference import mfsi as ref_mfsi
from repro.core import design as jdesign
from repro.core.models import mfsi as jmfsi
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.core import design
from repro_torch.core.models import mfsi
from repro_torch.sparse.interactions import build_interactions

N_CTX, N_ITEMS, NNZ, ALPHA0 = 14, 10, 45, 0.3
EPOCHS = 2
# float32 epochs against float64 ones at these sizes differ by rounding: the
# leaves by 1–4e-7 relative, both packages; a start rounded to float16 (a
# 2^-11 relative step in every factor) moves them by 2–4e-4 after two epochs,
# which the test also shows fails
LEAF_TOL = 5e-6
RESID_TOL = 5e-6   # the residuals: 1–3e-7, the same rounding through the patches
LOSS_TOL = 1e-6    # the objective (≈ 250): 1e-10 to 3e-8


def _problem(seed, k):
    """Fields of ``tests/test_torch_mfsi.py``'s problem with a bag of 3
    distinct ids a row (the last slot of every third row zero-weighted),
    sorted (ctx, item) pairs, and float32 start factors."""
    rng = np.random.default_rng(seed)
    w = np.full((N_CTX, 3), 1 / 3, np.float32)
    w[::3, 2] = 0
    ctx_fields = [dict(name="country", ids=rng.integers(0, 4, N_CTX), vocab=4),
                  dict(name="age", ids=rng.integers(0, 3, N_CTX), vocab=3),
                  dict(name="hist", vocab=6, weights=w,
                       ids=np.stack([rng.choice(6, 3, replace=False) for _ in range(N_CTX)]))]
    item_fields = [dict(name="item_id", ids=np.arange(N_ITEMS), vocab=N_ITEMS),
                   dict(name="genre", ids=rng.integers(0, 5, N_ITEMS), vocab=5)]
    pairs = np.sort(rng.choice(N_CTX * N_ITEMS, size=NNZ, replace=False))
    ctx, item = pairs // N_ITEMS, pairs % N_ITEMS
    y = rng.integers(1, 5, size=NNZ).astype(np.float64)
    alpha = ALPHA0 + 1.0 + rng.random(NNZ)
    w0 = (0.3 * rng.normal(size=(13, k))).astype(np.float32)
    h0 = (0.3 * rng.normal(size=(N_ITEMS + 5, k))).astype(np.float32)
    return SimpleNamespace(ctx=ctx, item=item, y=y, alpha=alpha, n_ctx=N_CTX,
                           n_items=N_ITEMS, ctx_fields=ctx_fields,
                           item_fields=item_fields), w0, h0


def _gap(a, b):
    a, b = torch.as_tensor(np.array(a)).double(), torch.as_tensor(np.array(b)).double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _reference(inputs, cfg, theta0):
    ref = ref_mfsi.Reference(inputs, cfg, theta0, common.REFERENCE, torch.device("cpu"))
    for _ in range(EPOCHS):
        ref.epoch()
    return ref


@pytest.mark.parametrize("jacobi_eta", [0.5, 0.1])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_flat_epochs_match_the_float64_reference(seed, k, jacobi_eta):
    inputs, w0, h0 = _problem(seed, k)
    hp_kw = dict(k=k, alpha0=ALPHA0, l2=0.05, eta=1.0, multi_hot_mode="jacobi",
                 jacobi_eta=jacobi_eta)
    # the port
    x = design.make_design(inputs.ctx_fields, N_CTX, device="cpu")
    z = design.make_design(inputs.item_fields, N_ITEMS, device="cpu")
    assert (x.p, z.p) == (13, N_ITEMS + 5)
    data = build_interactions(inputs.ctx, inputs.item, inputs.y, inputs.alpha, N_CTX,
                              N_ITEMS, alpha0=ALPHA0, device="cpu")
    hp = mfsi.MFSIHyperParams(**hp_kw)
    params = mfsi.params_from_numpy(w0, h0, device="cpu")
    e = mfsi.residuals(params, x, z, data)
    for _ in range(EPOCHS):
        params, e = mfsi.epoch(params, x, z, data, e, hp)
    # the JAX package
    jx, jz = (jdesign.make_design(inputs.ctx_fields, N_CTX),
              jdesign.make_design(inputs.item_fields, N_ITEMS))
    jd = jbuild(inputs.ctx, inputs.item, inputs.y, inputs.alpha, N_CTX, N_ITEMS,
                alpha0=ALPHA0)
    jhp = jmfsi.MFSIHyperParams(**hp_kw)
    jp = jmfsi.MFSIParams(jnp.asarray(w0), jnp.asarray(h0))
    je = jmfsi.residuals(jp, jx, jz, jd)
    for _ in range(EPOCHS):
        jp, je = jmfsi.epoch(jp, jx, jz, jd, je, jhp)
    # the reference
    theta0 = {"w": torch.from_numpy(w0), "h": torch.from_numpy(h0)}
    ref = _reference(inputs, hp_kw, theta0)

    got = params._asdict()
    jgot = {"w": np.asarray(jp.w), "h": np.asarray(jp.h)}
    for name, want in ref.leaves().items():
        assert _gap(got[name], want) < LEAF_TOL, name
        assert _gap(jgot[name], want) < LEAF_TOL, name
    # the same (ctx, item) order on all three sides
    assert _gap(e, ref.residual()) < RESID_TOL
    assert _gap(np.asarray(je), ref.residual()) < RESID_TOL
    loss = ref.objective(ref.leaves())
    for leaves in (got, {n: torch.from_numpy(v.copy()) for n, v in jgot.items()}):
        assert abs(ref.objective(leaves) - loss) / loss < LOSS_TOL
    assert abs(float(mfsi.objective(params, x, z, data, hp)) - loss) / loss < LOSS_TOL

    # the tolerances are tight: a start rounded to float16 fails them
    half = {n: t.half().float() for n, t in theta0.items()}
    coarse = _reference(inputs, hp_kw, half)
    assert max(_gap(coarse.leaves()[n], ref.leaves()[n]) for n in got) > 10 * LEAF_TOL
