"""The port's Model API (``repro_torch.core.models.api``), the engine built
from a model, the model-driven evaluations and the serve driver's
``--continual`` held against the JAX package from the same numpy inputs.

Each model is built in both packages on the same interactions, designs and
pair lists, with the reference's init carried over through the module's
``params_from_numpy``; then the same lifecycle runs in both: objective,
fit, a manual epoch, exports, φ rows and fold-in rows. Tolerances: flat
epochs' parameters to rtol 5e-4 / atol 5e-5 (the MF epochs'), objectives
to rtol 1e-4, and the residuals and exports of trained params to the
epochs' tolerance; fold-in rows to rtol 2e-4 / atol 2e-5
(``tests/test_foldin.py``), top-K ids exactly and scores to rtol 1e-5 /
atol 1e-6 (on the same params), ranking metrics to atol 1e-6."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import design as jdesign
from repro.core.models import api as japi
from repro.core.models import ctxmf as jctxmf
from repro.core.models import fm as jfm
from repro.core.models import mf as jmf
from repro.core.models import mfsi as jmfsi
from repro.core.models import parafac as jparafac
from repro.core.models import tucker as jtucker
from repro.eval import ranking as jranking
from repro.serve.engine import RetrievalEngine as JEngine
from repro.sparse.interactions import build_interactions as jbuild
from repro_torch.core import design
from repro_torch.core.models import ctxmf, fm, mf, mfsi, parafac, tucker
from repro_torch.core.models.api import Dataset, Model, build_model
from repro_torch.core.models.parafac import TensorContext
from repro_torch.eval import ranking
from repro_torch.launch import serve
from repro_torch.serve.engine import RetrievalEngine
from repro_torch.sparse.interactions import build_interactions

torch.set_num_threads(1)

N_CTX, N_ITEMS, K = 10, 12, 4
EPOCH_RTOL, EPOCH_ATOL = 5e-4, 5e-5
OBJ_RTOL = 1e-4
EXPORT_RTOL, EXPORT_ATOL = 1e-5, 1e-6
FOLD_RTOL, FOLD_ATOL = 2e-4, 2e-5
MODELS = ("mf", "mfsi", "fm", "parafac", "tucker", "ctxmf")
MODULES = dict(mf=(mf, jmf), mfsi=(mfsi, jmfsi), fm=(fm, jfm),
               parafac=(parafac, jparafac), tucker=(tucker, jtucker),
               ctxmf=(parafac, jparafac))
ROOT = Path(__file__).resolve().parents[1]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _models(name):
    """(port model, port query, reference model, reference query): the
    reference's ``tests/test_model_api.py`` recipe in both packages."""
    rng = np.random.default_rng(7)
    cells = rng.choice(N_CTX * N_ITEMS, size=40, replace=False)
    obs = (cells // N_ITEMS, cells % N_ITEMS, rng.integers(1, 4, 40),
           0.3 + 1.0 + rng.random(40), N_CTX, N_ITEMS)
    data = build_interactions(*obs, alpha0=0.3, device="cpu")
    jdata = jbuild(*obs, alpha0=0.3)
    kw = dict(alpha0=0.3, l2=0.05)
    if name == "mf":
        return (build_model("mf", hp=mf.MFHyperParams(k=K, **kw),
                            dataset=Dataset(data=data)), torch.arange(6),
                japi.build_model("mf", hp=jmf.MFHyperParams(k=K, **kw),
                                 dataset=japi.Dataset(data=jdata)), jnp.arange(6))
    if name in ("mfsi", "fm"):
        cf = [dict(name="id", ids=np.arange(N_CTX) % 7, vocab=7),
              dict(name="grp", ids=rng.integers(0, 3, N_CTX), vocab=3)]
        itf = [dict(name="item_id", ids=np.arange(N_ITEMS), vocab=N_ITEMS),
               dict(name="genre", ids=rng.integers(0, 5, N_ITEMS), vocab=5)]
        mod, jmod = MODULES[name]
        hp_cls = "MFSIHyperParams" if name == "mfsi" else "FMHyperParams"
        ds = Dataset(data=data, x=design.make_design(cf, N_CTX, device="cpu"),
                     z=design.make_design(itf, N_ITEMS, device="cpu"))
        jds = japi.Dataset(data=jdata, x=jdesign.make_design(cf, N_CTX),
                           z=jdesign.make_design(itf, N_ITEMS))
        return (build_model(name, hp=getattr(mod, hp_cls)(k=K, **kw), dataset=ds),
                torch.arange(6),
                japi.build_model(name, hp=getattr(jmod, hp_cls)(k=K, **kw),
                                 dataset=jds), jnp.arange(6))
    chosen = rng.choice(5 * 4, size=N_CTX, replace=False)
    c1, c2 = chosen // 4, chosen % 4
    tc = TensorContext(c1=torch.as_tensor(c1), c2=torch.as_tensor(c2), n_c1=5,
                       n_c2=4)
    jtc = jparafac.TensorContext(c1=jnp.asarray(c1, jnp.int32),
                                 c2=jnp.asarray(c2, jnp.int32), n_c1=5, n_c2=4)
    if name == "tucker":
        hp = tucker.TuckerHyperParams(k1=3, k2=2, k3=K, **kw)
        jhp = jtucker.TuckerHyperParams(k1=3, k2=2, k3=K, **kw)
    elif name == "ctxmf":
        hp, jhp = ctxmf.CtxMFHyperParams(k=K, **kw), jctxmf.CtxMFHyperParams(k=K, **kw)
    else:
        hp = parafac.PARAFACHyperParams(k=K, **kw)
        jhp = jparafac.PARAFACHyperParams(k=K, **kw)
    q1, q2 = [0, 1, 2, 3, 0, 1], [1, 0, 3, 2, 2, 0]
    return (build_model(name, hp=hp, dataset=Dataset(data=data, tc=tc)),
            (torch.as_tensor(q1), torch.as_tensor(q2)),
            japi.build_model(name, hp=jhp, dataset=japi.Dataset(data=jdata, tc=jtc)),
            (jnp.asarray(q1, jnp.int32), jnp.asarray(q2, jnp.int32)))


def _carry(name, jparams):
    return MODULES[name][0].params_from_numpy(
        *(np.asarray(a) for a in jparams), device="cpu")


def _close_params(got, want, rtol=EPOCH_RTOL, atol=EPOCH_ATOL):
    for a, b in zip(got, want):
        _close(a, b, rtol, atol)


@pytest.mark.parametrize("name", MODELS)
def test_uniform_lifecycle_matches_reference(name):
    model, query, jmodel, jquery = _models(name)
    assert isinstance(model, Model) and model.name == jmodel.name == name
    # the port's own init: the generator's device, the reference's shapes
    own = model.init(torch.Generator().manual_seed(0))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in own] == [tuple(a.shape) for a in jparams]
    params = _carry(name, jparams)
    obj0 = float(model.objective(params))
    _close(obj0, float(jmodel.objective(jparams)), OBJ_RTOL)
    params = model.fit(params, n_epochs=3)
    jparams = jmodel.fit(jparams, n_epochs=3)
    _close_params(params, jparams)
    obj = float(model.objective(params))
    assert obj < obj0
    _close(obj, float(jmodel.objective(jparams)), OBJ_RTOL)
    # a manual epoch from the residual cache: the same surface everywhere
    e = model.residuals(params)
    _close(e, jmodel.residuals(jparams), EPOCH_RTOL, EPOCH_ATOL)
    params2, e2 = model.epoch(params, e)
    jparams2, je2 = jmodel.epoch(jparams, jmodel.residuals(jparams))
    _close_params(params2, jparams2)
    _close(e2, je2, EPOCH_RTOL, EPOCH_ATOL)
    assert float(model.objective(params2)) <= obj
    psi, phi = model.export_psi(params), model.build_phi(params, query)
    assert psi.shape[0] == N_ITEMS and phi.shape == (6, psi.shape[1])
    # trained params agree to the epochs' tolerance, and so do their exports
    _close(psi, jmodel.export_psi(jparams), EPOCH_RTOL, EPOCH_ATOL)
    _close(phi, jmodel.build_phi(jparams, jquery), EPOCH_RTOL, EPOCH_ATOL)
    _close(model.phi_table(params), jmodel.phi_table(jparams), EPOCH_RTOL,
           EPOCH_ATOL)
    # fold-in rows live in the same export coordinates
    u = model.fold_in_user(params, [0, 3, 7])
    i = model.fold_in_item(params, [1, 2])
    assert u.shape == (psi.shape[1],) and i.shape == (psi.shape[1],)
    _close(u, jmodel.fold_in_user(jparams, [0, 3, 7]), FOLD_RTOL, FOLD_ATOL)
    _close(i, jmodel.fold_in_item(jparams, [1, 2]), FOLD_RTOL, FOLD_ATOL)
    # the Dataset's confidence rides into fit as weights
    wts = 0.5 + torch.rand(model.dataset.data.nnz, generator=torch.Generator().manual_seed(1))
    weighted = build_model(name, hp=model.hp, dataset=Dataset(
        data=model.dataset.data, x=model.dataset.x, z=model.dataset.z,
        tc=model.dataset.tc, confidence=wts))
    a = weighted.fit(params, n_epochs=1)
    b = model.fit(params, n_epochs=1, weights=wts)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", MODELS)
def test_engine_from_model_matches_reference(name):
    model, query, jmodel, jquery = _models(name)
    jparams = jmodel.fit(jmodel.init(jax.random.PRNGKey(0)), n_epochs=2)
    params = _carry(name, jparams)
    eng = RetrievalEngine.from_model(model, params, k=5)
    jeng = JEngine.from_model(jmodel, jparams, k=5)
    res = eng.topk(*(query if isinstance(query, tuple) else (query,)))
    jres = jeng.topk(*(jquery if isinstance(jquery, tuple) else (jquery,)))
    assert res.ids.shape == (6, 5) and res.coverage == 1.0
    np.testing.assert_array_equal(_np(res.ids), np.asarray(jres.ids))
    _close(res.scores, jres.scores, EXPORT_RTOL, EXPORT_ATOL)
    # the engine built by hand agrees bit for bit
    ref = RetrievalEngine(model.export_psi(params),
                          lambda q: model.build_phi(params, q), k=5)
    ref_res = ref.topk_phi(model.build_phi(params, query))
    assert torch.equal(res.ids, ref_res.ids)
    # request-time fold-in through the serving tier
    phi = eng.fold_in_phi([0, 2], n_sweeps=32)
    assert phi.shape == (1, eng.psi.shape[1])
    _close(phi, jeng.fold_in_phi([0, 2], n_sweeps=32), FOLD_RTOL, FOLD_ATOL)
    np.testing.assert_array_equal(_np(eng.topk_phi(phi).ids),
                                  np.asarray(jeng.topk_phi(jnp.asarray(_np(phi))).ids))


def test_engine_without_model_refuses_fold_in():
    eng = RetrievalEngine(torch.ones((4, 3)), lambda q: torch.ones((1, 3)), k=2)
    with pytest.raises(RuntimeError, match="from_model"):
        eng.fold_in_phi([0])


def test_dataset_require_errors():
    rng = np.random.default_rng(0)
    data = build_interactions(np.arange(4), np.arange(4), np.ones(4),
                              np.full(4, 2.0), N_CTX, N_ITEMS, alpha0=0.3,
                              device="cpu")
    with pytest.raises(ValueError, match="missing") as got:
        build_model("mfsi", hp=mfsi.MFSIHyperParams(k=K), dataset=Dataset())
    with pytest.raises(ValueError, match="missing") as want:
        japi.build_model("mfsi", hp=jmfsi.MFSIHyperParams(k=K),
                         dataset=japi.Dataset())
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="missing"):
        build_model("tucker", hp=tucker.TuckerHyperParams(k1=2, k2=2, k3=K),
                    dataset=Dataset(data=data))
    with pytest.raises(ValueError, match="unknown model") as got:
        build_model("gcn", hp=None, dataset=Dataset())
    assert "ctxmf" in str(got.value)
    # data-less adapters exist (fold-in only) but training requires data
    m = build_model("mf", hp=mf.MFHyperParams(k=K), dataset=Dataset())
    with pytest.raises(ValueError, match="missing"):
        m.fit(mf.init(N_CTX, N_ITEMS, K, generator=torch.Generator()), n_epochs=1)
    assert rng is not None


def test_model_eval_callback_and_foldin_eval_match_reference():
    model, query, jmodel, jquery = _models("fm")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = _carry("fm", jparams)
    truth = np.arange(6) % N_ITEMS
    excl = [np.array([(u + 1) % N_ITEMS]) for u in range(6)]
    cb = ranking.model_eval_callback(model, query, truth, k=5, exclude=excl,
                                     batch_rows=4)
    jcb = jranking.model_eval_callback(jmodel, jquery, truth, k=5, exclude=excl,
                                       batch_rows=4)
    model.fit(params, n_epochs=2, callback=cb)
    jmodel.fit(jparams, n_epochs=2, callback=jcb)
    assert [h["epoch"] for h in cb.history] == [0, 1]
    for h, jh in zip(cb.history, jcb.history):
        for key in ("recall@5", "ndcg@5"):
            _close(h[key], jh[key], 0, 1e-6)
    histories = [np.array([1, 4]), np.array([0, 2, 3]), np.array([5]),
                 np.array([7, 8, 9, 10])]
    held = np.array([6, 7, 8, 11])
    for kw in (dict(), dict(alpha=2.0, exclude_history=False)):
        got = ranking.foldin_ranking_eval(model, params, histories, held, k=5,
                                          batch_rows=3, **kw)
        want = jranking.foldin_ranking_eval(jmodel, jparams, histories, held,
                                            k=5, batch_rows=3, **kw)
        for key in ("recall@5", "ndcg@5"):
            _close(got[key], want[key], 0, 1e-6)
        assert got["n_eval"] == 4 and got["coverage"] == 1.0


def test_serve_continual_smoke_matches_reference(tmp_path):
    """``--continual`` on the CPU: the fold-in rows against the reference's
    fold-in on the same (carried) params, the mesh's answers against a
    plain recompute, and the report lines against the reference driver's."""
    argv = ["--arch", "icd-mf", "--smoke", "--requests", "32", "--kill", "0:0",
            "--continual"]
    report = serve.main([*argv, "--device", "cpu"])
    cont = report["continual"]
    p = report["params"]
    jparams = jmf.MFParams(jnp.asarray(_np(p.w)), jnp.asarray(_np(p.h)))
    cfg = serve.get_smoke_config("icd-mf")
    jmodel = japi.build_model("mf", hp=jmf.MFHyperParams(
        k=cfg.k, alpha0=cfg.alpha0, l2=cfg.l2), dataset=japi.Dataset())
    _close(cont["phi"][0], jmodel.fold_in_user(jparams, cont["history"]),
           FOLD_RTOL, FOLD_ATOL)
    _close(cont["psi_row"], jmodel.fold_in_item(jparams, cont["item_ctx"]),
           FOLD_RTOL, FOLD_ATOL)
    scores = cont["phi"] @ p.h.T
    assert int(cont["user_result"].ids[0, 0]) == int(torch.argmax(scores[0]))
    assert cont["new_id"] == cfg.n_items and cont["version"] == 2
    psi_all = torch.cat([p.h, cont["psi_row"][None, :]])
    assert int(cont["item_result"].ids[0, 0]) == int(
        torch.argmax(cont["psi_row"] @ psi_all.T))
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve", *argv],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode == 0, ref.stderr[-1500:]
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv, "--device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr[-1500:]
    tail = lambda out: [ln for ln in out.splitlines() if "fold-in" in ln]  # noqa: E731
    got, want = tail(port.stdout), tail(ref.stdout)
    assert len(got) == len(want) == 2
    # the same history and new id from the same rng; the ids served differ
    # only where the factors do (another generator)
    assert got[0].split(":")[0] == want[0].split(":")[0]
    assert got[1].split(";")[0] == want[1].split(";")[0]
    assert got[1].endswith(f"top id {cfg.n_items} ({cfg.n_items + 1} items live)")
