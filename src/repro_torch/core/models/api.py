"""Unified ``Model`` protocol over the k-separable zoo (MF, MFSI, FM,
PARAFAC, Tucker, CtxMF; port of ``repro.core.models.api``).

The model modules have their own entry points (``mf.fit(params, data,
hp, ...)`` against ``fm.fit(params, x, z, data, hp, ...)`` against
``tucker.fit(params, tc, data, hp, ...)``; ``build_phi`` takes ctx ids, a
design's rows or a ``(c1, c2)`` pair). This module routes them through ONE
surface, so the serving engine, ranking eval, zoo helpers and the
continual-learning path never branch on per-model signatures::

    ds = Dataset(data=interactions, x=x, z=z)          # per-model bundle
    model = build_model("fm", hp=hp, dataset=ds)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    params = model.fit(params, n_epochs=5)             # data keyword-only
    psi = model.export_psi(params)                     # (n_items, D)
    phi = model.build_phi(params, query)               # (B, D) query rows
    phi_new = model.fold_in_user(params, item_ids)     # closed-form, no epoch
    psi_new = model.fold_in_item(params, ctx_ids)      # → serve publish_delta

``query`` is the model's natural address: context ids (MF), context-design
row ids (MFSI/FM), or a ``(c1, c2)`` pair tuple (PARAFAC/Tucker/CtxMF).
``init`` takes a ``torch.Generator`` where the reference takes a JAX key
(the two draw different numbers; tests carry the reference's params over
with each module's ``params_from_numpy``).

Fold-in solves ONE embedding row in export coordinates against the frozen
other side through :mod:`repro_torch.core.foldin`, on the device the
params live on: the export table goes to the solver as the device tensor
it is, never copied to the host. ``fold_in_user`` returns a (D,) φ row for
``RetrievalEngine.topk_phi``; ``fold_in_item`` a (D,) ψ row for the
serving tier's ``publish_delta``. FM's constant-1 extended columns are
held fixed (the ``free`` mask).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import foldin
from repro_torch.core.design import Design
from repro_torch.core.models import fm, mf, mfsi, parafac, tucker
from repro_torch.core.models.parafac import TensorContext
from repro_torch.sparse.interactions import Interactions

__all__ = [
    "Dataset", "Model", "build_model", "MODEL_TYPES",
    "MFModel", "MFSIModel", "FMModel", "PARAFACModel", "TuckerModel",
    "CtxMFModel",
]


@dataclasses.dataclass(frozen=True)
class Dataset:
    """Per-model data bundle: everything a model consumes besides params.

    ``data``  training interactions (fold-in works without it)
    ``x``/``z`` context/item feature designs (MFSI, FM)
    ``tc``    tensor context pair lists (PARAFAC, Tucker, CtxMF)
    ``confidence`` optional (nnz,) per-interaction confidence weights in
    ctx-major order, threaded as ``weights=`` through every adapter's
    ``fit``/``epoch`` unless the call overrides it. ``None`` keeps every
    training program the unweighted one.
    """

    data: Optional[Interactions] = None
    x: Optional[Design] = None
    z: Optional[Design] = None
    tc: Optional[TensorContext] = None
    confidence: Optional[torch.Tensor] = None

    def require(self, *fields: str) -> "Dataset":
        missing = [f for f in fields if getattr(self, f) is None]
        if missing:
            raise ValueError(f"Dataset is missing required field(s) {missing}")
        return self


@runtime_checkable
class Model(Protocol):
    """What every zoo adapter provides (see the module docstring)."""

    name: str
    hp: object
    dataset: Dataset

    def init(self, generator: torch.Generator): ...
    def fit(self, params, *, n_epochs: int, data: Optional[Interactions] = None,
            callback: Optional[Callable] = None, schedule=None,
            weights=None): ...
    def epoch(self, params, e, *, data: Optional[Interactions] = None,
              schedule=None, sweep_index: int = 0, weights=None): ...
    def residuals(self, params, *, data: Optional[Interactions] = None): ...
    def objective(self, params, *, data: Optional[Interactions] = None): ...
    def export_psi(self, params): ...
    def build_phi(self, params, query): ...
    def phi_table(self, params): ...
    def fold_in_user(self, params, item_ids, y=None, alpha=None, *,
                     weights=None, n_sweeps: int = 64, tol: float = 1e-6): ...
    def fold_in_item(self, params, ctx_ids, y=None, alpha=None, *,
                     weights=None, n_sweeps: int = 64, tol: float = 1e-6): ...


class _ModelBase:
    """Shared adapter plumbing; subclasses bind one model module."""

    name = "?"

    def __init__(self, hp, dataset: Dataset):
        self.hp = hp
        self.dataset = dataset

    # -- data routing -----------------------------------------------------
    def _data(self, data: Optional[Interactions]) -> Interactions:
        if data is not None:
            return data
        self.dataset.require("data")
        return self.dataset.data

    def _weights(self, weights):
        """An explicit ``weights`` argument wins; otherwise the Dataset's
        ``confidence`` (None = the unweighted program)."""
        return weights if weights is not None else self.dataset.confidence

    # -- fold-in ----------------------------------------------------------
    # Free/fixed masks over the D export coordinates; None = all free.
    def _user_free_init(self):
        return None, None

    def _item_free_init(self):
        return None, None

    def _foldin_hp(self):
        return dict(alpha0=self.hp.alpha0, l2=self.hp.l2, eta=self.hp.eta)

    def _fold_in(self, table, ids, y, alpha, free_init, weights, n_sweeps,
                 tol) -> torch.Tensor:
        free, init = free_init
        return foldin.fold_in_row(
            table, ids, y, alpha, weights=weights, free=free, init=init,
            n_sweeps=n_sweeps, tol=tol, **self._foldin_hp()).row

    def fold_in_user(self, params, item_ids, y=None, alpha=None, *,
                     weights=None, n_sweeps: int = 64,
                     tol: float = 1e-6) -> torch.Tensor:
        """φ row (D,) for an UNSEEN user from their item interactions:
        single-row CD against the frozen ψ export table, on its device.
        ``weights`` (per-interaction confidence) multiplies α."""
        return self._fold_in(self.export_psi(params), item_ids, y, alpha,
                             self._user_free_init(), weights, n_sweeps, tol)

    def fold_in_item(self, params, ctx_ids, y=None, alpha=None, *,
                     weights=None, n_sweeps: int = 64,
                     tol: float = 1e-6) -> torch.Tensor:
        """ψ row (D,) for a NEW item from the contexts that touched it (ids
        in the model's ``Interactions.ctx`` space): single-row CD against
        the frozen φ table, ready for the serving tier's
        ``publish_delta``."""
        return self._fold_in(self.phi_table(params), ctx_ids, y, alpha,
                             self._item_free_init(), weights, n_sweeps, tol)


class MFModel(_ModelBase):
    name = "mf"

    def init(self, generator):
        d = self._data(None)
        return mf.init(d.n_ctx, d.n_items, self.hp.k, generator=generator)

    def fit(self, params, *, n_epochs, data=None, callback=None, schedule=None,
            weights=None):
        return mf.fit(params, self._data(data), self.hp, n_epochs,
                      callback=callback, schedule=schedule,
                      weights=self._weights(weights))

    def epoch(self, params, e, *, data=None, schedule=None, sweep_index=0,
              weights=None):
        return mf.epoch(params, self._data(data), e, self.hp, schedule,
                        sweep_index, self._weights(weights))

    def residuals(self, params, *, data=None):
        return mf.residuals(params, self._data(data))

    def objective(self, params, *, data=None):
        return mf.objective(params, self._data(data), self.hp)

    def export_psi(self, params):
        return mf.export_psi(params)

    def build_phi(self, params, query):
        return mf.build_phi(params, query)

    def phi_table(self, params):
        return mf.phi(params)


class _DesignModel(_ModelBase):
    """MFSI and FM: two feature designs, the query a context-design row."""

    module = None

    def __init__(self, hp, dataset: Dataset):
        super().__init__(hp, dataset.require("x", "z"))

    def init(self, generator):
        return self.module.init(self.dataset.x.p, self.dataset.z.p, self.hp.k,
                                generator=generator)

    def fit(self, params, *, n_epochs, data=None, callback=None, schedule=None,
            weights=None):
        ds = self.dataset
        return self.module.fit(params, ds.x, ds.z, self._data(data), self.hp,
                               n_epochs, callback=callback, schedule=schedule,
                               weights=self._weights(weights))

    def epoch(self, params, e, *, data=None, schedule=None, sweep_index=0,
              weights=None):
        ds = self.dataset
        return self.module.epoch(params, ds.x, ds.z, self._data(data), e,
                                 self.hp, schedule, sweep_index,
                                 self._weights(weights))

    def objective(self, params, *, data=None):
        ds = self.dataset
        return self.module.objective(params, ds.x, ds.z, self._data(data),
                                     self.hp)


class MFSIModel(_DesignModel):
    name = "mfsi"
    module = mfsi

    def residuals(self, params, *, data=None):
        ds = self.dataset
        return mfsi.residuals(params, ds.x, ds.z, self._data(data))

    def export_psi(self, params):
        return mfsi.export_psi(params, self.dataset.z)

    def build_phi(self, params, query):
        return mfsi.build_phi(params, self.dataset.x, query)

    def phi_table(self, params):
        return mfsi.phi(params, self.dataset.x)


class FMModel(_DesignModel):
    name = "fm"
    module = fm

    def residuals(self, params, *, data=None):
        ds = self.dataset
        return fm.residuals(params, ds.x, ds.z, self._data(data), self.hp)

    def export_psi(self, params):
        return fm.export_psi(params, self.dataset.z, self.hp)

    def build_phi(self, params, query):
        return fm.build_phi(params, self.dataset.x, self.hp, query)

    def phi_table(self, params):
        return fm.phi_ext(params, self.dataset.x, self.hp)

    # FM extended columns: Φe = [Φ | φ_spec | 1], Ψe = [Ψ | 1 | ψ_spec].
    # A folded-in row solves the latent block plus ITS OWN spec column (it
    # meets the other side's constant-1) while the constant-1 column that
    # meets the other side's spec stays fixed at 1.
    def _fixed_one(self, col):
        k = self.hp.k
        free = np.ones(k + 2, bool)
        free[col] = False
        init = np.zeros(k + 2, np.float32)
        init[col] = 1.0
        return free, init

    def _user_free_init(self):
        return self._fixed_one(self.hp.k + 1)

    def _item_free_init(self):
        return self._fixed_one(self.hp.k)


class PARAFACModel(_ModelBase):
    name = "parafac"
    module = parafac

    def __init__(self, hp, dataset: Dataset):
        super().__init__(hp, dataset.require("tc"))

    def init(self, generator):
        d = self._data(None)
        tc = self.dataset.tc
        return parafac.init(tc.n_c1, tc.n_c2, d.n_items, self.hp.k,
                            generator=generator)

    def fit(self, params, *, n_epochs, data=None, callback=None, schedule=None,
            weights=None):
        return self.module.fit(params, self.dataset.tc, self._data(data),
                               self.hp, n_epochs, callback=callback,
                               schedule=schedule,
                               weights=self._weights(weights))

    def epoch(self, params, e, *, data=None, schedule=None, sweep_index=0,
              weights=None):
        return self.module.epoch(params, self.dataset.tc, self._data(data), e,
                                 self.hp, schedule, sweep_index,
                                 self._weights(weights))

    def residuals(self, params, *, data=None):
        return self.module.residuals(params, self.dataset.tc, self._data(data))

    def objective(self, params, *, data=None):
        return self.module.objective(params, self.dataset.tc,
                                     self._data(data), self.hp)

    def export_psi(self, params):
        return self.module.export_psi(params)

    def build_phi(self, params, query):
        c1, c2 = query
        return self.module.build_phi(params, c1, c2)

    def phi_table(self, params):
        return self.module.phi(params, self.dataset.tc)


class TuckerModel(PARAFACModel):
    name = "tucker"
    module = tucker

    def init(self, generator):
        d = self._data(None)
        tc = self.dataset.tc
        return tucker.init(tc.n_c1, tc.n_c2, d.n_items, self.hp.k1,
                           self.hp.k2, self.hp.k3, generator=generator)


class CtxMFModel(PARAFACModel):
    """Context-aware MF (seasonal/session mode): PARAFAC with ``(c1, c2) =
    (user, context bucket)``. The query address is a ``(user_ids,
    bucket_ids)`` pair; ``tc``/``data.ctx`` come from
    :func:`repro_torch.core.models.ctxmf.build_context`. Every training and
    serving path is PARAFAC's."""

    name = "ctxmf"


MODEL_TYPES = {
    "mf": MFModel,
    "mfsi": MFSIModel,
    "fm": FMModel,
    "parafac": PARAFACModel,
    "tucker": TuckerModel,
    "ctxmf": CtxMFModel,
}


def build_model(name: str, *, hp, dataset: Dataset) -> Model:
    """The adapter for zoo model ``name`` around its hyperparams and
    :class:`Dataset` bundle."""
    try:
        cls = MODEL_TYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; zoo = {tuple(MODEL_TYPES)}") from None
    return cls(hp, dataset)
