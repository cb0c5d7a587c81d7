"""Context-aware MF: seasonal/session context as an extra k-separable mode
(port of ``repro.core.models.ctxmf``).

Hidasi & Tikk's *General Factorization Framework* (GFF) observes that any
context dimension can join a factorization model as one more k-separable
mode. This module realizes their seasonality-style "MF + context"
scenario on top of the paper's CD framework:

    ŷ(u, c, i) = Σ_f u_{u,f} · s_{c,f} · w_{i,f}

with user factors U, context-bucket factors S (one row per season or
session bucket) and item factors W — exactly the PARAFAC tensor model with
``(c1, c2) = (user, bucket)``. Every sweep delegates to
:mod:`repro_torch.core.models.parafac` unchanged; a bucket mode of a few
buckets has a few very long rows, which the row-patch sweep runs in its
block-row launch form.

What this module adds is the plumbing from a raw implicit event log
``(user, item, t)``:

  * :func:`seasonal_buckets` / :func:`session_buckets` — the context
    bucket per event from timestamps (phase within a season period, or a
    gap-split session index wrapped into a bucket vocabulary);
  * :func:`build_context` — dedupe ``(user, bucket)`` pairs into the
    :class:`~repro_torch.core.models.parafac.TensorContext` pair list plus
    the per-event pair index that ``Interactions.ctx`` expects.

The bucket helpers are numpy, seeded by their inputs, and return what the
reference returns, array for array.

Serving contract: ``export_psi`` is the item table W; a query address is a
``(user_ids, bucket_ids)`` pair and ``build_phi`` returns φ = U[u] ⊙ S[c].
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.models import parafac
from repro_torch.core.models.parafac import (  # re-exported: the delegation surface
    PARAFACParams as CtxMFParams,
    TensorContext,
    epoch,
    epoch_padded,
    pad_tensor_groups,
    params_from_numpy,
    residuals,
)
from repro_torch.kernels import resolve_device

__all__ = ["CtxMFParams", "CtxMFHyperParams", "TensorContext",
           "seasonal_buckets", "session_buckets", "build_context", "init",
           "params_from_numpy", "phi", "export_psi", "build_phi", "predict",
           "epoch", "epoch_padded", "pad_tensor_groups", "residuals",
           "objective", "fit"]


@dataclasses.dataclass(frozen=True)
class CtxMFHyperParams(parafac.PARAFACHyperParams):
    """PARAFAC hyperparams under the context-mode reading: ``dense_context``
    keeps its eq.-39 meaning (regularizer universe = users × buckets, the
    right default when every user can appear in every season)."""


def seasonal_buckets(t, n_buckets: int, period: float | None = None,
                     t0: float | None = None) -> np.ndarray:
    """Seasonal context bucket per event: the phase of ``t`` within
    ``period`` (default: the observed time span) quantized to
    ``n_buckets`` (hour of day, day of week, ... by the period chosen).

    ``t0`` is the phase origin; it defaults to ``t.min()`` of THIS call.
    When bucketing disjoint windows of one log, pass the same explicit
    ``t0`` to each call, or their bucket ids disagree."""
    t = np.asarray(t, np.float64)
    if t.size == 0:
        return np.zeros(0, np.int32)
    if t0 is None:
        t0 = float(t.min())
    if period is None:
        period = max(1.0, float(t.max() - t0 + 1))
    phase = np.mod(t - t0, period) / period
    return np.minimum((phase * n_buckets).astype(np.int32), n_buckets - 1)


def session_buckets(t, gap: float, n_buckets: int) -> np.ndarray:
    """Session context bucket per event: split the event times into
    sessions at gaps > ``gap``; session indices wrap into ``n_buckets`` so
    the bucket vocabulary stays bounded."""
    t = np.asarray(t, np.float64)
    if t.size == 0:
        return np.zeros(0, np.int32)
    order = np.argsort(t, kind="stable")
    new_session = np.r_[True, np.diff(t[order]) > gap]
    sess_sorted = np.cumsum(new_session) - 1
    sess = np.empty(t.size, np.int64)
    sess[order] = sess_sorted
    return (sess % n_buckets).astype(np.int32)


def build_context(user, bucket, n_users: int, n_buckets: int, *,
                  device=None) -> Tuple[TensorContext, np.ndarray]:
    """Dedupe per-event ``(user, bucket)`` into the tensor pair list.

    Returns ``(tc, pair_of_event)``: ``tc`` holds the unique pairs (the
    rows ``Interactions.ctx`` indexes), on ``device`` (the GPU unless the
    caller names the CPU), and ``pair_of_event`` (numpy) maps each event to
    its pair row. Pairs are lexsorted (user, bucket)."""
    user = np.asarray(user, np.int64)
    bucket = np.asarray(bucket, np.int64)
    if user.shape != bucket.shape:
        raise ValueError("user/bucket must have the same shape")
    if user.size and (user.min() < 0 or user.max() >= n_users):
        raise ValueError(f"user ids out of range [0, {n_users})")
    if bucket.size and (bucket.min() < 0 or bucket.max() >= n_buckets):
        raise ValueError(f"bucket ids out of range [0, {n_buckets})")
    device = resolve_device(device)
    key = user * n_buckets + bucket
    uniq, pair_of_event = np.unique(key, return_inverse=True)
    tc = TensorContext(
        c1=torch.as_tensor(uniq // n_buckets, device=device),
        c2=torch.as_tensor(uniq % n_buckets, device=device),
        n_c1=int(n_users), n_c2=int(n_buckets))
    return tc, pair_of_event.astype(np.int64)


def init(n_users: int, n_buckets: int, n_items: int, k: int, *,
         generator: torch.Generator, sigma: float = 0.1) -> CtxMFParams:
    return parafac.init(n_users, n_buckets, n_items, k, generator=generator,
                        sigma=sigma)


def phi(params: CtxMFParams, tc: TensorContext) -> torch.Tensor:
    return parafac.phi(params, tc)


def export_psi(params: CtxMFParams) -> torch.Tensor:
    """ψ table for the retrieval engine: the item factors W (n_items, k)."""
    return parafac.export_psi(params)


def build_phi(params: CtxMFParams, user, bucket) -> torch.Tensor:
    """φ rows for (user, context-bucket) queries: φ_f = u_{u,f}·s_{c,f}."""
    return parafac.build_phi(params, user, bucket)


def predict(params: CtxMFParams, user, bucket, item) -> torch.Tensor:
    return parafac.predict(params, user, bucket, item)


def objective(params, tc, data, hp) -> torch.Tensor:
    return parafac.objective(params, tc, data, hp)


def fit(params, tc, data, hp, n_epochs, callback=None, schedule=None,
        weights=None):
    return parafac.fit(params, tc, data, hp, n_epochs, callback=callback,
                       schedule=schedule, weights=weights)
