"""Training-loop observability: a ``fit(callback=...)`` adapter (port of
``repro.obs.train``).

The host-visible cadence of training is the epoch boundary, where every
model's ``fit`` invokes its callback, so that is where the registry gets
fed:

  * ``train_epoch_seconds``        histogram of epoch wall time
                                   (boundary to boundary, registry clock;
                                   the params' CUDA device is synchronised
                                   before each read, so the epoch's work
                                   is timed, not its enqueue)
  * ``train_loss``                 gauge; set when an ``objective`` fn is
                                   given (the trajectory rides
                                   ``callback.history`` too)
  * ``train_epochs_total``         counter
  * ``train_block_visits_total``   per-``f0`` counter of SweepSchedule
                                   block visits (one side's plan; both
                                   sides sweep the same plan per epoch)
  * ``train_block_seconds_est``    histogram: epoch time / blocks visited,
                                   an ESTIMATE of one k_b block's cost
                                   (a host clock cannot split the queued
                                   launches; the analytic cost below does)
  * ``kernel_*_total{kernel="cd_sweep"}`` — the analytic cost model
                                   (``obs/costs.py``) recorded per epoch
                                   when ``cd_shape=(C, D_pad, k)`` is
                                   given: 2 sides × the fused sweep

Compose with the eval hook::

    cb = compose_callbacks(
        fit_metrics_callback(registry=reg, objective=obj, n_dims=k,
                             block=k_b),
        fit_eval_callback(export, truth, k=10),
    )
    mf.fit(params, data, hp, n_epochs=8, callback=cb)
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.obs.costs import KernelCostRecorder
from repro_torch.obs.metrics import next_instance_id, resolve_registry

# epoch timing buckets: epochs run from milliseconds to minutes
_EPOCH_BUCKETS = (1e-3, 5e-3, 2.5e-2, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0,
                  30.0, 60.0, 300.0)


def compose_callbacks(*callbacks) -> Callable:
    """One ``callback(epoch, params)`` fanning out to several (``None``
    entries skipped) — the glue between this module's metrics callback
    and ``eval.ranking.fit_eval_callback``."""
    cbs = [cb for cb in callbacks if cb is not None]

    def composed(epoch: int, params) -> None:
        for cb in cbs:
            cb(epoch, params)

    composed.callbacks = cbs
    return composed


def _cuda_device(params):
    """The CUDA device of the first CUDA tensor among ``params``' leaves
    (a tensor, or a tuple, list or dict of them), or None."""
    if isinstance(params, dict):
        leaves = params.values()
    elif isinstance(params, (tuple, list)):
        leaves = params
    else:
        leaves = (params,)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


def fit_metrics_callback(
    *,
    registry=None,
    clock: Optional[Callable[[], float]] = None,
    objective: Optional[Callable] = None,
    schedule=None,
    n_dims: Optional[int] = None,
    block: int = 1,
    cd_shape: Optional[Tuple[int, int, int]] = None,
    sides: int = 2,
    labels: Optional[dict] = None,
) -> Callable:
    """Registry-backed ``fit`` callback (see module docstring).

    ``schedule``+``n_dims``+``block`` resolve each epoch's block plan via
    ``SweepSchedule.blocks`` (a pure host-side function of the epoch
    index, the same plan the epoch swept), feeding the
    block-visit counters. ``cd_shape=(C, D_pad, k)`` opts into the
    analytic cd_sweep cost accounting (``sides`` sweeps per epoch — 2
    for two-sided models like MF). ``objective(params) -> loss`` records
    the loss trajectory. The callback exposes ``history`` —
    ``[(epoch, seconds, loss | None), ...]``."""
    reg = resolve_registry(registry)
    clk = clock if clock is not None else reg.clock
    inst = dict(labels) if labels else {"instance": next_instance_id()}
    lnames = tuple(inst)
    epoch_h = reg.histogram(
        "train_epoch_seconds", "epoch wall time (fit callback cadence)",
        labels=lnames, buckets=_EPOCH_BUCKETS).labels(**inst)
    block_h = reg.histogram(
        "train_block_seconds_est",
        "epoch time / k_b blocks visited (estimate)",
        labels=lnames, buckets=_EPOCH_BUCKETS).labels(**inst)
    epochs_c = reg.counter(
        "train_epochs_total", "completed epochs", labels=lnames).labels(**inst)
    loss_g = reg.gauge(
        "train_loss", "objective(params) at the last epoch boundary",
        labels=lnames).labels(**inst)
    visits_f = reg.counter(
        "train_block_visits_total",
        "SweepSchedule k_b-block visits by starting dim f0 (one side)",
        labels=lnames + ("f0",))
    costs = KernelCostRecorder(reg)
    state = {"t": clk()}

    def callback(epoch: int, params) -> None:
        device = _cuda_device(params)
        if device is not None:
            torch.cuda.synchronize(device)
        now = clk()
        dt = now - state["t"]
        state["t"] = now
        epoch_h.observe(dt)
        epochs_c.inc()
        plan: Sequence = ()
        if schedule is not None and n_dims:
            plan = schedule.blocks(n_dims, epoch, block)
        elif n_dims:
            plan = tuple(
                (f0, min(block, n_dims - f0))
                for f0 in range(0, n_dims, max(block, 1))
            )
        for f0, _size in plan:
            visits_f.labels(**inst, f0=str(f0)).inc()
        if plan:
            block_h.observe(dt / (sides * len(plan)))
        if cd_shape is not None:
            c_rows, d_pad, k = cd_shape
            costs.record_cd_sweep(
                c_rows, d_pad, k, max(block, 1), sweeps=sides)
        loss = None
        if objective is not None:
            loss = float(objective(params))
            loss_g.set(loss)
        callback.history.append((int(epoch), float(dt), loss))

    callback.history = []
    return callback
