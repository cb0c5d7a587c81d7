"""End-to-end training driver (port of ``repro.launch.train``).

  python -m repro_torch.launch.train --arch icd-mf --smoke --steps 30 --device cpu
  python -m repro_torch.launch.train --arch icd-fm --smoke --steps 30

Builds the registry config's implicit dataset with the seeded generator
(``repro_torch.data.synthetic``, as the reference does), then runs
``--steps`` iCD-MF epochs, each one ``mf.fit`` call of one epoch, printing
the objective every 5 epochs. Both iCD archs train MF factors of their
config's shape, as in the reference. The generator forms a dense item
similarity matrix, so only ``--smoke`` sizes finish (ROADMAP §3); the loop
itself is :func:`train_loop`, which takes any built
:class:`~repro_torch.sparse.interactions.Interactions`, and
:func:`epoch_step` is the same epoch as a ``Trainer`` step.

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain PyTorch
versions. With no GPU the default raises rather than falling back.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.models import mf
from repro_torch.kernels import resolve_device
from repro_torch.train.train_step import TrainState


def train_loop(params: mf.MFParams, data, hp: mf.MFHyperParams,
               n_epochs: int, *, log_every: int = 5, log=print):
    """The driver's loop: ``n_epochs`` one-epoch ``mf.fit`` calls (each
    starts from freshly computed residuals), the objective every
    ``log_every`` epochs. Returns ``(params, [(epoch, objective), ...])``."""
    objectives = []
    for ep in range(n_epochs):
        params = mf.fit(params, data, hp, 1)
        if (ep + 1) % log_every == 0:
            obj = float(mf.objective(params, data, hp))
            objectives.append((ep + 1, obj))
            log(f"[icd] epoch {ep + 1} objective {obj:.4f}")
    return params, objectives


def epoch_step(data, hp: mf.MFHyperParams):
    """One epoch of :func:`train_loop` as a ``Trainer`` step over a
    :class:`~repro_torch.train.train_step.TrainState` whose ``params`` are
    ``MFParams`` (``opt`` unused); the batch is ignored, the metrics hold
    the epoch's objective."""

    def step(state: TrainState, batch):
        params = mf.fit(state.params, data, hp, 1)
        return (TrainState(params, state.opt, state.step + 1),
                {"objective": mf.objective(params, data, hp)})

    return step


def _icd_main(cfg, args):
    from repro_torch.data.synthetic import make_implicit_dataset
    from repro_torch.sparse.interactions import build_interactions

    device = resolve_device(args.device)
    ds = make_implicit_dataset(n_users=cfg.n_ctx, n_items=cfg.n_items,
                               seed=args.seed)
    ev = ds.events
    hp = mf.MFHyperParams(k=cfg.k, alpha0=cfg.alpha0, l2=cfg.l2)
    data = build_interactions(
        ev[:, 0], ev[:, 1], np.ones(len(ev)), np.full(len(ev), cfg.alpha0 + 2.0),
        cfg.n_ctx, cfg.n_items, alpha0=cfg.alpha0, device=device,
    )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = mf.init(cfg.n_ctx, cfg.n_items, cfg.k, generator=gen)
    return train_loop(params, data, hp, args.steps)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    name = getattr(cfg, "name", args.arch)
    print(f"[train] arch={name} smoke={args.smoke}")
    if not args.arch.startswith("icd"):
        raise SystemExit(f"no training driver for {args.arch!r}; "
                         "registered archs are the iCD configs")
    return _icd_main(cfg, args)


if __name__ == "__main__":
    main()
