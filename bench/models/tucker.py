"""The program under test for ``"model": "tucker"``: ``repro_torch``'s
iCD-Tucker epoch over the flat interaction log (``core/models/tucker.epoch``:
the U and V mode sweeps, the core sweep of k1·k2·k3 scalar steps, the
MF-like item sweep), looped as ``tucker.fit`` loops it, carrying the
residuals. The context is the pair (user, hour): the hours are the
inputs' (``harness/hours``), the pair list the port's
``ctxmf.build_context``."""
from __future__ import annotations

import torch

from repro_torch.core.models import ctxmf, tucker
from repro_torch.sparse.interactions import build_interactions

LEAVES = ("u", "v", "w", "b")


def hyper_params(config: dict) -> tucker.TuckerHyperParams:
    keys = ("k1", "k2", "k3", "alpha0", "l2", "l2_core", "eta", "implementation")
    return tucker.TuckerHyperParams(**{key: config[key] for key in keys})


class Program:
    def __init__(self, config: dict, inputs, device):
        self.hp = hyper_params(config)
        self.tc, pair = ctxmf.build_context(inputs.ctx, inputs.hour, inputs.n_ctx,
                                            inputs.n_buckets, device=device)
        self.data = build_interactions(pair, inputs.item, inputs.y, inputs.alpha,
                                       self.tc.n_ctx, inputs.n_items,
                                       alpha0=config["alpha0"], device=device)
        self.params = tucker.TuckerParams(*(inputs.factors[n] for n in LEAVES))
        self.e = tucker.residuals(self.params, self.tc, self.data)

    @property
    def nnz(self) -> int:
        return self.data.nnz

    def step(self, weights=None) -> None:
        """One epoch: the window's call."""
        self.params, self.e = tucker.epoch(self.params, self.tc, self.data, self.e,
                                           self.hp, weights=weights)

    def leaves(self) -> dict:
        return self.params._asdict()

    def residual(self) -> torch.Tensor:
        """The carried residuals on the observed pairs, (pair, item) order:
        pairs by (user, hour)."""
        return self.e

    def counters(self) -> dict:
        return {"nnz": self.nnz, "pairs": self.tc.n_ctx,
                "core_steps": self.hp.k1 * self.hp.k2 * self.hp.k3}
