"""The program under test for ``"model": "mf"``: ``repro_torch``'s iCD-MF
epoch over the flat interaction log (``core/models/mf.epoch``: a gather,
two ``index_add_`` segment sums and a mat-vec a column), looped as
``mf.fit`` loops it (the path of ``launch.train`` and the Model API),
carrying the residuals."""
from __future__ import annotations

import torch

from repro_torch.core.models import mf
from repro_torch.sparse.interactions import build_interactions

LEAVES = ("w", "h")


def hyper_params(config: dict) -> mf.MFHyperParams:
    return mf.MFHyperParams(
        k=config["k"], alpha0=config["alpha0"], l2=config["l2"],
        eta=config["eta"], implementation=config["implementation"],
        block_k=config["block_k"], psi_dispatch=config["psi_dispatch"])


class Program:
    def __init__(self, config: dict, inputs, device):
        self.hp = hyper_params(config)
        self.data = build_interactions(inputs.ctx, inputs.item, inputs.y, inputs.alpha,
                                       inputs.n_ctx, inputs.n_items,
                                       alpha0=config["alpha0"], device=device)
        self.params = mf.MFParams(inputs.factors["w"], inputs.factors["h"])
        self.e = mf.residuals(self.params, self.data)

    @property
    def nnz(self) -> int:
        return self.data.nnz

    def step(self, weights=None) -> None:
        """One epoch: the window's call."""
        self.params, self.e = mf.epoch(self.params, self.data, self.e, self.hp,
                                       weights=weights)

    def leaves(self) -> dict:
        return {"w": self.params.w, "h": self.params.h}

    def residual(self) -> torch.Tensor:
        """The carried residuals on the observed pairs, (ctx, item) order."""
        return self.e

    def counters(self) -> dict:
        return {"nnz": self.nnz}
