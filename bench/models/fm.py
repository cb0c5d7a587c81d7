"""The program under test for ``"model": "fm"``: ``repro_torch``'s iCD-FM
epoch over the flat interaction log (``core/models/fm.epoch``: per
dimension the field layers of ``mfsi._field_layers``, gathers and
``index_add_`` segment sums in PyTorch), looped as ``fm.fit`` loops it,
carrying the residuals."""
from __future__ import annotations

import torch

from repro_torch.core import design
from repro_torch.core.models import fm
from repro_torch.sparse.interactions import build_interactions

LEAVES = ("b", "w_lin", "w", "h_lin", "h")


def hyper_params(config: dict) -> fm.FMHyperParams:
    keys = ("k", "alpha0", "l2", "l2_lin", "eta", "use_linear", "use_bias",
            "multi_hot_mode", "jacobi_eta", "implementation", "block_k",
            "psi_dispatch")
    return fm.FMHyperParams(**{key: config[key] for key in keys})


class Program:
    def __init__(self, config: dict, inputs, device):
        self.hp = hyper_params(config)
        self.x = design.make_design(inputs.ctx_fields, inputs.n_ctx, device=device)
        self.z = design.make_design(inputs.item_fields, inputs.n_items, device=device)
        self.data = build_interactions(inputs.ctx, inputs.item, inputs.y, inputs.alpha,
                                       inputs.n_ctx, inputs.n_items,
                                       alpha0=config["alpha0"], device=device)
        self.params = fm.FMParams(*(inputs.factors[n] for n in LEAVES))
        self.e = fm.residuals(self.params, self.x, self.z, self.data, self.hp)

    @property
    def nnz(self) -> int:
        return self.data.nnz

    def step(self, weights=None) -> None:
        """One epoch: the window's call."""
        self.params, self.e = fm.epoch(self.params, self.x, self.z, self.data,
                                       self.e, self.hp, weights=weights)

    def leaves(self) -> dict:
        return self.params._asdict()

    def residual(self) -> torch.Tensor:
        """The carried residuals on the observed pairs, (ctx, item) order."""
        return self.e

    def counters(self) -> dict:
        return {"nnz": self.nnz, "p_ctx": self.x.p,
                "p_item": self.z.p,
                "design_entries": sum(f.ids.numel() for f in self.x.fields)}
