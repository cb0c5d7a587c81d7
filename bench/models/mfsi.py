"""The program under test for ``"model": "mfsi"``: ``repro_torch``'s
iCD-MFSI epoch over the flat interaction log (``core/models/mfsi.epoch``:
per dimension the sorted moment sums, then the field layers of
``mfsi._field_layers``, each a Newton step by the hand-written kernels of
``kernels/mfsi_layer`` over the design and a residual patch over nnz),
looped as ``mfsi.fit`` loops it, carrying the residuals."""
from __future__ import annotations

import torch

from repro_torch.core import design
from repro_torch.core.models import mfsi
from repro_torch.sparse.interactions import build_interactions

LEAVES = ("w", "h")


def hyper_params(config: dict) -> mfsi.MFSIHyperParams:
    keys = ("k", "alpha0", "l2", "eta", "multi_hot_mode", "jacobi_eta",
            "implementation", "block_k", "psi_dispatch")
    return mfsi.MFSIHyperParams(**{key: config[key] for key in keys})


class Program:
    def __init__(self, config: dict, inputs, device):
        self.hp = hyper_params(config)
        self.x = design.make_design(inputs.ctx_fields, inputs.n_ctx, device=device)
        self.z = design.make_design(inputs.item_fields, inputs.n_items, device=device)
        self.data = build_interactions(inputs.ctx, inputs.item, inputs.y, inputs.alpha,
                                       inputs.n_ctx, inputs.n_items,
                                       alpha0=config["alpha0"], device=device)
        self.params = mfsi.MFSIParams(*(inputs.factors[n] for n in LEAVES))
        self.e = mfsi.residuals(self.params, self.x, self.z, self.data)

    @property
    def nnz(self) -> int:
        return self.data.nnz

    def step(self, weights=None) -> None:
        """One epoch: the window's call."""
        self.params, self.e = mfsi.epoch(self.params, self.x, self.z, self.data,
                                         self.e, self.hp, weights=weights)

    def leaves(self) -> dict:
        return self.params._asdict()

    def residual(self) -> torch.Tensor:
        """The carried residuals on the observed pairs, (ctx, item) order."""
        return self.e

    def counters(self) -> dict:
        out = {"nnz": self.nnz, "p_ctx": self.x.p, "p_item": self.z.p}
        for side, d in (("ctx", self.x), ("item", self.z)):
            out[f"design_entries_{side}"] = sum(f.ids.numel() for f in d.fields)
            out[f"field_layers_{side}"] = len(mfsi._field_layers(d, self.hp))
        return out
