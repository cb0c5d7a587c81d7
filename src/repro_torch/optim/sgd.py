"""SGD with (Nesterov) momentum (port of ``repro.optim.sgd``)."""
from __future__ import annotations

import torch

from repro_torch.optim.base import OptimizerDef, tree_map


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> OptimizerDef:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        mom = (
            tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            if momentum else None
        )
        return {"step": torch.zeros((), dtype=torch.int32), "mom": mom}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.float(),
                           state["mom"], grads)
            if nesterov:
                upd = tree_map(lambda m, g: -(lr_t * (momentum * m + g.float())),
                               mom, grads)
            else:
                upd = tree_map(lambda m: -lr_t * m, mom)
            return upd, {"step": step, "mom": mom}
        upd = tree_map(lambda g: -lr_t * g.float(), grads)
        return upd, {"step": step, "mom": None}

    return OptimizerDef(init, update)
