"""AdamW with decoupled weight decay and bias correction (port of
``repro.optim.adam``)."""
from __future__ import annotations

import torch

from repro_torch.optim.base import OptimizerDef, tree_map


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> OptimizerDef:
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return {
            "step": torch.zeros((), dtype=torch.int32),
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
        }

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()

        def upd(m_, v_, p):
            u = -(lr_t * (m_ / c1) / (torch.sqrt(v_ / c2) + eps))
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            return u

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return OptimizerDef(init, update)
