"""Adafactor (Shazeer & Stern) — factored second moments (port of
``repro.optim.adafactor``).

Matrices keep row/col RMS statistics instead of the full (shape)-sized v,
cutting optimizer memory from 2× to ~1.01× of the parameters.
"""
from __future__ import annotations

import torch

from repro_torch.optim.base import (
    OptimizerDef,
    tree_flatten_up_to,
    tree_flatten_with_path,
    tree_leaves,
    tree_map,
)


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor(lr=None, decay=0.8, eps=1e-30, clip_threshold=1.0,
              eps_scale=1e-3) -> OptimizerDef:
    """lr=None ⇒ canonical relative step sizing
    ``max(eps_scale, RMS(param)) · min(1e-2, 1/√t)`` (Shazeer & Stern §9) —
    Adafactor's normalized updates stay O(1) near the optimum, so a constant
    lr oscillates; the 1/√t decay is part of the algorithm."""
    if lr is None:
        lr_fn = None
    else:
        lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        def state_for(p):
            if _factored(p.shape):
                return {
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),       # row
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device),
                }
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return {"step": torch.zeros((), dtype=torch.int32),
                "v": tree_map(state_for, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        beta = 1.0 - (step.float() + 1) ** (-decay)

        def lr_for(p):
            if lr_fn is not None:
                return lr_fn(step)
            rms_p = torch.sqrt(torch.mean(torch.square(p.float())))
            rel = torch.clamp(1.0 / torch.sqrt(step.float()), max=1e-2)
            return torch.clamp(rms_p, min=eps_scale) * rel

        def upd(g, s, p):
            lr_t = lr_for(p)
            g = g.float()
            g2 = torch.square(g) + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps)
                v_est = vr[..., None] * vc[..., None, :] / denom[..., None]
                u = g * torch.rsqrt(v_est + eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                new_s = {"v": v}
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            return -lr_t * u, new_s

        _, flat_g, unflatten = tree_flatten_with_path(grads)
        flat_s = tree_flatten_up_to(grads, state["v"])
        flat_p = tree_leaves(params)
        outs = [upd(g, s, p) for g, s, p in zip(flat_g, flat_s, flat_p)]
        updates = unflatten([o[0] for o in outs])
        new_v = unflatten([o[1] for o in outs])
        return updates, {"step": step, "v": new_v}

    return OptimizerDef(init, update)
