"""Mixed-precision optimizer wrapper (port of ``repro.optim.mixed``).

Live parameters stay bf16; the fp32 master copy lives INSIDE the optimizer
state. One step:

    grads(bf16) ──clip──► inner.update on fp32 master
    master += updates;  params_delta = master.to(bf16) − params

Its purpose is a ZeRO-1 schedule over a data × model mesh: the master
and moments keep the 'data' sharding while the live params drop it
(``launch.sharding.zero1_state_specs``). On one device it is the same
arithmetic.
"""
from __future__ import annotations

from repro_torch.optim.base import OptimizerDef, apply_updates, tree_map


def mixed_precision(inner: OptimizerDef) -> OptimizerDef:
    def init(params):
        master = tree_map(lambda p: p.float(), params)
        return {"master": master, "inner": inner.init(master)}

    def update(grads, state, params):
        upd, inner_state = inner.update(grads, state["inner"], state["master"])
        master = apply_updates(state["master"], upd)
        delta = tree_map(lambda m, p: m.to(p.dtype) - p, master, params)
        return delta, {"master": master, "inner": inner_state}

    return OptimizerDef(init, update)
