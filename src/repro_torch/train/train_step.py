"""Train-step builders: grads (+microbatch accumulation), clip, optimizer
(port of ``repro.train.train_step``).

The returned step is a function (state, batch) → (state, metrics) over
trees of tensors (``repro_torch.optim.base``). Gradients come from
autograd on detached copies of the parameters; microbatch accumulation
splits each batch leaf's leading dimension and sums the microbatches'
fp32 gradients in order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.optim import apply_updates, clip_by_global_norm
from repro_torch.optim.base import OptimizerDef, tree_flatten_with_path, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor


def init_state(params, optimizer: OptimizerDef) -> TrainState:
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32))


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` with respect to every
    leaf of ``params``, by autograd; ``params`` itself is not touched."""
    _, leaves, unflatten = tree_flatten_with_path(params)
    with torch.enable_grad():
        live = [x.detach().requires_grad_(True) for x in leaves]
        loss = loss_fn(unflatten(live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), unflatten(grads)


def build_train_step(
    loss_fn: Callable[[Any, Dict], torch.Tensor],
    optimizer: OptimizerDef,
    num_microbatches: int = 1,
    clip_norm: float = 1.0,
    unroll_microbatches: bool = False,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """loss_fn(params, batch) → scalar. Batch leaves have leading dim B,
    split into ``num_microbatches`` equal chunks when > 1.
    ``unroll_microbatches`` is the reference's switch between a scan and a
    Python loop over the microbatches; here both are the same Python loop,
    and the flag is kept so callers of either package pass the same
    arguments."""
    del unroll_microbatches

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        params = state.params
        if num_microbatches > 1:
            mbs = tree_map(
                lambda x: x.reshape((num_microbatches, -1) + tuple(x.shape[1:])),
                batch)
            loss = torch.zeros((), dtype=torch.float32)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(num_microbatches):
                mb = tree_map(lambda x: x[i], mbs)
                l_i, g_i = value_and_grad(loss_fn, params, mb)
                loss = loss.to(l_i.device) + l_i
                grads = tree_map(lambda a, g: a + g.float(), grads, g_i)
            loss = loss / num_microbatches
            grads = tree_map(lambda g: g / num_microbatches, grads)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)

        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        updates, opt = optimizer.update(grads, state.opt, params)
        params = apply_updates(params, updates)
        new_state = TrainState(params, opt, state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step
