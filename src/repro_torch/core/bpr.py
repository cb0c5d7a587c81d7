"""BPR-MF baseline (Rendle et al. [13]) — the paper's main competitor
(port of ``repro.core.bpr``).

Pairwise SGD over sampled (context, consumed item, non-consumed item)
triples: maximize σ(ŷ(c,i⁺) − ŷ(c,i⁻)), with uniform negative sampling,
the baseline the paper refers to.

Minibatched SGD with scatter-add parameter updates, one step per batch.
Collisions inside a batch add up ("hogwild in a batch"), as the
reference's ``.at[ids].add`` does: the port uses ``index_add_``, because
``w[ids] += …`` would keep only one of a repeated id's updates.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.models.mf import MFParams


@dataclasses.dataclass(frozen=True)
class BPRHyperParams:
    k: int
    lr: float = 0.05
    l2: float = 0.002
    batch: int = 4096


def init(n_ctx: int, n_items: int, k: int, *, generator: torch.Generator,
         sigma: float = 0.1) -> MFParams:
    """N(0, σ²) factors on the generator's device (other numbers than the
    reference's key draws; carry its factors over with
    ``mf.params_from_numpy`` to compare)."""
    device = generator.device
    return MFParams(
        w=sigma * torch.randn((n_ctx, k), generator=generator, device=device),
        h=sigma * torch.randn((n_items, k), generator=generator,
                              device=device),
    )


def step(
    params: MFParams,
    ctx: torch.Tensor,   # (B,) sampled contexts with ≥1 positive
    pos: torch.Tensor,   # (B,) consumed item per context
    neg: torch.Tensor,   # (B,) uniformly sampled item (not filtered)
    hp: BPRHyperParams,
) -> Tuple[MFParams, torch.Tensor]:
    """One SGD step; returns new params (``params`` is left as it was) and
    the batch's mean loss."""
    w_c = params.w[ctx]
    h_p = params.h[pos]
    h_n = params.h[neg]
    x = torch.sum(w_c * (h_p - h_n), dim=1)
    sig = torch.sigmoid(-x)  # dL/dx for L = -log σ(x)
    loss = torch.mean(F.softplus(-x))

    # every gradient from the gathered rows, before any update
    g_w = -sig[:, None] * (h_p - h_n) + hp.l2 * w_c
    g_p = -sig[:, None] * w_c + hp.l2 * h_p
    g_n = sig[:, None] * w_c + hp.l2 * h_n

    w = params.w.clone().index_add_(0, ctx, -hp.lr * g_w)
    h = params.h.clone().index_add_(0, pos, -hp.lr * g_p)
    h.index_add_(0, neg, -hp.lr * g_n)
    return MFParams(w, h), loss


def fit(
    params: MFParams,
    ctx_pos: np.ndarray,   # (nnz, 2) observed (context, item) pairs
    n_items: int,
    hp: BPRHyperParams,
    n_steps: int,
    seed: int = 0,
) -> MFParams:
    """``n_steps`` steps over batches drawn by the reference's numpy
    generator calls, so the same seed draws the same batches."""
    rng = np.random.default_rng(seed)
    nnz = len(ctx_pos)
    dev = params.w.device
    for _ in range(n_steps):
        idx = rng.integers(0, nnz, hp.batch)
        neg = rng.integers(0, n_items, hp.batch)
        params, _ = step(
            params,
            torch.as_tensor(ctx_pos[idx, 0], device=dev),
            torch.as_tensor(ctx_pos[idx, 1], device=dev),
            torch.as_tensor(neg, device=dev),
            hp,
        )
    return params
