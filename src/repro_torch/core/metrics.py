"""Ranking metrics: Recall@K and NDCG@K (port of ``repro.core.metrics``).

The ``*_at_k`` functions take a dense (n_eval_ctx, n_items) score matrix
(small-scale tests and baselines); the ``*_from_topk`` functions take
already-ranked (n, k) id lists, the contract of the streaming path
(``kernels/topk_score`` via ``eval.ranking``). Training items can be
masked out, as in the standard offline protocol.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def topk_items(scores, k: int, exclude_mask=None) -> torch.Tensor:
    """Top-k item ids per row; ``exclude_mask`` True ⇒ never recommend.

    Ties rank in ascending id, as ``lax.top_k`` ranks them (a stable sort:
    ``torch.topk`` promises no tie order). As in the reference, a row with
    fewer than k admissible items still returns real ids for its −inf
    tail."""
    scores = torch.as_tensor(scores)
    if exclude_mask is not None:
        scores = torch.where(torch.as_tensor(exclude_mask, device=scores.device),
                             -torch.inf, scores)
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def recall_from_topk(top_ids, true_items) -> torch.Tensor:
    """Recall@K from (n, k) top-k ids, one held-out item per row (−1
    filler ids never match a real item)."""
    top_ids = torch.as_tensor(top_ids)
    true_items = torch.as_tensor(true_items, device=top_ids.device)
    return torch.mean(
        torch.any(top_ids == true_items[:, None], dim=1).float())


def ndcg_from_topk(top_ids, true_items) -> torch.Tensor:
    """NDCG@K from (n, k) top-k ids, one relevant item ⇒
    DCG = 1/log2(rank+1), IDCG = 1."""
    top_ids = torch.as_tensor(top_ids)
    true_items = torch.as_tensor(true_items, device=top_ids.device)
    k = top_ids.shape[1]
    hits = top_ids == true_items[:, None]
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=top_ids.device)
    gains = torch.where(hits, (1.0 / torch.log2(ranks + 1.0))[None, :], 0.0)
    return torch.mean(torch.sum(gains, dim=1))


def recall_at_k(scores, true_items, k: int, exclude_mask=None) -> torch.Tensor:
    """Recall@K for a single held-out item per context (leave-one-out)."""
    return recall_from_topk(topk_items(scores, k, exclude_mask), true_items)


def ndcg_at_k(scores, true_items, k: int, exclude_mask=None) -> torch.Tensor:
    """NDCG@K, single relevant item ⇒ DCG = 1/log2(rank+1), IDCG = 1."""
    return ndcg_from_topk(topk_items(scores, k, exclude_mask), true_items)


def recall_ndcg_multi(scores: np.ndarray, held_out: list, k: int,
                      exclude_mask: Optional[np.ndarray] = None
                      ) -> Tuple[float, float]:
    """Host-side metrics with a SET of held-out items per context (instant
    and cold-start protocols hold out whole user histories)."""
    scores = np.asarray(scores)
    if exclude_mask is not None:
        scores = np.where(exclude_mask, -np.inf, scores)
    top = np.argpartition(-scores, min(k, scores.shape[1] - 1), axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(scores, top, axis=1), axis=1)
    top = np.take_along_axis(top, order, axis=1)
    recalls, ndcgs = [], []
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    for row, truth in enumerate(held_out):
        truth = set(int(t) for t in truth)
        if not truth:
            continue
        hits = np.fromiter((int(t) in truth for t in top[row]), bool, k)
        recalls.append(hits.sum() / len(truth))
        idcg = discounts[: min(len(truth), k)].sum()
        ndcgs.append((hits * discounts).sum() / idcg)
    return float(np.mean(recalls)), float(np.mean(ndcgs))
