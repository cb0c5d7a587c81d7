"""Streaming full-catalogue ranking evaluation, leave-one-out protocol
(port of ``repro.eval.ranking``).

For every held-out (context, item) pair, rank all n_items and score
Recall@K / NDCG@K of the true item, without the (n_eval, n_items) score
matrix: evaluation contexts stream in batches of ``batch_rows`` φ rows
through the fused top-K kernel (``kernels/topk_score``, the CUDA kernel on
the card), with each row's training items excluded through the kernel's
id-list form. The per-row metric math is shared with the dense path
(``core.metrics.*_from_topk``).

``cluster=`` runs the same loop against a sharded table or the
fault-tolerant mesh (``serve/mesh.py``); the metrics then carry its
``coverage`` and ``dead_ranges``. :func:`ann_recall_curve` holds an IVF
index (``serve/ann.py``) against the exact kernel. ``foldin_ranking_eval``
and ``model_eval_callback`` are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.metrics import ndcg_from_topk, recall_from_topk
from repro_torch.kernels.topk_score.ops import topk_score
from repro_torch.serve.engine import exclude_ids_from_lists


def ranking_eval(phi: torch.Tensor, psi: Optional[torch.Tensor], true_items,
                 *, k: int = 100, batch_rows: int = 256,
                 exclude: Optional[Sequence] = None,
                 block_items: Optional[int] = None,
                 cluster=None) -> Dict[str, float]:
    """Leave-one-out Recall@K / NDCG@K over the full catalogue, streamed.

    ``phi`` (n_eval, D) holds the eval contexts' φ rows and ``psi`` the
    (n_items, D) table (None with ``cluster=``); everything runs on φ's
    device. ``exclude`` is a length-``n_eval`` sequence of per-row item-id
    arrays (each row's training items)."""
    n_eval = int(phi.shape[0])
    dev = phi.device
    true_items = torch.as_tensor(np.asarray(true_items), dtype=torch.int32,
                                 device=dev)
    recall_sum = 0.0
    ndcg_sum = 0.0
    coverage = 1.0
    dead_ranges: set = set()
    for lo in range(0, n_eval, batch_rows):
        hi = min(lo + batch_rows, n_eval)
        eids = None
        if exclude is not None:
            eids = exclude_ids_from_lists(exclude[lo:hi], device=dev)
        if cluster is not None:
            res = cluster.topk_phi(phi[lo:hi], k=k, exclude_ids=eids)
            top_ids = res.ids if hasattr(res, "ids") else res[1]
            coverage = min(coverage, float(getattr(res, "coverage", 1.0)))
            dead_ranges.update(getattr(res, "dead_ranges", ()))
        else:
            _, top_ids = topk_score(phi[lo:hi], psi, k, exclude_ids=eids,
                                    block_items=block_items)
        truth = true_items[lo:hi]
        b = hi - lo
        recall_sum += float(recall_from_topk(top_ids, truth)) * b
        ndcg_sum += float(ndcg_from_topk(top_ids, truth)) * b
    return {
        f"recall@{k}": recall_sum / max(1, n_eval),
        f"ndcg@{k}": ndcg_sum / max(1, n_eval),
        "k": k,
        "n_eval": n_eval,
        "coverage": coverage,
        "dead_ranges": tuple(sorted(dead_ranges)),
    }


def overlap_recall(approx_ids, oracle_ids) -> float:
    """Mean fraction of the exact oracle's admissible top-K that an
    approximate retriever found; −1 oracle slots are ignored and rows with
    an empty oracle list count as fully recalled."""
    approx_ids = np.asarray(torch.as_tensor(approx_ids).cpu())
    oracle_ids = np.asarray(torch.as_tensor(oracle_ids).cpu())
    total, hit = 0, 0
    for r in range(oracle_ids.shape[0]):
        truth = set(int(i) for i in oracle_ids[r] if i >= 0)
        if not truth:
            continue
        total += len(truth)
        hit += len(truth & set(int(i) for i in approx_ids[r]))
    return hit / total if total else 1.0


def ann_recall_curve(index, phi: torch.Tensor, psi: torch.Tensor, *,
                     k: int = 100, n_probes: Sequence[int] = (1, 2, 4, 8),
                     exclude: Optional[Sequence] = None) -> list:
    """Recall-vs-probe curve of one :class:`~repro_torch.serve.ann.PsiIndex`:
    for each ``n_probe``, :func:`overlap_recall` of the index's top-K
    against the exact kernel over the (n_items, D) table ``psi``, on φ's
    device. ``exclude`` takes the same per-row id lists as
    :func:`ranking_eval`."""
    eids = None
    if exclude is not None:
        eids = exclude_ids_from_lists(exclude, device=phi.device)
    _, oracle = topk_score(phi, psi, k, exclude_ids=eids)
    out = []
    for p in n_probes:
        _, ids = index.topk(phi, k, n_probe=int(p), exclude_ids=eids)
        out.append({"n_probe": int(p),
                    f"recall@{k}": overlap_recall(ids, oracle)})
    return out


def fit_eval_callback(export: Callable, true_items, *, k: int = 100,
                      every: int = 1, exclude: Optional[Sequence] = None,
                      batch_rows: int = 256,
                      log: Optional[Callable[[str], None]] = None):
    """Adapt :func:`ranking_eval` to the models' ``fit(callback=...)``
    hook. ``export(params)`` returns ``(phi_eval, psi_table)``; the
    callback appends one metrics dict per evaluated epoch to its
    ``history``."""
    history: list = []

    def callback(epoch: int, params) -> None:
        if epoch % every:
            return
        phi_eval, psi_table = export(params)
        res = ranking_eval(phi_eval, psi_table, true_items, k=k,
                           exclude=exclude, batch_rows=batch_rows)
        res = {"epoch": epoch, **res}
        history.append(res)
        if log is not None:
            log(f"epoch {epoch}: recall@{k}={res[f'recall@{k}']:.4f} "
                f"ndcg@{k}={res[f'ndcg@{k}']:.4f}")

    callback.history = history
    return callback
