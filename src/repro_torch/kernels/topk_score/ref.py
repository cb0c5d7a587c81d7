"""Plain PyTorch versions of the fused score + top-K kernel (port of
``repro.kernels.topk_score.ref``).

Same semantics as the kernel: descending score with ties in ascending id,
and (−inf, −1) in every slot no admissible candidate fills.
``torch.topk`` promises no order among ties, so both functions rank with
``torch.sort(..., stable=True)`` over rows laid out in ascending id.

- :func:`topk_score_ref` materializes the full ``(B, n_rows)`` score
  matrix the kernel exists to avoid. It is the plain version that
  ``ops.topk_score`` runs for CPU tensors and the one ``chip_smoke.py``
  holds the kernel against on the card. It also takes the shard meta
  (``id_offset``, ``n_valid``) the kernel takes.
- :func:`topk_score_ivf_ref` is the IVF form's plain version: the same
  ranking over the probed clusters' valid rows of an IVF index, by global
  id.
- :func:`retrieval_topk` is the chunked running-reduce over an arbitrary
  ``score_fn``: it never holds all scores at once.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def exclude_ids_to_mask(exclude_ids, n_items: int, *, id_offset: int = 0):
    """Dense (B, n_items) bool mask from −1-padded per-row global id
    lists, over the ids ``[id_offset, id_offset + n_items)``."""
    ids = torch.as_tensor(exclude_ids).long()
    local = ids - int(id_offset)
    hit = (ids >= 0) & (local >= 0) & (local < n_items)
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
    mask = torch.zeros((ids.shape[0], n_items), dtype=torch.bool,
                       device=ids.device)
    mask[rows[hit], local[hit]] = True
    return mask


def dequantize_psi(psi, psi_scale=None) -> torch.Tensor:
    """The fp32 table the kernel scores against: bf16 and int8 storage
    cast to fp32, then, with ``psi_scale`` (n_rows,), each row multiplied
    by its scale (int8's per-row form), element by element."""
    psi = psi.float()
    if psi_scale is not None:
        psi = psi * psi_scale.float()[:, None]
    return psi


def topk_score_ref(phi, psi, k: int, exclude_mask=None, *, exclude_ids=None,
                   psi_scale=None, id_offset: int = 0, n_valid=None):
    """Dense top-K with the kernel's semantics: ``(scores (B, k) f32,
    ids (B, k) i32)``. ``exclude_mask`` (B, n_rows) nonzero and
    ``exclude_ids`` (B, L) global ids are the two exclusion forms; local
    rows ≥ ``n_valid`` are inadmissible and ids are ``id_offset + local``.
    ψ may be fp32, bf16, or int8 with its per-row ``psi_scale``
    (:func:`dequantize_psi`)."""
    n_rows = psi.shape[0]
    n_valid = n_rows if n_valid is None else max(0, min(int(n_valid), n_rows))
    scores = phi.float() @ dequantize_psi(psi, psi_scale).T
    if exclude_ids is not None:
        if exclude_mask is not None:
            raise ValueError("pass exclude_mask OR exclude_ids, not both")
        exclude_mask = exclude_ids_to_mask(exclude_ids, n_rows,
                                           id_offset=id_offset)
    inadmissible = torch.arange(n_rows, device=scores.device) >= n_valid
    if exclude_mask is not None:
        inadmissible = inadmissible | (exclude_mask != 0)
    scores = scores.masked_fill(inadmissible, float("-inf"))
    if k > n_rows:  # more slots than rows: the tail is inadmissible
        scores = torch.nn.functional.pad(scores, (0, k - n_rows),
                                         value=float("-inf"))
    top = torch.sort(scores, dim=1, descending=True, stable=True)
    top_s = top.values[:, :k]
    top_i = torch.where(torch.isneginf(top_s), -1,
                        top.indices[:, :k] + int(id_offset))
    return top_s, top_i.to(torch.int32)


def topk_score_ivf_ref(phi, psi, k: int, *, probe_mask, counts, ids_global,
                       block_rows: int, exclude_ids=None, psi_scale=None):
    """The IVF form's function over an index of C cluster-contiguous
    blocks of ``block_rows`` rows: ``(scores (B, k) f32, ids (B, k) i32)``.

    A (φ row, stored row) pair is admissible when the row probed the row's
    cluster (``probe_mask`` (B, C) nonzero), the row's slot is below its
    cluster's ``counts`` entry and its global id (``ids_global``) is not in
    the φ row's −1-padded ``exclude_ids``. The result is the K best
    admissible pairs in descending score, ties in ascending GLOBAL id, and
    (−inf, −1) in every slot no admissible pair fills. It scores the whole
    table (the kernel scores the probed blocks' valid rows only)."""
    n_rows = psi.shape[0]
    dev = phi.device
    scores = phi.float() @ dequantize_psi(psi, psi_scale).T
    slot = torch.arange(n_rows, device=dev)
    cl = slot // int(block_rows)
    counts = torch.as_tensor(counts, device=dev).long()
    admissible = ((slot - cl * int(block_rows)) < counts[cl])[None, :] \
        & (torch.as_tensor(probe_mask, device=dev) != 0)[:, cl]
    gid = ids_global.long()
    if exclude_ids is not None:
        ex = torch.as_tensor(exclude_ids, device=dev).long()
        for r in range(ex.shape[0]):
            admissible[r] &= ~torch.isin(gid, ex[r][ex[r] >= 0])
    scores = scores.masked_fill(~admissible, float("-inf"))
    if k > n_rows:  # more slots than rows: the tail is inadmissible
        scores = torch.nn.functional.pad(scores, (0, k - n_rows),
                                         value=float("-inf"))
        gid = torch.nn.functional.pad(gid, (0, k - n_rows), value=-1)
    # rank by (−score, global id): a stable sort by id, then a stable sort
    # by descending score
    by_id = torch.sort(gid, stable=True)
    top = torch.sort(scores[:, by_id.indices], dim=1, descending=True,
                     stable=True)
    top_s = top.values[:, :k]
    top_i = by_id.values[top.indices[:, :k]]
    top_i = torch.where(torch.isneginf(top_s), -1, top_i)
    return top_s, top_i.to(torch.int32)


def retrieval_topk(
    score_fn: Callable[[torch.Tensor], torch.Tensor],  # cand_ids → scores
    n_candidates: int,
    k: int = 100,
    chunk: int = 262144,
    *,
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over ``n_candidates`` scored in chunks with a running reduce.

    ``score_fn(ids)`` may return ``(chunk,)`` (one query) or ``(B, chunk)``
    (batched). Slots with no real candidate stay (−inf, −1). Ties resolve
    toward the smaller id: the running state sits before each new chunk
    and the sort is stable, the same policy as the kernel."""
    best_scores = best_ids = None
    for lo in range(0, n_candidates, chunk):
        ids = torch.arange(lo, min(lo + chunk, n_candidates),
                           dtype=torch.int32, device=device)
        scores = score_fn(ids)
        if best_scores is None:  # the first chunk fixes the batch dims
            lead = tuple(scores.shape[:-1])
            best_scores = torch.full(lead + (k,), float("-inf"),
                                     dtype=scores.dtype, device=scores.device)
            best_ids = torch.full(lead + (k,), -1, dtype=torch.int32,
                                  device=scores.device)
        merged_s = torch.cat([best_scores, scores], dim=-1)
        merged_i = torch.cat([best_ids, ids.expand(scores.shape)], dim=-1)
        if merged_s.shape[-1] < k:
            pad = k - merged_s.shape[-1]
            merged_s = torch.nn.functional.pad(merged_s, (0, pad),
                                               value=float("-inf"))
            merged_i = torch.nn.functional.pad(merged_i, (0, pad), value=-1)
        top = torch.sort(merged_s, dim=-1, descending=True, stable=True)
        best_scores = top.values[..., :k]
        best_ids = torch.gather(merged_i, -1, top.indices[..., :k])
    if best_scores is None:  # n_candidates == 0
        best_scores = torch.full((k,), float("-inf"), device=device)
        best_ids = torch.full((k,), -1, dtype=torch.int32, device=device)
    return best_scores, best_ids
