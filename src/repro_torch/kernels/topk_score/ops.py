"""Public wrappers for the fused score + top-K kernel (port of
``repro.kernels.topk_score.ops``).

  * :func:`topk_score` — the fused kernel over one ψ table, or one
    row-range shard of it via ``id_offset``/``n_valid``. A CUDA tensor
    launches the hand-written kernel (``csrc/topk_score.cu``); a CPU tensor
    takes the plain version (``ref.topk_score_ref``).
  * :func:`topk_merge_shards` — the cross-shard merge of per-shard
    candidate lists that already carry global ids. As in the reference it
    is a sort outside any kernel, written in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda, vmem
from repro_torch.kernels.topk_score import kernel
from repro_torch.kernels.topk_score.ref import topk_score_ref


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"topk_score: {msg}")


_PSI_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
_MASK_DTYPES = (torch.bool, torch.int8, torch.uint8)


def topk_score(phi, psi, k: int, exclude_mask=None, *, exclude_ids=None,
               psi_scale=None, id_offset=0, n_valid=None, block_items=None):
    """Fused top-K over the ψ table: ``(scores (B, k) f32, ids (B, k) i32)``.

    ``exclude_ids`` (B, L) int32 is a −1-padded list of GLOBAL excluded ids
    per φ row; ``exclude_mask`` (B, n_rows) bool, int8 or uint8, nonzero ⇒
    excluded, is the dense form (one of the two, not both). Local rows ≥
    ``n_valid`` are inadmissible, ids come back as ``id_offset + local``,
    and slots with no admissible candidate are (−inf, −1). Ties rank in
    ascending id.

    ψ is fp32, bf16, or int8 with its per-row fp32 ``psi_scale`` (n_rows,)
    (``core.quant.int8_quantize_rows``); each stored row is dequantized as
    ``q·scale`` before the fp32 products, as in the reference.

    On CUDA, ``block_items`` is the ψ rows per pass-1 block (a power of
    two; default :func:`~repro_torch.kernels.vmem.topk_block_items`). Any K
    runs; a K whose key buffers exceed the card's free memory raises. The mask may be a column slice
    of a wider mask (its rows are read at their own stride). Nothing falls
    back to the plain version."""
    if exclude_mask is not None and exclude_ids is not None:
        raise ValueError("pass exclude_mask OR exclude_ids, not both")
    if psi.dtype == torch.int8 and psi_scale is None:
        raise ValueError("int8 psi needs psi_scale (per-row dequant scales)")
    if psi_scale is not None and psi_scale.shape[0] != psi.shape[0]:
        raise ValueError(
            f"psi_scale has {psi_scale.shape[0]} rows, psi has {psi.shape[0]}")
    if not on_cuda(phi, psi, exclude_mask, exclude_ids, psi_scale):
        return topk_score_ref(phi, psi, k, exclude_mask,
                              exclude_ids=exclude_ids, psi_scale=psi_scale,
                              id_offset=id_offset, n_valid=n_valid)
    _check(phi.dtype == torch.float32, f"phi must be float32, got {phi.dtype}")
    _check(psi.dtype in _PSI_DTYPES,
           f"psi must be float32, bfloat16 or int8, got {psi.dtype}")
    _check(phi.dim() == 2 and psi.dim() == 2 and phi.shape[1] == psi.shape[1],
           f"phi (B, D) and psi (n_rows, D) disagree: {tuple(phi.shape)} vs "
           f"{tuple(psi.shape)}")
    _check(phi.is_contiguous() and psi.is_contiguous(),
           "phi and psi must be contiguous")
    b, d = phi.shape
    n_rows = psi.shape[0]
    if psi_scale is not None:
        _check(psi_scale.dtype == torch.float32 and psi_scale.dim() == 1
               and psi_scale.is_contiguous(),
               f"psi_scale must be a contiguous float32 (n_rows,) tensor, got "
               f"{psi_scale.dtype} {tuple(psi_scale.shape)}")
    if exclude_ids is not None:
        _check(exclude_ids.dtype == torch.int32,
               f"exclude_ids must be int32, got {exclude_ids.dtype}")
        _check(exclude_ids.dim() == 2 and exclude_ids.shape[0] == b
               and exclude_ids.is_contiguous(),
               f"exclude_ids must be a contiguous (B={b}, L) tensor, got "
               f"{tuple(exclude_ids.shape)}")
    mask, mask_stride = None, 0
    if exclude_mask is not None:
        _check(exclude_mask.dtype in _MASK_DTYPES,
               f"exclude_mask must be bool, int8 or uint8, got "
               f"{exclude_mask.dtype}")
        _check(tuple(exclude_mask.shape) == (b, n_rows),
               f"exclude_mask must be (B={b}, n_rows={n_rows}), got "
               f"{tuple(exclude_mask.shape)}")
        # a column slice of a wider mask is read in place at its row
        # stride; its columns must be adjacent bytes
        _check(n_rows <= 1 or exclude_mask.stride(1) == 1,
               f"exclude_mask columns must be contiguous, got strides "
               f"{exclude_mask.stride()}")
        mask = exclude_mask.view(torch.uint8)
        mask_stride = exclude_mask.stride(0) if b > 1 else n_rows
        _check(b <= 1 or mask_stride >= n_rows,
               f"exclude_mask rows overlap: row stride {mask_stride} < "
               f"{n_rows} columns")
    n_valid = n_rows if n_valid is None else max(0, min(int(n_valid), n_rows))
    id_offset = int(id_offset)
    _check(0 <= id_offset and id_offset + n_rows < 2**31,
           f"global ids must fit int32 (id_offset={id_offset})")
    k_pad = vmem.topk_k_pad(k)
    large_k = k_pad > vmem.TOPK_MAX_CHUNK
    chunk = block_items or vmem.topk_block_items(k_pad, n_items=n_rows)
    lo = 32 if large_k else max(32, k_pad)
    _check(chunk & (chunk - 1) == 0 and lo <= chunk <= vmem.TOPK_MAX_CHUNK,
           f"block_items={chunk} must be a power of two in [{lo}, "
           f"{vmem.TOPK_MAX_CHUNK}]")
    scores = torch.empty((b, k), dtype=torch.float32, device=phi.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=phi.device)
    if b == 0:
        return scores, ids
    _check(b <= 65535, f"B={b} rows exceed one launch's grid")
    n_chunks = -(-n_rows // chunk)
    if not large_k:
        n_level2 = max(1, -(-n_chunks // vmem.TOPK_MERGE_SLOTS))
        cand = torch.empty((n_chunks, b, k_pad), dtype=torch.int64,
                           device=phi.device)
        cand2 = torch.empty((n_level2, b, k_pad), dtype=torch.int64,
                            device=phi.device)
    else:
        keys = vmem.topk_large_k_keys(n_chunks, chunk, k_pad)
        nbytes = 2 * 8 * b * keys
        # free device memory, plus what PyTorch's cache holds unused
        free = (torch.cuda.mem_get_info(phi.device)[0]
                + torch.cuda.memory_reserved(phi.device)
                - torch.cuda.memory_allocated(phi.device))
        if nbytes > free:
            raise RuntimeError(
                f"topk_score: k={k} at B={b} over {n_rows} rows needs "
                f"{nbytes} bytes of candidate keys, more than the {free} "
                f"bytes free on {phi.device}")
        cand, cand2 = (torch.empty((b * keys,), dtype=torch.int64,
                                   device=phi.device) for _ in range(2))
    kernel.launch(phi, psi, psi_scale, exclude_ids, mask, mask_stride, k,
                  k_pad, chunk, id_offset, n_valid, scores, ids, cand, cand2)
    topk_score.launches += 1
    if psi.dtype == torch.bfloat16:
        topk_score.launches_bf16 += 1
    elif psi.dtype == torch.int8:
        topk_score.launches_int8 += 1
    if mask is not None:
        topk_score.launches_mask += 1
    return scores, ids


# CUDA kernel launches (chip_smoke.py reads them): all forms, then the
# bf16-ψ, int8-ψ and dense-mask forms among them
topk_score.launches = 0
topk_score.launches_bf16 = 0
topk_score.launches_int8 = 0
topk_score.launches_mask = 0


def topk_merge_shards(shard_scores, shard_ids, k: int):
    """Cross-shard merge: ``(S, B, Ks) → (B, k)`` scores and ids.

    The shards' row ranges are disjoint and their ids global, so the merge
    is a rank of the S·Ks candidates per row by ``(−score, id)``: a stable
    sort by id, then a stable sort by descending score. That is the
    kernel's policy (ties in ascending global id), so the result does not
    depend on the shard count. Slots at −inf are forced to id −1."""
    s, b, ks = shard_scores.shape
    flat_s = shard_scores.transpose(0, 1).reshape(b, s * ks)
    flat_i = shard_ids.transpose(0, 1).reshape(b, s * ks)
    if k > s * ks:  # fewer candidates than slots: pad inadmissible
        flat_s = torch.nn.functional.pad(flat_s, (0, k - s * ks),
                                         value=float("-inf"))
        flat_i = torch.nn.functional.pad(flat_i, (0, k - s * ks), value=-1)
    by_id = torch.sort(flat_i, dim=1, stable=True)
    by_score = torch.sort(torch.gather(flat_s, 1, by_id.indices), dim=1,
                          descending=True, stable=True)
    scores = by_score.values[:, :k]
    ids = torch.gather(by_id.values, 1, by_score.indices[:, :k])
    ids = torch.where(torch.isneginf(scores), -1, ids)
    return scores, ids.to(torch.int32)
