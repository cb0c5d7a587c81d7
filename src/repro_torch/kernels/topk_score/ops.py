"""Public wrappers for the fused score + top-K kernel (port of
``repro.kernels.topk_score.ops``).

  * :func:`topk_score` — the fused kernel over one ψ table, or one
    row-range shard of it via ``id_offset``/``n_valid``. A CUDA tensor
    launches the hand-written kernel (``csrc/topk_score.cu``): one launch
    for K ≤ 256 (``topk_fused_kernel``), else the chain of pass 1 and
    merge levels; a CPU tensor takes the plain version
    (``ref.topk_score_ref``).
  * :func:`topk_score_ivf` — the same kernel's IVF form: one launch chain
    over the probed clusters of a cluster-contiguous index (plain version
    ``ref.topk_score_ivf_ref``).
  * :func:`topk_merge_shards` — the cross-shard merge of per-shard
    candidate lists that already carry global ids. As in the reference it
    is a sort outside any kernel, written in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda, vmem
from repro_torch.kernels.topk_score import kernel
from repro_torch.kernels.topk_score.ref import (
    topk_score_ivf_ref,
    topk_score_ref,
)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"topk_score: {msg}")


_PSI_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
_MASK_DTYPES = (torch.bool, torch.int8, torch.uint8)


def topk_score(phi, psi, k: int, exclude_mask=None, *, exclude_ids=None,
               psi_scale=None, id_offset=0, n_valid=None, block_items=None,
               form=None):
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

    On CUDA, K ≤ 256 takes one launch (``form="fused"``,
    :func:`~repro_torch.kernels.vmem.topk_form`): blocks walk chunks of
    TOPK_MAX_CHUNK ψ rows, keep each φ row's running list, and the last
    cluster to finish merges and decodes; ``block_items``, if given, must
    be that chunk. ``form="chain"`` runs the three-launch chain the fused
    form replaced (pass 1 over chunks of ``block_items`` rows, a power of
    two, default :func:`~repro_torch.kernels.vmem.topk_block_items`, then
    merge levels), which also serves every K above 256; a K whose key
    buffers exceed the card's free memory raises. Both give the same bits.
    The mask may be a column slice of a wider mask (its rows are read at
    their own stride). Any number of φ rows: above 65,535 they run in
    slices of 65,520, one launch each (:func:`_row_slices`). Nothing falls
    back to the plain version."""
    if exclude_mask is not None and exclude_ids is not None:
        raise ValueError("pass exclude_mask OR exclude_ids, not both")
    form = vmem.topk_form(k, form)
    if psi.dtype == torch.int8 and psi_scale is None:
        raise ValueError("int8 psi needs psi_scale (per-row dequant scales)")
    if psi_scale is not None and psi_scale.shape[0] != psi.shape[0]:
        raise ValueError(
            f"psi_scale has {psi_scale.shape[0]} rows, psi has {psi.shape[0]}")
    if not on_cuda(phi, psi, exclude_mask, exclude_ids, psi_scale):
        return topk_score_ref(phi, psi, k, exclude_mask,
                              exclude_ids=exclude_ids, psi_scale=psi_scale,
                              id_offset=id_offset, n_valid=n_valid)
    _check_phi_psi(phi, psi, psi_scale, exclude_ids)
    b, d = phi.shape
    n_rows = psi.shape[0]
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
    chunk = block_items or vmem.topk_block_items(k_pad)
    lo = 32 if large_k else max(32, k_pad)
    _check(chunk & (chunk - 1) == 0 and lo <= chunk <= vmem.TOPK_MAX_CHUNK,
           f"block_items={chunk} must be a power of two in [{lo}, "
           f"{vmem.TOPK_MAX_CHUNK}]")
    _check(form == vmem.TOPK_CHAIN or chunk == vmem.TOPK_MAX_CHUNK,
           f"block_items={chunk}: the fused form walks chunks of "
           f"{vmem.TOPK_MAX_CHUNK} rows (block_items is the chain's)")
    scores = torch.empty((b, k), dtype=torch.float32, device=phi.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=phi.device)
    for rows in _row_slices(b):
        excl = None if exclude_ids is None else exclude_ids[rows]
        mask_r = None if mask is None else mask[rows]
        n = rows.stop - rows.start
        if form == vmem.TOPK_FUSED:
            n_blocks = vmem.topk_fused_blocks(n_rows, _sm_count(phi.device))
            n_clusters = n_blocks // vmem.TOPK_FUSED_CLUSTER
            cand = None if n_clusters == 1 else torch.empty(
                (n_clusters, n, k_pad), dtype=torch.int64, device=phi.device)
            kernel.launch_fused(phi[rows], psi, psi_scale, excl, mask_r,
                                mask_stride, k, k_pad, n_blocks, id_offset,
                                n_valid, scores[rows], ids[rows], cand,
                                fused_counters(phi.device))
        else:
            n_chunks = -(-n_rows // chunk)
            cand, cand2 = _key_buffers(phi, n, n_chunks, chunk, k, k_pad,
                                       n_rows)
            kernel.launch(phi[rows], psi, psi_scale, excl, mask_r,
                          mask_stride, k, k_pad, chunk, id_offset, n_valid,
                          scores[rows], ids[rows], cand, cand2)
            topk_score.launches_chain += 1
        _count(psi)
        if mask is not None:
            topk_score.launches_mask += 1
    return scores, ids


# One launch (or chain) takes at most 65,535 φ rows: the chain's merge and
# decode grids put the rows on grid.y, and the fused form has a completion
# counter for each block of rows up to that many. A larger batch runs in
# slices of 4,095 row blocks (65,520 rows), one launch each, in order on
# the current stream, each writing its rows of the output; the fused form's
# last cluster leaves its counters at zero, so the next slice finds them
# so. Every row's answer depends on its own φ row alone, so a slice gives
# the bits that a call of those rows alone gives.
_MAX_LAUNCH_ROWS = 65_535
_ROW_SLICE = 4_095 * vmem.TOPK_ROW_BLOCK


def _row_slices(b: int) -> list:
    """The row slices of a B-row call, one launch each: the whole call
    while B ≤ 65,535 (none for B = 0), else slices of 65,520 rows."""
    if b <= _MAX_LAUNCH_ROWS:
        return [slice(0, b)] if b else []
    return [slice(r, min(r + _ROW_SLICE, b)) for r in range(0, b, _ROW_SLICE)]


_SM_COUNT: dict = {}
_COUNTERS: dict = {}


def _sm_count(device) -> int:
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def fused_counters(device) -> torch.Tensor:
    """The fused form's completion counters on ``device``'s current
    stream: one int32 a block of TOPK_ROW_BLOCK φ rows, zeroed once here;
    the cluster that counts last sets its counter back to zero, so every
    call finds them at zero. One array a (device, stream): two streams'
    calls never share a counter, and calls on one stream run in order."""
    dev = torch.device(device)
    stream = torch.cuda.current_stream(dev)
    key = (stream.device.index, stream.cuda_stream)
    if key not in _COUNTERS:
        with torch.cuda.device(stream.device):
            _COUNTERS[key] = torch.zeros(-(-65535 // vmem.TOPK_ROW_BLOCK),
                                         dtype=torch.int32,
                                         device=stream.device)
    return _COUNTERS[key]


# CUDA kernel launches (chip_smoke.py reads them): all forms, then the
# bf16-ψ, int8-ψ, dense-mask and IVF forms among them (an IVF launch is one
# chain: plan, pass 1, merges), and the exact form's three-launch chain
# (K above 256, or named)
topk_score.launches = 0
topk_score.launches_chain = 0
topk_score.launches_bf16 = 0
topk_score.launches_int8 = 0
topk_score.launches_mask = 0
topk_score.launches_ivf = 0


def _count(psi) -> None:
    topk_score.launches += 1
    if psi.dtype == torch.bfloat16:
        topk_score.launches_bf16 += 1
    elif psi.dtype == torch.int8:
        topk_score.launches_int8 += 1


def _check_phi_psi(phi, psi, psi_scale, exclude_ids) -> None:
    _check(phi.dtype == torch.float32, f"phi must be float32, got {phi.dtype}")
    _check(psi.dtype in _PSI_DTYPES,
           f"psi must be float32, bfloat16 or int8, got {psi.dtype}")
    _check(phi.dim() == 2 and psi.dim() == 2 and phi.shape[1] == psi.shape[1],
           f"phi (B, D) and psi (n_rows, D) disagree: {tuple(phi.shape)} vs "
           f"{tuple(psi.shape)}")
    _check(phi.is_contiguous() and psi.is_contiguous(),
           "phi and psi must be contiguous")
    if psi_scale is not None:
        _check(psi_scale.dtype == torch.float32 and psi_scale.dim() == 1
               and psi_scale.is_contiguous(),
               f"psi_scale must be a contiguous float32 (n_rows,) tensor, got "
               f"{psi_scale.dtype} {tuple(psi_scale.shape)}")
    if exclude_ids is not None:
        _check(exclude_ids.dtype == torch.int32,
               f"exclude_ids must be int32, got {exclude_ids.dtype}")
        _check(exclude_ids.dim() == 2 and exclude_ids.shape[0] == phi.shape[0]
               and exclude_ids.is_contiguous(),
               f"exclude_ids must be a contiguous (B={phi.shape[0]}, L) "
               f"tensor, got {tuple(exclude_ids.shape)}")


def _key_buffers(phi, b: int, n_lists: int, chunk: int, k: int, k_pad: int,
                 n_rows: int):
    """The two candidate-key buffers of the merge levels over ``n_lists``
    pass-1 lists (``kernel.launch``)."""
    if k_pad <= chunk:
        n_level2 = max(1, -(-n_lists // vmem.TOPK_MERGE_SLOTS))
        return (torch.empty((n_lists, b, k_pad), dtype=torch.int64,
                            device=phi.device),
                torch.empty((n_level2, b, k_pad), dtype=torch.int64,
                            device=phi.device))
    keys = vmem.topk_large_k_keys(n_lists, chunk, k_pad)
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
    return tuple(torch.empty((b * keys,), dtype=torch.int64,
                             device=phi.device) for _ in range(2))


def topk_score_ivf(phi, psi, k: int, *, probe_mask, counts, ids_global,
                   block_rows: int, exclude_ids=None, psi_scale=None,
                   max_lists=None, block_items=None):
    """Top-K over the probed clusters of an IVF index: ``(scores (B, k)
    f32, ids (B, k) i32)``, ids GLOBAL.

    ``psi`` (C·block_rows, D) holds C cluster-contiguous blocks in fp32,
    bf16 or int8 (with its per-row ``psi_scale``); ``ids_global``
    (C·block_rows,) int32 maps each row to its global id; ``counts`` (C,)
    int32 holds each block's valid rows; ``probe_mask`` (B, C) bool or
    uint8 is nonzero where a φ row probed a cluster; ``exclude_ids`` (B, L)
    int32 lists GLOBAL ids. Order: descending score, ties in ascending
    global id; (−inf, −1) where nothing is admissible
    (``ref.topk_score_ivf_ref``).

    On CUDA it is one launch chain whatever the probe: the plan (the
    probed clusters' (cluster, chunk) list, built on the device), pass 1
    over that list only, the merges. ``max_lists`` bounds the list (default
    C·⌈block_rows/chunk⌉; a caller that knows the counts on the host may
    pass Σ⌈count/chunk⌉); ``block_items`` is the chunk (default
    TOPK_MAX_CHUNK). Above 65,535 φ rows the chain runs once a slice of
    65,520 rows, as :func:`topk_score`'s does. Nothing is copied to the
    host."""
    if psi.dtype == torch.int8 and psi_scale is None:
        raise ValueError("int8 psi needs psi_scale (per-row dequant scales)")
    if not on_cuda(phi, psi, probe_mask, counts, ids_global, exclude_ids,
                   psi_scale):
        return topk_score_ivf_ref(
            phi, psi, k, probe_mask=probe_mask, counts=counts,
            ids_global=ids_global, block_rows=block_rows,
            exclude_ids=exclude_ids, psi_scale=psi_scale)
    _check_phi_psi(phi, psi, psi_scale, exclude_ids)
    b = phi.shape[0]
    n_rows = psi.shape[0]
    block_rows = int(block_rows)
    c = probe_mask.shape[1] if probe_mask.dim() == 2 else -1
    _check(block_rows >= 1 and c >= 1 and n_rows == c * block_rows,
           f"psi has {n_rows} rows, not n_clusters={c} blocks of "
           f"{block_rows}")
    _check(tuple(probe_mask.shape) == (b, c) and probe_mask.is_contiguous()
           and probe_mask.dtype in _MASK_DTYPES,
           f"probe_mask must be a contiguous bool/int8/uint8 (B={b}, C) "
           f"tensor, got {probe_mask.dtype} {tuple(probe_mask.shape)}")
    _check(counts.dtype == torch.int32 and tuple(counts.shape) == (c,)
           and counts.is_contiguous(),
           f"counts must be a contiguous int32 ({c},) tensor")
    _check(ids_global.dtype == torch.int32
           and tuple(ids_global.shape) == (n_rows,)
           and ids_global.is_contiguous(),
           f"ids_global must be a contiguous int32 ({n_rows},) tensor")
    _check(psi_scale is None or psi_scale.shape[0] == n_rows,
           f"psi_scale must have {n_rows} rows")
    k_pad = vmem.topk_k_pad(k)
    chunk = block_items or vmem.TOPK_MAX_CHUNK
    _check(chunk & (chunk - 1) == 0 and 32 <= chunk <= vmem.TOPK_MAX_CHUNK
           and (chunk >= k_pad or k_pad > vmem.TOPK_MAX_CHUNK),
           f"block_items={chunk} must be a power of two in "
           f"[{max(32, k_pad) if k_pad <= vmem.TOPK_MAX_CHUNK else 32}, "
           f"{vmem.TOPK_MAX_CHUNK}]")
    bound = c * -(-block_rows // chunk)
    max_lists = bound if max_lists is None else int(max_lists)
    _check(1 <= max_lists <= bound,
           f"max_lists={max_lists} must be in [1, {bound}]")
    scores = torch.empty((b, k), dtype=torch.float32, device=phi.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=phi.device)
    probe = probe_mask.view(torch.uint8)
    for rows in _row_slices(b):
        n = rows.stop - rows.start
        plan = torch.empty((max_lists + 1,), dtype=torch.int32,
                           device=phi.device)
        cand, cand2 = _key_buffers(phi, n, max_lists, chunk, k, k_pad, n_rows)
        kernel.launch_ivf(phi[rows], psi, psi_scale,
                          None if exclude_ids is None else exclude_ids[rows],
                          ids_global, counts, probe[rows], block_rows, k,
                          k_pad, chunk, max_lists, scores[rows], ids[rows],
                          plan, cand, cand2)
        _count(psi)
        topk_score.launches_ivf += 1
    return scores, ids


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
