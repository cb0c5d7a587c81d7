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


def topk_score(phi, psi, k: int, exclude_mask=None, *, exclude_ids=None,
               id_offset=0, n_valid=None, block_items=None):
    """Fused top-K over the ψ table: ``(scores (B, k) f32, ids (B, k) i32)``.

    ``exclude_ids`` (B, L) int32 is a −1-padded list of GLOBAL excluded ids
    per φ row; ``exclude_mask`` (B, n_rows) is the dense form, taken only
    by the plain version for now. Local rows ≥ ``n_valid`` are
    inadmissible, ids come back as ``id_offset + local``, and slots with
    no admissible candidate are (−inf, −1). Ties rank in ascending id.

    On CUDA, ``block_items`` is the ψ rows per pass-1 block (a power of
    two; default :func:`~repro_torch.kernels.vmem.topk_block_items`). K
    above 256 takes the kernel's large-K merge, up to
    ``vmem.TOPK_WIDE_MAX_K_PAD`` (8,192). The dense ``exclude_mask`` and
    bf16/int8 ψ raise ``NotImplementedError`` there; nothing falls back to
    the plain version."""
    if not on_cuda(phi, psi, exclude_mask, exclude_ids):
        return topk_score_ref(phi, psi, k, exclude_mask,
                              exclude_ids=exclude_ids, id_offset=id_offset,
                              n_valid=n_valid)
    if exclude_mask is not None:
        raise NotImplementedError(
            "topk_score on CUDA takes exclude_ids; the dense exclude_mask "
            "form is not ported to the kernel yet")
    if psi.dtype != torch.float32:
        raise NotImplementedError(
            f"topk_score on CUDA takes fp32 psi; {psi.dtype} storage is not "
            "ported to the kernel yet")
    _check(phi.dtype == torch.float32, f"phi must be float32, got {phi.dtype}")
    _check(phi.dim() == 2 and psi.dim() == 2 and phi.shape[1] == psi.shape[1],
           f"phi (B, D) and psi (n_rows, D) disagree: {tuple(phi.shape)} vs "
           f"{tuple(psi.shape)}")
    _check(phi.is_contiguous() and psi.is_contiguous(),
           "phi and psi must be contiguous")
    b, d = phi.shape
    n_rows = psi.shape[0]
    if exclude_ids is not None:
        _check(exclude_ids.dtype == torch.int32,
               f"exclude_ids must be int32, got {exclude_ids.dtype}")
        _check(exclude_ids.dim() == 2 and exclude_ids.shape[0] == b
               and exclude_ids.is_contiguous(),
               f"exclude_ids must be a contiguous (B={b}, L) tensor, got "
               f"{tuple(exclude_ids.shape)}")
    n_valid = n_rows if n_valid is None else max(0, min(int(n_valid), n_rows))
    id_offset = int(id_offset)
    _check(0 <= id_offset and id_offset + n_rows < 2**31,
           f"global ids must fit int32 (id_offset={id_offset})")
    k_pad = vmem.topk_k_pad(k)
    chunk = block_items or vmem.topk_block_items(k_pad, n_items=n_rows)
    wide = k_pad > vmem.TOPK_MAX_CHUNK
    lo = 32 if wide else max(32, k_pad)
    _check(chunk & (chunk - 1) == 0 and lo <= chunk <= vmem.TOPK_MAX_CHUNK,
           f"block_items={chunk} must be a power of two in "
           f"[{lo}, {vmem.TOPK_MAX_CHUNK}]")
    _check(k_pad <= vmem.TOPK_WIDE_MAX_K_PAD,
           f"k={k} exceeds the kernel's largest K, {vmem.TOPK_WIDE_MAX_K_PAD}")
    scores = torch.empty((b, k), dtype=torch.float32, device=phi.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=phi.device)
    if b == 0:
        return scores, ids
    _check(b <= 65535, f"B={b} rows exceed one launch's grid")
    n_chunks = -(-n_rows // chunk)
    if wide:
        # pass 1 writes every chunk's keys; a merge level writes at most
        # half what it reads (lists of k_pad ≤ TOPK_WIDE_KEYS / 2 from
        # blocks of TOPK_WIDE_KEYS keys), so each buffer needs as many
        keys = n_chunks * chunk
        cand, cand2 = (torch.empty((b * keys,), dtype=torch.int64,
                                   device=phi.device) for _ in range(2))
    else:
        n_level2 = max(1, -(-n_chunks // vmem.TOPK_MERGE_SLOTS))
        cand = torch.empty((n_chunks, b, k_pad), dtype=torch.int64,
                           device=phi.device)
        cand2 = torch.empty((n_level2, b, k_pad), dtype=torch.int64,
                            device=phi.device)
    kernel.launch(phi, psi, exclude_ids, k, k_pad, chunk, id_offset, n_valid,
                  scores, ids, cand, cand2, wide=wide)
    topk_score.launches += 1
    return scores, ids


topk_score.launches = 0  # CUDA kernel launches (chip_smoke.py reads it)


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
