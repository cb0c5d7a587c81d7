"""Bind the hand-written CUDA top-K kernel (``csrc/topk_score.cu``): the
exact form in one launch (:func:`launch_fused`), the three-launch chain it
replaced and that K above 256 takes (:func:`launch`), and the IVF form
(:func:`launch_ivf`).

The source is built by :mod:`repro_torch.kernels.build` at the first
launch, with the tile sizes of :mod:`repro_torch.kernels.vmem` passed as
``-D`` flags, and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import vmem
from repro_torch.kernels.build import CudaLibrary


def _bind(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.topk_score_run.argtypes = [p, p, i, p, p, i, p, ll,
                                   i, i, i, i, i, i, i, i, ll,
                                   p, p, p, p, p]
    lib.topk_score_run.restype = i
    lib.topk_score_ivf_run.argtypes = [p, p, i, p, p, i, p, p, p, i, i,
                                       i, i, i, i, i, i, ll, p, p, p, p, p,
                                       p, p]
    lib.topk_score_ivf_run.restype = i
    lib.topk_score_fused_run.argtypes = [p, p, i, p, p, i, p, ll,
                                         i, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.topk_score_fused_run.restype = i


# ψ storage type codes of the C entry point
PSI_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


DEFINES = {
    "TOPK_ROWS": vmem.TOPK_ROW_BLOCK,
    "TOPK_DSLAB": vmem.TOPK_D_SLAB,
    "TOPK_MAX_CHUNK": vmem.TOPK_MAX_CHUNK,
    "TOPK_MERGE_SLOTS": vmem.TOPK_MERGE_SLOTS,
    "TOPK_MERGE_THREADS": vmem.TOPK_MERGE_THREADS,
    "TOPK_FUSED_THREADS": vmem.TOPK_FUSED_THREADS,
    "TOPK_FUSED_MIN_BLOCKS": vmem.TOPK_FUSED_MIN_BLOCKS,
    "TOPK_FUSED_CLUSTER": vmem.TOPK_FUSED_CLUSTER,
    "TOPK_FUSED_EXCL_STAGE": vmem.TOPK_FUSED_EXCL_STAGE,
}

LIB = CudaLibrary(
    "topk_score", Path(__file__).resolve().parent / "csrc" / "topk_score.cu",
    defines=DEFINES, bind=_bind,
)


def _ptr(t):
    return None if t is None or t.numel() == 0 else t.data_ptr()


def launch(phi: torch.Tensor, psi: torch.Tensor, psi_scale, exclude_ids,
           mask, mask_stride: int, k: int, k_pad: int, chunk: int,
           id_offset: int, n_valid: int, scores: torch.Tensor,
           ids: torch.Tensor, cand: torch.Tensor, cand2: torch.Tensor) -> None:
    """Enqueue the three-launch chain on the current stream: pass 1 over
    chunks of ``chunk`` rows, then the merge levels. With ``chunk ≥
    k_pad``, ``cand`` holds (chunks, B, k_pad) candidate keys and
    ``cand2`` (⌈chunks/16⌉, B, k_pad), the merge levels' other buffer;
    with ``chunk < k_pad`` (large K), each holds ``cand.numel() / B`` keys
    a φ row (``vmem.topk_large_k_keys``). ``mask`` is a uint8 (B, n_rows)
    view whose rows lie ``mask_stride`` bytes apart. The caller has
    checked every shape, dtype, device and stride (``ops.topk_score``)."""
    lib = LIB.load()
    b, d = phi.shape
    n_rows = psi.shape[0]
    n_excl = 0 if exclude_ids is None else exclude_ids.shape[1]
    # the launches go to the current device, which is φ's only for the
    # call: the caller's current device is left as it was
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = lib.topk_score_run(
            phi.data_ptr(), _ptr(psi), PSI_TYPES[psi.dtype], _ptr(psi_scale),
            _ptr(exclude_ids), n_excl, _ptr(mask), mask_stride,
            b, n_rows, d, id_offset, n_valid, k, k_pad, chunk,
            cand.numel() // b, _ptr(cand), _ptr(cand2), scores.data_ptr(),
            ids.data_ptr(), stream)
    LIB.check(rc, "topk_score")


def launch_ivf(phi: torch.Tensor, psi: torch.Tensor, psi_scale, exclude_ids,
               ids_global: torch.Tensor, counts: torch.Tensor,
               probe: torch.Tensor, block_rows: int, k: int, k_pad: int,
               chunk: int, max_lists: int, scores: torch.Tensor,
               ids: torch.Tensor, plan: torch.Tensor, cand: torch.Tensor,
               cand2: torch.Tensor) -> None:
    """Enqueue the IVF form's chain on the current stream: the plan, pass 1
    over the live (cluster, chunk) list, the merges and the decode.
    ``plan`` holds ``max_lists + 1`` int32 (the list, then its live
    length); ``cand``/``cand2`` as in :func:`launch` for ``max_lists``
    lists. ``probe`` is a uint8 (B, C) view. The caller has checked every
    shape, dtype, device and stride (``ops.topk_score_ivf``)."""
    lib = LIB.load()
    b, d = phi.shape
    n_excl = 0 if exclude_ids is None else exclude_ids.shape[1]
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = lib.topk_score_ivf_run(
            phi.data_ptr(), _ptr(psi), PSI_TYPES[psi.dtype], _ptr(psi_scale),
            _ptr(exclude_ids), n_excl, _ptr(ids_global), counts.data_ptr(),
            probe.data_ptr(), probe.shape[1], block_rows, b, d, k, k_pad,
            chunk, max_lists, cand.numel() // b, plan.data_ptr(),
            plan[max_lists:].data_ptr(), _ptr(cand), _ptr(cand2),
            scores.data_ptr(), ids.data_ptr(), stream)
    LIB.check(rc, "topk_score_ivf")


def launch_fused(phi: torch.Tensor, psi: torch.Tensor, psi_scale, exclude_ids,
                 mask, mask_stride: int, k: int, k_pad: int, n_blocks: int,
                 id_offset: int, n_valid: int, scores: torch.Tensor,
                 ids: torch.Tensor, cand, counters: torch.Tensor,
                 lib=None) -> None:
    """Enqueue the exact form's one launch (``topk_fused_kernel``) on the
    current stream: ``n_blocks`` blocks along the ψ rows
    (``vmem.topk_fused_blocks``); ``cand`` holds (n_blocks /
    TOPK_FUSED_CLUSTER, B, k_pad) keys, or is None for one cluster;
    ``counters`` is the stream's int32 completion counters, zero before
    and after. ``lib`` is :data:`LIB` or a variant build of its source.
    The caller has checked every shape, dtype, device and stride
    (``ops.topk_score``)."""
    lib = lib or LIB
    fn = lib.load().topk_score_fused_run
    b, d = phi.shape
    n_excl = 0 if exclude_ids is None else exclude_ids.shape[1]
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = fn(phi.data_ptr(), _ptr(psi), PSI_TYPES[psi.dtype],
                _ptr(psi_scale), _ptr(exclude_ids), n_excl, _ptr(mask),
                mask_stride, b, psi.shape[0], d, id_offset, n_valid, k, k_pad,
                n_blocks, _ptr(cand), counters.data_ptr(), scores.data_ptr(),
                ids.data_ptr(), stream)
    lib.check(rc, "topk_score_fused")
