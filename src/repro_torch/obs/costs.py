"""Kernel cost accounting at the dispatch sites (port of
``repro.obs.costs``, rebased on the Hopper kernel's own traffic).

The mesh records one cost per ``topk_score`` dispatch into the metrics
registry, and the training callback (``obs/train.py``) one per fused
sweep: device-memory bytes and FLOPs from the shapes in hand, and the
shared memory of one kernel block. The counts are analytic, computed on
the host; no kernel is instrumented.

Counters (label ``kernel``):

  ``kernel_calls_total``       dispatches
  ``kernel_hbm_bytes_total``   device-memory bytes the kernel moves
  ``kernel_flops_total``       FLOPs
  ``kernel_smem_bytes``        (gauge) shared memory of one pass-1 block
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import vmem
from repro_torch.obs.metrics import resolve_registry


def topk_score_cost(b: int, n_rows: int, d: int, k: int, *,
                    psi_bytes: int = 4, per_row_scale: bool = False,
                    excl_l: int = 0, mask: bool = False) -> Dict[str, float]:
    """Cost of ONE ``topk_score`` kernel call over ``n_rows`` stored ψ rows.

    Bytes: the ψ shard at its stored width
    (:func:`~repro_torch.kernels.vmem.psi_row_bytes`: ``psi_bytes`` a value,
    plus the fp32 scale of the int8 form) read once per 16-row φ block
    (pass 1 stages ψ per φ block), φ read once, the (B, k) scores and ids
    written, the exclude-id lists read, and the dense (B, n_rows) byte mask
    read (``mask``). The candidate keys that pass 1 writes and pass 2 reads
    back are left out. FLOPs: the score product's ``2·B·n_rows·D``."""
    row_blocks = -(-b // vmem.TOPK_ROW_BLOCK)
    row = vmem.psi_row_bytes(d, psi_bytes=psi_bytes,
                             per_row_scale=per_row_scale)
    hbm = (float(row_blocks) * n_rows * row + 4.0 * b * d + 8.0 * b * k
           + 4.0 * b * excl_l + (float(b) * n_rows if mask else 0.0))
    chunk = vmem.topk_block_items(vmem.topk_k_pad(k))
    return {"hbm_bytes": hbm, "flops": 2.0 * b * n_rows * d,
            "smem_bytes": float(vmem.topk_smem_bytes(chunk))}


def topk_score_ivf_cost(b: int, n_rows: int, d: int, k: int,
                        n_clusters: int, *, psi_bytes: int = 4,
                        per_row_scale: bool = False,
                        excl_l: int = 0) -> Dict[str, float]:
    """Cost of ONE ``topk_score_ivf`` call (the IVF form's launch chain)
    that scores ``n_rows`` stored ψ rows: the valid rows of the clusters
    the batch probed.

    Bytes: those rows at their stored width and their global ids (4 B),
    read once per 16-row φ block; the cluster counts (4 B a cluster) and
    the (B, C) probe mask (1 B an entry); φ, the exclude-id lists and the
    (B, k) outputs — what :func:`topk_score_cost` counts for a table of
    ``n_rows`` rows. The plan's list and the candidate keys are left out.
    FLOPs: ``2·B·n_rows·D``."""
    cost = topk_score_cost(b, n_rows, d, k, psi_bytes=psi_bytes,
                           per_row_scale=per_row_scale, excl_l=excl_l)
    row_blocks = -(-b // vmem.TOPK_ROW_BLOCK)
    cost["hbm_bytes"] += (4.0 * row_blocks * n_rows + 4.0 * n_clusters
                          + float(b) * n_clusters)
    return cost


def cd_sweep_cost(c: int, d_pad: int, k: int, k_b: int, *, n_src: int = 0,
                  gather: bool = True,
                  rowpatch: bool = False) -> Dict[str, float]:
    """Cost of ONE side's fused k-column block sweep over the padded
    (C, D_pad) layout, ⌈k/k_b⌉ launches of ``csrc/cd_sweep.cu``.

    ``hbm_bytes`` is what the function must move, per launch: ids (gather
    form), α and e read and e written once (16 B a slot; 12 B
    pre-gathered), W and R' read and W written (12 B a row and column),
    the ψ slab's ``n_src`` rows read once — or, in the pre-gathered form,
    the (C, k_b, D_pad) Ψ tile read — and, in the row-patch form, the
    per-row patch P (C·k_b² floats) read in place of the Gram block.
    FLOPs: 8 a slot and column (L'/2 and L''/2, three each; the e patch,
    two).

    ``form`` is the launch form (``vmem.cd_sweep_form``) and ``form_bytes``
    what that form itself moves: the register-row and warp-row forms, in
    either ψ routing, move ``hbm_bytes`` (the register-row form's shared
    memory is its coupling blocks and partial sums,
    ``vmem.cd_sweep_reg_smem_bytes``); the block-row form keeps e, α and ids in device memory and makes two
    passes over the row on each of its k_b steps, one reading α, e, ids and
    ψ_j, one reading ids, ψ_j and e and writing e (32 B a slot and step;
    24 B pre-gathered), in place of the one pass over the slots and the
    one read of the ψ slab; the split-row form makes two passes a launch,
    pass 1 reading ids, α, e and the slot's k_b ψ values, pass 2 ids, ψ
    and e and writing e ((12 + 4·k_b) B a slot each; pre-gathered, no ids:
    (8 + 4·k_b) B), and writes and reads back its scratch: 44 partial sums
    a chunk of a row (``vmem.cd_sweep_split_chunk``) and Δ (k_b a row)."""
    n_blocks = -(-k // k_b)
    slot = (16.0 if gather else 12.0) * c * d_pad
    psi = 4.0 * n_src * k if gather else 4.0 * c * d_pad * k
    rest = 12.0 * c * k
    if rowpatch:
        rest += 4.0 * c * sum(min(k_b, k - f0) ** 2 for f0 in range(0, k, k_b))
    hbm = n_blocks * slot + psi + rest
    form = vmem.cd_sweep_form(d_pad, k_b, gather=gather, rowpatch=rowpatch)
    if form == vmem.REG_ROW:
        lanes, _ = vmem.cd_sweep_reg_group(d_pad, k_b)
        smem = vmem.cd_sweep_reg_smem_bytes(lanes, rowpatch=rowpatch)
        own = hbm
    elif form == vmem.SPLIT_ROW:
        smem = vmem.cd_sweep_split_smem_bytes()
        n_chunks = -(-d_pad // vmem.cd_sweep_split_chunk(d_pad, c))
        own = rest + sum(
            2.0 * ((12 if gather else 8) + 4 * kb) * c * d_pad
            + 4.0 * c * (2 * vmem.CDG_NSUM * n_chunks + 2 * kb)
            for kb in (min(k_b, k - f0) for f0 in range(0, k, k_b)))
    elif form == vmem.WARP_ROW:
        rows = (vmem.cd_sweep_gather_block_ctx if gather else
                vmem.cd_sweep_block_ctx)(d_pad, k_b, n_rows=c,
                                         rowpatch=rowpatch)
        smem = vmem.cd_sweep_smem_bytes(d_pad, k_b, rows, gather=gather,
                                        rowpatch=rowpatch)
        own = hbm
    else:
        smem = vmem.cd_sweep_block_row_smem_bytes(k_b)
        own = (32.0 if gather else 24.0) * c * d_pad * k + rest
    return {"hbm_bytes": hbm, "flops": 8.0 * c * d_pad * k,
            "smem_bytes": float(smem), "form": form, "form_bytes": own}


def cd_slab_reduce_cost(c: int, d_pad: int, m: int, *, n_src: int = 0,
                        gather: bool = True) -> Dict[str, float]:
    """Cost of ONE slab-reduce launch (``csrc/cd_slab.cu``) over the
    padded (C, D_pad) layout and m block columns.

    Bytes: ids (gather form), α and e read once — 12 B a slot, the ψ
    slab's ``n_src`` rows of m floats read once; pre-gathered, α, e and
    the (C, m, D_pad) Ψ tile, (m + 2)·4 B a slot — and Q (C, m) and P
    (C, m, m) written. FLOPs a slot: α·e, then for each column the Q term
    (2) and α·ψ_i (1), and the m(m+1)/2 distinct P terms (2 each).

    ``form`` is the launch form (``vmem.cd_slab_reduce_form``) and
    ``form_bytes`` what it moves: the one-tile form ``hbm_bytes``; the
    tiled form one pass over the row for each pair of 8-column tiles
    (bi ≤ bj), each reading α, the diagonal passes also e, and ids and
    the ψ slab (gather) or the two tiles' Ψ columns (pre-gathered)."""
    slot = 12.0 if gather else 4.0 * (m + 2)
    psi = 4.0 * n_src * m if gather else 0.0
    out = 4.0 * c * (m + m * m)
    hbm = slot * c * d_pad + psi + out
    flops = float(c) * d_pad * (1 + 3 * m + m * (m + 1))
    form = vmem.cd_slab_reduce_form(m)
    own = hbm
    if form == vmem.SLAB_TILED:
        cols = [min(8, m - c0) for c0 in range(0, m, 8)]  # cd_slab.cu SLAB_TILE
        per_slot = 0.0
        for bi in range(len(cols)):
            for bj in range(bi, len(cols)):
                diag = bi == bj
                per_slot += 8.0 if diag else 4.0        # α, and e on the diagonal
                per_slot += 4.0 if gather else 4.0 * (
                    cols[bi] + (0 if diag else cols[bj]))
        own = per_slot * c * d_pad + psi + out
    return {"hbm_bytes": hbm, "flops": flops, "smem_bytes": 0.0,
            "form": form, "form_bytes": own}


def cd_resid_patch_cost(c: int, d_pad: int, m: int, *, n_src: int = 0,
                        gather: bool = True) -> Dict[str, float]:
    """Cost of ONE rank-m residual-patch launch (``csrc/cd_slab.cu``).

    Bytes: ids (gather form) and e read and e written — 12 B a slot, the
    ψ slab once; pre-gathered, the Ψ tile, e read and written, (m + 2)·4 B
    a slot — and Δφ (C, m) read. FLOPs: 2m a slot. ``form`` is the launch
    form (``vmem.cd_resid_patch_form``)."""
    slot = 12.0 if gather else 4.0 * (m + 2)
    psi = 4.0 * n_src * m if gather else 0.0
    hbm = slot * c * d_pad + psi + 4.0 * c * m
    return {"hbm_bytes": hbm, "flops": 2.0 * c * d_pad * m,
            "smem_bytes": 0.0,
            "form": vmem.cd_resid_patch_form(d_pad, m, gather=gather)}


class KernelCostRecorder:
    """Registry-bound recorder; resolve once, record per dispatch.

    Children are cached per kernel label, so a dispatch costs a dict hit
    and three float adds. With ``NULL_REGISTRY`` every record is a no-op."""

    def __init__(self, registry=None):
        reg = resolve_registry(registry)
        self._calls = reg.counter(
            "kernel_calls_total", "kernel dispatches", labels=("kernel",))
        self._hbm = reg.counter(
            "kernel_hbm_bytes_total",
            "device-memory bytes the kernel moves (obs/costs.py model)",
            labels=("kernel",))
        self._flops = reg.counter(
            "kernel_flops_total", "analytic FLOPs", labels=("kernel",))
        self._smem = reg.gauge(
            "kernel_smem_bytes",
            "last dispatch's shared memory per kernel block",
            labels=("kernel",))
        self._children: Dict[str, tuple] = {}

    def _resolve(self, kernel: str):
        ch = self._children.get(kernel)
        if ch is None:
            ch = (
                self._calls.labels(kernel=kernel),
                self._hbm.labels(kernel=kernel),
                self._flops.labels(kernel=kernel),
                self._smem.labels(kernel=kernel),
            )
            self._children[kernel] = ch
        return ch

    def record(self, kernel: str, cost: Dict[str, float],
               calls: int = 1) -> None:
        calls_c, hbm_c, flops_c, smem_g = self._resolve(kernel)
        calls_c.inc(calls)
        hbm_c.inc(cost["hbm_bytes"])
        flops_c.inc(cost["flops"])
        smem_g.set(cost.get("smem_bytes", 0.0))

    def record_topk(self, b: int, n_rows: int, d: int, k: int, *,
                    kernel: str = "topk_score", psi_bytes: int = 4,
                    per_row_scale: bool = False, excl_l: int = 0,
                    mask: bool = False) -> None:
        self.record(kernel, topk_score_cost(
            b, n_rows, d, k, psi_bytes=psi_bytes,
            per_row_scale=per_row_scale, excl_l=excl_l, mask=mask))

    def record_cd_sweep(self, c: int, d_pad: int, k: int, k_b: int, *,
                        kernel: str = "cd_sweep", sweeps: int = 1,
                        n_src: int = 0, gather: bool = True) -> None:
        cost = cd_sweep_cost(c, d_pad, k, k_b, n_src=n_src, gather=gather)
        self.record(kernel, {
            "hbm_bytes": cost["hbm_bytes"] * sweeps,
            "flops": cost["flops"] * sweeps,
            "smem_bytes": cost["smem_bytes"],
        }, calls=sweeps)
