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
                    excl_l: int = 0) -> Dict[str, float]:
    """Cost of ONE ``topk_score`` kernel call over ``n_rows`` fp32 ψ rows.

    Bytes: the ψ shard read once per 16-row φ block (pass 1 stages ψ per
    φ block), φ read once, the (B, k) scores and ids written, and the
    exclude-id lists read. The (chunks, B, k_pad) candidate keys that pass
    1 writes and pass 2 reads back are left out. FLOPs: the score
    product's ``2·B·n_rows·D``."""
    row_blocks = -(-b // vmem.TOPK_ROW_BLOCK)
    hbm = (4.0 * row_blocks * n_rows * d + 4.0 * b * d + 8.0 * b * k
           + 4.0 * b * excl_l)
    try:
        chunk = vmem.topk_block_items(vmem.topk_k_pad(k), n_items=n_rows)
        smem = float(vmem.topk_smem_bytes(chunk))
    except vmem.VmemBudgetError:  # k the kernel does not take (CPU only)
        smem = float(vmem.SMEM_STATIC_BYTES)
    return {"hbm_bytes": hbm, "flops": 2.0 * b * n_rows * d,
            "smem_bytes": smem}


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
    what that form itself moves: the warp-row form moves ``hbm_bytes``;
    the block-row form keeps e, α and ids in device memory and makes two
    passes over the row on each of its k_b steps, one reading α, e, ids and
    ψ_j, one reading ids, ψ_j and e and writing e (32 B a slot and step;
    24 B pre-gathered), in place of the one pass over the slots and the
    one read of the ψ slab."""
    n_blocks = -(-k // k_b)
    slot = (16.0 if gather else 12.0) * c * d_pad
    psi = 4.0 * n_src * k if gather else 4.0 * c * d_pad * k
    rest = 12.0 * c * k
    if rowpatch:
        rest += 4.0 * c * sum(min(k_b, k - f0) ** 2 for f0 in range(0, k, k_b))
    hbm = n_blocks * slot + psi + rest
    form = vmem.cd_sweep_form(d_pad, k_b, gather=gather, rowpatch=rowpatch)
    if form == vmem.WARP_ROW:
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
    (2) and α·ψ_i (1), and the m(m+1)/2 distinct P terms (2 each)."""
    slot = 12.0 if gather else 4.0 * (m + 2)
    psi = 4.0 * n_src * m if gather else 0.0
    hbm = slot * c * d_pad + psi + 4.0 * c * (m + m * m)
    flops = float(c) * d_pad * (1 + 3 * m + m * (m + 1))
    return {"hbm_bytes": hbm, "flops": flops, "smem_bytes": 0.0}


def cd_resid_patch_cost(c: int, d_pad: int, m: int, *, n_src: int = 0,
                        gather: bool = True) -> Dict[str, float]:
    """Cost of ONE rank-m residual-patch launch (``csrc/cd_slab.cu``).

    Bytes: ids (gather form) and e read and e written — 12 B a slot, the
    ψ slab once; pre-gathered, the Ψ tile, e read and written, (m + 2)·4 B
    a slot — and Δφ (C, m) read. FLOPs: 2m a slot."""
    slot = 12.0 if gather else 4.0 * (m + 2)
    psi = 4.0 * n_src * m if gather else 0.0
    hbm = slot * c * d_pad + psi + 4.0 * c * m
    return {"hbm_bytes": hbm, "flops": 2.0 * c * d_pad * m,
            "smem_bytes": 0.0}


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
                    kernel: str = "topk_score", excl_l: int = 0) -> None:
        self.record(kernel, topk_score_cost(b, n_rows, d, k, excl_l=excl_l))

    def record_cd_sweep(self, c: int, d_pad: int, k: int, k_b: int, *,
                        kernel: str = "cd_sweep", sweeps: int = 1,
                        n_src: int = 0, gather: bool = True) -> None:
        cost = cd_sweep_cost(c, d_pad, k, k_b, n_src=n_src, gather=gather)
        self.record(kernel, {
            "hbm_bytes": cost["hbm_bytes"] * sweeps,
            "flops": cost["flops"] * sweeps,
            "smem_bytes": cost["smem_bytes"],
        }, calls=sweeps)
